"""Advanced segmentation parity: labeling, distance, watershed, growing,
split/merge, clustering, grabcut, snake.

Device paths of the iterative ops (while_loop flooding) are exercised on
small fixtures; host<->device bitwise equality is the hard requirement, cv2
equality is asserted where the algorithm is deterministic (labeling,
distance, flood fill) and structurally elsewhere (level-synchronous
watershed vs cv2's FIFO flooding).
"""
from __future__ import annotations

import cv2
import numpy as np
import pytest

from yamimageprocessor_tpu.ops.registry import get_impl


def _cells(h=80, w=96, seed=3):
    """Synthetic microscopy-like frame: bright blobs on dark background."""

    rng = np.random.default_rng(seed)
    img = np.full((h, w), 30, np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for cy, cx, r in ((20, 24, 11), (30, 60, 13), (60, 30, 12), (58, 70, 9)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 210
    img = (img.astype(np.int16) + rng.integers(-12, 13, (h, w))).clip(0, 255)
    return img.astype(np.uint8)


@pytest.fixture()
def gray():
    return _cells()


@pytest.fixture()
def bgr(gray):
    return cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)


def run_device(identifier, image, **params):
    import jax.numpy as jnp

    impl = get_impl(identifier)
    static, dyn = impl.split_params(params, image.shape)
    dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
    return np.asarray(impl.device_fn(jnp.asarray(image), dyn_j, **static))


# ---------------------------------------------------------------------------
def test_connected_components_matches_cv2(gray):
    from yamimageprocessor_tpu.ops.labeling import label_j, label_np

    import jax.numpy as jnp

    mask = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)[1]
    n_ref, ref = cv2.connectedComponents(mask)
    golden = label_np(mask > 0)
    assert (golden == ref).all()
    device = np.asarray(label_j(jnp.asarray(mask > 0)))
    assert (device == golden).all()


def test_distance_transform_matches_cv2(gray):
    from yamimageprocessor_tpu.ops.distance import (
        distance_transform_j,
        distance_transform_np,
    )

    import jax.numpy as jnp

    mask = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)[1]
    ref = cv2.distanceTransform(mask, cv2.DIST_L2, 5)
    golden = distance_transform_np(mask)
    np.testing.assert_allclose(golden, ref, atol=2e-4)
    device = np.asarray(distance_transform_j(jnp.asarray(mask)))
    assert (device == golden).all(), "device/golden must be bit-identical"


@pytest.mark.parametrize(
    "shape",
    [
        (64, 96),
        (100, 130),
        (8, 128),
        # production-width rows, including a ragged width
        (8, 1024),
        (10, 1030),
        (16, 2048),
    ],
)
def test_distance_transform_matches_golden(shape, rng):
    """The XLA row-scan chamfer is bit-identical to the numpy golden on
    random masks with a solid band (long in-row runs), ragged widths
    included."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.distance import (
        distance_transform_j,
        distance_transform_np,
    )

    mask = (rng.random(shape) > 0.6).astype(np.uint8) * 255
    mask[shape[0] // 3 : 2 * shape[0] // 3, shape[1] // 4 :] = 255
    out = np.asarray(distance_transform_j(jnp.asarray(mask)))
    assert (out == distance_transform_np(mask)).all()


def test_watershed_device_matches_golden(bgr):
    impl = get_impl("segmentation.watershed")
    golden = impl.golden_fn(
        bgr,
        kernel_size=3,
        opening_iterations=2,
        dilation_iterations=3,
        distance_threshold_factor=0.7,
    )
    device = run_device(
        "segmentation.watershed",
        bgr,
        kernel_size=3,
        opening_iterations=2,
        dilation_iterations=3,
        distance_threshold_factor=0.7,
    )
    assert (device == golden).all()


def test_watershed_close_to_cv2(bgr):
    impl = get_impl("segmentation.watershed")
    golden = impl.golden_fn(
        bgr,
        kernel_size=3,
        opening_iterations=2,
        dilation_iterations=3,
        distance_threshold_factor=0.7,
    )

    # reference composition with cv2 (core/segmentation.py:96-114)
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    _, thresh = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    kernel = np.ones((3, 3), np.uint8)
    opening = cv2.morphologyEx(thresh, cv2.MORPH_OPEN, kernel, iterations=2)
    sure_bg = cv2.dilate(opening, kernel, iterations=3)
    dist = cv2.distanceTransform(opening, cv2.DIST_L2, 5)
    _, sure_fg = cv2.threshold(dist, 0.7 * dist.max(), 255, 0)
    sure_fg = np.uint8(sure_fg)
    unknown = cv2.subtract(sure_bg, sure_fg)
    _, markers = cv2.connectedComponents(sure_fg)
    markers = markers + 1
    markers[unknown == 255] = 0
    markers = cv2.watershed(bgr, markers)
    annotated = bgr.copy()
    annotated[markers == -1] = [0, 0, 255]

    agree = (golden == annotated).all(axis=-1).mean()
    assert agree > 0.98, f"only {agree:.3f} of pixels agree with cv2 watershed"


def test_region_growing_matches_cv2_floodfill(gray):
    impl = get_impl("segmentation.region_growing")
    golden = impl.golden_fn(gray, seed=(24, 20), tolerance=10)

    ref = gray.copy()
    mask = np.zeros((gray.shape[0] + 2, gray.shape[1] + 2), np.uint8)
    cv2.floodFill(ref, mask, seedPoint=(24, 20), newVal=255, loDiff=10, upDiff=10)
    assert (golden == ref).all()

    device = run_device("segmentation.region_growing", gray, seed=(24, 20), tolerance=10)
    assert (device == golden).all()


def test_region_split_merge(gray):
    impl = get_impl("segmentation.region_split_merge")
    golden = impl.golden_fn(gray, min_size=16, std_thresh=10.0)

    # recursive reference formulation (core/segmentation.py:177-193)
    ref_img = gray.astype(np.float32)
    seg = np.zeros_like(ref_img)

    def split_region(x, y, w, h):
        region = ref_img[y : y + h, x : x + w]
        if w <= 16 or h <= 16 or np.std(region) < 10.0:
            seg[y : y + h, x : x + w] = np.mean(region)
        else:
            hw, hh = w // 2, h // 2
            split_region(x, y, hw, hh)
            split_region(x + hw, y, w - hw, hh)
            split_region(x, y + hh, hw, h - hh)
            split_region(x + hw, y + hh, w - hw, h - hh)

    split_region(0, 0, ref_img.shape[1], ref_img.shape[0])
    ref = np.uint8(seg)
    # float32 two-pass stats vs float64 recursive stats: identical decisions
    # on this fixture, mean rounding may differ by 1 LSB
    assert np.abs(golden.astype(int) - ref.astype(int)).max() <= 1

    device = run_device("segmentation.region_split_merge", gray, min_size=16, std_thresh=10.0)
    assert (device == golden).all()


def test_kmeans(bgr):
    impl = get_impl("segmentation.kmeans")
    golden = impl.golden_fn(bgr, K=2, seed=42)
    assert set(np.unique(golden)).issubset({0, 255})
    device = run_device("segmentation.kmeans", bgr, K=2, seed=42)
    agree = (device == golden).mean()
    assert agree > 0.995, agree


def test_fcm(bgr):
    impl = get_impl("segmentation.fuzzy_cmeans")
    golden = impl.golden_fn(bgr, K=2, seed=42)
    assert set(np.unique(golden)).issubset({0, 255})
    device = run_device("segmentation.fuzzy_cmeans", bgr, K=2, seed=42)
    agree = (device == golden).mean()
    assert agree > 0.995, agree


def test_gmm(bgr):
    impl = get_impl("segmentation.gmm")
    golden = impl.golden_fn(bgr, components=2, seed=42)
    assert set(np.unique(golden)).issubset({0, 255})
    device = run_device("segmentation.gmm", bgr, components=2, seed=42)
    agree = (device == golden).mean()
    assert agree > 0.99, agree


def test_mean_shift_small(bgr):
    small = bgr[:32, :32]
    impl = get_impl("segmentation.mean_shift")
    golden = impl.golden_fn(small, spatial_radius=4, color_radius=30)
    assert set(np.unique(golden)).issubset({0, 255})
    device = run_device(
        "segmentation.mean_shift", small, spatial_radius=4, color_radius=30
    )
    agree = (device == golden).mean()
    assert agree > 0.99, agree


def test_graph_cuts(bgr):
    impl = get_impl("segmentation.graph_cuts")
    assert impl.jittable is True  # device ICM path since the grabcut_j rework
    out = impl.golden_fn(bgr)
    assert out.shape == bgr.shape[:2]
    assert set(np.unique(out)).issubset({0, 255})


def test_active_contour(gray):
    bgr = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    impl = get_impl("segmentation.active_contour")
    assert impl.jittable is True  # device snake path since the rework
    out = impl.golden_fn(bgr, iterations=50, alpha=0.015, beta=10.0, gamma=0.001)
    assert out.shape == bgr.shape
    # the drawn green contour must be present
    green = (out[..., 1] == 255) & (out[..., 0] == 0) & (out[..., 2] == 0)
    assert green.sum() > 50


def test_grabcut_device_structural_parity(rng):
    """Device GrabCut (weighted fixed-shape color fit + ICM) agrees with the
    numpy twin structurally; both run the identical update rule."""
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.grabcut import grabcut_j, grabcut_np
    from yamimageprocessor_tpu.ops.registry import get_impl

    img = np.full((96, 128, 3), 40, np.uint8)
    img[30:70, 40:90] = 200
    img = (
        (img.astype(np.int16) + rng.integers(-8, 9, img.shape))
        .clip(0, 255)
        .astype(np.uint8)
    )
    g_np = grabcut_np(img)
    g_j = np.asarray(jax.jit(grabcut_j)(jnp.asarray(img)))
    inter = (g_np & g_j).sum()
    union = (g_np | g_j).sum()
    assert inter / max(union, 1) > 0.9
    assert g_j[35:65, 45:85].all()      # blob interior is foreground
    assert not g_j[:10].any()           # border band is background (rect)

    impl = get_impl("segmentation.graph_cuts")
    dev = np.asarray(impl.device_fn(jnp.asarray(img), {}))
    assert set(np.unique(dev)).issubset({0, 255})
    gold = impl.golden_fn(img)
    both = ((dev > 0) & (gold > 0)).sum()
    either = ((dev > 0) | (gold > 0)).sum()
    assert both / max(either, 1) > 0.9


def test_active_contour_device_overlay(rng):
    """Device snake (lax.scan evolution + capsule polyline) matches the host
    contour within 2 px in both directions; non-overlay pixels untouched."""
    import jax.numpy as jnp
    from scipy import ndimage

    img = np.full((96, 128, 3), 20, np.uint8)
    yy, xx = np.mgrid[:96, :128]
    img[((yy - 48) ** 2 + (xx - 64) ** 2) <= 30 * 30] = 200
    img = (
        (img.astype(np.int16) + rng.integers(-5, 6, img.shape))
        .clip(0, 255)
        .astype(np.uint8)
    )
    impl = get_impl("segmentation.active_contour")
    assert impl.jittable is True  # device path since the snake rework
    params = {"iterations": 50, "alpha": 0.015, "beta": 10.0, "gamma": 0.001}
    gold = impl.golden_fn(img, **params)
    static, dyn = impl.split_params(params, img.shape)
    dev = np.asarray(
        impl.device_fn(
            jnp.asarray(img), {k: jnp.asarray(v) for k, v in dyn.items()}, **static
        )
    )
    g_mask = (gold[..., 1] == 255) & (gold[..., 0] == 0)
    d_mask = (dev[..., 1] == 255) & (dev[..., 0] == 0)
    assert (d_mask & ndimage.binary_dilation(g_mask, iterations=2)).sum() == d_mask.sum()
    assert (g_mask & ndimage.binary_dilation(d_mask, iterations=2)).sum() == g_mask.sum()
    assert (dev[~d_mask] == img[~d_mask]).all()
