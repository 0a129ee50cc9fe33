"""Preprocessing op parity: device (jnp) == golden (numpy) == cv2 reference.

The cv2 calls below mirror the reference kernels in
``core/preprocessing.py:50-151`` and serve as the behavioral oracle.
"""
from __future__ import annotations

import cv2
import numpy as np
import pytest

from yamimageprocessor_tpu.ops.registry import get_impl


def _structured_bgr(h=96, w=120):
    y, x = np.mgrid[:h, :w]
    b = (x * 255 / w).astype(np.uint8)
    g = (y * 255 / h).astype(np.uint8)
    r = ((x + y) % 256).astype(np.uint8)
    img = np.stack([b, g, r], axis=-1)
    img[20:40, 30:70] = (250, 10, 128)
    return img


@pytest.fixture()
def bgr(rng):
    img = rng.integers(0, 256, (96, 120, 3), dtype=np.uint8)
    img[10:30, 10:50] = 200
    return img


@pytest.fixture()
def gray(rng):
    return rng.integers(0, 256, (96, 120), dtype=np.uint8)


def run_device(identifier, image, **params):
    import jax.numpy as jnp

    impl = get_impl(identifier)
    static, dyn = impl.split(params)
    dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
    out = impl.device_fn(jnp.asarray(image), dyn_j, **static)
    return np.asarray(out)


def assert_triple(identifier, image, cv2_fn, max_cv2_diff=0, max_dev_diff=0, **params):
    """golden vs cv2 within max_cv2_diff; device vs golden within max_dev_diff."""

    impl = get_impl(identifier)
    golden = impl.golden_fn(image, **params)
    oracle = cv2_fn(image)
    assert golden.shape == oracle.shape, identifier
    diff = np.abs(golden.astype(np.int32) - oracle.astype(np.int32)).max()
    assert diff <= max_cv2_diff, f"{identifier}: golden vs cv2 diff {diff}"
    device = run_device(identifier, image, **params)
    ddiff = np.abs(device.astype(np.int32) - golden.astype(np.int32)).max()
    assert ddiff <= max_dev_diff, f"{identifier}: device vs golden diff {ddiff}"
    return golden


# ---------------------------------------------------------------------------
def test_grayscale(bgr):
    assert_triple(
        "preprocessing.grayscale",
        bgr,
        lambda im: cv2.cvtColor(im, cv2.COLOR_BGR2GRAY),
    )


def test_grayscale_passthrough(gray):
    impl = get_impl("preprocessing.grayscale")
    assert (impl.golden_fn(gray) == gray).all()


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (1.5, 20.0), (0.7, -30.0), (2.3, 5.5)])
def test_brightness_contrast(bgr, alpha, beta):
    assert_triple(
        "preprocessing.brightness_contrast",
        bgr,
        lambda im: cv2.convertScaleAbs(im, alpha=alpha, beta=beta),
        max_cv2_diff=1,  # cv2 computes in float64; we are float32 end-to-end
        alpha=alpha,
        beta=beta,
    )


@pytest.mark.parametrize("value", [0.4, 1.0, 2.2, 5.0])
def test_gamma(bgr, value):
    inv = 1.0 / value
    table = np.array([(i / 255.0) ** inv * 255 for i in range(256)]).astype("uint8")
    assert_triple(
        "preprocessing.gamma", bgr, lambda im: cv2.LUT(im, table), value=value
    )


def test_histogram_equalization_gray(gray):
    assert_triple(
        "preprocessing.histogram_equalization", gray, cv2.equalizeHist
    )


def test_histogram_equalization_color(bgr):
    def oracle(im):
        ycrcb = cv2.cvtColor(im, cv2.COLOR_BGR2YCrCb)
        ycrcb[:, :, 0] = cv2.equalizeHist(ycrcb[:, :, 0])
        return cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2BGR)

    assert_triple("preprocessing.histogram_equalization", bgr, oracle)


def test_histogram_equalization_constant():
    img = np.full((32, 32), 9, np.uint8)
    assert_triple("preprocessing.histogram_equalization", img, cv2.equalizeHist)


@pytest.mark.parametrize("alpha,beta", [(0.0, 255.0), (10.0, 200.0)])
def test_normalize(bgr, alpha, beta):
    assert_triple(
        "preprocessing.normalize",
        bgr,
        lambda im: cv2.normalize(im, None, alpha, beta, cv2.NORM_MINMAX),
        max_cv2_diff=1,
        alpha=alpha,
        beta=beta,
    )


def test_normalize_constant():
    img = np.full((16, 16), 40, np.uint8)
    out = get_impl("preprocessing.normalize").golden_fn(img, alpha=0.0, beta=255.0)
    ref = cv2.normalize(img, None, 0.0, 255.0, cv2.NORM_MINMAX)
    assert (out == ref).all()


@pytest.mark.parametrize("ksize", [3, 5, 9])
def test_gaussian_noise_reduction(bgr, ksize):
    assert_triple(
        "preprocessing.noise_reduction",
        bgr,
        lambda im: cv2.GaussianBlur(im, (ksize, ksize), 0),
        max_cv2_diff=1,  # cv2 8u path is 16-bit fixed point
        max_dev_diff=1,  # float reduction-order ties
        method="Gaussian",
        ksize=ksize,
    )


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_noise_reduction(bgr, ksize):
    assert_triple(
        "preprocessing.noise_reduction",
        bgr,
        lambda im: cv2.medianBlur(im, ksize),
        method="Median",
        ksize=ksize,
    )


def test_median_even_ksize_coerced(gray):
    # core/preprocessing.py:83-84 bumps even ksize
    impl = get_impl("preprocessing.noise_reduction")
    assert (
        impl.golden_fn(gray, method="Median", ksize=4)
        == cv2.medianBlur(gray, 5)
    ).all()


@pytest.mark.parametrize("ksize", [5, 9])
def test_bilateral_noise_reduction(gray, ksize):
    assert_triple(
        "preprocessing.noise_reduction",
        gray,
        lambda im: cv2.bilateralFilter(im, ksize, 75, 75),
        max_cv2_diff=1,
        max_dev_diff=1,
        method="Bilateral",
        ksize=ksize,
    )


def test_bilateral_color(bgr):
    assert_triple(
        "preprocessing.noise_reduction",
        bgr,
        lambda im: cv2.bilateralFilter(im, 5, 75, 75),
        max_cv2_diff=1,
        max_dev_diff=1,
        method="Bilateral",
        ksize=5,
    )


@pytest.mark.parametrize("strength", [0.5, 1.0, 2.0])
def test_sharpen(bgr, strength):
    def oracle(im):
        blurred = cv2.GaussianBlur(im, (0, 0), sigmaX=3)
        return cv2.addWeighted(im, 1 + strength, blurred, -strength, 0)

    assert_triple(
        "preprocessing.sharpen",
        bgr,
        oracle,
        max_cv2_diff=2,  # blur rounding feeds the weighted sum
        max_dev_diff=1,
        strength=strength,
    )


@pytest.mark.parametrize("value", ["All", "R", "G", "B", "RG", "GB", "BR"])
def test_select_channel(bgr, value):
    def oracle(im):
        blue, green, red = cv2.split(im)
        if value == "All":
            return im
        if value == "R":
            return red
        if value == "G":
            return green
        if value == "B":
            return blue
        pair = {
            "RG": (red, green),
            "GB": (green, blue),
            "BR": (blue, red),
        }[value]
        return np.uint8((pair[0].astype(np.float32) + pair[1].astype(np.float32)) / 2)

    assert_triple("preprocessing.select_channel", bgr, oracle, value=value)


def test_select_channel_gray_input(gray):
    out = get_impl("preprocessing.select_channel").golden_fn(gray, value="R")
    ref = cv2.split(cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))[2]
    assert (out == ref).all()


def test_crop(bgr):
    golden = assert_triple(
        "preprocessing.crop",
        bgr,
        lambda im: im[10 : 10 + 40, 20 : 20 + 60],
        x_offset=20,
        y_offset=10,
        width=60,
        height=40,
        apply_crop=True,
    )
    assert golden.shape == (40, 60, 3)


def test_crop_overlay_matches_cv2(bgr):
    ref = bgr.copy()
    overlay = ref.copy()
    cv2.rectangle(overlay, (20, 10), (80, 50), (0, 255, 0), thickness=-1)
    blended = cv2.addWeighted(overlay, 0.3, ref, 0.7, 0)
    out = get_impl("preprocessing.crop").golden_fn(
        bgr, x_offset=20, y_offset=10, width=60, height=40, apply_crop=False
    )
    # interior of the fill (away from the thickness-2 border) must match
    inner = (slice(14, 47), slice(24, 77))
    assert np.abs(
        out[inner].astype(int) - blended[inner].astype(int)
    ).max() <= 1


def test_clahe_matches_cv2_exact_divisible():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    assert_triple(
        "preprocessing.clahe",
        img,
        lambda im: cv2.createCLAHE(clipLimit=40.0, tileGridSize=(8, 8)).apply(im),
        clip_limit=40.0,
        grid_size=8,
    )


@pytest.mark.parametrize("shape", [(96, 120), (130, 100)])
def test_clahe_matches_cv2_padded(shape):
    # non-divisible frames pad to the grid; blend-rounding ties at exact .5
    # differ by <=1 LSB between float32/float64 evaluation orders
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    assert_triple(
        "preprocessing.clahe",
        img,
        lambda im: cv2.createCLAHE(clipLimit=40.0, tileGridSize=(8, 8)).apply(im),
        max_cv2_diff=1,
        max_dev_diff=1,
        clip_limit=40.0,
        grid_size=8,
    )


def test_clahe_gather_blend_parity():
    """The device CLAHE (scatter-add tile histograms + four-corner gather
    blend in the golden's f32 term order) is bit-identical to the numpy
    golden on a grid-aligned frame."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import clahe as CL

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    out = np.asarray(CL.clahe_j(jnp.asarray(img), clip_limit=2.0, grid=(8, 8)))
    assert (out == CL.clahe_np(img, 2.0, (8, 8))).all()


def test_clahe_gather_blend_batched_parity():
    """vmapped CLAHE (the batched chain's path: per-frame histograms and
    tables) matches the golden frame by frame."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import clahe as CL

    rng = np.random.default_rng(10)
    frames = rng.integers(0, 256, (3, 128, 128), dtype=np.uint8)
    batched = np.asarray(
        jax.vmap(lambda f: CL.clahe_j(f, clip_limit=2.0, grid=(4, 4)))(
            jnp.asarray(frames)
        )
    )
    for i in range(frames.shape[0]):
        assert (batched[i] == CL.clahe_np(frames[i], 2.0, (4, 4))).all()


def test_clahe_color(bgr):
    impl = get_impl("preprocessing.clahe")
    out = impl.golden_fn(bgr, clip_limit=2.0, grid_size=4)
    assert out.shape == bgr.shape
    device = run_device("preprocessing.clahe", bgr, clip_limit=2.0, grid_size=4)
    # f32/f64 blend-rounding ties: <=1 LSB on the equalized Y channel
    assert np.abs(device.astype(int) - out.astype(int)).max() <= 1


def test_histeq_odd_shapes_bit_exact(rng):
    """Odd shapes exercise the scatter-add histogram on ragged sizes and
    the correctly-rounded f32 scale divide (device == golden everywhere)."""
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.registry import get_impl

    impl = get_impl("preprocessing.histogram_equalization")
    for shape in [(7, 13), (129, 255), (100, 103, 3), (3, 5)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        golden = impl.golden_fn(img)
        device = np.asarray(impl.device_fn(jnp.asarray(img), {}))
        assert (device == golden).all(), shape


def test_batched_lut_and_histogram_parity(rng):
    """vmapped apply_lut_j / histogram256_j with per-frame tables stay
    bit-exact with numpy (the batched chain's LUT path)."""
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.lutops import apply_lut_j, histogram256_j

    imgs = rng.integers(0, 256, (3, 37, 53), dtype=np.uint8)
    luts = rng.integers(0, 256, (3, 256), dtype=np.uint8)
    out = np.asarray(jax.vmap(apply_lut_j)(jnp.asarray(imgs), jnp.asarray(luts)))
    ref = np.stack([luts[i][imgs[i]] for i in range(3)])
    assert (out == ref).all()
    h = np.asarray(jax.vmap(histogram256_j)(jnp.asarray(imgs)))
    href = np.stack([np.bincount(imgs[i].ravel(), minlength=256) for i in range(3)])
    assert (h == href).all()


def _gaussian_pair(imgs):
    import jax.numpy as jnp

    impl = get_impl("preprocessing.noise_reduction")
    params = {"method": "Gaussian", "ksize": 5}
    static, dyn = impl.split_params(params, imgs.shape[1:])
    dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
    for img in imgs:
        device = np.asarray(impl.device_fn(jnp.asarray(img), dyn_j, **static))
        yield device, impl.golden_fn(img, **params)


def test_gaussian_gray_parity():
    """The device separable Gaussian (uint8 gray, reflect101 borders,
    widths off any power of two) stays within the float-filter class of
    the golden: <= 1 LSB."""

    rng = np.random.default_rng(13)
    for shape in [(64, 128), (100, 130), (48, 256)]:
        imgs = rng.integers(0, 256, (2,) + shape, dtype=np.uint8)
        for device, golden in _gaussian_pair(imgs):
            assert np.abs(device.astype(int) - golden.astype(int)).max() <= 1, shape


def test_gaussian_channel_planes_parity():
    """Channel frames filter each plane independently: <= 1 LSB of the
    golden on 3- and 4-channel frames."""

    rng = np.random.default_rng(14)
    for shape in [(64, 128, 3), (52, 130, 4)]:
        imgs = rng.integers(0, 256, (2,) + shape, dtype=np.uint8)
        for device, golden in _gaussian_pair(imgs):
            assert np.abs(device.astype(int) - golden.astype(int)).max() <= 1, shape


def test_median25_network_exhaustive_zero_one():
    """0-1 principle proof of the ksize=5 median construction: sorting the
    window's columns, extracting the rank-feasible candidate multisets per
    row (median25_candidates_partial), and taking the forgetful median
    computes the median of 25 on ALL 2^25 binary inputs (the construction
    is min/max-monotone, so a network correct on every 0-1 input is
    correct on every input).  Guards _SORT5_PAIRS and the partial
    candidate extraction."""

    import itertools

    from yamimageprocessor_tpu.ops.filters import (
        _SORT5_PAIRS,
        median25_candidates_partial,
    )

    for bits in itertools.product([0, 1], repeat=5):
        v = list(bits)
        for a, b in _SORT5_PAIRS:
            v[a], v[b] = min(v[a], v[b]), max(v[a], v[b])
        assert v == sorted(bits)

    mn, mx = np.logical_and, np.logical_or

    def sort5(v):
        v = list(v)
        for a, b in _SORT5_PAIRS:
            lo, hi = mn(v[a], v[b]), mx(v[a], v[b])
            v[a], v[b] = lo, hi
        return v

    CHUNK = 20
    low = np.arange(1 << CHUNK, dtype=np.uint32)
    low_bits = [((low >> b) & 1).astype(bool) for b in range(CHUNK)]
    for hi in range(1 << 5):
        wires = [
            low_bits[b]
            if b < CHUNK
            else np.full(1 << CHUNK, bool((hi >> (b - CHUNK)) & 1))
            for b in range(25)
        ]
        m = [[wires[r * 5 + c] for c in range(5)] for r in range(5)]
        for c in range(5):
            col = sort5([m[r][c] for r in range(5)])
            for r in range(5):
                m[r][c] = col[r]
        vals = median25_candidates_partial(m, mn, mx)

        def dropmm(win):
            win = list(win)
            for i in range(1, len(win)):
                lo, hi = mn(win[0], win[i]), mx(win[0], win[i])
                win[0], win[i] = lo, hi
            for i in range(1, len(win) - 1):
                lo, hi = mn(win[i], win[-1]), mx(win[i], win[-1])
                win[i], win[-1] = lo, hi
            return win[1:-1]

        sel = vals[:8]
        for tap in vals[8:]:
            sel = dropmm(sel)
            sel.append(tap)
        sel = dropmm(sel)
        ones = np.zeros(1 << CHUNK, np.int16)
        for b in range(25):
            ones += wires[b].astype(np.int16)
        assert np.array_equal(sel[0], ones >= 13), f"hi={hi}"
