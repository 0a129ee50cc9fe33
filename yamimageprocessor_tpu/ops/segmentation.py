"""The 21 segmentation ops: numpy golden twins + jittable device functions.

Reference kernels: ``core/segmentation.py:79-325``; builder mapping
``processing/segmentation_pipeline.py:84-184``.  Composite ops reuse the
dedicated modules (threshold / edges / morphology / labeling / distance /
watershed / growing / splitmerge / clustering / meanshift / snake /
grabcut).  Mask-producing decisions are integer comparisons end-to-end, so
host (numpy) and device (jnp) outputs are bit-identical; cv2 parity is asserted
in the oracle suite.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from yamimageprocessor_tpu.ops import _kernels as K
from yamimageprocessor_tpu.ops import clustering as CL
from yamimageprocessor_tpu.ops import color as C
from yamimageprocessor_tpu.ops import distance as DI
from yamimageprocessor_tpu.ops import edges as E
from yamimageprocessor_tpu.ops import grabcut as GC
from yamimageprocessor_tpu.ops import growing as GR
from yamimageprocessor_tpu.ops import meanshift as MS
from yamimageprocessor_tpu.ops import morphology as M
from yamimageprocessor_tpu.ops import snake as SN
from yamimageprocessor_tpu.ops import splitmerge as SM
from yamimageprocessor_tpu.ops import threshold as T
from yamimageprocessor_tpu.ops import watershed as W
from yamimageprocessor_tpu.ops.registry import register_op

# ---------------------------------------------------------------------------
# Global threshold (core/segmentation.py:140-143)


def global_threshold_np(image, threshold: int = 127):
    gray = C.bgr_to_gray_np(image)
    return T.binary_np(gray, int(threshold))


def global_threshold_j(img, dyn):
    gray = C.bgr_to_gray_j(img)
    return T.binary_j(gray, dyn["threshold"])


register_op(
    "segmentation.global_threshold",
    golden_fn=global_threshold_np,
    device_fn=global_threshold_j,
    split=lambda p: ({}, {"threshold": np.int32(p.get("threshold", 127))}),
)


# ---------------------------------------------------------------------------
# Otsu threshold (core/segmentation.py:145-148)


def otsu_np(image):
    gray = C.bgr_to_gray_np(image)
    return T.binary_np(gray, T.otsu_threshold_np(gray))


def otsu_j(img, dyn):
    gray = C.bgr_to_gray_j(img)
    return T.binary_j(gray, T.otsu_threshold_j(gray))


def otsu_sharded_j(img, dyn, *, axis: str):
    """Otsu over a spatially sharded frame: psum'd histogram, identical
    integer threshold decision on every shard."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    gray = C.bgr_to_gray_j(img)
    hist = jax.lax.psum(histogram256_j(gray), axis)
    t = T.otsu_from_hist_j(hist)
    return T.binary_j(gray, t)


def otsu_tile_stats_j(tile, dyn):
    """Streaming stats pass: per-tile gray histogram."""

    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    return histogram256_j(C.bgr_to_gray_j(tile))


def otsu_apply_stats_j(tile, stats, dyn):
    """Streaming apply pass: threshold from the global histogram."""

    return T.binary_j(C.bgr_to_gray_j(tile), T.otsu_from_hist_j(stats))


register_op(
    "segmentation.otsu",
    golden_fn=otsu_np,
    device_fn=otsu_j,
    split=lambda p: ({}, {}),
    global_stats=True,
    sharded_device_fn=otsu_sharded_j,
    tile_stats_fn=otsu_tile_stats_j,
    merge_stats_fn=lambda a, b: a + b,
    apply_stats_fn=otsu_apply_stats_j,
)


# ---------------------------------------------------------------------------
# Adaptive threshold (core/segmentation.py:91-94)


def adaptive_np(image, block_size: int = 11, C_: float = None, **kw):
    c_val = kw.get("C", 2 if C_ is None else C_)
    gray = C.bgr_to_gray_np(image)
    return T.adaptive_threshold_np(gray, int(block_size), float(c_val))


def adaptive_j(img, dyn, *, block_size: int = 11):
    gray = C.bgr_to_gray_j(img)
    return T.adaptive_threshold_j(gray, dyn["taps"], dyn["C_ceil"])


def _adaptive_split(p: Mapping[str, Any]):
    bs = int(p.get("block_size", 11))
    if bs % 2 == 0:
        bs += 1
    return (
        {"block_size": bs},
        {
            "taps": K.gaussian_taps(bs, 0.0).astype(np.float32),
            "C_ceil": np.int32(np.ceil(float(p.get("C", 2)))),
        },
    )


register_op(
    "segmentation.adaptive",
    golden_fn=adaptive_np,
    device_fn=adaptive_j,
    split=_adaptive_split,
    halo=lambda p: int(p.get("block_size", 11)) // 2,
    border_mode="edge",  # the local-mean filter pads replicate (cv2 semantics)
)


# ---------------------------------------------------------------------------
# Edge-based segmentation: Canny + 3x3 dilate (core/segmentation.py:116-122)


def edge_np(image, low_threshold: int = 50, high_threshold: int = 150, aperture_size: int = 3):
    gray = C.bgr_to_gray_np(image)
    edges = E.canny_np(gray, low_threshold, high_threshold, aperture_size)
    return M.dilate_np(edges, np.ones((3, 3), np.uint8), 1)


def edge_j(img, dyn, *, aperture_size: int = 3):
    gray = C.bgr_to_gray_j(img)
    edges = E.canny_j(gray, dyn["low"], dyn["high"], aperture_size)
    return M.dilate_j(edges, np.ones((3, 3), np.uint8), 1)


def _edge_split(p: Mapping[str, Any]):
    low = int(np.floor(float(p.get("low_threshold", 50))))
    high = int(np.floor(float(p.get("high_threshold", 150))))
    if low > high:
        low, high = high, low
    ap = int(p.get("aperture_size", 3))
    return ({"aperture_size": ap}, {"low": np.int32(low), "high": np.int32(high)})


register_op(
    "segmentation.edge",
    golden_fn=edge_np,
    device_fn=edge_j,
    split=_edge_split,
    halo=lambda p: int(p.get("aperture_size", 3)) // 2 + 2,
    global_stats=True,  # hysteresis is a global reachability
)


# ---------------------------------------------------------------------------
# Watershed (core/segmentation.py:96-114)


def watershed_np(
    image,
    kernel_size: int = 3,
    opening_iterations: int = 2,
    dilation_iterations: int = 3,
    distance_threshold_factor: float = 0.7,
):
    from yamimageprocessor_tpu.ops.labeling import label_np

    gray = C.bgr_to_gray_np(image)
    thresh = T.binary_np(gray, T.otsu_threshold_np(gray), inverse=True)
    se = np.ones((int(kernel_size), int(kernel_size)), np.uint8)
    opening = M.open_np(thresh, se, int(opening_iterations))
    sure_bg = M.dilate_np(opening, se, int(dilation_iterations))
    dist = DI.distance_transform_np(opening)
    thr = np.float32(distance_threshold_factor) * dist.max()
    sure_fg = np.where(dist > thr, np.uint8(255), np.uint8(0))
    unknown = np.maximum(sure_bg.astype(np.int16) - sure_fg.astype(np.int16), 0).astype(
        np.uint8
    )
    markers = label_np(sure_fg > 0) + 1
    markers[unknown == 255] = 0
    labels = W.watershed_np(image, markers)
    return W.paint_boundaries_np(image, labels)


def watershed_seg_j(
    img,
    dyn,
    *,
    kernel_size: int = 3,
    opening_iterations: int = 2,
    dilation_iterations: int = 3,
):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.labeling import label_j

    gray = C.bgr_to_gray_j(img)
    thresh = T.binary_j(gray, T.otsu_threshold_j(gray), inverse=True)
    se = np.ones((int(kernel_size), int(kernel_size)), np.uint8)
    opening = M.open_j(thresh, se, int(opening_iterations))
    sure_bg = M.dilate_j(opening, se, int(dilation_iterations))
    dist = DI.distance_transform_j(opening)
    thr = dyn["factor"] * dist.max()
    sure_fg = jnp.where(dist > thr, jnp.uint8(255), jnp.uint8(0))
    unknown = jnp.maximum(
        sure_bg.astype(jnp.int16) - sure_fg.astype(jnp.int16), 0
    ).astype(jnp.uint8)
    markers = label_j(sure_fg > 0) + 1
    markers = jnp.where(unknown == 255, 0, markers)
    labels = W.watershed_j(img, markers)
    return W.paint_boundaries_j(img, labels)


def watershed_sharded(img, dyn, *, axis: str, **static):
    from yamimageprocessor_tpu.ops.watershed_sharded import watershed_sharded_j

    return watershed_sharded_j(img, dyn, axis=axis, **static)


register_op(
    "segmentation.watershed",
    golden_fn=watershed_np,
    device_fn=watershed_seg_j,
    split=lambda p: (
        {
            "kernel_size": int(p.get("kernel_size", 3)),
            "opening_iterations": int(p.get("opening_iterations", 2)),
            "dilation_iterations": int(p.get("dilation_iterations", 3)),
        },
        {"factor": np.float32(p.get("distance_threshold_factor", 0.7))},
    ),
    global_stats=True,
    sharded_device_fn=watershed_sharded,
)


# ---------------------------------------------------------------------------
# Sobel / Prewitt / Laplacian (core/segmentation.py:150-169)


def sobel_op_np(image, ksize: int = 3):
    return E.sobel_np(C.bgr_to_gray_np(image), int(ksize))


def sobel_op_j(img, dyn, *, ksize: int = 3):
    return E.sobel_j(C.bgr_to_gray_j(img), ksize)


register_op(
    "segmentation.sobel",
    golden_fn=sobel_op_np,
    device_fn=sobel_op_j,
    split=lambda p: ({"ksize": int(p.get("ksize", 3))}, {}),
    halo=lambda p: int(p.get("ksize", 3)) // 2,
)


def prewitt_op_np(image):
    return E.prewitt_np(C.bgr_to_gray_np(image))


def prewitt_op_j(img, dyn):
    return E.prewitt_j(C.bgr_to_gray_j(img))


register_op(
    "segmentation.prewitt",
    golden_fn=prewitt_op_np,
    device_fn=prewitt_op_j,
    split=lambda p: ({}, {}),
    halo=1,
)


def laplacian_op_np(image, ksize: int = 3):
    return E.laplacian_np(C.bgr_to_gray_np(image), int(ksize))


def laplacian_op_j(img, dyn, *, ksize: int = 3):
    return E.laplacian_j(C.bgr_to_gray_j(img), ksize)


register_op(
    "segmentation.laplacian",
    golden_fn=laplacian_op_np,
    device_fn=laplacian_op_j,
    split=lambda p: ({"ksize": int(p.get("ksize", 3))}, {}),
    halo=lambda p: max(int(p.get("ksize", 3)) // 2, 1),
)


# ---------------------------------------------------------------------------
# Region growing (core/segmentation.py:171-175)


def region_growing_np(image, seed=(50, 50), tolerance: int = 10):
    gray = C.bgr_to_gray_np(image).copy()
    return GR.region_growing_np(gray, seed, int(tolerance))


def region_growing_j(img, dyn):
    gray = C.bgr_to_gray_j(img)
    return GR.region_growing_j_dyn(gray, dyn["seed_x"], dyn["seed_y"], dyn["tol"])


register_op(
    "segmentation.region_growing",
    golden_fn=region_growing_np,
    device_fn=region_growing_j,
    split=lambda p: (
        {},
        {
            "seed_x": np.int32(p.get("seed", (50, 50))[0]),
            "seed_y": np.int32(p.get("seed", (50, 50))[1]),
            "tol": np.int32(p.get("tolerance", 10)),
        },
    ),
    global_stats=True,
)


# ---------------------------------------------------------------------------
# Region splitting/merging (core/segmentation.py:177-193)


def region_split_merge_np(image, min_size: int = 16, std_thresh: float = 10.0):
    gray = C.bgr_to_gray_np(image)
    return SM.region_split_merge_np(gray, int(min_size), float(std_thresh))


def region_split_merge_j(img, dyn):
    gray = C.bgr_to_gray_j(img)
    return SM.region_split_merge_j_dyn(gray, dyn["min_size"], dyn["std_thresh"])


register_op(
    "segmentation.region_split_merge",
    golden_fn=region_split_merge_np,
    device_fn=region_split_merge_j,
    split=lambda p: (
        {},
        {
            "min_size": np.int32(p.get("min_size", 16)),
            "std_thresh": np.float32(p.get("std_thresh", 10.0)),
        },
    ),
    global_stats=True,
)


# ---------------------------------------------------------------------------
# K-Means (core/segmentation.py:125-138)

_KM_ATTEMPTS = 10
_KM_ITERS = 10


def kmeans_np(image, K_: int = None, seed: int = 42, **kw):
    k = int(kw.get("K", 2 if K_ is None else K_))
    img = C.gray_to_bgr_np(image) if image.ndim == 2 else image
    data = img.reshape(-1, 3).astype(np.float32)
    labels, centers = CL.kmeans_np(data, k, int(seed), _KM_ATTEMPTS, _KM_ITERS)
    centers_u8 = centers.astype(np.uint8)  # truncation (line 133)
    seg = centers_u8[labels].reshape(img.shape)
    gray = C.bgr_to_gray_np(seg)
    return T.binary_np(gray, T.otsu_threshold_np(gray))


def kmeans_seg_j(img, dyn, *, K: int = 2):
    import jax.numpy as jnp

    img3 = C.gray_to_bgr_j(img) if img.ndim == 2 else img
    data = img3.reshape(-1, 3).astype(jnp.float32)
    labels, centers = CL.kmeans_j(data, dyn["init_u"], _KM_ITERS)
    centers_u8 = centers.astype(jnp.uint8)
    seg = centers_u8[labels].reshape(img3.shape)
    gray = C.bgr_to_gray_j(seg)
    return T.binary_j(gray, T.otsu_threshold_j(gray))


register_op(
    "segmentation.kmeans",
    golden_fn=kmeans_np,
    device_fn=kmeans_seg_j,
    split=lambda p: (
        {"K": int(p.get("K", 2))},
        {
            "init_u": CL.kmeans_init_uniform(
                int(p.get("K", 2)), 3, int(p.get("seed", 42)), _KM_ATTEMPTS
            )
        },
    ),
    global_stats=True,
)


# ---------------------------------------------------------------------------
# Fuzzy C-Means (core/segmentation.py:195-207)


def fcm_np(image, K_: int = None, seed: int = 42, **kw):
    k = int(kw.get("K", 2 if K_ is None else K_))
    gray = C.bgr_to_gray_np(image).astype(np.float32)
    data = gray.ravel() / np.float32(255.0)
    u0 = CL.fcm_init_u(data.size, k, int(seed))
    cntr, u = CL.fcm_np(data, u0)
    labels = np.argmax(u, axis=0)
    centers = (cntr * 255).astype(np.float32)
    seg = centers[labels].reshape(gray.shape)
    seg_u8 = seg.astype(np.uint8)  # truncation (line 206)
    return T.binary_np(seg_u8, T.otsu_threshold_np(seg_u8))


def fcm_seg_j(img, dyn, *, K: int = 2):
    import jax.numpy as jnp

    gray = C.bgr_to_gray_j(img).astype(jnp.float32)
    data = gray.ravel() / jnp.float32(255.0)
    cntr, u = CL.fcm_j(data, dyn["u0"])
    labels = jnp.argmax(u, axis=0)
    centers = (cntr * 255).astype(jnp.float32)
    seg = centers[labels].reshape(gray.shape)
    seg_u8 = seg.astype(jnp.uint8)
    return T.binary_j(seg_u8, T.otsu_threshold_j(seg_u8))


def _fcm_split(p: Mapping[str, Any], shape=None):
    k = int(p.get("K", 2))
    n = int(np.prod(shape[:2])) if shape is not None else 0
    return ({"K": k}, {"u0": CL.fcm_init_u(n, k, int(p.get("seed", 42)))})


register_op(
    "segmentation.fuzzy_cmeans",
    golden_fn=fcm_np,
    device_fn=fcm_seg_j,
    split=_fcm_split,
    global_stats=True,
)


# ---------------------------------------------------------------------------
# Mean shift (core/segmentation.py:209-213)


def mean_shift_np(image, spatial_radius: int = 20, color_radius: int = 30):
    shifted = MS.mean_shift_np(image, int(spatial_radius), int(color_radius))
    gray = C.bgr_to_gray_np(shifted)
    return T.binary_np(gray, T.otsu_threshold_np(gray))


def mean_shift_seg_j(img, dyn, *, spatial_radius: int = 20):
    gray_in = img
    shifted = MS.mean_shift_j(gray_in, spatial_radius, dyn["color_radius"])
    gray = C.bgr_to_gray_j(shifted)
    return T.binary_j(gray, T.otsu_threshold_j(gray))


register_op(
    "segmentation.mean_shift",
    golden_fn=mean_shift_np,
    device_fn=mean_shift_seg_j,
    split=lambda p: (
        {"spatial_radius": int(p.get("spatial_radius", 20))},
        {"color_radius": np.int32(p.get("color_radius", 30))},
    ),
    halo=lambda p: int(p.get("spatial_radius", 20)) * 5,
    global_stats=True,
)


# ---------------------------------------------------------------------------
# GMM (core/segmentation.py:215-235)

_GMM_ITERS = 50


def gmm_np(image, components: int = 2, seed: int = 42):
    img = C.gray_to_bgr_np(image) if image.ndim == 2 else image
    h, w, c = img.shape
    X = img.reshape(-1, c).astype(np.float32)
    u = CL.kmeans_init_uniform(int(components), c, int(seed), 1)[0]
    init_means = CL.scale_inits_np(u, X)
    labels, _ = CL.gmm_np(X, init_means, _GMM_ITERS)
    means = []
    for i in range(int(components)):
        sel = X[labels == i]
        if len(sel) > 0:
            mc = sel.mean(axis=0)
            means.append(0.114 * mc[0] + 0.587 * mc[1] + 0.299 * mc[2])
        else:
            means.append(0.0)
    seg = np.asarray(means, dtype=np.float64)[labels].reshape(h, w)
    seg_u8 = seg.astype(np.uint8)
    return T.binary_np(seg_u8, T.otsu_threshold_np(seg_u8))


def gmm_seg_j(img, dyn, *, components: int = 2):
    import jax
    import jax.numpy as jnp

    img3 = C.gray_to_bgr_j(img) if img.ndim == 2 else img
    h, w, c = img3.shape
    X = img3.reshape(-1, c).astype(jnp.float32)
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    init_means = lo + dyn["init_u"] * (hi - lo)
    labels, _ = CL.gmm_j(X, init_means, _GMM_ITERS)
    onehot = jax.nn.one_hot(labels, components, dtype=jnp.float32)
    counts = onehot.sum(0)
    sums = jnp.matmul(onehot.T, X, precision=jax.lax.Precision.HIGHEST)
    means = sums / jnp.maximum(counts[:, None], 1.0)
    lum = 0.114 * means[:, 0] + 0.587 * means[:, 1] + 0.299 * means[:, 2]
    lum = jnp.where(counts > 0, lum, 0.0)
    seg = lum[labels].reshape(h, w)
    seg_u8 = seg.astype(jnp.uint8)
    return T.binary_j(seg_u8, T.otsu_threshold_j(seg_u8))


register_op(
    "segmentation.gmm",
    golden_fn=gmm_np,
    device_fn=gmm_seg_j,
    split=lambda p: (
        {"components": int(p.get("components", 2))},
        {
            "init_u": CL.kmeans_init_uniform(
                int(p.get("components", 2)), 3, int(p.get("seed", 42)), 1
            )[0]
        },
    ),
    global_stats=True,
)


# ---------------------------------------------------------------------------
# Graph cuts (core/segmentation.py:237-247)


def graph_cuts_np(image):
    result = GC.grabcut_mask_image_np(image)
    gray = C.bgr_to_gray_np(result)
    return T.binary_np(gray, T.otsu_threshold_np(gray))


def graph_cuts_j(image, dyn):
    """Device path: same composition (grabcut mask -> gray -> Otsu binary);
    the GrabCut color models are a weighted fixed-shape fit, so this agrees
    with the golden structurally ("sem" parity class, like the clustering
    ops), not bit-for-bit."""

    result = GC.grabcut_mask_image_j(image)
    gray = C.bgr_to_gray_j(result) if result.ndim == 3 else result
    return T.binary_j(gray, T.otsu_threshold_j(gray))


register_op(
    "segmentation.graph_cuts",
    golden_fn=graph_cuts_np,
    device_fn=graph_cuts_j,
    split=lambda params: ({}, {}),
    jittable=True,
    global_stats=True,
)


# ---------------------------------------------------------------------------
# Active contour (core/segmentation.py:249-260) — host slow-path op


def active_contour_np(
    image,
    iterations: int = 250,
    alpha: float = 0.015,
    beta: float = 10.0,
    gamma: float = 0.001,
):
    from yamimageprocessor_tpu.utils.annotate import draw_polyline

    gray = C.bgr_to_gray_np(image)
    pts = SN.evolve_snake_np(gray, int(iterations), float(alpha), float(beta), float(gamma))
    out = image.copy()
    draw_polyline(out, np.rint(pts).astype(np.int64), (0, 255, 0), 2, closed=True)
    return out


def _active_contour_split(params: Mapping[str, Any], shape=None):
    iterations = int(params.get("iterations", 250))
    alpha = float(params.get("alpha", 0.015))
    beta = float(params.get("beta", 10.0))
    gamma = float(params.get("gamma", 0.001))
    # the pentadiagonal inverse depends only on the (dynamic) energy params,
    # so it travels as data: retuning alpha/beta/gamma never recompiles
    inv = SN.snake_matrix_inv(SN.N_POINTS, alpha, beta, gamma)
    return (
        {"iterations": iterations},
        {"inv": inv, "gamma": np.float32(gamma)},
    )


def active_contour_j(image, dyn, *, iterations: int = 250):
    """Device path: energy + snake evolution (lax.scan) + capsule-distance
    polyline overlay, all jittable.  The overlay rasterization differs from
    the host Bresenham stamp at corner pixels ("sem" class); the evolved
    contour itself follows the identical update rule."""

    import jax.numpy as jnp

    gray = C.bgr_to_gray_j(image) if image.ndim == 3 else image
    energy = SN.energy_j(gray)
    gy, gx = SN._gradient_j(energy)
    init = jnp.asarray(SN.initial_circle(gray.shape))
    pts = SN.evolve_snake_j(gx, gy, dyn["inv"], init, int(iterations), dyn["gamma"])
    pts = jnp.rint(pts)
    return SN.draw_closed_polyline_j(image, pts, (0, 255, 0), radius=1.0)


register_op(
    "segmentation.active_contour",
    golden_fn=active_contour_np,
    device_fn=active_contour_j,
    split=_active_contour_split,
    jittable=True,
    global_stats=True,
)


# ---------------------------------------------------------------------------
# Morphology quartet (core/segmentation.py:262-314)


def _register_morph(identifier: str, np_fn, j_fn, sharded_name: str):
    def golden(image, kernel_shape: str = "Rectangular", kernel_size: int = 3, iterations: int = 1):
        se = M.make_se(kernel_shape, int(kernel_size))
        return np_fn(image, se, int(iterations))

    def device(img, dyn, *, kernel_shape: str = "Rectangular", kernel_size: int = 3, iterations: int = 1):
        se = M.make_se(kernel_shape, int(kernel_size))
        return j_fn(img, se, int(iterations))

    def sharded(img, dyn, *, axis: str, kernel_shape: str = "Rectangular",
                kernel_size: int = 3, iterations: int = 1):
        # per-phase border fills (erode: dtype max, dilate: dtype min) make
        # sharded morphology bit-exact at TRUE frame edges, which the
        # generic mirror-halo path cannot (cv2 pads with extremes)
        from yamimageprocessor_tpu.ops import watershed_sharded as WS

        se = M.make_se(kernel_shape, int(kernel_size))
        fn = getattr(WS, sharded_name)
        return fn(img, se, int(iterations), axis)

    register_op(
        identifier,
        golden_fn=golden,
        device_fn=device,
        sharded_device_fn=sharded,
        split=lambda p: (
            {
                "kernel_shape": str(p.get("kernel_shape", "Rectangular")),
                "kernel_size": int(p.get("kernel_size", 3)),
                "iterations": int(p.get("iterations", 1)),
            },
            {},
        ),
        halo=lambda p: (int(p.get("kernel_size", 3)) // 2)
        * max(int(p.get("iterations", 1)), 1)
        * 2,  # open/close = 2 sub-passes
    )


_register_morph("segmentation.opening", M.open_np, M.open_j, "open_sharded_j")
_register_morph("segmentation.closing", M.close_np, M.close_j, "close_sharded_j")
_register_morph("segmentation.dilation", M.dilate_np, M.dilate_j, "dilate_sharded_j")
_register_morph("segmentation.erosion", M.erode_np, M.erode_j, "erode_sharded_j")


# ---------------------------------------------------------------------------
# Border removal (core/segmentation.py:316-325)


def border_removal_np(image, border_distance: int = 25):
    d = int(border_distance)
    h, w = image.shape[:2]
    yy, xx = np.mgrid[:h, :w]
    inside = (yy >= d) & (yy < h - d) & (xx >= d) & (xx < w - d)
    out = image.copy()
    out[~inside] = 0
    return out


def border_removal_j(img, dyn):
    import jax
    import jax.numpy as jnp

    d = dyn["border_distance"]
    h, w = img.shape[:2]
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (yy >= d) & (yy < h - d) & (xx >= d) & (xx < w - d)
    if img.ndim == 3:
        inside = inside[..., None]
    return jnp.where(inside, img, 0)


register_op(
    "segmentation.border_removal",
    golden_fn=border_removal_np,
    device_fn=border_removal_j,
    split=lambda p: ({}, {"border_distance": np.int32(p.get("border_distance", 25))}),
)
