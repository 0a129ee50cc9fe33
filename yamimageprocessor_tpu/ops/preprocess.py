"""The 8 preprocessing ops: numpy golden twins + jittable device functions.

Reference kernels: ``core/preprocessing.py:50-151`` (cv2-based); module
wrappers ``modules/preprocessing.py:41-277``.  Every op is a pure function
pair registered in :mod:`yamimageprocessor_tpu.ops.registry`:

* golden — numpy float32/int semantics (the framework's CPU reference path;
  validated against cv2 in the parity suite);
* device — jnp, shape/params-static structure with host-precomputed LUTs and
  filter taps arriving as dynamic inputs (no recompile on parameter tweaks).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from yamimageprocessor_tpu.ops import _kernels as K
from yamimageprocessor_tpu.ops import color as C
from yamimageprocessor_tpu.ops import filters as F
from yamimageprocessor_tpu.ops.registry import register_op

# ---------------------------------------------------------------------------
# Grayscale (core/preprocessing.py:53-57)


def grayscale_np(image: np.ndarray) -> np.ndarray:
    return C.bgr_to_gray_np(image)


def grayscale_j(img, dyn):
    return C.bgr_to_gray_j(img)


register_op(
    "preprocessing.grayscale",
    golden_fn=grayscale_np,
    device_fn=grayscale_j,
    split=lambda params: ({}, {}),
)


# ---------------------------------------------------------------------------
# Brightness / contrast (core/preprocessing.py:59-63: cv2.convertScaleAbs)


def brightness_contrast_np(image: np.ndarray, alpha: float = 1.0, beta: float = 0.0):
    if alpha <= 0:
        raise ValueError("Alpha must be > 0")
    scaled = image.astype(np.float32) * np.float32(alpha) + np.float32(beta)
    return F.to_uint8_np(np.abs(scaled))


def brightness_contrast_j(img, dyn):
    import jax.numpy as jnp

    scaled = img.astype(jnp.float32) * dyn["alpha"] + dyn["beta"]
    return F.to_uint8_j(jnp.abs(scaled))


def brightness_contrast_lut_j(img, dyn):
    """(256,) table of the uint8 action — per level v the arithmetic is
    identical to :func:`brightness_contrast_j` on a pixel of value v, so
    table application is exact."""

    import jax.numpy as jnp

    del img
    levels = jnp.arange(256, dtype=jnp.float32)
    return F.to_uint8_j(jnp.abs(levels * dyn["alpha"] + dyn["beta"]))


register_op(
    "preprocessing.brightness_contrast",
    golden_fn=brightness_contrast_np,
    device_fn=brightness_contrast_j,
    split=lambda params: (
        {},
        {
            "alpha": np.float32(params.get("alpha", 1.0)),
            "beta": np.float32(params.get("beta", 0.0)),
        },
    ),
    lut_fn=brightness_contrast_lut_j,
)


# ---------------------------------------------------------------------------
# Gamma LUT (core/preprocessing.py:65-71)


def gamma_np(image: np.ndarray, value: float = 1.0) -> np.ndarray:
    if value <= 0:
        raise ValueError("Gamma must be > 0")
    return K.gamma_lut(value)[image]


def gamma_j(img, dyn):
    from yamimageprocessor_tpu.ops.lutops import apply_lut_j

    return apply_lut_j(img, dyn["lut"])


register_op(
    "preprocessing.gamma",
    golden_fn=gamma_np,
    device_fn=gamma_j,
    split=lambda params: ({}, {"lut": K.gamma_lut(float(params.get("value", 1.0)))}),
    lut_fn=lambda img, dyn: dyn["lut"],
)


# ---------------------------------------------------------------------------
# Histogram equalization (core/preprocessing.py:73-79)


def _equalize_gray_np(gray: np.ndarray) -> np.ndarray:
    hist = np.bincount(gray.ravel(), minlength=256)
    return K.equalize_lut(hist)[gray]


def histeq_np(image: np.ndarray) -> np.ndarray:
    if image.ndim == 2:
        return _equalize_gray_np(image)
    ycrcb = C.bgr_to_ycrcb_np(image)
    ycrcb[..., 0] = _equalize_gray_np(ycrcb[..., 0])
    return C.ycrcb_to_bgr_np(ycrcb)


def _exact_div255_f32(b):
    """Correctly-rounded (IEEE RN) float32 ``255 / b`` for positive b.

    A device's fast divide can be 1 ulp off IEEE; the host (and cv2) divide
    is correctly rounded, and a 1-ulp difference in the equalization scale
    flips ``rint`` ties in the LUT.  Pick the candidate around the hardware
    quotient whose exact residual ``255 - q*b`` (Dekker two-product, exact
    in f32 adds/muls) is smallest, tie-breaking to the even mantissa —
    which is the definition of the correctly rounded quotient.
    """

    import jax
    import jax.numpy as jnp

    a = jnp.float32(255.0)
    b = b.astype(jnp.float32)
    q0 = a / b
    bits = jax.lax.bitcast_convert_type(q0, jnp.int32)

    def residual(q):
        # Dekker two-product: q*b = p + e exactly
        C = jnp.float32(4097.0)  # 2**12 + 1 splitter for f32
        pq = q * C
        hq = pq - (pq - q)
        tq = q - hq
        pb = b * C
        hb = pb - (pb - b)
        tb = b - hb
        p = q * b
        e = ((hq * hb - p) + hq * tb + tq * hb) + tq * tb
        return (a - p) - e  # a - p is exact by Sterbenz (p within [a/2, 2a])

    offsets = jnp.arange(-2, 3, dtype=jnp.int32)
    cands = jax.lax.bitcast_convert_type(bits + offsets, jnp.float32)
    res = jax.vmap(residual)(cands)
    absres = jnp.abs(res)
    best = jnp.min(absres)
    # ties (exact half-ulp residue on both neighbours) resolve to the even
    # mantissa, matching IEEE round-to-nearest-even
    is_best = absres == best
    even = ((bits + offsets) & 1) == 0
    score = is_best.astype(jnp.int32) * 2 + (is_best & even).astype(jnp.int32)
    return cands[jnp.argmax(score)]


def equalization_lut_j(hist):
    """cv2.equalizeHist LUT from a (256,) histogram (bit-exact: the 255/rem
    divide is correctly rounded via :func:`_exact_div255_f32`)."""

    import jax.numpy as jnp

    total = jnp.sum(hist)
    nonzero = hist > 0
    first = jnp.argmax(nonzero)
    cumsum = jnp.cumsum(hist)
    remainder = total - hist[first]
    safe_rem = jnp.maximum(remainder, 1)
    scale = _exact_div255_f32(safe_rem.astype(jnp.float32))
    lut_f = (cumsum - cumsum[first]).astype(jnp.float32) * scale
    lut = jnp.clip(jnp.rint(lut_f), 0, 255).astype(jnp.uint8)
    idx = jnp.arange(256)
    lut = jnp.where(idx <= first, jnp.uint8(0), lut)
    # constant image: cv2 leaves it untouched (identity LUT)
    lut = jnp.where(remainder == 0, idx.astype(jnp.uint8), lut)
    return lut


def _equalize_lut_from_image_j(gray):
    """The (256,) equalization table :func:`_equalize_gray_j` applies —
    exposed for the chain compiler's LUT-run composition."""

    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    return equalization_lut_j(histogram256_j(gray))


def _equalize_gray_j(gray):
    from yamimageprocessor_tpu.ops.lutops import apply_lut_j

    return apply_lut_j(gray, _equalize_lut_from_image_j(gray))


def histeq_j(img, dyn):
    import jax.numpy as jnp

    if img.ndim == 2:
        return _equalize_gray_j(img)
    ycrcb = C.bgr_to_ycrcb_j(img)
    y = _equalize_gray_j(ycrcb[..., 0])
    ycrcb = ycrcb.at[..., 0].set(y)
    return C.ycrcb_to_bgr_j(ycrcb)


def _equalize_gray_sharded_j(gray, axis: str):
    """Histogram equalization over a spatially sharded frame: local
    histogram + psum over the mesh axis, identical LUT math."""

    import jax

    from yamimageprocessor_tpu.ops.lutops import apply_lut_j, histogram256_j

    hist = jax.lax.psum(histogram256_j(gray), axis)
    return apply_lut_j(gray, equalization_lut_j(hist))


def histeq_sharded_j(img, dyn, *, axis: str):
    if img.ndim == 2:
        return _equalize_gray_sharded_j(img, axis)
    ycrcb = C.bgr_to_ycrcb_j(img)
    y = _equalize_gray_sharded_j(ycrcb[..., 0], axis)
    ycrcb = ycrcb.at[..., 0].set(y)
    return C.ycrcb_to_bgr_j(ycrcb)


def histeq_tile_stats_j(tile, dyn):
    """Streaming stats pass: per-tile histogram of the equalized channel."""

    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    channel = tile if tile.ndim == 2 else C.bgr_to_ycrcb_j(tile)[..., 0]
    return histogram256_j(channel)


def histeq_apply_stats_j(tile, stats, dyn):
    """Streaming apply pass: pointwise LUT from the global histogram."""

    from yamimageprocessor_tpu.ops.lutops import apply_lut_j

    lut = equalization_lut_j(stats)
    if tile.ndim == 2:
        return apply_lut_j(tile, lut)
    ycrcb = C.bgr_to_ycrcb_j(tile)
    ycrcb = ycrcb.at[..., 0].set(apply_lut_j(ycrcb[..., 0], lut))
    return C.ycrcb_to_bgr_j(ycrcb)


register_op(
    "preprocessing.histogram_equalization",
    golden_fn=histeq_np,
    device_fn=histeq_j,
    split=lambda params: ({}, {}),
    global_stats=True,
    sharded_device_fn=histeq_sharded_j,
    tile_stats_fn=histeq_tile_stats_j,
    merge_stats_fn=lambda a, b: a + b,
    apply_stats_fn=histeq_apply_stats_j,
    # gray equalization IS a stats-derived LUT; the color path (YCrCb
    # luma round-trip) is not, hence the ndim gate
    lut_fn=lambda img, dyn: _equalize_lut_from_image_j(img),
    lut_needs_image=True,
    lut_ndims=(2,),
    stats_lut_fn=lambda stats, dyn: equalization_lut_j(stats),
)


# ---------------------------------------------------------------------------
# CLAHE (extension; cv2.createCLAHE semantics, bit-exact)


def clahe_op_np(image, clip_limit: float = 40.0, grid_size: int = 8):
    from yamimageprocessor_tpu.ops.clahe import clahe_np

    grid = (int(grid_size), int(grid_size))
    if image.ndim == 2:
        return clahe_np(image, float(clip_limit), grid)
    ycrcb = C.bgr_to_ycrcb_np(image)
    ycrcb[..., 0] = clahe_np(ycrcb[..., 0], float(clip_limit), grid)
    return C.ycrcb_to_bgr_np(ycrcb)


def clahe_op_j(img, dyn, *, clip_limit: float = 40.0, grid_size: int = 8):
    from yamimageprocessor_tpu.ops.clahe import clahe_j

    grid = (int(grid_size), int(grid_size))
    if img.ndim == 2:
        return clahe_j(img, clip_limit=float(clip_limit), grid=grid)
    ycrcb = C.bgr_to_ycrcb_j(img)
    y = clahe_j(ycrcb[..., 0], clip_limit=float(clip_limit), grid=grid)
    ycrcb = ycrcb.at[..., 0].set(y)
    return C.ycrcb_to_bgr_j(ycrcb)


def clahe_op_sharded_j(
    img, dyn, *, axis: str, clip_limit: float = 40.0, grid_size: int = 8
):
    """Collective CLAHE over a row-sharded frame (psum'd grid histograms,
    shared LUT math — see ``ops/clahe.py:clahe_sharded_j``)."""

    from yamimageprocessor_tpu.ops.clahe import clahe_sharded_j

    grid = (int(grid_size), int(grid_size))
    if img.ndim == 2:
        return clahe_sharded_j(
            img, clip_limit=float(clip_limit), grid=grid, axis=axis
        )
    ycrcb = C.bgr_to_ycrcb_j(img)
    y = clahe_sharded_j(
        ycrcb[..., 0], clip_limit=float(clip_limit), grid=grid, axis=axis
    )
    ycrcb = ycrcb.at[..., 0].set(y)
    return C.ycrcb_to_bgr_j(ycrcb)


def clahe_tile_stats_j(
    tile, dyn, *, clip_limit: float = 40.0, grid_size: int = 8, box=None, frame_shape=None
):
    """Streaming stats pass: per-grid-cell histogram contributions of one
    stream tile (ops/clahe.py:clahe_grid_hist_tile_j); color tiles
    contribute their YCrCb luma exactly as the dense path equalizes it."""

    from yamimageprocessor_tpu.ops.clahe import clahe_grid_hist_tile_j

    grid = (int(grid_size), int(grid_size))
    gray = C.bgr_to_ycrcb_j(tile)[..., 0] if tile.ndim == 3 else tile
    return clahe_grid_hist_tile_j(
        gray, grid=grid, frame_shape=frame_shape, box=box
    )


def clahe_apply_stats_j(
    tile, stats, dyn, *, clip_limit: float = 40.0, grid_size: int = 8, box=None, frame_shape=None
):
    from yamimageprocessor_tpu.ops.clahe import clahe_apply_from_hist_j

    grid = (int(grid_size), int(grid_size))
    kw = dict(
        clip_limit=float(clip_limit), grid=grid, frame_shape=frame_shape, box=box
    )
    if tile.ndim == 2:
        return clahe_apply_from_hist_j(tile, stats, **kw)
    ycrcb = C.bgr_to_ycrcb_j(tile)
    y = clahe_apply_from_hist_j(ycrcb[..., 0], stats, **kw)
    ycrcb = ycrcb.at[..., 0].set(y)
    return C.ycrcb_to_bgr_j(ycrcb)


def clahe_stream_gate_op(static, frame_shape) -> bool:
    from yamimageprocessor_tpu.ops.clahe import clahe_stream_gate

    return clahe_stream_gate(int(static.get("grid_size", 8)), frame_shape)


register_op(
    "preprocessing.clahe",
    golden_fn=clahe_op_np,
    device_fn=clahe_op_j,
    split=lambda p: (
        {
            "clip_limit": float(p.get("clip_limit", 40.0)),
            "grid_size": int(p.get("grid_size", 8)),
        },
        {},
    ),
    global_stats=True,  # tile grid spans the frame
    sharded_device_fn=clahe_op_sharded_j,
    tile_stats_fn=clahe_tile_stats_j,
    merge_stats_fn=lambda a, b: a + b,
    apply_stats_fn=clahe_apply_stats_j,
    stream_gate=clahe_stream_gate_op,
)


# ---------------------------------------------------------------------------
# Intensity normalization (core/preprocessing.py:93-95: cv2 NORM_MINMAX)


def normalize_np(image: np.ndarray, alpha: float = 0.0, beta: float = 255.0):
    smin = np.float32(image.min())
    smax = np.float32(image.max())
    lo = np.float32(min(alpha, beta))
    hi = np.float32(max(alpha, beta))
    span = smax - smin
    scale = (hi - lo) / span if span > 0 else np.float32(0.0)
    shift = lo - smin * scale
    out = image.astype(np.float32) * scale + shift
    if image.dtype == np.uint8:
        return F.to_uint8_np(out)
    return out.astype(image.dtype)


def normalize_j(img, dyn):
    import jax.numpy as jnp

    smin = jnp.min(img).astype(jnp.float32)
    smax = jnp.max(img).astype(jnp.float32)
    lo = jnp.minimum(dyn["alpha"], dyn["beta"])
    hi = jnp.maximum(dyn["alpha"], dyn["beta"])
    span = smax - smin
    scale = jnp.where(span > 0, (hi - lo) / jnp.where(span > 0, span, 1.0), 0.0)
    shift = lo - smin * scale
    out = img.astype(jnp.float32) * scale + shift
    if img.dtype == jnp.uint8:
        return F.to_uint8_j(out)
    return out.astype(img.dtype)


def normalize_sharded_j(img, dyn, *, axis: str):
    import jax
    import jax.numpy as jnp

    smin = jax.lax.pmin(jnp.min(img).astype(jnp.float32), axis)
    smax = jax.lax.pmax(jnp.max(img).astype(jnp.float32), axis)
    lo = jnp.minimum(dyn["alpha"], dyn["beta"])
    hi = jnp.maximum(dyn["alpha"], dyn["beta"])
    span = smax - smin
    scale = jnp.where(span > 0, (hi - lo) / jnp.where(span > 0, span, 1.0), 0.0)
    shift = lo - smin * scale
    out = img.astype(jnp.float32) * scale + shift
    if img.dtype == np.uint8:
        return F.to_uint8_j(out)
    return out.astype(img.dtype)


def normalize_tile_stats_j(tile, dyn):
    import jax.numpy as jnp

    return jnp.stack(
        [jnp.min(tile).astype(jnp.float32), jnp.max(tile).astype(jnp.float32)]
    )


def normalize_merge_stats_j(a, b):
    import jax.numpy as jnp

    return jnp.stack([jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1])])


def normalize_apply_stats_j(tile, stats, dyn):
    import jax.numpy as jnp

    smin, smax = stats[0], stats[1]
    lo = jnp.minimum(dyn["alpha"], dyn["beta"])
    hi = jnp.maximum(dyn["alpha"], dyn["beta"])
    span = smax - smin
    scale = jnp.where(span > 0, (hi - lo) / jnp.where(span > 0, span, 1.0), 0.0)
    shift = lo - smin * scale
    out = tile.astype(jnp.float32) * scale + shift
    if tile.dtype == np.uint8:
        return F.to_uint8_j(out)
    return out.astype(tile.dtype)


def normalize_stats_lut_j(stats, dyn):
    """uint8 min-max normalize as a stats-derived 256-LUT: the same
    per-value arithmetic as :func:`normalize_apply_stats_j`, evaluated
    over the value axis once (the streaming engine composes it with
    adjacent value LUTs into one table pass)."""

    import jax.numpy as jnp

    smin, smax = stats[0], stats[1]
    lo = jnp.minimum(dyn["alpha"], dyn["beta"])
    hi = jnp.maximum(dyn["alpha"], dyn["beta"])
    span = smax - smin
    scale = jnp.where(span > 0, (hi - lo) / jnp.where(span > 0, span, 1.0), 0.0)
    shift = lo - smin * scale
    values = jnp.arange(256, dtype=jnp.float32)
    return F.to_uint8_j(values * scale + shift)


register_op(
    "preprocessing.normalize",
    golden_fn=normalize_np,
    device_fn=normalize_j,
    sharded_device_fn=normalize_sharded_j,
    split=lambda params: (
        {},
        {
            "alpha": np.float32(params.get("alpha", 0.0)),
            "beta": np.float32(params.get("beta", 255.0)),
        },
    ),
    global_stats=True,
    tile_stats_fn=normalize_tile_stats_j,
    merge_stats_fn=normalize_merge_stats_j,
    apply_stats_fn=normalize_apply_stats_j,
    stats_lut_fn=normalize_stats_lut_j,
)


# ---------------------------------------------------------------------------
# Noise reduction (core/preprocessing.py:81-91)


def _odd(ksize: int) -> int:
    ksize = int(ksize)
    return ksize + 1 if ksize % 2 == 0 else ksize


def noise_reduction_np(image: np.ndarray, method: str = "Gaussian", ksize: int = 5):
    ksize = _odd(ksize)
    if method == "Gaussian":
        taps = K.gaussian_taps(ksize, 0.0)
        out = F.sep_filter_np(image, taps, taps)
        return F.to_uint8_np(out) if image.dtype == np.uint8 else out
    if method == "Median":
        return F.median_np(image, ksize)
    if method == "Bilateral":
        out = F.bilateral_np(image, ksize, 75.0, 75.0)
        return F.to_uint8_np(out) if image.dtype == np.uint8 else out
    return image


def noise_reduction_j(img, dyn, *, method: str = "Gaussian", ksize: int = 5):
    if method == "Gaussian":
        out = F.sep_filter_j(img, dyn["taps"], dyn["taps"])
        return F.to_uint8_j(out) if img.dtype == np.uint8 else out
    if method == "Median":
        return F.median_j(img, ksize)
    if method == "Bilateral":
        out = F.bilateral_j(
            img,
            dyn["space_w"],
            dyn["color_lut"],
            offsets=dyn_offsets_for(ksize),
            ksize=ksize,
        )
        return F.to_uint8_j(out) if img.dtype == np.uint8 else out
    return img


def dyn_offsets_for(ksize: int):
    """Static (dy, dx) offsets of cv2's circular bilateral window."""

    _, mask = K.bilateral_space_weights(ksize, 75.0)
    return tuple(map(tuple, np.argwhere(mask)))


def _noise_split(params: Mapping[str, Any]):
    method = str(params.get("method", "Gaussian"))
    ksize = _odd(int(params.get("ksize", 5)))
    static = {"method": method, "ksize": ksize}
    dyn: Dict[str, Any] = {}
    if method == "Gaussian":
        dyn["taps"] = K.gaussian_taps(ksize, 0.0).astype(np.float32)
    elif method == "Bilateral":
        space_w, mask = K.bilateral_space_weights(ksize, 75.0)
        dyn["space_w"] = space_w[mask].astype(np.float32)
        # channel count is resolved at trace time; ship the 3-channel LUT
        # (a 2-D image only indexes its first 256 entries).
        dyn["color_lut"] = K.bilateral_color_weights(75.0, 3).astype(np.float32)
    return static, dyn


register_op(
    "preprocessing.noise_reduction",
    golden_fn=noise_reduction_np,
    device_fn=noise_reduction_j,
    split=_noise_split,
    halo=lambda params: max(_odd(int(params.get("ksize", 5))) // 2, 1),
)


# ---------------------------------------------------------------------------
# Sharpen / unsharp mask (core/preprocessing.py:97-100)

_SHARPEN_SIGMA = 3.0
_SHARPEN_KSIZE = K.gaussian_ksize_for_sigma(_SHARPEN_SIGMA)  # 19 for uint8


def sharpen_np(image: np.ndarray, strength: float = 1.0) -> np.ndarray:
    taps = K.gaussian_taps(_SHARPEN_KSIZE, _SHARPEN_SIGMA)
    blurred = F.sep_filter_np(image, taps, taps)
    if image.dtype == np.uint8:
        blurred = F.to_uint8_np(blurred)
    s = np.float32(strength)
    out = image.astype(np.float32) * (1 + s) - blurred.astype(np.float32) * s
    return F.to_uint8_np(out) if image.dtype == np.uint8 else out


def sharpen_j(img, dyn):
    import jax.numpy as jnp

    # the unsharp Gaussian is FIXED (sigma 3.0, 19 taps — no user sigma
    # param, core/preprocessing.py:97-100), so the taps trace as XLA
    # constants rather than runtime operands, so XLA folds the tap
    # multiplies; only `strength` stays dynamic
    taps = jnp.asarray(K.gaussian_taps(_SHARPEN_KSIZE, _SHARPEN_SIGMA), jnp.float32)
    blurred = F.sep_filter_j(img, taps, taps)
    if img.dtype == np.uint8:
        blurred = F.to_uint8_j(blurred)
    s = dyn["strength"]
    out = img.astype(jnp.float32) * (1 + s) - blurred.astype(jnp.float32) * s
    return F.to_uint8_j(out) if img.dtype == np.uint8 else out


register_op(
    "preprocessing.sharpen",
    golden_fn=sharpen_np,
    device_fn=sharpen_j,
    split=lambda params: (
        {},
        {"strength": np.float32(params.get("strength", 1.0))},
    ),
    halo=_SHARPEN_KSIZE // 2,
)


# ---------------------------------------------------------------------------
# Channel selection / mixing (core/preprocessing.py:102-121)


def select_channel_np(image: np.ndarray, value: str = "All") -> np.ndarray:
    if image.ndim == 2:
        image = C.gray_to_bgr_np(image)
    if value == "All":
        return image
    b, g, r = image[..., 0], image[..., 1], image[..., 2]
    if value == "R":
        return r.copy()
    if value == "G":
        return g.copy()
    if value == "B":
        return b.copy()
    pairs = {"RG": (r, g), "GB": (g, b), "BR": (b, r)}
    if value in pairs:
        a, b2 = pairs[value]
        # np.uint8(...) truncation, matching core/preprocessing.py:116-120
        return ((a.astype(np.float32) + b2.astype(np.float32)) / 2).astype(np.uint8)
    return image


def select_channel_j(img, dyn, *, value: str = "All"):
    import jax.numpy as jnp

    if img.ndim == 2:
        img = C.gray_to_bgr_j(img)
    if value == "All":
        return img
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    if value == "R":
        return r
    if value == "G":
        return g
    if value == "B":
        return b
    pairs = {"RG": (r, g), "GB": (g, b), "BR": (b, r)}
    if value in pairs:
        a, b2 = pairs[value]
        return ((a.astype(jnp.float32) + b2.astype(jnp.float32)) / 2).astype(jnp.uint8)
    return img


register_op(
    "preprocessing.select_channel",
    golden_fn=select_channel_np,
    device_fn=select_channel_j,
    split=lambda params: ({"value": str(params.get("value", "All"))}, {}),
)


# ---------------------------------------------------------------------------
# Crop (core/preprocessing.py:123-151; modules/preprocessing.py:226-252)


def crop_np(
    image: np.ndarray,
    x_offset: int = 0,
    y_offset: int = 0,
    width: int = 100,
    height: int = 100,
    apply_crop: bool = True,
) -> np.ndarray:
    if not apply_crop:
        from yamimageprocessor_tpu.utils.annotate import crop_overlay

        return crop_overlay(image, x_offset, y_offset, width, height)
    return image[y_offset : y_offset + height, x_offset : x_offset + width].copy()


def crop_j(
    img,
    dyn,
    *,
    x_offset: int = 0,
    y_offset: int = 0,
    width: int = 100,
    height: int = 100,
    apply_crop: bool = True,
):
    # static geometry: the result shape is resolved at trace time.
    # apply_crop=False is the PREVIEW mode (CropModule's default,
    # modules/preprocessing.py): the full frame comes back with the
    # region outlined, exactly like the golden twin — destructively
    # cropping in a preview chain desynchronizes downstream geometry
    if not apply_crop:
        return _crop_overlay_j(img, x_offset, y_offset, width, height)
    return img[y_offset : y_offset + height, x_offset : x_offset + width]


def _crop_overlay_j(img, x_offset: int, y_offset: int, width: int, height: int):
    """Device twin of ``utils.annotate.crop_overlay`` (translucent green
    fill, alpha 0.3, plus a thickness-2 border) — bit-exact vs the host:
    same inclusive corners, clamping, rint blend and uint8 cast."""

    import jax
    import jax.numpy as jnp

    h, w = img.shape[:2]
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    x0, y0 = int(x_offset), int(y_offset)
    x1, y1 = x0 + int(width), y0 + int(height)

    if img.ndim == 2:
        color = jnp.float32((0 + 255 + 0) // 3)
    else:
        color = jnp.asarray(
            np.array([0, 255, 0][: img.shape[2]], np.float32)
        )

    # translucent fill (inclusive corners, clamped)
    xa, xb = sorted((x0, x1))
    ya, yb = sorted((y0, y1))
    xa, ya = max(xa, 0), max(ya, 0)
    xb, yb = min(xb, w - 1), min(yb, h - 1)
    blended = jnp.clip(
        jnp.rint(color * np.float32(0.3) + img.astype(jnp.float32) * np.float32(0.7)),
        0,
        255,
    ).astype(jnp.uint8)
    out = img.astype(jnp.uint8)
    if xa <= xb and ya <= yb:
        fill = (rows >= ya) & (rows <= yb) & (cols >= xa) & (cols <= xb)
        out = jnp.where(fill if img.ndim == 2 else fill[..., None], blended, out)

    # border, thickness 2 (offsets {-1, 0}), cv2 clamped-segment semantics
    border = jnp.zeros((h, w), bool)
    for off in (-1, 0):
        bxa, bya, bxb, byb = x0 - off, y0 - off, x1 + off, y1 + off
        cxa, cxb = max(min(bxa, bxb), 0), min(max(bxa, bxb), w - 1)
        cya, cyb = max(min(bya, byb), 0), min(max(bya, byb), h - 1)
        if cxa > cxb or cya > cyb:
            continue
        in_x = (cols >= cxa) & (cols <= cxb)
        in_y = (rows >= cya) & (rows <= cyb)
        if 0 <= bya < h:
            border = border | (in_x & (rows == bya))
        if 0 <= byb < h:
            border = border | (in_x & (rows == byb))
        if 0 <= bxa < w:
            border = border | (in_y & (cols == bxa))
        if 0 <= bxb < w:
            border = border | (in_y & (cols == bxb))
    solid = color.astype(jnp.uint8)
    return jnp.where(border if img.ndim == 2 else border[..., None], solid, out)


def _crop_split(params: Mapping[str, Any]):
    return (
        {
            "x_offset": int(params.get("x_offset", 0)),
            "y_offset": int(params.get("y_offset", 0)),
            "width": int(params.get("width", 100)),
            "height": int(params.get("height", 100)),
            "apply_crop": bool(params.get("apply_crop", True)),
        },
        {},
    )


register_op(
    "preprocessing.crop",
    golden_fn=crop_np,
    device_fn=crop_j,
    split=_crop_split,
    reshapes=True,
)
