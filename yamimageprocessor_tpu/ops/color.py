"""Color-space conversions with OpenCV's fixed-point integer arithmetic.

The reference converts with cv2 (``core/preprocessing.py:54-57,74-79``);
cv2 computes uint8 conversions in 14-bit fixed point, so we reproduce that
arithmetic exactly in both the numpy golden path and the jnp device path —
this is what makes downstream masks bit-identical host <-> device <-> reference.

Images are channel-last BGR, matching the reference's wire convention.
"""
from __future__ import annotations

import numpy as np

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
# BGR -> luminance coefficients, 14-bit fixed point (OpenCV color.simd);
# used inside the YCrCb conversion.
_BY, _GY, _RY = 1868, 9617, 4899
# Plain BGR2GRAY in cv2 >= 5 uses 15-bit fixed point (empirically validated
# bit-exact in tests/test_kernel_constructors.py).
_GRAY_SHIFT = 15
_GRAY_HALF = 1 << (_GRAY_SHIFT - 1)
_BY15, _GY15, _RY15 = 3735, 19235, 9798
# Chroma coefficients for YCrCb: 0.713, 0.564 scaled by 2^14.
_CR = 11682
_CB = 9241
# YCrCb -> BGR: 1.403, -0.714, -0.344, 1.773 scaled by 2^14.
_C0, _C1, _C2, _C3 = 22987, -11698, -5636, 29049


def _descale(v):
    # cv2's CV_DESCALE: (v + half) >> shift with arithmetic shift.
    return (v + _HALF) >> _SHIFT


# ---------------------------------------------------------------------------
# numpy path
def bgr_to_gray_np(image: np.ndarray) -> np.ndarray:
    if image.ndim == 2:
        return image
    b = image[..., 0].astype(np.int32)
    g = image[..., 1].astype(np.int32)
    r = image[..., 2].astype(np.int32)
    return (
        (b * _BY15 + g * _GY15 + r * _RY15 + _GRAY_HALF) >> _GRAY_SHIFT
    ).astype(np.uint8)


def gray_to_bgr_np(image: np.ndarray) -> np.ndarray:
    if image.ndim == 3:
        return image
    return np.repeat(image[..., None], 3, axis=-1)


def bgr_to_ycrcb_np(image: np.ndarray) -> np.ndarray:
    b = image[..., 0].astype(np.int32)
    g = image[..., 1].astype(np.int32)
    r = image[..., 2].astype(np.int32)
    y = _descale(b * _BY + g * _GY + r * _RY)
    cr = _descale((r - y) * _CR) + 128
    cb = _descale((b - y) * _CB) + 128
    out = np.stack([y, cr, cb], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def ycrcb_to_bgr_np(image: np.ndarray) -> np.ndarray:
    y = image[..., 0].astype(np.int32)
    cr = image[..., 1].astype(np.int32) - 128
    cb = image[..., 2].astype(np.int32) - 128
    b = y + _descale(cb * _C3)
    g = y + _descale(cb * _C2 + cr * _C1)
    r = y + _descale(cr * _C0)
    out = np.stack([b, g, r], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# jnp path (identical integer arithmetic; imported lazily)
def bgr_to_gray_j(image):
    import jax.numpy as jnp

    if image.ndim == 2:
        return image
    b = image[..., 0].astype(jnp.int32)
    g = image[..., 1].astype(jnp.int32)
    r = image[..., 2].astype(jnp.int32)
    return (
        (b * _BY15 + g * _GY15 + r * _RY15 + _GRAY_HALF) >> _GRAY_SHIFT
    ).astype(jnp.uint8)


def gray_to_bgr_j(image):
    import jax.numpy as jnp

    if image.ndim == 3:
        return image
    return jnp.repeat(image[..., None], 3, axis=-1)


def bgr_to_ycrcb_j(image):
    import jax.numpy as jnp

    b = image[..., 0].astype(jnp.int32)
    g = image[..., 1].astype(jnp.int32)
    r = image[..., 2].astype(jnp.int32)
    y = (b * _BY + g * _GY + r * _RY + _HALF) >> _SHIFT
    cr = (((r - y) * _CR + _HALF) >> _SHIFT) + 128
    cb = (((b - y) * _CB + _HALF) >> _SHIFT) + 128
    out = jnp.stack([y, cr, cb], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def ycrcb_to_bgr_j(image):
    import jax.numpy as jnp

    y = image[..., 0].astype(jnp.int32)
    cr = image[..., 1].astype(jnp.int32) - 128
    cb = image[..., 2].astype(jnp.int32) - 128
    b = y + ((cb * _C3 + _HALF) >> _SHIFT)
    g = y + ((cb * _C2 + cr * _C1 + _HALF) >> _SHIFT)
    r = y + ((cr * _C0 + _HALF) >> _SHIFT)
    out = jnp.stack([b, g, r], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


__all__ = [
    "bgr_to_gray_np",
    "gray_to_bgr_np",
    "bgr_to_ycrcb_np",
    "ycrcb_to_bgr_np",
    "bgr_to_gray_j",
    "gray_to_bgr_j",
    "bgr_to_ycrcb_j",
    "ycrcb_to_bgr_j",
]
