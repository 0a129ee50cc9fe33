"""Threshold family: global, Otsu, adaptive (cv2 semantics).

Reference: ``core/segmentation.py:79-94,140-148``.  All threshold decisions
are integer comparisons so masks are bit-identical host <-> device.  The Otsu
score is evaluated with one vectorized float32 formula shared by both paths
(cv2 evaluates the same between-class variance in a sequential double loop —
equal argmax except at pathological near-ties).
"""
from __future__ import annotations

import numpy as np

from yamimageprocessor_tpu.ops import _kernels as K
from yamimageprocessor_tpu.ops import filters as F

_EPS = np.float32(1.19209290e-07)  # FLT_EPSILON, cv2's validity guard


def otsu_from_hist_np(hist: np.ndarray) -> int:
    hist = np.asarray(hist, dtype=np.float32)
    total = hist.sum()
    if total == 0:
        return 0
    p = hist / total
    i = np.arange(256, dtype=np.float32)
    mu_total = np.sum(i * p, dtype=np.float32)
    q1 = np.cumsum(p, dtype=np.float32)
    q2 = np.float32(1.0) - q1
    s1 = np.cumsum(i * p, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        mu1 = s1 / q1
        mu2 = (mu_total - s1) / q2
        sigma = q1 * q2 * (mu1 - mu2) ** 2
    valid = (np.minimum(q1, q2) >= _EPS) & (np.maximum(q1, q2) <= 1.0 - _EPS)
    sigma = np.where(valid, sigma, np.float32(-1.0))
    return int(np.argmax(sigma))


def otsu_threshold_np(gray: np.ndarray) -> int:
    return otsu_from_hist_np(np.bincount(gray.ravel(), minlength=256))


def otsu_from_hist_j(hist):
    import jax.numpy as jnp

    hist = hist.astype(jnp.float32)
    total = jnp.sum(hist)
    p = hist / jnp.maximum(total, 1.0)
    i = jnp.arange(256, dtype=jnp.float32)
    mu_total = jnp.sum(i * p)
    q1 = jnp.cumsum(p)
    q2 = jnp.float32(1.0) - q1
    s1 = jnp.cumsum(i * p)
    mu1 = s1 / jnp.where(q1 == 0, 1.0, q1)
    mu2 = (mu_total - s1) / jnp.where(q2 == 0, 1.0, q2)
    sigma = q1 * q2 * (mu1 - mu2) ** 2
    valid = (jnp.minimum(q1, q2) >= _EPS) & (jnp.maximum(q1, q2) <= 1.0 - _EPS)
    sigma = jnp.where(valid, sigma, jnp.float32(-1.0))
    return jnp.argmax(sigma).astype(jnp.int32)


def otsu_threshold_j(gray):
    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    return otsu_from_hist_j(histogram256_j(gray))


def binary_np(gray: np.ndarray, thresh, maxval: int = 255, inverse: bool = False):
    if inverse:
        return np.where(gray > thresh, np.uint8(0), np.uint8(maxval))
    return np.where(gray > thresh, np.uint8(maxval), np.uint8(0))


def binary_j(gray, thresh, maxval: int = 255, inverse: bool = False):
    import jax.numpy as jnp

    if inverse:
        return jnp.where(gray > thresh, jnp.uint8(0), jnp.uint8(maxval))
    return jnp.where(gray > thresh, jnp.uint8(maxval), jnp.uint8(0))


# ---------------------------------------------------------------------------
# Adaptive threshold, ADAPTIVE_THRESH_GAUSSIAN_C + THRESH_BINARY
# (core/segmentation.py:91-94).  cv2 rounds the Gaussian-weighted mean to
# uint8 and compares src > mean - ceil(C) with BORDER_REPLICATE.


def adaptive_threshold_np(gray: np.ndarray, block_size: int = 11, C: float = 2):
    taps = K.gaussian_taps(block_size, 0.0)
    mean = F.to_uint8_np(F.sep_filter_np(gray, taps, taps, border="replicate"))
    idelta = int(np.ceil(C))
    return np.where(
        gray.astype(np.int32) > mean.astype(np.int32) - idelta,
        np.uint8(255),
        np.uint8(0),
    )


def adaptive_threshold_j(gray, taps, C_ceil: int):
    import jax.numpy as jnp

    mean = F.to_uint8_j(F.sep_filter_j(gray, taps, taps, border="replicate"))
    return jnp.where(
        gray.astype(jnp.int32) > mean.astype(jnp.int32) - C_ceil,
        jnp.uint8(255),
        jnp.uint8(0),
    )


__all__ = [
    "otsu_from_hist_np",
    "otsu_threshold_np",
    "otsu_from_hist_j",
    "otsu_threshold_j",
    "binary_np",
    "binary_j",
    "adaptive_threshold_np",
    "adaptive_threshold_j",
]
