"""Texture features: LBP, GLCM/Haralick, Gabor response, histogram stats.

Reference kernels: ``core/extraction.py:107-201,264-290``.

Device redesign highlights:

* the GLCM is a scatter-add over (I[p], I[p+d]) index pairs — one pass over
  the image instead of the reference's O(H*W) python double loop
  (``my_greycomatrix``, ``core/extraction.py:120-141``), with identical
  counts (validated in tests);
* LBP samples its P neighbors by bilinear interpolation at static offsets,
  so the whole operator is a fixed stencil; the "uniform" coding
  (P+2 values) matches skimage's method="uniform" contract;
* histogram skew/kurtosis come from histogram central moments — identical
  to scipy.stats.skew/kurtosis on the reference's np.repeat expansion
  (``core/extraction.py:265-290``) without materializing it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from yamimageprocessor_tpu.ops import _kernels as K
from yamimageprocessor_tpu.ops import filters as F


# ---------------------------------------------------------------------------
# LBP (uniform, rotation-invariant — skimage method="uniform")
def _lbp_offsets(p: int, r: float) -> np.ndarray:
    angles = 2.0 * np.pi * np.arange(p) / p
    # skimage sample layout: (row, col) = (-r*sin, r*cos) rotated CCW
    rr = -r * np.sin(angles)
    cc = r * np.cos(angles)
    out = np.stack([rr, cc], axis=1)
    out[np.abs(out) < 1e-8] = 0.0
    return out


def lbp_np(gray: np.ndarray, p: int = 8, r: float = 1.0) -> np.ndarray:
    """Uniform LBP codes in [0, p+1]."""

    img = gray.astype(np.float64)
    h, w = img.shape
    pad = int(np.ceil(r)) + 1
    work = np.pad(img, pad, mode="edge")
    yy, xx = np.mgrid[:h, :w]
    samples = []
    for dr, dc in _lbp_offsets(p, r):
        ry = yy + pad + dr
        cx = xx + pad + dc
        y0 = np.floor(ry).astype(np.int64)
        x0 = np.floor(cx).astype(np.int64)
        fy = ry - y0
        fx = cx - x0
        val = (
            work[y0, x0] * (1 - fy) * (1 - fx)
            + work[y0, x0 + 1] * (1 - fy) * fx
            + work[y0 + 1, x0] * fy * (1 - fx)
            + work[y0 + 1, x0 + 1] * fy * fx
        )
        samples.append(val)
    stack = np.stack(samples, axis=0)
    bits = stack >= img[None, :, :]
    ones = bits.sum(axis=0)
    transitions = (bits != np.roll(bits, 1, axis=0)).sum(axis=0)
    return np.where(transitions <= 2, ones, p + 1).astype(np.float64)


def lbp_j(gray, *, p: int = 8, r: float = 1.0):
    import jax.numpy as jnp

    img = gray.astype(jnp.float32)
    h, w = img.shape
    pad = int(np.ceil(r)) + 1
    work = jnp.pad(img, pad, mode="edge")
    samples = []
    for dr, dc in _lbp_offsets(p, r):
        # static fractional offset: bilinear mix of four shifted slices
        y0 = int(np.floor(dr))
        x0 = int(np.floor(dc))
        fy = np.float32(dr - y0)
        fx = np.float32(dc - x0)
        base_y = pad + y0
        base_x = pad + x0
        v00 = work[base_y : base_y + h, base_x : base_x + w]
        v01 = work[base_y : base_y + h, base_x + 1 : base_x + 1 + w]
        v10 = work[base_y + 1 : base_y + 1 + h, base_x : base_x + w]
        v11 = work[base_y + 1 : base_y + 1 + h, base_x + 1 : base_x + 1 + w]
        # interpolate the DIFFERENCE to the center: |v - c| <= 255 keeps
        # the f32 rounding ~3e-5 absolute, vs ~1e-3 when interpolating the
        # raw ~200-level values and subtracting after — 30x fewer
        # comparison-tie flips against the f64 golden
        val = (
            (v00 - img) * (1 - fy) * (1 - fx)
            + (v01 - img) * (1 - fy) * fx
            + (v10 - img) * fy * (1 - fx)
            + (v11 - img) * fy * fx
        )
        samples.append(val)
    stack = jnp.stack(samples, axis=0)
    bits = stack >= 0.0
    ones = bits.sum(axis=0)
    rolled = jnp.roll(bits, 1, axis=0)
    transitions = (bits != rolled).sum(axis=0)
    return jnp.where(transitions <= 2, ones, p + 1).astype(jnp.float32)


def lbp_display(lbp: np.ndarray) -> np.ndarray:
    """Normalize to uint8 (``core/extraction.py:111``)."""

    lo, hi = float(lbp.min()), float(lbp.max())
    return (255.0 * (lbp - lo) / (hi - lo + 1e-6)).astype(np.uint8)


# ---------------------------------------------------------------------------
# GLCM
def glcm_np(
    gray: np.ndarray,
    distance: int = 1,
    angle: float = 0.0,
    levels: int = 256,
    symmetric: bool = True,
    normed: bool = True,
) -> np.ndarray:
    dx = int(round(distance * np.cos(angle)))
    dy = int(round(distance * np.sin(angle)))
    h, w = gray.shape
    r0, r1 = max(0, -dy), min(h, h - dy)
    c0, c1 = max(0, -dx), min(w, w - dx)
    src = gray[r0:r1, c0:c1].astype(np.int64)
    dst = gray[r0 + dy : r1 + dy, c0 + dx : c1 + dx].astype(np.int64)
    idx = src * levels + dst
    counts = np.bincount(idx.ravel(), minlength=levels * levels).astype(np.float64)
    glcm = counts.reshape(levels, levels)
    if symmetric:
        glcm = glcm + glcm.T
    if normed:
        glcm = glcm / (glcm.sum() + 1e-10)
    return glcm


def glcm_j(gray, *, dx: int, dy: int, levels: int = 256, symmetric: bool = True):
    import jax.numpy as jnp

    h, w = gray.shape
    r0, r1 = max(0, -dy), min(h, h - dy)
    c0, c1 = max(0, -dx), min(w, w - dx)
    src = gray[r0:r1, c0:c1].astype(jnp.int32)
    dst = gray[r0 + dy : r1 + dy, c0 + dx : c1 + dx].astype(jnp.int32)
    idx = (src * levels + dst).ravel()
    counts = jnp.zeros((levels * levels,), jnp.int32).at[idx].add(1)
    glcm = counts.reshape(levels, levels).astype(jnp.float32)
    if symmetric:
        glcm = glcm + glcm.T
    return glcm / (glcm.sum() + 1e-10)


def glcm_props(glcm) -> Dict[str, float]:
    """contrast / correlation / energy / homogeneity
    (``core/extraction.py:143-166``)."""

    xp = np
    try:
        import jax.numpy as jnp

        if not isinstance(glcm, np.ndarray):
            xp = jnp
    except ImportError:
        pass
    n = glcm.shape[0]
    i = xp.arange(n, dtype=glcm.dtype)
    ii = i[:, None] * xp.ones((1, n), glcm.dtype)
    jj = i[None, :] * xp.ones((n, 1), glcm.dtype)
    contrast = (glcm * (ii - jj) ** 2).sum()
    mu_i = (ii * glcm).sum()
    mu_j = (jj * glcm).sum()
    sigma_i = xp.sqrt((((ii - mu_i) ** 2) * glcm).sum())
    sigma_j = xp.sqrt((((jj - mu_j) ** 2) * glcm).sum())
    denom = sigma_i * sigma_j
    correlation = xp.where(
        denom == 0,
        xp.ones(()),
        ((ii - mu_i) * (jj - mu_j) * glcm).sum() / xp.where(denom == 0, 1.0, denom),
    )
    energy = (glcm**2).sum()
    homogeneity = (glcm / (1.0 + (ii - jj) ** 2)).sum()
    return {
        "contrast": contrast,
        "correlation": correlation,
        "energy": energy,
        "homogeneity": homogeneity,
    }


# ---------------------------------------------------------------------------
# Gabor response (core/extraction.py:190-201)
def gabor_np(gray: np.ndarray, ksize, sigma, theta, lambd, gamma, psi) -> np.ndarray:
    kernel = K.gabor_kernel(int(ksize), sigma, theta, lambd, gamma, psi)
    filtered = F.to_uint8_np(F.filter2d_np(gray, kernel))
    lo, hi = float(filtered.min()), float(filtered.max())
    span = hi - lo
    if span <= 0:
        return np.zeros_like(filtered)
    return F.to_uint8_np((filtered.astype(np.float32) - lo) * (255.0 / span))


def gabor_j(gray, kernel):
    import jax.numpy as jnp

    filtered = F.to_uint8_j(F.filter2d_j(gray, kernel))
    lo = filtered.min().astype(jnp.float32)
    hi = filtered.max().astype(jnp.float32)
    span = hi - lo
    scaled = (filtered.astype(jnp.float32) - lo) * (
        255.0 / jnp.where(span > 0, span, 1.0)
    )
    return jnp.where(span > 0, F.to_uint8_j(scaled), jnp.zeros_like(filtered))


# ---------------------------------------------------------------------------
# Histogram statistics (core/extraction.py:264-290)
def histogram_stats_np(gray: np.ndarray) -> Dict[str, float]:
    hist = np.bincount(gray.ravel(), minlength=256).astype(np.float64)
    total = hist.sum() if hist.sum() != 0 else 1.0
    px = np.arange(256, dtype=np.float64)
    mean = (px * hist).sum() / total
    m2 = (((px - mean) ** 2) * hist).sum() / total
    m3 = (((px - mean) ** 3) * hist).sum() / total
    m4 = (((px - mean) ** 4) * hist).sum() / total
    skew = m3 / m2**1.5 if m2 > 0 else 0.0
    kurt = m4 / m2**2 - 3.0 if m2 > 0 else -3.0
    return {"mean": mean, "variance": m2, "skewness": skew, "kurtosis": kurt}


def histogram_stats_j(gray):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    hist = histogram256_j(gray).astype(jnp.float32)
    total = jnp.maximum(hist.sum(), 1.0)
    px = jnp.arange(256, dtype=jnp.float32)
    mean = (px * hist).sum() / total
    m2 = (((px - mean) ** 2) * hist).sum() / total
    m3 = (((px - mean) ** 3) * hist).sum() / total
    m4 = (((px - mean) ** 4) * hist).sum() / total
    skew = jnp.where(m2 > 0, m3 / m2**1.5, 0.0)
    kurt = jnp.where(m2 > 0, m4 / m2**2 - 3.0, -3.0)
    return mean, m2, skew, kurt


__all__ = [
    "lbp_np",
    "lbp_j",
    "lbp_display",
    "glcm_np",
    "glcm_j",
    "glcm_props",
    "gabor_np",
    "gabor_j",
    "histogram_stats_np",
    "histogram_stats_j",
]
