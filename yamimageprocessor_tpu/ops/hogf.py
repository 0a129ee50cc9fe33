"""Histogram of Oriented Gradients (skimage.feature.hog capability).

Reference usage: ``core/extraction.py:248-262`` — hog with L2-Hys block
normalization plus the line-segment visualization image.

Implementation follows skimage's published algorithm: zero-border central
differences, unsigned orientations in [0, 180), hard assignment of each
pixel's magnitude to one orientation bin per cell, sliding block
L2-Hys normalization (clip 0.2, renormalize).  The cell histogram step is
expressed as a reshape-sum (device-friendly); the feature vector layout
matches skimage's (blocks_row, blocks_col, cpb, cpb, orientations) C-order
flattening.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _gradients_np(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    g_row = np.zeros_like(img, dtype=np.float64)
    g_col = np.zeros_like(img, dtype=np.float64)
    g_row[1:-1, :] = img[2:, :] - img[:-2, :]
    g_col[:, 1:-1] = img[:, 2:] - img[:, :-2]
    return g_row, g_col


def hog_features_np(
    gray: np.ndarray,
    orientations: int = 9,
    pixels_per_cell: Tuple[int, int] = (8, 8),
    cells_per_block: Tuple[int, int] = (3, 3),
):
    """(features, cell_histograms) with L2-Hys block normalization."""

    img = gray.astype(np.float64)
    g_row, g_col = _gradients_np(img)
    magnitude = np.hypot(g_row, g_col)
    orientation = np.rad2deg(np.arctan2(g_row, g_col)) % 180.0

    c_row, c_col = pixels_per_cell
    n_cells_row = img.shape[0] // c_row
    n_cells_col = img.shape[1] // c_col
    cropped_mag = magnitude[: n_cells_row * c_row, : n_cells_col * c_col]
    cropped_ori = orientation[: n_cells_row * c_row, : n_cells_col * c_col]

    bin_width = 180.0 / orientations
    hist = np.zeros((n_cells_row, n_cells_col, orientations), dtype=np.float64)
    for b in range(orientations):
        lo = b * bin_width
        hi = (b + 1) * bin_width
        sel = (cropped_ori >= lo) & (cropped_ori < hi)
        contrib = np.where(sel, cropped_mag, 0.0)
        hist[:, :, b] = (
            contrib.reshape(n_cells_row, c_row, n_cells_col, c_col)
            .sum(axis=(1, 3))
        ) / (c_row * c_col)

    b_row, b_col = cells_per_block
    n_blocks_row = n_cells_row - b_row + 1
    n_blocks_col = n_cells_col - b_col + 1
    if n_blocks_row <= 0 or n_blocks_col <= 0:
        return np.zeros(0), hist
    blocks = np.zeros(
        (n_blocks_row, n_blocks_col, b_row, b_col, orientations), dtype=np.float64
    )
    for r in range(n_blocks_row):
        for c in range(n_blocks_col):
            block = hist[r : r + b_row, c : c + b_col, :]
            eps = 1e-5
            norm = np.sqrt((block**2).sum() + eps**2)
            block = block / norm
            block = np.minimum(block, 0.2)
            norm = np.sqrt((block**2).sum() + eps**2)
            blocks[r, c] = block / norm
    return blocks.ravel(), hist


def hog_features_j(
    gray,
    *,
    orientations: int = 9,
    pixels_per_cell: Tuple[int, int] = (8, 8),
    cells_per_block: Tuple[int, int] = (3, 3),
):
    import jax.numpy as jnp

    img = gray.astype(jnp.float32)
    h, w = img.shape
    g_row = jnp.zeros_like(img).at[1:-1, :].set(img[2:, :] - img[:-2, :])
    g_col = jnp.zeros_like(img).at[:, 1:-1].set(img[:, 2:] - img[:, :-2])
    magnitude = jnp.hypot(g_row, g_col)
    orientation = jnp.rad2deg(jnp.arctan2(g_row, g_col)) % 180.0

    c_row, c_col = pixels_per_cell
    n_cells_row = h // c_row
    n_cells_col = w // c_col
    mag = magnitude[: n_cells_row * c_row, : n_cells_col * c_col]
    ori = orientation[: n_cells_row * c_row, : n_cells_col * c_col]
    bin_width = 180.0 / orientations
    bins = jnp.clip((ori / bin_width).astype(jnp.int32), 0, orientations - 1)
    onehot = (
        bins[..., None] == jnp.arange(orientations)[None, None, :]
    ).astype(jnp.float32)
    contrib = onehot * mag[..., None]
    hist = (
        contrib.reshape(n_cells_row, c_row, n_cells_col, c_col, orientations)
        .sum(axis=(1, 3))
    ) / (c_row * c_col)

    b_row, b_col = cells_per_block
    n_blocks_row = n_cells_row - b_row + 1
    n_blocks_col = n_cells_col - b_col + 1
    eps = jnp.float32(1e-5)

    def block_at(r, c):
        block = jax.lax.dynamic_slice(
            hist, (r, c, 0), (b_row, b_col, orientations)
        )
        norm = jnp.sqrt((block**2).sum() + eps**2)
        block = jnp.minimum(block / norm, 0.2)
        norm = jnp.sqrt((block**2).sum() + eps**2)
        return block / norm

    import jax

    rows = jnp.arange(n_blocks_row)
    cols = jnp.arange(n_blocks_col)
    blocks = jax.vmap(lambda r: jax.vmap(lambda c: block_at(r, c))(cols))(rows)
    return blocks.ravel(), hist


def hog_visualize_np(
    hist: np.ndarray,
    shape: Tuple[int, int],
    pixels_per_cell: Tuple[int, int],
    orientations: int,
) -> np.ndarray:
    """Line-segment visualization (skimage's hog_image)."""

    c_row, c_col = pixels_per_cell
    n_cells_row, n_cells_col = hist.shape[:2]
    out = np.zeros(shape, dtype=np.float64)
    radius = min(c_row, c_col) // 2 - 1
    orientation_bins = (np.arange(orientations) + 0.5) * np.pi / orientations
    for r in range(n_cells_row):
        for c in range(n_cells_col):
            cy = r * c_row + c_row // 2
            cx = c * c_col + c_col // 2
            for b, angle in enumerate(orientation_bins):
                weight = hist[r, c, b]
                if weight <= 0:
                    continue
                dy = int(round(radius * np.sin(angle)))
                dx = int(round(radius * np.cos(angle)))
                y0, x0 = cy - dy, cx - dx
                y1, x1 = cy + dy, cx + dx
                steps = max(abs(x1 - x0), abs(y1 - y0)) + 1
                ys = np.clip(
                    np.rint(np.linspace(y0, y1, steps)).astype(int), 0, shape[0] - 1
                )
                xs = np.clip(
                    np.rint(np.linspace(x0, x1, steps)).astype(int), 0, shape[1] - 1
                )
                out[ys, xs] += weight
    return out


def _stamp_masks(
    pixels_per_cell: Tuple[int, int], orientations: int
) -> np.ndarray:
    """(orientations, c_row, c_col) binary line stamps — the per-bin line
    segment of :func:`hog_visualize_np`, precomputed once (static) so the
    device visualization is a single einsum over cell histograms."""

    c_row, c_col = pixels_per_cell
    radius = min(c_row, c_col) // 2 - 1
    cy, cx = c_row // 2, c_col // 2
    stamps = np.zeros((orientations, c_row, c_col), dtype=np.float32)
    for b in range(orientations):
        angle = (b + 0.5) * np.pi / orientations
        dy = int(round(radius * np.sin(angle)))
        dx = int(round(radius * np.cos(angle)))
        y0, x0 = cy - dy, cx - dx
        y1, x1 = cy + dy, cx + dx
        steps = max(abs(x1 - x0), abs(y1 - y0)) + 1
        ys = np.clip(np.rint(np.linspace(y0, y1, steps)).astype(int), 0, c_row - 1)
        xs = np.clip(np.rint(np.linspace(x0, x1, steps)).astype(int), 0, c_col - 1)
        stamps[b, ys, xs] = 1.0  # duplicates collapse, matching += fancy-index
    return stamps


def hog_visualize_j(
    hist,
    shape: Tuple[int, int],
    pixels_per_cell: Tuple[int, int],
    orientations: int,
):
    """Device twin of :func:`hog_visualize_np`: out = einsum(cell hists,
    static line stamps) — lines never cross cell borders (radius <
    cell/2), so the render is one contraction plus a reshape."""

    import jax
    import jax.numpy as jnp

    c_row, c_col = pixels_per_cell
    n_cells_row, n_cells_col = hist.shape[:2]
    stamps = jnp.asarray(_stamp_masks(pixels_per_cell, orientations))
    # weight<=0 bins contribute nothing (mirrors the skip in the host loop)
    weights = jnp.maximum(hist, 0.0).astype(jnp.float32)
    cells = jnp.einsum(
        "rcb,bij->ricj", weights, stamps, precision=jax.lax.Precision.HIGHEST
    )
    out = cells.reshape(n_cells_row * c_row, n_cells_col * c_col)
    pad_r = shape[0] - out.shape[0]
    pad_c = shape[1] - out.shape[1]
    if pad_r or pad_c:
        out = jnp.pad(out, ((0, pad_r), (0, pad_c)))
    return out


def fractal_box_counts_j(binary, min_box_size: int = 2):
    """Device box-count series; sizes are static (shape-derived)."""

    import jax.numpy as jnp

    z = (binary > 0).astype(jnp.int32)
    h, w = z.shape
    p = min(h, w)
    sizes = []
    counts = []
    k = int(min_box_size)
    while k <= p:
        hp, wp = (-h) % k, (-w) % k
        padded = jnp.pad(z, ((0, hp), (0, wp)))
        sums = padded.reshape((h + hp) // k, k, (w + wp) // k, k).sum(axis=(1, 3))
        sizes.append(k)
        counts.append(jnp.sum((sums > 0) & (sums < k * k)).astype(jnp.float32))
        k *= 2
    return np.array(sizes, dtype=np.float32), jnp.stack(counts)


def fractal_dimension_j(binary, min_box_size: int = 2):
    """Device fractal dimension: slope of the log-log box-count fit."""

    import jax.numpy as jnp

    sizes, counts = fractal_box_counts_j(binary, min_box_size)
    x = jnp.log(jnp.asarray(sizes))
    y = jnp.log(jnp.maximum(counts, 1.0))
    xm = x.mean()
    slope = ((x - xm) * (y - y.mean())).sum() / jnp.maximum(
        ((x - xm) ** 2).sum(), 1e-12
    )
    return -slope


def fractal_box_counts(binary: np.ndarray, min_box_size: int = 2):
    """(sizes, counts) box-counting series (``core/extraction.py:293-336``):
    boxes with 0 < sum < k*k over a 0-1 mask, k doubling up to min(shape)."""

    z = (binary > 0).astype(np.int64)
    sizes, counts = [], []
    p = min(z.shape)
    k = int(min_box_size)
    while k <= p:
        h_pad = (-z.shape[0]) % k
        w_pad = (-z.shape[1]) % k
        padded = np.pad(z, ((0, h_pad), (0, w_pad)))
        sums = padded.reshape(
            padded.shape[0] // k, k, padded.shape[1] // k, k
        ).sum(axis=(1, 3))
        sizes.append(k)
        counts.append(int(((sums > 0) & (sums < k * k)).sum()))
        k *= 2
    return np.array(sizes), np.array(counts)


def fractal_dimension(binary: np.ndarray, min_box_size: int = 2) -> float:
    sizes, counts = fractal_box_counts(binary, min_box_size)
    counts = np.maximum(counts, 1)  # log-safety on degenerate masks
    coeffs = np.polyfit(np.log(sizes), np.log(counts), 1)
    return float(-coeffs[0])


__all__ = [
    "hog_features_np",
    "hog_features_j",
    "hog_visualize_np",
    "hog_visualize_j",
    "fractal_box_counts",
    "fractal_box_counts_j",
    "fractal_dimension",
    "fractal_dimension_j",
]
