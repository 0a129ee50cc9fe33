"""Quadtree region splitting (reference's "Region Splitting/Merging").

Reference: ``core/segmentation.py:177-193`` — recursively split a region in
four (half floor sizes) until width/height <= min_size or std < std_thresh;
leaves are filled with the region mean (uint8 truncation).

Device design: the recursion is re-expressed as a breadth-first sweep
over quadtree levels.  Every pixel carries its current node rectangle
(y0, x0, h, w); each level computes per-node mean/std in two passes with
``segment_sum`` over node ids (numerically safe: the variance pass subtracts
the node mean first), decides splits vectorized, and reassigns children.
Depth is bounded by log2(max_dim / min_size) — a static loop.

Float sums can round differently between numpy and XLA at reduction-order
ties; tests therefore assert exact equality of the split DECISIONS on
well-separated fixtures and behavioral equality vs the recursive reference
formulation.
"""
from __future__ import annotations

import numpy as np


def _split_children(y0, x0, hh, ww, py, px):
    """Child rect of pixel (py, px) when (y0, x0, hh, ww) splits in four
    with floor halving (reference lines 186-191)."""

    half_h = hh // 2
    half_w = ww // 2
    top = py < y0 + half_h
    left = px < x0 + half_w
    ny0 = np.where(top, y0, y0 + half_h)
    nx0 = np.where(left, x0, x0 + half_w)
    nh = np.where(top, half_h, hh - half_h)
    nw = np.where(left, half_w, ww - half_w)
    return ny0, nx0, nh, nw


def region_split_merge_np(
    gray: np.ndarray, min_size: int = 16, std_thresh: float = 10.0
) -> np.ndarray:
    img = gray.astype(np.float32)
    h, w = img.shape
    py, px = np.mgrid[:h, :w]
    y0 = np.zeros((h, w), np.int64)
    x0 = np.zeros((h, w), np.int64)
    hh = np.full((h, w), h, np.int64)
    ww = np.full((h, w), w, np.int64)

    max_depth = int(np.ceil(np.log2(max(max(h, w) / max(min_size, 1), 2)))) + 2
    for _ in range(max_depth):
        # (y0, x0) uniquely identifies a node within a sweep because node
        # rectangles never overlap; sizes ride along for the decision.
        node = y0 * (w + 1) + x0
        nsum = np.zeros((h * (w + 1) + w + 1,), np.float32)
        ncnt = np.zeros_like(nsum)
        np.add.at(nsum, node.ravel(), img.ravel())
        np.add.at(ncnt, node.ravel(), 1.0)
        mean = nsum[node] / np.maximum(ncnt[node], 1.0)
        nvar = np.zeros_like(nsum)
        np.add.at(nvar, node.ravel(), ((img - mean) ** 2).ravel())
        std = np.sqrt(nvar[node] / np.maximum(ncnt[node], 1.0))
        split = (ww > min_size) & (hh > min_size) & (std >= std_thresh)
        if not split.any():
            break
        ny0, nx0, nh, nw = _split_children(y0, x0, hh, ww, py, px)
        y0 = np.where(split, ny0, y0)
        x0 = np.where(split, nx0, x0)
        hh = np.where(split, nh, hh)
        ww = np.where(split, nw, ww)

    # final means per leaf
    node = y0 * (w + 1) + x0
    nsum = np.zeros((h * (w + 1) + w + 1,), np.float32)
    ncnt = np.zeros_like(nsum)
    np.add.at(nsum, node.ravel(), img.ravel())
    np.add.at(ncnt, node.ravel(), 1.0)
    mean = nsum[node] / np.maximum(ncnt[node], 1.0)
    return mean.astype(np.uint8)


def region_split_merge_j_dyn(gray, min_size, std_thresh):
    """Device twin; ``min_size``/``std_thresh`` may be traced scalars —
    the static depth bound uses min_size's schema minimum (2)."""

    import jax
    import jax.numpy as jnp

    img = gray.astype(jnp.float32)
    h, w = gray.shape
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    nseg = h * (w + 1) + w + 1

    def stats(y0, x0):
        node = (y0 * (w + 1) + x0).ravel()
        nsum = jax.ops.segment_sum(img.ravel(), node, num_segments=nseg)
        ncnt = jax.ops.segment_sum(jnp.ones_like(img).ravel(), node, num_segments=nseg)
        mean_flat = nsum / jnp.maximum(ncnt, 1.0)
        mean = mean_flat[node].reshape(h, w)
        nvar = jax.ops.segment_sum(
            ((img - mean) ** 2).ravel(), node, num_segments=nseg
        )
        std = jnp.sqrt((nvar / jnp.maximum(ncnt, 1.0))[node].reshape(h, w))
        return mean, std

    max_depth = int(np.ceil(np.log2(max(max(h, w) / 2, 2)))) + 2

    def body(_, state):
        y0, x0, hh, ww = state
        _, std = stats(y0, x0)
        split = (ww > min_size) & (hh > min_size) & (std >= std_thresh)
        half_h = hh // 2
        half_w = ww // 2
        top = py < y0 + half_h
        left = px < x0 + half_w
        ny0 = jnp.where(top, y0, y0 + half_h)
        nx0 = jnp.where(left, x0, x0 + half_w)
        nh = jnp.where(top, half_h, hh - half_h)
        nw = jnp.where(left, half_w, ww - half_w)
        return (
            jnp.where(split, ny0, y0),
            jnp.where(split, nx0, x0),
            jnp.where(split, nh, hh),
            jnp.where(split, nw, ww),
        )

    init = (
        jnp.zeros((h, w), jnp.int32),
        jnp.zeros((h, w), jnp.int32),
        jnp.full((h, w), h, jnp.int32),
        jnp.full((h, w), w, jnp.int32),
    )
    y0, x0, hh, ww = jax.lax.fori_loop(0, max_depth, body, init)
    mean, _ = stats(y0, x0)
    return mean.astype(jnp.uint8)


__all__ = ["region_split_merge_np", "region_split_merge_j_dyn"]
