"""CLAHE — contrast-limited adaptive histogram equalization.

The reference only offers global equalization (``core/preprocessing.py:
73-79``); the BASELINE's fused-chain configuration names CLAHE, so the
framework ships it as an extension op with cv2.createCLAHE semantics:

1. pad to a multiple of the tile grid (BORDER_REFLECT_101);
2. per-tile 256-bin histogram; clip at ``max(clip_limit*area/256, 1)`` and
   redistribute the excess evenly (remainder spread one-per-bin from 0);
3. per-tile LUT = round(cdf * 255 / area);
4. each output pixel bilinearly blends the LUTs of its 4 surrounding tile
   centers (edge-clamped).

The device path builds the tile histograms with one scatter-add and
blends with four per-pixel gathers from the tile LUTs (``_blend_j``); the
dense, mesh-sharded and streaming variants share both.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _tile_luts_np(
    gray: np.ndarray, grid: Tuple[int, int], clip_limit: float
) -> np.ndarray:
    gh, gw = grid
    h, w = gray.shape
    th, tw = h // gh, w // gw
    area = th * tw
    tiles = gray.reshape(gh, th, gw, tw)
    luts = np.zeros((gh, gw, 256), np.uint8)
    limit = max(int(clip_limit * area / 256.0), 1)
    scale = 255.0 / area
    for i in range(gh):
        for j in range(gw):
            hist = np.bincount(tiles[i, :, j, :].ravel(), minlength=256)
            if clip_limit > 0:
                clipped = int(np.maximum(hist - limit, 0).sum())
                hist = np.minimum(hist, limit)
                batch = clipped // 256
                residual = clipped - batch * 256
                hist = hist + batch
                if residual:
                    # cv2 spreads the residual with stride 256/residual
                    step = max(256 // residual, 1)
                    idx = np.arange(0, residual * step, step)[:residual]
                    hist[idx] += 1
            cdf = np.cumsum(hist)
            luts[i, j] = np.clip(np.rint(cdf * scale), 0, 255).astype(np.uint8)
    return luts


def _pad_to_grid(gray: np.ndarray, grid: Tuple[int, int]):
    gh, gw = grid
    h, w = gray.shape
    ph = (-h) % gh
    pw = (-w) % gw
    if ph or pw:
        gray = np.pad(gray, ((0, ph), (0, pw)), mode="reflect")
    return gray, (h, w)


def _interp_weights(h: int, w: int, grid: Tuple[int, int]):
    """Per-pixel surrounding tile indices + bilinear weights (edge clamp)."""

    gh, gw = grid
    th, tw = h // gh, w // gw
    # cv2's convention: x / tile_w - 0.5 (no pixel-center offset); indices
    # clamp AFTER the fraction is taken, so edge pixels blend a tile with
    # itself (validated bit-exact against cv2.createCLAHE)
    ys = np.arange(h) / th - 0.5
    xs = np.arange(w) / tw - 0.5
    fy = ys - np.floor(ys)
    fx = xs - np.floor(xs)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, gh - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, gw - 1)
    y1 = np.clip(np.floor(ys).astype(np.int64) + 1, 0, gh - 1)
    x1 = np.clip(np.floor(xs).astype(np.int64) + 1, 0, gw - 1)
    return (y0, y1, fy), (x0, x1, fx)


def clahe_np(
    gray: np.ndarray,
    clip_limit: float = 40.0,
    grid: Tuple[int, int] = (8, 8),
) -> np.ndarray:
    work, (h, w) = _pad_to_grid(np.asarray(gray), grid)
    luts = _tile_luts_np(work, grid, clip_limit)
    (y0, y1, fy), (x0, x1, fx) = _interp_weights(*work.shape, grid)
    vals = work.astype(np.int64)
    l00 = luts[y0[:, None], x0[None, :], vals].astype(np.float64)
    l01 = luts[y0[:, None], x1[None, :], vals].astype(np.float64)
    l10 = luts[y1[:, None], x0[None, :], vals].astype(np.float64)
    l11 = luts[y1[:, None], x1[None, :], vals].astype(np.float64)
    fy2 = fy[:, None]
    fx2 = fx[None, :]
    out = (
        l00 * (1 - fy2) * (1 - fx2)
        + l01 * (1 - fy2) * fx2
        + l10 * fy2 * (1 - fx2)
        + l11 * fy2 * fx2
    )
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)[:h, :w]


def _clip_and_lut_j(hist, clip_limit: float, area: int):
    """(gh, gw, 256) histograms -> f32 LUT tables (cv2 clip semantics);
    shared by the dense and the mesh-sharded paths so their LUT math is
    literally the same code."""

    import jax.numpy as jnp

    limit = max(int(clip_limit * area / 256.0), 1)
    scale = jnp.float32(255.0 / area)
    if clip_limit > 0:
        clipped = jnp.maximum(hist - limit, 0).sum(axis=-1)  # (gh, gw)
        hist = jnp.minimum(hist, limit)
        batch = clipped // 256
        residual = clipped - batch * 256
        hist = hist + batch[..., None]
        # residual spread: bins at stride max(256//residual, 1)
        idx = jnp.arange(256)
        step = jnp.maximum(256 // jnp.maximum(residual, 1), 1)
        take = (idx[None, None, :] % step[..., None] == 0) & (
            idx[None, None, :] // step[..., None] < residual[..., None]
        )
        hist = hist + take.astype(hist.dtype)
    cdf = jnp.cumsum(hist, axis=-1)
    return jnp.clip(jnp.rint(cdf.astype(jnp.float32) * scale), 0, 255).astype(
        jnp.float32
    )


def _tile_histograms_j(vals, tile_row, tile_col, gh: int, gw: int):
    """(gh, gw, 256) int32 tile histograms by one scatter-add on
    ``tile_id * 256 + value``; ``tile_row``/``tile_col`` give each pixel
    row's and column's tile index."""

    import jax.numpy as jnp

    seg = (tile_row[:, None] * gw + tile_col[None, :]) * 256 + vals
    hist = jnp.zeros((gh * gw * 256,), jnp.int32).at[seg.ravel()].add(1)
    return hist.reshape(gh, gw, 256)


def _blend_j(vals, luts, y0, y1, fy, x0, x1, fx):
    """Bilinear blend of the four surrounding tile LUTs at each pixel's own
    level: four per-pixel gathers from the flat (gh*gw*256) table, combined
    in the golden's f32 term order.  ``vals`` int32 (h, w); ``y*``/``x*``
    per-row / per-column tile indices and f32 fractions."""

    import jax.numpy as jnp

    gw = luts.shape[1]
    flat = luts.reshape(-1)

    def corner(yi, xi):
        return flat[(yi[:, None] * gw + xi[None, :]) * 256 + vals]

    fy2 = fy[:, None]
    fx2 = fx[None, :]
    w00 = (1 - fy2) * (1 - fx2)
    w01 = (1 - fy2) * fx2
    w10 = fy2 * (1 - fx2)
    w11 = fy2 * fx2
    out = (
        w00 * corner(y0, x0)
        + w01 * corner(y0, x1)
        + w10 * corner(y1, x0)
        + w11 * corner(y1, x1)
    )
    return jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)


def clahe_j(gray, *, clip_limit: float = 40.0, grid: Tuple[int, int] = (8, 8)):
    import jax.numpy as jnp

    gh, gw = grid
    h0, w0 = gray.shape
    ph = (-h0) % gh
    pw = (-w0) % gw
    work = jnp.pad(gray, ((0, ph), (0, pw)), mode="reflect") if (ph or pw) else gray
    h, w = work.shape
    th, tw = h // gh, w // gw
    area = th * tw

    vals = work.astype(jnp.int32)
    hist = _tile_histograms_j(
        vals, jnp.arange(h) // th, jnp.arange(w) // tw, gh, gw
    )
    luts = _clip_and_lut_j(hist, clip_limit, area)  # (gh, gw, 256)

    (y0, y1, fy), (x0, x1, fx) = _interp_weights(h, w, grid)
    out = _blend_j(
        vals,
        luts,
        jnp.asarray(y0, jnp.int32),
        jnp.asarray(y1, jnp.int32),
        jnp.asarray(fy, jnp.float32),
        jnp.asarray(x0, jnp.int32),
        jnp.asarray(x1, jnp.int32),
        jnp.asarray(fx, jnp.float32),
    )
    return out[:h0, :w0]


def clahe_sharded_j(
    gray_block,
    *,
    clip_limit: float = 40.0,
    grid: Tuple[int, int] = (8, 8),
    axis: str,
):
    """Row-sharded CLAHE, bit-identical to :func:`clahe_j`.

    The CLAHE grid spans the FULL frame while shards own row bands, so each
    shard scatter-adds its pixels into the global (gh, gw, 256) tile
    histograms at its rows' global tile indices, and the partial
    histograms are psum'd over the mesh (SURVEY §2.5: "global histograms
    [CLAHE/Otsu] become mesh collectives").  LUT math and the gather blend
    are the dense path's own code, so even f32 rounding matches.

    Requires the global frame to divide evenly by the grid (no reflect
    padding across shards); the dense path handles ragged shapes.
    """

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.parallel.collectives import axis_len

    gh, gw = grid
    n = axis_len(axis)
    idx = jax.lax.axis_index(axis)
    bh, w = gray_block.shape
    H = n * bh
    if H % gh or w % gw:
        raise ValueError(
            f"sharded CLAHE requires frame ({H}x{w}) divisible by grid {grid}"
        )
    th, tw = H // gh, w // gw
    area = th * tw

    start = idx * bh
    vals = gray_block.astype(jnp.int32)
    hist = _tile_histograms_j(
        vals, (start + jnp.arange(bh)) // th, jnp.arange(w) // tw, gh, gw
    )
    hist = jax.lax.psum(hist, axis)
    luts = _clip_and_lut_j(hist, clip_limit, area)

    # interpolation weights for ALL global rows via the SAME f64 host code
    # the dense path uses (f32-recomputed fractions differ by an ulp and
    # flip rounded outputs by 1); each shard dynamic-slices its row band
    (y0_all, y1_all, fy_all), (x0, x1, fx) = _interp_weights(H, w, grid)

    def band(a, dtype):
        return jax.lax.dynamic_slice(jnp.asarray(a, dtype), (start,), (bh,))

    return _blend_j(
        vals,
        luts,
        band(y0_all, jnp.int32),
        band(y1_all, jnp.int32),
        band(fy_all, jnp.float32),
        jnp.asarray(x0, jnp.int32),
        jnp.asarray(x1, jnp.int32),
        jnp.asarray(fx, jnp.float32),
    )


# ---------------------------------------------------------------------------
# streaming two-pass decomposition (gigapixel chains containing CLAHE)
#
# The reference streams every chain tile-by-tile
# (/root/reference/processing/pipeline_cache.py:416-574); CLAHE's global
# state is its (gh, gw, 256) grid of tile histograms, so the stats pass
# accumulates per-grid-cell histogram contributions from each stream tile
# and the apply pass blends the resolved LUTs at the tile's absolute
# frame coordinates.


def clahe_stream_gate(grid_size: int, frame_shape) -> bool:
    """True when the reflect-101 grid padding stays inside the last grid
    cell, so stream tiles can fold mirror contributions locally (always
    holds for large frames; tiny frames take the dense path)."""

    h, w = int(frame_shape[0]), int(frame_shape[1])
    gh = gw = int(grid_size)
    ph = (-h) % gh
    pw = (-w) % gw
    th = (h + ph) // gh
    tw = (w + pw) // gw
    return th >= 2 * ph + 1 and tw >= 2 * pw + 1


def clahe_grid_hist_tile_j(gray_tile, *, grid: Tuple[int, int], frame_shape, box):
    """Stats pass: (gh, gw, 256) histogram contributions of one stream
    tile.  ``box`` is the tile's traced (left, top, right, bottom); mirror
    weights replicate the dense path's reflect-101 grid padding."""

    import jax
    import jax.numpy as jnp

    h, w = int(frame_shape[0]), int(frame_shape[1])
    gh, gw = grid
    ph = (-h) % gh
    pw = (-w) % gw
    th = (h + ph) // gh
    tw = (w + pw) // gw

    t_h, t_w = gray_tile.shape
    r = box[1] + jax.lax.broadcasted_iota(jnp.int32, (t_h, t_w), 0)
    c = box[0] + jax.lax.broadcasted_iota(jnp.int32, (t_h, t_w), 1)
    # reflect-101 pad sources: rows h-1-ph .. h-2 contribute a second copy
    # (which lands in the same, last grid cell under the stream gate)
    wr = jnp.where((ph > 0) & (r >= h - 1 - ph) & (r <= h - 2), 2, 1)
    wc = jnp.where((pw > 0) & (c >= w - 1 - pw) & (c <= w - 2), 2, 1)
    weight = (wr * wc).astype(jnp.int32)
    ci = jnp.clip(r // th, 0, gh - 1)
    cj = jnp.clip(c // tw, 0, gw - 1)
    seg = (ci * gw + cj) * 256 + gray_tile.astype(jnp.int32)
    hist = jax.ops.segment_sum(
        weight.ravel(), seg.ravel(), num_segments=gh * gw * 256
    )
    return hist.reshape(gh, gw, 256)


def clahe_apply_from_hist_j(
    gray_tile, hist, *, clip_limit: float, grid: Tuple[int, int], frame_shape, box
):
    """Apply pass: resolve the grid LUTs from the accumulated histograms
    and blend them bilinearly at the tile's absolute coordinates.

    Interp fractions use exact integer arithmetic (floor((2r - th) /
    (2*th)) and the remainder) so the per-tile f32 weights agree with the
    dense path's f64-then-cast `_interp_weights` to the last ulp.  The
    remaining gap vs the dense path is <=1 LSB on blend-rounding ties:
    XLA's FMA contraction choices differ between the fused-chain programs,
    the same documented tie behavior as dense-vs-cv2
    (tests/test_preprocess_ops.py::test_clahe_matches_cv2_padded).
    """

    import jax.numpy as jnp

    h, w = int(frame_shape[0]), int(frame_shape[1])
    gh, gw = grid
    ph = (-h) % gh
    pw = (-w) % gw
    th = (h + ph) // gh
    tw = (w + pw) // gw
    area = th * tw

    luts = _clip_and_lut_j(hist, clip_limit, area)  # (gh, gw, 256) f32

    t_h, t_w = gray_tile.shape
    r = box[1] + jnp.arange(t_h, dtype=jnp.int32)
    c = box[0] + jnp.arange(t_w, dtype=jnp.int32)

    def axis_interp(pos, cell, count):
        num = 2 * pos - cell  # 2*th*(pos/th - 0.5), exact ints
        q = jnp.floor_divide(num, 2 * cell)
        frac = (num - q * 2 * cell).astype(jnp.float32) / jnp.float32(2 * cell)
        i0 = jnp.clip(q, 0, count - 1)
        i1 = jnp.clip(q + 1, 0, count - 1)
        return i0, i1, frac

    y0, y1, fy = axis_interp(r, th, gh)
    x0, x1, fx = axis_interp(c, tw, gw)
    return _blend_j(gray_tile.astype(jnp.int32), luts, y0, y1, fy, x0, x1, fx)


__all__ = [
    "clahe_np",
    "clahe_j",
    "clahe_sharded_j",
    "clahe_stream_gate",
    "clahe_grid_hist_tile_j",
    "clahe_apply_from_hist_j",
]
