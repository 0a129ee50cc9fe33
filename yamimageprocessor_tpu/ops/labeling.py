"""Connected-component labeling (8-connectivity, cv2-compatible numbering).

Reference usage: ``cv2.connectedComponents`` inside watershed marker
construction (``core/segmentation.py:108``) and ``skimage.measure.label``
in extraction (``core/extraction.py:61``).  cv2 numbers components compactly
in raster order of first occurrence (validated empirically); we use the same
canonical numbering in both paths:

* golden — scipy.ndimage two-pass labeling + raster-first renumbering;
* device — parallel label propagation: every foreground pixel starts with
  its flat index, then alternating neighbor-min + pointer-jumping (path
  compression via gather) rounds converge in O(log diameter) iterations;
  a final sort-based ranking produces compact raster-first labels.

Both paths produce bit-identical int32 label images.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

_EIGHT = np.ones((3, 3), dtype=np.uint8)


def label_np(fg: np.ndarray, connectivity: int = 8) -> np.ndarray:
    """Compact raster-first labels for the boolean foreground ``fg``."""

    structure = _EIGHT if connectivity == 8 else None
    raw, count = ndi.label(fg > 0, structure=structure)
    if count == 0:
        return np.zeros(fg.shape, dtype=np.int32)
    flat = raw.ravel()
    first_idx = np.full(count + 1, flat.size, dtype=np.int64)
    nz = np.flatnonzero(flat)
    # first occurrence of each label in raster order
    labels_at_nz = flat[nz]
    order = np.argsort(labels_at_nz, kind="stable")
    sorted_labels = labels_at_nz[order]
    firsts = np.searchsorted(sorted_labels, np.arange(1, count + 1))
    first_idx[1:] = nz[order[firsts]]
    rank = np.empty(count + 1, dtype=np.int32)
    rank[0] = 0
    rank[1:][np.argsort(first_idx[1:], kind="stable")] = np.arange(
        1, count + 1, dtype=np.int32
    )
    return rank[raw].astype(np.int32)


def _shifted(x, offset: int, axis: int, fill):
    """x shifted by +offset along axis (values move toward higher indices),
    vacated positions filled — static slicing only, no gathers."""

    import jax.numpy as jnp

    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    if offset >= 0:
        pad[axis] = (offset, 0)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n)
    else:
        pad[axis] = (0, -offset)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(-offset, n - offset)
    return jnp.pad(x, pad, constant_values=fill)[tuple(sl)]


def _segmented_min_both(values, run_id, axis: int, sentinel):
    """Min within contiguous runs (equal ``run_id``) along ``axis``, both
    directions, via Hillis-Steele doubling with static shifts (gather-free,
    log-depth, static slices only)."""

    import jax.numpy as jnp

    n = values.shape[axis]
    out = values
    shift = 1
    while shift < n:
        for sign in (1, -1):
            moved = _shifted(out, sign * shift, axis, sentinel)
            moved_id = _shifted(run_id, sign * shift, axis, -1)
            out = jnp.where(moved_id == run_id, jnp.minimum(out, moved), out)
        shift *= 2
    return out


def _renumber(lab, sentinel, h: int, w: int):
    """Canonical raster-first renumbering of a converged min-flat-index
    label field: roots are component min flat indices, automatically ordered
    by raster-first occurrence.  Depends only on the PARTITION, so every
    solver schedule (the dense Jacobi loop, the sharded collective merge)
    lands on bit-identical labels."""

    import jax.numpy as jnp

    n = h * w
    flat = lab.ravel()
    is_root = jnp.logical_and(
        flat != sentinel, flat == jnp.arange(n, dtype=jnp.int32)
    )
    rank_of_root = jnp.cumsum(is_root.astype(jnp.int32))  # 1-based at roots
    ranks = jnp.where(is_root, rank_of_root, 0)
    out = jnp.where(flat == sentinel, 0, ranks[jnp.clip(flat, 0, n - 1)])
    return out.reshape(h, w).astype(jnp.int32)


def _label_solve(fg, max_iters: int = 0):
    """Converged min-flat-index label field of the bool (H, W) ``fg`` and
    the number of propagation rounds the loop ran (background holds the
    sentinel ``H*W``)."""

    import jax
    import jax.numpy as jnp

    h, w = fg.shape
    n = h * w
    if max_iters <= 0:
        # the min-propagation is monotone, so n rounds is a TRUE
        # convergence bound (a fixed 256 silently fragmented high-turn
        # spiral/maze components).  The while_loop exits at convergence —
        # realistic masks take only a few rounds; the bound is never the
        # stopping reason, only a safety net.
        max_iters = n
    sentinel = jnp.int32(n)
    idx = jnp.arange(n, dtype=jnp.int32).reshape(h, w)
    lab0 = jnp.where(fg, idx, sentinel)
    bg = ~fg
    # run ids per axis (bg pixels get unique negative-ish ids so they never
    # match anything): computed once, reused every round
    row_runs = jnp.where(fg, jnp.cumsum(bg.astype(jnp.int32), axis=1), -2)
    col_runs = jnp.where(fg, jnp.cumsum(bg.astype(jnp.int32), axis=0), -2)

    def neighbor_min(lab):
        p = jnp.pad(lab, 1, constant_values=sentinel)
        m = lab
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                m = jnp.minimum(m, p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
        return jnp.where(fg, m, sentinel)

    def spread(lab):
        lab = neighbor_min(lab)
        lab = jnp.where(
            fg, _segmented_min_both(lab, row_runs, 1, sentinel), sentinel
        )
        lab = jnp.where(
            fg, _segmented_min_both(lab, col_runs, 0, sentinel), sentinel
        )
        return lab

    def cond(state):
        lab, prev, it = state
        return jnp.logical_and(jnp.any(lab != prev), it < max_iters)

    def body(state):
        lab, _, it = state
        return spread(lab), lab, it + 1

    lab, _, rounds = jax.lax.while_loop(
        cond, body, (spread(lab0), lab0, jnp.int32(0))
    )
    return lab, rounds + 1


def label_j(fg, max_iters: int = 0):
    """Device twin of :func:`label_np`; ``fg`` is a bool (H, W) array.

    Each round does a 1-pixel 8-neighbor min (covers diagonal links) then
    full-run row/column segmented min-scans (straight runs collapse in one
    pass), so convergence is a few rounds for realistic masks instead of
    O(diameter) sweeps.  Returns int32 labels, 0 = background.
    """

    h, w = fg.shape
    lab, _ = _label_solve(fg, max_iters)
    return _renumber(lab, h * w, h, w)


__all__ = ["label_np", "label_j"]
