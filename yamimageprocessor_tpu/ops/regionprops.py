"""Per-region measurements over labeled masks (skimage.regionprops family).

Reference usage: ``core/extraction.py:57-87`` (area, perimeter, centroid,
eccentricity, solidity, extent, orientation per region).  skimage is not a
dependency — the formulas are re-implemented:

* area / centroid / bbox / central moments — one-hot matmul reductions on
  the matrix units (``np.add.at`` golden twin), replacing per-region
  python loops;
* orientation / eccentricity — inertia-tensor eigenvalues from central
  moments (skimage's definitions: orientation in (-pi/2, pi/2] measured
  against the row axis; eccentricity sqrt(1 - l2/l1));
* perimeter — skimage's weighted border-pixel categories (weights 1,
  sqrt(2), (1+sqrt(2))/2 over a [[10,2],[4,1]] category convolution);
* solidity — area / convex area; the hull pixel count runs on device too
  (:func:`hull_pixel_areas_j`, batched gift wrapping over per-row column
  extremes with exact int32 arithmetic), bit-matching the host scan-line.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

_SQRT2 = float(np.sqrt(2.0))
_PERIMETER_WEIGHTS = np.zeros(50, dtype=np.float64)
_PERIMETER_WEIGHTS[[5, 7, 15, 17, 25, 27]] = 1.0
_PERIMETER_WEIGHTS[[21, 33]] = _SQRT2
_PERIMETER_WEIGHTS[[13, 23]] = (1.0 + _SQRT2) / 2.0


@dataclass
class RegionMeasurements:
    """Vectorized per-region metrics (index 0 = background, unused)."""

    count: int
    area: np.ndarray
    centroid_r: np.ndarray
    centroid_c: np.ndarray
    bbox: np.ndarray  # (n+1, 4): minr, minc, maxr(+1), maxc(+1)
    mu20: np.ndarray
    mu02: np.ndarray
    mu11: np.ndarray
    perimeter: np.ndarray

    def extent(self) -> np.ndarray:
        heights = np.maximum(self.bbox[:, 2] - self.bbox[:, 0], 1)
        widths = np.maximum(self.bbox[:, 3] - self.bbox[:, 1], 1)
        return self.area / (heights * widths)

    def orientation(self) -> np.ndarray:
        a = self.mu20 / np.maximum(self.area, 1)
        b = self.mu11 / np.maximum(self.area, 1)
        c = self.mu02 / np.maximum(self.area, 1)
        # skimage convention: orientation = 0.5*atan2(-2*T01, T11 - T00)
        # of the inertia tensor T = [[mu02, -mu11], [-mu11, mu20]]/m00
        # (T00 is the COLUMN variance: the sum-minus-corner diagonal in
        # skimage.measure.inertia_tensor).  With our a=mu20 (row var) that
        # reduces to 0.5*atan2(2b, a-c); a vertical bar reports 0, a
        # horizontal bar pi/2, the main diagonal -pi/4.
        with np.errstate(invalid="ignore"):
            out = np.where(
                a - c == 0,
                np.where(b > 0, -np.pi / 4.0, np.pi / 4.0),
                0.5 * np.arctan2(2.0 * b, a - c),
            )
        return out

    def eccentricity(self) -> np.ndarray:
        a = self.mu20 / np.maximum(self.area, 1)
        b = self.mu11 / np.maximum(self.area, 1)
        c = self.mu02 / np.maximum(self.area, 1)
        common = np.sqrt(np.maximum((a - c) ** 2 + 4 * b * b, 0.0))
        l1 = (a + c + common) / 2.0
        l2 = (a + c - common) / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            ecc = np.sqrt(np.maximum(1.0 - l2 / np.maximum(l1, 1e-12), 0.0))
        return np.where(self.area > 0, ecc, 0.0)


def measure_np(labels: np.ndarray) -> RegionMeasurements:
    """Golden path: all metrics via vectorized scatter sums."""

    labels = np.asarray(labels, dtype=np.int64)
    n = int(labels.max())
    h, w = labels.shape
    rr, cc = np.mgrid[:h, :w]
    flat = labels.ravel()

    area = np.bincount(flat, minlength=n + 1).astype(np.float64)
    sum_r = np.bincount(flat, weights=rr.ravel(), minlength=n + 1)
    sum_c = np.bincount(flat, weights=cc.ravel(), minlength=n + 1)
    safe = np.maximum(area, 1)
    cen_r = sum_r / safe
    cen_c = sum_c / safe

    dr = rr.ravel() - cen_r[flat]
    dc = cc.ravel() - cen_c[flat]
    mu20 = np.bincount(flat, weights=dr * dr, minlength=n + 1)
    mu02 = np.bincount(flat, weights=dc * dc, minlength=n + 1)
    mu11 = np.bincount(flat, weights=dr * dc, minlength=n + 1)

    bbox = np.zeros((n + 1, 4), dtype=np.int64)
    if n:
        big = 1 << 30
        minr = np.full(n + 1, big)
        minc = np.full(n + 1, big)
        maxr = np.full(n + 1, -1)
        maxc = np.full(n + 1, -1)
        np.minimum.at(minr, flat, rr.ravel())
        np.minimum.at(minc, flat, cc.ravel())
        np.maximum.at(maxr, flat, rr.ravel())
        np.maximum.at(maxc, flat, cc.ravel())
        bbox[:, 0] = np.where(minr == big, 0, minr)
        bbox[:, 1] = np.where(minc == big, 0, minc)
        bbox[:, 2] = maxr + 1
        bbox[:, 3] = maxc + 1

    perim = perimeters_np(labels, n)

    return RegionMeasurements(
        count=n,
        area=area,
        centroid_r=cen_r,
        centroid_c=cen_c,
        bbox=bbox,
        mu20=mu20,
        mu02=mu02,
        mu11=mu11,
        perimeter=perim,
    )


def perimeters_np(labels: np.ndarray, n: int) -> np.ndarray:
    """skimage-style perimeter per region.

    skimage.measure.perimeter convolves the border mask (pixels removed by
    a 4-connected erosion) with [[10, 2, 10], [2, 1, 2], [10, 2, 10]] and
    sums category weights.  Here the category counts only same-region border
    neighbors, which equals running skimage per-region on isolated masks.
    """

    out = np.zeros(n + 1, dtype=np.float64)
    h, w = labels.shape
    padded = np.pad(labels, 1)

    def same(dy: int, dx: int) -> np.ndarray:
        return padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] == labels

    interior = same(-1, 0) & same(1, 0) & same(0, -1) & same(0, 1) & (labels > 0)
    border = (labels > 0) & ~interior

    bpad = np.pad(border, 1)

    def nb(dy: int, dx: int) -> np.ndarray:
        return bpad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] & same(dy, dx)

    orth = (
        nb(-1, 0).astype(np.int64)
        + nb(1, 0)
        + nb(0, -1)
        + nb(0, 1)
    )
    diag = (
        nb(-1, -1).astype(np.int64)
        + nb(-1, 1)
        + nb(1, -1)
        + nb(1, 1)
    )
    cat = np.where(border, 1 + 2 * orth + 10 * diag, 0)
    weights = _PERIMETER_WEIGHTS[np.clip(cat, 0, 49)]
    np.add.at(out, labels.ravel(), weights.ravel())
    out[0] = 0.0
    return out


def measure_j(labels, max_regions: int):
    """Device twin: per-region reductions with a static region capacity.

    Returns a dict of (max_regions+1,) arrays; entries past the true count
    are zero.

    The reductions run as ONE-HOT MATMULS: per row-chunk, a (pixels,
    regions) one-hot contracts against a (pixels, 7) value matrix.  Moments are accumulated relative to each region's
    bbox-center (known before the matmul from the row-extreme pass), so
    f32 sums keep centered-moment precision without a second pass.
    """

    return _measure_packed(labels, max_regions, extra=None)[0]


def row_extremes_j(labels, max_regions: int):
    """Per-(region, row) column extremes — (mn, mx, has), each
    (max_regions+1, H).  ``mn``/``mx`` are the leftmost/rightmost columns
    of the region on that row; ``has`` marks rows the region occupies.

    Two formulations, both exact (integer min/max):

    * small capacities: fused broadcast-compare-select reduces over W,
      chunked by rows so nothing near (H, W, regions) materializes —
      O(H*W*capacity) lane work, the fastest shape for <=~128 lanes;
    * large capacities: (region*H + row)-keyed segment min/max — O(H*W)
      regardless of capacity.  (At the 1024-region tier on 4096² frames the end-to-end
      time is unchanged — the tier's wall is the hull wrap over 2x1025
      lanes — but the extremes stop scaling with capacity.)
    """

    import jax
    import jax.numpy as jnp

    labels = labels.astype(jnp.int32)
    h, w = labels.shape
    nseg = max_regions + 1
    big = jnp.int32(1) << 29

    if nseg > 128:
        # large capacities: the labeler numbers regions by raster-first
        # occurrence, so the labels present in a short row chunk span a
        # narrow window — each chunk reduces over 128 LOCAL lanes
        # (background lane 0 + a 127-label window anchored at the chunk's
        # min foreground label) and writes the window back at its offset:
        # O(H*W*128) lane work instead of O(H*W*capacity).  A chunk whose label
        # span overflows the window (non-raster-local layouts) reduces
        # over the full capacity via lax.cond.
        win = 128
        wfg = win - 1
        reg_loc = jnp.arange(win, dtype=jnp.int32)
        reg_full = jnp.arange(nseg, dtype=jnp.int32)
        rows = max(1, min(h, (1 << 23) // max(w * win, 1)), -(-h // 256))
        nchunks = -(-h // rows)
        hp = nchunks * rows
        labp = jnp.pad(labels, ((0, hp - h), (0, 0)), constant_values=-1)
        cols = jax.lax.broadcasted_iota(jnp.int32, (rows, w), 1)[..., None]

        def body(i, acc):
            chunk = jax.lax.dynamic_slice(labp, (i * rows, 0), (rows, w))
            fg = chunk > 0
            base = jnp.min(jnp.where(fg, chunk, big))
            base_c = jnp.clip(base, 1, nseg - wfg)
            maxlab = jnp.max(jnp.where(fg, chunk, 0))
            fits = maxlab <= base_c + (wfg - 1)

            def local(a):
                mn_acc, mx_acc = a
                loc = jnp.where(
                    fg, chunk - base_c + 1, jnp.where(chunk == 0, 0, -1)
                )
                eq = loc[:, :, None] == reg_loc
                mnl = jnp.min(jnp.where(eq, cols, big), axis=1)
                mxl = jnp.max(jnp.where(eq, cols, -1), axis=1)
                mn_acc = jax.lax.dynamic_update_slice(
                    mn_acc, mnl[:, :1], (i * rows, 0)
                )
                mx_acc = jax.lax.dynamic_update_slice(
                    mx_acc, mxl[:, :1], (i * rows, 0)
                )
                mn_acc = jax.lax.dynamic_update_slice(
                    mn_acc, mnl[:, 1:], (i * rows, base_c)
                )
                mx_acc = jax.lax.dynamic_update_slice(
                    mx_acc, mxl[:, 1:], (i * rows, base_c)
                )
                return mn_acc, mx_acc

            def full(a):
                mn_acc, mx_acc = a
                eq = chunk[:, :, None] == reg_full
                mnf = jnp.min(jnp.where(eq, cols, big), axis=1)
                mxf = jnp.max(jnp.where(eq, cols, -1), axis=1)
                mn_acc = jax.lax.dynamic_update_slice(
                    mn_acc, mnf, (i * rows, 0)
                )
                mx_acc = jax.lax.dynamic_update_slice(
                    mx_acc, mxf, (i * rows, 0)
                )
                return mn_acc, mx_acc

            return jax.lax.cond(fits, local, full, acc)

        mn0 = jnp.full((hp, nseg), big, jnp.int32)
        mx0 = jnp.full((hp, nseg), -1, jnp.int32)
        mn, mx = jax.lax.fori_loop(0, nchunks, body, (mn0, mx0))
        mn = mn[:h].T
        mx = mx[:h].T
        has = mx >= 0
        return jnp.where(has, mn, big), jnp.where(has, mx, -1), has

    reg = jnp.arange(nseg, dtype=jnp.int32)
    rows = max(1, min(h, (1 << 23) // max(w * nseg, 1)))
    nchunks = -(-h // rows)
    hp = nchunks * rows
    # pad rows with -1 (matches no region, including background lane 0)
    labp = jnp.pad(labels, ((0, hp - h), (0, 0)), constant_values=-1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (rows, w), 1)[..., None]

    def body(i, acc):
        mn_acc, mx_acc = acc
        chunk = jax.lax.dynamic_slice(labp, (i * rows, 0), (rows, w))
        eq = chunk[:, :, None] == reg  # (rows, W, nseg), fused into reduces
        mn = jnp.min(jnp.where(eq, cols, big), axis=1)
        mx = jnp.max(jnp.where(eq, cols, -1), axis=1)
        mn_acc = jax.lax.dynamic_update_slice(mn_acc, mn, (i * rows, 0))
        mx_acc = jax.lax.dynamic_update_slice(mx_acc, mx, (i * rows, 0))
        return mn_acc, mx_acc

    mn0 = jnp.zeros((hp, nseg), jnp.int32)
    mx0 = jnp.zeros((hp, nseg), jnp.int32)
    mn, mx = jax.lax.fori_loop(0, nchunks, body, (mn0, mx0))
    mn = mn[:h].T
    mx = mx[:h].T
    return mn, mx, mx >= 0


def _measure_packed(labels, max_regions: int, extra):
    """(feats dict, (mn, mx, has) row extremes) — shared by the measure
    entry points and the device hull-area kernel (which consumes the same
    extremes, so one pass serves both)."""

    import jax
    import jax.numpy as jnp

    labels = labels.astype(jnp.int32)
    h, w = labels.shape
    nseg = max_regions + 1
    lab = jnp.clip(labels, 0, max_regions)
    big = jnp.int32(1) << 29

    mn, mx, has = row_extremes_j(lab, max_regions)
    t = jnp.arange(h, dtype=jnp.int32)[None, :]
    minr = jnp.min(jnp.where(has, t, big), axis=1)
    maxr = jnp.max(jnp.where(has, t, -1), axis=1)
    minc = jnp.min(jnp.where(has, mn, big), axis=1)
    maxc = jnp.max(jnp.where(has, mx, -1), axis=1)
    present = maxr >= 0
    # bbox centers: the moment-shift origin (|dr| <= bbox_height/2 keeps
    # the f32 matmul sums in centered-moment precision)
    s_r = jnp.where(present, (minr + maxr).astype(jnp.float32) * 0.5, 0.0)
    s_c = jnp.where(present, (minc + maxc).astype(jnp.float32) * 0.5, 0.0)

    sums = _moment_sums_matmul(lab, extra, s_r, s_c, nseg)
    area = sums[:, 0]
    sdr, sdc = sums[:, 1], sums[:, 2]
    safe = jnp.maximum(area, 1.0)
    feats = {
        "area": area,
        "centroid_r": s_r + sdr / safe,
        "centroid_c": s_c + sdc / safe,
        "min_r": jnp.where(present, minr.astype(jnp.float32), 0.0),
        "min_c": jnp.where(present, minc.astype(jnp.float32), 0.0),
        "max_r": jnp.where(present, maxr.astype(jnp.float32), -1.0),
        "max_c": jnp.where(present, maxc.astype(jnp.float32), -1.0),
        # shift identity: mu20 = Σdr² - (Σdr)²/area for dr about ANY
        # per-region constant (here the bbox center)
        "mu20": sums[:, 3] - sdr * sdr / safe,
        "mu02": sums[:, 4] - sdc * sdc / safe,
        "mu11": sums[:, 5] - sdr * sdc / safe,
    }
    if extra is not None:
        feats["perimeter"] = sums[:, 6].at[0].set(0.0)
    return feats, (mn, mx, has)


def _moment_sums_matmul(lab, pw, s_r, s_c, nseg: int):
    """(nseg, 7) per-region sums of [1, dr, dc, dr², dc², dr·dc, pw] via
    chunked one-hot matmuls, dr/dc measured from the per-region shift
    origins ``s_r``/``s_c`` (gathered per pixel by a one-hot matvec).

    Large capacities (nseg > 256) exploit the labeler's raster-first
    numbering: the labels in a short row chunk span a narrow window, so
    the chunk contracts a 128-lane LOCAL one-hot (background lane 0 + a
    127-label window anchored at the chunk's min foreground label) and
    adds the partial sums into the global table at the window offset —
    O(H*W*128) lane work instead of O(H*W*capacity), with identical
    per-lane contraction lengths.  A chunk whose label span overflows the
    window takes the full-capacity contraction via lax.cond."""

    import jax
    import jax.numpy as jnp

    h, w = lab.shape
    big = jnp.int32(1) << 29
    local = nseg > 256
    win = 128 if local else nseg
    wfg = win - 1
    reg = jnp.arange(win, dtype=jnp.int32)
    reg_full = jnp.arange(nseg, dtype=jnp.int32)
    # ~32 MB one-hot per chunk, but never more than 256 chunks: at the
    # 512-region tier on large frames the per-chunk fori overhead would
    # otherwise dominate (total HBM traffic is chunking-invariant)
    rows = max(1, min(h, (1 << 23) // max(w * win, 1)), -(-h // 256))
    nchunks = -(-h // rows)
    hp = nchunks * rows
    # pad rows with -1: they match NO lane, so padding contributes nothing
    labp = jnp.pad(lab, ((0, hp - h), (0, 0)), constant_values=-1)
    pwp = (
        jnp.zeros((hp, w), jnp.float32)
        if pw is None
        else jnp.pad(pw.astype(jnp.float32), ((0, hp - h), (0, 0)))
    )
    ccf = jax.lax.broadcasted_iota(jnp.float32, (rows, w), 1).ravel()

    # default-precision f32 dots may round operands (bf16 / TF32): that
    # would quantize the weight/moment sums, so these contractions pin
    # full f32 precision — the 0/1 one-hot operand is exact either way
    hi = jax.lax.Precision.HIGHEST

    def _vals(onehot, sr, sc, rrf, pwc):
        dr = rrf - jnp.matmul(onehot, sr, precision=hi)
        dc = ccf - jnp.matmul(onehot, sc, precision=hi)
        vals = jnp.stack(
            [jnp.ones_like(dr), dr, dc, dr * dr, dc * dc, dr * dc, pwc],
            axis=1,
        )
        return jnp.matmul(onehot.T, vals, precision=hi)

    def body(i, acc):
        chunk = jax.lax.dynamic_slice(labp, (i * rows, 0), (rows, w))
        flat = chunk.reshape(-1)
        rrf = (
            jax.lax.broadcasted_iota(jnp.int32, (rows, w), 0) + i * rows
        ).reshape(-1).astype(jnp.float32)
        pwc = jax.lax.dynamic_slice(pwp, (i * rows, 0), (rows, w)).reshape(-1)
        if not local:
            onehot = (flat[:, None] == reg[None, :]).astype(jnp.float32)
            return acc + _vals(onehot, s_r, s_c, rrf, pwc)

        fg = flat > 0
        base = jnp.min(jnp.where(fg, flat, big))
        base_c = jnp.clip(base, 1, nseg - wfg)
        maxlab = jnp.max(jnp.where(fg, flat, 0))
        fits = maxlab <= base_c + (wfg - 1)

        def local_fn(a):
            loc = jnp.where(fg, flat - base_c + 1, jnp.where(flat == 0, 0, -1))
            onehot = (loc[:, None] == reg[None, :]).astype(jnp.float32)
            sr = jnp.concatenate(
                [s_r[:1], jax.lax.dynamic_slice(s_r, (base_c,), (wfg,))]
            )
            sc = jnp.concatenate(
                [s_c[:1], jax.lax.dynamic_slice(s_c, (base_c,), (wfg,))]
            )
            part = _vals(onehot, sr, sc, rrf, pwc)
            accw = jax.lax.dynamic_slice(a, (base_c, 0), (wfg, 7))
            a = jax.lax.dynamic_update_slice(a, accw + part[1:], (base_c, 0))
            return a.at[0].add(part[0])

        def full_fn(a):
            onehot = (flat[:, None] == reg_full[None, :]).astype(jnp.float32)
            return a + _vals(onehot, s_r, s_c, rrf, pwc)

        return jax.lax.cond(fits, local_fn, full_fn, acc)

    return jax.lax.fori_loop(
        0, nchunks, body, jnp.zeros((nseg, 7), jnp.float32)
    )


def measure_with_perimeter_j(labels, max_regions: int):
    """Fused measure + perimeter: the perimeter category weights ride the
    moment matmul as a seventh packed column."""

    return _measure_packed(
        labels, max_regions, extra=_perimeter_weights_j(labels)
    )[0]


def measure_extremes_j(labels, max_regions: int):
    """(feats incl. perimeter, (mn, mx, has)) — the row extremes feed
    :func:`hull_pixel_areas_j` without recomputation."""

    return _measure_packed(
        labels, max_regions, extra=_perimeter_weights_j(labels)
    )


def perimeters_j(labels, max_regions: int):
    """Device twin of :func:`perimeters_np`: same border categories, the
    weight lookup folded into arithmetic selects (no per-pixel gather) and
    the per-region sum as a segment reduction."""

    import jax
    import jax.numpy as jnp

    weights = _perimeter_weights_j(labels)
    flat = jnp.clip(labels.astype(jnp.int32).ravel(), 0, max_regions)
    out = jax.ops.segment_sum(
        weights.ravel(), flat, num_segments=max_regions + 1
    )
    return out.at[0].set(0.0)


def _perimeter_weights_j(labels):
    """Per-pixel skimage perimeter category weights (the scatter-ready
    value map shared by :func:`perimeters_j` and the packed measure)."""

    import jax.numpy as jnp

    labels = labels.astype(jnp.int32)
    h, w = labels.shape
    padded = jnp.pad(labels, 1)

    def same(dy, dx):
        return padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] == labels

    pos = labels > 0
    interior = same(-1, 0) & same(1, 0) & same(0, -1) & same(0, 1) & pos
    border = pos & ~interior
    bpad = jnp.pad(border, 1)

    def nb(dy, dx):
        return bpad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] & same(dy, dx)

    orth = (
        nb(-1, 0).astype(jnp.int32)
        + nb(1, 0)
        + nb(0, -1)
        + nb(0, 1)
    )
    diag = (
        nb(-1, -1).astype(jnp.int32)
        + nb(-1, 1)
        + nb(1, -1)
        + nb(1, 1)
    )
    # nonzero entries of _PERIMETER_WEIGHTS by (orth, diag) category:
    # orth in {2,3} & diag in {0,1,2} -> 1 ; (0,2)/(1,3) -> sqrt2 ;
    # (1,1)/(1,2) -> (1+sqrt2)/2
    one = (orth >= 2) & (orth <= 3) & (diag <= 2)
    s2 = ((orth == 0) & (diag == 2)) | ((orth == 1) & (diag == 3))
    mid = (orth == 1) & ((diag == 1) | (diag == 2))
    weights = jnp.where(
        one,
        jnp.float32(1.0),
        jnp.where(
            s2,
            jnp.float32(_SQRT2),
            jnp.where(mid, jnp.float32((1.0 + _SQRT2) / 2.0), 0.0),
        ),
    )
    return jnp.where(border, weights, 0.0)


# ---------------------------------------------------------------------------
# convex hull — device pixel-area kernel
#
# The reference's solidity (core/extraction.py:57-87, skimage regionprops)
# divides region area by the pixel count of the filled convex hull.  The
# device kernel computes that pixel count directly — no vertex list, no
# host scan-line — from the geometry of pixel-grid hulls:
#
#   * hull candidates are the per-row column extremes (mn, mx), and a
#     connected region occupies a CONTIGUOUS row interval;
#   * the hull's right boundary at row t is the concave upper envelope of
#     mx over rows, traced by gift wrapping: from vertex v the next hull
#     vertex maximizes the slope (exact int32 cross-product comparisons —
#     coords <= 2^14 keep every product in range);
#   * the left boundary is the SAME computation on -mn, because
#     floor(-LX) = -ceil(LX): one kernel runs both chains as extra lanes;
#   * per row, pixels-in-hull = floor(RX) - ceil(LX) + 1, and floor of an
#     exact rational (p // q) equals the host's f64 + 1e-9-epsilon
#     scan-line arithmetic exactly (rationals with denominator <= 2^14
#     are either integers or >= 6e-5 from one).
_HULL_ROW_CAP = 256  # compact fast-path window (bbox rows per region)


def hull_pixel_areas_j(mn, mx, has, max_iters: int = 64):
    """Filled-convex-hull pixel count per region, fully on device.

    ``mn``/``mx``/``has``: per-(region, row) column extremes from
    :func:`row_extremes_j`.  Returns ``(areas, saturated)`` — int32
    pixel counts (index 0 = background, garbage) and a bool flag for
    regions whose hull chain exceeded ``max_iters`` vertices (caller must
    fall back to the host hull for those; needs > ``max_iters`` hull
    vertices per side, i.e. enormous smooth regions).

    Bit parity: areas equal :func:`_hull_pixel_area` over
    :func:`convex_hull_points` for every region, including degenerate
    (collinear / single-row) hulls, where both reduce to the member pixel
    count.  Valid for frames up to 16384 on a side (int32 cross bound).

    Dispatch: a region's hull geometry lives entirely inside its bbox
    rows, so when every bbox is at most ``_HULL_ROW_CAP`` rows tall the
    chains run over per-region COMPACTED row windows (16x less lane work
    at 4096² and an exact single-reduce slope argmax instead of the
    pairwise tournament — see :func:`_hull_areas_compact`); frames with a
    taller region take the full-width tournament path via ``lax.cond``.
    """

    import jax
    import jax.numpy as jnp

    nseg, h = mx.shape
    if h <= _HULL_ROW_CAP:
        return _hull_areas_chains(mn, mx, has, max_iters)

    big = jnp.int32(1) << 29
    t = jnp.arange(h, dtype=jnp.int32)
    minr = jnp.min(jnp.where(has, t[None, :], big), axis=1)
    maxr = jnp.max(jnp.where(has, t[None, :], -1), axis=1)
    tall = jnp.any((maxr >= 0) & (maxr - minr + 1 > _HULL_ROW_CAP))
    return jax.lax.cond(
        tall,
        lambda ops: _hull_areas_chains(*ops, max_iters),
        lambda ops: _hull_areas_compact(*ops, max_iters),
        (mn, mx, has),
    )


def _hull_areas_compact(mn, mx, has, max_iters: int = 64):
    """Compact-window gift wrap: each lane's candidates are gathered into
    a ``_HULL_ROW_CAP``-row window starting at the region's ``minr`` (hull
    rows outside the bbox don't exist), and the next-vertex search runs as
    an EXACT 2-pass slope argmax — local ``dr <= 255`` keeps the scaled
    slope ``(dx << 16) // dr`` exact in int32 (distinct rationals with
    denominators <= 255 differ by >= 2^-16, so scaled floors differ by
    >= 1), ties resolved to the farthest row like the tournament's
    ``(cross == 0) & (r1 > r0)`` pop."""

    import jax
    import jax.numpy as jnp

    nseg, h = mx.shape
    cap = _HULL_ROW_CAP
    big = jnp.int32(1) << 29
    kmin = jnp.iinfo(jnp.int32).min
    t = jnp.arange(h, dtype=jnp.int32)
    lt = jnp.arange(cap, dtype=jnp.int32)

    minr = jnp.min(jnp.where(has, t[None, :], big), axis=1)
    maxr = jnp.max(jnp.where(has, t[None, :], -1), axis=1)
    start = jnp.clip(minr, 0, h - 1)
    idx = jnp.clip(start[:, None] + lt[None, :], 0, h - 1)
    # local validity re-derives from the gathered has: clipped duplicate
    # rows past maxr are masked by the height bound
    heights = maxr - minr  # >= 0 for present regions, < 0 for empty
    ok = jnp.take_along_axis(has, idx, axis=1) & (lt[None, :] <= heights[:, None])
    mxc = jnp.take_along_axis(mx, idx, axis=1)
    mnc = jnp.take_along_axis(mn, idx, axis=1)

    # lanes 0..nseg-1: right chain over mx; lanes nseg..: left chain as a
    # right chain over -mn (floor(-LX) = -ceil(LX))
    x_lanes = jnp.concatenate(
        [jnp.where(ok, mxc, -big), jnp.where(ok, -mnc, -big)], axis=0
    )
    has_l = jnp.concatenate([ok, ok], axis=0)
    hgt_l = jnp.concatenate([heights, heights], axis=0)
    lanes = 2 * nseg

    empty = hgt_l < 0
    cur_r = jnp.zeros((lanes,), jnp.int32)  # local row 0 == global minr
    cur_x = x_lanes[:, 0]
    # seed boundary rows with the start vertex (covers single-row hulls)
    rxf = jnp.where(
        (lt[None, :] == 0) & ~empty[:, None], cur_x[:, None], -big
    )
    done = empty | (cur_r >= hgt_l)

    def next_vertex(cur_r, cur_x, done):
        valid = has_l & (lt[None, :] > cur_r[:, None]) & ~done[:, None]
        dr = jnp.maximum(lt[None, :] - cur_r[:, None], 1)
        dx = x_lanes - cur_x[:, None]  # |dx| <= 2^15 where valid
        key = jnp.where(valid, (dx << 16) // dr, kmin)
        kmax = jnp.max(key, axis=1)
        nv = kmax > kmin
        nr = jnp.max(
            jnp.where(valid & (key == kmax[:, None]), lt[None, :], 0), axis=1
        )
        nx = jnp.take_along_axis(x_lanes, nr[:, None], axis=1)[:, 0]
        return nr, nx, nv

    def cond(state):
        _, _, done, _, it = state
        return (it < max_iters) & jnp.any(~done)

    def body(state):
        cur_r, cur_x, done, rxf, it = state
        nr, nx, nv = next_vertex(cur_r, cur_x, done)
        step = ~done & nv
        dr = jnp.maximum(jnp.where(step, nr - cur_r, 1), 1)
        dx = nx - cur_x
        # exact rational boundary: floor((x0*dr + (t-r0)*dx) / dr)
        num = cur_x[:, None] * dr[:, None] + (
            lt[None, :] - cur_r[:, None]
        ) * dx[:, None]
        interp = num // dr[:, None]
        seg = (
            step[:, None]
            & (lt[None, :] >= cur_r[:, None])
            & (lt[None, :] <= nr[:, None])
        )
        rxf = jnp.maximum(rxf, jnp.where(seg, interp, -big))
        cur_r = jnp.where(step, nr, cur_r)
        cur_x = jnp.where(step, nx, cur_x)
        done = done | (cur_r >= hgt_l) | ~nv
        return cur_r, cur_x, done, rxf, it + 1

    state = (cur_r, cur_x, done, rxf, jnp.int32(0))
    _, _, done, rxf, _ = jax.lax.while_loop(cond, body, state)

    widths = rxf[:nseg] + rxf[nseg:] + 1
    areas = jnp.sum(jnp.where(ok, widths, 0), axis=1)
    saturated = ~done[:nseg] | ~done[nseg:]
    return areas, saturated


def _hull_areas_chains(mn, mx, has, max_iters: int = 64):
    """Full-width gift wrap (pairwise-tournament next vertex) — the
    fallback for frames with a region taller than ``_HULL_ROW_CAP`` rows,
    and the direct path for short frames."""

    import jax
    import jax.numpy as jnp

    nseg, h = mx.shape
    big = jnp.int32(1) << 29
    t = jnp.arange(h, dtype=jnp.int32)
    minr = jnp.min(jnp.where(has, t[None, :], big), axis=1)
    maxr = jnp.max(jnp.where(has, t[None, :], -1), axis=1)

    # lanes 0..nseg-1: right chain over mx; lanes nseg..: left chain as a
    # right chain over -mn (floor(-LX) = -ceil(LX))
    x_lanes = jnp.concatenate(
        [jnp.where(has, mx, -big), jnp.where(has, -mn, -big)], axis=0
    )
    has_l = jnp.concatenate([has, has], axis=0)
    minr_l = jnp.concatenate([minr, minr], axis=0)
    maxr_l = jnp.concatenate([maxr, maxr], axis=0)
    lanes = 2 * nseg

    empty = maxr_l < 0
    cur_r = jnp.where(empty, 0, minr_l)
    cur_x = jnp.take_along_axis(x_lanes, cur_r[:, None], axis=1)[:, 0]
    # seed boundary rows with the start vertex (covers single-row hulls)
    rxf = jnp.where(
        (t[None, :] == cur_r[:, None]) & ~empty[:, None], cur_x[:, None], -big
    )
    done = empty | (cur_r >= maxr_l)

    hp = 1
    while hp < h:
        hp *= 2
    pad = hp - h
    t_rows = jnp.broadcast_to(t[None, :], (lanes, h))

    def next_vertex(cur_r, cur_x, done):
        # exact argmax of slope from (cur_r, cur_x) over the remaining
        # candidate rows: log2(H) pairwise tournament, ties -> farthest
        # row (skips collinear points, like the host chain's <= pop)
        valid = has_l & (t_rows > cur_r[:, None]) & ~done[:, None]
        ar = jnp.pad(t_rows, ((0, 0), (0, pad)))
        ax = jnp.pad(x_lanes, ((0, 0), (0, pad)))
        av = jnp.pad(valid, ((0, 0), (0, pad)))
        n = hp
        while n > 1:
            n //= 2
            r0, r1 = ar[:, :n], ar[:, n : 2 * n]
            x0, x1 = ax[:, :n], ax[:, n : 2 * n]
            v0, v1 = av[:, :n], av[:, n : 2 * n]
            dr0 = r0 - cur_r[:, None]
            dr1 = r1 - cur_r[:, None]
            cross = (x1 - cur_x[:, None]) * dr0 - (x0 - cur_x[:, None]) * dr1
            take1 = v1 & (~v0 | (cross > 0) | ((cross == 0) & (r1 > r0)))
            ar = jnp.where(take1, r1, r0)
            ax = jnp.where(take1, x1, x0)
            av = v0 | v1
        return ar[:, 0], ax[:, 0], av[:, 0]

    def cond(state):
        _, _, done, _, it = state
        return (it < max_iters) & jnp.any(~done)

    def body(state):
        cur_r, cur_x, done, rxf, it = state
        nr, nx, nv = next_vertex(cur_r, cur_x, done)
        step = ~done & nv
        dr = jnp.maximum(jnp.where(step, nr - cur_r, 1), 1)
        dx = nx - cur_x
        # exact rational boundary: floor((x0*dr + (t-r0)*dx) / dr)
        num = cur_x[:, None] * dr[:, None] + (
            t[None, :] - cur_r[:, None]
        ) * dx[:, None]
        interp = num // dr[:, None]
        seg = (
            step[:, None]
            & (t[None, :] >= cur_r[:, None])
            & (t[None, :] <= nr[:, None])
        )
        rxf = jnp.maximum(rxf, jnp.where(seg, interp, -big))
        cur_r = jnp.where(step, nr, cur_r)
        cur_x = jnp.where(step, nx, cur_x)
        done = done | (cur_r >= maxr_l) | ~nv
        return cur_r, cur_x, done, rxf, it + 1

    state = (cur_r, cur_x, done, rxf, jnp.int32(0))
    _, _, done, rxf, _ = jax.lax.while_loop(cond, body, state)

    widths = rxf[:nseg] + rxf[nseg:] + 1
    areas = jnp.sum(jnp.where(has, widths, 0), axis=1)
    saturated = ~done[:nseg] | ~done[nseg:]
    return areas, saturated


# ---------------------------------------------------------------------------
# convex hull (host finalization for solidity)
def convex_hull_points(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; ``points`` (n, 2) as (r, c)."""

    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: List[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def convex_area(points: np.ndarray, shape: Tuple[int, int]) -> float:
    """Pixel count of the filled convex hull (skimage's convex_area)."""

    hull = convex_hull_points(points)
    if len(hull) <= 2:
        return float(len(np.unique(points, axis=0)))
    minr = int(hull[:, 0].min())
    maxr = int(hull[:, 0].max())
    count = 0
    # scan-line fill over hull edges (pixel centers inside or on the hull)
    edges = list(zip(hull, np.roll(hull, -1, axis=0)))
    for r in range(minr, maxr + 1):
        xs: List[float] = []
        for (r0, c0), (r1, c1) in edges:
            if r0 == r1:
                if r0 == r:
                    xs.extend([c0, c1])
                continue
            t = (r - r0) / (r1 - r0)
            if 0.0 <= t <= 1.0:
                xs.append(c0 + t * (c1 - c0))
        if not xs:
            continue
        lo = int(np.ceil(min(xs) - 1e-9))
        hi = int(np.floor(max(xs) + 1e-9))
        count += max(0, hi - lo + 1)
    return float(count)


def _hull_pixel_area(hull: np.ndarray) -> float:
    """Vectorized scan-line fill of the hull polygon — identical
    arithmetic to :func:`convex_area`'s row loop (same f64 divisions and
    ceil/floor epsilons), one numpy pass instead of rows x edges Python."""

    minr = int(hull[:, 0].min())
    maxr = int(hull[:, 0].max())
    r0 = hull[:, 0].astype(np.float64)
    c0 = hull[:, 1].astype(np.float64)
    r1 = np.roll(r0, -1)
    c1 = np.roll(c0, -1)
    rows = np.arange(minr, maxr + 1, dtype=np.float64)[:, None]
    horiz = r0 == r1
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rows - r0[None, :]) / (r1 - r0)[None, :]
    valid = (~horiz[None, :]) & (t >= 0.0) & (t <= 1.0)
    xs = c0[None, :] + t * (c1 - c0)[None, :]
    hmask = horiz[None, :] & (rows == r0[None, :])
    xs_min = np.where(valid, xs, np.inf)
    xs_min = np.minimum(
        xs_min, np.where(hmask, np.minimum(c0, c1)[None, :], np.inf)
    )
    xs_max = np.where(valid, xs, -np.inf)
    xs_max = np.maximum(
        xs_max, np.where(hmask, np.maximum(c0, c1)[None, :], -np.inf)
    )
    mn = xs_min.min(axis=1)
    mx = xs_max.max(axis=1)
    has = np.isfinite(mn)
    lo = np.ceil(mn[has] - 1e-9)
    hi = np.floor(mx[has] + 1e-9)
    return float(np.maximum(0.0, hi - lo + 1.0).sum())


def solidity_np(labels: np.ndarray, measurements: RegionMeasurements) -> np.ndarray:
    """area / filled-hull-area per region.

    Hull vertices on a pixel grid are always per-row column extremes, so
    each region's hull is built from <= 2 candidate points per bbox row
    (vectorized from the bbox crop) instead of every member pixel — the
    same hull polygon, orders of magnitude less Python.  Degenerate hulls
    (<= 2 vertices after collinear removal) fall back to the member-pixel
    count, exactly as the all-points implementation did.
    """

    out = np.zeros(measurements.count + 1, dtype=np.float64)
    for region in range(1, measurements.count + 1):
        minr, minc, maxr, maxc = measurements.bbox[region]
        crop = labels[minr:maxr, minc:maxc] == region
        rows, cols = np.nonzero(crop)
        if len(rows) == 0:
            continue
        order = np.lexsort((cols, rows))
        rs = rows[order]
        cs = cols[order]
        urows, starts = np.unique(rs, return_index=True)
        ends = np.append(starts[1:], len(cs)) - 1
        cand = np.concatenate(
            [
                np.stack([urows + minr, cs[starts] + minc], axis=1),
                np.stack([urows + minr, cs[ends] + minc], axis=1),
            ]
        )
        hull = convex_hull_points(cand)
        if len(hull) <= 2:
            hull_area = float(measurements.area[region])
        else:
            hull_area = _hull_pixel_area(hull)
        out[region] = measurements.area[region] / max(hull_area, 1.0)
    return out


__all__ = [
    "RegionMeasurements",
    "measure_np",
    "measure_j",
    "measure_with_perimeter_j",
    "measure_extremes_j",
    "row_extremes_j",
    "perimeters_np",
    "convex_hull_points",
    "convex_area",
    "solidity_np",
    "hull_pixel_areas_j",
]
