"""2-D filtering primitives: paired numpy (golden) and jnp (device) paths.

Conventions (matching the cv2 kernels the reference calls):

* filtering is cross-correlation (cv2.filter2D semantics, no kernel flip) —
  XLA's ``conv_general_dilated`` is also cross-correlation;
* default border is BORDER_REFLECT_101 (= numpy/jnp pad mode "reflect");
  median and adaptive-threshold use BORDER_REPLICATE (= "edge");
* float work happens in float32; uint8 outputs are produced by
  round-half-even + saturate, i.e. cv2's ``saturate_cast<uchar>(cvRound(x))``.

Integer ops (median, morphology in :mod:`.morphology`) are bit-exact between
the two paths; float convolutions agree to 1 ulp and are verified to at most
an off-by-one on uint8 in the parity suite.
"""
from __future__ import annotations

import numpy as np

_BORDER_NUMPY = {"reflect101": "reflect", "replicate": "edge", "reflect": "symmetric"}


# ---------------------------------------------------------------------------
# numpy path
def _pad_np(img: np.ndarray, ph: int, pw: int, border: str) -> np.ndarray:
    if ph == 0 and pw == 0:
        return img
    pad = [(ph, ph), (pw, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode=_BORDER_NUMPY[border])


def sep_filter_np(
    img: np.ndarray,
    taps_y: np.ndarray,
    taps_x: np.ndarray,
    border: str = "reflect101",
) -> np.ndarray:
    """Separable correlation in float32; returns float32."""

    taps_y = np.asarray(taps_y, dtype=np.float32)
    taps_x = np.asarray(taps_x, dtype=np.float32)
    ry, rx = len(taps_y) // 2, len(taps_x) // 2
    work = _pad_np(img, ry, rx, border).astype(np.float32)
    h, w = img.shape[0], img.shape[1]
    # horizontal pass (sequential accumulation order shared with jnp path)
    acc = np.zeros((work.shape[0], w) + img.shape[2:], dtype=np.float32)
    for i in range(len(taps_x)):
        acc += taps_x[i] * work[:, i : i + w]
    out = np.zeros((h, w) + img.shape[2:], dtype=np.float32)
    for j in range(len(taps_y)):
        out += taps_y[j] * acc[j : j + h]
    return out


def filter2d_np(
    img: np.ndarray, kernel: np.ndarray, border: str = "reflect101"
) -> np.ndarray:
    """Dense 2-D correlation in float32."""

    kernel = np.asarray(kernel, dtype=np.float32)
    kh, kw = kernel.shape
    ry, rx = kh // 2, kw // 2
    work = _pad_np(img, ry, rx, border).astype(np.float32)
    h, w = img.shape[0], img.shape[1]
    out = np.zeros((h, w) + img.shape[2:], dtype=np.float32)
    for j in range(kh):
        for i in range(kw):
            out += kernel[j, i] * work[j : j + h, i : i + w]
    return out


def median_np(img: np.ndarray, ksize: int) -> np.ndarray:
    """Exact integer median over a k x k window, BORDER_REPLICATE."""

    r = ksize // 2
    work = _pad_np(img, r, r, "replicate")
    h, w = img.shape[0], img.shape[1]
    windows = np.stack(
        [work[j : j + h, i : i + w] for j in range(ksize) for i in range(ksize)],
        axis=0,
    )
    windows.sort(axis=0, kind="stable")
    return windows[(ksize * ksize) // 2].astype(img.dtype)


def bilateral_np(
    img: np.ndarray,
    ksize: int,
    sigma_color: float,
    sigma_space: float,
) -> np.ndarray:
    """Bilateral filter with cv2's circular window / abs-sum color distance."""

    from yamimageprocessor_tpu.ops._kernels import (
        bilateral_color_weights,
        bilateral_space_weights,
    )

    space_w, mask = bilateral_space_weights(ksize, sigma_space)
    channels = 1 if img.ndim == 2 else img.shape[2]
    color_lut = bilateral_color_weights(sigma_color, channels).astype(np.float32)
    radius = space_w.shape[0] // 2
    # cv2.bilateralFilter default border is BORDER_REFLECT_101
    work = _pad_np(img, radius, radius, "reflect101").astype(np.float32)
    h, w = img.shape[0], img.shape[1]
    centre = img.astype(np.float32)
    num = np.zeros_like(centre)
    den = np.zeros(img.shape[:2], dtype=np.float32)
    for j in range(space_w.shape[0]):
        for i in range(space_w.shape[1]):
            if not mask[j, i]:
                continue
            sw = np.float32(space_w[j, i])
            nb = work[j : j + h, i : i + w]
            if img.ndim == 2:
                k = np.abs(nb - centre).astype(np.int32)
            else:
                k = np.abs(nb - centre).sum(axis=-1).astype(np.int32)
            wgt = sw * color_lut[k]
            den += wgt
            num += (wgt[..., None] if img.ndim == 3 else wgt) * nb
    out = num / (den[..., None] if img.ndim == 3 else den)
    return out


def to_uint8_np(x: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar>(cvRound(x)) — round half to even, clip."""

    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# jnp path
def _pad_j(img, ph: int, pw: int, border: str):
    import jax.numpy as jnp

    if ph == 0 and pw == 0:
        return img
    pad = [(ph, ph), (pw, pw)] + [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, pad, mode=_BORDER_NUMPY[border])


def sep_filter_j(img, taps_y, taps_x, border: str = "reflect101"):
    """Separable correlation in float32 on device.

    ``taps_*`` are traced 1-D f32 arrays with static length, so sigma/kernel
    value changes never recompile; accumulation order matches the numpy twin.
    """

    import jax.numpy as jnp

    ky = taps_y.shape[0]
    kx = taps_x.shape[0]
    ry, rx = ky // 2, kx // 2
    work = _pad_j(img, ry, rx, border).astype(jnp.float32)
    h, w = img.shape[0], img.shape[1]
    if kx >= 13:
        # wide kernels: run the horizontal pass as a VERTICAL pass on the
        # transposed frame (row-offset slices instead of minor-dim offset
        # slices) and transpose back.  Per-element
        # FMA order is unchanged, so the result stays bit-identical to the
        # direct form and to the numpy twin.
        workT = jnp.swapaxes(work, 0, 1)
        accT = jnp.zeros((w, work.shape[0]) + img.shape[2:], dtype=jnp.float32)
        for i in range(kx):
            accT = accT + taps_x[i] * workT[i : i + w]
        acc = jnp.swapaxes(accT, 0, 1)
    else:
        acc = jnp.zeros((work.shape[0], w) + img.shape[2:], dtype=jnp.float32)
        for i in range(kx):
            acc = acc + taps_x[i] * jnp.asarray(work[:, i : i + w])
    out = jnp.zeros((h, w) + img.shape[2:], dtype=jnp.float32)
    for j in range(ky):
        out = out + taps_y[j] * acc[j : j + h]
    return out


def filter2d_j(img, kernel, border: str = "reflect101"):
    """Dense 2-D correlation in float32 on device (static kernel shape)."""

    import jax.numpy as jnp

    kh, kw = kernel.shape
    ry, rx = kh // 2, kw // 2
    work = _pad_j(img, ry, rx, border).astype(jnp.float32)
    h, w = img.shape[0], img.shape[1]
    out = jnp.zeros((h, w) + img.shape[2:], dtype=jnp.float32)
    for j in range(kh):
        for i in range(kw):
            out = out + kernel[j, i] * work[j : j + h, i : i + w]
    return out


# optimal 9-compare-exchange 5-element sorting network (validated on all
# 2^5 binary inputs per the 0-1 principle)
_SORT5_PAIRS = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4), (1, 3), (1, 2))

# After sorting the 5x5 window's columns then its rows, entry (i, j) is >=
# every entry of the upper-left (i+1)x(j+1) block and <= every entry of the
# lower-right (5-i)x(5-j) block, so it can be the 13th-of-25 only when both
# blocks stay <= 13 — these 13 positions.  The median of 25 equals the
# median of these 13 candidates (proved exhaustively over all 2^25 binary
# inputs by the 0-1 principle; see tests/test_preprocess_ops.py).
_MEDIAN25_CANDIDATES = (
    (0, 3), (0, 4),
    (1, 2), (1, 3), (1, 4),
    (2, 1), (2, 2), (2, 3),
    (3, 0), (3, 1), (3, 2),
    (4, 0), (4, 1),
)


def median25_candidates_partial(rows5, mn, mx):
    """The 13 rank-feasible candidates of `_MEDIAN25_CANDIDATES` as
    MULTISETS, without fully sorting the rows: per column-sorted row only
    the needed ranks are extracted (top-2 / top-3 / mid-3 / bottom-3 /
    bottom-2 — 32 exchanges total vs 45 for five full row 5-sorts).  The
    candidates feed a forgetful median, which is order-insensitive, so
    multiset equality is all that is required; the whole construction is
    min/max-monotone, so the exhaustive 0-1 test
    (tests/test_preprocess_ops.py::test_median25_network_exhaustive_zero_one)
    is a proof for all inputs.

    ``rows5`` is a list of 5 rows, each a list of the 5 window taps of the
    column-rank plane; ``mn``/``mx`` are the comparator pair (jnp min/max
    on device, logical and/or in the 0-1 proof)."""

    def top2(v):
        # top-2 of 5 as a multiset: 2nd-of-4 = max(min of the two pair
        # maxima, max of the two pair minima), then merge the 5th element
        a, b, c, d, e = v
        p1, p2 = mx(a, b), mn(a, b)
        q1, q2 = mx(c, d), mn(c, d)
        m4, t = mx(p1, q1), mn(p1, q1)
        s4 = mx(t, mx(p2, q2))
        return [mx(m4, e), mx(s4, mn(m4, e))]

    def bottom2(v):
        a, b, c, d, e = v
        p1, p2 = mn(a, b), mx(a, b)
        q1, q2 = mn(c, d), mx(c, d)
        m4, t = mn(p1, q1), mx(p1, q1)
        s4 = mn(t, mn(p2, q2))
        return [mn(m4, e), mn(s4, mx(m4, e))]

    def drop_min(v):
        v = list(v)
        for i in range(1, len(v)):
            v[0], v[i] = mn(v[0], v[i]), mx(v[0], v[i])
        return v[1:]

    def drop_max(v):
        v = list(v)
        for i in range(len(v) - 1):
            v[i], v[-1] = mn(v[i], v[-1]), mx(v[i], v[-1])
        return v[:-1]

    return (
        top2(rows5[0])
        + drop_min(drop_min(rows5[1]))
        + drop_max(drop_min(rows5[2]))
        + drop_max(drop_max(rows5[3]))
        + bottom2(rows5[4])
    )


def median_j(img, ksize: int):
    """Exact integer median (bit-identical to :func:`median_np`).

    ksize=3 uses the classic 19-exchange median-of-9 selection network
    (min/max only — ~10x faster on the VPU than a full 9-element sort);
    ksize=5 uses a shared-column-sort construction (102 exchanges/pixel
    vs 165 for plain forgetful selection: the vertical 5-sort is computed
    once per COLUMN on full-width planes and shared by the 5 windows that
    contain it, then per-output row sorts + a 13-candidate forgetful
    median finish the selection);
    larger apertures fall back to forgetful selection over the window.
    """

    import jax.numpy as jnp

    if ksize == 1:  # 1x1 window: the median of one tap is the pixel itself
        return img

    r = ksize // 2
    work = _pad_j(img, r, r, "replicate")
    h, w = img.shape[0], img.shape[1]

    if ksize == 5:
        mn, mx = jnp.minimum, jnp.maximum

        def sort5(v):
            v = list(v)
            for a, b in _SORT5_PAIRS:
                lo, hi = mn(v[a], v[b]), mx(v[a], v[b])
                v[a], v[b] = lo, hi
            return v

        # vertical sort on full-width planes: amortized across the 5
        # horizontally-overlapping windows sharing each column (9 CEs for
        # all five rank planes instead of 45 per window); the row stage
        # extracts only the rank-feasible candidates per row (32 CEs vs
        # 45 for full row sorts — the forgetful median below is
        # order-insensitive, so multisets suffice)
        vsorted = sort5([work[j : j + h, :] for j in range(5)])
        window = median25_candidates_partial(
            [[p[:, i : i + w] for i in range(5)] for p in vsorted], mn, mx
        )

        def drop_min_max13(win):
            win = list(win)
            for i in range(1, len(win)):
                lo, hi = mn(win[0], win[i]), mx(win[0], win[i])
                win[0], win[i] = lo, hi
            for i in range(1, len(win) - 1):
                lo, hi = mn(win[i], win[-1]), mx(win[i], win[-1])
                win[i], win[-1] = lo, hi
            return win[1:-1]

        sel = window[:8]
        for tap in window[8:]:
            sel = drop_min_max13(sel)
            sel.append(tap)
        sel = drop_min_max13(sel)
        assert len(sel) == 1
        return sel[0].astype(img.dtype)

    if ksize == 3:
        mn, mx = jnp.minimum, jnp.maximum

        def mid3(a, b, c):
            return mx(mn(a, b), mn(mx(a, b), c))

        # shared-column variant of the classic median-of-9 selection: the
        # vertical 3-sort runs once per COLUMN on full-width planes (3 CEs
        # shared by the 3 overlapping windows) and the candidate positions
        # after column sorting need only max(row0)/mid(row1)/min(row2) —
        # 13 exchanges/pixel vs 19 for the per-window network (same 0-1
        # exhaustive proof pattern as the 5x5 construction).
        v0, v1, v2 = (work[j : j + h, :] for j in range(3))
        lo1, hi1 = mn(v0, v1), mx(v0, v1)
        lo2, hi2 = mn(hi1, v2), mx(hi1, v2)
        smin, smid = mn(lo1, lo2), mx(lo1, lo2)
        smax = hi2

        def shifts(p):
            return p[:, 0:w], p[:, 1 : 1 + w], p[:, 2 : 2 + w]

        a0, a1, a2 = shifts(smin)
        hi_of_mins = mx(mx(a0, a1), a2)
        b0, b1, b2 = shifts(smid)
        med_of_mids = mid3(b0, b1, b2)
        c0, c1, c2 = shifts(smax)
        lo_of_maxs = mn(mn(c0, c1), c2)
        return mid3(hi_of_mins, med_of_mids, lo_of_maxs).astype(img.dtype)

    taps = [
        work[j : j + h, i : i + w] for j in range(ksize) for i in range(ksize)
    ]

    # forgetful selection (the standard GPU median-filter construction):
    # hold a window of W = (n+3)/2 taps, push its min to the front and max
    # to the back with compare-exchanges, drop both (provably not the
    # median), append one fresh tap, repeat with a window one smaller each
    # round.  For n=25 that is 165 exchanges vs 300 for a full sort.
    mn, mx = jnp.minimum, jnp.maximum
    n = len(taps)

    def drop_min_max(window):
        w = list(window)
        for i in range(1, len(w)):
            lo, hi = mn(w[0], w[i]), mx(w[0], w[i])
            w[0], w[i] = lo, hi
        for i in range(1, len(w) - 1):
            lo, hi = mn(w[i], w[-1]), mx(w[i], w[-1])
            w[i], w[-1] = lo, hi
        return w[1:-1]

    width = (n + 3) // 2
    window = taps[:width]
    for tap in taps[width:]:
        window = drop_min_max(window)
        window.append(tap)
    window = drop_min_max(window)
    assert len(window) == 1
    return window[0].astype(img.dtype)


def bilateral_j(img, space_w_flat, color_lut, *, offsets, ksize: int):
    """Bilateral filter on device.

    ``offsets`` is a static tuple of (dy, dx) window offsets (it shapes the
    program); ``space_w_flat`` (k,) f32 and ``color_lut`` (256*C,) f32 are
    host-prepared dynamic inputs.
    """

    import jax.numpy as jnp

    radius = ksize // 2 if ksize // 2 >= 1 else 1
    work = _pad_j(img, radius, radius, "reflect101").astype(jnp.float32)
    h, w = img.shape[0], img.shape[1]
    centre = img.astype(jnp.float32)
    num = jnp.zeros_like(centre)
    den = jnp.zeros(img.shape[:2], dtype=jnp.float32)
    for idx, (j, i) in enumerate(offsets):
        sw = space_w_flat[idx]
        nb = work[j : j + h, i : i + w]
        if img.ndim == 2:
            k = jnp.abs(nb - centre).astype(jnp.int32)
        else:
            k = jnp.abs(nb - centre).sum(axis=-1).astype(jnp.int32)
        wgt = sw * color_lut[k]
        den = den + wgt
        num = num + (wgt[..., None] if img.ndim == 3 else wgt) * nb
    return num / (den[..., None] if img.ndim == 3 else den)


def to_uint8_j(x):
    import jax.numpy as jnp

    return jnp.clip(jnp.rint(x), 0, 255).astype(jnp.uint8)


__all__ = [
    "sep_filter_np",
    "filter2d_np",
    "median_np",
    "bilateral_np",
    "to_uint8_np",
    "sep_filter_j",
    "filter2d_j",
    "median_j",
    "bilateral_j",
    "to_uint8_j",
]
