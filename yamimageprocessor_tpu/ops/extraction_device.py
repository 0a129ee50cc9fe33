"""Jittable device feature kernels for the extraction stage.

Reference kernels (``core/extraction.py:57-443``) run per-region python
loops and an O(H*W) interpreted GLCM; these twins express the same math as
segment reductions, one-hot contractions and pooled reductions so the
BASELINE extraction config runs on the accelerator.  DataFrame assembly and
(for text overlays) annotation remain host finalizations: annotation text
embeds float64-formatted host numbers, so raster parity there is
meaningless — the parity surface is the FEATURES, asserted in
``tests/test_extraction_device.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from yamimageprocessor_tpu.ops import color as C
from yamimageprocessor_tpu.ops import hogf as H
from yamimageprocessor_tpu.ops import regionprops as RP
from yamimageprocessor_tpu.ops import texture as TX
from yamimageprocessor_tpu.ops import threshold as T
from yamimageprocessor_tpu.ops.labeling import label_j

# static region-capacity tiers for padded per-region outputs.  Every
# reduction costs O(H*W*capacity) (one-hot lanes), so frames climb the
# ladder only as far as their raw label count demands; 1024 keeps the
# BASELINE-class dense 4096² scene (32x32 cell grid) on the device path,
# and past it the caller falls back to the unbounded host labeling.
MAX_REGIONS = 1024
MID_REGIONS = 512


def binary_j(img, maxval: int = 255):
    """Device twin of extraction's Otsu binarization helper."""

    gray = C.bgr_to_gray_j(img) if img.ndim == 3 else img
    return T.binary_j(gray, T.otsu_threshold_j(gray), maxval=maxval)


def _derived_features(feats, max_regions: int):
    """Extent / orientation / eccentricity / count derived in place from
    the packed measurements (shared by the single and bundled paths)."""

    import jax.numpy as jnp

    area = feats["area"]
    heights = jnp.maximum(feats["max_r"] - feats["min_r"] + 1.0, 1.0)
    widths = jnp.maximum(feats["max_c"] - feats["min_c"] + 1.0, 1.0)
    feats["extent"] = area / (heights * widths)
    safe = jnp.maximum(area, 1.0)
    a = feats["mu20"] / safe
    b = feats["mu11"] / safe
    c = feats["mu02"] / safe
    # skimage inertia-tensor convention (see RegionMeasurements.orientation)
    feats["orientation"] = jnp.where(
        a - c == 0,
        jnp.where(b > 0, -np.pi / 4.0, np.pi / 4.0),
        0.5 * jnp.arctan2(2.0 * b, a - c),
    )
    common = jnp.sqrt(jnp.maximum((a - c) ** 2 + 4.0 * b * b, 0.0))
    l1 = (a + c + common) / 2.0
    l2 = (a + c - common) / 2.0
    ecc = jnp.sqrt(jnp.maximum(1.0 - l2 / jnp.maximum(l1, 1e-12), 0.0))
    feats["eccentricity"] = jnp.where(area > 0, ecc, 0.0)
    feats["count"] = jnp.sum(area[1:] > 0).astype(jnp.int32)
    return feats


def _labeled_measurements(img, max_regions: int):
    """(labels, feats, (mn, mx, has)) — the shared front half of the
    feature bundle; the row extremes feed the device hull kernel."""

    labels = label_j(binary_j(img) > 0)
    feats, extremes = RP.measure_extremes_j(labels, max_regions)
    return labels, _derived_features(feats, max_regions), extremes


def region_features_j(img, max_regions: int = MAX_REGIONS):
    """Labels + per-region measurements (padded to ``max_regions``).

    Returns (labels, feats) where feats carries area/centroid/bbox/moment
    arrays of shape (max_regions+1,); matches ``RP.measure_np``.
    """

    labels, feats, _ = _labeled_measurements(img, max_regions)
    return labels, feats


def region_annotate_j(img, feats):
    """Device twin of the region_properties annotation: bounding-box
    borders (thickness 2, offsets {-1, 0} like ``AN.rect_border``) plus
    radius-3 centroid disks — value-independent geometry, bit-exact vs the
    host annotate helpers."""

    import jax
    import jax.numpy as jnp

    h, w = img.shape[:2]
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    area = feats["area"]

    # integer annotation coordinates exactly as the host path casts them
    minr = feats["min_r"].astype(jnp.int32)
    minc = feats["min_c"].astype(jnp.int32)
    maxr = (feats["max_r"] + 1.0).astype(jnp.int32)
    maxc = (feats["max_c"] + 1.0).astype(jnp.int32)
    cen_r = jnp.floor(feats["centroid_r"]).astype(jnp.int32)
    cen_c = jnp.floor(feats["centroid_c"]).astype(jnp.int32)
    valid = area > 0
    valid = valid.at[0].set(False)

    def border_mask(x0, y0, x1, y1, ok):
        # two nested outlines: off in {-1, 0} (thickness=2 in rect_border)
        m = jnp.zeros((h, w), bool)
        for off in (-1, 0):
            xa, ya, xb, yb = x0 - off, y0 - off, x1 + off, y1 + off
            cxa = jnp.clip(jnp.minimum(xa, xb), 0, w - 1)
            cxb = jnp.clip(jnp.maximum(xa, xb), 0, w - 1)
            cya = jnp.clip(jnp.minimum(ya, yb), 0, h - 1)
            cyb = jnp.clip(jnp.maximum(ya, yb), 0, h - 1)
            in_x = (cols >= cxa) & (cols <= cxb)
            in_y = (rows >= cya) & (rows <= cyb)
            m = m | (in_x & ((rows == ya) | (rows == yb)))
            m = m | (in_y & ((cols == xa) | (cols == xb)))
        return m & ok

    def disk_mask(cx, cy, ok):
        return (((cols - cx) ** 2 + (rows - cy) ** 2) <= 9) & ok

    # fold over regions painting in the host loop's order (border then
    # disk per region) so overlapping annotations resolve identically; a
    # vmapped mask stack would also materialize (max_regions, H, W) bools
    if img.ndim == 2:
        green = jnp.uint8(85)  # grayscale target: mean of (0, 255, 0)
        red = jnp.uint8(85)  # mean of (0, 0, 255)
    else:
        green = jnp.array([0, 255, 0], dtype=img.dtype)
        red = jnp.array([0, 0, 255], dtype=img.dtype)

    def paint(r, out):
        b = border_mask(minc[r], minr[r], maxc[r], maxr[r], valid[r])
        d = disk_mask(cen_c[r], cen_r[r], valid[r])
        if img.ndim == 2:
            return jnp.where(d, red, jnp.where(b, green, out))
        return jnp.where(d[..., None], red, jnp.where(b[..., None], green, out))

    return jax.lax.fori_loop(1, area.shape[0], paint, img)


def region_properties_device_fn(img, dyn, *, max_regions: int = MAX_REGIONS):
    """image -> annotated image, fully on device."""

    _, feats = region_features_j(img, max_regions)
    return region_annotate_j(img, feats)


def hu_features_j(img):
    """Device Hu invariants of the Otsu binarization (f32)."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import shape as SH

    m = SH.moments_j(binary_j(img))
    n20, n02, n11 = m["nu20"], m["nu02"], m["nu11"]
    n30, n03, n21, n12 = m["nu30"], m["nu03"], m["nu21"], m["nu12"]
    h1 = n20 + n02
    h2 = (n20 - n02) ** 2 + 4 * n11**2
    h3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h5 = (n30 - 3 * n12) * (n30 + n12) * (
        (n30 + n12) ** 2 - 3 * (n21 + n03) ** 2
    ) + (3 * n21 - n03) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    h6 = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) + 4 * n11 * (
        n30 + n12
    ) * (n21 + n03)
    h7 = (3 * n21 - n03) * (n30 + n12) * (
        (n30 + n12) ** 2 - 3 * (n21 + n03) ** 2
    ) - (n30 - 3 * n12) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    return jnp.stack([h1, h2, h3, h4, h5, h6, h7])


def haralick_features_j(img, *, distance: int = 1, angle: float = 0.0):
    """Device GLCM props (contrast/correlation/energy/homogeneity)."""

    import jax.numpy as jnp

    gray = C.bgr_to_gray_j(img) if img.ndim == 3 else img
    dx = int(round(distance * np.cos(angle)))
    dy = int(round(distance * np.sin(angle)))
    glcm = TX.glcm_j(gray, dx=dx, dy=dy)
    props = TX.glcm_props(glcm)
    return jnp.stack(
        [props["contrast"], props["correlation"], props["energy"], props["homogeneity"]]
    )


def histogram_features_j(img):
    """Device mean/variance/skewness/kurtosis of the gray histogram."""

    import jax.numpy as jnp

    gray = C.bgr_to_gray_j(img) if img.ndim == 3 else img
    mean, m2, skew, kurt = TX.histogram_stats_j(gray)
    return jnp.stack([mean, m2, skew, kurt])


def fractal_feature_j(img, *, min_box_size: int = 2):
    """Device box-count fractal dimension of the Otsu mask."""

    return H.fractal_dimension_j(binary_j(img, maxval=1), min_box_size)


def hog_device_fn(
    img,
    dyn,
    *,
    orientations: int = 9,
    pixels_per_cell: Tuple[int, int] = (8, 8),
    cells_per_block: Tuple[int, int] = (3, 3),
):
    """image -> HOG visualization (uint8), fully on device."""

    import jax.numpy as jnp

    gray = C.bgr_to_gray_j(img) if img.ndim == 3 else img
    _, hist = H.hog_features_j(
        gray,
        orientations=int(orientations),
        pixels_per_cell=tuple(pixels_per_cell),
        cells_per_block=tuple(cells_per_block),
    )
    viz = H.hog_visualize_j(
        hist, gray.shape, tuple(pixels_per_cell), int(orientations)
    )
    lo = viz.min()
    hi = viz.max()
    return (255.0 * (viz - lo) / (hi - lo + 1e-6)).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# (F) Fourier descriptors — device DFT over padded contours
# (reference core/extraction.py:204-245: FFT of the largest contour,
# truncate to +-num_coeff, reconstruct).  Contour TRACING stays host (a
# sequential Moore automaton); the numeric core — the +-k spectral lines
# and the truncated-spectrum reconstruction — runs as two masked matmuls
# over a power-of-two padded point list, so ONE compiled kernel serves
# every contour length in the bucket.  Angles reduce (m*j) mod n in int32
# before the f32 cos/sin, keeping precision at any contour length.


def fourier_dft_j(pts, n, ms, dup_w):
    """pts (N, 2) f32 padded points; n traced true length; ms (2k,) the
    spectral indices [0..k-1, n-k..n-1]; dup_w (2k,) zeroes the second
    copy of any index that appears in both halves (n < 2k), matching the
    golden path's overwrite-not-add ``kept`` construction.

    Returns (coeff_re, coeff_im, recon) — recon (N, 2) valid to row n.
    """

    import jax
    import jax.numpy as jnp

    cap = pts.shape[0]
    j = jnp.arange(cap, dtype=jnp.int32)
    valid = j < n
    zr = jnp.where(valid, pts[:, 0], 0.0)
    zi = jnp.where(valid, pts[:, 1], 0.0)
    nf = jnp.float32(n)
    # (m*j) mod n in int32 without overflow for long contours: m*j reaches
    # n*cap (~2^32+ past ~32k points), so reduce via the byte split
    # m*j = (m*(j>>8))<<8 + m*(j&255), each term < 2^26 for cap <= 2^22
    mhi = (ms[:, None].astype(jnp.int32) * (j // 256)[None, :]) % n
    mj = (mhi * 256 + ms[:, None].astype(jnp.int32) * (j % 256)[None, :]) % n
    theta = (2.0 * np.pi) * mj.astype(jnp.float32) / nf
    c = jnp.cos(theta) * valid[None, :]
    s = jnp.sin(theta) * valid[None, :]
    # forward: coeff_m = sum_j z_j * exp(-i theta); HIGHEST keeps the
    # contractions in full f32 (no TF32) against the f64 golden
    def mm(a, b):
        return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

    re = mm(c, zr) + mm(s, zi)
    im = mm(c, zi) - mm(s, zr)
    # inverse of the truncated spectrum: recon_j = (1/n) sum_m kept_m e^{+i theta}
    kr = re * dup_w
    ki = im * dup_w
    rr = (mm(c.T, kr) - mm(s.T, ki)) / nf
    ri = (mm(s.T, kr) + mm(c.T, ki)) / nf
    recon = jnp.stack([rr, ri], axis=1) * valid[:, None]
    return re, im, recon


_FOURIER_JITS: Dict[Tuple[int, int], object] = {}


def fourier_descriptors_device(points_xy: np.ndarray, num_coeff: int):
    """Host wrapper: pad to a power-of-two bucket, run the cached kernel,
    trim.  Returns (selected coeffs complex (2k,), recon (n, 2))."""

    import jax
    import jax.numpy as jnp

    n = len(points_xy)
    k = min(int(num_coeff), n)
    if k == 0 or n == 0:
        return np.zeros(0, complex), np.zeros((0, 2))
    cap = 64
    while cap < n:
        cap *= 2
    key = (cap, k)
    fn = _FOURIER_JITS.get(key)
    if fn is None:
        fn = jax.jit(fourier_dft_j)
        _FOURIER_JITS[key] = fn
    pts = np.zeros((cap, 2), np.float32)
    pts[:n] = points_xy[:, :2]
    t = np.arange(k)
    ms = np.concatenate([t, (n - k + t) % n]).astype(np.int32)
    # zero duplicated spectral lines in the reconstruction only (the CSV
    # keeps both copies, exactly like the golden concat)
    dup = np.zeros(2 * k, np.float32)
    dup[:k] = 1.0
    dup[k:] = (~np.isin(ms[k:], ms[:k])).astype(np.float32)
    re, im, recon = fn(
        jnp.asarray(pts), jnp.int32(n), jnp.asarray(ms), jnp.asarray(dup)
    )
    re, im, recon = jax.device_get((re, im, recon))
    return re.astype(np.float64) + 1j * im.astype(np.float64), recon[:n].astype(
        np.float64
    )


# ---------------------------------------------------------------------------
# (J) Approximate polygon — device error evaluation for the epsilon
# search (reference core/extraction.py:339-421).  Douglas-Peucker itself
# is a cheap host recursion over <=hundreds of vertices; the O(factors *
# points * vertices) mean-boundary-error evaluation is the hot loop and
# runs as one masked device reduction over every candidate polygon.


def polygon_mean_errors_j(contour, npts, polys, nverts):
    """contour (N, 2) f32 padded, npts traced; polys (F, V, 2) f32 padded
    candidate polygons with true vertex counts nverts (F,).  Returns (F,)
    mean over valid contour points of the min point-to-edge distance —
    the device twin of ``SH.point_polygon_distance`` averaged."""

    import jax
    import jax.numpy as jnp

    cap = contour.shape[0]
    fcount, vcap, _ = polys.shape
    j = jnp.arange(vcap, dtype=jnp.int32)
    pvalid = jnp.arange(cap) < npts
    pw = pvalid.astype(jnp.float32)

    def one(poly, nv):
        evalid = j < nv
        nxt = jnp.where(j + 1 < nv, j + 1, 0)
        a = poly  # (V, 2)
        b = poly[nxt]
        ab = b - a  # (V, 2)
        denom = (ab * ab).sum(-1)  # (V,)
        ap = contour[:, None, :] - a[None, :, :]  # (N, V, 2)
        t = (ap * ab[None, :, :]).sum(-1) / jnp.maximum(denom, 1e-30)[None, :]
        t = jnp.where(denom[None, :] == 0, 0.0, jnp.clip(t, 0.0, 1.0))
        q = a[None, :, :] + t[..., None] * ab[None, :, :]
        d = jnp.sqrt(((contour[:, None, :] - q) ** 2).sum(-1))  # (N, V)
        d = jnp.where(evalid[None, :], d, jnp.inf)
        best = jnp.min(d, axis=1)  # (N,)
        return (best * pw).sum() / jnp.maximum(pw.sum(), 1.0)

    return jax.lax.map(lambda args: one(*args), (polys, nverts))


_POLYERR_JITS: Dict[Tuple[int, int, int], object] = {}


def polygon_mean_errors_device(
    contour: np.ndarray, polys: list
) -> np.ndarray:
    """Host wrapper: bucket-pad the contour and candidate polygons, one
    dispatch, one scalar vector back."""

    import jax
    import jax.numpy as jnp

    n = len(contour)
    cap = 64
    while cap < n:
        cap *= 2
    vmax = max(len(p) for p in polys)
    vcap = 8
    while vcap < vmax:
        vcap *= 2
    key = (cap, vcap, len(polys))
    fn = _POLYERR_JITS.get(key)
    if fn is None:
        fn = jax.jit(polygon_mean_errors_j)
        _POLYERR_JITS[key] = fn
    cpad = np.zeros((cap, 2), np.float32)
    cpad[:n] = contour[:, :2]
    ppad = np.zeros((len(polys), vcap, 2), np.float32)
    nv = np.zeros(len(polys), np.int32)
    for i, p in enumerate(polys):
        ppad[i, : len(p)] = p
        nv[i] = len(p)
    out = fn(jnp.asarray(cpad), jnp.int32(n), jnp.asarray(ppad), jnp.asarray(nv))
    return np.asarray(out).astype(np.float64)


def use_device_extraction() -> bool:
    """Data-path routing: device features on any accelerator, numpy golden
    on the CPU harness (tests compare the two directly)."""

    import jax

    if jax.default_backend() == "cpu":
        return False
    from yamimageprocessor_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()  # idempotent
    return True


HULL_CHAIN_CAP = 64  # gift-wrap iterations per hull chain (vertices/side)
HULL_COORD_LIMIT = 16384  # exact-int32 cross-product bound (pixels/side)

# packed feature row order (everything — features, hull pixel areas,
# saturation flag, overflow detector — rides ONE (16, R+1) f32 transfer
# instead of a dict of blocking per-array pulls, one device sync each).
# max_label makes overflow
# detection EXACT: labels beyond the static capacity clip into the last
# segment, so ``count == capacity`` alone cannot distinguish "exactly
# capacity regions" (valid) from "clipped" (garbage) — the raw label
# maximum can.  Hull areas reach 2^28 (16k frames), past f32's exact
# integer range, so they ship split into 4096-quotient/remainder rows.
_PACK_KEYS = (
    "area",
    "centroid_r",
    "centroid_c",
    "min_r",
    "min_c",
    "max_r",
    "max_c",
    "mu20",
    "mu02",
    "mu11",
    "perimeter",
    "count",
    "max_label",
    "hull_hi",
    "hull_lo",
    "hull_sat",
)


def region_packed_j(img, max_regions: int = MAX_REGIONS):
    """Single-dispatch extraction bundle: labels stay on device; features
    and convex-hull pixel areas (``RP.hull_pixel_areas_j`` — bit-identical
    to the host scan-line fill, eliminating the label download for
    solidity) fuse into ONE f32 array so the host needs a single small D2H
    transfer per frame."""

    import jax.numpy as jnp

    labels, feats, (mn, mx, has) = _labeled_measurements(img, max_regions)
    feats["max_label"] = jnp.max(labels).astype(jnp.float32)
    hull, hull_sat = RP.hull_pixel_areas_j(mn, mx, has, HULL_CHAIN_CAP)
    feats["hull_hi"] = (hull // 4096).astype(jnp.float32)
    feats["hull_lo"] = (hull % 4096).astype(jnp.float32)
    feats["hull_sat"] = hull_sat.astype(jnp.float32)
    bundle = jnp.stack(
        [
            jnp.broadcast_to(
                jnp.asarray(feats[k], jnp.float32), (max_regions + 1,)
            )
            for k in _PACK_KEYS
        ]
    )
    return labels, bundle


FAST_REGIONS = 64  # first-tier capacity: most frames have < 64 regions

_region_packed_jits: Dict[int, object] = {}


def _jitted_region_packed(max_regions: int = MAX_REGIONS):
    """Module-cached jit wrappers keyed by region capacity: a fresh
    ``jax.jit`` per call would re-trace every invocation (the data path is
    called per file in mass extraction)."""

    fn = _region_packed_jits.get(max_regions)
    if fn is None:
        import functools

        import jax

        fn = jax.jit(
            functools.partial(region_packed_j, max_regions=max_regions)
        )
        _region_packed_jits[max_regions] = fn
    return fn


_region_packed_batch_jits: Dict[int, object] = {}


def _jitted_region_packed_batch(max_regions: int = MAX_REGIONS):
    """vmapped twin of :func:`_jitted_region_packed` over a frame stack:
    ONE H2D upload and ONE dispatch for the whole batch (the labeling
    kernels carry custom_vmap rules, so the stack maps cleanly).  Per-call
    link latency dominates mass extraction on high-latency hosts — eight
    1 MiB uploads cost ~8 sync latencies, one 8 MiB upload costs one."""

    fn = _region_packed_batch_jits.get(max_regions)
    if fn is None:
        import functools

        import jax

        fn = jax.jit(
            jax.vmap(functools.partial(region_packed_j, max_regions=max_regions))
        )
        _region_packed_batch_jits[max_regions] = fn
    return fn


def _finalize_region_table(
    bundle: np.ndarray,
    labels_dev,
    capacity: int = MAX_REGIONS,
) -> Dict[str, np.ndarray]:
    """``labels_dev``: the device label frame, or a zero-arg callable
    producing it (kept lazy so the common no-fallback path never enqueues
    the per-frame slice dispatch)."""

    row = {k: bundle[i] for i, k in enumerate(_PACK_KEYS)}
    n = int(row["count"][0])
    if int(row["max_label"][0]) > capacity:
        # labels beyond the static capacity clipped into one garbage
        # segment; the caller must re-run at a larger tier (or fall back
        # to the unbounded host path).  EXACT: a frame with precisely
        # ``capacity`` regions stays on this tier.  max_label lets the
        # caller jump STRAIGHT to the right tier instead of climbing.
        return {"saturated": True, "max_label": int(row["max_label"][0])}
    meas = RP.RegionMeasurements(
        count=n,
        area=row["area"][: n + 1].astype(np.float64),
        centroid_r=row["centroid_r"][: n + 1].astype(np.float64),
        centroid_c=row["centroid_c"][: n + 1].astype(np.float64),
        bbox=np.stack(
            [
                row["min_r"][: n + 1].astype(np.int64),
                row["min_c"][: n + 1].astype(np.int64),
                (row["max_r"][: n + 1] + 1).astype(np.int64),
                (row["max_c"][: n + 1] + 1).astype(np.int64),
            ],
            axis=1,
        ),
        mu20=row["mu20"][: n + 1].astype(np.float64),
        mu02=row["mu02"][: n + 1].astype(np.float64),
        mu11=row["mu11"][: n + 1].astype(np.float64),
        perimeter=row["perimeter"][: n + 1].astype(np.float64),
    )
    # device hull pixel areas: same division as solidity_np, in f64
    hull = (
        row["hull_hi"][: n + 1].astype(np.float64) * 4096.0
        + row["hull_lo"][: n + 1].astype(np.float64)
    )
    solidity = np.zeros(n + 1, dtype=np.float64)
    solidity[1:] = meas.area[1:] / np.maximum(hull[1:], 1.0)
    chain_overflow = np.nonzero(row["hull_sat"][1 : n + 1] > 0)[0] + 1
    if chain_overflow.size:
        # a hull chain exceeded HULL_CHAIN_CAP vertices (enormous smooth
        # regions): only now pull the label frame and redo just those
        # regions through the host hull
        import jax.numpy as jnp

        if callable(labels_dev):
            labels_dev = labels_dev()
        labels = np.asarray(labels_dev.astype(jnp.uint16)).astype(np.int32)
        host_sol = RP.solidity_np(labels, meas)
        for region in chain_overflow:
            solidity[region] = host_sol[region]
    return {"meas": meas, "solidity": solidity}


def region_table_device(img) -> Dict[str, np.ndarray]:
    """Host-facing per-region table from the device kernels: ONE device
    dispatch and ONE gathered transfer (features + hull vertices); the
    label frame never leaves the device unless a hull saturates."""

    return region_tables_device([img])[0]


class _GrayOperandCache:
    """Device-resident gray-frame cache keyed by source content token —
    the extraction twin of the streaming engine's source-stack cache
    (``parallel/tiling.py``).  The reference registers every source once
    by SHA-256 of its pixel bytes and keys all downstream work off that id
    (``processing/pipeline_cache.py:256-282``); here the same token keeps
    the uploaded grayscale operand in HBM so the interactive
    re-extract-after-tweak flow pays the host link once per source, not
    once per call.  Content-keyed, so in-place mutation of a caller's
    array simply mints a new token (never a stale hit)."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget = budget_bytes
        self._entries: Dict[object, tuple] = {}  # token -> (dev, nbytes)
        self._order: List[object] = []
        self.hits = 0
        self.misses = 0

    def get(self, token):
        entry = self._entries.get(token)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._order.remove(token)
        self._order.append(token)
        return entry[0]

    def put(self, token, dev, nbytes: int) -> None:
        if nbytes > self.budget:
            return
        while self._order and (
            sum(e[1] for e in self._entries.values()) + nbytes > self.budget
        ):
            old = self._order.pop(0)
            del self._entries[old]
        self._entries[token] = (dev, nbytes)
        self._order.append(token)

    def clear(self) -> None:
        self._entries.clear()
        self._order.clear()


def _operand_cache_budget() -> int:
    import os

    try:
        return int(
            os.environ.get("YAM_EXTRACT_OPERAND_CACHE_BYTES", 256 * 1024 * 1024)
        )
    except ValueError:
        return 256 * 1024 * 1024


_GRAY_CACHE = _GrayOperandCache(_operand_cache_budget())


class _TableCache:
    """Finalized region-table memo keyed by source content token — the
    extraction twin of the reference's result cache short-circuit
    (``ui/preprocessing.py:2365-2379``: an unchanged registered source
    re-shows the memoized result without recompute; the cache itself is
    content-addressed per ``processing/pipeline_cache.py:256-313``).

    Warm re-extraction of an unchanged source (the interactive
    tweak-downstream-then-re-extract flow) skips the device dispatch and
    its sync entirely and is bound by the content hash.  Entries are host dicts of small per-region arrays
    (~10 KB each); treat them as immutable."""

    CAP = 256

    def __init__(self) -> None:
        self._entries: Dict[object, Dict] = {}
        self._order: List[object] = []

    def get(self, token):
        entry = self._entries.get(token)
        if entry is not None:
            self._order.remove(token)
            self._order.append(token)
        return entry

    def put(self, token, table: Dict) -> None:
        if token in self._entries:
            self._order.remove(token)
        self._entries[token] = table
        self._order.append(token)
        while len(self._order) > self.CAP:
            del self._entries[self._order.pop(0)]

    def clear(self) -> None:
        self._entries.clear()
        self._order.clear()


_TABLE_CACHE = _TableCache()


def clear_gray_operand_cache() -> None:
    """Drop every device-resident extraction operand (frees HBM) and the
    host-side finalized-table memo."""

    _GRAY_CACHE.clear()
    _TABLE_CACHE.clear()


# Above this size a plain ndarray is NOT content-hashed for the operand
# cache: fingerprinting runs ~5 GB/s on one host core, so for big frames
# on a directly-attached link (>10 GB/s H2D) the hash would cost more than
# the upload it tries to skip.  Record-provided tokens (path, mtime, size)
# are free and unaffected.  Frames above the threshold simply re-upload.
_HASH_TOKEN_MAX_BYTES = 32 * 1024 * 1024

# content fingerprint: two independent multiply-sum accumulators over
# tiled random odd uint64 coefficients, combined across 1-MiB chunks as a
# polynomial in a per-accumulator odd constant (so equal-value swaps at
# the tile period cannot cancel).  128-bit non-cryptographic token —
# accidental collisions across a 256-entry cache are ~2^-128-scale, and
# the host is single-core on this harness, so the ~4x over SHA-256
# (measured 5.3 vs 1.3 GB/s) comes straight off every warm extraction
# (the 32-frame mass flow spent 103 ms of its 260 ms wall in SHA).
_FP_BLOCK = 1 << 17  # 131072 uint64 lanes = 1 MiB period
_FP_MULT1 = np.uint64(0x9E3779B97F4A7C15)
_FP_MULT2 = np.uint64(0xC2B2AE3D27D4EB4F)
_FP_VECS: tuple | None = None


def _fp_vectors() -> tuple:
    global _FP_VECS
    if _FP_VECS is None:
        rng = np.random.default_rng(0x59414D5F545055)
        _FP_VECS = (
            rng.integers(1, 1 << 62, _FP_BLOCK, dtype=np.uint64) << 1 | 1,
            rng.integers(1, 1 << 62, _FP_BLOCK, dtype=np.uint64) << 1 | 1,
        )
    return _FP_VECS


def _content_fingerprint(arr: np.ndarray) -> tuple:
    flat = arr.view(np.uint8).reshape(-1)
    pad = (-flat.size) % 8
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    x = flat.view(np.uint64)
    a, b = _fp_vectors()
    h1 = np.uint64(0)
    h2 = np.uint64(0)
    with np.errstate(over="ignore"):
        for off in range(0, x.size, _FP_BLOCK):
            chunk = x[off : off + _FP_BLOCK]
            k = chunk.size
            h1 = h1 * _FP_MULT1 + (chunk * a[:k]).sum(dtype=np.uint64)
            h2 = h2 * _FP_MULT2 + (chunk * b[:k]).sum(dtype=np.uint64)
    return int(h1), int(h2), flat.size


def _frame_token(frame) -> object | None:
    """Content token for a source frame: a record-provided cache token
    when the source carries one (file-backed records key on
    (path, mtime, size)), else a 128-bit content fingerprint of the pixel
    bytes — the content-addressed source-id scheme of the reference
    (``processing/pipeline_cache.py:256``).  Returns ``None`` (uncacheable)
    for large plain arrays where hashing would cost more than the upload
    it avoids."""

    fn = getattr(frame, "cache_token", None)
    if callable(fn):
        try:
            token = fn()
            hash(token)
            return ("record", token)
        except Exception:  # noqa: BLE001 — broken token means hash bytes
            pass
    if getattr(frame, "nbytes", 0) > _HASH_TOKEN_MAX_BYTES:
        return None
    arr = np.ascontiguousarray(frame)
    return ("fp128", _content_fingerprint(arr), arr.shape, arr.dtype.str)


def region_tables_device(frames) -> list:
    """Batched variant for mass extraction: dispatches every frame before
    fetching anything, so device compute and D2H transfers overlap and the
    per-frame sync latency amortizes across the batch.

    Geometry features only need the binary mask, so color frames upload as
    the (bit-exact) host grayscale — one third of the H2D bytes — and the
    uploaded operand is cached across calls by content token (warm
    re-extractions of a registered source skip the host link entirely).

    Tiered capacity (64 -> 512 -> 1024): every per-region reduction is
    O(H*W*capacity), so everything runs at the 64-region tier first and
    only frames whose raw label count EXCEEDS a tier climb to the next;
    past the top tier the caller falls back to the unbounded host
    labeling."""

    import jax
    import jax.numpy as jnp

    shapes = [tuple(f.shape[:2]) for f in frames]
    # frames beyond the hull kernel's exact-int32 bound (2^14 per side)
    # take the unbounded host path wholesale
    oversize = {i for i, s in enumerate(shapes) if max(s) > HULL_COORD_LIMIT}
    host_grays: Dict[int, np.ndarray] = {}

    def host_gray(i: int) -> np.ndarray:
        g = host_grays.get(i)
        if g is None:
            f = frames[i]
            g = C.bgr_to_gray_np(f) if getattr(f, "ndim", 2) == 3 else np.asarray(f)
            host_grays[i] = g
        return g

    def _token(i: int):
        # record tokens are free.  Plain arrays hash the RAW frame when it
        # fits the cap (warm hits then skip the gray conversion entirely);
        # when the raw frame is over the cap, fall back to hashing the
        # GRAY operand (what actually uploads — a third of the BGR bytes,
        # so 4096² color frames still cache their upload).
        frame = frames[i]
        fn = getattr(frame, "cache_token", None)
        if callable(fn):
            try:
                token = fn()
                hash(token)
                return ("record", token)
            except Exception:  # noqa: BLE001 — broken token means hash bytes
                pass
        if i in oversize:
            return None
        if getattr(frame, "nbytes", 1 << 62) <= _HASH_TOKEN_MAX_BYTES:
            return _frame_token(frame)
        gray = host_gray(i)
        return _frame_token(gray) if gray.nbytes <= _HASH_TOKEN_MAX_BYTES else None

    tokens = [_token(i) for i in range(len(frames))]

    dev_grays: Dict[int, object] = {}  # per-call memo (tiers reuse uploads)

    def device_gray(i: int):
        dev = dev_grays.get(i)
        if dev is not None:
            return dev
        if tokens[i] is None:  # uncacheable (oversized plain array)
            dev = jax.device_put(host_gray(i))
        else:
            dev = _GRAY_CACHE.get(tokens[i])
            if dev is None:
                g = host_gray(i)
                dev = jax.device_put(g)
                _GRAY_CACHE.put(tokens[i], dev, g.nbytes)
        dev_grays[i] = dev
        return dev


    def run_tier(idx: List[int], capacity: int):
        """(labels_i, bundle_np_i) per index — frames GROUPED by shape so
        each same-shape group ships as one stacked upload+dispatch (a lone
        odd-shaped frame must not knock every other frame off the batch
        path); singletons take the per-frame async route."""

        by_shape: Dict[tuple, List[int]] = {}
        for i in idx:
            by_shape.setdefault(shapes[i], []).append(i)
        out: Dict[int, tuple] = {}
        singles: List[int] = []
        for members in by_shape.values():
            if len(members) == 1:
                singles.append(members[0])
                continue
            if any(tokens[i] is None for i in members):
                stack_token = None  # any uncacheable member poisons the stack key
            else:
                stack_token = ("stack",) + tuple(tokens[i] for i in members)
            # every batch size runs as-is: no pow2 padding, no discarded
            # compute (every size 1..8 is regression-checked by
            # scripts/check_nonpow2_batches.py)
            stack = None if stack_token is None else _GRAY_CACHE.get(stack_token)
            if stack is None:
                host_stack = np.stack([host_gray(i) for i in members])
                stack = jax.device_put(host_stack)
                if stack_token is not None:
                    _GRAY_CACHE.put(stack_token, stack, host_stack.nbytes)
            labels_b, bundles_b = _jitted_region_packed_batch(capacity)(stack)
            fetched = np.asarray(bundles_b)
            for k, i in enumerate(members):
                # label slice stays LAZY: indexing a device batch enqueues
                # a dispatch per frame, and the labels are only touched on
                # the rare hull-overflow / saturation fallbacks
                out[i] = (
                    lambda labels_b=labels_b, k=k: labels_b[k],
                    fetched[k],
                )
        if len(singles) == 1:
            # interactive single-frame path: fetch the bundle directly —
            # a jnp.stack of one element enqueues an extra dispatch for
            # nothing
            i = singles[0]
            lab, bundle = _jitted_region_packed(capacity)(device_gray(i))
            out[i] = ((lambda lab=lab: lab), np.asarray(bundle))
        elif singles:
            fn = _jitted_region_packed(capacity)
            outs = [fn(device_gray(i)) for i in singles]  # async, no blocking
            # ONE stacked transfer for the stragglers: per-bundle
            # device_get pays a device sync N times over
            fetched = np.asarray(jnp.stack([b for (_, b) in outs]))
            for k, i in enumerate(singles):
                out[i] = (lambda lab=outs[k][0]: lab, fetched[k])
        return [out[i] for i in idx]

    tables: List[Dict] = [{"saturated": True}] * len(frames)
    # content-token memo: an unchanged source re-extracts from the host
    # cache without touching the device (reference result-cache semantics,
    # ui/preprocessing.py:2365-2379)
    eligible: List[int] = []
    for i in range(len(frames)):
        if i in oversize:
            continue
        hit = None if tokens[i] is None else _TABLE_CACHE.get(tokens[i])
        if hit is not None:
            tables[i] = hit
        else:
            eligible.append(i)
    pending = list(eligible)
    for capacity in (FAST_REGIONS, MID_REGIONS, MAX_REGIONS):
        if not pending:
            break
        # a saturated tier reports the frame's TRUE max label, so frames
        # jump straight to the tier that fits instead of climbing through
        # (and paying for) capacities that cannot hold them
        run = [i for i in pending if tables[i].get("max_label", 0) <= capacity]
        if not run:
            continue
        results = run_tier(run, capacity)
        for (labels, bundle), i in zip(results, run):
            tables[i] = _finalize_region_table(bundle, labels, capacity)
        pending = [i for i in pending if tables[i].get("saturated")]
    for i in eligible:
        # memo saturated outcomes too: the same content saturates again,
        # so the caller's host fallback shouldn't re-pay the device climb
        if tokens[i] is not None:
            _TABLE_CACHE.put(tokens[i], tables[i])
    return tables


__all__ = [
    "MAX_REGIONS",
    "binary_j",
    "region_features_j",
    "region_annotate_j",
    "region_properties_device_fn",
    "hu_features_j",
    "haralick_features_j",
    "histogram_features_j",
    "fractal_feature_j",
    "hog_device_fn",
    "use_device_extraction",
    "region_packed_j",
    "region_table_device",
    "region_tables_device",
    "clear_gray_operand_cache",
    "HULL_CHAIN_CAP",
]
