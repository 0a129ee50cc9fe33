"""Device extraction kernels vs the numpy golden paths.

The jittable feature kernels run here on the jax CPU backend; on the GPU
they are the same program via XLA.  Integer-derived features (areas,
bboxes, labels, annotations) must be exact; float reductions carry f32
vs f64 tolerance.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from yamimageprocessor_tpu.ops import extraction as EX
from yamimageprocessor_tpu.ops import extraction_device as XD
from yamimageprocessor_tpu.ops import hogf as H
from yamimageprocessor_tpu.ops import regionprops as RP
from yamimageprocessor_tpu.ops import texture as TX
from yamimageprocessor_tpu.ops.labeling import label_np
from yamimageprocessor_tpu.ops.registry import get_impl
from yamimageprocessor_tpu.services.parity import synthetic_scene


@pytest.fixture(scope="module")
def scene():
    gray, bgr = synthetic_scene((96, 128), seed=5)
    return gray, bgr


def test_region_features_match_golden(scene):
    _, bgr = scene
    labels_j, feats = XD.region_features_j(bgr, max_regions=64)
    labels = label_np(EX._binary(bgr) > 0)
    assert (np.asarray(labels_j) == labels).all()
    meas = RP.measure_np(labels)
    n = int(np.asarray(feats["count"]))
    assert n == meas.count
    np.testing.assert_array_equal(
        np.asarray(feats["area"])[: n + 1], meas.area[: n + 1]
    )
    np.testing.assert_allclose(
        np.asarray(feats["centroid_r"])[: n + 1], meas.centroid_r, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(feats["perimeter"])[: n + 1], meas.perimeter, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(feats["eccentricity"])[: n + 1],
        meas.eccentricity(),
        rtol=1e-4,
        # ecc near 0 (symmetric regions) is sqrt-amplified f32 noise
        atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(feats["extent"])[: n + 1], meas.extent(), rtol=1e-5
    )
    bbox = np.stack(
        [
            np.asarray(feats["min_r"])[: n + 1],
            np.asarray(feats["min_c"])[: n + 1],
            np.asarray(feats["max_r"])[: n + 1] + 1,
            np.asarray(feats["max_c"])[: n + 1] + 1,
        ],
        axis=1,
    ).astype(np.int64)
    np.testing.assert_array_equal(bbox[1:], meas.bbox[1 : n + 1])


def test_region_annotation_matches_golden(scene):
    _, bgr = scene
    golden = EX.region_properties_extraction(bgr)
    impl = get_impl("extraction.region_properties")
    assert impl.device_fn is not None and impl.jittable
    device = np.asarray(impl.device_fn(bgr, {}))
    assert (device == golden).all()


def test_region_table_device_matches_host(scene):
    _, bgr = scene
    table = XD.region_table_device(bgr)
    labels = label_np(EX._binary(bgr) > 0)
    meas = RP.measure_np(labels)
    assert table["meas"].count == meas.count
    np.testing.assert_allclose(
        table["solidity"], RP.solidity_np(labels, meas), rtol=1e-5
    )


def test_hu_features_device(scene):
    _, bgr = scene
    golden = EX._hu(bgr)  # host path on the CPU harness
    device = np.asarray(XD.hu_features_j(bgr))
    np.testing.assert_allclose(device, golden, rtol=2e-3, atol=1e-12)


def test_haralick_features_device(scene):
    _, bgr = scene
    golden = EX._haralick_props(bgr, 1, 0.0)  # host path on the CPU harness
    device = np.asarray(XD.haralick_features_j(bgr, distance=1, angle=0.0))
    for i, key in enumerate(("contrast", "correlation", "energy", "homogeneity")):
        np.testing.assert_allclose(device[i], golden[key], rtol=1e-3)


def test_histogram_features_device(scene):
    _, bgr = scene
    from yamimageprocessor_tpu.ops import color as C

    golden = TX.histogram_stats_np(C.bgr_to_gray_np(bgr))
    device = np.asarray(XD.histogram_features_j(bgr))
    for i, key in enumerate(("mean", "variance", "skewness", "kurtosis")):
        np.testing.assert_allclose(device[i], golden[key], rtol=1e-4)


def test_fractal_feature_device(scene):
    _, bgr = scene
    binary = EX._binary(bgr, maxval=1)
    golden = H.fractal_dimension(binary, 2)
    device = float(np.asarray(XD.fractal_feature_j(bgr, min_box_size=2)))
    np.testing.assert_allclose(device, golden, rtol=1e-4)


def test_hog_device_fn_matches_golden(scene):
    gray, bgr = scene
    golden = EX.hog_extraction(bgr)
    impl = get_impl("extraction.hog")
    assert impl.device_fn is not None and impl.jittable
    static, dyn = impl.split_params({}, bgr.shape)
    device = np.asarray(impl.device_fn(bgr, dyn, **static))
    # f32 cell histograms vs f64: allow 1 LSB on the normalized render
    assert np.abs(device.astype(np.int16) - golden.astype(np.int16)).max() <= 1


def test_device_extraction_families_registered():
    """>=6 of the 8 previously host-only families now carry device compute
    (device_fn or feature_fn)."""

    families = {
        "extraction.region_properties": ("device_fn",),
        "extraction.hu_moments": ("feature_fn",),
        "extraction.haralick": ("feature_fn",),
        "extraction.hog": ("device_fn",),
        "extraction.histogram": ("feature_fn",),
        "extraction.fractal": ("feature_fn",),
    }
    for identifier, attrs in families.items():
        impl = get_impl(identifier)
        assert any(getattr(impl, a) is not None for a in attrs), identifier


def _solidity_golden(bgr):
    labels = label_np(EX._binary(bgr) > 0)
    meas = RP.measure_np(labels)
    return RP.solidity_np(labels, meas), labels, meas


def test_hull_pixel_areas_bit_exact_vs_host_scanline():
    """Device gift-wrap hull areas must equal the host scan-line fill
    (including degenerate hulls, where both reduce to the member count)."""

    rng = np.random.default_rng(11)
    img = np.zeros((80, 90), np.uint8)
    # degenerate shapes: single pixel, horizontal line, vertical line,
    # diagonal (collinear), plus random blobs
    img[3, 4] = 200
    img[10, 20:40] = 210
    img[20:33, 50] = 220
    for k in range(12):
        img[40 + k, 8 + k] = 230
    for _ in range(14):
        r, c = rng.integers(5, 70, 2)
        img[r : r + rng.integers(2, 9), c : c + rng.integers(2, 9)] = 240
    bgr = np.repeat(img[..., None], 3, axis=-1)

    labels = label_np(EX._binary(bgr) > 0)
    meas = RP.measure_np(labels)
    mn, mx, has = RP.row_extremes_j(jnp.asarray(labels), 64)
    areas, saturated = RP.hull_pixel_areas_j(mn, mx, has)
    areas = np.asarray(areas)
    assert not np.asarray(saturated)[1 : meas.count + 1].any()
    for region in range(1, meas.count + 1):
        minr, minc, maxr, maxc = meas.bbox[region]
        crop = labels[minr:maxr, minc:maxc] == region
        rows, cols = np.nonzero(crop)
        order = np.lexsort((cols, rows))
        rs, cs = rows[order], cols[order]
        urows, starts = np.unique(rs, return_index=True)
        ends = np.append(starts[1:], len(cs)) - 1
        cand = np.concatenate(
            [
                np.stack([urows + minr, cs[starts] + minc], axis=1),
                np.stack([urows + minr, cs[ends] + minc], axis=1),
            ]
        )
        hull = RP.convex_hull_points(cand)
        if len(hull) <= 2:
            golden = float(meas.area[region])
        else:
            golden = RP._hull_pixel_area(hull.astype(np.float64))
        assert areas[region] == golden, f"region {region}: hull area"


def test_solidity_device_hulls_bit_exact(scene):
    _, bgr = scene
    golden, labels, meas = _solidity_golden(bgr)
    table = XD.region_table_device(bgr)
    np.testing.assert_array_equal(table["solidity"], golden)


def test_region_tables_two_tier_saturation():
    """>64 regions must transparently re-run at the 512 tier."""

    img = np.zeros((140, 140), np.uint8)
    for i in range(10):
        for j in range(10):
            img[3 + i * 13 : 7 + i * 13, 3 + j * 13 : 7 + j * 13] = 220
    bgr = np.repeat(img[..., None], 3, axis=-1)
    (table,) = XD.region_tables_device([bgr])
    assert not table.get("saturated")
    golden, labels, meas = _solidity_golden(bgr)
    assert table["meas"].count == meas.count == 100
    np.testing.assert_array_equal(table["solidity"], golden)
    np.testing.assert_array_equal(table["meas"].area, meas.area)


def test_region_tables_batched_matches_single():
    rng = np.random.default_rng(3)
    frames = []
    for s in range(3):
        img = np.zeros((64, 72), np.uint8)
        for _ in range(6 + s):
            r, c = rng.integers(4, 50, 2)
            img[r : r + 7, c : c + 5] = 200
        frames.append(np.repeat(img[..., None], 3, axis=-1))
    tables = XD.region_tables_device(frames)
    for f, t in zip(frames, tables):
        golden, labels, meas = _solidity_golden(f)
        assert t["meas"].count == meas.count
        np.testing.assert_array_equal(t["solidity"], golden)


def test_region_tables_batched_mixed_shapes_and_saturation():
    """Stacked batching must fall back per-frame on ragged shapes, and the
    saturation retry must work when triggered from inside a stacked batch."""

    rng = np.random.default_rng(7)

    def grid_frame(side: int, n: int) -> np.ndarray:
        img = np.zeros((side, side), np.uint8)
        pitch = max(side // n, 10)
        k = 0
        for r in range(3, side - 7, pitch):
            for c in range(3, side - 7, pitch):
                if k >= n * n:
                    break
                img[r : r + 4, c : c + 4] = 180 + int(rng.integers(0, 40))
                k += 1
        return np.repeat(img[..., None], 3, axis=-1)

    # two same-shape frames, one of which exceeds the 64-region fast tier
    dense = grid_frame(140, 10)  # 100 regions -> tier retry
    sparse = grid_frame(140, 3)
    tables = XD.region_tables_device([dense, sparse])
    for f, t in zip((dense, sparse), tables):
        assert not t.get("saturated")
        golden, labels, meas = _solidity_golden(f)
        assert t["meas"].count == meas.count
        np.testing.assert_array_equal(t["solidity"], golden)
        np.testing.assert_array_equal(t["meas"].area, meas.area)

    # ragged shapes -> per-frame fallback, same results
    other = grid_frame(96, 3)
    ragged = XD.region_tables_device([sparse, other])
    for f, t in zip((sparse, other), ragged):
        golden, labels, meas = _solidity_golden(f)
        assert t["meas"].count == meas.count
        np.testing.assert_array_equal(t["solidity"], golden)


def test_fourier_device_matches_fft(scene):
    """Device DFT (masked matmuls, mod-n angle reduction) vs the f64 FFT
    golden: coefficients and reconstruction (VERDICT r2 missing #3)."""

    from yamimageprocessor_tpu.ops import shape as SH

    _, bgr = scene
    binary = EX._binary(bgr)
    contours = SH.trace_external_contours(binary)
    assert contours
    largest = max(contours, key=SH.contour_area)
    for k in (10, 4, 1):
        sel_d, recon_d = XD.fourier_descriptors_device(largest, k)
        coeffs, recon = SH.fourier_reconstruct(largest, k)
        kk = min(k, len(coeffs))
        sel = np.concatenate([coeffs[:kk], coeffs[-kk:]])
        scale = max(1.0, float(np.abs(sel).max()))
        np.testing.assert_allclose(sel_d / scale, sel / scale, atol=2e-4)
        np.testing.assert_allclose(recon_d, recon.real * 0 + np.stack(
            [recon[:, 0], recon[:, 1]], axis=1), atol=0.02)


def test_fourier_device_short_contour_overlap():
    """n < 2k: the duplicated spectral lines must not double-count in the
    reconstruction (the golden 'kept' overwrites, never adds)."""

    from yamimageprocessor_tpu.ops import shape as SH

    square = np.array([[2, 2], [8, 2], [8, 8], [2, 8], [2, 5]], np.int64)
    k = 4  # 2k = 8 > n = 5
    sel_d, recon_d = XD.fourier_descriptors_device(square, k)
    coeffs, recon = SH.fourier_reconstruct(square, k)
    kk = min(k, len(coeffs))
    sel = np.concatenate([coeffs[:kk], coeffs[-kk:]])
    np.testing.assert_allclose(sel_d, sel, atol=1e-3)
    np.testing.assert_allclose(recon_d, recon, atol=1e-3)


def test_polygon_errors_device_matches_host(scene):
    from yamimageprocessor_tpu.ops import shape as SH

    _, bgr = scene
    binary = EX._binary(bgr)
    contours = [c for c in SH.trace_external_contours(binary) if len(c) > 8]
    assert contours
    contour = max(contours, key=SH.contour_area).astype(np.float64)
    arc = SH.arc_length(contour, closed=True)
    polys = [
        SH.approx_poly_dp(contour, f * arc).reshape(-1, 2)
        for f in (0.005, 0.02, 0.08)
    ]
    avgs = XD.polygon_mean_errors_device(contour.reshape(-1, 2), polys)
    for avg, poly in zip(avgs, polys):
        host = np.mean(
            [
                SH.point_polygon_distance(poly, (float(p[0]), float(p[1])))
                for p in contour
            ]
        )
        np.testing.assert_allclose(avg, host, rtol=1e-4, atol=1e-4)


def test_all_ten_extraction_families_device_capable():
    """VERDICT r2 missing #3 done-criterion: 10/10 families carry a
    device kernel (device_fn or feature_fn)."""

    from yamimageprocessor_tpu.ops.registry import all_impls

    families = {
        ident: impl
        for ident, impl in all_impls().items()
        if ident.startswith("extraction.") and impl.data_fn is not None
    }
    assert len(families) >= 10
    missing = [
        ident
        for ident, impl in families.items()
        if impl.device_fn is None and impl.feature_fn is None
    ]
    assert not missing, f"host-only extraction families: {missing}"


class TestGrayOperandCache:
    """Content-token device operand cache (the extraction twin of the
    streaming source-stack cache): warm re-extractions must not re-upload,
    and in-place mutation must mint a fresh token (content-keyed, never a
    stale hit)."""

    def setup_method(self):
        XD.clear_gray_operand_cache()
        self._cache = XD._GRAY_CACHE
        self._cache.hits = self._cache.misses = 0

    def teardown_method(self):
        XD.clear_gray_operand_cache()

    def test_warm_single_frame_hits(self, scene):
        _, bgr = scene
        XD.region_tables_device([bgr.copy()])
        first_misses = self._cache.misses
        assert first_misses >= 1 and self._cache.hits == 0
        XD.region_tables_device([bgr.copy()])
        # warm call is served from the table memo: no new upload, and the
        # device isn't touched at all (hits stay 0 because the memo
        # short-circuits before the operand cache)
        assert self._cache.misses == first_misses  # no new upload
        XD._TABLE_CACHE.clear()
        XD.region_tables_device([bgr.copy()])
        assert self._cache.hits >= 1  # operand reused when memo misses
        assert self._cache.misses == first_misses

    def test_mutation_mints_fresh_token(self, scene):
        _, bgr = scene
        frame = bgr.copy()
        t1 = XD.region_tables_device([frame])[0]
        frame[:] = 255 - frame  # in-place mutation
        t2 = XD.region_tables_device([frame])[0]
        assert self._cache.hits == 0  # content changed -> token changed
        assert t1["meas"].count != t2["meas"].count or not np.allclose(
            t1["solidity"], t2["solidity"]
        ) or t1["meas"].area.sum() != t2["meas"].area.sum()

    def test_batch_stack_cached(self, scene):
        _, bgr = scene
        frames = [bgr.copy(), (255 - bgr).copy()]
        a = XD.region_tables_device(frames)
        misses = self._cache.misses
        b = XD.region_tables_device(frames)
        assert self._cache.misses == misses  # stacked upload reused
        for ta, tb in zip(a, b):
            assert ta["meas"].count == tb["meas"].count
            np.testing.assert_array_equal(ta["meas"].area, tb["meas"].area)

    def test_budget_evicts_lru(self):
        cache = XD._GrayOperandCache(budget_bytes=100)
        cache.put("a", object(), 60)
        cache.put("b", object(), 60)  # evicts a
        assert cache.get("a") is None
        assert cache.get("b") is not None
        cache.put("huge", object(), 1000)  # over budget: never stored
        assert cache.get("huge") is None
        assert cache.get("b") is not None

    def test_table_memo_warm_hit_and_eviction(self, scene):
        _, bgr = scene
        frame = bgr.copy()
        t1 = XD.region_tables_device([frame])[0]
        t2 = XD.region_tables_device([frame])[0]
        assert t2 is t1  # warm call returns the memoized table
        XD.clear_gray_operand_cache()  # clears the memo too
        t3 = XD.region_tables_device([frame])[0]
        assert t3 is not t1
        assert t3["meas"].count == t1["meas"].count
        np.testing.assert_array_equal(t3["solidity"], t1["solidity"])

    def test_table_memo_lru_bound(self):
        memo = XD._TableCache()
        memo.CAP = 2
        memo.put("a", {"v": 1})
        memo.put("b", {"v": 2})
        memo.put("c", {"v": 3})  # evicts a
        assert memo.get("a") is None
        assert memo.get("b")["v"] == 2
        assert memo.get("c")["v"] == 3

    def test_record_token_preferred(self):
        class Rec(np.ndarray):
            def cache_token(self):
                return ("path.png", 123.0, 456)

        arr = np.zeros((8, 8), dtype=np.uint8).view(Rec)
        token = XD._frame_token(arr)
        assert token == ("record", ("path.png", 123.0, 456))
        plain = XD._frame_token(np.zeros((8, 8), dtype=np.uint8))
        assert plain[0] == "fp128"


def test_mass_batch_non_pow2_matches_singles(scene):
    """Non-power-of-two same-shape batches run as one stacked dispatch with
    no padding; batch results equal the single-frame results."""

    _, bgr = scene
    frames = [bgr.copy(), (255 - bgr).copy(), np.roll(bgr, 7, axis=1).copy()]
    batch = XD.region_tables_device(frames)
    singles = [XD.region_table_device(f) for f in frames]
    assert len(batch) == len(frames)
    for a, b in zip(batch, singles):
        assert a["meas"].count == b["meas"].count
        np.testing.assert_array_equal(a["meas"].area, b["meas"].area)
        np.testing.assert_array_equal(a["solidity"], b["solidity"])


def test_oversized_plain_frame_token_uncacheable():
    """Plain ndarrays above the hash threshold return None (uncacheable):
    hashing them would cost more than the upload the cache avoids."""

    big = np.zeros((6000, 6000), dtype=np.uint8)  # 36 MB > 32 MiB threshold
    assert XD._frame_token(big) is None
    small = np.zeros((64, 64), dtype=np.uint8)
    assert XD._frame_token(small)[0] == "fp128"


def test_region_tables_third_tier_600_regions():
    """>512 regions must stay on the device path at the 1024 tier (the
    BASELINE-class dense 4096² grid has ~1024 cells)."""

    img = np.zeros((200, 200), np.uint8)
    for i in range(25):
        for j in range(25):
            img[2 + i * 8 : 6 + i * 8, 2 + j * 8 : 6 + j * 8] = 220
    bgr = np.repeat(img[..., None], 3, axis=-1)
    (table,) = XD.region_tables_device([bgr])
    assert not table.get("saturated")
    golden, labels, meas = _solidity_golden(bgr)
    assert table["meas"].count == meas.count == 625
    np.testing.assert_array_equal(table["solidity"], golden)
    np.testing.assert_array_equal(table["meas"].area, meas.area)


def test_tier_ladder_skips_unfitting_capacity(monkeypatch):
    """A 600-region frame must run tier-64 (to learn the count) then jump
    STRAIGHT to tier-1024 — tier-512 cannot hold it and costs O(H*W*513)."""

    XD.clear_gray_operand_cache()  # defeat the table memo: drive the ladder
    seen = []
    orig = XD._finalize_region_table

    def spy(bundle, labels, capacity=XD.MAX_REGIONS):
        seen.append(capacity)
        return orig(bundle, labels, capacity)

    monkeypatch.setattr(XD, "_finalize_region_table", spy)
    img = np.zeros((200, 200), np.uint8)
    for i in range(25):
        for j in range(25):
            img[2 + i * 8 : 6 + i * 8, 2 + j * 8 : 6 + j * 8] = 220
    (table,) = XD.region_tables_device([np.repeat(img[..., None], 3, axis=-1)])
    assert table["meas"].count == 625
    assert seen == [XD.FAST_REGIONS, XD.MAX_REGIONS], seen
