"""Device<->golden parity audit, runnable in-process on real hardware.

The CPU test-suite asserts device==golden through the jax CPU backend; this
module re-runs the same assertions against whatever accelerator backend is
actually attached, so every bench run
re-verifies hardware parity (the numbers and the parity come from the same
process).  Reference parity classes: bit-exact for integer/mask ops
(``core/segmentation.py``), <=1 LSB for float filter ops
(``core/preprocessing.py:50-151``).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np


class _OutOfTime(Exception):
    """Raised between cases when the caller's time budget is exhausted."""

CASES = [
    # (identifier, params, tolerance[, input: "gray"|"bgr"])
    ("preprocessing.grayscale", {}, 0),
    ("preprocessing.brightness_contrast", {"alpha": 1.4, "beta": 7.0}, 0),
    ("preprocessing.brightness_contrast", {"alpha": 0.8, "beta": -12.0}, 0),
    ("preprocessing.gamma", {"value": 2.2}, 0),
    ("preprocessing.gamma", {"value": 0.45}, 0),
    ("preprocessing.histogram_equalization", {}, 0),
    # color path: equalize the Y plane of YCrCb and convert back — a
    # completely different code path from the grayscale LUT
    ("preprocessing.histogram_equalization", {}, 1, "bgr"),
    ("preprocessing.normalize", {"alpha": 10.0, "beta": 240.0}, 1),
    ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 5}, 1),
    ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 9}, 1),
    ("preprocessing.noise_reduction", {"method": "Median", "ksize": 5}, 0),
    # ksize=3 runs a different shared-column sorting network
    ("preprocessing.noise_reduction", {"method": "Median", "ksize": 3}, 0),
    # bilateral: gather-heavy range weights — exactly the class that can
    # diverge on an accelerator; 1-LSB like the CPU suite (test_preprocess_ops.py)
    ("preprocessing.noise_reduction", {"method": "Bilateral", "ksize": 5}, 1),
    ("preprocessing.sharpen", {"strength": 1.0}, 1),
    ("preprocessing.select_channel", {"value": "RG"}, 0),
    (
        "preprocessing.crop",
        {"x_offset": 12, "y_offset": 9, "width": 90, "height": 70},
        0,
    ),
    (
        "preprocessing.crop",  # preview overlay mode (translucent fill)
        {
            "x_offset": 12,
            "y_offset": 9,
            "width": 90,
            "height": 70,
            "apply_crop": False,
        },
        0,
    ),
    # clahe blend: f32 device interpolation vs f64 golden rounds +-1 at
    # exact .5 boundaries (tile hists and LUTs are bit-exact)
    ("preprocessing.clahe", {"clip_limit": 2.0, "grid_size": 8}, 1),
    ("segmentation.global_threshold", {"threshold": 127}, 0),
    ("segmentation.otsu", {}, 0),
    ("segmentation.adaptive", {"block_size": 11, "C": 2}, 0),
    (
        "segmentation.edge",
        {"low_threshold": 50, "high_threshold": 150, "aperture_size": 3},
        0,
    ),
    ("segmentation.sobel", {"ksize": 5}, 0),
    ("segmentation.sobel", {"ksize": 3}, 0),
    ("segmentation.prewitt", {}, 0),
    ("segmentation.laplacian", {"ksize": 3}, 0),
    ("segmentation.laplacian", {"ksize": 5}, 0),
    (
        "segmentation.opening",
        {"kernel_shape": "Elliptical", "kernel_size": 5, "iterations": 2},
        0,
    ),
    (
        "segmentation.erosion",
        {"kernel_shape": "Cross", "kernel_size": 3, "iterations": 1},
        0,
    ),
    ("segmentation.border_removal", {"border_distance": 10}, 0),
    ("segmentation.region_growing", {"seed": (40, 40), "tolerance": 12}, 0),
    (
        "segmentation.watershed",
        {
            "kernel_size": 3,
            "opening_iterations": 2,
            "dilation_iterations": 3,
            "distance_threshold_factor": 0.7,
        },
        0,
    ),
    (
        "segmentation.closing",
        {"kernel_shape": "Rectangular", "kernel_size": 5, "iterations": 2},
        0,
    ),
    (
        "segmentation.dilation",
        {"kernel_shape": "Elliptical", "kernel_size": 3, "iterations": 2},
        0,
    ),
    ("segmentation.region_split_merge", {"min_size": 16, "std_thresh": 10.0}, 0),
    ("extraction.gabor", {"ksize": 21, "sigma": 5.0, "theta": 0.0}, 1),
    (
        "extraction.hog",
        {"orientations": 9, "pixels_per_cell": (8, 8), "cells_per_block": (3, 3)},
        1,
    ),
]

# stochastic/iterative clustering ops: f32 device vs f64 golden may flip
# pixels at cluster boundaries — audited by agreement fraction, the same
# criterion the CPU suite uses (tests/test_segmentation_advanced.py)
AGREEMENT_CASES = [
    # LBP: bilinear samples can EXACTLY equal the center (irrational-weight
    # integer ties); the f64 golden's sign there is rounding noise, so
    # raster agreement is the honest criterion (device interpolates the
    # center-difference, keeping f32 flips to true-tie pixels only)
    ("extraction.lbp", {"P": 8, "R": 1.0}, 0.99, "bgr"),
    ("segmentation.kmeans", {"K": 2, "seed": 42}, 0.995, "bgr"),
    ("segmentation.fuzzy_cmeans", {"K": 2, "seed": 42}, 0.995, "bgr"),
    ("segmentation.gmm", {"components": 2, "seed": 42}, 0.99, "bgr"),
    (
        "segmentation.mean_shift",
        {"spatial_radius": 4, "color_radius": 30},
        0.99,
        "bgr32",
    ),
]

# region-mask ops audited by IoU (device and golden run the same update
# rule from independent float stacks)
IOU_CASES = [
    ("segmentation.graph_cuts", {}, 0.9),
]

# awkward geometries for the heavyweight families: padding / alignment bugs
# live at shapes that are NOT powers of two, which the shared 128x160 scene
# never exercises on hardware.  (identifier,
# params, tol, shape); tolerances follow the same classes as CASES.
ODD_SHAPE_CASES = [
    (
        "segmentation.watershed",
        {
            "kernel_size": 3,
            "opening_iterations": 2,
            "dilation_iterations": 3,
            "distance_threshold_factor": 0.7,
        },
        0,
        (97, 131),
    ),
    ("preprocessing.noise_reduction", {"method": "Median", "ksize": 5}, 0, (97, 131)),
    ("preprocessing.noise_reduction", {"method": "Gaussian", "ksize": 5}, 1, (33, 259)),
    (
        "segmentation.opening",
        {"kernel_shape": "Elliptical", "kernel_size": 5, "iterations": 2},
        0,
        (16, 515),
    ),
    # clahe pads odd frames to the grid; blend ties at exact .5 round
    # differently between f32 device / f64 golden (documented 1-LSB class)
    ("preprocessing.clahe", {"clip_limit": 2.0, "grid_size": 8}, 1, (97, 131)),
    ("segmentation.adaptive", {"block_size": 11, "C": 2}, 0, (97, 131)),
]


def synthetic_scene(
    shape: Tuple[int, int] = (128, 160), seed: int = 7
) -> Tuple[np.ndarray, np.ndarray]:
    """(gray, bgr) noisy multi-blob test frame used by every parity case."""

    rng = np.random.default_rng(seed)
    gray = np.zeros(shape, np.uint8)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    blobs = ((30, 40, 18, 210), (80, 100, 22, 180), (90, 30, 14, 230))
    for cy, cx, r, v in blobs:
        gray[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = v
    gray = (
        (gray.astype(np.int16) + rng.integers(-10, 11, gray.shape))
        .clip(0, 255)
        .astype(np.uint8)
    )
    bgr = np.repeat(gray[..., None], 3, axis=-1)
    bgr[..., 1] = np.roll(gray, 3, axis=1)
    return gray, bgr


def planned_total() -> int:
    """Number of checks a full audit performs (truncation detector)."""

    #  CASES + 3 odd-shape hist-eq + 1 wide CLAHE + 1 batched CLAHE
    #  + odd-geometry cases (+1 odd chamfer) + agreement + IoU + snake
    #  + distance transform + connected components
    #  + 10 device-extraction feature checks + annotated raster
    #  + the device-family completeness sweep
    return (
        len(CASES)
        + 3
        + 2
        + len(ODD_SHAPE_CASES)
        + 1
        + len(AGREEMENT_CASES)
        + len(IOU_CASES)
        + 3
        + 10
        + 2
    )


def run_parity_cases(
    report: Optional[Callable[[str], None]] = None,
    *,
    time_budget_s: Optional[float] = None,
) -> Tuple[int, int]:
    """Run every case on the current backend; returns (passed, total).

    ``time_budget_s`` bounds the audit: when the budget runs out BETWEEN
    cases the audit stops early and returns the partial tally (``total`` <
    :func:`planned_total`), so a slow compile service yields a truncated
    scoreboard instead of none at all.
    """

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.registry import get_impl

    emit = report or (lambda line: None)
    deadline = None if time_budget_s is None else time.monotonic() + time_budget_s

    def _tick() -> None:
        if deadline is not None and time.monotonic() > deadline:
            raise _OutOfTime

    gray, bgr = synthetic_scene()
    rng = np.random.default_rng(11)

    failures: List[str] = []
    progress = [0, 0]  # [passed, total] kept current for the timeout path
    try:
        return _run_all(emit, _tick, gray, bgr, rng, jnp, get_impl, failures, progress)
    except _OutOfTime:
        emit(
            f"TIMEOUT: audit truncated by time budget after "
            f"{progress[1]}/{planned_total()} cases"
        )
        return progress[0], progress[1]


def _run_all(emit, _tick, gray, bgr, rng, jnp, get_impl, failures, progress):
    passed = 0
    total = 0

    for case in CASES:
        identifier, params, tol = case[:3]
        _tick()
        impl = get_impl(identifier)
        image = gray
        if (
            len(case) > 3
            and case[3] == "bgr"
            or "channel" in identifier
            or "grayscale" in identifier
            or identifier in ("segmentation.otsu", "segmentation.watershed")
        ):
            image = bgr
        golden = impl.golden_fn(image, **params)
        static, dyn = impl.split_params(params, image.shape)
        dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
        device = np.asarray(impl.device_fn(jnp.asarray(image), dyn_j, **static))
        diff = int(np.abs(device.astype(np.int64) - golden.astype(np.int64)).max())
        total += 1
        ok = diff <= tol
        passed += ok
        progress[:] = [passed, total]
        if not ok:
            failures.append(identifier)
        emit(f"{'OK ' if ok else 'FAIL'} {identifier:44s} maxdiff={diff} (tol {tol})")

    # odd shapes exercise ragged histogram sizes and the correctly-rounded
    # f32 255/remainder divide in the equalization LUT
    histeq = get_impl("preprocessing.histogram_equalization")
    for shape in ((7, 13), (1000, 1003), (129, 255)):
        _tick()
        image = rng.integers(0, 256, shape, dtype=np.uint8)
        golden = histeq.golden_fn(image)
        device = np.asarray(histeq.device_fn(jnp.asarray(image), {}))
        diff = int(np.abs(device.astype(np.int64) - golden.astype(np.int64)).max())
        total += 1
        passed += diff == 0
        progress[:] = [passed, total]
        emit(f"{'OK ' if diff == 0 else 'FAIL'} histeq odd shape {shape}: maxdiff={diff}")

    # a wide frame with 256-wide tiles: the shared 128x160 scene has tiny
    # tiles, so audit the production tile geometry explicitly
    _tick()
    clahe = get_impl("preprocessing.clahe")
    wide = rng.integers(0, 256, (256, 2048), dtype=np.uint8)
    golden = clahe.golden_fn(wide, clip_limit=2.0, grid_size=8)
    static, dyn = clahe.split_params(
        {"clip_limit": 2.0, "grid_size": 8}, wide.shape
    )
    device = np.asarray(
        clahe.device_fn(
            jnp.asarray(wide), {k: jnp.asarray(v) for k, v in dyn.items()}, **static
        )
    )
    diff = int(np.abs(device.astype(np.int64) - golden.astype(np.int64)).max())
    total += 1
    passed += diff == 0
    progress[:] = [passed, total]
    emit(f"{'OK ' if diff == 0 else 'FAIL'} clahe wide tiles 256x2048: maxdiff={diff}")

    # vmapped CLAHE (the batched chain's path) against the per-frame
    # golden on hardware
    _tick()
    import jax as _jax

    from yamimageprocessor_tpu.ops import clahe as _CL

    frames = rng.integers(0, 256, (3, 256, 2048), dtype=np.uint8)
    batched = np.asarray(
        _jax.vmap(lambda f: _CL.clahe_j(f, clip_limit=2.0, grid=(8, 8)))(
            jnp.asarray(frames)
        )
    )
    bdiff = 0
    for k in range(frames.shape[0]):
        g = _CL.clahe_np(frames[k], clip_limit=2.0, grid=(8, 8))
        bdiff = max(
            bdiff, int(np.abs(batched[k].astype(np.int64) - g).max())
        )
    total += 1
    passed += bdiff == 0
    progress[:] = [passed, total]
    emit(f"{'OK ' if bdiff == 0 else 'FAIL'} clahe batched blend x3: maxdiff={bdiff}")

    def check(name: str, ok: bool, detail: str = "") -> None:
        nonlocal passed, total
        total += 1
        passed += bool(ok)
        progress[:] = [passed, total]
        if not ok:
            failures.append(name)
        emit(f"{'OK ' if ok else 'FAIL'} {name:44s} {detail}")

    # ---- awkward geometries for the heavyweight families
    for identifier, params, tol, shape in ODD_SHAPE_CASES:
        _tick()
        impl = get_impl(identifier)
        sgray, sbgr = synthetic_scene(shape)
        image = (
            sbgr
            if identifier in ("segmentation.otsu", "segmentation.watershed")
            else sgray
        )
        golden = impl.golden_fn(image, **params)
        static, dyn = impl.split_params(params, image.shape)
        dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
        device = np.asarray(impl.device_fn(jnp.asarray(image), dyn_j, **static))
        diff = int(np.abs(device.astype(np.int64) - golden.astype(np.int64)).max())
        check(
            f"{identifier}@{shape[0]}x{shape[1]}",
            diff <= tol,
            f"maxdiff={diff} (tol {tol})",
        )

    # odd-geometry chamfer distance (row-scan recurrence)
    _tick()
    from yamimageprocessor_tpu.ops.distance import (
        distance_transform_j as _dist_j,
        distance_transform_np as _dist_np,
    )

    ogray, _ = synthetic_scene((97, 131))
    omask = (ogray > 120).astype(np.uint8)
    check(
        "distance_transform@97x131",
        bool((_dist_np(omask) == np.asarray(_dist_j(jnp.asarray(omask)))).all()),
        "bit-exact",
    )

    # ---- agreement-fraction cases (clustering family)
    for identifier, params, min_agree, which in AGREEMENT_CASES:
        _tick()
        impl = get_impl(identifier)
        image = bgr[:32, :32] if which == "bgr32" else bgr
        golden = impl.golden_fn(image, **params)
        static, dyn = impl.split_params(params, image.shape)
        dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
        device = np.asarray(impl.device_fn(jnp.asarray(image), dyn_j, **static))
        agree = float((device == golden).mean())
        check(identifier, agree >= min_agree, f"agree={agree:.4f} (min {min_agree})")

    # ---- IoU cases
    for identifier, params, min_iou in IOU_CASES:
        _tick()
        impl = get_impl(identifier)
        golden = impl.golden_fn(bgr, **params)
        static, dyn = impl.split_params(params, bgr.shape)
        dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
        device = np.asarray(impl.device_fn(jnp.asarray(bgr), dyn_j, **static))
        inter = float(((device > 0) & (golden > 0)).sum())
        union = float(((device > 0) | (golden > 0)).sum())
        iou = inter / max(union, 1.0)
        check(identifier, iou >= min_iou, f"iou={iou:.3f} (min {min_iou})")

    # ---- snake: device overlay within 2 px of the golden contour
    _tick()
    snake = get_impl("segmentation.active_contour")
    sp = dict(iterations=50, alpha=0.015, beta=10.0, gamma=0.001)
    golden = snake.golden_fn(bgr, **sp)
    static, dyn = snake.split_params(sp, bgr.shape)
    device = np.asarray(
        snake.device_fn(
            jnp.asarray(bgr), {k: jnp.asarray(v) for k, v in dyn.items()}, **static
        )
    )

    def _green(img):
        return (img[..., 1] == 255) & (img[..., 0] == 0) & (img[..., 2] == 0)

    def _within(a, b, r):
        pad = np.pad(b, r)
        hits = np.zeros_like(a)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                hits |= pad[r + dy : r + dy + a.shape[0], r + dx : r + dx + a.shape[1]]
        return bool((~a | hits).all())

    ga, gb = _green(device), _green(golden)
    check(
        "segmentation.active_contour",
        ga.any() and gb.any() and _within(ga, gb, 2) and _within(gb, ga, 2),
        "overlay within 2px both directions",
    )

    # ---- distance transform (inside the watershed chain; audited alone)
    _tick()
    from yamimageprocessor_tpu.ops.distance import (
        distance_transform_j,
        distance_transform_np,
    )

    mask = (gray > 120).astype(np.uint8)
    dg = distance_transform_np(mask)
    dd = np.asarray(distance_transform_j(jnp.asarray(mask)))
    check("distance_transform", bool((dg == dd).all()), "bit-exact")

    # ---- connected components: a 50%-fill noise mask maximizes component count and boundary merges
    _tick()
    from yamimageprocessor_tpu.ops.labeling import label_j as _label_j
    from yamimageprocessor_tpu.ops.labeling import label_np as _label_np

    noise_fg = rng.random((257, 384)) > 0.5
    lg = _label_np(noise_fg)
    ld = np.asarray(_label_j(jnp.asarray(noise_fg)))
    check(
        "connected_components",
        bool((lg == ld).all()),
        f"bit-exact, {int(lg.max())} comps",
    )

    # ---- device extraction feature kernels (feature-vector parity, the
    # families whose golden output is a text-annotated raster)
    import jax

    from yamimageprocessor_tpu.ops import extraction as EX
    from yamimageprocessor_tpu.ops import extraction_device as XDev
    from yamimageprocessor_tpu.ops import hogf as HG
    from yamimageprocessor_tpu.ops import regionprops as RP
    from yamimageprocessor_tpu.ops import shape as SHp
    from yamimageprocessor_tpu.ops import texture as TXt
    from yamimageprocessor_tpu.ops.labeling import label_np

    labels_np = label_np(EX._binary(bgr) > 0)
    meas = RP.measure_np(labels_np)

    _tick()
    labels_j, feats = XDev.region_features_j(bgr, max_regions=64)
    n = int(np.asarray(feats["count"]))
    check(
        "xfeat.labels+count",
        bool((np.asarray(labels_j) == labels_np).all()) and n == meas.count,
        f"regions={n}",
    )
    # count guard FIRST: a miscount is exactly the regression this audit
    # exists to catch, and unsliced golden arrays would otherwise raise a
    # non-broadcastable ValueError that kills the whole audit
    ok = n == meas.count and (
        np.allclose(np.asarray(feats["area"])[: n + 1], meas.area[: n + 1])
        and np.allclose(
            np.asarray(feats["perimeter"])[: n + 1], meas.perimeter, rtol=1e-4
        )
        and np.allclose(
            np.asarray(feats["centroid_r"])[: n + 1], meas.centroid_r, rtol=1e-4
        )
        and np.allclose(
            np.asarray(feats["eccentricity"])[: n + 1],
            meas.eccentricity(),
            rtol=1e-3,
            # near-symmetric regions: ecc = sqrt(eps/l1) amplifies f32
            # moment noise through the square root — 1e-3 absolute class
            atol=1e-3,
        )
    )
    check("xfeat.region_properties", ok, "area/perimeter/centroid/ecc")

    _tick()
    table = XDev.region_table_device(bgr)
    sol_ok = not table.get("saturated") and np.array_equal(
        table["solidity"], RP.solidity_np(labels_np, meas)
    )
    check("xfeat.solidity_hull", bool(sol_ok), "device hull bit-exact")

    _tick()
    hu_d = np.asarray(jax.jit(XDev.hu_features_j)(bgr))
    hu_g = SHp.hu_moments(SHp.moments_np(EX._binary(bgr)))
    check(
        "xfeat.hu_moments",
        bool(np.allclose(hu_d, hu_g, rtol=1e-3, atol=1e-10)),
        "7 invariants",
    )

    _tick()
    har_d = np.asarray(jax.jit(XDev.haralick_features_j)(bgr))
    pg = EX._haralick_props(bgr, 1, 0.0)
    har_g = np.array([pg["contrast"], pg["correlation"], pg["energy"], pg["homogeneity"]])
    check(
        "xfeat.haralick",
        bool(np.allclose(har_d, har_g, rtol=1e-3, atol=1e-5)),
        "GLCM props",
    )

    from yamimageprocessor_tpu.ops import color as Col

    _tick()
    hist_d = np.asarray(jax.jit(XDev.histogram_features_j)(bgr))
    hs = TXt.histogram_stats_np(Col.bgr_to_gray_np(bgr))
    hist_g = np.array([hs["mean"], hs["variance"], hs["skewness"], hs["kurtosis"]])
    check(
        "xfeat.histogram_stats",
        bool(np.allclose(hist_d, hist_g, rtol=1e-3, atol=1e-4)),
        "mean/var/skew/kurt",
    )

    _tick()
    fr_d = float(np.asarray(jax.jit(XDev.fractal_feature_j)(bgr)))
    fr_g = float(HG.fractal_dimension(EX._binary(bgr, maxval=1), 2))
    check("xfeat.fractal", abs(fr_d - fr_g) < 1e-3, f"{fr_d:.4f} vs {fr_g:.4f}")

    _tick()
    hfe_d, _ = HG.hog_features_j(
        jnp.asarray(gray),
        orientations=9,
        pixels_per_cell=(8, 8),
        cells_per_block=(3, 3),
    )
    hfe_g, _ = HG.hog_features_np(gray, 9, (8, 8), (3, 3))
    check(
        "xfeat.hog_features",
        bool(np.allclose(np.asarray(hfe_d), hfe_g, rtol=1e-3, atol=1e-4)),
        "descriptor vector",
    )

    _tick()
    contour = max(SHp.trace_external_contours(EX._binary(bgr)), key=SHp.contour_area)
    sel_d, recon_d = XDev.fourier_descriptors_device(contour, 10)
    coeffs, recon_g = SHp.fourier_reconstruct(contour, 10)
    kk = min(10, len(coeffs))
    sel_g = np.concatenate([coeffs[:kk], coeffs[-kk:]])
    scale = max(1.0, float(np.abs(sel_g).max()))
    check(
        "xfeat.fourier",
        bool(
            np.allclose(sel_d / scale, sel_g / scale, atol=2e-4)
            and np.allclose(recon_d, recon_g, atol=0.05)
        ),
        "+-k coefficients + reconstruction",
    )

    _tick()
    arc = SHp.arc_length(contour, closed=True)
    polys = [
        SHp.approx_poly_dp(contour, f * arc).reshape(-1, 2)
        for f in (0.005, 0.02, 0.08)
    ]
    err_d = XDev.polygon_mean_errors_device(
        contour.reshape(-1, 2).astype(np.float64), polys
    )
    err_g = [
        float(
            np.mean(
                [
                    SHp.point_polygon_distance(p, (float(q[0]), float(q[1])))
                    for q in contour
                ]
            )
        )
        for p in polys
    ]
    check(
        "xfeat.approx_polygon_errors",
        bool(np.allclose(err_d, err_g, rtol=1e-3, atol=1e-3)),
        "epsilon-search mean errors",
    )

    # ---- region_properties ANNOTATED RASTER (the op's image output:
    # bbox borders + centroid disks, value-independent geometry)
    _tick()
    rp = get_impl("extraction.region_properties")
    golden_r = rp.golden_fn(bgr)
    device_r = np.asarray(rp.device_fn(jnp.asarray(bgr), {}))
    check(
        "xfeat.region_properties_raster",
        bool(np.array_equal(golden_r, device_r)),
        "annotated raster bit-exact",
    )

    # ---- completeness sweep: every registered op family with a device
    # path must be audited above — a newly registered device op that
    # nobody added to CASES fails here instead of silently shipping
    # unaudited (VERDICT r3 missing #3)
    _tick()
    from yamimageprocessor_tpu.ops.registry import all_impls

    audited = (
        {c[0] for c in CASES}
        | {c[0] for c in AGREEMENT_CASES}
        | {c[0] for c in IOU_CASES}
        | {c[0] for c in ODD_SHAPE_CASES}
        | {
            "segmentation.active_contour",
            "extraction.region_properties",
        }
    )
    unaudited = [
        ident
        for ident in sorted(all_impls())
        if get_impl(ident).device_fn is not None and ident not in audited
    ]
    check(
        "audit.device_family_coverage",
        not unaudited,
        f"unaudited: {unaudited}" if unaudited else "all device families audited",
    )

    return passed, total


__all__ = ["CASES", "run_parity_cases", "synthetic_scene"]
