"""The 10 extraction op families: annotated-image twins + tabular data.

Reference kernels: ``core/extraction.py:57-443``.  Every family registers

* ``golden_fn(image, **params) -> annotated image`` — the pipeline-facing
  variant (reference ``*_extraction`` functions);
* ``data_fn(image, **params) -> pandas.DataFrame`` — the export variant
  (reference ``*_data`` functions) with the same column layout, consumed by
  the CSV export service;

heavy numerics (label reductions, GLCM scatter, LBP stencils, HOG cells,
moments) run through the device-capable kernels in
:mod:`.regionprops` / :mod:`.texture` / :mod:`.shape` / :mod:`.hogf`;
annotation (boxes, text) is host finalization.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List

import numpy as np

from yamimageprocessor_tpu.ops import color as C
from yamimageprocessor_tpu.ops import extraction_device as XD
from yamimageprocessor_tpu.ops import hogf as H
from yamimageprocessor_tpu.ops import regionprops as RP
from yamimageprocessor_tpu.ops import shape as SH
from yamimageprocessor_tpu.ops import texture as TX
from yamimageprocessor_tpu.ops import threshold as T
from yamimageprocessor_tpu.ops.labeling import label_np
from yamimageprocessor_tpu.ops.registry import register_op
from yamimageprocessor_tpu.utils import annotate as AN

if TYPE_CHECKING:  # the DataFrame twins import pandas when called
    import pandas as pd


def _binary(image: np.ndarray, maxval: int = 255) -> np.ndarray:
    gray = C.bgr_to_gray_np(image)
    return T.binary_np(gray, T.otsu_threshold_np(gray), maxval=maxval)


# ---------------------------------------------------------------------------
# (A) Region properties (core/extraction.py:57-87)
def region_properties_extraction(image: np.ndarray) -> np.ndarray:
    labels = label_np(_binary(image) > 0)
    meas = RP.measure_np(labels)
    annotated = image.copy()
    for region in range(1, meas.count + 1):
        minr, minc, maxr, maxc = meas.bbox[region]
        AN.rect_border(annotated, int(minc), int(minr), int(maxc), int(maxr), (0, 255, 0), 2)
        AN.draw_disk(
            annotated,
            int(meas.centroid_c[region]),
            int(meas.centroid_r[region]),
            3,
            (0, 0, 255),
        )
    return annotated


def region_properties_data(image: np.ndarray) -> pd.DataFrame:
    import pandas as pd

    table = XD.region_table_device(image) if XD.use_device_extraction() else None
    if table is not None and not table.get("saturated"):
        meas = table["meas"]
        solidity = table["solidity"]
    else:
        # host path: off-accelerator, or the device kernels' static region
        # capacity saturated (unbounded labeling required for correctness)
        labels = label_np(_binary(image) > 0)
        meas = RP.measure_np(labels)
        solidity = RP.solidity_np(labels, meas)
    extent = meas.extent()
    orientation = meas.orientation()
    eccentricity = meas.eccentricity()
    # columnar construction: row-of-dicts DataFrame assembly routes the
    # mixed tuple column through arrow string inference (~300 ms/frame of
    # host time — measured dominating the device path); building typed
    # columns directly produces the identical frame layout
    count = meas.count
    if count == 0:
        # match the reference's row-of-dicts construction: no regions
        # yields a column-less empty frame (CSV export writes no header)
        return pd.DataFrame([])
    sl = slice(1, count + 1)
    centroids = pd.Series(
        [
            (float(meas.centroid_r[r]), float(meas.centroid_c[r]))
            for r in range(1, count + 1)
        ],
        dtype=object,
    )
    return pd.DataFrame(
        {
            "region_index": np.arange(1, count + 1, dtype=np.int64),
            "area": meas.area[sl].astype(np.float64),
            "perimeter": meas.perimeter[sl].astype(np.float64),
            "centroid": centroids,
            "eccentricity": np.asarray(eccentricity[sl], dtype=np.float64),
            "solidity": np.asarray(solidity[sl], dtype=np.float64),
            "extent": np.asarray(extent[sl], dtype=np.float64),
            "orientation": np.asarray(orientation[sl], dtype=np.float64),
        }
    )


register_op(
    "extraction.region_properties",
    golden_fn=region_properties_extraction,
    data_fn=region_properties_data,
    device_fn=XD.region_properties_device_fn,
    split=lambda p: ({}, {}),
    jittable=True,
    global_stats=True,  # labeling is frame-coupled
)


# ---------------------------------------------------------------------------
# (B) Hu moments (core/extraction.py:90-105)
def _hu(image: np.ndarray) -> np.ndarray:
    if XD.use_device_extraction():
        import jax

        return np.asarray(jax.jit(XD.hu_features_j)(image))
    binary = _binary(image)
    return SH.hu_moments(SH.moments_np(binary))


def hu_moments_extraction(image: np.ndarray) -> np.ndarray:
    hu = _hu(image)
    annotated = image.copy()
    text = "Hu Moments: " + ", ".join(f"{h:.2e}" for h in hu)
    AN.draw_text(annotated, text, (10, 30), (0, 255, 0), 0.6, 2)
    return annotated


def hu_moments_data(image: np.ndarray) -> pd.DataFrame:
    import pandas as pd

    hu = _hu(image)
    return pd.DataFrame([hu], columns=[f"hu_{i + 1}" for i in range(len(hu))])


register_op(
    "extraction.hu_moments",
    golden_fn=hu_moments_extraction,
    data_fn=hu_moments_data,
    feature_fn=XD.hu_features_j,
    jittable=False,  # annotation embeds host-formatted text
    global_stats=True,
)


# ---------------------------------------------------------------------------
# (C) LBP (core/extraction.py:108-117)
def lbp_extraction(image: np.ndarray, P: int = 8, R: float = 1.0) -> np.ndarray:
    gray = C.bgr_to_gray_np(image)
    return TX.lbp_display(TX.lbp_np(gray, int(P), float(R)))


def lbp_data(image: np.ndarray, P: int = 8, R: float = 1.0) -> pd.DataFrame:
    import pandas as pd

    lbp_img = lbp_extraction(image, P, R)
    hist, bin_edges = np.histogram(lbp_img, bins=256, range=(0, 255))
    return pd.DataFrame({"bin": bin_edges[:-1], "count": hist})


def lbp_device(img, dyn, *, P: int = 8, R: float = 1.0):
    import jax.numpy as jnp

    gray = C.bgr_to_gray_j(img)
    lbp = TX.lbp_j(gray, p=int(P), r=float(R))
    lo = lbp.min()
    hi = lbp.max()
    return (255.0 * (lbp - lo) / (hi - lo + 1e-6)).astype(jnp.uint8)


register_op(
    "extraction.lbp",
    golden_fn=lbp_extraction,
    data_fn=lbp_data,
    device_fn=lbp_device,
    split=lambda p: ({"P": int(p.get("P", 8)), "R": float(p.get("R", 1.0))}, {}),
    halo=lambda p: int(np.ceil(float(p.get("R", 1.0)))) + 1,
    global_stats=True,  # display normalization is a global min/max
)


# ---------------------------------------------------------------------------
# (D) Haralick / GLCM (core/extraction.py:120-187)
def _haralick_props(image: np.ndarray, distance: int, angle: float) -> Dict[str, float]:
    if XD.use_device_extraction():
        import functools

        import jax

        fn = jax.jit(
            functools.partial(
                XD.haralick_features_j, distance=int(distance), angle=float(angle)
            )
        )
        vals = np.asarray(fn(image))
        return dict(zip(("contrast", "correlation", "energy", "homogeneity"),
                        (float(v) for v in vals)))
    gray = C.bgr_to_gray_np(image)
    glcm = TX.glcm_np(gray, int(distance), float(angle))
    return {k: float(v) for k, v in TX.glcm_props(glcm).items()}


def haralick_extraction(image: np.ndarray, distance: int = 1, angle: float = 0.0):
    props = _haralick_props(image, distance, angle)
    annotated = image.copy()
    text = (
        f"Haralick: Contrast={props['contrast']:.2f}, "
        f"Corr={props['correlation']:.2f}, Energy={props['energy']:.2f}, "
        f"Homog={props['homogeneity']:.2f}"
    )
    AN.draw_text(annotated, text, (10, 30), (255, 0, 0), 0.6, 2)
    return annotated


def haralick_data(image: np.ndarray, distance: int = 1, angle: float = 0.0):
    import pandas as pd

    return pd.DataFrame([_haralick_props(image, distance, angle)])


register_op(
    "extraction.haralick",
    golden_fn=haralick_extraction,
    data_fn=haralick_data,
    feature_fn=XD.haralick_features_j,
    jittable=False,  # annotation embeds host-formatted text
    global_stats=True,
)


# ---------------------------------------------------------------------------
# (E) Gabor (core/extraction.py:190-201)
def gabor_extraction(
    image: np.ndarray,
    ksize: int = 21,
    sigma: float = 5.0,
    theta: float = 0.0,
    lambd: float = 10.0,
    gamma: float = 0.5,
    psi: float = 0.0,
) -> np.ndarray:
    gray = C.bgr_to_gray_np(image)
    return TX.gabor_np(gray, ksize, sigma, theta, lambd, gamma, psi)


def gabor_data(image: np.ndarray, **params: Any) -> pd.DataFrame:
    import pandas as pd

    filtered = gabor_extraction(image, **params)
    return pd.DataFrame(
        [{"mean": float(np.mean(filtered)), "std": float(np.std(filtered))}]
    )


def gabor_device(img, dyn):
    gray = C.bgr_to_gray_j(img)
    return TX.gabor_j(gray, dyn["kernel"])


def _gabor_split(p):
    from yamimageprocessor_tpu.ops import _kernels as K

    kernel = K.gabor_kernel(
        int(p.get("ksize", 21)),
        float(p.get("sigma", 5.0)),
        float(p.get("theta", 0.0)),
        float(p.get("lambd", 10.0)),
        float(p.get("gamma", 0.5)),
        float(p.get("psi", 0.0)),
    )
    return ({}, {"kernel": kernel})


register_op(
    "extraction.gabor",
    golden_fn=gabor_extraction,
    data_fn=gabor_data,
    device_fn=gabor_device,
    split=_gabor_split,
    halo=lambda p: int(p.get("ksize", 21)) // 2,
    global_stats=True,  # min-max normalization
)


# ---------------------------------------------------------------------------
# (F) Fourier descriptors (core/extraction.py:204-245)
def _largest_contour(image: np.ndarray):
    binary = _binary(image)
    contours = SH.trace_external_contours(binary)
    if not contours:
        return None
    return max(contours, key=SH.contour_area)


def _fourier_selected(contour: np.ndarray, num_coeff: int):
    """(selected +-k coefficients, reconstruction) — device DFT kernel on
    the accelerator (``XD.fourier_dft_j``: masked matmuls over a padded
    bucket), f64 FFT golden on host."""

    if XD.use_device_extraction():
        return XD.fourier_descriptors_device(contour, int(num_coeff))
    coeffs, recon = SH.fourier_reconstruct(contour, int(num_coeff))
    k = min(int(num_coeff), len(coeffs))
    selected = np.concatenate([coeffs[:k], coeffs[-k:]]) if k else np.array([])
    return selected, recon


def fourier_descriptors_extraction(image: np.ndarray, num_coeff: int = 10):
    largest = _largest_contour(image)
    if largest is None:
        return image
    _, recon = _fourier_selected(largest, int(num_coeff))
    annotated = image.copy()
    AN.draw_polyline(
        annotated, np.rint(recon).astype(np.int64), (0, 255, 255), 2, closed=True
    )
    return annotated


def fourier_data(image: np.ndarray, num_coeff: int = 10) -> pd.DataFrame:
    import pandas as pd

    largest = _largest_contour(image)
    if largest is None:
        return pd.DataFrame()
    selected, recon = _fourier_selected(largest, int(num_coeff))
    polygon = np.rint(recon).astype(np.int64)
    area = SH.contour_area(polygon)
    perimeter = SH.arc_length(polygon, closed=True)
    circularity = (4 * np.pi * area) / perimeter**2 if perimeter else 0.0
    data: Dict[str, Any] = {
        "num_coeff": int(num_coeff),
        "area": area,
        "perimeter": perimeter,
        "circularity": circularity,
    }
    for i, coeff in enumerate(selected):
        data[f"coeff_{i}_real"] = coeff.real
        data[f"coeff_{i}_imag"] = coeff.imag
    return pd.DataFrame([data])


register_op(
    "extraction.fourier",
    golden_fn=fourier_descriptors_extraction,
    data_fn=fourier_data,
    feature_fn=XD.fourier_dft_j,
    jittable=False,  # contour tracing + polyline annotation are host-side
    global_stats=True,
)


# ---------------------------------------------------------------------------
# (G) HOG (core/extraction.py:248-262)
def hog_extraction(
    image: np.ndarray,
    orientations: int = 9,
    pixels_per_cell=(8, 8),
    cells_per_block=(3, 3),
) -> np.ndarray:
    gray = C.bgr_to_gray_np(image)
    _, hist = H.hog_features_np(
        gray, int(orientations), tuple(pixels_per_cell), tuple(cells_per_block)
    )
    viz = H.hog_visualize_np(
        hist, gray.shape, tuple(pixels_per_cell), int(orientations)
    )
    lo, hi = viz.min(), viz.max()
    return np.uint8(255 * (viz - lo) / (hi - lo + 1e-6))


def hog_data(
    image: np.ndarray,
    orientations: int = 9,
    pixels_per_cell=(8, 8),
    cells_per_block=(3, 3),
) -> pd.DataFrame:
    import pandas as pd

    gray = C.bgr_to_gray_np(image)
    features, _ = H.hog_features_np(
        gray, int(orientations), tuple(pixels_per_cell), tuple(cells_per_block)
    )
    return pd.DataFrame([features])


register_op(
    "extraction.hog",
    golden_fn=hog_extraction,
    data_fn=hog_data,
    device_fn=XD.hog_device_fn,
    split=lambda p: (
        {
            "orientations": int(p.get("orientations", 9)),
            "pixels_per_cell": tuple(p.get("pixels_per_cell", (8, 8))),
            "cells_per_block": tuple(p.get("cells_per_block", (3, 3))),
        },
        {},
    ),
    jittable=True,
    global_stats=True,  # display normalization is a global min/max
)


# ---------------------------------------------------------------------------
# (H) Histogram statistics (core/extraction.py:264-290)
def histogram_stats_extraction(image: np.ndarray) -> np.ndarray:
    gray = C.bgr_to_gray_np(image)
    stats = TX.histogram_stats_np(gray)
    annotated = image.copy()
    text = (
        f"Hist: Mean={stats['mean']:.2f}, Var={stats['variance']:.2f}, "
        f"Skew={stats['skewness']:.2f}, Kurt={stats['kurtosis']:.2f}"
    )
    AN.draw_text(annotated, text, (10, 30), (0, 0, 255), 0.6, 2)
    return annotated


def histogram_data(image: np.ndarray) -> pd.DataFrame:
    import pandas as pd

    if XD.use_device_extraction():
        import jax

        vals = np.asarray(jax.jit(XD.histogram_features_j)(image))
        return pd.DataFrame(
            [dict(zip(("mean", "variance", "skewness", "kurtosis"),
                      (float(v) for v in vals)))]
        )
    gray = C.bgr_to_gray_np(image)
    return pd.DataFrame([TX.histogram_stats_np(gray)])


register_op(
    "extraction.histogram",
    golden_fn=histogram_stats_extraction,
    data_fn=histogram_data,
    feature_fn=XD.histogram_features_j,
    jittable=False,  # annotation embeds host-formatted text
    global_stats=True,
)


# ---------------------------------------------------------------------------
# (I) Fractal dimension (core/extraction.py:293-336)
def fractal_dimension_extraction(image: np.ndarray, min_box_size: int = 2):
    binary = _binary(image, maxval=1)
    dim = H.fractal_dimension(binary, int(min_box_size))
    annotated = image.copy()
    AN.draw_text(annotated, f"Fractal Dim: {dim:.2f}", (10, 30), (255, 255, 0), 0.6, 2)
    return annotated


def fractal_data(image: np.ndarray, min_box_size: int = 2) -> pd.DataFrame:
    import pandas as pd

    if XD.use_device_extraction():
        import functools

        import jax

        fn = jax.jit(
            functools.partial(XD.fractal_feature_j, min_box_size=int(min_box_size))
        )
        return pd.DataFrame([{"fractal_dimension": float(np.asarray(fn(image)))}])
    binary = _binary(image, maxval=1)
    return pd.DataFrame(
        [{"fractal_dimension": H.fractal_dimension(binary, int(min_box_size))}]
    )


register_op(
    "extraction.fractal",
    golden_fn=fractal_dimension_extraction,
    data_fn=fractal_data,
    feature_fn=XD.fractal_feature_j,
    jittable=False,  # annotation embeds host-formatted text
    global_stats=True,
)


# ---------------------------------------------------------------------------
# (J) Approximate shape (core/extraction.py:339-421)
def _optimize_epsilon(contour: np.ndarray, error_threshold: float):
    """Smallest epsilon factor whose simplification stays within the mean
    boundary error (``core/extraction.py:339-366``).

    Douglas-Peucker stays host (cheap recursion over few vertices); the
    O(factors x points x vertices) mean-error evaluation batches into one
    device dispatch on the accelerator (``XD.polygon_mean_errors_j``).
    """

    arc = SH.arc_length(contour, closed=True)
    factors = np.arange(0.005, 0.101, 0.005)
    approxes = [
        SH.approx_poly_dp(contour, float(factor) * arc).reshape(-1, 2)
        for factor in factors
    ]
    if XD.use_device_extraction() and len(contour):
        avgs = XD.polygon_mean_errors_device(
            contour.reshape(-1, 2).astype(np.float64), approxes
        )
    else:
        avgs = []
        for approx in approxes:
            errors = [
                SH.point_polygon_distance(approx, (float(p[0]), float(p[1])))
                for p in contour
            ]
            avgs.append(float(np.mean(errors)) if errors else 0.0)
    best = None
    best_err = np.inf
    for factor, approx, avg in zip(factors, approxes, avgs):
        if avg <= error_threshold:
            return factor, approx
        if avg < best_err:
            best_err = float(avg)
            best = (factor, approx)
    return best if best is not None else (factors[0], contour)


def _shape_records(image: np.ndarray, error_threshold: float):
    binary = _binary(image)
    records = []
    for contour in SH.trace_external_contours(binary):
        if SH.contour_area(contour) < 100:
            continue
        _, approx = _optimize_epsilon(contour, float(error_threshold))
        vertices = approx.reshape(-1, 2)
        area = SH.contour_area(vertices)
        perimeter = SH.arc_length(vertices, closed=True)
        edges = []
        for i in range(len(vertices)):
            nxt = vertices[(i + 1) % len(vertices)]
            edges.append(float(np.linalg.norm(nxt - vertices[i])))
        records.append((vertices, area, perimeter, edges))
    return records


def approximate_shape_extraction(image: np.ndarray, error_threshold: float = 1.0):
    annotated = image.copy()
    for vertices, area, perimeter, _ in _shape_records(image, error_threshold):
        AN.draw_polyline(
            annotated, np.rint(vertices).astype(np.int64), (0, 255, 255), 2, True
        )
        x, y = int(vertices[:, 0].min()), int(vertices[:, 1].min())
        info = f"A:{area:.2f} P:{perimeter:.2f} V:{len(vertices)}"
        AN.draw_text(annotated, info, (x, max(y - 10, 10)), (0, 255, 255), 0.5, 1)
    return annotated


def approximate_shape_data(image: np.ndarray, error_threshold: float = 1.0):
    import pandas as pd

    rows = []
    for index, (vertices, area, perimeter, edges) in enumerate(
        _shape_records(image, error_threshold), start=1
    ):
        rows.append(
            {
                "region_index": index,
                "area": area,
                "perimeter": perimeter,
                "vertices": len(vertices),
                "edge_lengths": ",".join(f"{e:.4f}" for e in edges),
            }
        )
    return pd.DataFrame(rows)


register_op(
    "extraction.approximate_shape",
    golden_fn=approximate_shape_extraction,
    data_fn=approximate_shape_data,
    feature_fn=XD.polygon_mean_errors_j,
    jittable=False,  # contour tracing + text annotation are host-side
    global_stats=True,
)


# ---------------------------------------------------------------------------
# (K) Export segmented regions (core/extraction.py:424-443)
def export_segmented_regions(original_image: np.ndarray, image_path) -> int:
    """Crop every segmented region to ``<name>_regions/`` as PNGs; returns
    the exported count (regions with bbox area < 100 are skipped)."""

    import os

    from yamimageprocessor_tpu.io import image_io

    labels = label_np(_binary(original_image) > 0)
    meas = RP.measure_np(labels)
    if meas.count == 0:
        raise ValueError("No segmented regions found.")
    image_path = os.fspath(image_path)
    base_dir = os.path.dirname(image_path)
    base_name = os.path.splitext(os.path.basename(image_path))[0]
    regions_folder = os.path.join(base_dir, base_name + "_regions")
    os.makedirs(regions_folder, exist_ok=True)
    count = 0
    for region in range(1, meas.count + 1):
        minr, minc, maxr, maxc = (int(v) for v in meas.bbox[region])
        if (maxr - minr) * (maxc - minc) < 100:
            continue
        crop = original_image[minr:maxr, minc:maxc]
        target = os.path.join(
            regions_folder, f"{base_name}_region_{region}.png"
        )
        image_io.save_image(target, crop)
        count += 1
    return count


__all__ = [
    "region_properties_extraction",
    "region_properties_data",
    "hu_moments_extraction",
    "hu_moments_data",
    "lbp_extraction",
    "lbp_data",
    "haralick_extraction",
    "haralick_data",
    "gabor_extraction",
    "gabor_data",
    "fourier_descriptors_extraction",
    "fourier_data",
    "hog_extraction",
    "hog_data",
    "histogram_stats_extraction",
    "histogram_data",
    "fractal_dimension_extraction",
    "fractal_data",
    "approximate_shape_extraction",
    "approximate_shape_data",
    "export_segmented_regions",
]
