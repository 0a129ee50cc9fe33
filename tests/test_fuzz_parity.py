"""Randomized differential parity: device vs golden over schema-drawn
parameters and awkward geometries.

The fixed parity suites pin one or two parameter points per op; this
sweep draws parameters from each op's declared schema ranges
(``ops/schema.py``, mirroring ``ui/control_metadata.py`` in the
reference) and random shapes — the class of coverage that catches
content/geometry-conditional bugs (batch-shape + content dependent
faults are invisible to every fixed case).

Deterministic: seeded rng, fixed case count, so CI never flakes.
Stochastic/iterative families (clustering, snake, grabcut, mean shift)
are excluded — their device/golden agreement is fractional by design and
audited in services/parity.py instead.
"""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.ops.registry import get_impl
from yamimageprocessor_tpu.ops.schema import op_by_identifier

# identifier -> max |device - golden| in LSB (same classes as the fixed
# suites: 0 for integer/mask/LUT ops, 1 for float filter rounding)
FUZZ_OPS = {
    "preprocessing.grayscale": 0,
    "preprocessing.brightness_contrast": 0,
    "preprocessing.gamma": 0,
    "preprocessing.normalize": 1,
    "preprocessing.noise_reduction": 1,  # per-method override below
    "preprocessing.sharpen": 1,
    "preprocessing.select_channel": 0,
    "preprocessing.histogram_equalization": 0,
    "preprocessing.clahe": 1,
    "preprocessing.crop": 0,
    "segmentation.global_threshold": 0,
    "segmentation.otsu": 0,
    "segmentation.adaptive": 0,
    "segmentation.edge": 0,
    "segmentation.sobel": 0,
    "segmentation.prewitt": 0,
    "segmentation.laplacian": 0,
    "segmentation.watershed": 0,
    "segmentation.region_growing": 0,
    "segmentation.region_split_merge": 0,
    "segmentation.opening": 0,
    "segmentation.closing": 0,
    "segmentation.dilation": 0,
    "segmentation.erosion": 0,
    "segmentation.border_removal": 0,
}

SHAPES = [(97, 131), (64, 96), (33, 259), (16, 128), (128, 160), (61, 60)]


def _draw_params(identifier: str, shape, rng) -> dict:
    """Random parameter point inside the schema's declared ranges, with
    shape-aware clamps for params the schema leaves open-ended."""

    h, w = shape
    schema = op_by_identifier(identifier)
    params = {}
    for spec in schema.params:
        if spec.kind == "bool":
            v = bool(rng.integers(2))
        elif spec.choices:
            v = spec.choices[int(rng.integers(len(spec.choices)))]
        elif spec.kind == "int":
            lo = int(spec.minimum) if spec.minimum is not None else 0
            hi = int(spec.maximum) if spec.maximum is not None else lo + 64
            v = int(rng.integers(lo, hi + 1))
        elif spec.kind == "float":
            lo = float(spec.minimum) if spec.minimum is not None else 0.0
            hi = float(spec.maximum) if spec.maximum is not None else lo + 10.0
            v = float(rng.uniform(lo, hi))
        else:
            v = spec.default
        params[spec.name] = spec.coerce(v)

    # shape-aware / runtime clamps the schema cannot express
    if identifier == "preprocessing.crop":
        params["x_offset"] = int(rng.integers(0, w - 4))
        params["y_offset"] = int(rng.integers(0, h - 4))
        params["width"] = int(rng.integers(2, w - params["x_offset"]))
        params["height"] = int(rng.integers(2, h - params["y_offset"]))
    elif identifier == "segmentation.region_growing":
        # call params use the (x, y) seed tuple (the schema's seed_x/seed_y
        # are the persisted settings form, translated by settings_to_params)
        params.pop("seed_x", None)
        params.pop("seed_y", None)
        params["seed"] = (int(rng.integers(0, w)), int(rng.integers(0, h)))
    elif identifier == "segmentation.border_removal":
        params["border_distance"] = int(rng.integers(1, max(2, min(h, w) // 2)))
    elif identifier == "segmentation.adaptive":
        params["block_size"] = min(params["block_size"], (min(h, w) - 1) | 1)
    elif identifier == "segmentation.watershed":
        params["kernel_size"] = int(rng.integers(1, 8))
        params["opening_iterations"] = int(rng.integers(0, 4))
        params["dilation_iterations"] = int(rng.integers(0, 5))
    elif identifier in (
        "segmentation.opening",
        "segmentation.closing",
        "segmentation.dilation",
        "segmentation.erosion",
    ):
        params["kernel_size"] = int(rng.integers(1, 10))
        params["iterations"] = int(rng.integers(1, 6))
    elif identifier == "preprocessing.noise_reduction":
        params["ksize"] = int(rng.integers(0, 4)) * 2 + 1  # 1..7
    elif identifier in ("segmentation.sobel", "segmentation.laplacian"):
        params["ksize"] = int(rng.integers(0, 3)) * 2 + 1  # 1..5
    elif identifier == "segmentation.edge":
        params["aperture_size"] = 3 + 2 * int(rng.integers(0, 2))
    elif identifier == "segmentation.region_split_merge":
        params["min_size"] = int(rng.integers(2, 33))
    elif identifier == "preprocessing.clahe":
        params["grid_size"] = int(rng.integers(2, 9))
        params["clip_limit"] = float(rng.uniform(0.5, 8.0))
    return params


def _scene(shape, rng, color: bool) -> np.ndarray:
    h, w = shape
    img = rng.integers(0, 256, (h, w, 3) if color else (h, w), dtype=np.uint8)
    # structured blobs so segmentation ops see real regions, not pure noise
    yy, xx = np.mgrid[:h, :w]
    for _ in range(3):
        cy, cx = int(rng.integers(h)), int(rng.integers(w))
        r = int(rng.integers(4, max(5, min(h, w) // 4)))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = int(rng.integers(120, 256))
    return img


def _run_device(impl, image, params):
    import jax.numpy as jnp

    static, dyn = impl.split_params(params, image.shape)
    dyn_j = {k: jnp.asarray(v) for k, v in dyn.items()}
    return np.asarray(impl.device_fn(jnp.asarray(image), dyn_j, **static))


@pytest.mark.parametrize("identifier", sorted(FUZZ_OPS))
def test_fuzzed_device_golden_parity(identifier):
    tol = FUZZ_OPS[identifier]
    impl = get_impl(identifier)
    import zlib

    # stable per-op seed (str hash() is salted per process — nondeterministic)
    rng = np.random.default_rng(zlib.crc32(identifier.encode()))
    for case in range(3):
        shape = SHAPES[int(rng.integers(len(SHAPES)))]
        color = bool(rng.integers(2))
        if identifier == "preprocessing.grayscale":
            color = True
        img = _scene(shape, rng, color)
        params = _draw_params(identifier, shape, rng)
        case_tol = tol
        if (
            identifier == "preprocessing.noise_reduction"
            and params.get("method") == "Median"
        ):
            case_tol = 0  # selection networks are exact
        golden = impl.golden_fn(img, **params)
        device = _run_device(impl, img, params)
        assert device.shape == golden.shape, (identifier, params, shape)
        assert device.dtype == golden.dtype, (identifier, params, shape)
        diff = np.abs(device.astype(np.int64) - golden.astype(np.int64)).max()
        assert diff <= case_tol, (
            f"{identifier} case {case}: diff {diff} > {case_tol} "
            f"shape={shape} color={color} params={params}"
        )
