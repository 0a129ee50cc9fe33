"""LUT-run composition in the chain compiler.

Consecutive LUT-expressible steps (gamma, brightness/contrast, grayscale
hist-eq — the reference applies these as independent full-frame passes,
``core/preprocessing.py:59-79``) compose into one table application.
Composition is exact on uint8 (``L2[L1[v]]`` per level), so every step's
output must stay bit-identical to sequential execution.
"""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.ops.registry import get_impl
from yamimageprocessor_tpu.pipeline.compiler import CompiledChain
from yamimageprocessor_tpu.pipeline.step import PipelineStep


def _step(op_id: str, **params):
    return PipelineStep(
        name=op_id.split(".")[-1], op_id=op_id, params=params
    )


def _golden_sequential(image, steps):
    outs = []
    cur = image
    for s in steps:
        impl = get_impl(s.op_id)
        cur = impl.golden_fn(cur, **s.params)
        outs.append(cur)
    return outs


@pytest.fixture()
def gray():
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, (96, 128), np.uint8)


def test_value_lut_run_composes_and_matches(gray):
    steps = [
        _step("preprocessing.gamma", value=0.7),
        _step("preprocessing.brightness_contrast", alpha=1.4, beta=-20.0),
        _step("preprocessing.gamma", value=1.8),
    ]
    chain = CompiledChain(steps, gray.shape, gray.dtype)
    assert chain.lut_runs[0] == {0: 3}
    outs = [np.asarray(o) for o in chain.run(gray)]
    for got, want in zip(outs, _golden_sequential(gray, steps)):
        np.testing.assert_array_equal(got, want)


def test_histeq_opens_but_cannot_extend_a_run(gray):
    steps = [
        _step("preprocessing.brightness_contrast", alpha=1.2, beta=5.0),
        _step("preprocessing.histogram_equalization"),
        _step("preprocessing.gamma", value=1.3),
    ]
    chain = CompiledChain(steps, gray.shape, gray.dtype)
    # hist-eq's table derives from its input image, so it may only OPEN a
    # run: brightness stays solo, [hist-eq, gamma] fuse
    assert chain.lut_runs[0] == {1: 2}
    outs = [np.asarray(o) for o in chain.run(gray)]
    for got, want in zip(outs, _golden_sequential(gray, steps)):
        np.testing.assert_array_equal(got, want)


def test_color_histeq_is_not_fused():
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (64, 80, 3), np.uint8)
    steps = [
        _step("preprocessing.histogram_equalization"),
        _step("preprocessing.gamma", value=0.9),
    ]
    chain = CompiledChain(steps, bgr.shape, bgr.dtype)
    # the color path is a YCrCb luma round-trip, not a LUT on BGR values
    assert chain.lut_runs[0] == {}
    outs = [np.asarray(o) for o in chain.run(bgr)]
    for got, want in zip(outs, _golden_sequential(bgr, steps)):
        np.testing.assert_array_equal(got, want)


def test_disabled_step_breaks_a_run(gray):
    steps = [
        _step("preprocessing.gamma", value=0.8),
        _step("preprocessing.brightness_contrast", alpha=1.1, beta=0.0),
        _step("preprocessing.gamma", value=1.4),
    ]
    steps[1].enabled = False
    chain = CompiledChain(steps, gray.shape, gray.dtype)
    assert chain.lut_runs[0] == {}
    outs = chain.run(gray)
    impl = get_impl("preprocessing.gamma")
    want0 = impl.golden_fn(gray, value=0.8)
    np.testing.assert_array_equal(np.asarray(outs[0]), want0)
    np.testing.assert_array_equal(np.asarray(outs[1]), want0)
    np.testing.assert_array_equal(
        np.asarray(outs[2]), impl.golden_fn(want0, value=1.4)
    )


def test_batched_run_matches(gray):
    frames = np.stack([gray, gray[::-1].copy(), np.roll(gray, 7, 1)])
    steps = [
        _step("preprocessing.histogram_equalization"),
        _step("preprocessing.brightness_contrast", alpha=1.3, beta=3.0),
    ]
    chain = CompiledChain(steps, frames.shape, frames.dtype, batch=3)
    assert chain.lut_runs[0] == {0: 2}
    outs = [np.asarray(o) for o in chain.run(frames)]
    for k in range(3):
        for got, want in zip(
            [o[k] for o in outs], _golden_sequential(frames[k], steps)
        ):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "n,px", [(3, 1024), (8, 2048), (11, 1000), (16, 8192), (9, 12345)]
)
def test_histogram256_parity(n, px):
    """Scatter-add histograms (vmapped over tiles) bincount-match for odd
    tile counts and pixel counts off any power of two."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    tiles = np.random.default_rng(21).integers(0, 256, (n, px), dtype=np.uint8)
    got = np.asarray(jax.vmap(histogram256_j)(jnp.asarray(tiles)))
    want = np.stack([np.bincount(tiles[i], minlength=256) for i in range(n)])
    assert (got == want).all()


def test_histogram256_full_bin_counts():
    """Constant tiles put all 65,536 pixels in one bin — counts past 2^15
    and 2^16-1 must come back exact for the extreme levels."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    for value in (0, 128, 200, 255):
        tiles = np.full((9, 256 * 256), value, np.uint8)
        got = np.asarray(jax.vmap(histogram256_j)(jnp.asarray(tiles)))
        want = np.zeros((9, 256), np.int64)
        want[:, value] = 256 * 256
        assert (got == want).all(), value
