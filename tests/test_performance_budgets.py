"""Opt-in performance budgets (--run-performance), mirroring the
reference's @performance markers (tests/test_pipeline_streaming_large.py),
plus the bench-size runs on the card (``chip`` marker).

The budgets run on the CPU harness scaled to the reference's own CI budget
(3.1 MPix x 2 steps < 3 s).  The chip tests run the bench's configurations
at full size on the GPU and assert correctness only: they carry no rate
floor until the ledger holds a measured one.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from yamimageprocessor_tpu.models.stages import preprocess_steps, segmentation_steps
from yamimageprocessor_tpu.pipeline.manager import PipelineManager

@pytest.mark.performance
def test_batched_preprocess_budget(rng):
    frames = rng.integers(0, 256, (4, 512, 512), dtype=np.uint8)
    manager = PipelineManager(preprocess_steps())
    manager.apply(frames)  # warm compile
    start = time.monotonic()
    manager.apply(frames)
    elapsed = time.monotonic() - start
    mpix_steps = 4 * 0.262 * 3
    # reference CI bound: ~2.07 MPix*steps/s; require at least that on CPU
    assert mpix_steps / elapsed > 2.07, f"{mpix_steps / elapsed:.2f} MPix*steps/s"


@pytest.mark.performance
def test_segmentation_chain_budget(rng):
    frame = rng.integers(0, 256, (512, 512), dtype=np.uint8)
    frame[100:300, 100:300] = 220
    manager = PipelineManager(segmentation_steps(watershed=False))
    manager.apply(frame)
    start = time.monotonic()
    manager.apply(frame)
    elapsed = time.monotonic() - start
    assert elapsed < 3.0, f"segmentation chain took {elapsed:.2f}s"


@pytest.mark.performance
def test_watershed_budget(rng):
    frame = np.full((256, 256), 30, np.uint8)
    yy, xx = np.mgrid[:256, :256]
    for cy, cx, r in ((60, 60, 30), (180, 180, 35), (60, 180, 25)):
        frame[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 210
    manager = PipelineManager(segmentation_steps(watershed=True)[-1:])
    manager.apply(np.repeat(frame[..., None], 3, axis=-1))
    start = time.monotonic()
    manager.apply(np.repeat(frame[..., None], 3, axis=-1))
    elapsed = time.monotonic() - start
    assert elapsed < 10.0, f"watershed took {elapsed:.2f}s"


# ---------------------------------------------------------------------------
# Bench-size runs on the card: each checks its result against the host
# golden (or a checksum invariant) and reports no rate.


def _dense_scene(side: int, seed: int = 3) -> np.ndarray:
    # the SAME fixture bench.py measures — import, don't fork
    from bench import _dense_scene as bench_scene

    return bench_scene(side, seed)


@pytest.mark.chip
def test_chip_preprocess_chain(rng):
    """BASELINE configs 1-2: the flagship chain on an 8x2048^2 batch
    matches the host golden frame by frame."""

    from yamimageprocessor_tpu.models.stages import flagship_chain

    import jax

    frames = rng.integers(0, 256, (8, 2048, 2048), dtype=np.uint8)
    fn, dyn = flagship_chain(frames.shape, frames.dtype)
    out = np.asarray(jax.jit(lambda x: fn(x, dyn)[-1])(frames))
    manager = PipelineManager(preprocess_steps())
    for k in (0, 7):
        assert (out[k] == manager.apply_host(frames[k])).all(), k


@pytest.mark.chip
def test_chip_watershed_4096():
    """BASELINE config 3 at full size: threshold+open+close+watershed on a
    4096^2 dense scene matches the host golden bit for bit."""

    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    frame = _dense_scene(4096)
    steps = segmentation_steps(watershed=True)
    chain = get_compiled_chain(steps, frame.shape, frame.dtype)
    out = np.asarray(chain.run_final(frame, steps))
    assert (out == PipelineManager(steps).apply_host(frame)).all()


@pytest.mark.chip
def test_chip_segmentation_2048():
    """BASELINE config 3 headline shape: the 2048^2 dense-scene chain is
    deterministic across repeated dispatches and matches the golden."""

    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    frame = _dense_scene(2048)
    steps = segmentation_steps(watershed=True)
    chain = get_compiled_chain(steps, frame.shape, frame.dtype)
    outs = [np.asarray(chain.run_final(frame, steps)) for _ in range(3)]
    golden = PipelineManager(steps).apply_host(frame)
    assert all((o == golden).all() for o in outs)


@pytest.mark.chip
def test_chip_extraction():
    """BASELINE config 4: region extraction takes the device route on the
    GPU and matches the host golden's regions exactly."""

    from yamimageprocessor_tpu.ops import extraction as EX
    from yamimageprocessor_tpu.ops import extraction_device as XD
    from yamimageprocessor_tpu.ops import regionprops as RP
    from yamimageprocessor_tpu.ops.labeling import label_np

    assert XD.use_device_extraction()
    frame = _dense_scene(1024)
    bgr = np.repeat(frame[..., None], 3, axis=-1)
    XD._TABLE_CACHE.clear()
    table = XD.region_table_device(bgr)
    labels = label_np(EX._binary(bgr) > 0)
    meas = RP.measure_np(labels)
    assert not table.get("saturated")
    assert table["meas"].count == meas.count > 0
    np.testing.assert_array_equal(table["meas"].area, meas.area)
    np.testing.assert_array_equal(table["solidity"], RP.solidity_np(labels, meas))


@pytest.mark.chip
def test_chip_nonpow2_batch_sweep():
    """The production batched extraction bundle survives every batch size
    1..8 (non-pow2 included) with bit-exact solidity — no padding."""

    import sys
    from pathlib import Path

    scripts = str(Path(__file__).resolve().parent.parent / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    from check_nonpow2_batches import run_sweep

    run_sweep(verbose=False)


@pytest.mark.chip
def test_chip_gigapixel_streaming(rng):
    """BASELINE config 5 shape: an 8192^2 source with a global-stats chain
    streams through the uniform batched path without materializing and
    matches the host golden."""

    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled

    side = 8192
    data = rng.integers(0, 256, (side, side), dtype=np.uint8)

    class Src:
        shape = data.shape
        tile_size = (2048, 2048)

        def infer_shape(self):
            return data.shape

        def read_region(self, box):
            left, top, right, bottom = box
            return data[top:bottom, left:right]

        def to_array(self):
            raise AssertionError("gigapixel source must not materialize")

    out = np.zeros_like(data)

    def on_tile(box, tile):
        left, top, right, bottom = box
        out[top:bottom, left:right] = tile

    stream_steps_tiled(preprocess_steps(), Src(), on_tile)
    assert (out == PipelineManager(preprocess_steps()).apply_host(data)).all()
