"""Tile streaming: non-materialization, reference box order, halo
correctness (tiled == dense bitwise even for stencil ops — the reference's
tiling is wrong at tile borders; ours must not be).

Models the reference's streaming suite
(``tests/test_pipeline_streaming_large.py:52-198``).
"""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.ops.schema import Stage
from yamimageprocessor_tpu.parallel.tiling import iter_tile_boxes
from yamimageprocessor_tpu.pipeline.cache import PipelineCache
from yamimageprocessor_tpu.pipeline.manager import PipelineManager
from yamimageprocessor_tpu.pipeline.step import PipelineStep
from yamimageprocessor_tpu.pipeline.tiled_records import TiledPipelineImage


class _SyntheticStreamingRecord:
    """Tiled source that refuses to materialize (mirrors the reference's
    fake at tests/test_pipeline_streaming_large.py:52-108)."""

    def __init__(self, array: np.ndarray, allow_materialize: bool = False):
        self._array = array
        self.allow_materialize = allow_materialize
        self.shape = array.shape
        self.dtype = array.dtype
        self.read_boxes = []

    def read_region(self, box):
        left, top, right, bottom = box
        self.read_boxes.append(tuple(box))
        return np.array(self._array[top:bottom, left:right, ...], copy=True)

    def iter_tiles(self, tile_size=None):
        h, w = self._array.shape[:2]
        for box in iter_tile_boxes(w, h, tile_size):
            yield box, self.read_region(box)

    def to_array(self):
        if not self.allow_materialize:
            raise AssertionError("streaming source must not be materialized")
        return self._array


def _frame(h=96, w=128):
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, (h, w), dtype=np.uint8)


def test_tile_box_order_matches_reference():
    boxes = list(iter_tile_boxes(100, 50, (32, 32)))
    assert boxes[0] == (0, 0, 32, 32)
    assert boxes[1] == (32, 0, 64, 32)
    assert boxes[3] == (96, 0, 100, 32)  # remainder column
    assert boxes[4] == (0, 32, 32, 50)  # next row, remainder height
    assert len(boxes) == 8


def test_streaming_never_materializes():
    array = _frame()
    record = _SyntheticStreamingRecord(array)
    image = TiledPipelineImage(record, tile_size=(32, 32))
    steps = [
        PipelineStep(
            name="BrightnessContrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": 1.2, "beta": 4.0},
        )
    ]
    manager = PipelineManager(steps)
    out = manager.apply(image)
    assert out.shape == array.shape
    impl_golden = steps[0].impl.golden_fn(array, alpha=1.2, beta=4.0)
    assert (out == impl_golden).all()


def test_halo_correct_stencil_tiling():
    """Gaussian blur across tile borders must equal the dense result —
    the property the reference's halo-less tiling lacks (SURVEY §5)."""

    array = _frame()
    record = _SyntheticStreamingRecord(array)
    image = TiledPipelineImage(record, tile_size=(32, 32))
    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 7},
        ),
        PipelineStep(
            name="BrightnessContrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": 1.1, "beta": 0.0},
        ),
    ]
    manager = PipelineManager(steps)
    tiled_out = manager.apply(image)
    dense_out = manager.apply(array)
    assert (tiled_out == dense_out).all()


def test_median_halo_correct():
    array = _frame()
    record = _SyntheticStreamingRecord(array)
    image = TiledPipelineImage(record, tile_size=(48, 48))
    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Median", "ksize": 5},
        )
    ]
    manager = PipelineManager(steps)
    tiled_out = manager.apply(image)
    dense_out = manager.apply(array)
    assert (tiled_out == dense_out).all()


def test_cache_tiled_incremental_updates():
    array = _frame(64, 96)
    record = _SyntheticStreamingRecord(array)
    image = TiledPipelineImage(record, tile_size=(32, 32))
    cache = PipelineCache()
    sid = cache.register_source_by_token("synthetic:1")
    steps = [
        PipelineStep(
            name="BrightnessContrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": 1.5, "beta": 0.0},
        )
    ]
    updates = []
    result = cache.compute(sid, image, steps, incremental=updates.append)
    assert len(updates) == 6  # 3x2 tiles
    assert [u.box for u in updates] == list(iter_tile_boxes(96, 64, (32, 32)))
    assert all(u.step_index == 1 and u.total_steps == 1 for u in updates)
    reassembled = np.zeros_like(result.image)
    for u in updates:
        left, top, right, bottom = u.box
        reassembled[top:bottom, left:right] = u.tile
    assert (reassembled == result.image).all()


def test_global_stats_chain_streams_without_materializing():
    """The flagship gigapixel shape: a chain containing a stencil op AND
    global-statistics ops (hist-eq, Otsu) streams in two passes without ever
    calling ``to_array`` (reference proof pattern:
    tests/test_pipeline_streaming_large.py:52-108), and matches the dense
    result bit-for-bit."""

    array = _frame(96, 128)
    record = _SyntheticStreamingRecord(array)  # to_array() raises
    image = TiledPipelineImage(record, tile_size=(32, 32))
    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        ),
        PipelineStep(
            name="histogram_equalization",
            op_id="preprocessing.histogram_equalization",
            stage=Stage.PREPROCESSING,
            params={},
        ),
        PipelineStep(name="Otsu", stage=Stage.SEGMENTATION, params={}),
    ]
    manager = PipelineManager(steps)
    out = manager.apply(image)
    dense = manager.apply(array)
    assert (out == dense).all()


def test_normalize_streams_without_materializing():
    array = _frame(64, 96)
    record = _SyntheticStreamingRecord(array)
    image = TiledPipelineImage(record, tile_size=(32, 32))
    steps = [
        PipelineStep(
            name="IntensityNormalization",
            op_id="preprocessing.normalize",
            stage=Stage.PREPROCESSING,
            params={"alpha": 10.0, "beta": 240.0},
        )
    ]
    manager = PipelineManager(steps)
    out = manager.apply(image)
    dense = manager.apply(array)
    assert (out == dense).all()


def test_uniform_grid_streams_same_shape_windows():
    """Exact tile grids take the batched fast path: every source read is
    the SAME-shape shifted halo window (edge tiles shift inward instead of
    shrinking), tiles are emitted in reference row-major order, and the
    result matches dense bit-for-bit."""

    array = _frame(96, 128)
    record = _SyntheticStreamingRecord(array)
    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        ),
        PipelineStep(
            name="histogram_equalization",
            op_id="preprocessing.histogram_equalization",
            stage=Stage.PREPROCESSING,
            params={},
        ),
    ]
    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled

    emitted = []
    out = np.zeros_like(array)

    def on_tile(box, tile):
        emitted.append(tuple(box))
        left, top, right, bottom = box
        out[top:bottom, left:right] = tile

    stream_steps_tiled(steps, record, on_tile, tile_size=(32, 32))
    # every read is a full-size halo window (halo 2 -> 36x36), shifted
    # inward at the frame edges rather than clipped
    sizes = {(r - l, b - t) for (l, t, r, b) in record.read_boxes}
    assert sizes == {(36, 36)}
    assert emitted == list(iter_tile_boxes(128, 96, (32, 32)))
    dense = PipelineManager(steps).apply_host(array)
    assert (out == dense).all()


def test_frame_coupled_op_falls_back_to_dense():
    """Watershed genuinely needs the frame; the dense fallback remains for
    frame-coupled ops only."""

    array = _frame(64, 64)
    record = _SyntheticStreamingRecord(array, allow_materialize=True)
    image = TiledPipelineImage(record, tile_size=(32, 32))
    steps = [
        PipelineStep(
            name="Watershed",
            stage=Stage.SEGMENTATION,
            params={
                "kernel_size": 3,
                "opening_iterations": 1,
                "dilation_iterations": 2,
                "distance_threshold_factor": 0.7,
            },
        )
    ]
    manager = PipelineManager(steps)
    out = manager.apply(image)
    dense = manager.apply(array)
    assert (out == dense).all()


@pytest.mark.performance
def test_streaming_budget():
    """2048x1536 float32 through a 2-step chain (reference budget:
    <3 s wall on CI CPU, tests/test_pipeline_streaming_large.py:166-198)."""

    import resource
    import time

    array = (np.random.default_rng(0).random((1536, 2048)) * 255).astype(np.uint8)
    record = _SyntheticStreamingRecord(array)
    image = TiledPipelineImage(record, tile_size=(256, 256))
    steps = [
        PipelineStep(
            name="BrightnessContrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": 1.2, "beta": 1.0},
        ),
        PipelineStep(name="Gamma", stage=Stage.PREPROCESSING, params={"value": 1.4}),
    ]
    manager = PipelineManager(steps)
    manager.apply(image)  # warm compile
    start = time.monotonic()
    out = manager.apply(image)
    elapsed = time.monotonic() - start
    assert out.shape == array.shape
    assert elapsed < 3.0, f"streaming took {elapsed:.2f}s"


def test_clahe_chain_streams_without_materializing():
    """BASELINE config-2's fused chain (Gaussian+CLAHE+channel-mix) must
    stream: CLAHE decomposes into per-tile grid-histogram contributions
    (stats pass) + LUT blending at absolute coordinates (apply pass).
    Round-2 VERDICT missing #2."""

    rng = np.random.default_rng(7)
    array = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    record = _SyntheticStreamingRecord(array)  # to_array() raises
    image = TiledPipelineImage(record, tile_size=(32, 32))
    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        ),
        PipelineStep(
            name="CLAHE",
            op_id="preprocessing.clahe",
            stage=Stage.PREPROCESSING,
            params={"clip_limit": 2.0, "grid_size": 8},
        ),
        PipelineStep(
            name="SelectChannel",
            op_id="preprocessing.select_channel",
            stage=Stage.PREPROCESSING,
            params={"value": "RG"},
        ),
    ]
    manager = PipelineManager(steps)
    out = manager.apply(image)
    dense = manager.apply(array)
    # <=1 LSB on blend-rounding ties: XLA FMA-contraction differences
    # between the fused streaming and dense programs (same documented tie
    # class as dense CLAHE vs cv2, test_preprocess_ops.py)
    assert np.abs(out.astype(int) - dense.astype(int)).max() <= 1
    assert (out != dense).mean() < 0.01


def test_clahe_streams_with_grid_padding():
    """Non-divisible frame: the stats pass folds the reflect-101 grid
    padding into mirror weights; output still matches dense bit-for-bit."""

    rng = np.random.default_rng(13)
    array = rng.integers(0, 256, (94, 123), dtype=np.uint8)
    record = _SyntheticStreamingRecord(array)
    image = TiledPipelineImage(record, tile_size=(32, 32))
    steps = [
        PipelineStep(
            name="CLAHE",
            op_id="preprocessing.clahe",
            stage=Stage.PREPROCESSING,
            params={"clip_limit": 3.0, "grid_size": 8},
        )
    ]
    manager = PipelineManager(steps)
    out = manager.apply(image)
    dense = manager.apply(array)
    assert np.abs(out.astype(int) - dense.astype(int)).max() <= 1
    assert (out != dense).mean() < 0.01


def test_clahe_stream_gate_rejects_degenerate_geometry():
    from yamimageprocessor_tpu.parallel.tiling import chain_streamable

    steps = [
        PipelineStep(
            name="CLAHE",
            op_id="preprocessing.clahe",
            stage=Stage.PREPROCESSING,
            params={"clip_limit": 2.0, "grid_size": 8},
        )
    ]
    assert chain_streamable(steps, (96, 128, 3))
    assert not chain_streamable(steps, (10, 10))


@pytest.mark.parametrize(
    "shape,steps_kind",
    [
        ((96, 128), "uniform"),  # exact grid -> uniform batched path
        ((90, 123), "stats"),  # ragged grid -> non-uniform stats path
        ((64, 96), "dense"),  # frame-coupled chain -> dense branch
        ((90, 123), "tileable"),  # ragged grid, stencil-only chain
    ],
)
def test_device_sink_honored_on_every_device_path(shape, steps_kind):
    """``device_sink`` is the device-resident result contract: EVERY path
    that runs the chain on the accelerator must hand results over without
    host fetches (r3 review: the non-uniform/dense/tileable paths silently
    ignored the sink and starved its accumulator)."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled

    array = _frame(*shape)
    record = _SyntheticStreamingRecord(array)
    if steps_kind in ("uniform", "stats"):
        steps = [
            PipelineStep(
                name="NoiseReduction",
                stage=Stage.PREPROCESSING,
                params={"method": "Gaussian", "ksize": 5},
            ),
            PipelineStep(
                name="histogram_equalization",
                op_id="preprocessing.histogram_equalization",
                stage=Stage.PREPROCESSING,
                params={},
            ),
        ]
    elif steps_kind == "tileable":
        steps = [
            PipelineStep(
                name="NoiseReduction",
                stage=Stage.PREPROCESSING,
                params={"method": "Gaussian", "ksize": 5},
            )
        ]
    else:
        record.allow_materialize = True  # dense branch needs the frame
        steps = [
            PipelineStep(name="Otsu", stage=Stage.SEGMENTATION, params={}),
            PipelineStep(
                name="Watershed",
                op_id="segmentation.watershed",
                stage=Stage.SEGMENTATION,
                params={},
            ),
        ]

    host_tiles = []
    out = None

    def on_tile(box, tile):
        host_tiles.append(box)

    def sink(tile_boxes, dev_batch):
        nonlocal out
        assert isinstance(dev_batch, jnp.ndarray)  # no host fetch happened
        batch = np.asarray(dev_batch)
        if out is None:
            out = np.zeros(array.shape[:2] + tuple(batch.shape[3:]), batch.dtype)
        for box, tile in zip(tile_boxes, batch):
            left, top, right, bottom = box
            out[top:bottom, left:right, ...] = tile

    stream_steps_tiled(steps, record, on_tile, tile_size=(32, 32), device_sink=sink)
    assert host_tiles == []  # device paths must not double-emit
    dense = PipelineManager(steps).apply(array)
    assert out is not None and (out == np.asarray(dense)).all()


def _global_chain(beta=4.0):
    return [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        ),
        PipelineStep(
            name="histogram_equalization",
            op_id="preprocessing.histogram_equalization",
            stage=Stage.PREPROCESSING,
            params={},
        ),
        PipelineStep(
            name="BrightnessContrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": 1.0, "beta": beta},
        ),
    ]


def test_source_stack_cache_warm_rerun_skips_reads():
    """Cross-call device-resident source cache: a re-run over the same
    source content (token) and tile geometry performs ZERO source reads and
    still matches dense bit-for-bit — the device analogue of the reference's
    content-addressed source memoization
    (processing/pipeline_cache.py:256-282)."""

    from yamimageprocessor_tpu.parallel.tiling import (
        clear_source_stack_cache,
        stream_steps_tiled,
    )

    array = _frame(96, 128)

    class _TokenRecord(_SyntheticStreamingRecord):
        token = ("test-source", 1)

        def cache_token(self):
            return self.token

    clear_source_stack_cache()
    try:
        rec1 = _TokenRecord(array)
        out1 = np.zeros_like(array)

        def paste(buf):
            def on_tile(box, tile):
                left, top, right, bottom = box
                buf[top:bottom, left:right] = tile

            return on_tile

        stream_steps_tiled(_global_chain(), rec1, paste(out1), tile_size=(32, 32))
        assert len(rec1.read_boxes) > 0
        dense = PipelineManager(_global_chain()).apply_host(array)
        assert (out1 == dense).all()

        # warm re-run: fresh record object, same token -> no reads at all
        rec2 = _TokenRecord(array)
        out2 = np.zeros_like(array)
        stream_steps_tiled(_global_chain(), rec2, paste(out2), tile_size=(32, 32))
        assert rec2.read_boxes == []
        assert (out2 == out1).all()

        # parameter tweak (same chain shape/halo): still zero reads, and the
        # result matches the dense chain with the NEW parameters
        rec3 = _TokenRecord(array)
        out3 = np.zeros_like(array)
        stream_steps_tiled(
            _global_chain(beta=40.0), rec3, paste(out3), tile_size=(32, 32)
        )
        assert rec3.read_boxes == []
        dense3 = PipelineManager(_global_chain(beta=40.0)).apply_host(array)
        assert (out3 == dense3).all()

        # content change -> new token -> the cache must miss
        changed = (array.astype(np.int16) + 1).clip(0, 255).astype(np.uint8)
        rec4 = _TokenRecord(changed)
        rec4.token = ("test-source", 2)
        out4 = np.zeros_like(array)
        stream_steps_tiled(_global_chain(), rec4, paste(out4), tile_size=(32, 32))
        assert len(rec4.read_boxes) > 0
        dense4 = PipelineManager(_global_chain()).apply_host(changed)
        assert (out4 == dense4).all()

        # tokenless sources are never cached (mutable arrays stay safe)
        rec5 = _SyntheticStreamingRecord(array)
        stream_steps_tiled(_global_chain(), rec5, paste(out2), tile_size=(32, 32))
        rec6 = _SyntheticStreamingRecord(array)
        stream_steps_tiled(_global_chain(), rec6, paste(out2), tile_size=(32, 32))
        assert len(rec6.read_boxes) > 0
    finally:
        clear_source_stack_cache()


def test_source_stack_cache_budget_eviction():
    """The cache is LRU-bounded by bytes: shrinking the budget below one
    source's stacks disables caching for it (and eviction never corrupts
    results)."""

    from yamimageprocessor_tpu.parallel import tiling as T

    array = _frame(96, 128)

    class _TokenRecord(_SyntheticStreamingRecord):
        def cache_token(self):
            return ("budget-source", 1)

    T.clear_source_stack_cache()
    old_budget = T._SOURCE_STACK_CACHE.budget
    T._SOURCE_STACK_CACHE.budget = 1  # nothing fits
    try:
        rec1 = _TokenRecord(array)
        out = np.zeros_like(array)

        def on_tile(box, tile):
            left, top, right, bottom = box
            out[top:bottom, left:right] = tile

        T.stream_steps_tiled(_global_chain(), rec1, on_tile, tile_size=(32, 32))
        rec2 = _TokenRecord(array)
        T.stream_steps_tiled(_global_chain(), rec2, on_tile, tile_size=(32, 32))
        assert len(rec2.read_boxes) > 0  # nothing was cached
        dense = PipelineManager(_global_chain()).apply_host(array)
        assert (out == dense).all()
    finally:
        T._SOURCE_STACK_CACHE.budget = old_budget
        T.clear_source_stack_cache()


def test_tiled_record_cache_token_tracks_file_changes(tmp_path):
    """File-backed records derive their token from (path, mtime, size) so a
    rewritten file invalidates cached device stacks."""

    import os

    from yamimageprocessor_tpu.io.tiled_image import TiledImageRecord
    from yamimageprocessor_tpu.pipeline.tiled_records import TiledPipelineImage

    path = tmp_path / "frame.npy"
    np.save(path, _frame(64, 64))
    memmap = np.load(path, mmap_mode="r")
    rec = TiledImageRecord.from_npy(path, metadata={}, memmap=memmap)
    tok1 = rec.cache_token()
    assert tok1 is not None
    assert TiledPipelineImage(rec).cache_token() == tok1

    np.save(path, _frame(64, 64) + 1)
    os.utime(path, ns=(1, 1))  # force a distinct mtime even on coarse clocks
    tok2 = rec.cache_token()
    assert tok2 != tok1

    # plain wrapped objects without tokens stay tokenless
    assert TiledPipelineImage(object()).cache_token() is None


def test_tileable_chain_uses_uniform_engine_and_cache():
    """Pure tileable chains (no global-stats op) on exact grids route
    through the batched uniform engine: same-shape halo windows, dense
    bit-parity, and warm re-runs skip every source read."""

    from yamimageprocessor_tpu.parallel.tiling import (
        clear_source_stack_cache,
        stream_steps_tiled,
    )

    array = _frame(96, 128)

    class _TokenRecord(_SyntheticStreamingRecord):
        def cache_token(self):
            return ("tileable-source", 1)

    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        )
    ]
    clear_source_stack_cache()
    try:
        rec1 = _TokenRecord(array)
        out = np.zeros_like(array)

        def on_tile(box, tile):
            left, top, right, bottom = box
            out[top:bottom, left:right] = tile

        stream_steps_tiled(steps, rec1, on_tile, tile_size=(32, 32))
        # batched uniform engine: every read is the same-shape halo window
        sizes = {(r - l, b - t) for (l, t, r, b) in rec1.read_boxes}
        assert sizes == {(36, 36)}
        dense = PipelineManager(steps).apply_host(array)
        assert (out == dense).all()

        rec2 = _TokenRecord(array)
        out2 = np.zeros_like(array)

        def on_tile2(box, tile):
            left, top, right, bottom = box
            out2[top:bottom, left:right] = tile

        stream_steps_tiled(steps, rec2, on_tile2, tile_size=(32, 32))
        assert rec2.read_boxes == []  # warm: zero source reads
        assert (out2 == dense).all()
    finally:
        clear_source_stack_cache()


@pytest.mark.parametrize("sink_mode", [False, True])
def test_generic_path_nonexact_grid_batched(sink_mode):
    """Non-exact tile grids (the generic streaming branch) batch same-shape
    windows into grouped dispatches, read the source exactly ONCE across all
    passes, match dense bit-for-bit, and honor the device-sink contract."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.parallel.tiling import (
        clear_source_stack_cache,
        stream_steps_tiled,
    )

    array = _frame(100, 130)  # 100 % 32 != 0 -> generic branch
    record = _SyntheticStreamingRecord(array)
    steps = _global_chain()
    clear_source_stack_cache()
    try:
        out = np.zeros_like(array)
        boxes_seen = []

        def on_tile(box, tile):
            boxes_seen.append(tuple(box))
            left, top, right, bottom = box
            out[top:bottom, left:right] = tile

        dev_out = np.zeros_like(array)

        def sink(tile_boxes, dev_batch):
            assert isinstance(dev_batch, jnp.ndarray)
            batch = np.asarray(dev_batch)
            for box, tile in zip(tile_boxes, batch):
                left, top, right, bottom = box
                dev_out[top:bottom, left:right] = tile

        if sink_mode:
            stream_steps_tiled(
                steps, record, on_tile, tile_size=(32, 32), device_sink=sink
            )
            assert boxes_seen == []
            result = dev_out
        else:
            stream_steps_tiled(steps, record, on_tile, tile_size=(32, 32))
            assert boxes_seen == list(iter_tile_boxes(130, 100, (32, 32)))
            result = out

        dense = PipelineManager(steps).apply_host(array)
        assert (result == dense).all()
        # ONE read per tile across ALL passes (chain has 1 global op => the
        # naive multi-pass form would read each tile twice)
        n_tiles = len(list(iter_tile_boxes(130, 100, (32, 32))))
        assert len(record.read_boxes) == n_tiles
    finally:
        clear_source_stack_cache()


def test_generic_path_warm_rerun_skips_reads():
    """The cross-call source-stack cache also covers the generic branch."""

    from yamimageprocessor_tpu.parallel.tiling import (
        clear_source_stack_cache,
        stream_steps_tiled,
    )

    array = _frame(100, 130)

    class _TokenRecord(_SyntheticStreamingRecord):
        def cache_token(self):
            return ("generic-source", 1)

    clear_source_stack_cache()
    try:
        outs = []
        for _ in range(2):
            rec = _TokenRecord(array)
            out = np.zeros_like(array)

            def on_tile(box, tile, _out=out):
                left, top, right, bottom = box
                _out[top:bottom, left:right] = tile

            stream_steps_tiled(_global_chain(), rec, on_tile, tile_size=(32, 32))
            outs.append((rec, out))
        assert len(outs[0][0].read_boxes) > 0
        assert outs[1][0].read_boxes == []  # warm: zero reads
        dense = PipelineManager(_global_chain()).apply_host(array)
        assert (outs[0][1] == dense).all()
        assert (outs[1][1] == dense).all()
    finally:
        clear_source_stack_cache()


def test_dense_branch_caches_device_operand():
    """Frame-coupled chains (watershed) materialize + upload once per
    SOURCE: a warm re-run never calls ``to_array`` (the interactive
    segmentation tweak-and-rerun case)."""

    from yamimageprocessor_tpu.parallel.tiling import (
        clear_source_stack_cache,
        stream_steps_tiled,
    )

    array = _frame(96, 128)
    steps = [
        PipelineStep(name="Otsu", stage=Stage.SEGMENTATION, params={}),
        PipelineStep(
            name="Watershed",
            op_id="segmentation.watershed",
            stage=Stage.SEGMENTATION,
            params={},
        ),
    ]

    class _TokenRecord(_SyntheticStreamingRecord):
        def cache_token(self):
            return ("dense-source", 1)

    clear_source_stack_cache()
    try:
        rec1 = _TokenRecord(array, allow_materialize=True)
        out1 = {}

        def collect(store):
            def on_tile(box, tile):
                store[tuple(box)] = np.asarray(tile)

            return on_tile

        stream_steps_tiled(steps, rec1, collect(out1), tile_size=(32, 32))

        # warm: to_array() raising proves the frame upload was reused
        rec2 = _TokenRecord(array, allow_materialize=False)
        out2 = {}
        stream_steps_tiled(steps, rec2, collect(out2), tile_size=(32, 32))
        assert out1.keys() == out2.keys() and len(out1) > 0
        for k in out1:
            np.testing.assert_array_equal(out1[k], out2[k])
        dense = PipelineManager(steps).apply(array)
        top_left = out1[(0, 0, 32, 32)]
        np.testing.assert_array_equal(
            top_left, np.asarray(dense)[:32, :32, ...]
        )
    finally:
        clear_source_stack_cache()


def test_unhashable_cache_token_disables_caching_gracefully():
    """A cache_token() returning an unhashable value must disable caching,
    not crash the stream (review finding r3)."""

    from yamimageprocessor_tpu.parallel.tiling import (
        clear_source_stack_cache,
        stream_steps_tiled,
    )

    array = _frame(96, 128)

    class _BadTokenRecord(_SyntheticStreamingRecord):
        def cache_token(self):
            return ["not", "hashable"]

    clear_source_stack_cache()
    try:
        out = np.zeros_like(array)

        def on_tile(box, tile):
            left, top, right, bottom = box
            out[top:bottom, left:right] = tile

        rec = _BadTokenRecord(array)
        stream_steps_tiled(_global_chain(), rec, on_tile, tile_size=(32, 32))
        dense = PipelineManager(_global_chain()).apply_host(array)
        assert (out == dense).all()

        rec2 = _BadTokenRecord(array)
        stream_steps_tiled(_global_chain(), rec2, on_tile, tile_size=(32, 32))
        assert len(rec2.read_boxes) > 0  # nothing was cached
    finally:
        clear_source_stack_cache()


@pytest.mark.performance
def test_streaming_budget_wall_and_rss():
    """The reference's only quantified perf artifact, ported verbatim:
    a 2048x1536 float32 frame through a 2-step chain, tile 256^2, in
    <3 s wall with peak-RSS delta <= max(4x result bytes, 500 MB) and no
    materialization (/root/reference/tests/test_pipeline_streaming_large.py:166-198)."""

    import resource
    import time as _time

    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    h, w = 1536, 2048
    rng = np.random.default_rng(3)
    data = rng.random((h, w), dtype=np.float32)
    record = _SyntheticStreamingRecord(data)
    steps = [
        PipelineStep(
            name="add", function=lambda a: a + 1.5, supports_tiled_input=True
        ),
        PipelineStep(
            name="scale", function=lambda a: a * 0.5, supports_tiled_input=True
        ),
    ]
    out = np.zeros_like(data)

    def paste(box, tile):
        left, top, right, bottom = box
        out[top:bottom, left:right] = tile

    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    start = _time.perf_counter()
    stream_steps_tiled(steps, record, paste, tile_size=(256, 256))
    elapsed = _time.perf_counter() - start
    rss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    np.testing.assert_allclose(out, (data + 1.5) * 0.5, rtol=0, atol=0)
    assert elapsed < 3.0, f"streaming took {elapsed:.2f}s (budget 3.0s)"
    delta_bytes = (rss_after - rss_before) * 1024  # ru_maxrss is KiB on Linux
    budget = max(4 * out.nbytes, 500 * 1024 * 1024)
    assert delta_bytes <= budget, f"RSS delta {delta_bytes/1e6:.0f} MB > budget"


def _lut_run_chain(kind: str):
    """Chains exercising the streaming LUT-run composition paths."""

    if kind == "normalize+contrast":
        return [
            PipelineStep(
                name="IntensityNormalization",
                op_id="preprocessing.normalize",
                stage=Stage.PREPROCESSING,
                params={"alpha": 10.0, "beta": 240.0},
            ),
            PipelineStep(
                name="BrightnessContrast",
                op_id="preprocessing.brightness_contrast",
                stage=Stage.PREPROCESSING,
                params={"alpha": 1.3, "beta": -6.0},
            ),
        ]
    # hist-eq opens a stats-derived run; gamma + contrast extend it
    return [
        PipelineStep(
            name="histogram_equalization",
            op_id="preprocessing.histogram_equalization",
            stage=Stage.PREPROCESSING,
            params={},
        ),
        PipelineStep(
            name="Gamma",
            op_id="preprocessing.gamma",
            stage=Stage.PREPROCESSING,
            params={"value": 1.8},
        ),
        PipelineStep(
            name="BrightnessContrast",
            op_id="preprocessing.brightness_contrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": 1.3, "beta": -6.0},
        ),
    ]


@pytest.mark.parametrize("kind", ["normalize+contrast", "histeq+gamma+contrast"])
@pytest.mark.parametrize("tile", [(32, 32), (33, 57)])
def test_streamed_lut_run_composition_bit_exact(kind, tile):
    """Stats-derived LUT runs (stats_lut_fn) composed with value LUTs must
    stream bit-exactly vs the dense path on exact AND non-exact grids —
    the fused engine applies the composed table after the center crop."""

    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled

    array = _frame(96, 128)
    rec = _SyntheticStreamingRecord(array)
    steps = _lut_run_chain(kind)
    out = np.zeros_like(array)

    def on_tile(box, t):
        left, top, right, bottom = box
        out[top:bottom, left:right] = t

    stream_steps_tiled(steps, rec, on_tile, tile_size=tile)
    # streamed == dense DEVICE path (normalize is the documented 1-LSB
    # class vs the f64 host golden, so host comparison would conflate
    # that with a composition bug)
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    dense = np.asarray(
        get_compiled_chain(steps, array.shape, array.dtype).run_final(
            array, steps
        )
    )
    np.testing.assert_array_equal(out, dense)
