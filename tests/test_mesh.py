"""Device-mesh execution on the virtual 8-device CPU harness:
frame-sharded batches and row-sharded frames with halo exchange +
collective global statistics (the multi-node-without-a-cluster strategy,
SURVEY §4)."""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.models.stages import preprocess_steps
from yamimageprocessor_tpu.ops.schema import Stage
from yamimageprocessor_tpu.parallel.mesh import (
    batch_sharded_apply,
    make_mesh,
    spatial_sharded_apply,
)
from yamimageprocessor_tpu.pipeline.manager import PipelineManager
from yamimageprocessor_tpu.pipeline.step import PipelineStep


@pytest.fixture(scope="module")
def mesh():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU harness")
    return make_mesh(8)


@pytest.fixture()
def frames(rng):
    return rng.integers(0, 256, (16, 64, 96), dtype=np.uint8)


def test_batch_sharded_matches_host(mesh, frames):
    steps = preprocess_steps()
    out = batch_sharded_apply(steps, frames, mesh)
    manager = PipelineManager(steps)
    for i in range(frames.shape[0]):
        expected = manager.apply_host(frames[i])
        assert (out[i] == expected).all(), f"frame {i}"


def test_spatial_sharded_stencil_and_global(mesh, rng):
    frame = rng.integers(0, 256, (64 * 8, 96), dtype=np.uint8)
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
    out = spatial_sharded_apply(steps, frame, mesh)
    dense = PipelineManager(steps).apply_host(frame)
    # interior: bit-identical (halo exchange carries real pixels; global
    # stats travel via psum so the Otsu threshold matches everywhere)
    assert (out[8:-8] == dense[8:-8]).all()
    # whole-frame agreement is near-total (first/last shard border rows use
    # the mirrored extension)
    assert (out == dense).mean() > 0.999


def test_spatial_sharded_elementwise_exact_everywhere(mesh, rng):
    frame = rng.integers(0, 256, (64 * 8, 96), dtype=np.uint8)
    steps = [
        PipelineStep(
            name="BrightnessContrast",
            stage=Stage.PREPROCESSING,
            params={"alpha": 1.3, "beta": 5.0},
        ),
        PipelineStep(
            name="Gamma", stage=Stage.PREPROCESSING, params={"value": 1.7}
        ),
    ]
    out = spatial_sharded_apply(steps, frame, mesh)
    dense = PipelineManager(steps).apply_host(frame)
    assert (out == dense).all()


def test_spatial_sharded_segmentation_chain_bit_exact(mesh, rng):
    """SURVEY hard part #1: threshold+morphology+watershed over a
    row-sharded mesh — labels/boundaries bit-identical to the dense path
    (all-gathered label merge, per-sweep halo exchange, op-correct border
    fills)."""

    from yamimageprocessor_tpu.models.stages import segmentation_steps

    h, w = 16 * 8, 96
    frame = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for cy, cx, r, v in ((30, 30, 12, 200), (70, 60, 14, 170), (100, 25, 9, 220)):
        frame[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = v
    frame = (
        (frame.astype(np.int16) + rng.integers(-8, 9, frame.shape))
        .clip(0, 255)
        .astype(np.uint8)
    )
    steps = segmentation_steps(watershed=True)
    out = spatial_sharded_apply(steps, frame, mesh)
    dense = PipelineManager(steps).apply_host(frame)
    assert (out == dense).all()


def test_spatial_sharded_clahe_bit_exact(mesh, rng):
    """Collective CLAHE: psum'd grid histograms + shared LUT math give
    full-frame bit parity (the BASELINE fused Gaussian+CLAHE chain)."""

    frame = rng.integers(0, 256, (16 * 8, 96), dtype=np.uint8)
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
    ]
    out = spatial_sharded_apply(steps, frame, mesh)
    # compare against the dense DEVICE path: the sharded blend matches it
    # bit-for-bit (the f64 numpy golden differs by <=1 LSB at exact .5
    # rounding boundaries — a dense-device property, not a sharding one)
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    dense_dev = get_compiled_chain(steps, frame.shape, frame.dtype).run_final(
        frame, steps
    )
    assert (out == dense_dev).all()
    dense = PipelineManager(steps).apply_host(frame)
    assert np.abs(out.astype(np.int16) - dense.astype(np.int16)).max() <= 1


def test_spatial_sharded_morphology_exact_everywhere(mesh, rng):
    """Morphology sharded variants reproduce cv2's extreme-value borders
    exactly, including the first/last shard's frame-edge rows."""

    frame = (rng.integers(0, 2, (16 * 8, 96), dtype=np.uint8)) * 255
    steps = [
        PipelineStep(
            name="Opening",
            stage=Stage.SEGMENTATION,
            params={"kernel_shape": "Elliptical", "kernel_size": 5, "iterations": 2},
        ),
        PipelineStep(
            name="Closing",
            stage=Stage.SEGMENTATION,
            params={"kernel_shape": "Rectangular", "kernel_size": 3, "iterations": 1},
        ),
    ]
    out = spatial_sharded_apply(steps, frame, mesh)
    dense = PipelineManager(steps).apply_host(frame)
    assert (out == dense).all()


def test_sharded_labeling_beyond_512_components(mesh):
    """The sharded renumbering's capacity is per-band, not global: a frame
    with >512 components still matches the dense labeling bit-for-bit
    (regression: the gathered root list used to re-truncate to 512)."""

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from yamimageprocessor_tpu.ops.labeling import label_np
    from yamimageprocessor_tpu.ops.watershed_sharded import label_sharded_j

    h, w = 16 * 8, 160
    fg = np.zeros((h, w), bool)
    # isolated single-pixel components: 320 per 16-row shard band (inside
    # the per-band capacity), 2560 total (5x the old global truncation)
    fg[::2, ::4] = True
    dense = label_np(fg)
    assert dense.max() > 512

    axis = mesh.axis_names[0]
    fn = jax.shard_map(
        lambda block: label_sharded_j(block, axis),
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
        check_vma=False,
    )
    dev = jax.device_put(jnp.asarray(fg), NamedSharding(mesh, P(axis)))
    out = np.asarray(jax.jit(fn)(dev))
    assert (out == dense).all()


def test_mesh_sharded_tile_streaming_bit_exact(mesh, rng):
    """Uniform-grid streaming with tile batches sharded over the mesh
    (data-parallel tiles): same bit-exact result as the dense path, stats
    merged across devices by XLA."""

    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled

    side, tile = 512, 64  # 8x8 grid -> batches of 8, divisible by 8 devices
    data = rng.integers(0, 256, (side, side), dtype=np.uint8)

    class Src:
        shape = data.shape
        tile_size = (tile, tile)

        def infer_shape(self):
            return data.shape

        def read_region(self, box):
            left, top, right, bottom = box
            return data[top:bottom, left:right]

        def to_array(self):
            raise AssertionError("must stream, not materialize")

    out = np.zeros_like(data)

    def on_tile(box, t):
        left, top, right, bottom = box
        out[top:bottom, left:right] = t

    steps = preprocess_steps()
    stream_steps_tiled(steps, Src(), on_tile, mesh=mesh)
    dense = PipelineManager(steps).apply_host(data)
    assert (out == dense).all()


def test_spatial_sharded_rejects_bad_height(mesh, rng):
    frame = rng.integers(0, 256, (100, 64), dtype=np.uint8)
    with pytest.raises(ValueError):
        spatial_sharded_apply(
            [PipelineStep(name="Otsu", stage=Stage.SEGMENTATION)], frame, mesh
        )


def test_spatial_sharded_rejects_host_ops(mesh, rng):
    frame = rng.integers(0, 256, (64 * 8, 64), dtype=np.uint8)
    with pytest.raises(ValueError):
        spatial_sharded_apply(
            [PipelineStep(name="Graph Cuts", stage=Stage.SEGMENTATION)],
            frame,
            mesh,
        )


@pytest.mark.parametrize(
    "name,params",
    [
        ("Prewitt", {}),  # replicate borders (edges.py:227)
        ("Adaptive", {"block_size": 11, "C": 2}),  # replicate mean
        ("NoiseReduction", {"method": "Gaussian", "ksize": 5}),  # reflect-101
    ],
)
def test_spatial_sharding_matches_dense_at_frame_borders(rng, name, params):
    """TRUE frame edges must use each op's OWN border mode (r3 review: the
    halo fill hardcoded reflect-101, so replicate-border ops diverged on
    the first/last rows of the frame)."""

    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.parallel.mesh import make_mesh, spatial_sharded_apply
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    frame = rng.integers(0, 255, (64, 48), dtype=np.uint8)
    step = PipelineStep(name=name, stage=(Stage.PREPROCESSING if name == "NoiseReduction" else Stage.SEGMENTATION), params=dict(params))
    mesh = make_mesh()
    sharded = spatial_sharded_apply([step], frame, mesh)
    dense = step.apply(frame)
    assert (np.asarray(sharded) == np.asarray(dense)).all()


def test_spatial_sharding_rejects_oversized_halo(rng):
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.parallel.mesh import make_mesh, spatial_sharded_apply
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    frame = rng.integers(0, 255, (64, 48), dtype=np.uint8)  # 8-row shards
    step = PipelineStep(
        name="NoiseReduction",
        stage=Stage.PREPROCESSING,
        params={"method": "Gaussian", "ksize": 31},  # halo 15 > 7
    )
    with pytest.raises(ValueError, match="halo"):
        spatial_sharded_apply([step], frame, make_mesh())


def test_tileable_stream_honours_mesh(mesh, rng):
    """Plain filter chains (no global-stats op) must also shard uniform
    batches over the mesh (r3 review: only the stats path honoured it)."""

    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    frame = rng.integers(0, 255, (128, 128), dtype=np.uint8)

    class _Src:
        shape = frame.shape
        tile_size = (16, 16)

        def infer_shape(self):
            return frame.shape

        def read_region(self, box):
            left, top, right, bottom = box
            return np.array(frame[top:bottom, left:right], copy=True)

    steps = [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        )
    ]
    out = np.zeros_like(frame)

    def on_tile(box, tile):
        left, top, right, bottom = box
        out[top:bottom, left:right] = tile

    stream_steps_tiled(steps, _Src(), on_tile, device_sink=None, mesh=mesh)
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager

    dense = PipelineManager(steps).apply(frame)
    assert (out == np.asarray(dense)).all()


SHARD_FUZZ_POOL = [
    ("preprocessing.brightness_contrast", None),
    ("preprocessing.gamma", None),
    ("preprocessing.histogram_equalization", None),  # psum'd histogram
    ("preprocessing.normalize", None),  # psum'd min/max
    ("preprocessing.noise_reduction", None),  # halo stencil
    ("preprocessing.clahe", {"grid_size": 8}),  # collective grid hists
    ("segmentation.global_threshold", None),
    ("segmentation.otsu", None),  # psum'd histogram
    ("segmentation.opening", None),  # iterated halo
    ("segmentation.closing", None),
    ("segmentation.dilation", None),
    ("segmentation.erosion", None),
]


@pytest.mark.parametrize("shard_seed", range(6))
def test_fuzzed_spatial_sharded_matches_dense(mesh, shard_seed, rng):
    """Random chains row-sharded over the 8-device mesh vs the dense host
    path: interior bit-exact, whole frame >= 0.999 (first/last shard
    border rows may use the mirrored extension) — the fixed sharded
    tests' contract, fuzzed over schema-drawn parameters."""

    import zlib

    from tests.test_fuzz_parity import _draw_params, _scene
    from yamimageprocessor_tpu.ops.registry import get_impl

    frng = np.random.default_rng(zlib.crc32(b"shard") + shard_seed)
    shape = [(128, 96), (136, 120), (192, 160)][shard_seed % 3]
    frame = _scene(shape, frng, color=False)

    steps = []
    for _ in range(int(frng.integers(2, 4))):
        op, overrides = SHARD_FUZZ_POOL[int(frng.integers(len(SHARD_FUZZ_POOL)))]
        params = _draw_params(op, shape, frng)
        if op == "preprocessing.noise_reduction":
            params["method"] = ("Gaussian", "Median")[int(frng.integers(2))]
            params["ksize"] = int(frng.integers(1, 4)) * 2 + 1
        if op in (
            "segmentation.opening",
            "segmentation.closing",
            "segmentation.dilation",
            "segmentation.erosion",
        ):
            params["iterations"] = int(frng.integers(1, 4))
        if overrides:
            params.update(overrides)
        steps.append(
            PipelineStep(
                name=op.split(".")[-1],
                op_id=op,
                stage=Stage.PREPROCESSING if op.startswith("pre") else Stage.SEGMENTATION,
                params=params,
            )
        )
        get_impl(op)  # registry sanity

    out = spatial_sharded_apply(steps, frame, mesh)
    dense = PipelineManager(steps).apply_host(frame)
    label = f"seed {shard_seed} chain={[(s.op_id, s.params) for s in steps]}"
    assert (out[8:-8] == dense[8:-8]).all(), f"interior diverged: {label}"
    assert (out == dense).mean() > 0.999, f"border rows diverged: {label}"
