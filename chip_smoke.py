#!/usr/bin/env python
"""Smoke run of the image chains on a GPU, checked against the numpy goldens.

One process opens the card.  The default run (one GPU) drives the main
path through the entry points a user calls — ``cli process`` / ``cli
batch``, the compiled chains of ``pipeline/compiler.py``,
``extraction_device.region_tables_device`` and ``stream_steps_tiled`` — at
the bench's sizes, compares every result with the host golden under the
parity classes of ``services/parity.py``, runs the device parity audit and
the ``chip``-marked tests, and ends with one JSON line:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Options (never combined with the default run):

    --four-cards     the mesh paths on four GPUs, each compared bit-exact
                     with the single-device dense path; nothing else
    --compare-forms  time the candidate plain forms of the hot ops
    --rehearse       every phase at tiny sizes on the CPU (JAX_PLATFORMS=cpu);
                     never prints the ok line

The timings printed here are smoke timings (one warm call after compile),
not benchmark numbers.  Goldens run on the host in worker processes that
never touch the card, while the card runs the chip tests.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

FULL = dict(
    cli=2048, batch=(8, 2048), flagship=(8, 2048), seg=2048, seg_batch=(8, 2048),
    seg_big=4096, clahe=(64, 1024), extract=(8, 2048), stream=(16384, 2048),
    mesh_batch=(32, 2048), mesh_spatial=8192, mesh_seg=4096, mesh_clahe=4096,
    mesh_stream=(8192, 2048), mesh_extract=(32, 2048), forms=(2048, 4096),
    forms_batch=8, forms_clahe=(64, 1024),
)
TINY = dict(
    cli=96, batch=(3, 64), flagship=(2, 64), seg=96, seg_batch=(3, 96),
    seg_big=128, clahe=(4, 64), extract=(3, 128), stream=(512, 128),
    mesh_batch=(8, 64), mesh_spatial=256, mesh_seg=512, mesh_clahe=256,
    mesh_stream=(512, 128), mesh_extract=(8, 128), forms=(64, 128),
    forms_batch=2, forms_clahe=(4, 64),
)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# host goldens (worker processes forced onto the CPU backend)


def _golden_worker_init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def _golden_steps(kind: str):
    from yamimageprocessor_tpu.models.stages import preprocess_steps, segmentation_steps

    if kind == "preprocess":
        return preprocess_steps()
    if kind == "segmentation":
        return segmentation_steps(watershed=True)
    if kind == "clahe":
        return clahe_steps(4)
    raise KeyError(kind)


def golden_chain(kind: str, frame: np.ndarray) -> np.ndarray:
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager

    return PipelineManager(_golden_steps(kind)).apply_host(frame)


def golden_cli(settings: str, stages: str, frame: np.ndarray) -> np.ndarray:
    """The CLI's own settings -> steps build, run by the host golden."""

    from yamimageprocessor_tpu import cli
    from yamimageprocessor_tpu.pipeline.manager import PipelineManager

    core = cli._build_core(argparse.Namespace(settings=settings))
    try:
        steps = cli._stage_steps(core, stages.split(","))
    finally:
        core.shutdown()
    return PipelineManager(steps).apply_host(frame)


def golden_regions(bgr: np.ndarray):
    from yamimageprocessor_tpu.ops import extraction as EX
    from yamimageprocessor_tpu.ops import regionprops as RP
    from yamimageprocessor_tpu.ops.labeling import label_np

    labels = label_np(EX._binary(bgr) > 0)
    meas = RP.measure_np(labels)
    return meas.area, meas.centroid_r, meas.centroid_c, RP.solidity_np(labels, meas)


def clahe_steps(grid: int):
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.pipeline.step import PipelineStep

    return [
        PipelineStep(
            name="NoiseReduction",
            stage=Stage.PREPROCESSING,
            params={"method": "Gaussian", "ksize": 5},
        ),
        PipelineStep(
            name="CLAHE",
            op_id="preprocessing.clahe",
            stage=Stage.PREPROCESSING,
            params={"clip_limit": 2.0, "grid_size": grid},
        ),
        PipelineStep(
            name="SelectChannel",
            op_id="preprocessing.select_channel",
            stage=Stage.PREPROCESSING,
            params={"value": "RG"},
        ),
    ]


# ---------------------------------------------------------------------------
# checks


class Phases:
    """Pass/fail bookkeeping: every phase prints one line; a failed check
    fails the run after the remaining phases have reported."""

    def __init__(self) -> None:
        self.failed: list = []

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        say(f"{'PASS' if ok else 'FAIL'} {name}: {detail}")
        if not ok:
            self.failed.append(name)

    def run(self, name: str, fn, *args) -> None:
        try:
            fn(self, *args)
        except Exception as exc:  # noqa: BLE001 — report, then fail the run
            import traceback

            traceback.print_exc()
            self.check(name, False, f"{type(exc).__name__}: {exc}")


def max_diff(a, b) -> int:
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return 1 << 30
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(initial=0))


def program(name: str, fn, *args):
    """Compile ``fn`` for ``args``, run it twice, print the smoke timings
    and the compiled memory analysis; returns the output."""

    import jax

    jitted = jax.jit(fn)
    start = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    compile_s = time.perf_counter() - start
    jax.block_until_ready(compiled(*args))
    start = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    warm_s = time.perf_counter() - start
    mem = compiled.memory_analysis()
    fields = (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "temp_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    memory = {f: getattr(mem, f, None) for f in fields} if mem is not None else None
    say(
        f"  smoke timing {name}: compile {compile_s:.3f} s, warm {warm_s:.4f} s, "
        f"memory {json.dumps(memory)}"
    )
    return out


def timed_call(name: str, fn, *args):
    """Cold (compile included) and warm wall time of a host entry point."""

    start = time.perf_counter()
    fn(*args)
    cold_s = time.perf_counter() - start
    start = time.perf_counter()
    out = fn(*args)
    warm_s = time.perf_counter() - start
    say(f"  smoke timing {name}: first call {cold_s:.3f} s, warm {warm_s:.4f} s")
    return out


# ---------------------------------------------------------------------------
# single-card phases


def scene(side: int, seed: int = 3) -> np.ndarray:
    from bench import _dense_scene

    return _dense_scene(side, seed)


def write_settings(path: Path) -> None:
    path.write_text(
        json.dumps(
            {
                "preprocess/order": "NoiseReduction,BrightnessContrast",
                "segmentation/order": "Otsu,Opening,Closing,Watershed",
            }
        )
    )


def phase_cli_process(ph: Phases, work: Path, golden) -> None:
    from yamimageprocessor_tpu import cli

    out = work / "process_out.npy"
    argv = [
        "--settings", str(work / "settings.json"),
        "process", str(work / "process_in.npy"), str(out),
        "--stages", "preprocessing,segmentation",
    ]
    rc = timed_call("cli process", cli.main, argv)
    got = np.load(out)
    ph.check("cli process", rc == 0 and max_diff(got, golden.get()) == 0,
             f"rc={rc} shape={got.shape} maxdiff={max_diff(got, golden.get())} (bit-exact)")


def phase_cli_batch(ph: Phases, work: Path, goldens) -> None:
    from yamimageprocessor_tpu import cli

    argv = [
        "--settings", str(work / "settings.json"),
        "batch", str(work / "batch_in"), str(work / "batch_out"),
        "--stages", "preprocessing", "--suffix", ".npy",
    ]
    rc = timed_call("cli batch", cli.main, argv)
    diffs = [
        max_diff(np.load(work / "batch_out" / f"frame{k}.npy"), g.get())
        for k, g in enumerate(goldens)
    ]
    ph.check("cli batch", rc == 0 and max(diffs) <= 1,
             f"rc={rc} frames={len(diffs)} maxdiff={max(diffs)} (float filters <= 1 LSB)")


def phase_flagship(ph: Phases, frames: np.ndarray, goldens) -> None:
    import jax

    from yamimageprocessor_tpu.models.stages import flagship_chain

    fn, dyn = flagship_chain(frames.shape, frames.dtype)
    out = np.asarray(
        program("flagship 3-step chain", lambda x: fn(x, dyn)[-1], jax.device_put(frames))
    )
    diffs = [max_diff(out[k], g.get()) for k, g in enumerate(goldens)]
    ph.check("flagship chain", max(diffs) <= 1,
             f"{frames.shape} maxdiff={max(diffs)} (float filters <= 1 LSB)")


def _chain_out(name: str, steps, frames: np.ndarray, batch: int = 0):
    import jax

    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    chain = get_compiled_chain(steps, frames.shape, frames.dtype, batch=batch)
    fn, dyn = chain.pure_callable()
    return np.asarray(program(name, lambda x: fn(x, dyn)[-1], jax.device_put(frames)))


def phase_segmentation(ph: Phases, name: str, frames: np.ndarray, goldens, batch: int) -> None:
    from yamimageprocessor_tpu.models.stages import segmentation_steps

    out = _chain_out(name, segmentation_steps(watershed=True), frames, batch)
    outs = out if batch else out[None]
    diffs = [max_diff(outs[k], g.get()) for k, g in enumerate(goldens)]
    ph.check(name, max(diffs) == 0, f"{frames.shape} maxdiff={max(diffs)} (masks bit-exact)")


def phase_clahe(ph: Phases, frames: np.ndarray, goldens) -> None:
    out = _chain_out("gaussian+clahe+channel-mix", clahe_steps(4), frames, frames.shape[0])
    diffs = [max_diff(out[k], g.get()) for k, g in enumerate(goldens)]
    ph.check("gaussian+clahe+channel-mix", max(diffs) <= 1,
             f"{frames.shape} maxdiff={max(diffs)} (float filters <= 1 LSB)")


def phase_extraction(ph: Phases, frames, goldens, rehearse: bool) -> None:
    from yamimageprocessor_tpu.ops import extraction_device as XD

    def run():
        XD._TABLE_CACHE.clear()
        return XD.region_tables_device(frames)

    tables = timed_call("region_tables_device", run)
    ok = rehearse or XD.use_device_extraction()  # the GPU routes to the device
    detail = []
    for k, (table, g) in enumerate(zip(tables, goldens)):
        area, cr, cc, sol = g.get()
        meas = table.get("meas")
        good = (
            not table.get("saturated")
            and meas is not None
            and meas.count == len(area) - 1
            and np.array_equal(meas.area, area)
            and np.array_equal(table["solidity"], sol)
            # row 0 is the background, which the table does not export:
            # its f32 moment sum over millions of pixels drifts past 1e-5
            and np.allclose(meas.centroid_r[1:], cr[1:], rtol=1e-5)
            and np.allclose(meas.centroid_c[1:], cc[1:], rtol=1e-5)
        )
        ok = ok and good
        detail.append(meas.count if meas is not None else -1)
    ph.check("region_tables_device", ok,
             f"{len(frames)} frames, regions {detail}: counts/areas/solidity exact, "
             "region centroids rtol 1e-5")


class ArraySource:
    """An in-memory tiled source that refuses to materialize, and the frame
    its streamed tiles are pasted into."""

    def __init__(self, data: np.ndarray, tile: int) -> None:
        self.data = data
        self.shape = data.shape
        self.tile_size = (tile, tile)
        self.out = np.zeros_like(data)

    def infer_shape(self):
        return self.shape

    def read_region(self, box):
        left, top, right, bottom = box
        return self.data[top:bottom, left:right]

    def to_array(self):
        raise AssertionError("streaming source must not materialize")

    def paste(self, box, tile) -> None:
        left, top, right, bottom = box
        self.out[top:bottom, left:right] = tile


def phase_stream(ph: Phases, data: np.ndarray, tile: int, golden) -> None:
    from yamimageprocessor_tpu.models.stages import preprocess_steps
    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled

    src = ArraySource(data, tile)
    timed_call("stream_steps_tiled", stream_steps_tiled, preprocess_steps(), src, src.paste)
    dense = _chain_out("dense preprocess chain", preprocess_steps(), data)
    ph.check(
        "stream_steps_tiled",
        max_diff(src.out, dense) == 0 and max_diff(src.out, golden.get()) <= 1,
        f"{data.shape} tile {tile}: stream vs dense device maxdiff="
        f"{max_diff(src.out, dense)} (bit-exact); vs golden "
        f"maxdiff={max_diff(src.out, golden.get())} (<= 1 LSB)",
    )


def phase_parity(ph: Phases) -> None:
    from yamimageprocessor_tpu.services.parity import planned_total, run_parity_cases

    start = time.perf_counter()
    passed, total = run_parity_cases(report=lambda line: say("  " + line))
    say(f"  smoke timing parity audit: {time.perf_counter() - start:.1f} s")
    ph.check("parity audit", passed == total == planned_total(),
             f"{passed}/{total} (planned {planned_total()})")


def chip_tests(rehearse: bool) -> subprocess.Popen:
    """The ``chip``-marked tests in a child process that runs while this
    process stays off the card."""

    env = dict(os.environ)
    if not rehearse:
        env["JAX_PLATFORMS"] = "cuda"
    cmd = [
        sys.executable, "-m", "pytest", "-q", "-m", "chip", "-p", "no:cacheprovider",
        "-p", "no:xdist", "--durations=10", str(REPO / "tests" / "test_performance_budgets.py"),
    ]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main_path(ph: Phases, sz: dict, rehearse: bool) -> dict:
    import multiprocessing as mp

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    work = Path(tmp.name)
    os.environ.setdefault("YAM_SETTINGS_DIR", str(work / "state"))
    write_settings(work / "settings.json")

    cli_frame = scene(sz["cli"])
    np.save(work / "process_in.npy", cli_frame)
    nb, side = sz["batch"]
    (work / "batch_in").mkdir()
    batch_frames = [scene(side, seed=10 + k) for k in range(nb)]
    for k, f in enumerate(batch_frames):
        np.save(work / "batch_in" / f"frame{k}.npy", f)
    rng = np.random.default_rng(0)
    flagship = rng.integers(0, 256, (sz["flagship"][0],) + (sz["flagship"][1],) * 2, np.uint8)
    seg_frames = np.stack([scene(sz["seg_batch"][1], seed=3 + k) for k in range(sz["seg_batch"][0])])
    seg_one = seg_frames[0] if sz["seg"] == sz["seg_batch"][1] else scene(sz["seg"])
    seg_big = scene(sz["seg_big"])
    nc, sc = sz["clahe"]
    clahe = rng.integers(0, 256, (nc, sc, sc, 3), np.uint8)
    ne, se = sz["extract"]
    extract = [np.repeat(scene(se, seed=20 + k)[..., None], 3, axis=-1) for k in range(ne)]
    sside, stile = sz["stream"]
    stream = rng.integers(0, 256, (sside, sside), np.uint8)

    tests = chip_tests(rehearse)
    workers = 2 if rehearse else max(2, min(12, (os.cpu_count() or 4) - 2))
    pool = mp.get_context("spawn").Pool(workers, initializer=_golden_worker_init)
    settings = str(work / "settings.json")
    g_cli = pool.apply_async(golden_cli, (settings, "preprocessing,segmentation", cli_frame))
    g_seg_big = pool.apply_async(golden_chain, ("segmentation", seg_big))
    g_stream = pool.apply_async(golden_chain, ("preprocess", stream))
    g_seg = [pool.apply_async(golden_chain, ("segmentation", f)) for f in seg_frames]
    g_seg_one = g_seg[0] if seg_one is seg_frames[0] else pool.apply_async(
        golden_chain, ("segmentation", seg_one))
    g_batch = [pool.apply_async(golden_cli, (settings, "preprocessing", f)) for f in batch_frames]
    g_flag = [pool.apply_async(golden_chain, ("preprocess", f)) for f in flagship]
    g_clahe = [pool.apply_async(golden_chain, ("clahe", f)) for f in clahe]
    g_extract = [pool.apply_async(golden_regions, (f,)) for f in extract]
    pool.close()

    out, _ = tests.communicate()
    say(out.rstrip())
    summary = out.strip().splitlines()[-1] if out.strip() else ""
    ph.check("chip-marked tests", tests.returncode == 0 and (rehearse or "passed" in summary),
             f"rc={tests.returncode}: {summary}")

    from yamimageprocessor_tpu.utils.jaxcache import enable_persistent_cache

    device = device_header(rehearse)
    enable_persistent_cache()
    ph.run("cli process", phase_cli_process, work, g_cli)
    ph.run("cli batch", phase_cli_batch, work, g_batch)
    ph.run("flagship chain", phase_flagship, flagship, g_flag)
    ph.run("segmentation single", phase_segmentation, "otsu+open+close+watershed single",
           seg_one, [g_seg_one], 0)
    ph.run("segmentation batch", phase_segmentation, "otsu+open+close+watershed batch",
           seg_frames, g_seg, len(seg_frames))
    ph.run("segmentation big", phase_segmentation, "otsu+open+close+watershed big",
           seg_big, [g_seg_big], 0)
    ph.run("clahe chain", phase_clahe, clahe, g_clahe)
    ph.run("region_tables_device", phase_extraction, extract, g_extract, rehearse)
    ph.run("stream_steps_tiled", phase_stream, stream, stile, g_stream)
    pool.join()
    ph.run("parity audit", phase_parity)
    tmp.cleanup()
    return device


# ---------------------------------------------------------------------------
# mesh paths (four cards): each against the single-device dense path


def mesh_phases(ph: Phases, sz: dict, n_devices: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from yamimageprocessor_tpu.models.stages import (
        full_pipeline_steps,
        preprocess_steps,
        segmentation_steps,
    )
    from yamimageprocessor_tpu.ops import extraction_device as XD
    from yamimageprocessor_tpu.parallel.mesh import (
        batch_sharded_apply,
        make_mesh,
        spatial_sharded_apply,
    )
    from yamimageprocessor_tpu.parallel.tiling import stream_steps_tiled
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    mesh = make_mesh(n_devices)
    devices = list(mesh.devices.flat)
    one = jax.devices()[0]
    rng = np.random.default_rng(1)

    def dense(steps, x, batch=0):
        with jax.default_device(one):
            chain = get_compiled_chain(steps, x.shape, x.dtype, batch=batch)
            return np.asarray(chain.run_final(x, steps))

    def timed(name, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        say(f"  smoke timing {name}: {time.perf_counter() - start:.3f} s (compile included)")
        return out

    def spread(x):
        placed = jax.device_put(x, NamedSharding(mesh, P(mesh.axis_names[0])))
        return {s.device for s in placed.addressable_shards} == set(devices)

    n, side = sz["mesh_batch"]
    frames = rng.integers(0, 256, (n, side, side), np.uint8)

    def p_batch(ph):
        got = timed("batch_sharded_apply", batch_sharded_apply, preprocess_steps(), frames, mesh)
        want = dense(preprocess_steps(), frames, batch=n)
        ph.check("batch_sharded_apply", spread(frames) and max_diff(got, want) == 0,
                 f"{frames.shape} over {len(devices)} devices: bit-exact vs one device")

    def p_spatial(ph):
        frame = rng.integers(0, 256, (sz["mesh_spatial"],) * 2, np.uint8)
        got = timed("spatial_sharded_apply full pipeline", spatial_sharded_apply,
                    full_pipeline_steps(), frame, mesh)
        want = dense(full_pipeline_steps(), frame)
        ph.check("spatial_sharded_apply", spread(frame) and max_diff(got, want) == 0,
                 f"{frame.shape} full pipeline, ppermute halos + psum'd Otsu/hist-eq: "
                 f"maxdiff={max_diff(got, want)} (bit-exact)")

    def p_watershed(ph):
        frame = scene(sz["mesh_seg"])
        steps = segmentation_steps(watershed=True)
        got = timed("sharded watershed chain", spatial_sharded_apply, steps, frame, mesh)
        want = dense(steps, frame)
        ph.check("sharded watershed chain", max_diff(got, want) == 0,
                 f"{frame.shape}: maxdiff={max_diff(got, want)} (bit-exact)")

    def p_clahe(ph):
        frame = rng.integers(0, 256, (sz["mesh_clahe"],) * 2, np.uint8)
        steps = clahe_steps(8)[:2]
        got = timed("collective CLAHE", spatial_sharded_apply, steps, frame, mesh)
        want = dense(steps, frame)
        ph.check("collective CLAHE", max_diff(got, want) == 0,
                 f"{frame.shape}: psum'd grid histograms, maxdiff={max_diff(got, want)} (bit-exact)")

    def p_stream(ph):
        sside, tile = sz["mesh_stream"]
        src = ArraySource(rng.integers(0, 256, (sside, sside), np.uint8), tile)
        timed("mesh-sharded streaming", stream_steps_tiled, preprocess_steps(), src,
              src.paste, mesh=mesh)
        want = dense(preprocess_steps(), src.data)
        ph.check("mesh-sharded streaming", max_diff(src.out, want) == 0,
                 f"{src.shape} tile {tile}: maxdiff={max_diff(src.out, want)} (bit-exact)")

    def p_extract(ph):
        ne, se = sz["mesh_extract"]
        gray = np.stack([scene(se, seed=30 + k) for k in range(ne)])
        cap = XD.MID_REGIONS
        fn = XD._jitted_region_packed_batch(cap)
        sharded = jax.device_put(gray, NamedSharding(mesh, P(mesh.axis_names[0])))
        labels, bundles = timed("frame-parallel extraction", fn, sharded)
        with jax.default_device(one):
            labels1, bundles1 = fn(jnp.asarray(gray))
        bundles, bundles1 = np.asarray(bundles), np.asarray(bundles1)
        ok = spread(gray)
        for k in range(ne):
            a = XD._finalize_region_table(bundles[k], labels[k], cap)
            b = XD._finalize_region_table(bundles1[k], labels1[k], cap)
            ok = ok and not a.get("saturated") and a["meas"].count == b["meas"].count
            ok = ok and np.array_equal(a["meas"].area, b["meas"].area)
            ok = ok and np.array_equal(a["solidity"], b["solidity"])
            ok = ok and np.allclose(a["meas"].centroid_r[1:], b["meas"].centroid_r[1:], rtol=1e-5)
        ph.check("frame-parallel extraction", ok,
                 f"{gray.shape}: counts/areas/solidity exact, region centroids rtol "
                 f"1e-5 vs one device (bundles bit-identical: "
                 f"{np.array_equal(bundles, bundles1)})")

    for name, fn in (
        ("batch_sharded_apply", p_batch),
        ("spatial_sharded_apply", p_spatial),
        ("sharded watershed chain", p_watershed),
        ("collective CLAHE", p_clahe),
        ("mesh-sharded streaming", p_stream),
        ("frame-parallel extraction", p_extract),
    ):
        ph.run(name, fn)

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in devices]
    say(f"  peak bytes in use per device: {peaks}")
    if peaks[0]:
        ph.check("work spread over every device", min(peaks) >= 0.1 * peaks[0],
                 f"min/first peak = {min(peaks) / peaks[0]:.3f}")


# ---------------------------------------------------------------------------
# candidate plain forms, timed on the card


def _median_ms(fn, *args, reps: int = 7) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - start)
    return float(np.median(times) * 1e3)


def lut_sweep(img, lut):
    """Rejected form: 255 full-frame selects, one per table level."""

    import jax
    import jax.numpy as jnp

    x = img.astype(jnp.int32)
    init = jnp.broadcast_to(lut[0], x.shape).astype(lut.dtype)
    return jax.lax.fori_loop(
        1, 256, lambda k, acc: jnp.where(x == k, lut[k].astype(lut.dtype), acc), init
    )


def histogram_scatter_add(img):
    """Rejected form: one 256-bin scatter-add."""

    import jax.numpy as jnp

    return jnp.zeros((256,), jnp.int32).at[img.ravel().astype(jnp.int32)].add(1)


def clahe_sweep(gray, clip_limit: float, grid):
    """Rejected form: 256-step tile histograms and a 255-step select blend."""

    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import clahe as CL

    gh, gw = grid
    h, w = gray.shape
    th, tw = h // gh, w // gw
    tiles = gray.reshape(gh, th, gw, tw).astype(jnp.int32)
    hist = jax.lax.map(lambda k: (tiles == k).sum(axis=(1, 3)), jnp.arange(256))
    luts = CL._clip_and_lut_j(jnp.moveaxis(hist, 0, -1), clip_limit, th * tw)
    (y0, y1, fy), (x0, x1, fx) = CL._interp_weights(h, w, grid)
    fy2 = jnp.asarray(fy, jnp.float32)[:, None]
    fx2 = jnp.asarray(fx, jnp.float32)[None, :]
    w00, w01 = (1 - fy2) * (1 - fx2), (1 - fy2) * fx2
    w10, w11 = fy2 * (1 - fx2), fy2 * fx2
    vals = gray.astype(jnp.int32)

    def upsample(t):
        return (w00 * t[y0][:, x0] + w01 * t[y0][:, x1]
                + w10 * t[y1][:, x0] + w11 * t[y1][:, x1])

    out = jax.lax.fori_loop(
        1, 256, lambda k, acc: jnp.where(vals == k, upsample(luts[:, :, k]), acc),
        upsample(luts[:, :, 0]),
    )
    return jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)


def watershed_inputs(img):
    """The flood's, CC's and chamfer's operands as ``watershed_seg_j``
    builds them from the segmentation chain's pre-watershed mask."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import color as C
    from yamimageprocessor_tpu.ops import distance as DI
    from yamimageprocessor_tpu.ops import morphology as M
    from yamimageprocessor_tpu.ops import threshold as T
    from yamimageprocessor_tpu.ops.labeling import label_j

    gray = C.bgr_to_gray_j(img)
    thresh = T.binary_j(gray, T.otsu_threshold_j(gray), inverse=True)
    se = np.ones((3, 3), np.uint8)
    opening = M.open_j(thresh, se, 2)
    sure_bg = M.dilate_j(opening, se, 3)
    dist = DI.distance_transform_j(opening)
    fg = dist > jnp.float32(0.7) * dist.max()
    unknown = sure_bg.astype(jnp.int16) - jnp.where(fg, 255, 0) > 0
    markers = jnp.where(unknown, 0, label_j(fg) + 1)
    return opening, fg, markers


def compare_forms(ph: Phases, sz: dict) -> None:
    import jax
    import jax.numpy as jnp

    from yamimageprocessor_tpu.models.stages import segmentation_steps
    from yamimageprocessor_tpu.ops import clahe as CL
    from yamimageprocessor_tpu.ops import labeling as LB
    from yamimageprocessor_tpu.ops import watershed as W
    from yamimageprocessor_tpu.ops.distance import distance_transform_j
    from yamimageprocessor_tpu.ops.lutops import apply_lut_j, histogram256_j
    from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

    rows = []
    rng = np.random.default_rng(4)
    small, big = sz["forms"]
    nb = sz["forms_batch"]
    frames = jax.device_put(rng.integers(0, 256, (nb, small, small), np.uint8))
    one = frames[0]
    lut = jnp.asarray(rng.integers(0, 256, 256), jnp.uint8)

    def row(op, shape, form, fn, *args, **extra):
        ms = _median_ms(jax.jit(fn), *args)
        rows.append(dict(op=op, shape=shape, form=form, ms=round(ms, 4), **extra))
        say(f"  form {op} {shape} {form}: {ms:.4f} ms (median of 7) {extra or ''}")

    same = bool((apply_lut_j(frames, lut) == lut_sweep(frames, lut)).all())
    row("lut", f"{nb}x{small}^2", "gather", apply_lut_j, frames, lut)
    row("lut", f"{nb}x{small}^2", "256-select sweep", lut_sweep, frames, lut)
    same &= bool((jax.vmap(histogram256_j)(frames) == jax.vmap(histogram_scatter_add)(frames)).all())
    row("histogram", f"{nb}x{small}^2", "compare-sum", jax.vmap(histogram256_j), frames)
    row("histogram", f"{nb}x{small}^2", "scatter-add", jax.vmap(histogram_scatter_add), frames)
    half = one[: small // 2, : small // 2]
    row("histogram", f"{small // 2}^2", "compare-sum", histogram256_j, half)
    row("histogram", f"{small // 2}^2", "scatter-add", histogram_scatter_add, half)
    nc, sc = sz["forms_clahe"]
    cframes = jax.device_put(rng.integers(0, 256, (nc, sc, sc), np.uint8))

    def gather(x):
        return jax.vmap(lambda f: CL.clahe_j(f, clip_limit=2.0, grid=(4, 4)))(x)

    def sweep(x):
        return jax.vmap(lambda f: clahe_sweep(f, 2.0, (4, 4)))(x)

    same &= bool((gather(cframes) == sweep(cframes)).all())
    row("clahe", f"{nc}x{sc}^2", "scatter-add + gather blend", gather, cframes)
    row("clahe", f"{nc}x{sc}^2", "level sweep + select blend", sweep, cframes)
    ph.check("candidate forms agree", same, "lut, histogram and clahe forms bit-identical")

    pre = segmentation_steps(watershed=True)[:-1]
    for side in (small, big):
        frame = scene(side)
        chain = get_compiled_chain(pre, frame.shape, frame.dtype)
        mask = jnp.asarray(chain.run_final(frame, pre))
        opening, fg, markers = jax.jit(watershed_inputs)(mask)
        rounds = int(jax.jit(lambda f: LB._label_solve(f)[1])(fg))
        sweeps = int(jax.jit(lambda i, m: W._flood(i, m)[1])(mask, markers))
        row("chamfer row scan", f"{side}^2", "lax.scan", distance_transform_j, opening,
            scan_steps=2 * side)
        row("cc labeling", f"{side}^2", "doubling-scan while_loop", LB.label_j, fg,
            rounds=rounds)
        row("watershed flood", f"{side}^2", "level-synchronous while_loop", W.watershed_j,
            mask, markers, sweeps=sweeps)
    out = REPO / "chiprun_out" / "compare_forms.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    say(f"  wrote {out}")


# ---------------------------------------------------------------------------


def device_header(rehearse: bool):
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    say(f"jax {jax.__version__}, device_kind {dev.device_kind!r}, devices {device['count']}")
    if not rehearse and dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {device}")
    return device


def probe_platform() -> str:
    """The platform JAX picks, asked in a child that exits before this
    process opens the card."""

    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True,
    )
    return probe.stdout.strip() if probe.returncode == 0 else probe.stderr.strip()[-500:]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true")
    parser.add_argument("--compare-forms", action="store_true")
    parser.add_argument("--rehearse", action="store_true")
    args = parser.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import yamimageprocessor_tpu  # noqa: F401 — fails outside the repo

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
            ).strip()
    else:
        platform = probe_platform()
        if platform != "gpu":
            say(f"chip_smoke.py needs a GPU; JAX found: {platform}")
            return 1
    say(card_line())  # name, power limit
    sz = TINY if args.rehearse else FULL
    ph = Phases()
    start = time.perf_counter()

    if args.four_cards or args.compare_forms:
        from yamimageprocessor_tpu.utils.jaxcache import enable_persistent_cache

        device = device_header(args.rehearse)
        enable_persistent_cache()
        if args.four_cards:
            if device["count"] < 4:
                raise SystemExit(f"--four-cards needs 4 devices; JAX found {device}")
            mesh_phases(ph, sz)
            device["count"] = 4
        else:
            compare_forms(ph, sz)
    else:
        device = main_path(ph, sz, args.rehearse)
        if args.rehearse:
            say("-- rehearsal: four-card phases on virtual CPU devices")
            mesh_phases(ph, sz)
            say("-- rehearsal: candidate forms")
            compare_forms(ph, sz)

    say(f"phases failed: {ph.failed or 'none'}; {time.perf_counter() - start:.1f} s in all")
    if ph.failed or args.rehearse:
        return 1 if ph.failed else 0
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
