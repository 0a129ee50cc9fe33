"""Headless command-line interface.

The launcher-equivalent entry point (``segmentation25.py`` ->
``core/application_launcher.py:153-266`` without Qt): bootstraps an AppCore,
builds stage pipelines from the persisted settings namespace, and exposes
the batch/export flows.

Commands
--------
  info                         backend + registered ops/modules
  process  IN OUT              run configured stages on one image
  batch    IN_DIR OUT_DIR      mass-process a folder (fused device batches)
  extract  IN OUT_DIR          export extraction CSVs for one image
  settings export/import PATH  settings JSON round-trip
  bench                        one-line throughput probe
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np


def _build_core(args) -> "AppCore":
    from yamimageprocessor_tpu.core.app_core import AppConfiguration, AppCore

    roots = [Path.cwd()]
    for candidate in (getattr(args, "input", None), getattr(args, "output", None)):
        if candidate:
            roots.append(Path(candidate).expanduser().resolve().parent)
    cfg = AppConfiguration(
        allowed_roots=tuple(roots),
        diagnostics=bool(getattr(args, "diagnostics", False)),
        settings_path=(
            Path(args.settings).expanduser() if getattr(args, "settings", None) else None
        ),
    )
    return AppCore(cfg).ensure_bootstrapped()


def _stage_steps(core, stages: List[str]):
    from yamimageprocessor_tpu.pipeline.builders import (
        build_extraction_pipeline_from_dict,
        build_preprocessing_pipeline_from_dict,
        build_segmentation_pipeline_from_dict,
    )

    snapshot = core.settings.snapshot()
    steps = []
    if "preprocessing" in stages:
        steps += list(build_preprocessing_pipeline_from_dict(snapshot).steps)
    if "segmentation" in stages:
        steps += list(build_segmentation_pipeline_from_dict(snapshot).steps)
    if "extraction" in stages:
        steps += list(build_extraction_pipeline_from_dict(snapshot).steps)
    return steps


def cmd_info(args) -> int:
    import jax

    from yamimageprocessor_tpu.ops.registry import all_impls

    core = _build_core(args)
    impls = all_impls()
    print(f"backend: {jax.default_backend()}  devices: {len(jax.devices())}")
    print(f"registered ops: {len(impls)}")
    for stage in ("preprocessing", "segmentation", "extraction"):
        names = sorted(i for i in impls if i.startswith(stage))
        print(f"  {stage}: {len(names)}")
    print(f"modules: {[m.metadata.identifier for m in core.modules()]}")
    core.shutdown()
    return 0


def cmd_process(args) -> int:
    core = _build_core(args)
    try:
        record = core.io_manager.load_image(Path(args.input).expanduser(), lazy=False)
        image = np.asarray(record.to_array())
        steps = _stage_steps(core, args.stages.split(","))
        if not steps:
            print("no enabled steps — check settings order keys", file=sys.stderr)
            return 2
        from yamimageprocessor_tpu.pipeline.manager import PipelineManager

        manager = PipelineManager(steps)
        result = np.asarray(manager.apply(image))
        core.io_manager.save_image(
            Path(args.output).expanduser(),
            result,
            metadata={"pipeline": manager.to_dict()},
        )
        print(f"wrote {args.output}  shape={result.shape} dtype={result.dtype}")
        return 0
    finally:
        core.shutdown()


def cmd_batch(args) -> int:
    core = _build_core(args)
    try:
        from yamimageprocessor_tpu.services.batch import process_folder

        steps = _stage_steps(core, args.stages.split(","))
        outputs = process_folder(
            Path(args.input).expanduser(),
            Path(args.output).expanduser(),
            steps,
            io_manager=core.io_manager,
            settings_snapshot=core.settings.snapshot(prefix="preprocess/"),
            progress=lambda pct: print(f"\r{pct:3d}%", end="", flush=True),
            batch_size=args.batch_size,
            output_suffix=args.suffix,
        )
        print(f"\nprocessed {len(outputs)} files -> {args.output}")
        return 0
    finally:
        core.shutdown()


def cmd_extract(args) -> int:
    core = _build_core(args)
    try:
        from yamimageprocessor_tpu.services.batch import export_all_extraction_data

        record = core.io_manager.load_image(Path(args.input).expanduser(), lazy=False)
        steps = _stage_steps(core, ["extraction"])
        if not steps:
            print("no extraction methods in extraction/order", file=sys.stderr)
            return 2
        written = export_all_extraction_data(
            np.asarray(record.to_array()),
            steps,
            Path(args.output).expanduser(),
            base_name=Path(args.input).stem,
        )
        for path in written:
            print(f"wrote {path}")
        return 0
    finally:
        core.shutdown()


def cmd_settings(args) -> int:
    core = _build_core(args)
    try:
        if args.action == "export":
            core.settings.export_json(Path(args.path).expanduser())
            print(f"exported settings -> {args.path}")
        else:
            core.settings.import_json(Path(args.path).expanduser())
            print(f"imported settings <- {args.path}")
        return 0
    finally:
        core.shutdown()


def cmd_bench(args) -> int:
    import bench  # repo-root bench module

    bench.main()
    return 0


def cmd_launch(args) -> int:
    """Entry layer (``segmentation25.py`` / ``core/application_launcher.py``):
    bootstrap the shell session from the persisted stage selection and
    report what came up."""

    from yamimageprocessor_tpu.core.launcher import (
        default_stage_specifications,
        launch_stage_applications,
    )
    from yamimageprocessor_tpu.ops.schema import Stage
    from yamimageprocessor_tpu.ui.startup import StartupSelection

    def selection(core, specs):
        if args.stages:
            stages = []
            for tok in args.stages.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                try:
                    stages.append(Stage(tok))
                except ValueError:
                    valid = ", ".join(s.value for s in Stage)
                    raise SystemExit(
                        f"error: unknown stage '{tok}' (choose from: {valid})"
                    )
            return StartupSelection(
                stages=stages, diagnostics=bool(args.diagnostics)
            )
        return StartupSelection.load(core.settings)

    def run(session) -> int:
        if getattr(args, "interactive", False):
            from yamimageprocessor_tpu.ui.shell import run_shell

            return run_shell(session)
        for stage, pane in session.panes.items():
            print(f"stage ready: {stage.value} ({type(pane).__name__})")
        for message in session.status_messages:
            print(message)
        return 0

    from yamimageprocessor_tpu.core.app_core import AppConfiguration

    def configuration():
        return AppConfiguration(
            allowed_roots=(Path.cwd(),),
            diagnostics=bool(args.diagnostics),
            settings_path=(
                Path(args.settings).expanduser() if args.settings else None
            ),
        )

    return launch_stage_applications(
        default_stage_specifications(),
        configuration_factory=configuration,
        selection_provider=selection,
        run=run,
        initial_diagnostics=bool(args.diagnostics),
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="yamtpu", description="microscopy image processing on JAX"
    )
    parser.add_argument("--settings", help="settings JSON store path")
    parser.add_argument(
        "--diagnostics", action="store_true", help="verbose console logging"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("info").set_defaults(fn=cmd_info)

    p = sub.add_parser("process")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "--stages", default="preprocessing,segmentation", help="comma list"
    )
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("batch")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--stages", default="preprocessing")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument(
        "--suffix", default=".png", help="output format suffix (.png, .npy, ...)"
    )
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("extract")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("settings")
    p.add_argument("action", choices=["export", "import"])
    p.add_argument("path")
    p.set_defaults(fn=cmd_settings)

    sub.add_parser("bench").set_defaults(fn=cmd_bench)

    p = sub.add_parser("launch", help="bootstrap the stage shell session")
    p.add_argument(
        "--stages",
        default=None,
        help="comma list overriding the persisted startup selection",
    )
    p.add_argument(
        "--interactive",
        action="store_true",
        help="host the session in the terminal shell (tabbed panes, "
        "status bar, diagnostics dock)",
    )
    p.set_defaults(fn=cmd_launch)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        # the persistent cache pays each chain's GPU compile once per cache
        # directory, so every CLI process after the first starts warm
        # (no-op on the CPU backend).
        from yamimageprocessor_tpu.utils.jaxcache import enable_persistent_cache

        enable_persistent_cache()
    except Exception:  # noqa: BLE001 — jax-free host installs still work
        pass
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
