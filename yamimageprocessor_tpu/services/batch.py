"""Batch (folder) processing — the throughput path.

Parity with the mass flows (``ui/preprocessing.py:2057-2159``,
``ui/segmentation.py:956-988``, ``ui/extraction.py:1676-1814``): enumerate
supported files in a folder, run the pipeline on each, save with
stage/mode/source-index metadata plus the pipeline dict and settings
snapshot, report progress, honour cooperative cancel.

Device redesign: same-shape frames are grouped and executed as fused device
BATCHES (vmap over the leading axis, optionally sharded over a mesh)
instead of one host pass per file — the chain compiles once per shape
group and every chip cycle processes multiple frames.
"""
from __future__ import annotations

import logging
import threading
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from yamimageprocessor_tpu.core.threading import OperationCancelled
from yamimageprocessor_tpu.pipeline.step import PipelineStep

LOGGER = logging.getLogger(__name__)

SUPPORTED_FORMATS = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp", ".npy")


def enumerate_images(folder: Path) -> List[Path]:
    folder = Path(folder)
    return sorted(
        p
        for p in folder.iterdir()
        if p.suffix.lower() in SUPPORTED_FORMATS and p.is_file()
    )


def _load_dense(path: Path) -> np.ndarray:
    from yamimageprocessor_tpu.io import image_io

    record = image_io.load_image(path, lazy=False)
    return np.asarray(record.to_array())


def process_folder(
    input_folder: Path,
    output_folder: Path,
    steps: Sequence[PipelineStep],
    *,
    io_manager=None,
    settings_snapshot: Optional[Dict[str, Any]] = None,
    stage: str = "preprocessing",
    output_suffix: str = ".png",
    progress: Optional[Callable[[int], None]] = None,
    cancel_event: Optional[threading.Event] = None,
    batch_size: int = 8,
    mesh=None,
) -> List[Path]:
    """Run ``steps`` over every image in ``input_folder``.

    Same-shape frames are batched through one fused executable; shapes that
    appear once fall back to single-frame execution.  Returns output paths.
    """

    from yamimageprocessor_tpu.pipeline.manager import PipelineManager

    files = enumerate_images(input_folder)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    manager = PipelineManager(steps)
    pipeline_dict = manager.to_dict()
    total = max(len(files), 1)
    outputs: List[Path] = []
    done = 0

    def check_cancel() -> None:
        if cancel_event is not None and cancel_event.is_set():
            raise OperationCancelled()

    def save_one(src: Path, index: int, image: np.ndarray) -> None:
        nonlocal done
        metadata = {
            "stage": stage,
            "mode": "batch",
            "source_index": index,
            "source": src.name,
            "pipeline": pipeline_dict,
        }
        if settings_snapshot is not None:
            metadata["settings"] = settings_snapshot
        target = output_folder / (src.stem + output_suffix)
        if io_manager is not None:
            io_manager.save_image(target, image, metadata=metadata)
        else:
            from yamimageprocessor_tpu.io import image_io

            image_io.save_image(target, image, metadata=metadata)
        outputs.append(target)
        done += 1
        if progress is not None:
            progress(int(done * 100 / total))

    # group by header-probed (shape, dtype): loading the whole folder up
    # front would make peak RSS proportional to the folder size; pixels
    # are read lazily, at most one batch chunk at a time
    groups: Dict[Tuple, List[Tuple[int, Path]]] = defaultdict(list)
    for index, path in enumerate(files):
        check_cancel()
        try:
            key = _probe_shape(path)
        except Exception:
            LOGGER.exception("Failed to probe %s", path)
            continue
        groups[key].append((index, path))

    enabled = [s for s in steps if s.enabled]
    batchable = bool(enabled) and all(s.is_device_capable() for s in enabled)

    def run_single(index: int, path: Path, array: np.ndarray) -> None:
        save_one(path, index, np.asarray(manager.apply(array)))

    for (shape, dtype), items in groups.items():
        check_cancel()
        for offset in range(0, len(items), batch_size):
            check_cancel()
            loaded: List[Tuple[int, Path, np.ndarray]] = []
            for index, path in items[offset : offset + batch_size]:
                try:
                    loaded.append((index, path, _load_dense(path)))
                except Exception:
                    LOGGER.exception("Failed to load %s", path)
            # header probes can mispredict (palette promotion etc.):
            # frames whose true shape diverges run per-frame
            matching = [e for e in loaded if e[2].shape == tuple(shape)]
            stragglers = [e for e in loaded if e[2].shape != tuple(shape)]
            if batchable and len(matching) > 1:
                chunk = matching
                stack = np.stack([arr for _, _, arr in chunk])
                try:
                    if mesh is not None:
                        from yamimageprocessor_tpu.parallel.mesh import (
                            batch_sharded_apply,
                        )

                        result = batch_sharded_apply(enabled, stack, mesh)
                    else:
                        from yamimageprocessor_tpu.pipeline.compiler import (
                            get_compiled_chain,
                        )

                        chain = get_compiled_chain(
                            enabled, stack.shape, stack.dtype, batch=len(chunk)
                        )
                        result = np.asarray(chain.run(stack, enabled)[-1])
                except Exception:
                    LOGGER.exception("Batched execution failed; per-frame fallback")
                    result = np.stack(
                        [np.asarray(manager.apply(arr)) for _, _, arr in chunk]
                    )
                for (index, path, _), out in zip(chunk, result):
                    save_one(path, index, np.asarray(out))
            else:
                for index, path, array in matching:
                    check_cancel()
                    run_single(index, path, array)
            for index, path, array in stragglers:
                check_cancel()
                run_single(index, path, array)
    return outputs


def _probe_shape(path: Path) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype) of the array :func:`_load_dense` would produce, read
    from file headers only (no pixel decode)."""

    suffix = path.suffix.lower()
    if suffix == ".npy":
        header = np.load(path, mmap_mode="r")  # maps the file, reads no pixels
        return tuple(header.shape), str(header.dtype)
    from PIL import Image

    with Image.open(path) as img:
        width, height = img.size
        mode = img.mode
    if mode in ("L", "I;16", "1"):
        return (height, width), "uint8" if mode != "I;16" else "uint16"
    if mode in ("RGBA", "CMYK"):
        return (height, width, 4), "uint8"
    # palette / RGB / YCbCr all decode to 3 channels
    return (height, width, 3), "uint8"


def export_all_extraction_data(
    image: np.ndarray,
    steps: Sequence[PipelineStep],
    output_folder: Path,
    *,
    base_name: str = "extraction",
    sanitize_names: bool = False,
) -> List[Path]:
    """One CSV per enabled extraction method.

    File layout matches the reference verbatim
    (``ui/extraction.py:1858-1859``): ``<base>_<method>.csv`` with the
    method name exactly as registered, including spaces — e.g.
    ``extraction_Region Properties.csv``.  Pass ``sanitize_names=True``
    for a filesystem-conservative ``<base>_<method_lower_underscored>.csv``
    variant instead.
    """

    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    written: List[Path] = []
    for step in steps:
        if not step.enabled:
            continue
        impl = step.impl
        if impl is None or impl.data_fn is None:
            continue
        frame = impl.data_fn(image, **step.params)
        method = impl.schema.method
        if sanitize_names:
            method = method.replace("/", "_").replace(" ", "_").lower()
        target = output_folder / f"{base_name}_{method}.csv"
        frame.to_csv(target, index=False)
        written.append(target)
    return written


def mass_export_data(
    input_folder: Path,
    output_folder: Path,
    steps: Sequence[PipelineStep],
    *,
    progress: Optional[Callable[[int], None]] = None,
    cancel_event: Optional[threading.Event] = None,
) -> Dict[str, List[Path]]:
    """Per-file extraction CSV export over a folder
    (``ui/extraction.py:1676-1814`` mass_export_data flow)."""

    files = enumerate_images(input_folder)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    written: Dict[str, List[Path]] = {}
    total = max(len(files), 1)
    for index, path in enumerate(files):
        if cancel_event is not None and cancel_event.is_set():
            raise OperationCancelled()
        try:
            image = _load_dense(path)
        except Exception:
            LOGGER.exception("Failed to load %s", path)
            continue
        written[path.name] = export_all_extraction_data(
            image, steps, output_folder, base_name=path.stem
        )
        if progress is not None:
            progress(int((index + 1) * 100 / total))
    return written


__all__ = [
    "SUPPORTED_FORMATS",
    "enumerate_images",
    "process_folder",
    "export_all_extraction_data",
    "mass_export_data",
]
