"""Chunked device→host transfers.

Fetches of large results are split into flat ≤``CHUNK_BYTES`` slices whose
copies are all started before any is awaited.  The chunk size and the
streaming engine's batch/in-flight knobs keep their historical defaults
until a measurement of the PCIe link justifies others (ROADMAP §1.7).

The reference never needed this: its arrays live in host memory
(``processing/pipeline_cache.py`` passes numpy buffers between steps).
"""
from __future__ import annotations

from typing import Any, List

import numpy as np

def _env_bytes(name: str, default: int) -> int:
    import os

    try:
        return max(1 << 16, int(os.environ.get(name, default)))
    except ValueError:
        return default


#: transfer granularity of a chunked fetch; override with
#: YAM_FETCH_CHUNK_BYTES.
CHUNK_BYTES = _env_bytes("YAM_FETCH_CHUNK_BYTES", 4 << 20)


class FetchHandle:
    """An in-flight chunked D2H fetch (start early, finish at drain)."""

    __slots__ = ("chunks", "shape", "dtype")

    def __init__(self, chunks: List[Any], shape, dtype) -> None:
        self.chunks = chunks
        self.shape = shape
        self.dtype = dtype


def start_fetch(dev: Any, chunk_bytes: int | None = None) -> FetchHandle:
    """Begin an async device→host copy of ``dev`` in ≤``chunk_bytes``
    flat slices (default :data:`CHUNK_BYTES`).  Returns a handle for :func:`finish_fetch`."""

    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES
    nbytes = int(getattr(dev, "nbytes", 0))
    if isinstance(dev, np.ndarray) or nbytes <= chunk_bytes:
        _copy_async(dev)
        return FetchHandle([dev], dev.shape, dev.dtype)
    flat = dev.reshape(-1)
    per = max(1, chunk_bytes // max(int(dev.dtype.itemsize), 1))
    chunks = [flat[i : i + per] for i in range(0, flat.shape[0], per)]
    for chunk in chunks:
        _copy_async(chunk)
    return FetchHandle(chunks, dev.shape, dev.dtype)


def finish_fetch(handle: FetchHandle) -> np.ndarray:
    """Block until every chunk has landed; returns the assembled array."""

    if len(handle.chunks) == 1:
        return np.asarray(handle.chunks[0])
    flat = np.concatenate([np.asarray(c) for c in handle.chunks])
    return flat.reshape(handle.shape)


def fetch(dev: Any, chunk_bytes: int | None = None) -> np.ndarray:
    """Synchronous chunked fetch (start + finish)."""

    return finish_fetch(start_fetch(dev, chunk_bytes))


def _copy_async(dev: Any) -> None:
    try:
        dev.copy_to_host_async()
    except Exception:  # pragma: no cover - backend-dependent
        pass


__all__ = [
    "CHUNK_BYTES",
    "FetchHandle",
    "start_fetch",
    "finish_fetch",
    "fetch",
]
