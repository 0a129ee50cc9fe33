"""Profiling / tracing hooks (SURVEY §5 tracing obligation).

The reference has no profiler; this build adds ``jax.profiler`` trace
capture plus lightweight per-stage wall timing surfaced through the same
task/diagnostics stream.
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List

LOGGER = logging.getLogger(__name__)


@dataclass
class StageTiming:
    name: str
    seconds: float


@dataclass
class PipelineTrace:
    """Accumulated per-stage timings for one pipeline run."""

    timings: List[StageTiming] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.timings.append(StageTiming(name, time.perf_counter() - start))

    def summary(self) -> Dict[str, float]:
        return {t.name: round(t.seconds, 6) for t in self.timings}

    def total(self) -> float:
        return sum(t.seconds for t in self.timings)


@contextlib.contextmanager
def device_trace(log_dir: Path | str) -> Iterator[None]:
    """Capture a ``jax.profiler`` trace (viewable in TensorBoard/Perfetto)."""

    import jax

    log_dir = str(log_dir)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        LOGGER.info("device trace written to %s", log_dir)


def annotate(name: str):
    """Named region inside a device trace (TraceAnnotation)."""

    import jax

    return jax.profiler.TraceAnnotation(name)


__all__ = ["PipelineTrace", "StageTiming", "device_trace", "annotate"]
