"""Accelerator executor for ``requires_gpu`` steps.

The reference defines a ``GpuExecutor`` protocol with CPU fallback
(``processing/pipeline_manager.py:69-73,448-465``) but ships no real
executor; this is the device implementation: a step marked as requiring an
accelerator executes its registered device function through the fused-chain
compiler (single-step chain, compiled once per signature).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

LOGGER = logging.getLogger(__name__)


class DeviceExecutor:
    """Executes individual steps on the JAX device."""

    def __init__(self, *, strict: bool = False) -> None:
        self._strict = strict

    def execute(self, step, image: np.ndarray) -> Optional[np.ndarray]:
        if not step.is_device_capable():
            if self._strict:
                raise RuntimeError(
                    f"Step '{step.name}' has no device implementation"
                )
            return None  # manager falls back to the host path
        from yamimageprocessor_tpu.pipeline.compiler import get_compiled_chain

        clone = step.clone()
        clone.enabled = True
        clone.execution.requires_gpu = False
        chain = get_compiled_chain([clone], image.shape, image.dtype)
        return chain.run_final(np.asarray(image), [clone])


__all__ = ["DeviceExecutor"]
