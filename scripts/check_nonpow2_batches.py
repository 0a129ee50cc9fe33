#!/usr/bin/env python
"""Regression check: vmapped extraction bundle at every batch size 1..8.

The mass-extraction path stacks frames into one dispatch of the batched
bundle (``extraction_device.region_packed_j``) at whatever batch size the
folder yields, with no padding to powers of two.  This script runs that
production bundle at every batch size with busy label content and verifies
features against the host golden — if a backend upgrade ever introduces a
batch-dimension fault, this is the first thing to re-run.

Each batch size compiles its own program, so the sweep prints one line per
size as it goes.

Usage (on whatever backend JAX selects; ``JAX_PLATFORMS=cpu`` forces the
CPU):
    python scripts/check_nonpow2_batches.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yamimageprocessor_tpu.ops import extraction_device as XD  # noqa: E402
from yamimageprocessor_tpu.ops import labeling, regionprops as RP  # noqa: E402

SIDE = 1024


def busy_frame(seed: int) -> np.ndarray:
    """A dense multi-cell grayscale frame like the bench's extraction scene."""
    rng = np.random.default_rng(seed)
    frame = np.zeros((SIDE, SIDE), np.uint8)
    for _ in range(48):
        cy, cx = rng.integers(40, SIDE - 40, size=2)
        r = int(rng.integers(12, 36))
        yy, xx = np.ogrid[:SIDE, :SIDE]
        frame[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 255
    return frame


def run_sweep(batch_sizes=(1, 2, 4, 8, 3, 5, 6, 7), verbose: bool = True) -> None:
    """Run the production batched bundle at each batch size and assert
    bit-exact solidity/count vs the host golden.  Importable so the chip
    test tier runs the same sweep the script does
    (tests/test_performance_budgets.py::test_chip_nonpow2_batch_sweep)."""

    frames = [busy_frame(s) for s in range(max(batch_sizes))]
    goldens = []
    for f in frames:
        labels = labeling.label_np(f > 0)
        meas = RP.measure_np(labels)
        goldens.append((meas, RP.solidity_np(labels, meas)))

    fn = XD._jitted_region_packed_batch(XD.FAST_REGIONS)
    for b in batch_sizes:  # pow2 first: prove content is fine
        stack = jnp.asarray(np.stack(frames[:b]))
        labels_b, bundles_b = fn(stack)
        bundles = np.asarray(bundles_b)  # forces execution + D2H
        for k in range(b):
            table = XD._finalize_region_table(
                bundles[k], labels_b[k], XD.FAST_REGIONS
            )
            meas, sol = goldens[k]
            assert not table.get("saturated"), f"batch={b} frame={k} saturated"
            assert table["meas"].count == meas.count, f"batch={b} frame={k}"
            np.testing.assert_array_equal(table["solidity"], sol)
        # flush per size: if the worker dies mid-sweep, the log must show
        # which batch size was in flight
        if verbose:
            print(f"batch={b}: OK  regions={goldens[0][0].count}", flush=True)


def main() -> None:
    from yamimageprocessor_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()  # no-op on the CPU backend
    print(
        f"backend={jax.default_backend()}  devices={len(jax.devices())}",
        flush=True,
    )
    run_sweep()
    print(
        "all batch sizes survived with bit-exact solidity — no padding needed",
        flush=True,
    )


if __name__ == "__main__":
    main()
