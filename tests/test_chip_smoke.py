"""``chip_smoke.py`` refuses to run without a GPU, and its rehearsal runs
every phase (main path, parity audit, four-card mesh paths on virtual
devices, candidate forms) at tiny sizes on the CPU."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(*args: str, timeout: int):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


def _ok_lines(stdout: str):
    lines = []
    for line in stdout.splitlines():
        try:
            payload = json.loads(line)
        except ValueError:
            continue
        if isinstance(payload, dict) and "ok" in payload:
            lines.append(payload)
    return lines


def test_chip_smoke_exits_nonzero_on_cpu():
    proc = _run(timeout=300)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stdout
    assert not _ok_lines(proc.stdout)


def test_chip_smoke_rehearse_runs_every_phase():
    proc = _run("--rehearse", timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    out = proc.stdout
    for phase in (
        "chip-marked tests", "cli process", "cli batch", "flagship chain",
        "otsu+open+close+watershed single", "otsu+open+close+watershed batch",
        "otsu+open+close+watershed big", "gaussian+clahe+channel-mix",
        "region_tables_device", "stream_steps_tiled", "parity audit",
        "batch_sharded_apply", "spatial_sharded_apply", "sharded watershed chain",
        "collective CLAHE", "mesh-sharded streaming", "frame-parallel extraction",
        "candidate forms agree",
    ):
        assert f"PASS {phase}:" in out, phase
    assert "FAIL" not in out
    assert not _ok_lines(out)
