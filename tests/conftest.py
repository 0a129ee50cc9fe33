"""Test harness configuration.

Tests run against the JAX CPU backend with a virtual 8-device mesh so the
multi-device sharding paths compile and execute without accelerator
hardware.  This mirrors the reference suite's fake-backend strategy
(/root/reference/tests/conftest.py:13-37 injects the repo root and gates
performance tests behind ``--run-performance``).

Tests marked ``chip`` need a GPU and skip on the CPU harness; run them on
the card with ``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

# Must happen before any jax import: the CPU harness unless the caller
# named a platform.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import pytest


def _configure_jax() -> None:
    """Persistent compilation cache: ``JAX_COMPILATION_CACHE_DIR`` if set,
    else ``<repo>/.jax_cache`` (the package's own rule)."""

    import jax

    from yamimageprocessor_tpu.utils.jaxcache import cache_dir_for

    cache_dir = Path(cache_dir_for())
    cache_dir.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_configure_jax()


def pytest_addoption(parser: pytest.Parser) -> None:
    parser.addoption(
        "--run-performance",
        action="store_true",
        default=False,
        help="run tests marked as performance budgets",
    )


def pytest_collection_modifyitems(config: pytest.Config, items) -> None:
    if config.getoption("--run-performance"):
        return
    skip_perf = pytest.mark.skip(reason="needs --run-performance option")
    for item in items:
        if "performance" in item.keywords:
            item.add_marker(skip_perf)


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip ``chip``-marked tests unless JAX runs on a GPU (decided per
    test, so every worker collects the same tests)."""

    if request.node.get_closest_marker("chip") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m chip tests/"
        )


@pytest.fixture()
def rng():
    import numpy as np

    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _isolated_settings_dir(tmp_path_factory, monkeypatch):
    """Default-config AppCore now persists settings/recovery under the
    user state dir; tests must never touch the real one."""

    monkeypatch.setenv(
        "YAM_SETTINGS_DIR", str(tmp_path_factory.mktemp("yam-state"))
    )
