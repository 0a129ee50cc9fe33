"""One form per op on every backend, and what the backend still decides.

The LUT, histogram and CLAHE device paths trace to the same program
whatever ``jax.default_backend()`` says; only whether an accelerator
exists at all routes extraction (device tables off the CPU, the host
golden on it).  The compile cache honours ``JAX_COMPILATION_CACHE_DIR``.
"""
from __future__ import annotations

import numpy as np
import pytest


def _lut(x):
    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops.lutops import apply_lut_j

    return apply_lut_j(x, jnp.arange(256, dtype=jnp.uint8)[::-1])


def _hist(x):
    from yamimageprocessor_tpu.ops.lutops import histogram256_j

    return histogram256_j(x)


def _clahe(x):
    from yamimageprocessor_tpu.ops.clahe import clahe_j

    return clahe_j(x, clip_limit=2.0, grid=(4, 4))


@pytest.mark.parametrize("fn", [_lut, _hist, _clahe], ids=["lut", "histogram", "clahe"])
def test_same_form_on_every_backend(fn, monkeypatch):
    import jax

    x = np.arange(64 * 64, dtype=np.uint32).reshape(64, 64).astype(np.uint8)
    programs = set()
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        programs.add(str(jax.make_jaxpr(fn)(x)))
    assert len(programs) == 1


@pytest.mark.parametrize("backend,device", [("cpu", False), ("gpu", True)])
def test_extraction_routes_to_device_off_cpu(backend, device, monkeypatch):
    import jax

    from yamimageprocessor_tpu.ops import extraction_device as XD
    from yamimageprocessor_tpu.utils import jaxcache

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda *a: "")
    assert XD.use_device_extraction() is device


def test_jaxcache_env_wins_over_argument(monkeypatch, tmp_path):
    from yamimageprocessor_tpu.utils import jaxcache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert jaxcache.cache_dir_for(tmp_path / "arg") == str(tmp_path / "env")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert jaxcache.cache_dir_for(tmp_path / "arg") == str(tmp_path / "arg")
    assert jaxcache.cache_dir_for() == str(jaxcache._DEFAULT_DIR)
    assert jaxcache._DEFAULT_DIR.name == ".jax_cache"


def test_jaxcache_skips_cpu_backend(monkeypatch, tmp_path):
    """The CPU backend never points jax at a shared cache directory."""

    from yamimageprocessor_tpu.utils import jaxcache

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert jaxcache.enable_persistent_cache() == ""
    assert not (tmp_path / "env").exists()
