"""Persistent XLA compilation cache wiring.

The compiled chains (the segmentation chain with its while-loop floods
above all) take seconds to tens of seconds to compile for the GPU; the
persistent cache pays that once per cache directory.  Every entry point
(bench, graft entry, CLI, compiled chains) calls
:func:`enable_persistent_cache` before building jitted programs.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives at the fixed ``<repo>/.jax_cache``.
"""
from __future__ import annotations

import os
from pathlib import Path

_DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
_enabled = False


def cache_dir_for(cache_dir: str | os.PathLike | None = None) -> str:
    """The directory the cache uses: ``JAX_COMPILATION_CACHE_DIR`` if set,
    else ``cache_dir``, else ``<repo>/.jax_cache``."""

    return str(
        os.environ.get("JAX_COMPILATION_CACHE_DIR") or cache_dir or _DEFAULT_DIR
    )


def enable_persistent_cache(cache_dir: str | os.PathLike | None = None) -> str:
    """Point jax at an on-disk compilation cache (idempotent); returns the
    directory, or "" on the CPU backend."""

    global _enabled
    import jax

    # XLA:CPU AOT entries from hosts with different CPU features can load
    # and then fault ("could lead to execution errors such as SIGILL"), so
    # the CPU backend never reads or writes a shared cache.  A platform
    # list such as "cuda,cpu" names the CPU only as a fallback, so ask the
    # backend JAX resolved.
    if jax.default_backend() == "cpu":
        return ""

    target = cache_dir_for(cache_dir)
    if _enabled and jax.config.jax_compilation_cache_dir == target:
        return target
    Path(target).mkdir(parents=True, exist_ok=True)
    # JAX's own threshold stays: compiles of 1 s or more (the chains) are
    # written, the parity audit's ~1,400 small programs are not (PERF.md).
    jax.config.update("jax_compilation_cache_dir", target)
    _enabled = True
    return target


__all__ = ["cache_dir_for", "enable_persistent_cache"]
