"""256-entry LUT application and histograms for uint8 images.

One form on every backend, each the faster of its candidates on the H100
(``chip_smoke.py --compare-forms``, PERF.md): a per-pixel table gather for
the LUT, and for the histogram eight fused compare-sum passes of 32 levels
each, which beat a 256-bin scatter-add (atomics on 256 hot bins) by ~2.4x.
"""
from __future__ import annotations


def apply_lut_j(img, lut):
    """``lut[img]`` for uint8 ``img``; ``lut`` is a traced (256,) array."""

    import jax.numpy as jnp

    return lut[img.astype(jnp.int32)]


def histogram256_j(img):
    """Counts per level for uint8 ``img`` -> (256,) int32."""

    import jax.numpy as jnp

    x = img.reshape(-1).astype(jnp.int32)
    chunks = []
    for base in range(0, 256, 32):
        levels = jnp.arange(base, base + 32, dtype=jnp.int32)
        chunks.append(
            jnp.sum((x[:, None] == levels[None, :]).astype(jnp.int32), axis=0)
        )
    return jnp.concatenate(chunks)


__all__ = ["apply_lut_j", "histogram256_j"]
