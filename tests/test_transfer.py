"""Chunked D2H transfer helpers.

Device-runtime infrastructure with no reference counterpart (the reference
passes numpy buffers between steps, ``processing/pipeline_cache.py``);
round-trip correctness is what matters.
"""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.parallel import transfer as TR


@pytest.mark.parametrize("shape", [(7, 13), (512, 512), (3, 257, 129)])
def test_chunked_fetch_roundtrip(shape, rng):
    import jax

    data = rng.integers(0, 256, shape, dtype=np.uint8)
    dev = jax.device_put(data)
    # tiny chunk size forces the multi-chunk path even for small arrays
    out = TR.fetch(dev, chunk_bytes=1 << 12)
    np.testing.assert_array_equal(out, data)
    handle = TR.start_fetch(dev, chunk_bytes=1 << 12)
    np.testing.assert_array_equal(TR.finish_fetch(handle), data)
