"""Device watershed flood: bit-parity with the numpy golden flood on gray
and color frames of awkward shapes."""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.ops.watershed import watershed_j, watershed_np


def _scene(h, w, seed=0, blobs=3):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    markers = np.zeros((h, w), np.int32)
    for i in range(blobs):
        cy, cx = rng.integers(8, h - 8), rng.integers(8, w - 8)
        r = int(rng.integers(4, max(5, min(h, w) // 6)))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 150 + i * 30
        markers[cy, cx] = i + 2
    img = (img.astype(np.int16) + rng.integers(-8, 9, img.shape)).clip(0, 255)
    markers[img > 250] = 1  # background marker blob
    markers[1, 1] = 1
    return img.astype(np.uint8), markers


@pytest.mark.parametrize("shape", [(40, 56), (64, 130), (33, 48)])
def test_flood_matches_golden(shape):
    img, markers = _scene(*shape, seed=shape[0])
    golden = watershed_np(img, markers)
    got = np.asarray(watershed_j(img, markers))
    assert (got == golden).all()


def test_flood_color_image():
    img, markers = _scene(48, 64, seed=7)
    bgr = np.stack([img, np.roll(img, 2, 1), img], axis=-1)
    golden = watershed_np(bgr, markers)
    got = np.asarray(watershed_j(bgr, markers))
    assert (got == golden).all()
