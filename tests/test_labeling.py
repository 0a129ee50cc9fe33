"""Connected components on the device: partition parity with scipy.

``label_j`` (the XLA doubling-scan loop) must agree exactly with
``label_np`` on adversarial masks — blobs, noise, a spiral that winds across
the whole frame, empty/full/corner frames and full-length thin lines.
"""
from __future__ import annotations

import numpy as np
import pytest

from yamimageprocessor_tpu.ops.labeling import label_j, label_np


def _disks(h, w, seed=0, blobs=6):
    rng = np.random.default_rng(seed)
    fg = np.zeros((h, w), bool)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(blobs):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = int(rng.integers(3, max(4, min(h, w) // 5)))
        fg |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return fg


def _noise():
    return np.random.default_rng(11).random((48, 160)) > 0.55


def _spiral():
    # one component winding through the whole frame: information must
    # cross the frame many times before the loop converges
    h = w = 64
    fg = np.zeros((h, w), bool)
    top, bottom, left, right = 0, h - 1, 0, w - 1
    while top < bottom and left < right:
        fg[top, left : right + 1] = True
        fg[top : bottom + 1, right] = True
        fg[bottom, left : right + 1] = True
        fg[top : bottom + 1, left] = True
        top += 4
        bottom -= 4
        left += 4
        right -= 4
    return fg


def _thin_lines():
    fg = np.zeros((41, 133), bool)
    fg[7, :] = True  # full-width run
    fg[:, 64] = True  # full-height run crossing it (one component)
    fg[30, 3:40] = True  # disjoint horizontal segment
    return fg


def _corners():
    fg = np.zeros((30, 140), bool)
    fg[0, 0] = fg[0, -1] = fg[-1, 0] = fg[-1, -1] = True
    return fg


@pytest.mark.parametrize(
    "make",
    [
        pytest.param(lambda: _disks(40, 56, seed=56), id="disks-40x56"),
        pytest.param(lambda: _disks(64, 130, seed=130), id="disks-64x130"),
        pytest.param(lambda: _disks(33, 300, seed=300), id="disks-33x300"),
        pytest.param(_noise, id="noise"),
        pytest.param(_spiral, id="spiral"),
        pytest.param(
            lambda: [np.zeros((24, 136), bool), np.ones((24, 136), bool), _corners()],
            id="edges",
        ),
        pytest.param(_thin_lines, id="thin-lines"),
    ],
)
def test_label_j_matches_golden(make):
    masks = make()
    for fg in masks if isinstance(masks, list) else [masks]:
        assert (np.asarray(label_j(fg)) == label_np(fg)).all()


def test_label_j_cpu_path_unchanged():
    # label_j takes (and passes through) the XLA loop on every backend
    fg = _disks(45, 150, seed=3)
    assert (np.asarray(label_j(fg)) == label_np(fg)).all()
