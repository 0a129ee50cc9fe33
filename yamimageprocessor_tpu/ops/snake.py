"""Active contour (snake) evolution — skimage.segmentation.active_contour
capability (reference: ``core/segmentation.py:249-260``).

The reference gaussians the gray image (sigma=3), initializes a 400-point
circle at (W/2, H/2) with radius W/4 x H/4 and evolves the classic
Kass-Witkin-Terzopoulos snake: implicit internal-energy step via a
precomputed periodic pentadiagonal inverse, explicit external image force
(gradient of smoothed intensity + edge magnitude), tanh-clamped moves.
The annotated output draws the final polygon in green.

The solver is identical in numpy and jnp (the device path runs the loop in
``lax.scan``); the (N, N) inverse matrix is precomputed on the host and fed
as an input.  skimage itself is NOT a dependency — this re-implements the
published formulation.
"""
from __future__ import annotations

import numpy as np

from yamimageprocessor_tpu.ops import _kernels as K
from yamimageprocessor_tpu.ops import filters as F

N_POINTS = 400
MAX_PX_MOVE = 1.0


def snake_matrix_inv(n: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """inv(I + gamma*(alpha*K2 + beta*K4)) with periodic boundary."""

    idx = np.arange(n)
    k2 = np.zeros((n, n))
    k2[idx, idx] = 2.0
    k2[idx, (idx + 1) % n] = -1.0
    k2[idx, (idx - 1) % n] = -1.0
    k4 = np.zeros((n, n))
    k4[idx, idx] = 6.0
    k4[idx, (idx + 1) % n] = -4.0
    k4[idx, (idx - 1) % n] = -4.0
    k4[idx, (idx + 2) % n] = 1.0
    k4[idx, (idx - 2) % n] = 1.0
    a = alpha * k2 + beta * k4
    return np.linalg.inv(np.eye(n) + gamma * a).astype(np.float32)


def initial_circle(shape) -> np.ndarray:
    """(N, 2) [x, y] circle init (core/segmentation.py:253-256)."""

    s = np.linspace(0, 2 * np.pi, N_POINTS)
    x = shape[1] / 2 + (shape[1] / 4) * np.cos(s)
    y = shape[0] / 2 + (shape[0] / 4) * np.sin(s)
    return np.stack([x, y], axis=1).astype(np.float32)


def _energy_np(gray: np.ndarray) -> np.ndarray:
    """Edge-energy image: |grad| of the sigma=3 smoothed intensity."""

    img = gray.astype(np.float32) / 255.0
    ks = K.gaussian_ksize_for_sigma(3.0, depth_is_8u=False)
    taps = K.gaussian_taps(ks, 3.0)
    sm = F.sep_filter_np(img, taps, taps, border="replicate")
    gy, gx = np.gradient(sm)
    return np.sqrt(gx * gx + gy * gy).astype(np.float32)


def _bilinear_np(field: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = field.shape
    x = np.clip(x, 0.0, w - 1.001)
    y = np.clip(y, 0.0, h - 1.001)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0
    v00 = field[y0, x0]
    v01 = field[y0, x0 + 1]
    v10 = field[y0 + 1, x0]
    v11 = field[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def evolve_snake_np(
    gray: np.ndarray,
    iterations: int = 250,
    alpha: float = 0.015,
    beta: float = 10.0,
    gamma: float = 0.001,
) -> np.ndarray:
    energy = _energy_np(gray)
    gy, gx = np.gradient(energy)
    inv = snake_matrix_inv(N_POINTS, alpha, beta, gamma)
    pts = initial_circle(gray.shape)
    x, y = pts[:, 0].copy(), pts[:, 1].copy()
    for _ in range(int(iterations)):
        fx = _bilinear_np(gx, x, y)
        fy = _bilinear_np(gy, x, y)
        xn = inv @ (x + gamma * fx)
        yn = inv @ (y + gamma * fy)
        x = x + MAX_PX_MOVE * np.tanh(xn - x)
        y = y + MAX_PX_MOVE * np.tanh(yn - y)
    return np.stack([x, y], axis=1)


def evolve_snake_j(energy_gx, energy_gy, inv, init_pts, iterations: int, gamma: float):
    import jax
    import jax.numpy as jnp

    h, w = energy_gx.shape
    exact = jax.lax.Precision.HIGHEST  # no TF32: compared with the f64 golden

    def bilinear(field, x, y):
        x = jnp.clip(x, 0.0, w - 1.001)
        y = jnp.clip(y, 0.0, h - 1.001)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = x - x0
        fy = y - y0
        v00 = field[y0, x0]
        v01 = field[y0, x0 + 1]
        v10 = field[y0 + 1, x0]
        v11 = field[y0 + 1, x0 + 1]
        return (
            v00 * (1 - fy) * (1 - fx)
            + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx)
            + v11 * fy * fx
        )

    def step(state, _):
        x, y = state
        fx = bilinear(energy_gx, x, y)
        fy = bilinear(energy_gy, x, y)
        xn = jnp.matmul(inv, x + gamma * fx, precision=exact)
        yn = jnp.matmul(inv, y + gamma * fy, precision=exact)
        return (
            x + MAX_PX_MOVE * jnp.tanh(xn - x),
            y + MAX_PX_MOVE * jnp.tanh(yn - y),
        ), None

    (x, y), _ = jax.lax.scan(
        step, (init_pts[:, 0], init_pts[:, 1]), None, length=int(iterations)
    )
    return jnp.stack([x, y], axis=1)


def _gradient_j(field):
    """jnp twin of ``np.gradient``: central differences in the interior,
    one-sided at the edges. Returns (gy, gx)."""

    import jax.numpy as jnp

    def axis_grad(f, axis):
        f = jnp.moveaxis(f, axis, 0)
        interior = (f[2:] - f[:-2]) * 0.5
        first = (f[1] - f[0])[None]
        last = (f[-1] - f[-2])[None]
        return jnp.moveaxis(jnp.concatenate([first, interior, last]), 0, axis)

    return axis_grad(field, 0), axis_grad(field, 1)


def energy_j(gray):
    """Device twin of :func:`_energy_np` (sigma=3 smoothed |grad|)."""

    import jax.numpy as jnp

    from yamimageprocessor_tpu.ops import filters as F

    ks = K.gaussian_ksize_for_sigma(3.0, depth_is_8u=False)
    taps = jnp.asarray(K.gaussian_taps(ks, 3.0).astype(np.float32))
    img = gray.astype(jnp.float32) / 255.0
    sm = F.sep_filter_j(img, taps, taps, border="replicate")
    gy, gx = _gradient_j(sm)
    return jnp.sqrt(gx * gx + gy * gy)


def draw_closed_polyline_j(image, pts, color, radius: float = 1.0):
    """Rasterize a closed polyline on device: a pixel is painted when its
    distance to the nearest segment is within ``radius`` (a capsule per
    segment).  Semantically equivalent to the host Bresenham stamp — not
    bit-identical at anti-diagonal corners (documented "sem" class)."""

    import jax.numpy as jnp

    h, w = image.shape[:2]
    a = pts
    b = jnp.roll(pts, -1, axis=0)  # closed: segment i = pts[i] -> pts[i+1]
    yy, xx = jnp.mgrid[:h, :w]
    p = jnp.stack([xx, yy], axis=-1).astype(jnp.float32)  # (h, w, 2)
    ab = b - a  # (n, 2)
    denom = jnp.maximum((ab * ab).sum(-1), 1e-6)  # (n,)

    def seg_d2(carry, idx):
        ap = p - a[idx]
        t = jnp.clip((ap * ab[idx]).sum(-1) / denom[idx], 0.0, 1.0)
        closest = a[idx] + t[..., None] * ab[idx]
        d2 = ((p - closest) ** 2).sum(-1)
        return jnp.minimum(carry, d2), None

    import jax

    init = jnp.full((h, w), jnp.float32(1e30))
    min_d2, _ = jax.lax.scan(seg_d2, init, jnp.arange(pts.shape[0]))
    hit = min_d2 <= radius * radius
    if image.ndim == 2:
        # grayscale target: the host's _as_color uses mean(color)//3
        gray_col = jnp.asarray(sum(int(c) for c in color) // 3, dtype=image.dtype)
        return jnp.where(hit, gray_col, image)
    col = jnp.asarray(color[: image.shape[2]], dtype=image.dtype)
    return jnp.where(hit[..., None], col[None, None, :], image)


__all__ = [
    "snake_matrix_inv",
    "initial_circle",
    "evolve_snake_np",
    "evolve_snake_j",
    "energy_j",
    "draw_closed_polyline_j",
    "N_POINTS",
]
