"""Clustering segmentation: K-Means, Fuzzy C-Means, GMM.

Reference: ``core/segmentation.py:125-138`` (cv2.kmeans, 10 attempts,
RANDOM_CENTERS, seeded), ``:195-207`` (skfuzzy cmeans, m=2, error 0.005,
maxiter 1000), ``:215-235`` (sklearn GaussianMixture, full covariance).

Device redesign: instead of sequential attempts/iterations on the host,
attempts are vmapped device-side (10 Lloyd runs execute in parallel) and
EM/FCM updates are batched matrix ops pinned to full f32 precision.
Seeded initial states are generated on the host from numpy RandomState so
results are reproducible; numpy golden twins run the same arithmetic.
cv2/sklearn/skfuzzy use their own RNGs, so cross-library equality is
structural (same K, binarized output) rather than bitwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# K-Means (Lloyd, multi-attempt)
def kmeans_init_uniform(k: int, channels: int, seed: int, attempts: int) -> np.ndarray:
    """(attempts, k, C) seeded uniforms in [0, 1); both paths scale them into
    the data bounding box (the distribution cv2's RANDOM_CENTERS draws from,
    with our own RNG so host and device share the exact same inits)."""

    rs = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    return rs.random_sample((attempts, k, channels)).astype(np.float32)


def scale_inits_np(u: np.ndarray, data: np.ndarray) -> np.ndarray:
    lo = data.min(axis=0)
    hi = data.max(axis=0)
    return lo + u * (hi - lo)


def _lloyd_np(data: np.ndarray, centers: np.ndarray, iters: int) -> Tuple[np.ndarray, np.float32]:
    for _ in range(iters):
        d2 = ((data[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = np.argmin(d2, axis=1)
        for kk in range(centers.shape[0]):
            sel = assign == kk
            if sel.any():
                centers[kk] = data[sel].mean(axis=0, dtype=np.float32)
    d2 = ((data[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    assign = np.argmin(d2, axis=1)
    compactness = np.float32(d2[np.arange(len(data)), assign].sum())
    return assign, compactness, centers


def kmeans_np(data: np.ndarray, k: int, seed: int, attempts: int = 10, iters: int = 10):
    """Returns (labels, centers) of the best of ``attempts`` Lloyd runs."""

    data = data.astype(np.float32)
    u = kmeans_init_uniform(k, data.shape[1], seed, attempts)
    inits = scale_inits_np(u, data)
    best = None
    for a in range(attempts):
        assign, compactness, centers = _lloyd_np(data, inits[a].copy(), iters)
        if best is None or compactness < best[0]:
            best = (compactness, assign, centers)
    return best[1], best[2]


def kmeans_j(data, init_u, iters: int = 10):
    """Device twin: ``init_u`` (attempts, k, C) in [0,1); all attempts run
    vmapped on the chip."""

    import jax
    import jax.numpy as jnp

    lo = data.min(axis=0)
    hi = data.max(axis=0)
    inits = lo + init_u * (hi - lo)
    exact = jax.lax.Precision.HIGHEST  # no TF32: sums of pixel values

    def one_attempt(centers):
        def body(_, centers):
            d2 = ((data[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            assign = jnp.argmin(d2, axis=1)
            onehot = jax.nn.one_hot(assign, centers.shape[0], dtype=jnp.float32)
            counts = onehot.sum(0)
            sums = jnp.matmul(onehot.T, data, precision=exact)
            new = sums / jnp.maximum(counts[:, None], 1.0)
            return jnp.where(counts[:, None] > 0, new, centers)

        centers = jax.lax.fori_loop(0, iters, body, centers)
        d2 = ((data[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = jnp.argmin(d2, axis=1)
        compactness = jnp.take_along_axis(d2, assign[:, None], axis=1).sum()
        return assign, compactness, centers

    assigns, compact, centers = jax.vmap(one_attempt)(inits)
    best = jnp.argmin(compact)
    return assigns[best], centers[best]


# ---------------------------------------------------------------------------
# Fuzzy C-Means (m=2)
def fcm_init_u(n: int, k: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    u = rs.rand(k, n).astype(np.float32)
    return u / u.sum(axis=0, keepdims=True)


def fcm_np(data: np.ndarray, u0: np.ndarray, error: float = 0.005, maxiter: int = 1000):
    """1-D fuzzy c-means; ``data`` shape (n,), ``u0`` shape (k, n)."""

    data = data.astype(np.float32)
    u = u0.copy()
    for _ in range(maxiter):
        um = u * u  # m = 2
        cntr = (um @ data) / um.sum(axis=1)
        d = np.abs(data[None, :] - cntr[:, None])
        d = np.fmax(d, np.finfo(np.float32).eps)
        inv = 1.0 / (d * d)
        u_new = (inv / inv.sum(axis=0, keepdims=True)).astype(np.float32)
        delta = np.linalg.norm(u_new - u)
        u = u_new
        if delta < error:
            break
    return cntr, u


def fcm_j(data, u0, error: float = 0.005, maxiter: int = 1000):
    import jax
    import jax.numpy as jnp

    data = data.astype(jnp.float32)
    eps = jnp.float32(np.finfo(np.float32).eps)
    exact = jax.lax.Precision.HIGHEST  # no TF32: compared with the f32 golden

    def step(u):
        um = u * u
        cntr = jnp.matmul(um, data, precision=exact) / um.sum(axis=1)
        d = jnp.abs(data[None, :] - cntr[:, None])
        d = jnp.maximum(d, eps)
        inv = 1.0 / (d * d)
        return cntr, inv / inv.sum(axis=0, keepdims=True)

    def cond(state):
        u, _, delta, it = state
        return jnp.logical_and(delta >= error, it < maxiter)

    def body(state):
        u, _, _, it = state
        cntr, u_new = step(u)
        delta = jnp.linalg.norm(u_new - u)
        return u_new, cntr, delta, it + 1

    cntr0, u1 = step(u0)
    delta0 = jnp.linalg.norm(u1 - u0)
    u, cntr, _, _ = jax.lax.while_loop(cond, body, (u1, cntr0, delta0, 1))
    # one more center pass so centers reflect the final memberships
    um = u * u
    cntr = jnp.matmul(um, data, precision=exact) / um.sum(axis=1)
    return cntr, u


# ---------------------------------------------------------------------------
# Gaussian mixture (full covariance EM); numpy twin mirrors gmm_j exactly
# (float32, fixed iteration count, scalar-variance covariance init).
def gmm_np(data: np.ndarray, init_means: np.ndarray, iters: int = 50, reg: float = 1e-2):
    data = data.astype(np.float32)
    n, d = data.shape
    k = init_means.shape[0]
    eye = np.eye(d, dtype=np.float32)

    def log_gauss(means, covs):
        chol = np.linalg.cholesky(covs)  # (k, d, d)
        diff = data[:, None, :] - means[None, :, :]
        sol = np.stack(
            [
                np.linalg.solve(np.tril(chol[i]), diff[:, i, :].T).T
                for i in range(k)
            ],
            axis=1,
        )
        quad = (sol * sol).sum(-1)
        logdet = 2.0 * np.log(np.diagonal(chol, axis1=1, axis2=2)).sum(-1)
        return -0.5 * (quad + logdet[None, :] + d * np.log(2 * np.pi))

    weights = np.full((k,), 1.0 / k, np.float32)
    means = init_means.astype(np.float32).copy()
    covs = np.broadcast_to(eye, (k, d, d)) * np.var(data) + reg * eye[None]
    covs = covs.astype(np.float32).copy()
    for _ in range(iters):
        logp = np.log(weights)[None, :] + log_gauss(means, covs)
        logp = logp - logp.max(axis=1, keepdims=True)
        resp = np.exp(logp)
        resp = resp / resp.sum(axis=1, keepdims=True)
        nk = resp.sum(axis=0) + 1e-10
        weights = np.maximum((nk / n).astype(np.float32), 1e-8)
        means = (resp.T @ data) / nk[:, None]
        diff = data[:, None, :] - means[None, :, :]
        covs = (
            np.einsum("nk,nki,nkj->kij", resp, diff, diff) / nk[:, None, None]
            + reg * eye[None]
        ).astype(np.float32)
    logp = np.log(weights)[None, :] + log_gauss(means, covs)
    return np.argmax(logp, axis=1), means


def gmm_j(data, init_means, iters: int = 50, reg: float = 1e-2):
    import jax
    import jax.numpy as jnp

    data = data.astype(jnp.float32)
    n, d = data.shape
    k = init_means.shape[0]
    eye = jnp.eye(d, dtype=jnp.float32)
    exact = jax.lax.Precision.HIGHEST  # no TF32: compared with the f32 golden

    def log_gauss(means, covs):
        chol = jnp.linalg.cholesky(covs)  # (k, d, d)
        diff = data[:, None, :] - means[None, :, :]  # (n, k, d)
        sol = jax.vmap(
            lambda L, v: jax.scipy.linalg.solve_triangular(L, v.T, lower=True).T,
            in_axes=(0, 1),
            out_axes=1,
        )(chol, diff)
        quad = (sol * sol).sum(-1)
        logdet = 2.0 * jnp.log(jnp.diagonal(chol, axis1=1, axis2=2)).sum(-1)
        return -0.5 * (quad + logdet[None, :] + d * jnp.log(2 * jnp.pi))

    def em_step(state, _):
        weights, means, covs = state
        logp = jnp.log(weights)[None, :] + log_gauss(means, covs)
        logp = logp - logp.max(axis=1, keepdims=True)
        resp = jnp.exp(logp)
        resp = resp / resp.sum(axis=1, keepdims=True)
        nk = resp.sum(axis=0) + 1e-10
        weights = jnp.maximum(nk / n, 1e-8)
        means = jnp.matmul(resp.T, data, precision=exact) / nk[:, None]
        diff = data[:, None, :] - means[None, :, :]
        covs = (
            jnp.einsum("nk,nki,nkj->kij", resp, diff, diff, precision=exact)
            / nk[:, None, None]
            + reg * eye[None]
        )
        return (weights, means, covs), None

    weights0 = jnp.full((k,), 1.0 / k, jnp.float32)
    covs0 = jnp.broadcast_to(eye, (k, d, d)) * jnp.var(data) + reg * eye[None]
    (weights, means, covs), _ = jax.lax.scan(
        em_step, (weights0, init_means.astype(jnp.float32), covs0), None, length=iters
    )
    logp = jnp.log(weights)[None, :] + log_gauss(means, covs)
    return jnp.argmax(logp, axis=1), means


__all__ = [
    "kmeans_init_uniform",
    "scale_inits_np",
    "kmeans_np",
    "kmeans_j",
    "fcm_init_u",
    "fcm_np",
    "fcm_j",
    "gmm_np",
    "gmm_j",
]
