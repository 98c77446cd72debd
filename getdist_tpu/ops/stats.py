"""Weighted-sample statistics kernels (device-side, jit/vmap-ready).

Re-design of the reference's per-parameter Python loops
(``getdist/chains.py:373-412, 709-733``) as batched XLA ops: weighted means
and covariances become single matmuls, confidence
limits use device sort + cumulative sums, and the Gaussian-KDE effective
sample size's lag terms (``chains.py:477-635``) are computed with
roll+mask so the lag can be a traced value (no per-lag recompiles).

All kernels take explicit arrays and return arrays — no object state — so
they can be vmapped over parameters/pairs and sharded over the sample axis
with ``shard_map`` (see ``getdist_tpu.parallel``).
"""

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "weighted_mean",
    "weighted_var",
    "weighted_cov",
    "cov_to_corr",
    "confidence_bounds",
    "kde_lag_correlation",
    "kde_lag_correlation_2d",
    "gelman_rubin_eigenvalues",
]

# f32 products may otherwise run in TF32 on the GPU
_PREC = jax.lax.Precision.HIGHEST


@jax.jit
def weighted_mean(samples, weights):
    """Weighted mean per column: ``w @ X / sum(w)``.

    ``samples``: (N, p) or (N,), ``weights``: (N,). A single matvec,
    order-stable under XLA's tree reductions.
    """
    norm = jnp.sum(weights)
    if samples.ndim == 1:
        return jnp.dot(weights, samples, precision=_PREC) / norm
    return jnp.matmul(weights, samples, precision=_PREC) / norm


@jax.jit
def weighted_var(samples, weights, means=None):
    """Weighted variance per column (biased, matching reference
    ``chains.py:400-412``)."""
    norm = jnp.sum(weights)
    if means is None:
        means = weighted_mean(samples, weights)
    diffs = samples - means
    if samples.ndim == 1:
        return jnp.dot(weights, diffs * diffs, precision=_PREC) / norm
    return jnp.matmul(weights, diffs * diffs, precision=_PREC) / norm


@jax.jit
def weighted_cov(samples, weights, means=None):
    """Full weighted covariance as one (p,N)@(N,p) matmul (vs the
    reference's O(p^2) Python loop at ``chains.py:709-733``)."""
    norm = jnp.sum(weights)
    if means is None:
        means = weighted_mean(samples, weights)
    diffs = samples - means
    weighted = diffs * weights[:, None]
    return jnp.matmul(weighted.T, diffs, precision=_PREC) / norm


@jax.jit
def cov_to_corr(cov):
    """Covariance -> correlation; zero-variance rows/cols left unscaled
    (reference ``covToCorr``, ``chains.py:155-169``)."""
    d = jnp.sqrt(jnp.diagonal(cov))
    scale = jnp.where(d > 0, d, 1.0)
    return cov / jnp.outer(scale, scale)


@partial(jax.jit, static_argnames=("upper",))
def confidence_bounds(paramvec, weights, limfrac, upper=False):
    """Tail-count confidence limit: sort values, accumulate weights, find
    where the cumulative weight crosses ``limfrac * norm`` (upper:
    ``(1-limfrac) * norm``). Matches reference ``confidence``
    (``chains.py:814-838``). ``limfrac`` may be a scalar or an array of
    tail fractions.
    """
    order = jnp.argsort(paramvec)
    sorted_vals = paramvec[order]
    cumsum = jnp.cumsum(weights[order])
    norm = cumsum[-1]
    limfrac = jnp.asarray(limfrac)
    target = norm * (1 - limfrac) if upper else norm * limfrac
    ix = jnp.searchsorted(cumsum, target)
    ix = jnp.minimum(ix, sorted_vals.shape[0] - 1)
    return sorted_vals[ix]


@jax.jit
def kde_lag_correlation(d, w, k, kernel_std):
    """One lag term of the Gaussian-KDE effective-sample-size estimator:

    ``sum_i exp(-(d_i - d_{i+k})^2 / (4 sigma^2)) w_i w_{i+k}``

    Reference computes this with array slicing per lag
    (``chains.py:533-537``); here the lag ``k`` is a traced value via
    roll+mask so the adaptive search loop reuses one compiled kernel.
    """
    n = d.shape[0]
    d_shift = jnp.roll(d, -k)
    w_shift = jnp.roll(w, -k)
    valid = jnp.arange(n) < n - k
    diff2 = (d - d_shift) ** 2 / (4.0 * kernel_std**2)
    return jnp.sum(jnp.where(valid, jnp.exp(-diff2) * w * w_shift, 0.0))


@jax.jit
def kde_lag_correlation_2d(d1, d2, w, k, kernel_inv):
    """2D analogue with Mahalanobis distance under ``kernel_inv``
    (reference ``chains.py:617-630``)."""
    n = d1.shape[0]
    e1 = d1 - jnp.roll(d1, -k)
    e2 = d2 - jnp.roll(d2, -k)
    w_shift = jnp.roll(w, -k)
    valid = jnp.arange(n) < n - k
    diff2 = kernel_inv[0, 0] * e1 * e1 + 2 * kernel_inv[0, 1] * e1 * e2 + kernel_inv[1, 1] * e2 * e2
    return jnp.sum(jnp.where(valid, jnp.exp(-diff2 / 4.0) * w * w_shift, 0.0))


def gelman_rubin_eigenvalues(chain_means, chain_covs, global_means):
    """Brooks & Gelman diagonalized var(mean)/mean(var) eigenvalues.

    ``chain_means``: (c, p) per-chain weighted means, ``chain_covs``:
    (c, p, p) per-chain covariances, ``global_means``: (p,). Returns the
    eigenvalue array, or None if mean(cov) is not positive definite
    (reference ``getGelmanRubinEigenvalues``, ``chains.py:1446-1474``).
    """
    diffs = chain_means - global_means
    meanscov = jnp.einsum("ci,cj->ij", diffs, diffs, precision=_PREC) / (chain_means.shape[0] - 1)
    meancov = jnp.mean(chain_covs, axis=0)
    w, u = jnp.linalg.eigh(meancov)
    if not bool(jnp.min(w) > 0):
        return None
    u = u / jnp.sqrt(w)
    scaled = jnp.matmul(jnp.matmul(u.T, meanscov, precision=_PREC), u, precision=_PREC)
    return jnp.linalg.eigvalsh(scaled)
