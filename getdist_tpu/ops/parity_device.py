"""Device kernels for the parity pipeline's O(N) stages.

These are the f64 jitted twins of the host passes `fastParityDensities`
runs per chain — bin-index computation (reference ``mcsamples.py:1874``
convention), exact weighted pair histograms, sheared-residual rows
(reference ``mcsamples.py:1334-1380``), and the KDE-N_eff lag pair sums
(reference ``chains.py:477-574``) — so the chain stays on the device and
only compact tables (per-pair histograms, per-job lag-sum scalars) return
to the host-exact bandwidth optimizers.

Exactness: bin indices are computed in f64 with the host formulas (trunc
semantics; f64 division is correctly rounded on both supported
platforms); histograms are scatter-adds, exact for integral
f32-representable weights with bin sums below 2**24. The only deviation
from the host pipeline is reduction order in the lag sums (~1e-15
relative).
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from getdist_tpu.ops.fft import next_fast_len
from getdist_tpu.ops.histograms import pair_histograms

__all__ = [
    "acl_batch",
    "bin_indices",
    "bin_rows",
    "sheared_rows_minmax",
    "group_pair_hists",
    "kde_neff_batch",
    "lag_terms",
]


@jax.jit
def bin_indices(samples, binmin, fine_width):
    """(P, N) int32 fine-bin indices, the ``_binSamples`` convention:
    ``((x - binmin) / fine_width + 0.5).astype(int)`` per column."""
    cols = samples.T
    return ((cols - binmin[:, None]) / fine_width[:, None] + 0.5).astype(jnp.int32)


@jax.jit
def bin_rows(rows, rmin, dx):
    """(J, N) int32 indices for residual rows, the ``kde_bandwidth.
    bin_samples`` convention: ``((x - rmin) / dx).astype(int)``."""
    return ((rows - rmin[:, None]) / dx[:, None]).astype(jnp.int32)


@jax.jit
def sheared_rows_minmax(samples, other_ix, lead_ix, r00, r10, r11):
    """Sheared residual rows for the host 2D bandwidth optimizer's
    correlated branch plus their data extents.

    rows[j] = (r00[j] * samples[:, other[j]] - r10[j] * samples[:, lead[j]])
              / r11[j]  — the Cholesky residual of ``_sheared_bandwidths_
    batch`` (host twin at mcsamples.py; reference mcsamples.py:1334-1380).
    Returns (rows (J, N), min (J,), max (J,)).
    """
    other = jnp.take(samples, other_ix, axis=1).T
    lead = jnp.take(samples, lead_ix, axis=1).T
    rows = (r00[:, None] * other - r10[:, None] * lead) / r11[:, None]
    return rows, jnp.min(rows, axis=1), jnp.max(rows, axis=1)


@partial(jax.jit, static_argnames=("fine",))
def _group_pair_hists(ix, pa, pb, weights, fine):
    return pair_histograms(ix, weights, pa, pb, fine)


def group_pair_hists(ix, pa, pb, weights, fine):
    """(K, fine, fine) weighted pair histograms (rows = b, cols = a, the
    ``_make2Dhist`` convention), exact for integral f32 weights with bin
    sums below 2**24. ``ix``: (R, N) int32 index rows; ``pa``/``pb``: (K,)
    int32 row positions (host arrays)."""
    pa = jnp.asarray(np.asarray(pa, np.int32))
    pb = jnp.asarray(np.asarray(pb, np.int32))
    return _group_pair_hists(ix, pa, pb, weights, fine)


@partial(jax.jit, static_argnames=("maxlag", "fft_size"))
def _acl_curves(cols_f32, weights_f32, means, invvars, maxlag, fft_size, min_corr=0.05):
    """(P,) autocorrelation lengths + knife-edge margins from one batched
    f32 FFT pass (the acl itself is accumulated in f64 from the f32 curve).

    Twin of the host chain ``getAutocorrelation(maxOff) -> acl_from_curve``
    (reference ``chains.py:423-466``): curve[k] = sum_i d_i d_{i+k} /
    overlap / var with d = (x - mean) * w, acl = curve[0] + 2 * sum of the
    leading run above min_corr * curve[0]. ``margin`` is the smallest
    distance of any lag to its threshold, in curve[0] units — the caller's
    guard band for f32-vs-f64 comparison flips."""
    d = (cols_f32 - means[:, None].astype(jnp.float32)) * weights_f32[None, :]
    spec = jnp.fft.rfft(d, fft_size, axis=1)
    lags = jnp.fft.irfft(spec * jnp.conj(spec), fft_size, axis=1)[:, :maxlag]
    overlap = (d.shape[1] - jnp.arange(maxlag)).astype(jnp.float64)
    corr = lags.astype(jnp.float64) / overlap[None, :] * invvars[:, None]
    c0 = corr[:, :1]
    t = min_corr * c0
    above = corr > t
    cut = jnp.argmin(above, axis=1)  # first below-threshold lag (0 if none)
    k = jnp.arange(maxlag)[None, :]
    tail = jnp.sum(jnp.where((k >= 1) & (k < cut[:, None]), corr, 0.0), axis=1)
    acl = corr[:, 0] + 2.0 * tail
    margin = jnp.min(jnp.abs(corr - t), axis=1) / jnp.abs(c0[:, 0])
    return acl, margin


def acl_batch(dev_samples_f32, dev_weights_f32, means, variances, col_ix, maxlag):
    """Batched autocorrelation lengths for the parity pipeline.

    One device dispatch replaces the per-param host FFT loop
    (``getCorrelationLength``), which costs seconds of single-core numpy at
    1M samples x 30 params.
    Returns (acl (P,) f64, safe (P,) bool): ``safe`` is False when an f32
    rounding flip could change the integer lag horizon the caller derives
    — threshold comparisons within the guard band, or 1.5*acl within it of
    an integer — and the caller must recompute that parameter with the
    exact host path."""
    cols = jnp.take(dev_samples_f32, jnp.asarray(np.asarray(col_ix, np.int32)), axis=1).T
    n = cols.shape[1]
    fft_size = next_fast_len(2 * n)
    acl, margin = _acl_curves(
        cols,
        dev_weights_f32,
        jnp.asarray(np.asarray(means, np.float64)),
        jnp.asarray(1.0 / np.asarray(variances, np.float64)),
        maxlag,
        fft_size,
    )
    acl = np.asarray(acl)
    margin = np.asarray(margin)
    # guard bands ~100x the observed f32-FFT error at 1M samples (~1e-6
    # relative): comparison flips, and int(1.5 * acl) truncation flips
    frac = np.mod(1.5 * acl, 1.0)
    safe = (margin > 1e-4) & (frac > 1e-3) & (frac < 1.0 - 1e-3) & np.isfinite(acl)
    return acl, safe


def kde_neff_batch(dev_samples, dev_weights, host_weights, kernel_stds, maxoffs, numrows, min_corr=0.05, col_ix=None):
    """Batched KDE effective-sample denominators N (the caller divides
    ``norm**2 / N``), reproducing the host adaptive-lag driver semantics
    (``samplemath.kde_pair_sum_adaptive``, reference ``chains.py:477-574``)
    for every parameter in TWO device dispatches.

    Dispatch 1 evaluates, per param, the five baseline lags near
    numrows//2, lags 1 and 2, and the full coarse-probe chain
    maxoff//3, //9, ... (a superset of the lags the host driver's
    data-dependent horizon loop can visit). The host then replays the
    driver's branch logic on those values and lists the strided phase-2
    lags each param still needs; dispatch 2 evaluates exactly those.
    Values match the host pair sums to reduction order (~1e-15).
    """
    p_count = len(kernel_stds)
    cols = list(range(p_count)) if col_ix is None else list(col_ix)
    far = numrows // 2
    lag0 = float(np.dot(host_weights, host_weights))
    floor = min_corr * lag0

    jobs_a, keys_a = [], []
    for p in range(p_count):
        for lag in (far, far + 1, far + 2, far + 3, far + 4, 1, 2):
            jobs_a.append((cols[p], lag, kernel_stds[p]))
            keys_a.append((p, lag))
        h = int(maxoffs[p])
        while h > 10:
            jobs_a.append((cols[p], h // 3, kernel_stds[p]))
            keys_a.append((p, h // 3))
            h //= 3
    vals_a = lag_terms(dev_samples, dev_weights, jobs_a)
    table = dict(zip(keys_a, vals_a))

    n_out = np.empty(p_count)
    jobs_b = []
    plan_b = {}
    for p in range(p_count):
        base = sum(table[(p, far + i)] for i in range(5)) / sum(numrows - (far + i) for i in range(5))

        def excess(lag, p=p, base=base):
            return table[(p, lag)] - (numrows - lag) * base

        first = excess(1)
        if first < floor:
            n_out[p] = lag0
            continue
        second = excess(2)
        if second <= floor:
            n_out[p] = lag0 + 2 * first
            continue
        horizon = int(maxoffs[p])
        while horizon > 10 and excess(horizon // 3) < floor:
            horizon //= 3
        stride = 1 if horizon < 20 else horizon // 10
        lags = list(range(3, int(maxoffs[p]) + 1, stride))
        plan_b[p] = (first, second, stride, lags, base)
        jobs_b.extend(((cols[p], lag, kernel_stds[p]), (p, lag)) for lag in lags)

    if jobs_b:
        vals_b = lag_terms(dev_samples, dev_weights, [jb[0] for jb in jobs_b])
        table.update({key: v for (_, key), v in zip(jobs_b, vals_b)})
    for p, (first, second, stride, lags, base) in plan_b.items():
        acc = first + second
        for k in lags:
            val = table[(p, k)] - (numrows - k) * base
            if val < floor:
                break
            acc += val * stride if k > 3 else val * stride / 2
        n_out[p] = lag0 + 2 * acc
    return n_out


@jax.jit
def _lag_terms_jobs(samples, weights, pidx, lags, inv4k2):
    """(J,) f64 Gaussian-kernel pair sums: job j sums over n of
    exp(-(d[n+lag] - d[n])^2 / (4 kstd^2)) * w[n+lag] * w[n] for column
    pidx[j] (host twin: samplemath.kde_lag_term_1d)."""
    n = samples.shape[0]
    pos = jnp.arange(n)

    def one(job):
        p, k, c = job
        d = jax.lax.dynamic_index_in_dim(samples.T, p, axis=0, keepdims=False)
        step = jnp.roll(d, -k) - d
        wprod = weights * jnp.roll(weights, -k)
        mask = pos < (n - k)
        return jnp.sum(jnp.where(mask, jnp.exp(step * step * (-c)) * wprod, 0.0))

    return jax.lax.map(one, (pidx, lags, inv4k2))


def lag_terms(samples, weights, jobs):
    """Batched KDE lag pair sums: ``jobs`` is a list of
    (param_pos, lag, kernel_std); returns a host f64 array of the sums.

    Jobs are padded to a multiple of 32 (cache-stable program shapes);
    one device dispatch evaluates every job.
    """
    if not jobs:
        return np.zeros(0)
    j = len(jobs)
    pad = (-j) % 32
    pidx = np.array([q[0] for q in jobs] + [0] * pad, np.int32)
    lags = np.array([q[1] for q in jobs] + [1] * pad, np.int32)
    kstd = np.array([q[2] for q in jobs] + [1.0] * pad, np.float64)
    out = _lag_terms_jobs(
        samples, weights, jnp.asarray(pidx), jnp.asarray(lags), jnp.asarray(0.25 / kstd**2)
    )
    return np.asarray(out)[:j]
