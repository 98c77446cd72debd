"""Fused all-params / all-pairs KDE pipeline (the benchmark program).

This is the speed path for the headline workload: all 1D and all-pairs 2D
marginalized densities of a p-parameter, N-sample weighted chain in a single
jitted program, vmapped over parameters/pairs, with zero host round trips.

Design:

* **Binning is a scatter-add** (:mod:`getdist_tpu.ops.histograms`): one
  weighted increment per sample and parameter (1D) or pair (2D).
* **No sorts.** Quantiles come from fine-histogram cumulative sums;
  contour levels use bisection on the water level instead of sort+cumsum.
* **Bandwidths run fully jitted**: the Botev ISJ fixed point is solved by
  lax.while_loop bisection per parameter (vmapped); the 2D plug-in uses the
  same psi-functional recursion (static depth, unrolled) with diagonal
  bandwidths and sample-correlation kernels.
* **Convolutions are batched rFFTs** over (pairs, pad, pad) grids.

The full reference bandwidth algorithm runs on device: quantile
sigma_range scales, the 2D fixed-point/plug-in functional tables, AMISE
kernel-correlation optimization, Cholesky shearing for correlated pairs
(approximated by resampling the pair histogram into sheared coordinates
rather than re-binning raw samples), rule-of-thumb fallbacks at extreme
correlation, and order-1 linear boundary-kernel corrections in both 1D
and 2D. Corr-adaptive fine grids run as a second per-bucket program
(``mcsamples.fastTriangleDensities``). Remaining approximations, all
regression-tested against the parity path in tests/test_batched.py and
tests/test_fused_fidelity.py: histogram-based quantiles for ranges (vs
exact sample quantiles), a fixed log-spaced lag grid for the KDE N_eff
estimate (vs adaptive stepping), fixed-iteration projected gradient for
the AMISE search (vs scipy TNC), and histogram-resampled shearing.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from getdist_tpu.ops.fft import dct, next_fast_len
from getdist_tpu.ops.histograms import pair_histograms, row_histograms

__all__ = [
    "prepare_chain",
    "all_1d_densities",
    "all_2d_densities",
    "triangle_densities",
]

_ROOT_PI = np.sqrt(np.pi)
_PI_SQ = np.pi**2
_ISJ_LMAX = 7
# stage constants for the 1D ISJ recursion, j = lmax-1 .. 2
_ISJ_CONSTS = tuple(
    (1 + 0.5 ** (j + 0.5)) / 3 * np.prod(np.arange(1, 2 * j, 2)) / (_ROOT_PI / np.sqrt(2.0))
    for j in range(_ISJ_LMAX - 1, 1, -1)
)
# 2D even-order kernel constants K[j] = phi^(2j)(0)
_K_EVEN = tuple(
    [1 / np.sqrt(2 * np.pi)] + [(-1) ** j * np.prod(np.arange(1, 2 * j, 2)) / np.sqrt(2 * np.pi) for j in range(1, 5)]
)


# Statistical contractions (bandwidth functionals, moments, cumulants) run
# at HIGHEST matmul precision: a float32 product may otherwise run in TF32
# (or bf16 passes), which is catastrophic for the tiny squared-DCT
# coefficients the ISJ functional chain contracts and sloppy for 1M-sample
# moment sums. These dots are a negligible share of the program's flops.
_PREC = jax.lax.Precision.HIGHEST


@jax.jit
def pair_cumulant_score(samples, weights):
    """|k31| + |k13| + |k22| standardized joint cumulants for every param
    pair, as a (P, P) matrix. These vanish for jointly-Gaussian pairs, so
    the host uses them to gate the fragile-bandwidth f64 assist
    (:meth:`MCSamples._fast_regrid_pairs`): genuinely non-Gaussian zoo
    shapes measure 0.4-3.4 where Gaussian chains stay below ~0.11."""
    wn = weights / jnp.sum(weights)
    zc = samples - jnp.matmul(wn, samples, precision=_PREC)
    zc = zc / jnp.sqrt(jnp.matmul(wn, zc * zc, precision=_PREC))
    z2 = zc * zc
    zw = zc * wn[:, None]
    rho = jnp.matmul(zw.T, zc, precision=_PREC)
    k31 = jnp.matmul((z2 * zw).T, zc, precision=_PREC) - 3 * rho
    k22 = jnp.matmul((z2 * wn[:, None]).T, z2, precision=_PREC) - 1 - 2 * rho * rho
    return jnp.abs(k31) + jnp.abs(k31).T + jnp.abs(k22)


# ---------------------------------------------------------------------------
# range / N_eff estimation
# ---------------------------------------------------------------------------

_QBINS = 1024  # histogram resolution for quantile estimation


def _quantiles_from_hist(hist, edges_lo, width, probs):
    """Approximate weighted quantiles from a fine histogram: linear
    interpolation on the cumulative mass. probs: (Q,). Returns (Q,)."""
    cum = jnp.cumsum(hist)
    norm = cum[-1]
    targets = probs * norm
    ix = jnp.clip(jnp.searchsorted(cum, targets), 0, _QBINS - 1)
    prev = jnp.where(ix > 0, cum[jnp.maximum(ix - 1, 0)], 0.0)
    frac = jnp.where(hist[ix] > 0, (targets - prev) / jnp.maximum(hist[ix], 1e-30), 0.0)
    return edges_lo + (ix + frac) * width


def _lag_grid(n, max_lag=None, num=40):
    """Static log-spaced lag grid for the N_eff estimator, spanning lags
    1 .. n//10 (the reference's maxoff cap, chains.py:506)."""
    top = max(n // 10, 2)
    if max_lag is not None:
        top = min(max_lag, top)
    ks = np.unique(np.geomspace(1, top, num).astype(np.int64))
    return tuple(int(k) for k in ks)


def _neff_kde_batch(values, weights, sigmas, lags, axis_name=None, axis_size=1):
    """Gaussian-KDE effective sample numbers for all parameters.

    Approximates the reference estimator (``chains.py:477-574``) on a fixed
    log-spaced lag grid: corr_k pair sums with an uncorrelated baseline,
    trapezoid-integrated over lags until the first drop below
    min_corr * corr0 (masked, so fully vectorized). The lag loop runs as a
    single lax.map body with a traced roll shift (an unrolled python loop
    here costs minutes of XLA compile time).
    values: (P, N), sigmas: (P,) fiducial scales. Returns (P,).

    Sharded mode (``axis_name`` set, ``axis_size`` = mesh size): each shard
    fetches the next shard's first max(lags) columns by ``ppermute`` (the
    last shard receives zero weights, which exactly zero the out-of-range
    pair terms), computes its local lag sums over the haloed block, and the
    per-lag sums are ``psum``'d — so the short-lag pair sums are the true
    global sums, not a weight proxy. The uncorrelated far-lag baseline
    (global lag ~ N/2, as the reference uses) pairs each shard with the
    shard half a mesh away via a second ppermute, so it too sums the same
    global pairs as the single-device estimator.
    """
    n = values.shape[1]
    min_corr = 0.05
    # h = 0.2 of the quantile structure scale, as the reference passes
    # scale=par.sigma_range (mcsamples.py:1233)
    kernel_std = sigmas * 0.2
    inv2 = 1.0 / (4.0 * kernel_std**2)

    def _ps(v):
        return jax.lax.psum(v, axis_name) if axis_name else v

    max_lag = int(max(lags))
    if axis_name is not None and axis_size > 1:
        # halo: receive the next shard's leading block; the last shard gets
        # zeros (no wraparound pairs), whose zero weights kill those terms
        perm = [(d, d - 1) for d in range(1, axis_size)]
        halo_v = jax.lax.ppermute(values[:, :max_lag], axis_name, perm)
        halo_w = jax.lax.ppermute(weights[:max_lag], axis_name, perm)
        ext_values = jnp.concatenate([values, halo_v], axis=1)
        ext_weights = jnp.concatenate([weights, halo_w])
    else:
        ext_values = values
        ext_weights = weights

    n_ext = ext_values.shape[1]

    def corr_at(k):
        # pairs (i, i+k) for local i in [0, n); in sharded mode i+k indexes
        # the halo, in local mode the validity mask cuts the wraparound
        k0 = jnp.zeros((), k.dtype)
        shifted = jax.lax.dynamic_slice(ext_values, (k0, k), values.shape) if n_ext > n else jnp.roll(
            values, -k, axis=1
        )
        w_shift = jax.lax.dynamic_slice(ext_weights, (k,), (n,)) if n_ext > n else jnp.roll(weights, -k)
        valid = jnp.ones((1, n), bool) if n_ext > n else (jnp.arange(n) < n - k)[None, :]
        diff2 = (values - shifted) ** 2 * inv2[:, None]
        return jnp.sum(jnp.where(valid, jnp.exp(-diff2) * weights[None, :] * w_shift[None, :], 0.0), axis=1)

    # uncorrelated baseline: 5 lags at the global half-length, as the
    # reference does (chains.py:512-519). Sharded: pair with the shard half
    # a mesh away so the SAME global pairs are summed.
    n_base = 5
    if axis_name is not None and axis_size > 1:
        half = axis_size // 2
        far_v = jax.lax.ppermute(values, axis_name, [(d, d - half) for d in range(half, axis_size)])
        far_w = jax.lax.ppermute(weights, axis_name, [(d, d - half) for d in range(half, axis_size)])
        head = n_base + 2
        nxt_v = jax.lax.ppermute(
            values[:, :head], axis_name, [(d, d - half - 1) for d in range(half + 1, axis_size)]
        )
        nxt_w = jax.lax.ppermute(
            weights[:head], axis_name, [(d, d - half - 1) for d in range(half + 1, axis_size)]
        )
        base_v = jnp.concatenate([far_v, nxt_v], axis=1)
        base_w = jnp.concatenate([far_w, nxt_w])
        uncorr_len = half * n  # global lag of the offset-0 partner (~N/2)
    else:
        base_v = values
        base_w = weights
        uncorr_len = n // 2

    n_global = axis_size * n

    def base_at(j):
        # partner offset within the half-shifted block; non-existent
        # partners carry ppermute-zero weights and vanish from the sum
        if axis_name is not None and axis_size > 1:
            part = jax.lax.dynamic_slice(base_v, (0, j), values.shape)
            pw = jax.lax.dynamic_slice(base_w, (j,), (n,))
            valid = jnp.ones((1, n), bool)
        else:
            k = uncorr_len + j
            part = jnp.roll(values, -k, axis=1)
            pw = jnp.roll(weights, -k)
            valid = (jnp.arange(n) < n - k)[None, :]
        diff2 = (values - part) ** 2 * inv2[:, None]
        return jnp.sum(jnp.where(valid, jnp.exp(-diff2) * weights[None, :] * pw[None, :], 0.0), axis=1)

    uncorr = _ps(sum(base_at(j) for j in range(n_base)))
    nav = sum(n_global - (uncorr_len + j) for j in range(n_base))
    uncorr_term = uncorr / nav

    corr0 = _ps(jnp.sum(weights * weights))
    lags_arr = jnp.asarray(np.array(lags, np.int32))
    corr_k = _ps(jax.lax.map(corr_at, lags_arr))  # (L, P)
    # expected pair count at lag k (the halo supplies cross-shard pairs;
    # only the final shard's tail is missing)
    n_pairs_k = axis_size * n - lags_arr[:, None]
    corr_k = corr_k - n_pairs_k * uncorr_term[None, :]
    threshold = min_corr * corr0
    alive = jnp.cumprod(corr_k >= threshold, axis=0).astype(corr_k.dtype)  # stop at first drop
    contrib = corr_k * alive
    # trapezoid over the (uneven) lag grid
    steps = np.diff(np.concatenate([[0], np.asarray(lags)])).astype(np.float64)
    weights_lag = jnp.asarray((steps + np.append(np.diff(np.asarray(lags)), 0)) / 2.0)
    total = corr0 + 2.0 * jnp.sum(contrib * weights_lag[:, None], axis=0)
    norm = _ps(jnp.sum(weights))
    return norm**2 / total


# ---------------------------------------------------------------------------
# ISJ bandwidths (jitted)
# ---------------------------------------------------------------------------


def _isj_log_gamma(h2_pi2, big_i, log_i, log_a2, neff):
    """log of the gamma functional chain of the 1D ISJ fixed point
    (vectorized over the DCT modes); h2_pi2 = pi^2 h^2.

    Everything stays in log space via log-sum-exp: the naive chain
    evaluates exp(LMAX*log_i - damping), and when the expression sits in a
    program with the bisection while_loop, XLA may hoist the
    loop-invariant exp(LMAX*log_i) factor (= i^14, inf above i~563 in f32)
    out of the damped product — the small-h residuals silently corrupt,
    the root bracket is missed, and multimodal shapes fall back to the
    rule of thumb (~6x oversmoothing on zoo 'trimodal').
    Bounded exponents make the computation immune to such rewrites."""

    def log_f(j, t):
        e = j * log_i - big_i * t + log_a2
        m = jnp.max(e)
        return jnp.log(jnp.sum(jnp.exp(e - m))) + m + np.log(2.0) + 2 * j * np.log(np.pi)

    lf = log_f(jnp.asarray(float(_ISJ_LMAX), big_i.dtype), h2_pi2)
    log_neff = jnp.log(neff)
    for j, const in zip(range(_ISJ_LMAX - 1, 1, -1), _ISJ_CONSTS):
        log_t = (2.0 / (3.0 + 2 * j)) * (np.log(const) - log_neff - lf)
        lf = log_f(jnp.asarray(float(j), big_i.dtype), _PI_SQ * jnp.exp(log_t))
    return lf


def _isj_bandwidth_1d(bins, neff):
    """Jitted ISJ bandwidth (fraction of bin range) by bisection on
    f(h) = h - (2 N sqrt(pi) gamma(h))^{-1/5}. Returns (h, ok)."""
    nb = bins.shape[0]
    big_i = (jnp.arange(1, nb, dtype=bins.dtype)) ** 2
    log_i = jnp.log(big_i)
    a = dct(bins / jnp.sum(bins))
    a2 = (a[1:] / 2) ** 2
    log_a2 = jnp.log(a2)  # -inf rows (zero coefficients) drop out of the LSE
    log_norm = jnp.log(2 * neff * _ROOT_PI)

    def residual(h):
        lf = _isj_log_gamma(_PI_SQ * h**2, big_i, log_i, log_a2, neff)
        return h - jnp.exp(-0.2 * (log_norm + lf))

    n_scale = neff ** (-1.0 / 5)
    # bracket the root by scanning a log grid of seeds: a two-endpoint
    # bracket is brittle in f32 (XLA fusion inside the full program can
    # flip a ~1e-3 residual at the lower endpoint, silently forcing the
    # rule-of-thumb fallback and ~2x oversmoothing on multimodal shapes)
    # lower endpoint stays above the spurious-root regime (the reference's
    # fsolve start is 0.019 N^{-1/5}, kde_bandwidth.py)
    lo0 = 0.019 * n_scale
    hi0 = 0.6
    n_seed = 16
    seeds = lo0 * (hi0 / lo0) ** jnp.linspace(0.0, 1.0, n_seed, dtype=bins.dtype)
    rs = jax.lax.map(residual, seeds)
    cross = (rs[:-1] < 0) & (rs[1:] >= 0)
    ok = jnp.any(cross)
    first = jnp.argmax(cross)
    lo = seeds[first]
    hi = seeds[first + 1]
    f_lo = rs[first]

    def body(state):
        lo_, hi_, _ = state
        mid = 0.5 * (lo_ + hi_)
        f_mid = residual(mid)
        new_lo = jnp.where(f_mid < 0, mid, lo_)
        new_hi = jnp.where(f_mid < 0, hi_, mid)
        return new_lo, new_hi, f_mid

    def cond(state):
        lo_, hi_, _ = state
        return (hi_ - lo_) > 1e-7 * n_scale

    lo_f, hi_f, _ = jax.lax.while_loop(cond, body, (lo, hi, f_lo))
    h = 0.5 * (lo_f + hi_f)
    # fallback: 1.06 sigma-ish rule handled by caller when not ok
    return h, ok


def _psi_2d(s0, s1, time, big_i, log_i, a2):
    w = -big_i * (_PI_SQ * time)
    wx = jnp.exp(w + log_i * s0)
    wy = jnp.exp(w + log_i * s1)
    return (
        (-1) ** (s0 + s1)
        * jnp.dot(jnp.dot(wy, a2, precision=_PREC), wx, precision=_PREC)
        * np.pi ** (2 * (s0 + s1))
        / 4
    )


def _func2d(s0, s1, t, big_i, log_i, a2, neff):
    """Static-depth unrolled 2D plug-in recursion (reference
    ``kde_bandwidth.py:188-196``)."""
    sums = s0 + s1
    if sums <= 4:
        sum_func = _func2d(s0 + 1, s1, t, big_i, log_i, a2, neff) + _func2d(s0, s1 + 1, t, big_i, log_i, a2, neff)
        const = (1 + 0.5 ** (sums + 1)) / 3
        time = (-2 * const * _K_EVEN[s0] * _K_EVEN[s1] / neff / sum_func) ** (1.0 / (2 + sums))
        return _psi_2d(s0, s1, time, big_i, log_i, a2)
    return _psi_2d(s0, s1, t, big_i, log_i, a2)


def _isj_bandwidth_2d(hist, neff):
    """Jitted 2D ISJ diagonal bandwidths (fractions of the bin ranges):
    t* by bisection on the 2D fixed point, then the closed-form (hx, hy).
    Returns (hx, hy, ok)."""
    size = hist.shape[0]
    big_i = (jnp.arange(1, size, dtype=hist.dtype)) ** 2
    log_i = jnp.log(big_i)
    a2 = dct(dct(hist / jnp.sum(hist), axis=0), axis=1)[1:, 1:] ** 2

    def fixed_point(t):
        sum_func = (
            _func2d(0, 2, t, big_i, log_i, a2, neff)
            + _func2d(2, 0, t, big_i, log_i, a2, neff)
            + 2 * _func2d(1, 1, t, big_i, log_i, a2, neff)
        )
        time = (2 * np.pi * neff * sum_func) ** (-1.0 / 3)
        return (t - time) / time

    lo, hi = 1e-8, 0.1
    f_lo = fixed_point(lo)
    f_hi = fixed_point(hi)
    ok = (f_lo < 0) & (f_hi > 0)

    def body(state):
        lo_, hi_ = state
        mid = 0.5 * (lo_ + hi_)
        f_mid = fixed_point(mid)
        return jnp.where(f_mid < 0, mid, lo_), jnp.where(f_mid < 0, hi_, mid)

    lo_f, hi_f = jax.lax.while_loop(lambda st: (st[1] - st[0]) > 1e-6, body, (lo, hi))
    t_star = 0.5 * (lo_f + hi_f)

    p_02 = _func2d(0, 2, t_star, big_i, log_i, a2, neff)
    p_20 = _func2d(2, 0, t_star, big_i, log_i, a2, neff)
    p_11 = _func2d(1, 1, t_star, big_i, log_i, a2, neff)
    denom = 4 * np.pi * neff * (p_11 + jnp.sqrt(p_20 * p_02))
    h_x = (p_02 ** (3.0 / 4) / (denom * p_20 ** (3.0 / 4))) ** (1.0 / 6)
    h_y = (p_20 ** (3.0 / 4) / (denom * p_02 ** (3.0 / 4))) ** (1.0 / 6)
    ok = ok & jnp.isfinite(h_x) & jnp.isfinite(h_y) & (h_x > 0) & (h_y > 0)
    return h_x, h_y, ok


# ---------------------------------------------------------------------------
# full 2D kernel optimizer (device twin of kde_bandwidth.KernelOptimizer2D)
# ---------------------------------------------------------------------------

# odd-order kernel constants phi-odd[j] (reference kde_bandwidth.py:198-213)
_K_ODD = tuple(
    [1.0] + [np.prod(np.arange(1, 2 * j, 2)) / 2.0 ** (j + 1) / _ROOT_PI for j in range(1, 9)]
)
_EVEN_LEVELS = {lv: [(i, lv - i) for i in range(lv + 1)] for lv in range(6)}
_ODD_LEVELS = {
    10: ((7, 3), (5, 5), (3, 7), (1, 9), (9, 1)),
    8: ((5, 3), (3, 5), (1, 7), (7, 1)),
    6: ((3, 3), (1, 5), (5, 1)),
    4: ((1, 3), (3, 1)),
}


def _even_table_2d(psi_multi, neff, t_star, min_level=0):
    """Level-by-level plug-in table of the even psi functionals (device
    twin of kde_bandwidth._even_table; each functional evaluated once).

    psi_multi(keys, ts) evaluates a whole level's functionals in one
    contraction: the spectrum array is the dominant HBM traffic, so each
    level reads it once instead of once per functional."""
    keys = _EVEN_LEVELS[5]
    table = dict(zip(keys, psi_multi(keys, [t_star] * len(keys))))
    for level in range(4, min_level - 1, -1):
        const = (1 + 0.5 ** (level + 1)) / 3
        keys = _EVEN_LEVELS[level]
        ts = []
        for sx, sy in keys:
            children = table[(sx + 1, sy)] + table[(sx, sy + 1)]
            ts.append((-2 * const * _K_EVEN[sx] * _K_EVEN[sy] / neff / children) ** (1.0 / (2 + level)))
        table.update(zip(keys, psi_multi(keys, ts)))
    return table


def _psi_multi_dct(a2, big_i, log_i, orders, ts):
    """Batch-evaluate even psi functionals on a squared-DCT spectrum (the
    reference convention, exact for bounded densities): ONE pass over the
    (big) a2 array per call."""
    t_vec = jnp.stack([jnp.asarray(t, a2.dtype) for t in ts])  # (k,)
    damp = -big_i[None, :] * (_PI_SQ * t_vec[:, None])  # (k, F)
    wx = jnp.exp(damp + log_i[None, :] * jnp.asarray([s[0] for s in orders], a2.dtype)[:, None])
    wy = jnp.exp(damp + log_i[None, :] * jnp.asarray([s[1] for s in orders], a2.dtype)[:, None])
    g = jnp.matmul(a2, wx.T, precision=_PREC)  # (F, k): the single pass over the spectrum
    vals = jnp.sum(wy.T * g, axis=0)
    scale = np.array([(-1) ** (s[0] + s[1]) * np.pi ** (2 * (s[0] + s[1])) / 4 for s in orders], np.float64)
    return vals * jnp.asarray(scale, a2.dtype)


def _psi_multi_pow(power, freqs, exponents, ts, signs):
    """Batch-evaluate psi functionals on an FFT power spectrum: ONE pass
    over the (big) power array per call. power is laid out [f_y, f_x];
    weights are damp * f^exponent per axis; ``signs`` carries each
    functional's derivative-parity sign."""
    t_vec = jnp.stack([jnp.asarray(t, power.dtype) for t in ts])  # (k,)
    damp = jnp.exp(-(freqs[None, :] ** 2) * (4 * _PI_SQ) * t_vec[:, None])  # (k, F)
    wx = damp * jnp.stack([freqs ** s[0] for s in exponents])
    wy = damp * jnp.stack([freqs ** s[1] for s in exponents])
    g = jnp.matmul(power, wx.T, precision=_PREC)  # (F, k): the single pass over the spectrum
    vals = jnp.sum(wy.T * g, axis=0)  # (k,)
    scale = np.array(
        [sg * (2 * np.pi) ** (s[0] + s[1]) for s, sg in zip(exponents, signs)], np.float64
    )
    return vals * jnp.asarray(scale, power.dtype)


def _odd_table_2d(power, freqs, neff, p00, t_star):
    """Plug-in table for the odd functionals psi_13/psi_31 (device twin of
    kde_bandwidth._odd_table), level-batched like the even table.

    The power is antisymmetrized pairwise in each frequency sign BEFORE the
    weighted sums: an odd functional is a near-total cancellation between
    ±f terms of the (symmetric-dominated) power, and letting that
    cancellation happen across the full f32 accumulation loses it entirely
    (measured 4000x error on multimodal histograms, which silently disabled
    the kernel-correlation search on f32 backends). Elementwise pairing
    makes every term of the remaining sum carry the same sign."""

    def negate_axis(m, axis):
        return jnp.roll(jnp.flip(m, axis=axis), 1, axis=axis)

    power = 0.5 * (power - negate_axis(power, 0))
    power = 0.5 * (power - negate_axis(power, 1))
    keys = _ODD_LEVELS[10]
    ones = [1.0] * len(keys)
    table = dict(zip(keys, _psi_multi_pow(power, freqs, keys, [t_star] * len(keys), ones)))
    for level in (8, 6, 4):
        const = 8 * (1 - 2.0 ** (-level - 1)) / 3.0
        keys = _ODD_LEVELS[level]
        ts = []
        for sx, sy in keys:
            children = table[(sx + 2, sy)] + table[(sx, sy + 2)]
            ts.append((const * p00 * _K_ODD[sx] * _K_ODD[sy] / neff**2 / children**2) ** (1.0 / (3 + level)))
        table.update(zip(keys, _psi_multi_pow(power, freqs, keys, ts, [1.0] * len(keys))))
    return table


def _amise_2d(wx, wy, rho, p, neff):
    """Asymptotic MISE for a correlated Gaussian kernel (reference
    kde_bandwidth.py:216-233); p = (p40, p04, p22, p31, p13)."""
    p40, p04, p22, p31, p13 = p
    variance = 1.0 / (4 * np.pi * wx * wy * jnp.sqrt(1 - rho**2) * neff)
    quartic = (
        wx**4 * p40
        + wy**4 * p04
        + 2 * wx**2 * wy**2 * p22 * (2 * rho**2 + 1)
        + 4 * rho * wx * wy * (wx**2 * p31 + wy**2 * p13)
    )
    return variance + 0.25 * quartic, 0.25 * quartic


_W_LO, _W_HI = 1e-3, 0.3


def _amise_minimize(p, neff, wx0, wy0, rho0, free_rho, iters=60):
    """Fixed-iteration bounded AMISE minimization (role of the reference's
    TNC search, kde_bandwidth.py:289-306): widths via log-sigmoid transform,
    correlation via scaled tanh; backtracking gradient descent, jit-safe.

    The free-correlation search is multi-started over a spread of kernel
    correlations: the AMISE surface has separated basins in rho for
    multimodal densities, and a single gradient descent from rho0 misses
    the global one (the reference's TNC escapes via its curvature model)."""

    def to_u(w):
        frac = jnp.clip((w - _W_LO) / (_W_HI - _W_LO), 1e-6, 1 - 1e-6)
        return jnp.log(frac / (1 - frac))

    def from_u(u):
        return _W_LO + (_W_HI - _W_LO) * jax.nn.sigmoid(u)

    rho_cap = 0.99

    def objective(z):
        wx, wy = from_u(z[0]), from_u(z[1])
        rho = jnp.where(free_rho, rho_cap * jnp.tanh(z[2]), rho0)
        val, _ = _amise_2d(wx, wy, rho, p, neff)
        return val

    grad = jax.grad(objective)

    def body(_, state):
        z, step = state
        g = grad(z)
        cand = z - step * g
        better = objective(cand) < objective(z)
        z = jnp.where(better, cand, z)
        step = jnp.where(better, step * 1.2, step * 0.5)
        return z, step

    def solve(z0):
        z, _ = jax.lax.fori_loop(0, iters, body, (z0, jnp.asarray(0.25, z0.dtype)))
        return z, objective(z)

    u0 = jnp.arctanh(jnp.clip(rho0 / rho_cap, -0.999, 0.999))
    rho_seeds = jnp.stack([u0] + [jnp.full_like(u0, jnp.arctanh(r / rho_cap)) for r in (-0.75, -0.35, 0.35, 0.75)])
    # when the correlation is pinned (free_rho False) every seed collapses
    # to the same problem, so the multi-start is a no-op there
    starts = jnp.stack([jnp.full_like(rho_seeds, to_u(wx0)), jnp.full_like(rho_seeds, to_u(wy0)), rho_seeds], axis=1)
    zs, vals = jax.vmap(solve)(starts)
    z = zs[jnp.argmin(vals)]
    wx, wy = from_u(z[0]), from_u(z[1])
    rho = jnp.where(free_rho, rho_cap * jnp.tanh(z[2]), rho0)
    val, bias = _amise_2d(wx, wy, rho, p, neff)
    ok = jnp.isfinite(val) & (bias > 0)
    return wx, wy, rho, val, ok


def _kernel_bandwidth_2d(hist, neff, sample_corr, do_correlation, fallback_t=None, power_override=None, use_override=False):
    """(hx, hy, c, ok): the full 2D bandwidth-matrix optimization on device.

    Mirrors kde_bandwidth.KernelOptimizer2D.get_h: t* by bisection on the
    2D fixed point (plug-in ``fallback_t`` replacing a failed or badly
    overshooting fixed point), closed-form diagonal widths, then (where
    ``do_correlation``, a traced per-call bool) AMISE searches at the
    sample correlation and with free correlation (the latter accepted only
    on a >10% AMISE win).

    With ``use_override`` (traced bool) the functionals are evaluated on
    ``power_override`` (a DC-zeroed FFT power spectrum, e.g. the sheared
    spectrum from :func:`_sheared_power`) instead of the histogram's own
    spectra — the numerically-verified FFT twin of the DCT convention."""
    size = hist.shape[0]
    dtype = hist.dtype
    normed = hist / jnp.sum(hist)
    big_i = (jnp.arange(1, size, dtype=dtype)) ** 2
    log_i = jnp.log(big_i)
    a2 = dct(dct(normed, axis=0), axis=1)[1:, 1:] ** 2
    freqs = jnp.fft.fftfreq(size, d=1.0 / size).astype(dtype)
    spec = jnp.fft.fft2(normed)
    power_plain = (spec * jnp.conj(spec)).real
    power_plain = power_plain.at[0, :].set(0.0).at[:, 0].set(0.0)
    if power_override is not None:
        power = jnp.where(use_override, power_override, power_plain)
    else:
        power = power_plain

    def psi_even_multi(keys, ts):
        # DCT convention (exact for bounded densities, reference semantics);
        # sheared pairs evaluate on their frequency-sheared FFT power instead
        # (verified equal to 1e-4 for interior densities)
        from_dct = _psi_multi_dct(a2, big_i, log_i, keys, ts)
        if power_override is None:
            return from_dct
        doubled = [(2 * s[0], 2 * s[1]) for s in keys]
        signs = [(-1.0) ** (s[0] + s[1]) for s in keys]
        from_pow = _psi_multi_pow(power, freqs, doubled, ts, signs)
        return jnp.where(use_override, from_pow, from_dct)

    def fixed_point(t):
        table = _even_table_2d(psi_even_multi, neff, t, min_level=2)
        curvature = table[(0, 2)] + table[(2, 0)] + 2 * table[(1, 1)]
        implied = (2 * np.pi * neff * curvature) ** (-1.0 / 3)
        return (t - implied) / implied

    lo, hi = 1e-8, 0.1
    ok = (fixed_point(lo) < 0) & (fixed_point(hi) > 0)

    def body(state):
        lo_, hi_ = state
        mid = 0.5 * (lo_ + hi_)
        below = fixed_point(mid) < 0
        return jnp.where(below, mid, lo_), jnp.where(below, hi_, mid)

    lo_f, hi_f = jax.lax.while_loop(lambda st: (st[1] - st[0]) > 1e-6, body, (lo, hi))
    t_star = 0.5 * (lo_f + hi_f)
    if fallback_t is not None:
        # replace a failed bracket or a badly overshooting fixed point with
        # the plug-in width (reference kde_bandwidth.py:264-276)
        overshoot = (t_star > 0.01) & (t_star > 2 * fallback_t)
        t_star = jnp.where(ok & ~overshoot, t_star, fallback_t)
        ok = jnp.asarray(True)

    table = _even_table_2d(psi_even_multi, neff, t_star)
    pyy, pxx, pxy = table[(0, 2)], table[(2, 0)], table[(1, 1)]
    cross = pxy + jnp.sqrt(pxx * pyy)
    denom = 4 * np.pi * neff * cross
    wx = (pyy ** (3.0 / 4) / (denom * pxx ** (3.0 / 4))) ** (1.0 / 6)
    wy = (pxx ** (3.0 / 4) / (denom * pyy ** (3.0 / 4))) ** (1.0 / 6)
    ok = ok & jnp.isfinite(wx) & jnp.isfinite(wy) & (wx > 0) & (wy > 0)
    wx = jnp.where(ok, wx, 0.05)
    wy = jnp.where(ok, wy, 0.05)

    # odd functionals from the (possibly sheared) FFT power spectrum
    p00 = table[(0, 0)]
    odd = _odd_table_2d(power, freqs, neff, p00, t_star)
    # Cauchy-Schwarz bound |psi_31| <= sqrt(psi_40 psi_22) (the functionals
    # are inner products of density derivatives): the odd part of the power
    # can sit below the f32 FFT noise floor, and an unbounded noise value
    # (observed 1000x the bound on multimodal histograms) would otherwise
    # dominate the AMISE correlation search
    bound_31 = jnp.sqrt(pxx * pxy)
    bound_13 = jnp.sqrt(pyy * pxy)
    # the clamp binding means the raw f32 value exceeded a rigorous bound,
    # i.e. the odd functionals are pure accumulation noise and the
    # correlation search below runs blind: flag such pairs FRAGILE so the
    # caller can route their bandwidths through the f64 host optimizer
    # (observed: zoo 'rotating'/'trimodal WJ2', where host and device pick
    # opposite-sign kernel correlations and the grids differ by ~2e-2)
    clamp_bind = (jnp.abs(odd[(3, 1)]) > bound_31) | (jnp.abs(odd[(1, 3)]) > bound_13)
    p = (pxx, pyy, pxy, jnp.clip(odd[(3, 1)], -bound_31, bound_31), jnp.clip(odd[(1, 3)], -bound_13, bound_13))

    best, _ = _amise_2d(wx, wy, jnp.zeros_like(wx), p, neff)
    rho = jnp.zeros_like(wx)
    # search 1: kernel correlation fixed at the sample correlation
    has_corr = jnp.abs(sample_corr) > 1e-12
    shrink = jnp.sqrt(1 - jnp.abs(sample_corr))
    wx1, wy1, rho1, val1, ok1 = _amise_minimize(
        p, neff, wx / shrink, wy / shrink, sample_corr, jnp.asarray(False)
    )
    take1 = do_correlation & has_corr & ok1 & (val1 < best)
    wxc = jnp.where(take1, wx1, wx)
    wyc = jnp.where(take1, wy1, wy)
    rho = jnp.where(take1, rho1, rho)
    best = jnp.where(take1, val1, best)
    # search 2: free correlation, accepted only on a clear (10%) win
    wx2, wy2, rho2, val2, ok2 = _amise_minimize(p, neff, wxc, wyc, sample_corr, jnp.asarray(True))
    take2 = do_correlation & ok2 & (val2 < best * 0.9)
    # acceptance knife edge: a small f32 shift of the AMISE values flips
    # the 10%-win decision (and with it the kernel correlation), so treat
    # the band around the threshold as fragile too
    # FRAGILE = the correlation search ran blind in f32 (odd-psi clamp
    # bound) AND its free-correlation stage misbehaved: failed outright
    # (minimize diverged / unphysical non-positive AMISE - the signature on
    # multimodal spectra, where f64 succeeds and picks a materially
    # different kernel correlation), made no progress at all (zoo
    # 'trimodal WJ2'), or sat in a tight band around the 10%-win acceptance
    # threshold where an f32-sized shift flips the decision.  The caller
    # additionally gates on a host non-Gaussianity score (cross-cumulants,
    # mcsamples._fast_regrid_pairs) before paying the f64 host assist:
    # benign Gaussian-ish pairs can flag blind here, but host and device
    # then agree on rho ~ 0 anyway.
    # "healthy" free search: converged, physical value, real progress over
    # the incumbent (a garbage f32 evaluation shows up as non-positive OR
    # bigger than the value it started from - XLA fusion differences flip
    # the garbage's sign, so test both), and clear of the threshold band
    edge_band = (val2 > best * 0.88) & (val2 < best * 0.92)
    good2 = ok2 & (val2 > 0) & (val2 <= best * 0.98) & ~edge_band
    fragile = do_correlation & clamp_bind & ~good2
    if os.environ.get("GETDIST_TPU_FRAGILE_SIGNAL") == "debug":
        fragile = jnp.stack([
            rho, rho2, val2 / best, clamp_bind.astype(rho.dtype),
            ok2.astype(rho.dtype), take2.astype(rho.dtype),
        ])
    wxc = jnp.where(take2, wx2, wxc)
    wyc = jnp.where(take2, wy2, wyc)
    rho = jnp.where(take2, rho2, rho)
    return wxc, wyc, rho, ok, fragile


def _shear_plan_2d(cov_aa, cov_ab, cov_bb, swap):
    """Per-pair shear decomposition (reference mcsamples.py:1347-1391).

    With swap the roles of (a, b) are exchanged first (the reference puts
    the hard-limited parameter first so the shear keeps its bounds exact).
    Returns (r0, r1, S) with sheared second coordinate p2 = r0*p_i + r1*p_j
    and S the scaled Cholesky root mapping kernel covariances back."""
    caa = jnp.where(swap, cov_bb, cov_aa)
    cbb = jnp.where(swap, cov_aa, cov_bb)
    s00 = jnp.sqrt(caa)
    s10 = cov_ab / s00
    s11 = jnp.sqrt(cbb - s10**2)
    # inverse Cholesky entries: ichol00 = 1/s00, ichol10 = -s10/(s00*s11), ichol11 = 1/s11
    i00 = 1.0 / s00
    r0 = (-s10 / (s00 * s11)) / i00
    r1 = (1.0 / s11) / i00
    s_mat = jnp.array([[s00, jnp.zeros_like(s00)], [s10, s11]]) * i00
    return r0, r1, s_mat


def _shear_kernel_back(hx, hy, c, s_mat, swap):
    """Map sheared-space kernel (hx, hy, c) back through S (data units)."""
    k00 = hx**2
    k01 = hx * hy * c
    k11 = hy**2
    kc = jnp.matmul(
        jnp.matmul(s_mat, jnp.array([[k00, k01], [k01, k11]]), precision=_PREC),
        s_mat.T,
        precision=_PREC,
    )
    out_hx = jnp.sqrt(kc[0, 0])
    out_hy = jnp.sqrt(kc[1, 1])
    out_c = kc[0, 1] / (out_hx * out_hy)
    # undo the swap so (hx, hy) refer to (a, b) again
    fx = jnp.where(swap, out_hy, out_hx)
    fy = jnp.where(swap, out_hx, out_hy)
    return fx, fy, out_c


def _sheared_power(hist, xc_a, xc_b, r0, r1, swap):
    """Power spectrum of the sheared pair density, computed EXACTLY in
    frequency space (no spatial resample): shearing coordinates is a linear
    frequency change, so the sheared spectrum is the unsheared histogram's
    non-uniform DFT, evaluated as two matmuls. The role of the
    reference's sheared re-binning (mcsamples.py:1372-1375).

    The p2 grid range comes from the mass-weighted p2 moments with the same
    sigma coverage as the p1 axis (mirroring the reference's rebinning of
    p2 over its own sample range). Returns (P[f_p2, f_p1] with the DC line
    zeroed to match the DCT-convention even functionals, range1, range2).
    """
    size = hist.shape[0]
    # hist rows are b, columns a; in sheared space p1 is a (or b when swap)
    h = jnp.where(swap, hist.T, hist)
    first = jnp.where(swap, xc_b, xc_a)  # (size,) centers of p1 (columns)
    second = jnp.where(swap, xc_a, xc_b)  # centers of the other coord (rows)
    p2 = r0 * first[None, :] + r1 * second[:, None]  # (size, size)
    step1 = first[1] - first[0]
    step2 = second[1] - second[0]
    # Both axis ranges follow the host path's kde_bandwidth.bin_samples
    # convention: occupied extent padded 10% per side. This matters twice:
    # the NUDFT below is periodic with period range, so a too-small range
    # aliases tail/mode mass (multimodal shapes were badly mis-measured by
    # a sigma-scaled p2 range), while a too-wide range (the full fine grid)
    # shifts the optimizer's range-relative width bounds and was observed
    # to destabilize the correlation search on bimodal shapes.
    occupied = h > 0
    p2_lo = jnp.min(jnp.where(occupied, p2, jnp.inf))
    p2_hi = jnp.max(jnp.where(occupied, p2, -jnp.inf))
    second_range = 1.2 * (p2_hi - p2_lo)
    first_range = first[-1] - first[0] + step1
    tot = jnp.sum(h)

    # s_hat[f1, f2] = sum_xy h[y, x] e^{-2 pi i [(f1 a + f2 b) x + (f2 c) y]}
    # (global phases drop out of the power)
    f = jnp.fft.fftfreq(size, d=1.0 / size).astype(hist.dtype)
    x = jnp.arange(size, dtype=hist.dtype)
    a_coef = step1 / first_range
    b_coef = r0 * step1 / second_range
    c_coef = r1 * step2 / second_range
    two_pi = 2 * np.pi
    cmat = jnp.exp(-1j * (two_pi * c_coef) * f[:, None] * x[None, :])  # (F2, y)
    g = jnp.matmul(cmat, h.astype(cmat.dtype), precision=_PREC)  # (F2, x)
    bmat = jnp.exp(-1j * (two_pi * b_coef) * f[:, None] * x[None, :])  # (F2, x)
    amat = jnp.exp(-1j * (two_pi * a_coef) * f[:, None] * x[None, :])  # (F1, x)
    s_hat = jnp.matmul(amat, (bmat * g).T, precision=_PREC)  # (F1, F2)
    power = (s_hat * jnp.conj(s_hat)).real / tot**2
    # orientation [f_p2, f_p1] to match the optimizer's (rows = y) layout;
    # zero the DC line so even functionals match the DCT convention
    power = power.T.at[0, :].set(0.0).at[:, 0].set(0.0)
    return power, first_range, second_range


# ---------------------------------------------------------------------------
# convolution + normalization
# ---------------------------------------------------------------------------


def _gauss_kernel_2d(rx, ry, corr, winw, dtype, support=None):
    """Anisotropic correlated Gaussian window on a fixed (2*winw+1)^2 grid,
    zeroed outside the per-pair effective support (2.5 * max(rx, ry) by
    default; parity mode passes the reference's exact integer half-width,
    round(2.5 * widest), so the truncation ring matches to the bin)."""
    idx = jnp.arange(-winw, winw + 1, dtype=dtype)
    iy = idx[:, None]
    ix = idx[None, :]
    det = (rx * ry) ** 2 * (1 - corr**2)
    # inverse of [[ry^2, rx ry c], [rx ry c, rx^2]] (y-major, reference mcsamples.py:1864)
    c00 = rx**2 / det
    c11 = ry**2 / det
    c01 = -rx * ry * corr / det
    q = iy**2 * c00 + ix**2 * c11 + 2 * c01 * iy * ix
    if support is None:
        support = jnp.maximum(rx, ry) * 2.5
    win = jnp.exp(-q / 2) * ((jnp.abs(iy) <= support) & (jnp.abs(ix) <= support))
    return win / jnp.sum(win)


@partial(jax.jit, static_argnames=("pad", "half_m"))
def _conv2d_same_kf(grids, kf, pad, half_m):
    """Batched 'same' convolution against a PRE-TRANSFORMED kernel spectrum
    (kf = rfftn of the centered (2*half_m+1)^2 kernels at size pad): the
    kernel FFT is the shared third of each convolution's cost."""
    n = grids.shape[-1]
    gf = jnp.fft.rfftn(grids, (pad, pad), axes=(1, 2))
    full = jnp.fft.irfftn(gf * kf, (pad, pad), axes=(1, 2))
    return jax.lax.dynamic_slice(full, (0, half_m, half_m), (grids.shape[0], n, n))


@partial(jax.jit, static_argnames=("pad",))
def _conv2d_same_batch(grids, kernels, pad):
    """Batched 'same' linear convolution via rFFT: grids (K, n, n),
    kernels (K, m, m) centered; pad >= n + m//2 guarantees no wrap."""
    m = kernels.shape[-1]
    kf = jnp.fft.rfftn(kernels, (pad, pad), axes=(1, 2))
    return _conv2d_same_kf(grids, kf, pad, (m - 1) // 2)


def _contour_levels_batch(grids, contours, iters=40):
    """Water-level contour levels by bisection (replaces sort+cumsum):
    find t per (grid, contour) with sum(P[P > t]) = contour * total, using
    the reference's half-weighted edges."""
    shaped = grids
    edge_weight = jnp.ones(shaped.shape[-2:])
    edge_weight = edge_weight.at[0, :].mul(0.5).at[-1, :].mul(0.5)
    edge_weight = edge_weight.at[:, 0].mul(0.5).at[:, -1].mul(0.5)
    weighted = shaped * edge_weight[None, :, :]
    norms = jnp.sum(weighted, axis=(1, 2))
    targets = contours[None, :] * norms[:, None]  # (K, C)
    lo = jnp.zeros_like(targets)
    hi = jnp.max(shaped, axis=(1, 2))[:, None] * jnp.ones_like(targets)

    def body(_, state):
        lo_, hi_ = state
        mid = 0.5 * (lo_ + hi_)
        # mass enclosed above level mid
        mass = jnp.sum(
            jnp.where(shaped[:, None, :, :] > mid[:, :, None, None], weighted[:, None, :, :], 0.0), axis=(2, 3)
        )
        too_much = mass > targets
        return jnp.where(too_much, mid, lo_), jnp.where(too_much, hi_, mid)

    lo_f, hi_f = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return 0.5 * (lo_f + hi_f)


# ---------------------------------------------------------------------------
# the fused pipelines
# ---------------------------------------------------------------------------


def prepare_chain(samples, weights, dtype=jnp.float32):
    """Move a chain to device: samples (N, P), weights (N,)."""
    return jnp.asarray(samples, dtype=dtype), jnp.asarray(weights, dtype=dtype)


@partial(jax.jit, static_argnames=("fine_bins", "mult_bias_order", "axis_name", "axis_size"))
def all_1d_densities(
    samples,
    weights,
    fine_bins=1024,
    mult_bias_order=1,
    limits_lo=None,
    limits_hi=None,
    periodic=None,
    axis_name=None,
    axis_size=1,
    neff_override=None,
    range_override=None,
    bandwidth_override=None,
    like_weights=None,
    bandwidth_scale=None,
):
    """All marginalized 1D densities in one program.

    Returns dict with 'x' (P, fine_bins) grids, 'P' (P, fine_bins)
    peak-normalized densities, 'neff' (P,), 'bandwidth' (P,) in parameter
    units. Pipeline per parameter (all vmapped): histogram-quantile ranges
    -> scatter-add binning -> ISJ bandwidth (bisection) with rule-of-thumb
    fallback -> FFT Gaussian convolution -> multiplicative bias correction
    -> peak normalization.

    limits_lo/limits_hi: optional (P,) hard prior bounds (NaN = unbounded).
    Active limits snap the grid edge to the bound and apply a first-order
    boundary-kernel correction (the role of the reference's
    ``mcsamples.py:1600-1647`` linear boundary correction), computed with
    analytic frequency-domain kernel moments instead of spatial masks.
    periodic: optional (P,) bools; periodic parameters (which must carry
    both limits) smooth circularly with period fine_bins-1 (the wrap bin is
    folded, as in the reference's periodic convolution mode) and skip
    boundary corrections.

    axis_name: when called inside shard_map with samples sharded on that
    mesh axis (``axis_size`` = mesh size), all sample reductions
    psum/pmin/pmax across shards and the grid-local stages run replicated;
    the KDE N_eff lag estimator runs with a ppermute halo so its short-lag
    pair sums are the true global sums. ``neff_override`` bypasses it.
    """
    n, p = samples.shape
    has_limits = limits_lo is not None or limits_hi is not None or periodic is not None
    if limits_lo is None:
        limits_lo = jnp.full((p,), jnp.nan, samples.dtype)
    if limits_hi is None:
        limits_hi = jnp.full((p,), jnp.nan, samples.dtype)
    per = jnp.zeros((p,), bool) if periodic is None else jnp.asarray(periodic)

    def _ps(v):
        return jax.lax.psum(v, axis_name) if axis_name else v

    cols = samples.T  # (P, N)
    norm = _ps(jnp.sum(weights))
    means = _ps(jnp.matmul(cols, weights, precision=_PREC)) / norm
    variances = _ps(jnp.matmul((cols - means[:, None]) ** 2, weights, precision=_PREC)) / norm
    sigmas = jnp.sqrt(variances)

    # ranges from histogram quantiles
    mins = jnp.min(cols, axis=1)
    maxs = jnp.max(cols, axis=1)
    if axis_name:
        mins = jax.lax.pmin(mins, axis_name)
        maxs = jax.lax.pmax(maxs, axis_name)
    spans = maxs - mins
    qwidth = spans / _QBINS

    def row_hists(ix_rows, w_in, nbins):
        return _ps(row_histograms(ix_rows, w_in, nbins))

    qix = jnp.clip(((cols - mins[:, None]) / qwidth[:, None]).astype(jnp.int32), 0, _QBINS - 1)
    qhists = row_hists(qix, weights, _QBINS)
    range_conf = 0.001
    probs = jnp.concatenate(
        [jnp.array([range_conf, 1 - range_conf], samples.dtype), jnp.linspace(0.1, 0.9, 9, dtype=samples.dtype)]
    )
    quants = jax.vmap(_quantiles_from_hist, in_axes=(0, 0, 0, None))(qhists, mins, qwidth, probs)
    # sigma_range: quantile-based structure scale (reference mcsamples.py
    # _initParam, Janssen-95-style peak search: min over 4-apart gaps of
    # [param_min, q(0.1..0.9), param_max])
    ladder = jnp.concatenate([mins[:, None], quants[:, 2:], maxs[:, None]], axis=1)  # (P, 11)
    gaps = ladder[:, 4:] - ladder[:, :-4]
    scale = jnp.min(gaps, axis=1) / 1.049
    very_flat = jnp.all(gaps > sigmas[:, None] * 1.049, axis=1) & jnp.all(gaps < scale[:, None] * 1.5, axis=1)
    sigma_range = jnp.where(very_flat, scale, jnp.minimum(sigmas, scale))
    # pad ranges as the reference does for unbounded parameters
    smooth_est = sigma_range * 0.4
    range_min = quants[:, 0] - smooth_est * 2
    range_max = quants[:, 1] + smooth_est * 2
    binmin = jnp.minimum(mins, range_min) - (range_max - range_min) * 0.1
    binmax = jnp.maximum(maxs, range_max) + (range_max - range_min) * 0.1
    if range_override is not None:
        # parity mode: host-exact grid ranges (sample-quantile based)
        binmin, binmax = range_override
    # hard limits cut the padded range; the limit is "active" when it binds
    # (periodic parameters always snap to their full period)
    active_lo = ~jnp.isnan(limits_lo) & (per | (jnp.where(jnp.isnan(limits_lo), -jnp.inf, limits_lo) > binmin))
    active_hi = ~jnp.isnan(limits_hi) & (per | (jnp.where(jnp.isnan(limits_hi), jnp.inf, limits_hi) < binmax))
    binmin = jnp.where(active_lo, jnp.where(jnp.isnan(limits_lo), binmin, limits_lo), binmin)
    binmax = jnp.where(active_hi, jnp.where(jnp.isnan(limits_hi), binmax, limits_hi), binmax)
    # boundary-kernel corrections apply only to non-periodic bounded params
    active_lo = active_lo & ~per
    active_hi = active_hi & ~per
    fine_width = (binmax - binmin) / (fine_bins - 1)

    fine_ix = jnp.clip(
        (((cols - binmin[:, None]) / fine_width[:, None]) + 0.5).astype(jnp.int32), 0, fine_bins - 1
    )
    bins = row_hists(fine_ix, weights, fine_bins)  # (P, fine_bins)
    like_bins = None if like_weights is None else row_hists(fine_ix, like_weights, fine_bins)

    # N_eff and ISJ bandwidths
    if neff_override is not None:
        neff = neff_override
    else:
        # the halo can be at most one shard long, so cap lags at the shard size
        lags = _lag_grid(n * axis_size, max_lag=n if axis_name else None)
        neff = _neff_kde_batch(cols, weights, sigma_range, lags, axis_name=axis_name, axis_size=axis_size)
    if bandwidth_override is not None:
        # parity mode: host-exact ISJ bandwidths (fractions of the bin range)
        h_frac = bandwidth_override
    else:
        h_frac, ok = jax.vmap(_isj_bandwidth_1d)(bins, neff)
        fallback = 1.06 * sigma_range * neff ** (-1.0 / 5) / (binmax - binmin)
        h_frac = jnp.where(ok & (h_frac > 0.01 * neff ** (-0.2) * 0.5), h_frac, fallback)
    if mult_bias_order:
        h_frac = h_frac * neff ** (1.0 / 5 - 1.0 / (4 * mult_bias_order + 5))
    if bandwidth_override is None:
        # the reference caps the auto bandwidth at a quarter of the range
        # (mcsamples.py:1571) BEFORE the smooth-scale multiplier; without
        # this the device oversmooths near-uniform bounded shapes (zoo 1D
        # 'flat': 344 vs the host's 256 fine-bin width)
        h_frac = jnp.minimum(h_frac, 0.25)
    if bandwidth_scale is not None:
        # MISE-sweep hook: reference smooth_scale_1D = -scale convention
        h_frac = h_frac * bandwidth_scale
    # kernel sigma in bin units (h is a fraction of the bin range)
    smooth_bins = jnp.clip(h_frac * fine_bins, 1.0, fine_bins // 2)

    # Gaussian convolution via frequency-domain multiplier (periodic pad is
    # safe: grids have 10% empty borders; with hard limits the data sits at
    # a centered offset so left/right outside regions are distinct)
    pad = int(2 ** np.ceil(np.log2(fine_bins * 1.25)))
    off = (pad - fine_bins) // 2 if has_limits else 0
    k = jnp.arange(pad // 2 + 1, dtype=samples.dtype)

    def smooth(b, sigma_bins):
        mult = jnp.exp(-2.0 * (np.pi * sigma_bins / pad) ** 2 * k**2)
        spec = jnp.fft.rfft(b, pad)
        return jnp.fft.irfft(spec * mult, pad)[off : off + fine_bins]

    if has_limits:
        # circular smoothing for periodic params: fold the duplicated wrap
        # bin and tile the data periodically into the pad borders (period
        # L = fine_bins - 1), so one linear FFT conv serves both modes
        L = fine_bins - 1
        rel = jnp.arange(pad) - off
        mod_idx = jnp.mod(rel, L)
        smooth_bins = jnp.where(per, jnp.minimum(smooth_bins, off / 4.0), smooth_bins)

        def _extend(rows):
            folded = rows.at[:, 0].add(rows[:, -1]).at[:, -1].set(0.0)
            per_ext = folded[:, mod_idx]
            plain_ext = jnp.zeros((p, pad), rows.dtype).at[:, off : off + fine_bins].set(rows)
            return jnp.where(per[:, None], per_ext, plain_ext)

        def _rewrap(c):
            # grid points 0 and fine_bins-1 are the same periodic point
            return c.at[:, -1].set(jnp.where(per, c[:, 0], c[:, -1]))

        bins_ext = _extend(bins)

        def smooth_ext(b_ext, sigma_bins):
            mult = jnp.exp(-2.0 * (np.pi * sigma_bins / pad) ** 2 * k**2)
            return jnp.fft.irfft(jnp.fft.rfft(b_ext) * mult, pad)[off : off + fine_bins]

        conv = _rewrap(jax.vmap(smooth_ext)(bins_ext, smooth_bins))
    else:
        conv = jax.vmap(smooth)(bins, smooth_bins)
    raw_conv = conv  # pre-correction smoothing (the meanlikes denominator)

    if has_limits:
        # first-order boundary-kernel correction (Jones 1993 linear boundary
        # kernel, as in the reference's order-1 branch): moments of the
        # Gaussian against the prior mask computed with analytic
        # frequency-domain kernel moments FT[x^m g]
        pos = jnp.arange(pad)
        mask_rows = jnp.ones((p, pad), samples.dtype)
        lo_cut = jnp.where(active_lo[:, None], jnp.where(pos[None, :] < off, 0.0, 1.0), 1.0)
        lo_half = jnp.where(active_lo[:, None] & (pos[None, :] == off), 0.5, 1.0)
        hi_cut = jnp.where(active_hi[:, None], jnp.where(pos[None, :] >= off + fine_bins, 0.0, 1.0), 1.0)
        hi_half = jnp.where(active_hi[:, None] & (pos[None, :] == off + fine_bins - 1), 0.5, 1.0)
        mask_rows = mask_rows * lo_cut * lo_half * hi_cut * hi_half

        def boundary_corrected(b_ext, m_row, p0, sigma_bins):
            c = 2.0 * (np.pi * sigma_bins / pad) ** 2
            g = jnp.exp(-c * k**2)
            # FT of x*g and x^2*g from derivatives of the Gaussian transform
            g1 = (-1j * (c * pad / np.pi) * k) * g
            g2 = (-((pad / (2 * np.pi)) ** 2) * (4 * c**2 * k**2 - 2 * c)) * g
            mspec = jnp.fft.rfft(m_row)
            bspec = jnp.fft.rfft(b_ext)
            sl = slice(off, off + fine_bins)
            a0 = jnp.fft.irfft(mspec * g, pad)[sl]
            a1 = jnp.fft.irfft(mspec * g1, pad)[sl]
            a2 = jnp.fft.irfft(mspec * g2, pad)[sl]
            xp = jnp.fft.irfft(bspec * g1, pad)[sl]
            good = (a0 > 1e-12) & (p0 > 0)
            a0s = jnp.where(good, a0, 1.0)
            normed = jnp.where(good, p0 / a0s, p0)
            denom = a0 * a2 - a1**2
            corrected = jnp.where(good & (jnp.abs(denom) > 1e-30), (p0 * a2 - xp * a1) / jnp.where(denom == 0, 1.0, denom), normed)
            fixed = normed * jnp.exp(jnp.minimum(corrected / jnp.where(normed == 0, 1.0, normed), 4) - 1)
            return jnp.where(good, fixed, p0)

        corrected = jax.vmap(boundary_corrected)(bins_ext, mask_rows, conv, smooth_bins)
        any_active = active_lo | active_hi
        conv = jnp.where(any_active[:, None], corrected, conv)

    if mult_bias_order:
        if has_limits:
            # the reference divides each bias round by the window-cut mask a0
            # (mcsamples.py:1650-1667); with hard limits the edge bin is
            # half-weighted and mass outside the grid is zero
            mb_inside = (pos >= off) & (pos < off + fine_bins)
            mask_mb = jnp.where(mb_inside[None, :], 1.0, 0.0).astype(conv.dtype)
            mask_mb = mask_mb * jnp.where(active_lo[:, None] & (pos[None, :] == off), 0.5, 1.0)
            mask_mb = mask_mb * jnp.where(active_hi[:, None] & (pos[None, :] == off + fine_bins - 1), 0.5, 1.0)

            def _smooth_ext_row(b_ext, s):
                mult = jnp.exp(-2.0 * (np.pi * s / pad) ** 2 * k**2)
                return jnp.fft.irfft(jnp.fft.rfft(b_ext) * mult, pad)[off : off + fine_bins]

            a0_mb = jax.vmap(_smooth_ext_row)(mask_mb, smooth_bins)
            a0_mb = jnp.where(a0_mb <= 1e-12, 1.0, a0_mb)
            a0_mb = jnp.where(per[:, None], 1.0, a0_mb)  # no edges on periodic axes
        for _ in range(mult_bias_order):
            prob1 = jnp.where(conv <= 0, 1.0, conv)
            flattened = bins / prob1
            if has_limits:
                conv = _rewrap(conv * jax.vmap(_smooth_ext_row)(_extend(flattened), smooth_bins) / a0_mb)
            else:
                conv = conv * jax.vmap(smooth)(flattened, smooth_bins)

    if like_weights is not None:
        # mean-likelihood curve (reference mcsamples.py get1DDensityGridData
        # meanlikes block): flatten by the corrected density, re-smooth,
        # rescale by corrected/raw density, peak-normalize
        pos = conv > 0
        flat_likes = jnp.where(pos, like_bins / jnp.where(pos, conv, 1.0), like_bins)
        if has_limits:
            blikes = _rewrap(jax.vmap(smooth_ext)(_extend(flat_likes), smooth_bins))
        else:
            blikes = jax.vmap(smooth)(flat_likes, smooth_bins)
        safe_raw = jnp.where(raw_conv == 0, 1.0, raw_conv)
        blikes = jnp.where(pos, blikes * conv / safe_raw, blikes)
        likes = blikes / jnp.max(blikes, axis=1)[:, None]
    else:
        likes = None

    peak = jnp.max(conv, axis=1)
    density = conv / peak[:, None]
    x = binmin[:, None] + fine_width[:, None] * jnp.arange(fine_bins)[None, :]
    bandwidth = h_frac * (binmax - binmin)
    return {
        "x": x,
        "P": density,
        "neff": neff,
        "bandwidth": bandwidth,
        "sigma": sigmas,
        "sigma_range": sigma_range,
        "mean": means,
        "range": (binmin, binmax),
        "active_lo": active_lo,
        "active_hi": active_hi,
        "periodic": per,
        "likes": likes,
        # the small per-param fields the public path's host planner reads,
        # pre-packed IN this program: one buffer = one readback round trip,
        # and no separate concatenation dispatch
        "host_pack": jnp.concatenate([neff, sigma_range, binmin, binmax, bandwidth]),
    }


@partial(
    jax.jit,
    static_argnames=(
        "fine_bins",
        "mult_bias_order",
        "winw",
        "axis_name",
        "boundary_order",
        "max_corr",
        "enable_shear",
        "exact_mult_bias",
        "export_hists",
    ),
)
def all_2d_densities(
    samples,
    weights,
    pair_a,
    pair_b,
    neff,
    binmin,
    binmax,
    contours,
    fine_bins=256,
    mult_bias_order=1,
    winw=30,
    active_lo=None,
    active_hi=None,
    periodic=None,
    axis_name=None,
    bandwidth_scale=None,
    sigma_range=None,
    boundary_order=1,
    max_corr=0.95,
    enable_shear=True,
    bandwidth_override=None,
    kernel_support=None,
    prior_mask=None,
    like_weights=None,
    exact_mult_bias=False,
    hists_in=None,
    export_hists=False,
):
    """All-pairs marginalized 2D densities in one program.

    pair_a/pair_b: (K,) int32 parameter indices per pair; binmin/binmax:
    (P,) fine ranges from :func:`all_1d_densities`; neff: (P,). Returns
    dict with 'P' (K, 256, 256) peak-normalized densities (rows = y = b),
    'contours' (K, C) water levels, and the per-pair kernel parameters.
    Pipeline: scatter-add binning -> 2D ISJ diagonal bandwidths (bisection)
    with plug-in fallback -> correlated Gaussian kernel (sample correlation,
    clipped) -> batched FFT convolution -> analytic edge normalization ->
    multiplicative bias iteration -> contour levels by bisection.

    hists_in: optional pre-binned (K, fine, fine) pair histograms replacing
    the in-program binning (rows = b, cols = a, the
    :func:`~getdist_tpu.ops.histograms.pair_histograms` convention). The
    parity modes pass the histograms they already built for the host
    bandwidth optimizers.
    """
    n, p = samples.shape

    # enable_shear may be a STATIC tuple of pair positions (host pre-sniffed,
    # see _sniff_shear): the expensive sheared-spectrum NUDFT then runs only
    # on that subset instead of all K pairs (usually only a handful are
    # correlated enough to shear)
    shear_subset = None
    if isinstance(enable_shear, tuple):
        shear_subset = np.asarray(enable_shear, np.int32)
        enable_shear = shear_subset.size > 0
        if enable_shear and shear_subset.size == int(pair_a.shape[0]):
            shear_subset = None  # every pair shears: use the plain full batch

    def _ps2(v):
        return jax.lax.psum(v, axis_name) if axis_name else v

    cols = samples.T
    norm = _ps2(jnp.sum(weights))
    means = _ps2(jnp.matmul(cols, weights, precision=_PREC)) / norm
    diffs = cols - means[:, None]
    cov = _ps2(jnp.matmul(diffs * weights[None, :], diffs.T, precision=_PREC)) / norm
    sd = jnp.sqrt(jnp.diagonal(cov))
    corr_mat = cov / jnp.outer(sd, sd)

    fine_width = (binmax - binmin) / (fine_bins - 1)

    def fine_ix(col, lo, width):
        return jnp.clip((((col - lo) / width) + 0.5).astype(jnp.int32), 0, fine_bins - 1)

    ix_all = jax.vmap(fine_ix)(cols, binmin, fine_width)  # (P, N) int32

    def make_pair_hists(w_in):
        return _ps2(pair_histograms(ix_all, w_in, pair_a, pair_b, fine_bins))  # (K, fine, fine)

    hists = make_pair_hists(weights) if hists_in is None else hists_in
    like_hists = None if like_weights is None else make_pair_hists(like_weights)

    pair_neff = jnp.minimum(neff[pair_a], neff[pair_b])
    range_a = (binmax - binmin)[pair_a]
    range_b = (binmax - binmin)[pair_b]
    sr = sd if sigma_range is None else sigma_range
    sr_a, sr_b = sr[pair_a], sr[pair_b]

    if bandwidth_override is not None:
        # parity / fragile-assist mode: host-exact bandwidth matrices
        # (data units) + kernel correlation.  The in-program optimizer is
        # skipped at trace time, not left for DCE: parity mode re-traces
        # this program per fine-grid group on its CPU backend, and the
        # optimizer subgraph alone costs seconds to trace.
        hx, hy, c = bandwidth_override
        fragile = jnp.zeros(pair_a.shape, bool)
    else:
        # branch selection (reference mcsamples.py:1334-1412): shear correlated
        # pairs for bandwidth estimation; pure rule-of-thumb at extreme
        # correlation; plain optimizer otherwise
        c_s = corr_mat[pair_a, pair_b]
        c_cap = jnp.clip(c_s, -max_corr, max_corr)
        c_eff = jnp.where(jnp.abs(c_cap) < 0.1, 0.0, c_cap)
        if active_lo is not None:
            par_lim = active_lo | active_hi
            lim_a, lim_b = par_lim[pair_a], par_lim[pair_b]
        else:
            lim_a = lim_b = jnp.zeros(pair_a.shape, bool)
        both_lim = lim_a & lim_b
        either_lim = lim_a | lim_b
        do_correlated = ~both_lim
        shear_sel = (jnp.abs(c_eff) > 0.2) & (jnp.abs(c_eff) <= max_corr) & do_correlated
        rule_sel = (jnp.abs(c_s) > max_corr) | (~do_correlated & (c_s > 0.8))

        do_corr = ~either_lim
        fb_t = (jnp.minimum(sr_a / range_a, sr_b / range_b) / pair_neff ** (1.0 / 6)) ** 2
        if enable_shear:
            # the sheared spectrum feeds the optimizer for correlated pairs (the
            # density convolution still runs on the original grid, as the
            # reference does: the shear only decorrelates the bandwidth
            # estimate). enable_shear=False (host pre-check: no pair has
            # 0.2 < |corr| <= max_corr) skips the shear spectra entirely.
            xc = binmin[:, None] + fine_width[:, None] * jnp.arange(fine_bins, dtype=samples.dtype)[None, :]
            cov_aa = cov[pair_a, pair_a]
            cov_ab = cov[pair_a, pair_b]
            cov_bb = cov[pair_b, pair_b]
            swap = lim_b  # limited parameter goes first so the shear keeps its bounds
            r0, r1, s_mats = jax.vmap(_shear_plan_2d)(cov_aa, cov_ab, cov_bb, swap)
            if shear_subset is not None:
                sub = jnp.asarray(shear_subset)
                sh_p_s, sh_r1_s, sh_r2_s = jax.vmap(_sheared_power)(
                    hists[sub], xc[pair_a[sub]], xc[pair_b[sub]], r0[sub], r1[sub], swap[sub]
                )
                k_all = pair_a.shape[0]
                sh_power = jnp.zeros((k_all,) + sh_p_s.shape[1:], sh_p_s.dtype).at[sub].set(sh_p_s)
                sh_range1 = range_a.at[sub].set(sh_r1_s)
                sh_range2 = range_b.at[sub].set(sh_r2_s)
                shear_sel = shear_sel & jnp.zeros(k_all, bool).at[sub].set(True)
            else:
                sh_power, sh_range1, sh_range2 = jax.vmap(_sheared_power)(
                    hists, xc[pair_a], xc[pair_b], r0, r1, swap
                )
            opt_range1 = jnp.where(shear_sel, sh_range1, range_a)
            opt_range2 = jnp.where(shear_sel, sh_range2, range_b)
            opt_corr = jnp.where(shear_sel, 0.0, c_eff)
        else:
            shear_sel = jnp.zeros_like(shear_sel)
            opt_range1, opt_range2, opt_corr = range_a, range_b, c_eff
            sh_power = None

        # vmap (not lax.map): all pairs bisect in lockstep so each psi
        # functional evaluates as one large batched contraction instead of 435
        # latency-bound small matvecs
        if enable_shear:
            wx, wy, c_k, ok, fragile = jax.vmap(
                lambda h_, n_, c_, d_, t_, p_, s_: _kernel_bandwidth_2d(h_, n_, c_, d_, t_, p_, s_)
            )(hists, pair_neff, opt_corr, do_corr, fb_t, sh_power, shear_sel)
        else:
            wx, wy, c_k, ok, fragile = jax.vmap(_kernel_bandwidth_2d)(hists, pair_neff, opt_corr, do_corr, fb_t)
        hx = wx * opt_range1
        hy = wy * opt_range2
        c = c_k
        if enable_shear:
            # map sheared-space kernels back through the scaled Cholesky root
            hx_sh, hy_sh, c_sh = jax.vmap(_shear_kernel_back)(hx, hy, c_k, s_mats, swap)
            hx = jnp.where(shear_sel, hx_sh, hx)
            hy = jnp.where(shear_sel, hy_sh, hy)
            c = jnp.where(shear_sel, c_sh, c)
        # rule-of-thumb branch and optimizer-failure fallback (data units)
        rule_hx = sr_a / pair_neff ** (1.0 / 6)
        rule_hy = sr_b / pair_neff ** (1.0 / 6)
        use_rule = rule_sel | ~ok
        # rule-of-thumb pairs never used the optimizer; overridden bandwidths
        # make its fragility moot
        if fragile.dtype == jnp.bool_:
            fragile = fragile & ~use_rule
        hx = jnp.where(use_rule, rule_hx, hx)
        hy = jnp.where(use_rule, rule_hy, hy)
        c = jnp.where(use_rule, c_cap, c)
        c = jnp.clip(c, -0.99, 0.99)
        if mult_bias_order:
            scale = 1.1 * pair_neff ** (1.0 / 6 - 1.0 / (2 + 4 * (1 + mult_bias_order)))
            hx = hx * scale
            hy = hy * scale
    if bandwidth_scale is not None:
        # MISE-sweep hook: reference smooth_scale_2D = -scale convention
        hx = hx * bandwidth_scale
        hy = hy * bandwidth_scale
    rx = jnp.clip(hx / fine_width[pair_a], 0.8, winw / 2.5)  # bin units
    ry = jnp.clip(hy / fine_width[pair_b], 0.8, winw / 2.5)

    if kernel_support is None:
        kernels = jax.vmap(lambda a, b, cc: _gauss_kernel_2d(a, b, cc, winw, samples.dtype))(rx, ry, c)
    else:
        kernels = jax.vmap(lambda a, b, cc, sp: _gauss_kernel_2d(a, b, cc, winw, samples.dtype, support=sp))(
            rx, ry, c, jnp.asarray(kernel_support)
        )

    pad = next_fast_len(fine_bins + 2 * winw)
    has_periodic = periodic is not None
    if has_periodic:
        # periodic axes: fold the duplicated wrap line and extend the grid
        # periodically (period fine_bins-1) into winw-wide borders, then a
        # 'valid' FFT convolution; non-periodic borders stay zero
        per = jnp.asarray(periodic)
        per_x = per[pair_a]
        per_y = per[pair_b]
        L2 = fine_bins - 1
        ext = fine_bins + 2 * winw
        pad_ext2 = next_fast_len(ext + 2 * winw)
        rel2 = jnp.arange(ext) - winw
        wrap_idx = jnp.mod(rel2, L2)
        clip_idx = jnp.clip(rel2, 0, fine_bins - 1)
        inside2 = (rel2 >= 0) & (rel2 < fine_bins)

        def _fold(h):
            fy = h.at[:, 0, :].add(h[:, -1, :]).at[:, -1, :].set(0.0)
            h = jnp.where(per_y[:, None, None], fy, h)
            fx = h.at[:, :, 0].add(h[:, :, -1]).at[:, :, -1].set(0.0)
            return jnp.where(per_x[:, None, None], fx, h)

        src_y = jnp.where(per_y[:, None], wrap_idx[None, :], clip_idx[None, :])  # (K, ext)
        src_x = jnp.where(per_x[:, None], wrap_idx[None, :], clip_idx[None, :])
        msk_y = (per_y[:, None] | inside2[None, :]).astype(samples.dtype)
        msk_x = (per_x[:, None] | inside2[None, :]).astype(samples.dtype)

        def _extend2(h):
            h = _fold(h)
            g = jax.vmap(lambda hk, sy, my: hk[sy] * my[:, None])(h, src_y, msk_y)
            return jax.vmap(lambda gk, sx, mx: gk[:, sx] * mx[None, :])(g, src_x, msk_x)

        def _conv_periodic(h):
            g = _extend2(h)
            gf = jnp.fft.rfftn(g, (pad_ext2, pad_ext2), axes=(1, 2))
            kf2 = jnp.fft.rfftn(kernels, (pad_ext2, pad_ext2), axes=(1, 2))
            full = jnp.fft.irfftn(gf * kf2, (pad_ext2, pad_ext2), axes=(1, 2))
            out = jax.lax.dynamic_slice(full, (0, 2 * winw, 2 * winw), (h.shape[0], fine_bins, fine_bins))
            # wrap line duplicates its partner row/column
            out = jnp.where(per_y[:, None, None], out.at[:, -1, :].set(out[:, 0, :]), out)
            return jnp.where(per_x[:, None, None], out.at[:, :, -1].set(out[:, :, 0]), out)

        smoothed = _conv_periodic(hists)
        kf_shared = None
    else:
        kf_shared = jnp.fft.rfftn(kernels, (pad, pad), axes=(1, 2))
        smoothed = _conv2d_same_kf(hists, kf_shared, pad, winw)

    if like_weights is not None:
        # mean-likelihood grids (reference mcsamples.py:1888-1901): smooth
        # the like-weighted bins, optionally bias-flatten, divide by the
        # smoothed density where it carries mass
        def _like_conv(grids):
            if has_periodic:
                return _conv_periodic(grids)
            return _conv2d_same_kf(grids, kf_shared, pad, winw)

        bin2dlikes = _like_conv(like_hists)
        if mult_bias_order:
            pos = bin2dlikes > 0
            flat_l = jnp.where(pos, like_hists / jnp.where(pos, bin2dlikes, 1.0), like_hists)
            likes2 = _like_conv(flat_l)
            bin2dlikes = jnp.where(pos, likes2 * bin2dlikes, likes2)
        floor = 1e-4 * jnp.max(smoothed, axis=(1, 2), keepdims=True)
        above = smoothed > floor
        bin2dlikes = jnp.where(above, bin2dlikes / jnp.where(above, smoothed, 1.0), 0.0)
        likes_grid = bin2dlikes / jnp.max(bin2dlikes, axis=(1, 2), keepdims=True)
    else:
        likes_grid = None

    # Hard-limit boundary handling (order-0 edge normalization, the role of
    # the reference's mcsamples.py:1921-1933): the prior mask is ones beyond
    # unbounded edges, zero beyond an active limit with a half-weight limit
    # line; a00 = conv(mask) normalizes the kernel mass inside the prior.
    has_limits = active_lo is not None
    if has_limits:
        ext = fine_bins + 2 * winw
        pad_ext = next_fast_len(ext + 2 * winw)
        idx = jnp.arange(ext)

        def _edge_mask(active_l, active_h):
            m = jnp.ones((ext,), samples.dtype)
            m = jnp.where(active_l, jnp.where(idx < winw, 0.0, jnp.where(idx == winw, 0.5, m)), m)
            m = jnp.where(
                active_h, jnp.where(idx >= ext - winw, 0.0, jnp.where(idx == ext - winw - 1, 0.5, m)), m
            )
            return m

        mx = jax.vmap(_edge_mask)(active_lo[pair_a], active_hi[pair_a])  # (K, ext)
        my = jax.vmap(_edge_mask)(active_lo[pair_b], active_hi[pair_b])
        masks = my[:, :, None] * mx[:, None, :]  # (K, ext, ext)
        if prior_mask is not None:
            # non-rectangular prior support (role of the reference's
            # mask_function, mcsamples.py:1907-1919): a host-evaluated
            # (K, ext, ext) indicator multiplied into the edge masks
            masks = masks * prior_mask
        # 'valid' convolution of the padded mask returns (fine, fine)
        mf = jnp.fft.rfftn(masks, (pad_ext, pad_ext), axes=(1, 2))

        def _mask_conv(kern):
            kf_ = jnp.fft.rfftn(kern, (pad_ext, pad_ext), axes=(1, 2))
            full_ = jnp.fft.irfftn(mf * kf_, (pad_ext, pad_ext), axes=(1, 2))
            return jax.lax.dynamic_slice(
                full_, (0, 2 * winw, 2 * winw), (masks.shape[0], fine_bins, fine_bins)
            )

        a00 = _mask_conv(kernels)
        pair_limited = (active_lo | active_hi)[pair_a] | (active_lo | active_hi)[pair_b]
        good = pair_limited[:, None, None] & (a00 > 1e-12)
        a00 = jnp.where(good, a00, 1.0)
        maxes0 = jnp.max(smoothed, axis=(1, 2), keepdims=True)
        apply_ix = good & (a00 * smoothed > maxes0 * 1e-8)
        normed = jnp.where(apply_ix, smoothed / a00, smoothed)
        if boundary_order == 1:
            # linear boundary-kernel correction (reference mcsamples.py:1933-1961)
            moment = jnp.arange(-winw, winw + 1, dtype=samples.dtype)
            win_x = kernels * moment[None, None, :]
            win_y = kernels * moment[None, :, None]
            a10 = _mask_conv(win_x)
            a01 = _mask_conv(win_y)
            x_p = _conv2d_same_batch(hists, win_x, pad)
            y_p = _conv2d_same_batch(hists, win_y, pad)
            a20 = _mask_conv(win_x * moment[None, None, :])
            a02 = _mask_conv(win_y * moment[None, :, None])
            a11 = _mask_conv(win_y * moment[None, None, :])
            denom = a20 * a01**2 + a10**2 * a02 - a00 * a02 * a20 + a11**2 * a00 - 2 * a01 * a10 * a11
            lin_a = a11**2 - a02 * a20
            lin_x = a10 * a02 - a01 * a11
            lin_y = a01 * a20 - a10 * a11
            safe_denom = jnp.where(denom == 0, 1.0, denom)
            corrected = (smoothed * lin_a + x_p * lin_x + y_p * lin_y) / safe_denom
            safe_normed = jnp.where(normed == 0, 1.0, normed)
            lifted = normed * jnp.exp(jnp.minimum(corrected / safe_normed, 4) - 1)
            smoothed = jnp.where(apply_ix & (denom != 0), lifted, normed)
        else:
            smoothed = normed

    # Multiplicative bias iteration. Without limits the reference's a00
    # edge-normalization mask is ~1 everywhere that matters (grids carry 10%
    # empty borders) — the deviation is quantified in tests/test_batched.py;
    # with limits each round divides by a00 as the reference does. Parity
    # mode (exact_mult_bias) reproduces the reference's full mask instead:
    # ones with zeroed winw borders on non-periodic axes, half-weight limit
    # lines on hard-limited directions (mcsamples.py _setAllEdgeMask2D after
    # _setEdgeMask2D), convolved with the pair kernel.
    if mult_bias_order and exact_mult_bias:
        ext_mb = fine_bins + 2 * winw
        pad_mb = next_fast_len(ext_mb + 2 * winw)
        idx_mb = jnp.arange(ext_mb)
        if has_periodic:
            per_arr = jnp.asarray(periodic)
            mb_per_x, mb_per_y = per_arr[pair_a], per_arr[pair_b]
        else:
            mb_per_x = mb_per_y = jnp.zeros(pair_a.shape, bool)
        if has_limits:
            mb_l_a, mb_h_a = active_lo[pair_a], active_hi[pair_a]
            mb_l_b, mb_h_b = active_lo[pair_b], active_hi[pair_b]
        else:
            mb_l_a = mb_h_a = mb_l_b = mb_h_b = jnp.zeros(pair_a.shape, bool)

        def _mb_axis_mask(act_l, act_h, per_ax):
            m = jnp.ones((ext_mb,), samples.dtype)
            border = (idx_mb < winw) | (idx_mb >= ext_mb - winw)
            m = jnp.where(~per_ax & border, 0.0, m)
            if boundary_order >= 0:
                m = jnp.where(act_l & ~per_ax & (idx_mb == winw), m * 0.5, m)
                m = jnp.where(act_h & ~per_ax & (idx_mb == ext_mb - winw - 1), m * 0.5, m)
            return m

        mb_x = jax.vmap(_mb_axis_mask)(mb_l_a, mb_h_a, mb_per_x)
        mb_y = jax.vmap(_mb_axis_mask)(mb_l_b, mb_h_b, mb_per_y)
        mb_masks = mb_y[:, :, None] * mb_x[:, None, :]
        if prior_mask is not None:
            mb_masks = mb_masks * prior_mask
        mb_f = jnp.fft.rfftn(mb_masks, (pad_mb, pad_mb), axes=(1, 2))
        kf_mb = jnp.fft.rfftn(kernels, (pad_mb, pad_mb), axes=(1, 2))
        full_mb = jnp.fft.irfftn(mb_f * kf_mb, (pad_mb, pad_mb), axes=(1, 2))
        a00_mb = jax.lax.dynamic_slice(full_mb, (0, 2 * winw, 2 * winw), (mb_masks.shape[0], fine_bins, fine_bins))
        fully_per = mb_per_x & mb_per_y
        a00_mb = jnp.where(fully_per[:, None, None] | (a00_mb <= 1e-12), 1.0, a00_mb)
    else:
        a00_mb = None
    if mult_bias_order:
        for _ in range(mult_bias_order):
            maxes = jnp.max(smoothed, axis=(1, 2), keepdims=True)
            flat = jnp.where(smoothed > maxes * 1e-8, hists / jnp.where(smoothed == 0, 1.0, smoothed), hists)
            if has_periodic:
                round_conv = _conv_periodic(flat)
            else:
                round_conv = _conv2d_same_kf(flat, kf_shared, pad, winw)
            if a00_mb is not None:
                round_conv = round_conv / a00_mb
            elif has_limits:
                round_conv = jnp.where(pair_limited[:, None, None], round_conv / a00, round_conv)
            smoothed = smoothed * round_conv

    peak = jnp.max(smoothed, axis=(1, 2), keepdims=True)
    density = smoothed / peak
    levels = _contour_levels_batch(density, contours)
    out = {
        "P": density,
        "contours": levels,
        "rx": rx,
        "ry": ry,
        "corr": c,
        "neff": pair_neff,
        "likes": likes_grid,
        # pairs whose f32 correlation search sat on a knife edge (odd-psi
        # clamp bound or the 10%-win acceptance band): the caller should
        # re-derive their bandwidths on the f64 host path
        "fragile": fragile,
        # packed host-facing diagnostics [fragile, rx, ry]: the public path
        # reads ALL its post-program decisions in one transfer instead of
        # one device-to-host copy per field (debug-mode 2D fragile signals
        # flag themselves with a leading -1 row)
        "diag": (
            jnp.concatenate([jnp.full((pair_a.shape[0],), -1.0, rx.dtype), rx, ry])
            if fragile.ndim > 1
            else jnp.concatenate([fragile.astype(rx.dtype), rx, ry])
        ),
    }
    if export_hists:
        # device handle onto the raw pair histograms: the rescue reruns
        # (host-assisted bandwidth overrides, saturated-window pairs) reuse
        # them via hists_in instead of repeating the O(N) binning
        out["hists"] = hists
    return out


@partial(
    jax.jit,
    static_argnames=(
        "fine_bins_2d",
        "has_limits",
        "max_corr",
        "enable_shear",
    ),
)
def _triangle_program(
    samples,
    weights,
    pair_a,
    pair_b,
    contours,
    limits_lo,
    limits_hi,
    periodic,
    fine_bins_2d,
    has_limits,
    max_corr=0.95,
    enable_shear=True,
    like_weights=None,
    bandwidth_scale_1d=None,
    bandwidth_scale_2d=None,
):
    """The full 1D + all-pairs-2D analysis as ONE jitted program: one
    device dispatch and no host round trip between the two stages."""
    if has_limits:
        d1 = all_1d_densities(
            samples, weights, limits_lo=limits_lo, limits_hi=limits_hi, periodic=periodic,
            like_weights=like_weights, bandwidth_scale=bandwidth_scale_1d,
        )
    else:
        d1 = all_1d_densities(samples, weights, like_weights=like_weights, bandwidth_scale=bandwidth_scale_1d)
    d2 = all_2d_densities(
        samples,
        weights,
        pair_a,
        pair_b,
        d1["neff"],
        d1["range"][0],
        d1["range"][1],
        contours,
        fine_bins=fine_bins_2d,
        active_lo=d1["active_lo"] if has_limits else None,
        active_hi=d1["active_hi"] if has_limits else None,
        periodic=periodic,
        bandwidth_scale=bandwidth_scale_2d,
        sigma_range=d1["sigma_range"],
        max_corr=max_corr,
        enable_shear=enable_shear,
        like_weights=like_weights,
    )
    return d1, d2


def _sniff_shear(samples, max_corr, pairs=None, weights=None):
    """Host pre-check: which pairs may want bandwidth shearing (0.2 < |corr|)?

    Only inspects host (numpy) samples — device arrays return True (stay
    correct, pay the shear cost) rather than forcing a device->host sync.
    Without ``pairs`` returns a bool (any pair close to the threshold).
    With ``pairs`` (a (K, 2) index list) returns the STATIC tuple of pair
    positions whose host-estimated |corr| clears 0.15 — a 0.05 margin under
    the device's 0.2 shear threshold so borderline f32 disagreements stay
    inside the subset — or True/False for all/none.
    """
    if not isinstance(samples, np.ndarray):
        return True
    if samples.shape[1] < 2:
        return False
    step = max(1, samples.shape[0] // 100000)
    sub = samples[::step]
    if weights is not None and isinstance(weights, np.ndarray) and weights.shape[:1] == samples.shape[:1]:
        cv = np.cov(sub.T, aweights=weights[::step])
        sd = np.sqrt(np.diag(cv))
        corr = cv / np.outer(sd, sd)
    else:
        corr = np.corrcoef(sub.T)
    if pairs is None:
        off = corr[~np.eye(corr.shape[0], dtype=bool)]
        return bool(np.any(np.abs(off) > 0.18))  # margin below the 0.2 threshold
    sel = [k for k, (a, b) in enumerate(np.asarray(pairs)) if abs(corr[a, b]) > 0.15]
    if not sel:
        return False
    if len(sel) == len(pairs):
        return True
    return tuple(sel)


def triangle_densities(
    samples,
    weights,
    contours=(0.68, 0.95),
    fine_bins_2d=256,
    limits_lo=None,
    limits_hi=None,
    periodic=None,
    max_corr=0.95,
    enable_shear=None,
    like_weights=None,
    bandwidth_scale_1d=None,
    bandwidth_scale_2d=None,
):
    """Convenience wrapper: all 1D and all-pairs 2D densities of a chain.

    Host-callable; runs the fused program and returns its outputs (device
    arrays). limits_lo/limits_hi: optional (P,) hard prior bounds (NaN =
    unbounded) enabling limit-snapped grids and boundary-kernel corrections.
    """
    sniffable = isinstance(weights, np.ndarray) or np.isscalar(weights) or isinstance(weights, (list, tuple))
    host_samples = samples if isinstance(samples, np.ndarray) else None
    host_weights = np.asarray(weights) if sniffable else None
    samples, weights = prepare_chain(samples, weights)
    p = samples.shape[1]
    has_limits = limits_lo is not None or limits_hi is not None or periodic is not None
    if has_limits:
        limits_lo = jnp.asarray(
            np.full(p, np.nan, np.float32) if limits_lo is None else np.asarray(limits_lo, np.float32)
        )
        limits_hi = jnp.asarray(
            np.full(p, np.nan, np.float32) if limits_hi is None else np.asarray(limits_hi, np.float32)
        )
    else:
        limits_lo = limits_hi = None
    per = None if periodic is None else jnp.asarray(np.asarray(periodic, bool))
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)], np.int32).reshape(-1, 2)
    return _triangle_program(
        samples,
        weights,
        jnp.asarray(pairs[:, 0]),
        jnp.asarray(pairs[:, 1]),
        jnp.asarray(np.array(contours, np.float32)),
        limits_lo,
        limits_hi,
        per,
        fine_bins_2d,
        has_limits,
        max_corr,
        _sniff_shear(host_samples if host_samples is not None else samples, max_corr, pairs=pairs, weights=host_weights)
        if enable_shear is None
        else enable_shear,
        like_weights=None if like_weights is None else jnp.asarray(like_weights, jnp.float32),
        bandwidth_scale_1d=None if bandwidth_scale_1d is None else jnp.float32(bandwidth_scale_1d),
        bandwidth_scale_2d=None if bandwidth_scale_2d is None else jnp.float32(bandwidth_scale_2d),
    )
