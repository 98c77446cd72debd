"""Parity tests for ISJ bandwidth selection (1D + 2D) vs the reference."""

import numpy as np
import pytest

from getdist_tpu.densities import Density1D, Density2D, getContourLevels
from getdist_tpu.kde_bandwidth import KernelOptimizer2D, gaussian_kde_bandwidth_binned


def binned_1d(seed=0, n=20000, nbins=1024, dist="gauss"):
    rng = np.random.RandomState(seed)
    if dist == "gauss":
        x = rng.standard_normal(n)
    elif dist == "bimodal":
        x = np.concatenate([rng.standard_normal(n // 2) - 2, rng.standard_normal(n // 2) + 2])
    elif dist == "skew":
        x = rng.gamma(2.0, 1.0, n)
    else:
        raise ValueError(dist)
    lo, hi = x.min(), x.max()
    ix = np.minimum(((x - lo) / (hi - lo) * (nbins - 1)).astype(int), nbins - 1)
    return np.bincount(ix, minlength=nbins), n


@pytest.mark.parametrize("dist", ["gauss", "bimodal", "skew"])
def test_isj_1d_parity(reference_getdist, dist):
    from getdist import kde_bandwidth as ref_kde

    data, n = binned_1d(dist=dist)
    ours = gaussian_kde_bandwidth_binned(data.astype(float), n)
    theirs = ref_kde.gaussian_kde_bandwidth_binned(data.astype(float), n)
    assert ours is not None and theirs is not None
    assert np.isclose(ours, theirs, rtol=1e-7), (dist, ours, theirs)


def binned_2d(seed=1, n=50000, nbins=256, corr=0.5):
    rng = np.random.RandomState(seed)
    cov = np.array([[1.0, corr], [corr, 1.0]])
    xy = rng.multivariate_normal([0, 0], cov, n)
    lo = xy.min(axis=0)
    hi = xy.max(axis=0)
    ix = np.minimum(((xy - lo) / (hi - lo) * (nbins - 1)).astype(int), nbins - 1)
    hist = np.zeros((nbins, nbins))
    np.add.at(hist, (ix[:, 1], ix[:, 0]), 1.0)
    return hist, n, corr


@pytest.mark.parametrize("corr", [0.0, 0.5, 0.9])
def test_kernel_optimizer_2d_parity(reference_getdist, corr):
    from getdist import kde_bandwidth as ref_kde

    hist, n, corr_val = binned_2d(corr=corr)
    ours = KernelOptimizer2D(hist, n, corr_val)
    theirs = ref_kde.KernelOptimizer2D(hist, n, corr_val)
    assert np.isclose(ours.t_star, theirs.t_star, rtol=1e-6)
    ox, oy, oc = ours.get_h()
    tx, ty, tc = theirs.get_h()
    assert np.isclose(ox, tx, rtol=1e-9)
    assert np.isclose(oy, ty, rtol=1e-9)
    assert np.isclose(oc, tc, rtol=1e-9, atol=1e-12)


def test_kernel_optimizer_fallback(reference_getdist):
    from getdist import kde_bandwidth as ref_kde

    # Flat-ish data can break the fixed point; both should take fallback_t.
    hist = np.ones((64, 64))
    ours = KernelOptimizer2D(hist, 1000, 0.0, fallback_t=0.01)
    theirs = ref_kde.KernelOptimizer2D(hist, 1000, 0.0, fallback_t=0.01)
    assert np.isclose(ours.t_star, theirs.t_star)


def test_density1d_parity(reference_getdist):
    from getdist import densities as ref_densities

    rng = np.random.RandomState(2)
    x = np.linspace(-4, 4, 128)
    P = np.exp(-(x**2) / 2) * (1 + 0.1 * rng.rand(128))
    ours = Density1D(x.copy(), P.copy())
    theirs = ref_densities.Density1D(x.copy(), P.copy())
    np.testing.assert_allclose(ours.Prob(np.array([0.3, 1.7])), theirs.Prob(np.array([0.3, 1.7])), rtol=1e-12)
    ours.normalize()
    theirs.normalize()
    np.testing.assert_allclose(ours.P, theirs.P, rtol=1e-12)
    for p in (0.68, 0.95):
        mine = ours.getLimits(p)
        ref = theirs.getLimits(p)
        np.testing.assert_allclose(mine[:2], ref[:2], rtol=1e-10)
        assert mine[2:] == ref[2:]


def test_density2d_and_contours_parity(reference_getdist):
    from getdist import densities as ref_densities

    x = np.linspace(-3, 3, 64)
    y = np.linspace(-2, 2, 64)
    X, Y = np.meshgrid(x, y)
    P = np.exp(-(X**2 + 1.5 * Y**2) / 2)
    ours = Density2D(x.copy(), y.copy(), P.copy())
    theirs = ref_densities.Density2D(x.copy(), y.copy(), P.copy())
    assert np.isclose(ours.norm_integral(), theirs.norm_integral(), rtol=1e-12)
    np.testing.assert_allclose(
        ours.getContourLevels((0.68, 0.95)), theirs.getContourLevels((0.68, 0.95)), rtol=1e-12
    )
    np.testing.assert_allclose(ours.Prob(0.5, -0.3), theirs.Prob(0.5, -0.3), rtol=1e-12)
    ref_levels = ref_densities.getContourLevels(P, (0.5, 0.9), half_edge=False)
    np.testing.assert_allclose(getContourLevels(P, (0.5, 0.9), half_edge=False), ref_levels, rtol=1e-12)


def test_func2d_recursion_matches_reference(reference_getdist):
    """The public func2d/func2d_odd recursion (reference API twins) must
    agree with the reference class on the same histogram."""
    from getdist import kde_bandwidth as ref_kde

    rng = np.random.RandomState(4)
    pts = rng.multivariate_normal([0, 0], [[1, 0.5], [0.5, 1]], 40000)
    hist, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=256)
    n = 40000.0
    ours = KernelOptimizer2D(hist, n, 0.5)
    theirs = ref_kde.KernelOptimizer2D(hist, n, 0.5)
    t = theirs.t_star
    for s in [(0, 2), (2, 0), (1, 1), (0, 4), (2, 2)]:
        a, b = ours.func2d(s, t), theirs.func2d(list(s), t)
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), (s, a, b)
    # odd functionals need the reference's get_h side effects (p00)
    ours.get_h()
    theirs.get_h()
    for s in [(3, 1), (1, 3)]:
        a, b = ours.func2d_odd(s, t), theirs.func2d_odd(list(s), t)
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), (s, a, b)


def test_nearest_fft_number_shapes():
    from getdist_tpu.ops.convolve import nearestFFTnumber

    assert nearestFFTnumber(17) >= 17
    arr = nearestFFTnumber(np.array([[17, 100], [257, 1]]))
    assert arr.shape == (2, 2) and (arr >= [[17, 100], [257, 1]]).all()


def test_isj_1d_multimodal_root_bracketing():
    """The device ISJ seed scan must bracket the SMALL fixed-point root of a
    well-separated trimodal mixture — the regime where the residual curve is
    shallow near the root and a few-1e-3 evaluation error silently forces
    the rule-of-thumb fallback (~6x oversmoothing).

    Regression for a failure seen on an accelerator: XLA hoisted the loop-invariant
    exp(LMAX*log_i) factor (= i^14, inf in f32) out of the bisection loop's
    gamma chain, corrupting the small-h residuals; the fix computes the
    chain in log space (ops.batched._isj_log_gamma), which this test pins
    on every backend.
    """
    import jax
    import jax.numpy as jnp

    from getdist_tpu import kde_bandwidth as kde
    from getdist_tpu.ops.batched import _isj_bandwidth_1d

    rng = np.random.RandomState(0)
    comps = rng.choice(3, size=10000, p=[0.4, 0.35, 0.25])
    x = np.array([0.0, 2.0, 5.0])[comps] + np.array([0.2, 0.7, 0.4])[comps] * rng.standard_normal(10000)
    ix, _ = kde.bin_samples(x, nbins=1024)
    bins = np.bincount(ix, minlength=1024).astype(np.float64)

    host = kde.gaussian_kde_bandwidth_binned(bins, Neff=10000.0)
    h_dev, ok = jax.jit(_isj_bandwidth_1d)(jnp.asarray(bins, jnp.float32), jnp.float32(10000.0))
    assert bool(ok), "seed scan failed to bracket the trimodal ISJ root"
    assert abs(float(h_dev) / host - 1) < 0.02, (float(h_dev), host)


def test_sheared_bandwidth_batch_matches_sequential():
    """_sheared_bandwidths_batch returns BIT-IDENTICAL values to the
    per-pair _optimize_bandwidth_sheared loop (same operands, same
    elementwise arithmetic; the native histogram kernel accumulates in
    np.bincount order)."""
    from getdist_tpu.gaussian_mixtures import GaussianND
    from getdist_tpu import chains as tchains

    tchains.print_load_details = False
    cov = np.array(
        [[1.0, 0.7, 0.2, 0.0], [0.7, 1.0, 0.1, 0.0], [0.2, 0.1, 1.0, 0.55], [0.0, 0.0, 0.55, 1.0]]
    )
    g = GaussianND([0, 0, 0, 0], cov, names=["a", "b", "c", "d"])
    s = g.MCSamples(30000, random_state=4)
    s.updateBaseStatistics()
    infos = [s._initParamRanges(j) for j in range(4)]
    neffs = [s._get1DNeff(infos[j], j) for j in range(4)]
    jobs = []
    for a, b in [(0, 1), (2, 3)]:  # the |corr| > 0.2 pairs
        jobs.append((infos[a], infos[b], a, b, float(min(neffs[a], neffs[b]))))
    batch = s._sheared_bandwidths_batch(jobs, s.fine_bins_2D)
    for parx, pary, a, b, n_eff in jobs:
        hx, hy, c = s._optimize_bandwidth_sheared(parx, pary, a, b, n_eff, s.fine_bins_2D)
        bx, by, bc = batch[(a, b)]
        assert (hx, hy, c) == (bx, by, bc), ((a, b), (hx, hy, c), (bx, by, bc))
