"""KDE accuracy via MISE against analytic mixtures — the reference's
published accuracy methodology (test_distributions.py:87-126, arXiv:1910.13970).

For each fixture distribution, draw samples, estimate the density, and
integrate the squared error against the analytic pdf. Asserts both that the
absolute MISE is small and that it matches the reference implementation's
MISE on identical samples (same-quality estimates)."""

import numpy as np
import pytest

from getdist_tpu import chains as tchains
from getdist_tpu.gaussian_mixtures import Gaussian1D, Gaussian2D, Mixture1D, Mixture2D

tchains.print_load_details = False


def mise_1d(samples_obj, mixture, param="x"):
    density = samples_obj.get1DDensityGridData(param)
    density.normalize(in_place=True)
    truth = mixture.pdf(density.x)
    norm = np.trapezoid(truth, density.x)
    return np.trapezoid((density.P - truth / norm) ** 2, density.x)


def mise_2d(samples_obj, mixture):
    density = samples_obj.get2DDensityGridData("x", "y", get_density=True)
    density.normalize(in_place=True)
    xx, yy = np.meshgrid(density.x, density.y)
    truth = mixture.pdf(xx, yy)
    dx = density.x[1] - density.x[0]
    dy = density.y[1] - density.y[0]
    truth /= np.sum(truth) * dx * dy
    return np.sum((density.P - truth) ** 2) * dx * dy


FIXTURES_1D = [
    ("gauss", Gaussian1D(0, 0.5)),
    ("skew", Mixture1D([0, 1], [1, 0.4], [0.6, 0.4])),
    ("bimodal", Mixture1D([0, 2], [0.5, 0.5], [0.6, 0.4])),
    ("cut", Gaussian1D(0, 1, xmin=-0.5)),
]


@pytest.mark.parametrize("name,mixture", FIXTURES_1D, ids=[f[0] for f in FIXTURES_1D])
def test_mise_1d(name, mixture, reference_getdist):
    from getdist.mcsamples import MCSamples as RefMCSamples

    samples = mixture.sim(20000, random_state=10)
    ranges = {"x": [mixture.lims[0][0], mixture.lims[0][1]]} if mixture.lims else None
    ours = __import__("getdist_tpu.mcsamples", fromlist=["MCSamples"]).MCSamples(
        samples=samples.copy(), names=["x"], ranges=ranges
    )
    theirs = RefMCSamples(samples=samples.copy(), names=["x"], ranges=ranges)
    m_ours = mise_1d(ours, mixture)
    m_ref = mise_1d(theirs, mixture)
    assert m_ours < 5e-4, (name, m_ours)
    # estimate quality within 5% of reference MISE (same samples)
    assert m_ours <= m_ref * 1.05 + 1e-7, (name, m_ours, m_ref)


FIXTURES_2D = [
    ("gauss", Gaussian2D([0, 0], (0.7, 1, 0.3))),
    ("bimodal_wj1", Mixture2D([[-1, 0], [1, 0]], [(2 / 3, 2 / 3, 0), (2 / 3, 2 / 3, 0)])),
    ("tight", Mixture2D([[0, 0], [2.5, 3.5]], [(1, 1, 0.99), (1, 1.5, 0.98)], [0.6, 0.4])),
    ("cut_correlated", Gaussian2D([0, 0], (0.7, 1, 0.95), ymin=0.3, xmax=1.2)),
]


@pytest.mark.parametrize("name,mixture", FIXTURES_2D, ids=[f[0] for f in FIXTURES_2D])
def test_mise_2d(name, mixture, reference_getdist):
    from getdist.mcsamples import MCSamples as RefMCSamples

    samples = mixture.sim(30000, random_state=10)
    ranges = (
        {"x": list(mixture.lims[0]), "y": list(mixture.lims[1])}
        if mixture.lims and any(v is not None for lim in mixture.lims for v in lim)
        else None
    )
    from getdist_tpu.mcsamples import MCSamples

    ours = MCSamples(samples=samples.copy(), names=["x", "y"], ranges=ranges)
    theirs = RefMCSamples(samples=samples.copy(), names=["x", "y"], ranges=ranges)
    m_ours = mise_2d(ours, mixture)
    m_ref = mise_2d(theirs, mixture)
    assert m_ours <= m_ref * 1.05 + 1e-8, (name, m_ours, m_ref)


def test_mise_fast_path_competitive():
    """The fused device path's 1D density quality should be within ~2x of the
    parity path's MISE on a smooth case (documented approximations)."""
    import jax.numpy as jnp

    from getdist_tpu.mcsamples import MCSamples
    from getdist_tpu.ops import batched

    mixture = Gaussian2D([0, 0], (1.0, 1.3, 0.4))
    samples = mixture.sim(50000, random_state=3)
    parity = MCSamples(samples=samples.copy(), names=["x", "y"])
    marg = mixture.marginalizedMixture(["x"])

    class _Marg1D:
        def pdf(self, x):
            return marg.pdf_marged(0, x)

    m_parity = mise_1d(parity, _Marg1D())

    d1 = batched.all_1d_densities(*batched.prepare_chain(samples, np.ones(len(samples))))
    x = np.asarray(d1["x"][0])
    P = np.asarray(d1["P"][0])
    P = P / np.trapezoid(P, x)
    truth = marg.pdf_marged(0, x)
    truth /= np.trapezoid(truth, x)
    m_fast = np.trapezoid((P - truth) ** 2, x)
    assert m_fast < max(2 * m_parity, 2e-5), (m_fast, m_parity)


@pytest.mark.parametrize("name,mixture", FIXTURES_1D, ids=[f[0] for f in FIXTURES_1D])
def test_mise_fast_path_1d(name, mixture):
    """The fused fast path matches the parity path's statistical quality:
    its MISE against the analytic truth is within 2x (typically ~1x)."""
    from getdist_tpu.mcsamples import MCSamples

    samples = mixture.sim(20000, random_state=10)
    ranges = {"x": [mixture.lims[0][0], mixture.lims[0][1]]} if mixture.lims else None
    mc = MCSamples(samples=samples.copy(), names=["x"], labels=["x"], ranges=ranges)
    mise_parity = mise_1d(mc, mixture)

    # fast path needs >= 2 params for the triangle; add an independent dummy
    rng = np.random.RandomState(0)
    s2 = np.column_stack([samples[:, 0], rng.standard_normal(len(samples))])
    lims = [mixture.lims[0][0], mixture.lims[0][1]] if mixture.lims else [None, None]
    mc2 = MCSamples(samples=s2, names=["x", "dummy"], ranges={"x": lims} if mixture.lims else None)
    dens1, _ = mc2.fastDensities()
    d = dens1["x"]
    d.normalize(in_place=True)
    truth = mixture.pdf(d.x)
    truth /= np.trapezoid(truth, d.x)
    mise_fast = np.trapezoid((d.P - truth) ** 2, d.x)
    assert mise_fast < max(2.0 * mise_parity, 5e-4), (mise_fast, mise_parity)
