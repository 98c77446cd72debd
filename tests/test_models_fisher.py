"""Fisher-forecast helpers (models.fisher) and the API docs generator."""

import os
import subprocess
import sys

import numpy as np

from getdist_tpu.models import (
    combine_fishers,
    condition_fisher,
    confidence_ellipse,
    figure_of_merit,
    fisher_sigma,
    fisher_to_cov,
    gaussian_from_fisher,
    marginalize_fisher,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_fisher(p, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.standard_normal((p, p))
    return a @ a.T + p * np.eye(p)


def test_fisher_round_trips():
    f = _random_fisher(4)
    cov = fisher_to_cov(f)
    np.testing.assert_allclose(cov @ f, np.eye(4), atol=1e-10)
    # marginalization = Schur complement: marginal cov is the cov slice
    keep = [0, 2]
    fm = marginalize_fisher(f, keep)
    np.testing.assert_allclose(np.linalg.inv(fm), cov[np.ix_(keep, keep)], rtol=1e-10)
    # conditioning tightens, marginalizing loosens
    fc = condition_fisher(f, keep)
    sig_marg = fisher_sigma(fm)
    sig_cond = fisher_sigma(fc)
    assert (sig_cond <= sig_marg + 1e-12).all()
    np.testing.assert_allclose(fisher_sigma(f, marginalized=False), 1 / np.sqrt(np.diagonal(f)))


def test_combined_fishers_add_information():
    f1, f2 = _random_fisher(3, 1), _random_fisher(3, 2)
    tot = combine_fishers(f1, f2)
    np.testing.assert_allclose(tot, f1 + f2)
    assert figure_of_merit(tot) > figure_of_merit(f1)


def test_confidence_ellipse_matches_gaussian_density():
    """Ellipse geometry agrees with the analytic GaussianND 2D density's
    own 95% contour: points on the ellipse boundary have equal pdf and
    ~95% of the mass lies inside."""
    f = _random_fisher(2, seed=3)
    a, b, angle = confidence_ellipse(f, contour=0.95)
    g = gaussian_from_fisher(f, names=["x", "y"])
    th = np.radians(angle)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    boundary = rot @ np.vstack([a * np.cos(t), b * np.sin(t)])
    pdfs = g.pdf(boundary.T)
    assert pdfs.std() / pdfs.mean() < 1e-6  # iso-density ring
    # mass inside the ellipse ~ 0.95 (Monte-Carlo against the exact sampler)
    samples = g.sim(20000, random_state=11)
    local = np.linalg.solve(rot, samples.T)
    inside = (local[0] / a) ** 2 + (local[1] / b) ** 2 <= 1.0
    assert abs(inside.mean() - 0.95) < 0.01


def test_gaussian_from_fisher_limits():
    f = np.diag([4.0, 1.0])  # sigmas 0.5, 1.0
    g = gaussian_from_fisher(f, means=[1.0, -2.0], names=["a", "b"])
    s = g.MCSamples(30000, random_state=5)
    marge = s.getMargeStats()
    assert abs(marge.parWithName("a").mean - 1.0) < 0.02
    assert abs(marge.parWithName("a").err - 0.5) < 0.02
    assert abs(marge.parWithName("b").err - 1.0) < 0.04


def test_api_docs_generator(tmp_path):
    """The stdlib API-reference generator produces a page per module with
    real content for the core modules."""
    out = tmp_path / "api"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "build_api_docs.py"), "--out", str(out)],
        capture_output=True,
        text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    index = (out / "index.md").read_text()
    assert "getdist_tpu.mcsamples" in index
    mcs = (out / "getdist_tpu_mcsamples.md").read_text()
    assert "fastTriangleDensities" in mcs and "get1DDensityGridData" in mcs
    plots = (out / "getdist_tpu_plots.md").read_text()
    assert "triangle_plot" in plots and "GetDistPlotSettings" in plots
    batched = (out / "getdist_tpu_ops_batched.md").read_text()
    assert "all_2d_densities" in batched
