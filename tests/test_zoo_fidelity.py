"""Fused-path fidelity across the FULL reference distribution zoo.

Every 2D shape of the reference battery
(``/root/reference/getdist/tests/test_distributions.py:154-258``, re-created
in :mod:`tests.zoo`) is run through both the host parity path and the fused
device pipeline; the peak-normalized density grids must agree within a
per-shape tolerance. The hard shapes (hammer, rotating, tight r=0.99,
quadrimodal, four-edge-cut flat) are exactly where the fused approximations
(frequency-space shearing, wide-kernel window, sheared-bandwidth assist)
were found wanting in round 3 and got dedicated passes; these tests pin
that down.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.interpolate import RectBivariateSpline

sys.path.insert(0, str(Path(__file__).parent))
from zoo import shapes_1d, shapes_2d  # noqa: E402

from getdist_tpu import chains as tchains  # noqa: E402

tchains.print_load_details = False

N_2D = 40000

# max |fused - parity| over the peak-normalized grid where parity > 0.05.
# 5e-3 is the generic budget (f32 + lag-grid N_eff approximations).  The
# former 2e-2 outliers are gone: 'rotating' (2e-2 -> 2.5e-3) via the
# Cauchy-Schwarz clamp on the odd psi functionals (its f32 correlation
# search now finds the same clear minimum f64 does), and 'trimodal WJ2'
# (1.9e-2 -> 9e-4) via the fragile-pair assist (its search stays blind, so
# the pair is flagged and served f64 host bandwidths in the regrid pass).
TOL_2D = {
    "tight": 7e-3,
    "cut correlated": 7e-3,
    "hammer": 6e-3,
    "trimodal WJ1": 6e-3,
}
DEFAULT_TOL_2D = 5e-3


def _max_grid_delta_2d(s):
    ref = s.get2DDensityGridData(0, 1)
    _, dens2 = s.fastDensities()
    fused = dens2[(s.parName(0), s.parName(1))]
    spline = RectBivariateSpline(fused.y, fused.x, fused.P)
    gx, gy = np.meshgrid(ref.x, ref.y)
    approx = spline.ev(gy.ravel(), gx.ravel()).reshape(gy.shape)
    exact = ref.P / ref.P.max()
    approx = approx / approx.max()
    sel = exact > 0.05
    return float(np.max(np.abs(approx[sel] - exact[sel])))


_SHAPES_2D = shapes_2d()


@pytest.mark.parametrize("label", list(_SHAPES_2D), ids=[k.replace(" ", "_") for k in _SHAPES_2D])
def test_fused_tracks_parity_across_2d_zoo(label):
    samps = _SHAPES_2D[label].MCSamples(N_2D, random_state=7)
    delta = _max_grid_delta_2d(samps)
    assert delta < TOL_2D.get(label, DEFAULT_TOL_2D), (label, delta)


_SHAPES_1D = shapes_1d()
_HARD_1D = ["Gaussian", "skew", "flat top", "bimodal 2", "trimodal", "Gaussian [x>0]"]


@pytest.mark.parametrize("label", _HARD_1D, ids=[k.replace(" ", "_") for k in _HARD_1D])
def test_fused_tracks_parity_across_1d_zoo(label):
    prob = _SHAPES_1D[label]
    samps = prob.MCSamples(N_2D, random_state=7)
    # fused pipeline needs >= 2 params: pair with an independent normal
    rng = np.random.RandomState(1)
    from getdist_tpu.mcsamples import MCSamples

    cols = np.column_stack([samps.samples[:, 0], rng.standard_normal(samps.numrows)])
    ranges = None
    if prob.lims and any(v is not None for v in prob.lims[0]):
        ranges = {"p0": list(prob.lims[0])}
    s = MCSamples(samples=cols, names=["p0", "p1"], ranges=ranges)
    ref = s.get1DDensityGridData(0)
    d1, _ = s.fastDensities()
    fused = d1["p0"]
    grid = np.clip(ref.x, fused.x[0], fused.x[-1])
    delta = np.abs(fused.Prob(grid) / fused.P.max() - ref.Prob(ref.x) / ref.P.max())
    assert float(np.max(delta)) < 6e-3, (label, float(np.max(delta)))


def test_fragile_assist_engages_on_blind_correlation_searches():
    """'trimodal WJ2': the f32 correlation search runs blind (odd-psi clamp
    binds) and makes no progress, so the fused program must flag the pair
    and the regrid pass must serve f64 host bandwidths (the grid is ~1.9e-2
    wrong without the assist, 9e-4 with it)."""
    samps = _SHAPES_2D["trimodal WJ2"].MCSamples(N_2D, random_state=7)
    d1, d2, pairs = samps.fastTriangleDensities()
    assert bool(np.asarray(d2["fragile"])[0]), "fused program no longer flags the pair"
    assert pairs[0] in d2["regrid"], "fragile pair was not host-assisted"


def test_fragile_assist_skips_gaussian_chains():
    """Gaussian-ish pairs may flag blind searches too, but the host
    cross-cumulant gate must keep them off the (host-priced) assist path."""
    from getdist_tpu.mcsamples import MCSamples

    rng = np.random.RandomState(5)
    cols = rng.standard_normal((30000, 4))
    s = MCSamples(samples=cols, names=[f"p{i}" for i in range(4)])
    d1, d2, pairs = s.fastTriangleDensities()
    assert not d2["regrid"], d2["regrid"].keys()


def test_wide_kernel_bounded_1d_served_host_exact():
    """Near-uniform double-cut 1D shapes (kernel sigma ~ range/3) hit two
    round-3 fixes: the device now applies the reference's range/4 auto
    bandwidth cap, and hard-limited params with kernel width > 0.15x range
    are served from the host boundary-correction convention. Fused output
    must then match the parity path essentially exactly."""
    import numpy as np

    prob = shapes_1d()["flat"]
    s = prob.MCSamples(10000, random_state=1)
    ref = s.get1DDensity("x")
    ref.normalize()
    s._fused_cache = None
    d1, _ = s.fastDensities()
    fused = d1["x"]
    fused.normalize()
    # residual is the f32 transport of the (identical) bandwidth: ~3e-7
    assert np.max(np.abs(fused.P - ref.P)) < 1e-5
