"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from getdist_tpu.parallel import (
    make_mesh,
    shard_samples,
    sharded_moments,
    sharded_hist_1d,
    sharded_pair_hists,
    sharded_triangle_step,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("need multiple (virtual) devices")
    return make_mesh()


@pytest.fixture(scope="module")
def chain():
    rng = np.random.RandomState(3)
    n, p = 16384, 4
    samples = rng.standard_normal((n, p))
    samples[:, 1] += 0.5 * samples[:, 0]
    weights = rng.randint(1, 4, n).astype(np.float64)
    return samples, weights


def test_sharded_moments(mesh, chain):
    samples, weights = chain
    dev_s, dev_w = shard_samples(mesh, samples, weights)
    norm, means, cov = sharded_moments(mesh, dev_s, dev_w)
    assert float(norm) == weights.sum()
    expected_means = weights @ samples / weights.sum()
    np.testing.assert_allclose(np.asarray(means), expected_means, rtol=1e-12)
    diffs = samples - expected_means
    expected_cov = (diffs * weights[:, None]).T @ diffs / weights.sum()
    np.testing.assert_allclose(np.asarray(cov), expected_cov, rtol=1e-10)


def test_sharded_hist_matches_local(mesh, chain):
    samples, weights = chain
    nbins = 64
    lo = samples.min(axis=0)
    hi = samples.max(axis=0)
    ix = np.clip(((samples - lo) / (hi - lo) * (nbins - 1)).astype(np.int32), 0, nbins - 1).T
    dev_ix = jax.device_put(jnp.asarray(ix), jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "samples")))
    dev_w = jax.device_put(jnp.asarray(weights), jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("samples")))
    hists = np.asarray(sharded_hist_1d(mesh, dev_ix, dev_w, nbins))
    for j in range(ix.shape[0]):
        np.testing.assert_allclose(hists[j], np.bincount(ix[j], weights=weights, minlength=nbins), rtol=1e-10)


def test_sharded_pair_hists(mesh, chain):
    samples, weights = chain
    nbins = 256
    lo = samples.min(axis=0)
    hi = samples.max(axis=0)
    ix = np.clip(((samples - lo) / (hi - lo) * (nbins - 1)).astype(np.int32), 0, nbins - 1).T
    spec2 = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "samples"))
    spec1 = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("samples"))
    dev_ix = jax.device_put(jnp.asarray(ix), spec2)
    dev_w = jax.device_put(jnp.asarray(weights), spec1)
    pa = jnp.asarray([0, 0, 1])
    pb = jnp.asarray([1, 2, 3])
    hists = np.asarray(sharded_pair_hists(mesh, dev_ix, dev_w, pa, pb))
    for k, (a, b) in enumerate([(0, 1), (0, 2), (1, 3)]):
        expected = np.zeros((nbins, nbins))
        np.add.at(expected, (ix[b], ix[a]), weights)
        np.testing.assert_allclose(hists[k], expected, rtol=1e-8, atol=1e-8)


def test_sharded_triangle_step(mesh, chain):
    samples, weights = chain
    dev_s, dev_w = shard_samples(mesh, samples, weights)
    pa = jnp.asarray([0, 0, 1])
    pb = jnp.asarray([1, 2, 2])
    d1, d2 = sharded_triangle_step(mesh, dev_s, dev_w, pa, pb)
    d1 = np.asarray(d1)
    d2 = np.asarray(d2)
    assert d1.shape == (4, 128)
    assert d2.shape == (3, 128, 128)
    np.testing.assert_allclose(d1.max(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(d2.max(axis=(1, 2)), 1.0, rtol=1e-6)
    # peak near the true mean for the smooth gaussian marginals
    peak_x = np.argmax(d1[0])
    assert 40 < peak_x < 88


def test_sharded_pair_hists_pallas_matches_xla():
    """Per-shard pair histograms + psum equal the single-device histograms."""
    import jax.numpy as jnp

    from getdist_tpu.ops.histograms import pair_histograms
    from getdist_tpu.parallel.mesh import make_mesh
    from getdist_tpu.parallel.reductions import sharded_pair_hists

    rng = np.random.RandomState(3)
    p, n = 5, 8 * 601  # shards of an odd length
    ix = jnp.asarray(rng.randint(0, 256, (p, n)).astype(np.int32))
    w = jnp.asarray(rng.randint(1, 4, n).astype(np.float32))
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = jnp.asarray(np.array([a for a, _ in pairs], np.int32))
    pb = jnp.asarray(np.array([b for _, b in pairs], np.int32))
    mesh = make_mesh()
    got = np.asarray(sharded_pair_hists(mesh, ix, w, pa, pb))
    ref = np.asarray(pair_histograms(ix, w, pa, pb, 256))
    np.testing.assert_array_equal(got, ref)


def _ar1_chain(n, p, rho=0.8, seed=8):
    """Strongly autocorrelated AR(1) chain — the case where a weight proxy
    for N_eff is wrong by ~an order of magnitude."""
    rng = np.random.RandomState(seed)
    innov = rng.standard_normal((n, p))
    s = np.empty((n, p), np.float64)
    s[0] = innov[0]
    for i in range(1, n):
        s[i] = rho * s[i - 1] + np.sqrt(1 - rho**2) * innov[i]
    s += 0.3 * np.arange(p)
    return s.astype(np.float32)


def test_sharded_neff_real_lag_estimator():
    """The sharded N_eff is the real psum'd lag estimator (halo exchange),
    matching the single-device estimator on a rho=0.8 chain — not the
    norm^2/sum(w^2) weight proxy, which grossly overestimates here."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from getdist_tpu.ops.batched import _lag_grid, _neff_kde_batch
    from getdist_tpu.parallel.mesh import make_mesh

    n, p = 8 * 4096, 3
    mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    w = np.random.RandomState(5).randint(1, 4, n).astype(np.float32)
    proxy = w.sum() ** 2 / (w * w).sum()

    for rho, proxy_frac in [(0.8, 0.7), (0.99, 0.2)]:
        s = _ar1_chain(n, p, rho=rho)
        sj, wj = jnp.asarray(s), jnp.asarray(w)
        sigmas = jnp.std(sj, axis=0)
        lags = _lag_grid(n, max_lag=min(4096, n // 8))

        single = np.asarray(_neff_kde_batch(sj.T, wj, sigmas, lags))

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(None, "samples"), P("samples"), P()),
            out_specs=P(),
        )
        def _sharded(cols, weights, sig):
            return _neff_kde_batch(cols, weights, sig, lags, axis_name="samples", axis_size=n_dev)

        sharded = np.asarray(jax.jit(_sharded)(sj.T, wj, sigmas))

        # the real estimators sum the same global pairs -> fp-order agreement
        np.testing.assert_allclose(sharded, single, rtol=1e-3)
        # and both sit well below the weight proxy (which ignores sample
        # autocorrelation; at rho=0.99 it overestimates N_eff >5x)
        assert sharded.max() < proxy_frac * proxy
        assert single.max() < proxy_frac * proxy


def test_sharded_triangle_densities_matches_single_device():
    """Full fused pipeline under shard_map equals the single-device path,
    both running the REAL lag N_eff estimator, on a rho=0.8 chain. The
    algorithm is identical up to f32 reduction order, so the tolerances
    are float-noise-sized, not approximation-sized: integer-weight
    histograms are exact either way, psum'd moments differ only in
    summation order, and the N_eff halo exchange reproduces the same
    global lag sums."""
    from getdist_tpu.ops import batched
    from getdist_tpu.parallel.mesh import make_mesh
    from getdist_tpu.parallel.reductions import sharded_triangle_densities

    n, p = 8 * 4000, 4
    s = _ar1_chain(n, p, seed=11)
    w = np.random.RandomState(8).randint(1, 4, n).astype(np.float32)
    mesh = make_mesh()
    d1s, d2s = sharded_triangle_densities(mesh, s, w)

    sj, wj = jnp.asarray(s), jnp.asarray(w)
    d1 = batched.all_1d_densities(sj, wj)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = jnp.asarray(np.array([a for a, _ in pairs], np.int32))
    pb = jnp.asarray(np.array([b for _, b in pairs], np.int32))
    cont = jnp.asarray(np.array([0.68, 0.95], np.float32))
    d2 = batched.all_2d_densities(sj, wj, pa, pb, d1["neff"], d1["range"][0], d1["range"][1], cont)

    np.testing.assert_allclose(np.asarray(d1s["neff"]), np.asarray(d1["neff"]), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(d1s["P"]), np.asarray(d1["P"]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(d2s["P"]), np.asarray(d2["P"]), atol=3e-5)
    np.testing.assert_allclose(np.asarray(d2s["contours"]), np.asarray(d2["contours"]), rtol=1e-3)


def test_sharded_public_path_full_features():
    """The PUBLIC fastTriangleDensities(mesh=...) — limits, a periodic
    axis, a strongly correlated pair (shear branch), and the rescue
    machinery — matches the single-device public path at float-noise
    tolerances (the sharded pipeline is the same algorithm, not a feature
    subset)."""
    from getdist_tpu.mcsamples import MCSamples
    from getdist_tpu.parallel.mesh import make_mesh

    rng = np.random.RandomState(5)
    n, p = 8 * 3000, 4
    s = rng.standard_normal((n, p))
    s[:, 1] = 0.8 * s[:, 0] + 0.6 * s[:, 1]  # corr ~ 0.8
    s[:, 2] = np.abs(s[:, 2])  # bounded at 0
    s[:, 3] = np.mod(s[:, 3], 2.0)  # periodic on [0, 2)
    w = rng.randint(1, 4, n).astype(np.float64)
    ranges = {"c": [0, None], "d": [0, 2]}

    def build():
        mc = MCSamples(samples=s, weights=w, names=["a", "b", "c", "d"], ranges=ranges)
        mc.paramNames.parWithName("d").periodic = True
        return mc

    d1s, d2s, pairs = build().fastTriangleDensities(mesh=make_mesh())
    d1u, d2u, _ = build().fastTriangleDensities()

    np.testing.assert_allclose(
        np.asarray(d1s["neff"]), np.asarray(d1u["neff"]), rtol=1e-3
    )
    np.testing.assert_allclose(np.asarray(d1s["P"]), np.asarray(d1u["P"]), atol=2e-5)
    np.testing.assert_allclose(np.asarray(d2s["P"]), np.asarray(d2u["P"]), atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(d2s["contours"]), np.asarray(d2u["contours"]), rtol=1e-3
    )
    # the rescue machinery ran identically on both paths
    assert sorted(d2s["regrid"]) == sorted(d2u["regrid"])
    for key in d2u["regrid"]:
        np.testing.assert_allclose(
            np.asarray(d2s["regrid"][key]["P"]),
            np.asarray(d2u["regrid"][key]["P"]),
            atol=2e-5,
        )


def test_program_cache_is_lru_bounded(mesh):
    """_PROGRAM_CACHE pins compiled shard_map programs (and the meshes they
    close over); it must evict least-recently-used entries instead of
    growing without bound (round-4 advisor finding)."""
    from getdist_tpu.parallel import reductions

    def fake_program(**kwargs):  # never traced: jit is lazy
        return None

    fake_program.__name__ = "all_2d_densities"
    saved = dict(reductions._PROGRAM_CACHE)
    reductions._PROGRAM_CACHE.clear()
    try:
        for i in range(reductions._PROGRAM_CACHE_MAX + 5):
            reductions._build_sharded(
                mesh, fake_program, (("fine_bins", 64 + i),), ("samples", "weights")
            )
        assert len(reductions._PROGRAM_CACHE) == reductions._PROGRAM_CACHE_MAX
        # oldest entries evicted, newest present
        keys = list(reductions._PROGRAM_CACHE)
        assert all(k[2] != (("fine_bins", 64),) for k in keys)
        newest = (mesh, "all_2d_densities", (("fine_bins", 64 + reductions._PROGRAM_CACHE_MAX + 4),), ("samples", "weights"))
        assert newest in reductions._PROGRAM_CACHE
        # a cache hit refreshes recency
        first_key = keys[0]
        reductions._build_sharded(mesh, fake_program, first_key[2], first_key[3])
        assert list(reductions._PROGRAM_CACHE)[-1] == first_key
    finally:
        reductions._PROGRAM_CACHE.clear()
        reductions._PROGRAM_CACHE.update(saved)
