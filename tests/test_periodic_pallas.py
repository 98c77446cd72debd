"""2D periodic-parameter parity and pair-histogram regression tests."""

import numpy as np

import jax.numpy as jnp

from getdist_tpu import chains as tchains
from getdist_tpu.mcsamples import MCSamples
from getdist_tpu.ops.histograms import _pad_samples, pair_histograms

tchains.print_load_details = False


def test_periodic_2d_parity(reference_getdist):
    from getdist.mcsamples import MCSamples as RefMCSamples

    rng = np.random.RandomState(5)
    n = 25000
    phase = np.mod(rng.standard_normal(n) * 0.6 + 3.0, 2 * np.pi)
    other = rng.standard_normal(n)
    ranges = {"phi": [0, 2 * np.pi, True]}
    ours = MCSamples(samples=np.column_stack([phase, other]).copy(), names=["phi", "y"], ranges=ranges)
    theirs = RefMCSamples(samples=np.column_stack([phase, other]).copy(), names=["phi", "y"], ranges=ranges)
    mine = ours.get2DDensityGridData("phi", "y", get_density=True)
    ref = theirs.get2DDensityGridData("phi", "y", get_density=True)
    np.testing.assert_allclose(mine.P, ref.P, atol=2e-6)
    # periodic continuity at the wrap edge
    np.testing.assert_allclose(mine.P[:, 0], mine.P[:, -1], atol=1e-8)


def test_periodic_both_axes_parity(reference_getdist):
    from getdist.mcsamples import MCSamples as RefMCSamples

    rng = np.random.RandomState(6)
    n = 20000
    a = np.mod(rng.standard_normal(n) * 0.5, 2 * np.pi)
    b = np.mod(rng.standard_normal(n) * 0.4 + 1.0, 1.0)
    ranges = {"a": [0, 2 * np.pi, True], "b": [0, 1, True]}
    ours = MCSamples(samples=np.column_stack([a, b]).copy(), names=["a", "b"], ranges=ranges)
    theirs = RefMCSamples(samples=np.column_stack([a, b]).copy(), names=["a", "b"], ranges=ranges)
    mine = ours.get2DDensityGridData("a", "b", get_density=True)
    ref = theirs.get2DDensityGridData("a", "b", get_density=True)
    np.testing.assert_allclose(mine.P, ref.P, atol=2e-6)


def test_pallas_pair_histograms_interpret():
    """Pair histograms (rows = b, cols = a) match np.add.at; 3 of 5 rows
    paired, one row used twice."""
    rng = np.random.RandomState(0)
    p, n = 5, 4096 * 2
    ix_pm = jnp.asarray(rng.randint(0, 256, (p, n)).astype(np.int32))
    w = jnp.asarray(rng.randint(1, 5, n).astype(np.float32))
    pa = jnp.asarray(np.array([0, 2, 3], np.int32))
    pb = jnp.asarray(np.array([1, 4, 4], np.int32))
    hists = np.asarray(pair_histograms(ix_pm, w, pa, pb, 256))
    assert hists.shape == (3, 256, 256)
    ixn = np.asarray(ix_pm)
    wn = np.asarray(w)
    for k, (a, b) in enumerate([(0, 1), (2, 4), (3, 4)]):
        expect = np.zeros((256, 256))
        np.add.at(expect, (ixn[b], ixn[a]), wn)
        np.testing.assert_array_equal(hists[k], expect)


def test_pallas_rejects_unaligned():
    """The GPU kernel reads 4 samples per vector load: an unaligned sample
    count is padded with zero-weight samples, which leave every bin
    unchanged."""
    rng = np.random.RandomState(4)
    ix = jnp.asarray(rng.randint(0, 256, (3, 101)).astype(np.int32))
    w = jnp.asarray(rng.randint(1, 4, 101).astype(np.float32))
    ix8, w_pad = _pad_samples(ix, w)
    assert ix8.dtype == jnp.uint8 and ix8.shape == (3, 104) and w_pad.shape == (104,)
    assert np.all(np.asarray(w_pad)[101:] == 0)
    pa, pb = jnp.asarray([0, 1]), jnp.asarray([2, 2])
    np.testing.assert_array_equal(
        np.asarray(pair_histograms(ix8.astype(jnp.int32), w_pad, pa, pb, 256)),
        np.asarray(pair_histograms(ix, w, pa, pb, 256)),
    )


def test_pallas_grouped_pair_histograms_interpret():
    """All 15 pairs of 6 parameters in the triangle's (a < b) order."""
    rng = np.random.RandomState(1)
    p, n = 6, 4096
    ix_pm = jnp.asarray(rng.randint(0, 256, (p, n)).astype(np.int32))
    w = jnp.asarray(rng.randint(1, 5, n).astype(np.float32))
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = jnp.asarray(np.array([a for a, _ in pairs], np.int32))
    pb = jnp.asarray(np.array([b for _, b in pairs], np.int32))
    hists = np.asarray(pair_histograms(ix_pm, w, pa, pb, 256))
    assert hists.shape == (15, 256, 256)
    ixn, wn = np.asarray(ix_pm), np.asarray(w)
    for k, (a, b) in enumerate(pairs):
        expect = np.zeros((256, 256))
        np.add.at(expect, (ixn[b], ixn[a]), wn)
        np.testing.assert_array_equal(hists[k], expect)


def test_all_2d_static_pairs_matches_dynamic():
    """Histograms built outside the program and passed as ``hists_in``
    give the same densities as the in-program binning."""
    from getdist_tpu.ops import batched

    rng = np.random.RandomState(2)
    n, p = 30000, 4
    s = jnp.asarray(rng.standard_normal((n, p)).astype(np.float32))
    w = jnp.asarray(rng.randint(1, 4, n).astype(np.float32))
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = jnp.asarray(np.array([a for a, _ in pairs], np.int32))
    pb = jnp.asarray(np.array([b for _, b in pairs], np.int32))
    cont = jnp.asarray(np.array([0.68, 0.95], np.float32))
    d1 = batched.all_1d_densities(s, w)
    args = (s, w, pa, pb, d1["neff"], d1["range"][0], d1["range"][1], cont)
    dyn = batched.all_2d_densities(*args, export_hists=True)
    stat = batched.all_2d_densities(*args, hists_in=dyn["hists"])
    np.testing.assert_array_equal(np.asarray(dyn["P"]), np.asarray(stat["P"]))


def test_pallas_grouped_int8_exact():
    """Integer weights across the full [0, 127] range, zeros included, are
    exact."""
    rng = np.random.RandomState(2)
    p, n = 4, 4096
    ix_pm = jnp.asarray(rng.randint(0, 256, (p, n)).astype(np.int32))
    w = jnp.asarray(rng.randint(0, 128, n).astype(np.float32))
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = jnp.asarray(np.array([a for a, _ in pairs], np.int32))
    pb = jnp.asarray(np.array([b for _, b in pairs], np.int32))
    h8 = np.asarray(pair_histograms(ix_pm, w, pa, pb, 256))
    assert h8.dtype == np.float32
    ixn, wn = np.asarray(ix_pm), np.asarray(w)
    for k, (a, b) in enumerate(pairs):
        expect = np.zeros((256, 256))
        np.add.at(expect, (ixn[b], ixn[a]), wn)
        np.testing.assert_array_equal(h8[k], expect)
