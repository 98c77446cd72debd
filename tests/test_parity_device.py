"""Device twins of the parity pipeline's O(N) host passes.

On the CPU x64 test backend the device kernels run the same f64
arithmetic as the host twins, so agreement here is essentially exact;
chip_smoke.py checks the parity device mode against the host on the GPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from getdist_tpu.ops import parity_device as pdev


@pytest.fixture(scope="module")
def chain():
    rng = np.random.RandomState(11)
    n, p = 40000, 4
    steps = rng.standard_normal((n, p))
    x = np.empty((n, p))
    x[0] = steps[0]
    for i in range(1, n):
        x[i] = 0.7 * x[i - 1] + np.sqrt(1 - 0.49) * steps[i]
    x[:, 2] = 0.9 * x[:, 1] + 0.45 * x[:, 2]
    w = rng.randint(1, 6, n).astype(np.float64)
    return x, w


def test_bin_indices_match_host(chain):
    x, w = chain
    lo = x.min(axis=0) - 0.1
    width = (x.max(axis=0) + 0.1 - lo) / 255
    host = ((x - lo[None, :]) / width[None, :] + 0.5).astype(np.int64).T
    dev = np.asarray(pdev.bin_indices(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(width)))
    assert np.array_equal(host, dev)


def test_bin_rows_match_host(chain):
    x, _ = chain
    rows = x.T[:3]
    rmin = rows.min(axis=1) - 0.2
    dx = (rows.max(axis=1) + 0.2 - rmin) / 255
    host = ((rows - rmin[:, None]) / dx[:, None]).astype(int)
    dev = np.asarray(pdev.bin_rows(jnp.asarray(rows), jnp.asarray(rmin), jnp.asarray(dx)))
    assert np.array_equal(host, dev)


def test_group_pair_hists_exact(chain):
    x, w = chain
    lo = x.min(axis=0) - 0.1
    width = (x.max(axis=0) + 0.1 - lo) / 255
    ix = pdev.bin_indices(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(width))
    pairs = [(0, 1), (1, 2), (0, 3)]
    hists = np.asarray(
        pdev.group_pair_hists(
            ix, [a for a, _ in pairs], [b for _, b in pairs], jnp.asarray(w, jnp.float32), 256
        )
    )
    ixh = np.asarray(ix)
    for k, (a, b) in enumerate(pairs):
        ref = np.bincount(ixh[a] + ixh[b] * 256, weights=w, minlength=256 * 256).reshape(256, 256)
        assert np.array_equal(hists[k], ref), (k, np.abs(hists[k] - ref).max())


def test_group_pair_hists_noninteger_weights_exact_f32(chain):
    x, _ = chain
    rng = np.random.RandomState(5)
    w = rng.random(x.shape[0]).astype(np.float32).astype(np.float64) + 0.25
    lo = x.min(axis=0) - 0.1
    width = (x.max(axis=0) + 0.1 - lo) / 255
    ix = pdev.bin_indices(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(width))
    hists = np.asarray(pdev.group_pair_hists(ix, [0], [1], jnp.asarray(w, jnp.float32), 256))
    ixh = np.asarray(ix)
    ref = np.bincount(ixh[0] + ixh[1] * 256, weights=w, minlength=256 * 256).reshape(256, 256)
    # f64 bincount vs an f32 scatter-add: agreement at f32 representation level
    assert np.abs(hists[0] - ref).max() <= 1e-3


def test_lag_terms_match_host(chain):
    from getdist_tpu import samplemath as smath

    x, w = chain
    jobs = [(0, 1, 0.3), (0, 7, 0.3), (2, 3, 0.5), (3, 20000, 0.7)]
    dev = pdev.lag_terms(jnp.asarray(x), jnp.asarray(w), jobs)
    for (p, k, s), got in zip(jobs, dev):
        ref = smath.kde_lag_term_1d(x[:, p], w, k, s)
        assert abs(got - ref) <= 1e-9 * abs(ref)


def test_kde_neff_batch_matches_host_driver(chain):
    from getdist_tpu import samplemath as smath

    x, w = chain
    numrows = x.shape[0]
    kstds = [0.2 * np.std(x[:, p]) for p in range(x.shape[1])]
    maxoffs = [min(40, numrows // 10)] * x.shape[1]
    dev_n = pdev.kde_neff_batch(jnp.asarray(x), jnp.asarray(w), w, kstds, maxoffs, numrows)
    for p in range(x.shape[1]):
        host_n = smath.kde_pair_sum_adaptive(
            lambda k, p=p: smath.kde_lag_term_1d(x[:, p], w, k, kstds[p]), w, numrows, maxoffs[p], 0.05
        )
        assert abs(dev_n[p] - host_n) <= 1e-9 * host_n, (p, dev_n[p], host_n)


def test_sheared_rows_minmax(chain):
    x, _ = chain
    r = np.array([[1.3, 0.0], [0.6, 0.9]])
    dev_rows, lo, hi = pdev.sheared_rows_minmax(
        jnp.asarray(x),
        jnp.asarray([2], jnp.int32),
        jnp.asarray([1], jnp.int32),
        jnp.asarray([r[0, 0]]),
        jnp.asarray([r[1, 0]]),
        jnp.asarray([r[1, 1]]),
    )
    ref = (r[0, 0] * x[:, 2] - r[1, 0] * x[:, 1]) / r[1, 1]
    assert np.allclose(np.asarray(dev_rows)[0], ref, rtol=0, atol=1e-12)
    assert np.isclose(float(lo[0]), ref.min()) and np.isclose(float(hi[0]), ref.max())


def test_acl_batch_matches_host(chain):
    """The batched device autocorrelation lengths must reproduce the host
    getCorrelationLength values (same curve, same threshold rule), and the
    safe flags must admit the clean cases; where they don't, the parity
    caller recomputes on host, so the guard only needs to be conservative."""
    x, w = chain
    from getdist_tpu.mcsamples import MCSamples

    mc = MCSamples(samples=x.copy(), weights=w.copy(), names=[f"p{i}" for i in range(x.shape[1])])
    host_acl = np.array(
        [mc.getCorrelationLength(j, weight_units=False) for j in range(x.shape[1])]
    )
    means = mc.getMeans()
    variances = mc.getVars()
    dev_acl, safe = pdev.acl_batch(
        jnp.asarray(mc.samples, jnp.float32),
        jnp.asarray(mc.weights, jnp.float32),
        means,
        variances,
        list(range(x.shape[1])),
        mc.numrows // 10 + 1,
    )
    # the f32 curve reproduces the f64 acl to ~1e-5 relative
    np.testing.assert_allclose(dev_acl, host_acl, rtol=1e-4)
    # the integer horizon the parity caller derives must agree wherever the
    # guard says the device value is usable
    for p in range(x.shape[1]):
        if safe[p]:
            assert int(1.5 * dev_acl[p]) == int(1.5 * host_acl[p]), p
    assert safe.any(), "guard should admit typical smooth-decay params"


def test_pallas_group_hists_interpret_bit_exact(chain):
    """The parity histograms must be BIT-identical to per-pair np.bincount
    for integral weights (bin sums below 2**24 are exact in any order),
    both for the triangle's param pairs and for a unique-b pair list over
    many stacked rows (the sheared lead/residual shape)."""
    x, w = chain
    lo = x.min(axis=0) - 0.1
    width = (x.max(axis=0) + 0.1 - lo) / 255
    ix = pdev.bin_indices(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(width))
    w32 = jnp.asarray(w, jnp.float32)
    p = x.shape[1]
    pa = np.array([a for a in range(p) for b in range(a + 1, p)], np.int32)
    pb = np.array([b for a in range(p) for b in range(a + 1, p)], np.int32)

    def bincount_ref(rows, pa_, pb_):
        return np.stack(
            [np.bincount(rows[b] * 256 + rows[a], weights=w, minlength=65536).reshape(256, 256) for a, b in zip(pa_, pb_)]
        )

    got = np.asarray(pdev.group_pair_hists(ix, pa, pb, w32, 256))
    np.testing.assert_array_equal(got, bincount_ref(np.asarray(ix), pa, pb))
    stacked = jnp.concatenate([ix + k for k in range(10)], axis=0) % 256
    r = int(stacked.shape[0])
    pa2 = np.arange(r // 2, dtype=np.int32)
    pb2 = np.arange(r // 2, r, dtype=np.int32)
    got2 = np.asarray(pdev.group_pair_hists(stacked, pa2, pb2, w32, 256))
    np.testing.assert_array_equal(got2, bincount_ref(np.asarray(stacked), pa2, pb2))
