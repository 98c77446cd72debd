"""Device parity mode (fastParityDensities(device=True)) vs the standard
host-orchestrated parity mode.

On the CPU x64 backend both modes run the same f64 arithmetic, so the
grids must agree essentially exactly (the device mode swaps numpy /
native-C++ O(N) passes for jitted f64 programs and reads back compact
histograms). chip_smoke.py holds the GPU run of the device mode to the
host mode at 1e-5.
"""

import numpy as np
import pytest

import zoo

SHAPES = [
    "Gaussian",
    "hammer",
    "rotating",
    "tight",
    "cut correlated",
    "flat",
    "trimodal WJ2",
    "Gaussian [x>0]",
]


@pytest.mark.parametrize("label", SHAPES)
def test_device_mode_matches_parity_zoo(label):
    shape = zoo.shapes_2d(include_cut_gaussians=True)[label]
    mc_a = shape.MCSamples(8000, random_state=np.random.default_rng(10))
    d1a, d2a = mc_a.fastParityDensities()
    mc_b = shape.MCSamples(8000, random_state=np.random.default_rng(10))
    d1b, d2b = mc_b.fastParityDensities(device=True)
    assert set(d2a) == set(d2b)
    for key in d2a:
        ga, gb = d2a[key].P, d2b[key].P
        assert np.abs(ga / ga.max() - gb / gb.max()).max() <= 1e-10, key
        assert np.abs(np.asarray(d2a[key].contours) - np.asarray(d2b[key].contours)).max() <= 1e-10
    for key in d1a:
        assert np.abs(d1a[key].P - d1b[key].P).max() <= 1e-10


def test_device_mode_multiparam_with_limits():
    """A >2-parameter chain exercising the pair grouping, the sheared
    batch, and a hard-bounded parameter in one call."""
    rng = np.random.RandomState(3)
    n = 12000
    base = rng.standard_normal((n, 2))
    x = base[:, 0]
    y = 0.75 * x + 0.66 * base[:, 1]
    z = np.abs(rng.standard_normal(n))  # bounded at 0
    w = rng.randint(1, 4, n).astype(np.float64)

    from getdist_tpu.mcsamples import MCSamples

    def make():
        return MCSamples(
            samples=np.column_stack([x, y, z]),
            weights=w,
            names=["x", "y", "z"],
            ranges={"z": [0, None]},
        )

    d1a, d2a = make().fastParityDensities()
    d1b, d2b = make().fastParityDensities(device=True)
    for key in d2a:
        ga, gb = d2a[key].P, d2b[key].P
        assert np.abs(ga / ga.max() - gb / gb.max()).max() <= 1e-10, key
    for key in d1a:
        assert np.abs(d1a[key].P - d1b[key].P).max() <= 1e-10


def test_device_mode_fractional_weights_falls_back(caplog):
    """Non-integer (or f32-lossy) weights cannot ride the exact device
    one-hot histograms: device mode must warn and serve the host parity
    results instead of silently truncating weighted counts (round-4
    advisor finding on _compact_readback's uint16 path)."""
    import logging

    rng = np.random.RandomState(7)
    n = 6000
    base = rng.standard_normal((n, 2))
    xy = np.column_stack([base[:, 0], 0.4 * base[:, 0] + base[:, 1]])
    w = rng.uniform(0.5, 2.0, n)

    from getdist_tpu.mcsamples import MCSamples, MCSamplesError

    def make():
        return MCSamples(samples=xy.copy(), weights=w.copy(), names=["x", "y"])

    d1a, d2a = make().fastParityDensities()
    with caplog.at_level(logging.WARNING):
        d1b, d2b = make().fastParityDensities(device=True)
    assert any("fractional" in rec.getMessage() for rec in caplog.records)
    for key in d2a:
        assert np.abs(d2a[key].P - d2b[key].P).max() == 0.0, key
    for key in d1a:
        assert np.abs(d1a[key].P - d1b[key].P).max() == 0.0, key
    # materialize=False has no host-shaped return to fall back to: explicit error
    with pytest.raises(MCSamplesError, match="integral"):
        make().fastParityDensities(device=True, materialize=False)


def test_compact_readback_preserves_fractional_counts():
    """The narrow uint16 readback may only fire for integral histograms;
    fractional weighted counts must come back bit-exact via full width."""
    import jax.numpy as jnp

    from getdist_tpu.mcsamples import MCSamples

    frac = np.array([[[0.0, 2.5], [7.25, 3.0]]])
    out = MCSamples._compact_readback(jnp.asarray(frac))
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, frac)
    # integral-and-small still takes the compact path, losslessly
    small = np.array([[[1.0, 2.0], [3.0, 65535.0]]])
    np.testing.assert_array_equal(MCSamples._compact_readback(jnp.asarray(small)), small)
    # integral but out of uint16 range: full width
    big = np.array([[[0.0, 2.0], [70000.0, 3.0]]])
    np.testing.assert_array_equal(MCSamples._compact_readback(jnp.asarray(big)), big)


def test_device_mode_materialize_false_groups():
    shape = zoo.shapes_2d()["Gaussian"]
    mc = shape.MCSamples(6000, random_state=np.random.default_rng(4))
    dens1, groups = mc.fastParityDensities(device=True, materialize=False)
    assert set(dens1) == {"x", "y"}
    (group,) = groups
    assert group["pairs"] == [("x", "y")]
    assert group["P"].shape[0] == 1 and group["P"].shape[1] == group["fine"]
    # device grids must match the materialized Density2D path
    mc2 = shape.MCSamples(6000, random_state=np.random.default_rng(4))
    _, dens2 = mc2.fastParityDensities(device=True)
    ref = dens2[("x", "y")].P
    got = np.asarray(group["P"][0], float)
    assert np.abs(got / got.max() - ref / ref.max()).max() <= 1e-12
