"""Parity mode: reference-exact densities from the fused f64 programs.

``MCSamples.fastParityDensities`` (VERDICT round-2 item 3) must reproduce
the host parity pipeline — itself byte/1e-6-tested against the reference —
to well under the 1e-4 bar (measured worst case over the full zoo: 1.9e-7).
These tests pin a representative subset: an unbounded Gaussian, hard cuts
on all four edges, a near-degenerate r=0.99 pair, and multimodal shapes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from zoo import shapes_2d  # noqa: E402

from getdist_tpu import chains as tchains  # noqa: E402

tchains.print_load_details = False

# the FULL 2D zoo: the README's parity-exactness claim is pinned here
CASES = sorted(shapes_2d().keys())


@pytest.mark.parametrize("label", CASES, ids=[c.replace(" ", "_") for c in CASES])
def test_parity_mode_matches_host_path(label):
    import jax

    if not jax.config.jax_enable_x64:
        pytest.skip("parity mode needs x64")
    samps = shapes_2d()[label].MCSamples(25000, random_state=3)
    ref = samps.get2DDensityGridData(0, 1)
    ref1 = samps.get1DDensityGridData(0)
    dens1, dens2 = samps.fastParityDensities()
    fused = dens2[("x", "y")]
    assert fused.P.shape == ref.P.shape
    assert float(np.abs(fused.P - ref.P / ref.P.max()).max()) < 1e-5, label
    nlev = len(np.asarray(ref.contours))
    assert float(np.abs(np.asarray(fused.contours)[:nlev] - np.asarray(ref.contours)).max()) < 1e-5
    # 1D is served by the host path itself: identical
    assert float(np.abs(dens1["x"].P - ref1.P).max()) == 0.0


def test_parity_mode_requires_x64(monkeypatch):
    import jax

    from getdist_tpu.mcsamples import MCSamples, MCSamplesError

    samps = shapes_2d()["Gaussian"].MCSamples(2000, random_state=0)
    assert isinstance(samps, MCSamples)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(MCSamplesError):
            samps.fastParityDensities()
    finally:
        jax.config.update("jax_enable_x64", old)


def test_parity_mode_via_fastdensities_flag():
    import jax

    if not jax.config.jax_enable_x64:
        pytest.skip("parity mode needs x64")
    samps = shapes_2d()["Gaussian"].MCSamples(20000, random_state=5)
    dens1, dens2 = samps.fastDensities(parity=True)
    ref = samps.get2DDensityGridData(0, 1)
    fused = dens2[("x", "y")]
    assert float(np.abs(fused.P - ref.P / ref.P.max()).max()) < 1e-5
    # 1D results land in the density cache like the fast path's do
    assert samps.density1D.get("x") is dens1["x"]


def test_parity_mode_mixed_kernel_scales_hits_multiple_buckets():
    """A chain mixing very smooth and very peaked marginals spreads its
    pairs across kernel-window buckets (fastParityDensities groups pairs by
    window level so narrow kernels don't pay the widest pair's FFT
    padding); every pair must still match the per-pair host path."""
    import jax

    if not jax.config.jax_enable_x64:
        pytest.skip("parity mode needs x64")
    from getdist_tpu.mcsamples import MCSamples

    rng = np.random.RandomState(17)
    n = 30000
    broad = rng.standard_normal(n)  # few-bin kernel
    spiky = np.where(rng.uniform(size=n) < 0.5, rng.standard_normal(n) * 0.03, 2 + rng.standard_normal(n) * 0.04)
    mid = 0.6 * broad + 0.8 * rng.standard_normal(n)
    flatish = rng.uniform(-3, 3, n)  # oversmoothed wide kernel
    samples = np.column_stack([broad, spiky, mid, flatish])
    samps = MCSamples(samples=samples, names=["a", "b", "c", "d"])

    # the bucket decomposition itself: more than one window level in play
    import getdist_tpu.ops.batched as batched

    calls = []
    orig = batched.all_2d_densities

    def spy(*args, **kwargs):
        calls.append(kwargs.get("winw"))
        return orig(*args, **kwargs)

    try:
        # fastParityDensities imports the symbol at call time, so patching
        # the module attribute intercepts it
        batched.all_2d_densities = spy
        _, dens2 = samps.fastParityDensities()
    finally:
        batched.all_2d_densities = orig
    assert len(set(calls)) > 1, f"expected multiple winw buckets, got {calls}"

    for a, b in [("a", "b"), ("b", "d"), ("a", "d"), ("c", "d")]:
        ref = samps.get2DDensityGridData(a, b)
        fused = dens2[(a, b)]
        assert fused.P.shape == ref.P.shape, (a, b)
        assert float(np.abs(fused.P - ref.P / ref.P.max()).max()) < 1e-5, (a, b)


def test_parity_mode_1d_stays_host_under_fused_routing(monkeypatch):
    """Where density queries route to the fused pipeline by default (the
    GPU; forced here with GETDIST_TPU_FUSED=1), the parity mode must still
    serve its 1D densities from the byte-exact host path."""
    import jax

    if not jax.config.jax_enable_x64:
        pytest.skip("parity mode needs x64")
    samps = shapes_2d()["skew"].MCSamples(20000, random_state=4)
    host = samps.get1DDensityGridData(0)
    samps.density1D.clear()
    monkeypatch.setenv("GETDIST_TPU_FUSED", "1")
    dens1, _ = samps.fastParityDensities()
    np.testing.assert_array_equal(dens1["x"].P, host.P)
