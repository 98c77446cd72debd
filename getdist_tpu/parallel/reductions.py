"""Sharded sample reductions under shard_map.

Each device reduces its local sample shard to the small binned state
(moments, 1D fine histograms, per-pair 2D histograms); one ``psum`` over
the sample axis combines them. The collective payload is small — p^2 for
moments, P x fine_bins and K x 256^2 for histograms — next to the O(N)
local binning.
"""

from collections import OrderedDict
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from getdist_tpu.ops.batched import _conv2d_same_batch, _gauss_kernel_2d
from getdist_tpu.ops.histograms import pair_histograms, row_histograms
from getdist_tpu.parallel.mesh import SAMPLE_AXIS

_PREC = jax.lax.Precision.HIGHEST

__all__ = [
    "sharded_moments",
    "sharded_hist_1d",
    "sharded_pair_hists",
    "sharded_triangle_step",
    "sharded_triangle_densities",
    "sharded_all_1d_densities",
    "sharded_all_2d_densities",
]

# cache of built shard_map callables keyed by (mesh, program, static config,
# present-array set): rebuilding the shard_map + jit wrapper per call would
# re-trace the full fused program every time. LRU-bounded — each entry pins
# a compiled program plus the Mesh/device objects it closes over, so an
# unbounded dict would leak across varying configs/meshes.
_PROGRAM_CACHE = OrderedDict()
_PROGRAM_CACHE_MAX = 32


def _spec_for(name):
    if name == "samples":
        return P(SAMPLE_AXIS, None)
    if name in ("weights", "like_weights"):
        return P(SAMPLE_AXIS)
    return P()


def _build_sharded(mesh, program, static_cfg, arg_names):
    """shard_map + jit wrapper running ``program`` (all_1d/all_2d_densities)
    with samples/weights sharded on the mesh's sample axis and every other
    array replicated; grid-local stages run replicated per device and all
    sample reductions psum over the mesh (the fused programs' ``axis_name``
    hooks)."""
    key = (mesh, program.__name__, static_cfg, arg_names)
    fn = _PROGRAM_CACHE.get(key)
    if fn is not None:
        _PROGRAM_CACHE.move_to_end(key)
        return fn
    specs = {name: _spec_for(name) for name in arg_names}
    static_kwargs = dict(static_cfg)
    static_kwargs["axis_name"] = SAMPLE_AXIS
    if program.__name__ == "all_1d_densities":
        static_kwargs["axis_size"] = int(mesh.devices.size)

    @partial(shard_map, mesh=mesh, in_specs=(specs,), out_specs=P(), check_vma=False)
    def _run(arrays):
        return program(**arrays, **static_kwargs)

    fn = jax.jit(_run)
    _PROGRAM_CACHE[key] = fn
    while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
        _PROGRAM_CACHE.popitem(last=False)
    return fn


def sharded_all_1d_densities(mesh, samples, weights, **kwargs):
    """:func:`getdist_tpu.ops.batched.all_1d_densities` over a sample-sharded
    mesh, same signature/result (replicated). Array kwargs (limits_lo,
    limits_hi, periodic, like_weights, bandwidth_scale, ...) are replicated
    except ``like_weights`` which shards with the samples."""
    from getdist_tpu.ops import batched

    arrays = {"samples": samples, "weights": weights}
    static_cfg = []
    for k, v in kwargs.items():
        if v is None:
            continue
        if k in ("fine_bins", "mult_bias_order"):
            static_cfg.append((k, v))
        else:
            arrays[k] = jnp.asarray(v)
    fn = _build_sharded(mesh, batched.all_1d_densities, tuple(sorted(static_cfg)), tuple(sorted(arrays)))
    return fn(arrays)


_ALL_2D_STATIC = (
    "fine_bins",
    "mult_bias_order",
    "winw",
    "boundary_order",
    "max_corr",
    "enable_shear",
    "exact_mult_bias",
    "export_hists",
)


def sharded_all_2d_densities(mesh, samples, weights, pair_a, pair_b, neff, binmin, binmax, contours, **kwargs):
    """:func:`getdist_tpu.ops.batched.all_2d_densities` over a sample-sharded
    mesh, same signature/result (replicated): the full pipeline — limits,
    periodic axes, shearing, meanlikes, bandwidth overrides, histogram
    reuse — with the pair binning psum'd over the mesh."""
    from getdist_tpu.ops import batched

    arrays = {
        "samples": samples,
        "weights": weights,
        "pair_a": pair_a,
        "pair_b": pair_b,
        "neff": neff,
        "binmin": binmin,
        "binmax": binmax,
        "contours": contours,
    }
    static_cfg = []
    for k, v in kwargs.items():
        if v is None:
            continue
        if k in _ALL_2D_STATIC:
            static_cfg.append((k, v))
        elif k == "bandwidth_override":
            arrays[k] = tuple(jnp.asarray(x) for x in v)
        else:
            arrays[k] = jnp.asarray(v)
    fn = _build_sharded(mesh, batched.all_2d_densities, tuple(sorted(static_cfg)), tuple(sorted(arrays)))
    return fn(arrays)


def sharded_moments(mesh, samples, weights):
    """Global weighted (norm, means, cov) from sample-sharded arrays."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(SAMPLE_AXIS, None), P(SAMPLE_AXIS)),
        out_specs=(P(), P(), P()),
    )
    def _local(s, w):
        norm = jax.lax.psum(jnp.sum(w), SAMPLE_AXIS)
        first = jax.lax.psum(jnp.matmul(w, s, precision=_PREC), SAMPLE_AXIS)
        means = first / norm
        diffs = s - means
        cov = jax.lax.psum(jnp.matmul((diffs * w[:, None]).T, diffs, precision=_PREC), SAMPLE_AXIS) / norm
        return norm, means, cov

    return jax.jit(_local)(samples, weights)


def sharded_hist_1d(mesh, ix, weights, nbins):
    """Global weighted histograms for (P, N)-sharded index rows."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, SAMPLE_AXIS), P(SAMPLE_AXIS)),
        out_specs=P(),
    )
    def _local(ix_shard, w_shard):
        return jax.lax.psum(row_histograms(ix_shard, w_shard, nbins), SAMPLE_AXIS)

    return jax.jit(_local)(ix, weights)


def sharded_pair_hists(mesh, ix, weights, pair_a, pair_b, nbins=256):
    """Global (K, nbins, nbins) pair histograms from sharded index rows:
    each shard bins its local samples, one psum combines the shards."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, SAMPLE_AXIS), P(SAMPLE_AXIS), P(), P()),
        out_specs=P(),
    )
    def _local(ix_shard, w_shard, pa, pb):
        return jax.lax.psum(pair_histograms(ix_shard, w_shard, pa, pb, nbins), SAMPLE_AXIS)

    return jax.jit(_local)(ix, weights, pair_a, pair_b)


@partial(jax.jit, static_argnames=("mesh", "fine_bins", "winw"))
def sharded_triangle_step(mesh, samples, weights, pair_a, pair_b, fine_bins=128, winw=12):
    """One full multi-chip triangle-density step (the dry-run target).

    Sample-sharded inputs -> per-shard range reduction (pmax/pmin), fine
    binning with psum-combined histograms (1D and all pairs), then
    replicated grid-local smoothing. Returns peak-normalized
    (P, fine_bins) and (K, fine_bins, fine_bins) densities.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(SAMPLE_AXIS, None), P(SAMPLE_AXIS), P(), P()),
        out_specs=(P(), P()),
    )
    def _step(s, w, pa, pb):
        cols = s.T
        # global ranges
        mins = jax.lax.pmin(jnp.min(cols, axis=1), SAMPLE_AXIS)
        maxs = jax.lax.pmax(jnp.max(cols, axis=1), SAMPLE_AXIS)
        norm = jax.lax.psum(jnp.sum(w), SAMPLE_AXIS)
        means = jax.lax.psum(jnp.matmul(cols, w, precision=_PREC), SAMPLE_AXIS) / norm
        variances = jax.lax.psum(jnp.matmul((cols - means[:, None]) ** 2, w, precision=_PREC), SAMPLE_AXIS) / norm
        sigmas = jnp.sqrt(variances)

        span = maxs - mins
        binmin = mins - 0.1 * span
        binmax = maxs + 0.1 * span
        width = (binmax - binmin) / (fine_bins - 1)
        ix = jnp.clip(
            (((cols - binmin[:, None]) / width[:, None]) + 0.5).astype(jnp.int32), 0, fine_bins - 1
        )

        hist1 = jax.lax.psum(row_histograms(ix, w, fine_bins), SAMPLE_AXIS)
        hist2 = jax.lax.psum(pair_histograms(ix, w, pa, pb, fine_bins), SAMPLE_AXIS)

        # replicated grid-local smoothing (rule-of-thumb bandwidths)
        neff_proxy = norm**2 / jax.lax.psum(jnp.sum(w * w), SAMPLE_AXIS)
        h1_bins = jnp.clip(1.06 * sigmas / span * neff_proxy ** (-0.2) * fine_bins, 1.0, fine_bins / 4)
        k = jnp.arange(fine_bins + 1, dtype=s.dtype)

        def smooth1(b, sig):
            pad = 2 * fine_bins
            mult = jnp.exp(-2.0 * (np.pi * sig / pad) ** 2 * jnp.arange(pad // 2 + 1, dtype=s.dtype) ** 2)
            return jnp.fft.irfft(jnp.fft.rfft(b, pad) * mult, pad)[:fine_bins]

        dens1 = jax.vmap(smooth1)(hist1, h1_bins)
        dens1 = dens1 / jnp.max(dens1, axis=1, keepdims=True)

        rx = jnp.clip(h1_bins[pa] * 0.8, 0.8, winw / 2.5)
        ry = jnp.clip(h1_bins[pb] * 0.8, 0.8, winw / 2.5)
        kernels = jax.vmap(lambda a, b: _gauss_kernel_2d(a, b, jnp.zeros(()), winw, s.dtype))(rx, ry)
        pad2 = 1 << int(np.ceil(np.log2(fine_bins + 2 * winw)))
        dens2 = _conv2d_same_batch(hist2, kernels, pad2)
        dens2 = dens2 / jnp.max(dens2, axis=(1, 2), keepdims=True)
        return dens1, dens2

    return _step(samples, weights, pair_a, pair_b)


def sharded_triangle_densities(
    mesh,
    samples,
    weights,
    contours=(0.68, 0.95),
    limits_lo=None,
    limits_hi=None,
    periodic=None,
    like_weights=None,
    bandwidth_scale_1d=None,
    bandwidth_scale_2d=None,
    max_corr=0.95,
    enable_shear=True,
    export_hists=False,
):
    """The FULL fused triangle pipeline on a sample-sharded mesh: identical
    algorithm to :func:`getdist_tpu.ops.batched.triangle_densities` (ISJ
    bisection bandwidths, hard-limit boundary kernels, periodic axes,
    frequency-space shearing, meanlikes grids, batched FFT convolutions,
    bias corrections, water-level contours) with every sample reduction
    psum'd over the mesh and the grid-local stages replicated per device.

    The effective sample sizes come from the real lag estimator: each shard
    exchanges a max-lag halo with its neighbor (ppermute) and the per-lag
    pair sums are psum'd, so the short-lag sums are the exact global sums
    (see ``ops.batched._neff_kde_batch``). Returns the (d1, d2) dicts
    (replicated).
    """
    samples = jnp.asarray(samples, jnp.float32)
    weights = jnp.asarray(weights, jnp.float32)
    p = samples.shape[1]
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)], np.int32)
    pa = jnp.asarray(pairs[:, 0])
    pb = jnp.asarray(pairs[:, 1])
    cont = jnp.asarray(np.array(contours, np.float32))

    d1 = sharded_all_1d_densities(
        mesh,
        samples,
        weights,
        limits_lo=limits_lo,
        limits_hi=limits_hi,
        periodic=periodic,
        like_weights=like_weights,
        bandwidth_scale=bandwidth_scale_1d,
    )
    has_limits = limits_lo is not None or limits_hi is not None or periodic is not None
    d2 = sharded_all_2d_densities(
        mesh,
        samples,
        weights,
        pa,
        pb,
        d1["neff"],
        d1["range"][0],
        d1["range"][1],
        cont,
        active_lo=d1["active_lo"] if has_limits else None,
        active_hi=d1["active_hi"] if has_limits else None,
        periodic=periodic,
        like_weights=like_weights,
        sigma_range=d1["sigma_range"],
        max_corr=max_corr if max_corr != 0.95 else None,
        enable_shear=enable_shear if enable_shear is not True else None,
        bandwidth_scale=bandwidth_scale_2d,
        export_hists=export_hists or None,
    )
    return d1, d2
