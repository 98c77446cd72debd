#!/usr/bin/env python
"""Smoke test of getdist_tpu on NVIDIA GPUs: the quickest proof that the
public density path runs on the card and gives the right answers.

    python chip_smoke.py           # one card, every phase below
    python chip_smoke.py --multi   # four cards: sharded pipeline vs one card

Phases (one card): device, pair histograms, the public fused path
(``MCSamples.fastTriangleDensities`` on 30 params x 1M samples), batched
FFT convolutions, the 2D distribution zoo against the host parity path,
and the parity device mode against the host parity mode. Each phase prints
one JSON line; the last line is ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result.
It also exits non-zero when JAX finds no GPU, or when the script is run
outside a checkout of the repository.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# f32 pair histograms with fractional weights: the atomics add in an order
# of their own, so each bin carries f32 rounding ~ sqrt(count) * 2**-24 of
# its total; bound it at 1e-5 of the peak bin.
HIST_FRAC_TOL = 1e-5
# cuFFT f32 'same' convolution vs a float64 numpy FFT: f32 round-off grows
# ~log2(pad**2) * 2**-24; bound it at 1e-5 of each grid's peak.
CONV_TOL = 1e-5
# fused f32 path vs the host parity path on the zoo: the bars of
# tests/test_zoo_fidelity.py (f32 + lag-grid N_eff approximations).
ZOO_TOL = {"tight": 7e-3, "cut correlated": 7e-3, "hammer": 6e-3, "trimodal WJ1": 6e-3}
ZOO_DEFAULT_TOL = 5e-3
# parity device mode vs host parity mode: the README's bar.
PARITY_TOL = 1e-5
# sharded vs one-card grids: reduction order of f32 moments and psum'd lag
# sums (the bars of tests/test_parallel.py's public-path comparison).
MULTI_GRID_TOL = 2e-5
MULTI_CONTOUR_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def _timed(fn, reps):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit(
        phase="device",
        nvidia_smi=smi.splitlines(),
        kind=dev.device_kind,
        count=len(jax.devices()),
        jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
    )
    return dev


def _bin_indices(x, nbins=256):
    lo, hi = x.min(axis=0), x.max(axis=0)
    span = hi - lo
    binmin = lo - 0.1 * span
    width = (1.2 * span) / (nbins - 1)
    return np.clip(((x - binmin) / width + 0.5).astype(np.int32), 0, nbins - 1).T.copy()


def phase_histograms(x, w_int):
    import jax.numpy as jnp

    from getdist_tpu.ops import histograms

    ix = _bin_indices(x)
    p = ix.shape[0]
    pairs = np.array([(a, b) for a in range(p) for b in range(a + 1, p)], np.int32)
    w_frac = np.random.default_rng(3).uniform(0.5, 2.0, x.shape[0])

    def reference(w):
        return np.stack(
            [np.bincount(ix[b] * 256 + ix[a], weights=w, minlength=65536).reshape(256, 256) for a, b in pairs]
        )

    ref_int, ref_frac = reference(w_int), reference(w_frac)
    ix_d, pa, pb = jnp.asarray(ix), jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    wi, wf = jnp.asarray(w_int, jnp.float32), jnp.asarray(w_frac, jnp.float32)
    import jax

    routes = {
        "cuda_smem": jax.jit(lambda i, w: histograms.pair_histograms(i, w, pa, pb, 256)),
        "xla_scatter": jax.jit(lambda i, w: histograms._scatter_pair_histograms(i, w, pa, pb, 256)),
    }
    result = {}
    for name, fn in routes.items():
        out, first, warm = _timed(lambda fn=fn: fn(ix_d, wi), reps=5)
        exact = bool(np.array_equal(np.asarray(out, np.float64), ref_int))
        frac = np.asarray(fn(ix_d, wf), np.float64)
        frac_err = float(np.max(np.abs(frac - ref_frac)) / np.max(ref_frac))
        result[name] = {"first_s": first, "warm_ms": warm * 1e3, "int_exact": exact, "frac_err": frac_err}
        check(exact, f"{name}: integer-weight pair histograms differ from np.bincount")
        check(frac_err <= HIST_FRAC_TOL, f"{name}: fractional-weight error {frac_err} > {HIST_FRAC_TOL}")
    rows = np.asarray(histograms.row_histograms(jnp.asarray(_bin_indices(x, 1024)), wi, 1024), np.float64)
    rows_ref = np.stack([np.bincount(r, weights=w_int, minlength=1024) for r in _bin_indices(x, 1024)])
    check(np.array_equal(rows, rows_ref), "1D row histograms differ from np.bincount")
    emit(phase="pair_histograms", shape=[len(pairs), 256, 256], samples=int(x.shape[0]), routes=result)
    return ref_int


def _check_fused_output(d1, d2, n_params):
    p1 = np.asarray(d1["P"])
    check(p1.shape == (n_params, 1024) and np.all(np.isfinite(p1)), "1D grids not finite / wrong shape")
    check(np.allclose(p1.max(axis=1), 1.0, atol=1e-6), "1D grids not peak-normalised")
    grids = [np.asarray(d2["P"])] + [np.asarray(e["P"])[None] for e in d2["regrid"].values()]
    levels = [np.asarray(d2["contours"])] + [np.asarray(e["contours"])[None] for e in d2["regrid"].values()]
    for g, lev in zip(grids, levels):
        check(np.all(np.isfinite(g)), "2D grids not finite")
        check(np.allclose(g.max(axis=(1, 2)), 1.0, atol=1e-6), "2D grids not peak-normalised")
        check(np.all(np.isfinite(lev)) and np.all(lev[:, 0] > lev[:, 1]) and np.all(lev[:, 1] > 0),
              "contour levels not ordered (68% above 95% above 0)")


def phase_public(x, w_int):
    from getdist_tpu.mcsamples import MCSamples
    from getdist_tpu.ops import histograms

    t0 = time.perf_counter()
    histograms.build_cuda_library()
    build_s = time.perf_counter() - t0
    names = [f"p{i}" for i in range(x.shape[1])]
    mc = MCSamples(samples=x, weights=w_int, names=names)
    out, cold, warm = _timed(mc.fastTriangleDensities, reps=5)
    d1, d2, pairs = out
    _check_fused_output(d1, d2, x.shape[1])
    emit(
        phase="public_fused",
        call="MCSamples.fastTriangleDensities",
        params=x.shape[1],
        samples=int(x.shape[0]),
        pairs=len(pairs),
        cuda_build_s=build_s,
        cold_s=cold,
        warm_ms=warm * 1e3,
        regrid_pairs=len(d2["regrid"]),
    )
    return d2


def phase_convolutions(d2, hists):
    import jax
    import jax.numpy as jnp

    from getdist_tpu.ops.batched import _conv2d_same_kf, _gauss_kernel_2d
    from getdist_tpu.ops.fft import next_fast_len

    winw, fine = 30, 256
    pad = next_fast_len(fine + 2 * winw)
    rx, ry, corr = (np.asarray(d2[k], np.float64) for k in ("rx", "ry", "corr"))
    kern = np.asarray(
        jax.vmap(lambda a, b, c: _gauss_kernel_2d(a, b, c, winw, jnp.float32))(
            jnp.asarray(rx, jnp.float32), jnp.asarray(ry, jnp.float32), jnp.asarray(corr, jnp.float32)
        ),
        np.float64,
    )
    grids = jnp.asarray(hists, jnp.float32)
    kf = jnp.fft.rfftn(jnp.asarray(kern, jnp.float32), (pad, pad), axes=(1, 2))
    out, first, warm = _timed(lambda: _conv2d_same_kf(grids, kf, pad, winw), reps=5)
    out = np.asarray(out, np.float64)
    worst = 0.0
    for k in range(hists.shape[0]):
        spec = np.fft.rfftn(hists[k], (pad, pad), axes=(0, 1)) * np.fft.rfftn(kern[k], (pad, pad), axes=(0, 1))
        want = np.fft.irfftn(spec, (pad, pad), axes=(0, 1))[winw : winw + fine, winw : winw + fine]
        worst = max(worst, float(np.max(np.abs(out[k] - want)) / np.max(np.abs(want))))
    check(worst <= CONV_TOL, f"f32 FFT convolution error {worst} > {CONV_TOL}")
    with jax.enable_x64(True):
        g64 = jnp.asarray(hists, jnp.float64)
        kf64 = jnp.fft.rfftn(jnp.asarray(kern), (pad, pad), axes=(1, 2))
        _, _, warm64 = _timed(lambda: _conv2d_same_kf(g64, kf64, pad, winw), reps=5)
    emit(
        phase="convolutions",
        shape=list(hists.shape),
        pad=pad,
        f32_first_s=first,
        f32_warm_ms=warm * 1e3,
        f64_warm_ms=warm64 * 1e3,
        max_err_vs_numpy_f64=worst,
    )


def phase_zoo():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from scipy.interpolate import RectBivariateSpline
    from zoo import shapes_2d

    from getdist_tpu import chains

    chains.print_load_details = False
    deltas = {}
    t0 = time.perf_counter()
    for label, shape in shapes_2d().items():
        samps = shape.MCSamples(40000, random_state=7)
        samps._force_host_densities = True  # the host parity path, not the fused routing
        ref = samps.get2DDensityGridData(0, 1)
        samps._force_host_densities = False
        _, dens2 = samps.fastDensities()
        fused = dens2[(samps.parName(0), samps.parName(1))]
        spline = RectBivariateSpline(fused.y, fused.x, fused.P)
        gx, gy = np.meshgrid(ref.x, ref.y)
        approx = spline.ev(gy.ravel(), gx.ravel()).reshape(gy.shape)
        exact = ref.P / ref.P.max()
        approx = approx / approx.max()
        sel = exact > 0.05
        deltas[label] = float(np.max(np.abs(approx[sel] - exact[sel])))
    failed = {k: v for k, v in deltas.items() if not v < ZOO_TOL.get(k, ZOO_DEFAULT_TOL)}
    emit(phase="zoo_2d", samples=40000, seconds=time.perf_counter() - t0, max_grid_delta=deltas)
    check(not failed, f"zoo shapes over their bars: {failed}")


def phase_parity():
    import jax

    jax.config.update("jax_enable_x64", True)
    from bench import make_chain
    from getdist_tpu.mcsamples import MCSamples

    x, w = make_chain(200_000, 8, seed=11)
    names = [f"p{i}" for i in range(x.shape[1])]
    dev_mc = MCSamples(samples=x, weights=w, names=names)
    host_calls = []
    device_impl = dev_mc.fastParityDensities

    def spy(*args, **kwargs):
        host_calls.append(not kwargs.get("device", False))
        return device_impl(*args, **kwargs)

    dev_mc.fastParityDensities = spy  # the host fallback calls back through here
    t0 = time.perf_counter()
    dens1_dev, dens2_dev = dev_mc.fastParityDensities(device=True)
    device_s = time.perf_counter() - t0
    check(not any(host_calls), "parity device mode fell back to the host pipeline")
    check(dev_mc._fast_chain_cache is not None, "parity device mode never put the chain on the device")
    t0 = time.perf_counter()
    dens1_host, dens2_host = MCSamples(samples=x, weights=w, names=names).fastParityDensities()
    host_s = time.perf_counter() - t0
    check(dens2_dev.keys() == dens2_host.keys(), "parity modes returned different pairs")
    delta2 = max(float(np.max(np.abs(dens2_dev[k].P - dens2_host[k].P))) for k in dens2_host)
    delta1 = max(float(np.max(np.abs(dens1_dev[k].P - dens1_host[k].P))) for k in dens1_host)
    emit(
        phase="parity_device",
        params=x.shape[1],
        samples=int(x.shape[0]),
        device_s=device_s,
        host_s=host_s,
        max_grid_delta_2d=delta2,
        max_grid_delta_1d=delta1,
    )
    check(delta2 <= PARITY_TOL and delta1 <= PARITY_TOL, f"parity device vs host {delta2}/{delta1} > {PARITY_TOL}")


def phase_multi(n_cards=4):
    import jax
    import jax.numpy as jnp

    from bench import make_chain
    from getdist_tpu.mcsamples import MCSamples
    from getdist_tpu.parallel.mesh import make_mesh, shard_samples

    check(len(jax.devices()) >= n_cards, f"--multi needs {n_cards} GPUs, JAX found {len(jax.devices())}")
    mesh = make_mesh(n_cards)
    x, w = make_chain(4_000_000, 30)
    dev_s, _ = shard_samples(mesh, jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32))
    placed = {sh.device.id: sh.data.shape[0] for sh in dev_s.addressable_shards}
    check(len(placed) == n_cards and set(placed.values()) == {x.shape[0] // n_cards},
          f"samples not spread over {n_cards} devices: {placed}")
    del dev_s
    mc = MCSamples(samples=x, weights=w, names=[f"p{i}" for i in range(x.shape[1])])
    (d1s, d2s, _), cold_s, warm_s = _timed(lambda: mc.fastTriangleDensities(mesh=mesh), reps=3)
    (d1u, d2u, _), cold_u, warm_u = _timed(mc.fastTriangleDensities, reps=3)
    _check_fused_output(d1s, d2s, x.shape[1])
    d1_err = float(np.max(np.abs(np.asarray(d1s["P"]) - np.asarray(d1u["P"]))))
    d2_err = float(np.max(np.abs(np.asarray(d2s["P"]) - np.asarray(d2u["P"]))))
    lev_err = float(np.max(np.abs(np.asarray(d2s["contours"]) / np.asarray(d2u["contours"]) - 1)))
    memory = {d.id: (d.memory_stats() or {}).get("peak_bytes_in_use") for d in jax.devices()[:n_cards]}
    emit(
        phase="multi",
        cards=n_cards,
        params=x.shape[1],
        samples=int(x.shape[0]),
        sharded_cold_s=cold_s,
        sharded_warm_ms=warm_s * 1e3,
        one_card_cold_s=cold_u,
        one_card_warm_ms=warm_u * 1e3,
        peak_bytes_per_card=memory,
        max_delta_1d=d1_err,
        max_delta_2d=d2_err,
        max_contour_rel=lev_err,
    )
    check(d1_err <= MULTI_GRID_TOL and d2_err <= MULTI_GRID_TOL, f"sharded vs one card: {d1_err}/{d2_err}")
    check(lev_err <= MULTI_CONTOUR_RTOL, f"sharded vs one card contour levels: {lev_err}")


def main(argv):
    if not os.path.isdir(os.path.join(HERE, "getdist_tpu")):
        print("chip_smoke: run from a checkout of the repository (getdist_tpu/ not found)", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    dev = phase_device()
    import jax

    if "--multi" in argv:
        phase_multi()
    else:
        from bench import make_chain

        x, w = make_chain(1_000_000, 30)
        hists = phase_histograms(x, w)
        d2 = phase_public(x, w)
        phase_convolutions(d2, hists)
        phase_zoo()
        phase_parity()
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                            "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
