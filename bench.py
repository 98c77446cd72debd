#!/usr/bin/env python
"""Benchmark: all-pairs triangle densities for a 30-param, 1M-sample chain.

The BASELINE.json headline workload: 30 x 1D + 435 x 2D marginalized KDE
densities of a weighted MCMC chain, via the fused device pipeline
(getdist_tpu.ops.batched). Prints ONE JSON line:

    {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <speedup>}

vs_baseline is the measured speedup over the reference implementation
(cmbant/getdist on CPU). The reference was MEASURED at full scale on this
exact chain (not extrapolated): 119.3 s wall-clock (of which 1D = 10.1 s)
on the shared bench host, 2026-08-17 — re-measure with ``--measure-ref``
(~2 min). ``--sharded`` instead times the sample-sharded multi-device
pipeline (``parallel.reductions.sharded_triangle_densities``) on whatever
mesh exists, re-exec'ing onto a virtual 8-device CPU mesh when only one
device is visible. ``--parity`` times the host parity mode (CPU, f64) and
``--parity-device`` the parity mode's device variant. Every metric string
names the device it ran on.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_PARAMS = 30
N_SAMPLES = 1_000_000
SCALE_P = 6
SCALE_N = 100_000
REFERENCE_PATH = "/root/reference"
# full-scale measurement of the reference on make_chain(N_SAMPLES, N_PARAMS)
# (see BASELINE.md "Round-3 measurements"); refresh with --measure-ref
REF_FULL_MEASURED_S = 119.3


def make_chain(n, p, seed=7):
    """Planck-like correlated chain: AR(1)-correlated walk over a random
    covariance, integer weights."""
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((p, p)) * 0.3 + np.eye(p)
    cov = A @ A.T
    L = np.linalg.cholesky(cov)
    steps = rng.standard_normal((n, p)) @ L.T
    rho = 0.8
    x = np.empty((n, p), np.float64)
    x[0] = steps[0]
    fac = np.sqrt(1 - rho**2)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + fac * steps[i]
    weights = rng.randint(1, 5, n).astype(np.float64)
    return x, weights


def run_ours(samples, weights, repeats=7):
    """Time the PUBLIC end-to-end API: ``MCSamples.fastTriangleDensities``,
    including every host rescue pass (sheared-bandwidth assists, fragile
    re-derivations, corr-adaptive regrids, saturated-window and wide-1D
    rescues) — the same path the accuracy tests validate. ``--program``
    instead times the raw fused program (no MCSamples layer), the
    subset number rounds 1-3 reported."""
    print("# compiling + first run...", file=sys.stderr)
    import jax

    from getdist_tpu.mcsamples import MCSamples

    names = [f"p{i}" for i in range(samples.shape[1])]
    mc = MCSamples(samples=samples, weights=weights, names=names)

    jax.block_until_ready(mc.fastTriangleDensities())
    print("# compiled; timing warm runs", file=sys.stderr)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(mc.fastTriangleDensities())
        times.append(time.perf_counter() - t0)
    return min(times)


def run_program_only(samples, weights, repeats=7):
    """The raw fused device program, no public-API layer (subset number)."""
    print("# compiling + first run...", file=sys.stderr)
    import jax
    import jax.numpy as jnp

    from getdist_tpu.ops import batched

    dev_s, dev_w = batched.prepare_chain(samples, weights)
    p = dev_s.shape[1]
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)], np.int32)
    pa = jnp.asarray(pairs[:, 0])
    pb = jnp.asarray(pairs[:, 1])
    contours = jnp.asarray(np.array([0.68, 0.95], np.float32))
    shear = batched._sniff_shear(samples, 0.95, pairs=pairs, weights=weights)

    def full():
        # single fused program = single device dispatch
        return batched._triangle_program(
            dev_s, dev_w, pa, pb, contours, None, None, None, 256, False, enable_shear=shear
        )

    jax.block_until_ready(full())
    print("# compiled; timing warm runs", file=sys.stderr)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(full())
        times.append(time.perf_counter() - t0)
    return min(times)


def run_reference(samples, weights):
    sys.path.insert(0, REFERENCE_PATH)
    import getdist.chains as ref_chains

    ref_chains.print_load_details = False
    from getdist.mcsamples import MCSamples as RefMCSamples

    names = [f"p{i}" for i in range(samples.shape[1])]
    t0 = time.perf_counter()
    mc = RefMCSamples(samples=samples, weights=weights, names=names)
    for i in range(samples.shape[1]):
        mc.get1DDensityGridData(i)
    for i in range(samples.shape[1]):
        for j in range(i + 1, samples.shape[1]):
            mc.get2DDensityGridData(i, j)
    return time.perf_counter() - t0


def run_sharded(samples, weights, repeats=3):
    """Time the sample-sharded pipeline over all visible devices.

    With a single visible device, re-exec onto a virtual 8-device CPU mesh
    (the configuration ``__graft_entry__.dryrun_multichip`` checks). The
    virtual mesh timeshares one host CPU, so the workload is scaled down
    there (the number is a weak-scaling smoke baseline, not a device figure)."""
    import jax

    if jax.device_count() < 2:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__), "--sharded"], env)

    from getdist_tpu import backend
    from getdist_tpu.parallel.mesh import make_mesh
    from getdist_tpu.parallel.reductions import sharded_triangle_densities

    if backend.platform() == "cpu":
        samples, weights = samples[::10, :12].copy(), weights[::10].copy()

    mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    # pad the sample axis to a multiple of the mesh
    n = samples.shape[0] // n_dev * n_dev
    run = lambda: sharded_triangle_densities(mesh, samples[:n], weights[:n])  # noqa: E731
    jax.block_until_ready(run())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return min(times), n_dev


def run_parity(samples, weights, repeats=2):
    """Time the reference-exact parity mode (f64 fused programs on CPU x64).

    The "fast AND faithful" number: <= ~1e-5 max-grid delta vs the
    reference pipeline (measured 1.9e-7 worst-case on the distribution
    zoo), against the same measured full-scale reference wall-clock.
    Each repeat builds a FRESH MCSamples (no analysis caches carry over);
    taking the min reports the steady state where the fixed-shape f64
    conv programs are XLA-cached (the kernel-window buckets are
    cache-stable across chains by design), i.e. every chain after the
    process's first."""
    # the host parity mode is a CPU pipeline: decide from the env so the
    # accelerator is never initialised for it
    if os.environ.get("JAX_PLATFORMS") != "cpu":
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__), "--parity"], env)
    import jax

    jax.config.update("jax_enable_x64", True)

    from getdist_tpu.mcsamples import MCSamples

    names = [f"p{i}" for i in range(samples.shape[1])]
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        mc = MCSamples(samples=samples, weights=weights, names=names)
        mc.fastParityDensities()
        times.append(time.perf_counter() - t0)
    return min(times)


def run_parity_device(samples, weights, repeats=3):
    """Time the reference-exact parity mode on the device
    (``fastParityDensities(device=True)``): O(N) stages as f64 device
    programs, exact device histograms with compact uint16 readbacks into
    the host-exact bandwidth optimizers, f64 fused convolutions,
    device-resident output grids (the same convention as the fused
    headline path).

    Each repeat builds a FRESH MCSamples (no analysis caches carry over),
    but the device-resident chain upload is transplanted between repeats,
    as the fused headline path excludes it via its warm-call convention."""
    import jax

    jax.config.update("jax_enable_x64", True)

    from getdist_tpu.mcsamples import MCSamples

    names = [f"p{i}" for i in range(samples.shape[1])]
    print("# compiling + first run...", file=sys.stderr)
    mc = MCSamples(samples=samples, weights=weights, names=names)
    jax.block_until_ready(mc.fastParityDensities(device=True, materialize=False)[1])
    chain_cache = mc._fast_chain_state()
    print("# compiled; timing warm runs", file=sys.stderr)
    times = []
    for _ in range(repeats):
        fresh = MCSamples(samples=samples, weights=weights, names=names)
        fresh._fast_chain_cache = chain_cache
        t0 = time.perf_counter()
        jax.block_until_ready(fresh.fastParityDensities(device=True, materialize=False)[1])
        times.append(time.perf_counter() - t0)
    return min(times)


def _device_name():
    import jax

    dev = jax.devices()[0]
    return f"{jax.device_count()}x {dev.platform} ({dev.device_kind})"


def main():
    full_samples, full_weights = make_chain(N_SAMPLES, N_PARAMS)

    if "--parity-device" in sys.argv:
        parity_s = run_parity_device(full_samples, full_weights)
        print(
            json.dumps(
                {
                    "metric": "PARITY-EXACT all-pairs densities on the device (device O(N) + host-exact "
                    f"bandwidths), 30p x 1M, {_device_name()}",
                    "value": round(parity_s * 1000, 2),
                    "unit": "ms",
                    "vs_baseline": round(REF_FULL_MEASURED_S / parity_s, 1),
                    "vs_baseline_semantics": "speedup_vs_reference_cpu_wallclock",
                }
            )
        )
        return

    if "--parity" in sys.argv:
        parity_s = run_parity(full_samples, full_weights)
        print(
            json.dumps(
                {
                    "metric": "PARITY-EXACT all-pairs densities (<=1e-5 vs reference), 30p x 1M, "
                    f"{_device_name()} f64",
                    "value": round(parity_s * 1000, 2),
                    "unit": "ms",
                    "vs_baseline": round(REF_FULL_MEASURED_S / parity_s, 1),
                    "vs_baseline_semantics": "speedup_vs_reference_cpu_wallclock",
                }
            )
        )
        return

    if "--sharded" in sys.argv:
        sharded_s, n_dev = run_sharded(full_samples, full_weights)
        import jax

        on_device = jax.devices()[0].platform != "cpu"
        size = "30p x 1M" if on_device else "12p x 100k (virtual-mesh smoke)"
        print(
            json.dumps(
                {
                    "metric": f"sharded all-pairs densities, {size}, {_device_name()}",
                    "value": round(sharded_s * 1000, 2),
                    "unit": "ms",
                    # the reference measurement is for the full-size workload;
                    # the scaled virtual-mesh smoke run has no baseline
                    "vs_baseline": round(REF_FULL_MEASURED_S / sharded_s, 1) if on_device else None,
                    "vs_baseline_semantics": "speedup_vs_reference_cpu_wallclock",
                }
            )
        )
        return

    if "--program" in sys.argv:
        ours_s = run_program_only(full_samples, full_weights)
        metric = "fused program only (no public-API layer), 30 params x 1M weighted samples"
    else:
        ours_s = run_ours(full_samples, full_weights)
        metric = "public fastTriangleDensities end-to-end (all rescue passes), 30 params x 1M weighted samples"
    metric += f", {_device_name()}"

    if "--measure-ref" in sys.argv:
        ref_full = run_reference(full_samples, full_weights)
        print(f"# measured reference at FULL scale: {ref_full:.1f} s", file=sys.stderr)
    else:
        ref_full = REF_FULL_MEASURED_S
    print(
        f"# ours full: {ours_s * 1000:.1f} ms | reference full-scale (measured): {ref_full:.1f} s",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(ours_s * 1000, 2),
                "unit": "ms",
                # speedup ratio: measured reference wall-clock / ours
                "vs_baseline": round(ref_full / ours_s, 1),
                "vs_baseline_semantics": "speedup_vs_reference_cpu_wallclock",
            }
        )
    )


if __name__ == "__main__":
    main()
