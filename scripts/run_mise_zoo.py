#!/usr/bin/env python
"""MISE sweep over the reference distribution zoo, parity vs fused path.

Re-creates the reference's published accuracy methodology
(``getdist/tests/test_distributions.py:341-420``, arXiv:1910.13970): for
each zoo shape, mean integrated squared error against the analytic density
over a grid of bandwidth scalings, with 1D bandwidth-failure counting.
Runs BOTH the host parity path and the fused device pipeline and writes a
per-shape table to ``docs/mise_zoo.md``.

Usage: python scripts/run_mise_zoo.py [--quick] [--out FILE]
  --quick: fewer sims/scales (the committed table's setting; ~15 min CPU)
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from zoo import mise_sweep_1d, mise_sweep_2d, shapes_1d, shapes_2d  # noqa: E402

from getdist_tpu import chains as tchains  # noqa: E402

tchains.print_load_details = False


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--out", default=os.path.join(REPO, "docs", "mise_zoo.md"))
    args = parser.parse_args()

    if args.quick:
        nsim_1d, nsim_2d = 12, 6
        scales = np.array([0.7, 1.0, 1.3])
    else:
        nsim_1d, nsim_2d = 50, 20
        scales = np.arange(0.6, 1.5, 0.1)

    lines = [
        "# MISE over the reference distribution zoo",
        "",
        "Mean integrated squared error vs the analytic density, averaged over",
        f"{nsim_2d} (2D) / {nsim_1d} (1D) simulations of 10000 samples, at bandwidth",
        f"scalings {np.round(scales, 2).tolist()} (reference methodology:",
        "`test_distributions.py:341-420`, arXiv:1910.13970). 'ratio' is",
        "fused-path MISE / parity-path MISE at scaling 1.0 — 1.00 means the",
        "fused pipeline's estimates are statistically as good as the",
        "reference algorithm's.",
        "",
        f"Generated by `scripts/run_mise_zoo.py{' --quick' if args.quick else ''}`; regenerate after any",
        "change to the fused bandwidth/convolution machinery.",
        "",
    ]

    mid = int(np.argmin(np.abs(scales - 1.0)))

    lines += ["## 2D shapes", "", "| shape | parity MISE | fused MISE | ratio |", "|---|---|---|---|"]
    t0 = time.time()
    for label, prob in shapes_2d().items():
        _, mise_p = mise_sweep_2d(prob, nsim=nsim_2d, scales=scales)
        _, mise_f = mise_sweep_2d(prob, nsim=nsim_2d, scales=scales, fused=True)
        ratio = mise_f[mid] / mise_p[mid]
        lines.append(f"| {label} | {mise_p[mid]:.4f} | {mise_f[mid]:.4f} | {ratio:.2f} |")
        print(f"2D {label:16s} parity {mise_p[mid]:.4f} fused {mise_f[mid]:.4f} ratio {ratio:.2f}", flush=True)

    lines += [
        "",
        "## 1D shapes",
        "",
        "All ratios sit at ~1.1 or below. History of the former outliers:",
        "'flat' (1.36 -> 1.00) was fixed by the reference range/4 bandwidth",
        "cap + host-convention rescue for wide-kernel bounded shapes",
        "(13ca99e); 'trimodal' (5.09 in the stale round-3 table) was",
        "an ISJ root-bracketing loss (XLA hoisted an overflowing",
        "loop-invariant out of the gamma chain) fixed by the log-space",
        "reformulation in ops.batched._isj_log_gamma, plus table staleness.",
        "",
        "| shape | parity MISE | fused MISE | ratio | bandwidth failures |",
        "|---|---|---|---|---|",
    ]
    for label, prob in shapes_1d().items():
        _, mise_p, fail_p = mise_sweep_1d(prob, nsim=nsim_1d, scales=scales)
        _, mise_f, fail_f = mise_sweep_1d(prob, nsim=nsim_1d, scales=scales, fused=True)
        ratio = mise_f[mid] / mise_p[mid]
        lines.append(
            f"| {label} | {mise_p[mid]:.5f} | {mise_f[mid]:.5f} | {ratio:.2f} | {fail_p}/{fail_f} |"
        )
        print(f"1D {label:16s} parity {mise_p[mid]:.5f} fused {mise_f[mid]:.5f} ratio {ratio:.2f}", flush=True)

    lines.append("")
    lines.append(f"Wall-clock: {time.time() - t0:.0f} s on the build host CPU.")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
