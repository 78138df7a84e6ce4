#!/usr/bin/env python3
"""K2 on the mono cell's shape, phase by phase, in one or two checkouts.

Run from the root of this checkout, on a machine with one CUDA card:

    python3 scripts/k2_profile.py [--other DIR] [--out FILE]

The problem is the sequential cell's (``benchmarks_torch/mono_dome_np90.json``:
Np 90, bbox 64, 193 LEDs, frames simulated from seed 0). For each checkout,
in its own process with that checkout first on ``sys.path``:

- ``k2_phase_profile``: one sweep through K2's cycle-counting build
  (``kernels.k2_phase_profile``), SM cycles per LED of each phase and their
  sum, at each tier, after one sweep to warm;
- ``ms_per_sweep``: the sweep loop as ``reconstruct`` runs it
  (``bench.solver``) on the sequential cell's ladder (5/55 sweeps, 5
  repetitions, CUDA events), at each tier; and ``ms_per_problem_sweep`` of
  the same loop with P = 16, 66 and 132 problems in one launch (the
  ``--fov-grid`` ROI runner's problem axis), bf16x3, on a ladder of 2/6
  sweeps.

With ``--other`` the runs go other, this, this, other (one card, in turns).
One JSON line per run, then, with ``--other``, one line that gives each
number of both checkouts side by side. Digests, ptxas resources and SASS
of two checkouts: ``scripts/compare_checkouts.py``. Never imports JAX or
``fpm_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import fpm_torch
from fpm_torch import bench
from fpm_torch.data.simulate import make_test_object, simulate_images
from fpm_torch.geometry import compute_geometry
from fpm_torch.ops import kernels
assert fpm_torch.__file__.startswith(root), fpm_torch.__file__

cfg, _ = bench.cell_config(root + "/benchmarks_torch/mono_dome_np90.json")
geom = compute_geometry(cfg)
frames = simulate_images(make_test_object(cfg.n_large, seed=0), geom, cfg, quantize=True)
k_leds = len(geom.schedule)
out = {"leds": k_leds, "k2_phase_profile": {}, "ms_per_sweep": {}}
for tier in ("bf16x3", "highest"):
    solve = bench.solver(cfg, geom, frames, "cuda", mode="sequential", dft_precision=tier)
    args = (*solve.state, *solve.operands)
    kernels.k2_phase_profile(*args, **solve.options)                    # built and warm
    _, cycles = kernels.k2_phase_profile(*args, **solve.options)
    per_led = {name: c / k_leds for name, c in cycles.items()}
    out["k2_phase_profile"][tier] = {"cycles_per_led": sum(per_led.values()),
                                     "cluster_size": kernels.fused_epry_sweep.cluster_size,
                                     "by_phase": per_led}
    sweep = solve.sweeps()
    out["ms_per_sweep"][tier] = bench.ladder(bench.cuda_clock(sweep, solve.state), 5, 55, 5,
                                             log=lambda m: None)[0] * 1e3
out["ms_per_problem_sweep"], out["cluster_size_by_problems"] = {}, {}
for p in (16, 66, 132):
    solve = bench.solver(cfg, geom, frames, "cuda", problems=p, mode="sequential",
                         dft_precision="bf16x3")
    ms = bench.ladder(bench.cuda_clock(solve.sweeps(), solve.state), 2, 6, 2,
                      log=lambda m: None)[0] * 1e3
    out["ms_per_problem_sweep"][str(p)] = ms / p
    out["cluster_size_by_problems"][str(p)] = kernels.fused_epry_sweep.cluster_size
print("RUN " + json.dumps(out), flush=True)
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root)],
                         cwd=os.path.abspath(root), capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"{root} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("RUN ")][-1][4:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the root of another checkout, run in turns with this one")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    order = ([("other", args.other), ("this", HERE), ("this", HERE), ("other", args.other)]
             if args.other else [("this", HERE)])
    lines, runs = [], []
    for name, root in order:
        res = run(root)
        lines.append(json.dumps({"checkout": name, "root": root, **res, "gpu": smi}))
        print(lines[-1], flush=True)
        runs.append((name, res))
    if args.other:
        by = {name: [r for n, r in runs if n == name] for name in ("other", "this")}

        def side(get):
            return {name: [get(r) for r in rs] for name, rs in by.items()}

        phases = list(by["this"][0]["k2_phase_profile"]["bf16x3"]["by_phase"])
        lines.append(json.dumps({
            "ms_per_sweep": {t: side(lambda r, t=t: r["ms_per_sweep"][t])
                             for t in ("bf16x3", "highest")},
            "ms_per_problem_sweep": {p: side(lambda r, p=p: r["ms_per_problem_sweep"][p])
                                     for p in ("16", "66", "132")},
            "cycles_per_led": {t: side(lambda r, t=t: r["k2_phase_profile"][t]["cycles_per_led"])
                               for t in ("bf16x3", "highest")},
            "bf16x3_by_phase": {ph: side(lambda r, ph=ph: r["k2_phase_profile"]["bf16x3"]
                                         ["by_phase"].get(ph)) for ph in phases},
            "order": [n for n, _ in order], "gpu": smi}))
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
