#!/usr/bin/env python3
"""The ``nvcc`` time of K1's and K2's kernel libraries, in one or two checkouts.

Run from the root of this checkout, optionally with another one (for example
the parent commit, unpacked with ``git archive`` into a git-ignored
directory) as the argument:

    python3 scripts/build_times.py [build/parent] [--runs 2]

Each round builds, in each checkout in turn (other, this, then this, other
in the next round), the main and the ablation (``-DFPM_ABLATE``) library of
``epry_sweep`` (K2) and ``epry_chunked`` (K1) anew: the four ``nvcc`` runs of
a checkout start together, one process each, as ``fpm_torch.ops.build``
starts a build, and each process's seconds are its library's. One JSON line
per round, then one line with each library's median per checkout. Needs the
CUDA toolkit, not a card; builds each checkout's libraries in its own
``build/``. It never imports JAX or ``fpm_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEMS = ("epry_sweep", "epry_chunked")

CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from fpm_torch.ops import build
assert build.__file__.startswith(sys.argv[1]), build.__file__
stem, extra = sys.argv[2], build.ABLATE_FLAGS if sys.argv[3] == "ablation" else []
path = build._lib_path(build.CSRC / (stem + ".cu"), build.NVCC_FLAGS + extra)
if path.exists():
    path.unlink()
t = time.perf_counter()
build._build([((stem,), extra)])
print(time.perf_counter() - t)
"""


def build_round(root: str) -> dict:
    """Seconds of each library of ``root``, all four builds started together."""
    root = os.path.abspath(root)
    procs = {f"{stem} {kind}": subprocess.Popen(
        [sys.executable, "-c", CHILD, root, stem, kind], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for stem in STEMS for kind in ("main", "ablation")}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=1200)
        if proc.returncode:
            raise RuntimeError(f"{root} {name} exited {proc.returncode}: {stderr[-3000:]}")
        out[name] = float(stdout.split()[-1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the root of another checkout")
    ap.add_argument("--runs", type=int, default=2, help="rounds (default 2)")
    args = ap.parse_args(argv)
    roots = {"this": HERE}
    if args.other:
        roots["other"] = args.other
    times: dict = {label: {} for label in roots}
    for r in range(args.runs):
        order = list(roots) if r % 2 else list(reversed(roots))
        line = {"round": r}
        for label in order:
            line[label] = build_round(roots[label])
            for name, sec in line[label].items():
                times[label].setdefault(name, []).append(sec)
        print(json.dumps(line), flush=True)
    print(json.dumps({"median_s": {label: {name: statistics.median(v) for name, v in t.items()}
                                   for label, t in times.items()},
                      "roots": {label: os.path.abspath(p) for label, p in roots.items()},
                      "runs": args.runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
