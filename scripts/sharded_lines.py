#!/usr/bin/env python3
"""The ``sharded_sweep`` lines of two checkouts on one card, each checkout's
own ``chip_smoke.py`` run on its own package.

Run from the root of this checkout, with the other one (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory)
as the argument:

    python3 scripts/sharded_lines.py build/parent --out chiprun_out/sharded_lines.jsonl

Four runs (other, this, this, other), each a process of its own with that
checkout first on ``sys.path`` and its ``chip_smoke.py``'s
``sharded_sweep_phase`` on the mono and dogStomach problems (every case of
its ``SHARDED_CASES``, fresh and stale, all ranks on the one card), which
makes that phase's checks and prints its lines. ``--out`` keeps every line.
Then one JSON line per case with, per run, the kernels of a sweep in the
trace of the sweep enqueued behind a gate (``trace_unpaced``), the wall ms
a sweep on the host's clock (median of 5) and all 5, the card's busy share
and the device span of the unpaced sweep; and the card's name and power
limit; the digest, whether the run replayed a captured sweep (``graph``),
its ``capture_ms`` and the ms a sweep through the entry point. Needs one
CUDA card; builds each checkout's kernels in its own
``build/``. It never imports JAX or ``fpm_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as cs
assert cs.__file__.startswith(root), cs.__file__
from fpm_torch.ops import build
build.build_all()
smi = sys.argv[2]
problems = {name: cs.sharded_problem(name) for name in ("mono", "dogStomach")}
cs.sharded_sweep_phase(problems, cs.sharded_digests(), cs.sharded_entry_timing(), smi)
"""


def run(root: str, smi: str) -> list[dict]:
    root = os.path.abspath(root)
    out = subprocess.run([sys.executable, "-c", CHILD, root, smi], cwd=root,
                         capture_output=True, text=True, timeout=1500)
    if out.returncode:
        raise RuntimeError(f"{root} exited {out.returncode}: {out.stderr[-3000:]}")
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith('{"phase": "sharded_sweep"')]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the root of the other checkout")
    ap.add_argument("--out", help="a file for every run's lines (JSON lines)")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    order = [("other", args.other), ("this", HERE), ("this", HERE), ("other", args.other)]
    runs = []
    for name, root in order:
        lines = run(root, smi)
        runs.append((name, lines))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                for line in lines:
                    f.write(json.dumps({"checkout": name, **line}) + "\n")
    for case in [ln["case"] for ln in runs[0][1]]:
        per_run = []
        for name, lines in runs:
            ln = next(x for x in lines if x["case"] == case)
            per_run.append({"checkout": name, "kernels_per_sweep": ln["trace_unpaced"]["kernels"],
                            "wall_ms": ln["wall_ms"], "wall_ms_all": ln["wall_ms_all"],
                            "busy_share": ln["busy_share"],
                            "span_ms_unpaced": ln["span_ms_unpaced"],
                            "overlap_ms": ln["overlap_ms"],
                            "enqueue_ms": ln.get("enqueue_ms"), "digest": ln["digest"],
                            "graph": ln.get("graph", False), "capture_ms": ln.get("capture_ms"),
                            "entry_ms_per_sweep": ln["entry_point"]["ms_per_sweep"]})
        print(json.dumps({"case": case, "runs": per_run, "gpu": smi}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
