#!/usr/bin/env python3
"""Two checkouts of the port on one card: their bits and their sharded sweeps.

Run from the root of this checkout, with the other one (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory)
as the argument:

    python3 scripts/compare_checkouts.py build/parent

Each of four runs (other, this, this, other) is a process of its own with
that checkout first on ``sys.path`` and this checkout's ``chip_smoke.py``
loaded by path, so the same functions run on either package: the kernel
digests (``kernel_digests``), the digests of the sharded sweeps
(``sharded_digests``) and their timing through the entry point
(``sharded_entry_timing``); and of each checkout's main libraries, ptxas's
registers, stack and spills per function (``build.resources``) and a digest
of each function's SASS (``cuobjdump -sass``). One JSON line per run, then
one line that says which digests, resources and SASS are equal between the
checkouts and gives each case's ms per sweep and busy share in each run. Needs one CUDA card; builds each
checkout's kernels in its own ``build/``. It never imports JAX or
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
import importlib.util, json, sys
root, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import hashlib, re, subprocess
import torch
import fpm_torch
from fpm_torch.ops import build
assert fpm_torch.__file__.startswith(root), fpm_torch.__file__

def sass(path):
    text = subprocess.run([build._tool("cuobjdump"), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = hashlib.sha256()
        elif name is not None:
            out[name].update(line.encode())
    return {k: h.hexdigest()[:16] for k, h in out.items()}

libs = build.build_all()
print("RUN " + json.dumps({
    "kernels": cs.kernel_digests(torch.device("cuda"))["all"],
    "resources": {stem: build.resources(stem) for stem in sorted(libs)},
    "sass": {stem: sass(path) for stem, path in sorted(libs.items())},
    "sharded": cs.sharded_digests(), "timing": cs.sharded_entry_timing(busy=True)}), flush=True)
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root),
                          os.path.join(HERE, "chip_smoke.py")], cwd=os.path.abspath(root),
                         capture_output=True, text=True, timeout=1500)
    if out.returncode:
        raise RuntimeError(f"{root} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("RUN ")][-1][4:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the root of the other checkout")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    order = [("other", args.other), ("this", HERE), ("this", HERE), ("other", args.other)]
    runs = []
    for name, root in order:
        res = run(root)
        print(json.dumps({"checkout": name, "root": root, **res, "gpu": smi}), flush=True)
        runs.append((name, res))
    by = {name: [r for n, r in runs if n == name] for name in ("other", "this")}
    cases = sorted(by["this"][0]["sharded"])
    print(json.dumps({
        "kernel_digests_equal": by["this"][0]["kernels"] == by["other"][0]["kernels"],
        "resources_equal": {stem: by["this"][0]["resources"][stem]
                            == by["other"][0]["resources"].get(stem)
                            for stem in by["this"][0]["resources"]},
        "sass_equal": {stem: by["this"][0]["sass"][stem] == by["other"][0]["sass"].get(stem)
                       for stem in by["this"][0]["sass"]},
        "sharded_digests_equal": {c: by["this"][0]["sharded"][c] == by["other"][0]["sharded"][c]
                                  for c in cases},
        "repeat_digests_equal": all(a["sharded"] == b["sharded"] and a["kernels"] == b["kernels"]
                                    for a, b in (by["this"], by["other"])),
        "ms_per_sweep": {c: {name: [r["timing"][c]["ms_per_sweep"] for r in rs]
                             for name, rs in by.items()} for c in cases},
        "busy_share": {c: {name: [r["timing"][c]["busy_share"] for r in rs]
                           for name, rs in by.items()} for c in cases},
        "order": [n for n, _ in order], "gpu": smi}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
