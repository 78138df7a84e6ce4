#!/usr/bin/env python3
"""Run-to-run spread of the benchmark's cells on one card, in this checkout
or beside another one.

Run from the repository root:

    python3 scripts/cell_spread.py [--repeats 3] [--out build/cell_spread] \
        [--runs N] [--ladder LO HI REPS] [--control] [--cell NAME] [--other DIR]
    python3 scripts/cell_spread.py --read build/cell_spread [--other DIR]

Runs ``python -m fpm_torch.bench --cell <name>`` ``--repeats`` times for
every cell of ``BENCHMARK.json``, the cells in turn, each run a process of
its own, and keeps each run's stdout as ``<out>/<cell>.<i>.out``
(``--runs``, ``--ladder`` and ``--control`` are passed on to each run;
``--cell`` runs that cell alone). Prints one
JSON line per cell (each metric's values, median and relative spread,
(max − min) / median, the ``correct`` of every run, the largest rel-max
of its CLI runs and sweep loops against the reference, and with
``--control`` the smallest of the control's), then one line with
the largest spread of each end-to-end metric over the cells, twice that (the
least regression bound it allows) and the bound ``BENCHMARK.json`` sets.

``--other DIR`` (for example the parent commit, unpacked with ``git
archive`` into a git-ignored directory) runs each repeat in both checkouts
as a pair, each with its checkout as the working directory, this one first
in odd pairs, and keeps the runs as ``<out>/<this|other>/<cell>.<i>.out``;
``--control`` goes to this checkout's runs alone. Each cell's line then
holds both sides' lines and, for each end-to-end metric, the pairs this
checkout won in the metric's ``direction`` (ties count for neither).
``--read DIR`` reads the lines of an earlier run instead. Exits 1 if a run
failed or was not correct, or a control came out correct.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
REL_KEYS = ("spectrum_rel_max", "pupil_rel_max")


def spread(values: list[float]) -> float:
    return (max(values) - min(values)) / statistics.median(values)


def read_lines(out: Path, cell: str) -> dict[int, dict]:
    """Each kept run's last line, by its repeat."""
    return {int(p.name.split(".")[-2]): json.loads(p.read_text().splitlines()[-1])
            for p in out.glob(f"{cell}.*.out") if p.stat().st_size}


def summary(lines: list[dict], names: list[str]) -> dict:
    row = {"runs": len(lines), "correct": [ln["correct"] for ln in lines],
           "device": sorted({ln["device"] for ln in lines})}
    for m in names:
        values = [ln[m] for ln in lines]
        row[m] = {"values": values, "median": statistics.median(values),
                  "spread": spread(values)}
    row["rel_max"] = max(max(ln["checks"][key], ln["checks"]["sweep_loop"][key])
                         for ln in lines for key in REL_KEYS)
    if all("control" in ln for ln in lines):
        row["control_rel_max"] = min(max(ln["control"][key] for key in REL_KEYS)
                                     for ln in lines)
        row["control_correct"] = [ln["control"]["correct"] for ln in lines]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="build/cell_spread", help="where each run's stdout goes")
    ap.add_argument("--read", help="read the runs kept in this directory instead")
    ap.add_argument("--cell", help="this cell alone")
    ap.add_argument("--runs", type=int, help="each run's timed runs (bench --runs)")
    ap.add_argument("--ladder", nargs=3, metavar=("LO", "HI", "REPS"),
                    help="each run's ladder (bench --ladder)")
    ap.add_argument("--control", action="store_true", help="bench --control")
    ap.add_argument("--other", help="the root of another checkout, run in pairs with this one")
    args = ap.parse_args(argv)
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in doc["workloads"] if args.cell in (None, w["name"])]
    extra = ((["--runs", str(args.runs)] if args.runs else [])
             + (["--ladder", *args.ladder] if args.ladder else []))
    out = Path(args.read or args.out)
    sides = {"this": (REPO, out)}
    if args.other:
        sides = {"this": (REPO, out / "this"), "other": (Path(args.other).resolve(), out / "other")}
    ok = True
    if not args.read:
        for _, side_out in sides.values():
            side_out.mkdir(parents=True, exist_ok=True)
        for i in range(1, args.repeats + 1):
            for cell in cells:
                for side in (list(sides) if i % 2 else list(sides)[::-1]):
                    root, side_out = sides[side]
                    control = ["--control"] if args.control and side == "this" else []
                    with open(side_out / f"{cell}.{i}.out", "w") as f:
                        rc = subprocess.run([sys.executable, "-m", "fpm_torch.bench", "--cell",
                                             cell, *extra, *control], cwd=root,
                                            stdout=f).returncode
                    print(f"cell_spread: {cell} {side} run {i} exited {rc}", file=sys.stderr,
                          flush=True)
                    ok &= rc == 0
    e2e = doc["metrics"]["end_to_end"]
    worst = dict.fromkeys(e2e, 0.0)
    for cell in cells:
        names = [*e2e, *(m for m, s in doc["metrics"]["per_layer"].items()
                         if cell in s["workloads"])]
        by_side = {side: read_lines(side_out, cell) for side, (_, side_out) in sides.items()}
        rows = {side: summary([lines[i] for i in sorted(lines)], names)
                for side, lines in by_side.items()}
        for row in rows.values():
            ok &= all(row["correct"]) and not any(row.get("control_correct", []))
        for m in e2e:
            worst[m] = max(worst[m], rows["this"][m]["spread"])
        if args.other:
            pairs = sorted(set(by_side["this"]) & set(by_side["other"]))
            wins = {}
            for m in e2e:
                higher = e2e[m]["direction"] == "higher"
                wins[m] = sum((a > b) if higher else (a < b) for a, b in
                              ((by_side["this"][i][m], by_side["other"][i][m]) for i in pairs))
            print(json.dumps({"cell": cell, "pairs": len(pairs), "this_wins": wins, **rows}),
                  flush=True)
        else:
            print(json.dumps({"cell": cell, **rows["this"]}), flush=True)
    print(json.dumps({"largest_spread": worst, "least_bound": {m: 2 * v for m, v in worst.items()},
                      "bound": {m: e2e[m]["regression_bound"] for m in e2e}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
