#!/usr/bin/env python3
"""K1's, K2's or the consensus kernels' time on the card, stage by stage,
in one or two checkouts.

Run from the root of this checkout, on a machine with one CUDA card:

    python3 scripts/kernel_profile.py [--kernel K2] [--other DIR] [--out FILE]
    python3 scripts/kernel_profile.py --kernel C1|C2|C3 [--shapes mono dog] [--other DIR]
    python3 scripts/kernel_profile.py --kernel P4|P3|P2|P1 [--shapes mono dog] [--other DIR]
    python3 scripts/kernel_profile.py --kernel K1 [--shapes mono dog]
        [--cs 0 1 2 4 8] [--tiers bf16x3 highest] [--chunks 15 30]
        [--z-layout 0] [--other DIR] [--out FILE]

Each checkout runs in a process of its own, with that checkout first on
``sys.path`` (this script's ``--child`` mode); with ``--other`` the runs go
other, this, this, other (one card, in turns). One JSON line per run, then,
with ``--other``, one line that gives each number of both checkouts side by
side. Digests, ptxas resources and SASS of two checkouts:
``scripts/compare_checkouts.py``. Never imports JAX or ``fpm_tpu``.

``--kernel K2``: the sequential cell's problem
(``benchmarks_torch/mono_dome_np90.json``: Np 90, bbox 64, 193 LEDs, frames
simulated from seed 0):

- ``k2_phase_profile``: one sweep through K2's cycle-counting build
  (``kernels.k2_phase_profile``), SM cycles per LED of each phase and their
  sum, at each tier, after one sweep to warm;
- ``ms_per_sweep``: the sweep loop as ``reconstruct`` runs it
  (``bench.solver``) on the sequential cell's ladder (5/55 sweeps, 5
  repetitions, CUDA events), at each tier; and ``ms_per_problem_sweep`` of
  the same loop with P = 16, 66 and 132 problems in one launch (the
  ``--fov-grid`` ROI runner's problem axis), bf16x3, on a ladder of 2/6
  sweeps.

``--kernel C1`` / ``--kernel C2``: the sharded sweeps' consensus on the
LED axis (``kernels.consensus_led``, mesh (4,1)) or the tile axis's object
step (``kernels.consensus_tile_object``, mesh (2,2)), for each shape of
``--shapes`` (``mono``: NL 360, Np 90, bbox 64, as chip_smoke's
``consensus_rows``; ``dog``: NL 600, Np 200, bbox 112), on seeded random
f32 payloads: ``device_us`` a call (a torch.profiler window of TIMED
calls after PAD short spin kernels, over the calls it kept: ``device_calls``),
``event_us`` (CUDA events over 50 calls), and, where the checkout
has the stamping build (``kernels.consensus_phase_profile``), ``stamped``:
the median over STAMPED calls of each block's µs in its payload sums and
apply, its fence and ticket and the tail, and the grid's timeline on the
card's global clock (``stamp_summary``).

``--kernel C3``: the tile axis's pupil step (``kernels.consensus_tile_pupil``)
of mesh (2,2) for each shape of ``--shapes`` (``mono``: bbox 64, ``dog``:
bbox 112; 4 ranks' pupil and metric payloads, 2 tile maxima, the sweep's
metric sums, seeded random f32), with its payloads and maxima on this card
and, with two cards or more, on a peer card (peer access enabled):
``device_us`` and ``event_us`` as P4's below, of the wrapper as the
checkout plans it (with its plan where the checkout has
``kernels.pupil_plan``), the result checked bitwise against
``consensus_tile_pupil_plain``; ``stamped`` where the checkout's
stamping build takes C3 (``consensus_phase_profile("C3", ...)``): the
median over STAMPED calls of each block's µs in its pupil sums, in
obtaining max|O| and in its step and stores, and the grid's timeline
(``pupil_stamp_summary``); and an empty kernel (``fpm_launch_floor``).
With four cards also ``in_sweep``: the one-process mesh (2,2) over the
four cards, fresh and stale, replaying its captured sweep: card 0's C3
in SWEEP_TRACES traces ungated and as
many behind ``chip_smoke.gated_trace``'s gate, the mean and the median
device ms a launch of each trace.

``--kernel P3``: the wait (``kernels.peer_wait``) on one card in three
cases: ``met``, its flag already posted, on this card and (two cards or
more) on a peer card, ``device_us`` and ``event_us`` as above; and
``woken``, a wait that starts with a spin of each of WAKE_DELAYS_US on
another stream, then a post (both behind one gate): the µs from the post's
end to the wait's end in the trace of WAKE_ROUNDS rounds (each round a
chunk no earlier round posted), their median, least and largest, with the
flag on this card and, with two cards, on a peer card (the post launched on
this card, into the peer's flag block, so both ends are on one card's
clock); beside them the epoch, the post and an empty kernel.

``--kernel P4``: the peer route's halo pull (``kernels.peer_pull``) of the
forward halo of mesh (2,2) for each shape of ``--shapes`` (``mono``: the
2 × 90 rows of 360 floats of a 180 × 360 tile, 259 KB; ``dog``: 2 × 200
rows of 600 of a 300 × 600 tile, 960 KB), from a tile on this card and,
with two cards or more, on a peer card (peer access enabled): ``device_us``
a call (a torch.profiler window of TIMED calls after PAD short spin
kernels: every device record but the spin kernels') and ``event_us`` (CUDA
events over 50 calls) of the wrapper as the checkout plans it, of
``Tensor.copy_`` (the library's yardstick), and, where the checkout has
``kernels.pull_plan``, of each plan of ``pull_variants`` (the vector path
at 32-1024 threads a block and the scalar path, forced through
``peer_pull.force_plan``), each also through the profile build
``build.profile_library("epry_peer")`` with its block stamps
(``stamped``: the blocks' span and each block's µs, medians over the
launches), and of an empty kernel (``fpm_launch_floor``: the launch
floor); every result checked bitwise against the tile's rows. A plan the
card refuses is recorded as ``refused``. With four cards also ``in_sweep``:
the one-process mesh (2,2) over the four cards, fresh and stale, replaying
its captured sweep (``chip_smoke.prepared_sweep``, ``graph.SweepGraph``):
card 0's pulls in a traced replay, ungated and behind a gate as
``chip_smoke.gated_trace`` holds the cards (``device_us``, the median of
a replay's launches), the checkout's plan from its main build and, where
the checkout has the profile build's stamps, from the profile build
(``stamped``), split on the card's global clock into
the wait from its traced start to its first block, its blocks' span and
the drain after its last block (``split_launches``), to set beside the
same pull alone on an idle pair; and ``by_card_kernel_ms``, each card's
consensus kernels and pull in ``gated_trace`` (multicard_smoke's
``consensus_bounds`` reads that).

``--kernel P2``: the post (``kernels.peer_post``), the epoch
(``peer_epoch``, P1), a wait on a posted flag (``peer_wait``, P3) and,
where the checkout has it, an empty kernel (``fpm_launch_floor``: the
launch floor) on one card, ``device_us`` and ``event_us`` as above, in
turns (forward, then backward). ``--other`` gives the other checkout's
post beside this one's.

``--kernel P1``: the epoch (``kernels.peer_epoch``) on one card beside
three forms of its kernel built from ``P1_FORMS_SOURCE`` (``nvcc`` into the
checkout's ``build/p1_forms/``, the same for either checkout): the load,
add and store with ``__threadfence_system()`` after them, the same without
the fence, and one ``red.relaxed.gpu.global.add.u64``; and an empty kernel
(``fpm_launch_floor``). ``device_us`` and ``event_us`` as above, in turns
(forward, then backward); ``words_after``: word 0 after EPOCH_CALLS calls
of each on a zeroed block; ``sass``: the memory and fence instructions of
the checkout's ``peer_epoch`` and of each form (``cuobjdump -sass``).

``--kernel K1``: for each shape, K1's sweep loop as the batched cell runs it
(``bench.solver``, one problem, chunk strided): ``mono`` is the cell's
configuration (Np 90, chunk 32), ``dog`` the dogStomach optics
(``bench.DOG_OPTICS``, Np 200, chunk 16, the chunk the kernel route runs
there; ``--chunks`` takes other chunk sizes instead). For each tier, chunk
size and cluster size of ``--cs`` (0: the one the entry point chooses;
else forced through ``force_cluster_size``), with Z whole or cut by rows as
``--z-layout`` says (``force_z_layout``: 0 the entry point's choice, 1
whole, 2 cut), one row:

- ``ms_per_sweep``: a short ladder on CUDA events (``bench.ladder``);
- ``device_ms_per_sweep``: the card's kernel time in a torch.profiler window
  of WINDOW sweeps after WARM to warm, with ``by_kernel`` (launches and mean
  µs of each kernel name), ``gaps_us`` (the median idle µs between one
  kernel's end and the next one's start, by the pair of names) and
  ``sweep_span_us`` (the median µs from a sweep's first kernel start to its
  last kernel end);
- ``host_enqueue_us_per_sweep``: the host's time to enqueue one sweep while
  the card is held busy by a spin kernel, so that no launch waits for it
  (the wrapper's host work: what paces the card when it is longer than the
  kernels' time), the median and the least of ENQUEUE sweeps;
- ``launches_per_sweep`` (the wrapper's count) and the plan chosen;
- ``phase_us_per_chunk``: the µs a chunk of the grid's first block in each
  phase of the sweep (``kernels.k1_phase_profile``, K1's cycle-counting
  build, at the card's SM clock of ``nvidia-smi``), where the kernel has
  one launch a sweep.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM, WINDOW, ENQUEUE = 10, 20, 20
K1_LADDER = (5, 45, 3)
CHUNKS = {"mono": 32, "dog": 16}


def mono_problem(root: str):
    from fpm_torch import bench
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry

    cfg, _ = bench.cell_config(os.path.join(root, "benchmarks_torch", "mono_dome_np90.json"))
    geom = compute_geometry(cfg)
    frames = simulate_images(make_test_object(cfg.n_large, seed=0), geom, cfg, quantize=True)
    return cfg, geom, frames


def k2_run(root: str, args) -> dict:
    from fpm_torch import bench
    from fpm_torch.ops import kernels

    cfg, geom, frames = mono_problem(root)
    k_leds = len(geom.schedule)
    out = {"leds": k_leds, "k2_phase_profile": {}, "ms_per_sweep": {}}
    for tier in ("bf16x3", "highest"):
        solve = bench.solver(cfg, geom, frames, "cuda", mode="sequential", dft_precision=tier)
        ops = (*solve.state, *solve.operands)
        kernels.k2_phase_profile(*ops, **solve.options)                 # built and warm
        _, cycles = kernels.k2_phase_profile(*ops, **solve.options)
        per_led = {name: c / k_leds for name, c in cycles.items()}
        out["k2_phase_profile"][tier] = {"cycles_per_led": sum(per_led.values()),
                                         "cluster_size": kernels.fused_epry_sweep.cluster_size,
                                         "by_phase": per_led}
        sweep = solve.sweeps()
        out["ms_per_sweep"][tier] = bench.ladder(bench.cuda_clock(sweep, solve.state), 5, 55,
                                                 5, log=lambda m: None)[0] * 1e3
    out["ms_per_problem_sweep"], out["cluster_size_by_problems"] = {}, {}
    for p in (16, 66, 132):
        solve = bench.solver(cfg, geom, frames, "cuda", problems=p, mode="sequential",
                             dft_precision="bf16x3")
        ms = bench.ladder(bench.cuda_clock(solve.sweeps(), solve.state), 2, 6, 2,
                          log=lambda m: None)[0] * 1e3
        out["ms_per_problem_sweep"][str(p)] = ms / p
        out["cluster_size_by_problems"][str(p)] = kernels.fused_epry_sweep.cluster_size
    return out


def k1_window(sweep, state, path: str) -> dict:
    """The device events of WINDOW sweeps in one profiler window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fpm_torch import bench

    s = state
    for _ in range(WARM):
        s = sweep(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = state
        for _ in range(WINDOW):
            s = sweep(s)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    work = sorted((e["ts"], e["dur"], bench.trace_name(e["name"])) for e in events
                  if e.get("ph") == "X" and e.get("cat") in bench.DEVICE_CATS)
    fpm = [e for e in work if e[2].startswith("fpm::")]
    by_name: dict[str, list] = {}
    for _, d, name in fpm:
        by_name.setdefault(name, []).append(d)
    gaps: dict[str, list] = {}
    for a, b in zip(fpm, fpm[1:]):
        gaps.setdefault(f"{a[2]} -> {b[2]}", []).append(b[0] - (a[0] + a[1]))
    per = len(fpm) // WINDOW
    spans = [fpm[i * per + per - 1][0] + fpm[i * per + per - 1][1] - fpm[i * per][0]
             for i in range(WINDOW)] if per else []
    return {"device_ms_per_sweep": sum(d for _, d, _ in fpm) / 1e3 / WINDOW,
            "other_device_ms_per_sweep": sum(d for _, d, n in work
                                             if not n.startswith("fpm::")) / 1e3 / WINDOW,
            "kernels_per_sweep": len(fpm) / WINDOW,
            "by_kernel": {k: {"launches": len(v), "mean_us": statistics.mean(v)}
                          for k, v in by_name.items()},
            "gaps_us": {k: {"n": len(v), "median": statistics.median(v)}
                        for k, v in gaps.items()},
            "sweep_span_us": statistics.median(spans) if spans else None}


def k1_host_enqueue_us(sweep, state) -> dict:
    """µs of host time to enqueue each of ENQUEUE sweeps behind a spin
    kernel: their median and least."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)      # ~0.1 s of the card's clock: longer than the enqueue
    times, s = [], state
    for _ in range(ENQUEUE):
        t0 = time.perf_counter()
        s = sweep(s)
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return {"median": statistics.median(times), "min": min(times)}


def sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.split()[0])


def k1_phases(solve, n_chunks: int) -> dict:
    """µs a chunk in each phase of K1's sweep (the first block's view), from
    three profiled sweeps after one, at the SM clock read after them."""
    from fpm_torch.ops import kernels

    kernels.k1_phase_profile(*solve.state, *solve.operands, **solve.options)
    total: dict[str, int] = {}
    for _ in range(3):
        _, cycles = kernels.k1_phase_profile(*solve.state, *solve.operands, **solve.options)
        for name, c in cycles.items():
            total[name] = total.get(name, 0) + c
    mhz = sm_mhz()
    return {"sm_mhz": mhz, **{name: c / 3 / n_chunks / mhz for name, c in total.items()}}


def k1_run(root: str, args) -> dict:
    import torch

    from fpm_torch import bench
    from fpm_torch.ops import kernels

    k1 = kernels.fused_epry_chunked
    rows = []
    for shape in args.shapes:
        cfg, geom, frames = (mono_problem(root) if shape == "mono"
                             else bench.make_problem(0, **bench.DOG_OPTICS)[:3])
        for tier in args.tiers:
            for chunk in args.chunks or [CHUNKS[shape]]:
                solve = bench.solver(cfg, geom, frames, "cuda", dft_precision=tier,
                                     mode="batched", chunk_size=chunk, chunk_assign="strided")
                sweep = solve.sweeps()
                k1.force_z_layout = args.z_layout
                for cs in args.cs:
                    k1.force_cluster_size = cs
                    row = {"shape": shape, "tier": tier, "chunk": chunk, "forced_cs": cs,
                           "forced_z_layout": args.z_layout}
                    try:
                        k1.launches = 0
                        sweep(solve.state)
                        torch.cuda.synchronize()
                    except RuntimeError as e:   # the forced plan does not fit: refused
                        rows.append(dict(row, refused=str(e)))
                        continue
                    row.update(plan=dict(k1.plan), launches_per_sweep=k1.launches,
                               n_slots=solve.n_slots)
                    row["ms_per_sweep"] = bench.ladder(bench.cuda_clock(sweep, solve.state),
                                                       *K1_LADDER, log=lambda m: None)[0] * 1e3
                    row.update(k1_window(sweep, solve.state,
                                         os.path.join(root, "build", "k1_window.trace.json")))
                    row["host_enqueue_us_per_sweep"] = k1_host_enqueue_us(sweep, solve.state)
                    if row["launches_per_sweep"] == 1:
                        row["phase_us_per_chunk"] = k1_phases(solve, solve.n_slots // chunk)
                    rows.append(row)
                k1.force_cluster_size = k1.force_z_layout = 0
    return {"rows": rows}


# (NL, Np, bbox b) of the consensus kernels' shapes, and the mesh (led,
# tile) each kernel runs on: chip_smoke's consensus_rows (mono) and the
# dogStomach optics.
CONSENSUS_SHAPES = {"mono": (360, 90, 64), "dog": (600, 200, 112)}
CONSENSUS_MESH = {"C1": (4, 1), "C2": (2, 2)}
STAMPED, TIMED, PAD = 5, 20, 64


def consensus_inputs(kernel: str, shape: str):
    """The wrapper's arguments for one chunk's consensus on one card, on
    seeded random payloads of the main path's shapes (f32): C1 the LED
    axis's 4 ranks of a (NL, NL) spectrum, C2 the 2 tiles of mesh (2,2)
    with their halo hops. Returns (args, keywords)."""
    import numpy as np
    import torch

    from fpm_torch.ops import kernels

    nl, n, b = CONSENSUS_SHAPES[shape]
    led, tile = CONSENSUS_MESH[kernel]
    r = np.random.default_rng(nl + n + b)
    dev = torch.device("cuda")

    def rnd(*shape_, scale=1.0):
        return torch.from_numpy((r.standard_normal(shape_) * scale).astype(np.float32)).to(dev)

    try:
        scratch = kernels.ConsensusScratch(dev)
    except TypeError:       # a checkout whose scratch still holds C1's pupil sums (bbox b)
        scratch = kernels.ConsensusScratch(dev, b)
    if kernel == "C1":
        o, pc = rnd(2, nl, nl, scale=10), rnd(2, b, b)
        ds = [rnd(2, nl, nl, scale=0.1) for _ in range(led)]
        vs = [rnd(2, b, b, scale=0.1) for _ in range(led)]
        mets = [rnd(2).abs() for _ in range(led)]
        out = (torch.empty_like(o), torch.empty_like(pc), torch.empty((), device=dev),
               torch.empty(2, device=dev))
        return ((o, pc, ds, vs, [m[0] for m in mets], [m[1] for m in mets], None),
                dict(wire=None, scale=0.75, metrics=True, scratch=scratch, out=out))
    s = nl // tile
    hops = [(j, lo, min(s, n - lo)) for j, lo in enumerate(range(0, n, s), start=1)]
    objs = [rnd(2, s, nl, scale=10) for _ in range(tile)]
    pay = {(li, ti): rnd(2, s + n, nl, scale=0.1) for li in range(led) for ti in range(tile)}
    blocks = [(objs[ti], [pay[(li, ti)] for li in range(led)],
               [[pay[(li, (ti - j) % tile)] for li in range(led)] for j, _, _ in hops])
              for ti in range(tile)]
    out = [(torch.empty_like(o), torch.empty((), device=dev)) for o in objs]
    return (blocks,), dict(s=s, hops=hops, wire=None, scratch=scratch, out=out)


def stamp_summary(records: list) -> dict:
    """One stamped call's blocks: the payload sums and apply and the fence
    and ticket of the blocks that make no tail, µs a block (mean and max,
    from the SM cycles at the clock the stamps give); the tail's µs in the
    blocks that make it (its own work after its ticket or wait); and the
    grid's timeline on the card's global clock: µs from the first block's
    start to the last start, the last apply and ticket of the blocks that
    make no tail, and the tail's end."""
    spans = [(max(r.values())[1] - r["start"][1], max(r.values())[0] - r["start"][0])
             for r in records]
    ghz = statistics.median(c / ns for c, ns in spans if ns > 0)
    t0 = min(r["start"][0] for r in records)

    def us(a, b, rs):
        return [(r[b][1] - r[a][1]) / ghz / 1e3 for r in rs if a in r and b in r]

    objects = [r for r in records if "tail" not in r]   # blocks that make no tail
    apply = us("start", "payload sums and apply", objects)
    ticket = us("payload sums and apply", "fence and ticket", objects)
    tail = us("fence and ticket", "tail", records)

    def last(mark, rs=objects):
        at = [r[mark][0] for r in rs if mark in r]
        return (max(at) - t0) / 1e3 if at else None

    return {"blocks": len(records), "sm_ghz": ghz,
            "sums_apply_us": {"mean": statistics.mean(apply), "max": max(apply)},
            "fence_ticket_us": {"mean": statistics.mean(ticket), "max": max(ticket)},
            "tail_us": {"blocks": len(tail), "max": max(tail) if tail else None},
            "timeline_us": {"last_start": last("start", records),
                            "last_apply": last("payload sums and apply"),
                            "last_ticket": last("fence and ticket"),
                            "tail_end": last("tail", records)}}


def consensus_run(root: str, args) -> dict:
    """For each shape: the kernel's device µs a call (a profiler window of
    TIMED calls after one), its µs a call on CUDA events, and, where the
    checkout has the stamping build (``kernels.consensus_phase_profile``),
    the median of STAMPED stamped calls' summaries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fpm_torch.ops import kernels

    wrapper = kernels.consensus_led if args.kernel == "C1" else kernels.consensus_tile_object
    rows = []
    for shape in args.shapes:
        a, kw = consensus_inputs(args.kernel, shape)
        call = (lambda: wrapper(*a, **kw))
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):     # the window's first device records may be lost
                torch.cuda._sleep(1000)
            for _ in range(TIMED):
                call()
            torch.cuda.synchronize()
        dev_us = [(e.count, getattr(e, "device_time_total", 0)) for e in prof.key_averages()
                  if "consensus" in e.key]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            call()
        end.record()
        torch.cuda.synchronize()
        row = {"shape": shape, "mesh": CONSENSUS_MESH[args.kernel],
               "device_us": sum(us for _, us in dev_us) / max(1, sum(n for n, _ in dev_us)),
               "device_calls": sum(n for n, _ in dev_us),
               "event_us": start.elapsed_time(end) / 50 * 1e3}
        if hasattr(kernels, "consensus_phase_profile"):
            got = [stamp_summary(kernels.consensus_phase_profile(args.kernel, *a, **kw)[1])
                   for _ in range(STAMPED + 1)][1:]
            row["stamped"] = {k: _median_tree([g[k] for g in got]) for k in got[0]}
        rows.append(row)
    return {"rows": rows}


# C3 on mesh (2,2): the pupil payloads of the (led, tile) group's 4 ranks,
# the 2 tiles' maxima.
PUPIL_RANKS, PUPIL_MAXIMA = 4, 2
SWEEP_TRACES = 3


def pupil_inputs(shape: str, src, dev):
    """C3's arguments for one chunk of mesh (2,2) on card ``dev``, at the
    bbox of ``shape``, the payloads and maxima on card ``src``: seeded
    random f32, metrics kept, the sweep's sums given. Returns (args,
    keywords)."""
    import numpy as np
    import torch

    b = CONSENSUS_SHAPES[shape][2]
    r = np.random.default_rng(b)

    def rnd(d, *shape_, scale=1.0):
        return torch.from_numpy((r.standard_normal(shape_) * scale).astype(np.float32)).to(d)

    pc = rnd(dev, 2, b, b)
    vs = [rnd(src, 2, b, b, scale=0.1) for _ in range(PUPIL_RANKS)]
    mets = [rnd(src, 2).abs() for _ in range(PUPIL_RANKS)]
    maxima = [rnd(src, 1).abs().reshape(()) * 10 for _ in range(PUPIL_MAXIMA)]
    acc = rnd(dev, 2).abs()
    out = (torch.empty_like(pc), torch.empty((), device=dev), torch.empty(2, device=dev))
    return ((pc, vs, maxima, [m[0] for m in mets], [m[1] for m in mets], acc),
            dict(wire=None, scale=0.75, metrics=True, out=out))


def forced_call(wrapper, plan, call):
    """``call`` with ``wrapper.force_plan`` set to ``plan`` (None: as the
    wrapper plans)."""
    if plan is None:
        return call

    def forced():
        wrapper.force_plan = plan
        try:
            call()
        finally:
            wrapper.force_plan = None
    return forced


def pupil_stamp_summary(records: list) -> dict:
    """One stamped C3 call's blocks: µs a block (mean and max, SM cycles at
    the clock the stamps give) in its pupil sums (start to "payload sums and
    apply"), in obtaining max|O| ("fence and ticket") and in its step and
    stores ("tail"); the grid's timeline on the card's global clock, µs from
    the first block's start to the last block's start, sums, max and end."""
    spans = [(r["tail"][1] - r["start"][1], r["tail"][0] - r["start"][0]) for r in records]
    ghz = statistics.median(c / ns for c, ns in spans if ns > 0)
    t0 = min(r["start"][0] for r in records)
    out = {"blocks": len(records), "sm_ghz": ghz}
    for name, a, b in (("sums_us", "start", "payload sums and apply"),
                       ("max_us", "payload sums and apply", "fence and ticket"),
                       ("step_us", "fence and ticket", "tail")):
        got = [(r[b][1] - r[a][1]) / ghz / 1e3 for r in records]
        out[name] = {"mean": statistics.mean(got), "max": max(got)}
    out["timeline_us"] = {m: (max(r[k][0] for r in records) - t0) / 1e3 for m, k in (
        ("last_start", "start"), ("last_sums", "payload sums and apply"),
        ("last_max", "fence and ticket"), ("end", "tail"))}
    return out


def pupil_run(root: str, args) -> dict:
    """The C3 rows (see the module's docstring)."""
    import torch

    from fpm_torch.ops import build, kernels

    cards = torch.cuda.device_count()
    new = hasattr(kernels, "pupil_plan")
    wrapper = kernels.consensus_tile_pupil
    d0 = torch.device("cuda", 0)
    if cards > 1:
        kernels.enable_peer_access(d0, torch.device("cuda", 1))
    out: dict = {"cards": cards, "rows": []}
    for shape in args.shapes:
        b = CONSENSUS_SHAPES[shape][2]
        for where in ["this card"] + (["peer"] if cards > 1 else []):
            a, kw = pupil_inputs(shape, torch.device("cuda", 1 if where == "peer" else 0), d0)
            want = kernels.consensus_tile_pupil_plain(
                *[[t.to(d0) for t in x] if isinstance(x, list) else x for x in a],
                **{k: v for k, v in kw.items() if k != "out"})
            def call():
                wrapper(*a, **kw)
            row = {"shape": shape, "source": where, "call": "wrapper",
                   "plan": kernels.pupil_plan(b * b)._asdict() if new else None}
            call()
            torch.cuda.synchronize(d0)
            row["bitwise"] = all(torch.equal(x, y) for x, y in zip(kw["out"], want))
            row.update(device_us(call, cards))
            row["event_us"] = event_us(call)
            if new:         # the same call through the stamping build
                got = [pupil_stamp_summary(kernels.consensus_phase_profile("C3", *a, **kw)[1])
                       for _ in range(STAMPED + 1)][1:]     # the first one warms
                row["stamped"] = {k: _median_tree([g[k] for g in got]) for k in got[0]}
            out["rows"].append(row)
    empty = floor_call(build, d0)
    if empty:
        out["rows"].append({"call": "empty kernel", **device_us(empty, cards),
                            "event_us": event_us(empty)})
    if cards >= 4:
        out["in_sweep"] = pupil_in_sweep()
    return out


def smoke_module():
    """``chip_smoke.py`` of this checkout, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def pupil_in_sweep() -> list:
    """Card 0's C3 in the one-process (2,2) sweep over four cards, fresh
    and stale: the mean and the median device ms a launch in each of SWEEP_TRACES
    traces of one replay, ungated (``trace_overlap``) and behind the gate
    (``gated_trace``)."""
    import torch

    from fpm_torch.parallel import graph, make_mesh

    cs = smoke_module()
    problem = cs.sharded_problem("mono")
    rows = []
    for stale in (False, True):
        mesh = make_mesh(2, 2)
        route, body = cs.prepared_sweep(problem, mesh, {}, stale)
        captured = graph.SweepGraph(mesh, route, body)
        ms, _, _ = cs.wall_ms(captured.replay)
        row = {"stale": stale, "call": "wrapper", "wall_ms_per_sweep": ms,
               "c3_per_sweep": captured.launches["consensus_tile_pupil"]}
        for gated in (False, True):
            got = []
            for _ in range(SWEEP_TRACES):
                traced = (cs.gated_trace(captured.replay, ms) if gated
                          else cs.trace_overlap(captured.replay))
                card = traced["by_card"].get(0, {})
                got.append([card.get("kernel_ms", {}).get("consensus_tile_pupil"),
                            card.get("kernel_ms_median", {}).get("consensus_tile_pupil")])
            row["gated" if gated else "ungated"] = {
                "mean_median_ms": got,
                "median_of_medians_ms": statistics.median(m for _, m in got if m is not None)}
        rows.append(row)
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    return rows


# The woken wait's rounds and the post's delays: 2 µs, within the wait's
# first polls (the peer route's waits spin 0.22-0.33 ms of a four-card
# sweep over about 100 waits a card, 2-3 µs each), and 20 µs.
WAKE_ROUNDS, WAKE_DELAYS_US = 50, (2, 20)


def wake_us(post, wait, dev, delay_us: int) -> dict:
    """WAKE_ROUNDS rounds in one profiler window, each a wait on stream B
    of ``dev`` and, on stream A, a spin of ~``delay_us`` and a post
    (``wait(k, B)`` and ``post(k, A)`` of round k's chunk), both streams
    held behind one gate (a spin kernel and an event) until the host has
    enqueued the round, so the wait and the spin start together: the µs
    from each post kernel's end to its wait kernel's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    a, b, g = (torch.cuda.Stream(dev) for _ in range(3))
    with torch.cuda.device(dev):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize(dev)
            for k in range(WAKE_ROUNDS):
                with torch.cuda.stream(g):
                    torch.cuda._sleep(200_000)                 # ≥ 0.1 ms: the round's enqueue
                    gate = torch.cuda.Event()
                    gate.record()
                b.wait_event(gate)
                a.wait_event(gate)
                with torch.cuda.stream(b):
                    wait(k, b)
                with torch.cuda.stream(a):
                    torch.cuda._sleep(delay_us * 2000)         # ≥ the delay at ≤ 2 GHz
                    post(k, a)
                torch.cuda.synchronize(dev)
    path = os.path.join(HERE, "build", "p3_wake.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)

    def ends(name):
        return sorted(e["ts"] + e["dur"] for e in events if e.get("ph") == "X"
                      and e.get("cat") == "kernel" and name in e["name"])

    posts, waits = ends("peer_post"), ends("peer_wait")
    lat = [w - p for p, w in zip(posts, waits)] if len(posts) == len(waits) else []
    return {"delay_us": delay_us, "rounds": len(lat), "posts_traced": len(posts),
            "waits_traced": len(waits),
            "wake_us_median": statistics.median(lat) if lat else None,
            "wake_us_min": min(lat) if lat else None, "wake_us_max": max(lat) if lat else None}


def wait_run(root: str, args) -> dict:
    """The P3 rows (see the module's docstring)."""
    import ctypes

    import torch

    from fpm_torch.ops import build, kernels

    cards = torch.cuda.device_count()
    d0 = torch.device("cuda", 0)
    words = kernels.flag_block(d0)          # card 0's block: its epoch, the flags here
    blocks = {"this card": words}
    if cards > 1:
        kernels.enable_peer_access(d0, torch.device("cuda", 1))
        blocks["peer"] = kernels.flag_block(torch.device("cuda", 1))
    for block in blocks.values():           # every block at epoch 1
        kernels.peer_epoch(block)
    lib = build.library("epry_peer")
    rows = []
    for where, block in blocks.items():
        def post(k, stream, block=block):   # launched on card 0, into the block's slot 1
            launched = ctypes.c_int(0)
            build.check(lib, lib.fpm_peer_post(block.data_ptr(), 1, k, 0, stream.cuda_stream,
                                               ctypes.byref(launched)), "peer_post")

        def wait(k, stream, block=block):
            kernels.peer_wait([(block, 1, k)], words, stream=stream.cuda_stream)

        kernels.peer_post(block, 0, 0)      # slot 0 posted by the block's own card
        for d in range(cards):
            torch.cuda.synchronize(d)
        met = (lambda block=block: kernels.peer_wait([(block, 0, 0)], words))
        rows.append({"case": "met", "source": where, **device_us(met, cards),
                     "event_us": event_us(met)})
        for n, delay in enumerate(WAKE_DELAYS_US):     # each delay's rounds on chunks of their own
            rows.append({"case": f"woken {delay} us", "source": where,
                         **wake_us(lambda k, st, n=n: post(n * WAKE_ROUNDS + k, st),
                                   lambda k, st, n=n: wait(n * WAKE_ROUNDS + k, st), d0, delay)})
    calls = {"peer_post": lambda: kernels.peer_post(words, 0, 0),
             "peer_epoch": lambda: kernels.peer_epoch(words),
             "empty kernel": floor_call(build, d0)}
    for name, call in calls.items():
        if call:
            rows.append({"case": name, **device_us(call, cards), "event_us": event_us(call)})
    return {"cards": cards, "rows": rows}


# The forward halo of mesh (2,2) at each shape: (NL, Np), a (2, NL/2, NL)
# tile whose first Np rows are pulled.
PULL_SHAPES = {"mono": (360, 90), "dog": (600, 200)}


def pull_variants(kernels, planes, rows):
    """The plans timed beside the checkout's own: the vector path at 32-1024
    threads a block and the scalar path, a warp a row."""
    P = kernels.PullPlan
    out = {f"vector {t}": P("vector", -(-rows // (t // 32)) * planes, t)
           for t in (32, 64, 128, 256, 512, 1024)}
    out["scalar 256"] = P("scalar", -(-rows // 8) * planes, 256)
    return out


def floor_call(build, dev):
    """One launch of the empty kernel (``fpm_launch_floor``) on ``dev``, or
    None where the checkout has none."""
    from fpm_torch.ops import kernels

    lib = build.library("epry_peer")
    if not hasattr(lib, "fpm_launch_floor"):
        return None
    stream = kernels._current_stream(dev)
    return lambda: build.check(lib, lib.fpm_launch_floor(dev.index, stream), "launch floor")


def device_us(call, dev_count: int, calls: int = None) -> dict:
    """``call`` TIMED times in a torch.profiler window after PAD spin
    kernels on every card: the device µs a call of every record but the
    spin kernels', and the records by name (calls, µs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = calls or TIMED
    call()
    for d in range(dev_count):
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for d in range(dev_count):
            with torch.cuda.device(d):
                for _ in range(PAD):
                    torch.cuda._sleep(1000)
        for _ in range(calls):
            call()
        for d in range(dev_count):
            torch.cuda.synchronize(d)
    got = {e.key[:70]: (e.count, getattr(e, "device_time_total", 0) or 0)
           for e in prof.key_averages() if "spin_kernel" not in e.key}
    got = {k: v for k, v in got.items() if v[1] > 0}
    return {"device_us": sum(us for _, us in got.values()) / calls, "by_name": got}


def event_us(call, reps: int = 50) -> float:
    import torch

    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def pull_records(lib, device: int, reset: bool = True) -> list:
    """The profile build's pull stamps on ``device`` since the last reset:
    [launch, block, start ns, end ns] each."""
    import ctypes

    n = 64 * 1024
    out, made = (ctypes.c_longlong * (4 * n))(), ctypes.c_int(0)
    err = lib.fpm_peer_records(out, n, int(reset), device, ctypes.byref(made))
    if err:
        raise RuntimeError(f"fpm_peer_records: error {err}")
    return [list(out[4 * i:4 * i + 4]) for i in range(min(made.value, n))]


def stamp_spans(records: list) -> dict:
    """Per launch of the records: the blocks' span (first start to last
    end) and each block's µs; their medians over the launches."""
    by: dict = {}
    for launch, _, t0, t1 in records:
        by.setdefault(launch, []).append((t0, t1))
    spans = [(max(b for _, b in v) - min(a for a, _ in v)) / 1e3 for v in by.values()]
    blocks = [(b - a) / 1e3 for v in by.values() for a, b in v]
    starts = [(max(a for a, _ in v) - min(a for a, _ in v)) / 1e3 for v in by.values()]
    return {"launches": len(by), "span_us": statistics.median(spans) if spans else None,
            "block_us": statistics.median(blocks) if blocks else None,
            "block_us_max": max(blocks) if blocks else None,
            "last_start_us": statistics.median(starts) if starts else None}


@contextlib.contextmanager
def stamping(build):
    """Every peer kernel from the profile build of ``csrc/epry_peer.cu``
    (its pulls stamp their blocks) while the context lasts."""
    library = build.library
    build.library = (lambda stem: build.profile_library(stem) if stem == "epry_peer"
                     else library(stem))
    try:
        yield
    finally:
        build.library = library


def pull_call(kernels, dst, src, plan):
    """One pull of ``src`` into ``dst``: the wrapper as planned (``plan``
    None) or forced to ``plan``."""
    return forced_call(kernels.peer_pull, plan, lambda: kernels.peer_pull(dst, src))


def pull_run(root: str, args) -> dict:
    """The P4 rows (see the module's docstring)."""
    import torch

    from fpm_torch.ops import build, kernels

    cards = torch.cuda.device_count()
    new = hasattr(kernels, "pull_plan")
    out: dict = {"cards": cards, "rows": []}
    d0 = torch.device("cuda", 0)
    if cards > 1:
        kernels.enable_peer_access(d0, torch.device("cuda", 1))
    for shape in args.shapes:
        nl, n = PULL_SHAPES[shape]
        for where in ["this card"] + (["peer"] if cards > 1 else []):
            sdev = torch.device("cuda", 1 if where == "peer" else 0)
            g = torch.Generator(device="cpu").manual_seed(nl + n)
            tile = torch.randn((2, nl // 2, nl), generator=g).to(sdev)
            src, dst = tile[:, :n], torch.empty((2, n, nl), device=d0)
            want = src.cpu()
            calls = {"wrapper": None}
            if new:
                calls.update(pull_variants(kernels, 2, n))
            for name, plan in calls.items():
                call = pull_call(kernels, dst, src, plan)
                row = {"shape": shape, "source": where, "call": name,
                       "plan": None if plan is None else plan._asdict()}
                if plan is None and new:
                    row["plan"] = kernels.pull_plan(2, n, nl, src.stride(0), src.stride(1),
                                                    aligned=kernels._aligned([dst, src]))._asdict()
                dst.zero_()
                try:
                    call()
                    torch.cuda.synchronize(d0)
                except RuntimeError as e:
                    out["rows"].append(dict(row, refused=str(e)))
                    continue
                row["bitwise"] = bool(torch.equal(dst.cpu(), want))
                row.update(device_us(call, cards))
                row["event_us"] = event_us(call)
                if new:         # the same calls through the profile build, stamped
                    lib = build.profile_library("epry_peer")
                    with stamping(build):
                        pull_records(lib, 0)
                        for _ in range(TIMED):
                            call()
                        row["stamped"] = stamp_spans(pull_records(lib, 0))
                out["rows"].append(row)
            copy = (lambda: dst.copy_(src))
            out["rows"].append({"shape": shape, "source": where, "call": "copy_",
                                **device_us(copy, cards), "event_us": event_us(copy)})
    empty = floor_call(build, d0)
    if empty:
        out["rows"].append({"call": "empty kernel", **device_us(empty, cards),
                            "event_us": event_us(empty)})
    if cards >= 4:
        out["in_sweep"] = pull_in_sweep(new)
    return out


def pull_in_sweep(new: bool) -> list:
    """Card 0's pull in the one-process (2,2) sweep over four cards, fresh
    and stale (see the module's docstring)."""
    import torch

    from fpm_torch.ops import build, kernels
    from fpm_torch.parallel import graph, make_mesh

    cs = smoke_module()
    problem = cs.sharded_problem("mono")
    rows = []     # stamped: every peer kernel from the profile build
    for stale in (False, True):
        for stamped in (False, True) if new else (False,):
            with stamping(build) if stamped else contextlib.nullcontext():
                mesh = make_mesh(2, 2)
                route, body = cs.prepared_sweep(problem, mesh, {}, stale)
                captured = graph.SweepGraph(mesh, route, body)
                ms, _, _ = cs.wall_ms(captured.replay)
                row = {"stale": stale, "stamped": stamped, "wall_ms_per_sweep": ms,
                       "pulls_per_sweep": captured.launches["peer_pull"]}
                row.update(split_launches(build, kernels, captured.replay, ms, stamped))
                traced = cs.gated_trace(captured.replay, ms)
                row["by_card_kernel_ms"] = {k: v["kernel_ms"] for k, v in traced["by_card"].items()}
                row["by_card_kernel_ms_median"] = {k: v.get("kernel_ms_median")
                                                   for k, v in traced["by_card"].items()}
                rows.append(row)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
    return rows


CALIBRATION = 5     # pulls alone on an idle card 0, after a traced replay


def split_launches(build, kernels, replay, ms: float, stamped: bool) -> dict:
    """Card 0's pulls in one ``replay`` of the sweep under torch.profiler,
    ungated and behind a gate (a spin kernel of 10 × ``ms`` + 50 ms on each
    card first, as ``chip_smoke.gated_trace`` holds the cards), each
    followed in the same window by CALIBRATION pulls of the mono halo
    alone on card 0: the replay's pulls' median device µs and, ``stamped``
    (the profile build's block stamps), each one's device µs split on the
    card's global clock into the wait from its traced start to its first
    block, its blocks' span and the drain after its last block. The
    trace's clock and the stamps' are set against each other by the alone
    pulls (the median of their first block's start less their traced
    start), so a wait is counted beyond an idle launch's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lib = build.profile_library("epry_peer") if stamped else None
    nl, n = PULL_SHAPES["mono"]
    d0 = torch.device("cuda", 0)
    tile = torch.randn((2, nl // 2, nl), device=d0)
    halo = torch.empty((2, n, nl), device=d0)
    cards = range(torch.cuda.device_count())
    out = {}
    for gated in (False, True):
        if stamped:
            pull_records(lib, 0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for d in cards:
                with torch.cuda.device(d):
                    for _ in range(PAD):
                        torch.cuda._sleep(1000)
                    if gated:
                        torch.cuda._sleep(int((10 * ms + 50) * 2e6))
            replay()
            for d in cards:
                torch.cuda.synchronize(d)
            for _ in range(CALIBRATION):
                kernels.peer_pull(halo, tile[:, :n])
                torch.cuda.synchronize(d0)
        path = os.path.join(HERE, "build", "p4_split.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(path)
        traced = sorted((e["ts"], e["dur"]) for e in events
                        if e.get("ph") == "X" and e.get("cat") == "kernel"
                        and "peer_pull" in e["name"] and e["args"].get("device") == 0)
        sweep = traced[:-CALIBRATION]
        res = {"launches_traced": len(sweep),
               "device_us": statistics.median(d for _, d in sweep) if sweep else None}
        if stamped:
            by: dict = {}
            for launch, _, t0, t1 in pull_records(lib, 0):
                by.setdefault(launch, []).append((t0, t1))
            got = sorted((min(a for a, _ in v), max(b for _, b in v)) for v in by.values())
            res["launches_stamped"] = len(got) - CALIBRATION
            if len(got) == len(traced) and sweep:
                t_0, s_0 = traced[0][0], got[0][0]
                offset = statistics.median((ts - t_0) - (first - s_0) / 1e3 for (ts, _), (first, _)
                                           in zip(traced[-CALIBRATION:], got[-CALIBRATION:]))
                split = [((first - s_0) / 1e3 + offset - (ts - t_0), (last - first) / 1e3,
                          (ts + dur - t_0) - ((last - s_0) / 1e3 + offset), dur)
                         for (ts, dur), (first, last) in zip(traced, got)]
                for name, rows in (("in_sweep", split[:-CALIBRATION]),
                                   ("alone", split[-CALIBRATION:])):
                    res[name] = {key: statistics.median(r[i] for r in rows) for i, key in
                                 enumerate(("wait_to_first_block_us", "blocks_span_us",
                                            "drain_us", "device_us"))}
                    res[name]["each"] = [[round(x, 3) for x in r] for r in rows]
        out["gated" if gated else "ungated"] = res
    return out


def post_run(root: str, args) -> dict:
    """The P2 rows (see the module's docstring)."""
    import torch

    from fpm_torch.ops import build, kernels

    dev = torch.device("cuda", 0)
    words = kernels.flag_block(dev)
    kernels.peer_epoch(words)
    kernels.peer_post(words, 0, 0)
    calls = {"peer_post": lambda: kernels.peer_post(words, 0, 0),
             "peer_epoch": lambda: kernels.peer_epoch(words),
             "peer_wait": lambda: kernels.peer_wait([(words, 0, 0)], words),
             "empty kernel": floor_call(build, dev)}
    order = [name for name, call in calls.items() if call]
    rows = []
    for name in order + order[::-1]:
        rows.append({"call": name, **device_us(calls[name], 1),
                     "event_us": event_us(calls[name])})
        kernels.peer_post(words, 0, 0)
    return {"rows": rows}


# P1's forms, timed beside the checkout's own (``--kernel P1``).
P1_FORMS = ("ld, st, membar.sys", "ld, st", "red.relaxed.gpu")
P1_FORMS_SOURCE = r"""
#include <cuda_runtime.h>
typedef unsigned long long u64;
__global__ void epoch_fenced(u64* w) { w[0] = __ldcg(w) + 1ull; __threadfence_system(); }
__global__ void epoch_stored(u64* w) { w[0] = __ldcg(w) + 1ull; }
__global__ void epoch_reduced(u64* w) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(w), "l"(1ull) : "memory");
}
extern "C" int fpm_p1_form(int form, void* words, void* stream) {
  u64* w = static_cast<u64*>(words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) epoch_fenced<<<1, 1, 0, s>>>(w);
  else if (form == 1) epoch_stored<<<1, 1, 0, s>>>(w);
  else epoch_reduced<<<1, 1, 0, s>>>(w);
  return (int)cudaGetLastError();
}
"""
EPOCH_CALLS = 1000
SASS_MEMORY = {"MEMBAR", "FENCE", "ERRBAR", "CCTL", "RED", "REDG", "ATOM", "ATOMG", "LDG",
               "STG", "LD", "ST"}


def p1_forms_library(root: str):
    """P1_FORMS_SOURCE built into ``root``'s ``build/p1_forms/``,
    loaded: (library, its path)."""
    import ctypes

    from fpm_torch.ops import build

    out = os.path.join(root, "build", "p1_forms")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "p1_forms.cu"), os.path.join(out, "libp1_forms.so")
    with open(src, "w") as f:
        f.write(P1_FORMS_SOURCE)
    made = subprocess.run([build._tool("nvcc"), *build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if made.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{made.stdout}{made.stderr}")
    cdll = ctypes.CDLL(lib)
    cdll.fpm_p1_form.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    cdll.fpm_p1_form.restype = ctypes.c_int
    return cdll, lib


def sass_memory(path: str, names: tuple) -> dict:
    """The memory and fence instructions (opcodes of SASS_MEMORY) of each
    function of ``path`` whose name holds one of ``names``, in order."""
    import re

    from fpm_torch.ops import build

    text = subprocess.run([build._tool("cuobjdump"), "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if any(n in m.group(1) for n in names) else None
            if name:
                out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
        if name and m:
            words = m.group(1).split()
            opcode = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
            if opcode.split(".")[0] in SASS_MEMORY:
                out[name].append(m.group(1))
    return out


def epoch_run(root: str, args) -> dict:
    """The P1 rows (see the module's docstring)."""
    import torch

    from fpm_torch.ops import build, kernels

    dev = torch.device("cuda", 0)
    forms, forms_path = p1_forms_library(root)
    stream = kernels._current_stream(dev)

    def form_call(i, block):
        def call():
            err = forms.fpm_p1_form(i, block.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{P1_FORMS[i]}: CUDA error {err}")
        return call

    def epoch_calls(block):
        return {"peer_epoch": lambda: kernels.peer_epoch(block),
                **{form: form_call(i, block) for i, form in enumerate(P1_FORMS)}}

    calls = {**epoch_calls(kernels.flag_block(dev)), "empty kernel": floor_call(build, dev)}
    order = [name for name, call in calls.items() if call]
    rows = [{"call": name, **device_us(calls[name], 1), "event_us": event_us(calls[name])}
            for name in order + order[::-1]]
    after = {}
    for name in ("peer_epoch", *P1_FORMS):
        block = kernels.flag_block(dev)
        call = epoch_calls(block)[name]
        for _ in range(EPOCH_CALLS):
            call()
        torch.cuda.synchronize(dev)
        after[name] = int(block[0])
    main = str(build.build_all(("epry_peer",))["epry_peer"])
    return {"rows": rows, "calls": EPOCH_CALLS, "words_after": after,
            "sass": {**sass_memory(main, ("peer_epoch",)),
                     **sass_memory(forms_path, ("epoch_",))}}


def _median_tree(xs):
    if isinstance(xs[0], dict):
        return {k: _median_tree([x[k] for x in xs]) for k in xs[0]}
    vals = [x for x in xs if x is not None]
    return statistics.median(vals) if vals else None


def child(root: str, args) -> int:
    """One checkout's run, in this process: printed as ``RUN <json>``."""
    sys.path.insert(0, root)
    import fpm_torch

    assert fpm_torch.__file__.startswith(root), fpm_torch.__file__
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    res = {"K1": k1_run, "K2": k2_run, "C3": pupil_run, "P4": pull_run, "P3": wait_run,
           "P2": post_run, "P1": epoch_run}.get(
        args.kernel, consensus_run)(root, args)
    print("RUN " + json.dumps(res), flush=True)
    return 0


def run(root: str, argv: list[str]) -> dict:
    root = os.path.abspath(root)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, *argv],
                         cwd=root, capture_output=True, text=True, timeout=1800)
    if out.returncode:
        raise RuntimeError(f"{root} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("RUN ")][-1][4:])


def side_by_side(kernel: str, runs: list) -> dict:
    """Each number of both checkouts' runs, {"other": [...], "this": [...]}."""
    by = {name: [r for n, r in runs if n == name] for name in ("other", "this")}

    def side(get):
        return {name: [get(r) for r in rs] for name, rs in by.items()}

    if kernel == "K2":
        phases = list(by["this"][0]["k2_phase_profile"]["bf16x3"]["by_phase"])
        return {
            "ms_per_sweep": {t: side(lambda r, t=t: r["ms_per_sweep"][t])
                             for t in ("bf16x3", "highest")},
            "ms_per_problem_sweep": {p: side(lambda r, p=p: r["ms_per_problem_sweep"][p])
                                     for p in ("16", "66", "132")},
            "cycles_per_led": {t: side(lambda r, t=t: r["k2_phase_profile"][t]["cycles_per_led"])
                               for t in ("bf16x3", "highest")},
            "bf16x3_by_phase": {ph: side(lambda r, ph=ph: r["k2_phase_profile"]["bf16x3"]
                                         ["by_phase"].get(ph)) for ph in phases}}
    if kernel in ("C3", "P4", "P3", "P2", "P1"):
        names = ("case", "shape", "source", "call")

        def key(row):
            return tuple(row.get(k) for k in names)
        sides: dict = {}
        for name, rs in by.items():
            for r in rs:
                for row in r["rows"]:
                    if "device_us" in row or "wake_us_median" in row:
                        sides.setdefault(key(row), {"other": [], "this": []})[name].append(
                            [row.get("device_us"), row.get("event_us")]
                            if "device_us" in row else row["wake_us_median"])
        out = {"device_us_event_us": [dict({n: v for n, v in zip(names, k) if v is not None},
                                           **v) for k, v in sides.items()]}
        if kernel in ("C3", "P4"):
            out["in_sweep"] = {name: [r.get("in_sweep") for r in rs] for name, rs in by.items()}
        return out
    if kernel in CONSENSUS_MESH:
        keys = ("device_us", "event_us", "stamped")
        return {"rows": [{"shape": row["shape"],
                          **{k: side(lambda r, k=k, i=i: r["rows"][i].get(k)) for k in keys}}
                         for i, row in enumerate(by["this"][0]["rows"])]}
    rows = []
    for i, row in enumerate(by["this"][0]["rows"]):
        head = {k: row[k] for k in ("shape", "tier", "chunk", "forced_cs")}
        rows.append(dict(head, **{key: side(lambda r, key=key: r["rows"][i].get(key))
                                  for key in ("ms_per_sweep", "device_ms_per_sweep")},
                         by_kernel=side(lambda r: {k: v["mean_us"] for k, v in
                                                   r["rows"][i].get("by_kernel", {}).items()})))
    return {"rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="K2",
                    choices=("K1", "K2", *CONSENSUS_MESH, "C3", "P4", "P3", "P2", "P1"))
    ap.add_argument("--other", help="the root of another checkout, run in turns with this one")
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--shapes", nargs="+", default=["mono"], choices=sorted(CHUNKS))
    ap.add_argument("--cs", nargs="+", type=int, default=[0])
    ap.add_argument("--tiers", nargs="+", default=["bf16x3"], choices=("bf16x3", "highest"))
    ap.add_argument("--chunks", nargs="+", type=int, default=None)
    ap.add_argument("--z-layout", type=int, default=0, choices=(0, 1, 2))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args)
    own = ["--kernel", args.kernel, "--shapes", *args.shapes, "--cs", *map(str, args.cs),
           "--tiers", *args.tiers, "--z-layout", str(args.z_layout)]
    if args.chunks:
        own += ["--chunks", *map(str, args.chunks)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    order = ([("other", args.other), ("this", HERE), ("this", HERE), ("other", args.other)]
             if args.other else [("this", HERE)])
    lines, runs = [], []
    for name, root in order:
        res = run(root, own)
        lines.append(json.dumps({"checkout": name, "root": root, "kernel": args.kernel, **res,
                                 "gpu": smi}))
        print(lines[-1], flush=True)
        runs.append((name, res))
    if args.other:
        lines.append(json.dumps({**side_by_side(args.kernel, runs),
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
