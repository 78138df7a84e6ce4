#!/usr/bin/env python3
"""Multi-process runs of the PyTorch/CUDA port (``fpm_torch``) on several
cards of one host, against one process.

Run from the repository root on a machine with four cards:

    python3 multicard_smoke.py          # four H100s: NCCL between processes
    python3 multicard_smoke.py --parent build/parent   # also time a parent checkout
    python3 multicard_smoke.py --cpu    # rehearsal on CPU ranks (gloo)

On the mono dome problem of ``chip_smoke.py`` (Np=90, NL=360, K=193 LEDs),
``fpm_torch run --distributed --use-pallas -n 3`` as 4 processes (a card
each) with ``--mesh 2 2``, ``--mesh 4 1`` and ``--mesh 1 4`` (every halo
crosses a process), as 2 processes (two cards each) with ``--mesh 2 2``, and
with ``--comm-precision bf16 --stale-consensus`` on (2 processes, ``--mesh 2
2``) and (4 processes, ``--mesh 1 4``), and with ``--stale-consensus`` (4
processes, ``--mesh 4 1`` and ``--mesh 2 2``); then, in this process, the
peer route's halo pull on an idle pair of cards beside ``copy_`` from the
same peer (``peer_pair``) and the ordering litmus of its flags across
cards (``ordering_litmus``: a writer's post, a reader on another card that
waits for it and pulls the writer's 8 MB in place, every element checked);
then the
one-process meshes (4,1) and (2,2) over the four cards, fresh and stale,
which replay one sweep captured into a CUDA graph over the four cards on
the peer route (``fpm_torch.parallel.mesh.peer_route``: payloads read in
place, the order between cards kept by flags): ms per sweep, the host's
enqueue ms of a replay, the capture ms, the event edges between cards a
sweep, the overlaps of each card and the chunk stages of a traced sweep
(under the stale consensus a consensus kernel beside the next K3 on every
card), beside the host loop's, the two routes bitwise
(``one_process_sweeps``); with ``--parent DIR`` also the one-process
graphs of that checkout, timed in turns with this one's (parent, this,
this, parent; ``scripts/process_sweeps.py --one-process``); then
``--fov-grid 8 8 -n 10`` on the 568×568 frames over 2 and 4 processes. Each run against the same command in
one process (its mesh's ranks round-robin over the cards): the arrays
bitwise equal, the counted collectives equal, the transport the layout
calls for (nccl: every process on cards of its own), nothing written by a
process other than 0, and the route ``fpm_torch.parallel.graph.replays``
fixes: over nccl every process replays one sweep captured with its
collectives (``graph`` true, with each process's capture ms, the host's
enqueue ms of a replay and ms a sweep of its replays), over gloo the host
walks the loop (``graph`` false). One JSON line per run with each
process's wall seconds. Then ``multicard_processes``: 4 processes, a card
each, ``--mesh 4 1`` and ``--mesh 2 2``, fresh and stale, on prepared grids
(``scripts/process_sweeps.py``): ms a sweep of each process's host loop and
of its replayed graph, and of a stale replay traced behind a gate on each
card its overlaps and chunk stages (recorded, not checked); with
``--parent DIR`` the host loop of the checkout in DIR too, timed in turns
(parent, this checkout, this checkout, parent). Any failure exits
non-zero. It never imports JAX or ``fpm_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs

MESH_CASES = ((4, ["--mesh", "2", "2"]), (4, ["--mesh", "4", "1"]), (4, ["--mesh", "1", "4"]),
              (2, ["--mesh", "2", "2"]), (2, ["--mesh", "2", "2", *cs.LEVERS]),
              (4, ["--mesh", "1", "4", *cs.LEVERS]),
              (4, ["--mesh", "4", "1", "--stale-consensus"]),
              (4, ["--mesh", "2", "2", "--stale-consensus"]))
ONE_PROCESS_MESHES = ((4, 1), (2, 2))
FOV_PROCESSES = (2, 4)
HBM_BYTES_S, NVLINK_BYTES_S = 3.35e12, 450e9    # an H100's memory; its NVLink, each way


PAIR_CALLS = 20


def peer_pair(cfg, gpu) -> dict:
    """The ``multicard_peer_pair`` lines: cards 0 and 1 idle, the forward
    halo of mesh (2,2) (mono: 2 × 90 rows of a 180 × 360 tile; dogStomach:
    2 × 200 of a 300 × 600 tile) pulled by card 0 from a tile on card 1
    (``kernels.peer_pull``, the plan it launches) and copied by
    ``Tensor.copy_`` from the same view: each one's device ms a call, the
    mean of PAIR_CALLS back-to-back calls in one profiler window after as
    many to warm (``chip_smoke.device_ms_by_kernel``; the first read over a
    link idle for milliseconds has been seen to take ~0.1 ms), and ms a
    call on CUDA events, the pull bitwise the tile's rows, and the NVLink
    bound (the rows read over NVLink once). Returns {halo: line}."""
    import torch

    from fpm_torch.config import FPMConfig
    from fpm_torch.ops import kernels

    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    kernels.enable_peer_access(d0, d1)
    dog = FPMConfig(**cs.DOG_OPTICS)
    out = {}
    for name, (nl, n) in (("mono", (cfg.n_large, cfg.np_size)),
                          ("dogStomach", (dog.n_large, dog.np_size))):
        tile = torch.randn((2, nl // 2, nl), device=d1)
        src, dst = tile[:, :n], torch.empty((2, n, nl), device=d0)
        pull, copy = (lambda: kernels.peer_pull(dst, src)), (lambda: dst.copy_(src))
        pull()
        torch.cuda.synchronize(d0)
        bitwise = bool(torch.equal(dst.cpu(), src.cpu()))

        def device_ms(fn):
            for _ in range(PAIR_CALLS):
                fn()
            return sum(cs.device_ms_by_kernel(
                lambda: [fn() for _ in range(PAIR_CALLS)]).values()) / PAIR_CALLS

        with torch.cuda.device(d0):
            line = {"phase": "multicard_peer_pair", "halo": name, "shape": [2, n, nl],
                    "plan": kernels.pull_plan_of(dst, src)._asdict()
                    if hasattr(kernels, "pull_plan_of") else None, "bitwise": bitwise,
                    "device_ms": device_ms(pull), "copy_device_ms": device_ms(copy),
                    "ms": cs.cuda_ms(pull, 50), "copy_ms": cs.cuda_ms(copy, 50),
                    "nvlink_bound_ms": 2 * n * nl * 4 / NVLINK_BYTES_S * 1e3, "gpu": gpu}
        cs.emit(line)
        cs.check(bitwise, f"{name}: the pull from a peer is not the tile's rows")
        out[name] = line
    return out


def ordering_litmus(gpu, repeats: int = 8) -> None:
    """The ``multicard_litmus`` lines: for each pair of cards (0 → 1, 1 → 0,
    2 → 3), card A spins (0 to ~2 ms), writes an 8 MB buffer (a pattern
    plus the round's number) and posts its flag (``kernels.peer_post``);
    card B waits on that flag on its own stream (``peer_wait``) and pulls
    A's buffer in place (``peer_pull``). Every element read must be the
    round's, over ``repeats`` times epochs 1-3 (each sweep's epoch bumped
    on both cards) and chunks 0-3 (both parities of a signal): each round
    waits for a post no earlier round made, since a flag only grows. Any
    element wrong fails the run."""
    import torch

    from fpm_torch.ops import kernels

    for pa, pb in ((0, 1), (1, 0), (2, 3)):
        a, b = torch.device("cuda", pa), torch.device("cuda", pb)
        kernels.enable_peer_access(b, a)
        words, mine = kernels.flag_block(a), kernels.flag_block(b)
        pattern = torch.arange(2 * 1024 * 1024, dtype=torch.float32, device=a).view(2, 1024, 1024)
        src, dst = torch.empty_like(pattern), torch.empty(pattern.shape, device=b)
        want = pattern.to(b)
        sa, sb = torch.cuda.Stream(a), torch.cuda.Stream(b)
        wrong, checked, t0 = 0, 0, time.perf_counter()
        for epoch in range(1, 3 * repeats + 1):
            for w in (words, mine):
                kernels.peer_epoch(w)
            for d in (a, b):
                torch.cuda.synchronize(d)
            for chunk in range(4):
                spin = (0, 100_000, 1_000_000, 4_000_000)[(epoch + chunk) % 4]
                value = float(100 * epoch + chunk)
                with torch.cuda.device(a), torch.cuda.stream(sa):
                    if spin:
                        torch.cuda._sleep(spin)
                    torch.add(pattern, value, out=src)
                    kernels.peer_post(words, chunk % 2, chunk)
                with torch.cuda.device(b), torch.cuda.stream(sb):
                    kernels.peer_wait([(words, chunk % 2, chunk)], mine)
                    kernels.peer_pull(dst, src)
                for d in (a, b):
                    torch.cuda.synchronize(d)
                wrong += int((dst != want + value).sum())
                checked += dst.numel()
        cs.emit({"phase": "multicard_litmus", "poster": pa, "reader": pb,
                 "rounds": 3 * repeats * 4, "elements_checked": checked, "wrong": wrong,
                 "plan": kernels.pull_plan_of(dst, src)._asdict()
                 if hasattr(kernels, "pull_plan_of") else None,
                 "seconds": time.perf_counter() - t0, "gpu": gpu})
        cs.check(wrong == 0, f"litmus {pa} -> {pb}: {wrong} elements read before the post")


def consensus_bounds(cfg, led: int, tile: int, by_card=None, pair=None) -> dict:
    """Card 0's consensus kernels of one chunk on the peer route, a rank a
    card, and on the tile axis its halo pull: the bytes each reads and
    writes in its own memory (its rank's payload, the state read and
    written once; the pulled rows written) and those it reads from its
    peers over NVLink (their payloads in place; the rows pulled), and the
    least time, the larger of the two at the H100's 3.35 TB/s and 450 GB/s
    each way; with ``by_card`` (a trace's, ``chip_smoke.gated_trace``)
    beside it ``device_ms``, card 0's mean device ms a launch of the kernel
    in that trace (``device_ms_median`` its median), and ``bound_share``
    (bound / device ms); with ``pair``
    (:func:`peer_pair`'s mono line) beside the pull the same pull's and
    ``copy_``'s device ms on an idle pair of cards. Not a gate."""
    from fpm_torch.geometry import pupil_radius
    from fpm_torch.ops import kernels

    nl, n = cfg.n_large, cfg.np_size
    b, _ = kernels.bbox_extent(n, pupil_radius(cfg))
    pupil, metrics = 2 * b * b * 4, 2 * 4
    if tile == 1:
        d = 2 * nl * nl * 4
        rows = {"consensus_led": (d + pupil + metrics + 2 * d + 2 * pupil,
                                  (led - 1) * (d + pupil + metrics))}
    else:
        s = nl // tile
        own, halo = 2 * s * nl * 4, 2 * min(n, s) * nl * 4
        rows = {"peer_pull": (halo, halo),
                "consensus_tile_object": (own + 2 * own, (led - 1) * own + led * halo),
                "consensus_tile_pupil": (pupil + metrics + 4 + 2 * pupil,
                                         (led * tile - 1) * (pupil + metrics) + (tile - 1) * 4)}
    card0 = (by_card or {}).get(0) or {}
    measured, medians = card0.get("kernel_ms", {}), card0.get("kernel_ms_median", {})
    out = {}
    for name, (hbm, peer) in rows.items():
        bound_ms = max(hbm / HBM_BYTES_S, peer / NVLINK_BYTES_S) * 1e3
        device_ms = measured.get(name)
        out[name] = {"hbm_bytes": hbm, "nvlink_bytes": peer, "bound_ms": bound_ms,
                     "bound_by": "nvlink bytes" if peer / NVLINK_BYTES_S > hbm / HBM_BYTES_S
                     else "hbm bytes", "device_ms": device_ms,
                     "device_ms_median": medians.get(name),
                     "bound_share": bound_ms / device_ms if device_ms else None}
    if pair and "peer_pull" in out:
        out["peer_pull"].update(idle_pair_device_ms=pair["device_ms"],
                                idle_pair_copy_device_ms=pair["copy_device_ms"])
    return out


def run_case(label, flags, n_proc, arrays, tmp, transport, gpu) -> dict:
    """``run *flags`` in one process, then as ``n_proc`` processes; checked."""
    import numpy as np

    one_dir = os.path.join(tmp, "one")
    dirs = [os.path.join(tmp, f"p{pid}") for pid in range(n_proc)]
    one = cs.cli_recording(["run", *flags, "-o", one_dir])
    cs.check(one["rc"] == 0, f"{label}: one process exited {one['rc']}")
    t0 = time.perf_counter()
    recs = cs.processes(lambda pid: ["run", *flags, "-o", dirs[pid], "--distributed"], n_proc,
                        timeout=300)
    start_to_exit = time.perf_counter() - t0
    bitwise = {a: bool(np.array_equal(np.load(os.path.join(dirs[0], a)),
                                      np.load(os.path.join(one_dir, a)))) for a in arrays}
    others = {pid: sorted(os.listdir(dirs[pid])) for pid in range(1, n_proc)}
    line = {"phase": "multicard", "run": label, "processes": n_proc, "bitwise_one_process": bitwise,
            "other_process_files": others, "counts_equal_one_process":
                all(r["counts"] == one["counts"] for r in recs),
            "mesh_one_process": one["meshes"], "mesh": [r["meshes"] for r in recs],
            "launches": [r["launches"] for r in recs],
            "graph": bool(recs[0]["graphs"]) and all(r["graphs"] for r in recs),
            **cs.graph_figures(recs), "one_process": cs.graph_figures([one]),
            "wall_s": {"processes": [r["wall_s"] for r in recs], "one": one["wall_s"],
                       "processes_start_to_exit": start_to_exit}, "gpu": gpu}
    cs.emit(line)
    cs.check(all(bitwise.values()), f"{label}: not bitwise the one-process run: {bitwise}")
    cs.check(not any(others.values()), f"{label}: a process other than 0 wrote {others}")
    cs.check(line["counts_equal_one_process"], f"{label}: counted collectives differ")
    if transport is not None:
        cs.check(recs[0]["meshes"] and all(f"transport {transport}" in m
                                           for r in recs for m in r["meshes"]),
                 f"{label}: transport is not {transport}: {recs[0]['meshes']}")
        replayed = [bool(r["graphs"]) for r in recs]
        cs.check(all(replayed) if transport == "nccl" else not any(replayed),
                 f"{label}: graph {replayed} over {transport}")
    for d in (one_dir, *dirs):
        shutil.rmtree(d)
    return line


def one_process_sweeps(problem, gpu, pair=None) -> None:
    """The one-process meshes over the four cards (a rank per card), fresh
    and stale, chunk 32. Every rank is a CUDA rank of this process, so the
    run replays one sweep captured into a CUDA graph (``fpm_torch.parallel.
    graph``; one graph over the four cards), on the peer route where every
    pair of cards has peer access (``peer_route``, recorded): its ms per
    sweep (median of 5), the host's enqueue ms of a replay, its capture ms,
    the event edges between cards a sweep (``comm.card_edges`` of the
    captured schedule: on the peer route the fork and the join alone, none
    in the chunk loop), and from a gated trace of a replay (every K3 launch
    seen) ``overlap_ms``, ``consensus_overlap_ms`` of the whole and of each
    card (``by_card``, each card on its own clock) and the chunk stages
    (``chip_smoke.chunk_stages``): under the stale consensus a consensus
    kernel of chunk c runs beside a K3 of chunk c+1 on every card
    (``consensus_overlap_ms`` above 0 on each), fresh never (exactly 0);
    with ``consensus_schedule_check`` on the captured schedule. Beside it
    the host loop on the same prepared grids (the copy route): its ms per
    sweep, its edges and the same gated trace of a sweep; and the entry
    point's result on both routes, bitwise. The graph route's results are
    those the ``run_case`` lines hold bitwise against the multi-process
    runs."""
    from fpm_torch.parallel import comm, graph, make_mesh, peer_route

    for led, tile in ONE_PROCESS_MESHES:
        for stale in (False, True):
            def prepared():
                mesh = make_mesh(led, tile)
                return (mesh, *cs.prepared_sweep(problem, mesh, {}, stale))

            host_mesh, host_route, host_body = prepared()
            host_ms, host_walls, _ = cs.wall_ms(lambda: host_body(None))
            host_edges = comm.card_edges(host_mesh.schedule, host_mesh.edges)
            host_gated = cs.gated_trace(lambda: host_body(None), host_ms,
                                        chunks=host_route.n_chunks)
            mesh, route, body = prepared()
            captured = graph.SweepGraph(mesh, route, body)
            per_sweep = captured.launches["fused_chunk_increments"]
            ms, walls, enqueues = cs.wall_ms(captured.replay)
            verdict = comm.consensus_schedule_check(mesh.schedule)
            edges, route_name = comm.card_edges(mesh.schedule, mesh.edges), peer_route(mesh)
            gated = cs.complete_trace(lambda: cs.gated_trace(captured.replay, ms,
                                                             chunks=route.n_chunks), per_sweep)
            stages = gated["stages"]
            entry = cs.sharded_run(problem, led, tile, {}, stale)
            replayed = cs.result_digest(entry)
            walked = cs.result_digest(cs.host_walked_run(problem, led, tile, {}, stale))
            label = f"one process {led}x{tile}{' stale' if stale else ''}"
            cs.emit({"phase": "multicard_one_process", "mesh": [led, tile],
                     "stale_consensus": stale, "ranks": mesh.describe(),
                     "graph": entry.replay is not None,
                     "cards_in_graph": len(mesh.cards()), "peer_route": route_name,
                     "consensus_bounds": consensus_bounds(problem[0], led, tile,
                                                          gated["by_card"], pair),
                     "card_edges_per_sweep": edges, "host_loop_card_edges": host_edges,
                     "peer_launches_per_sweep": {k: v for k, v in captured.launches.items()
                                                 if k.startswith("peer_")},
                     "capture_ms": captured.capture_ms,
                     "k3_launches_per_sweep": per_sweep,
                     "wall_ms_per_sweep": ms, "wall_ms_all": walls,
                     "enqueue_ms": cs.median(enqueues), "enqueue_ms_all": enqueues,
                     "host_loop_wall_ms_per_sweep": host_ms, "host_loop_wall_ms_all": host_walls,
                     "overlap_ms": gated["overlap_ms"],
                     "consensus_overlap_ms": gated["consensus_overlap_ms"],
                     "by_card": gated["by_card"], "peer_wait_ms": gated["peer_wait_ms"],
                     "stages": stages, "span_ms_unpaced": gated["span_ms"],
                     "busy_ms_unpaced": gated["busy_ms"], "trace_unpaced": gated,
                     "host_loop_trace_unpaced": host_gated,
                     "consensus_schedule_check": verdict, "graph_digest": replayed,
                     "host_walked_digest": walked, "gpu": gpu})
            cs.check(entry.replay is not None, f"{label}: the entry point walked the loop")
            cs.check(replayed == walked, f"{label}: the graph route is not the host loop's bits")
            cs.check(verdict["issued_before_compute"] is stale,
                     f"{label}: issued before compute is not {stale}")
            cs.check(gated["gate_held"], f"{label}: the gate ended before the sweep was enqueued")
            cs.check(per_sweep > 0 and gated["k3_kernels"] == per_sweep,
                     f"{label}: K3 captured {per_sweep} times, traced {gated['k3_kernels']}")
            # On the peer route nothing but the fork and the join crosses a
            # card as an event, so the graph's launch resolves no edge
            # between cards in the chunk loop, and each card's consensus of
            # chunk c runs beside its K3 of chunk c+1 (stale) as on one card.
            n_cards = len(mesh.cards())
            cs.check(route_name == "peer" and edges["chunk_loop"] == 0
                     and edges["total"] <= 2 * (n_cards - 1),
                     f"{label}: route {route_name}, edges between cards {edges}")
            beside = {card: v["consensus_overlap_ms"] for card, v in gated["by_card"].items()}
            cs.check(len(beside) == n_cards and all(v > 0 if stale else v == 0
                                                    for v in beside.values()),
                     f"{label}: a consensus kernel beside a K3 for {beside} ms by card")


def one_process_turns(parent, gpu) -> None:
    """The ``multicard_one_process_turns`` lines: the one-process graphs
    over the four cards of ``parent`` and of this checkout in turns
    (parent, this, this, parent; ``scripts/process_sweeps.py
    --one-process``, a process each): for each mesh and consensus, ms a
    sweep of the host loop and of the replayed graph (medians of 3 and of
    15 rounds of 10 sweeps), the host's enqueue ms of a replay, and for this
    checkout its route and edges between cards."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "scripts", "process_sweeps.py")
    turns = [("parent", parent), ("this", here), ("this", here), ("parent", parent)]
    got = []
    for name, root in turns:
        out = subprocess.run([sys.executable, script, "--root", root, "--graph",
                              "--one-process"], capture_output=True, text=True, timeout=600)
        cs.check(out.returncode == 0, f"one process of {name}: exit {out.returncode}: "
                                      f"{out.stderr[-2000:]}")
        got.append((name, next(json.loads(ln[len("SWEEPS "):]) for ln in out.stdout.splitlines()
                               if ln.startswith("SWEEPS "))))
    for j, first in enumerate(got[0][1]["runs"]):
        runs = [(name, rec["runs"][j]) for name, rec in got]
        cs.emit({"phase": "multicard_one_process_turns", "mesh": first["mesh"],
                 "stale_consensus": first["stale_consensus"], "turns": [n for n, _ in runs],
                 **{key: [r.get(key) for _, r in runs] for key in (
                     "graph_ms", "enqueue_ms", "host_loop_ms", "capture_ms", "peer_route",
                     "card_edges")}, "gpu": gpu})


def process_sweeps(cpu: bool, parent, gpu) -> None:
    """The ``multicard_processes`` lines: ``scripts/process_sweeps.py`` as 4
    processes, this checkout with ``--graph --trace`` (on the card), and
    with ``parent`` that checkout's host loop, in turns: parent, this, this,
    parent. One line per mesh and consensus: each launch's per-process
    figures, the medians over processes of ms a sweep, and each card's
    chunk stages of the stale replay. Checked: every process of this
    checkout on the card replays a graph and its gate held."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "scripts", "process_sweeps.py")
    turns = [("parent", parent), ("this", here), ("this", here), ("parent", parent)]
    launches = []
    for name, root in turns if parent else turns[1:3]:
        extra = ["--cpu"] if cpu else ["--graph", "--trace"] if name == "this" else []
        outs = cs.run_processes(lambda pid: [sys.executable, script, "--root", root, *extra], 4,
                                timeout=300)
        launches.append((name, [json.loads(ln[len("SWEEPS "):]) for out in outs
                                for ln in out.splitlines() if ln.startswith("SWEEPS ")]))

    def med(runs, key):
        vals = [r[key] for r in runs if r.get(key) is not None]
        return cs.median(vals) if vals else None

    for j, first in enumerate(launches[0][1][0]["runs"]):
        (led, tile), stale = first["mesh"], first["stale_consensus"]
        by_turn = [(name, [p["runs"][j] for p in procs]) for name, procs in launches]
        mine = [runs for name, runs in by_turn if name == "this"]
        line = {"phase": "multicard_processes", "mesh": [led, tile], "stale_consensus": stale,
                "processes": 4, "ranks": mine[0][0]["ranks"],
                "graph": all(r.get("graph") for runs in mine for r in runs),
                "graph_ms": [med(runs, "graph_ms") for runs in mine],
                "enqueue_ms": [med(runs, "enqueue_ms") for runs in mine],
                "capture_ms": [med(runs, "capture_ms") for runs in mine],
                "host_loop_ms": [med(runs, "host_loop_ms") for runs in mine],
                "parent_host_loop_ms": [med(runs, "host_loop_ms")
                                        for name, runs in by_turn if name == "parent"],
                "turns": [name for name, _ in by_turn],
                "fpm_torch": [procs[0]["fpm_torch"] for _, procs in launches],
                "per_process": by_turn, "gpu": gpu}
        if stale and not cpu:
            last = mine[-1]
            line.update({"overlap_ms": [r["overlap_ms"] for r in last],
                         "consensus_overlap_ms": [r["consensus_overlap_ms"] for r in last],
                         "stages": [r["stages"] for r in last],
                         "gate_held": [r["gate_held"] for r in last],
                         "k3_traced": [[r["k3_kernels"], r["k3_launches_per_sweep"]]
                                       for r in last]})
        cs.emit(line)
        if not cpu:
            label = f"4 processes {led}x{tile}{' stale' if stale else ''}"
            cs.check(line["graph"], f"{label}: a process walked the host loop")
            cs.check(all(line.get("gate_held", [True])),
                     f"{label}: a gate ended before the replay was enqueued")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on CPU ranks at Np 16 (gloo between the processes)")
    ap.add_argument("--parent", default=None,
                    help="a checkout (e.g. the parent commit, unpacked with git archive) "
                         "whose host loop is timed beside this one's")
    args = ap.parse_args(argv)
    import torch

    from fpm_torch.config import FPMConfig
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry

    if args.cpu:
        cfg, wide_np, plat, gpu, transport = (FPMConfig(max_illumination_na=0.2, np_size=16),
                                              100, ["--platform", "cpu"], "cpu", "gloo")
    else:
        if torch.cuda.device_count() < 4:
            print("multicard_smoke: needs four CUDA cards", file=sys.stderr)
            return 1
        cfg, wide_np, plat, transport = FPMConfig(max_illumination_na=0.45), cs.WIDE, [], "nccl"
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().replace("\n", " | ")
    geom = compute_geometry(cfg)
    frames = simulate_images(make_test_object(cfg.n_large, seed=0), geom, cfg, quantize=True)
    cfg_wide = dataclasses.replace(cfg, np_size=wide_np)
    wide = simulate_images(make_test_object(cfg_wide.n_large, seed=0),
                           compute_geometry(cfg_wide), cfg_wide, quantize=True)
    with tempfile.TemporaryDirectory(prefix="fpm_multicard_") as tmp:
        mono = cs.write_dataset(os.path.join(tmp, "mono"), cfg, geom, frames)
        widep = cs.write_dataset(os.path.join(tmp, "wide"), cfg, geom, wide)
        for n_proc, extra in MESH_CASES:
            run_case(f"{n_proc} processes " + " ".join(extra),
                     [mono, "-n", "3", "--use-pallas", *plat, *extra], n_proc,
                     ("object_spectrum.npy", "pupil.npy"), tmp, transport, gpu)
        if not args.cpu:
            pair = peer_pair(cfg, gpu)
            ordering_litmus(gpu)
            one_process_sweeps((cfg, geom, frames), gpu, pair["mono"])
            if args.parent:
                one_process_turns(os.path.abspath(args.parent), gpu)
        process_sweeps(args.cpu, args.parent and os.path.abspath(args.parent), gpu)
        for n_proc in FOV_PROCESSES:
            run_case(f"{n_proc} processes --fov-grid 8 8",
                     [widep, "-n", "10", "--use-pallas", *plat, "--fov-grid", "8", "8"], n_proc,
                     ("object_stitched.npy",), tmp, None, gpu)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
