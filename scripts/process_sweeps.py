#!/usr/bin/env python3
"""Sweep times of a ``--distributed`` mesh with a process on each card,
measured in every process of the run, for this checkout of the port or
another (its parent's, say, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists).

Run as every process of one run (``FPM_COORDINATOR``,
``FPM_NUM_PROCESSES`` and ``FPM_PROCESS_ID`` set, as
``multicard_smoke.py`` starts it):

    python3 scripts/process_sweeps.py --root DIR [--graph] [--trace] [--cpu]

``fpm_torch`` is imported from ``DIR``. On the mono dome problem of
``chip_smoke.py`` (Np 90, NL 360, 193 LEDs, chunk 32) and each mesh of
``MESHES``, fresh and with the stale consensus, this process's ranks of the
global mesh (``make_mesh``: a rank a card), on prepared grids:

- ``host_loop_ms``: ms a sweep of the host loop (the sweep body without
  buffers, the chunk loop walked from Python), after one sweep of warm-up;
- with ``--graph``: the sweep captured into a CUDA graph
  (``fpm_torch.parallel.graph.SweepGraph``; ``graph``: whether the mesh's
  route is the graph's), its ``capture_ms`` (the warm-up sweep, the capture
  and the instantiation), ``graph_ms`` a sweep of its replays and the
  host's ``enqueue_ms`` of a replay;
- with ``--trace`` (this checkout only: it reads the trace with
  ``chip_smoke.trace_overlap``): one replay of each stale mesh traced
  behind a gate on this process's card, in every process at once:
  ``overlap_ms``, ``consensus_overlap_ms`` and ``chip_smoke.chunk_stages``
  on this card's own clock, with ``gate_held`` and the K3 kernels traced
  (no retry: one process alone cannot replay its collectives).

With ``--one-process`` it runs as one process over every visible card
(no ``torch.distributed``; ``make_mesh``: a rank a card, round-robin): the
one-process graph over the cards, and where the checkout has them its
``peer_route`` and the event edges between cards of the captured sweep
(``comm.card_edges``).

Each figure in ms a sweep is the median of 3 rounds (of 15 for the
graph's replays, which take well under a millisecond), a round being 10
sweeps from a barrier of the processes (none with ``--one-process``) to a
synchronisation with the card.
Prints one line ``SWEEPS {json}`` with this process's figures. ``--cpu``
rehearses it on CPU ranks at Np 16 (the host loop only; host times, no
device metric). It never imports JAX or ``fpm_tpu``.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys
import time

MESHES = ((4, 1), (2, 2))
ROUNDS, GRAPH_ROUNDS, SWEEPS_A_ROUND = 3, 15, 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose fpm_torch is timed")
    ap.add_argument("--graph", action="store_true", help="also the captured sweep's replays")
    ap.add_argument("--trace", action="store_true", help="also a gated trace of a stale replay")
    ap.add_argument("--cpu", action="store_true", help="rehearse on CPU ranks at Np 16")
    ap.add_argument("--one-process", action="store_true",
                    help="one process over every visible card, without torch.distributed")
    args = ap.parse_args(argv)
    faulthandler.enable()           # a SIGABRT prints every thread's stack
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist

    from fpm_torch.config import FPMConfig
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry
    from fpm_torch.parallel import led_shard, make_mesh, tile_shard
    from fpm_torch.parallel.multihost import initialize_from_env

    one = args.one_process
    assert one or initialize_from_env()
    cfg = (FPMConfig(max_illumination_na=0.2, np_size=16) if args.cpu
           else FPMConfig(max_illumination_na=0.45))
    geom = compute_geometry(cfg)
    frames = simulate_images(make_test_object(cfg.n_large, seed=0), geom, cfg, quantize=True)

    def sync():
        if not args.cpu:
            torch.cuda.synchronize()

    def per_sweep(fn, n_rounds=ROUNDS) -> float:
        rounds = []
        for _ in range(n_rounds):
            if not one:
                dist.barrier()
            t0 = time.perf_counter()
            for _ in range(SWEEPS_A_ROUND):
                fn()
            sync()
            rounds.append((time.perf_counter() - t0) * 1e3 / SWEEPS_A_ROUND)
        return sorted(rounds)[n_rounds // 2]

    runs = []
    for led, tile in MESHES:
        for stale in (False, True):
            mesh = make_mesh(led, tile, devices=["cpu"] * (led * tile // (
                1 if one else dist.get_world_size())) if args.cpu else None)
            kw = dict(use_pallas=True, chunk_size=32, stale_consensus=stale)
            if tile == 1:
                route, opts = led_shard.prepare_led_sharded(frames, geom, cfg, mesh, **kw)

                def body(bufs, mesh=mesh, route=route, opts=opts):
                    return led_shard._sharded_sweep(mesh, route, opts=opts, bufs=bufs)
            else:
                route, opts, s = tile_shard.prepare_tile_sharded(frames, geom, cfg, mesh, **kw)

                def body(bufs, mesh=mesh, route=route, opts=opts, s=s):
                    return tile_shard._tile_sweep(mesh, route, opts=opts, s=s, bufs=bufs)
            body(None)
            sync()
            run = {"mesh": [led, tile], "stale_consensus": stale, "ranks": mesh.describe(),
                   "host_loop_ms": per_sweep(lambda: body(None))}
            if args.graph:
                from fpm_torch.parallel import graph

                run["graph"] = graph.replays(mesh)
                captured = graph.SweepGraph(mesh, route, body)
                run["capture_ms"] = captured.capture_ms
                run["graph_ms"] = per_sweep(captured.replay, GRAPH_ROUNDS)
                run["enqueue_ms"] = sorted(captured.enqueue_ms)[len(captured.enqueue_ms) // 2]
                from fpm_torch.parallel import comm, mesh as mesh_module

                if hasattr(mesh_module, "peer_route"):
                    run["peer_route"] = mesh_module.peer_route(mesh)
                    run["card_edges"] = comm.card_edges(mesh.schedule, mesh.edges)
                if args.trace and stale:
                    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
                        __file__))))
                    import chip_smoke as cs

                    # One traced replay in every process, behind one gate of
                    # a fixed length: a retry in one process alone would
                    # replay collectives that no other process joins.
                    if not one:
                        dist.barrier()
                    gated = cs.trace_overlap(captured.replay, gate_ms=10 * run["graph_ms"] + 200,
                                             chunks=route.n_chunks,
                                             cards=[c.index for c, _ in mesh.cards()])
                    run.update({key: gated[key] for key in (
                        "overlap_ms", "consensus_overlap_ms", "stages", "gate_held",
                        "k3_kernels", "span_ms", "busy_ms")},
                        k3_launches_per_sweep=captured.launches["fused_chunk_increments"])
                del captured
            runs.append(run)
    import fpm_torch

    print("SWEEPS " + json.dumps({"process": 0 if one else dist.get_rank(), "root": root,
                                  "fpm_torch": os.path.dirname(fpm_torch.__file__), "runs": runs,
                                  "device": "cpu" if args.cpu
                                  else torch.cuda.get_device_name(mesh.home)}), flush=True)
    if not one:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
