#!/usr/bin/env python3
"""How the cards of one process run a CUDA graph that spans them, and where
a replayed sharded sweep over four cards spends its span.

Run from the repository root on a machine with four cards:

    python3 scripts/graph_cards.py [--out chiprun_out/graph_cards.json]

Prints JSON lines, then the cards' name and power limit:

- ``peer``: ``torch.cuda.can_device_access_peer`` for each pair of cards.
- ``copy``: 3 MiB (about one rank's payload of a chunk at mono (4,1)) from
  card 0 to card 1, 20 copies enqueued on streams and the same 20 captured
  into a graph and replayed: µs a copy on CUDA events, GB/s.
- ``spins``: two graphs of spin kernels of 100 µs each across cards 0 and
  1, each against the same work enqueued on streams: two independent spins
  (one a card) and a chain (card 0's spin, then card 1's after an event
  wait); the host's ms to enqueue (a replay, or the stream calls) and the
  wall ms to the synchronisation; and the chain as one graph a card, the
  edge an external event node in each.
- ``nodes``: the host's ms to launch a graph of 16 or 128 spins of 1 µs a
  card on one card or on four, the cards' chains alone or linked by an
  event edge at every step, and its wall ms.
- ``sweep``: the one-process meshes (4,1) and (2,2) over the four cards,
  fresh and stale, on the mono problem of ``chip_smoke.py`` (chunk 32): a
  replay of the captured sweep and a sweep of the host loop, each traced
  behind a gate (``chip_smoke.gated_trace``), with the chunk stages of
  ``chip_smoke.chunk_stages``; no checks. With ``--out``, every traced
  kernel and copy of the stale (4,1) sweeps (card, kind, start and length
  in µs from the first) is written there too.

It never imports JAX or ``fpm_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SPIN_US = 100
CLOCK_GHZ = 1.98        # the H100's boost clock: cycles of a spin kernel


def spin(us: float) -> None:
    import torch

    torch.cuda._sleep(int(us * CLOCK_GHZ * 1e3))


def events_us(fn, reps: int) -> float:
    """µs per call of ``fn`` (enqueued ``reps`` times on card 0's current
    stream) on CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def across(fn_on, cards=(0, 1)):
    """``fn_on(card)`` for each card, each on a side stream of its card that
    forks from and joins into card 0's current stream (the mesh's way, which
    under a capture puts every card's work into the capture)."""
    import torch

    home = torch.cuda.current_stream(cards[0])
    streams = [torch.cuda.Stream(c) for c in cards]
    for s in streams:
        s.wait_stream(home)
    for c, s in zip(cards, streams):
        with torch.cuda.device(c), torch.cuda.stream(s):
            fn_on(c)
    for s in streams:
        home.wait_stream(s)


def graphed(fn):
    import torch

    g = torch.cuda.CUDAGraph()
    with torch.cuda.device(0), torch.cuda.graph(g, stream=torch.cuda.Stream(0)):
        fn()
    return g


def host_and_wall(fn, reps: int = 5):
    """Medians over ``reps`` of the host's ms to enqueue ``fn`` and the wall
    ms to the synchronisation after it."""
    import torch

    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return cs.median(host), cs.median(wall)


def probe_copy() -> dict:
    import torch

    n = 3 * 2**20 // 4
    src = torch.randn(n, device="cuda:0")
    dst = torch.empty(n, device="cuda:1")

    def copies():
        s1 = torch.cuda.current_stream(1)
        s1.wait_stream(torch.cuda.current_stream(0))
        with torch.cuda.device(1), torch.cuda.stream(s1):
            for _ in range(20):
                dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream(0).wait_stream(s1)

    def copies_across():
        across(lambda c: [dst.copy_(src, non_blocking=True) for _ in range(20)] if c == 1
               else None)

    stream_us = events_us(copies, 3) / 20
    g = graphed(copies_across)
    graph_us = events_us(g.replay, 3) / 20
    ok = torch.equal(dst.cpu(), src.cpu())
    return {"bytes": n * 4, "stream_us": stream_us, "graph_us": graph_us,
            "stream_gb_s": n * 4 / stream_us / 1e3, "graph_gb_s": n * 4 / graph_us / 1e3,
            "equal": ok}


def probe_spins() -> dict:
    import torch

    out = {}

    def independent():
        across(lambda c: spin(SPIN_US))

    def chain():
        home = torch.cuda.current_stream(0)
        s0, s1 = torch.cuda.Stream(0), torch.cuda.Stream(1)
        s0.wait_stream(home)
        with torch.cuda.device(0), torch.cuda.stream(s0):
            spin(SPIN_US)
        s1.wait_stream(s0)
        with torch.cuda.device(1), torch.cuda.stream(s1):
            spin(SPIN_US)
        home.wait_stream(s1)

    for name, fn in (("independent", independent), ("chain", chain)):
        g = graphed(fn)
        g.replay()
        sh, sw = host_and_wall(fn)
        gh, gw = host_and_wall(g.replay)
        out[name] = {"stream_host_ms": sh, "stream_wall_ms": sw, "graph_host_ms": gh,
                     "graph_wall_ms": gw}

    # The chain as one graph a card, the edge an event recorded in card 0's
    # graph and waited on in card 1's (external event nodes).
    edge = torch.cuda.Event(external=True)
    graphs = []
    for card in (0, 1):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.device(card), torch.cuda.graph(g, stream=torch.cuda.Stream(card)):
            if card:
                torch.cuda.current_stream(card).wait_event(edge)
            spin(SPIN_US)
            if not card:
                edge.record()
        graphs.append(g)

    def per_card():
        for card, g in enumerate(graphs):
            with torch.cuda.device(card):
                g.replay()

    per_card()
    ph, pw = host_and_wall(per_card)
    out["chain_graph_a_card"] = {"graph_host_ms": ph, "graph_wall_ms": pw}
    return out


def probe_nodes() -> dict:
    """The host's ms to launch a graph of many short kernels, and its wall
    ms: ``n`` spins of 1 µs on each of ``cards`` cards, each card's chain on
    a stream of its own forked from card 0's, either independent of the
    other cards (``alone``) or each spin after the previous spin of the next
    card too (``linked``, an event edge between cards at every step)."""
    import torch

    out = {}
    for cards in (1, 4):
        if cards > torch.cuda.device_count():
            continue
        for n in (16, 128):
            for linked in (False, True):
                if linked and cards == 1:
                    continue

                def body():
                    home = torch.cuda.current_stream(0)
                    streams = [torch.cuda.Stream(c) for c in range(cards)]
                    for st in streams:
                        st.wait_stream(home)
                    done = [None] * cards
                    for _ in range(n):
                        for c, st in enumerate(streams):
                            if linked and done[(c + 1) % cards] is not None:
                                st.wait_event(done[(c + 1) % cards])
                            with torch.cuda.device(c), torch.cuda.stream(st):
                                spin(1)
                            done[c] = torch.cuda.Event()
                            done[c].record(st)
                    for st in streams:
                        home.wait_stream(st)

                g = graphed(body)
                g.replay()
                host, wall = host_and_wall(g.replay)
                out[f"{cards} cards {n} {'linked' if linked else 'alone'}"] = {
                    "nodes": cards * n, "graph_host_ms": host, "graph_wall_ms": wall}
    return out


def probe_sweeps(keep: dict) -> list:
    import torch

    from fpm_torch.config import FPMConfig
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry
    from fpm_torch.parallel import graph, led_shard, make_mesh, tile_shard

    cfg = FPMConfig(max_illumination_na=0.45)
    geom = compute_geometry(cfg)
    frames = simulate_images(make_test_object(cfg.n_large, seed=0), geom, cfg, quantize=True)
    lines = []
    for led, tile in ((4, 1), (2, 2)):
        for stale in (False, True):
            mesh = make_mesh(led, tile)
            kw = dict(use_pallas=True, chunk_size=32, stale_consensus=stale)
            if tile == 1:
                route, opts = led_shard.prepare_led_sharded(frames, geom, cfg, mesh, **kw)

                def body(bufs):
                    return led_shard._sharded_sweep(mesh, route, opts=opts, bufs=bufs)
            else:
                route, opts, s = tile_shard.prepare_tile_sharded(frames, geom, cfg, mesh, **kw)

                def body(bufs):
                    return tile_shard._tile_sweep(mesh, route, opts=opts, s=s, bufs=bufs)
            captured = graph.SweepGraph(mesh, route, body)
            line = {"phase": "sweep", "mesh": [led, tile], "stale_consensus": stale,
                    "chunks": route.n_chunks, "capture_ms": captured.capture_ms}
            for name, fn in (("graph", captured.replay), ("host_loop", lambda: body(None))):
                _, wall = host_and_wall(fn)
                traced = cs.gated_trace(fn, wall, chunks=route.n_chunks,
                                        records=stale and tile == 1)
                if stale and tile == 1:
                    keep[name] = traced.pop("records", None)
                line[name] = {"wall_ms": wall, **{k: traced[k] for k in (
                    "span_ms", "busy_ms", "k3_ms", "lane_ms", "overlap_ms",
                    "consensus_overlap_ms", "stages", "k3_kernels", "kernels", "gate_held",
                    "enqueue_ms")}}
            lines.append(line)
            del captured
            torch.cuda.synchronize()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the stale (4,1) sweeps' traced records here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("graph_cards: needs two CUDA cards (four for the sweeps)", file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.emit({"phase": "peer", "cards": n,
             "access": [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
                        for i in range(n)]})
    for phase, probe in (("copy", probe_copy), ("spins", probe_spins), ("nodes", probe_nodes)):
        try:
            cs.emit({"phase": phase, "spin_us": SPIN_US, **probe()})
        except Exception as exc:            # a probe's failure is its finding
            cs.emit({"phase": phase, "error": repr(exc)})
    keep: dict = {}
    if n >= 4:
        for line in probe_sweeps(keep):
            cs.emit(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with tempfile.NamedTemporaryFile("w", dir=os.path.dirname(os.path.abspath(args.out)),
                                         delete=False) as f:
            json.dump(keep, f)
        os.replace(f.name, args.out)
    print(smi.replace("\n", " | "), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
