#!/usr/bin/env python3
"""Where the host's time of a sharded sweep goes, all ranks on one card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/host_profile.py [--out chiprun_out/host_profile.txt]

On the mono dome problem of ``chip_smoke.py`` (chunk 32), for each mesh of
``MESHES``: the host's enqueue ms a sweep and the wall ms a sweep (mean of
20 sweeps, on the host's clock; the wall after a synchronisation); for
(4,1) also the enqueue µs a call of K3's internal entry
(``kernels.chunk_increments_into``) and of the LED axis's consensus wrapper
(``kernels.consensus_led``) on chunk 0's operands (200 calls each, no
synchronisation between), and the Python functions that take most of 10
sweeps' host time (``cProfile``, by own time; the profiler slows the host,
so its total is larger than the enqueue). One JSON line per mesh, the
profile as text (to ``--out`` too), and the card's name and power limit.
It never imports JAX or ``fpm_tpu``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

MESHES = ((4, 1), (2, 2), (1, 8))


def host_us(fn, n: int) -> float:
    """µs a call of ``fn`` on the host's clock, ``n`` calls after one."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="a file for the profile's text")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("host_profile: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fpm_torch.ops import build, kernels
    from fpm_torch.parallel import led_shard, make_mesh, tile_shard

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build.build_all()
    cfg, geom, frames = cs.sharded_problem("mono")
    kw = dict(use_pallas=True, chunk_size=32)
    text = ""
    for led, tile in MESHES:
        mesh = make_mesh(led, tile)
        if tile == 1:
            route, opts = led_shard.prepare_led_sharded(frames, geom, cfg, mesh, **kw)

            def sweep():
                return led_shard._sharded_sweep(mesh, route, opts=opts)
        else:
            route, opts, s = tile_shard.prepare_tile_sharded(frames, geom, cfg, mesh, **kw)

            def sweep():
                return tile_shard._tile_sweep(mesh, route, opts=opts, s=s)
        line = {"mesh": [led, tile], "enqueue_ms_per_sweep": host_us(sweep, 20) / 1e3}
        t0 = time.perf_counter()
        for _ in range(20):
            sweep()
        torch.cuda.synchronize()
        line["wall_ms_per_sweep"] = (time.perf_counter() - t0) / 20 * 1e3
        if (led, tile) == (4, 1):
            ranks = [(li, 0) for li in range(led)]
            out = [route.increments(route.obj[li][ti], route.pupil[li][ti],
                                    *(g[li][ti] for g in route.inputs), c=0) for li, ti in ranks]
            o, pc = route.obj[0][0], route.pupil[0][0]
            sc, amps, starts, valid, scratch = (g[0][0] for g in route.inputs)
            k3_out = kernels.k3_outputs(o, pc)

            def k3():
                kernels.chunk_increments_into(
                    o, pc, sc, amps[0], starts[0], valid[0], out=k3_out, scratch=scratch,
                    stream=kernels._current_stream(o.device), lo=route.lo, eps=opts.eps,
                    delta1=opts.delta1, delta2=opts.delta2, collect_metrics=True,
                    dft_precision=opts.dft_precision)

            d, v, m = ([x[i] for x in out] for i in range(3))

            def consensus():
                kernels.consensus_led(o, pc, d, v, [x[0] for x in m], [x[1] for x in m],
                                      scratch=route.scratch[mesh.home])

            line["k3_enqueue_us_per_call"] = host_us(k3, 200)
            line["consensus_led_enqueue_us_per_call"] = host_us(consensus, 200)
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(10):
                sweep()
            prof.disable()
            torch.cuda.synchronize()
            sio = io.StringIO()
            pstats.Stats(prof, stream=sio).sort_stats("tottime").print_stats(25)
            text = sio.getvalue()
        print(json.dumps({**line, "gpu": smi}), flush=True)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
