"""Spectrum-tile spatial parallelism with halo exchange: the port of
``fpm_tpu.parallel.tile_shard``.

The spectrum is row-sharded over the ``tile`` axis of the mesh; per chunk:

1. **Forward halo** — every tile receives (``ppermute``) the ``Np`` rows
   following its block, forming an extended ``(S+Np, Nlarge)`` block so that
   any LED sub-aperture whose rows straddle tile boundaries is cropped
   locally. One hop when the tile height ``S`` ≥ ``Np``; ``ceil(Np/S)`` hops
   when the spectrum is split finer than a patch.
2. **Owner computes** — LEDs are partitioned host-side by the tile that owns
   their patch's first row and split across the ``led`` axis
   (:func:`partition_leds_by_tile`); per-rank worksets are padded and masked.
   The increments on the extended block come from kernel K3
   (``ops.kernels.fused_chunk_increments`` with block-relative starts) or, on
   the CPU parity route, eager ops.
3. **Reverse halo** — increments that landed in a rank's halo rows go back
   to the owner tiles and are added.
4. **Collectives** — ``psum`` over ``led`` reconciles the object increments,
   ``pmax`` over ``tile`` gives the global ``max|O|`` (the reference's
   ``cv::minMaxLoc`` over the full spectrum, fpmMain.cpp:467), and ``psum``
   over both axes forms the pupil consensus. The collectives gather the
   payloads and each card's consensus kernels (``ops.kernels.
   consensus_tile_object`` and ``consensus_tile_pupil``, around the pmax)
   reduce and apply them; their plain versions on the CPU and on the complex
   route.

Chunk membership is that of ``models.epry.chunk_schedule``, so the sweep
equals the single-device chunked sweep up to summation order. Functions take
grids of per-rank tensors (``parallel.mesh``) and run this process's ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import FPMConfig
from ..geometry import LEDGeometry
from ..models.epry import (
    EPRYOptions,
    ReconResult,
    _sorted_device_inputs,
    effective_chunk_size,
)
from .graph import run_sweeps
from .led_shard import (
    ComplexRoute,
    _wire_dtype,
    back_to_start,
    check_route,
    initial_grids,
    issue_metrics,
    next_slot,
    parity_buffer,
    pipelined_chunks,
    result_from,
    route_for,
    set_state,
    sharded_options,
    start_state,
    sweep_outputs,
)
from .mesh import Mesh, unzip


def partition_leds_by_tile(geom: LEDGeometry, n_large: int, n_tile: int, n_led: int,
                           np_size: int, chunk_size: int = 0,
                           chunk_assign: str = "strided"):
    """Host-side static partition of the LED schedule into per-rank worksets.

    Chunk membership follows ``models.epry.chunk_schedule``
    (``n_chunks = ceil(K/chunk_size)``; ``chunk_size=0`` = one whole-sweep
    chunk): ``'strided'`` puts schedule position i into chunk
    ``i % n_chunks``; ``'contiguous'`` keeps NA-sorted runs together. Within a
    chunk, LEDs go to the tile owning their patch's first row, round-robined
    over the ``led`` slots.

    Returns (idx, s): schedule positions shaped
    (n_chunks, n_led, n_tile, k_max), padded with -1, and the tile height.
    """
    s = n_large // n_tile
    if s * n_tile != n_large:
        raise ValueError(f"tile count {n_tile} must divide Nlarge={n_large}")
    if n_tile > 1 and np_size > n_large - s:
        # The Np-row halo must come entirely from OTHER tiles; past this
        # point a tile would wrap around to its own rows. (n_tile=1 is the
        # degenerate no-sharding case: the halo is never read.)
        raise ValueError(
            f"patch size {np_size} > Nlarge - tile height = {n_large - s}: "
            f"the halo would wrap around the {n_tile}-tile ring")
    order = geom.schedule
    k = len(order)
    c = chunk_size if chunk_size > 0 else k
    n_chunks = -(-k // c)
    owners = geom.crop_start[order, 0] // s
    if chunk_assign == "strided" and n_chunks > 1:
        chunk_of = np.arange(k) % n_chunks
    else:
        chunk_of = np.arange(k) // c
    worksets = [[[[] for _ in range(n_tile)] for _ in range(n_led)]
                for _ in range(n_chunks)]
    counters = np.zeros((n_chunks, n_tile), dtype=np.int64)
    for pos_i, owner in enumerate(owners):
        ci = chunk_of[pos_i]
        worksets[ci][counters[ci, owner] % n_led][owner].append(pos_i)
        counters[ci, owner] += 1
    k_max = max(1, max(len(w) for ch in worksets for row in ch for w in row))
    idx = -np.ones((n_chunks, n_led, n_tile, k_max), dtype=np.int64)
    for ci in range(n_chunks):
        for li in range(n_led):
            for ti in range(n_tile):
                w = worksets[ci][li][ti]
                idx[ci, li, ti, :len(w)] = w
    return idx, s


def _halo_hops(np_size: int, s: int):
    """(hop j, first halo row, rows) of the multi-hop halo: hop j moves the
    slab [lo, lo+rows) of the Np halo rows between tiles i and i+j."""
    return [(j, lo, min(s, np_size - lo))
            for j, lo in enumerate(range(0, np_size, s), start=1)]


def _slab_like(route: ComplexRoute, like, rows: int, wire):
    """A reverse-halo slab as fpm_tpu's ppermute carries it (for the
    counts): ``rows`` rows of the state ``like``, on the wire as (2, rows,
    NL) planes of its dtype."""
    x = like.to("meta")[..., :rows, :]
    if wire is None:
        return x
    return torch.empty((2, *x.shape[-2:]), dtype=wire, device="meta")


def _tile_sweep(mesh: Mesh, route: ComplexRoute, *, opts: EPRYOptions, s: int, bufs=None):
    """One sweep: chunks in order, each with its own halo exchange and
    consensus round; ``opts.stale_consensus`` and ``bufs`` (write only into
    its buffers) as in ``led_shard``. Updates ``route``'s state grids (each
    rank's row tile) and returns the sweep's (2,) metric sums.

    Per chunk: the forward halo (on the mesh's halo lane, from the state
    after the previous chunk's object step; the total bytes are independent
    of the hop count: Np rows either way), then each rank's increments on
    its extended (S+Np, Nlarge) block; the collectives gather the payloads:
    object increments over ``led`` (with the groups of the tiles whose halo
    rows each card reads), pupil increments and metrics over both axes; then
    on each card one object step for the tiles it holds (``ops.kernels.
    consensus_tile_object``: psum over ``led``, the reverse halo — the
    increments in tile i−j's halo rows belong to tile i's first rows —,
    the add, the local max|O|), the ``pmax`` of max|O| over ``tile``, and
    one pupil step (``consensus_tile_pupil``). The reverse halo's slabs
    travel with the object increments; its ``ppermute`` is counted and
    logged as fpm_tpu's. ``comm_precision='bf16'`` (kernel route) halves the
    psum and reverse-halo payloads; sums accumulate in f32.
    """
    n_led, n_tile = mesh.shape["led"], mesh.shape["tile"]
    wire = _wire_dtype(opts)
    hops = _halo_hops(opts.np_size, s)
    every = [(li, ti) for li in range(n_led) for ti in range(n_tile)]
    state = {"object": (), "pupil": (), "mets": None}
    cards = mesh.cards()
    tiles = {card: sorted({ti for _, ti in ranks}) for card, ranks in cards}
    # The led groups each card reads: its tiles' and, for each hop j, tile i−j's.
    needs = {card: [(li, (ti - j) % n_tile) for ti in tiles[card] for j in range(len(hops) + 1)
                    for li in range(n_led)] for card, _ in cards}
    real = route.opts.rdtype
    start_state(mesh, route, bufs)
    mesh.begin_sweep(route.obj, route.pupil, bufs=bufs, in_place=route.in_place)

    def increments(c):
        parts, halo_steps = [route.obj], []
        for j, _, rows in hops:
            fwd = [((i + j) % n_tile, i) for i in range(n_tile)]
            halo = mesh.ppermute(mesh.map(lambda o: o[..., :rows, :], route.obj), "tile", fwd,
                                 lane="halo", chunk=c, after=state["object"],
                                 what="forward halo", wait=False)
            parts.append(halo.result())
            halo_steps.append(halo.step)

        def extended(li, ti):                                    # (S+Np, Nlarge)
            own = route.obj[li][ti]
            rows = sum(p[li][ti].shape[-2] for p in parts)
            return own.new_empty((*own.shape[:-2], rows, own.shape[-1]))

        exts = sweep_outputs(mesh, bufs, ("extended block",), extended)
        outs = sweep_outputs(mesh, bufs, ("increments", c % 2), lambda li, ti: route.increments_out(
            exts[li][ti], route.pupil[li][ti]))

        def one(*args):
            k = len(parts)
            ext = torch.cat(args[:k], dim=-2, out=args[k])
            return route.increments(ext, *args[k + 1:-1], c=c, out=args[-1])

        out, steps = mesh.each(c, "increments", one, *parts, exts, route.pupil, *route.inputs,
                               outs, waits=[*halo_steps, *state["pupil"]])
        return (*unzip(out, 3), steps)

    def reduce(c, inc):
        d, v, mets, steps = inc
        return (mesh.collect(d, "led", wire, needs=needs, chunk=c, after=steps,
                             what="object increments"),
                mesh.collect(v, ("led", "tile"), wire, count_like=route.pupil_payload,
                             chunk=c, after=steps, what="pupil increments"),
                *issue_metrics(mesh, mets, ("led", "tile"), c, steps))

    def apply(c, red):
        pd, pv, *pm = red
        d = pd.result()
        like = mesh.local(route.obj)
        after = [pd.step] + [mesh.carried("ppermute", "tile", _slab_like(route, like, rows, wire),
                                          chunk=c, after=[pd.step], what="reverse halo")
                             for _, _, rows in hops]
        local_max, obj_steps = mesh.grid(lambda li, ti: None), []
        for card, ranks in cards:
            with mesh.on_card(c, card, "consensus object", after) as idx:
                held = [[r for r in ranks if r[1] == ti] for ti in tiles[card]]
                blocks = [(route.obj[own[0][0]][own[0][1]],
                           [d[card][(li, ti)] for li in range(n_led)],
                           [[d[card][(li, (ti - j) % n_tile)] for li in range(n_led)]
                            for j, _, _ in hops])
                          for ti, own in zip(tiles[card], held)]
                outs = route.consensus_tile_object(
                    card, blocks, s=s, hops=hops, out=None if bufs is None else [
                        (next_slot(bufs, ("obj", card, ti), c, route.n_chunks, o),
                         parity_buffer(bufs, ("omax", card, ti), c, (), real, card))
                        for ti, (o, _, _) in zip(tiles[card], blocks)])
                for own, (o, m) in zip(held, outs):
                    set_state(mesh, route.obj, own, o)
                    set_state(mesh, local_max, own, m)
            obj_steps.append(idx)
        state["object"] = obj_steps
        pmax = mesh.collect(local_max, "tile", op="pmax", chunk=c, after=obj_steps,
                            what="max|O|")
        maxima, v, mets = pmax.result(), pv.result(), [p.result() for p in pm]
        pupil_steps = []
        for card, ranks in cards:
            home = card == mesh.home
            li0, ti0 = ranks[0]
            with mesh.on_card(c, card, "consensus pupil",
                              [pmax.step, pv.step, *(p.step for p in pm)]) as idx:
                p_in = route.pupil[li0][ti0]
                p, omax, acc = route.consensus_tile_pupil(
                    card, p_in, [v[card][r] for r in every],
                    [maxima[card][(li0, ti)] for ti in range(n_tile)],
                    *([m[card][r] for r in every] for m in mets),
                    state["mets"] if home else None, metrics=home,
                    out=None if bufs is None else (
                        next_slot(bufs, ("pupil", card), c, route.n_chunks, p_in),
                        parity_buffer(bufs, ("omax", card), c, (), real, card),
                        parity_buffer(bufs, ("metrics", card), c, (2,), route.metrics_dtype,
                                      card) if home else None))
                set_state(mesh, route.pupil, ranks, p)
                set_state(mesh, route.omax, ranks, omax)
                if home:
                    state["mets"] = acc
            pupil_steps.append(idx)
        state["pupil"] = pupil_steps

    pipelined_chunks(route.n_chunks, increments, reduce, apply, opts.stale_consensus)
    back_to_start(mesh, route, bufs, route.n_chunks)
    mesh.end_sweep(route.obj, route.pupil, route.omax, tensors=[state["mets"]])
    return state["mets"]


def prepare_tile_sharded(images, geom: LEDGeometry, cfg: FPMConfig, mesh: Mesh,
                         iterations: int | None = None, dtype=None,
                         initial_state: tuple | None = None, **opt_overrides):
    """The route (``led_shard.route_for``), the options and the tile height
    of :func:`reconstruct_tile_sharded`: ``(route, opts, s)``. Rank ``(li,
    ti)`` holds spectrum rows ``[ti·s, (ti+1)·s)`` and, per chunk, its
    workset of the partition with patch starts relative to row ``ti·s``."""
    opts = sharded_options(cfg, iterations, dtype, opt_overrides)
    check_route(mesh, opts)
    n_led, n_tile = mesh.shape["led"], mesh.shape["tile"]
    k = len(geom.schedule)
    if opts.use_pallas:
        opts = dataclasses.replace(opts, chunk_size=effective_chunk_size(
            cfg.np_size, opts.chunk_size, k, True, "batched"))
    idx, s = partition_leds_by_tile(geom, cfg.n_large, n_tile, n_led, cfg.np_size,
                                    chunk_size=opts.chunk_size,
                                    chunk_assign=opts.chunk_assign)

    # Schedule-ordered inputs with one zero slot appended: index -1 (a padded
    # workset slot) picks it.
    amps_all, starts_all = _sorted_device_inputs(images, geom, opts.cdtype, "cpu")
    amps_pad = torch.cat([amps_all, torch.zeros_like(amps_all[:1])])
    starts_pad = np.concatenate([starts_all.numpy().astype(np.int64),
                                 np.zeros((1, 2), np.int64)])

    def workset(li, ti):
        sel = idx[:, li, ti]                                   # (n_chunks, k_max)
        live = sel >= 0
        st = starts_pad[sel]
        st[..., 0] -= np.where(live, ti * s, 0)
        dev = mesh.devices[li][ti]
        return (amps_pad[torch.from_numpy(sel)].to(dev),
                torch.from_numpy(st.astype(np.int32)).to(dev),
                torch.from_numpy(live).to(opts.rdtype).to(dev))

    amps_w, starts_w, mask_w = unzip(mesh.grid(workset), 3)
    obj_f, pupil, support = initial_grids(mesh, cfg, amps_pad[:k], opts, initial_state)
    obj_local = mesh.grid(lambda li, ti: obj_f[ti * s:(ti + 1) * s].to(mesh.devices[li][ti]))
    route = route_for(mesh, opts, obj_local, mesh.replicate(pupil), mesh.replicate(support),
                      amps_w, starts_w, mask_w, block_rows=s + cfg.np_size)
    return route, opts, s


def _fetch(mesh: Mesh, obj_local) -> torch.Tensor:
    """The full spectrum (or its planes) on this process's first device: the
    row tiles of the first ``led`` group, gathered in tile order from
    whichever process holds them, so that every process returns the same
    global result (as ``fpm_tpu.parallel.tile_shard._fetch`` all-gathers its
    rows)."""
    return torch.cat(mesh.gather(obj_local)[0], dim=-2)


def reconstruct_tile_sharded(images, geom: LEDGeometry, cfg: FPMConfig, mesh: Mesh,
                             iterations: int | None = None, dtype=None,
                             initial_state: tuple | None = None,
                             **opt_overrides) -> ReconResult:
    """Reconstruction with the spectrum row-sharded over the mesh's ``tile``
    axis; the ``led`` axis splits each tile's owned LEDs. ``initial_state`` is
    an optional ``(obj_f_centered, pupil)`` pair (complex arrays or planes,
    of either package) to resume from. Where every rank of this process is a
    CUDA rank and the transport between processes, if any, is NCCL, one
    sweep is captured into a CUDA graph and replayed
    (``parallel.graph.replays``); else the host walks the chunk loop."""
    route, opts, s = prepare_tile_sharded(images, geom, cfg, mesh, iterations=iterations,
                                          dtype=dtype, initial_state=initial_state,
                                          **opt_overrides)
    metrics, replay = run_sweeps(mesh, route, lambda bufs: _tile_sweep(
        mesh, route, opts=opts, s=s, bufs=bufs), opts.iterations)
    return result_from(*route.final_state(mesh, _fetch(mesh, route.obj)), metrics, replay)
