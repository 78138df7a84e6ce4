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
   over both axes forms the pupil consensus.

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
from .led_shard import (
    _as_complex,
    _chunk_increments,
    _wire_dtype,
    check_route,
    initial_grids,
    pipelined_chunks,
    psum_metrics,
    result_from,
    run_sweeps,
    sharded_options,
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


def _tile_chunk_increments(mesh: Mesh, obj_local, pupil, support, amps, starts_rel, mask,
                           *, opts: EPRYOptions, s: int):
    """Every rank's LOCAL increments for one tile-sharded chunk, on grids.

    Forward halo from the given state (the total bytes are independent of the
    hop count: Np rows either way), then the per-LED increments on the
    extended block. Returns grids ``(d_ext, v, mets)``: the halo-extended
    object increment (f32 planes on the kernel route, complex on the eager
    route), the pupil numerator WITHOUT the 1/max|O| factor, the metric
    partials.
    """
    n_tile = mesh.shape["tile"]
    parts = [obj_local]
    for j, _, rows in _halo_hops(opts.np_size, s):
        fwd = [((i + j) % n_tile, i) for i in range(n_tile)]
        parts.append(mesh.ppermute(mesh.map(lambda o: o[:rows], obj_local), "tile", fwd))
    ext = mesh.map(lambda *p: torch.cat(p, dim=0), *parts)      # (S+Np, Nlarge)
    return unzip(mesh.map(
        lambda e, p, sup, a, st, m: _chunk_increments(e, p, sup, a, st, m, opts=opts),
        ext, pupil, support, amps, starts_rel, mask), 3)


def _tile_consensus_apply(mesh: Mesh, obj_local, pupil, d_ext, v, mets, *,
                          opts: EPRYOptions, s: int):
    """Apply one chunk's consensus on the row-sharded spectrum, on grids.

    Object psum over ``led`` → reverse halo (increments in halo rows belong
    to the following tiles) → add → ``pmax`` over ``tile`` → pupil consensus.
    ``comm_precision='bf16'`` (kernel route) halves the psum and reverse-halo
    payloads; sums accumulate in f32.
    """
    n_tile = mesh.shape["tile"]
    wire = _wire_dtype(opts)
    d_ext = mesh.psum(d_ext, "led", wire_dtype=wire)
    d_ext = mesh.map(_as_complex, d_ext, obj_local)

    # Reverse halo: hop j returns halo slab [lo, lo+rows) to tile i+j, where
    # it lands on that tile's first rows (the mirror of the forward halo).
    d_local = mesh.map(lambda d: d[:s], d_ext)
    for j, lo, rows in _halo_hops(opts.np_size, s):
        slab = mesh.map(lambda d: d[s + lo:s + lo + rows], d_ext)
        bwd = [(i, (i + j) % n_tile) for i in range(n_tile)]
        if wire is not None:
            back = mesh.ppermute(
                mesh.map(lambda x: torch.stack([x.real, x.imag]).to(wire), slab), "tile", bwd)
            back = mesh.map(lambda b, o: torch.complex(b[0].float(), b[1].float()).to(o.dtype),
                            back, obj_local)
        else:
            back = mesh.ppermute(slab, "tile", bwd)
        d_local = mesh.map(lambda d, b: torch.cat([d[:rows] + b, d[rows:]], dim=0),
                           d_local, back)
    obj_local = mesh.map(torch.add, obj_local, d_local)

    omax = mesh.pmax(mesh.map(lambda o: torch.max(torch.abs(o)), obj_local), "tile")
    v = mesh.psum(v, ("led", "tile"), wire_dtype=wire)
    pupil = mesh.map(lambda p, vv, m: p + opts.pupil_step_scale * _as_complex(vv, p) / m,
                     pupil, v, omax)
    return obj_local, pupil, psum_metrics(mesh, mets, ("led", "tile"))


def _tile_sweep(mesh: Mesh, obj_local, pupil, support, amps, starts_rel, mask, *,
                opts: EPRYOptions, s: int):
    """One sweep over grids: chunks in order, each with its own halo exchange
    and consensus round; ``opts.stale_consensus`` as in ``led_shard``."""
    state = {"obj": obj_local, "pupil": pupil, "mets": 0}

    def increments(c):
        pick = [mesh.map(lambda t: t[c], g) for g in (amps, starts_rel, mask)]
        return _tile_chunk_increments(mesh, state["obj"], state["pupil"], support, *pick,
                                      opts=opts, s=s)

    def apply(inc):
        state["obj"], state["pupil"], mets = _tile_consensus_apply(
            mesh, state["obj"], state["pupil"], *inc, opts=opts, s=s)
        state["mets"] = state["mets"] + mesh.local(mets)

    pipelined_chunks(mesh.local(amps).shape[0], increments, apply, opts.stale_consensus)
    return state["obj"], state["pupil"], state["mets"]


def prepare_tile_sharded(images, geom: LEDGeometry, cfg: FPMConfig, mesh: Mesh,
                         iterations: int | None = None, dtype=None,
                         initial_state: tuple | None = None, **opt_overrides):
    """Per-rank input grids, the options and the tile height of
    :func:`reconstruct_tile_sharded`: ``((obj_local, pupil, support, amps,
    starts_rel, mask), opts, s)``. Rank ``(li, ti)`` holds spectrum rows
    ``[ti·s, (ti+1)·s)`` and, per chunk, its workset of the partition with
    patch starts relative to row ``ti·s``."""
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
    return (obj_local, mesh.replicate(pupil), mesh.replicate(support),
            amps_w, starts_w, mask_w), opts, s


def _fetch(mesh: Mesh, obj_local) -> torch.Tensor:
    """The full spectrum on this process's first device: the row tiles of
    the first ``led`` group, gathered in tile order from whichever process
    holds them, so that every process returns the same global result (as
    ``fpm_tpu.parallel.tile_shard._fetch`` all-gathers its rows)."""
    return torch.cat(mesh.gather(obj_local)[0], dim=0)


def reconstruct_tile_sharded(images, geom: LEDGeometry, cfg: FPMConfig, mesh: Mesh,
                             iterations: int | None = None, dtype=None,
                             initial_state: tuple | None = None,
                             **opt_overrides) -> ReconResult:
    """Reconstruction with the spectrum row-sharded over the mesh's ``tile``
    axis; the ``led`` axis splits each tile's owned LEDs. ``initial_state`` is
    an optional ``(obj_f_centered, pupil)`` pair (complex arrays or planes,
    of either package) to resume from."""
    (obj_local, pupil, support, amps, starts_rel, mask), opts, s = prepare_tile_sharded(
        images, geom, cfg, mesh, iterations=iterations, dtype=dtype,
        initial_state=initial_state, **opt_overrides)

    def sweep(o, p):
        return _tile_sweep(mesh, o, p, support, amps, starts_rel, mask, opts=opts, s=s)

    obj_local, pupil, metrics = run_sweeps(sweep, obj_local, pupil, opts.iterations)
    return result_from(_fetch(mesh, obj_local), mesh.local(pupil), metrics)
