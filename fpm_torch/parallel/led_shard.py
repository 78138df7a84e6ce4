"""LED-batch data parallelism: the port of ``fpm_tpu.parallel.led_shard``.

The chunked Gauss–Seidel-over-Jacobi sweep (``models.epry.sweep_batched``)
computes every LED update of a chunk from the chunk-start state, so the
within-chunk LED axis is embarrassingly parallel: it is split over the
``led`` axis of the mesh. Every rank holds the whole spectrum and pupil,
computes the increments of its slice of the chunk (kernel K3,
``ops.kernels.fused_chunk_increments``, or eager ops on ``torch.fft`` for the
complex128 parity runs on the CPU), and the ranks reconcile with one ``psum``
per chunk for the object and one for the pupil consensus. Chunks are padded
with masked dummy frames to a multiple of the ``led`` axis.

This module's functions take *grids* of per-rank tensors and loop over the
ranks of this process (``parallel.mesh``; under ``torch.distributed`` every
process runs the same program on its own ranks, ``parallel.multihost``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import FPMConfig
from ..geometry import LEDGeometry, pupil_support
from ..models.epry import (
    EPRYOptions,
    ReconResult,
    _amp_replace,
    _dtype_name,
    _from_planes,
    _host_starts,
    _object_delta,
    _pupil_delta,
    _sorted_device_inputs,
    _to_planes,
    chunk_permute,
    effective_chunk_size,
    init_traced,
    state_from_numpy,
    state_to_numpy,
)
from ..ops import crop_patch, fft2, fftshift2d, ifft2, ifftshift2d, kernels, paste_patch_add
from .mesh import Mesh, make_mesh, unzip


def _chunk_increments(block, pupil, support, amps, starts, mask, *, opts: EPRYOptions):
    """One rank's LOCAL increments for one chunk from the given state.

    ``block`` is the rank's spectrum block: the whole spectrum here, a
    halo-extended row tile in ``tile_shard`` (``starts`` relative to it).
    Returns ``(d, v, mets)``: the object increment window-added into a zero
    block, the pupil EPRY numerator sum WITHOUT the 1/max|O| factor (a scalar
    divide that commutes with psum and needs the post-consensus spectrum),
    and the metric partials. The kernel route returns f32 planes (K3), the
    eager route complex tensors. Separate from consensus and apply so that
    the stale sweep can compute chunk c+1 before chunk c's consensus lands.
    """
    if opts.use_pallas:
        return kernels.fused_chunk_increments(
            _to_planes(block), _to_planes(pupil), support.real.to(torch.float32),
            amps.to(torch.float32), starts.reshape(-1).to(torch.int32),
            (mask > 0).to(torch.int32),
            np_size=opts.np_size, n_rows=block.shape[0], n_cols=block.shape[1],
            delta1=opts.delta1, delta2=opts.delta2, eps=opts.eps,
            pupil_radius=opts.pupil_radius, collect_metrics=opts.collect_metrics,
            dft_precision=opts.dft_precision)

    np_sz = opts.np_size
    m = mask[:, None, None]
    starts = _host_starts(starts)
    objf_crop = fftshift2d(torch.stack([crop_patch(block, s, np_sz) for s in starts]))
    objf_crop_p = objf_crop * pupil
    obj_crop_p = ifft2(objf_crop_p)
    diff = fft2(_amp_replace(obj_crop_p, amps, opts.eps)) - objf_crop_p

    d_obj = fftshift2d(_object_delta(diff, pupil, opts.delta2) * m)
    d_full = torch.zeros_like(block)
    for d, s in zip(d_obj, starts):
        paste_patch_add(d_full, d, s)
    # omax=1: the true 1/max|O| factor is applied after the consensus.
    v = torch.sum(_pupil_delta(diff, objf_crop, 1.0, support, opts.delta1) * m, dim=0)
    if opts.collect_metrics:
        mets = torch.stack([torch.sum(((amps - torch.abs(obj_crop_p)) * m) ** 2),
                            torch.sum(torch.abs(d_obj) ** 2)])
    else:
        mets = torch.zeros(2, dtype=amps.dtype, device=amps.device)
    return d_full, v, mets


def _wire_dtype(opts: EPRYOptions):
    """bf16 consensus payloads (kernel route's f32 planes only), or None."""
    return torch.bfloat16 if opts.comm_precision == "bf16" else None


def psum_metrics(mesh: Mesh, mets, axes):
    """The two scalar metric psums of a chunk; a grid of (2,) tensors."""
    resid = mesh.psum(mesh.map(lambda m: m[0], mets), axes)
    upd = mesh.psum(mesh.map(lambda m: m[1], mets), axes)
    return mesh.map(lambda r, u: torch.stack([r, u]), resid, upd)


def _consensus_psum(mesh: Mesh, d, v, mets, *, opts: EPRYOptions):
    """The per-chunk all-reduces over the LED axis, on grids.
    ``comm_precision='bf16'`` halves the object-increment and
    pupil-numerator payloads; the sums accumulate in f32."""
    wire = _wire_dtype(opts)
    return (mesh.psum(d, "led", wire_dtype=wire), mesh.psum(v, "led", wire_dtype=wire),
            psum_metrics(mesh, mets, "led"))


def _as_complex(x, like):
    """f32 planes of the kernel route → complex; complex passes through."""
    return x if x.is_complex() else _from_planes(x, like)


def _apply_consensus(obj_f, pupil, d, v, *, opts: EPRYOptions):
    """One rank: object add → global max|O| of the UPDATED spectrum → pupil add."""
    obj_f = obj_f + _as_complex(d, obj_f)
    omax = torch.max(torch.abs(obj_f))
    return obj_f, pupil + opts.pupil_step_scale * _as_complex(v, pupil) / omax


def pipelined_chunks(n_chunks: int, increments, apply, stale: bool):
    """Run ``apply(increments(c))`` for every chunk in order. With ``stale``
    (one-chunk-stale consensus) chunk c+1's increments are computed BEFORE
    chunk c's are applied: one chunk of Gauss–Seidel freshness given up so
    that a chunk's collectives do not depend on the next chunk's compute.
    (The order of compute and apply is what this fixes; nothing overlaps on
    streams yet.)"""
    if not stale:
        for c in range(n_chunks):
            apply(increments(c))
        return
    pending = increments(0)
    for c in range(1, n_chunks):
        nxt = increments(c)
        apply(pending)
        pending = nxt
    apply(pending)


def _sharded_sweep(mesh: Mesh, obj_f, pupil, support, amps, starts, mask, *,
                   opts: EPRYOptions):
    """One full sweep over grids: chunks in order, each chunk's LEDs split
    over the ``led`` axis. ``amps`` (n_chunks, C_local, Np, Np), ``starts``
    (n_chunks, C_local, 2) and ``mask`` (n_chunks, C_local) are each rank's
    slices. Returns the new grids and the sweep's (2,) metric sums."""
    state = {"obj_f": obj_f, "pupil": pupil, "mets": 0}

    def increments(c):
        return unzip(mesh.map(
            lambda o, p, s, a, st, m: _chunk_increments(o, p, s, a[c], st[c], m[c], opts=opts),
            state["obj_f"], state["pupil"], support, amps, starts, mask), 3)

    def apply(inc):
        d, v, mets = _consensus_psum(mesh, *inc, opts=opts)
        state["obj_f"], state["pupil"] = unzip(mesh.map(
            lambda o, p, dd, vv: _apply_consensus(o, p, dd, vv, opts=opts),
            state["obj_f"], state["pupil"], d, v), 2)
        state["mets"] = state["mets"] + mesh.local(mets)

    pipelined_chunks(mesh.local(amps).shape[0], increments, apply, opts.stale_consensus)
    return state["obj_f"], state["pupil"], state["mets"]


def check_route(mesh: Mesh, opts: EPRYOptions) -> None:
    """On CUDA ranks the sweep runs only through the kernels, as
    ``models.epry.reconstruct`` requires."""
    if not opts.use_pallas and any(d is not None and d.type == "cuda"
                                   for row in mesh.devices for d in row):
        raise ValueError(
            "on a CUDA device fpm_torch sweeps only through its CUDA kernels: "
            "pass use_pallas=True (CLI: --use-pallas)")


def sharded_options(cfg: FPMConfig, iterations, dtype, opt_overrides) -> EPRYOptions:
    """The batched-mode options of a sharded run."""
    return EPRYOptions.from_config(
        cfg, iterations=iterations if iterations is not None else cfg.iterations,
        dtype=_dtype_name(dtype or cfg.dtype), mode="batched", **opt_overrides)


def initial_grids(mesh: Mesh, cfg: FPMConfig, amps_sorted, opts: EPRYOptions, initial_state):
    """(obj_f, pupil, support) on this process's first device: the fresh
    init, or ``initial_state`` (complex arrays or planes, of either package)."""
    dev = mesh.home
    support_r = torch.as_tensor(pupil_support(cfg, centered=False), dtype=opts.rdtype,
                                device=dev)
    if initial_state is not None:
        obj_f, pupil = state_from_numpy(*initial_state, device=dev, dtype=opts.cdtype)
    else:
        obj_f, pupil = init_traced(amps_sorted.to(dev), support_r, opts)
    return obj_f, pupil, support_r.to(opts.cdtype)


def prepare_led_sharded(images, geom: LEDGeometry, cfg: FPMConfig, mesh: Mesh,
                        iterations: int | None = None, dtype=None,
                        initial_state: tuple | None = None, **opt_overrides):
    """Per-rank input grids and the options of :func:`reconstruct_led_sharded`.

    Chunks the schedule (``models.epry.chunk_schedule``) with the chunk
    rounded up to a multiple of the ``led`` axis
    (``effective_chunk_size(..., n_led)``, the function the CLI's fingerprint
    calls), and gives rank ``li`` the ``li``-th slice of every chunk.
    Returns ``((obj_f, pupil, support, amps, starts, mask), opts)``, all grids.
    """
    opts = sharded_options(cfg, iterations, dtype, opt_overrides)
    check_route(mesh, opts)
    n_led = mesh.shape["led"]
    amps, starts = _sorted_device_inputs(images, geom, opts.cdtype, "cpu")
    c_eff = effective_chunk_size(cfg.np_size, opts.chunk_size, amps.shape[0],
                                 opts.use_pallas, "batched", n_led=n_led)
    opts = dataclasses.replace(opts, chunk_size=c_eff)
    obj_f, pupil, support = initial_grids(mesh, cfg, amps, opts, initial_state)

    amps_c, starts_c, mask_c = chunk_permute(amps, starts, c_eff, opts.chunk_assign,
                                             opts.rdtype)
    c_local = amps_c.shape[1] // n_led

    def slice_of(t):
        return mesh.grid(lambda li, ti: t[:, li * c_local:(li + 1) * c_local]
                         .contiguous().to(mesh.devices[li][ti]))

    return (mesh.replicate(obj_f), mesh.replicate(pupil), mesh.replicate(support),
            slice_of(amps_c), slice_of(starts_c), slice_of(mask_c)), opts


def run_sweeps(sweep, obj_f, pupil, iterations: int):
    """``iterations`` sweeps of ``sweep(obj_f, pupil) -> (obj_f, pupil, mets)``;
    returns the final grids and the (iterations, 2) metrics array."""
    per_sweep = []
    for _ in range(iterations):
        obj_f, pupil, mets = sweep(obj_f, pupil)
        per_sweep.append(mets)
    metrics = (torch.stack(per_sweep).cpu().numpy() if per_sweep
               else np.zeros((0, 2), np.float64))
    return obj_f, pupil, metrics


def result_from(obj_f: torch.Tensor, pupil: torch.Tensor, metrics) -> ReconResult:
    """The :class:`ReconResult` of a full centered spectrum and a pupil."""
    obj_crop = ifft2(ifftshift2d(obj_f))
    obj_np, pupil_np = state_to_numpy(obj_f, pupil)
    return ReconResult(
        obj_crop=obj_crop.cpu().numpy(), obj_f_centered=obj_np, pupil=pupil_np,
        metrics={"data_residual": metrics[:, 0], "update_norm": metrics[:, 1]})


def reconstruct_led_sharded(images, geom: LEDGeometry, cfg: FPMConfig,
                            mesh: Mesh | None = None, iterations: int | None = None,
                            dtype=None, initial_state: tuple | None = None,
                            **opt_overrides) -> ReconResult:
    """Reconstruction with each chunk's LEDs split over the mesh's ``led`` axis.

    ``mesh`` defaults to one rank per visible CUDA device (and raises without
    one); pass ``make_mesh(..., devices=["cpu"] * n)`` to run on the CPU.
    ``initial_state`` is an optional ``(obj_f_centered, pupil)`` pair — complex
    arrays or (2, ...) planes, of either package — to resume from.
    """
    if mesh is None:
        mesh = make_mesh(tile=1)
    (obj_f, pupil, support, amps, starts, mask), opts = prepare_led_sharded(
        images, geom, cfg, mesh, iterations=iterations, dtype=dtype,
        initial_state=initial_state, **opt_overrides)

    def sweep(o, p):
        return _sharded_sweep(mesh, o, p, support, amps, starts, mask, opts=opts)

    obj_f, pupil, metrics = run_sweeps(sweep, obj_f, pupil, opts.iterations)
    # Every rank holds the whole spectrum, the same bits on every rank: each
    # process returns the global result from its own first rank.
    return result_from(mesh.local(obj_f), mesh.local(pupil), metrics)
