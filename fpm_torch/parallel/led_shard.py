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
A chunk is each rank's K3 on its own stream, then one consensus step per
card on the mesh's comm lane, after their events: the collectives gather
the payloads (``Mesh.collect``; between cards and processes they travel,
on one card nothing moves) and one launch reduces them in rank order and
applies them to the state the card's ranks share (``ops.kernels.
consensus_led``; its plain version on the CPU and on the complex route).
With ``stale_consensus`` chunk c's consensus runs while chunk c+1's K3 runs
(:func:`pipelined_chunks`). On the kernel route with complex64 state the
state stays in K3's operands for the whole run (:class:`PlanesRoute`) and
goes back to complex only for the result.

The sweep is a body over buffers: with none (the host loop: the CPU,
processes over gloo) every chunk makes fresh tensors; over
``parallel.graph``'s :class:`~fpm_torch.parallel.graph.SweepBuffers` it
writes only into tensors made at its first call (:func:`sweep_outputs`,
:func:`next_slot`; the transport's, ``parallel.multihost``), and
``parallel.graph`` captures it once into a CUDA graph where every rank of
the process is a CUDA rank and the processes, if several, exchange over
NCCL.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import FPMConfig
from ..geometry import LEDGeometry, pupil_support
from ..models.epry import (
    EPRYOptions,
    ReconResult,
    _amp_replace,
    _dtype_name,
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
from .graph import run_sweeps
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


class ComplexRoute:
    """A sharded run whose state is complex tensors: the eager route
    (``torch.fft``; the complex128 parity runs on the CPU) and the kernel
    route with complex128 state, which converts K3's operands on every
    chunk (:func:`_chunk_increments`). Holds the per-rank grids: the state
    (``obj``, ``pupil``, ``omax``: the last max|O|; after a chunk the ranks
    of one card hold one tensor of each, their tile's) and the inputs of
    every chunk (``inputs``: support, amps, starts, mask). Its consensus is
    the plain version of the kernels' (``ops.kernels.consensus_*_plain``)."""

    pupil_payload = None      # the pupil psum's payload as counted: the payload itself
    # Its consensus (PyTorch's ops on one card) cannot read another CUDA
    # card's payloads in place: between CUDA cards it keeps the copy route.
    in_place = False

    def __init__(self, opts: EPRYOptions, obj, pupil, support, amps, starts, mask):
        self.opts, self.obj, self.pupil, self.frame = opts, obj, pupil, pupil
        self.omax = [[None] * len(row) for row in obj]
        self.inputs = (support, amps, starts, mask)
        self.wire = _wire_dtype(opts)

    @property
    def n_chunks(self) -> int:
        return next(a.shape[0] for row in self.inputs[1] for a in row if a is not None)

    def increments(self, block, pupil, support, amps, starts, mask, *, c, out=None):
        return kernels._copied(out, _chunk_increments(block, pupil, support, amps[c], starts[c],
                                                      mask[c], opts=self.opts))

    def increments_out(self, block, pupil):
        """Buffers of :meth:`increments`' (d, v, mets) for ``block``: K3's
        planes on the kernel route, else complex like the state."""
        if not self.opts.use_pallas:
            return (torch.empty_like(block), torch.empty_like(pupil),
                    block.new_empty(2, dtype=self.opts.rdtype))
        n = self.opts.np_size
        return kernels._empty(block.device, (2, *block.shape), (2, n, n), (2,))

    @property
    def metrics_dtype(self):
        """The dtype of the metric payloads and of the sweep's sums."""
        return torch.float32 if self.opts.use_pallas else self.opts.rdtype

    def consensus_led(self, card, *args, out=None, **kw):
        return kernels._copied(out, kernels.consensus_led_plain(
            *args, wire=self.wire, scale=self.opts.pupil_step_scale, **kw))

    def consensus_tile_object(self, card, blocks, out=None, **kw):
        got = [kernels.consensus_tile_object_plain(o, ds, halos, wire=self.wire, **kw)
               for o, ds, halos in blocks]
        return got if out is None else [kernels._copied(o, g) for o, g in zip(out, got)]

    def consensus_tile_pupil(self, card, *args, out=None, **kw):
        return kernels._copied(out, kernels.consensus_tile_pupil_plain(
            *args, wire=self.wire, scale=self.opts.pupil_step_scale, **kw))

    def complex_state(self, obj, pupil, omax, frame):
        """The state of one rank as complex tensors (``obj``: its spectrum,
        or the whole spectrum gathered from the tiles)."""
        return obj, pupil

    def final_state(self, mesh: Mesh, obj):
        """:meth:`complex_state` of this process's first rank."""
        li, ti = mesh.local_ranks[0]
        return self.complex_state(obj, self.pupil[li][ti], self.omax[li][ti],
                                  self.frame[li][ti])


class PlanesRoute(ComplexRoute):
    """The kernel route with complex64 state, kept in K3's operands for the
    whole run (built once by :meth:`of`): the spectrum (block) as (2, R, C)
    float32 planes, the pupil as (2, b, b) planes of the centered NA bbox
    at offset ``lo``, and as inputs the bbox support, float32 amps, int32
    starts (n_chunks, 2C) and valid flags (n_chunks, C), and K3's scratch
    per rank. K3 runs through ``kernels.chunk_increments_into``, the
    consensus through ``kernels.consensus_*`` (the kernels on the card, with
    one :class:`~fpm_torch.ops.kernels.ConsensusScratch` a card); nothing is
    converted per chunk. The arithmetic is the complex route's on the same
    values, so the bits are (the plain versions: an add of planes is the add
    of complex64 numbers; max|O| is ``torch.abs`` of the complex spectrum;
    the pupil step divides the complex numerator by the real max as a
    complex division). The pupil payload is the bbox, counted as the whole
    Np×Np patch (fpm_tpu's psum payload); outside the bbox the pupil is the
    initial ``frame`` plus that division's zero (:meth:`complex_state`)."""

    @classmethod
    def of(cls, mesh: Mesh, opts: EPRYOptions, obj, pupil, support, amps, starts, mask,
           block_rows: int):
        n = opts.np_size
        b, lo = kernels.bbox_extent(n, opts.pupil_radius)
        frame = pupil

        def rank(li, ti):
            p_planes, sup = _to_planes(pupil[li][ti]), support[li][ti].real.to(torch.float32)
            pc, sc = kernels._pupil_to_bbox(p_planes, sup, n, b, lo)
            a = amps[li][ti].to(torch.float32).contiguous()
            st = starts[li][ti].reshape(a.shape[0], -1).to(torch.int32).contiguous()
            valid = (mask[li][ti] > 0).to(torch.int32).contiguous()
            o = _to_planes(obj[li][ti]).contiguous()
            scratch = None
            if o.is_cuda:
                kernels._check_cuda_operands(
                    o.new_empty((2, block_rows, o.shape[-1])), pc, sc, a[0], st[0],
                    n_slots=a.shape[1], valid=valid[0], square=False)
                scratch = kernels.k3_scratch(a.shape[1], b, o.device)
            return o, pc, sc, a, st, valid, scratch

        o, pc, sc, a, st, valid, scratch = unzip(mesh.grid(rank), 7)
        route = cls(opts, o, pc, sc, a, st, valid)
        route.inputs += (scratch,)
        route.frame, route.b, route.lo = frame, b, lo
        route.pupil_payload = torch.empty((2, n, n), dtype=torch.float32, device="meta")
        route.scratch = {card: kernels.ConsensusScratch(card)
                         for card, _ in mesh.cards() if card.type == "cuda"}
        return route

    in_place = True           # the consensus kernels read their peers' payloads

    def increments(self, block, pc, sc, amps, starts, valid, scratch, *, c, out=None):
        o = self.opts
        return kernels.chunk_increments_into(
            block, pc, sc, amps[c], starts[c], valid[c], out=out or self.increments_out(block, pc),
            scratch=scratch, stream=kernels._current_stream(block.device)
            if block.is_cuda else None, lo=self.lo, eps=o.eps, delta1=o.delta1,
            delta2=o.delta2, collect_metrics=o.collect_metrics, dft_precision=o.dft_precision)

    def increments_out(self, block, pc):
        return kernels.k3_outputs(block, pc)

    def consensus_led(self, card, *args, **kw):
        return kernels.consensus_led(*args, wire=self.wire, scale=self.opts.pupil_step_scale,
                                     scratch=self.scratch.get(card), **kw)

    def consensus_tile_object(self, card, blocks, **kw):
        return kernels.consensus_tile_object(blocks, wire=self.wire,
                                             scratch=self.scratch.get(card), **kw)

    def consensus_tile_pupil(self, card, *args, **kw):
        return kernels.consensus_tile_pupil(*args, wire=self.wire,
                                            scale=self.opts.pupil_step_scale, **kw)

    def _window(self, x):
        return x[..., self.lo:self.lo + self.b, self.lo:self.lo + self.b]

    def complex_state(self, obj, pc, omax, frame):
        """(spectrum, pupil) as complex64, the pupil in the DC-at-corner
        frame: the initial ``frame`` (after a chunk plus the pupil step's
        zero, ``0 / max|O|``, that the complex route adds outside the bbox)
        with the bbox put back."""
        half = self.opts.np_size // 2
        if omax is not None:
            frame = frame + self.opts.pupil_step_scale * torch.zeros_like(frame) / omax
        centered = torch.roll(frame, (half, half), dims=(0, 1))
        self._window(centered).copy_(torch.complex(pc[0], pc[1]))
        return (torch.complex(obj[0], obj[1]),
                torch.roll(centered, (-half, -half), dims=(0, 1)))


def route_for(mesh: Mesh, opts: EPRYOptions, obj, pupil, support, amps, starts, mask,
              block_rows: int) -> ComplexRoute:
    """The route of a sharded run: the state kept in K3's operands on the
    kernel route with complex64 state, complex tensors otherwise."""
    if opts.use_pallas and opts.dtype == "complex64":
        return PlanesRoute.of(mesh, opts, obj, pupil, support, amps, starts, mask, block_rows)
    return ComplexRoute(opts, obj, pupil, support, amps, starts, mask)


def issue_metrics(mesh: Mesh, mets, axes, c, after):
    """The two scalar metric psums of chunk ``c``, gathered for the
    consensus (pending)."""
    return tuple(mesh.collect(mesh.map(lambda m: m[i], mets), axes, chunk=c, after=after,
                              what=what)
                 for i, what in enumerate(("residual", "update norm")))


def set_state(mesh: Mesh, grid, ranks, value) -> None:
    """``value``, made on a card's comm lane, as the state of ``ranks``."""
    mesh.share(value, ranks)
    for li, ti in ranks:
        grid[li][ti] = value


def sweep_outputs(mesh: Mesh, bufs, key, make):
    """The grid of each local rank's buffers under ``(*key, rank)``, made
    by ``make(li, ti)``, or of None without ``bufs`` (fresh tensors)."""
    if bufs is None:
        return mesh.grid(lambda li, ti: None)
    return mesh.grid(lambda li, ti: bufs.get((*key, (li, ti)), lambda: make(li, ti)))


# A sweep over buffers made once keeps three slots of each state (spectrum
# rows of a tile, pupil) on every card: slot 0 holds the state the sweep
# starts from and ends in, and chunk c's consensus writes slot
# :func:`state_slot` (c): never the slot the previous chunk wrote, which
# under the stale consensus chunk c+1's K3 reads meanwhile. Each chunk's
# K3 outputs, max|O| and metric sums have a set for each chunk parity, for
# the same reason.


def state_slot(c: int, n_chunks: int) -> int:
    """The slot chunk ``c``'s consensus writes: the last chunk slot 0,
    the chunks before it 1, 0, 1, ... back to chunk 0, which writes slot 2
    where that would be slot 0, the one it reads (an odd chunk count); a
    sweep of one chunk writes slot 1 and is copied back
    (:func:`back_to_start`)."""
    slot = (n_chunks - 1 - c) % 2
    if c == 0 and slot == 0:
        return 2 if n_chunks > 1 else 1
    return slot


def start_state(mesh: Mesh, route, bufs) -> None:
    """Over ``bufs``: every rank reads its card's slot 0 of its tile's
    spectrum rows and of the pupil (at the first call the state of the
    card's first rank of the tile; the ranks' states are equal)."""
    if bufs is None:
        return
    for card, ranks in mesh.cards():
        for li, ti in ranks:
            first = next(r for r in ranks if r[1] == ti)
            route.obj[li][ti] = bufs.get(("obj", card, ti, 0),
                                         lambda f=first: route.obj[f[0]][f[1]])
            route.pupil[li][ti] = bufs.get(("pupil", card, 0),
                                           lambda f=ranks[0]: route.pupil[f[0]][f[1]])


def next_slot(bufs, key, c: int, n_chunks: int, like):
    """Over ``bufs``: the slot of the state under ``key`` (made like
    ``like``) that chunk ``c`` of ``n_chunks`` writes (:func:`state_slot`)."""
    return bufs.get((*key, state_slot(c, n_chunks)), lambda: torch.empty_like(like))


def parity_buffer(bufs, key, c: int, shape, dtype, device):
    """Over ``bufs``: the buffer under ``key`` of chunk ``c``'s parity."""
    return bufs.get((*key, c % 2), lambda: torch.empty(shape, dtype=dtype, device=device))


def back_to_start(mesh: Mesh, route, bufs, n_chunks: int) -> None:
    """Over ``bufs``, after a sweep of one chunk: each card's state copied
    from slot 1 back into slot 0 on its comm lane (after its consensus),
    and the ranks pointed at it."""
    if bufs is None or n_chunks > 1:
        return
    for card, ranks in mesh.cards():
        with mesh.on_card(None, card, "state back to slot 0"):
            for grid, key in ((route.obj, lambda ti: ("obj", card, ti)),
                              (route.pupil, lambda ti: ("pupil", card))):
                copied = set()
                for li, ti in ranks:
                    start = bufs.get((*key(ti), 0), None)
                    if id(start) not in copied:
                        start.copy_(grid[li][ti])
                        copied.add(id(start))
                    grid[li][ti] = start


def pipelined_chunks(n_chunks: int, increments, reduce, apply, stale: bool):
    """The chunk loop of ``fpm_tpu``'s scan body, in the order its work is
    enqueued. Fresh: ``increments(c)``, ``reduce(c, ·)`` (the consensus
    collectives, started), ``apply(c, ·)``. With ``stale`` (one-chunk-stale
    consensus) ``reduce(c)`` is enqueued first, then ``increments(c+1)``,
    which reads the state after ``apply(c−1)`` only, then ``apply(c)``,
    which waits on ``reduce(c)``: chunk c's collectives and consensus and
    chunk c+1's K3 depend on nothing of each other, so on the card they run
    at once (``parallel.mesh``: ranks and the comm lane on streams of their
    own)."""
    if not stale:
        for c in range(n_chunks):
            apply(c, reduce(c, increments(c)))
        return
    inc = increments(0)
    for c in range(n_chunks):
        red = reduce(c, inc)
        if c + 1 < n_chunks:
            inc = increments(c + 1)
        apply(c, red)


def _sharded_sweep(mesh: Mesh, route: ComplexRoute, *, opts: EPRYOptions, bufs=None):
    """One full sweep: chunks in order, each chunk's LEDs split over the
    ``led`` axis (each rank's inputs hold its slices). Updates ``route``'s
    state grids and returns the sweep's (2,) metric sums. A chunk's K3
    waits on the consensus step that made the state it reads. ``bufs``
    (``parallel.graph.SweepBuffers``): write only into its buffers."""
    wire = _wire_dtype(opts)
    group = [(li, 0) for li in range(mesh.shape["led"])]
    state = {"steps": (), "mets": None}
    start_state(mesh, route, bufs)
    mesh.begin_sweep(route.obj, route.pupil, bufs=bufs, in_place=route.in_place)

    def increments(c):
        outs = sweep_outputs(mesh, bufs, ("increments", c % 2), lambda li, ti: route.increments_out(
            route.obj[li][ti], route.pupil[li][ti]))
        out, steps = mesh.each(c, "increments", lambda *a: route.increments(*a[:-1], c=c,
                                                                          out=a[-1]),
                               route.obj, route.pupil, *route.inputs, outs, waits=state["steps"])
        return (*unzip(out, 3), steps)

    def reduce(c, inc):
        d, v, mets, steps = inc
        return (mesh.collect(d, "led", wire, chunk=c, after=steps, what="object increments"),
                mesh.collect(v, "led", wire, count_like=route.pupil_payload, chunk=c,
                             after=steps, what="pupil increments"),
                *issue_metrics(mesh, mets, "led", c, steps))

    def apply(c, red):
        got = [p.result() for p in red]
        steps = []
        for card, ranks in mesh.cards():
            home = card == mesh.home
            with mesh.on_card(c, card, "consensus", [p.step for p in red]) as idx:
                first = ranks[0]
                o_in, p_in = route.obj[first[0]][first[1]], route.pupil[first[0]][first[1]]
                o, p, m, acc = route.consensus_led(
                    card, o_in, p_in, *([g[card][r] for r in group] for g in got),
                    state["mets"] if home else None, metrics=home,
                    out=None if bufs is None else (
                        next_slot(bufs, ("obj", card, 0), c, route.n_chunks, o_in),
                        next_slot(bufs, ("pupil", card), c, route.n_chunks, p_in),
                        parity_buffer(bufs, ("omax", card), c, (), route.opts.rdtype, card),
                        parity_buffer(bufs, ("metrics", card), c, (2,), route.metrics_dtype,
                                      card) if home else None))
                for grid, value in ((route.obj, o), (route.pupil, p), (route.omax, m)):
                    set_state(mesh, grid, ranks, value)
                if home:
                    state["mets"] = acc
            steps.append(idx)
        state["steps"] = steps

    pipelined_chunks(route.n_chunks, increments, reduce, apply, opts.stale_consensus)
    back_to_start(mesh, route, bufs, route.n_chunks)
    mesh.end_sweep(route.obj, route.pupil, route.omax, tensors=[state["mets"]])
    return state["mets"]


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
    Returns ``(route, opts)``: the run's :class:`ComplexRoute` or, on the
    kernel route with complex64 state, :class:`PlanesRoute`, whose grids
    hold each rank's state and inputs in the form its sweep takes them.
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

    route = route_for(mesh, opts, mesh.replicate(obj_f), mesh.replicate(pupil),
                      mesh.replicate(support), slice_of(amps_c), slice_of(starts_c),
                      slice_of(mask_c), block_rows=cfg.n_large)
    return route, opts


def result_from(obj_f: torch.Tensor, pupil: torch.Tensor, metrics, replay=None) -> ReconResult:
    """The :class:`ReconResult` of a full centered spectrum and a pupil,
    with ``graph.run_sweeps``' metrics and replay figures."""
    obj_crop = ifft2(ifftshift2d(obj_f))
    obj_np, pupil_np = state_to_numpy(obj_f, pupil)
    return ReconResult(
        obj_crop=obj_crop.cpu().numpy(), obj_f_centered=obj_np, pupil=pupil_np,
        metrics={"data_residual": metrics[:, 0], "update_norm": metrics[:, 1]},
        replay=replay)


def reconstruct_led_sharded(images, geom: LEDGeometry, cfg: FPMConfig,
                            mesh: Mesh | None = None, iterations: int | None = None,
                            dtype=None, initial_state: tuple | None = None,
                            **opt_overrides) -> ReconResult:
    """Reconstruction with each chunk's LEDs split over the mesh's ``led`` axis.

    ``mesh`` defaults to one rank per visible CUDA device (and raises without
    one); pass ``make_mesh(..., devices=["cpu"] * n)`` to run on the CPU.
    ``initial_state`` is an optional ``(obj_f_centered, pupil)`` pair — complex
    arrays or (2, ...) planes, of either package — to resume from. Where
    every rank of this process is a CUDA rank and the transport between
    processes, if any, is NCCL, one sweep is captured into a CUDA graph and
    replayed (``parallel.graph.replays``); else the host walks the chunk
    loop.
    """
    if mesh is None:
        mesh = make_mesh(tile=1)
    route, opts = prepare_led_sharded(images, geom, cfg, mesh, iterations=iterations,
                                      dtype=dtype, initial_state=initial_state,
                                      **opt_overrides)
    metrics, replay = run_sweeps(mesh, route, lambda bufs: _sharded_sweep(
        mesh, route, opts=opts, bufs=bufs), opts.iterations)
    # Every rank holds the whole spectrum, the same bits on every rank: each
    # process returns the global result from its own first rank.
    return result_from(*route.final_state(mesh, mesh.local(route.obj)), metrics, replay)
