"""Multi-process execution on ``torch.distributed``: the port of
``fpm_tpu.parallel.multihost``.

The reference is strictly single-process. As in the JAX package, every
process of a run starts the same command, calls :func:`initialize_from_env`
once, and builds one global mesh (:func:`global_mesh`, or ``make_mesh`` with
explicit axes) whose ranks the processes own in equal, contiguous shares
(:func:`process_mesh`); the sharded sweeps of :mod:`fpm_torch.parallel` run
unchanged, each process on its own ranks, and the mesh's collectives cross
the process boundary (``parallel.mesh``).

Transport. The process group :func:`initialize_from_env` opens is ``gloo``:
it carries the set-up and the results. A mesh picks the transport of its
collectives from its layout when it is created (:class:`ProcessTransport`):
``nccl`` where every process's ranks sit on cards of their own, ``gloo``
where the ranks are on the CPU or processes share a card (NCCL refuses two
members of one group on one device). Over ``gloo`` the payloads travel as
host copies; the computation stays on the ranks' devices. A collective is
begun when the sweep issues it and finished when its result is first
needed (``parallel.mesh.Pending``): over NCCL its all-gathers and
point-to-point sends are issued at once (``async_op``) and the consumer's
stream waits on them, so that under the stale consensus they run while
the card computes the next chunk's K3; over gloo the copies to the host
and the exchange wait until then, after the next chunk's K3 is enqueued.

A run over NCCL (each process on cards of its own) is captured as a
one-process run is (``parallel.graph.replays``): each process captures its
own ranks' sweep, with the all-gathers and point-to-point sends and
receives this transport issues on its process group's NCCL stream, into one
CUDA graph on its cards, and replays it once per iteration. Every process
captures the same collectives in the same order, after a warm-up sweep that
ran each of them once (NCCL makes its communicators and connections at
their first use, which a capture cannot hold). In a sweep over buffers made
once (``Mesh.sweep_buffers``) the transport writes only into buffers of
that sweep, made at the warm-up: the packed payloads sent and the bytes
received, keyed by the collective, its chunk's parity (under the stale
consensus chunk c+1's collective is issued while chunk c's result is still
read) and, point to point, the pair of ranks. A run over gloo walks the
chunk loop from Python: its exchanges pass through the host. Without sweep
buffers (the host loop) every call makes fresh tensors.

Tested without a cluster by the two-process harness of
``tests/test_torch_multihost.py``.
"""

from __future__ import annotations

import os
import socket

import torch

_ENV = ("FPM_COORDINATOR", "FPM_NUM_PROCESSES", "FPM_PROCESS_ID")


def initialize_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    require: bool = False,
) -> bool:
    """Initialize ``torch.distributed`` from args or environment.

    Environment: ``FPM_COORDINATOR`` (host:port), ``FPM_NUM_PROCESSES``,
    ``FPM_PROCESS_ID`` — or, with ``require=True`` (the CLI's
    ``--distributed`` flag), the launcher's own (torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; the counterpart of
    JAX's auto-detection). Returns True when running distributed, False for
    single-process. A run that ASKED for distributed execution but cannot
    initialize it raises instead of silently running single-process (each
    process would otherwise solve an independent duplicate run).
    """
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("FPM_COORDINATOR")
    if num_processes is None and "FPM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FPM_NUM_PROCESSES"])
    if process_id is None and "FPM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FPM_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            raise ValueError(
                "FPM_PROCESS_ID is set but FPM_COORDINATOR/FPM_NUM_PROCESSES "
                "are not — partial multi-host configuration"
            )
        if not require:
            return False
        launcher = _launcher_env()
        if launcher is None:
            raise ValueError(
                "--distributed requested but no multi-host configuration "
                "found: set FPM_COORDINATOR/FPM_NUM_PROCESSES/FPM_PROCESS_ID "
                "or run under a supported launcher (auto-detect said: no "
                "torchrun environment: RANK, WORLD_SIZE and MASTER_ADDR unset)"
            )
        coordinator_address, num_processes, process_id = launcher
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"{'/'.join(_ENV)} must all be set — partial multi-host configuration "
            f"(coordinator {coordinator_address}, processes {num_processes}, "
            f"process id {process_id})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _launcher_env():
    """``(address, world size, rank)`` from torchrun's environment, or None."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return None
    return (f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
            int(env["WORLD_SIZE"]), int(env["RANK"]))


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's index in a distributed run; 0 on a single process."""
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    """True on process 0 of a distributed run, and on a single process."""
    return process_index() == 0


def shutdown() -> None:
    """Destroy the process group, where one is open."""
    import torch.distributed as dist

    if _initialized():
        dist.destroy_process_group()


def all_processes(obj) -> list:
    """``obj`` of every process, in process order (``[obj]`` on one)."""
    import torch.distributed as dist

    if not _initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def local_cards() -> list[torch.device]:
    """The cards this process uses: the visible cards split in contiguous
    shares between the processes of its host (by process order), or, where
    a host has more processes than cards, one card shared round-robin."""
    from ..models.epry import resolve_device

    resolve_device("cuda")
    n = torch.cuda.device_count()
    hosts = all_processes(socket.gethostname())
    me = process_index()
    peers = [p for p, h in enumerate(hosts) if h == hosts[me]]
    k, m = peers.index(me), len(peers)
    if n >= m:
        per = n // m
        return [torch.device("cuda", i) for i in range(k * per, (k + 1) * per)]
    return [torch.device("cuda", k % n)]


def global_mesh(tile: int = 1, devices=None):
    """Build the global ('led', 'tile') mesh over all processes' devices.

    ``devices`` lists this process's devices (default: its cards,
    :func:`local_cards`); the mesh has one rank per device of every process,
    ``led = devices / tile``.
    """
    from .mesh import make_mesh

    n = sum(all_processes(len(devices) if devices is not None else len(local_cards())))
    if n % tile != 0:
        raise ValueError(f"{n} global devices not divisible by tile={tile}")
    return make_mesh(led=n // tile, tile=tile, devices=devices)


def process_mesh(led: int | None, tile: int, devices=None, serialize_streams: bool = False):
    """The ``led × tile`` mesh across the processes: process p owns ranks
    ``[p·n, (p+1)·n)`` in grid order, ``n = led·tile / processes``, placed
    round-robin over ``devices`` (default: :func:`local_cards`) or, with an
    explicit list, on its first n entries. ``serialize_streams``: tests
    only (``parallel.mesh.Mesh``)."""
    import torch.distributed as dist

    from .mesh import Mesh

    world, me = dist.get_world_size(), dist.get_rank()
    mine = ([torch.device(d) for d in devices] if devices is not None else local_cards())
    if led is None:
        led = sum(all_processes(len(mine))) // tile if tile > 0 else 0
    if led < 1 or tile < 1:
        raise ValueError(f"mesh axes must be >= 1, got led={led} tile={tile}")
    total = led * tile
    if total % world:
        raise ValueError(f"mesh led={led} x tile={tile} has {total} ranks, which "
                         f"{world} processes cannot own in equal shares")
    per = total // world
    if devices is None:
        ranks = [mine[i % len(mine)] for i in range(per)]
    elif per > len(mine):
        raise ValueError(f"mesh led={led} x tile={tile} needs {per} devices in each "
                         f"of {world} processes; only {len(mine)} available")
    else:
        ranks = mine[:per]
    flat = [None] * total
    flat[me * per:(me + 1) * per] = ranks
    return Mesh([flat[li * tile:(li + 1) * tile] for li in range(led)],
                ProcessTransport(ranks), serialize_streams)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _pack(out: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """The bytes ``out`` with ``x`` written into them, cast to ``dtype`` (as
    ``Tensor.to`` casts): a payload packed for the wire."""
    out.view(dtype).view(x.shape).copy_(x)
    return out


def _card(d: torch.device):
    """A card's identity across processes (host, UUID); None off the card."""
    if d.type != "cuda":
        return None
    return socket.gethostname(), str(torch.cuda.get_device_properties(d).uuid)


class ProcessTransport:
    """The collectives of a mesh between its processes, over a process group
    of their own whose backend comes from the layout (module docstring).
    Payloads travel as bytes, so every dtype crosses bitwise."""

    def __init__(self, ranks):
        import torch.distributed as dist

        self.world, self.process = dist.get_world_size(), dist.get_rank()
        layout = all_processes([_card(d) for d in ranks])
        cards = [set(ids) for ids in layout]
        if any(None in ids for ids in cards):
            self.backend, self.reason = "gloo", "ranks on the CPU"
        elif any(cards[p] & cards[q] for p in range(self.world) for q in range(p)):
            self.backend, self.reason = "gloo", "processes share a card"
        elif not dist.is_nccl_available():
            self.backend, self.reason = "gloo", "this torch has no NCCL"
        else:
            self.backend, self.reason = "nccl", "every process's ranks on cards of their own"
        self.device = ranks[0] if self.backend == "nccl" else torch.device("cpu")
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        self.group = dist.new_group(backend=self.backend)

    def describe(self) -> str:
        return (f"{self.world} process{'es' if self.world != 1 else ''}, "
                f"transport {self.backend}: {self.reason}")

    def _owner(self, mesh, rank) -> int:
        return (rank[0] * mesh.shape["tile"] + rank[1]) // (mesh.size // self.world)

    def all_gather(self, mesh, tensors: dict) -> dict:
        """Every rank's tensor from each process's ``{rank: tensor}`` of its
        local ranks (all of one shape and dtype)."""
        return self.finish(self.start_all_gather(mesh, tensors))

    def start_all_gather(self, mesh, tensors: dict, wire=None, key=()):
        """:meth:`all_gather` begun, each payload cast to ``wire`` (if given):
        over NCCL the all-gather is issued (``async_op``) after the caller's
        current stream and runs on while the card computes; over gloo
        nothing moves until :meth:`finish`, which then copies the payloads
        to the host and exchanges them. In a sweep over buffers made once
        the payloads are packed into, and received in, buffers under
        ``key`` (the collective and its chunk's parity)."""
        import torch.distributed as dist

        bufs = mesh.sweep_buffers
        like = tensors[mesh.local_ranks[0]]
        dtype = wire or like.dtype
        every = [(li, ti) for li in range(mesh.shape["led"]) for ti in range(mesh.shape["tile"])]
        per = len(mesh.local_ranks)

        def unpack(parts):
            return {every[p * per + j]: chunk.view(dtype).reshape(like.shape)
                    for p, part in enumerate(parts) for j, chunk in enumerate(part.view(per, -1))}

        if bufs is None and wire is not None:
            tensors = {r: x.to(wire) for r, x in tensors.items()}

        def gathered():
            buf = torch.cat([_as_bytes(tensors[r]).to(self.device) for r in mesh.local_ranks])
            parts = [torch.empty_like(buf) for _ in range(self.world)]
            work = dist.all_gather(parts, buf, group=self.group, async_op=True)
            return work, unpack(parts)

        def into_buffers():
            nbytes = like.numel() * dtype.itemsize
            sent = bufs.get(("all-gather sent", *key), lambda: torch.empty(
                (per, nbytes), dtype=torch.uint8, device=self.device))
            got = bufs.get(("all-gather received", *key), lambda: torch.empty(
                (self.world * per, nbytes), dtype=torch.uint8, device=self.device))
            for j, r in enumerate(mesh.local_ranks):
                _pack(sent[j], self._on_own_card(bufs, ("all-gather", *key, r), tensors[r],
                                                 dtype), dtype)
            work = dist.all_gather_into_tensor(got, sent, group=self.group, async_op=True)
            return work, {r: got[i].view(dtype).view(like.shape) for i, r in enumerate(every)}

        issue = gathered if bufs is None else into_buffers
        if self.backend == "nccl":
            work, out = issue()
            return lambda: (work.wait(), out)[1]

        def later():
            work, out = issue()
            work.wait()
            return out
        return later

    def _on_own_card(self, bufs, key, x, dtype):
        """``x`` as :func:`_pack` can copy it to this transport's card
        without a tensor of torch's own: where a copy between cards would
        cast or gather strides, cast and made contiguous on ``x``'s card
        first, in a buffer under ``key``."""
        if x.device == self.device or (x.dtype == dtype and x.is_contiguous()):
            return x
        return bufs.get(("cast", *key), lambda: torch.empty(
            x.shape, dtype=dtype, device=x.device)).copy_(x)

    def exchange(self, mesh, grid, pairs) -> dict:
        """``{dst: grid value of src}`` for this process's ``dst`` ranks of
        ``pairs`` ((src, dst), in the same order on every process): local
        sources directly, others received point to point."""
        return self.finish(self.start_exchange(mesh, grid, pairs))

    def start_exchange(self, mesh, grid, pairs, key=()):
        """:meth:`exchange` begun, as :meth:`start_all_gather` begins its
        all-gather (NCCL: the sends and receives issued; gloo: deferred). In
        a sweep over buffers made once each value sent and received is a
        buffer under ``key`` and its pair of ranks."""
        import torch.distributed as dist

        bufs = mesh.sweep_buffers
        like = mesh.local(grid)
        nbytes = like.numel() * like.element_size()

        def buffer(what, src, dst):
            return bufs.get((what, *key, src, dst), lambda: torch.empty(
                nbytes, dtype=torch.uint8, device=self.device))

        def issued():
            out, ops, recvs = {}, [], []
            for src, dst in pairs:
                ps, pd = self._owner(mesh, src), self._owner(mesh, dst)
                x = grid[src[0]][src[1]]
                if ps == pd == self.process:
                    out[dst] = x
                elif ps == self.process:
                    if bufs is None:
                        sent = _as_bytes(x).to(self.device)
                    else:
                        sent = _pack(buffer("exchange sent", src, dst),
                                     self._on_own_card(bufs, ("exchange", *key, src, dst), x,
                                                       x.dtype), x.dtype)
                    ops.append(dist.P2POp(dist.isend, sent, pd, self.group))
                elif pd == self.process:
                    got = (torch.empty(nbytes, dtype=torch.uint8, device=self.device)
                           if bufs is None else buffer("exchange received", src, dst))
                    ops.append(dist.P2POp(dist.irecv, got, ps, self.group))
                    recvs.append((dst, got))
            works = dist.batch_isend_irecv(ops) if ops else []

            def done():
                for work in works:
                    work.wait()
                for dst, got in recvs:
                    out[dst] = got.view(like.dtype).reshape(like.shape)
                return out
            return done

        if self.backend == "nccl":
            return issued()
        return lambda: issued()()

    @staticmethod
    def finish(started) -> dict:
        """The values of a begun :meth:`start_all_gather` or
        :meth:`start_exchange`; over NCCL the caller's current stream waits
        for them (the host does not)."""
        return started()
