"""The sharded runs as ``fpm_tpu`` compiles them: one sweep captured into a
CUDA graph and replayed, so that the host stops walking the chunk loop.

``fpm_tpu`` compiles a whole mesh run as one program (``jax.jit`` around a
``lax.scan`` over the iterations of a ``shard_map``'d sweep, itself a scan
over chunks). CUDA's counterpart is a graph: :class:`SweepGraph` captures
one sweep — every rank's K3 on its stream, the collectives and the
consensus kernels on the mesh's lanes, the halo copies, the fork and join
of the streams — and the run replays it once per iteration, one launch a
sweep where the host enqueued 35-126 kernels through milliseconds of Python.

**The route is fixed by the mesh** (:func:`replays`): a run replays a graph
when every rank of this process is a CUDA rank and its collectives between
processes, if it has any, go over NCCL: one card, several cards in one
process, or a process of a ``--distributed`` run on cards of its own
(``parallel.multihost.ProcessTransport``), which captures its own ranks'
sweep with the transport's NCCL all-gathers, sends and receives, as every
other process of the run does. It walks the chunk loop from Python
otherwise: on the CPU, where nothing is captured and the plain versions
run, and over gloo, whose exchanges pass through the host. A capture that
fails raises; nothing falls back to the host loop.

A captured sweep writes only into tensors made before the capture: the
sweep is a body over :class:`SweepBuffers`, whose tensors are made at the
body's first call (the warm-up before the capture, which also makes the
kernels' plans and matrices and the mesh's receive buffers) and are the same
tensors at every later call. The state ends each sweep in the buffers it
started from (``led_shard.state_slot``), so that the next replay reads it
there. On the CPU the same
body over the same buffers is bitwise the host loop's sweep
(``tests/test_torch_sweep_replay.py``).

The counts a run leaves are the host loop's: the wrappers' ``launches``
(``ops.kernels.launch_counts``) and the mesh's collectives (``Mesh.counts``)
advance by the captured sweep's counts once per replay, and the warm-up's
and the capture's own are taken back (the warm-up is set-up, and a capture
launches nothing); ``Mesh.schedule`` is the captured sweep's, the schedule
of every replay.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..ops import kernels
from .comm import card_edges
from .mesh import Mesh


class SweepBuffers:
    """The tensors a sweep body writes, by key: made by ``make()`` at the
    first :meth:`get` of a key and the same tensor at every later one. Once
    :attr:`frozen` (for the capture) a key not made yet raises."""

    def __init__(self):
        self._made: dict = {}
        self.frozen = False

    def get(self, key, make):
        t = self._made.get(key)
        if t is None:
            if self.frozen:
                raise RuntimeError(f"sweep buffer {key!r} was first asked for during the "
                                   "capture: every buffer must be made before it")
            t = self._made[key] = make()
        return t

    def tensors(self) -> list:
        """Every tensor made (a key may hold a tuple of them)."""
        return [t for v in self._made.values() for t in (v if isinstance(v, tuple) else (v,))
                if t is not None]


def replays(mesh: Mesh) -> bool:
    """The rule: a run replays one captured sweep when every rank of
    ``mesh`` in this process is a CUDA rank and its transport between
    processes is none or NCCL, else walks the chunk loop (CPU ranks, gloo;
    ``run_sweeps.force_host_loop``, tests only, walks it on a card too)."""
    return (not run_sweeps.force_host_loop
            and all(card.type == "cuda" for card, _ in mesh.cards())
            and (mesh.transport is None or getattr(mesh.transport, "backend", None) == "nccl"))


def _counts_less(now: dict, before: dict) -> dict:
    out = {}
    for key, slot in now.items():
        was = before.get(key, {"calls": 0, "payload_bytes": 0})
        out[key] = {k: v - was[k] for k, v in slot.items()}
    return out


def _add_counts(mesh: Mesh, delta: dict) -> None:
    for key, slot in delta.items():
        mine = mesh.counts.setdefault(key, {"calls": 0, "payload_bytes": 0})
        for k, v in slot.items():
            mine[k] += v


def _state(route) -> list:
    """The distinct tensors of ``route``'s state grids (spectrum, pupil)."""
    seen = {}
    for grid in (route.obj, route.pupil):
        for row in grid:
            for t in row:
                if t is not None:
                    seen[id(t)] = t
    return list(seen.values())


class SweepGraph:
    """One sweep of ``body(bufs) -> mets`` captured on the cards of
    ``mesh``: made with a warm-up call (whose effect on the state is put
    back), then the capture; :meth:`replay` runs it once on :attr:`Mesh.home`'s
    current stream and returns the sweep's (2,) metric sums (the same buffer
    at every replay). ``capture_ms``: the warm-up, the capture and the
    graph's instantiation, on the host's clock; ``launches`` and ``counts``:
    one replay's kernel launches by wrapper and collectives; ``enqueue_ms``:
    the host's time of each replay so far; ``replays_ms``: a run's replays
    to the synchronisation after the last (:func:`run_sweeps`).

    All ranks of one card, or of several cards of this process, go into one
    graph: the other cards' streams join the capture through the events of
    the fork from the capturing stream. On the peer route
    (``mesh.peer_route``) the fork and the join are the graph's only edges
    between cards: the consensus kernels read their peers' payloads in
    place, and the flags that order the cards are kernels like the others.
    On the copy route a peer copy or an event wait between cards is a node
    of the graph like a launch, and the graph's launch resolves each edge
    between cards on the host. Under an NCCL
    transport the process group's stream joins the capture the same way (it
    waits on the lane that issues a collective, and the lane on it at the
    collective's finish), so each collective is a node too; the warm-up ran
    each of them once, which made NCCL's communicators, and every process
    captures the same collectives in the same order. Such a capture is made
    in the "thread_local" mode of ``torch.cuda.graph``: the process group's
    watchdog thread queries the events of earlier collectives (the
    warm-up's) from its own thread whenever it wakes, and in the default
    "global" mode such a query from another thread while the capture runs
    can invalidate it; the mode keeps the capture's checks to this thread,
    which makes no call a capture forbids (a one-process run keeps
    "global"). ``capture_ms`` and the replays' figures are this process's.
    Nothing holds the graph but its caller, so that it is freed (and its
    memory pool with it) when the caller drops it, never by the cyclic
    collector during a later capture."""

    def __init__(self, mesh: Mesh, route, body):
        self.mesh = mesh
        self.home, self.cards = mesh.home, [card for card, _ in mesh.cards()]
        t0 = time.perf_counter()
        launches0, counts0 = kernels.launch_counts(), copy.deepcopy(mesh.counts)
        for card in self.cards:
            torch.cuda.synchronize(card)
        saved = [(t, t.clone()) for t in _state(route)]
        self.bufs = SweepBuffers()
        body(self.bufs)                    # the warm-up: every buffer, plan and matrix made
        # The warm-up joins its streams into home's alone: another card's
        # current stream, which puts the state back, waits on nothing of it.
        for card in self.cards:
            torch.cuda.synchronize(card)
        for t, was in saved:
            t.copy_(was)
        for card in self.cards:
            torch.cuda.synchronize(card)
        launches1, counts1 = kernels.launch_counts(), copy.deepcopy(mesh.counts)
        self.bufs.frozen = True
        self.graph = torch.cuda.CUDAGraph()
        mode = "global" if mesh.transport is None else "thread_local"
        with torch.cuda.device(mesh.home), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(mesh.home), capture_error_mode=mode):
            self.mets = body(self.bufs)
        self.launches = {k: v - launches1[k] for k, v in kernels.launch_counts().items()}
        self.counts = _counts_less(mesh.counts, counts1)
        kernels.add_launches({k: v - launches0[k] for k, v in kernels.launch_counts().items()},
                             -1)
        mesh.counts = counts0
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.enqueue_ms: list[float] = []
        self.replays_ms = None

    def replay(self) -> torch.Tensor:
        t0 = time.perf_counter()
        with torch.cuda.device(self.home):
            self.graph.replay()
        kernels.add_launches(self.launches)
        _add_counts(self.mesh, self.counts)
        self.enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        return self.mets

    def settle(self) -> None:
        """Every card's current stream after the replays (they ran on
        :attr:`Mesh.home`'s), for what reads the state there next."""
        home = torch.cuda.current_stream(self.home)
        for card in self.cards:
            if card != self.home:
                torch.cuda.current_stream(card).wait_stream(home)


def run_sweeps(mesh: Mesh, route, body, iterations: int):
    """``iterations`` sweeps of ``body(bufs) -> mets`` on ``mesh``; returns
    the (iterations, 2) metrics array (the one synchronisation with the
    card, after the last sweep) and the replay's figures. Where
    :func:`replays`, one captured sweep replayed ``iterations`` times, each
    sweep's metrics copied into one tensor on the card; the figures are the
    :class:`SweepGraph`'s ``capture_ms``, ``enqueue_ms``, ``replays_ms``
    and ``launches``, with ``peer_route`` (the route between cards the
    captured sweep took, ``Mesh.sweep_route``: ``mesh.peer_route``'s) and
    ``card_edges`` (``comm.card_edges`` of the captured sweep). Else the
    host loop, ``body(None)`` (fresh tensors every chunk), and the figures
    None."""
    if iterations and replays(mesh):
        graph = SweepGraph(mesh, route, body)
        metrics = torch.empty((iterations, 2), dtype=graph.mets.dtype, device=mesh.home)
        t0 = time.perf_counter()
        for i in range(iterations):
            metrics[i].copy_(graph.replay())
        graph.settle()
        out = metrics.cpu().numpy()
        graph.replays_ms = (time.perf_counter() - t0) * 1e3
        return out, {"capture_ms": graph.capture_ms, "enqueue_ms": graph.enqueue_ms,
                     "replays_ms": graph.replays_ms, "launches": graph.launches,
                     "peer_route": mesh.sweep_route,
                     "card_edges": card_edges(mesh.schedule, mesh.edges)}
    per_sweep = [body(None) for _ in range(iterations)]
    return (torch.stack(per_sweep).cpu().numpy() if per_sweep
            else np.zeros((0, 2), np.float64)), None


run_sweeps.force_host_loop = False     # tests only: the host loop on a card too
