"""The (led, tile) mesh of ranks and its collectives.

Axes (as in ``fpm_tpu.parallel.mesh``):

* ``led``  — LED-batch data parallelism: the ranks of one ``led`` group split
  a chunk's LEDs and hold the same spectrum (block).
* ``tile`` — spectrum-row tiling: the ranks of one ``tile`` group hold
  consecutive row blocks of the spectrum and exchange halos.

A rank is a position ``(li, ti)`` of the grid with a ``torch.device``;
**several ranks may name the same device** (on a one-GPU machine they all
share it, on the CPU the tests use ``devices=["cpu"] * n``). This is the
counterpart of a JAX mesh over virtual host devices: each rank has its own
state and its own contribution, only the transport differs. Per-rank values
travel as a *grid*: a list of lists ``g[li][ti]``.

One process drives its ranks. On one process (the default) it drives them
all. Under ``torch.distributed`` (``parallel.multihost``) each process owns an
equal, contiguous share of the ranks in grid order, as ``fpm_tpu``'s
``global_mesh`` lays out ``jax.devices()`` process by process: the other
processes' ranks have no device here (``None``), :meth:`Mesh.grid` and
:meth:`Mesh.map` run the local ranks only and leave the others ``None``, and
every process runs the same program on its own ranks.

The collectives — :meth:`Mesh.psum`, :meth:`Mesh.pmax`,
:meth:`Mesh.ppermute` — are plain functions over a grid. A reduction combines
its group's payloads **in rank order** on one device and copies the result to
every member, so a result never depends on timing or on the process layout:
across processes every member's payload (cast to the wire dtype, if one is
given) is first gathered from every process, and the adds are the same adds
in the same order, so the result is bitwise that of the one-process mesh.
Each call is counted on the mesh (``mesh.counts``: calls and payload bytes,
one rank's payload per call, keyed by ``(op, axis)``), the same counts on
every process, to be held against the analytic model of ``parallel.comm``.

Streams, events and the schedule. On CUDA every local rank computes on a
stream of its own (two ranks that share a card do not share a stream), and
the collectives run on two lanes, each a stream per card: ``comm`` for the
reductions and the reverse halos, ``halo`` for the forward halos that feed
the next chunk's compute. Work is enqueued in *steps*
(:meth:`Mesh.on_rank`, the collectives): a step waits on the events that
the steps named in its ``after``/``waits`` recorded, and records its own
when its work is enqueued, so that a collective starts when its payloads
are produced and a rank consumes a collective's results only after it.
Every step is appended to :attr:`Mesh.schedule` as a :class:`Step` —
``(chunk, rank, stream, op, waits_on, nbytes)`` — the counterpart of the
scheduled program that ``fpm_tpu``'s ``consensus_schedule_check`` reads
(``parallel.comm.consensus_schedule_check`` reads this one). On the CPU
there are no streams and steps run as they are enqueued, but the same
schedule, with the same stream labels, is recorded, so the order can be
tested there. A tensor made on one stream and read on another is handed to
the reader's stream with ``Tensor.record_stream``, so that the caching
allocator does not give its memory to a later chunk while the reader may
still use it.

A sweep over *buffers made once* (``begin_sweep(..., bufs=...)``; the
sweeps of ``parallel.graph``, which captures one into a CUDA graph) writes
only into tensors that live for the whole run: nothing is handed over, the
streams fork from and join into one stream (:attr:`Mesh.home`'s current
stream, the capturing stream under a capture), and a payload that moves
between cards lands in a buffer of the mesh made at its first move.

**The peer route** (:func:`peer_route`, fixed by the mesh). One process
over several cards, every pair of which reads the other's memory (peer
access, enabled at the mesh's creation; CPU "cards", ``torch.device("cpu",
i)``, share the host's): a sweep over buffers made once moves nothing
between cards. :meth:`Mesh.collect` hands each consumer the payloads where
their ranks wrote them, the forward halo (:meth:`Mesh.ppermute`) is pulled
by a kernel on the receiving card (``kernels.peer_pull``), and the order
between cards is kept on the cards: a step whose stream another card waits
on posts a flag after its work (``kernels.peer_post``), and a step that
waits on another card's step polls its flag first (``kernels.peer_wait``;
the epoch each card bumps at its sweep's first node tells one sweep's
posts from the last's). The only event edges between cards left are the
fork at :meth:`begin_sweep` and the join at :meth:`end_sweep`, one each per
card other than :attr:`home`'s. :attr:`Mesh.edges` records, beside each
step of the schedule, its card and the steps it waited on through events
and through flags (``parallel.comm.card_edges``, ``comm.ordered_before``).
The host loop, a pair of cards without peer access, and a run over
processes keep events and copies between cards (the copy route).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..models.epry import resolve_device
from ..ops import kernels

AXES = ("led", "tile")
LANES = ("comm", "halo")
# The routes of peer_route that keep the order between cards with flags.
FLAG_ROUTES = ("peer", "streams")


class Step(NamedTuple):
    """One enqueued step of a sharded sweep: its ``chunk`` (None outside the
    chunk loop), the ``rank`` ``(li, ti)`` whose stream it runs on (None for
    a collective, which runs on a lane), the ``stream`` label (``"rank
    li,ti"``, ``"comm"``, ``"halo"``, or ``"current"`` when the mesh
    serializes), ``op``, the indices in the schedule of the steps whose
    events it waits on (``waits_on``; a step also follows every earlier step
    of its own stream), and the payload bytes of one rank (collectives)."""

    chunk: int | None
    rank: tuple[int, int] | None
    stream: str
    op: str
    waits_on: tuple[int, ...]
    nbytes: int = 0


class Edges(NamedTuple):
    """How a step of :attr:`Mesh.schedule` was ordered (:attr:`Mesh.edges`,
    one per step): ``card``, the index in :meth:`Mesh.cards` of the card
    whose stream it runs on (None: every card's lane, a collective of the
    copy route); ``events``, the steps whose events its streams waited on
    (a step that enqueued nothing stands for the steps it names);
    ``flags``, the steps whose posts it polled (the peer route); ``copies``,
    the payloads it copied between cards (each ordered on both); ``work``
    False for a step that enqueued nothing."""

    card: int | None
    events: tuple[int, ...] = ()
    flags: tuple[int, ...] = ()
    copies: int = 0
    work: bool = True


class Pending:
    """A collective in flight (``wait=False``): :meth:`result` gives its
    grid, completing the exchange between processes where a transport
    defers it; :attr:`step` is its index in the schedule, which a consumer
    waits on."""

    def __init__(self, step: int, grid=None, finish=None):
        self.step = step
        self._grid, self._finish = grid, finish

    def result(self):
        if self._finish is not None:
            self._grid, self._finish = self._finish(), None
        return self._grid


def mesh_shape_for(n_devices: int, n_large: int, np_size: int) -> tuple[int, int]:
    """Pick an (led, tile) factorization of ``n_devices``.

    The tile axis is capped so each row shard keeps at least ``np_size`` rows
    (patches then straddle at most two shards — single-hop halos); remaining
    devices go to the LED axis.
    """
    max_tile = max(1, n_large // np_size)
    tile = 1
    for cand in range(min(n_devices, max_tile), 0, -1):
        if n_devices % cand == 0:
            tile = cand
            break
    return n_devices // tile, tile


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:<current>``): a rank's
    streams and its tensors then name one device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def _current(stream):
    """``stream`` as its card's current stream for the body; after it the
    current device and that card's current stream are what they were: what
    ``torch.cuda.stream`` does, through the calls it makes, without its own
    device checks, whose host time the sweeps would pay at every step of
    every chunk (``scripts/host_profile.py``)."""
    device = torch._C._cuda_getDevice()
    prev = torch._C._cuda_getCurrentStream(stream.device_index)
    torch._C._cuda_setStream(stream_id=stream.stream_id, device_index=stream.device_index,
                             device_type=stream.device_type)
    try:
        yield
    finally:
        torch._C._cuda_setStream(stream_id=prev[0], device_index=prev[1], device_type=prev[2])
        if device != stream.device_index:
            torch._C._cuda_setDevice(device)


def unzip(grid, n: int):
    """A grid of n-tuples as n grids (a rank of another process, ``None``,
    stays ``None`` in each)."""
    return tuple([[None if cell is None else cell[i] for cell in row] for row in grid]
                 for i in range(n))


class Mesh:
    """An ``led × tile`` grid of ranks; ``devices[li][ti]`` is a rank's
    device, ``None`` for a rank of another process. ``transport`` carries the
    collectives between processes (``parallel.multihost.ProcessTransport``);
    ``None`` on one process.

    ``serialize_streams`` is for tests only: it puts every rank and both
    lanes on each device's current stream, so that nothing overlaps (a run
    with it is bitwise the run without it; only when the work runs
    differs). Nothing on the main path sets it."""

    def __init__(self, devices, transport=None, serialize_streams: bool = False):
        self.devices = [[None if d is None else _indexed(torch.device(d)) for d in row]
                        for row in devices]
        self.shape = {"led": len(self.devices), "tile": len(self.devices[0])}
        self.transport = transport
        self.local_ranks = [(li, ti) for li, row in enumerate(self.devices)
                            for ti, d in enumerate(row) if d is not None]
        self.counts: dict[tuple[str, str], dict[str, int]] = {}
        self.serialize_streams = serialize_streams
        self.schedule: list[Step] = []
        self.edges: list[Edges] = []
        self._events: dict[int, list] = {}
        self._sources: dict = {}       # steps that enqueued nothing: {card or None: steps}
        self._posts: dict = {}         # step: (card, signal) of the flag it posted
        self._signals: dict = {}       # (card, stream, op, n-th in its chunk): signal
        self._nth: dict = {}
        self._flags = None             # each card's flag block (kernels.flag_block)
        self._route, self._flagged, self._lane_step = "one card", False, None
        self.sweep_route = "one card"     # the route of the last sweep (begin_sweep)
        self._received: dict = {}      # buffers of payloads moved between cards (_landed)
        self._bufs = None              # the sweep's buffers made once (begin_sweep), or None
        self._pool: dict = {}          # each device's events, reused sweep after sweep
        self._used: dict = {}
        self._needed: dict = {}        # collect's default needs by axes
        by_card: dict = {}
        for li, ti in self.local_ranks:
            by_card.setdefault(self.devices[li][ti], []).append((li, ti))
        self._cards = list(by_card.items())
        self._card_index = {card: k for k, (card, _) in enumerate(self._cards)}
        # Every pair of this process's cards reads the other's memory: CUDA
        # cards with peer access (enabled here), or CPU "cards" (the host's).
        self.peer_access = transport is None and len(self._cards) > 1 and all(
            a.type == b.type == "cpu" or (a.type == b.type == "cuda"
                                          and torch.cuda.can_device_access_peer(a, b))
            for a in by_card for b in by_card if a != b)
        if self.peer_access:
            for a in by_card:
                for b in by_card:
                    if a != b and a.type == "cuda":
                        kernels.enable_peer_access(a, b)
        cards = [d for d in by_card if d.type == "cuda"]
        streamed = bool(cards) and not serialize_streams
        self._rank_streams = {r: torch.cuda.Stream(self.devices[r[0]][r[1]])
                              for r in self.local_ranks if streamed
                              and self.devices[r[0]][r[1]].type == "cuda"}
        self._lane_streams = {lane: {d: torch.cuda.Stream(d) for d in cards} if streamed else {}
                              for lane in LANES}

    @property
    def size(self) -> int:
        return self.shape["led"] * self.shape["tile"]

    @property
    def home(self) -> torch.device:
        """The device of this process's first rank."""
        li, ti = self.local_ranks[0]
        return self.devices[li][ti]

    def local(self, grid):
        """The value of this process's first rank in ``grid`` (for values
        every rank holds alike, such as a reduction's result)."""
        li, ti = self.local_ranks[0]
        return grid[li][ti]

    def describe(self) -> str:
        """``led=L tile=T (N ranks on D devices: ...)`` for the CLI's line;
        across processes also the process layout and the transport, and on
        several devices the route between them (:func:`peer_route`)."""
        distinct = list(dict.fromkeys(str(self.devices[li][ti]) for li, ti in self.local_ranks))
        n_local = len(self.local_ranks)
        shared = "; ranks share a device" if len(distinct) < n_local else ""
        where = (f"{n_local} rank{'s' if n_local != 1 else ''} on {len(distinct)} device"
                 f"{'s' if len(distinct) != 1 else ''}: {', '.join(distinct)}{shared}")
        if self.transport is not None:
            where = f"{self.transport.describe()}; this process's {where}"
        if len(self._cards) > 1:
            where = f"{where}; {peer_route(self)} route between them"
        return f"led={self.shape['led']} tile={self.shape['tile']} ({where})"

    # ------------------------------------------------------------- grids

    def grid(self, fn):
        """The grid ``fn(li, ti)`` over the local ranks (``None`` elsewhere)."""
        return [[fn(li, ti) if d is not None else None for ti, d in enumerate(row)]
                for li, row in enumerate(self.devices)]

    def map(self, fn, *grids):
        """The grid ``fn(*values of rank)`` over the local ranks of ``grids``."""
        return self.grid(lambda li, ti: fn(*(g[li][ti] for g in grids)))

    def replicate(self, t: torch.Tensor):
        """``t`` on every local rank's device (ranks on one device share one
        tensor: a rank's state is never updated in place)."""
        return self.grid(lambda li, ti: t.to(self.devices[li][ti]))

    def gather(self, grid):
        """Every rank's value of ``grid`` on :attr:`home`, on every process
        (uncounted: for results, not for the sweep's collectives)."""
        if self.transport is None:
            return [[t.to(self.home) for t in row] for row in grid]
        values = self.transport.all_gather(self, {r: grid[r[0]][r[1]] for r in self.local_ranks})
        return [[values[(li, ti)].to(self.home) for ti in range(self.shape["tile"])]
                for li in range(self.shape["led"])]

    # -------------------------------------------------- streams and steps

    @property
    def sweep_buffers(self):
        """The buffers of the sweep being enqueued (``begin_sweep``'s
        ``bufs``), or None: the host loop, which makes fresh tensors."""
        return self._bufs

    def streams(self) -> list:
        """Every stream of this process's ranks and lanes (none on the CPU or
        when the mesh serializes)."""
        return [*self._rank_streams.values(),
                *(s for lane in self._lane_streams.values() for s in lane.values())]

    def _log(self, chunk, rank, stream: str, op: str, waits, nbytes: int = 0, card=None,
             work: bool = True) -> int:
        self.schedule.append(Step(chunk, rank, "current" if self.serialize_streams else stream,
                                  op, tuple(waits), nbytes))
        self.edges.append(Edges(card, work=work))
        return len(self.schedule) - 1

    def _card_of(self, rank) -> int:
        return self._card_index[self.devices[rank[0]][rank[1]]]

    def _domain(self, idx: int):
        """Steps of one domain wait on each other through events, of two
        through flags: a card on the peer route, a stream of the card on the
        route ``peer_route.force_flags`` gives one card."""
        card = self.edges[idx].card
        return card if self._route == "peer" else (card, self.schedule[idx].stream)

    def _resolve(self, waits, card) -> list[int]:
        """The steps that enqueued work which ``waits`` stand for, for a
        waiter on ``card``: a step that enqueued nothing stands for the steps
        it names for that card, or for every card (a waiter of no card
        waits on those of each)."""
        out = []
        for j in waits:
            src = self._sources.get(j)
            if src is None:
                out.append(j)
            else:
                mine = src.get(card, src.get(None)) if card in src or None in src else [
                    i for steps in src.values() for i in steps]
                out += self._resolve(mine, card)
        return list(dict.fromkeys(out))

    def _wait(self, idx: int, stream, waits, events_only: bool = False) -> None:
        """Step ``idx``'s ``stream`` (None: nothing to enqueue it on) after
        the steps ``waits``: the events of those of its domain, the flags of
        the others' on a route of flags. Recorded in :attr:`edges`."""
        steps = self._resolve(waits, self.edges[idx].card)
        mine = self._domain(idx)
        flagged = [j for j in steps if self._flagged and not events_only
                   and self._domain(j) != mine]
        events = [j for j in steps if j not in flagged]
        self.edges[idx] = self.edges[idx]._replace(events=tuple(events), flags=tuple(flagged))
        if stream is not None:
            for event in {id(e): e for j in events for e in self._events.get(j, ())}.values():
                stream.wait_event(event)
        if flagged:
            polled = []
            for j in flagged:
                if j not in self._posts:
                    raise RuntimeError(f"step {j} ({self.schedule[j].op}) of another card is "
                                       "waited on but posted no flag")
                card, signal = self._posts[j]
                polled.append((self._flags[card], signal, self.schedule[j].chunk))
            kernels.peer_wait(polled, self._flags[self.edges[idx].card],
                              stream=None if stream is None else stream.cuda_stream)

    def _post(self, idx: int, stream) -> None:
        """On a route of flags, step ``idx`` of the chunk loop posts its flag
        after its work, on ``stream``: signal n of its card is the n-th step
        of a chunk with its stream and op."""
        step, card = self.schedule[idx], self.edges[idx].card
        if not self._flagged or step.chunk is None:
            return
        key = (card, step.stream, step.op)
        nth = self._nth[(key, step.chunk)] = self._nth.get((key, step.chunk), -1) + 1
        if (*key, nth) not in self._signals:
            self._signals[(*key, nth)] = sum(1 for k in self._signals if k[0] == card)
        signal = self._signals[(*key, nth)]
        kernels.peer_post(self._flags[card], signal, step.chunk,
                          stream=None if stream is None else stream.cuda_stream)
        self._posts[idx] = (card, signal)

    def _recorded(self, idx: int, streams) -> None:
        # Events are reused from sweep to sweep (begin_sweep starts each
        # device's pool over; an event records on one device only): every
        # wait on an event's earlier record was enqueued before.
        events = []
        for stream in streams:
            pool, used = self._pool.setdefault(stream.device, []), self._used.get(stream.device, 0)
            if used == len(pool):
                pool.append(torch.cuda.Event())
            event = pool[used]
            self._used[stream.device] = used + 1
            event.record(stream)
            events.append(event)
        self._events[idx] = events

    @contextlib.contextmanager
    def on_rank(self, chunk, rank, op: str, waits=()):
        """A step of rank ``rank``: its work, enqueued in the body, runs on
        the rank's stream after the events of the steps ``waits``. Yields
        the step's index in the schedule."""
        idx = self._log(chunk, rank, f"rank {rank[0]},{rank[1]}", op, waits,
                        card=self._card_of(rank))
        stream = self._rank_streams.get(rank)
        self._wait(idx, stream, waits)
        with _current(stream) if stream is not None else contextlib.nullcontext():
            yield idx
        if stream is not None:
            self._recorded(idx, [stream])
        self._post(idx, stream)

    def each(self, chunk, op: str, fn, *grids, waits=()):
        """``fn(*values of rank)`` over the local ranks, each as a step of
        its own (:meth:`on_rank`); returns the grid and the steps' indices."""
        out = self.grid(lambda li, ti: None)
        steps = []
        for li, ti in self.local_ranks:
            with self.on_rank(chunk, (li, ti), op, waits) as idx:
                out[li][ti] = fn(*(g[li][ti] for g in grids))
            steps.append(idx)
        return out, steps

    @contextlib.contextmanager
    def _on_lane(self, lane: str, idx: int, waits=()):
        """Every local card's stream of ``lane`` made current (a copy between
        two cards runs on, and is ordered on, both), after ``waits``."""
        streams = list(self._lane_streams[lane].values())
        with contextlib.ExitStack() as stack:
            for stream in streams or [None]:
                self._wait(idx, stream, waits, events_only=True)
                if stream is not None:
                    stack.enter_context(_current(stream))
            self._lane_step = idx          # the step whose copies _landed counts
            yield
        if streams:
            self._recorded(idx, streams)

    def _hand_over(self, tensor, lane: str | None = None, rank=None) -> None:
        """``tensor`` is read on ``lane`` (its card's stream of it) or on
        ``rank``'s stream: keep its memory from the allocator until then
        (nothing to keep in a sweep over buffers made once)."""
        if tensor is None or not tensor.is_cuda or self._bufs is not None:
            return
        stream = (self._lane_streams[lane].get(tensor.device) if lane is not None
                  else self._rank_streams.get(rank))
        if stream is not None:
            tensor.record_stream(stream)

    def cards(self):
        """This process's devices, each with its local ranks in rank order,
        in the order of their first rank."""
        return self._cards

    @contextlib.contextmanager
    def on_card(self, chunk, card, op: str, waits=()):
        """A step of ``card`` on its comm lane (a chunk's consensus): its
        work, enqueued in the body, runs on the card's comm stream after the
        events of the steps ``waits``. Yields the step's index."""
        idx = self._log(chunk, None, "comm", op, waits, card=self._card_index[card])
        stream = self._lane_streams["comm"].get(card)
        self._wait(idx, stream, waits)
        with _current(stream) if stream is not None else contextlib.nullcontext():
            yield idx
        if stream is not None:
            self._recorded(idx, [stream])
        self._post(idx, stream)

    def share(self, tensor, ranks) -> None:
        """``tensor``, made on a lane, is read on the streams of ``ranks``:
        keep its memory from the allocator until they are done with it."""
        for rank in ranks:
            self._hand_over(tensor, rank=rank)

    def _origin(self, stream):
        """The stream a sweep's ``stream`` forks from and joins into: its
        card's current stream, or in a sweep over buffers made once
        :attr:`home`'s (under a capture the capturing stream, so that every
        card's streams join the capture)."""
        return torch.cuda.current_stream(self.home if self._bufs is not None else stream.device)

    def _card_streams(self, card) -> list:
        """The streams of ``card``: its ranks' and its lanes'."""
        return [*(s for r, s in self._rank_streams.items()
                  if self.devices[r[0]][r[1]] == card),
                *(lane[card] for lane in self._lane_streams.values() if card in lane)]

    def begin_sweep(self, *grids, bufs=None, in_place: bool = True) -> None:
        """Start a sweep's schedule: the rank and lane streams wait on the
        work enqueued on each card's current stream (the set-up that made
        ``grids``), and each rank's tensors of ``grids`` are handed to its
        stream. With ``bufs`` (``parallel.graph.SweepBuffers``) the sweep
        writes only into buffers made once: the streams fork from
        :attr:`home`'s current stream and nothing is handed over. On a route
        of flags (:func:`peer_route`) each card's comm lane forks from it
        (the only event edge into another card), bumps the card's epoch and
        forks the card's other streams. ``in_place`` False: the sweep's
        consumers cannot read another CUDA card's memory (the complex
        route's consensus, PyTorch's ops on one card), which keeps the copy
        route between cards. :attr:`sweep_route` is the route the sweep
        takes."""
        self.schedule, self.edges, self._events, self._used, self._bufs = [], [], {}, {}, bufs
        self._sources, self._posts, self._nth = {}, {}, {}
        self._route = peer_route(self)
        self._flagged = bufs is not None and self._route in FLAG_ROUTES and (
            in_place or self._route == "streams" or all(c.type == "cpu" for c, _ in self._cards))
        self.sweep_route = (self._route if self._flagged or self._route not in FLAG_ROUTES
                            else "copy" if len(self._cards) > 1 else "one card")
        if self._flagged:
            self._fork()
            return
        for stream in self.streams():
            stream.wait_stream(self._origin(stream))
        for grid in grids:
            for li, ti in self.local_ranks:
                self._hand_over(grid[li][ti], rank=(li, ti))

    def _fork(self) -> None:
        if self._flags is None:
            self._flags = [kernels.flag_block(card) for card, _ in self._cards]
        origin = torch.cuda.current_stream(self.home) if self._rank_streams else None
        fork = self._log(None, None, "origin", "fork", (), card=self._card_index[self.home])
        if origin is not None:
            self._recorded(fork, [origin])
        for k, (card, _) in enumerate(self._cards):
            root = self._lane_streams["comm"].get(card)
            idx = self._log(None, None, "comm", "sweep start", (fork,), card=k)
            self._wait(idx, root, [fork], events_only=True)
            kernels.peer_epoch(self._flags[k], stream=None if root is None else root.cuda_stream)
            if root is not None:
                self._recorded(idx, [root])
                for stream in self._card_streams(card):
                    if stream is not root:
                        stream.wait_stream(root)

    def _join(self) -> None:
        ends = []
        for k, (card, _) in enumerate(self._cards):
            root = self._lane_streams["comm"].get(card)
            if root is not None:
                for stream in self._card_streams(card):
                    if stream is not root:
                        root.wait_stream(stream)
            ends.append(self._log(None, None, "comm", "sweep end", (), card=k))
            if root is not None:
                self._recorded(ends[-1], [root])
        join = self._log(None, None, "origin", "join", ends, card=self._card_index[self.home])
        self._wait(join, torch.cuda.current_stream(self.home) if self._rank_streams else None,
                   ends, events_only=True)

    def end_sweep(self, *grids, tensors=()) -> None:
        """End a sweep: each card's current stream (with buffers made once,
        :attr:`home`'s) waits on every rank and lane stream, and takes over
        the tensors of ``grids`` and ``tensors``. On a route of flags each
        card's comm lane joins the card's other streams, and :attr:`home`'s
        current stream joins the comm lanes."""
        if self._flagged:
            self._join()
            self._bufs, self._flagged = None, False
            return
        for stream in self.streams():
            self._origin(stream).wait_stream(stream)
        fixed, self._bufs = self._bufs is not None, None
        if not self._rank_streams or fixed:
            return
        held = [grid[li][ti] for grid in grids for li, ti in self.local_ranks]
        for t in (*held, *tensors):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))

    # ------------------------------------------------------- collectives

    def reset_counts(self) -> None:
        self.counts = {}

    def _count(self, op: str, axes, payload: torch.Tensor) -> None:
        slot = self.counts.setdefault((op, ",".join(axes)), {"calls": 0, "payload_bytes": 0})
        slot["calls"] += 1
        slot["payload_bytes"] += payload.numel() * payload.element_size()

    def _groups(self, axes):
        """The rank groups a reduction over ``axes`` combines, in rank order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes or any(a not in AXES for a in axes):
            raise ValueError(f"mesh axes are {AXES}, got {axes!r}")
        n_led, n_tile = self.shape["led"], self.shape["tile"]
        if set(axes) == set(AXES):
            return AXES, [[(li, ti) for li in range(n_led) for ti in range(n_tile)]]
        if axes == ("led",):
            return axes, [[(li, ti) for li in range(n_led)] for ti in range(n_tile)]
        return axes, [[(li, ti) for ti in range(n_tile)] for li in range(n_led)]

    def _needs(self, axes):
        """For each card of this process, every rank of the groups over
        ``axes`` that hold one of its ranks (made once per axes)."""
        if axes not in self._needed:
            _, groups = self._groups(axes)
            self._needed[axes] = {card: [r for g in groups if set(g) & set(ranks) for r in g]
                                  for card, ranks in self.cards()}
        return self._needed[axes]

    def _collective(self, op: str, axes, payload, start, finish, *, lane, chunk=None,
                    after=(), what="", wait=True):
        """Count and log a collective, then ``start()`` it on ``lane`` after
        the steps ``after``; ``finish(started)`` gives its grid, on the lane
        too. On one process both run at once; a transport may defer
        ``finish`` (``wait=False`` then returns a :class:`Pending` whose
        ``result`` completes it)."""
        self._count(op, axes, payload)
        nbytes = payload.numel() * payload.element_size()
        idx = self._log(chunk, None, lane, f"{op} {what}" if what else op, after, nbytes)
        with self._on_lane(lane, idx, after):
            started = start()
            pending = (Pending(idx, grid=finish(started)) if self.transport is None
                       else Pending(idx, finish=lambda: self._finish_on(lane, idx, finish,
                                                                       started)))
        return pending if not wait else pending.result()

    def _finish_on(self, lane, idx, finish, started):
        with self._on_lane(lane, idx):
            return finish(started)

    def _reduce(self, op: str, grid, axes, combine, wire_dtype=None, lane="comm", **step):
        axes, groups = self._groups(axes)
        full_dtype = self.local(grid).dtype

        def start():
            for li, ti in self.local_ranks:
                self._hand_over(grid[li][ti], lane=lane)
            # The payloads on the wire; accumulated in full precision below.
            if self.transport is not None:
                return self.transport.start_all_gather(
                    self, {r: grid[r[0]][r[1]] for r in self.local_ranks}, wire_dtype,
                    _key(step))
            return {(li, ti): grid[li][ti] if wire_dtype is None
                    else grid[li][ti].to(wire_dtype) for li, ti in self.local_ranks}

        def finish(started):
            values = started if self.transport is None else self.transport.finish(started)
            out = self.grid(lambda li, ti: None)
            for group in groups:
                mine = [r for r in group if r in self.local_ranks]
                if not mine:
                    continue
                first = self.devices[group[0][0]][group[0][1]]
                home = first if first is not None else self.home
                acc = None
                for r in group:
                    x = values[r].to(home).to(full_dtype)
                    acc = x if acc is None else combine(acc, x)
                for li, ti in mine:
                    out[li][ti] = acc.to(self.devices[li][ti])
                    self._hand_over(out[li][ti], rank=(li, ti))
            return out

        payload = self.local(grid)
        if wire_dtype is not None:
            payload = torch.empty(payload.shape, dtype=wire_dtype, device="meta")
        return self._collective(op, axes, payload, start, finish, lane=lane, **step)

    def collect(self, grid, axes, wire_dtype=None, *, op="psum", count_like=None, needs=None,
                lane="comm", **step):
        """A reduction over ``axes`` whose payloads are gathered and not
        combined: the consumer (a consensus kernel, or its plain version)
        adds them in rank order, as :meth:`psum` would. Counted and logged as
        ``op`` with the payload bytes of ``count_like`` (default: one rank's
        payload), in ``wire_dtype`` if given. Returns a :class:`Pending`
        whose result is ``{card: {rank: payload on card}}`` for each card of
        this process and the ranks of ``needs[card]`` (default: every rank
        of the groups over ``axes`` that hold one of the card's ranks). A
        payload on its own card stays as it is (f32: the consumer rounds it
        to the wire's dtype); one from another card is cast to
        ``wire_dtype`` and copied; between processes the transport's
        all-gather carries every payload, cast. A copy lands in a buffer
        of this mesh, made at the first chunk and reused: the next copy into
        it is enqueued on the same lane after this chunk's consumer. On a
        route of flags (:func:`peer_route`) nothing moves: each card gets
        the payloads where their ranks wrote them (f32, rounded to the wire
        by the consumer), and a consumer that waits on the collective waits
        on the steps that made its card's payloads.
        ``step`` as for :meth:`psum`, ``wait`` False by default."""
        if needs is None:
            needs = self._needs(axes)
        axes, _ = self._groups(axes)
        cards = self.cards()

        def start():
            mine = {}
            for li, ti in self.local_ranks:
                self._hand_over(grid[li][ti], lane=lane)
                mine[(li, ti)] = grid[li][ti]
            if self.transport is None:
                return mine
            return self.transport.start_all_gather(self, mine, wire_dtype, _key(step))

        def arrive(r, x, card):
            # Without a transport x is rank r's own tensor, on its card.
            where = x.device if self.transport is not None else self.devices[r[0]][r[1]]
            if self._flagged or where == card:
                return x
            return self._landed((step.get("what"), r), x, card, wire_dtype or x.dtype)

        def finish(started):
            values = started if self.transport is None else self.transport.finish(started)
            return {card: {r: arrive(r, values[r], card) for r in needs[card]}
                    for card, _ in cards}

        payload = self.local(grid) if count_like is None else count_like
        if wire_dtype is not None:
            payload = torch.empty(payload.shape, dtype=wire_dtype, device="meta")
        if self.transport is None and (self._flagged or all(
                self.devices[r[0]][r[1]] == card for card, ranks in needs.items()
                for r in ranks)):
            idx = self._unmoved(op, axes, payload, lane, step.get("chunk"),
                                step.get("after", ()), step.get("what", ""), needs=needs)
            return Pending(idx, grid=finish(start()))
        step.setdefault("wait", False)
        return self._collective(op, axes, payload, start, finish, lane=lane, **step)

    def _buffer(self, key, where, device, shape, dtype):
        """The buffer of this mesh under ``key`` and ``where`` on ``device``,
        made at its first use (with the shape and dtype) and reused after."""
        full = (*key, where, device, tuple(shape), dtype)
        if full not in self._received:
            self._received[full] = torch.empty(shape, dtype=dtype, device=device)
        return self._received[full]

    def _landed(self, key, x, device, dtype):
        """``x`` from another card, cast to ``dtype``, in a buffer on
        ``device`` under ``key`` (:meth:`_buffer`): cast and made contiguous
        first in a buffer on ``x``'s card where it must be, so that a move
        makes no tensor. The copies run on the current streams (the lanes),
        each buffer's next copy after this one's; each is counted in the
        step's :class:`Edges` (ordered on both cards)."""
        if x.dtype != dtype or not x.is_contiguous():
            x = self._buffer(key, "sent", x.device, x.shape, dtype).copy_(x)
        idx = self._lane_step
        self.edges[idx] = self.edges[idx]._replace(copies=self.edges[idx].copies + 1)
        return self._buffer(key, "landed", device, x.shape, dtype).copy_(x, non_blocking=True)

    def _pulled(self, grid, axis, src, payload, lane, step) -> Pending:
        """:meth:`ppermute` on a route of flags: on each card one step of its
        ``lane`` that waits on those of ``step``'s ``after`` that ran on a
        source's card or its own, pulls each of its ranks' payload from the
        source's rows into a buffer of the card (``kernels.peer_pull``, the
        pair's buffer of the chunk's parity) and posts. Counted once, as the
        collective it is; a step that waits on it waits on its card's
        pull."""
        chunk, what = step.get("chunk"), step.get("what", "")
        out, pulls = self.grid(lambda li, ti: None), {}
        nbytes = payload.numel() * payload.element_size()
        for k, (card, ranks) in enumerate(self._cards):
            srcs = [src(li, ti) for li, ti in ranks]
            waits = self._owned(step.get("after", ()), [*srcs, *ranks])
            idx = self._log(chunk, None, lane, f"pull {what}", waits, nbytes * len(ranks), card=k)
            stream = self._lane_streams[lane].get(card)
            self._wait(idx, stream, waits)
            with _current(stream) if stream is not None else contextlib.nullcontext():
                for (li, ti), (sl, st) in zip(ranks, srcs):
                    x = grid[sl][st]
                    out[li][ti] = self._buffer((*_key(step), (sl, st), (li, ti)), "pulled", card,
                                               x.shape, x.dtype)
                    kernels.peer_pull(_words(out[li][ti]), _words(x),
                                      stream=None if stream is None else stream.cuda_stream)
            if stream is not None:
                self._recorded(idx, [stream])
            self._post(idx, stream)
            pulls[k] = (idx,)
        self._count("ppermute", (axis,), payload)
        idx = self._log(chunk, None, lane, f"ppermute {what}" if what else "ppermute",
                        [j for (j,) in pulls.values()], nbytes, work=False)
        self._sources[idx] = pulls
        return Pending(idx, grid=out)

    def carried(self, op: str, axes, payload_like, lane="comm", chunk=None, after=(),
                what="") -> int:
        """A collective of fpm_tpu's program whose payloads another
        collective of this mesh carried (:meth:`collect`'s ``needs``):
        counted with ``payload_like``'s bytes and logged as a step after
        ``after``; nothing moves. Returns the step's index."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._unmoved(op, axes, payload_like, lane, chunk, after, what)

    def _unmoved(self, op, axes, payload, lane, chunk, after, what, needs=None) -> int:
        """Count and log a collective whose step moves nothing and enqueues
        no work: a step that waits on it waits on the steps ``after``, or
        with ``needs`` ({card: ranks}) a step on a card on those of
        ``after`` that ran on the card's ranks of ``needs`` or their cards."""
        self._count(op, axes, payload)
        idx = self._log(chunk, None, lane, f"{op} {what}" if what else op, after,
                        payload.numel() * payload.element_size(), work=False)
        self._sources[idx] = ({None: tuple(after)} if needs is None else
                              {self._card_index[card]: self._owned(after, ranks)
                               for card, ranks in needs.items()})
        return idx

    def _owned(self, steps, ranks) -> tuple[int, ...]:
        """The steps of ``steps`` that ran on a rank of ``ranks``, on the
        card of one, or on every card (a step that enqueued nothing)."""
        ranks = set(ranks)
        cards = {self._card_of(r) for r in ranks}
        return tuple(j for j in steps if (
            self.schedule[j].rank in ranks if self.schedule[j].rank is not None
            else self.edges[j].card is None or self.edges[j].card in cards))

    def psum(self, grid, axes, wire_dtype=None, **step):
        """All-reduce sum over ``axes`` (``"led"``, ``"tile"`` or both).
        ``wire_dtype`` casts each rank's payload (real tensors only) before it
        travels; the sum is accumulated in the dtype the tensors came in.
        ``step``: ``lane`` (``"comm"``), ``chunk``, ``after`` (the steps
        that produced the payloads), ``what`` (the schedule's label) and
        ``wait`` (False: return a :class:`Pending`)."""
        return self._reduce("psum", grid, axes, torch.add, wire_dtype, **step)

    def pmax(self, grid, axes, **step):
        """All-reduce max over ``axes``; ``step`` as for :meth:`psum`."""
        return self._reduce("pmax", grid, axes, torch.maximum, **step)

    def ppermute(self, grid, axis: str, perm, prepare=None, lane="comm", **step):
        """Point-to-point along ``axis``: position ``dst`` receives position
        ``src``'s value for each ``(src, dst)`` of ``perm``, which must be a
        permutation of the axis. Between processes the value is sent.
        ``prepare`` maps each payload before it travels (on the lane: a cast
        to the wire dtype); ``step`` as for :meth:`psum`."""
        size = self.shape[axis]
        if sorted(s for s, _ in perm) != list(range(size)) or \
                sorted(d for _, d in perm) != list(range(size)):
            raise ValueError(f"perm {perm} is not a permutation of the {size}-rank "
                             f"{axis!r} axis")
        src_of = {d: s for s, d in perm}

        def src(li, ti):
            return (src_of[li], ti) if axis == "led" else (li, src_of[ti])

        def start():
            sent = self.grid(lambda li, ti: None)
            for li, ti in self.local_ranks:
                self._hand_over(grid[li][ti], lane=lane)
                sent[li][ti] = grid[li][ti] if prepare is None else prepare(grid[li][ti])
            if self.transport is None:
                return sent
            pairs = [(src(li, ti), (li, ti)) for li in range(self.shape["led"])
                     for ti in range(self.shape["tile"])]
            return self.transport.start_exchange(self, sent, pairs, _key(step))

        def moved(x, li, ti):
            dst = self.devices[li][ti]
            if x.device == dst or self._bufs is None:
                return x.to(dst)
            # Over buffers made once: one pair a chunk parity, since chunk
            # c+1's halo is sent while chunk c's may still be read.
            return self._landed((*_key(step), src(li, ti), (li, ti)), x, dst, x.dtype)

        def finish(started):
            if self.transport is None:
                out = self.grid(lambda li, ti: moved(started[src(li, ti)[0]][src(li, ti)[1]],
                                                     li, ti))
            else:
                received = self.transport.finish(started)
                out = self.grid(lambda li, ti: moved(received[(li, ti)], li, ti))
            for li, ti in self.local_ranks:
                self._hand_over(out[li][ti], rank=(li, ti))
            return out

        payload = self.local(grid)
        if prepare is not None:
            payload = prepare(payload.to("meta"))
        if self._flagged and self.transport is None:
            if prepare is not None:
                raise ValueError("the peer route pulls payloads as their ranks wrote them")
            pending = self._pulled(grid, axis, src, payload, lane, step)
            return pending if not step.get("wait", True) else pending.result()
        if prepare is None and self.transport is None and all(
                self.devices[li][ti] == self.devices[src(li, ti)[0]][src(li, ti)[1]]
                for li, ti in self.local_ranks):
            idx = self._unmoved("ppermute", (axis,), payload, lane, step.get("chunk"),
                                step.get("after", ()), step.get("what", ""))
            pending = Pending(idx, grid=finish(start()))
            return pending if not step.get("wait", True) else pending.result()
        return self._collective("ppermute", (axis,), payload, start, finish, lane=lane, **step)


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as float32 (planes, rows, cols): the same bytes (a
    complex row of n values is 2n or 4n floats)."""
    w = t if t.dtype == torch.float32 else t.view(torch.float32)
    return w if w.dim() == 3 else w.unsqueeze(0)


def _key(step: dict) -> tuple:
    """The key of a collective's buffers in a sweep over buffers made once:
    its label and its chunk's parity (chunk c+1's collective is issued while
    chunk c's result may still be read)."""
    return step.get("what", ""), (step.get("chunk") or 0) % 2


def peer_route(mesh: Mesh) -> str:
    """The rule for how a sweep over buffers made once orders and moves its
    work between the cards of this process: ``"one card"`` where its ranks
    share one card (nothing crosses a card); ``"peer"`` where it has
    several and every pair reads the other's memory (:attr:`Mesh.
    peer_access`) and no transport joins other processes (payloads read in
    place, the halo pulled, order kept with flags; :class:`Mesh`); else
    ``"copy"`` (events and copies between cards). Nothing is tried and
    caught: the mesh's cards decide. ``peer_route.force_flags`` (tests only;
    nothing on the main path sets it) gives one card ``"streams"``: its
    streams ordered with flags as the peer route orders cards, the halo
    pulled."""
    if len(mesh.cards()) > 1:
        return "peer" if mesh.peer_access else "copy"
    return "streams" if peer_route.force_flags and mesh.transport is None else "one card"


peer_route.force_flags = False     # tests only: flags between the streams of one card


def make_mesh(led: int | None = None, tile: int = 1, devices=None,
              serialize_streams: bool = False) -> Mesh:
    """Build an ``led × tile`` mesh of ranks.

    ``devices`` is a list of devices, one per rank, in which a device may
    appear more than once; it is checked like ``fpm_tpu.parallel.make_mesh``
    checks its device list (``led`` defaults to ``len(devices) // tile``; a
    mesh larger than the list is an error). With ``devices=None`` the ranks
    are placed round-robin over the visible CUDA devices — on a one-GPU
    machine all ranks share it — and without a CUDA device that raises.

    Under ``torch.distributed`` the mesh spans the processes
    (``parallel.multihost.process_mesh``): each process owns ``led·tile /
    processes`` ranks, and ``devices`` lists this process's devices.
    ``serialize_streams``: tests only (:class:`Mesh`).
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from .multihost import process_mesh

        return process_mesh(led, tile, devices, serialize_streams)
    round_robin = devices is None
    if round_robin:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if led is None:
        led = n // tile if tile > 0 else 0
    if led < 1 or tile < 1:
        raise ValueError(f"mesh axes must be >= 1, got led={led} tile={tile} "
                         f"({n} devices available)")
    if round_robin:
        devices = [devices[i % n] for i in range(led * tile)]
    elif led * tile > n:
        raise ValueError(f"mesh led={led} x tile={tile} needs {led * tile} devices; "
                         f"only {n} available")
    return Mesh([devices[li * tile:(li + 1) * tile] for li in range(led)],
                serialize_streams=serialize_streams)
