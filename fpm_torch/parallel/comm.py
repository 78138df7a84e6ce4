"""Per-sweep communication accounting for the sharded sweeps: the analytic
half of ``fpm_tpu.parallel.comm``.

From the same static geometry the sharded sweeps use, this module computes
which collectives one sweep issues and how many bytes each moves:

* ``led_shard_comm``  — the chunked Gauss–Seidel-over-Jacobi sweep
  (parallel/led_shard.py): per chunk, one object-increment ``psum``
  (Nlarge² complex), one pupil-consensus ``psum`` (Np² complex), and the
  two scalar metric ``psum``s.
* ``tile_shard_comm`` — the spectrum-row-sharded sweep
  (parallel/tile_shard.py): per chunk, forward + reverse halo ``ppermute``
  (Np·Nlarge complex each, point to point), one extended-block ``psum`` over
  the led axis ((S+Np)·Nlarge complex), the scalar ``pmax`` realizing the
  reference's full-spectrum ``cv::minMaxLoc`` (fpmMain.cpp:467), and the
  pupil consensus.

Byte counts are *payload* bytes. For a p-device ring all-reduce each device
sends and receives ``2·(p−1)/p × payload`` bytes (reduce-scatter +
all-gather); a ``ppermute`` moves the payload once per device.
``project_weak_scaling`` combines these with a measured per-device compute
time and a per-device link bandwidth the caller supplies.

The model is checked against what a run really issued by
:func:`counted_mismatches`, which compares it with the calls and payload
bytes the mesh counted (``Mesh.counts``) — the port's counterpart of the JAX
package's inventory of the compiled program's collectives — and the order
of the issued work by :func:`consensus_schedule_check`, which reads the
steps a sweep enqueued (``Mesh.schedule``) where the JAX package reads the
scheduled program. :func:`ordered_before` and :func:`card_edges` read the
same steps with how each was ordered on the cards (``Mesh.edges``: events,
and the flags of the peer route between the cards of one process).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Collective:
    op: str            # 'psum' | 'ppermute' | 'pmax'
    axis: str          # mesh axis/axes
    payload_bytes: int  # bytes reduced/moved per call (one replica's payload)
    calls_per_sweep: int
    what: str          # which solver quantity

    @property
    def bytes_per_sweep(self) -> int:
        return self.payload_bytes * self.calls_per_sweep


def _ring_allreduce_device_bytes(payload: int, p: int) -> int:
    """Bytes sent per device for a p-device ring all-reduce of ``payload``."""
    if p <= 1:
        return 0
    return math.ceil(2 * (p - 1) / p * payload)


def led_shard_comm(
    n_large: int,
    np_size: int,
    k: int,
    chunk_size: int,
    n_led: int,
    dtype_bytes: int = 8,
) -> dict:
    """Collectives one LED-sharded sweep issues (parallel/led_shard.py).

    Mirrors ``reconstruct_led_sharded``'s chunking: the requested chunk is
    rounded up to a multiple of the led-axis size, giving
    ``ceil(K/chunk_eff)`` chunks per sweep, each ending in one object psum +
    one pupil psum (+ 2 scalar metric psums).
    """
    c_req = chunk_size if chunk_size > 0 else k
    c_eff = -(-c_req // n_led) * n_led
    n_chunks = -(-k // c_eff)
    scalar = 4  # f32 metric scalars
    cols = [
        Collective("psum", "led", n_large * n_large * dtype_bytes, n_chunks,
                   "object-spectrum increment consensus"),
        Collective("psum", "led", np_size * np_size * dtype_bytes, n_chunks,
                   "pupil increment consensus"),
        Collective("psum", "led", scalar, 2 * n_chunks, "metrics"),
    ]
    return _summarize(cols, axis_sizes={"led": n_led}, n_chunks=n_chunks)


def tile_shard_comm(
    n_large: int,
    np_size: int,
    k: int,
    n_led: int,
    n_tile: int,
    chunk_size: int = 0,
    dtype_bytes: int = 8,
) -> dict:
    """Collectives one tile-sharded sweep issues (parallel/tile_shard.py).

    Mirrors ``partition_leds_by_tile``'s chunking: ``ceil(K/chunk_size)``
    chunks per sweep (``chunk_size=0`` = one whole-sweep chunk), and *every*
    collective below — forward halo, object consensus, reverse halo, the
    global-max pmax, pupil consensus, metrics — is issued once per chunk
    (the chunk loop of ``_tile_sweep``), not once per sweep.
    """
    s = n_large // n_tile
    c = chunk_size if chunk_size > 0 else k
    n_chunks = -(-k // c)
    scalar = 4
    halo = np_size * n_large * dtype_bytes
    cols = [
        Collective("ppermute", "tile", halo, n_chunks,
                   "forward halo (the Np rows following the tile's block)"),
        Collective("psum", "led", (s + np_size) * n_large * dtype_bytes, n_chunks,
                   "extended-block object increment consensus"),
        Collective("ppermute", "tile", halo, n_chunks,
                   "reverse halo (increments in halo rows)"),
        Collective("pmax", "tile", scalar, n_chunks,
                   "global max|O| (the reference's cv::minMaxLoc, fpmMain.cpp:467)"),
        Collective("psum", "led,tile", np_size * np_size * dtype_bytes, n_chunks,
                   "pupil increment consensus"),
        Collective("psum", "led,tile", scalar, 2 * n_chunks, "metrics"),
    ]
    return _summarize(cols, axis_sizes={"led": n_led, "tile": n_tile},
                      n_chunks=n_chunks)


def _summarize(cols: list[Collective], axis_sizes: dict[str, int], n_chunks: int) -> dict:
    """Totals + per-device wire bytes under the ring-collective model."""
    per_device = 0
    for c in cols:
        if c.op in ("psum", "pmax"):
            p = math.prod(axis_sizes[a] for a in c.axis.split(","))
            per_device += _ring_allreduce_device_bytes(c.payload_bytes, p) * c.calls_per_sweep
        else:  # ppermute: each device sends its payload once per call
            # (a 1-device axis degenerates to a local copy — no wire bytes)
            if all(axis_sizes[a] > 1 for a in c.axis.split(",")):
                per_device += c.payload_bytes * c.calls_per_sweep
    return {
        "collectives": [dataclasses.asdict(c) for c in cols],
        "n_chunks_per_sweep": n_chunks,
        "payload_bytes_per_sweep": sum(c.bytes_per_sweep for c in cols),
        "device_wire_bytes_per_sweep": per_device,
    }


def project_weak_scaling(
    compute_s_per_sweep: float,
    device_wire_bytes: float,
    link_bandwidth_gbs: float,
    overlap: float = 0.0,
    pipelined: bool = False,
    n_chunks: int = 1,
) -> dict:
    """Weak-scaling efficiency estimate at fixed per-device work.

    ``compute_s_per_sweep`` is the measured single-device sweep time for the
    per-device workload; ``device_wire_bytes`` comes from the comm model
    above at the target device count. ``link_bandwidth_gbs`` is the
    per-device bandwidth of the link the collectives ride, in GB/s: a
    required argument, to be given from a measurement or the data sheet of
    the machine at hand. ``overlap`` ∈ [0, 1] is the fraction of comm hidden
    under compute (0 = fully exposed, the pessimistic bound).

    ``pipelined`` models the one-chunk-stale consensus sweep
    (``stale_consensus``, parallel/led_shard.py): chunk c's all-reduce has
    no data dependence on chunk c+1's compute, so per-chunk comm can overlap
    per-chunk compute — per sweep of ``n_chunks`` chunks,
    ``t = cc + max(cc, mc)·(n_chunks−1) + mc`` with ``cc``/``mc`` the
    per-chunk compute/comm times (prologue computes, epilogue communicates).
    """
    t_comm = device_wire_bytes / (link_bandwidth_gbs * 1e9)
    if pipelined:
        n = max(1, n_chunks)
        cc = compute_s_per_sweep / n
        mc = t_comm / n
        t_total = cc + max(cc, mc) * (n - 1) + mc
    else:
        t_total = compute_s_per_sweep + (1.0 - overlap) * t_comm
    return {
        "compute_s": compute_s_per_sweep,
        "comm_s": t_comm,
        "efficiency": compute_s_per_sweep / t_total,
        "link_bandwidth_gbs": link_bandwidth_gbs,
        "overlap": overlap,
        "pipelined": pipelined,
    }


def counted_mismatches(counts: dict, model: dict, sweeps: int = 1,
                       halo_hops: int = 1) -> list[str]:
    """Differences between a mesh's counted collectives and the model.

    ``counts`` is ``Mesh.counts`` after ``sweeps`` sweeps; ``model`` the dict
    of :func:`led_shard_comm` or :func:`tile_shard_comm` for that run. Per
    (op, axis), calls and payload bytes must be equal. A halo of Np rows that
    spans ``halo_hops`` tiles is moved by that many ``ppermute`` calls whose
    payloads add up to the model's one: its calls are scaled, its bytes not.
    Returns one line per difference (empty = equal).
    """
    want: dict[tuple[str, str], list[int]] = {}
    for c in model["collectives"]:
        slot = want.setdefault((c["op"], c["axis"]), [0, 0])
        hops = halo_hops if c["op"] == "ppermute" else 1
        slot[0] += c["calls_per_sweep"] * hops * sweeps
        slot[1] += c["payload_bytes"] * c["calls_per_sweep"] * sweeps
    got = {key: [v["calls"], v["payload_bytes"]] for key, v in counts.items()}
    return [f"{op} over {axis}: counted (calls, bytes) {got.get((op, axis))}, "
            f"model {want.get((op, axis))}"
            for op, axis in sorted(set(want) | set(got))
            if got.get((op, axis)) != want.get((op, axis))]


# The steps of a sharded sweep (``Mesh.schedule``) that form a chunk's
# consensus, and its compute (kernel K3, or the eager increments).
CONSENSUS_OPS = ("psum object increments", "psum pupil increments")
COMPUTE_OP = "increments"


def _ancestors(schedule, roots) -> set[int]:
    """Every step that the steps ``roots`` wait on, directly or through
    others: the steps named in ``waits_on`` and, on a stream, every earlier
    step of that stream."""
    before: dict[int, list[int]] = {}
    last: dict[str, int] = {}
    for i, step in enumerate(schedule):
        before[i] = list(step.waits_on) + ([last[step.stream]] if step.stream in last else [])
        last[step.stream] = i
    seen, todo = set(), list(roots)
    while todo:
        for j in before[todo.pop()]:
            if j not in seen:
                seen.add(j)
                todo.append(j)
    return seen


def consensus_schedule_check(schedule) -> dict:
    """Schedule-level evidence for the stale-consensus overlap claim: the
    counterpart of ``fpm_tpu.parallel.comm.consensus_schedule_check``, which
    reads the compiled program's chunk-loop body, on ``Mesh.schedule`` (the
    steps one sweep enqueued, in order, each with its stream and the steps
    it waits on).

    For every pair of consecutive chunks c, c+1 the consensus of chunk c
    (its object- and pupil-increment psums) must be *issued before* chunk
    c+1's compute: enqueued before chunk c+1's first increments step, and
    no increments step of chunk c+1 waits on it, through an event or the
    order of a stream. Then on the card the two run at once. The fresh
    sweep fails this, since chunk c+1 computes from chunk c's applied
    consensus.

    Returns ``{"body", "consensus_idx", "first_dft_idx", "consensus_bytes",
    "issued_before_compute"}``: the chunks and ranks read, the schedule
    index of chunk 0's first consensus step and of chunk 1's first
    increments step, one rank's payload bytes of chunk 0's consensus, and
    whether the claim holds on every pair. Raises ValueError where there is
    no pair (a one-chunk sweep, which has no loop).
    """
    chunks = sorted({s.chunk for s in schedule if s.op == COMPUTE_OP})
    cons = {c: [i for i, s in enumerate(schedule) if s.chunk == c and s.op in CONSENSUS_OPS]
            for c in chunks}
    comp = {c: [i for i, s in enumerate(schedule) if s.chunk == c and s.op == COMPUTE_OP]
            for c in chunks}
    if len(chunks) < 2 or not cons[chunks[0]]:
        raise ValueError(
            "no two chunks with a consensus and increments found — is this the "
            "schedule of a multi-chunk sharded sweep?")
    ok = True
    for c, nxt in zip(chunks, chunks[1:]):
        waited = _ancestors(schedule, comp[nxt])
        ok = ok and max(cons[c]) < min(comp[nxt]) and not waited.intersection(cons[c])
    ranks = sorted({s.rank for s in schedule if s.op == COMPUTE_OP})
    return {
        "body": f"{len(chunks)} chunks on {len(ranks)} ranks, "
                f"streams {sorted({schedule[i].stream for c in chunks for i in comp[c]})}",
        "consensus_idx": min(cons[chunks[0]]),
        "first_dft_idx": min(comp[chunks[1]]),
        "consensus_bytes": sum(schedule[i].nbytes for i in cons[chunks[0]]),
        "issued_before_compute": ok,
    }


def ordered_before(schedule, edges) -> list[set[int]]:
    """For each step of a sweep (``Mesh.schedule`` with ``Mesh.edges``),
    the steps the cards finish before it starts: through the events it
    waited on, the flags it polled and the order of its stream (the stream
    of that label on its card; a step of no card is on every card's), and so
    on back. Only steps that enqueued work take part: one that enqueued
    nothing (a collective that moved nothing) orders nothing itself, and
    the steps waiting on it name, in their edges, the steps it stood for."""
    cards = sorted({e.card for e in edges if e.card is not None})
    last: dict = {}
    masks: list[int] = []
    for i, (step, e) in enumerate(zip(schedule, edges)):
        mask = 0
        if e.work:
            preds = [*e.events, *e.flags]
            for key in ((c, step.stream) for c in (cards if e.card is None else [e.card])):
                if key in last:
                    preds.append(last[key])
                last[key] = i
            for j in preds:
                mask |= masks[j] | (1 << j)
        masks.append(mask)
    return [{j for j in range(i) if mask >> j & 1} for i, mask in enumerate(masks)]


def card_edges(schedule, edges) -> dict:
    """The event edges between cards that one sweep's schedule holds
    (``Mesh.schedule`` with ``Mesh.edges``): for each step, each pair of a
    card it runs on and a card of a step whose events it waited on, where
    the two differ, and two for each payload it copied between cards
    (ordered on both). By where they lie: ``fork`` (each card's sweep start
    after :attr:`Mesh.home`'s stream), ``join``, ``chunk_loop`` and
    ``other``; and ``flags``, the flags polled between cards or streams. On
    the peer route a sweep holds at most 2·(cards − 1), none in the chunk
    loop; on the copy route the fork and join of its streams are not steps
    of the schedule and are not counted."""
    cards = sorted({e.card for e in edges if e.card is not None})

    def on(e):
        return cards if e.card is None else [e.card]

    out = {"fork": 0, "join": 0, "chunk_loop": 0, "other": 0, "flags": 0}
    for step, e in zip(schedule, edges):
        n = sum(1 for j in e.events for a in on(e) for b in on(edges[j]) if a != b) + 2 * e.copies
        where = ("chunk_loop" if step.chunk is not None else "fork" if step.op == "sweep start"
                 else "join" if step.op == "join" else "other")
        out[where] += n
        out["flags"] += len(e.flags)
    out["total"] = out["fork"] + out["join"] + out["chunk_loop"] + out["other"]
    return out

