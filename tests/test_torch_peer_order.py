"""The peer route of the one-process sweep over several cards
(``fpm_torch.parallel.mesh.peer_route``), held on the CPU with the plain
versions of its kernels and no card.

A mesh whose ranks sit on distinct CPU "cards" (``torch.device("cpu",
i)``, which share the host's memory as cards with peer access share
theirs) runs the sweep over buffers made once exactly as the card does on
several cards: every consensus reads its peers' payloads where K3 wrote
them, the halo is pulled, and the order between cards is kept by flags.
``Mesh.schedule`` with ``Mesh.edges`` (``comm.ordered_before``,
``comm.card_edges``) then shows:

* RAW: each consensus of chunk c is ordered after every K3 of chunk c
  whose payload it reads (the pupil step also after the object steps whose
  max|O| it reads; a halo pull after the object step that wrote the rows
  it pulls);
* WAR: each K3 that rewrites its parity buffer (chunk c) is ordered after
  every consensus of chunk c - 2 that read it;
* ``consensus_schedule_check`` gives ``issued_before_compute`` = stale;
* no event edge between cards lies inside the chunk loop: the fork and the
  join, one each per card but the first.

On the CPU steps run in the order they are enqueued, so the plain wait
raises where a flag it polls was not posted before it: every run here is
also a check that the flags come in an order the cards can keep. The
results are bitwise the host loop's and the one-card mesh's (the same
operations on the same values), the consumer's bf16 rounding of an f32
payload is bitwise the sender's cast, and the peer route stays within the
limits of tests/test_torch_sweep_replay.py against fpm_tpu's sharded
sweeps. Inputs from a seed with NumPy (the dataset of
tests/test_sharding.py, Np 16).
"""

import jax
import numpy as np
import pytest
import torch

import fpm_tpu.parallel as jpar
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.ops import kernels
from fpm_torch.parallel import comm, graph, led_shard, make_mesh, tile_shard
from fpm_torch.parallel.mesh import Mesh, peer_route

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) JAX devices")

SWEEPS = 3
KERNEL_ROUTE = dict(use_pallas=True, dtype="complex64", chunk_size=8)
# (led, tile, cards): each rank a card of its own, and (2, 2) on two cards.
LAYOUTS = [(4, 1, 4), (2, 2, 4), (1, 4, 4), (2, 2, 2)]
IDS = [f"{led}x{tile}-on-{cards}" for led, tile, cards in LAYOUTS]


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=5)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-30)


def cards_of(led, tile, cards):
    """Rank (li, ti)'s CPU card: ranks in grid order, round-robin."""
    return [torch.device("cpu", i % cards) for i in range(led * tile)]


def prepared(ds, led, tile, cards=0, **kw):
    """(mesh, route, body(bufs) -> mets) on ``cards`` CPU cards (0: one)."""
    devices = cards_of(led, tile, cards) if cards else ["cpu"] * (led * tile)
    mesh = make_mesh(led, tile, devices=devices)
    if tile == 1:
        route, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)
        return mesh, route, lambda bufs: led_shard._sharded_sweep(mesh, route, opts=opts,
                                                                  bufs=bufs)
    route, opts, s = tile_shard.prepare_tile_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)
    return mesh, route, lambda bufs: tile_shard._tile_sweep(mesh, route, opts=opts, s=s,
                                                            bufs=bufs)


def sweeps(ds, led, tile, cards, bufs, **kw):
    """SWEEPS sweeps of a fresh run; (mesh, metrics a sweep, state)."""
    mesh, route, body = prepared(ds, led, tile, cards, **kw)
    mets = [body(bufs).clone() for _ in range(SWEEPS)]
    whole = mesh.local(route.obj) if tile == 1 else tile_shard._fetch(mesh, route.obj)
    return mesh, mets, route.final_state(mesh, whole)


def captured_schedule(ds, led, tile, cards, stale, **kw):
    """The mesh after the warm-up and a second sweep over the same
    buffers: its schedule is the one a capture records."""
    mesh, _, body = prepared(ds, led, tile, cards, **KERNEL_ROUTE, stale_consensus=stale, **kw)
    bufs = graph.SweepBuffers()
    body(bufs)
    bufs.frozen = True
    body(bufs)
    return mesh


def reads(mesh, i, hops):
    """The ranks whose K3 payloads consensus step ``i`` reads, by the
    mesh's shape alone: the LED axis the led group of each tile its card
    holds; the tile axis's object step those tiles' groups and, for each
    halo hop j, tile i−j's; its pupil step every rank."""
    n_led, n_tile = mesh.shape["led"], mesh.shape["tile"]
    step, (_, ranks) = mesh.schedule[i], mesh.cards()[mesh.edges[i].card]
    tiles = {ti for _, ti in ranks}
    if step.op == "consensus pupil":
        return {(li, ti) for li in range(n_led) for ti in range(n_tile)}
    shifts = range(hops + 1) if step.op == "consensus object" else [0]
    return {(li, (ti - j) % n_tile) for ti in tiles for j in shifts for li in range(n_led)}


CONSENSUS = ("consensus", "consensus object", "consensus pupil")


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile,cards", LAYOUTS, ids=IDS)
def test_the_peer_route_orders_every_read_after_its_write_and_every_rewrite_after_its_reads(
        ds, led, tile, cards, stale):
    mesh = captured_schedule(ds, led, tile, cards, stale)
    assert peer_route(mesh) == "peer" and len(mesh.cards()) == cards
    sched, edges = mesh.schedule, mesh.edges
    before = comm.ordered_before(sched, edges)
    hops = len(tile_shard._halo_hops(ds.cfg.np_size, ds.cfg.n_large // tile)) if tile > 1 else 0
    k3 = {(s.chunk, s.rank): i for i, s in enumerate(sched) if s.op == "increments"}
    cons = [i for i, s in enumerate(sched) if s.op in CONSENSUS]
    chunks = sorted({c for c, _ in k3})
    assert len(chunks) == 3 and cons
    for i in cons:
        step = sched[i]
        for r in reads(mesh, i, hops):                                      # RAW
            assert k3[(step.chunk, r)] in before[i], (step, r)
        if step.op == "consensus pupil":        # max|O| of its first rank's row of tiles
            li0 = mesh.cards()[edges[i].card][1][0][0]
            row = {mesh.devices[li0][ti] for ti in range(mesh.shape["tile"])}
            made = [j for j, s in enumerate(sched) if s.op == "consensus object"
                    and s.chunk == step.chunk and mesh.cards()[edges[j].card][0] in row]
            assert made and all(j in before[i] for j in made), step
    for (c, r), i in k3.items():                                            # WAR
        if c < 2:
            continue
        readers = [j for j in cons if sched[j].chunk == c - 2 and r in reads(mesh, j, hops)]
        assert readers and all(j in before[i] for j in readers), (c, r)
    n_tile, first_pull = mesh.shape["tile"], {}
    for i, step in enumerate(sched):
        if step.op.startswith("pull"):
            first_pull.setdefault((step.chunk, edges[i].card), i)
    for (c, card), i in first_pull.items():                                # halo RAW
        made = c - (2 if stale else 1)      # the object step whose rows chunk c pulls
        sources = {mesh.devices[li][(ti + 1) % n_tile] for li, ti in mesh.cards()[card][1]}
        writers = [j for j, s in enumerate(sched) if s.op == "consensus object"
                   and s.chunk == made and mesh.cards()[edges[j].card][0] in sources]
        assert made < 0 or (writers and all(j in before[i] for j in writers)), (c, card)
    assert (tile > 1) == bool(first_pull)
    assert comm.consensus_schedule_check(sched)["issued_before_compute"] is stale


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile,cards", LAYOUTS, ids=IDS)
def test_no_event_edge_between_cards_lies_inside_the_chunk_loop(ds, led, tile, cards, stale):
    """Only the fork and the join cross cards: one each per card but the
    first, 2·(cards − 1) a sweep; every order between cards in the chunk
    loop is a flag, and every flag polled was posted by a step that ran
    on another card. The host loop on the same cards (the copy route)
    holds events and copies between cards in its chunk loop."""
    mesh = captured_schedule(ds, led, tile, cards, stale)
    got = comm.card_edges(mesh.schedule, mesh.edges)
    assert got["chunk_loop"] == got["other"] == 0
    assert got["fork"] == got["join"] == cards - 1
    assert got["total"] == 2 * (cards - 1) and got["flags"] > 0
    for step, e in zip(mesh.schedule, mesh.edges):
        assert all(mesh.edges[j].card != e.card for j in e.flags)
        if step.chunk is not None:
            assert all(mesh.edges[j].card == e.card for j in e.events)
    host, _, body = prepared(ds, led, tile, cards, **KERNEL_ROUTE, stale_consensus=stale)
    body(None)
    walked = comm.card_edges(host.schedule, host.edges)
    assert walked["chunk_loop"] > 0 and walked["flags"] == 0


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile,cards", LAYOUTS, ids=IDS)
def test_the_sweep_over_buffers_with_payloads_in_place_is_bitwise_the_host_loop(
        ds, led, tile, cards, stale):
    """Three sweeps on the peer route against three of the host loop on the
    same cards (payloads copied) and three on one card: the state after
    them and every sweep's metrics, bitwise."""
    kw = dict(KERNEL_ROUTE, stale_consensus=stale)
    _, want_mets, want = sweeps(ds, led, tile, 0, None, **kw)
    for bufs in (None, graph.SweepBuffers()):
        _, got_mets, got = sweeps(ds, led, tile, cards, bufs, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got_mets, want_mets))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile,cards", [(4, 1, 4), (2, 2, 4), (2, 2, 2)],
                         ids=["4x1-on-4", "2x2-on-4", "2x2-on-2"])
def test_every_epoch_is_read_on_its_own_card_and_no_flag_read_names_it(ds, monkeypatch, led,
                                                                        tile, cards, stale):
    """What lets the epoch kernel order its word at gpu scope alone: in
    SWEEPS sweeps of the peer route over buffers, every ``peer_wait`` and
    every ``peer_post`` is handed as ``words`` (whose word 0, the epoch,
    it reads) the flag block of the card of the step it guards; every
    flag a wait polls is a word 1..FLAG_SIGNALS of a card's block, never a
    word 0; and each card's block is bumped by ``peer_epoch`` once a
    sweep. After them every card's epoch is SWEEPS, and the high word of
    every posted flag is its card's epoch."""
    mesh, route, body = prepared(ds, led, tile, cards, **KERNEL_ROUTE, stale_consensus=stale)
    steps, calls = [], []

    def guarded(method):
        def run(self, idx, *args, **kw):
            steps.append(idx)
            try:
                return method(self, idx, *args, **kw)
            finally:
                steps.pop()
        return run

    def recorded(name, wrapper):
        def run(*args, **kw):
            calls.append((name, steps[-1] if steps else None, args))
            return wrapper(*args, **kw)
        return run

    for method in ("_wait", "_post"):
        monkeypatch.setattr(Mesh, method, guarded(getattr(Mesh, method)))
    for name in ("peer_epoch", "peer_post", "peer_wait"):
        monkeypatch.setattr(kernels, name, recorded(name, getattr(kernels, name)))
    bufs = graph.SweepBuffers()
    for _ in range(SWEEPS):
        body(bufs)
    blocks = mesh._flags
    assert peer_route(mesh) == "peer" and len(blocks) == cards
    assert {name for name, _, _ in calls} == {"peer_epoch", "peer_post", "peer_wait"}
    for name, idx, args in calls:
        if name == "peer_epoch":
            continue
        words = args[-1] if name == "peer_wait" else args[0]
        assert words is blocks[mesh.edges[idx].card], (name, mesh.schedule[idx])
        if name == "peer_wait":
            for block, slot, _ in args[0]:
                assert any(block is b for b in blocks)
                assert 0 <= slot < kernels.FLAG_SIGNALS     # the word 1 + slot
    bumped = [args[0] for name, _, args in calls if name == "peer_epoch"]
    assert len(bumped) == SWEEPS * cards
    assert all(sum(w is b for w in bumped) == SWEEPS for b in blocks)
    for b in blocks:
        assert int(b[0]) == SWEEPS
        posted = b[1:][b[1:] != 0]
        assert posted.numel() > 0 and torch.all(posted >> 32 == SWEEPS)


@pytest.mark.parametrize("kw", [dict(KERNEL_ROUTE, comm_precision="bf16"),
                                dict(dtype="complex128", chunk_size=8)],
                         ids=["bf16-wire", "complex128-eager"])
@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_the_peer_route_on_the_other_routes_is_bitwise_the_host_loop(ds, led, tile, kw):
    """The bf16 wire (each card rounds its peers' f32 payloads itself) and
    the complex route (the plain consensus), stale, against the one-card
    host loop."""
    kw = dict(kw, stale_consensus=True)
    _, want_mets, want = sweeps(ds, led, tile, 0, None, **kw)
    mesh, got_mets, got = sweeps(ds, led, tile, led * tile, graph.SweepBuffers(), **kw)
    assert peer_route(mesh) == "peer" and any(e.flags for e in mesh.edges)
    assert all(torch.equal(a, b) for a, b in zip(got_mets, want_mets))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flags_of_one_card_order_its_streams_bitwise_the_default(ds, monkeypatch):
    """``peer_route.force_flags`` (tests only): on one card every order
    between its streams is a flag and the halo is pulled; bitwise the
    default, and no event edge joins two streams in the chunk loop."""
    kw = dict(KERNEL_ROUTE, stale_consensus=True)
    _, want_mets, want = sweeps(ds, 2, 2, 0, graph.SweepBuffers(), **kw)
    monkeypatch.setattr(peer_route, "force_flags", True)
    mesh, got_mets, got = sweeps(ds, 2, 2, 0, graph.SweepBuffers(), **kw)
    assert peer_route(mesh) == "streams"
    assert all(torch.equal(a, b) for a, b in zip(got_mets, want_mets))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    sched, edges = mesh.schedule, mesh.edges
    assert any(s.op.startswith("pull") for s in sched)
    for i, e in enumerate(edges):
        if sched[i].chunk is not None:
            assert all(sched[j].stream == sched[i].stream for j in e.events)
    assert comm.card_edges(sched, edges)["total"] == 0


def test_the_route_is_fixed_by_the_mesh(monkeypatch):
    """Several CPU cards share the host's memory: the peer route; one card:
    nothing crosses a card; a transport between processes keeps the copy
    route. (CUDA meshes are built here without a card: their streams
    serialized, one card, no peer access asked.)"""
    assert peer_route(make_mesh(2, 1, devices=cards_of(2, 1, 2))) == "peer"
    assert peer_route(make_mesh(2, 1, devices=["cpu"] * 2)) == "one card"
    cuda = Mesh([[torch.device("cuda", 0)] * 2], serialize_streams=True)
    assert peer_route(cuda) == "one card" and not cuda.peer_access
    over = Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)], [None, None]],
                transport=object())
    assert peer_route(over) == "copy" and not over.peer_access
    monkeypatch.setattr(peer_route, "force_flags", True)
    assert peer_route(cuda) == "streams"
    assert peer_route(make_mesh(2, 1, devices=cards_of(2, 1, 2))) == "peer"
    assert "peer route between them" in make_mesh(2, 1, devices=cards_of(2, 1, 2)).describe()


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_the_entry_point_on_cpu_cards_walks_the_host_loop_bitwise_one_card(ds, led, tile):
    fn = led_shard.reconstruct_led_sharded if tile == 1 else tile_shard.reconstruct_tile_sharded
    kw = dict(iterations=2, chunk_size=8, use_pallas=True, stale_consensus=True)
    one = fn(ds.images, ds.geom, ds.cfg, mesh=make_mesh(led, tile, devices=["cpu"] * (led * tile)),
             **kw)
    many = fn(ds.images, ds.geom, ds.cfg, mesh=make_mesh(led, tile,
                                                         devices=cards_of(led, tile, led * tile)),
              **kw)
    assert many.replay is None
    assert np.array_equal(many.obj_f_centered, one.obj_f_centered)
    assert np.array_equal(many.pupil, one.pupil)


@pytest.mark.parametrize("count", [1, 3, 8])
def test_the_consumers_bf16_rounding_of_a_peers_payload_is_the_senders_cast(count):
    """``consensus_led_plain`` and ``consensus_tile_object_plain`` on the
    bf16 wire: f32 payloads rounded by the consumer, bitwise the same
    payloads cast to bf16 by their senders (both round to nearest even);
    values from a seed, some on the ties of bf16."""
    r = np.random.default_rng(count)
    o = torch.from_numpy(r.standard_normal((2, 12, 12)).astype(np.float32))
    pc = torch.from_numpy(r.standard_normal((2, 4, 4)).astype(np.float32))

    def payload(*shape):
        x = r.standard_normal((2, *shape)).astype(np.float32)
        bits = x.view(np.uint32)
        bits[..., ::3] = (bits[..., ::3] & ~np.uint32(0xFFFF)) | np.uint32(0x8000)   # ties
        return torch.from_numpy(x)

    ds, vs = [payload(12, 12) for _ in range(count)], [payload(4, 4) for _ in range(count)]
    mets = [torch.from_numpy(r.standard_normal(2).astype(np.float32)) for _ in range(count)]
    resid, upd = [m[0] for m in mets], [m[1] for m in mets]
    wire = torch.bfloat16
    consumer = kernels.consensus_led_plain(o, pc, ds, vs, resid, upd, wire=wire, scale=0.5)
    sender = kernels.consensus_led_plain(o, pc, [d.to(wire) for d in ds],
                                         [v.to(wire) for v in vs], resid, upd, wire=wire,
                                         scale=0.5)
    assert all(torch.equal(a, b) for a, b in zip(consumer, sender))
    hops = [(1, 0, 3)]
    ext = [payload(15, 12)[:, :, :] for _ in range(2 * count)]
    own, halo = ext[:count], ext[count:]
    got = kernels.consensus_tile_object_plain(o, own, [halo], s=12, hops=hops, wire=wire)
    cast = kernels.consensus_tile_object_plain(o, [x.to(wire) for x in own],
                                               [[x.to(wire) for x in halo]], s=12, hops=hops,
                                               wire=wire)
    assert all(torch.equal(a, b) for a, b in zip(got, cast))


def test_the_plain_signal_and_wait_keep_one_sweep_from_the_next():
    """A wait passes once the flag holds its chunk in this epoch (or a
    later chunk), and raises on the CPU before the post and after the next
    epoch starts; a pull copies the rows of a strided view."""
    a, b = kernels.flag_block("cpu"), kernels.flag_block("cpu")
    kernels.peer_epoch(a)
    kernels.peer_epoch(b)
    with pytest.raises(RuntimeError, match="has not posted chunk 0"):
        kernels.peer_wait([(a, 3, 0)], b)
    kernels.peer_post(a, 3, 0)
    kernels.peer_wait([(a, 3, 0)], b)
    kernels.peer_post(a, 3, 2)
    kernels.peer_wait([(a, 3, 1), (a, 3, 2)], b)
    with pytest.raises(RuntimeError, match="has not posted chunk 3"):
        kernels.peer_wait([(a, 3, 3)], b)
    assert int(a[4]) == (1 << 32) | 3
    kernels.peer_epoch(a)
    kernels.peer_epoch(b)
    with pytest.raises(RuntimeError):
        kernels.peer_wait([(a, 3, 0)], b)
    with pytest.raises(ValueError, match="signal"):
        kernels.peer_post(a, kernels.FLAG_SIGNALS, 0)
    src = torch.arange(2 * 7 * 5, dtype=torch.float32).reshape(2, 7, 5)
    dst = torch.empty(2, 3, 5)
    kernels.peer_pull(dst, src[:, :3])
    assert torch.equal(dst, src[:, :3])


@needs_8
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", [(2, 1), (4, 1), (2, 2)])
def test_the_peer_route_stays_within_fpm_tpus_limits(ds, led, tile, stale):
    """The peer route's sweeps (the body over buffers on a card a rank)
    against fpm_tpu's sharded sweeps on the same mesh of virtual devices:
    the limits of tests/test_torch_sweep_replay.py (spectrum 1e-5, pupil
    1e-4, metrics rtol 1e-3, both at ``dft_precision="highest"``)."""
    kw = dict(chunk_size=8, use_pallas=True, stale_consensus=stale, dft_precision="highest")
    _, mets, (obj, pupil) = sweeps(ds, led, tile, led * tile, graph.SweepBuffers(), **kw)
    got = led_shard.result_from(obj, pupil, torch.stack(mets).numpy())
    jfn = jpar.reconstruct_led_sharded if tile == 1 else jpar.reconstruct_tile_sharded
    ref = jfn(ds.images, ds.geom, ds.cfg, iterations=SWEEPS, dtype="complex64",
              mesh=jpar.make_mesh(led=led, tile=tile, devices=jax.devices()[:led * tile]), **kw)
    assert rel(got.obj_f_centered, ref.obj_f_centered) < 1e-5
    assert rel(got.pupil, ref.pupil) < 1e-4
    for key in ("data_residual", "update_norm"):
        np.testing.assert_allclose(got.metrics[key], ref.metrics[key], rtol=1e-3)
