"""The sharded sweep as a body over buffers made once — what
``fpm_torch.parallel.graph`` captures into a CUDA graph and replays on the
card — held on meshes of CPU ranks, where nothing is captured, against the
host loop's sweeps over fresh tensors and against ``fpm_tpu``'s sharded
sweeps on the virtual CPU devices of tests/conftest.py.

Same inputs, made from a seed with NumPy (the dataset of
tests/test_sharding.py, Np 16). The body over buffers must be bitwise the
host loop (the same operations on the same values; only where they write
differs); against fpm_tpu the limits of tests/test_torch_parallel.py: the
kernel route (K3's and the consensus kernels' plain versions here,
fpm_tpu's Pallas kernel in interpret mode) within 1e-5 on the spectrum,
1e-4 on the pupil, metrics rtol 1e-3, at ``dft_precision="highest"`` in
both packages; the complex128 eager route within 1e-10.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import fpm_tpu.parallel as jpar
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.ops import kernels
from fpm_torch.parallel import comm, graph, led_shard, make_mesh, tile_shard
from fpm_torch.parallel.mesh import Mesh

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) JAX devices")

SWEEPS = 3
MESHES = [(2, 1), (4, 1), (2, 2)]


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=5)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-30)


def prepared(ds, led, tile, **kw):
    """(mesh, route, body(bufs) -> mets) of one sharded run on CPU ranks."""
    mesh = make_mesh(led, tile, devices=["cpu"] * (led * tile))
    if tile == 1:
        route, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)
        return mesh, route, lambda bufs: led_shard._sharded_sweep(mesh, route, opts=opts,
                                                                  bufs=bufs)
    route, opts, s = tile_shard.prepare_tile_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)
    return mesh, route, lambda bufs: tile_shard._tile_sweep(mesh, route, opts=opts, s=s,
                                                            bufs=bufs)


def state_of(mesh, route, tile):
    """The run's (spectrum, pupil) as one rank returns them."""
    whole = mesh.local(route.obj) if tile == 1 else tile_shard._fetch(mesh, route.obj)
    return route.final_state(mesh, whole)


def sweeps(ds, led, tile, bufs, n=SWEEPS, **kw):
    """``n`` sweeps of a fresh run: the host loop (``bufs`` None) or the
    body over ``bufs``. Returns (mesh, route, per-sweep metrics, state)."""
    mesh, route, body = prepared(ds, led, tile, **kw)
    mets = [body(bufs).clone() for _ in range(n)]
    return mesh, route, mets, state_of(mesh, route, tile)


KERNEL_ROUTE = dict(use_pallas=True, dtype="complex64")


CHUNKS = {8: 3, 12: 2, 0: 1}      # chunk size: chunks a sweep


@pytest.mark.parametrize("chunk", list(CHUNKS), ids=[f"{n}-chunks" for n in CHUNKS.values()])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", MESHES)
def test_the_body_over_buffers_is_bitwise_the_host_loop(ds, led, tile, stale, chunk):
    """N calls of the body over one set of buffers against N host-loop
    sweeps over fresh tensors: the state after each and every sweep's
    metrics, bitwise; an odd chunk count writes slot 2 at chunk 0, one
    chunk writes slot 1 and is copied back."""
    kw = dict(KERNEL_ROUTE, chunk_size=chunk, stale_consensus=stale)
    _, route, want_mets, want = sweeps(ds, led, tile, None, **kw)
    assert route.n_chunks == CHUNKS[chunk]
    _, _, got_mets, got = sweeps(ds, led, tile, graph.SweepBuffers(), **kw)
    for a, b in zip(got_mets, want_mets):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(dtype="complex128"),
                                dict(KERNEL_ROUTE, comm_precision="bf16")],
                         ids=["complex128-eager", "bf16-wire"])
@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_the_other_routes_over_buffers_are_bitwise_the_host_loop(ds, led, tile, kw):
    """The complex route (its state complex tensors, the plain consensus
    copied into the buffers) and the bf16 wire, stale, 3 chunks."""
    kw = dict(kw, chunk_size=8, stale_consensus=True)
    _, _, want_mets, want = sweeps(ds, led, tile, None, **kw)
    _, _, got_mets, got = sweeps(ds, led, tile, graph.SweepBuffers(), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got_mets, want_mets))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


class Writes(TorchDispatchMode):
    """The storages every operator wrote into (its arguments marked as
    written in its schema) and the storages its outputs were made in."""

    def __init__(self):
        super().__init__()
        self.written, self.made = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        values = list(args) + [kwargs.get(a.name) for a in schema.arguments[len(args):]]
        for arg, value in zip(schema.arguments, values):
            if arg.alias_info is not None and arg.alias_info.is_write:
                for t in (value if isinstance(value, (list, tuple)) else (value,)):
                    if isinstance(t, torch.Tensor):
                        self.written.add(t.untyped_storage().data_ptr())
        if not (schema.returns and any(r.alias_info for r in schema.returns)):
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.made.add(t.untyped_storage().data_ptr())
        return out


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", MESHES)
def test_every_tensor_the_body_writes_is_a_buffer_made_at_its_first_call(ds, led, tile, stale):
    """After the first call the buffers are frozen (a new one would raise),
    and every later call writes only into them or into temporaries it made
    itself (the plain versions' own): each buffer keeps its ``data_ptr``,
    the state grids point at the same tensors after every sweep, and the
    sweep's metrics come back in one tensor."""
    mesh, route, body = prepared(ds, led, tile, **KERNEL_ROUTE, chunk_size=8,
                                 stale_consensus=stale)
    bufs = graph.SweepBuffers()
    mets = body(bufs)
    made = bufs.tensors()
    ptrs = [t.data_ptr() for t in made]
    owned = {t.untyped_storage().data_ptr() for t in made}
    state = [t for grid in (route.obj, route.pupil) for row in grid for t in row]
    bufs.frozen = True
    for _ in range(SWEEPS - 1):
        with Writes() as seen:
            assert body(bufs) is mets
        assert seen.written and seen.written <= owned | seen.made
        assert seen.written & owned
        assert [t.data_ptr() for t in bufs.tensors()] == ptrs
        assert [t for grid in (route.obj, route.pupil) for row in grid for t in row] == state
    assert all(t.untyped_storage().data_ptr() in owned for t in state)


def test_a_buffer_first_asked_for_once_frozen_raises():
    bufs = graph.SweepBuffers()
    a = bufs.get("a", lambda: torch.zeros(2))
    bufs.frozen = True
    assert bufs.get("a", lambda: torch.ones(2)) is a
    with pytest.raises(RuntimeError, match="during the capture"):
        bufs.get("b", lambda: torch.zeros(2))


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", MESHES)
def test_the_schedule_and_the_counts_of_a_replayed_sweep_are_the_host_loops(ds, led, tile,
                                                                              stale):
    """``consensus_schedule_check`` reads the same verdict on the body's
    schedule as on the host loop's, and the counts a graph run keeps (one
    captured sweep's, added once per replay: ``graph._counts_less``,
    ``graph._add_counts``) equal N host sweeps' and the analytic model's."""
    kw = dict(KERNEL_ROUTE, chunk_size=8, stale_consensus=stale)
    host_mesh, route, _, _ = sweeps(ds, led, tile, None, **kw)
    mesh, _, body = prepared(ds, led, tile, **kw)
    bufs = graph.SweepBuffers()
    body(bufs)                                       # the warm-up
    mesh.reset_counts()
    body(bufs)                                       # the sweep a capture records
    one = graph._counts_less(mesh.counts, {})
    mesh.reset_counts()
    for _ in range(SWEEPS):
        graph._add_counts(mesh, one)
    host = comm.consensus_schedule_check(host_mesh.schedule)
    assert comm.consensus_schedule_check(mesh.schedule) == host
    assert host["issued_before_compute"] is stale
    assert mesh.counts == host_mesh.counts
    cfg, k = ds.cfg, ds.geom.num_leds
    if tile == 1:
        model, hops = comm.led_shard_comm(cfg.n_large, cfg.np_size, k, 8, led), 1
    else:
        model = comm.tile_shard_comm(cfg.n_large, cfg.np_size, k, led, tile, 8)
        hops = -(-cfg.np_size // (cfg.n_large // tile))
    assert comm.counted_mismatches(mesh.counts, model, sweeps=SWEEPS, halo_hops=hops) == []
    assert not [s for s in mesh.schedule if s.chunk is None]       # nothing copied back


def test_the_state_slots_never_write_what_the_last_chunk_wrote():
    """Chunk c writes another slot than chunk c-1 (which the stale
    consensus's next K3 reads meanwhile) and than slot 0 at chunk 0 (which
    it reads); the last chunk writes slot 0, where the next sweep starts,
    but for a sweep of one chunk, which is copied back."""
    for n in range(1, 12):
        slots = [led_shard.state_slot(c, n) for c in range(n)]
        assert all(a != b for a, b in zip([0] + slots, slots))
        assert slots[-1] == (0 if n > 1 else 1)
        assert set(slots) <= {0, 1, 2}


def test_launch_counts_move_by_a_captured_sweeps_counts():
    before = kernels.launch_counts()
    delta = {"fused_chunk_increments": 28, "consensus_led": 7}
    kernels.add_launches(delta, 3)
    after = kernels.launch_counts()
    assert after["fused_chunk_increments"] == before["fused_chunk_increments"] + 84
    assert after["consensus_led"] == before["consensus_led"] + 21
    kernels.add_launches(delta, -3)
    assert kernels.launch_counts() == before


def test_the_route_is_fixed_by_the_mesh(monkeypatch):
    """A graph where every rank is a CUDA rank of this process; the host
    loop on the CPU, under a transport, and where a test forces it. (A
    CUDA mesh whose streams are serialized is built here without a card.)"""
    cuda = Mesh([[torch.device("cuda", 0)] * 2], serialize_streams=True)
    assert graph.replays(cuda)
    assert not graph.replays(make_mesh(2, 1, devices=["cpu"] * 2))
    assert not graph.replays(Mesh([[torch.device("cuda", 0), None]], transport=object(),
                                  serialize_streams=True))
    monkeypatch.setattr(graph.run_sweeps, "force_host_loop", True)
    assert not graph.replays(cuda)


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_a_cpu_run_walks_the_host_loop(ds, led, tile):
    fn = led_shard.reconstruct_led_sharded if tile == 1 else tile_shard.reconstruct_tile_sharded
    mesh = make_mesh(led, tile, devices=["cpu"] * (led * tile))
    res = fn(ds.images, ds.geom, ds.cfg, mesh=mesh, iterations=1, chunk_size=8, use_pallas=True)
    assert res.replay is None


@needs_8
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", MESHES)
def test_the_body_over_buffers_stays_within_fpm_tpus_limits(ds, led, tile, stale):
    """The replayed route's sweeps (the body over buffers, N times) against
    fpm_tpu's reconstruct_led_sharded / reconstruct_tile_sharded on the same
    mesh of virtual devices."""
    kw = dict(chunk_size=8, use_pallas=True, stale_consensus=stale, dft_precision="highest")
    mesh, route, mets, (obj, pupil) = sweeps(ds, led, tile, graph.SweepBuffers(), **kw)
    got = led_shard.result_from(obj, pupil, torch.stack(mets).numpy())
    jfn = jpar.reconstruct_led_sharded if tile == 1 else jpar.reconstruct_tile_sharded
    ref = jfn(ds.images, ds.geom, ds.cfg, iterations=SWEEPS, dtype="complex64",
              mesh=jpar.make_mesh(led=led, tile=tile, devices=jax.devices()[:led * tile]), **kw)
    assert rel(got.obj_f_centered, ref.obj_f_centered) < 1e-5
    assert rel(got.pupil, ref.pupil) < 1e-4
    for key in ("data_residual", "update_norm"):
        np.testing.assert_allclose(got.metrics[key], ref.metrics[key], rtol=1e-3)


@needs_8
def test_the_complex128_body_over_buffers_stays_within_fpm_tpus_limits(ds):
    kw = dict(chunk_size=8, dtype="complex128", stale_consensus=True)
    _, _, mets, (obj, pupil) = sweeps(ds, 2, 2, graph.SweepBuffers(), **kw)
    ref = jpar.reconstruct_tile_sharded(
        ds.images, ds.geom, ds.cfg, iterations=SWEEPS,
        mesh=jpar.make_mesh(led=2, tile=2, devices=jax.devices()[:4]), **kw)
    got = led_shard.result_from(obj, pupil, torch.stack(mets).numpy())
    assert rel(got.obj_f_centered, ref.obj_f_centered) < 1e-10
    assert rel(got.pupil, ref.pupil) < 1e-10
