"""The order of the port's sharded sweeps (``Mesh.schedule``) and the
counterpart of ``fpm_tpu``'s ``consensus_schedule_check``, on meshes of CPU
ranks at small size (``synthetic_dataset(np_size=16, grid=5, seed=3)``,
chunk 4).

On the CPU no step overlaps another, but each step is logged with the
stream it would run on and the steps it waits on, so the check reads here
what it reads on the card: under the stale consensus chunk c's consensus is
issued before chunk c+1's compute, which waits on nothing of it; on the
fresh sweep it does. Against fpm_tpu on its own case (tests/test_comm.py:
mesh (2,1), complex64, one sweep), the verdicts and the consensus bytes are
equal. The state kept in K3's operands is built once per run, not per
chunk; the complex routes (eager, complex128 kernel route) stay within
fpm_tpu's limits (1e-10 in complex128; 1e-5 / 1e-4 on the kernel route,
tests/test_sharding.py:114-117).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import fpm_tpu.parallel as jpar
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.ops import kernels
from fpm_torch.parallel import (
    consensus_schedule_check,
    led_shard,
    make_mesh,
    reconstruct_led_sharded,
    reconstruct_tile_sharded,
)
from fpm_torch.parallel.mesh import Pending, Step
from fpm_tpu.parallel.comm import consensus_schedule_check as jconsensus_schedule_check
from fpm_tpu.parallel.led_shard import _run_led_sharded
from fpm_tpu.parallel.led_shard import prepare_led_sharded as jprepare_led_sharded

MESHES = [(2, 1), (4, 1), (2, 2), (1, 4)]
ROUTES = {"kernel": dict(use_pallas=True), "eager": dict()}


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=3)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def sharded(ds, led, tile, mesh_kw=None, **kw):
    mesh = make_mesh(led, tile, devices=["cpu"] * (led * tile), **(mesh_kw or {}))
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    kw = dict(dict(iterations=1, chunk_size=4, dtype="complex64"), **kw)
    return fn(ds.images, ds.geom, ds.cfg, mesh=mesh, **kw), mesh


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("led,tile", MESHES)
def test_consensus_is_issued_before_the_next_chunks_compute_only_when_stale(
        ds, led, tile, route, stale):
    _, mesh = sharded(ds, led, tile, stale_consensus=stale, **ROUTES[route])
    got = consensus_schedule_check(mesh.schedule)
    assert got["issued_before_compute"] is stale, got
    assert got["consensus_idx"] < got["first_dft_idx"]       # enqueued first either way
    steps = mesh.schedule
    assert all(j < i for i, s in enumerate(steps) for j in s.waits_on)
    compute = [s for s in steps if s.op == "increments"]
    assert {s.rank for s in compute} == {(li, ti) for li in range(led) for ti in range(tile)}
    assert {s.stream for s in compute} == {f"rank {li},{ti}" for li in range(led)
                                           for ti in range(tile)}
    assert {s.stream for s in steps if s.rank is None} <= {"comm", "halo"}


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_verdict_and_consensus_bytes_equal_fpm_tpus_on_its_own_case(ds, stale):
    """tests/test_comm.py:152-170: mesh (2,1), complex64, one sweep, chunk
    4; fpm_tpu reads its compiled program, the port its schedule."""
    jmesh = jpar.make_mesh(led=2, tile=1, devices=jax.devices()[:2])
    args, opts = jprepare_led_sharded(ds.images, ds.geom, ds.cfg, jmesh, iterations=1,
                                      dtype="complex64", chunk_size=4, stale_consensus=stale)
    ref = jconsensus_schedule_check(_run_led_sharded.lower(*args, opts, jmesh).compile()
                                    .as_text())
    _, mesh = sharded(ds, 2, 1, stale_consensus=stale)
    got = consensus_schedule_check(mesh.schedule)
    assert got["issued_before_compute"] == ref["issued_before_compute"] == stale
    assert got["consensus_bytes"] == ref["consensus_bytes"] == (48 * 48 + 16 * 16) * 8
    assert set(got) == set(ref)


def test_a_one_chunk_schedule_raises(ds):
    _, mesh = sharded(ds, 2, 1, chunk_size=0, stale_consensus=True)
    assert {s.chunk for s in mesh.schedule if s.op == "increments"} == {0}
    with pytest.raises(ValueError, match="multi-chunk"):
        consensus_schedule_check(mesh.schedule)
    with pytest.raises(ValueError, match="multi-chunk"):
        consensus_schedule_check([])


def test_the_check_follows_the_order_of_a_stream():
    """A step waits on every earlier step of its stream: chunk 1's compute
    on the comm lane after chunk 0's consensus is not overlapped, though it
    names no event of it."""
    def steps(stream_of_compute):
        return [Step(0, (0, 0), "rank 0,0", "increments", ()),
                Step(0, None, "comm", "psum object increments", (0,), 8),
                Step(0, None, "comm", "psum pupil increments", (0,), 4),
                Step(1, (0, 0), stream_of_compute, "increments", ())]
    assert consensus_schedule_check(steps("rank 0,0"))["issued_before_compute"]
    assert not consensus_schedule_check(steps("comm"))["issued_before_compute"]
    assert consensus_schedule_check(steps("rank 0,0"))["consensus_bytes"] == 12


@pytest.mark.parametrize("led,tile", [(2, 1), (2, 2)])
def test_serialized_streams_change_no_bit_and_overlap_nothing(ds, led, tile):
    """The test-only ``serialize_streams``: every step on the current
    stream, so the stale schedule is no longer issued before compute; the
    result is bitwise that of the mesh with streams."""
    kw = dict(iterations=2, stale_consensus=True, use_pallas=True)
    a, mesh_a = sharded(ds, led, tile, **kw)
    b, mesh_b = sharded(ds, led, tile, mesh_kw=dict(serialize_streams=True), **kw)
    np.testing.assert_array_equal(a.obj_f_centered, b.obj_f_centered)
    np.testing.assert_array_equal(a.pupil, b.pupil)
    assert {s.stream for s in mesh_b.schedule} == {"current"}
    assert consensus_schedule_check(mesh_a.schedule)["issued_before_compute"]
    assert not consensus_schedule_check(mesh_b.schedule)["issued_before_compute"]
    assert [s[:2] + s[3:] for s in mesh_a.schedule] == [s[:2] + s[3:] for s in mesh_b.schedule]


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_k3_operands_are_built_once_per_run_not_per_chunk(ds, led, tile, monkeypatch):
    counts = {"bbox": 0, "planes": 0, "from_bbox": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kernels, "_pupil_to_bbox", counting("bbox", kernels._pupil_to_bbox))
    monkeypatch.setattr(kernels, "_pupil_from_bbox",
                        counting("from_bbox", kernels._pupil_from_bbox))
    monkeypatch.setattr(led_shard, "_to_planes", counting("planes", led_shard._to_planes))
    seen = []
    for iterations in (1, 3):
        counts.update(bbox=0, planes=0, from_bbox=0)
        _, mesh = sharded(ds, led, tile, iterations=iterations, use_pallas=True)
        n_chunks = len({s.chunk for s in mesh.schedule if s.op == "increments"})
        seen.append(dict(counts))
    assert n_chunks > 1
    ranks = led * tile
    assert seen == [{"bbox": ranks, "planes": 2 * ranks, "from_bbox": 0}] * 2


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", [(2, 1), (2, 2)])
def test_complex_routes_stay_within_fpm_tpus_limits(ds, led, tile, stale):
    """complex128 eager (1e-10) and the kernel route with complex128 state
    (K3 per chunk on converted operands; 1e-5 / 1e-4) against fpm_tpu."""
    jmesh = jpar.make_mesh(led=led, tile=tile, devices=jax.devices()[:led * tile])
    jfn = jpar.reconstruct_led_sharded if tile == 1 else jpar.reconstruct_tile_sharded
    for kw, lim_o, lim_p in ((dict(dtype="complex128"), 1e-10, 1e-10),
                             (dict(dtype="complex128", use_pallas=True,
                                   dft_precision="highest"), 1e-5, 1e-4)):
        kw = dict(kw, iterations=3, chunk_size=4, stale_consensus=stale)
        got, _ = sharded(ds, led, tile, **kw)
        ref = jfn(ds.images, ds.geom, ds.cfg, mesh=jmesh, **kw)
        assert rel(got.obj_f_centered, ref.obj_f_centered) < lim_o
        assert rel(got.pupil, ref.pupil) < lim_p


def test_pending_collectives_give_the_waited_result():
    mesh = make_mesh(2, 3, devices=["cpu"] * 6)
    g = mesh.grid(lambda li, ti: torch.tensor([10.0 * li + ti]))
    pending = mesh.psum(g, "led", chunk=0, what="x", wait=False)
    assert isinstance(pending, Pending)
    assert [[c.item() for c in row] for row in pending.result()] == [[10, 12, 14]] * 2
    step = mesh.schedule[pending.step]
    assert (step.chunk, step.rank, step.stream, step.op, step.nbytes) == (0, None, "comm",
                                                                          "psum x", 4)
    with mesh.on_rank(0, (1, 2), "use", waits=[pending.step]) as idx:
        pass
    assert mesh.schedule[idx] == Step(0, (1, 2), "rank 1,2", "use", (pending.step,), 0)


WORKER = r"""
import json, sys
from fpm_torch.parallel.multihost import global_mesh, initialize_from_env
assert initialize_from_env()
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.parallel import consensus_schedule_check, reconstruct_tile_sharded
import numpy as np
ds = synthetic_dataset(np_size=16, grid=5, seed=3)
mesh = global_mesh(tile=2, devices=["cpu"])
res = reconstruct_tile_sharded(ds.images, ds.geom, ds.cfg, mesh=mesh, iterations=2,
                               chunk_size=4, use_pallas=True, stale_consensus=True)
np.save(sys.argv[1] + ".npy", np.concatenate([res.obj_f_centered.ravel(), res.pupil.ravel()]))
print("CHECK " + json.dumps(consensus_schedule_check(mesh.schedule)))
"""


def test_two_process_stale_sweep_is_bitwise_one_process_and_issued_before_compute(
        ds, tmp_path):
    """The stale sweep over gloo (each halo crosses the processes; the
    exchange of chunk c's payloads waits until chunk c+1's K3 is enqueued)
    is bitwise the one-process mesh, and each process's schedule passes."""
    from test_torch_multihost import _two_processes

    out = str(tmp_path / "res")
    said = _two_processes(lambda pid: [sys.executable, "-c", WORKER, f"{out}{pid}"])
    checks = [json.loads(s.split("CHECK ", 1)[1].splitlines()[0]) for s in said]
    assert all(c["issued_before_compute"] for c in checks), checks
    one, _ = sharded(ds, 1, 2, iterations=2, use_pallas=True, stale_consensus=True)
    want = np.concatenate([one.obj_f_centered.ravel(), one.pupil.ravel()])
    for pid in range(2):
        np.testing.assert_array_equal(np.load(f"{out}{pid}.npy"), want)
