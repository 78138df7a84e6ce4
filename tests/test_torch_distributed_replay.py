"""The sharded sweep as a body over buffers made once — what
``fpm_torch.parallel.graph`` captures into a CUDA graph on each process of
a ``--distributed`` run over NCCL — held under a ``ProcessTransport``
between two CPU processes (gloo, the harness of
tests/test_torch_multihost.py), where nothing is captured: every
collective crosses the process boundary through the transport's buffers.

One two-process launch runs every case of ``CASES`` (the dataset of
tests/test_torch_multihost.py, Np 16, 3 chunks a sweep, ``SWEEPS`` sweeps):
in each process the host loop (fresh tensors every chunk) and the body over
one set of buffers, on two meshes of the same shape. The body must be
bitwise the host loop (every sweep's metrics and the state after the last;
the same operations on the same values, only where they write differs),
count the same collectives, and be bitwise the one-process mesh of the same
shape; every tensor the transport hands out (a received payload, a value
passed on) must be the same tensor at every sweep. Also the rule of
``graph.replays`` for a transport: NCCL replays, gloo walks the loop.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.parallel import graph, make_mesh, reconstruct_led_sharded, reconstruct_tile_sharded
from fpm_torch.parallel.mesh import Mesh
from test_torch_multihost import _two_processes

pytestmark = pytest.mark.skipif(sys.platform != "linux", reason="linux-only harness")

SWEEPS = 3
# (led, tile, ranks a process, stale consensus, wire): the LED mesh and the
# tile mesh of one rank a process, fresh and stale, at both wires; two ranks
# a process with the stale bf16 levers, where the tile mesh's halos take
# two hops (tile height 12 < Np 16).
CASES = [(led, tile, 1, stale, wire) for led, tile in ((2, 1), (1, 2))
         for stale in (False, True) for wire in ("f32", "bf16")]
CASES += [(2, 2, 2, True, "bf16"), (1, 4, 2, True, "bf16")]
IDS = [f"{led}x{tile}-{per}-a-process-{'stale' if stale else 'fresh'}-{wire}"
       for led, tile, per, stale, wire in CASES]


def options(stale: bool, wire: str) -> dict:
    return dict(dtype="complex64", chunk_size=8, use_pallas=True, dft_precision="highest",
                stale_consensus=stale, comm_precision=wire)


WORKER = r"""
import json, sys
import numpy as np
import torch
from fpm_torch.parallel.multihost import ProcessTransport, global_mesh, initialize_from_env
assert initialize_from_env()
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.parallel import graph, led_shard, tile_shard

out, cases, sweeps = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
ds = synthetic_dataset(np_size=16, grid=5, seed=11)
handed = []          # the data_ptr of every tensor the transport hands out, in order


def recorded(start):
    def wrapped(*args, **kw):
        started = start(*args, **kw)

        def finish():
            values = started()
            handed.append([t.data_ptr() for t in values.values()])
            return values
        return finish
    return wrapped


ProcessTransport.start_all_gather = recorded(ProcessTransport.start_all_gather)
ProcessTransport.start_exchange = recorded(ProcessTransport.start_exchange)


def prepared(led, tile, per, kw):
    mesh = global_mesh(tile=tile, devices=["cpu"] * per)
    assert (mesh.shape["led"], mesh.shape["tile"]) == (led, tile)
    if tile == 1:
        route, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)
        return mesh, route, lambda bufs: led_shard._sharded_sweep(mesh, route, opts=opts,
                                                                  bufs=bufs)
    route, opts, s = tile_shard.prepare_tile_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)
    return mesh, route, lambda bufs: tile_shard._tile_sweep(mesh, route, opts=opts, s=s,
                                                            bufs=bufs)


def state(mesh, route, tile):
    whole = mesh.local(route.obj) if tile == 1 else tile_shard._fetch(mesh, route.obj)
    return [t.numpy() for t in route.final_state(mesh, whole)]


for name, (led, tile, per, kw) in cases.items():
    mesh, route, body = prepared(led, tile, per, kw)
    host = [body(None).clone() for _ in range(sweeps)]
    want, want_counts = state(mesh, route, tile), mesh.counts
    mesh, route, body = prepared(led, tile, per, kw)
    bufs = graph.SweepBuffers()
    ptrs = []
    got = []
    for _ in range(sweeps):
        handed.clear()
        got.append(body(bufs).clone())
        ptrs.append(list(handed))
        bufs.frozen = True
    have = state(mesh, route, tile)
    owned = [(t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
             for t in bufs.tensors()]
    np.save(f"{out}.{name}.{mesh.transport.process}.obj.npy", have[0])
    np.save(f"{out}.{name}.{mesh.transport.process}.pupil.npy", have[1])
    print("CASE " + json.dumps({
        "name": name, "process": mesh.transport.process, "transport": mesh.transport.backend,
        "replays": graph.replays(mesh),
        "metrics_bitwise": all(torch.equal(a, b) for a, b in zip(got, host)),
        "state_bitwise": all(np.array_equal(a, b) for a, b in zip(have, want)),
        "counts_equal": mesh.counts == want_counts,
        "counts": {",".join(k): v for k, v in mesh.counts.items()},
        "collectives_a_sweep": len(ptrs[0]),
        "handed_same_every_sweep": all(p == ptrs[0] for p in ptrs),
        "handed_buffers": all(any(o <= p < o + n for o, n in owned)
                              for call in ptrs[0] for p in call),
        "buffers_made": len(bufs.tensors())}), flush=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of ``CASES`` in one two-process launch: each process's
    record of each case, by case id, and the prefix of the saved states."""
    out = str(tmp_path_factory.mktemp("replay") / "res")
    cases = {name: (led, tile, per, options(stale, wire))
             for name, (led, tile, per, stale, wire) in zip(IDS, CASES)}
    said = _two_processes(lambda pid: [sys.executable, "-c", WORKER, out, json.dumps(cases),
                                       str(SWEEPS)])
    records = {}
    for text in said:
        for line in text.splitlines():
            if line.startswith("CASE "):
                rec = json.loads(line[len("CASE "):])
                records.setdefault(rec["name"], {})[rec["process"]] = rec
    return records, out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_body_over_buffers_under_a_transport_is_bitwise_the_host_loop(runs, case):
    """Both processes: every sweep's metrics and the state after the last
    bitwise the host loop's, the same counted collectives; over gloo, whose
    route is the host loop's (``graph.replays`` false)."""
    records, _ = runs
    name = IDS[CASES.index(case)]
    for pid in (0, 1):
        rec = records[name][pid]
        assert rec["transport"] == "gloo" and not rec["replays"]
        assert rec["metrics_bitwise"] and rec["state_bitwise"], rec
        assert rec["counts_equal"], rec


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_tensor_the_transport_hands_out_keeps_its_data_ptr(runs, case):
    """Every all-gather's and exchange's values (received payloads, values
    of this process's own ranks passed on) are the same tensors at every
    sweep, and each lies in a buffer made at the first."""
    records, _ = runs
    for rec in records[IDS[CASES.index(case)]].values():
        assert rec["collectives_a_sweep"] > 0
        assert rec["handed_same_every_sweep"], rec
        assert rec["handed_buffers"], rec


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_body_over_buffers_under_a_transport_is_the_one_process_mesh(runs, case):
    """The two processes' state after the body's sweeps bitwise the
    one-process mesh of the same shape (the host loop on CPU ranks), and
    their counted collectives equal to its."""
    records, out = runs
    led, tile, per, stale, wire = case
    name = IDS[CASES.index(case)]
    ds = synthetic_dataset(np_size=16, grid=5, seed=11)
    mesh = make_mesh(led, tile, devices=["cpu"] * (led * tile))
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    one = fn(ds.images, ds.geom, ds.cfg, mesh=mesh, iterations=SWEEPS, **options(stale, wire))
    counts = {",".join(k): v for k, v in mesh.counts.items()}
    for pid in (0, 1):
        np.testing.assert_array_equal(np.load(f"{out}.{name}.{pid}.obj.npy"), one.obj_f_centered)
        np.testing.assert_array_equal(np.load(f"{out}.{name}.{pid}.pupil.npy"), one.pupil)
        assert records[name][pid]["counts"] == counts


@pytest.mark.parametrize("backend,replays", [("nccl", True), ("gloo", False)])
def test_the_route_under_a_transport_is_fixed_by_its_backend(monkeypatch, backend, replays):
    """Cards of this process with a transport: NCCL replays a captured
    sweep, gloo walks the loop; CPU ranks walk it whatever the transport,
    and so does ``force_host_loop``. (Meshes of CUDA devices whose streams
    are serialized are built here without a card.)"""
    transport = types.SimpleNamespace(backend=backend)
    on_cards = Mesh([[torch.device("cuda", 0), None], [None, None]], transport=transport,
                    serialize_streams=True)
    assert graph.replays(on_cards) is replays
    assert not graph.replays(Mesh([[torch.device("cpu"), None]], transport=transport))
    monkeypatch.setattr(graph.run_sweeps, "force_host_loop", True)
    assert not graph.replays(on_cards)
