"""Multi-process runs of the port without a cluster, after
tests/test_multihost.py: two CPU processes join through
``fpm_torch.parallel.multihost.initialize_from_env`` (the ``FPM_*``
environment, a free port, ``gloo``) and run the sharded sweeps on one global
mesh, so that every collective of the cases below crosses the process
boundary. Each process's result must be bitwise that of the one-process
mesh of the same shape, with the same counted collectives, and within
fpm_tpu's limits of fpm_tpu's references (1e-10 in complex128, 1e-5 on the
kernel route; with the bf16 wire 2^-9, see the test). Also
``initialize_from_env``'s three outcomes, and two-process CLI runs: a mesh
run in which only process 0 writes, and a ``--fov-grid`` run whose stitch is
bitwise the one-process run's."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from fpm_torch import cli as tcli
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.parallel import make_mesh, reconstruct_led_sharded, reconstruct_tile_sharded
from fpm_torch.parallel.multihost import initialize_from_env
from fpm_tpu.models.epry import reconstruct as jreconstruct
from fpm_tpu.parallel.mesh import make_mesh as jmake_mesh
from fpm_tpu.parallel.tile_shard import reconstruct_tile_sharded as jreconstruct_tile_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(sys.platform != "linux", reason="linux-only harness")

WORKER = r"""
import json, sys
import numpy as np
from fpm_torch.parallel.multihost import global_mesh, initialize_from_env, is_coordinator
assert initialize_from_env()
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.parallel import reconstruct_led_sharded, reconstruct_tile_sharded

out, tile, per = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
kw = json.loads(sys.argv[4])
ds = synthetic_dataset(np_size=16, grid=5, seed=11)
mesh = global_mesh(tile=tile, devices=["cpu"] * per)
fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
res = fn(ds.images, ds.geom, ds.cfg, mesh=mesh, **kw)
rank = 0 if is_coordinator() else 1
np.save(f"{out}.{rank}.obj.npy", res.obj_f_centered)
np.save(f"{out}.{rank}.pupil.npy", res.pupil)
with open(f"{out}.{rank}.counts.json", "w") as f:
    json.dump({",".join(k): v for k, v in mesh.counts.items()}, f)
print(mesh.describe())
"""

KERNEL = dict(dtype="complex64", chunk_size=8, use_pallas=True, dft_precision="highest")
LEVERS = dict(KERNEL, comm_precision="bf16", stale_consensus=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_processes(argv_of, cwd=REPO):
    """Run ``argv_of(pid)`` as processes 0 and 1 of one run; their outputs."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, FPM_COORDINATOR=f"127.0.0.1:{port}", FPM_NUM_PROCESSES="2",
                   FPM_PROCESS_ID=str(pid),
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(argv_of(pid), env=env, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-1500:]
    return [o.decode() for o, _ in outs]


def _ds():
    return synthetic_dataset(np_size=16, grid=5, seed=11)


@pytest.mark.parametrize("tile,per,kw,name", [
    (1, 2, dict(dtype="complex128"), "led-sharded"),
    (2, 1, KERNEL, "tile-sharded through K3's plain body"),
    (2, 1, LEVERS, "bf16 + stale levers"),
    (2, 1, dict(dtype="complex128"), "halos crossing processes"),
], ids=["led", "kernel", "levers", "halos"])
def test_two_process_mesh_is_bitwise_the_one_process_mesh(tmp_path, tile, per, kw, name):
    out = str(tmp_path / "res")
    said = _two_processes(lambda pid: [sys.executable, "-c", WORKER, out, str(tile), str(per),
                                       json.dumps(dict(iterations=3, **kw))])
    assert all("2 processes, transport gloo: ranks on the CPU" in s for s in said), said

    ds = _ds()
    n = 2 * per
    mesh = make_mesh(n // tile, tile, devices=["cpu"] * n)
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    one = fn(ds.images, ds.geom, ds.cfg, mesh=mesh, iterations=3, **kw)
    counts = {",".join(k): v for k, v in mesh.counts.items()}
    for rank in (0, 1):
        np.testing.assert_array_equal(np.load(f"{out}.{rank}.obj.npy"), one.obj_f_centered)
        np.testing.assert_array_equal(np.load(f"{out}.{rank}.pupil.npy"), one.pupil)
        with open(f"{out}.{rank}.counts.json") as f:
            assert json.load(f) == counts

    # fpm_tpu's references and limits, as tests/test_multihost.py holds them.
    if kw.get("comm_precision") == "bf16":
        jmesh = jmake_mesh(led=1, tile=2, devices=jax.devices()[:2])
        ref = jreconstruct_tile_sharded(ds.images, ds.geom, ds.cfg, mesh=jmesh, iterations=3,
                                        **kw)
    else:
        jkw = {k: v for k, v in kw.items() if k not in ("use_pallas", "dft_precision")}
        ref = jreconstruct(ds.images, ds.geom, ds.cfg, iterations=3, mode="batched", **jkw)
    # The levers case: fpm_tpu's bf16 psum accumulates in bf16, the port's in
    # f32 (a deliberate difference, ROADMAP §3), so the two lie up to about
    # one bf16 rounding apart: bf16's unit roundoff, 2^-9, not 1e-5.
    limit = {"complex128": 1e-10, "complex64": 1e-5}[kw["dtype"]]
    if kw.get("comm_precision") == "bf16":
        limit = 2.0 ** -9
    got = one.obj_f_centered
    assert np.abs(got - ref.obj_f_centered).max() / np.abs(ref.obj_f_centered).max() < limit


@pytest.mark.parametrize("env,require,outcome", [
    ({"FPM_PROCESS_ID": "1"}, False, "partial multi-host configuration"),
    ({"FPM_COORDINATOR": "127.0.0.1:1", "FPM_PROCESS_ID": "0"}, False,
     "partial multi-host configuration"),
    ({}, True, "--distributed requested but no multi-host configuration found"),
    ({}, False, False),
], ids=["process-id-only", "no-process-count", "require-without-env", "no-env"])
def test_initialize_from_env_outcomes(monkeypatch, env, require, outcome):
    for key in ("FPM_COORDINATOR", "FPM_NUM_PROCESSES", "FPM_PROCESS_ID", "RANK",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if outcome is False:
        assert initialize_from_env(require=require) is False
        return
    with pytest.raises(ValueError, match=outcome):
        initialize_from_env(require=require)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("mh") / "data")
    assert tcli.main(["simulate", data, "--np-size", "16", "--grid", "5", "--seed", "8"]) == 0
    return os.path.join(data, "dataset.json")


OUTPUTS = ["manifest.json", "metrics.jsonl", "object.npy", "object_amp.png",
           "object_phase.png", "object_spectrum.npy", "pupil.npy", "pupil_amp.png",
           "pupil_phase.png"]


def test_two_process_cli_run_writes_on_process_0_only(dataset, tmp_path):
    flags = ["-n", "3", "--platform", "cpu", "--mesh", "2", "1", "--chunk-size", "8",
             "--checkpoint-every", "1"]
    outs = [str(tmp_path / f"p{pid}") for pid in range(2)]
    said = _two_processes(lambda pid: [sys.executable, "-m", "fpm_torch", "run", dataset,
                                       "-o", outs[pid], "--distributed", *flags])
    assert "mesh: led=2 tile=1 (2 processes, transport gloo" in said[0]
    assert sorted(os.listdir(outs[0])) == sorted(OUTPUTS + ["ckpt_1.npz", "ckpt_2.npz"])
    assert os.listdir(outs[1]) == []
    one = str(tmp_path / "one")
    assert tcli.main(["run", dataset, "-o", one, *flags]) == 0
    for name in ("object.npy", "object_spectrum.npy", "pupil.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(outs[0], name)),
                                      np.load(os.path.join(one, name)))


def test_two_process_fov_grid_stitch_is_bitwise_one_process(tmp_path):
    data = str(tmp_path / "wide")
    assert tcli.main(["simulate", data, "--np-size", "16", "--grid", "5", "--seed", "9",
                      "--frame-size", "48"]) == 0
    cfg = os.path.join(data, "dataset.json")
    flags = ["-n", "2", "--platform", "cpu", "--fov-grid", "2", "2"]
    outs = [str(tmp_path / f"p{pid}") for pid in range(2)]
    said = _two_processes(lambda pid: [sys.executable, "-m", "fpm_torch", "run", cfg,
                                       "-o", outs[pid], "--distributed", *flags])
    assert "2 ROI ranks over 2 processes" in said[0]
    assert os.listdir(outs[1]) == []
    one = str(tmp_path / "one")
    assert tcli.main(["run", cfg, "-o", one, *flags]) == 0
    np.testing.assert_array_equal(np.load(os.path.join(outs[0], "object_stitched.npy")),
                                  np.load(os.path.join(one, "object_stitched.npy")))
    with open(os.path.join(outs[0], "metrics.jsonl")) as f:
        tiles = [r for r in map(json.loads, f) if r["event"] == "tile"]
    assert sorted((r["row"], r["col"]) for r in tiles) == [(0, 0), (0, 1), (1, 0), (1, 1)]
