"""The port's CLI end to end on the CPU against fpm_tpu's: simulate → run
gives the same output file set and the same object (complex128, ≤ 1e-10);
checkpoints carry over between the two CLIs, also on a mesh; ``--mesh`` and
the config's ``tileGrid`` key run the sharded sweeps as fpm_tpu's CLI does;
flags of unported paths are refused, never ignored."""

import json
import os

import numpy as np
import pytest

from fpm_torch import cli as tcli
from fpm_tpu import cli as jcli


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("sim")
    data = str(root / "data")
    assert tcli.main(["simulate", data, "--np-size", "16", "--grid", "5", "--seed", "2"]) == 0
    return os.path.join(data, "dataset.json")


def test_simulate_writes_what_fpm_tpu_writes(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["--np-size", "16", "--grid", "5", "--seed", "3", "--jitter", "0.1",
            "--darkfield-exp", "2"]
    assert tcli.main(["simulate", a, *args]) == 0
    assert jcli.main(["simulate", b, *args]) == 0
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    np.testing.assert_array_equal(np.load(os.path.join(a, "object_true.npy")),
                                  np.load(os.path.join(b, "object_true.npy")))
    doc_a, doc_b = (json.load(open(os.path.join(d, "dataset.json"))) for d in (a, b))
    doc_a.pop("datasetRoot"), doc_b.pop("datasetRoot")
    assert doc_a == doc_b


def test_info_matches(dataset, capsys):
    assert tcli.main(["info", dataset, "--geometry"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(["info", dataset, "--geometry"]) == 0
    assert ours == capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--mode", "batched", "--chunk-size", "8"]])
def test_run_matches_fpm_tpu(dataset, tmp_path, extra):
    common = ["-n", "3", "--platform", "cpu", "--dtype", "complex128", *extra]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["run", dataset, "-o", out_t, *common]) == 0
    assert jcli.main(["run", dataset, "-o", out_j, "--no-native", *common]) == 0
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in ("object.npy", "object_spectrum.npy", "pupil.npy"):
        a, b = np.load(os.path.join(out_t, name)), np.load(os.path.join(out_j, name))
        assert a.dtype == b.dtype
        assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10, name
    ma, mb = (json.load(open(os.path.join(d, "manifest.json"))) for d in (out_t, out_j))
    assert ma["derived"] == mb["derived"]
    np.testing.assert_allclose(ma["metrics"]["data_residual"], mb["metrics"]["data_residual"],
                               rtol=1e-10)


def test_plain_kernel_route_runs(dataset, tmp_path):
    out = str(tmp_path / "k")
    assert tcli.main(["run", dataset, "-o", out, "-n", "2", "--platform", "cpu",
                      "--use-pallas", "--mode", "batched", "--chunk-size", "8"]) == 0
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert len(manifest["metrics"]["update_norm"]) == 2


@pytest.mark.parametrize("first,second", [(jcli, tcli), (tcli, jcli)])
def test_checkpoint_resumes_across_packages(dataset, tmp_path, first, second):
    """A run checkpointed by one package's CLI and resumed by the other's
    ends where an uninterrupted run ends."""
    common = ["--platform", "cpu", "--dtype", "complex128", "--dft-precision", "highest"]
    out, full = str(tmp_path / "split"), str(tmp_path / "full")
    assert first.main(["run", dataset, "-o", out, "-n", "2", "--checkpoint-every", "1",
                       *common]) == 0
    assert os.path.exists(os.path.join(out, "ckpt_1.npz"))
    assert second.main(["run", dataset, "-o", out, "-n", "4", "--resume", *common]) == 0
    assert tcli.main(["run", dataset, "-o", full, "-n", "4", *common]) == 0
    a, b = (np.load(os.path.join(d, "object_spectrum.npy")) for d in (out, full))
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10


@pytest.mark.parametrize("flags", [
    ["--fov-grid", "2", "2"], ["--fov-overlap", "4"],
    ["--color-mode", "rgb"], ["--debug"], ["--debug-led", "3"], ["--distributed"],
    ["--watchdog-timeout", "5"], ["--no-native"], ["--dft-precision", "bf16x3"],
    ["--mesh", "2", "1", "--distributed"],
])
def test_unported_flags_are_refused(dataset, tmp_path, capsys, flags):
    rc = tcli.main(["run", dataset, "-o", str(tmp_path / "x"), "--platform", "cpu", *flags])
    assert rc == 1
    assert "not yet ported" in capsys.readouterr().err


def _solver_options(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return next(r for r in map(json.loads, f) if r["event"] == "solver_options")


def _checkpoint_fingerprint(path):
    with np.load(path) as z:
        return json.loads(bytes(z["fingerprint"]).decode())


@pytest.mark.parametrize("mesh,extra", [
    (["2", "1"], []), (["2", "2"], []), (["1", "6"], ["--stale-consensus"])])
def test_mesh_run_matches_fpm_tpu(dataset, tmp_path, mesh, extra):
    common = ["-n", "3", "--dtype", "complex128", "--dft-precision", "highest",
              "--chunk-size", "8", "--mesh", *mesh, *extra]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["run", dataset, "-o", out_t, "--platform", "cpu", *common]) == 0
    assert jcli.main(["run", dataset, "-o", out_j, "--no-native", *common]) == 0
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in ("object.npy", "object_spectrum.npy", "pupil.npy"):
        a, b = np.load(os.path.join(out_t, name)), np.load(os.path.join(out_j, name))
        assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10, name
    so_t, so_j = _solver_options(out_t), _solver_options(out_j)
    assert so_t.pop("device") == "cpu"
    for so in (so_t, so_j):
        so.pop("t")
    assert so_t == so_j and so_t["mesh"] == [int(m) for m in mesh] and so_t["mode"] == "batched"


def test_mesh_levers_run_on_the_kernel_route(dataset, tmp_path):
    out = str(tmp_path / "levers")
    assert tcli.main(["run", dataset, "-o", out, "-n", "10", "--platform", "cpu",
                      "--mesh", "4", "1", "--chunk-size", "8", "--use-pallas",
                      "--comm-precision", "bf16", "--stale-consensus"]) == 0
    so = _solver_options(out)
    assert so["comm_precision"] == "bf16" and so["stale_consensus"] is True
    obj = np.load(os.path.join(out, "object.npy"))
    truth = np.load(os.path.join(os.path.dirname(dataset), "object_true.npy"))
    a, t = np.abs(obj), np.abs(truth)
    scale = (t * a).sum() / (a * a).sum()
    assert np.sqrt(((a * scale - t) ** 2).mean()) / t.mean() < 0.15


def test_tile_grid_config_key_builds_the_mesh(dataset, tmp_path, capsys):
    """A config with ``tileGrid`` runs on that mesh, batched, and says so in
    the fingerprint, exactly like ``--mesh`` (as fpm_tpu's CLI does); it once
    ran single-device in the mode given."""
    doc = json.load(open(dataset))
    doc["tileGrid"] = [4, 2]
    cfg_path = str(tmp_path / "tiled.json")
    with open(cfg_path, "w") as f:
        json.dump(doc, f)
    out, ref = str(tmp_path / "tg"), str(tmp_path / "flag")
    common = ["-n", "4", "--platform", "cpu", "--dtype", "complex128", "--chunk-size", "8",
              "--dft-precision", "highest"]
    capsys.readouterr()
    assert tcli.main(["run", cfg_path, "-o", out, "--checkpoint-every", "2", *common]) == 0
    assert "mesh: led=4 tile=2" in capsys.readouterr().out
    fp = _checkpoint_fingerprint(os.path.join(out, "ckpt_2.npz"))
    assert fp["mesh"] == "4x2" and fp["mode"] == "batched" and fp["chunk_size"] == 8
    assert _solver_options(out)["mesh"] == [4, 2]
    assert tcli.main(["run", dataset, "-o", ref, "--mesh", "4", "2", *common]) == 0
    a, b = (np.load(os.path.join(d, "object_spectrum.npy")) for d in (out, ref))
    assert np.array_equal(a, b)
    # The same checkpoint under fpm_tpu's fingerprint of the same config.
    assert jcli.main(["run", cfg_path, "-o", out, "-n", "4", "--resume", "--no-native",
                      "--dtype", "complex128", "--chunk-size", "8",
                      "--dft-precision", "highest"]) == 0
    c = np.load(os.path.join(out, "object_spectrum.npy"))
    assert np.abs(c - b).max() / np.abs(b).max() <= 1e-10


@pytest.mark.parametrize("first,second", [(jcli, tcli), (tcli, jcli)])
@pytest.mark.parametrize("mesh", [["4", "1"], ["2", "3"]])
def test_mesh_checkpoint_resumes_across_packages(dataset, tmp_path, first, second, mesh):
    """(4,1) with chunk 6: the LED mesh rounds the chunk up to 8, and both
    fingerprints must say so for the resume to be accepted."""
    common = ["--dtype", "complex128", "--dft-precision", "highest", "--chunk-size", "6",
              "--mesh", *mesh]
    plat = {tcli: ["--platform", "cpu"], jcli: ["--no-native"]}
    out, full = str(tmp_path / "split"), str(tmp_path / "full")
    assert first.main(["run", dataset, "-o", out, "-n", "2", "--checkpoint-every", "1",
                       *common, *plat[first]]) == 0
    fp = _checkpoint_fingerprint(os.path.join(out, "ckpt_1.npz"))
    assert fp["mesh"] == "x".join(mesh) and fp["chunk_size"] == (8 if mesh[1] == "1" else 6)
    assert second.main(["run", dataset, "-o", out, "-n", "4", "--resume", *common,
                        *plat[second]]) == 0
    assert tcli.main(["run", dataset, "-o", full, "-n", "4", *common, *plat[tcli]]) == 0
    a, b = (np.load(os.path.join(d, "object_spectrum.npy")) for d in (out, full))
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10


def test_resume_refuses_a_checkpoint_of_another_mesh(dataset, tmp_path, capsys):
    out = str(tmp_path / "o")
    common = ["--platform", "cpu", "--dtype", "complex128", "--chunk-size", "8"]
    assert tcli.main(["run", dataset, "-o", out, "-n", "2", "--checkpoint-every", "1",
                      "--mesh", "2", "1", *common]) == 0
    capsys.readouterr()
    assert tcli.main(["run", dataset, "-o", out, "-n", "3", "--resume", "--mesh", "2", "2",
                      *common]) == 1
    assert "mesh: saved='2x1' vs now='2x2'" in capsys.readouterr().err


@pytest.mark.parametrize("flags,message", [
    (["--color-mode", "rgb"], "rgb does not support --mesh"),
    (["--fov-grid", "2", "2"], "--mesh is not supported with it"),
    (["--comm-precision", "bf16"], "bf16"),
])
def test_mesh_refusals(dataset, tmp_path, capsys, flags, message):
    rc = tcli.main(["run", dataset, "-o", str(tmp_path / "x"), "--platform", "cpu",
                    "--mesh", "2", "1", *flags])
    assert rc == 1
    assert message in capsys.readouterr().err


def test_mesh_without_a_gpu_is_an_error(dataset, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = tcli.main(["run", dataset, "-o", str(tmp_path / "x"), "--use-pallas",
                    "--mesh", "2", "2"])
    assert rc == 1
    assert "--platform cpu" in capsys.readouterr().err


def test_cuda_platform_without_a_gpu_is_an_error(dataset, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = tcli.main(["run", dataset, "-o", str(tmp_path / "x"), "--use-pallas"])
    assert rc == 1
    assert "--platform cpu" in capsys.readouterr().err
