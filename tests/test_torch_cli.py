"""The port's CLI end to end on the CPU against fpm_tpu's: simulate → run
gives the same output file set and the same object (complex128, ≤ 1e-10);
checkpoints carry over between the two CLIs; flags of unported paths are
refused, never ignored."""

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
    ["--mesh", "2", "1"], ["--fov-grid", "2", "2"], ["--fov-overlap", "4"],
    ["--color-mode", "rgb"], ["--debug"], ["--debug-led", "3"], ["--distributed"],
    ["--watchdog-timeout", "5"], ["--no-native"], ["--comm-precision", "bf16"],
    ["--stale-consensus"], ["--dft-precision", "bf16x3"],
])
def test_unported_flags_are_refused(dataset, tmp_path, capsys, flags):
    rc = tcli.main(["run", dataset, "-o", str(tmp_path / "x"), "--platform", "cpu", *flags])
    assert rc == 1
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_platform_without_a_gpu_is_an_error(dataset, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = tcli.main(["run", dataset, "-o", str(tmp_path / "x"), "--use-pallas"])
    assert rc == 1
    assert "--platform cpu" in capsys.readouterr().err
