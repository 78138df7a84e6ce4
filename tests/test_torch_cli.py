"""The port's CLI end to end on the CPU against fpm_tpu's: simulate → run
gives the same output file set and the same object (complex128, ≤ 1e-10),
also with ``--fov-grid`` (whole frames, stitched tiles) and ``--color-mode
rgb``; checkpoints and large-FOV tiles carry over between the two CLIs, also
on a mesh; ``--mesh`` and the config's ``tileGrid`` key run the sharded
sweeps as fpm_tpu's CLI does; ``--watchdog-timeout`` arms on every path;
the flags once refused as not yet ported (``--debug``, ``--debug-led``,
``--distributed``) do what fpm_tpu's do; checkpoints written with default
flags resume across the packages (both default to the bf16x3 tier)."""

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


@pytest.mark.parametrize("first,second", [(jcli, tcli), (tcli, jcli)])
def test_checkpoint_resumes_across_packages_with_default_flags(dataset, tmp_path, first,
                                                               second):
    """A checkpoint written with each CLI's default flags resumes under the
    other's defaults (the fingerprint's dft_precision is bf16x3 in both), and
    ends near an uninterrupted run of the resuming package (complex64)."""
    out, full = str(tmp_path / "split"), str(tmp_path / "full")
    assert first.main(["run", dataset, "-o", out, "-n", "2", "--checkpoint-every", "1",
                       "--platform", "cpu"]) == 0
    assert _checkpoint_fingerprint(os.path.join(out, "ckpt_1.npz"))["dft_precision"] == "bf16x3"
    assert second.main(["run", dataset, "-o", out, "-n", "3", "--resume",
                        "--platform", "cpu"]) == 0
    assert second.main(["run", dataset, "-o", full, "-n", "3", "--platform", "cpu"]) == 0
    a, b = (np.load(os.path.join(d, "object_spectrum.npy")) for d in (out, full))
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-3


@pytest.mark.parametrize("flags", [
    ["--debug"], ["--debug-led", "3"], ["--distributed"], ["--no-native"],
    ["--dft-precision", "bf16x3"], ["--mesh", "2", "1", "--distributed"],
])
def test_formerly_refused_flags_do_what_fpm_tpus_do(dataset, tmp_path, capsys, flags):
    """Every flag the port once refused as not yet ported now does what
    fpm_tpu's CLI does with it. ``--debug`` writes the same debug images;
    ``--debug-led 3`` without ``--debug`` writes none, as in fpm_tpu, and the
    same outputs; ``--distributed`` without a multi-process environment (also
    with ``--mesh``) exits 1 with fpm_tpu's message, up to what the launcher
    auto-detection said. ``--dft-precision bf16x3`` and ``--no-native``: the
    tier is recorded in the run's options and fingerprint, the decoder in its
    ``dataset`` record (Python under ``--no-native``, native without it where
    the decoder builds), with the same result."""
    out = str(tmp_path / "x")
    if flags[0] == "--no-native":
        from fpm_torch import native

        runs = {}
        for extra in ([], flags):
            runs[bool(extra)] = str(tmp_path / f"x{len(extra)}")
            assert tcli.main(["run", dataset, "-o", runs[bool(extra)], "--platform", "cpu",
                              "-n", "2", *extra]) == 0
        decoder = {k: _dataset_record(v)["decoder"] for k, v in runs.items()}
        assert decoder == {True: "python", False: "native" if native.available() else "python"}
        a, b = (np.load(os.path.join(d, "object.npy")) for d in runs.values())
        np.testing.assert_array_equal(a, b)
        return
    if flags[0] == "--dft-precision":
        assert tcli.main(["run", dataset, "-o", out, "--platform", "cpu", "-n", "2",
                          "--checkpoint-every", "1", "--use-pallas", *flags]) == 0
        assert _solver_options(out)["dft_precision"] == "bf16x3"
        fp = _checkpoint_fingerprint(os.path.join(out, "ckpt_1.npz"))
        assert fp["dft_precision"] == "bf16x3" and fp["use_pallas"] is True
        assert "kernel DFT precision: bf16x3" in capsys.readouterr().out
        return
    if "--distributed" in flags:
        said = []
        for cli, extra in ((tcli, ["--platform", "cpu"]), (jcli, ["--no-native"])):
            assert cli.main(["run", dataset, "-o", out, *extra, *flags]) == 1
            said.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert said[0].startswith("ERROR: --distributed requested but no multi-host")
        assert said[0].split(" (auto-detect said:")[0] == said[1].split(" (auto-detect said:")[0]
        return
    common = ["-n", "2", "--dtype", "complex128", *flags]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["run", dataset, "-o", out_t, "--platform", "cpu", *common]) == 0
    assert jcli.main(["run", dataset, "-o", out_j, "--no-native", *common]) == 0
    assert _files(out_t) == _files(out_j)
    debug = [f for f in _files(out_t) if f.startswith("debug")]
    if flags == ["--debug"]:
        assert {"debug/iter0001_objF_mag.png", "debug/iter0002_pupil_mag.png"} <= set(debug)
    else:
        assert debug == []
    a, b = (np.load(os.path.join(d, "object.npy")) for d in (out_t, out_j))
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10


def _dataset_record(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return next(r for r in map(json.loads, f) if r["event"] == "dataset")


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


@pytest.mark.parametrize("flags", [
    ["--fov-grid", "2", "2", "--color-mode", "rgb"],
    ["--mesh", "2", "1", "--color-mode", "rgb"],
    ["--mesh", "2", "1", "--fov-grid", "2", "2"],
])
def test_refusals_say_what_fpm_tpus_say(dataset, tmp_path, capsys, flags):
    """fpm_tpu/cli.py:309-317's three refusals, word for word."""
    said = []
    for cli, extra in ((tcli, ["--platform", "cpu"]), (jcli, ["--no-native"])):
        assert cli.main(["run", dataset, "-o", str(tmp_path / "x"), *extra, *flags]) == 1
        said.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert said[0] == said[1] and said[0].startswith("ERROR: ")


# ------------------------------------------------------ large FOV and RGB


@pytest.fixture(scope="module")
def wide_dataset(tmp_path_factory):
    """Whole 48-px camera frames of the Np=16 problem (``--frame-size``)."""
    data = str(tmp_path_factory.mktemp("wide") / "data")
    assert tcli.main(["simulate", data, "--np-size", "16", "--grid", "5", "--seed", "7",
                      "--frame-size", "48"]) == 0
    return os.path.join(data, "dataset.json")


@pytest.fixture(scope="module")
def rgb_dataset(tmp_path_factory):
    """8-bit RGB frames holding three different simulated objects."""
    from PIL import Image

    root = tmp_path_factory.mktemp("rgbsim")
    grays = []
    for seed in (4, 5, 6):
        d = str(root / f"g{seed}")
        assert tcli.main(["simulate", d, "--np-size", "16", "--grid", "5",
                          "--seed", str(seed)]) == 0
        grays.append(d)
    data = root / "rgb"
    data.mkdir()
    for f in sorted(os.listdir(grays[0])):
        if f.endswith(".tif"):
            planes = [np.asarray(Image.open(os.path.join(d, f))) for d in grays]
            Image.fromarray(np.stack([(p // 257).astype(np.uint8) for p in planes],
                                     axis=-1)).save(data / f)
    doc = json.load(open(os.path.join(grays[0], "dataset.json")))
    doc["datasetRoot"] = str(data) + os.sep
    path = str(root / "rgb.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _events(out, name):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["event"] == name]


@pytest.mark.parametrize("extra", [[], ["--checkpoint-every", "1", "--mode", "batched",
                                        "--chunk-size", "8"]])
def test_fov_grid_run_matches_fpm_tpu(wide_dataset, tmp_path, extra):
    """A 3×3 grid of Np=16 ROIs at overlap 4: the same files (with
    ``--checkpoint-every``, the same tiles under tiles/), the same stitch, a
    tile event per tile. (fpm_tpu runs its ROI-sharded path on the 8 CPU
    devices of tests/conftest.py, the port tile after tile.)"""
    common = ["-n", "3", "--dtype", "complex128", "--fov-grid", "3", "3", "--fov-overlap", "4",
              *extra]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["run", wide_dataset, "-o", out_t, "--platform", "cpu", *common]) == 0
    assert jcli.main(["run", wide_dataset, "-o", out_j, "--no-native", *common]) == 0
    assert _files(out_t) == _files(out_j)
    a, b = (np.load(os.path.join(d, "object_stitched.npy")) for d in (out_t, out_j))
    assert a.shape == b.shape == (120, 120)
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10
    assert sorted((e["row"], e["col"]) for e in _events(out_t, "tile")) == [
        (r, c) for r in range(3) for c in range(3)]


@pytest.mark.parametrize("first,second", [(jcli, tcli), (tcli, jcli)])
def test_fov_tiles_resume_across_packages(wide_dataset, tmp_path, first, second):
    """Tiles stored by one CLI are loaded, not solved, by the other's
    ``--resume`` (the two fingerprints agree key for key)."""
    common = ["-n", "2", "--dtype", "complex128", "--fov-grid", "2", "2", "--fov-overlap", "4",
              "--checkpoint-every", "1", "--dft-precision", "highest"]
    plat = {tcli: ["--platform", "cpu"], jcli: ["--no-native"]}
    out = str(tmp_path / "o")
    assert first.main(["run", wide_dataset, "-o", out, *common, *plat[first]]) == 0
    stitched = np.load(os.path.join(out, "object_stitched.npy"))
    before = len(_events(out, "tile"))
    assert second.main(["run", wide_dataset, "-o", out, "--resume", *common,
                        *plat[second]]) == 0
    assert len(_events(out, "tile")) == before == 4
    assert np.array_equal(np.load(os.path.join(out, "object_stitched.npy")), stitched)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_rgb_run_matches_fpm_tpu(rgb_dataset, tmp_path, mode):
    common = ["-n", "3", "--dtype", "complex128", "--color-mode", "rgb", "--mode", mode,
              "--chunk-size", "8"]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["run", rgb_dataset, "-o", out_t, "--platform", "cpu", *common]) == 0
    assert jcli.main(["run", rgb_dataset, "-o", out_j, "--no-native", *common]) == 0
    assert _files(out_t) == _files(out_j)
    for ch in ("red", "green", "blue"):
        for name in ("object.npy", "object_spectrum.npy", "pupil.npy"):
            a, b = (np.load(os.path.join(d, ch, name)) for d in (out_t, out_j))
            assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10, (ch, name)
    red, green = (np.load(os.path.join(out_t, c, "object.npy")) for c in ("red", "green"))
    assert not np.array_equal(red, green)


def test_rgb_checkpoint_resumes_across_packages(rgb_dataset, tmp_path):
    """fpm_tpu's stacked (3, ...) sweep checkpoint resumes in the port."""
    common = ["--dtype", "complex128", "--color-mode", "rgb", "--dft-precision", "highest"]
    out, full = str(tmp_path / "split"), str(tmp_path / "full")
    assert jcli.main(["run", rgb_dataset, "-o", out, "-n", "2", "--checkpoint-every", "1",
                      "--no-native", *common]) == 0
    assert tcli.main(["run", rgb_dataset, "-o", out, "-n", "3", "--resume", "--platform", "cpu",
                      *common]) == 0
    assert tcli.main(["run", rgb_dataset, "-o", full, "-n", "3", "--platform", "cpu",
                      *common]) == 0
    a, b = (np.load(os.path.join(d, "blue", "object_spectrum.npy")) for d in (out, full))
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10


@pytest.mark.parametrize("path", ["single", "fov", "rgb"])
def test_watchdog_timeout_is_armed_on_every_path(dataset, wide_dataset, rgb_dataset, tmp_path,
                                                 path):
    cfg, extra = {"single": (dataset, []),
                  "fov": (wide_dataset, ["--fov-grid", "2", "2", "--fov-overlap", "4"]),
                  "rgb": (rgb_dataset, ["--color-mode", "rgb"])}[path]
    out = str(tmp_path / "w")
    assert tcli.main(["run", cfg, "-o", out, "-n", "2", "--platform", "cpu",
                      "--watchdog-timeout", "60", *extra]) == 0


def test_watchdog_aborts_a_stalled_run(dataset, tmp_path):
    """A run whose solve makes no progress within the timeout is aborted with
    exit code 42 (its first chunk is watched too)."""
    import subprocess
    import sys

    stall = ("import sys, time; from fpm_torch import cli; import fpm_torch.models.epry as e; "
             "e.reconstruct = lambda *a, **k: time.sleep(30); "
             "sys.exit(cli.main(sys.argv[1:]))")
    proc = subprocess.run([sys.executable, "-c", stall, "run", dataset, "-o",
                           str(tmp_path / "s"), "-n", "2", "--platform", "cpu",
                           "--watchdog-timeout", "1"], capture_output=True, text=True,
                          timeout=60, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 42
    assert "WATCHDOG" in proc.stderr


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
