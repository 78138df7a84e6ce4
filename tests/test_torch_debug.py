"""The port's debug dumps against fpm_tpu's: ``led_intermediates`` (the six
working spectra of one LED update, replayed on the CPU here) within 1e-10
in complex128 and 1e-4 in complex64 of fpm_tpu's, from the init state and
after one sweep, at schedule positions 0, 3 and the last, and an
out-of-range position refused with fpm_tpu's error; ``run --debug`` and
``--debug --debug-led 3`` through both CLIs (the counterparts of
tests/test_cli.py's debug tests, also in batched mode and on a mesh) give the
same files under ``debug/`` and the same object; ``--debug`` keeps the
traceback of an ``OSError``."""

import json
import os

import numpy as np
import pytest

from fpm_torch import cli as tcli
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.models import epry as tepry
from fpm_tpu import cli as jcli
from fpm_tpu.models import epry as jepry

LIMIT = {"complex128": 1e-10, "complex64": 1e-4}


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=4)


@pytest.fixture(scope="module")
def states(ds):
    """The sweep-entry states: fpm_tpu's init (no sweep) and its state after
    one sequential sweep, both complex128."""
    init = jepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=0, dtype="complex128")
    one = jepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=1, dtype="complex128")
    return {"init": (init.obj_f_centered, init.pupil), "one sweep": (one.obj_f_centered,
                                                                     one.pupil)}


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
@pytest.mark.parametrize("position", ["0", "3", "last"])
@pytest.mark.parametrize("state", ["init", "one sweep"])
def test_led_intermediates_match_fpm_tpu(ds, states, state, position, dtype):
    k = len(ds.geom.schedule) - 1 if position == "last" else int(position)
    ref = jepry.led_intermediates(states[state], ds.images, ds.geom, ds.cfg, k, dtype=dtype)
    got = tepry.led_intermediates(states[state], ds.images, ds.geom, ds.cfg, k, dtype=dtype,
                                  device="cpu")
    assert sorted(got) == sorted(ref) == sorted(["objf_crop", "objf_crop_p", "obj_crop_p",
                                                 "objf_up", "d_obj", "pupil"])
    for name, b in ref.items():
        a = got[name]
        assert a.shape == b.shape == (ds.cfg.np_size,) * 2
        assert np.abs(a - b).max() / np.abs(b).max() <= LIMIT[dtype], name


def test_led_intermediates_take_the_state_as_planes(ds, states):
    """The state as (2, ...) real/imag planes, as fpm_tpu's _planes gives it."""
    o, p = states["one sweep"]
    planes = (np.stack([o.real, o.imag]), np.stack([p.real, p.imag]))
    a = tepry.led_intermediates(planes, ds.images, ds.geom, ds.cfg, 2, dtype="complex128",
                                device="cpu")
    b = tepry.led_intermediates((o, p), ds.images, ds.geom, ds.cfg, 2, dtype="complex128",
                                device="cpu")
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("position", [-1, "K"])
def test_led_intermediates_refuse_a_position_outside_the_schedule(ds, states, position):
    n = len(ds.geom.schedule)
    k = n if position == "K" else position
    said = []
    for fn, extra in ((tepry.led_intermediates, {"device": "cpu"}),
                      (jepry.led_intermediates, {})):
        with pytest.raises(ValueError) as err:
            fn(states["init"], ds.images, ds.geom, ds.cfg, k, **extra)
        said.append(str(err.value))
    assert said[0] == said[1] == f"led_index {k} outside schedule [0, {n})"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The Np=16 grid-5 set with centerLED 13, the 5x5 grid's center."""
    data = str(tmp_path_factory.mktemp("dbg") / "data")
    assert tcli.main(["simulate", data, "--np-size", "16", "--grid", "5", "--seed", "5"]) == 0
    path = os.path.join(data, "dataset.json")
    doc = json.load(open(path))
    doc["centerLED"] = 13
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("flags", [
    ["-n", "3", "--debug"],                                  # tests/test_cli.py:382
    ["-n", "2", "--debug", "--debug-led", "3"],               # tests/test_cli.py:398
    ["-n", "2", "--debug", "--debug-led", "3", "--mode", "batched", "--chunk-size", "8"],
    ["-n", "2", "--debug", "--debug-led", "3", "--mesh", "2", "1", "--chunk-size", "8"],
], ids=["debug", "debug-led", "batched", "mesh"])
def test_debug_runs_write_what_fpm_tpus_write(dataset, tmp_path, flags):
    common = ["--dtype", "complex128", *flags]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["run", dataset, "-o", out_t, "--platform", "cpu", *common]) == 0
    assert jcli.main(["run", dataset, "-o", out_j, "--no-native", *common]) == 0
    assert _files(out_t) == _files(out_j)
    debug = {f for f in _files(out_t) if f.startswith("debug/")}
    sweeps = int(flags[1])
    want = {f"debug/iter{i:04d}_{s}_mag.png" for i in range(1, sweeps + 1)
            for s in ("objF", "pupil")}
    want.add("debug/center_led_13.png")
    if "--debug-led" in flags:
        want |= {f"debug/iter{i:04d}_led0003_{s}_mag.png" for i in range(1, sweeps + 1)
                 for s in ("objf_crop", "objf_crop_p", "obj_crop_p", "objf_up", "d_obj",
                           "pupil")}
    assert debug == want
    a, b = (np.load(os.path.join(d, "object.npy")) for d in (out_t, out_j))
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-10


@pytest.mark.parametrize("cli", [tcli, jcli], ids=["fpm_torch", "fpm_tpu"])
def test_debug_keeps_the_traceback_of_an_oserror(tmp_path, capsys, cli):
    missing = str(tmp_path / "no_such_dataset.json")
    extra = ["--platform", "cpu"] if cli is tcli else ["--no-native"]
    assert cli.main(["run", missing, "-o", str(tmp_path / "o"), *extra]) == 1
    assert capsys.readouterr().err.startswith("ERROR: ")
    with pytest.raises(FileNotFoundError):
        cli.main(["run", missing, "-o", str(tmp_path / "o"), "--debug", *extra])
