"""Host layer of the PyTorch port against fpm_tpu, bitwise: config parsing,
LED geometry and schedule, the simulator, the Python (PIL) loader, and the
checkpoint fingerprint. All of it is NumPy on both sides, so the arrays
must be equal, not close."""

import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

import fpm_torch.config as tconfig
import fpm_torch.geometry as tgeom
import fpm_tpu.config as jconfig
import fpm_tpu.geometry as jgeom
from fpm_torch.data import loader as tloader
from fpm_torch.data import simulate as tsim
from fpm_torch.utils import checkpoint as tckpt
from fpm_tpu.data import loader as jloader
from fpm_tpu.data import simulate as jsim
from fpm_tpu.utils import checkpoint as jckpt


# Fields the port's dataclasses add to fpm_tpu's: the loader records which
# decoder ran and how many files fell back to PIL.
PORT_ONLY_FIELDS = {"decoder", "fallback_files"}


def assert_same(a, b):
    """Equal dataclasses / arrays / scalars, field by field (the port's
    ``a`` may add the fields in PORT_ONLY_FIELDS)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        theirs = {f.name for f in dataclasses.fields(b)}
        for f in dataclasses.fields(a):
            if f.name not in theirs:
                assert f.name in PORT_ONLY_FIELDS
                continue
            assert_same(getattr(a, f.name), getattr(b, f.name))
        assert theirs <= {f.name for f in dataclasses.fields(a)}
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


DOME_CONFIGS = [
    {},                                             # every inline default
    {"maxIlluminationNA": 0.45},                    # the mono dome problem, K=193
    {"cropSizeX": 100, "pixelSize": 4.0, "objectiveMag": 10, "lambda": 0.55,
     "arrayRotation": 12.5, "flipDatasetY": True, "ledCount": 300},
    {"bgThreh": 20, "flipDatasetX": True, "iterations": 7, "dtype": "complex128"},
]


@pytest.mark.parametrize("doc", DOME_CONFIGS)
def test_config_and_geometry_match_bitwise(doc):
    ct, cj = tconfig.load_config(doc), jconfig.load_config(doc)
    assert_same(ct, cj)
    for attr in ("ps_eff", "du", "res_improvement_factor", "n_large", "recovered_pixel_size"):
        assert getattr(ct, attr) == getattr(cj, attr)
    np.testing.assert_array_equal(ct.coordinates(), cj.coordinates())
    gt, gj = tgeom.compute_geometry(ct), jgeom.compute_geometry(cj)
    assert_same(gt, gj)
    np.testing.assert_array_equal(gt.sorted_led_numbers(), gj.sorted_led_numbers())
    assert tgeom.pupil_radius(ct) == jgeom.pupil_radius(cj)
    for centered in (False, True):
        np.testing.assert_array_equal(tgeom.pupil_support(ct, centered),
                                      jgeom.pupil_support(cj, centered))


def test_mono_dome_schedule_index_for_index():
    cfg_t = tconfig.FPMConfig(max_illumination_na=0.45)
    cfg_j = jconfig.FPMConfig(max_illumination_na=0.45)
    gt, gj = tgeom.compute_geometry(cfg_t), jgeom.compute_geometry(cfg_j)
    assert gt.num_leds == 193 and cfg_t.n_large == 360
    np.testing.assert_array_equal(gt.schedule, gj.schedule)
    np.testing.assert_array_equal(gt.crop_start[gt.schedule], gj.crop_start[gj.schedule])


def test_lenient_json_and_aliases(tmp_path):
    """JsonCpp trailing commas, commas inside strings, and the three quirk
    aliases (bgThreh, holePositions as (z, y, x), holeCoordinatFile)."""
    coords = [[0.001 * i, -0.002 * i, 0.06] for i in range(12)]
    (tmp_path / "leds.json").write_text(json.dumps({"holeCoordinates": coords}))
    text = ('{"filePrefix": "a,]", "bgThreh": 33, "holeCoordinatFile": "leds.json",\n'
            ' "cropSizeX": 16, "maxIlluminationNA": 0.2,\n}')
    path = tmp_path / "dataset_x.json"
    path.write_text(text)
    ct, cj = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    assert ct.file_prefix == "a,]" and ct.bg_threshold == 33
    assert_same(ct, cj)
    np.testing.assert_array_equal(ct.coordinates(), cj.coordinates())

    zyx = {"holePositions": [[0.06, 0.001 * i, 0.002 * i] for i in range(9)]}
    assert_same(tconfig.load_config(zyx), jconfig.load_config(zyx))
    np.testing.assert_array_equal(tconfig.load_config(zyx).coordinates()[:, 2], 0.06)


@pytest.mark.parametrize("kw", [
    dict(np_size=16, grid=5, seed=0),
    dict(np_size=32, grid=7, seed=2, quantize=True, aberrated_pupil=True),
    dict(np_size=16, grid=5, seed=1, jitter=0.1, raw_frames=True,
         darkfield_exp_multiplier=3),
])
def test_synthetic_dataset_matches_bitwise(kw):
    assert_same(tsim.synthetic_dataset(**kw), jsim.synthetic_dataset(**kw))


def _write_stack(root, frames, led_numbers, **cfg_keys):
    os.makedirs(root, exist_ok=True)
    for frame, led in zip(frames, led_numbers):
        Image.fromarray(frame).save(os.path.join(root, f"iLED_{led}.tif"))
    doc = {"datasetRoot": str(root) + os.sep, "filePrefix": "iLED_",
           "fileExtension": ".tif", **cfg_keys}
    path = os.path.join(root, "dataset.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _darkfield_stack(tmp_path):
    """dataset.json + TIFFs of a stack with darkfield frames and a
    background."""
    ds = tsim.synthetic_dataset(np_size=16, grid=5, seed=4, quantize=True,
                                raw_frames=True, darkfield_exp_multiplier=2)
    rng = np.random.default_rng(0)
    frames = np.zeros((ds.geom.num_leds, 24, 24), np.uint16)
    frames[:, 4:20, 3:19] = ds.images
    frames += rng.integers(0, 40, frames.shape, dtype=np.uint16)   # a background
    path = _write_stack(
        tmp_path / "data", frames, ds.geom.led_numbers, cropSizeX=16, cropX=3, cropY=4,
        bk1cropX=0, bk1cropY=0, bk2cropX=8, bk2cropY=8, bgThresh=25,
        darkfieldExpMultiplier=2, pixelSize=1.0, objectiveMag=1.0, objectiveNA=0.15,
        maxIlluminationNA=0.33, ledCount=int(ds.cfg.led_count),
        holeCoordinates=ds.cfg.hole_coordinates.tolist())
    return path


def test_python_loader_matches_bitwise(tmp_path):
    """dataset.json + TIFFs through both loaders' Python decode path:
    ROI crop, darkfield division, clamped background, saturating subtract."""
    path = _darkfield_stack(tmp_path)
    lt = tloader.load_dataset(tconfig.load_config(path), use_native=False)
    lj = jloader.load_dataset(jconfig.load_config(path), use_native=False)
    assert_same(lt, lj)
    assert lt.bg_values.max() > 0 and lt.images.dtype == np.uint16


def test_loader_native_path_not_ported(tmp_path):
    """Refused until the native decoder was ported: ``use_native=True`` now
    decodes through it, bitwise fpm_tpu's Python path (where it cannot be
    built it raises, as fpm_tpu's loader does without its library)."""
    from fpm_torch import native

    path = _darkfield_stack(tmp_path)
    if not native.available():
        with pytest.raises(RuntimeError, match="native decoder"):
            tloader.load_dataset(tconfig.load_config(path), use_native=True)
        return
    assert_same(tloader.load_dataset(tconfig.load_config(path), use_native=True),
                jloader.load_dataset(jconfig.load_config(path), use_native=False))


def test_checkpoint_fingerprint_and_layout_match(tmp_path):
    ds = tsim.synthetic_dataset(np_size=16, grid=5)
    opts = dict(mode="batched", chunk_size=8, use_pallas=True, mesh=None)
    assert tckpt.fingerprint(ds.cfg, ds.geom, **opts) == jckpt.fingerprint(ds.cfg, ds.geom, **opts)
    o = np.arange(6, dtype=np.complex64).reshape(2, 3)
    p = np.ones((2, 2), np.complex64)
    fp = tckpt.fingerprint(ds.cfg, ds.geom, **opts)
    tckpt.save_checkpoint(str(tmp_path / "ckpt_3.npz"), o, p, 3, meta=fp)
    got = jckpt.load_checkpoint(str(tmp_path / "ckpt_3.npz"), expect=fp)
    np.testing.assert_array_equal(got[0], o)
    assert got[2] == 3
    jckpt.save_checkpoint(str(tmp_path / "ckpt_5.npz"), o, p, 5, meta=fp)
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_5.npz")
    with pytest.raises(tckpt.CheckpointMismatch):
        tckpt.load_checkpoint(str(tmp_path / "ckpt_5.npz"),
                              expect=tckpt.fingerprint(ds.cfg, ds.geom, mode="sequential"))
