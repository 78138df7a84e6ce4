"""The port's RGB path and whole-frame ingest on the CPU against fpm_tpu's:
the decode-once RGB loader and the full-frame loader bitwise (fpm_tpu's
Python path, ``use_native=False``); ``reconstruct_channels`` in complex128
≤ 1e-10, and each channel bitwise the port's own single-channel solve
(tests/test_solver_parity.py:71-93's three routes)."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from fpm_torch.config import load_config as t_load_config
from fpm_torch.data import loader as tload
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.models import epry as tepry
from fpm_tpu.config import load_config as j_load_config
from fpm_tpu.data import loader as jload
from fpm_tpu.models import epry as jepry

TOL = 1e-10


def _write(root, frames, ds, extra=None):
    """``frames`` (K, H, W[, 3]) as iLED TIFFs plus a dataset.json of ``ds``'s optics."""
    import json

    root.mkdir()
    for i, led in enumerate(ds.geom.led_numbers):
        Image.fromarray(frames[i]).save(root / f"iLED_{led}.tif")
    doc = {"datasetRoot": str(root) + "/", "filePrefix": "iLED_", "fileExtension": ".tif",
           "cropSizeX": 16, "pixelSize": ds.cfg.pixel_size, "objectiveMag": ds.cfg.objective_mag,
           "objectiveNA": ds.cfg.objective_na, "maxIlluminationNA": ds.cfg.max_illumination_na,
           "lambda": ds.cfg.wavelength, "cropX": 2, "cropY": 3, "bk1cropX": 0, "bk1cropY": 0,
           "bk2cropX": 20, "bk2cropY": 20, "bgThresh": 40, "darkfieldExpMultiplier": 2,
           "delta1": ds.cfg.delta1, "delta2": ds.cfg.delta2, "ledCount": int(ds.cfg.led_count),
           "holeCoordinates": [[{"x": float(x)}, {"y": float(y)}, {"z": float(z)}]
                               for x, y, z in ds.cfg.hole_coordinates], **(extra or {})}
    path = root / "dataset.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture(scope="module")
def rgb_config(tmp_path_factory):
    """Three different 40-px objects in the planes of 8-bit RGB frames, a
    background and darkfield division to preprocess."""
    planes = []
    for seed in (1, 2, 3):
        ds = synthetic_dataset(np_size=40, grid=5, seed=seed, quantize=True, raw_frames=True)
        planes.append((np.clip(ds.images, 0, 65535) / 130 + 17).astype(np.uint8))
    return _write(tmp_path_factory.mktemp("rgb") / "data", np.stack(planes, axis=-1), ds)


@pytest.fixture(scope="module")
def gray_config(tmp_path_factory):
    ds = synthetic_dataset(np_size=40, grid=5, seed=4, quantize=True, raw_frames=True)
    frames = np.clip(ds.images + 30, 0, 65535).astype(np.uint16)
    return _write(tmp_path_factory.mktemp("gray") / "data", frames, ds)


def _same_dataset(a, b):
    assert np.array_equal(a.images, b.images) and a.images.dtype == b.images.dtype
    assert np.array_equal(a.bg_values, b.bg_values)
    assert np.array_equal(a.geom.led_numbers, b.geom.led_numbers)
    assert (a.cfg.color, a.cfg.color_channel) == (b.cfg.color, b.cfg.color_channel)


@pytest.mark.parametrize("which", ["rgb", "gray"])
def test_load_dataset_rgb_is_fpm_tpus(rgb_config, gray_config, which):
    path = rgb_config if which == "rgb" else gray_config
    got = tload.load_dataset_rgb(t_load_config(path))
    ref = jload.load_dataset_rgb(j_load_config(path), use_native=False)
    assert len(got) == 3
    for a, b in zip(got, ref):
        _same_dataset(a, b)
    if which == "rgb":
        assert not np.array_equal(got[0].images, got[1].images)


def test_load_dataset_rgb_is_three_channel_loads(rgb_config):
    cfg = t_load_config(rgb_config)
    for ch, bgr in zip(tload.load_dataset_rgb(cfg), (2, 1, 0)):
        _same_dataset(ch, tload.load_dataset(dataclasses.replace(cfg, color=True,
                                                                 color_channel=bgr)))


@pytest.mark.parametrize("which", ["rgb", "gray"])
def test_full_frames_are_fpm_tpus(rgb_config, gray_config, which):
    path = rgb_config if which == "rgb" else gray_config
    got = tload.load_dataset(t_load_config(path), full_frames=True)
    ref = jload.load_dataset(j_load_config(path), full_frames=True, use_native=False)
    _same_dataset(got, ref)
    assert got.images.shape[1:] == (40, 40)


def test_native_decoder_is_still_refused(gray_config):
    """Refused until the native decoder was ported: the decode-once RGB load
    now runs through it, each channel bitwise the Python path's."""
    from fpm_torch import native

    cfg = t_load_config(gray_config)
    if not native.available():
        with pytest.raises(RuntimeError, match="native decoder"):
            tload.load_dataset_rgb(cfg, use_native=True)
        return
    for nat, pil in zip(tload.load_dataset_rgb(cfg, use_native=True),
                        tload.load_dataset_rgb(cfg, use_native=False)):
        np.testing.assert_array_equal(nat.images, pil.images)
        np.testing.assert_array_equal(nat.bg_values, pil.bg_values)


@pytest.fixture(scope="module")
def channels():
    ds = synthetic_dataset(np_size=16, grid=5, quantize=True)
    return ds, [ds.images, ds.images * 0.8 + 1.0, ds.images * 1.2]


@pytest.mark.parametrize("kw", [dict(), dict(mode="batched", chunk_size=8)])
def test_reconstruct_channels_matches_fpm_tpu(channels, kw):
    ds, chans = channels
    got = tepry.reconstruct_channels(chans, ds.geom, ds.cfg, iterations=3, dtype="complex128",
                                     device="cpu", **kw)
    from fpm_tpu.data.simulate import synthetic_dataset as j_synthetic

    jds = j_synthetic(np_size=16, grid=5, quantize=True)
    ref = jepry.reconstruct_channels(chans, jds.geom, jds.cfg, iterations=3, dtype="complex128",
                                     **kw)
    for a, b in zip(got, ref):
        for key in ("obj_crop", "obj_f_centered", "pupil"):
            x, y = getattr(a, key), getattr(b, key)
            assert np.abs(x - y).max() / np.abs(y).max() <= TOL, key
        np.testing.assert_allclose(a.metrics["data_residual"], b.metrics["data_residual"],
                                   rtol=1e-9)


@pytest.mark.parametrize("kw", [dict(), dict(mode="batched", chunk_size=8),
                                dict(mode="batched", chunk_size=8, use_pallas=True)])
def test_channels_are_bitwise_separate_solves(channels, kw):
    ds, chans = channels
    got = tepry.reconstruct_channels(chans, ds.geom, ds.cfg, iterations=3, dtype="complex128",
                                     device="cpu", **kw)
    for images, res in zip(chans, got):
        alone = tepry.reconstruct(images, ds.geom, ds.cfg, iterations=3, dtype="complex128",
                                  device="cpu", **kw)
        for key in ("obj_crop", "obj_f_centered", "pupil"):
            assert np.array_equal(getattr(res, key), getattr(alone, key)), key
        assert np.array_equal(res.metrics["data_residual"], alone.metrics["data_residual"])


def test_channels_resume_from_a_stacked_state(channels):
    """Three sweeps, or one then two more from the stacked (3, ...) state a
    checkpoint holds: the same result."""
    ds, chans = channels
    kw = dict(geom=ds.geom, cfg=ds.cfg, dtype="complex128", device="cpu")
    whole = tepry.reconstruct_channels(chans, iterations=3, **kw)
    first = tepry.reconstruct_channels(chans, iterations=1, **kw)
    state = (np.stack([r.obj_f_centered for r in first]), np.stack([r.pupil for r in first]))
    rest = tepry.reconstruct_channels(chans, iterations=2, initial_state=state, **kw)
    for a, b in zip(whole, rest):
        assert np.array_equal(a.obj_crop, b.obj_crop)


def test_reconstruct_channels_on_cuda_needs_the_kernels(channels):
    ds, chans = channels
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tepry.reconstruct_channels(chans, ds.geom, ds.cfg, iterations=1)
    else:
        with pytest.raises(ValueError, match="use_pallas"):
            tepry.reconstruct_channels(chans, ds.geom, ds.cfg, iterations=1)
