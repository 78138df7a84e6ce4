"""The port's native C++ ingest (``fpm_torch.native``) against its own PIL
path and against ``fpm_tpu``'s loader on the PIL path: the counterparts of
the ten tests of tests/test_native.py, with the same files. Tolerance: bit
for bit (uint16 frames, int16 backgrounds). The library builds with ``g++``
into the git-ignored ``build/``; the fixture skips where it cannot be built
(no ``g++``, no ``zlib.h``)."""

import dataclasses
import os
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
from test_native import _write_gray16, _write_rgb8, _write_tiff_manual

from fpm_torch import native
from fpm_torch.config import FPMConfig as TorchConfig
from fpm_torch.data.loader import load_dataset, load_dataset_rgb
from fpm_tpu.config import FPMConfig as JaxConfig
from fpm_tpu.data.loader import load_dataset as jax_load_dataset
from fpm_tpu.data.loader import load_dataset_rgb as jax_load_dataset_rgb

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip(f"the native decoder cannot be built here: {native.build_error()}")
    assert REPO / "build" in native.library_path().parents
    return True


def _cfgs(tmp_path, color=False, darkfield_mult=1, n=12, **extra):
    """test_native.py's configuration, as (the port's, fpm_tpu's)."""
    kw = dict(
        dataset_root=str(tmp_path) + os.sep, np_size=n, crop_x=3, crop_y=5,
        bk1_crop_x=30, bk1_crop_y=30, bk2_crop_x=2, bk2_crop_y=30, bg_threshold=90.0,
        color=color, darkfield_exp_multiplier=darkfield_mult, pixel_size=1.0,
        objective_mag=1.0, objective_na=0.3, max_illumination_na=0.8, wavelength=0.5,
        led_count=4, hole_coordinates=np.array([[0.0, 0.0, 50.0], [5.0, 0.0, 50.0],
                                                [0.0, 5.0, 50.0], [30.0, 0.0, 50.0]]))
    kw.update(extra)
    return TorchConfig(**kw), JaxConfig(**kw)


def _same(a, b):
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.bg_values, b.bg_values)


def _native_against_python(tmp_path, full_frames=False, **cfg_kw):
    """The port's native load, held bitwise against its PIL load and
    fpm_tpu's; returns it."""
    cfg, jcfg = _cfgs(tmp_path, **cfg_kw)
    nat = load_dataset(cfg, use_native=True, full_frames=full_frames)
    pil = load_dataset(cfg, use_native=False, full_frames=full_frames)
    _same(nat, pil)
    _same(nat, jax_load_dataset(jcfg, use_native=False, full_frames=full_frames))
    assert (nat.decoder, pil.decoder, pil.fallback_files) == ("native", "python", 0)
    return nat


def test_the_decoder_source_is_fpm_tpus_byte_for_byte():
    assert (REPO / "fpm_torch/native/fpm_io.cpp").read_bytes() == \
        (REPO / "fpm_tpu/native/fpm_io.cpp").read_bytes()


def test_native_matches_python_gray16(tmp_path, built):
    rng = np.random.default_rng(0)
    for led in (1, 2, 3, 4):
        _write_gray16(tmp_path / f"iLED_{led}.tif", rng)
    _native_against_python(tmp_path, darkfield_mult=3)


def test_native_matches_python_rgb(tmp_path, built):
    rng = np.random.default_rng(1)
    for led in (1, 2, 3):
        _write_rgb8(tmp_path / f"iLED_{led}.tif", rng)
    _native_against_python(tmp_path, color=True)


def test_native_flags_missing_file(tmp_path, built):
    cfg, _ = _cfgs(tmp_path)
    _write_gray16(tmp_path / "iLED_1.tif", np.random.default_rng(2))
    _, _, status = native.load_and_preprocess(
        [str(tmp_path / "iLED_1.tif"), str(tmp_path / "nope.tif")], cfg, np.zeros(2, bool), 0)
    assert status.tolist() == [0, 1]


def test_unsupported_tiff_per_file_fallback(tmp_path, built):
    """A PackBits TIFF is flagged by the decoder and decoded by PIL alone."""
    rng = np.random.default_rng(3)
    for led in (1, 2, 4):
        _write_gray16(tmp_path / f"iLED_{led}.tif", rng)
    img = rng.integers(0, 4000, size=(48, 48), dtype=np.uint16)
    Image.fromarray(img).save(tmp_path / "iLED_3.tif", compression="packbits")
    cfg, _ = _cfgs(tmp_path)
    _, _, status = native.load_and_preprocess(
        [str(tmp_path / f"iLED_{n}.tif") for n in (1, 2, 3, 4)], cfg, np.zeros(4, bool), 0)
    assert status.tolist() == [0, 0, 1, 0]
    assert _native_against_python(tmp_path).fallback_files == 1


def test_compressed_tiff_native_decode(tmp_path, built):
    """LZW and Deflate 16-bit TIFFs decode natively, no file falling back."""
    rng = np.random.default_rng(4)
    for led, comp in ((1, "tiff_lzw"), (2, "tiff_adobe_deflate"), (3, None)):
        img = rng.integers(0, 60000, size=(48, 48), dtype=np.uint16)
        Image.fromarray(img).save(tmp_path / f"iLED_{led}.tif",
                                  **({"compression": comp} if comp else {}))
    _write_gray16(tmp_path / "iLED_4.tif", rng)
    cfg, _ = _cfgs(tmp_path)
    _, _, status = native.load_and_preprocess(
        [str(tmp_path / f"iLED_{n}.tif") for n in (1, 2, 3, 4)], cfg, np.zeros(4, bool), 0)
    assert status.tolist() == [0, 0, 0, 0]
    _native_against_python(tmp_path)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("big_endian", [False, True])
def test_tiff_decode_matrix(tmp_path, built, tiled, deflate, predictor, big_endian):
    """{strip, tile} × {raw, deflate} × {predictor 1, 2} × {LE, BE}, 16-bit,
    partial strips and tiles: the native frame is the written array. The
    two PIL paths agree bitwise, and with the native one but where PIL
    ignores predictor 2 on uncompressed data."""
    arr = np.random.default_rng(5).integers(0, 60000, size=(45, 57), dtype=np.uint16)
    _write_tiff_manual(tmp_path / "iLED_1.tif", arr, tiled=tiled, tile=(16, 16),
                       deflate=deflate, predictor=predictor, big_endian=big_endian,
                       rows_per_strip=None if tiled else 10)
    cfg, jcfg = _cfgs(tmp_path, bg_threshold=0)
    frames, _, status = native.load_frames([str(tmp_path / "iLED_1.tif")], cfg,
                                           np.zeros(1, np.uint8), (45, 57))
    assert status.tolist() == [0]
    np.testing.assert_array_equal(frames[0], arr)
    pil = load_dataset(cfg, use_native=False, full_frames=True)
    _same(pil, jax_load_dataset(jcfg, use_native=False, full_frames=True))
    nat = load_dataset(cfg, use_native=True, full_frames=True)
    np.testing.assert_array_equal(nat.images[0], arr)
    if deflate or predictor == 1:
        _same(nat, pil)


def test_rgb_decode_once_matches_per_channel_loads(tmp_path, built):
    """load_dataset_rgb (one decode per file) is bitwise three per-channel
    loads on both paths, and fpm_tpu's decode-once PIL load: a grayscale
    file in the colour stack, per-channel backgrounds, and an LZW file."""
    rng = np.random.default_rng(21)
    for led in (1, 2):
        _write_rgb8(tmp_path / f"iLED_{led}.tif", rng)
    _write_gray16(tmp_path / "iLED_3.tif", rng)
    img = rng.integers(0, 255, size=(48, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "iLED_4.tif", compression="tiff_lzw")
    cfg, jcfg = _cfgs(tmp_path, color=True, darkfield_mult=3)
    theirs = jax_load_dataset_rgb(jcfg, use_native=False)
    for use_native in (True, False):
        channels = load_dataset_rgb(cfg, use_native=use_native)
        assert len(channels) == 3
        for ds, ref_j, bgr in zip(channels, theirs, (2, 1, 0)):
            ref = load_dataset(dataclasses.replace(cfg, color=True, color_channel=bgr),
                               use_native=use_native)
            assert ds.cfg.color_channel == bgr
            _same(ds, ref)
            _same(ds, ref_j)


def test_native_full_frames_matches_python(tmp_path, built):
    rng = np.random.default_rng(11)
    for led in range(1, 5):
        _write_gray16(tmp_path / f"iLED_{led}.tif", rng)
    nat = _native_against_python(tmp_path, full_frames=True, darkfield_mult=3)
    assert nat.images.shape == (nat.geom.num_leds, 48, 48)


def test_native_full_frames_unsupported_file_falls_back(tmp_path, built):
    """A whole frame the decoder flags (here one of another size) is decoded
    by PIL alone; the rest natively."""
    rng = np.random.default_rng(12)
    for led in range(1, 4):
        _write_gray16(tmp_path / f"iLED_{led}.tif", rng)
    Image.fromarray(rng.integers(0, 4000, size=(48, 48), dtype=np.uint16)).save(
        tmp_path / "iLED_4.tif", compression="packbits")
    cfg, _ = _cfgs(tmp_path)
    _, _, status = native.load_frames([str(tmp_path / f"iLED_{n}.tif") for n in range(1, 5)],
                                      cfg, np.zeros(4, bool), (48, 48))
    assert status.tolist() == [0, 0, 0, 1]
    assert _native_against_python(tmp_path, full_frames=True).fallback_files == 1


def test_corrupt_tiff_variants_fail_gracefully(tmp_path, built):
    """Truncated, bit-flipped and adversarial TIFF bytes are flagged (status
    1) or decode to the right array; the process never crashes."""
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 60000, size=(32, 40), dtype=np.uint16)
    src = tmp_path / "good.tif"
    Image.fromarray(arr).save(src, compression="tiff_adobe_deflate")
    good = src.read_bytes()
    cfg, _ = _cfgs(tmp_path, n=8, bg_threshold=0)

    def probe(raw, name):
        p = tmp_path / name
        p.write_bytes(raw)
        frames, _, status = native.load_frames([str(p)], cfg, np.zeros(1, np.uint8), (32, 40))
        if status[0] == 0:
            np.testing.assert_array_equal(frames[0], arr)

    for cut in range(0, len(good), 7):
        probe(good[:cut], f"trunc_{cut}.tif")
    for trial in range(40):
        raw = bytearray(good)
        for _ in range(4):
            i = int(rng.integers(0, len(raw)))
            raw[i] ^= 1 << int(rng.integers(0, 8))
        probe(bytes(raw), f"flip_{trial}.tif")
    _write_tiff_manual(tmp_path / "adv1.tif", arr, rows_per_strip=8)
    adv = (tmp_path / "adv1.tif").read_bytes()
    probe(adv[:len(adv) // 2], "adv_half.tif")
    probe(good[:200] + zlib.compress(b"\x00" * 10_000_000), "adv_bomb.tif")
