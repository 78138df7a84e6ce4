"""Image-stack ingestion: ``loadFPMDataset`` on the host.

The same ingestion contract as ``fpm_tpu.data.loader`` (fpmMain.cpp:36-271):
directory scan with ``{prefix}{led#}{ext}`` filename parsing, per-LED PIL
decode, ROI crop, darkfield exposure division, two-point background
estimation clamped at ``bgThreshold`` and saturating subtraction. Only the
Python decode path is ported; the ctypes wrapper over the native C++ decoder
(``fpm_tpu/native/fpm_io.cpp``) comes in a later slice, so
``use_native=True`` raises.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from ..config import FPMConfig
from ..geometry import LEDGeometry, compute_geometry


@dataclasses.dataclass
class LoadedDataset:
    cfg: FPMConfig
    geom: LEDGeometry
    images: np.ndarray     # (K, Np, Np) uint16, bg-subtracted, ordered by geom.led_numbers
    bg_values: np.ndarray  # (K,) int16 per-LED background estimate


def scan_directory(cfg: FPMConfig) -> list[tuple[int, str]]:
    """Find ``{prefix}{number}{ext}`` files; return (led_num, path) pairs
    sorted by LED number (fpmMain.cpp:63-75, without readdir's order)."""
    out = []
    pat = re.compile(
        re.escape(cfg.file_prefix) + r"(\d+)" + re.escape(cfg.file_extension) + r"$"
    )
    root = cfg.dataset_root
    for name in os.listdir(root):
        m = pat.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort()
    return out


def _decode_image(path: str, color: bool, color_channel: int) -> np.ndarray:
    """Decode one image to a 2-D uint16 array (color: keep one BGR channel,
    fpmMain.cpp:109-115)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        if color:
            rgb_channel = {0: 2, 1: 1, 2: 0}[color_channel]  # BGR index → PIL RGB
            arr = arr[..., rgb_channel]
        else:
            arr = arr[..., 0]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.uint16)
    return arr.astype(np.uint16, copy=False)


def preprocess_image(
    full_img: np.ndarray, cfg: FPMConfig, is_darkfield: bool
) -> tuple[np.ndarray, int]:
    """ROI crop + darkfield scaling + background subtraction for one image
    (fpmMain.cpp:124-144): mean of two Np×Np background windows of the full
    frame, clamped at ``bgThreshold``, rounded, subtracted with uint16
    saturation; darkfield frames divided by ``darkfieldExpMultiplier``
    (round-half-to-even) first."""
    np_sz = cfg.np_size
    img = full_img[cfg.crop_y : cfg.crop_y + np_sz, cfg.crop_x : cfg.crop_x + np_sz]
    img = img.astype(np.float64)

    if cfg.darkfield_exp_multiplier != 1 and is_darkfield:
        img = np.rint(img / cfg.darkfield_exp_multiplier)

    bk1 = full_img[
        cfg.bk1_crop_y : cfg.bk1_crop_y + np_sz, cfg.bk1_crop_x : cfg.bk1_crop_x + np_sz
    ].mean()
    bk2 = full_img[
        cfg.bk2_crop_y : cfg.bk2_crop_y + np_sz, cfg.bk2_crop_x : cfg.bk2_crop_x + np_sz
    ].mean()
    bg_val = (bk1 + bk2) / 2.0
    if bg_val > cfg.bg_threshold:
        bg_val = cfg.bg_threshold
    bg = int(round(bg_val))

    img = np.clip(img - bg, 0, 65535).astype(np.uint16)  # saturating cv::subtract
    return img, bg


def _scan_and_prepare(cfg: FPMConfig):
    """Scan, validate LED numbers (1-based, unique, inside the coordinate
    table), build the geometry. Returns ``(geom, paths)``."""
    found = scan_directory(cfg)
    if not found:
        raise FileNotFoundError(
            f"no '{cfg.file_prefix}*{cfg.file_extension}' images in {cfg.dataset_root!r}"
        )
    led_numbers = np.array([n for n, _ in found], dtype=np.int32)
    paths = {n: p for n, p in found}
    if len(paths) != len(led_numbers):
        seen, dups = set(), set()
        for n in led_numbers.tolist():
            (dups if n in seen else seen).add(n)
        raise ValueError(
            f"duplicate LED numbers on disk: {sorted(dups)[:5]} — multiple "
            "files parse to the same LED (e.g. zero-padded and unpadded "
            "names side by side)"
        )
    if (led_numbers < 1).any():
        bad = led_numbers[led_numbers < 1]
        raise ValueError(
            f"LED numbers {bad[:5].tolist()} are not 1-based (the reference "
            "indexes holeCoordinates[led-1], fpmMain.cpp:77)"
        )
    coords = cfg.coordinates()
    in_range = led_numbers <= len(coords)
    if not in_range.all():
        skipped = led_numbers[~in_range]
        raise ValueError(
            f"LED numbers {skipped[:5].tolist()}... exceed coordinate table "
            f"({len(coords)} entries)"
        )
    geom = compute_geometry(cfg, coordinates=coords, led_numbers=led_numbers)
    return geom, paths


def load_dataset(cfg: FPMConfig, use_native: bool | None = None) -> LoadedDataset:
    """Scan, filter by NA, decode and preprocess the full LED stack.

    ``use_native=None`` or ``False`` takes the Python (PIL) decode path.
    """
    if use_native:
        raise ValueError("the native TIFF decoder is not yet ported to fpm_torch")
    geom, paths = _scan_and_prepare(cfg)
    images = np.empty((geom.num_leds, cfg.np_size, cfg.np_size), dtype=np.uint16)
    bgs = np.empty(geom.num_leds, dtype=np.int16)
    for i, led in enumerate(geom.led_numbers):
        full = _decode_image(paths[led], cfg.color, cfg.color_channel)
        images[i], bgs[i] = preprocess_image(full, cfg, geom.is_darkfield[i])
    return LoadedDataset(cfg=cfg, geom=geom, images=images, bg_values=bgs)
