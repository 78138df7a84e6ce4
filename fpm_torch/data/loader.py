"""Image-stack ingestion: ``loadFPMDataset`` on the host.

The same ingestion contract as ``fpm_tpu.data.loader`` (fpmMain.cpp:36-271):
directory scan with ``{prefix}{led#}{ext}`` filename parsing, per-LED PIL
decode, ROI crop, darkfield exposure division, two-point background
estimation clamped at ``bgThreshold`` and saturating subtraction; whole
camera frames for the large-FOV tiling mode (``full_frames=True``) and the
decode-once RGB ingest (:func:`load_dataset_rgb`). Each file is decoded by
the native C++ decoder (``fpm_torch.native``) where it is available and the
files are TIFF, else by PIL; a file the native decoder rejects is decoded by
PIL on its own. Both paths give the same arrays, bit for bit.
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
    images: np.ndarray     # (K, Np, Np) uint16 (full frames: (K, H, W)), bg-subtracted,
    #                        ordered by geom.led_numbers
    bg_values: np.ndarray  # (K,) int16 per-LED background estimate
    decoder: str = "python"  # "native" where the C++ decoder ran
    fallback_files: int = 0  # files the native decoder rejected, decoded by PIL


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


def _decode_image_rgb(path: str) -> np.ndarray:
    """Decode one image ONCE to (3, H, W) uint16 RGB planes; a grayscale
    image replicates to all three (what three per-channel
    :func:`_decode_image` calls would each return)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = np.broadcast_to(arr, (3,) + arr.shape)
    else:
        arr = np.moveaxis(arr[..., :3], -1, 0)
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


def preprocess_full_frame(
    full_img: np.ndarray, cfg: FPMConfig, is_darkfield: bool
) -> tuple[np.ndarray, int]:
    """Darkfield scaling + background subtraction WITHOUT the ROI crop, for
    the large-FOV tiling mode (models/largefov.py), which crops many
    overlapping ROIs later. Same background estimate and saturation as
    :func:`preprocess_image`."""
    np_sz = cfg.np_size
    img = full_img.astype(np.float64)
    if cfg.darkfield_exp_multiplier != 1 and is_darkfield:
        img = np.rint(img / cfg.darkfield_exp_multiplier)
    bk1 = full_img[
        cfg.bk1_crop_y : cfg.bk1_crop_y + np_sz, cfg.bk1_crop_x : cfg.bk1_crop_x + np_sz
    ].mean()
    bk2 = full_img[
        cfg.bk2_crop_y : cfg.bk2_crop_y + np_sz, cfg.bk2_crop_x : cfg.bk2_crop_x + np_sz
    ].mean()
    bg_val = min((bk1 + bk2) / 2.0, cfg.bg_threshold)
    bg = int(round(bg_val))
    return np.clip(img - bg, 0, 65535).astype(np.uint16), bg


def _scan_and_prepare(cfg: FPMConfig, use_native: bool | None):
    """Scan, validate LED numbers (1-based, unique, inside the coordinate
    table), build the geometry and settle the decoder: ``use_native=None``
    takes the native one when it is available and the files are TIFF.
    Returns ``(geom, paths, use_native)``."""
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
    return geom, paths, _uses_native(cfg, use_native)


def _uses_native(cfg: FPMConfig, use_native: bool | None = None) -> bool:
    """Whether a load with ``use_native`` decodes through the native decoder:
    as asked, or (``None``) where the files are TIFF and the decoder is
    available (built here on first call). Files it rejects still go
    through PIL one by one."""
    if use_native is not None:
        return bool(use_native)
    from .. import native

    return cfg.file_extension.lower() in (".tif", ".tiff") and native.available()


def _loaded(cfg, geom, images, bgs, use_native: bool, fallback) -> LoadedDataset:
    return LoadedDataset(cfg=cfg, geom=geom, images=images, bg_values=bgs,
                         decoder="native" if use_native else "python",
                         fallback_files=len(fallback) if use_native else 0)


def load_dataset(cfg: FPMConfig, use_native: bool | None = None, num_threads: int = 0,
                 full_frames: bool = False) -> LoadedDataset:
    """Scan, filter by NA, decode and preprocess the full LED stack.

    ``use_native``: the C++ decoder (``True``), PIL (``False``), or the
    C++ decoder where it is available and the files are TIFF (``None``);
    ``num_threads`` are its threads (0: one per core). ``full_frames=True``
    keeps whole camera frames (no ROI crop) for the large-FOV tiling mode;
    their shape comes from the first file.
    """
    from .. import native

    geom, paths, use_native = _scan_and_prepare(cfg, use_native)
    ordered = [paths[int(led)] for led in geom.led_numbers]
    if full_frames:
        # The frame shape from one decode of the first file, which the
        # Python path reuses; the native path flags a file of another shape.
        first = _decode_image(ordered[0], cfg.color, cfg.color_channel)
        if use_native:
            images, bgs, status = native.load_frames(ordered, cfg, geom.is_darkfield,
                                                     first.shape, num_threads)
            fallback = np.nonzero(status)[0]
        else:
            images = np.empty((geom.num_leds,) + first.shape, dtype=np.uint16)
            bgs = np.empty(geom.num_leds, dtype=np.int16)
            fallback = range(geom.num_leds)
        for i in fallback:
            full = first if i == 0 else _decode_image(ordered[i], cfg.color,
                                                      cfg.color_channel)
            images[i], bgs[i] = preprocess_full_frame(full, cfg, geom.is_darkfield[i])
        return _loaded(cfg, geom, images, bgs, use_native, fallback)
    if use_native:
        images, bgs, status = native.load_and_preprocess(ordered, cfg, geom.is_darkfield,
                                                         num_threads)
        fallback = np.nonzero(status)[0]
    else:
        images = np.empty((geom.num_leds, cfg.np_size, cfg.np_size), dtype=np.uint16)
        bgs = np.empty(geom.num_leds, dtype=np.int16)
        fallback = range(geom.num_leds)
    for i in fallback:
        full = _decode_image(ordered[i], cfg.color, cfg.color_channel)
        images[i], bgs[i] = preprocess_image(full, cfg, geom.is_darkfield[i])
    return _loaded(cfg, geom, images, bgs, use_native, fallback)


def load_dataset_rgb(cfg: FPMConfig, use_native: bool | None = None,
                     num_threads: int = 0) -> list[LoadedDataset]:
    """Decode-once RGB ingestion: returns [R, G, B] channel datasets.

    Each is bitwise ``load_dataset(replace(cfg, color=True,
    color_channel=bgr))`` for the matching BGR channel index (R↔2, G↔1,
    B↔0), per-channel background estimate included, but every file is read
    and decoded ONCE instead of three times: the ingest of ``--color-mode
    rgb`` (the reference decodes each color TIFF and throws two channels
    away, fpmMain.cpp:109-115). ``use_native`` and ``num_threads`` as in
    :func:`load_dataset`.
    """
    from .. import native

    geom, paths, use_native = _scan_and_prepare(cfg, use_native)
    ordered = [paths[int(led)] for led in geom.led_numbers]
    k = geom.num_leds
    if use_native:
        images, bgs, status = native.load_and_preprocess_rgb(ordered, cfg, geom.is_darkfield,
                                                             num_threads)
        fallback = np.nonzero(status)[0]
    else:
        images = np.empty((k, 3, cfg.np_size, cfg.np_size), dtype=np.uint16)
        bgs = np.empty((k, 3), dtype=np.int16)
        fallback = range(k)
    for i in fallback:
        planes = _decode_image_rgb(ordered[i])
        for c in range(3):
            images[i, c], bgs[i, c] = preprocess_image(planes[c], cfg, geom.is_darkfield[i])
    out = []
    for rgb_idx, bgr_idx in ((0, 2), (1, 1), (2, 0)):
        ch_cfg = dataclasses.replace(cfg, color=True, color_channel=bgr_idx)
        out.append(_loaded(ch_cfg, geom, np.ascontiguousarray(images[:, rgb_idx]),
                           np.ascontiguousarray(bgs[:, rgb_idx]), use_native, fallback))
    return out
