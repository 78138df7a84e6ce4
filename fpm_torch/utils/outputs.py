"""Result serialization and complex-field visualization.

The reference's only output is interactive OpenCV windows via cvComplex's
``showComplexImg(mat, mode, title)`` with modes ``SHOW_COMPLEX_MAG |
SHOW_COMPLEX_COMPONENTS | SHOW_COMPLEX_REAL | SHOW_AMP_PHASE``
(fpmMain.cpp:495-497; SURVEY.md §1 L0, quirk 12 "writes no output files").
Here every mode becomes a PNG writer, and raw arrays are written as ``.npy``
so results are testable and consumable.
"""

from __future__ import annotations

import json
import os

import numpy as np

# cvComplex display-mode equivalents (fpmMain.cpp:368-374 usage)
SHOW_COMPLEX_MAG = "mag"
SHOW_COMPLEX_COMPONENTS = "components"
SHOW_COMPLEX_REAL = "real"
SHOW_AMP_PHASE = "amp_phase"


def _to_uint8(x: np.ndarray) -> np.ndarray:
    if not np.isfinite(x).all():
        # A diverged solve must yield a defined (and visibly flagged)
        # image, not platform-dependent uint8 garbage from NaN casts.
        print("[fpm-torch] WARNING: non-finite values in image output; "
              "rendering finite part")
        x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    lo, hi = float(np.min(x)), float(np.max(x))
    if hi - lo < 1e-30:
        return np.zeros(x.shape, dtype=np.uint8)
    return np.clip((x - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(_to_uint8(img)).save(path)


def save_complex_img(field: np.ndarray, mode: str, path_base: str) -> list[str]:
    """Write a complex field as PNG(s) in one of the cvComplex display modes."""
    written = []
    if mode == SHOW_COMPLEX_MAG:
        save_png(p := path_base + "_mag.png", np.abs(field)); written.append(p)
    elif mode == SHOW_COMPLEX_REAL:
        save_png(p := path_base + "_real.png", field.real); written.append(p)
    elif mode == SHOW_COMPLEX_COMPONENTS:
        save_png(p := path_base + "_real.png", field.real); written.append(p)
        save_png(p := path_base + "_imag.png", field.imag); written.append(p)
    elif mode == SHOW_AMP_PHASE:
        save_png(p := path_base + "_amp.png", np.abs(field)); written.append(p)
        save_png(p := path_base + "_phase.png", np.angle(field)); written.append(p)
    else:
        raise ValueError(f"unknown display mode {mode!r}")
    return written


def save_results(result, out_dir: str, cfg=None) -> dict:
    """Write the full reconstruction result set (SURVEY.md N5).

    Arrays: object (complex .npy), spectrum, pupil; PNGs: the reference's
    final displays — object amp/phase and (centered) pupil amp/phase
    (fpmMain.cpp:495-497).
    """
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "object.npy"), result.obj_crop)
    np.save(os.path.join(out_dir, "object_spectrum.npy"), result.obj_f_centered)
    np.save(os.path.join(out_dir, "pupil.npy"), result.pupil)
    save_complex_img(result.obj_crop, SHOW_AMP_PHASE, os.path.join(out_dir, "object"))
    # The reference fftShifts the pupil before display (fpmMain.cpp:496).
    save_complex_img(
        np.fft.fftshift(result.pupil), SHOW_AMP_PHASE, os.path.join(out_dir, "pupil")
    )
    manifest = {
        "arrays": ["object.npy", "object_spectrum.npy", "pupil.npy"],
        "metrics": {k: np.asarray(v).tolist() for k, v in result.metrics.items()},
    }
    if cfg is not None:
        manifest["derived"] = {
            "ps_eff": cfg.ps_eff,
            "du": cfg.du,
            "res_improvement_factor": cfg.res_improvement_factor,
            "n_large": cfg.n_large,
            "recovered_pixel_size": cfg.recovered_pixel_size,
        }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest
