"""Large-FOV reconstruction: real-space ROI tiling with overlap stitching.

The port of ``fpm_tpu.models.largefov``: the NumPy parts (tiling, angle
bound, stitch) are copies, and the tiles solve through the port's
:func:`~fpm_torch.models.epry.reconstruct`.

The reference reconstructs a single Np×Np ROI of the camera frame
(``cropX/cropY``, fpmMain.cpp:124-125) — large fields of view are out of its
reach (one monolithic spectrum in RAM, SURVEY.md §5 "long-context" row).
Here the full frame is tiled into overlapping Np×Np ROIs, each reconstructed
independently (the FPM forward model is local, so ROIs share the same LED
geometry table — see :func:`roi_angle_error` for the quantified validity
bound of that approximation), and the recovered high-res complex fields are
stitched:

* per-tile global complex scale/phase is ambiguous, so each tile is
  least-squares phase-aligned to the already-stitched canvas over the
  overlap region before blending;
* blending uses a separable feathering ramp over the overlap.

ROIs are embarrassingly parallel — this module solves them one after another
on one device (the route on the CPU, and the yardstick on the card);
``parallel/roi_shard.py`` solves the same tiles in rounds, the tiles of a
round that share a card as ONE problem-axis launch per sweep (the
production scale-out mode, SCALING.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..config import FPMConfig
from ..geometry import LEDGeometry
from .epry import ReconResult, reconstruct


@dataclasses.dataclass
class LargeFOVResult:
    stitched: np.ndarray          # (H_hr, W_hr) complex high-res field; None on
    #                               a process other than the coordinator of a
    #                               distributed ROI run (parallel/roi_shard.py)
    tiles: list[ReconResult]
    tile_origins: list[tuple[int, int]]  # high-res (row, col) of each tile (None
    #                                      where ``stitched`` is)


def _feather_weight(n: int, overlap: int) -> np.ndarray:
    """Separable 2-D blending weight: linear ramps across the overlap."""
    w = np.ones(n)
    ramp = np.linspace(1.0 / (overlap + 1), 1.0, overlap, endpoint=False)
    if overlap > 0:
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return np.outer(w, w)


def roi_origins(
    cfg: FPMConfig, grid: tuple[int, int], overlap: int, frame_shape
) -> tuple[list[tuple[int, int]], int]:
    """Camera-pixel (y0, x0) of each ROI in row-major grid order + stride.

    Validates that the grid fits inside the frames. Shared by the
    sequential solver below and the ROI-sharded runner
    (parallel/roi_shard.py) so both tile identically.
    """
    np_sz = cfg.np_size
    rows, cols = grid
    if rows < 1 or cols < 1:
        raise ValueError(f"tile grid {grid} must be at least 1x1")
    stride = np_sz - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} must be < Np {np_sz}")
    need_h = cfg.crop_y + np_sz + stride * (rows - 1)
    need_w = cfg.crop_x + np_sz + stride * (cols - 1)
    if need_h > frame_shape[0] or need_w > frame_shape[1]:
        raise ValueError(
            f"tile grid {grid} with Np={np_sz}, overlap={overlap} needs "
            f"{need_h}×{need_w} frames, got {tuple(frame_shape)} "
        )
    return [
        (cfg.crop_y + r * stride, cfg.crop_x + c * stride)
        for r in range(rows)
        for c in range(cols)
    ], stride


def roi_angle_error(cfg: FPMConfig, geom: LEDGeometry, grid: tuple[int, int],
                    overlap: int | None = None) -> dict:
    """Quantify the shared-geometry approximation across the ROI grid.

    Every ROI reuses the LED table computed for the frame's reference crop,
    but a ROI offset by Δ camera pixels sees each LED from a laterally
    shifted position: its true illumination angle satisfies
    ``sinθ' = sin(atan(tan θ ∓ Δ·ps_eff/z))``. The observable consequence is
    a shift of the Fourier sub-aperture index ``idx = round(sinθ/λ/du)``
    (fpmMain.cpp:146-154). This returns the worst-case angular and index
    error over the grid's corner ROIs so callers can assert the bound
    ``max_idx_shift_px < 1`` (sub-pixel: the shared table is exact at the
    solver's own quantization) or compensate per tile.
    """
    if overlap is None:
        overlap = cfg.np_size // 4
    rows, cols = grid
    stride = cfg.np_size - overlap
    # max lateral offset of a ROI center from the reference crop center, in
    # meters on the sample plane (ps_eff is µm/camera-pixel at the sample)
    # 1x1 grids coincide exactly with the reference crop (zero offset)
    max_dx = max(rows, cols) - 1
    delta_m = max_dx * stride * cfg.ps_eff * 1e-6
    # LED z-distances in meters: the solver never needs absolute units
    # (sinθ = sin(atan2(x, z)) is scale-invariant) but this bound does;
    # coordinate tables are meters (dome, cellscope2) or mm (cellScope,
    # dogStomach) — infer from magnitude.
    coords = np.asarray(cfg.coordinates(), dtype=np.float64)[geom.led_numbers - 1]
    scale = 1.0 if np.abs(coords).max() < 1.0 else 1e-3
    z = np.maximum(np.abs(coords[:, 2]) * scale, 1e-9)
    # per-axis: sinθ = sin(atan2(u, z)) → tanθ = u/z; a lateral ROI offset Δ
    # perturbs it to tanθ' = tanθ + Δ/z (worst sign)
    sin_used = np.abs(np.asarray(geom.sin_theta))  # (K, 2)
    tan_t = sin_used / np.sqrt(np.maximum(1e-12, 1.0 - sin_used**2))
    sin_true = np.sin(np.arctan(tan_t + (delta_m / z)[:, None]))
    d_sin = float(np.max(np.abs(sin_true - sin_used)))
    # one sub-aperture index unit: idx = round(sinθ/λ/du) (fpmMain.cpp:146-154)
    idx_shift = d_sin / (cfg.wavelength * cfg.du)
    return {
        "max_lateral_offset_m": delta_m,
        "max_sin_theta_error": float(d_sin),
        "max_idx_shift_px": float(idx_shift),
        "subpixel": bool(idx_shift < 1.0),
    }


def stitch_fields(
    fields: list[np.ndarray],
    grid: tuple[int, int],
    hr_size: int,
    hr_stride: int,
    overlap_hr: int,
) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Feather-blend per-ROI high-res complex fields into one canvas.

    ``fields`` in row-major grid order. Each tile is least-squares
    complex-scale aligned to the already-stitched canvas over the overlap
    before blending (per-tile global phase is ambiguous in FPM).
    """
    rows, cols = grid
    canvas = np.zeros(
        (hr_size + hr_stride * (rows - 1), hr_size + hr_stride * (cols - 1)),
        dtype=np.complex128,
    )
    weight = np.zeros(canvas.shape, dtype=np.float64)
    feather = _feather_weight(hr_size, overlap_hr)

    origins = []
    for i, tile in enumerate(fields):
        r, c = divmod(i, cols)
        hy, hx = r * hr_stride, c * hr_stride
        origins.append((hy, hx))
        tile = np.asarray(tile, dtype=np.complex128)
        region = np.s_[hy : hy + hr_size, hx : hx + hr_size]
        seen = weight[region] > 0
        if seen.any():
            existing = canvas[region][seen] / weight[region][seen]
            t_vals = tile[seen]
            denom = np.vdot(t_vals, t_vals).real
            s = np.vdot(t_vals, existing) / denom if denom > 0 else 1.0
        else:
            s = 1.0
        canvas[region] += feather * (s * tile)
        weight[region] += feather
    return canvas / np.maximum(weight, 1e-12), origins


def tile_from_store(tile_store, i: int):
    """Rebuild a ReconResult from a persisted tile, or None if absent."""
    if tile_store is None:
        return None
    cached = tile_store.get(i)
    if cached is None:
        return None
    crop_p, objf_p, pupil_p, mets = cached
    return ReconResult(
        obj_crop=crop_p[0] + 1j * crop_p[1],
        obj_f_centered=objf_p[0] + 1j * objf_p[1],
        pupil=pupil_p[0] + 1j * pupil_p[1],
        metrics={"data_residual": mets[:, 0], "update_norm": mets[:, 1]},
    )


def tile_to_store(tile_store, i: int, res: ReconResult):
    """Persist a completed tile as (2, ...) real/imag planes."""
    if tile_store is None:
        return
    tile_store.put(
        i,
        np.stack([res.obj_crop.real, res.obj_crop.imag]),
        np.stack([res.obj_f_centered.real, res.obj_f_centered.imag]),
        np.stack([res.pupil.real, res.pupil.imag]),
        np.stack([np.asarray(res.metrics["data_residual"]),
                  np.asarray(res.metrics["update_norm"])], axis=1),
    )


def reconstruct_large_fov(
    full_images: np.ndarray,
    geom: LEDGeometry,
    cfg: FPMConfig,
    grid: tuple[int, int],
    overlap: int | None = None,
    iterations: int | None = None,
    dtype=None,
    progress=None,
    tile_store=None,
    device: Any = "cuda",
    **opt_overrides,
) -> LargeFOVResult:
    """Tile the FOV into an R×C grid of overlapping ROIs and stitch.

    Args:
      full_images: (K, H, W) preprocessed full frames ordered like
        ``geom.led_numbers`` (bg-subtracted; see ``load_dataset(...,
        full_frames=True)``).
      grid: (rows, cols) of ROI tiles starting at (cfg.crop_y, cfg.crop_x).
      overlap: camera-pixel overlap between neighboring ROIs
        (default Np // 4).
      tile_store: optional :class:`fpm_torch.utils.checkpoint.TileStore` —
        each completed tile is persisted as it finishes, and previously
        completed tiles (matching fingerprint) are loaded instead of
        re-solved. Tiles are independent, so a resumed run's stitch is
        bitwise-identical to an uninterrupted one.
      device, **opt_overrides: as :func:`~fpm_torch.models.epry.reconstruct`.
    """
    np_sz = cfg.np_size
    rif = cfg.res_improvement_factor
    rows, cols = grid
    if overlap is None:
        overlap = np_sz // 4
    origins_px, stride = roi_origins(cfg, grid, overlap, full_images.shape[1:])

    tiles = []
    for i, (y0, x0) in enumerate(origins_px):
        res = tile_from_store(tile_store, i)
        if res is None:
            roi = full_images[:, y0 : y0 + np_sz, x0 : x0 + np_sz]
            res = reconstruct(
                roi, geom, cfg, iterations=iterations, dtype=dtype, device=device,
                **opt_overrides
            )
            tile_to_store(tile_store, i, res)
            # progress fires for SOLVED tiles only — resumed runs must not
            # re-report (or re-beat a watchdog for) cached tiles, and the
            # metrics log then witnesses which tiles were actually re-solved.
            if progress is not None:
                progress(i // cols, i % cols, res)
        tiles.append(res)

    stitched, origins = stitch_fields(
        [t.obj_crop for t in tiles], grid,
        hr_size=np_sz * rif, hr_stride=stride * rif, overlap_hr=overlap * rif,
    )
    return LargeFOVResult(stitched=stitched, tiles=tiles, tile_origins=origins)
