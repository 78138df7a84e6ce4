"""Vectorized LED illumination geometry.

Re-derives, for every LED at once (NumPy, no per-LED loop), everything the
reference computes per image inside its ingestion loop (fpmMain.cpp:59-61,
77-168): array rotation, illumination flips, ``sinθ_x/y = sin(atan2(·, z))``,
illumination NA, the max-NA filter, spatial-frequency indices
``idx_u = round(sinθ/λ/du)``, and the Fourier-domain crop rectangles, plus the
ascending-NA processing schedule (fpmMain.h:103-115, fpmMain.cpp:246-258).

All geometry is data-independent of the images, so the whole table is
precomputed host-side once. A NumPy-only copy of ``fpm_tpu.geometry``; the
two must agree bitwise (tests/test_torch_host.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .config import FPMConfig


@dataclasses.dataclass
class LEDGeometry:
    """Per-LED geometry table for the ``K`` LEDs that pass the NA filter.

    Arrays are ordered by LED number (ascending); use :attr:`schedule` for the
    ascending-NA processing order. ``led_numbers`` are the 1-based LED ids used
    in filenames (the reference's ``led_num``, fpmMain.cpp:75).
    """

    led_numbers: np.ndarray      # (K,) int32, 1-based
    sin_theta: np.ndarray        # (K, 2) float64: (sinθ_x, sinθ_y)
    illumination_na: np.ndarray  # (K,) float64
    idx_uv: np.ndarray           # (K, 2) int32: (idx_u, idx_v)
    crop_start: np.ndarray       # (K, 2) int32: (cropYStart, cropXStart) row/col
    schedule: np.ndarray         # (K,) int32: positions into the above arrays,
    #                              ascending illumination NA (stable)
    is_darkfield: np.ndarray     # (K,) bool: illumination NA > objective NA

    @property
    def num_leds(self) -> int:
        return len(self.led_numbers)

    def sorted_led_numbers(self) -> np.ndarray:
        """LED numbers in processing order (reference ``sortedIndicies``)."""
        return self.led_numbers[self.schedule]


def rotation_matrix_z(angle_deg: float) -> np.ndarray:
    """The reference's Z rotation matrix (fpmMain.cpp:61).

    Note the reference multiplies a *row* vector on the left
    (``holeCoordinatesIn * rotationMatrixZ``, fpmMain.cpp:85), so the effective
    transform is ``coords @ R`` with this exact matrix — reproduced verbatim
    (it rotates by ``-angle`` in the usual column-vector convention).
    """
    a = math.radians(angle_deg)
    return np.array(
        [
            [math.cos(a), -math.sin(a), 0.0],
            [math.sin(a), math.cos(a), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )


def compute_geometry(
    cfg: FPMConfig,
    coordinates: np.ndarray | None = None,
    led_numbers: np.ndarray | None = None,
    strict_reference_flips: bool = True,
) -> LEDGeometry:
    """Compute the full geometry table from LED coordinates.

    Args:
      cfg: experiment configuration.
      coordinates: (N, 3) LED x/y/z positions; defaults to ``cfg.coordinates()``.
      led_numbers: 1-based LED ids present on disk; defaults to all N LEDs.
      strict_reference_flips: reproduce the reference's flip quirk where
        ``flipDatasetY`` *overwrites* (rather than composes with)
        ``flipDatasetX`` (fpmMain.cpp:88-93). With False, both flips compose
        (the evident intent). All bundled configs have both flips off, so this
        only matters for new datasets.
    """
    coords_all = np.asarray(
        coordinates if coordinates is not None else cfg.coordinates(), dtype=np.float64
    )
    if led_numbers is None:
        led_numbers = np.arange(1, len(coords_all) + 1, dtype=np.int32)
    led_numbers = np.asarray(led_numbers, dtype=np.int32)
    coords = coords_all[led_numbers - 1]

    # Rotation (fpmMain.cpp:85) then illumination flips (fpmMain.cpp:88-93).
    coords = coords @ rotation_matrix_z(cfg.array_rotation)
    flip = np.ones(3)
    if strict_reference_flips:
        if cfg.flip_illumination_x:
            flip = np.array([-1.0, 1.0, 1.0])
        if cfg.flip_illumination_y:
            flip = np.array([1.0, -1.0, 1.0])  # overwrites X flip — quirk
    else:
        if cfg.flip_illumination_x:
            flip = flip * np.array([-1.0, 1.0, 1.0])
        if cfg.flip_illumination_y:
            flip = flip * np.array([1.0, -1.0, 1.0])
    coords = coords * flip

    # sinθ = sin(atan2(x|y, z)) (fpmMain.cpp:95-99). Note sin(atan2(v, z)) is
    # invariant to the sign of z, so the dome datasets' negative z is harmless.
    sin_theta = np.sin(np.arctan2(coords[:, :2], coords[:, 2:3]))
    illum_na = np.sqrt(np.sum(sin_theta**2, axis=1))

    # NA filter. The reference writes sqrt(na < maxNA) — sqrt of a bool — which
    # acts as the plain comparison (fpmMain.cpp:106, SURVEY.md quirk 1). The
    # comparison happens on float32-stored values in C++.
    keep = illum_na.astype(np.float32) < np.float32(cfg.max_illumination_na)

    led_numbers = led_numbers[keep]
    sin_theta = sin_theta[keep]
    illum_na = illum_na[keep]

    # Spatial-frequency shift indices (fpmMain.cpp:146-154). uled/vled are
    # stored as float in the reference; round() is round-half-away-from-zero
    # in C (std::round), reproduced here.
    uv = sin_theta / cfg.wavelength
    idx_uv = _c_round(uv / cfg.du).astype(np.int32)

    # Fourier crop rectangles (fpmMain.cpp:156-168). Nlarge/Np are even in all
    # bundled configs; integer halves follow the C integer-division semantics.
    half_large = cfg.n_large // 2
    half_np = cfg.np_size // 2
    crop_x_start = half_large + idx_uv[:, 0] - half_np  # column (u ↔ x ↔ Rect.x)
    crop_y_start = half_large + idx_uv[:, 1] - half_np  # row    (v ↔ y ↔ Rect.y)
    crop_start = np.stack([crop_y_start, crop_x_start], axis=1).astype(np.int32)

    lo = crop_start.min(initial=0)
    hi = (crop_start + cfg.np_size).max(initial=0)
    if lo < 0 or hi > cfg.n_large:
        raise ValueError(
            "LED sub-aperture crop exceeds the high-res spectrum "
            f"(rows/cols span [{lo}, {hi}) vs Nlarge={cfg.n_large}); "
            "maxIlluminationNA and resImprovementFactor are inconsistent"
        )

    # Ascending-NA schedule (fpmMain.cpp:246-258). The reference uses
    # std::sort on float32 NA values (unstable on ties); we use a stable
    # argsort on the float32 values for a deterministic order.
    schedule = np.argsort(illum_na.astype(np.float32), kind="stable").astype(np.int32)

    return LEDGeometry(
        led_numbers=led_numbers,
        sin_theta=sin_theta,
        illumination_na=illum_na,
        idx_uv=idx_uv,
        crop_start=crop_start,
        schedule=schedule,
        is_darkfield=illum_na.astype(np.float32) > np.float32(cfg.objective_na),
    )


def _c_round(x: np.ndarray) -> np.ndarray:
    """C ``round()``: half-away-from-zero (np.round is half-to-even)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def pupil_radius(cfg: FPMConfig) -> int:
    """NA-limited pupil support radius in Fourier pixels (fpmMain.cpp:305-306)."""
    return int(math.ceil(cfg.objective_na * cfg.ps_eff * cfg.np_size / cfg.wavelength))


def pupil_support(cfg: FPMConfig, centered: bool = False) -> np.ndarray:
    """Binary circular pupil support, Np×Np.

    The reference rasterizes a filled ``cv::circle`` of radius
    ``pupil_radius`` centered at ``(Np/2, Np/2)`` then fftshifts it
    (fpmMain.cpp:304-310). We use the analytic disk ``dist² <= r²``
    (OpenCV's integer rasterizer may differ on a few boundary pixels; the
    analytic disk is the physically-correct NA cutoff).

    Returns the DC-at-corner (fftshifted) mask unless ``centered``.
    """
    n = cfg.np_size
    r = pupil_radius(cfg)
    c = round(n / 2)
    yy, xx = np.mgrid[0:n, 0:n]
    disk = ((xx - c) ** 2 + (yy - c) ** 2 <= r * r).astype(np.float64)
    if centered:
        return disk
    return np.fft.fftshift(disk)
