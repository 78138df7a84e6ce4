"""Forward FPM simulator: generate LED image stacks from a known object.

The exact inverse of the solver contract (SURVEY.md §2.2): for each LED, crop
the shifted sub-aperture of the high-res object spectrum, apply the pupil,
inverse-FFT to the image plane, and record the intensity. The reference ships
no sample data (its dataset JSONs point at the author's local folders,
e.g. dataset_mono.json:2), so this simulator is both the hermetic test
fixture and the accuracy oracle (reconstruction RMSE vs known ground truth).
A NumPy copy of ``fpm_tpu.data.simulate``; the two give bitwise-equal
datasets (tests/test_torch_host.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import FPMConfig
from ..geometry import LEDGeometry, compute_geometry, pupil_support


@dataclasses.dataclass
class SyntheticDataset:
    cfg: FPMConfig
    geom: LEDGeometry
    images: np.ndarray        # (K, Np, Np) float64 intensities (≥0)
    object_true: np.ndarray   # (Nlarge, Nlarge) complex high-res ground truth
    pupil_true: np.ndarray    # (Np, Np) complex, DC-at-corner frame


def make_test_object(
    n: int, seed: int = 0, amp_range=(0.6, 1.4), phase_range=(-1.0, 1.0)
) -> np.ndarray:
    """A smooth random complex object (band-limited amplitude and phase)."""
    rng = np.random.default_rng(seed)

    def smooth(field):
        spec = np.fft.fft2(field)
        k = np.fft.fftfreq(n)
        mask = (np.abs(k)[:, None] < 0.12) & (np.abs(k)[None, :] < 0.12)
        out = np.fft.ifft2(spec * mask).real
        lo, hi = out.min(), out.max()
        return (out - lo) / (hi - lo + 1e-12)

    amp = amp_range[0] + (amp_range[1] - amp_range[0]) * smooth(rng.standard_normal((n, n)))
    phase = phase_range[0] + (phase_range[1] - phase_range[0]) * smooth(
        rng.standard_normal((n, n))
    )
    return amp * np.exp(1j * phase)


def simulate_images(
    obj_true: np.ndarray,
    geom: LEDGeometry,
    cfg: FPMConfig,
    pupil_true: np.ndarray | None = None,
    photon_scale: float | None = None,
    quantize: bool = True,
    seed: int | None = None,
    apply_darkfield_exposure: bool = False,
) -> np.ndarray:
    """Simulate the (K, Np, Np) LED intensity stack.

    ``photon_scale`` scales intensities so the brightest pixel across the
    stack lands near 30000 (well inside uint16, like the reference's 16-bit
    TIFFs); pass ``quantize=False`` for exact float data (noise-free inverse
    crime, used by convergence tests). ``seed`` adds Poisson shot noise.
    ``apply_darkfield_exposure`` models the longer exposure real rigs use
    for the dim darkfield frames: darkfield-LED intensities are multiplied
    by ``cfg.darkfield_exp_multiplier`` (the loader divides it back out at
    ingest, fpmMain.cpp:128-129).
    """
    np_sz = cfg.np_size
    if pupil_true is None:
        pupil_true = pupil_support(cfg, centered=False).astype(np.complex128)

    spec_centered = np.fft.fftshift(np.fft.fft2(obj_true))
    fields = np.empty((geom.num_leds, np_sz, np_sz), dtype=np.complex128)
    for i in range(geom.num_leds):
        ys, xs = geom.crop_start[i]
        patch = np.fft.ifftshift(spec_centered[ys : ys + np_sz, xs : xs + np_sz])
        fields[i] = np.fft.ifft2(patch * pupil_true)
    intensity = np.abs(fields) ** 2

    if apply_darkfield_exposure and cfg.darkfield_exp_multiplier != 1:
        intensity[geom.is_darkfield] *= cfg.darkfield_exp_multiplier

    if photon_scale is None:
        photon_scale = 30000.0 / max(intensity.max(), 1e-30)
    intensity = intensity * photon_scale

    if seed is not None:
        rng = np.random.default_rng(seed)
        intensity = rng.poisson(intensity).astype(np.float64)
    if quantize:
        intensity = np.clip(np.rint(intensity), 0, 65535).astype(np.uint16)
    return intensity


def synthetic_dataset(
    np_size: int = 16,
    grid: int = 5,
    seed: int = 0,
    quantize: bool = False,
    aberrated_pupil: bool = False,
    raw_frames: bool = False,
    jitter: float = 0.0,
    **cfg_overrides,
) -> SyntheticDataset:
    """A fully hermetic small FPM problem (planar LED grid, rif=3).

    Optics are chosen so ``res_improvement_factor == 3`` and every LED
    sub-aperture stays inside the large spectrum; the grid corners exceed
    ``maxIlluminationNA`` so the NA filter is exercised. Mirrors the
    dogStomach planar-grid geometry style (dataset_dogStomach.json:28-320).

    ``raw_frames=True`` returns as-captured frames (darkfield exposure boost
    applied per ``darkfield_exp_multiplier``) for writing to disk and
    re-ingesting through the loader; the default returns loader-equivalent
    (already-normalized) intensities for feeding the solver directly.
    """
    params = dict(
        dataset_root=".",
        pixel_size=1.0,
        objective_mag=1.0,
        objective_na=0.15,
        max_illumination_na=0.33,
        wavelength=0.5,
        np_size=np_size,
        delta1=5.0,
        delta2=10.0,
        led_count=grid * grid,
        iterations=10,
    )
    params.update(cfg_overrides)

    # Planar LED grid at height h; tan(theta) spans ±0.3 → corners filtered.
    h = 60.0
    lin = np.linspace(-0.3 * h, 0.3 * h, grid)
    gx, gy = np.meshgrid(lin, lin, indexing="xy")
    if jitter:
        # Symmetric grids produce exactly-tied illumination NAs, which the
        # reference orders with an UNSTABLE std::sort (fpmMain.h:111) — its
        # tie order is an implementation detail of the host's STL. A small
        # deterministic position jitter makes every NA distinct so the
        # schedule is unique, which the reference-binary parity harness
        # (tests/test_reference_binary.py) requires to compare trajectories.
        spacing = 0.6 * h / max(grid - 1, 1)
        jr = np.random.default_rng(seed + 0x5EED)
        gx = gx + jr.uniform(-jitter, jitter, gx.shape) * spacing
        gy = gy + jr.uniform(-jitter, jitter, gy.shape) * spacing
    coords = np.stack([gx.ravel(), gy.ravel(), np.full(grid * grid, h)], axis=1)
    # Round through float32: the reference parses hole coordinates with
    # JsonCpp's asFloat() (fpmMain.cpp:77-79), so only float32-representable
    # positions survive its ingestion. Building the simulation geometry from
    # already-rounded values keeps this pipeline, the written dataset.json,
    # and the reference binary in exact agreement on the geometry inputs.
    coords = coords.astype(np.float32).astype(np.float64)
    cfg = FPMConfig(hole_coordinates=coords, **params)
    geom = compute_geometry(cfg)

    obj_true = make_test_object(cfg.n_large, seed=seed)
    pupil_true = pupil_support(cfg, centered=False).astype(np.complex128)
    if aberrated_pupil:
        # Defocus-like quadratic phase, ~1.2 rad peak at the NA cutoff.
        from ..geometry import pupil_radius

        n = np_size
        c = round(n / 2)
        r_p = max(pupil_radius(cfg), 1)
        yy, xx = np.mgrid[0:n, 0:n]
        r2 = ((xx - c) ** 2 + (yy - c) ** 2) / r_p**2
        pupil_true = pupil_true * np.fft.ifftshift(np.exp(1j * 1.2 * r2))

    images = simulate_images(
        obj_true, geom, cfg, pupil_true=pupil_true, quantize=quantize,
        apply_darkfield_exposure=raw_frames,
    )
    return SyntheticDataset(
        cfg=cfg, geom=geom, images=np.asarray(images, dtype=np.float64),
        object_true=obj_true, pupil_true=pupil_true,
    )
