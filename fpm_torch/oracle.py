"""Reference-faithful NumPy oracle for the EPRY/FPM solver.

A step-by-step float64 re-derivation of ``runFPM`` (fpmMain.cpp:274-498,
SURVEY.md §2.2): the golden-math baseline the port's solver is held to.
Written in the reference's own frame bookkeeping (object spectrum stored
DC-at-corner, shifted to centered for every crop/paste) so each line can be
checked against the C++.

A NumPy-only copy of ``fpm_tpu.oracle`` (importing that module would run
``fpm_tpu/__init__.py`` and pull in JAX): the same float64 code, so the two
give the same bits (tests/test_torch_oracle.py). Not a performance path —
:mod:`fpm_torch.models.epry` is the product; this module is the contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import FPMConfig
from .geometry import LEDGeometry, pupil_support


@dataclasses.dataclass
class OracleResult:
    obj_crop: np.ndarray      # high-res complex object, real space (fpmMain.h:91)
    obj_f: np.ndarray         # high-res spectrum, DC-at-corner frame (fpmMain.h:92)
    pupil: np.ndarray         # recovered pupil, DC-at-corner frame (fpmMain.h:94)
    pupil_support: np.ndarray


def run_fpm_oracle(
    images: np.ndarray,
    geom: LEDGeometry,
    cfg: FPMConfig,
    iterations: int | None = None,
) -> OracleResult:
    """Run the sequential EPRY reconstruction exactly as the reference does.

    Args:
      images: (K, Np, Np) background-subtracted intensity images, ordered by
        ``geom.led_numbers`` (uint16 in the reference, fpmMain.cpp:380; any
        real dtype accepted — values are sqrt'ed to amplitudes).
      geom: precomputed LED geometry (same ordering as ``images``).
      cfg: experiment configuration.
      iterations: overrides ``cfg.iterations``.
    """
    np_sz = cfg.np_size
    n_large = cfg.n_large
    iters = cfg.iterations if iterations is None else iterations
    delta1, delta2, eps = cfg.delta1, cfg.delta2, cfg.eps

    # --- Pupil init: fftshifted filled NA circle (fpmMain.cpp:301-313).
    support = pupil_support(cfg, centered=False)
    pupil = support.astype(np.complex128)

    # --- Object-spectrum init (fpmMain.cpp:315-343): amplitude of the
    # *second*-lowest-NA image (sortedIndicies.at(1) — SURVEY.md quirk 2),
    # FFT'd, masked by pupil support, pasted at the center of the large
    # zeros, then shifted to the corner frame.
    seed_pos = geom.schedule[1] if len(geom.schedule) > 1 else geom.schedule[0]
    amp0 = np.sqrt(images[seed_pos].astype(np.float64))
    ci = np.fft.fft2(amp0) * support
    ci = np.fft.fftshift(ci)
    obj_f_centered = np.zeros((n_large, n_large), dtype=np.complex128)
    half_l, half_n = n_large // 2, np_sz // 2
    obj_f_centered[half_l - half_n : half_l - half_n + np_sz,
                   half_l - half_n : half_l - half_n + np_sz] = ci
    obj_f = np.fft.ifftshift(obj_f_centered)  # reference fftShift; even sizes equal

    amps = np.sqrt(images.astype(np.float64))

    for _ in range(iters):
        for pos in geom.schedule:
            ys, xs = geom.crop_start[pos]

            # Crop sub-spectrum, to corner frame (fpmMain.cpp:358-362).
            obj_f_centered = np.fft.fftshift(obj_f)
            objf_crop = np.fft.fftshift(
                obj_f_centered[ys : ys + np_sz, xs : xs + np_sz]
            )

            # Apply pupil, to image plane (fpmMain.cpp:364-365).
            objf_crop_p = objf_crop * pupil
            obj_crop_p = np.fft.ifft2(objf_crop_p)

            # Amplitude replacement preserving phase (fpmMain.cpp:377-394).
            # cv::add(mat2ch, double) unrolls the scalar across BOTH channels
            # (convertAndUnrollScalar replicates a 1-element scalar to every
            # channel — verified empirically via native/refshim/cv_probe.cpp
            # on this rig's OpenCV 4.6), so eps lands on real AND imaginary.
            ratio = obj_crop_p / np.abs(obj_crop_p + eps * (1 + 1j))
            objf_up = np.fft.fft2(ratio * amps[pos])

            # Object update, quasi-Newton/PIE (fpmMain.cpp:404-447).
            diff = objf_up - objf_crop_p
            pupil_abs = np.abs(pupil)
            pupil_abs_max = pupil_abs.max()
            d_obj = (diff * pupil_abs * np.conj(pupil)) / (
                pupil_abs_max * (pupil_abs**2 + delta2)
            )
            obj_f_centered[ys : ys + np_sz, xs : xs + np_sz] += np.fft.fftshift(d_obj)
            obj_f = np.fft.ifftshift(obj_f_centered)

            # Pupil update, EPRY (fpmMain.cpp:457-475). The max|objF|
            # denominator is taken over the *already-updated* full spectrum —
            # the solver's one global cross-patch reduction.
            objf_crop_abs = np.abs(objf_crop)
            objf_abs_max = np.abs(obj_f).max()
            d_pupil = (diff * objf_crop_abs * np.conj(objf_crop)) / (
                objf_abs_max * (objf_crop_abs**2 + delta1)
            )
            pupil = pupil + d_pupil * support

    obj_crop = np.fft.ifft2(obj_f)  # DFT_INVERSE|DFT_SCALE (fpmMain.cpp:481)
    return OracleResult(obj_crop=obj_crop, obj_f=obj_f, pupil=pupil, pupil_support=support)
