"""2D FFT layer on ``torch.fft``.

The conventions of ``fpm_tpu.ops.fft`` (and the reference's cvComplex
``fft2``/``ifft2``): the forward transform is unnormalized, the inverse
carries the 1/N² scale (``DFT_SCALE``, fpmMain.cpp:481), and real input is
promoted to the matching complex dtype. The TPU package's matmul-DFT path
exists only for its matrix unit and is not ported; the port's kernels build
their own DFT matrices from :func:`_dft_matrix_np`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _dft_matrix_np(n: int, inverse: bool, dtype: str) -> np.ndarray:
    """The (inverse-normalized) n×n DFT matrix, built in float64 then cast."""
    k = np.arange(n)
    sign = 2j if inverse else -2j
    mat = np.exp(sign * np.pi * np.outer(k, k) / n)
    if inverse:
        mat = mat / n
    return mat.astype(dtype)


def _ensure_complex(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64 else torch.complex64)


def fft2(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized forward 2D FFT over the last two axes."""
    return torch.fft.fft2(_ensure_complex(x))


def ifft2(x: torch.Tensor) -> torch.Tensor:
    """Normalized (1/N²) inverse 2D FFT over the last two axes."""
    return torch.fft.ifft2(_ensure_complex(x))
