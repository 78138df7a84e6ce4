"""Complex-field primitives on torch complex tensors.

Counterparts of ``fpm_tpu.ops.complexops``. The solver keeps the large object
spectrum **centered** (DC in the middle); patch-size shifts between the
centered and corner frames are cheap rolls. Every supported size is even, so
``fftshift == ifftshift`` (the reference's quadrant-swap ``fftShift`` equals
both).
"""

from __future__ import annotations

import torch


def fftshift2d(x: torch.Tensor) -> torch.Tensor:
    """fftshift over the last two axes (corner frame → centered frame)."""
    return torch.fft.fftshift(x, dim=(-2, -1))


def ifftshift2d(x: torch.Tensor) -> torch.Tensor:
    """ifftshift over the last two axes (centered frame → corner frame)."""
    return torch.fft.ifftshift(x, dim=(-2, -1))


def clamp_start(s: int, dim: int, size: int) -> int:
    """A patch start as JAX's ``dynamic_slice`` takes it: a negative start
    counts from the end, then the start is clamped so the patch fits."""
    s = int(s)
    if s < 0:
        s += dim
    return min(max(s, 0), dim - size)


def _clamped(spectrum: torch.Tensor, start_yx, size: int) -> tuple[int, int]:
    return (clamp_start(start_yx[0], spectrum.shape[-2], size),
            clamp_start(start_yx[1], spectrum.shape[-1], size))


def crop_patch(spectrum: torch.Tensor, start_yx, size: int) -> torch.Tensor:
    """``size×size`` patch (a view) at (row, col) ``start_yx`` of host
    integers (fpmMain.cpp:361)."""
    y, x = _clamped(spectrum, start_yx, size)
    return spectrum[..., y:y + size, x:x + size]


def paste_patch_add(spectrum: torch.Tensor, patch: torch.Tensor, start_yx) -> torch.Tensor:
    """Add ``patch`` into ``spectrum`` at (row, col) ``start_yx``, in place,
    and return ``spectrum`` (fpmMain.cpp:429-446). The JAX version returns a
    new array; here the solver owns its state tensors and saves the copy."""
    size = patch.shape[-1]
    y, x = _clamped(spectrum, start_yx, size)
    spectrum[..., y:y + size, x:x + size] += patch
    return spectrum
