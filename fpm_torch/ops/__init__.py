"""Complex-math layer of the port: shifts, patch crop/paste, FFTs, and the
hand-written CUDA sweep kernels (:mod:`fpm_torch.ops.kernels`)."""

from .complexops import crop_patch, fftshift2d, ifftshift2d, paste_patch_add  # noqa: F401
from .fft import fft2, ifft2  # noqa: F401
