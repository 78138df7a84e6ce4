"""fpm_torch: the PyTorch/CUDA port of fpm-tpu's EPRY Fourier-ptychography
reconstruction engine, for NVIDIA H100 GPUs.

It sits beside the JAX package ``fpm_tpu`` (the reference, which it never
imports). Public entry points:

* :func:`fpm_torch.load_config` — parse the reference's ``dataset_*.json``.
* :func:`fpm_torch.compute_geometry` — LED illumination geometry.
* :func:`fpm_torch.reconstruct` — the EPRY reconstruction, on ``cuda`` unless
  ``device="cpu"``.
* ``python -m fpm_torch run dataset.json -n ITERS --use-pallas`` — the CLI.
"""

from .config import FPMConfig, default_dome_coordinates, load_config  # noqa: F401
from .geometry import LEDGeometry, compute_geometry, pupil_support  # noqa: F401
from .models import (  # noqa: F401
    EPRYOptions,
    ReconResult,
    reconstruct,
    reconstruct_channels,
    state_from_numpy,
    state_to_numpy,
)

__version__ = "0.1.0"
