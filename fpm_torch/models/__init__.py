"""Solver layer: the EPRY phase-retrieval engine (reference L2, ``runFPM``)."""

from .epry import (  # noqa: F401
    EPRYOptions,
    ReconResult,
    reconstruct,
    state_from_numpy,
    state_to_numpy,
)
