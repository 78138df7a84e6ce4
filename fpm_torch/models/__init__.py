"""Solver layer: the EPRY phase-retrieval engine (reference L2, ``runFPM``)."""

from .epry import (  # noqa: F401
    EPRYOptions,
    ReconResult,
    init_state,
    led_step,
    reconstruct,
    reconstruct_channels,
    state_from_numpy,
    state_to_numpy,
    sweep_batched,
    sweep_batched_pallas,
    sweep_pallas,
    sweep_sequential,
)
