"""Phase timers and ``torch.profiler`` traces.

Every pipeline phase is wall-clock timed and wrapped in a
``torch.profiler.record_function`` range, so a trace attributes device time
to ingest / solve / output (the JAX package uses ``jax.profiler`` the same
way). A range costs next to nothing when no profiler is running.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def phase(name: str, logger=None, echo: bool = True):
    """Time a pipeline phase; name it in profiler traces."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log("phase", name=name, seconds=round(dt, 6))
    if echo:
        # Mirrors the reference's per-phase prints (fpmMain.cpp:489).
        print(f"[fpm-torch] {name} completed (time: {dt:.3f} s)")


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block into ``<log_dir>/fpm_torch_trace.json``
    (a Chrome trace; CUDA activity included when a GPU is present). The
    trace is written on every exit path. ``log_dir=None`` profiles nothing."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "fpm_torch_trace.json"))
