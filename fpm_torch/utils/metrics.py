"""Structured per-iteration metrics as JSONL.

The reference computes no convergence metric at all — only wall-clock prints
(fpmMain.cpp:477-480,487-489). The solver emits per-sweep data-fidelity
residual and update norms; this module streams them, plus phase timings, to
a JSONL file (the same records as ``fpm_tpu.utils.metrics``).
"""

from __future__ import annotations

import json
import time


class MetricsLogger:
    def __init__(self, path: str | None, resume: bool = False):
        # Fresh runs truncate: appending a new run's records onto a stale
        # file would interleave two configs'/iterations' streams and poison
        # any consumer. Resumes append (one continuing logical run).
        self._f = open(path, "a" if resume else "w") if path else None
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.perf_counter() - self._t0, 6), **fields}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()

