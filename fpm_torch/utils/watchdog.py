"""Stall/failure detection for long runs (SURVEY.md §5 failure row).

A copy of ``fpm_tpu.utils.watchdog`` (which imports no JAX, but the port
imports nothing of the JAX package), with the same class and behaviour.

The reference has no failure handling at all; a JAX multi-process run has a
specific failure mode the stack does not surface: when a peer process dies,
the survivors *hang* inside the next collective (psum/ppermute over DCN)
rather than erroring; a wedged GPU call hangs the same way. A run
wedged like this holds its cards forever and never reaches the
checkpoint/resume machinery.

``Watchdog`` converts that silent hang into a detected failure: the solve
loop calls :meth:`beat` after every completed unit of progress (the CLI
beats once per iteration chunk, or per round of large-FOV tiles); a daemon
thread aborts the process with a
diagnostic once no beat arrives within ``timeout`` seconds. Exiting is the
correct recovery primitive here — the surviving processes of a broken
collective cannot continue; a supervisor (or operator) restarts the job,
which resumes bit-deterministically from the latest checkpoint
(utils/checkpoint.py).
"""

from __future__ import annotations

import os
import sys
import threading
import time


class Watchdog:
    """Abort the process when progress stalls for ``timeout`` seconds.

    ``on_timeout`` (for tests) replaces the default ``os._exit(exit_code)``
    action. The default action is deliberately ``os._exit`` rather than an
    exception: the stalled thread is blocked inside a collective and will
    never observe a Python exception raised elsewhere.
    """

    def __init__(self, timeout: float, on_timeout=None, exit_code: int = 42,
                 poll_interval: float | None = None):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = float(timeout)
        self._on_timeout = on_timeout
        self._exit_code = exit_code
        self._poll = poll_interval if poll_interval is not None else min(
            1.0, self.timeout / 4
        )
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self):
        """Record progress; resets the stall clock."""
        self._last = time.monotonic()

    @property
    def running(self) -> bool:
        return self._thread is not None

    def start(self) -> "Watchdog":
        self._last = time.monotonic()  # the stall clock starts NOW
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fpm-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self):
        while not self._stop.wait(self._poll):
            stalled = time.monotonic() - self._last
            if stalled > self.timeout:
                msg = (f"[fpm-torch] WATCHDOG: no progress for {stalled:.1f}s "
                       f"(timeout {self.timeout:.1f}s) — a peer process "
                       "likely died and this process is wedged in a "
                       "collective; aborting for supervisor restart "
                       "(resume from the latest checkpoint)")
                print(msg, file=sys.stderr, flush=True)
                if self._on_timeout is not None:
                    self._on_timeout()
                    return
                os._exit(self._exit_code)
