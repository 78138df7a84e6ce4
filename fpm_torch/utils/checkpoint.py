"""Deterministic checkpoint/resume for the iterative solve.

The same ``.npz`` layout and provenance fingerprint as
``fpm_tpu.utils.checkpoint``, so a checkpoint written by either package
resumes in the other; the same holds for the large-FOV :class:`TileStore`'s
``tile_NNNN.npz`` files.

The reference has no checkpointing at all — a killed run loses everything and
results only ever existed in GUI windows (SURVEY.md §5, fpmMain.cpp:495-497).
The solver state is tiny and RNG-free: ``(obj_f_centered, pupil, iteration)``
fully determines the rest of the run *given the same problem and solver
options*, so restart is bit-deterministic.

"Given the same" is load-bearing: resuming a ``chunk_size=32`` batched run
with ``--mode sequential`` silently converges to a different fixed point.
Each checkpoint therefore carries a provenance fingerprint (problem shape,
solver mode/chunking, dtype, and a hash of the NA-ordered LED schedule) and
``load_checkpoint`` refuses to resume under a different one.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


class CheckpointMismatch(ValueError):
    """Resume was attempted with a different problem/solver configuration.

    Subclasses ValueError so the CLI's clean one-line error handler
    catches it (a strict --resume mismatch must exit 1 with the message,
    not a traceback)."""


def fingerprint(cfg, geom=None, **solver_opts) -> dict:
    """Canonical provenance dict for a run.

    ``cfg`` supplies the problem shape; ``geom`` (if given) pins the exact
    NA-ordered schedule the sweeps iterate in — two runs with the same shapes
    but different LED subsets/orderings are different trajectories.
    ``solver_opts`` are the knobs that change the iteration map itself
    (mode, chunk_size, chunk_assign, global_max, dft_precision, ...).
    """
    fp = {
        "np_size": int(cfg.np_size),
        "n_large": int(cfg.n_large),
        "dtype": str(cfg.dtype),
        "delta1": float(cfg.delta1),
        "delta2": float(cfg.delta2),
        "eps": float(cfg.eps),
    }
    if geom is not None:
        sched = np.ascontiguousarray(np.asarray(geom.schedule, np.int64))
        idx_uv = np.ascontiguousarray(np.asarray(geom.idx_uv, np.int64))
        h = hashlib.sha256()
        for a in (sched, idx_uv):
            h.update(a.tobytes())
        fp["schedule_sha"] = h.hexdigest()[:16]
    for k in sorted(solver_opts):
        v = solver_opts[k]
        fp[k] = v if isinstance(v, (int, float, bool, str, type(None))) else str(v)
    return fp


def _fingerprint_diffs(saved: dict, expect: dict) -> dict:
    """Mismatched keys between a stored fingerprint and the current run's.

    An empty stored fingerprint counts as a mismatch (pre-provenance
    artifact) — shared by sweep checkpoints and tile stores so the refusal
    semantics cannot drift apart."""
    diffs = {
        k: (saved.get(k), expect[k])
        for k in expect
        if saved.get(k) != expect[k]
    }
    if not saved:
        diffs = {"<fingerprint>": ("missing (pre-provenance checkpoint)", "present")}
    return diffs


def _mismatch_message(path: str, diffs: dict) -> str:
    return (
        f"checkpoint {path} was written by a different run configuration; "
        "resuming would silently diverge. Mismatched keys: "
        + ", ".join(f"{k}: saved={s!r} vs now={e!r}" for k, (s, e) in diffs.items())
    )


def save_checkpoint(path: str, obj_f_centered, pupil, iteration: int,
                    meta: dict | None = None):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            obj_f_centered=np.asarray(obj_f_centered),
            pupil=np.asarray(pupil),
            iteration=np.int64(iteration),
            fingerprint=np.bytes_(
                json.dumps(meta or {}, sort_keys=True).encode()
            ),
        )
    os.replace(tmp, path)


def load_checkpoint(path: str, expect: dict | None = None, strict: bool = True):
    """Load a checkpoint; verify its fingerprint against ``expect``.

    ``expect=None`` skips the check (inspection tools). ``strict=False``
    downgrades a mismatch to a printed warning — for deliberate
    restart-under-new-options experiments.
    """
    with np.load(path) as z:
        obj_f, pupil, it = z["obj_f_centered"], z["pupil"], int(z["iteration"])
        saved: dict = {}
        if "fingerprint" in z.files:
            saved = json.loads(bytes(z["fingerprint"]).decode() or "{}")
    if expect is not None:
        diffs = _fingerprint_diffs(saved, expect)
        if diffs:
            msg = _mismatch_message(path, diffs)
            if strict:
                raise CheckpointMismatch(msg)
            print(f"[fpm-torch] WARNING: {msg}")
    return obj_f, pupil, it


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> str | None:
    if not os.path.isdir(directory):
        return None
    cands = []
    for f in os.listdir(directory):
        if not (f.startswith(prefix) and f.endswith(".npz")):
            continue
        try:
            cands.append((int(f[len(prefix):-4]), f))
        except ValueError:
            continue  # e.g. a user's ckpt_backup.npz — not ours, skip
    if not cands:
        return None
    return os.path.join(directory, max(cands)[1])



class TileStore:
    """Per-tile result persistence for the large-FOV production mode.

    The ``--fov-grid`` path solves an R×C grid of independent ROI tiles;
    a TileStore writes each completed tile to ``<dir>/tile_<i>.npz``
    (atomically, with the run's provenance fingerprint), and a ``--resume``
    run loads completed tiles instead of re-solving them, refusing tiles
    written under a different configuration (the contract of
    :func:`load_checkpoint`). The layout, keys and fingerprint are those of
    ``fpm_tpu.utils.checkpoint.TileStore``, so a tile written by either
    package resumes under the other. Tiles are independent reconstructions,
    so a resumed run's stitched result is bitwise that of an uninterrupted
    one.

    The store exists wherever tiles are solved, so every process reads the
    same cached set and dispatches the same tiles; ``write=False`` (a process
    that is not the one owning the output directory) makes :meth:`put` a
    no-op.
    """

    def __init__(self, directory: str, meta: dict | None = None,
                 resume: bool = False, strict: bool = True, write: bool = True):
        self.directory = directory
        self.meta = meta or {}
        self.resume = resume
        self.strict = strict
        self.write = write
        if write:
            os.makedirs(directory, exist_ok=True)

    def _path(self, i: int) -> str:
        return os.path.join(self.directory, f"tile_{i:04d}.npz")

    def get(self, i: int):
        """Return the stored (obj_crop, obj_f_centered, pupil, metrics)
        planes for tile ``i``, or None if absent / not resuming."""
        path = self._path(i)
        if not self.resume or not os.path.isfile(path):
            return None
        with np.load(path) as z:
            saved = json.loads(bytes(z["fingerprint"]).decode() or "{}")
            out = (z["obj_crop_p"], z["obj_f_p"], z["pupil_p"], z["metrics"])
        diffs = _fingerprint_diffs(saved, self.meta)
        if diffs:
            msg = _mismatch_message(path, diffs)
            if self.strict:
                raise CheckpointMismatch(msg)
            print(f"[fpm-torch] WARNING: {msg}; re-solving tile {i}")
            return None
        return out

    def put(self, i: int, obj_crop_p, obj_f_p, pupil_p, metrics):
        """Atomically persist tile ``i`` ((2,...) real/imag plane arrays)."""
        if not self.write:
            return
        path = self._path(i)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                obj_crop_p=np.asarray(obj_crop_p),
                obj_f_p=np.asarray(obj_f_p),
                pupil_p=np.asarray(pupil_p),
                metrics=np.asarray(metrics),
                fingerprint=np.bytes_(
                    json.dumps(self.meta, sort_keys=True).encode()
                ),
            )
        os.replace(tmp, path)
