"""The native C++ ingest: multithreaded TIFF decode and preprocess.

A ctypes wrapper over ``fpm_io.cpp``, this package's own copy of the JAX
package's decoder (``fpm_tpu/native/fpm_io.cpp``, byte for byte; a test
holds the two equal). It decodes TIFF stacks (strips or tiles; raw, LZW,
Deflate, predictor 2; either byte order) and runs the ROI crop, the
darkfield division and the background subtraction in parallel threads,
bitwise the Python (PIL) path of ``fpm_torch.data.loader``. Files it cannot
decode are flagged in a per-file status for the caller's Python fallback.

The library is built at first use with ``g++`` and the JAX package's
Makefile flags into the git-ignored ``build/fpm_torch_native/`` at the
repository root, under a name that carries a hash of the source and the
flags (an edited source rebuilds; a stale library is never loaded). Where
``g++`` or zlib is missing the build fails, :func:`available` is False and
:func:`build_error` says why; the loader then takes the Python path, as
``fpm_tpu``'s does when its library is absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fpm_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fpm_torch_native"
# fpm_tpu/native/Makefile: $(CXX) $(CXXFLAGS) -shared -o $@ $< -pthread -lz
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
LINK_FLAGS = ["-pthread", "-lz"]
ABI_VERSION = 4

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error: str | None = None


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfpm_io_{h.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    """Compile ``fpm_io.cpp`` into ``path`` (atomically: a temporary file,
    then a rename, so a concurrent build never loads a half-written one)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {SOURCE.name}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, path)


def _bind(lib: ctypes.CDLL) -> None:
    common = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,                     # n images
        ctypes.c_int, ctypes.c_int,       # crop x, y (fpm_load_frames: frame w, h)
        ctypes.c_int,                     # np_size
        ctypes.c_int, ctypes.c_int,       # bk1 x, y
        ctypes.c_int, ctypes.c_int,       # bk2 x, y
        ctypes.c_double,                  # bg_threshold
        ctypes.c_int,                     # darkfield multiplier
        ctypes.POINTER(ctypes.c_uint8),   # is_darkfield flags
        ctypes.c_int,                     # channel (BGR index; -1 gray; -2 all three)
        ctypes.c_int,                     # threads (0 = auto)
        ctypes.POINTER(ctypes.c_uint16),  # out images
        ctypes.POINTER(ctypes.c_int16),   # out background values
        ctypes.POINTER(ctypes.c_uint8),   # out per-image status
    ]
    for name in ("fpm_load_stack", "fpm_load_frames"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = common


def _load() -> ctypes.CDLL | None:
    """The library, built on first use; None if it cannot be built or is not
    of ABI 4 (then :func:`build_error` says why)."""
    global _lib, _tried, _error
    with _lock:
        if not _tried:
            _tried = True
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                abi = lib.fpm_abi_version() if hasattr(lib, "fpm_abi_version") else 1
                if abi != ABI_VERSION:
                    raise RuntimeError(f"native library {path} has ABI {abi}, "
                                       f"need {ABI_VERSION}")
                _bind(lib)
                _lib = lib
            except (OSError, RuntimeError) as e:
                _error = str(e)
    return _lib


def available() -> bool:
    """Whether the native decoder can be used (built here on first call)."""
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not available (None if it is, or was not tried)."""
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native decoder is not available: {_error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _call(fn, paths, cfg, is_darkfield, geometry, channel, num_threads, out, bgs):
    n = len(paths)
    status = np.empty(n, dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    df = np.ascontiguousarray(np.asarray(is_darkfield), dtype=np.uint8)
    fn(c_paths, n, *geometry, cfg.bk1_crop_x, cfg.bk1_crop_y, cfg.bk2_crop_x, cfg.bk2_crop_y,
       float(cfg.bg_threshold), int(cfg.darkfield_exp_multiplier), _ptr(df, ctypes.c_uint8),
       channel, num_threads, _ptr(out, ctypes.c_uint16), _ptr(bgs, ctypes.c_int16),
       _ptr(status, ctypes.c_uint8))
    return status


def load_and_preprocess(paths, cfg, is_darkfield, num_threads: int = 0):
    """Decode and preprocess the ROI of each image. Returns ``(images (n,
    Np, Np) uint16, bgs (n,) int16, status (n,) uint8)``: ``status[i] != 0``
    marks a file the decoder rejected (missing, another format or encoding),
    which the caller decodes through the Python path instead."""
    lib = _require()
    n, np_sz = len(paths), cfg.np_size
    images = np.empty((n, np_sz, np_sz), dtype=np.uint16)
    bgs = np.empty(n, dtype=np.int16)
    status = _call(lib.fpm_load_stack, paths, cfg, is_darkfield,
                   (cfg.crop_x, cfg.crop_y, np_sz),
                   cfg.color_channel if cfg.color else -1, num_threads, images, bgs)
    return images, bgs, status


def load_and_preprocess_rgb(paths, cfg, is_darkfield, num_threads: int = 0):
    """RGB decode-once: each file decoded once, its three channels
    preprocessed (channel −2, ABI 4). Returns ``(images (n, 3, Np, Np) in
    RGB plane order, bgs (n, 3), status (n,))``; each plane bitwise
    :func:`load_and_preprocess` with that channel configured."""
    lib = _require()
    n, np_sz = len(paths), cfg.np_size
    images = np.empty((n, 3, np_sz, np_sz), dtype=np.uint16)
    bgs = np.empty((n, 3), dtype=np.int16)
    status = _call(lib.fpm_load_stack, paths, cfg, is_darkfield,
                   (cfg.crop_x, cfg.crop_y, np_sz), -2, num_threads, images, bgs)
    return images, bgs, status


def load_frames(paths, cfg, is_darkfield, frame_shape, num_threads: int = 0):
    """Decode and preprocess WHOLE camera frames (no ROI crop; the
    large-FOV ingest), with the same darkfield and background semantics.
    ``frame_shape`` is the expected (H, W); a file of another size is
    flagged in ``status`` for the caller's Python fallback."""
    lib = _require()
    n, (h, w) = len(paths), (int(frame_shape[0]), int(frame_shape[1]))
    frames = np.empty((n, h, w), dtype=np.uint16)
    bgs = np.empty(n, dtype=np.int16)
    status = _call(lib.fpm_load_frames, paths, cfg, is_darkfield, (w, h, cfg.np_size),
                   cfg.color_channel if cfg.color else -1, num_threads, frames, bgs)
    return frames, bgs, status
