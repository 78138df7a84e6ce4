"""Build and load the port's CUDA kernels (``fpm_torch/ops/csrc/*.cu``).

Each ``.cu`` source compiles, with ``nvcc`` for ``sm_90a``, into its own
shared library with a plain C interface under ``build/fpm_torch_kernels/``
at the repository root, and is loaded with ``ctypes``. The sources compile
in parallel, one ``nvcc`` each. A library's file name carries a hash of the
sources and flags, so an edited source rebuilds and a stale library is
never loaded. Nothing is built or imported until a kernel is first
launched: this module imports on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fpm_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(nvcc on PATH or /usr/local/cuda/bin/nvcc)")


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; returns {stem: path}.

    ``nvcc``'s resource report (registers, shared memory, spills per kernel)
    is kept beside each library as ``<name>.log``. A failed build raises
    with the compiler's output.
    """
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _lib_path(src) for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{out}")
                continue
            targets[src.stem].with_suffix(".log").write_text(out)
            os.replace(tmp, targets[src.stem])
        if failures:
            raise RuntimeError("nvcc failed to build the port's kernels:\n"
                               + "\n".join(failures))
    return targets


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of the entry points (see the sources for the argument meaning).
_SIGNATURES = {
    "epry_chunked": {"fpm_k1_sweep": [_P] * 15 + [_I] * 6 + [_F] * 4 + [_I, _I, _P, _IP]},
    "epry_sweep": {"fpm_k2_sweep": [_P] * 11 + [_I] * 5 + [_F] * 3 + [_I, _I, _I, _P, _IP]},
}


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    lib = ctypes.CDLL(str(build_all()[stem]))
    for name, argtypes in _SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fpm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fpm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point refused its operands or a launch failed."""
    if err != 0:
        msg = lib.fpm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: {msg} (error {err})")
