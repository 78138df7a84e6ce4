"""Build and load the port's CUDA kernels (``fpm_torch/ops/csrc/*.cu``).

Each ``.cu`` source compiles, with ``nvcc`` for ``sm_90a``, into its own
shared library with a plain C interface under ``build/fpm_torch_kernels/``
at the repository root, and is loaded with ``ctypes``. The sources compile
in parallel, one ``nvcc`` each. A library's file name carries a hash of the
sources and flags, so an edited source rebuilds and a stale library is
never loaded. Nothing is built or imported until a kernel is first
launched: this module imports on machines without ``nvcc`` or a GPU.

``profile_library(stem)`` builds a second variant with ``-DFPM_PROFILE``,
whose K2 kernel counts SM cycles per phase of an LED (``csrc/epry_common.cuh``,
``FPM_PHASES``); only measurements ask for it, no wrapper does.
``ablation_library(stem)`` (K1 and K2) builds one with ``-DFPM_ABLATE``,
which adds the kernels of ``ablate=`` (each stage that a variant turns off
is a template argument of those kernels alone, ``Ablate`` in
``csrc/epry_common.cuh``): the wrappers load it only for a non-empty
``ablate``, so the libraries of the main path are built with the flags and
code they had. ``build_with_ablations()`` starts every main and ablation
build at once, one ``nvcc`` each. Only measurements ask for
``resources(stem)`` (ptxas's registers and spills of each compiled
function) and ``hmma_counts(stem)`` (the tensor-core instructions in each
function's SASS, from ``cuobjdump``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fpm_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit "
                       f"({name} on PATH or /usr/local/cuda/bin/{name})")


PROFILE_FLAGS = ["-DFPM_PROFILE"]
ABLATE_FLAGS = ["-DFPM_ABLATE"]
# The sources whose kernels take ``ablate=`` (K1, K2).
ABLATION_STEMS = ("epry_chunked", "epry_sweep")


def _lib_path(source: Path, flags: list[str]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def _build(requests) -> list[dict[str, Path]]:
    """Compile the missing libraries of several builds, given as (stems or
    None for every source, extra flags), their ``nvcc`` runs all started
    together; returns {stem: path} per build.

    ``nvcc``'s resource report (registers, shared memory, spills per kernel)
    is kept beside each library as ``<name>.log``. A failed build raises
    with the compiler's output.
    """
    builds, todo = [], []
    for stems, extra in requests:
        flags = NVCC_FLAGS + extra
        sources = sorted(src for src in CSRC.glob("*.cu") if stems is None or src.stem in stems)
        targets = {src.stem: _lib_path(src, flags) for src in sources}
        builds.append(targets)
        todo += [(src, flags, targets[src.stem]) for src in sources
                 if not targets[src.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _tool("nvcc")
        procs = []
        for src, flags, target in todo:
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *flags, "-o", str(tmp), str(src)]
            procs.append((src, tmp, target, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, tmp, target, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name} ({target.name}):\n{out}")
                continue
            target.with_suffix(".log").write_text(out)
            os.replace(tmp, target)
        if failures:
            raise RuntimeError("nvcc failed to build the port's kernels:\n"
                               + "\n".join(failures))
    return builds


def build_all(stems=None, profile: bool = False, ablate: bool = False) -> dict[str, Path]:
    """Compile every source (or those named in ``stems``) whose library is
    missing, as the main build or, with ``profile`` or ``ablate``, that
    variant; returns {stem: path}."""
    extra = (PROFILE_FLAGS if profile else []) + (ABLATE_FLAGS if ablate else [])
    return _build([(stems, extra)])[0]


def build_with_ablations() -> tuple[dict[str, Path], dict[str, Path]]:
    """The main libraries of every source and the ablation libraries of
    ABLATION_STEMS, all compiled at once: ({stem: path}, {stem: path})."""
    main, ablation = _build([(None, []), (ABLATION_STEMS, ABLATE_FLAGS)])
    return main, ablation


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of the entry points (see the sources for the argument meaning).
_SIGNATURES = {
    "epry_chunked": {"fpm_k1_sweep": [_P] * 15 + [_I] * 7 + [_F] * 4
                     + [_I, _I, _I, _P, _I, _I, _IP, _IP],
                     "fpm_resident_clusters": [_I] * 6 + [_IP]},
    "epry_sweep": {"fpm_k2_sweep": [_P] * 11 + [_I] * 6 + [_F] * 3
                   + [_I, _I, _I, _I, _P, _I, _I, _IP, _IP],
                   "fpm_resident_clusters": [_I] * 6 + [_IP]},
    "epry_increments": {"fpm_k3_increments": [_P] * 16 + [_I] * 6 + [_F] * 3
                        + [_I, _I, _I, _P, _I, _I, _IP, _IP]},
}


# The ablation build's entry points: the main ones with ``ablate`` after ``tier``.
_ABLATION_SIGNATURES = {
    "epry_chunked": {"fpm_k1_sweep_ablate": [_P] * 15 + [_I] * 7 + [_F] * 4
                     + [_I, _I, _I, _I, _P, _I, _I, _IP, _IP]},
    "epry_sweep": {"fpm_k2_sweep_ablate": [_P] * 11 + [_I] * 6 + [_F] * 3
                   + [_I, _I, _I, _I, _I, _P, _I, _I, _IP, _IP]},
}


def _load(path: Path, stem: str, signatures=None) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in {**_SIGNATURES[stem], **(signatures or {})}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fpm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fpm_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    return _load(build_all()[stem], stem)


@functools.lru_cache(maxsize=None)
def profile_library(stem: str) -> ctypes.CDLL:
    """The cycle-counting variant of ``csrc/<stem>.cu`` (built alone, on
    first use): the same entry points, plus ``fpm_phase_count()``,
    ``fpm_phase_name(i)`` and ``fpm_phase_read(out, reset)``."""
    lib = _load(build_all((stem,), profile=True)[stem], stem)
    lib.fpm_phase_count.argtypes = []
    lib.fpm_phase_count.restype = ctypes.c_int
    lib.fpm_phase_name.argtypes = [ctypes.c_int]
    lib.fpm_phase_name.restype = ctypes.c_char_p
    lib.fpm_phase_read.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    lib.fpm_phase_read.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def ablation_library(stem: str) -> ctypes.CDLL:
    """The ablation build of ``csrc/<stem>.cu`` (K1 ``epry_chunked``, K2
    ``epry_sweep``; built on first use, or by :func:`build_with_ablations`):
    the main entry points plus ``fpm_k1_sweep_ablate`` / ``fpm_k2_sweep_ablate``."""
    if stem not in ABLATION_STEMS:
        raise ValueError(f"{stem} has no ablation build; {ABLATION_STEMS} have")
    return _load(build_all((stem,), ablate=True)[stem], stem, _ABLATION_SIGNATURES[stem])


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point refused its operands or a launch failed."""
    if err != 0:
        msg = lib.fpm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: {msg} (error {err})")


def _demangle(names: list[str]) -> dict[str, str]:
    """{mangled: readable} through ``cu++filt`` (the names as they are if it
    is missing or fails)."""
    try:
        out = subprocess.run([_tool("cu++filt"), *names], capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return {n: n for n in names}
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def resources(stem: str, ablate: bool = False) -> dict[str, dict[str, int]]:
    """ptxas's report of the library built from ``csrc/<stem>.cu`` (built on
    first use; ``ablate``: its ablation build): {function: {registers,
    stack, spill_stores, spill_loads}}."""
    log = build_all((stem,), ablate=ablate)[stem].with_suffix(".log").read_text()
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'|Function properties for (\w+)", line)
        if m:
            name = m.group(1) or m.group(2)
            continue
        if name is None:
            continue
        entry = report.setdefault(name, {})
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                entry[key] = int(m.group(1))
    names = _demangle(sorted(report))
    return {names[k]: v for k, v in report.items() if v}


def hmma_counts(stem: str) -> dict[str, int]:
    """{function: HMMA instructions} in the SASS of the library built from
    ``csrc/<stem>.cu`` (``cuobjdump -sass``): the tensor-core products of the
    bf16x3 tier."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(build_all((stem,))[stem])],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    names = _demangle(sorted(counts))
    return {names[k]: v for k, v in counts.items()}
