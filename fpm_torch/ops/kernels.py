"""The fused EPRY sweep kernels K1 and K2, each beside its plain version.

* K1 :func:`fused_epry_chunked` — one chunked Gauss–Seidel-over-Jacobi
  sweep (the ``--mode batched`` path). Replaces
  ``fpm_tpu/ops/pallas_kernels.py:fused_epry_chunked``; CUDA source
  ``csrc/epry_chunked.cu``.
* K2 :func:`fused_epry_sweep` — one exact sequential sweep (the
  ``--mode sequential`` path). Replaces
  ``fpm_tpu/ops/pallas_kernels.py:fused_epry_sweep``; CUDA source
  ``csrc/epry_sweep.cu``.

Both take and return the JAX package's operands: the centered object
spectrum as (2, NL, NL) float32 (re, im) planes, the pupil as (2, Np, Np)
planes in the DC-at-corner frame, the support as (Np, Np) float32, and
return ``(o_planes, p_planes, mets)`` with ``mets`` the per-sweep
(data-residual, update-norm) sums (zeros unless ``collect_metrics``).
Around the kernel, plain PyTorch rolls the pupil and support to the
centered frame and crops them to the NA disk's bounding box, and undoes
that afterwards (so the pupil is exactly zero outside the box).

Dispatch: a wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version (``*_plain``, same function, same operands) for CPU
tensors; nothing falls back. Each wrapper adds to ``<wrapper>.launches``
the launches its C entry point counted, one per kernel launch accepted.

What bounds the kernels on an H100, and what the design does about it: see
``csrc/epry_common.cuh`` (FP32 operations of four small complex DFT
products per LED, all intermediates of one LED held in one block's shared
memory).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .complexops import clamp_start
from .fft import _dft_matrix_np

# The plain versions are the kernels' references on the card: every float32
# product in them must be a full FP32 product, not TF32 (~3 decimal digits).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _support_bbox(n: int, radius: int) -> tuple[int, int]:
    """(b, lo): bounding box of the centered NA disk; b 8-aligned, lo free.

    The disk is ``dist² <= radius²`` around ``c = round(n/2)``
    (geometry.pupil_support): rows/cols [c-radius, c+radius]. ``radius <= 0``
    (restriction disabled) gives the full 8-padded patch at lo=0; then
    ``lo + b`` may pass ``n`` and the kernels use the extent inside the
    patch, ``min(b, n - lo)``.
    """
    if radius <= 0:
        return _round_up(n, 8), 0
    c = round(n / 2)
    b = _round_up(2 * radius + 1, 8)
    if b >= n:
        return _round_up(n, 8), 0
    return b, c - radius


def bbox_extent(n: int, radius: int) -> tuple[int, int]:
    """(b, lo) of the box the kernels work on: the bbox clipped to the patch."""
    b, lo = _support_bbox(n, radius)
    return min(b, n - lo), lo


@functools.lru_cache(maxsize=16)
def _block_dft_mats(n: int, b: int, lo: int) -> tuple[np.ndarray, ...]:
    """The shift-folded, bbox-selected DFT matrices (Ai, Bi, Af, Bf).

    For even n the half-roll permutation S satisfies S = Sᵀ = S⁻¹, so
      ifft2(ifftshift(X))  = (F⁻¹S) X (SF⁻¹)     — centered input
      fftshift(fft2(y))    = (SF) y (FS)         — centered output
    and with the bbox ``sel = lo:lo+b`` (the pupil is zero outside it)
      Ai = (F⁻¹S)[:, sel] (n, b)    Bi = (SF⁻¹)[sel, :] (b, n)
      Af = (SF)[sel, :]   (b, n)    Bf = (FS)[:, sel]   (n, b)
    Built in float64, returned as contiguous complex64 arrays.
    """
    h = n // 2
    fwd = _dft_matrix_np(n, False, "complex128")
    inv = _dft_matrix_np(n, True, "complex128")
    mats = (
        np.roll(inv, -h, axis=1)[:, lo:lo + b],
        np.roll(inv, -h, axis=0)[lo:lo + b, :],
        np.roll(fwd, -h, axis=0)[lo:lo + b, :],
        np.roll(fwd, -h, axis=1)[:, lo:lo + b],
    )
    return tuple(np.ascontiguousarray(m.astype(np.complex64)) for m in mats)


@functools.lru_cache(maxsize=16)
def _dft_mats(n: int, b: int, lo: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(m).to(device) for m in _block_dft_mats(n, b, lo))


def _pupil_to_bbox(p_planes, support, n: int, b: int, lo: int):
    """Pupil planes and support, corner frame → centered bbox (contiguous)."""
    half = n // 2
    sel = slice(lo, lo + b)
    pc = torch.roll(p_planes, (half, half), dims=(1, 2))[:, sel, sel].contiguous()
    sc = torch.roll(support, (half, half), dims=(0, 1))[sel, sel].contiguous()
    return pc, sc


def _pupil_from_bbox(pc, n: int, lo: int):
    """Centered bbox pupil planes → full (2, n, n) corner-frame planes."""
    b = pc.shape[-1]
    full = pc.new_zeros((2, n, n))
    full[:, lo:lo + b, lo:lo + b] = pc
    return torch.roll(full, (-(n // 2), -(n // 2)), dims=(1, 2))


# ------------------------------------------------------------ plain versions
#
# The same arithmetic as the CUDA kernels, per LED, in complex64 tensor ops,
# on the kernels' own operands: o (2, NL, NL) planes, pc (2, b, b) centered
# bbox pupil planes, sc (b, b) support, amps, int32 starts (and valid).


def _windows(starts, n: int, nl: int, b: int, lo: int):
    """The (rows, cols) slices of each LED's b×b window: the patch start
    clamped as the kernels and JAX's crop clamp it, plus lo."""
    def one(s):
        s = clamp_start(s, nl, n) + lo
        return slice(s, s + b)
    return [(one(y), one(x)) for y, x in starts.view(-1, 2).tolist()]


def _complex(planes):
    return torch.complex(planes[0], planes[1])


def _planes(z):
    return torch.stack([z.real, z.imag]).contiguous()


def _forward(oc, p, amp, mats, eps):
    """(img, up) of the LED(s) with window(s) ``oc`` — see led_forward."""
    ai, bi, af, bf = mats
    img = ai @ (oc * p) @ bi
    rep = img * (amp / torch.sqrt((img.real + eps) ** 2 + (img.imag + eps) ** 2))
    return img, af @ rep @ bf


def _object_weight(p, delta2):
    """|P|·conj(P) / (max|P| · (|P|² + delta2))."""
    pabs2 = p.real * p.real + p.imag * p.imag
    pmax = torch.sqrt(pabs2.max())
    return torch.sqrt(pabs2) * p.conj() / (pmax * (pabs2 + delta2))


def _pupil_weight(oc, sup, delta1):
    """|Oc|·conj(Oc) · support / (|Oc|² + delta1) — the 1/max|O| comes later."""
    oabs2 = oc.real * oc.real + oc.imag * oc.imag
    return torch.sqrt(oabs2) * oc.conj() * (sup / (oabs2 + delta1))


def _abs_max(o):
    return torch.sqrt((o.real * o.real + o.imag * o.imag).max())


def _sq_sum(z, dims):
    return (z.real * z.real + z.imag * z.imag).sum(dims)


def _sweep_core_plain(o, pc, sc, amps, starts, *, lo, eps, delta1, delta2,
                      global_max, collect_metrics):
    n, b = amps.shape[-1], pc.shape[-1]
    mats = _dft_mats(n, b, lo, o.device)
    obj, pup = _complex(o), _complex(pc)
    mets = torch.zeros(2, dtype=torch.float32, device=o.device)
    omax_lazy = _abs_max(obj)
    for k, win in enumerate(_windows(starts, n, o.shape[-1], b, lo)):
        oc = obj[win].clone()
        img, up = _forward(oc, pup, amps[k], mats, eps)
        diff = up - oc * pup
        d_obj = diff * _object_weight(pup, delta2)
        obj[win] += d_obj
        omax = _abs_max(obj) if global_max == "exact" else omax_lazy
        pup = pup + diff * _pupil_weight(oc, sc, delta1) * (1.0 / omax)
        if collect_metrics:
            mets += torch.stack([((amps[k] - img.abs()) ** 2).sum(), _sq_sum(d_obj, (0, 1))])
    return _planes(obj), _planes(pup), mets


def _chunked_core_plain(o, pc, sc, amps, starts, valid, *, lo, eps, delta1, delta2,
                        pupil_step_scale, collect_metrics):
    n_chunks, c, n = amps.shape[0], amps.shape[1], amps.shape[-1]
    b = pc.shape[-1]
    mats = _dft_mats(n, b, lo, o.device)
    obj, pup = _complex(o), _complex(pc)
    mets = torch.zeros(2, dtype=torch.float32, device=o.device)
    windows = _windows(starts, n, o.shape[-1], b, lo)
    valid_l = valid.view(n_chunks, c).tolist()
    for k in range(n_chunks):
        live = [j for j in range(c) if valid_l[k][j]]     # masked dummies skipped
        if not live:
            continue
        wins = [windows[k * c + j] for j in live]
        oc = torch.stack([obj[w] for w in wins])           # chunk-start crops
        amp = amps[k, live]
        img, up = _forward(oc, pup, amp, mats, eps)
        diff = up - oc * pup
        d_obj = diff * _object_weight(pup, delta2)
        for w, d in zip(wins, d_obj):
            obj[w] += d
        num = diff * _pupil_weight(oc, sc, delta1)
        pup = pup + pupil_step_scale * (num.sum(0) * (1.0 / _abs_max(obj)))
        if collect_metrics:
            mets += torch.stack([((amp - img.abs()) ** 2).sum(), _sq_sum(d_obj, (0, 1, 2))])
    return _planes(obj), _planes(pup), mets


# ---------------------------------------------------------------- CUDA route


def _check_cuda_operands(o, pc, sc, amps, starts, *, n_slots, valid=None):
    """Raise on anything the kernels do not take: device, dtype and shapes.
    (Patch starts need no check: the kernels clamp them. An Np too large for
    one block's shared memory is refused by the kernels' entry points.)"""
    dev, n, b, nl = o.device, amps.shape[-1], pc.shape[-1], o.shape[-1]
    operands = [("o_planes", o, torch.float32), ("pupil", pc, torch.float32),
                ("support", sc, torch.float32), ("amps", amps, torch.float32),
                ("starts", starts, torch.int32)]
    if valid is not None:
        operands.append(("valid", valid, torch.int32))
    for name, t, dt in operands:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the spectrum on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    if (o.shape != (2, nl, nl) or pc.shape != (2, b, b) or sc.shape != (b, b)
            or amps.shape[-2] != n or amps.numel() != n_slots * n * n
            or starts.numel() != 2 * n_slots
            or (valid is not None and valid.numel() != n_slots)):
        raise ValueError(
            f"operand shapes do not fit together: o {tuple(o.shape)}, pupil "
            f"{tuple(pc.shape)}, support {tuple(sc.shape)}, amps {tuple(amps.shape)}, "
            f"starts {tuple(starts.shape)}")


def _sweep_cuda(o, pc, sc, amps, starts, *, lo, eps, delta1, delta2, global_max,
                collect_metrics):
    n, b, nl, k = amps.shape[-1], pc.shape[-1], o.shape[-1], amps.shape[0]
    _check_cuda_operands(o, pc, sc, amps, starts, n_slots=k)
    lib = build.library("epry_sweep")
    o, pc = o.contiguous().clone(), pc.contiguous().clone()
    sc, amps, starts = sc.contiguous(), amps.contiguous(), starts.contiguous()
    mats = _dft_mats(n, b, lo, o.device)
    rowmax = torch.empty(nl, dtype=torch.float32, device=o.device)
    mets = torch.zeros(2, dtype=torch.float32, device=o.device)
    launched = ctypes.c_int(0)
    err = lib.fpm_k2_sweep(
        o.data_ptr(), pc.data_ptr(), sc.data_ptr(), amps.data_ptr(), starts.data_ptr(),
        *(m.data_ptr() for m in mats), rowmax.data_ptr(), mets.data_ptr(),
        k, n, b, lo, nl, eps, delta1, delta2,
        int(global_max == "exact"), int(collect_metrics), o.device.index,
        torch.cuda.current_stream(o.device).cuda_stream, ctypes.byref(launched))
    fused_epry_sweep.launches += launched.value
    build.check(lib, err, "K2 fused_epry_sweep")
    return o, pc, mets


def _chunked_cuda(o, pc, sc, amps, starts, valid, *, lo, eps, delta1, delta2,
                  pupil_step_scale, collect_metrics):
    n_chunks, c, n = amps.shape[0], amps.shape[1], amps.shape[-1]
    b, nl = pc.shape[-1], o.shape[-1]
    _check_cuda_operands(o, pc, sc, amps, starts, n_slots=n_chunks * c, valid=valid)
    lib = build.library("epry_chunked")
    o, pc = o.contiguous().clone(), pc.contiguous().clone()
    sc, amps = sc.contiguous(), amps.contiguous()
    starts, valid = starts.contiguous(), valid.contiguous()
    dev = o.device
    mats = _dft_mats(n, b, lo, dev)
    d_obj = torch.empty((c, b, b, 2), dtype=torch.float32, device=dev)
    num = torch.empty((c, b, b, 2), dtype=torch.float32, device=dev)
    parts = torch.empty((c, 2), dtype=torch.float32, device=dev)
    omax_bits = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    mets = torch.zeros(2, dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    err = lib.fpm_k1_sweep(
        o.data_ptr(), pc.data_ptr(), sc.data_ptr(), amps.data_ptr(), starts.data_ptr(),
        valid.data_ptr(), *(m.data_ptr() for m in mats), d_obj.data_ptr(),
        num.data_ptr(), parts.data_ptr(), omax_bits.data_ptr(), mets.data_ptr(),
        n_chunks, c, n, b, lo, nl, eps, delta1, delta2, pupil_step_scale,
        int(collect_metrics), dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(launched))
    fused_epry_chunked.launches += launched.value
    build.check(lib, err, "K1 fused_epry_chunked")
    return o, pc, mets


# ------------------------------------------------------------------ wrappers


def _route(o_planes, cuda_core, plain_core):
    if o_planes.is_cuda:
        return cuda_core
    if o_planes.device.type == "cpu":
        return plain_core
    raise ValueError(f"no kernel for device {o_planes.device}")


def _check_patch_size(p_planes, support, amps, np_size):
    n = np_size
    if (tuple(p_planes.shape) != (2, n, n) or tuple(support.shape) != (n, n)
            or tuple(amps.shape[-2:]) != (n, n)):
        raise ValueError(f"pupil {tuple(p_planes.shape)}, support {tuple(support.shape)} "
                         f"and amps {tuple(amps.shape)} must be {n}×{n} patches")


def _run(core, o_planes, p_planes, support, amps, *rest, np_size, pupil_radius, **core_kw):
    """Pupil and support to the centered bbox, the core, and back."""
    _check_patch_size(p_planes, support, amps, np_size)
    b, lo = bbox_extent(np_size, pupil_radius)
    pc, sc = _pupil_to_bbox(p_planes, support, np_size, b, lo)
    o, pc, mets = core(o_planes, pc, sc, amps, *rest, lo=lo, **core_kw)
    return o, _pupil_from_bbox(pc, np_size, lo), mets


def _check_global_max(global_max):
    if global_max not in ("exact", "lazy"):
        raise ValueError(f"global_max must be 'exact' or 'lazy', got {global_max!r}")


def fused_epry_sweep(o_planes, p_planes, support, amps, starts_flat, *, np_size,
                     n_large, delta1, delta2, eps, pupil_radius=0, global_max="exact",
                     collect_metrics=False):
    """K2: one sequential EPRY sweep (``models.epry.sweep_sequential``).

    ``amps`` (K, Np, Np) float32 in schedule order, ``starts_flat`` (2K,)
    int32 ``[y0, x0, y1, x1, ...]``. ``global_max='lazy'`` freezes max|O| at
    its sweep-start value. ``n_large`` is implied by ``o_planes`` and kept
    for the JAX package's signature.
    """
    _check_global_max(global_max)
    core = _route(o_planes, _sweep_cuda, _sweep_core_plain)
    return _run(core, o_planes, p_planes, support, amps, starts_flat, np_size=np_size,
                pupil_radius=pupil_radius, eps=eps, delta1=delta1, delta2=delta2,
                global_max=global_max, collect_metrics=collect_metrics)


def fused_epry_sweep_plain(o_planes, p_planes, support, amps, starts_flat, *, np_size,
                           n_large, delta1, delta2, eps, pupil_radius=0,
                           global_max="exact", collect_metrics=False):
    """The plain PyTorch version of :func:`fused_epry_sweep`, on any device."""
    _check_global_max(global_max)
    return _run(_sweep_core_plain, o_planes, p_planes, support, amps, starts_flat,
                np_size=np_size, pupil_radius=pupil_radius, eps=eps, delta1=delta1,
                delta2=delta2, global_max=global_max, collect_metrics=collect_metrics)


def fused_epry_chunked(o_planes, p_planes, support, amps, starts_flat, valid, *,
                       np_size, n_large, delta1, delta2, eps, pupil_radius=0,
                       pupil_step_scale=1.0, collect_metrics=False):
    """K1: one chunked Gauss–Seidel-over-Jacobi sweep (``models.epry.sweep_batched``).

    ``amps`` (n_chunks, C, Np, Np) float32 in chunk-permuted schedule order,
    ``starts_flat`` (n_chunks·C·2,) int32, ``valid`` (n_chunks·C,) int32
    (0 = padded dummy). ``n_large`` is implied by ``o_planes``.
    """
    core = _route(o_planes, _chunked_cuda, _chunked_core_plain)
    return _run(core, o_planes, p_planes, support, amps, starts_flat, valid,
                np_size=np_size, pupil_radius=pupil_radius, eps=eps, delta1=delta1,
                delta2=delta2, pupil_step_scale=pupil_step_scale,
                collect_metrics=collect_metrics)


def fused_epry_chunked_plain(o_planes, p_planes, support, amps, starts_flat, valid, *,
                             np_size, n_large, delta1, delta2, eps, pupil_radius=0,
                             pupil_step_scale=1.0, collect_metrics=False):
    """The plain PyTorch version of :func:`fused_epry_chunked`, on any device."""
    return _run(_chunked_core_plain, o_planes, p_planes, support, amps, starts_flat, valid,
                np_size=np_size, pupil_radius=pupil_radius, eps=eps, delta1=delta1,
                delta2=delta2, pupil_step_scale=pupil_step_scale,
                collect_metrics=collect_metrics)


fused_epry_sweep.launches = 0
fused_epry_chunked.launches = 0
