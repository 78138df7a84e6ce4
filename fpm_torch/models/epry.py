"""EPRY (embedded pupil recovery) phase-retrieval solver in PyTorch.

The port of ``fpm_tpu.models.epry`` (the reference's ``runFPM``,
fpmMain.cpp:274-498). The large object spectrum ``O`` lives in the
**centered** frame; each LED crops a patch, applies the pupil, replaces the
image-plane amplitude and feeds the difference back into ``O`` and the pupil.

Two sweep modes, each with two routes:

* ``sequential`` — exact Gauss–Seidel LED order (the parity mode):
  :func:`sweep_sequential` in eager tensor ops on ``torch.fft``, or kernel K2
  (:func:`sweep_pallas` → ``ops.kernels.fused_epry_sweep``).
* ``batched`` — chunked Gauss–Seidel-over-Jacobi: the NA-sorted schedule is
  split into chunks (``chunk_assign='strided'`` spreads each chunk across the
  NA range; contiguous chunks and whole-sweep Jacobi are unstable at
  realistic LED counts); inside a chunk every LED update comes from the
  chunk-start state. :func:`sweep_batched` in eager ops, or kernel K1
  (:func:`sweep_batched_pallas` → ``ops.kernels.fused_epry_chunked``).

``use_pallas`` keeps the JAX package's option name: it selects the kernels.
On a CUDA device the sweep runs ONLY through them (the eager route there
is a timing yardstick for ``chip_smoke.py``, never the solver), so
:func:`reconstruct` on ``cuda`` requires ``use_pallas=True``. On the CPU the
kernels' plain PyTorch versions run instead.

The per-LED global ``max|O|`` pupil-update denominator (fpmMain.cpp:467) is
taken over the already-updated spectrum; ``global_max='lazy'`` freezes it at
the sweep-start value (a documented deviation).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import FPMConfig
from ..geometry import LEDGeometry, pupil_support
from ..ops import crop_patch, fft2, fftshift2d, ifft2, ifftshift2d, paste_patch_add
from ..ops import kernels

_COMPLEX = {"complex64": torch.complex64, "complex128": torch.complex128}


@dataclasses.dataclass(frozen=True)
class EPRYOptions:
    """Solver options."""

    np_size: int
    iterations: int
    delta1: float
    delta2: float
    eps: float
    mode: str = "sequential"          # "sequential" | "batched"
    global_max: str = "exact"         # "exact" | "lazy"
    pupil_step_scale: float = 1.0     # batched-mode pupil update scaling
    chunk_size: int = 0               # batched mode: LEDs per Jacobi chunk (0 = all)
    chunk_assign: str = "strided"     # "strided" | "contiguous" chunk makeup
    collect_metrics: bool = True
    use_pallas: bool = False          # run the sweep through the port's kernels
    dft_precision: str = "highest"    # kernels' DFT products: "highest" = FP32
    pupil_radius: int = 0             # NA-disk radius px: the kernels' bbox
    n_large: int = 0
    dtype: str = "complex64"          # solver complex dtype

    def __post_init__(self):
        if self.mode not in ("sequential", "batched"):
            raise ValueError(f"mode must be 'sequential' or 'batched', got {self.mode!r}")
        if self.global_max not in ("exact", "lazy"):
            raise ValueError(f"global_max must be 'exact' or 'lazy', got {self.global_max!r}")
        if self.dft_precision == "bf16x3":
            raise ValueError(
                "dft_precision 'bf16x3' (3xTF32 on Hopper tensor cores): precision "
                "tier not yet ported to fpm_torch; use 'highest'")
        if self.dft_precision != "highest":
            raise ValueError(f"dft_precision must be 'highest', got {self.dft_precision!r}")
        if self.chunk_assign not in ("strided", "contiguous"):
            raise ValueError(
                f"chunk_assign must be 'strided' or 'contiguous', got {self.chunk_assign!r}"
            )
        if self.chunk_size < 0:
            raise ValueError(f"chunk_size must be >= 0, got {self.chunk_size}")
        if self.dtype not in _COMPLEX:
            raise ValueError(f"dtype must be complex64 or complex128, got {self.dtype!r}")

    @classmethod
    def from_config(cls, cfg: FPMConfig, **overrides) -> "EPRYOptions":
        from ..geometry import pupil_radius

        kwargs = dict(
            np_size=cfg.np_size,
            iterations=cfg.iterations,
            delta1=cfg.delta1,
            delta2=cfg.delta2,
            eps=cfg.eps,
            n_large=cfg.n_large,
            dtype=cfg.dtype,
            pupil_radius=pupil_radius(cfg),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    @property
    def cdtype(self) -> torch.dtype:
        return _COMPLEX[self.dtype]

    @property
    def rdtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "complex128" else torch.float32


@dataclasses.dataclass
class ReconResult:
    obj_crop: np.ndarray       # high-res complex object, real space
    obj_f_centered: np.ndarray # high-res spectrum, centered frame
    pupil: np.ndarray          # recovered pupil, DC-at-corner frame
    metrics: dict[str, np.ndarray]

    @property
    def obj_f(self) -> np.ndarray:
        """Spectrum in the reference's DC-at-corner frame (fpmMain.h:92)."""
        return np.fft.ifftshift(self.obj_f_centered)


# ------------------------------------------------------------ device + state


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fpm_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' (CLI: --platform cpu) to run on the CPU")
    return dev


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _as_complex_np(a) -> np.ndarray:
    """A complex array, or (2, ...) real/imag planes, as a complex array."""
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return a
    if a.ndim == 3 and a.shape[0] == 2:
        return a[0] + 1j * a[1]
    return a.astype(np.complex128)


def state_from_numpy(obj_f_centered, pupil, device="cuda", dtype=torch.complex64):
    """Solver state ``(O centered spectrum, pupil)`` as complex tensors.

    Each input is a complex array or a ``(2, ...)`` real/imag plane stack, as
    ``fpm_tpu``'s :class:`ReconResult` and its ``_planes`` give them, so a
    result of either package seeds the other through ``initial_state``.
    """
    dev = resolve_device(device)
    dtype = _COMPLEX[_dtype_name(dtype)]
    return tuple(torch.from_numpy(np.ascontiguousarray(_as_complex_np(a))).to(dev, dtype)
                 for a in (obj_f_centered, pupil))


def state_to_numpy(obj_f, pupil, planes: bool = False):
    """Inverse of :func:`state_from_numpy`: complex numpy arrays, or
    ``(2, ...)`` real/imag planes with ``planes=True``."""
    out = tuple(t.detach().cpu().numpy() for t in (obj_f, pupil))
    if planes:
        return tuple(np.stack([a.real, a.imag]) for a in out)
    return out


# --------------------------------------------------------------------- init


def init_traced(amps_sorted: torch.Tensor, support_r: torch.Tensor, opts: EPRYOptions):
    """Initial (O_centered, pupil) per the reference contract.

    Pupil: the fftshifted filled NA circle (fpmMain.cpp:301-313). Object
    spectrum: the FFT of the *second*-lowest-NA amplitude (``sortedIndicies
    .at(1)``, SURVEY.md quirk 2), masked by the pupil support, pasted at the
    center of the large zeros (fpmMain.cpp:315-343). ``amps_sorted`` is in
    schedule order, so the seed image is index 1.
    """
    dtype = opts.cdtype
    n_large, np_sz = opts.n_large, opts.np_size
    support = support_r.to(dtype)
    seed_idx = 1 if amps_sorted.shape[0] > 1 else 0
    ci = fftshift2d(fft2(amps_sorted[seed_idx].to(dtype)) * support)
    obj_f = torch.zeros((n_large, n_large), dtype=dtype, device=amps_sorted.device)
    top = n_large // 2 - np_sz // 2
    obj_f[top:top + np_sz, top:top + np_sz] = ci
    return obj_f, support.clone()


# ------------------------------------------------------------------ LED step


def _amp_replace(obj_crop_p, amp, eps):
    """Phase-preserving amplitude replacement (fpmMain.cpp:377-394); ``eps``
    is added to BOTH channels (OpenCV's ``cv::add(mat2ch, double)``)."""
    return obj_crop_p / torch.abs(obj_crop_p + eps * (1 + 1j)) * amp


def _object_delta(diff, pupil, delta2):
    """``ΔO = (|P| · conj(P) · diff) / (max|P| · (|P|² + delta2))``
    (fpmMain.cpp:404-419)."""
    pabs = torch.abs(pupil)
    pmax = torch.max(pabs)
    return diff * (pabs * torch.conj(pupil)) / (pmax * (pabs * pabs + delta2))


def _pupil_delta(diff, objf_crop, objf_abs_max, support, delta1):
    """``ΔP = (|Oc| · conj(Oc) · diff) / (max|O| · (|Oc|² + delta1)) · support``
    with ``max|O|`` over the full, already-updated spectrum (fpmMain.cpp:457-472)."""
    oabs = torch.abs(objf_crop)
    return diff * (oabs * torch.conj(objf_crop)) / (
        objf_abs_max * (oabs * oabs + delta1)
    ) * support


def _host_starts(starts):
    """Patch starts as host integers (the eager route slices with them)."""
    if isinstance(starts, torch.Tensor):
        return starts.tolist()
    return np.asarray(starts).tolist()


def led_step(carry, inputs, *, support, opts: EPRYOptions):
    """One Gauss–Seidel LED update: (O, P, omax) × (amp, start) → (O, P, omax).

    Updates ``O`` in place (the sweep owns its copy).
    """
    obj_f, pupil, omax_lazy = carry
    amp, start = inputs
    patch_c = crop_patch(obj_f, start, opts.np_size)
    objf_crop = fftshift2d(patch_c)          # centered → corner frame (even N)
    objf_crop_p = objf_crop * pupil
    obj_crop_p = ifft2(objf_crop_p)

    objf_up = fft2(_amp_replace(obj_crop_p, amp, opts.eps))
    diff = objf_up - objf_crop_p

    d_obj = _object_delta(diff, pupil, opts.delta2)
    paste_patch_add(obj_f, fftshift2d(d_obj), start)

    if opts.global_max == "exact":
        omax = torch.max(torch.abs(obj_f))   # fpmMain.cpp:460,467: per LED
    else:
        omax = omax_lazy

    pupil = pupil + _pupil_delta(diff, objf_crop, omax, support, opts.delta1)

    if opts.collect_metrics:
        out = torch.stack([torch.sum((amp - torch.abs(obj_crop_p)) ** 2),
                           torch.sum(torch.abs(d_obj) ** 2)])
    else:
        out = torch.zeros(2, dtype=amp.dtype, device=amp.device)
    return (obj_f, pupil, omax_lazy), out


# -------------------------------------------------------------------- sweeps


def sweep_sequential(obj_f, pupil, amps, starts, *, support, opts: EPRYOptions):
    """One NA-ascending sequential sweep over all LEDs (eager)."""
    obj_f = obj_f.clone()
    carry = (obj_f, pupil, torch.max(torch.abs(obj_f)))
    per_led = []
    for amp, start in zip(amps, _host_starts(starts)):
        carry, out = led_step(carry, (amp, start), support=support, opts=opts)
        per_led.append(out)
    return carry[0], carry[1], torch.stack(per_led).sum(0)


def _to_planes(z):
    return torch.stack([z.real, z.imag]).to(torch.float32)


def _from_planes(planes, like):
    return torch.complex(planes[0], planes[1]).to(like.dtype)


def sweep_pallas(obj_f, pupil, amps, starts, *, support, opts: EPRYOptions):
    """Sequential sweep through kernel K2 (``ops.kernels.fused_epry_sweep``).

    Per-sweep (residual, update-norm) metrics come from the kernel when
    ``opts.collect_metrics``.
    """
    o_out, p_out, mets = kernels.fused_epry_sweep(
        _to_planes(obj_f), _to_planes(pupil), support.real.to(torch.float32),
        amps.to(torch.float32), starts.reshape(-1).to(torch.int32),
        np_size=opts.np_size, n_large=opts.n_large,
        delta1=opts.delta1, delta2=opts.delta2, eps=opts.eps,
        pupil_radius=opts.pupil_radius, global_max=opts.global_max,
        collect_metrics=opts.collect_metrics,
    )
    return _from_planes(o_out, obj_f), _from_planes(p_out, pupil), mets.to(amps.dtype)


def sweep_batched_pallas(obj_f, pupil, amps_it, starts_it, mask, *, support,
                         opts: EPRYOptions):
    """Chunked sweep through kernel K1 (``ops.kernels.fused_epry_chunked``)
    on the pre-chunked (n_chunks, C, ...) arrays."""
    o_out, p_out, mets = kernels.fused_epry_chunked(
        _to_planes(obj_f), _to_planes(pupil), support.real.to(torch.float32),
        amps_it.to(torch.float32), starts_it.reshape(-1).to(torch.int32),
        (mask > 0).reshape(-1).to(torch.int32),
        np_size=opts.np_size, n_large=opts.n_large,
        delta1=opts.delta1, delta2=opts.delta2, eps=opts.eps,
        pupil_radius=opts.pupil_radius, pupil_step_scale=opts.pupil_step_scale,
        collect_metrics=opts.collect_metrics,
    )
    return _from_planes(o_out, obj_f), _from_planes(p_out, pupil), mets.to(amps_it.dtype)


def effective_chunk_size(np_size: int, chunk_size: int, k: int,
                         use_pallas: bool, mode: str) -> int:
    """The chunk size that will actually run (recorded in provenance).

    Sequential mode and the eager batched route pass the request through;
    the kernel route runs ``min(chunk or K, K)``. (The JAX package also
    clamps to a TPU compiler ceiling; the CUDA kernels have none.)
    """
    if mode != "batched" or not use_pallas:
        return chunk_size
    return min(chunk_size if chunk_size > 0 else k, k)


def chunk_schedule(k: int, chunk_size: int, assign: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Static chunking of a K-LED schedule: (perm, mask, n_chunks).

    ``perm`` (n_chunks·C,) indexes the padded NA-sorted schedule (indices
    ≥ k address masked dummy frames); ``mask`` is 1.0 for real LEDs.
    ``assign='strided'`` gives chunk c the LEDs {c, c+n_chunks, ...}.
    """
    c = chunk_size if chunk_size > 0 else k
    n_chunks = -(-k // c)
    total = n_chunks * c
    if assign == "strided" and n_chunks > 1:
        perm = np.arange(total).reshape(c, n_chunks).T.ravel()
    else:
        perm = np.arange(total)
    mask = (perm < k).astype(np.float32)
    return perm, mask, n_chunks


def jacobi_chunk(obj_f, pupil, amps, starts, mask, *, support, opts: EPRYOptions):
    """One Jacobi chunk: every LED update from the chunk-start state, the
    object increments summed, max|O| after the update, the masked pupil
    increments summed. ``mask`` zeroes padded dummy frames."""
    np_sz = opts.np_size
    m = mask[:, None, None]
    starts = _host_starts(starts)

    patches = torch.stack([crop_patch(obj_f, s, np_sz) for s in starts])
    objf_crop = fftshift2d(patches)
    objf_crop_p = objf_crop * pupil
    obj_crop_p = ifft2(objf_crop_p)
    objf_up = fft2(_amp_replace(obj_crop_p, amps, opts.eps))
    diff = objf_up - objf_crop_p

    d_obj = fftshift2d(_object_delta(diff, pupil, opts.delta2) * m)
    d_obj_full = torch.zeros_like(obj_f)
    for d, s in zip(d_obj, starts):
        paste_patch_add(d_obj_full, d, s)
    obj_f = obj_f + d_obj_full

    omax = torch.max(torch.abs(obj_f))
    d_pupil = _pupil_delta(diff, objf_crop, omax, support, opts.delta1) * m
    pupil = pupil + opts.pupil_step_scale * torch.sum(d_pupil, dim=0)

    if opts.collect_metrics:
        resid = torch.sum(((amps - torch.abs(obj_crop_p)) * m) ** 2)
        upd = torch.sum(torch.abs(d_obj) ** 2)
    else:
        resid = upd = torch.zeros((), dtype=amps.dtype, device=amps.device)
    return obj_f, pupil, torch.stack([resid, upd])


def _chunk_inputs(amps, starts, opts: EPRYOptions, real_dtype):
    """Pad and permute flat (K, ...) schedule arrays into (n_chunks, C, ...)."""
    k = amps.shape[0]
    csize = effective_chunk_size(opts.np_size, opts.chunk_size, k, opts.use_pallas, "batched")
    perm, mask_np, n_chunks = chunk_schedule(k, csize, opts.chunk_assign)
    pad = perm.size - k
    if pad:
        amps = torch.cat([amps, amps.new_zeros((pad,) + tuple(amps.shape[1:]))])
        starts = torch.cat([starts, starts.new_zeros((pad, 2))])
    c = perm.size // n_chunks
    perm_t = torch.as_tensor(perm, device=amps.device)
    mask = torch.as_tensor(mask_np, dtype=real_dtype, device=amps.device)
    return (amps[perm_t].reshape(n_chunks, c, *amps.shape[1:]),
            starts[perm_t].reshape(n_chunks, c, 2), mask.reshape(n_chunks, c))


def sweep_batched(obj_f, pupil, amps, starts, *, support, opts: EPRYOptions, mask=None):
    """One chunked Gauss–Seidel-over-Jacobi sweep (eager).

    ``amps``/``starts``/``mask`` are either flat (K, ...) — chunked here per
    ``opts`` — or pre-chunked (n_chunks, C, ...).
    """
    if amps.ndim == 3:
        amps, starts, mask = _chunk_inputs(amps, starts, opts, torch.abs(obj_f).dtype)
    elif mask is None:
        mask = torch.ones(amps.shape[:2], dtype=torch.abs(obj_f).dtype, device=amps.device)
    mets = []
    for a, s, m in zip(amps, _host_starts(starts), mask):
        obj_f, pupil, met = jacobi_chunk(obj_f, pupil, a, s, m, support=support, opts=opts)
        mets.append(met)
    return obj_f, pupil, torch.stack(mets).sum(0)


# ----------------------------------------------------------------- top level


def _make_sweep_fn(amps, starts, support, support_r, opts: EPRYOptions):
    """Mode and route dispatch; the batched mode's chunk permutation is
    applied once here, not every sweep. Returns
    ``sweep_once(obj_f, pupil) -> (obj_f, pupil, metrics)``."""
    if opts.mode == "batched":
        amps_it, starts_it, mask = _chunk_inputs(amps, starts, opts, support_r.dtype)
        sweep = sweep_batched_pallas if opts.use_pallas else sweep_batched

        def sweep_once(obj_f, pupil):
            return sweep(obj_f, pupil, amps_it, starts_it, support=support, opts=opts,
                         mask=mask)

        return sweep_once

    sweep = sweep_pallas if opts.use_pallas else sweep_sequential

    def sweep_once(obj_f, pupil):
        return sweep(obj_f, pupil, amps, starts, support=support, opts=opts)

    return sweep_once


def _sorted_device_inputs(images, geom: LEDGeometry, dtype: torch.dtype, device):
    """Amplitudes and crop starts in schedule order, on ``device``."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    amps = np.sqrt(np.asarray(images, dtype=np.float64))[geom.schedule]
    starts = geom.crop_start[geom.schedule]
    return (torch.from_numpy(np.ascontiguousarray(amps)).to(device, real),
            torch.from_numpy(np.ascontiguousarray(starts, dtype=np.int32)).to(device))


def reconstruct(
    images,
    geom: LEDGeometry,
    cfg: FPMConfig,
    iterations: int | None = None,
    dtype: Any | None = None,
    initial_state: tuple | None = None,
    device: Any = "cuda",
    **opt_overrides,
) -> ReconResult:
    """End-to-end reconstruction (the ``runFPM`` equivalent).

    Args:
      images: (K, Np, Np) background-subtracted intensity stack ordered by
        ``geom.led_numbers``.
      geom: LED geometry table.
      cfg: experiment configuration.
      iterations: overrides ``cfg.iterations``.
      dtype: solver complex dtype (default from ``cfg.dtype``).
      initial_state: optional ``(obj_f_centered, pupil)`` — complex arrays
        or (2, ...) planes — to resume from instead of the fresh init.
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
      **opt_overrides: :class:`EPRYOptions` fields (``mode``,
        ``use_pallas``, ``chunk_size``, ...).
    """
    dev = resolve_device(device)
    opts = EPRYOptions.from_config(
        cfg, iterations=iterations if iterations is not None else cfg.iterations,
        dtype=_dtype_name(dtype or cfg.dtype), **opt_overrides,
    )
    if dev.type == "cuda" and not opts.use_pallas:
        raise ValueError(
            "on a CUDA device fpm_torch sweeps only through its CUDA kernels: "
            "pass use_pallas=True (CLI: --use-pallas)")
    k = len(geom.schedule)
    eff_chunk = effective_chunk_size(opts.np_size, opts.chunk_size, k, opts.use_pallas,
                                     opts.mode)
    if eff_chunk != opts.chunk_size:
        opts = dataclasses.replace(opts, chunk_size=eff_chunk)
    amps, starts = _sorted_device_inputs(images, geom, opts.cdtype, dev)
    support_r = torch.as_tensor(pupil_support(cfg, centered=False), dtype=opts.rdtype,
                                device=dev)

    if initial_state is not None:
        obj_f, pupil = state_from_numpy(*initial_state, device=dev, dtype=opts.cdtype)
    else:
        obj_f, pupil = init_traced(amps, support_r, opts)

    sweep_once = _make_sweep_fn(amps, starts, support_r.to(opts.cdtype), support_r, opts)
    per_sweep = []
    for _ in range(opts.iterations):
        obj_f, pupil, m = sweep_once(obj_f, pupil)
        per_sweep.append(m)
    # Only the final inverse transform of the full spectrum is observable
    # (fpmMain.cpp:481 computes one per iteration).
    obj_crop = ifft2(ifftshift2d(obj_f))
    metrics = (torch.stack(per_sweep).cpu().numpy() if per_sweep
               else np.zeros((0, 2), np.float64))
    obj_np, pupil_np = state_to_numpy(obj_f, pupil)
    return ReconResult(
        obj_crop=obj_crop.cpu().numpy(),
        obj_f_centered=obj_np,
        pupil=pupil_np,
        metrics={"data_residual": metrics[:, 0], "update_norm": metrics[:, 1]},
    )
