"""EPRY (embedded pupil recovery) phase-retrieval solver in PyTorch.

The port of ``fpm_tpu.models.epry`` (the reference's ``runFPM``,
fpmMain.cpp:274-498). The large object spectrum ``O`` lives in the
**centered** frame; each LED crops a patch, applies the pupil, replaces the
image-plane amplitude and feeds the difference back into ``O`` and the pupil.

Two sweep modes, each with two routes:

* ``sequential`` — exact Gauss–Seidel LED order (the parity mode):
  :func:`sweep_sequential` in eager tensor ops on ``torch.fft``, or kernel K2
  (``ops.kernels.fused_epry_sweep``).
* ``batched`` — chunked Gauss–Seidel-over-Jacobi: the NA-sorted schedule is
  split into chunks (``chunk_assign='strided'`` spreads each chunk across the
  NA range; contiguous chunks and whole-sweep Jacobi are unstable at
  realistic LED counts); inside a chunk every LED update comes from the
  chunk-start state. :func:`sweep_batched` in eager ops, or kernel K1
  (``ops.kernels.fused_epry_chunked``).

``use_pallas`` keeps the JAX package's option name: it selects the kernels.
On a CUDA device the sweep runs ONLY through them (the eager route there
is a timing yardstick for ``chip_smoke.py``, never the solver), so
:func:`reconstruct` on ``cuda`` requires ``use_pallas=True``. On the CPU the
kernels' plain PyTorch versions run instead. The kernel route solves any
number of same-geometry problems at once (:func:`reconstruct_channels`; a
single :func:`reconstruct` is one problem): each sweep of all of them is ONE
call of K1 or K2 with a problem axis.

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
    dft_precision: str = "bf16x3"     # kernels' DFT products: "bf16x3" | "highest"
    #                                   (read by the kernel route only)
    pupil_radius: int = 0             # NA-disk radius px: the kernels' bbox
    n_large: int = 0
    dtype: str = "complex64"          # solver complex dtype
    comm_precision: str = "f32"       # sharded sweeps' consensus payloads:
    #                                   "f32" | "bf16" (halves every psum and
    #                                   reverse-halo payload; kernel route only)
    stale_consensus: bool = False     # sharded sweeps: chunk c+1's increments
    #                                   come from the state BEFORE chunk c's
    #                                   consensus is applied (one chunk stale)

    def __post_init__(self):
        if self.mode not in ("sequential", "batched"):
            raise ValueError(f"mode must be 'sequential' or 'batched', got {self.mode!r}")
        if self.global_max not in ("exact", "lazy"):
            raise ValueError(f"global_max must be 'exact' or 'lazy', got {self.global_max!r}")
        if self.dft_precision not in ("bf16x3", "highest"):
            raise ValueError(
                f"dft_precision must be 'bf16x3' or 'highest', got {self.dft_precision!r}"
            )
        if self.chunk_assign not in ("strided", "contiguous"):
            raise ValueError(
                f"chunk_assign must be 'strided' or 'contiguous', got {self.chunk_assign!r}"
            )
        if self.chunk_size < 0:
            raise ValueError(f"chunk_size must be >= 0, got {self.chunk_size}")
        if self.dtype not in _COMPLEX:
            raise ValueError(f"dtype must be complex64 or complex128, got {self.dtype!r}")
        if self.comm_precision not in ("f32", "bf16"):
            raise ValueError(
                f"comm_precision must be 'f32' or 'bf16', got {self.comm_precision!r}")
        if self.comm_precision == "bf16" and not self.use_pallas:
            raise ValueError(
                "comm_precision='bf16' requires the kernel (f32-planes) sharded "
                "bodies (use_pallas=True); the eager complex parity route keeps "
                "full-precision consensus")

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
    # A sharded run that replayed one captured sweep: the graph's figures
    # (parallel.graph.run_sweeps); None for every other run.
    replay: dict | None = None

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


def init_state(cfg: FPMConfig, geom: LEDGeometry, amps_sorted, dtype=torch.complex64,
               device="cuda"):
    """``(O centered spectrum, pupil, support)`` of a fresh solve on ``device``
    (the card unless ``device="cpu"``), for driving sweeps by hand: the
    options from ``cfg``, the pupil support, then :func:`init_traced` on
    ``amps_sorted`` (the (K, Np, Np) amplitudes in schedule order, an array
    or a tensor). The pupil is a tensor of its own; the support is complex,
    in ``dtype``. The counterpart of ``fpm_tpu.models.epry.init_state``
    (``geom`` is taken for its signature)."""
    dev = resolve_device(device)
    opts = EPRYOptions.from_config(cfg, dtype=_dtype_name(dtype))
    support_r = torch.as_tensor(pupil_support(cfg, centered=False), dtype=opts.rdtype,
                                device=dev)
    amps = torch.as_tensor(amps_sorted).to(dev, opts.rdtype)
    obj_f, pupil = init_traced(amps, support_r, opts)
    return obj_f, pupil, support_r.to(opts.cdtype)


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


def _kernel_options(opts: EPRYOptions) -> dict:
    """The options of ``opts`` that K1 and K2's wrappers share."""
    return dict(np_size=opts.np_size, n_large=opts.n_large, delta1=opts.delta1,
                delta2=opts.delta2, eps=opts.eps, pupil_radius=opts.pupil_radius,
                collect_metrics=opts.collect_metrics, dft_precision=opts.dft_precision)


def _kernel_operands(obj_f, pupil, support, starts):
    """Complex state, support and patch starts as the wrappers take them:
    float32 planes, the real support, flat int32 starts (which, like every
    operand, must lie on the state's device: the wrappers raise if not)."""
    starts = torch.as_tensor(starts).reshape(-1).to(torch.int32)
    return (_to_planes(obj_f), _to_planes(pupil), support.real.to(torch.float32), starts)


def sweep_pallas(obj_f, pupil, amps, starts, *, support, opts: EPRYOptions):
    """One sequential sweep of a complex state through kernel K2 (CUDA,
    ``ops.kernels.fused_epry_sweep``; on CPU tensors its plain version):
    :func:`sweep_sequential`'s function at ``opts.global_max``, with the
    products at ``opts.dft_precision`` and the pupil's bbox from
    ``opts.pupil_radius``. Returns the state in the inputs' dtypes and the
    sweep's (residual, update-norm) metrics (zeros unless
    ``opts.collect_metrics``) in ``amps``' dtype. A shape the kernel refuses
    raises its error. The counterpart of ``fpm_tpu.models.epry.sweep_pallas``."""
    o, p, sup, starts = _kernel_operands(obj_f, pupil, support, starts)
    o, p, mets = kernels.fused_epry_sweep(o, p, sup, amps.to(torch.float32), starts,
                                          global_max=opts.global_max, **_kernel_options(opts))
    return _from_planes(o, obj_f), _from_planes(p, pupil), mets.to(amps.dtype)


def led_intermediates(state, images, geom: LEDGeometry, cfg: FPMConfig, led_index: int,
                      dtype="complex64", device="cuda") -> dict[str, np.ndarray]:
    """The six working spectra of one LED update, for the debug dumps.

    The reference's debug mode opens windows of the working spectra at six
    points inside each LED update (fpmMain.cpp:366-375, 396-402, 421-425,
    435-441, 449-455). This replays the sequential sweep from ``state`` (the
    sweep-entry ``(obj_f_centered, pupil)``, complex arrays or (2, ...)
    planes, of either package) up to schedule position ``led_index``
    (0 = lowest NA) with the eager :func:`led_step`, on ``device``, and
    returns that LED's

      objf_crop   — sub-spectrum crop (fpmMain.cpp:358-362, shown :366-375)
      objf_crop_p — crop × pupil (fpmMain.cpp:364)
      obj_crop_p  — image-plane field (fpmMain.cpp:365, shown :396-402)
      objf_up     — amplitude-replaced spectrum (fpmMain.cpp:389-394)
      d_obj       — object-spectrum increment (fpmMain.cpp:404-419, :421-425)
      pupil       — pupil after this LED's EPRY update (:449-455)

    as complex NumPy arrays. The counterpart of
    ``fpm_tpu.models.epry.led_intermediates``.
    """
    dev = resolve_device(device)
    opts = EPRYOptions.from_config(cfg, dtype=_dtype_name(dtype), collect_metrics=False)
    amps, starts = _sorted_device_inputs(images, geom, opts.cdtype, dev)
    if not 0 <= led_index < amps.shape[0]:
        raise ValueError(f"led_index {led_index} outside schedule [0, {amps.shape[0]})")
    support = torch.as_tensor(pupil_support(cfg, centered=False), dtype=opts.rdtype,
                              device=dev).to(opts.cdtype)
    obj_f, pupil = state_from_numpy(*state, device=dev, dtype=opts.cdtype)
    starts = _host_starts(starts)
    omax0 = torch.max(torch.abs(obj_f))
    carry = (obj_f.clone(), pupil, omax0)
    for pos in range(led_index):
        carry, _ = led_step(carry, (amps[pos], starts[pos]), support=support, opts=opts)
    obj_f, pupil, _ = carry

    amp, start = amps[led_index], starts[led_index]
    objf_crop = fftshift2d(crop_patch(obj_f, start, opts.np_size))
    objf_crop_p = objf_crop * pupil
    obj_crop_p = ifft2(objf_crop_p)
    objf_up = fft2(_amp_replace(obj_crop_p, amp, opts.eps))
    diff = objf_up - objf_crop_p
    d_obj = _object_delta(diff, pupil, opts.delta2)
    paste_patch_add(obj_f, fftshift2d(d_obj), start)
    omax = torch.max(torch.abs(obj_f)) if opts.global_max == "exact" else omax0
    out = {"objf_crop": objf_crop, "objf_crop_p": objf_crop_p, "obj_crop_p": obj_crop_p,
           "objf_up": objf_up, "d_obj": d_obj,
           "pupil": pupil + _pupil_delta(diff, objf_crop, omax, support, opts.delta1)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def _to_planes(z):
    return torch.stack([z.real, z.imag]).to(torch.float32)


def _from_planes(planes, like):
    return torch.complex(planes[0], planes[1]).to(like.dtype)


# fpm_tpu's ceiling on the kernel route's chunk (fpm_tpu/ops/pallas_kernels.py
# _CHUNK_ROWS_LIMIT and max_pallas_chunk: stacked chunk rows C·round_up(Np, 8)
# at most 3328, a limit of its TPU compiler). The CUDA kernels have no such
# limit; the port reproduces it so that the same command runs the same chunk,
# and so the same trajectory and checkpoint fingerprint, in both packages.
_FPM_TPU_CHUNK_ROWS_LIMIT = 3328


def max_kernel_chunk(np_size: int) -> int:
    """fpm_tpu's ``max_pallas_chunk``: the largest chunk of LEDs its fused
    chunked kernel runs at patch size ``np_size`` (34 at Np 90, 16 at 200)."""
    return max(1, _FPM_TPU_CHUNK_ROWS_LIMIT // (-(-np_size // 8) * 8))


def effective_chunk_size(np_size: int, chunk_size: int, k: int,
                         use_pallas: bool, mode: str, n_led: int = 1) -> int:
    """The chunk size that will actually run (recorded in provenance), on
    every solver path: :func:`reconstruct`, the sharded sweeps of
    ``fpm_torch.parallel`` and the CLI's fingerprint all call it.
    ``fpm_tpu.models.epry.effective_chunk_size``'s value in every case.

    Sequential mode and the eager batched route on one device pass the
    request through. The kernel route clamps ``chunk or K`` to
    :func:`max_kernel_chunk` · ``n_led`` (and, on one device, to K). The
    LED-sharded sweep (``n_led`` > 1) then rounds it UP to a multiple of
    ``n_led`` so every rank gets an equal slice (padded with masked
    dummies), on both routes.
    """
    if mode != "batched":
        return chunk_size
    eff = chunk_size if chunk_size > 0 else k
    if use_pallas:
        cap = max_kernel_chunk(np_size) * n_led
        eff = min(eff, cap, k) if n_led == 1 else min(eff, cap)
    elif n_led == 1:
        return chunk_size
    if n_led > 1:
        eff = -(-eff // n_led) * n_led
    return eff


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


def chunk_permute(amps, starts, chunk_size: int, assign: str, real_dtype):
    """Pad and permute flat (K, ...) schedule arrays into (n_chunks, C, ...)
    chunks of ``chunk_size`` (0 = one whole-sweep chunk; :func:`chunk_schedule`),
    with the (n_chunks, C) mask of real LEDs."""
    k = amps.shape[0]
    perm, mask_np, n_chunks = chunk_schedule(k, chunk_size, assign)
    pad = perm.size - k
    if pad:
        amps = torch.cat([amps, amps.new_zeros((pad,) + tuple(amps.shape[1:]))])
        starts = torch.cat([starts, starts.new_zeros((pad, 2))])
    c = perm.size // n_chunks
    perm_t = torch.as_tensor(perm, device=amps.device)
    mask = torch.as_tensor(mask_np, dtype=real_dtype, device=amps.device)
    return (amps[perm_t].reshape(n_chunks, c, *amps.shape[1:]),
            starts[perm_t].reshape(n_chunks, c, 2), mask.reshape(n_chunks, c))


def _chunk_inputs(amps, starts, opts: EPRYOptions, real_dtype):
    """:func:`chunk_permute` at the single-device chunk size of ``opts``."""
    csize = effective_chunk_size(opts.np_size, opts.chunk_size, amps.shape[0],
                                 opts.use_pallas, "batched")
    return chunk_permute(amps, starts, csize, opts.chunk_assign, real_dtype)


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


def sweep_batched_pallas(obj_f, pupil, amps_it, starts_it, mask, *, support,
                         opts: EPRYOptions):
    """One chunked sweep of a complex state through kernel K1 (CUDA,
    ``ops.kernels.fused_epry_chunked``; on CPU tensors its plain version):
    :func:`sweep_batched`'s function on the pre-chunked (n_chunks, C, ...)
    ``amps_it``, ``starts_it`` and ``mask`` (:func:`chunk_permute`), with
    ``opts.pupil_step_scale``, the products at ``opts.dft_precision`` and the
    pupil's bbox from ``opts.pupil_radius``. Returns as :func:`sweep_pallas`.
    The counterpart of ``fpm_tpu.models.epry.sweep_batched_pallas``."""
    o, p, sup, starts = _kernel_operands(obj_f, pupil, support, starts_it)
    valid = (torch.as_tensor(mask) > 0).reshape(-1).to(torch.int32)
    o, p, mets = kernels.fused_epry_chunked(o, p, sup, amps_it.to(torch.float32), starts, valid,
                                            pupil_step_scale=opts.pupil_step_scale,
                                            **_kernel_options(opts))
    return _from_planes(o, obj_f), _from_planes(p, pupil), mets.to(amps_it.dtype)


# ----------------------------------------------------------------- top level


def _make_sweep_fn(amps, starts, support, support_r, opts: EPRYOptions):
    """Mode dispatch of the eager route; the batched mode's chunk permutation
    is applied once here, not every sweep. Returns
    ``sweep_once(obj_f, pupil) -> (obj_f, pupil, metrics)``."""
    if opts.mode == "batched":
        amps_it, starts_it, mask = _chunk_inputs(amps, starts, opts, support_r.dtype)

        def sweep_once(obj_f, pupil):
            return sweep_batched(obj_f, pupil, amps_it, starts_it, support=support, opts=opts,
                                 mask=mask)

        return sweep_once

    def sweep_once(obj_f, pupil):
        return sweep_sequential(obj_f, pupil, amps, starts, support=support, opts=opts)

    return sweep_once


def frames_on(images, device) -> torch.Tensor:
    """The frames on ``device`` with their values exact: integers of up to
    16 bits go in their own width (uint16 as the int16 of the same bits,
    widened back on the device), anything else as float64."""
    frames = np.asarray(images)
    if frames.dtype == np.uint16:
        return torch.from_numpy(frames.view(np.int16)).to(device).to(torch.int32) & 0xFFFF
    if frames.dtype in (np.bool_, np.uint8, np.int8, np.int16):
        return torch.from_numpy(frames).to(device)
    return torch.from_numpy(frames.astype(np.float64, copy=False)).to(device)


def _sorted_device_inputs(images, geom: LEDGeometry, dtype: torch.dtype, device):
    """Amplitudes and crop starts in schedule order, on ``device``.

    The amplitudes are ``np.sqrt`` of the frames in float64, cast to the
    solver's real type. For a card the frames go there as :func:`frames_on`
    puts them (or are there already: ``images`` may be a tensor on the card,
    as the ROI runner cuts its tiles from frames it uploaded once) and the
    square root is taken there: CUDA's float64 square root is correctly
    rounded, as NumPy's is, so the values are the same without a host pass
    over every frame. On the CPU NumPy takes it (torch's CPU square root is
    not correctly rounded)."""
    dev = torch.device(device)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    if dev.type == "cpu":
        frames = np.asarray(images, dtype=np.float64)
        amps = torch.from_numpy(np.sqrt(frames)[geom.schedule]).to(real)
    else:
        frames = images if isinstance(images, torch.Tensor) else frames_on(images, dev)
        sched = torch.as_tensor(geom.schedule, device=dev)
        amps = frames.to(dev)[sched].to(torch.float64).sqrt().to(real)
    starts = geom.crop_start[geom.schedule]
    return amps, torch.from_numpy(np.ascontiguousarray(starts, dtype=np.int32)).to(dev)


def _solver_setup(geom: LEDGeometry, cfg: FPMConfig, iterations, dtype, device,
                  opt_overrides) -> tuple[torch.device, EPRYOptions, torch.Tensor]:
    """The device, the options (with the chunk that will run) and the real
    pupil support of a solve: what :func:`reconstruct` and
    :func:`reconstruct_channels` share."""
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
    support_r = torch.as_tensor(pupil_support(cfg, centered=False), dtype=opts.rdtype,
                                device=dev)
    return dev, opts, support_r


def _initial(amps, support_r, opts: EPRYOptions, state):
    """The fresh init of :func:`init_traced`, or ``state`` on the solve's device."""
    if state is None:
        return init_traced(amps, support_r, opts)
    return state_from_numpy(*state, device=amps.device, dtype=opts.cdtype)


def _result(obj_f, pupil, per_sweep) -> ReconResult:
    """A :class:`ReconResult` from the final state and the per-sweep metrics.
    Only the final inverse transform of the full spectrum is observable
    (fpmMain.cpp:481 computes one per iteration)."""
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
    state = None if initial_state is None else ([initial_state[0]], [initial_state[1]])
    return reconstruct_channels([images], geom, cfg, iterations=iterations, dtype=dtype,
                                initial_state=state, device=device, **opt_overrides)[0]


def _reconstruct_eager(images, state, geom: LEDGeometry, dev, opts: EPRYOptions,
                       support_r) -> ReconResult:
    """One problem through the eager sweeps (on the CPU)."""
    amps, starts = _sorted_device_inputs(images, geom, opts.cdtype, dev)
    obj_f, pupil = _initial(amps, support_r, opts, state)
    sweep_once = _make_sweep_fn(amps, starts, support_r.to(opts.cdtype), support_r, opts)
    per_sweep = []
    for _ in range(opts.iterations):
        obj_f, pupil, m = sweep_once(obj_f, pupil)
        per_sweep.append(m)
    return _result(obj_f, pupil, per_sweep)


def _problems_kernel_call(amps_b, starts, support_r, opts: EPRYOptions):
    """The call that sweeps P same-geometry problems through the kernels:
    ``(wrapper, operands, options)``, the sweep being ``wrapper(o_planes,
    p_planes, *operands, **options)``, ONE call of K1 or K2 with a problem
    axis (``ops.kernels``; on the CPU their plain versions). ``amps_b`` (P,
    K, Np, Np)."""
    common = dict(np_size=opts.np_size, n_large=opts.n_large, delta1=opts.delta1,
                  delta2=opts.delta2, eps=opts.eps, pupil_radius=opts.pupil_radius,
                  collect_metrics=opts.collect_metrics, dft_precision=opts.dft_precision)
    support = support_r.to(torch.float32)
    if opts.mode == "batched":
        chunked = [_chunk_inputs(a, starts, opts, support_r.dtype) for a in amps_b]
        amps_it = torch.stack([c[0] for c in chunked]).to(torch.float32)
        starts_flat = chunked[0][1].reshape(-1).to(torch.int32)
        valid = (chunked[0][2] > 0).reshape(-1).to(torch.int32)
        del chunked
        return (kernels.fused_epry_chunked, (support, amps_it, starts_flat, valid),
                dict(common, pupil_step_scale=opts.pupil_step_scale))
    return (kernels.fused_epry_sweep,
            (support, amps_b.to(torch.float32), starts.reshape(-1).to(torch.int32)),
            dict(common, global_max=opts.global_max))


def _make_problems_sweep_fn(amps_b, starts, support_r, opts: EPRYOptions):
    """One sweep of P same-geometry problems through the kernels
    (:func:`_problems_kernel_call`): ``sweep_once(o_planes, p_planes) ->
    (o_planes, p_planes, mets)`` on (P, 2, ...) float32 planes, with (P, 2)
    metrics."""
    wrapper, operands, options = _problems_kernel_call(amps_b, starts, support_r, opts)

    def sweep_once(o, p):
        return wrapper(o, p, *operands, **options)
    return sweep_once


def reconstruct_channels(
    channel_images,
    geom: LEDGeometry,
    cfg: FPMConfig,
    iterations: int | None = None,
    dtype: Any | None = None,
    initial_state: tuple | None = None,
    device: Any = "cuda",
    **opt_overrides,
) -> list[ReconResult]:
    """Reconstruct N independent same-geometry problems: the RGB channels
    (``--color-mode rgb``), or the ROI tiles of a large field of view
    (``fpm_torch.parallel.roi_shard``); :func:`reconstruct` is one problem.
    The counterpart of ``fpm_tpu.models.epry.reconstruct_channels``.

    The problems share the LED schedule, crop geometry and pupil support. On
    the kernel route (``use_pallas=True``; the only one on a CUDA device)
    every sweep of all N problems is ONE call of K1 or K2 with a problem
    axis, which on the card is one launch sequence and on the CPU the plain
    versions one problem after another (as ``lax.map`` runs them in the JAX
    package); the init and the final inverse transform run per problem. So
    problem i's result is bitwise that of problem i solved alone. The eager
    route solves the problems one after another.

    Args:
      channel_images: sequence of N (K, Np, Np) intensity stacks, each
        ordered by ``geom.led_numbers`` (on a card they may be tensors there).
      initial_state: optional ``(obj_f_centered, pupil)`` with a leading N
        axis — stacked checkpoint state for resume.
      device, **opt_overrides: as :func:`reconstruct`.

    Returns one :class:`ReconResult` per problem, in input order.
    """
    n_prob = len(channel_images)
    states = ([None] * n_prob if initial_state is None
              else [(initial_state[0][i], initial_state[1][i]) for i in range(n_prob)])
    dev, opts, support_r = _solver_setup(geom, cfg, iterations, dtype, device, opt_overrides)
    if not opts.use_pallas:
        return [_reconstruct_eager(images, state, geom, dev, opts, support_r)
                for images, state in zip(channel_images, states)]
    per_problem = [_sorted_device_inputs(images, geom, opts.cdtype, dev)
                   for images in channel_images]
    starts = per_problem[0][1]
    amps_b = torch.stack([amps for amps, _ in per_problem])
    del per_problem
    inits = [_initial(amps_b[i], support_r, opts, states[i]) for i in range(n_prob)]
    o_planes = torch.stack([_to_planes(o) for o, _ in inits])
    p_planes = torch.stack([_to_planes(p) for _, p in inits])
    like = inits[0]
    del inits
    sweep_once = _make_problems_sweep_fn(amps_b, starts, support_r, opts)
    per_sweep = []
    for _ in range(opts.iterations):
        o_planes, p_planes, m = sweep_once(o_planes, p_planes)
        per_sweep.append(m.to(amps_b.dtype))
    return [_result(_from_planes(o_planes[i], like[0]), _from_planes(p_planes[i], like[1]),
                    [m[i] for m in per_sweep])
            for i in range(n_prob)]
