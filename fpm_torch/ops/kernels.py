"""The fused EPRY kernels K1, K2 and K3, each beside its plain version.

* K1 :func:`fused_epry_chunked` — one chunked Gauss–Seidel-over-Jacobi
  sweep (the ``--mode batched`` path). Replaces
  ``fpm_tpu/ops/pallas_kernels.py:fused_epry_chunked``; CUDA source
  ``csrc/epry_chunked.cu``.
* K2 :func:`fused_epry_sweep` — one exact sequential sweep (the
  ``--mode sequential`` path). Replaces
  ``fpm_tpu/ops/pallas_kernels.py:fused_epry_sweep``; CUDA source
  ``csrc/epry_sweep.cu``.
* K3 :func:`fused_chunk_increments` — one chunk's local increments with
  nothing applied, on any (R, Ncols) block of the spectrum (the per-rank body
  of the sharded sweeps, ``fpm_torch.parallel``). Replaces
  ``fpm_tpu/ops/pallas_kernels.py:fused_chunk_increments``; CUDA source
  ``csrc/epry_increments.cu``. The sharded sweeps call it through
  :func:`chunk_increments_into`, on operands they keep in the kernel's form
  for the whole run, on the stream they give.

All take and return the JAX package's operands: the centered object
spectrum as (2, NL, NL) float32 (re, im) planes (K3: any (2, R, Ncols)
block of it), the pupil as (2, Np, Np) planes in the DC-at-corner frame, the
support as (Np, Np) float32. K1 and K2 return ``(o_planes, p_planes, mets)``
with ``mets`` the per-sweep (data-residual, update-norm) sums (zeros unless
``collect_metrics``); K3 returns ``(d_planes, v_planes, mets)``.

K1 and K2 also take a leading **problem axis**: P independent problems of
one geometry (RGB channels, the ROI tiles of a large field of view) as
``o_planes`` (P, 2, NL, NL), ``p_planes`` (P, 2, Np, Np) and ``amps`` (P,
...), with the support, starts and valid flags shared; they return (P, ...)
planes and (P, 2) metrics. On the card that is ONE launch sequence for all
P problems (K2: 2 launches per sweep, K1: 3 per chunk), and problem q's
result is bitwise that of problem q solved alone, at every P and cluster
size; the plain versions loop over the problems.
Around the kernel, plain PyTorch rolls the pupil and support to the
centered frame and crops them to the NA disk's bounding box, and undoes
that afterwards (so the pupil, and K3's numerator, is exactly zero outside
the box).

Precision tiers (``dft_precision``, as in the JAX signatures): ``"bf16x3"``,
the default, forms each DFT product from the bf16 (hi, lo) split of both
operands as hi·hi + (hi·lo + lo·hi) in float32 (:func:`cmm_bf16x3`; on the
card on the tensor cores); ``"highest"`` in full FP32. Any other value
raises.

Ablations (``ablate``, K1 and K2, as in the JAX signatures): a measurement
aid that turns one stage of the kernel off so that a benchmark can time
what the stage costs (``fpm_torch.bench --ablate``; ``benchmarks/ablate.py``
in the JAX package). ``""``, the default and the only value the solver
passes, is the kernel itself; any other name of :data:`SWEEP_ABLATIONS` or
:data:`CHUNKED_ABLATIONS` gives a result that is garbage by design, the same
garbage as ``fpm_tpu``'s: the plain versions compute its semantics, and on
the card the ablated kernel comes from a separate build of the source
(``build.ablation_library``), where the variant is a template argument, so
that the main path's kernels are compiled as if no variant existed. A
variant runs at every shape the kernel takes: its entry point plans it as
the kernel's own (Z whole in every block, or cut by rows where Z whole fits
no block, as at b = n = 200) and takes ``force_z_layout`` as the kernel
does, with the same result either way. Any other name raises.

Dispatch: a wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version (``*_plain``, same function, same operands) for CPU
tensors; nothing falls back, and a tier runs as asked or raises. Each
wrapper adds to ``<wrapper>.launches`` the launches its C entry point
counted, one per kernel launch accepted, and leaves in ``<wrapper>.plan``
the plan that entry point chose (:data:`PLAN_FIELDS`: cluster size, slabs,
staged matrices, frame buffers, shared memory, the layout of Z) and in
``<wrapper>.cluster_size`` its cluster size. ``<wrapper>.force_cluster_size``
(tests only; 0 = let the entry point choose) makes it take 1, 2, 4 or 8
blocks per LED, or raise; ``<wrapper>.force_z_layout`` (tests only; 0 =
choose: Z whole in every block where that fits) takes Z whole (1) or cut by
rows across the cluster (2), or raises.

What bounds the kernels on an H100, and what the design does about it: see
``csrc/epry_common.cuh`` (the operations of four small complex DFT
products per LED, FP32 FMAs or bf16 tensor-core products by tier; one LED
runs on a thread-block cluster, each block holding a slab of the image
plane's rows in its shared memory, so the kernels need a card of compute
capability 9.0).
"""

from __future__ import annotations

import ctypes
import functools
import threading

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


# The precision tiers and the C entry points' number for each (Tier in
# csrc/epry_common.cuh).
_TIERS = {"highest": 0, "bf16x3": 1}


# The stages an ablation turns off, and the C entry points' number for each
# (Ablate in csrc/epry_common.cuh). K2 and K1 take the names of fpm_tpu's
# fused_epry_sweep and fused_epry_chunked, in benchmarks/ablate.py's order:
#   omax-const       max|O| is 1 + (the LED index in K2, the chunk index in
#                    K1): no max reduction over the spectrum
#   no-dft           no DFT products: the bbox patch Oc∘P, zero-padded to
#                    the image plane, is the image; up is the replaced
#                    image's [0:b, 0:b] corner
#   no-window-read   every LED reads the window at the spectrum's corner
#                    O[0:b, 0:b] in place of its own (the update still goes
#                    to its window)
#   no-window-write  no object update (the increments are still computed)
#   no-pupil-acc     (K1) no pupil numerator and no consensus: P stays
#   dft-1pass        each DFT product as one bf16 pass, hi·hi, at either tier
_ABLATE_IDS = {"": 0, "no-dft": 1, "no-window-read": 2, "no-window-write": 3,
               "omax-const": 4, "no-pupil-acc": 5, "dft-1pass": 6}
SWEEP_ABLATIONS = ("", "omax-const", "no-dft", "no-window-read", "no-window-write",
                   "dft-1pass")
CHUNKED_ABLATIONS = ("", "no-dft", "no-window-read", "no-window-write", "omax-const",
                     "no-pupil-acc", "dft-1pass")


def _check_ablate(ablate, names, kernel):
    if ablate not in names:
        raise ValueError(f"{kernel} has no ablation {ablate!r}; it takes {names}")


def _check_dft_precision(dft_precision):
    if dft_precision not in _TIERS:
        raise ValueError(
            f"dft_precision must be 'bf16x3' or 'highest', got {dft_precision!r}")


def bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 → (hi, lo) bfloat16 with hi = RN(x), lo = RN(x − hi), both
    rounded to nearest even: ``fpm_tpu.ops.pallas_kernels._bf16_split``."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def _csplit(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """complex64 → (hi, lo) complex64 whose parts are bf16 values: the real
    and imaginary parts split apart (:func:`bf16_split`)."""
    (rh, rl), (ih, il) = bf16_split(z.real), bf16_split(z.imag)
    return (torch.complex(rh.to(torch.float32), ih.to(torch.float32)),
            torch.complex(rl.to(torch.float32), il.to(torch.float32)))


def cmm_hi_hi(a, b):
    """A·B with one bf16 pass, hi·hi (``fpm_tpu``'s ``_mm_fns`` under
    ``ablate="dft-1pass"``, at either tier: a float32 matrix cast to bf16 is
    its hi part): operands as :func:`cmm_bf16x3` takes them."""
    return (a if isinstance(a, tuple) else _csplit(a))[0] @ (b if isinstance(b, tuple)
                                                             else _csplit(b))[0]


def cmm_bf16x3(a, b):
    """A·B as the bf16x3 tier forms it (``fpm_tpu``'s ``_mm_fns("bf16x3")``):
    each operand as its (hi, lo) split — a static DFT matrix comes split, as
    a pair; a tensor is split here (:func:`_csplit`) — and hi·hi + (hi·lo +
    lo·hi) summed in float32, lo·lo dropped. A product of two bf16 values is
    exact in float32, so only the order of the sums differs from the JAX
    package and from the tensor-core kernels."""
    ah, al = a if isinstance(a, tuple) else _csplit(a)
    bh, bl = b if isinstance(b, tuple) else _csplit(b)
    return ah @ bh + (ah @ bl + al @ bh)


@functools.lru_cache(maxsize=16)
def _block_dft_mats(n: int, b: int, lo: int, dft_precision: str = "highest"):
    """The shift-folded, bbox-selected DFT matrices (Ai, Bi, Af, Bf).

    For even n the half-roll permutation S satisfies S = Sᵀ = S⁻¹, so
      ifft2(ifftshift(X))  = (F⁻¹S) X (SF⁻¹)     — centered input
      fftshift(fft2(y))    = (SF) y (FS)         — centered output
    and with the bbox ``sel = lo:lo+b`` (the pupil is zero outside it)
      Ai = (F⁻¹S)[:, sel] (n, b)    Bi = (SF⁻¹)[sel, :] (b, n)
      Af = (SF)[sel, :]   (b, n)    Bf = (FS)[:, sel]   (n, b)
    Built in float64, returned as contiguous complex64 arrays; for
    ``'bf16x3'`` each as its (hi, lo) split (:func:`_csplit`), the numbers of
    the ``[[Re, −Im], [Im, Re]]`` blocks of ``fpm_tpu``'s
    ``_block_dft_mats(n, b, lo, "bf16x3")``.
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
    mats = tuple(np.ascontiguousarray(m.astype(np.complex64)) for m in mats)
    if dft_precision == "highest":
        return mats
    return tuple(tuple(t.numpy() for t in _csplit(torch.from_numpy(m))) for m in mats)


@functools.lru_cache(maxsize=16)
def _dft_mats(n: int, b: int, lo: int, device: torch.device, dft_precision: str = "highest"):
    """:func:`_block_dft_mats` as tensors on ``device`` (the plain versions')."""
    mats = _block_dft_mats(n, b, lo, dft_precision)
    if dft_precision == "highest":
        return tuple(torch.from_numpy(m).to(device) for m in mats)
    return tuple(tuple(torch.from_numpy(h).to(device) for h in pair) for pair in mats)


def split_layout(m: np.ndarray) -> np.ndarray:
    """The bf16x3 kernels' layout of a static complex matrix whose
    contraction runs along its rows (``csrc/epry_common.cuh`` cgemm_tc):
    (rows, ceil(K/2), 4) int32, for each row and pair (2i, 2i+1) of
    contraction indices the bf16x2 words re hi, re lo, im hi, im lo, index 2i
    in the low half; an odd K is padded with a zero."""
    rows, k = m.shape
    words = []
    for part in (m.real, m.imag):
        x = np.zeros((rows, k + (k & 1)), np.float32)
        x[:, :k] = part
        for half in bf16_split(torch.from_numpy(x)):
            bits = half.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
            words.append(bits[:, 0::2] | (bits[:, 1::2] << 16))
    return np.ascontiguousarray(np.stack(words, axis=-1).view(np.int32))


@functools.lru_cache(maxsize=16)
def _kernel_mats(n: int, b: int, lo: int, device: torch.device, dft_precision: str):
    """The DFT matrices as the C entry points take them: ``'highest'``
    complex64 Ai, Bi, Af, Bf; ``'bf16x3'`` the :func:`split_layout` of Ai,
    Biᵀ, Af, Bfᵀ (every contraction along the rows)."""
    if dft_precision == "highest":
        return _dft_mats(n, b, lo, device)
    ai, bi, af, bf = _block_dft_mats(n, b, lo)
    return tuple(torch.from_numpy(split_layout(m)).to(device) for m in (ai, bi.T, af, bf.T))


def _pupil_to_bbox(p_planes, support, n: int, b: int, lo: int):
    """Pupil planes (..., 2, n, n) and support, corner frame → centered bbox
    (contiguous)."""
    half = n // 2
    sel = slice(lo, lo + b)
    pc = torch.roll(p_planes, (half, half), dims=(-2, -1))[..., sel, sel].contiguous()
    sc = torch.roll(support, (half, half), dims=(0, 1))[sel, sel].contiguous()
    return pc, sc


def _pupil_from_bbox(pc, n: int, lo: int):
    """Centered bbox pupil planes (..., 2, b, b) → full (..., 2, n, n)
    corner-frame planes."""
    b = pc.shape[-1]
    full = pc.new_zeros(tuple(pc.shape[:-2]) + (n, n))
    full[..., lo:lo + b, lo:lo + b] = pc
    return torch.roll(full, (-(n // 2), -(n // 2)), dims=(-2, -1))


# ------------------------------------------------------------ plain versions
#
# The same arithmetic as the CUDA kernels, per LED, in complex64 tensor ops,
# on the kernels' own operands: o (2, NL, NL) planes, pc (2, b, b) centered
# bbox pupil planes, sc (b, b) support, amps, int32 starts (and valid).


def _windows(starts, n: int, shape, b: int, lo: int):
    """The (rows, cols) slices of each LED's b×b window in a spectrum block
    of ``shape`` (rows, cols): the patch start clamped as the kernels and
    JAX's crop clamp it, plus lo."""
    def one(s, dim):
        s = clamp_start(s, dim, n) + lo
        return slice(s, s + b)
    return [(one(y, shape[-2]), one(x, shape[-1])) for y, x in starts.view(-1, 2).tolist()]


def _complex(planes):
    return torch.complex(planes[0], planes[1])


def _planes(z):
    return torch.stack([z.real, z.imag]).contiguous()


def _sqrt(x):
    """The float32 square root rounded correctly, as CUDA's ``sqrtf`` and
    NumPy's are: taken in float64 and rounded back. torch's float32 square
    root on the CPU goes through MKL's vector library, which is not
    correctly rounded (1 ulp off on ~1 % of values) and, on its first call
    in a process, has been seen to return values ~1e-4 off on some of its
    threads, so that one process's results differed from another's."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _forward(oc, p, amp, mats, eps, dft_precision, ablate=""):
    """(img, up) of the LED(s) with window(s) ``oc`` — see led_forward."""
    ai, bi, af, bf = mats
    mm = (cmm_hi_hi if ablate == "dft-1pass" else
          cmm_bf16x3 if dft_precision == "bf16x3" else torch.matmul)
    if ablate == "no-dft":
        n, b = amp.shape[-1], oc.shape[-1]
        img = torch.nn.functional.pad(oc * p, (0, n - b, 0, n - b))
    else:
        img = mm(mm(ai, oc * p), bi)
    rep = img * (amp / _sqrt((img.real + eps) ** 2 + (img.imag + eps) ** 2))
    if ablate == "no-dft":
        return img, rep[..., :b, :b]
    return img, mm(mm(af, rep), bf)


def _omax_const(k: int, like):
    """max|O| under ``ablate="omax-const"``: 1 + k in float32."""
    return torch.full((), 1.0 + k, dtype=torch.float32, device=like.device)


def slab_bounds(n: int, cs: int) -> list[tuple[int, int]]:
    """The [start, stop) rows of the ``cs`` slabs that a cluster of ``cs``
    blocks cuts ``n`` rows into (``carve_smem`` in csrc/epry_common.cuh
    follows the same rule): ceil(n/cs) rows each, the last may be short, or
    empty."""
    per = -(-n // cs)
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(cs)]


def _object_weight(p, delta2):
    """|P|·conj(P) / (max|P| · (|P|² + delta2))."""
    pabs2 = p.real * p.real + p.imag * p.imag
    pmax = _sqrt(pabs2.max())
    return _sqrt(pabs2) * p.conj() / (pmax * (pabs2 + delta2))


def _pupil_weight(oc, sup, delta1):
    """|Oc|·conj(Oc) · support / (|Oc|² + delta1) — the 1/max|O| comes later."""
    oabs2 = oc.real * oc.real + oc.imag * oc.imag
    return _sqrt(oabs2) * oc.conj() * (sup / (oabs2 + delta1))


def _abs_max(o):
    return _sqrt((o.real * o.real + o.imag * o.imag).max())


def _sq_sum(z, dims):
    return (z.real * z.real + z.imag * z.imag).sum(dims)


def _sweep_core_plain(o, pc, sc, amps, starts, *, lo, eps, delta1, delta2,
                      global_max, collect_metrics, dft_precision, ablate=""):
    n, b = amps.shape[-1], pc.shape[-1]
    mats = _dft_mats(n, b, lo, o.device, dft_precision)
    obj, pup = _complex(o), _complex(pc)
    mets = torch.zeros(2, dtype=torch.float32, device=o.device)
    omax_lazy = _abs_max(obj)
    for k, win in enumerate(_windows(starts, n, o.shape, b, lo)):
        oc = (obj[:b, :b] if ablate == "no-window-read" else obj[win]).clone()
        img, up = _forward(oc, pup, amps[k], mats, eps, dft_precision, ablate)
        diff = up - oc * pup
        d_obj = diff * _object_weight(pup, delta2)
        if ablate != "no-window-write":
            obj[win] += d_obj
        if ablate == "omax-const":
            omax = _omax_const(k, obj)
        else:
            omax = _abs_max(obj) if global_max == "exact" else omax_lazy
        pup = pup + diff * _pupil_weight(oc, sc, delta1) * (1.0 / omax)
        if collect_metrics:
            mets += torch.stack([((amps[k] - img.abs()) ** 2).sum(), _sq_sum(d_obj, (0, 1))])
    return _planes(obj), _planes(pup), mets


def _chunked_core_plain(o, pc, sc, amps, starts, valid, *, lo, eps, delta1, delta2,
                        pupil_step_scale, collect_metrics, dft_precision, ablate=""):
    n_chunks, c, n = amps.shape[0], amps.shape[1], amps.shape[-1]
    b = pc.shape[-1]
    mats = _dft_mats(n, b, lo, o.device, dft_precision)
    obj, pup = _complex(o), _complex(pc)
    mets = torch.zeros(2, dtype=torch.float32, device=o.device)
    windows = _windows(starts, n, o.shape, b, lo)
    valid_l = valid.view(n_chunks, c).tolist()
    for k in range(n_chunks):
        live = [j for j in range(c) if valid_l[k][j]]     # masked dummies skipped
        if not live:
            continue
        wins = [windows[k * c + j] for j in live]
        reads = [(slice(0, b),) * 2] * len(wins) if ablate == "no-window-read" else wins
        oc = torch.stack([obj[w] for w in reads])          # chunk-start crops
        amp = amps[k, live]
        img, up = _forward(oc, pup, amp, mats, eps, dft_precision, ablate)
        diff = up - oc * pup
        d_obj = diff * _object_weight(pup, delta2)
        if ablate != "no-window-write":
            for w, d in zip(wins, d_obj):
                obj[w] += d
        omax = _omax_const(k, obj) if ablate == "omax-const" else _abs_max(obj)
        if ablate == "no-pupil-acc":     # no numerator; the data dependence kept, as fpm_tpu's
            num_sum = torch.complex(0.0 * diff[0].real, torch.zeros_like(diff[0].real))
        else:
            num_sum = (diff * _pupil_weight(oc, sc, delta1)).sum(0)
        pup = pup + pupil_step_scale * (num_sum * (1.0 / omax))
        if collect_metrics:
            mets += torch.stack([((amp - img.abs()) ** 2).sum(), _sq_sum(d_obj, (0, 1, 2))])
    return _planes(obj), _planes(pup), mets


def _per_problem(core):
    """A single-problem plain core over a leading problem axis: the problems
    one after another, the shared operands (support, starts, valid) given to
    each."""
    def run(o, pc, sc, amps, *shared, **kw):
        outs = [core(o[q], pc[q], sc, amps[q], *shared, **kw) for q in range(o.shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return run


def _increments_core_plain(o, pc, sc, amps, starts, valid, *, lo, eps, delta1, delta2,
                           collect_metrics, dft_precision):
    n, b = amps.shape[-1], pc.shape[-1]
    obj, pup = _complex(o), _complex(pc)
    d = torch.zeros_like(obj)
    v = torch.zeros_like(pup)
    mets = torch.zeros(2, dtype=torch.float32, device=o.device)
    windows = _windows(starts, n, o.shape, b, lo)
    live = [j for j, ok in enumerate(valid.tolist()) if ok]   # masked dummies skipped
    if live:
        wins = [windows[j] for j in live]
        oc = torch.stack([obj[w] for w in wins])
        amp = amps[live]
        img, up = _forward(oc, pup, amp, _dft_mats(n, b, lo, o.device, dft_precision), eps,
                           dft_precision)
        diff = up - oc * pup
        d_obj = diff * _object_weight(pup, delta2)
        for w, dj in zip(wins, d_obj):
            d[w] += dj
        v = (diff * _pupil_weight(oc, sc, delta1)).sum(0)
        if collect_metrics:
            mets = torch.stack([((amp - img.abs()) ** 2).sum(), _sq_sum(d_obj, (0, 1, 2))])
    return _planes(d), _planes(v), mets


# ---------------------------------------------------------------- CUDA route

# The launch counters may be added to from several threads (the ROI runner
# drives one thread per card).
_counter_lock = threading.Lock()


# The fields of the plan an entry point hands back (LedPlan and export_plan
# in csrc/epry_common.cuh): blocks per LED, image rows and bbox rows per
# block, the staged DFT matrices (bits Bi 1, Bf 2, Ai 4, Af 8), K2's frame
# buffers, the bytes of dynamic shared memory per block, and whether Z is
# cut by rows across the cluster (1) or whole in every block (0).
PLAN_FIELDS = ("cs", "nr", "br", "stage", "frames", "smem", "zcut")


def _plan_out():
    return (ctypes.c_int * len(PLAN_FIELDS))()


def _record(wrapper, launched: ctypes.c_int, plan) -> None:
    """Add an entry point's counted launches to ``wrapper.launches`` and
    keep the plan it chose (``wrapper.plan``, and its cluster size)."""
    with _counter_lock:
        wrapper.launches += launched.value
        wrapper.plan = dict(zip(PLAN_FIELDS, plan))
        wrapper.cluster_size = wrapper.plan["cs"]


def _check_cuda_operands(o, pc, sc, amps, starts, *, n_slots, valid=None, square=True):
    """Raise on anything the kernels do not take: device, dtype and shapes
    (``square``: the spectrum is the whole NL×NL one, not a block of it).
    (Patch starts need no check: the kernels clamp them. An Np too large for
    a block's shared memory at every cluster size is refused by the kernels'
    entry points.)"""
    dev, n, b = o.device, amps.shape[-1], pc.shape[-1]
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
    if (o.ndim != 3 or o.shape[0] != 2 or min(o.shape[1:]) < n
            or (square and o.shape[1] != o.shape[2])
            or pc.shape != (2, b, b) or sc.shape != (b, b)
            or amps.shape[-2] != n or amps.numel() != n_slots * n * n
            or starts.numel() != 2 * n_slots
            or (valid is not None and valid.numel() != n_slots)):
        raise ValueError(
            f"operand shapes do not fit together: o {tuple(o.shape)}, pupil "
            f"{tuple(pc.shape)}, support {tuple(sc.shape)}, amps {tuple(amps.shape)}, "
            f"starts {tuple(starts.shape)}")


def _check_problem_axis(o, pc, amps, **check):
    """The checks of :func:`_check_cuda_operands` on problem 0, and one
    problem count on the three per-problem operands."""
    if o.ndim != 4 or pc.ndim != 4 or amps.shape[0] != o.shape[0] or pc.shape[0] != o.shape[0]:
        raise ValueError(f"the problem axis does not fit together: o {tuple(o.shape)}, "
                         f"pupil {tuple(pc.shape)}, amps {tuple(amps.shape)}")
    _check_cuda_operands(o[0], pc[0], check.pop("sc"), amps[0], check.pop("starts"), **check)


def _ablation_entry(wrapper, stem, entry, ablate, dft_precision):
    """(library, entry point, the arguments after the tier, tier) of one K1
    or K2 launch: the main build's ``entry`` for the kernel itself;
    the ablation build's ``entry + "_ablate"`` for a variant, or for ``""``
    when the wrapper's test-only ``force_ablation_build`` asks for it.
    dft-1pass runs the bf16x3 instantiation at either tier (a float32
    matrix in bf16 is its bf16x3 hi part). Either entry point takes the
    wrapper's ``force_cluster_size`` and ``force_z_layout`` (the caller
    passes them after the arguments returned here)."""
    if not ablate and not wrapper.force_ablation_build:
        lib = build.library(stem)
        return lib, getattr(lib, entry), (), dft_precision
    lib = build.ablation_library(stem)
    tier = "bf16x3" if ablate == "dft-1pass" else dft_precision
    return lib, getattr(lib, entry + "_ablate"), (_ABLATE_IDS[ablate],), tier


def _sweep_cuda(o, pc, sc, amps, starts, *, lo, eps, delta1, delta2, global_max,
                collect_metrics, dft_precision, ablate="", lib=None):
    """K2 on P problems: ``o`` (P, 2, NL, NL), ``pc`` (P, 2, b, b), ``amps``
    (P, K, n, n). ``lib``: another build of csrc/epry_sweep.cu than the one
    ``build.library`` hands out (:func:`k2_phase_profile` passes its own)."""
    n_prob, k, n = amps.shape[0], amps.shape[1], amps.shape[-1]
    b, nl = pc.shape[-1], o.shape[-1]
    _check_problem_axis(o, pc, amps, sc=sc, starts=starts, n_slots=k)
    if lib is None:
        lib, entry, extra, dft_precision = _ablation_entry(
            fused_epry_sweep, "epry_sweep", "fpm_k2_sweep", ablate, dft_precision)
    else:
        entry, extra = lib.fpm_k2_sweep, ()
    o, pc = o.contiguous().clone(), pc.contiguous().clone()
    sc, amps, starts = sc.contiguous(), amps.contiguous(), starts.contiguous()
    mats = _kernel_mats(n, b, lo, o.device, dft_precision)
    rowmax = torch.empty((n_prob, nl), dtype=torch.float32, device=o.device)
    mets = torch.zeros((n_prob, 2), dtype=torch.float32, device=o.device)
    launched, plan = ctypes.c_int(0), _plan_out()
    err = entry(
        o.data_ptr(), pc.data_ptr(), sc.data_ptr(), amps.data_ptr(), starts.data_ptr(),
        *(m.data_ptr() for m in mats), rowmax.data_ptr(), mets.data_ptr(),
        n_prob, k, n, b, lo, nl, eps, delta1, delta2,
        int(global_max == "exact"), int(collect_metrics), _TIERS[dft_precision], *extra,
        o.device.index, torch.cuda.current_stream(o.device).cuda_stream,
        fused_epry_sweep.force_cluster_size, fused_epry_sweep.force_z_layout,
        ctypes.byref(launched), plan)
    _record(fused_epry_sweep, launched, plan)
    build.check(lib, err, "K2 fused_epry_sweep")
    return o, pc, mets


def _chunked_cuda(o, pc, sc, amps, starts, valid, *, lo, eps, delta1, delta2,
                  pupil_step_scale, collect_metrics, dft_precision, ablate=""):
    """K1 on P problems: ``o`` (P, 2, NL, NL), ``pc`` (P, 2, b, b), ``amps``
    (P, n_chunks, C, n, n)."""
    n_prob, n_chunks, c, n = amps.shape[0], amps.shape[1], amps.shape[2], amps.shape[-1]
    b, nl = pc.shape[-1], o.shape[-1]
    _check_problem_axis(o, pc, amps, sc=sc, starts=starts, n_slots=n_chunks * c, valid=valid)
    lib, entry, extra, dft_precision = _ablation_entry(
        fused_epry_chunked, "epry_chunked", "fpm_k1_sweep", ablate, dft_precision)
    o, pc = o.contiguous().clone(), pc.contiguous().clone()
    sc, amps = sc.contiguous(), amps.contiguous()
    starts, valid = starts.contiguous(), valid.contiguous()
    dev = o.device
    mats = _kernel_mats(n, b, lo, dev, dft_precision)
    d_obj = torch.empty((n_prob, c, b, b, 2), dtype=torch.float32, device=dev)
    num = torch.empty((n_prob, c, b, b, 2), dtype=torch.float32, device=dev)
    parts = torch.empty((n_prob, c, 2), dtype=torch.float32, device=dev)
    omax_bits = torch.zeros((n_prob, n_chunks), dtype=torch.int32, device=dev)
    mets = torch.zeros((n_prob, 2), dtype=torch.float32, device=dev)
    launched, plan = ctypes.c_int(0), _plan_out()
    err = entry(
        o.data_ptr(), pc.data_ptr(), sc.data_ptr(), amps.data_ptr(), starts.data_ptr(),
        valid.data_ptr(), *(m.data_ptr() for m in mats), d_obj.data_ptr(),
        num.data_ptr(), parts.data_ptr(), omax_bits.data_ptr(), mets.data_ptr(),
        n_prob, n_chunks, c, n, b, lo, nl, eps, delta1, delta2, pupil_step_scale,
        int(collect_metrics), _TIERS[dft_precision], *extra, dev.index,
        torch.cuda.current_stream(dev).cuda_stream, fused_epry_chunked.force_cluster_size,
        fused_epry_chunked.force_z_layout, ctypes.byref(launched), plan)
    _record(fused_epry_chunked, launched, plan)
    build.check(lib, err, "K1 fused_epry_chunked")
    return o, pc, mets


def _increments_cuda(o, pc, sc, amps, starts, valid, *, lo, eps, delta1, delta2,
                     collect_metrics, dft_precision):
    c, b = amps.shape[0], pc.shape[-1]
    _check_cuda_operands(o, pc, sc, amps, starts, n_slots=c, valid=valid, square=False)
    o, pc, sc, amps = o.contiguous(), pc.contiguous(), sc.contiguous(), amps.contiguous()
    starts, valid = starts.contiguous(), valid.contiguous()
    out = k3_outputs(o, pc)
    _launch_k3(o, pc, sc, amps, starts, valid, out, k3_scratch(c, b, o.device), lo=lo,
               eps=eps, delta1=delta1, delta2=delta2, collect_metrics=collect_metrics,
               dft_precision=dft_precision, stream=torch.cuda.current_stream(o.device))
    return out


def _launch_k3(o, pc, sc, amps, starts, valid, out, scratch, *, lo, eps, delta1, delta2,
               collect_metrics, dft_precision, stream):
    """One launch sequence of K3 on ``stream`` into ``out`` = (d, v, mets),
    with ``scratch`` = (d_obj, num, parts) (:func:`k3_scratch`); every
    operand contiguous, on one card, in the kernel's form."""
    c, n, b = amps.shape[0], amps.shape[-1], pc.shape[-1]
    lib = build.library("epry_increments")
    mats = _kernel_mats(n, b, lo, o.device, dft_precision)
    launched, plan = ctypes.c_int(0), _plan_out()
    err = lib.fpm_k3_increments(
        o.data_ptr(), pc.data_ptr(), sc.data_ptr(), amps.data_ptr(), starts.data_ptr(),
        valid.data_ptr(), *(m.data_ptr() for m in mats), *(t.data_ptr() for t in scratch),
        *(t.data_ptr() for t in out), c, n, b, lo, o.shape[1], o.shape[2], eps, delta1,
        delta2, int(collect_metrics), _TIERS[dft_precision], o.device.index,
        stream.cuda_stream, fused_chunk_increments.force_cluster_size,
        fused_chunk_increments.force_z_layout, ctypes.byref(launched), plan)
    _record(fused_chunk_increments, launched, plan)
    build.check(lib, err, "K3 fused_chunk_increments")


def k3_outputs(o, pc):
    """Fresh (d, v, mets) buffers of K3 for the spectrum block ``o`` and
    the bbox pupil ``pc`` (every element is written by the kernel)."""
    return (torch.empty_like(o), torch.empty_like(pc),
            torch.empty(2, dtype=torch.float32, device=o.device))


def k3_scratch(c: int, b: int, device):
    """K3's scratch for ``c`` slots at bbox ``b``: (d_obj, num, parts)."""
    return (torch.empty((c, b, b, 2), dtype=torch.float32, device=device),
            torch.empty((c, b, b, 2), dtype=torch.float32, device=device),
            torch.empty((c, 2), dtype=torch.float32, device=device))


def chunk_increments_into(o, pc, sc, amps, starts, valid, *, out, scratch, stream, lo,
                          eps, delta1, delta2, collect_metrics, dft_precision):
    """K3 on operands already in the kernel's form, the internal entry of
    the sharded sweeps (``fpm_torch.parallel``), which keep them across the
    sweep: ``o`` (2, R, C) float32 spectrum block, ``pc`` (2, b, b) and
    ``sc`` (b, b) the pupil and support in the centered bbox at offset
    ``lo``, ``amps`` (C, Np, Np) float32, ``starts`` (2C,) and ``valid``
    (C,) int32, all contiguous; writes ``(d, v, mets)`` into ``out``
    (:func:`k3_outputs`; ``v`` in the bbox) and returns it. On the card it
    launches on ``stream`` with ``scratch`` (:func:`k3_scratch`) and checks
    nothing (the caller checked the operands once); on the CPU the plain
    version computes ``out``. :func:`fused_chunk_increments` is this entry
    with the conversions around it."""
    kw = dict(lo=lo, eps=eps, delta1=delta1, delta2=delta2,
              collect_metrics=collect_metrics, dft_precision=dft_precision)
    if o.is_cuda:
        _launch_k3(o, pc, sc, amps, starts, valid, out, scratch, stream=stream, **kw)
    elif o.device.type == "cpu":
        for dst, src in zip(out, _increments_core_plain(o, pc, sc, amps, starts, valid, **kw)):
            dst.copy_(src)
    else:
        raise ValueError(f"no kernel for device {o.device}")
    return out


# ------------------------------------------------------------------ wrappers


def _route(o_planes, cuda_core, plain_core):
    if o_planes.is_cuda:
        return cuda_core
    if o_planes.device.type == "cpu":
        return plain_core
    raise ValueError(f"no kernel for device {o_planes.device}")


def _check_patch_size(p_planes, support, amps, np_size):
    n = np_size
    if (tuple(p_planes.shape[-3:]) != (2, n, n) or tuple(support.shape) != (n, n)
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


def _run_problems(core, o_planes, p_planes, support, amps, *rest, **kw):
    """:func:`_run` for K1 and K2, whose cores take a leading problem axis:
    a single problem ((2, NL, NL) planes) runs as P = 1 and comes back
    without the axis."""
    single = o_planes.ndim == 3
    if single:
        o_planes, p_planes, amps = o_planes[None], p_planes[None], amps[None]
    o, p, mets = _run(core, o_planes, p_planes, support, amps, *rest, **kw)
    return (o[0], p[0], mets[0]) if single else (o, p, mets)


def _check_global_max(global_max):
    if global_max not in ("exact", "lazy"):
        raise ValueError(f"global_max must be 'exact' or 'lazy', got {global_max!r}")


def fused_epry_sweep(o_planes, p_planes, support, amps, starts_flat, *, np_size,
                     n_large, delta1, delta2, eps, pupil_radius=0, global_max="exact",
                     collect_metrics=False, dft_precision="bf16x3", ablate=""):
    """K2: one sequential EPRY sweep (``models.epry.sweep_sequential``).

    ``amps`` (K, Np, Np) float32 in schedule order, ``starts_flat`` (2K,)
    int32 ``[y0, x0, y1, x1, ...]``. ``global_max='lazy'`` freezes max|O| at
    its sweep-start value. ``n_large`` is implied by ``o_planes`` and kept
    for the JAX package's signature. With a leading problem axis
    (``o_planes`` (P, 2, NL, NL), ``p_planes`` (P, 2, Np, Np), ``amps`` (P,
    K, Np, Np)) one launch sweeps all P problems. ``dft_precision``: the
    products' tier. ``ablate``: a name of :data:`SWEEP_ABLATIONS` (a
    measurement aid; the output is garbage unless ``""``).
    """
    _check_global_max(global_max)
    _check_dft_precision(dft_precision)
    _check_ablate(ablate, SWEEP_ABLATIONS, "K2 fused_epry_sweep")
    core = _route(o_planes, _sweep_cuda, _per_problem(_sweep_core_plain))
    return _run_problems(core, o_planes, p_planes, support, amps, starts_flat, np_size=np_size,
                         pupil_radius=pupil_radius, eps=eps, delta1=delta1, delta2=delta2,
                         global_max=global_max, collect_metrics=collect_metrics,
                         dft_precision=dft_precision, ablate=ablate)


def fused_epry_sweep_plain(o_planes, p_planes, support, amps, starts_flat, *, np_size,
                           n_large, delta1, delta2, eps, pupil_radius=0,
                           global_max="exact", collect_metrics=False, dft_precision="bf16x3",
                           ablate=""):
    """The plain PyTorch version of :func:`fused_epry_sweep`, on any device."""
    _check_global_max(global_max)
    _check_dft_precision(dft_precision)
    _check_ablate(ablate, SWEEP_ABLATIONS, "K2 fused_epry_sweep")
    return _run_problems(_per_problem(_sweep_core_plain), o_planes, p_planes, support, amps,
                         starts_flat, np_size=np_size, pupil_radius=pupil_radius, eps=eps,
                         delta1=delta1, delta2=delta2, global_max=global_max,
                         collect_metrics=collect_metrics, dft_precision=dft_precision,
                         ablate=ablate)


def k2_phase_profile(o_planes, p_planes, support, amps, starts_flat, *, np_size, n_large,
                     delta1, delta2, eps, pupil_radius=0, global_max="exact",
                     collect_metrics=False, dft_precision="bf16x3"):
    """A measurement aid: one :func:`fused_epry_sweep` on the card through
    the cycle-counting build of K2 (``build.profile_library``; the wrapper
    itself never loads it). Returns the sweep's ``(o_planes, p_planes,
    mets)``, bitwise those of the wrapper, and ``{phase: SM cycles}`` that
    the cluster's first block spent in each phase of an LED, summed over the
    sweep, under the names the library gives its phases. Waits for the card."""
    _check_global_max(global_max)
    _check_dft_precision(dft_precision)
    lib = build.profile_library("epry_sweep")
    cycles = (ctypes.c_longlong * lib.fpm_phase_count())()
    build.check(lib, lib.fpm_phase_read(cycles, 1), "K2 phase profile")     # counts to 0
    out = _run_problems(functools.partial(_sweep_cuda, lib=lib), o_planes, p_planes, support, amps,
               starts_flat, np_size=np_size, pupil_radius=pupil_radius, eps=eps,
               delta1=delta1, delta2=delta2, global_max=global_max,
               collect_metrics=collect_metrics, dft_precision=dft_precision)
    build.check(lib, lib.fpm_phase_read(cycles, 1), "K2 phase profile")
    return out, {lib.fpm_phase_name(i).decode(): int(c) for i, c in enumerate(cycles)}


def resident_clusters(wrapper, np_size: int, pupil_radius: int, slots: int, cs: int,
                      device=None, dft_precision="bf16x3") -> int:
    """A measurement aid: how many clusters of ``cs`` blocks of K2
    (``wrapper`` = :func:`fused_epry_sweep`) or of K1's forward launch
    (:func:`fused_epry_chunked`) at ``dft_precision`` a card holds at once
    for ``slots`` LEDs, by CUDA's occupancy query (``fpm_resident_clusters``);
    the entry points weigh their choice of cluster size with it. 0: none
    fits."""
    _check_dft_precision(dft_precision)
    stem = {fused_epry_sweep: "epry_sweep", fused_epry_chunked: "epry_chunked"}[wrapper]
    lib = build.library(stem)
    b, _ = bbox_extent(np_size, pupil_radius)
    dev = torch.device(device or "cuda")
    clusters = ctypes.c_int(0)
    err = lib.fpm_resident_clusters(np_size, b, slots, cs, _TIERS[dft_precision],
                                    dev.index or 0, ctypes.byref(clusters))
    build.check(lib, err, f"{stem} resident clusters")
    return clusters.value


def fused_epry_chunked(o_planes, p_planes, support, amps, starts_flat, valid, *,
                       np_size, n_large, delta1, delta2, eps, pupil_radius=0,
                       pupil_step_scale=1.0, collect_metrics=False, dft_precision="bf16x3",
                       ablate=""):
    """K1: one chunked Gauss–Seidel-over-Jacobi sweep (``models.epry.sweep_batched``).

    ``amps`` (n_chunks, C, Np, Np) float32 in chunk-permuted schedule order,
    ``starts_flat`` (n_chunks·C·2,) int32, ``valid`` (n_chunks·C,) int32
    (0 = padded dummy). ``n_large`` is implied by ``o_planes``. With a
    leading problem axis (``o_planes`` (P, 2, NL, NL), ``p_planes`` (P, 2,
    Np, Np), ``amps`` (P, n_chunks, C, Np, Np)) one launch per kernel and
    chunk serves all P problems. ``dft_precision``: the products' tier.
    ``ablate``: a name of :data:`CHUNKED_ABLATIONS` (a measurement aid; the
    output is garbage unless ``""``).
    """
    _check_dft_precision(dft_precision)
    _check_ablate(ablate, CHUNKED_ABLATIONS, "K1 fused_epry_chunked")
    core = _route(o_planes, _chunked_cuda, _per_problem(_chunked_core_plain))
    return _run_problems(core, o_planes, p_planes, support, amps, starts_flat, valid,
                         np_size=np_size, pupil_radius=pupil_radius, eps=eps, delta1=delta1,
                         delta2=delta2, pupil_step_scale=pupil_step_scale,
                         collect_metrics=collect_metrics, dft_precision=dft_precision,
                         ablate=ablate)


def fused_epry_chunked_plain(o_planes, p_planes, support, amps, starts_flat, valid, *,
                             np_size, n_large, delta1, delta2, eps, pupil_radius=0,
                             pupil_step_scale=1.0, collect_metrics=False,
                             dft_precision="bf16x3", ablate=""):
    """The plain PyTorch version of :func:`fused_epry_chunked`, on any device."""
    _check_dft_precision(dft_precision)
    _check_ablate(ablate, CHUNKED_ABLATIONS, "K1 fused_epry_chunked")
    return _run_problems(_per_problem(_chunked_core_plain), o_planes, p_planes, support, amps,
                         starts_flat, valid, np_size=np_size, pupil_radius=pupil_radius,
                         eps=eps, delta1=delta1, delta2=delta2,
                         pupil_step_scale=pupil_step_scale, collect_metrics=collect_metrics,
                         dft_precision=dft_precision, ablate=ablate)


def _check_block(o_planes, n_rows, n_cols):
    if tuple(o_planes.shape) != (2, n_rows, n_cols):
        raise ValueError(f"spectrum block {tuple(o_planes.shape)} is not "
                         f"(2, n_rows={n_rows}, n_cols={n_cols})")


def fused_chunk_increments(o_planes, p_planes, support, amps, starts_flat, valid, *,
                           np_size, n_rows, n_cols, delta1, delta2, eps, pupil_radius=0,
                           collect_metrics=True, dft_precision="bf16x3"):
    """K3: one Jacobi chunk's local increments, nothing applied (the per-rank
    body of ``fpm_torch.parallel``'s sharded sweeps).

    ``o_planes`` (2, n_rows, n_cols) float32: this rank's spectrum block,
    centered frame — the whole spectrum, or a halo-extended row tile.
    ``amps`` (C, Np, Np) float32, ``starts_flat`` (2C,) int32 patch starts
    relative to the block, ``valid`` (C,) int32 (0 = masked dummy). Returns
    ``(d_planes, v_planes, mets)``: the object increments window-added into a
    zeroed block of ``o_planes``' shape; the pupil numerator sum in the
    DC-at-corner frame WITHOUT the 1/max|O| factor (divide by the max of the
    spectrum after the consensus); the (residual, update-norm) partial sums
    (zeros unless ``collect_metrics``). ``dft_precision``: the products' tier.
    """
    _check_block(o_planes, n_rows, n_cols)
    _check_dft_precision(dft_precision)
    core = _route(o_planes, _increments_cuda, _increments_core_plain)
    return _run(core, o_planes, p_planes, support, amps, starts_flat, valid,
                np_size=np_size, pupil_radius=pupil_radius, eps=eps, delta1=delta1,
                delta2=delta2, collect_metrics=collect_metrics, dft_precision=dft_precision)


def fused_chunk_increments_plain(o_planes, p_planes, support, amps, starts_flat, valid, *,
                                 np_size, n_rows, n_cols, delta1, delta2, eps,
                                 pupil_radius=0, collect_metrics=True, dft_precision="bf16x3"):
    """The plain PyTorch version of :func:`fused_chunk_increments`, on any device."""
    _check_block(o_planes, n_rows, n_cols)
    _check_dft_precision(dft_precision)
    return _run(_increments_core_plain, o_planes, p_planes, support, amps, starts_flat,
                valid, np_size=np_size, pupil_radius=pupil_radius, eps=eps, delta1=delta1,
                delta2=delta2, collect_metrics=collect_metrics, dft_precision=dft_precision)


for _wrapper in (fused_epry_sweep, fused_epry_chunked, fused_chunk_increments):
    _wrapper.launches = 0
    _wrapper.cluster_size = 0          # as chosen by the last launch
    _wrapper.plan = {}                 # the whole plan of the last launch (PLAN_FIELDS)
    _wrapper.force_cluster_size = 0    # tests only
    _wrapper.force_z_layout = 0        # tests only: 1 Z whole in every block, 2 cut by rows
for _wrapper in (fused_epry_sweep, fused_epry_chunked):
    _wrapper.force_ablation_build = False   # tests only: ablate="" through the ablation build
