"""The fused EPRY kernels K1, K2 and K3 and the consensus kernels of the
sharded sweeps, each beside its plain version.

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
* The consensus of a sharded sweep's chunk, :func:`consensus_led`,
  :func:`consensus_tile_object` and :func:`consensus_tile_pupil` (one
  launch each per card and chunk; CUDA source ``csrc/epry_consensus.cu``).
  They replace no Pallas kernel: ``fpm_tpu`` leaves these collectives and
  element-wise ops to XLA inside its one program of a mesh run. They count
  their ``launches`` like the others; their launch shape is
  :func:`consensus_plan`'s (section below). They take payloads on another
  card where this card reads its memory (:func:`enable_peer_access`).
* The peer route of the one-process sweep over several cards,
  :func:`peer_epoch`, :func:`peer_post`, :func:`peer_wait` and
  :func:`peer_pull` (CUDA source ``csrc/epry_peer.cu``): the signal and
  wait kernels that keep the order between cards on the cards, and the
  forward halo pulled from a peer's rows. No Pallas kernel either: XLA
  orders and moves a mesh run's collectives inside its program.

K1-K3 take and return the JAX package's operands: the centered object
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
P problems (K2: 2 launches per sweep, K1: 1), and problem q's
result is bitwise that of problem q solved alone, at every P and cluster
size; the plain versions loop over the problems.
Around the kernel, plain PyTorch rolls the pupil and support to the
centered frame and crops them to the NA disk's bounding box, and undoes
that afterwards (so the pupil, and K3's numerator, is exactly zero outside
the box); K1's kernel makes the pupil's roll and crop and their undoing
itself, and copies O, so that its sweep is one launch on the card.

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
rows across the cluster (2), or raises. A launch captured into a CUDA graph
is counted where the capture's owner says (``fpm_torch.parallel.graph``: once
per replay): :func:`launch_counts` and :func:`add_launches` read and move
every wrapper's count.

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
from typing import NamedTuple

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


def _split_words(m: np.ndarray, rows: int, k_pad: int) -> np.ndarray:
    """The bf16x2 words of a complex matrix's split, (4, rows, k_pad / 2)
    uint32: re hi, re lo, im hi, im lo, index 2i in the low half; rows and
    the contraction zero-padded to ``rows`` and ``k_pad``."""
    r, k = m.shape
    out = []
    for part in (m.real, m.imag):
        x = np.zeros((rows, k_pad), np.float32)
        x[:r, :k] = part
        for half in bf16_split(torch.from_numpy(x)):
            bits = half.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
            out.append(bits[:, 0::2] | (bits[:, 1::2] << 16))
    return np.stack(out)


def split_layout(m: np.ndarray) -> np.ndarray:
    """The bf16x3 split of a static complex matrix whose contraction runs
    along its rows, row by row: (rows, ceil(K/2), 4) int32, for each row and
    pair (2i, 2i+1) of contraction indices the bf16x2 words re hi, re lo, im
    hi, im lo, index 2i in the low half; an odd K is padded with a zero.
    :func:`tile_layout` and :func:`row_layout` lay the same words out for
    the kernels' products."""
    rows, k = m.shape
    return np.ascontiguousarray(_split_words(m, rows, k + (k & 1)).transpose(1, 2, 0)).view(
        np.int32)


def tile_layout(m: np.ndarray) -> np.ndarray:
    """K2's tile layout of a complex matrix whose contraction runs along its
    rows (``csrc/epry_common.cuh`` TileA: mma's A operand), int32: for each
    16-row tile, 16-index k-step, part (re hi, re lo, im hi, im lo) and lane
    (g, t), the words of rows g, g + 8 at the index pairs t, then t + 4; rows
    and contraction zero-padded to multiples of 16."""
    rows, k = m.shape
    mt, ks = -(-rows // 16), -(-k // 16)
    w = _split_words(m, 16 * mt, 16 * ks).reshape(4, mt, 2, 8, ks, 2, 4)
    # (part, mt, row half, g, ks, pair half, t) -> (mt, ks, part, g, t, pair half, row half)
    return np.ascontiguousarray(w.transpose(1, 4, 0, 3, 6, 5, 2)).reshape(-1).view(np.int32)


def row_layout(m: np.ndarray, rows: int) -> np.ndarray:
    """K2's row layout of a complex matrix whose contraction runs along its
    rows (TileA's partner RowB: mma's B operand), int32, ``rows`` rows (zero
    rows past the matrix's): per row and 16-index k-step, for t = 0..3 the
    words re hi, re lo of the index pairs t, t + 4 (hi of both, then lo),
    then im hi, im lo the same; each row then one 16-byte unit of zeros."""
    ks = -(-m.shape[1] // 16)
    w = _split_words(m, rows, 16 * ks).reshape(2, 2, rows, ks, 2, 4)
    # (re/im, hi/lo, row, ks, pair half, t) -> (row, ks, t, re/im, hi/lo, pair half)
    units = w.transpose(2, 3, 5, 0, 1, 4).reshape(rows, 32 * ks)
    return np.ascontiguousarray(np.pad(units, ((0, 0), (0, 4)))).reshape(-1).view(np.int32)


@functools.lru_cache(maxsize=16)
def _k2_mats(n: int, b: int, lo: int, device: torch.device):
    """The DFT matrices at bf16x3 of all three kernels, first made for K2
    (``csrc/epry_common.cuh`` led_forward_split): Ai in the row layout with
    8 zero rows past its n (a slab's n-tile reads up to 7 rows past its own,
    and carve_smem stages those rows8(rows) rows and no more), Biᵀ, Af and
    Bfᵀ in the tile layout."""
    ai, bi, af, bf = _block_dft_mats(n, b, lo)
    mats = (row_layout(ai, n + 8), tile_layout(bi.T), tile_layout(af), tile_layout(bf.T))
    return tuple(torch.from_numpy(m).to(device) for m in mats)


def _kernel_mats(n: int, b: int, lo: int, device: torch.device, dft_precision: str):
    """The DFT matrices as the C entry points take them: ``'highest'``
    complex64 Ai, Bi, Af, Bf; ``'bf16x3'`` :func:`_k2_mats` (both cached)."""
    if dft_precision == "highest":
        return _dft_mats(n, b, lo, device)
    return _k2_mats(n, b, lo, device)


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
# buffers, the bytes of dynamic shared memory per block, whether Z is cut by
# rows across the cluster (1) or whole in every block (0), and how many
# clusters of the plan the card holds at once (K1's one launch takes exactly
# that many).
PLAN_FIELDS = ("cs", "nr", "br", "stage", "frames", "smem", "zcut", "resident")


def _plan_out():
    return (ctypes.c_int * len(PLAN_FIELDS))()


def _record(wrapper, launched: ctypes.c_int, plan) -> None:
    """Add an entry point's counted launches to ``wrapper.launches`` and
    keep the plan it chose (``wrapper.plan``, and its cluster size)."""
    with _counter_lock:
        wrapper.launches += launched.value
        wrapper.plan = dict(zip(PLAN_FIELDS, plan))
        wrapper.cluster_size = wrapper.plan["cs"]


def _dense(t):
    """``t`` itself where it is contiguous, else a contiguous copy."""
    return t if t.is_contiguous() else t.contiguous()


def _check_cuda_operands(o, pc, sc, amps, starts, *, n_slots, valid=None, square=True,
                         corner=False):
    """Raise on anything the kernels do not take: device, dtype and shapes
    (``square``: the spectrum is the whole NL×NL one, not a block of it;
    ``corner``: the pupil and support are n×n corner-frame planes, not the
    bbox). (Patch starts need no check: the kernels clamp them. An Np too
    large for a block's shared memory at every cluster size is refused by
    the kernels' entry points.)"""
    dev, n = o.device, amps.shape[-1]
    b = n if corner else pc.shape[-1]
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


def _chunked_cuda(o, p, sup, amps, starts, valid, *, b, lo, eps, delta1, delta2,
                  pupil_step_scale, collect_metrics, dft_precision, ablate="", lib=None):
    """K1 on P problems: ``o`` (P, 2, NL, NL), the pupils ``p`` (P, 2, n, n)
    and the support ``sup`` (n, n) in the corner frame (the kernel crops
    them to the b × b bbox at ``lo`` and the pupils back, as
    :func:`_pupil_to_bbox` and :func:`_pupil_from_bbox` do), ``amps`` (P,
    n_chunks, C, n, n); returns new (o, p, mets). ``lib``: another build of
    csrc/epry_chunked.cu than the one ``build.library`` hands out
    (:func:`k1_phase_profile` passes its own)."""
    n_prob, n_chunks, c, n = amps.shape[0], amps.shape[1], amps.shape[2], amps.shape[-1]
    nl = o.shape[-1]
    _check_problem_axis(o, p, amps, sc=sup, starts=starts, n_slots=n_chunks * c, valid=valid,
                        corner=True)
    if lib is None:
        lib, entry, extra, dft_precision = _ablation_entry(
            fused_epry_chunked, "epry_chunked", "fpm_k1_sweep", ablate, dft_precision)
    else:
        entry, extra = lib.fpm_k1_sweep, ()
    # The host's work per sweep paces the card where it outlasts the kernel's
    # one launch (PERF.md §5): the kernel copies O, crops the pupils and the
    # support, uncrops the pupils and zeroes its max slots and the metrics
    # itself, so a sweep is that one launch on the card and four allocations
    # here; the scratch is one buffer: the pupils' bboxes (P, 2, b, b) and
    # the support's (b, b) f32, d_obj and num (P, C, b, b) complex64 each,
    # parts (P, C, 2) f32 and the max slots (P, n_chunks) u32.
    o, p, sup, amps, starts, valid = (_dense(t) for t in (o, p, sup, amps, starts, valid))
    dev = o.device
    mats = _kernel_mats(n, b, lo, dev, dft_precision)
    o_out, p_out = torch.empty_like(o), torch.empty_like(p)
    slots, fl = n_prob * c, 4
    scratch = torch.empty((2 * n_prob + 1) * b * b + 4 * slots * b * b + 2 * slots
                          + n_prob * n_chunks, dtype=torch.float32, device=dev)
    p_bbox = scratch.data_ptr()
    sup_bbox = p_bbox + 2 * n_prob * b * b * fl
    d_obj = sup_bbox + b * b * fl
    num = d_obj + 2 * slots * b * b * fl
    parts = num + 2 * slots * b * b * fl
    omax_bits = parts + 2 * slots * fl
    mets = torch.empty((n_prob, 2), dtype=torch.float32, device=dev)
    launched, plan = ctypes.c_int(0), _plan_out()
    err = entry(
        o.data_ptr(), o_out.data_ptr(), p.data_ptr(), p_out.data_ptr(), p_bbox, sup.data_ptr(),
        sup_bbox, amps.data_ptr(), starts.data_ptr(), valid.data_ptr(),
        *(m.data_ptr() for m in mats), d_obj, num, parts, omax_bits, mets.data_ptr(), n_prob,
        n_chunks, c, n, b, lo, nl, eps, delta1, delta2, pupil_step_scale, int(collect_metrics),
        _TIERS[dft_precision], *extra, dev.index, torch._C._cuda_getCurrentRawStream(dev.index),
        fused_epry_chunked.force_cluster_size, fused_epry_chunked.force_z_layout,
        ctypes.byref(launched), plan)
    _record(fused_epry_chunked, launched, plan)
    build.check(lib, err, "K1 fused_epry_chunked")
    return o_out, p_out, mets


def _increments_cuda(o, pc, sc, amps, starts, valid, *, lo, eps, delta1, delta2,
                     collect_metrics, dft_precision):
    c, b = amps.shape[0], pc.shape[-1]
    _check_cuda_operands(o, pc, sc, amps, starts, n_slots=c, valid=valid, square=False)
    o, pc, sc, amps = o.contiguous(), pc.contiguous(), sc.contiguous(), amps.contiguous()
    starts, valid = starts.contiguous(), valid.contiguous()
    out = k3_outputs(o, pc)
    _launch_k3(o, pc, sc, amps, starts, valid, out, k3_scratch(c, b, o.device), lo=lo,
               eps=eps, delta1=delta1, delta2=delta2, collect_metrics=collect_metrics,
               dft_precision=dft_precision, stream=_current_stream(o.device))
    return out


def _launch_k3(o, pc, sc, amps, starts, valid, out, scratch, *, lo, eps, delta1, delta2,
               collect_metrics, dft_precision, stream):
    """One launch of K3 on ``stream`` (a raw CUDA stream handle) into
    ``out`` = (d, v, mets), with ``scratch`` = (d_obj, num, parts)
    (:func:`k3_scratch`); every operand contiguous, on one card, in the
    kernel's form."""
    c, n, b = amps.shape[0], amps.shape[-1], pc.shape[-1]
    lib = build.library("epry_increments")
    mats = _kernel_mats(n, b, lo, o.device, dft_precision)
    launched, plan = ctypes.c_int(0), _plan_out()
    err = lib.fpm_k3_increments(
        o.data_ptr(), pc.data_ptr(), sc.data_ptr(), amps.data_ptr(), starts.data_ptr(),
        valid.data_ptr(), *(m.data_ptr() for m in mats), *(t.data_ptr() for t in scratch),
        *(t.data_ptr() for t in out), c, n, b, lo, o.shape[1], o.shape[2], eps, delta1,
        delta2, int(collect_metrics), _TIERS[dft_precision], o.device.index,
        stream, fused_chunk_increments.force_cluster_size,
        fused_chunk_increments.force_z_layout, ctypes.byref(launched), plan)
    _record(fused_chunk_increments, launched, plan)
    build.check(lib, err, "K3 fused_chunk_increments")


def _current_stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _empty(device, *shapes):
    """Fresh float32 tensors of ``shapes`` on ``device``."""
    return tuple(torch.empty(shape, dtype=torch.float32, device=device) for shape in shapes)


def k3_outputs(o, pc):
    """Fresh (d, v, mets) buffers of K3 for the spectrum block ``o`` and
    the bbox pupil ``pc`` (every element is written by the kernel)."""
    return _empty(o.device, o.shape, pc.shape, (2,))


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
    launches on ``stream`` (a raw CUDA stream handle) with ``scratch``
    (:func:`k3_scratch`) and checks
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


def _run(core, o_planes, p_planes, support, amps, *rest, np_size, pupil_radius, corner=False,
         **core_kw):
    """Pupil and support to the centered bbox, the core, and back
    (``corner``: the core takes the pupil and support in the corner frame,
    with the bbox ``b``, and returns the pupil so, as K1's kernel does)."""
    _check_patch_size(p_planes, support, amps, np_size)
    b, lo = bbox_extent(np_size, pupil_radius)
    if corner:
        return core(o_planes, p_planes, support, amps, *rest, b=b, lo=lo, **core_kw)
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


def k1_phase_profile(o_planes, p_planes, support, amps, starts_flat, valid, *, np_size,
                     n_large, delta1, delta2, eps, pupil_radius=0, pupil_step_scale=1.0,
                     collect_metrics=False, dft_precision="bf16x3"):
    """A measurement aid: one :func:`fused_epry_chunked` on the card through
    the cycle-counting build of K1 (``build.profile_library``; the wrapper
    itself never loads it). Returns the sweep's ``(o_planes, p_planes,
    mets)``, bitwise those of the wrapper, and ``{phase: SM cycles}`` that
    the grid's first block spent in each phase of a chunk, summed over the
    sweep. Waits for the card."""
    _check_dft_precision(dft_precision)
    lib = build.profile_library("epry_chunked")
    cycles = (ctypes.c_longlong * lib.fpm_phase_count())()
    build.check(lib, lib.fpm_phase_read(cycles, 1), "K1 phase profile")     # counts to 0
    out = _run_problems(functools.partial(_chunked_cuda, lib=lib), o_planes, p_planes, support,
                        amps, starts_flat, valid, np_size=np_size, pupil_radius=pupil_radius,
                        eps=eps, delta1=delta1, delta2=delta2, pupil_step_scale=pupil_step_scale,
                        collect_metrics=collect_metrics, dft_precision=dft_precision,
                        corner=True)
    build.check(lib, lib.fpm_phase_read(cycles, 1), "K1 phase profile")
    return out, {lib.fpm_phase_name(i).decode(): int(c) for i, c in enumerate(cycles)}


def resident_clusters(wrapper, np_size: int, pupil_radius: int, slots: int, cs: int,
                      device=None, dft_precision="bf16x3") -> int:
    """A measurement aid: how many clusters of ``cs`` blocks of K2
    (``wrapper`` = :func:`fused_epry_sweep`) or of K1's sweep
    (:func:`fused_epry_chunked`) at ``dft_precision`` a card holds at once
    for ``slots`` LEDs, by CUDA's occupancy query (``fpm_resident_clusters``);
    the entry points weigh their choice of cluster size with it, and K1's
    one launch takes exactly that many clusters. 0: none fits."""
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
    Np, Np), ``amps`` (P, n_chunks, C, Np, Np)) the sweep's one launch
    serves all P problems. ``dft_precision``: the products' tier.
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
                         ablate=ablate, corner=core is _chunked_cuda)


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


# ---------------------------------------------------------------- consensus
#
# The consensus of one chunk of the sharded sweeps (``fpm_torch.parallel``)
# on one card, after each rank's K3: the payloads of the ranks' increments
# added in rank order, applied to the state the card's ranks share, max|O|,
# the pupil step and the metric sums. fpm_tpu runs these as XLA's fused
# collectives and element-wise ops in its one program of a mesh run
# (``fpm_tpu/parallel/led_shard.py:112-141``, ``tile_shard.py:200-254``);
# no Pallas kernel. CUDA source ``csrc/epry_consensus.cu``: the LED axis in
# one launch (:func:`consensus_led`), the tile axis in two around the pmax
# over its tiles (:func:`consensus_tile_object`, :func:`consensus_tile_pupil`).
# Their plain versions are the eager op chain the sharded sweeps ran before,
# op for op (the kernels make its bits): the CPU path and the complex route
# take them. The state is (2, R, NL) float32 planes of the spectrum (block)
# and (2, b, b) planes of the bbox pupil, or, on the complex route, complex
# tensors (the pupil n×n); a payload is float32 planes, bf16 planes (it came
# on the bf16 wire) or complex; ``wire`` (``torch.bfloat16`` or None) rounds
# each payload to the wire's dtype before it is added, as the sender's cast
# did.


def _psum_plain(xs, wire=None):
    """The payloads ``xs`` added in rank order, as ``Mesh.psum`` adds them:
    each cast to ``wire`` (if given) and back to the payloads' dtype (f32 for
    payloads that came as bf16)."""
    full = torch.float32 if xs[0].dtype == torch.bfloat16 else xs[0].dtype
    acc = None
    for x in xs:
        x = (x if wire is None else x.to(wire)).to(full)
        acc = x if acc is None else torch.add(acc, x)
    return acc


def _as_state(x, like):
    """A sum of planes payloads in the form of the state ``like``."""
    return x if x.is_complex() or not like.is_complex() else (
        torch.complex(x[0], x[1]).to(like.dtype))


def _state_abs_max(o):
    """max|O| of a state: complex, or (2, ...) planes."""
    return torch.max(torch.abs(o if o.is_complex() else torch.complex(o[0], o[1])))


def _wire_trip(b, like, wire):
    """A reverse-halo slab sent on the ``wire`` dtype and received in the
    form of the state ``like``."""
    if not like.is_complex():
        return b.to(wire).float()
    w = torch.stack([b.real, b.imag]).to(wire)
    return torch.complex(w[0].float(), w[1].float()).to(like.dtype)


def _pupil_step_plain(pc, v, omax, scale):
    if pc.is_complex():
        return pc + scale * _as_state(v, pc) / omax
    step = torch.complex(pc[0], pc[1]) + scale * torch.complex(v[0], v[1]) / omax
    return torch.stack([step.real, step.imag])


def consensus_tile_object_plain(o, ds, halos=(), *, s, hops=(), wire=None):
    """The plain version of one row tile of :func:`consensus_tile_object`:
    ``o`` the tile's state (s rows), ``ds`` its led group's payloads of the
    halo-extended block (S+Np rows) in rank order, ``halos`` for each hop
    ``(j, lo, rows)`` of ``hops`` tile i−j's group's payloads. Returns
    ``(o', max|o'|)``: o + the tile's rows of the psum, the reverse halo
    added to its first rows hop by hop (tile i−j's psum of rows [s+lo,
    s+lo+rows), on the wire and back). With s the block's rows and no hops
    it is the LED axis's object step."""
    d = _as_state(_psum_plain(ds, wire), o)
    d_local = d[..., :s, :]
    for (_, lo, rows), src in zip(hops, halos):
        b = _as_state(_psum_plain([x[..., s + lo:s + lo + rows, :] for x in src], wire), o)
        if wire is not None:
            b = _wire_trip(b, o, wire)
        d_local = torch.cat([d_local[..., :rows, :] + b, d_local[..., rows:, :]], dim=-2)
    o = o + d_local
    return o, _state_abs_max(o)


def consensus_tile_pupil_plain(pc, vs, maxima, resid=(), upd=(), acc=None, *, wire=None,
                               scale=1.0, metrics=True):
    """The plain version of :func:`consensus_tile_pupil`: max|O| the max of
    ``maxima`` in order (the pmax), the pupil step with the psum of ``vs``,
    and with ``metrics`` the sweep's sums ``acc`` (None on the first chunk)
    plus the psums of ``resid`` and ``upd``. Returns ``(pc', max|O|, acc')``
    (``acc'`` None without ``metrics``)."""
    omax = maxima[0]
    for m in maxima[1:]:
        omax = torch.maximum(omax, m)
    pc = _pupil_step_plain(pc, _psum_plain(vs, wire), omax, scale)
    if metrics:
        acc = (0 if acc is None else acc) + torch.stack([_psum_plain(resid), _psum_plain(upd)])
    return pc, omax, acc if metrics else None


def consensus_led_plain(o, pc, ds, vs, resid=(), upd=(), acc=None, *, wire=None, scale=1.0,
                        metrics=True):
    """The plain version of :func:`consensus_led`: returns ``(o', pc',
    max|o'|, acc')``."""
    o, omax = consensus_tile_object_plain(o, ds, s=o.shape[-2], wire=wire)
    pc, omax, acc = consensus_tile_pupil_plain(pc, vs, [omax], resid, upd, acc, wire=wire,
                                               scale=scale, metrics=metrics)
    return o, pc, omax, acc


# Tile groups and ranks per group an entry point of csrc/epry_consensus.cu
# takes (kMaxTiles, kMaxRanks there); its threads a block, elements of a
# plane a thread of C1's and C2's (kConsensusThreads, kPerThread), and the
# scratch words a tile (kSyncWords: blocks arrived, the max's bits).
CONSENSUS_MAX_TILES, CONSENSUS_MAX_RANKS = 8, 32
CONSENSUS_THREADS, CONSENSUS_PER_THREAD = 256, 4
# C3's elements of the pupil a thread (``pupil_plan``; kPupilPerThread
# there): 1, faster than 2 and 4 from a peer's payloads and on one card
# (H100s, scripts/kernel_profile.py --kernel C3).
PUPIL_PER_THREAD = 1
CONSENSUS_SYNC_WORDS = 2


class ConsensusPlan(NamedTuple):
    """The launch of :func:`consensus_led` (C1), :func:`consensus_tile_object`
    (C2) or :func:`consensus_tile_pupil` (C3): ``blocks`` object blocks (a
    tile, C2's grid ``(blocks, tiles)``; 0 for C3), then ``pupil_blocks``
    (C1's and C3's, 0 for C2) of ``threads`` threads, ``per_thread``
    elements of a plane each; the vector path (16-byte loads and stores) or
    the scalar one (C3: neither, a pupil element a load)."""
    blocks: int
    pupil_blocks: int
    threads: int
    per_thread: int
    vector: bool


def consensus_plan(elements: int, *, aligned: bool, nl: int, pupil: int = 0) -> ConsensusPlan:
    """The launch for ``elements`` elements of a plane (a tile's s·NL, or
    R·NL on the LED axis) and, for C1, ``pupil`` = b² pupil elements:
    every element taken by one thread, CONSENSUS_PER_THREAD a thread. The
    vector path where NL is a multiple of 4 and every plane is ``aligned``
    (state and f32 payloads on 16 bytes, bf16 payloads on 8), as
    csrc/epry_consensus.cu's ``vector_ok`` requires."""
    per_block = CONSENSUS_THREADS * CONSENSUS_PER_THREAD
    return ConsensusPlan(blocks=max(1, -(-elements // per_block)),
                         pupil_blocks=-(-pupil // per_block), threads=CONSENSUS_THREADS,
                         per_thread=CONSENSUS_PER_THREAD, vector=aligned and nl % 4 == 0)


def pupil_plan(pupil: int) -> ConsensusPlan:
    """The launch of :func:`consensus_tile_pupil` (C3) for ``pupil`` = b²
    elements: ``pupil_blocks`` blocks of CONSENSUS_THREADS threads,
    PUPIL_PER_THREAD elements each, every element taken once and no block
    without one (the C entry refuses any other grid)."""
    per_block = CONSENSUS_THREADS * PUPIL_PER_THREAD
    return ConsensusPlan(blocks=0, pupil_blocks=-(-pupil // per_block),
                         threads=CONSENSUS_THREADS, per_thread=PUPIL_PER_THREAD, vector=False)


def _aligned(ts) -> bool:
    """Every tensor's first element on 16 bytes (8 for bf16): four elements
    of a plane load as one."""
    return all(t.data_ptr() % (4 * t.element_size()) == 0 for t in ts)


class ConsensusScratch:
    """The scratch of one card's consensus launches, made once a run:
    CONSENSUS_SYNC_WORDS words a tile (C1 uses the first tile's), zero
    between launches; each launch leaves them zero."""

    def __init__(self, device):
        self.sync = torch.zeros(CONSENSUS_SYNC_WORDS * CONSENSUS_MAX_TILES, dtype=torch.int32,
                                device=device)


def _pointers(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _ints(xs):
    return (ctypes.c_int * max(1, len(xs)))(*xs)


def _payload_list(ts, like, dev, what):
    """Pointers and bf16 bits of one reduction's payloads, checked against
    the state ``like``'s shape: f32 or bf16, contiguous, on ``dev``."""
    if not 1 <= len(ts) <= CONSENSUS_MAX_RANKS:
        raise ValueError(f"{what}: {len(ts)} payloads; the kernel takes 1 to "
                         f"{CONSENSUS_MAX_RANKS}")
    for t in ts:
        if (not _readable(t, dev) or t.dtype not in (torch.float32, torch.bfloat16)
                or not t.is_contiguous() or (like is not None and t.shape != like)):
            raise ValueError(f"{what}: a payload {t.dtype} {tuple(t.shape)} on {t.device}; "
                             f"the kernel takes contiguous f32 or bf16 {like} on {dev} "
                             "or on a card whose memory it reads")
    return _pointers(ts), sum(1 << r for r, t in enumerate(ts) if t.dtype == torch.bfloat16)


def _check_state(dev, *ts):
    for t in ts:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"consensus state {t.dtype} {tuple(t.shape)} on {t.device}: "
                             f"the kernels take contiguous float32 planes on {dev}")


def _check_out(dev, *pairs):
    """Caller-owned outputs ``(tensor, shape)``: contiguous float32 of that
    shape on ``dev`` (None: not written)."""
    for t, shape in pairs:
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or not t.is_contiguous() or t.shape != torch.Size(shape)):
            raise ValueError(f"consensus output {t.dtype} {tuple(t.shape)} on {t.device}: "
                             f"the kernels write contiguous float32 {tuple(shape)} on {dev}")


def _copied(out, got):
    """The plain version's results ``got`` copied into the caller's
    ``out`` (None entries stay None), or ``got`` where ``out`` is None."""
    if out is None:
        return got
    return tuple(None if g is None else o.copy_(g) for o, g in zip(out, got))


def _count(wrapper, launched: ctypes.c_int) -> None:
    with _counter_lock:
        wrapper.launches += launched.value


def _metric_lists(resid, upd, dev, metrics):
    if not metrics:
        return None, None
    return (_payload_list(resid, torch.Size([]), dev, "residual")[0],
            _payload_list(upd, torch.Size([]), dev, "update norm")[0])


def _consensus_led_cuda(o, pc, ds, vs, resid, upd, acc, *, wire, scale, metrics, scratch, out,
                        lib=None):
    dev = o.device
    _check_state(dev, o, pc, *(() if acc is None else (acc,)))
    d, d_bf16 = _payload_list(ds, o.shape, dev, "object increments")
    v, v_bf16 = _payload_list(vs, pc.shape, dev, "pupil increments")
    r, u = _metric_lists(resid, upd, dev, metrics)
    o_out, pc_out, omax, acc_out = out or _empty(dev, o.shape, pc.shape, (), (2,))
    _check_out(dev, (o_out, o.shape), (pc_out, pc.shape), (omax, ()),
               (acc_out if metrics else None, (2,)))
    acc_out = acc_out if metrics else None
    plan = consensus_plan(o[0].numel(), aligned=_aligned([o, o_out, *ds]), nl=o.shape[2],
                          pupil=pc[0].numel())
    lib = lib or build.library("epry_consensus")
    launched = ctypes.c_int(0)
    err = lib.fpm_consensus_led(
        o.data_ptr(), o_out.data_ptr(), o.shape[1], o.shape[2], d, d_bf16, pc.data_ptr(),
        pc_out.data_ptr(), pc.shape[-1], v, v_bf16, r, u, len(ds),
        None if acc is None else acc.data_ptr(), None if acc_out is None else acc_out.data_ptr(),
        omax.data_ptr(), scale, int(wire is not None), int(metrics), scratch.sync.data_ptr(),
        plan.blocks, plan.pupil_blocks, int(plan.vector), dev.index, _current_stream(dev),
        ctypes.byref(launched))
    _count(consensus_led, launched)
    build.check(lib, err, "consensus_led")
    return o_out, pc_out, omax, acc_out


def _consensus_tile_object_cuda(blocks, *, s, hops, wire, scratch, out, lib=None):
    dev = blocks[0][0].device
    groups, own, halo = [], [], []

    def group(ts):
        key = tuple(t.data_ptr() for t in ts)
        for g, (k, _) in enumerate(groups):
            if k == key:
                return g
        groups.append((key, ts))
        return len(groups) - 1

    for o, ds, halos in blocks:
        _check_state(dev, o)
        own.append(group(ds))
        halo += [group(src) for src in halos]
    if len(blocks) > CONSENSUS_MAX_TILES or len(groups) > CONSENSUS_MAX_TILES:
        raise ValueError(f"consensus_tile_object: {len(blocks)} tiles reading {len(groups)} "
                         f"groups; the kernel takes at most {CONSENSUS_MAX_TILES} of each")
    count = len(groups[0][1])
    if any(len(ts) != count for _, ts in groups):
        raise ValueError("consensus_tile_object: groups of different sizes")
    like = groups[0][1][0].shape
    lists = [_payload_list(ts, like, dev, "object increments") for _, ts in groups]
    if out is None:
        views = _empty(dev, *(shape for o, _, _ in blocks for shape in (o.shape, ())))
        out = list(zip(views[0::2], views[1::2]))
    outs = list(out)
    _check_out(dev, *((t, shape) for (o, _, _), pair in zip(blocks, outs)
                      for t, shape in zip(pair, (o.shape, ()))))
    plan = consensus_plan(s * like[-1], nl=like[-1], aligned=_aligned(
        [o for o, _, _ in blocks] + [o for o, _ in outs] + [t for _, ts in groups for t in ts]))
    lib = lib or build.library("epry_consensus")
    launched = ctypes.c_int(0)
    err = lib.fpm_consensus_tile_object(
        _pointers([t for _, ts in groups for t in ts]),
        (ctypes.c_uint * len(lists))(*(bits for _, bits in lists)), len(groups), count,
        _pointers([o for o, _, _ in blocks]), _pointers([o for o, _ in outs]),
        _pointers([m for _, m in outs]), _ints(own), _ints(halo), len(blocks), s, like[-1],
        like[-2], len(hops), _ints([lo for _, lo, _ in hops]),
        _ints([rows for _, _, rows in hops]), int(wire is not None), scratch.sync.data_ptr(),
        plan.blocks, int(plan.vector), dev.index, _current_stream(dev), ctypes.byref(launched))
    _count(consensus_tile_object, launched)
    build.check(lib, err, "consensus_tile_object")
    return outs


def _consensus_tile_pupil_cuda(pc, vs, maxima, resid, upd, acc, *, wire, scale, metrics, out,
                               lib=None):
    dev = pc.device
    _check_state(dev, pc, *(() if acc is None else (acc,)))
    v, v_bf16 = _payload_list(vs, pc.shape, dev, "pupil increments")
    r, u = _metric_lists(resid, upd, dev, metrics)
    m, _ = _payload_list(maxima, torch.Size([]), dev, "max|O|")
    pc_out, omax, acc_out = out or _empty(dev, pc.shape, (), (2,))
    _check_out(dev, (pc_out, pc.shape), (omax, ()), (acc_out if metrics else None, (2,)))
    acc_out = acc_out if metrics else None
    plan = pupil_plan(pc[0].numel())
    lib = lib or build.library("epry_consensus")
    launched = ctypes.c_int(0)
    err = lib.fpm_consensus_tile_pupil(
        pc.data_ptr(), pc_out.data_ptr(), pc.shape[-1], v, v_bf16, r, u, len(vs), m,
        len(maxima), None if acc is None else acc.data_ptr(),
        None if acc_out is None else acc_out.data_ptr(), omax.data_ptr(), scale,
        int(wire is not None), int(metrics), plan.pupil_blocks, dev.index,
        _current_stream(dev), ctypes.byref(launched))
    _count(consensus_tile_pupil, launched)
    build.check(lib, err, "consensus_tile_pupil")
    return pc_out, omax, acc_out


def consensus_led(o, pc, ds, vs, resid=(), upd=(), acc=None, *, wire=None, scale=1.0,
                  metrics=True, scratch=None, out=None):
    """The LED axis's consensus of one chunk on one card: ``o`` (2, R, NL)
    and ``pc`` (2, b, b) float32 planes, the state the card's ranks share;
    ``ds``, ``vs`` the group's object and pupil payloads in rank order;
    ``resid``, ``upd`` its metric payloads (one value each) and ``acc`` the
    sweep's (2,) metric sums so far (None on the first chunk; ``metrics``
    False: not this card's to keep). Returns ``(o', pc', max|o'|, acc')``:
    new tensors, or ``out``, the caller's four (``acc'`` None without
    ``metrics``), which must not be ``o``, ``pc`` or ``acc``. On the card one
    launch on the current stream, with ``scratch`` (:class:`ConsensusScratch`);
    on the CPU :func:`consensus_led_plain`."""
    if o.is_cuda:
        return _consensus_led_cuda(o, pc, ds, vs, resid, upd, acc, wire=wire, scale=scale,
                                   metrics=metrics, scratch=scratch, out=out)
    if o.device.type == "cpu":
        return _copied(out, consensus_led_plain(o, pc, ds, vs, resid, upd, acc, wire=wire,
                                                scale=scale, metrics=metrics))
    raise ValueError(f"no kernel for device {o.device}")


def consensus_tile_object(blocks, *, s, hops=(), wire=None, scratch=None, out=None):
    """The tile axis's object step of one chunk on one card, for each row
    tile the card holds: ``blocks`` a list of ``(o, ds, halos)`` as
    :func:`consensus_tile_object_plain` takes them (float32 planes, the
    payloads f32 or bf16). Returns ``[(o', max|o'|)]``: new tensors, or
    ``out``, the caller's pair for each tile. On the card one launch for all
    the tiles, on the current stream; on the CPU the plain version, tile by
    tile."""
    if blocks[0][0].is_cuda:
        return _consensus_tile_object_cuda(blocks, s=s, hops=hops, wire=wire, scratch=scratch,
                                           out=out)
    if blocks[0][0].device.type == "cpu":
        got = [consensus_tile_object_plain(o, ds, halos, s=s, hops=hops, wire=wire)
               for o, ds, halos in blocks]
        return got if out is None else [_copied(o, g) for o, g in zip(out, got)]
    raise ValueError(f"no kernel for device {blocks[0][0].device}")


def consensus_tile_pupil(pc, vs, maxima, resid=(), upd=(), acc=None, *, wire=None,
                         scale=1.0, metrics=True, out=None):
    """The tile axis's pupil step of one chunk on one card: ``maxima`` the
    tiles' max|O| in tile order (what the pmax gathered), the rest as
    :func:`consensus_led`'s. Returns ``(pc', max|O|, acc')``, or ``out``. On
    the card one launch on the current stream as :func:`pupil_plan` plans
    it; on the CPU :func:`consensus_tile_pupil_plain`."""
    if pc.is_cuda:
        return _consensus_tile_pupil_cuda(pc, vs, maxima, resid, upd, acc, wire=wire,
                                          scale=scale, metrics=metrics, out=out)
    if pc.device.type == "cpu":
        return _copied(out, consensus_tile_pupil_plain(pc, vs, maxima, resid, upd, acc,
                                                       wire=wire, scale=scale, metrics=metrics))
    raise ValueError(f"no kernel for device {pc.device}")


def consensus_phase_profile(kernel: str, *args, **kw):
    """A measurement aid: one call of :func:`consensus_led` (``kernel``
    "C1"), :func:`consensus_tile_object` ("C2") or
    :func:`consensus_tile_pupil` ("C3") on the card through the
    stamping build of ``csrc/epry_consensus.cu`` (``build.profile_library``;
    the wrappers never load it), every argument of the wrapper's CUDA path
    given (``scratch`` and ``out`` too). Returns the call's outputs, bitwise
    the wrapper's, and for each block that ran ``{mark: (global ns, SM
    cycles)}`` of the marks it reached (``FPM_CONSENSUS_MARKS``). Waits
    for the card."""
    fn = {"C1": _consensus_led_cuda, "C2": _consensus_tile_object_cuda,
          "C3": _consensus_tile_pupil_cuda}[kernel]
    lib = build.profile_library("epry_consensus")
    marks = [lib.fpm_phase_name(i).decode() for i in range(lib.fpm_phase_count())]
    n = CONSENSUS_MAX_TILES * 1024          # the build's records (kRecords), a block each
    stamps = (ctypes.c_longlong * (n * 2 * len(marks)))()
    build.check(lib, lib.fpm_consensus_records(stamps, 0, 1), "consensus profile")
    out = fn(*args, lib=lib, **kw)
    build.check(lib, lib.fpm_consensus_records(stamps, n, 1), "consensus profile")
    k = len(marks)
    records = [{m: (stamps[r * 2 * k + i], stamps[r * 2 * k + k + i])
                for i, m in enumerate(marks) if stamps[r * 2 * k + i]} for r in range(n)]
    return out, [r for r in records if r]


# ----------------------------------------------------------- the peer route
# The signal and wait kernels of the sharded sweeps' peer route and its halo
# pull (csrc/epry_peer.cu; ``parallel.mesh``: the one-process sweep over
# several cards reads its peers' payloads in place and keeps the order
# between cards on the cards). A card's flag block is a (1 + FLAG_SIGNALS)
# int64 tensor on it: word 0 the card's epoch, bumped once a sweep; word
# 1 + s the flag of signal s, (epoch << 32) | (chunk + 1) after each post.
# The plain versions run on CPU tensors, where steps run in the order they
# are enqueued: a post writes its word, and a wait raises where a flag it
# polls was not posted before it.

FLAG_SIGNALS, PEER_MAX_WAITS = 63, 32
_PEERS: set = set()        # (device, peer) indices whose peer access is enabled


def flag_block(device) -> torch.Tensor:
    """A card's flag block, zero (epoch 0, nothing posted)."""
    return torch.zeros(1 + FLAG_SIGNALS, dtype=torch.int64, device=device)


def enable_peer_access(device, peer) -> None:
    """Let kernels on CUDA ``device`` read ``peer``'s memory (and take
    payloads on it: :func:`consensus_led` and the other consensus kernels,
    :func:`peer_wait`, :func:`peer_pull`)."""
    lib = build.library("epry_peer")
    build.check(lib, lib.fpm_enable_peer_access(device.index, peer.index),
                f"peer access from {device} to {peer}")
    _PEERS.add((device.index, peer.index))


def _readable(t: torch.Tensor, dev) -> bool:
    """``t`` is on ``dev`` or on a card whose memory ``dev`` reads."""
    return t.device == dev or (t.is_cuda and (dev.index, t.device.index) in _PEERS)


def _flag_value(words, chunk: int):
    return (words[0] << 32) | (chunk + 1)


def _peer_launch(wrapper, name, *args):
    lib = build.library("epry_peer")
    launched = ctypes.c_int(0)
    err = getattr(lib, name)(*args, ctypes.byref(launched))
    _count(wrapper, launched)
    build.check(lib, err, wrapper.__name__)


def _stream_of(words, stream):
    return _current_stream(words.device) if stream is None else stream


def peer_epoch_plain(words) -> None:
    words[0] += 1


def peer_epoch(words, *, stream=None) -> None:
    """A card's sweep starts: its epoch += 1 (one launch on ``stream``, a
    raw handle, default the current stream)."""
    if words.is_cuda:
        return _peer_launch(peer_epoch, "fpm_peer_epoch", words.data_ptr(), words.device.index,
                            _stream_of(words, stream))
    peer_epoch_plain(words)


def peer_post_plain(words, slot: int, chunk: int) -> None:
    words[1 + slot] = _flag_value(words, chunk)


def peer_post(words, slot: int, chunk: int, *, stream=None) -> None:
    """Signal ``slot`` of the card of ``words`` posts ``chunk``: one launch
    after the step's work on its stream."""
    if not 0 <= slot < FLAG_SIGNALS or chunk < 0:
        raise ValueError(f"peer_post: signal {slot}, chunk {chunk}; the block holds "
                         f"{FLAG_SIGNALS} signals")
    if words.is_cuda:
        return _peer_launch(peer_post, "fpm_peer_post", words.data_ptr(), slot, chunk,
                            words.device.index, _stream_of(words, stream))
    peer_post_plain(words, slot, chunk)


def peer_wait_plain(flags, words) -> None:
    for block, slot, chunk in flags:
        if int(block[1 + slot]) < int(_flag_value(words, chunk)):
            raise RuntimeError(f"peer_wait: signal {slot} has not posted chunk {chunk}: on "
                               "the CPU every post must be enqueued before its wait")


def peer_wait(flags, words, *, stream=None) -> None:
    """Hold ``stream`` (of the card of ``words``, whose epoch it reads)
    until every ``(block, slot, chunk)`` of ``flags`` has posted ``chunk``
    in this sweep: the blocks are this card's or its peers'. One launch of
    one block per PEER_MAX_WAITS flags."""
    if not words.is_cuda:
        return peer_wait_plain(flags, words)
    dev = words.device
    for block, slot, chunk in flags:
        if not _readable(block, dev) or not 0 <= slot < FLAG_SIGNALS:
            raise ValueError(f"peer_wait: signal {slot} of a block on {block.device}, which "
                             f"{dev} cannot read")
    for i in range(0, len(flags), PEER_MAX_WAITS):
        part = flags[i:i + PEER_MAX_WAITS]
        ptrs = (ctypes.c_void_p * len(part))(*(b.data_ptr() + 8 * (1 + s) for b, s, _ in part))
        _peer_launch(peer_wait, "fpm_peer_wait", ptrs, _ints([c for _, _, c in part]),
                     len(part), words.data_ptr(), dev.index, _stream_of(words, stream))


def peer_pull_plain(dst, src) -> None:
    dst.copy_(src)


# The pull's paths (csrc/epry_peer.cu ``PullPath``, in its order) and
# threads a block (a warp a row; chosen on H100s, scripts/kernel_profile.py
# --kernel P4).
PULL_PATHS = ("scalar", "vector")
PULL_THREADS = 256


class PullPlan(NamedTuple):
    """The launch of :func:`peer_pull`: ``path`` (one of PULL_PATHS),
    ``blocks`` in its grid, (row blocks) × planes of ``threads`` threads, a
    warp a row."""
    path: str
    blocks: int
    threads: int


def pull_plan(planes: int, rows: int, cols: int, plane_stride: int, row_stride: int, *,
              aligned: bool) -> PullPlan:
    """The launch for ``planes`` × ``rows`` runs of ``cols`` floats at
    element strides (``plane_stride``, ``row_stride``, 1), both pointers
    on 16 bytes where ``aligned``: a warp a row, every row of every plane
    in one grid of blocks of PULL_THREADS threads; the vector path (float4)
    where each row is 16-byte chunks that start on 16 bytes (as
    csrc/epry_peer.cu's ``vector_ok`` requires), the scalar path otherwise
    (odd columns, unaligned views)."""
    vector = aligned and cols % 4 == 0 and plane_stride % 4 == 0 and row_stride % 4 == 0
    return PullPlan("vector" if vector else "scalar", -(-rows // (PULL_THREADS // 32)) * planes,
                    PULL_THREADS)


def pull_operands(dst, src) -> None:
    """Raise unless :func:`peer_pull`'s kernel takes ``dst`` and ``src``:
    float32 (planes, rows, cols), at most 65535 planes, ``dst`` contiguous,
    ``src`` of the same shape with unit stride along its rows, on the card
    of ``dst`` or one whose memory it reads."""
    dev = dst.device
    if (src.shape != dst.shape or dst.dim() != 3 or src.dtype != torch.float32
            or dst.dtype != torch.float32 or not dst.is_contiguous() or src.stride(-1) != 1
            or not _readable(src, dev) or dst.shape[0] > 65535):
        raise ValueError(f"peer_pull: {src.dtype} {tuple(src.shape)} on {src.device} into "
                         f"{dst.dtype} {tuple(dst.shape)} on {dev}: the kernel takes float32 "
                         "(planes, rows, cols) rows it can read into contiguous ones, at most "
                         "65535 planes")


def pull_plan_of(dst, src) -> PullPlan:
    """The launch :func:`peer_pull` makes for these operands: test-only
    ``peer_pull.force_plan`` where set, else :func:`pull_plan` of their
    shape, strides and alignment."""
    return peer_pull.force_plan or pull_plan(*dst.shape, src.stride(0), src.stride(1),
                                             aligned=_aligned([dst, src]))


def peer_pull(dst, src, *, stream=None) -> None:
    """``dst`` (contiguous float32 planes on this card) := ``src``, a view
    of the same shape with unit stride along its last dimension, on this
    card or a peer's (:func:`pull_operands`): one launch on the card of
    ``dst`` as :func:`pull_plan_of` plans it, which the C entry checks
    again (a plan the operands do not allow raises)."""
    if not dst.is_cuda:
        return peer_pull_plain(dst, src)
    pull_operands(dst, src)
    plan = pull_plan_of(dst, src)
    _peer_launch(peer_pull, "fpm_peer_pull", dst.data_ptr(), src.data_ptr(), *dst.shape,
                 src.stride(0), src.stride(1), PULL_PATHS.index(plan.path), plan.blocks,
                 plan.threads, dst.device.index, _stream_of(dst, stream))


# Every wrapper that counts its launches.
COUNTED = (fused_epry_sweep, fused_epry_chunked, fused_chunk_increments, consensus_led,
           consensus_tile_object, consensus_tile_pupil, peer_epoch, peer_post, peer_wait,
           peer_pull)


def launch_counts() -> dict[str, int]:
    """Every wrapper's ``launches`` by its name."""
    with _counter_lock:
        return {w.__name__: w.launches for w in COUNTED}


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``counts`` (by wrapper name) to the wrappers'
    ``launches``: a captured sweep's launches once per replay, or (times -1)
    the capture's own, which launched nothing."""
    with _counter_lock:
        for w in COUNTED:
            w.launches += times * counts.get(w.__name__, 0)


for _wrapper in COUNTED:
    _wrapper.launches = 0
peer_pull.force_plan = None            # tests and measurements only: a PullPlan
for _wrapper in (fused_epry_sweep, fused_epry_chunked, fused_chunk_increments):
    _wrapper.launches = 0
    _wrapper.cluster_size = 0          # as chosen by the last launch
    _wrapper.plan = {}                 # the whole plan of the last launch (PLAN_FIELDS)
    _wrapper.force_cluster_size = 0    # tests only
    _wrapper.force_z_layout = 0        # tests only: 1 Z whole in every block, 2 cut by rows
for _wrapper in (fused_epry_sweep, fused_epry_chunked):
    _wrapper.force_ablation_build = False   # tests only: ablate="" through the ablation build
