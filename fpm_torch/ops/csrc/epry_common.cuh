// Device code shared by the EPRY kernels (epry_chunked.cu, K1; epry_sweep.cu,
// K2; epry_increments.cu, K3): the per-LED forward pass and the per-LED
// increments, one LED on a thread-block cluster.
//
// Data layout. The object spectrum O is two f32 planes (re, im) in the
// centered frame: NL×NL for K1 and K2, any R×Ncols block of it for K3 (the
// device code here takes the row stride ``ld``; the callers clamp a window's
// rows and columns to their own extents). The pupil P and its support live in the
// centered frame, cropped to the NA disk's bounding box (b×b at offset lo
// inside the Np×Np patch); the wrapper in fpm_torch/ops/kernels.py rolls and
// crops them. The four bbox DFT matrices, with the fftshifts folded in, are
// complex row-major float2: Ai (n×b), Bi (b×n), Af (b×n), Bf (n×b), so that
//   image     = Ai · (Oc ∘ P) · Bi          (n×n, corner frame)
//   spectrum  = Af · R · Bf                (b×b, centered bbox)
// Two precision tiers, a template parameter of every kernel (Tier):
//   highest  FP32 FMAs on the CUDA cores (cgemm);
//   bf16x3   the default, fpm_tpu's "bf16x3" (pallas_kernels.py _mm_fns):
//            each operand split into bf16 parts, hi = RN(x), lo = RN(x − hi),
//            real and imaginary parts apart, and the product formed as
//            hi·hi + (hi·lo + lo·hi) on the tensor cores (tile_product,
//            warp-level mma.sync m16n8k16 bf16 with f32 accumulation), lo·lo
//            dropped. A product of two bf16 values is exact in f32, so the
//            tier computes fpm_tpu's function up to the f32 summation order.
//            The static matrices come split from the host in the layouts of
//            the products (kernels.py _kernel_mats: Ai in the row layout, Biᵀ,
//            Af, Bfᵀ in the tile layout, so that the contraction runs along
//            the rows for both operand sides); the passes that write the
//            dynamic operands (Z, T_r, the gathered rep, V) split them once,
//            there (led_forward_split, below).
//
// Bound. Per LED the four products are n·b·b + n·b·n + b·n·n + b·n·b
// complex multiply-adds (1.77 M at Np=90, b=64), against a few hundred KB of
// memory traffic: FP32-operation bound, and for K2, where the LEDs run in
// order, bound by how much of the card one LED can use.
//
// Design. A cluster of cs blocks (1, 2, 4 or 8, a launch attribute) owns
// one LED. The four products are cut by their OUTPUTS, never by their
// contraction: every element of every product is one thread's sum over the
// whole contraction in index order, whatever cs is. So the results do not
// depend on the cluster size, repeat to the last bit, and need no float
// atomics. Block r owns slab r of the image plane's rows and of its
// columns (at most nr = ceil(n/cs) each; the last slab may be short or
// empty) and slab r of the bbox's rows (at most br = ceil(b/cs)). With
// Z = Oc∘P (b×b) whole in every block (each computes its own copy: cheaper
// than sharing it):
//   T_r    = Ai[rows_r, :] · Z          local
//   img_r  = T_r · Bi                   local rows of the image; the amplitude
//                                       replacement and the data residual
//                                       are local too             -- barrier 1
//   V[:, cols_r] = Af · rep[:, cols_r]  the column slab of rep is gathered
//                                       from the peers' shared memory (DSMEM),
//                                       n·nr values per block      -- barrier 2
//   up[slab r]   = V[slab r, :] · Bf    the row slab of V is gathered from
//                                       the peers' column slabs, br·n values
// and the increments run on up[slab r]. A cluster barrier stands between a
// slab's writes and the peers' reads of it (1, 2), and the caller puts one
// more before a block may overwrite its V slab or exit. A block's shared
// memory holds Z, T_r, img_r and the gathered slab of rep (56 KB at Np=90,
// cs=8, where one block held 143 KB) and, as far as the rest of its 227 KB
// reaches, the DFT matrices its products read (Bi, Bf, Ai[rows_r,:], Af:
// 144 KB at cs=8), so the contraction loops read both operands from shared
// memory. cs=1 is the single-block layout: nothing is gathered.
// Where Z whole does not fit a block (the whole 200×200 patch as the bbox),
// Z is cut by the bbox rows too (a plan's zcut; the *_zcut kernels, built
// from the same code with CUT): block r builds its br rows of Z and their
// share of max|P| (a cluster max after an extra barrier 0: a max has no
// order), and product 1 reads row k of Z from block k / br through DSMEM (a
// table gives each row's cluster address, carve_smem). Every element of T_r
// is still one tile's (or thread's) sum over k in order, so the results are
// bitwise those of Z whole; V[:, cols_r] takes the place of the block's
// rows of Z after barrier 1, when every peer is done with product 1. Where
// Z whole fits, it is kept: on an H100 the cut made K2 slower (product 1
// through DSMEM doubled; PERF.md §6). What then bounds Np is the image
// plane's slabs: img_r, the gathered rep columns (nr·n values each) and
// T_r: at the highest tier, at Np=200 they keep cs = 4 out (80 KB each at
// nr = 50), and b = n fits cs = 8 up to at least 226 (plan_led refuses
// more at 240); the bf16x3 layouts, which gather rep's columns where T_r
// was, fit cs = 4 at Np=200 with Z cut by rows and b = n up to 256.
// The metric sums do not depend on cs either: one warp sums each 32-column
// segment of an image row (and of a bbox row), lane l on column 32·seg + l,
// the block that owns the row adds that into the segment's accumulator;
// every block stores its accumulators into the cluster's first block at the
// segments' places in the whole image (send_segment_sums), and one warp
// there adds them in a fixed order (ordered_sum).
// cgemm gives a thread a 4×2, 2×2 or 1×2 complex register tile, the
// largest that still leaves the block kMinTiles tiles for its warps (the
// slab products are skinny: 12 rows at cs=8, where only img = T·Bi is
// large enough for 4×2; at cs=4 all four products are), reads the
// right-hand operand as float4 (two complex values), and loads staged
// operands with ld.shared rather than through generic pointers, which were
// slower on the products. A 4×4 tile is not among them: on an H100 it was
// slower wherever it ran (too few warps left to hide the loads), and its
// 32 accumulators made the compiler spill in k2_sweep, which cost every
// product 17 % whichever tile it took. The element-wise passes step their
// 2-D indices without divisions and start a batch of loads before the
// first use.
//
// tile_product gives a warp one 16×8 tile of the complex output over the
// WHOLE contraction, in k order, 16 at a time (K padded with zeros to a
// multiple of 16; rows and columns past M and N are read and not stored),
// with the three passes in three accumulators added as hh + (hl + lh) at
// the end (in K3 each k-step's products reach them through fresh
// accumulators, kstep_sums): the same cut by outputs as cgemm, so results stay
// independent of cs and P and repeat to the last bit; the six independent
// products of a k-step go first and the next k-step's fragments load while
// they run. Its operands are laid out for the fragments: in the tile layout
// (mma's A) or the row layout (mma's B), both split into bf16 parts and
// padded with zeros to whole k-steps, so that a k-step is six 16-byte
// loads, each a whole fragment register set, with no split, no guard and
// no register moves before its 12 mma. The static matrices come so from
// the host (kernels.py tile_layout, row_layout); the passes that write Z,
// T_r, the gathered rep and V split them once, there. Products 1, 2 and 4
// run transposed (cmma_step_t keeps each accumulator's products and their
// order), which puts each skinny side of a slab on mma's 8-wide n and the
// long side on its 16-wide m: product 4's 8 rows at Np 90, cs 8, half of
// whose m16 rows were padding. At cs 8 only some of a block's 16 warps own
// a tile, and each tile's k-steps run in order: the products are bound by
// latency there, not by the tensor cores (PERF.md §5). Splitting a tile's
// contraction across the warps that own none (fresh sums per half, added
// in a fixed order) was tried on an H100 and made the products slower
// (PERF.md §6).
//
// This is the DFT-by-matmul design: the four products cost ~14 MFLOP per
// LED at Np=90, where pruned FFTs (2·(n+b) length-n transforms) need ~1
// MFLOP. So even at the FP32 peak it stays an order of magnitude above the
// least time the work needs.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace fpm {

namespace cg = cooperative_groups;

// The phases of one LED in K2's persistent kernel, in the order they run:
// the one list of them, (identifier, name). Built with -DFPM_PROFILE
// (fpm_torch/ops/build.py, profile_library), the first thread of the first
// block adds the SM cycles since the last mark to the phase that just ended
// (FPM_PHASE), after a block barrier where the phase does not end with one
// (FPM_PHASE_SYNC: the one difference in schedule from a plain build), and
// fpm_phase_read hands the sums out under fpm_phase_name's names. The
// kernel sets the first mark when it starts (FPM_PHASE_START). A plain
// build compiles the marks away.
#define FPM_PHASES(X)                              \
  X(FrameWait, "frame wait")                       \
  X(Window, "window, Z, max|P|")                   \
  X(Barrier0, "cluster barrier 0")                 \
  X(Product1, "product 1: T = Ai·Z")               \
  X(Product2, "product 2: img = T·Bi")             \
  X(Replace, "replace, residual")                  \
  X(Barrier1, "cluster barrier 1")                 \
  X(GatherRep, "gather rep")                       \
  X(Product3, "product 3: V = Af·rep")             \
  X(Barrier2, "cluster barrier 2")                 \
  X(GatherV, "gather V")                           \
  X(Product4, "product 4: up = V·Bf")              \
  X(Increments, "increments, O update")            \
  X(RowMax, "row maxima")                          \
  X(Barrier3, "cluster barrier 3")                 \
  X(MaxReduce, "max|O| reduce")                    \
  X(PupilStep, "pupil step")                       \
  X(Barrier4, "cluster barrier 4")
enum Phase {
#define FPM_PHASE_ID(id, name) kPhase##id,
  FPM_PHASES(FPM_PHASE_ID)
#undef FPM_PHASE_ID
  kPhases
};
#ifdef FPM_PROFILE
__device__ long long fpm_phase_cycles[kPhases];
__device__ long long fpm_phase_last;
#define FPM_PHASE_START()                                             \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0) fpm_phase_last = clock64(); \
  } while (0)
#define FPM_PHASE(i)                                  \
  do {                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0) {        \
      const long long t_ = clock64();                 \
      fpm_phase_cycles[i] += t_ - fpm_phase_last;     \
      fpm_phase_last = t_;                            \
    }                                                 \
  } while (0)
#define FPM_PHASE_SYNC(i) \
  do {                    \
    __syncthreads();      \
    FPM_PHASE(i);         \
  } while (0)
#else
#define FPM_PHASE_START()
#define FPM_PHASE(i)
#define FPM_PHASE_SYNC(i)
#endif

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;
// Loads a thread starts together in the latency-bound element-wise passes.
constexpr int kBatch = 4;
// cgemm takes a smaller register tile when the larger one leaves fewer
// tiles than this (this and kUnroll were chosen on the mono shapes on an H100).
constexpr int kMinTiles = 128;
// Steps of the contraction whose loads are started together.
constexpr int kUnroll = 4;

// The precision tier of the four DFT products (the entry points' ``tier``).
enum Tier { kHighest = 0, kBf16x3 = 1 };

// The stage a kernel of the ablation build turns off: fpm_tpu's ``ablate=``
// (pallas_kernels.py:793, 1148), a measurement aid whose output is garbage
// but for kFull; fpm_torch/ops/kernels.py _ABLATE_IDS gives the names. It is
// a template argument, resolved at compile time wherever it is tested. The
// main kernels are kMain and call the out-of-line led_forward and
// led_increments as before; the ablation build (-DFPM_ABLATE,
// fpm_torch/ops/build.py ablation_library) adds kernels for the others,
// which inline led_forward_at and led_increments_at, each in both layouts
// of Z (whole in every block, and cut by rows: *_ablate_zcut), so that a
// variant runs at every shape the main kernels take. kFull there turns
// nothing off: the main arithmetic (bitwise the same results) through the
// variants' code, their yardstick.
//   kNoDft          no DFT products: Z zero-padded is the image, up the
//                   replaced image's [0:b, 0:b] corner
//   kNoWindowRead   every LED reads its window at O's corner [0:b, 0:b]; the
//                   update still goes to its own window
//   kNoWindowWrite  no object update
//   kOmaxConst      max|O| = 1 + (K2: the LED's index, K1: the chunk's), no
//                   max reduction
//   kNoPupilAcc     (K1) no pupil numerator, no consensus: P stays
//   kDft1Pass       each product one bf16 pass, hi·hi (bf16x3 layout only)
enum Ablate {
  kMain = -1, kFull = 0, kNoDft = 1, kNoWindowRead = 2, kNoWindowWrite = 3, kOmaxConst = 4,
  kNoPupilAcc = 5, kDft1Pass = 6
};

// The DFT matrices. kHighest: complex row-major, Ai (n, b), Bi (b, n), Af
// (b, n), Bf (n, b). kBf16x3: Ai in the row layout (n + 8 rows, K = b), Biᵀ
// (n, b), Af (b, n) and Bfᵀ (b, n) in the tile layout (led_forward_split),
// addressed in 8-byte units.
struct DftMats {
  const float2* ai;
  const float2* bi;
  const float2* af;
  const float2* bf;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// A load of solver state (O, P, the row-max cache, K1's scratch) from L2,
// the point of coherence between SMs: K2's blocks read what their peers
// wrote before the last cluster barrier, K1's what any block wrote before
// the last grid barrier, so these loads must go through neither L1 nor the
// non-coherent path.
__device__ __forceinline__ float ld_state(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float2 ld_state(const float2* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned ld_state(const unsigned* p) { return __ldcg(p); }

// Loads of cgemm's operands. SH: the operand lies in shared memory and ``p``
// is its 32-bit shared address (ld.shared); else ``p`` is a generic pointer.
template <bool SH>
struct Operand {
  using Ptr = typename std::conditional<SH, unsigned, const float2*>::type;
  static __device__ __forceinline__ Ptr base(const float2* p) {
    if constexpr (SH) return (unsigned)__cvta_generic_to_shared(p);
    else return p;
  }
  static __device__ __forceinline__ Ptr at(Ptr p, int elems) {
    if constexpr (SH) return p + 8u * (unsigned)elems;
    else return p + elems;
  }
  static __device__ __forceinline__ float2 ld2(Ptr p) {
    if constexpr (SH) {
      float2 v;
      asm("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(p));
      return v;
    } else {
      return *p;
    }
  }
  static __device__ __forceinline__ float4 ld4(Ptr p) {
    if constexpr (SH) {
      float4 v;
      asm("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
          : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(p));
      return v;
    } else {
      return *reinterpret_cast<const float4*>(p);
    }
  }
};

// A load from the shared memory of a block of the cluster: ``a`` is a
// shared::cluster address (mapa). Volatile: it must not move above the
// cluster barrier after which the peer's data is there.
__device__ __forceinline__ float2 ld_cluster2(unsigned a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(unsigned a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

// The shared::cluster address of ``p`` (this block's shared memory) in the
// shared memory of cluster block ``rank``.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out) : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}

// A dynamic operand cut by row slabs across the cluster: row k starts at the
// shared::cluster address row[k] (a table in this block's shared memory).
struct ZRows {
  const unsigned* row;
};

// The right-hand operand B of cgemm_tile: one matrix (row stride ldb, in
// shared memory when SH) ...
template <bool SH>
struct DenseB {
  using Op = Operand<SH>;
  typename Op::Ptr base;
  int ldb;
  __device__ __forceinline__ typename Op::Ptr row(int k) const { return Op::at(base, k * ldb); }
  __device__ __forceinline__ float2 ld2(typename Op::Ptr r, int j) const {
    return Op::ld2(Op::at(r, j));
  }
  __device__ __forceinline__ float4 ld4(typename Op::Ptr r, int j) const {
    return Op::ld4(Op::at(r, j));
  }
};

// ... or a ZRows table, read from the peers' shared memory.
struct ClusterB {
  ZRows z;
  __device__ __forceinline__ unsigned row(int k) const { return z.row[k]; }
  __device__ __forceinline__ float2 ld2(unsigned r, int j) const { return ld_cluster2(r + 8u * j); }
  __device__ __forceinline__ float4 ld4(unsigned r, int j) const { return ld_cluster4(r + 8u * j); }
};

// C (M×N, row stride ldc) = A (M×K, lda) · B (K×N), complex, one TM × 2
// register tile per thread (TM rows of one pair of columns), each element
// one sum over k in order. Neighbouring threads read neighbouring pairs of
// B. A lies in shared memory when SH; B is a DenseB or a ClusterB. VEC: a
// pair of B is one float4 (N and B's row stride even, its rows 16-byte
// aligned). A ragged last row repeats a valid index and is computed but not
// stored; so is the second column of an odd N's last pair.
template <int TM, bool VEC, bool SH, class BS>
__device__ __forceinline__ void cgemm_tile(const float2* A, int lda, const BS B, float2* C,
                                           int ldc, int M, int N, int K) {
  const int npairs = (N + 1) >> 1;
  const int tm = (M + TM - 1) / TM;
  for (int t = threadIdx.x; t < tm * npairs; t += blockDim.x) {
    const int i0 = (t / npairs) * TM;
    const int j = 2 * (t % npairs), j1 = min(j + 1, N - 1);   // the pair's two columns
    using Op = Operand<SH>;
    typename Op::Ptr a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = Op::at(Op::base(A), min(i0 + i, M - 1) * lda);
    float2 c[TM][2];
#pragma unroll
    for (int i = 0; i < TM; ++i) c[i][0] = c[i][1] = make_float2(0.f, 0.f);
#pragma unroll kUnroll
    for (int k = 0; k < K; ++k) {
      float2 x[TM], y[2];
#pragma unroll
      for (int i = 0; i < TM; ++i) x[i] = Op::ld2(Op::at(a[i], k));
      const auto brow = B.row(k);
      if (VEC) {
        const float4 v = B.ld4(brow, j);
        y[0] = make_float2(v.x, v.y);
        y[1] = make_float2(v.z, v.w);
      } else {
        y[0] = B.ld2(brow, j);
        y[1] = B.ld2(brow, j1);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        cfma(c[i][0], x[i], y[0]);
        cfma(c[i][1], x[i], y[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (i0 + i >= M) continue;
      float2* crow = C + (size_t)(i0 + i) * ldc;
      crow[j] = c[i][0];
      if (j + 1 < N) crow[j + 1] = c[i][1];
    }
  }
}

template <bool VEC, bool SH, class BS>
__device__ __forceinline__ void cgemm_pick(const float2* A, int lda, const BS B, float2* C,
                                           int ldc, int M, int N, int K) {
  const int npairs = (N + 1) >> 1;
  if (((M + 3) >> 2) * npairs >= kMinTiles)
    cgemm_tile<4, VEC, SH>(A, lda, B, C, ldc, M, N, K);
  else if (((M + 1) >> 1) * npairs >= kMinTiles)
    cgemm_tile<2, VEC, SH>(A, lda, B, C, ldc, M, N, K);
  else
    cgemm_tile<1, VEC, SH>(A, lda, B, C, ldc, M, N, K);
}

// C = A · B as above; A and B may be in shared or global memory; C must
// alias neither. All threads of the block call; no barrier inside.
__device__ __noinline__ void cgemm(const float2* A, int lda, const float2* B, int ldb,
                                   float2* C, int ldc, int M, int N, int K) {
  const bool vec = ((N | ldb) & 1) == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  const bool sh = __isShared(A) && __isShared(B);   // both staged: ld.shared
  if (vec && sh)
    cgemm_pick<true, true>(A, lda, DenseB<true>{Operand<true>::base(B), ldb}, C, ldc, M, N, K);
  else if (vec)
    cgemm_pick<true, false>(A, lda, DenseB<false>{B, ldb}, C, ldc, M, N, K);
  else if (sh)
    cgemm_pick<false, true>(A, lda, DenseB<true>{Operand<true>::base(B), ldb}, C, ldc, M, N,
                            K);
  else
    cgemm_pick<false, false>(A, lda, DenseB<false>{B, ldb}, C, ldc, M, N, K);
}

// C = A · B with B's rows in the peers' shared memory (ZRows ``z``; ``vec``:
// B's row stride and N are even). A in shared or global memory.
__device__ __noinline__ void cgemm_z(const float2* A, int lda, const ZRows z, bool vec,
                                     float2* C, int ldc, int M, int N, int K) {
  const ClusterB B{z};
  const bool sh = __isShared(A);
  vec = vec && (N & 1) == 0;
  if (vec && sh)
    cgemm_pick<true, true>(A, lda, B, C, ldc, M, N, K);
  else if (vec)
    cgemm_pick<true, false>(A, lda, B, C, ldc, M, N, K);
  else if (sh)
    cgemm_pick<false, true>(A, lda, B, C, ldc, M, N, K);
  else
    cgemm_pick<false, false>(A, lda, B, C, ldc, M, N, K);
}

// ------------------------------------------------------------ the bf16x3 tier

// (hi, lo) of the pair (x0, x1) as two bf16x2 words, x0 in the low half:
// hi = RN(x), lo = RN(x − hi), fpm_tpu's _bf16_split.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  memcpy(&hi, &h, 4);
  memcpy(&lo, &l, 4);
}

// One fragment of the split of a complex operand: re hi, re lo, im hi, im lo.
template <int R>
struct SplitFrag {
  uint32_t rh[R], rl[R], ih[R], il[R];
};

// d += a · b: one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void negate(uint32_t (&out)[4], const uint32_t (&in)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) out[r] = in[r] ^ 0x80008000u;   // both bf16 signs: exact
}

// The complex product of one k-step into the pass accumulators
// acc[pass][re/im]: pass 0 hi·hi, 1 hi·lo, 2 lo·hi. PASSES = 1 (the
// ablation kDft1Pass): pass 0 alone.
template <int PASSES>
__device__ __forceinline__ void cmma_step(float (&acc)[3][2][4], const SplitFrag<4>& a,
                                          const SplitFrag<2>& b) {
  uint32_t nih[4], nil[4];
  negate(nih, a.ih);
  if constexpr (PASSES == 1) {
    mma_bf16(acc[0][0], a.rh, b.rh);
    mma_bf16(acc[0][1], a.rh, b.ih);
    mma_bf16(acc[0][0], nih, b.ih);
    mma_bf16(acc[0][1], a.ih, b.rh);
    return;
  }
  negate(nil, a.il);
  // Six independent products, then the six that add to them.
  mma_bf16(acc[0][0], a.rh, b.rh);
  mma_bf16(acc[0][1], a.rh, b.ih);
  mma_bf16(acc[1][0], a.rh, b.rl);
  mma_bf16(acc[1][1], a.rh, b.il);
  mma_bf16(acc[2][0], a.rl, b.rh);
  mma_bf16(acc[2][1], a.rl, b.ih);
  mma_bf16(acc[0][0], nih, b.ih);
  mma_bf16(acc[0][1], a.ih, b.rh);
  mma_bf16(acc[1][0], nih, b.il);
  mma_bf16(acc[1][1], a.ih, b.rl);
  mma_bf16(acc[2][0], nil, b.ih);
  mma_bf16(acc[2][1], a.il, b.rh);
}

// cmma_step with the operands swapped: A holds cmma_step's B and B its A
// (the product computed transposed). Each accumulator gets the same exact
// products in the same order, so the sums are cmma_step's, bit for bit.
template <int PASSES>
__device__ __forceinline__ void cmma_step_t(float (&acc)[3][2][4], const SplitFrag<4>& a,
                                            const SplitFrag<2>& b) {
  uint32_t nih[4], nil[4];
  negate(nih, a.ih);
  if constexpr (PASSES == 1) {
    mma_bf16(acc[0][0], a.rh, b.rh);
    mma_bf16(acc[0][1], a.ih, b.rh);
    mma_bf16(acc[0][0], nih, b.ih);
    mma_bf16(acc[0][1], a.rh, b.ih);
    return;
  }
  negate(nil, a.il);
  mma_bf16(acc[0][0], a.rh, b.rh);
  mma_bf16(acc[0][1], a.ih, b.rh);
  mma_bf16(acc[1][0], a.rl, b.rh);
  mma_bf16(acc[1][1], a.il, b.rh);
  mma_bf16(acc[2][0], a.rh, b.rl);
  mma_bf16(acc[2][1], a.ih, b.rl);
  mma_bf16(acc[0][0], nih, b.ih);
  mma_bf16(acc[0][1], a.rh, b.ih);
  mma_bf16(acc[1][0], nil, b.ih);
  mma_bf16(acc[1][1], a.rl, b.ih);
  mma_bf16(acc[2][0], nih, b.il);
  mma_bf16(acc[2][1], a.rh, b.il);
}

// How a k-step's products join a tile's sums. mma.sync adds its 16 products
// to the accumulator it is given with truncation, so a running sum fed
// through it step after step drifts toward zero: over the 13 k-steps of a
// contraction over Np = 200 that moved K3's d by up to 7.6e-4 of max|d| from
// the plain version, where two plain FP32 versions (cuBLAS, MKL) lie 7e-5
// apart (H100, dogStomach shape). With FPM_KSTEP_SUMS (epry_increments.cu,
// K3, whose outputs are the increments themselves) each k-step's products go
// into fresh accumulators, added to the running sums in IEEE f32: K3's d
// then lies 1e-4 from plain there. K1 and K2 apply each increment to O at
// once, where the drift is far below their limits (relative to max|O|); fed
// straight through they spill less and run ~7 % faster (K2).
#ifndef FPM_KSTEP_SUMS
#define FPM_KSTEP_SUMS 0
#endif

// One k-step's products into fresh accumulators, added to the running sums
// in IEEE f32 (FPM_KSTEP_SUMS); TR: the product computed transposed
// (cmma_step_t).
template <int PASSES, bool TR>
__device__ __forceinline__ void kstep_sums(float (&acc)[3][2][4], const SplitFrag<4>& a,
                                           const SplitFrag<2>& b) {
  float s[3][2][4] = {};
  if constexpr (TR)
    cmma_step_t<PASSES>(s, a, b);
  else
    cmma_step<PASSES>(s, a, b);
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[p][c][r] += s[p][c][r];
}

// --------------------------------- the bf16x3 products (led_forward_split)

// The two layouts of the bf16x3 operands, both of 16-byte units, both padded with
// zeros to whole k-steps (16 contraction indices) so that no load needs a
// guard, and both such that one 16-byte load is a whole fragment register
// set of one part (no register moves before the mma):
//   tile (mma's A, m16 × k16 per k-step): unit ((mt·ks + s)·4 + part)·32 +
//     lane holds, for lane (g, t) and part (re hi, re lo, im hi, im lo), the
//     bf16x2 words of rows 16mt + g, + g + 8 at the index pairs 8s + t, then
//     the same at 8s + t + 4: a warp's load is 512 contiguous bytes;
//   row (mma's B, n8 × k16): row r at unit r·rs (rs = row_units(K), odd:
//     a quarter-warp's loads meet no bank conflict), k-step s at 8s, then
//     for t = 0..3 two units: re hi, re lo of the pairs t, t + 4, then
//     im hi, im lo. A row's place depends on nothing but r, so a slab of a
//     static matrix's rows (Ai[rows_r, :]) is read where it lies.
// The host builds the static matrices so (fpm_torch/ops/kernels.py
// tile_layout, row_layout); the passes that write a dynamic operand split it
// into them (put_tile, put_row).
__host__ __device__ inline int ksteps(int K) { return (K + 15) >> 4; }
__host__ __device__ inline int row_units(int K) { return 8 * ksteps(K) + 1; }
__host__ __device__ inline int tile_units(int M, int K) {
  return ((M + 15) >> 4) * ksteps(K) * 128;
}

// An operand in the tile layout (``ks`` k-steps per m-tile) ...
struct TileA {
  const uint4* w;
  int ks;
  __device__ __forceinline__ uint4 quad(int mt, int s, int part, int lane) const {
    return w[((mt * ks + s) * 4 + part) * 32 + lane];
  }
};

// ... or Zᵀ cut across the cluster by k-steps: k-step s of m-tile 0 at the
// shared::cluster address step[s], ``ks`` k-steps per m-tile in each block.
struct TileCut {
  const unsigned* step;
  int ks;
  __device__ __forceinline__ uint4 quad(int mt, int s, int part, int lane) const {
    uint4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(step[s] + 16u * (unsigned)((mt * ks * 4 + part) * 32 + lane)));
    return v;
  }
};

// An operand in the row layout (``rs`` units per row).
struct RowB {
  const uint4* w;
  int rs;
  __device__ __forceinline__ uint4 unit(int r, int s, int t, int im) const {
    return w[r * rs + s * 8 + 2 * t + im];
  }
};

// The split of the complex pair (v0, v1) at (row, index pair p) into an
// operand in the tile layout (``ks`` k-steps per m-tile) or the row layout
// (``rs`` units per row): four 32-bit stores.
__device__ __forceinline__ void put_tile(uint32_t* w, int ks, int row, int p, float2 v0,
                                         float2 v1) {
  uint32_t rh, rl, ih, il;
  split2(v0.x, v1.x, rh, rl);
  split2(v0.y, v1.y, ih, il);
  const int pp = p & 7, lane = ((row & 7) << 2) + (pp & 3);
  const int at = ((((row >> 4) * ks + (p >> 3)) * 128 + lane) << 2) + ((row >> 3) & 1)
                 + (pp >> 2) * 2;
  w[at] = rh;
  w[at + 128] = rl;
  w[at + 256] = ih;
  w[at + 384] = il;
}
__device__ __forceinline__ void put_row(uint32_t* w, int rs, int row, int p, float2 v0,
                                        float2 v1) {
  uint32_t rh, rl, ih, il;
  split2(v0.x, v1.x, rh, rl);
  split2(v0.y, v1.y, ih, il);
  const int pp = p & 7;
  const int at = ((row * rs + (p >> 3) * 8 + 2 * (pp & 3)) << 2) + (pp >> 2);
  w[at] = rh;
  w[at + 2] = rl;
  w[at + 4] = ih;
  w[at + 6] = il;
}

// The split of the complex values v[0..3] at the contraction indices 16s +
// 2t, + 1, + 8, + 9 of ``row`` (the pairs t and t + 4 of k-step s; st =
// 4s + t) into an operand in the row layout: its two 16-byte units there.
__device__ __forceinline__ void put_row4(uint4* w, int rs, int row, int st,
                                         const float2 (&v)[4]) {
  uint4 re, im;
  split2(v[0].x, v[1].x, re.x, re.z);
  split2(v[2].x, v[3].x, re.y, re.w);
  split2(v[0].y, v[1].y, im.x, im.z);
  split2(v[2].y, v[3].y, im.y, im.w);
  uint4* const u = w + row * rs + 8 * (st >> 2) + 2 * (st & 3);
  u[0] = re;
  u[1] = im;
}

// The slab of ``per`` rows that holds row k, from q0, the slab of a row
// k0 ≤ k: no division.
__device__ __forceinline__ int owner(int q0, int k, int per) {
  while (k >= (q0 + 1) * per) ++q0;
  return q0;
}

// The tile's sums over the ks k-steps in order, the passes added as
// hh + (hl + lh): v[r] is accumulator r's element (row 16mt + g (+ 8 for
// r ≥ 2), column cb − g + 2t + (r & 1)), B's row cb the lane's column. The
// next step's fragments load while this one's products run.
template <int PASSES, bool TR, class AS, class BS>
__device__ __forceinline__ void tile_sums(float2 (&v)[4], const AS A, const BS B, int mt, int cb,
                                          int ks, int lane) {
  const int t = lane & 3;
  float acc[3][2][4];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[p][c][r] = 0.f;
  auto load = [&](SplitFrag<4>& a, SplitFrag<2>& b, int s) {
    const uint4 rh = A.quad(mt, s, 0, lane), rl = A.quad(mt, s, 1, lane);
    const uint4 ih = A.quad(mt, s, 2, lane), il = A.quad(mt, s, 3, lane);
    const uint4 re = B.unit(cb, s, t, 0), im = B.unit(cb, s, t, 1);
    a.rh[0] = rh.x; a.rh[1] = rh.y; a.rh[2] = rh.z; a.rh[3] = rh.w;
    a.rl[0] = rl.x; a.rl[1] = rl.y; a.rl[2] = rl.z; a.rl[3] = rl.w;
    a.ih[0] = ih.x; a.ih[1] = ih.y; a.ih[2] = ih.z; a.ih[3] = ih.w;
    a.il[0] = il.x; a.il[1] = il.y; a.il[2] = il.z; a.il[3] = il.w;
    b.rh[0] = re.x; b.rh[1] = re.y; b.rl[0] = re.z; b.rl[1] = re.w;
    b.ih[0] = im.x; b.ih[1] = im.y; b.il[0] = im.z; b.il[1] = im.w;
  };
  auto step = [&](const SplitFrag<4>& a, const SplitFrag<2>& b) {
    if constexpr (FPM_KSTEP_SUMS)
      kstep_sums<PASSES, TR>(acc, a, b);
    else if constexpr (TR)
      cmma_step_t<PASSES>(acc, a, b);
    else
      cmma_step<PASSES>(acc, a, b);
  };
  SplitFrag<4> a;
  SplitFrag<2> b;
  load(a, b, 0);
  for (int s = 1; s < ks; ++s) {
    SplitFrag<4> a2;
    SplitFrag<2> b2;
    load(a2, b2, s);
    step(a, b);
    a = a2;
    b = b2;
  }
  step(a, b);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    v[r] = make_float2(acc[0][0][r] + (acc[1][0][r] + acc[2][0][r]),
                       acc[0][1][r] + (acc[1][1][r] + acc[2][1][r]));
}

// C (M×N) = A (M×K) · B (K×N), A in the tile layout and B in the row layout
// (B's N rows, each a column of C), on the tensor cores: the bf16x3 tier
// (PASSES 3) or its hi·hi pass alone (1: the ablation kDft1Pass). A warp
// owns a 16×8 tile of C over the whole contraction in k order, so every
// element is the same sum whatever the slab sizes (cs, P). Rows of A up to
// the m-tiles' end and of B up to the n-tiles' end are read whatever they
// hold: their elements of C are not stored. ``out.store(v, m0, n0, g, t, M,
// N)``, called by every lane of the warp, stores the lane's four elements of
// the tile at (m0, n0). All threads of the block call; no barrier inside; A
// and B alias no output.
template <int PASSES, bool TR, class AS, class BS, class Out>
__device__ __forceinline__ void tile_product(const AS A, const BS B, const Out out, int M, int N,
                                             int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int nt = (N + 7) >> 3, tiles = ((M + 15) >> 4) * nt;
  for (int tile = warp; tile < tiles; tile += warps) {
    const int mt = tile / nt, n0 = (tile - mt * nt) << 3;
    float2 v[4];
    tile_sums<PASSES, TR>(v, A, B, mt, n0 + (lane >> 2), ksteps(K), lane);
    out.store(v, mt << 4, n0, lane >> 2, lane & 3, M, N);
  }
}

// The row stride, in complex values, of Z as f32 (m = b columns): m at the
// highest tier; at bf16x3, where only the ablation kNoDft keeps Z in f32,
// padded to ≡ 2 mod 8 (the stride the split-operand reckoning, so_z_units,
// leaves room for).
__host__ __device__ inline int z_ld(int m, bool split) {
  return split ? m + ((2 - m % 8) + 8) % 8 : m;
}

// Block-wide sum / max; every thread of the block must call, every thread
// gets the result. ``red`` is 32 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Warp-wide sum; every lane of the warp must call and gets the same value
// (a xor butterfly: each step adds the same two values on both lanes).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How one LED is laid out on its cluster; made by plan_led on the host and
// passed to the kernel by value.
struct LedPlan {
  int cs;      // blocks per LED
  int nr;      // image rows, and image columns, per block: ceil(n / cs)
  int br;      // bbox rows per block, ceil(b / cs)
  int stage;   // bit i set: matrix i (kStage*) is staged in shared memory
  int frames;  // frame buffers of nr·n floats per block (K2: 2 if they fit, else 0)
  unsigned smem;  // dynamic shared memory per block, bytes
  int zcut;    // 1: Z cut by rows across the cluster; 0: Z whole in every block
  int resident;   // clusters of this plan the card holds at once (K1's grid)
};

constexpr int kStageBi = 1, kStageBf = 2, kStageAi = 4, kStageAf = 8;

// An entry point hands its plan back to the wrapper as kPlanFields ints, in
// the order of LedPlan's fields (fpm_torch/ops/kernels.py PLAN_FIELDS).
constexpr int kPlanFields = 8;
inline void export_plan(const LedPlan& p, int* out) {
  const int fields[kPlanFields] = {p.cs,     p.nr,         p.br,   p.stage,
                                   p.frames, (int)p.smem, p.zcut, p.resident};
  memcpy(out, fields, sizeof(fields));
}

__host__ __device__ inline int even_up(int x) { return (x + 1) & ~1; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The shared memory of one LED's block, reckoned per tier T (Tier): the
// highest tier's operands are complex f32, row-major (cgemm); the bf16x3
// tier's are in the tile and row layouts of the split-operand products
// (led_forward_split). One reckoning serves all three kernels: carve_smem
// lays a block out by it, plan_at sizes a plan by it.
//
// The highest tier's buffers, in float2 units:
//   z    Z (b rows of stride b; cut by rows: the block's slab of br rows),
//        then V[:, cols_r] (b rows of stride even_up(nr))
//   t    T_r (nr rows of stride b), then the gathered V[slab r, :] (br·n)
//   img  img_r, then rep_r (nr·n), then up[slab r] (br·b)
//   repc the gathered rep[:, cols_r] (n rows of stride even_up(nr)); with
//        cs = 1 there is nothing to gather and no such buffer
// and its staged matrices complex row-major: Bi, Bf, Af whole, Ai[rows_r, :].
__host__ __device__ inline int z_units(int b, int nr, int br, bool cut) {
  return even_up(imax((cut ? br : b) * b, b * even_up(nr)));
}
__host__ __device__ inline int t_units(int n, int b, int nr, int br) {
  return even_up(imax(nr * b, br * n));
}
__host__ __device__ inline int img_units(int n, int nr) { return even_up(nr * n); }
// Floats of one frame buffer: a block's rows of a frame, 16-byte granular.
__host__ __device__ inline int frame_units(int n, int nr) { return (nr * n + 3) & ~3; }
__host__ __device__ inline int repc_units(int n, int nr, int cs) {
  return cs > 1 ? n * even_up(nr) : 0;
}

// 32-column segments of a row of m columns: the unit of the metric sums.
__host__ __device__ inline int segments(int m) { return (m + 31) >> 5; }

// Floats of the metric sums of all segments of an LED: the n image rows',
// then the b bbox rows'.
__host__ __device__ inline int sums_units(int n, int b) {
  return n * segments(n) + b * segments(b);
}

// The bf16x3 tier's buffers, in float2 units (with Z cut by rows, block r
// builds Zᵀ's zcut_steps(b, cs) k-steps):
//   z    Zᵀ (tile layout), then V[:, cols_r] f32 (b rows of stride
//        even_up(nr)) where cs > 1; in the ablation kNoDft Z f32 (stride
//        z_ld(b, true))
//   t    T_r (row layout, rows8(nr) rows), then rep[:, cols_r]ᵀ (rows8(nr)
//        rows) and V[slab r, :] (rows8(br) rows) where cs > 1, and K2's
//        pupil numerator (br·b)
//   img  img_r, then rep_r (nr·n), then up[slab r] (br·b); with cs = 1 V f32
//        between them (no peer reads it), and rep[:, cols_r]ᵀ and V[slab r, :]
//        over z and t, both free by then
// and its staged matrices: Biᵀ, Af and Bfᵀ whole in the tile layout,
// Ai[rows_r, :] in the row layout with the n-tiles' rows8(nr) rows.
__host__ __device__ inline int rows8(int r) { return (r + 7) & ~7; }
__host__ __device__ inline int zcut_steps(int b, int cs) { return (ksteps(b) + cs - 1) / cs; }
__host__ __device__ inline int so_z_units(int b, int nr, int br, int cs, bool cut) {
  const int zt = 2 * (cut ? ((b + 15) >> 4) * zcut_steps(b, cs) * 128 : tile_units(b, b));
  return even_up(imax(imax(zt, cs > 1 ? b * even_up(nr) : 0), (cut ? br : b) * z_ld(b, true)));
}
__host__ __device__ inline int so_t_units(int n, int b, int nr, int br, int cs, bool cut) {
  const int late = 2 * imax(rows8(nr), rows8(br)) * row_units(n);   // rep columns, V rows
  const int t = even_up(imax(imax(2 * rows8(nr) * row_units(b), br * b), cs > 1 ? late : 0));
  return cs > 1 ? t : imax(t, even_up(late - so_z_units(b, nr, br, cs, cut)));
}
__host__ __device__ inline int so_img_units(int n, int b, int nr, int cs) {
  return even_up(imax(nr * n, cs > 1 ? 0 : b * even_up(nr)));
}

// float2 units (8 bytes) of matrix ``bit``'s slice at tier T for ``rows``
// rows of Ai: the whole matrix, or Ai's rows (bf16x3: the rows8(rows) rows
// of the row layout, all within the n + 8 rows the host gives). Its stride
// in Ai, per row, is ai_units<T>(b).
template <int T>
__host__ __device__ inline int stage_count(int bit, int n, int b, int rows) {
  if constexpr (T == kBf16x3) {
    if (bit == kStageAi) return 2 * rows8(rows) * row_units(b);
    return 2 * (bit == kStageBi ? tile_units(n, b) : tile_units(b, n));
  } else {
    return bit == kStageAi ? rows * b : n * b;
  }
}
template <int T>
__host__ __device__ inline int ai_units(int b) {
  return T == kBf16x3 ? 2 * row_units(b) : b;
}

// float2 units of matrix ``bit``'s staged slice for slabs of nr rows
// (16-byte granular; the bf16x3 layouts are by construction).
template <int T>
__host__ __device__ inline int stage_units(int bit, int n, int b, int nr) {
  return T == kBf16x3 ? stage_count<T>(bit, n, b, nr) : even_up(stage_count<T>(bit, n, b, nr));
}

// 4-byte units of the cut of Z across a cluster: the table of Z's b row
// addresses (ZRows) and this block's max|P|² over its rows, read by the
// peers; at bf16x3, then the table of the addresses of Zᵀ's ksteps(b)
// k-steps.
template <int T>
__host__ __device__ inline int zrows_units(int b, bool cut) {
  return cut ? b + 1 + (T == kBf16x3 ? ksteps(b) : 0) : 0;
}

// Bytes of a block's shared memory at tier T before any staged matrix: the
// buffers, the frame buffers, 32 floats for reductions, the metric
// accumulators of the segments of the block's nr image rows and br bbox
// rows, room for the sums of all segments (read in the first block), and,
// ``cut``, the cut of Z.
template <int T>
__host__ __device__ inline size_t led_base_bytes(int n, int b, int cs, int nr, int br,
                                                 int frames, bool cut) {
  const int buffers = T == kBf16x3 ? so_z_units(b, nr, br, cs, cut)
                                         + so_t_units(n, b, nr, br, cs, cut)
                                         + so_img_units(n, b, nr, cs)
                                   : z_units(b, nr, br, cut) + t_units(n, b, nr, br)
                                         + img_units(n, nr) + repc_units(n, nr, cs);
  return (size_t)buffers * sizeof(float2)
         + (size_t)(frames * frame_units(n, nr) + 32 + nr * segments(n) + br * segments(b)
                    + sums_units(n, b) + zrows_units<T>(b, cut)) * sizeof(float);
}

// One block's view of its shared memory and of its slabs.
struct LedSmem {
  float2 *z, *t, *img, *repc;           // see z_units
  const float2 *bi, *bf, *ai, *af;      // the DFT matrices: staged or global
  float* frame;  // frames · frame_units floats
  float* red;    // 32 floats
  float* rsum;   // Σ(amp − |img|)² of each segment of this block's image rows
  float* usum;   // Σ|dO|² of each segment of this block's bbox rows
  float* sums;   // the first block: every segment's sum (sums_units floats)
  int rank, cs, nr, br, nrp;   // nrp = even_up(nr): the row stride of z as V and of repc
  int row0, rows;          // this block's image rows, and image columns
  int brow0, brows;        // this block's bbox rows
};

// When Z is cut by rows across the cluster, the table of where each of its
// b rows lies (a ZRows) follows the segment sums, then the block's max|P|²
// over its rows (zrows_units).
__device__ __forceinline__ unsigned* zcut_rows(const LedSmem& s, int n, int b) {
  return reinterpret_cast<unsigned*>(s.sums + sums_units(n, b));
}

// Zeroes this block's metric accumulators (s.rsum, s.usum). The callers'
// barriers order it before the first addition to them (led_forward's first
// block barrier) and after the last read (send_segment_sums, then a cluster
// barrier).
__device__ __forceinline__ void zero_segment_sums(const LedSmem& s, int n, int b) {
  for (int e = threadIdx.x; e < s.nr * segments(n) + s.br * segments(b); e += blockDim.x)
    s.rsum[e] = 0.f;
}

// Carves the block's dynamic shared memory as the reckoning of tier T says
// (the tier's buffer units, stage_count), zeroes the metric accumulators,
// writes the table of Z's rows (CUT, Z cut by rows: row k in block k / br,
// at its row k mod br; at bf16x3 also Zᵀ's k-steps) and copies the staged
// slices of the DFT matrices into it. Ends with a block barrier. Slab r of m rows cut for cs
// blocks is [min(r·per, m), min((r+1)·per, m)) with per = ceil(m/cs)
// (fpm_torch/ops/kernels.py slab_bounds states the same rule, and a test
// holds that such slabs cover every row once).
template <int T, bool CUT>
__device__ inline LedSmem carve_smem(void* base, const DftMats m, int n, int b,
                                     const LedPlan plan, int rank) {
  LedSmem s;
  s.rank = rank;
  s.cs = plan.cs;
  s.nr = plan.nr;
  s.br = plan.br;
  s.nrp = even_up(plan.nr);
  s.row0 = min(rank * plan.nr, n);
  s.rows = min(plan.nr, n - s.row0);
  s.brow0 = min(rank * plan.br, b);
  s.brows = min(plan.br, b - s.brow0);
  float2* f = reinterpret_cast<float2*>(base);
  s.z = f;
  if constexpr (T == kBf16x3) {   // rep's columns gathered into t
    f += so_z_units(b, plan.nr, plan.br, plan.cs, CUT);
    s.t = f;
    f += so_t_units(n, b, plan.nr, plan.br, plan.cs, CUT);
    s.img = f;
    f += so_img_units(n, b, plan.nr, plan.cs);
    s.repc = s.t;
  } else {
    f += z_units(b, plan.nr, plan.br, CUT);
    s.t = f;
    f += t_units(n, b, plan.nr, plan.br);
    s.img = f;
    f += img_units(n, plan.nr);
    s.repc = plan.cs > 1 ? f : s.img;
    f += repc_units(n, plan.nr, plan.cs);
  }
  // Matrix ``bit`` from ``src``: copied to f and read there if the plan
  // stages it, else read where it is. Of Ai only the rows the products read
  // are copied, in room for the plan's nr.
  auto stage = [&](const float2* src, int bit) -> const float2* {
    if (!(plan.stage & bit)) return src;
    const int count = stage_count<T>(bit, n, b, s.rows);
    for (int e = threadIdx.x; e < count; e += blockDim.x) f[e] = src[e];
    const float2* staged = f;
    f += stage_units<T>(bit, n, b, plan.nr);
    return staged;
  };
  s.bi = stage(m.bi, kStageBi);
  s.bf = stage(m.bf, kStageBf);
  s.ai = stage(m.ai + (size_t)s.row0 * ai_units<T>(b), kStageAi);
  s.af = stage(m.af, kStageAf);
  s.frame = reinterpret_cast<float*>(f);
  s.red = s.frame + plan.frames * frame_units(n, plan.nr);
  s.rsum = s.red + 32;
  s.usum = s.rsum + plan.nr * segments(n);
  s.sums = s.usum + plan.br * segments(b);
  for (int e = threadIdx.x; e < plan.nr * segments(n) + plan.br * segments(b);
       e += blockDim.x)
    s.rsum[e] = 0.f;
  if constexpr (CUT) {
    unsigned* zrow = zcut_rows(s, n, b);
    const int ldz = z_ld(b, T == kBf16x3);
    for (int k = threadIdx.x; k < b; k += blockDim.x) {
      const int q = k / plan.br;
      zrow[k] = cluster_addr(s.z, q) + 8u * (unsigned)((k - q * plan.br) * ldz);
    }
    if constexpr (T == kBf16x3) {   // Zᵀ's k-step k of m-tile 0: block k / zs, k-step k mod zs
      const int zs = zcut_steps(b, plan.cs);
      for (int k = threadIdx.x; k < ksteps(b); k += blockDim.x) {
        const int q = k / zs;
        zrow[b + 1 + k] = cluster_addr(s.z, q) + 2048u * (unsigned)(k - q * zs);
      }
    }
  }
  __syncthreads();
  return s;
}

// Errors of an entry point beside the cudaError_t values.
constexpr int kErrLedSmem = -1;   // Np too large for a block's shared memory
constexpr int kErrCluster = -2;   // the cluster size asked for cannot be resident

// Makes ``device`` current for an entry point's launches and gives the
// caller's device back when the entry point returns, so that one process
// driving several cards keeps the current device it had.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return;
    err = cudaSetDevice(device);
    if (err == cudaSuccess) prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

// The error of the launch just made; counts it in *launches if accepted.
inline cudaError_t count_launch(int* launches) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

// The launch configuration of ``clusters`` clusters of plan.cs blocks;
// ``cooperative``: every block resident at once, so that the kernel may
// call cg::this_grid().sync() (the runtime refuses a grid past what the card
// holds).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  ClusterLaunch(int clusters, const LedPlan& plan, cudaStream_t stream, bool cooperative = false)
      : cfg{} {
    cfg.gridDim = dim3(clusters * plan.cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// The two builds of a kernel: Z whole in every block, and Z cut by rows
// (the template argument CUT of carve_smem and led_forward).
template <typename Kernel>
struct KernelPair {
  Kernel whole, cut;
  Kernel of(const LedPlan& p) const { return p.zcut ? cut : whole; }
};

// The plan at tier T (the reckoning above) of ``slots`` LEDs on clusters of
// cs blocks: Z whole in every block where its buffers fit, else cut by rows
// across the cluster (``force_zcut``, tests only: 1 takes Z whole, 2 cut, or
// fails); then K2's frame buffers if they fit; then as many matrix slices
// as fit beside the buffers, in the order Bi, Bf, Ai, Af; and in
// plan->resident how many such clusters the card holds at once (0: none).
// ``limit`` is the card's shared memory per block. Returns 0, kErrLedSmem
// (the buffers do not fit) or a cudaError_t value of the occupancy query.
template <int T, typename Kernel>
int plan_at(KernelPair<Kernel> kernel, int n, int b, int slots, int frames, int cs, int limit,
            int force_zcut, LedPlan* plan) {
  LedPlan p{cs, (n + cs - 1) / cs, (b + cs - 1) / cs, 0, frames, 0, 0, 0};
  size_t bytes = 0;
  bool fits = false;
  for (int cut = 0; cut <= (cs > 1 ? 1 : 0) && !fits; ++cut) {
    if (force_zcut && cut != force_zcut - 1) continue;
    p.zcut = cut;
    p.frames = frames;
    bytes = led_base_bytes<T>(n, b, cs, p.nr, p.br, frames, cut);
    if (bytes > (size_t)limit) {   // then without frame buffers: frames read in place
      p.frames = 0;
      bytes = led_base_bytes<T>(n, b, cs, p.nr, p.br, 0, cut);
    }
    fits = bytes <= (size_t)limit;
  }
  if (!fits) return kErrLedSmem;
  for (int bit = kStageBi; bit <= kStageAf; bit <<= 1) {
    const size_t more = (size_t)stage_units<T>(bit, n, b, p.nr) * sizeof(float2);
    if (bytes + more <= (size_t)limit) {
      bytes += more;
      p.stage |= bit;
    }
  }
  p.smem = (unsigned)bytes;
  const ClusterLaunch launch(slots, p, nullptr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&p.resident, kernel.of(p), &launch.cfg);
  if (err != cudaSuccess) cudaGetLastError();   // returned here, not left for the next launch
  *plan = p;
  return (int)err;
}

// The card's shared memory per block, set as both builds' limit: the most
// the card allows, whatever a plan takes, so a kept plan of another size
// needs no second call.
template <typename Kernel>
int smem_limit(KernelPair<Kernel> kernel, int device, int* limit) {
  cudaError_t err =
      cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel.whole, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel.cut, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  return (int)err;
}

// The time of one LED on a cluster of cs = 1, 2, 4, 8 blocks relative to
// cs = 1, per tier: K2's sweep at forced cluster sizes on an H100, the
// weight plan_led gives a wave at each cs (PERF.md §5). highest: 22.06,
// 12.36, 7.34, 4.40 ms; bf16x3, whose products gain most where a block owns
// most rows: 12.9, 8.58, 5.67, 4.21 ms.
constexpr float kLedTime[2][4] = {{1.f, 0.56f, 0.333f, 0.2f}, {1.f, 0.665f, 0.44f, 0.326f}};

// How a launch's slots meet the card: the wave rule of plan_led, and the
// waves a plan of ``resident`` clusters (``sms`` SMs) needs for ``slots``.
//   kOneShot     K3: one cluster per slot, each running one LED; a cluster
//                left without room starts as soon as any finishes, so a wave
//                is as many as the SMs take, sms / cs
//   kPersistent  K2: one cluster per problem walking its whole sweep; a wave
//                is as many clusters as the card holds at once (its own
//                count: clusters sit inside one GPC, and an H100 holds 15 of
//                8 blocks, 30 of 4), and a cluster that finds no room waits
//                for a whole sweep
//   kGrid        K1: exactly the resident clusters walk the chunk's slots in
//                a fixed order; the slots past a wave cost their share of one,
//                not a whole one (on an H100, K1 at mono chunk 32 on 30
//                clusters of 4 took 0.7 µs a chunk more than at chunk 30,
//                where one wave holds them all: the forward of a full card
//                is bound by its throughput, not by one LED; PERF.md §6)
enum Waves { kOneShot, kPersistent, kGrid };
inline float waves(Waves rule, int slots, int resident, int sms, int cs) {
  if (rule == kGrid) return slots > resident ? (float)slots / resident : 1.f;
  const int wave = rule == kPersistent ? resident : imax(1, sms / cs);
  return (float)((slots + wave - 1) / wave);
}

// Chooses the cluster size at tier T for ``kernel`` running ``slots`` LEDs
// (K2: one per problem; K1: the chunk's LEDs of every problem; K3: the
// chunk's slots) and sets the kernel's shared-memory attribute. Of the
// sizes 8, 4, 2, 1 at which a block's buffers fit its shared memory and the
// card says a cluster can be resident, it takes the one with the least
// estimated time: the waves the slots need by ``rule`` times
// kLedTime[T][cs]; a tie goes to the larger cs. ``force_cs`` (tests only; 0
// = choose) takes that size or fails; ``force_zcut`` (tests only; plan_at)
// the layout of Z. Returns 0, a cudaError_t value (an error of the
// occupancy query), kErrLedSmem (no cs fits) or kErrCluster (the forced cs
// cannot run). A plan, once made, is kept by (kernel, shapes, slots,
// device): the card is asked once.
template <int T, typename Kernel>
int plan_led(KernelPair<Kernel> kernel, int n, int b, int slots, int frames, Waves rule,
             int force_cs, int force_zcut, int device, LedPlan* plan) {
  if ((force_cs != 0 && force_cs != 1 && force_cs != 2 && force_cs != 4 && force_cs != 8)
      || force_zcut < 0 || force_zcut > 2)
    return (int)cudaErrorInvalidValue;
  using Key = std::tuple<const void*, int, int, int, int, int, int, int>;
  static std::map<Key, LedPlan> plans;
  static std::mutex plans_lock;
  const Key key{reinterpret_cast<const void*>(kernel.whole), n, b, slots, frames, force_cs,
                force_zcut, device};
  const std::lock_guard<std::mutex> lock(plans_lock);
  const auto made = plans.find(key);
  if (made != plans.end()) {
    *plan = made->second;
    return 0;
  }
  int limit = 0, sms = 0;
  if (const int e = smem_limit(kernel, device, &limit)) return e;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  bool fits_smem = false, found = false;
  float best = 0.f;
  for (int cs = kMaxCluster, log_cs = 3; cs >= 1; cs >>= 1, --log_cs) {
    if (force_cs && cs != force_cs) continue;
    LedPlan p;
    const int e = plan_at<T>(kernel, n, b, slots, frames, cs, limit, force_zcut, &p);
    if (e == kErrLedSmem) continue;
    if (e) return e;
    fits_smem = true;
    if (p.resident < 1) continue;
    const float cost = waves(rule, slots, p.resident, sms, cs) * kLedTime[T][log_cs];
    if (!found || cost < best) {
      found = true;
      best = cost;
      *plan = p;
    }
  }
  if (!found) return fits_smem ? kErrCluster : kErrLedSmem;
  plans[key] = *plan;
  return 0;
}

// A measurement aid behind each library's fpm_resident_clusters: how many
// clusters of cs blocks of ``kernel`` at tier T the card holds at once for
// ``slots`` LEDs of Np n and bbox b (0 when none; kErrLedSmem when the
// buffers do not fit at this cs).
template <int T, typename Kernel>
int resident_clusters(KernelPair<Kernel> kernel, int n, int b, int slots, int frames, int cs,
                      int device, int* clusters) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int limit = 0;
  if (const int e = smem_limit(kernel, device, &limit)) return e;
  LedPlan p;
  const int e = plan_at<T>(kernel, n, b, slots, frames, cs, limit, 0, &p);
  *clusters = e ? 0 : p.resident;
  return e;
}

// A patch start as the JAX package's crop (``lax.dynamic_slice``) takes it:
// a negative start counts from the end, then it is clamped so the n×n patch
// lies inside the spectrum's extent ``dim`` along that axis. Every window
// access stays in bounds whatever the caller passes (ops/complexops.py
// clamp_start is the same).
__device__ __forceinline__ int clamp_start(int s, int dim, int n) {
  if (s < 0) s += dim;
  return min(max(s, 0), dim - n);
}

// The amplitude replacement of this block's image rows in s.img, and their
// share of the data residual Σ(amp − |img|)² into s.rsum when ``metrics``:
// one warp per 32-column segment of an image row, lane l on its column l, so
// a segment's residual is the same sum whichever block and warp own it. The
// one replace pass of both forward passes (led_forward_at,
// led_forward_split), inlined into each.
__device__ __forceinline__ void replace_rows(const LedSmem s, const float* amp, int n, float eps,
                                             bool metrics) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int segs = segments(n);
  for (int t = warp; t < s.rows * segs; t += warps) {
    const int r = t / segs, c = 32 * (t - r * segs) + lane;
    float racc = 0.f;
    if (c < n) {
      const int e = r * n + c;
      const float2 v = s.img[e];
      const float a = amp[e];
      const float re = v.x + eps, im = v.y + eps;
      const float scale = a / sqrtf(re * re + im * im);
      if (metrics) {
        const float d = a - sqrtf(v.x * v.x + v.y * v.y);
        racc = d * d;
      }
      s.img[e] = make_float2(v.x * scale, v.y * scale);
    }
    if (metrics) {
      racc = warp_sum(racc);
      if (lane == 0) s.rsum[t] += racc;
    }
  }
}

// This block's share of the forward pass of one LED from the state (O, P):
//   oc   = O[y0:y0+b, x0:x0+b]                     (centered window; O's row
//                                                   stride is ld)
//   img  = Ai·(oc∘P)·Bi                            (image plane, n×n)
//   rep  = img · amp / |img + eps(1+i)|            (eps on BOTH channels)
//   up   = Af·rep·Bf                               (b×b)
// computed as the header's design note says. ``amp`` points at this
// block's rows of the frame (shared or global memory). Leaves up[slab r]
// in s.img (brows × b), max|P| over the whole bbox pupil in *pmax (the
// object update's max|P|, fpmMain.cpp:404-419; every block gets the same
// value), and, when ``metrics``, adds each segment of its image rows' share
// of the data residual Σ(amp − |img|)² to s.rsum. All threads of all blocks of
// the cluster must call; with cs > 1 it holds two cluster barriers (three
// when Z is cut), and
// the peers may read this block's s.z until the next one, which the caller
// places before s.z is written again or the block exits. T (Tier) picks the
// products; CUT: Z is cut by rows across the cluster (a plan's zcut, and
// carve_smem's CUT). led_forward_at<T, CUT, A> is the same with the stage of
// ablation A turned off, with Z whole or cut as the main kernels take it and
// with the same bits either way (every branch of A reads Z where the block
// that built it keeps it); the main kernels call led_forward. The products
// here are the highest tier's (cgemm); at bf16x3 the kernels call
// led_forward_split, which comes here for kNoDft alone (no product).
template <int T, bool CUT, int A>
__device__ __forceinline__ void led_forward_at(const float* o_re, const float* o_im, int ld,
                                               int y0, int x0, const float* p_re,
                                               const float* p_im, const float* amp, int n, int b,
                                               float eps, bool metrics, const LedSmem s,
                                               float* pmax) {
  static_assert(T == kHighest || A == kNoDft, "bf16x3's products are led_forward_split's");
  cg::cluster_group cluster = cg::this_cluster();
  const int zr0 = CUT ? s.brow0 : 0;   // the first row of Z this block builds
  const int bb = (CUT ? s.brows : b) * b;
  const int ldz = z_ld(b, T == kBf16x3);
  p_re += zr0 * b;
  p_im += zr0 * b;
  y0 += zr0;
  float pm2 = 0.f;
  // Element e = i·b + j of the block's rows of the window, stepped by
  // blockDim without a division.
  const int di = blockDim.x / b, dj = blockDim.x - di * b;
  int i = threadIdx.x / b, j = threadIdx.x - i * b;
  for (int e0 = threadIdx.x; e0 < bb; e0 += kBatch * blockDim.x) {
    float2 o[kBatch], p[kBatch];   // all loads of a batch in flight before the first use
    int zi[kBatch];                // where the element lies in Z
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < bb) {
        const size_t g = A == kNoWindowRead ? (size_t)(zr0 + i) * ld + j   // O[0:b, 0:b]
                                            : (size_t)(y0 + i) * ld + (x0 + j);
        o[u] = make_float2(ld_state(o_re + g), ld_state(o_im + g));
        p[u] = make_float2(ld_state(p_re + e), ld_state(p_im + e));
      }
      zi[u] = i * ldz + j;
      i += di;
      j += dj;
      if (j >= b) {
        j -= b;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < bb) {
        pm2 = fmaxf(pm2, p[u].x * p[u].x + p[u].y * p[u].y);
        s.z[T == kBf16x3 ? zi[u] : e] = cmul(o[u], p[u]);
      }
    }
  }
  pm2 = block_max(pm2, s.red);            // ends with a block barrier: Z is written
  FPM_PHASE(kPhaseWindow);
  if constexpr (CUT) {
    float* const pm2_slot = reinterpret_cast<float*>(zcut_rows(s, n, b) + b);
    if (threadIdx.x == 0) *pm2_slot = pm2;
    cluster.sync();   // barrier 0: every block's rows of Z and its max|P|² are written
    for (int q = 0; q < s.cs; ++q) pm2 = fmaxf(pm2, *cluster.map_shared_rank(pm2_slot, q));
  }
  *pmax = sqrtf(pm2);
  FPM_PHASE(kPhaseBarrier0);
  if constexpr (A == kNoDft) {   // img_r = this block's rows of Z zero-padded to n×n
    for (int e = threadIdx.x; e < s.rows * n; e += blockDim.x) {
      const int r = e / n, c = e - r * n, i = s.row0 + r;
      float2 v = make_float2(0.f, 0.f);
      if (i < b && c < b) {
        if constexpr (CUT)   // row i from the block that built it (barrier 0 is behind)
          v = ld_cluster2(zcut_rows(s, n, b)[i] + 8u * (unsigned)c);
        else
          v = s.z[i * ldz + c];
      }
      s.img[e] = v;
    }
  } else {
    // T_r = Ai[rows_r,:]·Z; cut, row k of Z read from the block that built it
    if constexpr (CUT)
      cgemm_z(s.ai, b, ZRows{zcut_rows(s, n, b)}, (ldz & 1) == 0, s.t, b, s.rows, b, b);
    else
      cgemm(s.ai, b, s.z, b, s.t, b, s.rows, b, b);
    __syncthreads();
    FPM_PHASE(kPhaseProduct1);
    cgemm(s.t, b, s.bi, n, s.img, n, s.rows, n, b);   // img_r = T_r·Bi
  }
  __syncthreads();
  FPM_PHASE(kPhaseProduct2);
  replace_rows(s, amp, n, eps, metrics);
  FPM_PHASE(kPhaseReplace);
  if constexpr (A == kNoDft) {   // up[slab r] = rep[slab r rows, 0:b], via s.t
    if (s.cs > 1) cluster.sync();   // every rep_q is written
    for (int l = threadIdx.x; l < s.brows * b; l += blockDim.x) {
      const int i = s.brow0 + l / b, j = l % b, q = i / s.nr;
      s.t[l] = cluster.map_shared_rank(s.img, q)[(i - q * s.nr) * n + j];
    }
    if (s.cs > 1) cluster.sync();   // every peer has read this block's rep
    __syncthreads();
    for (int l = threadIdx.x; l < s.brows * b; l += blockDim.x) s.img[l] = s.t[l];
    __syncthreads();
    return;
  }
  const float2* vrow = s.z;     // V[slab r, :]; with one block, V itself
  int ld_repc = n, ld_vrow = s.nrp;
  if (s.cs > 1) {
    cluster.sync();             // barrier 1: every rep_q is written, every slab of Z read
    FPM_PHASE(kPhaseBarrier1);
    // rep[:, cols_r]: row i from the block that owns it
    for (int e0 = threadIdx.x; e0 < n * s.rows; e0 += kBatch * blockDim.x) {
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < n * s.rows) {
          const int i = e / s.rows, c = e - i * s.rows, q = i / s.nr;
          v[u] = cluster.map_shared_rank(s.img, q)[(i - q * s.nr) * n + s.row0 + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < n * s.rows) {
          const int i = e / s.rows;
          s.repc[i * s.nrp + (e - i * s.rows)] = v[u];
        }
      }
    }
    ld_repc = s.nrp;
  }
  __syncthreads();
  FPM_PHASE(kPhaseGatherRep);
  // V[:,cols_r] = Af·rep[:,cols_r]; an odd count of columns takes the pad
  // column of repc along (never read afterwards) and keeps the float4 loads.
  cgemm(s.af, n, s.repc, ld_repc, s.z, s.nrp, b, min(even_up(s.rows), s.nrp), n);
  if (s.cs > 1) {
    FPM_PHASE_SYNC(kPhaseProduct3);
    cluster.sync();             // barrier 2: every V[:, cols_q] is written, every rep_q read
    FPM_PHASE(kPhaseBarrier2);
    // V[slab r, :]: column k from the block that owns it
    for (int e0 = threadIdx.x; e0 < s.brows * n; e0 += kBatch * blockDim.x) {
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < s.brows * n) {
          const int i = e / n, k = e - i * n, q = k / s.nr;
          v[u] = cluster.map_shared_rank(s.z, q)[(s.brow0 + i) * s.nrp + (k - q * s.nr)];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < s.brows * n) s.t[e] = v[u];
      }
    }
    vrow = s.t;
    ld_vrow = n;
  }
  __syncthreads();
  FPM_PHASE(kPhaseGatherV);
  cgemm(vrow, ld_vrow, s.bf, b, s.img, b, s.brows, b, n);   // up[slab r] = V[slab r,:]·Bf
  __syncthreads();
  FPM_PHASE(kPhaseProduct4);
}

template <int T, bool CUT>
__device__ void led_forward(const float* o_re, const float* o_im, int ld, int y0, int x0,
                             const float* p_re, const float* p_im, const float* amp, int n,
                             int b, float eps, bool metrics, const LedSmem s, float* pmax) {
  led_forward_at<T, CUT, kMain>(o_re, o_im, ld, y0, x0, p_re, p_im, amp, n, b, eps, metrics, s,
                                pmax);
}

// The outputs of tile_product: complex f32, row stride ``ld``; TR: the
// product's rows are the output's columns (the product computed transposed) ...
template <bool TR>
struct OutF32 {
  float2* c;
  int ld;
  __device__ __forceinline__ void store(const float2 (&v)[4], int m0, int n0, int g, int t,
                                        int M, int N) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = m0 + g + ((r >> 1) << 3), j = n0 + 2 * t + (r & 1);
      if (i < M && j < N) c[TR ? (size_t)j * ld + i : (size_t)i * ld + j] = v[r];
    }
  }
};

// ... or T_r = (the product)ᵀ in the row layout (``rs`` units per row: the
// rows its N columns, the index pairs along its M rows): lane (g, t) holds
// rows m0 + g, + 8 of columns n0 + 2t, + 1, and takes from lane g ^ 1 the
// partners of one column's pairs (even g column n0 + 2t, odd g the next);
// rows past M are the contraction's zero padding.
struct OutTr {
  uint32_t* w;
  int rs;
  __device__ __forceinline__ void store(const float2 (&v)[4], int m0, int n0, int g, int t,
                                        int M, int N) const {
    const int odd = g & 1;
    const float2 s0 = odd ? v[0] : v[1], s1 = odd ? v[2] : v[3];
    const float2 r0 = make_float2(__shfl_xor_sync(0xffffffffu, s0.x, 4),
                                  __shfl_xor_sync(0xffffffffu, s0.y, 4));
    const float2 r1 = make_float2(__shfl_xor_sync(0xffffffffu, s1.x, 4),
                                  __shfl_xor_sync(0xffffffffu, s1.y, 4));
    const int col = n0 + 2 * t + odd, j = m0 + g - odd;   // j: the pair's even row
    if (col >= N) return;
    const float2 z = make_float2(0.f, 0.f);
    const float2 a0 = odd ? r0 : v[0], a1 = odd ? v[1] : r0;   // rows j, j + 1
    const float2 b0 = odd ? r1 : v[2], b1 = odd ? v[3] : r1;   // rows j + 8, j + 9
    put_row(w, rs, col, j >> 1, j < M ? a0 : z, j + 1 < M ? a1 : z);
    put_row(w, rs, col, (j >> 1) + 4, j + 8 < M ? b0 : z, j + 9 < M ? b1 : z);
  }
};

// The forward pass at bf16x3 of all three kernels: led_forward_at's
// function and contract (the same barriers; up[slab r] left in s.img), with
// every operand of the four products in a layout whose loads are whole
// fragments (TileA, RowB; the static matrices from the host, the dynamic
// ones split where they are written) and each product a tile_product:
//   window      Zᵀ (tile layout: rows j, index pairs along Z's rows; cut by
//               rows: this block's zcut_steps k-steps of every row)
//   product 1   T_rᵀ = Zᵀ·Ai[rows_r, :]ᵀ: the slab's rows on mma's 8-wide
//               side; stored as T_r in the row layout (OutTr)
//   product 2   img_rᵀ = Biᵀ·T_rᵀ
//   rep gather  rep[:, cols_r]ᵀ (row layout), rep's rows from the block that
//               owns each
//   product 3   V[:, cols_r] = Af·rep[:, cols_r], f32 for the peers
//   V gather    V[slab r, :] (row layout), V's columns from their owners
//   product 4   up[slab r]ᵀ = Bfᵀ·V[slab r, :]ᵀ: the slab's br rows (8 at
//               Np 90, cs 8) on the 8-wide side and Bf's b on the 16-wide
// (so_z_units gives the buffers). A = kNoDft runs no product: it is
// led_forward_at's, on f32 Z.
template <bool CUT, int A>
__device__ __forceinline__ void led_forward_split(const float* o_re, const float* o_im, int ld,
                                                  int y0, int x0, const float* p_re,
                                                  const float* p_im, const float* amp, int n,
                                                  int b, float eps, bool metrics,
                                                  const LedSmem s, float* pmax) {
  if constexpr (A == kNoDft) {
    led_forward_at<kBf16x3, CUT, kNoDft>(o_re, o_im, ld, y0, x0, p_re, p_im, amp, n, b, eps,
                                         metrics, s, pmax);
  } else {
    constexpr int kPasses = A == kDft1Pass ? 1 : 3;
    cg::cluster_group cluster = cg::this_cluster();
    const int kb = ksteps(b), kn = ksteps(n);
    const int zs = CUT ? zcut_steps(b, s.cs) : kb;   // k-steps of Zᵀ this block holds per m-tile
    // Zᵀ's index pairs [q0, q1) of every row j < b: Z = O[y0 + i, x0 + j]·P[i, j]
    const int q0 = CUT ? min(s.rank * zs, kb) * 8 : 0, q1 = CUT ? min(q0 + 8 * zs, 8 * kb) : 8 * kb;
    const int count = (q1 - q0) * b;
    uint32_t* const zw = reinterpret_cast<uint32_t*>(s.z);
    float pm2 = 0.f;
    // Element e = w·b + j (pair q0 + w of row j), stepped by blockDim without a division.
    const int dw = blockDim.x / b, dj = blockDim.x - dw * b;
    int w = threadIdx.x / b, j = threadIdx.x - w * b;
    for (int e0 = threadIdx.x; e0 < count; e0 += kBatch * blockDim.x) {
      float2 o[kBatch][2], p[kBatch][2];   // every load of a batch before the first use
      int at[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 2 * (q0 + w) + hh;
          o[u][hh] = p[u][hh] = make_float2(0.f, 0.f);
          if (e0 + u * (int)blockDim.x < count && i < b) {
            const size_t g = A == kNoWindowRead ? (size_t)i * ld + j                // O[0:b, 0:b]
                                                : (size_t)(y0 + i) * ld + (x0 + j);
            o[u][hh] = make_float2(ld_state(o_re + g), ld_state(o_im + g));
            p[u][hh] = make_float2(ld_state(p_re + i * b + j), ld_state(p_im + i * b + j));
          }
        }
        at[u][0] = j;
        at[u][1] = w;
        w += dw;
        j += dj;
        if (j >= b) {
          j -= b;
          ++w;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (e0 + u * (int)blockDim.x < count) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            pm2 = fmaxf(pm2, p[u][hh].x * p[u][hh].x + p[u][hh].y * p[u][hh].y);
          put_tile(zw, zs, at[u][0], at[u][1], cmul(o[u][0], p[u][0]), cmul(o[u][1], p[u][1]));
        }
      }
    }
    pm2 = block_max(pm2, s.red);            // ends with a block barrier: Zᵀ is written
    FPM_PHASE(kPhaseWindow);
    if constexpr (CUT) {
      float* const pm2_slot = reinterpret_cast<float*>(zcut_rows(s, n, b) + b);
      if (threadIdx.x == 0) *pm2_slot = pm2;
      cluster.sync();   // barrier 0: every block's k-steps of Zᵀ and its max|P|² are written
      for (int q = 0; q < s.cs; ++q) pm2 = fmaxf(pm2, *cluster.map_shared_rank(pm2_slot, q));
    }
    *pmax = sqrtf(pm2);
    FPM_PHASE(kPhaseBarrier0);
    // T_rᵀ = Zᵀ·Ai[rows_r, :]ᵀ (cut: k-step s of Zᵀ from the block that built it)
    const RowB ai{reinterpret_cast<const uint4*>(s.ai), row_units(b)};
    const OutTr tr{reinterpret_cast<uint32_t*>(s.t), row_units(b)};
    if constexpr (CUT)
      tile_product<kPasses, true>(TileCut{zcut_rows(s, n, b) + b + 1, zs}, ai, tr, b, s.rows, b);
    else
      tile_product<kPasses, true>(TileA{reinterpret_cast<const uint4*>(s.z), kb}, ai, tr, b,
                                  s.rows, b);
    __syncthreads();
    FPM_PHASE(kPhaseProduct1);
    // img_rᵀ = Biᵀ·T_rᵀ
    tile_product<kPasses, true>(TileA{reinterpret_cast<const uint4*>(s.bi), kb},
                                RowB{reinterpret_cast<const uint4*>(s.t), row_units(b)},
                                OutF32<true>{s.img, n}, n, s.rows, b);
    __syncthreads();
    FPM_PHASE(kPhaseProduct2);
    replace_rows(s, amp, n, eps, metrics);
    FPM_PHASE(kPhaseReplace);
    // Where the later operands go: with peers, V[:, cols_r] where Zᵀ was (the
    // peers read it until the caller's next barrier) and rep's columns, then
    // V's rows, where T_r was; alone, V in img and the rest over z and t.
    const bool solo = s.cs == 1;
    uint32_t* const cols = reinterpret_cast<uint32_t*>(solo ? s.z : s.t);
    float2* const vcols = solo ? s.img : s.z;   // V[:, cols_r]
    if (solo) {
      __syncthreads();            // every row of rep is written
    } else {
      cluster.sync();             // barrier 1: every rep_q is written, every k-step of Zᵀ read
      FPM_PHASE(kPhaseBarrier1);
    }
    // rep[:, cols_r]ᵀ: thread e = (s·4 + t)·rows + c writes the units of rep's
    // rows 16s + 2t, + 1, + 8, + 9 at column c, each row from the block that
    // owns it
    const int rn = row_units(n), quads_n = 4 * kn;
    uint4* const cw = reinterpret_cast<uint4*>(cols);
    for (int e = threadIdx.x; e < s.rows * quads_n; e += blockDim.x) {
      const int st = e / s.rows, c = e - st * s.rows;
      const int i0 = 16 * (st >> 2) + 2 * (st & 3), q0 = i0 / s.nr;
      float2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + (r & 1) + ((r >> 1) << 3), q = owner(q0, i, s.nr);
        v[r] = i < n ? cluster.map_shared_rank(s.img, q)[(i - q * s.nr) * n + s.row0 + c]
                     : make_float2(0.f, 0.f);
      }
      put_row4(cw, rn, c, st, v);
    }
    __syncthreads();
    FPM_PHASE(kPhaseGatherRep);
    // V[:, cols_r] = Af·rep[:, cols_r]
    tile_product<kPasses, false>(TileA{reinterpret_cast<const uint4*>(s.af), kn},
                                 RowB{reinterpret_cast<const uint4*>(cols), rn},
                                 OutF32<false>{vcols, s.nrp}, b, s.rows, n);
    if (solo) {
      __syncthreads();
    } else {
      FPM_PHASE_SYNC(kPhaseProduct3);
      cluster.sync();             // barrier 2: every V[:, cols_q] is written, every rep_q read
      FPM_PHASE(kPhaseBarrier2);
    }
    // V[slab r, :]: thread e = i·4kn + s·4 + t writes the units of V's columns
    // 16s + 2t, + 1, + 8, + 9 at row i, each column from the block that owns it
    for (int e = threadIdx.x; e < s.brows * quads_n; e += blockDim.x) {
      const int i = e / quads_n, st = e - i * quads_n;
      const int k0 = 16 * (st >> 2) + 2 * (st & 3), q0 = k0 / s.nr;
      float2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + (r & 1) + ((r >> 1) << 3), q = owner(q0, k, s.nr);
        v[r] = k < n ? cluster.map_shared_rank(vcols, q)[(s.brow0 + i) * s.nrp + k - q * s.nr]
                     : make_float2(0.f, 0.f);
      }
      put_row4(cw, rn, i, st, v);
    }
    __syncthreads();
    FPM_PHASE(kPhaseGatherV);
    // up[slab r]ᵀ = Bfᵀ·V[slab r, :]ᵀ
    tile_product<kPasses, true>(TileA{reinterpret_cast<const uint4*>(s.bf), kn},
                                RowB{reinterpret_cast<const uint4*>(cols), rn},
                                OutF32<true>{s.img, b}, b, s.brows, n);
    __syncthreads();
    FPM_PHASE(kPhaseProduct4);
  }
}

// Per-element increments of one LED on this block's slab of bbox rows, from
// the window oc (re-read from O, which no block has changed since
// led_forward read it), up[slab r] (s.img) and the pupil/support at the
// chunk (K1, K3) or step (K2) start:
//   diff = up − oc∘P
//   dO   = diff · |P|·conj(P) / (max|P| · (|P|² + delta2))       (fpmMain.cpp:404-419)
//   num  = diff · |oc|·conj(oc) · support / (|oc|² + delta1)     (fpmMain.cpp:457-472,
//          everything but the 1/max|O| factor)
// Writes num[l], l counting from the slab's first element, and dO either
// to d_obj[l] (K1, K3; both may be shared or global memory) or, when d_obj
// is null, straight into the window: ow += dO (K2; ow_re/ow_im are O's
// planes, and every element of the window is read and written by one thread
// of one block). When ``metrics``, adds each segment of its bbox rows'
// Σ|dO|² to s.usum (one warp per 32-column segment, as led_forward's
// residual). led_increments_at<A> is the same with the stage of ablation A
// turned off; the main kernels call led_increments. Under kNoWindowRead oc
// is read at O's corner and, in K2, a cluster barrier parts every read of
// the corner from the window updates (dO waits in s.img), which may overlap it.
template <int A>
__device__ __forceinline__ void led_increments_at(
    const LedSmem s, const float* o_re, const float* o_im, int ld, int y0, int x0, int b,
    const float* p_re, const float* p_im, const float* __restrict__ sup, float pmax,
    float delta1, float delta2, bool metrics, float2* d_obj, float2* num, float* ow_re,
    float* ow_im) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int segs = segments(b);
  for (int t = warp; t < s.brows * segs; t += warps) {
    const int r = t / segs, j = 32 * (t - r * segs) + lane;
    float uacc = 0.f;
    if (j < b) {
      const int l = r * b + j;
      const int i = s.brow0 + r, e = i * b + j;
      const float2 up = s.img[l];
      const size_t g = (size_t)(y0 + i) * ld + (x0 + j);
      const size_t gr = A == kNoWindowRead ? (size_t)i * ld + j : g;   // where oc is read
      const float2 oc = make_float2(ld_state(o_re + gr), ld_state(o_im + gr));
      const float2 p = make_float2(ld_state(p_re + e), ld_state(p_im + e));
      const float2 ocp = cmul(oc, p);
      const float2 diff = make_float2(up.x - ocp.x, up.y - ocp.y);

      const float pabs2 = p.x * p.x + p.y * p.y;
      const float pabs = sqrtf(pabs2);
      const float recip_o = 1.f / (pmax * (pabs2 + delta2));
      const float2 w = make_float2(pabs * p.x * recip_o, -pabs * p.y * recip_o);
      const float2 dob = cmul(diff, w);

      const float oabs2 = oc.x * oc.x + oc.y * oc.y;
      const float oabs = sqrtf(oabs2);
      const float rp = sup[e] / (oabs2 + delta1);
      const float2 v = make_float2(oabs * oc.x * rp, -oabs * oc.y * rp);

      if (d_obj) {
        d_obj[l] = dob;
      } else if constexpr (A == kNoWindowRead) {
        s.img[l] = dob;
      } else if constexpr (A != kNoWindowWrite) {
        ow_re[g] = oc.x + dob.x;
        ow_im[g] = oc.y + dob.y;
      }
      if constexpr (A != kNoPupilAcc) num[l] = cmul(diff, v);
      if (metrics) uacc = fmaf(dob.x, dob.x, dob.y * dob.y);
    }
    if (metrics) {
      uacc = warp_sum(uacc);
      if (lane == 0) s.usum[t] += uacc;
    }
  }
  if constexpr (A == kNoWindowRead) {
    if (d_obj) return;
    cg::this_cluster().sync();   // every block has read the corner
    for (int l = threadIdx.x; l < s.brows * b; l += blockDim.x) {
      const size_t g = (size_t)(y0 + s.brow0 + l / b) * ld + (x0 + l % b);
      ow_re[g] = ld_state(ow_re + g) + s.img[l].x;
      ow_im[g] = ld_state(ow_im + g) + s.img[l].y;
    }
  }
}

__device__ void led_increments(const LedSmem s, const float* o_re, const float* o_im, int ld,
                               int y0, int x0, int b, const float* p_re, const float* p_im,
                               const float* __restrict__ sup, float pmax, float delta1,
                               float delta2, bool metrics, float2* d_obj, float2* num,
                               float* ow_re, float* ow_im) {
  led_increments_at<kMain>(s, o_re, o_im, ld, y0, x0, b, p_re, p_im, sup, pmax, delta1, delta2,
                           metrics, d_obj, num, ow_re, ow_im);
}

// Stores this block's segment accumulators into the cluster's first block,
// at their segments' places in the whole LED (s.sums: the n image rows,
// then the b bbox rows). All threads of all blocks call it after a barrier
// that follows the last addition to the accumulators; a cluster barrier
// must follow before the first block reads s.sums (ordered_sum).
__device__ inline void send_segment_sums(const LedSmem s, int n, int b) {
  cg::cluster_group cluster = cg::this_cluster();
  float* const first = cluster.map_shared_rank(s.sums, 0);
  const int sn = segments(n), sb = segments(b);
  for (int e = threadIdx.x; e < s.rows * sn; e += blockDim.x)
    first[s.row0 * sn + e] = s.rsum[e];
  for (int e = threadIdx.x; e < s.brows * sb; e += blockDim.x)
    first[n * sn + s.brow0 * sb + e] = s.usum[e];
}

// Σ v[0..count) in an order fixed by the index alone (lane l adds v[l],
// v[l+32], ... in turn, then the warp's xor butterfly): one warp calls, and
// every lane gets the sum.
__device__ inline float ordered_sum(const float* v, int count) {
  float acc = 0.f;
  for (int i = threadIdx.x & 31; i < count; i += 32) acc += v[i];
  return warp_sum(acc);
}

}  // namespace fpm

// Every library built from a source that includes this header exports its
// own copy, so each wrapper can name the error its launches returned.
extern "C" const char* fpm_cuda_error_string(int err) {
  if (err == fpm::kErrLedSmem)
    return "Np too large: one LED's slabs of the n×n image plane (img and the gathered rep "
           "columns), of the n×b half-transform T and of the b×b window Z do not fit a "
           "block's shared memory at any cluster size";
  if (err == fpm::kErrCluster)
    return "a thread-block cluster of the size asked for cannot be resident on this card";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
