// K1: one chunked Gauss–Seidel-over-Jacobi EPRY sweep, in one launch.
//
// Replaces fpm_tpu/ops/pallas_kernels.py:fused_epry_chunked (body
// _chunked_kernel / _batched_chunk_forward). Semantics of
// models.epry.jacobi_chunk: chunks run in order; inside a chunk every LED's
// increments are computed from the chunk-start (O, P), the object
// increments are summed into O, max|O| is taken over the UPDATED spectrum,
// and P += scale · Σ_j valid_j · num_j / max|O|.
//
// Problem axis: one launch solves P independent problems of one geometry
// (RGB channels, the ROI tiles of a large field of view): each has its own
// O (P, 2, NL, NL), P (P, 2, b, b), frames, scratch, max slots and metrics;
// support, starts, valid flags and DFT matrices are shared. No thread reads
// or writes another problem's data, so problem q's result is bitwise that of
// problem q solved alone.
//
// One launch a sweep on the caller's stream, whatever P and the chunk count:
// k1_sweep, a persistent grid of G clusters of cs blocks, G exactly as many
// as the card holds at once (the plan's ``resident``, CUDA's occupancy
// query), launched cooperatively beside the cluster dimension: the runtime
// then makes every block resident at once or refuses the launch (a grid
// past what the card holds), and a grid barrier
// (cg::this_grid().sync()) waits only on blocks that run.
// The TPU kernel's sequential grid over the chunks (grid=(n_chunks,), the
// spectrum resident through input/output aliasing) becomes a loop inside
// the kernel. Phase 0 makes the working state: O copied from the caller's
// planes to the output, each pupil and the support cropped from the corner
// frame to the centered bbox (the roll and crop of kernels.py
// _pupil_to_bbox), the corner-frame output pupil zeroed outside the bbox,
// the max slots and metrics zeroed. Then each chunk runs three phases; each
// phase ends with a grid-wide barrier (every block's writes before it are
// seen by every block after it):
//   1. forward  cluster g takes slots g, g + G, ... of the chunk's P·C
//               (problem, LED) slots in that fixed order (chunk_led,
//               epry_chunk.cuh): the forward pass and the increments into
//               scratch; a masked dummy is skipped. Each block carves its
//               shared memory and stages its slices of the DFT matrices
//               once a sweep.
//   2. apply    the grid's threads stride over each problem's spectrum: O +=
//               Σ_j valid_j·dO_j over the windows covering an element, in
//               LED order (apply_chunk: a warp walks only the windows that
//               meet its rows), then a block max of |O|² and one atomicMax
//               on its float bits (non-negative floats order as unsigned
//               ints) into the problem's max slot of the chunk.
//   3. pupil    the grid's threads stride over the P bbox pupils: the
//               consensus, summed in LED order (the last chunk's result
//               also into the corner-frame output); the threads past them
//               sum each problem's metrics.
// These are the sums and orders of the three launches a chunk made before
// (the forward, an apply launch, a pupil launch) and the wrapper's copies,
// so the results are bitwise theirs; a max has no order, so it does not
// matter which block reduces which elements. State that crosses a barrier
// (O, P, the scratch, the max slots, the metrics) is read from L2
// (ld_state), never through L1 or the non-coherent path. The last chunk
// needs no third barrier: the kernel's end is one. On the card the sweep is
// this one launch and nothing else (the host's work per sweep: four
// allocations and the call). The support is written in phase 0 and only
// read after its barrier, by no block that read it before in the launch.
// The ablation build (-DFPM_ABLATE) adds k1_sweep_ablate<T, A> and
// k1_sweep_ablate_zcut<T, A> (Z cut by rows where plan_led cuts it for the
// main kernels), the same sweep with the stage of ablation A turned off
// (Ablate, epry_common.cuh), behind fpm_k1_sweep_ablate. Each phase turns
// off what is its own: the forward kNoDft, kNoWindowRead, kNoPupilAcc (no
// numerator) and kDft1Pass; the apply kNoWindowWrite and kOmaxConst; the
// pupil kOmaxConst and kNoPupilAcc.
//
// Bound: FP32 operations (highest) or tensor-core products (bf16x3) in the
// forward phase (see epry_common.cuh). A chunk's P·C LEDs run at once on
// G·cs SMs, cs by plan_led's rule for this grid (kGrid: a part wave costs
// its share of one; 4 at mono chunk 32, where cluster 0 and 1 take two
// LEDs each, 8 at Np 200 chunk 16); the apply phase reads and writes each 1
// MB spectrum once per chunk; each grid barrier costs ~1-2 µs on an H100.

#include "epry_chunk.cuh"

namespace fpm {

// The phases of a chunk in K1's sweep as the grid's first block lives them,
// in the order they run: the one list of them, (identifier, name). Built
// with -DFPM_PROFILE (fpm_torch/ops/build.py, profile_library), its first
// thread adds the SM cycles since the last mark to the phase that just
// ended, after a block barrier (the one difference in schedule from a plain
// build); fpm_phase_read hands the sums out under fpm_phase_name's names.
// The first block's forward phase is its cluster's slots (cluster 0 takes
// the most where the slots do not divide evenly); each grid barrier's time
// is its wait for the slowest block. A plain build compiles the marks away.
#define FPM_K1_PHASES(X)                           \
  X(Forward, "forward: the first cluster's slots") \
  X(Barrier1, "grid barrier 1")                    \
  X(Apply, "apply, max|O|")                        \
  X(Barrier2, "grid barrier 2")                    \
  X(Pupil, "pupil step, metrics")                  \
  X(Barrier3, "grid barrier 3")
enum K1Phase {
#define FPM_K1_PHASE_ID(id, name) kK1Phase##id,
  FPM_K1_PHASES(FPM_K1_PHASE_ID)
#undef FPM_K1_PHASE_ID
  kK1Phases
};
#ifdef FPM_PROFILE
__device__ long long fpm_k1_cycles[kK1Phases];
__device__ long long fpm_k1_last;
#define FPM_K1_START()                                               \
  do {                                                               \
    if (threadIdx.x == 0 && blockIdx.x == 0) fpm_k1_last = clock64(); \
  } while (0)
#define FPM_K1_MARK(i)                               \
  do {                                               \
    __syncthreads();                                 \
    if (threadIdx.x == 0 && blockIdx.x == 0) {       \
      const long long t_ = clock64();                \
      fpm_k1_cycles[i] += t_ - fpm_k1_last;          \
      fpm_k1_last = t_;                              \
    }                                                \
  } while (0)
#else
#define FPM_K1_START()
#define FPM_K1_MARK(i)
#endif

// O += Σ_j valid_j·dO_j on one problem's NL×NL spectrum (planes ``o``, re
// then im), the grid's threads striding over its elements, each element's
// sum over the windows covering it in LED order: gather_increments' sums,
// with the work of a warp's 32 consecutive elements shared: lane l clamps
// window j0 + l of each group of 32 (a masked slot's lies far outside the
// spectrum), a ballot gives the windows that meet the warp's rows, and the
// warp walks only those, in LED order, each lane testing its element.
// WRITE: the object is updated (false: the ablation kNoWindowWrite).
// Returns this thread's max of |O|² over its elements after the update.
// Every lane of a warp calls (the loops are warp-uniform).
template <bool WRITE>
__device__ __forceinline__ float apply_chunk(float* o, int nl, const int* __restrict__ starts,
                                             const int* __restrict__ valid, int c, int n, int b,
                                             int lo, const float2* d_obj, int tid, int threads) {
  constexpr int kFar = -(1 << 29);
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, plane = nl * nl, bb = b * b;
  float* const o_re = o;
  float* const o_im = o + plane;
  // Lane l's window of the group of 32 from j0: its first row and column.
  auto window = [&](int j0, int& wy, int& wx) {
    const int j = j0 + lane;
    wy = wx = kFar;
    if (j < c && valid[j]) {
      wy = clamp_start(starts[2 * j], nl, n) + lo;
      wx = clamp_start(starts[2 * j + 1], nl, n) + lo;
    }
  };
  int wy0, wx0;   // the first group's, kept
  window(0, wy0, wx0);
  float m2 = 0.f;
  for (int i0 = tid - lane; i0 < plane; i0 += threads) {   // warp-uniform
    const int idx = i0 + lane, e = min(idx, plane - 1);
    const int r = e / nl, col = e - r * nl;
    const int r_first = i0 / nl, r_last = min(i0 + 31, plane - 1) / nl;   // the warp's rows
    float re = ld_state(o_re + e), im = ld_state(o_im + e);
    if constexpr (WRITE) {
      float add_re = 0.f, add_im = 0.f;
      bool touched = false;
      for (int j0 = 0; j0 < c; j0 += 32) {
        int wy = wy0, wx = wx0;
        if (j0) window(j0, wy, wx);
        for (unsigned meet = __ballot_sync(kAll, wy <= r_last && r_first < wy + b); meet;
             meet &= meet - 1) {   // in LED order
          const int jj = __ffs(meet) - 1;
          const int y = __shfl_sync(kAll, wy, jj), x = __shfl_sync(kAll, wx, jj);
          const unsigned dy = (unsigned)(r - y), dx = (unsigned)(col - x);
          if (dy < (unsigned)b && dx < (unsigned)b) {
            const float2 d = ld_state(d_obj + (size_t)(j0 + jj) * bb + dy * b + dx);
            add_re += d.x;
            add_im += d.y;
            touched = true;
          }
        }
      }
      if (touched && idx < plane) {
        re += add_re;
        im += add_im;
        o_re[idx] = re;
        o_im[idx] = im;
      }
    }
    if (idx < plane) m2 = fmaxf(m2, re * re + im * im);
  }
  return m2;
}

// The sweep of the header on this block; CUT: Z cut by rows across the
// cluster (the plan's zcut; k1_sweep_zcut), else whole in every block
// (k1_sweep); A: the ablation (kMain but in k1_sweep_ablate).
// The sweep's state: O and the pupils as the caller gives them (o_in, p_in:
// (P, 2, NL, NL) and (P, 2, n, n) corner-frame planes) and as the sweep
// leaves them (o, p_out, the same shapes, written whole); the pupils'
// centered bboxes, (P, 2, b, b), on which the chunks work (p); and the
// support, corner frame (sup_in, n × n) and its bbox (sup, b × b).
struct K1State {
  const float* o_in;
  float* o;
  const float* p_in;
  float* p_out;
  float* p;
  const float* sup_in;
  float* sup;
};

template <int T, bool CUT, int A = kMain>
__device__ __forceinline__ void k1_sweep_body(
    K1State st, int nl, const float* __restrict__ amps,
    const int* __restrict__ starts, const int* __restrict__ valid, int n_problems, int n_chunks,
    int c, DftMats m, int n, int b, int lo, float eps, float delta1, float delta2, float scale,
    int metrics, float2* d_obj, float2* num, float* parts, unsigned* omax_bits, float* mets,
    LedPlan plan) {
  // The forward's ablation: A where the forward turns it off, else none.
  constexpr int F = A == kNoWindowWrite || A == kOmaxConst ? kFull : A;
  extern __shared__ float4 smem_raw[];
  const LedSmem s =
      carve_smem<T, CUT>(smem_raw, m, n, b, plan, (int)cg::this_cluster().block_rank());
  const int clusters = gridDim.x / plan.cs, slots = n_problems * c;
  const int plane = nl * nl, bb = b * b;
  const size_t frames = (size_t)c * n * n, a_stride = (size_t)n_chunks * frames;
  const int threads = gridDim.x * blockDim.x, tid = blockIdx.x * blockDim.x + threadIdx.x;
  float* const o = st.o;
  float* const p = st.p;
  const float* const sup = st.sup;
  cg::grid_group grid = cg::this_grid();
  // 0. The working state, as torch.roll by n/2 and the crop at lo make it
  // (kernels.py _pupil_to_bbox): O copied; each pupil's and the support's
  // bbox element (i, j) from the corner frame's ((lo + i − n/2) mod n,
  // (lo + j − n/2) mod n); p_out zero outside the bbox and the input inside
  // it (the result where no chunk runs; the last chunk's pupil step writes
  // the rest). The max slots and the metrics start at 0. A grid barrier
  // ends it.
  const int half = n / 2, nn = n * n;
  auto wrap = [n](int x) { return ((x % n) + n) % n; };
  for (size_t i = tid; i < (size_t)n_problems * 2 * plane; i += threads) o[i] = st.o_in[i];
  for (int i = tid; i < (n_problems * 2 + 1) * nn; i += threads) {   // the pupils, the support
    const int pl = i / nn, e = i - pl * nn, r = e / n, col = e - r * n;
    const int bi = wrap(r + half - lo), bj = wrap(col + half - lo);
    const bool in = bi < b && bj < b;
    if (pl == n_problems * 2) {
      if (in) st.sup[bi * b + bj] = st.sup_in[e];
      continue;
    }
    const float v = st.p_in[i];
    st.p_out[i] = in ? v : 0.f;
    if (in) p[(size_t)pl * bb + bi * b + bj] = v;
  }
  for (int i = tid; i < n_problems * n_chunks; i += threads) omax_bits[i] = 0u;
  for (int i = tid; i < 2 * n_problems; i += threads) mets[i] = 0.f;
  grid.sync();
  FPM_K1_START();
  for (int k = 0; k < n_chunks; ++k) {
    const int* const s_k = starts + 2 * k * c;
    const int* const v_k = valid + k * c;
    for (int g = blockIdx.x / plan.cs; g < slots; g += clusters) {   // 1. forward
      const int q = g / c;
      chunk_led<T, CUT, F>(s, g, q, g - q * c, o, (size_t)2 * plane, nl, nl, p, (size_t)2 * bb,
                           sup, amps + k * frames, a_stride, s_k, v_k, n, b, lo, eps, delta1,
                           delta2, metrics, d_obj, num, parts);
    }
    FPM_K1_MARK(kK1PhaseForward);
    grid.sync();   // every slot's increments are in scratch; no block reads O any more
    FPM_K1_MARK(kK1PhaseBarrier1);
    for (int q = 0; q < n_problems; ++q) {   // 2. apply
      const float m2 = apply_chunk<A != kNoWindowWrite>(
          o + (size_t)q * 2 * plane, nl, s_k, v_k, c, n, b, lo, d_obj + (size_t)q * c * bb, tid,
          threads);
      if constexpr (A != kOmaxConst) {
        const float block = block_max(m2, s.red);
        if (threadIdx.x == 0) atomicMax(omax_bits + q * n_chunks + k, __float_as_uint(block));
      }
    }
    FPM_K1_MARK(kK1PhaseApply);
    grid.sync();   // O is updated; every problem's max slot of the chunk is final
    FPM_K1_MARK(kK1PhaseBarrier2);
    // 3. pupil: items [0, P·b²) the pupils' elements, then, with metrics, one
    // item per problem for its metrics (threads the pupils leave free)
    const int pupil_items = n_problems * bb;
    for (int i = tid; i < pupil_items + (metrics ? n_problems : 0); i += threads) {
      if (i >= pupil_items) {
        const int q = i - pupil_items;
        const float2 mq = sum_valid(reinterpret_cast<const float2*>(parts) + q * c, 1, 0, v_k, c);
        mets[2 * q] = ld_state(mets + 2 * q) + mq.x;
        mets[2 * q + 1] = ld_state(mets + 2 * q + 1) + mq.y;
        continue;
      }
      if constexpr (A != kNoPupilAcc) {
        const int q = i / bb, e = i - q * bb;
        float* const p_re = p + (size_t)q * 2 * bb;
        float* const p_im = p_re + bb;
        const float recip =
            A == kOmaxConst ? 1.f / (1.f + (float)k)
                            : 1.f / sqrtf(__uint_as_float(ld_state(omax_bits + q * n_chunks + k)));
        const float2 v = sum_valid(num + (size_t)q * c * bb, bb, e, v_k, c);
        const float re = ld_state(p_re + e) + scale * (v.x * recip);
        const float im = ld_state(p_im + e) + scale * (v.y * recip);
        p_re[e] = re;
        p_im[e] = im;
        if (k + 1 == n_chunks) {   // the result, in the corner frame
          const int bi = e / b, at = wrap(lo + bi - half) * n + wrap(lo + e - bi * b - half);
          st.p_out[(size_t)q * 2 * nn + at] = re;
          st.p_out[(size_t)(q * 2 + 1) * nn + at] = im;
        }
      }
    }
    FPM_K1_MARK(kK1PhasePupil);
    if (k + 1 < n_chunks)
      grid.sync();   // P is updated; the scratch is free for the next chunk
    FPM_K1_MARK(kK1PhaseBarrier3);
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
k1_sweep(K1State st, int nl, const float* __restrict__ amps, const int* __restrict__ starts,
         const int* __restrict__ valid, int n_problems, int n_chunks, int c, DftMats m, int n,
         int b, int lo, float eps, float delta1, float delta2, float scale, int metrics,
         float2* d_obj, float2* num, float* parts, unsigned* omax_bits, float* mets,
         LedPlan plan) {
  k1_sweep_body<T, false>(st, nl, amps, starts, valid, n_problems, n_chunks, c, m, n, b,
                          lo, eps, delta1, delta2, scale, metrics, d_obj, num, parts, omax_bits,
                          mets, plan);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
k1_sweep_zcut(K1State st, int nl, const float* __restrict__ amps, const int* __restrict__ starts,
              const int* __restrict__ valid, int n_problems, int n_chunks, int c, DftMats m,
              int n, int b, int lo, float eps, float delta1, float delta2, float scale,
              int metrics, float2* d_obj, float2* num, float* parts, unsigned* omax_bits,
              float* mets, LedPlan plan) {
  k1_sweep_body<T, true>(st, nl, amps, starts, valid, n_problems, n_chunks, c, m, n, b,
                         lo, eps, delta1, delta2, scale, metrics, d_obj, num, parts, omax_bits,
                         mets, plan);
}

#ifdef FPM_ABLATE
template <int T, int A>
__global__ void __launch_bounds__(kThreads)
k1_sweep_ablate(K1State st, int nl, const float* __restrict__ amps, const int* __restrict__ starts,
                const int* __restrict__ valid, int n_problems, int n_chunks, int c, DftMats m,
                int n, int b, int lo, float eps, float delta1, float delta2, float scale,
                int metrics, float2* d_obj, float2* num, float* parts, unsigned* omax_bits,
                float* mets, LedPlan plan) {
  k1_sweep_body<T, false, A>(st, nl, amps, starts, valid, n_problems, n_chunks, c, m, n,
                             b, lo, eps, delta1, delta2, scale, metrics, d_obj, num, parts,
                             omax_bits, mets, plan);
}

template <int T, int A>
__global__ void __launch_bounds__(kThreads)
k1_sweep_ablate_zcut(K1State st, int nl, const float* __restrict__ amps,
                     const int* __restrict__ starts, const int* __restrict__ valid,
                     int n_problems, int n_chunks, int c,
                     DftMats m, int n, int b, int lo, float eps, float delta1, float delta2,
                     float scale, int metrics, float2* d_obj, float2* num, float* parts,
                     unsigned* omax_bits, float* mets, LedPlan plan) {
  k1_sweep_body<T, true, A>(st, nl, amps, starts, valid, n_problems, n_chunks, c, m, n, b,
                            lo, eps, delta1, delta2, scale, metrics, d_obj, num, parts,
                            omax_bits, mets, plan);
}
#endif

// K1's kernels of ablation A, (Z whole, Z cut): the main pair for kMain, the
// ablation build's pair for the others.
template <int T, int A>
KernelPair<decltype(&k1_sweep<T>)> k1_kernels() {
  if constexpr (A == kMain) {
    return {k1_sweep<T>, k1_sweep_zcut<T>};
  } else {
#ifdef FPM_ABLATE
    return {k1_sweep_ablate<T, A>, k1_sweep_ablate_zcut<T, A>};
#endif
  }
}

}  // namespace fpm

// One sweep over ``n_chunks`` chunks of ``c`` LEDs, for each of ``n_problems``
// problems of one geometry.
//   o_in   (P, 2, nl, nl) f32 planes, centered spectra; o the same shape, the
//                         sweep's result (written whole)
//   p_in   (P, 2, n, n)   f32 planes, corner-frame pupils; p_out the same
//                         shape, the result (written whole, zero outside the bbox)
//   p      (P, 2, b, b)   f32 scratch, the pupils' centered bboxes
//   sup_in (n, n)         f32 corner-frame support; sup (b, b) f32 scratch, its bbox
//   amps   (P, n_chunks·c, n, n) f32, chunk-permuted schedule order
//   starts (n_chunks·c·2) int32 patch starts (row, col); valid (n_chunks·c)
//   ai/bi/af/bf           the DFT matrices in the tier's layout (epry_common.cuh)
//   d_obj, num            scratch, (P, c, b, b) complex64 each
//   parts  (P, c, 2) f32 scratch; omax_bits (P, n_chunks) u32 scratch, the
//                         max slots (the kernel zeroes them)
//   mets   (P, 2) f32, written (the kernel zeroes it, then adds each chunk's sums)
//   tier                  Tier of the products: 0 highest, 1 bf16x3
//   force_cs              tests only: the cluster size to take (0 = choose)
//   force_zcut            tests only: Z whole (1) or cut by rows (2) (0 = choose)
//   launches              host int, incremented at each accepted launch
//   plan_out              host int[kPlanFields], set to the plan chosen (export_plan)
// Returns a cudaError_t value (0 = the launch was accepted; the runtime's
// refusal of the cooperative grid, e.g. cudaErrorCooperativeLaunchTooLarge,
// is returned as it is), kErrLedSmem or kErrCluster (no cluster of the plan
// fits the card: the grid, its resident clusters, would be empty). A: the ablation (kMain but behind
// fpm_k1_sweep_ablate, whose kernels take the plan, Z whole or cut, as the
// main ones do).
template <int T, int A>
static int k1_sweep_at(const fpm::K1State& state, const float* amps,
                       const int* starts, const int* valid, const fpm::DftMats& m, void* d_obj,
                       void* num, float* parts, unsigned int* omax_bits, float* mets,
                       int n_problems, int n_chunks, int c, int n, int b, int lo, int nl,
                       float eps, float delta1, float delta2, float scale, int metrics,
                       int device, cudaStream_t st, int force_cs, int force_zcut,
                       int* launches, int* plan_out) {
  using namespace fpm;
  LedPlan plan;
  const auto kernel = k1_kernels<T, A>();
  if (const int e = plan_led<T>(kernel, n, b, n_problems * c, 0, kGrid, force_cs, force_zcut,
                                device, &plan))
    return e;
  export_plan(plan, plan_out);
  if (plan.resident < 1) return kErrCluster;
  const ClusterLaunch sweep(plan.resident, plan, st, /*cooperative=*/true);
  cudaLaunchKernelEx(&sweep.cfg, kernel.of(plan), state, nl, amps, starts, valid, n_problems,
                     n_chunks, c, m, n, b, lo, eps, delta1, delta2, scale, metrics,
                     static_cast<float2*>(d_obj), static_cast<float2*>(num), parts, omax_bits,
                     mets, plan);
  return (int)count_launch(launches);
}

extern "C" int fpm_k1_sweep(const float* o_in, float* o, const float* p_in, float* p_out,
                            float* p, const float* sup_in, float* sup, const float* amps,
                            const int* starts, const int* valid, const void* ai,
                            const void* bi, const void* af, const void* bf, void* d_obj,
                            void* num, float* parts, unsigned int* omax_bits, float* mets,
                            int n_problems, int n_chunks, int c, int n, int b, int lo, int nl,
                            float eps, float delta1, float delta2, float scale, int metrics,
                            int tier, int device, void* stream, int force_cs, int force_zcut,
                            int* launches, int* plan_out) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (n_problems < 1) return (int)cudaErrorInvalidValue;
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  const auto run = tier == kBf16x3   ? &k1_sweep_at<kBf16x3, kMain>
                   : tier == kHighest ? &k1_sweep_at<kHighest, kMain>
                                      : nullptr;
  if (!run) return (int)cudaErrorInvalidValue;
  return run(K1State{o_in, o, p_in, p_out, p, sup_in, sup}, amps, starts, valid, m, d_obj, num,
             parts, omax_bits, mets, n_problems, n_chunks, c, n, b, lo, nl, eps, delta1, delta2,
             scale, metrics, device, static_cast<cudaStream_t>(stream), force_cs, force_zcut,
             launches, plan_out);
}

// How many clusters of cs blocks of K1's sweep at ``tier`` the card holds at
// once for ``slots`` LEDs a chunk (epry_common.cuh resident_clusters; the
// grid the entry point launches at that cs).
extern "C" int fpm_resident_clusters(int n, int b, int slots, int cs, int tier, int device,
                                     int* clusters) {
  using namespace fpm;
  if (tier == kBf16x3)
    return resident_clusters<kBf16x3>(k1_kernels<kBf16x3, kMain>(), n, b, slots, 0, cs, device,
                                      clusters);
  if (tier == kHighest)
    return resident_clusters<kHighest>(k1_kernels<kHighest, kMain>(), n, b, slots, 0, cs, device,
                                       clusters);
  return (int)cudaErrorInvalidValue;
}

#ifdef FPM_ABLATE
// fpm_k1_sweep with the stage of ``ablate`` (Ablate) turned off: the
// arguments of fpm_k1_sweep with ``ablate`` after ``tier``. kDft1Pass is of
// the bf16x3 tier alone (the highest tier's matrices in bf16 are the bf16x3
// layout's hi parts: the wrapper passes those); Z whole or cut by rows as
// in fpm_k1_sweep (force_zcut too).
extern "C" int fpm_k1_sweep_ablate(const float* o_in, float* o, const float* p_in,
                                   float* p_out, float* p, const float* sup_in, float* sup,
                                   const float* amps,
                                   const int* starts, const int* valid, const void* ai,
                                   const void* bi, const void* af, const void* bf, void* d_obj,
                                   void* num, float* parts, unsigned int* omax_bits, float* mets,
                                   int n_problems, int n_chunks, int c, int n, int b, int lo,
                                   int nl, float eps, float delta1, float delta2, float scale,
                                   int metrics, int tier, int ablate, int device, void* stream,
                                   int force_cs, int force_zcut, int* launches, int* plan_out) {
  using namespace fpm;
  using Run = decltype(&k1_sweep_at<kHighest, kMain>);
  static const Run runs[2][7] = {
      {&k1_sweep_at<kHighest, kFull>, &k1_sweep_at<kHighest, kNoDft>,
       &k1_sweep_at<kHighest, kNoWindowRead>, &k1_sweep_at<kHighest, kNoWindowWrite>,
       &k1_sweep_at<kHighest, kOmaxConst>, &k1_sweep_at<kHighest, kNoPupilAcc>, nullptr},
      {&k1_sweep_at<kBf16x3, kFull>, &k1_sweep_at<kBf16x3, kNoDft>,
       &k1_sweep_at<kBf16x3, kNoWindowRead>, &k1_sweep_at<kBf16x3, kNoWindowWrite>,
       &k1_sweep_at<kBf16x3, kOmaxConst>, &k1_sweep_at<kBf16x3, kNoPupilAcc>,
       &k1_sweep_at<kBf16x3, kDft1Pass>}};
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (n_problems < 1 || (tier != kHighest && tier != kBf16x3) || ablate < 0 || ablate > 6
      || !runs[tier][ablate])
    return (int)cudaErrorInvalidValue;
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  return runs[tier][ablate](K1State{o_in, o, p_in, p_out, p, sup_in, sup}, amps, starts, valid, m,
                            d_obj, num, parts, omax_bits, mets, n_problems, n_chunks, c, n, b, lo,
                            nl, eps, delta1, delta2, scale, metrics, device,
                            static_cast<cudaStream_t>(stream), force_cs, force_zcut, launches,
                            plan_out);
}
#endif

#ifdef FPM_PROFILE
extern "C" int fpm_phase_count() { return fpm::kK1Phases; }

// The name of phase ``i`` of a chunk (FPM_K1_PHASES), or null.
extern "C" const char* fpm_phase_name(int i) {
  static const char* const names[] = {
#define FPM_K1_PHASE_NAME(id, name) name,
      FPM_K1_PHASES(FPM_K1_PHASE_NAME)
#undef FPM_K1_PHASE_NAME
  };
  return i >= 0 && i < fpm::kK1Phases ? names[i] : nullptr;
}

// The cycles per phase summed since the last call with ``reset``; waits for
// the device first. ``out`` holds fpm_phase_count() values.
extern "C" int fpm_phase_read(long long* out, int reset) {
  const long long zeros[fpm::kK1Phases] = {0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, fpm::fpm_k1_cycles, sizeof(zeros));
  if (err == cudaSuccess && reset)
    err = cudaMemcpyToSymbol(fpm::fpm_k1_cycles, zeros, sizeof(zeros));
  return (int)err;
}
#endif
