// K2: one exact sequential (Gauss–Seidel) EPRY sweep.
//
// Replaces fpm_tpu/ops/pallas_kernels.py:fused_epry_sweep (body
// _sweep_kernel). Semantics of models.epry.sweep_sequential: LED k+1 starts
// from the state LED k left, so the sweep is sequential by definition.
//
// Problem axis: one launch solves P independent problems of one geometry
// (RGB channels, the ROI tiles of a large field of view), each with its own
// O, P, frames, row cache and metrics; support, starts and DFT matrices are
// shared. Cluster q walks problem q's LEDs and nothing else: no barrier,
// atomic or read crosses problems, so problem q's result is bitwise that of
// problem q solved alone.
//
// Two launches on the caller's stream, whatever P: k2_rowmax_init (grid
// (NL, P), one block per spectrum row and problem: the row maxima of |O|²,
// the sweep-start cache), then k2_sweep, P persistent clusters of cs blocks,
// cluster q walking problem q's K LEDs in schedule order. Per LED the
// cluster runs the forward pass on its row slabs (epry_common.cuh); each
// block adds its slab of dO into the window
// (led_increments) and takes max|O| over the UPDATED spectrum:
//   global_max = exact: each block re-reduces the window rows it just
//     wrote into the row cache; after a cluster barrier every block
//     reduces the cache (NL values) to the same value (a max has no
//     order) — exact, since no other row changed;
//   global_max = lazy: the frozen sweep-start cache, reduced once.
// Then each block steps its slab of P by num / max|O|, and a cluster
// barrier ends the LED: with the forward pass's two, four cluster barriers
// per LED in all (five with Z cut by rows, k2_sweep_zcut).
//
// State between LEDs (O, P, the row cache) lives in device memory, written
// by one block and read by its peers after the next cluster barrier, whose
// release/acquire orders those accesses; the reads are ld.global.cg
// (ld_state: from L2, never L1 or the non-coherent path) and none of the
// three is const __restrict__ here. What the persistent kernel keeps on
// chip instead is what does not change: each block's slices of the DFT
// matrices, loaded into shared memory once per sweep; and the next LED's
// frame slab, prefetched with cp.async into the second of two buffers
// while this LED's products run (its start is read one LED ahead too).
// The metric sums are per-segment accumulators (epry_common.cuh), added in
// a fixed order in the cluster's first block at the end of the sweep.
//
// The four DFT products: at highest the FP32 cgemm of led_forward; at
// bf16x3 led_forward_split (epry_common.cuh), the tensor-core sums of
// cgemm_tc, bit for bit, on operands that the host (the DFT matrices) and
// the passes that write them (Z, T_r, the gathered rep and V) lay out once
// in the tile and row layouts, whose 16-byte loads are whole mma fragments;
// products 1, 2 and 4 transposed, the slabs' skinny sides on mma's 8-wide
// n. Its buffers and staged matrices are the bf16x3 tier's reckoning
// (so_z_units, stage_count), which K1 and K3 share.
//
// The ablation build (-DFPM_ABLATE) adds k2_sweep_ablate<T, A> and
// k2_sweep_ablate_zcut<T, A>, the same sweep with the stage of ablation A
// turned off (Ablate, epry_common.cuh; kOmaxConst also drops the row-max
// launch), with Z whole or cut by rows as plan_led chooses for the main
// kernels, behind fpm_k2_sweep_ablate.
//
// Bound: FP32 operations of one LED's forward pass on cs SMs of the card's
// 132 — the sweep's data dependence allows one LED of a problem at a time —
// plus four cluster barriers per LED. plan_led picks cs for the P clusters
// (waves of resident clusters weighed by the time of an LED at each cs), so
// P problems fill the card where one uses 8 of its 132 SMs; past one wave
// the clusters wait for SMs.

#include "epry_common.cuh"

namespace fpm {

__global__ void __launch_bounds__(256)
k2_rowmax_init(const float* __restrict__ o, int nl, float* __restrict__ rowmax) {
  __shared__ float red[32];
  const size_t q = blockIdx.y, plane = (size_t)nl * nl;
  const float* const o_re = o + q * 2 * plane;
  const float* const o_im = o_re + plane;
  rowmax += q * nl;
  const size_t base = (size_t)blockIdx.x * nl;
  float m = 0.f;
  for (int c = threadIdx.x; c < nl; c += blockDim.x)
    m = fmaxf(m, o_re[base + c] * o_re[base + c] + o_im[base + c] * o_im[base + c]);
  m = block_max(m, red);
  if (threadIdx.x == 0) rowmax[blockIdx.x] = m;
}

// Starts the copy of this block's rows of one frame into ``dst``, 16 bytes
// at a time where both ends and the count allow; the caller waits for it
// with cp_async_wait before the next block barrier.
__device__ __forceinline__ void prefetch_frame(float* dst, const float* src, int count) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  if (((g | d) & 15) == 0 && (count & 3) == 0) {
    for (int e = 4 * threadIdx.x; e < count; e += 4 * blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 4 * e),
                   "l"(g + 4 * (size_t)e));
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * e),
                   "l"(g + 4 * (size_t)e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 1 / max|O| from the row cache; every thread of the block gets it.
__device__ float recip_abs_max(const float* rowmax, int nl, float* red) {
  float m2 = 0.f;
  for (int r = threadIdx.x; r < nl; r += blockDim.x) m2 = fmaxf(m2, ld_state(rowmax + r));
  return 1.f / sqrtf(block_max(m2, red));
}

// The sweep of one cluster (the header); CUT: Z is cut by rows across the
// cluster (the plan's zcut; k2_sweep_zcut), else whole in every block
// (k2_sweep); A: the ablation (kMain but in k2_sweep_ablate).
template <int T, bool CUT, int A = kMain>
__device__ __forceinline__ void k2_sweep_body(
    float* o, int nl, float* p, const float* __restrict__ sup, const float* __restrict__ amps,
    const int* __restrict__ starts, int k_leds, DftMats m, int n, int b, int lo, float eps,
    float delta1, float delta2, int exact, int metrics, float* rowmax,
    float* __restrict__ mets, LedPlan plan) {
  cg::cluster_group cluster = cg::this_cluster();
  // This cluster's problem: its planes, frames, row cache and metrics.
  const size_t q = blockIdx.x / plan.cs, plane = (size_t)nl * nl;
  float* const o_re = o + q * 2 * plane;
  float* const o_im = o_re + plane;
  float* const p_re = p + q * 2 * b * b;
  float* const p_im = p_re + b * b;
  amps += q * k_leds * n * n;
  rowmax += q * nl;
  mets += 2 * q;
  extern __shared__ float4 smem_raw[];
  const LedSmem s = carve_smem<T, CUT>(smem_raw, m, n, b, plan, (int)cluster.block_rank());
  const int frame_stride = frame_units(n, plan.nr);
  const int slab_count = s.rows * n;           // this block's floats of a frame
  const float* slab0 = amps + (size_t)s.row0 * n;
  float2* num = s.t;                            // free after the fourth product

  // Without room for the two buffers (plan.frames = 0) a frame is read in
  // place from device memory.
  const bool buffered = plan.frames == 2;
  if (buffered) prefetch_frame(s.frame, slab0, slab_count);
  float recip = exact || A == kOmaxConst ? 0.f : recip_abs_max(rowmax, nl, s.red);
  int y_next = starts[0], x_next = starts[1];
  FPM_PHASE_START();
  for (int k = 0; k < k_leds; ++k) {
    const int y0 = clamp_start(y_next, nl, n) + lo;
    const int x0 = clamp_start(x_next, nl, n) + lo;
    const float* amp = buffered ? s.frame + (k & 1) * frame_stride
                                : slab0 + (size_t)k * n * n;
    cp_async_wait();
    __syncthreads();                            // frame k is in shared memory
    if (k + 1 < k_leds) {
      y_next = starts[2 * k + 2];
      x_next = starts[2 * k + 3];
      if (buffered)
        prefetch_frame(s.frame + ((k + 1) & 1) * frame_stride,
                       slab0 + (size_t)(k + 1) * n * n, slab_count);
    }
    FPM_PHASE(kPhaseFrameWait);
    float pmax;
    if constexpr (T == kBf16x3)
      led_forward_split<CUT, A>(o_re, o_im, nl, y0, x0, p_re, p_im, amp, n, b, eps,
                                metrics != 0, s, &pmax);
    else if constexpr (A == kMain)
      led_forward<T, CUT>(o_re, o_im, nl, y0, x0, p_re, p_im, amp, n, b, eps, metrics != 0, s,
                          &pmax);
    else
      led_forward_at<T, CUT, A>(o_re, o_im, nl, y0, x0, p_re, p_im, amp, n, b, eps,
                                metrics != 0, s, &pmax);
    if constexpr (A == kMain)
      led_increments(s, o_re, o_im, nl, y0, x0, b, p_re, p_im, sup, pmax, delta1, delta2,
                     metrics != 0, nullptr, num, o_re, o_im);
    else
      led_increments_at<A>(s, o_re, o_im, nl, y0, x0, b, p_re, p_im, sup, pmax, delta1, delta2,
                           metrics != 0, nullptr, num, o_re, o_im);
    FPM_PHASE_SYNC(kPhaseIncrements);
    if (exact && A != kOmaxConst) {
      __syncthreads();                          // this block wrote all of these rows' updates
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int i = warp; i < s.brows; i += blockDim.x >> 5) {
        const size_t base = (size_t)(y0 + s.brow0 + i) * nl;
        float mr = 0.f;
#pragma unroll 4
        for (int c = lane; c < nl; c += 32) {
          const float re = ld_state(o_re + base + c), im = ld_state(o_im + base + c);
          mr = fmaxf(mr, re * re + im * im);
        }
        for (int o = 16; o > 0; o >>= 1) mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, o));
        if (lane == 0) rowmax[y0 + s.brow0 + i] = mr;
      }
    }
    FPM_PHASE_SYNC(kPhaseRowMax);
    cluster.sync();   // O and the row cache are updated; every slab of V has been read
    FPM_PHASE(kPhaseBarrier3);
    if constexpr (A == kOmaxConst)
      recip = 1.f / (1.f + (float)k);
    else if (exact)
      recip = recip_abs_max(rowmax, nl, s.red);
    FPM_PHASE(kPhaseMaxReduce);
    for (int l = threadIdx.x; l < s.brows * b; l += blockDim.x) {
      const int e = s.brow0 * b + l;
      p_re[e] = ld_state(p_re + e) + num[l].x * recip;
      p_im[e] = ld_state(p_im + e) + num[l].y * recip;
    }
    FPM_PHASE_SYNC(kPhasePupilStep);
    cluster.sync();   // P is updated: the next LED may start
    FPM_PHASE(kPhaseBarrier4);
  }
  if (!metrics) return;
  send_segment_sums(s, n, b);   // the last LED's barrier 4 made the sums final
  cluster.sync();               // every segment's sum is in the first block
  if (s.rank == 0 && threadIdx.x < 32) {
    const float resid = ordered_sum(s.sums, n * segments(n));
    const float upd = ordered_sum(s.sums + n * segments(n), b * segments(b));
    if (threadIdx.x == 0) {
      mets[0] += resid;
      mets[1] += upd;
    }
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
k2_sweep(float* o, int nl, float* p, const float* __restrict__ sup,
         const float* __restrict__ amps, const int* __restrict__ starts, int k_leds, DftMats m,
         int n, int b, int lo, float eps, float delta1, float delta2, int exact, int metrics,
         float* rowmax, float* __restrict__ mets, LedPlan plan) {
  k2_sweep_body<T, false>(o, nl, p, sup, amps, starts, k_leds, m, n, b, lo, eps, delta1, delta2,
                          exact, metrics, rowmax, mets, plan);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
k2_sweep_zcut(float* o, int nl, float* p, const float* __restrict__ sup,
              const float* __restrict__ amps, const int* __restrict__ starts, int k_leds,
              DftMats m, int n, int b, int lo, float eps, float delta1, float delta2, int exact,
              int metrics, float* rowmax, float* __restrict__ mets, LedPlan plan) {
  k2_sweep_body<T, true>(o, nl, p, sup, amps, starts, k_leds, m, n, b, lo, eps, delta1, delta2,
                         exact, metrics, rowmax, mets, plan);
}

#ifdef FPM_ABLATE
template <int T, int A>
__global__ void __launch_bounds__(kThreads)
k2_sweep_ablate(float* o, int nl, float* p, const float* __restrict__ sup,
                const float* __restrict__ amps, const int* __restrict__ starts, int k_leds,
                DftMats m, int n, int b, int lo, float eps, float delta1, float delta2,
                int exact, int metrics, float* rowmax, float* __restrict__ mets, LedPlan plan) {
  k2_sweep_body<T, false, A>(o, nl, p, sup, amps, starts, k_leds, m, n, b, lo, eps, delta1,
                             delta2, exact, metrics, rowmax, mets, plan);
}

template <int T, int A>
__global__ void __launch_bounds__(kThreads)
k2_sweep_ablate_zcut(float* o, int nl, float* p, const float* __restrict__ sup,
                     const float* __restrict__ amps, const int* __restrict__ starts, int k_leds,
                     DftMats m, int n, int b, int lo, float eps, float delta1, float delta2,
                     int exact, int metrics, float* rowmax, float* __restrict__ mets,
                     LedPlan plan) {
  k2_sweep_body<T, true, A>(o, nl, p, sup, amps, starts, k_leds, m, n, b, lo, eps, delta1,
                            delta2, exact, metrics, rowmax, mets, plan);
}
#endif

// K2's kernels of ablation A, (Z whole, Z cut): the main pair for kMain, the
// ablation build's pair for the others.
template <int T, int A>
KernelPair<decltype(&k2_sweep<T>)> k2_kernels() {
  if constexpr (A == kMain) {
    return {k2_sweep<T>, k2_sweep_zcut<T>};
  } else {
#ifdef FPM_ABLATE
    return {k2_sweep_ablate<T, A>, k2_sweep_ablate_zcut<T, A>};
#endif
  }
}

}  // namespace fpm

// One sequential sweep over ``k_leds`` LEDs for each of ``n_problems``
// problems of one geometry.
//   o      (P, 2, nl, nl) f32 planes, updated in place
//   p      (P, 2, b, b)   f32 planes, centered bbox pupils, updated in place
//   sup    (b, b)         f32 centered bbox support
//   amps   (P, k_leds, n, n) f32, schedule order; starts (2·k_leds) int32
//   ai/bi/af/bf           the DFT matrices in the tier's layout (epry_common.cuh; at
//                         bf16x3 K2's: Ai in the row layout, Biᵀ, Af, Bfᵀ in the tile
//                         layout, kernels.py _k2_mats)
//   rowmax (P, nl) f32 scratch; mets (P, 2) f32, accumulated into
//   tier               Tier of the products: 0 highest, 1 bf16x3
//   force_cs           tests only: the cluster size to take (0 = choose)
//   force_zcut         tests only: Z whole (1) or cut by rows (2) (0 = choose)
//   launches           host int, incremented at each accepted launch
//   plan_out           host int[kPlanFields], set to the plan chosen (export_plan)
// Returns a cudaError_t value (0 = every launch was accepted), kErrLedSmem or
// kErrCluster. A: the ablation (kMain but behind fpm_k2_sweep_ablate, whose
// kernels take the plan, Z whole or cut, as the main ones do).
template <int T, int A>
static int k2_sweep_at(float* o, float* p, const float* sup, const float* amps, const int* starts,
                       const fpm::DftMats& m, float* rowmax, float* mets, int n_problems,
                       int k_leds, int n, int b, int lo, int nl, float eps, float delta1,
                       float delta2, int exact, int metrics, int device, cudaStream_t st,
                       int force_cs, int force_zcut, int* launches, int* plan_out) {
  using namespace fpm;
  LedPlan plan;
  const auto kernel = k2_kernels<T, A>();
  if (const int e = plan_led<T>(kernel, n, b, n_problems, 2, kPersistent, force_cs, force_zcut,
                                device, &plan))
    return e;
  export_plan(plan, plan_out);
  cudaError_t err;
  if (A != kOmaxConst) {
    k2_rowmax_init<<<dim3(nl, n_problems), 256, 0, st>>>(o, nl, rowmax);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  }
  if (k_leds < 1) return 0;
  const ClusterLaunch sweep(n_problems, plan, st);
  cudaLaunchKernelEx(&sweep.cfg, kernel.of(plan), o, nl, p, sup, amps, starts, k_leds, m, n, b,
                     lo, eps, delta1, delta2, exact, metrics, rowmax, mets, plan);
  if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  return 0;
}

extern "C" int fpm_k2_sweep(float* o, float* p, const float* sup, const float* amps,
                            const int* starts, const void* ai, const void* bi, const void* af,
                            const void* bf, float* rowmax, float* mets, int n_problems,
                            int k_leds, int n, int b, int lo, int nl, float eps, float delta1,
                            float delta2, int exact, int metrics, int tier, int device,
                            void* stream, int force_cs, int force_zcut, int* launches,
                            int* plan_out) {
  using namespace fpm;
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (n_problems < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  const auto run = tier == kBf16x3   ? &k2_sweep_at<kBf16x3, kMain>
                   : tier == kHighest ? &k2_sweep_at<kHighest, kMain>
                                      : nullptr;
  if (!run) return (int)cudaErrorInvalidValue;
  return run(o, p, sup, amps, starts, m, rowmax, mets, n_problems, k_leds, n, b, lo, nl, eps,
             delta1, delta2, exact, metrics, device, st, force_cs, force_zcut, launches, plan_out);
}

// How many clusters of cs blocks of K2 at ``tier`` the card holds at once
// for ``slots`` LEDs (epry_common.cuh resident_clusters; a measurement aid).
extern "C" int fpm_resident_clusters(int n, int b, int slots, int cs, int tier, int device,
                                     int* clusters) {
  using namespace fpm;
  if (tier == kBf16x3)
    return resident_clusters<kBf16x3>(k2_kernels<kBf16x3, kMain>(), n, b, slots, 2, cs, device,
                                      clusters);
  if (tier == kHighest)
    return resident_clusters<kHighest>(k2_kernels<kHighest, kMain>(), n, b, slots, 2, cs, device,
                                       clusters);
  return (int)cudaErrorInvalidValue;
}

#ifdef FPM_ABLATE
// fpm_k2_sweep with the stage of ``ablate`` (Ablate) turned off: the
// arguments of fpm_k2_sweep with ``ablate`` after ``tier``. kNoPupilAcc is
// K1's alone, kDft1Pass is of the bf16x3 tier alone (the highest tier's
// matrices in bf16 are the bf16x3 layout's hi parts: the wrapper passes
// those); Z whole or cut by rows as in fpm_k2_sweep (force_zcut too).
extern "C" int fpm_k2_sweep_ablate(float* o, float* p, const float* sup, const float* amps,
                                   const int* starts, const void* ai, const void* bi,
                                   const void* af, const void* bf, float* rowmax, float* mets,
                                   int n_problems, int k_leds, int n, int b, int lo, int nl,
                                   float eps, float delta1, float delta2, int exact, int metrics,
                                   int tier, int ablate, int device, void* stream, int force_cs,
                                   int force_zcut, int* launches, int* plan_out) {
  using namespace fpm;
  using Run = decltype(&k2_sweep_at<kHighest, kMain>);
  static const Run runs[2][7] = {
      {&k2_sweep_at<kHighest, kFull>, &k2_sweep_at<kHighest, kNoDft>,
       &k2_sweep_at<kHighest, kNoWindowRead>, &k2_sweep_at<kHighest, kNoWindowWrite>,
       &k2_sweep_at<kHighest, kOmaxConst>, nullptr, nullptr},
      {&k2_sweep_at<kBf16x3, kFull>, &k2_sweep_at<kBf16x3, kNoDft>,
       &k2_sweep_at<kBf16x3, kNoWindowRead>, &k2_sweep_at<kBf16x3, kNoWindowWrite>,
       &k2_sweep_at<kBf16x3, kOmaxConst>, nullptr, &k2_sweep_at<kBf16x3, kDft1Pass>}};
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (n_problems < 1 || (tier != kHighest && tier != kBf16x3) || ablate < 0 || ablate > 6
      || !runs[tier][ablate])
    return (int)cudaErrorInvalidValue;
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  return runs[tier][ablate](o, p, sup, amps, starts, m, rowmax, mets, n_problems, k_leds, n, b,
                            lo, nl, eps, delta1, delta2, exact, metrics, device,
                            static_cast<cudaStream_t>(stream), force_cs, force_zcut, launches,
                            plan_out);
}
#endif

#ifdef FPM_PROFILE
extern "C" int fpm_phase_count() { return fpm::kPhases; }

// The name of phase ``i`` of an LED (FPM_PHASES), or null.
extern "C" const char* fpm_phase_name(int i) {
  static const char* const names[] = {
#define FPM_PHASE_NAME(id, name) name,
      FPM_PHASES(FPM_PHASE_NAME)
#undef FPM_PHASE_NAME
  };
  return i >= 0 && i < fpm::kPhases ? names[i] : nullptr;
}

// The cycles per phase summed since the last call with ``reset``; waits for
// the device first. ``out`` holds fpm_phase_count() values.
extern "C" int fpm_phase_read(long long* out, int reset) {
  const long long zeros[fpm::kPhases] = {0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, fpm::fpm_phase_cycles, sizeof(zeros));
  if (err == cudaSuccess && reset)
    err = cudaMemcpyToSymbol(fpm::fpm_phase_cycles, zeros, sizeof(zeros));
  return (int)err;
}
#endif
