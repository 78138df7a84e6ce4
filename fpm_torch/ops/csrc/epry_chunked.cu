// K1: one chunked Gauss–Seidel-over-Jacobi EPRY sweep.
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
// Per chunk, three launches on the caller's stream, whatever P:
//   chunk_forward  (epry_chunk.cuh) grid = P·C·cs, one cluster of cs blocks
//               per problem and LED: the forward pass and the increments into
//               scratch; masked dummies exit at once.
//   k1_apply    grid (⌈NL²/256⌉, P), one thread per spectrum element: O +=
//               Σ_j valid_j·dO_j over the windows covering it, in LED order
//               (gather_increments, epry_chunk.cuh), then a block max of
//               |O|² and one atomicMax on its float bits (non-negative floats
//               order as unsigned ints) into the problem's max slot of the
//               chunk.
//   k1_pupil    grid (⌈b²/256⌉, P), one thread per bbox element: the pupil
//               consensus, summed in LED order; the first block of a problem
//               also sums its metrics.
// Bound: FP32 operations in chunk_forward (see epry_common.cuh). The
// chunk's P·C LEDs run at once on P·C·cs SMs, cs the largest cluster size
// with which they still fit one wave of the card (4 at P = 1, chunk 32 on
// 132 SMs; 1 from P = 3 on); past one wave the clusters wait for SMs.
// k1_apply reads and writes each 1 MB spectrum once per chunk.

#include "epry_chunk.cuh"

namespace fpm {

__global__ void __launch_bounds__(256)
k1_apply(float* __restrict__ o, int nl, const int* __restrict__ starts,
         const int* __restrict__ valid, int c, int n, int b, int lo,
         const float2* __restrict__ d_obj, unsigned int* __restrict__ omax_bits,
         int n_chunks) {
  __shared__ float red[32];
  const size_t q = blockIdx.y;
  const size_t plane = (size_t)nl * nl;
  float* const o_re = o + q * 2 * plane;
  float* const o_im = o_re + plane;
  d_obj += q * c * b * b;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float m2 = 0.f;
  if (idx < nl * nl) {
    const int r = idx / nl, col = idx - r * nl;
    float re = o_re[idx], im = o_im[idx];
    bool touched;
    const float2 d = gather_increments(r, col, nl, nl, starts, valid, c, n, b, lo, d_obj,
                                       &touched);
    if (touched) {
      re += d.x;
      im += d.y;
      o_re[idx] = re;
      o_im[idx] = im;
    }
    m2 = re * re + im * im;
  }
  m2 = block_max(m2, red);
  if (threadIdx.x == 0) atomicMax(omax_bits + q * n_chunks, __float_as_uint(m2));
}

__global__ void __launch_bounds__(256)
k1_pupil(float* __restrict__ p, const int* __restrict__ valid, int c, int bb,
         const float2* __restrict__ num, const unsigned int* __restrict__ omax_bits,
         int n_chunks, float scale, const float* __restrict__ parts, float* __restrict__ mets,
         int metrics) {
  const size_t q = blockIdx.y;
  float* const p_re = p + q * 2 * bb;
  float* const p_im = p_re + bb;
  num += q * c * bb;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < bb) {
    const float recip = 1.f / sqrtf(__uint_as_float(omax_bits[q * n_chunks]));
    const float2 v = sum_valid(num, bb, e, valid, c);
    p_re[e] += scale * (v.x * recip);
    p_im[e] += scale * (v.y * recip);
  }
  if (metrics && e == 0) {
    const float2 m = sum_valid(reinterpret_cast<const float2*>(parts) + q * c, 1, 0, valid, c);
    mets[2 * q] += m.x;
    mets[2 * q + 1] += m.y;
  }
}

}  // namespace fpm

// One sweep over ``n_chunks`` chunks of ``c`` LEDs, for each of ``n_problems``
// problems of one geometry.
//   o      (P, 2, nl, nl) f32 planes, updated in place
//   p      (P, 2, b, b)   f32 planes, centered bbox pupils, updated in place
//   sup    (b, b)         f32 centered bbox support
//   amps   (P, n_chunks·c, n, n) f32, chunk-permuted schedule order
//   starts (n_chunks·c·2) int32 patch starts (row, col); valid (n_chunks·c)
//   ai/bi/af/bf           the DFT matrices in the tier's layout (epry_common.cuh)
//   d_obj, num            scratch, (P, c, b, b) complex64 each
//   parts  (P, c, 2) f32 scratch; omax_bits (P, n_chunks) u32, zeroed by the caller
//   mets   (P, 2) f32, accumulated into
//   tier                  Tier of the products: 0 highest, 1 bf16x3
//   force_cs              tests only: the cluster size to take (0 = choose)
//   force_zcut            tests only: Z whole (1) or cut by rows (2) (0 = choose)
//   launches              host int, incremented at each accepted launch
//   plan_out              host int[kPlanFields], set to the plan chosen (export_plan)
// Returns a cudaError_t value (0 = every launch was accepted), kErrLedSmem or
// kErrCluster.
template <int T>
static int k1_sweep_at(float* o, float* p, const float* sup, const float* amps,
                       const int* starts, const int* valid, const fpm::DftMats& m, void* d_obj,
                       void* num, float* parts, unsigned int* omax_bits, float* mets,
                       int n_problems, int n_chunks, int c, int n, int b, int lo, int nl,
                       float eps, float delta1, float delta2, float scale, int metrics,
                       int device, cudaStream_t st, int force_cs, int force_zcut,
                       int* launches, int* plan_out) {
  using namespace fpm;
  cudaError_t err;
  LedPlan plan;
  const KernelPair<decltype(&chunk_forward<T>)> kernel{chunk_forward<T>, chunk_forward_zcut<T>};
  if (const int e = plan_led(kernel, n, b, n_problems * c, 0, false, T, force_cs, force_zcut,
                             device, &plan))
    return e;
  export_plan(plan, plan_out);
  const ClusterLaunch forward(n_problems * c, plan, st);
  const size_t plane = (size_t)nl * nl;
  const int bb = b * b;
  const size_t a_stride = (size_t)n_chunks * c * n * n;
  const dim3 apply_grid((unsigned)((plane + 255) / 256), n_problems);
  const dim3 pupil_grid((bb + 255) / 256, n_problems);
  for (int k = 0; k < n_chunks; ++k) {
    const float* a_k = amps + (size_t)k * c * n * n;
    const int* s_k = starts + 2 * k * c;
    const int* v_k = valid + k * c;
    cudaLaunchKernelEx(&forward.cfg, kernel.of(plan), (const float*)o, 2 * plane, nl, nl,
                       (const float*)p, (size_t)2 * bb, sup, a_k, a_stride, s_k, v_k, c, m, n,
                       b, lo, eps, delta1, delta2, metrics, static_cast<float2*>(d_obj),
                       static_cast<float2*>(num), parts, plan);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
    k1_apply<<<apply_grid, 256, 0, st>>>(o, nl, s_k, v_k, c, n, b, lo,
                                         static_cast<const float2*>(d_obj), omax_bits + k,
                                         n_chunks);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
    k1_pupil<<<pupil_grid, 256, 0, st>>>(p, v_k, c, bb, static_cast<const float2*>(num),
                                         omax_bits + k, n_chunks, scale, parts, mets, metrics);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int fpm_k1_sweep(float* o, float* p, const float* sup, const float* amps,
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
  const auto run = tier == kBf16x3   ? &k1_sweep_at<kBf16x3>
                   : tier == kHighest ? &k1_sweep_at<kHighest>
                                      : nullptr;
  if (!run) return (int)cudaErrorInvalidValue;
  return run(o, p, sup, amps, starts, valid, m, d_obj, num, parts, omax_bits, mets, n_problems,
             n_chunks, c, n, b, lo, nl, eps, delta1, delta2, scale, metrics, device,
             static_cast<cudaStream_t>(stream), force_cs, force_zcut, launches, plan_out);
}

// How many clusters of cs blocks of K1's forward at ``tier`` the card holds
// at once for ``slots`` LEDs (epry_common.cuh resident_clusters; a
// measurement aid).
extern "C" int fpm_resident_clusters(int n, int b, int slots, int cs, int tier, int device,
                                     int* clusters) {
  using namespace fpm;
  if (tier == kBf16x3)
    return resident_clusters(KernelPair<decltype(&chunk_forward<kBf16x3>)>{
                                 chunk_forward<kBf16x3>, chunk_forward_zcut<kBf16x3>},
                             n, b, slots, 0, cs, tier, device, clusters);
  if (tier == kHighest)
    return resident_clusters(KernelPair<decltype(&chunk_forward<kHighest>)>{
                                 chunk_forward<kHighest>, chunk_forward_zcut<kHighest>},
                             n, b, slots, 0, cs, tier, device, clusters);
  return (int)cudaErrorInvalidValue;
}
