// K1: one chunked Gauss–Seidel-over-Jacobi EPRY sweep.
//
// Replaces fpm_tpu/ops/pallas_kernels.py:fused_epry_chunked (body
// _chunked_kernel / _batched_chunk_forward). Semantics of
// models.epry.jacobi_chunk: chunks run in order; inside a chunk every LED's
// increments are computed from the chunk-start (O, P), the object
// increments are summed into O, max|O| is taken over the UPDATED spectrum,
// and P += scale · Σ_j valid_j · num_j / max|O|.
//
// Per chunk, three launches on the caller's stream:
//   chunk_forward  (epry_chunk.cuh) grid = C·cs, one cluster of cs blocks
//               per LED: the forward pass and the increments into scratch;
//               masked dummies exit at once.
//   k1_apply    one thread per spectrum element: O += Σ_j valid_j·dO_j over
//               the windows covering it, in LED order (gather_increments,
//               epry_chunk.cuh), then a block max of |O|² and
//               one atomicMax on its float bits (non-negative floats order
//               as unsigned ints) into the chunk's max slot.
//   k1_pupil    one thread per bbox element: the pupil consensus, summed
//               in LED order; the first block also sums the metrics.
// Bound: FP32 operations in chunk_forward (see epry_common.cuh). The
// chunk's C LEDs run at once on C·cs SMs, cs the largest cluster size with
// which the chunk still fits one wave of the card (4 at chunk 32 on 132
// SMs). k1_apply reads and writes the 1 MB spectrum once per chunk.

#include "epry_chunk.cuh"

namespace fpm {

__global__ void __launch_bounds__(256)
k1_apply(float* __restrict__ o_re, float* __restrict__ o_im, int nl,
         const int* __restrict__ starts, const int* __restrict__ valid, int c, int n, int b,
         int lo, const float2* __restrict__ d_obj, unsigned int* __restrict__ omax_bits) {
  __shared__ float red[32];
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
  if (threadIdx.x == 0) atomicMax(omax_bits, __float_as_uint(m2));
}

__global__ void __launch_bounds__(256)
k1_pupil(float* __restrict__ p_re, float* __restrict__ p_im, const int* __restrict__ valid,
         int c, int bb, const float2* __restrict__ num,
         const unsigned int* __restrict__ omax_bits, float scale,
         const float* __restrict__ parts, float* __restrict__ mets, int metrics) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < bb) {
    const float recip = 1.f / sqrtf(__uint_as_float(*omax_bits));
    const float2 v = sum_valid(num, bb, e, valid, c);
    p_re[e] += scale * (v.x * recip);
    p_im[e] += scale * (v.y * recip);
  }
  if (metrics && e == 0) {
    const float2 m = sum_valid(reinterpret_cast<const float2*>(parts), 1, 0, valid, c);
    mets[0] += m.x;
    mets[1] += m.y;
  }
}

}  // namespace fpm

// One sweep over ``n_chunks`` chunks of ``c`` LEDs.
//   o      (2, nl, nl) f32 planes, updated in place
//   p      (2, b, b)   f32 planes, centered bbox pupil, updated in place
//   sup    (b, b)      f32 centered bbox support
//   amps   (n_chunks·c, n, n) f32, chunk-permuted schedule order
//   starts (n_chunks·c·2) int32 patch starts (row, col); valid (n_chunks·c)
//   ai/bi/af/bf        complex64 DFT matrices (epry_common.cuh)
//   d_obj, num         scratch, (c, b, b) complex64 each
//   parts  (c, 2) f32 scratch; omax_bits (n_chunks) u32, zeroed by the caller
//   mets   (2) f32, accumulated into
//   force_cs           tests only: the cluster size to take (0 = choose)
//   launches           host int, incremented at each accepted launch
//   cluster_size       host int, set to the cluster size chosen
// Returns a cudaError_t value (0 = every launch was accepted), kErrLedSmem or
// kErrCluster.
extern "C" int fpm_k1_sweep(float* o, float* p, const float* sup, const float* amps,
                            const int* starts, const int* valid, const void* ai,
                            const void* bi, const void* af, const void* bf, void* d_obj,
                            void* num, float* parts, unsigned int* omax_bits, float* mets,
                            int n_chunks, int c, int n, int b, int lo, int nl, float eps,
                            float delta1, float delta2, float scale, int metrics,
                            int device, void* stream, int force_cs, int* launches,
                            int* cluster_size) {
  using namespace fpm;
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  LedPlan plan;
  if (const int e = plan_led(chunk_forward, n, b, c, 0, force_cs, device, &plan)) return e;
  *cluster_size = plan.cs;
  const ClusterLaunch forward(c, plan, st);
  const size_t plane = (size_t)nl * nl;
  const int bb = b * b;
  const int apply_blocks = (int)((plane + 255) / 256);
  for (int k = 0; k < n_chunks; ++k) {
    const float* a_k = amps + (size_t)k * c * n * n;
    const int* s_k = starts + 2 * k * c;
    const int* v_k = valid + k * c;
    cudaLaunchKernelEx(&forward.cfg, chunk_forward, (const float*)o, (const float*)(o + plane),
                       nl, nl, (const float*)p, (const float*)(p + bb), sup, a_k, s_k, v_k, m,
                       n, b, lo, eps, delta1, delta2, metrics, static_cast<float2*>(d_obj),
                       static_cast<float2*>(num), parts, plan);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
    k1_apply<<<apply_blocks, 256, 0, st>>>(o, o + plane, nl, s_k, v_k, c, n, b, lo,
                                           static_cast<const float2*>(d_obj), omax_bits + k);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
    k1_pupil<<<(bb + 255) / 256, 256, 0, st>>>(p, p + bb, v_k, c, bb, static_cast<const float2*>(num),
                                     omax_bits + k, scale, parts, mets, metrics);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  }
  return 0;
}
