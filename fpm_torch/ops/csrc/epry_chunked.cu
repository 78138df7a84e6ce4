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
//   k1_forward  grid = C, one block per LED: the forward pass and the
//               increments (epry_common.cuh) into scratch; masked dummies
//               exit at once.
//   k1_apply    one thread per spectrum element: O += Σ_j valid_j·dO_j over
//               the windows covering it, in LED order (a gather, so the sum
//               is deterministic, no atomics), then a block max of |O|² and
//               one atomicMax on its float bits (non-negative floats order
//               as unsigned ints) into the chunk's max slot.
//   k1_pupil    one block: the pupil consensus and the metric sums, in LED
//               order.
// Bound: FP32 operations in k1_forward (see epry_common.cuh); the chunk's C
// LEDs run on C SMs at once. k1_apply reads and writes the 1 MB spectrum
// once per chunk.

#include "epry_common.cuh"

namespace fpm {

__global__ void __launch_bounds__(kThreads)
k1_forward(const float* __restrict__ o_re, const float* __restrict__ o_im, int nl,
           const float* __restrict__ p_re, const float* __restrict__ p_im,
           const float* __restrict__ sup, const float* __restrict__ amps,
           const int* __restrict__ starts, const int* __restrict__ valid,
           DftMats m, int n, int b, int lo, float eps, float delta1, float delta2,
           int metrics, float2* __restrict__ d_obj, float2* __restrict__ num,
           float* __restrict__ parts) {
  const int j = blockIdx.x;
  const int bb = b * b;
  if (!valid[j]) {
    if (threadIdx.x == 0) parts[2 * j] = parts[2 * j + 1] = 0.f;
    return;
  }
  extern __shared__ float4 smem_raw[];
  const LedSmem s = carve_smem(smem_raw, n, b);
  const float pmax = pupil_abs_max(p_re, p_im, bb, s.red);
  const int y0 = clamp_start(starts[2 * j], nl, n) + lo;
  const int x0 = clamp_start(starts[2 * j + 1], nl, n) + lo;
  const float resid = led_forward(o_re, o_im, nl, y0, x0, p_re, p_im,
                                  amps + (size_t)j * n * n, m, n, b, eps, metrics != 0, s);
  const float upd = led_increments(s, o_re, o_im, nl, y0, x0, b, p_re, p_im, sup, pmax,
                                   delta1, delta2, metrics != 0, d_obj + (size_t)j * bb,
                                   num + (size_t)j * bb);
  if (threadIdx.x == 0) {
    parts[2 * j] = resid;
    parts[2 * j + 1] = upd;
  }
}

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
    float ar = 0.f, ai = 0.f;
    bool touched = false;
    for (int j = 0; j < c; ++j) {
      if (!valid[j]) continue;
      const unsigned dy = (unsigned)(r - clamp_start(starts[2 * j], nl, n) - lo);
      const unsigned dx = (unsigned)(col - clamp_start(starts[2 * j + 1], nl, n) - lo);
      if (dy < (unsigned)b && dx < (unsigned)b) {
        const float2 d = d_obj[(size_t)j * b * b + dy * b + dx];
        ar += d.x;
        ai += d.y;
        touched = true;
      }
    }
    if (touched) {
      re += ar;
      im += ai;
      o_re[idx] = re;
      o_im[idx] = im;
    }
    m2 = re * re + im * im;
  }
  m2 = block_max(m2, red);
  if (threadIdx.x == 0) atomicMax(omax_bits, __float_as_uint(m2));
}

__global__ void __launch_bounds__(kThreads)
k1_pupil(float* __restrict__ p_re, float* __restrict__ p_im, const int* __restrict__ valid,
         int c, int bb, const float2* __restrict__ num,
         const unsigned int* __restrict__ omax_bits, float scale,
         const float* __restrict__ parts, float* __restrict__ mets, int metrics) {
  const float recip = 1.f / sqrtf(__uint_as_float(*omax_bits));
  for (int e = threadIdx.x; e < bb; e += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j < c; ++j) {
      if (!valid[j]) continue;
      const float2 v = num[(size_t)j * bb + e];
      ar += v.x;
      ai += v.y;
    }
    p_re[e] += scale * (ar * recip);
    p_im[e] += scale * (ai * recip);
  }
  if (metrics && threadIdx.x == 0) {
    float r = mets[0], u = mets[1];
    for (int j = 0; j < c; ++j) {
      if (!valid[j]) continue;
      r += parts[2 * j];
      u += parts[2 * j + 1];
    }
    mets[0] = r;
    mets[1] = u;
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
//   launches           host int, incremented at each accepted launch
// Returns a cudaError_t value (0 = every launch was accepted) or kErrLedSmem.
extern "C" int fpm_k1_sweep(float* o, float* p, const float* sup, const float* amps,
                            const int* starts, const int* valid, const void* ai,
                            const void* bi, const void* af, const void* bf, void* d_obj,
                            void* num, float* parts, unsigned int* omax_bits, float* mets,
                            int n_chunks, int c, int n, int b, int lo, int nl, float eps,
                            float delta1, float delta2, float scale, int metrics,
                            int device, void* stream, int* launches) {
  using namespace fpm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  size_t smem = 0;
  if (const int e = set_led_smem(k1_forward, n, b, device, &smem)) return e;
  const size_t plane = (size_t)nl * nl;
  const int bb = b * b;
  const int apply_blocks = (int)((plane + 255) / 256);
  for (int k = 0; k < n_chunks; ++k) {
    const float* a_k = amps + (size_t)k * c * n * n;
    const int* s_k = starts + 2 * k * c;
    const int* v_k = valid + k * c;
    k1_forward<<<c, kThreads, smem, st>>>(o, o + plane, nl, p, p + bb, sup, a_k, s_k, v_k, m, n,
                                          b, lo, eps, delta1, delta2, metrics,
                                          static_cast<float2*>(d_obj), static_cast<float2*>(num),
                                          parts);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
    k1_apply<<<apply_blocks, 256, 0, st>>>(o, o + plane, nl, s_k, v_k, c, n, b, lo,
                                           static_cast<const float2*>(d_obj), omax_bits + k);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
    k1_pupil<<<1, kThreads, 0, st>>>(p, p + bb, v_k, c, bb, static_cast<const float2*>(num),
                                     omax_bits + k, scale, parts, mets, metrics);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  }
  return 0;
}
