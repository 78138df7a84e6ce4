// K2: one exact sequential (Gauss–Seidel) EPRY sweep.
//
// Replaces fpm_tpu/ops/pallas_kernels.py:fused_epry_sweep (body
// _sweep_kernel). Semantics of models.epry.sweep_sequential: LED k+1 starts
// from the state LED k left, so the sweep is sequential by definition.
//
// Launches on the caller's stream: one k2_rowmax_init (one block per
// spectrum row: the row maxima of |O|², the sweep-start cache), then K
// launches of k2_step, one block each, in schedule order. A step runs the
// forward pass (epry_common.cuh), adds dO into the window, and takes
// max|O| over the UPDATED spectrum:
//   global_max = exact: re-reduces the b rows the update touched into the
//     row cache, then reduces the cache (NL values) — exact, since no other
//     row changed;
//   global_max = lazy: reduces the frozen sweep-start cache.
// Then P += num / max|O| and the metrics accumulate.
// Bound: FP32 operations of the forward pass on ONE SM of the card's 132 —
// the sweep's data dependence allows one LED at a time, and this first
// design gives each LED a single block.

#include "epry_common.cuh"

namespace fpm {

__global__ void __launch_bounds__(256)
k2_rowmax_init(const float* __restrict__ o_re, const float* __restrict__ o_im, int nl,
               float* __restrict__ rowmax) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * nl;
  float m = 0.f;
  for (int c = threadIdx.x; c < nl; c += blockDim.x)
    m = fmaxf(m, o_re[base + c] * o_re[base + c] + o_im[base + c] * o_im[base + c]);
  m = block_max(m, red);
  if (threadIdx.x == 0) rowmax[blockIdx.x] = m;
}

__global__ void __launch_bounds__(kThreads)
k2_step(float* o_re, float* o_im, int nl,
        float* __restrict__ p_re, float* __restrict__ p_im, const float* __restrict__ sup,
        const float* __restrict__ amps, const int* __restrict__ starts, int k, DftMats m,
        int n, int b, int lo, float eps, float delta1, float delta2, int exact, int metrics,
        float* rowmax, float* __restrict__ mets) {
  extern __shared__ float4 smem_raw[];
  const LedSmem s = carve_smem(smem_raw, n, b);
  const int bb = b * b;
  const int y0 = clamp_start(starts[2 * k], nl, n) + lo;
  const int x0 = clamp_start(starts[2 * k + 1], nl, n) + lo;

  const float pmax = pupil_abs_max(p_re, p_im, bb, s.red);
  const float resid = led_forward(o_re, o_im, nl, y0, x0, p_re, p_im,
                                  amps + (size_t)k * n * n, m, n, b, eps, metrics != 0, s);
  // dO overwrites ``up`` in s.z element by element; the pupil numerator
  // goes to s.t (free after the last product).
  const float upd = led_increments(s, o_re, o_im, nl, y0, x0, b, p_re, p_im, sup, pmax,
                                   delta1, delta2, metrics != 0, s.z, s.t);

  for (int e = threadIdx.x; e < bb; e += blockDim.x) {
    const int i = e / b, j = e - i * b;
    const size_t g = (size_t)(y0 + i) * nl + (x0 + j);
    o_re[g] += s.z[e].x;
    o_im[g] += s.z[e].y;
  }
  __syncthreads();

  if (exact) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < b; i += blockDim.x >> 5) {
      const size_t base = (size_t)(y0 + i) * nl;
      float mr = 0.f;
      for (int c = lane; c < nl; c += 32)
        mr = fmaxf(mr, o_re[base + c] * o_re[base + c] + o_im[base + c] * o_im[base + c]);
      for (int o = 16; o > 0; o >>= 1) mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, o));
      if (lane == 0) rowmax[y0 + i] = mr;
    }
    __syncthreads();
  }
  float m2 = 0.f;
  for (int r = threadIdx.x; r < nl; r += blockDim.x) m2 = fmaxf(m2, rowmax[r]);
  const float recip = 1.f / sqrtf(block_max(m2, s.red));

  for (int e = threadIdx.x; e < bb; e += blockDim.x) {
    const float2 v = s.t[e];
    p_re[e] += v.x * recip;
    p_im[e] += v.y * recip;
  }
  if (metrics && threadIdx.x == 0) {
    mets[0] += resid;
    mets[1] += upd;
  }
}

}  // namespace fpm

// One sequential sweep over ``k_leds`` LEDs.
//   o      (2, nl, nl) f32 planes, updated in place
//   p      (2, b, b)   f32 planes, centered bbox pupil, updated in place
//   sup    (b, b)      f32 centered bbox support
//   amps   (k_leds, n, n) f32, schedule order; starts (2·k_leds) int32
//   ai/bi/af/bf        complex64 DFT matrices (epry_common.cuh)
//   rowmax (nl) f32 scratch; mets (2) f32, accumulated into
//   launches           host int, incremented at each accepted launch
// Returns a cudaError_t value (0 = every launch was accepted) or kErrLedSmem.
extern "C" int fpm_k2_sweep(float* o, float* p, const float* sup, const float* amps,
                            const int* starts, const void* ai, const void* bi, const void* af,
                            const void* bf, float* rowmax, float* mets, int k_leds, int n,
                            int b, int lo, int nl, float eps, float delta1, float delta2,
                            int exact, int metrics, int device, void* stream, int* launches) {
  using namespace fpm;
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  size_t smem = 0;
  if (const int e = set_led_smem(k2_step, n, b, device, &smem)) return e;
  const size_t plane = (size_t)nl * nl;
  const int bb = b * b;
  k2_rowmax_init<<<nl, 256, 0, st>>>(o, o + plane, nl, rowmax);
  if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  for (int k = 0; k < k_leds; ++k) {
    k2_step<<<1, kThreads, smem, st>>>(o, o + plane, nl, p, p + bb, sup, amps, starts, k, m, n,
                                       b, lo, eps, delta1, delta2, exact, metrics, rowmax, mets);
    if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  }
  return 0;
}
