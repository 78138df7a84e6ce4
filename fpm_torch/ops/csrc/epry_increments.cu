// K3: one Jacobi chunk's LOCAL increments from the chunk-start state, with
// nothing applied — the per-rank body of the sharded sweeps.
//
// Replaces fpm_tpu/ops/pallas_kernels.py:fused_chunk_increments (body
// _chunk_inc_kernel). A rank of the LED-sharded sweep holds the whole
// spectrum (R = Ncols = NL); a rank of the tile-sharded sweep holds a
// halo-extended row tile (R = S + Np rows of Ncols = NL columns, patch starts
// relative to the block). The collectives (object psum, global max, pupil
// consensus) come between computing the increments and applying them, so the
// kernel only returns this rank's contributions:
//   d    (2, R, Ncols)  Σ_j valid_j·dO_j window-added into a zeroed block
//   v    (2, b, b)      Σ_j valid_j·num_j, the pupil numerator WITHOUT the
//                       1/max|O| factor (a scalar divide commutes with the sum
//                       over ranks and needs the spectrum after the consensus)
//   mets (2)            (Σ valid·(A − |img|)², Σ valid·|dO|²), zeros unless
//                       ``metrics``
//
// Three launches on the caller's stream:
//   chunk_forward  (epry_chunk.cuh; its LED, chunk_led, is K1's)
//               grid = C·cs, one cluster of cs blocks per LED into scratch;
//               masked dummies skip the LED.
//   k3_gather   one thread per block element: WRITES d = the sum over the
//               windows covering it, in LED order, or 0 (gather_increments):
//               every element is written, so d needs no memset, and the sum
//               is deterministic with no atomics.
//   k3_sums     one thread per bbox element: v, summed in LED order; the
//               first block also sums mets.
// Bound: FP32 operations in chunk_forward (see epry_common.cuh) for the
// rank's C_local LEDs on C_local·cs SMs (cs = 8 at 8 slots). k3_gather reads only the LEDs' scratch
// but writes all of d, R·Ncols·8 bytes per call: most of the call's bytes.
// At bf16x3 the products are K1's and K2's (led_forward_split), but add each
// k-step's sums in IEEE f32 (FPM_KSTEP_SUMS, epry_common.cuh): d and v are
// small differences of large terms.

#define FPM_KSTEP_SUMS 1
#include "epry_chunk.cuh"

namespace fpm {

__global__ void __launch_bounds__(256)
k3_gather(float* __restrict__ d_re, float* __restrict__ d_im, int n_rows, int n_cols,
          const int* __restrict__ starts, const int* __restrict__ valid, int c, int n, int b,
          int lo, const float2* __restrict__ d_obj) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * n_cols) return;
  const int r = idx / n_cols, col = idx - r * n_cols;
  bool touched;
  const float2 d = gather_increments(r, col, n_rows, n_cols, starts, valid, c, n, b, lo,
                                     d_obj, &touched);
  d_re[idx] = d.x;
  d_im[idx] = d.y;
}

__global__ void __launch_bounds__(256)
k3_sums(float* __restrict__ v_re, float* __restrict__ v_im, const int* __restrict__ valid,
        int c, int bb, const float2* __restrict__ num, const float* __restrict__ parts,
        float* __restrict__ mets, int metrics) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < bb) {
    const float2 v = sum_valid(num, bb, e, valid, c);
    v_re[e] = v.x;
    v_im[e] = v.y;
  }
  if (e == 0) {
    float2 m = make_float2(0.f, 0.f);
    if (metrics) m = sum_valid(reinterpret_cast<const float2*>(parts), 1, 0, valid, c);
    mets[0] = m.x;
    mets[1] = m.y;
  }
}

}  // namespace fpm

// One chunk of ``c`` LEDs on one spectrum block.
//   o      (2, n_rows, n_cols) f32 planes, read only
//   p      (2, b, b)   f32 planes, centered bbox pupil, read only
//   sup    (b, b)      f32 centered bbox support
//   amps   (c, n, n) f32; starts (2·c) int32 (row, col) relative to the block;
//   valid  (c) int32, 0 = masked dummy
//   ai/bi/af/bf        the DFT matrices in the tier's layout (epry_common.cuh)
//   d_obj, num         scratch, (c, b, b) complex64 each; parts (c, 2) f32 scratch
//   d_out  (2, n_rows, n_cols) f32, v_out (2, b, b) f32, mets (2) f32: written whole
//   tier               Tier of the products: 0 highest, 1 bf16x3
//   force_cs           tests only: the cluster size to take (0 = choose)
//   force_zcut         tests only: Z whole (1) or cut by rows (2) (0 = choose)
//   launches           host int, incremented at each accepted launch
//   plan_out           host int[kPlanFields], set to the plan chosen (export_plan)
// Returns a cudaError_t value (0 = every launch was accepted), kErrLedSmem or
// kErrCluster.
template <int T>
static int k3_increments_at(const float* o, const float* p, const float* sup, const float* amps,
                            const int* starts, const int* valid, const fpm::DftMats& m,
                            void* d_obj, void* num, float* parts, float* d_out, float* v_out,
                            float* mets, int c, int n, int b, int lo, int n_rows, int n_cols,
                            float eps, float delta1, float delta2, int metrics, int device,
                            cudaStream_t st, int force_cs, int force_zcut, int* launches,
                            int* plan_out) {
  using namespace fpm;
  cudaError_t err;
  LedPlan plan;
  const KernelPair<decltype(&chunk_forward<T>)> kernel{chunk_forward<T>, chunk_forward_zcut<T>};
  if (const int e = plan_led<T>(kernel, n, b, c, 0, kOneShot, force_cs, force_zcut, device, &plan))
    return e;
  export_plan(plan, plan_out);
  const ClusterLaunch forward(c, plan, st);
  const size_t plane = (size_t)n_rows * n_cols;
  const int bb = b * b;
  cudaLaunchKernelEx(&forward.cfg, kernel.of(plan), o, n_rows, n_cols, p, sup, amps, starts,
                     valid, m, n, b, lo, eps, delta1, delta2, metrics,
                     static_cast<float2*>(d_obj), static_cast<float2*>(num), parts, plan);
  if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  k3_gather<<<(int)((plane + 255) / 256), 256, 0, st>>>(
      d_out, d_out + plane, n_rows, n_cols, starts, valid, c, n, b, lo,
      static_cast<const float2*>(d_obj));
  if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  k3_sums<<<(bb + 255) / 256, 256, 0, st>>>(v_out, v_out + bb, valid, c, bb,
                                  static_cast<const float2*>(num), parts, mets, metrics);
  if ((err = count_launch(launches)) != cudaSuccess) return (int)err;
  return 0;
}

extern "C" int fpm_k3_increments(const float* o, const float* p, const float* sup,
                                 const float* amps, const int* starts, const int* valid,
                                 const void* ai, const void* bi, const void* af,
                                 const void* bf, void* d_obj, void* num, float* parts,
                                 float* d_out, float* v_out, float* mets, int c, int n, int b,
                                 int lo, int n_rows, int n_cols, float eps, float delta1,
                                 float delta2, int metrics, int tier, int device, void* stream,
                                 int force_cs, int force_zcut, int* launches,
                                 int* plan_out) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const DftMats m{static_cast<const float2*>(ai), static_cast<const float2*>(bi),
                  static_cast<const float2*>(af), static_cast<const float2*>(bf)};
  const auto run = tier == kBf16x3   ? &k3_increments_at<kBf16x3>
                   : tier == kHighest ? &k3_increments_at<kHighest>
                                      : nullptr;
  if (!run) return (int)cudaErrorInvalidValue;
  return run(o, p, sup, amps, starts, valid, m, d_obj, num, parts, d_out, v_out, mets, c, n, b,
             lo, n_rows, n_cols, eps, delta1, delta2, metrics, device,
             static_cast<cudaStream_t>(stream), force_cs, force_zcut, launches, plan_out);
}
