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
// One cooperative launch on the caller's stream, k3_chunk: G clusters of
// cs blocks, G = min(C, the clusters of the plan the card holds at once),
// launched cooperatively beside the cluster dimension (as K1's sweep,
// epry_chunked.cu: every block resident at once, or the runtime refuses the
// grid), in two phases with a grid barrier (cg::this_grid().sync()) between:
//   1. forward  cluster g takes slots g, g + G, ... of the chunk (chunk_led,
//               epry_chunk.cuh; its LED is K1's): the forward pass and the
//               increments into scratch; masked dummies skip the LED.
//   2. sums     the grid's threads stride over the block's elements: each
//               WRITES d = the sum over the windows covering it, in LED
//               order, or 0 (gather_increments): every element is written,
//               so d needs no memset, and the sum is deterministic with no
//               atomics; then over the bbox elements: v, summed in LED
//               order; the grid's first thread sums mets.
// These are the sums and orders of the three launches a call made before
// (the forward, a gather launch, a sums launch), so the results are bitwise
// theirs. The scratch that crosses the barrier is read from L2 (ld_state).
// G stays at most C so that the ranks' calls on their streams still share
// the card (a cooperative grid waits until all of its blocks fit).
// Bound: FP32 operations in the forward (see epry_common.cuh) for the
// rank's C_local LEDs on C_local·cs SMs (cs = 8 at 8 slots). The sums phase
// reads only the LEDs' scratch but writes all of d, R·Ncols·8 bytes per
// call: most of the call's bytes.
// At bf16x3 the products are K1's and K2's (led_forward_split), but add each
// k-step's sums in IEEE f32 (FPM_KSTEP_SUMS, epry_common.cuh): d and v are
// small differences of large terms.

#define FPM_KSTEP_SUMS 1
#include "epry_chunk.cuh"

namespace fpm {

// The call of the header on this block; CUT: Z cut by rows across the
// cluster (the plan's zcut; k3_chunk_zcut), else whole in every block.
template <int T, bool CUT>
__device__ __forceinline__ void k3_chunk_body(
    const float* o, int n_rows, int n_cols, const float* p, const float* __restrict__ sup,
    const float* __restrict__ amps, const int* __restrict__ starts,
    const int* __restrict__ valid, int c, DftMats m, int n, int b, int lo, float eps,
    float delta1, float delta2, int metrics, float2* d_obj, float2* num, float* parts,
    float* d_out, float* v_out, float* mets, LedPlan plan) {
  extern __shared__ float4 smem_raw[];
  const LedSmem s =
      carve_smem<T, CUT>(smem_raw, m, n, b, plan, (int)cg::this_cluster().block_rank());
  const int clusters = gridDim.x / plan.cs;
  for (int g = blockIdx.x / plan.cs; g < c; g += clusters)   // 1. forward
    chunk_led<T, CUT, kMain>(s, g, 0, g, o, 0, n_rows, n_cols, p, 0, sup, amps, 0, starts,
                             valid, n, b, lo, eps, delta1, delta2, metrics, d_obj, num, parts);
  cg::this_grid().sync();   // every slot's increments are in scratch
  const int threads = gridDim.x * blockDim.x, tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = n_rows * n_cols, bb = b * b;
  for (int idx = tid; idx < plane; idx += threads) {   // 2. sums
    const int r = idx / n_cols, col = idx - r * n_cols;
    bool touched;
    const float2 d =
        gather_increments(r, col, n_rows, n_cols, starts, valid, c, n, b, lo, d_obj, &touched);
    d_out[idx] = d.x;
    d_out[plane + idx] = d.y;
  }
  for (int e = tid; e < bb; e += threads) {
    const float2 v = sum_valid(num, bb, e, valid, c);
    v_out[e] = v.x;
    v_out[bb + e] = v.y;
  }
  if (tid == 0) {
    float2 mt = make_float2(0.f, 0.f);
    if (metrics) mt = sum_valid(reinterpret_cast<const float2*>(parts), 1, 0, valid, c);
    mets[0] = mt.x;
    mets[1] = mt.y;
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
k3_chunk(const float* o, int n_rows, int n_cols, const float* p, const float* __restrict__ sup,
         const float* __restrict__ amps, const int* __restrict__ starts,
         const int* __restrict__ valid, int c, DftMats m, int n, int b, int lo, float eps,
         float delta1, float delta2, int metrics, float2* d_obj, float2* num, float* parts,
         float* d_out, float* v_out, float* mets, LedPlan plan) {
  k3_chunk_body<T, false>(o, n_rows, n_cols, p, sup, amps, starts, valid, c, m, n, b, lo, eps,
                          delta1, delta2, metrics, d_obj, num, parts, d_out, v_out, mets, plan);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
k3_chunk_zcut(const float* o, int n_rows, int n_cols, const float* p,
              const float* __restrict__ sup, const float* __restrict__ amps,
              const int* __restrict__ starts, const int* __restrict__ valid, int c, DftMats m,
              int n, int b, int lo, float eps, float delta1, float delta2, int metrics,
              float2* d_obj, float2* num, float* parts, float* d_out, float* v_out, float* mets,
              LedPlan plan) {
  k3_chunk_body<T, true>(o, n_rows, n_cols, p, sup, amps, starts, valid, c, m, n, b, lo, eps,
                         delta1, delta2, metrics, d_obj, num, parts, d_out, v_out, mets, plan);
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
//   launches           host int, incremented at the accepted launch
//   plan_out           host int[kPlanFields], set to the plan chosen (export_plan)
// Returns a cudaError_t value (0 = the launch was accepted; the runtime's
// refusal of the cooperative grid is returned as it is), kErrLedSmem or
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
  LedPlan plan;
  const KernelPair<decltype(&k3_chunk<T>)> kernel{k3_chunk<T>, k3_chunk_zcut<T>};
  if (const int e = plan_led<T>(kernel, n, b, c, 0, kOneShot, force_cs, force_zcut, device, &plan))
    return e;
  export_plan(plan, plan_out);
  if (plan.resident < 1) return kErrCluster;
  const ClusterLaunch chunk(imax(1, plan.resident < c ? plan.resident : c), plan, st,
                            /*cooperative=*/true);
  cudaLaunchKernelEx(&chunk.cfg, kernel.of(plan), o, n_rows, n_cols, p, sup, amps, starts, valid,
                     c, m, n, b, lo, eps, delta1, delta2, metrics, static_cast<float2*>(d_obj),
                     static_cast<float2*>(num), parts, d_out, v_out, mets, plan);
  return (int)count_launch(launches);
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
