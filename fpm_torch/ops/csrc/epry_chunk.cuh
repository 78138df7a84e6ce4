// Device code shared by the two chunk kernels (epry_chunked.cu, K1, which
// applies a chunk's increments; epry_increments.cu, K3, which returns them):
// the per-LED forward launch and the deterministic sums over a chunk's LEDs.
//
// The spectrum block is R rows × Ncols columns (row stride Ncols): the whole
// NL×NL spectrum for K1, any block of it for K3. A patch start is clamped so
// that its n rows lie in [0, R) and its n columns in [0, Ncols).
#pragma once

#include "epry_common.cuh"

namespace fpm {

// grid = C · cs in clusters of cs blocks, one cluster per LED of the chunk
// (LED j = blockIdx.x / cs): the forward pass and the increments
// (epry_common.cuh) from the chunk-start (O, P) into scratch, each block
// writing its slab of bbox rows:
//   d_obj (C, b, b)  dO_j          num (C, b, b)  pupil numerator_j
//   parts (C, 2)     (Σ(A − |img|)², Σ|dO|²) of LED j, zeros unless
//                    ``metrics``: the blocks' shares summed in rank order by
//                    the cluster's first block
// A masked dummy (valid_j = 0) exits at once, before any cluster barrier:
// every block of its cluster sees the same valid_j, so none waits for a
// peer that left, and its frame and start are never read.
__global__ void __launch_bounds__(kThreads)
chunk_forward(const float* o_re, const float* o_im, int n_rows, int n_cols,
              const float* p_re, const float* p_im,
              const float* __restrict__ sup, const float* __restrict__ amps,
              const int* __restrict__ starts, const int* __restrict__ valid,
              DftMats m, int n, int b, int lo, float eps, float delta1, float delta2,
              int metrics, float2* __restrict__ d_obj, float2* __restrict__ num,
              float* __restrict__ parts, LedPlan plan) {
  cg::cluster_group cluster = cg::this_cluster();
  const int j = blockIdx.x / plan.cs;
  const int rank = (int)cluster.block_rank();
  const int bb = b * b;
  if (!valid[j]) {
    if (rank == 0 && threadIdx.x == 0) parts[2 * j] = parts[2 * j + 1] = 0.f;
    return;
  }
  extern __shared__ float4 smem_raw[];
  const LedSmem s = carve_smem(smem_raw, m, n, b, plan, rank);
  const int y0 = clamp_start(starts[2 * j], n_rows, n) + lo;
  const int x0 = clamp_start(starts[2 * j + 1], n_cols, n) + lo;
  float pmax;
  const float resid = led_forward(o_re, o_im, n_cols, y0, x0, p_re, p_im,
                                  amps + ((size_t)j * n + s.row0) * n, n, b, eps,
                                  metrics != 0, s, &pmax);
  const size_t slab = (size_t)j * bb + (size_t)s.brow0 * b;
  const float upd = led_increments(s, o_re, o_im, n_cols, y0, x0, b, p_re, p_im, sup, pmax,
                                   delta1, delta2, metrics != 0, d_obj + slab, num + slab,
                                   nullptr, nullptr);
  if (threadIdx.x == 0) {
    s.share[0] = resid;
    s.share[1] = upd;
  }
  cluster.sync();   // the peers have read this block's slab of V; the shares are written
  if (!metrics) {
    if (rank == 0 && threadIdx.x == 0) parts[2 * j] = parts[2 * j + 1] = 0.f;
    return;
  }
  if (rank == 0 && threadIdx.x == 0) {
    parts[2 * j] = cluster_share_sum(s, 0);
    parts[2 * j + 1] = cluster_share_sum(s, 1);
  }
  cluster.sync();   // no block exits while the first still reads its share
}

// Σ_j valid_j·dO_j over the windows of the chunk that cover block element
// (r, col), in LED order: a gather, so the sum is deterministic and needs no
// atomics. *touched says whether any window covered the element.
__device__ __forceinline__ float2 gather_increments(
    int r, int col, int n_rows, int n_cols, const int* __restrict__ starts,
    const int* __restrict__ valid, int c, int n, int b, int lo,
    const float2* __restrict__ d_obj, bool* touched) {
  float2 acc = make_float2(0.f, 0.f);
  *touched = false;
  for (int j = 0; j < c; ++j) {
    if (!valid[j]) continue;
    const unsigned dy = (unsigned)(r - clamp_start(starts[2 * j], n_rows, n) - lo);
    const unsigned dx = (unsigned)(col - clamp_start(starts[2 * j + 1], n_cols, n) - lo);
    if (dy < (unsigned)b && dx < (unsigned)b) {
      const float2 d = d_obj[(size_t)j * b * b + dy * b + dx];
      acc.x += d.x;
      acc.y += d.y;
      *touched = true;
    }
  }
  return acc;
}

// Σ_j valid_j·v_j[e] over the chunk, in LED order; v is (c, stride) float2.
__device__ __forceinline__ float2 sum_valid(const float2* __restrict__ v, int stride, int e,
                                            const int* __restrict__ valid, int c) {
  float2 acc = make_float2(0.f, 0.f);
  for (int j = 0; j < c; ++j) {
    if (!valid[j]) continue;
    const float2 x = v[(size_t)j * stride + e];
    acc.x += x.x;
    acc.y += x.y;
  }
  return acc;
}

}  // namespace fpm
