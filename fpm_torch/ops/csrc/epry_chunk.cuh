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

// grid = P · C · cs in clusters of cs blocks, one cluster per problem and
// LED of the chunk (cluster g = blockIdx.x / cs is LED j = g mod C of
// problem q = g / C): the forward pass, its products at tier T (Tier), and
// the increments (epry_common.cuh)
// from problem q's chunk-start (O, P) into its scratch, each block writing
// its slab of bbox rows:
//   d_obj (P, C, b, b)  dO_j          num (P, C, b, b)  pupil numerator_j
//   parts (P, C, 2)     (Σ(A − |img|)², Σ|dO|²) of LED j, zeros unless
//                       ``metrics``: the segment sums added in a fixed order
//                       in the cluster's first block (ordered_sum)
// Problem q's spectrum starts at o + q·o_stride (re plane, then the im
// plane n_rows·n_cols further), its pupil at p + q·p_stride (re, then im b·b
// further) and its chunk frames at amps + q·a_stride; the support, starts,
// valid flags and DFT matrices are shared by all problems. No block reads or
// writes another problem's data. A masked dummy (valid_j = 0) exits at once,
// before any cluster barrier: every block of its cluster sees the same
// valid_j, so none waits for a peer that left, and its frame and start are
// never read. CUT: Z is cut by rows across the cluster (the plan's zcut;
// chunk_forward_zcut), else whole in every block (chunk_forward). A: the
// ablation (Ablate, epry_common.cuh; kMain but in chunk_forward_ablate).
template <int T, bool CUT, int A = kMain>
__device__ __forceinline__ void chunk_forward_body(
    const float* o, size_t o_stride, int n_rows, int n_cols, const float* p, size_t p_stride,
    const float* __restrict__ sup, const float* __restrict__ amps, size_t a_stride,
    const int* __restrict__ starts, const int* __restrict__ valid, int c, DftMats m, int n,
    int b, int lo, float eps, float delta1, float delta2, int metrics,
    float2* __restrict__ d_obj, float2* __restrict__ num, float* __restrict__ parts,
    LedPlan plan) {
  cg::cluster_group cluster = cg::this_cluster();
  const int g = blockIdx.x / plan.cs;
  const int q = g / c, j = g - q * c;
  const int rank = (int)cluster.block_rank();
  const int bb = b * b;
  float* const part = parts + 2 * (size_t)g;
  if (!valid[j]) {
    if (rank == 0 && threadIdx.x == 0) part[0] = part[1] = 0.f;
    return;
  }
  const float* o_re = o + q * o_stride;
  const float* o_im = o_re + (size_t)n_rows * n_cols;
  const float* p_re = p + q * p_stride;
  const float* p_im = p_re + bb;
  extern __shared__ float4 smem_raw[];
  const LedSmem s = carve_smem<CUT>(smem_raw, m, n, b, plan, rank, T == kBf16x3);
  const int y0 = clamp_start(starts[2 * j], n_rows, n) + lo;
  const int x0 = clamp_start(starts[2 * j + 1], n_cols, n) + lo;
  float pmax;
  const float* const amp = amps + q * a_stride + ((size_t)j * n + s.row0) * n;
  if constexpr (A == kMain) {
    led_forward<T, CUT>(o_re, o_im, n_cols, y0, x0, p_re, p_im, amp, n, b, eps, metrics != 0, s,
                        &pmax);
  } else {
    led_forward_at<T, CUT, A>(o_re, o_im, n_cols, y0, x0, p_re, p_im, amp, n, b, eps,
                              metrics != 0, s, &pmax);
  }
  const size_t slab = (size_t)g * bb + (size_t)s.brow0 * b;
  if constexpr (A == kMain) {
    led_increments(s, o_re, o_im, n_cols, y0, x0, b, p_re, p_im, sup, pmax, delta1, delta2,
                   metrics != 0, d_obj + slab, num + slab, nullptr, nullptr);
  } else {
    led_increments_at<A>(s, o_re, o_im, n_cols, y0, x0, b, p_re, p_im, sup, pmax, delta1,
                         delta2, metrics != 0, d_obj + slab, num + slab, nullptr, nullptr);
  }
  cluster.sync();   // the peers have read this block's slab of V; the segment sums are final
  if (!metrics) {
    if (rank == 0 && threadIdx.x == 0) part[0] = part[1] = 0.f;
    return;
  }
  send_segment_sums(s, n, b);
  cluster.sync();   // every segment's sum is in the first block
  if (rank == 0 && threadIdx.x < 32) {
    const float resid = ordered_sum(s.sums, n * segments(n));
    const float upd = ordered_sum(s.sums + n * segments(n), b * segments(b));
    if (threadIdx.x == 0) {
      part[0] = resid;
      part[1] = upd;
    }
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
chunk_forward(const float* o, size_t o_stride, int n_rows, int n_cols,
              const float* p, size_t p_stride,
              const float* __restrict__ sup, const float* __restrict__ amps, size_t a_stride,
              const int* __restrict__ starts, const int* __restrict__ valid, int c,
              DftMats m, int n, int b, int lo, float eps, float delta1, float delta2,
              int metrics, float2* __restrict__ d_obj, float2* __restrict__ num,
              float* __restrict__ parts, LedPlan plan) {
  chunk_forward_body<T, false>(o, o_stride, n_rows, n_cols, p, p_stride, sup, amps, a_stride,
                               starts, valid, c, m, n, b, lo, eps, delta1, delta2, metrics,
                               d_obj, num, parts, plan);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
chunk_forward_zcut(const float* o, size_t o_stride, int n_rows, int n_cols,
                   const float* p, size_t p_stride,
                   const float* __restrict__ sup, const float* __restrict__ amps, size_t a_stride,
                   const int* __restrict__ starts, const int* __restrict__ valid, int c,
                   DftMats m, int n, int b, int lo, float eps, float delta1, float delta2,
                   int metrics, float2* __restrict__ d_obj, float2* __restrict__ num,
                   float* __restrict__ parts, LedPlan plan) {
  chunk_forward_body<T, true>(o, o_stride, n_rows, n_cols, p, p_stride, sup, amps, a_stride,
                              starts, valid, c, m, n, b, lo, eps, delta1, delta2, metrics,
                              d_obj, num, parts, plan);
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
