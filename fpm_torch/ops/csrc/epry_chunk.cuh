// Device code shared by the two chunk kernels (epry_chunked.cu, K1, which
// applies a chunk's increments; epry_increments.cu, K3, which returns them):
// one LED of a chunk on a cluster (chunk_led) and the deterministic sums
// over a chunk's LEDs.
//
// The spectrum block is R rows × Ncols columns (row stride Ncols): the whole
// NL×NL spectrum for K1, any block of it for K3. A patch start is clamped so
// that its n rows lie in [0, R) and its n columns in [0, Ncols).
#pragma once

#include "epry_common.cuh"

namespace fpm {

// One LED of a chunk on this cluster: slot g = q·C + j, LED j of the chunk
// for problem q. The forward pass (at bf16x3 led_forward_split, at highest
// led_forward: the products of tier T) and the increments (epry_common.cuh)
// from problem q's chunk-start (O, P) into slot g of the scratch, each block
// writing its slab of bbox rows:
//   d_obj (P·C, b, b)  dO_j          num (P·C, b, b)  pupil numerator_j
//   parts (P·C, 2)     (Σ(A − |img|)², Σ|dO|²) of LED j, zeros unless
//                      ``metrics``: the segment sums added in a fixed order
//                      in the cluster's first block (ordered_sum)
// Problem q's spectrum starts at o + q·o_stride (re plane, then the im
// plane n_rows·n_cols further), its pupil at p + q·p_stride (re, then im b·b
// further) and its chunk frames at amps + q·a_stride; the support, starts,
// valid flags and DFT matrices are shared by all problems. No block reads or
// writes another problem's data. A masked dummy (valid_j = 0) returns at
// once, before any cluster barrier: every block of the cluster sees the same
// valid_j, so none waits for a peer that left, and its frame and start are
// never read. Otherwise the LED ends with a cluster barrier, after which no
// peer reads this block's shared memory, so the cluster may start its next
// LED. ``s`` is carve_smem's (CUT: Z cut by rows across the cluster, the
// plan's zcut); A: the ablation (Ablate, epry_common.cuh; kMain in the main
// kernels).
template <int T, bool CUT, int A>
__device__ __forceinline__ void chunk_led(
    const LedSmem& s, int g, int q, int j, const float* o, size_t o_stride, int n_rows,
    int n_cols, const float* p, size_t p_stride, const float* __restrict__ sup,
    const float* __restrict__ amps, size_t a_stride, const int* __restrict__ starts,
    const int* __restrict__ valid, int n, int b, int lo, float eps, float delta1, float delta2,
    int metrics, float2* d_obj, float2* num, float* parts) {
  cg::cluster_group cluster = cg::this_cluster();
  const int bb = b * b;
  float* const part = parts + 2 * (size_t)g;
  if (!valid[j]) {
    if (s.rank == 0 && threadIdx.x == 0) part[0] = part[1] = 0.f;
    return;
  }
  const float* o_re = o + q * o_stride;
  const float* o_im = o_re + (size_t)n_rows * n_cols;
  const float* p_re = p + q * p_stride;
  const float* p_im = p_re + bb;
  zero_segment_sums(s, n, b);
  const int y0 = clamp_start(starts[2 * j], n_rows, n) + lo;
  const int x0 = clamp_start(starts[2 * j + 1], n_cols, n) + lo;
  float pmax;
  const float* const amp = amps + q * a_stride + ((size_t)j * n + s.row0) * n;
  if constexpr (T == kBf16x3)
    led_forward_split<CUT, A>(o_re, o_im, n_cols, y0, x0, p_re, p_im, amp, n, b, eps,
                              metrics != 0, s, &pmax);
  else if constexpr (A == kMain)
    led_forward<T, CUT>(o_re, o_im, n_cols, y0, x0, p_re, p_im, amp, n, b, eps, metrics != 0, s,
                        &pmax);
  else
    led_forward_at<T, CUT, A>(o_re, o_im, n_cols, y0, x0, p_re, p_im, amp, n, b, eps,
                              metrics != 0, s, &pmax);
  const size_t slab = (size_t)g * bb + (size_t)s.brow0 * b;
  if constexpr (A == kMain)
    led_increments(s, o_re, o_im, n_cols, y0, x0, b, p_re, p_im, sup, pmax, delta1, delta2,
                   metrics != 0, d_obj + slab, num + slab, nullptr, nullptr);
  else
    led_increments_at<A>(s, o_re, o_im, n_cols, y0, x0, b, p_re, p_im, sup, pmax, delta1,
                         delta2, metrics != 0, d_obj + slab, num + slab, nullptr, nullptr);
  cluster.sync();   // the peers have read this block's slab of V; the segment sums are final
  if (!metrics) {
    if (s.rank == 0 && threadIdx.x == 0) part[0] = part[1] = 0.f;
    return;
  }
  send_segment_sums(s, n, b);
  cluster.sync();   // every segment's sum is in the first block
  if (s.rank == 0 && threadIdx.x < 32) {
    const float resid = ordered_sum(s.sums, n * segments(n));
    const float upd = ordered_sum(s.sums + n * segments(n), b * segments(b));
    if (threadIdx.x == 0) {
      part[0] = resid;
      part[1] = upd;
    }
  }
}

// Σ_j valid_j·dO_j over the windows of the chunk that cover block element
// (r, col), in LED order: a gather, so the sum is deterministic and needs no
// atomics. *touched says whether any window covered the element. K3's
// gather; K1's apply phase makes the same sums (apply_chunk, epry_chunked.cu).
__device__ __forceinline__ float2 gather_increments(
    int r, int col, int n_rows, int n_cols, const int* __restrict__ starts,
    const int* __restrict__ valid, int c, int n, int b, int lo, const float2* d_obj,
    bool* touched) {
  float2 acc = make_float2(0.f, 0.f);
  *touched = false;
  for (int j = 0; j < c; ++j) {
    if (!valid[j]) continue;
    const unsigned dy = (unsigned)(r - clamp_start(starts[2 * j], n_rows, n) - lo);
    const unsigned dx = (unsigned)(col - clamp_start(starts[2 * j + 1], n_cols, n) - lo);
    if (dy < (unsigned)b && dx < (unsigned)b) {
      const float2 d = ld_state(d_obj + (size_t)j * b * b + dy * b + dx);
      acc.x += d.x;
      acc.y += d.y;
      *touched = true;
    }
  }
  return acc;
}

// Σ_j valid_j·v_j[e] over the chunk, in LED order; v is (c, stride) float2,
// read from L2 (ld_state: K1 reads what other blocks wrote before its last
// grid barrier). A masked slot's value (never written this chunk) is loaded
// too and not added, so that no load waits for a valid flag.
__device__ __forceinline__ float2 sum_valid(const float2* v, int stride, int e,
                                            const int* __restrict__ valid, int c) {
  float2 acc = make_float2(0.f, 0.f);
  for (int j = 0; j < c; ++j) {
    const float2 x = ld_state(v + (size_t)j * stride + e);
    if (!valid[j]) continue;
    acc.x += x.x;
    acc.y += x.y;
  }
  return acc;
}

}  // namespace fpm
