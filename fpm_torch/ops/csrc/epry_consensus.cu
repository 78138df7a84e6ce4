// The consensus of one chunk of the sharded sweeps, on one card: what the
// ranks' K3 calls (epry_increments.cu) returned, reduced over the mesh and
// applied to the state the card's ranks share.
//
// Replaces no Pallas kernel: in fpm_tpu's one compiled program of a mesh
// run these are XLA's fused collectives and element-wise ops,
// fpm_tpu/parallel/led_shard.py:112-141 (_consensus_psum, _apply_consensus)
// and fpm_tpu/parallel/tile_shard.py:200-254 (_tile_consensus_apply). The
// port ran them as eager ops that the host enqueued per rank and chunk
// (psums that added the payloads one by one, the apply, max|O|, the pupil
// step, the metric sums); each entry point below is one launch per card and
// chunk, on the stream the caller gives (the mesh's comm lane).
//
// The arithmetic is the eager chain's, op for op, so the results are its
// bits (ops/kernels.py consensus_*_plain is that chain):
//   * a psum adds the payloads of its group in rank order in f32,
//     ((x0 + x1) + x2) + ...; on the bf16 wire each payload is first rounded
//     to bf16 (round to nearest even, as torch's .to(bfloat16)) unless it
//     arrived as bf16;
//   * O' = O + d; on the tile axis d is the tile's own rows of its psum, and
//     the reverse halo adds to its first rows, hop by hop, the psum of tile
//     i−j's halo rows, itself rounded to bf16 on the bf16 wire;
//   * max|O'| with c10::complex<float>'s std::abs (hypotf), as torch.abs of
//     a complex tensor; a max has no order, and NaN wins as in torch.max;
//   * the pupil step P' = P + α·((s·v) / (max, 0)) with c10::complex<float>
//     from torch's own headers: the scale s = (scale, 0) times v (torch's mul
//     with a Python float), the division of numpy's algorithm (torch's div by
//     a real tensor promoted to complex), and the add's α = (1, 0);
//   * the metric sums in rank order, added to the sweep's accumulator
//     (0 + sums on the first chunk).
//
// fpm_consensus_led (LED axis): one launch, no grid barrier. Every block
// adds its elements of O', writes its max to scratch and the bbox pupil
// sums of its elements to scratch, then takes a ticket (atomicInc, which
// wraps to 0 for the next launch); the last block to finish reduces the
// blocks' maxima and makes the pupil step and the metric sums. So the grid
// never waits on a block that is not resident, and it shares the card with
// the next chunk's K3 under the stale consensus (a cooperative grid would
// wait until all of its blocks fit).
// fpm_consensus_tile_object (tile axis): the same object phase for each row
// tile that the card holds (blockIdx.y), each tile's max|O'| by its own
// ticket. The pmax over the tile axis, a collective, comes between it and
// fpm_consensus_tile_pupil: max over the tiles' maxima in tile order, then
// the pupil step and the metric sums of the (led, tile) group.
//
// Bound: bytes. The L payloads of d are read once (R·NL·8 bytes each in f32,
// half on the bf16 wire), O read and O' written once; the pupil's L payloads
// and the state are b·b·8 bytes each. No operation count comes near.

#include <c10/util/complex.h>

#include "epry_common.cuh"

namespace fpm {

constexpr int kConsensusThreads = 512;
constexpr int kMaxRanks = 32;    // payloads of one reduction
constexpr int kMaxTiles = 8;     // row tiles of one card, and tiles of one group
constexpr int kMaxHops = kMaxTiles - 1;

using cfloat = c10::complex<float>;

// One reduction's payloads on this card, in rank order: f32 values, or bf16
// values where bit r of ``bf16`` is set (a payload that travelled on the
// wire). Each is (2, rows, cols) planes, or one value (the metrics, the
// tiles' maxima).
struct Payloads {
  const void* p[kMaxRanks];
  unsigned bf16;
  int count;
};

// Payload r's element i as the sum takes it: on the bf16 wire an f32 value
// is rounded to bf16 first.
__device__ __forceinline__ float payload_at(const Payloads& l, int r, size_t i, bool wire) {
  if ((l.bf16 >> r) & 1u) return __bfloat162float(static_cast<const __nv_bfloat16*>(l.p[r])[i]);
  const float x = static_cast<const float*>(l.p[r])[i];
  return wire ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Σ_r payload_r[i], in rank order.
__device__ __forceinline__ float rank_sum(const Payloads& l, size_t i, bool wire) {
  float acc = payload_at(l, 0, i, wire);
  for (int r = 1; r < l.count; ++r) acc = acc + payload_at(l, r, i, wire);
  return acc;
}

__device__ __forceinline__ float wire_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.maximum's max: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

__device__ float block_nan_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The pupil step and the metric sums of a consensus. ``pc``, ``pc_out``:
// (2, b, b) planes of the centered bbox pupil; ``v``: its numerators' payloads
// (or, with ``vsum``, their sums already made); ``resid``, ``upd``: the
// metric payloads; ``acc_in`` the sweep's metric sums so far (null on the
// first chunk: 0), ``acc_out`` the new ones (``metrics`` 0: not this card's).
struct Pupil {
  const float* pc;
  float* pc_out;
  int bb;
  Payloads v, resid, upd;
  const float* acc_in;
  float* acc_out;
  float* omax_out;
  float scale;
  int wire, metrics;
};

__device__ void pupil_step(const Pupil& a, const float* vsum, float omax, int tid, int threads) {
  const cfloat scale(a.scale, 0.f), alpha(1.f, 0.f), denom(omax, 0.f);
  for (int e = tid; e < a.bb; e += threads) {
    const float vr = vsum ? ld_state(vsum + e) : rank_sum(a.v, e, a.wire);
    const float vi = vsum ? ld_state(vsum + a.bb + e) : rank_sum(a.v, (size_t)a.bb + e, a.wire);
    const cfloat step = (scale * cfloat(vr, vi)) / denom;
    const cfloat p = cfloat(a.pc[e], a.pc[a.bb + e]) + alpha * step;
    a.pc_out[e] = p.real();
    a.pc_out[a.bb + e] = p.imag();
  }
  if (tid == 0) {
    *a.omax_out = omax;
    if (a.metrics) {
      const float resid = rank_sum(a.resid, 0, false), upd = rank_sum(a.upd, 0, false);
      a.acc_out[0] = (a.acc_in ? a.acc_in[0] : 0.f) + resid;
      a.acc_out[1] = (a.acc_in ? a.acc_in[1] : 0.f) + upd;
    }
  }
}

// One row tile (the whole spectrum on the LED axis) of this card: its state
// ``o`` → ``o_out``, (2, s, nl) planes; its max|O'| into ``max_out`` (tile
// axis; the LED axis writes Pupil::omax_out); the
// index in Tiles::src of its group's payloads (``own``) and of tile i−j's
// for hop j (``halo[j − 1]``).
struct Tile {
  const float* o;
  float* o_out;
  float* max_out;
  int own;
  int halo[kMaxHops];
};

struct Tiles {
  Payloads src[kMaxTiles];   // each (2, r_ext, nl): a group's d payloads
  Tile tile[kMaxTiles];
  int s, nl, r_ext, n_hops, wire;
  int hop_lo[kMaxHops], hop_rows[kMaxHops];
};

// O' = O + d over this block's share of tile ``t``'s elements; returns the
// block's max|O'| (every thread gets it).
__device__ float object_phase(const Tiles& a, int t, float* red) {
  const Tile& tl = a.tile[t];
  const Payloads& own = a.src[tl.own];
  const bool wire = a.wire != 0;
  const int n = a.s * a.nl;
  const size_t pplane = (size_t)a.r_ext * a.nl;
  float m = 0.f;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    float dr = rank_sum(own, e, wire), di = rank_sum(own, pplane + e, wire);
    const int r = e / a.nl;
    for (int h = 0; h < a.n_hops; ++h) {   // the reverse halo, hop by hop
      if (r >= a.hop_rows[h]) continue;
      const Payloads& src = a.src[tl.halo[h]];
      const size_t i = (size_t)(a.s + a.hop_lo[h]) * a.nl + e;
      float br = rank_sum(src, i, wire), bi = rank_sum(src, pplane + i, wire);
      if (wire) {
        br = wire_round(br);
        bi = wire_round(bi);
      }
      dr = dr + br;
      di = di + bi;
    }
    const float re = tl.o[e] + dr, im = tl.o[n + e] + di;
    tl.o_out[e] = re;
    tl.o_out[n + e] = im;
    m = nan_max(m, std::abs(cfloat(re, im)));
  }
  return block_nan_max(m, red);
}

// This block's max into ``block_max[blockIdx.x]``, after every thread's
// writes are fenced; true in the block that finishes last (``ticket`` back
// at 0 for the next launch), which then sees every block's writes.
__device__ bool last_block(float m, float* block_max, unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    block_max[blockIdx.x] = m;
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The max of the blocks' maxima, in the last block.
__device__ float grid_max(const float* block_max, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
    m = nan_max(m, ld_state(block_max + i));
  return block_nan_max(m, red);
}

__global__ void __launch_bounds__(kConsensusThreads)
consensus_led(Tiles a, Pupil pu, float* vsum, float* block_max, unsigned* ticket) {
  __shared__ float red[32];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, threads = gridDim.x * blockDim.x;
  for (int e = tid; e < pu.bb; e += threads) {   // the pupil numerators' sums, for the last block
    vsum[e] = rank_sum(pu.v, e, pu.wire);
    vsum[pu.bb + e] = rank_sum(pu.v, (size_t)pu.bb + e, pu.wire);
  }
  const float m = object_phase(a, 0, red);
  if (!last_block(m, block_max, ticket)) return;
  pupil_step(pu, vsum, grid_max(block_max, red), threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kConsensusThreads)
consensus_tile_object(Tiles a, float* block_max, unsigned* ticket) {
  __shared__ float red[32];
  const int t = blockIdx.y;
  const float m = object_phase(a, t, red);
  float* const maxima = block_max + (size_t)t * gridDim.x;
  if (!last_block(m, maxima, ticket + t)) return;
  const float omax = grid_max(maxima, red);
  if (threadIdx.x == 0) *a.tile[t].max_out = omax;
}

__global__ void __launch_bounds__(kConsensusThreads)
consensus_tile_pupil(Pupil pu, Payloads maxima) {
  float omax = static_cast<const float*>(maxima.p[0])[0];
  for (int t = 1; t < maxima.count; ++t)   // the pmax over the tile axis, in tile order
    omax = nan_max(omax, static_cast<const float*>(maxima.p[t])[0]);
  pupil_step(pu, nullptr, omax, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

inline int set_payloads(Payloads* l, const void* const* p, unsigned bf16, int count) {
  if (count < 1 || count > kMaxRanks) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < count; ++r) l->p[r] = p[r];
  l->bf16 = bf16;
  l->count = count;
  return 0;
}

inline int set_pupil(Pupil* a, const float* pc, float* pc_out, int bb, const void* const* v,
                     unsigned v_bf16, const void* const* resid, const void* const* upd,
                     int count, const float* acc_in, float* acc_out, float* omax_out,
                     float scale, int wire, int metrics) {
  *a = Pupil{pc, pc_out, bb, {}, {}, {}, acc_in, acc_out, omax_out, scale, wire, metrics};
  if (const int e = set_payloads(&a->v, v, v_bf16, count)) return e;
  if (!metrics) return 0;
  if (const int e = set_payloads(&a->resid, resid, 0u, count)) return e;
  return set_payloads(&a->upd, upd, 0u, count);
}

// Blocks of an object phase over ``n`` elements: enough for one element a
// thread, at most ``max_blocks`` (the caller's scratch of block maxima).
inline int object_blocks(int n, int max_blocks) {
  const int want = (n + kConsensusThreads - 1) / kConsensusThreads;
  return imax(1, want < max_blocks ? want : max_blocks);
}

}  // namespace fpm

// LED axis: one launch for the (one) group of the card's ranks.
//   o, o_out      (2, n_rows, nl) f32 planes, the state and its successor
//   d             ``count`` pointers to the ranks' object payloads, (2, n_rows,
//                 nl) each, f32 or (bit r of d_bf16) bf16, rank order
//   pc, pc_out    (2, b, b) f32, the bbox pupil and its successor
//   v             ``count`` pointers to the pupil payloads, (2, b, b) each
//   resid, upd    ``count`` pointers to f32 scalars (with ``metrics``)
//   acc_in        (2) f32, the sweep's metric sums so far, or null; acc_out (2)
//   omax_out      (1) f32, max|O'|
//   vsum          (2, b, b) f32 scratch; block_max f32 scratch of max_blocks
//   ticket        u32, 0 between launches (the kernel leaves it 0)
//   launches      host int, incremented at the accepted launch
// Returns a cudaError_t value (0 = the launch was accepted).
extern "C" int fpm_consensus_led(const float* o, float* o_out, int n_rows, int nl,
                                 const void* const* d, unsigned d_bf16, const float* pc,
                                 float* pc_out, int b, const void* const* v, unsigned v_bf16,
                                 const void* const* resid, const void* const* upd, int count,
                                 const float* acc_in, float* acc_out, float* omax_out,
                                 float scale, int wire, int metrics, float* vsum,
                                 float* block_max, unsigned* ticket, int max_blocks, int device,
                                 void* stream, int* launches) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Tiles a{};
  if (const int e = set_payloads(&a.src[0], d, d_bf16, count)) return e;
  a.tile[0] = Tile{o, o_out, nullptr, 0, {}};
  a.s = a.r_ext = n_rows;
  a.nl = nl;
  a.wire = wire;
  Pupil pu;
  if (const int e = set_pupil(&pu, pc, pc_out, b * b, v, v_bf16, resid, upd, count, acc_in,
                              acc_out, omax_out, scale, wire, metrics))
    return e;
  consensus_led<<<object_blocks(n_rows * nl, max_blocks), kConsensusThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, pu, vsum, block_max, ticket);
  return (int)count_launch(launches);
}

// Tile axis, first launch: for each of the card's ``n_tiles`` row tiles t,
// O'_t = O_t + its group's psum of rows [0, s) + the reverse halo, and its
// max|O'_t|.
//   src           n_src × count pointers: the d payloads ((2, r_ext, nl) each,
//                 the halo-extended blocks) of the led groups this card reads,
//                 group after group, each in rank order; src_bf16[g] the
//                 group's bf16 bits
//   o, o_out      n_tiles pointers to (2, s, nl) f32 planes; max_out n_tiles
//                 pointers to one f32 each
//   own           n_tiles group indices; halo n_tiles × n_hops group indices
//                 (tile i−j's group for hop j)
//   hop_lo, hop_rows   each hop's first halo row and its rows
//   block_max     f32 scratch of n_tiles × max_blocks; ticket n_tiles u32, 0
//                 between launches
extern "C" int fpm_consensus_tile_object(const void* const* src, const unsigned* src_bf16,
                                         int n_src, int count, const float* const* o,
                                         float* const* o_out, float* const* max_out,
                                         const int* own, const int* halo, int n_tiles, int s,
                                         int nl, int r_ext, int n_hops, const int* hop_lo,
                                         const int* hop_rows, int wire, float* block_max,
                                         unsigned* ticket, int max_blocks, int device,
                                         void* stream, int* launches) {
  using namespace fpm;
  if (n_src < 1 || n_src > kMaxTiles || n_tiles < 1 || n_tiles > kMaxTiles || n_hops < 0
      || n_hops > kMaxHops)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Tiles a{};
  for (int g = 0; g < n_src; ++g)
    if (const int e = set_payloads(&a.src[g], src + (size_t)g * count, src_bf16[g], count))
      return e;
  for (int t = 0; t < n_tiles; ++t) {
    a.tile[t] = Tile{o[t], o_out[t], max_out[t], own[t], {}};
    for (int h = 0; h < n_hops; ++h) a.tile[t].halo[h] = halo[t * n_hops + h];
  }
  a.s = s;
  a.nl = nl;
  a.r_ext = r_ext;
  a.n_hops = n_hops;
  a.wire = wire;
  for (int h = 0; h < n_hops; ++h) {
    a.hop_lo[h] = hop_lo[h];
    a.hop_rows[h] = hop_rows[h];
  }
  const dim3 grid(object_blocks(s * nl, max_blocks), n_tiles);
  consensus_tile_object<<<grid, kConsensusThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, block_max, ticket);
  return (int)count_launch(launches);
}

// Tile axis, second launch: the (led, tile) group's pupil consensus, with
// max|O'| the max of ``n_maxima`` tile maxima (one f32 each, tile order);
// the arguments as fpm_consensus_led's.
extern "C" int fpm_consensus_tile_pupil(const float* pc, float* pc_out, int b,
                                        const void* const* v, unsigned v_bf16,
                                        const void* const* resid, const void* const* upd,
                                        int count, const void* const* maxima, int n_maxima,
                                        const float* acc_in, float* acc_out, float* omax_out,
                                        float scale, int wire, int metrics, int device,
                                        void* stream, int* launches) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Pupil pu;
  if (const int e = set_pupil(&pu, pc, pc_out, b * b, v, v_bf16, resid, upd, count, acc_in,
                              acc_out, omax_out, scale, wire, metrics))
    return e;
  Payloads m;
  if (const int e = set_payloads(&m, maxima, 0u, n_maxima)) return e;
  const int blocks = imax(1, (b * b + kConsensusThreads - 1) / kConsensusThreads);
  consensus_tile_pupil<<<blocks, kConsensusThreads, 0, static_cast<cudaStream_t>(stream)>>>(pu,
                                                                                            m);
  return (int)count_launch(launches);
}
