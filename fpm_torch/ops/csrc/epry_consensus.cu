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
// Bound: bytes. The L payloads of d are read once (R·NL·8 bytes each in f32,
// half on the bf16 wire), O read and O' written once; the pupil's L payloads
// and the state are b·b·8 bytes each. No operation count comes near. What
// the design does about it (fpm_consensus_led, C1, and
// fpm_consensus_tile_object, C2, with the host's plan
// kernels.consensus_plan; C3 last):
//   * Each thread of the object phase takes kPerThread elements of a plane:
//     one 16-byte chunk (float4 of f32, 8 bytes of bf16) where NL is a
//     multiple of 4 and every plane is aligned (the vector path), else four
//     elements a block's width apart (the scalar path). It starts the loads
//     of kRankBatch ranks of its group, of its first halo hop's group and of
//     O before it adds any of them, so each SM keeps tens of KB in flight
//     (peer cards' payloads arrive over NVLink, at microseconds a trip).
//   * The phase is a template on the chunk, on the payloads' pattern (all
//     f32, all bf16, mixed: a test a rank, not an element) and on the wire,
//     so the inner loop carries no test of the payloads' type.
//   * max|O'| across the grid is one atomicMax on the float's bits a block,
//     which orders the maxima as floats because |O'| >= 0, and in which a
//     NaN (any sign) wins as in torch.max. The block stores O' as soon as
//     it is made; after the block's reduction (one barrier) thread 0 alone
//     puts the block's max and then its arrival, a release atomic that
//     orders the max before it: one fence a block (C1: an add; C2: an
//     atomicInc that wraps to 0 and also acquires).
//   * C2's tile ends in the block that arrives last: it swaps the tile's
//     maximum for 0 and writes it. C1 has no single-block tail: its last
//     blocks (enough for kPerThread pupil elements a thread) load and add
//     the pupil payloads and P while the object blocks run, then thread 0
//     of each polls (ld.acquire) until every object block has arrived, and
//     they make the pupil step over several SMs. The pupil blocks come last
//     in the grid, so the blocks they wait on are dispatched before them,
//     and they never wait on each other; the last of them to leave puts the
//     words back to 0 for the next launch. A wait unmet after
//     kWaitTimeoutNs traps rather than hang.
//   * No grid barrier and no cooperative launch: a block waits only on
//     object blocks, which wait on nothing, so the grid shares the card with
//     the next chunk's cooperative K3 under the stale consensus (a
//     cooperative grid would wait until all of its blocks fit).
//   * C3 (fpm_consensus_tile_pupil) is the pmax's max over the tiles' maxima
//     in tile order, then the pupil step and the metric sums of the (led,
//     tile) group. Its blocks run the body of C1's pupil blocks
//     (pupil_body) at kPupilPerThread elements a thread (1: 2 and 4 were
//     slower from a peer and on one card; C1's pupil blocks take
//     kPerThread). A block starts every load before it uses
//     any: in thread 0 the tile maxima, in the grid's first thread the
//     sweep's sums and the metric payloads, in every thread the first
//     kRankBatch ranks' numerators and P; so it waits about one round trip
//     (over NVLink where the payloads are peers'), and no load follows the
//     grid's work. The max is thread 0's, handed to its block by one
//     barrier. The host's plan (kernels.pupil_plan) covers b² once, which
//     the C entry checks; no scratch and no wait, so C3 too fits beside the
//     next chunk's K3.

#include <c10/util/complex.h>

#include <cstdint>

#include "epry_common.cuh"

namespace fpm {

constexpr int kConsensusThreads = 256;   // threads a block, C1-C3
constexpr int kPerThread = 4;    // elements of a plane a thread takes (C1, C2)
constexpr int kPupilPerThread = 1;   // C3's (kernels.PUPIL_PER_THREAD)
constexpr int kRankBatch = 4;    // ranks of a group whose loads a thread starts together
constexpr int kMaxRanks = 32;    // payloads of one reduction
constexpr int kMaxTiles = 8;     // row tiles of one card, and tiles of one group
constexpr int kMaxHops = kMaxTiles - 1;
constexpr long long kWaitTimeoutNs = 20LL * 1000 * 1000 * 1000;

using cfloat = c10::complex<float>;

// The phase stamps of one launch, per block (the LED kernel's blocks, or
// the tile kernel's blockIdx.y × gridDim.x + blockIdx.x). Built with
// -DFPM_PROFILE (fpm_torch/ops/build.py, profile_library), thread 0 of each
// block stamps the card's global clock (ns) and its SM's cycle counter
// after a block barrier (the one difference in schedule from a plain
// build) at each mark: the block's start, the end of its payload sums and
// apply (C1's pupil blocks: their pupil sums), the end of its fence and
// ticket (C1's pupil blocks: of their wait), and, in a block that makes the
// tail (the grid's max, the pupil step), the tail's end.
// fpm_consensus_records hands them out. A plain build compiles the marks away.
#define FPM_CONSENSUS_MARKS(X)       \
  X(Start, "start")                  \
  X(Apply, "payload sums and apply") \
  X(Ticket, "fence and ticket")      \
  X(Tail, "tail")
enum Mark {
#define FPM_MARK_ID(id, name) kMark##id,
  FPM_CONSENSUS_MARKS(FPM_MARK_ID)
#undef FPM_MARK_ID
  kMarks
};
#ifdef FPM_PROFILE
constexpr int kRecords = 8 * 1024;
__device__ long long fpm_consensus_stamps[kRecords][2 * kMarks];
#define FPM_MARK(i)                                                          \
  do {                                                                       \
    __syncthreads();                                                         \
    const int r_ = blockIdx.y * gridDim.x + blockIdx.x;                      \
    if (threadIdx.x == 0 && r_ < kRecords) {                                 \
      fpm_consensus_stamps[r_][i] = global_ns();                             \
      fpm_consensus_stamps[r_][kMarks + i] = clock64();                      \
    }                                                                        \
  } while (0)
// A mark reached only where ``cond`` (the same in every thread of the block).
#define FPM_MARK_IF(cond, i) \
  do {                       \
    if (cond) FPM_MARK(i);   \
  } while (0)
#else
#define FPM_MARK(i)
#define FPM_MARK_IF(cond, i)
#endif

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The words of a launch's scratch (ConsensusScratch: two a tile, 0 between
// launches): blocks arrived, and the bits of the max|O'| so far.
enum SyncWord { kArrived = 0, kMaxBits = 1, kSyncWords = 2 };

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// old = *p; *p = old >= wrap ? 0 : old + 1 (acquire and release at once).
__device__ __forceinline__ unsigned inc_acq_rel(unsigned* p, unsigned wrap) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(wrap) : "memory");
  return old;
}

// One reduction's payloads on this card, in rank order: f32 values, or bf16
// values where bit r of ``bf16`` is set (a payload that travelled on the
// wire). Each is (2, rows, cols) planes, or one value (the metrics, the
// tiles' maxima).
struct Payloads {
  const void* p[kMaxRanks];
  unsigned bf16;
  int count;
};

// Which payloads of a launch arrived as bf16 (a template argument of C1's
// and C2's object phase): none, all, or some (bit r of Payloads::bf16).
enum Pattern { kF32 = 0, kBf16 = 1, kMixed = 2, kPatterns = 3 };

template <int P>
__device__ __forceinline__ bool is_bf16(const Payloads& l, int r) {
  return P == kBf16 || (P == kMixed && ((l.bf16 >> r) & 1u));
}

__device__ __forceinline__ float wire_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// W consecutive elements of one payload as loaded: W f32 words, or W bf16
// values in the low then high halves of W / 2 words (one word's low half
// for W = 1).
template <int W>
struct Raw {
  unsigned w[W];
};

template <int W>
__device__ __forceinline__ void load_raw(Raw<W>& x, const void* p, unsigned i, bool bf16) {
  if constexpr (W == 4) {
    if (bf16) {
      const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
      x.w[0] = v.x;
      x.w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(static_cast<const float*>(p) + i);
      x.w[0] = v.x;
      x.w[1] = v.y;
      x.w[2] = v.z;
      x.w[3] = v.w;
    }
  } else {
    x.w[0] = bf16 ? static_cast<const unsigned short*>(p)[i] : static_cast<const unsigned*>(p)[i];
  }
}

// Element k of ``x`` as the sum takes it: a bf16 value
// widened exactly, an f32 value rounded to bf16 on the wire.
template <int W, bool Wire>
__device__ __forceinline__ float raw_value(const Raw<W>& x, int k, bool bf16) {
  if (bf16) return __uint_as_float((W == 4 ? x.w[k >> 1] >> (16 * (k & 1)) : x.w[0]) << 16);
  const float f = __uint_as_float(x.w[k]);
  return Wire ? wire_round(f) : f;
}

// The loads of kRankBatch ranks of a group at a thread's U chunks of W
// elements, real and imaginary planes.
template <int U, int W>
struct Loads {
  Raw<W> re[kRankBatch][U], im[kRankBatch][U];
};

// Start the loads of ranks [r0, r0 + kRankBatch) of ``g`` at the chunks
// ``at`` (the imaginary plane ``plane`` elements further) where ``ok``.
template <int U, int W, int P>
__device__ __forceinline__ void load_ranks(Loads<U, W>& x, const Payloads& g, int r0,
                                           const unsigned (&at)[U], unsigned plane,
                                           const bool (&ok)[U]) {
#pragma unroll
  for (int k = 0; k < kRankBatch; ++k) {
    if (r0 + k >= g.count) break;
    const bool h = is_bf16<P>(g, r0 + k);
    const void* const p = g.p[r0 + k];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u]) {
        load_raw(x.re[k][u], p, at[u], h);
        load_raw(x.im[k][u], p, plane + at[u], h);
      }
  }
}

// Add the loads of ranks [r0, r0 + kRankBatch) to the sums, in rank order
// (rank 0's value starts them).
template <int U, int W, int P, bool Wire>
__device__ __forceinline__ void add_ranks(float (&re)[U][W], float (&im)[U][W],
                                          const Loads<U, W>& x, const Payloads& g, int r0) {
#pragma unroll
  for (int k = 0; k < kRankBatch; ++k) {
    if (r0 + k >= g.count) break;
    const bool h = is_bf16<P>(g, r0 + k);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float vr = raw_value<W, Wire>(x.re[k][u], j, h);
        const float vi = raw_value<W, Wire>(x.im[k][u], j, h);
        re[u][j] = r0 + k == 0 ? vr : re[u][j] + vr;
        im[u][j] = r0 + k == 0 ? vi : im[u][j] + vi;
      }
  }
}

// Σ_r of group ``g`` at the chunks, in rank order: the first batch's loads
// ``first`` already started, the later batches (more than kRankBatch ranks)
// loaded and added batch by batch.
template <int U, int W, int P, bool Wire>
__device__ __forceinline__ void group_sum(float (&re)[U][W], float (&im)[U][W],
                                          const Loads<U, W>& first, const Payloads& g,
                                          const unsigned (&at)[U], unsigned plane,
                                          const bool (&ok)[U]) {
  add_ranks<U, W, P, Wire>(re, im, first, g, 0);
  for (int r0 = kRankBatch; r0 < g.count; r0 += kRankBatch) {
    Loads<U, W> x;
    load_ranks<U, W, P>(x, g, r0, at, plane, ok);
    add_ranks<U, W, P, Wire>(re, im, x, g, r0);
  }
}

// torch.maximum's max: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// The block's max of ``v``, in thread 0 (one barrier).
__device__ float block_nan_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kConsensusThreads / 32; ++w) v = nan_max(v, red[w]);
  return v;
}

// The pupil step and the metric sums of a consensus. ``pc``, ``pc_out``:
// (2, b, b) planes of the centered bbox pupil; ``v``: its numerators'
// payloads; ``resid``, ``upd``: the metric payloads; ``acc_in`` the sweep's
// metric sums so far (null on the first chunk: 0), ``acc_out`` the new ones
// (``metrics`` 0: not this card's).
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

// One element's pupil step, from its numerator's sum (vr, vi).
__device__ __forceinline__ cfloat pupil_at(const Pupil& a, float vr, float vi, float pr, float pi,
                                           float omax) {
  const cfloat scale(a.scale, 0.f), alpha(1.f, 0.f), denom(omax, 0.f);
  const cfloat step = (scale * cfloat(vr, vi)) / denom;
  return cfloat(pr, pi) + alpha * step;
}

// The metric sums' operands: the sweep's sums so far and the psums of the
// metric payloads (read by one thread; ``metrics`` 0: none), f32 values
// added in rank order. load_metrics starts the loads of the sums so far and
// of the first kRankBatch ranks' payloads; sum_metrics adds them, and the
// later ranks' batch by batch.
struct Metrics {
  float acc[2], sum[2];
};

struct MetricLoads {
  float acc[2], x[2][kRankBatch];
};

__device__ __forceinline__ void metric_batch(float (&x)[2][kRankBatch], const Pupil& a, int r0) {
#pragma unroll
  for (int k = 0; k < kRankBatch; ++k)
    if (r0 + k < a.resid.count) {
      x[0][k] = *static_cast<const float*>(a.resid.p[r0 + k]);
      x[1][k] = *static_cast<const float*>(a.upd.p[r0 + k]);
    }
}

__device__ __forceinline__ MetricLoads load_metrics(const Pupil& a) {
  MetricLoads l{};
  if (!a.metrics) return l;
  l.acc[0] = a.acc_in ? a.acc_in[0] : 0.f;
  l.acc[1] = a.acc_in ? a.acc_in[1] : 0.f;
  metric_batch(l.x, a, 0);
  return l;
}

__device__ __forceinline__ Metrics sum_metrics(const Pupil& a, const MetricLoads& l) {
  Metrics m{{l.acc[0], l.acc[1]}, {}};
  if (!a.metrics) return m;
  float x[2][kRankBatch];
  for (int r0 = 0; r0 < a.resid.count; r0 += kRankBatch) {
    if (r0 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < kRankBatch; ++k) x[i][k] = l.x[i][k];
    } else {
      metric_batch(x, a, r0);
    }
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k)
      if (r0 + k < a.resid.count)
#pragma unroll
        for (int i = 0; i < 2; ++i) m.sum[i] = r0 + k == 0 ? x[i][k] : m.sum[i] + x[i][k];
  }
  return m;
}

// max|O'| and the metric sums, written once (by the thread that read ``m``).
__device__ __forceinline__ void write_scalars(const Pupil& a, const Metrics& m, float omax) {
  *a.omax_out = omax;
  if (a.metrics) {
    a.acc_out[0] = m.acc[0] + m.sum[0];
    a.acc_out[1] = m.acc[1] + m.sum[1];
  }
}

// One row tile (the whole spectrum on the LED axis) of this card: its state
// ``o`` → ``o_out``, (2, s, nl) planes; its max|O'| into ``max_out`` (tile
// axis; the LED axis writes Pupil::omax_out); the index in Tiles::src of
// its group's payloads (``own``) and of tile i−j's for hop j
// (``halo[j − 1]``).
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
  int s, nl, r_ext, n_hops;
  int hop_lo[kMaxHops], hop_rows[kMaxHops];
};

// A thread's U chunks of W elements of a tile plane (all W in one row) in
// the block's share of the tile, and their O' = O + d.
template <int U, int W>
struct Chunks {
  unsigned at[U];
  bool ok[U];
  float re[U][W], im[U][W];
};

// The chunks of hop ``h`` among a thread's chunks ``at``: where its rows
// are (the first hop_rows[h] rows of the tile), and where it reads the halo
// rows of its group's payloads.
template <int U>
__device__ __forceinline__ void hop_chunks(const Tiles& a, int h, const unsigned (&at)[U],
                                           const bool (&ok)[U], unsigned (&hat)[U],
                                           bool (&hok)[U]) {
  const unsigned lo = (unsigned)(a.s + a.hop_lo[h]) * a.nl, rows = (unsigned)a.hop_rows[h] * a.nl;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    hok[u] = ok[u] && at[u] < rows;
    hat[u] = lo + at[u];
  }
}

// The chunks' O' into tile ``t``'s o_out.
template <int U, int W>
__device__ __forceinline__ void store_chunks(const Tiles& a, int t, const Chunks<U, W>& c) {
  float* const out = a.tile[t].o_out;
  const unsigned n = (unsigned)a.s * a.nl;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c.ok[u]) {
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(out + c.at[u]) =
            make_float4(c.re[u][0], c.re[u][1], c.re[u][2], c.re[u][3]);
        *reinterpret_cast<float4*>(out + n + c.at[u]) =
            make_float4(c.im[u][0], c.im[u][1], c.im[u][2], c.im[u][3]);
      } else {
        out[c.at[u]] = c.re[u][0];
        out[n + c.at[u]] = c.im[u][0];
      }
    }
}

// O' = O + d at this block's chunks of tile ``t`` (the plan's blocks cover
// the tile, kPerThread elements a thread: the vector path (U, W) = (1, 4),
// the scalar path (4, 1)), stored as soon as they are made; returns the
// thread's max|O'|.
template <int U, int W, int P, bool Wire>
__device__ float object_phase(const Tiles& a, int t) {
  static_assert(U * W == kPerThread, "kPerThread elements a thread");
  const Tile& tl = a.tile[t];
  const Payloads& own = a.src[tl.own];
  const unsigned n = (unsigned)a.s * a.nl, plane = (unsigned)a.r_ext * a.nl;
  Chunks<U, W> c;
  unsigned hat[U];
  bool hok[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    c.at[u] = ((blockIdx.x * U + u) * kConsensusThreads + threadIdx.x) * W;
    c.ok[u] = c.at[u] < n;
  }
  // Every load of the first round before any add: the own group's first
  // batch, the first hop's, O.
  Loads<U, W> x_own, x_hop;
  load_ranks<U, W, P>(x_own, own, 0, c.at, plane, c.ok);
  if (a.n_hops > 0) {
    hop_chunks(a, 0, c.at, c.ok, hat, hok);
    load_ranks<U, W, P>(x_hop, a.src[tl.halo[0]], 0, hat, plane, hok);
  }
  float o_re[U][W], o_im[U][W];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c.ok[u]) {
      if constexpr (W == 4) {
        const float4 r = *reinterpret_cast<const float4*>(tl.o + c.at[u]);
        const float4 i = *reinterpret_cast<const float4*>(tl.o + n + c.at[u]);
        o_re[u][0] = r.x, o_re[u][1] = r.y, o_re[u][2] = r.z, o_re[u][3] = r.w;
        o_im[u][0] = i.x, o_im[u][1] = i.y, o_im[u][2] = i.z, o_im[u][3] = i.w;
      } else {
        o_re[u][0] = tl.o[c.at[u]];
        o_im[u][0] = tl.o[n + c.at[u]];
      }
    }
  float dr[U][W], di[U][W];
  group_sum<U, W, P, Wire>(dr, di, x_own, own, c.at, plane, c.ok);
  for (int h = 0; h < a.n_hops; ++h) {   // the reverse halo, hop by hop
    const Payloads& src = a.src[tl.halo[h]];
    if (h > 0) {
      hop_chunks(a, h, c.at, c.ok, hat, hok);
      load_ranks<U, W, P>(x_hop, src, 0, hat, plane, hok);
    }
    float br[U][W], bi[U][W];
    group_sum<U, W, P, Wire>(br, bi, x_hop, src, hat, plane, hok);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (hok[u]) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          dr[u][j] = dr[u][j] + (Wire ? wire_round(br[u][j]) : br[u][j]);
          di[u][j] = di[u][j] + (Wire ? wire_round(bi[u][j]) : bi[u][j]);
        }
      }
  }
  float m = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c.ok[u]) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        c.re[u][j] = o_re[u][j] + dr[u][j];
        c.im[u][j] = o_im[u][j] + di[u][j];
        m = nan_max(m, std::abs(cfloat(c.re[u][j], c.im[u][j])));
      }
    }
  store_chunks(a, t, c);
  return m;
}

// How C1's pupil blocks obtain max|O'|: thread 0 polls (ld.acquire) until
// the ``blocks`` object blocks have arrived and reads their max; each
// pupil block arrives again as it leaves, and the last one to leave puts
// ``sync`` back to 0.
struct ArrivedMax {
  unsigned* sync;
  int blocks, n_pupil;

  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ float get() const {
    const long long t0 = global_ns();
    while (ld_acquire(sync + kArrived) < (unsigned)blocks)
      if (global_ns() - t0 > kWaitTimeoutNs) __trap();
    return __uint_as_float(ld_relaxed(sync + kMaxBits));
  }
  // Thread 0 leaves before its stores, which its release would wait for.
  __device__ __forceinline__ void leave() const {
    if (add_release(sync + kArrived, 1) == (unsigned)(blocks + n_pupil - 1)) {
      sync[kArrived] = 0;   // every block has read both words
      sync[kMaxBits] = 0;
    }
  }
};

// How C3's blocks obtain max|O'|: thread 0 starts the loads of the first
// kMaxTiles tile maxima with the block's other loads, and after the sums
// takes their nan_max in tile order (more maxima, rarely: loaded then).
struct TileMaxima {
  const Payloads& m;
  float x[kMaxTiles];

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t)
      if (t < m.count) x[t] = *static_cast<const float*>(m.p[t]);
  }
  __device__ __forceinline__ float get() const {
    float v = x[0];
#pragma unroll
    for (int t = 1; t < kMaxTiles; ++t)
      if (t < m.count) v = nan_max(v, x[t]);
    for (int t = kMaxTiles; t < m.count; ++t) v = nan_max(v, *static_cast<const float*>(m.p[t]));
    return v;
  }
  __device__ __forceinline__ void leave() const {}
};

// Pupil block ``p`` (of C1's last blocks, or of C3's grid), U elements of
// the pupil a thread: starts the loads of ``omax_of`` (thread 0), of the
// metric operands (the ``writer`` thread), of the first kRankBatch ranks'
// numerators and of P before it uses any; the sums; thread 0 obtains
// max|O'| from ``omax_of`` and one barrier hands it to the block; the
// pupil step, stored; the writer writes max|O'| and the metric sums.
template <int U, bool Wire, class Max>
__device__ __forceinline__ void pupil_body(const Pupil& a, int p, bool writer, Max& omax_of) {
  unsigned at[U];
  bool ok[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    at[u] = (p * U + u) * kConsensusThreads + threadIdx.x;
    ok[u] = at[u] < (unsigned)a.bb;
  }
  if (threadIdx.x == 0) omax_of.start();
  const MetricLoads ml = writer ? load_metrics(a) : MetricLoads{};
  Loads<U, 1> x;
  load_ranks<U, 1, kMixed>(x, a.v, 0, at, a.bb, ok);
  float pr[U], pi[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) {
      pr[u] = a.pc[at[u]];
      pi[u] = a.pc[a.bb + at[u]];
    }
  const Metrics mets = writer ? sum_metrics(a, ml) : Metrics{};
  float vr[U][1], vi[U][1];
  group_sum<U, 1, kMixed, Wire>(vr, vi, x, a.v, at, a.bb, ok);
  FPM_MARK(kMarkApply);
  __shared__ float omax_s;
  if (threadIdx.x == 0) omax_s = omax_of.get();
  __syncthreads();
  const float omax = omax_s;
  FPM_MARK(kMarkTicket);
  cfloat q[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) q[u] = pupil_at(a, vr[u][0], vi[u][0], pr[u], pi[u], omax);
  if (threadIdx.x == 0) omax_of.leave();
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) {
      a.pc_out[at[u]] = q[u].real();
      a.pc_out[a.bb + at[u]] = q[u].imag();
    }
  if (writer) write_scalars(a, mets, omax);
  FPM_MARK(kMarkTail);
}

// C1: ``blocks`` object blocks, then the pupil blocks.
template <int U, int W, int P, bool Wire>
__global__ void __launch_bounds__(kConsensusThreads)
consensus_led(Tiles a, Pupil pu, unsigned* sync, int blocks) {
  __shared__ float red[kConsensusThreads / 32];
  FPM_MARK(kMarkStart);
  if ((int)blockIdx.x >= blocks) {
    ArrivedMax omax_of{sync, blocks, (int)gridDim.x - blocks};
    const int p = blockIdx.x - blocks;
    pupil_body<kPerThread, Wire>(pu, p, p == 0 && threadIdx.x == 0, omax_of);
    return;
  }
  const float m = block_nan_max(object_phase<U, W, P, Wire>(a, 0), red);
  FPM_MARK(kMarkApply);
  if (threadIdx.x == 0) {
    atomicMax(sync + kMaxBits, __float_as_uint(m));
    add_release(sync + kArrived, 1);
  }
  FPM_MARK(kMarkTicket);
}

// C2: gridDim.x blocks a tile (blockIdx.y); the tile's last block to arrive
// (its arrival wraps the count to 0, and acquires the others' maxima)
// swaps the tile's max for 0 and writes it.
template <int U, int W, int P, bool Wire>
__global__ void __launch_bounds__(kConsensusThreads)
consensus_tile_object(Tiles a, unsigned* sync) {
  __shared__ float red[kConsensusThreads / 32];
  __shared__ bool last;
  FPM_MARK(kMarkStart);
  const int t = blockIdx.y;
  const float m = block_nan_max(object_phase<U, W, P, Wire>(a, t), red);
  FPM_MARK(kMarkApply);
  unsigned* const words = sync + kSyncWords * t;
  if (threadIdx.x == 0) {
    atomicMax(words + kMaxBits, __float_as_uint(m));
    last = inc_acq_rel(words + kArrived, gridDim.x - 1) == gridDim.x - 1;
  }
  FPM_MARK(kMarkTicket);
  if (threadIdx.x == 0 && last)
    *a.tile[t].max_out = __uint_as_float(atomicExch(words + kMaxBits, 0u));
  FPM_MARK_IF(last, kMarkTail);
}

// C3: the plan's blocks, kPupilPerThread pupil elements a thread.
template <bool Wire>
__global__ void __launch_bounds__(kConsensusThreads)
consensus_tile_pupil(Pupil pu, Payloads maxima) {
  FPM_MARK(kMarkStart);
  TileMaxima omax_of{maxima, {}};
  pupil_body<kPupilPerThread, Wire>(pu, blockIdx.x, blockIdx.x == 0 && threadIdx.x == 0,
                                    omax_of);
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

// The pattern of the ``n`` groups' payloads: no bf16 bit set, every rank's
// set, or some.
inline int pattern(const Payloads* g, int n) {
  bool none = true, all = true;
  for (int i = 0; i < n; ++i) {
    const unsigned every = g[i].count == 32 ? ~0u : (1u << g[i].count) - 1u;
    none = none && (g[i].bf16 & every) == 0u;
    all = all && (g[i].bf16 & every) == every;
  }
  return none ? kF32 : all ? kBf16 : kMixed;
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The vector path's condition (kernels.consensus_plan's): NL a multiple of
// 4, each state plane and every payload aligned to its 4 elements.
inline bool vector_ok(const Tiles& a, int n_src, int n_tiles) {
  if (a.nl % 4) return false;
  for (int t = 0; t < n_tiles; ++t)
    if (!aligned(a.tile[t].o, 16) || !aligned(a.tile[t].o_out, 16)) return false;
  for (int g = 0; g < n_src; ++g)
    for (int r = 0; r < a.src[g].count; ++r)
      if (!aligned(a.src[g].p[r], (a.src[g].bf16 >> r) & 1u ? 8 : 16)) return false;
  return true;
}

// The plan's blocks cover the ``n`` elements of a plane (kPerThread a
// thread), whose planes (2·r_ext·NL elements) a 32-bit index reaches, and its
// path is one these operands take.
inline bool plan_ok(const Tiles& a, int n_src, int n_tiles, size_t n, int blocks, int vector) {
  return blocks >= 1 && (size_t)blocks * kConsensusThreads * kPerThread >= n
         && 2 * (size_t)a.r_ext * a.nl + (size_t)blocks * kConsensusThreads * kPerThread
                < (1ull << 31)
         && (vector == 0 || (vector == 1 && vector_ok(a, n_src, n_tiles)));
}

template <int U, int W, int P, bool Wire>
void launch_led(int grid, cudaStream_t stream, const Tiles& a, const Pupil& pu, unsigned* sync,
                int blocks) {
  consensus_led<U, W, P, Wire><<<grid, kConsensusThreads, 0, stream>>>(a, pu, sync, blocks);
}

template <int U, int W, int P, bool Wire>
void launch_tile_object(dim3 grid, cudaStream_t stream, const Tiles& a, unsigned* sync) {
  consensus_tile_object<U, W, P, Wire><<<grid, kConsensusThreads, 0, stream>>>(a, sync);
}

// C3's plan: ``blocks`` blocks of kConsensusThreads threads,
// kPupilPerThread elements each, cover the ``bb`` elements once (no block
// without one).
inline bool pupil_plan_ok(int bb, int blocks) {
  const long long per_block = (long long)kConsensusThreads * kPupilPerThread;
  return blocks >= 1 && blocks * per_block >= bb && (blocks - 1) * per_block < bb;
}

// A launcher's instantiations, [vector][pattern][wire]: the scalar path
// (U, W) = (4, 1), the vector path (1, 4).
#define FPM_CONSENSUS_INSTANCES(launch)                                                       \
  {{{launch<4, 1, kF32, false>, launch<4, 1, kF32, true>},                                    \
    {launch<4, 1, kBf16, false>, launch<4, 1, kBf16, true>},                                  \
    {launch<4, 1, kMixed, false>, launch<4, 1, kMixed, true>}},                               \
   {{launch<1, 4, kF32, false>, launch<1, 4, kF32, true>},                                    \
    {launch<1, 4, kBf16, false>, launch<1, 4, kBf16, true>},                                  \
    {launch<1, 4, kMixed, false>, launch<1, 4, kMixed, true>}}}

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
//   sync          u32 scratch of 2 words, 0 between launches (the kernel
//                 leaves them 0)
//   blocks, pupil_blocks, vector   the plan (kernels.consensus_plan): object
//                 blocks, pupil blocks after them, the vector path (1) or the
//                 scalar one (0); refused if they do not cover the elements
//                 or the operands do not allow the path
//   launches      host int, incremented at the accepted launch
// Returns a cudaError_t value (0 = the launch was accepted).
extern "C" int fpm_consensus_led(const float* o, float* o_out, int n_rows, int nl,
                                 const void* const* d, unsigned d_bf16, const float* pc,
                                 float* pc_out, int b, const void* const* v, unsigned v_bf16,
                                 const void* const* resid, const void* const* upd, int count,
                                 const float* acc_in, float* acc_out, float* omax_out,
                                 float scale, int wire, int metrics, unsigned* sync, int blocks,
                                 int pupil_blocks, int vector, int device, void* stream,
                                 int* launches) {
  using namespace fpm;
  using Launch = void (*)(int, cudaStream_t, const Tiles&, const Pupil&, unsigned*, int);
  static const Launch launch[2][kPatterns][2] = FPM_CONSENSUS_INSTANCES(launch_led);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Tiles a{};
  if (const int e = set_payloads(&a.src[0], d, d_bf16, count)) return e;
  a.tile[0] = Tile{o, o_out, nullptr, 0, {}};
  a.s = a.r_ext = n_rows;
  a.nl = nl;
  Pupil pu;
  if (const int e = set_pupil(&pu, pc, pc_out, b * b, v, v_bf16, resid, upd, count, acc_in,
                              acc_out, omax_out, scale, wire, metrics))
    return e;
  if (!plan_ok(a, 1, 1, (size_t)n_rows * nl, blocks, vector) || pupil_blocks < 1
      || (size_t)pupil_blocks * kConsensusThreads * kPerThread < (size_t)b * b)
    return (int)cudaErrorInvalidValue;
  launch[vector != 0][pattern(a.src, 1)][wire != 0](
      blocks + pupil_blocks, static_cast<cudaStream_t>(stream), a, pu, sync, blocks);
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
//   sync          u32 scratch of 2 words a tile, 0 between launches
//   blocks, vector     the plan: blocks a tile, the vector path or not
extern "C" int fpm_consensus_tile_object(const void* const* src, const unsigned* src_bf16,
                                         int n_src, int count, const float* const* o,
                                         float* const* o_out, float* const* max_out,
                                         const int* own, const int* halo, int n_tiles, int s,
                                         int nl, int r_ext, int n_hops, const int* hop_lo,
                                         const int* hop_rows, int wire, unsigned* sync,
                                         int blocks, int vector, int device, void* stream,
                                         int* launches) {
  using namespace fpm;
  using Launch = void (*)(dim3, cudaStream_t, const Tiles&, unsigned*);
  static const Launch launch[2][kPatterns][2] = FPM_CONSENSUS_INSTANCES(launch_tile_object);
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
  for (int h = 0; h < n_hops; ++h) {
    a.hop_lo[h] = hop_lo[h];
    a.hop_rows[h] = hop_rows[h];
  }
  if (!plan_ok(a, n_src, n_tiles, (size_t)s * nl, blocks, vector))
    return (int)cudaErrorInvalidValue;
  launch[vector != 0][pattern(a.src, n_src)][wire != 0](
      dim3(blocks, n_tiles), static_cast<cudaStream_t>(stream), a, sync);
  return (int)count_launch(launches);
}

// Tile axis, second launch: the (led, tile) group's pupil consensus, with
// max|O'| the max of ``n_maxima`` tile maxima (one f32 each, tile order);
// the arguments as fpm_consensus_led's, and the plan (kernels.pupil_plan):
// ``blocks`` blocks, refused unless they cover the b² elements once.
extern "C" int fpm_consensus_tile_pupil(const float* pc, float* pc_out, int b,
                                        const void* const* v, unsigned v_bf16,
                                        const void* const* resid, const void* const* upd,
                                        int count, const void* const* maxima, int n_maxima,
                                        const float* acc_in, float* acc_out, float* omax_out,
                                        float scale, int wire, int metrics, int blocks,
                                        int device, void* stream, int* launches) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Pupil pu;
  if (const int e = set_pupil(&pu, pc, pc_out, b * b, v, v_bf16, resid, upd, count, acc_in,
                              acc_out, omax_out, scale, wire, metrics))
    return e;
  Payloads m;
  if (const int e = set_payloads(&m, maxima, 0u, n_maxima)) return e;
  if (!pupil_plan_ok(b * b, blocks)) return (int)cudaErrorInvalidValue;
  const auto kernel = wire ? consensus_tile_pupil<true> : consensus_tile_pupil<false>;
  kernel<<<blocks, kConsensusThreads, 0, static_cast<cudaStream_t>(stream)>>>(pu, m);
  return (int)count_launch(launches);
}

#ifdef FPM_PROFILE
extern "C" int fpm_phase_count() { return fpm::kMarks; }

// The name of mark ``i`` (FPM_CONSENSUS_MARKS), or null.
extern "C" const char* fpm_phase_name(int i) {
  static const char* const names[] = {
#define FPM_MARK_NAME(id, name) name,
      FPM_CONSENSUS_MARKS(FPM_MARK_NAME)
#undef FPM_MARK_NAME
  };
  return i >= 0 && i < fpm::kMarks ? names[i] : nullptr;
}

// The stamps of the last launches' first ``n`` records (n × 2·kMarks values:
// each record's global ns at each mark, then its SM cycles; 0 where a mark
// was not reached), after waiting for the device; with ``reset`` every
// record back to 0.
extern "C" int fpm_consensus_records(long long* out, int n, int reset) {
  using namespace fpm;
  if (n < 0 || n > kRecords) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(fpm_consensus_stamps[0]);
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess && n) err = cudaMemcpyFromSymbol(out, fpm_consensus_stamps, n * bytes);
  void* at = nullptr;
  if (err == cudaSuccess && reset) err = cudaGetSymbolAddress(&at, fpm_consensus_stamps);
  if (err == cudaSuccess && reset) err = cudaMemset(at, 0, kRecords * bytes);
  if (err == cudaSuccess && reset) err = cudaDeviceSynchronize();
  return (int)err;
}
#endif
