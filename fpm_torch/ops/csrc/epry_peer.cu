// Order between the cards of one process, kept on the cards: the signal and
// wait kernels of the sharded sweeps' peer route, and the forward halo
// pulled from a peer card's rows.
//
// Replaces no Pallas kernel. fpm_tpu runs a mesh as one compiled program, in
// which XLA orders each chunk's collectives and consensus against the next
// chunk's increments (the stale pipeline, fpm_tpu/parallel/led_shard.py:
// 164-209) and moves the halo (tile_shard.py's ppermute). The port's
// one-process sweep over several cards ordered them with CUDA events: about
// 120 event edges between cards a (4,1) chunk, which a graph's launch
// resolves on the host, 3.5 µs an edge (scripts/graph_cards.py). With peer
// access between every pair of cards the consensus kernels read their
// peers' payloads where K3 wrote them, and these kernels keep the order:
//
//   fpm_peer_epoch  a card's sweep starts: its epoch word += 1 (the first
//                   node of the sweep on the card), so flags are never reset
//                   and a replay needs no host argument. One thread, one
//                   red.relaxed.gpu.global.add.u64: no load, no store that
//                   waits on a load, no fence (the epoch, below).
//   fpm_peer_post   after a step (a rank's K3, a card's consensus, a halo
//                   pull): its flag word := (epoch << 32) | (chunk + 1),
//                   one system-scope release (below).
//   fpm_peer_wait   before a step: one block whose threads poll one flag
//                   each (ld.acquire.sys, which reads a peer card's word
//                   through peer access) until it holds at least
//                   (own epoch << 32) | (chunk + 1). The values a flag
//                   takes only grow (a step posts chunk after chunk, sweep
//                   after sweep), so "at least" also holds for a post that
//                   is further on. Every card's epoch is bumped once a
//                   sweep, so a card's epoch is its peers' while the sweep
//                   runs. A thread starts the load of the epoch and the
//                   first load of its flag together and compares once both
//                   have arrived, so a flag already posted costs one round
//                   trip; an unmet flag it polls with kPauseNs between
//                   polls (3 µs of polls without a pause, then 32-64 ns
//                   pauses, woke it no sooner, on this card or from a
//                   peer, and moved no sweep: PERF.md §6).
//                   A thread leaves when its flag is met: no barrier, since
//                   the kernel's end, which the guarded step waits for in
//                   stream order, is every thread's. The count, the
//                   epoch's address and the first threads' flags and chunks
//                   share one line of the constant cache, which a thread
//                   reads before its loads (the count first, uniform, so
//                   the threads past it never read a flag: an indexed read
//                   by all 32 took 0.47 µs more; three lines, the count's,
//                   the addresses' and the chunks', 0.07-0.09 µs more than
//                   one: PERF.md §6).
//   fpm_peer_pull   the forward halo: the receiving card copies the rows of
//                   the peer's state into its own buffer, behind a wait.
//
// Why no cycle can form: every card enqueues the same chunks in the same
// order, and a wait is enqueued only for a step the host enqueued before it
// (a consensus of chunk c after the K3s of chunk c; a K3 after the consensus
// of an earlier chunk; a pull after the consensus that made its rows). So
// the host's order of enqueue is an order in which every wait finds its
// post already done, and a stream never holds a wait ahead of a post it
// needs. A wait is one block of 32 threads on the stream it guards, so a
// spinning waiter never holds the SMs that a cooperative K3 or a consensus
// on the same card needs. A wait that is still unmet after kWaitTimeoutNs
// traps (the launch fails, and with it the sweep) rather than hang.
//
// The post (P2): one system-scope release, fence.acq_rel.sys then a
// st.relaxed.sys of the flag (a release pattern). Why the step's writes are
// visible to a peer that reads the flag with ld.acquire.sys, under the PTX
// memory model: the step (K3, a consensus, a pull) is the kernel before the
// post on the same stream, so every write of its grid is performed before
// the post's grid starts (stream order, at least gpu scope) and precedes
// the fence in causality order. A release pattern is cumulative: the
// fence.acq_rel.sys and the strong store after it order every write that
// precedes the fence in causality order, whichever thread made it, before
// the flag's new value at system scope. An ld.acquire.sys that reads that
// value (or a later one of the same word, which only grows) synchronizes
// with the pattern, so every later read of the waiting card, the reads of
// the step that the wait guards on its stream included, sees those writes.
// In the wait every load of the flag is that ld.acquire.sys: the first,
// started with the epoch's, and each poll after it; whichever of them
// reads a value at least the one awaited is the acquire that synchronizes.
// The epoch's load (ld.global.cg, this card's word, written by P1 earlier
// on the stream or on one the sweep's events order before it) comes first
// in program order, and an acquire orders only what follows it, so the two
// loads are in flight at once. The wait's reads that follow the acquire are
// none of its own: they are the guarded step's, in the next kernel on the
// stream, which stream order puts after every thread of the wait.
// The post was once a fence.sc.sys before a st.release.sys: two
// system-scope orderings, of which the second orders nothing the first does
// not (the sc fence is for sequential consistency between fences, which no
// reader here relies on). Measured in turns on one H100 (PERF.md §5): this
// pattern and st.release.sys alone cost the same within 0.04 µs (this one
// the less in 3 of 4 turns), about 1.85 µs above an empty kernel; the two
// orderings 1.6 µs more.
//
// The pull (P4): the halo is planes × rows runs of cols contiguous floats
// (mono (2,2): 2 × 90 runs of 1,440 bytes, 259 KB; dogStomach (2,2): 2 ×
// 200 of 2,400, 960 KB), read from a peer over NVLink or from this card.
// Its time is latency: the bytes in flight, not the threads, set the rate,
// and the whole halo fits in flight at once. So one warp a plane-row, in a
// 2-D grid (row blocks, planes) of blocks of 8 warps: each lane loads up to
// kPerLane float4 of its row (3 at mono, 5 at dogStomach) into registers
// before it stores any, every row of the halo in one wave of blocks that
// need no shared memory and few registers, so they fit beside the kernels
// that hold the SMs. No 64-bit division. The vector path where vector_ok
// holds (cols % 4 == 0, strides % 4 == 0, both pointers on 16 bytes), the
// scalar path (the same with floats) for unaligned views and odd columns.
// kernels.pull_plan chooses, the C entry checks again: blocks of 256
// threads, the least from a peer's memory on both halos and below
// Tensor.copy_ on one card (scripts/kernel_profile.py --kernel P4, PERF.md
// §5). Taken over TMA bulk copies (a few blocks whose elected thread kept a
// ring of rows in shared memory filled with cp.async.bulk, each stage
// completed on its mbarrier and stored with a bulk store; a bulk copy takes
// a peer's address), which measured 2 to 80 times slower: a block's bulk
// copies of these 1.4-2.4 KB rows complete about one every 0.27 µs, so few
// blocks serialise and many are no better than a warp a row. From a peer
// the pull stays above Tensor.copy_, whose kernel runs on the source card
// and pushes the rows: both move them at the same rate, but a read waits a
// round trip over NVLink that a posted write does not.
//
// The epoch (P1): why gpu scope and the kernel boundary suffice. A card's
// word 0 is read by two kernels only, both on the same card: the post (P2,
// ld.global.cg of its own card's word) and the wait (P3, the same load of
// the waiting card's word; kernels.peer_wait launches on the card whose
// block it is given, and the mesh gives each wait its own step's card).
// Each runs after P1 on the card, in stream order or behind the sweep's
// fork, whose events the card's other streams wait on after P1's lane; a
// kernel's end orders its writes, at least at gpu scope, before every
// kernel that stream order or an event puts after it. The reduction is
// performed at the card's L2, where both readers' .cg loads read. No peer
// reads word 0: peers read the flag words 1..63 only (ld.acquire.sys in
// the wait), and a flag's high word is the posting card's epoch as its
// post read it after that card's P1. A waiter compares it with its own
// card's epoch, which every card bumps once a sweep, so no card needs
// another card's epoch, and nothing orders word 0 at system scope. The
// one hazard is a stale read of the epoch: a waiter that read the last
// sweep's epoch would be met by the last sweep's flags and let its step
// run early; the order above rules it out, and the stale-epoch litmus of
// tests/test_torch_cuda.py is aimed at it. A __threadfence_system() after
// the add (membar.sys) would cost ~1.8 µs, twice a launch, and order nothing
// the kernel's end does not; a load, add and store without it ~0.15 µs
// more than the reduction (scripts/kernel_profile.py --kernel P1).
//
// Bound: a post or an epoch writes 8 bytes, a wait reads 8 bytes a flag:
// each is a launch's latency. A pull moves its rows once (read over NVLink
// from a peer, written to this card's memory).

#include "epry_common.cuh"

namespace fpm {

constexpr int kMaxWaits = 32;                           // flags one wait polls
constexpr long long kWaitTimeoutNs = 20LL * 1000 * 1000 * 1000;
constexpr unsigned kPauseNs = 100;           // between a wait's polls
enum PullPath { kPathScalar = 0, kPathVector = 1 };     // kernels.PULL_PATHS
constexpr int kPerLane = 8;                  // loads a lane holds before it stores

using u64 = unsigned long long;

// A wait's launch parameters: this card's epoch word, the count of its
// flags, then each flag and the awaited step's chunk + 1, so the first
// threads' reads of them share one line of the constant cache.
struct Wait {
  const u64* flag;
  u64 chunk1;
};

struct Waits {
  const u64* epoch;
  int count;
  Wait wait[kMaxWaits];
};

__device__ __forceinline__ u64 load_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The epoch's load (L2, this card's word) and the flag's first acquire
// load, both started before either is used.
__device__ __forceinline__ void load_epoch_and_flag(const u64* epoch, const u64* flag, u64& e,
                                                    u64& f) {
  asm volatile(
      "ld.global.cg.u64 %0, [%2];\n\t"
      "ld.acquire.sys.global.u64 %1, [%3];"
      : "=l"(e), "=l"(f) : "l"(epoch), "l"(flag) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The pull's stamps. Built with -DFPM_PROFILE (fpm_torch/ops/build.py,
// profile_library), thread 0 of each block of a pull records the launch's
// number (the entry point's count of its pulls), its block, and the card's
// global clock (ns) at the block's start and after its last store
// completed (a block barrier first: the one difference in schedule from a
// plain build); fpm_peer_records hands them out. A plain build compiles
// the stamps away.
#ifdef FPM_PROFILE
constexpr int kPullRecords = 64 * 1024;
__device__ long long fpm_pull_stamps[kPullRecords][4];
__device__ unsigned fpm_pull_next;
#define FPM_SEQ_PARAM , int seq
#define FPM_PULL_START() const long long t0_ = global_ns()
#define FPM_PULL_END()                                                        \
  do {                                                                        \
    __syncthreads();                                                          \
    if (threadIdx.x == 0) {                                                   \
      const unsigned i_ = atomicAdd(&fpm_pull_next, 1u);                      \
      if (i_ < kPullRecords) {                                                \
        fpm_pull_stamps[i_][0] = seq;                                         \
        fpm_pull_stamps[i_][1] = blockIdx.y * gridDim.x + blockIdx.x;         \
        fpm_pull_stamps[i_][2] = t0_;                                         \
        fpm_pull_stamps[i_][3] = global_ns();                                 \
      }                                                                       \
    }                                                                         \
  } while (0)
#else
#define FPM_SEQ_PARAM
#define FPM_PULL_START()
#define FPM_PULL_END()
#endif

__global__ void peer_epoch(u64* words) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(words), "l"(1ull) : "memory");
}

__global__ void peer_post(u64* words, int slot, int chunk) {
  const u64 value = (__ldcg(words) << 32) | (u64)(chunk + 1);
  asm volatile("fence.acq_rel.sys;" ::: "memory");
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(words + 1 + slot), "l"(value)
               : "memory");
}

__global__ void __launch_bounds__(kMaxWaits) peer_wait(Waits w) {
  if ((int)threadIdx.x >= w.count) return;
  const Wait mine = w.wait[threadIdx.x];
  const u64* const flag = mine.flag;
  u64 e, f;
  load_epoch_and_flag(w.epoch, flag, e, f);
  const u64 want = (e << 32) | mine.chunk1;
  if (f >= want) return;
  const long long t0 = global_ns();
  while (load_acquire_sys(flag) < want) {
    __nanosleep(kPauseNs);
    if (global_ns() - t0 > kWaitTimeoutNs) __trap();
  }
}

// dst (planes, rows, w) contiguous ← src's view at strides (plane_stride,
// row_stride, 1), all in units of T (float4: the vector path, float: the
// scalar one). Grid (row blocks, planes), a warp a row; each lane holds up
// to kPerLane elements of its row in registers before it stores any.
template <typename T>
__global__ void __launch_bounds__(1024)
peer_pull_rows(T* __restrict__ dst, const T* __restrict__ src, int rows, int w,
               long long plane_stride, long long row_stride FPM_SEQ_PARAM) {
  FPM_PULL_START();
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r < rows) {
    const T* s = src + blockIdx.y * plane_stride + r * row_stride;
    T* d = dst + ((long long)blockIdx.y * rows + r) * w;
    for (int x0 = lane; x0 < w; x0 += 32 * kPerLane) {
      T v[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (x0 + 32 * k < w) v[k] = s[x0 + 32 * k];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (x0 + 32 * k < w) d[x0 + 32 * k] = v[k];
    }
  }
  FPM_PULL_END();
}

// An empty kernel: the least a launch takes on this card, the yardstick of
// the one-thread kernels above (no path launches it).
__global__ void launch_floor() {}


// The vector path is allowed: 16-byte rows (cols % 4 == 0, strides % 4 ==
// 0, both pointers on 16 bytes).
inline bool vector_ok(const float* dst, const float* src, int cols, long long plane_stride,
                      long long row_stride) {
  return cols % 4 == 0 && plane_stride % 4 == 0 && row_stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(dst) % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
}

}  // namespace fpm

// Peer access from ``device`` to ``peer``'s memory (already enabled: 0).
extern "C" int fpm_enable_peer_access(int device, int peer) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)err;
}

// words: the card's flag block, (1 + signals) u64, word 0 its epoch.
extern "C" int fpm_peer_epoch(void* words, int device, void* stream, int* launches) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  peer_epoch<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<u64*>(words));
  return (int)count_launch(launches);
}

extern "C" int fpm_peer_post(void* words, int slot, int chunk, int device, void* stream,
                             int* launches) {
  using namespace fpm;
  if (slot < 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  peer_post<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<u64*>(words), slot,
                                                           chunk);
  return (int)count_launch(launches);
}

// flags: ``count`` pointers to flag words (this card's or a peer's);
// chunks: the chunk each awaited step posts; epoch: this card's word 0.
extern "C" int fpm_peer_wait(const void* const* flags, const int* chunks, int count,
                             const void* epoch, int device, void* stream, int* launches) {
  using namespace fpm;
  if (count < 1 || count > kMaxWaits) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Waits w{static_cast<const u64*>(epoch), count, {}};
  for (int i = 0; i < count; ++i) {
    if (chunks[i] < 0) return (int)cudaErrorInvalidValue;
    w.wait[i] = Wait{static_cast<const u64*>(flags[i]), (u64)chunks[i] + 1};
  }
  peer_wait<<<1, kMaxWaits, 0, static_cast<cudaStream_t>(stream)>>>(w);
  return (int)count_launch(launches);
}

// dst: (planes, rows, cols) contiguous f32 on ``device``; src: the same
// shape at element strides (plane_stride, row_stride, 1), on this card or a
// peer's. The launch is the host's plan (kernels.pull_plan): ``path``, its
// ``blocks``, (row blocks) × planes of ``threads`` threads, a warp a row.
// A plan the operands do not allow is refused (cudaErrorInvalidValue).
extern "C" int fpm_peer_pull(float* dst, const float* src, int planes, int rows, int cols,
                             long long plane_stride, long long row_stride, int path, int blocks,
                             int threads, int device, void* stream, int* launches) {
  using namespace fpm;
  if (planes < 1 || rows < 1 || cols < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const bool vec = vector_ok(dst, src, cols, plane_stride, row_stride);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef FPM_PROFILE
  static int seq = 0;
#define FPM_SEQ_ARG , seq++
#else
#define FPM_SEQ_ARG
#endif
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if ((path != kPathVector && path != kPathScalar) || (path == kPathVector && !vec) ||
      threads < 32 || threads > 1024 || threads % 32 || planes > 65535)
    return (int)cudaErrorInvalidValue;
  const int warps = threads / 32;
  const int row_blocks = (rows + warps - 1) / warps;
  if ((long long)row_blocks * planes != blocks) return (int)cudaErrorInvalidValue;
  const dim3 grid(row_blocks, planes);
  if (path == kPathVector)
    peer_pull_rows<float4><<<grid, threads, 0, st>>>(
        reinterpret_cast<float4*>(dst), reinterpret_cast<const float4*>(src), rows, cols / 4,
        plane_stride / 4, row_stride / 4 FPM_SEQ_ARG);
  else
    peer_pull_rows<float><<<grid, threads, 0, st>>>(dst, src, rows, cols, plane_stride,
                                                    row_stride FPM_SEQ_ARG);
  return (int)count_launch(launches);
#undef FPM_SEQ_ARG
}

// One launch of the empty kernel on ``device``'s ``stream``.
extern "C" int fpm_launch_floor(int device, void* stream) {
  using namespace fpm;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  launch_floor<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

#ifdef FPM_PROFILE
extern "C" int fpm_phase_count() { return 2; }

// The names of a pull record's two stamps.
extern "C" const char* fpm_phase_name(int i) {
  static const char* const names[] = {"start", "end"};
  return i >= 0 && i < 2 ? names[i] : nullptr;
}

// The pull records of ``device`` since its last reset, after waiting for
// it: up to ``n`` of them into ``out`` (n × 4 values: the launch's number,
// the block, its start and its end in global ns); returns the count made
// (more than n: some were not kept) through ``made``; with ``reset`` the
// count back to 0.
extern "C" int fpm_peer_records(long long* out, int n, int reset, int device, int* made) {
  using namespace fpm;
  if (n < 0 || n > kPullRecords) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  unsigned count = 0;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&count, fpm_pull_next, sizeof(count));
  *made = (int)count;
  const unsigned kept = count < (unsigned)n ? count : (unsigned)n;
  if (err == cudaSuccess && kept)
    err = cudaMemcpyFromSymbol(out, fpm_pull_stamps, kept * sizeof(fpm_pull_stamps[0]));
  const unsigned zero = 0;
  if (err == cudaSuccess && reset) err = cudaMemcpyToSymbol(fpm_pull_next, &zero, sizeof(zero));
  if (err == cudaSuccess && reset) err = cudaDeviceSynchronize();
  return (int)err;
}
#endif
