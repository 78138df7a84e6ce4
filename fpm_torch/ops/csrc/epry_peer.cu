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
//                   and a replay needs no host argument.
//   fpm_peer_post   after a step (a rank's K3, a card's consensus, a halo
//                   pull): its flag word := (epoch << 32) | (chunk + 1),
//                   a st.release.sys store after a system-scope fence, so
//                   that the step's writes are visible to every card that
//                   sees the flag.
//   fpm_peer_wait   before a step: one block whose threads poll one flag
//                   each (ld.acquire.sys, which reads a peer card's word
//                   through peer access) until it holds at least
//                   (own epoch << 32) | (chunk + 1). The values a flag
//                   takes only grow (a step posts chunk after chunk, sweep
//                   after sweep), so "at least" also holds for a post that
//                   is further on. Every card's epoch is bumped once a
//                   sweep, so a card's epoch is its peers' while the sweep
//                   runs.
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
// Bound: a post or an epoch writes 8 bytes, a wait reads 8 bytes a flag:
// each is a launch's latency. A pull moves its rows once (read over NVLink
// from a peer, written to this card's memory).

#include "epry_common.cuh"

namespace fpm {

constexpr int kMaxWaits = 32;                           // flags one wait polls
constexpr long long kWaitTimeoutNs = 20LL * 1000 * 1000 * 1000;
constexpr int kPullThreads = 256;
constexpr int kPullMaxBlocks = 1024;

using u64 = unsigned long long;

struct Waits {
  const u64* flag[kMaxWaits];
  u64 chunk1[kMaxWaits];     // the awaited step's chunk + 1
  int count;
};

__device__ __forceinline__ u64 load_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void peer_epoch(u64* words) {
  words[0] = __ldcg(words) + 1ull;
  __threadfence_system();
}

__global__ void peer_post(u64* words, int slot, int chunk) {
  const u64 value = (__ldcg(words) << 32) | (u64)(chunk + 1);
  __threadfence_system();
  store_release_sys(words + 1 + slot, value);
}

__global__ void __launch_bounds__(kMaxWaits) peer_wait(Waits w, const u64* epoch) {
  const int t = threadIdx.x;
  if (t < w.count) {
    const u64 want = (__ldcg(epoch) << 32) | w.chunk1[t];
    const long long t0 = global_ns();
    while (load_acquire_sys(w.flag[t]) < want) {
      __nanosleep(100);
      if (global_ns() - t0 > kWaitTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// dst (planes, rows, cols) contiguous ← src's view with the given strides;
// four floats a thread where the rows and both pointers allow it.
__global__ void __launch_bounds__(kPullThreads)
peer_pull(float* dst, const float* src, int planes, int rows, int cols, long long plane_stride,
          long long row_stride, int vec) {
  const int w = vec ? cols / 4 : cols;
  const long long n = (long long)planes * rows * w;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int x = (int)(i % w);
    const long long pr = i / w;
    const int r = (int)(pr % rows), pl = (int)(pr / rows);
    const long long s = pl * plane_stride + r * row_stride;
    const long long d = ((long long)pl * rows + r) * cols;
    if (vec)
      reinterpret_cast<float4*>(dst + d)[x] = reinterpret_cast<const float4*>(src + s)[x];
    else
      dst[d + x] = src[s + x];
  }
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
  Waits w{};
  for (int i = 0; i < count; ++i) {
    if (chunks[i] < 0) return (int)cudaErrorInvalidValue;
    w.flag[i] = static_cast<const u64*>(flags[i]);
    w.chunk1[i] = (u64)(chunks[i] + 1);
  }
  w.count = count;
  peer_wait<<<1, kMaxWaits, 0, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const u64*>(epoch));
  return (int)count_launch(launches);
}

// dst: (planes, rows, cols) contiguous f32 on ``device``; src: the same
// shape at element strides (plane_stride, row_stride, 1), on this card or a
// peer's.
extern "C" int fpm_peer_pull(float* dst, const float* src, int planes, int rows, int cols,
                             long long plane_stride, long long row_stride, int device,
                             void* stream, int* launches) {
  using namespace fpm;
  if (planes < 1 || rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int vec = cols % 4 == 0 && plane_stride % 4 == 0 && row_stride % 4 == 0
                  && reinterpret_cast<uintptr_t>(dst) % 16 == 0
                  && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const long long n = (long long)planes * rows * (vec ? cols / 4 : cols);
  const long long want = (n + kPullThreads - 1) / kPullThreads;
  const int blocks = (int)(want < kPullMaxBlocks ? want : kPullMaxBlocks);
  peer_pull<<<blocks, kPullThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dst, src, planes, rows, cols, plane_stride, row_stride, vec);
  return (int)count_launch(launches);
}
