// Device code shared by the EPRY kernels (epry_chunked.cu, K1; epry_sweep.cu,
// K2; epry_increments.cu, K3): the per-LED forward pass and the per-LED
// increments.
//
// Data layout. The object spectrum O is two f32 planes (re, im) in the
// centered frame: NL×NL for K1 and K2, any R×Ncols block of it for K3 (the
// device code here takes the row stride ``ld``; the callers clamp a window's
// rows and columns to their own extents). The pupil P and its support live in the
// centered frame, cropped to the NA disk's bounding box (b×b at offset lo
// inside the Np×Np patch); the wrapper in fpm_torch/ops/kernels.py rolls and
// crops them. The four bbox DFT matrices, with the fftshifts folded in, are
// complex row-major float2: Ai (n×b), Bi (b×n), Af (b×n), Bf (n×b), so that
//   image     = Ai · (Oc ∘ P) · Bi          (n×n, corner frame)
//   spectrum  = Af · R · Bf                (b×b, centered bbox)
// All products are FP32 FMAs (the "highest" precision tier).
//
// Bound. Per LED the four products are n·b·b + n·b·n + b·n·n + b·n·b
// complex multiply-adds (1.77 M at Np=90, b=64), against a few hundred KB of
// memory traffic: FP32-operation bound. The design keeps every
// intermediate of one LED in one block's shared memory (Oc∘P, the n×b
// half-transform and the n×n image: 143 KB at Np=90), so the only
// device-memory traffic per LED is the window (read twice, from L2), the
// amplitude frame and the DFT matrices (read through L1/L2). Each thread
// computes a 2×2 tile of complex outputs per product to reuse every
// shared-memory load four times. The n×n image in one block bounds Np: the
// buffers must fit the 227 KB a block may use (Np=100 with b=80 does,
// Np=200 does not and is refused, set_led_smem).
//
// This is the DFT-by-matmul design: the four products cost ~14 MFLOP per
// LED at Np=90, where pruned FFTs (2·(n+b) length-n transforms) need ~1
// MFLOP. So even at the FP32 peak it stays an order of magnitude above the
// least time the work needs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fpm {

constexpr int kThreads = 512;

struct DftMats {
  const float2* ai;  // (n, b)
  const float2* bi;  // (b, n)
  const float2* af;  // (b, n)
  const float2* bf;  // (n, b)
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// C (M×N, row stride ldc) = A (M×K, lda) · B (K×N, ldb), complex.
// A and B may be in shared or global memory; C must alias neither.
// Each thread owns a 2×2 output tile; a ragged last row/column repeats the
// previous index and is computed but not stored.
__device__ void cgemm(const float2* __restrict__ A, int lda,
                      const float2* __restrict__ B, int ldb,
                      float2* __restrict__ C, int ldc, int M, int N, int K) {
  const int tm = (M + 1) >> 1, tn = (N + 1) >> 1;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int i0 = (t / tn) * 2, j0 = (t % tn) * 2;
    const bool has_i1 = i0 + 1 < M, has_j1 = j0 + 1 < N;
    const float2* a0 = A + i0 * lda;
    const float2* a1 = A + (has_i1 ? i0 + 1 : i0) * lda;
    const int j1 = has_j1 ? j0 + 1 : j0;
    float2 c00 = make_float2(0.f, 0.f), c01 = c00, c10 = c00, c11 = c00;
    for (int k = 0; k < K; ++k) {
      const float2 x0 = a0[k], x1 = a1[k];
      const float2 y0 = B[k * ldb + j0], y1 = B[k * ldb + j1];
      cfma(c00, x0, y0);
      cfma(c01, x0, y1);
      cfma(c10, x1, y0);
      cfma(c11, x1, y1);
    }
    C[i0 * ldc + j0] = c00;
    if (has_j1) C[i0 * ldc + j0 + 1] = c01;
    if (has_i1) {
      C[(i0 + 1) * ldc + j0] = c10;
      if (has_j1) C[(i0 + 1) * ldc + j0 + 1] = c11;
    }
  }
}

// Block-wide sum / max; every thread of the block must call, every thread
// gets the result. ``red`` is 32 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Shared memory of one LED's forward pass, in float2 units:
// z (b·b) | t (n·b) | img (n·n), then 32 floats for reductions.
struct LedSmem {
  float2* z;
  float2* t;
  float2* img;
  float* red;
};

__host__ __device__ inline size_t led_smem_bytes(int n, int b) {
  return (size_t)(b * b + n * b + n * n) * sizeof(float2) + 32 * sizeof(float);
}

// Returned by an entry point for an Np whose buffers do not fit one block.
constexpr int kErrLedSmem = -1;

// Gives ``kernel`` one LED's dynamic shared memory (*smem bytes), or returns
// kErrLedSmem when that exceeds what one block may use on ``device``.
template <typename Kernel>
int set_led_smem(Kernel kernel, int n, int b, int device, size_t* smem) {
  int limit = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  *smem = led_smem_bytes(n, b);
  if (*smem > (size_t)limit) return kErrLedSmem;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

// Makes ``device`` current for an entry point's launches and gives the
// caller's device back when the entry point returns, so that one process
// driving several cards keeps the current device it had.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return;
    err = cudaSetDevice(device);
    if (err == cudaSuccess) prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

// The error of the launch just made; counts it in *launches if accepted.
inline cudaError_t count_launch(int* launches) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

__device__ inline LedSmem carve_smem(void* base, int n, int b) {
  LedSmem s;
  s.z = reinterpret_cast<float2*>(base);
  s.t = s.z + b * b;
  s.img = s.t + n * b;
  s.red = reinterpret_cast<float*>(s.img + n * n);
  return s;
}

// A patch start as the JAX package's crop (``lax.dynamic_slice``) takes it:
// a negative start counts from the end, then it is clamped so the n×n patch
// lies inside the spectrum's extent ``dim`` along that axis. Every window
// access stays in bounds whatever the caller passes (ops/complexops.py
// clamp_start is the same).
__device__ __forceinline__ int clamp_start(int s, int dim, int n) {
  if (s < 0) s += dim;
  return min(max(s, 0), dim - n);
}

// max|P| over the bbox pupil (the object update's max|P|, fpmMain.cpp:404-419).
__device__ float pupil_abs_max(const float* p_re, const float* p_im, int bb, float* red) {
  float m = 0.f;
  for (int e = threadIdx.x; e < bb; e += blockDim.x)
    m = fmaxf(m, p_re[e] * p_re[e] + p_im[e] * p_im[e]);
  return sqrtf(block_max(m, red));
}

// The forward pass of one LED from the state (O, P):
//   oc   = O[y0:y0+b, x0:x0+b]                     (centered window; O's row
//                                                   stride is ld)
//   img  = Ai·(oc∘P)·Bi                            (image plane, n×n)
//   rep  = img · amp / |img + eps(1+i)|            (eps on BOTH channels)
//   up   = Af·rep·Bf                               (b×b)
// Leaves up in s.z; returns the data residual
// Σ(amp − |img|)² when ``metrics`` (else 0). All threads must call.
// O is read without __restrict__: K2 writes it later in the same launch.
__device__ float led_forward(const float* o_re, const float* o_im,
                             int ld, int y0, int x0,
                             const float* __restrict__ p_re, const float* __restrict__ p_im,
                             const float* __restrict__ amp, const DftMats m,
                             int n, int b, float eps, bool metrics, const LedSmem s) {
  const int bb = b * b;
  for (int e = threadIdx.x; e < bb; e += blockDim.x) {
    const int i = e / b, j = e - i * b;
    const size_t g = (size_t)(y0 + i) * ld + (x0 + j);
    s.z[e] = cmul(make_float2(o_re[g], o_im[g]), make_float2(p_re[e], p_im[e]));
  }
  __syncthreads();
  cgemm(m.ai, b, s.z, b, s.t, b, n, b, b);      // t = Ai·z        (n×b)
  __syncthreads();
  cgemm(s.t, b, m.bi, n, s.img, n, n, n, b);    // img = t·Bi      (n×n)
  __syncthreads();
  float resid = 0.f;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const float2 v = s.img[e];
    const float a = amp[e];
    const float re = v.x + eps, im = v.y + eps;
    const float scale = a / sqrtf(re * re + im * im);
    if (metrics) {
      const float d = a - sqrtf(v.x * v.x + v.y * v.y);
      resid = fmaf(d, d, resid);
    }
    s.img[e] = make_float2(v.x * scale, v.y * scale);
  }
  __syncthreads();
  cgemm(m.af, n, s.img, n, s.t, n, b, n, n);    // t = Af·rep      (b×n)
  __syncthreads();
  cgemm(s.t, n, m.bf, b, s.z, b, b, b, n);      // up = t·Bf       (b×b)
  __syncthreads();
  return metrics ? block_sum(resid, s.red) : 0.f;
}

// Per-element increments of one LED, from the window oc (re-read from O,
// which no kernel has changed yet), up (s.z) and the pupil/support at
// the chunk (K1, K3) or step (K2) start:
//   diff = up − oc∘P
//   dO   = diff · |P|·conj(P) / (max|P| · (|P|² + delta2))       (fpmMain.cpp:404-419)
//   num  = diff · |oc|·conj(oc) · support / (|oc|² + delta1)     (fpmMain.cpp:457-472,
//          everything but the 1/max|O| factor)
// Writes dO[e] and num[e] (either may point into shared memory; dO may be
// s.z itself) and returns the block-wide Σ|dO|² when ``metrics``.
__device__ float led_increments(const LedSmem s, const float* o_re, const float* o_im,
                                int ld, int y0, int x0, int b,
                                const float* __restrict__ p_re,
                                const float* __restrict__ p_im,
                                const float* __restrict__ sup, float pmax,
                                float delta1, float delta2, bool metrics,
                                float2* d_obj, float2* num) {
  float upd = 0.f;
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    const int i = e / b, j = e - i * b;
    const size_t g = (size_t)(y0 + i) * ld + (x0 + j);
    const float2 oc = make_float2(o_re[g], o_im[g]);
    const float2 p = make_float2(p_re[e], p_im[e]);
    const float2 ocp = cmul(oc, p);
    const float2 up = s.z[e];
    const float2 diff = make_float2(up.x - ocp.x, up.y - ocp.y);

    const float pabs2 = p.x * p.x + p.y * p.y;
    const float pabs = sqrtf(pabs2);
    const float recip_o = 1.f / (pmax * (pabs2 + delta2));
    const float2 w = make_float2(pabs * p.x * recip_o, -pabs * p.y * recip_o);
    const float2 dob = cmul(diff, w);

    const float oabs2 = oc.x * oc.x + oc.y * oc.y;
    const float oabs = sqrtf(oabs2);
    const float rp = sup[e] / (oabs2 + delta1);
    const float2 v = make_float2(oabs * oc.x * rp, -oabs * oc.y * rp);

    d_obj[e] = dob;
    num[e] = cmul(diff, v);
    if (metrics) upd = fmaf(dob.x, dob.x, fmaf(dob.y, dob.y, upd));
  }
  __syncthreads();
  return metrics ? block_sum(upd, s.red) : 0.f;
}

}  // namespace fpm

// Every library built from a source that includes this header exports its
// own copy, so each wrapper can name the error its launches returned.
extern "C" const char* fpm_cuda_error_string(int err) {
  if (err == fpm::kErrLedSmem)
    return "Np too large: one LED's b×b window, n×b half-transform and n×n image "
           "do not fit one block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
