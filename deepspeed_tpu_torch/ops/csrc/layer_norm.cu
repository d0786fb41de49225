// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/norms.py `_ln_kernel` (pallas_call at
// :101, op `layer_norm`). Same function, row by row in fp32:
//   mean = mean(x); xc = x - mean; var = mean(xc^2);
//   y = (xc * rsqrt(var + eps)) * w + b, cast back to x's dtype.
// The variance comes from the centred values, as in the TPU kernel, not from
// E[x^2] - mean^2: with bf16 rows of large mean the latter cancels the digits
// the parity tolerance needs. `b` may be null (no bias).
//
// Bound on an H100 SXM: memory. Each row is read once and written once
// (2 * N * d * sizeof(T) bytes, plus 2 * d * sizeof(T) for w and b) against
// 3.35 TB/s; the arithmetic (about 8 flops per element) is negligible. At
// decode (N = 64 rows of d = 2048 bf16, 0.5 MiB in all) the launch itself,
// not the bytes, sets the time.
//
// Design: one block per row, so any row count works. Each thread reads
// 16-byte vectors (8 bf16 or 4 fp32), neighbouring threads on neighbouring
// addresses, and keeps its share of the row in registers across the three
// passes: sum, centred sum of squares, output. So x is read from memory
// exactly once. The kernel is instantiated for 1, 2, 4 or 8 vectors a thread
// and the launch picks the smallest that covers the row: with room for 8
// at every width the bf16 kernel took 94 registers, two blocks of 256
// threads an SM, and at d = 2048 (one vector a thread) too few loads were
// in flight to fill the memory pipe. Sums reduce by warp shuffle, then
// across warps through shared memory. A d that is not a multiple of the
// vector width, or too wide for 8 vectors a thread (> 16384 bf16 or 8192
// fp32 elements), takes a scalar path that re-reads the row (an L1/L2 hit).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCache = 8;   // most 16-byte vectors a thread keeps in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kMaxThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float s = lane < nwarps ? partial[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) total = s;
  }
  __syncthreads();
  const float out = total;
  __syncthreads();   // the next call may overwrite `total` only after every read
  return out;
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// Vector path: d % VEC == 0 and d / VEC <= blockDim.x * C.
template <typename T, int C>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, T* __restrict__ y, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const int nv = d / VEC;

  uint4 cache[C];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < nv) {
      cache[c] = xr[i];
      const T* e = reinterpret_cast<const T*>(&cache[c]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += to_f(e[k]);
    }
  }
  const float mean = block_sum(s) / (float)d;

  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < nv) {
      const T* e = reinterpret_cast<const T*>(&cache[c]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) { const float f = to_f(e[k]) - mean; ss += f * f; }
    }
  }
  const float r = rsqrtf(block_sum(ss) / (float)d + eps);

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < nv) {
      const uint4 wraw = reinterpret_cast<const uint4*>(w)[i];
      uint4 braw = make_uint4(0u, 0u, 0u, 0u);   // all-zero bits: 0.0 in bf16 and fp32
      if (b != nullptr) braw = reinterpret_cast<const uint4*>(b)[i];
      uint4 oraw;
      const T* xe = reinterpret_cast<const T*>(&cache[c]);
      const T* we = reinterpret_cast<const T*>(&wraw);
      const T* be = reinterpret_cast<const T*>(&braw);
      T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        oe[k] = from_f<T>(((to_f(xe[k]) - mean) * r) * to_f(we[k]) + to_f(be[k]));
      yr[i] = oraw;
    }
  }
}

// Scalar path: any d; three passes over the row.
template <typename T>
__global__ void layer_norm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                         const T* __restrict__ b, T* __restrict__ y, int d,
                                         float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s += to_f(xr[i]);
  const float mean = block_sum(s) / (float)d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_f(xr[i]) - mean;
    ss += f * f;
  }
  const float r = rsqrtf(block_sum(ss) / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float bias = b != nullptr ? to_f(b[i]) : 0.f;
    yr[i] = from_f<T>(((to_f(xr[i]) - mean) * r) * to_f(w[i]) + bias);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int n_rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  const bool vec = (d % VEC == 0) && (d / VEC <= kMaxThreads * kMaxCache);
  const int work = vec ? d / VEC : d;
  int threads = ((work + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  const int per_thread = (work + threads - 1) / threads;
  if (!vec)
    layer_norm_scalar_kernel<T><<<n_rows, threads, 0, stream>>>(xp, wp, bp, yp, d, eps);
  else if (per_thread <= 1)
    layer_norm_vec_kernel<T, 1><<<n_rows, threads, 0, stream>>>(xp, wp, bp, yp, d, eps);
  else if (per_thread <= 2)
    layer_norm_vec_kernel<T, 2><<<n_rows, threads, 0, stream>>>(xp, wp, bp, yp, d, eps);
  else if (per_thread <= 4)
    layer_norm_vec_kernel<T, 4><<<n_rows, threads, 0, stream>>>(xp, wp, bp, yp, d, eps);
  else
    layer_norm_vec_kernel<T, kMaxCache><<<n_rows, threads, 0, stream>>>(xp, wp, bp, yp, d, eps);
  return cudaGetLastError();
}

}  // namespace

// b may be null (no bias). dtype: 0 bf16, 1 f32 (x, w, b and y alike).
extern "C" int dstt_layer_norm(const void* x, const void* w, const void* b, void* y,
                               int n_rows, int d, float eps, int dtype, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<__nv_bfloat16>(x, w, b, y, n_rows, d, eps, s);
    case 1: return (int)launch<float>(x, w, b, y, n_rows, d, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
