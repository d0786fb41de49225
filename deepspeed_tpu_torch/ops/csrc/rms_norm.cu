// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/norms.py `_rms_kernel` (pallas_call at
// :38, op `rms_norm`). Same function: y = (x * rsqrt(mean(x^2) + eps)) * w,
// accumulated in fp32 and cast back to x's dtype, row by row.
//
// Bound on an H100 SXM: memory. Each row is read once and written once
// (2 * N * d * sizeof(T) bytes, plus d * sizeof(T) for the weight) against
// 3.35 TB/s; the arithmetic (3 flops per element) is negligible. At decode
// (N = 64 rows of d = 4096 bf16, 1 MiB in all) the launch itself, not the
// bytes, sets the time.
//
// Design: one block per row, so any row count works (1..7 and odd counts
// included: the TPU kernel pads rows to 8, this one does not). Each thread
// reads 16-byte vectors (8 bf16 or 4 fp32), neighbouring threads on
// neighbouring addresses; the sum of squares reduces by warp shuffle and
// then across warps through shared memory. The second pass re-reads the row
// (an L1/L2 hit at these widths) rather than holding it in registers, which
// keeps any d legal. A d that is not a multiple of the vector width takes a
// scalar path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

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
  return total;
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                T* __restrict__ y, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const bool vec = (d % VEC) == 0;

  float ss = 0.f;
  if (vec) {
    const int nv = d / VEC;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) { float f = to_f(e[k]); ss += f * f; }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) { float f = to_f(xr[i]); ss += f * f; }
  }
  ss = block_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);

  if (vec) {
    const int nv = d / VEC;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 xraw = reinterpret_cast<const uint4*>(xr)[i];
      uint4 wraw = reinterpret_cast<const uint4*>(w)[i];
      uint4 oraw;
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* we = reinterpret_cast<const T*>(&wraw);
      T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) oe[k] = from_f<T>((to_f(xe[k]) * r) * to_f(we[k]));
      reinterpret_cast<uint4*>(yr)[i] = oraw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f<T>((to_f(xr[i]) * r) * to_f(w[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int n_rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int work = (d % VEC == 0) ? d / VEC : d;
  int threads = ((work + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  rms_norm_kernel<T><<<n_rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dstt_rms_norm(const void* x, const void* w, void* y, int n_rows, int d,
                             float eps, int dtype, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<__nv_bfloat16>(x, w, y, n_rows, d, eps, s);
    case 1: return (int)launch<float>(x, w, y, n_rows, d, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
