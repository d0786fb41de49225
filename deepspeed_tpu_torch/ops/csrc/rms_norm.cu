// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/norms.py `_rms_kernel` (pallas_call at
// :38, op `rms_norm`). Same function: y = (x * rsqrt(mean(x^2) + eps)) * w,
// accumulated in fp32 and cast back to x's dtype, row by row. bf16, fp16 and
// fp32, as the Pallas kernel takes them.
//
// Bound on an H100 SXM: memory. Each row is read once and written once
// (2 * N * d * sizeof(T) bytes, plus d * sizeof(T) for the weight) against
// 3.35 TB/s; the arithmetic (3 flops per element) is negligible. At decode
// (N = 64 rows of d = 4096 bf16, 1 MiB in all) the launch and one dependent
// chain (a DRAM round trip, the sum, the store) set the time, not the bytes;
// at a training micro-batch (thousands of rows) the rows in flight per SM
// do.
//
// Design. Each thread issues the loads of its share of the row and of w
// first, keeps them in registers, and reads neither again: the sum of
// squares, then y from the same registers. The weight's load is in flight
// under the row's, never a second round trip after the sum. One sum only
// (no mean, unlike layer_norm.cu), reduced by __shfl_xor_sync within a warp
// and, where a row spans W > 1 warps, one exchange of the W partials through
// shared memory behind a single __syncthreads: every thread then adds the W
// entries in the same order, so every thread holds the same bits. One block
// a row, of at most kThreads threads. `launch` picks the kernel from d and
// the dtype alone:
// - the vector kernel where d % VEC == 0 and a row fits kMaxVectors 16-byte
//   vectors a thread: V, the least power of two that keeps a row within
//   kThreads threads (d 4096 bf16: 8 warps of 2 vectors), at every row
//   count. Measured on one H100 80GB HBM3 at 700 W
//   (scripts/norm_sparse_ab_timing.py, PERF.md section 6), bf16 d 4096: 8 warps
//   of 2 vectors ran 1.67 us at 64 rows and 23.7 us at 4096 (the old
//   kernel 2.24 and 25.2); a 512-thread cap (16 warps of 1 vector) 1.68 and
//   25.0, no faster at any row count between; the 8 x 2 kernel held to 8
//   blocks an SM (__launch_bounds__(256, 8): 32 registers, 48 bytes
//   spilled a thread) 69.4 us at 4096 rows. So there is no row threshold:
//   one shape, at its own register count.
// - the scalar kernel where d % VEC != 0, up to kMaxScalar elements a
//   thread;
// - the wide kernel for rows beyond both (bf16/fp16 d > 32768, fp32
//   d > 16384, d % VEC != 0 beyond 8192): a strided loop that reads x twice,
//   the sum's pass and y's (the second read mostly from L2), as no thread's
//   registers hold its share.
// Planted faults (dstt_rms_norm_plant, tests only): 1 lane 31's partial sum
// is left out of every warp's sum; 2 the first vector of every row is not
// multiplied by the weight. Both reach every kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // most threads a row takes (every kernel)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVectors = 16;      // most 16-byte vectors a thread of the vector kernel holds
constexpr int kMaxScalar = 32;       // most elements a thread of the scalar kernel holds

int g_plant = 0;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum over the block of each warp's sum `v` (every lane of a warp
// holding it): one exchange through shared memory, one barrier; every
// thread adds the entries in warp order, so all get the same bits.
__device__ __forceinline__ float block_total(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (nw == 1) return v;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j)
    if (j < nw) s += part[j];
  return s;
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// Sum of squares of a 16-byte vector's VEC values.
template <typename T>
__device__ __forceinline__ float vec_sq(const uint4& v) {
  constexpr int VEC = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = to_f(e[k]);
    s = fmaf(f, f, s);
  }
  return s;
}

// y's vector from x's and w's (planted fault 2: the weight left off).
template <typename T>
__device__ __forceinline__ uint4 vec_out(const uint4& xv, const uint4& wv, float r, bool no_w) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 o;
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* we = reinterpret_cast<const T*>(&wv);
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int k = 0; k < VEC; ++k) oe[k] = from_f<T>((to_f(xe[k]) * r) * (no_w ? 1.f : to_f(we[k])));
  return o;
}

// Vector kernel: d % VEC == 0, nv = d / VEC <= blockDim.x * V, blockDim.x a
// multiple of 32 up to kThreads; vector k of thread i is i + k blockDim.x.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rms_norm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int d,
                    float eps, int plant) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[kWarps];
  const int nv = d / VEC;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nv;
  uint4 xv[V], wv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    xv[k] = wv[k] = make_uint4(0u, 0u, 0u, 0u);   // all-zero bits: 0.0
    if (i < nv) {
      xv[k] = xr[i];
      wv[k] = __ldg(reinterpret_cast<const uint4*>(w) + i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) ss += vec_sq<T>(xv[k]);
  if (plant == 1 && (threadIdx.x & 31) == 31) ss = 0.f;   // planted fault 1
  ss = block_total(warp_sum(ss), part);
  const float r = rsqrtf(ss / (float)d + eps);
  uint4* yr = reinterpret_cast<uint4*>(y) + row * nv;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) yr[i] = vec_out<T>(xv[k], wv[k], r, plant == 2 && i == 0);
  }
}

// Scalar kernel: any d <= blockDim.x * C, element k of thread i at
// i + k blockDim.x.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
rms_norm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                       int d, float eps, int plant) {
  __shared__ float part[kWarps];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  float xv[C], wv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    xv[c] = i < d ? to_f(xr[i]) : 0.f;
    wv[c] = i < d ? to_f(__ldg(w + i)) : 0.f;
  }
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) ss = fmaf(xv[c], xv[c], ss);
  if (plant == 1 && (threadIdx.x & 31) == 31) ss = 0.f;   // planted fault 1
  ss = block_total(warp_sum(ss), part);
  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    // planted fault 2: the first vector's worth of elements left unweighted
    const bool no_w = plant == 2 && i < 16 / (int)sizeof(T);
    if (i < d) yr[i] = from_f<T>((xv[c] * r) * (no_w ? 1.f : wv[c]));
  }
}

// Wide kernel: any d, kThreads threads; unit i (a 16-byte vector where
// d % VEC == 0, else an element) of thread t at i = t + k kThreads. x is
// read twice: for the sum, then for y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_wide_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                     int d, float eps, int plant) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[kWarps];
  const size_t row = blockIdx.x;
  const bool vec = d % VEC == 0;
  const int n = vec ? d / VEC : d;
  const T* xr = x + row * d;
  const uint4* xr4 = reinterpret_cast<const uint4*>(xr);
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (vec) {
      ss += vec_sq<T>(xr4[i]);
    } else {
      const float f = to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  if (plant == 1 && (threadIdx.x & 31) == 31) ss = 0.f;   // planted fault 1
  ss = block_total(warp_sum(ss), part);
  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = y + row * d;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (vec) {
      reinterpret_cast<uint4*>(yr)[i] = vec_out<T>(
          xr4[i], __ldg(reinterpret_cast<const uint4*>(w) + i), r, plant == 2 && i == 0);
    } else {
      const bool no_w = plant == 2 && i < VEC;   // planted fault 2
      yr[i] = from_f<T>((to_f(xr[i]) * r) * (no_w ? 1.f : to_f(__ldg(w + i))));
    }
  }
}

// Threads (a multiple of 32, at least 32, at most kThreads) for `work`
// items at `per` items a thread.
int threads_for(int work, int per) {
  int t = (work + per - 1) / per;
  t = (t + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kThreads ? kThreads : t);
}

template <typename T>
cudaError_t launch(const void* xp, const void* wp, void* yp, int n_rows, int d, float eps,
                   cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* y = static_cast<T*>(yp);
  const int nv = d / VEC, p = g_plant;
  if (d % VEC == 0 && nv <= kThreads * kMaxVectors) {
    int V = 1;
    while (nv > kThreads * V) V *= 2;
    const int threads = threads_for(nv, V);
    switch (V) {
      case 1: rms_norm_vec_kernel<T, 1><<<n_rows, threads, 0, s>>>(x, w, y, d, eps, p); break;
      case 2: rms_norm_vec_kernel<T, 2><<<n_rows, threads, 0, s>>>(x, w, y, d, eps, p); break;
      case 4: rms_norm_vec_kernel<T, 4><<<n_rows, threads, 0, s>>>(x, w, y, d, eps, p); break;
      case 8: rms_norm_vec_kernel<T, 8><<<n_rows, threads, 0, s>>>(x, w, y, d, eps, p); break;
      default: rms_norm_vec_kernel<T, 16><<<n_rows, threads, 0, s>>>(x, w, y, d, eps, p);
    }
  } else if (d % VEC != 0 && d <= kThreads * kMaxScalar) {
    const int threads = threads_for(d, 1);
    if ((d + threads - 1) / threads <= 4)
      rms_norm_scalar_kernel<T, 4><<<n_rows, threads, 0, s>>>(x, w, y, d, eps, p);
    else
      rms_norm_scalar_kernel<T, kMaxScalar><<<n_rows, threads, 0, s>>>(x, w, y, d, eps, p);
  } else {
    rms_norm_wide_kernel<T><<<n_rows, kThreads, 0, s>>>(x, w, y, d, eps, p);
  }
  return cudaGetLastError();
}

}  // namespace

// y = rms_norm(x, w) over rows of d. dtype: 0 bf16, 1 f32, 2 f16 (x, w and
// y alike).
extern "C" int dstt_rms_norm(const void* x, const void* w, void* y, int n_rows, int d,
                             float eps, int dtype, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<__nv_bfloat16>(x, w, y, n_rows, d, eps, s);
    case 1: return (int)launch<float>(x, w, y, n_rows, d, eps, s);
    case 2: return (int)launch<__half>(x, w, y, n_rows, d, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Plants a fault in the next launches of every RMSNorm kernel (tests only):
// 1 leaves lane 31's partial out of each warp's sum of squares, 2 leaves
// the weight off the first vector of every row; 0 none.
extern "C" int dstt_rms_norm_plant(int fault) {
  g_plant = fault;
  return 0;
}

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
