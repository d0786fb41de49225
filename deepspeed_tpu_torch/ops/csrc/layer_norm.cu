// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/norms.py `_ln_kernel` (pallas_call at
// :101, op `layer_norm`). Same function, row by row in fp32:
//   mean = mean(x); xc = x - mean; var = mean(xc^2);
//   y = (xc * rsqrt(var + eps)) * w + b, cast back to x's dtype.
// The variance comes from the centred values, as in the TPU kernel, not from
// E[x^2] - mean^2: with rows of large mean the latter cancels the digits the
// parity tolerance needs. `b` may be null (no bias). bf16, fp16 and fp32, as
// the Pallas kernel takes them.
//
// Bound on an H100 SXM: memory. Each row is read once and written once
// (2 * N * d * sizeof(T) bytes, plus 2 * d * sizeof(T) for w and b) against
// 3.35 TB/s; the arithmetic (about 8 flops per element) is negligible. At
// decode (N = 64 rows of d = 2048, 0.5 MiB in all) the launch and one
// dependent chain (an L2 or DRAM round trip, the reductions, the store) set
// the time, not the bytes; at a training micro-batch (thousands of rows)
// the rows in flight per SM do.
//
// Design, as measured on one H100 80GB HBM3 at 700 W (the variants below
// timed against each other and against a block-per-row kernel; PERF.md):
// - Calls of at most 4 rows per SM with d <= 256 vectors of 16 bytes (bf16 /
//   fp16 d <= 2048, fp32 d <= 1024: OPT-1.3B's and GPT-2's serving steps)
//   take the warp kernel: W = nv / 32 warps per row (1 for d <= 256 bf16, 8
//   at 2048), one vector a lane, the row's loads and those of w and b all
//   issued first; each warp sums its share by __shfl_xor_sync alone (no
//   shared memory, no barrier), takes its mean and its centred sum of
//   squares the same way, and W > 1 warps exchange (mean, M2) once through
//   shared memory: one __syncthreads, then every thread merges the W entries
//   by Chan's formula in a fixed pairwise tree (the variance stays centred:
//   delta^2 na nb / n is added, never a difference of squares; every warp
//   computes the same bits). Index arithmetic by shifts: a division by a
//   runtime W before the first load cost ~0.4 us. [64 x 2048]: 1.79 us
//   against the block kernel's 2.01.
// - Everything else of a vector width runs the block kernel: one block of
//   up to 256 threads per row, 1-8 vectors a thread, two block-wide sums.
//   Measured against it, a warp holding a whole row in registers (8 vectors
//   a lane, 178 registers) or 2-4 warps a row ran 13-29% slower at
//   [8192 x 2048] and [4096 x 4096]: its registers left fewer rows in flight
//   per SM, while the block kernel's 32 registers fill an SM with 8 rows.
// - Rows not a multiple of the vector width, or wider than 8 vectors a
//   thread, take the scalar kernel (block per row, the row re-read).
// Planted fault 1 (dstt_layer_norm_plant, tests only): in the warp kernel,
// lane 31's share of the centred sum of squares is left out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCache = 8;      // most 16-byte vectors a thread of the block kernel keeps
constexpr int kMaxWarps = 8;      // most warps a row takes in the warp kernel
constexpr int kWarpRowsPerSM = 4; // the warp kernel takes calls of at most this many rows an SM

int g_plant = 0;

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

// Chan's merge of two groups' (count, mean, centred sum of squares), group
// a taken first: the variance stays centred (delta^2 na nb / n is added,
// never a difference of squares). The counts here are multiples of the
// vector width, so nb / n is 1/2 whenever the groups are equal.
__device__ __forceinline__ void merge(float& na, float& ma, float& qa, float nb, float mb,
                                      float qb) {
  const float n = na + nb;
  if (nb == 0.f) return;
  const float delta = mb - ma, f = __fdividef(nb, n);
  ma = fmaf(delta, f, ma);
  qa = qa + qb + delta * delta * na * f;
  na = n;
}

// Sum of the VEC values of a 16-byte vector (SQ: of their squared distances
// from mean), as a balanced tree.
template <typename T, bool SQ>
__device__ __forceinline__ float vec_sum(const uint4& v, float mean) {
  constexpr int VEC = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
  float t[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = to_f(e[k]) - mean;
    t[k] = SQ ? f * f : f;
  }
#pragma unroll
  for (int w = VEC / 2; w > 0; w >>= 1)
#pragma unroll
    for (int k = 0; k < w; ++k) t[k] += t[k + w];
  return t[0];
}

// Warp kernel: d % VEC == 0 and d / VEC <= 32 * W, W = 2^lw warps per row
// (W <= kMaxWarps; blockDim.x = 32 W), one vector a lane.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ y, int d, float eps, int lw,
                       int plant) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float2 part[kMaxWarps];
  const int W = 1 << lw, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = d / VEC, i = threadIdx.x;
  const size_t row = blockIdx.x;

  // the row's vector, w's and b's in flight before the first use
  uint4 xv = make_uint4(0u, 0u, 0u, 0u), wv = xv, bv = xv;   // all-zero bits: 0.0
  if (i < nv) {
    xv = reinterpret_cast<const uint4*>(x)[row * nv + i];
    wv = __ldg(reinterpret_cast<const uint4*>(w) + i);
    if (b != nullptr) bv = __ldg(reinterpret_cast<const uint4*>(b) + i);
  }

  // this warp's mean and centred sum of squares over its share, by shuffles
  // alone (1 / count taken while the loads are in flight)
  const float n_w = (float)(min(32, max(0, nv - warp * 32)) * VEC);
  const float inv_n = n_w > 0.f ? 1.f / n_w : 0.f;
  float mean = warp_sum(vec_sum<T, false>(xv, 0.f)) * inv_n;
  float q = i < nv ? vec_sum<T, true>(xv, mean) : 0.f;
  if (plant == 1 && lane == 31) q = 0.f;   // planted fault 1
  q = warp_sum(q);
  if (W > 1) {
    // one exchange; every thread merges the W entries by the same tree
    if (lane == 0) part[warp] = make_float2(mean, q);
    __syncthreads();
    float nn[kMaxWarps], mm[kMaxWarps], qq[kMaxWarps];
#pragma unroll
    for (int j = 0; j < kMaxWarps; ++j) {
      const float2 e = j < W ? part[j] : make_float2(0.f, 0.f);
      nn[j] = j < W ? (float)(min(32, max(0, nv - j * 32)) * VEC) : 0.f;
      mm[j] = e.x;
      qq[j] = e.y;
    }
#pragma unroll
    for (int h = 1; h < kMaxWarps; h <<= 1)
#pragma unroll
      for (int j = 0; j < kMaxWarps; j += 2 * h)
        merge(nn[j], mm[j], qq[j], nn[j + h], mm[j + h], qq[j + h]);
    mean = mm[0];
    q = qq[0];
  }
  if (i >= nv) return;
  const float r = rsqrtf(q / (float)d + eps);
  uint4 oraw;
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* we = reinterpret_cast<const T*>(&wv);
  const T* be = reinterpret_cast<const T*>(&bv);
  T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    oe[k] = from_f<T>(((to_f(xe[k]) - mean) * r) * to_f(we[k]) + to_f(be[k]));
  reinterpret_cast<uint4*>(y)[row * nv + i] = oraw;
}

// Block kernel (one block per row; calls of many rows, rows wider than 256
// vectors): d % VEC == 0 and d / VEC <= blockDim.x * C.
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
      uint4 braw = make_uint4(0u, 0u, 0u, 0u);   // all-zero bits: 0.0
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

// Scalar path: any d; one block per row, three passes over the row.
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

// SMs of the current device, read once.
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  cudaError_t err = cudaSuccess;
  if (cached == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
  }
  *sms = cached;
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int n_rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  const int nv = d / VEC;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (d % VEC == 0 && nv <= 32 * kMaxWarps && n_rows <= kWarpRowsPerSM * sms) {
    int lw = 0;   // log2 of the warps per row
    while (nv > 32 << lw) ++lw;
    layer_norm_warp_kernel<T><<<n_rows, 32 << lw, 0, stream>>>(xp, wp, bp, yp, d, eps, lw,
                                                              g_plant);
    return cudaGetLastError();
  }
  const bool vec = d % VEC == 0 && nv <= kMaxThreads * kMaxCache;
  const int work = vec ? nv : d;
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

// b may be null (no bias). dtype: 0 bf16, 1 f32, 2 f16 (x, w, b and y alike).
extern "C" int dstt_layer_norm(const void* x, const void* w, const void* b, void* y,
                               int n_rows, int d, float eps, int dtype, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<__nv_bfloat16>(x, w, b, y, n_rows, d, eps, s);
    case 1: return (int)launch<float>(x, w, b, y, n_rows, d, eps, s);
    case 2: return (int)launch<__half>(x, w, b, y, n_rows, d, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Plants a fault in the next launches of the warp kernel (tests only): 1
// leaves lane 31's share out of the centred sum of squares; 0 none. The
// block and scalar kernels take no fault.
extern "C" int dstt_layer_norm_plant(int fault) {
  g_plant = fault;
  return 0;
}
