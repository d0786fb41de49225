// Paged attention over t query rows per sequence, bf16 or int8 pools, for
// Hopper (sm_90a). Shared by paged_decode.cu (its int8 mode: t = 1) and
// paged_verify.cu (speculative verification: t = k + 1 rows, bf16 or int8).
//
// Replaces, in deepspeed_tpu/ops/pallas/paged_attention.py: `_decode_kernel`
// (:74) in its int8 mode (`quant=True`, `_dequant_tile` :58) and
// `_spec_verify_kernel` (:315, via `paged_spec_verify_attention` :390) in
// both modes. Row ti of sequence b sits at position ctx+ti and attends the
// positions <= ctx+ti of its K/V, read straight out of the block pools
// through the block table (and, with a window w, only those > ctx+ti-w).
//
//   q            [B, t, nh, hd]              bf16 (t = 1: [B, nh, hd])
//   k/v pool     [num_blocks, nkv, bs, hd]   bf16, or int8 codes
//   k/v scale    [num_blocks, nkv, bs, ng]   fp32 (int8 mode): element d of a
//                row is code * scale[d / (hd / ng)]
//   block_tables [B, max_blocks]             int32
//   context_lens [B]                         int32
//   window       none, a static int >= 1, or a 0-d int32 device tensor
//                (clamped to >= 1)
//   out          like q                      bf16
//
// Bound on an H100 SXM: memory. The least traffic is the K and V rows (and
// their scale rows) of the positions some row can see, read once, plus q and
// out: in int8 at hd 128 and ng 1, 132 bytes per position, kv head and
// tensor against 256 in bf16. The products are 4 flops per (query row,
// position, dim): with g*t = 20 rows (GQA 4, t = 5) about 20 flop per byte
// of bf16 K/V, far under the tensor-core ridge near 295.
//
// Design: the paged-decode kernel's (paged_decode.cu) with its g query rows
// generalized to R = g*t rows, g-major and t-minor as the TPU kernel folds
// them. One block per (kv head, sequence) walks only the positions any of
// its rows can see, [max(ctx-w+1, 0), min(ctx+t, cap)), in tiles of 128:
// each tile's K and V rows go to shared memory with 16-byte loads and are
// read from there for all R rows, so each K/V row leaves device memory once.
// In int8 mode the tile holds the codes (half the bytes) and their fp32
// scale rows; codes become floats in registers right before the products
// and no pass over the pool converts it first. Scores: one thread per
// position, R rows in passes of kRowChunk (registers stay bounded for any
// R); the per-row limits pos <= ctx+ti (and pos > ctx+ti-w) apply inside
// the tile. Softmax: fp32 online, one warp per row; a row with no visible
// position in a tile keeps its running state, and a row that sees nothing
// at all writes 0, as the TPU kernel's `_finish` does. At ng = 1 the V
// scale of a position is folded into its probability once per (row,
// position) instead of once per element. Not done here: tensor cores
// (mma.sync over 16-row tiles), cp.async stages, split-K over positions.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace dstt_rows {

constexpr int kThreads = 128;   // threads per block
constexpr int kTile = 128;      // positions per tile: one per thread
constexpr int kRowChunk = 8;    // query rows scored per pass over a K row
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

struct Args {
  const __nv_bfloat16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* ctx_lens;
  const int* window_ptr;
  int window_static;
  __nv_bfloat16* out;
  int B, t, nh, nkv, bs, num_blocks, max_blocks, ng;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool QUANT>
using code_t = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;

__host__ __device__ inline size_t smem_bytes(int hd, bool quant, int rows, int ng) {
  const size_t esz = quant ? 1 : 2;
  return (size_t)kTile * (hd * esz + 16)          // K tile, rows padded by 16 bytes
         + (size_t)kTile * hd * esz               // V tile
         + (quant ? (size_t)2 * kTile * ng * 4 : 0)  // K and V scale rows
         + (size_t)rows * hd * 4 * 2              // q, acc
         + (size_t)rows * kTile * 4               // p
         + (size_t)rows * 3 * 4;                  // m, l, alpha
}

// 16 bytes of a tile row as floats: 8 bf16 values or 16 int8 codes
__device__ __forceinline__ void unpack(const uint4& raw, float* f, std::false_type) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float* f, std::true_type) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) f[e] = static_cast<float>(c[e]);
}

template <int HD, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_rows_kernel(const Args a) {
  using T = code_t<QUANT>;
  constexpr int ESZ = sizeof(T);
  constexpr int EPC = 16 / ESZ;        // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;        // chunks per K/V row
  constexpr int KROW = HD + EPC;       // K row stride in shared memory (16 bytes of padding)
  constexpr int nwarps = kThreads / 32;
  const int h = blockIdx.x;            // kv head
  const int b = blockIdx.y;            // sequence
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = a.t, g = a.nh / a.nkv, R = g * t, ng = a.ng;
  const int gs = HD / ng;              // int8 mode: lanes per scale group

  extern __shared__ uint4 smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);                            // [kTile][KROW]
  T* v_s = k_s + kTile * KROW;                                        // [kTile][HD]
  float* ks_s = reinterpret_cast<float*>(v_s + kTile * HD);           // [kTile][ng]
  float* vs_s = ks_s + (QUANT ? kTile * ng : 0);                      // [kTile][ng]
  float* q_s = vs_s + (QUANT ? kTile * ng : 0);                       // [R][HD]
  float* acc_s = q_s + R * HD;                                        // [R][HD]
  float* p_s = acc_s + R * HD;                                        // [R][kTile]
  float* m_s = p_s + R * kTile;                                       // [R]
  float* l_s = m_s + R;                                               // [R]
  float* alpha_s = l_s + R;                                           // [R]

  const int ctx = a.ctx_lens[b];
  const int cap = a.max_blocks * a.bs;
  int hi = ctx + t;                                   // exclusive: the newest row's position + 1
  if (hi > cap) hi = cap;
  const bool has_w = a.window_ptr != nullptr || a.window_static > 0;
  int w = 0, lo = 0;
  if (has_w) {
    w = a.window_ptr != nullptr ? *a.window_ptr : a.window_static;
    if (w < 1) w = 1;
    lo = ctx - w + 1;                                 // the oldest row's window start
    if (lo < 0) lo = 0;
  }

  // row r = gi * t + ti reads query head h * g + gi at step ti
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int gi = r / t, ti = r - gi * t;
    const size_t row = ((size_t)b * t + ti) * a.nh + (size_t)h * g + gi;
    q_s[i] = __bfloat162float(a.q[row * HD + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const int* table = a.tables + (size_t)b * a.max_blocks;
  for (int p0 = lo; p0 < hi; p0 += kTile) {
    const int n = min(kTile, hi - p0);
    // K/V rows (and scale rows) of positions p0 .. p0+n-1 into shared memory
    for (int i = tid; i < n * CPR; i += kThreads) {
      const int tt = i / CPR, c = i - tt * CPR;
      const int pos = p0 + tt;
      const int j = pos / a.bs;
      int blk = table[j];
      blk = blk < 0 ? 0 : (blk >= a.num_blocks ? a.num_blocks - 1 : blk);
      const size_t row = (((size_t)blk * a.nkv + h) * a.bs + (pos - j * a.bs)) * HD;
      const uint4 kk = reinterpret_cast<const uint4*>(kp + row)[c];
      const uint4 vv = reinterpret_cast<const uint4*>(vp + row)[c];
      *reinterpret_cast<uint4*>(k_s + tt * KROW + c * EPC) = kk;
      *reinterpret_cast<uint4*>(v_s + tt * HD + c * EPC) = vv;
    }
    if constexpr (QUANT) {
      for (int i = tid; i < n * ng; i += kThreads) {
        const int tt = i / ng, gg = i - tt * ng;
        const int pos = p0 + tt;
        const int j = pos / a.bs;
        int blk = table[j];
        blk = blk < 0 ? 0 : (blk >= a.num_blocks ? a.num_blocks - 1 : blk);
        const size_t srow = (((size_t)blk * a.nkv + h) * a.bs + (pos - j * a.bs)) * ng + gg;
        ks_s[i] = a.k_scale[srow];
        vs_s[i] = a.v_scale[srow];
      }
    }
    __syncthreads();

    // scores: thread tid scores position p0 + tid against every row
    const int pos = p0 + tid;
    for (int r0 = 0; r0 < R; r0 += kRowChunk) {
      float s[kRowChunk];
#pragma unroll
      for (int rr = 0; rr < kRowChunk; ++rr) s[rr] = 0.f;
      if (tid < n) {
#pragma unroll 2
        for (int c = 0; c < CPR; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(k_s + tid * KROW + c * EPC);
          float kf[EPC];
          unpack(raw, kf, std::integral_constant<bool, QUANT>());
          float ksc = 1.f;
          if constexpr (QUANT) ksc = ks_s[tid * ng + (c * EPC) / gs];
#pragma unroll
          for (int rr = 0; rr < kRowChunk; ++rr) {
            if (r0 + rr < R) {
              const float* qr = q_s + (r0 + rr) * HD + c * EPC;
              float dot = 0.f;
#pragma unroll
              for (int e = 0; e < EPC; e += 4) {
                const float4 qa = *reinterpret_cast<const float4*>(qr + e);
                dot += qa.x * kf[e] + qa.y * kf[e + 1] + qa.z * kf[e + 2] + qa.w * kf[e + 3];
              }
              s[rr] += QUANT ? dot * ksc : dot;
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowChunk; ++rr) {
        const int r = r0 + rr;
        if (r < R) {
          const int lim = ctx + (r % t);              // row r sits at ctx + ti
          const bool ok = tid < n && pos <= lim && (!has_w || pos > lim - w);
          p_s[r * kTile + tid] = ok ? s[rr] * a.scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row; at ng = 1 the V scale of each
    // position is folded into its probability
    for (int r = warp; r < R; r += nwarps) {
      float* pr = p_s + r * kTile;
      float mx = -INFINITY;
      for (int tt = lane; tt < kTile; tt += 32) mx = fmaxf(mx, pr[tt]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // nothing visible yet
      float sum = 0.f;
      for (int tt = lane; tt < kTile; tt += 32) {
        const float e = expf(pr[tt] - m_use);
        sum += e;
        if constexpr (QUANT) pr[tt] = (ng == 1 && tt < n) ? e * vs_s[tt] : e;
        else pr[tt] = e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha[r] + sum_t p[r][t] * v[t][d]
    for (int i = tid; i < R * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const float* pr = p_s + r * kTile;
      float acc = acc_s[i] * alpha_s[r];
      if constexpr (QUANT) {
        if (ng == 1) {
          for (int tt = 0; tt < n; ++tt) acc += pr[tt] * static_cast<float>(v_s[tt * HD + d]);
        } else {
          const float* vsc = vs_s + d / gs;
          for (int tt = 0; tt < n; ++tt)
            acc += pr[tt] * (static_cast<float>(v_s[tt * HD + d]) * vsc[tt * ng]);
        }
      } else {
        for (int tt = 0; tt < n; ++tt) acc += pr[tt] * __bfloat162float(v_s[tt * HD + d]);
      }
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int gi = r / t, ti = r - gi * t;
    const size_t row = ((size_t)b * t + ti) * a.nh + (size_t)h * g + gi;
    float l = l_s[r];
    l = (l == 0.f) ? 1.f : l;
    a.out[row * HD + d] = __float2bfloat16(acc_s[i] / l);
  }
}

template <int HD, bool QUANT>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
  const int rows = (a.nh / a.nkv) * a.t;
  const size_t smem = smem_bytes(HD, QUANT, rows, QUANT ? a.ng : 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = paged_rows_kernel<HD, QUANT>;
  // above 48 KB dynamic shared memory must be opted into; set on every
  // launch (a host-side attribute write) so each device sees it
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nkv, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Checks the shapes the kernel takes and launches it; returns a cudaError_t.
template <bool QUANT>
cudaError_t launch(const Args& a, int hd, cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  if (a.nkv <= 0 || a.nh % a.nkv != 0 || a.t < 1 || a.bs < 1) return cudaErrorInvalidValue;
  if (QUANT && (a.ng < 1 || hd % (16 * a.ng) != 0)) return cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_hd<64, QUANT>(a, stream);
    case 128: return launch_hd<128, QUANT>(a, stream);
    case 256: return launch_hd<256, QUANT>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dstt_rows
