// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py `_decode_kernel`
// (pallas_call at :230, via `paged_decode_attention` :146, op
// `paged_decode_attention`) in its bf16 mode, with and without a sliding
// window. One query token per sequence attends the first ctx+1 positions of
// its K/V, read straight out of the shared block pools through the block
// table, with an fp32 online softmax.
//
// The int8 mode (`quant=True`: int8 code pools with fp32 scale rows,
// dequantized in registers) is `dstt_paged_decode_int8` at the end of this
// file: the t = 1 instantiation of the kernel in paged_rows.cuh, which
// paged_verify.cu shares. The bf16 kernel below is separate and unchanged by it.
//
//   q            [B, nh, hd]                 bf16
//   k/v pool     [num_blocks, nkv, bs, hd]   bf16 (block 0 = trash block)
//   block_tables [B, max_blocks]             int32
//   context_lens [B]                         int32 (attends ctx+1 positions)
//   window       none, a static int >= 1, or a 0-d int32 device tensor
//                (clamped to >= 1): only positions (ctx - window, ctx] count
//   out          [B, nh, hd]                 bf16
//
// Bound on an H100 SXM: memory. The least traffic is the live K and V rows,
// sum_b live_tokens(b) * nkv * hd * 2 (K and V) * 2 bytes, against
// 3.35 TB/s; the products are 4 flops per (query row, position, dim) pair,
// two orders of magnitude under the tensor-core line at g = 4.
//
// Design: one block per (kv head, sequence); the block handles the
// g = nh / nkv query rows of that group together, so each K/V row is read
// from device memory once for all g rows. The block reads its own table
// row and context length and walks only the live positions [lo, ctx+1), in
// tiles of 128 positions: a tile's K and V rows are copied to shared memory
// with 16-byte loads (a block-table row is bs * hd contiguous elements, so
// neighbouring threads read neighbouring addresses), then each thread scores
// one position against the g query rows (K rows padded by 16 bytes so the
// row-per-thread reads do not collide on banks), one warp per query row
// updates the running max and sum, and each thread accumulates its
// (row, dim) outputs. Inactive slots (ctx = 0 on the trash block) attend
// exactly position 0, as in the TPU kernel. With B = 64 slots and nkv = 8
// the grid has 512 blocks; with few live slots and short contexts it
// underfills the 132 SMs — splitting one sequence's positions across blocks
// with a combine pass (split-K) is the next step and is not done here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "paged_rows.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 128;     // positions per tile: one per thread
constexpr int kPad = 8;        // bf16 elements of padding per K row in shared memory

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

template <int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int* __restrict__ tables, const int* __restrict__ ctx_lens,
                    const int* __restrict__ window_ptr, int window_static,
                    __nv_bfloat16* __restrict__ out,
                    int nh, int nkv, int g, int bs, int num_blocks, int max_blocks,
                    float scale) {
  constexpr int CPR = HD / 8;          // 16-byte chunks per K/V row
  constexpr int KROW = HD + kPad;      // K row stride in shared memory
  const int h = blockIdx.x;            // kv head
  const int b = blockIdx.y;            // sequence
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;

  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kTile][KROW]
  __nv_bfloat16* v_s = k_s + kTile * KROW;                             // [kTile][HD]
  float* q_s = reinterpret_cast<float*>(v_s + kTile * HD);             // [g][HD]
  float* p_s = q_s + g * HD;                                           // [g][kTile]
  float* acc_s = p_s + g * kTile;                                      // [g][HD]
  float* m_s = acc_s + g * HD;                                         // [g]
  float* l_s = m_s + g;                                                // [g]
  float* alpha_s = l_s + g;                                            // [g]

  const int ctx = ctx_lens[b];
  int hi = ctx + 1;                                   // exclusive
  const int cap = max_blocks * bs;
  if (hi > cap) hi = cap;
  int lo = 0;
  if (window_ptr != nullptr || window_static > 0) {
    int w = window_ptr != nullptr ? *window_ptr : window_static;
    if (w < 1) w = 1;
    lo = ctx - w + 1;
    if (lo < 0) lo = 0;
  }

  const size_t q_row0 = (size_t)b * nh + (size_t)h * g;
  for (int i = tid; i < g * HD; i += kThreads) {
    q_s[i] = __bfloat162float(q[q_row0 * HD + i]);
    acc_s[i] = 0.f;
  }
  if (tid < g) { m_s[tid] = -INFINITY; l_s[tid] = 0.f; }
  __syncthreads();

  const int* table = tables + (size_t)b * max_blocks;
  for (int p0 = lo; p0 < hi; p0 += kTile) {
    const int n = min(kTile, hi - p0);
    // K/V rows of positions p0 .. p0+n-1 into shared memory
    for (int i = tid; i < n * CPR; i += kThreads) {
      const int t = i / CPR, c = i - t * CPR;
      const int p = p0 + t;
      const int j = p / bs;
      int blk = table[j];
      blk = blk < 0 ? 0 : (blk >= num_blocks ? num_blocks - 1 : blk);
      const size_t row = (((size_t)blk * nkv + h) * bs + (p - j * bs)) * HD;
      const uint4 kk = reinterpret_cast<const uint4*>(k_pool + row)[c];
      const uint4 vv = reinterpret_cast<const uint4*>(v_pool + row)[c];
      *reinterpret_cast<uint4*>(k_s + t * KROW + c * 8) = kk;
      *reinterpret_cast<uint4*>(v_s + t * HD + c * 8) = vv;
    }
    __syncthreads();

    // scores: thread tid scores position p0 + tid against the g query rows
    if (tid < n) {
      float s[GMAX];
#pragma unroll
      for (int r = 0; r < GMAX; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        const uint4 kk = *reinterpret_cast<const uint4*>(k_s + tid * KROW + c * 8);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kk);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < GMAX; ++r) {
          if (r < g) {
            const float4 qa = *reinterpret_cast<const float4*>(q_s + r * HD + c * 8);
            const float4 qb = *reinterpret_cast<const float4*>(q_s + r * HD + c * 8 + 4);
            s[r] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                    qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < g) p_s[r * kTile + tid] = s[r] * scale;
    } else {
      for (int r = 0; r < g; ++r) p_s[r * kTile + tid] = -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < g; r += nwarps) {
      float mx = -INFINITY;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, p_s[r * kTile + t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);   // finite: every tile holds a live position
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float e = expf(p_s[r * kTile + t] - m_new);
        p_s[r * kTile + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha[r] + sum_t p[r][t] * v[t][d]
    for (int i = tid; i < g * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const float* pr = p_s + r * kTile;
      float a = acc_s[i] * alpha_s[r];
      for (int t = 0; t < n; ++t) a += pr[t] * __bfloat162float(v_s[t * HD + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD;
    float l = l_s[r];
    l = (l == 0.f) ? 1.f : l;
    out[q_row0 * HD + i] = __float2bfloat16(acc_s[i] / l);
  }
}

size_t smem_bytes(int hd, int g) {
  return (size_t)kTile * (hd + kPad) * 2 + (size_t)kTile * hd * 2 +
         (size_t)g * hd * 4 * 2 + (size_t)g * kTile * 4 + (size_t)g * 3 * 4;
}

template <int HD, int GMAX>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* ctx, const int* window_ptr, int window_static, void* out,
                   int B, int nh, int nkv, int bs, int num_blocks, int max_blocks,
                   float scale, cudaStream_t stream) {
  const int g = nh / nkv;
  const size_t smem = smem_bytes(HD, g);
  auto kernel = paged_decode_kernel<HD, GMAX>;
  // above 48 KB dynamic shared memory must be opted into; set on every
  // launch (a host-side attribute write) so each device sees it
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), tables, ctx, window_ptr, window_static,
      static_cast<__nv_bfloat16*>(out), nh, nkv, g, bs, num_blocks, max_blocks, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                      const int* ctx, const int* window_ptr, int window_static, void* out,
                      int B, int nh, int nkv, int bs, int num_blocks, int max_blocks,
                      float scale, cudaStream_t stream) {
  const int g = nh / nkv;
#define DSTT_LAUNCH(G)                                                                 \
  return launch<HD, G>(q, k_pool, v_pool, tables, ctx, window_ptr, window_static, out, \
                       B, nh, nkv, bs, num_blocks, max_blocks, scale, stream)
  if (g <= 1) DSTT_LAUNCH(1);
  if (g <= 2) DSTT_LAUNCH(2);
  if (g <= 4) DSTT_LAUNCH(4);
  if (g <= 8) DSTT_LAUNCH(8);
  if (g <= 16) DSTT_LAUNCH(16);
#undef DSTT_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dstt_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const void* tables, const void* ctx, const void* window_ptr,
                                 int window_static, void* out, int B, int nh, int nkv, int hd,
                                 int bs, int num_blocks, int max_blocks, float scale,
                                 void* stream) {
  if (B == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* c = static_cast<const int*>(ctx);
  const int* w = static_cast<const int*>(window_ptr);
  switch (hd) {
    case 64:
      return (int)launch_hd<64>(q, k_pool, v_pool, t, c, w, window_static, out, B, nh, nkv,
                                bs, num_blocks, max_blocks, scale, s);
    case 128:
      return (int)launch_hd<128>(q, k_pool, v_pool, t, c, w, window_static, out, B, nh, nkv,
                                 bs, num_blocks, max_blocks, scale, s);
    case 256:
      return (int)launch_hd<256>(q, k_pool, v_pool, t, c, w, window_static, out, B, nh, nkv,
                                 bs, num_blocks, max_blocks, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// int8 pools: codes [num_blocks, nkv, bs, hd] int8, scales [num_blocks, nkv,
// bs, ng] fp32; q and out bf16 [B, nh, hd].
extern "C" int dstt_paged_decode_int8(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* tables, const void* ctx,
                                      const void* window_ptr, int window_static, void* out,
                                      int B, int nh, int nkv, int hd, int bs, int num_blocks,
                                      int max_blocks, int ng, float scale, void* stream) {
  dstt_rows::Args a{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const int*>(tables), static_cast<const int*>(ctx),
                    static_cast<const int*>(window_ptr), window_static,
                    static_cast<__nv_bfloat16*>(out),
                    B, /*t=*/1, nh, nkv, bs, num_blocks, max_blocks, ng, scale};
  return (int)dstt_rows::launch<true>(a, hd, static_cast<cudaStream_t>(stream));
}
