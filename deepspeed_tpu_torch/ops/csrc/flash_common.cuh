// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// and the block-sparse kernels (sparse_attention.cu).
//
// Layout at the C interface is the JAX package's: q/o/dq [B, Sq, H, D],
// k/v/dk/dv [B, Skv, Hkv, D] (narrow K/V: query head h reads kv head
// h / (H / Hkv)), lse/delta [B * H, Sq] fp32. Every kernel indexes those
// tensors with their strides, so nothing is transposed or widened.
//
// Products run per warp on 16-row tiles held in shared memory. bf16 tiles go
// through the tensor cores with mma.sync.m16n8k16 (fp32 accumulation),
// fragments loaded with ldmatrix (.trans for the transposed operands); fp32
// tiles take a plain FMA loop that fills the same accumulator layout, so the
// softmax and epilogue code is one for both types. Accumulator layout (the
// mma C fragment): lane = 4 * gr + tq holds rows gr and gr + 8 of the warp's
// 16 rows, columns 8 * nt + 2 * tq and + 1 of each 8-column tile nt.
//
// Bias mode (the TPU's `has_bias`): an additive logits bias, bf16 or fp32,
// read in place through four element strides (batch, query head, q row, kv
// row), any of which may be 0, so a broadcast bias ([H, 1, Skv] ALiBi, an
// MSA pair bias shared by every row) is never copied to [B, H, Sq, Skv].
// With a bias the kernels keep the softmax in natural units (x = scale *
// q.k + bias, p = 2^((x - m) log2 e)): a row whose every key carries a
// -1e30 mask bias then has m = -1e30 and p = 1 on each key, a uniform
// average as in the JAX package, and the backward's x - lse is exactly 0
// there; base-2 units would turn those 1e30-sized values into an
// exponent of a rounding error.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dstt_flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;   // lse of a row that sees no key, as in the JAX package

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // backward only
  const float* lse;     // backward input
  const float* delta;   // backward input: rowsum(dO * O)
  void* o;              // forward output
  float* lse_out;       // forward output
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, Sq, Skv;
  int q_offset;         // absolute position of q row 0 in the kv sequence (causal only)
  int causal;
  int window;           // > 0: causal sliding window length; 0: none
  float scale;
};

// The bias mode's inputs, a kernel parameter of their own: with these fields
// inside Args, nvcc compiled the no-bias kernels' unchanged text into other
// code (the dQ kernel 44% slower on an H100, scripts/flash_ab_timing.py).
struct Bias {
  const void* ptr;      // additive logits bias, bf16 or fp32; null: no bias
  long long sb, sh, sq, sk;   // its element strides (batch, query head, q row, kv row)
  int f32;              // 1: fp32 bias; 0: bf16
  float* dbias;         // dQ kernel: fp32 [B, H, Sq, Skv] dL/dlogits, or null
};

// The bias at (batch b, query head h, q row, kv row); only visible
// positions are read.
__device__ __forceinline__ float bias_at(const Bias& bb, int b, int h, int qrow, int kvrow) {
  const long long i = (long long)b * bb.sb + (long long)h * bb.sh + (long long)qrow * bb.sq +
                      (long long)kvrow * bb.sk;
  return bb.f32 ? __ldg(static_cast<const float*>(bb.ptr) + i)
                : __bfloat162float(static_cast<const __nv_bfloat16*>(bb.ptr)[i]);
}

// The one visibility rule of all three kernels (the TPU's _block_mask).
__device__ __forceinline__ bool visible(const Args& a, int qrow, int kvrow) {
  if (qrow >= a.Sq || kvrow >= a.Skv) return false;
  if (!a.causal) return true;
  const int qpos = qrow + a.q_offset;
  if (kvrow > qpos) return false;
  return a.window <= 0 || qpos - kvrow < a.window;
}

template <typename T> struct Pad { static constexpr int value = 16 / sizeof(T); };

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// rows [row0, row0 + rows) of a [*, D] matrix with row stride gstride
// (elements) into shared memory with row stride D + Pad, by a block of NTH
// threads; rows at or past n_valid read as zero. 16-byte vectors,
// neighbouring threads on neighbouring addresses.
template <typename T, int D, int NTH>
__device__ __forceinline__ void load_rows_n(T* sm, const T* g, int row0, int n_valid, int rows,
                                            size_t gstride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + Pad<T>::value;
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += NTH) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * gstride + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = val;
  }
}

// load_rows_n for the flash kernels' blocks of kThreads threads.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* sm, const T* g, int row0, int n_valid, int rows,
                                          size_t gstride) {
  load_rows_n<T, D, kThreads>(sm, g, row0, n_valid, rows, gstride);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte cp.async copies from global into shared memory (L2 only), their
// commit, and the wait until at most N groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory into mma fragments; lane l gives
// the address of one row of matrix l / 8 (16-byte aligned). .trans delivers
// each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc[NT][4] += A[16 x K] * B[K x 8 NT]. A is row-major at a (row stride
// lda). B's element (k, n) is b[n * ldb + k] (B_KN false: rows of B^T, as K
// is stored for Q K^T) or b[k * ldb + n] (B_KN true, as V is stored for P V).
// Fragments come from ldmatrix: one x4 load gives A's 16 x 16 tile, another
// the two 8-column B tiles nt and nt + 1 (transposed for B_KN). Row strides
// of 16-byte multiples keep every row address aligned and the eight rows of
// a matrix on distinct banks.
template <int NT, int K, bool B_KN>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb) {
  static_assert(NT % 2 == 0, "B tiles are loaded in pairs");
  const int lane = threadIdx.x & 31;
  const int arow = lane & 15, acol = (lane >> 4) * 8;     // A: matrices (rows, k half)
  const int brow = lane & 7, bk = ((lane >> 3) & 1) * 8;  // B: row within 8, k half
  const int bn = (lane >> 4) * 8;                         // B: tile nt or nt + 1
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + arow * lda + kk + acol);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      if constexpr (!B_KN)
        ldsm_x4(bf, b + (nt * 8 + bn + brow) * ldb + kk + bk);
      else
        ldsm_x4_trans(bf, b + (kk + bk + brow) * ldb + nt * 8 + bn);
      mma_bf16(acc[nt], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
    }
  }
}

template <int NT, int K, bool B_KN>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, int lda,
                                         const float* b, int ldb) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[gr * lda + k], a1 = a[(gr + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * tq;
      float b0, b1;
      if constexpr (!B_KN) {
        b0 = b[n * ldb + k];
        b1 = b[(n + 1) * ldb + k];
      } else {
        b0 = b[k * ldb + n];
        b1 = b[k * ldb + n + 1];
      }
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

// A warp's accumulator tile, rounded to T, into shared memory (row-major).
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* sm, int ld, const float (&v)[NT][4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * tq;
    sm[gr * ld + c] = from_f<T>(v[nt][0]);
    sm[gr * ld + c + 1] = from_f<T>(v[nt][1]);
    sm[(gr + 8) * ld + c] = from_f<T>(v[nt][2]);
    sm[(gr + 8) * ld + c + 1] = from_f<T>(v[nt][3]);
  }
}

// A warp's [16 x 8 NT] accumulator, times `mul` per row half, to rows
// row_lo and row_lo + 8 of a global [*, 8 NT] matrix with row stride gstride;
// rows at or past n_valid are not written.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* g, size_t gstride, int row_lo, int n_valid,
                                           const float (&v)[NT][4], float mul0, float mul1) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= n_valid) continue;
    const float mul = half ? mul1 : mul0;
    T* gr = g + (size_t)row * gstride;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tq;
      gr[c] = from_f<T>(v[nt][2 * half] * mul);
      gr[c + 1] = from_f<T>(v[nt][2 * half + 1] * mul);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The backward kernels' inputs (flash_bwd.cu, flash_bwd_sm90.cu); the
// outputs are set by each entry point.
inline Args bwd_args(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, int B, int H, int Hkv, int Sq, int Skv,
                     int q_offset, int causal, int window, float scale) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Skv = Skv;
  a.q_offset = q_offset; a.causal = causal; a.window = window; a.scale = scale;
  return a;
}

// Head counts and a kv length the backward kernels cannot take.
inline bool bad_shape(int H, int Hkv, int Skv) {
  return H <= 0 || Hkv <= 0 || H % Hkv != 0 || Skv <= 0;
}

// Sets the dynamic shared-memory size a launch needs (above 48 KB this must
// be allowed per kernel first) and reports a refusal.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace dstt_flash
