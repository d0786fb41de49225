// Block-sparse flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces: deepspeed_tpu/ops/pallas/sparse_attention.py `_sparse_fwd_kernel`
// (:39), `_sparse_dq_kernel` (:87) and `_sparse_dkv_kernel` (:126), driven by
// `_sparse_fwd_lse` (:213) and `sparse_flash_attention_bwd` (:270). Same
// functions as the flash kernels (flash_fwd.cu, flash_bwd.cu) over a static
// [S/bs, S/bs] block layout: the forward and dQ walk each q block's
// compacted list of active kv blocks (`compact_layout`, :170), dK/dV each
// kv block's transposed list of the q blocks that attend to it
// (`compact_layout_t`, :193); inactive blocks cost nothing, and padded list
// slots are never visited (the loops run to the row's count). Causal
// layouts are lower-triangular after compaction, so only the diagonal block
// needs the intra-block mask kv <= q. A kv block that no q block attends to
// writes zero dK/dV. lse is fp32 [B * H, S].
//
// Bound on an H100 SXM: operations, over the active pairs only. At
// Llama-3-8B width (32 heads, hd 128) with S = 16384, block 128 and a causal
// bigbird layout (window 3, global 1, random 2) 7% of the causal pairs are
// active: ~154 GFLOP forward, ~156 us at 989 TFLOP/s (dense causal: 2.2 ms).
//
// Design: the flash kernels' tiles. A block of BT / 16 warps (BT = min(bs,
// 64)) owns BT q rows (forward, dQ) or BT kv rows (dK/dV) of one (batch,
// head) and walks its list; each active layout block is consumed in BT-row
// (dK/dV: min(BT, 32)-row) sub-tiles, with the sub-tiles of the diagonal
// block that lie wholly above the diagonal skipped. Narrow GQA K/V are read
// in place; dK/dV loops over the query heads of its kv head, so the group's
// contributions add up in registers (no atomics, no widen-then-sum).
// Products: mma.sync bf16 tensor-core tiles through ldmatrix (fp32: FMA),
// as in flash_common.cuh.

#include "flash_common.cuh"

namespace {

using namespace dstt_flash;

struct SArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* o;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  const int* idx;   // [nb, max_a] compacted block lists (row-major)
  const int* cnt;   // [nb] active entries of each list
  int max_a;
  int B, H, Hkv, S, bs, causal;
  float scale;
};

__device__ __forceinline__ bool sp_visible(const SArgs& a, int qrow, int kvrow) {
  return !a.causal || kvrow <= qrow;
}

// ------------------------------------------------------------- forward --
template <typename T, int D, int BT>
constexpr size_t fwd_smem() {
  return sizeof(T) * ((size_t)3 * BT * (D + Pad<T>::value) +
                      (size_t)(BT / 16) * 16 * (BT + Pad<T>::value));
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * BT) sparse_fwd_kernel(const SArgs a) {
  constexpr int NTH = 2 * BT;   // BT / 16 warps
  constexpr int LD = D + Pad<T>::value, LDP = BT + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BT * LD;
  T* sV = sK + BT * LD;
  T* sP = sV + BT * LD + (threadIdx.x >> 5) * 16 * LDP;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BT, qb = q0 / a.bs;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.S * a.H + h) * D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.S * a.Hkv + hk) * D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.S * a.Hkv + hk) * D;

  load_rows_n<T, D, NTH>(sQ, q, q0, a.S, BT, qstride);

  const int r0 = q0 + warp * 16 + gr;
  const float sl2 = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n = a.cnt[qb];
  for (int j = 0; j < n; ++j) {
    const int kb = a.idx[(size_t)qb * a.max_a + j];
    for (int c0 = kb * a.bs; c0 < (kb + 1) * a.bs; c0 += BT) {
      if (a.causal && c0 > q0 + BT - 1) break;   // wholly above the diagonal
      __syncthreads();
      load_rows_n<T, D, NTH>(sK, k, c0, a.S, BT, kstride);
      load_rows_n<T, D, NTH>(sV, v, c0, a.S, BT, kstride);
      __syncthreads();

      float s[BT / 8][4];
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      warp_mma<BT / 8, D, false>(s, sQ + warp * 16 * LD, LD, sK, LD);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1), col = c0 + nt * 8 + 2 * tq + (e & 1);
          const float x = sp_visible(a, row, col) ? s[nt][e] * sl2 : -INFINITY;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mn = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = mn == -INFINITY ? 1.f : exp2f(m[i] - mn);
        m[i] = mn;
      }
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mi = m[e >> 1];
          const float p = mi == -INFINITY ? 0.f : exp2f(s[nt][e] - mi);
          s[nt][e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(ls[i]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
      store_tile<T, BT / 8>(sP, LDP, s);   // p rounded to v's dtype, as on the TPU
      __syncwarp();
      warp_mma<D / 8, BT, true>(acc, sP, LDP, sV, LD);
      __syncwarp();
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    if (tq == 0)
      a.lse_out[(size_t)bh * a.S + r0 + 8 * i] =
          (m[i] == -INFINITY ? kNegInf : m[i] * kLn2) + logf(l_safe);
  }
  T* o = static_cast<T*>(a.o) + ((size_t)b * a.S * a.H + h) * D;
  store_rows<T, D / 8>(o, qstride, r0, a.S, acc, inv[0], inv[1]);
}

// ------------------------------------------------------------------ dQ --
template <typename T, int D, int BT>
constexpr size_t dq_smem() {
  return sizeof(T) * ((size_t)4 * BT * (D + Pad<T>::value) +
                      (size_t)(BT / 16) * 16 * (BT + Pad<T>::value));
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * BT) sparse_dq_kernel(const SArgs a) {
  constexpr int NTH = 2 * BT;
  constexpr int LD = D + Pad<T>::value, LDS = BT + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + BT * LD;
  T* sK = sdO + BT * LD;
  T* sV = sK + BT * LD;
  T* sS = sV + BT * LD + (threadIdx.x >> 5) * 16 * LDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BT, qb = q0 / a.bs;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const size_t qbase = ((size_t)b * a.S * a.H + h) * D;
  const size_t kbase = ((size_t)b * a.S * a.Hkv + hk) * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  load_rows_n<T, D, NTH>(sQ, static_cast<const T*>(a.q) + qbase, q0, a.S, BT, qstride);
  load_rows_n<T, D, NTH>(sdO, static_cast<const T*>(a.dout) + qbase, q0, a.S, BT, qstride);

  const int r0 = q0 + warp * 16 + gr;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = a.lse[(size_t)bh * a.S + r0 + 8 * i] * kLog2e;
    dlt[i] = a.delta[(size_t)bh * a.S + r0 + 8 * i];
  }
  const float sl2 = a.scale * kLog2e;
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const int n = a.cnt[qb];
  for (int j = 0; j < n; ++j) {
    const int kb = a.idx[(size_t)qb * a.max_a + j];
    for (int c0 = kb * a.bs; c0 < (kb + 1) * a.bs; c0 += BT) {
      if (a.causal && c0 > q0 + BT - 1) break;
      __syncthreads();
      load_rows_n<T, D, NTH>(sK, k, c0, a.S, BT, kstride);
      load_rows_n<T, D, NTH>(sV, v, c0, a.S, BT, kstride);
      __syncthreads();

      float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
      for (int i = 0; i < BT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
      warp_mma<BT / 8, D, false>(s, sQ + warp * 16 * LD, LD, sK, LD);
      warp_mma<BT / 8, D, false>(dp, sdO + warp * 16 * LD, LD, sV, LD);
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, row = r0 + 8 * i, col = c0 + nt * 8 + 2 * tq + (e & 1);
          const float p = sp_visible(a, row, col) ? exp2f(s[nt][e] * sl2 - lse2[i]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - dlt[i]) * a.scale;
        }
      store_tile<T, BT / 8>(sS, LDS, s);   // ds rounded to k's dtype, as on the TPU
      __syncwarp();
      warp_mma<D / 8, BT, true>(dq, sS, LDS, sK, LD);
      __syncwarp();
    }
  }
  store_rows<T, D / 8>(static_cast<T*>(a.dq) + qbase, qstride, r0, a.S, dq, 1.f, 1.f);
}

// --------------------------------------------------------------- dK/dV --
// q rows per dK/dV sub-tile
template <int BT> struct QtRows { static constexpr int value = BT < 32 ? BT : 32; };

template <typename T, int D, int BT>
constexpr size_t dkv_smem() {
  constexpr int QT = QtRows<BT>::value;
  return sizeof(T) * ((size_t)(2 * BT + 2 * QT) * (D + Pad<T>::value) +
                      (size_t)(BT / 16) * 2 * 16 * (QT + Pad<T>::value)) +
         sizeof(float) * 2 * QT;
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * BT) sparse_dkv_kernel(const SArgs a) {
  constexpr int NTH = 2 * BT, QT = QtRows<BT>::value;
  constexpr int LD = D + Pad<T>::value, LDT = QT + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BT * LD;
  T* sQ = sV + BT * LD;
  T* sdO = sQ + QT * LD;
  T* sP = sdO + QT * LD + (threadIdx.x >> 5) * 2 * 16 * LDT;   // p^T, then ds^T
  T* sS = sP + 16 * LDT;
  float* sLse = reinterpret_cast<float*>(sdO + QT * LD + (BT / 16) * 2 * 16 * LDT);
  float* sDelta = sLse + QT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * BT, kb = k0 / a.bs;
  const int bkh = blockIdx.y, b = bkh / a.Hkv, hk = bkh % a.Hkv, group = a.H / a.Hkv;
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = ((size_t)b * a.S * a.Hkv + hk) * D;

  load_rows_n<T, D, NTH>(sK, static_cast<const T*>(a.k) + kbase, k0, a.S, BT, kstride);
  load_rows_n<T, D, NTH>(sV, static_cast<const T*>(a.v) + kbase, k0, a.S, BT, kstride);

  const int kr0 = k0 + warp * 16 + gr;   // this thread's kv rows: kr0 and kr0 + 8
  const float sl2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  const int n = a.cnt[kb];   // 0: a kv block nobody attends to writes zeros
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const size_t qbase = ((size_t)b * a.S * a.H + hq) * D;
    const T* q = static_cast<const T*>(a.q) + qbase;
    const T* dout = static_cast<const T*>(a.dout) + qbase;
    const float* lse = a.lse + (size_t)(b * a.H + hq) * a.S;
    const float* delta = a.delta + (size_t)(b * a.H + hq) * a.S;
    for (int j = 0; j < n; ++j) {
      const int qb = a.idx[(size_t)kb * a.max_a + j];
      for (int i0 = qb * a.bs; i0 < (qb + 1) * a.bs; i0 += QT) {
        if (a.causal && i0 + QT - 1 < k0) continue;   // every row before every key
        __syncthreads();
        load_rows_n<T, D, NTH>(sQ, q, i0, a.S, QT, qstride);
        load_rows_n<T, D, NTH>(sdO, dout, i0, a.S, QT, qstride);
        if (threadIdx.x < QT) {
          sLse[threadIdx.x] = lse[i0 + threadIdx.x] * kLog2e;
          sDelta[threadIdx.x] = delta[i0 + threadIdx.x];
        }
        __syncthreads();

        float st[QT / 8][4], dpt[QT / 8][4];   // [kv row][q col]
#pragma unroll
        for (int i = 0; i < QT / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
        warp_mma<QT / 8, D, false>(st, sK + warp * 16 * LD, LD, sQ, LD);
        warp_mma<QT / 8, D, false>(dpt, sV + warp * 16 * LD, LD, sdO, LD);
#pragma unroll
        for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * tq + (e & 1), kvrow = kr0 + 8 * (e >> 1);
            const float p =
                sp_visible(a, i0 + c, kvrow) ? exp2f(st[nt][e] * sl2 - sLse[c]) : 0.f;
            st[nt][e] = p;
            dpt[nt][e] = p * (dpt[nt][e] - sDelta[c]) * a.scale;
          }
        store_tile<T, QT / 8>(sP, LDT, st);    // p^T rounded to dO's dtype
        store_tile<T, QT / 8>(sS, LDT, dpt);   // ds^T rounded to q's dtype
        __syncwarp();
        warp_mma<D / 8, QT, true>(dv, sP, LDT, sdO, LD);
        warp_mma<D / 8, QT, true>(dk, sS, LDT, sQ, LD);
        __syncwarp();
      }
    }
  }
  store_rows<T, D / 8>(static_cast<T*>(a.dk) + kbase, kstride, kr0, a.S, dk, 1.f, 1.f);
  store_rows<T, D / 8>(static_cast<T*>(a.dv) + kbase, kstride, kr0, a.S, dv, 1.f, 1.f);
}

// ----------------------------------------------------------- launchers --
enum Which { kFwd, kDq, kDkv };

template <Which W, typename T, int D, int BT>
cudaError_t launch(const SArgs& a, cudaStream_t stream) {
  const int heads = W == kDkv ? a.Hkv : a.H;
  const dim3 grid(a.S / BT, a.B * heads);
  size_t smem;
  cudaError_t err;
  if constexpr (W == kFwd) {
    smem = fwd_smem<T, D, BT>();
    if ((err = allow_smem(sparse_fwd_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
    sparse_fwd_kernel<T, D, BT><<<grid, 2 * BT, smem, stream>>>(a);
  } else if constexpr (W == kDq) {
    smem = dq_smem<T, D, BT>();
    if ((err = allow_smem(sparse_dq_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
    sparse_dq_kernel<T, D, BT><<<grid, 2 * BT, smem, stream>>>(a);
  } else {
    smem = dkv_smem<T, D, BT>();
    if ((err = allow_smem(sparse_dkv_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
    sparse_dkv_kernel<T, D, BT><<<grid, 2 * BT, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <Which W, typename T, int D>
cudaError_t launch_bt(const SArgs& a, cudaStream_t s) {
  if (a.bs >= 64) return launch<W, T, D, 64>(a, s);
  if (a.bs == 32) return launch<W, T, D, 32>(a, s);
  return launch<W, T, D, 16>(a, s);
}

template <Which W>
cudaError_t launch_any(const SArgs& a, int D, int dtype, cudaStream_t s) {
  if (a.bs != 16 && a.bs != 32 && a.bs != 64 && a.bs != 128) return cudaErrorInvalidValue;
  if (a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.S % a.bs != 0 || a.max_a <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D == 128) return launch_bt<W, __nv_bfloat16, 128>(a, s);
    if (D == 64) return launch_bt<W, __nv_bfloat16, 64>(a, s);
    if (D == 32) return launch_bt<W, __nv_bfloat16, 32>(a, s);
  } else if (dtype == 1) {
    if (D == 128) return launch_bt<W, float, 128>(a, s);
    if (D == 64) return launch_bt<W, float, 64>(a, s);
    if (D == 32) return launch_bt<W, float, 32>(a, s);
  }
  return cudaErrorInvalidValue;
}

SArgs make_args(const void* q, const void* k, const void* v, const int* idx, const int* cnt,
                int max_a, int B, int H, int Hkv, int S, int bs, int causal, float scale) {
  SArgs a{};
  a.q = q; a.k = k; a.v = v; a.idx = idx; a.cnt = cnt; a.max_a = max_a;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.bs = bs; a.causal = causal; a.scale = scale;
  return a;
}

}  // namespace

// q [B, S, H, D], k/v [B, S, Hkv, D] -> o [B, S, H, D], lse [B * H, S] fp32.
// idx [S/bs, max_a] int32 and cnt [S/bs] int32: each q block's active kv
// blocks (compact_layout). bs: 16, 32, 64 or 128; D: 32, 64 or 128; dtype:
// 0 bf16, 1 fp32.
extern "C" int dstt_sparse_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               const int* idx, const int* cnt, int max_a, int B, int H, int Hkv,
                               int S, int D, int bs, int causal, float scale, int dtype,
                               void* stream) {
  if (B == 0 || S == 0) return 0;
  SArgs a = make_args(q, k, v, idx, cnt, max_a, B, H, Hkv, S, bs, causal, scale);
  a.o = o;
  a.lse_out = lse;
  return (int)launch_any<kFwd>(a, D, dtype, static_cast<cudaStream_t>(stream));
}

// dq [B, S, H, D] from q, k, v, dout, lse and delta [B * H, S] over the
// same lists.
extern "C" int dstt_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dq, const int* idx,
                                  const int* cnt, int max_a, int B, int H, int Hkv, int S, int D,
                                  int bs, int causal, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  SArgs a = make_args(q, k, v, idx, cnt, max_a, B, H, Hkv, S, bs, causal, scale);
  a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  return (int)launch_any<kDq>(a, D, dtype, static_cast<cudaStream_t>(stream));
}

// dk, dv [B, S, Hkv, D] (narrow) over the transposed lists idx_t
// [S/bs, max_t], cnt_t [S/bs] (compact_layout_t).
extern "C" int dstt_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, const int* idx_t, const int* cnt_t,
                                   int max_t, int B, int H, int Hkv, int S, int D, int bs,
                                   int causal, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  SArgs a = make_args(q, k, v, idx_t, cnt_t, max_t, B, H, Hkv, S, bs, causal, scale);
  a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  return (int)launch_any<kDkv>(a, D, dtype, static_cast<cudaStream_t>(stream));
}
