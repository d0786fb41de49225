// Flash-attention backward in fp32, with and without a bias: dQ and dK/dV.
// Every bf16 call, with or without a bias, runs flash_bwd_sm90.cu (TMA +
// wgmma); dstt_flash_bwd_dq / dstt_flash_bwd_dkv below refuse bf16.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py `_bwd_dq_kernel`
// (:448, pallas_call at :657) and `_bwd_dkv_kernel` (:523, pallas_call at
// :706), driven by `_flash_bwd` (:592). Same functions: p is recomputed from
// the forward's saved lse, p = exp(scale * q k^T - lse) (0 where masked),
// dp = dO v^T, ds = p * (dp - delta) * scale, with delta = rowsum(dO * O)
// computed by the caller (XLA code in JAX, torch code here); dq = ds k,
// dv = p^T dO, dk = ds^T q. Bias mode (`has_bias`, a bf16 or fp32 bias):
// the bias joins the recomputed logits as in the forward (:481-482,
// :557-558), in natural units, and the dQ kernel, given a dbias pointer,
// writes dL/dlogits = p * (dp - delta) unscaled in fp32 (:492-494): every
// position of its q rows, zero where nothing is visible and over the kv
// tiles its causal band skips (:507-512).
//
// Bound on an H100 SXM: operations, at 67 TFLOP/s of fp32 outside the
// tensor cores (the bf16 shapes and their bounds are in flash_bwd_sm90.cu's
// head). No training or op path of the port runs fp32 on the card: these
// kernels serve fp32 callers and the fp32 tests.
//
// Design. dQ: one block of 4 warps per (batch * head, 64-row q tile), each
// warp owning 16 q rows, looping over the kv tiles of its causal/window band;
// it writes its own rows, so no atomics. dK/dV: one block per (batch * KV
// head, 64-row kv tile), each warp owning 16 kv rows, looping over the g
// query heads of its group and over the 32-row q tiles of its band; the
// group's contributions add up in registers onto NARROW dK/dV (the TPU
// native-GQA kernel's row-axis contraction), deterministic, with no atomics
// and no widen-then-sum. Products: flash_common.cuh's FMA loop over fp32
// tiles in shared memory, in the mma fragment layout.

#include "flash_common.cuh"

namespace {

using namespace dstt_flash;

// ------------------------------------------------------------------ dQ --
constexpr int DQ_BQ = 64, DQ_BKV = 64;

template <typename T, int D>
constexpr size_t dq_smem() {
  return sizeof(T) * ((size_t)(2 * DQ_BQ + 2 * DQ_BKV) * (D + Pad<T>::value) +
                      (size_t)kWarps * 16 * (DQ_BKV + Pad<T>::value));
}

template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a, const Bias bb) {
  constexpr int LD = D + Pad<T>::value, LDS = DQ_BKV + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + DQ_BQ * LD;
  T* sK = sdO + DQ_BQ * LD;
  T* sV = sK + DQ_BKV * LD;
  T* sS = sV + DQ_BKV * LD + (threadIdx.x >> 5) * 16 * LDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const size_t qbase = ((size_t)b * a.Sq * a.H + h) * D;
  const size_t kbase = ((size_t)b * a.Skv * a.Hkv + hk) * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  load_rows<T, D>(sQ, static_cast<const T*>(a.q) + qbase, q0, a.Sq, DQ_BQ, qstride);
  load_rows<T, D>(sdO, static_cast<const T*>(a.dout) + qbase, q0, a.Sq, DQ_BQ, qstride);

  const int r0 = q0 + warp * 16 + gr;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    // base-2 units without a bias, natural units with one (see the forward)
    lse2[i] = row < a.Sq ? a.lse[(size_t)bh * a.Sq + row] * (BIAS ? 1.f : kLog2e) : 0.f;
    dlt[i] = row < a.Sq ? a.delta[(size_t)bh * a.Sq + row] : 0.f;
  }
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.causal) {
    kv_hi = min(a.Skv, q0 + DQ_BQ + a.q_offset);
    if (a.window > 0) kv_lo = max(0, q0 + a.q_offset - a.window + 1);
  }
  const float sl2 = a.scale * kLog2e;
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const int j_lo = (kv_lo / DQ_BKV) * DQ_BKV;
  for (int j0 = j_lo; j0 < kv_hi; j0 += DQ_BKV) {
    __syncthreads();
    load_rows<T, D>(sK, k, j0, a.Skv, DQ_BKV, kstride);
    load_rows<T, D>(sV, v, j0, a.Skv, DQ_BKV, kstride);
    __syncthreads();

    float s[DQ_BKV / 8][4], dp[DQ_BKV / 8][4];
#pragma unroll
    for (int i = 0; i < DQ_BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    warp_mma<DQ_BKV / 8, D, false>(s, sQ + warp * 16 * LD, LD, sK, LD);
    warp_mma<DQ_BKV / 8, D, false>(dp, sdO + warp * 16 * LD, LD, sV, LD);
#pragma unroll
    for (int nt = 0; nt < DQ_BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, row = r0 + 8 * i, col = j0 + nt * 8 + 2 * tq + (e & 1);
        if constexpr (BIAS) {
          float p = 0.f;
          if (visible(a, row, col))
            p = exp2f((s[nt][e] * a.scale + bias_at(bb, b, h, row, col) - lse2[i]) * kLog2e);
          const float ds = p * (dp[nt][e] - dlt[i]);   // dL/dlogits: the bias gradient
          if (bb.dbias && row < a.Sq && col < a.Skv)
            bb.dbias[((size_t)bh * a.Sq + row) * a.Skv + col] = ds;
          s[nt][e] = ds * a.scale;
        } else {
          const float p = visible(a, row, col) ? exp2f(s[nt][e] * sl2 - lse2[i]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - dlt[i]) * a.scale;
        }
      }
    store_tile<T, DQ_BKV / 8>(sS, LDS, s);   // ds rounded to k's dtype, as on the TPU
    __syncwarp();
    warp_mma<D / 8, DQ_BKV, true>(dq, sS, LDS, sK, LD);
    __syncwarp();
  }
  store_rows<T, D / 8>(static_cast<T*>(a.dq) + qbase, qstride, r0, a.Sq, dq, 1.f, 1.f);
  if constexpr (BIAS) {
    if (bb.dbias) {   // the kv tiles outside the causal/window band: zeros
      const int tiles = kv_hi > j_lo ? (kv_hi - j_lo + DQ_BKV - 1) / DQ_BKV : 0;
      const int j_hi = min(j_lo + tiles * DQ_BKV, a.Skv);
      for (int r = 0; r < DQ_BQ && q0 + r < a.Sq; ++r) {
        float* row = bb.dbias + ((size_t)bh * a.Sq + q0 + r) * a.Skv;
        for (int c = threadIdx.x; c < j_lo; c += kThreads) row[c] = 0.f;
        for (int c = j_hi + threadIdx.x; c < a.Skv; c += kThreads) row[c] = 0.f;
      }
    }
  }
}

// --------------------------------------------------------------- dK/dV --
constexpr int KV_BKV = 64, KV_BQ = 32;

template <typename T, int D>
constexpr size_t dkv_smem() {
  return sizeof(T) * ((size_t)(2 * KV_BKV + 2 * KV_BQ) * (D + Pad<T>::value) +
                      (size_t)kWarps * 2 * 16 * (KV_BQ + Pad<T>::value)) +
         sizeof(float) * 2 * KV_BQ;
}

template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Args a, const Bias bb) {
  constexpr int LD = D + Pad<T>::value, LDT = KV_BQ + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + KV_BKV * LD;
  T* sQ = sV + KV_BKV * LD;
  T* sdO = sQ + KV_BQ * LD;
  T* sP = sdO + KV_BQ * LD + (threadIdx.x >> 5) * 2 * 16 * LDT;   // p^T, then ds^T
  T* sS = sP + 16 * LDT;
  float* sLse = reinterpret_cast<float*>(sdO + KV_BQ * LD + kWarps * 2 * 16 * LDT);
  float* sDelta = sLse + KV_BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * KV_BKV;   // causal: the first kv tiles carry the most rows
  const int bkh = blockIdx.y, b = bkh / a.Hkv, hk = bkh % a.Hkv, group = a.H / a.Hkv;
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = ((size_t)b * a.Skv * a.Hkv + hk) * D;

  load_rows<T, D>(sK, static_cast<const T*>(a.k) + kbase, k0, a.Skv, KV_BKV, kstride);
  load_rows<T, D>(sV, static_cast<const T*>(a.v) + kbase, k0, a.Skv, KV_BKV, kstride);

  int q_lo = 0, q_hi = a.Sq;   // q rows that can see this kv tile
  if (a.causal) {
    q_lo = max(0, k0 - a.q_offset);
    if (a.window > 0) q_hi = max(0, min(a.Sq, k0 + KV_BKV - 1 + a.window - a.q_offset));
  }
  const int kr0 = k0 + warp * 16 + gr;   // this thread's kv rows: kr0 and kr0 + 8
  const float sl2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const size_t qbase = ((size_t)b * a.Sq * a.H + hq) * D;
    const T* q = static_cast<const T*>(a.q) + qbase;
    const T* dout = static_cast<const T*>(a.dout) + qbase;
    const float* lse = a.lse + (size_t)(b * a.H + hq) * a.Sq;
    const float* delta = a.delta + (size_t)(b * a.H + hq) * a.Sq;
    for (int i0 = (q_lo / KV_BQ) * KV_BQ; i0 < q_hi; i0 += KV_BQ) {
      __syncthreads();
      load_rows<T, D>(sQ, q, i0, a.Sq, KV_BQ, qstride);
      load_rows<T, D>(sdO, dout, i0, a.Sq, KV_BQ, qstride);
      if (threadIdx.x < KV_BQ) {
        const int row = i0 + threadIdx.x;
        sLse[threadIdx.x] = row < a.Sq ? lse[row] * (BIAS ? 1.f : kLog2e) : 0.f;
        sDelta[threadIdx.x] = row < a.Sq ? delta[row] : 0.f;
      }
      __syncthreads();

      float st[KV_BQ / 8][4], dpt[KV_BQ / 8][4];   // [kv row][q col]
#pragma unroll
      for (int i = 0; i < KV_BQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
      warp_mma<KV_BQ / 8, D, false>(st, sK + warp * 16 * LD, LD, sQ, LD);
      warp_mma<KV_BQ / 8, D, false>(dpt, sV + warp * 16 * LD, LD, sdO, LD);
#pragma unroll
      for (int nt = 0; nt < KV_BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * tq + (e & 1), kvrow = kr0 + 8 * (e >> 1);
          float p;
          if constexpr (BIAS) {
            p = 0.f;
            if (visible(a, i0 + c, kvrow))
              p = exp2f((st[nt][e] * a.scale + bias_at(bb, b, hq, i0 + c, kvrow) - sLse[c]) *
                        kLog2e);
          } else {
            p = visible(a, i0 + c, kvrow) ? exp2f(st[nt][e] * sl2 - sLse[c]) : 0.f;
          }
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sDelta[c]) * a.scale;
        }
      store_tile<T, KV_BQ / 8>(sP, LDT, st);    // p^T rounded to dO's dtype
      store_tile<T, KV_BQ / 8>(sS, LDT, dpt);   // ds^T rounded to q's dtype
      __syncwarp();
      warp_mma<D / 8, KV_BQ, true>(dv, sP, LDT, sdO, LD);
      warp_mma<D / 8, KV_BQ, true>(dk, sS, LDT, sQ, LD);
      __syncwarp();
    }
  }
  store_rows<T, D / 8>(static_cast<T*>(a.dk) + kbase, kstride, kr0, a.Skv, dk, 1.f, 1.f);
  store_rows<T, D / 8>(static_cast<T*>(a.dv) + kbase, kstride, kr0, a.Skv, dv, 1.f, 1.f);
}

template <typename T, int D, bool BIAS>
cudaError_t launch_dq(const Args& a, const Bias& bb, cudaStream_t stream) {
  const size_t smem = dq_smem<T, D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D, BIAS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + DQ_BQ - 1) / DQ_BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D, BIAS><<<grid, kThreads, smem, stream>>>(a, bb);
  return cudaGetLastError();
}

template <typename T, int D, bool BIAS>
cudaError_t launch_dkv(const Args& a, const Bias& bb, cudaStream_t stream) {
  const size_t smem = dkv_smem<T, D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D, BIAS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + KV_BKV - 1) / KV_BKV, a.B * a.Hkv);
  flash_bwd_dkv_kernel<T, D, BIAS><<<grid, kThreads, smem, stream>>>(a, bb);
  return cudaGetLastError();
}

// dispatch over (dtype, D, bias) to launch_dq or launch_dkv
template <bool DQ, typename T, bool BIAS>
cudaError_t launch_d(const Args& a, const Bias& bb, int D, cudaStream_t s) {
  if (D == 128) return DQ ? launch_dq<T, 128, BIAS>(a, bb, s) : launch_dkv<T, 128, BIAS>(a, bb, s);
  if (D == 64) return DQ ? launch_dq<T, 64, BIAS>(a, bb, s) : launch_dkv<T, 64, BIAS>(a, bb, s);
  if (D == 32) return DQ ? launch_dq<T, 32, BIAS>(a, bb, s) : launch_dkv<T, 32, BIAS>(a, bb, s);
  return cudaErrorInvalidValue;
}

template <bool DQ>
cudaError_t launch_any(const Args& a, const Bias& bb, int D, int dtype, cudaStream_t s) {
  const bool bias = bb.ptr != nullptr;
  if (dtype == 1)   // fp32 only: bf16 runs flash_bwd_sm90.cu
    return bias ? launch_d<DQ, float, true>(a, bb, D, s)
                : launch_d<DQ, float, false>(a, bb, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dq [B, Sq, H, D] from q, k, v, dout, lse [B * H, Sq], delta [B * H, Sq].
// bias as in dstt_flash_fwd; dbias (bias mode only, may be null): fp32
// [B, H, Sq, Skv], every element written.
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, int B, int H,
                                 int Hkv, int Sq, int Skv, int D, int q_offset, int causal,
                                 int window, float scale, int dtype, const void* bias,
                                 long long sb, long long sh, long long sq, long long sk,
                                 int bias_f32, float* dbias, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (bad_shape(H, Hkv, Skv) || (dbias && !bias)) return (int)cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Skv, q_offset, causal, window,
                    scale);
  a.dq = dq;
  const Bias bb{bias, sb, sh, sq, sk, bias_f32, dbias};
  return (int)launch_any<true>(a, bb, D, dtype, static_cast<cudaStream_t>(stream));
}

// dk, dv [B, Skv, Hkv, D] (narrow) from the same inputs.
extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv, int B,
                                  int H, int Hkv, int Sq, int Skv, int D, int q_offset,
                                  int causal, int window, float scale, int dtype,
                                  const void* bias, long long sb, long long sh, long long sq,
                                  long long sk, int bias_f32, void* stream) {
  if (B == 0 || Skv == 0) return 0;
  if (bad_shape(H, Hkv, Skv)) return (int)cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Skv, q_offset, causal, window,
                    scale);
  a.dk = dk;
  a.dv = dv;
  const Bias bb{bias, sb, sh, sq, sk, bias_f32, nullptr};
  return (int)launch_any<false>(a, bb, D, dtype, static_cast<cudaStream_t>(stream));
}
