// Flash-attention forward for Hopper (sm_90a), fp32 inputs. bf16 goes to
// flash_fwd_sm90.cu (TMA + wgmma); dstt_flash_fwd below routes by dtype.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (:284,
// pallas_call at :426, driven by `_flash_fwd` :361; op `attention`). Same
// function: o = softmax(scale * q k^T + mask) v per (batch, head), with the
// running max, sum and accumulator in fp32 and p rounded to v's dtype before
// the P V product; lse = m + log(l) per row. Masks: causal with q_offset, a
// static causal window, kv length. A row that sees no key gets o = 0 and
// lse = -1e30 + log 1, as `_finish` does with l_safe. Bias mode (`_flash_b`
// :787, `has_bias`): an additive bf16/fp32 logits bias added after the
// scale and before the masks (:315-316), read in place through its strides
// (flash_common.cuh), the softmax then kept in natural units.
//
// Bound on an H100 SXM: operations. A causal pass at Llama-3-8B shapes
// (B = 1, S = 4096, 32 heads, hd 128) is 2 * S^2 * hd * 32 ~ 137 GFLOP of
// bf16 products against ~70 MB of q, k, v, o: ~139 us at 989 TFLOP/s,
// ~21 us of HBM time.
//
// Design: one block of 4 warps per (batch * head, 64-row q tile); each warp
// owns 16 q rows. The TPU's sequential kv grid axis with scratch carried
// between steps becomes a loop inside the block over exactly the kv tiles
// the causal/window band needs (the TPU's _mask_split / _fold_maps become
// loop bounds); tails of any length are masked by bounds rather than padded.
// Narrow GQA K/V are read in place (query head h reads kv head h / g).
// Products: this kernel now serves fp32 only, with FMA products (wgmma on
// fp32 inputs would be TF32 and change the numbers); no training path runs
// fp32 attention. The bias costs one strided (cached) load per visible
// score; at BLOOM-7b1's S = 2048 the bias mode's forward is ~34 GFLOP per
// 32 heads (~35 us at 989 TFLOP/s) and a summed evoformer bias of 1.07 GB
// makes it bytes-bound (~320 us to read at 3.35 TB/s).

#include "flash_common.cuh"

namespace {

using namespace dstt_flash;

constexpr int BQ = 64, BKV = 64;

template <typename T, int D>
constexpr size_t fwd_smem() {
  return sizeof(T) * ((size_t)(BQ + 2 * BKV) * (D + Pad<T>::value) +
                      (size_t)kWarps * 16 * (BKV + Pad<T>::value));
}

template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a, const Bias bb) {
  // no bias: scores in base-2 units (exp(x) = 2^(x log2 e)); bias: natural
  constexpr float kUnit = BIAS ? kLog2e : 1.f;
  constexpr int LD = D + Pad<T>::value, LDP = BKV + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BKV * LD;
  T* sP = sV + BKV * LD + (threadIdx.x >> 5) * 16 * LDP;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows start first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.Sq * a.H + h) * D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.Skv * a.Hkv + hk) * D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.Skv * a.Hkv + hk) * D;

  load_rows<T, D>(sQ, q, q0, a.Sq, BQ, qstride);

  int kv_lo = 0, kv_hi = a.Skv;
  if (a.causal) {
    kv_hi = min(a.Skv, q0 + BQ + a.q_offset);
    if (a.window > 0) kv_lo = max(0, q0 + a.q_offset - a.window + 1);
  }
  const int r0 = q0 + warp * 16 + gr;   // this thread's rows: r0 and r0 + 8
  const float sl2 = a.scale * kLog2e;   // softmax in base 2: exp(x) = 2^(x log2 e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j0 = (kv_lo / BKV) * BKV; j0 < kv_hi; j0 += BKV) {
    __syncthreads();   // the previous tile's readers are done
    load_rows<T, D>(sK, k, j0, a.Skv, BKV, kstride);
    load_rows<T, D>(sV, v, j0, a.Skv, BKV, kstride);
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    warp_mma<BKV / 8, D, false>(s, sQ + warp * 16 * LD, LD, sK, LD);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), col = j0 + nt * 8 + 2 * tq + (e & 1);
        float x = -INFINITY;
        if (visible(a, row, col)) {
          if constexpr (BIAS)
            x = s[nt][e] * a.scale + bias_at(bb, b, h, row, col);
          else
            x = s[nt][e] * sl2;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = mn == -INFINITY ? 1.f : exp2f((m[i] - mn) * kUnit);
      m[i] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mi = m[e >> 1];
        const float p = mi == -INFINITY ? 0.f : exp2f((s[nt][e] - mi) * kUnit);
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
    store_tile<T, BKV / 8>(sP, LDP, s);   // p rounded to v's dtype, as on the TPU
    __syncwarp();
    warp_mma<D / 8, BKV, true>(acc, sP, LDP, sV, LD);
    __syncwarp();
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    const int row = r0 + 8 * i;
    if (tq == 0 && row < a.Sq)
      a.lse_out[(size_t)bh * a.Sq + row] =
          (m[i] == -INFINITY ? kNegInf : (BIAS ? m[i] : m[i] * kLn2)) + logf(l_safe);
  }
  T* o = static_cast<T*>(a.o) + ((size_t)b * a.Sq * a.H + h) * D;
  store_rows<T, D / 8>(o, qstride, r0, a.Sq, acc, inv[0], inv[1]);
}

template <typename T, int D, bool BIAS>
cudaError_t launch(const Args& a, const Bias& bb, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D, BIAS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_kernel<T, D, BIAS><<<grid, kThreads, smem, stream>>>(a, bb);
  return cudaGetLastError();
}

template <typename T, bool BIAS>
cudaError_t launch_d(const Args& a, const Bias& bb, int D, cudaStream_t s) {
  if (D == 128) return launch<T, 128, BIAS>(a, bb, s);
  if (D == 64) return launch<T, 64, BIAS>(a, bb, s);
  if (D == 32) return launch<T, 32, BIAS>(a, bb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

namespace dstt_flash {
cudaError_t flash_fwd_sm90(const Args& a, const Bias& bb, int D, cudaStream_t s);
}

// q [B, Sq, H, D], k/v [B, Skv, Hkv, D] -> o [B, Sq, H, D], lse [B * H, Sq] fp32.
// dtype: 0 bf16 (flash_fwd_sm90.cu), 1 fp32 (here). D: 32, 64 or 128.
// window <= 0: none. bias: null (none) or a bf16 (bias_f32 0) / fp32 (1)
// bias read at b * sb + h * sh + q * sq + kv * sk elements.
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int H, int Hkv, int Sq, int Skv, int D, int q_offset,
                              int causal, int window, float scale, int dtype, const void* bias,
                              long long sb, long long sh, long long sq, long long sk,
                              int bias_f32, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Skv = Skv;
  a.q_offset = q_offset; a.causal = causal; a.window = window; a.scale = scale;
  const Bias bb{bias, sb, sh, sq, sk, bias_f32, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dstt_flash::flash_fwd_sm90(a, bb, D, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)(bias ? launch_d<float, true>(a, bb, D, s) : launch_d<float, false>(a, bb, D, s));
}
