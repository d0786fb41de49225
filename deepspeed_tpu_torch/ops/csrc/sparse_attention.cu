// Block-sparse flash attention for Hopper (sm_90a): forward, dQ and dK/dV
// at layout blocks 16-64 (bf16) and in fp32 at every block; bf16 at block
// 128 runs sparse_sm90.cu (ops/sparse_attention.py `sparse_source` routes
// all three kernels by one rule of shape and dtype).
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
// Bound on an H100 SXM: operations, over the active pairs only; at small
// blocks the bytes. At Llama-3-8B width (32 / 8 heads, hd 128), S 4096,
// block 32 and a causal bigbird layout (window 3, global 1, random 2) dK/dV
// is ~30 us of bytes against ~20 us of operations.
//
// Forward and dQ: the flash kernels' tiles. A block of BT / 16 warps (BT =
// min(bs, 64)) owns BT q rows of one (batch, head) and walks its list; each
// active layout block is consumed in BT-row sub-tiles, with the sub-tiles
// of the diagonal block that lie wholly above the diagonal skipped.
// Products: mma.sync bf16 tensor-core tiles through ldmatrix (fp32: FMA),
// as in flash_common.cuh.
//
// dK/dV. What bounded the first design (a block per (kv block, batch, kv
// head) walking that column's whole list): the bigbird layout's global
// column is in every q block's list, so at S 4096 block 32 its blocks walked
// 512 (query head, q block) pairs while the median column's walked 16, one
// synchronous load behind two barriers at a time (2.16 ms against 30 us).
// Design, accordingly:
// - Work items split the long columns, as sparse_sm90.cu's dK/dV does at
//   block 128. An item is (plan entry, batch, kv head, part): a plan entry
//   (ops/sparse_attention.py `dkv_split_plan`, int32 [entries, 8], counted
//   in layout blocks, so the same plan serves every block size) is one chunk
//   of one column, a run of at most twice the median column's pairs; a part
//   is BT of the kv block's bs rows (two parts at block 128, else one).
//   Entries come longest first, one block per item.
// - A column of one chunk stores its dK/dV directly (zeros when it has no
//   pair). The chunks of a split column write fp32 partials to the
//   wrapper's scratch in each warp's own accumulator order; then each warp
//   takes a ticket from its own counter (per column, batch, kv head and
//   16-row slice of the kv block) after a __threadfence, and the warp that
//   draws the last ticket sums the column's partials in chunk order (two
//   calls give the same bits) and resets its counter for the next call.
// - A block of BT / 16 warps, each owning 16 kv rows (K and V in shared
//   memory for the whole item). The chunk's steps (pair, q sub-tile of QT =
//   min(BT, 32) rows) stream Q, dO, lse and delta through a 3-stage ring of
//   16-byte cp.async copies, one barrier a step, so the next steps' loads
//   run under this step's four products. Per step and warp: S^T = K Q^T and
//   dP^T = V dO^T (16 x QT), p^T and ds^T rounded to the inputs' dtype
//   through the warp's scratch, dV += P^T dO, dK += dS^T Q. A warp whose
//   keys all come after the sub-tile's queries (the diagonal block) skips
//   the step. Under GQA the group's query heads are pairs of the same
//   column: their contributions add up in registers (narrow dK/dV, no
//   atomics).
// Planted fault (dstt_sparse_attention_plant, tests only): 1 the merge of a
// split column drops its last chunk's partial.

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
constexpr int kDkvStages = 3;   // ring stages of Q, dO, lse and delta
constexpr int kPlanInts = 8;    // int32 fields of a plan entry
constexpr int kSliceCap = 8;    // counters a (column, batch, kv head): bs / 16 <= 8

int g_plant = 0;   // planted fault of the dK/dV kernel's next launches (tests)

// q rows per dK/dV step
template <int BT> struct QtRows { static constexpr int value = BT < 32 ? BT : 32; };

// Shared memory of the dK/dV kernel: per stage lse and delta (fp32, QT
// each), K and V of the item's BT kv rows, per stage Q and dO (QT rows), and
// each warp's p^T / ds^T scratch. Every region starts on 16 bytes.
template <typename T, int D, int BT>
struct DkvSmem {
  static constexpr int QT = QtRows<BT>::value;
  static constexpr int LD = D + Pad<T>::value, LDT = QT + Pad<T>::value;
  static constexpr size_t ROWS = (size_t)kDkvStages * 2 * QT;       // floats
  static constexpr size_t KV = (size_t)2 * BT * LD;                  // elements
  static constexpr size_t STAGE = (size_t)2 * QT * LD;
  static constexpr size_t SCRATCH = (size_t)(BT / 16) * 2 * 16 * LDT;
  static constexpr size_t BYTES =
      sizeof(float) * ROWS + sizeof(T) * (KV + kDkvStages * STAGE + SCRATCH);
};

// The split: the plan (int32 [n_plan, kPlanInts]) and the scratch of split
// columns, kernel parameters of their own (SArgs stays the forward's and
// dQ's).
struct DkvPlan {
  const int* plan;
  int n_plan;
  int* counters;     // [split columns, B * Hkv, kSliceCap], 0 between calls
  float* partials;   // [slots, B * Hkv, 2 * bs * D]
};

// rows [row0, row0 + ROWS) of a [*, D] matrix (row stride gstride elements)
// into shared memory with row stride D + Pad, as 16-byte cp.async copies by
// a block of NTH threads.
template <typename T, int D, int NTH, int ROWS>
__device__ __forceinline__ void copy_rows(T* sm, const T* g, int row0, size_t gstride) {
  constexpr int VEC = 16 / sizeof(T), LD = D + Pad<T>::value, VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTH) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    cp_async16(sm + r * LD + c, g + (size_t)(row0 + r) * gstride + c);
  }
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * BT)
    sparse_dkv_kernel(const SArgs a, const int* __restrict__ plan, int* counters,
                      float* partials, const int plant) {
  using L = DkvSmem<T, D, BT>;
  constexpr int NTH = 2 * BT, QT = L::QT, LD = L::LD, LDT = L::LDT, ST = kDkvStages;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sRows = reinterpret_cast<float*>(smem);   // stage s: lse at 2 s QT, delta after it
  T* sK = reinterpret_cast<T*>(sRows + L::ROWS);
  T* sV = sK + BT * LD;
  T* sRing = sV + BT * LD;                         // stage s: Q at s STAGE, dO after it
  T* sP = sRing + ST * L::STAGE + (threadIdx.x >> 5) * 2 * 16 * LDT;   // p^T, then ds^T
  T* sS = sP + 16 * LDT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  // the item: blockIdx.x = ((entry * B * Hkv) + b * Hkv + hk) * parts + part
  const int parts = a.bs / BT, BH = a.B * a.Hkv;
  const int part = blockIdx.x % parts, bh = blockIdx.x / parts % BH;
  const int* e = plan + (size_t)(blockIdx.x / parts / BH) * kPlanInts;
  const int kb = __ldg(e), p0 = __ldg(e + 1), np = __ldg(e + 2), chunk = __ldg(e + 3),
            chunks = __ldg(e + 4), slot0 = __ldg(e + 5), ctr = __ldg(e + 6);
  const int b = bh / a.Hkv, hk = bh % a.Hkv, group = a.H / a.Hkv;
  const int cnt = __ldg(a.cnt + kb), subs = a.bs / QT, n = np * subs;
  const int k0 = kb * a.bs + part * BT;   // the block's kv rows: k0 .. k0 + BT - 1
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = ((size_t)b * a.S * a.Hkv + hk) * D;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);

  // step s: pair p0 + s / subs (query head p / cnt of the group, q block
  // idx_t[kb][p % cnt]), its q sub-tile s % subs
  auto first_row = [&](int s) {
    const int p = p0 + s / subs;
    return __ldg(a.idx + (size_t)kb * a.max_a + p % cnt) * a.bs + (s % subs) * QT;
  };
  auto load_step = [&](int s) {
    const int hq = hk * group + (p0 + s / subs) / cnt, i0 = first_row(s);
    const size_t qbase = ((size_t)b * a.S * a.H + hq) * D;
    T* st = sRing + (s % ST) * L::STAGE;
    copy_rows<T, D, NTH, QT>(st, q + qbase, i0, qstride);
    copy_rows<T, D, NTH, QT>(st + QT * LD, dout + qbase, i0, qstride);
    const size_t row = (size_t)(b * a.H + hq) * a.S + i0;
    float* sr = sRows + (s % ST) * 2 * QT;
    const int c = threadIdx.x % (QT / 4);
    if (threadIdx.x < QT / 4) cp_async16(sr + 4 * c, a.lse + row + 4 * c);
    else if (threadIdx.x < QT / 2) cp_async16(sr + QT + 4 * c, a.delta + row + 4 * c);
  };

  if (n > 0) {   // K and V join the first stage's copies
    copy_rows<T, D, NTH, BT>(sK, static_cast<const T*>(a.k) + kbase, k0, kstride);
    copy_rows<T, D, NTH, BT>(sV, static_cast<const T*>(a.v) + kbase, k0, kstride);
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n) load_step(s);
    cp_async_commit();
  }

  const int kr0 = k0 + warp * 16 + gr;   // this thread's kv rows: kr0 and kr0 + 8
  const float sl2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int s = 0; s < n; ++s) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // step s has landed for every thread; step s - 1's stage is free
    if (s + ST - 1 < n) load_step(s + ST - 1);
    cp_async_commit();
    const int i0 = first_row(s);
    if (a.causal && i0 + QT - 1 < k0 + warp * 16) continue;   // every query before every key
    const T* sQ = sRing + (s % ST) * L::STAGE;
    const T* sdO = sQ + QT * LD;
    const float* sLse = sRows + (s % ST) * 2 * QT;
    const float* sDelta = sLse + QT;

    float st[QT / 8][4], dpt[QT / 8][4];   // [kv row][q col]
#pragma unroll
    for (int i = 0; i < QT / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    warp_mma<QT / 8, D, false>(st, sK + warp * 16 * LD, LD, sQ, LD);
    warp_mma<QT / 8, D, false>(dpt, sV + warp * 16 * LD, LD, sdO, LD);
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nt * 8 + 2 * tq + (j & 1), kvrow = kr0 + 8 * (j >> 1);
        const float p = sp_visible(a, i0 + c, kvrow)
                            ? exp2f(st[nt][j] * sl2 - sLse[c] * kLog2e)
                            : 0.f;
        st[nt][j] = p;
        dpt[nt][j] = p * (dpt[nt][j] - sDelta[c]) * a.scale;
      }
    store_tile<T, QT / 8>(sP, LDT, st);    // p^T rounded to dO's dtype
    store_tile<T, QT / 8>(sS, LDT, dpt);   // ds^T rounded to q's dtype
    __syncwarp();
    warp_mma<D / 8, QT, true>(dv, sP, LDT, sdO, LD);
    warp_mma<D / 8, QT, true>(dk, sS, LDT, sQ, LD);
    __syncwarp();
  }
  cp_async_wait<0>();

  T* dkp = static_cast<T*>(a.dk) + kbase;
  T* dvp = static_cast<T*>(a.dv) + kbase;
  if (chunks == 1) {
    store_rows<T, D / 8>(dkp, kstride, kr0, a.S, dk, 1.f, 1.f);
    store_rows<T, D / 8>(dvp, kstride, kr0, a.S, dv, 1.f, 1.f);
    return;
  }
  // a split column: this chunk's fp32 partial in this warp's register order
  // (float4 nt of lane l of slice w at ((tensor * W + w) * D / 8 + nt) * 32
  // + l), then a ticket of the slice's counter
  const int W = a.bs / 16, w = part * (BT / 16) + warp;   // this warp's 16-row slice
  const size_t span = (size_t)2 * a.bs * D / 4;           // float4s of one partial
  float4* mine = reinterpret_cast<float4*>(partials) + ((size_t)(slot0 + chunk) * BH + bh) * span;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    mine[((size_t)w * (D / 8) + nt) * 32 + lane] =
        make_float4(dk[nt][0], dk[nt][1], dk[nt][2], dk[nt][3]);
    mine[((size_t)(W + w) * (D / 8) + nt) * 32 + lane] =
        make_float4(dv[nt][0], dv[nt][1], dv[nt][2], dv[nt][3]);
  }
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    int* c = counters + ((size_t)ctr * BH + bh) * kSliceCap + w;
    last = atomicAdd(c, 1) == chunks - 1;
    if (last) *c = 0;   // every chunk has arrived: ready for the next call
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  // the last chunk to arrive sums the column's partials in chunk order
  const int nuse = plant == 1 ? chunks - 1 : chunks;   // planted fault 1
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int c = 0; c < nuse; ++c) {
    const float4* src =
        reinterpret_cast<const float4*>(partials) + ((size_t)(slot0 + c) * BH + bh) * span;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const float4 x = __ldcg(src + ((size_t)w * (D / 8) + nt) * 32 + lane);
      const float4 y = __ldcg(src + ((size_t)(W + w) * (D / 8) + nt) * 32 + lane);
      dk[nt][0] += x.x;
      dk[nt][1] += x.y;
      dk[nt][2] += x.z;
      dk[nt][3] += x.w;
      dv[nt][0] += y.x;
      dv[nt][1] += y.y;
      dv[nt][2] += y.z;
      dv[nt][3] += y.w;
    }
  }
  store_rows<T, D / 8>(dkp, kstride, kr0, a.S, dk, 1.f, 1.f);
  store_rows<T, D / 8>(dvp, kstride, kr0, a.S, dv, 1.f, 1.f);
}

// ----------------------------------------------------------- launchers --
enum Which { kFwd, kDq, kDkv };

template <Which W, typename T, int D, int BT>
cudaError_t launch(const SArgs& a, const DkvPlan& pl, cudaStream_t stream) {
  size_t smem;
  cudaError_t err;
  if constexpr (W == kFwd) {
    const dim3 grid(a.S / BT, a.B * a.H);
    smem = fwd_smem<T, D, BT>();
    if ((err = allow_smem(sparse_fwd_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
    sparse_fwd_kernel<T, D, BT><<<grid, 2 * BT, smem, stream>>>(a);
  } else if constexpr (W == kDq) {
    const dim3 grid(a.S / BT, a.B * a.H);
    smem = dq_smem<T, D, BT>();
    if ((err = allow_smem(sparse_dq_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
    sparse_dq_kernel<T, D, BT><<<grid, 2 * BT, smem, stream>>>(a);
  } else {
    const long long items = (long long)pl.n_plan * a.B * a.Hkv * (a.bs / BT);
    if (pl.n_plan <= 0 || items >= (1ll << 31)) return cudaErrorInvalidValue;
    smem = DkvSmem<T, D, BT>::BYTES;
    if ((err = allow_smem(sparse_dkv_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
    sparse_dkv_kernel<T, D, BT><<<(unsigned)items, 2 * BT, smem, stream>>>(
        a, pl.plan, pl.counters, pl.partials, g_plant);
  }
  return cudaGetLastError();
}

template <Which W, typename T, int D>
cudaError_t launch_bt(const SArgs& a, const DkvPlan& pl, cudaStream_t s) {
  if (a.bs >= 64) return launch<W, T, D, 64>(a, pl, s);
  if (a.bs == 32) return launch<W, T, D, 32>(a, pl, s);
  return launch<W, T, D, 16>(a, pl, s);
}

template <Which W>
cudaError_t launch_any(const SArgs& a, int D, int dtype, cudaStream_t s,
                       const DkvPlan& pl = DkvPlan{}) {
  if (a.bs != 16 && a.bs != 32 && a.bs != 64 && a.bs != 128) return cudaErrorInvalidValue;
  if (a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.S % a.bs != 0 || a.max_a <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D == 128) return launch_bt<W, __nv_bfloat16, 128>(a, pl, s);
    if (D == 64) return launch_bt<W, __nv_bfloat16, 64>(a, pl, s);
    if (D == 32) return launch_bt<W, __nv_bfloat16, 32>(a, pl, s);
  } else if (dtype == 1) {
    if (D == 128) return launch_bt<W, float, 128>(a, pl, s);
    if (D == 64) return launch_bt<W, float, 64>(a, pl, s);
    if (D == 32) return launch_bt<W, float, 32>(a, pl, s);
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
// [S/bs, max_t], cnt_t [S/bs] (compact_layout_t) and the plan [n_plan, 8]
// int32 of ops/sparse_attention.py `dkv_split_plan`; counters (int32, zero,
// split columns x B * Hkv x 8) and partials (fp32, the plan's slots x B *
// Hkv x 2 * bs * D) are the wrapper's cached scratch. lse and delta 16-byte
// aligned.
extern "C" int dstt_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, const int* idx_t, const int* cnt_t,
                                   const int* plan, int* counters, float* partials, int max_t,
                                   int n_plan, int B, int H, int Hkv, int S, int D, int bs,
                                   int causal, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) % 16)
    return (int)cudaErrorMisalignedAddress;
  SArgs a = make_args(q, k, v, idx_t, cnt_t, max_t, B, H, Hkv, S, bs, causal, scale);
  a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  const DkvPlan pl{plan, n_plan, counters, partials};
  return (int)launch_any<kDkv>(a, D, dtype, static_cast<cudaStream_t>(stream), pl);
}

// Plants a fault in the dK/dV kernel's next launches (tests only): 1 the
// merge of a split column drops its last chunk's partial; 0 none.
extern "C" int dstt_sparse_attention_plant(int fault) {
  g_plant = fault;
  return 0;
}
