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
// Forward and dQ. What bounded PR 5's design (a block of BT / 16 warps per
// (BT q rows, batch, query head), each kv sub-tile loaded synchronously
// between two barriers, P and dS through shared memory, the causal test on
// every score): at S 4096 bigbird causal block 32 each q block's list holds
// ~5 entries, so 4096 blocks of 2 warps each paid a Q load and an epilogue
// for ~5 tiles, every kv sub-tile was read once per query head (4 times
// under GQA 32/8), and no load overlapped a product (142 us forward and
// 164 us dQ against 25 and 35 us of bytes). Design, accordingly:
// - A work item is (q part of BT = min(bs, 64) rows, batch, kv head, head
//   group): the group's query heads are stacked in the item, each as BT
//   rows, a warp owning 16 rows of one head, at most ItemRows rows (8 warps
//   in bf16, 4 in fp32), so each K / V sub-tile is read from L2 once per
//   head group. ops/sparse_attention.py `mma_items` lists the items' (q
//   block, part, first head) longest list first (`dq_item_order`); the
//   item count and heads an item are kernel parameters of their own (SArgs
//   stays the dK/dV kernel's).
// - The item walks its q block's list in kv sub-tiles of KT rows (forward
//   min(BT, 32), dQ 16), the sub-tiles of a causal diagonal block that lie
//   wholly above the item's rows left out. K and V come through a 3-stage
//   ring of 16-byte cp.async copies, one barrier a step, the next two
//   steps' copies in flight under this step's products. Q (dQ: and dO) is
//   copied once with the first stage; dQ's lse and delta rows sit in
//   registers. bf16 aims at two blocks an SM (128 registers a thread), so
//   that one item's loads and epilogue run under another's products: at hd
//   128 Q and dO are then read from shared memory each step (held in
//   registers, they cost the second block: forward 101 against 77 us, dQ
//   114 against 105, on an H100 at S 4096 block 32), at hd 64 and below
//   they are held in registers as the A operand. dQ's Q and dO take twice
//   the forward's shared memory, so its ring steps by 16 rows to keep two
//   blocks an SM. Deferring each step's second product under the next
//   step's first ones (a 4-stage ring) gained nothing there.
// - bf16 P (forward) and dS (dQ) stay in registers: the m16n8k16
//   accumulator packed to bf16 A fragments (p rounded to v's dtype, ds to
//   k's, as on the TPU) for O += P V and dQ += dS K. fp32 takes FMA products
//   through a per-warp scratch.
// - The causal mask runs only on a sub-tile the diagonal crosses; a warp
//   whose rows all precede the sub-tile skips the step. The forward's
//   softmax is sparse_sm90.cu's: one FFMA and one exp2 a score where nothing
//   is masked, row sums reduced once in the epilogue, the rescale skipped
//   while every row's max stays put.
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
// Planted faults (dstt_sparse_attention_plant, tests only): 1 dK/dV's
// merge of a split column drops its last chunk's partial; 2 the forward
// reads each step's K / V from the ring stage after its own, before that
// copy has landed; 3 dQ leaves the last query head of each item out.

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

// ------------------------------------------------------- forward and dQ --
constexpr int kItemInts = 3;   // int32 fields of a work item: q block, part, first head

// q rows a forward / dQ work item holds at most: 8 warps of 16 in bf16, 4
// in fp32 (whose Q, dO and scratch take twice the shared memory)
template <typename T> struct ItemRows { static constexpr int value = sizeof(T) == 2 ? 128 : 64; };

constexpr int kRing = 3;   // ring stages of K / V sub-tiles

// The forward's (DQ false) or dQ's shape: kv rows a step, whether the
// warp's q rows are held in registers, the blocks an SM its registers aim
// at; and its shared memory for an item of `rows` q rows: the ring (per
// stage K, then V, KT rows each), the item's q rows (NQ of them: Q; dQ: Q,
// then dO), in fp32 each warp's p / ds scratch, and each stage's first kv
// row. Every region starts on 16 bytes.
template <typename T, int D, int BT, bool DQ>
struct RowCfg {
  static constexpr bool BF = sizeof(T) == 2;
  static constexpr int KT = DQ ? 16 : (BT < 32 ? BT : 32);
  static constexpr int AHEAD = kRing - 1;   // steps the ring's copies run ahead
  static constexpr bool QREGS = BF && D <= 64;
  static constexpr int MINB = BF ? 2 : 1;
  static constexpr int NQ = DQ ? 2 : 1;
  static constexpr int LD = D + Pad<T>::value, LDP = KT + Pad<T>::value;
  static constexpr size_t STAGE = (size_t)2 * KT * LD;   // elements
  static constexpr size_t bytes(int rows) {
    return sizeof(T) * (kRing * STAGE + (size_t)NQ * rows * LD + (BF ? 0 : (size_t)rows * LDP)) +
           16;
  }
};

// A forward / dQ work item. blockIdx.x = entry * B * Hkv + b * Hkv + hk
// over the item list (`items`, int32 [entries, kItemInts]); the item holds
// q rows q0 .. q0 + BT - 1 of the query heads h0 .. h0 + hpi - 1 of kv head
// hk, warp w the 16 rows wr0 .. wr0 + 15 of head h0 + hw. Its n steps are
// the kv sub-tiles (KT rows) of its q block's list in list order, less the
// trailing sub-tiles of a causal diagonal block that lie wholly above the
// item's rows (compact_layout's lists ascend, so the diagonal is last).
template <int BT, int KT>
struct QItem {
  int qb, q0, b, hk, h0, hw, wr0, n, lsub;
  __device__ __forceinline__ QItem(const SArgs& a, const int* __restrict__ items) {
    const int BH = a.B * a.Hkv, bh = blockIdx.x % BH, warp = threadIdx.x >> 5;
    const int* e = items + (size_t)(blockIdx.x / BH) * kItemInts;
    qb = __ldg(e);
    const int part = __ldg(e + 1);
    q0 = qb * a.bs + part * BT;
    b = bh / a.Hkv;
    hk = bh % a.Hkv;
    h0 = hk * (a.H / a.Hkv) + __ldg(e + 2);
    hw = warp / (BT / 16);
    wr0 = q0 + (warp % (BT / 16)) * 16;
    const int subs = a.bs / KT, cnt = __ldg(a.cnt + qb);
    lsub = __ffs(subs) - 1;
    n = cnt * subs;
    if (a.causal && __ldg(a.idx + (size_t)qb * a.max_a + cnt - 1) == qb)
      n -= subs - min(subs, (part * BT + BT - 1) / KT + 1);
  }
  // the first kv row of step s
  __device__ __forceinline__ int kv0(const SArgs& a, int s) const {
    return __ldg(a.idx + (size_t)qb * a.max_a + (s >> lsub)) * a.bs +
           (s & ((1 << lsub) - 1)) * KT;
  }
};

// The item's q rows of one [B, S, H, D] tensor (g at batch b, head h0;
// head j of the item at shared rows j BT ..) as 16-byte cp.async copies by
// the whole block.
template <typename T, int D, int BT>
__device__ __forceinline__ void copy_item_rows(T* sm, const T* g, int rows, int q0,
                                               size_t qstride) {
  constexpr int VEC = 16 / sizeof(T), LD = D + Pad<T>::value, VPR = D / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    cp_async16(sm + r * LD + c, g + (size_t)(r / BT) * D + (size_t)(q0 + r % BT) * qstride + c);
  }
}

// kv rows kv0 .. kv0 + KT - 1 of K and V into a ring stage (K, then V).
template <typename T, int D, int KT>
__device__ __forceinline__ void copy_kv(T* st, const T* k, const T* v, int kv0, size_t kstride) {
  constexpr int VEC = 16 / sizeof(T), LD = D + Pad<T>::value, VPR = D / VEC;
  for (int i = threadIdx.x; i < 2 * KT * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    cp_async16(st + r * LD + c, (r < KT ? k : v) + (size_t)(kv0 + r % KT) * kstride + c);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warp's 16 x K bf16 tile (row stride ld) as m16n8k16 A fragments, one
// per 16 columns, as warp_mma loads them.
template <int K>
__device__ __forceinline__ void load_a(uint32_t (&af)[K / 16][4], const __nv_bfloat16* a,
                                       int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    ldsm_x4(af[kk], a + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
}

// A warp's [16 x 8 NT] accumulator rounded to bf16 as the A fragments of a
// product over its 8 NT columns (no trip through shared memory).
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&af)[NT / 2][4], const float (&v)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    af[kk][0] = bf16x2(v[2 * kk][0], v[2 * kk][1]);
    af[kk][1] = bf16x2(v[2 * kk][2], v[2 * kk][3]);
    af[kk][2] = bf16x2(v[2 * kk + 1][0], v[2 * kk + 1][1]);
    af[kk][3] = bf16x2(v[2 * kk + 1][2], v[2 * kk + 1][3]);
  }
}

// warp_mma with A in registers (K / 16 fragments): acc[NT][4] += A B, B in
// shared memory as warp_mma reads it.
template <int NT, int K, bool B_KN>
__device__ __forceinline__ void mma_ra(float (&acc)[NT][4], const uint32_t (&af)[K / 16][4],
                                       const __nv_bfloat16* b, int ldb) {
  static_assert(NT % 2 == 0, "B tiles are loaded in pairs");
  const int lane = threadIdx.x & 31;
  const int brow = lane & 7, bk = ((lane >> 3) & 1) * 8, bn = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      if constexpr (!B_KN)
        ldsm_x4(bf, b + (nt * 8 + bn + brow) * ldb + kk * 16 + bk);
      else
        ldsm_x4_trans(bf, b + (kk * 16 + bk + brow) * ldb + nt * 8 + bn);
      mma_bf16(acc[nt], af[kk][0], af[kk][1], af[kk][2], af[kk][3], bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af[kk][0], af[kk][1], af[kk][2], af[kk][3], bf[2], bf[3]);
    }
}

// A warp's [16 x 8 NT] accumulator times `mul` per row half to rows row_lo
// and row_lo + 8 of a global matrix, as pairs (bf16x2 or float2): a row's
// 4 lanes write one contiguous run an instruction, where store_rows' single
// elements write every other element in each of two (with them both kernels
// read ~35 us slower at S 4096 block 32 on an H100).
template <typename T, int NT>
__device__ __forceinline__ void store_pairs(T* g, size_t gstride, int row_lo,
                                            const float (&v)[NT][4], float mul0, float mul1) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float mul = half ? mul1 : mul0;
    T* gr = g + (size_t)(row_lo + 8 * half) * gstride;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tq;
      const float x = v[nt][2 * half] * mul, y = v[nt][2 * half + 1] * mul;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(gr + c) = bf16x2(x, y);
      else
        *reinterpret_cast<float2*>(gr + c) = make_float2(x, y);
    }
  }
}

// One step's scores of this thread's rows (s: the S accumulator, rows row0
// + gr and + 8, columns col0 + ..) through the scale, the causal mask where
// the diagonal crosses the sub-tile (mask), and the online softmax in
// base-2 units: s becomes p, m and l move on (l this thread's share of each
// row's sum: the quad sums it once, in the epilogue), alpha is the factor
// the accumulator must take. Unmasked: one FFMA and one exp2 a score.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float sl2, bool mask,
                                               int row0, int col0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY}, mu[2], ls[2] = {0.f, 0.f};
  if (!mask && sl2 > 0.f) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
      alpha[r] = mn == -INFINITY ? 1.f : ex2(m[r] - mn);
      m[r] = mn;
      mu[r] = mn == -INFINITY ? 0.f : mn;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(fmaf(s[nt][e], sl2, -mu[e >> 1]));
        ls[e >> 1] += s[nt][e];
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + gr + 8 * (e >> 1), col = col0 + nt * 8 + 2 * tq + (e & 1);
        const float x = mask && col > row ? -INFINITY : s[nt][e] * sl2;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = mn == -INFINITY ? 1.f : ex2(m[r] - mn);
      m[r] = mn;
      mu[r] = mn == -INFINITY ? 0.f : mn;   // the max subtracted: 0 for a row that saw no key
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(s[nt][e] - mu[e >> 1]);
        ls[e >> 1] += s[nt][e];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * ItemRows<T>::value, (RowCfg<T, D, BT, false>::MINB))
    sparse_fwd_kernel(const SArgs a, const int* __restrict__ items, const int hpi,
                      const int plant) {
  using C = RowCfg<T, D, BT, false>;
  constexpr int KT = C::KT, LD = C::LD, LDP = C::LDP, AHEAD = C::AHEAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sRing = reinterpret_cast<T*>(smem);
  T* sQ = sRing + kRing * C::STAGE;
  const int rows = hpi * BT, warp = threadIdx.x >> 5, gr = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  T* sP = sQ + (size_t)rows * LD + warp * 16 * LDP;   // fp32: this warp's p
  int* sKv = reinterpret_cast<int*>(sQ + (size_t)rows * (LD + (C::BF ? 0 : LDP)));
  const T* sQw = sQ + warp * 16 * LD;                 // this warp's q rows
  const QItem<BT, KT> it(a, items);
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = ((size_t)it.b * a.S * a.Hkv + it.hk) * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  // Q joins the first stage's copies; each stage's first kv row goes to
  // sKv, the next copy's is read a step ahead
  copy_item_rows<T, D, BT>(sQ, static_cast<const T*>(a.q) + ((size_t)it.b * a.S * a.H + it.h0) * D,
                           rows, it.q0, qstride);
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < it.n) {
      const int c = it.kv0(a, s);
      copy_kv<T, D, KT>(sRing + s * C::STAGE, k, v, c, kstride);
      if (threadIdx.x == 0) sKv[s] = c;
    }
    cp_async_commit();
  }
  int c_next = AHEAD < it.n ? it.kv0(a, AHEAD) : 0;
  uint32_t qa[C::QREGS ? D / 16 : 1][4];   // this warp's Q rows as the A operand of S = Q K^T
  if constexpr (C::QREGS) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    load_a<D>(qa, sQw, LD);
  }

  const float sl2 = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int s = 0; s < it.n; ++s) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();   // step s has landed for every thread; the stage it replaces is free
    if (s + AHEAD < it.n) {
      copy_kv<T, D, KT>(sRing + (s + AHEAD) % kRing * C::STAGE, k, v, c_next, kstride);
      if (threadIdx.x == 0) sKv[(s + AHEAD) % kRing] = c_next;
    }
    cp_async_commit();
    c_next = s + AHEAD + 1 < it.n ? it.kv0(a, s + AHEAD + 1) : 0;
    const int c0 = sKv[s % kRing];
    const bool skip = a.causal && c0 > it.wr0 + 15;       // every key after the warp's rows
    const bool mask = a.causal && c0 + KT - 1 > it.wr0;   // the diagonal crosses the sub-tile
    const T* sK = sRing + (plant == 2 ? s + 1 : s) % kRing * C::STAGE;   // planted fault 2
    const T* sV = sK + KT * LD;

    float sc[KT / 8][4];
    if (!skip) {
#pragma unroll
      for (int i = 0; i < KT / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      if constexpr (C::QREGS)
        mma_ra<KT / 8, D, false>(sc, qa, sK, LD);
      else
        warp_mma<KT / 8, D, false>(sc, sQw, LD, sK, LD);
    }
    if (skip) continue;
    float alpha[2];
    online_softmax<KT / 8>(sc, m, l, alpha, sl2, mask, it.wr0, c0);
    // once a row's max stops moving its alpha is exactly 1: skip the rescale
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
    }
    if constexpr (C::BF) {
      uint32_t pa[KT / 16][4];   // p rounded to v's dtype, as on the TPU
      acc_to_a<KT / 8>(pa, sc);
      mma_ra<D / 8, KT, true>(acc, pa, sV, LD);
    } else {
      store_tile<T, KT / 8>(sP, LDP, sc);
      __syncwarp();
      warp_mma<D / 8, KT, true>(acc, sP, LDP, sV, LD);
      __syncwarp();
    }
  }
  cp_async_wait<0>();

  const int r0 = it.wr0 + gr;
  const size_t bh = (size_t)it.b * a.H + it.h0 + it.hw;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    if (tq == 0)
      a.lse_out[bh * a.S + r0 + 8 * i] = (m[i] == -INFINITY ? kNegInf : m[i] * kLn2) + logf(l_safe);
  }
  store_pairs<T, D / 8>(static_cast<T*>(a.o) + ((size_t)it.b * a.S * a.H + it.h0 + it.hw) * D,
                        qstride, r0, acc, inv[0], inv[1]);
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(2 * ItemRows<T>::value, (RowCfg<T, D, BT, true>::MINB))
    sparse_dq_kernel(const SArgs a, const int* __restrict__ items, const int hpi,
                     const int plant) {
  using C = RowCfg<T, D, BT, true>;
  constexpr int KT = C::KT, LD = C::LD, LDP = C::LDP, AHEAD = C::AHEAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sRing = reinterpret_cast<T*>(smem);
  T* sQ = sRing + kRing * C::STAGE;
  const int rows = hpi * BT, warp = threadIdx.x >> 5, gr = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  T* sdO = sQ + (size_t)rows * LD;
  T* sS = sdO + (size_t)rows * LD + warp * 16 * LDP;   // fp32: this warp's ds
  int* sKv = reinterpret_cast<int*>(sdO + (size_t)rows * (LD + (C::BF ? 0 : LDP)));
  const T* sQw = sQ + warp * 16 * LD;                  // this warp's q rows
  const T* sdOw = sdO + warp * 16 * LD;
  const QItem<BT, KT> it(a, items);
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = ((size_t)it.b * a.S * a.Hkv + it.hk) * D;
  const size_t qbase = ((size_t)it.b * a.S * a.H + it.h0) * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  // Q and dO join the first stage's copies; each stage's first kv row goes
  // to sKv, the next copy's is read a step ahead
  copy_item_rows<T, D, BT>(sQ, static_cast<const T*>(a.q) + qbase, rows, it.q0, qstride);
  copy_item_rows<T, D, BT>(sdO, static_cast<const T*>(a.dout) + qbase, rows, it.q0, qstride);
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < it.n) {
      const int c = it.kv0(a, s);
      copy_kv<T, D, KT>(sRing + s * C::STAGE, k, v, c, kstride);
      if (threadIdx.x == 0) sKv[s] = c;
    }
    cp_async_commit();
  }
  int c_next = AHEAD < it.n ? it.kv0(a, AHEAD) : 0;
  const int r0 = it.wr0 + gr;
  const size_t bh = (size_t)it.b * a.H + it.h0 + it.hw;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = __ldg(a.lse + bh * a.S + r0 + 8 * i) * kLog2e;
    dlt[i] = __ldg(a.delta + bh * a.S + r0 + 8 * i);
  }
  // this warp's Q and dO rows as the A operands of S = Q K^T and dP = dO V^T
  uint32_t qa[C::QREGS ? D / 16 : 1][4], da[C::QREGS ? D / 16 : 1][4];
  if constexpr (C::QREGS) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    load_a<D>(qa, sQw, LD);
    load_a<D>(da, sdOw, LD);
  }
  const bool left_out = plant == 3 && it.hw == hpi - 1;   // planted fault 3

  const float sl2 = a.scale * kLog2e;
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  for (int s = 0; s < it.n; ++s) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();   // step s has landed for every thread; the stage it replaces is free
    if (s + AHEAD < it.n) {
      copy_kv<T, D, KT>(sRing + (s + AHEAD) % kRing * C::STAGE, k, v, c_next, kstride);
      if (threadIdx.x == 0) sKv[(s + AHEAD) % kRing] = c_next;
    }
    cp_async_commit();
    c_next = s + AHEAD + 1 < it.n ? it.kv0(a, s + AHEAD + 1) : 0;
    const int c0 = sKv[s % kRing];
    // every key after the warp's rows, or planted fault 3
    const bool skip = left_out || (a.causal && c0 > it.wr0 + 15);
    const bool mask = a.causal && c0 + KT - 1 > it.wr0;   // the diagonal crosses the sub-tile
    const T* sK = sRing + s % kRing * C::STAGE;
    const T* sV = sK + KT * LD;

    float sc[KT / 8][4], dp[KT / 8][4];
    if (!skip) {
#pragma unroll
      for (int i = 0; i < KT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
      if constexpr (C::QREGS) {
        mma_ra<KT / 8, D, false>(sc, qa, sK, LD);
        mma_ra<KT / 8, D, false>(dp, da, sV, LD);
      } else {
        warp_mma<KT / 8, D, false>(sc, sQw, LD, sK, LD);
        warp_mma<KT / 8, D, false>(dp, sdOw, LD, sV, LD);
      }
    }
    if (skip) continue;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, row = r0 + 8 * i, col = c0 + nt * 8 + 2 * tq + (e & 1);
        const float p = mask && col > row ? 0.f : ex2(fmaf(sc[nt][e], sl2, -lse2[i]));
        sc[nt][e] = p * (dp[nt][e] - dlt[i]) * a.scale;
      }
    if constexpr (C::BF) {
      uint32_t sa[KT / 16][4];   // ds rounded to k's dtype, as on the TPU
      acc_to_a<KT / 8>(sa, sc);
      mma_ra<D / 8, KT, true>(dq, sa, sK, LD);
    } else {
      store_tile<T, KT / 8>(sS, LDP, sc);
      __syncwarp();
      warp_mma<D / 8, KT, true>(dq, sS, LDP, sK, LD);
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  store_pairs<T, D / 8>(static_cast<T*>(a.dq) + qbase + (size_t)it.hw * D, qstride, r0, dq, 1.f,
                        1.f);
}

// --------------------------------------------------------------- dK/dV --
constexpr int kDkvStages = 3;   // ring stages of Q, dO, lse and delta
constexpr int kPlanInts = 8;    // int32 fields of a plan entry
constexpr int kSliceCap = 8;    // counters a (column, batch, kv head): bs / 16 <= 8

int g_plant = 0;   // planted fault of the next launches (tests)

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

// The forward's and dQ's work items (ops/sparse_attention.py `mma_items`,
// int32 [n, kItemInts]) and the query heads an item stacks, kernel
// parameters of their own.
struct QItems {
  const int* items;
  int n, heads;
};

template <Which W, typename T, int D, int BT>
cudaError_t launch(const SArgs& a, const DkvPlan& pl, const QItems& qi, cudaStream_t stream) {
  size_t smem;
  cudaError_t err;
  if constexpr (W == kFwd || W == kDq) {
    const long long blocks = (long long)qi.n * a.B * a.Hkv;
    const int rows = qi.heads * BT;
    if (qi.n <= 0 || qi.heads <= 0 || (a.H / a.Hkv) % qi.heads != 0 ||
        rows > ItemRows<T>::value || blocks >= (1ll << 31))
      return cudaErrorInvalidValue;
    if constexpr (W == kFwd) {
      smem = RowCfg<T, D, BT, false>::bytes(rows);
      if ((err = allow_smem(sparse_fwd_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
      sparse_fwd_kernel<T, D, BT><<<(unsigned)blocks, 2 * rows, smem, stream>>>(
          a, qi.items, qi.heads, g_plant);
    } else {
      smem = RowCfg<T, D, BT, true>::bytes(rows);
      if ((err = allow_smem(sparse_dq_kernel<T, D, BT>, smem)) != cudaSuccess) return err;
      sparse_dq_kernel<T, D, BT><<<(unsigned)blocks, 2 * rows, smem, stream>>>(
          a, qi.items, qi.heads, g_plant);
    }
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
cudaError_t launch_bt(const SArgs& a, const DkvPlan& pl, const QItems& qi, cudaStream_t s) {
  if (a.bs >= 64) return launch<W, T, D, 64>(a, pl, qi, s);
  if (a.bs == 32) return launch<W, T, D, 32>(a, pl, qi, s);
  return launch<W, T, D, 16>(a, pl, qi, s);
}

template <Which W>
cudaError_t launch_any(const SArgs& a, int D, int dtype, cudaStream_t s,
                       const DkvPlan& pl = DkvPlan{}, const QItems& qi = QItems{}) {
  if (a.bs != 16 && a.bs != 32 && a.bs != 64 && a.bs != 128) return cudaErrorInvalidValue;
  if (a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.S % a.bs != 0 || a.max_a <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D == 128) return launch_bt<W, __nv_bfloat16, 128>(a, pl, qi, s);
    if (D == 64) return launch_bt<W, __nv_bfloat16, 64>(a, pl, qi, s);
    if (D == 32) return launch_bt<W, __nv_bfloat16, 32>(a, pl, qi, s);
  } else if (dtype == 1) {
    if (D == 128) return launch_bt<W, float, 128>(a, pl, qi, s);
    if (D == 64) return launch_bt<W, float, 64>(a, pl, qi, s);
    if (D == 32) return launch_bt<W, float, 32>(a, pl, qi, s);
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
// blocks (compact_layout); items [n_items, 3] int32 and heads_per_item: the
// work items of ops/sparse_attention.py `mma_items`. bs: 16, 32, 64 or 128;
// D: 32, 64 or 128; dtype: 0 bf16, 1 fp32.
extern "C" int dstt_sparse_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               const int* idx, const int* cnt, const int* items, int max_a,
                               int n_items, int heads_per_item, int B, int H, int Hkv, int S,
                               int D, int bs, int causal, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  SArgs a = make_args(q, k, v, idx, cnt, max_a, B, H, Hkv, S, bs, causal, scale);
  a.o = o;
  a.lse_out = lse;
  return (int)launch_any<kFwd>(a, D, dtype, static_cast<cudaStream_t>(stream), DkvPlan{},
                               QItems{items, n_items, heads_per_item});
}

// dq [B, S, H, D] from q, k, v, dout, lse and delta [B * H, S] over the
// same lists and work items.
extern "C" int dstt_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dq, const int* idx,
                                  const int* cnt, const int* items, int max_a, int n_items,
                                  int heads_per_item, int B, int H, int Hkv, int S, int D,
                                  int bs, int causal, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  SArgs a = make_args(q, k, v, idx, cnt, max_a, B, H, Hkv, S, bs, causal, scale);
  a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  return (int)launch_any<kDq>(a, D, dtype, static_cast<cudaStream_t>(stream), DkvPlan{},
                              QItems{items, n_items, heads_per_item});
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

// Plants a fault in the next launches (tests only): 1 dK/dV's merge of a
// split column drops its last chunk's partial; 2 the forward reads each
// step's K / V from the ring stage after its own; 3 dQ leaves the last query
// head of each work item out; 0 none.
extern "C" int dstt_sparse_attention_plant(int fault) {
  g_plant = fault;
  return 0;
}
