// Block-sparse attention for Hopper (sm_90a), bf16, layout block 128, hd
// 32 / 64 / 128: dK/dV (the columns of the layout split over work items),
// dQ and the forward (further down), each on TMA loads into an mbarrier
// ring, wgmma products and warp specialisation. bf16 at blocks 16-64 and
// all of fp32 stay on sparse_attention.cu (ops/sparse_attention.py
// `sparse_source` routes the three kernels by one rule of shape and dtype).
//
// dK/dV replaces: deepspeed_tpu/ops/pallas/sparse_attention.py `_sparse_dkv_kernel`
// (:126, pallas_call at :333), driven by `sparse_flash_attention_bwd` (:270).
// The same function as sparse_attention.cu's dK/dV: for each kv block, the
// q blocks of its transposed list (`compact_layout_t`, :193), each of the
// kv head's g query heads in turn; p recomputed from the forward's lse, p =
// exp(scale q k^T - lse) (0 above the diagonal of a causal layout's
// diagonal block), dp = dO v^T, ds = p (dp - delta) scale rounded to bf16;
// dv = p^T dO (p rounded to bf16), dk = ds^T q, fp32 accumulation. Under GQA
// K / V are read in place and the group's heads add up: NARROW dK/dV, no
// widen-then-sum. A kv block no q block sees gets zero dK/dV.
//
// Bound on an H100 SXM: operations, over the active pairs. At Llama-3-8B
// width (32 / 8 heads, hd 128) with S 16384, block 128 and a causal bigbird
// layout (window 3, global 1, random 2): four products over the visible
// (q, k) pairs, ~308 GFLOP, 311 us at 989 TFLOP/s, against ~0.41 GB of
// inputs and outputs (~121 us of HBM time).
//
// What bounded sparse_attention.cu's kernel there: one block per (kv block,
// batch, kv head) walks that column's whole list. The global column (kv
// block 0) is in all 128 q blocks' lists, so its blocks walk 128 q blocks x
// 4 heads while a typical one walks ~4 x 4: the kernel's time was that
// one walk (7.3 ms against 0.3 ms of operations), on mma.sync tiles.
// Design, accordingly:
// - Work items split the long columns. An item is (plan entry, batch, kv
//   head); a plan entry (ops/sparse_attention.py `dkv_split_plan`, uploaded
//   as int32 [entries, 8]) is one chunk of one column: a run of at most L
//   consecutive (query head, listed q block) pairs, L twice the median
//   column's pairs. At that layout column 0's 512 pairs become 16 chunks of
//   32 and every other column (<= 32 pairs) stays one. Entries come longest
//   first and a persistent grid (one block of 3 warpgroups per SM) deals
//   items forward and backward in turn, as flash_bwd_sm90.cu does.
// - A column of one chunk stores bf16 dK/dV directly (zeros when it has no
//   pair). The chunks of a split column write fp32 partials to scratch;
//   then each consumer warp takes a ticket from a counter of its own (per
//   column, batch, kv head and warp) after a __threadfence, and the warp
//   that draws the last ticket sums the column's partials in chunk order
//   (deterministic: two calls give the same bits) into bf16 dK/dV and
//   resets its counter to 0 for the next call. A warp stores its partial in
//   its own threads' accumulator layout, so it reads back exactly its lanes'
//   values: no exchange between warps, no barrier.
// - The item's step is flash_bwd_sm90.cu's dK/dV step: 128 kv rows of K and
//   V loaded once by TMA; Q and dO tiles of 64 rows streamed through a
//   4-stage ring by the producer warp, whose next coordinate comes from the
//   item's chunk of the transposed list (query head, q block, one of its two
//   64-row tiles), with each tile's lse (base 2) and delta staged beside it
//   by the producer's ordinary loads; per tile and consumer warpgroup (64 kv
//   rows) S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16 from shared
//   memory), p^T packed to bf16 in registers as the A operand of dV += P^T
//   dO, ds^T that of dK += dS^T Q. P and dS never leave registers. The
//   element mask applies only on a causal layout's diagonal block.
// - The rules of the repo's wgmma kernels hold: [rows, 64] TMA boxes with a
//   128-byte swizzle (64-byte at hd 32); setmaxnreg only inside `if
//   (consumer) {...} else {...}`; wgmma only under conditions on tile and
//   item indices, every value loaded from the plan or the lists broadcast
//   through __shfl_sync (as the warpgroup index is), so ptxas sees uniform
//   branches and keeps the wgmma asynchronous (C7520 otherwise).
// - A copy of the step, not a header shared with flash_bwd_sm90.cu: moving
//   it would change the text every flash kernel is compiled from, and nvcc
//   compiled unchanged flash text 44% slower once before when a shared
//   struct grew. This source includes the two headers unchanged.
// - Block 64 is not taken: an item is 128 kv rows for two consumer
//   warpgroups; a 64-row layout block would leave one of them idle or need
//   two items per block with lists of their own.
// Shared memory as flash_bwd_sm90.cu's dK/dV: K + V 4 * 128 * D bytes, 4
// stages of Q + dO 4 * 64 * D and 512 B of lse and delta; D = 128: 194 KB.
// Planted faults (dstt_sparse_sm90_plant, tests only): 1 the merge drops the
// last chunk's partial; 2 each tile is read from the ring stage after its
// own, before that copy has landed; 3 the last query head of each GQA group
// is skipped.
//
// dQ replaces: deepspeed_tpu/ops/pallas/sparse_attention.py `_sparse_dq_kernel`
// (:87, pallas_call at :307), driven by `sparse_flash_attention_bwd` (:280).
// The same function as sparse_attention.cu's dQ: for each q block, the kv
// blocks of its compacted list (`compact_layout`, :170); p = exp(scale q k^T
// - lse), 0 above the diagonal of a causal layout's diagonal block; dp = dO
// v^T; ds = p (dp - delta) scale rounded to bf16; dq = ds k in fp32, cast
// once. Bound: operations, three products over the visible pairs (at the
// dK/dV's S 16384 shape ~231 GFLOP, 233.5 us). sparse_attention.cu's dQ
// (one block of 64 q rows, mma.sync, K / V loaded synchronously per 64-row
// sub-tile) ran at 16% of it. Design: flash_bwd_sm90.cu's dQ step, copied
// (not shared, as above):
// - An item is 128 q rows (one layout block) of one (batch, head): Q and dO
//   loaded once by TMA, the two 64-row K / V tiles of each listed kv block
//   streamed through the 4-stage ring by the producer warp, which takes
//   each next coordinate from the q block's list (GQA: kv head h / g, read
//   in place). A list holds at most window + globals + randoms blocks, so
//   no row needs a split: each item owns its rows and stores bf16 dQ
//   directly (no merge, no atomics, the same bits on every call).
// - Per tile and consumer warpgroup (64 q rows): S = Q K^T and dP = dO V^T
//   (wgmma m64n64k16 from shared memory); dQ += dS K of the previous tile
//   (dS in registers as the A operand, K read MN-major) runs while p and ds
//   of this tile are computed. Masks by tile index only: on a causal
//   layout's diagonal block the tile below a consumer's rows is visible
//   whole, the tile on them takes the element mask, the tile above them is
//   skipped (its stage waited for and released, no product).
// - A persistent grid (one block of 3 warpgroups per SM); items in q blocks
//   of longest list first (ops/sparse_attention.py `dq_item_order`, an
//   int32 [S / 128] upload), all heads of a block together, dealt forward
//   and backward in turn.
// - The repo's wgmma rules as above: every list value and count broadcast
//   through __shfl_sync before it steers a branch around a wgmma.
// Shared memory as flash_bwd_sm90.cu's dQ: Q + dO 4 * 128 * D bytes, 4
// stages of K + V 4 * 64 * D; D = 128: 192 KB.
// Planted faults: 4 each list's last entry is left out; 5 each tile is
// read from the ring stage after its own; 6 the diagonal block's element
// mask is left out.
//
// Forward replaces: deepspeed_tpu/ops/pallas/sparse_attention.py
// `_sparse_fwd_kernel` (:39, pallas_call at :252), driven by
// `_sparse_fwd_lse` (:213). The same function as sparse_attention.cu's
// forward: for each q block, the kv blocks of its compacted list; s = scale
// q k^T (-inf above the diagonal of a causal layout's diagonal block), the
// running max m, sum l and accumulator O in fp32 (base-2 units), p rounded
// to bf16 before O += P V; o = O / l in bf16 and lse = m ln 2 + log l in
// fp32 [B * H, S], which both backward routes read. Bound: operations, two
// products over the visible pairs (at the dK/dV's S 16384 shape ~154 GFLOP,
// 155.7 us). sparse_attention.cu's forward (a block of 64 q rows, mma.sync,
// each kv sub-tile loaded synchronously behind two barriers) ran at 16% of
// it. Design: flash_fwd_sm90.cu's step, copied (not shared, as above), over
// the dQ kernel's items:
// - An item is 128 q rows of one (batch, head): Q loaded once by TMA, the
//   two 64-row K / V tiles of each listed kv block streamed through the
//   4-stage ring by the producer warp, which takes each coordinate from the
//   q block's list. Items in `dq_item_order` (longest list first), all
//   heads of a q block together, on a persistent grid dealt forward and
//   backward in turn; each item owns its rows (no merge).
// - Per tile and consumer warpgroup (64 q rows): S = Q K^T (wgmma
//   m64n64k16; Q's rows held in registers as the A operand, loaded once an
//   item by ldmatrix, so a tile's S reads only K from shared memory: 4-5%
//   faster at S 16384 on an H100 than Q read from shared memory); O += P V
//   of the previous tile (P in registers as the A operand, V read MN-major)
//   runs while this tile's online softmax is computed. Masks by tile index
//   only, as in dQ: on a causal layout's diagonal block the tile below a
//   consumer's rows is visible whole, the tile on them takes the element
//   mask, the tile above them is skipped.
// - The two consumers take turns on the tensor cores (named barriers, as in
//   flash_fwd_sm90.cu), so one's softmax runs under the other's products; a
//   skipped tile passes its turn on, so the two walks stay equal and the
//   turns run on across items. Q has two slots, each freed once its rows
//   are in registers: the next item's Q and first tiles load under this
//   item's products and epilogue (~6% faster at S 16384 on an H100 than one
//   slot; a deeper ring bought nothing).
// - The softmax sits on the critical path (on an H100 the forward without it
//   ran 28% faster at S 16384), so an unmasked tile takes one FFMA and one
//   exp2 a score, each thread keeps its share of a row's sum until the
//   epilogue, and O's rescale is skipped where a warp's factors are all 1.
// Shared memory: two Q slots 2 * 2 * 128 * D bytes, 4 stages of K + V 4 *
// 64 * D; D = 128: 192 KB. What still bounds it is not measured (no stall
// profiler): on an H100 a fit over the S 4096 layouts gives ~1.1 us a
// 64-row tile and ~3.4 us an item, against ~0.56 us of tensor time a tile.
// Planted faults: 7 each list's last entry is left out; 8 each kv tile is
// read from the ring stage after its own; 9 the diagonal block's element
// mask is left out.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dstt_sparse {

namespace {

using namespace dstt_hopper;
using dstt_flash::allow_smem;
using dstt_flash::kLn2;
using dstt_flash::kLog2e;
using dstt_flash::kNegInf;
using dstt_flash::quad_max;
using dstt_flash::quad_sum;

constexpr int WG = 64;        // kv rows a consumer warpgroup owns
constexpr int BM = 2 * WG;    // kv rows of a work item: one layout block
constexpr int BT = 64;        // q rows of a ring tile
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 3 * 128;   // producer + two consumer warpgroups
constexpr int STAGES = 4;
constexpr int kPlanInts = 8;        // int32 fields of a plan entry
constexpr int FWD_QBUF = 2;         // the forward's Q slots: item n in slot n % 2

template <int D>
struct Cfg {
  static constexpr int CB = D < 64 ? D : 64;        // columns of one swizzled block
  static constexpr int RB = CB * 2;                 // its row bytes
  static constexpr int NCB = D / CB;                // column blocks of a tile
  static constexpr int SWZ = RB;                    // 128-byte (64-byte at D = 32) swizzle
  static constexpr int SBO = 8 * RB;                // stride of 8-row groups
  static constexpr int ITEM_BYTES = BM * D * 2;     // K or V
  static constexpr int TILE_BYTES = BT * D * 2;     // one ring tile of Q or dO
  static constexpr int ROW_BYTES = 2 * BT * 4;      // a tile's lse and delta
  static constexpr size_t SMEM = 1024 + 2 * ITEM_BYTES + (size_t)STAGES * 2 * TILE_BYTES +
                                 8 * (2 + 2 * STAGES) + (size_t)STAGES * ROW_BYTES;
  static constexpr int PART = 2 * BM * D;           // floats of one partial (dK, dV)
  // the dQ kernel: Q + dO of the item, 4 stages of K + V tiles, the barriers
  static constexpr size_t DQ_SMEM =
      1024 + 2 * ITEM_BYTES + (size_t)STAGES * 2 * TILE_BYTES + 8 * (2 + 2 * STAGES);
  // the forward: FWD_QBUF slots of an item's Q, 4 stages of K + V tiles,
  // the barriers
  static constexpr size_t FWD_SMEM = 1024 + (size_t)FWD_QBUF * ITEM_BYTES +
                                     (size_t)STAGES * 2 * TILE_BYTES +
                                     8 * (2 * FWD_QBUF + 2 * STAGES);
};

int g_plant = 0;

struct SpArgs {
  const float* lse;     // [B * H, S], base e
  const float* delta;   // [B * H, S]
  void* dk;             // [B, S, Hkv, D] bf16
  void* dv;
  const int* idx_t;     // [S / BM, max_t] transposed lists
  const int* cnt_t;     // [S / BM]
  const int* plan;      // [n_plan, kPlanInts]
  int* counters;        // [split columns, B * Hkv, 8 warps], 0 between calls
  float* partials;      // [slots, B * Hkv, PART]
  int max_t, n_plan, B, H, Hkv, S, causal;
  float scale;
};

// A value every lane of the warp loaded alike, as lane 0's: branches on it
// are then uniform to ptxas.
__device__ __forceinline__ int uni(int v) { return __shfl_sync(0xffffffffu, v, 0); }

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a, uint64_t db) {
  wgmma_rs_n32(d, a[0], a[1], a[2], a[3], db, 1);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(d, a[0], a[1], a[2], a[3], db, 1);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(d, a[0], a[1], a[2], a[3], db, 1);
}

// acc = A B^T over D (64 x 64): A's 64 rows of an item tile at sa, B a ring
// tile at sb, both K-major.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[BT / 2], uint32_t sa, uint32_t sb) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk * 16 / C::CB, in_row = (kk * 16 % C::CB) * 2;
    wgmma_ss_n64(acc, smem_desc(sa + cb * BM * C::RB + in_row, 16, C::SBO, C::SWZ),
                 smem_desc(sb + cb * BT * C::RB + in_row, 16, C::SBO, C::SWZ), kk > 0);
  }
}

// acc += A B: A (64 x BT, bf16) in registers, k16 step kt in a[4 kt .. +3];
// B the [BT, D] ring tile at sb read MN-major.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[BT / 4],
                                         uint32_t sb) {
  using C = Cfg<D>;
#pragma unroll
  for (int kt = 0; kt < BT / 16; ++kt)
    wgmma_rs(acc, &a[4 * kt], smem_desc(sb + kt * 16 * C::RB, BT * C::RB, C::SBO, C::SWZ));
}

template <int N>
__device__ __forceinline__ void pack(uint32_t (&pa)[N / 2], const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) pa[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
}

// This thread's rows r0 and r0 + 8 of an accumulator (D / 2 registers) as
// bf16 rows of `first` (row stride `stride` elements).
template <int D>
__device__ __forceinline__ void store_acc(const float (&v)[D / 2], int t, int r0,
                                          __nv_bfloat16* first, size_t stride) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* out = first + (size_t)(r0 + 8 * r) * stride;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4)   // registers i, i + 1 of this row
      *reinterpret_cast<__nv_bfloat162*>(out + acc_col(t, i)) =
          __floats2bfloat162_rn(v[i], v[i + 1]);
  }
}

// The item a block takes in its round k: rounds of gridDim.x items, dealt
// forward in even rounds and backward in odd ones.
__device__ __forceinline__ int item_of(int k) {
  const int g = gridDim.x, c = blockIdx.x;
  return k * g + ((k & 1) ? g - 1 - c : c);
}

__host__ __device__ __forceinline__ int n_items(const SpArgs& a) { return a.n_plan * a.B * a.Hkv; }

// A work item: one plan entry (a chunk of kv block kb's pairs) at one
// (batch, kv head). Every field is warp-uniform (uni).
struct Item {
  int b, hk, kb, p0, np, chunk, chunks, slot0, ctr, cnt;
  __device__ Item(int w, const SpArgs& a) {
    const int bh = w % (a.B * a.Hkv);
    const int* e = a.plan + (size_t)(w / (a.B * a.Hkv)) * kPlanInts;
    b = bh / a.Hkv;
    hk = bh % a.Hkv;
    kb = uni(__ldg(e));
    p0 = uni(__ldg(e + 1));
    np = uni(__ldg(e + 2));
    chunk = uni(__ldg(e + 3));
    chunks = uni(__ldg(e + 4));
    slot0 = uni(__ldg(e + 5));
    ctr = uni(__ldg(e + 6));
    cnt = uni(__ldg(a.cnt_t + kb));
  }
  // pair p: query head p / cnt of the group, q block idx_t[kb][p % cnt]
  __device__ int head(int p) const { return p / cnt; }
  __device__ int qblock(const SpArgs& a, int p) const {
    return uni(__ldg(a.idx_t + (size_t)kb * a.max_t + p % cnt));
  }
  // planted fault 3: the last query head of the group is skipped
  __device__ bool skipped(const SpArgs& a, int p, int plant) const {
    return plant == 3 && head(p) == a.H / a.Hkv - 1;
  }
};

template <int D>
struct Smem {
  uint32_t k, v, ring, rows, kv_full, kv_empty, full0, empty0;
  float* rows_gen;
  __device__ explicit Smem(unsigned char* raw) {
    using C = Cfg<D>;
    k = (smem_u32(raw) + 1023u) & ~1023u;   // swizzled tiles start on 1024-byte lines
    v = k + C::ITEM_BYTES;
    ring = v + C::ITEM_BYTES;               // stage s: Q at ring + 2 s TILE_BYTES, dO after it
    rows = ring + STAGES * 2 * C::TILE_BYTES;   // stage s: lse (base 2), delta: BT each
    rows_gen = reinterpret_cast<float*>(raw + (rows - smem_u32(raw)));
    kv_full = rows + STAGES * C::ROW_BYTES;
    kv_empty = kv_full + 8;
    full0 = kv_empty + 8;
    empty0 = full0 + 8 * STAGES;
  }
  __device__ uint32_t q(int s) const { return ring + s * 2 * Cfg<D>::TILE_BYTES; }
  __device__ uint32_t dout(int s) const { return q(s) + Cfg<D>::TILE_BYTES; }
  __device__ float* lse(int s) const { return rows_gen + s * 2 * BT; }
  __device__ float* delta(int s) const { return lse(s) + BT; }
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};

// The producer warp: per item, K and V (once the consumers are done with the
// last ones; lane 0), then the two 64-row Q / dO tiles of each of the
// chunk's pairs into the ring (lane 0, TMA) with their lse and delta (every
// lane). A stage's full barrier counts the 32 lanes' arrivals and the TMA
// bytes.
template <int D>
__device__ __forceinline__ void produce(const Smem<D>& sm, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, const SpArgs& a, int plant) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31, g = a.H / a.Hkv;
  if (lane == 0) {
    tma_prefetch_map(tm_q);
    tma_prefetch_map(tm_do);
    tma_prefetch_map(tm_k);
    tma_prefetch_map(tm_v);
  }
  int it = 0;   // q tiles loaded so far
  for (int n = 0; item_of(n) < n_items(a); ++n) {
    const Item item(item_of(n), a);
    if (lane == 0) {
      if (n > 0) mbar_wait(sm.kv_empty, (n - 1) & 1);
      mbar_expect_tx(sm.kv_full, 2 * C::ITEM_BYTES);
      for (int c = 0; c < C::NCB; ++c) {
        tma_load_4d(sm.k + c * BM * C::RB, tm_k, sm.kv_full, c * C::CB, item.hk,
                    item.kb * BM, item.b);
        tma_load_4d(sm.v + c * BM * C::RB, tm_v, sm.kv_full, c * C::CB, item.hk,
                    item.kb * BM, item.b);
      }
    }
    for (int p = item.p0; p < item.p0 + item.np; ++p) {
      if (item.skipped(a, p, plant)) continue;
      const int hq = item.hk * g + item.head(p), qb = item.qblock(a, p);
      const float* lse = a.lse + ((size_t)item.b * a.H + hq) * a.S;
      const float* delta = a.delta + ((size_t)item.b * a.H + hq) * a.S;
      for (int t = 0; t < BM / BT; ++t, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(sm.empty(s), (it / STAGES - 1) & 1);
        const int i0 = qb * BM + t * BT;
        float* sl = sm.lse(s);
        float* sd = sm.delta(s);
        for (int r = lane; r < BT; r += 32) {
          sl[r] = lse[i0 + r] * kLog2e;
          sd[r] = delta[i0 + r];
        }
        if (lane == 0) {
          mbar_expect_tx(sm.full(s), 2 * C::TILE_BYTES);
          for (int c = 0; c < C::NCB; ++c) {
            tma_load_4d(sm.q(s) + c * BT * C::RB, tm_q, sm.full(s), c * C::CB, hq, i0, item.b);
            tma_load_4d(sm.dout(s) + c * BT * C::RB, tm_do, sm.full(s), c * C::CB, hq, i0,
                        item.b);
          }
        } else {
          mbar_arrive(sm.full(s));
        }
      }
    }
  }
}

// A consumer warpgroup (cw 0 or 1: kv rows kb * 128 + 64 cw ..). Per q tile:
// S^T and dP^T as two commit groups; p^T once S^T is done, then dV += P^T dO
// issued while ds^T waits for dP^T; then dK += dS^T Q, and the stage is
// released once both products are done. Then the item's epilogue: a store,
// or a partial, a ticket and (for the last chunk to finish) the merge.
template <int D>
__device__ __forceinline__ void consume(const Smem<D>& sm, const SpArgs& a, int cw, int plant) {
  using C = Cfg<D>;
  const int t = threadIdx.x % 128, lane = t & 31, wi = t >> 5;
  const uint32_t sKw = sm.k + cw * WG * C::RB;   // this warpgroup's 64 K rows
  const uint32_t sVw = sm.v + cw * WG * C::RB;   // and V rows
  const float sl2 = a.scale * kLog2e;
  const size_t BH = (size_t)a.B * a.Hkv;
  int it = 0;                                    // q tiles consumed so far

  for (int n = 0; item_of(n) < n_items(a); ++n) {
    const Item item(item_of(n), a);
    const int kr0 = item.kb * BM + cw * WG + acc_row(t, 0);   // kv rows kr0, kr0 + 8
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(sm.kv_full, n & 1);
    for (int p = item.p0; p < item.p0 + item.np; ++p) {
      if (item.skipped(a, p, plant)) continue;
      const int qb = item.qblock(a, p);
      const bool mask = a.causal && qb == item.kb;   // the diagonal block
      for (int tt = 0; tt < BM / BT; ++tt, ++it) {
        const int s = it % STAGES;
        const int i0 = qb * BM + tt * BT;
        const int sr = plant == 2 ? (it + 1) % STAGES : s;   // planted fault 2
        mbar_wait(sm.full(s), (it / STAGES) & 1);

        float st[BT / 2], dpt[BT / 2];   // [kv row][q col]
        wgmma_fence();
        issue_ss<D>(st, sKw, sm.q(sr));
        wgmma_commit();
        issue_ss<D>(dpt, sVw, sm.dout(sr));
        wgmma_commit();

        const float* lse2 = sm.lse(sr);
        const float* dlt = sm.delta(sr);
        wgmma_wait<1>();   // S^T is done
        fence_regs(st);
        if (mask) {
#pragma unroll
          for (int e = 0; e < BT / 2; ++e) {
            const int col = acc_col(t, e);
            st[e] = kr0 + 8 * ((e >> 1) & 1) <= i0 + col
                        ? exp2_ftz(fmaf(st[e], sl2, -lse2[col]))
                        : 0.f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < BT / 2; ++e) st[e] = exp2_ftz(fmaf(st[e], sl2, -lse2[acc_col(t, e)]));
        }
        uint32_t pa[BT / 4];   // p^T rounded to bf16: the A operand of dV += P^T dO
        pack<BT / 2>(pa, st);
        wgmma_fence();
        issue_rs<D>(dv, pa, sm.dout(sr));
        wgmma_commit();

        wgmma_wait<1>();   // dP^T is done; dV may still run
        fence_regs(dpt);
#pragma unroll
        for (int e = 0; e < BT / 2; ++e)
          dpt[e] = st[e] * (dpt[e] - dlt[acc_col(t, e)]) * a.scale;
        uint32_t sa[BT / 4];   // ds^T rounded to bf16: the A operand of dK += dS^T Q
        pack<BT / 2>(sa, dpt);
        wgmma_fence();
        issue_rs<D>(dk, sa, sm.q(sr));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(sa);
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty(s));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.kv_empty);   // every S^T and dP^T of this item is done

    const size_t kstride = (size_t)a.Hkv * D;   // dk, dv [B, S, Hkv, D]
    const size_t first = (size_t)item.b * a.S * kstride + (size_t)item.hk * D;
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + first;
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + first;
    if (item.chunks == 1) {
      store_acc<D>(dk, t, kr0, dkp, kstride);
      store_acc<D>(dv, t, kr0, dvp, kstride);
      continue;
    }
    // a split column: this chunk's fp32 partial, in this thread's register
    // order (float4 q of thread t at (tensor, cw, q, t)), then a ticket
    const size_t bh = (size_t)item.b * a.Hkv + item.hk;
    float4* part = reinterpret_cast<float4*>(a.partials) +
                   ((size_t)(item.slot0 + item.chunk) * BH + bh) * (C::PART / 4);
#pragma unroll
    for (int q = 0; q < D / 8; ++q) {
      part[((0 * 2 + cw) * (D / 8) + q) * 128 + t] =
          make_float4(dk[4 * q], dk[4 * q + 1], dk[4 * q + 2], dk[4 * q + 3]);
      part[((1 * 2 + cw) * (D / 8) + q) * 128 + t] =
          make_float4(dv[4 * q], dv[4 * q + 1], dv[4 * q + 2], dv[4 * q + 3]);
    }
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      int* ctr = a.counters + ((size_t)item.ctr * BH + bh) * kConsumerWarps + cw * 4 + wi;
      last = atomicAdd(ctr, 1) == item.chunks - 1;
      if (last) *ctr = 0;   // every chunk has arrived: ready for the next call
    }
    last = uni(last);
    if (!last) continue;
    __threadfence();
    // the last chunk to arrive sums the column's partials in chunk order
    const int nuse = plant == 1 ? item.chunks - 1 : item.chunks;   // planted fault 1
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int c = 0; c < nuse; ++c) {
      const float4* src = reinterpret_cast<const float4*>(a.partials) +
                          ((size_t)(item.slot0 + c) * BH + bh) * (C::PART / 4);
#pragma unroll
      for (int q = 0; q < D / 8; ++q) {
        const float4 x = __ldcg(src + ((0 * 2 + cw) * (D / 8) + q) * 128 + t);
        const float4 y = __ldcg(src + ((1 * 2 + cw) * (D / 8) + q) * 128 + t);
        dk[4 * q] += x.x;
        dk[4 * q + 1] += x.y;
        dk[4 * q + 2] += x.z;
        dk[4 * q + 3] += x.w;
        dv[4 * q] += y.x;
        dv[4 * q + 1] += y.y;
        dv[4 * q + 2] += y.z;
        dv[4 * q + 3] += y.w;
      }
    }
    store_acc<D>(dk, t, kr0, dkp, kstride);
    store_acc<D>(dv, t, kr0, dvp, kstride);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const SpArgs a,
                           const int plant) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full, 1);
    mbar_init(sm.kv_empty, kConsumerWarps);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 32);   // the producer warp's lanes; lane 0's also brings the bytes
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    setmaxnreg_inc<240>();
    // the warpgroup index broadcast from lane 0: branches on it are then
    // uniform to ptxas, which keeps the wgmma after them asynchronous
    const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
    consume<D>(sm, a, cw, plant);
  } else {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) produce<D>(sm, &tm_q, &tm_do, &tm_k, &tm_v, a, plant);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const SpArgs& a, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = bhsd_map(&tq, q, a.B, a.S, a.H, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tdo, dout, a.B, a.S, a.H, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tk, k, a.B, a.S, a.Hkv, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tv, v, a.B, a.S, a.Hkv, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = allow_smem(sparse_dkv_sm90_kernel<D>, C::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int items = n_items(a);
  sparse_dkv_sm90_kernel<D><<<items < sms ? items : sms, kThreads, C::SMEM, stream>>>(
      tq, tdo, tk, tv, a, g_plant);
  return cudaGetLastError();
}


// ------------------------------------------------------------------- dQ --
struct DqArgs {
  const float* lse;     // [B * H, S], base e
  const float* delta;   // [B * H, S]
  void* dq;             // [B, S, H, D] bf16
  const int* idx;       // [S / BM, max_a] compacted lists
  const int* cnt;       // [S / BM]
  const int* order;     // [S / BM] q blocks, longest list first
  int max_a, B, H, Hkv, S, causal;
  float scale;
};

__host__ __device__ __forceinline__ int dq_items(const DqArgs& a) {
  return a.S / BM * a.B * a.H;
}

// A dQ item: the 128 q rows of layout block qb at one (batch, head), over
// the n kv blocks of qb's list (planted fault 4: its last entry left out),
// two 64-row K / V tiles each. Items run through `order` (longest list
// first), all heads of a q block together. Every field is warp-uniform.
struct DqItem {
  int b, h, qb, n;
  __device__ DqItem(int w, const DqArgs& a, int plant) {
    const int bh = w % (a.B * a.H);
    b = bh / a.H;
    h = bh % a.H;
    qb = uni(__ldg(a.order + w / (a.B * a.H)));
    n = uni(__ldg(a.cnt + qb)) - (plant == 4 ? 1 : 0);   // planted fault 4
  }
  __device__ int kblock(const DqArgs& a, int j) const {
    return uni(__ldg(a.idx + (size_t)qb * a.max_a + j));
  }
};

// Shared-memory addresses of the dQ kernel's tiles and barriers.
template <int D>
struct DqSmem {
  uint32_t q, dout, ring, q_full, q_empty, full0, empty0;
  __device__ explicit DqSmem(const void* raw) {
    using C = Cfg<D>;
    q = (smem_u32(raw) + 1023u) & ~1023u;   // swizzled tiles start on 1024-byte lines
    dout = q + C::ITEM_BYTES;
    ring = dout + C::ITEM_BYTES;            // stage s: K at ring + 2 s TILE_BYTES, V after it
    q_full = ring + STAGES * 2 * C::TILE_BYTES;
    q_empty = q_full + 8;
    full0 = q_empty + 8;
    empty0 = full0 + 8 * STAGES;
  }
  __device__ uint32_t k(int s) const { return ring + s * 2 * Cfg<D>::TILE_BYTES; }
  __device__ uint32_t v(int s) const { return k(s) + Cfg<D>::TILE_BYTES; }
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};

// The producer warp (lane 0 issues; every lane reads the lists, so their
// values are warp-uniform): per item, Q and dO once the consumers are done
// with the last ones, then the two 64-row K / V tiles of each listed kv
// block into the ring, whose stage and phase run on across items. GQA: K /
// V of kv head h / g, read in place.
template <int D>
__device__ __forceinline__ void dq_produce(const DqSmem<D>& sm, const CUtensorMap* tm_q,
                                           const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, const DqArgs& a, int plant) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    tma_prefetch_map(tm_q);
    tma_prefetch_map(tm_do);
    tma_prefetch_map(tm_k);
    tma_prefetch_map(tm_v);
  }
  int it = 0;   // kv tiles loaded so far
  for (int n = 0; item_of(n) < dq_items(a); ++n) {
    const DqItem item(item_of(n), a, plant);
    const int hk = item.h / (a.H / a.Hkv);
    if (lane == 0) {
      if (n > 0) mbar_wait(sm.q_empty, (n - 1) & 1);
      mbar_expect_tx(sm.q_full, 2 * C::ITEM_BYTES);
      for (int c = 0; c < C::NCB; ++c) {
        tma_load_4d(sm.q + c * BM * C::RB, tm_q, sm.q_full, c * C::CB, item.h, item.qb * BM,
                    item.b);
        tma_load_4d(sm.dout + c * BM * C::RB, tm_do, sm.q_full, c * C::CB, item.h,
                    item.qb * BM, item.b);
      }
    }
    for (int j = 0; j < item.n; ++j) {
      const int kb = item.kblock(a, j);
      for (int t = 0; t < BM / BT; ++t, ++it) {
        if (lane != 0) continue;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(sm.empty(s), (it / STAGES - 1) & 1);
        mbar_expect_tx(sm.full(s), 2 * C::TILE_BYTES);
        for (int c = 0; c < C::NCB; ++c) {
          tma_load_4d(sm.k(s) + c * BT * C::RB, tm_k, sm.full(s), c * C::CB, hk,
                      kb * BM + t * BT, item.b);
          tma_load_4d(sm.v(s) + c * BT * C::RB, tm_v, sm.full(s), c * C::CB, hk,
                      kb * BM + t * BT, item.b);
        }
      }
    }
  }
}

// A dQ consumer warpgroup (cw 0 or 1: q rows qb * 128 + 64 cw ..). Per kv
// tile it issues S, dP and dQ += dS K of the previous tile as three commit
// groups, computes p from S while dP and that dQ product run, then ds; the
// previous tile's stage is released once its dQ product is done. On a
// causal layout's diagonal block the consumer's tile t = cw takes the
// element mask (planted fault 6: left out), t < cw none, and t > cw (every
// score above the diagonal) is skipped: its stage is waited for and
// released, no product issued. The epilogue stores dQ from registers.
template <int D>
__device__ __forceinline__ void dq_consume(const DqSmem<D>& sm, const DqArgs& a, int cw,
                                           int plant) {
  using C = Cfg<D>;
  const int t = threadIdx.x % 128, lane = t & 31;
  const uint32_t sQw = sm.q + cw * WG * C::RB;      // this warpgroup's 64 Q rows
  const uint32_t sdOw = sm.dout + cw * WG * C::RB;  // and dO rows
  const float sl2 = a.scale * kLog2e;
  int it = 0;                                       // kv tiles consumed so far

  for (int n = 0; item_of(n) < dq_items(a); ++n) {
    const DqItem item(item_of(n), a, plant);
    const int lr0 = cw * WG + acc_row(t, 0);        // this thread's rows in the block
    const int r0 = item.qb * BM + lr0;              // and in the sequence: r0, r0 + 8
    const size_t bh = (size_t)item.b * a.H + item.h;
    float lse2[2], dlt[2];                          // lse in base 2, delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = a.lse[bh * a.S + r0 + 8 * r] * kLog2e;
      dlt[r] = a.delta[bh * a.S + r0 + 8 * r];
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    uint32_t da[BT / 4];   // dS of the previous tile as bf16, the A operand
    int prev = 0, prev_read = 0, done = 0;   // its stage, the one its K is read from; tiles done

    mbar_wait(sm.q_full, n & 1);
    for (int j = 0; j < item.n; ++j) {
      const bool diag = a.causal && item.kblock(a, j) == item.qb;
      for (int tt = 0; tt < BM / BT; ++tt, ++it) {
        const int s = it % STAGES;
        const int sr = plant == 5 ? (it + 1) % STAGES : s;   // planted fault 5
        mbar_wait(sm.full(s), (it / STAGES) & 1);
        if (diag && tt > cw) {   // above the diagonal: no score visible
          __syncwarp();
          if (lane == 0) mbar_arrive(sm.empty(s));
          continue;
        }
        const bool mask = diag && tt == cw && plant != 6;   // planted fault 6

        float sacc[BT / 2], dpacc[BT / 2];
        wgmma_fence();
        issue_ss<D>(sacc, sQw, sm.k(sr));
        wgmma_commit();
        issue_ss<D>(dpacc, sdOw, sm.v(sr));
        wgmma_commit();
        if (done > 0) issue_rs<D>(dq, da, sm.k(prev_read));
        wgmma_commit();

        wgmma_wait<2>();   // S is done
        fence_regs(sacc);
        if (mask) {        // local kv column <= local q row (tile t = cw)
#pragma unroll
          for (int e = 0; e < BT / 2; ++e) {
            const int r = (e >> 1) & 1;
            sacc[e] = cw * WG + acc_col(t, e) <= lr0 + 8 * r
                          ? exp2_ftz(fmaf(sacc[e], sl2, -lse2[r]))
                          : 0.f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < BT / 2; ++e)
            sacc[e] = exp2_ftz(fmaf(sacc[e], sl2, -lse2[(e >> 1) & 1]));
        }
        wgmma_wait<1>();   // dP is done
        fence_regs(dpacc);
#pragma unroll
        for (int e = 0; e < BT / 2; ++e)
          dpacc[e] = sacc[e] * (dpacc[e] - dlt[(e >> 1) & 1]) * a.scale;
        wgmma_wait<0>();   // the previous tile's dQ product is done: its stage and da are free
        fence_regs(dq);
        fence_regs(da);
        __syncwarp();
        if (done > 0 && lane == 0) mbar_arrive(sm.empty(prev));
        pack<BT / 2>(da, dpacc);   // ds rounded to bf16, as on the TPU
        prev = s;
        prev_read = sr;
        ++done;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.q_empty);   // every S and dP of this item has read Q, dO
    if (done > 0) {
      wgmma_fence();
      issue_rs<D>(dq, da, sm.k(prev_read));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(prev));
    }
    const size_t qstride = (size_t)a.H * D;   // dq [B, S, H, D]
    store_acc<D>(dq, t, r0,
                 static_cast<__nv_bfloat16*>(a.dq) + (size_t)item.b * a.S * qstride +
                     (size_t)item.h * D,
                 qstride);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const DqArgs a,
                          const int plant) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const DqSmem<D> sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    mbar_init(sm.q_empty, kConsumerWarps);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    setmaxnreg_inc<240>();
    // the warpgroup index broadcast from lane 0: branches on it are then
    // uniform to ptxas, which keeps the wgmma after them asynchronous
    const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
    dq_consume<D>(sm, a, cw, plant);
  } else {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) dq_produce<D>(sm, &tm_q, &tm_do, &tm_k, &tm_v, a, plant);
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const DqArgs& a, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = bhsd_map(&tq, q, a.B, a.S, a.H, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tdo, dout, a.B, a.S, a.H, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tk, k, a.B, a.S, a.Hkv, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tv, v, a.B, a.S, a.Hkv, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = allow_smem(sparse_dq_sm90_kernel<D>, C::DQ_SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int items = dq_items(a);
  sparse_dq_sm90_kernel<D><<<items < sms ? items : sms, kThreads, C::DQ_SMEM, stream>>>(
      tq, tdo, tk, tv, a, g_plant);
  return cudaGetLastError();
}


// -------------------------------------------------------------- forward --
struct FwdArgs {
  void* o;              // [B, S, H, D] bf16
  float* lse;           // [B * H, S], base e
  const int* idx;       // [S / BM, max_a] compacted lists
  const int* cnt;       // [S / BM]
  const int* order;     // [S / BM] q blocks, longest list first
  int max_a, B, H, Hkv, S, causal;
  float scale;
};

__host__ __device__ __forceinline__ int fwd_items(const FwdArgs& a) {
  return a.S / BM * a.B * a.H;
}

// A forward item: the 128 q rows of layout block qb at one (batch, head),
// over the n kv blocks of qb's list (planted fault 7: its last entry left
// out), two 64-row K / V tiles each; items in `order`, all heads of a q
// block together. Every field is warp-uniform.
struct FwdItem {
  int b, h, qb, n;
  __device__ FwdItem(int w, const FwdArgs& a, int plant) {
    const int bh = w % (a.B * a.H);
    b = bh / a.H;
    h = bh % a.H;
    qb = uni(__ldg(a.order + w / (a.B * a.H)));
    n = uni(__ldg(a.cnt + qb)) - (plant == 7 ? 1 : 0);   // planted fault 7
  }
  __device__ int kblock(const FwdArgs& a, int j) const {
    return uni(__ldg(a.idx + (size_t)qb * a.max_a + j));
  }
};

// Shared-memory addresses of the forward's tiles and barriers: FWD_QBUF
// slots of Q (item n in slot n % FWD_QBUF, so the next item's Q and first
// tiles load while this item's last tiles and epilogue run), then the ring.
template <int D>
struct FwdSmem {
  uint32_t q0, ring, q_full0, q_empty0, full0, empty0;
  __device__ explicit FwdSmem(const void* raw) {
    using C = Cfg<D>;
    q0 = (smem_u32(raw) + 1023u) & ~1023u;   // swizzled tiles start on 1024-byte lines
    ring = q0 + FWD_QBUF * C::ITEM_BYTES;    // stage s: K at ring + 2 s TILE_BYTES, V after it
    q_full0 = ring + STAGES * 2 * C::TILE_BYTES;
    q_empty0 = q_full0 + 8 * FWD_QBUF;
    full0 = q_empty0 + 8 * FWD_QBUF;
    empty0 = full0 + 8 * STAGES;
  }
  __device__ uint32_t q(int n) const { return q0 + n % FWD_QBUF * Cfg<D>::ITEM_BYTES; }
  __device__ uint32_t q_full(int n) const { return q_full0 + 8 * (n % FWD_QBUF); }
  __device__ uint32_t q_empty(int n) const { return q_empty0 + 8 * (n % FWD_QBUF); }
  __device__ uint32_t k(int s) const { return ring + s * 2 * Cfg<D>::TILE_BYTES; }
  __device__ uint32_t v(int s) const { return k(s) + Cfg<D>::TILE_BYTES; }
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};

// This thread's A fragments of its warpgroup's 64 Q rows (one k16 step in
// qa[4 kk .. +3], the m16n8k16 A fragment of the warp's 16 rows) by
// ldmatrix from the swizzled Q tile at sq (TMA's layout: the 16-byte chunk c
// of row r at c ^ (r % 8), 64-byte rows at D = 32: c ^ (r / 2 % 4)).
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 4], uint32_t sq, int cw) {
  using C = Cfg<D>;
  const int t = threadIdx.x % 128, lane = t & 31;
  const int row = cw * WG + 16 * (t >> 5) + (lane & 15);   // row of the item tile
  const int swz = C::RB == 128 ? row % 8 : row / 2 % 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = (kk * 16 % C::CB) / 8 + (lane >> 4);
    const uint32_t addr = sq + (kk * 16 / C::CB) * BM * C::RB + row * C::RB + ((chunk ^ swz) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(qa[4 * kk]), "=r"(qa[4 * kk + 1]), "=r"(qa[4 * kk + 2]),
                   "=r"(qa[4 * kk + 3])
                 : "r"(addr));
  }
}

// d[32] (+)= A (registers, 4 x bf16x2 a thread) * B (smem, K-major): m64n64k16;
// acc 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32], const uint32_t* a,
                                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// S = Q K^T over D (64 x 64): Q's fragments in registers, K the ring tile at
// sk (K-major).
template <int D>
__device__ __forceinline__ void issue_qk(float (&acc)[BT / 2], const uint32_t (&qa)[D / 4],
                                         uint32_t sk) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk * 16 / C::CB, in_row = (kk * 16 % C::CB) * 2;
    wgmma_rs_n64_kmajor(acc, &qa[4 * kk],
                        smem_desc(sk + cb * BT * C::RB + in_row, 16, C::SBO, C::SWZ), kk > 0);
  }
}

// The forward's producer warp (lane 0 issues; every lane reads the lists):
// per item, Q once the consumers are done with the last one, then the two
// 64-row K / V tiles of each listed kv block into the ring. GQA: K / V of kv
// head h / g, read in place.
template <int D>
__device__ __forceinline__ void fwd_produce(const FwdSmem<D>& sm, const CUtensorMap* tm_q,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const FwdArgs& a, int plant) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    tma_prefetch_map(tm_q);
    tma_prefetch_map(tm_k);
    tma_prefetch_map(tm_v);
  }
  int it = 0;   // kv tiles loaded so far
  for (int n = 0; item_of(n) < fwd_items(a); ++n) {
    const FwdItem item(item_of(n), a, plant);
    const int hk = item.h / (a.H / a.Hkv);
    if (lane == 0) {
      // the slot's last item (n - FWD_QBUF) is done with it
      if (n >= FWD_QBUF) mbar_wait(sm.q_empty(n), (n / FWD_QBUF - 1) & 1);
      mbar_expect_tx(sm.q_full(n), C::ITEM_BYTES);
      for (int c = 0; c < C::NCB; ++c)
        tma_load_4d(sm.q(n) + c * BM * C::RB, tm_q, sm.q_full(n), c * C::CB, item.h,
                    item.qb * BM, item.b);
    }
    for (int j = 0; j < item.n; ++j) {
      const int kb = item.kblock(a, j);
      for (int t = 0; t < BM / BT; ++t, ++it) {
        if (lane != 0) continue;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(sm.empty(s), (it / STAGES - 1) & 1);
        mbar_expect_tx(sm.full(s), 2 * C::TILE_BYTES);
        for (int c = 0; c < C::NCB; ++c) {
          tma_load_4d(sm.k(s) + c * BT * C::RB, tm_k, sm.full(s), c * C::CB, hk,
                      kb * BM + t * BT, item.b);
          tma_load_4d(sm.v(s) + c * BT * C::RB, tm_v, sm.full(s), c * C::CB, hk,
                      kb * BM + t * BT, item.b);
        }
      }
    }
  }
}

// One kv tile's scores (this thread's 2 rows x 64 columns) through the
// mask, the scale and the online softmax, in base-2 units: s becomes p, m
// and l move on, alpha is the factor the accumulator must take. l is this
// thread's share of each row's sum (the quad sums it once, in the
// epilogue). MASK: the diagonal tile of a causal layout's diagonal block,
// local column <= local row.
template <bool MASK>
__device__ __forceinline__ void fwd_softmax(float (&s)[BT / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], float sl2, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (!MASK && sl2 > 0.f) {
    // no mask: the row max of s, scaled once, and p = 2^(s sl2 - m) as one
    // FFMA and one exp2 per score (flash_fwd_sm90.cu's no-mask path)
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
      alpha[r] = mn == -INFINITY ? 1.f : exp2f(m[r] - mn);
      m[r] = mn;
      mu[r] = mn == -INFINITY ? 0.f : mn;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) {
      s[e] = exp2_ftz(fmaf(s[e], sl2, -mu[(e >> 1) & 1]));
      ls[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
    return;
  }
#pragma unroll
  for (int e = 0; e < BT / 2; ++e) {
    const float x = MASK && acc_col(t, e) > acc_row(t, e) ? -INFINITY : s[e] * sl2;
    s[e] = x;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
  float mu[2];   // the max subtracted: 0 for a row that has seen no key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = mn == -INFINITY ? 1.f : exp2f(m[r] - mn);
    m[r] = mn;
    mu[r] = mn == -INFINITY ? 0.f : mn;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BT / 2; ++e) {
    const float p = exp2_ftz(s[e] - mu[(e >> 1) & 1]);
    s[e] = p;
    ls[(e >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

// A forward consumer warpgroup (cw 0 or 1: q rows qb * 128 + 64 cw ..). Per
// item it takes its Q rows into registers and frees the Q slot. Per kv
// tile, in its turn on the tensor cores, it issues S = Q K^T and O += P V
// of the previous tile as two commit groups and hands the turn to the other
// warpgroup; then it runs the softmax of S while that product may still
// run, rescales O once it is done and releases the previous tile's stage.
// So one warpgroup's products overlap the other's softmax (the turns are
// named barriers 1 and 2, as in flash_fwd_sm90.cu). On a causal layout's
// diagonal block the consumer's tile t = cw takes the element mask (planted
// fault 9: left out), t < cw none, and t > cw is skipped: its stage waited
// for and released, its turn passed on without a product, so both
// warpgroups take 2 n turns an item and the turns alternate across items
// (the next item's Q may already sit in the other slot). The epilogue
// writes o = O / l and lse = m ln 2 + log l from registers.
template <int D>
__device__ __forceinline__ void fwd_consume(const FwdSmem<D>& sm, const FwdArgs& a, int cw,
                                            int plant) {
  using C = Cfg<D>;
  constexpr int kTurn = 1;   // named barriers kTurn + cw
  const int t = threadIdx.x % 128, lane = t & 31;
  const float sl2 = a.scale * kLog2e;
  int it = 0;                                    // kv tiles consumed so far

  // The turns run on across items (both warpgroups take 2 n of them an
  // item): warpgroup 0 takes the first, and the last hand-over of warpgroup
  // 1, which has no turn after it, after the last item.
  if (cw == 1) named_bar_arrive(kTurn, 256);
  for (int n = 0; item_of(n) < fwd_items(a); ++n) {
    const FwdItem item(item_of(n), a, plant);
    const int r0 = item.qb * BM + cw * WG + acc_row(t, 0);   // this thread's rows r0, r0 + 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t pa[BT / 4];   // P of the previous tile as bf16, the A operand of O += P V
    int prev = 0, prev_read = 0, done = 0;   // its stage, the one its V is read from; tiles done

    mbar_wait(sm.q_full(n), (n / FWD_QBUF) & 1);
    uint32_t qa[D / 4];   // this warpgroup's 64 Q rows as the A operand of S = Q K^T
    load_q_frags<D>(qa, sm.q(n), cw);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.q_empty(n));   // Q is in registers: its slot is free
    for (int j = 0; j < item.n; ++j) {
      const bool diag = a.causal && item.kblock(a, j) == item.qb;
      for (int tt = 0; tt < BM / BT; ++tt, ++it) {
        const int s = it % STAGES;
        const int sr = plant == 8 ? (it + 1) % STAGES : s;   // planted fault 8
        mbar_wait(sm.full(s), (it / STAGES) & 1);
        named_bar_sync(kTurn + cw, 256);
        if (diag && tt > cw) {   // above the diagonal: no score visible
          named_bar_arrive(kTurn + 1 - cw, 256);
          __syncwarp();
          if (lane == 0) mbar_arrive(sm.empty(s));
          continue;
        }
        const bool mask = diag && tt == cw && plant != 9;   // planted fault 9

        float sacc[BT / 2];
        wgmma_fence();
        issue_qk<D>(sacc, qa, sm.k(sr));
        wgmma_commit();
        if (done > 0) issue_rs<D>(o, pa, sm.v(prev_read));
        wgmma_commit();
        named_bar_arrive(kTurn + 1 - cw, 256);

        float alpha[2];
        wgmma_wait<1>();   // S is done; the previous P V may still run
        fence_regs(sacc);
        if (mask)
          fwd_softmax<true>(sacc, m, l, alpha, sl2, t);
        else
          fwd_softmax<false>(sacc, m, l, alpha, sl2, t);
        wgmma_wait<0>();   // the previous P V is done: its stage and pa are free
        fence_regs(o);
        fence_regs(pa);
        __syncwarp();
        if (done > 0 && lane == 0) mbar_arrive(sm.empty(prev));
        // once a row's max stops moving its alpha is exactly 1: skip the rescale
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        pack<BT / 2>(pa, sacc);   // p rounded to bf16, as on the TPU
        prev = s;
        prev_read = sr;
        ++done;
      }
    }
    if (done > 0) {
      wgmma_fence();
      issue_rs<D>(o, pa, sm.v(prev_read));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(prev));
    }
    const size_t bh = (size_t)item.b * a.H + item.h;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      inv[r] = 1.f / l_safe;
      if ((t & 3) == 0)
        a.lse[bh * a.S + r0 + 8 * r] = (m[r] == -INFINITY ? kNegInf : m[r] * kLn2) + logf(l_safe);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= inv[(i >> 1) & 1];
    const size_t qstride = (size_t)a.H * D;   // o [B, S, H, D]
    store_acc<D>(o, t, r0,
                 static_cast<__nv_bfloat16*>(a.o) + (size_t)item.b * a.S * qstride +
                     (size_t)item.h * D,
                 qstride);
  }
  if (cw == 0) named_bar_sync(kTurn, 256);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const FwdArgs a,
                           const int plant) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const FwdSmem<D> sm(smem_raw);
  if (threadIdx.x == 0) {
    for (int n = 0; n < FWD_QBUF; ++n) {
      mbar_init(sm.q_full(n), 1);
      mbar_init(sm.q_empty(n), kConsumerWarps);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    setmaxnreg_inc<240>();
    // the warpgroup index broadcast from lane 0: branches on it are then
    // uniform to ptxas, which keeps the wgmma after them asynchronous
    const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
    fwd_consume<D>(sm, a, cw, plant);
  } else {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) fwd_produce<D>(sm, &tm_q, &tm_k, &tm_v, a, plant);
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const FwdArgs& a,
                       cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = bhsd_map(&tq, q, a.B, a.S, a.H, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tk, k, a.B, a.S, a.Hkv, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tv, v, a.B, a.S, a.Hkv, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = allow_smem(sparse_fwd_sm90_kernel<D>, C::FWD_SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int items = fwd_items(a);
  sparse_fwd_sm90_kernel<D><<<items < sms ? items : sms, kThreads, C::FWD_SMEM, stream>>>(
      tq, tk, tv, a, g_plant);
  return cudaGetLastError();
}

}  // namespace

}  // namespace dstt_sparse

// dk, dv [B, S, Hkv, D] bf16 (narrow) from q, dout [B, S, H, D], k, v [B, S,
// Hkv, D] (bf16, dense, 16-byte aligned), lse and delta [B * H, S] fp32 (lse
// in base e), over the transposed lists idx_t [S / 128, max_t], cnt_t
// [S / 128] (layout block 128) and the plan [n_plan, 8] int32 of
// ops/sparse_attention.py `dkv_split_plan`; counters (int32, zero, one per
// split column x B * Hkv x 8) and partials (fp32, the plan's slots x B * Hkv
// x 2 * 128 * D) are the wrapper's cached scratch. D: 32, 64 or 128.
extern "C" int dstt_sparse_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dk, void* dv, const int* idx_t, const int* cnt_t,
                                        const int* plan, int* counters, float* partials,
                                        int max_t, int n_plan, int B, int H, int Hkv, int S,
                                        int D, int causal, float scale, void* stream) {
  using namespace dstt_sparse;
  if (B == 0 || S == 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || S % BM != 0 || max_t <= 0 || n_plan <= 0 ||
      (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16)
    return (int)cudaErrorMisalignedAddress;
  SpArgs a{};
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.idx_t = idx_t;
  a.cnt_t = cnt_t;
  a.plan = plan;
  a.counters = counters;
  a.partials = partials;
  a.max_t = max_t;
  a.n_plan = n_plan;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.causal = causal;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch<128>(q, k, v, dout, a, s);
  if (D == 64) return (int)launch<64>(q, k, v, dout, a, s);
  return (int)launch<32>(q, k, v, dout, a, s);
}

// bf16 dq [B, S, H, D] from q, dout [B, S, H, D], k, v [B, S, Hkv, D]
// (bf16, dense, 16-byte aligned), lse and delta [B * H, S] fp32 (lse in base
// e), over the compacted lists idx [S / 128, max_a], cnt [S / 128] (layout
// block 128; every count >= 1) and order [S / 128], the q blocks longest
// list first (ops/sparse_attention.py `dq_item_order`). D: 32, 64 or 128.
extern "C" int dstt_sparse_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dq, const int* idx, const int* cnt,
                                       const int* order, int max_a, int B, int H, int Hkv,
                                       int S, int D, int causal, float scale, void* stream) {
  using namespace dstt_sparse;
  if (B == 0 || S == 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || S % BM != 0 || max_a <= 0 ||
      (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16)
    return (int)cudaErrorMisalignedAddress;
  DqArgs a{};
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.idx = idx;
  a.cnt = cnt;
  a.order = order;
  a.max_a = max_a;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.causal = causal;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_dq<128>(q, k, v, dout, a, s);
  if (D == 64) return (int)launch_dq<64>(q, k, v, dout, a, s);
  return (int)launch_dq<32>(q, k, v, dout, a, s);
}

// bf16 o [B, S, H, D] and fp32 lse [B * H, S] (base e) from q [B, S, H, D],
// k, v [B, S, Hkv, D] (bf16, dense, 16-byte aligned) over the compacted
// lists idx [S / 128, max_a], cnt [S / 128] (layout block 128; every count
// >= 1) and order [S / 128], the q blocks longest list first
// (ops/sparse_attention.py `dq_item_order`). D: 32, 64 or 128.
extern "C" int dstt_sparse_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                    float* lse, const int* idx, const int* cnt, const int* order,
                                    int max_a, int B, int H, int Hkv, int S, int D, int causal,
                                    float scale, void* stream) {
  using namespace dstt_sparse;
  if (B == 0 || S == 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || S % BM != 0 || max_a <= 0 ||
      (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  FwdArgs a{};
  a.o = o;
  a.lse = lse;
  a.idx = idx;
  a.cnt = cnt;
  a.order = order;
  a.max_a = max_a;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.causal = causal;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_fwd<128>(q, k, v, a, s);
  if (D == 64) return (int)launch_fwd<64>(q, k, v, a, s);
  return (int)launch_fwd<32>(q, k, v, a, s);
}

// Plants a fault in the kernels' next launches (tests only). dK/dV: 1 the
// merge drops the last chunk's partial, 2 each tile is read from the ring
// stage after its own, 3 the last query head of each GQA group is skipped.
// dQ: 4 each list's last entry is left out, 5 each tile is read from the
// ring stage after its own, 6 the diagonal block's mask is left out.
// Forward: 7 each list's last entry is left out, 8 each kv tile is read
// from the ring stage after its own, 9 the diagonal block's mask is left
// out. 0 none.
extern "C" int dstt_sparse_sm90_plant(int fault) {
  dstt_sparse::g_plant = fault;
  return 0;
}
