// Flash-attention backward for Hopper (sm_90a), bf16, hd 32 / 64 / 128, with
// and without a bias: dQ (and dbias) and dK/dV on TMA loads into an mbarrier
// ring, wgmma products, warp specialisation. fp32 stays on flash_bwd.cu.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py `_bwd_dq_kernel`
// (:448, pallas_call at :657) and `_bwd_dkv_kernel` (:523, pallas_call at
// :706), driven by `_flash_bwd` (:592), and their bias mode (`has_bias`,
// driven by `_flash_b` :787). The same functions as flash_bwd.cu: p is
// recomputed from the forward's saved lse, p = exp(scale * q k^T - lse) (0
// where masked; lse in base 2 here), dp = dO v^T, ds = p * (dp - delta) *
// scale rounded to bf16, with delta = rowsum(dO * O) computed by the caller;
// dq = ds k, dv = p^T dO (p rounded to bf16), dk = ds^T q. Accumulation in
// fp32, one cast at the end. Masks: causal with q_offset, a static causal
// window, the q and kv tails. A row that sees no key (lse = -1e30) has every
// score masked, so its p and its grads are 0. Under GQA, K / V are read in
// place and each kv head's dK / dV sums its g query heads in registers:
// NARROW, deterministic, no atomics and no widen-then-sum.
//
// Bias mode (BIAS): the additive bias (bf16 or fp32) joins the recomputed
// logits as in the forward's bias mode (:481-482, :557-558), in natural
// units with the lse the bias-mode forward writes: p = 2^((scale * s + bias
// - lse) log2 e), so a query whose every key carries -1e30 gets p = 1 on
// each key and grads n times the softmax's, as in JAX (:484-489). The bias
// is read in place through its four strides (flash_common.cuh), any of them
// 0, as a kernel parameter of its own (never in Args: flash_common.cuh).
// - dQ reads the 32 values of a thread's 2 rows x 16 column pairs of the
//   next kv tile while this tile's dP and dQ products run: as 8-byte (fp32)
//   or 4-byte (bf16) pairs where the kv stride is 1, one 32-byte sector per
//   4 lanes of a row; per visible score (-inf elsewhere, so p = 0 with no
//   mask pass) on tiles that the causal band or a tail crosses. Given a
//   dbias pointer it stores dbias = p (dp - delta), unscaled, in fp32 from
//   the accumulator's registers (:492-494), rows past Sq and columns past
//   Skv not written, and zeros over the kv tiles its band skips (:507-512),
//   so dbias is written once, with no memset.
// - dK/dV holds S^T (kv rows x q columns): a thread's pairs run along q, so
//   it reads single values, 8 lanes on 8 consecutive kv rows of one q column
//   (a whole 32-byte sector). A bias whose q stride is 0 (ALiBi) is one
//   value per (head, kv row): two registers, read once per query head. Any
//   other bias is read a tile ahead at D <= 64; at D = 128 (dK, dV, S^T,
//   dP^T and their packed operands hold ~224 registers) per score as p is
//   computed.
//
// Bound on an H100 SXM. Without a bias, operations: at Llama-3-8B's training
// shape (B = 1, S = 4096 causal, 32 / 8 heads, hd 128) dQ does three products
// over the 268.5 M visible (q, k) pairs (S, dP, dQ: 206.2 GFLOP, 208.5 us at
// 989 TFLOP/s) and dK/dV four (S^T, dP^T, dV, dK: 274.9 GFLOP, 278.0 us),
// against ~60 / ~70 MB of inputs and outputs (~20 us of HBM time). At
// BLOOM-7b1's bias shape (2 x 2048 causal, 32 heads, hd 128, ALiBi [32, 1,
// S] fp32) likewise: 104.3 / 139.0 us of operations. At AlphaFold's MSA row
// shape (512 rows x 256 residues, 8 heads of 32, a summed fp32 bias [512,
// 8, 256, 256] of 1.07 GB) bytes: dQ reads the bias and writes dbias (2.49
// GB in all, 743.7 us at 3.35 TB/s), dK/dV reads the bias again (443.2 us).
// So, as in the forward (flash_fwd_sm90.cu), TMA moves q, k, v and dO,
// every product is a wgmma, P and dS never leave registers, and the bias
// moves through registers, read once and loaded ahead of its use.
//
// Design: a persistent grid (one block of 3 warpgroups per SM walking work
// items, dealt forward and backward in turn, longest first). Warpgroup 0,
// the producer, gives its registers away (setmaxnreg) and issues the loads;
// warpgroups 1 and 2, the consumers, own 64 rows of each item.
// - dQ. An item is 128 q rows of one (batch, head). Q and dO are loaded once
//   (released after the item's last S and dP, so the next item's loads run
//   under this one's last dQ product); K and V tiles of BT = 64 rows stream
//   through the ring over the kv tiles the causal band or window can see.
//   Per kv tile and consumer: S = Q K^T and dP = dO V^T, each D / 16 wgmma
//   m64n64k16 from shared memory; then dQ += dS K of the previous tile (K
//   read MN-major, dS packed to bf16 in registers as the A operand) runs on
//   the tensor cores while p and ds of this tile are computed on the
//   accumulators (the element mask only on tiles that cross the diagonal,
//   the window edge or a tail). lse and delta of the thread's two rows sit
//   in registers for the item. The epilogue stores dQ from registers, rows
//   past Sq not written.
// - dK/dV. An item is 128 kv rows of one (batch, kv head). K and V are
//   loaded once; for each of the group's g query heads, Q and dO tiles of 64
//   rows stream through the ring over the q tiles that can see these kv
//   rows, with the tile's lse and delta staged beside them by the producer
//   warp's ordinary loads (TMA's 16-byte stride rule fails on [B * H, Sq]
//   fp32 when Sq % 4 != 0). Per q tile and consumer: S^T = K Q^T and dP^T =
//   V dO^T (wgmma m64n64k16 from shared memory); p^T to bf16 in registers
//   is the A operand of dV += P^T dO, issued before ds^T is computed, and
//   ds^T that of dK += dS^T Q (dO and Q read MN-major). dK and dV stay in
//   registers across all g heads; the epilogue stores them, rows past Skv
//   not written (an item no q row sees stores zeros).
// Shared memory (tiles on 1024-byte lines, plus 1 KB of slack and the
// barriers; one block per SM; the bias mode adds none):
//   dQ:    Q + dO 4 * 128 * D bytes, plus 4 stages x (K + V) 4 * 64 * D;
//          D = 128: 64 + 4 x 32 = 192 KB; D = 64: 32 + 4 x 16 = 96 KB;
//          D = 32: 16 + 4 x 8 = 48 KB.
//   dK/dV: K + V 4 * 128 * D bytes, plus 4 stages x (Q + dO 4 * 64 * D, lse
//          and delta 512 B); D = 128: 64 + 4 x 32.5 = 194 KB; D = 64: 32 + 4 x
//          16.5 = 98 KB; D = 32: 16 + 4 x 8.5 = 50 KB.
// As in the forward: the producer branch ends in `if (consumer) {...} else
// {...}` (setmaxnreg), every wgmma is issued under tile-index conditions
// only (ptxas serialises wgmma after a branch it cannot prove uniform, C7520),
// fully masked tiles are computed rather than skipped, and the warpgroup
// index comes through __shfl_sync. The no-bias kernels are the BIAS = false
// instantiations; the bias and its flag are parameters after theirs.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dstt_flash {

namespace {

using namespace dstt_hopper;

constexpr int WG = 64;        // rows a consumer warpgroup owns
constexpr int BM = 2 * WG;    // rows of a work item: Q rows (dQ), K rows (dK/dV)
// Rows of a ring tile: K and V (dQ), Q and dO (dK/dV). 128-row K / V tiles
// spilled dQ at hd 64 and 32 (S, dP, dQ and dS held 192 and 176 registers
// a thread) and ran it slower on the card.
constexpr int BT = 64;
constexpr int kConsumerWarps = 8;
constexpr int kThreadsBwd = 3 * 128;   // producer + two consumer warpgroups
constexpr int STAGES = 4;

// The forward's swizzled layout: a tile of [rows, D] bf16 is D / CB column
// blocks of [rows, CB], each row RB bytes.
template <int D>
struct Cfg {
  static constexpr int CB = D < 64 ? D : 64;        // columns of one swizzled block
  static constexpr int RB = CB * 2;                 // its row bytes
  static constexpr int NCB = D / CB;                // column blocks of a tile
  static constexpr int SWZ = RB;                    // 128-byte (64-byte at D = 32) swizzle
  static constexpr int SBO = 8 * RB;                // stride of 8-row groups
  static constexpr int ITEM_BYTES = BM * D * 2;     // Q or dO (dQ), K or V (dK/dV)
  static constexpr int TILE_BYTES = BT * D * 2;     // one ring tile
  static constexpr int ROW_BYTES = 2 * BT * 4;      // a dK/dV tile's lse and delta
  static constexpr size_t DQ_SMEM =
      1024 + 2 * ITEM_BYTES + (size_t)STAGES * 2 * TILE_BYTES + 8 * (2 + 2 * STAGES);
  static constexpr size_t DKV_SMEM = DQ_SMEM + (size_t)STAGES * ROW_BYTES;
};

// Planted faults for the tests (dstt_flash_bwd_sm90_plant): 1 reads the
// ring's stage one step late, 2 drops the last tile of each item's band, 3
// skips the last query head of each GQA group in dK/dV, 4 (bias mode) reads
// the bias one 64-row kv tile off (kv row j reads j + 64, modulo Skv). 0:
// none.
int g_plant = 0;

// 2^x by the special-function unit alone (subnormal in or out: 0): p below
// 2^-126 weighs nothing next to a row's largest p of ~1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The RS wgmma m64nDk16 (A in registers, B MN-major) by accumulator size.
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

// An accumulator's values as bf16 pairs: the A operand of the next product.
template <int N>
__device__ __forceinline__ void pack(uint32_t (&pa)[N / 2], const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) pa[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
}

// This thread's rows r0 and r0 + 8 of an accumulator (D / 2 registers) as
// bf16 rows of `first` (row stride `stride` elements), rows at or past n_rows
// not written.
template <int D>
__device__ __forceinline__ void store_acc(const float (&v)[D / 2], int t, int r0, int n_rows,
                                          __nv_bfloat16* first, size_t stride) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* out = first + (size_t)row * stride;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4)   // registers i, i + 1 of this row
      *reinterpret_cast<__nv_bfloat162*>(out + acc_col(t, i)) =
          __floats2bfloat162_rn(v[i], v[i + 1]);
  }
}

// The item a block takes in its round k: rounds of gridDim.x items, dealt
// forward in even rounds and backward in odd ones, so the blocks' sums of
// band lengths come out even.
__device__ __forceinline__ int item_of(int k) {
  const int g = gridDim.x, c = blockIdx.x;
  return k * g + ((k & 1) ? g - 1 - c : c);
}

// ------------------------------------------------------------ bias mode --
// The bias's kv row read for kv row j (planted fault 4: one tile off).
__device__ __forceinline__ int bias_kv(const Args& a, int j, int plant) {
  return plant == 4 ? (j + BT) % a.Skv : j;
}

// The bias at (batch b, head h, q row, kv row), or -inf where that score is
// not visible: p = 2^((scale s + bias - lse) log2 e) is then 0 there with
// no mask of its own.
__device__ __forceinline__ float bias_or_inf(const Args& a, const Bias& bb, int b, int h,
                                             int qrow, int kvrow, int plant) {
  return visible(a, qrow, kvrow) ? bias_at(bb, b, h, qrow, bias_kv(a, kvrow, plant))
                                 : -INFINITY;
}

// p in natural units (the bias mode's lse): -inf logits give 0, a row whose
// every logit and lse round to -1e30 gives exactly 1.
__device__ __forceinline__ float p_biased(float s, float scale, float bias, float lse) {
  return exp2_ftz((fmaf(s, scale, bias) - lse) * kLog2e);
}

// ------------------------------------------------------------------- dQ --
// A dQ item: BM q rows of one (batch, head) and the kv tiles they see,
// numbered longest band first, all heads of a q tile together.
struct DqItem {
  int b, h, q0, t_lo, n_tiles;
  __device__ DqItem(int w, const Args& a, int plant) {
    const int bh = w % (a.B * a.H), n_qt = (a.Sq + BM - 1) / BM;
    b = bh / a.H;
    h = bh % a.H;
    q0 = (n_qt - 1 - w / (a.B * a.H)) * BM;
    int kv_lo = 0, kv_hi = a.Skv;   // the kv rows these q rows can see
    if (a.causal) {
      kv_hi = min(a.Skv, q0 + BM + a.q_offset);
      if (a.window > 0) kv_lo = max(0, q0 + a.q_offset - a.window + 1);
    }
    t_lo = kv_lo / BT;
    const int t_hi = (kv_hi + BT - 1) / BT - (plant == 2 ? 1 : 0);   // planted fault 2
    n_tiles = kv_hi > kv_lo ? max(0, t_hi - t_lo) : 0;
  }
};

__device__ __forceinline__ int dq_items(const Args& a) {
  return (a.Sq + BM - 1) / BM * a.B * a.H;
}

// Whether a consumer's 64 q rows from rlo and the kv tile at j0 need the
// element mask (a tail, the diagonal or the window edge crosses them).
__device__ __forceinline__ bool dq_masked(const Args& a, int rlo, int j0) {
  bool mask = j0 + BT > a.Skv || rlo + WG > a.Sq;
  if (a.causal)
    mask = mask || j0 + BT - 1 > rlo + a.q_offset ||
           (a.window > 0 && rlo + WG - 1 + a.q_offset - j0 >= a.window);
  return mask;
}

// The bias of this thread's 32 scores of the dQ tile (q rows from rlo, kv
// columns from j0): rows r0 and r0 + 8, columns j0 + acc_col. A tile no
// mask touches reads pairs as one load where `vec` (kv stride 1, even
// offsets, an aligned base); a masked one each visible score, -inf
// elsewhere.
__device__ __forceinline__ void dq_bias_tile(float (&bv)[BT / 2], const Args& a, const Bias& bb,
                                             int b, int h, int rlo, int j0, bool vec, int t,
                                             int plant) {
  const int r0 = rlo + acc_row(t, 0);
  if (!dq_masked(a, rlo, j0) && vec && plant != 4) {
    const long long base = (long long)b * bb.sb + (long long)h * bb.sh;
    const long long roff[2] = {base + (long long)r0 * bb.sq, base + (long long)(r0 + 8) * bb.sq};
    const int c0 = j0 + 2 * (t & 3);
    if (bb.f32) {
      const float* p = static_cast<const float*>(bb.ptr);
#pragma unroll
      for (int i = 0; i < BT / 2; i += 2) {
        const float2 x =
            __ldg(reinterpret_cast<const float2*>(p + roff[(i >> 1) & 1] + c0 + 8 * (i >> 2)));
        bv[i] = x.x;
        bv[i + 1] = x.y;
      }
    } else {
      const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(bb.ptr);
#pragma unroll
      for (int i = 0; i < BT / 2; i += 2) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            p + roff[(i >> 1) & 1] + c0 + 8 * (i >> 2)));
        bv[i] = x.x;
        bv[i + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < BT / 2; ++e)
      bv[e] = bias_or_inf(a, bb, b, h, r0 + 8 * ((e >> 1) & 1), j0 + acc_col(t, e), plant);
  }
}

// dbias = p (dp - delta) of this thread's 32 scores (rows r0, r0 + 8 of
// `out`, the [Sq, Skv] fp32 plane of this batch and head; columns from
// j0), in fp32 pairs where Skv is even; rows past Sq and columns past Skv
// not written.
__device__ __forceinline__ void store_dbias(const float (&ds)[BT / 2], const Args& a, float* out,
                                            int r0, int j0, int t) {
  const bool pairs = (a.Skv & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Sq) continue;
    float* o = out + (size_t)row * a.Skv;
#pragma unroll
    for (int i = 2 * r; i < BT / 2; i += 4) {   // registers i, i + 1 of this row
      const int col = j0 + acc_col(t, i);
      if (pairs) {
        if (col < a.Skv) *reinterpret_cast<float2*>(o + col) = make_float2(ds[i], ds[i + 1]);
      } else {
        if (col < a.Skv) o[col] = ds[i];
        if (col + 1 < a.Skv) o[col + 1] = ds[i + 1];
      }
    }
  }
}

// dbias zeros over the kv columns outside [c_lo, c_hi) (the tiles the band
// skips) of a consumer's 64 rows from rlo, rows past Sq not written.
__device__ __forceinline__ void dbias_zeros(const Args& a, float* out, int rlo, int c_lo,
                                            int c_hi, int t) {
  const bool quads = (a.Skv & 3) == 0;   // c_lo and c_hi < Skv are multiples of 64
  for (int r = 0; r < WG && rlo + r < a.Sq; ++r) {
    float* o = out + (size_t)(rlo + r) * a.Skv;
    if (quads) {
      for (int c = 4 * t; c < c_lo; c += 4 * 128)
        *reinterpret_cast<float4*>(o + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = c_hi + 4 * t; c < a.Skv; c += 4 * 128)
        *reinterpret_cast<float4*>(o + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int c = t; c < c_lo; c += 128) o[c] = 0.f;
      for (int c = c_hi + t; c < a.Skv; c += 128) o[c] = 0.f;
    }
  }
}

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

// The producer's one thread: per item, Q and dO (once the consumers are done
// with the last ones), then its K / V tiles into the ring, whose stage and
// phase run on across items.
template <int D>
__device__ __forceinline__ void dq_produce(const DqSmem<D>& sm, const CUtensorMap* tm_q,
                                           const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, const Args& a, int plant) {
  using C = Cfg<D>;
  tma_prefetch_map(tm_q);
  tma_prefetch_map(tm_do);
  tma_prefetch_map(tm_k);
  tma_prefetch_map(tm_v);
  int it = 0;   // kv tiles loaded so far
  for (int n = 0; item_of(n) < dq_items(a); ++n) {
    const DqItem item(item_of(n), a, plant);
    const int hk = item.h / (a.H / a.Hkv);
    if (n > 0) mbar_wait(sm.q_empty, (n - 1) & 1);
    mbar_expect_tx(sm.q_full, 2 * C::ITEM_BYTES);
    for (int c = 0; c < C::NCB; ++c) {
      tma_load_4d(sm.q + c * BM * C::RB, tm_q, sm.q_full, c * C::CB, item.h, item.q0, item.b);
      tma_load_4d(sm.dout + c * BM * C::RB, tm_do, sm.q_full, c * C::CB, item.h, item.q0,
                  item.b);
    }
    for (int i = 0; i < item.n_tiles; ++i, ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(sm.empty(s), (it / STAGES - 1) & 1);
      const int j0 = (item.t_lo + i) * BT;
      mbar_expect_tx(sm.full(s), 2 * C::TILE_BYTES);
      for (int c = 0; c < C::NCB; ++c) {
        tma_load_4d(sm.k(s) + c * BT * C::RB, tm_k, sm.full(s), c * C::CB, hk, j0, item.b);
        tma_load_4d(sm.v(s) + c * BT * C::RB, tm_v, sm.full(s), c * C::CB, hk, j0, item.b);
      }
    }
  }
}

// A dQ consumer warpgroup (cw 0 or 1: q rows q0 + 64 cw .. of each item).
// Per kv tile i it issues S(i), dP(i) and dQ += dS(i-1) K(i-1) as three
// commit groups, computes p from S(i) while dP(i) and the dQ product run,
// then ds; the stage of tile i-1 is released once its dQ product is done.
// Bias mode: p takes the tile's bias from bv, which then loads the next
// tile's (the next item's first, after an item's last) under the dP and dQ
// products; dbias is stored once ds is known.
template <int D, bool BIAS>
__device__ __forceinline__ void dq_consume(const DqSmem<D>& sm, const Args& a, const Bias& bb,
                                           bool bias_vec, int cw, int plant) {
  using C = Cfg<D>;
  const int t = threadIdx.x % 128, lane = t & 31;
  const uint32_t sQw = sm.q + cw * WG * C::RB;      // this warpgroup's 64 Q rows
  const uint32_t sdOw = sm.dout + cw * WG * C::RB;  // and dO rows
  const float sl2 = a.scale * kLog2e;
  int it = 0;                                       // kv tiles consumed so far
  float bv[BT / 2];   // bias mode: the bias of the next tile to compute
  int bv_item = -1;   // the item whose first tile bv already holds

  for (int n = 0; item_of(n) < dq_items(a); ++n) {
    const DqItem item(item_of(n), a, plant);
    const int rlo = item.q0 + cw * WG;              // first row here
    const int r0 = rlo + acc_row(t, 0);             // this thread's rows r0, r0 + 8
    const size_t bh = (size_t)item.b * a.H + item.h;
    // lse of the two rows, in base 2 (in natural units with a bias), and delta
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lse2[r] = row < a.Sq ? a.lse[bh * a.Sq + row] * (BIAS ? 1.f : kLog2e) : 0.f;
      dlt[r] = row < a.Sq ? a.delta[bh * a.Sq + row] : 0.f;
    }
    float* dbias = BIAS && bb.dbias ? bb.dbias + bh * a.Sq * a.Skv : nullptr;
    if (BIAS && item.n_tiles > 0 && bv_item != n)
      dq_bias_tile(bv, a, bb, item.b, item.h, rlo, item.t_lo * BT, bias_vec, t, plant);
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    uint32_t da[BT / 4];   // dS(i-1) as bf16, the A operand: k16 step kt in da[4 kt .. +3]
    int prev = 0, prev_read = 0;   // the previous tile's stage, and the one its K is read from

    mbar_wait(sm.q_full, n & 1);
    for (int i = 0; i < item.n_tiles; ++i, ++it) {
      const int s = it % STAGES;
      const int j0 = (item.t_lo + i) * BT;
      const int sr = plant == 1 && i > 0 ? (it - 1) % STAGES : s;   // planted fault 1
      const bool mask = dq_masked(a, rlo, j0);
      mbar_wait(sm.full(s), (it / STAGES) & 1);

      float sacc[BT / 2], dpacc[BT / 2];
      wgmma_fence();
      issue_ss<D>(sacc, sQw, sm.k(sr));
      wgmma_commit();
      issue_ss<D>(dpacc, sdOw, sm.v(sr));
      wgmma_commit();
      if (i > 0) issue_rs<D>(dq, da, sm.k(prev_read));
      wgmma_commit();

      wgmma_wait<2>();   // S(i) is done
      fence_regs(sacc);
      if constexpr (BIAS) {
#pragma unroll
        for (int e = 0; e < BT / 2; ++e)
          sacc[e] = p_biased(sacc[e], a.scale, bv[e], lse2[(e >> 1) & 1]);
        // the next tile's bias: this item's next kv tile or the next item's first
        int nb = item.b, nh = item.h, nr = rlo, nj = j0 + BT;
        bool next = true;
        if (i + 1 == item.n_tiles) {
          next = item_of(n + 1) < dq_items(a);
          if (next) {
            const DqItem nx(item_of(n + 1), a, plant);
            nb = nx.b;
            nh = nx.h;
            nr = nx.q0 + cw * WG;
            nj = nx.t_lo * BT;
            next = nx.n_tiles > 0;
            bv_item = n + 1;
          }
        }
        if (next) dq_bias_tile(bv, a, bb, nb, nh, nr, nj, bias_vec, t, plant);
      } else if (mask) {
#pragma unroll
        for (int e = 0; e < BT / 2; ++e) {
          const int r = (e >> 1) & 1;
          sacc[e] = visible(a, r0 + 8 * r, j0 + acc_col(t, e))
                        ? exp2_ftz(fmaf(sacc[e], sl2, -lse2[r]))
                        : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < BT / 2; ++e)
          sacc[e] = exp2_ftz(fmaf(sacc[e], sl2, -lse2[(e >> 1) & 1]));
      }
      wgmma_wait<1>();   // dP(i) is done
      fence_regs(dpacc);
      if constexpr (BIAS) {
#pragma unroll
        for (int e = 0; e < BT / 2; ++e)   // dL/dlogits: the bias gradient
          dpacc[e] = sacc[e] * (dpacc[e] - dlt[(e >> 1) & 1]);
        if (dbias) store_dbias(dpacc, a, dbias, r0, j0, t);
#pragma unroll
        for (int e = 0; e < BT / 2; ++e) dpacc[e] *= a.scale;
      } else {
#pragma unroll
        for (int e = 0; e < BT / 2; ++e)
          dpacc[e] = sacc[e] * (dpacc[e] - dlt[(e >> 1) & 1]) * a.scale;
      }
      wgmma_wait<0>();   // dQ += dS(i-1) K(i-1) is done: its stage and da are free
      fence_regs(dq);
      fence_regs(da);
      __syncwarp();
      if (i > 0 && lane == 0) mbar_arrive(sm.empty(prev));
      pack<BT / 2>(da, dpacc);   // ds rounded to bf16, as on the TPU
      prev = s;
      prev_read = sr;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.q_empty);   // every S and dP of this item has read Q, dO
    if (item.n_tiles > 0) {
      wgmma_fence();
      issue_rs<D>(dq, da, sm.k(prev_read));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(prev));
    }
    const size_t qstride = (size_t)a.H * D;   // dq [B, Sq, H, D]
    store_acc<D>(dq, t, r0, a.Sq,
                 static_cast<__nv_bfloat16*>(a.dq) + (size_t)item.b * a.Sq * qstride +
                     (size_t)item.h * D,
                 qstride);
    if (dbias)   // the kv tiles the band skips
      dbias_zeros(a, dbias, rlo, item.t_lo * BT,
                  min(a.Skv, (item.t_lo + item.n_tiles) * BT), t);
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const Args a,
                             const int plant, const Bias bb, const int bias_vec) {
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
    dq_consume<D, BIAS>(sm, a, bb, bias_vec != 0, cw, plant);
  } else {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) dq_produce<D>(sm, &tm_q, &tm_do, &tm_k, &tm_v, a, plant);
  }
}

// ---------------------------------------------------------------- dK/dV --
// A dK/dV item: BM kv rows of one (batch, kv head) and the q tiles that can
// see them, numbered first kv tiles first (causal: they see the most q rows).
struct DkvItem {
  int b, hk, k0, t_lo, n_tiles;   // q tiles t_lo .. t_lo + n_tiles - 1 of each query head
  __device__ DkvItem(int w, const Args& a, int plant) {
    const int bh = w % (a.B * a.Hkv);
    b = bh / a.Hkv;
    hk = bh % a.Hkv;
    k0 = w / (a.B * a.Hkv) * BM;
    int q_lo = 0, q_hi = a.Sq;   // the q rows that can see these kv rows
    if (a.causal) {
      q_lo = max(0, k0 - a.q_offset);
      if (a.window > 0) q_hi = max(0, min(a.Sq, k0 + BM - 1 + a.window - a.q_offset));
    }
    t_lo = q_lo / BT;
    const int t_hi = (q_hi + BT - 1) / BT - (plant == 2 ? 1 : 0);   // planted fault 2
    n_tiles = q_hi > q_lo ? max(0, t_hi - t_lo) : 0;
  }
};

__device__ __forceinline__ int dkv_items(const Args& a) {
  return (a.Skv + BM - 1) / BM * a.B * a.Hkv;
}

// The query heads of a kv head's group that dK/dV walks (planted fault 3
// leaves the last one out).
__device__ __forceinline__ int dkv_heads(const Args& a, int plant) {
  return a.H / a.Hkv - (plant == 3 ? 1 : 0);
}

// Whether a consumer's 64 kv rows from klo and the q tile at i0 need the
// element mask.
__device__ __forceinline__ bool dkv_masked(const Args& a, int klo, int i0) {
  bool mask = i0 + BT > a.Sq || klo + WG > a.Skv;
  if (a.causal)
    mask = mask || klo + WG - 1 > i0 + a.q_offset ||
           (a.window > 0 && i0 + BT - 1 + a.q_offset - klo >= a.window);
  return mask;
}

// The bias of this thread's 32 scores of the dK/dV tile (S^T: kv rows kr0,
// kr0 + 8 from klo, q columns i0 + acc_col), -inf where not visible. With
// kv stride 1 the 8 lanes of a q column read one 32-byte sector. A tile no
// mask touches walks two offsets (kv rows kr0 and kr0 + 8) along q by
// column pairs, so no per-score address is held.
template <typename T>
__device__ __forceinline__ void dkv_bias_walk(float (&bv)[BT / 2], const T* p, long long o0,
                                              long long o1, long long sq) {
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt, o0 += 8 * sq, o1 += 8 * sq) {   // registers 4 nt ..
    bv[4 * nt] = to_f(__ldg(p + o0));
    bv[4 * nt + 1] = to_f(__ldg(p + o0 + sq));
    bv[4 * nt + 2] = to_f(__ldg(p + o1));
    bv[4 * nt + 3] = to_f(__ldg(p + o1 + sq));
  }
}

__device__ __forceinline__ void dkv_bias_tile(float (&bv)[BT / 2], const Args& a, const Bias& bb,
                                              int b, int hq, int klo, int i0, int t, int plant) {
  const int kr0 = klo + acc_row(t, 0);
  if (!dkv_masked(a, klo, i0) && plant != 4) {
    const long long o0 = (long long)b * bb.sb + (long long)hq * bb.sh +
                         (long long)(i0 + 2 * (t & 3)) * bb.sq + (long long)kr0 * bb.sk;
    const long long o1 = o0 + 8 * bb.sk;
    if (bb.f32)
      dkv_bias_walk(bv, static_cast<const float*>(bb.ptr), o0, o1, bb.sq);
    else
      dkv_bias_walk(bv, static_cast<const __nv_bfloat16*>(bb.ptr), o0, o1, bb.sq);
  } else {
#pragma unroll
    for (int e = 0; e < BT / 2; ++e)
      bv[e] = bias_or_inf(a, bb, b, hq, i0 + acc_col(t, e), kr0 + 8 * ((e >> 1) & 1), plant);
  }
}

// Shared-memory addresses of the dK/dV kernel's tiles, rows and barriers.
template <int D>
struct DkvSmem {
  uint32_t k, v, ring, rows, kv_full, kv_empty, full0, empty0;
  float* rows_gen;   // the rows region as a generic pointer
  __device__ explicit DkvSmem(unsigned char* raw) {
    using C = Cfg<D>;
    k = (smem_u32(raw) + 1023u) & ~1023u;
    v = k + C::ITEM_BYTES;
    ring = v + C::ITEM_BYTES;                 // stage s: Q at ring + 2 s TILE_BYTES, dO after it
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
// last ones; lane 0), then for each query head of the group its Q / dO
// tiles into the ring (lane 0, TMA) with the tile's lse and delta (every
// lane, ordinary loads). A stage's full barrier counts the 32 lanes' arrivals
// (each after its own row writes) and the TMA bytes.
template <int D, bool BIAS>
__device__ __forceinline__ void dkv_produce(const DkvSmem<D>& sm, const CUtensorMap* tm_q,
                                            const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v, const Args& a, int plant) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31, g = a.H / a.Hkv;
  if (lane == 0) {
    tma_prefetch_map(tm_q);
    tma_prefetch_map(tm_do);
    tma_prefetch_map(tm_k);
    tma_prefetch_map(tm_v);
  }
  int it = 0;   // q tiles loaded so far
  for (int n = 0; item_of(n) < dkv_items(a); ++n) {
    const DkvItem item(item_of(n), a, plant);
    if (lane == 0) {
      if (n > 0) mbar_wait(sm.kv_empty, (n - 1) & 1);
      mbar_expect_tx(sm.kv_full, 2 * C::ITEM_BYTES);
      for (int c = 0; c < C::NCB; ++c) {
        tma_load_4d(sm.k + c * BM * C::RB, tm_k, sm.kv_full, c * C::CB, item.hk, item.k0, item.b);
        tma_load_4d(sm.v + c * BM * C::RB, tm_v, sm.kv_full, c * C::CB, item.hk, item.k0, item.b);
      }
    }
    for (int j = 0; j < dkv_heads(a, plant); ++j) {
      const int hq = item.hk * g + j;
      const float* lse = a.lse + ((size_t)item.b * a.H + hq) * a.Sq;
      const float* delta = a.delta + ((size_t)item.b * a.H + hq) * a.Sq;
      for (int i = 0; i < item.n_tiles; ++i, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(sm.empty(s), (it / STAGES - 1) & 1);
        const int i0 = (item.t_lo + i) * BT;
        float* sl = sm.lse(s);
        float* sd = sm.delta(s);
        for (int r = lane; r < BT; r += 32) {
          const int row = i0 + r;
          sl[r] = row < a.Sq ? lse[row] * (BIAS ? 1.f : kLog2e) : 0.f;
          sd[r] = row < a.Sq ? delta[row] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(sm.full(s), 2 * C::TILE_BYTES);
          for (int c = 0; c < C::NCB; ++c) {
            tma_load_4d(sm.q(s) + c * BT * C::RB, tm_q, sm.full(s), c * C::CB, hq, i0,
                        item.b);
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

// A dK/dV consumer warpgroup (cw 0 or 1: kv rows k0 + 64 cw .. of each
// item). Per q tile: S^T and dP^T as two commit groups; p^T once S^T is
// done, then dV += P^T dO issued while ds^T waits for dP^T; then dK +=
// dS^T Q, and the stage is released once both products are done.
// Bias mode: a bias with q stride 0 is read as bk, two values per query
// head; any other from bv, loaded a tile ahead under the tile's products
// at D <= 64, or per score at D = 128 where the registers are not there.
template <int D, bool BIAS>
__device__ __forceinline__ void dkv_consume(const DkvSmem<D>& sm, const Args& a, const Bias& bb,
                                            int cw, int plant) {
  using C = Cfg<D>;
  constexpr bool kAhead = D <= 64;
  const int t = threadIdx.x % 128, lane = t & 31;
  const uint32_t sKw = sm.k + cw * WG * C::RB;   // this warpgroup's 64 K rows
  const uint32_t sVw = sm.v + cw * WG * C::RB;   // and V rows
  const float sl2 = a.scale * kLog2e;
  int it = 0;                                    // q tiles consumed so far
  const bool per_kv = BIAS && bb.sq == 0;        // the bias is one value per kv row
  const int g = a.H / a.Hkv, heads = dkv_heads(a, plant);
  float bv[BT / 2];   // bias mode, kAhead: the bias of the next tile to compute
  int bv_item = -1;   // the item whose first tile bv already holds

  for (int n = 0; item_of(n) < dkv_items(a); ++n) {
    const DkvItem item(item_of(n), a, plant);
    const int klo = item.k0 + cw * WG;            // first kv row here
    const int kr0 = klo + acc_row(t, 0);          // this thread's kv rows kr0, kr0 + 8
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (BIAS && kAhead && !per_kv && item.n_tiles > 0 && heads > 0 && bv_item != n)
      dkv_bias_tile(bv, a, bb, item.b, item.hk * g, klo, item.t_lo * BT, t, plant);

    mbar_wait(sm.kv_full, n & 1);
    for (int j = 0; j < dkv_heads(a, plant); ++j) {
      const int hq = item.hk * g + j;
      float bk[2];   // per_kv: the bias of this thread's two kv rows for head hq
      if (BIAS && per_kv) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kv = kr0 + 8 * r;
          bk[r] = kv < a.Skv ? bias_at(bb, item.b, hq, 0, bias_kv(a, kv, plant)) : 0.f;
        }
      }
      for (int i = 0; i < item.n_tiles; ++i, ++it) {
        const int s = it % STAGES;
        const int i0 = (item.t_lo + i) * BT;
        const int sr = plant == 1 && (i > 0 || j > 0) ? (it - 1) % STAGES : s;   // fault 1
        const bool mask = dkv_masked(a, klo, i0);
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
        if constexpr (BIAS) {   // lse in natural units
          if (per_kv && mask) {
#pragma unroll
            for (int e = 0; e < BT / 2; ++e) {
              const int col = acc_col(t, e), r = (e >> 1) & 1;
              st[e] = visible(a, i0 + col, kr0 + 8 * r)
                          ? p_biased(st[e], a.scale, bk[r], lse2[col])
                          : 0.f;
            }
          } else if (per_kv) {
#pragma unroll
            for (int e = 0; e < BT / 2; ++e)
              st[e] = p_biased(st[e], a.scale, bk[(e >> 1) & 1], lse2[acc_col(t, e)]);
          } else if (kAhead) {
#pragma unroll
            for (int e = 0; e < BT / 2; ++e)
              st[e] = p_biased(st[e], a.scale, bv[e], lse2[acc_col(t, e)]);
            // the next tile's bias: this head's next q tile, the next head's
            // first, or the next item's first
            int nb = item.b, nh = hq, nk = klo, ni = i0 + BT;
            bool next = true;
            if (i + 1 == item.n_tiles) {
              ni = item.t_lo * BT;
              ++nh;
              if (j + 1 == heads) {
                next = item_of(n + 1) < dkv_items(a);
                if (next) {
                  const DkvItem nx(item_of(n + 1), a, plant);
                  nb = nx.b;
                  nh = nx.hk * g;
                  nk = nx.k0 + cw * WG;
                  ni = nx.t_lo * BT;
                  next = nx.n_tiles > 0;
                  bv_item = n + 1;
                }
              }
            }
            if (next) dkv_bias_tile(bv, a, bb, nb, nh, nk, ni, t, plant);
          } else {
#pragma unroll
            for (int e = 0; e < BT / 2; ++e) {
              const int col = acc_col(t, e);
              st[e] = p_biased(st[e], a.scale,
                               bias_or_inf(a, bb, item.b, hq, i0 + col, kr0 + 8 * ((e >> 1) & 1),
                                           plant),
                               lse2[col]);
            }
          }
        } else if (mask) {
#pragma unroll
          for (int e = 0; e < BT / 2; ++e) {
            const int col = acc_col(t, e);
            st[e] = visible(a, i0 + col, kr0 + 8 * ((e >> 1) & 1))
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
    const size_t kstride = (size_t)a.Hkv * D;   // dk, dv [B, Skv, Hkv, D]
    const size_t first = (size_t)item.b * a.Skv * kstride + (size_t)item.hk * D;
    store_acc<D>(dk, t, kr0, a.Skv, static_cast<__nv_bfloat16*>(a.dk) + first, kstride);
    store_acc<D>(dv, t, kr0, a.Skv, static_cast<__nv_bfloat16*>(a.dv) + first, kstride);
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const Args a,
                              const int plant, const Bias bb) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const DkvSmem<D> sm(smem_raw);
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
    const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
    dkv_consume<D, BIAS>(sm, a, bb, cw, plant);
  } else {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) dkv_produce<D, BIAS>(sm, &tm_q, &tm_do, &tm_k, &tm_v, a, plant);
  }
}

// ---------------------------------------------------------------- launch --
cudaError_t grid_of(long long items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = (int)(items < sms ? items : sms);
  return err;
}

template <int D, bool BIAS>
cudaError_t launch_dq(const Args& a, const Bias& bb, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = bhsd_map(&tq, a.q, a.B, a.Sq, a.H, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tdo, a.dout, a.B, a.Sq, a.H, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tk, a.k, a.B, a.Skv, a.Hkv, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tv, a.v, a.B, a.Skv, a.Hkv, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_sm90_kernel<D, BIAS>, C::DQ_SMEM);
  int grid = 0;
  if (err == cudaSuccess) err = grid_of((long long)((a.Sq + BM - 1) / BM) * a.B * a.H, &grid);
  if (err != cudaSuccess) return err;
  // bias pairs as one load: kv stride 1, even offsets, an aligned base
  const int bias_vec = bb.sk == 1 && bb.sb % 2 == 0 && bb.sh % 2 == 0 && bb.sq % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(bb.ptr) % (bb.f32 ? 8 : 4) == 0;
  flash_bwd_dq_sm90_kernel<D, BIAS><<<grid, kThreadsBwd, C::DQ_SMEM, stream>>>(
      tq, tdo, tk, tv, a, g_plant, bb, bias_vec);
  return cudaGetLastError();
}

template <int D, bool BIAS>
cudaError_t launch_dkv(const Args& a, const Bias& bb, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = bhsd_map(&tq, a.q, a.B, a.Sq, a.H, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tdo, a.dout, a.B, a.Sq, a.H, D, BT, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tk, a.k, a.B, a.Skv, a.Hkv, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tv, a.v, a.B, a.Skv, a.Hkv, D, BM, C::CB, C::SWZ);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkv_sm90_kernel<D, BIAS>, C::DKV_SMEM);
  int grid = 0;
  if (err == cudaSuccess) err = grid_of((long long)((a.Skv + BM - 1) / BM) * a.B * a.Hkv, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_sm90_kernel<D, BIAS><<<grid, kThreadsBwd, C::DKV_SMEM, stream>>>(
      tq, tdo, tk, tv, a, g_plant, bb);
  return cudaGetLastError();
}

// launch_dq or launch_dkv at head dim D, with or without a bias (bb.ptr)
template <bool DQ>
cudaError_t launch_any(const Args& a, const Bias& bb, int D, cudaStream_t s) {
  const bool bias = bb.ptr != nullptr;
  if (D == 128)
    return DQ ? (bias ? launch_dq<128, true>(a, bb, s) : launch_dq<128, false>(a, bb, s))
              : (bias ? launch_dkv<128, true>(a, bb, s) : launch_dkv<128, false>(a, bb, s));
  if (D == 64)
    return DQ ? (bias ? launch_dq<64, true>(a, bb, s) : launch_dq<64, false>(a, bb, s))
              : (bias ? launch_dkv<64, true>(a, bb, s) : launch_dkv<64, false>(a, bb, s));
  return DQ ? (bias ? launch_dq<32, true>(a, bb, s) : launch_dq<32, false>(a, bb, s))
            : (bias ? launch_dkv<32, true>(a, bb, s) : launch_dkv<32, false>(a, bb, s));
}

// Checks shared by both entry points: a valid head layout, and q, k, v and
// dO at the 16-byte alignment TMA needs (the wrapper checks it first and
// raises).
cudaError_t check_inputs(const Args& a, int D) {
  if (bad_shape(a.H, a.Hkv, a.Skv) || (D != 32 && D != 64 && D != 128))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout)) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

}  // namespace dstt_flash

// The two entry points of each kernel (with and without a bias) share
// these: dq from the inputs (B = 0 or Sq = 0: nothing to write).
static int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int B, int H, int Hkv, int Sq,
                  int Skv, int D, int q_offset, int causal, int window, float scale,
                  const dstt_flash::Bias& bb, void* stream) {
  using namespace dstt_flash;
  if (B == 0 || Sq == 0) return 0;
  Args a = bwd_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Skv, q_offset, causal, window,
                    scale);
  a.dq = dq;
  cudaError_t err = check_inputs(a, D);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_any<true>(a, bb, D, static_cast<cudaStream_t>(stream));
}

// dk, dv from the inputs (Skv = 0: nothing to write; Sq = 0: zeros).
static int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                   int Hkv, int Sq, int Skv, int D, int q_offset, int causal, int window,
                   float scale, const dstt_flash::Bias& bb, void* stream) {
  using namespace dstt_flash;
  if (B == 0 || Skv == 0) return 0;
  Args a = bwd_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Skv, q_offset, causal, window,
                    scale);
  a.dk = dk;
  a.dv = dv;
  cudaError_t err = check_inputs(a, D);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0) {   // nothing to sum: a tensor map cannot span 0 rows
    const size_t bytes = (size_t)B * Skv * Hkv * D * 2;
    err = cudaMemsetAsync(dk, 0, bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, s);
    return (int)err;
  }
  return (int)launch_any<false>(a, bb, D, s);
}

// bf16 dq [B, Sq, H, D] from q, k, v, dout [B, S, *, D] (dense, 16-byte
// aligned), lse and delta [B * H, Sq] fp32 (lse in base e, as the forward
// writes it). D: 32, 64 or 128.
extern "C" int dstt_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int B, int H, int Hkv, int Sq, int Skv, int D,
                                      int q_offset, int causal, int window, float scale,
                                      void* stream) {
  return bwd_dq(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Skv, D, q_offset, causal, window,
                scale, dstt_flash::Bias{}, stream);
}

// bf16 dk, dv [B, Skv, Hkv, D] (narrow) from the same inputs. No query row
// (Sq = 0): zeros.
extern "C" int dstt_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                                       int Skv, int D, int q_offset, int causal, int window,
                                       float scale, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Skv, D, q_offset, causal,
                 window, scale, dstt_flash::Bias{}, stream);
}

// The bias mode of dstt_flash_bwd_dq_sm90: bias (not null unless there is
// nothing to compute: a bias of no element may have none; bf16 or fp32 by
// bias_f32) broadcastable to [B, H, Sq, Skv], read through its element
// strides sb, sh, sq, sk (any may be 0); dbias (may be null) fp32 [B, H,
// Sq, Skv], every element written; lse as the bias-mode forward writes it.
extern "C" int dstt_flash_bwd_dq_bias_sm90(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse,
                                           const float* delta, void* dq, int B, int H, int Hkv,
                                           int Sq, int Skv, int D, int q_offset, int causal,
                                           int window, float scale, const void* bias,
                                           long long sb, long long sh, long long sq,
                                           long long sk, int bias_f32, float* dbias,
                                           void* stream) {
  if (bias == nullptr && B > 0 && Sq > 0) return (int)cudaErrorInvalidValue;
  return bwd_dq(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Skv, D, q_offset, causal, window,
                scale, dstt_flash::Bias{bias, sb, sh, sq, sk, bias_f32, dbias}, stream);
}

// The bias mode of dstt_flash_bwd_dkv_sm90 (the bias as above).
extern "C" int dstt_flash_bwd_dkv_bias_sm90(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, void* dk, void* dv, int B,
                                            int H, int Hkv, int Sq, int Skv, int D,
                                            int q_offset, int causal, int window, float scale,
                                            const void* bias, long long sb, long long sh,
                                            long long sq, long long sk, int bias_f32,
                                            void* stream) {
  if (bias == nullptr && B > 0 && Sq > 0 && Skv > 0) return (int)cudaErrorInvalidValue;
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Skv, D, q_offset, causal,
                 window, scale, dstt_flash::Bias{bias, sb, sh, sq, sk, bias_f32, nullptr},
                 stream);
}

// Plants a fault in the next launches of both kernels (tests only): 1 reads
// the ring's stage one step late, 2 drops the last tile of each item's band,
// 3 skips the last query head of each GQA group in dK/dV, 4 (bias mode)
// reads the bias one kv tile off, 0 none.
extern "C" int dstt_flash_bwd_sm90_plant(int fault) {
  dstt_flash::g_plant = fault;
  return 0;
}
