// Flash-attention forward for Hopper (sm_90a), bf16, hd 32 / 64 / 128:
// TMA loads into an mbarrier ring, wgmma products, warp specialisation.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (:284,
// pallas_call at :426, driven by `_flash_fwd` :361; bias mode `_flash_b`
// :787). Same function as flash_fwd.cu (which now serves fp32 only): o =
// softmax(scale * q k^T + bias + mask) v per (batch, head), the running max,
// sum and accumulator in fp32, p rounded to bf16 before the P V product,
// lse = m + log(l) per row. Masks: causal with q_offset, a static causal
// window, kv length. A row that sees no key gets o = 0 and lse = -1e30 +
// log 1. The bias mode keeps the softmax in natural units (flash_common.cuh),
// so a row whose every key carries a -1e30 bias averages v uniformly.
//
// Bound on an H100 SXM: operations. A causal pass at Llama-3-8B's training
// shape (B = 1, S = 4096, 32 / 8 heads, hd 128) is 2 * S^2 * hd * 32 ~ 137
// GFLOP of bf16 products (~139 us at 989 TFLOP/s) against ~70 MB of q, k, v,
// o (~21 us of HBM time). So the tensor cores must be kept fed: the design
// moves the data with TMA, runs both products as warpgroup MMAs (wgmma, the
// only path to the card's full bf16 rate) and keeps P in registers.
//
// Design. A work item is BQ = 128 q rows of one (batch, head); the grid is
// persistent (one block of 3 warpgroups per SM walks items, dealt so that
// the blocks' causal lengths come out even, longest rows first).
// - warpgroup 0, the producer, gives its registers away (setmaxnreg) and one
//   of its threads issues every load: an item's Q once the consumers are
//   done with the last one, then its K and V tiles of BKV = 128 rows into a
//   ring of STAGES stages, each with a "full" mbarrier (TMA completes its
//   bytes) and an "empty" one (the 8 consumer warps arrive when done with
//   it). So the next item's loads run under this item's last product and
//   epilogue. The maps are 4-D over [B, S, H(kv), D]: a tile never crosses
//   into another batch or head, rows past S arrive as zeros, and GQA K / V
//   are read in place (query head h reads kv head h / g).
// - warpgroups 1 and 2, the consumers, own 64 q rows each. Per kv tile:
//   S = Q K^T as D / 16 wgmma m64n128k16 with both operands in shared memory;
//   mask (only on tiles that cross the diagonal, the window edge or a tail),
//   scale, bias and online softmax on the accumulator in registers (one FFMA
//   and one ex2 per score without a bias); P packed to bf16 in registers is
//   the A operand of O += P V, BKV / 16 wgmma m64nDk16 with V read as the
//   transposed B operand. P never goes through shared memory.
// - the two consumers take turns on the tensor cores (named barriers): one
//   issues S(i) and O += P(i-1) V(i-1) while the other runs its softmax, and
//   a warpgroup's softmax of S(i) overlaps its own P(i-1) V(i-1).
// - only the kv tiles the causal band or window can see are loaded.
// - the epilogue writes o from registers with stores masked at Sq, and lse.
// Shared memory: Q 2 * BQ * D bytes plus STAGES x (K + V) 4 * BKV * D bytes;
// D = 128: 32 + 3 x 64 = 224 KB; D = 64: 16 + 4 x 32 = 144 KB; D = 32:
// 8 + 4 x 16 = 72 KB (plus 1 KB of alignment slack and the barriers), all
// under the 227 KB a block may hold; one block per SM (registers).
// The bias is read in place through its four strides (flash_common.cuh's
// rule): on a masked tile at each visible score, on an unmasked one as
// 8-byte pairs where the kv stride is 1, issued before the S product at
// D <= 64 (where the registers allow) so they arrive under it. At the MSA
// shape (1.07 GB of fp32 bias) that read bounds the kernel.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dstt_flash {

namespace {

using namespace dstt_hopper;

constexpr int BQ = 128, BKV = 128, WG_ROWS = 64;
constexpr int kConsumerWarps = 8;
constexpr int kThreads90 = 3 * 128;   // producer + two consumer warpgroups

template <int D>
struct Cfg {
  static constexpr int CB = D < 64 ? D : 64;          // columns of one swizzled block
  static constexpr int RB = CB * 2;                   // its row bytes
  static constexpr int NCB = D / CB;                  // column blocks of a tile
  static constexpr int SWZ = RB;                      // 128-byte (64-byte at D = 32) swizzle
  static constexpr int SBO = 8 * RB;                  // stride of 8-row groups
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int BAR_BYTES = 8 * (2 + 2 * STAGES);
  static constexpr size_t SMEM = 1024 + Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + BAR_BYTES;
};

// Planted faults for the tests (dstt_flash_fwd_sm90_plant): 1 reads the ring's
// stage one step late, 2 drops the last kv tile of the band. 0: none.
int g_plant = 0;

// The bias of a tile no mask touches, at this thread's 64 scores: rows
// roff[0], roff[1] (element offsets of the thread's two rows), columns c0 +
// 8 nt + {0, 1}. vec: kv stride 1 and even offsets, so each pair is one
// 8-byte (fp32) or 4-byte (bf16) load.
__device__ __forceinline__ void bias_tile(float (&bv)[64], const Bias& bb,
                                          const long long (&roff)[2], int c0, bool vec) {
  if (vec && bb.f32) {
    const float* p = static_cast<const float*>(bb.ptr);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float2 x =
          __ldg(reinterpret_cast<const float2*>(p + roff[(i >> 1) & 1] + c0 + 8 * (i >> 2)));
      bv[i] = x.x;
      bv[i + 1] = x.y;
    }
  } else if (vec) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(bb.ptr);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          p + roff[(i >> 1) & 1] + c0 + 8 * (i >> 2)));
      bv[i] = x.x;
      bv[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const long long at =
          roff[(i >> 1) & 1] + (long long)(c0 + 8 * (i >> 2) + (i & 1)) * bb.sk;
      bv[i] = bb.f32 ? __ldg(static_cast<const float*>(bb.ptr) + at)
                     : __bfloat162float(static_cast<const __nv_bfloat16*>(bb.ptr)[at]);
    }
  }
}

// 2^x by the special-function unit alone (subnormal in or out: 0). p below
// 2^-126 weighs nothing next to a row's max term of 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile's scores (s, this thread's 2 rows x 64 columns) through mask,
// scale, bias and the online softmax: s becomes p, m / l move on, alpha is
// the factor the accumulator must take. A masked tile reads the bias only at
// visible scores (bias_at); an unmasked one takes bv, its bias_tile.
template <bool BIAS, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const float (&bv)[64],
                                             const Args& a, const Bias& bb, int b, int h, int t,
                                             int rlo, int j0) {
  constexpr float kUnit = BIAS ? kLog2e : 1.f;
  const float sl2 = a.scale * kLog2e;
  float mx[2] = {-INFINITY, -INFINITY};
  if (!BIAS && !MASK && a.scale > 0.f) {
    // no bias, no mask: the row max of s, scaled once, and p = 2^(s sl2 - m)
    // as one FFMA and one exp2 per score
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
    for (int i = 0; i < 64; ++i) {
      s[i] = exp2_ftz(fmaf(s[i], sl2, -mu[(i >> 1) & 1]));
      ls[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(ls[r]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = rlo + acc_row(t, i), col = j0 + acc_col(t, i);
    float x;
    if (MASK && !visible(a, row, col)) {
      x = -INFINITY;
    } else if constexpr (BIAS) {
      x = s[i] * a.scale + (MASK ? bias_at(bb, b, h, row, col) : bv[i]);
    } else {
      x = s[i] * sl2;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float mu[2];   // the max subtracted: 0 for a row that has seen no key (its x are all -inf)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = mn == -INFINITY ? 1.f : exp2f((m[r] - mn) * kUnit);
    m[r] = mn;
    mu[r] = mn == -INFINITY ? 0.f : mn;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // bias: (x - m) first, so a row of -1e30 biases gets exactly 2^0 per key
    const float p = exp2_ftz(BIAS ? (s[i] - mu[(i >> 1) & 1]) * kUnit : s[i] - mu[(i >> 1) & 1]);
    s[i] = p;
    ls[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(ls[r]);
}

// Shared-memory addresses of one block's tiles and barriers.
template <int D>
struct Smem {
  uint32_t q, kv, q_full, q_empty, full0, empty0;
  __device__ explicit Smem(const void* raw) {
    using C = Cfg<D>;
    q = (smem_u32(raw) + 1023u) & ~1023u;    // swizzled tiles start on 1024-byte lines
    kv = q + C::Q_BYTES;                      // stage s: K at kv + 2 s KV_BYTES, V after it
    q_full = kv + C::STAGES * 2 * C::KV_BYTES;
    q_empty = q_full + 8;
    full0 = q_empty + 8;
    empty0 = full0 + 8 * C::STAGES;
  }
  __device__ uint32_t k(int s) const { return kv + s * 2 * Cfg<D>::KV_BYTES; }
  __device__ uint32_t v(int s) const { return k(s) + Cfg<D>::KV_BYTES; }
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};

// One work item: BQ q rows of one (batch, head) and the kv tiles they see.
// Items are numbered longest causal rows first, all heads of a q tile
// together.
struct Item {
  int b, h, q0, t_lo, n_tiles;
  __device__ Item(int w, const Args& a, int plant) {
    const int bh = w % (a.B * a.H), n_qt = (a.Sq + BQ - 1) / BQ;
    b = bh / a.H;
    h = bh % a.H;
    q0 = (n_qt - 1 - w / (a.B * a.H)) * BQ;
    int kv_lo = 0, kv_hi = a.Skv;   // the kv rows these q rows can see
    if (a.causal) {
      kv_hi = min(a.Skv, q0 + BQ + a.q_offset);
      if (a.window > 0) kv_lo = max(0, q0 + a.q_offset - a.window + 1);
    }
    t_lo = kv_lo / BKV;
    const int t_hi = (kv_hi + BKV - 1) / BKV - (plant == 2 ? 1 : 0);   // planted fault 2
    n_tiles = kv_hi > kv_lo ? max(0, t_hi - t_lo) : 0;
  }
};

__device__ __forceinline__ int n_items(const Args& a) {
  return (a.Sq + BQ - 1) / BQ * a.B * a.H;
}

// The item a block takes in its round k: rounds of gridDim.x items, dealt
// forward in even rounds and backward in odd ones, so the blocks' sums of
// causal lengths come out even (Llama-3-8B's 1024 items: 128 tiles at most
// a block, against 144 when every round is dealt forward).
__device__ __forceinline__ int item_of(int k) {
  const int g = gridDim.x, c = blockIdx.x;
  return k * g + ((k & 1) ? g - 1 - c : c);
}

// The producer's one thread: per item, Q (once the consumers are done with
// the last one), then its K / V tiles into the ring, whose stage and phase
// run on across items.
template <int D>
__device__ __forceinline__ void produce(const Smem<D>& sm, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const Args& a, int plant) {
  using C = Cfg<D>;
  tma_prefetch_map(tm_q);
  tma_prefetch_map(tm_k);
  tma_prefetch_map(tm_v);
  int it = 0;   // kv tiles loaded so far
  for (int n = 0; item_of(n) < n_items(a); ++n) {
    const Item item(item_of(n), a, plant);
    const int hk = item.h / (a.H / a.Hkv);
    if (n > 0) mbar_wait(sm.q_empty, (n - 1) & 1);
    mbar_expect_tx(sm.q_full, C::Q_BYTES);
    for (int c = 0; c < C::NCB; ++c)
      tma_load_4d(sm.q + c * BQ * C::RB, tm_q, sm.q_full, c * C::CB, item.h, item.q0, item.b);
    for (int i = 0; i < item.n_tiles; ++i, ++it) {
      const int s = it % C::STAGES;
      if (it >= C::STAGES) mbar_wait(sm.empty(s), (it / C::STAGES - 1) & 1);
      const int j0 = (item.t_lo + i) * BKV;
      mbar_expect_tx(sm.full(s), 2 * C::KV_BYTES);
      for (int c = 0; c < C::NCB; ++c) {
        tma_load_4d(sm.k(s) + c * BKV * C::RB, tm_k, sm.full(s), c * C::CB, hk, j0, item.b);
        tma_load_4d(sm.v(s) + c * BKV * C::RB, tm_v, sm.full(s), c * C::CB, hk, j0, item.b);
      }
    }
  }
}

// O += P V for one kv tile: P (this warpgroup's 64 rows x BKV, bf16) in
// registers, V at sv read as the transposed B operand.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BKV / 4],
                                         uint32_t sv) {
  using C = Cfg<D>;
#pragma unroll
  for (int kt = 0; kt < BKV / 16; ++kt) {
    const uint64_t dv = smem_desc(sv + kt * 16 * C::RB, BKV * C::RB, C::SBO, C::SWZ);
    if constexpr (D == 128)
      wgmma_rs_n128(o, pa[4 * kt], pa[4 * kt + 1], pa[4 * kt + 2], pa[4 * kt + 3], dv, 1);
    else if constexpr (D == 64)
      wgmma_rs_n64(o, pa[4 * kt], pa[4 * kt + 1], pa[4 * kt + 2], pa[4 * kt + 3], dv, 1);
    else
      wgmma_rs_n32(o, pa[4 * kt], pa[4 * kt + 1], pa[4 * kt + 2], pa[4 * kt + 3], dv, 1);
  }
}

// A consumer warpgroup (cw 0 or 1: q rows q0 + 64 cw .. of each item). Per
// kv tile i, in its turn on the tensor cores, it issues S(i) = Q K(i)^T and
// O += P(i-1) V(i-1) as two commit groups and hands the turn to the other
// warpgroup; then the softmax of S(i) runs while P(i-1) V(i-1) may still be
// in flight, and O takes its rescale once that product is done. So one
// warpgroup's products overlap the other's softmax (the turns are named
// barriers 1 and 2), and a stage is released once P V has read its V. Q is
// released after an item's last S, so the producer loads the next item's Q
// and first tiles while this one's last P V and epilogue run.
template <int D, bool BIAS>
__device__ __forceinline__ void consume(const Smem<D>& sm, const Args& a, const Bias& bb,
                                        bool bias_vec, int cw, int plant) {
  using C = Cfg<D>;
  constexpr int kTurn = 1;   // named barriers kTurn + cw
  // a bias tile in flight across the S product needs 64 more registers: at
  // D = 128 they are not there (o, S and P already hold 160)
  constexpr bool kEarlyBias = D <= 64;
  const int t = threadIdx.x % 128, lane = t & 31;
  const uint32_t sQw = sm.q + cw * WG_ROWS * C::RB;       // this warpgroup's 64 Q rows
  int it = 0;                                             // kv tiles consumed so far

  for (int n = 0; item_of(n) < n_items(a); ++n) {
    const Item item(item_of(n), a, plant);
    const int b = item.b, h = item.h, rlo = item.q0 + cw * WG_ROWS;   // first row here
    const int r0 = rlo + acc_row(t, 0);                   // this thread's rows r0, r0 + 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    long long roff[2];   // the bias's element offset of this thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r)
      roff[r] = (long long)b * bb.sb + (long long)h * bb.sh + (long long)(r0 + 8 * r) * bb.sq;
    uint32_t pa[BKV / 4];   // P(i-1) as bf16, the A operand: k16 step kt in pa[4 kt .. +3]
    int prev = 0, prev_read = 0;   // the previous tile's stage, and the one its V is read from

    // Every wgmma is issued on a condition that is the same for all threads
    // (the tile index), never on a warpgroup's own rows: ptxas serialises
    // wgmma that sits on a divergent path. A tile none of this warpgroup's
    // rows sees is computed all the same and masked whole.
    mbar_wait(sm.q_full, n & 1);
    if (cw == 1 && item.n_tiles > 0) named_bar_arrive(kTurn, 256);   // warpgroup 0 first
    for (int i = 0; i < item.n_tiles; ++i, ++it) {
      const int s = it % C::STAGES;
      const int j0 = (item.t_lo + i) * BKV;
      const int sr = plant == 1 && i > 0 ? (it - 1) % C::STAGES : s;   // planted fault 1
      bool mask = j0 + BKV > a.Skv || rlo + WG_ROWS > a.Sq;
      if (a.causal)
        mask = mask || j0 + BKV - 1 > rlo + a.q_offset ||
               (a.window > 0 && rlo + WG_ROWS - 1 + a.q_offset - j0 >= a.window);
      float bv[64];   // the bias of an unmasked tile, loaded while K and S are on their way
      if (BIAS && kEarlyBias && !mask) bias_tile(bv, bb, roff, j0 + 2 * (t & 3), bias_vec);
      mbar_wait(sm.full(s), (it / C::STAGES) & 1);

      float sacc[64];
      named_bar_sync(kTurn + cw, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk * 16 / C::CB, in_row = (kk * 16 % C::CB) * 2;
        wgmma_ss_n128(sacc, smem_desc(sQw + cb * BQ * C::RB + in_row, 16, C::SBO, C::SWZ),
                      smem_desc(sm.k(sr) + cb * BKV * C::RB + in_row, 16, C::SBO, C::SWZ),
                      kk > 0);
      }
      wgmma_commit();
      if (i > 0) issue_pv<D>(o, pa, sm.v(prev_read));
      wgmma_commit();
      named_bar_arrive(kTurn + 1 - cw, 256);

      float alpha[2];
      wgmma_wait<1>();   // S(i) is done; P(i-1) V(i-1) may still run
      fence_regs(sacc);
      if (mask) {
        softmax_tile<BIAS, true>(sacc, m, l, alpha, bv, a, bb, b, h, t, rlo, j0);
      } else {
        if (BIAS && !kEarlyBias) bias_tile(bv, bb, roff, j0 + 2 * (t & 3), bias_vec);
        softmax_tile<BIAS, false>(sacc, m, l, alpha, bv, a, bb, b, h, t, rlo, j0);
      }
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (i > 0 && lane == 0) mbar_arrive(sm.empty(prev));
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int j = 0; j < BKV / 4; ++j) pa[j] = pack_bf16(sacc[2 * j], sacc[2 * j + 1]);
      prev = s;
      prev_read = sr;
    }
    // warpgroup 1's last hand-over has no turn after it: warpgroup 0 takes it
    // here, before it lets the next item's Q in (so warpgroup 1 cannot arrive
    // for the next item first), and both barriers end the item balanced
    if (cw == 0 && item.n_tiles > 0) named_bar_sync(kTurn, 256);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.q_empty);   // every S of this item has read Q
    if (item.n_tiles > 0) {
      wgmma_fence();
      issue_pv<D>(o, pa, sm.v(prev_read));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(prev));
    }

    // epilogue: o / l from registers, rows at or past Sq not written
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
    const size_t qstride = (size_t)a.H * D;
    const int bh = b * a.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= a.Sq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / l_safe;
      if ((t & 3) == 0)
        a.lse_out[(size_t)bh * a.Sq + row] =
            (m[r] == -INFINITY ? kNegInf : (BIAS ? m[r] : m[r] * kLn2)) + logf(l_safe);
      __nv_bfloat16* orow = out + ((size_t)b * a.Sq + row) * qstride + (size_t)h * D;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4)   // registers i, i + 1 of this row
        *reinterpret_cast<__nv_bfloat162*>(orow + acc_col(t, i)) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
  }
}

// A persistent kernel: one block per SM (at most one per item) walks the
// items; see produce / consume.
template <int D, bool BIAS>
__global__ void __launch_bounds__(kThreads90, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Args a, const Bias bb,
                          const int bias_vec, const int plant) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    mbar_init(sm.q_empty, kConsumerWarps);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    setmaxnreg_inc<240>();
    // the warpgroup index broadcast from lane 0, so the compiler knows it is
    // the same across each warp: branches on it are then not divergent, and
    // ptxas keeps the wgmma after them asynchronous
    const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
    consume<D, BIAS>(sm, a, bb, bias_vec != 0, cw, plant);
  } else {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce<D>(sm, &tm_q, &tm_k, &tm_v, a, plant);
  }
}

template <int D, bool BIAS>
cudaError_t launch_sm90(const Args& a, const Bias& bb, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = bhsd_map(&tq, a.q, a.B, a.Sq, a.H, D, BQ, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tk, a.k, a.B, a.Skv, a.Hkv, D, BKV, C::CB, C::SWZ);
  if (err == cudaSuccess) err = bhsd_map(&tv, a.v, a.B, a.Skv, a.Hkv, D, BKV, C::CB, C::SWZ);
  if (err == cudaSuccess) err = allow_smem(flash_fwd_sm90_kernel<D, BIAS>, C::SMEM);
  if (err != cudaSuccess) return err;
  // bias pairs as one load: kv stride 1, even offsets, an aligned base
  const int bias_vec = bb.sk == 1 && bb.sb % 2 == 0 && bb.sh % 2 == 0 && bb.sq % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(bb.ptr) % (bb.f32 ? 8 : 4) == 0;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((a.Sq + BQ - 1) / BQ) * a.B * a.H;
  const int grid = (int)(items < sms ? items : sms);
  flash_fwd_sm90_kernel<D, BIAS><<<grid, kThreads90, C::SMEM, stream>>>(tq, tk, tv, a, bb,
                                                                         bias_vec, g_plant);
  return cudaGetLastError();
}

template <bool BIAS>
cudaError_t launch_sm90_d(const Args& a, const Bias& bb, int D, cudaStream_t s) {
  if (D == 128) return launch_sm90<128, BIAS>(a, bb, s);
  if (D == 64) return launch_sm90<64, BIAS>(a, bb, s);
  if (D == 32) return launch_sm90<32, BIAS>(a, bb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The bf16 forward (flash_fwd.cu's dstt_flash_fwd routes here). TMA needs
// 16-byte aligned q, k, v; the wrapper checks it first and raises.
cudaError_t flash_fwd_sm90(const Args& a, const Bias& bb, int D, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) % 16)
    return cudaErrorMisalignedAddress;
  return bb.ptr ? launch_sm90_d<true>(a, bb, D, s) : launch_sm90_d<false>(a, bb, D, s);
}

}  // namespace dstt_flash

// Plants a fault in the next launches (tests only): 1 reads the ring's
// stage one step late, 2 drops the last kv tile of the band, 0 none.
extern "C" int dstt_flash_fwd_sm90_plant(int fault) {
  dstt_flash::g_plant = fault;
  return 0;
}
