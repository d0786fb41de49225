// Paged attention over the block-table KV pools for Hopper (sm_90a): one-token
// decode and fused speculative verification, bf16 or fp16 pools (of q's
// type) or int8 code pools with fp32 scales. The element type T of q and
// out, bf16 or fp16, is a template parameter: it picks the mma.sync type and
// the rounding of P (and, at ng > 1, of code x scale); nothing else moves.
//
// Replaces, in deepspeed_tpu/ops/pallas/paged_attention.py:
// - `_decode_kernel` (:74; pallas_call :230, op `paged_decode_attention`) in
//   its bf16 mode and its int8 mode (`quant=True`, `_dequant_tile` :58):
//   the t = 1 case of the kernel below;
// - `_spec_verify_kernel` (:315; pallas_call :469, op
//   `paged_spec_verify_attention`) in both modes.
// Row ti of sequence b sits at position ctx+ti and attends the positions
// <= ctx+ti of its K/V, read straight out of the pools through the block
// table (with a window w only those > ctx+ti-w). An inactive slot (ctx 0,
// trash block 0) attends position 0; a row that sees nothing writes 0.
//
//   q            [B, t, nh, hd]              bf16 or fp16 (decode: t = 1)
//   k/v pool     [num_blocks, nkv, bs, hd]   q's type, or int8 codes (ng > 0)
//   k/v scale    [num_blocks, nkv, bs, ng]   fp32: element d of a row is
//                code * scale[d / (hd / ng)]
//   block_tables [B, max_blocks]             int32
//   context_lens [B]                         int32
//   window       none, a static int >= 1, or a 0-d int32 device tensor
//                (clamped to >= 1)
//   out          like q
//
// Bound on an H100 SXM: memory. The least traffic is the K and V rows (and
// scale rows) of the positions some row can see, read once, plus q and out:
// 512 bytes per position and kv head in bf16 at hd 128, 264 in int8 at
// ng 1, against 3.35 TB/s. The products are 4 flops per (query row,
// position, dim), 20 flop per byte of bf16 K/V at g*t = 20 rows: on tensor
// cores far under the ridge (~295), on fp32 CUDA cores at it.
//
// Design.
// - Work items: (sequence, split, kv head, row tile), one warp each. A
//   sequence's live positions [max(ctx-w+1, 0), min(ctx+t, cap)) are cut
//   into splits of whole 16-position subtiles: 4 subtiles at least (short
//   sequences spread over more warps), 32 at most, about 8 splits between
//   (so the merge stays short). The g*t query rows of a kv head (g-major,
//   t-minor, as the TPU kernel folds them) go in tiles of 16, the M of
//   `mma.sync.m16n8k16`, so decode's g = 4 pads to 16 and any g or g*t runs
//   (Falcon-7B's 71 heads over one kv head; 355 verify rows at t = 5).
//   Shared memory does not grow with the rows.
// - The grid is persistent: the blocks an SM holds at once, on every SM
//   (or fewer, if fewer items can exist). Each block derives the work list
//   from the context lengths on the device (a prefix sum of splits over
//   the sequences); its warps walk items i, i + 4 * grid, ..., item i
//   going to warp i / grid of block i % grid. The host never reads ctx.
// - Each warp streams its split 16 positions at a time through its own
//   ring of stages filled by 16-byte `cp.async` copies (zero-filled past
//   the split's end). The copies' rows come from the block table, loaded
//   two subtiles ahead into registers. No barrier beyond the warp's own sits
//   between loads, scores, softmax and P.V.
// - Products on tensor cores: S = Q K^T and O += P V by
//   `mma.sync.m16n8k16` T -> fp32. The Q fragments stay in registers
//   for the whole item; 16-bit K comes through `ldmatrix`, V through
//   `ldmatrix.trans`. int8 codes stay int8 in shared memory (half the bytes)
//   and become T on the way into the fragments (exact, |code| <= 127):
//   K through `ldmatrix` of int8 pairs (4 codes of one position; the
//   product's k order within 16 dims is permuted, Q's fragments with it),
//   V through `ldmatrix.trans` of int8 pairs (two positions x two dims; the
//   output dims of each 16 are dealt even / odd to two n8 tiles). At ng = 1
//   the K scale multiplies its position's score and the V scale its
//   probability; at ng > 1 code x scale is rounded to T before the
//   product, as `_dequant_tile` does.
// - fp32 online softmax (in base 2); P is rounded to T before P.V, as the
//   TPU kernel's `p.astype(v.dtype)`; l sums the unrounded p. The
//   accumulator stays in registers.
// - A sequence of one split writes its rows. Otherwise each split writes
//   its fp32 partials (m, l, acc) to scratch, takes a ticket from a
//   per-(sequence, kv head, row tile) counter after a __threadfence, and
//   the last split to arrive merges all of them in split order
//   (deterministic: no atomics on values) and resets the counter to 0 for
//   the next call. One launch per call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using dstt_flash::cp_async_commit;
using dstt_flash::cp_async_wait;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 16;            // positions a warp takes at a time (a subtile)
constexpr int kRows = 16;           // query rows of a row tile (the mma's M)
constexpr int kMinSubs = 4;         // subtiles of a split: at least,
constexpr int kMaxSubs = 32;        // at most,
constexpr int kTargetSplits = 8;    // and splits of a sequence in between
constexpr int kSeqChunk = 512;      // sequences per grid row
constexpr size_t kMaxSmem = 232448;

// Planted faults for the tests (dstt_paged_sm90_plant): 1 drops the last
// split from the merge; 2 reads each subtile from the ring stage after its
// own (whose copy has not been waited for); 3 leaves the K scale out at
// ng = 1. 0: none.
int g_plant = 0;

// q and out hold 16-bit elements of the kernel's T (bf16 or fp16); the
// kernel reads and writes them as raw 32- and 64-bit words.
struct Args {
  const __nv_bfloat16* q;
  const char* k_pool;
  const char* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* ctx_lens;
  const int* window_ptr;
  int window_static;
  __nv_bfloat16* out;
  int* counters;        // [B, nkv, row tiles], 0 between calls
  float* partials;      // [B, nsplit, nkv, R, hd] acc, then [B, nsplit, nkv, R, 2] m, l
  int B, t, nh, nkv, bs, num_blocks, max_blocks, ng, nsplit;
  float scale_log2;     // softmax scale * log2(e)
};

template <int HD, bool QUANT>
struct Cfg {
  static constexpr int ESZ = QUANT ? 1 : 2;
  static constexpr int RB = HD * ESZ;             // bytes of a K/V row
  static constexpr int CPR = RB / 16;             // 16-byte chunks per row
  static constexpr int ROWB = RB + 16;            // a row in shared memory (16 bytes of
                                                  // padding: ldmatrix rows on distinct banks)
  static constexpr int NGMAX = HD / 16;
  static constexpr int KV = kSub * ROWB;          // K (or V) rows of one stage
  static constexpr int SC = QUANT ? kSub * NGMAX * 4 : 0;   // K (or V) scale rows
  static constexpr int STAGE = 2 * KV + 2 * SC;
  static constexpr int STAGES = QUANT ? 3 : 2;    // ring stages per warp
  static constexpr int RING = STAGES * STAGE;     // a warp's region
  static constexpr int NT = HD / 8;               // n8 tiles of the accumulator
  static constexpr size_t SMEM = (size_t)kWarps * RING + (2 * kSeqChunk + 5) * 4;
  // the merge stages at least one split's partials (16 rows) in the ring
  static_assert(RING >= (kRows * HD + kRows) * 4, "ring too small for the merge");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a * b: m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The element type T of q, out and 16-bit pools (bf16 or fp16): its
// m16n8k16 product (fp32 accumulator) and its packing of two fp32 values
// (lo in the low half, rounded to nearest; fp16 past 65504: inf). The bf16
// members are mma and pack above.
template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    ::mma(c, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return ::pack(lo, hi); }
};
template <> struct Elem<__half> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// byte k of a word of int8 codes, the word's sign bits flipped first
// (x = w ^ 0x80808080), as an exact float: 2^23 + (code + 128) - (2^23 + 128)
__device__ __forceinline__ float code_at(uint32_t x, int k) {
  return __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + k)) - 8388736.f;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The live positions of a sequence: [lo, hi).
__device__ __forceinline__ void live_range(int ctx, int t, int cap, bool has_w, int w, int& lo,
                                           int& hi) {
  lo = has_w ? max(ctx - w + 1, 0) : 0;
  hi = min(ctx + t, cap);
}

// How a sequence of `len` live positions is split: subtiles (of kSub) per
// split, and splits. Short sequences take splits of kMinSubs subtiles, so
// their few positions still spread over warps; long ones kTargetSplits
// splits, up to kMaxSubs subtiles each, so the merge stays short.
__device__ __forceinline__ int subs_per_split(int len) {
  const int nsub = (max(len, 0) + kSub - 1) / kSub;
  return min(kMaxSubs, max(kMinSubs, (nsub + kTargetSplits - 1) / kTargetSplits));
}

__device__ __forceinline__ int splits_of(int len) {
  const int nsub = (max(len, 0) + kSub - 1) / kSub, sps = subs_per_split(len);
  return max(1, (nsub + sps - 1) / sps);
}

template <typename T, int HD, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_sm90_kernel(const Args a, const int plant) {
  using C = Cfg<HD, QUANT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;   // the mma fragments' row and column group
  unsigned char* wreg = smem + warp * C::RING;
  int* start_s = reinterpret_cast<int*>(smem + kWarps * C::RING);   // [kSeqChunk + 1]
  int* ctx_s = start_s + kSeqChunk + 1;                               // [kSeqChunk]
  int* misc_s = ctx_s + kSeqChunk;                                    // [4]

  const int b0 = blockIdx.y * kSeqChunk;
  const int nb = min(kSeqChunk, a.B - b0);
  const int cap = a.max_blocks * a.bs;
  const bool has_w = a.window_ptr != nullptr || a.window_static > 0;
  int w = 0;
  if (has_w) w = max(a.window_ptr != nullptr ? *a.window_ptr : a.window_static, 1);
  const int g = a.nh / a.nkv, R = g * a.t, RT = (R + kRows - 1) / kRows;

  // splits of this chunk's sequences and their exclusive prefix sums: each
  // thread sums a run of sequences, the runs are scanned across the block
  const int per = (nb + kThreads - 1) / kThreads;
  const int r_lo = min(nb, tid * per), r_hi = min(nb, r_lo + per);
  int run = 0;
  for (int i = r_lo; i < r_hi; ++i) {
    const int c = a.ctx_lens[b0 + i];
    ctx_s[i] = c;
    int lo, hi;
    live_range(c, a.t, cap, has_w, w, lo, hi);
    run += splits_of(hi - lo);
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) misc_s[warp] = incl;
  __syncthreads();
  int excl = incl - run;
  for (int ww = 0; ww < warp; ++ww) excl += misc_s[ww];
  const int total = misc_s[0] + misc_s[1] + misc_s[2] + misc_s[3];
  for (int i = r_lo; i < r_hi; ++i) {
    start_s[i] = excl;
    int lo, hi;
    live_range(ctx_s[i], a.t, cap, has_w, w, lo, hi);
    excl += splits_of(hi - lo);
  }
  if (tid == 0) start_s[nb] = total;
  __syncthreads();

  // each warp walks its own items: (split, kv head, row tile), row tile
  // fastest; consecutive items go to consecutive blocks first, so a few
  // long sequences spread over the SMs
  const int n_items = total * a.nkv * RT;   // < 2^31: the wrapper bounds it
  const uint32_t ring = smem_u32(wreg);
  const int mi = lane >> 3, r8 = lane & 7;   // the ldmatrix address a lane gives
  for (int item = warp * gridDim.x + blockIdx.x; item < n_items; item += gridDim.x * kWarps) {
    const int rt = item % RT, rest = item / RT;
    const int h = rest % a.nkv, si = rest / a.nkv;
    int bl = 0, bh = nb - 1;   // the sequence: the last with start_s[bl] <= si
    while (bl < bh) {
      const int mid = (bl + bh + 1) >> 1;
      if (start_s[mid] <= si) bl = mid; else bh = mid - 1;
    }
    const int b = b0 + bl;
    const int s = si - start_s[bl], ns = start_s[bl + 1] - start_s[bl];
    const int ctx = ctx_s[bl];
    int lo, hi;
    live_range(ctx, a.t, cap, has_w, w, lo, hi);
    const int span = kSub * subs_per_split(hi - lo);
    const int p0 = lo + s * span;
    const int n = max(0, min(p0 + span, hi) - p0);
    const int cnt = (n + kSub - 1) / kSub;

    // the pool row of this lane's position (lane & 15) of subtile k, or -1
    // past the split's end; loaded two subtiles ahead of its copy
    const int* table = a.tables + (size_t)b * a.max_blocks;
    auto row_of = [&](int k) -> int {
      const int i = k * kSub + (lane & 15);
      if (i >= n) return -1;
      const int p = p0 + i, j = p / a.bs;
      int blk = __ldg(table + j);
      blk = blk < 0 ? 0 : (blk >= a.num_blocks ? a.num_blocks - 1 : blk);
      return (blk * a.nkv + h) * a.bs + (p - j * a.bs);
    };
    int row_q0 = row_of(0), row_q1 = row_of(1);
    auto issue = [&](int k) {   // subtile k into stage k % STAGES
      const int row = row_q0;
      row_q0 = row_q1;
      row_q1 = row_of(k + 2);
      const uint32_t st = ring + (k % C::STAGES) * C::STAGE;
#pragma unroll
      for (int e = 0; e < kSub * C::CPR / 32; ++e) {
        const int c = lane + 32 * e;
        const int r = c / C::CPR, cc = c % C::CPR;
        const int pr = __shfl_sync(0xffffffffu, row, r);
        const size_t off = (size_t)(pr < 0 ? 0 : pr) * C::RB + cc * 16;
        cp16(st + r * C::ROWB + cc * 16, a.k_pool + off, pr >= 0);
        cp16(st + C::KV + r * C::ROWB + cc * 16, a.v_pool + off, pr >= 0);
      }
      if constexpr (QUANT) {
        for (int c0 = 0; c0 < kSub * a.ng; c0 += 32) {   // warp-uniform trip count
          const int c = c0 + lane;
          const int r = min(c / a.ng, kSub - 1), gg = c - r * a.ng;
          const int pr = __shfl_sync(0xffffffffu, row, r);
          const bool ok = c < kSub * a.ng && pr >= 0;
          const size_t off = (size_t)(pr < 0 ? 0 : pr) * a.ng + (ok ? gg : 0);
          if (c < kSub * a.ng) {
            cp4(st + 2 * C::KV + (r * C::NGMAX + gg) * 4, a.k_scale + off, ok);
            cp4(st + 2 * C::KV + C::SC + (r * C::NGMAX + gg) * 4, a.v_scale + off, ok);
          }
        }
      }
      cp_async_commit();
    };

    // Q fragments of rows rt*16 + g4 and + 8 (rows past R read 0 and see
    // nothing). int8 mode: the k order within 16 dims is permuted to match
    // K's fragments (k 2c+e <-> dim 4c+e, k 2c+8+e <-> dim 4c+2+e).
    uint32_t qa[HD / 16][4];
    int vis_hi[2], vis_lo[2];   // rows' visible positions (vis_lo, vis_hi]
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = rt * kRows + g4 + 8 * e2;
      const __nv_bfloat16* qr = nullptr;
      vis_hi[e2] = -1;
      vis_lo[e2] = -1;
      if (r < R) {
        const int gi = r / a.t, ti = r - gi * a.t;
        qr = a.q + (((size_t)b * a.t + ti) * a.nh + (size_t)h * g + gi) * HD;
        const int lim = ctx + ti;
        vis_hi[e2] = min(lim, p0 + n - 1);
        vis_lo[e2] = has_w ? lim - w : -1;
      }
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int c0 = ks * 16 + (QUANT ? 4 * c4 : 2 * c4);
        qa[ks][e2] = qr ? ld32(qr + c0) : 0u;                          // a0 / a1
        qa[ks][2 + e2] = qr ? ld32(qr + c0 + (QUANT ? 2 : 8)) : 0u;    // a2 / a3
      }
    }

#pragma unroll
    for (int k = 0; k < C::STAGES - 1; ++k) {
      if (k < cnt) issue(k); else cp_async_commit();
    }

    float acc[C::NT][4];
#pragma unroll
    for (int i = 0; i < C::NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    // S = Q K^T over a subtile's 16 positions (stage sidx): n8 tiles 0
    // (positions 0-7) and 1 (8-15); even and odd k-steps accumulate apart
    // (two short dependency chains per n8 tile instead of one long one)
    auto scores = [&](int sidx, float (&sc)[2][4]) {
      const uint32_t st = ring + sidx * C::STAGE;
      const float* ksc = reinterpret_cast<const float*>(wreg + sidx * C::STAGE + 2 * C::KV);
      float sc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (!QUANT) {
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t r[4];   // positions 0-7 / 8-15 (mi / 2), dims 0-7 / 8-15 (mi % 2)
          ldsm_x4(st + ((mi >> 1) * 8 + r8) * C::ROWB + ks * 32 + (mi & 1) * 16, r);
          Elem<T>::mma((ks & 1) ? sc2[0] : sc[0], qa[ks], r[0], r[1]);
          Elem<T>::mma((ks & 1) ? sc2[1] : sc[1], qa[ks], r[2], r[3]);
        }
      } else {
        const bool grouped = a.ng > 1;
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {
          uint32_t r[4];   // positions 0-7 / 8-15 (mi % 2), k-steps 2kk / 2kk+1 (mi / 2)
          ldsm_x4(st + ((mi & 1) * 8 + r8) * C::ROWB + (2 * kk + (mi >> 1)) * 16, r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = j & 1, kstep = 2 * kk + (j >> 1);
            const uint32_t x = r[j] ^ 0x80808080u;   // 4 codes of position nt*8 + g4
            float f0 = code_at(x, 0), f1 = code_at(x, 1), f2 = code_at(x, 2), f3 = code_at(x, 3);
            if (grouped) {
              const float sk = ksc[(nt * 8 + g4) * C::NGMAX + kstep * 16 * a.ng / HD];
              f0 *= sk; f1 *= sk; f2 *= sk; f3 *= sk;
            }
            Elem<T>::mma((kstep & 1) ? sc2[nt] : sc[nt], qa[kstep], Elem<T>::pack(f0, f1),
                         Elem<T>::pack(f2, f3));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] += sc2[nt][e];
    };
    // O += P V over a subtile (stage sidx), P the A fragment of T
    auto pv = [&](int sidx, const uint32_t (&pa)[4]) {
      const uint32_t st = ring + sidx * C::STAGE;
      const float* vsc = reinterpret_cast<const float*>(wreg + sidx * C::STAGE + 2 * C::KV) + C::SC / 4;
      if constexpr (!QUANT) {
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
          uint32_t r[4];   // positions 0-7 / 8-15 (mi % 2), dims dd*16 + 0-7 / 8-15 (mi / 2)
          ldsm_x4_t(st + C::KV + ((mi & 1) * 8 + r8) * C::ROWB + dd * 32 + (mi >> 1) * 16, r);
          Elem<T>::mma(acc[2 * dd], pa, r[0], r[1]);
          Elem<T>::mma(acc[2 * dd + 1], pa, r[2], r[3]);
        }
      } else {
        const bool grouped = a.ng > 1;
#pragma unroll
        for (int dq = 0; dq < HD / 32; ++dq) {
          uint32_t r[4];   // positions 0-7 / 8-15 (mi % 2), dims dq*32 + 0-15 / 16-31 (mi / 2)
          ldsm_x4_t(st + C::KV + ((mi & 1) * 8 + r8) * C::ROWB + dq * 32 + (mi >> 1) * 16, r);
#pragma unroll
          for (int half = 0; half < 2; ++half) {   // dims dq*32 + half*16 + 0..15
            const int gq = 2 * dq + half;
            uint32_t be[2], bo[2];   // even / odd dims; k = positions 0-7 (0), 8-15 (1)
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              // bytes: (pos 2c4, dim 2g4), (2c4, 2g4+1), (2c4+1, 2g4), (2c4+1, 2g4+1)
              const uint32_t x = r[2 * half + kh] ^ 0x80808080u;
              float f0 = code_at(x, 0), f1 = code_at(x, 1), f2 = code_at(x, 2), f3 = code_at(x, 3);
              if (grouped) {
                const int grp = gq * 16 * a.ng / HD, pp = kh * 8 + 2 * c4;
                const float s0 = vsc[pp * C::NGMAX + grp], s1 = vsc[(pp + 1) * C::NGMAX + grp];
                f0 *= s0; f1 *= s0; f2 *= s1; f3 *= s1;
              }
              be[kh] = Elem<T>::pack(f0, f2);
              bo[kh] = Elem<T>::pack(f1, f3);
            }
            Elem<T>::mma(acc[2 * gq], pa, be[0], be[1]);
            Elem<T>::mma(acc[2 * gq + 1], pa, bo[0], bo[1]);
          }
        }
      }
    };

    // software-pipelined walk: the scores of subtile k go out before the
    // P V products of subtile k - 1, so the two overlap and the softmax of
    // k waits on neither for long; the copy of subtile k + STAGES - 1 goes
    // into the stage P V (k - 1) has just read
    uint32_t pa[4] = {0u, 0u, 0u, 0u};
    int prev = 0;   // the stage of subtile k - 1
    for (int k = 0; k < cnt; ++k) {
      cp_async_wait<C::STAGES - 2>();
      __syncwarp();
      const int sidx = (plant == 2 ? k + 1 : k) % C::STAGES;   // planted fault 2
      const float* ksc = reinterpret_cast<const float*>(wreg + sidx * C::STAGE + 2 * C::KV);
      const float* vsc = ksc + C::SC / 4;
      const int pbase = p0 + k * kSub;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      scores(sidx, sc);
      if (k > 0) pv(prev, pa);
      __syncwarp();
      if (k + C::STAGES - 1 < cnt) issue(k + C::STAGES - 1); else cp_async_commit();

      // scale, mask, online softmax; this lane holds rows g4 (e2 = 0) and
      // g4 + 8 (e2 = 1), positions nt*8 + 2*c4 + e
      float prob[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + 2 * c4 + e, pos = pbase + col;
            float v = sc[nt][2 * e2 + e];
            if constexpr (QUANT) {
              if (a.ng == 1 && plant != 3) v *= ksc[col * C::NGMAX];   // planted fault 3
            }
            v *= a.scale_log2;
            v = (pos <= vis_hi[e2] && pos > vis_lo[e2]) ? v : -INFINITY;
            sc[nt][2 * e2 + e] = v;
            mx = fmaxf(mx, v);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[e2], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;   // nothing visible yet
        const float alpha = exp2f(m_run[e2] - m_use);
        m_run[e2] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[nt][2 * e2 + e] - m_use);
            sum += p;
            float pw = p;
            if constexpr (QUANT) {
              if (a.ng == 1) pw *= vsc[(nt * 8 + 2 * c4 + e) * C::NGMAX];
            }
            prob[nt][2 * e2 + e] = pw;
          }
        }
        l_run[e2] = l_run[e2] * alpha + sum;
#pragma unroll
        for (int i = 0; i < C::NT; ++i) {
          acc[i][2 * e2] *= alpha;
          acc[i][2 * e2 + 1] *= alpha;
        }
      }
      // P (of T) as the A fragment of P V: k = positions 0-15
      pa[0] = Elem<T>::pack(prob[0][0], prob[0][1]);
      pa[1] = Elem<T>::pack(prob[0][2], prob[0][3]);
      pa[2] = Elem<T>::pack(prob[1][0], prob[1][1]);
      pa[3] = Elem<T>::pack(prob[1][2], prob[1][3]);
      prev = sidx;
    }
    if (cnt > 0) pv(prev, pa);
    cp_async_wait<0>();
    __syncwarp();

    // the split's result: l summed over the quad; this lane's 4 values of
    // row g4 + 8*e2 at dims d .. d+3 (bf16: tiles 2q, 2q+1 hold d = 16q +
    // 2*c4 and + 8, two values each, so a lane's values come in pairs)
    float lsum[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float l = l_run[e2];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      lsum[e2] = l;
    }
    const int nrows = min(kRows, R - rt * kRows);
    auto out_row = [&](int r) -> __nv_bfloat16* {   // r < nrows: row rt*16 + r's output
      const int rr = rt * kRows + r, gi = rr / a.t, ti = rr - gi * a.t;
      return a.out + (((size_t)b * a.t + ti) * a.nh + (size_t)h * g + gi) * HD;
    };
    if (ns == 1) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = g4 + 8 * e2;
        if (r < nrows) {
          const float inv = 1.f / (lsum[e2] == 0.f ? 1.f : lsum[e2]);
          __nv_bfloat16* dst = out_row(r);
#pragma unroll
          for (int q = 0; q < HD / 16; ++q) {
            const float* x0 = acc[2 * q];
            const float* x1 = acc[2 * q + 1];
            if constexpr (QUANT) {   // dims 16q + 4*c4 + 0..3: even tile, odd tile
              uint2 u;
              u.x = Elem<T>::pack(x0[2 * e2] * inv, x1[2 * e2] * inv);
              u.y = Elem<T>::pack(x0[2 * e2 + 1] * inv, x1[2 * e2 + 1] * inv);
              *reinterpret_cast<uint2*>(dst + 16 * q + 4 * c4) = u;
            } else {                 // dims 16q + 2*c4 + 0..1 and + 8
              *reinterpret_cast<uint32_t*>(dst + 16 * q + 2 * c4) =
                  Elem<T>::pack(x0[2 * e2] * inv, x0[2 * e2 + 1] * inv);
              *reinterpret_cast<uint32_t*>(dst + 16 * q + 8 + 2 * c4) =
                  Elem<T>::pack(x1[2 * e2] * inv, x1[2 * e2 + 1] * inv);
            }
          }
        }
      }
      continue;
    }

    // more than one split: this split's fp32 partials, then a ticket
    const size_t n_part = (size_t)a.B * a.nsplit * a.nkv * R;
    float* pacc = a.partials;
    float* pml = a.partials + n_part * HD;
    const size_t row0 = (((size_t)b * a.nsplit) * a.nkv + h) * R + (size_t)rt * kRows;
    const size_t sstride = (size_t)a.nkv * R;   // from one split to the next
    {
      const size_t mine = row0 + (size_t)s * sstride;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = g4 + 8 * e2;
        if (r < nrows) {
          float* dst = pacc + (mine + r) * HD;
#pragma unroll
          for (int q = 0; q < HD / 16; ++q) {
            const float* x0 = acc[2 * q];
            const float* x1 = acc[2 * q + 1];
            if constexpr (QUANT) {
              *reinterpret_cast<float4*>(dst + 16 * q + 4 * c4) =
                  make_float4(x0[2 * e2], x1[2 * e2], x0[2 * e2 + 1], x1[2 * e2 + 1]);
            } else {
              *reinterpret_cast<float2*>(dst + 16 * q + 2 * c4) =
                  make_float2(x0[2 * e2], x0[2 * e2 + 1]);
              *reinterpret_cast<float2*>(dst + 16 * q + 8 + 2 * c4) =
                  make_float2(x1[2 * e2], x1[2 * e2 + 1]);
            }
          }
          if (c4 == 0) *reinterpret_cast<float2*>(pml + (mine + r) * 2) =
              make_float2(m_run[e2], lsum[e2]);
        }
      }
    }
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      int* ctr = a.counters + ((size_t)b * a.nkv + h) * RT + rt;
      last = atomicAdd(ctr, 1) == ns - 1;
      if (last) *ctr = 0;   // every split has arrived: ready for the next call
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    if (!last) continue;
    __threadfence();

    // the last split to arrive merges all of them, in split order.
    // Batches of the splits' acc rows (and m) come into this warp's ring by
    // cp.async; while the first is in flight, each row's max M and sum L
    // over the splits (lanes r and r + 16 take row r's even and odd splits,
    // online). Each (split, row) weight w = 2^(m - M) / L then replaces its
    // m in the ring, and each lane sums w * acc over the splits for its
    // (row, 4 dims) items.
    const int nuse = plant == 1 ? ns - 1 : ns;   // planted fault 1
    constexpr int D4 = HD / 4;
    constexpr int KMAX = kRows * D4 / 32;
    const int n_it = nrows * D4;                             // (row, d4) items
    const int per_split = nrows * HD + kRows;                // floats: acc rows, then m
    const int nbat_max = C::RING / 4 / per_split;            // >= 1: see the static_assert
    float* stage = reinterpret_cast<float*>(wreg);
    auto fetch = [&](int sb) {   // splits sb .. sb + nbat_max - 1 into the ring
      for (int j = 0; j < min(nbat_max, nuse - sb); ++j) {
        const size_t prow = row0 + (size_t)(sb + j) * sstride;
        const uint32_t dst = ring + j * per_split * 4;
        for (int c = lane; c < n_it; c += 32) cp16(dst + c * 16, pacc + prow * HD + 4 * c, true);
        if (lane < nrows) cp4(dst + (nrows * HD + lane) * 4, pml + (prow + lane) * 2, true);
      }
      cp_async_commit();
    };
    fetch(0);
    const int rl = lane & 15;
    float M = -INFINITY, L = 0.f;
    if (rl < nrows) {
#pragma unroll 4
      for (int ss = lane >> 4; ss < nuse; ss += 2) {
        const float2 ml =
            __ldcg(reinterpret_cast<const float2*>(pml + (row0 + ss * sstride + rl) * 2));
        const float Mn = fmaxf(M, ml.x), Mu = Mn == -INFINITY ? 0.f : Mn;
        L = L * exp2f(M - Mu) + ml.y * exp2f(ml.x - Mu);
        M = Mn;
      }
    }
    {
      const float M2 = __shfl_xor_sync(0xffffffffu, M, 16);
      const float L2 = __shfl_xor_sync(0xffffffffu, L, 16);
      const float Mn = fmaxf(M, M2), Mu = Mn == -INFINITY ? 0.f : Mn;
      L = L * exp2f(M - Mu) + L2 * exp2f(M2 - Mu);
      M = Mu;
    }
    const float invL = 1.f / (L == 0.f ? 1.f : L);
    float4 o[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sb = 0; sb < nuse; sb += nbat_max) {
      const int nbat = min(nbat_max, nuse - sb);
      cp_async_wait<0>();
      __syncwarp();
      for (int i0 = 0; i0 < nbat * nrows; i0 += 32) {   // warp-uniform trip count
        const int idx = i0 + lane, j = idx / nrows, r = idx - j * nrows;
        const float mr = __shfl_sync(0xffffffffu, M, r & 15);
        const float ir = __shfl_sync(0xffffffffu, invL, r & 15);
        if (idx < nbat * nrows) {
          float* wp = stage + j * per_split + nrows * HD + r;
          *wp = exp2f(*wp - mr) * ir;
        }
      }
      __syncwarp();
      for (int j = 0; j < nbat; ++j) {
        const float* sp = stage + j * per_split;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int i = lane + 32 * k;
          if (i < n_it) {
            const float w = sp[nrows * HD + i / D4];
            const float4 x = *reinterpret_cast<const float4*>(sp + 4 * i);
            o[k].x += x.x * w; o[k].y += x.y * w; o[k].z += x.z * w; o[k].w += x.w * w;
          }
        }
      }
      __syncwarp();   // the ring is the next batch's
      if (sb + nbat < nuse) fetch(sb + nbat);
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int i = lane + 32 * k;
      if (i < n_it) {
        uint2 u;
        u.x = Elem<T>::pack(o[k].x, o[k].y);
        u.y = Elem<T>::pack(o[k].z, o[k].w);
        *reinterpret_cast<uint2*>(out_row(i / D4) + 4 * (i % D4)) = u;
      }
    }
  }
}

template <typename T, int HD, bool QUANT>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
  using C = Cfg<HD, QUANT>;
  static_assert(C::SMEM <= kMaxSmem, "shared memory");
  auto kernel = paged_sm90_kernel<T, HD, QUANT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // per device: the opt-in to > 48 KB of shared memory and the blocks the
  // card holds at once
  constexpr int kDevs = 64;
  static int resident[kDevs] = {};
  if (dev >= kDevs) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, C::SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int R = a.nh / a.nkv * a.t, RT = (R + kRows - 1) / kRows;
  const long long items = (long long)min(a.B, kSeqChunk) * a.nsplit * a.nkv * RT;
  const long long blocks = (items + kWarps - 1) / kWarps;
  const int gx = (int)(blocks < resident[dev] ? blocks : resident[dev]);
  const dim3 grid(gx, (a.B + kSeqChunk - 1) / kSeqChunk);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(a, g_plant);
  return cudaGetLastError();
}

template <typename T, bool QUANT>
cudaError_t launch(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<T, 64, QUANT>(a, stream);
    case 128: return launch_hd<T, 128, QUANT>(a, stream);
    case 256: return launch_hd<T, 256, QUANT>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const Args& a, int hd, cudaStream_t stream) {
  return a.ng > 0 ? launch<T, true>(a, hd, stream) : launch<T, false>(a, hd, stream);
}

}  // namespace

// q, k_pool, v_pool, k_scale, v_scale (null with 16-bit pools), tables, ctx,
// window_ptr (null: none), window_static (0: none), out, counters (int32,
// zero, >= B * nkv * row tiles), partials (fp32, >= B * nsplit * nkv * R *
// (hd + 2) where nsplit > 1), B, t, nh, nkv, hd, bs, num_blocks, max_blocks,
// ng (0: 16-bit pools), nsplit (the most splits any sequence can have: see
// splits_of), dtype of q, out and 16-bit pools (0 bf16, 2 fp16), scale,
// stream.
extern "C" int dstt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_scale, const void* v_scale,
                                    const void* tables, const void* ctx, const void* window_ptr,
                                    int window_static, void* out, void* counters,
                                    void* partials, int B, int t, int nh, int nkv, int hd,
                                    int bs, int num_blocks, int max_blocks, int ng, int nsplit,
                                    int dtype, float scale, void* stream) {
  if (B == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || t < 1 || bs < 1 || max_blocks < 1 || num_blocks < 1 ||
      nsplit < 1)
    return (int)cudaErrorInvalidValue;
  if (ng < 0 || (ng > 0 && hd % (16 * ng) != 0) || (dtype != 0 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const char*>(k_pool),
         static_cast<const char*>(v_pool), static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), static_cast<const int*>(tables),
         static_cast<const int*>(ctx), static_cast<const int*>(window_ptr), window_static,
         static_cast<__nv_bfloat16*>(out), static_cast<int*>(counters),
         static_cast<float*>(partials), B, t, nh, nkv, bs, num_blocks, max_blocks, ng, nsplit,
         scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 2 ? launch_t<__half>(a, hd, s) : launch_t<__nv_bfloat16>(a, hd, s));
}

// Planted fault of the next launches (tests): 0 none, 1-3 as at g_plant.
extern "C" int dstt_paged_sm90_plant(int fault) {
  g_plant = fault;
  return 0;
}
