// Fused speculative-verification attention over the paged KV pools, for
// Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py `_spec_verify_kernel`
// (:315; pallas_call at :469, via `paged_spec_verify_attention` :390, op
// `paged_spec_verify_attention`), in its bf16 and int8 modes, with and
// without a sliding window. The t = k + 1 rows [last_token, draft_1..k] of
// each sequence score against the same block-table-indexed pools the decode
// kernel walks (their K/V already written there): row ti sits at position
// ctx+ti and sees the positions <= ctx+ti. No dense [B, max_blocks*bs, ...]
// view of the context is built.
//
// The kernel, its bound and its design are in paged_rows.cuh (shared with
// the int8 mode of paged_decode.cu). At Llama-3-8B with k = 4 a block holds
// g*t = 4*5 = 20 rows of one kv head and reads each live K/V row once for
// all of them, so the verify step moves about the bytes of one decode step.
//
//   q     [B, t, nh, hd] bf16;  out [B, t, nh, hd] bf16
//   pools [num_blocks, nkv, bs, hd] bf16 (quant = 0) or int8 (quant = 1,
//         with fp32 scales [num_blocks, nkv, bs, ng])

#include "paged_rows.cuh"

extern "C" int dstt_paged_verify(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale, const void* tables,
                                 const void* ctx, const void* window_ptr, int window_static,
                                 void* out, int B, int t, int nh, int nkv, int hd, int bs,
                                 int num_blocks, int max_blocks, int ng, int quant, float scale,
                                 void* stream) {
  dstt_rows::Args a{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const int*>(tables), static_cast<const int*>(ctx),
                    static_cast<const int*>(window_ptr), window_static,
                    static_cast<__nv_bfloat16*>(out),
                    B, t, nh, nkv, bs, num_blocks, max_blocks, quant ? ng : 1, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(quant ? dstt_rows::launch<true>(a, hd, s) : dstt_rows::launch<false>(a, hd, s));
}
