#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # Llama-3-8B, OPT-1.3B, BLOOM-7b1, MSA shapes

Phases (any failure raises and the script exits nonzero; nothing is caught):

1. Device: require CUDA; print ``nvidia-smi``'s card name and power limit.
2. Build: compile ``deepspeed_tpu_torch/ops/csrc/*.cu`` with nvcc for
   sm_90a into ``build/deepspeed_tpu_torch/`` and print the build seconds.
3. Kernels against their plain PyTorch versions on the card: RMSNorm at
   N in {1, 7, 64, 2048, 4096} rows of d = 4096 (bf16; fp16 within
   ``FP16_TOL`` and fp32 within 1e-4 at 1, 7, 64 and 4096 rows, where the
   plain version rounded through bf16 must exceed ``FP16_TOL``), and its
   two planted faults (lane 31's partial left out of the sum, the weight
   left off a row's first vector) must fail at 64 and 4096 rows; paged
   decode at the 8B
   shapes (B = 64 slots, 32 heads, 8 kv heads, hd 128, 512 blocks of 128)
   with random tables and context lengths 0, bs-1, bs, bs+1 .. 8191, with
   and without a window. Each output row's largest error must stay within
   a stated share of that row's RMS (see ``row_err``); one wrong
   block-table entry on the longest row must exceed it, or the check is
   too loose to count. Prints each error beside its tolerance, and each
   kernel's device time (``torch.profiler``) beside its plain version's,
   its bound and (for RMSNorm) ``torch.nn.functional.rms_norm`` as the
   library yardstick.
   Flash-attention kernels (forward, dQ, dK/dV) through op ``attention``'s
   autograd function against plain attention under autograd in fp32 on the
   same bf16 inputs (output, and the grads of sum(o * dO) for a random dO)
   at Llama-3-8B attention shapes
   (32 heads, 8 kv heads, hd 128, bf16): S = 4096 causal, S = 1000, Sq 512
   against Skv 4096 at q_offset 3584, window 1024, non-causal, and MHA
   (32/32). Each output held with ``row_err`` to its limit in
   ``FLASH_TOL``; one swapped 64-row K tile must fail the check, and so
   must the bf16 forward's (``flash_fwd_sm90.cu``, TMA + wgmma) two planted
   faults: a ring stage read one step late, the last kv tile of the causal
   band dropped. The bf16 dQ and dK/dV wrappers (``flash_bwd_sm90.cu``)
   against their plain pieces (``flash_bwd_torch``, same o and lse) at
   S = 4096, with the same limits, and its three planted faults (a ring
   stage read one step late, the last tile of each band dropped, the last
   query head of each GQA group skipped) must fail. Prints each kernel's
   device time beside its bound, its plain version's and
   ``F.scaled_dot_product_attention``'s (the library yardstick, timed here
   and used nowhere in the port); all three, held to their plain versions
   again, also at OPT-1.3B's training shape (4 x 2048 tokens, 32/32 heads,
   hd 64).
   The int8 mode of paged decode (group 128 and group
   32, i.e. 1 and 4 scales per vector, windows none / 1 / 100 / 4096 /
   tensor) and the spec-verify kernel (t = 5 rows; bf16, int8 group 128 and
   group 32; windows none / 1 / 100 / tensor) against their plain versions
   at the same 8B shapes (int8 pools from the port's own quantizer,
   contexts where ctx + t - 1 crosses a block edge, ctx 0 on the trash
   block, the table's end), within ``ROWS_TOL``; the wrong block's scales
   (int8) or one wrong table entry (bf16) on the longest row must fail.
   Prints their device times beside their plain versions' and bytes bound.
   What the one paged kernel (``paged_sm90.cu``: positions split across
   warps, merged in split order) adds: live lengths one before, on and one
   after its split boundaries (64, 512, 4096), within one split, the
   table's end, decode and verify on bf16 and int8 pools (groups 128 and
   32), with and without a window; Falcon-7B's shapes (71 query heads over
   one kv head, hd 64: decode, and verify of 355 rows); two calls giving
   identical bits; its three planted faults (the merge dropping the last
   split, a ring stage read before its copy lands, the K scale left out)
   each failing the same check.
   LayerNorm at N in {1, 7, 64, 2048, 8192} rows of d = 2048, 4096 rows of
   d = 4096 (one BLOOM-7b1 micro-batch) and 64 rows of d = 768, bf16, fp16
   and fp32, with and without bias, within ``RMS_TOL`` (fp16: ``FP16_TOL``,
   fp32: 1e-4) of each row's RMS; a left-out bias must fail (d 4096 bf16 and d 768 fp32), and so
   must the warp kernel's planted fault (lane 31's share left out of the
   centred sum, 64 rows of d 2048); times at 1 row (the launch floor), 64,
   8192 and [4096 x 4096]. int8 quantize of
   OPT-1.3B's ``w_up`` [2048, 8192] in bf16, fp16 and fp32 at groups 2048
   and 128 (one all-zero row, one group of exact .5 ties) and dequantize to
   fp32, bf16 and fp16, and of Llama-3-8B's MLP weight [4096, 14336] in
   bf16 (dequantized to bf16; beyond L2, so read cold): codes, scales and
   values EQUAL to the plain versions' bit for bit, also at ties and
   boundary quotients of the division (fp32, ``division_boundary_groups``)
   and at every (amax, x) pair of bf16 and of fp16
   (``every_pair_groups``); ``quantize.cu``'s planted
   faults (the quotient as the product by the reciprocal, a lane left out
   of each segment's max, a group's first vector scaled by the previous
   group's scale) and scales shifted by one group must break the equality.
   Times beside the plain versions', the bytes bound, ``F.layer_norm`` and
   (dequantize) one ``torch.mul(out=)``. The reused
   paged and flash kernels once more at OPT-1.3B's shapes (MHA, 32 kv
   heads, hd 64, tables of 16 blocks; S = 2048).
   The flash kernels' bias mode against its plain pieces (same bf16
   inputs): at BLOOM-7b1's attention (2 x 2048 tokens, 32/32 heads, hd 128,
   causal, ALiBi [32, 1, S] read with stride 0; fault: ALiBi shifted by one
   key) and at AlphaFold MSA row attention (512 rows x 256 residues, 8
   heads of 32, non-causal, summed fp32 mask + pair bias with one residue
   masked everywhere and one row wholly masked, which must average v
   uniformly; dbias checked; fault: the bias read transposed). The bias
   mode of the bf16 backward (``flash_bwd_sm90.cu``) with its planted
   faults at both shapes (ring stage late, band tile dropped, query head
   skipped at BLOOM; the bias read one kv tile off at both), each of which
   must fail. The block-sparse kernels against their dense plain pieces at Llama-3-8B
   width (S 4096, block 128: bigbird causal, fixed non-causal, sliding
   window), at blocks 16, 32 and 64, and with an empty kv column (exact zero
   dK/dV); fault: one list entry swapped. The forward, dQ and dK/dV at
   block 128 run ``sparse_sm90.cu`` (TMA + wgmma; dK/dV's columns split over
   work items): each two calls bit-identical, and their planted faults
   (dK/dV: the merge dropping a chunk's partial, a ring stage read before
   its copy lands, a query head of the group skipped; dQ and forward: each
   list's last entry left out, a ring stage read early, the diagonal
   block's mask left out) must fail; their times at each S 4096 layout. The
   forward, dQ and dK/dV of ``sparse_attention.cu`` timed at S 4096 block
   32, its forward and dQ held there against the plain forward and dQ, each
   of the three two calls bit-identical (dK/dV's columns split by the same
   plan) and its planted faults (1: a split column's last chunk dropped; 2:
   the forward's ring stage read early; 3: dQ's last head of each item left
   out) failing.
   Times beside the bound, the plain
   pieces and SDPA (float ``attn_mask``; at the MSA shape a mask that
   requires grad, so SDPA computes dbias as the dQ kernel does, on the
   first fused backend that takes it, fp32 mask first; the bf16 mask
   without grad on a line of its own; for the sparse kernels the
   dense-masked SDPA at S 16384).
4. Main path: ``build_engine_v2`` with ``LlamaConfig.llama3_8b()`` (bf16
   weights from a seed, 512 x 128-token KV blocks, 64 slots) and
   ``generate`` on 8 prompts of mixed lengths (one of length 1, one > 128),
   32 greedy tokens each. Launch counters are zeroed just before and read
   just after: RMSNorm must have launched 65 times per forward and paged
   decode 32 times per decode step. Each decode step is one replay of the
   engine's CUDA graph (captured in the warm-up): the wrappers count the
   eager forwards (prefill), and the graph's launches are its kernel nodes
   (``graph_kernels``, read from the graph itself) times the replays.
   Prints TTFT, decode tokens/s and peak memory beside the card's name and
   power limit.
5. Speculative serving: Llama-3-8B (full width and depth, bf16 weights from
   the seed, 512 x 128-token blocks, 64 slots) through ``generate`` on 8
   prompts that repeat their own opening span, 32 greedy tokens each, in
   three engines in turn: (a) ``speculative {enabled, fused_verify,
   max_draft_tokens 4}`` on bf16 pools; (b) the same with ``kv_quant
   {enabled, group_size 128}``; (c) ``kv_quant`` alone. Counters zeroed
   before and read after each: RMSNorm 65 per forward, spec verify 32 per
   fused verify step (at least one), paged decode (bf16 or int8, by pool)
   32 per plain decode step (graph replays, counted as in phase 4). Prints
   tokens per step, acceptance rate,
   verify- and decode-step ms, TTFT, pool bytes, peak memory and a profile
   of 6 steps.
6. Whole path against the plain path: the same width at 2 layers, one
   prompt's prefill and 4 decode steps on the card (kernels) and on the CPU
   (plain versions), logits compared within a bf16 tolerance; then on int8
   pools one prompt's prefill, one fused verify step with a fixed draft of
   4 tokens and 2 decode steps, compared the same way.
7. Training main path: ``initialize(model=llama.model_spec(Llama-3-8B at
   4 layers))`` with bf16, AdamW (lr 3e-4, weight decay 0.1), clipping 1.0,
   ZeRO 0, batch 2 as 2 micro-batches of one 4096-token sequence; 6
   ``train_batch`` steps on one fixed batch. Launch counters are zeroed
   just before and read just after: per step 8 launches of each flash
   kernel (4 layers x 2 micro-batches) and 18 of RMSNorm (9 per forward);
   the loss must be finite and fall. Prints step ms, tokens/s, model
   TFLOP/s and its share of 989, peak memory and the device-idle share of
   one profiled step.
8. Whole training path against the plain path: the same width at 1 layer,
   S = 256, one step's loss and every leaf's gradient on the card (kernels,
   bf16) and on the CPU (plain versions, fp32) from the same fp32 masters,
   within ``TRAIN_LOSS_RTOL`` and ``TRAIN_GRAD_RTOL``; a planted fault
   (dV of one kv head zeroed) must fail the check.

9. OPT-1.3B serving: ``build_engine_v2(gpt, GPTConfig.opt_1_3b()`` with
   relu``)`` at all 24 layers, bf16 weights from the seed, 512 x 128-token
   blocks, 64 slots, 32 greedy tokens for each of 8 prompts: mixed lengths
   1 .. 1900 on bf16 pools, then self-repeating prompts with speculative
   decoding + fused verify on int8 pools. Counters zeroed before and read
   after: LayerNorm 49 per forward, paged decode (bf16 or int8) 24 per
   decode step, spec verify 24 per fused verify step, RMSNorm 0. Then the
   bf16 decode and int8 verify kernels timed on the inputs of those
   engines' last steps (MHA 32/32, hd 64, tables of 16 blocks).
10. OPT-1.3B training at all 24 layers: bf16, AdamW (lr 3e-4, weight decay
   0.1), clipping 1.0, ZeRO 0, 2 micro-batches of 4 sequences of 2048
   tokens, 6 ``train_batch`` steps on one fixed batch; per step 48 launches
   of each flash kernel and 98 of LayerNorm, RMSNorm 0; the loss must be
   finite and fall. Prints what phase 7 prints.
11. The GPT family's whole paths against the plain paths at OPT-1.3B width:
   phase 6's bf16 serving check at 2 layers, and phase 8's training check
   at 1 layer with LayerNorm's bias gradient zeroed as the planted fault:
   with relu, as served and trained above, within ``TRAIN_GRAD_RTOL_RELU``
   (ReLU's kink turns bf16 rounding of a pre-activation near 0 into a
   full-size gradient error, ~0.07 a leaf on a sound path), and with gelu
   within ``TRAIN_GRAD_RTOL``.
12. The inference module system through ``modules.registry.instantiate``:
   OPT-1.3B's ``w_up`` and ``w_down`` quantized on the card (group 128),
   the ``weight_only_quant`` linear against the ``dense`` linear on
   [64, 2048] bf16 activations within ``MODULE_QUANT_TOL`` (shifted scales
   must fail), and on fp16 activations (``w_up`` quantized from fp16,
   dequantized into fp16) against the dense fp16 linear at the same limit;
   the ``norm`` slot with ``kind="layer"``; quantize, dequantize and
   LayerNorm launches equal to the calls made (3, 3, 1).

13. BLOOM-7b1 width training at 4 layers (depth cut from 30; 1.833 B
   parameters): bf16, AdamW (lr 3e-4, weight decay 0.1), clipping 1.0,
   ZeRO 0, 2 micro-batches of 2 sequences of 2048 tokens, 6
   ``train_batch`` steps on one fixed batch; per step 8 launches of each
   bias-mode flash kernel (ALiBi), 0 of the no-bias ones, 20 of LayerNorm,
   0 of RMSNorm; the loss must be finite and fall. Prints what phase 7
   prints.
14. BLOOM-7b1 width at 1 layer, S = 256: phase 8's check, with ``bk``
   (zero gradient in exact arithmetic) held against ``bq``'s reference norm
   and ``final_ln_bias`` (a nearly cancelling gradient) at its own limit
   (``TRAIN_GRAD_AGAINST_BLOOM``, ``TRAIN_LEAF_TOL_BLOOM``); ALiBi zeroed,
   and LayerNorm's db zeroed, on the card side must each fail it.
15. The attention entry points under autograd: ``msa_row_attention`` at the
   AlphaFold shapes above (pair-bias grad included) against its einsum
   path in fp32, and ``blocksparse_attention`` at S 16384 (bigbird causal,
   block 128, 32/8 heads, hd 128) against the dense-masked SDPA, within
   ``ENTRY_RTOL`` (relative Frobenius), its grads against the plain pieces
   (query-row chunks) at ``FLASH_TOL``; launches equal the calls made (the
   forward, dQ and dK/dV on ``sparse_sm90.cu``); then at S 4096, block 32,
   whose three kernels run ``sparse_attention.cu``, the grads held the same
   way.

16. Engine v2's serving core at Llama-3-8B's full width and depth, every
   engine on one set of bf16 weights (``phase_serving_core``): 8 prompts x
   32 greedy tokens through the decode graph (64 slots; ``step_many`` 8
   tokens a quantum, and single ``step()`` calls) identical to the eager
   decode (its plain version: the same forward, not captured) in single
   steps and in quanta; 4 sampled beside 4 greedy rows identical too; the
   graph's kernel nodes (65 RMSNorm and 32 paged decode) times its
   replays as its launches; the same identities for Llama-3-8B on int8
   pools and with speculative decoding + fused verify, and for OPT-1.3B
   (24 layers) on bf16 pools and in that spec mode (``graph_modes``);
   eager ``step()``, graph ``step()`` and the graph quantum timed (wall,
   device busy, idle share, kernels and host launches a token-step), the
   profiler's RMSNorm and paged-decode records in each window equal to the
   launches made there. Then, at
   max_seq_len 2048 and 16 slots: the prefix cache on against off on 8
   prompts sharing 1024 tokens (both split at 1024, so the prefix is one
   chunk either way; the prefill tokens saved printed), split prefill
   (256-token chunks) against one-shot, a fork (child's pending token
   changed) against solo runs — tokens and K/V rows bit for bit, one
   copy-on-write —, park / resume under churn against park / resume
   without, a native export → import handoff resumed on a second engine
   against the resume at the source, and speculative decoding with fused
   verify over the shared prefix (prefix on against off) and over a forked
   tail. A replay whose context-length buffer is not advanced, and skipped
   copy-on-write copies, must each fail their check.
17. The serving fleet at Llama-3-8B's full width and depth
   (``phase_serving_fleet``; ``max_seq_len`` 2048, 16 slots, blocks of
   128, one set of bf16 weights): a seeded ``TrafficGenerator`` trace of
   48 Poisson requests (prompts 64-1024 tokens, 16-128 generated,
   priorities 0-2, a deadline on every third) on a 64-block pool below its
   peak demand, with 256-token split prefill. (a) The trace through one
   ``ServingScheduler`` at ``decode_quantum`` 8 on a fake clock, over the
   decode graph and over the eager decode: streams, ``stats`` and the
   decision log (admissions, parks, resumes, finishes) equal, every cache
   invariant checked after every tick, every stream delivered exactly
   once; admission blocks, preemptions, resumes and chunked admissions
   counted and required; speculative decoding + fused verify on int8 pools
   through a scheduler, graph against eager; a resume that re-emits its
   stream's last token must fail the exactly-once check. (b) The trace in
   real time with ``trace`` on: generated tokens/s, goodput, TTFT / ITL /
   queue p50 and p99, the host ms of a tick outside the forwards, a
   profiled window's idle share and bare ``step_many(8)`` on its batch
   (nothing pass/fail but completion). (c) Two replicas behind a
   ``ReplicaRouter`` with ``fleet`` on, fault-free and with replica 1
   crashing: every stream complete exactly once, its tokens before the
   crash equal to the fault-free run's, an unmoved stream whole, a moved
   stream's rest equal to its history resumed on a fresh engine. (d) One
   prefill and one decode replica on the native wire, bf16 and int8
   pools: streams equal a hand-driven park → export → import → resume,
   shared 1024-token prefixes deduplicated off the wire. In each part the
   profiler's RMSNorm and paged-kernel records in a window equal the
   launches; no tick, export or import fault that the phase did not inject.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
launches on the main paths, times, bound, max error); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--details PATH`` also writes every measurement as JSON to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
# Tolerances: max |got - ref| over an output row, as a share of that row's
# RMS (``row_err``). A row-relative limit follows what is compared: a
# paged-decode row over n positions has an RMS of about sqrt(e/n), 0.02 at
# n = 8191, where an absolute limit of that size would pass a wrong block.
RMS_TOL = 0.05         # bf16: one rounding step (<= 0.031) of |y| < 8, row RMS ~1
FP16_TOL = 0.005       # norms at fp16: sound kernels read <= 0.0020, an RMSNorm
                       # rounded through bf16 >= 0.0117 (checked in phase 3)
DECODE_TOL = 0.06      # sound kernels read <= 0.03 (the plain version rounds p
                       # to bf16); one wrong 128-position block reads >= 0.5
WHOLE_PATH_TOL = 0.1   # logits after 2 bf16 layers + lm-head, row RMS ~1
# flash kernels (bf16) against plain attention in fp32 on the same inputs:
# row err / row RMS, each row's RMS floored at FLASH_FLOOR times the
# output's. dQ rows are floored at the output's RMS: the flash backward
# takes delta = rowsum(dO * O) from the bf16 O (as the TPU kernel does), and
# a query that sees few keys, whose dQ is small, keeps that rounding whole
# (up to 0.34 of its own RMS). From the CPU simulation in
# tests/test_torch_flash_attention.py
# (test_flash_row_limits_separate_sound_from_faulty, which prints them):
# sound o/dk/dv <= 0.021 and dq <= 0.063; one swapped 64-row K tile >= 2.6.
FLASH_TOL = {"o": 0.05, "dq": 0.15, "dk": 0.05, "dv": 0.05}
FLASH_FLOOR = {"o": 0.01, "dq": 1.0, "dk": 0.01, "dv": 0.01}
# the forward kernels' fp32 lse against the plain forward's, elementwise
# |lse - ref| <= LSE_ATOL + LSE_RTOL * |ref|: the limits of the GPU tests
# (tests/test_torch_cuda_kernels.py)
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# whole training step, card (bf16, kernels) against CPU (fp32, plain), from
# the CPU simulation in tests/test_torch_train_llama.py
# (test_train_limits_separate_sound_from_faulty): loss <= 1e-4 relative,
# leaf grads <= 0.0133 relative Frobenius, a zeroed dV head ~0.7 on wv.
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_RTOL = 0.05     # per leaf, ||card - cpu||_F / ||cpu||_F
# the same check through a ReLU MLP: bf16 rounding moves a pre-activation
# within ~0.01 of 0 across the kink, and each such element (about one in 200)
# carries a full-size gradient error, so every leaf below the activation reads
# 0.065-0.069 on a sound path on the card (CPU simulation 0.068,
# tests/test_torch_gpt.py, test_train_limits_separate_sound_from_faulty);
# LayerNorm's db zeroed reads 1.0
TRAIN_GRAD_RTOL_RELU = 0.15
TRAIN_STEPS = 6
OPT_MICRO = 4                  # 2048-token sequences per OPT-1.3B micro-batch
SEED = 0                       # weights, prompts and kernel inputs
MAX_NEW_TOKENS = 32
# the int8 paged decode and the spec-verify kernel (bf16 and int8 pools)
# against their plain versions: row err / row RMS as DECODE_TOL. The kernels
# dequantize in fp32; the plain versions fold one scale per vector into the
# scores in fp32 and otherwise dequantize into bf16, one rounding step of
# each K/V element (sound rows read <= 0.03 in tests/test_torch_cuda_kernels.py
# on the card; one wrong block, or one block's wrong scales, >= 0.5)
ROWS_TOL = 0.06
SPEC_K = 4                     # max_draft_tokens of the spec-serving engines
# the weight-only int8 linear (group 128) against the dense linear on the same
# bf16 activations, row err / row RMS: each weight moves by at most half a code
# step (amax_group / 254), independently over the 2048 or 8192 terms of a dot
# product, and the largest of a row's 8192 outputs decides. From the CPU
# simulation at these shapes in tests/test_torch_inference_modules.py
# (test_quant_linear_limit_separates_sound_from_faulty): sound <= 0.047 after
# one linear and after both; w_down's scales shifted by one group 0.89.
MODULE_QUANT_TOL = 0.1
# BLOOM's whole training step, card against CPU: two leaves carry no signal
# a relative limit on their own norm can read (CPU simulation in
# tests/test_torch_bloom.py: test_train_limits_separate_sound_from_faulty at
# vocab 8192, test_train_limits_hold_at_bloom_vocab at 250880).
# - bk's exact gradient is zero (softmax drops a shift shared by every key),
#   so its reference is fp32 rounding (RMS 1e-7 of bq's) and its card reading
#   bf16 rounding of the dS row sums: it is held against bq's reference norm,
#   the gradient made from the same dS (sound 1.3e-3 of it). The rule applies
#   only while the reference stays below GRAD_ZERO_SHARE of that norm.
# - final_ln_bias's gradient nearly cancels at random init (the tied head
#   makes each token predict itself): bf16 rounding reads 0.03-0.08 of it
#   (0.08 at S 512), so it is held at its own limit; its zeroed db reads 1.0.
TRAIN_GRAD_AGAINST_BLOOM = {"layers.0.bk": "layers.0.bq"}
TRAIN_LEAF_TOL_BLOOM = {"final_ln_bias": 0.15}
GRAD_ZERO_SHARE = 1e-4
BLOOM_MICRO = 2                # 2048-token sequences per BLOOM-7b1 micro-batch
# the attention entry points (phase 15) against a reference on the same
# inputs, relative Frobenius: bf16 kernels against the fp32 einsum path, or
# against the dense-masked SDPA (CPU simulation of the former at 16 MSA
# rows: output 0.0038, pair-bias grad 0.0032)
ENTRY_RTOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Host-loop time per call: CUDA events around ``iters`` back-to-back
    calls. Where the host takes longer to issue a call than the card takes
    to run it, this is the host's time, not the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else getattr(evt, "self_cuda_time_total", 0.0))


PROFILE_SESSIONS = 4       # of one window, 0.2 s apart, before giving up
LEAD_IN = 256                  # spin kernels a profiler session starts with
LEAD_IN_CYCLES = 20_000_000    # the first one's length (~10 ms)


def profile_window(fn, undo=None):
    """Run ``fn`` under torch.profiler (CUDA activity): (wall s, device-busy
    s, kernels launched, [(kernel, device ms, count)] by device time). One
    stream, so busy time is the sum of the kernels' own times.

    Once a process has run a few phases of this script, CUPTI drops
    records near the start of every session on this card, more as the
    process ages: 2000 launches of one kernel read 1999 (with or without
    50 ms of host sleep first; a fresh process reads 2000:
    ``scripts/profiler_lead_in_check.py``), a spec serving
    window lost both spin kernels put before it, and phase 16's 8-step
    serving windows read 12419 kernels of the 12432 launched (519 RMSNorm
    of 520). So each session opens with a lead-in of ``LEAD_IN`` spin
    kernels (``torch.cuda._sleep``, the first ~10 ms long, then a sync)
    that absorbs the loss, needs at least one of them recorded, and counts
    nothing of it. About
    4 sessions in 1000 on this card come back without one kernel, in
    bursts: the same window run again at once was still empty 10 times in
    22, and a third session 0.2 s later never (5400 sessions,
    ``scripts/torch_profiler_trace_check.py``). So a session without its
    lead-in or without a kernel of ``fn`` is logged, ``undo`` (if given)
    takes back what ``fn`` must not do twice, and the window runs again,
    ``PROFILE_SESSIONS`` times in all; then it raises. No other clock ever
    stands in for a device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lead_in, evts = [], []
    for session in range(PROFILE_SESSIONS):
        if session:
            log(f"  (torch.profiler session {session} of this window held "
                f"{sum(e.count for e in lead_in)} of {LEAD_IN} lead-in and "
                f"{sum(e.count for e in evts)} other kernel records; again)")
            if undo is not None:
                undo()
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_IN_CYCLES)
            for _ in range(LEAD_IN - 1):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evts = [e for e in prof.key_averages() if _dev_us(e) > 0]
        lead_in = [e for e in evts if "spin_kernel" in e.key]
        evts = [e for e in evts if "spin_kernel" not in e.key]
        if lead_in and evts:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no lead-in or no device time in "
                           f"{PROFILE_SESSIONS} sessions; no device time can be reported")
    busy = sum(_dev_us(e) for e in evts) / 1e6
    top = sorted(((e.key, _dev_us(e) / 1e3, e.count) for e in evts),
                 key=lambda t: -t[1])
    return wall, busy, sum(e.count for e in evts), top


def launch_calls(fn) -> dict:
    """The host's launch calls in one run of ``fn``, from the CUDA runtime
    and driver API events ``torch.profiler`` records: kernel launches,
    graph launches, and copies / fills. Empty when the profiler recorded no
    such event (the caller then reports them as not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"kernel": ("LaunchKernel",), "graph": ("GraphLaunch",),
             "copy": ("Memcpy", "Memset")}
    out = {k: 0 for k in kinds}
    for e in prof.key_averages():
        if e.key.startswith("cu"):
            for k, marks in kinds.items():
                if any(m in e.key for m in marks):
                    out[k] += e.count
    return out if any(out.values()) else {}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(graph) -> list:
    """The (mangled) names of the kernel nodes of a captured
    ``torch.cuda.CUDAGraph`` (``keep_graph=True``), read from the graph
    itself through the driver API: what every replay launches."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        err = getattr(cu, fn)(*args)
        if err:
            raise RuntimeError(f"{fn} failed with CUresult {err}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                    # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(p))
        name = ctypes.c_char_p()
        if p.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(p.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(p.kern))
        names.append(name.value.decode())
    return names


# the hand-written kernels a decode graph can hold, by a piece of their
# (mangled) names; the paged kernel is the int8 mode on int8 pools
GRAPH_KERNEL_NAMES = {"rms_norm": "rms_norm_", "layer_norm": "layer_norm_",
                      "paged_decode_attention": "paged_sm90_kernel"}


def graph_per_replay(eng) -> dict:
    """The hand-written kernels one replay of ``eng``'s decode graph
    launches, from the graph's own kernel nodes (:func:`graph_kernels`)."""
    if eng._graph is None:
        raise AssertionError("the engine has not captured its decode graph")
    names = graph_kernels(eng._graph)
    per = {k: sum(piece in n for n in names) for k, piece in GRAPH_KERNEL_NAMES.items()}
    per = {k: n for k, n in per.items() if n}
    if eng._kvq_on and "paged_decode_attention" in per:
        per["paged_decode_attention_int8"] = per.pop("paged_decode_attention")
    return per


def capture_decode_graph(eng, prompt) -> dict:
    """Have ``eng`` capture its decode graph now (one sequence, one
    ``step_many`` tick, then retired), outside any counted run: the capture's
    two warm-up forwards launch through the wrappers and the captured one
    moves their counts without a launch. → :func:`graph_per_replay`."""
    uid = 1 << 30
    eng.put(uid, prompt)
    eng.step_many(1)
    eng.finish(uid)
    return graph_per_replay(eng)


def with_replays(launches: dict, per_replay: dict, replays: int) -> dict:
    """A counted run's launches: the wrappers' (eager forwards) plus the
    decode graph's kernels times the replays made in that run."""
    out = dict(launches)
    for k, n in per_replay.items():
        out[k] = out.get(k, 0) + n * replays
    return out


def measure(fn, iters: int) -> dict:
    """Device time per call (the kernels' own time, from the profiler) and
    host-loop time per call (CUDA events)."""
    host = time_ms(fn, iters)
    fn()
    _, busy, n_kernels, _ = profile_window(lambda: [fn() for _ in range(iters)])
    return {"ms": busy * 1e3 / iters, "host_ms": host,
            "kernels_per_call": n_kernels / iters}


def row_err(got, ref, floor: float = 0.0) -> tuple:
    """(max |got - ref|, max over rows of max |got - ref| / RMS(ref row)),
    a row being the last dimension; ``floor`` > 0 floors each row's RMS at
    that share of the whole output's RMS."""
    diff = (got.float() - ref.float()).abs()
    rms = ref.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)
    if floor:
        rms = rms.clamp_min(floor * float(ref.float().pow(2).mean().sqrt()))
    return float(diff.max()), float((diff.amax(-1) / rms).max())


def check_close(what: str, got, ref, tol: float, floor: float = 0.0) -> tuple:
    """``row_err(got, ref, floor)``; raises unless every row's error is
    within ``tol`` of its RMS and ``got`` is finite."""
    import torch

    err, rel = row_err(got, ref, floor)
    ok = rel <= tol and bool(torch.isfinite(got.float()).all())
    log(f"  {what}: max_abs_err={err:.3e}, max row err/RMS={rel:.4f} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(max abs err {err}, row err/RMS {rel})")
    return err, rel


# --------------------------------------------------------------------------- #
def phase_kernels(seed: int, card: str):
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.norms import (
        rms_norm_cuda, rms_norm_planted_fault, rms_norm_torch)
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_torch)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    # ---- RMSNorm ---------------------------------------------------------
    d, eps = 4096, 1e-5
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    errs, rows = [], {}
    for n in (1, 7, 64, 2048, 4096):
        x = (3 * torch.randn(n, d, generator=gen, device=dev)).to(torch.bfloat16)
        y = rms_norm_cuda(x, w, eps)
        torch.cuda.synchronize()
        errs.append(check_close(f"rms_norm N={n} d={d}", y, rms_norm_torch(x, w, eps),
                                RMS_TOL))
        iters = 2000 if n <= 64 else 300
        byt = 2 * n * d * 2 + d * 2
        flops = 4 * n * d
        kern_t = measure(lambda: rms_norm_cuda(x, w, eps), iters)
        plain_t = measure(lambda: rms_norm_torch(x, w, eps), iters)
        lib_t = measure(lambda: F.rms_norm(x, (d,), w, eps), iters)
        rows[n] = {
            "ms": kern_t["ms"], "plain_ms": plain_t["ms"], "library_ms": lib_t["ms"],
            "host_ms": kern_t["host_ms"], "plain_host_ms": plain_t["host_ms"],
            "library_host_ms": lib_t["host_ms"],
            "plain_kernels": plain_t["kernels_per_call"],
            "library_kernels": lib_t["kernels_per_call"],
            "bound_ms": max(byt / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bytes": byt,
        }
        r = rows[n]
        log(f"  rms_norm N={n}: device kernel {r['ms']*1e3:.2f} us, plain {r['plain_ms']*1e3:.2f} us "
            f"({r['plain_kernels']} kernels), F.rms_norm {r['library_ms']*1e3:.2f} us, "
            f"bound {r['bound_ms']*1e3:.3f} us; host loop: kernel {r['host_ms']*1e3:.2f} us, "
            f"plain {r['plain_host_ms']*1e3:.2f} us, F.rms_norm {r['library_host_ms']*1e3:.2f} us "
            f"[{card}]")
    # fp16 (FP16_TOL) and fp32 (1e-4) at the serving and training rows,
    # from a generator of their own (the later phases' inputs stay); at
    # fp16 the plain version rounded through bf16 (its inputs, its output)
    # must read above FP16_TOL, as an fp16 kernel working in bf16 would
    gen16 = torch.Generator(device=dev).manual_seed(seed + 20)
    bf16_control = {}
    for dtype, tol in ((torch.float16, FP16_TOL), (torch.float32, 1e-4)):
        wd = w.to(dtype)
        for n in (1, 7, 64, 4096):
            x = (3 * torch.randn(n, d, generator=gen16, device=dev)).to(dtype)
            y = rms_norm_cuda(x, wd, eps)
            torch.cuda.synchronize()
            ref = rms_norm_torch(x, wd, eps)
            errs.append(check_close(f"rms_norm N={n} d={d} {str(dtype)[6:]}", y, ref, tol))
            if dtype != torch.float16:
                continue
            for through, bad in (
                    ("inputs", rms_norm_torch(x.bfloat16(), wd.bfloat16(), eps).half()),
                    ("output", ref.bfloat16().half())):
                rel = row_err(bad, ref)[1]
                log(f"  rms_norm N={n} d={d} float16, plain version with its {through} "
                    f"rounded through bf16: row err/RMS={rel:.4f} (must exceed tol {tol:g})")
                if rel <= tol:
                    raise AssertionError("rms_norm fp16 tolerance passes bf16 rounding")
                bf16_control[f"{through} N={n}"] = rel
    # planted faults, each of which must fail the check: lane 31's partial
    # left out of the sum, the weight left off a row's first vector; at the
    # serving step's 64 rows and a training micro-batch's 4096, bf16
    faults = {}
    for fault, what in ((1, "lane 31's partial left out of the sum"),
                        (2, "the weight left off a row's first vector")):
        for n in (64, 4096):
            x = (3 * torch.randn(n, d, generator=gen16, device=dev)).to(torch.bfloat16)
            with rms_norm_planted_fault(fault):
                y_bad = rms_norm_cuda(x, w, eps)
                torch.cuda.synchronize()
            err, rel = row_err(y_bad, rms_norm_torch(x, w, eps))
            log(f"  rms_norm planted fault {fault} ({what}, N={n} d={d} bf16): "
                f"max_abs_err={err:.3e}, row err/RMS={rel:.4f} (must exceed tol {RMS_TOL:g})")
            if rel <= RMS_TOL:
                raise AssertionError(f"rms_norm tolerance passes planted fault {fault}")
            faults[f"{fault} N={n}"] = {"what": what, "max_abs_err": err,
                                        "row_err_over_rms": rel}
    out["rms_norm"] = {"max_abs_err": max(e for e, _ in errs),
                       "max_row_err_over_rms": max(r for _, r in errs), "tol": RMS_TOL,
                       "fp16_tol": FP16_TOL, "fp16_bf16_control": bf16_control,
                       "planted_faults": faults, "rows": rows}

    # ---- paged decode ----------------------------------------------------
    B, nh, nkv, hd, bs, nblocks, max_blocks = 64, 32, 8, 128, 128, 512, 64
    k_pool = torch.randn(nblocks, nkv, bs, hd, generator=gen, device=dev).to(torch.bfloat16)
    v_pool = torch.randn(nblocks, nkv, bs, hd, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
    rs = np.random.RandomState(seed)
    edge = [0, bs - 1, bs, bs + 1, 2 * bs - 1, 2 * bs, 8191, 8190]
    ctx_np = np.concatenate([edge, rs.randint(0, 8192, B - len(edge))]).astype(np.int32)
    tables_np = rs.randint(1, nblocks, (B, max_blocks)).astype(np.int32)
    tables_np[0] = 0                          # ctx 0: an inactive slot on the trash block
    ctx = torch.from_numpy(ctx_np).to(dev)
    tables = torch.from_numpy(tables_np).to(dev)
    errs = []
    for window in (None, 1, 100, 4096, torch.tensor(1000, dtype=torch.int32, device=dev)):
        got = paged_decode_attention_cuda(q, k_pool, v_pool, tables, ctx, window=window)
        torch.cuda.synchronize()
        ref = paged_decode_attention_torch(q, k_pool, v_pool, tables, ctx, window=window)
        wname = window if not isinstance(window, torch.Tensor) else f"tensor({int(window)})"
        errs.append(check_close(f"paged_decode B={B} window={wname}", got, ref, DECODE_TOL))

    # the check must catch a planted fault: one wrong table entry in the
    # middle of the longest row (ctx 8191: the smallest outputs, so the
    # hardest row to tell a fault on), against the sound reference
    row, j = int(np.argmax(ctx_np)), max_blocks // 2
    bad_np = tables_np.copy()
    bad_np[row, j] = bad_np[row, j] % (nblocks - 1) + 1
    got = paged_decode_attention_cuda(q, k_pool, v_pool, torch.from_numpy(bad_np).to(dev), ctx)
    ref = paged_decode_attention_torch(q, k_pool, v_pool, tables, ctx)
    fault_err, fault_rel = row_err(got[row], ref[row])
    log(f"  paged_decode planted fault (table[{row}, {j}] wrong, ctx {int(ctx_np[row])}): "
        f"max_abs_err={fault_err:.3e}, row err/RMS={fault_rel:.4f} (must exceed tol {DECODE_TOL:g})")
    if fault_rel <= DECODE_TOL:
        raise AssertionError("paged_decode tolerance passes a wrong block-table entry; "
                             "it is too loose to hold the kernel")

    def decode_case(ctx_np, tables_np, label):
        c = torch.from_numpy(ctx_np).to(dev)
        t = torch.from_numpy(tables_np).to(dev)
        live = np.minimum(ctx_np.astype(np.int64) + 1, max_blocks * bs)
        byt = int(live.sum()) * nkv * hd * 2 * 2 + 2 * B * nh * hd * 2 \
            + t.numel() * 4 + c.numel() * 4
        flops = int(live.sum()) * nh * hd * 4
        kern_t = measure(lambda: paged_decode_attention_cuda(q, k_pool, v_pool, t, c), 100)
        plain_t = measure(lambda: paged_decode_attention_torch(q, k_pool, v_pool, t, c), 5)
        r = {"ms": kern_t["ms"], "plain_ms": plain_t["ms"], "host_ms": kern_t["host_ms"],
             "plain_host_ms": plain_t["host_ms"],
             "bound_ms": max(byt / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
             "bytes": byt, "live_tokens": int(live.sum())}
        log(f"  paged_decode {label}: device kernel {r['ms']*1e3:.1f} us, plain {r['plain_ms']*1e3:.1f} us, "
            f"bound {r['bound_ms']*1e3:.1f} us ({r['live_tokens']} live tokens, "
            f"{byt / (r['ms'] * 1e-3) / 1e9:.0f} GB/s); host loop: kernel {r['host_ms']*1e3:.1f} us "
            f"[{card}]")
        return r

    cases = {"random_ctx": decode_case(ctx_np, tables_np, "random ctx 0..8191")}
    log("  paged_decode: no single PyTorch call computes this function "
        "(block-table gather + masked GQA softmax), so it has no library time")
    out["paged_decode"] = {"max_abs_err": max(e for e, _ in errs),
                           "max_row_err_over_rms": max(r for _, r in errs), "tol": DECODE_TOL,
                           "planted_fault": {"row": row, "ctx": int(ctx_np[row]),
                                             "max_abs_err": fault_err,
                                             "row_err_over_rms": fault_rel},
                           "cases": cases}
    return out, decode_case


# --------------------------------------------------------------------------- #
def phase_main_path(seed: int, max_new_tokens: int, card: str):
    import torch

    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda
    from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention_cuda

    cfg = llama.LlamaConfig.llama3_8b()       # full width and full depth
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    eng = build_engine_v2(llama, cfg, params, config={
        "dtype": "bfloat16", "prefill_bucket": 64,
        "ragged": {"max_tracked_sequences": 64, "max_ragged_batch_size": 64,
                   "memory_config_blocks": 512, "block_size": 128}})
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in eng.model.parameters())
    pool_bytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
    log(f"  engine: {cfg.num_layers} layers, {n_params/1e9:.3f} B params bf16, "
        f"pool {pool_bytes/1e9:.2f} GB, set-up {time.perf_counter()-t0:.1f} s")

    rs = np.random.RandomState(seed)
    lengths = [1, 17, 64, 100, 129, 200, 333, 500]
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    # warm-up (cuBLAS handles, allocator, the decode graph's capture) outside
    # the counted run
    eng.generate([prompts[0], prompts[2]], max_new_tokens=2)
    per_replay = capture_decode_graph(eng, prompts[1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.forward_log.clear()
    rms_norm_cuda.launches = 0
    paged_decode_attention_cuda.launches = 0
    replays0 = eng.graph_replays
    t_start = time.monotonic()
    outs = eng.generate(prompts, max_new_tokens=max_new_tokens)
    t_end = time.monotonic()
    eager_launches = {"rms_norm": rms_norm_cuda.launches,
                      "paged_decode_attention": paged_decode_attention_cuda.launches}
    replays = eng.graph_replays - replays0
    launches = with_replays(eager_launches, per_replay, replays)
    peak = torch.cuda.max_memory_allocated()

    assert len(outs) == len(prompts)
    for o in outs:
        assert len(o) == max_new_tokens, o
        assert all(0 <= t < cfg.vocab_size for t in o), o
    n_prefill = sum(k == "prefill" for k, *_ in eng.forward_log)
    n_decode = sum(k == "decode" for k, *_ in eng.forward_log)
    per_fwd = 2 * cfg.num_layers + 1
    want = {"rms_norm": per_fwd * (n_prefill + n_decode),
            "paged_decode_attention": cfg.num_layers * n_decode}
    log(f"  forwards: {n_prefill} prefill + {n_decode} decode ({replays} replays of the "
        f"decode graph, whose kernel nodes hold {per_replay}); launches {launches} (by the "
        f"wrappers {eager_launches}), expected {want}")
    if launches != want or n_decode == 0 or replays != n_decode \
            or eager_launches != {"rms_norm": per_fwd * n_prefill, "paged_decode_attention": 0}:
        raise AssertionError(f"kernel launch counts {launches} != expected {want}")
    first = next(e for e in eng.forward_log if e[0] == "prefill")
    ttft_ms = (first[3] - t_start) * 1e3
    dec = [e for e in eng.forward_log if e[0] == "decode"]
    dec_tokens = sum(e[2] for e in dec)
    dec_s = sum(e[1] for e in dec)
    res = {"ttft_ms": ttft_ms, "decode_tokens_per_s": dec_tokens / dec_s,
           "decode_step_ms": dec_s / len(dec) * 1e3,
           "prefill_ms": first[1] * 1e3, "e2e_s": t_end - t_start,
           "peak_mem_bytes": peak, "launches": launches, "per_replay": per_replay,
           "replays": replays,
           "n_prefill": n_prefill, "n_decode": n_decode,
           "prompt_lengths": lengths, "max_new_tokens": max_new_tokens,
           "num_layers": cfg.num_layers}
    log(f"  TTFT {ttft_ms:.1f} ms (8-prompt burst prefill {first[1]*1e3:.1f} ms), "
        f"decode {dec_tokens / dec_s:.1f} tok/s ({res['decode_step_ms']:.2f} ms/step, "
        f"{len(dec)} steps), peak mem {peak/2**30:.2f} GiB [{card}]")

    # where the time goes, after the counted run: the same burst's prefill
    # and 8 decode steps under the profiler (device-busy vs wall time)
    uids = list(range(1000, 1000 + len(prompts)))
    prof = {}
    for name, fn, n, undo in (
            ("prefill", lambda: eng.put_many(list(zip(uids, prompts))), 1,
             lambda: [eng.finish(u) for u in uids]),
            ("decode", lambda: [eng.step() for _ in range(8)], 8, None)):
        wall, busy, n_k, top = profile_window(fn, undo)
        prof[name] = {"wall_ms_per_call": wall * 1e3 / n, "busy_ms_per_call": busy * 1e3 / n,
                      "idle_share": 1 - busy / wall, "kernels_per_call": n_k / n,
                      "top": [(k, ms / n, c // n) for k, ms, c in top[:10]]}
        p = prof[name]
        log(f"  profile {name}: wall {p['wall_ms_per_call']:.2f} ms, device busy "
            f"{p['busy_ms_per_call']:.2f} ms (idle {p['idle_share']:.1%}), "
            f"{p['kernels_per_call']:.0f} kernels per call [{card}]")
        for k, ms, c in p["top"][:6]:
            log(f"    {ms:8.3f} ms  x{c:<4d} {k[:90]}")
    for u in uids:
        eng.finish(u)
    res["profile"] = prof
    del eng, params
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
ROWS_SHAPE = {"B": 64, "nh": 32, "nkv": 8, "hd": 128, "bs": 128, "nblocks": 512,
              "max_blocks": 64}
# OPT-1.3B's serving step: MHA 32/32 at hd 64, tables of 16 blocks (2048 positions)
OPT_ROWS_SHAPE = {"B": 64, "nh": 32, "nkv": 32, "hd": 64, "bs": 128, "nblocks": 512,
                  "max_blocks": 16}


def rows_work(ctx_np, t: int, ng: int, window=None, shape=None) -> dict:
    """Bytes and operations of one paged-attention call over t rows per
    sequence (t = 1: decode): the K and V rows of every position some row
    can see, read once (int8 codes and their ng fp32 scales, or bf16), q and
    out once, the tables and context lengths; 4 operations per (query row,
    visible position, dim). ``shape``: ``ROWS_SHAPE`` (Llama-3-8B) unless
    given (``OPT_ROWS_SHAPE``)."""
    S = shape or ROWS_SHAPE
    cap = S["max_blocks"] * S["bs"]
    ctx = ctx_np.astype(np.int64)
    hi = np.minimum(ctx + t, cap)
    lo = np.maximum(ctx - window + 1, 0) if window else np.zeros_like(ctx)
    live = int(np.maximum(hi - lo, 0).sum())
    per_pos = S["nkv"] * (2 * S["hd"] * (1 if ng else 2) + 2 * ng * 4)
    byt = live * per_pos + 2 * len(ctx) * t * S["nh"] * S["hd"] * 2 \
        + len(ctx) * (S["max_blocks"] + 1) * 4
    seen = 0
    for ti in range(t):
        top = np.minimum(ctx + ti + 1, cap)
        low = np.maximum(ctx + ti - window + 1, 0) if window else 0
        seen += int(np.maximum(top - low, 0).sum())
    flops = seen * S["nh"] * S["hd"] * 4
    return {"bytes": byt, "flops": flops, "live_tokens": live,
            "bound_ms": max(byt / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3}


def phase_rows_kernels(seed: int, card: str):
    """The int8 mode of paged decode and the spec-verify kernel (bf16 and
    int8 pools) against their plain versions at the Llama-3-8B serving
    shapes, a planted fault for each, and their times."""
    import torch

    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_int8_cuda, paged_decode_attention_torch,
        paged_spec_verify_attention_cuda, paged_spec_verify_attention_torch)
    from deepspeed_tpu_torch.ops.quantization import kv_quantize_int8

    S = ROWS_SHAPE
    B, nh, nkv, hd, bs = S["B"], S["nh"], S["nkv"], S["hd"], S["bs"]
    nblocks, max_blocks, t = S["nblocks"], S["max_blocks"], SPEC_K + 1
    cap = max_blocks * bs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    kf = torch.randn(nblocks, nkv, bs, hd, generator=gen, device=dev)
    vf = torch.randn(nblocks, nkv, bs, hd, generator=gen, device=dev)
    pools = {0: (kf.to(torch.bfloat16), vf.to(torch.bfloat16), {})}
    for ng in (1, 4):          # group 128 (one scale per vector) and group 32
        kc, ks = kv_quantize_int8(kf, hd // ng)
        vc, vs = kv_quantize_int8(vf, hd // ng)
        pools[ng] = (kc, vc, {"k_scale": ks, "v_scale": vs})
    del kf, vf
    q1 = torch.randn(B, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
    qt = torch.randn(B, t, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
    rs = np.random.RandomState(seed + 5)
    tables_np = rs.randint(1, nblocks, (B, max_blocks)).astype(np.int32)
    # decode: block edges and the table's end; verify: ctx + t - 1 crossing
    # a block edge, and the newest row at the table's last position
    dec_edge = [0, bs - 1, bs, bs + 1, 2 * bs - 1, 2 * bs, cap - 1, cap - 2]
    ver_edge = [0, bs - t, bs - t + 1, bs - 2, bs - 1, bs, 2 * bs - 3, cap - t]
    ctx_dec = np.concatenate([dec_edge, rs.randint(0, cap, B - len(dec_edge))])
    ctx_ver = np.concatenate([ver_edge, rs.randint(0, cap - t + 1, B - len(ver_edge))])
    ctx_dec, ctx_ver = ctx_dec.astype(np.int32), ctx_ver.astype(np.int32)
    tables_np[0] = 0                          # ctx 0: an inactive slot on the trash block
    tables = torch.from_numpy(tables_np).to(dev)
    cd, cv = torch.from_numpy(ctx_dec).to(dev), torch.from_numpy(ctx_ver).to(dev)
    windows = (None, 1, 100, torch.tensor(1000, dtype=torch.int32, device=dev))
    wname = lambda w: f"tensor({int(w)})" if isinstance(w, torch.Tensor) else w  # noqa: E731
    out = {"tol": ROWS_TOL}

    errs = []
    for ng in (1, 4):
        kc, vc, sc = pools[ng]
        for window in windows + (4096,):
            got = paged_decode_attention_int8_cuda(q1, kc, vc, tables, cd, window=window, **sc)
            torch.cuda.synchronize()
            ref = paged_decode_attention_torch(q1, kc, vc, tables, cd, window=window, **sc)
            errs.append(check_close(f"paged_decode int8 ng={ng} B={B} window={wname(window)}",
                                    got, ref, ROWS_TOL))
    out["decode_int8"] = {"max_abs_err": max(e for e, _ in errs),
                          "max_row_err_over_rms": max(r for _, r in errs)}
    errs = []
    for ng in (0, 1, 4):
        kp, vp, sc = pools[ng]
        for window in windows:
            got = paged_spec_verify_attention_cuda(qt, kp, vp, tables, cv, window=window, **sc)
            torch.cuda.synchronize()
            ref = paged_spec_verify_attention_torch(qt, kp, vp, tables, cv, window=window, **sc)
            errs.append(check_close(f"paged_spec_verify {'int8 ng=%d' % ng if ng else 'bf16'} "
                                    f"B={B} t={t} window={wname(window)}", got, ref, ROWS_TOL))
    out["verify"] = {"max_abs_err": max(e for e, _ in errs),
                     "max_row_err_over_rms": max(r for _, r in errs)}

    # planted faults on the longest row, against the sound reference: the
    # wrong block's scale rows (int8) or one wrong table entry (bf16)
    def bad_scales(sc, blk):
        bad = {k: v.clone() for k, v in sc.items()}
        for k in bad:
            bad[k][blk] = sc[k][blk % (nblocks - 1) + 1]
        return bad

    faults = {}
    j = max_blocks // 2
    kc, vc, sc = pools[1]
    row = int(np.argmax(ctx_dec))
    got = paged_decode_attention_int8_cuda(q1, kc, vc, tables, cd,
                                           **bad_scales(sc, int(tables_np[row, j])))
    ref = paged_decode_attention_torch(q1, kc, vc, tables, cd, **sc)
    faults["decode_int8"] = row_err(got[row], ref[row])
    row = int(np.argmax(ctx_ver))
    got = paged_spec_verify_attention_cuda(qt, kc, vc, tables, cv,
                                           **bad_scales(sc, int(tables_np[row, j])))
    ref = paged_spec_verify_attention_torch(qt, kc, vc, tables, cv, **sc)
    faults["verify_int8"] = row_err(got[row], ref[row])
    kp, vp, _ = pools[0]
    bad_np = tables_np.copy()
    bad_np[row, j] = bad_np[row, j] % (nblocks - 1) + 1
    got = paged_spec_verify_attention_cuda(qt, kp, vp, torch.from_numpy(bad_np).to(dev), cv)
    ref = paged_spec_verify_attention_torch(qt, kp, vp, tables, cv)
    faults["verify_bf16"] = row_err(got[row], ref[row])
    for name, (err, rel) in faults.items():
        what = "one wrong table entry" if name.endswith("bf16") else "one block's scales wrong"
        log(f"  {name} planted fault ({what}, longest row): max_abs_err={err:.3e}, "
            f"row err/RMS={rel:.4f} (must exceed tol {ROWS_TOL:g})")
        if rel <= ROWS_TOL:
            raise AssertionError(f"{name} tolerance passes a planted fault; it is too loose")
    out["planted_faults"] = {k: {"max_abs_err": e, "row_err_over_rms": r}
                             for k, (e, r) in faults.items()}

    def time_case(kind, ng, ctx_np, tables_np, label):
        c = torch.from_numpy(ctx_np.astype(np.int32)).to(dev)
        tb = torch.from_numpy(tables_np).to(dev)
        kp, vp, sc = pools[ng]
        if kind == "decode":
            kern = lambda: paged_decode_attention_int8_cuda(q1, kp, vp, tb, c, **sc)  # noqa: E731
            plain = lambda: paged_decode_attention_torch(q1, kp, vp, tb, c, **sc)  # noqa: E731
        else:
            kern = lambda: paged_spec_verify_attention_cuda(qt, kp, vp, tb, c, **sc)  # noqa: E731
            plain = lambda: paged_spec_verify_attention_torch(qt, kp, vp, tb, c, **sc)  # noqa: E731
        w = rows_work(ctx_np, 1 if kind == "decode" else t, ng)
        kt, pt = measure(kern, 100), measure(plain, 5)
        r = {"ms": kt["ms"], "plain_ms": pt["ms"], "host_ms": kt["host_ms"],
             "plain_host_ms": pt["host_ms"], **w}
        log(f"  {label}: device kernel {r['ms']*1e3:.1f} us, plain {r['plain_ms']*1e3:.1f} us, "
            f"bound {r['bound_ms']*1e3:.1f} us ({r['live_tokens']} live positions, "
            f"{r['bytes'] / (r['ms'] * 1e-3) / 1e9:.0f} GB/s); host loop: kernel "
            f"{r['host_ms']*1e3:.1f} us [{card}]")
        return r

    out["timing"] = {
        "decode_int8_random_ctx": time_case("decode", 1, ctx_dec, tables_np,
                                            "paged_decode int8 ng=1 random ctx 0..8191"),
        "verify_bf16_random_ctx": time_case("verify", 0, ctx_ver, tables_np,
                                            "paged_spec_verify bf16 t=5 random ctx"),
        "verify_int8_random_ctx": time_case("verify", 1, ctx_ver, tables_np,
                                            "paged_spec_verify int8 ng=1 t=5 random ctx"),
    }
    log("  paged_decode int8 / paged_spec_verify: no single PyTorch call computes these "
        "functions (block-table gather, in-register dequant, per-row masked GQA softmax), "
        "so they have no library time")
    return out, time_case


PAGED_FAULTS = [   # paged_sm90.cu's planted faults: code, what, (kind, ng) it runs at
    (1, "the merge drops each sequence's last split", (("decode", 0), ("verify", 0))),
    (2, "a ring stage read before its copy lands", (("verify", 0), ("verify", 4))),
    (3, "the K scale left out at ng = 1", (("decode", 1), ("verify", 1)))]


def phase_paged_sm90(seed: int, card: str):
    """What ``paged_sm90.cu``'s design adds to check: contexts at the edges
    of its splits at the Llama-3-8B shapes (live lengths one before a split
    boundary, on it and one after; within one split; the table's last
    position), Falcon-7B's shapes (71 query heads over one kv head, hd 64:
    decode, and verify at t = 5 over 355 rows; bf16 and int8 at one scale
    per vector), two calls giving identical bits, and its planted faults
    failing the row check; each against the plain version."""
    import torch

    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_torch, paged_planted_fault,
        paged_spec_verify_attention_cuda, paged_spec_verify_attention_torch, splits_of)
    from deepspeed_tpu_torch.ops.quantization import kv_quantize_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    rs = np.random.RandomState(seed + 11)

    def pools(nblocks, nkv, bs, hd, ngs):
        kf, vf = (torch.randn(nblocks, nkv, bs, hd, generator=gen, device=dev) for _ in range(2))
        out = {0: (kf.to(torch.bfloat16), vf.to(torch.bfloat16), {})}
        for ng in ngs:
            (kc, ks), (vc, vs) = kv_quantize_int8(kf, hd // ng), kv_quantize_int8(vf, hd // ng)
            out[ng] = (kc, vc, {"k_scale": ks, "v_scale": vs})
        return out

    def call(kind, q, p, tables, ctx, window=None):
        kp, vp, sc = p
        if kind == "decode":
            return (paged_decode_attention_cuda(q, kp, vp, tables, ctx, window=window, **sc),
                    paged_decode_attention_torch(q, kp, vp, tables, ctx, window=window, **sc))
        return (paged_spec_verify_attention_cuda(q, kp, vp, tables, ctx, window=window, **sc),
                paged_spec_verify_attention_torch(q, kp, vp, tables, ctx, window=window, **sc))

    def tol(kind, ng):
        return DECODE_TOL if kind == "decode" and not ng else ROWS_TOL

    out = {"split_edges": {}, "falcon": {}, "determinism": {}, "planted_faults": {}}
    S = ROWS_SHAPE
    nh, nkv, hd, bs, nblocks, mb = S["nh"], S["nkv"], S["hd"], S["bs"], S["nblocks"], \
        S["max_blocks"]
    cap, t = mb * bs, SPEC_K + 1
    p = pools(nblocks, nkv, bs, hd, (1, 4))
    # live lengths (ctx + t) around split boundaries: 64 | 65 (one split |
    # two), 512 | 513 (8 of 64 | 7 of 80), 4096 | 4097 (8 of 512 | 9), the
    # table's end (16 of 512)
    lengths = [17, 63, 64, 65, 511, 512, 513, 4095, 4096, 4097, cap]
    for kind, tt in (("decode", 1), ("verify", t)):
        ctx_np = np.array([0] + [n - tt for n in lengths], np.int32)
        tables_np = rs.randint(1, nblocks, (len(ctx_np), mb)).astype(np.int32)
        tables_np[0] = 0
        ctx, tables = torch.from_numpy(ctx_np).to(dev), torch.from_numpy(tables_np).to(dev)
        shape_q = (len(ctx_np), nh, hd) if kind == "decode" else (len(ctx_np), tt, nh, hd)
        q = torch.randn(*shape_q, generator=gen, device=dev).to(torch.bfloat16)
        for ng in (0, 1, 4):
            for window in (None, 4095):
                got, ref = call(kind, q, p[ng], tables, ctx, window)
                torch.cuda.synchronize()
                name = f"{kind} {'int8 ng=%d' % ng if ng else 'bf16'} window={window}"
                out["split_edges"][name] = check_close(
                    f"paged_sm90 split edges {name} (splits "
                    f"{[splits_of(min(c + tt, cap)) for c in ctx_np.tolist()]})",
                    got, ref, tol(kind, ng))
        if kind == "verify":
            # determinism and the planted faults at the verify edges
            for ng in (0, 1):
                first = call(kind, q, p[ng], tables, ctx)[0].clone()
                again = call(kind, q, p[ng], tables, ctx)[0]
                torch.cuda.synchronize()
                same = bool(torch.equal(first, again))
                log(f"  paged_sm90 verify {'int8' if ng else 'bf16'}: two calls identical: {same}")
                if not same:
                    raise AssertionError("paged_sm90.cu gave two results on the same inputs")
                out["determinism"][f"verify ng={ng}"] = same
        for fault, what, runs in PAGED_FAULTS:
            for fng in [ng for k_, ng in runs if k_ == kind]:
                ref = call(kind, q, p[fng], tables, ctx)[1]
                with paged_planted_fault(fault):
                    bad = call(kind, q, p[fng], tables, ctx)[0]
                    torch.cuda.synchronize()
                err, rel = row_err(bad, ref)
                finite = bool(torch.isfinite(bad.float()).all())
                lim = tol(kind, fng)
                log(f"  paged_sm90 planted fault {fault} ({what}; {kind} "
                    f"{'int8 ng=%d' % fng if fng else 'bf16'}): max_abs_err={err:.3e}, "
                    f"row err/RMS={rel:.4f}, finite {finite} (must exceed tol {lim:g} or not "
                    "be finite)")
                if rel <= lim and finite:
                    raise AssertionError(f"the paged check passes a planted fault ({what})")
                out["planted_faults"][f"{fault} {kind} ng={fng}"] = {
                    "what": what, "row_err_over_rms": rel, "finite": finite}
                # a faulty launch leaves the ticket counters as the sound one does
                got, ref = call(kind, q, p[fng], tables, ctx)
                check_close(f"paged_sm90 {kind} after planted fault {fault}", got, ref, lim)
    del p

    # Falcon-7B: 71 query heads over one kv head at hd 64
    nh, nkv, hd, bs, nblocks, mb = 71, 1, 64, 128, 128, 16
    p = pools(nblocks, nkv, bs, hd, (1,))
    for kind, tt in (("decode", 1), ("verify", t)):
        ctx_np = np.array([0, 5, 63, 64, 300, 513 - tt, 1000, mb * bs - tt], np.int32)
        tables_np = rs.randint(1, nblocks, (len(ctx_np), mb)).astype(np.int32)
        tables_np[0] = 0
        ctx, tables = torch.from_numpy(ctx_np).to(dev), torch.from_numpy(tables_np).to(dev)
        shape_q = (len(ctx_np), nh, hd) if kind == "decode" else (len(ctx_np), tt, nh, hd)
        q = torch.randn(*shape_q, generator=gen, device=dev).to(torch.bfloat16)
        for ng in (0, 1):
            got, ref = call(kind, q, p[ng], tables, ctx)
            torch.cuda.synchronize()
            name = f"{kind} {'int8 ng=1' if ng else 'bf16'}"
            out["falcon"][name] = check_close(
                f"paged_sm90 Falcon-7B {name} (nh 71 over 1 kv head, hd 64, "
                f"{71 * tt} rows)", got, ref, tol(kind, ng))
    del p
    torch.cuda.empty_cache()
    return out


def opt_paged_times(seed: int, card: str, dec_inputs, ver_inputs) -> dict:
    """OPT-1.3B's main-path step (MHA 32/32, hd 64, tables of 16 blocks):
    bf16 decode and int8 verify (t = 5) on the inputs of its serving
    phase's last steps, timed as ``phase_rows_kernels`` times Llama's."""
    import torch

    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_torch,
        paged_spec_verify_attention_cuda, paged_spec_verify_attention_torch)
    from deepspeed_tpu_torch.ops.quantization import kv_quantize_int8

    S = OPT_ROWS_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    kf, vf = (torch.randn(S["nblocks"], S["nkv"], S["bs"], S["hd"], generator=gen, device=dev)
              for _ in range(2))
    kb, vb = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    (kc, ks), (vc, vs) = kv_quantize_int8(kf, S["hd"]), kv_quantize_int8(vf, S["hd"])
    del kf, vf
    q1 = torch.randn(S["B"], S["nh"], S["hd"], generator=gen, device=dev).to(torch.bfloat16)
    qt = torch.randn(S["B"], SPEC_K + 1, S["nh"], S["hd"], generator=gen,
                     device=dev).to(torch.bfloat16)
    out = {}
    for name, (ctx_np, tables_np), t, ng in (("decode_bf16_main_path", dec_inputs, 1, 0),
                                            ("verify_int8_main_path", ver_inputs, SPEC_K + 1, 1)):
        c = torch.from_numpy(ctx_np.astype(np.int32)).to(dev)
        tb = torch.from_numpy(tables_np).to(dev)
        if ng:
            sc = {"k_scale": ks, "v_scale": vs}
            kern = lambda: paged_spec_verify_attention_cuda(qt, kc, vc, tb, c, **sc)  # noqa: E731
            plain = lambda: paged_spec_verify_attention_torch(qt, kc, vc, tb, c, **sc)  # noqa: E731
        else:
            kern = lambda: paged_decode_attention_cuda(q1, kb, vb, tb, c)  # noqa: E731
            plain = lambda: paged_decode_attention_torch(q1, kb, vb, tb, c)  # noqa: E731
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check_close(f"OPT-1.3B {name}", got, ref, ROWS_TOL if ng else DECODE_TOL)
        w = rows_work(ctx_np, t, ng, shape=S)
        kt, pt = measure(kern, 100), measure(plain, 5)
        r = {"ms": kt["ms"], "plain_ms": pt["ms"], "host_ms": kt["host_ms"],
             "plain_host_ms": pt["host_ms"], **w}
        log(f"  OPT-1.3B {name}: device kernel {r['ms']*1e3:.1f} us, plain "
            f"{r['plain_ms']*1e3:.1f} us, bound {r['bound_ms']*1e3:.2f} us "
            f"({r['live_tokens']} live positions); host loop: kernel {r['host_ms']*1e3:.1f} us "
            f"[{card}]")
        out[name] = r
    del kb, vb, kc, vc
    torch.cuda.empty_cache()
    return out


def spec_prompts(seed: int, vocab: int):
    """Eight prompts of 24..500 tokens, each its own opening span repeated
    three times, so the drafter finds an earlier occurrence of the trailing
    n-gram once the model repeats itself."""
    rs = np.random.RandomState(seed + 7)
    lengths = [24, 64, 100, 129, 150, 200, 300, 500]
    prompts = []
    for n in lengths:
        span = rs.randint(0, vocab, n // 3 + 1)
        prompts.append(np.concatenate([span, span, span])[:n].astype(np.int32))
    return prompts, lengths


SPEC = {"speculative": {"enabled": True, "fused_verify": True,
                        "max_draft_tokens": SPEC_K}}
INT8 = {"kv_quant": {"enabled": True, "group_size": 128}}


def phase_spec_serving(seed: int, max_new_tokens: int, card: str, family=None, cfg=None,
                       norm: str = "rms_norm", engines=None):
    """A model at full width and depth through ``generate`` in several
    engines in turn, each ``(name, extra config, prompts)``; launch counts
    held to the engine's own step counts. By default Llama-3-8B with
    speculative decoding and fused verification on bf16 pools, the same on
    int8 pools, and int8 pools alone (whose every step is an int8 decode),
    all on self-repeating prompts. ``norm`` names the family's norm op (one
    launch per norm, 2 per layer and a final one)."""
    import torch

    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, rms_norm_cuda
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_int8_cuda,
        paged_spec_verify_attention_cuda)

    family = family or llama
    cfg = cfg or llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = family.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    if engines is None:
        prompts, _ = spec_prompts(seed, cfg.vocab_size)
        engines = (("spec_bf16", SPEC, prompts), ("spec_int8", {**SPEC, **INT8}, prompts),
                   ("int8", INT8, prompts))
    other_norm = "layer_norm" if norm == "rms_norm" else "rms_norm"
    counters = {"rms_norm": rms_norm_cuda, "layer_norm": layer_norm_cuda,
                "paged_decode_attention": paged_decode_attention_cuda,
                "paged_decode_attention_int8": paged_decode_attention_int8_cuda,
                "paged_spec_verify_attention": paged_spec_verify_attention_cuda}
    res = {"max_new_tokens": max_new_tokens, "num_layers": cfg.num_layers,
           "max_draft_tokens": SPEC_K}
    for name, extra, prompts in engines:
        lengths = [len(p) for p in prompts]
        t0 = time.perf_counter()
        eng = build_engine_v2(family, cfg, params, config=dict({
            "dtype": "bfloat16", "prefill_bucket": 64,
            "ragged": {"max_tracked_sequences": 64, "max_ragged_batch_size": 64,
                       "memory_config_blocks": 512, "block_size": 128}}, **extra))
        torch.cuda.synchronize()
        pool_bytes = sum(x.numel() * x.element_size() for x in eng.cache.values())
        log(f"  {name}: pools {sorted(eng.cache)} {pool_bytes/1e9:.3f} GB, "
            f"set-up {time.perf_counter()-t0:.1f} s")
        eng.generate([prompts[0], prompts[4]], max_new_tokens=4)   # warm-up
        per_replay = capture_decode_graph(eng, prompts[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.forward_log.clear()
        stats0 = dict(eng.spec_stats)
        for c in counters.values():
            c.launches = 0
        replays0 = eng.graph_replays
        t_start = time.monotonic()
        outs = eng.generate(prompts, max_new_tokens=max_new_tokens)
        t_end = time.monotonic()
        replays = eng.graph_replays - replays0
        launches = with_replays({k: c.launches for k, c in counters.items()}, per_replay,
                                replays)
        peak = torch.cuda.max_memory_allocated()
        stats = {k: v - stats0[k] for k, v in eng.spec_stats.items()}
        for o in outs:
            assert len(o) == max_new_tokens and all(0 <= x < cfg.vocab_size for x in o), o
        kinds = {k: [e for e in eng.forward_log if e[0] == k]
                 for k in ("prefill", "decode", "verify")}
        n_fwd = sum(len(v) for v in kinds.values())
        quant, spec_on = "kv_quant" in extra, "speculative" in extra
        decode_key = "paged_decode_attention_int8" if quant else "paged_decode_attention"
        other_key = "paged_decode_attention" if quant else "paged_decode_attention_int8"
        want = {norm: (2 * cfg.num_layers + 1) * n_fwd, other_norm: 0,
                decode_key: cfg.num_layers * len(kinds["decode"]), other_key: 0,
                "paged_spec_verify_attention": cfg.num_layers * len(kinds["verify"])}
        log(f"  {name}: forwards {len(kinds['prefill'])} prefill + {len(kinds['verify'])} "
            f"verify + {len(kinds['decode'])} decode ({replays} replays of the decode graph, "
            f"whose kernel nodes hold {per_replay}); launches {launches}, expected {want}; "
            f"spec stats {stats}")
        if spec_on:
            # every verify step is a fused one, and the launches match the
            # engine's own step counts
            ok = stats["fused_verify_steps"] >= 1 \
                and len(kinds["verify"]) == stats["fused_verify_steps"] \
                and len(kinds["decode"]) == stats["decode_steps"]
        else:
            ok = len(kinds["decode"]) >= 1 and not kinds["verify"]
        if launches != want or not ok or replays != len(kinds["decode"]):
            raise AssertionError(f"{name}: kernel launch counts {launches} != expected {want} "
                                 f"or step counts disagree (spec stats {stats})")
        first = kinds["prefill"][0]
        step_ms = {k: (sum(e[1] for e in kinds[k]) / len(kinds[k]) * 1e3 if kinds[k] else None)
                   for k in ("verify", "decode")}
        r = {"prompt_lengths": lengths, "n_forwards": n_fwd,
             "ttft_ms": (first[3] - t_start) * 1e3, "prefill_ms": first[1] * 1e3,
             "verify_step_ms": step_ms["verify"], "decode_step_ms": step_ms["decode"],
             "tokens_per_step": (stats["emitted_tokens"] / stats["step_seqs"]
                                 if spec_on else 1.0),
             "acceptance_rate": (stats["accepted_tokens"] / max(stats["drafted_tokens"], 1)
                                 if spec_on else None),
             "spec_stats": stats, "launches": launches, "per_replay": per_replay,
             "replays": replays, "pool_bytes": pool_bytes,
             "peak_mem_bytes": peak, "e2e_s": t_end - t_start,
             "generated_tokens_per_s": len(prompts) * max_new_tokens / (t_end - t_start)}
        fmt = lambda v, f: "n/a" if v is None else f % v  # noqa: E731
        log(f"  {name}: TTFT {r['ttft_ms']:.1f} ms, {r['tokens_per_step']:.3f} tokens per "
            f"sequence-step, acceptance {fmt(r['acceptance_rate'], '%.3f')} "
            f"({stats['accepted_tokens']}/{stats['drafted_tokens']}), verify step "
            f"{fmt(r['verify_step_ms'], '%.2f ms')} ({len(kinds['verify'])}), decode step "
            f"{fmt(r['decode_step_ms'], '%.2f ms')} ({len(kinds['decode'])}), "
            f"{r['generated_tokens_per_s']:.1f} generated tok/s, pool {pool_bytes/1e9:.3f} GB, "
            f"peak mem {peak/2**30:.2f} GiB [{card}]")

        # where the time goes: the burst's prefill and 6 steps under the
        # profiler (device-busy vs wall time), after the counted run
        uids = list(range(1000, 1000 + len(prompts)))
        eng.put_many(list(zip(uids, prompts)))
        wall, busy, n_k, top = profile_window(lambda: [eng.step() for _ in range(6)])
        r["profile_steps"] = {"wall_ms_per_step": wall * 1e3 / 6,
                              "busy_ms_per_step": busy * 1e3 / 6,
                              "idle_share": 1 - busy / wall, "kernels_per_step": n_k / 6,
                              "top": [(k, ms / 6, c // 6) for k, ms, c in top[:10]]}
        p = r["profile_steps"]
        log(f"  {name} profile of 6 steps: wall {p['wall_ms_per_step']:.2f} ms, device busy "
            f"{p['busy_ms_per_step']:.2f} ms (idle {p['idle_share']:.1%}), "
            f"{p['kernels_per_step']:.0f} kernels per step [{card}]")
        for k, ms, c in p["top"][:6]:
            log(f"    {ms:8.3f} ms  x{c:<4d} {k[:90]}")
        for u in uids:
            eng.finish(u)
        res[name] = r
        del eng
        torch.cuda.empty_cache()
    if "spec_int8" in res and "spec_bf16" in res:
        res["pool_ratio_int8_to_bf16"] = \
            res["spec_int8"]["pool_bytes"] / res["spec_bf16"]["pool_bytes"]
        log(f"  int8 pools {res['pool_ratio_int8_to_bf16']:.4f} x the bf16 pools' bytes")
    del params
    torch.cuda.empty_cache()
    return res


def phase_whole_path_spec(seed: int, card: str):
    """2 layers at Llama-3-8B width on int8 pools: one prompt's prefill, one
    fused verify step with a fixed draft and 2 decode steps, on the card
    (kernels) and on the CPU (plain versions), logits compared."""
    import torch

    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.models._paged import fused_verify_scope
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_int8_cuda, paged_spec_verify_attention_cuda)

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    params = llama.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    rs = np.random.RandomState(seed + 4)
    prompt = rs.randint(0, cfg.vocab_size, 125).astype(np.int32)
    pad_t, bs, nblocks = 128, 128, 8
    tokens = np.zeros((1, pad_t), np.int32)
    tokens[0, :len(prompt)] = prompt
    valid = np.arange(pad_t)[None, :] < len(prompt)
    # the verify rows at 125..129 cross the edge of the first block
    tables = np.array([[3, 5] + [0] * (cfg.max_seq_len // bs - 2)], np.int32)
    draft = prompt[10:10 + SPEC_K]

    def run(device, params, feed):
        with torch.device("meta"):
            model = llama.build(cfg)
        model.load_state_dict({k: v.to(device) for k, v in params.items()},
                              strict=True, assign=True)
        cache = llama.init_paged_cache(cfg, nblocks, bs, torch.bfloat16, device,
                                       kv_quant_group=128)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        logits, cache = llama.apply_paged(cfg, model, t(tokens), cache, t(tables),
                                          t(np.zeros(1, np.int32)), valid=t(valid))
        outs = [logits[0, len(prompt) - 1:len(prompt)].float().cpu()]
        first = int(outs[0][0].argmax()) if feed is None else feed[0]
        with fused_verify_scope():
            logits, cache = llama.apply_paged(
                cfg, model, t(np.array([[first, *draft]], np.int32)), cache, t(tables),
                t(np.array([len(prompt)], np.int32)))
        outs.append(logits[0].float().cpu())
        nxt = int(outs[-1][-1].argmax()) if feed is None else feed[1]
        fed = [first, nxt]
        for s in range(2):
            ctx = np.array([len(prompt) + SPEC_K + 1 + s], np.int32)
            logits, cache = llama.apply_paged(cfg, model, t(np.array([[nxt]], np.int32)),
                                              cache, t(tables), t(ctx))
            outs.append(logits[0].float().cpu())
            nxt = int(outs[-1][0].argmax()) if feed is None else feed[2 + s]
            fed.append(nxt)
        return torch.cat(outs), fed

    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        paged_decode_attention_int8_cuda.launches = 0
        paged_spec_verify_attention_cuda.launches = 0
        t0 = time.perf_counter()
        gpu_logits, fed = run(torch.device("cuda"), params, None)
        gpu_s = time.perf_counter() - t0
        launches = (paged_spec_verify_attention_cuda.launches,
                    paged_decode_attention_int8_cuda.launches)
        if launches != (cfg.num_layers, 2 * cfg.num_layers):
            raise AssertionError(f"whole path launched (verify, int8 decode) {launches}")
        cpu_params = {k: v.cpu() for k, v in params.items()}
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu_logits, _ = run(torch.device("cpu"), cpu_params, fed)
        cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    assert gpu_logits.shape == (1 + SPEC_K + 1 + 2, cfg.vocab_size)
    assert torch.isfinite(gpu_logits).all() and torch.isfinite(cpu_logits).all()
    err, rel = check_close("2-layer 8B-width logits on int8 pools, card vs CPU "
                           f"(prefill + fused verify of {SPEC_K} drafts + 2 decode)",
                           gpu_logits, cpu_logits, WHOLE_PATH_TOL)
    agree = float((gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean())
    log(f"  greedy agreement {agree:.2f}; card {gpu_s:.1f} s, cpu {cpu_s:.1f} s [{card}]")
    return {"max_abs_err": err, "max_row_err_over_rms": rel, "tol": WHOLE_PATH_TOL,
            "argmax_agreement": agree}


# --------------------------------------------------------------------------- #
def phase_whole_path(seed: int, card: str, family=None, cfg=None, label="8B-width"):
    """2 layers at full width (Llama-3-8B by default): one prompt's prefill
    and 4 decode steps on the card (kernels) and on the CPU (plain
    versions), logits compared."""
    import torch

    from deepspeed_tpu_torch.models import llama

    family = family or llama
    cfg = dataclasses.replace(cfg or llama.LlamaConfig.llama3_8b(), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = family.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    rs = np.random.RandomState(seed + 1)
    prompt = rs.randint(0, cfg.vocab_size, 48).astype(np.int32)
    pad_t, bs, nblocks, steps = 64, 128, 8, 4
    tokens = np.zeros((1, pad_t), np.int32)
    tokens[0, :len(prompt)] = prompt
    valid = np.arange(pad_t)[None, :] < len(prompt)
    tables = np.array([[3, 5] + [0] * (cfg.max_seq_len // bs - 2)], np.int32)

    def run(device, params, feed):
        with torch.device("meta"):
            model = family.build(cfg)
        model.load_state_dict({k: v.to(device) for k, v in params.items()},
                              strict=True, assign=True)
        cache = family.init_paged_cache(cfg, nblocks, bs, torch.bfloat16, device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        logits, cache = family.apply_paged(cfg, model, t(tokens), cache, t(tables),
                                          t(np.zeros(1, np.int32)), valid=t(valid))
        outs = [logits[0, len(prompt) - 1].float().cpu()]
        nxt = int(outs[0].argmax()) if feed is None else feed[0]
        fed = [nxt]
        for s in range(steps):
            ctx = np.array([len(prompt) + s], np.int32)
            logits, cache = family.apply_paged(cfg, model, t(np.array([[nxt]], np.int32)),
                                              cache, t(tables), t(ctx))
            outs.append(logits[0, 0].float().cpu())
            nxt = int(outs[-1].argmax()) if feed is None else feed[s + 1]
            fed.append(nxt)
        return torch.stack(outs), fed

    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        t0 = time.perf_counter()
        gpu_logits, fed = run(torch.device("cuda"), params, None)
        gpu_s = time.perf_counter() - t0
        cpu_params = {k: v.cpu() for k, v in params.items()}
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu_logits, _ = run(torch.device("cpu"), cpu_params, fed)
        cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    assert gpu_logits.shape == (steps + 1, cfg.vocab_size)
    assert torch.isfinite(gpu_logits).all() and torch.isfinite(cpu_logits).all()
    err, rel = check_close(f"2-layer {label} logits, card vs CPU (prefill + 4 decode)",
                           gpu_logits, cpu_logits, WHOLE_PATH_TOL)
    agree = float((gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean())
    log(f"  greedy agreement {agree:.2f}; card {gpu_s:.1f} s, cpu {cpu_s:.1f} s "
        f"(logit std {float(cpu_logits.std()):.3f}) [{card}]")
    return {"max_abs_err": err, "max_row_err_over_rms": rel, "tol": WHOLE_PATH_TOL,
            "argmax_agreement": agree}


# --------------------------------------------------------------------------- #
FLASH_CASES = [   # name, Sq, Skv, kv heads, causal, q_offset, window
    ("causal S=4096", 4096, 4096, 8, True, 0, None),
    ("tail S=1000", 1000, 1000, 8, True, 0, None),
    ("Sq=512 Skv=4096 q_offset=3584", 512, 4096, 8, True, 3584, None),
    ("window 1024 S=4096", 4096, 4096, 8, True, 0, 1024),
    ("non-causal S=4096", 4096, 4096, 8, False, 0, None),
    ("MHA 32/32 S=4096", 4096, 4096, 32, True, 0, None),
]
H, HD = 32, 128


def flash_work(sq, skv, hkv, causal, q_offset, window, b=1, hd=HD) -> dict:
    """Visible (q, k) pairs of the case and, per kernel, the operations its
    products need (2 * hd per pair and product: forward QK^T and PV; dQ
    three products; dK/dV four) and the bytes it must move (each input
    read once, each output written once; bf16 tensors, fp32 lse/delta)."""
    from deepspeed_tpu_torch.ops.flash_attention import _visible

    pairs = int(_visible(sq, skv, causal, q_offset, window, "cpu").sum()) * b * H
    q_bytes = b * sq * H * hd * 2
    kv_bytes = b * skv * hkv * hd * 2
    row_bytes = b * H * sq * 4
    return {"pairs": pairs,
            "fwd": {"flops": 4 * hd * pairs, "bytes": 2 * q_bytes + 2 * kv_bytes + row_bytes},
            "dq": {"flops": 6 * hd * pairs, "bytes": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes},
            "dkv": {"flops": 8 * hd * pairs,
                    "bytes": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes}}


BWD_FAULTS = [   # flash_bwd_sm90.cu's planted faults: (code, what, grads that must fail)
    (1, "ring stage read one step late", ("dq", "dk")),
    (2, "last tile of each band dropped", ("dq", "dv")),
    (3, "last query head of each GQA group skipped", ("dk", "dv")),
]


def _bwd_pieces(q, k, v, do, o, lse, kw) -> dict:
    """The dQ and dK/dV wrappers on the forward's o and lse."""
    import torch

    from deepspeed_tpu_torch.ops.flash_attention import flash_bwd_dkv_cuda, flash_bwd_dq_cuda

    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    got = {"dq": flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)}
    got["dk"], got["dv"] = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    return got


def _time_flash(q, k, v, do, kw, work) -> dict:
    """Device times of the three no-bias kernels on these inputs beside
    their bounds, the plain versions' and SDPA's (forward; backward as the
    forward-and-backward time less the forward's, all three grads)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_torch, flash_fwd_cuda, flash_fwd_torch)

    o, lse = flash_fwd_cuda(q, k, v, **kw)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    t = {"fwd": measure(lambda: flash_fwd_cuda(q, k, v, **kw), 10),
         "dq": measure(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw), 10),
         "dkv": measure(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw), 10)}
    plain = {"fwd": measure(lambda: flash_fwd_torch(q, k, v, **kw), 3),
             "bwd": measure(lambda: flash_bwd_torch(q, k, v, o, lse, do, **kw), 3)}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    dot = do.transpose(1, 2)
    gqa = {}
    if kt.shape[1] != qt.shape[1]:
        try:     # the yardstick's own GQA option (PyTorch >= 2.5); else widened K/V
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            gqa = {"enable_gqa": True}
        except TypeError:
            kt, vt = (x.repeat_interleave(qt.shape[1] // kt.shape[1], dim=1) for x in (kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)

    def sdpa_fwd_bwd():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, is_causal=True, **gqa).backward(dot)

    lib_fwd = measure(sdpa, 10)["ms"]
    lib_bwd = measure(sdpa_fwd_bwd, 10)["ms"] - lib_fwd
    rows = {}
    for key, plain_key, lib in (("fwd", "fwd", lib_fwd), ("dq", "bwd", lib_bwd),
                                ("dkv", "bwd", lib_bwd)):
        w = work[key]
        t_ops, t_bytes = w["flops"] / BF16_FLOPS, w["bytes"] / HBM_BYTES_PER_S
        rows[key] = {"ms": t[key]["ms"], "host_ms": t[key]["host_ms"],
                     "plain_ms": plain[plain_key]["ms"], "library_ms": lib,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": w["flops"], "bytes": w["bytes"]}
    return rows


def phase_flash(seed: int, card: str):
    import torch

    from deepspeed_tpu_torch.ops.attention import attention_torch
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd_torch, flash_fwd_cuda, sm90_planted_fault)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False     # the fp32 reference in full fp32
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    out = {"cases": {}, "tol": FLASH_TOL, "floor": FLASH_FLOOR}
    main = None
    for name, sq, skv, hkv, causal, q_offset, window in FLASH_CASES:
        kw = dict(causal=causal, q_offset=q_offset, window=window)
        q, k, v = (torch.randn(1, n, hh, HD, generator=gen, device=dev).to(torch.bfloat16)
                   for n, hh in ((sq, H), (skv, hkv), (skv, hkv)))
        do = torch.randn(1, sq, H, HD, generator=gen, device=dev).to(torch.bfloat16)
        res = {}
        for label, fn, dtype in (("kernel", flash_attention, torch.bfloat16),
                                 ("plain", attention_torch, torch.float32)):
            leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, **kw)
            (o.float() * do.float()).sum().backward()
            res[label] = [o.detach()] + [t.grad for t in leaves]
            del o, leaves
        torch.cuda.synchronize()
        errs = {}
        for key, got, ref in zip(("o", "dq", "dk", "dv"), res["kernel"], res["plain"]):
            errs[key] = check_close(f"flash {name} {key}", got, ref, FLASH_TOL[key],
                                    floor=FLASH_FLOOR[key])
        out["cases"][name] = _pieces_result(errs)
        if name == FLASH_CASES[0][0]:
            main = (q, k, v, do, kw, res["plain"][0])
        del res
        torch.cuda.empty_cache()

    # planted fault: one 64-row K tile swapped with another on the S = 4096
    # case must fail the forward check against the sound plain output
    q, k, v, do, kw, o_ref = main
    bad = k.clone()
    bad[:, 1024:1088], bad[:, 2048:2112] = k[:, 2048:2112], k[:, 1024:1088]
    o_bad, _ = flash_fwd_cuda(q, bad, v, **kw)
    fault_err, fault_rel = row_err(o_bad, o_ref, floor=FLASH_FLOOR["o"])
    log(f"  flash planted fault (K rows 1024:1088 <-> 2048:2112): max_abs_err={fault_err:.3e}, "
        f"row err/RMS={fault_rel:.4f} (must exceed tol {FLASH_TOL['o']:g})")
    if fault_rel <= FLASH_TOL["o"]:
        raise AssertionError("flash tolerance passes a swapped K tile; it is too loose")
    out["planted_fault"] = {"max_abs_err": fault_err, "row_err_over_rms": fault_rel}
    del bad, o_bad
    # the bf16 forward's own planted faults (flash_fwd_sm90.cu) must fail too
    out["planted_faults_sm90"] = {}
    for fault, what in ((1, "ring stage read one step late"),
                        (2, "last kv tile of the causal band dropped")):
        with sm90_planted_fault(fault):
            o_bad, _ = flash_fwd_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
        out["planted_faults_sm90"][what] = _fault_must_fail(what, o_bad, o_ref, "o")
        del o_bad
    del o_ref

    # the bf16 backward's wrappers (flash_bwd_sm90.cu) against their plain
    # pieces on the same o and lse, and its planted faults
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    ref = dict(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, **kw)))
    out["pieces"] = _pieces_result(_check_pieces(
        "flash bwd pieces S=4096 causal", _bwd_pieces(q, k, v, do, o, lse, kw), ref,
        ("dq", "dk", "dv")))
    out["planted_faults_bwd_sm90"] = {}
    for fault, what, keys in BWD_FAULTS:
        with sm90_planted_fault(fault, "bwd"):
            bad = _bwd_pieces(q, k, v, do, o, lse, kw)
        out["planted_faults_bwd_sm90"][what] = [
            _fault_must_fail(f"{what}, {key}", bad[key], ref[key], key) for key in keys]
        del bad
    del ref, o, lse

    # times at the main path's shape (S = 4096 causal, 32/8 heads, hd 128)
    work = flash_work(4096, 4096, 8, True, 0, None)
    out["timing"] = _time_flash(q, k, v, do, kw, work)
    _log_times("S=4096 causal", out["timing"], card)
    out["pairs"] = work["pairs"]
    del q, k, v, do
    torch.cuda.empty_cache()
    out["opt"] = flash_opt_shape(gen, card)
    return out


def _pieces_result(errs: dict) -> dict:
    return {"max_abs_err": {k: e for k, (e, _) in errs.items()},
            "row_err_over_rms": {k: r for k, (_, r) in errs.items()}}


def _log_times(label: str, rows: dict, card: str) -> None:
    for key, r in rows.items():
        log(f"  flash {key} {label}: device kernel {r['ms']*1e3:.1f} us "
            f"({r['flops'] / (r['ms'] * 1e-3) / 1e12:.1f} TFLOP/s), bound "
            f"{r['bound_ms']*1e3:.1f} us ({r['bound_by']}), plain {r['plain_ms']*1e3:.1f} us, "
            f"SDPA {r['library_ms']*1e3:.1f} us [{card}]")
    log("  (plain and SDPA backward times cover dQ, dK and dV together)")


def flash_opt_shape(gen, card: str) -> dict:
    """The three no-bias kernels at OPT-1.3B's training shape (OPT_MICRO x
    2048 tokens, causal, 32/32 heads, hd 64): the forward held to its plain
    version, dQ and dK/dV to their plain pieces on its o and lse, then each
    timed beside its bound, the plain version and SDPA (the yardstick)."""
    import torch

    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_torch, flash_fwd_cuda, flash_fwd_torch)

    b, s, hd = OPT_MICRO, 2048, 64
    label = f"OPT-1.3B [{b}x{s}, 32/32 heads, hd {hd}] causal"
    kw = {"causal": True}
    q, k, v, do = (torch.randn(b, s, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    o_ref, _ = flash_fwd_torch(q, k, v, **kw)
    errs = {"o": check_close(f"flash fwd {label} o", o, o_ref, FLASH_TOL["o"],
                             floor=FLASH_FLOOR["o"])}
    del o_ref
    ref = dict(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, **kw)))
    errs.update(_check_pieces(f"flash bwd pieces {label}", _bwd_pieces(q, k, v, do, o, lse, kw),
                              ref, ("dq", "dk", "dv")))
    del o, lse, ref
    work = flash_work(s, s, H, True, 0, None, b=b, hd=hd)
    rows = _time_flash(q, k, v, do, kw, work)
    _log_times(label, rows, card)
    del q, k, v, do
    torch.cuda.empty_cache()
    return {"timing": rows, "pairs": work["pairs"], **_pieces_result(errs)}


def _train_config(seed: int, gas: int, bf16: bool, micro: int = 1) -> dict:
    return {"train_batch_size": gas * micro, "gradient_accumulation_steps": gas,
            "bf16": {"enabled": bf16},
            "optimizer": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 0},
            "seed": seed, "steps_per_print": 0}


def train_flops(cfg, seq: int, sequences: int) -> float:
    """Model FLOPs of one training step: 6 per matmul parameter per token,
    and 3x the forward attention products (QK^T, PV) over causal pairs."""
    h, i, v, hd = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.head_size
    if hasattr(cfg, "num_kv_heads"):     # Llama: GQA projections, gated MLP
        per_layer = h * cfg.num_heads * hd * 2 + 2 * h * cfg.num_kv_heads * hd + 3 * h * i
    else:                                # GPT-2/OPT: MHA, two-matrix MLP
        per_layer = 4 * h * h + 2 * h * i
    matmul_params = cfg.num_layers * per_layer + v * h
    attn = 3 * 4 * hd * cfg.num_heads * seq * (seq + 1) // 2 * cfg.num_layers
    return 6.0 * matmul_params * seq * sequences + attn * sequences


# kernel-name substrings that sort a profiled training step's device time
PROFILE_GROUPS = [
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel")),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel")),
    ("sparse", ("sparse_fwd_kernel", "sparse_dq_kernel", "sparse_dkv_kernel",
                "sparse_fwd_sm90_kernel", "sparse_dq_sm90_kernel", "sparse_dkv_sm90_kernel")),
    ("rms_norm", ("rms_norm_vec_kernel", "rms_norm_scalar_kernel",
                  "rms_norm_wide_kernel")),
    ("layer_norm", ("layer_norm_warp_kernel", "layer_norm_vec_kernel",
                    "layer_norm_scalar_kernel")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("softmax_ce", ("softmax", "SoftMax", "nll_loss", "cross_entropy")),
    ("reduce", ("reduce_kernel",)),
    ("copy_cast", ("copy_kernel", "direct_copy")),
    ("elementwise", ("elementwise_kernel",)),
]


def phase_train(seed: int, card: str, family=None, cfg=None, label="Llama-3-8B",
                seq: int = 4096, gas: int = 2, micro: int = 1, norm: str = "rms_norm",
                bias_mode: bool = False, norms_per_layer_extra: int = 1):
    """``initialize(model=family.model_spec(cfg))`` and TRAIN_STEPS steps of
    ``train_batch`` on one fixed batch of ``gas`` micro-batches of ``micro``
    sequences; by default Llama-3-8B width at 4 layers. ``norm`` names the
    family's norm op, launched 2 per layer plus ``norms_per_layer_extra`` per
    forward; ``bias_mode``: attention runs the flash kernels' bias mode
    (ALiBi), and the no-bias flash kernels must not launch."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bias_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_bias_cuda, flash_bwd_dq_cuda,
        flash_fwd_bias_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, rms_norm_cuda

    family = family or llama
    cfg = cfg or dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=4)
    t0 = time.perf_counter()
    eng, *_ = dst.initialize(model=family.model_spec(cfg),
                             config=_train_config(seed, gas, True, micro))
    n_params = sum(p.numel() for p in eng.state.params.values())
    log(f"  engine: {cfg.num_layers} layers at {label} width, {n_params/1e9:.3f} B params "
        f"(fp32 masters + AdamW), {gas} micro-batches of {micro} x {seq} tokens, "
        f"set-up {time.perf_counter()-t0:.1f} s")
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (gas * micro, seq + 1)).astype(np.int32)}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norms = {"rms_norm": rms_norm_cuda, "layer_norm": layer_norm_cuda}
    other_norm = "layer_norm" if norm == "rms_norm" else "rms_norm"
    flash = {"flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
             "flash_bwd_dkv": flash_bwd_dkv_cuda, "flash_fwd_bias": flash_fwd_bias_cuda,
             "flash_bwd_dq_bias": flash_bwd_dq_bias_cuda,
             "flash_bwd_dkv_bias": flash_bwd_dkv_bias_cuda}
    for c in (*flash.values(), *norms.values()):
        c.launches = 0
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = eng.train_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out.loss))
    launches = {**{k: c.launches for k, c in flash.items()},
                **{k: c.launches for k, c in norms.items()}}
    peak = torch.cuda.max_memory_allocated()
    per_step = cfg.num_layers * gas
    want = {k: (per_step * TRAIN_STEPS if k.endswith("_bias") == bias_mode else 0)
            for k in flash}
    want.update({norm: (2 * cfg.num_layers + norms_per_layer_extra) * gas * TRAIN_STEPS,
                 other_norm: 0})
    log(f"  losses {['%.4f' % l for l in losses]}; launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: {losses}")
    steady = step_s[1:]
    step_ms = sum(steady) / len(steady) * 1e3
    flops = train_flops(cfg, seq, gas * micro)
    res = {"losses": losses, "step_s": step_s, "step_ms": step_ms,
           "tokens_per_s": gas * micro * seq / (step_ms / 1e3), "model_flops_per_step": flops,
           "model_tflops": flops / (step_ms / 1e3) / 1e12, "peak_mem_bytes": peak,
           "launches": launches, "num_layers": cfg.num_layers, "seq": seq, "gas": gas,
           "micro": micro, "n_params": n_params}
    res["mfu"] = res["model_tflops"] * 1e12 / BF16_FLOPS
    log(f"  step {step_ms:.1f} ms (steps 2-{TRAIN_STEPS}; first {step_s[0]*1e3:.1f} ms), "
        f"{res['tokens_per_s']:.0f} tokens/s, model {res['model_tflops']:.1f} TFLOP/s "
        f"= {res['mfu']:.1%} of 989, peak mem {peak/2**30:.2f} GiB [{card}]")

    wall, busy, n_k, top = profile_window(lambda: eng.train_batch(batch))
    groups = {}
    for k, ms, c in top:
        g = next((g for g, keys in PROFILE_GROUPS if any(x in k for x in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    res["profile"] = {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3, "idle_share": 1 - busy / wall,
                      "kernels": n_k, "by_group_ms": groups,
                      "top": [(k, ms, c) for k, ms, c in top[:15]]}
    log(f"  profiled step: wall {wall*1e3:.1f} ms, device busy {busy*1e3:.1f} ms "
        f"(idle {1 - busy / wall:.1%}), {n_k} kernels [{card}]")
    log("  device ms by group: " + ", ".join(
        f"{g} {ms:.1f}" for g, ms in sorted(groups.items(), key=lambda t: -t[1])))
    for k, ms, c in top[:10]:
        log(f"    {ms:8.3f} ms  x{c:<5d} {k[:90]}")
    del eng
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def fault_zero_dv_head():
    """dV of kv head 0 zeroed in the dK/dV kernel's output."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    sound = fa.flash_bwd_dkv_cuda

    def faulty(*a, **kw):
        dk, dv = sound(*a, **kw)
        dv[:, :, 0] = 0
        return dk, dv

    faulty.launches = 0     # the sound wrapper counts on the module's name
    fa.flash_bwd_dkv_cuda = faulty
    try:
        yield "dV of kv head 0 zeroed"
    finally:
        fa.flash_bwd_dkv_cuda = sound


@contextlib.contextmanager
def fault_zero_ln_db():
    """LayerNorm's bias gradient zeroed in its backward."""
    from deepspeed_tpu_torch.ops import norms

    sound = norms.layer_norm_bwd

    def faulty(*a, **kw):
        dx, dw, db = sound(*a, **kw)
        return dx, dw, db.zero_()

    norms.layer_norm_bwd = faulty
    try:
        yield "LayerNorm's db zeroed"
    finally:
        norms.layer_norm_bwd = sound


@contextlib.contextmanager
def fault_zero_alibi():
    """BLOOM's ALiBi bias zeroed (on the card side only: the fault is on
    while the card's step runs)."""
    from deepspeed_tpu_torch.models import bloom

    sound = bloom._alibi_bias
    bloom._alibi_bias = lambda *a, **kw: sound(*a, **kw).zero_()
    try:
        yield "ALiBi zeroed"
    finally:
        bloom._alibi_bias = sound


def phase_train_whole(seed: int, card: str, family=None, cfg=None, label="8B-width",
                      fault=fault_zero_dv_head, grad_tol=TRAIN_GRAD_RTOL,
                      against: dict = None, leaf_tol: dict = None):
    """1 layer at full width (Llama-3-8B by default), S = 256: one step's
    loss and every leaf's gradient, card (kernels, bf16) against CPU (plain,
    fp32), each leaf's error over its reference norm within ``grad_tol``
    (``leaf_tol`` names leaves held at limits of their own; ``against`` maps
    a leaf whose reference gradient is zero in exact arithmetic to the leaf
    whose reference norm it is measured against); each planted ``fault``
    (one context manager, or a tuple of them) must fail the same check."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import llama

    family = family or llama
    cfg = dataclasses.replace(cfg or llama.LlamaConfig.llama3_8b(), num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    masters = family.init(cfg, gen)          # fp32, on the card
    rs = np.random.RandomState(seed + 2)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (1, 257)).astype(np.int32)}

    def step(device, bf16):
        params = {k: v.to(device) for k, v in masters.items()}
        eng, *_ = dst.initialize(
            model=dst.ModelSpec(params=params, loss_fn=lambda p, b: family.loss_fn(
                cfg, p, b, compute_dtype=torch.bfloat16 if bf16 else torch.float32)),
            config=_train_config(seed, 1, bf16), device=device)
        loss = float(eng.forward(batch))
        grads = {k: p.grad.float().cpu() for k, p in eng.state.params.items()}
        del eng, params
        return loss, grads

    t0 = time.perf_counter()
    loss_gpu, g_gpu = step("cuda", True)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu, g_cpu = step("cpu", False)
    cpu_s = time.perf_counter() - t0

    against, leaf_tol = against or {}, leaf_tol or {}
    tol = {k: leaf_tol.get(k, grad_tol) for k in g_cpu}
    for k, other in against.items():
        share = float(g_cpu[k].norm()) / float(g_cpu[other].norm())
        log(f"  {k}'s reference gradient: {share:.2e} of {other}'s norm (a zero gradient "
            f"reads below {GRAD_ZERO_SHARE:g})")
        if not share < GRAD_ZERO_SHARE:
            raise AssertionError(f"{k}'s reference gradient is not zero; hold it against "
                                 "its own norm")

    def compare(grads):
        return {k: float((grads[k] - g_cpu[k]).norm()) /
                max(float(g_cpu[against.get(k, k)].norm()), 1e-30) for k in g_cpu}

    def worst_of(rel):
        return max(rel, key=lambda k: rel[k] / tol[k])

    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    rel = compare(g_gpu)
    worst = worst_of(rel)
    ok = loss_rel <= TRAIN_LOSS_RTOL and rel[worst] <= tol[worst] and \
        all(np.isfinite(list(rel.values())))
    log(f"  1-layer {label} step, card (bf16, kernels) vs CPU (fp32, plain): loss "
        f"{loss_gpu:.5f} vs {loss_cpu:.5f} (rel {loss_rel:.2e}, tol {TRAIN_LOSS_RTOL:g}); "
        f"worst leaf grad rel Frobenius {rel[worst]:.4f} ({worst}, tol {tol[worst]:g}) "
        f"{'ok' if ok else 'FAIL'}; card {gpu_s:.1f} s, cpu {cpu_s:.1f} s [{card}]")
    for k in sorted(rel):
        note = (f"  (of {against[k]}'s norm)" if k in against else "") + \
            (f"  (tol {tol[k]:g})" if tol[k] != grad_tol else "")
        log(f"    {k:24s} {rel[k]:.4f}{note}")
    if not ok:
        raise AssertionError("training step on the card disagrees with the plain path")

    faults = []
    for fault_cm in (fault if isinstance(fault, tuple) else (fault,)):
        with fault_cm() as what:
            _, g_bad = step("cuda", True)
        rel_bad = compare(g_bad)
        worst_bad = worst_of(rel_bad)
        log(f"  planted fault ({what}): worst leaf {worst_bad} "
            f"{rel_bad[worst_bad]:.4f} (must exceed tol {tol[worst_bad]:g})")
        if rel_bad[worst_bad] <= tol[worst_bad]:
            raise AssertionError(f"the training-path check passes a planted fault ({what}); "
                                 "too loose")
        faults.append({"what": what, "leaf": worst_bad, "grad_rel": rel_bad[worst_bad]})
    del masters
    torch.cuda.empty_cache()
    return {"loss_card": loss_gpu, "loss_cpu": loss_cpu, "loss_rel": loss_rel,
            "grad_rel": rel, "loss_tol": TRAIN_LOSS_RTOL, "grad_tol": grad_tol,
            "leaf_tol": leaf_tol, "against": against,
            "planted_fault": faults[0], "planted_faults": faults,
            "card_s": gpu_s, "cpu_s": cpu_s}


# --------------------------------------------------------------------------- #
def check_equal(what: str, got, ref) -> float:
    """Raises unless ``got`` equals ``ref`` bit for bit; returns the largest
    absolute difference it measured (0.0 when it passes)."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against the plain "
                             f"version's {ref.dtype} {tuple(ref.shape)}")
    n_bad = int((got != ref).sum())
    err = float((got.double() - ref.double()).abs().max()) if got.numel() else 0.0
    log(f"  {what}: "
        + ("equal bit for bit" if n_bad == 0 else f"{n_bad} elements differ: FAIL")
        + f" (max_abs_err={err:.3e})")
    if n_bad or not torch.equal(got, ref):
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"({n_bad} elements differ, max_abs_err {err:.3e})")
    return err


OPT_W_UP = (2048, 8192)        # OPT-1.3B's w_up as the module system's x @ w holds it
LLAMA_W_UP = (4096, 14336)     # Llama-3-8B's MLP weight: 176 MB of quantize traffic in
                               # bf16, beyond the 50 MB L2, so read cold


def quant_input(dtype, gen, dev, shape=OPT_W_UP):
    """Values of three magnitudes by row; row 0 all zero; the last 2048
    elements hold 127 and exact .5 values over zeros, so every group size
    gives that group scale 1 and the values are ties."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev) * shape[0] ** -0.5
    x *= torch.tensor([1e-3, 1.0, 50.0], device=dev)[
        torch.randint(0, 3, (shape[0], 1), generator=gen, device=dev)]
    x[0] = 0
    flat = x.view(-1)
    flat[-2048:] = 0
    flat[-8:] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], device=dev)
    return x.to(dtype)


def _faithful(x, s, q):
    """Whether each fp32 ``q`` is RD(x / s) or RU(x / s), decided exactly:
    ``s * q`` and ``s`` times ``q``'s neighbours are exact in fp64."""
    s64, x64 = s.astype(np.float64), x.astype(np.float64)
    above = s64 * q.astype(np.float64) > x64 * np.sign(s64)
    inner = np.nextafter(q, np.where(above, -np.inf, np.inf).astype(np.float32))
    return np.where(above, s64 * inner.astype(np.float64) <= x64,
                    s64 * inner.astype(np.float64) >= x64) | (s64 * q.astype(np.float64) == x64)


def division_boundary_groups(n_groups: int, group_size: int, seed: int = 0) -> np.ndarray:
    """fp32 ``[n_groups, group_size]`` whose quotients ``x / scale`` reach
    the hard cases of the quantize kernel's FMA division (``quantize.cu``,
    "The division"); each group's first element sets its scale, random
    values fill what the cases leave. By ``g % 4``: 0 and 1, values a few
    ulps from ``(k + 1/2) scale`` for which the product by the fp32
    reciprocal rounds to another code than the IEEE quotient; 2, a scale of
    significand near 2 - 2^-23 and values whose product by the reciprocal is
    not a faithful rounding of the quotient (half-integer neighbours first,
    then the top of the binade); 3, a power-of-two scale and exact ties
    ``(k + 1/2) scale``."""
    rs = np.random.RandomState(seed)
    inv127 = np.float32(1.0) / np.float32(127.0)
    out = np.zeros((n_groups, group_size), np.float32)
    ks = np.arange(-125, 126, dtype=np.float64) + 0.5
    steps = np.arange(-6, 7, dtype=np.int32)     # ulps either side of (k + 1/2) scale
    for g in range(n_groups):
        if g % 4 == 3:
            scale = np.float32(2.0 ** rs.randint(-20, 20))
            amax = np.float32(127.0) * scale
            cand = (rs.permutation(ks) * np.float64(scale)).astype(np.float32)
        else:
            if g % 4 == 2:
                target = (2.0 - (2 * rs.randint(0, 32) + 1) * 2.0 ** -23) * 2.0 ** rs.randint(-20, 20)
                amax = np.float32(127.0 * target)
            else:
                amax = np.float32(np.exp(rs.uniform(-20.0, 20.0)))
            scale = amax * inv127
            recip = np.float32(1.0) / scale
            near = (ks * np.float64(scale)).astype(np.float32)
            x = (near.view(np.int32)[:, None] + steps[None, :]).view(np.float32).ravel()
            if g % 4 == 2:
                top = (rs.uniform(0.5, 1.0, 4 * group_size) * amax).astype(np.float32)
                top = top * rs.choice(np.float32([-1.0, 1.0]), top.size)
                sc = np.full(x.size, scale, np.float32)
                x = x[~_faithful(x, sc, x * recip)]
                sc = np.full(top.size, scale, np.float32)
                cand = np.concatenate([rs.permutation(x), top[~_faithful(top, sc, top * recip)]])
            else:
                cand = rs.permutation(x[np.rint(x / scale) != np.rint(x * recip)])
        row = rs.uniform(-1.0, 1.0, group_size).astype(np.float32) * amax
        n = min(len(cand), group_size - 1)
        row[1:1 + n] = cand[:n]
        row[0] = amax if g % 2 else -amax
        out[g] = row
    return out


def every_pair_groups(dtype, group_size: int, dev, rows: int = 1 << 16):
    """Groups that hold every pair (amax, x) of a 16-bit dtype (bf16, fp16)
    once: amax each finite value > 0, x each finite value with |x| <= amax,
    both signs. A group is amax, then ``(group_size - 1) // 2`` magnitudes
    up to amax as +x, -x, then zeros. Yields ``[rows, group_size]`` tensors
    on ``dev``, the last one shorter."""
    import torch

    n = 0x7F80 if dtype == torch.bfloat16 else 0x7C00          # the bits of +inf
    mag = torch.arange(n, dtype=torch.int32, device=dev).to(torch.int16).view(dtype)
    h = (group_size - 1) // 2
    amax = torch.arange(1, n, device=dev)
    per = (amax + h) // h                           # groups of amax: ceil((i + 1) / h)
    row_amax = torch.repeat_interleave(amax, per)
    row_part = torch.arange(row_amax.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    pad = torch.zeros(group_size - 1 - 2 * h, dtype=dtype, device=dev)
    for r0 in range(0, row_amax.numel(), rows):
        ra, rp = row_amax[r0:r0 + rows, None], row_part[r0:r0 + rows, None]
        j = rp * h + torch.arange(h, device=dev)
        v = torch.where(j <= ra, mag[j.clamp(max=n - 1)], torch.zeros((), dtype=dtype, device=dev))
        yield torch.cat([mag[ra], torch.stack([v, -v], -1).view(v.shape[0], 2 * h),
                         pad.expand(v.shape[0], -1)], 1)


def phase_ln_quant_kernels(seed: int, card: str):
    """LayerNorm, int8 quantize and int8 dequantize against their plain
    versions at OPT-1.3B shapes, a planted fault for each, and their times
    beside the plain versions', the bytes bound and (LayerNorm)
    ``F.layer_norm``."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.norms import (
        layer_norm_cuda, layer_norm_planted_fault, layer_norm_torch)
    from deepspeed_tpu_torch.ops.quantization import (
        dequantize_int8_cuda, dequantize_int8_torch, quantize_int8_cuda, quantize_int8_torch,
        quantize_planted_fault)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    out = {}

    # ---- LayerNorm -------------------------------------------------------
    eps = 1e-5
    errs, rows, faults = [], {}, {}
    lane_fault = None
    # OPT-1.3B (d 2048), one BLOOM-7b1 micro-batch (2 x 2048 tokens of d 4096)
    # and GPT-2 (768); bf16, fp16 (FP16_TOL) and fp32 (1e-4)
    for d, ns in ((2048, (1, 7, 64, 2048, 8192)), (4096, (4096,)), (768, (64,))):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
            b = (0.2 * torch.randn(d, generator=gen, device=dev)).to(dtype)
            for n in ns:
                x = (3 * torch.randn(n, d, generator=gen, device=dev) + 1).to(dtype)
                for bias in (b, None):
                    y = layer_norm_cuda(x, w, bias, eps)
                    torch.cuda.synchronize()
                    name = (f"layer_norm N={n} d={d} {str(dtype)[6:]} "
                            f"{'bias' if bias is not None else 'no bias'}")
                    tol = {torch.float32: 1e-4, torch.float16: FP16_TOL}.get(dtype, RMS_TOL)
                    errs.append(check_close(name, y, layer_norm_torch(x, w, bias, eps), tol))
                if d == 4096 and dtype == torch.bfloat16:
                    faults[d] = row_err(layer_norm_cuda(x, w, None, eps),
                                        layer_norm_torch(x, w, b, eps))
                if d == 2048 and dtype == torch.bfloat16 and n == 64:
                    # planted fault (the warp kernel, which serves 64 rows):
                    # lane 31's share left out of the centred sum
                    with layer_norm_planted_fault(1):
                        y_bad = layer_norm_cuda(x, w, b, eps)
                        torch.cuda.synchronize()
                    lane_fault = row_err(y_bad, layer_norm_torch(x, w, b, eps))
                    del y_bad
                if dtype != torch.bfloat16 or (d, n) not in ((2048, 1), (2048, 64), (2048, 8192),
                                                             (4096, 4096)):
                    continue
                # times at one row (the launch floor), the serving step's rows
                # (64 slots), an OPT training micro-batch's (4 x 2048 tokens)
                # and a BLOOM-7b1 one's (2 x 2048 tokens of d 4096)
                iters = 2000 if n <= 64 else 300
                byt = 2 * n * d * 2 + 2 * d * 2
                kern_t = measure(lambda: layer_norm_cuda(x, w, b, eps), iters)
                plain_t = measure(lambda: layer_norm_torch(x, w, b, eps), iters)
                lib_t = measure(lambda: F.layer_norm(x, (d,), w, b, eps), iters)
                key = n if d == 2048 else f"{n}x{d}"
                rows[key] = {"ms": kern_t["ms"], "plain_ms": plain_t["ms"],
                             "library_ms": lib_t["ms"], "host_ms": kern_t["host_ms"],
                             "plain_kernels": plain_t["kernels_per_call"],
                             "bound_ms": max(byt / HBM_BYTES_PER_S,
                                             8 * n * d / FP32_FLOPS) * 1e3,
                             "bytes": byt}
                r = rows[key]
                log(f"  layer_norm N={n} d={d} bf16: device kernel {r['ms']*1e3:.2f} us, plain "
                    f"{r['plain_ms']*1e3:.2f} us ({r['plain_kernels']} kernels), F.layer_norm "
                    f"{r['library_ms']*1e3:.2f} us, bound {r['bound_ms']*1e3:.3f} us (bytes); "
                    f"host loop {r['host_ms']*1e3:.2f} us [{card}]")
    # planted fault: the bias left out must fail the check it passed above,
    # at the last shape (d 768 fp32) and at BLOOM-7b1's (d 4096 bf16)
    faults[d] = row_err(layer_norm_cuda(x, w, None, eps), layer_norm_torch(x, w, b, eps))
    for d, (fault_err, fault_rel) in sorted(faults.items()):
        log(f"  layer_norm planted fault (bias left out, d={d}): max_abs_err={fault_err:.3e}, "
            f"row err/RMS={fault_rel:.4f} (must exceed tol {RMS_TOL:g})")
        if fault_rel <= RMS_TOL:
            raise AssertionError("layer_norm tolerance passes a missing bias; it is too loose")
    log(f"  layer_norm planted fault (lane 31's share left out of the centred sum, N=64 "
        f"d=2048 bf16): max_abs_err={lane_fault[0]:.3e}, row err/RMS={lane_fault[1]:.4f} "
        f"(must exceed tol {RMS_TOL:g})")
    if lane_fault[1] <= RMS_TOL:
        raise AssertionError("layer_norm tolerance passes a lane left out of the variance")
    out["layer_norm"] = {"max_abs_err": max(e for e, _ in errs),
                         "max_row_err_over_rms": max(r for _, r in errs), "tol": RMS_TOL,
                         "planted_fault": {f"d={d}": {"max_abs_err": e, "row_err_over_rms": r}
                                           for d, (e, r) in faults.items()},
                         "planted_fault_lane31": {"max_abs_err": lane_fault[0],
                                                  "row_err_over_rms": lane_fault[1]},
                         "rows": rows}

    # ---- quantize / dequantize -------------------------------------------
    def check_quant(x, gs, tag, outs):
        """Codes, scales and each of ``outs``' values equal to the plain
        versions'; the all-zero row and the ties; returns (q, scales)."""
        q, sc = quantize_int8_cuda(x, gs)
        torch.cuda.synchronize()
        q_ref, sc_ref = quantize_int8_torch(x, gs)
        q_errs.append(check_equal(f"quantize_int8 {tag} group {gs} codes", q, q_ref))
        q_errs.append(check_equal(f"quantize_int8 {tag} group {gs} scales", sc, sc_ref))
        del q_ref, sc_ref
        if float(sc[0]) != 1.0 or bool(q[0].any()) or float(sc[-1]) != 1.0 \
                or q.view(-1)[-8:].tolist() != [127, 0, 2, 2, 0, -2, -2, 4]:
            raise AssertionError("quantize_int8: the all-zero group or the .5 ties "
                                 f"came out wrong: {sc[0]}, {sc[-1]}, {q.view(-1)[-8:]}")
        for odt in outs:
            got = dequantize_int8_cuda(q, sc, gs, odt)
            torch.cuda.synchronize()
            dq_errs.append(check_equal(f"dequantize_int8 {tag} group {gs} -> {str(odt)[6:]}",
                                       got, dequantize_int8_torch(q, sc, gs, odt)))
        return q, sc

    def time_quant(key, x, gs):
        n_el, ng = x.numel(), x.numel() // gs
        byt = n_el * x.element_size() + n_el + ng * 4
        kq = measure(lambda: quantize_int8_cuda(x, gs), 100)
        pq = measure(lambda: quantize_int8_torch(x, gs), 20)
        timing[key] = {"ms": kq["ms"], "plain_ms": pq["ms"], "host_ms": kq["host_ms"],
                       "plain_kernels": pq["kernels_per_call"], "bytes": byt,
                       "bound_ms": max(byt / HBM_BYTES_PER_S, 4 * n_el / FP32_FLOPS) * 1e3}

    def time_dequant(key, q, sc, gs, odt):
        n_el, ng = q.numel(), q.numel() // gs
        byt = n_el + ng * 4 + n_el * torch.empty(0, dtype=odt).element_size()
        kd = measure(lambda: dequantize_int8_cuda(q, sc, gs, odt), 100)
        pd = measure(lambda: dequantize_int8_torch(q, sc, gs, odt), 20)
        # the library's one call: a broadcast multiply that promotes int8 x
        # fp32 to fp32 and casts into ``out``
        lib_out = torch.empty(ng, gs, dtype=odt, device=dev)
        lib = lambda: torch.mul(q.view(ng, gs), sc[:, None], out=lib_out)  # noqa: E731
        lib()
        check_equal(f"torch.mul(out=) group {gs} -> {str(odt)[6:]} (library call)",
                    lib_out.view(q.shape), dequantize_int8_torch(q, sc, gs, odt))
        ld = measure(lib, 100)
        timing[key] = {"ms": kd["ms"], "plain_ms": pd["ms"], "host_ms": kd["host_ms"],
                       "library_ms": ld["ms"], "library_kernels": ld["kernels_per_call"],
                       "plain_kernels": pd["kernels_per_call"], "bytes": byt,
                       "bound_ms": max(byt / HBM_BYTES_PER_S, n_el / FP32_FLOPS) * 1e3}

    def n_differ(got, ref) -> int:
        torch.cuda.synchronize()
        return int((got != ref).sum())

    # OPT-1.3B's w_up in bf16, fp16 and fp32 at groups 2048 and 128, each
    # dequantized to fp32, bf16 and fp16; all timed
    timing, q_errs, dq_errs = {}, [], []
    quant_dtypes = (torch.bfloat16, torch.float16, torch.float32)
    for dtype in quant_dtypes:
        x = quant_input(dtype, gen, dev)
        tag = str(dtype)[6:]
        for gs in (2048, 128):
            q, sc = check_quant(x, gs, tag, quant_dtypes)
            time_quant(f"quantize_g{gs}_{tag}", x, gs)
            if dtype == torch.bfloat16:
                for odt in quant_dtypes:
                    time_dequant(f"dequantize_g{gs}_{str(odt)[6:]}", q, sc, gs, odt)
                if gs == 128:
                    x_opt, q_opt, sc_opt = x, q, sc
    # Llama-3-8B's MLP weight in bf16 (cold: beyond L2)
    x = quant_input(torch.bfloat16, gen, dev, LLAMA_W_UP)
    for gs in (2048, 128):
        q, sc = check_quant(x, gs, "bfloat16 [4096 x 14336]", (torch.bfloat16,))
        time_quant(f"llama_quantize_g{gs}_bfloat16", x, gs)
        time_dequant(f"llama_dequantize_g{gs}_bfloat16", q, sc, gs, torch.bfloat16)
    del x, q, sc
    for name, r in timing.items():
        shape = "[4096 x 14336]" if name.startswith("llama") else "[2048 x 8192]"
        log(f"  {name} {shape}: device kernel {r['ms']*1e3:.2f} us "
            f"({r['bytes'] / (r['ms'] * 1e-3) / 1e9:.0f} GB/s, "
            f"{100 * r['bound_ms'] / r['ms']:.0f}% of bound), plain {r['plain_ms']*1e3:.1f} us "
            f"({r['plain_kernels']:.0f} kernels), "
            + (f"torch.mul(out=) {r['library_ms']*1e3:.1f} us "
               f"({r['library_kernels']:.0f} kernels), " if "library_ms" in r else "")
            + f"bound {r['bound_ms']*1e3:.2f} us (bytes); "
            f"host loop {r['host_ms']*1e3:.1f} us [{card}]")
    log("  (back-to-back launches on one working set: the [2048 x 8192] cases (50 MB in bf16) "
        "may partly hit in L2, so a reading above 100% of bound is L2's; [4096 x 14336] is "
        "cold)")
    log("  quantize_int8: no single PyTorch call computes the per-group scale and the codes "
        "(amax, divide, round, clip), so it has no library time; dequantize_int8's is one "
        "broadcast torch.mul(codes, scales[:, None], out=)")

    # planted faults: each must break the equality the sound kernels keep
    faults = {}
    xb = torch.from_numpy(division_boundary_groups(4096, 128, seed=seed)).to(dev)
    qb_ref = quantize_int8_torch(xb, 128)[0]
    q_errs.append(check_equal("quantize_int8 fp32 group 128 codes at ties and boundary "
                              "quotients", quantize_int8_cuda(xb, 128)[0], qb_ref))
    with quantize_planted_fault(1):
        faults["1 (quotient as the product by the reciprocal; boundary quotients)"] = \
            n_differ(quantize_int8_cuda(xb, 128)[0], qb_ref)
        # informative: how often random values meet a boundary
        random_fault1 = n_differ(quantize_int8_cuda(x_opt, 128)[0], q_opt)
    # every (amax, x) pair of bf16 and of fp16, in groups of 2048: the FMA
    # division's codes equal IEEE division's over the whole input domain
    pairs = {}
    for dtype in (torch.bfloat16, torch.float16):
        tag, n_groups, n_fault = str(dtype)[6:], 0, 0
        for xg in every_pair_groups(dtype, 2048, dev):
            q_ref, s_ref = quantize_int8_torch(xg, 2048)
            q, sc = quantize_int8_cuda(xg, 2048)
            torch.cuda.synchronize()
            if not (torch.equal(q, q_ref) and torch.equal(sc, s_ref)):
                check_equal(f"quantize_int8 {tag} every (amax, x) pair, codes", q, q_ref)
                check_equal(f"quantize_int8 {tag} every (amax, x) pair, scales", sc, s_ref)
            with quantize_planted_fault(1):
                n_fault += n_differ(quantize_int8_cuda(xg, 2048)[0], q_ref)
            n_groups += xg.shape[0]
        n_mag = 0x7F80 if dtype == torch.bfloat16 else 0x7C00   # finite values >= 0
        pairs[tag] = {"pairs": n_mag ** 2 - 1, "groups": n_groups, "fault1_codes": n_fault}
        log(f"  quantize_int8 {tag} every (amax, x) pair ({n_mag ** 2 - 1} in {n_groups} groups "
            f"of 2048): codes and scales equal bit for bit; fault 1 changes {n_fault} codes")
        faults[f"1 (the product by the reciprocal; every {tag} pair)"] = n_fault
        del xg, q_ref, s_ref, q, sc
    del xb, qb_ref
    with quantize_planted_fault(2):
        for gs in (128, 2048):
            faults[f"2 (a lane left out of each segment's max; group {gs} scales)"] = \
                n_differ(quantize_int8_cuda(x_opt, gs)[1], quantize_int8_torch(x_opt, gs)[1])
    dq_ref = dequantize_int8_torch(q_opt, sc_opt, 128, torch.bfloat16)
    with quantize_planted_fault(3):
        faults["3 (each group's first vector by the previous group's scale)"] = \
            n_differ(dequantize_int8_cuda(q_opt, sc_opt, 128, torch.bfloat16), dq_ref)
    faults["scales shifted by one group"] = n_differ(
        dequantize_int8_cuda(q_opt, sc_opt.roll(1), 128, torch.bfloat16), dq_ref)
    for what, n_bad in faults.items():
        log(f"  quantize.cu planted fault {what}: {n_bad} elements differ (must be > 0)")
    log(f"  (fault 1 on the random [2048 x 8192] bf16 values at group 128: {random_fault1} of "
        f"{x_opt.numel()} codes differ)")
    for what, n_bad in faults.items():
        if n_bad == 0:
            raise AssertionError(f"the equality check passes planted fault {what}")
    out["quantize"] = {"max_abs_err": max(q_errs), "dequantize_max_abs_err": max(dq_errs),
                       "timing": timing, "planted_faults": faults, "every_pair": pairs,
                       "fault1_random_codes": random_fault1}
    return out


def phase_opt_shapes(seed: int, card: str):
    """The reused kernels at the shapes OPT-1.3B gives them (MHA: 32 kv
    heads, g = 1, hd 64; 64 slots over 512 blocks of 128, tables of 16):
    bf16 decode, int8 decode and verify (t = 5) against their plain
    versions; the flash kernels through op ``attention`` under autograd at
    4 x 2048 tokens against plain attention in fp32."""
    import torch

    from deepspeed_tpu_torch.ops.attention import attention_torch
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_torch,
        paged_spec_verify_attention_cuda, paged_spec_verify_attention_torch)
    from deepspeed_tpu_torch.ops.quantization import kv_quantize_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    B, nh, hd, bs, nblocks, mb, t = 64, 32, 64, 128, 512, 16, SPEC_K + 1
    cap = mb * bs
    kf, vf = (torch.randn(nblocks, nh, bs, hd, generator=gen, device=dev) for _ in range(2))
    kb, vb = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    (kc, ks), (vc, vs) = kv_quantize_int8(kf, hd), kv_quantize_int8(vf, hd)
    sc = {"k_scale": ks, "v_scale": vs}
    rs = np.random.RandomState(seed + 8)
    tables_np = rs.randint(1, nblocks, (B, mb)).astype(np.int32)
    edge = [0, bs - t, bs - 1, bs, 2 * bs - 3, cap - t]
    ctx_np = np.concatenate([edge, rs.randint(0, cap - t + 1, B - len(edge))]).astype(np.int32)
    tables_np[0] = 0
    tables, ctx = torch.from_numpy(tables_np).to(dev), torch.from_numpy(ctx_np).to(dev)
    q1 = torch.randn(B, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
    qt = torch.randn(B, t, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
    out = {}
    for name, got, ref, tol in (
            ("paged_decode bf16", paged_decode_attention_cuda(q1, kb, vb, tables, ctx),
             paged_decode_attention_torch(q1, kb, vb, tables, ctx), DECODE_TOL),
            ("paged_decode int8", paged_decode_attention_cuda(q1, kc, vc, tables, ctx, **sc),
             paged_decode_attention_torch(q1, kc, vc, tables, ctx, **sc), ROWS_TOL),
            ("paged_spec_verify bf16", paged_spec_verify_attention_cuda(qt, kb, vb, tables, ctx),
             paged_spec_verify_attention_torch(qt, kb, vb, tables, ctx), ROWS_TOL),
            ("paged_spec_verify int8",
             paged_spec_verify_attention_cuda(qt, kc, vc, tables, ctx, **sc),
             paged_spec_verify_attention_torch(qt, kc, vc, tables, ctx, **sc), ROWS_TOL)):
        torch.cuda.synchronize()
        out[name] = check_close(f"{name} at OPT-1.3B shapes (B={B}, 32/32 heads, hd 64)",
                                got, ref, tol)
    del kf, vf, kb, vb, kc, vc

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = (torch.randn(2, 2048, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    res = {}
    for label, fn, dtype in (("kernel", flash_attention, torch.bfloat16),
                             ("plain", attention_torch, torch.float32)):
        leaves = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
        o = fn(*leaves, causal=True)
        (o.float() * do.float()).sum().backward()
        res[label] = [o.detach()] + [x.grad for x in leaves]
        del o, leaves
    torch.cuda.synchronize()
    for key, got, ref in zip(("o", "dq", "dk", "dv"), res["kernel"], res["plain"]):
        out[f"flash {key}"] = check_close(f"flash MHA 32/32 hd 64 S=2048 B=2 {key}", got, ref,
                                          FLASH_TOL[key], floor=FLASH_FLOOR[key])
    del res
    torch.cuda.empty_cache()
    return {k: {"max_abs_err": e, "row_err_over_rms": r} for k, (e, r) in out.items()}


def phase_modules(seed: int, card: str):
    """The inference module system on the card: OPT-1.3B's w_up and w_down
    quantized through op ``quantize_int8``, the ``weight_only_quant`` linear
    against the ``dense`` linear on [64, 2048] bf16 activations, w_up in
    fp16 quantized and served the same way on fp16 activations, and the
    ``norm`` slot with ``kind="layer"``; launches equal to the calls made."""
    import torch

    from deepspeed_tpu_torch.inference import modules
    from deepspeed_tpu_torch.ops import quantize_int8
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, layer_norm_torch
    from deepspeed_tpu_torch.ops.quantization import dequantize_int8_cuda, quantize_int8_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    h, i, gs = 2048, 8192, 128
    w_up = (torch.randn(h, i, generator=gen, device=dev) * h ** -0.5).to(torch.bfloat16)
    w_down = (torch.randn(i, h, generator=gen, device=dev) * i ** -0.5).to(torch.bfloat16)
    b_up = (0.1 * torch.randn(i, generator=gen, device=dev)).to(torch.bfloat16)
    x = torch.randn(64, h, generator=gen, device=dev).to(torch.bfloat16)
    reg = modules.registry
    dense_up = reg.instantiate("linear", modules.LinearConfig(activation="relu"))
    quant_up = reg.instantiate("linear", modules.LinearConfig(quant_bits=8, activation="relu"))
    dense_down = reg.instantiate("linear", modules.LinearConfig())
    quant_down = reg.instantiate("linear", modules.LinearConfig(quant_bits=8))
    norm = reg.instantiate("norm", modules.NormConfig(kind="layer", eps=1e-5))
    counters = (quantize_int8_cuda, dequantize_int8_cuda, layer_norm_cuda)
    for c in counters:
        c.launches = 0
    q_up, s_up = quantize_int8(w_up, gs)
    q_down, s_down = quantize_int8(w_down, gs)
    ln_w, ln_b = torch.ones(h, device=dev, dtype=torch.bfloat16), \
        torch.zeros(h, device=dev, dtype=torch.bfloat16)
    y = norm(x, ln_w, ln_b)
    mid_q = quant_up(y, q_up, s_up, b_up)
    out_q = quant_down(mid_q, q_down, s_down)
    # fp16: w_up quantized from fp16, dequantized into fp16 by the linear
    y16, w_up16, b_up16 = (t.to(torch.float16) for t in (y, w_up, b_up))
    q_up16, s_up16 = quantize_int8(w_up16, gs)
    mid_q16 = quant_up(y16, q_up16, s_up16, b_up16)
    torch.cuda.synchronize()
    launches = {"quantize_int8": quantize_int8_cuda.launches,
                "dequantize_int8": dequantize_int8_cuda.launches,
                "layer_norm": layer_norm_cuda.launches}
    want = {"quantize_int8": 3, "dequantize_int8": 3, "layer_norm": 1}
    log(f"  module system: launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"module-system launches {launches} != calls made {want}")
    check_close("norm slot kind=layer [64, 2048]", y, layer_norm_torch(x, ln_w, ln_b, 1e-5),
                RMS_TOL)
    mid = dense_up(y, w_up, b_up)
    out = dense_down(mid, w_down)
    errs = {"up": check_close("weight_only_quant linear up+relu vs dense [64, 8192]",
                              mid_q, mid, MODULE_QUANT_TOL),
            "down": check_close("weight_only_quant up -> down vs dense [64, 2048]",
                                out_q, out, MODULE_QUANT_TOL),
            "up fp16": check_close("weight_only_quant linear up+relu fp16 vs dense fp16 "
                                   "[64, 8192]", mid_q16, dense_up(y16, w_up16, b_up16),
                                   MODULE_QUANT_TOL)}
    bad = quant_down(mid_q, q_down, s_down.roll(1))
    fault_err, fault_rel = row_err(bad, out)
    log(f"  module planted fault (w_down's scales shifted by one group): row err/RMS="
        f"{fault_rel:.4f} (must exceed tol {MODULE_QUANT_TOL:g})")
    if fault_rel <= MODULE_QUANT_TOL:
        raise AssertionError("the quantized-linear limit passes shifted scales; too loose")
    times = {}
    for tag, args, dense_args in (("bf16", (y, q_up, s_up, b_up), (y, w_up, b_up)),
                                  ("fp16", (y16, q_up16, s_up16, b_up16),
                                   (y16, w_up16, b_up16))):
        t_q = measure(lambda: quant_up(*args), 50)
        t_d = measure(lambda: dense_up(*dense_args), 50)
        times[tag] = {"quant_linear_ms": t_q["ms"], "dense_linear_ms": t_d["ms"]}
        log(f"  up-projection [64, 2048] x [2048, 8192] {tag}: weight_only_quant "
            f"{t_q['ms']*1e3:.1f} us (dequantize + matmul), dense {t_d['ms']*1e3:.1f} us "
            f"[{card}]")
    return {"launches": launches, "tol": MODULE_QUANT_TOL,
            "row_err_over_rms": {k: r for k, (_, r) in errs.items()},
            "planted_fault": fault_rel, **times["bf16"], "fp16": times["fp16"]}


# --------------------------------------------------------------------------- #
BLOOM_B, BLOOM_S, BLOOM_H = 2, 2048, 32          # one BLOOM-7b1 micro-batch, hd 128
MSA_ROWS, MSA_RES, MSA_H, MSA_HD = 512, 256, 8, 32   # AlphaFold MSA row attention
SPARSE_S, SPARSE_S_LONG, SPARSE_BS = 4096, 16384, 128
SPARSE_BS_OLD = 32             # a block that sparse_attention.cu's dK/dV keeps
SPARSE_Q_CHUNK = 1024          # query rows a plain piece holds at S 16384
SPARSE_LAYOUTS = {   # name: (builder of the [nb, nb] layout, causal)
    "bigbird causal": (lambda nb: _sparse().bigbird_layout(nb, 3, 1, 2, seed=SEED, causal=True),
                       True),
    "fixed non-causal": (lambda nb: _sparse().fixed_layout(nb, 4, 4, causal=False), False),
    "sliding window": (lambda nb: _sparse().sliding_window_layout(nb, 4, causal=True), True),
}


def _sparse():
    from deepspeed_tpu_torch.ops import sparse_attention

    return sparse_attention


def attn_bound_ms(pairs: int, hd: int, products: int, nbytes: int) -> tuple:
    """(bound ms, "bytes" or "operations") of attention work over ``pairs``
    visible (q, k) pairs: 2 * hd operations per pair and product, against
    ``nbytes`` moved once."""
    t_ops = 2 * hd * products * pairs / BF16_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bias_work(b, h, sq, skv, hd, pairs, bias_bytes, dbias_bytes=0) -> dict:
    """Per bias-mode kernel: (bound ms, bound_by) from its visible pairs and
    the bytes it must move (bf16 q/k/v/o/dO/grads, fp32 lse/delta, the bias
    read once as stored, dbias written once)."""
    q_bytes, kv_bytes, row_bytes = b * sq * h * hd * 2, b * skv * h * hd * 2, b * h * sq * 4
    return {"fwd": attn_bound_ms(pairs, hd, 2, 2 * q_bytes + 2 * kv_bytes + row_bytes
                                 + bias_bytes),
            "dq": attn_bound_ms(pairs, hd, 3, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                                + bias_bytes + dbias_bytes),
            "dkv": attn_bound_ms(pairs, hd, 4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
                                 + bias_bytes)}


def _bias_pieces(q, k, v, do, bias, kw, need_dbias):
    """The three bias-mode kernels, as the autograd function runs them."""
    import torch

    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bias_cuda, flash_bwd_dq_bias_cuda, flash_fwd_bias_cuda)

    o, lse = flash_fwd_bias_cuda(q, k, v, bias, **kw)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    dq, dbias = flash_bwd_dq_bias_cuda(q, k, v, do, lse, delta, bias, need_dbias=need_dbias,
                                       **kw)
    dk, dv = flash_bwd_dkv_bias_cuda(q, k, v, do, lse, delta, bias, **kw)
    torch.cuda.synchronize()
    return (o, lse, delta), {"o": o, "dq": dq, "dk": dk, "dv": dv, "dbias": dbias}


def _check_pieces(label, got, ref, keys) -> dict:
    errs = {}
    for key in keys:
        tol, floor = (FLASH_TOL["dq"], FLASH_FLOOR["dq"]) if key == "dbias" else \
            (FLASH_TOL[key], FLASH_FLOOR[key])
        errs[key] = check_close(f"{label} {key}", got[key], ref[key], tol, floor=floor)
    return errs


def _fault_must_fail(what: str, got, ref, key: str):
    """The check ``check_close`` makes (dbias at dQ's limits) must fail
    ``got``: a row beyond its limit, or a value that is not finite."""
    import torch

    tol, floor = (FLASH_TOL["dq"], FLASH_FLOOR["dq"]) if key == "dbias" else \
        (FLASH_TOL[key], FLASH_FLOOR[key])
    err, rel = row_err(got, ref, floor=floor)
    finite = bool(torch.isfinite(got.float()).all())
    log(f"  planted fault ({what}): {key} max_abs_err={err:.3e}, row err/RMS={rel:.4f}, "
        f"finite {finite} (must exceed tol {tol:g} or not be finite)")
    if rel <= tol and finite:
        raise AssertionError(f"the check passes a planted fault ({what}); too loose")
    return {"what": what, "row_err_over_rms": rel, "finite": finite}


BIAS_BWD_FAULTS = [   # flash_bwd_sm90.cu's planted faults on the bias mode: code, what,
    # the grads that must fail (BLOOM: no dbias), the shapes they run at
    (1, "ring stage read one step late", ("dq", "dk"), ("bloom",)),
    (2, "last tile of each band dropped", ("dq", "dv", "dbias"), ("bloom", "msa")),
    (3, "last query head of each group skipped", ("dk", "dv"), ("bloom",)),
    (4, "bias read one kv tile off", ("dq", "dk", "dbias"), ("bloom", "msa")),
]


def _bias_bwd_faults(shape, q, k, v, do, bias, kw, ref, need_dbias) -> dict:
    """The bias-mode backward's planted faults at one shape: each must fail
    the check the sound kernels passed against ``ref``."""
    import torch

    from deepspeed_tpu_torch.ops.flash_attention import sm90_planted_fault

    out = {}
    for fault, what, keys, shapes in BIAS_BWD_FAULTS:
        if shape not in shapes:
            continue
        with sm90_planted_fault(fault, "bwd"):
            _, bad = _bias_pieces(q, k, v, do, bias, kw, need_dbias)
        out[what] = [_fault_must_fail(f"bias backward, {what}, {key}", bad[key], ref[key], key)
                     for key in keys if bad[key] is not None]
        del bad
        torch.cuda.empty_cache()
    return out


def _sdpa_bias_grad(qt, kt, vt, dot, bias):
    """SDPA forward and backward with ``bias`` as an ``attn_mask`` that
    requires grad, so that it computes dQ, dK, dV and dbias, the function
    of the bias-mode kernels with dbias: on the first fused backend
    (memory-efficient, then cuDNN) that takes an fp32 mask, else a bf16
    one, else the math backend with a bf16 mask. Returns (fwd, fwd_bwd,
    label)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def make(mask, backends):
        def fwd():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def fwd_bwd():
            leaves = [x.detach().requires_grad_() for x in (qt, kt, vt, mask)]
            with sdpa_kernel(backends):
                F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3]).backward(dot)
        return fwd, fwd_bwd

    tried = []
    for dtype in (torch.float32, torch.bfloat16):
        mask = bias.to(dtype)
        for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION):
            fwd, fwd_bwd = make(mask, [backend])
            try:
                fwd_bwd()
                torch.cuda.synchronize()
                return fwd, fwd_bwd, f"{backend.name}, {str(dtype)[6:]} mask with grad"
            except RuntimeError as e:
                tried.append(f"{backend.name}/{str(dtype)[6:]}: {str(e).splitlines()[0][:80]}")
    log(f"  (no fused SDPA backend took a mask with grad: {tried})")
    fwd, fwd_bwd = make(bias.to(torch.bfloat16), [SDPBackend.MATH])
    return fwd, fwd_bwd, "MATH, bfloat16 mask with grad"


def phase_bias_kernels(seed: int, card: str):
    """The flash kernels' bias mode against its plain pieces on the card
    (same bf16 inputs, same o and lse into the backward), at BLOOM-7b1's
    attention (ALiBi [32, 1, S] read with stride 0, causal) and at AlphaFold
    MSA row attention (summed fp32 mask + pair bias, non-causal, one residue
    masked in every row and one MSA row wholly masked; dbias checked). Each
    with a planted fault that must fail; times beside the bound, the plain
    pieces and SDPA with a float ``attn_mask``."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models.bloom import _alibi_bias
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bias_cuda, flash_bwd_dq_bias_cuda, flash_bwd_torch, flash_fwd_bias_cuda,
        flash_fwd_torch)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    out = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # ---- BLOOM-7b1: ALiBi, causal, MHA 32/32, hd 128 ----------------------
    b, s, h, hd = BLOOM_B, BLOOM_S, BLOOM_H, HD
    q, k, v, do = (randn(b, s, h, hd) for _ in range(4))
    alibi = _alibi_bias(h, s, dev)                       # [32, 1, S] fp32
    kw = dict(causal=True)
    (o, lse, delta), got = _bias_pieces(q, k, v, do, alibi, kw, False)
    o_ref, lse_ref = flash_fwd_torch(q, k, v, bias=alibi, **kw)
    ref = dict(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, bias=alibi, **kw)))
    ref["o"] = o_ref
    lse_err = float((lse - lse_ref).abs().max())
    log(f"  flash bias BLOOM lse: max_abs_err={lse_err:.3e}")
    errs = _check_pieces("flash bias BLOOM-7b1 (ALiBi, S=2048, causal)", got, ref,
                         ("o", "dq", "dk", "dv"))
    del ref
    # shifted by one key with wrap-around (a plain shift adds one constant
    # per row, which softmax drops): key 0 gets the last key's bias
    shifted = alibi.roll(1, -1)
    o_bad, _ = flash_fwd_bias_cuda(q, k, v, shifted, **kw)
    fault = _fault_must_fail("ALiBi shifted by one key", o_bad, o_ref, "o")
    del o_bad, o_ref, shifted
    ref = dict(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, bias=alibi, **kw)))
    bwd_faults = _bias_bwd_faults("bloom", q, k, v, do, alibi, kw, ref, False)
    del ref
    torch.cuda.empty_cache()
    pairs = b * h * s * (s + 1) // 2
    work = bias_work(b, h, s, s, hd, pairs, alibi.numel() * 4)
    t = {"fwd": measure(lambda: flash_fwd_bias_cuda(q, k, v, alibi, **kw), 10),
         "dq": measure(lambda: flash_bwd_dq_bias_cuda(q, k, v, do, lse, delta, alibi, **kw), 10),
         "dkv": measure(lambda: flash_bwd_dkv_bias_cuda(q, k, v, do, lse, delta, alibi, **kw),
                        10)}
    plain = {"fwd": measure(lambda: flash_fwd_torch(q, k, v, bias=alibi, **kw), 3)["ms"],
             "bwd": measure(lambda: flash_bwd_torch(q, k, v, o, lse, do, bias=alibi, **kw),
                            3)["ms"]}
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    fmask = (alibi[None] + torch.zeros(1, h, s, s, device=dev)).masked_fill(
        ~causal, float("-inf")).to(torch.bfloat16)       # [1, 32, S, S]: ALiBi + causal

    def sdpa_fwd_bwd():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, attn_mask=fmask).backward(dot)

    lib_fwd = measure(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=fmask),
                      10)["ms"]
    lib_bwd = measure(sdpa_fwd_bwd, 10)["ms"] - lib_fwd
    rows = {}
    for key, pk, lib in (("fwd", "fwd", lib_fwd), ("dq", "bwd", lib_bwd),
                         ("dkv", "bwd", lib_bwd)):
        bound, by = work[key]
        rows[key] = {"ms": t[key]["ms"], "host_ms": t[key]["host_ms"], "plain_ms": plain[pk],
                     "library_ms": lib, "bound_ms": bound, "bound_by": by}
        log(f"  flash {key} bias BLOOM-7b1 [{b}x{s}, 32 heads]: device {rows[key]['ms']*1e3:.1f} us, "
            f"bound {bound*1e3:.1f} us ({by}), plain {plain[pk]*1e3:.1f} us, "
            f"SDPA float mask {lib*1e3:.1f} us [{card}]")
    log("  (plain and SDPA backward times cover dQ, dK and dV together)")
    out["bloom"] = {"max_abs_err": {k_: e for k_, (e, _) in errs.items()},
                    "row_err_over_rms": {k_: r for k_, (_, r) in errs.items()},
                    "lse_max_abs_err": lse_err, "planted_fault": fault,
                    "planted_faults_bwd_sm90": bwd_faults, "timing": rows, "pairs": pairs}
    del q, k, v, do, o, lse, delta, got, qt, kt, vt, dot, fmask, causal
    torch.cuda.empty_cache()

    # ---- AlphaFold MSA row attention: summed fp32 biases, dbias ----------
    n, r, h, hd = MSA_ROWS, MSA_RES, MSA_H, MSA_HD
    q, k, v, do = (randn(n, r, h, hd) for _ in range(4))
    valid = torch.ones(n, r, device=dev, dtype=torch.bool)
    valid[:, 7] = False                                  # one residue masked in every row
    valid[3] = False                                     # MSA row 3 wholly masked
    mask_bias = torch.where(valid, 0.0, -1e30)[:, None, None, :]          # [n, 1, 1, r]
    pair = torch.randn(1, h, r, r, generator=gen, device=dev)
    bias = mask_bias + pair                              # [n, h, r, r] fp32, 1.07 GB
    kw = dict(causal=False)
    (o, lse, delta), got = _bias_pieces(q, k, v, do, bias, kw, True)
    o_ref, _ = flash_fwd_torch(q, k, v, bias=bias, **kw)
    ref = dict(zip(("dq", "dk", "dv", "dbias"),
                   flash_bwd_torch(q, k, v, o, lse, do, bias=bias, need_dbias=True, **kw)))
    ref["o"] = o_ref
    uniform = float((o[3].float() - v[3].float().mean(0)).abs().max())
    log(f"  evoformer wholly masked MSA row: max |o - mean(v)| = {uniform:.3e}")
    if uniform > 0.05:
        raise AssertionError("a wholly masked MSA row is not v's uniform average")
    errs = _check_pieces("flash bias MSA row (512 x 256, 8 x 32, mask + pair)", got, ref,
                         ("o", "dq", "dk", "dv", "dbias"))
    del got
    bwd_faults = _bias_bwd_faults("msa", q, k, v, do, bias, kw, ref, True)
    del ref
    torch.cuda.empty_cache()
    o_bad, _ = flash_fwd_bias_cuda(q, k, v, bias.transpose(-1, -2), **kw)
    fault = _fault_must_fail("pair + mask bias read transposed", o_bad, o_ref, "o")
    del o_bad, o_ref
    pairs = n * h * r * r
    work = bias_work(n, h, r, r, hd, pairs, bias.numel() * 4, bias.numel() * 4)
    t = {"fwd": measure(lambda: flash_fwd_bias_cuda(q, k, v, bias, **kw), 10),
         "dq": measure(lambda: flash_bwd_dq_bias_cuda(q, k, v, do, lse, delta, bias,
                                                      need_dbias=True, **kw), 10),
         "dkv": measure(lambda: flash_bwd_dkv_bias_cuda(q, k, v, do, lse, delta, bias, **kw),
                        10)}
    plain = {"fwd": measure(lambda: flash_fwd_torch(q, k, v, bias=bias, **kw), 3)["ms"],
             "bwd": measure(lambda: flash_bwd_torch(q, k, v, o, lse, do, bias=bias,
                                                    need_dbias=True, **kw), 3)["ms"]}
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    # the same function as the kernels with dbias: a mask that requires grad
    sdpa_fwd, sdpa_fwd_bwd, sdpa_label = _sdpa_bias_grad(qt, kt, vt, dot, bias)
    lib_fwd = measure(sdpa_fwd, 10)["ms"]
    lib_bwd = measure(sdpa_fwd_bwd, 10)["ms"] - lib_fwd
    log(f"  SDPA at the MSA shape ran on {sdpa_label}: forward {lib_fwd*1e3:.1f} us, "
        f"backward with dbias {lib_bwd*1e3:.1f} us [{card}]")
    torch.cuda.empty_cache()
    # the earlier yardstick, kept for continuity: a bf16 mask without grad
    # (SDPA reads half the bias bytes and computes no dbias)
    fmask = bias.to(torch.bfloat16)

    def sdpa_fwd_bwd_bf16():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, attn_mask=fmask).backward(dot)

    old_fwd = measure(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=fmask),
                      10)["ms"]
    old_bwd = measure(sdpa_fwd_bwd_bf16, 10)["ms"] - old_fwd
    log(f"  SDPA at the MSA shape, bf16 mask without grad (the earlier yardstick): forward "
        f"{old_fwd*1e3:.1f} us, backward {old_bwd*1e3:.1f} us [{card}]")
    rows = {}
    for key, pk, lib in (("fwd", "fwd", lib_fwd), ("dq", "bwd", lib_bwd),
                         ("dkv", "bwd", lib_bwd)):
        bound, by = work[key]
        rows[key] = {"ms": t[key]["ms"], "host_ms": t[key]["host_ms"], "plain_ms": plain[pk],
                     "library_ms": lib, "bound_ms": bound, "bound_by": by}
        rows[key]["library_ms_bf16_mask_no_grad"] = old_fwd if key == "fwd" else old_bwd
        log(f"  flash {key} bias MSA row [512 x 256, 8 x 32]: device {rows[key]['ms']*1e3:.1f} us, "
            f"bound {bound*1e3:.1f} us ({by}), plain {plain[pk]*1e3:.1f} us, "
            f"SDPA ({sdpa_label}) {lib*1e3:.1f} us [{card}]")
    out["evoformer"] = {"max_abs_err": {k_: e for k_, (e, _) in errs.items()},
                        "row_err_over_rms": {k_: r_ for k_, (_, r_) in errs.items()},
                        "uniform_row_err": uniform, "planted_fault": fault,
                        "planted_faults_bwd_sm90": bwd_faults, "sdpa_backend": sdpa_label,
                        "timing": rows, "pairs": pairs}
    del q, k, v, do, o, lse, delta, bias, qt, kt, vt, dot, fmask
    torch.cuda.empty_cache()
    return out


def sparse_pairs(layout, bs: int, causal: bool) -> int:
    """Visible (q, k) token pairs of one (batch, head) under a layout."""
    lay = np.asarray(layout, bool)
    nb = lay.shape[0]
    if not causal:
        return int(lay.sum()) * bs * bs
    lay = lay & np.tril(np.ones((nb, nb), bool))
    diag = int(np.trace(lay))
    return (int(lay.sum()) - diag) * bs * bs + diag * bs * (bs + 1) // 2


def sparse_work(layout, bs, causal, b, s, h, hkv, hd) -> dict:
    pairs = sparse_pairs(layout, bs, causal) * b * h
    q_bytes, kv_bytes, row_bytes = b * s * h * hd * 2, b * s * hkv * hd * 2, b * h * s * 4
    return {"pairs": pairs,
            "fwd": attn_bound_ms(pairs, hd, 2, 2 * q_bytes + 2 * kv_bytes + row_bytes),
            "dq": attn_bound_ms(pairs, hd, 3, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
            "dkv": attn_bound_ms(pairs, hd, 4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes)}


def _sparse_pieces(q, k, v, do, layout, bs, causal):
    import torch

    sa = _sparse()
    o, lse = sa.sparse_fwd_cuda(q, k, v, layout, bs, causal=causal)
    b, s, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)
    dq = sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, layout, bs, causal=causal)
    dk, dv = sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, layout, bs, causal=causal)
    torch.cuda.synchronize()
    return (o, lse, delta), {"o": o, "dq": dq, "dk": dk, "dv": dv}


def phase_sparse_kernels(seed: int, card: str):
    """The block-sparse kernels against their dense plain pieces on the card
    at Llama-3-8B attention width (batch 1, 32/8 heads, hd 128, bf16,
    S 4096, block 128): bigbird causal, fixed non-causal, sliding window;
    one small case at each of blocks 16, 32 and 64, and a layout with an
    empty kv column (exact zero dK/dV). A layout with one list entry
    swapped must fail. At S 16384 (bigbird causal, phase 15's shape) the
    same check against the plain pieces run over query-row chunks, and the
    global column's transposed list cut in half must fail dK; times there
    beside the bound and the dense-masked SDPA; the plain pieces' at
    S 4096."""
    import torch
    import torch.nn.functional as F

    sa = _sparse()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    out = {"cases": {}}

    def qkv(s, h, hkv, hd, b=1):
        return [torch.randn(b, s, hh, hd, generator=gen, device=dev).to(torch.bfloat16)
                for hh in (h, hkv, hkv, h)]

    def case(label, layout, bs, causal, tensors, q_chunk=None):
        q, k, v, do = tensors
        stats, got = _sparse_pieces(q, k, v, do, layout, bs, causal)
        o, lse, _ = stats
        o_ref, _ = sa.sparse_fwd_torch(q, k, v, layout, bs, causal=causal, q_chunk=q_chunk)
        ref = dict(zip(("dq", "dk", "dv"),
                       sa.sparse_bwd_torch(q, k, v, o, lse, do, layout, bs, causal=causal,
                                           q_chunk=q_chunk)))
        ref["o"] = o_ref
        errs = _check_pieces(f"sparse {label}", got, ref, ("o", "dq", "dk", "dv"))
        out["cases"][label] = {"max_abs_err": {k_: e for k_, (e, _) in errs.items()},
                               "row_err_over_rms": {k_: r for k_, (_, r) in errs.items()}}
        return got, o_ref, stats

    s, bs = SPARSE_S, SPARSE_BS
    nb = s // bs
    main = None
    t4096, t4096_dq, t4096_fwd = {}, {}, {}
    for name, (builder, causal) in SPARSE_LAYOUTS.items():
        tensors = qkv(s, H, 8, HD)
        lay = builder(nb)
        got, o_ref, (_, lse, delta) = case(f"{name} S={s} block {bs}", lay, bs, causal, tensors)
        q, k, v, do = tensors
        # the dK/dV kernel (sparse_sm90.cu at block 128) timed at each layout
        w4 = sparse_work(lay, bs, causal, 1, s, H, 8, HD)
        t4096[name] = {"ms": measure(lambda: sa.sparse_bwd_dkv_cuda(
            q, k, v, do, lse, delta, lay, bs, causal=causal), 10)["ms"],
            "bound_ms": w4["dkv"][0], "bound_by": w4["dkv"][1]}
        log(f"  sparse dkv {name} S={s} block {bs} (sparse_sm90.cu): device "
            f"{t4096[name]['ms']*1e3:.1f} us, bound {w4['dkv'][0]*1e3:.1f} us "
            f"({w4['dkv'][1]}) [{card}]")
        # and the dQ kernel (sparse_sm90.cu at block 128)
        t4096_dq[name] = {"ms": measure(lambda: sa.sparse_bwd_dq_cuda(
            q, k, v, do, lse, delta, lay, bs, causal=causal), 10)["ms"],
            "bound_ms": w4["dq"][0], "bound_by": w4["dq"][1]}
        log(f"  sparse dq {name} S={s} block {bs} (sparse_sm90.cu): device "
            f"{t4096_dq[name]['ms']*1e3:.1f} us, bound {w4['dq'][0]*1e3:.1f} us "
            f"({w4['dq'][1]}) [{card}]")
        # and the forward (sparse_sm90.cu at block 128)
        t4096_fwd[name] = {"ms": measure(lambda: sa.sparse_fwd_cuda(
            q, k, v, lay, bs, causal=causal), 10)["ms"],
            "bound_ms": w4["fwd"][0], "bound_by": w4["fwd"][1]}
        log(f"  sparse fwd {name} S={s} block {bs} (sparse_sm90.cu): device "
            f"{t4096_fwd[name]['ms']*1e3:.1f} us, bound {w4['fwd'][0]*1e3:.1f} us "
            f"({w4['fwd'][1]}) [{card}]")
        if main is None:
            main = (tensors, lay, causal, o_ref, lse, delta, got)
        del got, q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    out["timing_s4096_dkv"] = t4096
    out["timing_s4096_dq"] = t4096_dq
    out["timing_s4096_fwd"] = t4096_fwd
    for small_bs, hd, h, hkv in ((16, 32, 4, 2), (32, 64, 8, 2), (64, 128, 8, 8)):
        nb_s = 12
        lay = sa.bigbird_layout(nb_s, 3, 1, 2, seed=seed, causal=True)
        case(f"bigbird causal block {small_bs} hd {hd}", lay, small_bs, True,
             qkv(nb_s * small_bs, h, hkv, hd, b=2))
    lay = np.eye(8, dtype=bool)
    lay[:, 0] = True
    lay[1, 1] = False                                    # nobody attends to kv block 1
    got, _, _ = case("empty kv column block 128", lay, bs, False, qkv(8 * bs, H, 8, HD))
    if got["dk"][:, bs:2 * bs].any() or got["dv"][:, bs:2 * bs].any():
        raise AssertionError("an unattended kv block got nonzero dK/dV")
    log("  empty kv column: dK/dV exactly zero")

    # sparse_sm90.cu on the bigbird layout (its global column split into
    # chunks): two calls give the same bits, and each planted fault (the
    # merge dropping a chunk, a ring stage read early, a query head
    # skipped) fails the check the sound kernel passed
    (q, k, v, do), lay, causal, o_ref, lse, delta, good = main
    chunks0 = int(sa.dkv_split_plan(lay, causal, H // 8)["plan"][0, 4])
    again = sa.sparse_bwd_dkv_sm90_cuda(q, k, v, do, lse, delta, lay, bs, causal=causal)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], good["dk"]) and torch.equal(again[1], good["dv"])):
        raise AssertionError("sparse_sm90.cu: two calls gave different bits")
    log(f"  sparse dkv (sparse_sm90.cu): two calls bit-identical; kv block 0 in {chunks0} "
        "chunks")
    out["sm90_faults"] = {}
    for fault, what in ((1, "the merge drops a chunk's partial"),
                        (2, "a ring stage read before its copy lands"),
                        (3, "one query head of the group skipped")):
        with sa.sparse_sm90_planted_fault(fault):
            bad = sa.sparse_bwd_dkv_sm90_cuda(q, k, v, do, lse, delta, lay, bs, causal=causal)
            torch.cuda.synchronize()
        out["sm90_faults"][fault] = _fault_must_fail(
            f"sparse_sm90.cu planted fault {fault} ({what})", bad[0], good["dk"], "dk")
        del bad
    # its dQ (each item owns its rows: no merge): two calls give the same
    # bits, and each planted fault fails the check the sound kernel passed
    again = sa.sparse_bwd_dq_sm90_cuda(q, k, v, do, lse, delta, lay, bs, causal=causal)
    torch.cuda.synchronize()
    if not torch.equal(again, good["dq"]):
        raise AssertionError("sparse_sm90.cu dQ: two calls gave different bits")
    log("  sparse dq (sparse_sm90.cu): two calls bit-identical")
    for fault, what in ((4, "each list's last entry left out"),
                        (5, "a ring stage read before its copy lands"),
                        (6, "the diagonal block's mask left out")):
        with sa.sparse_sm90_planted_fault(fault):
            bad = sa.sparse_bwd_dq_sm90_cuda(q, k, v, do, lse, delta, lay, bs, causal=causal)
            torch.cuda.synchronize()
        out["sm90_faults"][fault] = _fault_must_fail(
            f"sparse_sm90.cu planted fault {fault} ({what})", bad, good["dq"], "dq")
        del bad
    # and its forward (each item owns its rows: no merge), held against the
    # plain forward as the sound kernel was
    again = sa.sparse_fwd_sm90_cuda(q, k, v, lay, bs, causal=causal)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], good["o"]) and torch.equal(again[1], lse)):
        raise AssertionError("sparse_sm90.cu forward: two calls gave different bits")
    log("  sparse fwd (sparse_sm90.cu): two calls bit-identical")
    for fault, what in ((7, "each list's last entry left out"),
                        (8, "a ring stage read before its copy lands"),
                        (9, "the diagonal block's mask left out")):
        with sa.sparse_sm90_planted_fault(fault):
            bad, _ = sa.sparse_fwd_sm90_cuda(q, k, v, lay, bs, causal=causal)
            torch.cuda.synchronize()
        out["sm90_faults"][fault] = _fault_must_fail(
            f"sparse_sm90.cu planted fault {fault} ({what})", bad, o_ref, "o")
        del bad
    del good, lse, delta, again

    # planted fault: one list entry of the bigbird layout swapped
    bad = lay.copy()
    row = nb - 1
    act = np.nonzero(bad[row, :row])[0]
    off = next(j for j in range(row) if not bad[row, j])
    bad[row, act[-1]], bad[row, off] = False, True
    o_bad, _ = sa.sparse_fwd_cuda(q, k, v, bad, bs, causal=causal)
    out["planted_fault"] = _fault_must_fail(
        f"row {row}'s list entry {act[-1]} -> {off}", o_bad, o_ref, "o")
    plain = {"fwd": measure(lambda: sa.sparse_fwd_torch(q, k, v, lay, bs, causal=causal),
                            3)["ms"]}
    o, lse = sa.sparse_fwd_cuda(q, k, v, lay, bs, causal=causal)
    plain["bwd"] = measure(lambda: sa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs,
                                                       causal=causal), 3)["ms"]
    del q, k, v, do, o, lse, o_bad, o_ref, main
    torch.cuda.empty_cache()

    # the kernels of sparse_attention.cu (bf16 below block 128, fp32) timed
    # where phase 15's second call runs them: S 4096, bigbird causal, block
    # 32, beside their bounds, their plain pieces and the dense-masked SDPA;
    # each two calls bit-identical, and its planted faults failing
    bs32 = SPARSE_BS_OLD
    lay = SPARSE_LAYOUTS["bigbird causal"][0](s // bs32)
    q, k, v, do = qkv(s, H, 8, HD)
    o, lse = sa.sparse_fwd_cuda(q, k, v, lay, bs32, causal=True)
    # its forward (this path's only one) held against the plain forward on
    # the same inputs: o at the flash limits, lse at the GPU tests'
    label32 = f"bigbird causal S={s} block {bs32}"
    o_ref, lse_ref = sa.sparse_fwd_torch(q, k, v, lay, bs32, causal=True)
    (err_o, rel_o), = _check_pieces(f"sparse {label32}", {"o": o}, {"o": o_ref},
                                    ("o",)).values()
    lse_err = float((lse - lse_ref).abs().max())
    lse_ok = bool(torch.isfinite(lse).all()) and bool(
        ((lse - lse_ref).abs() <= LSE_ATOL + LSE_RTOL * lse_ref.abs()).all())
    log(f"  sparse {label32} lse: max_abs_err={lse_err:.3e} (atol {LSE_ATOL:g}, rtol "
        f"{LSE_RTOL:g}) {'ok' if lse_ok else 'FAIL'}")
    if not lse_ok:
        raise AssertionError(f"sparse {label32}: lse disagrees with the plain forward "
                             f"(max abs err {lse_err})")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(H, s)
    if sa.sparse_source(q.dtype, bs32, HD) != sa.SPARSE_MMA:
        raise AssertionError(f"block {bs32} is not routed to {sa.SPARSE_MMA}")
    # its dQ on its own against the plain dQ from the same o and lse
    dq = sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, lay, bs32, causal=True)
    dq_ref = sa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs32, causal=True)[0]
    (err_dq, rel_dq), = _check_pieces(f"sparse {label32}", {"dq": dq}, {"dq": dq_ref},
                                      ("dq",)).values()
    out["cases"][label32] = {"max_abs_err": {"o": err_o, "lse": lse_err, "dq": err_dq},
                             "row_err_over_rms": {"o": rel_o, "dq": rel_dq}}
    # the forward and dQ (the query heads of a kv head in one work item, a
    # cp.async K / V ring): two calls give the same bits, and planted faults
    # 2 (the forward's ring stage read early) and 3 (dQ's last head of each
    # item left out) fail the checks the sound kernels passed
    again_o, again_lse = sa.sparse_fwd_cuda(q, k, v, lay, bs32, causal=True)
    again_dq = sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, lay, bs32, causal=True)
    torch.cuda.synchronize()
    if not (torch.equal(again_o, o) and torch.equal(again_lse, lse) and
            torch.equal(again_dq, dq)):
        raise AssertionError("sparse_attention.cu forward / dQ: two calls gave different bits")
    log(f"  sparse fwd, dq block {bs32} (sparse_attention.cu): two calls bit-identical")
    with sa.sparse_attention_planted_fault(2):
        bad_o, _ = sa.sparse_fwd_cuda(q, k, v, lay, bs32, causal=True)
    with sa.sparse_attention_planted_fault(3):
        bad_dq = sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, lay, bs32, causal=True)
    torch.cuda.synchronize()
    out["mma_faults"] = {
        2: _fault_must_fail("sparse_attention.cu planted fault 2 (the forward reads a ring "
                            "stage before its copy lands)", bad_o, o_ref, "o"),
        3: _fault_must_fail("sparse_attention.cu planted fault 3 (dQ leaves each item's last "
                            "query head out)", bad_dq, dq_ref, "dq")}
    del o_ref, lse_ref, dq, dq_ref, again_o, again_lse, again_dq, bad_o, bad_dq
    good = sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, lay, bs32, causal=True)
    again = sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, lay, bs32, causal=True)
    with sa.sparse_attention_planted_fault(1):
        bad, _ = sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, lay, bs32, causal=True)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], good[0]) and torch.equal(again[1], good[1])):
        raise AssertionError("sparse_attention.cu dK/dV: two calls gave different bits")
    chunks0 = int(sa.dkv_split_plan(lay, True, H // 8)["plan"][0, 4])
    log(f"  sparse dkv block {bs32} (sparse_attention.cu): two calls bit-identical; kv "
        f"block 0 in {chunks0} chunks")
    out["mma_fault"] = _fault_must_fail(
        "sparse_attention.cu planted fault 1 (the merge drops a split column's last chunk)",
        bad, good[0], "dk")
    del good, again, bad
    w32 = sparse_work(lay, bs32, True, 1, s, H, 8, HD)
    mask = sa.token_mask(lay, bs32, True, dev)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    kt, vt = (x.repeat_interleave(H // 8, dim=1) for x in (kt, vt))

    def sdpa32():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(dot)

    lib32_fwd = measure(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                        5)["ms"]
    lib32 = measure(sdpa32, 5)["ms"] - lib32_fwd
    out["timing_mma_fwd"] = {
        "ms": measure(lambda: sa.sparse_fwd_cuda(q, k, v, lay, bs32, causal=True), 10)["ms"],
        "plain_ms": measure(lambda: sa.sparse_fwd_torch(q, k, v, lay, bs32, causal=True),
                            3)["ms"],
        "plain_at": f"S {s} block {bs32}", "library_ms": lib32_fwd,
        "bound_ms": w32["fwd"][0], "bound_by": w32["fwd"][1]}
    out["timing_mma_dkv"] = {
        "ms": measure(lambda: sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, lay, bs32,
                                                     causal=True), 10)["ms"],
        "plain_ms": measure(lambda: sa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs32,
                                                        causal=True), 3)["ms"],
        "plain_at": f"S {s} block {bs32}", "library_ms": lib32,
        "bound_ms": w32["dkv"][0], "bound_by": w32["dkv"][1]}
    out["timing_mma_dq"] = {
        "ms": measure(lambda: sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, lay, bs32,
                                                    causal=True), 10)["ms"],
        **{k_: out["timing_mma_dkv"][k_] for k_ in ("plain_ms", "plain_at", "library_ms")},
        "bound_ms": w32["dq"][0], "bound_by": w32["dq"][1]}
    for key in ("fwd", "dq", "dkv"):
        r = out[f"timing_mma_{key}"]
        log(f"  sparse {key} bigbird causal S={s} block {bs32} (sparse_attention.cu): device "
            f"{r['ms']*1e3:.1f} us, bound {r['bound_ms']*1e3:.1f} us ({r['bound_by']}), plain "
            f"{r['plain_ms']*1e3:.1f} us, dense-masked SDPA "
            f"{'forward' if key == 'fwd' else 'backward'} {r['library_ms']*1e3:.1f} us "
            f"[{card}]")
    del q, k, v, do, o, lse, delta, mask, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # S 16384, bigbird causal, block 128 (phase 15's shape): held against the
    # plain pieces SPARSE_Q_CHUNK query rows at a time (their dense fp32
    # scores whole would take 32 GiB), the global kv column's transposed list
    # cut at half its length must fail dK; then timed
    s = SPARSE_S_LONG
    nb = s // bs
    builder, causal = SPARSE_LAYOUTS["bigbird causal"]
    lay = builder(nb)
    q, k, v, do = tensors = qkv(s, H, 8, HD)
    got, _, _ = case(f"bigbird causal S={s} block {bs}", lay, bs, causal, tensors,
                     q_chunk=SPARSE_Q_CHUNK)
    o, lse = sa.sparse_fwd_cuda(q, k, v, lay, bs, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(H, s)
    bad = lay.copy()
    bad[nb // 2:, 0] = False
    dk_bad, _ = sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, bad, bs, causal=causal)
    out["planted_fault_long"] = _fault_must_fail(
        f"S={s}: kv block 0's transposed list cut at {nb // 2} of {nb} entries",
        dk_bad[:, :bs], got["dk"][:, :bs], "dk")
    del got, dk_bad
    torch.cuda.empty_cache()
    work = sparse_work(lay, bs, causal, 1, s, H, 8, HD)
    t = {"fwd": measure(lambda: sa.sparse_fwd_cuda(q, k, v, lay, bs, causal=causal), 10),
         "dq": measure(lambda: sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, lay, bs,
                                                     causal=causal), 10),
         "dkv": measure(lambda: sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, lay, bs,
                                                       causal=causal), 10)}
    mask = sa.token_mask(lay, bs, causal, dev)
    # K/V widened for the yardstick: with a mask, SDPA's GQA option can
    # fall back to its math path, which would hold the dense scores
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    kt, vt = (x.repeat_interleave(H // 8, dim=1) for x in (kt, vt))

    def sdpa_fwd_bwd():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(dot)

    lib_fwd = measure(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                      5)["ms"]
    lib_bwd = measure(sdpa_fwd_bwd, 5)["ms"] - lib_fwd
    density = work["pairs"] / (H * s * (s + 1) / 2)
    rows = {}
    for key, pk, lib in (("fwd", "fwd", lib_fwd), ("dq", "bwd", lib_bwd),
                         ("dkv", "bwd", lib_bwd)):
        bound, by = work[key]
        rows[key] = {"ms": t[key]["ms"], "host_ms": t[key]["host_ms"], "plain_ms": plain[pk],
                     "plain_at": f"S {SPARSE_S}", "library_ms": lib, "bound_ms": bound,
                     "bound_by": by}
        log(f"  sparse {key} bigbird causal S={s} block {bs}: device {rows[key]['ms']*1e3:.1f} us, "
            f"bound {bound*1e3:.1f} us ({by}), plain (S {SPARSE_S}) {plain[pk]*1e3:.1f} us, "
            f"dense-masked SDPA {lib*1e3:.1f} us [{card}]")
    log(f"  ({density:.2%} of the causal pairs active; plain and SDPA backward times cover "
        f"dQ, dK and dV together)")
    out["timing"] = rows
    out["pairs"], out["density_of_causal"] = work["pairs"], density
    del q, k, v, do, o, lse, delta, mask, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return out



def check_fro(what: str, got, ref, tol: float = ENTRY_RTOL) -> float:
    """||got - ref||_F / ||ref||_F within ``tol``, ``got`` finite."""
    import torch

    rel = float((got.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30))
    ok = rel <= tol and bool(torch.isfinite(got.float()).all())
    log(f"  {what}: rel Frobenius {rel:.4f} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: disagrees with its reference (rel Frobenius {rel})")
    return rel


def phase_entry_points(seed: int, card: str):
    """The two attention entry points under autograd on the card:
    ``msa_row_attention`` at AlphaFold shapes (512 MSA rows x 256
    residues, c 256 = 8 heads of 32, bf16, one residue masked in every row,
    pair bias with grad) and ``blocksparse_attention`` at S 16384 (bigbird
    causal, block 128, 32/8 heads, hd 128, bf16). Launch counters are
    zeroed before each and must equal the calls made; outputs and grads
    finite and the outputs against a reference (the einsum path in fp32;
    the dense-masked SDPA), the block-sparse grads against the plain pieces
    (row limits of the flash checks)."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.evoformer_attn import msa_row_attention

    sa = _sparse()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    out = {}

    # ---- msa_row_attention ----------------------------------------------
    n, r, h, c = MSA_ROWS, MSA_RES, MSA_H, MSA_H * MSA_HD
    msa = torch.randn(1, n, r, c, generator=gen, device=dev).to(torch.bfloat16)
    ws = [(torch.randn(c, c, generator=gen, device=dev) * c ** -0.5).to(torch.bfloat16)
          for _ in range(4)]
    mask = torch.ones(1, n, r, device=dev)
    mask[..., 7] = 0
    pair0 = torch.randn(1, h, r, r, generator=gen, device=dev)
    bias_fns = (fa.flash_fwd_bias_cuda, fa.flash_bwd_dq_bias_cuda, fa.flash_bwd_dkv_bias_cuda)
    plain_fns = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    res = {}
    for label, use_kernel, dtype in (("kernel", None, torch.bfloat16),
                                     ("einsum", False, torch.float32)):
        for f in bias_fns + plain_fns:
            f.launches = 0
        x = msa.detach().to(dtype).requires_grad_()
        pair = pair0.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = msa_row_attention(x, *(w.to(dtype) for w in ws), pair_bias=pair, mask=mask,
                              num_heads=h, use_kernel=use_kernel)
        y.float().pow(2).mean().backward()
        torch.cuda.synchronize()
        res[label] = (y.detach(), pair.grad, x.grad, time.perf_counter() - t0,
                      [f.launches for f in bias_fns + plain_fns])
        del x, pair, y
    y, gpair, gx, wall, launches = res["kernel"]
    want = [1, 1, 1, 0, 0, 0]
    log(f"  msa_row_attention [1, {n}, {r}, {c}]: launches (bias fwd, dq, dkv; plain fwd, dq, "
        f"dkv) {launches}, expected {want}; fwd+bwd {wall*1e3:.1f} ms by host clock [{card}]")
    if launches != want:
        raise AssertionError(f"msa_row_attention launches {launches} != calls made {want}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in (y, gpair, gx)):
        raise AssertionError("msa_row_attention: non-finite output or grads")
    e_out = check_fro("msa_row_attention output vs einsum path (fp32)", y, res["einsum"][0])
    e_pair = check_fro("msa_row_attention pair-bias grad vs einsum path (fp32)", gpair,
                       res["einsum"][1])
    out["msa_row"] = {"launches": dict(zip(("flash_fwd_bias", "flash_bwd_dq_bias",
                                            "flash_bwd_dkv_bias"), launches[:3])),
                      "rel_fro": {"out": e_out, "pair_grad": e_pair}, "host_ms": wall * 1e3}
    del res, msa, ws, mask, pair0, y, gpair, gx
    torch.cuda.empty_cache()

    # ---- blocksparse_attention at S 16384 -------------------------------
    s, bs = SPARSE_S_LONG, SPARSE_BS
    builder, causal = SPARSE_LAYOUTS["bigbird causal"]
    lay = builder(s // bs)
    q, k, v = (torch.randn(1, s, hh, HD, generator=gen, device=dev).to(torch.bfloat16)
               .requires_grad_() for hh in (H, 8, 8))
    do = torch.randn(1, s, H, HD, generator=gen, device=dev).to(torch.bfloat16)
    # the three kernels: sparse_sm90.cu at block 128 (bf16),
    # sparse_attention.cu below it
    fns = (sa.sparse_fwd_sm90_cuda, sa.sparse_bwd_dq_sm90_cuda, sa.sparse_bwd_dkv_sm90_cuda,
           sa.sparse_fwd_cuda, sa.sparse_bwd_dq_cuda, sa.sparse_bwd_dkv_cuda)
    names = ("sparse_fwd_sm90", "sparse_bwd_dq_sm90", "sparse_bwd_dkv_sm90", "sparse_fwd",
             "sparse_bwd_dq", "sparse_bwd_dkv")
    for f in fns:
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = sa.blocksparse_attention(q, k, v, lay, bs, causal=causal)
    o.backward(do)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [f.launches for f in fns]
    log(f"  blocksparse_attention S={s} bigbird causal: launches (fwd, dq, dkv sm90; fwd, dq, "
        f"dkv) {launches}, expected [1, 1, 1, 0, 0, 0]; fwd+bwd {wall*1e3:.1f} ms by host "
        f"clock [{card}]")
    if launches != [1, 1, 1, 0, 0, 0]:
        raise AssertionError(f"blocksparse_attention launches {launches} != calls made")
    if not all(bool(torch.isfinite(t.float()).all()) for t in (o, q.grad, k.grad, v.grad)):
        raise AssertionError("blocksparse_attention: non-finite output or grads")
    mask = sa.token_mask(lay, bs, causal, dev)
    with torch.no_grad():
        ref = F.scaled_dot_product_attention(
            q.transpose(1, 2), *(x.repeat_interleave(H // 8, dim=2).transpose(1, 2)
                                 for x in (k, v)), attn_mask=mask).transpose(1, 2)
    e_out = check_fro("blocksparse_attention output vs dense-masked SDPA", o.detach(), ref)
    del ref, mask
    torch.cuda.empty_cache()
    # the grads against the plain pieces, SPARSE_Q_CHUNK query rows at a time
    with torch.no_grad():
        qd, kd, vd = (x.detach() for x in (q, k, v))
        o_ref, lse_ref = sa.sparse_fwd_torch(qd, kd, vd, lay, bs, causal=causal,
                                             q_chunk=SPARSE_Q_CHUNK)
        ref = dict(zip(("dq", "dk", "dv"), sa.sparse_bwd_torch(
            qd, kd, vd, o_ref, lse_ref, do, lay, bs, causal=causal, q_chunk=SPARSE_Q_CHUNK)))
    errs = _check_pieces(f"blocksparse_attention S={s} grads vs plain pieces",
                         {"dq": q.grad, "dk": k.grad, "dv": v.grad}, ref, ("dq", "dk", "dv"))
    out["blocksparse"] = {"launches": dict(zip(names, launches)),
                          "rel_fro": e_out, "host_ms": wall * 1e3,
                          "grad_row_err_over_rms": {k_: r for k_, (_, r) in errs.items()}}
    del q, k, v, do, o, ref, o_ref, lse_ref
    torch.cuda.empty_cache()

    # ---- blocksparse_attention at S 4096, block 32 ------------------------
    # (the three kernels of sparse_attention.cu, which keeps the blocks below 128)
    s, bs = SPARSE_S, SPARSE_BS_OLD
    lay = builder(s // bs)
    q, k, v = (torch.randn(1, s, hh, HD, generator=gen, device=dev).to(torch.bfloat16)
               .requires_grad_() for hh in (H, 8, 8))
    do = torch.randn(1, s, H, HD, generator=gen, device=dev).to(torch.bfloat16)
    for f in fns:
        f.launches = 0
    o = sa.blocksparse_attention(q, k, v, lay, bs, causal=causal)
    o.backward(do)
    torch.cuda.synchronize()
    launches = [f.launches for f in fns]
    log(f"  blocksparse_attention S={s} block {bs} bigbird causal: launches (fwd, dq, dkv "
        f"sm90; fwd, dq, dkv) {launches}, expected [0, 0, 0, 1, 1, 1]")
    if launches != [0, 0, 0, 1, 1, 1]:
        raise AssertionError(f"blocksparse_attention launches {launches} != calls made")
    if not all(bool(torch.isfinite(t.float()).all()) for t in (o, q.grad, k.grad, v.grad)):
        raise AssertionError("blocksparse_attention: non-finite output or grads")
    with torch.no_grad():
        qd, kd, vd = (x.detach() for x in (q, k, v))
        o_ref, lse_ref = sa.sparse_fwd_torch(qd, kd, vd, lay, bs, causal=causal,
                                             q_chunk=SPARSE_Q_CHUNK)
        ref = dict(zip(("dq", "dk", "dv"), sa.sparse_bwd_torch(
            qd, kd, vd, o_ref, lse_ref, do, lay, bs, causal=causal, q_chunk=SPARSE_Q_CHUNK)))
    errs = _check_pieces(f"blocksparse_attention S={s} block {bs} grads vs plain pieces",
                         {"dq": q.grad, "dk": k.grad, "dv": v.grad}, ref, ("dq", "dk", "dv"))
    out["blocksparse_block32"] = {
        "launches": dict(zip(names, launches)),
        "grad_row_err_over_rms": {k_: r for k_, (_, r) in errs.items()}}
    del q, k, v, do, o, ref, o_ref, lse_ref
    torch.cuda.empty_cache()
    return out


def bias_sparse_entries(kern: dict, bloom_train: dict, entry: dict) -> list:
    """The ``kernels`` line's entries of the flash kernels' bias mode (times
    at BLOOM-7b1's attention; the MSA row case beside them) and of the
    block-sparse kernels of both sources (``sparse_sm90.cu`` timed at S
    16384, ``sparse_attention.cu`` at S 4096 block 32)."""
    kernels = []
    fb, sp = kern["flash_bias"], kern["sparse"]
    for key, name, line in (("fwd", "flash_fwd_bias", "flash_attention.py:284"),
                            ("dq", "flash_bwd_dq_bias", "flash_attention.py:448"),
                            ("dkv", "flash_bwd_dkv_bias", "flash_attention.py:523")):
        r = fb["bloom"]["timing"][key]
        parts = {"fwd": ("o",), "dq": ("dq", "dbias"), "dkv": ("dk", "dv")}[key]
        errs = [c["max_abs_err"][x] for c in (fb["bloom"], fb["evoformer"])
                for x in parts if x in c["max_abs_err"]]
        by_path = {"bloom training": bloom_train["launches"][name],
                   "msa_row_attention": entry["msa_row"]["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/ops/csrc/"
                      + ("flash_fwd_sm90.cu" if key == "fwd" else "flash_bwd_sm90.cu"),
            "replaces": "deepspeed_tpu/ops/pallas/" + line + " (has_bias, _flash_b :787)",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "evoformer": {k_: fb["evoformer"]["timing"][key][k_]
                          for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "library_ms_bf16_mask_no_grad")}})
    # the cases each kernel ran: block 128 on sparse_sm90.cu, the smaller
    # blocks on sparse_attention.cu
    sm90_case = {c: c.endswith("block 128") for c in sp["cases"]}
    for key, name, line, src, which in (
            ("fwd", "sparse_fwd_sm90", ":39", "sparse_sm90.cu", True),
            ("fwd_mma", "sparse_fwd", ":39", "sparse_attention.cu", False),
            ("dq", "sparse_bwd_dq_sm90", ":87", "sparse_sm90.cu", True),
            ("dq_mma", "sparse_bwd_dq", ":87", "sparse_attention.cu", False),
            ("dkv", "sparse_bwd_dkv_sm90", ":126", "sparse_sm90.cu", True),
            ("dkv_mma", "sparse_bwd_dkv", ":126", "sparse_attention.cu", False)):
        r = {"fwd_mma": sp["timing_mma_fwd"], "dq_mma": sp["timing_mma_dq"],
             "dkv_mma": sp["timing_mma_dkv"]}.get(key, sp["timing"].get(key))
        keys = ("o",) if key.startswith("fwd") else ("dq",) if key.startswith("dq") else \
            ("dk", "dv")
        cases = [c for label, c in sp["cases"].items() if which == sm90_case[label]]
        by_path = {"blocksparse_attention S 16384 block 128":
                   entry["blocksparse"]["launches"][name],
                   "blocksparse_attention S 4096 block 32":
                   entry["blocksparse_block32"]["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/ops/csrc/" + src,
            "replaces": "deepspeed_tpu/ops/pallas/sparse_attention.py" + line,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"][x] for c in cases for x in keys
                               if x in c["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "plain_at": r["plain_at"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    kernels[-6]["s4096"] = sp["timing_s4096_fwd"]
    kernels[-4]["s4096"] = sp["timing_s4096_dq"]
    kernels[-2]["s4096"] = sp["timing_s4096_dkv"]
    return kernels


# --------------------------------------------------------------------------- #
# the serving core (phase 16): Llama-3-8B at 32 layers through engine v2's
# step_many (eager and as one CUDA graph), prefix cache, split prefill, fork,
# park / resume and the KV handoff
CORE_SHARED = 1024             # tokens of the prefix the core prompts share
CORE_TAILS = (17, 40, 64, 90, 100, 3, 77, 128)
CORE_K = 8                     # tokens a step_many quantum
CORE_CTX = 2048                # max_seq_len of the core engines (tables of 16 blocks)


def _stale_lengths(eng):
    """Planted fault of the graph path: ticks feed the tokens back but
    leave the context-length buffer, so every replay rewrites one position."""
    def advance(nxt):
        eng._dec.tokens[:, 0].copy_(nxt)
    eng._advance = advance


def _skip_cow(eng):
    """Planted fault of the prefix path: copy-on-write copies are skipped."""
    eng._copy_blocks = lambda pairs: None


def kv_rows(eng, desc, upto=None):
    """A sequence's K and V rows [L, positions, nkv, hd] through its table."""
    import torch

    n = desc.seen_tokens if upto is None else upto
    bs = eng.state.block_size
    table = torch.as_tensor(desc.blocks, device=eng.device)
    out = []
    for name in ("k", "v"):
        g = eng.cache[name][:, table].transpose(2, 3)       # [L, mb, bs, nkv, hd]
        out.append(g.reshape(g.shape[0], -1, *g.shape[3:])[:, :n])
    return out


def _fork_run(eng, prompt, inject: bool, steps: int = 6):
    """put, one step, fork (or not), the child's pending token changed, then
    ``steps`` steps; → (parent tokens, child tokens or None, parent, child)."""
    f0 = eng.put(1, prompt)
    f1 = eng.step()[1]
    child = eng.fork(1, 2) if inject else None
    if child is not None:
        inj = (f1 + 1) % eng.family.cfg.vocab_size
        child.last_token = inj
        eng._slot_tokens[child.slot] = inj
    outs = [eng.step() for _ in range(steps)]
    par = [f0, f1] + [o[1] for o in outs]
    chi = [o[2] for o in outs] if child is not None else None
    return par, chi, eng.state.seqs[1], child


def core_fork_check(fork_eng, ref, prompt) -> dict:
    """The fork's parent and child against solo runs on ``ref``: identical
    tokens and, bit for bit, identical K/V rows (decode-only paths: the same
    kernels at the same shapes). One copy-on-write of the shared tail."""
    import torch

    cow0 = fork_eng.state.prefix_stats["cow_copies"]
    par, chi, pd, cd = _fork_run(fork_eng, prompt, inject=True)
    cows = fork_eng.state.prefix_stats["cow_copies"] - cow0
    pk, pv = kv_rows(fork_eng, pd)
    ck, cv = kv_rows(fork_eng, cd)
    tail = pd.blocks[len(prompt) // fork_eng.state.block_size]
    ctail = cd.blocks[len(prompt) // fork_eng.state.block_size]
    # the solo parent, then the solo child (same put and step, the pending
    # token changed after it)
    rpar, _, rd, _ = _fork_run(ref, prompt, inject=False)
    rk, rv = kv_rows(ref, rd)
    ref.finish(1)
    ref.put(1, prompt)
    f1 = ref.step()[1]
    d = ref.state.seqs[1]
    d.last_token = (f1 + 1) % ref.family.cfg.vocab_size
    ref._slot_tokens[d.slot] = d.last_token
    rchi = [ref.step()[1] for _ in range(6)]
    rck, rcv = kv_rows(ref, ref.state.seqs[1])
    ref.finish(1)
    fork_eng.finish(1)
    fork_eng.finish(2)
    res = {"cow_copies": cows, "private_tails": tail != ctail,
           "parent_tokens": par == rpar, "child_tokens": chi == rchi,
           "parent_kv": bool(torch.equal(pk, rk) and torch.equal(pv, rv)),
           "child_kv": bool(torch.equal(ck, rck) and torch.equal(cv, rcv))}
    if not all(res.values()) or cows != 1:
        raise AssertionError(f"fork against solo runs: {res}")
    return res


def graph_modes(llama_params, llama_cfg, seed: int) -> dict:
    """The decode graph against the eager decode (``_graph_on = False``, the
    same forward over the same buffers) in every other family and mode whose
    decodes it runs: Llama-3-8B on int8 pools and with speculative decoding
    + fused verify on int8 pools (its plain decode steps), OPT-1.3B (24
    layers, LayerNorm) on bf16 pools and the same speculative mode: 8
    prompts x 32 greedy tokens through ``generate``, and two ``step_many``
    quanta of 8 after the same admissions, identical. → {mode: result}."""
    import torch

    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import gpt, llama

    opt_cfg = dataclasses.replace(gpt.GPTConfig.opt_1_3b(), activation="relu")
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    opt_params = gpt.init(opt_cfg, gen, dtype=torch.bfloat16, device="cuda")
    rs = np.random.RandomState(seed + 21)
    out = {}
    for label, family, cfg, params, extra in (
            ("llama_int8", llama, llama_cfg, llama_params, INT8),
            ("llama_spec_int8", llama, llama_cfg, llama_params, {**SPEC, **INT8}),
            ("opt_bf16", gpt, opt_cfg, opt_params, {}),
            ("opt_spec_int8", gpt, opt_cfg, opt_params, {**SPEC, **INT8})):
        prompts = (spec_prompts(seed, cfg.vocab_size)[0] if "speculative" in extra else
                   [rs.randint(0, cfg.vocab_size, n).astype(np.int32)
                    for n in (1, 17, 64, 100, 129, 200, 333, 500)])
        engines = []
        for graph_on in (False, True):
            eng = build_engine_v2(family, cfg, params, config=dict({
                "dtype": "bfloat16", "prefill_bucket": 64,
                "ragged": {"max_tracked_sequences": 64, "max_ragged_batch_size": 64,
                           "memory_config_blocks": 160, "block_size": 128}}, **extra))
            eng._graph_on = graph_on
            engines.append(eng)
        eager, graph = engines
        want = eager.generate(prompts, max_new_tokens=MAX_NEW_TOKENS)
        r = {"steps": graph.generate(prompts, max_new_tokens=MAX_NEW_TOKENS) == want}
        # quanta of plain decode ticks (spec mode too: step_many does not
        # draft), after the same admissions
        quanta = []
        for eng in engines:
            eng.put_many(list(enumerate(prompts)))
            quanta.append([eng.step_many(CORE_K) for _ in range(2)])
            for uid in list(eng.state.seqs):
                eng.finish(uid)
        r["step_many"] = quanta[0] == quanta[1]
        r["replays"] = graph.graph_replays
        r["per_replay"] = graph_per_replay(graph)
        expect = {"rms_norm" if family is llama else "layer_norm": 2 * cfg.num_layers + 1,
                  "paged_decode_attention" + ("_int8" if "kv_quant" in extra else ""):
                  cfg.num_layers}
        log(f"  decode graph == eager decode, {label}: {r}")
        if not (r["steps"] and r["step_many"]) or r["replays"] == 0 \
                or r["per_replay"] != expect:
            raise AssertionError(f"{label}: the decode graph's tokens differ from the eager "
                                 f"decode's, it never replayed, or its kernel nodes are not "
                                 f"{expect}: {r}")
        out[label] = r
        del engines, eager, graph
        torch.cuda.empty_cache()
    del opt_params
    torch.cuda.empty_cache()
    return out


def phase_serving_core(seed: int, card: str) -> dict:
    """Engine v2's serving core at Llama-3-8B's full width and depth, every
    engine on one set of bf16 weights from the seed. Each check compares two
    runs whose forwards have the same shapes, so their tokens (and K/V) must
    agree bit for bit:

    - the decode graph (``step_many`` quanta and single steps) against the
      eager decode (8 prompts x 32 tokens, 64 slots; sampled rows too), and
      in the other families and modes (:func:`graph_modes`); launches under
      the graph (its kernel nodes x replays); eager step(), graph step() and
      the graph quantum timed (wall, device busy, idle share, kernels a
      token-step), the profiler's named records equal to the launches;
    - the prefix cache on against off on 8 prompts sharing 1024 tokens (both
      split at 1024, so the prefix is the same chunk either way);
    - split prefill (256-token chunks) against one-shot prefill, which holds
      only while a prefill row's result does not hang on the batch's shape
      (the GEMMs' and the plain attention's), and the prefix cache on
      against off with speculative decoding + fused verify (verify over
      shared blocks; one-shot admissions, which rest on the same);
    - a fork (shared partial tail, copy-on-write) against solo runs, plain
      and in spec mode; park / resume under churn against park / resume
      without; an export → import handoff resumed on a second engine against
      the resume on the first.

    Planted faults: a replay whose context-length buffer is not advanced,
    and skipped copy-on-write copies, must each fail their check."""
    import torch

    from deepspeed_tpu_torch.inference import SamplingParams, build_engine_v2
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_spec_verify_attention_cuda)

    cfg = llama.LlamaConfig.llama3_8b()
    core_cfg = dataclasses.replace(cfg, max_seq_len=CORE_CTX)
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    counters = {"rms_norm": rms_norm_cuda, "paged_decode_attention": paged_decode_attention_cuda,
                "paged_spec_verify_attention": paged_spec_verify_attention_cuda}

    def engine(c, slots, blocks, **conf):
        return build_engine_v2(llama, c, params, config=dict({
            "dtype": "bfloat16", "prefill_bucket": 64,
            "ragged": {"max_tracked_sequences": slots, "max_ragged_batch_size": slots,
                       "memory_config_blocks": blocks, "block_size": 128}}, **conf))

    def zero():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    res = {"num_layers": cfg.num_layers, "k": CORE_K}
    per_fwd = 2 * cfg.num_layers + 1

    # -- (a) the decode graph against the eager decode -------------------- #
    # the eager engine runs the graph's plain version: the same forward over
    # the same static buffers, not captured
    rs = np.random.RandomState(seed)
    lengths = [1, 17, 64, 100, 129, 200, 333, 500]
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    eager = engine(cfg, 64, 160)
    eager._graph_on = False
    graph = engine(cfg, 64, 160)
    eager.generate(prompts[:2], max_new_tokens=2)                      # warm-up
    graph.generate(prompts[:2], max_new_tokens=2)
    per_replay = graph_per_replay(graph)
    log(f"  decode graph captured at 64 slots; its kernel nodes hold {per_replay} of the "
        f"hand-written kernels")
    if per_replay != {"rms_norm": per_fwd, "paged_decode_attention": cfg.num_layers}:
        raise AssertionError(f"a replay launches {per_replay}, expected {per_fwd} RMSNorm "
                             f"and {cfg.num_layers} paged decode")
    want = eager.generate(prompts, max_new_tokens=MAX_NEW_TOKENS)
    zero()
    many = eager.generate(prompts, max_new_tokens=MAX_NEW_TOKENS, steps_per_sync=CORE_K)
    eager_many_launches = counts()
    zero()
    replays0 = graph.graph_replays
    graph.forward_log.clear()
    got = graph.generate(prompts, max_new_tokens=MAX_NEW_TOKENS, steps_per_sync=CORE_K)
    replays = graph.graph_replays - replays0
    eager_side = counts()
    n_prefill = sum(k == "prefill" for k, *_ in graph.forward_log)
    graph_launches = with_replays(eager_side, per_replay, replays)
    log(f"  graph run: {n_prefill} prefill forwards and {replays} replays; launches "
        f"{graph_launches} (by the wrappers {eager_side})")
    if eager_side != {"rms_norm": per_fwd * n_prefill, "paged_decode_attention": 0,
                      "paged_spec_verify_attention": 0} or replays == 0:
        raise AssertionError(f"graph run's eager launches {eager_side} ({n_prefill} prefills)")
    steps = graph.generate(prompts, max_new_tokens=MAX_NEW_TOKENS)
    # stochastic rows beside greedy ones: sampling runs outside the graph,
    # from the same per-row generators, on the same logits
    samp = SamplingParams(temperature=0.8, top_k=50)
    sampled = []
    for eng in (eager, graph):
        eng.put_many([(200 + i, p) for i, p in enumerate(prompts[:4])], samp, seed=3)
        eng.put_many([(300 + i, p) for i, p in enumerate(prompts[4:])], seed=3)
        sampled.append([eng.step_many(4, seed=5 + i) for i in range(4)]
                       + [eng.step(seed=21)])
        for uid in list(eng.state.seqs):
            eng.finish(uid)
    ident = {"step_many_eager": many == want, "step_many_graph": got == want,
             "step_graph": steps == want, "sampled_graph": sampled[0] == sampled[1]}
    log(f"  8 prompts x {MAX_NEW_TOKENS} greedy tokens against eager single steps: eager "
        f"step_many {ident['step_many_eager']}, graph step_many {ident['step_many_graph']}, "
        f"graph steps {ident['step_graph']}; 4 sampled + 4 greedy rows, graph == eager "
        f"{ident['sampled_graph']}")
    if not all(ident.values()):
        raise AssertionError(f"the decode graph's tokens differ from the eager decode's: {ident}")
    res.update(identity=ident, per_replay=per_replay, graph_launches=graph_launches,
               eager_launches=eager_side, eager_many_launches=eager_many_launches,
               replays=replays)
    # every other family and mode that decodes through the graph
    res["modes"] = graph_modes(params, cfg, seed)

    # where the time goes: 8 token-steps as eager step() calls, as graph
    # step() calls and as one quantum of graph replays, over the same 8 live
    # sequences; the hand-written kernels the profiler names in each window
    # must be the launches made there, exactly
    uids = list(range(100, 108))
    timing = {}
    want_named = {k: per_replay[k] * CORE_K for k in per_replay}
    for name, eng, fn in (("eager_step", eager, lambda: [eager.step() for _ in range(CORE_K)]),
                          ("graph_step", graph, lambda: [graph.step() for _ in range(CORE_K)]),
                          ("graph_step_many", graph, lambda: graph.step_many(CORE_K))):
        eng.put_many(list(zip(uids, prompts)))
        fn()                                           # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / (2 * CORE_K)
        wall, busy, n_k, top = profile_window(fn)
        named = {"rms_norm": sum(c for k, _, c in top if "rms_norm_" in k),
                 "paged_decode_attention": sum(c for k, _, c in top if "paged_sm90" in k)}
        timing[name] = {"wall_ms": host_ms, "profiled_wall_ms": wall * 1e3 / CORE_K,
                        "busy_ms": busy * 1e3 / CORE_K, "idle_share": 1 - busy / wall,
                        "kernels_per_step": n_k / CORE_K, "named_kernels": named,
                        "top": [(k, ms / CORE_K, c / CORE_K) for k, ms, c in top[:8]]}
        calls = launch_calls(fn)
        timing[name]["host_calls_per_step"] = {k: v / CORE_K for k, v in calls.items()}
        for u in uids:
            eng.finish(u)
        t = timing[name]
        log(f"  {name}: wall {t['wall_ms']:.2f} ms a token-step (profiled "
            f"{t['profiled_wall_ms']:.2f}), device busy {t['busy_ms']:.2f} ms, idle "
            f"{t['idle_share']:.1%}, {t['kernels_per_step']:.0f} kernels a step; by name "
            f"{named}; host launch calls a step {t['host_calls_per_step'] or 'not measured'} "
            f"[{card}]")
        if named != want_named:
            raise AssertionError(f"{name}: the profiler names {named} kernels, the launches "
                                 f"were {want_named}")
    res["timing"] = timing

    # planted fault: the graph replays with the lengths never advanced
    _stale_lengths(graph)
    bad = graph.generate(prompts, max_new_tokens=MAX_NEW_TOKENS, steps_per_sync=CORE_K)
    if bad == want:
        raise AssertionError("graph replays with stale context lengths passed the check")
    log("  planted fault (replays with the context-length buffer not advanced): "
        "differs from single steps, as it must")
    del eager, graph
    torch.cuda.empty_cache()

    # -- (b) prefix cache on against off ---------------------------------- #
    rs = np.random.RandomState(seed + 16)
    shared = rs.randint(0, cfg.vocab_size, CORE_SHARED)
    core_prompts = [np.concatenate([shared, rs.randint(0, cfg.vocab_size, n)]).astype(np.int32)
                    for n in CORE_TAILS]
    split1k = {"split_prefill_chunk": CORE_SHARED}
    prefix = {"prefix_cache": {"enabled": True}}
    off = engine(core_cfg, 16, 128, **split1k)
    on = engine(core_cfg, 16, 128, **split1k, **prefix)
    want = off.generate(core_prompts, max_new_tokens=MAX_NEW_TOKENS)
    on.generate(core_prompts[:1], max_new_tokens=2)        # the shared blocks retained
    saved0 = on.state.prefix_stats["prefill_tokens_saved"]
    zero()
    got = on.generate(core_prompts, max_new_tokens=MAX_NEW_TOKENS)
    saved = on.state.prefix_stats["prefill_tokens_saved"] - saved0
    res["prefix"] = {"identical": got == want, "prefill_tokens_saved": saved,
                     "launches": counts(), "stats": dict(on.state.prefix_stats)}
    log(f"  prefix cache on == off: {got == want}; prefill tokens saved {saved} of "
        f"{sum(len(p) for p in core_prompts)} (8 x {CORE_SHARED} shared)")
    if got != want or saved < len(core_prompts) * CORE_SHARED:
        raise AssertionError(f"prefix cache: {res['prefix']}")
    on.state.debug_check()

    # -- (c) split prefill against one-shot ------------------------------- #
    one = engine(core_cfg, 16, 128)
    split = engine(core_cfg, 16, 128, split_prefill_chunk=CORE_SHARED // 4)
    want1 = one.generate(core_prompts, max_new_tokens=MAX_NEW_TOKENS)
    got1 = split.generate(core_prompts, max_new_tokens=MAX_NEW_TOKENS)
    chunks = sum(k == "prefill_chunk" for k, *_ in split.forward_log)
    agree = [sum(a == b for a, b in zip(x, y)) for x, y in zip(got1, want1)]
    firsts = [x[0] == y[0] for x, y in zip(got1, want1)]
    res["split"] = {"identical": got1 == want1, "chunks": chunks,
                    "first_token_identical": firsts, "tokens_agreeing": agree,
                    "split1k_identical": want == want1}
    log(f"  split prefill ({CORE_SHARED // 4}) == one-shot: {got1 == want1} ({chunks} chunks; first tokens "
        f"{sum(firsts)}/8, tokens agreeing {agree}); split 1024 == one-shot: {want == want1}")
    if got1 != want1:
        raise AssertionError(f"split prefill against one-shot: {res['split']}")

    # -- (d) fork: the shared partial tail copied on write ---------------- #
    fork_prompt = np.random.RandomState(seed + 17).randint(0, cfg.vocab_size, CORE_SHARED - 24)
    res["fork"] = core_fork_check(one, split, fork_prompt)
    log(f"  fork against solo runs: {res['fork']}")
    # (another prompt: the sound run's blocks, freed in the same order, would
    # hand the faulty run's copies their right contents)
    _skip_cow(one)
    try:
        core_fork_check(one, split, fork_prompt[::-1].copy())
    except AssertionError as e:
        log(f"  planted fault (copy-on-write copies skipped): fails, as it must ({e})")
    else:
        raise AssertionError("a fork with its copy-on-write copies skipped passed the check")
    for uid in list(one.state.seqs):
        one.finish(uid)
    del one

    # -- (e) park / resume under churn, and the export → import handoff -- #
    rs = np.random.RandomState(seed + 18)
    q, churn, q2 = (rs.randint(0, cfg.vocab_size, n).astype(np.int32)
                    for n in (CORE_SHARED - 24, CORE_SHARED // 3, CORE_SHARED - 24))
    dst = engine(core_cfg, 16, 128, **prefix)

    def park_cycle(eng, with_churn):
        eng.put(1, q)
        for _ in range(5):
            eng.step()
        parked = eng.park(1)
        if with_churn:
            eng.put(2, churn)
            for _ in range(3):
                eng.step()
            eng.finish(2)
        eng.resume(parked)
        for _ in range(6):
            eng.step()
        return eng.finish(1)

    a = park_cycle(on, True)
    b = park_cycle(dst, False)
    ref = engine(core_cfg, 16, 128)
    ref.put(1, q)
    for _ in range(12):
        ref.step()
    uninterrupted = ref.finish(1)
    del ref
    res["park_resume"] = {"identical": a == b,
                          "agree_uninterrupted": sum(x == y for x, y in zip(a, uninterrupted))}
    log(f"  park / resume under churn == without: {a == b}; tokens agreeing with the "
        f"uninterrupted run {res['park_resume']['agree_uninterrupted']}/{len(a)}")
    if a != b:
        raise AssertionError(f"park / resume: {a} != {b}")

    src = on
    src.put(5, q2)
    for _ in range(5):
        src.step()
    exp = src.export_kv_blocks(5, wire="native")
    exp8 = src.export_kv_blocks(5, wire="int8", wire_group=64)
    parked = src.park(5)
    imp = dst.import_kv_blocks(exp["hashes"], exp["blocks"])
    dst.resume(parked)
    src.resume(parked)
    for _ in range(6):
        dst.step()
        src.step()
    d_toks, s_toks = dst.finish(5), src.finish(5)
    res["handoff"] = {"identical": d_toks == s_toks, "import": imp,
                      "blocks": len(exp["blocks"]), "wire_bytes": exp["wire_bytes"],
                      "int8_wire_bytes": exp8["wire_bytes"],
                      "bf16_equiv_bytes": exp8["bf16_equiv_bytes"]}
    log(f"  handoff: {len(exp['blocks'])} blocks, native {exp['wire_bytes']/1e6:.1f} MB, "
        f"int8 wire {exp8['wire_bytes']/1e6:.1f} MB; import {imp}; resumed == resumed at the "
        f"source {d_toks == s_toks}")
    if d_toks != s_toks or imp["imported"] != len(exp["blocks"]):
        raise AssertionError(f"handoff: {res['handoff']}")
    dst.state.debug_check()
    src.state.debug_check()
    del src, on, off, dst, split
    torch.cuda.empty_cache()

    # -- (f) spec verify over shared prefix blocks and forked tails ------- #
    rs = np.random.RandomState(seed + 19)
    spec_prompts_ = []
    for n in CORE_TAILS:
        span = rs.randint(0, cfg.vocab_size, max(2, n // 3))
        spec_prompts_.append(np.concatenate([shared, np.tile(span, 3)]).astype(np.int32))
    # not split: in spec mode a step verifies every live sequence when any
    # drafts, so the rows a sequence's tokens come from hang on the others'
    # schedule, and split admissions schedule differently with and without
    # hits. Unsplit, both engines admit all 8 prompts in one burst; the
    # prefill rows' independence of the batch's shape is what (c) shows.
    s_off = engine(core_cfg, 16, 128, **SPEC)
    s_on = engine(core_cfg, 16, 128, **SPEC, **prefix)
    want = s_off.generate(spec_prompts_, max_new_tokens=MAX_NEW_TOKENS)
    s_on.generate(spec_prompts_[:1], max_new_tokens=2)
    zero()
    stats0 = dict(s_on.spec_stats)
    got = s_on.generate(spec_prompts_, max_new_tokens=MAX_NEW_TOKENS)
    spec_launches = counts()
    verify_steps = s_on.spec_stats["verify_steps"] - stats0["verify_steps"]
    log(f"  spec + fused verify, prefix on == off: {got == want}; {verify_steps} verify "
        f"steps, launches {spec_launches}")
    if got != want or spec_launches["paged_spec_verify_attention"] != \
            cfg.num_layers * verify_steps or verify_steps == 0:
        raise AssertionError(f"spec over shared blocks: {got == want}, {spec_launches}")
    # a fork in spec mode: verify rows over the shared tail, rollback into it
    span = np.random.RandomState(seed + 20).randint(0, cfg.vocab_size, 50)
    rep = np.tile(span, (CORE_SHARED - 24) // 50).astype(np.int32)
    zero()
    cow0 = s_on.state.prefix_stats["cow_copies"]
    s_on.put(1, rep)
    s_on.fork(1, 2)
    par = [s_on.step() for _ in range(4)]
    fork_launches = counts()
    s_off.put(1, rep)
    solo = [s_off.step() for _ in range(4)]
    ok = [p[1] for p in par] == [s[1] for s in solo] and [p[2] for p in par] == [s[1] for s in solo]
    res["spec"] = {"identical": got == want, "verify_steps": verify_steps,
                   "launches": spec_launches, "fork_identical": ok,
                   "fork_launches": fork_launches,
                   "fork_cow_copies": s_on.state.prefix_stats["cow_copies"] - cow0}
    log(f"  spec fork: parent and child == solo run {ok}; launches {fork_launches}, "
        f"copies on write {res['spec']['fork_cow_copies']}")
    if not ok or fork_launches["paged_spec_verify_attention"] == 0:
        raise AssertionError(f"spec fork: {par} != {solo} or no verify step "
                             f"({fork_launches})")
    s_on.state.debug_check()
    del s_on, s_off, params
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  serving core phase {res['seconds']:.1f} s [{card}]")
    return res


# --------------------------------------------------------------------------- #
# the serving fleet (phase 17): Llama-3-8B at 32 layers behind the port's
# continuous-batching scheduler, replica router, fleet failover and
# disaggregated prefill / decode
FLEET_N = 48                   # requests in the seeded trace
FLEET_RATE = 6.0               # Poisson arrivals a second
FLEET_PROMPT = (64, 1024)      # prompt tokens, uniform
FLEET_GEN = (16, 128)          # generated tokens, uniform
FLEET_DEADLINE_MS = 20000.0    # the deadline of every third request (the rest: none)
FLEET_CHUNK = 256              # split_prefill_chunk
FLEET_BLOCKS = 65              # 64 usable blocks of 128 tokens, below the trace's peak demand
FLEET_K = 8                    # decode_quantum
FLEET_SLOTS = 16
FLEET_TICK_S = 0.25            # fake-clock seconds a tick (parts a and c)
FLEET_PREEMPT_EVERY = 15       # ticks between part a's explicit preemptions
FLEET_WINDOW = 2               # ticks or router steps a profiled window of a part holds
FLEET_C_REQUESTS = 12          # requests of part c (all submitted at once)
FLEET_C_CRASH_AFTER = 2        # healthy ticks of replica 1 before it crashes
FLEET_D_SHARED = 1024          # tokens of the prefix part d's prompts share
FLEET_D_GEN = 32               # generated tokens of part d, cut from the trace's
PAGED_KEYS = ("paged_decode_attention", "paged_decode_attention_int8",
              "paged_spec_verify_attention")


class FakeClock:
    """A clock that moves only when told to (scheduler deadlines and queue
    waits, ``FleetConfig.clock``), so every scheduling decision of a run is
    a function of its inputs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


def fleet_trace(S, vocab: int, seed: int) -> list:
    """The phase's seeded trace as fresh ``(arrival s, Request)`` pairs: the
    first ``FLEET_N`` Poisson arrivals of a ``TrafficGenerator``, priorities
    0-2, a deadline on every third request."""
    gen = S.TrafficGenerator(S.WorkloadConfig(
        seed=seed, vocab_size=vocab, process="poisson", rate_rps=FLEET_RATE,
        prompt_len=FLEET_PROMPT, gen_len=FLEET_GEN, priorities=(0, 1, 2)))
    arr = gen.arrivals(10 * FLEET_N / FLEET_RATE)[:FLEET_N]
    if len(arr) < FLEET_N:
        raise AssertionError(f"the trace holds {len(arr)} arrivals, not {FLEET_N}")
    for i, a in enumerate(arr):
        if i % 3 == 0:
            a.request.deadline_ms = FLEET_DEADLINE_MS
    return [(a.t, a.request) for a in arr]


def record_calls(eng):
    """Log ``eng``'s admissions, split admissions, parks, resumes and
    finishes in order (the decision log), and keep what each finish
    returned (the engine's own generated tokens) → (log, {uid: tokens})."""
    log, finished = [], {}
    keys = {"put_many": lambda a, k: tuple(int(u) for u, _ in a[0]),
            "put_split": lambda a, k: int(a[0]), "park": lambda a, k: int(a[0]),
            "resume": lambda a, k: (int(a[0]["uid"]), bool(k.get("split", False))),
            "finish": lambda a, k: int(a[0])}
    for name, key in keys.items():
        orig = getattr(eng, name)

        def wrapped(*a, _orig=orig, _name=name, _key=key, **k):
            log.append((_name, _key(a, k)))
            out = _orig(*a, **k)
            if _name == "finish":
                finished[int(a[0])] = list(out)
            return out

        setattr(eng, name, wrapped)
    return log, finished


def count_blocked(sched) -> dict:
    """Count the ticks whose admission left requests queued although a slot
    was free: admission control held them back for KV blocks."""
    stat = {"blocked_ticks": 0}
    orig = sched._admit

    def admit(now, seed):
        n = orig(now, seed)
        st = sched.engine.state
        if sched.queue_depth and st.free_slots and \
                len(sched._live) < (sched.cfg.max_live or st.max_sequences):
            stat["blocked_ticks"] += 1
        return n

    sched._admit = admit
    return stat


def preempt_least_urgent(sched) -> None:
    """Park the least urgent decoding request (highest priority number, then
    latest deadline, then uid) through ``ServingScheduler.preempt``: the
    path the preemption guard takes under decode growth, which this trace
    never reaches (an admission reserves a decode block beyond the prompt,
    and no generation here outgrows it)."""
    seqs = sched.engine.state.seqs
    live = [h for h in sched.handles.values()
            if h.state == "running" and h.uid in seqs and not seqs[h.uid].prefilling]
    if live:
        h = max(live, key=lambda h: (h.request.priority, h._deadline_t, h.uid))
        sched.preempt(h.uid)


def reemit_last_token(eng):
    """Planted fault of the scheduler path: a resume re-emits the last token
    the stream already emitted before the new one (exactly-once broken)."""
    orig = eng.resume

    def resume(parked, *a, **k):
        toks = orig(parked, *a, **k)
        return parked["generated"][-1:] + toks
    eng.resume = resume


def exactly_once(handles, streams, finished) -> list:
    """The requests whose stream is not delivered exactly once at full
    length: state done, ``max_new_tokens`` tokens, the ``on_token`` stream
    equal to the handle's tokens, and those equal to the tokens the engine
    generated (what its ``finish`` returned)."""
    bad = []
    for h, s in zip(handles, streams):
        gen = finished.get(h.uid, [])
        if not (h.state == "done" and len(h.tokens) == h.request.max_new_tokens
                and s == h.tokens and h.tokens == gen[:len(h.tokens)]):
            bad.append(h.uid)
    return bad


class PathLaunches:
    """The hand-written kernels' launches on a path since construction: the
    wrappers' (eager forwards) plus each engine's decode-graph kernel nodes
    times the replays it made. A CUDA engine must have captured its graph
    first (:func:`capture_decode_graph`): the capture moves the wrappers'
    counts without a launch."""

    def __init__(self, counters: dict, engines):
        self.counters = counters
        self.engines = list(engines)
        for e in self.engines:
            if e._graph_on and e._graph is None:
                raise AssertionError("count launches only after the decode graph's capture")
        self.per = [graph_per_replay(e) if e._graph_on else {} for e in self.engines]
        self.c0 = {k: c.launches for k, c in counters.items()}
        self.r0 = [e.graph_replays for e in self.engines]

    def read(self) -> dict:
        out = {k: c.launches - self.c0[k] for k, c in self.counters.items()}
        for e, per, r0 in zip(self.engines, self.per, self.r0):
            out = with_replays(out, per, e.graph_replays - r0)
        return out


def add_launches(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def checked_window(label: str, engines, counters: dict, fn, card: str) -> dict:
    """``fn`` under the profiler: the RMSNorm and paged-kernel records it
    names must equal the launches made in that session (decode, int8 decode
    and spec verify share ``paged_sm90.cu``'s kernel), as phase 16 checks
    them; → wall, busy, idle share, the session's launches and the
    launches of every session run (``launches_total``).

    CUPTI on this card has dropped records in the middle of a long window
    late in the script (62593 of 64555 kernels, 79 of 2470 RMSNorm): such
    a session is logged and the window runs again, ``PROFILE_SESSIONS``
    times in all, then it raises. A launch count the kernels do not match
    fails every session."""
    got, total = {}, {}

    def run():
        pl = PathLaunches(counters, engines)
        fn()
        got.clear()
        got.update(pl.read())
        add_launches(total, got)

    for session in range(PROFILE_SESSIONS):
        wall, busy, n_k, top = profile_window(run)
        named = {"rms_norm": sum(c for k, _, c in top if "rms_norm_" in k),
                 "paged": sum(c for k, _, c in top if "paged_sm90" in k)}
        want = {"rms_norm": got["rms_norm"], "paged": sum(got[k] for k in PAGED_KEYS)}
        if named == want and want["rms_norm"]:
            break
        log(f"  {label}: the profiler names {named} kernels of {n_k} records, the launches "
            f"were {want} (session {session + 1} of this window; again)")
    else:
        raise AssertionError(f"{label}: the profiler names {named} kernels, the launches "
                             f"were {want}, in {PROFILE_SESSIONS} sessions")
    res = {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall, "kernels": n_k,
           "named": named, "launches": dict(got), "launches_total": total,
           "sessions": session + 1}
    log(f"  {label}: profiled window wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms (idle {res['idle_share']:.1%}), {n_k} kernels; by name "
        f"{named}, launches {want} [{card}]")
    return res


class Replay:
    """Open-loop replay of a trace on a fake clock: each :meth:`step` moves
    the clock ``dt``, submits every arrival due and, while work is pending,
    ticks once (``tick``: a scheduler's ``tick`` or a router's ``step``),
    checking the caches' invariants after the tick when ``engines`` are
    given."""

    def __init__(self, submit, tick, pending, trace, clock, dt, engines=(), every=None):
        self.submit, self.tick, self.pending = submit, tick, pending
        self.trace, self.clock, self.dt = trace, clock, dt
        self.engines = list(engines)
        self.every = every                      # (n, fn): fn() after every n-th tick
        self.i = self.ticks = 0
        self.handles, self.streams = [], []

    @property
    def done(self) -> bool:
        return self.i == len(self.trace) and not self.pending()

    def step(self) -> None:
        self.clock.advance(self.dt)
        while self.i < len(self.trace) and self.trace[self.i][0] <= self.clock.t:
            self.streams.append([])
            self.handles.append(self.submit(self.trace[self.i][1],
                                            on_token=self.streams[-1].append))
            self.i += 1
        if self.pending():
            self.tick()
            self.ticks += 1
            if self.every and self.ticks % self.every[0] == 0:
                self.every[1]()
            for e in self.engines:
                e.state.debug_check()
                e.debug_check_cache()

    def run(self, until_ticks=None, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if self.done or (until_ticks is not None and self.ticks >= until_ticks):
                return
            self.step()
        raise AssertionError("the replay did not drain")


def fleet_engines(params, cfg, n: int, warm_prompt, graph=True, **conf) -> list:
    """``n`` engines of Llama-3-8B at ``CORE_CTX``, 16 slots, blocks of 128,
    each warmed and (on the graph) captured alike, so their states agree."""
    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import llama

    base = {"dtype": "bfloat16", "prefill_bucket": 64,
            "ragged": {"max_tracked_sequences": FLEET_SLOTS,
                       "max_ragged_batch_size": FLEET_SLOTS,
                       "memory_config_blocks": conf.pop("blocks", FLEET_BLOCKS),
                       "block_size": 128}}
    out = []
    for _ in range(n):
        eng = build_engine_v2(llama, cfg, params, config=dict(base, **conf))
        eng._graph_on = graph
        if graph:
            capture_decode_graph(eng, warm_prompt)
        else:                                   # the same warm-up, uncaptured
            eng.put(1 << 30, warm_prompt)
            eng.step_many(1)
            eng.finish(1 << 30)
        out.append(eng)
    return out


def fleet_sched_run(S, eng, trace, counters, card, window: bool, fault=False) -> dict:
    """One scheduler over ``eng`` replaying ``trace`` on the fake clock at
    ``decode_quantum`` 8, every cache invariant checked after every tick;
    a profiled window of ``FLEET_WINDOW`` ticks once 10 ticks have run."""
    log_calls, finished = record_calls(eng)
    if fault:
        reemit_last_token(eng)
    clock = FakeClock()
    sched = S.ServingScheduler(eng, S.SchedulerConfig(decode_quantum=FLEET_K, clock=clock))
    blocked = count_blocked(sched)
    rp = Replay(sched.submit, sched.tick, lambda: sched.pending, trace, clock, FLEET_TICK_S,
                engines=[eng], every=(FLEET_PREEMPT_EVERY, lambda: preempt_least_urgent(sched)))
    pl = PathLaunches(counters, [eng])
    t0 = time.perf_counter()
    win = None
    if window:
        rp.run(until_ticks=10)
        win = checked_window("a: scheduler over the decode graph", [eng], counters,
                             lambda: [rp.step() for _ in range(FLEET_WINDOW)], card)
    rp.run()
    seconds = time.perf_counter() - t0
    return {"streams": [list(h.tokens) for h in rp.handles],
            "on_token": rp.streams, "stats": dict(sched.stats), "log": list(log_calls),
            "states": [h.state for h in rp.handles], "ticks": rp.ticks,
            "blocked_ticks": blocked["blocked_ticks"],
            "not_exactly_once": exactly_once(rp.handles, rp.streams, finished),
            "launches": pl.read(), "window": win, "seconds": seconds}


def fleet_part_a(S, params, cfg, seed, counters, card) -> dict:
    """Scheduler identity: the trace through one scheduler over the decode
    graph and over the eager decode (the graph's plain version), equal in
    streams, stats and decision log; then speculative decoding with fused
    verify on int8 pools through a scheduler at quantum 1, graph against
    eager; then the planted re-emit fault."""
    import torch

    vocab = cfg.vocab_size
    warm = np.random.RandomState(seed + 30).randint(0, vocab, 70).astype(np.int32)
    conf = {"prefix_cache": {"enabled": True}, "split_prefill_chunk": FLEET_CHUNK}
    graph, = fleet_engines(params, cfg, 1, warm, **conf)
    eager, = fleet_engines(params, cfg, 1, warm, graph=False, **conf)
    runs = {"graph": fleet_sched_run(S, graph, fleet_trace(S, vocab, seed), counters, card,
                                     window=True),
            "eager": fleet_sched_run(S, eager, fleet_trace(S, vocab, seed), counters, card,
                                     window=False)}
    g, e = runs["graph"], runs["eager"]
    s = g["stats"]
    trace = fleet_trace(S, vocab, seed)
    counts = {"requests": len(trace),
              "prompt_tokens": sum(len(r.prompt) for _, r in trace),
              "generated_tokens": sum(r.max_new_tokens for _, r in trace),
              "with_deadline": sum(r.deadline_ms != float("inf") for _, r in trace),
              "by_priority": [sum(r.priority == p for _, r in trace) for p in range(3)],
              "arrival_span_s": trace[-1][0], "blocked_ticks": g["blocked_ticks"],
              "preempted": s["preempted"], "resumed": s["resumed"],
              "chunked_admissions": s["chunked_admissions"],
              "split_resumes": sum(1 for c, k in g["log"] if c == "resume" and k[1]),
              "ticks": g["ticks"]}
    log(f"  trace: {counts['requests']} Poisson requests over {counts['arrival_span_s']:.2f} s, "
        f"{counts['prompt_tokens']} prompt and {counts['generated_tokens']} generated tokens, "
        f"{counts['with_deadline']} with a deadline, priorities {counts['by_priority']}; "
        f"pool {FLEET_BLOCKS - 1} blocks of 128")
    log(f"  a: {g['ticks']} ticks; admission held back in {counts['blocked_ticks']} ticks, "
        f"{counts['preempted']} preemptions, {counts['resumed']} resumes "
        f"({counts['split_resumes']} chunked), {counts['chunked_admissions']} chunked "
        f"admissions; graph run {g['seconds']:.1f} s, eager run {e['seconds']:.1f} s [{card}]")
    ident = {k: g[k] == e[k] for k in ("streams", "stats", "log", "states")}
    log(f"  a: graph == eager: {ident}; exactly once: graph {not g['not_exactly_once']}, "
        f"eager {not e['not_exactly_once']}")
    if not all(ident.values()) or g["not_exactly_once"] or e["not_exactly_once"]:
        raise AssertionError(f"scheduler over the graph against the eager decode: {ident}; "
                             f"not exactly once: {g['not_exactly_once']} / "
                             f"{e['not_exactly_once']}")
    if not (counts["blocked_ticks"] and counts["preempted"] and counts["resumed"]
            and counts["chunked_admissions"]):
        raise AssertionError(f"the trace did not press the pool as it must: {counts}")
    if set(g["states"]) != {"done"}:
        raise AssertionError(f"requests not done: {g['states']}")
    res = {"counts": counts, "identity": ident, "graph": g, "eager": e}

    # the planted fault: a resume re-emits its stream's last token
    sub = [(0.0, r) for _, r in fleet_trace(S, vocab, seed)[:16]]
    bad = fleet_sched_run(S, graph, sub, counters, card, window=False, fault=True)
    log(f"  a: planted fault (a resume re-emits the last token): {bad['stats']['resumed']} "
        f"resumes, streams not exactly once {bad['not_exactly_once']}")
    if not bad["stats"]["resumed"] or not bad["not_exactly_once"]:
        raise AssertionError("the re-emitting resume passed the exactly-once check "
                             f"({bad['stats']['resumed']} resumes)")
    res["fault"] = {"resumed": bad["stats"]["resumed"],
                    "not_exactly_once": bad["not_exactly_once"]}
    del graph, eager
    torch.cuda.empty_cache()

    # speculative decoding + fused verify on int8 pools, through the
    # scheduler at quantum 1: graph against eager
    prompts, _ = spec_prompts(seed, vocab)
    spec = {}
    for name, graph_on in (("graph", True), ("eager", False)):
        eng, = fleet_engines(params, cfg, 1, warm, graph=graph_on, blocks=129,
                             **SPEC, **INT8)
        log_calls, finished = record_calls(eng)
        sched = S.ServingScheduler(eng, S.SchedulerConfig(clock=FakeClock()))
        streams = [[] for _ in prompts]
        hs = [sched.submit(S.Request(prompt=p.tolist(), max_new_tokens=MAX_NEW_TOKENS),
                           on_token=streams[i].append) for i, p in enumerate(prompts)]
        pl = PathLaunches(counters, [eng])
        sched.tick()
        win = checked_window(f"a: spec + fused verify, int8 pools, {name}", [eng], counters,
                             lambda: [sched.tick() for _ in range(FLEET_WINDOW)], card) \
            if graph_on else None
        while sched.pending:
            sched.tick()
            eng.state.debug_check()
            eng.debug_check_cache()
        spec[name] = {"streams": [h.tokens for h in hs], "stats": dict(sched.stats),
                      "log": list(log_calls), "spec_stats": dict(eng.spec_stats),
                      "not_exactly_once": exactly_once(hs, streams, finished),
                      "launches": pl.read(), "window": win}
        del eng
        torch.cuda.empty_cache()
    sg, se = spec["graph"], spec["eager"]
    ident = {k: sg[k] == se[k] for k in ("streams", "stats", "log", "spec_stats")}
    log(f"  a: spec through the scheduler, graph == eager {ident}; verify steps "
        f"{sg['spec_stats']['fused_verify_steps']}, launches {sg['launches']}")
    if not all(ident.values()) or sg["not_exactly_once"] \
            or not sg["launches"]["paged_spec_verify_attention"]:
        raise AssertionError(f"spec through the scheduler: {ident}, {sg['launches']}, "
                             f"not exactly once {sg['not_exactly_once']}")
    res["spec"] = spec
    res["launches"] = add_launches(dict(g["launches"]), sg["launches"])
    return res


def fleet_part_b(S, params, cfg, seed, counters, card) -> dict:
    """The trace replayed in real time (the real clock, ``trace`` on):
    throughput, goodput, latency percentiles, the host time of a tick
    outside the engine's forwards; then a profiled window of a backlog's
    ticks (idle share, launches against the profiler) and bare
    ``step_many(8)`` on the batch it left."""
    import torch

    vocab = cfg.vocab_size
    warm = np.random.RandomState(seed + 30).randint(0, vocab, 70).astype(np.int32)
    eng, = fleet_engines(params, cfg, 1, warm, prefix_cache={"enabled": True},
                         split_prefill_chunk=FLEET_CHUNK,
                         trace={"enabled": True, "ring_size": 1 << 20,
                                "dump_on_crash": False})
    eng._lat = {k: [] for k in eng._lat}            # the warm-up's samples out
    sched = S.ServingScheduler(eng, S.SchedulerConfig(decode_quantum=FLEET_K))
    trace = fleet_trace(S, vocab, seed)
    pl = PathLaunches(counters, [eng])
    handles, ticks = [], []
    i = 0
    t0 = time.monotonic()
    while i < len(trace) or sched.pending:
        now = time.monotonic() - t0
        while i < len(trace) and trace[i][0] <= now:
            handles.append(sched.submit(trace[i][1]))
            i += 1
        if sched.pending:
            f0 = len(eng.forward_log)
            a = time.perf_counter()
            sched.tick()
            b = time.perf_counter()
            ticks.append((b - a, sum(f[1] for f in eng.forward_log[f0:])))
        else:
            time.sleep(max(0.0, min(trace[i][0] - now, 0.01)))
    wall = time.monotonic() - t0
    launches = pl.read()
    st = sched.stats
    lat = eng.latency_summary()
    qw = sched.queue_wait_summary()
    dl = [h for h in handles if h.request.deadline_ms != float("inf")]
    res = {"wall_s": wall, "ticks": len(ticks), "stats": dict(st),
           "generated_tokens_per_s": st["tokens_emitted"] / wall,
           "goodput_frac": st["slo_met"] / max(st["completed"], 1),
           "deadline_met": sum(bool(h.slo_met) for h in dl), "deadline_requests": len(dl),
           "goodput_rps": st["slo_met"] / wall,
           "latency_ms": lat, "queue_wait_ms": qw,
           "tick_ms_mean": sum(t for t, _ in ticks) / len(ticks) * 1e3,
           "host_ms_per_tick": sum(t - f for t, f in ticks) / len(ticks) * 1e3,
           "trace_events": len(eng.tracer)}
    if st["completed"] != len(trace) or any(h.state != "done" for h in handles):
        raise AssertionError(f"b: {st['completed']} of {len(trace)} requests completed")
    pct = lambda d: f"p50 {d['p50']:.1f} / p99 {d['p99']:.1f} ms"  # noqa: E731
    log(f"  b: real time, trace on: {wall:.2f} s, {len(ticks)} ticks, "
        f"{res['generated_tokens_per_s']:.1f} generated tokens/s, goodput "
        f"{res['goodput_frac']:.3f} of completions ({res['deadline_met']}/{len(dl)} deadlined "
        f"within {FLEET_DEADLINE_MS:.0f} ms) [{card}]")
    log(f"  b: TTFT {pct(lat['ttft_ms'])}, ITL {pct(lat['itl_ms'])}, engine queue "
        f"{pct(lat['queue_ms'])}, scheduler queue wait {pct(qw)}, e2e {pct(lat['e2e_ms'])}; "
        f"a tick {res['tick_ms_mean']:.2f} ms, of it {res['host_ms_per_tick']:.2f} ms host "
        f"outside the forwards [{card}]")

    # a backlog's ticks under the profiler, then bare step_many(8) on the
    # batch they leave (no split prefill pending: pure decode)
    pl = PathLaunches(counters, [eng])
    for _, r in fleet_trace(S, vocab, seed + 1)[:FLEET_SLOTS]:
        sched.submit(r)
    for _ in range(2):
        sched.tick()
    win = checked_window("b: scheduler ticks over a backlog", [eng], counters,
                         lambda: [sched.tick() for _ in range(FLEET_WINDOW)], card)
    for _ in range(64):
        if not eng._pending_prefill:
            break
        sched.tick()
    add_launches(launches, pl.read())                  # bare step_many uncounted
    # the batch the timing's 4 quanta fit in the pool: the longest go first
    while eng.state.growth_blocks_short(n=4 * FLEET_K) > 0:
        eng.finish(max(eng.state.seqs.values(), key=lambda d: d.seen_tokens).uid)
    live = [d for d in eng.state.seqs.values() if not d.prefilling]
    eng.step_many(FLEET_K)
    a = time.perf_counter()
    for _ in range(3):
        eng.step_many(FLEET_K)
    bare = (time.perf_counter() - a) * 1e3 / (3 * FLEET_K)
    res.update(window=win, idle_share=win["idle_share"], bare_step_many_ms=bare,
               bare_batch=len(live), window_tick_ms=win["wall_s"] * 1e3 / FLEET_WINDOW)
    log(f"  b: profiled backlog window idle {win['idle_share']:.1%}, "
        f"{res['window_tick_ms']:.1f} ms a tick; bare step_many(8) on its batch of "
        f"{len(live)}: {bare:.2f} ms a token [{card}]")
    for uid in list(eng.state.seqs):
        eng.finish(uid)
    res["launches"] = launches
    del eng
    torch.cuda.empty_cache()
    return res


def fleet_part_c(S, faults, params, cfg, seed, counters, card) -> dict:
    """Two replicas behind a router with ``fleet`` on: fault-free, then with
    replica 1 crashing after two healthy ticks. Every stream completes
    exactly once at full length; the tokens a stream had before the crash
    equal the fault-free run's, as do the whole streams of the requests
    the crash did not move; a moved stream's rest equals its history
    parked and resumed on a fresh engine (the same forward shapes: a
    re-prefill of a history need not agree bit for bit with the decode
    that wrote it)."""
    import torch

    vocab = cfg.vocab_size
    warm = np.random.RandomState(seed + 30).randint(0, vocab, 70).astype(np.int32)
    engines = fleet_engines(params, cfg, 3, warm, blocks=257)
    oracle = engines.pop()
    clock = FakeClock()

    def router():
        scheds = [S.ServingScheduler(e, S.SchedulerConfig(decode_quantum=FLEET_K, clock=clock))
                  for e in engines]
        return S.ReplicaRouter(scheds, S.RouterConfig(fleet=S.FleetConfig(
            enabled=True, failure_threshold=1, probe_backoff_ticks=10000, degrade=False,
            clock=clock))), scheds

    def requests():
        return [r for _, r in fleet_trace(S, vocab, seed)[:FLEET_C_REQUESTS]]

    pl = PathLaunches(counters, engines)
    runs = {}
    for name in ("fault_free", "crash"):
        rt, scheds = router()
        streams = [[] for _ in range(FLEET_C_REQUESTS)]
        hs = [rt.submit(r, on_token=streams[k].append) for k, r in enumerate(requests())]
        snap = {}
        orig = rt.fail_over

        def fail_over(idx, reason="replica fault", _orig=orig, _hs=hs, _snap=snap):
            _snap.update(tokens=[list(h.tokens) for h in _hs],
                         moved=[k for k, h in enumerate(_hs) if h.replica == idx and not h.done])
            return _orig(idx, reason=reason)
        rt.fail_over = fail_over
        crash = contextlib.nullcontext({"crashes": 0}) if name == "fault_free" else \
            faults.replica_crash(scheds[1], after_ticks=FLEET_C_CRASH_AFTER)
        steps = 0
        with crash as cs:
            while rt.pending:
                clock.advance(FLEET_TICK_S)
                rt.step()
                steps += 1
                for e in engines:
                    e.state.debug_check()
        runs[name] = {"tokens": [list(h.tokens) for h in hs], "streams": streams,
                      "states": [h.state for h in hs], "replicas": [h.replica for h in hs],
                      "fleet_stats": dict(rt.fleet_stats), "stats": dict(rt.stats),
                      "crashes": cs["crashes"], "snap": snap, "steps": steps,
                      "max_new": [h.request.max_new_tokens for h in hs],
                      "prompts": [list(h.request.prompt) for h in hs]}
    ff, cr = runs["fault_free"], runs["crash"]
    launches = pl.read()
    moved, snap = cr["snap"].get("moved", []), cr["snap"].get("tokens", [])
    checks = {
        "all_done": set(ff["states"]) == set(cr["states"]) == {"done"},
        "full_length": all(len(t) == n for t, n in zip(cr["tokens"], cr["max_new"])),
        "exactly_once": cr["streams"] == cr["tokens"] and ff["streams"] == ff["tokens"],
        "failed_over": cr["fleet_stats"]["failovers"] >= 1 and bool(moved),
        "faults_injected_only": (ff["fleet_stats"]["tick_faults"] == 0
                                 and cr["fleet_stats"]["tick_faults"] == cr["crashes"] >= 1),
        "before_crash": all(s == f[:len(s)] for s, f in zip(snap, ff["tokens"])),
        "unmoved": all(cr["tokens"][k] == ff["tokens"][k]
                       for k in range(FLEET_C_REQUESTS) if k not in moved),
    }
    # the oracle of a moved stream's rest: its history parked and resumed
    # on a fresh engine (one prefill each, as on the survivor), decoded in
    # quanta of 8 (a decode row does not depend on the others)
    uids = {5000 + k: k for k in moved}
    for uid, k in uids.items():
        oracle.resume({"uid": uid, "history": cr["prompts"][k] + snap[k],
                       "generated": list(snap[k]), "prompt_len": len(cr["prompts"][k]),
                       "sp": S.Request(prompt=[0]).sp})
    while any(len(oracle.state.seqs[u].generated) < cr["max_new"][k] for u, k in uids.items()):
        oracle.step_many(FLEET_K)
    rest = [oracle.finish(u)[:cr["max_new"][k]] == cr["tokens"][k] for u, k in uids.items()]
    checks["moved_rest"] = all(rest) and bool(rest)
    differs = sum(cr["tokens"][k] != ff["tokens"][k] for k in moved)
    log(f"  c: crash after {FLEET_C_CRASH_AFTER} healthy ticks of replica 1: "
        f"{cr['fleet_stats']['failovers']} failover(s), {len(moved)} streams moved "
        f"({differs} of them differ from the fault-free run after the crash), replayed "
        f"{cr['fleet_stats']['replayed_tokens']} tokens; fleet stats {cr['fleet_stats']}")
    log(f"  c: checks {checks} (before the crash: the fault-free run; unmoved streams: the "
        f"fault-free run; a moved stream's rest: its history resumed on a fresh engine)")
    if not all(checks.values()):
        raise AssertionError(f"router failover: {checks}")
    # a window of router steps over 4 of the requests, after their prefills
    rt, _ = router()
    pl = PathLaunches(counters, engines)
    for r in requests()[:4]:
        rt.submit(r)
    rt.step()
    win = checked_window("c: router steps, fleet on", engines, counters,
                         lambda: [rt.step() for _ in range(FLEET_WINDOW)], card)
    rt.run()
    res = {"checks": checks, "moved": moved, "moved_differ": differs,
           "fleet_stats": cr["fleet_stats"], "router_stats": cr["stats"],
           "steps": {n: r["steps"] for n, r in runs.items()}, "window": win,
           "launches": add_launches(launches, pl.read())}
    del engines, oracle
    torch.cuda.empty_cache()
    return res


def fleet_part_d(S, params, cfg, seed, counters, card) -> dict:
    """One prefill and one decode replica, ``native`` wire, on bf16 pools and
    on int8 pools: each request served alone through the router equals a
    hand-driven pair of engines doing what the replicas do (prefill and one
    quantum, park → ``export_kv_blocks`` → ``import_kv_blocks`` → resume,
    then quanta); prompts sharing 1024 tokens ship only their novel
    blocks."""
    import torch

    vocab = cfg.vocab_size
    warm = np.random.RandomState(seed + 30).randint(0, vocab, 70).astype(np.int32)
    rs = np.random.RandomState(seed + 31)
    shared = rs.randint(0, vocab, FLEET_D_SHARED).tolist()
    base = fleet_trace(S, vocab, seed)

    def requests():
        reqs = [r for _, r in base[:2]]
        reqs += [S.Request(prompt=shared + r.prompt[:n], max_new_tokens=r.max_new_tokens)
                 for (_, r), n in zip(base[2:5], (40, 90, 130))]
        for r in reqs:
            r.max_new_tokens = min(r.max_new_tokens, FLEET_D_GEN)
            r.deadline_ms = float("inf")
        return reqs

    res = {}
    launches = {}
    for pool, extra in (("bf16", {}), ("int8", INT8)):
        engines = fleet_engines(params, cfg, 4, warm, blocks=129,
                                prefix_cache={"enabled": True}, **extra)
        (p_eng, d_eng), (po, do) = engines[:2], engines[2:]
        scheds = [S.ServingScheduler(e, S.SchedulerConfig(decode_quantum=FLEET_K))
                  for e in (p_eng, d_eng)]
        rt = S.ReplicaRouter(scheds, S.RouterConfig(disagg=S.DisaggConfig(
            enabled=True, num_prefill=1, wire="native")))
        pl = PathLaunches(counters, [p_eng, d_eng])
        got, dedup = [], []
        for r in requests():
            d0 = rt.disagg_stats["dedup_blocks"]
            h = rt.submit(r)
            rt.run()
            got.append(list(h.tokens))
            dedup.append(rt.disagg_stats["dedup_blocks"] - d0)
            for e in (p_eng, d_eng):
                e.state.debug_check()
                e.debug_check_cache()
        add_launches(launches, pl.read())          # before the oracle's forwards
        want = []
        for k, r in enumerate(requests()):
            uid = 7000 + k
            toks = [po.put(uid, r.prompt)] + po.step_many(FLEET_K)[uid]
            hashes = po.kv_chain_hashes(uid)
            exp = po.export_kv_blocks(uid, skip=do.resident_prefix(hashes), wire="native")
            parked = po.park(uid)
            do.import_kv_blocks(exp["hashes"], exp["blocks"])
            toks += do.resume(parked)
            while len(toks) < r.max_new_tokens:
                toks += do.step_many(FLEET_K)[uid]
            do.finish(uid)
            want.append(toks[:r.max_new_tokens])
        st = dict(rt.disagg_stats)
        checks = {"streams": got == want, "handoffs": st["handoffs"] == len(got),
                  "dedup": all(n > 0 for n in dedup[3:]) and st["dedup_blocks"] > 0,
                  "import_failures": st["import_failures"] == 0,
                  "no_faults": rt.fleet_stats["tick_faults"] == 0}
        log(f"  d ({pool} pools): streams == park → export → import → resume {checks['streams']}; "
            f"{st['handoffs']} handoffs, {st['blocks_shipped']} blocks shipped, dedup blocks "
            f"by request {dedup}; wire {st['wire_bytes'] / 1e6:.2f} MB against "
            f"{st['bf16_equiv_bytes'] / 1e6:.2f} MB bf16-equivalent "
            f"({st['wire_bytes'] / st['bf16_equiv_bytes']:.4f}); checks {checks}")
        if not all(checks.values()):
            raise AssertionError(f"disagg on {pool} pools: {checks}, {st}")
        extra = requests()[1].prompt

        def serve_one():
            rt.submit(S.Request(prompt=list(extra), max_new_tokens=16))
            rt.run()
        win = checked_window(f"d: disagg router ({pool} pools)", [p_eng, d_eng], counters,
                             serve_one, card)
        add_launches(launches, win["launches_total"])
        res[pool] = {"checks": checks, "disagg_stats": st, "dedup_by_request": dedup,
                     "window": win}
        del engines, p_eng, d_eng, po, do, scheds, rt
        torch.cuda.empty_cache()
    res["launches"] = launches
    return res


def phase_serving_fleet(seed: int, card: str) -> dict:
    """The serving fleet at Llama-3-8B's full width and depth, every engine
    on one set of bf16 weights from the seed, at ``CORE_CTX`` with 16 slots
    and blocks of 128: (a) scheduler identity, graph against eager, and the
    planted re-emit fault; (b) the trace in real time with tracing on;
    (c) router failover; (d) disaggregated prefill / decode. Launches of
    RMSNorm, paged decode (bf16, int8) and spec verify counted over the
    parts' runs, and equal to the profiler's records in a window of each
    part; no tick, export or import fault the phase did not inject."""
    import torch

    from deepspeed_tpu_torch.inference import serving as S
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_int8_cuda,
        paged_spec_verify_attention_cuda)
    from deepspeed_tpu_torch.testing import faults

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), max_seq_len=CORE_CTX)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    counters = {"rms_norm": rms_norm_cuda, "paged_decode_attention": paged_decode_attention_cuda,
                "paged_decode_attention_int8": paged_decode_attention_int8_cuda,
                "paged_spec_verify_attention": paged_spec_verify_attention_cuda}
    res = {"num_layers": cfg.num_layers}
    t0 = time.perf_counter()
    res["a"] = fleet_part_a(S, params, cfg, seed, counters, card)
    res["a"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["b"] = fleet_part_b(S, params, cfg, seed, counters, card)
    res["b"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["c"] = fleet_part_c(S, faults, params, cfg, seed, counters, card)
    res["c"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["d"] = fleet_part_d(S, params, cfg, seed, counters, card)
    res["d"]["seconds"] = time.perf_counter() - t0
    total = {}
    for part in "abcd":
        add_launches(total, res[part]["launches"])
    res["launches"] = total
    del params
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  serving fleet phase {res['seconds']:.1f} s (a {res['a']['seconds']:.1f}, "
        f"b {res['b']['seconds']:.1f}, c {res['c']['seconds']:.1f}, "
        f"d {res['d']['seconds']:.1f}); launches {total} [{card}]")
    return res


def main_step_inputs(prompt_lengths, generated: int, extra: int = 1, shape=None):
    """(context lengths, block tables) of a serving step over 64 slots: the
    first len(prompt_lengths) slots hold prompt_len + generated cached
    tokens in fresh blocks covering ``extra`` more positions; the rest are
    inactive (ctx 0 on the trash block). ``shape``: ``ROWS_SHAPE`` unless
    given."""
    S = shape or ROWS_SHAPE
    B, max_blocks, bs = S["B"], S["max_blocks"], S["bs"]
    ctx_np = np.zeros(B, np.int32)
    tables_np = np.zeros((B, max_blocks), np.int32)
    next_blk = 1
    for i, n in enumerate(prompt_lengths):
        ctx_np[i] = n + generated
        need = (int(ctx_np[i]) + extra + bs - 1) // bs
        tables_np[i, :need] = np.arange(next_blk, next_blk + need)
        next_blk += need
    return ctx_np, tables_np


# --------------------------------------------------------------------------- #
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--details", metavar="PATH",
                    help="also write every measurement as JSON to PATH")
    args = ap.parse_args()

    if not (REPO / "deepspeed_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)

    log("== phase 1: device")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python {sys.version.split()[0]}")

    log("== phase 2: build")
    from deepspeed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"  built {[s.name for s in _build.sources()]} in {build_s:.1f} s")

    log("== phase 3: kernels against their plain versions")
    kern, decode_case = phase_kernels(SEED, card)
    kern["flash"] = phase_flash(SEED, card)
    kern["rows"], rows_case = phase_rows_kernels(SEED, card)
    kern["paged_sm90"] = phase_paged_sm90(SEED, card)
    kern.update(phase_ln_quant_kernels(SEED, card))
    kern["opt_shapes"] = phase_opt_shapes(SEED, card)
    kern["flash_bias"] = phase_bias_kernels(SEED, card)
    kern["sparse"] = phase_sparse_kernels(SEED, card)

    log("== phase 4: main path (Llama-3-8B shapes through generate)")
    main_res = phase_main_path(SEED, MAX_NEW_TOKENS, card)

    # the paged-decode inputs of the main path's last decode step: the 8
    # prompts' slots at prompt_len + max_new_tokens - 2 cached tokens, the
    # other 56 slots inactive (ctx 0 on the trash block)
    main_case = decode_case(*main_step_inputs(main_res["prompt_lengths"],
                                              main_res["max_new_tokens"] - 2),
                            "main-path last step")
    kern["paged_decode"]["cases"]["main_path"] = main_case

    log("== phase 5: speculative serving (Llama-3-8B through generate; fused verify on "
        "bf16 and int8 pools, and int8 pools alone)")
    spec = phase_spec_serving(SEED, MAX_NEW_TOKENS, card)
    # the new kernels' inputs late in that run: the 8 slots at
    # prompt_len + max_new_tokens - t (verify, t = k + 1 rows) or - 2
    # (int8 decode) cached tokens, the other 56 inactive
    spec_lengths = spec["spec_int8"]["prompt_lengths"]
    ver_ctx, ver_tables = main_step_inputs(spec_lengths,
                                           MAX_NEW_TOKENS - SPEC_K - 1, extra=SPEC_K + 1)
    dec_ctx, dec_tables = main_step_inputs(spec_lengths, MAX_NEW_TOKENS - 2)
    kern["rows"]["timing"]["verify_bf16_main_path"] = rows_case(
        "verify", 0, ver_ctx, ver_tables, "paged_spec_verify bf16 main-path step")
    kern["rows"]["timing"]["verify_int8_main_path"] = rows_case(
        "verify", 1, ver_ctx, ver_tables, "paged_spec_verify int8 main-path step")
    kern["rows"]["timing"]["decode_int8_main_path"] = rows_case(
        "decode", 1, dec_ctx, dec_tables, "paged_decode int8 main-path step")

    log("== phase 6: whole path on the card against the plain path on the CPU")
    whole = phase_whole_path(SEED, card)
    whole_spec = phase_whole_path_spec(SEED, card)

    log("== phase 7: training main path (Llama-3-8B width, 4 layers, through train_batch)")
    train = phase_train(SEED, card)

    log("== phase 8: whole training step on the card against the plain path on the CPU")
    train_whole = phase_train_whole(SEED, card)

    from deepspeed_tpu_torch.models import gpt

    opt_cfg = dataclasses.replace(gpt.GPTConfig.opt_1_3b(), activation="relu")
    log("== phase 9: OPT-1.3B serving (24 layers through generate; bf16 pools, then "
        "speculative + fused verify on int8 pools)")
    rs = np.random.RandomState(SEED + 10)
    opt_prompts = [rs.randint(0, opt_cfg.vocab_size, n).astype(np.int32)
                   for n in (1, 17, 64, 100, 129, 333, 700, 1900)]
    opt_serve = phase_spec_serving(
        SEED, MAX_NEW_TOKENS, card, family=gpt, cfg=opt_cfg, norm="layer_norm",
        engines=(("bf16", {}, opt_prompts),
                 ("spec_int8", {**SPEC, **INT8}, spec_prompts(SEED, opt_cfg.vocab_size)[0])))

    # the OPT engines' last steps: bf16 decode and int8 fused verify
    opt_paged = opt_paged_times(
        SEED, card,
        main_step_inputs(opt_serve["bf16"]["prompt_lengths"], MAX_NEW_TOKENS - 2,
                         shape=OPT_ROWS_SHAPE),
        main_step_inputs(opt_serve["spec_int8"]["prompt_lengths"],
                         MAX_NEW_TOKENS - SPEC_K - 1, extra=SPEC_K + 1, shape=OPT_ROWS_SHAPE))
    kern["opt_paged"] = opt_paged

    log("== phase 10: OPT-1.3B training (24 layers through train_batch)")
    opt_train = phase_train(SEED, card, family=gpt, cfg=opt_cfg, label="OPT-1.3B",
                            seq=2048, gas=2, micro=OPT_MICRO, norm="layer_norm")

    log("== phase 11: OPT-1.3B width, whole paths on the card against the plain paths "
        "on the CPU")
    opt_whole = phase_whole_path(SEED, card, family=gpt, cfg=opt_cfg, label="OPT-1.3B-width")
    opt_train_whole = {
        act: phase_train_whole(
            SEED, card, family=gpt, cfg=dataclasses.replace(opt_cfg, activation=act),
            label=f"OPT-1.3B-width ({act})", fault=fault_zero_ln_db, grad_tol=tol)
        for act, tol in (("relu", TRAIN_GRAD_RTOL_RELU), ("gelu", TRAIN_GRAD_RTOL))}

    log("== phase 12: inference module system (weight-only int8 linear, LayerNorm slot)")
    mods = phase_modules(SEED, card)

    from deepspeed_tpu_torch.models import bloom

    bloom_cfg = dataclasses.replace(bloom.BloomConfig.bloom_7b1(), num_layers=4)
    log("== phase 13: BLOOM-7b1 width training (4 layers through train_batch, ALiBi through "
        "the flash kernels' bias mode)")
    bloom_train = phase_train(SEED, card, family=bloom, cfg=bloom_cfg, label="BLOOM-7b1",
                              seq=BLOOM_S, gas=2, micro=BLOOM_MICRO, norm="layer_norm",
                              bias_mode=True, norms_per_layer_extra=2)

    log("== phase 14: BLOOM-7b1 width, whole training step on the card against the plain "
        "path on the CPU")
    bloom_whole = phase_train_whole(SEED, card, family=bloom, cfg=bloom.BloomConfig.bloom_7b1(),
                                    label="BLOOM-7b1-width",
                                    fault=(fault_zero_alibi, fault_zero_ln_db),
                                    against=TRAIN_GRAD_AGAINST_BLOOM,
                                    leaf_tol=TRAIN_LEAF_TOL_BLOOM)

    log("== phase 15: attention entry points under autograd (msa_row_attention, "
        "blocksparse_attention)")
    entry = phase_entry_points(SEED, card)

    log("== phase 16: serving core (Llama-3-8B, 32 layers: step_many as one CUDA graph, "
        "prefix cache, split prefill, fork, park / resume, KV handoff)")
    core = phase_serving_core(SEED, card)

    log("== phase 17: serving fleet (Llama-3-8B, 32 layers: continuous-batching scheduler, "
        "router failover, disaggregated prefill / decode)")
    fleet = phase_serving_fleet(SEED, card)
    fleet_l = fleet["launches"]

    rms = kern["rms_norm"]["rows"][64]        # decode: 64 slots x d = 4096
    # the serving paths decode through their graphs: each path's launches are
    # its wrappers' (eager forwards) plus the graph's kernel nodes x replays
    core_graph = core["graph_launches"]
    rms_launches = {"serving": main_res["launches"]["rms_norm"],
                    "training": train["launches"]["rms_norm"],
                    "serving core (graph)": core_graph["rms_norm"],
                    "serving fleet": fleet_l["rms_norm"]}
    opt_l = {name: opt_serve[name]["launches"] for name in ("bf16", "spec_int8")}
    decode_launches = {"llama serving": main_res["launches"]["paged_decode_attention"],
                       "opt serving": opt_l["bf16"]["paged_decode_attention"],
                       "serving core (graph)": core_graph["paged_decode_attention"],
                       "serving fleet": fleet_l["paged_decode_attention"]}
    flash = kern["flash"]
    flash_err = {k: max([c["max_abs_err"][k] for c in flash["cases"].values()]
                        + [p["max_abs_err"][k] for p in (flash["pieces"], flash["opt"])
                           if k in p["max_abs_err"]])
                 for k in ("o", "dq", "dk", "dv")}
    kernels = [
        {"name": "rms_norm", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/rms_norm.cu",
         "replaces": "deepspeed_tpu/ops/pallas/norms.py:27",
         "launches": sum(rms_launches.values()), "launches_by_path": rms_launches,
         "max_abs_err": kern["rms_norm"]["max_abs_err"],
         "ms": rms["ms"], "plain_ms": rms["plain_ms"], "bound_ms": rms["bound_ms"],
         "bound_by": "bytes", "library_ms": rms["library_ms"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/paged_sm90.cu",
         "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:74",
         "launches": sum(decode_launches.values()), "launches_by_path": decode_launches,
         "max_abs_err": kern["paged_decode"]["max_abs_err"],
         "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
         "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         # the same kernel at OPT-1.3B's main-path step
         "opt": {k_: opt_paged["decode_bf16_main_path"][k_]
                 for k_ in ("ms", "plain_ms", "bound_ms")}},
    ]
    for key, name, line, err in (
            ("fwd", "flash_fwd", "deepspeed_tpu/ops/pallas/flash_attention.py:284",
             flash_err["o"]),
            ("dq", "flash_bwd_dq", "deepspeed_tpu/ops/pallas/flash_attention.py:448",
             flash_err["dq"]),
            ("dkv", "flash_bwd_dkv", "deepspeed_tpu/ops/pallas/flash_attention.py:523",
             max(flash_err["dk"], flash_err["dv"]))):
        r = flash["timing"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/ops/csrc/"
                      + ("flash_fwd_sm90.cu" if key == "fwd" else "flash_bwd_sm90.cu"),
            "replaces": line,
            "launches": train["launches"][name] + opt_train["launches"][name],
            "launches_by_path": {"llama training": train["launches"][name],
                                 "opt training": opt_train["launches"][name]},
            "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # the same kernel at OPT-1.3B's training shape
            "opt": {k_: flash["opt"]["timing"][key][k_] for k_ in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    rows_t = kern["rows"]["timing"]
    dec8, ver8, ver16 = (rows_t["decode_int8_main_path"], rows_t["verify_int8_main_path"],
                         rows_t["verify_bf16_main_path"])
    int8_launches = {p: spec[p]["launches"]["paged_decode_attention_int8"]
                     for p in ("spec_int8", "int8")}
    int8_launches["opt spec_int8"] = opt_l["spec_int8"]["paged_decode_attention_int8"]
    int8_launches["serving fleet"] = fleet_l["paged_decode_attention_int8"]
    ver_launches = {p: spec[p]["launches"]["paged_spec_verify_attention"]
                    for p in ("spec_bf16", "spec_int8")}
    ver_launches["opt spec_int8"] = opt_l["spec_int8"]["paged_spec_verify_attention"]
    ver_launches["serving core (shared and forked blocks)"] = (
        core["spec"]["launches"]["paged_spec_verify_attention"]
        + core["spec"]["fork_launches"]["paged_spec_verify_attention"])
    ver_launches["serving fleet"] = fleet_l["paged_spec_verify_attention"]
    ln = kern["layer_norm"]["rows"][64]       # decode: 64 slots x d = 2048
    ln_launches = {"opt serving": opt_l["bf16"]["layer_norm"],
                   "opt spec_int8": opt_l["spec_int8"]["layer_norm"],
                   "opt training": opt_train["launches"]["layer_norm"],
                   "module system": mods["launches"]["layer_norm"]}
    qt = kern["quantize"]["timing"]

    def quant_entry(key):
        return {"ms": qt[key]["ms"], "plain_ms": qt[key]["plain_ms"],
                "bound_ms": qt[key]["bound_ms"], "bound_by": "bytes"}

    kernels += [
        {"name": "paged_decode_attention_int8", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/paged_sm90.cu",
         "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:74",
         "launches": sum(int8_launches.values()), "launches_by_path": int8_launches,
         "max_abs_err": kern["rows"]["decode_int8"]["max_abs_err"],
         "ms": dec8["ms"], "plain_ms": dec8["plain_ms"], "bound_ms": dec8["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "paged_spec_verify_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/paged_sm90.cu",
         "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:315",
         "launches": sum(ver_launches.values()), "launches_by_path": ver_launches,
         "max_abs_err": kern["rows"]["verify"]["max_abs_err"],
         "ms": ver8["ms"], "plain_ms": ver8["plain_ms"], "bound_ms": ver8["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "bf16": {"ms": ver16["ms"], "plain_ms": ver16["plain_ms"],
                  "bound_ms": ver16["bound_ms"]},
         "opt": {k_: opt_paged["verify_int8_main_path"][k_]
                 for k_ in ("ms", "plain_ms", "bound_ms")}},
    ]
    kernels += [
        {"name": "layer_norm", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/layer_norm.cu",
         "replaces": "deepspeed_tpu/ops/pallas/norms.py:87",
         "launches": sum(ln_launches.values()), "launches_by_path": ln_launches,
         "max_abs_err": kern["layer_norm"]["max_abs_err"],
         "ms": ln["ms"], "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
         "bound_by": "bytes", "library_ms": ln["library_ms"]},
        {"name": "quantize_int8", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/quantize.cu",
         "replaces": "deepspeed_tpu/ops/pallas/quantize.py:30",
         "launches": mods["launches"]["quantize_int8"],
         "max_abs_err": kern["quantize"]["max_abs_err"],
         **quant_entry("quantize_g128_bfloat16"), "library_ms": None,
         # other dtypes and group 2048 at OPT's w_up, and the cold Llama-3-8B shape
         "cases": {k_: quant_entry(k_) for k_ in qt if "quantize_" in k_ and "dequant" not in k_}},
        {"name": "dequantize_int8", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/quantize.cu",
         "replaces": "deepspeed_tpu/ops/pallas/quantize.py:39",
         "launches": mods["launches"]["dequantize_int8"],
         "max_abs_err": kern["quantize"]["dequantize_max_abs_err"],
         **quant_entry("dequantize_g128_bfloat16"),
         "library_ms": qt["dequantize_g128_bfloat16"]["library_ms"],
         "cases": {k_: quant_entry(k_) for k_ in qt if "dequantize_" in k_}},
    ]
    kernels += bias_sparse_entries(kern, bloom_train, entry)
    detail = {"card": card, "kind": kind, "build_s": build_s, "kernels": kern,
              "bloom_train": bloom_train, "bloom_train_whole_path": bloom_whole,
              "entry_points": entry,
              "opt_serving": opt_serve, "opt_train": opt_train, "opt_whole_path": opt_whole,
              "opt_train_whole_path": opt_train_whole, "modules": mods,
              "main_path": main_res, "spec_serving": spec, "whole_path": whole,
              "whole_path_spec": whole_spec, "train": train,
              "train_whole_path": train_whole, "serving_core": core, "serving_fleet": fleet,
              "total_s": time.perf_counter() - t_all}
    if args.details:
        path = Path(args.details)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(detail, indent=1, default=str))
    log(f"  total {detail['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
