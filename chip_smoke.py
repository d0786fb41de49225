#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py   # Llama-3-8B, OPT-1.3B, BLOOM-7b1, EXAONE-4.0-32B, Mixtral-8x7B,
                            # Falcon-7B, GPT-NeoX-20B, GPT-J-6B, BERT-base, CLIP ViT-B/32,
                            # MSA shapes; an HF directory read without transformers

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
   ZeRO 0, batch 2 as 2 micro-batches of one 4096-token sequence;
   ``TRAIN_STEPS`` (4) ``train_batch`` steps on one fixed batch. Launch counters are zeroed
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
14. BLOOM-7b1 width at 1 layer, S = ``BLOOM_CHECK_SEQ`` (128, cut from
   256 for the CPU's time): phase 8's check, with ``bk``
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
17. The serving fleet at Llama-3-8B's full width and ``FLEET_LAYERS`` (4)
   of its 32 layers (cut from 32 for the smoke's time)
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
18. Data-parallel training with ZeRO (``phase_zero``): a real NCCL process
   group of world size 1 (``comm.init_distributed()``) and
   ``comm.init_mesh({"data": 1})``, then phase 7's configuration (Llama-3-8B
   width at 4 layers, bf16, GAS 2 of one 4096-token sequence,
   ``TRAIN_STEPS`` steps) at ZeRO stages 0, 1, 2 and 3, one engine at a
   time. With a process group every stage shards over ``data`` (one shard)
   and runs its collectives through NCCL: stage 1 all-gathers each leaf's
   bf16 copy a micro-batch, stages 2 and 3 also reduce-scatter each fp32
   grad, stage 3 gathers a block's leaves when the forward enters it. Each
   stage's losses and grad norms must equal stage 0's (whether bit for bit
   is printed; otherwise within ``TRAIN_LOSS_RTOL``), its kernel launches
   phase 7's, its loss fall; ``zero.Init`` at that width must equal the
   unsharded init bit for bit; a planted fault (the reduce-scatter of every
   [4096 x 4096] grad dropped, stage 2) must fail the check. Prints step
   ms, peak GiB, the idle share of a profiled step and the collectives a
   step (count and bytes by op, from ``comm.counts``) for each stage.
19. Training checkpoints (``phase_checkpoint``): first the machine under
   ``build/`` (free disk, an fsync'd write and a warm read of 2 GiB, free
   host RAM; too little disk for the phase's three tags fails it), then
   phase 18's widths at ``CKPT_LAYERS`` layer(s) with the head tied to the
   embedding (``CKPT_TIED``: one 128256 x 4096 table, as Llama-3.2's
   checkpoints tie it; a tag of 8.92 GB instead of 15.23) at ZeRO-3 over a
   real NCCL group of world size 1. (a) ``CKPT_STEPS`` steps, a regular
   (``default`` engine) and a universal tag, ``CKPT_STEPS`` more steps: the
   uninterrupted run. (b) An engine drawn from another seed loads the
   regular tag and (c) another the universal tag: the state at the load,
   the losses and grad norms of the same steps and the masters and moments
   after them must equal (a)'s bit for bit, the flash forward / dQ / dK-dV
   and RMSNorm launches phase 18's counts a step, the steady step ms within
   ``CKPT_STEP_TOL`` of (a)'s, and the peak device memory during a load at
   most its level before plus the largest leaf. (d) The async engine saves,
   a ``train_batch`` runs before the write is durable, ``commit``; the tag
   loads back to the state at the save bit for bit. (e) Planted faults: the
   async tag's state file truncated (``faults.corrupt_file``) — the load
   walks back to the regular tag, and with that gone the truncated tag
   named explicitly raises ``RuntimeError``; one bit of one ``nu`` element
   flipped after a load — the continuation differs. Prints GB written,
   save s and GB/s, manifest (sha256) s, load s, async blocking against
   durable s, device GiB before, at peak and after each load, and step ms
   before and after the resume. The phase removes its directory at its end.
20. Activation checkpointing and the tiled loss head (``phase_remat``):
   phase 7's configuration under each of ``REMAT_POLICIES`` (``none``,
   ``full``, ``save_attn_out``, ``save_big_matmuls``, ``offload``; the
   family's ``remat``), ``REMAT_STEPS`` steps each from the same weights:
   losses and grad norms equal to ``none``'s (printed: bit for bit, else
   within ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_RTOL``), launches a step of
   ``remat_launches`` (a recomputed block launches its flash forward and
   its two RMSNorms again: flash forward 16, dQ and dK/dV 8, RMSNorm 34 a
   step under the recomputing policies; 8 / 8 / 8 / 18 under ``none`` and
   ``offload``), peak GiB and step ms; one micro-batch's grads under
   ``full`` equal to ``none``'s, and a recompute that rotates q at positions
   shifted by one (planted) must move them beyond ``TRAIN_GRAD_RTOL``;
   ``saved_bytes`` of one block at S 4096 in the order none >=
   save_big_matmuls >= save_attn_out >= full = 0. Then one sequence of the
   first of ``REMAT_LONG_SEQS`` whose step fits without remat (16384 first,
   ``max_seq_len`` raised to it) under ``none``, ``full`` and ``full`` +
   ``sequence.tiled_loss`` (``TILED_SHARDS`` tiles): peak GiB, step ms and
   launches of each, the tiled loss within ``TRAIN_LOSS_RTOL`` of the dense
   one, the tiled head's cost in ms.
21. ``init_inference`` (``phase_init_inference``): Llama-3-8B at 32 layers,
   bf16 weights from the seed, through the v1 engine's dense KV cache: 8
   prompts (``V1_LENGTHS``) x 32 greedy tokens, one row ending early on EOS;
   RMSNorm 65 launches a forward; the prefill logits and every generated
   token (its gap below the no-cache forward's argmax) held against the
   fp32 forward of the same weights at ``V1_NOISE_RATIO`` times the bf16
   flash path's own error there; a cache write one slot late (planted) must
   fail the token check; prefill and decode-step ms, peak GiB; the first
   step where each row's stream leaves the v2 engine's (printed). Then the
   weights at rest as int8, packed int4 and fp8: weight bytes against bf16's
   16.06 GB, peak GiB and step ms; logits equal bit for bit to a bf16 engine
   over the same weights dequantized once (one row's scale of
   ``layers.0.wq`` doubled, planted, must break it); at ``QUANT_DEPTH``
   layers the logits against bf16 weights within ``QUANT_VS_BF16_TOL``
   (``tests/test_torch_quant_limits.py``'s CPU simulation). Where a row's v1
   and v2 streams part, its top-two logit gap in v1, in v2 (the decode
   graph's output) and in the fp32 forward, over the row's RMS, and the fp32
   margin between the two tokens against the bf16 error (``v1_v2_parting``:
   beyond it one side is wrong, within it a near-tie). Then BLOOM-7b1 (30
   layers) with int8 weights (``bloom_v1_peak``): v1 ``forward``'s peak above
   the weights when ``apply`` reads a block's leaves at the block against
   every leaf dequantized first; the logits equal, the peak lower.
22. The optimizer set (``phase_optimizers``) at phase 7's configuration:
   the multi-tensor AdamW (phase 7's run) against its per-leaf loop
   (``loop_adamw``): losses equal or within ``TRAIN_LOSS_RTOL``, step ms,
   elementwise ms of a profiled step, peak at most the loop's plus one
   ``CHUNK_BYTES``; each of ``OPTIMIZER_CASES`` (AdamW, AdamW with a
   no-decay group, Lion, LAMB, Adagrad, SGD with Nesterov momentum, Muon,
   1-bit Adam, 1-bit LAMB, 0/1 Adam; the 1-bit ones past their warmup from
   step 2) for ``OPT_STEPS`` steps, the update of step ``OPT_CHECK_STEP``
   held leaf by leaf to the same update computed in float64 on the card from
   the same params, grads and state (``reference_update``, the JAX update
   per JAX leaf; snapshots in a pinned host arena) within ``OPT_CHECK_TOL``
   relative Frobenius; planted faults (the card's beta1 0.8 in LAMB, Muon's
   scale in the port's ``[out, in]`` orientation) must fail it; LAMB and
   Muon at ZeRO stages 0-3 over NCCL at world size 1, each stage's losses,
   grad norms and params bit for bit stage 0's. Flash and RMSNorm launches
   a step as phase 7's.
23. EXAONE-4.0-32B (``phase_exaone4``; published widths: hidden 5120, MLP
   27392, 40 / 8 heads of 128, vocab 102400, window 4096 on the LLL of each
   LLLG period, untied head; plain RoPE at theta 1e6, since neither package
   implements its llama3 ``rope_scaling``; random bf16 weights from the
   seed). (a) Training at 4 layers (LLLG, 2.98 B parameters): bf16, AdamW
   with the no-decay group, GAS 2 of one 2048-token sequence,
   ``EXA_TRAIN_STEPS`` steps; RMSNorm 17 launches a forward, no flash kernel
   (the hybrid attention is masked, so plain, as in the JAX package); the
   loss finite and falling. (b) Phase 8's card-vs-CPU check at those 4
   layers (S ``EXA_CHECK_SEQ``, 128, cut from 256); RoPE on the global
   layers (planted) must fail it. (c)
   Serving at ``EXA_SERVE_LAYERS`` (4) of the 64 layers (one LLLG
   period, shared by every engine; cut from 64 to 16, 8 and 4 for the
   smoke's time):
   8 prompts (``EXA_LENGTHS``: two of 5120 tokens, so that decodes read past
   the 4096 window, split into 512-token prefill chunks) x 32 greedy tokens
   through v2 on bf16 pools (the decode graph) and with speculative
   decoding + fused verify on int8 pools (self-repeating prompts), launches
   held to the engines' step counts (RMSNorm 257 a forward; 64 paged
   decodes a step, every one ``paged_sm90.cu`` with its layer's window);
   then v1 (each 5120-token prompt alone, the rest together), and how many
   rows v1 and v2 agree on. (d) At 4 layers: v1's prefill logits on a
   5120-token prompt, and every token of v1, v2 and v2 spec + int8 against
   the fp32 forward of the same weights, within ``V1_NOISE_RATIO`` times the
   bf16 forward's own error; a late cache write (planted) must fail it.
24. Mixtral-8x7B (``phase_mixtral``; ``MixtralConfig()``'s widths: vocab
   32000, hidden 4096, 8 experts of 14336, top 2, 32 / 8 heads of 128;
   random bf16 weights from the seed). (a) Training at ``MIX_TRAIN_LAYERS``
   (2) layers (3.17 B parameters) through phase 7's ``phase_train``: bf16,
   AdamW, GAS 2 of one 4096-token sequence, 4 steps, the einsum dispatch at
   capacity factor 1.25; RMSNorm 5 a forward, the three flash kernels one a
   layer a micro-batch; ``lm_loss`` and ``aux_loss`` printed. (b) Phase 8's
   card-vs-CPU step at those 2 layers (S 128, for the CPU's time), the CPU
   routing each (token, level) to the expert the card chose (bf16 router
   logits flip near-ties, and a flipped route moves its token's whole
   gradient: without it the step read 0.21-0.43 a leaf on the H100), with
   the share the CPU's own gating would have chosen otherwise printed; the
   card's gates left unrenormalized (planted) must fail it. (c) Serving at
   ``MIX_SERVE_LAYERS`` (4) of the 32 layers (11.8 GB of weights; 32
   layers' 93 GB fit no card; cut from 16 to 8 and 4 for the smoke's time), shared by
   every engine: the 8 self-repeating prompts x 32 greedy tokens through v2
   on bf16 pools (the decode graph), with speculative decoding + fused
   verify, and on int8 pools; RMSNorm 17 a forward, 8 paged launches a replay; the decode step
   against its weight-bytes bound (every expert is read: the no-drop
   routing gives every slot a place); then v1, and where each row's v1 and
   v2 streams part, ``v1_v2_parting``'s fp32 margin. (d) The einsum and
   compact dispatches of one layer at (c)'s prefill burst (no-drop: C = T)
   within ``DISPATCH_TOL``, each one's ms and the combine tensor's bytes;
   then at ``MIX_CHECK_LAYERS`` (2) every token of v1, v2 and v2 spec + int8
   (v2 on its eager decode, the graph's plain version) against the fp32
   forward at ``V1_NOISE_RATIO`` x the bf16 forward's error, the fp32
   forward routing each position as the engine's forwards did
   (``v1_routes`` / ``v2_routes``: without it a route flipped on a near-tie
   read 4.3 row RMS on the H100, above any fault); the gates left
   unrenormalized must fail it. The serving depth's bf16 error behind the
   parting rule is measured with the
   same routes (``routed_noise``).
25. Falcon-7B (``FalconConfig()``: 71 query heads over ONE kv head, hd 64,
   the parallel block, the tied head) and GPT-NeoX-20B (``GPTNeoXConfig()``:
   64 heads of 96, partial rotary over 24 dims, biases, two LayerNorms)
   (``phase_falcon_neox``). The kernels first (``p25_kernels``): the flash
   forward, dQ and dK/dV at hd 96 (GPT-NeoX-20B's 64/64 heads, S 2048 causal
   and S 1000 under a window of 256; bf16 and fp32) against their plain
   pieces within ``FLASH_TOL``, the bf16 kernels' five planted faults
   failing at hd 96, the flash backward at Falcon-7B's 71 over 1 heads (S
   2048), LayerNorm at [4096 x 4544] and [4096 x 6144]; each timed beside
   its bound, the plain version and SDPA / ``F.layer_norm`` (SDPA at the MQA
   shape with ``enable_gqa``, or K/V widened by ``repeat_interleave`` where
   PyTorch lacks it: the log says which). Then for each family (a) training
   at ``P25_TRAIN_LAYERS`` (4) of 32 / 44 layers, GAS 2 of one 2048-token
   sequence, ``P25_TRAIN_STEPS`` (3) steps, the flash and LayerNorm launches
   asserted (Falcon: one LayerNorm a block and a final one); (b) one step
   card (bf16) against CPU (fp32) at ``P25_CHECK_LAYERS`` (2) layers, S 128,
   at the training limits, dV of kv head 0 and LayerNorm's db zeroed each
   failing it. (c) Falcon-7B serving at all 32 layers (13.8 GB) on one set
   of weights: v2 on bf16 pools and v2 spec + fused verify on int8 pools (32
   paged launches a decode replay), the decode step against its weight-bytes
   bound, v1 (33 LayerNorms a forward) and the v1 / v2 partings; (d) at 2
   layers every token of v1, v2 and v2 spec + int8 within ``V1_NOISE_RATIO``
   x the bf16 forward's own error from fp32, a late cache write planted and
   failing. GPT-NeoX-20B v1 at all 44 layers (41.1 GB): prefill, 8 prompts x
   32 greedy tokens and the decode step, no flash launch (v1's reads are
   masked); its 2-layer tokens against fp32, rotary on pairs planted.
   GPT-J-6B (``gptj_6b``, hd 256) v1 at ``GPTJ_LAYERS`` (4) of 28: no flash
   launch, its tokens against the dense-cache fp32 forward (plain
   attention: no flash kernel takes hd 256), rotary on halves planted.
26. fp16 on the card (``phase_fp16``): the fp16 instantiations of the
   flash forward, dQ and dK/dV against their plain pieces in fp16 within
   ``FP16_PIECES_TOL`` at Llama-3-8B's S 4096 causal 32/8 hd 128, under a
   window of 1024 and at q_offset 3584, at OPT-1.3B's hd 64 and
   GPT-NeoX-20B's hd 96, and the ALiBi bias mode at BLOOM-7b1's shape; the
   forward's two, the backward's three and the bias mode's fourth planted
   faults failing; a planted overflow (dO near fp16's top) giving inf / nan
   in the same grad elements as the plain version; the Llama-3-8B and
   BLOOM cases timed beside their bound, the plain pieces and SDPA in fp16
   (``enable_gqa`` at GQA, a float mask with ALiBi). The paged kernel in fp16 at the Llama serving shape:
   decode and verify over fp16 pools and int8 pools (ng 1 and 4), two calls
   bit-identical, its three planted faults and a wrong table entry failing,
   timed at the serving prompts' step. Op ``attention`` with ALiBi under
   autograd in fp16 (the bias kernels' path). Training under DeepSpeed's
   fp16 block (``FP16_BLOCK``): phase 7's Llama-3-8B width at 4 layers
   through ``train_batch`` (the loss scale printed after each step); a
   2-layer step card (fp16) against CPU (fp32) within ``FP16_LOSS_RTOL`` /
   ``FP16_GRAD_RTOL`` (``tests/test_torch_fp16_limits.py``), dV of kv head 0
   zeroed failing; an overflow drill from 2^32 on a narrow 2-layer Llama,
   card against CPU (skipped steps leave every param and optimizer tensor
   bit for bit, the scale sequences equal to within one step of where each
   stops skipping); ZeRO-3 equal to stage 0 bit for bit at 2 layers over an
   NCCL group of world size 1. Serving Llama-3-8B at 32 layers (16 GB of
   fp16 weights): v2 graph decode on fp16 pools, on int8 pools and under
   spec + fused verify (launches held to the engine's step counts), the
   decode step against its weight-bytes bound; v1 in fp16 (its no-cache
   forward on the fp16 flash kernel), v1 against v2 equal on half the rows
   or more with every parting a near-tie; at 2 layers every token of v1 and
   the three v2 engines within ``V1_NOISE_RATIO`` x the fp16 forward's own
   error from fp32, a late cache write planted and failing.
27. The HF importer, BERT and CLIP (``phase_hf``). The flash forward, dQ
   and dK/dV at BERT-base's attention (8 x 512, 12 heads of 64,
   non-causal) and CLIP ViT-B/32's (32 x 50, 12 heads, non-causal; 32 x 77,
   8 heads, causal), bf16 and fp16, against their plain pieces, the
   forward's last kv tile dropped and the backward's faults 2 and 3
   failing; timed at BERT-base's shape beside the bound, the plain pieces
   and SDPA. LayerNorm at 512 and 768 wide (CLIP's text rows, BERT-base's
   [4096 x 768] timed beside ``F.layer_norm``; a left-out bias failing) and
   at 64 rows (the warp kernel's planted fault failing). (a) The smoke
   writes a local HF directory itself (``write_hf_llama_dir``: no
   ``transformers`` on the card; ``config.json``, two safetensors shards
   and their index) of Llama-3-8B's widths at ``HF_LAYERS`` (2) layers,
   random bf16 weights from the seed; ``build_hf_engine`` reads it
   (``models/hf_import.py``, no ``transformers``) into v2 engines, graph
   decode plain and with speculative fused verify (launches held to the
   engine's step counts), and ``init_inference(checkpoint=)`` into v1,
   whose weights must equal the ones written; every token of the three
   within ``V1_NOISE_RATIO`` x the bf16 forward's own error from fp32, a
   late cache write planted and failing. (b) ``initialize(model=...)`` on
   the reader's stand-in of a ``transformers`` model (``HFCheckpoint``:
   ``config`` and ``state_dict()``): ``P27_STEPS`` (4) steps of 2 x 4096
   tokens, launches held to the path's; one step on the card against the
   CPU (S ``HF_CHECK_SEQ``), dV of kv head 0 zeroed failing. (c) BERT-base
   (``BertConfig()``, all 12 layers) MLM training, 8 x 512 without a mask
   (flash non-causal, LayerNorm at 768, the embedding LayerNorm in fp32),
   4 steps; masked forwards running plain attention (no flash launch; the
   tokens behind the mask leave the unmasked rows bit for bit; logits
   within ``V1_NOISE_RATIO`` x the unmasked forward's error from fp32); a
   step at 2 layers card against CPU, dV zeroed and LayerNorm's db zeroed
   failing. (d) CLIP ViT-B/32 (``CLIPConfig()``) contrastive training at
   32 pairs, 4 steps (the vision tower non-causal at S 50, the text tower
   causal at S 77); a step at 2 layers a tower card against CPU, in fp32 on
   both sides (the fp32 flash and LayerNorm kernels; a bf16 InfoNCE head
   rounds the leaves beside it by ~20%) within ``FP32_LOSS_RTOL`` /
   ``FP32_GRAD_RTOL``, the K biases (zero in exact arithmetic) against their
   Q biases' norms, the same two faults failing.

The last three lines: ``{"profile_sessions": {...}}`` (the sessions each
checked profiler window of phases 16 and 17 took), ``{"kernels": [...]}``
(one entry per kernel: launches on the main paths, times, bound, max
error) and ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. ``--details PATH`` also writes every measurement as JSON
to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import os
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
TRAIN_STEPS = 4            # cut from 6 for the smoke's time
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
# tokens of BLOOM's card-vs-CPU step (phase 14; cut from 256 for the CPU's
# time): at S 128 the CPU simulation of tests/test_torch_bloom.py's limits
# reads final_ln_bias 0.024-0.029 and ALiBi zeroed 0.78-0.81
BLOOM_CHECK_SEQ = 128
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
                       norm: str = "rms_norm", engines=None, params=None,
                       norms_per_layer: int = 2, base_conf=None, warm=None, build=None):
    """A model at full width and depth through ``generate`` in several
    engines in turn, each ``(name, extra config, prompts)``; launch counts
    held to the engine's own step counts. By default Llama-3-8B with
    speculative decoding and fused verification on bf16 pools, the same on
    int8 pools, and int8 pools alone (whose every step is an int8 decode),
    all on self-repeating prompts. ``norm`` names the family's norm op (one
    launch per norm, ``norms_per_layer`` per layer and a final one).
    ``params``: the bf16 weights (drawn from the seed when None, and then
    freed at the end); ``base_conf``: the engines' config before each one's
    extra; ``warm``: the warm-up and profiled prompts (by default the
    first, second and fifth); ``build``: the engine from its config (by
    default ``build_engine_v2`` over ``params``)."""
    import torch

    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, rms_norm_cuda
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_int8_cuda,
        paged_spec_verify_attention_cuda)

    family = family or llama
    cfg = cfg or llama.LlamaConfig.llama3_8b()
    own = params is None and build is None
    if own:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = family.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    if base_conf is None:
        base_conf = {"dtype": "bfloat16", "prefill_bucket": 64,
                     "ragged": {"max_tracked_sequences": 64, "max_ragged_batch_size": 64,
                                "memory_config_blocks": 512, "block_size": 128}}
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
        conf = dict(base_conf, **extra)
        eng = build(conf) if build else build_engine_v2(family, cfg, params, config=conf)
        torch.cuda.synchronize()
        pool_bytes = sum(x.numel() * x.element_size() for x in eng.cache.values())
        log(f"  {name}: pools {sorted(eng.cache)} {pool_bytes/1e9:.3f} GB, "
            f"set-up {time.perf_counter()-t0:.1f} s")
        w = warm or (prompts[0], prompts[1], prompts[4])
        eng.generate([w[0], w[2]], max_new_tokens=4)   # warm-up
        per_replay = capture_decode_graph(eng, w[1])
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
                 for k in ("prefill", "prefill_chunk", "decode", "verify")}
        n_fwd = sum(len(v) for v in kinds.values())
        quant, spec_on = "kv_quant" in extra, "speculative" in extra
        decode_key = "paged_decode_attention_int8" if quant else "paged_decode_attention"
        other_key = "paged_decode_attention" if quant else "paged_decode_attention_int8"
        want = {norm: (norms_per_layer * cfg.num_layers + 1) * n_fwd, other_norm: 0,
                decode_key: cfg.num_layers * len(kinds["decode"]), other_key: 0,
                "paged_spec_verify_attention": cfg.num_layers * len(kinds["verify"])}
        log(f"  {name}: forwards {len(kinds['prefill'])} prefill + "
            f"{len(kinds['prefill_chunk'])} prefill chunks + {len(kinds['verify'])} "
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
             "generated_tokens_per_s": len(prompts) * max_new_tokens / (t_end - t_start),
             "outs": outs}
        if kinds["prefill_chunk"]:
            # the split prompts' first token comes with their last chunk
            r["ttft_split_ms"] = (kinds["prefill_chunk"][-1][3] - t_start) * 1e3
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
        prof_prompts = list(w) if warm else prompts
        uids = list(range(1000, 1000 + len(prof_prompts)))
        eng.put_many(list(zip(uids, prof_prompts)))
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
    if own:
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


def flash_work(sq, skv, hkv, causal, q_offset, window, b=1, hd=HD, h=H) -> dict:
    """Visible (q, k) pairs of the case and, per kernel, the operations its
    products need (2 * hd per pair and product: forward QK^T and PV; dQ
    three products; dK/dV four) and the bytes it must move (each input
    read once, each output written once; bf16 tensors, fp32 lse/delta)."""
    from deepspeed_tpu_torch.ops.flash_attention import _visible

    pairs = int(_visible(sq, skv, causal, q_offset, window, "cpu").sum()) * b * h
    q_bytes = b * sq * h * hd * 2
    kv_bytes = b * skv * hkv * hd * 2
    row_bytes = b * h * sq * 4
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
    causal = kw.get("causal", True)
    gqa, gqa_form = {}, None
    if kt.shape[1] != qt.shape[1]:
        try:     # the yardstick's own GQA option (PyTorch >= 2.5); else widened K/V
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
            gqa, gqa_form = {"enable_gqa": True}, "enable_gqa"
        except TypeError:
            kt, vt = (x.repeat_interleave(qt.shape[1] // kt.shape[1], dim=1) for x in (kt, vt))
            gqa_form = "repeat_interleave"

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)

    def sdpa_fwd_bwd():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, is_causal=causal, **gqa).backward(dot)

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
                     "flops": w["flops"], "bytes": w["bytes"], "sdpa_gqa": gqa_form}
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


def _train_config(seed: int, gas: int, bf16: bool, micro: int = 1, fp16=None) -> dict:
    """The smoke's training config; ``fp16`` (a DeepSpeed ``fp16`` block)
    replaces bf16 with it."""
    return {"train_batch_size": gas * micro, "gradient_accumulation_steps": gas,
            "bf16": {"enabled": bf16 and not fp16}, "fp16": fp16 or {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 0},
            "seed": seed, "steps_per_print": 0}


def train_flops(cfg, seq: int, sequences: int) -> float:
    """Model FLOPs of one training step: 6 per matmul parameter per token,
    and 3x the forward attention products (QK^T, PV) over causal pairs."""
    h, i, v, hd = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.head_size
    if hasattr(cfg, "parallel_attn"):    # Falcon: MQA / GQA projections, two-matrix MLP
        per_layer = h * cfg.num_heads * hd * 2 + 2 * h * cfg.num_kv_heads * hd + 2 * h * i
    elif hasattr(cfg, "num_experts"):    # Mixtral: GQA, top_k of the SwiGLU experts, router
        per_layer = h * cfg.num_heads * hd * 2 + 2 * h * cfg.num_kv_heads * hd + \
            cfg.top_k * 3 * h * i + h * cfg.num_experts
    elif hasattr(cfg, "num_kv_heads"):   # Llama: GQA projections, gated MLP
        per_layer = h * cfg.num_heads * hd * 2 + 2 * h * cfg.num_kv_heads * hd + 3 * h * i
    else:                                # GPT-2/OPT, GPT-NeoX: MHA, two-matrix MLP
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
    ("nccl", ("nccl",)),
    ("copy_cast", ("copy_kernel", "direct_copy")),
    ("foreach", ("multi_tensor_apply_kernel",)),     # torch._foreach_* (the optimizers)
    ("elementwise", ("elementwise_kernel",)),
]


def phase_train(seed: int, card: str, family=None, cfg=None, label="Llama-3-8B",
                seq: int = 4096, gas: int = 2, micro: int = 1, norm: str = "rms_norm",
                bias_mode: bool = False, norms_per_layer_extra: int = 1,
                norms_per_layer: int = 2, steps: int = TRAIN_STEPS, fp16=None):
    """``initialize(model=family.model_spec(cfg))`` and ``steps`` steps of
    ``train_batch`` on one fixed batch of ``gas`` micro-batches of ``micro``
    sequences; by default Llama-3-8B width at 4 layers. ``norm`` names the
    family's norm op, launched ``norms_per_layer`` per layer plus
    ``norms_per_layer_extra`` per forward; ``bias_mode``: attention runs the
    flash kernels' bias mode (ALiBi), and the no-bias flash kernels must not
    launch. ``fp16``: a DeepSpeed ``fp16`` block, the model computing in
    fp16 under its dynamic loss scale (each step's scale and overflow
    kept)."""
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
    spec = (family.model_spec(cfg, compute_dtype=torch.float16) if fp16
            else family.model_spec(cfg))
    eng, *_ = dst.initialize(model=spec, config=_train_config(seed, gas, True, micro, fp16))
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
    losses, step_s, metrics, scales = [], [], {}, []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = eng.train_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out.loss))
        scales.append((float(out.loss_scale), bool(out.overflow)))
        for m in ("lm_loss", "aux_loss"):       # a MoE family's two parts of the loss
            if m in out.aux:
                metrics.setdefault(m, []).append(float(out.aux[m]))
    launches = {**{k: c.launches for k, c in flash.items()},
                **{k: c.launches for k, c in norms.items()}}
    peak = torch.cuda.max_memory_allocated()
    per_step = cfg.num_layers * gas
    want = {k: (per_step * steps if k.endswith("_bias") == bias_mode else 0)
            for k in flash}
    want.update({norm: (norms_per_layer * cfg.num_layers + norms_per_layer_extra) * gas * steps,
                 other_norm: 0})
    log(f"  losses {['%.4f' % l for l in losses]}; launches {launches}, expected {want}")
    if fp16:
        log("  loss scale after each step (overflow): "
            + ", ".join(f"{sc:g} ({'skipped' if o else 'applied'})" for sc, o in scales))
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
           "micro": micro, "n_params": n_params, "metrics": metrics, "loss_scales": scales}
    if metrics:
        log("  " + ", ".join(f"{m} {['%.4f' % x for x in v]}" for m, v in metrics.items()))
    res["mfu"] = res["model_tflops"] * 1e12 / BF16_FLOPS
    log(f"  step {step_ms:.1f} ms (steps 2-{steps}; first {step_s[0]*1e3:.1f} ms), "
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


ZERO_STAGES = (0, 1, 2, 3)
ZERO_FAULT_STEPS = 2


@contextlib.contextmanager
def fault_drop_reduce_scatter(shape=(4096, 4096)):
    """The reduce-scatter of every grad of ``shape`` (wq and wo at
    Llama-3-8B width) gives zeros: those leaves never learn."""
    from deepspeed_tpu_torch.comm import comm

    sound = comm.reduce_scatter

    def faulty(x, *a, **kw):
        out = sound(x, *a, **kw)
        return out.zero_() if tuple(x.shape) == shape else out

    comm.reduce_scatter = faulty
    try:
        yield
    finally:
        comm.reduce_scatter = sound


def zero_train(seed: int, cfg, stage: int, batch, steps: int, counters=None, fp16=None):
    """``steps`` of ``train_batch`` at ZeRO ``stage`` over the installed
    mesh: (losses, grad norms, step seconds, collectives by op a step,
    (bytes allocated before the engine, peak bytes), the engine). ``fp16``:
    a DeepSpeed ``fp16`` block, the model computing in fp16."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import llama

    conf = _train_config(seed, 2, True, fp16=fp16)
    conf["zero_optimization"] = {"stage": stage}
    gc.collect()                  # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    spec = llama.model_spec(cfg, compute_dtype=torch.float16) if fp16 else llama.model_spec(cfg)
    eng, *_ = dst.initialize(model=spec, config=conf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters or ():
        c.launches = 0
    comm.counts.reset()
    losses, norms, step_s = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = eng.train_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out.loss))
        norms.append(float(out.grad_norm))
    coll = {op: {k: v / steps for k, v in rec.items()} for op, rec in comm.counts.snapshot().items()}
    return losses, norms, step_s, coll, (before, torch.cuda.max_memory_allocated()), eng


def phase_zero(seed: int, card: str) -> dict:
    """Phase 7's training at ZeRO stages 0-3 through a real NCCL process
    group of world size 1, held to stage 0 (see the module docstring)."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                         flash_bwd_dq_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=4)
    comm.init_distributed()
    try:
        mm = comm.init_mesh({"data": 1})
        log(f"  process group: {dist.get_backend()}, world size {dist.get_world_size()}, "
            f"mesh {mm.sizes}")
        rs = np.random.RandomState(seed)
        batch = {"tokens": rs.randint(0, cfg.vocab_size, (2, 4096 + 1)).astype(np.int32)}
        kernels = {"flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
                   "flash_bwd_dkv": flash_bwd_dkv_cuda, "rms_norm": rms_norm_cuda}
        per_step = cfg.num_layers * 2
        want = {k: (2 * cfg.num_layers + 1) * 2 * TRAIN_STEPS if k == "rms_norm"
                else per_step * TRAIN_STEPS for k in kernels}
        res, base = {}, None
        for stage in ZERO_STAGES:
            losses, norms, step_s, coll, (before, peak), eng = zero_train(
                seed, cfg, stage, batch, TRAIN_STEPS, kernels.values())
            launches = {k: c.launches for k, c in kernels.items()}
            if launches != want:
                raise AssertionError(f"ZeRO-{stage}: kernel launches {launches} != {want}")
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"ZeRO-{stage}: loss not finite and falling: {losses}")
            wall, busy, n_k, top = profile_window(lambda: eng.train_batch(batch))
            nccl_ms = sum(ms for k, ms, _ in top if "nccl" in k)
            steady = step_s[1:]
            r = {"losses": losses, "grad_norms": norms, "step_s": step_s,
                 "step_ms": sum(steady) / len(steady) * 1e3, "peak_bytes": peak,
                 "allocated_before_bytes": before,
                 "collectives_per_step": coll, "launches": launches,
                 "sharded_leaves": len(eng._sharded), "leaves": len(eng.state.params),
                 "profile": {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3,
                             "idle_share": 1 - busy / wall, "kernels": n_k, "nccl_ms": nccl_ms}}
            if base is None:
                base = r
            else:
                r["bitwise_equal_stage0"] = losses == base["losses"] and norms == base["grad_norms"]
                err = max(max(abs(a - b) / abs(b) for a, b in zip(losses, base["losses"])),
                          max(abs(a - b) / abs(b) for a, b in zip(norms, base["grad_norms"])))
                r["max_rel_err_stage0"] = err
                if err > TRAIN_LOSS_RTOL:
                    raise AssertionError(f"ZeRO-{stage} against ZeRO-0: losses {losses} / "
                                         f"{base['losses']}, grad norms {norms} / "
                                         f"{base['grad_norms']} (rel {err:.3g} > "
                                         f"{TRAIN_LOSS_RTOL})")
            log(f"  ZeRO-{stage}: losses {['%.4f' % l for l in losses]}, step "
                f"{r['step_ms']:.1f} ms, peak {peak / 2**30:.2f} GiB ({before / 2**30:.2f} "
                f"allocated before the engine), idle "
                f"{r['profile']['idle_share']:.1%} (nccl {nccl_ms:.2f} ms of "
                f"{busy * 1e3:.1f} busy), {r['sharded_leaves']}/{r['leaves']} leaves "
                f"sharded" + ("" if stage == 0 else
                              f", equal to ZeRO-0 bit for bit: {r['bitwise_equal_stage0']} "
                              f"(max rel {r['max_rel_err_stage0']:.3g})") + f" [{card}]")
            log("    collectives a step: " + ", ".join(
                f"{op} {rec['count']:g} x, {rec['bytes'] / 2**20:.1f} MiB"
                for op, rec in coll.items()))
            res[stage] = r
            del eng
            torch.cuda.empty_cache()

        # planted fault: the grads of every [4096 x 4096] leaf dropped
        with fault_drop_reduce_scatter():
            f_losses, f_norms, *_, eng = zero_train(seed, cfg, 2, batch, ZERO_FAULT_STEPS)
        del eng
        torch.cuda.empty_cache()
        f_err = max(abs(a - b) / abs(b) for a, b in
                    zip(f_losses + f_norms, base["losses"][:ZERO_FAULT_STEPS]
                        + base["grad_norms"][:ZERO_FAULT_STEPS]))
        log(f"  planted fault (reduce-scatter of [4096 x 4096] grads dropped, ZeRO-2): "
            f"rel err {f_err:.3g} against {TRAIN_LOSS_RTOL}")
        if f_err <= TRAIN_LOSS_RTOL:
            raise AssertionError("the dropped reduce-scatter passed the ZeRO check")

        # zero.Init at that width: the shards gathered equal the unsharded init
        gen = lambda: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
        shards = dst.zero.materialize_sharded(
            lambda g, **kw: llama.init(cfg, g, **kw), gen(), llama.param_logical_axes(cfg),
            mesh_mgr=mm)
        full = llama.init(cfg, gen())
        same = all(torch.equal(shards[k], full[k]) for k in full)
        del shards, full
        torch.cuda.empty_cache()
        log(f"  zero.Init at Llama-3-8B width (4 layers) equal to the unsharded init: {same}")
        if not same:
            raise AssertionError("zero.Init differs from the unsharded init")
    finally:
        comm.set_mesh(None)
        dist.destroy_process_group()
    return {"stages": res, "fault_rel_err": f_err, "zero_init_equal": same,
            "launches": {k: sum(r["launches"][k] for r in res.values()) for k in kernels},
            "phase_s": time.perf_counter() - t_phase}


CKPT_LAYERS = 1            # Llama-3-8B width at 1 layer (PERF.md section 4: the depth and why)
CKPT_TIED = True           # the head tied to the embedding: the tag's bytes, and the phase's
                           # seconds, cut by 41% (to pay for phase 27; PERF.md section 6, PR 25)
CKPT_STEPS = 3             # steps before the save, and after each resume
CKPT_TIMED = 4             # more steps timed after each resume (steady ms: the median)
CKPT_STEP_TOL = 0.03       # a resumed step's ms against the step before the save
CKPT_DIR = REPO / "build" / "ckpt_smoke"


def machine_io(root: Path, probe_gib: int = 2) -> dict:
    """Free disk under ``root``, a write (fsync'd) and a read of a
    ``probe_gib`` GiB file there, and the host's free RAM. The read comes
    from the page cache the write filled: a warm read."""
    import shutil

    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free
    block = np.random.default_rng(0).integers(0, 255, 64 << 20, dtype=np.uint8).tobytes()
    probe = root / "io_probe.bin"
    t0 = time.perf_counter()
    with open(probe, "wb") as f:
        for _ in range(probe_gib * 16):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(probe, "rb") as f:
        while f.read(64 << 20):
            pass
    read_s = time.perf_counter() - t0
    probe.unlink()
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            mem[k] = int(v.split()[0]) * 1024
    gib = probe_gib * 2**30
    return {"free_disk_bytes": free, "write_gb_s": gib / write_s / 1e9,
            "read_warm_gb_s": gib / read_s / 1e9, "ram_available_bytes": mem["MemAvailable"],
            "ram_total_bytes": mem["MemTotal"]}


def state_digests(eng) -> dict:
    """The int64 sum of each master's and moment's bits (as int32): equal
    for equal states, changed by any one flipped bit."""
    import torch

    st = eng.state
    out = {}
    for group, tensors in (("params", st.params), ("mu", st.opt_state.mu),
                           ("nu", st.opt_state.nu)):
        for k, t in tensors.items():
            out[f"{group}/{k}"] = int(t.detach().view(torch.int32).sum(dtype=torch.int64))
    return out


@contextlib.contextmanager
def timed_calls(module, name: str, into: list):
    """Record the seconds of each call of ``module.name``."""
    sound = getattr(module, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return sound(*a, **kw)
        finally:
            into.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield into
    finally:
        setattr(module, name, sound)


def phase_checkpoint(seed: int, card: str, layers: int = CKPT_LAYERS) -> dict:
    """Training checkpoints at Llama-3-8B width through a real NCCL group of
    world size 1 at ZeRO stage 3 (see the module docstring)."""
    import shutil

    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                         flash_bwd_dq_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda
    from deepspeed_tpu_torch.runtime.checkpoint import saver as saver_mod
    from deepspeed_tpu_torch.runtime.checkpoint import universal as universal_mod
    from deepspeed_tpu_torch.testing import faults

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=layers,
                              tie_embeddings=CKPT_TIED)
    io = machine_io(CKPT_DIR)
    state_bytes = cfg.num_params * 12            # fp32 masters, mu, nu
    need = 3 * state_bytes + (8 << 30)           # regular, universal, async tags
    log(f"  machine: {io['free_disk_bytes'] / 1e9:.1f} GB free under build/, write "
        f"{io['write_gb_s']:.2f} GB/s (fsync'd), read {io['read_warm_gb_s']:.2f} GB/s "
        f"(warm), host RAM {io['ram_available_bytes'] / 2**30:.1f} of "
        f"{io['ram_total_bytes'] / 2**30:.1f} GiB available; a tag of {layers} layer(s) "
        f"{state_bytes / 1e9:.2f} GB, the phase needs {need / 1e9:.1f} GB [{card}]")
    if io["free_disk_bytes"] < need:
        raise RuntimeError(f"phase 19 needs {need / 1e9:.1f} GB of disk under {CKPT_DIR}, "
                           f"{io['free_disk_bytes'] / 1e9:.1f} GB free")
    reg, uni = str(CKPT_DIR / "regular"), str(CKPT_DIR / "universal")
    kernels = {"flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda, "rms_norm": rms_norm_cuda}
    # phase 18's counts a step (2 micro-batches)
    per_step = {k: (2 * layers + 1) * 2 if k == "rms_norm" else layers * 2 for k in kernels}
    rs = np.random.RandomState(seed + 19)
    batches = [{"tokens": rs.randint(0, cfg.vocab_size, (2, 4096 + 1)).astype(np.int32)}
               for _ in range(2 * CKPT_STEPS + 1)]
    largest = max(int(np.prod(s)) for s, _ in llama.param_shapes(cfg).values()) * 4
    res = {"layers": layers, "params": cfg.num_params, "machine": io,
           "largest_leaf_bytes": largest}

    def engine(seed_, ckpt_engine="default"):
        conf = _train_config(seed_, 2, True)
        conf["zero_optimization"] = {"stage": 3}
        conf["checkpoint"] = {"engine": ckpt_engine}
        gc.collect()
        torch.cuda.empty_cache()
        return dst.initialize(model=llama.model_spec(cfg), config=conf)[0]

    def steps(eng, bs, count=False):
        for c in kernels.values():
            c.launches = 0
        out, step_s = [], []
        for b in bs:
            t0 = time.perf_counter()
            o = eng.train_batch(b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            out.append((float(o.loss), float(o.grad_norm)))
        launches = {k: c.launches for k, c in kernels.items()}
        want = {k: n * len(bs) for k, n in per_step.items()}
        if count and launches != want:
            raise AssertionError(f"kernel launches {launches} != {want}")
        return out, step_s, launches

    def load(eng, fn, *a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        path, _ = fn(*a, **kw)
        torch.cuda.synchronize()
        r = {"path": path, "load_s": time.perf_counter() - t0,
             "before_gib": before / 2**30, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "after_gib": torch.cuda.memory_allocated() / 2**30}
        if r["peak_gib"] * 2**30 > before + largest:
            raise AssertionError(f"peak device memory during the load {r['peak_gib']:.2f} GiB > "
                                 f"{before / 2**30:.2f} before + the largest leaf "
                                 f"{largest / 2**30:.2f}")
        return r

    def same(what, got, want):
        if got != want:
            raise AssertionError(f"{what}: the resumed run differs from the uninterrupted one")

    comm.init_distributed()
    try:
        comm.init_mesh({"data": 1})
        # (a) the uninterrupted run, both tags at step CKPT_STEPS
        eng = engine(seed)
        head, head_s, _ = steps(eng, batches[:CKPT_STEPS])
        manifests = []
        with timed_calls(saver_mod, "write_manifest", manifests):
            t0 = time.perf_counter()
            eng.save_checkpoint(reg, tag="s3")
            save_reg_s = time.perf_counter() - t0
        with timed_calls(universal_mod, "write_manifest", manifests):
            t0 = time.perf_counter()
            eng.save_universal_checkpoint(uni, tag="u3")
            save_uni_s = time.perf_counter() - t0
        at_save = state_digests(eng)
        ref, ref_s, _ = steps(eng, batches[CKPT_STEPS:2 * CKPT_STEPS], count=True)
        ref_digests = state_digests(eng)
        del eng
        tag_bytes = {name: sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                               os.walk(os.path.join(root, tag)) for f in fs)
                     for name, root, tag in (("regular", reg, "s3"), ("universal", uni, "u3"))}
        step_ms = float(np.median(head_s[1:] + ref_s)) * 1e3
        res["a"] = {"losses": [r[0] for r in head + ref], "grad_norms": [r[1] for r in head + ref],
                    "step_ms": step_ms, "step_s": head_s + ref_s, "tag_bytes": tag_bytes,
                    "save_s": {"regular": save_reg_s, "universal": save_uni_s},
                    "manifest_s": {"regular": manifests[0], "universal": manifests[1]}}
        for name, s_ in (("regular", save_reg_s), ("universal", save_uni_s)):
            log(f"  (a) {name} save at step {CKPT_STEPS}: {tag_bytes[name] / 1e9:.2f} GB in "
                f"{s_:.1f} s ({tag_bytes[name] / s_ / 1e9:.2f} GB/s), manifest (sha256) "
                f"{res['a']['manifest_s'][name]:.1f} s [{card}]")
        log(f"  (a) uninterrupted: losses {['%.4f' % r[0] for r in head + ref]}, step "
            f"{step_ms:.1f} ms [{card}]")

        # (b), (c) resume each tag on an engine drawn from another seed
        for key, fn_name, path in (("b", "load_checkpoint", reg), ("c", "load_universal_checkpoint", uni)):
            eng = engine(seed + 1, ckpt_engine="async" if key == "c" else "default")
            r = load(eng, getattr(eng, fn_name), path)
            same(f"({key}) the state at load", state_digests(eng), at_save)
            got, got_s, launches = steps(eng, batches[CKPT_STEPS:2 * CKPT_STEPS], count=True)
            same(f"({key}) losses and grad norms", got, ref)
            same(f"({key}) masters and moments after {CKPT_STEPS} steps", state_digests(eng),
                 ref_digests)
            _, more_s, _ = steps(eng, batches[CKPT_STEPS:CKPT_STEPS + CKPT_TIMED])
            resumed_ms = float(np.median(got_s[1:] + more_s)) * 1e3
            r.update(step_ms=resumed_ms, launches=launches, step_s=got_s + more_s,
                     step_rel=resumed_ms / step_ms - 1)
            if abs(r["step_rel"]) > CKPT_STEP_TOL:
                raise AssertionError(f"({key}) resumed step {resumed_ms:.1f} ms against "
                                     f"{step_ms:.1f} before the save")
            res[key] = r
            log(f"  ({key}) {fn_name}: {r['load_s']:.1f} s; device GiB before / peak / after "
                f"{r['before_gib']:.2f} / {r['peak_gib']:.2f} / {r['after_gib']:.2f}; "
                f"{CKPT_STEPS} steps bit for bit, launches {launches}, step {resumed_ms:.1f} ms "
                f"({r['step_rel']:+.1%}) [{card}]")
            if key == "b":
                del eng

        # (d) the async engine: train_batch before the write is durable
        at_async = state_digests(eng)
        t0 = time.perf_counter()
        eng.save_checkpoint(reg, tag="async")
        block_s = time.perf_counter() - t0
        eng.train_batch(batches[-1])            # updates the saved tensors in place
        eng.checkpoint_engine.commit("async")
        durable_s = time.perf_counter() - t0
        r = load(eng, eng.load_checkpoint, reg, tag="async")
        same("(d) the async tag", state_digests(eng), at_async)
        r.update(block_s=block_s, durable_s=durable_s)
        res["d"] = r
        log(f"  (d) async save: blocks {block_s:.1f} s, durable after {durable_s:.1f} s (a "
            f"train_batch in between); loaded back bit for bit in {r['load_s']:.1f} s [{card}]")

        # (e) planted faults: a truncated state file, then one flipped bit of nu
        victim = faults.corrupt_file(os.path.join(reg, "async"), filename="state.r0.bin")
        r = load(eng, eng.load_checkpoint, reg)
        if not r["path"].endswith("s3"):
            raise AssertionError(f"(e) the truncated tag was not walked back from: {r['path']}")
        same("(e) the walked-back state", state_digests(eng), at_save)
        nu = eng.state.opt_state.nu["layers.0.wq"]
        with torch.no_grad():
            nu.view(torch.int32).view(-1)[nu.numel() // 3] ^= 1 << 22   # a mantissa bit
        flipped, _, _ = steps(eng, batches[CKPT_STEPS:2 * CKPT_STEPS])
        flip_caught = state_digests(eng) != ref_digests
        if not flip_caught:
            raise AssertionError("(e) one flipped bit of nu left the continuation unchanged")
        shutil.rmtree(os.path.join(reg, "s3"))
        try:
            eng.load_checkpoint(reg, tag="async")
            raise AssertionError("(e) the truncated tag named explicitly loaded")
        except RuntimeError as e:
            explicit = str(e)
        eng.destroy()
        del eng
        res["e"] = {"truncated": os.path.relpath(victim, CKPT_DIR), "walk_back": r,
                    "flip_losses": [x[0] for x in flipped], "explicit_error": explicit}
        log(f"  (e) truncated {res['e']['truncated']}: walked back to s3 in {r['load_s']:.1f} s; "
            f"named explicitly: RuntimeError; one flipped nu bit: the continuation differs "
            f"(losses {['%.4f' % x[0] for x in flipped]}) [{card}]")
    finally:
        comm.set_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    res["launches"] = {k: res["b"]["launches"][k] + res["c"]["launches"][k] for k in kernels}
    res["phase_s"] = time.perf_counter() - t_phase
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
                      against: dict = None, leaf_tol: dict = None, layers: int = 1,
                      seq: int = 256, fp16=None, loss_tol: float = TRAIN_LOSS_RTOL,
                      batch: dict = None, model_of=None, card_bf16: bool = True):
    """``layers`` layer(s) at full width (Llama-3-8B by default), S = ``seq``: one step's
    loss and every leaf's gradient, card (kernels, bf16) against CPU (plain,
    fp32), each leaf's error over its reference norm within ``grad_tol``
    (``leaf_tol`` names leaves held at limits of their own; ``against`` maps
    a leaf whose reference gradient is zero in exact arithmetic to the leaf
    whose reference norm it is measured against); each planted ``fault``
    (one context manager, or a tuple of them) must fail the same check.
    ``fp16``: the card computes in fp16 under this DeepSpeed ``fp16`` block,
    its grads unscaled by the loss scale before the compare; ``loss_tol``
    the loss's limit. ``layers`` None keeps ``cfg``'s depth; ``batch`` (by
    default ``seq + 1`` random tokens) is what each step trains on;
    ``model_of(device)``: what ``initialize`` takes (by default a
    ``ModelSpec`` over masters drawn from the seed), its compute dtype the
    config's. A leaf the loss does not reach has a zero gradient.
    ``card_bf16`` False: the card computes in fp32 too (its fp32 kernels)."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import llama

    family = family or llama
    cfg = cfg or llama.LlamaConfig.llama3_8b()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    masters = None
    if model_of is None:
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        masters = family.init(cfg, gen)          # fp32, on the card
    if batch is None:
        rs = np.random.RandomState(seed + 2)
        batch = {"tokens": rs.randint(0, cfg.vocab_size, (1, seq + 1)).astype(np.int32)}

    low = torch.float16 if fp16 else torch.bfloat16
    low_name = ("fp16" if fp16 else "bf16") if card_bf16 else "fp32"

    def step(device, bf16):
        params = {} if masters is None else {k: v.to(device) for k, v in masters.items()}
        model = model_of(device) if model_of is not None else dst.ModelSpec(
            params=params, loss_fn=lambda p, b: family.loss_fn(
                cfg, p, b, compute_dtype=low if bf16 else torch.float32))
        eng, *_ = dst.initialize(
            model=model, config=_train_config(seed, 1, bf16, fp16=fp16 if bf16 else None),
            device=device)
        # the engine copied the leaves: drop the given ones (host memory at
        # EXAONE-4's width)
        params.clear()
        eng.model.params = None
        loss = float(eng.forward(batch))
        inv = 1.0 / eng.loss_scale
        # the grads stay where the step ran (compare holds the card's to the
        # CPU's on the card), unscaled where a loss scale ran
        grads = {k: torch.zeros_like(p) if p.grad is None else
                 p.grad.float() if inv == 1.0 else p.grad.float() * inv
                 for k, p in eng.state.params.items()}
        del eng, params
        return loss, grads

    t0 = time.perf_counter()
    loss_gpu, g_gpu = step("cuda", card_bf16)
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

    # the CPU's grads go to the card a leaf at a time, for their norms once
    # and for each card step's distances: passes over GBs of fp32 grads take
    # seconds on the host and milliseconds on the card
    ref_norm = {k: float(v.to("cuda").norm()) for k, v in g_cpu.items()}

    def compare(grads):
        return {k: float((grads[k] - g_cpu[k].to(grads[k].device)).norm()) /
                max(ref_norm[against.get(k, k)], 1e-30) for k in g_cpu}

    def worst_of(rel):
        return max(rel, key=lambda k: rel[k] / tol[k])

    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    rel = compare(g_gpu)
    del g_gpu
    torch.cuda.empty_cache()
    worst = worst_of(rel)
    ok = loss_rel <= loss_tol and rel[worst] <= tol[worst] and \
        all(np.isfinite(list(rel.values())))
    log(f"  {label} step ({'' if layers is None else f'{layers} layer(s), '}card ({low_name}, "
        f"kernels) vs CPU (fp32, plain)): loss "
        f"{loss_gpu:.5f} vs {loss_cpu:.5f} (rel {loss_rel:.2e}, tol {loss_tol:g}); "
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
            _, g_bad = step("cuda", card_bf16)
        rel_bad = compare(g_bad)
        del g_bad
        torch.cuda.empty_cache()
        worst_bad = worst_of(rel_bad)
        log(f"  planted fault ({what}): worst leaf {worst_bad} "
            f"{rel_bad[worst_bad]:.4f} (must exceed tol {tol[worst_bad]:g})")
        if rel_bad[worst_bad] <= tol[worst_bad]:
            raise AssertionError(f"the training-path check passes a planted fault ({what}); "
                                 "too loose")
        faults.append({"what": what, "leaf": worst_bad, "grad_rel": rel_bad[worst_bad]})
    del masters
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss_card": loss_gpu, "loss_cpu": loss_cpu, "loss_rel": loss_rel,
            "grad_rel": rel, "loss_tol": loss_tol, "grad_tol": grad_tol,
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
        # CUPTI drops records in the middle of a window now and then (500 of
        # 520 RMSNorm and 246 of 256 paged in one eager window): such a
        # session is logged and the window runs again, as checked_window does
        for session in range(PROFILE_SESSIONS):
            wall, busy, n_k, top = profile_window(fn)
            named = {"rms_norm": sum(c for k, _, c in top if "rms_norm_" in k),
                     "paged_decode_attention": sum(c for k, _, c in top if "paged_sm90" in k)}
            if named == want_named:
                break
            log(f"  {name}: the profiler names {named} kernels of {n_k} records, the "
                f"launches were {want_named} (session {session + 1} of this window; again)")
        else:
            raise AssertionError(f"{name}: the profiler names {named} kernels, the launches "
                                 f"were {want_named}, in {PROFILE_SESSIONS} sessions")
        timing[name] = {"wall_ms": host_ms, "profiled_wall_ms": wall * 1e3 / CORE_K,
                        "busy_ms": busy * 1e3 / CORE_K, "idle_share": 1 - busy / wall,
                        "kernels_per_step": n_k / CORE_K, "named_kernels": named,
                        "sessions": session + 1,
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
# the serving fleet (phase 17): Llama-3-8B at FLEET_LAYERS behind the port's
# continuous-batching scheduler, replica router, fleet failover and
# disaggregated prefill / decode
FLEET_LAYERS = 4               # Llama-3-8B's depth here (cut from 32 for the smoke's time)
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
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), max_seq_len=CORE_CTX,
                              num_layers=FLEET_LAYERS)
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


# --------------------------------------------------------------------------- #
# phase 20: activation checkpointing and the tiled logits + loss head
# --------------------------------------------------------------------------- #
REMAT_POLICIES = ("none", "full", "save_attn_out", "save_big_matmuls", "offload")
REMAT_STEPS = 3
REMAT_LONG_SEQS = (16384, 12288, 8192)   # tried in order until `none` fits one step
REMAT_LONG_STEPS = 2                     # the second timed
TILED_SHARDS = 8


def remat_counters() -> dict:
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                         flash_bwd_dq_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

    return {"flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
            "flash_bwd_dkv": flash_bwd_dkv_cuda, "rms_norm": rms_norm_cuda}


def remat_launches(layers: int, policy: str, micro_batches: int) -> dict:
    """Launches of ``micro_batches`` Llama forwards and backwards under
    ``policy``: a rematerialized block runs its forward again in the
    backward (its flash forward and its two RMSNorms launch again; the final
    norm is outside the blocks), ``offload`` recomputes nothing."""
    again = policy not in ("none", "offload")
    per = {"flash_fwd": layers * (2 if again else 1), "flash_bwd_dq": layers,
           "flash_bwd_dkv": layers, "rms_norm": 2 * layers + 1 + (2 * layers if again else 0)}
    return {k: v * micro_batches for k, v in per.items()}


def remat_run(seed: int, cfg, policy: str, batch, steps: int, gas: int, tiled: bool = False):
    """``steps`` of ``train_batch`` with every block under ``policy`` (the
    family's ``remat``; ``none``: no remat): losses, grad norms, step ms
    (the mean after the first step), peak GiB, launches, and the engine."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import llama

    rcfg = dataclasses.replace(cfg, remat=policy != "none", remat_policy=policy)
    conf = _train_config(seed, gas, True)
    if tiled:
        conf["sequence"] = {"tiled_loss": True, "tiled_loss_shards": TILED_SHARDS}
    gc.collect()
    torch.cuda.empty_cache()
    eng, *_ = dst.initialize(model=llama.model_spec(rcfg), config=conf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = remat_counters()
    for c in counters.values():
        c.launches = 0
    losses, norms, step_s = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = eng.train_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out.loss))
        norms.append(float(out.grad_norm))
    timed = step_s[1:] or step_s
    return {"losses": losses, "grad_norms": norms, "step_s": step_s,
            "step_ms": sum(timed) / len(timed) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {k: c.launches for k, c in counters.items()}}, eng


def check_launches(what: str, got: dict, want: dict) -> None:
    log(f"  {what}: launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{what}: kernel launch counts {got} != expected {want}")


def same_or_within(what: str, got: list, ref: list, tol: float) -> str:
    """'bit for bit' when ``got`` equals ``ref``; else 'within <tol>' when
    every entry is within ``tol`` relative; raises otherwise."""
    if got == ref:
        return "bit for bit"
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, ref))
    if not rel <= tol:
        raise AssertionError(f"{what}: {got} against {ref} (rel {rel:.2e} > {tol:g})")
    return f"within {tol:g} (rel {rel:.2e})"


@contextlib.contextmanager
def fault_recompute_shifted_positions():
    """The recompute of each checkpointed block rotates q at positions one
    later than its forward did (k as before)."""
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ac

    sound_ckpt, sound_rot = ac.checkpoint, llama.apply_rotary

    def shifted(x, cos, sin, positions=None):
        shifted.calls += 1
        if shifted.calls % 2:                     # each block rotates q, then k
            import torch

            positions = (torch.arange(x.shape[-3], device=x.device) if positions is None
                         else positions) + 1
        return sound_rot(x, cos, sin, positions)

    shifted.calls = 0

    def faulty(function, *args, policy=None, **kw):
        calls = [0]

        def run(*a, **k):
            calls[0] += 1
            if calls[0] == 1:
                return function(*a, **k)
            llama.apply_rotary = shifted
            try:
                return function(*a, **k)
            finally:
                llama.apply_rotary = sound_rot

        return sound_ckpt(run, *args, policy=policy, **kw)

    ac.checkpoint = faulty
    try:
        yield "the recompute rotates q at positions shifted by one"
    finally:
        ac.checkpoint = sound_ckpt


def micro_grads(eng, cfg, micro, names) -> dict:
    """Grads of the masters ``names`` from one micro-batch's loss of
    ``cfg``'s forward over the engine's compute params (outside the step)."""
    import torch

    from deepspeed_tpu_torch.models import llama

    batch = {k: torch.as_tensor(v).to(eng.device) for k, v in micro.items()}
    loss, _ = llama.loss_fn(cfg, eng._compute_params(), batch)
    grads = torch.autograd.grad(loss, [eng.state.params[n] for n in names])
    return {n: g.float() for n, g in zip(names, grads)}


def block_saved_bytes(seed: int, cfg, seq: int) -> dict:
    """``saved_bytes`` of one Llama block at ``seq`` tokens (bf16) under
    each policy: what its backward keeps beyond its input and leaves."""
    import torch

    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.rotary import rope_frequencies
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ac

    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    leaves = {}
    for name, (shape, fan_in) in llama._layer_shapes(cfg).items():
        t = (torch.randn(shape, generator=gen, device="cuda") * fan_in ** -0.5 if fan_in
             else torch.ones(shape, device="cuda"))
        leaves[name] = t.to(torch.bfloat16).requires_grad_()
    x = torch.randn(1, seq, cfg.hidden_size, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta, device="cuda")
    out = {p: ac.saved_bytes(lambda x, p_: llama._block(cfg, x, p_, cos, sin, None), x, leaves,
                             policy=p) for p in REMAT_POLICIES}
    del leaves, x
    torch.cuda.empty_cache()
    return out


def phase_remat(seed: int, card: str) -> dict:
    """Phase 7's training under each of ``REMAT_POLICIES``, then one long
    sequence with ``none``, ``full`` and ``full`` + the tiled loss head
    (see the module docstring)."""
    import torch

    from deepspeed_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=4)
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (2, 4097)).astype(np.int32)}
    runs, fault = {}, None
    launches = {k: 0 for k in remat_counters()}
    for policy in REMAT_POLICIES:
        r, eng = remat_run(seed, cfg, policy, batch, REMAT_STEPS, 2)
        check_launches(f"policy {policy}", r["launches"],
                       remat_launches(cfg.num_layers, policy, 2 * REMAT_STEPS))
        for k, n in r["launches"].items():
            launches[k] += n
        if policy != "none":
            r["losses_vs_none"] = same_or_within(f"{policy} losses", r["losses"],
                                                 runs["none"]["losses"], TRAIN_LOSS_RTOL)
            r["grad_norms_vs_none"] = same_or_within(f"{policy} grad norms", r["grad_norms"],
                                                     runs["none"]["grad_norms"], TRAIN_GRAD_RTOL)
        log(f"  {policy:17s} step {r['step_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB, "
            f"losses {['%.5f' % l for l in r['losses']]}"
            + (f" ({r['losses_vs_none']}; grad norms {r['grad_norms_vs_none']})"
               if policy != "none" else "") + f" [{card}]")
        if policy == "full":
            # planted fault: a recompute that does not replay its forward
            micro = {"tokens": batch["tokens"][:1]}
            names = ["layers.0.wq", "layers.0.wk", "layers.3.wq", "layers.3.w_down"]
            plain = micro_grads(eng, cfg, micro, names)
            rcfg = dataclasses.replace(cfg, remat=True, remat_policy="full")
            sound = micro_grads(eng, rcfg, micro, names)
            with fault_recompute_shifted_positions() as what:
                bad = micro_grads(eng, rcfg, micro, names)
            rel = {n: float((sound[n] - plain[n]).norm() / plain[n].norm()) for n in names}
            rel_bad = {n: float((bad[n] - plain[n]).norm() / plain[n].norm()) for n in names}
            worst = max(rel_bad, key=rel_bad.get)
            log(f"  micro-batch grads, full remat against none: {rel} (tol {TRAIN_GRAD_RTOL:g}); "
                f"planted fault ({what}): {worst} {rel_bad[worst]:.4f}")
            if max(rel.values()) > TRAIN_GRAD_RTOL:
                raise AssertionError(f"remat grads disagree with the plain ones: {rel}")
            if rel_bad[worst] <= TRAIN_GRAD_RTOL:
                raise AssertionError(f"the remat check passes a planted fault ({what})")
            fault = {"what": what, "leaf": worst, "grad_rel": rel_bad[worst],
                     "sound_grad_rel": rel}
            del plain, sound, bad
        del eng
        runs[policy] = r
    saved = block_saved_bytes(seed, cfg, 4096)
    log("  saved_bytes of one block (S 4096, bf16): " + ", ".join(
        f"{p} {b / 2**20:.1f} MiB" for p, b in saved.items()))
    if not saved["none"] >= saved["save_big_matmuls"] >= saved["save_attn_out"] \
            >= saved["full"] == 0:
        raise AssertionError(f"saved_bytes out of order: {saved}")

    long_runs, seq = {}, None
    for S in REMAT_LONG_SEQS:
        lcfg = dataclasses.replace(cfg, max_seq_len=S)
        lbatch = {"tokens": rs.randint(0, cfg.vocab_size, (1, S + 1)).astype(np.int32)}
        try:
            r, eng = remat_run(seed, lcfg, "none", lbatch, REMAT_LONG_STEPS, 1)
        except torch.cuda.OutOfMemoryError:
            r = eng = None
        if r is None:               # the failed step's engine is freed once the
            log(f"  S {S}: one step without remat does not fit the card")
            gc.collect()            # exception is gone
            torch.cuda.empty_cache()
            continue
        del eng
        seq, long_runs["none"] = S, r
        break
    if seq is None:
        raise AssertionError(f"no sequence of {REMAT_LONG_SEQS} fits a step without remat")
    for name, policy, tiled in (("full", "full", False), ("full+tiled", "full", True)):
        r, eng = remat_run(seed, lcfg, policy, lbatch, REMAT_LONG_STEPS, 1, tiled=tiled)
        del eng
        long_runs[name] = r
    for name, r in long_runs.items():
        check_launches(f"S {seq} {name}", r["launches"],
                       remat_launches(cfg.num_layers, name.split("+")[0], REMAT_LONG_STEPS))
        for k, n in r["launches"].items():
            launches[k] += n
        log(f"  S {seq} {name:11s} step {r['step_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB, "
            f"losses {['%.5f' % l for l in r['losses']]} [{card}]")
    dense, tiled_l = long_runs["full"]["losses"][0], long_runs["full+tiled"]["losses"][0]
    tiled_rel = abs(tiled_l - dense) / abs(dense)
    tiled_ms = long_runs["full+tiled"]["step_ms"] - long_runs["full"]["step_ms"]
    log(f"  tiled loss {tiled_l:.6f} against dense {dense:.6f} (rel {tiled_rel:.2e}, tol "
        f"{TRAIN_LOSS_RTOL:g}); the fp32 tiled head costs {tiled_ms:.1f} ms a step [{card}]")
    if not tiled_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"tiled loss {tiled_l} against dense {dense}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"policies": runs, "saved_bytes": saved, "planted_fault": fault, "long_seq": seq,
            "long": long_runs, "tiled_loss_rel": tiled_rel, "tiled_cost_ms": tiled_ms,
            "launches": launches}


# --------------------------------------------------------------------------- #
# phase 21: init_inference (the v1 engine) at Llama-3-8B's full depth
# --------------------------------------------------------------------------- #
V1_LENGTHS = (1, 17, 64, 100, 129, 200, 33, 150)
V1_EOS_ROW, V1_EOS_STEP = 2, 5          # the row that ends early, and by when
# at 32 bf16 layers the prefill logits and the generated tokens are held to
# the fp32 forward at this multiple of the bf16 flash path's own error there
# (WHOLE_PATH_TOL is a 2-layer limit: at 32 layers the two bf16 paths read
# 0.1095 against each other on an H100, PERF.md section 6)
V1_NOISE_RATIO = 2.0
QUANT_MODES = {"int8": {"enabled": True, "bits": 8}, "int4": {"enabled": True, "bits": 4},
               "fp8": {"enabled": True, "dtype": "fp8"}}
# quantized against bf16 logits at QUANT_DEPTH layers, each row's largest
# error over its RMS: tests/test_torch_quant_limits.py's CPU simulation at
# these widths (twice the largest error it measures)
QUANT_VS_BF16_TOL = {"int8": 0.5, "fp8": 1.25, "int4": 8.5}
QUANT_DEPTH = 2
BF16_8B_BYTES = 16.06e9


def v1_prompts(seed: int, vocab: int):
    rs = np.random.RandomState(seed + 21)
    prompts = np.zeros((len(V1_LENGTHS), max(V1_LENGTHS)), np.int32)
    for i, n in enumerate(V1_LENGTHS):
        prompts[i, :n] = rs.randint(0, vocab, n)
    return prompts, np.array(V1_LENGTHS, np.int32)


def v1_prefill_logits(eng, prompts, lengths):
    import torch

    with torch.inference_mode():
        pad = -(-prompts.shape[1] // eng.config.prefill_bucket) * eng.config.prefill_bucket
        padded = np.zeros((len(prompts), pad), np.int64)
        padded[:, :prompts.shape[1]] = prompts
        logits, _ = eng._prefill(eng._tensor(padded), eng._tensor(lengths), pad + 1)
    return logits, padded


def stream_check(eng, prompts, lengths, outs, eos=None) -> tuple:
    """Each generated token against the no-cache forward over its row's
    prompt and the tokens before it: (argmax matches, tokens checked,
    largest (max logit - the token's logit) / row RMS)."""
    import torch

    match, n, worst = 0, 0, 0.0
    for r in range(len(prompts)):
        toks = list(outs[r])
        if eos is not None and eos in toks:
            toks = toks[:toks.index(eos) + 1]
        seq = np.concatenate([prompts[r, :lengths[r]], np.asarray(toks[:-1], np.int64)])
        z = eng.forward(seq[None])[0, lengths[r] - 1:].float()
        rms = z.pow(2).mean(-1).sqrt()
        t = torch.as_tensor(toks, device=z.device)
        gap = (z.max(-1).values - z.gather(-1, t[:, None])[:, 0]) / rms
        match += int((z.argmax(-1) == t).sum())
        n += len(toks)
        worst = max(worst, float(gap.max()))
    return match, n, worst


@contextlib.contextmanager
def fault_cache_write_late():
    """Every K/V row lands one cache slot after its position."""
    from deepspeed_tpu_torch.models import llama

    sound = llama._write_cache
    llama._write_cache = lambda cache, new, starts: sound(cache, new, starts + 1)
    try:
        yield "each K/V row written one cache slot late"
    finally:
        llama._write_cache = sound


def v1_times(eng, prompts, lengths, new: int) -> dict:
    """Prefill ms (a 1-token generate) and the decode step's ms (the rest of
    a ``new``-token generate over its ``new - 1`` steps), wall clock with the
    host syncs a generate makes; the engine's peak GiB in the longer one:
    its weights at rest and what the generate allocated above the memory in
    use before it (the phase also holds the bf16 weights)."""
    import torch

    before = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, prompt_lengths=lengths, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.generate(prompts, prompt_lengths=lengths, max_new_tokens=new)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return {"prefill_ms": prefill * 1e3, "decode_step_ms": (total - prefill) / (new - 1) * 1e3,
            "generate_s": total,
            "peak_gib": (eng.weight_bytes() + torch.cuda.max_memory_allocated() - before) / 2**30}


def _top2(z) -> tuple:
    """(argmax, second token, (top1 - top2) / row RMS) of one logits row."""
    top = z.float().topk(2)
    rms = float(z.float().pow(2).mean().sqrt())
    return int(top.indices[0]), int(top.indices[1]), float(top.values[0] - top.values[1]) / rms


def logits_of(out):
    """A family's ``apply`` output as logits (a MoE family's is (logits, aux))."""
    return out[0] if isinstance(out, tuple) else out


def v1_v2_parting(cfg, eng, prompts, lengths, v1_outs, v2_outs, leave, v2_ticks,
                  noise: float, family=None, beyond: str = None) -> dict:
    """At the step where a row's v1 and v2 streams part: the top-two logit
    gap of v1 (its dense-cache decode), of v2 (the paged kernel's decode
    step, recorded from the graph's output) and of the fp32 forward of the
    same weights, each over its row's RMS, and the fp32 forward's margin
    between the two tokens chosen. A margin wider than the bf16 path's own
    error (``noise``) would be a fault of the side whose token has the lower
    fp32 logit; within it the rows part on a near-tie. ``beyond`` names
    the verdict beyond it instead (a MoE family: a route that flipped on a
    near-tie earlier in the row moves its tokens wholesale)."""
    import torch

    from deepspeed_tpu_torch.models import llama

    family = family or llama
    want = {i: j for i, j in enumerate(leave) if j is not None}
    v1_rows = {}
    sound = eng._apply_cached
    calls = []

    def recorded(tokens, cache, cache_len):
        logits, cache = sound(tokens, cache, cache_len)
        step = len(calls)
        calls.append(None)
        for i, j in want.items():
            if j == step:
                pos = int(lengths[i]) - 1 if step == 0 else 0
                v1_rows[i] = logits[i, pos].float().clone()
        return logits, cache

    eng._apply_cached = recorded
    again = eng.generate(prompts, prompt_lengths=lengths, max_new_tokens=MAX_NEW_TOKENS)
    eng._apply_cached = sound
    out = {"noise": noise, "rows": {}}
    for i, j in want.items():
        seq = np.concatenate([prompts[i, :lengths[i]], np.asarray(v1_outs[i][:j], np.int64)])
        with torch.inference_mode():
            z32 = logits_of(family.apply(cfg, eng.weights(), eng._tensor(seq[None]),
                                         compute_dtype=torch.float32))[0, -1]
        t1, t2 = int(v1_outs[i][j]), int(v2_outs[i][j])
        rms32 = float(z32.pow(2).mean().sqrt())
        row = {"step": j, "v1_token": t1, "v2_token": t2,
               "fp32": _top2(z32), "fp32_margin_v1_minus_v2": float(z32[t1] - z32[t2]) / rms32,
               "v1": _top2(v1_rows[i]) if i in v1_rows else None,
               "v2": _top2(v2_ticks[j - 1][i]) if 0 < j <= len(v2_ticks) else None}
        row["v2_slot_is_row"] = row["v2"] is not None and row["v2"][0] == t2
        row["verdict"] = ("near-tie" if abs(row["fp32_margin_v1_minus_v2"]) <= noise else
                          beyond or ("v2 wrong" if row["fp32_margin_v1_minus_v2"] > 0
                                     else "v1 wrong"))
        out["rows"][i] = row
        log(f"  row {i} parts at step {j}: v1 picks {t1}, v2 {t2}; top-two gap / RMS v1 "
            f"{row['v1'][2] if row['v1'] else float('nan'):.4f}, v2 "
            f"{row['v2'][2] if row['v2'] else float('nan'):.4f}, fp32 {row['fp32'][2]:.4f} "
            f"(fp32 argmax {row['fp32'][0]}); fp32 margin of v1's token over v2's "
            f"{row['fp32_margin_v1_minus_v2']:+.4f} against the 16-bit path's error "
            f"{noise:.4f}: "
            f"{row['verdict']}")
    out["v1_repeat_equal"] = [list(map(int, r)) for r in again] == \
        [list(map(int, r)) for r in v1_outs]
    return out


def phase_init_inference(seed: int, card: str) -> dict:
    """``init_inference`` on Llama-3-8B (32 layers, bf16 weights from the
    seed), its streams against the no-cache forward, its weights at rest as
    int8 / int4 / fp8, and its greedy streams against the v2 engine's."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.inference.engine import dequantize_leaf, is_quantized
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

    cfg = llama.LlamaConfig.llama3_8b()
    conf = {"dtype": "bfloat16", "prefill_bucket": 64}
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        dtype=torch.bfloat16, device="cuda")
    eng = dst.init_inference(llama, model_cfg=cfg, params=params, config=conf)
    bf16_bytes = eng.weight_bytes()
    log(f"  engine: {cfg.num_layers} layers, weights {bf16_bytes / 1e9:.2f} GB bf16, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    prompts, lengths = v1_prompts(seed, cfg.vocab_size)
    eng.generate(prompts[:2], prompt_lengths=lengths[:2], max_new_tokens=2)   # warm-up
    free = eng.generate(prompts, prompt_lengths=lengths, max_new_tokens=MAX_NEW_TOKENS)
    eos = int(free[V1_EOS_ROW, V1_EOS_STEP])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms_norm_cuda.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, prompt_lengths=lengths, max_new_tokens=MAX_NEW_TOKENS,
                        eos_token_id=eos)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"rms_norm": rms_norm_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # every row ran all MAX_NEW_TOKENS - 1 decode steps: the early exit waits
    # for every row, and one row's EOS does not end the others
    want = {"rms_norm": (2 * cfg.num_layers + 1) * MAX_NEW_TOKENS}
    check_launches("v1 generate", launches, want)
    row = list(outs[V1_EOS_ROW])
    first = row.index(eos)
    if first > V1_EOS_STEP or any(t != eos for t in row[first:]):
        raise AssertionError(f"row {V1_EOS_ROW} did not end on EOS {eos}: {row}")
    log(f"  generate: 8 prompts x {MAX_NEW_TOKENS} tokens in {gen_s * 1e3:.1f} ms, row "
        f"{V1_EOS_ROW} ends on EOS at step {first}, peak {peak:.2f} GiB [{card}]")

    # the bf16 paths at 32 layers, each against the same forward computed in
    # fp32 (the fp32 flash kernels, the same bf16 weights): the cached
    # path's error may be at most V1_NOISE_RATIO times the kernel path's own
    logits, padded = v1_prefill_logits(eng, prompts, lengths)
    full = eng.forward(padded)
    with torch.inference_mode():
        ref32 = llama.apply(cfg, eng.weights(), eng._tensor(padded), compute_dtype=torch.float32)
    direct = row_err(logits, full)
    noise = row_err(full, ref32)[1]
    tol = V1_NOISE_RATIO * noise
    pre_err = check_close("prefill logits (dense cache, plain masked attention) against the "
                          "fp32 forward", logits, ref32, tol)
    log(f"  (the no-cache bf16 forward, flash kernels, against the fp32 forward: "
        f"{noise:.4f}; the two bf16 paths against each other: {direct[1]:.4f}, "
        f"WHOLE_PATH_TOL {WHOLE_PATH_TOL:g} at 2 layers)")
    del logits, full, ref32
    match, n, worst = stream_check(eng, prompts, lengths, outs, eos)
    log(f"  generated tokens against the no-cache forward: {match}/{n} its argmax, largest gap "
        f"{worst:.4f} of the row's RMS (tol {tol:.4f})")
    if worst > tol:
        raise AssertionError(f"a generated token is {worst} row RMS below the argmax")
    with fault_cache_write_late() as what:
        bad = eng.generate(prompts, prompt_lengths=lengths, max_new_tokens=8)
    _, _, worst_bad = stream_check(eng, prompts, lengths, bad)
    log(f"  planted fault ({what}): largest gap {worst_bad:.4f} (must exceed {tol:.4f})")
    if worst_bad <= tol:
        raise AssertionError(f"the stream check passes a planted fault ({what})")
    times = {"bf16": v1_times(eng, prompts, lengths, MAX_NEW_TOKENS)}
    times["bf16"]["weight_bytes"] = bf16_bytes
    log(f"  bf16: prefill {times['bf16']['prefill_ms']:.1f} ms, decode step "
        f"{times['bf16']['decode_step_ms']:.2f} ms, peak {times['bf16']['peak_gib']:.2f} GiB "
        f"[{card}]")

    # the greedy stream of the v2 engine on the same weights and prompts
    v2 = build_engine_v2(llama, cfg, params, config={
        **conf, "ragged": {"max_tracked_sequences": 8, "max_ragged_batch_size": 8,
                           "memory_config_blocks": 64, "block_size": 128}})
    v2_ticks = []
    sound_decode = v2._decode_forward

    def recorded_decode():
        logits, amax = sound_decode()
        v2_ticks.append(logits.float().clone())
        return logits, amax

    v2._decode_forward = recorded_decode
    v2_outs = v2.generate([prompts[i, :n_] for i, n_ in enumerate(lengths)],
                          max_new_tokens=MAX_NEW_TOKENS)
    v2._decode_forward = sound_decode
    leave = [next((j for j, (a, b) in enumerate(zip(free[i], v2_outs[i])) if a != b), None)
             for i in range(len(prompts))]
    log(f"  v1 against v2 greedy streams: first differing step by row {leave} "
        f"(None: the same {MAX_NEW_TOKENS} tokens)")
    parting = v1_v2_parting(cfg, eng, prompts, lengths, free, v2_outs, leave, v2_ticks,
                            noise)
    del v2, v2_ticks
    torch.cuda.empty_cache()

    quant, prefill_bf16 = {}, v1_prefill_logits(eng, prompts, lengths)[0]
    for mode, q in QUANT_MODES.items():
        eq = dst.init_inference(llama, model_cfg=cfg, params=params, config={**conf, "quant": q})
        qt = v1_times(eq, prompts, lengths, MAX_NEW_TOKENS)
        qt["weight_bytes"] = eq.weight_bytes()
        # the plain version of weights at rest: a bf16 engine over the same
        # weights dequantized once, whose logits must equal bit for bit
        ref = dst.init_inference(llama, model_cfg=cfg, config=conf, params={
            k: dequantize_leaf(k, v, torch.bfloat16) if is_quantized(v) else v
            for k, v in eq.params.items()})
        got = v1_prefill_logits(eq, prompts, lengths)[0]
        want_l = v1_prefill_logits(ref, prompts, lengths)[0]
        exact = bool(torch.equal(got, want_l))
        qt["vs_bf16_full_depth"] = row_err(got, prefill_bf16)[1]
        del ref, want_l
        scale = eq.params["layers.0.wq"]["scale"]
        sound_scale = scale[0, 7].clone()
        scale[0, 7] *= 2
        bad = v1_prefill_logits(eq, prompts, lengths)[0]
        scale[0, 7] = sound_scale
        fault_err = row_err(bad, got)
        del bad
        log(f"  {mode}: weights {qt['weight_bytes'] / 1e9:.2f} GB (bf16 {bf16_bytes / 1e9:.2f}), "
            f"prefill {qt['prefill_ms']:.1f} ms, decode step {qt['decode_step_ms']:.2f} ms, peak "
            f"{qt['peak_gib']:.2f} GiB; logits {'equal' if exact else 'NOT equal'} to the "
            f"dequantized bf16 engine's; against bf16 weights at 32 layers row err/RMS "
            f"{qt['vs_bf16_full_depth']:.3f}; planted fault (layers.0.wq's scale of input 7 "
            f"doubled): row err/RMS {fault_err[1]:.3e} [{card}]")
        if not exact:
            raise AssertionError(f"{mode}: dequantize-on-use disagrees with the dequantized weights")
        if fault_err[0] == 0:
            raise AssertionError(f"{mode}: the quant check passes a planted fault")
        qt["planted_fault_row_err"] = fault_err[1]
        quant[mode] = qt
        del eq, got
        torch.cuda.empty_cache()
    del prefill_bf16, eng

    # quantized against bf16 logits at the simulated depth
    small = dataclasses.replace(cfg, num_layers=QUANT_DEPTH)
    sp = {k: v for k, v in params.items()
          if not k.startswith("layers.") or int(k.split(".")[1]) < QUANT_DEPTH}
    base = v1_prefill_logits(dst.init_inference(llama, model_cfg=small, params=sp, config=conf),
                             prompts, lengths)[0]
    for mode, q in QUANT_MODES.items():
        eq = dst.init_inference(llama, model_cfg=small, params=sp, config={**conf, "quant": q})
        quant[mode]["vs_bf16"] = check_close(
            f"{mode} logits at {QUANT_DEPTH} layers against bf16 weights",
            v1_prefill_logits(eq, prompts, lengths)[0], base, QUANT_VS_BF16_TOL[mode])[1]
        del eq
    del base, params, sp
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "generate_s": gen_s, "peak_gib": peak, "eos_step": first,
            "prefill_err": pre_err, "bf16_noise": noise, "paths_direct": direct[1], "tol": tol, "argmax_match": [match, n], "worst_gap": worst,
            "planted_fault_gap": worst_bad, "times": times, "quant": quant,
            "v1_v2_first_difference": leave, "v1_v2_parting": parting}


# --------------------------------------------------------------------------- #
# phase 22: the optimizer set
# --------------------------------------------------------------------------- #
OPT_STEPS = 3              # steps of each optimizer's run
OPT_CHECK_STEP = 2         # the step whose update is held to float64
OPT_CHECK_TOL = 1e-5       # per leaf: ||p_card - p_f64||_F / ||p_f64||_F
OPT_ZERO_STEPS = 2         # steps of each ZeRO stage's LAMB and Muon run
NO_DECAY = [{"pattern": "(norm|bias)", "weight_decay": 0.0}]
OPTIMIZER_CASES = {        # the runs of phase 22 (and zero_nccl_check.py --optimizer)
    "adamw": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1}},
    "adamw_groups": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1},
                     "param_groups": NO_DECAY},
    "lion": {"type": "lion", "params": {"lr": 3e-5, "weight_decay": 0.1}},
    "lamb": {"type": "lamb", "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "adagrad": {"type": "adagrad", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "sgd": {"type": "sgd", "params": {"lr": 1.0, "momentum": 0.9, "nesterov": True,
                                      "weight_decay": 1e-4}},
    "muon": {"type": "muon", "params": {"lr": 0.02, "weight_decay": 0.01}},
    "onebitadam": {"type": "onebitadam", "params": {"lr": 1e-4, "freeze_step": 1,
                                                    "weight_decay": 0.01}},
    "onebitlamb": {"type": "onebitlamb", "params": {"lr": 3e-3, "freeze_step": 1,
                                                    "weight_decay": 0.01}},
    "zerooneadam": {"type": "zerooneadam", "params": {"lr": 1e-4, "var_freeze_step": 1,
                                                      "weight_decay": 0.01}},
}


def loop_adamw(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1):
    """The multi-tensor AdamW's plain version: the per-leaf loop of
    ``ops/optimizers.py`` as it stood before the foreach update, about ten
    elementwise launches and one leaf's temporaries at a time."""
    import torch

    from deepspeed_tpu_torch.ops.optimizers import AdamState, Optimizer

    b1, b2 = betas

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamState(0, {k: z(p) for k, p in params.items()},
                         {k: z(p) for k, p in params.items()})

    def update(params, grads, state, lr_scale=1.0):
        step = state.step + 1
        c1, c2 = 1 - b1 ** float(step), 1 - b2 ** float(step)
        alpha = lr * float(lr_scale)
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name].float()
                m, v = state.mu[name], state.nu[name]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                step_val = (m / c1).div_((v / c2).sqrt_().add_(eps))
                if weight_decay:
                    step_val.add_(p.float(), alpha=weight_decay)
                p.sub_(step_val.mul_(alpha).to(p.dtype))
        return params, AdamState(step, state.mu, state.nu)

    return Optimizer("adamw", init, update,
                     dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))


class HostArena:
    """One page-locked host buffer, reused: the snapshots of the checked
    step. ``close`` gives the memory back to the host (96 GiB, which phase
    23's CPU reference needs): PyTorch's pinned-memory cache keeps freed
    blocks, so it is emptied, or, where torch cannot empty it, the buffer
    is a plain one registered with ``cudaHostRegister``."""

    def __init__(self, nbytes: int):
        import torch

        self.off = 0
        # PyTorch's pinned allocation is faster (8 s against 19 s for 38.8 GB
        # on the H100 machine, PR 21 runs 1-2) where its cache can be emptied
        self.cached = torch.cuda.is_available() and hasattr(torch._C, "_host_emptyCache")
        self.registered = torch.cuda.is_available() and not self.cached
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.cached)
        if self.registered:
            err = torch.cuda.cudart().cudaHostRegister(self.buf.data_ptr(), nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister failed: {err}")

    def close(self):
        import torch

        if self.registered:
            torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
            self.registered = False
        self.buf = None
        if self.cached:
            torch._C._host_emptyCache()

    def reset(self):
        self.off = 0

    def put(self, t):
        n = t.numel() * t.element_size()
        if self.off + n > self.buf.numel():
            raise MemoryError("host arena too small for the snapshot")
        dst = self.buf[self.off:self.off + n].view(t.dtype).view(t.shape)
        dst.copy_(t, non_blocking=True)
        self.off += -(-n // 512) * 512
        return dst


class SnapshotOptimizer:
    """Wraps an engine's optimizer: before the update of step ``at`` it
    copies the params, grads and every state tensor to the host arena (the
    inputs of the float64 reference), then runs the update unchanged."""

    def __init__(self, eng, arena, at: int):
        from deepspeed_tpu_torch.ops.optimizers import Optimizer

        self.inner, self.arena, self.at, self.calls, self.snap = eng.optimizer, arena, at, 0, None
        opt = self.inner

        def update(params, grads, state, lr_scale=1.0, layout=None):
            import torch

            from deepspeed_tpu_torch.ops.optimizers import state_scalars, state_tensors

            self.calls += 1
            if self.calls == self.at:
                arena.reset()
                self.snap = {
                    "params": {k: arena.put(v.detach()) for k, v in params.items()},
                    "grads": {k: arena.put(v) for k, v in grads.items()},
                    "state": {path: {k: arena.put(v) for k, v in ts.items()}
                              for path, ts in state_tensors(state).items()},
                    "scalars": state_scalars(state), "lr_scale": float(lr_scale)}
                torch.cuda.synchronize()
            return opt.update(params, grads, state, lr_scale=lr_scale, layout=layout)

        eng.optimizer = Optimizer(opt.name, opt.init, update, opt.hyperparams)


def _ns64(x, steps=5):
    """Newton-Schulz in float64 (the JAX formulation)."""
    import torch

    a, b, c = 3.4445, -4.7750, 2.0315
    x = x / (torch.linalg.vector_norm(x) + 1e-7)
    tr = x.shape[0] > x.shape[1]
    if tr:
        x = x.T
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * xxt @ xxt) @ x
    return x.T if tr else x


def reference_update(kind: str, hp: dict, names, layout, snap, dev) -> dict:
    """The JAX update of one JAX leaf (its port leaves ``names``, in layer
    order) in float64 on the card from the snapshot: new params by name.
    ``kind`` is the optimizer's type; ``snap`` the host copies of params,
    grads and state before the update (one group's state, by field)."""
    import torch

    f64 = lambda t: t.to(dev, non_blocking=True).double()  # noqa: E731
    p = {n: f64(snap["params"][n]) for n in names}
    g = {n: f64(snap["grads"][n]) for n in names}
    st = {f: {n: f64(ts[n]) for n in names} for f, ts in snap["state"].items()}
    step = snap["scalars"]["step"] + 1
    lr = hp["lr"] * snap["lr_scale"]
    wd = hp.get("weight_decay", 0.0)
    b1, b2 = hp.get("betas", (0.9, 0.999))
    out = {}

    def adam_dir(n, c1, c2, eps, mu="mu", nu="nu"):
        m = b1 * st[mu][n] + (1 - b1) * g[n]
        v = b2 * st[nu][n] + (1 - b2) * g[n] ** 2
        return (m / c1) / (torch.sqrt(v / c2) + eps)

    def trust(us, lo=0.01, hi=10.0):
        w = torch.sqrt(sum((p[n] ** 2).sum() for n in names))
        u = torch.sqrt(sum((us[n] ** 2).sum() for n in names))
        return torch.where((w > 0) & (u > 0), torch.clamp(w / u, lo, hi), torch.ones_like(w))

    def compressed(n_list, mu="mu"):
        # the sign from g + e as the card rounds it (fp32), the scale in float64
        corr32 = {n: (snap["grads"][n].to(dev).float() + snap["state"]["error"][n].to(dev))
                  for n in n_list}
        total = sum(c.double().abs().sum() for c in corr32.values())
        count = sum(c.numel() for c in corr32.values())
        scale = total / count
        return {n: torch.where(corr32[n] >= 0, 1.0, -1.0).double() * scale for n in n_list}

    if kind in ("adam", "adamw"):
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        for n in names:
            out[n] = p[n] - lr * (adam_dir(n, c1, c2, hp.get("eps", 1e-8)) + wd * p[n])
    elif kind == "lion":
        b1, b2 = hp.get("betas", (0.9, 0.99))
        for n in names:
            out[n] = p[n] - lr * (torch.sign(b1 * st["mu"][n] + (1 - b1) * g[n]) + wd * p[n])
    elif kind == "lamb":
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        u = {n: adam_dir(n, c1, c2, hp.get("eps", 1e-6)) + wd * p[n] for n in names}
        t = trust(u)
        out = {n: p[n] - lr * t * u[n] for n in names}
    elif kind == "adagrad":
        for n in names:
            gn = g[n] + wd * p[n]
            acc = st["accum"][n] + gn ** 2
            out[n] = p[n] - lr * gn / (torch.sqrt(acc) + hp.get("eps", 1e-10))
    elif kind == "sgd":
        mom = hp.get("momentum", 0.0)
        for n in names:
            gn = g[n] + wd * p[n]
            m = mom * st["mu"][n] + gn
            out[n] = p[n] - lr * ((gn + mom * m) if hp.get("nesterov") else m)
    elif kind == "muon":
        lo = layout.of(names[0])
        nd = p[names[0]].dim() + (lo.layer is not None)
        if nd in (2, 3):
            ms = {n: hp.get("momentum", 0.95) * st["mu"][n] + g[n] for n in names}
            if nd == 3:
                groups = [([n], False) for n in names]
            else:
                groups = [(names, lo.layer is not None)]
            for members, stacked in groups:
                if stacked:
                    o = _ns64(torch.stack([ms[n] for n in members]))
                else:
                    x = ms[members[0]]
                    o = _ns64(x.T if lo.transpose else x)
                scale = max(1.0, o.shape[-2] / o.shape[-1]) ** 0.5
                for i, n in enumerate(members):
                    oi = o[i] if stacked else (o.T if lo.transpose else o)
                    out[n] = p[n] - lr * scale * oi - lr * wd * p[n]
        else:
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for n in names:
                out[n] = p[n] - 3e-4 * snap["lr_scale"] * (
                    adam_dir(n, c1, c2, 1e-8, "fb_state.mu", "fb_state.nu") + wd * p[n])
    elif kind in ("onebitadam", "zerooneadam"):
        gc_ = compressed(names)
        for n in names:
            m = b1 * st["mu"][n] + (1 - b1) * gc_[n]
            out[n] = p[n] - lr * (m / (torch.sqrt(st["nu"][n]) + hp.get("eps", 1e-8))
                                  + wd * p[n])
    elif kind == "onebitlamb":
        gc_ = compressed(names)
        u = {n: (b1 * st["mu"][n] + (1 - b1) * gc_[n])
             / (torch.sqrt(st["nu"][n]) + hp.get("eps", 1e-6)) + wd * p[n] for n in names}
        t = trust(u)
        out = {n: p[n] - lr * t * u[n] for n in names}
    else:
        raise ValueError(kind)
    return out


def check_against_f64(eng, kind: str, snap: dict, hp_of, what: str, layout) -> dict:
    """Every leaf of ``eng`` after the snapshotted update against the
    float64 update of the same params, grads and state: (leaf -> relative
    Frobenius error), raising above ``OPT_CHECK_TOL``. ``hp_of(name)`` gives
    a leaf's hyperparameters and its group's state paths prefix."""
    import torch

    dev = eng.device
    rel = {}
    by_group = {}
    for n in eng.state.params:
        by_group.setdefault(hp_of(n)[1], []).append(n)
    for prefix, members in by_group.items():
        hp = hp_of(members[0])[0]
        state = {f[len(prefix):]: ts for f, ts in snap["state"].items() if f.startswith(prefix)}
        scalars = {k[len(prefix):]: v for k, v in snap["scalars"].items() if k.startswith(prefix)}
        gsnap = dict(snap, state=state, scalars=scalars)
        for path, names in layout.paths(members).items():
            ref = reference_update(kind, hp, names, layout, gsnap, dev)
            for n in names:
                got = eng.state.params[n].detach().double()
                rel[n] = float((got - ref[n]).norm() / ref[n].norm().clamp_min(1e-30))
            del ref
    worst = max(rel, key=rel.get)
    log(f"  {what}: step {OPT_CHECK_STEP}'s update against float64, worst leaf {worst} "
        f"{rel[worst]:.2e} (tol {OPT_CHECK_TOL:g})")
    torch.cuda.empty_cache()
    return rel


def _hp_of(case: dict):
    """A function giving each leaf's (hyperparameters, state-path prefix)."""
    import re

    from deepspeed_tpu_torch.models.convert import jax_leaf
    from deepspeed_tpu_torch.ops.optimizers import get_optimizer

    def hp(params):
        # the factory's defaults, then what the config sets (the hyperparams
        # of some optimizers leave out weight_decay or nesterov)
        return {**get_optimizer(case["type"], **params).hyperparams, **params}

    base = hp(case["params"])
    groups = case.get("param_groups")
    if not groups:
        return lambda n: (base, "")
    hps = [hp({**case["params"], **{k: v for k, v in g.items() if k != "pattern"}})
           for g in groups + [{}]]

    def of(n):
        path = jax_leaf(n)[0]
        i = next((i for i, g in enumerate(groups) if re.search(g["pattern"], path)),
                 len(groups))
        return hps[i], f"{i}."
    return of


def opt_run(seed: int, cfg, case: dict, batch, steps: int, arena=None, optimizer=None,
            counters=(), check=True, stage=0, label="", ref_case=None, ref_layout=None):
    """``steps`` of ``train_batch`` with optimizer ``case`` (a config block)
    at ZeRO ``stage``; with ``check``, the update of step OPT_CHECK_STEP
    held to float64 (the reference's hyperparameters from ``ref_case``, its
    layout ``ref_layout``: by default the run's own): (losses, grad norms,
    step seconds, peak bytes, leaf errors, the engine)."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import llama

    conf = _train_config(seed, 2, True)
    conf["optimizer"] = case
    conf["zero_optimization"] = {"stage": stage}
    gc.collect()
    torch.cuda.empty_cache()
    eng, *_ = dst.initialize(model=llama.model_spec(cfg), config=conf, optimizer=optimizer)
    snap = SnapshotOptimizer(eng, arena, OPT_CHECK_STEP) if check else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    losses, norms, step_s, peaks = [], [], [], []
    rel = {}
    for i in range(steps):
        t0 = time.perf_counter()
        out = eng.train_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out.loss))
        norms.append(float(out.grad_norm))
        if check and i + 1 == OPT_CHECK_STEP:
            peaks.append(torch.cuda.max_memory_allocated())
            ref_case = ref_case or case
            rel = check_against_f64(eng, ref_case["type"], snap.snap, _hp_of(ref_case),
                                    label or case["type"], ref_layout or eng.layout)
            torch.cuda.reset_peak_memory_stats()
    peaks.append(torch.cuda.max_memory_allocated())
    return losses, norms, step_s, max(peaks), rel, eng


@contextlib.contextmanager
def fault_wrong_beta1(case: dict):
    """The card's optimizer built with beta1 0.8 instead of the config's."""
    params = dict(case["params"])
    params["betas"] = (0.8, params.get("betas", (0.9, 0.999))[1])
    yield dict(case, params=params), "the card's beta1 0.8 (the reference's 0.9)"


@contextlib.contextmanager
def fault_muon_port_orientation():
    """Muon's layout without the transposes: the scale taken from the port's
    [out, in] leaves (w_gate: sqrt(3.5) instead of 1)."""
    from deepspeed_tpu_torch.ops import optimizers as topt

    sound = topt.Layout.for_model.__func__

    def faulty(cls, *a, **kw):
        lay = sound(cls, *a, **kw)
        lay.leaves = {k: v._replace(transpose=False) for k, v in lay.leaves.items()}
        return lay

    topt.Layout.for_model = classmethod(faulty)
    try:
        yield "Muon's scale from the port's [out, in] orientation"
    finally:
        topt.Layout.for_model = classmethod(sound)


def phase_optimizers(seed: int, card: str, train: dict) -> dict:
    """Phase 7's configuration under every optimizer (module docstring,
    phase 22)."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import optimizers as topt
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                         flash_bwd_dq_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=4)
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (2, 4096 + 1)).astype(np.int32)}
    kernels = {"flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda, "rms_norm": rms_norm_cuda}
    total = {k: 0 for k in kernels}
    per_step = {k: (2 * cfg.num_layers + 1) * 2 if k == "rms_norm" else cfg.num_layers * 2
                for k in kernels}

    def count(steps, what):
        got = {k: c.launches for k, c in kernels.items()}
        check_launches(what, got, {k: n * steps for k, n in per_step.items()})
        for k in total:
            total[k] += got[k]

    res = {"chunk_bytes": topt.CHUNK_BYTES}
    # (a) the multi-tensor AdamW (phase 7's run) against its per-leaf loop
    losses, norms, step_s, peak, _, eng = opt_run(
        seed, cfg, OPTIMIZER_CASES["adamw"], batch, TRAIN_STEPS, optimizer=loop_adamw(),
        counters=kernels.values(), check=False)
    count(TRAIN_STEPS, "AdamW per-leaf loop")
    wall, busy, n_k, top = profile_window(lambda: eng.train_batch(batch))
    groups = {}
    for k, ms, c in top:
        gname = next((g for g, keys in PROFILE_GROUPS if any(x in k for x in keys)), "other")
        groups[gname] = groups.get(gname, 0.0) + ms
    del eng
    loop = {"losses": losses, "step_ms": sum(step_s[1:]) / len(step_s[1:]) * 1e3,
            "peak_bytes": peak, "elementwise_ms": groups.get("elementwise", 0.0),
            "busy_ms": busy * 1e3, "kernels": n_k, "by_group_ms": groups}
    fe = {"losses": train["losses"], "step_ms": train["step_ms"],
          "peak_bytes": train["peak_mem_bytes"],
          "elementwise_ms": train["profile"]["by_group_ms"].get("elementwise", 0.0),
          "foreach_ms": train["profile"]["by_group_ms"].get("foreach", 0.0),
          "busy_ms": train["profile"]["busy_ms"], "kernels": train["profile"]["kernels"]}
    same = fe["losses"] == loop["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(fe["losses"], loop["losses"]))
    log(f"  AdamW multi-tensor (phase 7): step {fe['step_ms']:.1f} ms, elementwise "
        f"{fe['elementwise_ms']:.1f} ms + foreach {fe['foreach_ms']:.1f} ms, {fe['kernels']} "
        f"kernels, peak "
        f"{fe['peak_bytes'] / 2**30:.2f} GiB; per-leaf loop: step {loop['step_ms']:.1f} ms, "
        f"elementwise {loop['elementwise_ms']:.1f} ms, {n_k} kernels, peak "
        f"{loop['peak_bytes'] / 2**30:.2f} GiB (PR 12: 289.7 / 139.6 ms, 41.66 GiB); losses "
        f"{'bit for bit' if same else f'within {err:.2e}'} [{card}]")
    if err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"multi-tensor AdamW losses {fe['losses']} against the loop's "
                             f"{loop['losses']}")
    if fe["peak_bytes"] > loop["peak_bytes"] + topt.CHUNK_BYTES:
        raise AssertionError(f"multi-tensor AdamW peak {fe['peak_bytes']} above the loop's "
                             f"{loop['peak_bytes']} + one chunk")
    res["adamw"] = {"multi_tensor": fe, "loop": loop, "losses_bitwise": same,
                    "losses_rel_err": err}

    # (b) every optimizer, 3 steps, the second step's update against float64
    # the snapshot: params, grads and up to three state tensors a leaf (fp32)
    nbytes = int(sum(int(np.prod(s)) for s, _ in llama.param_shapes(cfg).values()) * 4 * 5.05)
    t0 = time.perf_counter()
    arena = HostArena(nbytes)
    log(f"  pinned host arena {nbytes / 1e9:.1f} GB in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for name, case in OPTIMIZER_CASES.items():
        losses, norms, step_s, peak, rel, eng = opt_run(
            seed, cfg, case, batch, OPT_STEPS, arena=arena, counters=kernels.values(),
            label=name)
        count(OPT_STEPS, name)
        del eng
        worst = max(rel, key=rel.get)
        # the step after the checked one: the checked step also copies the
        # snapshot to the host
        runs[name] = {"losses": losses, "grad_norms": norms, "step_s": step_s,
                      "step_ms": step_s[OPT_CHECK_STEP] * 1e3,
                      "peak_bytes": peak, "worst_leaf": worst, "worst_rel": rel[worst]}
        log(f"  {name}: losses {['%.4f' % l for l in losses]}, step "
            f"{runs[name]['step_ms']:.1f} ms, peak {peak / 2**30:.2f} GiB [{card}]")
        if rel[worst] > OPT_CHECK_TOL or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: leaf {worst} {rel[worst]:.3g} from float64 "
                                 f"(losses {losses})")
    res["runs"] = runs

    # (c) planted faults: a wrong beta1 (LAMB), Muon's scale in the port's orientation
    sound_layout = topt.Layout.for_model(cfg, llama.param_shapes(cfg))
    faults = {}
    with fault_wrong_beta1(OPTIMIZER_CASES["lamb"]) as (bad_case, what):
        *_, rel, eng = opt_run(seed, cfg, bad_case, batch, OPT_CHECK_STEP, arena=arena,
                               label=f"planted fault ({what})",
                               ref_case=OPTIMIZER_CASES["lamb"])
        del eng
    faults["wrong_beta1"] = max(rel.values())
    with fault_muon_port_orientation() as what:
        *_, rel, eng = opt_run(seed, cfg, OPTIMIZER_CASES["muon"], batch, OPT_CHECK_STEP,
                               arena=arena, label=f"planted fault ({what})",
                               ref_layout=sound_layout)
        del eng
    faults["muon_orientation"] = max(rel.values())
    for k, v in faults.items():
        if v <= OPT_CHECK_TOL:
            raise AssertionError(f"the float64 check passes a planted fault ({k}: {v:.3g})")
    res["planted_faults"] = faults
    arena.close()
    del arena
    gc.collect()

    # (d) LAMB and Muon at ZeRO stages 1-3 against stage 0, NCCL world 1
    comm.init_distributed()
    zero = {}
    try:
        comm.init_mesh({"data": 1})
        for name in ("lamb", "muon"):
            base = None
            for stage in ZERO_STAGES:
                losses, norms, step_s, peak, _, eng = opt_run(
                    seed, cfg, OPTIMIZER_CASES[name], batch, OPT_ZERO_STEPS,
                    counters=kernels.values(), check=False, stage=stage)
                count(OPT_ZERO_STEPS, f"{name} ZeRO-{stage}")
                state = {k: v.detach().clone() for k, v in eng.state.params.items()} \
                    if stage == 0 else None
                same = stage == 0 or (losses == base["losses"] and norms == base["norms"] and
                                      all(torch.equal(eng.state.params[k], base["params"][k])
                                          for k in base["params"]))
                del eng
                if stage == 0:
                    base = {"losses": losses, "norms": norms, "params": state}
                zero[f"{name}_s{stage}"] = {"losses": losses, "grad_norms": norms,
                                            "step_ms": sum(step_s[1:]) / len(step_s[1:]) * 1e3,
                                            "peak_bytes": peak, "bitwise_stage0": same}
                log(f"  {name} ZeRO-{stage}: losses {['%.4f' % l for l in losses]}, step "
                    f"{zero[f'{name}_s{stage}']['step_ms']:.1f} ms, peak {peak / 2**30:.2f} GiB, "
                    f"bit for bit against ZeRO-0 (losses, grad norms, params): {same} [{card}]")
                if not same:
                    raise AssertionError(f"{name} at ZeRO-{stage} differs from ZeRO-0")
            del base
            torch.cuda.empty_cache()
    finally:
        comm.set_mesh(None)
        dist.destroy_process_group()
    res["zero"] = zero
    res["launches"] = total
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 22: {res['phase_s']:.1f} s; launches {total}")
    return res


# --------------------------------------------------------------------------- #
# phase 23: EXAONE-4.0-32B
# --------------------------------------------------------------------------- #
EXA_TRAIN_LAYERS = 4           # one LLLG period: 3 sliding layers and a global one
EXA_TRAIN_SEQ = 2048           # plain attention keeps fp32 scores and probabilities
EXA_TRAIN_STEPS = 3
EXA_MAX_SEQ = 5248             # 41 blocks of 128: the 5120-token prompts and 32 tokens
EXA_LENGTHS = (5120, 64, 200, 5120, 333, 512, 777, 1024)
EXA_SPLIT = 512                # split_prefill_chunk: bounds a prefill's fp32 scores
EXA_BLOCKS = 160               # pool blocks of 128 (the 8 prompts need ~115)
EXA_CHECK_LAYERS = 4           # the fp32-reference checks: one LLLG period
EXA_CHECK_SEQ = 128            # the card-vs-CPU step's tokens (cut from 256 for the CPU's
                               # time; its worst leaf read 0.0284 at 128 on the H100, 0.0279
                               # at 256)
EXA_SERVE_LAYERS = 4           # serving depth, one LLLG period (64 -> 16 -> 8 -> 4 for the
                               # smoke's time)


def exaone_cfg(layers=None):
    from deepspeed_tpu_torch.models import exaone4

    cfg = exaone4.Exaone4Config.exaone4_32b(max_seq_len=EXA_MAX_SEQ)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def exaone_prompts(seed: int, vocab: int):
    rs = np.random.RandomState(seed + 23)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in EXA_LENGTHS]


@contextlib.contextmanager
def fault_rope_on_global():
    """RoPE on EXAONE-4's global layers too (they have none)."""
    from deepspeed_tpu_torch.models import exaone4

    sound = exaone4.layer_scalars
    exaone4.layer_scalars = lambda cfg: [(w, True) for w, _ in sound(cfg)]
    try:
        yield "RoPE applied on the global layers"
    finally:
        exaone4.layer_scalars = sound


@contextlib.contextmanager
def fault_exaone_cache_write_late():
    """Every K/V row of the dense cache lands one slot late."""
    from deepspeed_tpu_torch.models import exaone4

    sound = exaone4._write_cache
    exaone4._write_cache = lambda cache, new, starts: sound(cache, new, starts + 1)
    try:
        yield "each K/V row written one cache slot late"
    finally:
        exaone4._write_cache = sound


def v1_groups(eng, prompts, new: int, eos=None):
    """v1 ``generate`` over ``prompts`` a group at a time (each long prompt
    alone, the rest together: a batch's dense plain-attention prefill holds
    fp32 scores of its longest row for every row) → one stream a prompt."""
    long_ = [i for i, p in enumerate(prompts) if len(p) > 2048]
    short = [i for i in range(len(prompts)) if i not in long_]
    outs = {}
    for group in [[i] for i in long_] + [short]:
        t = max(len(prompts[i]) for i in group)
        batch = np.zeros((len(group), t), np.int32)
        for j, i in enumerate(group):
            batch[j, :len(prompts[i])] = prompts[i]
        got = eng.generate(batch, prompt_lengths=np.array([len(prompts[i]) for i in group]),
                           max_new_tokens=new, eos_token_id=eos)
        for j, i in enumerate(group):
            outs[i] = [int(x) for x in got[j]]
    return [outs[i] for i in range(len(prompts))]


def layers_of(params, n: int) -> dict:
    """A flat param dict's leaves of its first ``n`` layers and the rest."""
    return {k: v for k, v in params.items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}


def fp32_gaps(family, cfg, params, prompts, outs, routes=None, keys=None,
              forward=None) -> tuple:
    """Each generated token against the fp32 forward of the same weights
    over its row's prompt and the tokens before it: (argmax matches, tokens,
    largest (max logit - the token's logit) / row RMS). With ``routes`` (a
    MoE family's :class:`PositionRoutes`, ``keys[i]`` prompt i's key) the
    fp32 forward routes every position as the serving run did; ``forward``
    (tokens [1, s] -> logits) replaces ``family.apply`` in fp32."""
    import torch

    match, n, worst = 0, 0, 0.0
    for i, (p, toks) in enumerate(zip(prompts, outs)):
        seq = torch.as_tensor(np.concatenate([p, np.asarray(toks[:-1], np.int32)]),
                              device=params["embed"].device)[None]
        replay = (routes_replayed(routes.of(keys[i], seq.shape[1])) if routes is not None
                  else contextlib.nullcontext())
        with torch.inference_mode(), replay:
            z = (forward(seq) if forward is not None else logits_of(family.apply(
                cfg, params, seq, compute_dtype=torch.float32)))[0, len(p) - 1:]
        rms = z.pow(2).mean(-1).sqrt()
        t = torch.as_tensor(toks, device=z.device)
        gap = (z.max(-1).values - z.gather(-1, t[:, None])[:, 0]) / rms
        match += int((z.argmax(-1) == t).sum())
        n += len(toks)
        worst = max(worst, float(gap.max()))
        del z
    return match, n, worst


def phase_exaone4(seed: int, card: str) -> dict:
    """EXAONE-4.0-32B (module docstring, phase 23)."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import exaone4
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                         flash_bwd_dq_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

    t_phase = time.perf_counter()
    res = {}
    # (a) training at 4 layers, AdamW with the no-decay group
    cfg4 = exaone_cfg(EXA_TRAIN_LAYERS)
    conf = _train_config(seed, 2, True)
    conf["optimizer"] = OPTIMIZER_CASES["adamw_groups"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng, *_ = dst.initialize(model=exaone4.model_spec(cfg4), config=conf)
    n_params = sum(p.numel() for p in eng.state.params.values())
    pattern = "".join("L" if t == "sliding_attention" else "G"
                      for t in cfg4.resolved_layer_types())
    log(f"  training engine: {cfg4.num_layers} layers ({pattern}) at EXAONE-4.0-32B width, "
        f"{n_params / 1e9:.3f} B params, set-up {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg4.vocab_size, (2, EXA_TRAIN_SEQ + 1)).astype(np.int32)}
    kernels = {"rms_norm": rms_norm_cuda, "flash_fwd": flash_fwd_cuda,
               "flash_bwd_dq": flash_bwd_dq_cuda, "flash_bwd_dkv": flash_bwd_dkv_cuda}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in kernels.values():
        c.launches = 0
    losses, step_s = [], []
    for _ in range(EXA_TRAIN_STEPS):
        t0 = time.perf_counter()
        out = eng.train_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out.loss))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: c.launches for k, c in kernels.items()}
    per_fwd = 4 * cfg4.num_layers + 1
    check_launches("EXAONE-4 training (the hybrid attention is masked: plain, no flash)",
                   launches, {"rms_norm": per_fwd * 2 * EXA_TRAIN_STEPS, "flash_fwd": 0,
                              "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"EXAONE-4 training loss not finite and falling: {losses}")
    res["train"] = {"losses": losses, "step_s": step_s,
                    "step_ms": sum(step_s[1:]) / len(step_s[1:]) * 1e3, "peak_bytes": peak,
                    "launches": launches, "rms_norm_per_step": launches["rms_norm"] //
                    EXA_TRAIN_STEPS, "n_params": n_params}
    log(f"  losses {['%.4f' % l for l in losses]}, step {res['train']['step_ms']:.1f} ms, "
        f"RMSNorm {res['train']['rms_norm_per_step']} a step, peak {peak / 2**30:.2f} GiB "
        f"[{card}]")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (b) one step card (bf16) against CPU (fp32) at 4 layers, S EXA_CHECK_SEQ
    res["train_whole_path"] = phase_train_whole(
        seed, card, family=exaone4, cfg=cfg4, label="EXAONE-4.0-32B-width",
        fault=fault_rope_on_global, layers=EXA_TRAIN_LAYERS, seq=EXA_CHECK_SEQ)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) serving at EXA_SERVE_LAYERS: one set of bf16 weights, v2 and v1
    cfg = exaone_cfg(EXA_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = exaone4.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                          dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"  serving weights: {cfg.num_layers} layers, {cfg.num_params / 1e9:.2f} B params, "
        f"{wbytes / 1e9:.2f} GB bf16 in {time.perf_counter() - t0:.1f} s; RoPE plain at "
        f"theta {cfg.rope_theta:g} (the published llama3 rope_scaling is implemented by "
        f"neither package)")
    prompts = exaone_prompts(seed, cfg.vocab_size)
    sp = [np.concatenate([s, s, s])[:len(p)] for p, s in
          ((p, p[:len(p) // 3 + 1]) for p in prompts)]
    base = {"dtype": "bfloat16", "prefill_bucket": 64, "split_prefill_chunk": EXA_SPLIT,
            "ragged": {"max_tracked_sequences": 8, "max_ragged_batch_size": 8,
                       "memory_config_blocks": EXA_BLOCKS, "block_size": 128}}
    warm = (prompts[1], prompts[2], prompts[4])
    serve = phase_spec_serving(
        seed, MAX_NEW_TOKENS, card, family=exaone4, cfg=cfg, params=params,
        norms_per_layer=4, base_conf=base, warm=warm,
        engines=(("bf16", {}, prompts), ("spec_int8", {**SPEC, **INT8}, sp)))
    res["serving"] = serve
    v2_outs = serve["bf16"]["outs"]
    for name in ("bf16", "spec_int8"):
        w = serve[name]["per_replay"]
        if w.get("paged_decode_attention", w.get("paged_decode_attention_int8")) != \
                cfg.num_layers:
            raise AssertionError(f"{name}: a decode replay launches {w}, not "
                                 f"{cfg.num_layers} paged decodes")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v1 = dst.init_inference(exaone4, model_cfg=cfg, params=params,
                            config={"dtype": "bfloat16", "prefill_bucket": 64})
    v1.generate(np.asarray(prompts[1])[None], max_new_tokens=2)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms_norm_cuda.launches = 0
    v1_outs = v1_groups(v1, prompts, MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    v1_s = time.perf_counter() - t0
    v1_launches = rms_norm_cuda.launches
    check_launches("v1 generate (3 groups)", {"rms_norm": v1_launches},
                   {"rms_norm": (4 * cfg.num_layers + 1) * MAX_NEW_TOKENS * 3})
    leave = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(v1_outs, v2_outs)]
    res["v1"] = {"generate_s": v1_s, "peak_bytes": torch.cuda.max_memory_allocated(),
                 "launches": {"rms_norm": v1_launches}, "outs": v1_outs,
                 "v1_v2_first_difference": leave,
                 "agree_rows": sum(x is None for x in leave)}
    log(f"  v1 bf16 (3 groups): {v1_s:.1f} s, peak {res['v1']['peak_bytes'] / 2**30:.2f} GiB; "
        f"v1 against v2 at {cfg.num_layers} layers: {res['v1']['agree_rows']} of "
        f"{len(prompts)} rows the same {MAX_NEW_TOKENS} tokens, first differing step by row "
        f"{leave} [{card}]")
    del v1
    gc.collect()
    torch.cuda.empty_cache()

    # (d) at 4 layers (LLLG) against the fp32 forward of the same weights
    small = dataclasses.replace(cfg, num_layers=EXA_CHECK_LAYERS)
    sp4 = layers_of(params, EXA_CHECK_LAYERS)
    long_ = torch.as_tensor(prompts[0], device="cuda")[None]
    with torch.inference_mode():
        z32 = exaone4.apply(small, sp4, long_, compute_dtype=torch.float32)
        z16 = exaone4.apply(small, sp4, long_, compute_dtype=torch.bfloat16)
    noise = row_err(z16, z32)[1]
    tol = V1_NOISE_RATIO * noise
    del z16
    log(f"  {EXA_CHECK_LAYERS} layers: the bf16 no-cache forward against fp32 on the "
        f"{len(prompts[0])}-token prompt {noise:.4f} of a row's RMS; limit {tol:.4f}")
    v1s = dst.init_inference(exaone4, model_cfg=small, params=sp4,
                             config={"dtype": "bfloat16", "prefill_bucket": 64})
    pre, _ = v1_prefill_logits(v1s, np.asarray(prompts[0])[None],
                               np.array([len(prompts[0])], np.int32))
    pre_err = check_close(f"v1 prefill logits ({len(prompts[0])} tokens, {EXA_CHECK_LAYERS} "
                          f"layers) against the fp32 forward", pre[:, :len(prompts[0])],
                          z32, tol)[1]
    del pre, z32
    checks = {}
    for name, outs in (("v1", v1_groups(v1s, prompts, MAX_NEW_TOKENS)),):
        checks[name] = fp32_gaps(exaone4, small, sp4, prompts, outs)
    with fault_exaone_cache_write_late() as what:
        bad = v1_groups(v1s, prompts[1:3], 8)
    bad_gap = fp32_gaps(exaone4, small, sp4, prompts[1:3], bad)[2]
    del v1s
    torch.cuda.empty_cache()
    for extra_name, extra in (("v2 bf16", {}), ("v2 spec + fused verify, int8 pools",
                                                 {**SPEC, **INT8})):
        e2 = build_engine_v2(exaone4, small, sp4, config=dict(base, **extra))
        checks[extra_name] = fp32_gaps(exaone4, small, sp4, prompts,
                                       e2.generate(prompts, max_new_tokens=MAX_NEW_TOKENS))
        del e2
        torch.cuda.empty_cache()
    for name, (m, n, worst) in checks.items():
        log(f"  {name} at {EXA_CHECK_LAYERS} layers: {m}/{n} tokens the fp32 argmax, largest "
            f"gap {worst:.4f} of the row's RMS (limit {tol:.4f})")
        if worst > tol:
            raise AssertionError(f"{name}: a generated token is {worst} row RMS below the "
                                 f"fp32 argmax")
    log(f"  planted fault ({what}): largest gap {bad_gap:.4f} (must exceed {tol:.4f})")
    if bad_gap <= tol:
        raise AssertionError(f"the EXAONE-4 stream check passes a planted fault ({what})")
    res["check"] = {"noise": noise, "tol": tol, "prefill_err": pre_err,
                    "streams": {k: {"argmax": [m, n], "worst_gap": w}
                                for k, (m, n, w) in checks.items()},
                    "planted_fault_gap": bad_gap}
    del params, sp4
    gc.collect()
    torch.cuda.empty_cache()
    l2 = serve["bf16"]["launches"]
    l8 = serve["spec_int8"]["launches"]
    res["launches"] = {
        "rms_norm_training": launches["rms_norm"],
        "rms_norm_serving": l2["rms_norm"] + l8["rms_norm"] + v1_launches,
        "paged_decode_attention": l2["paged_decode_attention"],
        "paged_decode_attention_int8": l8["paged_decode_attention_int8"],
        "paged_spec_verify_attention": l8["paged_spec_verify_attention"]}
    res["weight_bytes"] = wbytes
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 23: {res['phase_s']:.1f} s")
    return res


MIX_TRAIN_LAYERS = 2           # Mixtral-8x7B width: 3.17 B parameters, fp32 masters + AdamW
MIX_SERVE_LAYERS = 4           # 11.8 GB of bf16 weights (32 layers' 93 GB fit no card;
                               # 16 -> 8 -> 4 for the smoke's time)
MIX_CHECK_LAYERS = 2           # the fp32-reference checks
MIX_SEQ = 4096                 # tokens a training micro-batch
MIX_CHECK_SEQ = 128            # tokens of the card-vs-CPU step (256 in phase 8: the CPU's time)
# the einsum and compact dispatches of one layer against each other: the
# same expert products in bf16, summed in another order (one rounding step
# of |y| < 8 is <= 0.031, as RMS_TOL reads it)
DISPATCH_TOL = RMS_TOL


def mixtral_cfg(layers: int):
    from deepspeed_tpu_torch.models import mixtral

    return dataclasses.replace(mixtral.MixtralConfig(), num_layers=layers)


@contextlib.contextmanager
def card_routes_on_cpu():
    """The CPU's gating routes as the card's did: its i-th top-k takes the
    experts of the card's i-th (on the CPU's own fp32 probabilities), since
    the top-k of bf16 router logits flips near-ties and a flipped route
    moves its token's whole gradient (module docstring, phase 24 b). Yields
    the share of (token, level) routes each CPU gating would have chosen
    otherwise, by call."""
    from deepspeed_tpu_torch.moe import sharded_moe

    sound, card, flipped = sharded_moe.top_k, [], []

    def routed(probs, k):
        vals, idx = sound(probs, k)
        if probs.is_cuda:
            card.append(idx.cpu())
            return vals, idx
        theirs = card[len(flipped)]
        flipped.append(float((idx != theirs).float().mean()))
        return probs.gather(-1, theirs), theirs

    sharded_moe.top_k = routed
    try:
        yield flipped
    finally:
        sharded_moe.top_k = sound


@contextlib.contextmanager
def fault_unnormalized_gates():
    """Planted: the card's gating keeps the raw top-k probabilities (the
    renormalization left out), the CPU's stays sound."""
    from deepspeed_tpu_torch.moe import layer

    sound = layer.top_k_gating_compact

    def faulty(logits, *a, **kw):
        if logits.is_cuda:
            kw["norm_topk"] = False
        return sound(logits, *a, **kw)

    layer.top_k_gating_compact = faulty
    try:
        yield "top-k gates left unrenormalized on the card"
    finally:
        layer.top_k_gating_compact = sound


@contextlib.contextmanager
def routes_recorded():
    """Every gating's experts ([T, k], in call order) while the context is
    open."""
    from deepspeed_tpu_torch.moe import sharded_moe

    sound, tape = sharded_moe.top_k, []

    def recording(probs, k):
        vals, idx = sound(probs, k)
        tape.append(idx.detach().cpu())
        return vals, idx

    sharded_moe.top_k = recording
    try:
        yield tape
    finally:
        sharded_moe.top_k = sound


@contextlib.contextmanager
def routes_replayed(tape):
    """Each gating takes the next experts of ``tape`` (on its own
    probabilities) instead of its own top-k."""
    from deepspeed_tpu_torch.moe import sharded_moe

    sound, it = sharded_moe.top_k, iter(tape)

    def replaying(probs, k):
        idx = next(it).to(probs.device)
        return probs.gather(-1, idx), idx

    sharded_moe.top_k = replaying
    try:
        yield
    finally:
        sharded_moe.top_k = sound


def routed_noise(family, cfg, params, toks) -> float:
    """The bf16 forward's largest row error over the row's RMS against the
    fp32 forward that routes every token as the bf16 one did (a route that
    flips on a near-tie moves its token wholesale, which is no arithmetic
    error)."""
    import torch

    with torch.inference_mode():
        with routes_recorded() as tape:
            z16 = logits_of(family.apply(cfg, params, toks, compute_dtype=torch.bfloat16))
        with routes_replayed(tape):
            z32 = logits_of(family.apply(cfg, params, toks, compute_dtype=torch.float32))
    return row_err(z16, z32)[1]


class PositionRoutes:
    """The experts each forward of a serving run gave each (sequence,
    position), the last forward's winning (a position a rolled-back verify
    wrote is written again), per layer. A sequence is keyed by its first
    KV block (v2) or its batch row (v1)."""

    def __init__(self, layers: int):
        self.layers, self.map, self.first_keys = layers, {}, None

    def add(self, entries, keys, ctx, valid) -> None:
        t = valid.shape[1]
        for l, idx in enumerate(entries):
            idx = idx.view(len(keys), t, -1)
            for r, key in enumerate(keys):
                if key is None:
                    continue
                for j in np.nonzero(valid[r])[0]:
                    self.map[(key, int(ctx[r]) + int(j), l)] = idx[r, j]
        if self.first_keys is None:
            self.first_keys = keys

    def of(self, key, n: int) -> list:
        """Per layer, the [n, k] experts of positions 0..n-1 of ``key``."""
        import torch

        return [torch.stack([self.map[(key, p, l)] for p in range(n)])
                for l in range(self.layers)]


@contextlib.contextmanager
def v2_routes(eng, layers: int):
    """Every paged forward of a v2 engine (prefill, eager decode, verify)
    with the experts it routed each (sequence, position) to; the first
    forward's rows (the admission burst) give the prompts' keys."""
    import torch

    sound, pr = eng._forward, PositionRoutes(layers)

    def host(x):
        return torch.as_tensor(x).cpu().numpy()

    def recorded(tokens, tables, ctx, valid):
        tb, c, v = host(tables), host(ctx), host(valid).astype(bool)
        with routes_recorded() as tape:
            out = sound(tokens, tables, ctx, valid)
        keys = [int(k) if k else None for k in tb[:, 0]]
        pr.add(tape[-layers:], keys, c, v)
        return out

    eng._forward = recorded
    try:
        yield pr
    finally:
        eng._forward = sound


@contextlib.contextmanager
def v1_routes(eng, layers: int):
    """The same for a v1 engine's dense-cache forwards (rows: the batch)."""
    import torch

    sound, pr = eng._apply_cached, PositionRoutes(layers)

    def recorded(tokens, cache, cache_len):
        b, t = tokens.shape
        c = torch.as_tensor(cache_len).expand(b).cpu().numpy()
        with routes_recorded() as tape:
            out = sound(tokens, cache, cache_len)
        pr.add(tape[-layers:], list(range(b)), c, np.ones((b, t), bool))
        return out

    eng._apply_cached = recorded
    try:
        yield pr
    finally:
        eng._apply_cached = sound


def phase_mixtral(seed: int, card: str) -> dict:
    """Mixtral-8x7B (module docstring, phase 24)."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import mixtral
    from deepspeed_tpu_torch.moe.layer import MoELayer
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

    t_phase = time.perf_counter()
    res = {}
    # (a) training at 2 layers through train_batch (einsum dispatch)
    gc.collect()
    torch.cuda.empty_cache()
    res["train"] = phase_train(seed, card, family=mixtral, cfg=mixtral_cfg(MIX_TRAIN_LAYERS),
                               label="Mixtral-8x7B", seq=MIX_SEQ, gas=2, micro=1)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one step card (bf16) against CPU (fp32) at 2 layers, S 256, the
    # CPU routing each token as the card did
    with card_routes_on_cpu() as flipped:
        res["train_whole_path"] = phase_train_whole(
            seed, card, family=mixtral, cfg=mixtral_cfg(MIX_TRAIN_LAYERS),
            label="Mixtral-8x7B-width", fault=fault_unnormalized_gates,
            layers=MIX_TRAIN_LAYERS, seq=MIX_CHECK_SEQ)
    res["train_whole_path"]["route_difference_by_layer"] = flipped
    log(f"  routes (token, level) the CPU's own fp32 gating would choose otherwise than the "
        f"card's bf16 one, by layer: {['%.4f' % d for d in flipped]}")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) serving at MIX_SERVE_LAYERS: one set of bf16 weights, v2 and v1
    cfg = mixtral_cfg(MIX_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = mixtral.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                          dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    log(f"  serving weights: {cfg.num_layers} layers, {cfg.num_params / 1e9:.2f} B params, "
        f"{wbytes / 1e9:.2f} GB bf16 in {time.perf_counter() - t0:.1f} s; a decode step "
        f"reads every expert (no-drop routing of every slot): bound {bound_ms:.2f} ms")
    prompts, lengths = spec_prompts(seed, cfg.vocab_size)
    serve = phase_spec_serving(
        seed, MAX_NEW_TOKENS, card, family=mixtral, cfg=cfg, params=params,
        engines=(("bf16", {}, prompts), ("spec", SPEC, prompts), ("int8", INT8, prompts)))
    res["serving"] = serve
    for name in ("bf16", "spec", "int8"):
        w = serve[name]["per_replay"]
        if w.get("paged_decode_attention", w.get("paged_decode_attention_int8")) != \
                cfg.num_layers:
            raise AssertionError(f"{name}: a decode replay launches {w}, not "
                                 f"{cfg.num_layers} paged decodes")
    busy = serve["bf16"]["profile_steps"]["busy_ms_per_step"]
    res["decode"] = {"step_ms": serve["bf16"]["decode_step_ms"], "busy_ms": busy,
                     "bound_ms": bound_ms, "weight_bytes": wbytes}
    log(f"  bf16 decode step {serve['bf16']['decode_step_ms']:.2f} ms (device busy "
        f"{busy:.2f} ms) against the weight-bytes bound {bound_ms:.2f} ms [{card}]")

    # v1 on the same weights; where its stream parts from v2's bf16 one, the
    # fp32 margin between the two tokens against the bf16 error (phase 21)
    gc.collect()
    torch.cuda.empty_cache()
    v1 = dst.init_inference(mixtral, model_cfg=cfg, params=params,
                            config={"dtype": "bfloat16", "prefill_bucket": 64})
    padded = np.zeros((len(prompts), max(lengths)), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lens = np.array(lengths, np.int32)
    v1.generate(padded[:2], prompt_lengths=lens[:2], max_new_tokens=2)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms_norm_cuda.launches = 0
    t0 = time.perf_counter()
    v1_outs = [list(map(int, r)) for r in
               v1.generate(padded, prompt_lengths=lens, max_new_tokens=MAX_NEW_TOKENS)]
    torch.cuda.synchronize()
    v1_s = time.perf_counter() - t0
    v1_launches = rms_norm_cuda.launches
    check_launches("v1 generate", {"rms_norm": v1_launches},
                   {"rms_norm": (2 * cfg.num_layers + 1) * MAX_NEW_TOKENS})
    v2_outs = [list(map(int, r)) for r in serve["bf16"]["outs"]]
    leave = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(v1_outs, v2_outs)]
    nodrop = dataclasses.replace(cfg, drop_tokens=False)      # the serving routing
    noise16 = routed_noise(mixtral, nodrop, params, v1._tensor(padded[:2, :128].astype(np.int64)))
    parting = v1_v2_parting(nodrop, v1, padded, lens, v1_outs, v2_outs, leave, [], noise16,
                            family=mixtral, beyond="beyond the bf16 error: a route flip "
                            "earlier in the row, or a fault")
    res["v1"] = {"generate_s": v1_s, "peak_bytes": torch.cuda.max_memory_allocated(),
                 "launches": {"rms_norm": v1_launches}, "outs": v1_outs,
                 "v1_v2_first_difference": leave, "agree_rows": sum(x is None for x in leave),
                 "bf16_noise": noise16, "v1_v2_parting": parting}
    log(f"  v1 bf16: {v1_s:.1f} s for 8 x {MAX_NEW_TOKENS} tokens, peak "
        f"{res['v1']['peak_bytes'] / 2**30:.2f} GiB; v1 against v2 at {cfg.num_layers} layers: "
        f"{res['v1']['agree_rows']} of {len(prompts)} rows the same, first differing step by "
        f"row {leave} (bf16 error of the forward {noise16:.4f}) [{card}]")
    del v1
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the two dispatches at (c)'s prefill shape: layer 0's bank, the
    # burst's tokens (8 prompts padded to a multiple of 64, every row routed)
    pad_t = -(-max(lengths) // 64) * 64
    moe = {k[len("layers.0.moe."):]: v for k, v in params.items()
           if k.startswith("layers.0.moe.")}
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)
    x = torch.randn((len(prompts), pad_t, cfg.hidden_size), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    T = x.shape[0] * x.shape[1]
    layers = {d: MoELayer(cfg.num_experts, cfg.top_k, drop_tokens=False, dispatch=d)
              for d in ("einsum", "compact")}
    with torch.inference_mode():
        outs = {d: lay(moe, x)[0] for d, lay in layers.items()}
        times = {d: time_ms(lambda lay=lay: lay(moe, x), 5, warmup=2)
                 for d, lay in layers.items()}
    err = check_close("compact dispatch against einsum (no-drop, prefill burst)",
                      outs["compact"], outs["einsum"], DISPATCH_TOL)[1]
    C = T                                      # no-drop capacity: every slot fits
    res["dispatch"] = {"tokens": T, "capacity": C, "row_err": err, "tol": DISPATCH_TOL,
                       "ms": times, "combine_bytes": T * cfg.num_experts * C * 4,
                       "table_bytes": cfg.num_experts * C * (8 + 4),
                       "expert_rows": cfg.num_experts * C, "routed_rows": cfg.top_k * T}
    d = res["dispatch"]
    log(f"  dispatch at {T} tokens (no-drop, C = {C}): einsum {times['einsum']:.2f} ms, "
        f"compact {times['compact']:.2f} ms; combine tensor {d['combine_bytes'] / 1e6:.1f} MB "
        f"against {d['table_bytes'] / 1e6:.2f} MB of token tables; the bank multiplies "
        f"{d['expert_rows']} rows for {d['routed_rows']} routed ones [{card}]")
    del outs, x, moe

    # at MIX_CHECK_LAYERS: every token of v1, v2 and v2 spec + int8 against
    # the fp32 forward of the same weights routing each position as the
    # engine did, at V1_NOISE_RATIO x the bf16 forward's own error (v2 with
    # the decode graph's plain version, the eager decode, whose forwards
    # can be recorded); the card's gates left unrenormalized must fail it
    small = dataclasses.replace(nodrop, num_layers=MIX_CHECK_LAYERS)
    sp = layers_of(params, MIX_CHECK_LAYERS)
    noise = routed_noise(mixtral, small, sp,
                         torch.as_tensor(prompts[-1], device="cuda")[None].long())
    tol = V1_NOISE_RATIO * noise
    log(f"  {MIX_CHECK_LAYERS} layers: the bf16 forward against fp32 (the same routes) on "
        f"the {len(prompts[-1])}-token prompt {noise:.4f} of a row's RMS; limit {tol:.4f}")
    v1s = dst.init_inference(mixtral, model_cfg=small, params=sp,
                             config={"dtype": "bfloat16", "prefill_bucket": 64})
    checks = {}
    with v1_routes(v1s, MIX_CHECK_LAYERS) as routes:
        outs = [list(map(int, r)) for r in v1s.generate(padded, prompt_lengths=lens,
                                                         max_new_tokens=MAX_NEW_TOKENS)]
    checks["v1"] = fp32_gaps(mixtral, small, sp, prompts, outs, routes,
                               list(range(len(prompts))))
    with fault_unnormalized_gates() as what, v1_routes(v1s, MIX_CHECK_LAYERS) as routes:
        bad = [list(map(int, r)) for r in v1s.generate(padded[:3], prompt_lengths=lens[:3],
                                                        max_new_tokens=8)]
    bad_gap = fp32_gaps(mixtral, small, sp, prompts[:3], bad, routes, [0, 1, 2])[2]
    del v1s
    torch.cuda.empty_cache()
    base = {"dtype": "bfloat16", "prefill_bucket": 64,
            "ragged": {"max_tracked_sequences": 8, "max_ragged_batch_size": 8,
                       "memory_config_blocks": 64, "block_size": 128}}
    for extra_name, extra in (("v2 bf16", {}), ("v2 spec + fused verify, int8 pools",
                                                 {**SPEC, **INT8})):
        e2 = build_engine_v2(mixtral, small, sp, config=dict(base, **extra))
        e2._graph_on = False
        with v2_routes(e2, MIX_CHECK_LAYERS) as routes:
            outs = [list(map(int, o)) for o in e2.generate(prompts,
                                                            max_new_tokens=MAX_NEW_TOKENS)]
        checks[extra_name] = fp32_gaps(mixtral, small, sp, prompts, outs, routes,
                                         routes.first_keys[:len(prompts)])
        del e2
        torch.cuda.empty_cache()
    for name, (m, n, worst) in checks.items():
        log(f"  {name} at {MIX_CHECK_LAYERS} layers: {m}/{n} tokens the fp32 argmax, largest "
            f"gap {worst:.4f} of the row's RMS (limit {tol:.4f})")
        if worst > tol:
            raise AssertionError(f"{name}: a generated token is {worst} row RMS below the "
                                 f"fp32 argmax")
    log(f"  planted fault ({what}): largest gap {bad_gap:.4f} (must exceed {tol:.4f})")
    if bad_gap <= tol:
        raise AssertionError(f"the Mixtral stream check passes a planted fault ({what})")
    res["check"] = {"noise": noise, "tol": tol,
                    "streams": {k: {"argmax": [m, n], "worst_gap": w}
                                for k, (m, n, w) in checks.items()},
                    "planted_fault_gap": bad_gap}
    del params, sp
    gc.collect()
    torch.cuda.empty_cache()
    tr = res["train"]["launches"]
    res["launches"] = {
        "rms_norm_training": tr["rms_norm"],
        "rms_norm_serving": sum(serve[n]["launches"]["rms_norm"] for n in ("bf16", "spec", "int8"))
        + v1_launches,
        "flash_fwd": tr["flash_fwd"], "flash_bwd_dq": tr["flash_bwd_dq"],
        "flash_bwd_dkv": tr["flash_bwd_dkv"],
        "paged_decode_attention": serve["bf16"]["launches"]["paged_decode_attention"]
        + serve["spec"]["launches"]["paged_decode_attention"],
        "paged_decode_attention_int8": serve["int8"]["launches"]["paged_decode_attention_int8"],
        "paged_spec_verify_attention": serve["spec"]["launches"]["paged_spec_verify_attention"]}
    res["weight_bytes"] = wbytes
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {res['launches']}")
    log(f"  phase 24: {res['phase_s']:.1f} s")
    return res


# --------------------------------------------------------------------------- #
# phase 25: Falcon-7B, GPT-NeoX-20B (head dim 96) and GPT-J-6B
# --------------------------------------------------------------------------- #
P25_TRAIN_LAYERS = 4     # Falcon-7B (of 32) and GPT-NeoX-20B (of 44) in training: the fp32
                         # masters + AdamW of 1.12 / 2.43 B params, and the smoke's time
P25_CHECK_LAYERS = 2     # the card-vs-CPU steps and the fp32-reference stream checks
P25_SEQ = 2048           # tokens a training micro-batch (both families' max_seq_len)
P25_CHECK_SEQ = 128      # tokens of the card-vs-CPU steps
P25_TRAIN_STEPS = 3
GPTJ_LAYERS = 4          # GPT-J-6B's v1 depth (of 28)
NEOX_KERNEL_CASES = [    # GPT-NeoX-20B's attention: 64/64 heads of 96
    ("causal S=2048", 2048, None), ("window 256 S=1000", 1000, 256)]
FALCON_ATTN = (2048, 71, 1, 64)    # Falcon-7B's attention: S, query heads, kv heads, hd


def p25_kernels(gen, card: str) -> dict:
    """The flash kernels at hd 96 (GPT-NeoX-20B's shape, bf16 and fp32) and
    at Falcon-7B's 71 query heads over one kv head, each against its plain
    pieces; the bf16 kernels' planted faults at hd 96; LayerNorm at
    Falcon-7B's and GPT-NeoX-20B's widths. Times beside their bounds, the
    plain versions and the PyTorch call that computes the same function."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_torch, flash_fwd_cuda, flash_fwd_torch, sm90_planted_fault)
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, layer_norm_torch

    out = {"neox": {}, "tol": FLASH_TOL, "floor": FLASH_FLOOR}

    def pieces(label, q, k, v, do, kw):
        o, lse = flash_fwd_cuda(q, k, v, **kw)
        o_ref, lse_ref = flash_fwd_torch(q, k, v, **kw)
        errs = {"o": check_close(f"flash fwd {label} o", o, o_ref, FLASH_TOL["o"],
                                 floor=FLASH_FLOOR["o"])}
        if not bool(((lse - lse_ref).abs() <= LSE_ATOL + LSE_RTOL * lse_ref.abs()).all()):
            raise AssertionError(f"flash fwd {label}: lse disagrees with the plain version")
        ref = dict(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, **kw)))
        errs.update(_check_pieces(f"flash bwd pieces {label}",
                                  _bwd_pieces(q, k, v, do, o, lse, kw), ref, ("dq", "dk", "dv")))
        return errs, (o, lse, o_ref, ref)

    h, hd = 64, 96
    for name, s, window in NEOX_KERNEL_CASES:
        kw = dict(causal=True, window=window)
        for dtype in (torch.bfloat16, torch.float32):
            label = f"hd 96 [{s} x 64/64 heads] {name} {str(dtype)[6:]}"
            q, k, v, do = (torch.randn(1, s, h, hd, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            errs, (o, lse, o_ref, ref) = pieces(label, q, k, v, do, kw)
            out["neox"][label] = _pieces_result(errs)
            if dtype == torch.bfloat16 and window is None:
                faults = {}
                for fault, what in ((1, "ring stage read one step late"),
                                    (2, "last kv tile of the causal band dropped")):
                    with sm90_planted_fault(fault):
                        o_bad, _ = flash_fwd_cuda(q, k, v, **kw)
                        torch.cuda.synchronize()
                    faults[what] = _fault_must_fail(f"hd 96 {what}", o_bad, o_ref, "o")
                for fault, what, keys in BWD_FAULTS:
                    with sm90_planted_fault(fault, "bwd"):
                        bad = _bwd_pieces(q, k, v, do, o, lse, kw)
                    faults[what] = [_fault_must_fail(f"hd 96 {what}, {key}", bad[key], ref[key],
                                                     key) for key in keys]
                out["planted_faults_hd96"] = faults
                work = flash_work(s, s, h, True, 0, None, hd=hd, h=h)
                out["timing"] = _time_flash(q, k, v, do, kw, work)
                out["pairs"] = work["pairs"]
                _log_times(f"hd 96 [{s} x 64/64 heads] causal", out["timing"], card)
            del q, k, v, do, o, lse, o_ref, ref
            torch.cuda.empty_cache()

    # Falcon-7B: dK/dV sums all 71 query heads into the one kv head
    s, h, hkv, hd = FALCON_ATTN
    label = f"Falcon-7B [{s} x {h}/{hkv} heads, hd {hd}] causal"
    q, do = (torch.randn(1, s, h, hd, generator=gen, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(1, s, hkv, hd, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    kw = {"causal": True}
    errs, _ = pieces(label, q, k, v, do, kw)
    work = flash_work(s, s, hkv, True, 0, None, hd=hd, h=h)
    out["falcon"] = {**_pieces_result(errs), "pairs": work["pairs"],
                     "timing": _time_flash(q, k, v, do, kw, work)}
    _log_times(label, out["falcon"]["timing"], card)
    log(f"  (SDPA at this shape: {out['falcon']['timing']['fwd']['sdpa_gqa']})")
    log(f"  dK/dV at {label}: {-(-s // 128)} work items of 128 kv rows, each walking all {h} "
        f"query heads; it reads {work['dkv']['bytes'] / 1e6:.1f} MB (q and dO once: "
        f"{2 * s * h * hd * 2 / 1e6:.1f} MB) [{card}]")
    del q, k, v, do
    torch.cuda.empty_cache()

    out["layer_norm"] = {}
    for d in (4544, 6144):
        x = (torch.randn(4096, d, generator=gen, device="cuda") * 3).bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        b = (0.2 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        err = check_close(f"layer_norm [4096 x {d}] bf16", layer_norm_cuda(x, w, b, 1e-5),
                          layer_norm_torch(x, w, b, 1e-5), RMS_TOL)
        nbytes = 2 * x.numel() * 2 + 2 * d * 2
        r = {"max_abs_err": err[0], "row_err_over_rms": err[1],
             "ms": measure(lambda: layer_norm_cuda(x, w, b, 1e-5), 20)["ms"],
             "plain_ms": measure(lambda: layer_norm_torch(x, w, b, 1e-5), 20)["ms"],
             "library_ms": measure(lambda: F.layer_norm(x, (d,), w, b, 1e-5), 20)["ms"],
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes}
        out["layer_norm"][d] = r
        log(f"  layer_norm [4096 x {d}] bf16: device kernel {r['ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.2f} us (bytes), plain {r['plain_ms'] * 1e3:.2f} us, "
            f"F.layer_norm {r['library_ms'] * 1e3:.2f} us [{card}]")
        del x, w, b
    return out


@contextlib.contextmanager
def fault_falcon_cache_write_late():
    """Every K/V row of Falcon's v1 lands one cache slot after its position."""
    from deepspeed_tpu_torch.models import falcon

    sound = falcon._write_cache
    falcon._write_cache = lambda cache, new, starts: sound(cache, new, starts + 1)
    try:
        yield "each K/V row written one cache slot late"
    finally:
        falcon._write_cache = sound


@contextlib.contextmanager
def fault_rotary(**change):
    """GPT-NeoX / GPT-J's rotary with its arguments changed:
    ``interleaved=True`` rotates pairs of adjacent dims (not GPT-NeoX's split
    halves), ``interleaved=False`` split halves (not GPT-J's pairs)."""
    from deepspeed_tpu_torch.models import gptneox

    sound = gptneox.apply_rotary_partial
    gptneox.apply_rotary_partial = lambda *a, **kw: sound(*a, **{**kw, **change})
    try:
        yield f"rotary with {change}"
    finally:
        gptneox.apply_rotary_partial = sound


def fp32_stream_check(label: str, family, cfg, params, prompts, outs_by_engine: dict, fault,
                 forward=None, low=None) -> dict:
    """Every token of each engine's streams (``outs_by_engine``: name ->
    streams) against the fp32 forward of the same weights within
    ``V1_NOISE_RATIO`` x the bf16 forward's own error from it on the longest
    prompt; ``fault`` = (name, streams made under a planted fault, its
    prompts) must exceed that. ``forward`` (tokens -> logits, compute
    dtype) replaces ``family.apply`` for both; ``low``: the engines'
    compute dtype (bf16 unless given)."""
    import torch

    low = low or torch.bfloat16
    fwd = forward or (lambda t, dt: family.apply(cfg, params, t, compute_dtype=dt))
    long_ = torch.as_tensor(max(prompts, key=len), device="cuda")[None].long()
    with torch.inference_mode():
        noise = row_err(fwd(long_, low), fwd(long_, torch.float32))[1]
    tol = V1_NOISE_RATIO * noise
    log(f"  {label}: the {str(low).split('.')[-1]} forward against fp32 on the "
        f"{long_.shape[1]}-token prompt "
        f"{noise:.4f} of a row's RMS; limit {tol:.4f}")
    f32 = lambda seq: fwd(seq.long(), torch.float32)  # noqa: E731
    checks = {name: fp32_gaps(family, cfg, params, prompts, outs, forward=f32)
              for name, outs in outs_by_engine.items()}
    for name, (m, n, worst) in checks.items():
        log(f"  {name}: {m}/{n} tokens the fp32 argmax, largest gap {worst:.4f} of the row's "
            f"RMS (limit {tol:.4f})")
        if worst > tol:
            raise AssertionError(f"{label} {name}: a generated token is {worst} row RMS below "
                                 f"the fp32 argmax")
    what, bad, bad_prompts = fault
    bad_gap = fp32_gaps(family, cfg, params, bad_prompts, bad, forward=f32)[2]
    log(f"  planted fault ({what}): largest gap {bad_gap:.4f} (must exceed {tol:.4f})")
    if bad_gap <= tol:
        raise AssertionError(f"the {label} stream check passes a planted fault ({what})")
    return {"noise": noise, "tol": tol, "planted_fault_gap": bad_gap,
            "streams": {k: {"argmax": [m, n], "worst_gap": w}
                        for k, (m, n, w) in checks.items()}}


def _v1_generate(v1, prompts, new: int):
    padded = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    return [list(map(int, r)) for r in v1.generate(padded, prompt_lengths=lens,
                                                      max_new_tokens=new)], padded, lens


def phase_falcon_neox(seed: int, card: str) -> dict:
    """Falcon-7B, GPT-NeoX-20B and GPT-J-6B (module docstring, phase 25)."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import falcon, gptneox
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd_cuda
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    res = {"kernels": p25_kernels(gen, card)}
    fcfg, ncfg = falcon.FalconConfig(), gptneox.GPTNeoXConfig()
    for key, fam, cfg, label in (("falcon", falcon, fcfg, "Falcon-7B"),
                                 ("neox", gptneox, ncfg, "GPT-NeoX-20B")):
        gc.collect()
        torch.cuda.empty_cache()
        # (a) training at P25_TRAIN_LAYERS, (b) one step card against CPU
        per_layer = 1 if fam is falcon else 2      # classic Falcon: one LayerNorm a block
        r = {"train": phase_train(
            seed, card, family=fam, cfg=dataclasses.replace(cfg, num_layers=P25_TRAIN_LAYERS),
            label=label, seq=P25_SEQ, gas=2, micro=1, norm="layer_norm",
            norms_per_layer=per_layer, steps=P25_TRAIN_STEPS)}
        gc.collect()
        torch.cuda.empty_cache()
        r["train_whole_path"] = phase_train_whole(
            seed, card, family=fam, cfg=cfg, label=f"{label}-width",
            fault=(fault_zero_dv_head, fault_zero_ln_db), layers=P25_CHECK_LAYERS,
            seq=P25_CHECK_SEQ)
        res[key] = r
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Falcon-7B serving at all 32 layers: v2 bf16, v2 spec + fused verify
    # on int8 pools, and v1, on one set of bf16 weights
    t0 = time.perf_counter()
    params = falcon.init(fcfg, torch.Generator(device="cuda").manual_seed(seed),
                         dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    log(f"  Falcon-7B serving weights: {fcfg.num_layers} layers, {fcfg.num_params / 1e9:.2f} B "
        f"params, {wbytes / 1e9:.2f} GB bf16 in {time.perf_counter() - t0:.1f} s; a decode "
        f"step's weight-bytes bound {bound_ms:.2f} ms")
    prompts, lengths = spec_prompts(seed, fcfg.vocab_size)
    base = {"dtype": "bfloat16", "prefill_bucket": 64,
            "ragged": {"max_tracked_sequences": 8, "max_ragged_batch_size": 8,
                       "memory_config_blocks": 64, "block_size": 128}}
    serve = phase_spec_serving(
        seed, MAX_NEW_TOKENS, card, family=falcon, cfg=fcfg, params=params, norm="layer_norm",
        norms_per_layer=1, base_conf=base,
        engines=(("bf16", {}, prompts), ("spec_int8", {**SPEC, **INT8}, prompts)))
    for name in ("bf16", "spec_int8"):
        w = serve[name]["per_replay"]
        if w.get("paged_decode_attention", w.get("paged_decode_attention_int8")) != \
                fcfg.num_layers:
            raise AssertionError(f"Falcon {name}: a decode replay launches {w}, not "
                                 f"{fcfg.num_layers} paged decodes")
    busy = serve["bf16"]["profile_steps"]["busy_ms_per_step"]
    res["falcon"]["serving"] = serve
    res["falcon"]["decode"] = {"step_ms": serve["bf16"]["decode_step_ms"], "busy_ms": busy,
                               "bound_ms": bound_ms, "weight_bytes": wbytes,
                               "per_replay": serve["bf16"]["per_replay"]}
    log(f"  Falcon-7B bf16 decode step {serve['bf16']['decode_step_ms']:.2f} ms (device busy "
        f"{busy:.2f} ms) against the weight-bytes bound {bound_ms:.2f} ms; a replay launches "
        f"{serve['bf16']['per_replay']} [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    v1 = dst.init_inference(falcon, model_cfg=fcfg, params=params,
                            config={"dtype": "bfloat16", "prefill_bucket": 64})
    _v1_generate(v1, prompts[:2], 2)                                     # warm-up
    torch.cuda.synchronize()
    layer_norm_cuda.launches = 0
    t0 = time.perf_counter()
    v1_outs, padded, lens = _v1_generate(v1, prompts, MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    v1_s = time.perf_counter() - t0
    v1_ln = layer_norm_cuda.launches
    check_launches("Falcon v1 generate", {"layer_norm": v1_ln},
                   {"layer_norm": (fcfg.num_layers + 1) * MAX_NEW_TOKENS})
    v2_outs = [list(map(int, r)) for r in serve["bf16"]["outs"]]
    leave = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(v1_outs, v2_outs)]
    long_ = torch.as_tensor(prompts[-1], device="cuda")[None].long()
    with torch.inference_mode():
        noise32 = row_err(falcon.apply(fcfg, params, long_, compute_dtype=torch.bfloat16),
                          falcon.apply(fcfg, params, long_, compute_dtype=torch.float32))[1]
    parting = v1_v2_parting(fcfg, v1, padded, lens, v1_outs, v2_outs, leave, [], noise32,
                            family=falcon)
    res["falcon"]["v1"] = {"generate_s": v1_s, "launches": {"layer_norm": v1_ln},
                           "outs": v1_outs, "v1_v2_first_difference": leave,
                           "agree_rows": sum(x is None for x in leave), "bf16_noise": noise32,
                           "v1_v2_parting": parting}
    log(f"  Falcon-7B v1 bf16: {v1_s:.1f} s for 8 x {MAX_NEW_TOKENS} tokens; v1 against v2 at "
        f"{fcfg.num_layers} layers: {res['falcon']['v1']['agree_rows']} of {len(prompts)} rows "
        f"the same, first differing step by row {leave} (bf16 error {noise32:.4f}) [{card}]")
    del v1
    gc.collect()
    torch.cuda.empty_cache()

    # (d) at P25_CHECK_LAYERS: every token of v1, v2 and v2 spec + int8
    # against the fp32 forward
    small = dataclasses.replace(fcfg, num_layers=P25_CHECK_LAYERS)
    sp = layers_of(params, P25_CHECK_LAYERS)
    v1s = dst.init_inference(falcon, model_cfg=small, params=sp,
                             config={"dtype": "bfloat16", "prefill_bucket": 64})
    outs = {"v1": _v1_generate(v1s, prompts, MAX_NEW_TOKENS)[0]}
    with fault_falcon_cache_write_late() as what:
        bad = _v1_generate(v1s, prompts[:3], 8)[0]
    del v1s
    for name, extra in (("v2 bf16", {}), ("v2 spec + fused verify, int8 pools",
                                          {**SPEC, **INT8})):
        e2 = build_engine_v2(falcon, small, sp, config=dict(base, **extra))
        outs[name] = [list(map(int, o)) for o in e2.generate(prompts,
                                                              max_new_tokens=MAX_NEW_TOKENS)]
        del e2
        torch.cuda.empty_cache()
    res["falcon"]["check"] = fp32_stream_check(f"Falcon-7B at {P25_CHECK_LAYERS} layers", falcon,
                                          small, sp, prompts, outs, (what, bad, prompts[:3]))
    del params, sp
    gc.collect()
    torch.cuda.empty_cache()

    # GPT-NeoX-20B v1 at all 44 layers: prefill, 8 prompts x 32 greedy tokens
    t0 = time.perf_counter()
    params = gptneox.init(ncfg, torch.Generator(device="cuda").manual_seed(seed),
                          dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"  GPT-NeoX-20B serving weights: {ncfg.num_layers} layers, "
        f"{ncfg.num_params / 1e9:.2f} B params, {wbytes / 1e9:.2f} GB bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    v1 = dst.init_inference(gptneox, model_cfg=ncfg, params=params,
                            config={"dtype": "bfloat16", "prefill_bucket": 64})
    vp, vl = v1_prompts(seed, ncfg.vocab_size)
    v1.generate(vp[:2], prompt_lengths=vl[:2], max_new_tokens=2)         # warm-up
    layer_norm_cuda.launches = flash_fwd_cuda.launches = 0
    times = v1_times(v1, vp, vl, MAX_NEW_TOKENS)
    neox_outs = v1.generate(vp, prompt_lengths=vl, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    neox_ln = layer_norm_cuda.launches
    check_launches("GPT-NeoX-20B v1 (two generates of 1 and 32 tokens, then 32)",
                   {"layer_norm": neox_ln, "flash_fwd": flash_fwd_cuda.launches},
                   {"layer_norm": (2 * ncfg.num_layers + 1) * (1 + 2 * MAX_NEW_TOKENS),
                    "flash_fwd": 0})
    if not all(0 <= int(t) < ncfg.vocab_size for row in neox_outs for t in row):
        raise AssertionError("GPT-NeoX-20B v1 generated a token outside the vocabulary")
    res["neox"]["v1"] = {**times, "weight_bytes": wbytes,
                         "decode_bound_ms": wbytes / HBM_BYTES_PER_S * 1e3,
                         "launches": {"layer_norm": neox_ln}}
    log(f"  GPT-NeoX-20B v1 bf16 ({ncfg.num_layers} layers, 8 prompts of {vl.tolist()}): prefill "
        f"{times['prefill_ms']:.1f} ms, decode step {times['decode_step_ms']:.2f} ms against "
        f"the weight-bytes bound {res['neox']['v1']['decode_bound_ms']:.2f} ms, peak "
        f"{times['peak_gib']:.2f} GiB [{card}]")
    del v1
    gc.collect()
    torch.cuda.empty_cache()
    small = dataclasses.replace(ncfg, num_layers=P25_CHECK_LAYERS)
    sp = layers_of(params, P25_CHECK_LAYERS)
    del params
    nprompts = [vp[i, :vl[i]] for i in range(len(vl))]
    v1s = dst.init_inference(gptneox, model_cfg=small, params=sp,
                             config={"dtype": "bfloat16", "prefill_bucket": 64})
    outs = {"v1": _v1_generate(v1s, nprompts, MAX_NEW_TOKENS)[0]}
    with fault_rotary(interleaved=True) as what:
        bad = _v1_generate(v1s, nprompts[1:4], 8)[0]
    res["neox"]["check"] = fp32_stream_check(f"GPT-NeoX-20B at {P25_CHECK_LAYERS} layers", gptneox,
                                        small, sp, nprompts, outs, (what, bad, nprompts[1:4]))
    del v1s, sp
    gc.collect()
    torch.cuda.empty_cache()

    # GPT-J-6B v1 at GPTJ_LAYERS: interleaved rotary, the shared LayerNorm,
    # the head bias; hd 256 takes no flash kernel, and v1's reads are plain
    jcfg = dataclasses.replace(gptneox.GPTNeoXConfig.gptj_6b(), num_layers=GPTJ_LAYERS)
    params = gptneox.init(jcfg, torch.Generator(device="cuda").manual_seed(seed),
                          dtype=torch.bfloat16, device="cuda")
    v1 = dst.init_inference(gptneox, model_cfg=jcfg, params=params,
                            config={"dtype": "bfloat16", "prefill_bucket": 64})
    jprompts = [vp[i, :vl[i]] for i in range(len(vl))]
    _v1_generate(v1, jprompts[:2], 2)                                    # warm-up
    layer_norm_cuda.launches = flash_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    outs = {"v1": _v1_generate(v1, jprompts, MAX_NEW_TOKENS)[0]}
    torch.cuda.synchronize()
    gptj_s = time.perf_counter() - t0
    gptj_ln = layer_norm_cuda.launches
    check_launches("GPT-J-6B v1 generate (hd 256: no flash launch)",
                   {"layer_norm": gptj_ln, "flash_fwd": flash_fwd_cuda.launches},
                   {"layer_norm": (jcfg.num_layers + 1) * MAX_NEW_TOKENS, "flash_fwd": 0})
    with fault_rotary(interleaved=False) as what:
        bad = _v1_generate(v1, jprompts[1:4], 8)[0]

    def dense_forward(tokens, dtype):
        """The fp32 (or bf16) forward through the dense-cache path from an
        empty cache: causal, plain attention (no flash kernel takes hd 256)."""
        cache = gptneox.init_cache(jcfg, 1, tokens.shape[1], dtype=dtype)
        return gptneox.apply_cached(jcfg, params, tokens, cache, 0, compute_dtype=dtype)[0]

    res["gptj"] = {"generate_s": gptj_s, "launches": {"layer_norm": gptj_ln, "flash_fwd": 0},
                   "check": fp32_stream_check(f"GPT-J-6B at {GPTJ_LAYERS} layers", gptneox, jcfg,
                                         params, jprompts, outs, (what, bad, jprompts[1:4]),
                                         forward=dense_forward)}
    log(f"  GPT-J-6B v1 bf16 ({GPTJ_LAYERS} layers): {gptj_s:.1f} s for 8 x {MAX_NEW_TOKENS} "
        f"tokens, no flash launch [{card}]")
    del v1, params
    gc.collect()
    torch.cuda.empty_cache()

    ft, nt = res["falcon"]["train"]["launches"], res["neox"]["train"]["launches"]
    res["launches"] = {
        **{k: {"falcon training": ft[k], "gpt-neox training (hd 96)": nt[k]}
           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
        "layer_norm": {"falcon training": ft["layer_norm"], "gpt-neox training": nt["layer_norm"],
                       "falcon serving": serve["bf16"]["launches"]["layer_norm"]
                       + serve["spec_int8"]["launches"]["layer_norm"] + v1_ln,
                       "gpt-neox / gpt-j v1": neox_ln + gptj_ln},
        "paged_decode_attention": serve["bf16"]["launches"]["paged_decode_attention"],
        "paged_decode_attention_int8":
            serve["spec_int8"]["launches"]["paged_decode_attention_int8"],
        "paged_spec_verify_attention":
            serve["spec_int8"]["launches"]["paged_spec_verify_attention"]}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {res['launches']}")
    log(f"  phase 25: {res['phase_s']:.1f} s")
    return res


def bloom_v1_peak(seed: int, card: str) -> dict:
    """v1 ``forward`` on BLOOM-7b1 (30 layers) with int8 weights at rest:
    the peak device memory of the family's ``apply`` reading each block's
    leaves at the block (a block dequantized at a time) against the same
    forward over every leaf dequantized first (how ``apply`` read them
    before: a bf16 copy of the whole model); the logits must be equal."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import bloom

    cfg = bloom.BloomConfig.bloom_7b1()
    params = bloom.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        dtype=torch.bfloat16, device="cuda")
    eng = dst.init_inference(bloom, model_cfg=cfg, params=params,
                             config={"dtype": "bfloat16", "quant": {"enabled": True, "bits": 8}})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tokens = np.random.RandomState(seed + 3).randint(0, cfg.vocab_size, (1, 512))
    base = torch.cuda.memory_allocated()
    peaks, logits = {}, {}
    for name, fn in (("whole model first", lambda: bloom.apply(
                          cfg, dict(eng.weights()), eng._tensor(tokens),
                          compute_dtype=torch.bfloat16)),
                     ("a block at a time", lambda: eng.forward(tokens))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            logits[name] = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    same = bool(torch.equal(*logits.values()))
    res = {"weight_bytes": eng.weight_bytes(), "peak_above_weights_bytes": peaks,
           "logits_equal": same}
    log(f"  BLOOM-7b1 int8 v1 forward (1 x 512 tokens): weights {eng.weight_bytes() / 1e9:.2f} "
        f"GB; peak above them: every leaf dequantized first "
        f"{peaks['whole model first'] / 2**30:.2f} GiB, a block at a time "
        f"{peaks['a block at a time'] / 2**30:.2f} GiB; logits equal: {same} [{card}]")
    if not same or not peaks["a block at a time"] < peaks["whole model first"]:
        raise AssertionError("BLOOM's per-block read did not lower the peak, or changed the "
                             "logits")
    del eng, logits
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# phase 26: fp16 on the card
# --------------------------------------------------------------------------- #
# DeepSpeed's documented fp16 block (dynamic loss scale from 2^16)
FP16_BLOCK = {"enabled": True, "loss_scale": 0, "initial_scale_power": 16,
              "loss_scale_window": 1000, "hysteresis": 2, "min_loss_scale": 1}
# a 16-bit kernel against its plain version in fp16 (the same rounding
# points): each row's largest error over its RMS (floored at 1% of the
# output's), tests/test_torch_cuda_kernels.py's FLASH_TOL_FP16; the paged
# kernel at its own ROWS_TOL
FP16_PIECES_TOL = 0.02
FP16_PIECES_FLOOR = 0.01
# the card's fp16 step against the CPU's fp32 one (tests/test_torch_fp16_limits.py)
FP16_LOSS_RTOL = 5e-4
FP16_GRAD_RTOL = 0.012
FP16_CHECK_LAYERS = 2          # the card-vs-CPU step and the fp32-reference stream checks
FP16_CHECK_SEQ = 128
FP16_DRILL_POWER = 32          # the overflow drill's initial_scale_power
FP16_DRILL_STEPS = 24          # at most, until two steps in a row apply
FP16_ZERO_LAYERS = 2           # ZeRO-3 against stage 0 under fp16 (phase 18 holds bf16 at 4)
FP16_ZERO_STEPS = 2
# label, (B, Sq, Skv, H, Hkv, hd), kw, timed (at Llama-3-8B's shape only: the
# other shapes' fp16 times track their bf16 ones: PERF.md section 6)
FP16_FLASH_CASES = [
    ("Llama-3-8B S=4096 causal 32/8", (1, 4096, 4096, 32, 8, 128), {"causal": True}, True),
    ("window 1024 S=4096", (1, 4096, 4096, 32, 8, 128), {"causal": True, "window": 1024}, False),
    ("Sq=512 Skv=4096 q_offset=3584", (1, 512, 4096, 32, 8, 128),
     {"causal": True, "q_offset": 3584}, False),
    ("OPT-1.3B 4x2048 32/32 hd 64", (OPT_MICRO, 2048, 2048, 32, 32, 64), {"causal": True}, False),
    ("GPT-NeoX-20B 2048 64/64 hd 96", (1, 2048, 2048, 64, 64, 96), {"causal": True}, False),
]


FP16_BIAS_LABEL = "BLOOM-7b1 ALiBi 2x2048 32 heads"


def _f16_randn(gen, *shape):
    import torch

    return torch.randn(*shape, generator=gen, device="cuda").to(torch.float16)


def _f16_fault(what: str, got, ref) -> dict:
    """A planted fault must fail the fp16 check: a row beyond its limit, or
    a value that is not finite."""
    import torch

    err, rel = row_err(got, ref, floor=FP16_PIECES_FLOOR)
    finite = bool(torch.isfinite(got.float()).all())
    log(f"  planted fault ({what}): max_abs_err={err:.3e}, row err/RMS={rel:.4f}, finite "
        f"{finite} (must exceed tol {FP16_PIECES_TOL:g} or not be finite)")
    if rel <= FP16_PIECES_TOL and finite:
        raise AssertionError(f"the fp16 check passes a planted fault ({what}); too loose")
    return {"what": what, "row_err_over_rms": rel, "finite": finite}


def p26_flash(gen, card: str) -> dict:
    """The fp16 flash forward, dQ and dK/dV against their plain pieces in
    fp16 in every mode the training paths take, the ALiBi bias mode at
    BLOOM-7b1's shape, each kernel's planted faults and a planted overflow;
    times beside the bound, the plain pieces and SDPA in fp16."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models.bloom import _alibi_bias
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bias_cuda, flash_bwd_dq_bias_cuda, flash_bwd_torch, flash_fwd_bias_cuda,
        flash_fwd_cuda, flash_fwd_torch, sm90_planted_fault)

    res = {"tol": FP16_PIECES_TOL, "floor": FP16_PIECES_FLOOR, "cases": {}, "timing": {},
           "planted_faults": {}}
    errs_all = {k: 0.0 for k in ("o", "dq", "dk", "dv", "dbias")}

    def check(label, got, ref, keys):
        out = {}
        for key in keys:
            out[key] = check_close(f"fp16 flash {label} {key}", got[key], ref[key],
                                   FP16_PIECES_TOL, floor=FP16_PIECES_FLOOR)
            errs_all[key] = max(errs_all[key], out[key][0])
        return out

    for label, (b, sq, skv, h, hkv, hd), kw, timed in FP16_FLASH_CASES:
        q, do = (_f16_randn(gen, b, sq, h, hd) for _ in range(2))
        k, v = (_f16_randn(gen, b, skv, hkv, hd) for _ in range(2))
        o, lse = flash_fwd_cuda(q, k, v, **kw)
        ref = {"o": flash_fwd_torch(q, k, v, **kw)[0]}
        ref.update(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, **kw)))
        got = {"o": o, **_bwd_pieces(q, k, v, do, o, lse, kw)}
        if o.dtype != torch.float16 or any(got[x].dtype != torch.float16 for x in got):
            raise AssertionError(f"fp16 flash {label}: outputs are not fp16")
        res["cases"][label] = _pieces_result(check(label, got, ref, ("o", "dq", "dk", "dv")))
        if label == FP16_FLASH_CASES[0][0]:
            for fault, what in ((1, "ring stage read one step late"),
                                (2, "last kv tile of the causal band dropped")):
                with sm90_planted_fault(fault):
                    o_bad, _ = flash_fwd_cuda(q, k, v, **kw)
                    torch.cuda.synchronize()
                res["planted_faults"][f"fwd {fault}"] = _f16_fault(f"fp16 fwd: {what}", o_bad,
                                                                  ref["o"])
            for fault, what, keys in BWD_FAULTS:
                with sm90_planted_fault(fault, "bwd"):
                    bad = _bwd_pieces(q, k, v, do, o, lse, kw)
                res["planted_faults"][f"bwd {fault}"] = [
                    _f16_fault(f"fp16 bwd: {what}, {key}", bad[key], ref[key]) for key in keys]
                del bad
        del ref, got
        if timed:
            work = flash_work(sq, skv, hkv, True, 0, None, b=b, hd=hd, h=h)
            res["timing"][label] = _time_flash(q, k, v, do, kw, work)
            _log_times(f"fp16 {label}", res["timing"][label], card)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    # the planted overflow: tiny q and k make p flat (1 / the keys a row
    # sees), v x 300 and dO x 3e3 make dp - delta ~1e7, so dS passes 65504
    # on the rows that see few keys while every finite output stays far
    # below it; rounded to fp16 (no saturation) that dS is inf in the
    # kernels as in the plain version, so dq and dk hold inf / nan in the
    # same elements (the finite rows agree), and dv stays finite and agrees
    b, s, h, hkv, hd = 1, 2048, 32, 8, 128
    q = (torch.randn(b, s, h, hd, generator=gen, device="cuda") * 1e-3).half()
    k = (torch.randn(b, s, hkv, hd, generator=gen, device="cuda") * 1e-3).half()
    v = (torch.randn(b, s, hkv, hd, generator=gen, device="cuda") * 300).half()
    do = (torch.randn(b, s, h, hd, generator=gen, device="cuda") * 3e3).half()
    o, lse = flash_fwd_cuda(q, k, v)
    got = _bwd_pieces(q, k, v, do, o, lse, {"causal": True})
    ref = dict(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do)))
    over = {}
    for key in ("dq", "dk", "dv"):
        bad_got, bad_ref = ~torch.isfinite(got[key].float()), ~torch.isfinite(ref[key].float())
        same = bool(torch.equal(bad_got, bad_ref))
        rows = ~bad_ref.any(-1)
        share = float(bad_ref.float().mean())
        rel = row_err(got[key][rows], ref[key][rows], floor=FP16_PIECES_FLOOR)[1] \
            if bool(rows.any()) else float("nan")
        over[key] = {"nonfinite_share": share, "same_elements": same, "finite_rows_err": rel}
        log(f"  fp16 planted overflow (q, k x 1e-3, v x 300, dO x 3e3): {key} non-finite in "
            f"{share:.4%} of its elements, the same elements as the plain version's: {same}; "
            f"finite rows err/RMS {rel:.4f}")
        want_some = key != "dv"
        if not same or (0 < share < 1) != want_some or (share > 0) != want_some \
                or not rel <= FP16_PIECES_TOL:
            raise AssertionError(f"fp16 overflow: {key} does not overflow where the plain "
                                 "version does")
    res["planted_overflow"] = over
    del q, k, v, do, o, lse, got, ref
    torch.cuda.empty_cache()

    # the ALiBi bias mode at BLOOM-7b1's shape, fp16 inputs, fp32 bias
    b, s, h, hd = BLOOM_B, BLOOM_S, BLOOM_H, HD
    q, k, v, do = (_f16_randn(gen, b, s, h, hd) for _ in range(4))
    alibi = _alibi_bias(h, s, "cuda")
    kw = {"causal": True}
    (o, lse, delta), got = _bias_pieces(q, k, v, do, alibi, kw, False)
    ref = {"o": flash_fwd_torch(q, k, v, bias=alibi, **kw)[0]}
    ref.update(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, bias=alibi, **kw)))
    label = FP16_BIAS_LABEL
    res["cases"][label] = _pieces_result(check(label, got, ref, ("o", "dq", "dk", "dv")))
    with sm90_planted_fault(4, "bwd"):
        bad = _bias_pieces(q, k, v, do, alibi, kw, False)[1]
    res["planted_faults"]["bwd 4"] = [
        _f16_fault(f"fp16 bias bwd: the bias read one kv tile off, {key}", bad[key], ref[key])
        for key in ("dq", "dk")]
    del bad, ref, got
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
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    fmask = (alibi[None] + torch.zeros(1, h, s, s, device="cuda")).masked_fill(
        ~causal, float("-inf")).to(torch.float16)

    def sdpa_fwd_bwd():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, attn_mask=fmask).backward(dot)

    lib_fwd = measure(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=fmask),
                      10)["ms"]
    lib_bwd = measure(sdpa_fwd_bwd, 5)["ms"] - lib_fwd
    rows = {}
    for key, plain_key, lib in (("fwd", "fwd", lib_fwd), ("dq", "bwd", lib_bwd),
                                ("dkv", "bwd", lib_bwd)):
        rows[key] = {"ms": t[key]["ms"], "plain_ms": plain[plain_key], "library_ms": lib,
                     "bound_ms": work[key][0], "bound_by": work[key][1]}
        log(f"  fp16 flash bias {key} {label}: device kernel {rows[key]['ms']*1e3:.1f} us, "
            f"bound {rows[key]['bound_ms']*1e3:.1f} us ({rows[key]['bound_by']}), plain "
            f"{rows[key]['plain_ms']*1e3:.1f} us, SDPA float mask {lib*1e3:.1f} us [{card}]")
    res["timing"][label] = rows
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot, fmask
    torch.cuda.empty_cache()
    res["max_abs_err"] = errs_all
    return res


def p26_paged(gen, card: str, serve_lengths) -> dict:
    """fp16 q through ``paged_sm90.cu`` at the Llama-3-8B serving shape:
    decode and verify over fp16 pools and over int8 pools (ng 1 and 4, where
    code x scale rounds to fp16), against the plain versions in fp16; its
    planted faults and one wrong table entry; times at the main path's step
    (the phase's serving prompts), beside the bound."""
    import torch

    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_int8_cuda,
        paged_decode_attention_torch, paged_planted_fault, paged_spec_verify_attention_cuda,
        paged_spec_verify_attention_torch)
    from deepspeed_tpu_torch.ops.quantization import kv_quantize_int8

    S = ROWS_SHAPE
    B, nh, nkv, hd, bs = S["B"], S["nh"], S["nkv"], S["hd"], S["bs"]
    nblocks, max_blocks, t = S["nblocks"], S["max_blocks"], SPEC_K + 1
    cap = max_blocks * bs
    kf = torch.randn(nblocks, nkv, bs, hd, generator=gen, device="cuda")
    vf = torch.randn(nblocks, nkv, bs, hd, generator=gen, device="cuda")
    pools = {0: (kf.half(), vf.half(), {})}
    for ng in (1, 4):
        kc, ks = kv_quantize_int8(kf, hd // ng)
        vc, vs = kv_quantize_int8(vf, hd // ng)
        pools[ng] = (kc, vc, {"k_scale": ks, "v_scale": vs})
    del kf, vf
    q1 = _f16_randn(gen, B, nh, hd)
    qt = _f16_randn(gen, B, t, nh, hd)
    rs = np.random.RandomState(26)
    tables_np = rs.randint(1, nblocks, (B, max_blocks)).astype(np.int32)
    ctx_np = np.concatenate([[0, bs - t, bs, 2 * bs - 1, cap - t],
                             rs.randint(0, cap - t + 1, B - 5)]).astype(np.int32)
    tables_np[0] = 0
    tables = torch.from_numpy(tables_np).cuda()
    ctx = torch.from_numpy(ctx_np).cuda()

    def decode(ng, tb=tables, c=ctx):
        kp, vp, sc = pools[ng]
        fn = paged_decode_attention_int8_cuda if ng else paged_decode_attention_cuda
        return (fn(q1, kp, vp, tb, c, **sc), paged_decode_attention_torch(q1, kp, vp, tb, c, **sc))

    def verify(ng, tb=tables, c=ctx):
        kp, vp, sc = pools[ng]
        return (paged_spec_verify_attention_cuda(qt, kp, vp, tb, c, **sc),
                paged_spec_verify_attention_torch(qt, kp, vp, tb, c, **sc))

    res = {"tol": ROWS_TOL, "max_abs_err": {}, "planted_faults": {}, "timing": {}}
    for kind, fn in (("decode", decode), ("verify", verify)):
        errs = []
        for ng in (0, 1, 4):
            got, ref = fn(ng)
            torch.cuda.synchronize()
            if got.dtype != torch.float16:
                raise AssertionError(f"fp16 paged {kind}: output {got.dtype}")
            pool = f"int8 ng={ng}" if ng else "fp16"
            errs.append(check_close(f"fp16 paged {kind} over {pool} pools, B={B}", got, ref,
                                    ROWS_TOL)[0])
            again = fn(ng)[0]
            if not torch.equal(got, again):
                raise AssertionError(f"fp16 paged {kind} {pool}: two calls differ")
        res["max_abs_err"][kind] = max(errs)
    for fault, what, kind, ng in ((1, "the merge drops each sequence's last split", "decode", 0),
                                  (2, "a ring stage read before its copy lands", "verify", 4),
                                  (3, "the K scale left out at ng = 1", "decode", 1)):
        fn = decode if kind == "decode" else verify
        ref = fn(ng)[1]
        with paged_planted_fault(fault):
            bad = fn(ng)[0]
            torch.cuda.synchronize()
        err, rel = row_err(bad, ref)
        log(f"  fp16 paged planted fault {fault} ({what}; {kind}): row err/RMS {rel:.4f} (must "
            f"exceed tol {ROWS_TOL:g})")
        if rel <= ROWS_TOL:
            raise AssertionError(f"the fp16 paged check passes planted fault {fault}")
        res["planted_faults"][fault] = rel
    row = int(np.argmax(ctx_np))
    bad_np = tables_np.copy()
    bad_np[row, max_blocks // 2] = bad_np[row, max_blocks // 2] % (nblocks - 1) + 1
    got = verify(0, tb=torch.from_numpy(bad_np).cuda())[0]
    rel = row_err(got[row], verify(0)[1][row])[1]
    log(f"  fp16 paged verify, one wrong table entry on the longest row: row err/RMS {rel:.4f} "
        f"(must exceed {ROWS_TOL:g})")
    if rel <= ROWS_TOL:
        raise AssertionError("the fp16 paged check passes a wrong table entry")
    res["planted_faults"]["table"] = rel

    def time_case(key, kind, ng, c_np, tb_np):
        c, tb = torch.from_numpy(c_np.astype(np.int32)).cuda(), torch.from_numpy(tb_np).cuda()
        kp, vp, sc = pools[ng]
        if kind == "decode":
            fn = paged_decode_attention_int8_cuda if ng else paged_decode_attention_cuda
            kern = lambda: fn(q1, kp, vp, tb, c, **sc)  # noqa: E731
            plain = lambda: paged_decode_attention_torch(q1, kp, vp, tb, c, **sc)  # noqa: E731
        else:
            kern = lambda: paged_spec_verify_attention_cuda(qt, kp, vp, tb, c, **sc)  # noqa: E731
            plain = lambda: paged_spec_verify_attention_torch(qt, kp, vp, tb, c, **sc)  # noqa: E731
        w = rows_work(c_np, 1 if kind == "decode" else t, ng)
        kt_, pt = measure(kern, 100), measure(plain, 3)
        res["timing"][key] = {"ms": kt_["ms"], "plain_ms": pt["ms"], "library_ms": None,
                              "bound_ms": w["bound_ms"], "bound_by": "bytes",
                              "bytes": w["bytes"], "live_tokens": w["live_tokens"]}
        log(f"  fp16 {key}: device kernel {kt_['ms']*1e3:.1f} us, plain {pt['ms']*1e3:.1f} us, "
            f"bound {w['bound_ms']*1e3:.1f} us ({w['live_tokens']} live positions) [{card}]")

    dec_c, dec_t = main_step_inputs(serve_lengths, MAX_NEW_TOKENS - 2)
    ver_c, ver_t = main_step_inputs(serve_lengths, MAX_NEW_TOKENS - SPEC_K - 1, extra=SPEC_K + 1)
    time_case("decode_fp16_main_path", "decode", 0, dec_c, dec_t)
    time_case("decode_int8_main_path", "decode", 1, dec_c, dec_t)
    time_case("verify_fp16_main_path", "verify", 0, ver_c, ver_t)
    del pools, q1, qt
    torch.cuda.empty_cache()
    return res


def fp16_drill(seed: int, card: str) -> dict:
    """The overflow drill: a narrow 2-layer Llama at hd 128 (the flash
    kernels' fp16 path; hidden 256, vocabulary 1024, 32 tokens, so that its
    CPU twin's fp16 steps run in seconds: at hidden 512, vocabulary 8192 and
    64 tokens they took a minute on the card's host), from
    ``initial_scale_power`` FP16_DRILL_POWER, on the card and the same
    config on the CPU (plain pieces), until two steps in a row apply.
    Each skipped step must leave every param and optimizer-state tensor bit
    for bit; the two scale sequences must be equal up to where each stops
    skipping, and those points at most one step apart."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=2, num_kv_heads=1, max_seq_len=64)
    masters = llama.init(cfg, torch.Generator().manual_seed(seed + 26))
    rs = np.random.RandomState(seed + 26)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (1, 33)).astype(np.int32)}
    block = dict(FP16_BLOCK, initial_scale_power=FP16_DRILL_POWER)

    def state_of(eng):
        out = {f"p.{k}": v.detach().clone() for k, v in eng.state.params.items()}
        for k, v in _flat_state(eng.state.opt_state).items():
            out[f"s.{k}"] = v.clone()
        return out

    def run(device):
        eng, *_ = dst.initialize(
            model=dst.ModelSpec(params={k: v.to(device) for k, v in masters.items()},
                                loss_fn=lambda p, b: llama.loss_fn(
                                    cfg, p, b, compute_dtype=torch.float16)),
            config=_train_config(seed, 1, True, fp16=block), device=device)
        scales, kept, applied = [], True, 0
        for _ in range(FP16_DRILL_STEPS):
            before = state_of(eng)
            out = eng.train_batch(batch)
            scales.append((float(out.loss_scale), bool(out.overflow)))
            if out.overflow:
                after = state_of(eng)
                kept = kept and all(torch.equal(before[k], after[k]) for k in before)
                applied = 0
            else:
                applied += 1
                if applied == 2:
                    break
        del eng
        return scales, kept

    card_scales, card_kept = run("cuda")
    cpu_scales, cpu_kept = run("cpu")
    stop = [next((i for i, (_, o) in enumerate(sc) if not o), None)
            for sc in (card_scales, cpu_scales)]
    n = min(x for x in stop if x is not None) if None not in stop else 0
    same = [a[0] for a in card_scales[:n]] == [a[0] for a in cpu_scales[:n]]
    log(f"  overflow drill from 2^{FP16_DRILL_POWER}: card scales {[s for s, _ in card_scales]} "
        f"(first applied step {stop[0]}), CPU {[s for s, _ in cpu_scales]} (first applied "
        f"{stop[1]}); skipped steps left params and optimizer state bit for bit: card "
        f"{card_kept}, CPU {cpu_kept}")
    if None in stop or abs(stop[0] - stop[1]) > 1 or not same or not (card_kept and cpu_kept) \
            or stop[0] == 0:
        raise AssertionError("the fp16 overflow drill: scales or skipped steps disagree")
    return {"card": card_scales, "cpu": cpu_scales, "first_applied": stop,
            "skips_kept_state": card_kept and cpu_kept}


def _flat_state(tree, prefix="") -> dict:
    """The tensors of an optimizer state (nested dicts / lists / tuples of
    tensors) by dotted path."""
    import torch

    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_state(v, f"{prefix}.{i}" if prefix else str(i)))
    elif hasattr(tree, "__dict__"):
        out.update(_flat_state(vars(tree), prefix))
    return out


def fp16_zero(seed: int, card: str) -> dict:
    """ZeRO-3 against stage 0 under the fp16 block through a real NCCL group
    of world size 1, at FP16_ZERO_LAYERS: losses, grad norms and scales bit
    for bit (phase 18 holds bf16)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=FP16_ZERO_LAYERS)
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (2, 4096 + 1)).astype(np.int32)}
    comm.init_distributed()
    out = {}
    try:
        comm.init_mesh({"data": 1})
        for stage in (0, 3):
            losses, norms, step_s, _, (_, peak), eng = zero_train(
                seed, cfg, stage, batch, FP16_ZERO_STEPS, fp16=FP16_BLOCK)
            out[stage] = {"losses": losses, "grad_norms": norms, "scale": eng.loss_scale,
                          "peak_bytes": peak}
            del eng
    finally:
        comm.set_mesh(None)
        dist.destroy_process_group()
    same = out[3]["losses"] == out[0]["losses"] and out[3]["grad_norms"] == out[0]["grad_norms"] \
        and out[3]["scale"] == out[0]["scale"]
    log(f"  fp16 ZeRO-3 against ZeRO-0 ({FP16_ZERO_LAYERS} layers, NCCL world 1): losses "
        f"{out[3]['losses']} / {out[0]['losses']}, scale {out[3]['scale']:g} / "
        f"{out[0]['scale']:g}: bit for bit {same}")
    if not same:
        raise AssertionError("fp16 ZeRO-3 differs from stage 0")
    return {"stages": out, "bitwise_equal": same}


def phase_fp16(seed: int, card: str) -> dict:
    """fp16 on the card (module docstring, phase 26)."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.attention import attention
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bias_cuda, flash_bwd_dq_bias_cuda, flash_fwd_bias_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.models.bloom import _alibi_bias

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 26)
    cfg = llama.LlamaConfig.llama3_8b()
    prompts, lengths = spec_prompts(seed, cfg.vocab_size)
    marks = [("start", t_phase)]

    def mark(part):
        marks.append((part, time.perf_counter()))

    res = {"flash": p26_flash(gen, card)}
    mark("flash kernels")
    res["paged"] = p26_paged(gen, card, lengths)
    mark("paged kernel")
    t_kern = time.perf_counter() - t_phase

    # (a) the bias mode through op attention under autograd in fp16 (BLOOM's
    # ALiBi): the path whose launches the kernels line counts for rows 3a-5a
    bias_k = {"flash_fwd_bias": flash_fwd_bias_cuda, "flash_bwd_dq_bias": flash_bwd_dq_bias_cuda,
              "flash_bwd_dkv_bias": flash_bwd_dkv_bias_cuda}
    for c in bias_k.values():
        c.launches = 0
    q, k, v = (_f16_randn(gen, BLOOM_B, BLOOM_S, BLOOM_H, HD).requires_grad_() for _ in range(3))
    o = attention(q, k, v, causal=True, bias=_alibi_bias(BLOOM_H, BLOOM_S, "cuda"))
    o.float().pow(2).mean().backward()
    torch.cuda.synchronize()
    res["bias_entry"] = {"launches": {n: c.launches for n, c in bias_k.items()},
                         "grads_finite": all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))}
    check_launches("fp16 op attention with ALiBi under autograd", res["bias_entry"]["launches"],
                   {n: 1 for n in bias_k})
    del q, k, v, o
    torch.cuda.empty_cache()
    mark("bias entry")

    # (b) training: phase 7's configuration under DeepSpeed's fp16 block
    res["train"] = phase_train(seed, card, label="Llama-3-8B fp16", fp16=FP16_BLOCK)
    gc.collect()
    torch.cuda.empty_cache()
    mark("training")
    res["train_whole_path"] = phase_train_whole(
        seed, card, label="8B-width fp16", layers=FP16_CHECK_LAYERS, seq=FP16_CHECK_SEQ,
        fp16=FP16_BLOCK, grad_tol=FP16_GRAD_RTOL, loss_tol=FP16_LOSS_RTOL)
    mark("card vs CPU step")
    res["drill"] = fp16_drill(seed, card)
    mark("overflow drill")
    res["zero"] = fp16_zero(seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("ZeRO-3")

    # (c) serving Llama-3-8B at 32 layers in fp16: v2 on fp16 pools, on int8
    # pools and under spec + fused verify (graph decode), then v1
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        dtype=torch.float16, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    log(f"  Llama-3-8B fp16 serving weights: {wbytes / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s; a decode step's weight-bytes bound {bound_ms:.2f} ms")
    base = {"dtype": "float16", "prefill_bucket": 64,
            "ragged": {"max_tracked_sequences": 8, "max_ragged_batch_size": 8,
                       "memory_config_blocks": 64, "block_size": 128}}
    serve = phase_spec_serving(
        seed, MAX_NEW_TOKENS, card, cfg=cfg, params=params, base_conf=base,
        engines=(("fp16", {}, prompts), ("int8", INT8, prompts), ("spec_fp16", SPEC, prompts)))
    res["serving"] = serve
    mark("v2 serving")
    busy = serve["fp16"]["profile_steps"]["busy_ms_per_step"]
    log(f"  Llama-3-8B fp16 decode step {serve['fp16']['decode_step_ms']:.2f} ms (device busy "
        f"{busy:.2f} ms) against the weight-bytes bound {bound_ms:.2f} ms; a replay launches "
        f"{serve['fp16']['per_replay']} [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    v1 = dst.init_inference(llama, model_cfg=cfg, params=params,
                            config={"dtype": "float16", "prefill_bucket": 64})
    _v1_generate(v1, prompts[:2], 2)                                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v1_outs, padded, lens = _v1_generate(v1, prompts, MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    v1_s = time.perf_counter() - t0
    # the no-cache forward runs the fp16 flash forward (v1's dense-cache
    # prefill and decode read the cache with plain masked attention, as in JAX)
    flash_fwd_cuda.launches = 0
    match, n_tok, worst = stream_check(v1, padded, lens, v1_outs)
    v1_flash = flash_fwd_cuda.launches
    check_launches("v1 fp16 no-cache forwards", {"flash_fwd": v1_flash},
                   {"flash_fwd": cfg.num_layers * len(prompts)})
    v2_outs = [list(map(int, r)) for r in serve["fp16"]["outs"]]
    leave = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(v1_outs, v2_outs)]
    long_ = torch.as_tensor(prompts[-1], device="cuda")[None].long()
    with torch.inference_mode():
        noise16 = row_err(llama.apply(cfg, params, long_, compute_dtype=torch.float16),
                          llama.apply(cfg, params, long_, compute_dtype=torch.float32))[1]
    parting = v1_v2_parting(cfg, v1, padded, lens, v1_outs, v2_outs, leave, [], noise16)
    agree = sum(x is None for x in leave)
    verdicts = [r["verdict"] for r in parting["rows"].values()]
    log(f"  Llama-3-8B v1 fp16: {v1_s:.1f} s for 8 x {MAX_NEW_TOKENS} tokens; its tokens against "
        f"its no-cache forward: {match}/{n_tok} the argmax, largest gap {worst:.4f}; v1 against "
        f"v2 at {cfg.num_layers} layers: {agree} of {len(prompts)} rows the same, first "
        f"differing step by row {leave}, partings {verdicts} (fp16 error {noise16:.4f}) [{card}]")
    if 2 * agree < len(prompts) or any(v != "near-tie" for v in verdicts):
        raise AssertionError("fp16 v1 and v2 part beyond the near-tie rule")
    res["v1"] = {"generate_s": v1_s, "launches": {"flash_fwd": v1_flash}, "outs": v1_outs,
                 "v1_v2_first_difference": leave, "agree_rows": agree, "fp16_noise": noise16,
                 "v1_v2_parting": parting, "argmax_match": [match, n_tok], "worst_gap": worst}
    del v1
    gc.collect()
    torch.cuda.empty_cache()
    mark("v1 serving")

    # (d) at FP16_CHECK_LAYERS: every token of v1, v2 (fp16 and int8 pools,
    # spec + fused verify) against the fp32 forward of the same fp16 weights
    small = dataclasses.replace(cfg, num_layers=FP16_CHECK_LAYERS)
    sp = layers_of(params, FP16_CHECK_LAYERS)
    v1s = dst.init_inference(llama, model_cfg=small, params=sp,
                             config={"dtype": "float16", "prefill_bucket": 64})
    outs = {"v1": _v1_generate(v1s, prompts, MAX_NEW_TOKENS)[0]}
    with fault_cache_write_late() as what:
        bad = _v1_generate(v1s, prompts[:3], 8)[0]
    del v1s
    for name, extra in (("v2 fp16", {}), ("v2 int8 pools", INT8),
                        ("v2 spec + fused verify", SPEC)):
        e2 = build_engine_v2(llama, small, sp, config=dict(base, **extra))
        outs[name] = [list(map(int, o)) for o in e2.generate(prompts,
                                                              max_new_tokens=MAX_NEW_TOKENS)]
        del e2
        torch.cuda.empty_cache()
    res["check"] = fp32_stream_check(f"Llama-3-8B fp16 at {FP16_CHECK_LAYERS} layers", llama,
                                     small, sp, prompts, outs, (what, bad, prompts[:3]),
                                     low=torch.float16)
    del params, sp
    gc.collect()
    torch.cuda.empty_cache()
    mark("2-layer token checks")
    res["part_s"] = {part: round(t - marks[i][1], 1) for i, (part, t) in enumerate(marks[1:])}

    tl = res["train"]["launches"]
    res["launches"] = {
        **{k: {"llama fp16 training": tl[k]}
           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
        **{k: {"op attention fp16 (ALiBi)": n} for k, n in res["bias_entry"]["launches"].items()},
        "paged_decode_attention": {"llama fp16 serving":
                                   serve["fp16"]["launches"]["paged_decode_attention"]
                                   + serve["spec_fp16"]["launches"]["paged_decode_attention"]},
        "paged_decode_attention_int8": {"llama fp16 serving (int8 pools)":
                                        serve["int8"]["launches"]["paged_decode_attention_int8"]},
        "paged_spec_verify_attention": {"llama fp16 serving (spec)":
                                        serve["spec_fp16"]["launches"]
                                        ["paged_spec_verify_attention"]}}
    res["launches"]["flash_fwd"]["llama fp16 v1 no-cache forwards"] = v1_flash
    for k, by_path in res["launches"].items():
        if not sum(by_path.values()):
            raise AssertionError(f"fp16 phase: {k} was never launched on its path")
    res["kernels_s"] = t_kern
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {res['launches']}")
    log(f"  phase 26: {res['phase_s']:.1f} s (kernel checks {t_kern:.1f} s); by part "
        f"{res['part_s']}")
    return res


# --------------------------------------------------------------------------- #
# phase 27: the HF importer; BERT and CLIP
# --------------------------------------------------------------------------- #
HF_LAYERS = 2                  # Llama-3-8B widths in the smoke's HF directory (~3.9 GB bf16)
HF_SHARDS = 2
HF_DIR = REPO / "build" / "hf_llama3_8b"
HF_CHECK_SEQ = 64              # tokens of the stand-in's card-vs-CPU step
P27_STEPS = 4                  # training steps of each model
BERT_BATCH, BERT_SEQ = 8, 512  # BERT-base MLM micro-batch (no mask: the flash kernels)
BERT_CHECK_LAYERS = 2          # the card-vs-CPU steps (BERT-base and CLIP widths)
BERT_CHECK_SEQ = 128
CLIP_BATCH = 32                # CLIP ViT-B/32 image-text pairs a step
CLIP_CHECK_BATCH = 4
# CLIP's card-vs-CPU step in fp32 on both sides: the CPU parity tests'
# limits (loss 1e-5, each leaf's grad 1e-4); PR 25 run 2 read 0 and 4.4e-6
FP32_LOSS_RTOL, FP32_GRAD_RTOL = 1e-5, 1e-4
HF_NAMES = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm",
            "wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
            "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj"}
_ST_DTYPE = {"bfloat16": "BF16", "float16": "F16", "float32": "F32"}


def hf_llama_names(params) -> dict:
    """The port's Llama ``state_dict`` under ``LlamaForCausalLM``'s keys:
    the port keeps each matrix ``[out, in]``, as ``nn.Linear`` does."""
    top = {"embed": "model.embed_tokens.weight", "final_norm": "model.norm.weight",
           "lm_head": "lm_head.weight"}
    out = {}
    for name, t in params.items():
        if name in top:
            out[top[name]] = t
        else:
            _, layer, leaf = name.split(".", 2)
            out[f"model.layers.{layer}.{HF_NAMES[leaf]}.weight"] = t
    return out


def write_safetensors(path, tensors: dict) -> int:
    """``tensors`` (name -> CPU tensor) as one ``.safetensors`` file: the
    8-byte little-endian header length, the JSON header (8-byte aligned),
    the raw data in header order. Returns the data's bytes."""
    import torch

    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPE[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy().data)
    return off


def write_hf_llama_dir(path, cfg, params, shards: int = HF_SHARDS) -> dict:
    """A local HF checkpoint of the port's Llama ``params`` (any device,
    written in their dtype) without ``transformers``: ``config.json`` as
    ``LlamaForCausalLM.save_pretrained`` writes it, the weights in
    ``shards`` safetensors files of about equal bytes and their index. No
    fsync: the reads that follow come from the page cache."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    named = hf_llama_names(params)
    dtype = str(next(iter(named.values())).dtype).split(".")[-1]
    config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
              "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_size,
              "max_position_embeddings": cfg.max_seq_len, "rope_theta": cfg.rope_theta,
              "rms_norm_eps": cfg.rms_norm_eps, "tie_word_embeddings": cfg.tie_embeddings,
              "attention_bias": False, "hidden_act": "silu", "torch_dtype": dtype}
    (path / "config.json").write_text(json.dumps(config, indent=2))
    sizes = {k: t.numel() * t.element_size() for k, t in named.items()}
    total, per = sum(sizes.values()), -(-sum(sizes.values()) // shards)
    groups, acc = [[]], 0
    for k in named:
        if acc >= per * len(groups):
            groups.append([])
        groups[-1].append(k)
        acc += sizes[k]
    weight_map = {}
    for i, keys in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        write_safetensors(path / fname, {k: named[k].cpu() for k in keys})
        weight_map.update({k: fname for k in keys})
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return {"bytes": total, "files": len(groups), "config": config}


def p27_counters() -> dict:
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                                         flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, rms_norm_cuda

    return {"flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
            "flash_bwd_dkv": flash_bwd_dkv_cuda, "rms_norm": rms_norm_cuda,
            "layer_norm": layer_norm_cuda}


def p27_train(label: str, model, batch: dict, gas: int, micro: int, want: dict,
              card: str) -> dict:
    """``initialize(model=model)`` on the card (bf16) and ``P27_STEPS``
    steps of ``train_batch`` on ``batch``; the kernels' launches held to
    ``want`` (a step's), the loss finite and falling."""
    import torch

    import deepspeed_tpu_torch as dst

    t0 = time.perf_counter()
    eng, *_ = dst.initialize(model=model, config=_train_config(SEED, gas, True, micro))
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eng.state.params.values())
    counters = p27_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, step_s = [], []
    for _ in range(P27_STEPS):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch).loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {k: c.launches for k, c in counters.items()}
    expect = {k: want.get(k, 0) * P27_STEPS for k in counters}
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(step_s[1:])) * 1e3
    log(f"  {label}: {n_params / 1e6:.1f} M params, set-up {setup_s:.1f} s; losses "
        f"{['%.4f' % x for x in losses]}; step {step_ms:.1f} ms (steps 2-{P27_STEPS}), peak "
        f"{peak / 2**30:.2f} GiB; launches {launches}, expected {expect} [{card}]")
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches} != expected {expect}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: training loss not finite and falling: {losses}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": step_s, "step_ms": step_ms, "launches": launches,
            "n_params": n_params, "peak_mem_bytes": peak, "setup_s": setup_s}


def p27_flash(gen, card: str) -> dict:
    """The flash forward, dQ and dK/dV at BERT-base's attention (8 x 512,
    12 heads of 64, non-causal) and CLIP ViT-B/32's (32 images x 50
    positions, 12 heads, non-causal; 32 texts x 77 tokens, 8 heads, causal),
    bf16 and fp16, against their plain pieces, each with the forward's and
    the backward's planted faults failing; times at BERT-base's shape beside
    the bound, the plain pieces and SDPA. LayerNorm at CLIP's text width
    (32 x 77 rows of 512) and at 768 ([4096 x 768], BERT-base's rows; timed
    beside ``F.layer_norm``) with a left-out bias failing, and at 64 rows of
    each width (the warp kernel) with its planted fault failing."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_torch, flash_fwd_cuda,
                                                         flash_fwd_torch, sm90_planted_fault)
    from deepspeed_tpu_torch.ops.norms import (layer_norm_cuda, layer_norm_planted_fault,
                                               layer_norm_torch)

    out = {"cases": {}, "planted_faults": {}, "tol": FLASH_TOL, "floor": FLASH_FLOOR}
    cases = (("BERT-base 8x512, 12 heads, non-causal", 8, 512, 12, False),
             ("CLIP vision 32x50, 12 heads, non-causal", 32, 50, 12, False),
             ("CLIP text 32x77, 8 heads, causal", 32, 77, 8, True))
    for label, b, s, h, causal in cases:
        for dtype in (torch.bfloat16, torch.float16):
            name = f"{label} {str(dtype)[6:]}"
            q, k, v, do = (torch.randn(b, s, h, 64, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            kw = {"causal": causal}
            o, lse = flash_fwd_cuda(q, k, v, **kw)
            o_ref, lse_ref = flash_fwd_torch(q, k, v, **kw)
            errs = {"o": check_close(f"flash fwd {name} o", o, o_ref, FLASH_TOL["o"],
                                     floor=FLASH_FLOOR["o"])}
            if not bool(((lse - lse_ref).abs() <= LSE_ATOL + LSE_RTOL * lse_ref.abs()).all()):
                raise AssertionError(f"flash fwd {name}: lse disagrees with the plain version")
            ref = dict(zip(("dq", "dk", "dv"), flash_bwd_torch(q, k, v, o, lse, do, **kw)))
            errs.update(_check_pieces(f"flash bwd pieces {name}",
                                      _bwd_pieces(q, k, v, do, o, lse, kw), ref,
                                      ("dq", "dk", "dv")))
            out["cases"][name] = _pieces_result(errs)
            faults = {}
            with sm90_planted_fault(2):
                o_bad, _ = flash_fwd_cuda(q, k, v, **kw)
                torch.cuda.synchronize()
            faults["fwd: last kv tile dropped"] = _fault_must_fail(
                f"{name}, forward's last kv tile dropped", o_bad, o_ref, "o")
            for fault, what, keys in BWD_FAULTS[1:]:     # each bites at any length
                with sm90_planted_fault(fault, "bwd"):
                    bad = _bwd_pieces(q, k, v, do, o, lse, kw)
                faults[what] = [_fault_must_fail(f"{name}, {what}, {key}", bad[key], ref[key],
                                                 key) for key in keys]
            out["planted_faults"][name] = faults
            if dtype == torch.bfloat16 and label.startswith("BERT"):
                work = flash_work(s, s, h, False, 0, None, b=b, hd=64, h=h)
                out["timing"] = _time_flash(q, k, v, do, kw, work)
                out["pairs"] = work["pairs"]
                _log_times(label, out["timing"], card)
            del q, k, v, do, o, lse, o_ref, ref
            torch.cuda.empty_cache()
    out["layer_norm"] = {}
    for rows, d in ((32 * 77, 512), (4096, 768), (64, 512), (64, 768)):
        for dtype in (torch.bfloat16, torch.float16):
            x = (torch.randn(rows, d, generator=gen, device="cuda") * 3).to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
            bias = (0.2 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
            tol = RMS_TOL if dtype == torch.bfloat16 else FP16_TOL
            ref = layer_norm_torch(x, w, bias, 1e-5)
            err = check_close(f"layer_norm [{rows} x {d}] {str(dtype)[6:]}",
                              layer_norm_cuda(x, w, bias, 1e-5), ref, tol)
            # the warp kernel (a few rows an SM) carries the planted fault;
            # the block kernel's check must fail a left-out bias
            if rows <= 64:
                what = "lane 31's share left out"
                with layer_norm_planted_fault(1):
                    bad = layer_norm_cuda(x, w, bias, 1e-5)
                    torch.cuda.synchronize()
            else:
                what, bad = "bias left out", layer_norm_cuda(x, w, None, 1e-5)
            bad_rel = row_err(bad, ref)[1]
            log(f"  planted fault ({what}) at [{rows} x {d}]: row err/RMS {bad_rel:.4f} "
                f"(must exceed {tol:g})")
            if bad_rel <= tol:
                raise AssertionError(f"the layer_norm check passes a planted fault ({what}) "
                                     f"at [{rows} x {d}]")
            r = {"max_abs_err": err[0], "row_err_over_rms": err[1],
                 "planted_fault": {"what": what, "row_err_over_rms": bad_rel}}
            if dtype == torch.bfloat16 and rows > 64:
                nbytes = 2 * x.numel() * 2 + 2 * d * 2
                r.update(ms=measure(lambda: layer_norm_cuda(x, w, bias, 1e-5), 20)["ms"],
                         plain_ms=measure(lambda: layer_norm_torch(x, w, bias, 1e-5), 20)["ms"],
                         library_ms=measure(lambda: F.layer_norm(x, (d,), w, bias, 1e-5),
                                            20)["ms"],
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                         bytes=nbytes)
                log(f"  layer_norm [{rows} x {d}] bf16: device kernel {r['ms'] * 1e3:.2f} us, "
                    f"bound {r['bound_ms'] * 1e3:.2f} us (bytes), plain "
                    f"{r['plain_ms'] * 1e3:.2f} us, F.layer_norm {r['library_ms'] * 1e3:.2f} "
                    f"us [{card}]")
            out["layer_norm"][f"{rows}x{d} {str(dtype)[6:]}"] = r
            del x, w, bias
    return out


def p27_hf_llama(seed: int, card: str) -> dict:
    """(a) the smoke's own HF directory of Llama-3-8B widths at ``HF_LAYERS``
    layers, served through ``build_hf_engine`` (graph decode, plain and
    speculative with fused verify) and ``init_inference(checkpoint=)``,
    every token held to the fp32 forward; (b) ``initialize(model=...)`` on
    the reader's stand-in of a ``transformers`` model: ``P27_STEPS`` steps,
    and one step on the card against the CPU's."""
    import shutil

    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.engine_v2 import build_hf_engine
    from deepspeed_tpu_torch.models import hf_import, llama
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

    res = {}
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=HF_LAYERS)
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(seed + 27),
                        dtype=torch.bfloat16, device="cuda")
    shutil.rmtree(HF_DIR, ignore_errors=True)
    written = write_hf_llama_dir(HF_DIR, cfg, params)
    res["write"] = {"bytes": written["bytes"], "files": written["files"],
                    "s": time.perf_counter() - t0}
    log(f"  wrote {HF_DIR.name}: {written['files']} safetensors shards + index, "
        f"{written['bytes'] / 1e9:.2f} GB bf16 in {res['write']['s']:.1f} s")
    prompts, _ = spec_prompts(seed, cfg.vocab_size)
    base = {"dtype": "bfloat16", "prefill_bucket": 64,
            "ragged": {"max_tracked_sequences": 8, "max_ragged_batch_size": 8,
                       "memory_config_blocks": 64, "block_size": 128}}
    loads = []

    def build(conf):
        t = time.perf_counter()
        eng = build_hf_engine(str(HF_DIR), config=conf)
        loads.append(time.perf_counter() - t)
        return eng

    serve = phase_spec_serving(seed, MAX_NEW_TOKENS, card, family=llama, cfg=cfg,
                               engines=(("bf16", {}, prompts), ("spec_bf16", SPEC, prompts)),
                               base_conf=base, build=build)
    log(f"  build_hf_engine: read, imported and on the card in {['%.1f' % x for x in loads]} s")
    res["serving"] = serve
    res["build_hf_engine_s"] = loads

    # v1 from the directory; the bf16 weights it holds are the fp32 check's
    t0 = time.perf_counter()
    v1 = dst.init_inference(checkpoint=str(HF_DIR),
                            config={"dtype": "bfloat16", "prefill_bucket": 64})
    v1_load = time.perf_counter() - t0
    same = all(torch.equal(v1.params[k], params[k]) for k in params)
    log(f"  init_inference(checkpoint=): {v1_load:.1f} s; its bf16 weights equal the ones "
        f"written: {same}")
    if not same or set(v1.params) != set(params):
        raise AssertionError("init_inference(checkpoint=) read other weights than the ones "
                             "written")
    _v1_generate(v1, prompts[:2], 2)                                     # warm-up
    torch.cuda.synchronize()
    rms_norm_cuda.launches = 0
    t0 = time.perf_counter()
    v1_outs = _v1_generate(v1, prompts, MAX_NEW_TOKENS)[0]
    torch.cuda.synchronize()
    v1_s = time.perf_counter() - t0
    v1_rms = rms_norm_cuda.launches
    check_launches("HF Llama v1 generate", {"rms_norm": v1_rms},
                   {"rms_norm": (2 * cfg.num_layers + 1) * MAX_NEW_TOKENS})
    with fault_cache_write_late() as what:
        bad = _v1_generate(v1, prompts[:3], 8)[0]
    outs = {"v2 bf16": serve["bf16"]["outs"], "v2 spec + fused verify": serve["spec_bf16"]["outs"],
            "v1": v1_outs}
    res["check"] = fp32_stream_check(f"HF Llama-3-8B widths at {HF_LAYERS} layers", llama, cfg,
                                     params, prompts, outs, (what, bad, prompts[:3]))
    res["v1"] = {"load_s": v1_load, "generate_s": v1_s, "launches": {"rms_norm": v1_rms}}
    del v1, params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) initialize(model=<stand-in>): the reader's config and fp32 weights
    # behind a transformers model's two attributes
    t0 = time.perf_counter()
    stand_in = hf_import.read_hf_dir(str(HF_DIR))
    read_s = time.perf_counter() - t0
    if not hf_import.is_hf_model(stand_in):
        raise AssertionError("the reader's stand-in is not taken for a transformers model")
    rs = np.random.RandomState(seed + 27)
    gas, seq = 2, 4096
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (gas, seq + 1)).astype(np.int32)}
    per = {"flash_fwd": cfg.num_layers * gas, "flash_bwd_dq": cfg.num_layers * gas,
           "flash_bwd_dkv": cfg.num_layers * gas, "rms_norm": (2 * cfg.num_layers + 1) * gas}
    res["train"] = p27_train(f"initialize(model=<HF stand-in>), {HF_LAYERS} layers, "
                             f"{gas} x {seq} tokens", stand_in, batch, gas, 1, per, card)
    res["train"]["read_s"] = read_s
    res["train_whole_path"] = phase_train_whole(
        seed, card, family=llama, cfg=cfg, label=f"HF Llama-3-8B widths ({HF_LAYERS} layers)",
        layers=None, seq=HF_CHECK_SEQ, model_of=lambda device: stand_in)
    del stand_in
    shutil.rmtree(HF_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def clip_against() -> dict:
    """CLIP's K biases: zero gradients in exact arithmetic (softmax drops a
    shift of every key), each held against its layer's Q bias's norm."""
    return {f"{t}.layers.{l}.bk": f"{t}.layers.{l}.bq"
            for t in ("text", "vision") for l in range(BERT_CHECK_LAYERS)}


def phase_hf(seed: int, card: str) -> dict:
    """The HF importer, BERT-base and CLIP ViT-B/32 (module docstring,
    phase 27)."""
    import torch

    from deepspeed_tpu_torch.models import bert, clip

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 27)
    res = {"kernels": p27_flash(gen, card)}
    res["hf"] = p27_hf_llama(seed, card)

    # (c) BERT-base MLM: 8 x 512 without a mask (flash, non-causal), fp32
    # embedding LayerNorm then bf16 blocks
    bcfg = bert.BertConfig()
    rs = np.random.RandomState(seed + 28)

    def mlm_batch(b, s, vocab):
        tokens = rs.randint(0, vocab, (b, s)).astype(np.int32)
        labels = np.where(rs.rand(b, s) < 0.15, tokens, -100).astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    L = bcfg.num_layers
    per = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "layer_norm": 2 * L + 1}
    res["bert"] = {"train": p27_train(
        f"BERT-base MLM, {BERT_BATCH} x {BERT_SEQ}", bert.model_spec(bcfg),
        mlm_batch(BERT_BATCH, BERT_SEQ, bcfg.vocab_size), 1, BERT_BATCH, per, card)}
    res["bert"]["masked"] = p27_bert_masked(seed, bcfg, card)
    small = dataclasses.replace(bcfg, num_layers=BERT_CHECK_LAYERS)
    res["bert"]["train_whole_path"] = phase_train_whole(
        seed, card, family=bert, cfg=small, label="BERT-base width",
        fault=(fault_zero_dv_head, fault_zero_ln_db), layers=None,
        batch=mlm_batch(1, BERT_CHECK_SEQ, bcfg.vocab_size))

    # (d) CLIP ViT-B/32 contrastive: the vision tower non-causal at S 50, the
    # text tower causal at S 77
    ccfg = clip.CLIPConfig()

    def clip_batch(b):
        tokens = rs.randint(0, ccfg.eos_token_id - 1, (b, ccfg.max_seq_len)).astype(np.int32)
        tokens[np.arange(b), rs.randint(8, ccfg.max_seq_len, b)] = ccfg.eos_token_id
        images = rs.randn(b, 3, ccfg.image_size, ccfg.image_size).astype(np.float32)
        return {"tokens": tokens, "images": images}

    Lt, Lv = ccfg.text.num_layers, ccfg.vision.num_layers
    per = {"flash_fwd": Lt + Lv, "flash_bwd_dq": Lt + Lv, "flash_bwd_dkv": Lt + Lv,
           "layer_norm": 2 * Lt + 1 + 2 * Lv + 2}
    res["clip"] = {"train": p27_train(
        f"CLIP ViT-B/32 contrastive, {CLIP_BATCH} pairs",
        clip.model_spec(ccfg, compute_dtype=torch.bfloat16), clip_batch(CLIP_BATCH), 1,
        CLIP_BATCH, per, card)}
    towers = {t: dataclasses.replace(getattr(ccfg, t), num_layers=BERT_CHECK_LAYERS)
              for t in ("text", "vision")}
    # in fp32 on both sides: the InfoNCE head in bf16 rounds p - onehot to
    # ~20% on the leaves beside it (PERF.md section 6, PR 25), so a limit
    # sound bf16 steps pass would pass the planted faults too
    res["clip"]["train_whole_path"] = phase_train_whole(
        seed, card, family=clip, cfg=dataclasses.replace(ccfg, **towers),
        label="CLIP ViT-B/32 width", fault=(fault_zero_dv_head, fault_zero_ln_db),
        layers=None, against=clip_against(), batch=clip_batch(CLIP_CHECK_BATCH),
        card_bf16=False, loss_tol=FP32_LOSS_RTOL, grad_tol=FP32_GRAD_RTOL)

    hl = res["hf"]
    serve = hl["serving"]
    bt, ct = res["bert"]["train"]["launches"], res["clip"]["train"]["launches"]
    res["launches"] = {
        "rms_norm": {"hf llama serving": serve["bf16"]["launches"]["rms_norm"]
                     + serve["spec_bf16"]["launches"]["rms_norm"],
                     "hf llama v1": hl["v1"]["launches"]["rms_norm"],
                     "hf llama training": hl["train"]["launches"]["rms_norm"]},
        "paged_decode_attention": {
            "hf llama serving": serve["bf16"]["launches"]["paged_decode_attention"]
            + serve["spec_bf16"]["launches"]["paged_decode_attention"]},
        "paged_spec_verify_attention": {
            "hf llama serving": serve["spec_bf16"]["launches"]["paged_spec_verify_attention"]},
        **{k: {"hf llama training": hl["train"]["launches"][k], "bert training": bt[k],
               "clip training": ct[k]} for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
        "layer_norm": {"bert training": bt["layer_norm"], "clip training": ct["layer_norm"]}}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {res['launches']}")
    log(f"  phase 27: {res['phase_s']:.1f} s")
    return res


def p27_bert_masked(seed: int, cfg, card: str) -> dict:
    """BERT-base forwards with an ``attention_mask`` (bf16, the card):
    attention runs plain, as in the JAX package (no flash launch); changing
    the tokens behind the mask leaves every unmasked row's hidden state bit
    for bit; the masked forward's MLM logits stay within ``V1_NOISE_RATIO``
    x the unmasked (flash) bf16 forward's own distance from fp32."""
    import torch

    from deepspeed_tpu_torch.models import bert

    params = bert.init(cfg, torch.Generator(device="cuda").manual_seed(seed + 29))
    rs = np.random.RandomState(seed + 29)
    b, s = 4, 256
    tokens = torch.as_tensor(rs.randint(0, cfg.vocab_size, (b, s)), device="cuda")
    mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
    lens = [256, 200, 77, 129]
    for i, n in enumerate(lens):
        mask[i, n:] = 0
    other = tokens.clone()
    other[mask == 0] = (other[mask == 0] + 1) % cfg.vocab_size
    counters = p27_counters()
    for c in counters.values():
        c.launches = 0
    with torch.inference_mode():
        out = bert.apply(cfg, params, tokens, attention_mask=mask)
        out2 = bert.apply(cfg, params, other, attention_mask=mask)
        ref = bert.apply(cfg, params, tokens, attention_mask=mask, compute_dtype=torch.float32)
        launches = {k: c.launches for k, c in counters.items()}
        full = bert.apply(cfg, params, tokens)
        full32 = bert.apply(cfg, params, tokens, compute_dtype=torch.float32)
    keep = mask.bool()
    same = bool(torch.equal(out["hidden"][keep], out2["hidden"][keep]))
    err = row_err(out["mlm_logits"][keep], ref["mlm_logits"][keep])[1]
    noise = row_err(full["mlm_logits"], full32["mlm_logits"])[1]
    tol = V1_NOISE_RATIO * noise
    want = {k: 3 * (2 * cfg.num_layers + 1) if k == "layer_norm" else 0 for k in counters}
    log(f"  BERT-base masked forward ({b} x {s}, lengths {lens}): launches {launches} (expected "
        f"{want}); unmasked rows unchanged by the masked tokens: {same}; MLM logits against "
        f"fp32 {err:.4f} of a row's RMS (limit {tol:.4f}: {V1_NOISE_RATIO} x the unmasked "
        f"flash forward's {noise:.4f}) [{card}]")
    if launches != want or not same or not err <= tol:
        raise AssertionError("BERT's masked forward: a flash launch, a masked token reaching "
                             "an unmasked row, or logits away from fp32")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "unmasked_rows_unchanged": same, "logits_vs_fp32": err,
            "flash_noise": noise, "tol": tol}


def fp16_subentries(kernels: list, f16: dict) -> None:
    """Each 16-bit kernel's fp16 instantiation (phase 26) as the ``fp16``
    sub-entry of its row of the ``kernels`` line: its launches on the fp16
    paths, its largest error against the plain version and its times at
    Llama-3-8B's shapes (the bias mode at BLOOM-7b1's)."""
    fl, pg, err = f16["flash"], f16["paged"], f16["flash"]["max_abs_err"]
    main, bias = fl["timing"][FP16_FLASH_CASES[0][0]], fl["timing"][FP16_BIAS_LABEL]
    rows = {"paged_decode_attention": (pg["timing"]["decode_fp16_main_path"],
                                       pg["max_abs_err"]["decode"]),
            "paged_decode_attention_int8": (pg["timing"]["decode_int8_main_path"],
                                            pg["max_abs_err"]["decode"]),
            "paged_spec_verify_attention": (pg["timing"]["verify_fp16_main_path"],
                                            pg["max_abs_err"]["verify"]),
            "flash_fwd": (main["fwd"], err["o"]), "flash_bwd_dq": (main["dq"], err["dq"]),
            "flash_bwd_dkv": (main["dkv"], max(err["dk"], err["dv"])),
            "flash_fwd_bias": (bias["fwd"], err["o"]),
            "flash_bwd_dq_bias": (bias["dq"], err["dq"]),
            "flash_bwd_dkv_bias": (bias["dkv"], max(err["dk"], err["dv"]))}
    for k in kernels:
        if k["name"] in rows:
            t, e = rows[k["name"]]
            by_path = f16["launches"][k["name"]]
            k["fp16"] = {"launches": sum(by_path.values()), "launches_by_path": by_path,
                         "max_abs_err": e, **{x: t[x] for x in ("ms", "plain_ms", "bound_ms",
                                                                 "bound_by", "library_ms")}}


def hf_subentries(kernels: list, p27: dict) -> None:
    """Phase 27's paths as the ``hf``, ``bert`` and ``clip`` sub-entries of
    rows 1-7 of the ``kernels`` line: each path's launches and, where phase
    27 checked and timed the kernel at its shapes, its largest error and
    its times (the flash kernels at BERT-base's attention, LayerNorm at
    BERT-base's [4096 x 768] and CLIP's text rows of 512)."""
    fl, ln = p27["kernels"], p27["kernels"]["layer_norm"]
    groups = {"hf": "hf llama", "bert": "bert", "clip": "clip"}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        by_path = p27["launches"].get(k["name"])
        if by_path is None:
            continue
        for sub, prefix in groups.items():
            mine = {p: n for p, n in by_path.items() if p.startswith(prefix)}
            if not mine:
                continue
            entry = {"launches": sum(mine.values()), "launches_by_path": mine}
            key = {"flash_fwd": "fwd", "flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}.get(k["name"])
            if key and sub in ("bert", "clip"):
                errs = [c["max_abs_err"] for name, c in fl["cases"].items()
                        if name.startswith(sub.upper())]
                err_keys = ("o",) if key == "fwd" else ("dq",) if key == "dq" else ("dk", "dv")
                entry["max_abs_err"] = max(e[x] for e in errs for x in err_keys)
                if sub == "bert":
                    entry.update({x: fl["timing"][key][x] for x in keys})
            if k["name"] == "layer_norm":
                r = ln["4096x768 bfloat16" if sub == "bert" else f"{32 * 77}x512 bfloat16"]
                entry.update({"max_abs_err": r["max_abs_err"], **{x: r[x] for x in keys}})
            k[sub] = entry


def profile_sessions(detail, path: str = "") -> dict:
    """Each ``sessions`` count in ``detail`` by its dotted path: the
    profiler sessions a checked window took (phases 16 and 17)."""
    out = {}
    if isinstance(detail, dict):
        for k, v in detail.items():
            sub = f"{path}.{k}" if path else str(k)
            if k == "sessions" and isinstance(v, int):
                out[path] = v
            else:
                out.update(profile_sessions(v, sub))
    return out


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
    marks = {}      # phase banner -> seconds since the start, for "phase_start_s"

    def log_phase(msg: str) -> None:
        marks[msg.split(":")[0].lstrip("= ")] = round(time.perf_counter() - t_all, 1)
        log(msg)

    log_phase("== phase 1: device")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python {sys.version.split()[0]}")

    log_phase("== phase 2: build")
    from deepspeed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"  built {[s.name for s in _build.sources()]} in {build_s:.1f} s")

    log_phase("== phase 3: kernels against their plain versions")
    kern, decode_case = phase_kernels(SEED, card)
    kern["flash"] = phase_flash(SEED, card)
    kern["rows"], rows_case = phase_rows_kernels(SEED, card)
    kern["paged_sm90"] = phase_paged_sm90(SEED, card)
    kern.update(phase_ln_quant_kernels(SEED, card))
    kern["opt_shapes"] = phase_opt_shapes(SEED, card)
    kern["flash_bias"] = phase_bias_kernels(SEED, card)
    kern["sparse"] = phase_sparse_kernels(SEED, card)

    log_phase("== phase 4: main path (Llama-3-8B shapes through generate)")
    main_res = phase_main_path(SEED, MAX_NEW_TOKENS, card)

    # the paged-decode inputs of the main path's last decode step: the 8
    # prompts' slots at prompt_len + max_new_tokens - 2 cached tokens, the
    # other 56 slots inactive (ctx 0 on the trash block)
    main_case = decode_case(*main_step_inputs(main_res["prompt_lengths"],
                                              main_res["max_new_tokens"] - 2),
                            "main-path last step")
    kern["paged_decode"]["cases"]["main_path"] = main_case

    log_phase("== phase 5: speculative serving (Llama-3-8B through generate; fused verify on "
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

    log_phase("== phase 6: whole path on the card against the plain path on the CPU")
    whole = phase_whole_path(SEED, card)
    whole_spec = phase_whole_path_spec(SEED, card)

    log_phase("== phase 7: training main path (Llama-3-8B width, 4 layers, through train_batch)")
    train = phase_train(SEED, card)

    log_phase("== phase 8: whole training step on the card against the plain path on the CPU")
    train_whole = phase_train_whole(SEED, card)

    from deepspeed_tpu_torch.models import gpt

    opt_cfg = dataclasses.replace(gpt.GPTConfig.opt_1_3b(), activation="relu")
    log_phase("== phase 9: OPT-1.3B serving (24 layers through generate; bf16 pools, then "
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

    log_phase("== phase 10: OPT-1.3B training (24 layers through train_batch)")
    opt_train = phase_train(SEED, card, family=gpt, cfg=opt_cfg, label="OPT-1.3B",
                            seq=2048, gas=2, micro=OPT_MICRO, norm="layer_norm")

    log_phase("== phase 11: OPT-1.3B width, whole paths on the card against the plain paths "
              "on the CPU")
    opt_whole = phase_whole_path(SEED, card, family=gpt, cfg=opt_cfg, label="OPT-1.3B-width")
    opt_train_whole = {
        act: phase_train_whole(
            SEED, card, family=gpt, cfg=dataclasses.replace(opt_cfg, activation=act),
            label=f"OPT-1.3B-width ({act})", fault=fault_zero_ln_db, grad_tol=tol)
        for act, tol in (("relu", TRAIN_GRAD_RTOL_RELU), ("gelu", TRAIN_GRAD_RTOL))}

    log_phase("== phase 12: inference module system (weight-only int8 linear, LayerNorm slot)")
    mods = phase_modules(SEED, card)

    from deepspeed_tpu_torch.models import bloom

    bloom_cfg = dataclasses.replace(bloom.BloomConfig.bloom_7b1(), num_layers=4)
    log_phase("== phase 13: BLOOM-7b1 width training (4 layers through train_batch, ALiBi through "
              "the flash kernels' bias mode)")
    bloom_train = phase_train(SEED, card, family=bloom, cfg=bloom_cfg, label="BLOOM-7b1",
                              seq=BLOOM_S, gas=2, micro=BLOOM_MICRO, norm="layer_norm",
                              bias_mode=True, norms_per_layer_extra=2)

    log_phase("== phase 14: BLOOM-7b1 width, whole training step on the card against the plain "
              "path on the CPU")
    bloom_whole = phase_train_whole(SEED, card, family=bloom, cfg=bloom.BloomConfig.bloom_7b1(),
                                    label="BLOOM-7b1-width",
                                    fault=(fault_zero_alibi, fault_zero_ln_db),
                                    against=TRAIN_GRAD_AGAINST_BLOOM,
                                    leaf_tol=TRAIN_LEAF_TOL_BLOOM, seq=BLOOM_CHECK_SEQ)

    log_phase("== phase 15: attention entry points under autograd (msa_row_attention, "
              "blocksparse_attention)")
    entry = phase_entry_points(SEED, card)

    log_phase("== phase 16: serving core (Llama-3-8B, 32 layers: step_many as one CUDA graph, "
              "prefix cache, split prefill, fork, park / resume, KV handoff)")
    core = phase_serving_core(SEED, card)

    log_phase(f"== phase 17: serving fleet (Llama-3-8B, {FLEET_LAYERS} layers: continuous-batching "
              "scheduler, router failover, disaggregated prefill / decode)")
    fleet = phase_serving_fleet(SEED, card)
    fleet_l = fleet["launches"]

    log_phase("== phase 18: data-parallel training with ZeRO stages 0-3 (NCCL, world size 1; "
              "Llama-3-8B width, 4 layers)")
    zero = phase_zero(SEED, card)

    log_phase(f"== phase 19: training checkpoints (NCCL, world size 1, ZeRO-3; Llama-3-8B "
              f"width, {CKPT_LAYERS} layer(s): regular, universal and async tags, resumes, "
              "planted faults)")
    ckpt = phase_checkpoint(SEED, card)

    log_phase("== phase 20: activation checkpointing and the tiled loss head (Llama-3-8B width, "
              "4 layers: remat policies, one long sequence)")
    remat = phase_remat(SEED, card)

    log_phase("== phase 21: init_inference (Llama-3-8B, 32 layers: dense KV cache, int8 / int4 / "
              "fp8 weights)")
    v1 = phase_init_inference(SEED, card)
    log_phase("== phase 21 (BLOOM): v1 forward of BLOOM-7b1 with int8 weights, a block at a time")
    bloom_peak = bloom_v1_peak(SEED, card)

    log_phase("== phase 22: the optimizer set (Llama-3-8B width, 4 layers: multi-tensor AdamW "
              "against its loop, every optimizer against float64, LAMB and Muon at ZeRO 0-3)")
    optim = phase_optimizers(SEED, card, train)

    log_phase(f"== phase 23: EXAONE-4.0-32B (4-layer training; {EXA_SERVE_LAYERS}-layer serving "
              "through v2 and v1, "
              "the windowed paged decode)")
    exa = phase_exaone4(SEED, card)
    exa_l = exa["launches"]

    log_phase(f"== phase 24: Mixtral-8x7B ({MIX_TRAIN_LAYERS}-layer training; "
              f"{MIX_SERVE_LAYERS}-layer serving through v2 and v1; the einsum and compact "
              "dispatches)")
    mix = phase_mixtral(SEED, card)
    mix_l = mix["launches"]

    log_phase("== phase 25: Falcon-7B (MQA: 4-layer training, 32-layer serving through v2 and "
              "v1) and GPT-NeoX-20B (hd 96: 4-layer training, 44-layer v1), GPT-J-6B v1")
    p25 = phase_falcon_neox(SEED, card)
    p25_l = p25["launches"]

    log_phase("== phase 26: fp16 on the card (the flash and paged kernels in fp16; Llama-3-8B "
              "under DeepSpeed's fp16 block: 4-layer training, 32-layer serving through v2 and "
              "v1)")
    f16 = phase_fp16(SEED, card)

    log_phase("== phase 27: the HF importer (a local HF directory of Llama-3-8B widths through "
              "build_hf_engine, init_inference and initialize), BERT-base MLM and CLIP "
              "ViT-B/32 contrastive training")
    p27 = phase_hf(SEED, card)
    p27_l = p27["launches"]

    rms = kern["rms_norm"]["rows"][64]        # decode: 64 slots x d = 4096
    # the serving paths decode through their graphs: each path's launches are
    # its wrappers' (eager forwards) plus the graph's kernel nodes x replays
    core_graph = core["graph_launches"]
    rms_launches = {"serving": main_res["launches"]["rms_norm"],
                    "training": train["launches"]["rms_norm"],
                    "zero training (stages 0-3)": zero["launches"]["rms_norm"],
                    "checkpoint resumes": ckpt["launches"]["rms_norm"],
                    "serving core (graph)": core_graph["rms_norm"],
                    "serving fleet": fleet_l["rms_norm"],
                    "remat training": remat["launches"]["rms_norm"],
                    "v1 serving": v1["launches"]["rms_norm"],
                    "optimizer training": optim["launches"]["rms_norm"],
                    "exaone4 training": exa_l["rms_norm_training"],
                    "exaone4 serving": exa_l["rms_norm_serving"],
                    "mixtral training": mix_l["rms_norm_training"],
                    "mixtral serving": mix_l["rms_norm_serving"], **p27_l["rms_norm"]}
    opt_l = {name: opt_serve[name]["launches"] for name in ("bf16", "spec_int8")}
    decode_launches = {"llama serving": main_res["launches"]["paged_decode_attention"],
                       "opt serving": opt_l["bf16"]["paged_decode_attention"],
                       "serving core (graph)": core_graph["paged_decode_attention"],
                       "serving fleet": fleet_l["paged_decode_attention"],
                       "exaone4 serving": exa_l["paged_decode_attention"],
                       "mixtral serving": mix_l["paged_decode_attention"],
                       "falcon serving": p25_l["paged_decode_attention"],
                       **p27_l["paged_decode_attention"]}
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
            "launches": (train["launches"][name] + opt_train["launches"][name]
                         + zero["launches"][name] + ckpt["launches"][name]
                         + remat["launches"][name] + optim["launches"][name]
                         + mix_l[name] + sum(p25_l[name].values())
                         + sum(p27_l[name].values())),
            "launches_by_path": {"llama training": train["launches"][name],
                                 "opt training": opt_train["launches"][name],
                                 "zero training (stages 0-3)": zero["launches"][name],
                                 "checkpoint resumes": ckpt["launches"][name],
                                 "remat training": remat["launches"][name],
                                 "optimizer training": optim["launches"][name],
                                 # hybrid attention is masked: plain, as in JAX
                                 "exaone4 training": exa["train"]["launches"][name],
                                 "mixtral training": mix_l[name], **p25_l[name],
                                 **p27_l[name]},
            "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # the same kernel at OPT-1.3B's training shape, at GPT-NeoX-20B's
            # (hd 96) and at Falcon-7B's (71 query heads over one kv head)
            **{sub: {k_: t[key][k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")}
               for sub, t in (("opt", flash["opt"]["timing"]),
                              ("hd96", p25["kernels"]["timing"]),
                              ("falcon", p25["kernels"]["falcon"]["timing"]))}})
    rows_t = kern["rows"]["timing"]
    dec8, ver8, ver16 = (rows_t["decode_int8_main_path"], rows_t["verify_int8_main_path"],
                         rows_t["verify_bf16_main_path"])
    int8_launches = {p: spec[p]["launches"]["paged_decode_attention_int8"]
                     for p in ("spec_int8", "int8")}
    int8_launches["opt spec_int8"] = opt_l["spec_int8"]["paged_decode_attention_int8"]
    int8_launches["serving fleet"] = fleet_l["paged_decode_attention_int8"]
    int8_launches["exaone4 serving"] = exa_l["paged_decode_attention_int8"]
    int8_launches["mixtral serving"] = mix_l["paged_decode_attention_int8"]
    int8_launches["falcon serving"] = p25_l["paged_decode_attention_int8"]
    ver_launches = {p: spec[p]["launches"]["paged_spec_verify_attention"]
                    for p in ("spec_bf16", "spec_int8")}
    ver_launches["opt spec_int8"] = opt_l["spec_int8"]["paged_spec_verify_attention"]
    ver_launches["serving core (shared and forked blocks)"] = (
        core["spec"]["launches"]["paged_spec_verify_attention"]
        + core["spec"]["fork_launches"]["paged_spec_verify_attention"])
    ver_launches["serving fleet"] = fleet_l["paged_spec_verify_attention"]
    ver_launches["exaone4 serving"] = exa_l["paged_spec_verify_attention"]
    ver_launches["mixtral serving"] = mix_l["paged_spec_verify_attention"]
    ver_launches["falcon serving"] = p25_l["paged_spec_verify_attention"]
    ver_launches.update(p27_l["paged_spec_verify_attention"])
    ln = kern["layer_norm"]["rows"][64]       # decode: 64 slots x d = 2048
    ln_launches = {"opt serving": opt_l["bf16"]["layer_norm"],
                   "opt spec_int8": opt_l["spec_int8"]["layer_norm"],
                   "opt training": opt_train["launches"]["layer_norm"],
                   "module system": mods["launches"]["layer_norm"], **p25_l["layer_norm"],
                   **p27_l["layer_norm"]}
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
         "bound_by": "bytes", "library_ms": ln["library_ms"],
         # at [4096 x 4544] (Falcon-7B) and [4096 x 6144] (GPT-NeoX-20B)
         **{f"d{d}": {k_: r[k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for d, r in p25["kernels"]["layer_norm"].items()}},
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
    fp16_subentries(kernels, f16)
    hf_subentries(kernels, p27)
    detail = {"card": card, "kind": kind, "build_s": build_s, "kernels": kern,
              "bloom_train": bloom_train, "bloom_train_whole_path": bloom_whole,
              "entry_points": entry,
              "opt_serving": opt_serve, "opt_train": opt_train, "opt_whole_path": opt_whole,
              "opt_train_whole_path": opt_train_whole, "modules": mods,
              "main_path": main_res, "spec_serving": spec, "whole_path": whole,
              "whole_path_spec": whole_spec, "train": train,
              "train_whole_path": train_whole, "serving_core": core, "serving_fleet": fleet,
              "zero": zero, "checkpoint": ckpt, "remat": remat, "init_inference": v1,
              "bloom_v1_peak": bloom_peak, "optimizers": optim, "exaone4": exa,
              "mixtral": mix, "falcon_neox": p25, "fp16": f16, "hf_bert_clip": p27,
              "phase_start_s": marks, "total_s": time.perf_counter() - t_all}
    if args.details:
        path = Path(args.details)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(detail, indent=1, default=str))
    log(f"  total {detail['total_s']:.1f} s; phases start at (s) {marks}")
    # every checked profiler window's sessions (1: its first session held every
    # record), where the tail of the output shows it
    print(json.dumps({"profile_sessions": profile_sessions(detail)}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
