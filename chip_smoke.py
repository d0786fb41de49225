#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # Llama-3-8B shapes, full width and depth

Phases (any failure raises and the script exits nonzero; nothing is caught):

1. Device: require CUDA; print ``nvidia-smi``'s card name and power limit.
2. Build: compile ``deepspeed_tpu_torch/ops/csrc/*.cu`` with nvcc for
   sm_90a into ``build/deepspeed_tpu_torch/`` and print the build seconds.
3. Kernels against their plain PyTorch versions on the card: RMSNorm at
   N in {1, 7, 64, 2048, 4096} rows of d = 4096 (bf16); paged decode at the 8B
   shapes (B = 64 slots, 32 heads, 8 kv heads, hd 128, 512 blocks of 128)
   with random tables and context lengths 0, bs-1, bs, bs+1 .. 8191, with
   and without a window. Each output row's largest error must stay within
   a stated share of that row's RMS (see ``row_err``); one wrong
   block-table entry on the longest row must exceed it, or the check is
   too loose to count. Prints each error beside its tolerance, and each
   kernel's device time (``torch.profiler``) beside its plain version's,
   its bound and (for RMSNorm) ``torch.nn.functional.rms_norm`` as the
   library yardstick.
4. Main path: ``build_engine_v2`` with ``LlamaConfig.llama3_8b()`` (bf16
   weights from a seed, 512 x 128-token KV blocks, 64 slots) and
   ``generate`` on 8 prompts of mixed lengths (one of length 1, one > 128),
   32 greedy tokens each. Launch counters are zeroed just before and read
   just after: RMSNorm must have launched 65 times per forward and paged
   decode 32 times per decode step. Prints TTFT, decode tokens/s and peak
   memory beside the card's name and power limit.
5. Whole path against the plain path: the same width at 2 layers, one
   prompt's prefill and 4 decode steps on the card (kernels) and on the CPU
   (plain versions), logits compared within a bf16 tolerance.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
launches on the main path, times, bound, max error); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--details PATH`` also writes every measurement as JSON to PATH.
"""

from __future__ import annotations

import argparse
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
DECODE_TOL = 0.06      # sound kernels read <= 0.03 (the plain version rounds p
                       # to bf16); one wrong 128-position block reads >= 0.5
WHOLE_PATH_TOL = 0.1   # logits after 2 bf16 layers + lm-head, row RMS ~1
SEED = 0                       # weights, prompts and kernel inputs
MAX_NEW_TOKENS = 32


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


def profile_window(fn):
    """Run ``fn`` under torch.profiler (CUDA activity): (wall s, device-busy
    s, kernels launched, [(kernel, device ms, count)] by device time). One
    stream, so busy time is the sum of the kernels' own times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evts = [e for e in prof.key_averages() if _dev_us(e) > 0]
    if not evts:
        raise RuntimeError("torch.profiler recorded no device time (CUPTI "
                           "saw no kernel); no device time can be reported")
    busy = sum(_dev_us(e) for e in evts) / 1e6
    top = sorted(((e.key, _dev_us(e) / 1e3, e.count) for e in evts),
                 key=lambda t: -t[1])
    return wall, busy, sum(e.count for e in evts), top


def measure(fn, iters: int) -> dict:
    """Device time per call (the kernels' own time, from the profiler) and
    host-loop time per call (CUDA events)."""
    host = time_ms(fn, iters)
    fn()
    _, busy, n_kernels, _ = profile_window(lambda: [fn() for _ in range(iters)])
    return {"ms": busy * 1e3 / iters, "host_ms": host,
            "kernels_per_call": n_kernels / iters}


def row_err(got, ref) -> tuple:
    """(max |got - ref|, max over rows of max |got - ref| / RMS(ref row)),
    a row being the last dimension."""
    diff = (got.float() - ref.float()).abs()
    rms = ref.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return float(diff.max()), float((diff.amax(-1) / rms).max())


def check_close(what: str, got, ref, tol: float) -> tuple:
    """``row_err(got, ref)``; raises unless every row's error is within
    ``tol`` of its RMS and ``got`` is finite."""
    import torch

    err, rel = row_err(got, ref)
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

    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda, rms_norm_torch
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
    out["rms_norm"] = {"max_abs_err": max(e for e, _ in errs),
                       "max_row_err_over_rms": max(r for _, r in errs), "tol": RMS_TOL,
                       "rows": rows}

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
    # warm-up (cuBLAS handles, allocator) outside the counted run
    eng.generate([prompts[0], prompts[2]], max_new_tokens=2)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.forward_log.clear()
    rms_norm_cuda.launches = 0
    paged_decode_attention_cuda.launches = 0
    t_start = time.monotonic()
    outs = eng.generate(prompts, max_new_tokens=max_new_tokens)
    t_end = time.monotonic()
    launches = {"rms_norm": rms_norm_cuda.launches,
                "paged_decode_attention": paged_decode_attention_cuda.launches}
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
    log(f"  forwards: {n_prefill} prefill + {n_decode} decode; launches {launches}, "
        f"expected {want}")
    if launches != want or n_decode == 0:
        raise AssertionError(f"kernel launch counts {launches} != expected {want}")
    first = next(e for e in eng.forward_log if e[0] == "prefill")
    ttft_ms = (first[3] - t_start) * 1e3
    dec = [e for e in eng.forward_log if e[0] == "decode"]
    dec_tokens = sum(e[2] for e in dec)
    dec_s = sum(e[1] for e in dec)
    res = {"ttft_ms": ttft_ms, "decode_tokens_per_s": dec_tokens / dec_s,
           "decode_step_ms": dec_s / len(dec) * 1e3,
           "prefill_ms": first[1] * 1e3, "e2e_s": t_end - t_start,
           "peak_mem_bytes": peak, "launches": launches,
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
    for name, fn, n in (
            ("prefill", lambda: eng.put_many(list(zip(uids, prompts))), 1),
            ("decode", lambda: [eng.step() for _ in range(8)], 8)):
        wall, busy, n_k, top = profile_window(fn)
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
def phase_whole_path(seed: int, card: str):
    import torch

    from deepspeed_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = llama.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    rs = np.random.RandomState(seed + 1)
    prompt = rs.randint(0, cfg.vocab_size, 48).astype(np.int32)
    pad_t, bs, nblocks, steps = 64, 128, 8, 4
    tokens = np.zeros((1, pad_t), np.int32)
    tokens[0, :len(prompt)] = prompt
    valid = np.arange(pad_t)[None, :] < len(prompt)
    tables = np.array([[3, 5] + [0] * (cfg.max_seq_len // bs - 2)], np.int32)

    def run(device, params, feed):
        with torch.device("meta"):
            model = llama.build(cfg)
        model.load_state_dict({k: v.to(device) for k, v in params.items()},
                              strict=True, assign=True)
        cache = llama.init_paged_cache(cfg, nblocks, bs, torch.bfloat16, device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        logits, cache = llama.apply_paged(cfg, model, t(tokens), cache, t(tables),
                                          t(np.zeros(1, np.int32)), valid=t(valid))
        outs = [logits[0, len(prompt) - 1].float().cpu()]
        nxt = int(outs[0].argmax()) if feed is None else feed[0]
        fed = [nxt]
        for s in range(steps):
            ctx = np.array([len(prompt) + s], np.int32)
            logits, cache = llama.apply_paged(cfg, model, t(np.array([[nxt]], np.int32)),
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
    err, rel = check_close("2-layer 8B-width logits, card vs CPU (prefill + 4 decode)",
                           gpu_logits, cpu_logits, WHOLE_PATH_TOL)
    agree = float((gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean())
    log(f"  greedy agreement {agree:.2f}; card {gpu_s:.1f} s, cpu {cpu_s:.1f} s "
        f"(logit std {float(cpu_logits.std()):.3f}) [{card}]")
    return {"max_abs_err": err, "max_row_err_over_rms": rel, "tol": WHOLE_PATH_TOL,
            "argmax_agreement": agree}


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

    log("== phase 4: main path (Llama-3-8B shapes through generate)")
    main_res = phase_main_path(SEED, MAX_NEW_TOKENS, card)

    # the paged-decode inputs of the main path's last decode step: the 8
    # prompts' slots at prompt_len + max_new_tokens - 2 cached tokens, the
    # other 56 slots inactive (ctx 0 on the trash block)
    B, max_blocks, bs = 64, 64, 128
    ctx_np = np.zeros(B, np.int32)
    tables_np = np.zeros((B, max_blocks), np.int32)
    next_blk = 1
    for i, n in enumerate(main_res["prompt_lengths"]):
        ctx_np[i] = n + main_res["max_new_tokens"] - 2
        need = (int(ctx_np[i]) + 1 + bs - 1) // bs
        tables_np[i, :need] = np.arange(next_blk, next_blk + need)
        next_blk += need
    main_case = decode_case(ctx_np, tables_np, "main-path last step")
    kern["paged_decode"]["cases"]["main_path"] = main_case

    log("== phase 5: whole path on the card against the plain path on the CPU")
    whole = phase_whole_path(SEED, card)

    rms = kern["rms_norm"]["rows"][64]        # decode: 64 slots x d = 4096
    kernels = [
        {"name": "rms_norm", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/rms_norm.cu",
         "replaces": "deepspeed_tpu/ops/pallas/norms.py:27",
         "launches": main_res["launches"]["rms_norm"],
         "max_abs_err": kern["rms_norm"]["max_abs_err"],
         "ms": rms["ms"], "plain_ms": rms["plain_ms"], "bound_ms": rms["bound_ms"],
         "bound_by": "bytes", "library_ms": rms["library_ms"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/paged_decode.cu",
         "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:74",
         "launches": main_res["launches"]["paged_decode_attention"],
         "max_abs_err": kern["paged_decode"]["max_abs_err"],
         "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
         "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]
    detail = {"card": card, "kind": kind, "build_s": build_s, "kernels": kern,
              "main_path": main_res, "whole_path": whole,
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
