#!/usr/bin/env python3
"""Device times of the paged-attention kernels of one checkout of the
PyTorch port (bf16 decode, int8 decode, spec verify on bf16 and int8
pools), at the shapes ``chip_smoke.py`` times them:

- Llama-3-8B's main-path step: 64 slots (32 query / 8 kv heads, hd 128,
  512 blocks of 128, tables of 64), the 8 prompts of the serving phases at
  their last steps (``main_step_inputs``), the other 56 slots inactive;
- OPT-1.3B's main-path step (32 / 32 heads, hd 64, tables of 16): bf16
  decode and int8 verify;
- random contexts 0..8191 over the 64 slots (the inputs of
  ``phase_kernels`` / ``phase_rows_kernels``);
- a call with all 64 slots inactive (ctx 0 on the trash block).

    python3 scripts/paged_ab_timing.py --root PATH [--iters 100]

To compare two checkouts, run it on both in turns (parent, change, change,
parent) on one card, one after another: each run builds its checkout's kernels
(into PATH/build/) and prints one JSON line with the card's name and power
limit and, per case, the mean device time of one launch in microseconds
(the paged kernel's own time from ``torch.profiler``, after a warm-up).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

LLAMA = {"nh": 32, "nkv": 8, "hd": 128, "max_blocks": 64}
OPT = {"nh": 32, "nkv": 32, "hd": 64, "max_blocks": 16}
B, BS, NBLOCKS, T = 64, 128, 512, 5
MAIN_LENGTHS = [1, 17, 64, 100, 129, 200, 333, 500]        # phase 4
SPEC_LENGTHS = [24, 64, 100, 129, 150, 200, 300, 500]      # phases 5 and 9 (spec)
OPT_LENGTHS = [1, 17, 64, 100, 129, 333, 700, 1900]        # phase 9 (bf16)
NEW_TOKENS = 32


def step_inputs(lengths, generated, max_blocks, extra=1):
    """``chip_smoke.main_step_inputs``: 64 slots, the first len(lengths)
    holding prompt + generated tokens in fresh blocks, the rest inactive."""
    ctx = np.zeros(B, np.int32)
    tables = np.zeros((B, max_blocks), np.int32)
    nxt = 1
    for i, n in enumerate(lengths):
        ctx[i] = n + generated
        need = (int(ctx[i]) + extra + BS - 1) // BS
        tables[i, :need] = np.arange(nxt, nxt + need)
        nxt += need
    return ctx, tables


def device_us(fn, iters: int, profile_sessions: int = 4) -> float:
    """Mean device time of one call: the kernels' own time in a
    ``torch.profiler`` window of ``iters`` calls (a session that comes back
    without a kernel is run again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(profile_sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages())
        if us > 0:
            return us / iters
    raise RuntimeError("torch.profiler recorded no device time")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="checkout holding deepspeed_tpu_torch/")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("paged_ab_timing.py needs a CUDA GPU", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops.quantization import kv_quantize_int8

    if Path(pa.__file__).resolve().parents[2] != root:
        print(f"imported {pa.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def pools(shape):
        kf, vf = (torch.randn(NBLOCKS, shape["nkv"], BS, shape["hd"], generator=gen,
                              device=dev) for _ in range(2))
        (kc, ks), (vc, vs) = kv_quantize_int8(kf, shape["hd"]), kv_quantize_int8(vf, shape["hd"])
        return {0: (kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}),
                1: (kc, vc, {"k_scale": ks, "v_scale": vs})}

    def case(shape, p, kind, ng, ctx_np, tables_np):
        q1 = torch.randn(B, shape["nh"], shape["hd"], generator=gen, device=dev).to(torch.bfloat16)
        qt = torch.randn(B, T, shape["nh"], shape["hd"], generator=gen,
                         device=dev).to(torch.bfloat16)
        kp, vp, sc = p[ng]
        c = torch.from_numpy(np.asarray(ctx_np, np.int32)).to(dev)
        tb = torch.from_numpy(np.asarray(tables_np, np.int32)).to(dev)
        if kind == "decode":
            fn = (lambda: pa.paged_decode_attention_int8_cuda(q1, kp, vp, tb, c, **sc)) if ng \
                else (lambda: pa.paged_decode_attention_cuda(q1, kp, vp, tb, c))
        else:
            fn = lambda: pa.paged_spec_verify_attention_cuda(qt, kp, vp, tb, c, **sc)  # noqa: E731
        return fn

    out = {"root": str(root), "card": card}
    p = pools(LLAMA)
    mb = LLAMA["max_blocks"]
    dec_main = step_inputs(MAIN_LENGTHS, NEW_TOKENS - 2, mb)
    dec_spec = step_inputs(SPEC_LENGTHS, NEW_TOKENS - 2, mb)
    ver_spec = step_inputs(SPEC_LENGTHS, NEW_TOKENS - T, mb, extra=T)
    # phase_kernels' decode inputs and phase_rows_kernels' (seeds 0 and 5)
    rs = np.random.RandomState(0)
    edge = [0, BS - 1, BS, BS + 1, 2 * BS - 1, 2 * BS, 8191, 8190]
    ctx_rand = np.concatenate([edge, rs.randint(0, 8192, B - len(edge))]).astype(np.int32)
    tab_rand = rs.randint(1, NBLOCKS, (B, mb)).astype(np.int32)
    tab_rand[0] = 0
    rs = np.random.RandomState(5)
    cap = mb * BS
    tab_rows = rs.randint(1, NBLOCKS, (B, mb)).astype(np.int32)
    dec_edge = [0, BS - 1, BS, BS + 1, 2 * BS - 1, 2 * BS, cap - 1, cap - 2]
    ver_edge = [0, BS - T, BS - T + 1, BS - 2, BS - 1, BS, 2 * BS - 3, cap - T]
    ctx_dec = np.concatenate([dec_edge, rs.randint(0, cap, B - len(dec_edge))]).astype(np.int32)
    ctx_ver = np.concatenate([ver_edge, rs.randint(0, cap - T + 1, B - len(ver_edge))]
                             ).astype(np.int32)
    tab_rows[0] = 0
    idle = (np.zeros(B, np.int32), np.zeros((B, mb), np.int32))
    cases = {
        "llama_main_decode_bf16": ("decode", 0, *dec_main),
        "llama_main_decode_int8": ("decode", 1, *dec_spec),
        "llama_main_verify_bf16": ("verify", 0, *ver_spec),
        "llama_main_verify_int8": ("verify", 1, *ver_spec),
        "random_decode_bf16": ("decode", 0, ctx_rand, tab_rand),
        "random_decode_int8": ("decode", 1, ctx_dec, tab_rows),
        "random_verify_bf16": ("verify", 0, ctx_ver, tab_rows),
        "random_verify_int8": ("verify", 1, ctx_ver, tab_rows),
        "inactive_decode_bf16": ("decode", 0, *idle),
        "inactive_verify_bf16": ("verify", 0, *idle),
    }
    us = {}
    for name, (kind, ng, c, tb) in cases.items():
        iters = args.iters if name.startswith(("llama", "inactive")) else max(args.iters // 5, 5)
        us[name] = device_us(case(LLAMA, p, kind, ng, c, tb), iters)
    del p
    torch.cuda.empty_cache()
    p = pools(OPT)
    mb = OPT["max_blocks"]
    us["opt_main_decode_bf16"] = device_us(
        case(OPT, p, "decode", 0, *step_inputs(OPT_LENGTHS, NEW_TOKENS - 2, mb)), args.iters)
    us["opt_main_verify_int8"] = device_us(
        case(OPT, p, "verify", 1, *step_inputs(SPEC_LENGTHS, NEW_TOKENS - T, mb, extra=T)),
        args.iters)
    out["us"] = us
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
