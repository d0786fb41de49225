#!/usr/bin/env python3
"""Device times of the flash-attention kernels of one checkout of the
PyTorch port: the no-bias forward, dQ and dK/dV at Llama-3-8B's training
shape (1 x 4096 tokens, causal, 32 query / 8 kv heads, hd 128, bf16) and
OPT-1.3B's (4 x 2048 tokens, causal, 32 / 32 heads, hd 64) and, where the
checkout has it, the bias mode at BLOOM-7b1's (2 x 2048 tokens, causal, 32
heads, hd 128, ALiBi [32, 1, S] fp32) and at AlphaFold MSA row attention's
(512 rows x 256 residues, non-causal, 8 heads of 32, a full fp32 bias
[512, 8, 256, 256] of 1.07 GB; dQ there also with its fp32 dbias written).

    python3 scripts/flash_ab_timing.py --root PATH [--iters 20]

To compare two checkouts, run it on both in turns (parent, change, change,
parent) on one card in one session: each run builds its checkout's kernels
(into PATH/build/) and prints one JSON line with the card's name and power
limit and the mean device time per launch (CUDA events around ``iters``
back-to-back launches, after a warm-up).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def events_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="checkout holding deepspeed_tpu_torch/")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("flash_ab_timing.py needs a CUDA GPU", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import flash_attention as fa

    if Path(fa.__file__).resolve().parents[2] != root:
        print(f"imported {fa.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, h, hkv, d=128):
        return [torch.randn(b, s, n, d, generator=gen, device=dev).to(torch.bfloat16)
                for n in (h, hkv, hkv, h)]

    def times(q, k, v, do, fwd, dq, dkv, *extra, causal=True, dq_dbias=None):
        kw = {"causal": causal}
        o, lse = fwd(q, k, v, *extra, **kw)
        b, s, h, _ = q.shape
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)
        out = {"fwd_ms": events_ms(lambda: fwd(q, k, v, *extra, **kw), args.iters),
               "dq_ms": events_ms(lambda: dq(q, k, v, do, lse, delta, *extra, **kw),
                                  args.iters),
               "dkv_ms": events_ms(lambda: dkv(q, k, v, do, lse, delta, *extra, **kw),
                                   args.iters)}
        if dq_dbias is not None:   # dQ writing dbias too, as the MSA entry points run it
            out["dq_dbias_ms"] = events_ms(
                lambda: dq_dbias(q, k, v, do, lse, delta, *extra, need_dbias=True, **kw),
                args.iters)
        return out

    plain = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    out = {"root": str(root), "card": card,
           "llama_no_bias": times(*inputs(1, 4096, 32, 8), *plain),
           "opt_no_bias": times(*inputs(4, 2048, 32, 32, 64), *plain)}
    if hasattr(fa, "flash_fwd_bias_cuda"):
        from deepspeed_tpu_torch.models.bloom import _alibi_bias

        bias = (fa.flash_fwd_bias_cuda, lambda *a, **kw: fa.flash_bwd_dq_bias_cuda(*a, **kw)[0],
                fa.flash_bwd_dkv_bias_cuda)
        out["bloom_bias"] = times(*inputs(2, 2048, 32, 32), *bias, _alibi_bias(32, 2048, dev))
        # the no-bias kernels at the same shape: what the bias mode adds
        out["bloom_no_bias"] = times(*inputs(2, 2048, 32, 32), *plain)
        msa = torch.randn(512, 8, 256, 256, generator=gen, device=dev)
        out["msa_bias"] = times(*inputs(512, 256, 8, 8, 32), *bias, msa, causal=False,
                                dq_dbias=fa.flash_bwd_dq_bias_cuda)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
