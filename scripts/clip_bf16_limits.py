#!/usr/bin/env python3
"""How far one CLIP training step in bf16 lands from the same step in fp32,
on the CPU (the port's plain path): the simulation behind the smoke's
choice to hold CLIP's card-vs-CPU step in fp32 on both sides.

CLIP ViT-B/32's widths (``CLIPConfig()``) at 2 layers a tower, 4
image-text pairs, weights and data from each seed. For each seed: the
loss's relative error and the five leaves with the largest relative
Frobenius error of their gradient (the K biases, zero in exact
arithmetic, against their Q biases' norms). The contrastive head computes
p - onehot in the compute dtype, so the leaves beside it carry bf16's
rounding of that difference.

    python3 scripts/clip_bf16_limits.py [--seeds 4] [--threads 8]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deepspeed_tpu_torch.models import clip  # noqa: E402

LAYERS, PAIRS = 2, 4


def step_errors(cfg, seed: int):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.eos_token_id - 1, (PAIRS, cfg.max_seq_len)).astype(np.int64)
    tokens[np.arange(PAIRS), rs.randint(8, cfg.max_seq_len, PAIRS)] = cfg.eos_token_id
    images = rs.randn(PAIRS, 3, cfg.image_size, cfg.image_size).astype(np.float32)
    batch = {"tokens": torch.from_numpy(tokens), "images": torch.from_numpy(images)}
    master = clip.init(cfg, torch.Generator().manual_seed(seed + 2))
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        p = {k: v.detach().clone().to(dt).requires_grad_() for k, v in master.items()}
        loss, _ = clip.loss_fn(cfg, p, batch, compute_dtype=dt)
        loss.backward()
        out[dt] = (float(loss.detach()), {k: v.grad.float() for k, v in p.items()})
    (l16, g16), (l32, g32) = out[torch.bfloat16], out[torch.float32]
    rel = {}
    for k in g32:
        ref = k.replace(".bk", ".bq") if k.endswith(".bk") else k
        rel[k] = float((g16[k] - g32[k]).norm() / g32[ref].norm().clamp_min(1e-30))
    return abs(l16 - l32) / abs(l32), rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    base = clip.CLIPConfig()
    towers = {t: dataclasses.replace(getattr(base, t), num_layers=LAYERS)
              for t in ("text", "vision")}
    cfg = dataclasses.replace(base, **towers)
    for seed in range(args.seeds):
        loss_rel, rel = step_errors(cfg, seed)
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
        print(f"seed {seed}: loss rel {loss_rel:.2e}; worst leaves "
              + ", ".join(f"{k} {v:.4f}" for k, v in worst), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
