#!/usr/bin/env python3
"""Time the serving step of one checkout of the PyTorch port: Llama-3-8B
(full width and depth, bf16 weights from a seed) in ``chip_smoke.py``
phase 4's engine (64 slots, 512 blocks of 128) with phase 4's 8 prompts
live, and each of

- ``eager_step``: ``step()`` with the decode forward run eagerly (the
  parent's only decode; on a checkout with the decode graph, its plain
  version, ``_graph_on = False``);
- ``graph_step``: ``step()`` replaying the decode graph (checkouts that
  have one);
- ``graph_step_many``: ``step_many(8)``, 8 replays and one host sync.

    python3 scripts/serving_step_ab.py --root PATH [--rounds 6]

Each mode runs ``rounds`` rounds of 8 token-steps after a warm-up round;
the wall time of each round (host clock around the round and a sync) is
printed per token-step, with one more round under ``torch.profiler`` for
the device-busy time (the kernels' own time; the session opens with 256
spin kernels that are not counted, as ``chip_smoke.profile_window``'s do). To compare two checkouts, run it on
both in turns (parent, change, change, parent) on one card in one call:
each run builds its checkout's kernels (into PATH/build/) and prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

MAIN_LENGTHS = [1, 17, 64, 100, 129, 200, 333, 500]        # chip_smoke phase 4
K = 8


def busy_ms(fn) -> float:
    """Device-busy ms of one call of ``fn`` (a session without its lead-in or
    without a kernel is run again, 4 times at most)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(20_000_000)
            for _ in range(255):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        kern = [e for e in evts if "spin_kernel" not in e.key]
        if kern and len(kern) < len(evts):
            return sum(e.self_device_time_total for e in kern) / 1e3
        time.sleep(0.2)
    raise RuntimeError("torch.profiler recorded no device time")


def run(root: Path, rounds: int) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from deepspeed_tpu_torch.inference import build_engine_v2
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import _build

    _build.load()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in MAIN_LENGTHS]
    eng = build_engine_v2(llama, cfg, params, config={
        "dtype": "bfloat16", "prefill_bucket": 64,
        "ragged": {"max_tracked_sequences": 64, "max_ragged_batch_size": 64,
                   "memory_config_blocks": 512, "block_size": 128}})
    has_graph = hasattr(eng, "graph_replays")
    modes = {"eager_step": (False, lambda: [eng.step() for _ in range(K)])}
    if has_graph:
        modes["graph_step"] = (True, lambda: [eng.step() for _ in range(K)])
        modes["graph_step_many"] = (True, lambda: eng.step_many(K))
    out = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    for name, (graph_on, fn) in modes.items():
        eng._graph_on = graph_on
        eng.generate(prompts[:2], max_new_tokens=3)           # warm-up
        uids = list(range(100, 100 + len(prompts)))
        eng.put_many(list(zip(uids, prompts)))
        fn()
        walls = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / K)
        out[name] = {"wall_ms": walls, "busy_ms": busy_ms(fn) / K}
        for u in uids:
            eng.finish(u)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, required=True, help="checkout to time")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    print(json.dumps(run(args.root.resolve(), args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
