#!/usr/bin/env python3
"""Expert-parallel Mixtral training of the PyTorch port over NCCL at world 4.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/moe_ep_check.py                        # 4 layers, 3 steps

Each rank joins through ``comm.init_distributed()`` (torchrun's env) and
trains Mixtral-8x7B width (``MixtralConfig()``: 8 experts of 14336, top 2)
at ``--layers`` layers in fp32 compute, AdamW, clipping 1.0, ZeRO-3, one
``--seq``-token sequence a rank (the same global batch everywhere, weights
from ``--seed``), twice, one engine at a time:

- expert-parallel size 1: the mesh ``{"data": world}``, every rank holding
  every expert (its ZeRO shard of it);
- ``moe.expert_parallel_size`` = world, no ``mesh``: the engine's mesh
  ``{"data": 1, "expert": world}``, each rank holding its own experts, the
  dispatched tokens exchanged by ``all_to_all`` over ``expert``.

The gating is global in both (capacity, drops and aux loss over the whole
batch, ``moe/layer.py``), so the two runs compute one function: their
losses must agree within ``--rtol`` (2e-4, the JAX package's own
expert-parallel tolerance, ``tests/test_moe.py``). Rank 0 prints, per run,
the losses, grad norms, step ms (steps 2 on), every rank's peak GiB and the
collectives a step (``comm.counts``: the all-to-all count and bytes); the
last line is one JSON object of all of it (``--out`` writes it to a file).

``--tiny --backend gloo --device cpu`` rehearses the same code on the CPU.
"""

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rtol", type=float, default=2e-4)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import mixtral

    torch.set_num_threads(1 if args.device == "cpu" else torch.get_num_threads())
    comm.init_distributed(dist_backend=args.backend)
    rank, world = comm.get_rank(), comm.get_world_size()
    cuda = args.device == "cuda"
    card = ""
    if cuda:
        from deepspeed_tpu_torch.ops import _build

        if rank == 0:
            card = cs.card_line()
            cs.log(card)
            t0 = time.perf_counter()
            _build.load()
            cs.log(f"build {time.perf_counter() - t0:.1f} s")
        comm.barrier()
        _build.load()
    if args.tiny:
        cfg, seq = mixtral.MixtralConfig.tiny(num_layers=args.layers, capacity_factor=0.5), 32
    else:
        cfg, seq = dataclasses.replace(mixtral.MixtralConfig(), num_layers=args.layers), args.seq
    rs = np.random.RandomState(args.seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (world, seq + 1)).astype(np.int32)}
    runs = {"ep1": {"mesh": {"data": world}},
            f"ep{world}": {"moe": {"enabled": True, "expert_parallel_size": world}}}
    res = {}
    for name, extra in runs.items():
        conf = {"train_batch_size": world, "gradient_accumulation_steps": 1,
                "optimizer": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1}},
                "gradient_clipping": 1.0, "zero_optimization": {"stage": 3},
                "seed": args.seed, "steps_per_print": 0, **extra}
        t0 = time.perf_counter()
        eng, *_ = dst.initialize(model=mixtral.model_spec(cfg, compute_dtype=torch.float32),
                                 config=conf, device=args.device)
        setup_s = time.perf_counter() - t0
        sizes = {a: n for a, n in eng.mesh_mgr.sizes.items() if n > 1}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        comm.counts.reset()
        losses, norms, aux, step_s = [], [], [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            out = eng.train_batch(batch)
            if cuda:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(out.loss))
            norms.append(float(out.grad_norm))
            aux.append(float(out.aux["aux_loss"]))
        bank = eng.state.params["layers.0.moe.w_gate"]
        r = {"mesh": sizes, "losses": losses, "grad_norms": norms, "aux_loss": aux,
             "step_s": step_s, "setup_s": setup_s,
             "step_ms": sum(step_s[1:]) / max(len(step_s) - 1, 1) * 1e3,
             "collectives_per_step": {op: {k: v / args.steps for k, v in rec.items()}
                                      for op, rec in comm.counts.snapshot().items()},
             "bank_shape_on_rank": list(bank.shape),
             "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda else None)}
        ranks = comm.all_gather_object(r)
        del eng, bank
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if rank != 0:
            continue
        bad = [i for i, q in enumerate(ranks) if q["losses"] != losses]
        if bad:
            raise AssertionError(f"{name}: ranks {bad} report other losses")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: loss not finite: {losses}")
        r["peak_gib_by_rank"] = [q["peak_gib"] for q in ranks]
        a2a = r["collectives_per_step"].get("all_to_all", {"count": 0, "bytes": 0})
        cs.log(f"{name} ({sizes}): losses {['%.6f' % l for l in losses]}, aux "
               f"{['%.4f' % a for a in aux]}, step {r['step_ms']:.1f} ms, set-up "
               f"{setup_s:.1f} s, bank {r['bank_shape_on_rank']} on a rank, peak GiB by rank "
               f"{['%.2f' % g for g in r['peak_gib_by_rank'] if g is not None]}, all_to_all "
               f"{a2a['count']:g} x {a2a['bytes'] / 2**20:.1f} MiB a step [{card}]")
        cs.log("  collectives a step: " + ", ".join(
            f"{op} {rec['count']:g} x, {rec['bytes'] / 2**20:.1f} MiB"
            for op, rec in r["collectives_per_step"].items()))
        res[name] = r
    comm.set_mesh(None)
    dist.destroy_process_group()
    if rank != 0:
        return 0
    a, b = res["ep1"], res[f"ep{world}"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"]))
    cs.log(f"expert-parallel {world} against 1: loss max rel {rel:.3g} (limit {args.rtol:g})")
    summary = {"world": world, "layers": cfg.num_layers, "seq": seq, "card": card,
               "runs": res, "loss_max_rel": rel, "rtol": args.rtol}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    if rel > args.rtol:
        raise AssertionError(f"expert parallelism changed the losses: rel {rel:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
