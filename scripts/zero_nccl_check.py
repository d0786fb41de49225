#!/usr/bin/env python3
"""Data-parallel ZeRO training of the PyTorch port over NCCL at world size > 1.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/zero_nccl_check.py                      # 4 layers, stages 0-3
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/zero_nccl_check.py --layers 32 --stages 3 --steps 3

Each rank joins through ``comm.init_distributed()`` (torchrun's ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``), builds the mesh
``{"data": world}`` and trains Llama-3-8B width at ``--layers`` layers, bf16,
AdamW, clipping 1.0, GAS 2 of one 4096-token sequence a rank (a global
batch of 2 x world sequences, the same on every rank), at each ZeRO stage of
``--stages``, one engine at a time, weights from ``--seed``. Per stage rank
0 prints the losses, grad norms, step ms (steps 2 on), every rank's peak
GiB, the collectives a step (``comm.counts``), the flash and RMSNorm
launches, and the device-idle share and NCCL kernel ms of one profiled
step. Every rank must report the same losses and grad norms, the kernels
must launch 2 x layers (flash) and 2 x (2 x layers + 1) (RMSNorm) times a
step, and each stage after the first must equal the first within
``--rtol`` (printed: whether bit for bit). The last line is one JSON object
of all of it; ``--out`` also writes it to a file.

``--ckpt`` runs the checkpoint leg instead of the stages: ZeRO-3 at world
``W``, ``--steps`` steps, a regular and a universal tag (under
``build/ckpt_nccl``), ``--steps`` more steps — the uninterrupted run; then
the same steps four ways from a fresh engine (drawn from another seed):
from the regular tag at ZeRO-3 (bit for bit), from the regular tag at
ZeRO-1 and from the universal tag at ZeRO-2 (within ``--rtol``), all at
world ``W``; and, once the group is gone, on rank 0 alone from the
universal tag at ZeRO-0 (GAS ``W x --gas``, the same global batch; within
``--rtol``). Each load's peak device memory on each rank must stay within
its level before plus the largest leaf. Prints save and load seconds and
every rank's device GiB before, at peak and after each load.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        scripts/zero_nccl_check.py --ckpt --steps 3

``--remat POLICY`` checkpoints every block under that policy of
``runtime/activation_checkpointing`` (the family's ``remat``): at ZeRO-3 a
block then gathers its leaves inside the checkpointed function, so the
gathered block does not outlive its forward and the recompute gathers it
again; the flash forward and RMSNorm launch counts then include the
recompute (``chip_smoke.remat_launches``).

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        scripts/zero_nccl_check.py --layers 32 --stages 3 --steps 3 --remat full

``--optimizer NAME`` trains with ``chip_smoke.OPTIMIZER_CASES[NAME]``
instead of AdamW: LAMB, Muon and the 1-bit optimizers reduce over whole
JAX leaves through the engine's layout (all-reduces of their sums, Muon's
all-gather of each momentum leaf), so every stage must still equal the
first within ``--rtol``.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        scripts/zero_nccl_check.py --optimizer muon --stages 0,3 --steps 3

``--tiny --backend gloo --device cpu`` rehearses the same code on the CPU
(tiny Llama, plain versions, no profile).
"""

import argparse
import dataclasses
import gc
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--stages", default="0,1,2,3")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--gas", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rtol", type=float, default=2e-3)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", action="store_true", help="the checkpoint leg instead")
    ap.add_argument("--remat", default="none", help="remat policy of every block")
    ap.add_argument("--optimizer", default="adamw",
                    help="a name of chip_smoke.OPTIMIZER_CASES (lamb, muon, onebitadam, ...)")
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                         flash_bwd_dq_cuda, flash_fwd_cuda)
    from deepspeed_tpu_torch.ops.norms import rms_norm_cuda

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
            cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, world {world} "
                   f"over {torch.cuda.device_count()} GPUs")
            t0 = time.perf_counter()
            _build.load()
            cs.log(f"build {time.perf_counter() - t0:.1f} s")
        comm.barrier()
        _build.load()
    mm = comm.init_mesh({"data": world})
    if args.tiny:
        cfg, seq = llama.LlamaConfig.tiny(num_layers=args.layers), 32
    else:
        cfg, seq = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                       num_layers=args.layers), args.seq
    cfg = dataclasses.replace(cfg, remat=args.remat != "none", remat_policy=args.remat)
    rs = np.random.RandomState(args.seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size,
                                  (args.gas * world, seq + 1)).astype(np.int32)}
    kernels = {"flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
               "flash_bwd_dkv": flash_bwd_dkv_cuda, "rms_norm": rms_norm_cuda}
    if args.ckpt:
        return checkpoint_leg(args, cfg, seq, card)
    want = cs.remat_launches(cfg.num_layers, args.remat, args.steps * args.gas)
    res, base = {}, None
    for stage in (int(s) for s in args.stages.split(",")):
        conf = cs._train_config(args.seed, args.gas, True)
        conf["train_batch_size"] = args.gas * world
        conf["zero_optimization"] = {"stage": stage}
        conf["optimizer"] = cs.OPTIMIZER_CASES[args.optimizer]
        t0 = time.perf_counter()
        eng, *_ = dst.initialize(model=llama.model_spec(cfg), config=conf, device=args.device)
        setup_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for c in kernels.values():
            c.launches = 0
        comm.counts.reset()
        losses, norms, step_s = [], [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            out = eng.train_batch(batch)
            if cuda:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(out.loss))
            norms.append(float(out.grad_norm))
        r = {"losses": losses, "grad_norms": norms, "step_s": step_s, "setup_s": setup_s,
             "step_ms": sum(step_s[1:]) / max(len(step_s) - 1, 1) * 1e3,
             "collectives_per_step": {op: {k: v / args.steps for k, v in rec.items()}
                                      for op, rec in comm.counts.snapshot().items()},
             "launches": {k: c.launches for k, c in kernels.items()},
             "sharded_leaves": len(eng._sharded), "leaves": len(eng.state.params),
             "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda else None)}
        if cuda:
            wall, busy, n_k, top = cs.profile_window(lambda: eng.train_batch(batch))
            r["profile"] = {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3,
                            "idle_share": 1 - busy / wall, "kernels": n_k,
                            "nccl_ms": sum(ms for k, ms, _ in top if "nccl" in k)}
        ranks = comm.all_gather_object(r)
        del eng
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if rank != 0:
            continue
        bad = [i for i, q in enumerate(ranks)
               if q["losses"] != losses or q["grad_norms"] != norms]
        if bad:
            raise AssertionError(f"ZeRO-{stage}: ranks {bad} report other values")
        if cuda and r["launches"] != want:
            raise AssertionError(f"ZeRO-{stage}: launches {r['launches']} != {want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"ZeRO-{stage}: loss not finite and falling: {losses}")
        r["peak_gib_by_rank"] = [q["peak_gib"] for q in ranks]
        if base is None:
            base = r
        else:
            r["bitwise_equal_first"] = losses == base["losses"] and norms == base["grad_norms"]
            r["max_rel_err_first"] = max(abs(a - b) / abs(b) for a, b in zip(
                losses + norms, base["losses"] + base["grad_norms"]))
            if r["max_rel_err_first"] > args.rtol:
                raise AssertionError(f"ZeRO-{stage} against the first stage: rel "
                                     f"{r['max_rel_err_first']:.3g} > {args.rtol}")
        prof = r.get("profile", {})
        cs.log(f"ZeRO-{stage} at world {world}: losses {['%.4f' % l for l in losses]}, "
               f"grad norms {['%.4f' % g for g in norms]}, step {r['step_ms']:.1f} ms, "
               f"set-up {setup_s:.1f} s, peak GiB by rank "
               f"{['%.2f' % g for g in r['peak_gib_by_rank'] if g is not None]}, "
               f"idle {prof.get('idle_share', float('nan')):.1%}, nccl "
               f"{prof.get('nccl_ms', float('nan')):.1f} of {prof.get('busy_ms', float('nan')):.1f}"
               f" ms busy, {r['sharded_leaves']}/{r['leaves']} leaves sharded"
               + (f", equal to the first bit for bit: {r['bitwise_equal_first']} (max rel "
                  f"{r['max_rel_err_first']:.3g})" if r is not base else "") + f" [{card}]")
        cs.log("  collectives a step: " + ", ".join(
            f"{op} {rec['count']:g} x, {rec['bytes'] / 2**20:.1f} MiB"
            for op, rec in r["collectives_per_step"].items()))
        res[stage] = r
    comm.set_mesh(None)
    dist.destroy_process_group()
    if rank == 0:
        summary = {"world": world, "layers": cfg.num_layers, "remat": args.remat, "card": card,
                   "stages": res}
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(summary, indent=1))
        print(json.dumps(summary), flush=True)
    return 0


def checkpoint_leg(args, cfg, seq: int, card: str) -> int:
    """See the module docstring (``--ckpt``)."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.zero_init import GatheredParameters

    rank, world = comm.get_rank(), comm.get_world_size()
    cuda = args.device == "cuda"
    root = REPO / "build" / "ckpt_nccl"
    reg, uni = str(root / "regular"), str(root / "universal")
    rs = np.random.RandomState(args.seed + 19)
    batches = [{"tokens": rs.randint(0, cfg.vocab_size, (args.gas * world, seq + 1))
                .astype(np.int32)} for _ in range(2 * args.steps)]
    largest = max(int(np.prod(s)) for s, _ in llama.param_shapes(cfg).values()) * 4
    if rank == 0:
        root.mkdir(parents=True, exist_ok=True)
        need = 2 * cfg.num_params * 12 + (4 << 30)
        free = shutil.disk_usage(root).free
        cs.log(f"checkpoint leg: {free / 1e9:.1f} GB free under build/, two tags of "
               f"{cfg.num_params * 12 / 1e9:.2f} GB [{card}]")
        if free < need:
            raise RuntimeError(f"the checkpoint leg needs {need / 1e9:.1f} GB, {free / 1e9:.1f} free")

    def engine(stage, seed, gas=args.gas, dp=world):
        conf = cs._train_config(seed, gas, True)
        conf["train_batch_size"] = gas * dp
        conf["zero_optimization"] = {"stage": stage}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return dst.initialize(model=llama.model_spec(cfg), config=conf, device=args.device)[0]

    def run(eng, bs):
        outs = [eng.train_batch(b) for b in bs]
        return [float(o.loss) for o in outs], [float(o.grad_norm) for o in outs]

    def load(eng, fn, path):
        if cuda:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(path)
        if cuda:
            torch.cuda.synchronize()
        r = {"load_s": time.perf_counter() - t0}
        if cuda:
            r.update(before_gib=before / 2**30,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     after_gib=torch.cuda.memory_allocated() / 2**30)
            if r["peak_gib"] * 2**30 > before + largest:
                raise AssertionError(f"rank {rank}: peak {r['peak_gib']:.2f} GiB during the load "
                                     f"> {r['before_gib']:.2f} before + the largest leaf")
        return r

    def held(what, got, ref, exact):
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[0] + got[1], ref[0] + ref[1]))
        if (got != ref) if exact else rel > args.rtol:
            raise AssertionError(f"{what}: {got} against {ref} (max rel {rel:.3g})")
        return {"losses": got[0], "grad_norms": got[1], "bitwise": got == ref, "max_rel": rel}

    res = {}
    eng = engine(3, args.seed)
    run(eng, batches[:args.steps])
    t0 = time.perf_counter()
    eng.save_checkpoint(reg, tag="reg")
    res["save_regular_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.save_universal_checkpoint(uni, tag="uni")
    res["save_universal_s"] = time.perf_counter() - t0
    ref = run(eng, batches[args.steps:])
    with GatheredParameters(eng.state.params, eng.shard_dims, mesh_mgr=eng.mesh_mgr) as full:
        ref_wq = full["layers.0.wq"].float().cpu()
    del eng
    res["uninterrupted"] = {"losses": ref[0], "grad_norms": ref[1]}
    for name, stage, fn_name, path, exact in (
            ("regular, ZeRO-3", 3, "load_checkpoint", reg, True),
            ("regular, ZeRO-1", 1, "load_checkpoint", reg, False),
            ("universal, ZeRO-2", 2, "load_universal_checkpoint", uni, False)):
        eng = engine(stage, args.seed + 1)
        r = load(eng, getattr(eng, fn_name), path)
        r.update(held(f"resume from the {name} tag at world {world}",
                      run(eng, batches[args.steps:]), ref, exact))
        r["by_rank"] = comm.all_gather_object({k: r.get(k) for k in
                                               ("load_s", "before_gib", "peak_gib", "after_gib")})
        res[name] = r
        del eng
        if rank == 0:
            cs.log(f"  {name} at world {world}: load {r['load_s']:.1f} s, device GiB before / peak"
                   f" / after by rank {[(q['before_gib'], q['peak_gib'], q['after_gib']) for q in r['by_rank']]}"
                   f", bit for bit {r['bitwise']} (max rel {r['max_rel']:.3g}) [{card}]")
    comm.set_mesh(None)
    dist.destroy_process_group()
    if rank == 0:
        # one process, no group: the universal tag at ZeRO-0, all W x GAS
        # micro-batches of the same global batch on this card
        eng = engine(0, args.seed + 1, gas=args.gas * world, dp=1)
        r = load(eng, eng.load_universal_checkpoint, uni)
        r.update(held("resume from the universal tag at world 1", run(eng, batches[args.steps:]),
                      ref, False))
        wq = eng.state.params["layers.0.wq"].detach().float().cpu()
        r["wq_max_abs_diff"] = float((wq - ref_wq).abs().max())
        res["universal, world 1, ZeRO-0"] = r
        del eng
        cs.log(f"  universal at world 1, ZeRO-0: load {r['load_s']:.1f} s, max rel "
               f"{r['max_rel']:.3g}, layers.0.wq max |diff| {r['wq_max_abs_diff']:.3g} [{card}]")
        shutil.rmtree(root, ignore_errors=True)
        summary = {"world": world, "layers": cfg.num_layers, "card": card, "checkpoint": res}
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(summary, indent=1))
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
