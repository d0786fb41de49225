"""Multi-rank scenarios of the PyTorch port on the CPU: :func:`spawn` starts
``world`` ranks of this module as subprocesses over a gloo process group,
and collects what each rank wrote.

The ranks meet through a ``file://`` store in the job's directory, a name
no other spawn uses, not through a TCP port: a port that the spawner found
free could be taken by another process before rank 0 bound it, and under
``pytest -n`` many jobs spawn ranks at once.

A rank runs ``python _torch_dist_worker.py JOB RANK WORLD STORE``: it pins
torch to one thread, joins the group through
``comm.init_distributed(dist_backend="gloo", ...)`` with a collective
timeout under a minute, runs the job's scenario (``SCENARIOS``) and writes
``rank<r>.npz`` into the job's ``out`` directory. The ranks import no JAX:
the tests hold their results to the JAX package in the parent process. A
spawn that outlives its ``timeout`` is killed and fails, so a hang costs
at most that long.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GLOO_TIMEOUT_S = 45


def spawn(job: dict, world: int, tmp_path, timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` ranks; returns each rank's arrays (a dict
    per rank, rank order). Raises with the ranks' output on a failure or a
    timeout."""
    tmp = Path(tmp_path)
    job = dict(job, out=str(tmp))
    job_file = tmp / "job.json"
    job_file.write_text(json.dumps(job))
    store = f"file://{tmp.resolve() / f'store.{os.getpid()}.{time.monotonic_ns()}'}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    logs, procs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(job_file), str(r),
             str(world), store], cwd=str(REPO), env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for log in logs:
        log.seek(0)
        out.append(log.read())
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"ranks exited {[p.returncode for p in procs]} "
                           f"(timeout {timeout} s):\n" + "\n".join(
                               f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(out)))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


# --------------------------------------------------------------------------- #
# scenarios (run inside a rank)
# --------------------------------------------------------------------------- #
def _family(name):
    from deepspeed_tpu_torch.models import bloom, falcon, gpt, llama, mixtral

    return {"llama": (llama, llama.LlamaConfig), "gpt": (gpt, gpt.GPTConfig),
            "bloom": (bloom, bloom.BloomConfig),
            "mixtral": (mixtral, mixtral.MixtralConfig),
            "falcon": (falcon, falcon.FalconConfig)}[name]


def _gathered(eng):
    """The engine's masters gathered whole (an expert bank over its
    ``expert`` and replica parts)."""
    from deepspeed_tpu_torch.runtime.zero_init import GatheredParameters

    return GatheredParameters(eng.state.params, eng.shard_dims, mesh_mgr=eng.mesh_mgr,
                              axes={k: s.axes for k, s in eng.splits.items()})


def _state_bytes(eng) -> int:
    """Bytes of this rank's persistent train state: masters and every
    tensor of the optimizer state."""
    from deepspeed_tpu_torch.ops.optimizers import state_tensors

    leaves = list(eng.state.params.values())
    for tensors in state_tensors(eng.state.opt_state).values():
        leaves += list(tensors.values())
    return sum(t.numel() * t.element_size() for t in leaves)


def scenario_train(job, rank, world):
    """Train each of ``job["runs"]`` from the same weights and batches;
    record losses, grad norms, aux, state bytes, the collectives of a step
    and the final masters gathered whole. A run's own ``cfg`` (fields of
    the family's config) replaces the job's."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.comm import comm

    family, cfg_type = _family(job["family"])
    data = np.load(job["npz"])
    params = {k[len("param/"):]: torch.from_numpy(data[k]) for k in data if k.startswith("param/")}
    out = {}
    for run in job["runs"]:
        name, conf = run["name"], run["config"]
        cfg = cfg_type(**run.get("cfg", job["cfg"]))
        # the run's batches: "<data>/<step>/<key>" arrays
        pre = run.get("data", "batch")
        batches = [{k.split("/", 2)[2]: data[k] for k in data if k.startswith(f"{pre}/{i}/")}
                   for i in range(run["steps"])]
        spec = dst.ModelSpec(
            params=params, logical_axes=family.param_logical_axes(cfg), config=cfg,
            loss_fn=lambda p, b: family.loss_fn(cfg, p, b, compute_dtype=torch.float32))
        eng, *_ = dst.initialize(model=spec, config=conf, device="cpu")
        out[f"{name}/state_bytes"] = np.int64(_state_bytes(eng))
        if run.get("accumulator"):
            # the accumulator once every micro-batch but the last has run
            gas = eng.gradient_accumulation_steps()
            rows = len(batches[0]["tokens"]) // gas
            for i in range(gas - 1):
                eng.forward({k: v[i * rows:(i + 1) * rows] for k, v in batches[0].items()})
            acc = eng.grad_accumulator()
            out[f"{name}/acc_bytes"] = np.int64(sum(t.numel() * t.element_size()
                                                    for t in acc.values()))
            eng._staged.clear()
        for k in job.get("local_shapes", ()):
            out[f"{name}/local_shape/{k}"] = np.array(eng.state.params[k].shape)
        losses, norms, ntok, metrics = [], [], [], {}
        gas = eng.gradient_accumulation_steps()
        for i, batch in enumerate(batches):
            comm.counts.reset()
            if run.get("api") == "micro":    # forward / backward per micro-batch, then step
                rows = len(batch["tokens"]) // gas
                for j in range(gas):
                    eng.backward(eng.forward({k: v[j * rows:(j + 1) * rows]
                                              for k, v in batch.items()}))
                o = eng.step()
            else:
                o = eng.train_batch(batch)
            losses.append(float(o.loss))
            norms.append(float(o.grad_norm))
            ntok.append(int(o.aux.get("ntokens", -1)))
            for m in ("lm_loss", "aux_loss"):
                if m in o.aux:
                    metrics.setdefault(m, []).append(float(o.aux[m]))
            assert not o.overflow
            if i == 0:
                for op, rec in comm.counts.snapshot().items():
                    out[f"{name}/comm/{op}"] = np.array([rec["count"], rec["bytes"]])
        out[f"{name}/losses"] = np.array(losses)
        out[f"{name}/grad_norm"] = np.array(norms)
        out[f"{name}/ntokens"] = np.array(ntok)
        out.update({f"{name}/{m}": np.array(v) for m, v in metrics.items()})
        with _gathered(eng) as full:
            for k, t in full.items():
                out[f"{name}/param/{k}"] = t.numpy()
        del eng
    return out


def scenario_comm(job, rank, world):
    """Every collective on member ``rank``'s slice of the shared inputs."""
    import torch

    from deepspeed_tpu_torch import comm

    data = np.load(job["npz"])
    mm = comm.init_mesh(job["mesh"])
    ax = job["axis"]
    idx = mm.axis_index(ax)
    x = torch.from_numpy(data["x"][idx])            # this member's local shard
    out = {"axis_index": np.int64(comm.axis_index(ax)),
           "axis_size": np.int64(comm.axis_size(ax))}
    for op in ("sum", "max", "min", "mean"):
        out[f"all_reduce_{op}"] = comm.all_reduce(x, ax, op).numpy()
    for ga in (0, 1):
        out[f"all_gather_{ga}"] = comm.all_gather(x, ax, gather_axis=ga).numpy()
        out[f"all_gather_untiled_{ga}"] = comm.all_gather(x, ax, tiled=False,
                                                          gather_axis=ga).numpy()
        out[f"reduce_scatter_{ga}"] = comm.reduce_scatter(x, ax, scatter_axis=ga).numpy()
    out["all_to_all_10"] = comm.all_to_all(x, ax, split_axis=1, concat_axis=0).numpy()
    out["all_to_all_01"] = comm.all_to_all(x, ax, split_axis=0, concat_axis=1).numpy()
    n = mm.axis_size(ax)
    out["ppermute"] = comm.ppermute(x, ax, [(i, (i + 1) % n) for i in range(n - 1)]).numpy()
    out["ring_shift"] = comm.ring_shift(x, ax, n, shift=-1).numpy()
    out["broadcast"] = comm.broadcast(x, ax, src_index=n - 1).numpy()
    out["send_recv"] = comm.send_recv(x, ax, src=n - 1, dst=0).numpy()
    out["gather"] = comm.gather(x, ax, dst=1).numpy()
    out["scatter"] = comm.scatter(torch.from_numpy(data["s"][idx]), ax, src=2).numpy()
    out["inference_all_reduce"] = comm.inference_all_reduce(x, ax).numpy()
    objs = comm.all_gather_object({"rank": rank, "tag": f"r{rank}"})
    out["objects"] = np.array([o["rank"] for o in objs])
    lst = [f"from {rank}", rank * 10] if rank == 1 else [None, None]
    comm.broadcast_object_list(lst, src=1)
    out["broadcast_object"] = np.array([lst[1]])
    out["broadcast_host"] = np.array([comm.broadcast_host(rank + 100, src=2)])
    out["barrier_s"] = np.array([comm.monitored_barrier("t", timeout=30.0)])
    out["counts"] = np.array([sum(r["count"] for r in comm.counts.snapshot().values())])
    # a rank that never arrives: the others' monitored barrier raises in time
    if rank == world - 1:
        time.sleep(4.0)
        comm.barrier()              # meets the others' timed-out barrier
    else:
        t0 = time.perf_counter()
        try:
            comm.monitored_barrier("late", timeout=1.0)
            out["late"] = np.array([0.0])
        except RuntimeError:
            out["late"] = np.array([time.perf_counter() - t0])
    comm.barrier()
    return out


def scenario_zero_init(job, rank, world):
    """``zero.Init`` at stage 3 and ``GatheredParameters`` with a modifier."""
    import torch

    import deepspeed_tpu_torch as dst

    family, cfg_type = _family(job["family"])
    cfg = cfg_type(**job["cfg"])
    mm = dst.comm.init_mesh({"data": world})
    with dst.zero.Init(config_dict_or_path={"zero_optimization": {"stage": 3}},
                       mesh_mgr=mm) as zi:
        shards = zi.materialize(lambda g, **kw: family.init(cfg, g, **kw),
                                torch.Generator().manual_seed(job["seed"]),
                                family.param_logical_axes(cfg))
    shapes = {k: s for k, (s, _) in family.param_shapes(cfg).items()}
    dims = dst.zero.shard_dims(family.param_logical_axes(cfg), shapes, mm)
    out = {f"shard/{k}": t.numpy() for k, t in shards.items()}
    with dst.zero.GatheredParameters(shards, dims, mesh_mgr=mm) as full:
        out.update({f"full/{k}": t.numpy().copy() for k, t in full.items()})
    with dst.zero.GatheredParameters(shards, dims, modifier_rank=1, mesh_mgr=mm) as full:
        for t in full.values():
            t.add_(1.0 + rank)                  # only rank 1's edit may land
    with dst.zero.GatheredParameters(shards, dims, mesh_mgr=mm) as full:
        out.update({f"edited/{k}": t.numpy() for k, t in full.items()})
    # the engine draws its masters sharded from config.seed the same way
    for stage in (1, 3):
        eng, *_ = dst.initialize(model=family.model_spec(cfg, compute_dtype=torch.float32),
                                 config={"train_batch_size": 2, "seed": job["seed"],
                                         "zero_optimization": {"stage": stage}},
                                 device="cpu", mesh_mgr=mm)
        out[f"engine{stage}/numel"] = np.int64(sum(p.numel() for p in eng.state.params.values()))
        with dst.zero.GatheredParameters(eng.state.params, eng.shard_dims, mesh_mgr=mm) as full:
            out.update({f"engine{stage}/{k}": t.numpy() for k, t in full.items()})
    return out


def scenario_ckpt(job, rank, world):
    """Checkpoints across topologies. ``mode == "save"``: train
    ``job["before"]`` steps from the job's weights, save a regular and a
    universal tag into ``job["dir"]``, train the rest (the uninterrupted
    run, ``run/*``), then resume each tag at this topology on an engine
    drawn from another seed and train the same rest (``reg/*``,
    ``uni/*``). ``mode == "load"``: only the resumes of ``job["resumes"]``
    (``[kind, config]`` pairs). Records losses, grad norms and the final
    masters gathered whole."""
    import dataclasses

    import torch

    import deepspeed_tpu_torch as dst

    family, cfg_type = _family(job["family"])
    cfg = cfg_type(**job["cfg"])
    data = np.load(job["npz"])
    params = {k[len("param/"):]: torch.from_numpy(data[k]) for k in data if k.startswith("param/")}
    batches = [{"tokens": data[f"batch/{i}/tokens"]} for i in range(job["steps"])]
    spec = family.model_spec(cfg, compute_dtype=torch.float32)
    out = {}

    def run(name, eng, rest):
        outs = [eng.train_batch(b) for b in rest]
        out[f"{name}/losses"] = np.array([float(o.loss) for o in outs])
        out[f"{name}/grad_norm"] = np.array([float(o.grad_norm) for o in outs])
        out[f"{name}/step"] = np.array([eng.state.step, eng.global_steps])
        with _gathered(eng) as full:
            for k, t in full.items():
                out[f"{name}/param/{k}"] = t.numpy()

    def resume(kind, config):
        conf = dict(config, seed=config.get("seed", 0) + 7)
        eng, *_ = dst.initialize(model=spec, config=conf, device="cpu")
        if kind == "reg":
            path, _ = eng.load_checkpoint(job["dir"], tag="reg")
        else:
            path, _ = eng.load_universal_checkpoint(job["dir"], tag="uni")
        assert path is not None and eng.global_steps == job["before"], (path, eng.global_steps)
        run(kind, eng, batches[job["before"]:])

    if job["mode"] == "save":
        eng, *_ = dst.initialize(model=dataclasses.replace(spec, params=params, init_fn=None),
                                 config=job["config"], device="cpu")
        for b in batches[:job["before"]]:
            eng.train_batch(b)
        eng.save_checkpoint(job["dir"], tag="reg")
        eng.save_universal_checkpoint(job["dir"], tag="uni")
        run("run", eng, batches[job["before"]:])
        del eng
        for kind, config in job.get("resumes") or [(k, job["config"]) for k in ("reg", "uni")]:
            resume(kind, config)
    else:
        for kind, config in job["resumes"]:
            resume(kind, config)
    return out


SCENARIOS = {"train": scenario_train, "comm": scenario_comm, "zero_init": scenario_zero_init,
             "ckpt": scenario_ckpt}


def main():
    job_file, rank, world, store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch

    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    job = json.loads(Path(job_file).read_text())
    comm.init_distributed(dist_backend="gloo", coordinator_address=store,
                          num_processes=world, process_id=rank, timeout=GLOO_TIMEOUT_S)
    try:
        out = SCENARIOS[job["scenario"]](job, rank, world)
        np.savez(Path(job["out"]) / f"rank{rank}.npz", **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
