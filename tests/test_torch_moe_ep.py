"""Expert parallelism of the PyTorch port over gloo ranks on the CPU
(``tests/_torch_dist_worker.py``), against the JAX package's Mixtral engine
on one device: the gating is global in JAX (capacity, drop priority and aux
loss over the whole batch), so every layout of the same global batch has
JAX's trajectory.

Tiny Mixtral (4 experts, top 2) at capacity factor 0.5, where tokens drop
across ranks; AdamW, GAS 2, clipping, fp32; 3 steps on 4 ranks.

- ``mesh`` data 2 x expert 2 at ZeRO-1 and ZeRO-3, and
  ``moe.expert_parallel_size`` 4 (no ``mesh``: data 1 x expert 4) at ZeRO-0
  and ZeRO-2: losses, grad norms, ``lm_loss`` / ``aux_loss`` and every
  final master within 2e-4 of JAX (JAX's own expert-parallel tolerance,
  ``tests/test_moe.py``); each bank leaf a rank holds is its own experts
  (and, from ZeRO-1 at data 2, its replica's half of them); the tokens
  travel by ``all_to_all``.
- A regular and a universal checkpoint saved at data 2 x expert 2 (ZeRO-2)
  resume at expert 4 (ZeRO-1) and at expert 1 over data 4 (ZeRO-3) within
  2e-4 of the uninterrupted run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
from deepspeed_tpu.models import mixtral as jmx
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.models import mixtral as tmx
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params
from deepspeed_tpu_torch.runtime import config as tcfg
from deepspeed_tpu_torch.runtime.engine import mesh_sizes

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, num_experts=4, top_k=2, max_seq_len=64,
            rope_theta=10000.0, capacity_factor=0.5)
STEPS = 3
TOL = dict(rtol=2e-4, atol=2e-4)
BANK = ("layers.0.moe.w_gate", "layers.1.moe.w_down")


def _config(stage, **kw):
    return dict({"train_batch_size": 8, "gradient_accumulation_steps": 2,
                 "optimizer": {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1}},
                 "zero_optimization": {"stage": stage}, "gradient_clipping": 1.0,
                 "steps_per_print": 0, "seed": 3}, **kw)


RUNS = {   # name: config on 4 ranks
    "d2e2_z1": _config(1, mesh={"data": 2, "expert": 2}),
    "d2e2_z3": _config(3, mesh={"data": 2, "expert": 2}),
    "e4_z0": _config(0, moe={"enabled": True, "expert_parallel_size": 4}),
    "e4_z2": _config(2, moe={"enabled": True, "expert_parallel_size": 4}),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg_j = jmx.MixtralConfig(**TINY)
    params = jax.tree.map(np.asarray, jmx.init(cfg_j, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, TINY["vocab_size"], (8, 17), dtype=np.int32)
               for _ in range(STEPS * 2)]
    arrays = {f"param/{k}": v.numpy()
              for k, v in from_jax_params(tmx.MixtralConfig(**TINY), params).items()}
    arrays.update({f"batch/{i}/tokens": b for i, b in enumerate(batches)})
    path = tmp / "inputs.npz"
    np.savez(path, **arrays)
    return tmp, str(path), params, batches


@pytest.fixture(scope="module")
def jax_run(inputs):
    _, _, params, batches = inputs
    cfg_j = jmx.MixtralConfig(**TINY)
    eng, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params),
                           loss_fn=lambda p, b: jmx.loss_fn(cfg_j, p, b,
                                                            compute_dtype=jnp.float32)),
        config=_config(0), devices=jax.devices()[:1])
    outs = [eng.train_batch({"tokens": b}) for b in batches[:STEPS]]
    return outs, jax.tree.map(np.asarray, eng.state.params)


@pytest.fixture(scope="module")
def ep_runs(inputs):
    tmp, npz, _, _ = inputs
    job = {"scenario": "train", "family": "mixtral", "cfg": TINY, "npz": npz,
           "local_shapes": list(BANK),
           "runs": [{"name": n, "config": c, "steps": STEPS} for n, c in RUNS.items()]}
    out = tmp / "train"
    out.mkdir()
    return spawn(job, 4, out, timeout=150)


def test_configs_build_the_expert_mesh():
    """``moe`` and ``mesh.expert`` are accepted; without ``mesh`` the
    ``expert`` axis is ``moe.expert_parallel_size`` (JAX ``initialize``)."""
    for name, conf in RUNS.items():
        cfg = tcfg.parse_config(conf, world_size=4)
        tcfg.check_ported(cfg, world_size=4)
        sizes = mesh_sizes(cfg, 4)
        assert (sizes["data"], sizes["expert"]) == ((2, 2) if "d2e2" in name else (1, 4))
        assert cfg.train_micro_batch_size_per_gpu == 1
    with pytest.raises(ValueError, match="not divisible"):
        mesh_sizes(tcfg.parse_config(_config(0, moe={"expert_parallel_size": 3}),
                                     world_size=4), 4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_trajectories_match_jax(ep_runs, jax_run, run):
    outs_j, params_j = jax_run
    for rank, got in enumerate(ep_runs):
        np.testing.assert_allclose(got[f"{run}/losses"], [float(o.loss) for o in outs_j], **TOL)
        np.testing.assert_allclose(got[f"{run}/grad_norm"], [float(o.grad_norm) for o in outs_j],
                                   **TOL)
        for m in ("lm_loss", "aux_loss"):
            np.testing.assert_allclose(got[f"{run}/{m}"], [float(o.aux[m]) for o in outs_j],
                                       err_msg=m, **TOL)
    cfg = tmx.MixtralConfig(**TINY)
    masters = {k.split("/", 2)[2]: torch.from_numpy(v) for k, v in ep_runs[0].items()
               if k.startswith(f"{run}/param/")}
    got = to_jax_params(cfg, masters)
    flat_g = {jax.tree_util.keystr(p): l for p, l in jax.tree_util.tree_flatten_with_path(got)[0]}
    for p, want in jax.tree_util.tree_flatten_with_path(params_j)[0]:
        np.testing.assert_allclose(flat_g[jax.tree_util.keystr(p)], want, err_msg=str(p), **TOL)


def test_capacity_drops_tokens_of_every_rank(inputs, monkeypatch):
    """At this capacity the first micro-batch's gating drops entries in
    every rank's rows (4 ranks, one 16-token row each), in both layers."""
    from deepspeed_tpu_torch.moe import layer as tlayer

    _, _, params, batches = inputs
    cfg = tmx.MixtralConfig(**TINY)
    keeps = []
    plain = tlayer.top_k_gating_compact

    def recording(*a, **kw):
        out = plain(*a, **kw)
        keeps.append(out.keep)
        return out

    monkeypatch.setattr(tlayer, "top_k_gating_compact", recording)
    micro = torch.from_numpy(batches[0][:4])
    tmx.loss_fn(cfg, from_jax_params(cfg, params), {"tokens": micro},
                compute_dtype=torch.float32)
    assert len(keeps) == cfg.num_layers
    for keep in keeps:
        dropped = (~keep).any(-1).reshape(4, 16)
        assert dropped.any(-1).all(), dropped


@pytest.mark.parametrize("run", sorted(RUNS))
def test_banks_sharded_over_expert_and_exchanged(ep_runs, run):
    e, h, i = TINY["num_experts"], TINY["hidden_size"], TINY["intermediate_size"]
    ep = 2 if "d2e2" in run else 4
    zero_halves = "d2e2" in run and not run.endswith("z0")     # ZeRO splits 2 experts over data 2
    rows = e // ep // (2 if zero_halves else 1)
    for got in ep_runs:
        assert tuple(got[f"{run}/local_shape/{BANK[0]}"]) == (rows, h, i)
        assert tuple(got[f"{run}/local_shape/{BANK[1]}"]) == (rows, i, h)
        # 2 layers x 2 micro-batches x (in, out) forward, and as many back
        assert got[f"{run}/comm/all_to_all"][0] == 2 * 2 * 2 * 2


def test_resume_across_expert_parallel_sizes(inputs):
    tmp, npz, _, _ = inputs
    job = {"scenario": "ckpt", "family": "mixtral", "cfg": TINY, "npz": npz,
           "dir": str(tmp / "ckpt"), "before": 2, "steps": 4, "mode": "save",
           "config": _config(2, mesh={"data": 2, "expert": 2}),
           "resumes": [["reg", _config(1, moe={"expert_parallel_size": 4})],
                       ["uni", _config(3)]]}
    out = tmp / "ckpt_out"
    out.mkdir()
    ranks = spawn(job, 4, out, timeout=150)
    for got in ranks:
        for kind in ("reg", "uni"):
            assert tuple(got[f"{kind}/step"]) == (4, 4)
            for k in [k for k in got if k.startswith("run/")]:
                np.testing.assert_allclose(got[kind + k[3:]], got[k], err_msg=kind + k[3:], **TOL)
