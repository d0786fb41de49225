"""Training runtime of the PyTorch port against the JAX package, on the CPU:
config parsing, AdamW, lr schedules, the fp16 loss scaler, the global norm,
the dataloader cursor, and what ``initialize`` refuses.

Tolerances: parsed configs and the scaler are compared exactly; schedules
step by step at 1e-6 relative and 1e-10 absolute (the JAX package evaluates
them in fp32, the port in Python floats, and an fp32 rounding of an lr of
order 1e-3 is ~1e-10, which near a cosine's floor exceeds 1e-6 of it);
Adam trajectories at 1e-6 relative and 1e-7 absolute over 5 steps (fp32 elementwise arithmetic on both sides, the
port fusing multiply-adds the JAX package rounds separately).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu_torch
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import config as jcfg
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import precision as jprec
from deepspeed_tpu.runtime.dataloader import DeepSpeedTPUDataLoader as JaxLoader
from deepspeed_tpu.runtime.utils import global_norm as jax_global_norm
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import config as tcfg
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import precision as tprec
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedTPUDataLoader as TorchLoader
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, global_norm

# the configs of tests/test_config.py, with their world sizes, and one that
# sets most blocks
PARSE_CASES = [
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2}, 8),
    ({"train_batch_size": 64, "train_micro_batch_size_per_gpu": 2}, 8),
    ({"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2}, 8),
    ({}, 4),
    ({"bf16": {"enabled": True},
      "zero_optimization": {"stage": 3, "offload_optimizer": {"device": "cpu"}},
      "gradient_clipping": 1.0}, 1),
    ({"fp16": {"enabled": True, "initial_scale_power": 12}}, 1),
    ({"train_batch_size": 16, "steps_per_print": 100,
      "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
      "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
      "bfloat16": {"enabled": True}, "zero_allow_untested_optimizer": True,
      "wall_clock_breakdown": False}, 8),
    ({"mesh": {"tensor": 2, "seq": 2}}, 8),
    ({"train_batch_size": 8, "zero_optimization": {"stage": 2}}, 8),
    ({"train_batch_size": 6, "gradient_accumulation_steps": 3, "seed": 3,
      "fp16": {"enabled": True, "loss_scale": 0, "loss_scale_window": 50,
               "min_loss_scale": 2},
      "optimizer": {"type": "Adam", "params": {"lr": 2e-4, "betas": [0.8, 0.9],
                                               "eps": 1e-6, "weight_decay": 0.01}},
      "scheduler": {"type": "WarmupCosineLR",
                    "params": {"total_num_steps": 100, "warmup_num_steps": 10}},
      "zero_optimization": {"stage": 1, "reduce_bucket_size": 1000},
      "activation_checkpointing": {"policy": "full"},
      "pipeline": {"stages": 2}, "moe": {"enabled": True, "num_experts": 4},
      "comms_overlap": {"enabled": True}, "telemetry": {"trace": {"enabled": True}},
      "sequence": {"tiled_loss": True, "ring": {"layout": "zigzag"}},
      "data_efficiency": {"enabled": False}}, 1),
]


def _as_json(cfg, module):
    return json.dumps(module._dictify(cfg), sort_keys=True, default=str)


@pytest.mark.parametrize("i", range(len(PARSE_CASES)))
def test_parse_config_matches_jax(i, tmp_path):
    config, world = PARSE_CASES[i]
    want = jcfg.parse_config(config, world_size=world)
    got = tcfg.parse_config(config, world_size=world)
    assert _as_json(got, tcfg) == _as_json(want, jcfg)
    assert (got.train_batch_size, got.train_micro_batch_size_per_gpu,
            got.gradient_accumulation_steps, got.compute_dtype) == \
        (want.train_batch_size, want.train_micro_batch_size_per_gpu,
         want.gradient_accumulation_steps, want.compute_dtype)
    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps(config))
    assert _as_json(tcfg.parse_config(str(path), world_size=world), tcfg) == _as_json(want, jcfg)


@pytest.mark.parametrize("config", [
    {"train_batch_size": 33, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 2},
    {"fp16": {"enabled": True}, "bf16": {"enabled": True}},
])
def test_parse_config_refuses_what_jax_refuses(config):
    with pytest.raises(ValueError):
        jcfg.parse_config(config, world_size=8)
    with pytest.raises(ValueError):
        tcfg.parse_config(config, world_size=8)


def _spec():
    return deepspeed_tpu_torch.ModelSpec(
        params={"w": torch.ones(4, 4)},
        loss_fn=lambda p, b: (b["x"].to(p["w"].dtype) @ p["w"]).float().pow(2).mean())


@pytest.mark.parametrize("block", [
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"pipeline": {"stages": 2}},
    {"sequence": {"ring": {"overlap": True}}},
    {"comms_logger": {"enabled": True}},
    {"comms_overlap": {"enabled": True}},
    {"profiler": {"enabled": True}},
    {"tensor_parallel": {"autotp_size": 2}},
    {"telemetry": {"trace": {"enabled": True}}},
    {"tuning": {"enabled": True}},
    {"reliability": {"integrity": {"enabled": True}}},
    {"memory": {"tiering": {"enabled": True}}},
    {"aio": {"block_size": 4096}},
    {"watchdog": {"enabled": True}},
    {"flops_profiler": {"enabled": True}},
])
def test_initialize_refuses_unported_blocks(block):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        deepspeed_tpu_torch.initialize(model=_spec(), config=block, device="cpu")


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stages_accepted_at_world_size_one(stage):
    """Every ZeRO stage builds at world size 1, and a world size of 2, all
    of it on the ``data`` axis, is accepted too (data parallelism is
    ported; the multi-rank arithmetic is held to JAX in
    ``test_torch_zero_stages.py``)."""
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_spec(), config={"zero_optimization": {"stage": stage}}, device="cpu")
    assert eng.zero_optimization_stage() == stage and eng.dp_world_size() == 1
    assert eng.zero_optimization() == (stage > 0)
    conf = {"train_batch_size": 4, "zero_optimization": {"stage": stage}}
    cfg = tcfg.parse_config(conf, world_size=2)
    tcfg.check_ported(cfg, world_size=2)
    assert cfg.train_micro_batch_size_per_gpu == 2 and cfg.mesh.axis_sizes(2)["data"] == 2


@pytest.mark.parametrize("block", [
    {"mesh": {"tensor": 2}}, {"mesh": {"pipe": 2}}, {"mesh": {"seq": 2}},
    {"sequence_parallel_size": 2}, {"zero_optimization": {"zero_hpz_partition_size": 2}},
    {"zero_optimization": {"mics_shard_size": 2}},
])
def test_world_size_two_refuses_axes_other_than_data(block):
    cfg = tcfg.parse_config(block, world_size=2, resolve_batch=False)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tcfg.check_ported(cfg, world_size=2)


def test_initialize_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        deepspeed_tpu_torch.initialize(model=_spec(), config={})
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("nosuch", lr=1e-3)


def _tree(rs):
    return {"a": rs.randn(3, 5).astype(np.float32), "b": rs.randn(7).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adam", {"lr": 1e-2, "weight_decay": 0.1}),   # JAX adam decays like adamw
    ("adamw", {"lr": 3e-3, "betas": [0.8, 0.95], "eps": 1e-6,
               "bias_correction": False}),
    ("fusedadam", {"learning_rate": 1e-3, "adam_w_mode": False}),
])
def test_adam_trajectory_matches_jax(name, kw):
    rs = np.random.RandomState(0)
    p0 = _tree(rs)
    opt_j, opt_t = jopt.get_optimizer(name, **kw), topt.get_optimizer(name, **kw)
    assert opt_t.name == opt_j.name and opt_t.hyperparams.keys() == opt_j.hyperparams.keys()
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for step in range(5):
        g = _tree(rs)
        lr_scale = 1.0 - 0.1 * step
        pj, sj = opt_j.update(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj,
                              lr_scale=jnp.float32(lr_scale))
        pt, st = opt_t.update(pt, {k: torch.from_numpy(v) for k, v in g.items()}, st,
                              lr_scale=lr_scale)
    assert st.step == int(sj.step) == 5
    for k in p0:
        for got, want in ((pt[k], pj[k]), (st.mu[k], sj.mu[k]), (st.nu[k], sj.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_adam_equals_adamw_as_in_the_reference():
    """The JAX ``adam(adamw=False)`` adds ``weight_decay * p`` to the step
    exactly as ``adamw`` does; the port keeps that behaviour."""
    rs = np.random.RandomState(1)
    p0, g = _tree(rs), _tree(rs)
    out = []
    for name in ("adam", "adamw"):
        opt = topt.get_optimizer(name, lr=1e-2, weight_decay=0.5)
        p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        p, _ = opt.update(p, {k: torch.from_numpy(v) for k, v in g.items()}, opt.init(p))
        out.append(p)
    for k in p0:
        assert torch.equal(out[0][k], out[1][k])


SCHEDULES = [
    (None, {}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 8}),
    ("WarmupLR", {"warmup_max_lr": 2e-3, "warmup_num_steps": 5, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_max_lr": 1e-3, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 4,
                        "warmup_min_ratio": 0.1, "warmup_max_lr": 3e-4}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 6,
                  "decay_step_size": 3, "decay_lr_rate": 0.5}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 4,
                  "cycle_second_step_size": 8}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_lr_schedules_match_jax_step_by_step(i):
    name, params = SCHEDULES[i]
    sj = jlr.get_schedule(name, params, base_lr=5e-4)
    st = tlr.get_schedule(name, params, base_lr=5e-4)
    for step in range(25):
        np.testing.assert_allclose(st(step), float(sj(jnp.float32(step))), rtol=1e-6,
                                   atol=1e-10, err_msg=f"{name} step {step}")
    lj, lt = jlr.LRScheduler(sj), tlr.LRScheduler(st)
    lj.step(3)
    lt.step(3)
    np.testing.assert_allclose(lt.get_lr(), lj.get_lr(), rtol=1e-6)
    assert lt.state_dict() == lj.state_dict()


@pytest.mark.parametrize("fp16", [
    {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 3,
     "min_loss_scale": 32},
    {"enabled": True, "loss_scale": 128.0},
    {"enabled": False},
])
def test_loss_scaler_matches_jax(fp16):
    cj = jcfg.FP16Config.from_dict(fp16)
    ct = tcfg.FP16Config.from_dict(fp16)
    sj, st = jprec.make_loss_scaler(cj), tprec.make_loss_scaler(ct)
    flags = [True, True, True, False, True, False, False, False, True, True, True, True]
    for f in flags:
        sj = jprec.update_loss_scale(sj, jnp.asarray(f))
        st = tprec.update_loss_scale(st, torch.tensor(f))
        assert float(st.scale) == float(sj.scale)
        assert int(st.good_steps) == int(sj.good_steps)
    loss = torch.tensor(0.5)
    assert float(tprec.scale_loss(loss, st)) == float(jprec.scale_loss(jnp.float32(0.5), sj))


def test_grads_finite_global_norm_and_clip_match_jax():
    rs = np.random.RandomState(2)
    g = _tree(rs)
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    np.testing.assert_allclose(float(global_norm(gt)),
                               float(jax_global_norm({k: jnp.asarray(v) for k, v in g.items()})),
                               rtol=1e-6)
    assert bool(tprec.grads_finite(gt.values()))
    bad = dict(gt, b=torch.tensor([1.0, float("inf")]))
    assert not bool(tprec.grads_finite(bad.values()))
    norm = float(global_norm(gt))
    clipped, pre = clip_grad_norm_({k: v.clone() for k, v in gt.items()}, 1.0)
    assert float(pre) == norm
    np.testing.assert_allclose(float(global_norm(clipped)), norm / (norm + 1e-6), rtol=1e-6)


def test_engine_skips_an_overflowing_step():
    """fp16 with a scale that overflows the fp16 grads: params, optimizer
    state and step stay, the skip is counted and the scale halves."""
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_spec(), device="cpu",
        config={"fp16": {"enabled": True, "initial_scale_power": 20},
                "optimizer": {"type": "adamw", "params": {"lr": 0.1}}})
    x = np.ones((1, 4), np.float32)
    out = eng.train_batch({"x": x})
    assert out.overflow and eng.state.step == 0 and eng.state.skipped_steps == 1
    assert eng.loss_scale == 2.0 ** 19
    assert torch.equal(eng.state.params["w"].detach(), torch.ones(4, 4))
    assert eng.state.opt_state.step == 0 and not eng.state.opt_state.mu["w"].any()
    while out.overflow:
        out = eng.train_batch({"x": x})
    assert eng.state.step == 1 and not torch.equal(eng.state.params["w"].detach(),
                                                   torch.ones(4, 4))


def test_initialize_builds_the_dataloader():
    data = [{"x": np.full(4, i, np.float32)} for i in range(10)]
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=_spec(), config={"train_batch_size": 4}, training_data=data, device="cpu")
    assert isinstance(loader, TorchLoader) and len(loader) == 2
    for batch in loader:
        assert batch["x"].shape == (4, 4)
        assert not eng.train_batch({"x": batch["x"][:, None, :]}).overflow
    assert eng.state.step == 2 and eng.lr_scheduler.last_step == 2


def test_dataloader_cursor_matches_jax():
    data = [{"tokens": np.full(3, i, np.int32)} for i in range(23)]
    jl, tl = JaxLoader(data, batch_size=4, seed=5), TorchLoader(data, batch_size=4, seed=5)
    assert len(tl) == len(jl) == 5
    it_j, it_t = iter(jl), iter(tl)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_t)["tokens"], next(it_j)["tokens"])
    assert tl.state_dict() == jl.state_dict()
    resumed = TorchLoader(data, batch_size=4, seed=5)
    resumed.load_state_dict(tl.state_dict())
    rest_t = [b["tokens"] for b in resumed]
    rest_j = [b["tokens"] for b in it_j]
    assert len(rest_t) == len(rest_j) == 3
    for a, b in zip(rest_t, rest_j):
        np.testing.assert_array_equal(a, b)
