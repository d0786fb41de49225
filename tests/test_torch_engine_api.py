"""The training engine's API beside ``train_batch``, and fp16 with loss
scaling, against the JAX engine on the CPU (JAX ``runtime/engine.py``
:898-993, :2014-2071; the JAX engine on one device, dp = 1).

- Every accessor returns the JAX engine's value after the same steps
  (floats rtol 1e-5), also after ``set_lr`` mid-run; ``eval_batch`` and the
  micro-batch API through ``__call__`` agree within rtol 1e-5.
- fp16: 12 ``train_batch`` steps of tiny Llama from the same weights
  (``initial_scale_power`` 24, ``loss_scale_window`` 3, hysteresis 2, GAS
  2, clipping 0.5). Overflow flags, loss scales, step and skip counts are
  equal; losses agree within 6e-4 relative and grad norms within 1.4e-3
  (fp16 rounding in two implementations; the limits ROADMAP queue C
  records for this configuration). The port saves both formats mid-trajectory: each resume
  continues its uninterrupted run bit for bit, loss scaler included, and
  the JAX engine resumed from the port's universal tag continues JAX's
  trajectory within the same limits. A universal load sets ``state.step``
  to ``global_steps`` in both packages, also when skips left it behind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params

CFG_J, CFG_T = jl.LlamaConfig.tiny(num_layers=2), tl.LlamaConfig.tiny(num_layers=2)
_RS = np.random.RandomState(1)
BATCHES = [{"tokens": _RS.randint(0, CFG_T.vocab_size, (4, 17)).astype(np.int32)}
           for _ in range(12)]
CONFIG = {
    "train_batch_size": 4, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                              "betas": [0.8, 0.99]}},
    "gradient_clipping": 0.5,
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                             "warmup_num_steps": 4, "warmup_type": "linear"}},
    "steps_per_print": 0,
}
FP16 = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
        "gradient_clipping": 0.5, "steps_per_print": 0,
        "fp16": {"enabled": True, "initial_scale_power": 24, "loss_scale_window": 3,
                 "hysteresis": 2}}
# the first 7 steps overflow; the save after 9 holds skips and steps, and
# the 3 after it an overflow and two steps
SAVE_AT = 9


def _pair(config, jdtype=jnp.float32, tdtype=torch.float32):
    params = jl.init(CFG_J, jax.random.PRNGKey(0))
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params, loss_fn=lambda p, b: jl.loss_fn(
            CFG_J, p, b, compute_dtype=jdtype)),
        config=config, devices=jax.devices()[:1])
    return eng_j, _port(config, jax.tree.map(np.asarray, params), tdtype)


def _port(config, params_np=None, tdtype=torch.float32, seed=None):
    spec = tl.model_spec(CFG_T, compute_dtype=tdtype)
    if params_np is not None:
        spec.params, spec.init_fn = from_jax_params(CFG_T, params_np), None
    conf = config if seed is None else dict(config, seed=seed)
    eng, *_ = deepspeed_tpu_torch.initialize(model=spec, config=conf, device="cpu")
    return eng


def _accessors(eng):
    return {
        "get_lr": eng.get_lr(), "get_global_grad_norm": float(eng.get_global_grad_norm()),
        "get_batch_info": tuple(eng.get_batch_info()), "global_samples": eng.global_samples,
        "global_steps": eng.global_steps, "micro_steps": eng.micro_steps,
        "global_tokens": eng.global_tokens, "bfloat16_enabled": eng.bfloat16_enabled(),
        "fp16_enabled": eng.fp16_enabled(),
        "gradient_clipping_value": eng.gradient_clipping_value(),
        "steps_per_print": eng.steps_per_print(),
        "wall_clock_breakdown": eng.wall_clock_breakdown(), "get_mom": eng.get_mom(),
        "mp_world_size": eng.mp_world_size(), "dp_world_size": eng.dp_world_size(),
        "zero_optimization": eng.zero_optimization(),
        "zero_optimization_stage": eng.zero_optimization_stage(),
        "train_batch_size": eng.train_batch_size(),
        "train_micro_batch_size_per_gpu": eng.train_micro_batch_size_per_gpu(),
        "gradient_accumulation_steps": eng.gradient_accumulation_steps(),
        "loss_scale": eng.loss_scale, "is_compiled": bool(eng.is_compiled),
        "lr_scheduler": eng.lr_scheduler.state_dict(),
    }


def _assert_accessors(eng_t, eng_j):
    got, want = _accessors(eng_t), _accessors(eng_j)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
        elif isinstance(want[k], list):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        else:
            assert got[k] == want[k], k


def test_accessors_match_the_jax_engine():
    eng_j, eng_t = _pair(CONFIG)
    assert eng_t.module is eng_t.model and eng_j.module is eng_j.model
    assert not eng_t.is_compiled and eng_t.get_global_grad_norm() == 0.0
    for b in BATCHES[:3]:
        eng_j.train_batch(b), eng_t.train_batch(b)
    _assert_accessors(eng_t, eng_j)

    # set_lr mid-run: a constant rate from the next step; base_lr stays
    eng_j.set_lr(2.5e-4), eng_t.set_lr(2.5e-4)
    assert eng_t.base_lr == 1e-3
    _assert_accessors(eng_t, eng_j)
    for b in BATCHES[3:5]:
        out_j, out_t = eng_j.train_batch(b), eng_t.train_batch(b)
        assert float(out_t.loss) == pytest.approx(float(out_j.loss), rel=1e-5)
        assert out_t.lr == pytest.approx(float(out_j.lr), rel=1e-6) and out_t.lr == 2.5e-4
    _assert_accessors(eng_t, eng_j)

    # eval_batch: the loss without a step; nothing moves
    before = {k: v.clone() for k, v in eng_t.state.params.items()}
    micro = {"tokens": BATCHES[5]["tokens"][:2]}
    assert float(eng_t.eval_batch(micro)) == pytest.approx(float(eng_j.eval_batch(micro)),
                                                          rel=1e-5)
    assert all(torch.equal(v, before[k]) for k, v in eng_t.state.params.items())
    assert all(p.grad is None for p in eng_t.state.params.values())

    # the micro-batch API through __call__, under no_sync
    for eng in (eng_j, eng_t):
        with eng.no_sync():
            for i in range(2):
                eng.backward(eng({"tokens": BATCHES[6]["tokens"][2 * i:2 * i + 2]}))
    out_j, out_t = eng_j.step(), eng_t.step()
    assert float(out_t.loss) == pytest.approx(float(out_j.loss), rel=1e-5)
    _assert_accessors(eng_t, eng_j)
    assert eng_t.micro_steps == 2 and eng_t.global_steps == 6
    assert eng_t.compile({"tokens": BATCHES[7]["tokens"]}) is eng_t and eng_t.is_compiled


def _trajectory(eng, batches):
    rows = []
    for b in batches:
        o = eng.train_batch(b)
        rows.append((float(o.loss), float(o.grad_norm), bool(o.overflow),
                     float(o.loss_scale), int(eng.state.step), int(eng.state.skipped_steps)))
    return rows


def _hold_fp16(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[2:] == w[2:], f"step {i}: overflow / scale / step / skips {g[2:]} != {w[2:]}"
        if not w[2]:
            assert g[0] == pytest.approx(w[0], rel=6e-4), f"step {i} loss"
            assert g[1] == pytest.approx(w[1], rel=1.4e-3), f"step {i} grad norm"


def test_fp16_trajectory_and_resume_match_jax(tmp_path):
    eng_j, eng_t = _pair(FP16, jnp.float16, torch.float16)
    head_j, head_t = (_trajectory(eng_j, BATCHES[:SAVE_AT]),
                      _trajectory(eng_t, BATCHES[:SAVE_AT]))
    _hold_fp16(head_t, head_j)
    assert any(r[2] for r in head_t) and not all(r[2] for r in head_t)
    eng_t.save_checkpoint(str(tmp_path / "reg"), tag="s")
    eng_t.save_universal_checkpoint(str(tmp_path / "uni"), tag="u")
    skipped = int(eng_t.state.skipped_steps)
    assert skipped > 0
    tail_j, tail_t = _trajectory(eng_j, BATCHES[SAVE_AT:]), _trajectory(eng_t, BATCHES[SAVE_AT:])
    _hold_fp16(tail_t, tail_j)

    reg = _port(FP16, tdtype=torch.float16, seed=4)
    reg.load_checkpoint(str(tmp_path / "reg"))
    assert reg.state.step == SAVE_AT - skipped and reg.state.skipped_steps == skipped
    assert _trajectory(reg, BATCHES[SAVE_AT:]) == tail_t

    uni = _port(FP16, tdtype=torch.float16, seed=4)
    uni.load_universal_checkpoint(str(tmp_path / "uni"))
    # the reference's universal load: state.step = global_steps (skips
    # included), the optimizer step and the loss scaler exact
    assert uni.state.step == SAVE_AT and uni.state.opt_state.step == SAVE_AT - skipped
    assert uni.loss_scale == head_t[-1][3]
    got = _trajectory(uni, BATCHES[SAVE_AT:])
    assert [r[:4] for r in got] == [r[:4] for r in tail_t]

    params = jl.init(CFG_J, jax.random.PRNGKey(3))
    eng_j2, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params, loss_fn=lambda p, b: jl.loss_fn(
            CFG_J, p, b, compute_dtype=jnp.float16)),
        config=FP16, devices=jax.devices()[:1])
    eng_j2.load_universal_checkpoint(str(tmp_path / "uni"))
    assert int(eng_j2.state.step) == SAVE_AT
    assert float(eng_j2.loss_scale) == head_t[-1][3]
    _hold_fp16(got, _trajectory(eng_j2, BATCHES[SAVE_AT:]))
