"""Llama training: the PyTorch port against the JAX package, on the CPU.

- ``loss_fn`` and the gradient of every leaf, port (``models/llama.py``)
  against JAX ``llama.loss_fn`` under ``jax.grad``, in fp32, for the base,
  QKV-bias (Qwen2), qk_norm (Qwen3) and tied-embedding variants. Weights go
  across with ``from_jax_params``; the port's grads come back to the JAX
  tree with ``to_jax_params``. Tolerance: loss 1e-5 relative, grads 1e-5
  absolute + 1e-4 relative (same fp32 arithmetic, other summation orders;
  measured ~4e-7 at these shapes).
- 10 ``train_batch`` steps of the port's engine against the JAX engine
  (``deepspeed_tpu.initialize(..., devices=jax.devices()[:1])``: one device,
  so dp = 1 as in the port), same weights and batches, GAS 2, clipping that
  bites, AdamW with weight decay, a warm-up schedule, fp32 compute.
  Tolerance: losses and grad norms 1e-5 relative; final params 2e-4
  absolute — Adam divides each step by sqrt(v), so an embedding row whose
  grads are rounding noise moves by up to lr either way (measured 4.6e-5 on
  ``embed``, <= 1.5e-6 elsewhere).
"""

import dataclasses

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
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params

VARIANTS = {
    "base": {},
    "bias": {"attention_bias": True},
    "qk_norm": {"qk_norm": True},
    "tied": {"tie_embeddings": True},
}


def _configs(**kw):
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


def _jax_params(cfg_j, seed=0, perturb=False):
    params = jl.init(cfg_j, jax.random.PRNGKey(seed))
    if perturb:
        # norms init to 1 and biases to 0; move them so their grads and
        # their effect on the forward are both exercised
        rs = np.random.RandomState(seed)
        params = jax.tree_util.tree_map_with_path(
            lambda path, p: p + 0.1 * rs.randn(*p.shape).astype(np.float32)
            if any(getattr(k, "key", "").endswith(("norm", "bq", "bk", "bv"))
                   for k in path) else p, params)
    return params


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_leaf_grad_match_jax(variant):
    cfg_j, cfg_t = _configs(**VARIANTS[variant])
    params_j = _jax_params(cfg_j, perturb=True)
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, cfg_t.vocab_size, (2, 33)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[0, :5] = -100                       # ignored positions
    batch = {"tokens": tokens[:, :-1], "labels": labels}

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jl.loss_fn(cfg_j, p, jbatch, compute_dtype=jnp.float32),
        has_aux=True))(params_j)
    params_t = {k: v.requires_grad_() for k, v in
                from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j)).items()}
    loss_t, aux_t = tl.loss_fn(cfg_t, params_t,
                               {k: torch.from_numpy(v) for k, v in batch.items()},
                               compute_dtype=torch.float32)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    assert int(aux_t["ntokens"]) == int(aux_j["ntokens"]) == labels.size - 5

    got = _leaves(to_jax_params(cfg_t, {k: v.grad for k, v in params_t.items()}))
    want = _leaves(grads_j)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_to_jax_params_inverts_from_jax_params():
    cfg_j, cfg_t = _configs(qk_norm=True, attention_bias=True)
    tree = jax.tree.map(np.asarray, _jax_params(cfg_j, seed=2))
    back = to_jax_params(cfg_t, from_jax_params(cfg_t, tree))
    a, b = _leaves(tree), _leaves(back)
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


CONFIG = {
    "train_batch_size": 4, "gradient_accumulation_steps": 2,
    "gradient_clipping": 0.5,   # below the grad norms (~4): the clip bites
    "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3,
                             "warmup_num_steps": 4, "warmup_type": "linear"}},
    "steps_per_print": 0,
}


def test_engine_ten_steps_match_jax_engine():
    cfg_j, cfg_t = _configs(num_layers=2)
    params_j = _jax_params(cfg_j)
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params_j, loss_fn=lambda p, b: jl.loss_fn(
            cfg_j, p, b, compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    eng_t, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.ModelSpec(
            params=from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j)),
            loss_fn=lambda p, b: tl.loss_fn(cfg_t, p, b, compute_dtype=torch.float32)),
        config=CONFIG, device="cpu")
    assert opt is eng_t.optimizer and loader is None and sched is eng_t.lr_scheduler
    assert eng_t.gradient_accumulation_steps() == 2
    rs = np.random.RandomState(0)
    for step in range(10):
        batch = {"tokens": rs.randint(0, cfg_t.vocab_size, (4, 17)).astype(np.int32)}
        out_j, out_t = eng_j.train_batch(batch), eng_t.train_batch(batch)
        np.testing.assert_allclose(float(out_t.loss), float(out_j.loss), rtol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(out_t.grad_norm), float(out_j.grad_norm),
                                   rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(out_t.lr, float(out_j.lr), rtol=1e-6)
        assert not out_t.overflow and not bool(out_j.overflow)
    assert eng_t.state.step == int(eng_j.state.step) == 10
    got = _leaves(to_jax_params(cfg_t, {k: v.detach() for k, v in eng_t.state.params.items()}))
    want = _leaves(eng_j.state.params)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=2e-4, err_msg=name)


def test_forward_backward_step_equals_train_batch():
    """The reference's micro-batch API gives the fused step's result."""
    cfg = tl.LlamaConfig.tiny(num_layers=1)
    gen = torch.Generator().manual_seed(0)
    params = tl.init(cfg, gen)
    spec = lambda: deepspeed_tpu_torch.ModelSpec(  # noqa: E731
        params=params, loss_fn=lambda p, b: tl.loss_fn(cfg, p, b, compute_dtype=torch.float32))
    a, *_ = deepspeed_tpu_torch.initialize(model=spec(), config=CONFIG, device="cpu")
    b, *_ = deepspeed_tpu_torch.initialize(model=spec(), config=CONFIG, device="cpu")
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (4, 9)).astype(np.int32)
    out_a = a.train_batch({"tokens": tokens})
    assert b.step() is None                     # not at a GAS boundary yet
    for i in range(2):
        b.forward({"tokens": tokens[2 * i:2 * i + 2]})
        b.backward()
    out_b = b.step()
    torch.testing.assert_close(out_b.loss, out_a.loss, rtol=1e-6, atol=0)
    for k in params:
        torch.testing.assert_close(b.state.params[k], a.state.params[k], rtol=1e-6, atol=1e-7)
    assert torch.equal(params["embed"], tl.init(cfg, torch.Generator().manual_seed(0))["embed"]), \
        "the engine must not write into the caller's tensors"


def test_model_spec_trains_from_a_seed():
    """``initialize(model=llama.model_spec(cfg))`` draws the weights from
    ``config.seed`` and the loss falls on a fixed batch."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), num_layers=1)
    conf = dict(CONFIG, seed=7, bf16={"enabled": True})
    eng, *_ = deepspeed_tpu_torch.initialize(model=tl.model_spec(cfg), config=conf,
                                             device="cpu")
    twin, *_ = deepspeed_tpu_torch.initialize(model=tl.model_spec(cfg), config=conf,
                                              device="cpu")
    for k, p in eng.state.params.items():
        assert p.dtype == torch.float32 and torch.equal(p, twin.state.params[k])
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    losses = [float(eng.train_batch({"tokens": tokens}).loss) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1, losses


# chip_smoke.py's limits for one training step on the card (bf16, kernels)
# against the CPU (fp32, plain): TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL
CHIP_LOSS_RTOL, CHIP_GRAD_RTOL = 2e-3, 0.05


def test_train_limits_separate_sound_from_faulty(monkeypatch):
    """The simulation behind those limits, on the CPU at a reduced width (1
    layer, hidden 1024, 8 heads on 2 kv heads of 128, vocab 8192, S 256):
    one step's loss and every leaf's grad in bf16 against fp32 from the same
    fp32 masters. Measured over three seeds: loss 1e-4 relative at worst,
    leaf grads <= 0.0133 relative Frobenius; with dV of kv head 0 zeroed in
    the attention backward, wv's grad reads ~0.7."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = tl.LlamaConfig(vocab_size=8192, hidden_size=1024, intermediate_size=3584,
                         num_layers=1, num_heads=8, num_kv_heads=2, max_seq_len=512)
    masters = tl.init(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 257))
             .astype(np.int32)}
    # attention through the flash autograd function (its plain pieces on
    # CPU tensors), so a fault can be planted in its backward
    monkeypatch.setattr(tl, "attention", lambda q, k, v, causal: fa.FlashAttention.apply(
        q, k, v, causal, None, 0, None))

    def step(bf16):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.ModelSpec(
                params={k: v.clone() for k, v in masters.items()},
                loss_fn=lambda p, b: tl.loss_fn(
                    cfg, p, b, compute_dtype=torch.bfloat16 if bf16 else torch.float32)),
            config={"train_batch_size": 1, "bf16": {"enabled": bf16}, "steps_per_print": 0},
            device="cpu")
        loss = float(eng.forward(batch))
        return loss, {k: p.grad.float() for k, p in eng.state.params.items()}

    loss32, g32 = step(False)
    loss16, g16 = step(True)
    rel = lambda g: {k: float((g[k] - g32[k]).norm() / g32[k].norm()) for k in g32}  # noqa: E731
    assert abs(loss16 - loss32) / loss32 < CHIP_LOSS_RTOL / 10
    assert max(rel(g16).values()) < CHIP_GRAD_RTOL / 3
    sound = fa.flash_bwd_torch

    def faulty(*a, **kw):
        dq, dk, dv = sound(*a, **kw)
        dv[:, :, 0] = 0
        return dq, dk, dv

    monkeypatch.setattr(fa, "flash_bwd_torch", faulty)
    _, g_bad = step(True)
    assert rel(g_bad)["layers.0.wv"] > 5 * CHIP_GRAD_RTOL
