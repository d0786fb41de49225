"""BLOOM family: the PyTorch port against the JAX package, on the CPU.

Weights are made by the JAX ``bloom.init`` (LayerNorm scales and every bias
perturbed, so their effect and their grads are exercised), turned to numpy
and moved with ``from_jax_params``; tokens come from numpy. Everything runs
in fp32 on the CPU, where op ``attention`` adds the ALiBi bias in plain
attention (the flash kernels' bias mode on the card).

- ``alibi_slopes`` (powers of two and the odd-step fill) and the one-sided
  ALiBi bias equal to JAX's.
- ``apply`` logits (1e-5), ``loss_fn`` with every leaf's grad (loss 1e-5
  relative, grads 1e-4), also with ``labels`` and -100 positions; the
  ``nn.Module`` form.
- A 10-step ``train_batch`` trajectory against ``deepspeed_tpu.initialize``
  on one device (loss, grad norm 1e-5; final params 2e-4 absolute).
- ``convert`` round trip; config presets equal.
- The CPU simulation behind ``chip_smoke.py``'s BLOOM training-step check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bloom as jbloom
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params


def _configs(**kw):
    return jbloom.BloomConfig.tiny(**kw), tbloom.BloomConfig.tiny(**kw)


def _jax_params(cfg_j, seed=0, perturb=True):
    params = jax.tree.map(np.asarray, jbloom.init(cfg_j, jax.random.PRNGKey(seed)))
    if perturb:
        rs = np.random.RandomState(seed)
        bump = lambda p: (p + 0.1 * rs.randn(*p.shape)).astype(np.float32)  # noqa: E731
        for name in ("ln1_scale", "ln1_bias", "bq", "bk", "bv", "bo", "ln2_scale",
                     "ln2_bias", "b_up", "b_down"):
            params["layers"][name] = bump(params["layers"][name])
        for name in ("embed_ln_scale", "embed_ln_bias", "final_ln_scale", "final_ln_bias"):
            params[name] = bump(params[name])
    return params


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("heads", [1, 2, 4, 6, 12, 32])
def test_alibi_slopes_and_bias_equal_jax(heads):
    got = tbloom.alibi_slopes(heads)
    assert got.dtype == torch.float32 and got.shape == (heads,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbloom.alibi_slopes(heads)))
    np.testing.assert_array_equal(tbloom._alibi_bias(heads, 37).numpy(),
                                  np.asarray(jbloom._alibi_bias(heads, 37)))


def test_apply_logits_and_module_match_jax():
    cfg_j, cfg_t = _configs()
    params = _jax_params(cfg_j)
    tokens = np.random.RandomState(1).randint(0, cfg_t.vocab_size, (2, 24)).astype(np.int32)
    want = jax.jit(lambda p, t: jbloom.apply(cfg_j, p, t, compute_dtype=jnp.float32))(
        params, jnp.asarray(tokens))
    sd = from_jax_params(cfg_t, params)
    got = tbloom.apply(cfg_t, sd, torch.from_numpy(tokens), compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    model = tbloom.build(cfg_t)
    model.load_state_dict(sd, strict=True, assign=True)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(tokens)).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # bf16: every leaf cast before use, logits within bf16 steps of JAX's
    want = jbloom.apply(cfg_j, params, jnp.asarray(tokens), compute_dtype=jnp.bfloat16)
    got = tbloom.apply(cfg_t, sd, torch.from_numpy(tokens), compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("labels", [False, True])
def test_loss_and_every_leaf_grad_match_jax(labels):
    cfg_j, cfg_t = _configs(num_heads=6, hidden_size=96)
    params_j = _jax_params(cfg_j)
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, cfg_t.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": tokens}
    if labels:
        lab = rs.randint(0, cfg_t.vocab_size, (2, 33)).astype(np.int32)
        lab[0, :7] = -100
        lab[1, 20:] = -100
        batch = {"tokens": tokens, "labels": lab}
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jbloom.loss_fn(cfg_j, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                 compute_dtype=jnp.float32), has_aux=True))(params_j)
    params_t = {k: v.requires_grad_() for k, v in from_jax_params(cfg_t, params_j).items()}
    loss_t, aux_t = tbloom.loss_fn(cfg_t, params_t,
                                   {k: torch.from_numpy(v) for k, v in batch.items()},
                                   compute_dtype=torch.float32)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    assert int(aux_t["ntokens"]) == int(aux_j["ntokens"])
    got = _leaves(to_jax_params(cfg_t, {k: v.grad for k, v in params_t.items()}))
    want = _leaves(grads_j)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5, err_msg=name)


CONFIG = {
    "train_batch_size": 4, "gradient_accumulation_steps": 2,
    "gradient_clipping": 0.5,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3,
                             "warmup_num_steps": 4, "warmup_type": "linear"}},
    "steps_per_print": 0,
}


def test_engine_ten_steps_match_jax_engine():
    cfg_j, cfg_t = _configs()
    params_j = _jax_params(cfg_j)
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params_j),
                           loss_fn=lambda p, b: jbloom.loss_fn(
                               cfg_j, p, b, compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    eng_t, *_ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.ModelSpec(
            params=from_jax_params(cfg_t, params_j),
            loss_fn=lambda p, b: tbloom.loss_fn(cfg_t, p, b, compute_dtype=torch.float32)),
        config=CONFIG, device="cpu")
    rs = np.random.RandomState(0)
    for step in range(10):
        batch = {"tokens": rs.randint(0, cfg_t.vocab_size, (4, 17)).astype(np.int32)}
        out_j, out_t = eng_j.train_batch(batch), eng_t.train_batch(batch)
        np.testing.assert_allclose(float(out_t.loss), float(out_j.loss), rtol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(out_t.grad_norm), float(out_j.grad_norm),
                                   rtol=1e-5, err_msg=f"step {step}")
    assert eng_t.state.step == int(eng_j.state.step) == 10
    got = _leaves(to_jax_params(cfg_t, {k: v.detach() for k, v in eng_t.state.params.items()}))
    want = _leaves(eng_j.state.params)
    # the K bias has a gradient of exactly zero in exact arithmetic (a shift
    # of every key moves each query's scores by one constant, which softmax
    # drops), so Adam turns its rounding noise into lr-size steps in either
    # package: leave that leaf out
    del got["['layers']['bk']"], want["['layers']['bk']"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=2e-4, err_msg=name)


def test_model_spec_trains_from_a_generator():
    cfg = tbloom.BloomConfig.tiny()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tbloom.model_spec(cfg, compute_dtype=torch.float32),
        config=dict(CONFIG, seed=3), device="cpu")
    assert set(eng.state.params) == set(tbloom.param_shapes(cfg))
    batch = {"tokens": np.random.RandomState(5).randint(0, 256, (4, 17)).astype(np.int32)}
    losses = [float(eng.train_batch(batch).loss) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["tiny", "bloom_7b1"])
def test_configs_equal_and_convert_round_trip(name):
    cfg_j = jbloom.BloomConfig.tiny() if name == "tiny" else jbloom.BloomConfig()
    cfg_t = getattr(tbloom.BloomConfig, name)()
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "max_seq_len",
                  "layer_norm_eps", "head_size", "intermediate_size"):
        assert getattr(cfg_t, field) == getattr(cfg_j, field), field
    shapes = tbloom.param_shapes(cfg_t)
    if name == "bloom_7b1":   # BLOOM-7b1: 7.07 B parameters
        assert abs(sum(int(np.prod(s)) for s, _ in shapes.values()) - 7.069e9) < 1e6
        return
    params = _jax_params(cfg_j, seed=2)
    sd = from_jax_params(cfg_t, params)
    assert set(sd) == set(shapes)
    np.testing.assert_array_equal(sd["layers.1.wq"].numpy(), params["layers"]["wq"][1].T)
    np.testing.assert_array_equal(sd["layers.0.w_down"].numpy(), params["layers"]["w_down"][0].T)
    np.testing.assert_array_equal(sd["layers.1.bk"].numpy(), params["layers"]["bk"][1])
    np.testing.assert_array_equal(sd["embed"].numpy(), params["embed"])
    a, b = _leaves(params), _leaves(to_jax_params(cfg_t, sd))
    assert set(a) == set(b)
    for leaf in a:
        np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=leaf)
    with pytest.raises(ValueError, match="does not match"):
        from_jax_params(tgpt.GPTConfig.tiny(), params)
    with pytest.raises(ValueError, match="stacks 2 layers"):
        from_jax_params(tbloom.BloomConfig.tiny(num_layers=3), params)


def test_init_from_generator_is_seeded_and_scaled():
    cfg = tbloom.BloomConfig.tiny()
    a = tbloom.init(cfg, torch.Generator().manual_seed(3))
    b = tbloom.init(cfg, torch.Generator().manual_seed(3))
    assert set(a) == set(tbloom.param_shapes(cfg))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert abs(float(a["layers.0.w_down"].std()) - cfg.intermediate_size ** -0.5) < 0.01
    assert abs(float(a["embed"].std()) - cfg.hidden_size ** -0.5) < 0.01
    assert bool((a["embed_ln_scale"] == 1).all()) and not a["layers.1.bq"].any()


# chip_smoke.py's limits for one BLOOM training step on the card (bf16,
# kernels) against the CPU (fp32, plain): TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL,
# and BLOOM's TRAIN_GRAD_AGAINST_BLOOM, TRAIN_LEAF_TOL_BLOOM, GRAD_ZERO_SHARE
CHIP_LOSS_RTOL, CHIP_GRAD_RTOL = 2e-3, 0.05
CHIP_AGAINST, CHIP_LEAF_TOL = {"layers.0.bk": "layers.0.bq"}, {"final_ln_bias": 0.15}
CHIP_ZERO_SHARE = 1e-4


def leaf_rel(g, ref, against=None):
    """Per leaf, ||g - ref||_F over the reference norm of the leaf itself,
    or of the leaf ``against`` names for it (the smoke's
    ``phase_train_whole``)."""
    against = against or {}
    return {k: float((g[k] - ref[k]).norm()) / max(float(ref[against.get(k, k)].norm()), 1e-30)
            for k in ref}


def test_train_limits_separate_sound_from_faulty(monkeypatch):
    """The simulation behind those limits for this family, on the CPU at a
    reduced width (1 layer, hidden 512, 8 heads of 64, vocab 8192, S 256):
    see :func:`_limits_sim`."""
    _limits_sim(monkeypatch, 8192)


def test_train_limits_hold_at_bloom_vocab(monkeypatch):
    """The same simulation at BLOOM's vocabulary of 250880, the smoke's: the
    tied embedding's many near-zero rows shrink the whole gradient's RMS,
    which the limits do not depend on."""
    _limits_sim(monkeypatch, 250880)


def _limits_sim(monkeypatch, vocab):
    """One step's loss and every leaf's grad in bf16 against
    fp32 from the same fp32 masters. Against their own norms, two leaves are
    not held by a relative limit: ``bk``'s exact gradient is zero (softmax
    drops a shift of every key), so its reference is fp32 rounding (below
    1e-6 of ``bq``'s norm) and its bf16 reading ~5000x that; measured
    against ``bq``'s reference norm (the same dS makes both) it reads
    ~1.3e-3. ``final_ln_bias``'s gradient nearly cancels at random init (the
    tied head makes each token predict itself, and the per-token terms
    telescope over the sequence), so bf16 rounding reads 0.03-0.08 of it
    (0.076 at S 512): it has a limit of its own. Every other leaf reads
    under a third of the limit; the ALiBi bias zeroed on the bf16 side (a
    planted fault of the smoke) reads above 0.6 on the attention leaves,
    and LayerNorm's db zeroed (the other) reads 1.0 on the LayerNorm
    biases."""
    batch = {"tokens": np.random.RandomState(0).randint(0, vocab, (1, 257)).astype(np.int32)}
    cfg = tbloom.BloomConfig(vocab_size=vocab, hidden_size=512, num_layers=1, num_heads=8,
                             max_seq_len=512)
    masters = tbloom.init(cfg, torch.Generator().manual_seed(0))

    def step(bf16):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.ModelSpec(
                params={k: v.clone() for k, v in masters.items()},
                loss_fn=lambda p, b: tbloom.loss_fn(
                    cfg, p, b, compute_dtype=torch.bfloat16 if bf16 else torch.float32)),
            config={"train_batch_size": 1, "bf16": {"enabled": bf16}, "steps_per_print": 0},
            device="cpu")
        loss = float(eng.forward(batch))
        return loss, {k: p.grad.float() for k, p in eng.state.params.items()}

    loss32, g32 = step(False)
    loss16, g16 = step(True)
    tol = {k: CHIP_LEAF_TOL.get(k, CHIP_GRAD_RTOL) for k in g32}
    raw = leaf_rel(g16, g32)
    held = leaf_rel(g16, g32, CHIP_AGAINST)
    share = float(g32["layers.0.bk"].norm() / g32["layers.0.bq"].norm())
    print(f"sound: loss rel {abs(loss16 - loss32) / loss32:.2e}; bk raw {raw['layers.0.bk']:.1f}, "
          f"against bq {held['layers.0.bk']:.2e} (reference {share:.1e} of bq's); "
          f"final_ln_bias {raw['final_ln_bias']:.4f}")
    assert abs(loss16 - loss32) / loss32 < CHIP_LOSS_RTOL / 10
    assert raw["layers.0.bk"] > 100 and raw["final_ln_bias"] > CHIP_GRAD_RTOL / 3
    assert share < CHIP_ZERO_SHARE / 100
    assert max(v for k, v in raw.items() if k not in ("layers.0.bk", "final_ln_bias")) \
        < CHIP_GRAD_RTOL / 3
    assert held["layers.0.bk"] < CHIP_GRAD_RTOL / 10
    assert all(held[k] < tol[k] / 1.5 for k in held), held
    real = tbloom._alibi_bias
    monkeypatch.setattr(tbloom, "_alibi_bias", lambda *a, **kw: torch.zeros_like(real(*a, **kw)))
    _, g_bad = step(True)
    bad = leaf_rel(g_bad, g32, CHIP_AGAINST)
    print(f"ALiBi zeroed: worst leaf {max(bad.values()):.4f}")
    assert max(bad[k] / tol[k] for k in bad) > 10
    # LayerNorm's db zeroed (on the CPU the plain LayerNorm has no kernel
    # backward to break, so its bias grads are zeroed here)
    no_db = {k: torch.zeros_like(v) if k.endswith("ln_bias") or "ln1_bias" in k
             or "ln2_bias" in k else v for k, v in g16.items()}
    bad = leaf_rel(no_db, g32, CHIP_AGAINST)
    assert min(bad[k] / tol[k] for k in bad if g32[k] is not None and k.endswith("_bias")
               and "ln" in k) > 6
