"""The BERT family of the PyTorch port (``models/bert.py``) against the JAX
package's (``deepspeed_tpu/models/bert.py``), on the CPU, in fp32.

Tiny configs (2 layers, hidden 64, 4 heads of 16; the exact-erf and the
tanh GELU; a DistilBERT-shaped one with one token type). Weights from the
JAX ``init`` with every LayerNorm and bias perturbed, moved with
``models/convert.py``; tokens, labels (-100 on most positions) and masks
from numpy.

- ``apply`` (hidden, pooled, MLM logits 1e-5) and ``loss_fn`` with every
  leaf's grad: loss 1e-5 relative, grads 1e-4 (relative, absolute floor 1e-4
  of the leaf's largest grad), with and without an ``attention_mask``, with
  token types; ``remat`` computes the same.
- 10 engine steps (AdamW, GAS 2, clipping) against the JAX engine: losses
  and grad norms 1e-5 relative, params 2e-4 absolute.
- A universal checkpoint of the port's engine: a resume continues the run
  bit for bit; the JAX engine resumes the same tag; the config's JSON
  round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.models import bert as tb
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params
from deepspeed_tpu_torch.runtime.checkpoint.universal import (model_config_from_json,
                                                              model_config_to_json)

VARIANTS = {"erf": {}, "tanh": {"gelu_approx": True},
            "distil": {"type_vocab_size": 1, "num_layers": 3}}


def _setup(variant, seed=0):
    kw = VARIANTS[variant]
    cfg_j, cfg_t = jb.BertConfig.tiny(**kw), tb.BertConfig.tiny(**kw)
    params = jax.tree.map(np.asarray, jb.init(cfg_j, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    for tree in (params["layers"], params):
        for name, leaf in tree.items():
            if "ln" in name or name.startswith("b") or name == "pooler_b":
                base = 1.0 if name.endswith("_scale") else 0.0
                tree[name] = (base + 0.2 * rs.randn(*leaf.shape)).astype(np.float32)
    return cfg_j, cfg_t, params


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed, b=2, s=24, mask=False, types=False):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.where(rs.rand(b, s) < 0.3, rs.randint(0, cfg.vocab_size, (b, s)),
                      -100).astype(np.int32)
    labels[:, 0] = 5                       # every row counts a token
    batch = {"tokens": tokens, "labels": labels}
    if mask:
        m = np.ones((b, s), np.int32)
        m[0, s - 7:] = 0
        m[1, s - 2:] = 0
        batch["attention_mask"] = m
    if types:
        batch["token_types"] = (rs.rand(b, s) < 0.5).astype(np.int32)
    return batch


def test_presets_and_convert():
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                  "max_seq_len", "type_vocab_size", "layer_norm_eps", "gelu_approx", "remat",
                  "head_size"):
        assert getattr(tb.BertConfig.bert_base(), field) == \
            getattr(jb.BertConfig.bert_base(), field), field
    for variant in VARIANTS:
        cfg_j, cfg_t, params = _setup(variant)
        sd = from_jax_params(cfg_t, params)
        assert set(sd) == set(tb.param_shapes(cfg_t)) == set(tb.param_logical_axes(cfg_t))
        np.testing.assert_array_equal(sd["layers.1.wqkv"].numpy(), params["layers"]["wqkv"][1].T)
        np.testing.assert_array_equal(sd["pooler_w"].numpy(), params["pooler_w"])
        back, want = _leaves(to_jax_params(cfg_t, sd)), _leaves(params)
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    init = tb.init(cfg_t, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: s for k, (s, _) in tb.param_shapes(cfg_t).items()}


@pytest.mark.parametrize("inputs", ["plain", "mask", "types", "mask_types"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_leaf_grad_match_jax(variant, inputs):
    cfg_j, cfg_t, params = _setup(variant)
    batch = _batch(cfg_t, 3, mask="mask" in inputs,
                   types="types" in inputs and cfg_t.type_vocab_size > 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (lj, _), gj = jax.value_and_grad(
        lambda p: jb.loss_fn(cfg_j, p, jbatch, compute_dtype=jnp.float32),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    pt = {k: v.requires_grad_() for k, v in from_jax_params(cfg_t, params).items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    lt, _ = tb.loss_fn(cfg_t, pt, tbatch, compute_dtype=torch.float32)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    # the pooler is outside the MLM loss: no grad here, zeros in JAX
    got = _leaves(to_jax_params(cfg_t, {k: torch.zeros_like(v) if v.grad is None else v.grad
                                        for k, v in pt.items()}))
    want = _leaves(gj)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    out_j = jb.apply(cfg_j, jax.tree.map(jnp.asarray, params), jbatch["tokens"],
                     token_types=jbatch.get("token_types"),
                     attention_mask=jbatch.get("attention_mask"), compute_dtype=jnp.float32)
    out_t = tb.apply(cfg_t, {k: v.detach() for k, v in pt.items()}, tbatch["tokens"],
                     token_types=tbatch.get("token_types"),
                     attention_mask=tbatch.get("attention_mask"), compute_dtype=torch.float32)
    for key in ("hidden", "pooled", "mlm_logits"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_remat_computes_the_same():
    _, cfg_t, params = _setup("erf")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg_t, 4, mask=True).items()}
    grads = []
    for remat in (False, True):
        cfg = tb.BertConfig.tiny(remat=remat)
        pt = {k: v.requires_grad_() for k, v in from_jax_params(cfg, params).items()}
        loss, _ = tb.loss_fn(cfg, pt, batch, compute_dtype=torch.float32)
        loss.backward()
        grads.append((loss.item(), {k: v.grad for k, v in pt.items() if v.grad is not None}))
    assert grads[0][0] == grads[1][0]
    for k, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][k], g, rtol=1e-6, atol=1e-7)


CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 0.5, "steps_per_print": 0}


def _engines(variant, params_np=None, seed=0):
    cfg_j, cfg_t, params = _setup(variant, seed)
    params = params if params_np is None else params_np
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params),
                           loss_fn=lambda p, b: jb.loss_fn(cfg_j, p, b,
                                                           compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    spec = tb.model_spec(cfg_t, compute_dtype=torch.float32)
    spec.params, spec.init_fn = from_jax_params(cfg_t, params), None
    eng_t, *_ = deepspeed_tpu_torch.initialize(model=spec, config=CONFIG, device="cpu")
    return cfg_t, eng_j, eng_t


def _batches(cfg, mask):
    two = [_batch(cfg, 10 + i, b=4, s=16, mask=mask) for i in range(2)]
    return [two[i % 2] for i in range(10)]


@pytest.mark.parametrize("mask", [False, True])
def test_engine_ten_steps_match_jax_engine(mask):
    cfg_t, eng_j, eng_t = _engines("erf")
    batches = _batches(cfg_t, mask)
    outs_j = [eng_j.train_batch(b) for b in batches]
    outs_t = [eng_t.train_batch(b) for b in batches]
    losses = [float(o.loss) for o in outs_t]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, [float(o.loss) for o in outs_j], rtol=1e-5)
    np.testing.assert_allclose([float(o.grad_norm) for o in outs_t],
                               [float(o.grad_norm) for o in outs_j], rtol=1e-5)
    got = _leaves(to_jax_params(cfg_t, {k: v.detach() for k, v in eng_t.state.params.items()}))
    want = _leaves(eng_j.state.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4, err_msg=k)


def test_universal_save_load(tmp_path):
    """A universal tag of the port's engine: a second port engine (other
    weights) resumes it and continues bit for bit; the JAX engine resumes
    the same tag and continues within the trajectory tolerances; the
    config goes through its JSON."""
    cfg_t, eng_j, eng_t = _engines("distil")
    assert model_config_from_json(model_config_to_json(cfg_t)) == cfg_t
    batches = _batches(cfg_t, True)
    for b in batches[:3]:
        eng_t.train_batch(b)
    eng_t.save_universal_checkpoint(str(tmp_path), tag="u3")
    rest = [float(eng_t.train_batch(b).loss) for b in batches[3:6]]

    _, eng_j2, eng_t2 = _engines("distil", seed=7)
    eng_t2.load_universal_checkpoint(str(tmp_path))
    assert eng_t2.global_steps == 3
    assert [float(eng_t2.train_batch(b).loss) for b in batches[3:6]] == rest
    for k, v in eng_t.state.params.items():
        assert torch.equal(eng_t2.state.params[k], v), k
    eng_j2.load_universal_checkpoint(str(tmp_path))
    np.testing.assert_allclose([float(eng_j2.train_batch(b).loss) for b in batches[3:6]],
                               rest, rtol=1e-5)
