"""The EXAONE-4 family of the PyTorch port (``models/exaone4.py``) against the
JAX package's (``deepspeed_tpu/models/exaone4.py``), on the CPU, in fp32.

Tiny configs (4 layers, 4 heads on 2 kv heads, head size 16, window 16):
hybrid (layers L G L G: the sliding ones with RoPE and the window, the
global ones without RoPE) and pure-global (``sliding_window=None``: RoPE on
every layer, causal attention). Weights from the JAX ``init`` with the
norm scales perturbed (so the QK-norm and post-norm grads are not
degenerate), moved with ``models/convert.py``.

- ``apply``, ``loss_fn`` and every leaf grad: loss 1e-5, logits 1e-5,
  grads 1e-4; ``tiled_loss_fn`` against JAX's, loss 1e-5 and grads 1e-4.
- 10 engine steps (AdamW with a no-decay group on the norms, GAS 2,
  clipping) against the JAX engine: losses and grad norms rtol 1e-5,
  params 2e-4 absolute (``test_torch_train_llama.py``'s tolerances).
- Greedy streams of v1 (``init_inference``) and v2 (``build_engine_v2``)
  identical to the JAX engines', token for token, with decodes past the
  window (contexts to 30 against the window of 16), on fp32 pools and on
  int8 pools.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as mesh_lib
from deepspeed_tpu.inference import engine as jinf
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models import exaone4 as jex
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import build_engine_v2
from deepspeed_tpu_torch.models import exaone4 as tex
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params

VARIANTS = {"hybrid": {}, "global": {"sliding_window": None}}


def _setup(variant, seed=0):
    kw = VARIANTS[variant]
    cfg_j, cfg_t = jex.Exaone4Config.tiny(**kw), tex.Exaone4Config.tiny(**kw)
    params = jax.tree.map(np.asarray, jex.init(cfg_j, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    for name in ("q_norm", "k_norm", "post_attn_norm", "post_mlp_norm"):
        leaf = params["layers"][name]
        params["layers"][name] = (1.0 + 0.2 * rs.randn(*leaf.shape)).astype(np.float32)
    params["final_norm"] = (1.0 + 0.2 * rs.randn(cfg_t.hidden_size)).astype(np.float32)
    return cfg_j, cfg_t, params


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_layer_pattern_matches_jax():
    for variant in VARIANTS:
        cfg_j, cfg_t, _ = _setup(variant)
        windows, rope = jex._layer_scalars(cfg_j)
        got = tex.layer_scalars(cfg_t)
        assert [w if w is not None else 1 << 30 for w, _ in got] == list(np.asarray(windows))
        assert [int(r) for _, r in got] == list(np.asarray(rope))
    cfg = tex.Exaone4Config.exaone4_32b()
    assert cfg.resolved_layer_types()[:4] == ("sliding_attention",) * 3 + ("full_attention",)
    assert sum(w is None for w, _ in tex.layer_scalars(cfg)) == 16
    assert abs(cfg.num_params / 1e9 - 32.0) < 0.1


@pytest.mark.parametrize("loss", ["dense", "tiled"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_leaf_grad_match_jax(variant, loss):
    cfg_j, cfg_t, params = _setup(variant)
    tokens = np.random.RandomState(3).randint(0, cfg_t.vocab_size, (2, 41)).astype(np.int32)
    if loss == "dense":
        jfn = partial(jex.loss_fn, compute_dtype=jnp.float32)
        tfn = partial(tex.loss_fn, compute_dtype=torch.float32)
    else:
        jfn = partial(jex.tiled_loss_fn, compute_dtype=jnp.float32, shards=4)
        tfn = partial(tex.tiled_loss_fn, compute_dtype=torch.float32, shards=4)
    (lj, _), gj = jax.value_and_grad(lambda p: jfn(cfg_j, p, {"tokens": jnp.asarray(tokens)}),
                                     has_aux=True)(jax.tree.map(jnp.asarray, params))
    pt = {k: v.requires_grad_() for k, v in from_jax_params(cfg_t, params).items()}
    lt, _ = tfn(cfg_t, pt, {"tokens": torch.from_numpy(tokens)})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    got = _leaves(to_jax_params(cfg_t, {k: v.grad for k, v in pt.items()}))
    want = _leaves(gj)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    if loss == "dense":
        logits_j = jex.apply(cfg_j, jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
                             compute_dtype=jnp.float32)
        logits_t = tex.apply(cfg_t, {k: v.detach() for k, v in pt.items()},
                             torch.from_numpy(tokens), compute_dtype=torch.float32)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)


CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1},
                        "param_groups": [{"pattern": "(norm|bias)", "weight_decay": 0.0}]},
          "gradient_clipping": 0.5, "steps_per_print": 0}


def test_engine_ten_steps_match_jax_engine():
    cfg_j, cfg_t, params = _setup("hybrid")
    rs = np.random.RandomState(0)
    two = [{"tokens": rs.randint(0, cfg_t.vocab_size, (4, 33)).astype(np.int32)}
           for _ in range(2)]
    batches = [two[i % 2] for i in range(10)]
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params),
                           loss_fn=lambda p, b: jex.loss_fn(cfg_j, p, b,
                                                            compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    spec = tex.model_spec(cfg_t, compute_dtype=torch.float32)
    spec.params, spec.init_fn = from_jax_params(cfg_t, params), None
    eng_t, *_ = deepspeed_tpu_torch.initialize(model=spec, config=CONFIG, device="cpu")
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


V1 = {"dtype": "float32", "prefill_bucket": 8}
V2 = {"dtype": "float32", "prefill_bucket": 16,
      "ragged": {"max_tracked_sequences": 4, "max_ragged_batch_size": 4,
                 "memory_config_blocks": 48, "block_size": 8}}
INT8 = {"kv_quant": {"enabled": True, "group_size": 16}}
NEW = 14


def _prompts(vocab, lengths):
    rs = np.random.RandomState(5)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_v1_greedy_streams_match_jax(variant):
    cfg_j, cfg_t, params = _setup(variant)
    mesh_lib.set_mesh(None)
    fam = jinf.ModelFamily(
        cfg=cfg_j, apply_fn=partial(jex.apply, compute_dtype=jnp.float32),
        apply_cached=partial(jex.apply_cached, compute_dtype=jnp.float32),
        init_cache=partial(jex.init_cache, dtype=jnp.float32),
        param_logical_axes=jex.param_logical_axes, name="exaone4")
    eng_j = jinf.InferenceEngine(fam, jax.tree.map(jnp.asarray, params), JConfig.from_dict(V1))
    eng_t = init_inference(tex, model_cfg=cfg_t, params=from_jax_params(cfg_t, params),
                           config=V1, device="cpu")
    prompts = np.random.RandomState(2).randint(0, cfg_t.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 13], np.int32)
    want = np.asarray(eng_j.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW))
    got = eng_t.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    assert int(lengths.max()) + NEW > 16 + 8      # past the hybrid window


@pytest.mark.parametrize("pools", ["fp32", "int8"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_v2_greedy_streams_match_jax(variant, pools):
    cfg_j, cfg_t, params = _setup(variant)
    conf = dict(V2, **(INT8 if pools == "int8" else {}))
    mesh_lib.set_mesh(None)
    eng_j = JEngine(jinf.ModelFamily.from_module(jex, cfg_j), params, JConfig.from_dict(conf),
                    init_paged_cache=partial(jex.init_paged_cache, dtype=jnp.float32),
                    apply_paged=partial(jex.apply_paged, compute_dtype=jnp.float32))
    eng_t = build_engine_v2(tex, cfg_t, from_jax_params(cfg_t, params), config=conf,
                            device="cpu")
    if pools == "int8":
        assert eng_t.cache["k"].dtype == torch.int8
    prompts = _prompts(cfg_t.vocab_size, [16, 5, 14, 9])
    want = [[int(t) for t in s] for s in eng_j.generate(prompts, max_new_tokens=NEW)]
    got = eng_t.generate(prompts, max_new_tokens=NEW)
    assert [list(map(int, s)) for s in got] == want
