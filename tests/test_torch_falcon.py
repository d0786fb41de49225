"""The Falcon family of the PyTorch port (``models/falcon.py``) against the JAX
package's (``deepspeed_tpu/models/falcon.py``), on the CPU, in fp32.

Tiny configs (2 layers, hidden 64, 4 heads of 16) in the four variants:
classic (the parallel MQA block of Falcon-7B: one kv head, one LayerNorm
feeding both branches, the tied head), ``new_arch`` (the new decoder
architecture of Falcon-40B/180B: separate ``ln_mlp``, 2 kv heads),
``sequential`` (``parallel_attn=False``) and ``untied`` (an ``lm_head``
leaf). Weights from the JAX ``init`` with the LayerNorm scales and biases
perturbed (so their grads are exercised), moved with ``models/convert.py``;
tokens from numpy. The JAX attention op runs as the JAX package's own CPU
tests run it.

- ``loss_fn`` and ``tiled_loss_fn``: loss 1e-5 relative, every leaf's grad
  1e-4 (relative, with an absolute floor of 1e-4 of the leaf's largest
  grad: fp32 sums in another order), logits 1e-5.
- 10 engine steps (AdamW, GAS 2, clipping) against the JAX engine on one
  device: losses and grad norms 1e-5 relative, params 2e-4 absolute
  (``test_torch_train_llama.py``'s tolerances).
- Greedy streams of v1 (``init_inference``) identical to the JAX engine's,
  token for token; of v2 (``build_engine_v2``, on ``tests/_v2_pair.py``)
  on fp32 pools, int8 pools and under speculative decoding with fused
  verify, identical to JAX's v2 (and ``spec_stats`` equal).
- ZeRO-3 on 2 gloo ranks against the JAX engine at dp = 2: losses and grad
  norms 2e-4, final params 2e-4 absolute (``test_torch_zero_stages.py``'s
  tolerances); Falcon-7B's narrow ``wk`` / ``wv`` (one kv head) are the
  partitioner's new leaf shapes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair, ints

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as mesh_lib
from deepspeed_tpu.inference import engine as jinf
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.models import falcon as jfa
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import falcon as tfa
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params

VARIANTS = {"classic": {}, "new_arch": {"new_decoder_architecture": True, "num_kv_heads": 2},
            "sequential": {"parallel_attn": False}, "untied": {"tie_embeddings": False}}


def _params(cfg_j, seed=0):
    params = jax.tree.map(np.asarray, jfa.init(cfg_j, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    for tree in (params["layers"], params):
        for name, leaf in tree.items():
            if name.endswith("_scale") or name.endswith("_bias"):
                base = 1.0 if name.endswith("_scale") else 0.0
                tree[name] = (base + 0.2 * rs.randn(*leaf.shape)).astype(np.float32)
    return params


def _setup(variant, seed=0, **kw):
    kw = dict(VARIANTS[variant], **kw)
    cfg_j, cfg_t = jfa.FalconConfig.tiny(**kw), tfa.FalconConfig.tiny(**kw)
    return cfg_j, cfg_t, _params(cfg_j, seed)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_config_shapes_and_convert():
    cfg = tfa.FalconConfig()
    assert (cfg.head_size, cfg.num_kv_heads, cfg.intermediate_size) == (64, 1, 18176)
    assert abs(sum(int(np.prod(s)) for s, _ in tfa.param_shapes(cfg).values())
               - cfg.num_params) == 0
    assert abs(cfg.num_params / 1e9 - 6.92) < 0.01       # Falcon-7B
    for variant in VARIANTS:
        cfg_j, cfg_t, params = _setup(variant)
        sd = from_jax_params(cfg_t, params)
        assert set(sd) == set(tfa.param_shapes(cfg_t)) == set(tfa.param_logical_axes(cfg_t))
        assert ("lm_head" in sd) == (variant == "untied")
        assert ("layers.0.ln_mlp_scale" in sd) == (variant in ("new_arch", "sequential"))
        np.testing.assert_array_equal(sd["layers.1.wk"].numpy(), params["layers"]["wk"][1].T)
        back = _leaves(to_jax_params(cfg_t, sd))
        want = _leaves(params)
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    a = tfa.init(cfg_t, torch.Generator().manual_seed(3))
    assert set(a) == set(tfa.param_shapes(cfg_t))
    assert bool((a["final_ln_scale"] == 1).all()) and not a["layers.0.ln_attn_bias"].any()


@pytest.mark.parametrize("loss", ["dense", "tiled"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_leaf_grad_match_jax(variant, loss):
    cfg_j, cfg_t, params = _setup(variant)
    tokens = np.random.RandomState(3).randint(0, cfg_t.vocab_size, (2, 41)).astype(np.int32)
    if loss == "dense":
        jfn = partial(jfa.loss_fn, compute_dtype=jnp.float32)
        tfn = partial(tfa.loss_fn, compute_dtype=torch.float32)
    else:
        jfn = partial(jfa.tiled_loss_fn, compute_dtype=jnp.float32, shards=4)
        tfn = partial(tfa.tiled_loss_fn, compute_dtype=torch.float32, shards=4)
    (lj, _), gj = jax.value_and_grad(lambda p: jfn(cfg_j, p, {"tokens": jnp.asarray(tokens)}),
                                     has_aux=True)(jax.tree.map(jnp.asarray, params))
    pt = {k: v.requires_grad_() for k, v in from_jax_params(cfg_t, params).items()}
    lt, aux = tfn(cfg_t, pt, {"tokens": torch.from_numpy(tokens)})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert int(aux["ntokens"]) == 2 * 40
    got = _leaves(to_jax_params(cfg_t, {k: v.grad for k, v in pt.items()}))
    want = _leaves(gj)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    if loss == "dense":
        logits_j = jfa.apply(cfg_j, jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
                             compute_dtype=jnp.float32)
        logits_t = tfa.apply(cfg_t, {k: v.detach() for k, v in pt.items()},
                             torch.from_numpy(tokens), compute_dtype=torch.float32)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)


CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 0.5, "steps_per_print": 0}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_ten_steps_match_jax_engine(variant):
    cfg_j, cfg_t, params = _setup(variant)
    rs = np.random.RandomState(0)
    two = [{"tokens": rs.randint(0, cfg_t.vocab_size, (4, 33)).astype(np.int32)}
           for _ in range(2)]
    batches = [two[i % 2] for i in range(10)]
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params),
                           loss_fn=lambda p, b: jfa.loss_fn(cfg_j, p, b,
                                                            compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    spec = tfa.model_spec(cfg_t, compute_dtype=torch.float32)
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
NEW = 12


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_v1_greedy_streams_match_jax(variant):
    cfg_j, cfg_t, params = _setup(variant)
    mesh_lib.set_mesh(None)
    fam = jinf.ModelFamily(
        cfg=cfg_j, apply_fn=partial(jfa.apply, compute_dtype=jnp.float32),
        apply_cached=partial(jfa.apply_cached, compute_dtype=jnp.float32),
        init_cache=partial(jfa.init_cache, dtype=jnp.float32),
        param_logical_axes=jfa.param_logical_axes, name="falcon")
    eng_j = jinf.InferenceEngine(fam, jax.tree.map(jnp.asarray, params), JConfig.from_dict(V1))
    eng_t = init_inference(tfa, model_cfg=cfg_t, params=from_jax_params(cfg_t, params),
                           config=V1, device="cpu")
    prompts = np.random.RandomState(2).randint(0, cfg_t.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 13], np.int32)
    want = np.asarray(eng_j.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW))
    got = eng_t.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    logits = eng_t.forward(prompts)
    want_logits = jfa.apply(cfg_j, jax.tree.map(jnp.asarray, params), jnp.asarray(prompts),
                            compute_dtype=jnp.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)


MODES = {"fp32": {}, "int8": {"kv_quant": {"enabled": True, "group_size": 16}},
         "spec": {"speculative": {"enabled": True, "max_draft_tokens": 4,
                                  "fused_verify": True}}}


@pytest.mark.parametrize("variant,mode", [("classic", "fp32"), ("classic", "int8"),
                                          ("classic", "spec"), ("new_arch", "fp32"),
                                          ("sequential", "int8"), ("untied", "spec")])
def test_v2_greedy_streams_match_jax(variant, mode):
    cfg_j, _, params = _setup(variant, max_seq_len=128)
    pair = Pair(jfa, tfa, "FalconConfig", params=params, **VARIANTS[variant])
    eng_j, eng_t = pair.jax(**MODES[mode]), pair.port(**MODES[mode])
    prompts = pair.prompts([16, 5, 14, 9], seed=5)
    prompts[1] = np.tile(prompts[1], 3)          # a repetitive prompt the drafter matches
    want = ints(eng_j.generate(prompts, max_new_tokens=NEW))
    got = eng_t.generate(prompts, max_new_tokens=NEW)
    assert [list(map(int, s)) for s in got] == want
    if mode == "spec":
        assert eng_t.spec_stats == eng_j.spec_stats
        assert eng_t.spec_stats["verify_steps"] > 0
    if mode == "int8":
        assert eng_t.cache["k"].dtype == torch.int8
    assert eng_t.cache["k"].shape[2] == pair.tcfg.num_kv_heads    # narrow pools


ZERO = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=1,
            max_seq_len=64)
ZBATCH, ZSEQ, ZSTEPS = 8, 32, 6


def _zero_config(stage):
    return {"train_batch_size": ZBATCH, "optimizer": {"type": "adamw", "params": {
        "lr": 1e-3, "weight_decay": 0.1}}, "zero_optimization": {"stage": stage},
        "gradient_clipping": 1.0, "steps_per_print": 0}


def test_zero3_two_ranks_match_jax_dp2(tmp_path):
    """ZeRO-3 over 2 gloo ranks against the JAX engine at dp = 2 (stage 0,
    the oracle ``test_torch_zero_stages.py`` uses for stage 3)."""
    cfg_j, cfg_t = jfa.FalconConfig(**ZERO), tfa.FalconConfig(**ZERO)
    params = _params(cfg_j, seed=4)
    batches = [{"tokens": np.random.default_rng(100 + i).integers(
        0, ZERO["vocab_size"], (ZBATCH, ZSEQ + 1), dtype=np.int32)} for i in range(ZSTEPS)]
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params),
                           logical_axes=jfa.param_logical_axes(cfg_j),
                           loss_fn=lambda p, b: jfa.loss_fn(cfg_j, p, b,
                                                            compute_dtype=jnp.float32)),
        config=_zero_config(0), devices=jax.devices()[:2])
    outs = [eng_j.train_batch(b) for b in batches]
    arrs = {f"param/{k}": v.numpy() for k, v in from_jax_params(cfg_t, params).items()}
    arrs.update({f"batch/{i}/tokens": b["tokens"] for i, b in enumerate(batches)})
    np.savez(tmp_path / "in.npz", **arrs)
    ranks = spawn({"scenario": "train", "family": "falcon", "cfg": ZERO,
                   "runs": [{"name": "s3", "config": _zero_config(3), "steps": ZSTEPS}],
                   "local_shapes": ["layers.0.wk", "embed"],
                   "npz": str(tmp_path / "in.npz")}, 2, tmp_path)
    got = ranks[0]
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["s3/losses"], [float(o.loss) for o in outs], **tol)
    np.testing.assert_allclose(got["s3/grad_norm"], [float(o.grad_norm) for o in outs], **tol)
    assert got["s3/losses"][-1] < got["s3/losses"][0]
    for r in ranks:      # each rank holds half of the one-kv-head wk and of the tied embed
        assert int(np.prod(r["s3/local_shape/layers.0.wk"])) == 16 * 64 // 2
        assert int(np.prod(r["s3/local_shape/embed"])) == 128 * 64 // 2
    params_t = {k.split("/", 2)[2]: torch.from_numpy(v) for k, v in got.items()
                if k.startswith("s3/param/")}
    have = _leaves(to_jax_params(cfg_t, params_t))
    want = _leaves(eng_j.state.params)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=2e-4, err_msg=k)
