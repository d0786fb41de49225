"""The Mixtral family of the PyTorch port (``models/mixtral.py``) against the
JAX package's (``deepspeed_tpu/models/mixtral.py``), on the CPU, in fp32.

Tiny configs (2 layers, 4 heads on 2 kv heads, 4 experts, top 2): plain,
dropping (capacity factor 0.5), and the Qwen2-MoE options together (QKV
biases, raw top-k gates, a shared expert). Weights from the JAX ``init``
with the norm scales and biases perturbed, moved with
``models/convert.py``.

- ``loss_fn`` and ``tiled_loss_fn`` (loss 1e-5), the ``lm_loss`` /
  ``aux_loss`` metrics and every leaf's grad (1e-4).
- 10 engine steps (AdamW, GAS 2, clipping) against the JAX engine: losses,
  grad norms and the two metrics rtol 1e-5, params 2e-4 absolute; 3 steps
  of LAMB and of Muon (the layout seam: JAX's 4-D bank takes Muon's AdamW
  fallback, the router is orthogonalized per layer) at the same limits.
- The remat policies: losses and grads bit for bit those without remat.
- Greedy streams of v1 and v2 (fp32 pools, int8 pools, speculative with
  fused verify) identical to the JAX engines', and v2 to v1.
"""

import dataclasses
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
from deepspeed_tpu.models import mixtral as jmx
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import build_engine_v2
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import mixtral as tmx
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params

VARIANTS = {"plain": {}, "drop": {"capacity_factor": 0.5},
            "qwen2_moe": {"attention_bias": True, "norm_topk_prob": False,
                          "shared_expert_intermediate_size": 48}}


def _setup(variant, seed=0):
    kw = VARIANTS[variant]
    cfg_j, cfg_t = jmx.MixtralConfig.tiny(**kw), tmx.MixtralConfig.tiny(**kw)
    params = jax.tree.map(np.asarray, jmx.init(cfg_j, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    for name in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
        if name in params["layers"]:
            leaf = params["layers"][name]
            base = 0.0 if name.startswith("b") else 1.0
            params["layers"][name] = (base + 0.2 * rs.randn(*leaf.shape)).astype(np.float32)
    params["final_norm"] = (1.0 + 0.2 * rs.randn(cfg_t.hidden_size)).astype(np.float32)
    return cfg_j, cfg_t, params


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_config_and_layout():
    cfg = tmx.MixtralConfig()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
            cfg.top_k, cfg.num_heads, cfg.num_kv_heads, cfg.head_size) == \
        (32000, 4096, 14336, 8, 2, 32, 8, 128)
    assert abs(cfg.num_params / 1e9 - 46.70) < 0.01
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jmx.MixtralConfig())
    assert tmx.CHECKPOINT_NAMES_EMITTED == jmx.CHECKPOINT_NAMES_EMITTED
    assert convert.jax_leaf("layers.3.moe.w_gate") == ("layers/moe/w_gate", 3, False)
    assert convert.jax_leaf("layers.3.w_gate") == ("layers/w_gate", 3, True)
    assert convert.jax_leaf("layers.0.moe.router") == ("layers/moe/router", 0, False)
    _, cfg_t, params = _setup("qwen2_moe")
    back = to_jax_params(cfg_t, from_jax_params(cfg_t, params))
    assert _leaves(back).keys() == _leaves(params).keys()
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(_leaves(back)[k], v, err_msg=k)


@pytest.mark.parametrize("loss", ["dense", "tiled"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_leaf_grad_match_jax(variant, loss):
    cfg_j, cfg_t, params = _setup(variant)
    tokens = np.random.RandomState(3).randint(0, cfg_t.vocab_size, (2, 41)).astype(np.int32)
    if loss == "dense":
        jfn = partial(jmx.loss_fn, compute_dtype=jnp.float32)
        tfn = partial(tmx.loss_fn, compute_dtype=torch.float32)
    else:
        jfn = partial(jmx.tiled_loss_fn, compute_dtype=jnp.float32, shards=4)
        tfn = partial(tmx.tiled_loss_fn, compute_dtype=torch.float32, shards=4)
    (lj, mj), gj = jax.value_and_grad(lambda p: jfn(cfg_j, p, {"tokens": jnp.asarray(tokens)}),
                                      has_aux=True)(jax.tree.map(jnp.asarray, params))
    pt = {k: v.requires_grad_() for k, v in from_jax_params(cfg_t, params).items()}
    lt, mt = tfn(cfg_t, pt, {"tokens": torch.from_numpy(tokens)})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for name in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(mt[name].item(), float(mj[name]), rtol=1e-5, err_msg=name)
    got = _leaves(to_jax_params(cfg_t, {k: v.grad for k, v in pt.items()}))
    want = _leaves(gj)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 0.5, "steps_per_print": 0}


def test_engine_ten_steps_match_jax_engine():
    cfg_j, cfg_t, params = _setup("drop")
    rs = np.random.RandomState(0)
    two = [{"tokens": rs.randint(0, cfg_t.vocab_size, (4, 33)).astype(np.int32)}
           for _ in range(2)]
    batches = [two[i % 2] for i in range(10)]
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params),
                           loss_fn=lambda p, b: jmx.loss_fn(cfg_j, p, b,
                                                            compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    spec = tmx.model_spec(cfg_t, compute_dtype=torch.float32)
    spec.params, spec.init_fn = from_jax_params(cfg_t, params), None
    eng_t, *_ = deepspeed_tpu_torch.initialize(model=spec, config=CONFIG, device="cpu")
    outs_j = [eng_j.train_batch(b) for b in batches]
    outs_t = [eng_t.train_batch(b) for b in batches]
    losses = [float(o.loss) for o in outs_t]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, [float(o.loss) for o in outs_j], rtol=1e-5)
    np.testing.assert_allclose([float(o.grad_norm) for o in outs_t],
                               [float(o.grad_norm) for o in outs_j], rtol=1e-5)
    for name in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose([float(o.aux[name]) for o in outs_t],
                                   [float(o.aux[name]) for o in outs_j], rtol=1e-5, err_msg=name)
    got = _leaves(to_jax_params(cfg_t, {k: v.detach() for k, v in eng_t.state.params.items()}))
    want = _leaves(eng_j.state.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("opt", [
    {"type": "lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    {"type": "muon", "params": {"lr": 0.02, "weight_decay": 0.01}}], ids=["lamb", "muon"])
def test_whole_leaf_optimizers_see_jax_leaves(opt):
    """LAMB's norms run over each JAX leaf whole and Muon orthogonalizes the
    router ``[L, h, E]`` per layer while the 4-D bank ``[L, E, h, i]`` takes
    its AdamW fallback (the layout seam, ``ops/optimizers.py``): 3 engine
    steps against the JAX engine, losses and grad norms rtol 1e-5, params
    2e-4 absolute."""
    cfg_j, cfg_t, params = _setup("plain")
    conf = dict(CONFIG, optimizer=opt)
    batches = [{"tokens": np.random.RandomState(i).randint(0, cfg_t.vocab_size, (4, 33))
                .astype(np.int32)} for i in range(3)]
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params),
                           loss_fn=lambda p, b: jmx.loss_fn(cfg_j, p, b,
                                                            compute_dtype=jnp.float32)),
        config=conf, devices=jax.devices()[:1])
    spec = tmx.model_spec(cfg_t, compute_dtype=torch.float32)
    spec.params, spec.init_fn = from_jax_params(cfg_t, params), None
    eng_t, *_ = deepspeed_tpu_torch.initialize(model=spec, config=conf, device="cpu")
    outs_j = [eng_j.train_batch(b) for b in batches]
    outs_t = [eng_t.train_batch(b) for b in batches]
    np.testing.assert_allclose([float(o.loss) for o in outs_t],
                               [float(o.loss) for o in outs_j], rtol=1e-5)
    np.testing.assert_allclose([float(o.grad_norm) for o in outs_t],
                               [float(o.grad_norm) for o in outs_j], rtol=1e-5)
    got = _leaves(to_jax_params(cfg_t, {k: v.detach() for k, v in eng_t.state.params.items()}))
    for k, want in _leaves(eng_j.state.params).items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("policy", ["none", "full", "dots", "save_attn_out"])
def test_remat_policies_bit_identical_to_no_remat(policy):
    _, cfg_t, params = _setup("drop")
    tokens = torch.from_numpy(
        np.random.RandomState(4).randint(0, cfg_t.vocab_size, (2, 33)).astype(np.int32))

    def run(cfg):
        pt = {k: v.requires_grad_() for k, v in from_jax_params(cfg, params).items()}
        loss, aux = tmx.loss_fn(cfg, pt, {"tokens": tokens}, compute_dtype=torch.float32)
        loss.backward()
        return loss.detach(), aux["aux_loss"], {k: v.grad for k, v in pt.items()}

    base = run(cfg_t)
    remat = run(dataclasses.replace(cfg_t, remat=True, remat_policy=policy))
    assert torch.equal(base[0], remat[0]) and torch.equal(base[1], remat[1])
    for k, g in base[2].items():
        assert torch.equal(g, remat[2][k]), k


V1 = {"dtype": "float32", "prefill_bucket": 8}
V2 = {"dtype": "float32", "prefill_bucket": 16,
      "ragged": {"max_tracked_sequences": 4, "max_ragged_batch_size": 4,
                 "memory_config_blocks": 48, "block_size": 8}}
MODES = {"fp32": {}, "int8": {"kv_quant": {"enabled": True, "group_size": 16}},
         "spec": {"speculative": {"enabled": True, "max_draft_tokens": 4,
                                  "fused_verify": True}}}
NEW = 12


def _prompts(vocab):
    rs = np.random.RandomState(5)
    base = [rs.randint(0, vocab, n).astype(np.int32) for n in (16, 5, 14, 9)]
    # a repetitive prompt the drafter matches
    base[1] = np.tile(base[1], 3)
    return base


@pytest.mark.parametrize("variant", ["plain", "qwen2_moe"])
def test_v1_greedy_streams_match_jax(variant):
    cfg_j, cfg_t, params = _setup(variant)
    mesh_lib.set_mesh(None)
    fam = jinf.ModelFamily(
        cfg=cfg_j,
        apply_fn=lambda *a, **kw: jmx.apply(*a, **dict(kw, compute_dtype=jnp.float32))[0],
        apply_cached=partial(jmx.apply_cached, compute_dtype=jnp.float32),
        init_cache=partial(jmx.init_cache, dtype=jnp.float32),
        param_logical_axes=jmx.param_logical_axes, name="mixtral")
    eng_j = jinf.InferenceEngine(fam, jax.tree.map(jnp.asarray, params), JConfig.from_dict(V1))
    eng_t = init_inference(tmx, model_cfg=cfg_t, params=from_jax_params(cfg_t, params),
                           config=V1, device="cpu")
    prompts = np.random.RandomState(2).randint(0, cfg_t.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 13], np.int32)
    want = np.asarray(eng_j.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW))
    got = eng_t.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    logits = eng_t.forward(prompts)
    want_logits = jmx.apply(cfg_j, jax.tree.map(jnp.asarray, params), jnp.asarray(prompts),
                            compute_dtype=jnp.float32)[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_v2_greedy_streams_match_jax_and_v1(mode):
    cfg_j, cfg_t, params = _setup("plain")
    conf = dict(V2, **MODES[mode])
    mesh_lib.set_mesh(None)
    eng_j = JEngine(jinf.ModelFamily.from_module(jmx, cfg_j), params, JConfig.from_dict(conf),
                    init_paged_cache=partial(jmx.init_paged_cache, dtype=jnp.float32),
                    apply_paged=partial(jmx.apply_paged, compute_dtype=jnp.float32))
    eng_t = build_engine_v2(tmx, cfg_t, from_jax_params(cfg_t, params), config=conf,
                            device="cpu")
    prompts = _prompts(cfg_t.vocab_size)
    want = [[int(t) for t in s] for s in eng_j.generate(prompts, max_new_tokens=NEW)]
    got = eng_t.generate(prompts, max_new_tokens=NEW)
    assert [list(map(int, s)) for s in got] == want
    if mode == "spec":
        assert eng_t.spec_stats == eng_j.spec_stats
        assert eng_t.spec_stats["verify_steps"] > 0
    if mode == "int8":
        assert eng_t.cache["k"].dtype == torch.int8
    v1 = init_inference(tmx, model_cfg=cfg_t, params=from_jax_params(cfg_t, params),
                        config=V1, device="cpu")
    for p, s in zip(prompts, got):
        if mode != "int8":
            assert v1.generate(p[None], max_new_tokens=NEW)[0].tolist() == list(map(int, s))
