"""The GPT-NeoX / GPT-J family of the PyTorch port (``models/gptneox.py``)
against the JAX package's (``deepspeed_tpu/models/gptneox.py``), on the CPU,
in fp32.

Tiny configs (2 layers, hidden 64, 4 heads of 16) under four flag sets:
``neox`` (GPT-NeoX: ln1 + ln2 in a parallel residual, split-half rotary
over ``rotary_pct`` 0.25 of the head, biases on q / k / v / o and the MLP,
erf GELU), ``sequential`` (``parallel_residual=False``), ``gptj`` (GPT-J's
flags: one shared LayerNorm, interleaved rotary over ``rotary_dim`` 8, no
attention biases, ``lm_head_bias``, tanh GELU) and ``mixed`` (the shared
LayerNorm, ``lm_head_bias`` and tanh GELU over split-half rotary, without
MLP biases). Weights from the JAX ``init`` with every LayerNorm and bias
perturbed, moved with ``models/convert.py``; tokens from numpy.

- ``loss_fn`` and ``tiled_loss_fn`` (the tiled head takes the logit bias):
  loss 1e-5 relative, every leaf's grad 1e-4 (relative, absolute floor
  1e-4 of the leaf's largest grad), logits 1e-5.
- 10 engine steps (AdamW, GAS 2, clipping) against the JAX engine: losses
  and grad norms 1e-5 relative, params 2e-4 absolute.
- Greedy streams of v1 (``init_inference``) identical to JAX's.
- ``build_engine_v2`` refuses the family with the JAX package's message
  (it has no paged path in either package).
- ``runtime.engine.check_head_dim``: ``initialize`` refuses a head dim the
  flash kernels do not take (GPT-J-6B's 256) on a CUDA device, and takes
  GPT-NeoX-20B's 96 there and any on the CPU.
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
from deepspeed_tpu.models import gptneox as jnx
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import build_engine_v2
from deepspeed_tpu_torch.models import gptneox as tnx
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params
from deepspeed_tpu_torch.runtime.engine import check_head_dim

GPTJ = dict(rotary_dim=8, rotary_interleaved=True, shared_ln=True, qkv_bias=False,
            attn_out_bias=False, lm_head_bias=True, gelu_approx=True)
VARIANTS = {"neox": {}, "sequential": {"parallel_residual": False}, "gptj": GPTJ,
            "mixed": {"shared_ln": True, "lm_head_bias": True, "gelu_approx": True,
                      "mlp_bias": False}}


def _setup(variant, seed=0):
    kw = VARIANTS[variant]
    cfg_j, cfg_t = jnx.GPTNeoXConfig.tiny(**kw), tnx.GPTNeoXConfig.tiny(**kw)
    params = jax.tree.map(np.asarray, jnx.init(cfg_j, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    for tree in (params["layers"], params):
        for name, leaf in tree.items():
            if "ln" in name or name.startswith("b") or name == "lm_head_bias":
                base = 1.0 if name.endswith("_scale") else 0.0
                tree[name] = (base + 0.2 * rs.randn(*leaf.shape)).astype(np.float32)
    return cfg_j, cfg_t, params


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["neox_20b", "gptj_6b"])
def test_presets_and_convert(name):
    cfg = tnx.GPTNeoXConfig() if name == "neox_20b" else tnx.GPTNeoXConfig.gptj_6b()
    want = jnx.GPTNeoXConfig() if name == "neox_20b" else jnx.GPTNeoXConfig.gptj_6b()
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                  "head_size", "rot_dim", "rotary_interleaved", "shared_ln", "qkv_bias",
                  "lm_head_bias", "gelu_approx", "parallel_residual"):
        assert getattr(cfg, field) == getattr(want, field), field
    n = sum(int(np.prod(s)) for s, _ in tnx.param_shapes(cfg).values())
    assert n == cfg.num_params
    if name == "neox_20b":
        assert (cfg.head_size, cfg.rot_dim) == (96, 24) and abs(n / 1e9 - 20.55) < 0.01
    else:
        assert (cfg.head_size, cfg.rot_dim) == (256, 64) and abs(n / 1e9 - 6.05) < 0.01
    with pytest.raises(ValueError, match="shared_ln requires parallel_residual"):
        tnx.GPTNeoXConfig.tiny(shared_ln=True, parallel_residual=False)
    for variant in VARIANTS:
        cfg_j, cfg_t, params = _setup(variant)
        sd = from_jax_params(cfg_t, params)
        assert set(sd) == set(tnx.param_shapes(cfg_t)) == set(tnx.param_logical_axes(cfg_t))
        np.testing.assert_array_equal(sd["lm_head"].numpy(), params["lm_head"].T)
        back, want_l = _leaves(to_jax_params(cfg_t, sd)), _leaves(params)
        assert back.keys() == want_l.keys()
        for k in want_l:
            np.testing.assert_array_equal(back[k], want_l[k], err_msg=k)


@pytest.mark.parametrize("loss", ["dense", "tiled"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_leaf_grad_match_jax(variant, loss):
    cfg_j, cfg_t, params = _setup(variant)
    tokens = np.random.RandomState(3).randint(0, cfg_t.vocab_size, (2, 41)).astype(np.int32)
    if loss == "dense":
        jfn = partial(jnx.loss_fn, compute_dtype=jnp.float32)
        tfn = partial(tnx.loss_fn, compute_dtype=torch.float32)
    else:
        jfn = partial(jnx.tiled_loss_fn, compute_dtype=jnp.float32, shards=4)
        tfn = partial(tnx.tiled_loss_fn, compute_dtype=torch.float32, shards=4)
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
        logits_j = jnx.apply(cfg_j, jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
                             compute_dtype=jnp.float32)
        logits_t = tnx.apply(cfg_t, {k: v.detach() for k, v in pt.items()},
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
                           loss_fn=lambda p, b: jnx.loss_fn(cfg_j, p, b,
                                                            compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    spec = tnx.model_spec(cfg_t, compute_dtype=torch.float32)
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
    # the K bias has a gradient of exactly zero in exact arithmetic (softmax
    # drops a shift of every key), so Adam turns its rounding noise into
    # lr-size steps in either package (test_torch_bloom.py): left out
    want.pop("['layers']['bk']", None)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4, err_msg=k)


V1 = {"dtype": "float32", "prefill_bucket": 8}
NEW = 12


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_v1_greedy_streams_match_jax(variant):
    cfg_j, cfg_t, params = _setup(variant)
    mesh_lib.set_mesh(None)
    fam = jinf.ModelFamily(
        cfg=cfg_j, apply_fn=partial(jnx.apply, compute_dtype=jnp.float32),
        apply_cached=partial(jnx.apply_cached, compute_dtype=jnp.float32),
        init_cache=partial(jnx.init_cache, dtype=jnp.float32),
        param_logical_axes=jnx.param_logical_axes, name="gptneox")
    eng_j = jinf.InferenceEngine(fam, jax.tree.map(jnp.asarray, params), JConfig.from_dict(V1))
    eng_t = init_inference(tnx, model_cfg=cfg_t, params=from_jax_params(cfg_t, params),
                           config=V1, device="cpu")
    prompts = np.random.RandomState(2).randint(0, cfg_t.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 13], np.int32)
    want = np.asarray(eng_j.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW))
    got = eng_t.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    logits = eng_t.forward(prompts)
    want_logits = jnx.apply(cfg_j, jax.tree.map(jnp.asarray, params), jnp.asarray(prompts),
                            compute_dtype=jnp.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)


def test_engine_v2_refuses_as_jax_does():
    """Neither package has a paged GPT-NeoX: the JAX family has no
    ``apply_paged``, which JAX's ``build_hf_engine`` refuses with this
    message (``inference/engine_v2.py:1832-1838``); the port's v2 says the
    same at build."""
    assert not hasattr(jnx, "apply_paged") and not hasattr(tnx, "apply_paged")
    cfg_j, cfg_t, params = _setup("neox")
    with pytest.raises(ValueError, match=r"family 'gptneox' has no paged decode path "
                                         r"\(apply_paged\) — use init_inference"):
        build_engine_v2(tnx, cfg_t, from_jax_params(cfg_t, params),
                        config={"dtype": "float32"}, device="cpu")


def test_initialize_refuses_a_head_dim_the_kernels_do_not_take():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    with pytest.raises(NotImplementedError, match="head dim 256 .*queue B.1"):
        check_head_dim(tnx.GPTNeoXConfig.gptj_6b(), cuda)
    check_head_dim(tnx.GPTNeoXConfig(), cuda)            # GPT-NeoX-20B: hd 96
    check_head_dim(tnx.GPTNeoXConfig.gptj_6b(), cpu)
    check_head_dim(None, cuda)                           # a spec without a family config
    # initialize asks it: GPT-J-6B's width at 1 layer, built on the CPU only
    cfg = tnx.GPTNeoXConfig.tiny(hidden_size=512, num_heads=2, **GPTJ)
    assert cfg.head_size == 256
    eng, *_ = deepspeed_tpu_torch.initialize(model=tnx.model_spec(cfg, torch.float32),
                                             config=CONFIG, device="cpu")
    assert eng.state.step == 0
