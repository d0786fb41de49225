"""The tiled logits + loss head of the PyTorch port
(``deepspeed_tpu_torch/sequence/tiled.py``) against the JAX package's
(``deepspeed_tpu/sequence/tiled.py``), on the CPU.

- ``sequence_tiled_compute``, ``tiled_mlp`` and ``tiled_fused_logits_loss``
  (with a vocabulary bias, ``logit_soft_cap``, ignored labels, both
  reductions) against JAX's: values and grads, 1e-5 / 1e-4 (the port's
  unembedding is JAX's transposed, ``[V, H]``). The shims give the same.
- Each family's ``tiled_loss_fn`` (Llama, GPT, BLOOM) against its dense
  ``loss_fn`` and against JAX's ``tiled_loss_fn``: loss 1e-5, every leaf
  grad 1e-4 relative + 1e-5 absolute (JAX ``tests/test_tiled_loss_engine.py``'s
  limits).
- The engine: ``sequence.tiled_loss`` off is inert (a state dict after 3
  steps equals the one without the block, bit for bit); on, the port's
  trajectory against the JAX engine's with ``tiled_loss`` on (losses 1e-5,
  params 2e-4).
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
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu.sequence import tiled as jtiled
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params
from deepspeed_tpu_torch.sequence import tiled as ttiled

B, S, H, V = 2, 16, 8, 64


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_()


def test_sequence_tiled_compute_and_tiled_mlp_equal_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(B, 32, H).astype(np.float32)
    out_j = jtiled.sequence_tiled_compute(lambda t: jax.nn.gelu(t) * 2.0, x, shards=4)
    out_t = ttiled.sequence_tiled_compute(
        lambda t: torch.nn.functional.gelu(t, approximate="tanh") * 2.0, _t(x), shards=4)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-6)
    w1, w2 = (0.1 * rs.randn(H, 32)).astype(np.float32), (0.1 * rs.randn(32, H)).astype(np.float32)

    def mlp_j(p, t):
        return jax.nn.gelu(t @ p[0]) @ p[1]

    def mlp_t(p, t):
        return torch.nn.functional.gelu(t @ p[0], approximate="tanh") @ p[1]

    g_j = jax.grad(lambda p, x: jtiled.tiled_mlp(mlp_j, p, x, shards=4).sum(),
                   argnums=(0, 1))((w1, w2), x)
    pt, xt = (_t(w1), _t(w2)), _t(x)
    for shards, remat in ((4, True), (4, False), (1, True)):
        out = ttiled.tiled_mlp(mlp_t, pt, xt, shards=shards, remat=remat)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(mlp_j((w1, w2), x)),
                                   rtol=1e-5, atol=1e-6)
        g_t = torch.autograd.grad(out.sum(), (*pt, xt))
        for a, b in zip(g_t, list(g_j[0]) + [g_j[1]]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    shim = ttiled.TiledMLP(mlp_t, pt, shards=4)
    assert torch.equal(shim(xt), ttiled.tiled_mlp(mlp_t, pt, xt, shards=4))
    with pytest.raises(ValueError, match="divisible"):
        ttiled.sequence_tiled_compute(lambda t: t, xt, shards=5)


@pytest.mark.parametrize("variant", ["plain", "bias", "soft_cap", "sum"])
def test_tiled_fused_logits_loss_equals_jax(variant):
    rs = np.random.RandomState(1)
    hidden = rs.randn(B, S, H).astype(np.float32)
    w = (0.2 * rs.randn(H, V)).astype(np.float32)            # JAX layout [H, V]
    bias = (0.1 * rs.randn(V)).astype(np.float32)
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    kw = {"bias": {"bias": True}, "soft_cap": {"logit_soft_cap": 2.0},
          "sum": {"reduction": "sum"}}.get(variant, {})

    def jfn(h, w, b):
        extra = dict(kw)
        if extra.pop("bias", False):
            extra["bias"] = b
        return jtiled.tiled_fused_logits_loss(h, w, jnp.asarray(labels), shards=4, **extra)

    def tfn(h, w, b):
        extra = dict(kw)
        if extra.pop("bias", False):
            extra["bias"] = b
        return ttiled.tiled_fused_logits_loss(h, w.t(), torch.from_numpy(labels), shards=4,
                                              **extra)

    val_j, g_j = jax.value_and_grad(jfn, argnums=(0, 1, 2))(hidden, w, bias)
    ht, wt, bt = _t(hidden), _t(w), _t(bias)
    val_t = tfn(ht, wt, bt)
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    g_t = torch.autograd.grad(val_t, (ht, wt, bt), allow_unused=True)
    for a, b in zip(g_t, g_j):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    shim = ttiled.TiledFusedLogitsLoss(wt.t(), shards=4)
    if variant == "plain":
        assert torch.equal(shim(ht, torch.from_numpy(labels)), val_t)


FAMILIES = {
    "llama": (jl, tl, jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()),
    "llama_tied": (jl, tl, jl.LlamaConfig.tiny(tie_embeddings=True),
                   tl.LlamaConfig.tiny(tie_embeddings=True)),
    "gpt": (jgpt, tgpt, jgpt.GPTConfig.tiny(), tgpt.GPTConfig.tiny()),
    "bloom": (jbloom, tbloom, jbloom.BloomConfig.tiny(), tbloom.BloomConfig.tiny()),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_tiled_loss_fn_equals_dense_and_jax(family):
    jmod, tmod, cfg_j, cfg_t = FAMILIES[family]
    params_j = jmod.init(cfg_j, jax.random.PRNGKey(0))
    params_np = from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j))
    tokens = np.random.RandomState(3).randint(0, cfg_t.vocab_size, (2, 17)).astype(np.int32)

    def port(fn):
        params = {k: v.clone().requires_grad_() for k, v in params_np.items()}
        loss, _ = fn(cfg_t, params, {"tokens": torch.from_numpy(tokens)},
                     compute_dtype=torch.float32)
        loss.backward()
        return float(loss), _leaves(to_jax_params(cfg_t, {k: v.grad for k, v in params.items()}))

    loss_d, g_d = port(tmod.loss_fn)
    loss_t, g_t = port(lambda *a, **k: tmod.tiled_loss_fn(*a, shards=4, **k))
    jbatch = {"tokens": jnp.asarray(tokens)}
    loss_j, grads_j = jax.value_and_grad(lambda p: jmod.tiled_loss_fn(
        cfg_j, p, jbatch, compute_dtype=jnp.float32, shards=4)[0])(params_j)
    g_j = _leaves(grads_j)
    np.testing.assert_allclose(loss_t, loss_d, rtol=1e-5)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    assert set(g_t) == set(g_j) == set(g_d)
    for name in g_j:
        np.testing.assert_allclose(g_t[name], g_d[name], rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g_t[name], g_j[name], rtol=1e-4, atol=1e-5, err_msg=name)


CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 0.5,
          "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
          "steps_per_print": 0}


def test_engine_tiled_loss_off_is_inert_and_on_matches_jax_engine():
    cfg_j, cfg_t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    params_j = jl.init(cfg_j, jax.random.PRNGKey(0))
    params_t = from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j))
    rs = np.random.RandomState(0)
    batches = [{"tokens": rs.randint(0, cfg_t.vocab_size, (4, 17)).astype(np.int32)}
               for _ in range(3)]

    def port(conf):
        spec = tl.model_spec(cfg_t, compute_dtype=torch.float32)
        spec.params, spec.init_fn = params_t, None
        eng, *_ = deepspeed_tpu_torch.initialize(model=spec, config=conf, device="cpu")
        return eng, [float(eng.train_batch(b).loss) for b in batches]

    base, l_base = port(CONFIG)
    off, l_off = port(dict(CONFIG, sequence={"tiled_loss": False}))
    assert l_off == l_base
    for k, p in base.state.params.items():
        assert torch.equal(p, off.state.params[k]), k
    on, l_on = port(dict(CONFIG, sequence={"tiled_loss": True, "tiled_loss_shards": 4}))
    np.testing.assert_allclose(l_on, l_base, rtol=1e-5)
    spec_j = jl.model_spec(cfg_j, compute_dtype=jnp.float32)
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params_j, loss_fn=spec_j.loss_fn,
                           tiled_loss_fn=spec_j.tiled_loss_fn),
        config=dict(CONFIG, sequence={"tiled_loss": True, "tiled_loss_shards": 4}),
        devices=jax.devices()[:1])
    l_j = [float(eng_j.train_batch(b).loss) for b in batches]
    np.testing.assert_allclose(l_on, l_j, rtol=1e-5)
    got = _leaves(to_jax_params(cfg_t, {k: v.detach() for k, v in on.state.params.items()}))
    for name, want in _leaves(eng_j.state.params).items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=2e-4, err_msg=name)
