"""Llama over the paged cache: the PyTorch port against the JAX package.

Weights are made by the JAX ``llama.init`` (plus random biases / norm
weights where a variant has them) and moved with ``from_jax_params``; one
batched prefill (a padded row and a dummy row, as the engine builds them)
and two decode steps run through JAX ``llama.apply_paged`` and the port's
``Llama``; logits and the updated pools are compared. Block 0 (the trash
block) is left out of the pool comparison: padded tokens write there in an
unspecified order in both packages.

Tolerances: fp32 1e-5 (``compute_dtype=jnp.float32`` and fp32 pools on the
JAX side: same arithmetic, other summation order); bf16 5e-2 absolute on
logits of order 1 (both round each matmul, norm and attention output to bf16,
at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import from_jax_params

NUM_BLOCKS, BS, MAX_BLOCKS = 12, 8, 4

VARIANTS = {
    "base": {},
    "bias": {"attention_bias": True},
    "qk_norm": {"qk_norm": True},
    "tied": {"tie_embeddings": True},
}


def _params(kw, seed=0):
    cfg_kw = dict(max_seq_len=MAX_BLOCKS * BS, **kw)
    jcfg = jllama.LlamaConfig.tiny(**cfg_kw)
    tcfg = tllama.LlamaConfig.tiny(**cfg_kw)
    params = jax.tree.map(np.asarray, jllama.init(jcfg, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm", "attn_norm", "mlp_norm"):
        if name in params["layers"]:
            leaf = params["layers"][name]
            base = 1.0 if "norm" in name else 0.0
            params["layers"][name] = (base + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
    return jcfg, tcfg, params


def _run_both(kw, dtype):
    jcfg, tcfg, params = _params(kw)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    model = tllama.build(tcfg)
    state = {k: v.to(tdt) for k, v in from_jax_params(tcfg, params).items()}
    model.load_state_dict(state, strict=True, assign=True)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)

    rs = np.random.RandomState(1)
    lengths = np.array([11, 3, 0, 0], np.int32)   # two prompts, two dummy rows
    pad_t = 16
    tokens = np.zeros((4, pad_t), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rs.randint(0, tcfg.vocab_size, n)
    tables = np.zeros((4, MAX_BLOCKS), np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :2] = [7, 1]
    valid = np.arange(pad_t)[None, :] < lengths[:, None]

    jcache = jllama.init_paged_cache(jcfg, NUM_BLOCKS, BS, dtype=jdt)
    tcache = tllama.init_paged_cache(tcfg, NUM_BLOCKS, BS, dtype=tdt, device="cpu")
    steps = [(tokens, np.zeros(4, np.int32), valid)]
    ctx = lengths.copy()
    for s in range(2):
        tok = rs.randint(0, tcfg.vocab_size, (4, 1)).astype(np.int32)
        steps.append((tok, ctx.copy(), (lengths > 0)[:, None]))
        ctx = ctx + (lengths > 0)
    japply = jax.jit(lambda p, tok, cache, tab, c, v: jllama.apply_paged(
        jcfg, p, tok, cache, tab, c, valid=v, compute_dtype=jdt))
    out = []
    for tok, c, v in steps:
        jl, jcache = japply(jparams, jnp.asarray(tok), jcache, jnp.asarray(tables),
                            jnp.asarray(c), jnp.asarray(v))
        tl, tcache = tllama.apply_paged(tcfg, model, torch.from_numpy(tok), tcache,
                                        torch.from_numpy(tables), torch.from_numpy(c),
                                        valid=torch.from_numpy(v))
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        out.append((np.asarray(jl), tl.numpy()))
    pools = [(np.asarray(jcache[k].astype(jnp.float32))[:, 1:],
              tcache[k].float().numpy()[:, 1:]) for k in ("k", "v")]
    return lengths, out, pools


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_paged_matches_jax_fp32(variant):
    lengths, out, pools = _run_both(VARIANTS[variant], "float32")
    live = lengths > 0
    for j, t in out:
        # dummy rows compute on the trash block in both packages: compare
        # the real rows (all positions of the padded prompt rows)
        np.testing.assert_allclose(t[live], j[live], rtol=1e-5, atol=1e-5)
    for j, t in pools:
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_apply_paged_matches_jax_bf16():
    lengths, out, pools = _run_both({}, "bfloat16")
    live = lengths > 0
    for j, t in out:
        np.testing.assert_allclose(t[live], j[live], rtol=5e-2, atol=5e-2)
    for j, t in pools:
        np.testing.assert_allclose(t, j, rtol=5e-2, atol=5e-2)


def test_from_jax_params_layout_and_checks():
    """Matrices land transposed into nn.Linear layout, layer leaves
    unstacked; a tree that does not match the config is refused."""
    _, tcfg, params = _params({})
    sd = from_jax_params(tcfg, params)
    np.testing.assert_array_equal(sd["layers.1.wq"].numpy(), params["layers"]["wq"][1].T)
    np.testing.assert_array_equal(sd["lm_head"].numpy(), params["lm_head"].T)
    np.testing.assert_array_equal(sd["embed"].numpy(), params["embed"])
    assert set(sd) == set(tllama.param_shapes(tcfg))
    bad = dict(params, layers=dict(params["layers"]))
    del bad["layers"]["w_up"]
    with pytest.raises(ValueError, match="w_up"):
        from_jax_params(tcfg, bad)


def test_init_from_generator_is_seeded_and_scaled():
    cfg = tllama.LlamaConfig.tiny()
    a = tllama.init(cfg, torch.Generator().manual_seed(3))
    b = tllama.init(cfg, torch.Generator().manual_seed(3))
    assert set(a) == set(tllama.param_shapes(cfg))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["layers.0.w_down"]
    assert abs(float(w.std()) - cfg.intermediate_size ** -0.5) < 0.01
    assert torch.all(a["final_norm"] == 1)
