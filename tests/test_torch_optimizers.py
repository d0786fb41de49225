"""The port's optimizers against the JAX package's, on the CPU.

Every name of the JAX ``_FACTORY`` (aliases included) runs 10 steps on a
tiny Llama's params, the JAX tree on one side and the port's unstacked,
transposed leaves (``models/convert.py``) on the other, with the same grads
each step; the port's update gets the layout of its leaves in the JAX tree
(``ops/optimizers.py`` ``Layout.for_model``), so that LAMB's norms, Muon's
orthogonalization and scale, and the 1-bit scale are taken over the JAX
leaf. Tolerance: the JAX package's own ``tests/test_optimizers.py``, rtol
1e-5 and atol 1e-6, on every param and every state tensor but the 1-bit
error feedback, held to 1e-5 of its leaf's largest value (it accumulates
each step's fp32 rounding of the leaf mean, whose sum order is XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params
from deepspeed_tpu_torch.ops import optimizers as topt

LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=32, rope_theta=10000.0)
TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 10

CASES = [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("fusedadam", {"learning_rate": 3e-3, "betas": [0.8, 0.95], "bias_correction": False}),
    ("lion", {"lr": 1e-3, "weight_decay": 0.1}),
    ("fusedlion", {"lr": 1e-3, "betas": [0.95, 0.98]}),
    ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("fusedlamb", {"lr": 1e-2, "min_trust": 0.5, "max_trust": 2.0}),
    ("adagrad", {"lr": 1e-2, "weight_decay": 0.01}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
    ("muon", {"lr": 0.02, "weight_decay": 0.01}),
    ("muon", {"lr": 0.02, "momentum": 0.9, "ns_steps": 3}),
    ("onebitadam", {"lr": 1e-3, "freeze_step": 3, "weight_decay": 0.01}),
    ("onebitadam", {"lr": 1e-3, "freeze_step": 3, "weight_decay": 0.01,
                    "adam_w_mode": False}),
    ("onebitlamb", {"lr": 1e-2, "freeze_step": 3, "weight_decay": 0.01}),
    ("zerooneadam", {"lr": 1e-3, "var_freeze_step": 4, "var_update_scaler": 2}),
    ("01adam", {"lr": 1e-3, "var_freeze_step": 2, "weight_decay": 0.01, "adamw": False}),
]


@pytest.fixture(scope="module")
def tree():
    cfg_j, cfg_t = jl.LlamaConfig(**LLAMA, use_pipeline=False), tl.LlamaConfig(**LLAMA)
    params = jax.tree.map(np.asarray, jl.init(cfg_j, jax.random.PRNGKey(0)))
    rs = np.random.RandomState(7)
    grads = [jax.tree.map(lambda p: rs.randn(*p.shape).astype(np.float32), params)
             for _ in range(STEPS)]
    return cfg_t, params, grads


def _port(cfg_t, tree_np):
    return {k: v.float() for k, v in from_jax_params(cfg_t, tree_np).items()}


def run_both(cfg_t, params, grads, name, kw, lr_scale=lambda i: 1.0):
    """10 steps of ``name`` in both packages; (JAX params and state, port
    params and state)."""
    opt_j, opt_t = jopt.get_optimizer(name, **kw), topt.get_optimizer(name, **kw)
    pj = jax.tree.map(jnp.asarray, params)
    pt = _port(cfg_t, params)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    layout = topt.Layout.for_model(cfg_t, pt)
    for i, g in enumerate(grads):
        pj, sj = opt_j.update(pj, jax.tree.map(jnp.asarray, g), sj,
                              lr_scale=jnp.float32(lr_scale(i)))
        pt, st = opt_t.update(pt, _port(cfg_t, g), st, lr_scale=lr_scale(i), layout=layout)
    return opt_j, opt_t, pj, sj, pt, st


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def assert_matches(cfg_t, pj, sj, pt, st):
    want = _leaves(pj)
    got = _leaves(to_jax_params(cfg_t, pt))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=f"param {k}")
    # every state tensor, named by its JAX state path
    want_s = _leaves(sj)
    got_s = {}
    for path, tensors in topt.state_tensors(st).items():
        for k, v in _leaves(to_jax_params(cfg_t, tensors)).items():
            got_s["." + ".".join(path.split(".")) + k if path else k] = v
    for path, v in topt.state_scalars(st).items():
        got_s["." + path] = np.asarray(v)
    assert set(got_s) == set(want_s), sorted(set(got_s) ^ set(want_s))
    for k in want_s:
        if k.startswith(".error"):
            # the error feedback carries each step's fp32 rounding of the
            # leaf mean |g + e|, whose sum order XLA's reduction sets: held to
            # 1e-5 of the leaf's largest error
            w = np.asarray(want_s[k])
            np.testing.assert_allclose(got_s[k], w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-6,
                                       err_msg=f"state {k}")
            continue
        np.testing.assert_allclose(got_s[k], want_s[k], **TOL, err_msg=f"state {k}")


@pytest.mark.parametrize("name,kw", CASES)
def test_ten_steps_match_jax(tree, name, kw):
    cfg_t, params, grads = tree
    opt_j, opt_t, pj, sj, pt, st = run_both(cfg_t, params, grads, name, kw)
    assert opt_t.name == opt_j.name and opt_t.hyperparams == {
        k: tuple(v) if isinstance(v, list) else v for k, v in opt_j.hyperparams.items()}
    assert_matches(cfg_t, pj, sj, pt, st)


def test_adamw_foreach_at_lr_scale(tree):
    """The multi-tensor AdamW under a moving ``lr_scale`` (a schedule)."""
    cfg_t, params, grads = tree
    _, _, pj, sj, pt, st = run_both(cfg_t, params, grads, "adamw",
                                    {"lr": 1e-2, "weight_decay": 0.1},
                                    lr_scale=lambda i: 0.3 + 0.07 * i)
    assert_matches(cfg_t, pj, sj, pt, st)


def test_adamw_chunks_bound_the_temporaries(tree, monkeypatch):
    """Chunks of a few leaves compute what one chunk of all does, bit for
    bit, and no chunk's temporaries exceed the bound (a leaf alone aside)."""
    cfg_t, params, grads = tree
    outs = []
    for chunk in (64 << 20, 20000):
        monkeypatch.setattr(topt, "CHUNK_BYTES", chunk)
        opt = topt.get_optimizer("adamw", lr=1e-2, weight_decay=0.1)
        pt = _port(cfg_t, params)
        st = opt.init(pt)
        for g in grads[:3]:
            pt, st = opt.update(pt, _port(cfg_t, g), st)
        outs.append(pt)
        runs = list(topt._chunks(list(pt), pt))
        assert sum(map(len, runs)) == len(pt)
        for run in runs:
            assert len(run) == 1 or sum(pt[n].numel() * 8 for n in run) <= chunk
    assert len(list(topt._chunks(list(outs[1]), outs[1]))) > 3
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_muon_orthogonalizes_stacked_norms_together(tree):
    """JAX's ``_is_matrix`` counts a stacked norm [L, h] as a matrix, so its
    L layers are orthogonalized together; a 1-D leaf of the JAX tree
    (``final_norm``) falls back to AdamW. The port does the same: the
    layers' rows of one Newton-Schulz result, and the scale of the
    ``[in, out]`` orientation (``w_gate`` [h, i] in JAX: 1, not
    sqrt(i / h))."""
    cfg_t, params, grads = tree
    opt = topt.get_optimizer("muon", lr=0.02)
    pt = _port(cfg_t, params)
    st = opt.init(pt)
    before = {k: v.clone() for k, v in pt.items()}
    g = _port(cfg_t, grads[0])
    pt, st = opt.update(pt, g, st, layout=topt.Layout.for_model(cfg_t, pt))
    L = cfg_t.num_layers
    stacked = torch.stack([g[f"layers.{l}.attn_norm"] for l in range(L)])
    o = topt._newton_schulz(stacked)
    for l in range(L):
        torch.testing.assert_close(before[f"layers.{l}.attn_norm"] - pt[f"layers.{l}.attn_norm"],
                                   0.02 * o[l], rtol=1e-5, atol=1e-7)
    o = topt._newton_schulz(g["layers.0.w_gate"].T).T
    torch.testing.assert_close(before["layers.0.w_gate"] - pt["layers.0.w_gate"], 0.02 * o,
                               rtol=1e-5, atol=1e-7)
    # final_norm [h]: the AdamW fallback's first step, lr 3e-4 * sign-like
    d = before["final_norm"] - pt["final_norm"]
    torch.testing.assert_close(d.abs(), torch.full_like(d, 3e-4), rtol=1e-3, atol=0)
    # without the layout every port leaf is its own JAX leaf: the norms
    # would be vectors (AdamW) and w_gate's scale sqrt(i / h)
    opt2 = topt.get_optimizer("muon", lr=0.02)
    p2 = _port(cfg_t, params)
    p2, _ = opt2.update(p2, g, opt2.init(p2))
    assert not torch.allclose(p2["layers.0.attn_norm"], pt["layers.0.attn_norm"])
    scale = (cfg_t.intermediate_size / cfg_t.hidden_size) ** 0.5
    torch.testing.assert_close(before["layers.0.w_gate"] - p2["layers.0.w_gate"],
                               0.02 * scale * o, rtol=1e-5, atol=1e-7)


def test_get_optimizer_builds_every_factory_name():
    jopt._register_onebit()
    topt._register_onebit()
    assert sorted(topt._FACTORY) == sorted(jopt._FACTORY)
    assert not hasattr(topt, "_NOT_PORTED")
    for name in jopt._FACTORY:
        assert topt.get_optimizer(name).name == jopt.get_optimizer(name).name, name
    assert topt.get_optimizer("Fused_Lamb", learning_rate=0.5).hyperparams["lr"] == 0.5


def test_get_optimizer_errors_as_in_jax():
    with pytest.raises(ValueError, match="unknown optimizer"):
        jopt.get_optimizer("adafactor")
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("adafactor")
    # unsupported params are dropped with a warning in both
    assert topt.get_optimizer("sgd", lr=0.1, betas=[0.9, 0.99]).hyperparams == \
        jopt.get_optimizer("sgd", lr=0.1, betas=[0.9, 0.99]).hyperparams
