"""The MoE layer of the PyTorch port (``deepspeed_tpu_torch/moe``) against the
JAX package's (``deepspeed_tpu/moe``), on the CPU, in fp32.

- ``compute_capacity`` over a grid of token counts, experts, k and factors.
- The compact gating (experts, gates, slots, keep, capacity, aux loss,
  probabilities) and the dense [T, E, C] view at k 1, 2 and 4, with and
  without drops, with ``norm_topk`` off and in the no-drop mode: indices
  and slots equal, values at 1e-6.
- Ties broken as ``jax.lax.top_k`` breaks them (the lower index first),
  also where every token prefers one expert (JAX's own drop test).
- ``MoELayer``, einsum and compact dispatch, plain, dropping, with raw
  gates and with the Qwen2-MoE shared expert: outputs at JAX's rtol 1e-4,
  atol 1e-5, the aux loss at rtol 1e-5, and every parameter's and the
  input's grad at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tmoe


def test_capacity_math():
    for tokens in (1, 4, 17, 64, 4096):
        for e, k, cf in ((8, 1, 1.0), (8, 2, 1.25), (4, 2, 0.5), (16, 4, 0.3), (2, 1, 0.25)):
            for mn in (0, 4):
                assert tmoe.compute_capacity(tokens, e, k, cf, mn) == \
                    jmoe.compute_capacity(tokens, e, k, cf, mn)
    assert tmoe.compute_capacity(64, 8, 2, 1.0) == 16


GATE_CASES = {   # name: (experts, k, gating kwargs)
    "k1": (4, 1, {"capacity_factor": 2.0}),
    "k1_drop": (4, 1, {"capacity_factor": 0.5}),
    "k2": (4, 2, {"capacity_factor": 2.0}),
    "k2_drop": (4, 2, {"capacity_factor": 0.5}),
    "k2_raw_gates_drop": (4, 2, {"capacity_factor": 0.5, "norm_topk": False}),
    "k2_no_drop": (4, 2, {"capacity_factor": 0.25, "drop_tokens": False}),
    "k4": (8, 4, {"capacity_factor": 2.0}),
    "k4_drop": (8, 4, {"capacity_factor": 0.5, "min_capacity": 2}),
}


def _logits(t, e, seed=0):
    return np.random.RandomState(seed).randn(t, e).astype(np.float32)


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_compact_and_dense_gating_match_jax(case):
    e, k, kw = GATE_CASES[case]
    logits = _logits(40, e)
    want = jmoe.top_k_gating_compact(jnp.asarray(logits), k, **kw)
    got = tmoe.top_k_gating_compact(torch.from_numpy(logits), k, **kw)
    assert got.capacity == want.capacity
    for name in ("topk_idx", "pos", "keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("gates", "aux_loss", "router_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    if "drop" in case and kw.get("drop_tokens", True):
        assert not np.asarray(want.keep).all()
    dj = jmoe.top_k_gating(jnp.asarray(logits), k, **kw)
    dt = tmoe.top_k_gating(torch.from_numpy(logits), k, **kw)
    np.testing.assert_array_equal(dt.dispatch_mask.numpy(), np.asarray(dj.dispatch_mask))
    np.testing.assert_allclose(dt.combine_weights.numpy(), np.asarray(dj.combine_weights),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dt.aux_loss.numpy(), np.asarray(dj.aux_loss), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_ties_break_as_lax_top_k(k):
    """Equal probabilities keep the lower expert first, as ``lax.top_k``
    orders them; the slots and drops follow from that order."""
    rows = np.array([[10.0, 0.0, 10.0, 0.0], [1.0, 1.0, 1.0, 1.0], [0.0, 2.0, 2.0, 2.0],
                     [3.0, -1.0, 3.0, 3.0]], np.float32)
    logits = np.tile(rows, (4, 1))
    want = jmoe.top_k_gating_compact(jnp.asarray(logits), k, capacity_factor=0.5,
                                     min_capacity=1)
    got = tmoe.top_k_gating_compact(torch.from_numpy(logits), k, capacity_factor=0.5,
                                    min_capacity=1)
    for name in ("topk_idx", "pos", "keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    # JAX's own drop test: every token prefers expert 0, two slots there
    one = np.tile(np.array([[10.0, 0.0]], np.float32), (16, 1))
    dt = tmoe.top_k_gating(torch.from_numpy(one), k=1, capacity_factor=0.25, min_capacity=2)
    assert int(dt.dispatch_mask.sum()) == 2 and float(dt.aux_loss) > 1.0


LAYER_CASES = {   # name: (MoELayer kwargs, shared expert width)
    "plain": ({"capacity_factor": 2.0}, 0),
    "drop": ({"capacity_factor": 0.5}, 0),
    "raw_gates_drop": ({"capacity_factor": 0.5, "norm_topk": False}, 0),
    "no_drop": ({"capacity_factor": 0.25, "drop_tokens": False}, 0),
    "shared_expert": ({"capacity_factor": 1.25}, 24),
}


def _layer_params(shared: int, seed=0):
    e, h, i = 4, 16, 32
    params = jlayer.init_moe_ffn(jax.random.PRNGKey(seed), e, h, i)
    if shared:
        ks = jax.random.split(jax.random.PRNGKey(seed + 1), 4)
        params.update({"shared_w_gate": jax.random.normal(ks[0], (h, shared)) * h ** -0.5,
                       "shared_w_up": jax.random.normal(ks[1], (h, shared)) * h ** -0.5,
                       "shared_w_down": jax.random.normal(ks[2], (shared, h)) * shared ** -0.5,
                       "shared_gate": jax.random.normal(ks[3], (h, 1)) * h ** -0.5})
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("dispatch", ["einsum", "compact"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_and_grads_match_jax(case, dispatch):
    kw, shared = LAYER_CASES[case]
    params = _layer_params(shared)
    x = np.random.RandomState(1).randn(2, 12, 16).astype(np.float32)
    r = np.random.RandomState(2).randn(2, 12, 16).astype(np.float32)
    jl = jlayer.MoELayer(4, top_k=2, dispatch=dispatch, **kw)
    tl = tlayer.MoELayer(4, top_k=2, dispatch=dispatch, **kw)

    def jloss(p, xx):
        out, aux = jl(p, xx)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (out_j, aux_j)), (gp_j, gx_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    pt = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out_t, aux_t = tl(pt, xt)
    (torch.sum(out_t * torch.from_numpy(r)) + aux_t).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-5)
    for k in params:
        want = np.asarray(gp_j[k])
        np.testing.assert_allclose(pt[k].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_dispatches_agree_and_refuse_unknown():
    params = {k: torch.from_numpy(v.copy()) for k, v in _layer_params(0).items()}
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 30, 16).astype(np.float32))
    outs = [tlayer.MoELayer(4, 2, capacity_factor=0.5, dispatch=d)(params, x)[0]
            for d in ("einsum", "compact")]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="dispatch"):
        tlayer.MoELayer(4, dispatch="ragged")
