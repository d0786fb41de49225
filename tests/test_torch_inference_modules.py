"""Inference module system: the PyTorch port against the JAX package.

For the cases of ``tests/test_inference_modules.py`` and every other default
implementation: each slot of the port's registry picks, for the same config,
the implementation the JAX registry picks (by name, through the table
below), and the callables compute the same values on the same numpy inputs
(fp32 on the CPU, 1e-5: the same arithmetic in another summation order). The
quantized linear dequantizes the same codes with the same scales, so it is
held to the JAX one at 1e-5 too. The ``moe`` slot's gating is held to JAX's
``top_k_gating``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.inference import modules as jm
from deepspeed_tpu.ops.quantization import quantize_int8 as jquantize
from deepspeed_tpu_torch.inference import modules as tm
from deepspeed_tpu_torch.ops import quantize_int8
from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, rms_norm_cuda
from deepspeed_tpu_torch.ops.quantization import dequantize_int8_cuda

# the port's attention implementation names -> the JAX registry's (the other
# slots keep the JAX names)
NAMES = {"attention": {"dense": "flash_or_xla", "paged": "paged_pallas",
                       "paged_int8kv": "paged_pallas_int8kv"}}

CASES = [
    ("attention", "AttentionConfig", {}),
    ("attention", "AttentionConfig", {"paged": True}),
    ("attention", "AttentionConfig", {"paged": True, "kv_quant": True}),
    ("attention", "AttentionConfig", {"kv_quant": True}),
    ("norm", "NormConfig", {"kind": "rms", "eps": 1e-6}),
    ("norm", "NormConfig", {"kind": "layer"}),
    ("linear", "LinearConfig", {}),
    ("linear", "LinearConfig", {"activation": "relu"}),
    ("linear", "LinearConfig", {"quant_bits": 8}),
    ("linear", "LinearConfig", {"quant_bits": 8, "activation": "gelu"}),
    ("embedding", "EmbeddingConfig", {}),
    ("unembed", "UnembedConfig", {}),
    ("unembed", "UnembedConfig", {"tile_tokens": 4}),
    ("moe", "MoEConfig", {"num_experts": 4}),
]


def _picked(reg, slot, config):
    return next(i.name for i in reg._impls[slot] if i.supports(config))


@pytest.mark.parametrize("slot,cls,kw", CASES,
                         ids=[f"{s}-{'-'.join(map(str, kw.values())) or 'default'}"
                              for s, _, kw in CASES])
def test_slot_picks_what_the_jax_registry_picks(slot, cls, kw):
    got = _picked(tm.registry, slot, getattr(tm, cls)(**kw))
    want = _picked(jm.registry, slot, getattr(jm, cls)(**kw))
    names = NAMES.get(slot, {})
    assert names.get(got, got) == want
    assert [names.get(n, n) for n in tm.registry.implementations(slot)] == \
        jm.registry.implementations(slot)


def test_config_fields_equal():
    for cls in ("ModuleConfig", "AttentionConfig", "LinearConfig", "NormConfig",
                "EmbeddingConfig", "UnembedConfig", "MoEConfig"):
        j, t = getattr(jm, cls)(), getattr(tm, cls)()
        fields = {k: v for k, v in vars(j).items() if k != "dtype"}
        assert {k: v for k, v in vars(t).items() if k != "dtype"} == fields
    assert tm.ModuleConfig().dtype == torch.bfloat16


def test_slot_selection_by_config():
    dense = tm.registry.instantiate("attention", tm.AttentionConfig(paged=False))
    paged = tm.registry.instantiate("attention", tm.AttentionConfig(paged=True))
    assert dense is not paged
    assert "paged" in tm.registry.implementations("attention")


def test_norm_slot_variants_match_jax():
    x = np.random.RandomState(0).randn(2, 4, 8).astype(np.float32)
    scale = (1 + 0.1 * np.random.RandomState(1).randn(8)).astype(np.float32)
    bias = (0.1 * np.random.RandomState(2).randn(8)).astype(np.float32)
    before = (rms_norm_cuda.launches, layer_norm_cuda.launches)
    for kind, eps, args in (("rms", 1e-6, (scale,)), ("layer", 1e-5, (scale, bias))):
        got = tm.registry.instantiate("norm", tm.NormConfig(kind=kind, eps=eps))(
            torch.from_numpy(x), *map(torch.from_numpy, args))
        want = jm.registry.instantiate("norm", jm.NormConfig(kind=kind, eps=eps))(
            jnp.asarray(x), *map(jnp.asarray, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (rms_norm_cuda.launches, layer_norm_cuda.launches) == before   # CPU tensors


@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_linear_slots_match_jax(activation, with_bias):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32) if with_bias else None
    bt = None if b is None else torch.from_numpy(b)
    bj = None if b is None else jnp.asarray(b)
    got = tm.registry.instantiate("linear", tm.LinearConfig(activation=activation))(
        torch.from_numpy(x), torch.from_numpy(w), bt)
    want = jm.registry.instantiate("linear", jm.LinearConfig(activation=activation))(
        jnp.asarray(x), jnp.asarray(w), bj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    # weight-only int8: the same codes and scales on both sides
    qw, scales = quantize_int8(torch.from_numpy(w), group_size=16)
    qw_j, scales_j = jax.jit(lambda a: jquantize(a, group_size=16))(jnp.asarray(w))
    np.testing.assert_array_equal(qw.numpy(), np.asarray(qw_j))
    launches = dequantize_int8_cuda.launches
    got_q = tm.registry.instantiate(
        "linear", tm.LinearConfig(quant_bits=8, activation=activation))(
        torch.from_numpy(x), qw, scales, bt)
    want_q = jm.registry.instantiate(
        "linear", jm.LinearConfig(quant_bits=8, activation=activation))(
        jnp.asarray(x), qw_j, jnp.asarray(scales.numpy()), bj)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5, atol=1e-5)
    assert dequantize_int8_cuda.launches == launches
    # and close to the dense linear, as the JAX package's own test holds it
    np.testing.assert_allclose(got_q.numpy(), got.numpy(), rtol=0.1, atol=0.1)


def test_quant_linear_in_bf16_equals_cast_of_fp32_dequant():
    """The op writes bf16 directly; the JAX module casts an fp32 result: the
    same values (one rounding of the same fp32 product)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 64).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    qw, scales = quantize_int8(w, group_size=64)
    got = tm.registry.instantiate("linear", tm.LinearConfig(quant_bits=8))(x, qw, scales)
    w_deq = (qw.float().view(-1, 64) * scales[:, None]).view(w.shape).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, x @ w_deq, rtol=0, atol=0)


def test_embedding_and_unembed_match_jax():
    rng = np.random.RandomState(2)
    table = rng.randn(32, 8).astype(np.float32)
    tokens = rng.randint(0, 32, (2, 7)).astype(np.int32)
    got = tm.registry.instantiate("embedding", tm.EmbeddingConfig(dtype=torch.float32))(
        torch.from_numpy(table), torch.from_numpy(tokens))
    want = jm.registry.instantiate("embedding", jm.EmbeddingConfig(dtype=jnp.float32))(
        jnp.asarray(table), jnp.asarray(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    x = rng.randn(2, 7, 8).astype(np.float32)
    head = rng.randn(8, 32).astype(np.float32)
    full = tm.registry.instantiate("unembed", tm.UnembedConfig())
    tiled = tm.registry.instantiate("unembed", tm.UnembedConfig(tile_tokens=4))
    want = jm.registry.instantiate("unembed", jm.UnembedConfig(tile_tokens=4))(
        jnp.asarray(x), jnp.asarray(head))
    for fn in (full, tiled):
        out = fn(torch.from_numpy(x), torch.from_numpy(head))
        assert out.dtype == torch.float32 and tuple(out.shape) == want.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_paged_attention_slots_bridge_the_decode_op():
    """The paged implementations are op ``paged_decode_attention``; the int8
    one refuses a call without scales."""
    from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention_torch

    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.randn(6, 2, 8, 16).astype(np.float32)) for _ in range(2))
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    ctx = torch.tensor([11, 5], dtype=torch.int32)
    paged = tm.registry.instantiate("attention", tm.AttentionConfig(paged=True))
    torch.testing.assert_close(paged(q, kp, vp, tables, ctx),
                               paged_decode_attention_torch(q, kp, vp, tables, ctx))
    quant = tm.registry.instantiate("attention",
                                    tm.AttentionConfig(paged=True, kv_quant=True))
    with pytest.raises(TypeError, match="k_scale"):
        quant(q, kp, vp, tables, ctx)
    codes = kp.clamp(-1, 1).mul(127).round().to(torch.int8)
    scale = torch.full((6, 2, 8, 1), 1 / 127.0)
    torch.testing.assert_close(
        quant(q, codes, codes, tables, ctx, k_scale=scale, v_scale=scale),
        paged_decode_attention_torch(q, codes, codes, tables, ctx, k_scale=scale,
                                     v_scale=scale))


# chip_smoke.py's MODULE_QUANT_TOL: the weight-only int8 linear against the
# dense linear, largest error of an output row as a share of that row's RMS
CHIP_LIMIT = 0.1


def _row_err(got, ref):
    diff = (got - ref).abs().amax(-1)
    return float((diff / ref.pow(2).mean(-1).sqrt()).max())


def test_quant_linear_limit_separates_sound_from_faulty():
    """The simulation behind ``chip_smoke.py``'s module-system limit, at its
    shapes (OPT-1.3B's w_up and w_down, group 128, 64 rows, fp32 on the CPU;
    bf16 reads 0.045 / 0.046): the sound quantized linears stay under half
    the limit, scales shifted by one group read over 5x the limit."""
    g = torch.Generator().manual_seed(0)
    h, i, gs = 2048, 8192, 128
    w_up = torch.randn(h, i, generator=g) * h ** -0.5
    w_down = torch.randn(i, h, generator=g) * i ** -0.5
    b_up = 0.1 * torch.randn(i, generator=g)
    x = torch.randn(64, h, generator=g)
    dense_up = tm.registry.instantiate("linear", tm.LinearConfig(activation="relu"))
    quant_up = tm.registry.instantiate("linear", tm.LinearConfig(quant_bits=8, activation="relu"))
    dense_down = tm.registry.instantiate("linear", tm.LinearConfig())
    quant_down = tm.registry.instantiate("linear", tm.LinearConfig(quant_bits=8))
    (q_up, s_up), (q_down, s_down) = quantize_int8(w_up, gs), quantize_int8(w_down, gs)
    mid, mid_q = dense_up(x, w_up, b_up), quant_up(x, q_up, s_up, b_up)
    out, out_q = dense_down(mid, w_down), quant_down(mid_q, q_down, s_down)
    sound = (_row_err(mid_q, mid), _row_err(out_q, out))
    faulty = _row_err(quant_down(mid_q, q_down, s_down.roll(1)), out)
    print(f"sound {sound}, shifted scales {faulty}")
    assert max(sound) < 0.5 * CHIP_LIMIT
    assert faulty > 5 * CHIP_LIMIT


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_slot_matches_jax(top_k):
    """The ``moe`` slot is JAX's ``top_k_gating`` at ``k = top_k``: the
    same combine weights, dispatch mask, aux loss and probabilities, with
    drops at capacity factor 0.5."""
    assert tm.registry.implementations("moe") == ["dense_dispatch"]
    logits = np.random.RandomState(top_k).randn(24, 4).astype(np.float32)
    cfg_kw = {"num_experts": 4, "top_k": top_k}
    gate_t = tm.registry.instantiate("moe", tm.MoEConfig(**cfg_kw))
    gate_j = jm.registry.instantiate("moe", jm.MoEConfig(**cfg_kw))
    got = gate_t(torch.from_numpy(logits), capacity_factor=0.5)
    want = gate_j(jnp.asarray(logits), capacity_factor=0.5)
    assert got.combine_weights.shape == want.combine_weights.shape
    assert not np.asarray(want.dispatch_mask).any(axis=(1, 2)).all()   # some dropped
    for name in ("combine_weights", "dispatch_mask", "aux_loss", "router_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_no_impl_raises():
    with pytest.raises(ValueError, match="no implementation"):
        tm.registry.instantiate("norm", tm.NormConfig(kind="group"))
    with pytest.raises(ValueError, match="no implementation"):
        tm.registry.instantiate("linear", tm.LinearConfig(quant_bits=4))
