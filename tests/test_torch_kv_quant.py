"""Quantized (int8) KV cache: the PyTorch port against the JAX package.

- ``ops/quantization.py``: the port's ``kv_quantize_int8`` gives JAX's codes
  exactly and its scales within 1 ulp; dequantization and the shared group
  quantizer likewise.
- The int8 mode of op ``paged_decode_attention`` (plain version) against the
  JAX Pallas kernel in interpret mode and ``paged_decode_attention_xla``, on
  the inputs of ``tests/test_kv_quant.py``, at that test's tolerance (rtol
  2e-5, atol 2e-6): score-folded scales at one group per vector, gathered
  dequant at 4 groups, windows none / static / tensor.
- The pools: int8 codes and zero fp32 scales with JAX's keys, dtypes and
  shapes; a group that does not divide the head size is refused.
- The engine: ``kv_quant`` OFF is inert (the streams and the cache dict of
  an engine built without the block), ON gives greedy streams identical to
  the JAX ``engine_v2`` in fp32 on the same weights, on ``LlamaConfig.tiny``
  and on the hd-64 model of ``tests/test_kv_quant.py``; the engine refuses
  what the JAX engine refuses.

The CUDA kernel is held against the plain version on a GPU by
``tests/test_torch_cuda_kernels.py``.
"""

import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.comm import mesh as mesh_lib
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.engine import ModelFamily as JFamily
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_decode_attention, paged_decode_attention_xla)
from deepspeed_tpu_torch.inference import build_engine_v2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import from_jax_params
from deepspeed_tpu_torch.ops import quantization as tq
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_decode_attention_cuda, paged_decode_attention_torch,
    paged_spec_verify_attention_torch)

RAGGED = {"max_tracked_sequences": 4, "max_ragged_batch_size": 4,
          "memory_config_blocks": 40, "block_size": 16}


def config(**kw):
    return dict({"dtype": "float32", "prefill_bucket": 16, "ragged": RAGGED}, **kw)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny(max_seq_len=128)
    tcfg = tllama.LlamaConfig.tiny(max_seq_len=128)
    params = jax.tree.map(np.asarray, jllama.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params


@pytest.fixture(scope="module")
def hd64():
    """``tests/test_kv_quant.py``'s bench-shaped model (head size 64)."""
    kw = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=2, num_kv_heads=2, max_seq_len=256)
    jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
    params = jax.tree.map(np.asarray, jllama.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params


def jax_engine(jcfg, params, conf):
    mesh_lib.set_mesh(None)
    return JEngine(JFamily.from_module(jllama, jcfg), params, JConfig.from_dict(conf),
                   init_paged_cache=partial(jllama.init_paged_cache, dtype=jnp.float32),
                   apply_paged=partial(jllama.apply_paged, compute_dtype=jnp.float32))


def port_engine(tcfg, params, conf):
    return build_engine_v2(tllama, tcfg, from_jax_params(tcfg, params), config=conf,
                           device="cpu")


def prompts_for(vocab, lengths, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lengths]


# --------------------------------------------------------------------------- #
# ops/quantization.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("group", [64, 32, 16])
def test_kv_quantize_matches_jax(group):
    rs = np.random.RandomState(group)
    x = (rs.standard_normal((3, 5, 2, 64)) * rs.uniform(0.1, 4, (3, 5, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero vector: scale 1e-8 / 127
    codes, scales = tq.kv_quantize_int8(torch.from_numpy(x), group)
    jcodes, jscales = jq.kv_quantize_int8(jnp.asarray(x), group)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert scales.shape == (3, 5, 2, 64 // group)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_max_ulp(scales.numpy(), np.asarray(jscales), maxulp=1)
    back = tq.kv_dequantize_int8(codes, scales)
    want = jq.kv_dequantize_int8(jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()))
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    # symmetric rounding: error within half a step of each group's scale
    err = np.abs(back.numpy() - x)
    assert np.all(err <= np.repeat(scales.numpy(), group, axis=-1) * 0.5 + 1e-7)
    assert tq.kv_dequantize_int8(codes, scales, torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="divide"):
        tq.kv_quantize_int8(torch.from_numpy(x), 24)


def test_group_quantize_matches_jax():
    rs = np.random.RandomState(1)
    g = (rs.standard_normal((7, 32)) * 3).astype(np.float32)
    codes, scale = tq.group_quantize_int8(torch.from_numpy(g))
    jcodes, jscale = jq.group_quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_max_ulp(scale.numpy(), np.asarray(jscale), maxulp=1)
    assert codes.abs().max() == 127


# --------------------------------------------------------------------------- #
# int8 paged decode (plain version) against the JAX kernel and reference
# --------------------------------------------------------------------------- #
def int8_inputs(ng, seed=1, ctx=(13, 37, 70)):
    """``tests/test_kv_quant.py``'s int8 decode inputs."""
    rng = np.random.default_rng(seed)
    nb, nkv, bs, hd, nh, mb = 12, 2, 16, 64, 4, 5
    B = len(ctx)
    return (rng.standard_normal((B, nh, hd)).astype(np.float32),
            rng.integers(-127, 128, (nb, nkv, bs, hd)).astype(np.int8),
            rng.integers(-127, 128, (nb, nkv, bs, hd)).astype(np.int8),
            rng.integers(1, nb, (B, mb)).astype(np.int32),
            np.asarray(ctx, np.int32),
            (rng.random((nb, nkv, bs, ng)) * 0.02).astype(np.float32),
            (rng.random((nb, nkv, bs, ng)) * 0.02).astype(np.float32))


@pytest.mark.parametrize("ng", [1, 4])
@pytest.mark.parametrize("window", [None, 20, "tensor"])
def test_int8_paged_decode_matches_jax(ng, window):
    q, kp, vp, bt, cl, ks, vs = int8_inputs(ng)
    tw = torch.tensor(20, dtype=torch.int32) if window == "tensor" else window
    jw = jnp.asarray(20, jnp.int32) if window == "tensor" else window
    got = paged_decode_attention_torch(
        *map(torch.from_numpy, (q, kp, vp, bt, cl)), window=tw,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, cl)]
    kw = dict(window=jw, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    for ref in (paged_decode_attention(*args, **kw), paged_decode_attention_xla(*args, **kw)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-6)


def test_int8_paged_decode_trash_slot_and_dispatch():
    """An inactive slot (ctx 0, trash block) attends position 0 only; CPU
    tensors reach the plain version and launch nothing."""
    q, kp, vp, bt, cl, ks, vs = int8_inputs(1, seed=3, ctx=(0, 17))
    bt[0] = 0
    before = paged_decode_attention_cuda.launches
    t = list(map(torch.from_numpy, (q, kp, vp, bt, cl)))
    got = paged_decode_attention_torch(*t, k_scale=torch.from_numpy(ks),
                                       v_scale=torch.from_numpy(vs)).numpy()
    v0 = vp[0, :, 0].astype(np.float32) * vs[0, :, 0]          # [nkv, hd]
    np.testing.assert_allclose(got[0], np.repeat(v0, 2, axis=0), rtol=1e-6, atol=1e-7)
    assert paged_decode_attention_cuda.launches == before


def test_scales_must_come_together():
    q, kp, vp, bt, cl, ks, _ = int8_inputs(1)
    t = list(map(torch.from_numpy, (q, kp, vp, bt, cl)))
    ks = torch.from_numpy(ks)
    with pytest.raises(ValueError, match="together"):
        paged_decode_attention_torch(*t, k_scale=ks)
    with pytest.raises(ValueError, match="together"):
        paged_decode_attention_cuda(*t, v_scale=ks)
    with pytest.raises(ValueError, match="together"):
        paged_spec_verify_attention_torch(t[0][:, None], *t[1:], k_scale=ks)
    # the JAX kernel refuses the same call
    with pytest.raises(AssertionError, match="together"):
        paged_decode_attention(*[jnp.asarray(a.numpy()) for a in t],
                               k_scale=jnp.asarray(ks.numpy()))


# --------------------------------------------------------------------------- #
# pools
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("group", [None, 128, 8])
def test_paged_pools_match_jax_layout(tiny, group):
    jcfg, tcfg, _ = tiny
    tc = tllama.init_paged_cache(tcfg, 8, 16, torch.float32, "cpu", kv_quant_group=group)
    jc = jllama.init_paged_cache(jcfg, 8, 16, dtype=jnp.float32, kv_quant_group=group)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
        assert not tc[name].any()           # scales start at zero
    if group is not None:
        assert tc["k_scale"].shape[-1] == tcfg.head_size // min(group, tcfg.head_size)
    with pytest.raises(ValueError, match="group_size"):
        tllama.init_paged_cache(tcfg, 8, 16, device="cpu", kv_quant_group=3)


def test_int8_pool_bytes(hd64):
    """The int8 pool with its fp32 scales is 0.53x the bf16 pool at hd 64
    (one 4-byte scale per 64 one-byte codes), 0.52x at hd 128."""
    _, tcfg, _ = hd64

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for t in cache.values())

    bf16 = nbytes(tllama.init_paged_cache(tcfg, 16, 16, torch.bfloat16, "cpu"))
    int8 = nbytes(tllama.init_paged_cache(tcfg, 16, 16, torch.bfloat16, "cpu",
                                          kv_quant_group=128))
    assert int8 / bf16 == pytest.approx((64 + 4) / 128)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
def test_kv_quant_off_is_inert(tiny):
    """``kv_quant.enabled: false`` (with a group size set) builds the engine
    that has no ``kv_quant`` block: the same streams, the same cache keys and
    dtypes."""
    _, tcfg, params = tiny
    prompts = prompts_for(tcfg.vocab_size, [9, 20, 5], seed=2)
    plain = port_engine(tcfg, params, config())
    off = port_engine(tcfg, params, config(kv_quant={"enabled": False, "group_size": 8}))
    assert {k: v.dtype for k, v in off.cache.items()} == \
        {k: v.dtype for k, v in plain.cache.items()} == {"k": torch.float32,
                                                         "v": torch.float32}
    assert off.generate(prompts, max_new_tokens=6) == plain.generate(prompts, max_new_tokens=6)
    assert not off._kvq_on


@pytest.mark.parametrize("group", [128, 8])
def test_kv_quant_greedy_streams_match_jax(tiny, group):
    """Greedy streams identical to the JAX engine with ``kv_quant`` on the
    same weights in fp32 (tiny: hd 16, one group per vector at 128, two at
    8); the cache holds int8 codes and fp32 scales."""
    jcfg, tcfg, params = tiny
    conf = config(kv_quant={"enabled": True, "group_size": group})
    prompts = prompts_for(tcfg.vocab_size, [5, 14, 30, 16, 9], seed=group)
    want = jax_engine(jcfg, params, conf).generate(prompts, max_new_tokens=8)
    eng = port_engine(tcfg, params, conf)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == [list(map(int, w)) for w in want]
    assert eng.cache["k"].dtype == torch.int8 and eng.cache["k_scale"].dtype == torch.float32
    assert eng.cache["k_scale"].shape[-1] == 16 // min(group, 16)
    eng.state.debug_check()


@pytest.mark.parametrize("group", [128, 32])
def test_kv_quant_greedy_streams_match_jax_hd64(hd64, group):
    jcfg, tcfg, params = hd64
    conf = config(kv_quant={"enabled": True, "group_size": group})
    prompts = prompts_for(tcfg.vocab_size, [32, 32, 17], seed=11)
    want = jax_engine(jcfg, params, conf).generate(prompts, max_new_tokens=8)
    got = port_engine(tcfg, params, conf).generate(prompts, max_new_tokens=8)
    assert got == [list(map(int, w)) for w in want]


def test_kv_quant_apply_paged_matches_jax(hd64):
    """One prefill and one decode step of ``apply_paged`` on int8 pools:
    logits within fp32 roundoff of JAX's, and the written codes equal."""
    jcfg, tcfg, params = hd64
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (1, 32)).astype(np.int32)
    tables = np.arange(1, 6, dtype=np.int32)[None]
    jc = jllama.init_paged_cache(jcfg, 8, 16, kv_quant_group=128)
    jlo, jc = jllama.apply_paged(jcfg, params, jnp.asarray(toks), jc, jnp.asarray(tables),
                                 jnp.zeros((1,), jnp.int32), compute_dtype=jnp.float32)
    jlo2, jc = jllama.apply_paged(jcfg, params, jnp.asarray(toks[:, :1]), jc,
                                  jnp.asarray(tables), jnp.full((1,), 32, jnp.int32),
                                  compute_dtype=jnp.float32)
    with torch.device("meta"):
        model = tllama.build(tcfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           from_jax_params(tcfg, params).items()}, assign=True)
    tc = tllama.init_paged_cache(tcfg, 8, 16, torch.float32, "cpu", kv_quant_group=128)
    tlo, tc = tllama.apply_paged(tcfg, model, torch.from_numpy(toks), tc,
                                 torch.from_numpy(tables), torch.zeros(1, dtype=torch.int32))
    tlo2, tc = tllama.apply_paged(tcfg, model, torch.from_numpy(toks[:, :1]), tc,
                                  torch.from_numpy(tables), torch.full((1,), 32, dtype=torch.int32))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tlo2.numpy(), np.asarray(jlo2), rtol=1e-4, atol=1e-4)
    codes, jcodes = tc["k"].numpy(), np.asarray(jc["k"])
    # K/V vectors agree to fp32 roundoff, so a code may sit one step off at
    # a rounding boundary; nearly all are equal
    assert np.abs(codes.astype(int) - jcodes).max() <= 1
    assert (codes == jcodes).mean() > 0.999
    np.testing.assert_allclose(tc["k_scale"].numpy(), np.asarray(jc["k_scale"]), rtol=1e-5)


def test_kv_quant_config_validation(tiny):
    _, tcfg, params = tiny
    with pytest.raises(ValueError, match="dtype"):
        port_engine(tcfg, params, config(kv_quant={"enabled": True, "dtype": "fp8"}))
    with pytest.raises(ValueError, match="group_size"):
        port_engine(tcfg, params, config(kv_quant={"enabled": True, "group_size": 3}))
    # a family whose init_paged_cache has no kv_quant_group seam fails at
    # build, not at the first step
    fam = types.SimpleNamespace(
        build=tllama.build, apply_paged=tllama.apply_paged,
        init_paged_cache=lambda cfg, nb, bs, dtype, device: {})
    with pytest.raises(ValueError, match="kv_quant"):
        build_engine_v2(fam, tcfg, from_jax_params(tcfg, params),
                        config=config(kv_quant={"enabled": True}), device="cpu")
