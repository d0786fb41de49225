"""Llama served in fp16: the port's engines against the JAX package's, on the
CPU, and the build checks that let fp16 onto the card.

- Engine v2 (``dtype: float16``: fp16 weights, fp16 paged pools, the plain
  paged decode and, with ``fused_verify``, the plain fused verify; with
  ``kv_quant``, int8 pools read by fp16 q) and v1 (``init_inference``,
  fp16 dense cache) against the JAX engines built on the same weights with
  fp16 ``apply_paged`` / ``init_paged_cache`` (v2) and fp16 ``apply`` /
  ``apply_cached`` / ``init_cache`` (v1) partials: greedy streams equal, or
  parting only at a near-tie. The rule, as the card's smoke holds v1 to v2:
  at the first token where two streams part, the fp32 forward of the
  shared prefix (the same weights) gives the two tokens' logits; their
  margin over the fp32 logits' RMS must lie within twice the fp16 forward's
  own error there (the largest |fp16 logit - fp32 logit| over that RMS).
  Beyond it one side would be wrong. The streams after a parting are not
  compared (they continue from different tokens).
- In fp32 the same streams stay exactly equal, as ``tests/_v2_pair.py``'s
  tests hold them.
- ``check_compute_dtype`` and both engines' ``_check`` take fp16 on a CUDA
  device (the device check monkeypatched as
  ``tests/test_torch_isolation.py`` does); v2 still refuses fp32 with the
  paged kernel's queue-B gap in its message.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.comm import mesh as mesh_lib
from deepspeed_tpu.inference import engine as jinf
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.engine import ModelFamily as JFamily
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import build_engine_v2
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params
from deepspeed_tpu_torch.runtime.engine import check_compute_dtype

JDT = {"float16": jnp.float16, "float32": jnp.float32}
RAGGED = {"max_tracked_sequences": 4, "max_ragged_batch_size": 4,
          "memory_config_blocks": 64, "block_size": 8}
V2_MODES = {
    "plain": {},
    "kv_quant": {"kv_quant": {"enabled": True, "group_size": 32}},
    "spec_fused": {"speculative": {"enabled": True, "fused_verify": True}},
}
NEW_TOKENS = 12
NEAR_TIE = 2.0   # a parting's fp32 margin within this many fp16 errors


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig.tiny(max_seq_len=128)
    tcfg = tl.LlamaConfig.tiny(max_seq_len=128)
    params = jax.tree.map(np.asarray, jl.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(tcfg, params)


def _prompts(vocab, lengths, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lengths]


def _v2_conf(dtype, mode):
    return dict({"dtype": dtype, "prefill_bucket": 16, "ragged": dict(RAGGED)},
                **V2_MODES[mode])


def _v2_pair(weights, dtype, mode):
    jcfg, tcfg, params, sd = weights
    conf = _v2_conf(dtype, mode)
    mesh_lib.set_mesh(None)
    jeng = JEngine(JFamily.from_module(jl, jcfg), params, JConfig.from_dict(conf),
                   init_paged_cache=partial(jl.init_paged_cache, dtype=JDT[dtype]),
                   apply_paged=partial(jl.apply_paged, compute_dtype=JDT[dtype]))
    teng = build_engine_v2(tl, tcfg, sd, config=conf, device="cpu")
    return jeng, teng


def parting_verdict(tcfg, sd, prefix, tok_a, tok_b) -> tuple:
    """(fp32 margin of tok_a over tok_b, fp16 error), both over the fp32
    logits' RMS at the last position of ``prefix``."""
    tokens = torch.as_tensor(np.asarray(prefix, np.int64)[None])
    with torch.inference_mode():
        z32 = tl.apply(tcfg, sd, tokens, compute_dtype=torch.float32)[0, -1].float()
        z16 = tl.apply(tcfg, sd, tokens, compute_dtype=torch.float16)[0, -1].float()
    rms = float(z32.pow(2).mean().sqrt())
    return float(z32[tok_a] - z32[tok_b]) / rms, float((z16 - z32).abs().max()) / rms


def assert_streams_agree(tcfg, sd, prompts, got, want):
    """Equal streams, or streams that part only at a near-tie (module
    docstring); returns how many rows parted."""
    parted = 0
    for prompt, a, b in zip(prompts, got, want):
        a, b = [int(t) for t in a], [int(t) for t in b]
        assert len(a) == len(b)
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if not diff:
            continue
        i = diff[0]
        margin, noise = parting_verdict(tcfg, sd, list(prompt) + a[:i], a[i], b[i])
        assert abs(margin) <= NEAR_TIE * noise, \
            f"streams part at {i} on a margin {margin:+.4f} beyond {NEAR_TIE} x {noise:.4f}"
        parted += 1
    return parted


@pytest.mark.parametrize("mode", sorted(V2_MODES))
def test_fp16_v2_streams_match_jax(weights, mode):
    """v2 in fp16 (plain, int8 pools, spec + fused verify) against JAX's v2
    in fp16; at most one row of four may part, at a near-tie."""
    jcfg, tcfg, params, sd = weights
    jeng, teng = _v2_pair(weights, "float16", mode)
    prompts = _prompts(tcfg.vocab_size, [9, 5, 14, 7])
    want = jeng.generate(prompts, max_new_tokens=NEW_TOKENS)
    got = teng.generate(prompts, max_new_tokens=NEW_TOKENS)
    assert teng.params["embed"].dtype == torch.float16
    assert assert_streams_agree(tcfg, sd, prompts, got, want) <= 1


@pytest.mark.parametrize("mode", ["plain", "kv_quant"])
def test_fp32_v2_streams_stay_equal(weights, mode):
    jcfg, tcfg, params, sd = weights
    jeng, teng = _v2_pair(weights, "float32", mode)
    prompts = _prompts(tcfg.vocab_size, [9, 5, 14, 7], seed=1)
    want = jeng.generate(prompts, max_new_tokens=NEW_TOKENS)
    got = teng.generate(prompts, max_new_tokens=NEW_TOKENS)
    assert [[int(t) for t in s] for s in got] == [[int(t) for t in s] for s in want]


def _v1_pair(weights, dtype):
    jcfg, tcfg, params, sd = weights
    mesh_lib.set_mesh(None)
    fam = jinf.ModelFamily(
        cfg=jcfg, apply_fn=partial(jl.apply, compute_dtype=JDT[dtype]),
        apply_cached=partial(jl.apply_cached, compute_dtype=JDT[dtype]),
        init_cache=partial(jl.init_cache, dtype=JDT[dtype]),
        param_logical_axes=jl.param_logical_axes, name=jl.__name__)
    conf = {"dtype": dtype, "prefill_bucket": 8}
    jeng = jinf.InferenceEngine(fam, jax.tree.map(jnp.asarray, params),
                                jinf.InferenceConfig.from_dict(conf))
    teng = init_inference(tl, model_cfg=tcfg, params=sd, config=conf, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_v1_streams_match_jax(weights, dtype):
    """v1 in fp16 against JAX's v1 in fp16 (near-ties allowed, at most one
    row of three); in fp32 equal."""
    jcfg, tcfg, params, sd = weights
    jeng, teng = _v1_pair(weights, dtype)
    rs = np.random.RandomState(2)
    prompts = rs.randint(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    lengths = [9, 5, 7]
    want = np.asarray(jeng.generate(prompts, prompt_lengths=lengths,
                                    max_new_tokens=NEW_TOKENS))
    got = teng.generate(prompts, prompt_lengths=lengths, max_new_tokens=NEW_TOKENS)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    assert teng.params["embed"].dtype == torch.float16
    rows = [p[:n] for p, n in zip(prompts, lengths)]
    assert assert_streams_agree(tcfg, sd, rows, got, want) <= 1


def test_near_tie_rule_refuses_a_wrong_token(weights):
    """The rule is not vacuous: a stream whose token is swapped for the fp32
    forward's least likely one parts far beyond the fp16 error."""
    jcfg, tcfg, params, sd = weights
    prompt = _prompts(tcfg.vocab_size, [9], seed=3)[0]
    tokens = torch.as_tensor(prompt[None].astype(np.int64))
    z = tl.apply(tcfg, sd, tokens, compute_dtype=torch.float32)[0, -1]
    best, worst = int(z.argmax()), int(z.argmin())
    with pytest.raises(AssertionError, match="beyond"):
        assert_streams_agree(tcfg, sd, [prompt], [[worst]], [[best]])
    margin, noise = parting_verdict(tcfg, sd, list(prompt), best, worst)
    assert margin > 0 and noise > 0


# --------------------------------------------------------------------------- #
# the build checks: fp16 onto the card
# --------------------------------------------------------------------------- #
def test_fp16_compute_dtype_passes_on_cuda():
    for dt in (torch.float16, torch.bfloat16, torch.float32, None):
        check_compute_dtype(dt, torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="float64"):
        check_compute_dtype(torch.float64, torch.device("cuda"))


@pytest.mark.parametrize("dtype,ok", [("float16", True), ("bfloat16", True),
                                      ("float32", False)])
def test_v2_check_on_a_cuda_device(weights, dtype, ok):
    """Engine v2's build check on a CUDA device: bf16 and fp16 pass (the
    paged kernel takes both), fp32 is refused naming the kernel's fp32-pool
    gap (ROADMAP queue B.2)."""
    jcfg, tcfg, params, sd = weights
    eng = build_engine_v2(tl, tcfg, sd, config=_v2_conf(dtype, "plain"), device="cpu")
    eng.device = torch.device("cuda")
    if ok:
        eng._check()
    else:
        with pytest.raises(ValueError, match="fp32 pools.*B.2"):
            eng._check()


def test_v1_check_on_a_cuda_device(weights):
    jcfg, tcfg, params, sd = weights
    eng = init_inference(tl, model_cfg=tcfg, params=sd, config={"dtype": "float16"},
                         device="cpu")
    eng.device = torch.device("cuda")
    eng._check()


def test_initialize_takes_an_fp16_config_on_cuda(monkeypatch):
    """``initialize`` with DeepSpeed's fp16 block and an fp16 Llama passes
    its build checks on a CUDA device (monkeypatched: there is no card
    here, so the engine itself is not built)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime import engine as rt

    seen = {}

    class Stop(Exception):
        pass

    def stop(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(rt, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(rt, "DeepSpeedTPUEngine", stop)
    cfg = tl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=2, num_kv_heads=1, max_seq_len=64)   # head dim 32
    with pytest.raises(Stop):
        deepspeed_tpu_torch.initialize(
            model=tl.model_spec(cfg, compute_dtype=torch.float16),
            config={"train_batch_size": 2, "fp16": {
                "enabled": True, "loss_scale": 0, "initial_scale_power": 16,
                "loss_scale_window": 1000, "hysteresis": 2, "min_loss_scale": 1}})
    assert seen["device"].type == "cuda"
    assert seen["config"].fp16.enabled
