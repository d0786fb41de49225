"""The v1 inference engine of the PyTorch port
(``deepspeed_tpu_torch/inference/engine.py``: ``init_inference``, the dense
KV cache, weight-only int8 / packed int4 / fp8) against the JAX package's
(``deepspeed_tpu/inference/engine.py``), on the CPU, in fp32.

- Each family's ``apply_cached`` (Llama, GPT, BLOOM) against JAX's: a
  ragged prefill then decode steps, logits and the written cache 1e-5; and
  the port's cached logits equal to its full forward at those positions
  (1e-5).
- ``generate``: greedy streams equal to the JAX engine's, token for token,
  per family, with ragged prompt lengths, EOS inside a stream, and EOS on
  every row (the early exit between chunks). The JAX engine's family runs
  ``apply`` / ``apply_cached`` at fp32 with an fp32 cache, as the port's
  does at ``dtype: float32``.
- Sampling (temperature, top-k, top-p): the first sampled token over many
  identical rows against the filtered softmax of the prefill logits, within
  5 standard deviations a token.
- Quantized weights and ``init_inference(checkpoint=)``: in
  ``test_torch_inference_v1_quant.py``; from a ``transformers`` model or a
  local HF directory: in ``test_torch_hf_entry_points.py``. The HF inputs
  the JAX package refuses raise its ``ValueError``: an object without
  ``state_dict``, a ``config.json`` without ``model_type``, a
  ``rope_scaling`` checkpoint.
- The port's v2 engine against its v1 (Llama, GPT): greedy streams equal (as
  JAX ``tests/test_inference.py:435`` holds its v2 to its v1).
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
from deepspeed_tpu.models import bloom as jbloom
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import build_engine_v2
from deepspeed_tpu_torch.inference.sampling import SamplingParams, filter_logits
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params

FAMILIES = {
    "llama": (jl, tl, jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()),
    "gpt": (jgpt, tgpt, jgpt.GPTConfig.tiny(), tgpt.GPTConfig.tiny()),
    "bloom": (jbloom, tbloom, jbloom.BloomConfig.tiny(), tbloom.BloomConfig.tiny()),
}
CONF = {"dtype": "float32", "prefill_bucket": 8}
LENGTHS = [9, 5, 7]


def _setup(family, seed=0):
    jmod, tmod, cfg_j, cfg_t = FAMILIES[family]
    params_j = jmod.init(cfg_j, jax.random.PRNGKey(seed))
    return jmod, tmod, cfg_j, cfg_t, params_j, \
        from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j))


def _prompts(vocab, b=3, t=9, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _jax_engine(jmod, cfg_j, params_j, conf=CONF):
    mesh_lib.set_mesh(None)
    fam = jinf.ModelFamily(
        cfg=cfg_j, apply_fn=partial(jmod.apply, compute_dtype=jnp.float32),
        apply_cached=partial(jmod.apply_cached, compute_dtype=jnp.float32),
        init_cache=partial(jmod.init_cache, dtype=jnp.float32),
        param_logical_axes=jmod.param_logical_axes, name=jmod.__name__)
    return jinf.InferenceEngine(fam, params_j, jinf.InferenceConfig.from_dict(conf))


# --------------------------------------------------------------------------- #
# apply_cached
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_apply_cached_equals_jax_and_the_full_forward(family):
    jmod, tmod, cfg_j, cfg_t, params_j, params_t = _setup(family)
    prompts = _prompts(cfg_t.vocab_size, t=8)
    S, steps = 16, 3
    lengths = np.array([8, 5, 6], np.int32)
    cache_j = jmod.init_cache(cfg_j, 3, S, dtype=jnp.float32)
    cache_t = tmod.init_cache(cfg_t, 3, S, dtype=torch.float32, device="cpu")
    logits_j, cache_j = jmod.apply_cached(cfg_j, params_j, jnp.asarray(prompts), cache_j,
                                          jnp.zeros((3,), jnp.int32), compute_dtype=jnp.float32)
    logits_t, cache_t = tmod.apply_cached(cfg_t, params_t, torch.from_numpy(prompts), cache_t,
                                          torch.zeros(3, dtype=torch.long),
                                          compute_dtype=torch.float32)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)
    seqs = [list(prompts[i, :lengths[i]]) for i in range(3)]
    cache_len = lengths.copy()
    for step in range(steps):
        tok = np.random.RandomState(10 + step).randint(0, cfg_t.vocab_size, (3, 1)).astype(np.int32)
        logits_j, cache_j = jmod.apply_cached(cfg_j, params_j, jnp.asarray(tok), cache_j,
                                              jnp.asarray(cache_len), compute_dtype=jnp.float32)
        logits_t, cache_t = tmod.apply_cached(cfg_t, params_t, torch.from_numpy(tok), cache_t,
                                              torch.from_numpy(cache_len),
                                              compute_dtype=torch.float32)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step}")
        for i in range(3):
            seqs[i].append(int(tok[i, 0]))
            full = tmod.apply(cfg_t, params_t, torch.tensor([seqs[i]]),
                              compute_dtype=torch.float32)
            np.testing.assert_allclose(logits_t[i, 0].numpy(), full[0, -1].numpy(),
                                       rtol=1e-5, atol=1e-5)
        cache_len += 1
    for k in ("k", "v"):
        np.testing.assert_allclose(cache_t[k].numpy(), np.asarray(cache_j[k]), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------- #
# generate
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_generate_equals_jax_with_ragged_lengths_and_eos(family):
    jmod, tmod, cfg_j, cfg_t, params_j, params_t = _setup(family)
    eng_j = _jax_engine(jmod, cfg_j, params_j)
    eng_t = init_inference(tmod, model_cfg=cfg_t, params=params_t, config=CONF, device="cpu")
    prompts = _prompts(cfg_t.vocab_size)
    out_j = eng_j.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=12)
    out_t = eng_t.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=12)
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    # EOS inside row 0's stream; the rows it does not end run on
    eos = int(out_t[0, 3])
    np.testing.assert_array_equal(
        eng_t.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=12, eos_token_id=eos),
        np.asarray(eng_j.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=12,
                                  eos_token_id=eos)))
    # one row ending early: every row finished inside the first chunk, so
    # the second is never decoded and the tail is EOS
    one = prompts[:1]
    eos = int(out_t[0, 2])
    got = eng_t.generate(one, prompt_lengths=LENGTHS[:1], max_new_tokens=40, eos_token_id=eos)
    want = eng_j.generate(one, prompt_lengths=LENGTHS[:1], max_new_tokens=40, eos_token_id=eos)
    np.testing.assert_array_equal(got, np.asarray(want))
    first = int(np.argmax(got[0] == eos))
    assert (got[0, first:] == eos).all() and first <= 2
    # the no-cache forward's argmax at every generated position
    seq = np.concatenate([prompts[0, :LENGTHS[0]], out_t[0, :-1]])[None]
    full = eng_t.forward(seq)[0, LENGTHS[0] - 1:].argmax(-1).numpy()
    np.testing.assert_array_equal(full, out_t[0])


def test_sampling_follows_the_filtered_distribution():
    _, tmod, _, cfg_t, _, params_t = _setup("llama")
    eng = init_inference(tmod, model_cfg=cfg_t, params=params_t, config=CONF, device="cpu")
    n = 4000
    prompt = _prompts(cfg_t.vocab_size, b=1, t=6)
    for kw in ({"temperature": 1.0}, {"temperature": 0.7, "top_k": 20},
               {"temperature": 1.3, "top_p": 0.8}):
        toks = eng.generate(np.repeat(prompt, n, 0), max_new_tokens=1, seed=3, **kw)[:, 0]
        logits = eng.forward(prompt)[0, -1]
        p = torch.softmax(filter_logits(logits[None], SamplingParams(**kw)), -1)[0].numpy()
        freq = np.bincount(toks, minlength=p.size) / n
        assert (freq[p == 0] == 0).all(), kw
        sd = np.sqrt(p * (1 - p) / n)
        assert (np.abs(freq - p) <= 5 * sd + 1e-3).all(), kw


# --------------------------------------------------------------------------- #
# quantized weights
# --------------------------------------------------------------------------- #
def test_hf_inputs_raise(tmp_path):
    """The HF inputs that ``init_inference`` still refuses, as the JAX
    package refuses them: an object without ``state_dict`` (no transformers
    model), a ``config.json`` without ``model_type``, and a ``rope_scaling``
    checkpoint (JAX's words)."""
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu.models.hf_import import llama_config_from_hf

    class FakeHF:
        config = type("Config", (), {"model_type": "llama"})()

    with pytest.raises(ValueError, match="transformers model"):
        init_inference(FakeHF(), device="cpu")
    (tmp_path / "hf").mkdir()
    (tmp_path / "hf" / "config.json").write_text("{}")
    with pytest.raises(ValueError, match="model_type"):
        init_inference(checkpoint=str(tmp_path / "hf"), device="cpu")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
        num_attention_heads=2, rope_scaling={"rope_type": "linear", "factor": 2.0})
    transformers.LlamaForCausalLM(hf_cfg).save_pretrained(tmp_path / "scaled")
    with pytest.raises(ValueError) as jax_err:
        llama_config_from_hf(hf_cfg)
    with pytest.raises(ValueError, match="rope_scaling") as err:
        init_inference(checkpoint=str(tmp_path / "scaled"), device="cpu")
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_v2_engine_matches_v1(family):
    _, tmod, _, cfg_t, _, params_t = _setup(family)
    v1 = init_inference(tmod, model_cfg=cfg_t, params=params_t, config=CONF, device="cpu")
    v2 = build_engine_v2(tmod, cfg_t, params_t, device="cpu", config=dict(
        CONF, ragged={"max_tracked_sequences": 4, "max_ragged_batch_size": 4,
                      "memory_config_blocks": 32, "block_size": 8}))
    prompts = _prompts(cfg_t.vocab_size)
    want = v1.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=6)
    got = v2.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=6)
    np.testing.assert_array_equal(np.asarray(got), want)
