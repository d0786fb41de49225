"""The v1 inference engine of the PyTorch port against the JAX package's, on
the CPU, in fp32: weights at rest quantized and weights read from training
tags (cases moved unchanged from ``test_torch_inference_v1.py``, whose
helpers they use, to keep each file under ~100 s).

- Quantized weights: int8, packed int4 and fp8 codes and scales bit for bit
  against the JAX engine's ``_quantize_params`` (the JAX layout's matrices
  compared transposed; the two fp8 casts agree below 464, and codes stay at
  most 448 in magnitude), and quantized greedy streams equal to JAX's.
- ``init_inference(checkpoint=)`` from a regular port tag, a universal port
  tag and a universal tag the JAX engine wrote: the same streams as from
  the params.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_inference_v1 import CONF, FAMILIES, LENGTHS, _jax_engine, _prompts, _setup

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import TRANSPOSED, from_jax_params


QUANT = {"int8": {"enabled": True, "bits": 8}, "int4": {"enabled": True, "bits": 4},
         "fp8": {"enabled": True, "dtype": "fp8"}}


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name.startswith("float8"):
        return a.view(np.uint8)
    return a


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mode", sorted(QUANT))
def test_quantized_codes_scales_and_streams_equal_jax(family, mode):
    jmod, tmod, cfg_j, cfg_t, params_j, params_t = _setup(family)
    conf = dict(CONF, quant=QUANT[mode])
    eng_j = _jax_engine(jmod, cfg_j, params_j, conf)
    eng_t = init_inference(tmod, model_cfg=cfg_t, params=params_t, config=conf, device="cpu")
    jtree = eng_j.params
    for name, leaf in eng_t.params.items():
        base = name.rsplit(".", 1)[-1]
        if name.startswith("layers."):
            _, l, base = name.split(".", 2)
            want = jax.tree.map(lambda a, l=int(l): np.asarray(a)[l], jtree["layers"][base])
        else:
            want = jax.tree.map(np.asarray, jtree[name])
        if not isinstance(leaf, dict):
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=name)
            continue
        assert set(leaf) == set(want), (name, set(leaf), set(want))
        for part, t in leaf.items():
            got = t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t.numpy()
            w = _bits(want[part])
            if base in TRANSPOSED:
                w = w.T
            np.testing.assert_array_equal(got, w, err_msg=f"{name} {part}")
    prompts = _prompts(cfg_t.vocab_size)
    np.testing.assert_array_equal(
        eng_t.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=8),
        np.asarray(eng_j.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=8)))
    assert eng_t.weight_bytes() < sum(t.numel() * 4 for t in params_t.values())


# --------------------------------------------------------------------------- #
# init_inference from checkpoints, and what it refuses
# --------------------------------------------------------------------------- #
TRAIN = {"train_batch_size": 2, "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
         "steps_per_print": 0}


def test_init_inference_from_port_and_jax_tags(tmp_path):
    jmod, tmod, cfg_j, cfg_t, params_j, params_t = _setup("llama")
    batch = {"tokens": _prompts(cfg_t.vocab_size, b=2, t=9)}
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params_j, loss_fn=lambda p, b: jl.loss_fn(
            cfg_j, p, b, compute_dtype=jnp.float32)),
        config=TRAIN, devices=jax.devices()[:1])
    eng_j.train_batch(batch)
    eng_j.save_universal_checkpoint(str(tmp_path / "jax"), tag="u1")
    trained = from_jax_params(cfg_t, jax.tree.map(np.asarray, eng_j.state.params))
    spec = dataclasses.replace(tl.model_spec(cfg_t, compute_dtype=torch.float32),
                               params=trained, init_fn=None)
    eng_p, *_ = deepspeed_tpu_torch.initialize(model=spec, config=TRAIN, device="cpu")
    eng_p.save_checkpoint(str(tmp_path / "port"), tag="reg")
    eng_p.save_universal_checkpoint(str(tmp_path / "port"), tag="uni")

    prompts = _prompts(cfg_t.vocab_size)
    want = init_inference(tmod, model_cfg=cfg_t, params=trained, config=CONF,
                          device="cpu").generate(prompts, prompt_lengths=LENGTHS,
                                                 max_new_tokens=6)
    for ckpt in (tmp_path / "jax", tmp_path / "jax" / "u1", tmp_path / "port" / "reg",
                 tmp_path / "port" / "uni", tmp_path / "port"):
        eng = init_inference(tmod, model_cfg=cfg_t, checkpoint=str(ckpt), config=CONF,
                             device="cpu")
        for k, t in eng.params.items():
            np.testing.assert_allclose(t.numpy(), trained[k].numpy(), rtol=0, atol=0,
                                       err_msg=f"{ckpt} {k}")
        np.testing.assert_array_equal(
            eng.generate(prompts, prompt_lengths=LENGTHS, max_new_tokens=6), want)
