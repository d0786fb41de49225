"""The port's HF entry points against the JAX package's, on the CPU:
``initialize(model=<transformers model>)``, ``init_inference`` from a
``transformers`` model and from a local HF directory, and engine v2's
``build_hf_engine(directory)``.

- ``initialize(model=hf_model)``: 10 engine steps (AdamW, GAS 2, clipping)
  against ``deepspeed_tpu.initialize(model=hf_model)`` on the same model.
  fp32: losses and grad norms 1e-5 relative, params 2e-4 absolute (the
  other families' trajectory tolerances). bf16 (the ``bf16`` block: both
  packages compute in bf16, on their own orders of rounding): losses within
  ``BF16_LOSS_RTOL`` (4 bf16 roundings, 4 * 2^-8) relative of JAX's, and
  falling. The spec computes in the config's bf16 / fp16 / fp32.
- ``init_inference`` from a model and from a directory, and
  ``build_hf_engine``: greedy streams equal to the JAX engines' (v1 and v2
  built on JAX's own import of the same model or directory, computing in
  fp32), token for token, and to ``transformers``' own ``generate``.
- The JAX package's errors: a family without a KV-cached decode (BERT,
  CLIP) is "not generative" for ``init_inference``; one without a paged
  path (GPT-NeoX, BERT, CLIP) is refused by ``build_hf_engine``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

from _hf_models import hf_model  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.comm import mesh as mesh_lib  # noqa: E402
from deepspeed_tpu.inference import engine as jinf  # noqa: E402
from deepspeed_tpu.inference import engine_v2 as jv2  # noqa: E402
from deepspeed_tpu.models import hf_import as jhf  # noqa: E402
from deepspeed_tpu_torch import init_inference  # noqa: E402
from deepspeed_tpu_torch.inference.engine_v2 import build_hf_engine  # noqa: E402
from deepspeed_tpu_torch.models.convert import to_jax_params  # noqa: E402

BF16_LOSS_RTOL = 4 * 2.0 ** -8
CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 0.5, "steps_per_print": 0}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_initialize_hf_model_matches_jax(family, precision):
    m = hf_model(family)
    conf = dict(CONFIG, bf16={"enabled": precision == "bf16"})
    mesh_lib.set_mesh(None)
    eng_j, *_ = deepspeed_tpu.initialize(model=m, config=conf, devices=jax.devices()[:1])
    eng_t, *_ = deepspeed_tpu_torch.initialize(model=m, config=conf, device="cpu")
    assert eng_t.model.compute_dtype == (torch.bfloat16 if precision == "bf16"
                                         else torch.float32)
    rs = np.random.RandomState(1)
    two = [{"tokens": rs.randint(0, 128, (4, 17)).astype(np.int32)} for _ in range(2)]
    batches = [two[i % 2] for i in range(10)]
    outs_j = [eng_j.train_batch(b) for b in batches]
    outs_t = [eng_t.train_batch(b) for b in batches]
    losses_t, losses_j = [float(o.loss) for o in outs_t], [float(o.loss) for o in outs_j]
    assert losses_t[-1] < losses_t[0]
    if precision == "bf16":
        np.testing.assert_allclose(losses_t, losses_j, rtol=BF16_LOSS_RTOL)
        return
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    np.testing.assert_allclose([float(o.grad_norm) for o in outs_t],
                               [float(o.grad_norm) for o in outs_j], rtol=1e-5)
    cfg = eng_t.model.config
    got = _leaves(to_jax_params(cfg, {k: v.detach() for k, v in eng_t.state.params.items()}))
    want = _leaves(eng_j.state.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("block,dtype", [("bf16", torch.bfloat16), ("fp16", torch.float16),
                                         (None, torch.float32)])
def test_initialize_hf_model_computes_in_the_config_precision(block, dtype):
    """The import waits for the parsed config: the family's spec computes in
    bf16, fp16 or fp32 as the ``bf16`` / ``fp16`` blocks say (JAX
    ``initialize``), and holds the imported weights as fp32 masters."""
    conf = dict(CONFIG, **({block: {"enabled": True}} if block else {}))
    eng, *_ = deepspeed_tpu_torch.initialize(model=hf_model("qwen2"), config=conf, device="cpu")
    assert eng.model.compute_dtype == dtype and eng.model.name == "llama"
    assert all(p.dtype == torch.float32 for p in eng.state.params.values())
    assert float(eng.train_batch({"tokens": np.ones((4, 9), np.int32)}).loss) > 0


def test_initialize_refuses_what_is_not_a_model():
    with pytest.raises(TypeError) as ej:
        deepspeed_tpu.initialize(model=object(), config={"train_batch_size": 1})
    with pytest.raises(TypeError) as et:
        deepspeed_tpu_torch.initialize(model=object(), config={"train_batch_size": 1},
                                       device="cpu")
    assert str(et.value) == str(ej.value)


V1 = {"dtype": "float32", "prefill_bucket": 8}
NEW = 8


def _jax_v1(module, cfg, tree):
    mesh_lib.set_mesh(None)
    fam = jinf.ModelFamily(
        cfg=cfg, apply_fn=partial(module.apply, compute_dtype=jnp.float32),
        apply_cached=partial(module.apply_cached, compute_dtype=jnp.float32),
        init_cache=partial(module.init_cache, dtype=jnp.float32),
        param_logical_axes=module.param_logical_axes, name=module.__name__)
    return jinf.InferenceEngine(fam, jax.tree.map(jnp.asarray, tree),
                                jinf.InferenceConfig.from_dict(V1))


def _prompts(seed=2):
    return np.random.RandomState(seed).randint(4, 128, (3, 6)).astype(np.int32)


def _hf_generate(m, prompts):
    with torch.no_grad():
        return m.generate(torch.as_tensor(prompts), max_new_tokens=NEW, do_sample=False,
                          pad_token_id=0).numpy()[:, prompts.shape[1]:]


@pytest.mark.parametrize("family", ["llama", "gpt2", "falcon", "qwen2"])
def test_init_inference_from_a_model_matches_jax(family):
    m = hf_model(family)
    eng_t = init_inference(m, config=V1, device="cpu")
    cfg_j, tree_j = jhf.from_hf(m)
    eng_j = _jax_v1(jhf.resolve_module(family), cfg_j, tree_j)
    prompts = _prompts()
    got = eng_t.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, np.asarray(eng_j.generate(prompts, max_new_tokens=NEW)))
    np.testing.assert_array_equal(got, _hf_generate(m, prompts))


@pytest.mark.parametrize("family", ["llama", "gptj", "mixtral"])
def test_init_inference_from_a_directory_matches_jax(family, tmp_path):
    m = hf_model(family)
    m.save_pretrained(tmp_path)
    eng_t = init_inference(checkpoint=str(tmp_path), config=V1, device="cpu")
    fam, module, cfg_j, tree_j = jhf.load_checkpoint_dir_module(str(tmp_path))
    eng_j = _jax_v1(module, cfg_j, tree_j)
    prompts = _prompts(3)
    got = eng_t.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, np.asarray(eng_j.generate(prompts, max_new_tokens=NEW)))
    if family != "mixtral":     # HF routes top-k in its own order of sums
        np.testing.assert_array_equal(got, _hf_generate(m, prompts))


V2 = {"dtype": "float32", "prefill_bucket": 16,
      "ragged": {"max_tracked_sequences": 4, "max_ragged_batch_size": 4,
                 "memory_config_blocks": 64, "block_size": 8}}


@pytest.mark.parametrize("family", ["llama", "gpt2", "falcon"])
def test_build_hf_engine_matches_jax(family, tmp_path):
    m = hf_model(family)
    m.save_pretrained(tmp_path)
    eng_t = build_hf_engine(str(tmp_path), config=V2, device="cpu")
    fam, module, cfg_j, tree_j = jhf.load_checkpoint_dir_module(str(tmp_path))
    mesh_lib.set_mesh(None)
    eng_j = jv2.InferenceEngineV2(
        jinf.ModelFamily.from_module(module, cfg_j), jax.tree.map(jnp.asarray, tree_j),
        jinf.InferenceConfig.from_dict(V2),
        init_paged_cache=partial(module.init_paged_cache, dtype=jnp.float32),
        apply_paged=partial(module.apply_paged, compute_dtype=jnp.float32))
    prompts = [p for p in _prompts(4)] + [np.array([5, 9, 17], np.int32)]
    got = eng_t.generate(prompts, max_new_tokens=NEW)
    want = [[int(t) for t in s] for s in eng_j.generate(prompts, max_new_tokens=NEW)]
    assert got == want
    np.testing.assert_array_equal(np.asarray(got[:3]), _hf_generate(m, _prompts(4)))


def _jax_error(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


@pytest.mark.parametrize("family", ["bert", "clip", "gpt_neox", "distilbert"])
def test_families_without_a_decode_path_raise_like_jax(family, tmp_path):
    hf_model(family).save_pretrained(tmp_path)
    path = str(tmp_path)
    want = _jax_error(jv2.build_hf_engine, path)
    with pytest.raises(ValueError) as e:
        build_hf_engine(path, device="cpu")
    assert str(e.value) == want and "apply_paged" in want
    if family == "gpt_neox":   # v1 serves it
        assert init_inference(checkpoint=path, config=V1, device="cpu").generate(
            _prompts(), max_new_tokens=2).shape == (3, 2)
        return
    want = _jax_error(deepspeed_tpu.init_inference, checkpoint=path)
    with pytest.raises(ValueError) as e:
        init_inference(checkpoint=path, device="cpu")
    assert str(e.value) == want and "not generative" in want
