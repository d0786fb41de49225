"""The port's HF importer (``deepspeed_tpu_torch/models/hf_import.py``)
against the JAX package's (``deepspeed_tpu/models/hf_import.py``), on the
CPU.

- For every row of the JAX ``_FAMILIES`` table, a tiny ``transformers``
  model built from its config class under a seed: the port's ``from_hf``
  gives JAX's config and tree, bit for bit, and the port's forward of that
  tree (through ``models/convert.py``) equals the HF model's own output at
  the JAX test's tolerance (``tests/test_hf_import.py``: rtol / atol 2e-3).
- ``save_pretrained`` directories, read by the port without
  ``transformers``, give the tree JAX's ``load_checkpoint_dir_module``
  (``transformers``' loader) gives, bit for bit: safetensors for every
  family, ``.bin`` and sharded safetensors for some, bf16 files, a file
  without the base-model prefix, BERT's legacy ``gamma`` / ``beta`` names
  and a masked-LM head's keys.
- The port's config-default table equals the ``transformers`` classes'
  defaults for every attribute read.
- Megatron-GPT state dicts (checkpoint versions 0, 1 and 2) and the JAX
  package's refusals, word for word.
"""

import copy
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

from _hf_models import FAMILIES, LLAMA_LIKE, SMALL, _hf_config, hf_model  # noqa: E402

from deepspeed_tpu.models import hf_import as jhf  # noqa: E402
from deepspeed_tpu_torch.models import convert, hf_import as thf  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_hf_import.py's logit tolerance


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), \
        (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, (path, k, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def assert_configs_equal(cfg_t, cfg_j):
    """Every field the two configs share, equal (CLIP's towers field by
    field)."""
    assert type(cfg_t).__name__ == type(cfg_j).__name__
    tj = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)}
    for f in dataclasses.fields(cfg_t):
        if f.name in tj:
            a, b = getattr(cfg_t, f.name), tj[f.name]
            if dataclasses.is_dataclass(a):
                assert_configs_equal(a, b)
            else:
                assert a == b, (f.name, a, b)


# --------------------------------------------------------------------------- #
# live models: config, tree, forward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", FAMILIES)
def test_from_hf_equals_jax(family):
    m = hf_model(family)
    cfg_t, tree_t = thf.from_hf(m, family)
    cfg_j, tree_j = jhf.from_hf(m, family)
    assert_configs_equal(cfg_t, cfg_j)
    assert_trees_equal(tree_t, tree_j)
    state = convert.from_jax_params(cfg_t, tree_t)       # the port's layout holds it
    assert_trees_equal(convert.to_jax_params(cfg_t, state), tree_t)


def _inputs(family, seed):
    rs = np.random.RandomState(seed)
    if family == "clip":
        tokens = rs.randint(0, 62, (3, 10))
        tokens[:, -1] = 63
        return tokens, rs.randn(2, 3, 32, 32).astype(np.float32)
    return rs.randint(4, 128, (2, 10)), None


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_hf(family):
    m = hf_model(family)
    cfg, tree = thf.from_hf(m, family)
    params = convert.from_jax_params(cfg, tree)
    module = thf.resolve_module(family)
    tokens, images = _inputs(family, FAMILIES.index(family))
    tt = torch.as_tensor(tokens)
    with torch.no_grad():
        if family == "clip":
            ref = m(input_ids=tt, pixel_values=torch.as_tensor(images))
            lt, li = module.apply(cfg, params, tt, torch.as_tensor(images),
                                  compute_dtype=torch.float32)
            np.testing.assert_allclose(lt.numpy(), ref.logits_per_text.numpy(), **TOL)
            np.testing.assert_allclose(li.numpy(), ref.logits_per_image.numpy(), **TOL)
            return
        if family in ("bert", "distilbert"):
            ref = m(tt)
            out = module.apply(cfg, params, tt, compute_dtype=torch.float32)
            np.testing.assert_allclose(out["hidden"].numpy(),
                                       ref.last_hidden_state.numpy(), **TOL)
            if family == "bert":
                np.testing.assert_allclose(out["pooled"].numpy(),
                                           ref.pooler_output.numpy(), **TOL)
            return
        ref = m(tt).logits.numpy()
        out = module.apply(cfg, params, tt, compute_dtype=torch.float32)
        logits = out[0] if isinstance(out, tuple) else out
        np.testing.assert_allclose(logits.numpy(), ref, **TOL)


def test_state_dict_mapping_inputs():
    """The mappers take a raw state-dict mapping, as JAX's do."""
    m = hf_model("llama")
    cfg, _ = thf.from_hf(m)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    assert_trees_equal(thf.llama_params_from_hf(sd, cfg), jhf.llama_params_from_hf(sd, cfg))


# --------------------------------------------------------------------------- #
# local directories, read without transformers
# --------------------------------------------------------------------------- #
def _dir_trees(path):
    fam_t, mod_t, cfg_t, tree_t = thf.load_checkpoint_dir_module(str(path))
    fam_j, mod_j, cfg_j, tree_j = jhf.load_checkpoint_dir_module(str(path))
    assert fam_t == fam_j and mod_t.__name__.rsplit(".", 1)[1] == mod_j.__name__.rsplit(".", 1)[1]
    assert_configs_equal(cfg_t, cfg_j)
    return tree_t, tree_j


@pytest.mark.parametrize("family", FAMILIES)
def test_dir_safetensors_equals_jax(family, tmp_path):
    hf_model(family).save_pretrained(tmp_path)
    tree_t, tree_j = _dir_trees(tmp_path)
    assert_trees_equal(tree_t, tree_j)


@pytest.mark.parametrize("family,fmt", [
    ("llama", "bin"), ("gpt2", "bin"), ("bert", "bin"), ("clip", "bin"),
    ("llama", "sharded"), ("falcon", "sharded"), ("distilbert", "sharded"),
    ("qwen2_moe", "sharded_bin"), ("mistral", "bf16"), ("bert", "bf16"),
    ("falcon", "tied_untied_head")])
def test_dir_formats_equal_jax(family, fmt, tmp_path):
    """``.bin`` (``safe_serialization=False``), sharded indexes, a bf16 file
    (read as fp32, as the loader's ``torch_dtype="float32"``), and a tied
    Falcon whose file still holds a head the loader overrides."""
    m = hf_model(family)
    if fmt == "bin":
        m.save_pretrained(tmp_path, safe_serialization=False)
    elif fmt == "sharded":
        m.save_pretrained(tmp_path, max_shard_size="20KB")
        assert os.path.exists(tmp_path / "model.safetensors.index.json")
    elif fmt == "sharded_bin":
        m.save_pretrained(tmp_path, max_shard_size="20KB", safe_serialization=False)
        assert os.path.exists(tmp_path / "pytorch_model.bin.index.json")
    elif fmt == "bf16":
        copy.deepcopy(m).to(torch.bfloat16).save_pretrained(tmp_path)
    else:
        m.save_pretrained(tmp_path)
        sd = thf.read_safetensors(str(tmp_path / "model.safetensors"))
        sd["lm_head.weight"] = np.ones_like(sd["transformer.word_embeddings.weight"])
        os.remove(tmp_path / "model.safetensors")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / "pytorch_model.bin")
    tree_t, tree_j = _dir_trees(tmp_path)
    assert_trees_equal(tree_t, tree_j)


def _write_bin_dir(path, config: dict, state: dict):
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.json", "w") as f:
        json.dump(config, f)
    torch.save({k: v.contiguous() for k, v in state.items()}, path / "pytorch_model.bin")


@pytest.mark.parametrize("case", ["bert_gamma_beta_unprefixed", "bert_mlm_head",
                                  "gpt2_unprefixed", "llama_base_model", "distilbert_mlm"])
def test_dir_key_fixups_equal_jax(case, tmp_path):
    """Keys the loader mends: legacy ``LayerNorm.gamma`` / ``.beta``, no
    base-model prefix (older GPT-2 / BERT files, a base model's own
    ``save_pretrained``), a masked-LM head's keys (BERT's pooler, which the
    class JAX's loader lands on drops; DistilBERT's prefix and head)."""
    family = case.split("_")[0]
    m = hf_model(family)
    cfg = m.config.to_dict()
    if case == "bert_gamma_beta_unprefixed":
        state = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
                 .replace("LayerNorm.bias", "LayerNorm.beta"): v
                 for k, v in m.state_dict().items()}
        assert any(k.endswith("LayerNorm.gamma") for k in state)
        _write_bin_dir(tmp_path, cfg, state)
    elif case == "bert_mlm_head":
        torch.manual_seed(40)
        mlm = transformers.BertForMaskedLM(m.config)
        mlm.save_pretrained(tmp_path)
    elif case == "gpt2_unprefixed":
        base = transformers.GPT2Model(m.config)
        base.load_state_dict({k[len("transformer."):]: v for k, v in m.state_dict().items()
                              if k.startswith("transformer.")})
        base.save_pretrained(tmp_path)
    elif case == "llama_base_model":
        cfg = dict(cfg, tie_word_embeddings=True)
        base = transformers.LlamaModel(transformers.LlamaConfig(**cfg))
        base.load_state_dict({k[len("model."):]: v for k, v in m.state_dict().items()
                              if k.startswith("model.")})
        base.save_pretrained(tmp_path)
    else:
        torch.manual_seed(41)
        transformers.DistilBertForMaskedLM(m.config).save_pretrained(tmp_path)
    tree_t, tree_j = _dir_trees(tmp_path)
    assert_trees_equal(tree_t, tree_j)
    if family == "bert":       # BertLMHeadModel has no pooler: zeros on both sides
        assert not tree_t["pooler_w"].any()


def test_hf_checkpoint_is_a_stand_in(tmp_path):
    """``read_hf_dir`` gives a stand-in that ``is_hf_model`` takes, whose
    ``from_hf`` tree equals the live model's."""
    m = hf_model("llama")
    m.save_pretrained(tmp_path)
    ckpt = thf.read_hf_dir(str(tmp_path))
    assert thf.is_hf_model(ckpt) and thf.is_hf_model(m)
    assert not thf.is_hf_model(object())
    assert_trees_equal(thf.from_hf(ckpt)[1], thf.from_hf(m)[1])


ATTRS = {   # what each config function reads (the JAX package's getattr list)
    "llama": ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
              "rope_theta", "rms_norm_eps", "tie_word_embeddings", "attention_bias",
              "head_dim", "rope_scaling"),
    "mixtral": ("num_local_experts", "num_experts_per_tok", "router_aux_loss_coef"),
    "qwen2_moe": ("moe_intermediate_size", "num_experts", "num_experts_per_tok",
                  "norm_topk_prob", "shared_expert_intermediate_size", "mlp_only_layers",
                  "decoder_sparse_step", "router_aux_loss_coef"),
    "gpt2": ("vocab_size", "n_embd", "n_inner", "n_layer", "n_head", "n_positions",
             "layer_norm_epsilon"),
    "opt": ("vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers",
            "num_attention_heads", "max_position_embeddings", "word_embed_proj_dim",
            "do_layer_norm_before", "activation_function", "tie_word_embeddings"),
    "falcon": ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
               "num_kv_heads", "max_position_embeddings", "rope_theta", "layer_norm_epsilon",
               "alibi", "new_decoder_architecture", "multi_query", "parallel_attn", "bias",
               "tie_word_embeddings"),
    "gpt_neox": ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "max_position_embeddings", "rotary_pct",
                 "rotary_emb_base", "use_parallel_residual", "hidden_act", "layer_norm_eps"),
    "gptj": ("vocab_size", "n_embd", "n_inner", "n_layer", "n_head", "n_positions",
             "rotary_dim", "layer_norm_epsilon"),
    "bloom": ("vocab_size", "hidden_size", "n_layer", "n_head", "layer_norm_epsilon"),
    "bert": ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
             "num_attention_heads", "max_position_embeddings", "type_vocab_size",
             "layer_norm_eps", "hidden_act"),
    "distilbert": ("vocab_size", "dim", "hidden_dim", "n_layers", "n_heads",
                   "max_position_embeddings", "activation"),
    "exaone4": ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
                "sliding_window", "sliding_window_pattern", "rope_theta", "rms_norm_eps",
                "tie_word_embeddings", "layer_types", "rope_scaling"),
    "clip": ("projection_dim",),
    "clip.text_config": ("vocab_size", "max_position_embeddings", "eos_token_id",
                         "hidden_size", "intermediate_size", "num_hidden_layers",
                         "num_attention_heads", "layer_norm_eps", "hidden_act"),
    "clip.vision_config": ("image_size", "patch_size", "num_channels", "hidden_size",
                           "intermediate_size", "num_hidden_layers", "num_attention_heads",
                           "layer_norm_eps", "hidden_act"),
}
for _f in ("mistral", "qwen2", "qwen3", "phi3"):
    ATTRS[_f] = ATTRS["llama"]
ATTRS["mixtral"] = ATTRS["llama"][:10] + ATTRS["mixtral"]
ATTRS["qwen2_moe"] = ATTRS["llama"][:10] + ATTRS["qwen2_moe"]


@pytest.mark.parametrize("family", FAMILIES)
def test_config_defaults_equal_transformers(family):
    """A ``config.json`` holding only ``model_type`` reads as the class's
    default instance on every attribute a mapper reads (present on both or
    on neither); the tiny config's own ``config.json`` as the tiny config."""
    pairs = [(thf.hf_config({"model_type": family}),
              transformers.AutoConfig.for_model(family)),
             (thf.hf_config(json.loads(_hf_config(family).to_json_string(use_diff=True))),
              _hf_config(family))]
    for ours, ref in pairs:
        subs = [("", ours, ref)]
        if family == "clip":
            subs += [(".text_config", ours.text_config, ref.text_config),
                     (".vision_config", ours.vision_config, ref.vision_config)]
        for sub, o, r in subs:
            for a in ATTRS[family + sub]:
                assert hasattr(o, a) == hasattr(r, a), (family + sub, a)
                if hasattr(r, a):
                    assert getattr(o, a) == getattr(r, a), (family + sub, a, getattr(o, a),
                                                            getattr(r, a))


def test_config_aliases():
    """transformers' ``attribute_map``: a config.json may name GPT-2's
    widths ``hidden_size``, BLOOM's ``num_hidden_layers``; Falcon's and
    BLOOM's legacy ``n_embed``."""
    for family, doc in (("gpt2", {"hidden_size": 96, "num_hidden_layers": 3}),
                        ("bloom", {"num_hidden_layers": 3, "n_embed": 96}),
                        ("falcon", {"n_embed": 96}),
                        ("distilbert", {"hidden_size": 96})):
        ours = thf.hf_config({"model_type": family, **doc})
        ref = transformers.AutoConfig.for_model(family, **doc)
        for a in ATTRS[family]:
            assert getattr(ours, a) == getattr(ref, a), (family, a)
        assert ours.hidden_size == ref.hidden_size


def test_safetensors_reader_dtypes(tmp_path):
    """BF16, F16, F32, F64, I64 and BOOL tensors read as fp32, equal to
    torch's ``.float()`` of the same tensors."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "f16": torch.randn(7, generator=g).half(),
               "f32": torch.randn(2, 2, 2, generator=g),
               "f64": torch.randn(4, generator=g).double(),
               "i64": torch.arange(6).reshape(2, 3),
               "bool": torch.tensor([True, False, True]),
               "scalar": torch.tensor(2.5)}
    save_file(tensors, str(tmp_path / "t.safetensors"))
    got = thf.read_safetensors(str(tmp_path / "t.safetensors"))
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == np.float32 and got[k].shape == tuple(t.shape)
        np.testing.assert_array_equal(got[k], t.float().numpy())


# --------------------------------------------------------------------------- #
# Megatron-GPT, and the refusals
# --------------------------------------------------------------------------- #
def _megatron_sd(rng, L=2, h=16, nh=4, v=64, ckpt_ver=2.0):
    sd = {"checkpoint_version": ckpt_ver,
          "word_embeddings.weight": rng.randn(v, h),
          "position_embeddings.weight": rng.randn(32, h),
          "final_layernorm.weight": rng.randn(h),
          "final_layernorm.bias": rng.randn(h)}
    for i in range(L):
        p = f"transformer.layers.{i}."
        sd[p + "input_layernorm.weight"] = rng.randn(h)
        sd[p + "input_layernorm.bias"] = rng.randn(h)
        sd[p + "attention.query_key_value.weight"] = rng.randn(3 * h, h)
        sd[p + "attention.query_key_value.bias"] = rng.randn(3 * h)
        sd[p + "attention.dense.weight"] = rng.randn(h, h)
        sd[p + "attention.dense.bias"] = rng.randn(h)
        sd[p + "post_attention_layernorm.weight"] = rng.randn(h)
        sd[p + "post_attention_layernorm.bias"] = rng.randn(h)
        sd[p + "mlp.dense_h_to_4h.weight"] = rng.randn(4 * h, h)
        sd[p + "mlp.dense_h_to_4h.bias"] = rng.randn(4 * h)
        sd[p + "mlp.dense_4h_to_h.weight"] = rng.randn(h, 4 * h)
        sd[p + "mlp.dense_4h_to_h.bias"] = rng.randn(h)
    return sd


@pytest.mark.parametrize("version", ["v0_module_unversioned", "v0", "v2", "v2_module"])
def test_megatron_versions_equal_jax(version):
    """v0 (whole [q;k;v] blocks; an unversioned module-wrapped dict is v0),
    v2 (per-head groups, de-interleaved): the port's tree is JAX's, and
    runs through the port's GPT."""
    from deepspeed_tpu_torch.models import gpt

    rng = np.random.RandomState(30)
    inner = _megatron_sd(rng, ckpt_ver=2.0 if "v2" in version else 0.0)
    if version == "v0_module_unversioned":
        del inner["checkpoint_version"]
        sd = {"module": inner}
    elif version == "v2_module":
        ver = inner.pop("checkpoint_version")
        sd = {"checkpoint_version": ver, "module": inner}
    else:
        sd = inner
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=16, intermediate_size=64,
                        num_layers=2, num_heads=4, max_seq_len=32)
    got = thf.megatron_gpt_params_from_sd(dict(sd), cfg=cfg)
    assert_trees_equal(got, jhf.megatron_gpt_params_from_sd(dict(sd), cfg=cfg))
    logits = gpt.apply(cfg, convert.from_jax_params(cfg, got), torch.tensor([[1, 2, 3]]),
                       compute_dtype=torch.float32)
    assert torch.isfinite(logits).all()


def _raises_like_jax(fn_t, fn_j, *args, **kw):
    with pytest.raises(Exception) as ej:
        fn_j(*args, **kw)
    with pytest.raises(type(ej.value)) as et:
        fn_t(*args, **kw)
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_megatron_v1_refused_like_jax():
    inner = _megatron_sd(np.random.RandomState(32))
    del inner["checkpoint_version"]
    msg = _raises_like_jax(thf.megatron_gpt_params_from_sd, jhf.megatron_gpt_params_from_sd,
                           {"checkpoint_version": 1.0, "module": inner}, cfg=None)
    assert "checkpoint_version" in msg


@pytest.mark.parametrize("case", ["rope_scaling", "exaone_rope_scaling", "attention_bias",
                                  "qk_norm", "unsupported", "falcon_alibi", "opt_proj",
                                  "opt_gelu", "clip_no_cfg", "falcon_no_cfg",
                                  "qwen2_moe_dense"])
def test_errors_like_jax(case):
    """The JAX package's refusals, word for word (and type for type)."""
    T = transformers
    if case == "rope_scaling":
        c = T.LlamaConfig(**dict(LLAMA_LIKE, rope_scaling={"rope_type": "linear",
                                                             "factor": 2.0}))
        _raises_like_jax(thf.llama_config_from_hf, jhf.llama_config_from_hf, c)
    elif case == "exaone_rope_scaling":
        c = types_ns(rope_scaling={"rope_type": "linear", "factor": 2.0})
        _raises_like_jax(thf.exaone4_config_from_hf, jhf.exaone4_config_from_hf, c)
    elif case in ("attention_bias", "qk_norm"):
        m = hf_model("llama" if case == "attention_bias" else "qwen3")
        cfg, _ = jhf.from_hf(m)
        bad = dataclasses.replace(cfg, **{case: not getattr(cfg, case)})
        _raises_like_jax(thf.llama_params_from_hf, jhf.llama_params_from_hf, m, bad)
    elif case == "unsupported":
        _raises_like_jax(thf.from_hf, jhf.from_hf, hf_model("gpt2"), family="rwkv")
        _raises_like_jax(thf.resolve_module, jhf.resolve_module, "rwkv")
    elif case == "falcon_alibi":
        c = T.FalconConfig(**SMALL, alibi=True)
        _raises_like_jax(thf.falcon_config_from_hf, jhf.falcon_config_from_hf, c)
    elif case == "opt_proj":
        c = T.OPTConfig(**SMALL, word_embed_proj_dim=32)
        _raises_like_jax(thf.opt_config_from_hf, jhf.opt_config_from_hf, c)
    elif case == "opt_gelu":
        c = T.OPTConfig(**SMALL, activation_function="gelu")
        _raises_like_jax(thf.opt_config_from_hf, jhf.opt_config_from_hf, c)
    elif case == "clip_no_cfg":
        sd = {k: v.numpy() for k, v in hf_model("clip").state_dict().items()}
        _raises_like_jax(thf.clip_params_from_hf, jhf.clip_params_from_hf, sd)
    elif case == "falcon_no_cfg":
        _raises_like_jax(thf.falcon_params_from_hf, jhf.falcon_params_from_hf,
                         hf_model("falcon"), None)
    else:
        c = T.Qwen2MoeConfig(**dict(LLAMA_LIKE, intermediate_size=96), decoder_sparse_step=2)
        _raises_like_jax(thf.qwen2_moe_config_from_hf, jhf.qwen2_moe_config_from_hf, c)


def types_ns(**kw):
    import types

    return types.SimpleNamespace(**kw)


def test_dir_without_model_type_raises(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"hidden_size": 64}, f)
    with pytest.raises(ValueError, match="model_type"):
        thf.read_hf_dir(str(tmp_path))


def test_tree_leaves_are_numpy_fp32():
    """The importer's trees hold fp32 numpy leaves, as JAX's before its
    ``device_put``."""
    _, tree = thf.from_hf(hf_model("bert"))
    for leaf in jax.tree.leaves(tree):
        assert isinstance(leaf, np.ndarray) and leaf.dtype == np.float32


def test_smoke_writer_dir_reads_the_same_in_transformers(tmp_path):
    """``chip_smoke.py``'s own safetensors writer (the card's machine has no
    ``transformers``): ``transformers`` reads its sharded directory into the
    weights written, bit for bit, and the port's reader and JAX's loader
    give one tree from it."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from deepspeed_tpu_torch.models import llama

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_layers=2)
    params = llama.init(cfg, torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    out = smoke.write_hf_llama_dir(tmp_path, cfg, params, shards=2)
    assert out["files"] == 2 and os.path.exists(tmp_path / "model.safetensors.index.json")
    model = transformers.AutoModelForCausalLM.from_pretrained(str(tmp_path),
                                                              torch_dtype=torch.bfloat16)
    got = model.state_dict()
    for name, t in smoke.hf_llama_names(params).items():
        assert got[name].dtype == torch.bfloat16 and torch.equal(got[name], t), name
    assert model.config.num_key_value_heads == cfg.num_kv_heads
    assert model.config.rope_theta == cfg.rope_theta
    tree_t, tree_j = _dir_trees(tmp_path)
    assert_trees_equal(tree_t, tree_j)
    cfg_t, _ = thf.from_hf(thf.read_hf_dir(str(tmp_path)))
    assert cfg_t == dataclasses.replace(cfg, head_dim=cfg.head_size)   # config.json states it
    state = convert.from_jax_params(cfg_t, tree_t)
    for k, v in params.items():
        assert torch.equal(state[k], v.float()), k
