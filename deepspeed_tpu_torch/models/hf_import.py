"""HF checkpoint import: ``transformers`` state dicts and local HF
checkpoint directories → the JAX package's param trees, which
``models/convert.py`` :func:`~.convert.from_jax_params` turns into the
port's ``state_dict`` — counterpart of ``deepspeed_tpu/models/hf_import.py``
(helpers :37-74, the family mappers :76-1154, ``resolve_module`` …
``load_checkpoint_dir_module`` :1156-1274).

The mappers are a numpy copy of the JAX package's and give the same trees
from the same weights, bit for bit: Llama / Mistral / Qwen2 / Qwen3 / Phi-3
(→ ``models/llama``), GPT-2 and OPT (→ ``models/gpt``), Mixtral and
Qwen2-MoE (→ ``models/mixtral``), Falcon, GPT-NeoX and GPT-J (→
``models/gptneox``), BLOOM, BERT and DistilBERT (→ ``models/bert``), CLIP
(both towers and the contrastive head), EXAONE-4, and Megatron-GPT state
dicts (:func:`megatron_gpt_params_from_sd`, checkpoint versions 0 and 2;
1.0 is refused). Their refusals keep the JAX package's words.

This module imports neither ``transformers`` nor ``safetensors``: a live
model is duck-typed (:func:`is_hf_model`), and a local directory is read
from its files alone (:func:`read_hf_dir`), giving the state dict that the
JAX package's ``transformers`` loader (``AutoModelForCausalLM``, else
``AutoModel``, in fp32) yields, as far as the mappers read it:

- ``config.json`` holds what ``save_pretrained`` wrote, which leaves out
  values equal to the class defaults (in a nested CLIP tower, all such
  values): :data:`CONFIG_DEFAULTS` holds the defaults of every attribute the
  mappers read, :data:`ATTRIBUTE_MAPS` the config classes' aliases
  (``n_embd`` …), and :func:`hf_config` derives what the classes derive
  (kv heads, Llama's head dim, EXAONE-4's layer types);
- weights from ``model.safetensors`` (parsed here: an 8-byte header length,
  a JSON header, little-endian data), a sharded ``*.safetensors.index.json``,
  or ``pytorch_model.bin`` (with its index) through ``torch.load(...,
  weights_only=True)``; every tensor cast to fp32, as the loader's
  ``torch_dtype="float32"`` does;
- the keys the loader mends: BERT's legacy ``LayerNorm.gamma`` / ``.beta``,
  a missing or extra base-model prefix (:data:`LOADED_CLASS`), a tied head
  ``save_pretrained`` left out, and the keys the loaded class drops (BERT's
  pooler under ``BertLMHeadModel``).
"""

from __future__ import annotations

import json
import os
import re
import types
from typing import Any, Dict, Mapping, Optional

import numpy as np

from ..utils.logging import log_dist

Params = Dict[str, Any]


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    try:  # torch tensor
        return t.detach().cpu().float().numpy()
    except AttributeError:
        return np.asarray(t)


def _normalize_state_dict(src) -> Dict[str, np.ndarray]:
    """Accept a transformers model, an nn.Module, or a mapping."""
    if hasattr(src, "state_dict") and callable(src.state_dict):
        src = src.state_dict()
    if not isinstance(src, Mapping):
        raise TypeError(f"cannot read weights from {type(src)}")
    return {k: _to_numpy(v) for k, v in src.items()}


def _count_indices(sd: Dict[str, np.ndarray], pattern: str) -> int:
    """1 + max index matched by ``pattern`` (one capture group) over keys."""
    idx = [int(m.group(1)) for k in sd if (m := re.match(pattern, k))]
    if not idx:
        raise KeyError(f"no keys match {pattern!r} — wrong family/prefix?")
    return 1 + max(idx)


def _stack(sd: Dict[str, np.ndarray], pattern: str, num_layers: int,
           transpose: bool = False) -> np.ndarray:
    """Collect per-layer tensors 'prefix.{i}.suffix' into one [L, ...] array."""
    mats = []
    for i in range(num_layers):
        key = pattern.format(i=i)
        if key not in sd:
            raise KeyError(f"missing weight {key}")
        m = sd[key]
        mats.append(m.T if transpose else m)
    return np.stack(mats)


def llama_config_from_hf(hf_config) -> "Any":
    """Map a transformers LlamaConfig/MistralConfig/Qwen2Config/Phi3Config."""
    from .llama import LlamaConfig

    scaling = getattr(hf_config, "rope_scaling", None)
    if scaling:
        # longrope (Phi-3-128k) / llama3 scaling rescale even short contexts;
        # silently applying plain RoPE would give wrong logits everywhere
        raise ValueError(
            f"rope_scaling={scaling.get('type', scaling.get('rope_type'))!r} "
            f"checkpoints are not supported yet — import the base "
            f"(non-scaled) variant")
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads",
                             hf_config.num_attention_heads),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rms_norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        # Qwen2 always uses QKV biases; Llama exposes an attention_bias flag
        attention_bias=bool(getattr(hf_config, "attention_bias",
                                    hf_config.model_type == "qwen2")),
        # Qwen3: decoupled head_dim + per-head q/k RMSNorm, no QKV bias
        head_dim=getattr(hf_config, "head_dim", None),
        qk_norm=hf_config.model_type == "qwen3",
    )


def llama_params_from_hf(src, cfg=None) -> Params:
    """HF LlamaForCausalLM (or compatible) weights → ``models/llama`` pytree.
    HF nn.Linear stores [out, in]; our layout is [in, out] → transpose."""
    sd = _normalize_state_dict(src)
    pfx = "model." if any(k.startswith("model.") for k in sd) else ""
    L = cfg.num_layers if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}layers\.(\d+)\.")
    lay = pfx + "layers.{i}."
    params: Params = {
        "embed": sd[pfx + "embed_tokens.weight"],
        "layers": {
            "attn_norm": _stack(sd, lay + "input_layernorm.weight", L),
            "wq": _stack(sd, lay + "self_attn.q_proj.weight", L, transpose=True),
            "wk": _stack(sd, lay + "self_attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, lay + "self_attn.v_proj.weight", L, transpose=True),
            "wo": _stack(sd, lay + "self_attn.o_proj.weight", L, transpose=True),
            "mlp_norm": _stack(sd, lay + "post_attention_layernorm.weight", L),
            "w_gate": _stack(sd, lay + "mlp.gate_proj.weight", L, transpose=True),
            "w_up": _stack(sd, lay + "mlp.up_proj.weight", L, transpose=True),
            "w_down": _stack(sd, lay + "mlp.down_proj.weight", L, transpose=True),
        },
        "final_norm": sd[pfx + "norm.weight"],
    }
    if "lm_head.weight" in sd and \
            not (cfg is not None and cfg.tie_embeddings):
        params["lm_head"] = sd["lm_head.weight"].T  # tied ckpts alias it
    has_bias = (lay.format(i=0) + "self_attn.q_proj.bias") in sd
    if has_bias:
        # Qwen2 QKV biases
        params["layers"]["bq"] = _stack(sd, lay + "self_attn.q_proj.bias", L)
        params["layers"]["bk"] = _stack(sd, lay + "self_attn.k_proj.bias", L)
        params["layers"]["bv"] = _stack(sd, lay + "self_attn.v_proj.bias", L)
    has_qk_norm = (lay.format(i=0) + "self_attn.q_norm.weight") in sd
    if has_qk_norm:
        params["layers"]["q_norm"] = _stack(sd, lay + "self_attn.q_norm.weight", L)
        params["layers"]["k_norm"] = _stack(sd, lay + "self_attn.k_norm.weight", L)
    if cfg is not None and \
            bool(getattr(cfg, "qk_norm", False)) != has_qk_norm:
        # same silent-drop class as the attention_bias check below: a
        # missing norm would silently skip in _qkv_proj; an unexpected one
        # would load leaves with no logical-axes entry
        raise ValueError(
            f"qk_norm={getattr(cfg, 'qk_norm', False)} but checkpoint "
            f"{'has' if has_qk_norm else 'lacks'} q_norm.weight tensors")
    if cfg is not None and bool(getattr(cfg, "attention_bias", False)) != has_bias:
        raise ValueError(
            f"attention_bias={getattr(cfg, 'attention_bias', False)} but "
            f"checkpoint {'has' if has_bias else 'lacks'} q_proj.bias tensors")
    log_dist(f"imported HF llama-family weights: {L} layers, "
             f"vocab {params['embed'].shape[0]}, qkv_bias={has_bias}")
    return params


def gpt2_config_from_hf(hf_config) -> "Any":
    from .gpt import GPTConfig

    return GPTConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        intermediate_size=getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        max_seq_len=hf_config.n_positions,
        layer_norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        tie_embeddings=True,
    )


def gpt2_params_from_hf(src, cfg=None) -> Params:
    """HF GPT2LMHeadModel weights → ``models/gpt`` pytree. GPT-2 Conv1D
    already stores [in, out] — no transpose."""
    sd = _normalize_state_dict(src)
    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    L = cfg.num_layers if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}h\.(\d+)\.")
    lay = pfx + "h.{i}."
    params: Params = {
        "embed": sd[pfx + "wte.weight"],
        "pos_embed": sd[pfx + "wpe.weight"],
        "layers": {
            "ln1_scale": _stack(sd, lay + "ln_1.weight", L),
            "ln1_bias": _stack(sd, lay + "ln_1.bias", L),
            "wqkv": _stack(sd, lay + "attn.c_attn.weight", L),
            "bqkv": _stack(sd, lay + "attn.c_attn.bias", L),
            "wo": _stack(sd, lay + "attn.c_proj.weight", L),
            "bo": _stack(sd, lay + "attn.c_proj.bias", L),
            "ln2_scale": _stack(sd, lay + "ln_2.weight", L),
            "ln2_bias": _stack(sd, lay + "ln_2.bias", L),
            "w_up": _stack(sd, lay + "mlp.c_fc.weight", L),
            "b_up": _stack(sd, lay + "mlp.c_fc.bias", L),
            "w_down": _stack(sd, lay + "mlp.c_proj.weight", L),
            "b_down": _stack(sd, lay + "mlp.c_proj.bias", L),
        },
        "final_ln_scale": sd[pfx + "ln_f.weight"],
        "final_ln_bias": sd[pfx + "ln_f.bias"],
    }
    log_dist(f"imported HF gpt2-family weights: {L} layers")
    return params


def opt_config_from_hf(hf_config) -> "Any":
    """Map a transformers OPTConfig onto the GPT family (pre-LN, ReLU,
    learned positions; reference ``inference/v2/model_implementations/opt``)."""
    from .gpt import GPTConfig

    if getattr(hf_config, "word_embed_proj_dim",
               hf_config.hidden_size) != hf_config.hidden_size:
        raise ValueError("OPT variants with word_embed_proj_dim != "
                         "hidden_size (opt-350m) are not supported")
    if not getattr(hf_config, "do_layer_norm_before", True):
        raise ValueError("OPT with do_layer_norm_before=False (opt-350m) "
                         "is not supported")
    act = getattr(hf_config, "activation_function", "relu")
    if act != "relu":
        # silently running a different activation would give wrong logits
        # (and HF 'gelu' is exact-erf vs jax's tanh default)
        raise ValueError(f"OPT activation_function={act!r} not supported "
                         "(only 'relu', the released OPT family)")
    return GPTConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.ffn_dim,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        max_seq_len=hf_config.max_position_embeddings,
        activation=act,
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", True)),
    )


def opt_params_from_hf(src, cfg=None) -> Params:
    """HF OPTForCausalLM → ``models/gpt`` pytree: q/k/v/out projections fuse
    into wqkv/bqkv; OPT's learned positions carry a +2 offset, dropped here
    by slicing the table."""
    sd = _normalize_state_dict(src)
    pfx = "model.decoder." if any(k.startswith("model.decoder.") for k in sd) \
        else "decoder." if any(k.startswith("decoder.") for k in sd) else ""
    L = cfg.num_layers if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}layers\.(\d+)\.")
    lay = pfx + "layers.{i}."

    def fuse_qkv(i):
        ws = [sd[lay.format(i=i) + f"self_attn.{p}_proj.weight"].T
              for p in ("q", "k", "v")]
        bs = [sd[lay.format(i=i) + f"self_attn.{p}_proj.bias"]
              for p in ("q", "k", "v")]
        return np.concatenate(ws, axis=1), np.concatenate(bs)

    fused = [fuse_qkv(i) for i in range(L)]
    params: Params = {
        "embed": sd[pfx + "embed_tokens.weight"],
        "pos_embed": sd[pfx + "embed_positions.weight"][2:],  # OPT offset
        "layers": {
            "ln1_scale": _stack(sd, lay + "self_attn_layer_norm.weight", L),
            "ln1_bias": _stack(sd, lay + "self_attn_layer_norm.bias", L),
            "wqkv": np.stack([w for w, _ in fused]),
            "bqkv": np.stack([b for _, b in fused]),
            "wo": _stack(sd, lay + "self_attn.out_proj.weight", L,
                         transpose=True),
            "bo": _stack(sd, lay + "self_attn.out_proj.bias", L),
            "ln2_scale": _stack(sd, lay + "final_layer_norm.weight", L),
            "ln2_bias": _stack(sd, lay + "final_layer_norm.bias", L),
            "w_up": _stack(sd, lay + "fc1.weight", L, transpose=True),
            "b_up": _stack(sd, lay + "fc1.bias", L),
            "w_down": _stack(sd, lay + "fc2.weight", L, transpose=True),
            "b_down": _stack(sd, lay + "fc2.bias", L),
        },
        "final_ln_scale": sd[pfx + "final_layer_norm.weight"],
        "final_ln_bias": sd[pfx + "final_layer_norm.bias"],
    }
    if cfg is not None and not cfg.tie_embeddings:
        if "lm_head.weight" not in sd:
            raise ValueError("untied OPT config but checkpoint has no "
                             "lm_head.weight")
        params["lm_head"] = sd["lm_head.weight"].T
    log_dist(f"imported HF opt weights: {L} layers")
    return params


def phi3_params_from_hf(src, cfg=None) -> Params:
    """HF Phi3ForCausalLM → ``models/llama`` pytree. Phi-3 fuses QKV into
    ``self_attn.qkv_proj`` and gate/up into ``mlp.gate_up_proj`` (reference
    ``inference/v2/model_implementations/phi3``) — split them here."""
    sd = _normalize_state_dict(src)
    pfx = "model." if any(k.startswith("model.") for k in sd) else ""
    L = cfg.num_layers if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}layers\.(\d+)\.")
    lay = pfx + "layers.{i}."
    qkv = _stack(sd, lay + "self_attn.qkv_proj.weight", L, transpose=True)
    gate_up = _stack(sd, lay + "mlp.gate_up_proj.weight", L, transpose=True)
    h = qkv.shape[1]
    if cfg is not None:
        nq = cfg.num_heads * cfg.head_size
        nkv = cfg.num_kv_heads * cfg.head_size
    else:  # phi3: q span == hidden, k/v split the rest evenly
        nq = h
        nkv = (qkv.shape[2] - nq) // 2
    inter = gate_up.shape[2] // 2
    params: Params = {
        "embed": sd[pfx + "embed_tokens.weight"],
        "layers": {
            "attn_norm": _stack(sd, lay + "input_layernorm.weight", L),
            "wq": qkv[:, :, :nq],
            "wk": qkv[:, :, nq:nq + nkv],
            "wv": qkv[:, :, nq + nkv:],
            "wo": _stack(sd, lay + "self_attn.o_proj.weight", L, transpose=True),
            "mlp_norm": _stack(sd, lay + "post_attention_layernorm.weight", L),
            "w_gate": gate_up[:, :, :inter],
            "w_up": gate_up[:, :, inter:],
            "w_down": _stack(sd, lay + "mlp.down_proj.weight", L, transpose=True),
        },
        "final_norm": sd[pfx + "norm.weight"],
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = sd["lm_head.weight"].T
    log_dist(f"imported HF phi3 weights: {L} layers (split fused qkv/gate_up)")
    return params


def mixtral_config_from_hf(hf_config) -> "Any":
    from .mixtral import MixtralConfig

    return MixtralConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads",
                             hf_config.num_attention_heads),
        num_experts=hf_config.num_local_experts,
        top_k=hf_config.num_experts_per_tok,
        # HF Mixtral routes every token (no capacity limit): disable token
        # dropping so imported logits match exactly
        drop_tokens=False,
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        rope_theta=float(getattr(hf_config, "rope_theta", 1e6)),
        rms_norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        aux_loss_coef=float(getattr(hf_config, "router_aux_loss_coef", 0.02)),
    )


def mixtral_params_from_hf(src, cfg=None) -> Params:
    """HF MixtralForCausalLM → ``models/mixtral`` pytree. Experts stack to
    [L, E, ...] (reference ``inference/v2/model_implementations/mixtral``)."""
    sd = _normalize_state_dict(src)
    pfx = "model." if any(k.startswith("model.") for k in sd) else ""
    L = cfg.num_layers if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}layers\.(\d+)\.")
    lay = pfx + "layers.{i}."
    E = cfg.num_experts if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}layers\.0\.block_sparse_moe"
                           rf"\.experts\.(\d+)\.")

    def stack_expert(w: str) -> np.ndarray:  # → [L, E, out, in] pre-transpose
        return np.stack([
            np.stack([sd[lay.format(i=i) +
                         f"block_sparse_moe.experts.{e}.{w}.weight"].T
                      for e in range(E)]) for i in range(L)])

    params: Params = {
        "embed": sd[pfx + "embed_tokens.weight"],
        "layers": {
            "attn_norm": _stack(sd, lay + "input_layernorm.weight", L),
            "wq": _stack(sd, lay + "self_attn.q_proj.weight", L, transpose=True),
            "wk": _stack(sd, lay + "self_attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, lay + "self_attn.v_proj.weight", L, transpose=True),
            "wo": _stack(sd, lay + "self_attn.o_proj.weight", L, transpose=True),
            "mlp_norm": _stack(sd, lay + "post_attention_layernorm.weight", L),
            "moe": {
                "router": _stack(sd, lay + "block_sparse_moe.gate.weight", L,
                                 transpose=True),
                "w_gate": stack_expert("w1"),
                "w_up": stack_expert("w3"),
                "w_down": stack_expert("w2"),
            },
        },
        "final_norm": sd[pfx + "norm.weight"],
        # tied checkpoints omit lm_head from the state dict — materialize the
        # transpose (models/mixtral always carries an explicit head)
        "lm_head": (sd["lm_head.weight"].T if "lm_head.weight" in sd
                    else sd[pfx + "embed_tokens.weight"].T.copy()),
    }
    log_dist(f"imported HF mixtral weights: {L} layers x {E} experts")
    return params


def qwen2_moe_config_from_hf(hf_config) -> "Any":
    """Map a transformers Qwen2MoeConfig (reference ``.../qwen_v2_moe``)."""
    from .mixtral import MixtralConfig

    if getattr(hf_config, "mlp_only_layers", None) or \
            getattr(hf_config, "decoder_sparse_step", 1) != 1:
        raise ValueError("Qwen2-MoE variants with dense interleaved layers "
                         "(mlp_only_layers/decoder_sparse_step>1) are not "
                         "supported — the layer stack must be uniform for "
                         "the scanned block")
    return MixtralConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.moe_intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=hf_config.num_key_value_heads,
        num_experts=hf_config.num_experts,
        top_k=hf_config.num_experts_per_tok,
        drop_tokens=False,
        norm_topk_prob=bool(getattr(hf_config, "norm_topk_prob", False)),
        attention_bias=True,  # Qwen2 family always carries QKV biases
        shared_expert_intermediate_size=int(
            getattr(hf_config, "shared_expert_intermediate_size", 0)),
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        rope_theta=float(getattr(hf_config, "rope_theta", 1e6)),
        rms_norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-6)),
        aux_loss_coef=float(getattr(hf_config, "router_aux_loss_coef", 0.001)),
    )


def qwen2_moe_params_from_hf(src, cfg=None) -> Params:
    """HF Qwen2MoeForCausalLM → ``models/mixtral`` pytree (+ shared expert
    and QKV biases)."""
    sd = _normalize_state_dict(src)
    pfx = "model." if any(k.startswith("model.") for k in sd) else ""
    L = cfg.num_layers if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}layers\.(\d+)\.")
    lay = pfx + "layers.{i}."
    E = cfg.num_experts if cfg is not None else \
        _count_indices(sd, rf"{re.escape(pfx)}layers\.0\.mlp\.experts"
                           rf"\.(\d+)\.")

    def stack_expert(w: str) -> np.ndarray:
        return np.stack([
            np.stack([sd[lay.format(i=i) + f"mlp.experts.{e}.{w}.weight"].T
                      for e in range(E)]) for i in range(L)])

    moe: Params = {
        "router": _stack(sd, lay + "mlp.gate.weight", L, transpose=True),
        "w_gate": stack_expert("gate_proj"),
        "w_up": stack_expert("up_proj"),
        "w_down": stack_expert("down_proj"),
        "shared_w_gate": _stack(sd, lay + "mlp.shared_expert.gate_proj.weight",
                                L, transpose=True),
        "shared_w_up": _stack(sd, lay + "mlp.shared_expert.up_proj.weight",
                              L, transpose=True),
        "shared_w_down": _stack(sd, lay + "mlp.shared_expert.down_proj.weight",
                                L, transpose=True),
        "shared_gate": _stack(sd, lay + "mlp.shared_expert_gate.weight", L,
                              transpose=True),
    }
    params: Params = {
        "embed": sd[pfx + "embed_tokens.weight"],
        "layers": {
            "attn_norm": _stack(sd, lay + "input_layernorm.weight", L),
            "wq": _stack(sd, lay + "self_attn.q_proj.weight", L, transpose=True),
            "wk": _stack(sd, lay + "self_attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, lay + "self_attn.v_proj.weight", L, transpose=True),
            "wo": _stack(sd, lay + "self_attn.o_proj.weight", L, transpose=True),
            "bq": _stack(sd, lay + "self_attn.q_proj.bias", L),
            "bk": _stack(sd, lay + "self_attn.k_proj.bias", L),
            "bv": _stack(sd, lay + "self_attn.v_proj.bias", L),
            "mlp_norm": _stack(sd, lay + "post_attention_layernorm.weight", L),
            "moe": moe,
        },
        "final_norm": sd[pfx + "norm.weight"],
        "lm_head": (sd["lm_head.weight"].T if "lm_head.weight" in sd
                    else sd[pfx + "embed_tokens.weight"].T.copy()),
    }
    log_dist(f"imported HF qwen2_moe weights: {L} layers x {E} experts "
             f"+ shared expert")
    return params


def falcon_config_from_hf(hf_config) -> "Any":
    from .falcon import FalconConfig

    if getattr(hf_config, "alibi", False):
        # models/falcon.py applies rotary embeddings; running an ALiBi
        # checkpoint through RoPE would give silently wrong logits
        raise ValueError("alibi=True falcon checkpoints are not supported — "
                         "models/falcon.py implements the RoPE variants "
                         "(7B/40B/180B); ALiBi (rw-*) needs an ALiBi "
                         "attention path")
    return FalconConfig(
        max_seq_len=int(getattr(hf_config, "max_position_embeddings", 2048)),
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=(hf_config.num_kv_heads
                      if getattr(hf_config, "new_decoder_architecture", False)
                      else (1 if getattr(hf_config, "multi_query", True)
                            else hf_config.num_attention_heads)),
        parallel_attn=bool(getattr(hf_config, "parallel_attn", True)),
        new_decoder_architecture=bool(getattr(hf_config,
                                              "new_decoder_architecture", False)),
        layer_norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        attention_bias=bool(getattr(hf_config, "bias", False)),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", True)),
    )


def falcon_params_from_hf(src, cfg) -> Params:
    """HF FalconForCausalLM → ``models/falcon`` pytree (reference
    ``inference/v2/model_implementations/falcon``). Fused-QKV layouts (HF
    ``FalconAttention._split_heads``): new decoder architecture =
    [nkv groups of (q*g | k | v)]; classic multi_query = [q-block | k | v];
    classic multi-head (rw-1b) = per-head interleaved [nh, (q | k | v)].

    ``cfg`` is required (head split depends on it) — build via
    ``falcon_config_from_hf``."""
    if cfg is None:
        raise ValueError("falcon_params_from_hf requires cfg (the fused-QKV "
                         "split depends on head counts) — build it with "
                         "falcon_config_from_hf")
    sd = _normalize_state_dict(src)
    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    L = cfg.num_layers
    lay = pfx + "h.{i}."
    if (lay.format(i=0) + "self_attention.query_key_value.bias") in sd:
        raise ValueError("falcon checkpoints with linear biases (bias=True) "
                         "are not supported — models/falcon.py has no bias "
                         "params (classic 7B/40B/180B are bias-free)")
    qkv = _stack(sd, lay + "self_attention.query_key_value.weight", L,
                 transpose=True)  # [L, h, (nh + 2*nkv) * hd]
    h = qkv.shape[1]
    nh = cfg.num_heads
    nkv = cfg.num_kv_heads
    hd = cfg.head_size
    if cfg.new_decoder_architecture:
        # interleaved [nkv groups of (q*g | k | v)]
        g = nh // nkv
        fused = qkv.reshape(L, h, nkv, g + 2, hd)
        wq = fused[:, :, :, :g].reshape(L, h, nh * hd)
        wk = fused[:, :, :, g].reshape(L, h, nkv * hd)
        wv = fused[:, :, :, g + 1].reshape(L, h, nkv * hd)
    elif nkv == nh:
        # classic multi-head (multi_query=False, e.g. rw-1b): per-head
        # interleave view(.., nh, 3, hd)
        fused = qkv.reshape(L, h, nh, 3, hd)
        wq = fused[:, :, :, 0].reshape(L, h, nh * hd)
        wk = fused[:, :, :, 1].reshape(L, h, nh * hd)
        wv = fused[:, :, :, 2].reshape(L, h, nh * hd)
    else:
        # classic multi_query (7B): [q-block | k | v]
        wq = qkv[:, :, :nh * hd]
        wk = qkv[:, :, nh * hd:(nh + nkv) * hd]
        wv = qkv[:, :, (nh + nkv) * hd:]
    params: Params = {
        "embed": sd[pfx + "word_embeddings.weight"],
        "layers": {
            "ln_attn_scale": _stack(
                sd, lay + ("ln_attn.weight" if cfg.new_decoder_architecture
                           else "input_layernorm.weight"), L),
            "ln_attn_bias": _stack(
                sd, lay + ("ln_attn.bias" if cfg.new_decoder_architecture
                           else "input_layernorm.bias"), L),
            "wq": wq, "wk": wk, "wv": wv,
            "wo": _stack(sd, lay + "self_attention.dense.weight", L,
                         transpose=True),
            "w_up": _stack(sd, lay + "mlp.dense_h_to_4h.weight", L,
                           transpose=True),
            "w_down": _stack(sd, lay + "mlp.dense_4h_to_h.weight", L,
                             transpose=True),
        },
        "final_ln_scale": sd[pfx + "ln_f.weight"],
        "final_ln_bias": sd[pfx + "ln_f.bias"],
    }
    if cfg.new_decoder_architecture:
        params["layers"]["ln_mlp_scale"] = _stack(sd, lay + "ln_mlp.weight", L)
        params["layers"]["ln_mlp_bias"] = _stack(sd, lay + "ln_mlp.bias", L)
    elif not cfg.parallel_attn:
        # sequential classic blocks carry a distinct second norm
        params["layers"]["ln_mlp_scale"] = _stack(
            sd, lay + "post_attention_layernorm.weight", L)
        params["layers"]["ln_mlp_bias"] = _stack(
            sd, lay + "post_attention_layernorm.bias", L)
    if "lm_head.weight" in sd and not cfg.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T  # tied ckpts alias it
    log_dist(f"imported HF falcon weights: {L} layers (nkv={nkv})")
    return params


def _split_fused_qkv(w: np.ndarray, nh: int, hd: int):
    """De-interleave an HF fused query_key_value projection whose output rows
    are grouped per head as [q(hd); k(hd); v(hd)] (GPT-NeoX views the fused
    tensor as (nh, 3*hd), BLOOM as (nh, 3, hd) — the same row layout).
    w: [3*nh*hd, in] or bias [3*nh*hd] → (q, k, v) each [nh*hd(, in)]."""
    shape = (nh, 3, hd) + w.shape[1:]
    grouped = w.reshape(shape)
    return tuple(grouped[:, j].reshape((nh * hd,) + w.shape[1:])
                 for j in range(3))


def gptneox_config_from_hf(hf_config) -> "Any":
    from .gptneox import GPTNeoXConfig

    return GPTNeoXConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        max_seq_len=hf_config.max_position_embeddings,
        rotary_pct=float(getattr(hf_config, "rotary_pct", 1.0)),
        rope_theta=float(getattr(hf_config, "rotary_emb_base", 10000.0)),
        parallel_residual=bool(getattr(hf_config, "use_parallel_residual",
                                       True)),
        gelu_approx=getattr(hf_config, "hidden_act", "gelu") in
        ("gelu_new", "gelu_pytorch_tanh", "gelu_fast"),
        layer_norm_eps=float(getattr(hf_config, "layer_norm_eps", 1e-5)),
    )


def gptneox_params_from_hf(src, cfg=None) -> Params:
    """HF GPTNeoXForCausalLM → ``models/gptneox`` pytree (fused QKV is
    de-interleaved per head so TP can shard the heads axis)."""
    sd = _normalize_state_dict(src)
    L = cfg.num_layers
    nh, hd = cfg.num_heads, cfg.head_size
    lay = "gpt_neox.layers.{i}."
    qkv_w = _stack(sd, lay + "attention.query_key_value.weight", L)
    qkv_b = _stack(sd, lay + "attention.query_key_value.bias", L)
    wq, wk, wv = zip(*(_split_fused_qkv(w, nh, hd) for w in qkv_w))
    bq, bk, bv = zip(*(_split_fused_qkv(b, nh, hd) for b in qkv_b))
    params: Params = {
        "embed": sd["gpt_neox.embed_in.weight"],
        "layers": {
            "ln1_scale": _stack(sd, lay + "input_layernorm.weight", L),
            "ln1_bias": _stack(sd, lay + "input_layernorm.bias", L),
            "ln2_scale": _stack(sd, lay + "post_attention_layernorm.weight", L),
            "ln2_bias": _stack(sd, lay + "post_attention_layernorm.bias", L),
            "wq": np.stack([w.T for w in wq]),
            "wk": np.stack([w.T for w in wk]),
            "wv": np.stack([w.T for w in wv]),
            "bq": np.stack(bq), "bk": np.stack(bk), "bv": np.stack(bv),
            "wo": _stack(sd, lay + "attention.dense.weight", L, transpose=True),
            "bo": _stack(sd, lay + "attention.dense.bias", L),
            "w_up": _stack(sd, lay + "mlp.dense_h_to_4h.weight", L,
                           transpose=True),
            "b_up": _stack(sd, lay + "mlp.dense_h_to_4h.bias", L),
            "w_down": _stack(sd, lay + "mlp.dense_4h_to_h.weight", L,
                             transpose=True),
            "b_down": _stack(sd, lay + "mlp.dense_4h_to_h.bias", L),
        },
        "final_ln_scale": sd["gpt_neox.final_layer_norm.weight"],
        "final_ln_bias": sd["gpt_neox.final_layer_norm.bias"],
        "lm_head": sd["embed_out.weight"].T,
    }
    log_dist(f"imported HF gpt_neox weights: {L} layers")
    return params


def gptj_config_from_hf(hf_config) -> "Any":
    from .gptneox import GPTNeoXConfig

    inner = getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd
    # HF GPT-J rotates the FULL head dim when rotary_dim is None
    rotary_dim = getattr(hf_config, "rotary_dim", None)
    if rotary_dim is None:
        rotary_dim = hf_config.n_embd // hf_config.n_head
    return GPTNeoXConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        intermediate_size=inner,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        max_seq_len=hf_config.n_positions,
        rotary_dim=rotary_dim,
        rotary_interleaved=True,
        shared_ln=True,
        qkv_bias=False,
        attn_out_bias=False,
        lm_head_bias=True,
        gelu_approx=True,   # 'gelu_new'
        layer_norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
    )


def gptj_params_from_hf(src, cfg=None) -> Params:
    """HF GPTJForCausalLM → ``models/gptneox`` pytree (shared-ln variant)."""
    sd = _normalize_state_dict(src)
    L = cfg.num_layers
    lay = "transformer.h.{i}."
    params: Params = {
        "embed": sd["transformer.wte.weight"],
        "layers": {
            "ln1_scale": _stack(sd, lay + "ln_1.weight", L),
            "ln1_bias": _stack(sd, lay + "ln_1.bias", L),
            "wq": _stack(sd, lay + "attn.q_proj.weight", L, transpose=True),
            "wk": _stack(sd, lay + "attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, lay + "attn.v_proj.weight", L, transpose=True),
            "wo": _stack(sd, lay + "attn.out_proj.weight", L, transpose=True),
            "w_up": _stack(sd, lay + "mlp.fc_in.weight", L, transpose=True),
            "b_up": _stack(sd, lay + "mlp.fc_in.bias", L),
            "w_down": _stack(sd, lay + "mlp.fc_out.weight", L, transpose=True),
            "b_down": _stack(sd, lay + "mlp.fc_out.bias", L),
        },
        "final_ln_scale": sd["transformer.ln_f.weight"],
        "final_ln_bias": sd["transformer.ln_f.bias"],
        "lm_head": sd["lm_head.weight"].T,
        "lm_head_bias": sd["lm_head.bias"],
    }
    log_dist(f"imported HF gptj weights: {L} layers")
    return params


def bloom_config_from_hf(hf_config) -> "Any":
    from .bloom import BloomConfig

    return BloomConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        max_seq_len=getattr(hf_config, "seq_length", 2048),
        layer_norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
    )


def bloom_params_from_hf(src, cfg=None) -> Params:
    """HF BloomForCausalLM → ``models/bloom`` pytree. The fused
    query_key_value rows are per-head [q;k;v] groups — same layout as
    GPT-NeoX — de-interleaved here so the TP rules shard heads."""
    sd = _normalize_state_dict(src)
    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    L = cfg.num_layers
    nh, hd = cfg.num_heads, cfg.head_size
    lay = pfx + "h.{i}."
    qkv_w = _stack(sd, lay + "self_attention.query_key_value.weight", L)
    qkv_b = _stack(sd, lay + "self_attention.query_key_value.bias", L)
    wq, wk, wv = zip(*(_split_fused_qkv(w, nh, hd) for w in qkv_w))
    bq, bk, bv = zip(*(_split_fused_qkv(b, nh, hd) for b in qkv_b))
    params: Params = {
        "embed": sd[pfx + "word_embeddings.weight"],
        "embed_ln_scale": sd[pfx + "word_embeddings_layernorm.weight"],
        "embed_ln_bias": sd[pfx + "word_embeddings_layernorm.bias"],
        "layers": {
            "ln1_scale": _stack(sd, lay + "input_layernorm.weight", L),
            "ln1_bias": _stack(sd, lay + "input_layernorm.bias", L),
            "wq": np.stack([w.T for w in wq]),
            "wk": np.stack([w.T for w in wk]),
            "wv": np.stack([w.T for w in wv]),
            "bq": np.stack(bq), "bk": np.stack(bk), "bv": np.stack(bv),
            "wo": _stack(sd, lay + "self_attention.dense.weight", L,
                         transpose=True),
            "bo": _stack(sd, lay + "self_attention.dense.bias", L),
            "ln2_scale": _stack(sd, lay + "post_attention_layernorm.weight", L),
            "ln2_bias": _stack(sd, lay + "post_attention_layernorm.bias", L),
            "w_up": _stack(sd, lay + "mlp.dense_h_to_4h.weight", L,
                           transpose=True),
            "b_up": _stack(sd, lay + "mlp.dense_h_to_4h.bias", L),
            "w_down": _stack(sd, lay + "mlp.dense_4h_to_h.weight", L,
                             transpose=True),
            "b_down": _stack(sd, lay + "mlp.dense_4h_to_h.bias", L),
        },
        "final_ln_scale": sd[pfx + "ln_f.weight"],
        "final_ln_bias": sd[pfx + "ln_f.bias"],
    }
    log_dist(f"imported HF bloom weights: {L} layers (alibi heads={nh})")
    return params




def bert_config_from_hf(hf_config) -> "Any":
    from .bert import BertConfig

    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        max_seq_len=hf_config.max_position_embeddings,
        type_vocab_size=getattr(hf_config, "type_vocab_size", 2),
        layer_norm_eps=float(getattr(hf_config, "layer_norm_eps", 1e-12)),
        gelu_approx=getattr(hf_config, "hidden_act", "gelu") in
        ("gelu_new", "gelu_pytorch_tanh", "gelu_fast"),
    )


def bert_params_from_hf(src, cfg=None) -> Params:
    """HF BertModel / BertFor* → ``models/bert`` pytree (q/k/v fused into
    one [h, 3h] block column-wise; the MLM head stays the tied embedding)."""
    sd = _normalize_state_dict(src)
    pfx = "bert." if any(k.startswith("bert.") for k in sd) else ""
    L = cfg.num_layers
    lay = pfx + "encoder.layer.{i}."

    def qkv_w(i):
        return np.concatenate(
            [sd[lay.format(i=i) + f"attention.self.{n}.weight"].T
             for n in ("query", "key", "value")], axis=1)

    def qkv_b(i):
        return np.concatenate(
            [sd[lay.format(i=i) + f"attention.self.{n}.bias"]
             for n in ("query", "key", "value")])

    emb = pfx + "embeddings."
    params: Params = {
        "embed": sd[emb + "word_embeddings.weight"],
        "pos_embed": sd[emb + "position_embeddings.weight"],
        "type_embed": sd[emb + "token_type_embeddings.weight"],
        "embed_ln_scale": sd[emb + "LayerNorm.weight"],
        "embed_ln_bias": sd[emb + "LayerNorm.bias"],
        "layers": {
            "wqkv": np.stack([qkv_w(i) for i in range(L)]),
            "bqkv": np.stack([qkv_b(i) for i in range(L)]),
            "wo": _stack(sd, lay + "attention.output.dense.weight", L,
                         transpose=True),
            "bo": _stack(sd, lay + "attention.output.dense.bias", L),
            "attn_ln_scale": _stack(sd, lay + "attention.output.LayerNorm.weight", L),
            "attn_ln_bias": _stack(sd, lay + "attention.output.LayerNorm.bias", L),
            "w_up": _stack(sd, lay + "intermediate.dense.weight", L,
                           transpose=True),
            "b_up": _stack(sd, lay + "intermediate.dense.bias", L),
            "w_down": _stack(sd, lay + "output.dense.weight", L,
                             transpose=True),
            "b_down": _stack(sd, lay + "output.dense.bias", L),
            "mlp_ln_scale": _stack(sd, lay + "output.LayerNorm.weight", L),
            "mlp_ln_bias": _stack(sd, lay + "output.LayerNorm.bias", L),
        },
    }
    h = cfg.hidden_size
    if pfx + "pooler.dense.weight" in sd:
        params["pooler_w"] = sd[pfx + "pooler.dense.weight"].T
        params["pooler_b"] = sd[pfx + "pooler.dense.bias"]
    else:
        params["pooler_w"] = np.zeros((h, h), np.float32)
        params["pooler_b"] = np.zeros((h,), np.float32)
    log_dist(f"imported HF bert weights: {L} layers")
    return params


def distilbert_config_from_hf(hf_config) -> "Any":
    from .bert import BertConfig

    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.dim,
        intermediate_size=hf_config.hidden_dim,
        num_layers=hf_config.n_layers,
        num_heads=hf_config.n_heads,
        max_seq_len=hf_config.max_position_embeddings,
        type_vocab_size=1,   # DistilBERT drops token-type embeddings
        layer_norm_eps=1e-12,
        gelu_approx=getattr(hf_config, "activation", "gelu") in
        ("gelu_new", "gelu_pytorch_tanh", "gelu_fast"),
    )


def distilbert_params_from_hf(src, cfg=None) -> Params:
    """HF DistilBertModel / DistilBertFor* → ``models/bert`` pytree
    (reference policy ``module_inject/containers/distil_bert.py``). The
    missing token-type table becomes a zero row; the missing pooler becomes
    zeros (pooled output is then a constant — DistilBERT has none)."""
    sd = _normalize_state_dict(src)
    pfx = "distilbert." if any(k.startswith("distilbert.") for k in sd) else ""
    L, h = cfg.num_layers, cfg.hidden_size
    lay = pfx + "transformer.layer.{i}."

    def qkv_w(i):
        return np.concatenate(
            [sd[lay.format(i=i) + f"attention.{n}.weight"].T
             for n in ("q_lin", "k_lin", "v_lin")], axis=1)

    def qkv_b(i):
        return np.concatenate(
            [sd[lay.format(i=i) + f"attention.{n}.bias"]
             for n in ("q_lin", "k_lin", "v_lin")])

    emb = pfx + "embeddings."
    params: Params = {
        "embed": sd[emb + "word_embeddings.weight"],
        "pos_embed": sd[emb + "position_embeddings.weight"],
        "type_embed": np.zeros((1, h), np.float32),
        "embed_ln_scale": sd[emb + "LayerNorm.weight"],
        "embed_ln_bias": sd[emb + "LayerNorm.bias"],
        "layers": {
            "wqkv": np.stack([qkv_w(i) for i in range(L)]),
            "bqkv": np.stack([qkv_b(i) for i in range(L)]),
            "wo": _stack(sd, lay + "attention.out_lin.weight", L,
                         transpose=True),
            "bo": _stack(sd, lay + "attention.out_lin.bias", L),
            "attn_ln_scale": _stack(sd, lay + "sa_layer_norm.weight", L),
            "attn_ln_bias": _stack(sd, lay + "sa_layer_norm.bias", L),
            "w_up": _stack(sd, lay + "ffn.lin1.weight", L, transpose=True),
            "b_up": _stack(sd, lay + "ffn.lin1.bias", L),
            "w_down": _stack(sd, lay + "ffn.lin2.weight", L, transpose=True),
            "b_down": _stack(sd, lay + "ffn.lin2.bias", L),
            "mlp_ln_scale": _stack(sd, lay + "output_layer_norm.weight", L),
            "mlp_ln_bias": _stack(sd, lay + "output_layer_norm.bias", L),
        },
        "pooler_w": np.zeros((h, h), np.float32),
        "pooler_b": np.zeros((h,), np.float32),
    }
    log_dist(f"imported HF distilbert weights: {L} layers")
    return params


def megatron_gpt_params_from_sd(sd, cfg=None, ckpt_ver=None) -> Params:
    """Megatron-GPT state dict (merged to TP=1 via ``SDLoaderFactory``) →
    ``models/gpt`` pytree (reference policy
    ``module_inject/containers/megatron_gpt.py`` + ``MegatronSDLoader``).

    The fused query_key_value layouts by checkpoint version (reference
    ``state_dict_factory.py:220``): v0 = whole-tensor [q;k;v] blocks (the
    GPT-2 layout our model uses directly); v2 = per-head [q;k;v] groups,
    de-interleaved here. v1.0's (np·hn·3) ordering is rejected."""
    if ckpt_ver is None:
        # read the version BEFORE unwrapping 'module' (it lives at the top
        # level of Megatron checkpoints); default 0 matches
        # SDLoaderBase.get_checkpoint_version — defaulting to 2 would
        # silently scramble v0 whole-block QKV tensors as per-head groups
        ckpt_ver = sd.get("checkpoint_version",
                          sd.get("module", {}).get("checkpoint_version", 0))
    sd = {k: _to_numpy(v) for k, v in (sd.get("module", sd)).items()
          if k != "checkpoint_version"}
    # strip megatron prefixes down to the transformer block names
    def find(suffix):
        hits = [k for k in sd if k.endswith(suffix)]
        if len(hits) != 1:
            raise KeyError(f"expected exactly one key ending {suffix!r}, "
                           f"got {hits}")
        return sd[hits[0]]

    L = _count_indices(sd, r".*?layers\.(\d+)\.")
    nh, hd = (cfg.num_heads, cfg.head_size) if cfg is not None else (None, None)

    def layer(i, suffix):
        return find(f"layers.{i}.{suffix}")

    def qkv_to_gpt2(w):
        """[3h(, h)] megatron fused → [q|k|v] blocks (transposed for weights)."""
        if ckpt_ver in (0, 0.0):
            out = w  # already [q;k;v] whole blocks
        elif ckpt_ver in (2, 2.0):
            assert nh is not None, "cfg (num_heads) required for v2 layout"
            grouped = w.reshape((nh, 3, hd) + w.shape[1:])
            out = np.concatenate(
                [grouped[:, j].reshape((nh * hd,) + w.shape[1:])
                 for j in range(3)], axis=0)
        else:
            raise ValueError(f"unsupported megatron checkpoint_version "
                             f"{ckpt_ver} (v0 and v2 layouts supported)")
        return out.T if out.ndim == 2 else out

    params: Params = {
        "embed": find("word_embeddings.weight"),
        "pos_embed": find("position_embeddings.weight"),
        "layers": {
            "ln1_scale": np.stack([layer(i, "input_layernorm.weight")
                                   for i in range(L)]),
            "ln1_bias": np.stack([layer(i, "input_layernorm.bias")
                                  for i in range(L)]),
            "wqkv": np.stack([qkv_to_gpt2(
                layer(i, "attention.query_key_value.weight"))
                for i in range(L)]),
            "bqkv": np.stack([qkv_to_gpt2(
                layer(i, "attention.query_key_value.bias"))
                for i in range(L)]),
            "wo": np.stack([layer(i, "attention.dense.weight").T
                            for i in range(L)]),
            "bo": np.stack([layer(i, "attention.dense.bias")
                            for i in range(L)]),
            "ln2_scale": np.stack([layer(i, "post_attention_layernorm.weight")
                                   for i in range(L)]),
            "ln2_bias": np.stack([layer(i, "post_attention_layernorm.bias")
                                  for i in range(L)]),
            "w_up": np.stack([layer(i, "mlp.dense_h_to_4h.weight").T
                              for i in range(L)]),
            "b_up": np.stack([layer(i, "mlp.dense_h_to_4h.bias")
                              for i in range(L)]),
            "w_down": np.stack([layer(i, "mlp.dense_4h_to_h.weight").T
                                for i in range(L)]),
            "b_down": np.stack([layer(i, "mlp.dense_4h_to_h.bias")
                                for i in range(L)]),
        },
        "final_ln_scale": find("final_layernorm.weight"),
        "final_ln_bias": find("final_layernorm.bias"),
    }
    log_dist(f"imported megatron-gpt weights: {L} layers "
             f"(ckpt_ver={ckpt_ver})")
    return params


def clip_config_from_hf(hf_config) -> "Any":
    from .clip import CLIPConfig, CLIPTowerConfig

    t, v = hf_config.text_config, hf_config.vision_config
    return CLIPConfig(
        vocab_size=t.vocab_size,
        max_seq_len=t.max_position_embeddings,
        eos_token_id=t.eos_token_id,
        text=CLIPTowerConfig(hidden_size=t.hidden_size,
                             intermediate_size=t.intermediate_size,
                             num_layers=t.num_hidden_layers,
                             num_heads=t.num_attention_heads,
                             layer_norm_eps=float(t.layer_norm_eps),
                             hidden_act=getattr(t, "hidden_act",
                                                "quick_gelu")),
        image_size=v.image_size,
        patch_size=v.patch_size,
        num_channels=getattr(v, "num_channels", 3),
        vision=CLIPTowerConfig(hidden_size=v.hidden_size,
                               intermediate_size=v.intermediate_size,
                               num_layers=v.num_hidden_layers,
                               num_heads=v.num_attention_heads,
                               layer_norm_eps=float(v.layer_norm_eps),
                               hidden_act=getattr(v, "hidden_act",
                                                  "quick_gelu")),
        projection_dim=hf_config.projection_dim,
    )


def _clip_tower_from_hf(sd, prefix: str, L: int) -> Params:
    lay = prefix + "encoder.layers.{i}."
    return {
        "ln1_scale": _stack(sd, lay + "layer_norm1.weight", L),
        "ln1_bias": _stack(sd, lay + "layer_norm1.bias", L),
        "wq": _stack(sd, lay + "self_attn.q_proj.weight", L, transpose=True),
        "bq": _stack(sd, lay + "self_attn.q_proj.bias", L),
        "wk": _stack(sd, lay + "self_attn.k_proj.weight", L, transpose=True),
        "bk": _stack(sd, lay + "self_attn.k_proj.bias", L),
        "wv": _stack(sd, lay + "self_attn.v_proj.weight", L, transpose=True),
        "bv": _stack(sd, lay + "self_attn.v_proj.bias", L),
        "wo": _stack(sd, lay + "self_attn.out_proj.weight", L, transpose=True),
        "bo": _stack(sd, lay + "self_attn.out_proj.bias", L),
        "ln2_scale": _stack(sd, lay + "layer_norm2.weight", L),
        "ln2_bias": _stack(sd, lay + "layer_norm2.bias", L),
        "w_up": _stack(sd, lay + "mlp.fc1.weight", L, transpose=True),
        "b_up": _stack(sd, lay + "mlp.fc1.bias", L),
        "w_down": _stack(sd, lay + "mlp.fc2.weight", L, transpose=True),
        "b_down": _stack(sd, lay + "mlp.fc2.bias", L),
    }


def clip_params_from_hf(src, cfg=None) -> Params:
    """HF CLIPModel → ``models/clip`` pytree. The vision conv patch embed
    (out, c, p, p) flattens to the unfold+matmul layout [c·p·p, out]."""
    if cfg is None:
        if not hasattr(src, "config"):
            raise ValueError("clip_params_from_hf needs cfg= when given a "
                             "bare state dict (no .config to derive it from)")
        cfg = clip_config_from_hf(src.config)
    sd = _normalize_state_dict(src)
    h_v = cfg.vision.hidden_size
    params: Params = {
        "text": {
            "embed": sd["text_model.embeddings.token_embedding.weight"],
            "pos_embed": sd["text_model.embeddings.position_embedding.weight"],
            "layers": _clip_tower_from_hf(sd, "text_model.",
                                          cfg.text.num_layers),
            "final_ln_scale": sd["text_model.final_layer_norm.weight"],
            "final_ln_bias": sd["text_model.final_layer_norm.bias"],
        },
        "vision": {
            "class_embed": sd["vision_model.embeddings.class_embedding"],
            "patch_embed": sd["vision_model.embeddings.patch_embedding.weight"]
            .reshape(h_v, -1).T,
            "pos_embed": sd["vision_model.embeddings.position_embedding.weight"],
            "pre_ln_scale": sd["vision_model.pre_layrnorm.weight"],
            "pre_ln_bias": sd["vision_model.pre_layrnorm.bias"],
            "layers": _clip_tower_from_hf(sd, "vision_model.",
                                          cfg.vision.num_layers),
            "post_ln_scale": sd["vision_model.post_layernorm.weight"],
            "post_ln_bias": sd["vision_model.post_layernorm.bias"],
        },
        "text_projection": sd["text_projection.weight"].T,
        "visual_projection": sd["visual_projection.weight"].T,
        "logit_scale": sd["logit_scale"],
    }
    log_dist(f"imported HF clip weights: text {cfg.text.num_layers}L / "
             f"vision {cfg.vision.num_layers}L")
    return params


def exaone4_config_from_hf(hf_config) -> "Any":
    from .exaone4 import Exaone4Config

    if getattr(hf_config, "rope_scaling", None):
        # same hazard as the llama guard: silently applying plain RoPE to a
        # scaled-rope checkpoint gives wrong logits everywhere
        raise ValueError(
            "rope_scaling checkpoints are not supported yet — import the "
            "base (non-scaled) EXAONE-4 variant")
    return Exaone4Config(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads",
                             hf_config.num_attention_heads),
        head_dim=getattr(hf_config, "head_dim", None),
        max_seq_len=hf_config.max_position_embeddings,
        sliding_window=getattr(hf_config, "sliding_window", None),
        sliding_window_pattern=getattr(hf_config, "sliding_window_pattern",
                                       4) or 4,
        rope_theta=float(getattr(hf_config, "rope_theta", 1000000.0)),
        rms_norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        layer_types=tuple(hf_config.layer_types)
        if getattr(hf_config, "layer_types", None) else None,
    )


def exaone4_params_from_hf(src, cfg=None) -> Params:
    """HF Exaone4ForCausalLM → ``models/exaone4`` pytree (post-norm +
    QK-norm + hybrid attention)."""
    sd = _normalize_state_dict(src)
    L = cfg.num_layers
    lay = "model.layers.{i}."
    params: Params = {
        "embed": sd["model.embed_tokens.weight"],
        "layers": {
            "wq": _stack(sd, lay + "self_attn.q_proj.weight", L,
                         transpose=True),
            "wk": _stack(sd, lay + "self_attn.k_proj.weight", L,
                         transpose=True),
            "wv": _stack(sd, lay + "self_attn.v_proj.weight", L,
                         transpose=True),
            "wo": _stack(sd, lay + "self_attn.o_proj.weight", L,
                         transpose=True),
            "q_norm": _stack(sd, lay + "self_attn.q_norm.weight", L),
            "k_norm": _stack(sd, lay + "self_attn.k_norm.weight", L),
            "post_attn_norm": _stack(
                sd, lay + "post_attention_layernorm.weight", L),
            "w_gate": _stack(sd, lay + "mlp.gate_proj.weight", L,
                             transpose=True),
            "w_up": _stack(sd, lay + "mlp.up_proj.weight", L, transpose=True),
            "w_down": _stack(sd, lay + "mlp.down_proj.weight", L,
                             transpose=True),
            "post_mlp_norm": _stack(
                sd, lay + "post_feedforward_layernorm.weight", L),
        },
        "final_norm": sd["model.norm.weight"],
    }
    if "lm_head.weight" in sd and not cfg.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T
    log_dist(f"imported HF exaone4 weights: {L} layers "
             f"(types={cfg.resolved_layer_types()[:4]}...)")
    return params



# --------------------------------------------------------------------------- #
# family resolution and the live-model entry points (JAX :1156-1238)
# --------------------------------------------------------------------------- #
def resolve_module(family: str):
    """Family name → the ``deepspeed_tpu_torch.models`` module that runs it."""
    from . import bert, bloom, clip, exaone4, falcon, gpt, gptneox, llama, mixtral

    modules = {
        "llama": llama, "mistral": llama, "qwen2": llama, "qwen3": llama,
        "phi3": llama,
        "gpt2": gpt, "opt": gpt,
        "mixtral": mixtral, "qwen2_moe": mixtral,
        "falcon": falcon,
        "gpt_neox": gptneox, "gptj": gptneox,
        "bloom": bloom,
        "bert": bert, "distilbert": bert,
        "clip": clip,
        "exaone4": exaone4,
    }
    if family not in modules:
        raise ValueError(f"unsupported HF family '{family}' "
                         f"(supported: {sorted(modules)})")
    return modules[family]


def is_hf_model(model) -> bool:
    """True for a live transformers/torch model (as opposed to a ModelSpec
    or one of our model modules): duck-typed, no ``transformers`` import."""
    return (hasattr(model, "state_dict") and callable(model.state_dict)
            and hasattr(model, "config")
            and hasattr(model.config, "model_type"))


def spec_from_hf(model, family: Optional[str] = None, compute_dtype=None):
    """Live transformers model → a ``ModelSpec`` carrying the imported
    weights in the port's layout (``models/convert.py``), as the JAX
    package's ``spec_from_hf`` makes ``initialize(model=hf_model)`` work;
    ``compute_dtype`` defaults to bf16."""
    import dataclasses

    import torch

    from .convert import from_jax_params

    family = family or getattr(model.config, "model_type", None)
    module = resolve_module(family)
    cfg, params = from_hf(model, family)
    spec = module.model_spec(cfg, compute_dtype=compute_dtype or torch.bfloat16)
    return dataclasses.replace(spec, params=from_jax_params(cfg, params))


_FAMILIES = {
    "llama": (llama_config_from_hf, llama_params_from_hf),
    "mistral": (llama_config_from_hf, llama_params_from_hf),
    "qwen2": (llama_config_from_hf, llama_params_from_hf),
    "qwen3": (llama_config_from_hf, llama_params_from_hf),
    "phi3": (llama_config_from_hf, phi3_params_from_hf),
    "gpt2": (gpt2_config_from_hf, gpt2_params_from_hf),
    "opt": (opt_config_from_hf, opt_params_from_hf),
    "mixtral": (mixtral_config_from_hf, mixtral_params_from_hf),
    "qwen2_moe": (qwen2_moe_config_from_hf, qwen2_moe_params_from_hf),
    "falcon": (falcon_config_from_hf, falcon_params_from_hf),
    "gpt_neox": (gptneox_config_from_hf, gptneox_params_from_hf),
    "gptj": (gptj_config_from_hf, gptj_params_from_hf),
    "bloom": (bloom_config_from_hf, bloom_params_from_hf),
    "bert": (bert_config_from_hf, bert_params_from_hf),
    "distilbert": (distilbert_config_from_hf, distilbert_params_from_hf),
    "clip": (clip_config_from_hf, clip_params_from_hf),
    "exaone4": (exaone4_config_from_hf, exaone4_params_from_hf),
}


def from_hf(model, family: Optional[str] = None):
    """One-stop conversion: (our_config, our_params) from a transformers
    model instance (or :class:`HFCheckpoint`). Family is sniffed from
    ``model.config.model_type``. The params are the JAX package's tree
    (numpy leaves); ``models/convert.py`` ``from_jax_params`` gives the
    port's ``state_dict``."""
    family = family or getattr(model.config, "model_type", None)
    if family not in _FAMILIES:
        raise ValueError(f"unsupported HF family '{family}' "
                         f"(supported: {sorted(_FAMILIES)})")
    cfg_fn, params_fn = _FAMILIES[family]
    cfg = cfg_fn(model.config)
    return cfg, params_fn(model, cfg)


# --------------------------------------------------------------------------- #
# a local HF directory without transformers
# --------------------------------------------------------------------------- #
# The class defaults (transformers' config classes) of every attribute the
# mappers read, for each family: only attributes the class has (a mapper's
# getattr default applies to the rest). None where the class derives the
# value (see hf_config).
_LLAMA_LIKE = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
               "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
               "rope_theta", "rms_norm_eps", "tie_word_embeddings")
CONFIG_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": dict(zip(_LLAMA_LIKE, (32000, 4096, 11008, 32, 32, None, 2048, 10000.0, 1e-6,
                                    False)),
                  attention_bias=False, head_dim=None, rope_scaling=None),
    "mistral": dict(zip(_LLAMA_LIKE, (32000, 4096, 14336, 32, 32, 8, 131072, 10000.0, 1e-6,
                                      False)), head_dim=None),
    "qwen2": dict(zip(_LLAMA_LIKE, (151936, 4096, 22016, 32, 32, 32, 32768, 10000.0, 1e-6,
                                    False)), rope_scaling=None),
    "qwen3": dict(zip(_LLAMA_LIKE, (151936, 4096, 22016, 32, 32, 32, 32768, 10000.0, 1e-6,
                                    False)),
                  attention_bias=False, head_dim=128, rope_scaling=None),
    "phi3": dict(zip(_LLAMA_LIKE, (32064, 3072, 8192, 32, 32, None, 4096, 10000.0, 1e-5,
                                   False)), rope_scaling=None),
    "exaone4": dict(zip(_LLAMA_LIKE, (102400, 4096, 16384, 32, 32, 32, 2048, 10000.0, 1e-5,
                                      False)),
                    rope_scaling=None, sliding_window=4096, sliding_window_pattern=4,
                    layer_types=None),
    "mixtral": dict(zip(_LLAMA_LIKE, (32000, 4096, 14336, 32, 32, 8, 131072, 1e6, 1e-5,
                                      False)),
                    head_dim=None, num_local_experts=8, num_experts_per_tok=2,
                    router_aux_loss_coef=0.001),
    "qwen2_moe": dict(zip(_LLAMA_LIKE, (151936, 2048, 5632, 24, 16, 16, 32768, 10000.0,
                                        1e-6, False)),
                      rope_scaling=None, num_experts_per_tok=4, router_aux_loss_coef=0.001,
                      mlp_only_layers=None, decoder_sparse_step=1, moe_intermediate_size=1408,
                      num_experts=60, norm_topk_prob=False,
                      shared_expert_intermediate_size=5632),
    "gpt2": dict(vocab_size=50257, n_embd=768, n_inner=None, n_layer=12, n_head=12,
                 n_positions=1024, layer_norm_epsilon=1e-5, tie_word_embeddings=True),
    "opt": dict(vocab_size=50272, hidden_size=768, ffn_dim=3072, num_hidden_layers=12,
                num_attention_heads=12, max_position_embeddings=2048, word_embed_proj_dim=None,
                do_layer_norm_before=True, activation_function="relu",
                tie_word_embeddings=True),
    "falcon": dict(vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
                   num_attention_heads=71, num_kv_heads=None, max_position_embeddings=2048,
                   rope_theta=10000.0, layer_norm_epsilon=1e-5, alibi=False,
                   new_decoder_architecture=False, multi_query=True, parallel_attn=True,
                   bias=False, tie_word_embeddings=True),
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144, intermediate_size=24576,
                     num_hidden_layers=44, num_attention_heads=64, max_position_embeddings=2048,
                     rotary_pct=0.25, rotary_emb_base=10000, use_parallel_residual=True,
                     hidden_act="gelu", layer_norm_eps=1e-5, tie_word_embeddings=False),
    "gptj": dict(vocab_size=50400, n_embd=4096, n_inner=None, n_layer=28, n_head=16,
                 n_positions=2048, rotary_dim=64, layer_norm_epsilon=1e-5,
                 tie_word_embeddings=False),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5, tie_word_embeddings=True),
    "bert": dict(vocab_size=30522, hidden_size=768, intermediate_size=3072,
                 num_hidden_layers=12, num_attention_heads=12, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu",
                 tie_word_embeddings=True),
    "distilbert": dict(vocab_size=30522, dim=768, hidden_dim=3072, n_layers=6, n_heads=12,
                       max_position_embeddings=512, activation="gelu",
                       tie_word_embeddings=True),
    "clip": dict(projection_dim=512, tie_word_embeddings=True),
    "clip_text_model": dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                            num_hidden_layers=12, num_attention_heads=8,
                            max_position_embeddings=77, layer_norm_eps=1e-5,
                            hidden_act="quick_gelu", eos_token_id=49407),
    "clip_vision_model": dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                              num_attention_heads=12, layer_norm_eps=1e-5,
                              hidden_act="quick_gelu", image_size=224, patch_size=32,
                              num_channels=3),
}
# transformers' ``attribute_map`` of the config classes that have one: the
# alias a config.json may use → the attribute it sets
_GPT2_ALIASES = {"hidden_size": "n_embd", "max_position_embeddings": "n_positions",
                 "num_attention_heads": "n_head", "num_hidden_layers": "n_layer"}
ATTRIBUTE_MAPS: Dict[str, Dict[str, str]] = {
    "gpt2": _GPT2_ALIASES, "gptj": dict(_GPT2_ALIASES),
    "bloom": {"num_hidden_layers": "n_layer", "num_attention_heads": "n_head"},
    "distilbert": {"hidden_size": "dim", "num_attention_heads": "n_heads",
                   "num_hidden_layers": "n_layers"},
}

# The class the JAX package's loader lands on for each family (the causal-LM
# class, else the base class): its base-model prefix, whether its keys carry
# it, its (head, input embedding) keys when the head can be tied, and the
# keys of the file it drops that a mapper would read.
LOADED_CLASS: Dict[str, Dict[str, Any]] = {
    **{f: dict(prefix="model", prefixed=True,
               tie=("lm_head.weight", "model.embed_tokens.weight"))
       for f in ("llama", "mistral", "qwen2", "qwen3", "phi3", "mixtral", "qwen2_moe",
                 "exaone4")},
    "gpt2": dict(prefix="transformer", prefixed=True,
                 tie=("lm_head.weight", "transformer.wte.weight")),
    "opt": dict(prefix="model", prefixed=True,
                tie=("lm_head.weight", "model.decoder.embed_tokens.weight")),
    "falcon": dict(prefix="transformer", prefixed=True,
                   tie=("lm_head.weight", "transformer.word_embeddings.weight")),
    "gpt_neox": dict(prefix="gpt_neox", prefixed=True,
                     tie=("embed_out.weight", "gpt_neox.embed_in.weight")),
    "gptj": dict(prefix="transformer", prefixed=True,
                 tie=("lm_head.weight", "transformer.wte.weight")),
    "bloom": dict(prefix="transformer", prefixed=True,
                  tie=("lm_head.weight", "transformer.word_embeddings.weight")),
    # BertLMHeadModel (AutoModelForCausalLM's bert class) has no pooler
    "bert": dict(prefix="bert", prefixed=True, tie=None, drop=("bert.pooler.",)),
    "distilbert": dict(prefix="distilbert", prefixed=False, tie=None),
    "clip": dict(prefix="clip", prefixed=False, tie=None),
}


class HFConfig(types.SimpleNamespace):
    """A config read from ``config.json`` (:func:`hf_config`): attribute
    access as on a transformers config, aliases included."""

    def __getattr__(self, name):
        aliases = self.__dict__.get("_aliases", {})
        if name in aliases:
            return getattr(self, aliases[name])
        raise AttributeError(name)


def _fill(kind: str, doc: Dict[str, Any]) -> HFConfig:
    aliases = ATTRIBUTE_MAPS.get(kind, {})
    values = dict(CONFIG_DEFAULTS.get(kind, {}))
    doc = dict(doc)
    n_embed = doc.pop("n_embed", None)      # falcon / bloom legacy kwarg
    for k, v in doc.items():
        values[aliases.get(k, k)] = v
    if n_embed is not None and kind in ("falcon", "bloom"):
        values["hidden_size"] = n_embed
    ns = HFConfig(**values)
    ns._aliases = aliases
    if "num_key_value_heads" in values and values["num_key_value_heads"] is None:
        ns.num_key_value_heads = ns.num_attention_heads
    if kind == "llama" and ns.head_dim is None:
        ns.head_dim = ns.hidden_size // ns.num_attention_heads
    if kind == "falcon" and ns.num_kv_heads is None:
        ns.num_kv_heads = ns.num_attention_heads
    if kind == "opt" and ns.word_embed_proj_dim is None:
        ns.word_embed_proj_dim = ns.hidden_size
    if kind == "qwen2_moe" and ns.mlp_only_layers is None:
        ns.mlp_only_layers = []
    if kind == "exaone4" and ns.layer_types is None:
        pattern = ns.sliding_window_pattern if ns.sliding_window is not None else 0
        ns.layer_types = ["sliding_attention" if (i + 1) % pattern != 0 else "full_attention"
                          for i in range(ns.num_hidden_layers)]
    return ns


def hf_config(doc: Dict[str, Any]) -> HFConfig:
    """``config.json``'s dict → the attributes the transformers config
    class would hold for the mappers: the class defaults
    (:data:`CONFIG_DEFAULTS`) under the file's values, aliases resolved,
    derived values derived; a CLIP config's towers as nested configs."""
    kind = doc.get("model_type")
    if not kind:
        raise ValueError("config.json has no model_type: cannot tell the model family")
    if kind == "clip":
        doc = dict(doc)
        text = _fill("clip_text_model", doc.pop("text_config", None) or {})
        vision = _fill("clip_vision_model", doc.pop("vision_config", None) or {})
        ns = _fill("clip", doc)
        ns.text_config, ns.vision_config = text, vision
        return ns
    return _fill(kind, doc)


class HFCheckpoint:
    """A local HF checkpoint read without transformers, in the shape of a
    live model (:func:`is_hf_model` accepts it): ``config`` the
    :class:`HFConfig`, ``state_dict()`` the fp32 weights (numpy) under the
    keys the JAX package's loader gives."""

    def __init__(self, config: HFConfig, state: Dict[str, np.ndarray]):
        self.config = config
        self._state = state

    def state_dict(self) -> Dict[str, np.ndarray]:
        return self._state


# safetensors dtype names → torch (read in place from the mapped file, then
# widened to fp32 by torch on all the host's cores)
_ST_DTYPES = {"F64": "float64", "F32": "float32", "F16": "float16", "BF16": "bfloat16",
              "I64": "int64", "I32": "int32", "I16": "int16", "I8": "int8", "U8": "uint8",
              "BOOL": "bool"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` file → fp32 arrays: an 8-byte little-endian
    header length, the JSON header (name → dtype, shape, data offsets),
    then the raw little-endian data."""
    import torch

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    size = os.path.getsize(path) - 8 - n
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n, shape=(size,)) \
        if size else np.zeros(0, np.uint8)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        dt = meta["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {dt}, which the reader "
                             "does not take")
        t = torch.frombuffer(data[lo:hi], dtype=getattr(torch, _ST_DTYPES[dt])) \
            if hi > lo else torch.zeros(0, dtype=getattr(torch, _ST_DTYPES[dt]))
        out[name] = t.to(torch.float32).reshape(meta["shape"]).numpy()
    return out


def _read_bin(path: str) -> Dict[str, np.ndarray]:
    import torch

    return {k: _to_numpy(v) for k, v in
            torch.load(path, map_location="cpu", weights_only=True).items()}


def read_hf_weights(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the directory's weights as fp32 numpy, in the order
    transformers looks for them: ``model.safetensors``, its sharded index,
    ``pytorch_model.bin``, its sharded index."""
    for name, reader in (("model.safetensors", read_safetensors),
                         ("pytorch_model.bin", _read_bin)):
        single, index = os.path.join(path, name), os.path.join(path, name + ".index.json")
        if os.path.exists(single):
            return reader(single)
        if os.path.exists(index):
            with open(index) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            out: Dict[str, np.ndarray] = {}
            for shard in files:
                out.update(reader(os.path.join(path, shard)))
            return out
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin (nor an index of "
                            f"shards) in {path!r}")


def _mend_keys(family: str, cfg: HFConfig, sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The keys as the class the JAX package's loader picks holds them
    (:data:`LOADED_CLASS`): legacy LayerNorm names renamed, the base-model
    prefix added or stripped, the keys that class drops dropped, a tied head
    set to the input embedding."""
    fixed = {}
    for k, v in sd.items():
        if k.endswith("LayerNorm.gamma"):
            k = k.replace("LayerNorm.gamma", "LayerNorm.weight")
        elif k.endswith("LayerNorm.beta"):
            k = k.replace("LayerNorm.beta", "LayerNorm.bias")
        fixed[k] = v
    cls = LOADED_CLASS[family]
    pfx = cls["prefix"] + "."
    has = any(k.startswith(pfx) for k in fixed)
    if cls["prefixed"] and not has:
        fixed = {pfx + k: v for k, v in fixed.items()}
    elif not cls["prefixed"] and has:
        fixed = {k[len(pfx):]: v for k, v in fixed.items() if k.startswith(pfx)}
    for drop in cls.get("drop", ()):
        fixed = {k: v for k, v in fixed.items() if not k.startswith(drop)}
    if cls["tie"] is not None:
        head, embed = cls["tie"]
        if getattr(cfg, "tie_word_embeddings", True):
            fixed[head] = fixed[embed]      # the loader ties the head to the embedding
        elif head not in fixed:
            raise ValueError(f"untied {family} config but the checkpoint has no {head}")
    return fixed


def read_hf_dir(path: str) -> HFCheckpoint:
    """A LOCAL HF checkpoint directory (no network) → :class:`HFCheckpoint`:
    its ``config.json`` through :func:`hf_config`, its weights through
    :func:`read_hf_weights` and the loader's key fix-ups."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = hf_config(json.load(f))
    family = cfg.model_type
    if family not in LOADED_CLASS:
        raise ValueError(f"unsupported HF family '{family}' "
                         f"(supported: {sorted(_FAMILIES)})")
    return HFCheckpoint(cfg, _mend_keys(family, cfg, read_hf_weights(path)))


def load_hf_checkpoint_with_family(path: str, family: Optional[str] = None):
    """Load a LOCAL HF checkpoint directory (no network) → (family_name,
    our_config, our_params), the params the JAX package's tree."""
    ckpt = read_hf_dir(path)
    family = family or ckpt.config.model_type
    cfg, params = from_hf(ckpt, family)
    return family, cfg, params


def load_hf_checkpoint(path: str, family: Optional[str] = None):
    """Load a LOCAL HF checkpoint directory (no network) and convert."""
    _, cfg, params = load_hf_checkpoint_with_family(path, family)
    return cfg, params


def load_checkpoint_dir_module(path: str):
    """Checkpoint directory → (family_name, model_module, our_config,
    our_params) — the shared resolution step behind
    ``init_inference(checkpoint=)`` and the v2 ``build_hf_engine``; callers
    gate on the module capability they need (``apply_cached`` for v1 decode,
    ``apply_paged`` for the paged v2 path)."""
    fam_name, cfg, params = load_hf_checkpoint_with_family(path)
    return fam_name, resolve_module(fam_name), cfg, params
