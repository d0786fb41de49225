"""Tiny ``transformers`` models, one per row of the JAX package's
``hf_import._FAMILIES`` table, built from their config classes under fixed
seeds, for the port's HF tests (``test_torch_hf_import.py``,
``test_torch_hf_entry_points.py``). Biases and norms are moved off their
init so that a dropped one shows."""

import torch
import transformers

from deepspeed_tpu.models import hf_import as jhf

FAMILIES = sorted(jhf._FAMILIES)
SMALL = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64)
LLAMA_LIKE = dict(SMALL, intermediate_size=112, num_key_value_heads=2, rope_theta=10000.0,
                  tie_word_embeddings=False)


def _hf_config(family):
    T = transformers
    if family in ("llama", "mistral", "qwen2", "qwen3"):
        cls = {"llama": T.LlamaConfig, "mistral": T.MistralConfig, "qwen2": T.Qwen2Config,
               "qwen3": T.Qwen3Config}[family]
        return cls(**LLAMA_LIKE)
    if family == "phi3":
        return T.Phi3Config(**dict(LLAMA_LIKE, intermediate_size=96), pad_token_id=0,
                            bos_token_id=1, eos_token_id=2)
    if family == "exaone4":
        return T.Exaone4Config(**dict(LLAMA_LIKE, num_hidden_layers=4), sliding_window=8,
                               sliding_window_pattern=2)
    if family == "mixtral":
        return T.MixtralConfig(**dict(LLAMA_LIKE, intermediate_size=96), num_local_experts=4,
                               num_experts_per_tok=2)
    if family == "qwen2_moe":
        return T.Qwen2MoeConfig(**dict(LLAMA_LIKE, intermediate_size=96),
                                moe_intermediate_size=48, shared_expert_intermediate_size=80,
                                num_experts=4, num_experts_per_tok=2, decoder_sparse_step=1,
                                mlp_only_layers=[])
    if family == "gpt2":
        return T.GPT2Config(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64)
    if family == "opt":
        return T.OPTConfig(**SMALL, ffn_dim=256, word_embed_proj_dim=64)
    if family == "falcon":
        return T.FalconConfig(**SMALL, multi_query=True, parallel_attn=True, bias=False,
                              alibi=False)
    if family == "gpt_neox":
        return T.GPTNeoXConfig(**SMALL, intermediate_size=256, rotary_pct=0.25)
    if family == "gptj":
        return T.GPTJConfig(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
                            rotary_dim=8)
    if family == "bloom":
        return T.BloomConfig(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
    if family == "bert":
        return T.BertConfig(**SMALL, intermediate_size=128)
    if family == "distilbert":
        return T.DistilBertConfig(vocab_size=128, dim=64, hidden_dim=128, n_layers=2,
                                  n_heads=4, max_position_embeddings=64)
    if family == "clip":
        return T.CLIPConfig(
            text_config={"vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
                         "num_hidden_layers": 2, "num_attention_heads": 2,
                         "max_position_embeddings": 16, "eos_token_id": 63},
            vision_config={"hidden_size": 32, "intermediate_size": 64,
                           "num_hidden_layers": 2, "num_attention_heads": 2,
                           "image_size": 32, "patch_size": 8},
            projection_dim=24)
    raise KeyError(family)


def _hf_class(family):
    T = transformers
    if family == "bert":
        return T.BertModel
    if family == "distilbert":
        return T.DistilBertModel
    if family == "clip":
        return T.CLIPModel
    return T.AutoModelForCausalLM


_MODELS = {}


def hf_model(family):
    """A tiny HF model of ``family`` from a fixed seed (built once)."""
    if family not in _MODELS:
        torch.manual_seed(FAMILIES.index(family))
        cls = _hf_class(family)
        cfg = _hf_config(family)
        m = cls.from_config(cfg) if cls is transformers.AutoModelForCausalLM else cls(cfg)
        with torch.no_grad():   # biases and norms away from their init
            for name, p in m.named_parameters():
                if p.dim() == 1 and "logit_scale" not in name:
                    p.add_(0.1 * torch.randn_like(p))
        _MODELS[family] = m.eval()
    return _MODELS[family]
