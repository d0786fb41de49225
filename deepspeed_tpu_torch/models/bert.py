"""BERT-family encoder (bidirectional attention, learned positions and token
types, post-LN blocks, the MLM head tied to the embedding) — counterpart of
``deepspeed_tpu/models/bert.py`` (``BertConfig`` :28, ``init`` :58,
``param_logical_axes`` :92, ``_block`` :112, ``apply`` :129, ``loss_fn``
:165, ``model_spec`` :181).

Training only, as in the JAX package: :func:`apply` / :func:`loss_fn` are
pure functions over a flat param dict, wrapped for the engine by
:func:`model_spec`. Parameter names follow the JAX tree with the leading
layer dim unstacked (``layers.<i>.wqkv`` for ``layers/wqkv[i]``); the block
matrices (``wqkv``, ``wo``, ``w_up``, ``w_down``) are kept in ``nn.Linear``
layout ``[out, in]`` (``models/convert.py``), the pooler ``x @ W`` as the
JAX tree keeps it.

Attention is op ``attention`` with ``causal=False``: the flash kernels on
CUDA tensors without an ``attention_mask``; with one, a boolean mask that
goes to plain attention on every device (the JAX package hands masked calls
to XLA). The embedding sum and its LayerNorm stay fp32, the cast to the
compute dtype after the norm. DistilBERT maps onto the same config
(``models/hf_import.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import layer_norm
from ..runtime.activation_checkpointing import checkpointing as ac
from ..runtime.partitioning import LeafAxes, linear


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    gelu_approx: bool = False  # HF 'gelu' is the exact erf form
    remat: bool = False

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, max_seq_len=64,
                    type_vocab_size=2)
        base.update(kw)
        return cls(**base)

    @classmethod
    def bert_base(cls) -> "BertConfig":
        return cls()


def _layer_shapes(cfg: BertConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, i = cfg.hidden_size, cfg.intermediate_size
    return {"wqkv": ((3 * h, h), h), "bqkv": ((3 * h,), 0),
            "wo": ((h, h), h), "bo": ((h,), 0),
            "attn_ln_scale": ((h,), 0), "attn_ln_bias": ((h,), 0),
            "w_up": ((i, h), h), "b_up": ((i,), 0),
            "w_down": ((h, i), i), "b_down": ((h,), 0),
            "mlp_ln_scale": ((h,), 0), "mlp_ln_bias": ((h,), 0)}


def param_shapes(cfg: BertConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in) of every parameter; the block
    matrices in ``nn.Linear`` layout ``[out, in]``, vectors with fan_in 0
    (LayerNorm scales init to 1, biases to 0, as in the JAX ``init``)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h), "pos_embed": ((cfg.max_seq_len, h), h),
              "type_embed": ((cfg.type_vocab_size, h), h),
              "embed_ln_scale": ((h,), 0), "embed_ln_bias": ((h,), 0)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{name}": spec
                       for name, spec in _layer_shapes(cfg).items()})
    shapes["pooler_w"] = ((h, h), h)
    shapes["pooler_b"] = ((h,), 0)
    return shapes


def param_logical_axes(cfg: BertConfig) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes`` :92),
    per layer and in the port's layout."""
    vec = lambda name: LeafAxes((name,))  # noqa: E731
    per_layer = {"wqkv": linear("heads", "embed"), "bqkv": vec("heads"),
                 "wo": linear("embed", "heads"), "bo": vec("embed"),
                 "attn_ln_scale": vec("embed"), "attn_ln_bias": vec("embed"),
                 "w_up": linear("mlp", "embed"), "b_up": vec("mlp"),
                 "w_down": linear("embed", "mlp"), "b_down": vec("embed"),
                 "mlp_ln_scale": vec("embed"), "mlp_ln_bias": vec("embed")}
    top = {"embed": LeafAxes(("vocab", "embed")), "pos_embed": LeafAxes((None, "embed")),
           "type_embed": LeafAxes((None, "embed")),
           "embed_ln_scale": vec("embed"), "embed_ln_bias": vec("embed"),
           "pooler_w": LeafAxes(("embed", "embed")), "pooler_b": vec("embed")}
    return {name: top[name] if name in top else per_layer[name.rsplit(".", 1)[1]]
            for name in param_shapes(cfg)}


@torch.no_grad()
def init(cfg: BertConfig, generator: torch.Generator, dtype=torch.float32,
         device=None, keep=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution:
    matrices and the embedding tables N(0, 1/fan_in), LayerNorm scales 1,
    biases 0 (as ``gpt.init``)."""
    gen_device = generator.device
    device = gen_device if device is None else device
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, fan_in) in param_shapes(cfg).items():
        if fan_in:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=gen_device).mul_(fan_in ** -0.5)
            out[name] = w.to(device=device, dtype=dtype)
            del w
        elif name.endswith("_scale"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        if keep is not None:
            out[name] = keep(name, out[name])
    return out


def _block(cfg: BertConfig, x: torch.Tensor, w, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Post-LN encoder block (JAX ``_block``). ``w(name)`` hands out the
    layer's leaves; mask: [b, 1, 1, s] boolean (True = attend) or None."""
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_size
    eps = cfg.layer_norm_eps
    q, k, v = [t.reshape(b, s, nh, hd)
               for t in F.linear(x, w("wqkv"), w("bqkv")).chunk(3, dim=-1)]
    a = attention(q, k, v, causal=False, mask=mask)
    a = F.linear(a.reshape(b, s, h), w("wo"), w("bo"))
    x = layer_norm(x + a, w("attn_ln_scale"), w("attn_ln_bias"), eps)
    up = F.linear(x, w("w_up"), w("b_up"))
    m = F.linear(F.gelu(up, approximate="tanh" if cfg.gelu_approx else "none"),
                 w("w_down"), w("b_down"))
    return layer_norm(x + m, w("mlp_ln_scale"), w("mlp_ln_bias"), eps)


def apply(cfg: BertConfig, params: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
          token_types: Optional[torch.Tensor] = None,
          attention_mask: Optional[torch.Tensor] = None,
          compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """→ {"hidden": [b, s, h], "pooled": [b, h], "mlm_logits": [b, s, vocab]
    fp32}. The embedding sum and its LayerNorm in fp32, then the cast; a
    block's leaves cast to ``compute_dtype`` when the block is entered
    (inside the checkpointed block under ``cfg.remat``)."""
    b, s = tokens.shape
    tokens = tokens.long()
    if token_types is None:
        token_types = torch.zeros_like(tokens)
    x = (embedding_lookup(params["embed"], tokens, torch.float32)
         + params["pos_embed"][:s][None] + params["type_embed"][token_types.long()])
    x = layer_norm(x, params["embed_ln_scale"].float(), params["embed_ln_bias"].float(),
                   cfg.layer_norm_eps).to(compute_dtype)
    mask = None
    if attention_mask is not None:
        mask = torch.as_tensor(attention_mask, device=tokens.device)[:, None, None, :].bool()

    def block(x, l):
        pre = f"layers.{l}."
        p = {name: params[pre + name].to(compute_dtype) for name in _layer_shapes(cfg)}
        return _block(cfg, x, p.__getitem__, mask)

    for l in range(cfg.num_layers):
        x = ac.checkpoint(block, x, l, policy="full") if cfg.remat else block(x, l)
    pooled = torch.tanh(x[:, 0] @ params["pooler_w"].to(compute_dtype)
                        + params["pooler_b"].to(compute_dtype))
    mlm = F.linear(x, params["embed"].to(compute_dtype)).float()
    return {"hidden": x, "pooled": pooled, "mlm_logits": mlm}


def loss_fn(cfg: BertConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked-LM loss (JAX ``loss_fn``): labels -100 = unmasked (ignored);
    the mean over the counted tokens, at least one."""
    out = apply(cfg, params, batch["tokens"], token_types=batch.get("token_types"),
                attention_mask=batch.get("attention_mask"), compute_dtype=compute_dtype)
    logits = out["mlm_logits"]
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    n = (labels != -100).sum()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           ignore_index=-100, reduction="sum") / n.clamp_min(1)
    return loss, {"loss": loss.detach()}


def model_spec(cfg: BertConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec for this config (JAX ``model_spec``);
    ``init_fn`` draws the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="bert",
        init_fn=lambda gen, **kw: init(cfg, gen, **kw),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch,
                                              compute_dtype=compute_dtype),
        compute_dtype=compute_dtype,
        logical_axes=param_logical_axes(cfg),
        config=cfg,
    )
