"""BLOOM family (ALiBi, LayerNorm, biases everywhere, tied head) —
counterpart of ``deepspeed_tpu/models/bloom.py`` (``BloomConfig`` :38,
``alibi_slopes`` :64, ``_alibi_bias`` :77, ``init`` :85, ``_block`` :142,
``apply`` :190, ``loss_fn`` :270, ``model_spec`` :303).

BLOOM's differences from the GPT/Llama families, kept as the JAX package
has them:

- **ALiBi**: a per-head additive logits slope instead of positions, in its
  one-sided form ``slope · key_pos`` (``[heads, 1, kv_len]`` fp32; softmax
  rows are shift-invariant, so under the causal mask it equals
  ``slope · (key_pos − query_pos)``). It reaches op ``attention`` as
  ``bias=``: on CUDA tensors the flash kernels' bias mode reads it in
  place; on CPU tensors plain attention adds it.
- A LayerNorm over the embedding output (``embed_ln``); sequential
  pre-LN blocks; LayerNorm with bias; biases on every linear; the tanh
  GELU (``jax.nn.gelu`` defaults to it); the tied head ``embed.T``.

:func:`apply` / :func:`loss_fn` are pure functions over a flat param dict
(:func:`param_shapes` names: the JAX tree with the layer dim unstacked,
``layers.<i>.wq`` for ``layers/wq[i]``, every matrix in ``nn.Linear``
layout ``[out, in]``, ``models/convert.py``), wrapped for the engine by
:func:`model_spec`. :class:`Bloom` is the same model as an ``nn.Module``
whose ``forward`` is :func:`apply` over its own parameters. The v1 dense
cache (``init_cache`` / ``apply_cached``), the tiled loss and the logical
axes are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import layer_norm


@dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 4096
    num_layers: int = 30
    num_heads: int = 32
    max_seq_len: int = 2048
    layer_norm_eps: float = 1e-5

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @classmethod
    def tiny(cls, **kw) -> "BloomConfig":
        base = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                    max_seq_len=128)
        base.update(kw)
        return cls(**base)

    @classmethod
    def bloom_7b1(cls) -> "BloomConfig":
        return cls()


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes, fp32 (HF ``build_alibi_tensor``: a geometric
    series from the closest power of two, odd steps filling the rest)."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_rem = min(closest, num_heads - closest)
        slopes += [extra_base ** i for i in range(1, 2 * n_rem, 2)]
    return torch.tensor(slopes, dtype=torch.float32)


def _alibi_bias(num_heads: int, kv_len: int, device=None) -> torch.Tensor:
    """[heads, 1, kv_len] additive fp32 logits bias (one-sided form)."""
    slopes = alibi_slopes(num_heads).to(device)
    return slopes[:, None, None] * torch.arange(kv_len, dtype=torch.float32,
                                                device=device)[None, None, :]


def _layer_shapes(cfg: BloomConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, i = cfg.hidden_size, cfg.intermediate_size
    return {"ln1_scale": ((h,), 0), "ln1_bias": ((h,), 0),
            "wq": ((h, h), h), "wk": ((h, h), h), "wv": ((h, h), h),
            "bq": ((h,), 0), "bk": ((h,), 0), "bv": ((h,), 0),
            "wo": ((h, h), h), "bo": ((h,), 0),
            "ln2_scale": ((h,), 0), "ln2_bias": ((h,), 0),
            "w_up": ((i, h), h), "b_up": ((i,), 0),
            "w_down": ((h, i), i), "b_down": ((h,), 0)}


def param_shapes(cfg: BloomConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in) of every parameter; matrices in
    ``nn.Linear`` layout ``[out, in]``, vectors with fan_in 0 (LayerNorm
    scales init to 1, biases to 0, as in the JAX ``init``)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h), "embed_ln_scale": ((h,), 0),
              "embed_ln_bias": ((h,), 0)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{name}": spec
                       for name, spec in _layer_shapes(cfg).items()})
    shapes["final_ln_scale"] = ((h,), 0)
    shapes["final_ln_bias"] = ((h,), 0)
    return shapes


@torch.no_grad()
def init(cfg: BloomConfig, generator: torch.Generator, dtype=torch.float32,
         device=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution:
    matrices and the embedding N(0, 1/fan_in), LayerNorm scales 1, biases 0.
    Drawn on the generator's device (fp32, then cast); kept there unless
    ``device`` says otherwise."""
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
    return out


def _block(cfg: BloomConfig, x: torch.Tensor, w: Callable[[str], torch.Tensor],
           bias: torch.Tensor) -> torch.Tensor:
    """One block (JAX ``_block``): the attention's ALiBi ``bias`` is
    ``[heads, 1, seq]``; the output and down-projection biases are added
    after the residual sum, as in the JAX block."""
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_size
    eps = cfg.layer_norm_eps
    y = layer_norm(x, w("ln1_scale"), w("ln1_bias"), eps)
    q = F.linear(y, w("wq"), w("bq")).reshape(b, s, nh, hd)
    k = F.linear(y, w("wk"), w("bk")).reshape(b, s, nh, hd)
    v = F.linear(y, w("wv"), w("bv")).reshape(b, s, nh, hd)
    attn_out = attention(q, k, v, causal=True, bias=bias)
    x = x + F.linear(attn_out.reshape(b, s, h), w("wo")) + w("bo")
    y = layer_norm(x, w("ln2_scale"), w("ln2_bias"), eps)
    u = F.gelu(F.linear(y, w("w_up"), w("b_up")), approximate="tanh")
    return x + F.linear(u, w("w_down")) + w("b_down")


def apply(cfg: BloomConfig, params: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Causal forward over the whole sequence → logits [batch, seq, vocab]
    fp32. Every leaf is cast to ``compute_dtype`` here, as the JAX ``apply``
    casts its layers, so grads of fp32 params flow back through the cast.
    ``positions`` is accepted and ignored: ALiBi carries position in the
    logits bias."""
    del positions
    p = {k: v.to(compute_dtype) for k, v in params.items()}
    x = embedding_lookup(p["embed"], tokens, compute_dtype)
    eps = cfg.layer_norm_eps
    x = layer_norm(x, p["embed_ln_scale"], p["embed_ln_bias"], eps)
    bias = _alibi_bias(cfg.num_heads, tokens.shape[1], tokens.device)
    for l in range(cfg.num_layers):
        x = _block(cfg, x, lambda name, _pre=f"layers.{l}.": p[_pre + name], bias)
    x = layer_norm(x, p["final_ln_scale"], p["final_ln_bias"], eps)
    return F.linear(x, p["embed"]).float()


def loss_fn(cfg: BloomConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32 (JAX ``loss_fn``): batch
    ``{"tokens": [b, s+1]}``, or ``{"tokens", "labels"}`` with -100 marking
    positions that do not count; mean over the counted tokens."""
    tokens = batch["tokens"]
    if "labels" in batch:
        inputs, labels = tokens, batch["labels"]
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    labels = torch.as_tensor(labels, device=inputs.device).long()
    logits = apply(cfg, params, inputs, compute_dtype=compute_dtype)
    n = (labels != -100).sum()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           ignore_index=-100, reduction="sum") / n.clamp_min(1)
    return loss, {"loss": loss.detach(), "ntokens": n}


def model_spec(cfg: BloomConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec for this config (JAX ``model_spec``);
    ``init_fn`` draws the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="bloom",
        init_fn=lambda gen: init(cfg, gen),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch,
                                              compute_dtype=compute_dtype),
        compute_dtype=compute_dtype,
    )


# --------------------------------------------------------------------------- #
# the same model as an nn.Module
# --------------------------------------------------------------------------- #
def _param(shape) -> nn.Parameter:
    # uninitialised: weights arrive through load_state_dict (or init())
    return nn.Parameter(torch.empty(shape))


class BloomBlock(nn.Module):
    """One block's parameters (``layers.<i>.*``)."""

    def __init__(self, cfg: BloomConfig):
        super().__init__()
        for name, (shape, _) in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape))


class Bloom(nn.Module):
    """BLOOM as an ``nn.Module``: its ``state_dict`` holds
    :func:`param_shapes`'s names, and ``forward(tokens)`` is :func:`apply`
    over those parameters in their own dtype."""

    def __init__(self, cfg: BloomConfig):
        super().__init__()
        self.cfg = cfg
        h, v = cfg.hidden_size, cfg.vocab_size
        self.embed = _param((v, h))
        self.embed_ln_scale = _param((h,))
        self.embed_ln_bias = _param((h,))
        self.layers = nn.ModuleList(BloomBlock(cfg) for _ in range(cfg.num_layers))
        self.final_ln_scale = _param((h,))
        self.final_ln_bias = _param((h,))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self.cfg, dict(self.named_parameters()), tokens,
                     compute_dtype=self.embed.dtype)


def build(cfg: BloomConfig) -> Bloom:
    """The module with uninitialised parameters (build it under
    ``torch.device("meta")`` and ``load_state_dict(..., assign=True)`` to
    place weights without a throwaway copy)."""
    return Bloom(cfg)
