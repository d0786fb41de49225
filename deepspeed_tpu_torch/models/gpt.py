"""GPT-2/OPT-family model (learned positions, LayerNorm, GELU or ReLU MLP,
MHA) — counterpart of ``deepspeed_tpu/models/gpt.py`` (``GPTConfig`` :39,
``init`` :88, ``_block`` :176, ``apply`` :231, ``init_paged_cache`` :303,
``apply_paged`` :327, ``loss_fn`` :360, ``model_spec`` :385).

Two entry points over one set of parameters, as in ``models/llama.py``:

- training: :func:`apply` / :func:`loss_fn`, pure functions over a flat
  param dict, wrapped for the engine by :func:`model_spec`. Attention is op
  ``attention``: the flash kernels on CUDA tensors, plain attention on CPU
  tensors.
- serving: the ``nn.Module`` :class:`GPT`, whose ``forward`` is
  ``apply_paged`` over the paged KV cache.

Both run one block function (:func:`_block`, the JAX ``_block`` with its
``attn_call`` hook), so the two LayerNorm orderings and the activation are
written once. Parameter names follow the JAX tree with the leading layer dim
unstacked (``layers.<i>.wqkv`` for ``layers/wqkv[i]``); every matrix is kept
in ``nn.Linear`` layout ``[out, in]`` (``models/convert.py``). LayerNorm
reaches its CUDA kernel on CUDA tensors (with a plain backward); the
projections, MLP and lm-head stay ``torch.matmul`` as the JAX package leaves
them to XLA.

Covers GPT-2, OPT (pre-LN) and, with ``post_ln=True``, the original post-LN
ordering. The v1 dense cache (``init_cache`` / ``apply_cached``), the tiled
loss, remat and the logical axes are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import layer_norm
from ._paged import (init_paged_pools, join_kv, layer_kv, paged_attention_step,
                     split_kv)


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    post_ln: bool = False     # True = original transformer/BLOOM ordering
    activation: str = "gelu"  # "gelu" (GPT-2) | "relu" (OPT)

    def __post_init__(self):
        if self.activation not in ("gelu", "relu"):
            raise ValueError(f"unsupported activation {self.activation!r} "
                             "(gelu | relu)")

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_params(self) -> int:
        h, i, v, L, s = (self.hidden_size, self.intermediate_size,
                         self.vocab_size, self.num_layers, self.max_seq_len)
        # weights 4h²+2hi; biases bqkv 3h + bo h + b_up i + b_down h; LN 4h
        block = 4 * h * h + 2 * h * i + 9 * h + i
        embed = v * h * (1 if self.tie_embeddings else 2) + s * h
        return L * block + embed + 2 * h

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, max_seq_len=128)
        base.update(kw)
        return cls(**base)

    @classmethod
    def gpt2_small(cls) -> "GPTConfig":
        return cls()

    @classmethod
    def opt_1_3b(cls) -> "GPTConfig":
        return cls(vocab_size=50272, hidden_size=2048, intermediate_size=8192,
                   num_layers=24, num_heads=32, max_seq_len=2048)


def _layer_shapes(cfg: GPTConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, i = cfg.hidden_size, cfg.intermediate_size
    return {"ln1_scale": ((h,), 0), "ln1_bias": ((h,), 0),
            "wqkv": ((3 * h, h), h), "bqkv": ((3 * h,), 0),
            "wo": ((h, h), h), "bo": ((h,), 0),
            "ln2_scale": ((h,), 0), "ln2_bias": ((h,), 0),
            "w_up": ((i, h), h), "b_up": ((i,), 0),
            "w_down": ((h, i), i), "b_down": ((h,), 0)}


def param_shapes(cfg: GPTConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in) of every parameter; matrices in
    ``nn.Linear`` layout ``[out, in]``, vectors with fan_in 0 (LayerNorm
    scales init to 1, biases to 0, as in the JAX ``init``)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h), "pos_embed": ((cfg.max_seq_len, h), h)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{name}": spec
                       for name, spec in _layer_shapes(cfg).items()})
    shapes["final_ln_scale"] = ((h,), 0)
    shapes["final_ln_bias"] = ((h,), 0)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((v, h), h)
    return shapes


@torch.no_grad()
def init(cfg: GPTConfig, generator: torch.Generator, dtype=torch.float32,
         device=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution:
    matrices and both embedding tables N(0, 1/fan_in), LayerNorm scales 1,
    biases 0. The draws are made on the generator's device (in fp32, then
    cast) and the weights stay there unless ``device`` says otherwise."""
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


def init_paged_cache(cfg: GPTConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda",
                     kv_quant_group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``{"k", "v"}`` pools ``[L, num_blocks, nh, block_size, hd]`` on
    ``device`` (the GPU unless the caller passes ``device="cpu"``); with
    ``kv_quant_group``, int8 code pools and their fp32 scale pools
    (``models/_paged.py`` ``init_paged_pools``). MHA: kv heads = heads."""
    return init_paged_pools(cfg.num_layers, num_blocks, cfg.num_heads,
                            block_size, cfg.head_size, dtype, device,
                            kv_quant_group=kv_quant_group)


# --------------------------------------------------------------------------- #
# one block, shared by the training and the paged forward
# --------------------------------------------------------------------------- #
def _act(cfg: GPTConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
    return F.relu(x) if cfg.activation == "relu" else F.gelu(x, approximate="tanh")


def _qkv(cfg: GPTConfig, y: torch.Tensor, w: Callable[[str], torch.Tensor]):
    """The fused projection split q | k | v along the output dim, each
    [b, t, nh, hd]."""
    b, t, _ = y.shape
    q, k, v = F.linear(y, w("wqkv"), w("bqkv")).chunk(3, dim=-1)
    shape = (b, t, cfg.num_heads, cfg.head_size)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _block(cfg: GPTConfig, x: torch.Tensor, w: Callable[[str], torch.Tensor],
           attn_call: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """One block (JAX ``_block``). ``w(name)`` hands out this layer's
    parameters; ``attn_call(y)`` is the QKV projection, the attention (dense
    or paged) and the output projection. ``b_down`` is added after the
    residual sum, as in the JAX block."""
    eps = cfg.layer_norm_eps
    if cfg.post_ln:
        x = layer_norm(x + attn_call(x), w("ln1_scale"), w("ln1_bias"), eps)
        up = F.linear(x, w("w_up"), w("b_up"))
        m = F.linear(_act(cfg, up), w("w_down")) + w("b_down")
        return layer_norm(x + m, w("ln2_scale"), w("ln2_bias"), eps)
    y = layer_norm(x, w("ln1_scale"), w("ln1_bias"), eps)
    x = x + attn_call(y)
    y = layer_norm(x, w("ln2_scale"), w("ln2_bias"), eps)
    up = F.linear(y, w("w_up"), w("b_up"))
    return x + F.linear(_act(cfg, up), w("w_down")) + w("b_down")


def _head(cfg: GPTConfig, x: torch.Tensor, w: Callable[[str], torch.Tensor]
          ) -> torch.Tensor:
    """Final LayerNorm and the unembedding (``embed.T`` when tied) → fp32
    logits."""
    x = layer_norm(x, w("final_ln_scale"), w("final_ln_bias"), cfg.layer_norm_eps)
    return F.linear(x, w("embed") if cfg.tie_embeddings else w("lm_head")).float()


# --------------------------------------------------------------------------- #
# paged serving (JAX ``apply_paged``)
# --------------------------------------------------------------------------- #
def _param(shape) -> nn.Parameter:
    # uninitialised: weights arrive through load_state_dict (or init())
    return nn.Parameter(torch.empty(shape))


class GPTBlock(nn.Module):
    """One block's parameters; the forward is :func:`_block` with the paged
    attention step (JAX ``_attn_paged``)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        for name, (shape, _) in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape))

    def forward(self, x: torch.Tensor, k_cache, v_cache,
                block_tables: torch.Tensor, context_lens: torch.Tensor,
                valid: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w = partial(getattr, self)

        def attn_call(y):
            b, t, h = y.shape
            q, k, v = _qkv(cfg, y, w)
            out, _, _ = paged_attention_step(q, k, v, k_cache, v_cache,
                                             block_tables, context_lens,
                                             positions, valid)
            return F.linear(out.reshape(b, t, h), w("wo"), w("bo"))

        return _block(cfg, x, w, attn_call)


class GPT(nn.Module):
    """The paged-serving GPT. ``forward`` is ``apply_paged``: a ragged
    forward over the paged cache for prefill chunks or decode steps. The
    compute dtype is the parameters' dtype (the engine casts them to
    ``inference.dtype``, LayerNorm scales and biases included)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        h, v = cfg.hidden_size, cfg.vocab_size
        self.embed = _param((v, h))
        self.pos_embed = _param((cfg.max_seq_len, h))
        self.layers = nn.ModuleList(GPTBlock(cfg) for _ in range(cfg.num_layers))
        self.final_ln_scale = _param((h,))
        self.final_ln_bias = _param((h,))
        if not cfg.tie_embeddings:
            self.lm_head = _param((v, h))

    def forward(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                block_tables: torch.Tensor, context_lens: torch.Tensor,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B, t]; context_lens [B] tokens already cached per sequence;
        block_tables [B, max_blocks] int32 into the shared pool; valid [B, t]
        marks real (non-pad) tokens. Returns (logits [B, t, vocab] fp32,
        cache), the cache updated in place."""
        cfg = self.cfg
        b, t = tokens.shape
        if valid is None:
            valid = torch.ones((b, t), dtype=torch.bool, device=tokens.device)
        positions = context_lens.long()[:, None] + \
            torch.arange(t, device=tokens.device)[None, :]
        # clamp ONLY the learned-position lookup; the cache scatter and mask
        # see the true positions, or slots past max_seq_len would collide
        pos_idx = positions.clamp(max=cfg.max_seq_len - 1)
        dtype = self.embed.dtype
        x = embedding_lookup(self.embed, tokens, dtype) + self.pos_embed[pos_idx]
        k_pools, v_pools = split_kv(cache)
        for l, layer in enumerate(self.layers):
            x = layer(x, layer_kv(k_pools, l), layer_kv(v_pools, l), block_tables,
                      context_lens, valid, positions)
        return _head(cfg, x, partial(getattr, self)), join_kv(k_pools, v_pools)


def build(cfg: GPTConfig) -> GPT:
    """The module with uninitialised parameters (build it under
    ``torch.device("meta")`` and ``load_state_dict(..., assign=True)`` to
    place weights without a throwaway copy)."""
    return GPT(cfg)


def apply_paged(cfg: GPTConfig, model: GPT, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], block_tables: torch.Tensor,
                context_lens: torch.Tensor, *,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Functional entry with the JAX ``apply_paged`` signature."""
    if model.cfg != cfg:
        raise ValueError("model was built for another config")
    with torch.no_grad():
        return model(tokens, cache, block_tables, context_lens, valid)


# --------------------------------------------------------------------------- #
# full-sequence training forward (JAX ``apply`` / ``loss_fn``)
# --------------------------------------------------------------------------- #
def apply(cfg: GPTConfig, params: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Causal forward over the whole sequence → logits [batch, seq, vocab]
    fp32. ``params`` is a flat dict (:func:`param_shapes` names); every
    leaf, LayerNorm scales and biases included, is cast to ``compute_dtype``
    here as the JAX ``apply`` casts its layers, so grads of fp32 params flow
    back through the cast. ``positions`` default to ``arange(seq)``."""
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, device=tokens.device)[None, :]
    # the table is cast whole only where the tied head needs it as a matrix
    p = {k: v.to(compute_dtype) for k, v in params.items()
         if k != "embed" or cfg.tie_embeddings}
    x = embedding_lookup(p.get("embed", params["embed"]), tokens, compute_dtype) \
        + p["pos_embed"][positions.long()]
    for l in range(cfg.num_layers):
        w = lambda name, _pre=f"layers.{l}.": p[_pre + name]  # noqa: E731

        def attn_call(y, w=w):
            q, k, v = _qkv(cfg, y, w)
            out = attention(q, k, v, causal=True)
            return F.linear(out.reshape(y.shape), w("wo"), w("bo"))

        x = _block(cfg, x, w, attn_call)
    return _head(cfg, x, p.__getitem__)


def loss_fn(cfg: GPTConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32, mean over all tokens (JAX
    ``loss_fn``). batch: ``{"tokens": [b, s+1]}``."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits = apply(cfg, params, inputs, compute_dtype=compute_dtype)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
    return loss, {"loss": loss.detach()}


def model_spec(cfg: GPTConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec for this config (JAX ``model_spec``);
    ``init_fn`` draws the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="gpt",
        init_fn=lambda gen: init(cfg, gen),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch,
                                              compute_dtype=compute_dtype),
        compute_dtype=compute_dtype,
    )
