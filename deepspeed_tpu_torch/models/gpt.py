"""GPT-2/OPT-family model (learned positions, LayerNorm, GELU or ReLU MLP,
MHA) — counterpart of ``deepspeed_tpu/models/gpt.py`` (``GPTConfig`` :39,
``init`` :88, ``_attn`` :141, ``_block`` :176, ``_head_split`` :214,
``apply`` :231, ``init_cache`` … ``apply_cached`` :267-300,
``init_paged_cache`` :303, ``apply_paged`` :327, ``loss_fn`` :360,
``tiled_loss_fn`` :370, ``model_spec`` :385).

Three entry points over one set of parameters, as in ``models/llama.py``:

- training: :func:`apply` / :func:`loss_fn` / :func:`tiled_loss_fn`, pure
  functions over a flat param dict, wrapped for the engine by
  :func:`model_spec`. Attention is op ``attention``: the flash kernels on
  CUDA tensors, plain attention on CPU tensors. ``cfg.remat`` checkpoints
  each block, which reads its leaves inside the checkpointed function.
- v1 serving: :func:`apply_cached` over the dense cache of
  :func:`init_cache` (masked, so plain attention).
- v2 serving: the ``nn.Module`` :class:`GPT`, whose ``forward`` is
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
ordering.
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
from ..runtime.activation_checkpointing import checkpointing as ac
from ..runtime.activation_checkpointing.checkpointing import checkpoint_name
from ..runtime.partitioning import LeafAxes, linear
from ._paged import (init_paged_pools, join_kv, layer_kv, paged_attention_step,
                     split_kv)
from .llama import _write_cache, cache_mask, remat_policy

# the checkpoint names the training block attaches
CHECKPOINT_NAMES_EMITTED = ("qkv_proj", "attn_mix", "attn_out", "mlp_up", "mlp_out")


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
    remat: bool = False
    remat_policy: str = "none"  # none | full | dots | any registry policy

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


def param_logical_axes(cfg: GPTConfig) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes``
    :122), per layer and in the port's ``[out, in]`` layout."""
    vec = lambda name: LeafAxes((name,))  # noqa: E731
    per_layer = {"ln1_scale": vec("embed"), "ln1_bias": vec("embed"),
                 "wqkv": linear("heads", "embed"), "bqkv": vec("heads"),
                 "wo": linear("embed", "heads"), "bo": vec("embed"),
                 "ln2_scale": vec("embed"), "ln2_bias": vec("embed"),
                 "w_up": linear("mlp", "embed"), "b_up": vec("mlp"),
                 "w_down": linear("embed", "mlp"), "b_down": vec("embed")}
    axes = {"embed": LeafAxes(("vocab", "embed")), "pos_embed": LeafAxes((None, "embed")),
            "final_ln_scale": vec("embed"), "final_ln_bias": vec("embed"),
            "lm_head": linear("vocab", "embed")}
    return {name: axes[name] if name in axes else per_layer[name.rsplit(".", 1)[1]]
            for name in param_shapes(cfg)}


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
         device=None, keep=None) -> Dict[str, torch.Tensor]:
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
        if keep is not None:     # as llama.init's keep
            out[name] = keep(name, out[name])
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
    q, k, v = checkpoint_name(F.linear(y, w("wqkv"), w("bqkv")), "qkv_proj").chunk(3, dim=-1)
    shape = (b, t, cfg.num_heads, cfg.head_size)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _block(cfg: GPTConfig, x: torch.Tensor, w: Callable[[str], torch.Tensor],
           attn_call: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """One block (JAX ``_block``). ``w(name)`` hands out this layer's
    parameters; ``attn_call(y)`` is the QKV projection, the attention (dense
    or paged) and the output projection. ``b_down`` is added after the
    residual sum, as in the JAX block; the checkpoint names sit where the
    JAX block puts them."""
    eps = cfg.layer_norm_eps
    if cfg.post_ln:
        a = checkpoint_name(attn_call(x), "attn_out")
        x = layer_norm(x + a, w("ln1_scale"), w("ln1_bias"), eps)
        up = checkpoint_name(F.linear(x, w("w_up"), w("b_up")), "mlp_up")
        m = checkpoint_name(F.linear(_act(cfg, up), w("w_down")), "mlp_out") + w("b_down")
        return layer_norm(x + m, w("ln2_scale"), w("ln2_bias"), eps)
    y = layer_norm(x, w("ln1_scale"), w("ln1_bias"), eps)
    x = x + checkpoint_name(attn_call(y), "attn_out")
    y = layer_norm(x, w("ln2_scale"), w("ln2_bias"), eps)
    up = checkpoint_name(F.linear(y, w("w_up"), w("b_up")), "mlp_up")
    return x + checkpoint_name(F.linear(_act(cfg, up), w("w_down")), "mlp_out") + w("b_down")


def _head_split(cfg: GPTConfig, x: torch.Tensor, w: Callable[[str], torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final LayerNorm and the unembedding ``[vocab, hidden]`` (``embed``
    when tied) without the logits matmul (JAX ``_head_split``)."""
    x = layer_norm(x, w("final_ln_scale"), w("final_ln_bias"), cfg.layer_norm_eps)
    return x, w("embed") if cfg.tie_embeddings else w("lm_head")


def _head(cfg: GPTConfig, x: torch.Tensor, w: Callable[[str], torch.Tensor]
          ) -> torch.Tensor:
    """Final LayerNorm and the unembedding → fp32 logits."""
    x, head = _head_split(cfg, x, w)
    return F.linear(x, head).float()


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
def _top_leaves(cfg: GPTConfig, params: Dict[str, torch.Tensor], compute_dtype):
    """The leaves outside the blocks, cast to ``compute_dtype`` (the table
    whole only where the tied head needs it as a matrix)."""
    names = ["pos_embed", "final_ln_scale", "final_ln_bias"]
    names.append("embed" if cfg.tie_embeddings else "lm_head")
    return {k: params[k].to(compute_dtype) for k in names}


def _block_leaves(cfg: GPTConfig, params: Dict[str, torch.Tensor], l: int, compute_dtype):
    """Layer ``l``'s leaves, read and cast when the block is entered."""
    pre = f"layers.{l}."
    return {name: params[pre + name].to(compute_dtype) for name in _layer_shapes(cfg)}


def _embed(cfg: GPTConfig, params, top, tokens, positions, compute_dtype):
    table = top["embed"] if cfg.tie_embeddings else params["embed"]
    return embedding_lookup(table, tokens, compute_dtype) + top["pos_embed"][positions.long()]


def apply(cfg: GPTConfig, params: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None,
          compute_dtype=torch.bfloat16, return_hidden: bool = False):
    """Causal forward over the whole sequence → logits [batch, seq, vocab]
    fp32; with ``return_hidden`` the :func:`_head_split` pair. ``params`` is
    a flat dict (:func:`param_shapes` names); every leaf, LayerNorm scales
    and biases included, is cast to ``compute_dtype`` as the JAX ``apply``
    casts its layers, so grads of fp32 params flow back through the cast; a
    block's leaves when the block is entered (inside the checkpointed block
    under ``cfg.remat``). ``positions`` default to ``arange(seq)``."""
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, device=tokens.device)[None, :]
    top = _top_leaves(cfg, params, compute_dtype)
    x = _embed(cfg, params, top, tokens, positions, compute_dtype)

    def block(x, l):
        w = _block_leaves(cfg, params, l, compute_dtype).__getitem__

        def attn_call(y):
            q, k, v = _qkv(cfg, y, w)
            out = checkpoint_name(attention(q, k, v, causal=True), "attn_mix")
            return F.linear(out.reshape(y.shape), w("wo"), w("bo"))

        return _block(cfg, x, w, attn_call)

    policy = remat_policy(cfg.remat_policy)
    for l in range(cfg.num_layers):
        x = ac.checkpoint(block, x, l, policy=policy) if cfg.remat else block(x, l)
    if return_hidden:
        return _head_split(cfg, x, top.__getitem__)
    return _head(cfg, x, top.__getitem__)


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


def tiled_loss_fn(cfg: GPTConfig, params: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16,
                  shards: int = 8) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`loss_fn` with the unembedding and the cross-entropy fused a
    sequence tile at a time (``sequence.tiled_loss``)."""
    from ..sequence.tiled import tiled_fused_logits_loss

    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, head = apply(cfg, params, inputs, compute_dtype=compute_dtype,
                         return_hidden=True)
    loss = tiled_fused_logits_loss(hidden, head, labels, shards=shards)
    return loss, {"loss": loss.detach()}


def model_spec(cfg: GPTConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec for this config (JAX ``model_spec``);
    ``init_fn`` draws the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="gpt",
        init_fn=lambda gen, **kw: init(cfg, gen, **kw),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch,
                                              compute_dtype=compute_dtype),
        tiled_loss_fn=lambda params, batch, shards=8: tiled_loss_fn(
            cfg, params, batch, compute_dtype=compute_dtype, shards=shards),
        compute_dtype=compute_dtype,
        logical_axes=param_logical_axes(cfg),
        config=cfg,
    )


# --------------------------------------------------------------------------- #
# v1 dense-cache serving (JAX ``init_cache`` … ``apply_cached``)
# --------------------------------------------------------------------------- #
def init_cache(cfg: GPTConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Dense KV cache ``{"k", "v"}``: [layers, batch, max_len, heads,
    head_dim] zeros on ``device`` (the GPU unless the caller passes
    ``device="cpu"``)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_heads, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes(cfg: GPTConfig) -> Dict[str, LeafAxes]:
    spec = LeafAxes(("layers", None, None, "heads", None))
    return {"k": spec, "v": spec}


def apply_cached(cfg: GPTConfig, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 cache: Dict[str, torch.Tensor], cache_len: torch.Tensor, *,
                 compute_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward with the dense KV cache (JAX ``apply_cached``): tokens
    [b, t]; cache_len [b] (or a scalar). The learned positions are clamped
    to ``max_seq_len - 1`` for the table lookup only. Returns (logits fp32,
    cache), the cache written in place."""
    b, t = tokens.shape
    cache_len = torch.as_tensor(cache_len, device=tokens.device).long().expand(b)
    positions = (cache_len[:, None] + torch.arange(t, device=tokens.device)[None, :]) \
        .clamp(max=cfg.max_seq_len - 1)
    top = _top_leaves(cfg, params, compute_dtype)
    x = _embed(cfg, params, top, tokens, positions, compute_dtype)
    S = cache["k"].shape[2]
    mask = cache_mask(cache_len, t, S)
    for l in range(cfg.num_layers):
        w = _block_leaves(cfg, params, l, compute_dtype).__getitem__
        k_cache, v_cache = cache["k"][l], cache["v"][l]

        def attn_call(y, w=w, k_cache=k_cache, v_cache=v_cache):
            q, k, v = _qkv(cfg, y, w)
            _write_cache(k_cache, k, cache_len)
            _write_cache(v_cache, v, cache_len)
            out = attention(q, k_cache, v_cache, causal=False, mask=mask)
            return F.linear(out.reshape(y.shape), w("wo"), w("bo"))

        x = _block(cfg, x, w, attn_call)
    return _head(cfg, x, top.__getitem__), cache
