"""Falcon family (RW architecture) — counterpart of
``deepspeed_tpu/models/falcon.py`` (``FalconConfig`` :35, ``init`` :65,
``param_logical_axes`` :99, ``_attn_part`` / ``_block`` :123-158,
``_head_split`` / ``_head`` :161-177, ``apply`` :186, ``init_cache`` …
``apply_cached`` :207-271, ``loss_fn`` :274, ``tiled_loss_fn`` :290,
``model_spec`` :308, ``init_paged_cache`` / ``apply_paged`` :330-382).

What differs from Llama (``models/llama.py``), as in the JAX package:

- LayerNorm with a bias (op ``layer_norm``: the LayerNorm kernel on CUDA
  tensors) instead of RMSNorm, and a plain two-matrix MLP with the exact
  (erf) GELU;
- three block variants: the classic parallel block of Falcon-7B
  (``x + attn(ln(x)) + mlp(ln(x))``, one LayerNorm feeding both branches),
  the new decoder architecture of Falcon-40B/180B (the parallel block with
  a separate ``ln_mlp``), and the sequential ``parallel_attn=False`` block
  (``ln_mlp`` is its post-attention norm);
- MQA (classic: ONE kv head) or grouped kv heads. K/V pass NARROW into op
  ``attention``, so on the card the flash kernels read the one kv head in
  place and dK/dV sums the whole group of query heads into it; they are
  never widened before the kernel;
- the head is tied to the embedding unless ``tie_embeddings=False`` (then
  an ``lm_head`` leaf exists); the tied embedding takes its gradient from
  both uses, as one leaf.

One block function (:func:`_block`) serves the three entry points: training
(:func:`apply` / :func:`loss_fn` / :func:`tiled_loss_fn`, causal attention:
the flash kernels), v1 serving (:func:`apply_cached` over the dense cache,
masked: plain attention, as the JAX package hands a masked call to XLA) and
v2 serving (the ``nn.Module`` :class:`Falcon`, whose ``forward`` is
``apply_paged`` over the paged cache: the paged decode and verify kernels).
Parameter names follow the JAX tree with the layer dim unstacked
(``layers.<i>.wq``), matrices in ``nn.Linear`` layout ``[out, in]``
(``models/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import layer_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from ..runtime.partitioning import LeafAxes, linear
from ._paged import init_paged_pools, join_kv, layer_kv, paged_attention_step, split_kv
from .llama import _split_batch, _write_cache, cache_mask


@dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_layers: int = 32
    num_heads: int = 71
    num_kv_heads: int = 1          # classic 7B MQA
    max_seq_len: int = 2048
    parallel_attn: bool = True
    new_decoder_architecture: bool = False
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    attention_bias: bool = False   # a field of the JAX config, which reads it nowhere
    tie_embeddings: bool = True    # the head is the embedding

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def separate_ln_mlp(self) -> bool:
        """Whether a layer has ``ln_mlp_*`` (JAX ``init`` :85-89)."""
        return self.new_decoder_architecture or not self.parallel_attn

    @property
    def num_params(self) -> int:
        h, hd, i, v = self.hidden_size, self.head_size, self.intermediate_size, self.vocab_size
        attn = 2 * h * self.num_heads * hd + 2 * h * self.num_kv_heads * hd
        norms = (4 if self.separate_ln_mlp else 2) * h
        embed = v * h * (1 if self.tie_embeddings else 2)
        return self.num_layers * (attn + 2 * h * i + norms) + embed + 2 * h

    @classmethod
    def tiny(cls, **kw) -> "FalconConfig":
        base = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                    num_kv_heads=1, max_seq_len=128)
        base.update(kw)
        return cls(**base)


def _layer_shapes(cfg: FalconConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, hd, i = cfg.hidden_size, cfg.head_size, cfg.intermediate_size
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    shapes = {"ln_attn_scale": ((h,), 0), "ln_attn_bias": ((h,), 0),
              "wq": ((nh * hd, h), h), "wk": ((nkv * hd, h), h), "wv": ((nkv * hd, h), h),
              "wo": ((h, nh * hd), nh * hd), "w_up": ((i, h), h), "w_down": ((h, i), i)}
    if cfg.separate_ln_mlp:
        shapes.update({"ln_mlp_scale": ((h,), 0), "ln_mlp_bias": ((h,), 0)})
    return shapes


def param_shapes(cfg: FalconConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in); matrices ``[out, in]``, the
    LayerNorm vectors with fan_in 0 (scales init to 1, biases to 0)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{name}": spec
                       for name, spec in _layer_shapes(cfg).items()})
    shapes["final_ln_scale"] = ((h,), 0)
    shapes["final_ln_bias"] = ((h,), 0)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((v, h), h)
    return shapes


def param_logical_axes(cfg: FalconConfig) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes`` :99), per
    layer and in the port's ``[out, in]`` layout."""
    vec = LeafAxes(("embed",))
    per_layer = {"ln_attn_scale": vec, "ln_attn_bias": vec, "ln_mlp_scale": vec,
                 "ln_mlp_bias": vec, "wq": linear("heads", "embed"),
                 "wk": linear("kv_heads", "embed"), "wv": linear("kv_heads", "embed"),
                 "wo": linear("embed", "heads"), "w_up": linear("mlp", "embed"),
                 "w_down": linear("embed", "mlp")}
    axes = {"embed": LeafAxes(("vocab", "embed")), "final_ln_scale": vec,
            "final_ln_bias": vec, "lm_head": linear("vocab", "embed")}
    return {name: axes[name] if name in axes else per_layer[name.rsplit(".", 1)[1]]
            for name in param_shapes(cfg)}


@torch.no_grad()
def init(cfg: FalconConfig, generator: torch.Generator, dtype=torch.float32,
         device=None, keep=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution:
    matrices and the embedding N(0, 1/fan_in), LayerNorm scales 1, biases 0;
    drawn on the generator's device; ``keep(name, leaf)`` as in
    ``models/llama.py`` ``init``."""
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


# --------------------------------------------------------------------------- #
# the block (JAX ``_attn_part`` / ``_block``), one for every entry point
# --------------------------------------------------------------------------- #
def _mlp(y: torch.Tensor, w) -> torch.Tensor:
    return F.linear(F.gelu(F.linear(y, w("w_up"))), w("w_down"))


def _block(cfg: FalconConfig, x: torch.Tensor, w, cos, sin, positions,
           attend) -> torch.Tensor:
    """One block over x [b, t, h]; ``w(name)`` reads a leaf of the layer and
    ``attend(q, k, v)`` is the entry point's attention over the narrow K/V
    ([b, t, nkv, hd]) of these tokens."""
    b, t, _ = x.shape
    nh, nkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_size, cfg.layer_norm_eps
    y_attn = layer_norm(x, w("ln_attn_scale"), w("ln_attn_bias"), eps)
    q = F.linear(y_attn, w("wq")).view(b, t, nh, hd)
    k = F.linear(y_attn, w("wk")).view(b, t, nkv, hd)
    v = F.linear(y_attn, w("wv")).view(b, t, nkv, hd)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    attn_out = F.linear(attend(q, k, v).reshape(b, t, nh * hd), w("wo"))
    if cfg.parallel_attn:
        y_mlp = layer_norm(x, w("ln_mlp_scale"), w("ln_mlp_bias"), eps) \
            if cfg.new_decoder_architecture else y_attn
        return x + attn_out + _mlp(y_mlp, w)
    # sequential (parallel_attn=False): ln_mlp is the post-attention norm
    x = x + attn_out
    return x + _mlp(layer_norm(x, w("ln_mlp_scale"), w("ln_mlp_bias"), eps), w)


def _block_leaves(cfg: FalconConfig, params: Mapping[str, torch.Tensor], l: int,
                  compute_dtype) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s leaves, read (ZeRO-3: gathered; v1: dequantized) and
    cast when the block is entered."""
    pre = f"layers.{l}."
    return {k: params[pre + k].to(compute_dtype) for k in _layer_shapes(cfg)}


def _head_split(cfg: FalconConfig, params: Mapping[str, torch.Tensor], x: torch.Tensor,
                compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final LayerNorm and the unembedding ``[vocab, hidden]`` (the tied
    ``embed``, else ``lm_head``) without the logits matmul."""
    x = layer_norm(x, params["final_ln_scale"].to(compute_dtype),
                   params["final_ln_bias"].to(compute_dtype), cfg.layer_norm_eps)
    head = params["lm_head"] if "lm_head" in params else params["embed"]
    return x, head.to(compute_dtype)


def _head(cfg, params, x, compute_dtype) -> torch.Tensor:
    x, head = _head_split(cfg, params, x, compute_dtype)
    return F.linear(x, head).float()


def _rope(cfg: FalconConfig, device):
    return rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta, device=device)


# --------------------------------------------------------------------------- #
# training (JAX ``apply`` / ``loss_fn`` / ``tiled_loss_fn``)
# --------------------------------------------------------------------------- #
def _causal(q, k, v):
    return attention(q, k, v, causal=True)


def apply(cfg: FalconConfig, params: Mapping[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None, compute_dtype=torch.bfloat16,
          return_hidden: bool = False):
    """Causal forward over the whole sequence → logits [b, s, vocab] fp32
    (or the :func:`_head_split` pair); a block's leaves are read when the
    forward enters it."""
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = _rope(cfg, x.device)
    for l in range(cfg.num_layers):
        x = _block(cfg, x, _block_leaves(cfg, params, l, compute_dtype).get, cos, sin,
                   positions, _causal)
    if return_hidden:
        return _head_split(cfg, params, x, compute_dtype)
    return _head(cfg, params, x, compute_dtype)


def loss_fn(cfg: FalconConfig, params: Mapping[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16):
    """Next-token cross-entropy in fp32, mean over the counted tokens
    (labels -100 not counted)."""
    inputs, labels = _split_batch(batch)
    logits = apply(cfg, params, inputs, compute_dtype=compute_dtype)
    ntokens = (labels != -100).sum()
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                            ignore_index=-100, reduction="sum")
    loss = total / torch.clamp(ntokens, min=1)
    return loss, {"loss": loss.detach(), "ntokens": ntokens}


def tiled_loss_fn(cfg: FalconConfig, params: Mapping[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16,
                  shards: int = 8):
    """:func:`loss_fn` with the unembedding and the cross-entropy fused a
    sequence tile at a time (``sequence.tiled_loss``)."""
    from ..sequence.tiled import tiled_fused_logits_loss

    inputs, labels = _split_batch(batch)
    hidden, head = apply(cfg, params, inputs, compute_dtype=compute_dtype,
                         return_hidden=True)
    loss = tiled_fused_logits_loss(hidden, head, labels, shards=shards)
    return loss, {"loss": loss.detach(), "ntokens": (labels != -100).sum()}


def model_spec(cfg: FalconConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec (JAX ``model_spec``); ``init_fn`` draws
    the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="falcon",
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
def init_cache(cfg: FalconConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Dense KV cache ``{"k", "v"}`` [layers, batch, max_len, kv_heads,
    head_dim] on ``device`` (the GPU unless ``device="cpu"``)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes(cfg: FalconConfig) -> Dict[str, LeafAxes]:
    spec = LeafAxes(("layers", None, None, "kv_heads", None))
    return {"k": spec, "v": spec}


def apply_cached(cfg: FalconConfig, params: Mapping[str, torch.Tensor],
                 tokens: torch.Tensor, cache: Dict[str, torch.Tensor], cache_len, *,
                 compute_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward with the dense KV cache (prefill when ``cache_len`` is 0,
    decode otherwise): each layer writes its K/V in place and attends over
    the cache. Returns (logits [b, t, vocab] fp32, cache)."""
    b, t = tokens.shape
    cache_len = torch.as_tensor(cache_len, device=tokens.device).long().expand(b)
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = _rope(cfg, x.device)
    positions = cache_len[:, None] + torch.arange(t, device=x.device)[None, :]
    mask = cache_mask(cache_len, t, cache["k"].shape[2])
    for l in range(cfg.num_layers):
        k_c, v_c = cache["k"][l], cache["v"][l]

        def attend(q, k, v, k_c=k_c, v_c=v_c):
            _write_cache(k_c, k, cache_len)
            _write_cache(v_c, v, cache_len)
            return attention(q, k_c, v_c, causal=False, mask=mask)

        x = _block(cfg, x, _block_leaves(cfg, params, l, compute_dtype).get, cos, sin,
                   positions, attend)
    return _head(cfg, params, x, compute_dtype), cache


# --------------------------------------------------------------------------- #
# v2 paged serving (JAX ``init_paged_cache`` / ``apply_paged``)
# --------------------------------------------------------------------------- #
def init_paged_cache(cfg: FalconConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda",
                     kv_quant_group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``{"k", "v"}`` pools ``[L, num_blocks, nkv, block_size, hd]`` (int8
    codes and fp32 scale pools with ``kv_quant_group``)."""
    return init_paged_pools(cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
                            cfg.head_size, dtype, device, kv_quant_group=kv_quant_group)


def _param(shape) -> nn.Parameter:
    # uninitialised: weights arrive through load_state_dict (or init())
    return nn.Parameter(torch.empty(shape))


class FalconBlock(nn.Module):
    """One block's parameters (``layers.<i>.*``) and its paged forward."""

    def __init__(self, cfg: FalconConfig):
        super().__init__()
        self.cfg = cfg
        for name, (shape, _) in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape))

    def forward(self, x, k_cache, v_cache, block_tables, context_lens, valid, cos, sin,
                positions) -> torch.Tensor:
        def attend(q, k, v):
            return paged_attention_step(q, k, v, k_cache, v_cache, block_tables,
                                        context_lens, positions, valid)[0]

        return _block(self.cfg, x, lambda name: getattr(self, name), cos, sin, positions,
                      attend)


class Falcon(nn.Module):
    """The paged-serving Falcon; ``forward`` is ``apply_paged``. The compute
    dtype is the parameters' dtype (the engine casts them to
    ``inference.dtype``)."""

    def __init__(self, cfg: FalconConfig):
        super().__init__()
        self.cfg = cfg
        h, v = cfg.hidden_size, cfg.vocab_size
        self.embed = _param((v, h))
        self.layers = nn.ModuleList(FalconBlock(cfg) for _ in range(cfg.num_layers))
        self.final_ln_scale = _param((h,))
        self.final_ln_bias = _param((h,))
        if not cfg.tie_embeddings:
            self.lm_head = _param((v, h))
        self._rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def rope(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 cos/sin tables, built once per device."""
        if self._rope is None or self._rope[0].device != torch.device(device):
            self._rope = _rope(self.cfg, device)
        return self._rope

    def forward(self, tokens, cache, block_tables, context_lens, valid=None):
        """tokens [B, t] at ``context_lens`` cached tokens a sequence (see
        ``models/llama.py`` ``Llama.forward``): (logits [B, t, vocab] fp32,
        cache), the cache written in place."""
        b, t = tokens.shape
        if valid is None:
            valid = torch.ones((b, t), dtype=torch.bool, device=tokens.device)
        x = embedding_lookup(self.embed, tokens, self.embed.dtype)
        cos, sin = self.rope(x.device)
        positions = context_lens.long()[:, None] + torch.arange(t, device=x.device)[None, :]
        k_pools, v_pools = split_kv(cache)
        for l, layer in enumerate(self.layers):
            x = layer(x, layer_kv(k_pools, l), layer_kv(v_pools, l), block_tables,
                      context_lens, valid, cos, sin, positions)
        top = dict(self.named_parameters(recurse=False))
        return _head(self.cfg, top, x, x.dtype), join_kv(k_pools, v_pools)


def build(cfg: FalconConfig) -> Falcon:
    """The module with uninitialised parameters (build it under
    ``torch.device("meta")`` and ``load_state_dict(..., assign=True)`` to
    place weights without a throwaway copy)."""
    return Falcon(cfg)


def apply_paged(cfg: FalconConfig, model: Falcon, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], block_tables: torch.Tensor,
                context_lens: torch.Tensor, *, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Functional entry with the JAX ``apply_paged`` signature."""
    if model.cfg != cfg:
        raise ValueError("model was built for another config")
    with torch.no_grad():
        return model(tokens, cache, block_tables, context_lens, valid)
