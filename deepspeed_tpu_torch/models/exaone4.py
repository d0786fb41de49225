"""EXAONE-4 family — counterpart of ``deepspeed_tpu/models/exaone4.py``
(``Exaone4Config`` :39, ``init`` :81, ``param_logical_axes`` :113,
``_layer_scalars`` :135, ``_qkv`` :149, ``_block`` :162, ``_head_split`` /
``_head`` :198-213, ``apply`` :216, ``init_cache`` / ``apply_cached``
:236-295, ``loss_fn`` :298, ``tiled_loss_fn`` :317, ``model_spec`` :336,
``init_paged_cache`` / ``apply_paged`` :364-387).

What differs from Llama (``models/llama.py``), as in the JAX package:

- post-norm: ``x = x + rms(attn(x)); x = x + rms(mlp(x))``, the RMSNorm on
  the sublayer's output, no input norms;
- QK-norm: a per-head RMSNorm over rows of ``head_dim`` on q and k, before
  RoPE;
- hybrid attention: a layer pattern mixes sliding-window layers (RoPE and a
  windowed causal mask) with global layers (causal, and no RoPE at all when
  the config is hybrid). The JAX package scans two per-layer scalars; here
  each layer reads its own (:func:`layer_scalars`).

Attention: a hybrid config masks its attention, so it runs plain attention
in training and in v1, as the JAX package hands a masked call to XLA; a
pure-global config (``sliding_window=None``) takes the flash kernels. The
paged path (v2) passes each layer's window to ``models/_paged.py``: a decode
step reaches the paged kernel (``paged_sm90.cu``) with the sliding layers'
window and no window on the global ones (the JAX package's ``1 << 30``).

Parameter names follow the JAX tree with the layer dim unstacked
(``layers.<i>.q_norm``), matrices in ``nn.Linear`` layout ``[out, in]``
(``models/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from ..runtime.partitioning import LeafAxes, linear
from ._paged import init_paged_pools, join_kv, layer_kv, paged_attention_step, split_kv
from .llama import _split_batch, _write_cache, cache_mask

GLOBAL_WINDOW = 1 << 30   # the JAX package's "no window" on a global layer


@dataclass(frozen=True)
class Exaone4Config:
    vocab_size: int = 102400
    hidden_size: int = 4096
    intermediate_size: int = 16384
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    sliding_window: Optional[int] = 4096
    sliding_window_pattern: int = 4   # every Nth layer is global
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    layer_types: Optional[Tuple[str, ...]] = None  # overrides the pattern

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def resolved_layer_types(self) -> Tuple[str, ...]:
        if self.layer_types is not None:
            return tuple(self.layer_types)
        if self.sliding_window is None:
            return ("full_attention",) * self.num_layers
        # HF pattern: every `pattern`-th layer (1-indexed) is global
        return tuple("full_attention" if (i + 1) % self.sliding_window_pattern == 0
                     else "sliding_attention" for i in range(self.num_layers))

    @property
    def num_params(self) -> int:
        h, i, v, L, hd = (self.hidden_size, self.intermediate_size, self.vocab_size,
                          self.num_layers, self.head_size)
        attn = h * self.num_heads * hd + 2 * h * self.num_kv_heads * hd + self.num_heads * hd * h
        per_layer = attn + 3 * h * i + 2 * hd + 2 * h
        return L * per_layer + v * h * (1 if self.tie_embeddings else 2) + h

    @classmethod
    def tiny(cls, **kw) -> "Exaone4Config":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=4, num_heads=4, num_kv_heads=2,
                    max_seq_len=64, sliding_window=16,
                    sliding_window_pattern=2, rope_theta=10000.0)
        base.update(kw)
        return cls(**base)

    @classmethod
    def exaone4_32b(cls, **kw) -> "Exaone4Config":
        """EXAONE-4.0-32B's published widths (HF ``config.json``). RoPE is
        plain at theta 1e6: its llama3 ``rope_scaling`` is implemented by
        neither package."""
        base = dict(vocab_size=102400, hidden_size=5120, intermediate_size=27392,
                    num_layers=64, num_heads=40, num_kv_heads=8, head_dim=128,
                    max_seq_len=131072, sliding_window=4096, sliding_window_pattern=4,
                    rope_theta=1000000.0, rms_norm_eps=1e-5, tie_embeddings=False)
        base.update(kw)
        return cls(**base)


def layer_scalars(cfg: Exaone4Config) -> List[Tuple[Optional[int], bool]]:
    """(window, use_rope) of each layer (JAX ``_layer_scalars``): the
    sliding window on sliding layers, None (no window) on global ones; RoPE
    on sliding layers, and on every layer of a pure-global config."""
    return [(cfg.sliding_window if t == "sliding_attention" else None,
             cfg.sliding_window is None or t == "sliding_attention")
            for t in cfg.resolved_layer_types()]


_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _layer_shapes(cfg: Exaone4Config) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, hd = cfg.hidden_size, cfg.head_size
    nh, nkv, i = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    return {"wq": ((nh * hd, h), h), "wk": ((nkv * hd, h), h), "wv": ((nkv * hd, h), h),
            "wo": ((h, nh * hd), nh * hd), "q_norm": ((hd,), 0), "k_norm": ((hd,), 0),
            "post_attn_norm": ((h,), 0), "w_gate": ((i, h), h), "w_up": ((i, h), h),
            "w_down": ((h, i), i), "post_mlp_norm": ((h,), 0)}


def param_shapes(cfg: Exaone4Config) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in); matrices ``[out, in]``, norms
    with fan_in 0 (ones)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{k}": s for k, s in _layer_shapes(cfg).items()})
    shapes["final_norm"] = ((h,), 0)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((v, h), h)
    return shapes


def param_logical_axes(cfg: Exaone4Config) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes``), per
    layer and in the port's ``[out, in]`` layout."""
    per_layer = {"wq": linear("heads", "embed"), "wk": linear("kv_heads", "embed"),
                 "wv": linear("kv_heads", "embed"), "wo": linear("embed", "heads"),
                 "q_norm": LeafAxes((None,)), "k_norm": LeafAxes((None,)),
                 "post_attn_norm": LeafAxes(("embed",)), "w_gate": linear("mlp", "embed"),
                 "w_up": linear("mlp", "embed"), "w_down": linear("embed", "mlp"),
                 "post_mlp_norm": LeafAxes(("embed",))}
    axes = {"embed": LeafAxes(("vocab", "embed")), "final_norm": LeafAxes(("embed",)),
            "lm_head": linear("vocab", "embed")}
    return {n: axes[n] if n in axes else per_layer[n.rsplit(".", 1)[1]]
            for n in param_shapes(cfg)}


@torch.no_grad()
def init(cfg: Exaone4Config, generator: torch.Generator, dtype=torch.float32,
         device=None, keep=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution
    (matrices N(0, 1/fan_in), norms 1), drawn on the generator's device;
    ``keep(name, leaf)`` as in ``models/llama.py`` ``init``."""
    gen_device = generator.device
    device = gen_device if device is None else device
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, fan_in) in param_shapes(cfg).items():
        if fan_in:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=gen_device).mul_(fan_in ** -0.5)
            out[name] = w.to(device=device, dtype=dtype)
            del w
        else:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        if keep is not None:
            out[name] = keep(name, out[name])
    return out


# --------------------------------------------------------------------------- #
# training forward (JAX ``apply`` / ``loss_fn``)
# --------------------------------------------------------------------------- #
def _qkv(cfg: Exaone4Config, x: torch.Tensor, w, cos, sin, positions, use_rope: bool):
    """Projections, QK-norm over rows of head_dim, then RoPE on q and k
    when the layer uses it (JAX ``_qkv``)."""
    b, s, _ = x.shape
    nh, nkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_size, cfg.rms_norm_eps
    q = F.linear(x, w("wq")).view(b, s, nh, hd)
    k = F.linear(x, w("wk")).view(b, s, nkv, hd)
    v = F.linear(x, w("wv")).view(b, s, nkv, hd)
    q = rms_norm(q, w("q_norm"), eps)
    k = rms_norm(k, w("k_norm"), eps)
    if use_rope:
        q = apply_rotary(q, cos, sin, positions)
        k = apply_rotary(k, cos, sin, positions)
    return q, k, v


def _post(cfg: Exaone4Config, x: torch.Tensor, attn: torch.Tensor, w) -> torch.Tensor:
    """Post-norm residuals of the attention output and the MLP."""
    b, t = attn.shape[:2]
    eps = cfg.rms_norm_eps
    x = x + rms_norm(F.linear(attn.reshape(b, t, -1), w("wo")), w("post_attn_norm"), eps)
    mlp = F.linear(F.silu(F.linear(x, w("w_gate"))) * F.linear(x, w("w_up")), w("w_down"))
    return x + rms_norm(mlp, w("post_mlp_norm"), eps)


def _block(cfg: Exaone4Config, x: torch.Tensor, p: Dict[str, torch.Tensor], cos, sin,
           positions, window: Optional[int], use_rope: bool) -> torch.Tensor:
    """One block (JAX ``_block``): a pure-global config runs causal
    attention (the flash kernels on CUDA tensors); a hybrid one masks every
    layer (causal and, on sliding layers, ``q - kv < window``), plain."""
    s = x.shape[1]
    w = p.get
    q, k, v = _qkv(cfg, x, w, cos, sin, positions, use_rope)
    if cfg.sliding_window is None:
        out = attention(q, k, v, causal=True)
    else:
        pos = torch.arange(s, device=x.device)
        diff = pos[:, None] - pos[None, :]
        mask = (diff >= 0) & (diff < (GLOBAL_WINDOW if window is None else window))
        out = attention(q, k, v, causal=False, mask=mask[None, None])
    return _post(cfg, x, out, w)


def _block_leaves(cfg: Exaone4Config, params: Mapping[str, torch.Tensor], l: int,
                  compute_dtype) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s leaves, read (ZeRO-3: gathered; v1: dequantized) and
    cast when the block is entered."""
    pre = f"layers.{l}."
    return {k: params[pre + k].to(compute_dtype) for k in _layer_shapes(cfg)}


def _head_split(cfg: Exaone4Config, params: Mapping[str, torch.Tensor], x: torch.Tensor,
                compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    x = rms_norm(x, params["final_norm"].to(compute_dtype), cfg.rms_norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x, head.to(compute_dtype)


def _head(cfg, params, x, compute_dtype) -> torch.Tensor:
    x, head = _head_split(cfg, params, x, compute_dtype)
    return F.linear(x, head).float()


def apply(cfg: Exaone4Config, params: Mapping[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None, compute_dtype=torch.bfloat16,
          return_hidden: bool = False):
    """Forward over the whole sequence → logits [b, s, vocab] fp32 (or the
    :func:`_head_split` pair); a block's leaves are read when it is
    entered."""
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                device=x.device)
    for l, (window, rope) in enumerate(layer_scalars(cfg)):
        x = _block(cfg, x, _block_leaves(cfg, params, l, compute_dtype), cos, sin,
                   positions, window, rope)
    if return_hidden:
        return _head_split(cfg, params, x, compute_dtype)
    return _head(cfg, params, x, compute_dtype)


def loss_fn(cfg: Exaone4Config, params: Mapping[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16):
    """Next-token cross-entropy in fp32, mean over valid tokens (labels
    -100 ignored)."""
    inputs, labels = _split_batch(batch)
    logits = apply(cfg, params, inputs, compute_dtype=compute_dtype)
    valid = labels != -100
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                            ignore_index=-100, reduction="sum")
    ntokens = valid.sum()
    loss = total / torch.clamp(ntokens, min=1)
    return loss, {"loss": loss.detach(), "ntokens": ntokens}


def tiled_loss_fn(cfg: Exaone4Config, params: Mapping[str, torch.Tensor],
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


def model_spec(cfg: Exaone4Config, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec (JAX ``model_spec``)."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="exaone4",
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
# v1 dense-cache serving (JAX ``init_cache`` / ``apply_cached``)
# --------------------------------------------------------------------------- #
def init_cache(cfg: Exaone4Config, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Dense KV cache ``{"k", "v"}`` [layers, batch, max_len, kv_heads,
    head_dim] on ``device`` (the GPU unless ``device="cpu"``)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_cached(cfg: Exaone4Config, params: Mapping[str, torch.Tensor],
                 tokens: torch.Tensor, cache: Dict[str, torch.Tensor], cache_len, *,
                 compute_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward with the dense KV cache (JAX ``apply_cached``): each layer
    writes its K/V in place and attends under its own window. Returns
    (logits [b, t, vocab] fp32, cache)."""
    b, t = tokens.shape
    cache_len = torch.as_tensor(cache_len, device=tokens.device).long().expand(b)
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                device=x.device)
    positions = cache_len[:, None] + torch.arange(t, device=x.device)[None, :]
    S = cache["k"].shape[2]
    visible = cache_mask(cache_len, t, S)
    q_abs = cache_len[:, None, None, None] + torch.arange(t, device=x.device)[None, None, :, None]
    dist = q_abs - torch.arange(S, device=x.device)[None, None, None, :]
    for l, (window, rope) in enumerate(layer_scalars(cfg)):
        w = _block_leaves(cfg, params, l, compute_dtype).get
        q, k, v = _qkv(cfg, x, w, cos, sin, positions, rope)
        _write_cache(cache["k"][l], k, cache_len)
        _write_cache(cache["v"][l], v, cache_len)
        mask = visible & (dist < (GLOBAL_WINDOW if window is None else window))
        out = attention(q, cache["k"][l], cache["v"][l], causal=False, mask=mask)
        x = _post(cfg, x, out, w)
    return _head(cfg, params, x, compute_dtype), cache


# --------------------------------------------------------------------------- #
# v2 paged serving (JAX ``init_paged_cache`` / ``apply_paged``)
# --------------------------------------------------------------------------- #
def init_paged_cache(cfg: Exaone4Config, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda",
                     kv_quant_group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``{"k", "v"}`` pools ``[L, num_blocks, nkv, block_size, hd]`` (int8
    codes and fp32 scale pools with ``kv_quant_group``)."""
    return init_paged_pools(cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
                            cfg.head_size, dtype, device, kv_quant_group=kv_quant_group)


def _param(shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape))


class Exaone4Block(nn.Module):
    """One block over the paged cache, with its layer's window and RoPE
    flag."""

    def __init__(self, cfg: Exaone4Config, window: Optional[int], use_rope: bool):
        super().__init__()
        self.cfg, self.window, self.use_rope = cfg, window, use_rope
        for name, (shape, _) in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape))

    def forward(self, x, k_cache, v_cache, block_tables, context_lens, valid, cos, sin,
                positions) -> torch.Tensor:
        w = lambda name: getattr(self, name)  # noqa: E731
        q, k, v = _qkv(self.cfg, x, w, cos, sin, positions, self.use_rope)
        attn, _, _ = paged_attention_step(q, k, v, k_cache, v_cache, block_tables,
                                          context_lens, positions, valid,
                                          window=self.window)
        return _post(self.cfg, x, attn, w)


class Exaone4(nn.Module):
    """The paged-serving EXAONE-4; ``forward`` is ``apply_paged``. The
    compute dtype is the parameters' dtype."""

    def __init__(self, cfg: Exaone4Config):
        super().__init__()
        self.cfg = cfg
        h, v = cfg.hidden_size, cfg.vocab_size
        self.embed = _param((v, h))
        self.layers = nn.ModuleList(Exaone4Block(cfg, window, rope)
                                    for window, rope in layer_scalars(cfg))
        self.final_norm = _param((h,))
        if not cfg.tie_embeddings:
            self.lm_head = _param((v, h))
        self._rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def rope(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._rope is None or self._rope[0].device != torch.device(device):
            cfg = self.cfg
            self._rope = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                          device=device)
        return self._rope

    def forward(self, tokens, cache, block_tables, context_lens, valid=None):
        cfg = self.cfg
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
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        return F.linear(x, head).float(), join_kv(k_pools, v_pools)


def build(cfg: Exaone4Config) -> Exaone4:
    """The module with uninitialised parameters."""
    return Exaone4(cfg)


def apply_paged(cfg: Exaone4Config, model: Exaone4, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], block_tables: torch.Tensor,
                context_lens: torch.Tensor, *, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Functional entry with the JAX ``apply_paged`` signature."""
    if model.cfg != cfg:
        raise ValueError("model was built for another config")
    with torch.no_grad():
        return model(tokens, cache, block_tables, context_lens, valid)
