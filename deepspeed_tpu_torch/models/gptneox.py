"""GPT-NeoX / GPT-J family — counterpart of
``deepspeed_tpu/models/gptneox.py`` (``GPTNeoXConfig`` :43, ``init`` :95,
``param_logical_axes`` :137, ``_qkv`` / ``_mlp`` / ``_block`` :172-214,
``_head_split`` / ``_head`` :217-235, ``apply`` :244, ``init_cache`` …
``apply_cached`` :264-322, ``loss_fn`` :325, ``tiled_loss_fn`` :341,
``model_spec`` :361).

One config covers both architectures; their differences are flags, as in
the JAX package:

==============  ======================  =========================
                GPT-NeoX (20B)          GPT-J (6B, ``gptj_6b``)
==============  ======================  =========================
norms           ln1 + ln2 (parallel)    one shared ln
rotary          ``rotary_pct`` of the   ``rotary_dim`` 64 of 256,
                head (24 of 96), halves interleaved pairs
attn biases     q / k / v / o           none
mlp biases      yes                     yes
lm_head         no bias                 ``lm_head_bias``
gelu            erf                     tanh (``gelu_approx``)
==============  ======================  =========================

Both run parallel residual blocks (``x + attn(ln1(x)) + mlp(ln2(x))``);
``parallel_residual=False`` is the sequential ordering. Rotary covers only
the first ``rot_dim`` dims of each head, with frequencies over ``rot_dim``
(not the head size, JAX :250). Training attention is causal (op
``attention``: the flash kernels on CUDA tensors; GPT-NeoX-20B's head dim
96 runs their hd-96 instantiations); v1's dense-cache reads are masked, so
plain attention, as in the JAX package. The JAX family has no paged path,
so neither has this one: ``build_engine_v2`` refuses it.

Parameter names follow the JAX tree with the layer dim unstacked, matrices
in ``nn.Linear`` layout ``[out, in]`` (``models/convert.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import layer_norm
from ..ops.rotary import apply_rotary_partial, rope_frequencies
from ..runtime.partitioning import LeafAxes, linear
from .llama import _split_batch, _write_cache, cache_mask


@dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_layers: int = 44
    num_heads: int = 64
    max_seq_len: int = 2048
    rotary_pct: float = 0.25
    rotary_dim: Optional[int] = None     # explicit override (GPT-J: 64)
    rotary_interleaved: bool = False     # GPT-J rotate-every-two
    parallel_residual: bool = True
    shared_ln: bool = False              # GPT-J: one ln feeds both branches
    qkv_bias: bool = True
    attn_out_bias: bool = True
    mlp_bias: bool = True
    lm_head_bias: bool = False           # GPT-J: True
    gelu_approx: bool = False            # NeoX 'gelu' (erf); GPT-J 'gelu_new' (tanh)
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.shared_ln and not self.parallel_residual:
            raise ValueError("shared_ln requires parallel_residual (the "
                             "sequential ordering needs a distinct post-"
                             "attention norm)")

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rot_dim(self) -> int:
        if self.rotary_dim is not None:
            return self.rotary_dim
        return int(self.head_size * self.rotary_pct)

    @property
    def num_params(self) -> int:
        h, v = self.hidden_size, self.vocab_size
        per_layer = sum(math.prod(s) for s, _ in _layer_shapes(self).values())
        return self.num_layers * per_layer + 2 * v * h + 2 * h + \
            (v if self.lm_head_bias else 0)

    @classmethod
    def tiny(cls, **kw) -> "GPTNeoXConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, max_seq_len=128)
        base.update(kw)
        return cls(**base)

    @classmethod
    def gptj_6b(cls) -> "GPTNeoXConfig":
        return cls(vocab_size=50400, hidden_size=4096, intermediate_size=16384,
                   num_layers=28, num_heads=16, max_seq_len=2048,
                   rotary_dim=64, rotary_interleaved=True, shared_ln=True,
                   qkv_bias=False, attn_out_bias=False, lm_head_bias=True,
                   gelu_approx=True)


def _layer_shapes(cfg: GPTNeoXConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, i = cfg.hidden_size, cfg.intermediate_size
    a = cfg.num_heads * cfg.head_size
    shapes = {"ln1_scale": ((h,), 0), "ln1_bias": ((h,), 0),
              "wq": ((a, h), h), "wk": ((a, h), h), "wv": ((a, h), h),
              "wo": ((h, a), a), "w_up": ((i, h), h), "w_down": ((h, i), i)}
    if not cfg.shared_ln:
        shapes.update({"ln2_scale": ((h,), 0), "ln2_bias": ((h,), 0)})
    if cfg.qkv_bias:
        shapes.update({"bq": ((a,), 0), "bk": ((a,), 0), "bv": ((a,), 0)})
    if cfg.attn_out_bias:
        shapes["bo"] = ((h,), 0)
    if cfg.mlp_bias:
        shapes.update({"b_up": ((i,), 0), "b_down": ((h,), 0)})
    return shapes


def param_shapes(cfg: GPTNeoXConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in); matrices ``[out, in]``,
    vectors with fan_in 0 (LayerNorm scales init to 1, biases to 0)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{name}": spec
                       for name, spec in _layer_shapes(cfg).items()})
    shapes.update({"final_ln_scale": ((h,), 0), "final_ln_bias": ((h,), 0),
                   "lm_head": ((v, h), h)})
    if cfg.lm_head_bias:
        shapes["lm_head_bias"] = ((v,), 0)
    return shapes


def param_logical_axes(cfg: GPTNeoXConfig) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes`` :137),
    per layer and in the port's ``[out, in]`` layout."""
    vec = lambda name: LeafAxes((name,))  # noqa: E731
    per_layer = {"ln1_scale": vec("embed"), "ln1_bias": vec("embed"),
                 "ln2_scale": vec("embed"), "ln2_bias": vec("embed"),
                 "wq": linear("heads", "embed"), "wk": linear("heads", "embed"),
                 "wv": linear("heads", "embed"), "wo": linear("embed", "heads"),
                 "w_up": linear("mlp", "embed"), "w_down": linear("embed", "mlp"),
                 "bq": vec("heads"), "bk": vec("heads"), "bv": vec("heads"),
                 "bo": vec("embed"), "b_up": vec("mlp"), "b_down": vec("embed")}
    axes = {"embed": LeafAxes(("vocab", "embed")), "final_ln_scale": vec("embed"),
            "final_ln_bias": vec("embed"), "lm_head": linear("vocab", "embed"),
            "lm_head_bias": vec("vocab")}
    return {name: axes[name] if name in axes else per_layer[name.rsplit(".", 1)[1]]
            for name in param_shapes(cfg)}


@torch.no_grad()
def init(cfg: GPTNeoXConfig, generator: torch.Generator, dtype=torch.float32,
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
# the block (JAX ``_qkv`` / ``_mlp`` / ``_block``)
# --------------------------------------------------------------------------- #
def _qkv(cfg: GPTNeoXConfig, y: torch.Tensor, w, cos, sin, positions):
    """Projections (with the optional biases) as [b, s, heads, hd], q and k
    rotated over their first ``rot_dim`` dims."""
    b, s, _ = y.shape
    nh, hd = cfg.num_heads, cfg.head_size
    q = F.linear(y, w("wq"), w("bq")).view(b, s, nh, hd)
    k = F.linear(y, w("wk"), w("bk")).view(b, s, nh, hd)
    v = F.linear(y, w("wv"), w("bv")).view(b, s, nh, hd)
    rot = partial(apply_rotary_partial, rotary_dim=cfg.rot_dim,
                  interleaved=cfg.rotary_interleaved)
    return rot(q, cos, sin, positions), rot(k, cos, sin, positions), v


def _mlp(cfg: GPTNeoXConfig, y: torch.Tensor, w) -> torch.Tensor:
    u = F.gelu(F.linear(y, w("w_up"), w("b_up")),
               approximate="tanh" if cfg.gelu_approx else "none")
    return F.linear(u, w("w_down"), w("b_down"))


def _block(cfg: GPTNeoXConfig, x: torch.Tensor, w, cos, sin, positions,
           attend) -> torch.Tensor:
    """One block over x [b, t, h]; ``w(name)`` reads a leaf of the layer
    (None for a bias the config leaves out) and ``attend(q, k, v)`` is the
    entry point's attention."""
    b, t, _ = x.shape
    eps = cfg.layer_norm_eps
    y1 = layer_norm(x, w("ln1_scale"), w("ln1_bias"), eps)
    q, k, v = _qkv(cfg, y1, w, cos, sin, positions)
    attn_out = F.linear(attend(q, k, v).reshape(b, t, -1), w("wo"), w("bo"))
    if cfg.parallel_residual:
        y2 = y1 if cfg.shared_ln else layer_norm(x, w("ln2_scale"), w("ln2_bias"), eps)
        return x + attn_out + _mlp(cfg, y2, w)
    x = x + attn_out
    return x + _mlp(cfg, layer_norm(x, w("ln2_scale"), w("ln2_bias"), eps), w)


def _block_leaves(cfg: GPTNeoXConfig, params: Mapping[str, torch.Tensor], l: int,
                  compute_dtype) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s leaves, read (ZeRO-3: gathered; v1: dequantized) and
    cast when the block is entered."""
    pre = f"layers.{l}."
    return {k: params[pre + k].to(compute_dtype) for k in _layer_shapes(cfg)}


def _head_split(cfg: GPTNeoXConfig, params: Mapping[str, torch.Tensor], x: torch.Tensor,
                compute_dtype):
    """Final LayerNorm, the unembedding ``[vocab, hidden]`` and the optional
    logit bias (JAX ``_head_split``), without the logits matmul: the triple
    the tiled loss head takes."""
    x = layer_norm(x, params["final_ln_scale"].to(compute_dtype),
                   params["final_ln_bias"].to(compute_dtype), cfg.layer_norm_eps)
    bias = params.get("lm_head_bias")
    return (x, params["lm_head"].to(compute_dtype),
            None if bias is None else bias.to(compute_dtype))


def _head(cfg, params, x, compute_dtype) -> torch.Tensor:
    x, head, bias = _head_split(cfg, params, x, compute_dtype)
    return F.linear(x, head, bias).float()


def _rope(cfg: GPTNeoXConfig, device):
    return rope_frequencies(cfg.rot_dim, cfg.max_seq_len, cfg.rope_theta, device=device)


# --------------------------------------------------------------------------- #
# training (JAX ``apply`` / ``loss_fn`` / ``tiled_loss_fn``)
# --------------------------------------------------------------------------- #
def _causal(q, k, v):
    return attention(q, k, v, causal=True)


def apply(cfg: GPTNeoXConfig, params: Mapping[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None, compute_dtype=torch.bfloat16,
          return_hidden: bool = False):
    """Causal forward over the whole sequence → logits [b, s, vocab] fp32
    (or the :func:`_head_split` triple); a block's leaves are read when the
    forward enters it."""
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = _rope(cfg, x.device)
    for l in range(cfg.num_layers):
        x = _block(cfg, x, _block_leaves(cfg, params, l, compute_dtype).get, cos, sin,
                   positions, _causal)
    if return_hidden:
        return _head_split(cfg, params, x, compute_dtype)
    return _head(cfg, params, x, compute_dtype)


def loss_fn(cfg: GPTNeoXConfig, params: Mapping[str, torch.Tensor],
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


def tiled_loss_fn(cfg: GPTNeoXConfig, params: Mapping[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16,
                  shards: int = 8):
    """:func:`loss_fn` with the unembedding, its bias and the cross-entropy
    fused a sequence tile at a time (``sequence.tiled_loss``)."""
    from ..sequence.tiled import tiled_fused_logits_loss

    inputs, labels = _split_batch(batch)
    hidden, head, bias = apply(cfg, params, inputs, compute_dtype=compute_dtype,
                               return_hidden=True)
    loss = tiled_fused_logits_loss(hidden, head, labels, shards=shards, bias=bias)
    return loss, {"loss": loss.detach(), "ntokens": (labels != -100).sum()}


def model_spec(cfg: GPTNeoXConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec (JAX ``model_spec``); ``init_fn`` draws
    the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="gptneox",
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
def init_cache(cfg: GPTNeoXConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Dense KV cache ``{"k", "v"}`` [layers, batch, max_len, heads,
    head_dim] on ``device`` (the GPU unless ``device="cpu"``)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_heads, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes(cfg: GPTNeoXConfig) -> Dict[str, LeafAxes]:
    spec = LeafAxes(("layers", None, None, "heads", None))
    return {"k": spec, "v": spec}


def apply_cached(cfg: GPTNeoXConfig, params: Mapping[str, torch.Tensor],
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
