"""Llama-family model — counterpart of ``deepspeed_tpu/models/llama.py``
(``LlamaConfig`` :49, ``init`` :121, ``_block`` :330, ``_head_split`` :363,
``apply`` :381, ``init_cache`` … ``apply_cached`` :459-542,
``init_paged_cache`` :550, ``apply_paged`` :590, ``model_spec`` :627,
``loss_fn`` :727, ``tiled_loss_fn`` :746).

Three entry points over one set of parameters:

- training: :func:`apply` / :func:`loss_fn` / :func:`tiled_loss_fn`, pure
  functions over a flat param dict (the JAX ``apply`` over its pytree),
  wrapped for the engine by :func:`model_spec`. Attention is op
  ``attention``: the flash kernels (``ops/csrc/flash_*.cu``) on CUDA
  tensors, plain attention on CPU tensors. With ``cfg.remat`` each block
  runs under ``runtime/activation_checkpointing``'s ``checkpoint`` and reads
  its leaves inside it, so ZeRO stage 3 gathers them again in the recompute
  rather than keeping them; the block marks the values the name policies
  save (:data:`CHECKPOINT_NAMES_EMITTED`).
- v1 serving: :func:`apply_cached` over the dense KV cache of
  :func:`init_cache` (the v1 engine, ``inference/engine.py``); its
  attention is masked, so plain attention, as the JAX package hands every
  masked call to XLA.
- v2 serving: the ``nn.Module`` :class:`Llama`, whose ``forward`` is
  ``apply_paged`` over the paged KV cache.

Parameter names follow the JAX tree with the leading layer dim unstacked
(``layers.<i>.wq`` for ``layers/wq[i]``); every matrix is kept in
``nn.Linear`` layout ``[out, in]`` (the JAX ``x @ W`` matrices transposed,
see ``models/convert.py``). RMSNorm reaches its CUDA kernel on CUDA tensors
(with a plain backward), the projections, MLP and lm-head stay
``torch.matmul`` as the JAX package leaves them to XLA.

Supports GQA, RoPE, SwiGLU, RMSNorm, optional tied embeddings, QKV biases
(Qwen2) and per-head q/k RMSNorm (Qwen3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from ..runtime.activation_checkpointing import checkpointing as ac
from ..runtime.activation_checkpointing.checkpointing import checkpoint_name
from ..runtime.partitioning import LeafAxes, linear
from ._paged import (init_paged_pools, join_kv, layer_kv, paged_attention_step,
                     split_kv)

# the checkpoint names the training block attaches (the name policies'
# saveables; a test holds every name a policy saves to this list)
CHECKPOINT_NAMES_EMITTED = ("qkv_proj", "attn_mix", "attn_out",
                            "mlp_gate", "mlp_up", "mlp_out")

# cfg.remat_policy -> the registry policy that wraps each block (JAX :423)
_REMAT_NAMES = {"none": "full", "full": "full", "dots": "dots_saveable"}


def remat_policy(remat_policy: str) -> str:
    return _REMAT_NAMES.get(remat_policy, remat_policy)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attention_bias: bool = False  # QKV biases (Qwen2; HF attention_bias flag)
    qk_norm: bool = False         # per-head RMSNorm on q/k pre-rotary (Qwen3)
    remat: bool = False           # checkpoint each training block
    remat_policy: str = "none"    # none | full | dots | any registry policy

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def num_params(self) -> int:
        h, i, v, L = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        hd = self.head_size
        attn = h * self.num_heads * hd + 2 * h * self.num_kv_heads * hd + self.num_heads * hd * h
        mlp = 3 * h * i
        norms = 2 * h
        embed = v * h * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp + norms) + embed + h

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
                    rope_theta=10000.0)
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8,
                   max_seq_len=8192, rope_theta=10000.0)

    @classmethod
    def qwen2_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                   num_layers=28, num_heads=28, num_kv_heads=4,
                   max_seq_len=32768, rope_theta=1000000.0)

    @classmethod
    def phi3_mini(cls) -> "LlamaConfig":
        return cls(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                   num_layers=32, num_heads=32, num_kv_heads=32,
                   max_seq_len=4096, rope_theta=10000.0)


def _layer_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, hd = cfg.hidden_size, cfg.head_size
    nh, nkv, i = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    shapes = {"attn_norm": ((h,), 0), "wq": ((nh * hd, h), h), "wk": ((nkv * hd, h), h),
              "wv": ((nkv * hd, h), h), "wo": ((h, nh * hd), nh * hd),
              "mlp_norm": ((h,), 0), "w_gate": ((i, h), h), "w_up": ((i, h), h),
              "w_down": ((h, i), i)}
    if cfg.attention_bias:
        shapes.update({"bq": ((nh * hd,), 0), "bk": ((nkv * hd,), 0),
                       "bv": ((nkv * hd,), 0)})
    if cfg.qk_norm:
        shapes.update({"q_norm": ((hd,), 0), "k_norm": ((hd,), 0)})
    return shapes


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in) of every parameter; matrices in
    ``nn.Linear`` layout ``[out, in]``, vectors with fan_in 0 (init to 1 or
    0, as in the JAX ``init``)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{name}": spec
                       for name, spec in _layer_shapes(cfg).items()})
    shapes["final_norm"] = ((h,), 0)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((v, h), h)
    return shapes


def param_logical_axes(cfg: LlamaConfig) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes`` :158),
    for the partitioner (``runtime/partitioning.py``): per layer, and in the
    port's ``[out, in]`` layout."""
    per_layer = {"attn_norm": LeafAxes(("embed",)), "wq": linear("heads", "embed"),
                 "wk": linear("kv_heads", "embed"), "wv": linear("kv_heads", "embed"),
                 "wo": linear("embed", "heads"), "mlp_norm": LeafAxes(("embed",)),
                 "w_gate": linear("mlp", "embed"), "w_up": linear("mlp", "embed"),
                 "w_down": linear("embed", "mlp"), "bq": LeafAxes(("heads",)),
                 "bk": LeafAxes(("kv_heads",)), "bv": LeafAxes(("kv_heads",)),
                 "q_norm": LeafAxes((None,)), "k_norm": LeafAxes((None,))}
    axes = {"embed": LeafAxes(("vocab", "embed")), "final_norm": LeafAxes(("embed",)),
            "lm_head": linear("vocab", "embed")}
    return {name: axes[name] if name in axes else per_layer[name.rsplit(".", 1)[1]]
            for name in param_shapes(cfg)}


@torch.no_grad()
def init(cfg: LlamaConfig, generator: torch.Generator, dtype=torch.float32,
         device=None, keep=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution:
    matrices N(0, 1/fan_in), norms 1, biases 0. The draws are made on the
    generator's device (in fp32, then cast), and the weights stay there
    unless ``device`` says otherwise, so a CUDA generator builds an 8B model
    on the card without a host copy. ``keep(name, leaf)``, if given, is
    applied to each leaf as it is drawn and its result kept (``zero.Init``
    keeps a shard, so no whole model exists at once)."""
    gen_device = generator.device
    device = gen_device if device is None else device
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, fan_in) in param_shapes(cfg).items():
        if fan_in:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=gen_device).mul_(fan_in ** -0.5)
            out[name] = w.to(device=device, dtype=dtype)
            del w
        elif name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        if keep is not None:
            out[name] = keep(name, out[name])
    return out


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda",
                     kv_quant_group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``{"k", "v"}`` pools ``[L, num_blocks, nkv, block_size, hd]`` on
    ``device`` (the GPU unless the caller passes ``device="cpu"``); with
    ``kv_quant_group``, int8 code pools and their fp32 ``k_scale`` /
    ``v_scale`` pools (``models/_paged.py`` ``init_paged_pools``)."""
    return init_paged_pools(cfg.num_layers, num_blocks, cfg.num_kv_heads,
                            block_size, cfg.head_size, dtype, device,
                            kv_quant_group=kv_quant_group)


def _param(shape) -> nn.Parameter:
    # uninitialised: weights arrive through load_state_dict (or init());
    # serving runs under no_grad (apply_paged) on a module it froze itself
    return nn.Parameter(torch.empty(shape))


class LlamaBlock(nn.Module):
    """One transformer block over the paged cache (JAX ``_block_paged``)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_size
        nh, nkv, i = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
        self.attn_norm = _param((h,))
        self.wq = _param((nh * hd, h))
        self.wk = _param((nkv * hd, h))
        self.wv = _param((nkv * hd, h))
        self.wo = _param((h, nh * hd))
        self.mlp_norm = _param((h,))
        self.w_gate = _param((i, h))
        self.w_up = _param((i, h))
        self.w_down = _param((h, i))
        if cfg.attention_bias:
            self.bq = _param((nh * hd,))
            self.bk = _param((nkv * hd,))
            self.bv = _param((nkv * hd,))
        if cfg.qk_norm:
            self.q_norm = _param((hd,))
            self.k_norm = _param((hd,))

    def forward(self, x: torch.Tensor, k_cache, v_cache,
                block_tables: torch.Tensor,
                context_lens: torch.Tensor, valid: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        nh, nkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_size, cfg.rms_norm_eps
        y = rms_norm(x, self.attn_norm, eps)
        q = F.linear(y, self.wq, getattr(self, "bq", None)).view(b, t, nh, hd)
        k = F.linear(y, self.wk, getattr(self, "bk", None)).view(b, t, nkv, hd)
        v = F.linear(y, self.wv, getattr(self, "bv", None)).view(b, t, nkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, eps)
            k = rms_norm(k, self.k_norm, eps)
        q = apply_rotary(q, cos, sin, positions)
        k = apply_rotary(k, cos, sin, positions)
        attn, _, _ = paged_attention_step(q, k, v, k_cache, v_cache,
                                          block_tables, context_lens,
                                          positions, valid)
        x = x + F.linear(attn.reshape(b, t, nh * hd), self.wo)
        y = rms_norm(x, self.mlp_norm, eps)
        mlp = F.silu(F.linear(y, self.w_gate)) * F.linear(y, self.w_up)
        return x + F.linear(mlp, self.w_down)


class Llama(nn.Module):
    """The paged-serving Llama. ``forward`` is ``apply_paged``: a ragged
    forward over the paged cache for prefill chunks or decode steps. The
    compute dtype is the parameters' dtype (the engine casts them to
    ``inference.dtype``)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h, v = cfg.hidden_size, cfg.vocab_size
        self.embed = _param((v, h))
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.num_layers))
        self.final_norm = _param((h,))
        if not cfg.tie_embeddings:
            self.lm_head = _param((v, h))
        self._rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def rope(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 cos/sin tables, built once per device."""
        if self._rope is None or self._rope[0].device != torch.device(device):
            cfg = self.cfg
            self._rope = rope_frequencies(cfg.head_size, cfg.max_seq_len,
                                          cfg.rope_theta, device=device)
        return self._rope

    def forward(self, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                block_tables: torch.Tensor, context_lens: torch.Tensor,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B, t]; context_lens [B] tokens already cached per sequence;
        block_tables [B, max_blocks] int32 into the shared pool; valid [B, t]
        marks real (non-pad) tokens; ``cache`` holds plain pools or int8
        pools with their scale pools. Returns (logits [B, t, vocab] fp32,
        cache), the cache updated in place."""
        cfg = self.cfg
        b, t = tokens.shape
        if valid is None:
            valid = torch.ones((b, t), dtype=torch.bool, device=tokens.device)
        x = embedding_lookup(self.embed, tokens, self.embed.dtype)
        cos, sin = self.rope(x.device)
        positions = context_lens.long()[:, None] + \
            torch.arange(t, device=x.device)[None, :]
        k_pools, v_pools = split_kv(cache)
        for l, layer in enumerate(self.layers):
            x = layer(x, layer_kv(k_pools, l), layer_kv(v_pools, l), block_tables,
                      context_lens, valid, cos, sin, positions)
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        logits = F.linear(x, head)
        return logits.float(), join_kv(k_pools, v_pools)


# --------------------------------------------------------------------------- #
# full-sequence training forward (JAX ``apply`` / ``loss_fn``)
# --------------------------------------------------------------------------- #
def _qkv_proj(cfg: LlamaConfig, y: torch.Tensor, w) -> Tuple[torch.Tensor, ...]:
    """QKV projections (JAX ``_qkv_proj``), each marked ``qkv_proj``, as
    [b, s, heads, hd]; Qwen3's per-head q/k RMSNorm after them."""
    b, s, _ = y.shape
    nh, nkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_size, cfg.rms_norm_eps
    q = checkpoint_name(F.linear(y, w("wq"), w("bq")), "qkv_proj").view(b, s, nh, hd)
    k = checkpoint_name(F.linear(y, w("wk"), w("bk")), "qkv_proj").view(b, s, nkv, hd)
    v = checkpoint_name(F.linear(y, w("wv"), w("bv")), "qkv_proj").view(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w("q_norm"), eps)
        k = rms_norm(k, w("k_norm"), eps)
    return q, k, v


def _mlp(cfg: LlamaConfig, x: torch.Tensor, w) -> torch.Tensor:
    y = rms_norm(x, w("mlp_norm"), cfg.rms_norm_eps)
    gate = F.silu(checkpoint_name(F.linear(y, w("w_gate")), "mlp_gate"))
    up = checkpoint_name(F.linear(y, w("w_up")), "mlp_up")
    return x + checkpoint_name(F.linear(gate * up, w("w_down")), "mlp_out")


def _block(cfg: LlamaConfig, x: torch.Tensor, p: Dict[str, torch.Tensor],
           cos: torch.Tensor, sin: torch.Tensor,
           positions: Optional[torch.Tensor]) -> torch.Tensor:
    """One transformer block (JAX ``_block`` with ``_qkv_proj``); x
    [batch, seq, hidden] and the block's leaves ``p`` in the compute dtype.
    The checkpoint names sit where the JAX block puts them."""
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_size
    w = p.get
    y = rms_norm(x, w("attn_norm"), cfg.rms_norm_eps)
    q, k, v = _qkv_proj(cfg, y, w)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    attn = checkpoint_name(attention(q, k, v, causal=True), "attn_mix")
    x = x + checkpoint_name(F.linear(attn.reshape(b, s, nh * hd), w("wo")), "attn_out")
    return _mlp(cfg, x, w)


def _block_leaves(cfg: LlamaConfig, params: Mapping[str, torch.Tensor], l: int,
                  compute_dtype) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s leaves, read (ZeRO stage 3: gathered; the v1 engine:
    dequantized) and cast to ``compute_dtype`` when the block is entered."""
    pre = f"layers.{l}."
    return {name: params[pre + name].to(compute_dtype) for name in _layer_shapes(cfg)}


def _head_split(cfg: LlamaConfig, params: Mapping[str, torch.Tensor], x: torch.Tensor,
                compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final norm and the unembedding ``[vocab, hidden]`` without the logits
    matmul (JAX ``_head_split``), the pair the tiled loss head takes."""
    x = rms_norm(x, params["final_norm"].to(compute_dtype), cfg.rms_norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x, head.to(compute_dtype)


def _head(cfg: LlamaConfig, params: Mapping[str, torch.Tensor], x: torch.Tensor,
          compute_dtype) -> torch.Tensor:
    x, head = _head_split(cfg, params, x, compute_dtype)
    return F.linear(x, head).float()


def apply(cfg: LlamaConfig, params: Mapping[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None,
          compute_dtype=torch.bfloat16, return_hidden: bool = False):
    """Causal forward over the whole sequence → logits [batch, seq, vocab]
    fp32; with ``return_hidden`` the :func:`_head_split` pair instead.
    ``params`` maps :func:`param_shapes` names to tensors, cast to
    ``compute_dtype`` here as the JAX ``apply`` casts its layers, so grads
    of fp32 params flow back through the cast. A block's leaves are read
    when the forward enters the block (ZeRO stage 3 gathers them then);
    with ``cfg.remat`` that read is inside the checkpointed block, under the
    policy of ``cfg.remat_policy`` (JAX :417-425)."""
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                device=x.device)

    def block(x, l):
        return _block(cfg, x, _block_leaves(cfg, params, l, compute_dtype), cos, sin,
                      positions)

    policy = remat_policy(cfg.remat_policy)
    for l in range(cfg.num_layers):
        x = ac.checkpoint(block, x, l, policy=policy) if cfg.remat else block(x, l)
    if return_hidden:
        return _head_split(cfg, params, x, compute_dtype)
    return _head(cfg, params, x, compute_dtype)


def _split_batch(batch: Dict[str, torch.Tensor]):
    tokens = batch["tokens"]
    if "labels" in batch:
        return tokens, batch["labels"].long()
    return tokens[:, :-1], tokens[:, 1:].long()


def loss_fn(cfg: LlamaConfig, params: Mapping[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32, mean over valid tokens. batch:
    ``{"tokens": [b, s+1]}`` or ``{"tokens": [b, s], "labels": [b, s]}``
    with -100 = ignore."""
    inputs, labels = _split_batch(batch)
    logits = apply(cfg, params, inputs, compute_dtype=compute_dtype)
    valid = labels != -100
    token_loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1), ignore_index=-100,
                                 reduction="sum")
    ntokens = valid.sum()
    loss = token_loss / torch.clamp(ntokens, min=1)
    return loss, {"loss": loss.detach(), "ntokens": ntokens}


def tiled_loss_fn(cfg: LlamaConfig, params: Mapping[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16,
                  shards: int = 8) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`loss_fn` with the unembedding and the cross-entropy fused a
    sequence tile at a time (``sequence.tiled_loss``): the [B, S, V] logits
    never exist, one [B, S/shards, V] tile at a time does."""
    from ..sequence.tiled import tiled_fused_logits_loss

    inputs, labels = _split_batch(batch)
    hidden, head = apply(cfg, params, inputs, compute_dtype=compute_dtype,
                         return_hidden=True)
    loss = tiled_fused_logits_loss(hidden, head, labels, shards=shards)
    return loss, {"loss": loss.detach(), "ntokens": (labels != -100).sum()}


def model_spec(cfg: LlamaConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec for this config (JAX ``model_spec``);
    ``init_fn`` draws the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="llama",
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
def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Dense KV cache ``{"k", "v"}``: [layers, batch, max_len, kv_heads,
    head_dim] zeros on ``device`` (the GPU unless the caller passes
    ``device="cpu"``)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes(cfg: LlamaConfig) -> Dict[str, LeafAxes]:
    spec = LeafAxes(("layers", None, None, "kv_heads", None))
    return {"k": spec, "v": spec}


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 starts: torch.Tensor) -> torch.Tensor:
    """Write new K/V rows into the cache at per-sequence offsets, in place
    (JAX ``_write_cache``; a start past ``S - t`` is clamped, as
    ``dynamic_update_slice`` clamps it). cache [b, S, kv, hd], new
    [b, t, kv, hd], starts [b]."""
    b, t = new.shape[:2]
    start = starts.long().clamp(min=0, max=cache.shape[1] - t)
    rows = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    cache[torch.arange(b, device=cache.device)[:, None], rows] = new.to(cache.dtype)
    return cache


def cache_mask(cache_len: torch.Tensor, t: int, S: int) -> torch.Tensor:
    """[b, 1, t, S]: kv slot j is visible to query i (absolute position
    ``cache_len + i``) iff j <= cache_len + i."""
    dev = cache_len.device
    q_abs = cache_len.long()[:, None, None, None] + torch.arange(t, device=dev)[None, None, :, None]
    return torch.arange(S, device=dev)[None, None, None, :] <= q_abs


def _block_cached(cfg: LlamaConfig, x: torch.Tensor, p: Dict[str, torch.Tensor],
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  cache_len: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """One block that writes its K/V into the layer's cache (in place) and
    attends over it (JAX ``_block_cached``). x [b, t, h]; cache_len [b]."""
    b, t, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_size
    w = p.get
    y = rms_norm(x, w("attn_norm"), cfg.rms_norm_eps)
    q, k, v = _qkv_proj(cfg, y, w)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    _write_cache(k_cache, k, cache_len)
    _write_cache(v_cache, v, cache_len)
    mask = cache_mask(cache_len, t, k_cache.shape[1])
    attn = attention(q, k_cache, v_cache, causal=False, mask=mask)
    x = x + F.linear(attn.reshape(b, t, nh * hd), w("wo"))
    return _mlp(cfg, x, w)


def apply_cached(cfg: LlamaConfig, params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                 cache: Dict[str, torch.Tensor], cache_len: torch.Tensor, *,
                 compute_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward with the dense KV cache (prefill when ``cache_len`` is 0,
    decode otherwise; JAX ``apply_cached``). tokens [b, t]; cache_len [b]
    (or a scalar) valid cache slots per sequence. Returns (logits
    [b, t, vocab] fp32, cache), the cache written in place."""
    b, t = tokens.shape
    cache_len = torch.as_tensor(cache_len, device=tokens.device).long().expand(b)
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                device=x.device)
    positions = cache_len[:, None] + torch.arange(t, device=x.device)[None, :]
    for l in range(cfg.num_layers):
        x = _block_cached(cfg, x, _block_leaves(cfg, params, l, compute_dtype),
                          cache["k"][l], cache["v"][l], cache_len, cos, sin, positions)
    return _head(cfg, params, x, compute_dtype), cache


def build(cfg: LlamaConfig) -> Llama:
    """The module with uninitialised parameters (build it under
    ``torch.device("meta")`` and ``load_state_dict(..., assign=True)`` to
    place weights without a throwaway copy)."""
    return Llama(cfg)


def apply_paged(cfg: LlamaConfig, model: Llama, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], block_tables: torch.Tensor,
                context_lens: torch.Tensor, *,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Functional entry with the JAX ``apply_paged`` signature."""
    if model.cfg != cfg:
        raise ValueError("model was built for another config")
    with torch.no_grad():
        return model(tokens, cache, block_tables, context_lens, valid)
