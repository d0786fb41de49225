"""Llama-family model — counterpart of ``deepspeed_tpu/models/llama.py``
(``LlamaConfig`` :49, ``init`` :121, ``apply`` :381, ``loss_fn`` :727,
``model_spec`` :627, ``init_paged_cache`` :550, ``apply_paged`` :590).

Two entry points over one set of parameters:

- training: :func:`apply` / :func:`loss_fn`, pure functions over a flat
  param dict (the JAX ``apply`` over its pytree), wrapped for the engine by
  :func:`model_spec`. Attention is op ``attention``: the flash kernels
  (``ops/csrc/flash_*.cu``) on CUDA tensors, plain attention on CPU tensors.
- serving: the ``nn.Module`` :class:`Llama`, whose ``forward`` is
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
from ..runtime.partitioning import LeafAxes, linear
from ._paged import (init_paged_pools, join_kv, layer_kv, paged_attention_step,
                     split_kv)


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
def _block(cfg: LlamaConfig, x: torch.Tensor, p: Dict[str, torch.Tensor],
           cos: torch.Tensor, sin: torch.Tensor,
           positions: Optional[torch.Tensor]) -> torch.Tensor:
    """One transformer block (JAX ``_block`` with ``_qkv_proj``); x
    [batch, seq, hidden] and the block's leaves ``p`` in the compute dtype."""
    b, s, _ = x.shape
    nh, nkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_size, cfg.rms_norm_eps
    w = p.get
    y = rms_norm(x, w("attn_norm"), eps)
    q = F.linear(y, w("wq"), w("bq")).view(b, s, nh, hd)
    k = F.linear(y, w("wk"), w("bk")).view(b, s, nkv, hd)
    v = F.linear(y, w("wv"), w("bv")).view(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w("q_norm"), eps)
        k = rms_norm(k, w("k_norm"), eps)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    attn = attention(q, k, v, causal=True)
    x = x + F.linear(attn.reshape(b, s, nh * hd), w("wo"))
    y = rms_norm(x, w("mlp_norm"), eps)
    mlp = F.silu(F.linear(y, w("w_gate"))) * F.linear(y, w("w_up"))
    return x + F.linear(mlp, w("w_down"))


def apply(cfg: LlamaConfig, params: Mapping[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Causal forward over the whole sequence → logits [batch, seq, vocab]
    fp32. ``params`` maps :func:`param_shapes` names to tensors, cast to
    ``compute_dtype`` here as the JAX ``apply`` casts its layers, so grads
    of fp32 params flow back through the cast. A block's leaves are read
    when the forward enters the block (ZeRO stage 3 gathers them then)."""
    cast = lambda t: t.to(compute_dtype)  # noqa: E731
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                device=x.device)
    names = tuple(_layer_shapes(cfg))
    for l in range(cfg.num_layers):
        block = {name: cast(params[f"layers.{l}.{name}"]) for name in names}
        x = _block(cfg, x, block, cos, sin, positions)
    x = rms_norm(x, cast(params["final_norm"]), cfg.rms_norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return F.linear(x, cast(head)).float()


def loss_fn(cfg: LlamaConfig, params: Mapping[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32, mean over valid tokens. batch:
    ``{"tokens": [b, s+1]}`` or ``{"tokens": [b, s], "labels": [b, s]}``
    with -100 = ignore."""
    tokens = batch["tokens"]
    if "labels" in batch:
        inputs, labels = tokens, batch["labels"]
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits = apply(cfg, params, inputs, compute_dtype=compute_dtype)
    labels = labels.long()
    valid = labels != -100
    token_loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1), ignore_index=-100,
                                 reduction="sum")
    ntokens = valid.sum()
    loss = token_loss / torch.clamp(ntokens, min=1)
    return loss, {"loss": loss.detach(), "ntokens": ntokens}


def model_spec(cfg: LlamaConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec for this config (JAX ``model_spec``);
    ``init_fn`` draws the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="llama",
        init_fn=lambda gen, **kw: init(cfg, gen, **kw),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch,
                                              compute_dtype=compute_dtype),
        compute_dtype=compute_dtype,
        logical_axes=param_logical_axes(cfg),
        config=cfg,
    )


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
