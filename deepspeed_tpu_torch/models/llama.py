"""Llama-family model over the paged KV cache — counterpart of
``deepspeed_tpu/models/llama.py`` (``LlamaConfig`` :49, ``init`` :121,
``init_paged_cache`` :550, ``apply_paged`` :590).

The JAX package keeps the model as a pure function over a stacked param
pytree; here it is an ``nn.Module`` (:class:`Llama`) whose ``forward`` is
``apply_paged``. Parameter names follow the JAX tree with the leading layer
dim unstacked (``layers.<i>.wq`` for ``layers/wq[i]``); every matrix is kept
in ``nn.Linear`` layout ``[out, in]`` (the JAX ``x @ W`` matrices transposed,
see ``models/convert.py``). Norm, rotary and attention go through the
port's ops: RMSNorm and single-token paged attention reach their CUDA
kernels on CUDA tensors, the projections, MLP and lm-head stay
``torch.matmul`` as the JAX package leaves them to XLA.

Supports GQA, RoPE, SwiGLU, RMSNorm, optional tied embeddings, QKV biases
(Qwen2) and per-head q/k RMSNorm (Qwen3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embedding import embedding_lookup
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from ._paged import init_paged_pools, join_kv, paged_attention_step, split_kv


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


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in) of every parameter; matrices in
    ``nn.Linear`` layout ``[out, in]``, vectors with fan_in 0 (init to 1 or
    0, as in the JAX ``init``)."""
    h, hd = cfg.hidden_size, cfg.head_size
    nh, nkv, i, v = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h)}
    for l in range(cfg.num_layers):
        p = f"layers.{l}."
        shapes.update({
            p + "attn_norm": ((h,), 0),
            p + "wq": ((nh * hd, h), h),
            p + "wk": ((nkv * hd, h), h),
            p + "wv": ((nkv * hd, h), h),
            p + "wo": ((h, nh * hd), nh * hd),
            p + "mlp_norm": ((h,), 0),
            p + "w_gate": ((i, h), h),
            p + "w_up": ((i, h), h),
            p + "w_down": ((h, i), i),
        })
        if cfg.attention_bias:
            shapes.update({p + "bq": ((nh * hd,), 0), p + "bk": ((nkv * hd,), 0),
                           p + "bv": ((nkv * hd,), 0)})
        if cfg.qk_norm:
            shapes.update({p + "q_norm": ((hd,), 0), p + "k_norm": ((hd,), 0)})
    shapes["final_norm"] = ((h,), 0)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((v, h), h)
    return shapes


@torch.no_grad()
def init(cfg: LlamaConfig, generator: torch.Generator, dtype=torch.float32,
         device=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution:
    matrices N(0, 1/fan_in), norms 1, biases 0. The draws are made on the
    generator's device (in fp32, then cast), and the weights stay there
    unless ``device`` says otherwise, so a CUDA generator builds an 8B model
    on the card without a host copy."""
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
    return out


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """``{"k", "v"}`` pools ``[L, num_blocks, nkv, block_size, hd]`` on
    ``device`` (the GPU unless the caller passes ``device="cpu"``)."""
    return init_paged_pools(cfg.num_layers, num_blocks, cfg.num_kv_heads,
                            block_size, cfg.head_size, dtype, device)


def _param(shape) -> nn.Parameter:
    # uninitialised: weights arrive through load_state_dict (or init())
    return nn.Parameter(torch.empty(shape), requires_grad=False)


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

    def forward(self, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, block_tables: torch.Tensor,
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
        marks real (non-pad) tokens. Returns (logits [B, t, vocab] fp32,
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
            x = layer(x, k_pools[l], v_pools[l], block_tables, context_lens,
                      valid, cos, sin, positions)
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        logits = F.linear(x, head)
        return logits.float(), join_kv(k_pools, v_pools)


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
