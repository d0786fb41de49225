"""Inference v2 module system: typed module slots with config-driven,
pluggable implementation selection — counterpart of
``deepspeed_tpu/inference/modules.py`` (configs :28-67, ``DSModuleRegistry``
:85, default implementations :131-268).

Each slot resolves to the port's ops: an implementation is a plain callable
over tensors, and the op it bridges onto picks the CUDA kernel for CUDA
tensors and the plain version for CPU tensors (``ops/registry.py``), so the
same engine code serves CPU tests and the card. The ``weight_only_quant``
linear dequantizes through op ``dequantize_int8`` (``ops/csrc/quantize.cu``
on the card), straight into the activations' dtype.

The ``moe`` slot's implementation (``top_k_gating``) is not ported yet:
instantiating it raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..utils.logging import logger

# --------------------------------------------------------------------------- #
# Configs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ModuleConfig:
    dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class AttentionConfig(ModuleConfig):
    num_heads: int = 0
    num_kv_heads: int = 0
    head_size: int = 0
    paged: bool = False          # block-table (ragged decode) layout
    kv_quant: bool = False       # int8 KV pools + fused in-kernel dequant


@dataclass(frozen=True)
class LinearConfig(ModuleConfig):
    quant_bits: Optional[int] = None   # None | 8 | 4 (weight-only)
    activation: Optional[str] = None   # fused epilogue: 'gelu'|'silu'|'relu'|None


@dataclass(frozen=True)
class NormConfig(ModuleConfig):
    kind: str = "rms"            # 'rms' | 'layer'
    eps: float = 1e-5


@dataclass(frozen=True)
class EmbeddingConfig(ModuleConfig):
    vocab_sharded: bool = False


@dataclass(frozen=True)
class UnembedConfig(ModuleConfig):
    tile_tokens: Optional[int] = None   # tiled logits when set


@dataclass(frozen=True)
class MoEConfig(ModuleConfig):
    num_experts: int = 0
    top_k: int = 2


# --------------------------------------------------------------------------- #
# Registry (ConfigBundle → implementation)
# --------------------------------------------------------------------------- #

_SLOTS = ("attention", "linear", "norm", "embedding", "unembed", "moe")


@dataclass
class _Impl:
    name: str
    supports: Callable[[ModuleConfig], bool]
    build: Callable[[ModuleConfig], Callable]
    priority: int = 0


class DSModuleRegistry:
    """Per-slot implementation registry. ``instantiate(slot, config)``
    returns the highest-priority implementation whose ``supports(config)``
    accepts the config."""

    def __init__(self):
        self._impls: Dict[str, List[_Impl]] = {s: [] for s in _SLOTS}

    def register(self, slot: str, name: str, *,
                 supports: Callable[[ModuleConfig], bool] = lambda c: True,
                 priority: int = 0):
        assert slot in _SLOTS, f"unknown module slot {slot!r}"

        def deco(build):
            self._impls[slot].append(
                _Impl(name=name, supports=supports, build=build,
                      priority=priority))
            self._impls[slot].sort(key=lambda i: -i.priority)
            return build

        return deco

    def instantiate(self, slot: str, config: ModuleConfig) -> Callable:
        for impl in self._impls[slot]:
            try:
                ok = impl.supports(config)
            except Exception:
                ok = False
            if ok:
                logger.debug("modules: %s ← %s", slot, impl.name)
                return impl.build(config)
        raise ValueError(f"no implementation for slot {slot!r} supports "
                         f"{config}")

    def implementations(self, slot: str) -> List[str]:
        return [i.name for i in self._impls[slot]]


registry = DSModuleRegistry()


# --------------------------------------------------------------------------- #
# Default implementations — thin bridges onto the port's ops
# --------------------------------------------------------------------------- #


@registry.register("attention", "dense",
                   supports=lambda c: not c.paged, priority=0)
def _dense_attention(cfg: AttentionConfig):
    from ..ops.attention import attention

    return attention


@registry.register("attention", "paged",
                   supports=lambda c: c.paged, priority=10)
def _paged_attention(cfg: AttentionConfig):
    from ..ops.registry import op

    return op("paged_decode_attention")


@registry.register("attention", "paged_int8kv",
                   supports=lambda c: c.paged and c.kv_quant, priority=20)
def _paged_attention_quant(cfg: AttentionConfig):
    """Quantized-KV paged decode: int8 code pools + per-position-per-group
    scale pools, dequantized in the kernel's registers. The caller MUST pass
    ``k_scale`` / ``v_scale`` (enforced here so a mis-wired engine fails
    loudly instead of attending over raw int8 codes)."""
    from ..ops.registry import op

    paged_decode_attention = op("paged_decode_attention")

    def quant_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                        k_scale, v_scale, **kw):
        return paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      context_lens, k_scale=k_scale,
                                      v_scale=v_scale, **kw)

    return quant_attention


@registry.register("norm", "rms", supports=lambda c: c.kind == "rms")
def _rms_norm(cfg: NormConfig):
    from ..ops.norms import rms_norm

    return lambda x, scale, bias=None: rms_norm(x, scale, cfg.eps)


@registry.register("norm", "layer", supports=lambda c: c.kind == "layer")
def _layer_norm(cfg: NormConfig):
    from ..ops.norms import layer_norm

    return lambda x, scale, bias: layer_norm(x, scale, bias, cfg.eps)


def _act(name):
    # jax.nn.gelu defaults to the tanh approximation
    return {None: lambda x: x, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "silu": F.silu, "relu": F.relu}[name]


@registry.register("linear", "dense", supports=lambda c: c.quant_bits is None)
def _dense_linear(cfg: LinearConfig):
    """``w`` is ``[in, out]`` (``x @ w``), as in the JAX module system."""
    act = _act(cfg.activation)

    def linear(x, w, b=None):
        y = x @ w.to(x.dtype)
        if b is not None:
            y = y + b.to(x.dtype)
        return act(y)

    return linear


@registry.register("linear", "weight_only_quant",
                   # int8 group quant only: the packed-int4 path of the v1
                   # engine's ``quant`` block is not ported
                   supports=lambda c: c.quant_bits == 8, priority=5)
def _quant_linear(cfg: LinearConfig):
    from ..ops.quantization import dequantize_int8

    act = _act(cfg.activation)

    def linear(x, qw, scales, b=None):
        # written in x's dtype by the op: the same values as an fp32 result
        # cast afterwards (one rounding of the fp32 product either way)
        w = dequantize_int8(qw, scales, group_size=qw.numel() // scales.numel(),
                            dtype=x.dtype)
        y = x @ w
        if b is not None:
            y = y + b.to(x.dtype)
        return act(y)

    return linear


@registry.register("embedding", "lookup")
def _embedding(cfg: EmbeddingConfig):
    from ..ops.embedding import embedding_lookup

    return lambda table, tokens: embedding_lookup(table, tokens, cfg.dtype)


@registry.register("unembed", "full", supports=lambda c: c.tile_tokens is None)
def _unembed(cfg: UnembedConfig):
    def unembed(x, head):
        return (x @ head.to(x.dtype)).float()

    return unembed


@registry.register("unembed", "tiled",
                   supports=lambda c: c.tile_tokens is not None, priority=5)
def _unembed_tiled(cfg: UnembedConfig):
    """Tiled logits: the matmul runs over ``tile_tokens`` rows at a time, so
    only one tile's bf16 product is live beside the fp32 output."""
    T = cfg.tile_tokens

    def unembed(x, head):
        flat = x.reshape(-1, x.shape[-1])
        head = head.to(x.dtype)
        out = torch.empty((flat.shape[0], head.shape[-1]), dtype=torch.float32,
                          device=x.device)
        for start in range(0, flat.shape[0], T):
            out[start:start + T] = flat[start:start + T] @ head
        return out.reshape(x.shape[:-1] + (head.shape[-1],))

    return unembed


@registry.register("moe", "dense_dispatch")
def _moe(cfg: MoEConfig):
    raise NotImplementedError(
        "the moe slot's top_k_gating (moe/sharded_moe.py) is not ported yet: "
        "ROADMAP.md queue A.7")
