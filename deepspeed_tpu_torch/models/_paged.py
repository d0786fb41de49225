"""Shared paged-KV attention step — counterpart of
``deepspeed_tpu/models/_paged.py``: the v2 block-table protocol every family's
``apply_paged`` builds on.

Contract (as in the JAX package): the KV pool is
``[num_blocks, kv_heads, block_size, hd]`` per layer, block tables are
fixed-width ``[b, max_blocks]`` indices into the pool, block 0 is the trash
block that absorbs writes for padded tokens, and ``positions`` are absolute
token positions (``context_lens + arange(t)``).

Quantized KV mode (``inference.kv_quant``): the cache dict also carries
``k_scale``/``v_scale`` pools ``[num_blocks, kv_heads, block_size, ngroups]``
fp32, the K/V pools hold int8 codes, and :func:`paged_attention_step`
receives each pool as a ``(codes, scales)`` tuple (:func:`split_kv`).
Quantization happens at fill time inside the cache scatter (per-token
groupwise scales: a token's write never touches another position's scale);
the decode and fused-verify kernels dequantize in registers, and the
multi-token prefill read dequantizes its gathered view. No pass over the
pool converts it to bf16.

Fused speculative verification (``inference.speculative.fused_verify``):
the engine's verify forward runs under :func:`fused_verify_scope`, and only
there does a multi-token step dispatch op ``paged_spec_verify_attention``
instead of the gathered-view prefill read.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple, Union

import torch

from ..ops.paged_attention import paged_spec_verify_attention_torch
from ..ops.quantization import kv_quantize_int8
from ..ops.registry import get_op
from ..utils.device import resolve_device

_FUSED_VERIFY = {"on": False}


def fused_verify_active() -> bool:
    return _FUSED_VERIFY["on"]


@contextmanager
def fused_verify_scope():
    """Dispatch multi-token attention to the spec-verify op for the
    duration of the block (the engine wraps its verify forward in it)."""
    prev = _FUSED_VERIFY["on"]
    _FUSED_VERIFY["on"] = True
    try:
        yield
    finally:
        _FUSED_VERIFY["on"] = prev


def init_paged_pools(num_layers: int, num_blocks: int, num_kv_heads: int,
                     block_size: int, head_size: int, dtype=torch.bfloat16,
                     device="cuda", kv_quant_group: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """The ``{"k", "v"}`` pools, each
    ``[num_layers, num_blocks, nkv, block_size, hd]``, zero-filled, on
    ``device`` (the GPU unless the caller passes ``device="cpu"``). With
    ``kv_quant_group`` (``inference.kv_quant.group_size``, clamped to
    ``head_size``) the pools hold int8 codes, with fp32
    ``[num_layers, num_blocks, nkv, block_size, ngroups]`` ``k_scale`` /
    ``v_scale`` pools beside them that start at zero, so unwritten positions
    and the trash block dequantize to exact zeros."""
    device = resolve_device(device)
    shape = (num_layers, num_blocks, num_kv_heads, block_size, head_size)
    if kv_quant_group is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    gs = min(int(kv_quant_group), head_size)
    if gs < 1 or head_size % gs:
        raise ValueError(f"kv_quant.group_size {kv_quant_group} does not divide "
                         f"head_size {head_size}")
    sshape = shape[:-1] + (head_size // gs,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}


def split_kv(cache: Dict[str, torch.Tensor]):
    """The cache dict → ``(k_entry, v_entry)`` for
    :func:`paged_attention_step`: plain pools stay tensors, quantized pools
    become ``(codes, scales)`` tuples."""
    if "k_scale" in cache:
        return ((cache["k"], cache["k_scale"]),
                (cache["v"], cache["v_scale"]))
    return cache["k"], cache["v"]


def join_kv(k_entry, v_entry) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_kv`."""
    if isinstance(k_entry, tuple):
        return {"k": k_entry[0], "k_scale": k_entry[1],
                "v": v_entry[0], "v_scale": v_entry[1]}
    return {"k": k_entry, "v": v_entry}


def layer_kv(entry, l: int):
    """Layer ``l``'s pool (a view) of a :func:`split_kv` entry."""
    if isinstance(entry, tuple):
        return entry[0][l], entry[1][l]
    return entry[l]


PoolEntry = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def paged_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_cache: PoolEntry, v_cache: PoolEntry,
                         block_tables: torch.Tensor, context_lens: torch.Tensor,
                         positions: torch.Tensor, valid: torch.Tensor, *,
                         window: Optional[Union[int, torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, PoolEntry, PoolEntry]:
    """Scatter this step's K/V into the block pool, then attend over it.

    q [b, t, nh, hd]; k/v [b, t, nkv, hd]; pools [num_blocks, nkv, bs, hd],
    or ``(codes, scales)`` tuples in quantized mode. Single-token decode
    dispatches op ``paged_decode_attention``; under
    :func:`fused_verify_scope` a multi-token step dispatches op
    ``paged_spec_verify_attention`` (the kernels on CUDA tensors); otherwise
    multi-token prefill takes the gathered-view mask read in plain PyTorch,
    as the JAX package leaves it to XLA. ``positions`` are
    ``context_lens + arange(t)``.

    Unlike the JAX version, which returns new pools, the scatter writes the
    pools IN PLACE (a pool is the largest tensor the engine holds — at
    Llama-3-8B widths 8.6 GB across layers in bf16 — and PyTorch can update
    it where JAX must copy or donate); in quantized mode codes and scales
    are written in the same step. The returned pools are the same tensors.
    Returns (attn_out [b, t, nh, hd], k_cache, v_cache)."""
    b, t = q.shape[0], q.shape[1]
    hd = k.shape[-1]
    quant = isinstance(k_cache, tuple)
    k_pool, k_scales = k_cache if quant else (k_cache, None)
    v_pool, v_scales = v_cache if quant else (v_cache, None)
    bs = k_pool.shape[2]
    max_blocks = block_tables.shape[1]
    tables = block_tables.long()
    pos = positions.long()

    # padded positions may run past the table; they write to the trash block
    blk_idx = torch.gather(tables, 1, (pos // bs).clamp(max=max_blocks - 1))
    blk_idx = torch.where(valid, blk_idx, torch.zeros_like(blk_idx))
    off = pos % bs
    # advanced indices (blk_idx, off) straddle the kv-head slice, so the
    # indexed dims land in front: [b, t, nkv, hd] — exactly k's layout
    if quant:
        group_size = hd // k_scales.shape[-1]
        qk, sk = kv_quantize_int8(k, group_size)
        qv, sv = kv_quantize_int8(v, group_size)
        k_pool[blk_idx, :, off] = qk
        v_pool[blk_idx, :, off] = qv
        k_scales[blk_idx, :, off] = sk
        v_scales[blk_idx, :, off] = sv
        scales = {"k_scale": k_scales, "v_scale": v_scales}
    else:
        k_pool[blk_idx, :, off] = k.to(k_pool.dtype)
        v_pool[blk_idx, :, off] = v.to(v_pool.dtype)
        scales = {}

    if t == 1:
        out = get_op("paged_decode_attention", q.device)(
            q[:, 0], k_pool, v_pool, block_tables, context_lens,
            window=window, **scales)[:, None]
    elif fused_verify_active():
        out = get_op("paged_spec_verify_attention", q.device)(
            q, k_pool, v_pool, block_tables, context_lens, window=window,
            **scales)
    else:
        # the prefill read: a dense gathered view of the table's rows (the
        # int8 view dequantized), masked to positions <= each token's own —
        # plain PyTorch on any device, as the JAX package leaves it to XLA.
        # It is the spec-verify op's plain version, which the JAX package
        # keeps expression for expression equal to this read.
        out = paged_spec_verify_attention_torch(
            q, k_pool, v_pool, block_tables, context_lens, window=window,
            **scales)
    return out, k_cache, v_cache
