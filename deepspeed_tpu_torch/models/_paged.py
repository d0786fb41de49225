"""Shared paged-KV attention step — counterpart of
``deepspeed_tpu/models/_paged.py``: the v2 block-table protocol every family's
``apply_paged`` builds on.

Contract (as in the JAX package): the KV pool is
``[num_blocks, kv_heads, block_size, hd]`` per layer, block tables are
fixed-width ``[b, max_blocks]`` indices into the pool, block 0 is the trash
block that absorbs writes for padded tokens, and ``positions`` are absolute
token positions (``context_lens + arange(t)``).

This slice carries the plain (bf16 or fp32) pools only; the int8 pools of
``inference.kv_quant`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..ops.attention import attention
from ..ops.registry import get_op
from ..utils.device import resolve_device


def init_paged_pools(num_layers: int, num_blocks: int, num_kv_heads: int,
                     block_size: int, head_size: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """The ``{"k", "v"}`` pools, each
    ``[num_layers, num_blocks, nkv, block_size, hd]``, zero-filled, on
    ``device`` (the GPU unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    shape = (num_layers, num_blocks, num_kv_heads, block_size, head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def split_kv(cache: Dict[str, torch.Tensor]):
    """The cache dict → ``(k_entry, v_entry)`` for
    :func:`paged_attention_step` (plain pools: the tensors themselves)."""
    if "k_scale" in cache:
        raise NotImplementedError("quantized KV pools are not ported yet")
    return cache["k"], cache["v"]


def join_kv(k_entry: torch.Tensor, v_entry: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_kv`."""
    return {"k": k_entry, "v": v_entry}


def _gathered_view(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Dense [b, S, nkv, *] view of the pool rows the tables reference — the
    multi-token (prefill) read path's gather."""
    b, max_blocks = block_tables.shape
    g = pool[block_tables.long()]             # [b, mb, nkv, bs, *]
    g = g.transpose(2, 3)                     # [b, mb, bs, nkv, *]
    return g.reshape((b, max_blocks * g.shape[2]) + tuple(g.shape[3:]))


def paged_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         block_tables: torch.Tensor, context_lens: torch.Tensor,
                         positions: torch.Tensor, valid: torch.Tensor, *,
                         window: Optional[Union[int, torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter this step's K/V into the block pool, then attend over it.

    q [b, t, nh, hd]; k/v [b, t, nkv, hd]; pools [num_blocks, nkv, bs, hd].
    Single-token decode dispatches op ``paged_decode_attention`` (the
    kernel on CUDA tensors); multi-token prefill takes the gathered-view mask
    path in plain PyTorch, as the JAX package leaves it to XLA.

    Unlike the JAX version, which returns new pools, the scatter writes the
    pools IN PLACE (a pool is the largest tensor the engine holds — at
    Llama-3-8B widths 8.6 GB across layers — and PyTorch can update it where
    JAX must copy or donate). The returned pools are the same tensors.
    Returns (attn_out [b, t, nh, hd], k_cache, v_cache)."""
    b, t = q.shape[0], q.shape[1]
    bs = k_cache.shape[2]
    max_blocks = block_tables.shape[1]
    tables = block_tables.long()
    pos = positions.long()

    # padded positions may run past the table; they write to the trash block
    blk_idx = torch.gather(tables, 1, (pos // bs).clamp(max=max_blocks - 1))
    blk_idx = torch.where(valid, blk_idx, torch.zeros_like(blk_idx))
    off = pos % bs
    # advanced indices (blk_idx, off) straddle the kv-head slice, so the
    # indexed dims land in front: [b, t, nkv, hd] — exactly k's layout
    k_cache[blk_idx, :, off] = k.to(k_cache.dtype)
    v_cache[blk_idx, :, off] = v.to(v_cache.dtype)

    if t == 1:
        out = get_op("paged_decode_attention", q.device)(
            q[:, 0], k_cache, v_cache, block_tables, context_lens,
            window=window)[:, None]
    else:
        kg = _gathered_view(k_cache, block_tables)
        vg = _gathered_view(v_cache, block_tables)
        S = max_blocks * bs
        kv_pos = torch.arange(S, device=q.device)[None, None, None, :]
        q_abs = pos[:, None, :, None]
        mask = kv_pos <= q_abs
        if window is not None:
            mask = mask & (q_abs - kv_pos < window)
        out = attention(q, kg, vg, causal=False, mask=mask)
    return out, k_cache, v_cache
