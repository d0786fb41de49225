"""Paged (blocked-KV) decode attention — counterpart of
``deepspeed_tpu/ops/pallas/paged_attention.py`` (bf16 mode).

Two implementations of op ``paged_decode_attention``, chosen by the input's
device (``ops/registry.py``):

- :func:`paged_decode_attention_torch`, the plain version, with the
  semantics of ``paged_decode_attention_xla`` (``paged_attention.py:239``):
  gather the pool rows the block table references into a dense view, mask
  positions past ``ctx`` (and at or before ``ctx - window``), softmax in
  fp32. It serves CPU tensors and is the oracle the kernel is held against.
- :func:`paged_decode_attention_cuda`, the wrapper of the hand-written
  kernel ``ops/csrc/paged_decode.cu``, which replaces the TPU kernel
  ``_decode_kernel`` (``paged_attention.py:74``): one block per (kv head,
  sequence), walking only the live positions through the block table with
  an fp32 online softmax; its header note gives the bound.
  ``paged_decode_attention_cuda.launches`` counts its kernel launches.

Layout (as in the JAX package):
  q            [B, nh, hd]
  k/v pool     [num_blocks, nkv, bs, hd]   (block 0 = trash block)
  block_tables [B, max_blocks] int32
  context_lens [B] int32 — tokens ALREADY cached; the current token's K/V is
               written to the pool before the call, so ctx + 1 positions
               are attended.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import _build
from .registry import register

NEG_INF = -1e30

Window = Optional[Union[int, torch.Tensor]]


def _check_window(window: Window) -> Window:
    """Same ``window >= 1`` contract as the JAX kernel: a static value below
    1 is refused; a tensor is clamped to >= 1."""
    if window is None:
        return None
    if isinstance(window, torch.Tensor):
        if window.numel() != 1:
            raise ValueError(f"window tensor must hold one value, got shape "
                             f"{tuple(window.shape)}")
        return window
    window = int(window)
    if window < 1:
        raise ValueError(f"sliding window must be >= 1, got {window}")
    return window


@register("paged_decode_attention", backend="torch")
def paged_decode_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 context_lens: torch.Tensor, *,
                                 scale: Optional[float] = None,
                                 window: Window = None) -> torch.Tensor:
    """Dense-gather reference with the kernel's semantics. Returns
    [B, nh, hd] in q's dtype."""
    B, nh, hd = q.shape
    num_blocks, nkv, bs, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    S = max_blocks * bs
    g = nh // nkv
    scale = hd ** -0.5 if scale is None else scale
    window = _check_window(window)
    tables = block_tables.long().clamp(0, num_blocks - 1)
    # [B, mb, nkv, bs, hd] -> [B, nkv, S, hd]
    kg = k_pool[tables].permute(0, 2, 1, 3, 4).reshape(B, nkv, S, hd)
    vg = v_pool[tables].permute(0, 2, 1, 3, 4).reshape(B, nkv, S, hd)
    # query head h = kv * g + gi attends kv head h // g
    qg = q.reshape(B, nkv, g, hd).float()
    s = torch.einsum("bngh,bnsh->bngs", qg, kg.float()) * scale
    kv_pos = torch.arange(S, device=q.device)[None, :]
    cl = context_lens.long()[:, None]
    mask = kv_pos <= cl
    if window is not None:
        w = window.to(q.device).long().clamp(min=1) \
            if isinstance(window, torch.Tensor) else window
        mask = mask & (kv_pos > cl - w)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngs,bnsh->bngh", p.to(v_pool.dtype).float(),
                       vg.float())
    return out.reshape(B, nh, hd).to(q.dtype)


@register("paged_decode_attention", backend="cuda")
def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                context_lens: torch.Tensor, *,
                                scale: Optional[float] = None,
                                window: Window = None) -> torch.Tensor:
    """Launch ``ops/csrc/paged_decode.cu``. Returns [B, nh, hd] bf16."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16 \
            or v_pool.dtype != torch.bfloat16:
        raise ValueError("paged_decode_attention_cuda takes bf16 q and pools, got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables and context_lens must be int32")
    B, nh, hd = q.shape
    num_blocks, nkv, bs, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if nh % nkv or nh // nkv > 16 or hd not in (64, 128, 256):
        raise ValueError(f"unsupported heads: nh={nh}, nkv={nkv}, hd={hd} "
                         f"(needs nh % nkv == 0, nh/nkv <= 16, hd in 64/128/256)")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or context_lens.shape != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"match batch {B}")
    max_blocks = block_tables.shape[1]
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous")
    q = q.contiguous()
    tables = block_tables.contiguous()
    ctx = context_lens.contiguous()
    window = _check_window(window)
    window_ptr, window_static = None, 0
    if isinstance(window, torch.Tensor):
        if window.device != dev:
            raise ValueError(f"window tensor on {window.device}, q on {dev}")
        window = window.to(torch.int32).reshape(())
        window_ptr = window.data_ptr()
    elif window is not None:
        window_static = window
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = hd ** -0.5 if scale is None else scale
    lib = _build.load()
    err = lib.dstt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        ctx.data_ptr(), window_ptr, window_static, out.data_ptr(),
        B, nh, nkv, hd, bs, num_blocks, max_blocks, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_decode_attention kernel")
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
