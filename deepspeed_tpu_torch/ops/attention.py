"""Attention — counterpart of ``deepspeed_tpu/ops/attention.py``
(``attention_xla`` :141, ``repeat_kv`` / ``widen_kv`` :59-72, op
``attention`` :182).

:func:`attention_torch` is the plain masked GQA softmax attention, with the
scores and softmax in fp32, differentiable through plain autograd. All
shapes are [batch, seq, heads, head_dim]; K/V may have fewer heads and are
widened to the query head count (query head ``h`` reads kv head ``h // g``).

Op ``attention`` (:data:`attention`) has two implementations, chosen by the
device of ``q`` (``ops/registry.py``): CPU tensors get
:func:`attention_torch`; CUDA tensors get the flash kernels
(``ops/flash_attention.py``, an autograd function over
``ops/csrc/flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu`` (bf16) or
``flash_fwd.cu`` and ``flash_bwd.cu`` (fp32); with an additive ``bias``,
their bias mode). Masked calls — the paged prefill — go to
:func:`attention_torch`: the JAX package hands every masked call to XLA,
never to its kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .registry import op, register

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    kv_heads = k.shape[-2]
    if kv_heads == num_q_heads:
        return k
    if num_q_heads % kv_heads:
        raise ValueError(f"{num_q_heads} query heads not a multiple of "
                         f"{kv_heads} kv heads")
    return torch.repeat_interleave(k, num_q_heads // kv_heads, dim=-2)


def widen_kv(k: torch.Tensor, v: torch.Tensor,
             num_q_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return repeat_kv(k, num_q_heads), repeat_kv(v, num_q_heads)


def _causal_window_mask(q_len: int, kv_len: int, q_offset: int,
                        window: Optional[int], device) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    m = q_pos >= kv_pos
    if window is not None:
        m = m & (q_pos - kv_pos < window)
    return m


@register("attention", backend="torch")
def attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, q_offset: int = 0,
                    window: Optional[int] = None) -> torch.Tensor:
    """mask: optional [batch, 1|heads, q_len, kv_len] boolean (True =
    attend) or additive mask. bias: optional additive logits term of the
    same broadcast shape (differentiable), added in fp32 after the causal
    mask and before ``mask``, as ``attention_xla`` adds it. ``q_offset``:
    absolute position of q[0] within the kv sequence. ``window``:
    sliding-window length (requires causal)."""
    q_len, num_heads = q.shape[-3], q.shape[-2]
    kv_len = k.shape[-3]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if window is not None and (not causal or window < 1):
        raise ValueError("window needs causal attention and window >= 1")
    k, v = widen_kv(k, v, num_heads)
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * scale
    # masks apply in place: at serving widths the fp32 scores are the
    # largest tensor of the step
    if causal:
        logits.masked_fill_(
            ~_causal_window_mask(q_len, kv_len, q_offset, window, q.device),
            NEG_INF)
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        if mask.dtype == torch.bool:
            logits.masked_fill_(~mask, NEG_INF)
        else:
            logits += mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


attention = op("attention")
