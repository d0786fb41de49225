"""Attention — counterpart of ``deepspeed_tpu/ops/attention.py``
(``attention_xla`` :141, ``repeat_kv`` / ``widen_kv`` :59-72).

Plain masked GQA softmax attention: the JAX package hands every masked call
(the paged prefill path) to XLA, so the port computes it in PyTorch, with the
scores and softmax in fp32. All shapes are [batch, seq, heads, head_dim];
K/V may have fewer heads and are widened to the query head count (query
head ``h`` reads kv head ``h // g``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              mask: Optional[torch.Tensor] = None, q_offset: int = 0,
              window: Optional[int] = None) -> torch.Tensor:
    """mask: optional [batch, 1|heads, q_len, kv_len] boolean (True =
    attend) or additive mask. ``q_offset``: absolute position of q[0] within
    the kv sequence. ``window``: sliding-window length (requires causal)."""
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
    if mask is not None:
        if mask.dtype == torch.bool:
            logits.masked_fill_(~mask, NEG_INF)
        else:
            logits += mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
