"""Rotary position embedding — counterpart of ``deepspeed_tpu/ops/rotary.py``
(``rope_frequencies`` :15, ``apply_rotary_xla`` :25). Plain PyTorch: the
JAX package leaves this elementwise rotation to XLA."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     dtype=torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_len, head_dim/2], computed in fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [max_len, head_dim/2];
    positions: [..., seq] integer positions (defaults to arange). Split-half
    (``rotate_half``) convention, computed in fp32, cast back."""
    seq = x.shape[-3]
    if positions is None:
        c = cos[:seq][:, None, :]
        s = sin[:seq][:, None, :]
    else:
        c = cos[positions][..., :, None, :]
        s = sin[positions][..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
