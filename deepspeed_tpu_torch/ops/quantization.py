"""Symmetric int8 group quantization — counterpart of
``deepspeed_tpu/ops/quantization.py`` (``group_quantize_int8`` :30,
``kv_quantize_int8`` :40, ``kv_dequantize_int8`` :55).

The JAX package computes these in XLA, so here they are plain PyTorch on any
device: the KV fill path quantizes each token's K/V vector as it is written
into the int8 pools (``models/_paged.py``), and the prefill path dequantizes
the gathered view. The same formulas as the JAX functions: scale =
max(max|g|, 1e-8) / 127, codes = round(g / scale) (half to even), clipped to
±127.

``quantize_int8``/``dequantize_int8`` (the Pallas ``_quant_kernel`` and
``_dequant_kernel``, used by the weight-only int8 linear) are not ported
yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def group_quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of the trailing (group) dim of an already
    grouped tensor: ``g [..., group]`` → ``(codes int8 same shape, scales
    fp32 [..., 1])``."""
    scale = g.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(g / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def kv_quantize_int8(x: torch.Tensor, group_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Groupwise int8 quantization of KV vectors along the trailing (head)
    dim: ``x [..., hd]`` → ``(codes int8 [..., hd], scales fp32 [..., ng])``
    with ``ng = hd // group_size``. Each vector is quantized on its own, so
    writing one token never touches another position's scale."""
    hd = x.shape[-1]
    if hd % group_size:
        raise ValueError(f"group_size {group_size} does not divide {hd}")
    g = x.float().reshape(x.shape[:-1] + (hd // group_size, group_size))
    q, scale = group_quantize_int8(g)
    return q.reshape(x.shape), scale[..., 0]


def kv_dequantize_int8(codes: torch.Tensor, scales: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`kv_quantize_int8`: ``codes [..., hd]`` int8 +
    ``scales [..., ng]`` → ``[..., hd]`` in ``dtype`` (group size
    ``hd // ng``)."""
    hd, ng = codes.shape[-1], scales.shape[-1]
    x = codes.float().reshape(codes.shape[:-1] + (ng, hd // ng))
    return (x * scales[..., None]).reshape(codes.shape).to(dtype)
