"""Symmetric int8 group quantization — counterpart of
``deepspeed_tpu/ops/quantization.py`` (``group_quantize_int8`` :30,
``kv_quantize_int8`` :40, ``kv_dequantize_int8`` :55, ``quantize_int8_xla``
:66, ``dequantize_int8_xla`` :78) and ``deepspeed_tpu/ops/pallas/quantize.py``
(``_quant_kernel`` :30, ``_dequant_kernel`` :39).

The JAX package computes the KV functions in XLA, so here they are plain
PyTorch on any device: the KV fill path quantizes each token's K/V vector as it is written
into the int8 pools (``models/_paged.py``), and the prefill path dequantizes
the gathered view. The same formulas as the JAX functions: scale =
max(max|g|, 1e-8) / 127, codes = round(g / scale) (half to even), clipped to
±127.

Ops ``quantize_int8`` / ``dequantize_int8`` (any shape viewed as
``[n_groups, group_size]``; consumed by the weight-only int8 linear of
``inference/modules.py``) have two implementations each, chosen by the
input's device (``ops/registry.py``): the plain versions
(:func:`quantize_int8_torch`, :func:`dequantize_int8_torch`) serve CPU
tensors and are the oracle on the card; :func:`quantize_int8_cuda` and
:func:`dequantize_int8_cuda` launch the hand-written kernels of
``ops/csrc/quantize.cu`` and count their launches in ``.launches``. Both
take bf16, fp16 and fp32, as the Pallas kernels take any dtype. Their
formula differs from the KV one: scale = max|g| * (1 / 127) — the fp32
product XLA compiles the Pallas kernel's ``amax / 127.0`` to, written out so
that the CPU, the card and the JAX package agree to the bit — and 1 for an
all-zero group. The kernels give the plain versions' codes, scales and
values bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from . import _build
from .registry import op, register

# dtype codes of quantize.cu (those of rms_norm.cu and layer_norm.cu)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


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


# --------------------------------------------------------------------------- #
# quantize_int8 / dequantize_int8
# --------------------------------------------------------------------------- #
def _check_groups(numel: int, group_size: int) -> None:
    if group_size < 1 or numel % group_size:
        raise ValueError(f"group_size {group_size} does not divide the "
                         f"{numel} elements")


@register("quantize_int8", backend="torch")
def quantize_int8_torch(x: torch.Tensor, group_size: int = 2048
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: any shape with numel % group_size == 0 → (int8 codes of the same
    shape, fp32 scales ``[n_groups]``)."""
    _check_groups(x.numel(), group_size)
    x2 = x.reshape(-1, group_size).float()
    amax = x2.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    q = torch.round(x2 / scale).clamp_(-127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[:, 0]


@register("dequantize_int8", backend="torch")
def dequantize_int8_torch(q: torch.Tensor, scales: torch.Tensor,
                          group_size: int = 2048, dtype=torch.float32) -> torch.Tensor:
    _check_groups(q.numel(), group_size)
    q2 = q.reshape(-1, group_size).float()
    return (q2 * scales[:, None]).to(dtype).reshape(q.shape)


def _check_cuda(name: str, numel: int, group_size: int, *tensors: torch.Tensor) -> None:
    _check_groups(numel, group_size)
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} needs its tensors on one CUDA device, got "
                             f"{[str(t.device) for t in tensors]}")
    if numel >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2^31 elements, got {numel}")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")


@register("quantize_int8", backend="cuda")
def quantize_int8_cuda(x: torch.Tensor, group_size: int = 2048
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Op ``quantize_int8`` on CUDA tensors: one launch of the quantize
    kernel (bf16, fp16 or fp32 input)."""
    _check_cuda("quantize_int8_cuda", x.numel(), group_size, x)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"quantize_int8_cuda takes bf16, f16 or f32, got {x.dtype}")
    x2 = x.contiguous().view(-1, group_size)
    q = torch.empty(x2.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device)
    _check_aligned("quantize_int8_cuda", x2, q, scales)
    err = _build.load().dstt_quantize_int8(
        x2.data_ptr(), q.data_ptr(), scales.data_ptr(), x2.shape[0], group_size,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_int8 kernel")
    if x2.shape[0]:
        quantize_int8_cuda.launches += 1
    return q.view(x.shape), scales


@register("dequantize_int8", backend="cuda")
def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor,
                         group_size: int = 2048, dtype=torch.float32) -> torch.Tensor:
    """Op ``dequantize_int8`` on CUDA tensors: one launch of the dequantize
    kernel (int8 codes, fp32 scales; ``dtype`` fp32, bf16 or fp16)."""
    _check_cuda("dequantize_int8_cuda", q.numel(), group_size, q, scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"dequantize_int8_cuda takes int8 codes and f32 scales, "
                         f"got {q.dtype} and {scales.dtype}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dequantize_int8_cuda writes bf16, f16 or f32, got {dtype}")
    q2 = q.contiguous().view(-1, group_size)
    s = scales.contiguous()
    if s.shape != (q2.shape[0],):
        raise ValueError(f"scales shape {tuple(scales.shape)} != ({q2.shape[0]},)")
    out = torch.empty(q2.shape, dtype=dtype, device=q.device)
    _check_aligned("dequantize_int8_cuda", q2, s, out)
    err = _build.load().dstt_dequantize_int8(
        q2.data_ptr(), s.data_ptr(), out.data_ptr(), q2.shape[0], group_size,
        _DTYPE_CODE[dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "dequantize_int8 kernel")
    if q2.shape[0]:
        dequantize_int8_cuda.launches += 1
    return out.view(q.shape)


quantize_int8_cuda.launches = 0
dequantize_int8_cuda.launches = 0


@contextlib.contextmanager
def quantize_planted_fault(fault: int):
    """For the tests that show a check can fail: the quantize and dequantize
    kernels' launches inside the block carry a planted fault. 1: quantize
    takes each quotient as the product by the fp32 reciprocal; 2: the first
    lane of each segment is left out of the group's max; 3: dequantize
    scales each group's first vector by the previous group's scale."""
    plant = _build.load().dstt_quantize_plant
    plant(int(fault))
    try:
        yield
    finally:
        plant(0)


quantize_int8 = op("quantize_int8")
dequantize_int8 = op("dequantize_int8")
