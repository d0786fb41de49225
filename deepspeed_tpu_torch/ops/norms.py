"""RMSNorm — counterpart of ``deepspeed_tpu/ops/norms.py`` (``rms_norm_xla``)
and ``deepspeed_tpu/ops/pallas/norms.py`` (``_rms_kernel``).

Two implementations of op ``rms_norm``, chosen by the input's device
(``ops/registry.py``):

- :func:`rms_norm_torch`, the plain version: fp32 accumulation, cast back to
  the input dtype. It serves CPU tensors and is the oracle the kernel is held
  against on the card.
- :func:`rms_norm_cuda`, the differentiable op over the hand-written kernel
  ``ops/csrc/rms_norm.cu`` (one block per row, 16-byte loads, fp32
  warp-shuffle reduction). It replaces the TPU kernel
  ``deepspeed_tpu/ops/pallas/norms.py:27``; its header note gives the bound.
  ``rms_norm_cuda.launches`` counts its kernel launches.

As in the JAX package (``_rms`` custom VJP, ``norms.py:51-73``) the forward
is the kernel and the backward is plain tensor code: :func:`rms_norm_bwd`
mirrors ``_rms_vjp_bwd`` line by line. :class:`RMSNormFunction` joins the
two, so the kernel's output carries gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .registry import op, register

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


@register("rms_norm", backend="torch")
def rms_norm_torch(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dtype)


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of y = rms_norm(x, weight): ``_rms_vjp_bwd`` in fp32,
    dx cast to x's dtype, dw summed over rows and cast to weight's dtype."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    wf = weight.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wdy = dyf * wf
    dx = r * wdy - xf * (r ** 3) * torch.sum(wdy * xf, dim=-1, keepdim=True) / d
    dw = torch.sum(dyf * xf * r, dim=0)
    return dx.to(x.dtype).view(x.shape), dw.to(weight.dtype)


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """One launch of ``ops/csrc/rms_norm.cu`` (forward, no autograd)."""
    d = x.shape[-1]
    x2 = x.contiguous().view(-1, d)
    w = weight.contiguous()
    y = torch.empty_like(x2)
    for t in (x2, w, y):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError("rms_norm_cuda needs 16-byte aligned tensors")
    lib = _build.load()
    err = lib.dstt_rms_norm(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                            x2.shape[0], d, float(eps), _DTYPE_CODE[x.dtype],
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rms_norm kernel")
    rms_norm_cuda.launches += 1
    return y.view(x.shape)


class RMSNormFunction(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors (the plain version on CPU
    tensors); backward: :func:`rms_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        with torch.no_grad():
            if x.device.type == "cuda":
                return _launch(x, weight, eps)
            return rms_norm_torch(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, dy, ctx.eps)
        return dx, dw, None


@register("rms_norm", backend="cuda")
def rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Op ``rms_norm`` on CUDA tensors: :class:`RMSNormFunction` (the kernel
    forward, differentiable)."""
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rms_norm_cuda needs x and weight on one CUDA device, "
                         f"got {x.device} and {weight.device}")
    if x.dtype not in _DTYPE_CODE or weight.dtype != x.dtype:
        raise ValueError(f"rms_norm_cuda takes bf16 or f32 x with a weight of "
                         f"the same dtype, got {x.dtype} and {weight.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    return RMSNormFunction.apply(x, weight, eps)


rms_norm_cuda.launches = 0

rms_norm = op("rms_norm")
