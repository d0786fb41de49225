"""RMSNorm and LayerNorm — counterpart of ``deepspeed_tpu/ops/norms.py``
(``rms_norm_xla``, ``layer_norm_xla``) and ``deepspeed_tpu/ops/pallas/norms.py``
(``_rms_kernel``, ``_ln_kernel``).

Each op (``rms_norm``, ``layer_norm``) has two implementations, chosen by
the input's device (``ops/registry.py``):

- the plain version (:func:`rms_norm_torch`, :func:`layer_norm_torch`): fp32
  accumulation, cast back to the input dtype. It serves CPU tensors and is
  the oracle the kernel is held against on the card.
- the differentiable op over the hand-written kernel (:func:`rms_norm_cuda`
  over ``ops/csrc/rms_norm.cu``, :func:`layer_norm_cuda` over
  ``ops/csrc/layer_norm.cu``): 16-byte loads, fp32 reductions, bf16, fp16
  and fp32 as the Pallas kernels take them; shuffle-only sums within a
  warp (RMSNorm: a block a row, each thread holding its share of the row
  and of the weight in registers, a strided loop for rows wider than that;
  LayerNorm: a few warps a row for calls of few rows, a block per row
  otherwise). They replace the TPU kernels
  ``deepspeed_tpu/ops/pallas/norms.py:27`` and ``:87``; each source's header
  note gives the bound. ``rms_norm_cuda.launches`` and
  ``layer_norm_cuda.launches`` count the kernel launches.

As in the JAX package (``_rms`` / ``_ln`` custom VJPs, ``norms.py:51-73``,
``:115-145``) the forward is the kernel and the backward is plain tensor
code: :func:`rms_norm_bwd` and :func:`layer_norm_bwd` mirror
``_rms_vjp_bwd`` and ``_ln_vjp_bwd`` line by line. :class:`RMSNormFunction`
and :class:`LayerNormFunction` join the two, so the kernels' outputs carry
gradients.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from . import _build
from .registry import op, register

# dtype codes of rms_norm.cu and layer_norm.cu
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

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
    if x2.shape[0]:
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
        raise ValueError(f"rms_norm_cuda takes bf16, fp16 or f32 x with a weight of "
                         f"the same dtype, got {x.dtype} and {weight.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    return RMSNormFunction.apply(x, weight, eps)


rms_norm_cuda.launches = 0


@contextlib.contextmanager
def rms_norm_planted_fault(fault: int):
    """For the tests that show a check can fail: the RMSNorm kernels'
    launches inside the block carry a planted fault. 1: lane 31's partial
    is left out of each warp's sum of squares (a row must give lane 31
    values); 2: the first 16-byte vector of each row is not multiplied by
    the weight."""
    plant = _build.load().dstt_rms_norm_plant
    plant(int(fault))
    try:
        yield
    finally:
        plant(0)


rms_norm = op("rms_norm")


# --------------------------------------------------------------------------- #
# layer_norm
# --------------------------------------------------------------------------- #
@register("layer_norm", backend="torch")
def layer_norm_torch(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """The variance comes from the centred values, as in ``_ln_kernel``."""
    dtype = x.dtype
    xf = x.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-5, bias_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)`` of y = layer_norm(x, weight, bias): ``_ln_vjp_bwd``
    in fp32, dx cast to x's dtype, dw and db summed over rows and cast to
    the weight's and the bias's dtype (the weight's when there is no bias)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    wf = weight.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    xhat = xc * r
    wdy = dyf * wf
    dx = r * (wdy - torch.mean(wdy, dim=-1, keepdim=True)
              - xhat * torch.mean(wdy * xhat, dim=-1, keepdim=True))
    dw = torch.sum(dyf * xhat, dim=0)
    db = torch.sum(dyf, dim=0)
    return (dx.to(x.dtype).view(x.shape), dw.to(weight.dtype),
            db.to(bias_dtype or weight.dtype))


def _launch_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """One launch of ``ops/csrc/layer_norm.cu`` (forward, no autograd)."""
    d = x.shape[-1]
    x2 = x.contiguous().view(-1, d)
    w = weight.contiguous()
    b = None if bias is None else bias.contiguous()
    y = torch.empty_like(x2)
    for t in (x2, w, b, y):
        if t is not None and t.numel() and t.data_ptr() % 16:
            raise ValueError("layer_norm_cuda needs 16-byte aligned tensors")
    lib = _build.load()
    err = lib.dstt_layer_norm(x2.data_ptr(), w.data_ptr(),
                              None if b is None else b.data_ptr(), y.data_ptr(),
                              x2.shape[0], d, float(eps), _DTYPE_CODE[x.dtype],
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "layer_norm kernel")
    if x2.shape[0]:
        layer_norm_cuda.launches += 1
    return y.view(x.shape)


class LayerNormFunction(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors (the plain version on CPU
    tensors); backward: :func:`layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        ctx.bias_dtype = None if bias is None else bias.dtype
        with torch.no_grad():
            if x.device.type == "cuda":
                return _launch_layer_norm(x, weight, bias, eps)
            return layer_norm_torch(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, dy, ctx.eps, ctx.bias_dtype)
        return dx, dw, (db if ctx.bias_dtype is not None else None), None


@register("layer_norm", backend="cuda")
def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """Op ``layer_norm`` on CUDA tensors: :class:`LayerNormFunction` (the
    kernel forward, differentiable). ``bias`` may be None."""
    for name, t in [("weight", weight)] + ([] if bias is None else [("bias", bias)]):
        if x.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"layer_norm_cuda needs x and {name} on one CUDA "
                             f"device, got {x.device} and {t.device}")
        if x.dtype not in _DTYPE_CODE or t.dtype != x.dtype:
            raise ValueError(f"layer_norm_cuda takes bf16, fp16 or f32 x with a {name} "
                             f"of the same dtype, got {x.dtype} and {t.dtype}")
        if t.shape != (x.shape[-1],):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({x.shape[-1]},)")
    return LayerNormFunction.apply(x, weight, bias, eps)


layer_norm_cuda.launches = 0


@contextlib.contextmanager
def layer_norm_planted_fault(fault: int):
    """For the tests that show a check can fail: the LayerNorm kernel's
    launches inside the block carry a planted fault. 1: lane 31's share of
    each row's centred sum of squares is left out (a row must give lane 31
    values: d of at least 32 vectors of 16 bytes)."""
    plant = _build.load().dstt_layer_norm_plant
    plant(int(fault))
    try:
        yield
    finally:
        plant(0)

layer_norm = op("layer_norm")
