"""Mixed precision: dtype policy and dynamic loss scaling — counterpart of
``deepspeed_tpu/runtime/precision.py`` (``PrecisionPolicy`` :26,
``LossScaleState`` :48 … ``update_loss_scale`` :94, ``grads_finite`` :79).

The scaler is a small state of 0-d tensors updated by plain tensor functions,
as in the JAX package: with fp16 the scale halves on overflow (not below
``min_loss_scale``) and doubles after ``loss_scale_window`` good steps; with
bf16 or fp32 it is pinned to 1 and never changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, NamedTuple, Optional

import torch

from ..comm import comm
from ..comm.mesh import AxisName, MeshManager


@dataclass(frozen=True)
class PrecisionPolicy:
    """Params (and optimizer state) stay fp32 masters; compute casts them
    per step."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def from_config(cls, cfg) -> "PrecisionPolicy":
        if cfg.fp16.enabled:
            return cls(compute_dtype=torch.float16)
        if cfg.bf16.enabled:
            return cls(compute_dtype=torch.bfloat16)
        return cls()

    def cast_to_compute(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A differentiable cast: grads of the compute copies reach the fp32
        masters through it."""
        return {k: p.to(self.compute_dtype) if p.is_floating_point() else p
                for k, p in params.items()}


class LossScaleState(NamedTuple):
    """Dynamic loss scaler state (0-d tensors on the training device)."""

    scale: torch.Tensor            # f32
    good_steps: torch.Tensor       # i32 consecutive overflow-free steps
    growth_interval: torch.Tensor  # i32
    backoff: torch.Tensor          # f32 (0.5)
    growth: torch.Tensor           # f32 (2.0)
    min_scale: torch.Tensor        # f32
    enabled: torch.Tensor          # bool — False for bf16/fp32 (scale pinned)


def make_loss_scaler(cfg_fp16, device="cpu") -> LossScaleState:
    """Build from an ``FP16Config``; static scale if ``loss_scale`` > 0."""
    enabled = bool(cfg_fp16.enabled)
    dynamic = enabled and cfg_fp16.dynamic_loss_scale
    init = (2.0 ** cfg_fp16.initial_scale_power) if dynamic else (
        cfg_fp16.loss_scale if enabled and cfg_fp16.loss_scale else 1.0)

    def t(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return LossScaleState(
        scale=t(init, torch.float32),
        good_steps=t(0, torch.int32),
        growth_interval=t(cfg_fp16.loss_scale_window, torch.int32),
        backoff=t(0.5, torch.float32),
        growth=t(2.0, torch.float32),
        min_scale=t(cfg_fp16.min_loss_scale, torch.float32),
        enabled=t(dynamic, torch.bool),
    )


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale.to(loss.dtype)


def grads_finite(grads: Iterable[torch.Tensor], axis: Optional[AxisName] = None,
                 mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """0-d bool: every element of every grad is finite — on every rank of
    ``axis`` when it is given (each rank holding its shards of the grads),
    else on this rank."""
    flags = [torch.isfinite(g).all() for g in grads]
    if not flags:
        return torch.tensor(True)
    finite = torch.stack(flags).all()
    if axis is not None:
        finite = comm.all_reduce(finite.to(torch.int32), axis, "min", mesh=mesh).bool()
    return finite


def update_loss_scale(state: LossScaleState, finite: torch.Tensor) -> LossScaleState:
    """Halve on overflow (not below ``min_scale``), double after
    ``growth_interval`` consecutive good steps; inert when not enabled."""
    finite = torch.as_tensor(finite, device=state.scale.device)
    grown = state.good_steps + 1 >= state.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grown, state.scale * state.growth, state.scale),
        torch.maximum(state.scale * state.backoff, state.min_scale))
    new_good = torch.where(finite, torch.where(grown, torch.zeros_like(state.good_steps),
                                               state.good_steps + 1),
                           torch.zeros_like(state.good_steps))
    new_scale = torch.where(state.enabled, new_scale, state.scale)
    new_good = torch.where(state.enabled, new_good, state.good_steps)
    return state._replace(scale=new_scale, good_steps=new_good.to(torch.int32))
