"""Runtime utilities — counterpart of ``deepspeed_tpu/runtime/utils.py``
(``global_norm`` :11, ``clip_grad_norm_`` :18).

Under ZeRO the grads a rank holds may be shards: pass their names as
``sharded`` and the data-parallel ``axis``, and the norm is the norm of
the whole grads, one all-reduce of the per-leaf sums of squares, in which a
replicated leaf counts once (rank 0's). Without ``axis``, or over an axis
with no process group, the norm is this rank's alone."""

from __future__ import annotations

from typing import Collection, Dict, Optional, Tuple

import torch

from ..comm import comm
from ..comm.mesh import AxisName, MeshManager


def global_norm(grads: Dict[str, torch.Tensor], sharded: Collection[str] = (),
                axis: Optional[AxisName] = None,
                mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """fp32 L2 norm over every grad leaf: sqrt(sum of each leaf's sum of
    squares), a 0-d tensor on the grads' device."""
    sums = torch.stack([torch.sum(torch.square(g.float())) for g in grads.values()])
    if axis is not None:
        first = comm.axis_index(axis, mesh=mesh) == 0
        once = torch.tensor([first or k in sharded for k in grads], device=sums.device)
        sums = comm.all_reduce(torch.where(once, sums, 0.0), axis, mesh=mesh)
    return torch.sqrt(torch.sum(sums))


def clip_grad_norm_(grads: Dict[str, torch.Tensor], max_norm: float,
                    norm: Optional[torch.Tensor] = None, sharded: Collection[str] = (),
                    axis: Optional[AxisName] = None, mesh: Optional[MeshManager] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most ``max_norm``:
    coef = min(1, max_norm / (norm + 1e-6)), as the JAX engine clips.
    Returns (grads, pre-clip norm)."""
    norm = global_norm(grads, sharded, axis, mesh) if norm is None else norm
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads.values():
        g.mul_(coef)
    return grads, norm
