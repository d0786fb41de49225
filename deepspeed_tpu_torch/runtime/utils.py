"""Runtime utilities — counterpart of ``deepspeed_tpu/runtime/utils.py``
(``global_norm`` :19, ``clip_grad_norm_`` :25)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """fp32 L2 norm over every grad leaf: sqrt(sum of each leaf's sum of
    squares), a 0-d tensor on the grads' device."""
    sums = [torch.sum(torch.square(g.float())) for g in grads.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_grad_norm_(grads: Dict[str, torch.Tensor], max_norm: float,
                    norm: Optional[torch.Tensor] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most ``max_norm``:
    coef = min(1, max_norm / (norm + 1e-6)), as the JAX engine clips.
    Returns (grads, pre-clip norm)."""
    norm = global_norm(grads) if norm is None else norm
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads.values():
        g.mul_(coef)
    return grads, norm
