"""Compressed collectives — counterpart of ``deepspeed_tpu/comm/compressed.py``.

Only the pure function :func:`onebit_compress` (JAX :35-44) is ported: the
1-bit optimizers (``ops/onebit.py``) compress with it. The compressed
all-reduce and the quantized reductions (JAX ``onebit_all_reduce`` and the
rest of the module) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def onebit_compress(x: torch.Tensor, error: torch.Tensor,
                    scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback 1-bit compression: returns (signs int8, scale,
    new_error), with ``scale = mean(|x + error|)`` unless ``scale`` is given
    (the optimizers pass the mean over the whole JAX leaf when ``x`` is one
    layer or one shard of it)."""
    corrected = x + error
    if scale is None:
        # the sum times the reciprocal of the count, as XLA computes
        # jnp.mean (bit for bit when the sum is the same)
        scale = corrected.abs().sum() * (1.0 / corrected.numel())
    signs = torch.where(corrected >= 0, 1, -1).to(torch.int8)
    decompressed = signs.to(x.dtype) * scale
    return signs, scale, corrected - decompressed
