"""Inference engine base — counterpart of ``deepspeed_tpu/inference/engine.py``
(``ModelFamily`` :37, ``InferenceEngine`` :68-125).

The base resolves the device, builds the family's module and loads the
weights onto the device in ``inference.dtype``. The v1 dense-cache
``generate`` and tensor parallelism are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .config import InferenceConfig, check_ported

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16}


@dataclasses.dataclass
class ModelFamily:
    """What the engine needs from a model family: a module constructor, its
    paged forward and its cache constructor."""

    cfg: Any
    build: Callable            # (cfg) -> nn.Module with uninitialised params
    apply_paged: Callable      # (cfg, model, tokens, cache, tables, ctx, *, valid)
    init_paged_cache: Callable  # (cfg, num_blocks, block_size, dtype, device)
    name: str = "model"

    @classmethod
    def from_module(cls, module, cfg) -> "ModelFamily":
        return cls(cfg=cfg, build=module.build, apply_paged=module.apply_paged,
                   init_paged_cache=module.init_paged_cache,
                   name=getattr(module, "__name__", "model").rsplit(".", 1)[-1])


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported inference dtype {name!r}") from None


class InferenceEngine:
    """Holds the family's module with its weights on ``device``."""

    def __init__(self, family: ModelFamily, params: Mapping[str, Any],
                 config: Optional[InferenceConfig] = None, device="cuda"):
        self.family = family
        self.config = config or InferenceConfig()
        check_ported(self.config)
        self.device = resolve_device(device)
        self.dtype = torch_dtype(self.config.dtype)
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            # the paged-decode kernel takes bf16 q and pools only; refuse
            # here rather than at the first decode step
            raise ValueError(f"inference dtype {self.config.dtype!r} has no CUDA "
                             "kernel yet; the card path serves bfloat16")
        with torch.device("meta"):
            model = family.build(family.cfg)
        state = {}
        for name, value in params.items():
            t = torch.as_tensor(value)
            dtype = self.dtype if t.is_floating_point() else t.dtype
            # a tensor already on the device in the right dtype is not copied
            state[name] = t.to(device=self.device, dtype=dtype)
        model.load_state_dict(state, strict=True, assign=True)
        self.model = model.eval().requires_grad_(False)
        log_dist(f"InferenceEngine: {family.name} on {self.device} "
                 f"(dtype={self.dtype})")
