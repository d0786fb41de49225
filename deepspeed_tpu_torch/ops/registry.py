"""Op registry — counterpart of ``deepspeed_tpu/ops/registry.py``.

Each logical op that has a hand-written kernel (``rms_norm``,
``paged_decode_attention``) registers two implementations:

- ``cuda``: the kernel's wrapper (``ops/csrc/*.cu``, built at first use);
- ``torch``: the plain PyTorch version — the oracle the CPU tests hold
  against the JAX package and the chip smoke holds the kernel against.

Selection is by the device of the tensor the op is called on: a CUDA tensor
gets the ``cuda`` backend, a CPU tensor the ``torch`` backend. There is no
override that puts a plain version on the card path; a kernel that fails to
build or launch raises.

Usage::

    @register("rms_norm", backend="torch")
    def rms_norm_torch(x, weight, eps): ...

    rms_norm = op("rms_norm")   # resolved per call from x.device
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

_REGISTRY: Dict[str, Dict[str, Callable]] = {}

# tensor device type -> backend that serves it
_BACKEND_FOR_DEVICE = {"cuda": "cuda", "cpu": "torch"}


def register(name: str, backend: str = "torch") -> Callable[[Callable], Callable]:
    if backend not in _BACKEND_FOR_DEVICE.values():
        raise ValueError(f"unknown backend {backend!r}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(name, {})[backend] = fn
        return fn

    return deco


def get_op(name: str, device) -> Callable:
    """The implementation of ``name`` for tensors on ``device``."""
    impls = _REGISTRY.get(name)
    if not impls:
        raise KeyError(f"no implementations registered for op '{name}'")
    dev_type = torch.device(device).type
    backend = _BACKEND_FOR_DEVICE.get(dev_type)
    if backend is None or backend not in impls:
        raise RuntimeError(f"op '{name}' has no implementation for "
                           f"{dev_type} tensors (available: {list(impls)})")
    return impls[backend]


def op(name: str) -> Callable:
    """Late-binding callable: resolves the implementation from the device of
    its first argument at each call."""

    def dispatch(x: torch.Tensor, *args, **kwargs):
        return get_op(name, x.device)(x, *args, **kwargs)

    dispatch.__name__ = name
    return dispatch
