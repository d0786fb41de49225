"""Optimizers on fp32 masters — counterpart of
``deepspeed_tpu/ops/optimizers.py`` (``adam`` :63, ``get_optimizer`` :357).

Interface as in the JAX package::

    opt = get_optimizer("adamw", lr=3e-4, weight_decay=0.1)
    state = opt.init(params)                      # fp32 moments
    params, state = opt.update(params, grads, state, lr_scale=sched(t) / lr)

Params are a dict of fp32 tensors. Unlike the JAX package, ``update``
writes the new params and moments IN PLACE (the returned objects are the
same tensors): at 8B-width the masters and both moments are ~23 GB, and a
functional update would need as much again.

The update is the JAX ``adam`` exactly, including its quirk: with
``adamw=False`` (optimizer ``"adam"``) weight decay is still added to the
step as ``weight_decay * p`` (``optimizers.py:87-94``), so ``adam`` and
``adamw`` compute the same update. The other optimizers of the JAX package
(lion, lamb, adagrad, sgd, muon, 1-bit, param groups) are not ported yet.
"""

from __future__ import annotations

import inspect
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]
    hyperparams: Dict[str, Any]


class AdamState(NamedTuple):
    step: int
    mu: Params
    nu: Params


def adam(lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.0,
         adamw: bool = True, bias_correction: bool = True) -> Optimizer:
    b1, b2 = betas

    def init(params: Params) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamState(0, {k: zeros(p) for k, p in params.items()},
                         {k: zeros(p) for k, p in params.items()})

    def update(params: Params, grads: Params, state: AdamState,
               lr_scale: float = 1.0) -> Tuple[Params, AdamState]:
        step = state.step + 1
        if bias_correction:
            c1 = 1 - b1 ** float(step)
            c2 = 1 - b2 ** float(step)
        else:
            c1 = c2 = 1.0
        alpha = lr * float(lr_scale)
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name].float()
                m, v = state.mu[name], state.nu[name]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                step_val = (m / c1).div_((v / c2).sqrt_().add_(eps))
                if weight_decay:
                    # adamw and adam alike (the JAX package's L2 branch adds
                    # the same term): decay rides on the step
                    step_val.add_(p.float(), alpha=weight_decay)
                p.sub_(step_val.mul_(alpha).to(p.dtype))
        return params, AdamState(step, state.mu, state.nu)

    return Optimizer("adamw" if adamw else "adam", init, update,
                     dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))


_FACTORY: Dict[str, Callable[..., Optimizer]] = {
    "adam": partial(adam, adamw=False),
    "adamw": adam,
    "fusedadam": adam,
}
_NOT_PORTED = ("lion", "fusedlion", "lamb", "fusedlamb", "adagrad", "sgd", "muon",
               "onebitadam", "onebitlamb", "zerooneadam", "01adam")


def get_optimizer(name: str, **params) -> Optimizer:
    """Build from a DeepSpeed-style optimizer config block (same key aliases
    as the JAX package: ``learning_rate``, ``betas``, ``adam_w_mode``)."""
    key = name.lower().replace("_", "")
    if key in _NOT_PORTED:
        raise NotImplementedError(f"optimizer '{name}' is not yet ported to "
                                  f"deepspeed_tpu_torch (queue A.6)")
    if key not in _FACTORY:
        raise ValueError(f"unknown optimizer '{name}' (known: {sorted(_FACTORY)})")
    params = dict(params)
    params.pop("torch_adam", None)
    params.pop("fused", None)
    if "learning_rate" in params:
        params["lr"] = params.pop("learning_rate")
    if "betas" in params:
        params["betas"] = tuple(params["betas"])
    if "adam_w_mode" in params:
        params["adamw"] = params.pop("adam_w_mode")
    fn = _FACTORY[key]
    target = fn.func if isinstance(fn, partial) else fn
    accepted = set(inspect.signature(target).parameters)
    dropped = sorted(k for k in params if k not in accepted)
    if dropped:
        from ..utils.logging import logger

        logger.warning(f"optimizer '{name}': ignoring unsupported params {dropped}")
    return fn(**{k: v for k, v in params.items() if k in accepted})
