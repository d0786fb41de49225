"""1-bit optimizers — counterpart of ``deepspeed_tpu/ops/onebit.py``
(``onebit_adam`` :37, ``onebit_lamb`` :88, ``zero_one_adam`` :138).

After a full-precision warmup (``freeze_step``) OnebitAdam and OnebitLamb
freeze the variance and update the momentum from the error-feedback 1-bit
compressed gradient (``comm/compressed.py`` ``onebit_compress``); 0/1 Adam
compresses from the first step and refreshes the variance during its
warmup and then every ``var_update_scaler`` steps. As in the JAX package,
the gradient is already reduced when the optimizer sees it: what the
compression changes is the algorithm (the moments), not the wire.

Updates run in place over ``torch._foreach_*`` ops, as ``ops/optimizers.py``'s.
The compression scale ``mean(|g + e|)`` and LAMB's norms are taken over the
JAX leaf (the optimizer's ``layout``): sums over the leaf's layers and over
the data axis, divided by the JAX leaf's size.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..comm.compressed import onebit_compress
from .optimizers import (_NO_LAYOUT, Optimizer, Params, _apply, _chunks, _f32, _groups,
                         _lamb_apply, _zeros)


class OnebitAdamState(NamedTuple):
    step: int
    mu: Params       # momentum
    nu: Params       # variance, frozen after the warmup
    error: Params    # compression error feedback


OnebitLambState = OnebitAdamState
ZeroOneAdamState = OnebitAdamState


def _init(params: Params) -> OnebitAdamState:
    return OnebitAdamState(0, _zeros(params), _zeros(params), _zeros(params))


def _compressed(params, grads, error, layout):
    """The EF-1-bit compressed gradient of every leaf (``signs * scale``,
    the scale over its JAX leaf); the new error is written into ``error``
    in place. ``|g + e|`` is summed in a first pass without keeping
    ``g + e``, so one leaf's temporaries live at a time."""
    names = list(params)
    sums = layout.leaf_sums({n: (grads[n].float() + error[n]).abs().sum() for n in names})
    counts = {}
    for n in names:
        path = layout.of(n).path
        counts[path] = counts.get(path, 0) + layout.numel(n, params[n])
    out = {}
    for n in names:
        path = layout.of(n).path
        signs, scale, new_e = onebit_compress(grads[n].float(), error[n],
                                              scale=sums[path] * (1.0 / counts[path]))
        out[n] = signs.float() * scale
        error[n].copy_(new_e)
    return out


def _moments(state, names, g_eff, grads, b1, b2, refresh: bool) -> None:
    """m = b1 m + (1 - b1) g_eff; v = b2 v + (1 - b2) g^2 when ``refresh``."""
    for run in _groups(names, state.mu):
        ms = [state.mu[n] for n in run]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(_f32([g_eff[n] for n in run]), 1 - b1))
        if refresh:
            gs = _f32([grads[n] for n in run])
            vs = [state.nu[n] for n in run]
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))


def _adam_like(params, state, eps, weight_decay, adamw, alpha) -> None:
    """p -= alpha * (m / (sqrt(v) + eps) [+ weight_decay * p])."""
    for names in _groups(list(params), params):
        for run in _chunks(names, params):
            ps = [params[n] for n in run]
            den = torch._foreach_sqrt([state.nu[n] for n in run])
            torch._foreach_add_(den, eps)
            u = torch._foreach_div([state.mu[n] for n in run], den)
            del den
            if weight_decay and adamw:
                torch._foreach_add_(u, torch._foreach_mul(_f32(ps), weight_decay))
            torch._foreach_mul_(u, alpha)
            _apply(ps, u)
            del u


def _l2_grads(params, grads, weight_decay):
    return {n: grads[n].float() + weight_decay * params[n].float() for n in params}


def onebit_adam(lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                eps: float = 1e-8, weight_decay: float = 0.0,
                freeze_step: int = 100, adamw: bool = True) -> Optimizer:
    """Warmup: exact Adam without bias correction; after ``freeze_step`` the
    variance is frozen and the momentum follows the EF-1-bit compressed
    gradient."""
    b1, b2 = betas

    def update(params, grads, state: OnebitAdamState, lr_scale=1.0, layout=None):
        layout = layout or _NO_LAYOUT
        step = state.step + 1
        warm = step <= freeze_step
        alpha = lr * float(lr_scale)
        l2 = weight_decay if (weight_decay and not adamw) else 0.0
        with torch.no_grad():
            g = _l2_grads(params, grads, l2) if l2 else grads
            g_eff = g if warm else _compressed(params, g, state.error, layout)
            _moments(state, list(params), g_eff, g, b1, b2, refresh=warm)
            _adam_like(params, state, eps, weight_decay, adamw, alpha)
        return params, OnebitAdamState(step, state.mu, state.nu, state.error)

    return Optimizer("onebitadam", _init, update,
                     dict(lr=lr, betas=betas, eps=eps,
                          weight_decay=weight_decay, freeze_step=freeze_step))


def onebit_lamb(lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                eps: float = 1e-6, weight_decay: float = 0.0,
                freeze_step: int = 100,
                min_trust: float = 0.01, max_trust: float = 10.0) -> Optimizer:
    """LAMB's trust ratio over the (compressed) Adam-style update, the
    variance frozen after the warmup."""
    b1, b2 = betas

    def update(params, grads, state: OnebitLambState, lr_scale=1.0, layout=None):
        layout = layout or _NO_LAYOUT
        step = state.step + 1
        warm = step <= freeze_step
        alpha = lr * float(lr_scale)

        def direction(run):
            den = torch._foreach_sqrt([state.nu[n] for n in run])
            torch._foreach_add_(den, eps)
            u = torch._foreach_div([state.mu[n] for n in run], den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(_f32([params[n] for n in run]),
                                                      weight_decay))
            return u

        with torch.no_grad():
            g_eff = grads if warm else _compressed(params, grads, state.error, layout)
            _moments(state, list(params), g_eff, grads, b1, b2, refresh=warm)
            _lamb_apply(params, list(params), direction, layout, alpha, min_trust, max_trust)
        return params, OnebitLambState(step, state.mu, state.nu, state.error)

    return Optimizer("onebitlamb", _init, update,
                     dict(lr=lr, betas=betas, eps=eps,
                          weight_decay=weight_decay, freeze_step=freeze_step))


def zero_one_adam(lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                  eps: float = 1e-8, weight_decay: float = 0.0,
                  var_freeze_step: int = 100,
                  var_update_scaler: int = 16, adamw: bool = True) -> Optimizer:
    """0/1 Adam: 1-bit compressed momentum from the first step; the
    variance refreshes every step until ``var_freeze_step`` and then every
    ``var_update_scaler`` steps."""
    b1, b2 = betas

    def update(params, grads, state: ZeroOneAdamState, lr_scale=1.0, layout=None):
        layout = layout or _NO_LAYOUT
        step = state.step + 1
        refresh = step <= var_freeze_step or step % var_update_scaler == 0
        alpha = lr * float(lr_scale)
        l2 = weight_decay if (weight_decay and not adamw) else 0.0
        with torch.no_grad():
            g = _l2_grads(params, grads, l2) if l2 else grads
            g_comp = _compressed(params, g, state.error, layout)
            _moments(state, list(params), g_comp, g, b1, b2, refresh=refresh)
            _adam_like(params, state, eps, weight_decay, adamw, alpha)
        return params, ZeroOneAdamState(step, state.mu, state.nu, state.error)

    return Optimizer("zerooneadam", _init, update,
                     dict(lr=lr, betas=betas, eps=eps,
                          weight_decay=weight_decay,
                          var_freeze_step=var_freeze_step))
