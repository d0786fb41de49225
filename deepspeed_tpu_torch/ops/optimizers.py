"""Optimizers on fp32 masters — counterpart of
``deepspeed_tpu/ops/optimizers.py`` (``adam`` :63, ``lion`` :116, ``lamb``
:148, ``adagrad`` :194, ``sgd`` :227, ``muon`` :256, ``_FACTORY`` :321,
``_register_onebit`` :335, ``get_optimizer`` :357, ``grouped_optimizer``
:390); the 1-bit ones are in ``ops/onebit.py``.

Interface as in the JAX package::

    opt = get_optimizer("adamw", lr=3e-4, weight_decay=0.1)
    state = opt.init(params)                      # fp32 state
    params, state = opt.update(params, grads, state, lr_scale=sched(t) / lr)

Params are a dict of fp32 tensors. Unlike the JAX package, ``update``
writes the new params and the state's tensors IN PLACE (the returned objects
are the same tensors): at 8B-width the masters and both moments are ~23 GB,
and a functional update would need as much again.

Each update is multi-tensor: ``torch._foreach_*`` ops over every leaf of a
(device, dtype) group at once, the moments in one pass, and what needs a
temporary (the step) in chunks of at most :data:`CHUNK_BYTES` of
temporaries, so the peak is the largest leaf's temporaries or one chunk's.
The arithmetic is the JAX update's, op for op, including ``adam``'s quirk:
with ``adamw=False`` weight decay is still added to the step as
``weight_decay * p`` (JAX ``optimizers.py:87-94``).

The layout seam (:class:`Layout`). Some optimizers reduce over a whole
leaf: LAMB's trust ratio (its two norms), Muon's orthogonalization (its
``_is_matrix`` test, its Newton-Schulz input and its scale) and the 1-bit
compression scale. A JAX leaf is stacked over the layers and laid out
``[in, out]``; a port leaf is one layer in ``[out, in]`` and, from ZeRO
stage 1, one rank's shard. ``update(..., layout=)`` takes each reduction
over the JAX leaf: sums are summed over the leaf's layers and then
all-reduced over the data axis, and Muon all-gathers one momentum leaf at a
time. Without a layout (a user's own model) a port leaf is its own JAX leaf.
"""

from __future__ import annotations

import inspect
import math
import re
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]

# bytes of temporaries an update holds at once (the step of a chunk of
# leaves); a leaf larger than this is a chunk of its own
CHUNK_BYTES = 256 << 20

# Newton-Schulz quintic coefficients (JAX ``_newton_schulz``)
NS_COEFFS = (3.4445, -4.7750, 2.0315)


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]
    hyperparams: Dict[str, Any]


# --------------------------------------------------------------------------- #
# where a port leaf lives in the JAX tree
# --------------------------------------------------------------------------- #
class LeafLayout(NamedTuple):
    """One port leaf's place in its JAX leaf: the JAX path ('/'-joined),
    the index along the JAX leaf's stacked layer dim (None: not stacked),
    whether the port keeps it transposed, the dim split over the ranks
    (None: whole on every rank) and the axes of that split, row-major in
    their order (None: the layout's data axis; an expert bank's are
    ``expert`` and its replicas)."""

    path: str
    layer: Optional[int] = None
    transpose: bool = False
    shard_dim: Optional[int] = None
    axes: Any = None


class Layout:
    """Port leaves → their :class:`LeafLayout`, and the data axis their
    shards lie over. A leaf not listed is its own JAX leaf, whole."""

    def __init__(self, leaves: Optional[Dict[str, LeafLayout]] = None,
                 axis: Any = None, mesh: Any = None):
        self.leaves = dict(leaves or {})
        self.axis, self.mesh = axis, mesh

    @classmethod
    def for_model(cls, model_config: Any, names, shard_dims: Optional[Dict] = None,
                  axis: Any = None, mesh: Any = None,
                  axes: Optional[Dict] = None) -> "Layout":
        """The layout of a model's leaves: with a family's config, the JAX
        tree's places (``models/convert.py`` ``jax_leaf``); each leaf's
        sharded dim from ``shard_dims`` and its split's axes from ``axes``
        (the engine's)."""
        from ..models.convert import jax_leaf

        shard_dims, axes = shard_dims or {}, axes or {}
        leaves = {}
        for n in names:
            path, layer, t = jax_leaf(n) if model_config is not None else (n, None, False)
            leaves[n] = LeafLayout(path, layer, t, shard_dims.get(n), axes.get(n))
        sharded = any(v.shard_dim is not None for v in leaves.values())
        return cls(leaves, axis if sharded else None, mesh)

    def of(self, name: str) -> LeafLayout:
        return self.leaves.get(name) or LeafLayout(name)

    def _axis_of(self, name: str) -> Any:
        return self.of(name).axes or self.axis

    def _size(self, name: str) -> int:
        axis = self._axis_of(name)
        return 1 if axis is None else self.mesh.axis_size(axis)

    def jax_ndim(self, name: str, t: torch.Tensor) -> int:
        return t.dim() + (self.of(name).layer is not None)

    def paths(self, names) -> Dict[str, List[str]]:
        """JAX path → its port leaves among ``names``, in layer order."""
        out: Dict[str, List[str]] = {}
        for n in sorted(names, key=lambda n: (self.of(n).path, self.of(n).layer or 0)):
            out.setdefault(self.of(n).path, []).append(n)
        return out

    def leaf_sums(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """JAX path → the sum of its port leaves' 0-d ``values`` (summed in
        layer order, then over the data axis for sharded leaves, all such
        sums in one all-reduce)."""
        sums = {path: torch.stack([values[n] for n in names]).sum()
                for path, names in self.paths(values).items()}
        by_axis: Dict[Tuple[str, ...], List[str]] = {}   # one all-reduce an axis group
        for p, names in self.paths(values).items():
            axis = self._axis_of(names[0])
            if self.of(names[0]).shard_dim is not None and axis is not None:
                from ..comm.mesh import MESH_AXES

                key = tuple(a for a in MESH_AXES if a in ((axis,) if isinstance(axis, str)
                                                          else tuple(axis)))
                by_axis.setdefault(key, []).append(p)
        if by_axis:
            from ..comm import comm

            for axis, sharded in by_axis.items():
                total = comm.all_reduce(torch.stack([sums[p] for p in sharded]), axis,
                                        mesh=self.mesh)
                sums.update(zip(sharded, total.unbind(0)))
        return sums

    def numel(self, name: str, t: torch.Tensor) -> int:
        """Elements of the whole port leaf whose part ``t`` is."""
        return t.numel() * (self._size(name) if self.of(name).shard_dim is not None else 1)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim, axis = self.of(name).shard_dim, self._axis_of(name)
        if dim is None or axis is None:
            return t
        from ..runtime.partitioning import unshard_parts

        return unshard_parts(t, dim, (axis,) if isinstance(axis, str) else axis, self.mesh)

    def own(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        dim, axis = self.of(name).shard_dim, self._axis_of(name)
        if dim is None or axis is None:
            return whole
        from ..runtime.partitioning import shard

        return shard(whole, dim, self.mesh.axis_index(axis), self._size(name))


_NO_LAYOUT = Layout()


# --------------------------------------------------------------------------- #
# multi-tensor helpers
# --------------------------------------------------------------------------- #
def _groups(names: List[str], params: Params) -> Iterator[List[str]]:
    """``names`` grouped by (device, dtype) of their params, so each group
    goes through ``torch._foreach_*`` together."""
    by: Dict[Tuple, List[str]] = {}
    for n in names:
        by.setdefault((params[n].device, params[n].dtype), []).append(n)
    return iter(by.values())


def _chunks(names: List[str], params: Params, temps: int = 2) -> Iterator[List[str]]:
    """``names`` in runs whose ``temps`` fp32 temporaries total at most
    :data:`CHUNK_BYTES` (a larger leaf alone)."""
    run, size = [], 0
    for n in names:
        b = params[n].numel() * 4 * temps
        if run and size + b > CHUNK_BYTES:
            yield run
            run, size = [], 0
        run.append(n)
        size += b
    if run:
        yield run


def _f32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    return [t if t.dtype == torch.float32 else t.float() for t in ts]


def _apply(ps: List[torch.Tensor], steps: List[torch.Tensor]) -> None:
    """p -= step, the step rounded to the param's dtype first."""
    if ps and ps[0].dtype != torch.float32:
        steps = [s.to(p.dtype) for s, p in zip(steps, ps)]
    torch._foreach_sub_(ps, steps)


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


# --------------------------------------------------------------------------- #
# Adam / AdamW
# --------------------------------------------------------------------------- #
class AdamState(NamedTuple):
    step: int
    mu: Params
    nu: Params


def _adam_moments(ms, vs, gs, b1, b2):
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)


def _adam_step(ms, vs, ps, c1, c2, eps, weight_decay):
    """The Adam direction ``(m / c1) / (sqrt(v / c2) + eps)`` (plus
    ``weight_decay * p``), as new fp32 tensors."""
    den = torch._foreach_div(vs, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    out = torch._foreach_div(ms, c1)
    torch._foreach_div_(out, den)
    del den
    if weight_decay:
        torch._foreach_add_(out, _f32(ps), alpha=weight_decay)
    return out


def adam(lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.0,
         adamw: bool = True, bias_correction: bool = True) -> Optimizer:
    b1, b2 = betas

    def init(params: Params) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params))

    def update(params: Params, grads: Params, state: AdamState, lr_scale: float = 1.0,
               layout: Optional[Layout] = None, apply_to=None) -> Tuple[Params, AdamState]:
        # apply_to: the leaves whose params move (all by default); the others'
        # moments still advance (Muon's fallback runs over every leaf)
        step = state.step + 1
        if bias_correction:
            c1 = 1 - b1 ** float(step)
            c2 = 1 - b2 ** float(step)
        else:
            c1 = c2 = 1.0
        alpha = lr * float(lr_scale)
        with torch.no_grad():
            for names in _groups(list(params), params):
                ms = [state.mu[n] for n in names]
                vs = [state.nu[n] for n in names]
                _adam_moments(ms, vs, _f32([grads[n] for n in names]), b1, b2)
                moving = [n for n in names if apply_to is None or n in apply_to]
                for run in _chunks(moving, params):
                    ps = [params[n] for n in run]
                    out = _adam_step([state.mu[n] for n in run], [state.nu[n] for n in run],
                                     ps, c1, c2, eps, weight_decay)
                    torch._foreach_mul_(out, alpha)
                    _apply(ps, out)
                    del out
        return params, AdamState(step, state.mu, state.nu)

    return Optimizer("adamw" if adamw else "adam", init, update,
                     dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))


# --------------------------------------------------------------------------- #
# Lion
# --------------------------------------------------------------------------- #
class LionState(NamedTuple):
    step: int
    mu: Params


def lion(lr: float = 1e-4, betas: Tuple[float, float] = (0.9, 0.99),
         weight_decay: float = 0.0) -> Optimizer:
    b1, b2 = betas

    def init(params: Params) -> LionState:
        return LionState(0, _zeros(params))

    def update(params, grads, state: LionState, lr_scale=1.0, layout=None):
        alpha = lr * float(lr_scale)
        with torch.no_grad():
            for names in _groups(list(params), params):
                for run in _chunks(names, params):
                    ps, ms = [params[n] for n in run], [state.mu[n] for n in run]
                    gs = _f32([grads[n] for n in run])
                    d = torch._foreach_mul(ms, b1)
                    gb = torch._foreach_mul(gs, 1 - b1)
                    torch._foreach_add_(d, gb)
                    del gb
                    torch._foreach_sign_(d)
                    if weight_decay:
                        wd = torch._foreach_mul(_f32(ps), weight_decay)
                        torch._foreach_add_(d, wd)
                        del wd
                    torch._foreach_mul_(d, alpha)
                    _apply(ps, d)
                    del d
                    torch._foreach_mul_(ms, b2)
                    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b2))
        return params, LionState(state.step + 1, state.mu)

    return Optimizer("lion", init, update, dict(lr=lr, betas=betas,
                                                weight_decay=weight_decay))


# --------------------------------------------------------------------------- #
# LAMB
# --------------------------------------------------------------------------- #
def _sumsq(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    return [n * n for n in torch._foreach_norm(ts)]


def _trust(w_sq: torch.Tensor, u_sq: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """JAX: ``where(w > 0 & u > 0, clip(w / u, lo, hi), 1)`` of the norms."""
    w, u = w_sq.sqrt(), u_sq.sqrt()
    ratio = torch.clamp(w / u, lo, hi)
    return torch.where((w > 0) & (u > 0), ratio, torch.ones_like(ratio))


def _lamb_apply(params, names, direction, layout, alpha, lo, hi):
    """Two passes over chunks: the norms of the params and of the update
    ``direction(run)`` per JAX leaf, then ``p -= alpha * trust * u`` with the
    update computed again (the same arithmetic, so the same values), so no
    more than a chunk of temporaries lives at once."""
    w_sq, u_sq = {}, {}
    for run in _chunks(names, params, temps=3):
        u = direction(run)
        w_sq.update(zip(run, _sumsq(_f32([params[n] for n in run]))))
        u_sq.update(zip(run, _sumsq(u)))
        del u
    w_tot, u_tot = layout.leaf_sums(w_sq), layout.leaf_sums(u_sq)
    scale = {path: alpha * _trust(w_tot[path], u_tot[path], lo, hi) for path in w_tot}
    for run in _chunks(names, params, temps=3):
        u = direction(run)
        for n, un in zip(run, u):
            un.mul_(scale[layout.of(n).path])
        _apply([params[n] for n in run], u)
        del u


def lamb(lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-6, weight_decay: float = 0.0,
         min_trust: float = 0.01, max_trust: float = 10.0) -> Optimizer:
    b1, b2 = betas

    def init(params: Params) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params))

    def update(params, grads, state: AdamState, lr_scale=1.0, layout=None):
        layout = layout or _NO_LAYOUT
        step = state.step + 1
        c1 = 1 - b1 ** float(step)
        c2 = 1 - b2 ** float(step)
        alpha = lr * float(lr_scale)

        def direction(run):
            u = _adam_step([state.mu[n] for n in run], [state.nu[n] for n in run],
                           [params[n] for n in run], c1, c2, eps, 0.0)
            wd = torch._foreach_mul(_f32([params[n] for n in run]), weight_decay)
            torch._foreach_add_(u, wd)
            return u

        with torch.no_grad():
            for names in _groups(list(params), params):
                _adam_moments([state.mu[n] for n in names], [state.nu[n] for n in names],
                              _f32([grads[n] for n in names]), b1, b2)
            _lamb_apply(params, list(params), direction, layout, alpha, min_trust, max_trust)
        return params, AdamState(step, state.mu, state.nu)

    return Optimizer("lamb", init, update, dict(lr=lr, betas=betas, eps=eps,
                                                weight_decay=weight_decay))


# --------------------------------------------------------------------------- #
# Adagrad
# --------------------------------------------------------------------------- #
class AdagradState(NamedTuple):
    step: int
    accum: Params


def _decayed(gs, ps, weight_decay):
    """JAX: ``g + weight_decay * p`` (new tensors), or ``gs`` unchanged."""
    if not weight_decay:
        return gs
    out = torch._foreach_mul(_f32(ps), weight_decay)
    torch._foreach_add_(out, gs)
    return out


def adagrad(lr: float = 1e-2, eps: float = 1e-10,
            weight_decay: float = 0.0) -> Optimizer:
    def init(params: Params) -> AdagradState:
        return AdagradState(0, _zeros(params))

    def update(params, grads, state: AdagradState, lr_scale=1.0, layout=None):
        alpha = lr * float(lr_scale)
        with torch.no_grad():
            for names in _groups(list(params), params):
                for run in _chunks(names, params):
                    ps, accs = [params[n] for n in run], [state.accum[n] for n in run]
                    gs = _decayed(_f32([grads[n] for n in run]), ps, weight_decay)
                    torch._foreach_addcmul_(accs, gs, gs)
                    den = torch._foreach_sqrt(accs)
                    torch._foreach_add_(den, eps)
                    d = torch._foreach_mul(gs, alpha)
                    torch._foreach_div_(d, den)
                    del den
                    _apply(ps, d)
                    del d
        return params, AdagradState(state.step + 1, state.accum)

    return Optimizer("adagrad", init, update, dict(lr=lr, eps=eps))


# --------------------------------------------------------------------------- #
# SGD (+momentum)
# --------------------------------------------------------------------------- #
class SGDState(NamedTuple):
    step: int
    mu: Params


def sgd(lr: float = 1e-2, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params: Params) -> SGDState:
        return SGDState(0, _zeros(params))

    def update(params, grads, state: SGDState, lr_scale=1.0, layout=None):
        alpha = lr * float(lr_scale)
        with torch.no_grad():
            for names in _groups(list(params), params):
                for run in _chunks(names, params):
                    ps, ms = [params[n] for n in run], [state.mu[n] for n in run]
                    gs = _decayed(_f32([grads[n] for n in run]), ps, weight_decay)
                    torch._foreach_mul_(ms, momentum)
                    torch._foreach_add_(ms, gs)
                    if nesterov:
                        d = torch._foreach_mul(ms, momentum)
                        torch._foreach_add_(d, gs)
                    else:
                        d = [m.clone() for m in ms]
                    torch._foreach_mul_(d, alpha)
                    _apply(ps, d)
                    del d
        return params, SGDState(state.step + 1, state.mu)

    return Optimizer("sgd", init, update, dict(lr=lr, momentum=momentum))


# --------------------------------------------------------------------------- #
# Muon
# --------------------------------------------------------------------------- #
def _newton_schulz(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Quintic Newton-Schulz iteration orthogonalizing a 2-D update (JAX
    ``_newton_schulz``), in fp32: with TF32 off (torch's default for
    matmuls) the products are full fp32, as in the JAX package."""
    a, b, c = NS_COEFFS
    x = g / (torch.linalg.vector_norm(g) + 1e-7)
    transpose = x.shape[0] > x.shape[1]
    if transpose:
        x = x.T
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * xxt @ xxt) @ x
    if transpose:
        x = x.T
    return x


class MuonState(NamedTuple):
    step: int
    mu: Params
    fb_state: Any


def _muon_targets(layout: Layout, names: List[str], params: Params):
    """The JAX leaves Muon orthogonalizes, as (port leaves, stacked): the
    JAX ``_is_matrix`` (ndim 2 or 3) of each JAX leaf. A stacked [L, m, n]
    leaf is orthogonalized a layer at a time (JAX ``vmap``), so each of its
    port leaves is a target alone; a stacked vector leaf ([L, n] in JAX, a
    norm or a bias) is one matrix, its L port leaves together."""
    out = []
    for path, members in layout.paths(names).items():
        nd = layout.jax_ndim(members[0], params[members[0]])
        if nd == 3:
            out += [([n], False) for n in members]
        elif nd == 2:
            out.append((members, layout.of(members[0]).layer is not None))
    return out


def muon(lr: float = 0.02, momentum: float = 0.95, ns_steps: int = 5,
         weight_decay: float = 0.0, fallback: Optional[Optimizer] = None) -> Optimizer:
    """Muon for the JAX package's matrices (every leaf of 2 or 3 dims in its
    tree, stacked norms included); the AdamW fallback at lr 3e-4 runs over
    every leaf, and moves the params of the others."""
    fb = fallback or adam(lr=3e-4, weight_decay=weight_decay)

    def init(params: Params) -> MuonState:
        return MuonState(0, _zeros(params), fb.init(params))

    def update(params, grads, state: MuonState, lr_scale=1.0, layout=None):
        layout = layout or _NO_LAYOUT
        alpha = lr * float(lr_scale)
        names = list(params)
        targets = _muon_targets(layout, names, params)
        matrices = {n for members, _ in targets for n in members}
        with torch.no_grad():
            # the fallback's step over every leaf, from the params before
            # Muon's own step (JAX ``fb.update(params, ...)``)
            _, fb_state = fb.update(params, grads, state.fb_state, lr_scale,
                                    layout=layout,
                                    apply_to={n for n in names if n not in matrices})
            for run in _groups(sorted(matrices), params):
                ms = [state.mu[n] for n in run]
                torch._foreach_mul_(ms, momentum)
                torch._foreach_add_(ms, _f32([grads[n] for n in run]))
            for members, stacked in targets:
                _muon_step(params, state.mu, members, stacked, layout, alpha,
                           weight_decay, ns_steps)
        return params, MuonState(state.step + 1, state.mu, fb_state)

    return Optimizer("muon", init, update, dict(lr=lr, momentum=momentum))


def _muon_step(params, mu, members, stacked, layout, alpha, weight_decay, ns_steps):
    """Orthogonalize one JAX matrix from the whole momentum (gathered over
    the data axis, in the JAX orientation) and step this rank's part."""
    whole = [layout.gather(n, mu[n]) for n in members]
    if stacked:
        x = torch.stack(whole)                                    # [L, n]
    else:
        x = whole[0].T if layout.of(members[0]).transpose else whole[0]
    o = _newton_schulz(x, ns_steps)
    scale = math.sqrt(max(1.0, o.shape[-2] / o.shape[-1]))
    for i, n in enumerate(members):
        oi = o[i] if stacked else (o.T if layout.of(n).transpose else o)
        oi = layout.own(n, oi)
        p = params[n]
        pf = p.float()
        decay = pf * (alpha * weight_decay) if weight_decay else None
        new = pf - oi * (alpha * scale)
        if decay is not None:
            new = new - decay
        p.copy_(new)


# --------------------------------------------------------------------------- #
# factory (reference engine._configure_basic_optimizer)
# --------------------------------------------------------------------------- #
_FACTORY: Dict[str, Callable[..., Optimizer]] = {
    "adam": partial(adam, adamw=False),
    "adamw": adam,
    "fusedadam": adam,
    "lion": lion,
    "fusedlion": lion,
    "lamb": lamb,
    "fusedlamb": lamb,
    "adagrad": adagrad,
    "sgd": sgd,
    "muon": muon,
}


def _register_onebit() -> None:
    """Lazy registration: ``.onebit`` imports this module."""
    if "onebitadam" in _FACTORY:
        return
    from .onebit import onebit_adam, onebit_lamb, zero_one_adam

    _FACTORY.update({
        "onebitadam": onebit_adam,
        "onebitlamb": onebit_lamb,
        "zerooneadam": zero_one_adam,
        "01adam": zero_one_adam,
    })


def get_optimizer(name: str, **params) -> Optimizer:
    """Build from a DeepSpeed-style optimizer config block (same key aliases
    as the JAX package: ``learning_rate``, ``betas``, ``adam_w_mode``)."""
    _register_onebit()
    key = name.lower().replace("_", "")
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


# --------------------------------------------------------------------------- #
# param groups
# --------------------------------------------------------------------------- #
def grouped_optimizer(name: str, params_tree: Params, param_groups,
                      leaf_paths: Optional[Dict[str, str]] = None,
                      **base_params) -> Optimizer:
    """Per-group hyperparameters over one param dict (JAX
    ``grouped_optimizer``): ``param_groups`` is ``[{"pattern": <regex>,
    **overrides}, ...]``; the first group whose pattern matches a leaf's
    JAX path ('/'-joined, ``leaf_paths[name]``; the port name itself when
    not given) wins, and unmatched leaves use ``base_params``. The patterns
    never see the port's ``layers.<i>.`` names, so one config selects the
    same leaves in both packages, and all layers of a JAX leaf fall in one
    group. The state is a tuple of the groups' states; a group with no leaf
    keeps its state unchanged, as in the JAX package."""
    compiled = []
    for i, g in enumerate(param_groups):
        if "pattern" not in g:
            raise ValueError(f"optimizer param_groups[{i}] has no 'pattern' "
                             f"key (got keys {sorted(g)})")
        try:
            compiled.append(re.compile(g["pattern"]))
        except re.error as e:
            raise ValueError(f"optimizer param_groups[{i}] pattern "
                             f"{g['pattern']!r} is not a valid regex: {e}") from None
    paths = dict(leaf_paths or {})
    assignment = {}
    for leaf in params_tree:
        path = paths.get(leaf, leaf)
        assignment[leaf] = next((i for i, rx in enumerate(compiled) if rx.search(path)),
                                len(param_groups))
    opts = []
    for g in list(param_groups) + [{}]:
        hp = dict(base_params)
        hp.update({k: v for k, v in g.items() if k != "pattern"})
        opts.append(get_optimizer(name, **hp))
    members = [[k for k in params_tree if assignment[k] == g] for g in range(len(opts))]

    def init(params: Params):
        return tuple(opt.init({k: params[k] for k in ks}) for opt, ks in zip(opts, members))

    def update(params, grads, state, lr_scale=1.0, layout=None):
        new = []
        for opt, ks, st in zip(opts, members, state):
            if ks:
                _, st = opt.update({k: params[k] for k in ks}, {k: grads[k] for k in ks},
                                   st, lr_scale=lr_scale, layout=layout)
            new.append(st)
        return params, tuple(new)

    hyper = dict(base_params)
    hyper["param_groups"] = [dict(g) for g in param_groups]
    return Optimizer(f"{name}+groups", init, update, hyper)


# --------------------------------------------------------------------------- #
# the state as named parts (checkpoints)
# --------------------------------------------------------------------------- #
def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def state_tensors(state: Any, prefix: str = "") -> Dict[str, Params]:
    """Dotted path (the JAX state tree's: ``mu``, ``fb_state.nu``, ``0.mu``)
    → each dict of leaf tensors in an optimizer state."""
    if isinstance(state, dict):
        return {prefix: state}
    out: Dict[str, Params] = {}
    if isinstance(state, tuple):
        fields = getattr(state, "_fields", None) or [str(i) for i in range(len(state))]
        for f, v in zip(fields, state):
            out.update(state_tensors(v, _join(prefix, f)))
    return out


def state_scalars(state: Any, prefix: str = "") -> Dict[str, int]:
    """Dotted path → each integer of an optimizer state (its steps)."""
    if isinstance(state, dict):
        return {}
    if isinstance(state, tuple):
        fields = getattr(state, "_fields", None) or [str(i) for i in range(len(state))]
        out: Dict[str, int] = {}
        for f, v in zip(fields, state):
            out.update(state_scalars(v, _join(prefix, f)))
        return out
    return {prefix: int(state)}


def with_scalars(state: Any, values: Dict[str, int], prefix: str = "") -> Any:
    """``state`` with the integers at the paths of ``values`` replaced."""
    if isinstance(state, dict):
        return state
    if isinstance(state, tuple):
        fields = getattr(state, "_fields", None)
        names = fields or [str(i) for i in range(len(state))]
        items = [with_scalars(v, values, _join(prefix, f)) for f, v in zip(names, state)]
        return type(state)(*items) if fields else tuple(items)
    return int(values.get(prefix, state))
