"""ZeRO stages as sharding specs, and the helpers that shard and gather —
counterpart of ``deepspeed_tpu/runtime/partitioning.py`` (``DEFAULT_RULES``,
``logical_to_spec``, ``_add_zero_axes``, ``Partitioner``).

A spec is a tuple with one entry per dim of a leaf: ``None`` (not sharded),
a mesh axis, or a tuple of mesh axes, as a JAX ``PartitionSpec``'s entries
are. The partitioner gives each leaf's specs per stage:

- stage 1: masters and optimizer state ZeRO-sharded (``opt_state_specs``);
- stage 2: + gradients (``grad_specs``);
- stage 3: + parameters (``param_specs``), gathered at use.

One dim of a leaf is sharded over the ZeRO axes: the largest dim that
divides evenly, and the leaf stays replicated when none does. Ties go to the
dim the JAX package's layout lists first. The port keeps its weights per
layer and in ``nn.Linear`` layout ``[out, in]``, where the JAX package
stacks the layers in a leading dim and keeps ``x @ W`` matrices ``[in,
out]``; a model's logical axes (:class:`LeafAxes`) therefore name the port's
dims and give the order of the JAX layout's dims for the tie. JAX shards
the stacked ``layers`` dim only when no other dim divides; the port has no
such dim, so those leaves stay replicated here.

Expert parallelism: a leaf with an ``expert`` logical dim (a MoE bank) is
split over the ``expert`` mesh axis along that dim at every stage, and
ZeRO's other axes split the same dim further where each rank's experts
divide over them (``("expert", "data")``: expert-major parts), so a leaf
has one split dim, the one a checkpoint's parts name; where they do not
divide, the bank stays whole across its replicas. Its gradient reduces
over the replica axes only (:class:`Split`).

Tensor, pipeline, hpZ and MiCS rules are not ported (ROADMAP A.7, A.10): a
mesh with a ``tensor``, ``pipe`` or ``zero_shard`` axis above 1 is refused.

:func:`shard` / :func:`unshard` move a leaf between its full and sharded
forms, and :class:`GatherParam` is stage 3's gather at use: it all-gathers
the compute-dtype copy of a shard and reduce-scatters the full grad back,
in fp32.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..comm import comm
from ..comm.mesh import ZERO_AXES, AxisName, MeshManager
from .activation_checkpointing.checkpointing import in_checkpoint

# default logical-axis → mesh-axis rules (t5x style)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "heads": "tensor",
    "kv_heads": "tensor",
    "mlp": "tensor",
    "vocab": "tensor",
    "tp": "tensor",
    "expert": "expert",
    "embed": None,
    "layers": None,
    "kv": None,
}

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


class LeafAxes(NamedTuple):
    """A leaf's logical axis names, one per dim of the port's tensor, and
    ``ref_order``: its dims in the order the JAX layout lists them (None:
    the same order), which breaks ties between equal dims."""

    names: Tuple[Optional[str], ...]
    ref_order: Optional[Tuple[int, ...]] = None


def linear(out_name: Optional[str], in_name: Optional[str]) -> LeafAxes:
    """An ``nn.Linear`` weight ``[out, in]``, kept ``[in, out]`` in JAX."""
    return LeafAxes((out_name, in_name), (1, 0))


def _leaf(axes) -> LeafAxes:
    return axes if isinstance(axes, LeafAxes) else LeafAxes(tuple(axes))


def logical_to_spec(axes: Sequence[Optional[str]], rules: Dict[str, Optional[str]]) -> Spec:
    return tuple(rules.get(a) if a is not None else None for a in axes)


def _add_zero_axes(spec: Spec, axes: LeafAxes, shape: Tuple[int, ...],
                   axis_sizes: Dict[str, int], zero_axes: Sequence[str]) -> Spec:
    """Shard one unsharded dim over the ZeRO axes: the largest dim that
    divides by their size (a non-``layers`` dim first; on a tie, the first
    in ``axes.ref_order``); the spec unchanged when none divides. Mesh axes
    the spec already uses are left out of the ZeRO group."""
    entries = list(spec)
    used = {a for e in entries for a in (e if isinstance(e, tuple) else (e,)) if a}
    zero_axes = tuple(a for a in zero_axes if a not in used)
    if not zero_axes:
        return spec
    zero_size = math.prod(axis_sizes[a] for a in zero_axes)
    order = axes.ref_order or tuple(range(len(shape)))
    candidates = []
    for pos, i in enumerate(order):
        if entries[i] is None and shape[i] % zero_size == 0:
            candidates.append((axes.names[i] != "layers", shape[i], -pos, i))
    if not candidates:
        return spec      # replicated: too small to shard
    entries[max(candidates)[3]] = tuple(zero_axes)
    return tuple(entries)


def shard_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards over ZeRO axes (a tuple entry), or None."""
    return next((i for i, e in enumerate(spec) if isinstance(e, tuple)), None)


class Split(NamedTuple):
    """How a master leaf lies over the ranks: split along ``dim`` into the
    parts of ``axes`` (row-major over them, in that order; None: whole on
    every rank), ZeRO's share of it along ``zero_dim`` over ``zero_axis``
    (None: not ZeRO-sharded), and ``zero_axis`` the replicas its gradient
    reduces over (None: the leaf has none)."""

    dim: Optional[int]
    axes: Optional[Tuple[str, ...]]
    zero_dim: Optional[int]
    zero_axis: Optional[Tuple[str, ...]]


def leaf_split(spec: Spec, axes, zero_axis: Tuple[str, ...], ep: int) -> Split:
    """The :class:`Split` of a leaf with ``spec`` and logical ``axes``;
    ``zero_axis`` the engine's ZeRO group, ``ep`` the expert axis's size."""
    names = _leaf(axes).names
    if ep > 1 and "expert" in names:
        i = names.index("expert")
        parts = spec[i] if isinstance(spec[i], tuple) else (spec[i],)
        replicas = tuple(a for a in zero_axis if a != "expert") or None
        return Split(i, parts, i if len(parts) > 1 else None, replicas)
    d = shard_dim(spec)
    return Split(d, tuple(zero_axis) if d is not None else None, d, tuple(zero_axis))


def unshard_parts(t: torch.Tensor, dim: Optional[int], axes: Optional[Sequence[str]],
                  mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """The whole leaf from parts split row-major over ``axes`` (in the
    given order, which need not be the mesh's): gathered over the last
    axis first."""
    if dim is None or not axes:
        return t
    for a in reversed(tuple(axes)):
        t = comm.all_gather(t, a, gather_axis=dim, mesh=mesh)
    return t


class Partitioner:
    """Param / grad / optimizer-state specs of a model over ``mesh_mgr``.

    ``logical_axes`` maps each leaf name to its :class:`LeafAxes` (or a
    plain tuple of names); ``shapes`` each leaf name to its shape. The ZeRO
    group is the axes of ``zero_axes`` with more than one member; with
    ``keep_trivial`` a one-member ``data`` axis still counts, so that a
    one-rank process group runs the sharded path's collectives."""

    def __init__(self, mesh_mgr: MeshManager, zero_stage: int = 0,
                 rules: Optional[Dict[str, Optional[str]]] = None,
                 zero_axes: Sequence[str] = ZERO_AXES, keep_trivial: bool = False):
        refused = {a: mesh_mgr.sizes[a] for a in ("tensor", "pipe", "zero_shard")
                   if mesh_mgr.sizes[a] > 1}
        if refused:
            raise NotImplementedError(f"not yet ported to deepspeed_tpu_torch: "
                                      f"partitioning over {refused} (TP / PP / MiCS / hpZ)")
        self.mm = mesh_mgr
        self.zero_stage = zero_stage
        self.zero_axes = tuple(a for a in zero_axes if mesh_mgr.axis_size(a) > 1)
        if not self.zero_axes and keep_trivial:
            self.zero_axes = ("data",)
        self.axis_sizes = {a: mesh_mgr.axis_size(a) for a in self.zero_axes}
        self.zero_size = math.prod(self.axis_sizes.values())
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        for k, v in list(self.rules.items()):     # no tensor axis: drop TP rules
            if v == "tensor":
                self.rules[k] = None

    def _specs(self, logical_axes, shapes, shard_extra: bool) -> Dict[str, Spec]:
        out = {}
        ep = self.mm.axis_size("expert")
        for name, shape in shapes.items():
            axes = _leaf(logical_axes[name])
            spec = logical_to_spec(axes.names, self.rules)
            if shard_extra and ep > 1 and "expert" in spec:
                spec = self._add_zero_to_experts(spec, tuple(shape), ep)
            elif shard_extra:
                spec = _add_zero_axes(spec, axes, tuple(shape), self.axis_sizes,
                                      self.zero_axes)
            out[name] = spec
        return out

    def _add_zero_to_experts(self, spec: Spec, shape: Tuple[int, ...], ep: int) -> Spec:
        """An expert leaf's ZeRO axes split its expert dim further, expert
        first, when a rank's experts divide over them (module docstring)."""
        i = spec.index("expert")
        rest = tuple(a for a in self.zero_axes if a != "expert")
        if not rest or (shape[i] // ep) % math.prod(self.axis_sizes[a] for a in rest):
            return spec
        entries = list(spec)
        entries[i] = ("expert",) + rest
        return tuple(entries)

    def param_specs(self, logical_axes, shapes) -> Dict[str, Spec]:
        """Compute-layout specs: ZeRO-sharded at stage 3 (gathered at use)."""
        return self._specs(logical_axes, shapes, self.zero_stage >= 3)

    def gathered_param_specs(self, logical_axes, shapes) -> Dict[str, Spec]:
        """The layout a sharded leaf has after its all-gather."""
        return self._specs(logical_axes, shapes, False)

    def grad_specs(self, logical_axes, shapes) -> Dict[str, Spec]:
        """Gradient specs: reduce-scattered (sharded) from stage 2."""
        return self._specs(logical_axes, shapes, self.zero_stage >= 2)

    def opt_state_specs(self, logical_axes, shapes) -> Dict[str, Spec]:
        """fp32 master and optimizer-state specs: sharded from stage 1."""
        return self._specs(logical_axes, shapes, self.zero_stage >= 1)


def replicated_axes(shapes) -> Dict[str, LeafAxes]:
    """Logical axes for a model that states none: no names, so ZeRO still
    shards each leaf's largest divisible dim."""
    return {k: LeafAxes((None,) * len(s)) for k, s in shapes.items()}


# --------------------------------------------------------------------------- #
# shard / unshard
# --------------------------------------------------------------------------- #
def shard(t: torch.Tensor, dim: Optional[int], index: int, n: int) -> torch.Tensor:
    """Member ``index``'s chunk of ``n`` along ``dim`` (a view; ``t`` itself
    when ``dim`` is None)."""
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


def unshard(t: torch.Tensor, dim: Optional[int], axis: AxisName,
            mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """The full leaf from every member's shard along ``dim`` (an all-gather
    along a dim other than 0 reorders through a transpose)."""
    if dim is None:
        return t
    return comm.all_gather(t, axis, gather_axis=dim, mesh=mesh)


class GatherParam(torch.autograd.Function):
    """Stage 3's gather at use: forward casts the fp32 shard to the compute
    dtype and all-gathers that copy along ``dim``; backward reduces the full
    grad in fp32 (never in the compute dtype), reduce-scattered to the shard
    along ``dim`` or, for a replicated leaf, all-reduced."""

    @staticmethod
    def forward(ctx, master: torch.Tensor, dim: Optional[int], axis: AxisName,
                mesh: MeshManager, dtype: torch.dtype) -> torch.Tensor:
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        c = master.to(dtype)
        if dim is None:
            return c if c is not master else master.view_as(master)
        return comm.all_gather(c, axis, gather_axis=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.float()
        if ctx.axis is None:
            return g, None, None, None, None
        if ctx.dim is None:
            g = comm.all_reduce(g, ctx.axis, mesh=ctx.mesh)
        else:
            g = comm.reduce_scatter(g, ctx.axis, scatter_axis=ctx.dim, mesh=ctx.mesh)
        return g, None, None, None, None


class GatherOnUse(Mapping):
    """A param mapping for one micro-batch at stage 3: reading a leaf runs
    :class:`GatherParam` on its shard (once; later reads reuse the gathered
    tensor), so a model that reads a block's leaves when it enters the block
    gathers one block at a time. A read inside a checkpointed function
    (``activation_checkpointing.in_checkpoint``) gathers every time and
    keeps nothing: the gathered block then dies with the block's forward,
    and the recompute gathers it again."""

    def __init__(self, masters: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                 axis: AxisName, mesh: MeshManager, dtype: torch.dtype,
                 axes: Optional[Dict[str, Optional[AxisName]]] = None):
        self._masters, self._dims = masters, dims
        self._axis, self._mesh, self._dtype = axis, mesh, dtype
        self._axes = axes or {}     # a leaf's own ZeRO axis (an expert bank's replicas)
        self._gathered: Dict[str, torch.Tensor] = {}

    def _gather(self, name: str) -> torch.Tensor:
        m = self._masters[name]
        if not m.is_floating_point():
            return m
        axis = self._axes[name] if name in self._axes else self._axis
        return GatherParam.apply(m, self._dims[name], axis, self._mesh, self._dtype)

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._gathered:
            return self._gathered[name]
        if in_checkpoint():
            return self._gather(name)
        self._gathered[name] = self._gather(name)
        return self._gathered[name]

    def __iter__(self):
        return iter(self._masters)

    def __len__(self) -> int:
        return len(self._masters)
