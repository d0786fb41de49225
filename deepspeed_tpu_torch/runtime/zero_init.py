"""``zero.Init``: build a model already sharded — counterpart of
``deepspeed_tpu/runtime/zero_init.py`` (``materialize_sharded``, ``Init``,
``GatheredParameters``, ``on_device``, ``tp_model_init``).

The JAX package runs the init function under ``jit`` with sharded outputs,
so each device computes only its shard. Here a model's ``init_fn(generator,
keep=...)`` draws its leaves one at a time from a ``torch.Generator``, in
the order the unsharded init draws them, and ``keep`` keeps only this
rank's shard of each: the values equal the unsharded init's bit for bit,
and no rank ever holds more than one whole leaf. (An ``init_fn`` without a
``keep`` argument is drawn whole and then sharded.) The meta-device
construction (the reference's ``OnDevice``) runs the init function under
``FakeTensorMode``: shapes and dtypes, no bytes, no draws.
"""

from __future__ import annotations

import contextlib
import inspect
import math
from typing import Any, Callable, Dict, Optional

import torch

from ..comm import comm
from ..comm.mesh import MeshManager, get_mesh
from ..utils.logging import log_dist
from .partitioning import Partitioner, replicated_axes, shard, shard_dim, unshard_parts

Params = Dict[str, torch.Tensor]


def _takes_keep(init_fn: Callable) -> bool:
    try:
        params = inspect.signature(init_fn).parameters
    except (TypeError, ValueError):
        return False
    return "keep" in params or any(p.kind is p.VAR_KEYWORD for p in params.values())


def draw(init_fn: Callable, generator: torch.Generator,
         keep: Callable[[str, torch.Tensor], torch.Tensor]) -> Params:
    """``init_fn``'s leaves with ``keep`` applied to each as it is drawn."""
    if _takes_keep(init_fn):
        return init_fn(generator, keep=keep)
    return {k: keep(k, v) for k, v in init_fn(generator).items()}


def shard_dims(logical_axes, shapes, mesh_mgr: MeshManager,
               zero_stage: int = 3) -> Dict[str, Optional[int]]:
    """Each leaf's ZeRO-sharded dim (None: replicated) in the stage's
    parameter layout."""
    part = Partitioner(mesh_mgr, zero_stage=zero_stage)
    axes = logical_axes if logical_axes is not None else replicated_axes(shapes)
    return {k: shard_dim(s) for k, s in part.param_specs(axes, shapes).items()}


def materialize_sharded(init_fn: Callable, generator: torch.Generator, logical_axes: Any,
                        *, mesh_mgr: Optional[MeshManager] = None,
                        zero_stage: int = 3) -> Params:
    """This rank's shards of ``init_fn``'s parameters at ZeRO-``zero_stage``
    (sharded at stage 3, whole below it), drawn one leaf at a time."""
    mesh_mgr = mesh_mgr or get_mesh()
    shapes = {k: tuple(t.shape) for k, t in on_device(init_fn, generator).items()}
    dims = shard_dims(logical_axes, shapes, mesh_mgr, zero_stage)
    n, index = mesh_mgr.zero_world_size, mesh_mgr.axis_index("data")

    def keep(name, t):
        return shard(t, dims[name], index, n).clone(memory_format=torch.contiguous_format) \
            if dims[name] is not None else t

    params = draw(init_fn, generator, keep)
    log_dist(f"zero.Init: {sum(math.prod(s) for s in shapes.values()) / 1e6:.1f}M params "
             f"drawn sharded (stage {zero_stage}, {n} shards)")
    return params


class Init(contextlib.AbstractContextManager):
    """The reference ``zero.Init``'s shape; inside the context call
    :meth:`materialize` (construction is an explicit function here)::

        with deepspeed_tpu_torch.zero.Init(config_dict_or_path=cfg) as zi:
            params = zi.materialize(init_fn, generator, logical_axes)
    """

    def __init__(self, config_dict_or_path: Any = None,
                 mesh_mgr: Optional[MeshManager] = None, **kw):
        from .config import parse_config

        stage = 3
        if config_dict_or_path is not None:
            stage = parse_config(config_dict_or_path, resolve_batch=False).zero_config.stage
        self.zero_stage = stage
        self.mesh_mgr = mesh_mgr

    def __exit__(self, *exc):
        return False

    def materialize(self, init_fn, generator, logical_axes) -> Params:
        return materialize_sharded(init_fn, generator, logical_axes,
                                   mesh_mgr=self.mesh_mgr, zero_stage=self.zero_stage)


@contextlib.contextmanager
def GatheredParameters(params: Params, dims: Optional[Dict[str, Optional[int]]] = None,
                       modifier_rank: Optional[int] = None,
                       mesh_mgr: Optional[MeshManager] = None,
                       axes: Optional[Dict[str, Any]] = None):
    """The whole leaves of sharded ``params`` (``dims``: each leaf's sharded
    dim, None or absent for a whole leaf), for the body of the ``with``;
    ``axes``: each leaf's parts' axes (an engine's ``splits``), ``data``
    where absent. With ``modifier_rank``, that rank's edits to the whole
    leaves are broadcast on exit and written back into every rank's shards
    (``data`` splits only)."""
    mesh_mgr = mesh_mgr or get_mesh()
    dims, axes = dims or {}, axes or {}
    full = {k: unshard_parts(p.detach(), dims.get(k), axes.get(k) or ("data",),
                             mesh_mgr).clone()
            for k, p in params.items()}
    yield full
    if modifier_rank is None:
        return
    n, index = mesh_mgr.zero_world_size, mesh_mgr.axis_index("data")
    with torch.no_grad():
        for k, p in params.items():
            t = comm.broadcast(full[k], "data", modifier_rank, mesh=mesh_mgr)
            p.copy_(shard(t, dims.get(k), index, n))


def on_device(init_fn: Callable, generator: torch.Generator) -> Params:
    """The parameters' shapes and dtypes as meta tensors (the reference's
    ``OnDevice(meta)``): the init function runs on fake tensors, so nothing
    is allocated and the generator does not advance."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    state = generator.get_state()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = init_fn(generator)
    generator.set_state(state)
    return {k: torch.empty(t.shape, dtype=t.dtype, device="meta") for k, t in fake.items()}


def tp_model_init(model_spec, tp_size: int, dtype=None, **kw):
    """Reference ``deepspeed.tp_model_init``: tensor parallelism is not
    ported (ROADMAP A.7)."""
    raise NotImplementedError("not yet ported to deepspeed_tpu_torch: tp_model_init "
                              "(tensor parallelism, ROADMAP A.7)")
