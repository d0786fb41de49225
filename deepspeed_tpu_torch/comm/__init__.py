"""Collectives by mesh axis name over ``torch.distributed`` — counterpart of
``deepspeed_tpu/comm`` (``comm.py``, ``mesh.py``)."""

from .comm import (all_gather, all_gather_object, all_reduce, all_to_all, axis_index,
                   axis_size, barrier, broadcast, broadcast_host, broadcast_object_list,
                   counts, gather, get_rank, get_world_size, inference_all_reduce,
                   init_distributed, is_initialized, monitored_barrier, ppermute,
                   reduce_scatter, resolve_process_id, ring_shift, scatter, send_recv)
from .mesh import (BATCH_AXES, MESH_AXES, ZERO_AXES, MeshManager, get_mesh, init_mesh,
                   set_mesh)

__all__ = [
    "all_gather", "all_gather_object", "all_reduce", "all_to_all", "axis_index",
    "axis_size", "barrier", "broadcast", "broadcast_host", "broadcast_object_list",
    "counts", "gather", "get_rank", "get_world_size", "inference_all_reduce",
    "init_distributed", "is_initialized", "monitored_barrier", "ppermute",
    "reduce_scatter", "resolve_process_id", "ring_shift", "scatter", "send_recv",
    "BATCH_AXES", "MESH_AXES", "ZERO_AXES", "MeshManager", "get_mesh", "init_mesh",
    "set_mesh",
]
