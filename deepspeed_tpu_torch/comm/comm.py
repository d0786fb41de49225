"""Collectives by axis name and the process-level helpers — counterpart of
``deepspeed_tpu/comm/comm.py`` (collectives :315-440, process level
:451-580).

In the JAX package a collective is a traced op over a mesh axis inside
``shard_map``: it takes the member's local shard and returns its result.
Here each function takes this rank's local tensor and runs the same
collective over the axis's process group (:meth:`MeshManager.group`),
returning what JAX returns to that member; ``mesh`` defaults to the
installed mesh (:func:`~.mesh.get_mesh`). The input is never written. Over
an axis with no process group behind it (a single process that never
called :func:`init_distributed`) a collective returns its input unchanged,
as a collective over a one-member axis does. A one-rank process group (a
single GPU) still runs every collective through the backend.

Every collective that runs adds one to :data:`counts` under its op, with
its input's bytes, so a caller can read what a step moved. The JAX
package's ``CommsTelemetry`` and comms logger are not ported (ROADMAP
A.13), nor are ``compressed.py`` and ``overlap.py`` (A.9).
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.logging import log_dist
from .mesh import AxisName, MeshManager, get_mesh


class CollectiveCounts:
    """Collectives run and their input bytes, by op name."""

    def __init__(self):
        self.ops: Dict[str, Dict[str, int]] = {}

    def add(self, op: str, x: torch.Tensor) -> None:
        rec = self.ops.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += x.numel() * x.element_size()

    def reset(self) -> None:
        self.ops.clear()

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {op: dict(rec) for op, rec in sorted(self.ops.items())}


counts = CollectiveCounts()


def _group(axis: AxisName, mesh: Optional[MeshManager]):
    mesh = mesh or get_mesh()
    return mesh, mesh.group(axis)


def _global(group, index: int) -> int:
    return dist.get_global_rank(group, index)


# the fused collectives under their newer names where torch has them
_all_gather_base = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM,
               "avg": dist.ReduceOp.SUM}


# --------------------------------------------------------------------------- #
# collectives over named axes
# --------------------------------------------------------------------------- #
def all_reduce(x: torch.Tensor, axis: AxisName, op: str = "sum", *,
               mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """psum / pmax / pmin / pmean over ``axis`` (reference ``dist.all_reduce``)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    mesh, group = _group(axis, mesh)
    if group is None:
        return x
    counts.add(f"all_reduce_{op}", x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
    if op in ("mean", "avg"):
        out /= mesh.axis_size(axis)
    return out


def all_gather(x: torch.Tensor, axis: AxisName, *, tiled: bool = True,
               gather_axis: int = 0, mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """Members' tensors along ``gather_axis``: concatenated (``tiled``) or
    stacked in a new dim there (reference ``dist.all_gather_into_tensor``)."""
    mesh, group = _group(axis, mesh)
    if group is None:
        return x if tiled else x.unsqueeze(gather_axis)
    counts.add("all_gather", x)
    n = mesh.axis_size(axis)
    src = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _all_gather_base(out.flatten(0, 1) if src.dim() else out, src, group=group)
    out = out.movedim(0, gather_axis)
    if not tiled:
        return out.contiguous()
    shape = list(x.shape)
    shape[gather_axis] *= n
    return out.reshape(shape)


def reduce_scatter(x: torch.Tensor, axis: AxisName, *, scatter_axis: int = 0,
                   op: str = "sum", mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """Sum over the members, then member i keeps the i-th of equal chunks
    along ``scatter_axis`` (reference ``dist.reduce_scatter_tensor``)."""
    if op != "sum":
        raise ValueError(f"unsupported reduce op {op}")
    mesh, group = _group(axis, mesh)
    if group is None:
        return x
    counts.add("reduce_scatter", x)
    n = mesh.axis_size(axis)
    src = x.movedim(scatter_axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {scatter_axis} of size {src.shape[0]} does not split over {n}")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter_base(out, src, group=group)
    return out.movedim(0, scatter_axis).contiguous()


def all_to_all(x: torch.Tensor, axis: AxisName, *, split_axis: int, concat_axis: int,
               mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """Chunk j of ``split_axis`` goes to member j; the chunks received are
    concatenated along ``concat_axis`` in member order (Ulysses: seq → head
    is ``split_axis=1, concat_axis=0`` on ``[seq, heads, ...]``, the
    inverse swaps them)."""
    mesh, group = _group(axis, mesh)
    if group is None:
        return x
    counts.add("all_to_all", x)
    n = mesh.axis_size(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} does not split over {n}")
    sends = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
    recvs = [torch.empty_like(sends[0]) for _ in range(n)]
    dist.all_to_all(recvs, sends, group=group)
    return torch.cat(recvs, dim=concat_axis)


def ppermute(x: torch.Tensor, axis: AxisName, perm: Sequence[Tuple[int, int]], *,
             mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """Member ``dst`` receives member ``src``'s tensor for every ``(src,
    dst)`` pair; a member no pair sends to gets zeros (the reference's
    pipeline send / recv pairs). With NCCL, the first point-to-point call in
    a group must involve every rank of it."""
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {perm} sends from or to a member twice")
    mesh, group = _group(axis, mesh)
    if group is None:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    counts.add("ppermute", x)
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    src = x.contiguous()
    for s, d in perm:
        if s == me and d == me:
            out = x.clone()
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, _global(group, d), group))
        elif d == me:
            out = torch.empty_like(src)
            ops.append(dist.P2POp(dist.irecv, out, _global(group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ring_shift(x: torch.Tensor, axis: str, axis_size: int, shift: int = 1, *,
               mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """Shift members' tensors around the ring by ``shift``."""
    return ppermute(x, axis, [(i, (i + shift) % axis_size) for i in range(axis_size)],
                    mesh=mesh)


def broadcast(x: torch.Tensor, axis: AxisName, src_index: int = 0, *,
              mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """Member ``src_index``'s tensor, on every member."""
    mesh, group = _group(axis, mesh)
    if group is None:
        return x
    counts.add("broadcast", x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=_global(group, src_index), group=group)
    return out


def send_recv(x: torch.Tensor, axis: AxisName, src: int, dst: int, *,
              mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """One transfer: ``dst`` receives ``src``'s tensor, every other member
    zeros (reference ``dist.send`` / ``recv``)."""
    return ppermute(x, axis, [(src, dst)], mesh=mesh)


def gather(x: torch.Tensor, axis: AxisName, dst: int = 0, *,
           mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """``[n, *x.shape]``: every member's tensor on ``dst``, zeros on the
    others (reference ``dist.gather``)."""
    mesh, group = _group(axis, mesh)
    if group is None:
        return x.unsqueeze(0)
    counts.add("gather", x)
    n = mesh.axis_size(axis)
    bufs = [torch.zeros_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    me = dist.get_rank(group)
    dist.gather(x.contiguous(), bufs if me == dst else None, dst=_global(group, dst),
                group=group)
    return torch.stack(bufs)


def scatter(x: torch.Tensor, axis: AxisName, src: int = 0, *,
            mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """Member i receives ``x[i]`` of member ``src``'s ``x`` (``[n, ...]``;
    reference ``dist.scatter``)."""
    mesh, group = _group(axis, mesh)
    if group is None:
        return x[0]
    counts.add("scatter", x)
    out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    me = dist.get_rank(group)
    dist.scatter(out, [c.contiguous() for c in x.unbind(0)] if me == src else None,
                 src=_global(group, src), group=group)
    return out


def inference_all_reduce(x: torch.Tensor, axis: AxisName = "tensor", *,
                         mesh: Optional[MeshManager] = None) -> torch.Tensor:
    """The tensor-parallel forward's sum (reference
    ``dist.inference_all_reduce``): the same wire op as ``all_reduce``, its
    own name in :data:`counts`."""
    mesh, group = _group(axis, mesh)
    if group is None:
        return x
    counts.add("inference_all_reduce", x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def axis_index(axis: AxisName, *, mesh: Optional[MeshManager] = None) -> int:
    return (mesh or get_mesh()).axis_index(axis)


def axis_size(axis: AxisName, *, mesh: Optional[MeshManager] = None) -> int:
    return (mesh or get_mesh()).axis_size(axis)


def monitored_barrier(name: str = "dstpu_barrier", timeout: Optional[float] = None) -> float:
    """A barrier that raises within ``timeout`` seconds when it does not
    complete (a dead or straggling rank) instead of hanging; returns the
    seconds it took."""
    t0 = time.perf_counter()
    if timeout is None:
        barrier(name)
        return time.perf_counter() - t0
    err: List[BaseException] = []
    done = threading.Event()

    def run():
        try:
            barrier(name)
        except Exception as e:  # surfaced below
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=run, daemon=True, name=f"barrier:{name}").start()
    if not done.wait(timeout):
        raise RuntimeError(f"monitored_barrier '{name}' timed out after "
                           f"{timeout}s — straggler or dead process")
    if err:
        raise err[0]
    return time.perf_counter() - t0


# --------------------------------------------------------------------------- #
# process level
# --------------------------------------------------------------------------- #
def resolve_process_id() -> int:
    """This process's rank: ``DSTPU_PROCESS_ID``; else the variable that
    ``DSTPU_RANK_ENV`` names (the MPI launchers' ``OMPI_COMM_WORLD_RANK``,
    ``PMI_RANK``, ...); else torchrun's ``RANK``; else ``SLURM_PROCID``;
    else 0."""
    pid = os.environ.get("DSTPU_PROCESS_ID")
    if pid is None and (rank_env := os.environ.get("DSTPU_RANK_ENV")):
        pid = os.environ.get(rank_env)
    if pid is None:
        pid = os.environ.get("RANK", os.environ.get("SLURM_PROCID", 0))
    return int(pid)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(dist_backend: str = "nccl",
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: Optional[float] = None, **kwargs) -> None:
    """Create the default process group (reference ``comm.init_distributed``).

    The rendezvous is ``coordinator_address`` or ``DSTPU_COORDINATOR``
    (``host:port``, or a ``file://`` path that the ranks of one host share
    and no other job uses), else torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``; the
    world size ``num_processes``, ``DSTPU_NUM_PROCESSES`` or ``WORLD_SIZE``
    (1 by default, on a free local port); the rank :func:`resolve_process_id`.
    The backend is NCCL, with this rank on ``cuda:LOCAL_RANK`` (or the rank
    modulo the GPUs); it raises without a GPU. ``dist_backend="gloo"`` runs
    on the CPU, and only when asked for. ``timeout`` bounds each collective,
    in seconds. A second call does nothing."""
    if dist.is_initialized():
        return
    backend = dist_backend.lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be 'nccl' or 'gloo', got {dist_backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: the NCCL backend needs a CUDA GPU and none "
                           "is available; pass dist_backend='gloo' to run on the CPU")
    env = os.environ
    world = int(num_processes or env.get("DSTPU_NUM_PROCESSES") or env.get("WORLD_SIZE") or 1)
    rank = resolve_process_id() if process_id is None else int(process_id)
    coordinator = coordinator_address or env.get("DSTPU_COORDINATOR")
    if coordinator:
        init_method = coordinator if coordinator.startswith("file://") else f"tcp://{coordinator}"
    elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"
    elif world == 1:
        init_method = f"tcp://localhost:{_free_port()}"
    else:
        raise ValueError(f"world size {world} needs a rendezvous: set DSTPU_COORDINATOR "
                         "or torchrun's MASTER_ADDR / MASTER_PORT")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if backend == "nccl":
        # the rank's own GPU, named to NCCL: its guess from the global rank
        # is wrong on every host but the first
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, **kw)
    log_dist(f"init_distributed: {backend}, rank {rank} of {world}")


def is_initialized() -> bool:
    return dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str = "dstpu_barrier") -> None:
    """Host-level barrier over every rank (reference ``dist.barrier``)."""
    if dist.is_initialized():
        dist.barrier()


def all_gather_object(obj) -> list:
    """One picklable object per rank, as a list in rank order (reference
    ``dist.all_gather_object``)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object_list(object_list: list, src: int = 0) -> list:
    """``src``'s list of picklable objects, in place on every rank."""
    if dist.is_initialized():
        dist.broadcast_object_list(object_list, src=src)
    return object_list


def broadcast_host(value, src: int = 0):
    """Host data from rank ``src`` on every rank (checkpoint tags etc.)."""
    return broadcast_object_list([value], src=src)[0]
