"""Training engine, data parallel with ZeRO stages 0-3 — counterpart of
``deepspeed_tpu/runtime/engine.py`` (``ModelSpec`` :56, ``TrainState`` :89,
``StepOutput`` :105, ``_cast_gather`` :1020, ``_loss`` :1134,
``_grads_one_micro`` :1143, ``_accumulate`` :1258, ``_apply_update``
:1604, ``_shard_batch`` :1790, ``train_batch`` :1838,
``forward``/``backward``/``step`` :1906-1983, the accessors :898-993,
``eval_batch`` :2014, ``compile`` :2035, ``no_sync`` :2071, the checkpoint
methods :2093-2123, ``destroy`` :2140, ``initialize`` :2170).

Same step semantics as the JAX engine:

- fp32 master params; each micro-batch casts them to the compute dtype
  (bf16/fp16/fp32), and grads reach the masters in fp32;
- a global batch ``[gas * micro * dp, ...]`` is split into ``gas``
  micro-batches, and rank r of the ``data`` axis takes its ``micro`` rows
  of each (JAX ``BATCH_AXES`` order: micro-batch first, then rank); grads
  and losses are the mean over micro-batches;
- the update: overflow check on the (scaled) grads, unscale, global-norm
  clip ``min(1, clip / (norm + 1e-6))``, ``lr_scale = lr_t / base_lr`` with
  ``lr_t`` the schedule at ``state.step``, the optimizer step, and on
  overflow a skip that leaves params, optimizer state and step untouched
  while the fp16 scaler backs off.

ZeRO over the ``data`` axis (JAX ``runtime/partitioning.py:1-23``; the
sharded dim of each leaf from ``runtime/partitioning.py``):

- stage 0: masters, AdamW moments and grads replicated; grads all-reduced
  at the GAS boundary;
- stage 1: masters and moments sharded; each micro-batch casts the shard
  to the compute dtype and all-gathers that copy (JAX ``_cast_gather``);
  grads accumulate whole on each rank and are all-reduced at the boundary,
  where each rank keeps its shard and updates it;
- stage 2: as stage 1, but each micro-batch's grads are reduce-scattered
  into a sharded fp32 accumulator;
- stage 3: parameters sharded at rest; a leaf is all-gathered (compute
  dtype) when the model first reads it in a micro-batch, through
  ``partitioning.GatherParam``, whose backward reduce-scatters the grad into
  the fp32 shard's grad, reducing in fp32. Llama reads a block's leaves when
  it enters the block. The gathered blocks stay alive for the backward,
  except under a family's ``remat``, where a block reads its leaves inside
  the checkpointed function: the gather is not kept, and the recompute
  gathers the block again.

The optimizer updates the shards in place. An elementwise one (AdamW,
Lion, Adagrad, SGD) needs nothing more; LAMB, Muon and the 1-bit
optimizers reduce over a whole JAX leaf, and take their reductions over
the layers and the data axis through the engine's ``layout``
(``ops/optimizers.py`` :class:`Layout`, built from the family's
``models/convert.py`` table and ``shard_dims``). ``optimizer.param_groups``
builds a grouped optimizer whose patterns match the JAX paths.

The reported loss, ``grad_norm``, overflow flag and aux are the global
ones: the JAX loss is the token mean over the global micro-batch, so when
``loss_fn`` returns ``aux["ntokens"]`` (every model family here but GPT,
whose loss counts every token) the counts are all-reduced after the forward
and each rank's loss is weighted by ``n_r / N`` before the backward, which
gives JAX's grads also when ranks hold different numbers of valid tokens;
without it each rank's loss is weighted ``1 / world``, so the result is
the mean of the rank means. Float aux values are reduced with the same
weights, integer ones summed.

A single process that never called ``comm.init_distributed`` has a
one-member ``data`` axis and no process group: every stage then runs with
whole leaves and no collective, the arithmetic of the stage-0 step. With a
process group, even of one rank, every stage shards over ``data`` and runs
its collectives through the backend.

PyTorch runs eagerly, so the step is Python over autograd rather than one
compiled program. The overflow check reads one boolean back to the host per
step. :meth:`DeepSpeedTPUEngine.compile` builds every CUDA kernel the step
launches, so the first ``train_batch`` pays no build.

Checkpoints (``runtime/checkpoint/``): :meth:`save_checkpoint` /
:meth:`load_checkpoint` write and read the port's regular format (any world
size and ZeRO stage loads any other), :meth:`save_universal_checkpoint` /
:meth:`load_universal_checkpoint` the fragments the JAX package reads too;
``checkpoint.engine`` is ``default``, ``fast`` or ``async``. Loads copy into
the engine's tensors in place.

Expert parallelism (JAX ``runtime/engine.py:2215-2250``): the mesh takes
``moe.expert_parallel_size`` as its ``expert`` axis when ``mesh`` is not
given, and the batch splits over ``data`` and ``expert``. A MoE bank
(``expert`` logical dim) is split over ``expert`` at every stage, each
rank holding its own experts, and ZeRO splits it further over its replicas
where it divides (``runtime/partitioning.py`` :class:`Split`). Its
gradient reduces over the replica axes only; every other leaf's over
``data`` and ``expert``. The MoE layer exchanges the dispatched tokens by
``all_to_all`` over ``expert`` (``moe/layer.py``).

Not ported yet (their config blocks raise at :func:`initialize`, see
``runtime/config.py``): the tensor, pipe and seq axes, MiCS / hpZ,
offload and tiered memory, quantized ZeRO collectives, comms overlap,
telemetry, tuning, watchdog, integrity, curriculum.

``activation_checkpointing`` sets the default policy of
``activation_checkpointing.checkpoint()``; ``sequence.tiled_loss`` routes
the loss through the model's ``tiled_loss_fn``.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..comm import comm
from ..comm.mesh import BATCH_AXES, ZERO_AXES, MeshManager, get_mesh, init_mesh
from ..models.convert import jax_leaf
from ..ops.flash_attention import HEAD_DIMS
from ..ops.optimizers import Layout, Optimizer, get_optimizer, grouped_optimizer
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .config import DeepSpeedTPUConfig, check_ported, parse_config
from .dataloader import DeepSpeedTPUDataLoader
from .lr_schedules import LRScheduler, Schedule, constant, get_schedule
from .partitioning import (GatherOnUse, Partitioner, Split, leaf_split, replicated_axes,
                           shard, unshard)
from .precision import (LossScaleState, PrecisionPolicy, grads_finite,
                        make_loss_scaler, scale_loss, update_loss_scale)
from .utils import clip_grad_norm_, global_norm
from .zero_init import draw, on_device

Params = Dict[str, torch.Tensor]


@dataclass
class ModelSpec:
    """What the engine needs from a user model: a loss function over a flat
    mapping of params, and the params themselves or a function that draws
    them from a ``torch.Generator`` (taking ``keep=`` to shard them as they
    are drawn, see ``runtime/zero_init.py``)."""

    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
    init_fn: Optional[Callable[..., Params]] = None
    params: Optional[Params] = None
    name: str = "model"
    # the dtype loss_fn computes in (None: not stated); initialize refuses
    # one that no CUDA kernel takes (check_compute_dtype)
    compute_dtype: Optional[torch.dtype] = None
    # leaf name -> partitioning.LeafAxes (None: ZeRO shards each leaf's
    # largest divisible dim)
    logical_axes: Optional[Dict[str, Any]] = None
    # the family's config (LlamaConfig, GPTConfig, BloomConfig): universal
    # checkpoints then write the JAX tree's names and layout
    config: Optional[Any] = None
    # optional fused unembedding + cross-entropy: (params, batch, *, shards)
    # -> (loss, aux), never holding the [B, S, V] logits; the loss when
    # config.sequence.tiled_loss is on (sequence/tiled.py)
    tiled_loss_fn: Optional[Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]] = None


class TrainState(NamedTuple):
    step: int                  # optimizer steps taken (skipped ones excluded)
    params: Params             # fp32 masters: this rank's shards from stage 1
    opt_state: Any
    loss_scale: LossScaleState
    skipped_steps: int


class StepOutput(NamedTuple):
    loss: torch.Tensor         # 0-d fp32, mean over micro-batches
    grad_norm: torch.Tensor    # 0-d fp32, after unscaling, before clipping
    lr: float
    loss_scale: torch.Tensor
    overflow: bool
    aux: Dict[str, Any]


class DeepSpeedTPUEngine:
    """The engine (the JAX package's class name, so a reader finds its
    counterpart). Construct through :func:`initialize`."""

    def __init__(self, model: ModelSpec, config: DeepSpeedTPUConfig,
                 device: torch.device, optimizer: Optional[Optimizer] = None,
                 lr_schedule: Optional[Schedule] = None,
                 training_data=None, generator: Optional[torch.Generator] = None,
                 mesh_mgr: Optional[MeshManager] = None):
        self.model = model
        self.config = config
        self.device = device
        self.global_steps = 0
        self.micro_steps = 0       # micro-batches through backward() (JAX counts the same)
        self.global_tokens = 0     # token count of every batch through train_batch
        self.training_dataloader = None
        self.checkpoint_engine = None   # built at the first save or load
        self.reliability_counts: Dict[str, int] = {}   # "Reliability/<event>" -> count
        self._last_grad_norm = 0.0
        self._is_compiled = False
        self.precision = PrecisionPolicy.from_config(config)
        self.mesh_mgr = mesh_mgr or MeshManager.from_sizes({"data": 1})
        self.zero_stage = config.zero_config.stage

        # a config with param_groups builds its optimizer once the masters
        # exist (the groups match leaf paths); a passed optimizer wins, with
        # the JAX engine's warning (JAX runtime/engine.py:163-197)
        groups = config.optimizer.param_groups
        if optimizer is not None and groups:
            logger.warning("optimizer.param_groups in the config are IGNORED because an "
                           "optimizer object was passed to initialize()")
        self._grouped_ctor = None
        if optimizer is None and not groups:
            optimizer = get_optimizer(config.optimizer.type or "adamw",
                                      **config.optimizer.params)

        if generator is None:
            generator = torch.Generator(device=device).manual_seed(config.seed)
        params = self._init_masters(model, generator)
        paths = ({k: jax_leaf(k)[0] for k in params} if model.config is not None else None)
        if optimizer is None:
            self._grouped_ctor = (config.optimizer.type or "adamw", [dict(g) for g in groups],
                                  dict(config.optimizer.params), paths)
            optimizer = grouped_optimizer(config.optimizer.type or "adamw", params, groups,
                                          leaf_paths=paths, **config.optimizer.params)
        self.optimizer = optimizer
        self.layout = Layout.for_model(model.config, params, self.shard_dims,
                                       self._axis, self.mesh_mgr,
                                       axes={k: s.axes for k, s in self.splits.items()})
        self.base_lr = float(optimizer.hyperparams.get("lr", 1.0)) or 1.0
        if lr_schedule is None:
            lr_schedule = get_schedule(config.scheduler.type,
                                       config.scheduler.params,
                                       base_lr=self.base_lr)
        self.lr_schedule = lr_schedule
        self.lr_scheduler = LRScheduler(lr_schedule)
        self.state = TrainState(
            step=0, params=params, opt_state=optimizer.init(params),
            loss_scale=make_loss_scaler(config.fp16, device), skipped_steps=0)
        self._grad_acc: Params = {}    # stage 1: whole fp32 grads until the boundary
        self._staged: List[Tuple[torch.Tensor, Dict[str, Any], Any]] = []

        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
        # the config's remat policy becomes the process-wide default of
        # activation_checkpointing.checkpoint() (JAX :492-499); a family's
        # blocks are rematerialized by its own cfg.remat alone
        ac = config.activation_checkpointing
        if ac.policy != "none" or ac.cpu_checkpointing:
            from .activation_checkpointing import checkpointing as _ac

            _ac.configure(deepspeed_config=config)
        if config.sequence.tiled_loss:
            if model.tiled_loss_fn is None:
                log_dist("sequence.tiled_loss: ON but the model spec has no "
                         "tiled_loss_fn — using the dense loss_fn")
            else:
                log_dist("sequence.tiled_loss: fused unembedding + CE "
                         f"(shards={config.sequence.tiled_loss_shards})")
        log_dist(f"engine ready: device={device} zero_stage={self.zero_stage} "
                 f"dp={self.dp_world_size()} dtype={config.compute_dtype} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()} "
                 f"sharded leaves={len(self._sharded)}/{len(params)}")

    def _init_masters(self, model: ModelSpec, generator: torch.Generator) -> Params:
        """fp32 masters, this rank's shards of them from stage 1, drawn a leaf
        at a time when the model has an ``init_fn``; also sets each master
        leaf's sharded dim (``shard_dims``, None: whole)."""
        mm = self.mesh_mgr
        if model.params is not None:
            shapes = {k: tuple(torch.as_tensor(p).shape) for k, p in model.params.items()}
        elif model.init_fn is not None:
            shapes = {k: tuple(t.shape) for k, t in on_device(model.init_fn, generator).items()}
        else:
            raise ValueError("ModelSpec needs params or init_fn")
        axes = model.logical_axes or replicated_axes(shapes)
        # with a process group, even of one rank, the stage shards over
        # 'data' and runs its collectives; the masters' layout (sharded from
        # stage 1) is also the grads' and, at stage 3, the params'
        part = Partitioner(mm, self.zero_stage, keep_trivial=mm.device_mesh is not None)
        self._axis = tuple(a for a in ZERO_AXES if mm.axis_size(a) > 1) or ("data",)
        ep = mm.axis_size("expert")
        self.splits: Dict[str, Split] = {
            k: leaf_split(s, axes[k], self._axis, ep)
            for k, s in part.opt_state_specs(axes, shapes).items()}
        self.shard_dims = {k: s.dim for k, s in self.splits.items()}
        self._sharded = frozenset(k for k, d in self.shard_dims.items() if d is not None)
        self._expert_parallel = ep > 1
        # the leaves this rank counts in the grad norm: its parts of split
        # leaves, once across their replicas (a whole leaf: rank 0's)
        self._counted = frozenset(
            k for k, s in self.splits.items() if s.dim is not None and all(
                mm.axis_index(a) == 0 for a in self._axis if a not in s.axes))
        own = model.params is None   # drawn here: no caller holds these tensors

        def keep(name: str, p) -> torch.Tensor:
            p = torch.as_tensor(p).detach()
            if not p.is_floating_point():
                return p.to(self.device)
            dim, n, index = self.part_of(name)
            # a shard of a drawn leaf is copied, so the whole leaf is freed
            p = shard(p, dim, index, n).to(device=self.device, dtype=self.precision.param_dtype,
                                           copy=not own or dim is not None,
                                           memory_format=torch.contiguous_format)
            return p.requires_grad_()

        if own:
            return draw(model.init_fn, generator, keep)
        return {k: keep(k, p) for k, p in model.params.items()}

    def part_of(self, name: str) -> Tuple[Optional[int], int, int]:
        """(split dim, number of parts, this rank's part) of master ``name``."""
        s, mm = self.splits[name], self.mesh_mgr
        if s.dim is None:
            return None, 1, 0
        return s.dim, mm.axis_size(s.axes), mm.axis_index(s.axes)

    # ------------------------------------------------------------------ #
    # reference accessors
    # ------------------------------------------------------------------ #
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def zero_optimization(self) -> bool:
        return self.zero_stage > 0

    def dp_world_size(self) -> int:
        return self.mesh_mgr.dp_world_size

    @property
    def loss_scale(self) -> float:
        return float(self.state.loss_scale.scale)

    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(self.global_steps))]

    def get_global_grad_norm(self) -> float:
        """The grad norm of the last optimizer step (after unscaling, before
        clipping); 0.0 before the first."""
        return float(self._last_grad_norm)

    def get_batch_info(self) -> Tuple[int, int, int]:
        """(train_batch_size, micro_batch_per_gpu, gradient_accumulation)."""
        return (self.train_batch_size(), self.train_micro_batch_size_per_gpu(),
                self.gradient_accumulation_steps())

    @property
    def global_samples(self) -> int:
        return self.global_steps * self.train_batch_size()

    def bfloat16_enabled(self) -> bool:
        return self.config.bf16.enabled

    def fp16_enabled(self) -> bool:
        return self.config.fp16.enabled

    def gradient_clipping_value(self) -> float:
        return float(self.config.gradient_clipping or 0.0)

    def steps_per_print(self) -> int:
        return self.config.steps_per_print

    def wall_clock_breakdown(self) -> bool:
        return bool(self.config.wall_clock_breakdown)

    @property
    def module(self) -> ModelSpec:
        """The user model (the reference returns the wrapped nn.Module)."""
        return self.model

    def set_lr(self, lr: float) -> None:
        """Pin the LR to a constant from the next step on. ``base_lr`` stays
        the optimizer's: the step scales the optimizer's own lr by
        ``schedule(t) / base_lr``, so resetting it here would cancel the
        scale and keep the old rate."""
        self.lr_schedule = constant(float(lr))
        self.lr_scheduler = LRScheduler(self.lr_schedule)
        if self._grouped_ctor is not None:
            # per-group lrs become one: the grouped optimizer is rebuilt with
            # every group pinned to lr (JAX :955-980); its state carries over
            name, groups, kwargs, paths = self._grouped_ctor
            groups = [{k: v for k, v in g.items() if k != "lr"} for g in groups]
            self.optimizer = grouped_optimizer(name, self.state.params, groups,
                                               leaf_paths=paths, **{**kwargs, "lr": float(lr)})
            self.base_lr = float(lr) or 1.0

    def get_mom(self) -> List[float]:
        b = self.optimizer.hyperparams.get("betas", (0.9, 0.999))
        return [float(b[0] if isinstance(b, (tuple, list)) else b)]

    def mp_world_size(self) -> int:
        return self.mesh_mgr.tp_world_size

    def grad_accumulator(self) -> Params:
        """The fp32 tensors this rank accumulates micro-batch grads in until
        the GAS boundary: whole leaves at stages 0 and 1, shards at 2 and 3."""
        if self.zero_stage == 1:
            return dict(self._grad_acc)
        return {k: p.grad for k, p in self.state.params.items() if p.grad is not None}

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                .to(self.device) for k, v in batch.items()}

    def _rank_rows(self, micro: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global micro-batch (JAX ``_shard_batch``)."""
        dp = self.mesh_mgr.dp_world_size
        if dp == 1:
            return micro
        b = next(iter(micro.values())).shape[0]
        if b % dp:
            raise ValueError(f"micro-batch dim {b} not divisible by dp={dp}")
        r, m = self.mesh_mgr.axis_index(BATCH_AXES), b // dp
        return {k: v[r * m:(r + 1) * m] for k, v in micro.items()}

    def _compute_params(self):
        """The compute-dtype params the model reads in one micro-batch."""
        params, dtype = self.state.params, self.precision.compute_dtype
        if self.zero_stage == 0:
            return self.precision.cast_to_compute(params)
        sp = self.splits
        if self.zero_stage == 3:
            return GatherOnUse(params, {k: s.zero_dim for k, s in sp.items()}, self._axis,
                               self.mesh_mgr, dtype, axes={k: s.zero_axis for k, s in sp.items()})
        with torch.no_grad():   # stages 1-2: whole leaves whose grads _reduce_micro takes
            return {k: unshard(p.to(dtype), sp[k].zero_dim, sp[k].zero_axis, self.mesh_mgr)
                    .detach().requires_grad_() if p.is_floating_point() else p
                    for k, p in params.items()}

    def _rank_weight(self, aux: Dict[str, Any]):
        """This rank's weight in the global micro-batch loss: ``n_r / N``
        with the valid-token counts of ``aux["ntokens"]``, else ``1 / dp``."""
        n = aux.get("ntokens") if isinstance(aux, dict) else None
        if n is None:
            return 1.0 / self.mesh_mgr.dp_world_size
        n = torch.as_tensor(n, device=self.device)
        total = comm.all_reduce(n.to(torch.int64), self._axis, mesh=self.mesh_mgr)
        return n.float() / total.clamp(min=1).float()

    def _raw_loss(self, compute, batch):
        """The model's loss on the compute params: through ``tiled_loss_fn``
        when ``sequence.tiled_loss`` is on and the model has one (JAX
        ``_raw_loss``), else ``loss_fn``."""
        seq = self.config.sequence
        if seq.tiled_loss and self.model.tiled_loss_fn is not None:
            return self.model.tiled_loss_fn(compute, batch, shards=seq.tiled_loss_shards)
        return self.model.loss_fn(compute, batch)

    def _grads_one_micro(self, batch: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
        """Forward and backward of this rank's rows of one micro-batch: the
        grads of the scaled, weighted loss ADD into the stage's accumulator.
        Returns (this rank's weighted loss, its aux, its weight)."""
        compute = self._compute_params()
        out = self._raw_loss(compute, batch)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        weight = self._rank_weight(aux)
        loss = loss.float() * weight
        scale_loss(loss, self.state.loss_scale).backward()
        if self.zero_stage in (1, 2):
            self._reduce_micro(compute)
        return loss.detach(), aux, weight

    def _reduce_micro(self, compute: Params) -> None:
        """Stages 1-2: move the whole compute leaves' grads, in fp32, into the
        accumulator: whole (stage 1) or reduce-scattered (stage 2)."""
        masters = self.state.params
        for k, c in compute.items():
            if not c.is_floating_point() or c.grad is None:
                continue
            g = c.grad.float()
            if self.zero_stage == 1:
                acc = self._grad_acc.get(k)
                self._grad_acc[k] = g if acc is None else acc.add_(g)
                continue
            s = self.splits[k]
            if s.zero_axis is not None:
                g = (comm.all_reduce(g, s.zero_axis, mesh=self.mesh_mgr) if s.zero_dim is None
                     else comm.reduce_scatter(g, s.zero_axis, scatter_axis=s.zero_dim,
                                              mesh=self.mesh_mgr))
            m = masters[k]
            m.grad = g if m.grad is None else m.grad.add_(g)

    def _reduce_boundary(self) -> None:
        """At the GAS boundary: stage 0 all-reduces the whole grads, stage 1
        all-reduces its accumulator and keeps this rank's shard of it."""
        masters, mm = self.state.params, self.mesh_mgr
        if self.zero_stage == 0:
            for k, p in masters.items():
                axis = self.splits[k].zero_axis
                if p.grad is not None and axis is not None:
                    p.grad = comm.all_reduce(p.grad, axis, mesh=mm)
        elif self.zero_stage == 1:
            for k, acc in self._grad_acc.items():
                s = self.splits[k]
                if s.zero_axis is not None:
                    acc = comm.all_reduce(acc, s.zero_axis, mesh=mm)
                    acc = shard(acc, s.zero_dim, mm.axis_index(s.zero_axis),
                                mm.axis_size(s.zero_axis))
                masters[k].grad = acc
            self._grad_acc = {}

    def _zero_grads(self) -> None:
        for p in self.state.params.values():
            p.grad = None
        self._grad_acc = {}

    def _grads(self) -> Params:
        params = self.state.params
        return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                for k, p in params.items() if p.requires_grad}

    def _global_loss(self, losses: List[torch.Tensor]) -> torch.Tensor:
        """Mean over micro-batches of the ranks' weighted losses summed."""
        return comm.all_reduce(torch.stack(losses), self._axis, mesh=self.mesh_mgr).mean()

    def _reduce_aux(self, auxes: List[Dict[str, Any]], weights: List[Any]) -> Dict[str, Any]:
        """Aux over ranks (floats weighted as the loss, counts summed), then
        over micro-batches (floats the mean, counts the sum), as the JAX
        engine reduces its aux."""
        if not auxes or not auxes[0]:
            return {}
        w = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=self.device)
                         for x in weights])
        out = {}
        for k in auxes[0]:
            vals = torch.stack([torch.as_tensor(a[k]) for a in auxes]).to(self.device)
            if vals.is_floating_point():
                vals = vals.float() * w.reshape((-1,) + (1,) * (vals.dim() - 1))
                out[k] = comm.all_reduce(vals, self._axis, mesh=self.mesh_mgr).mean()
            else:
                out[k] = comm.all_reduce(vals, self._axis, mesh=self.mesh_mgr).sum()
        return out

    def _apply_update(self, grads: Params, loss: torch.Tensor,
                      aux: Optional[Dict[str, Any]] = None) -> StepOutput:
        """JAX ``_apply_update``: grads are the mean micro-batch grads of the
        scaled loss (this rank's shards from stage 1), modified in place."""
        cfg, state = self.config, self.state
        # from stage 1 (and with expert parallelism, at every stage) each rank
        # holds parts: flag and norm are agreed over the batch axes
        axis = self._axis if self.zero_stage >= 1 or self._expert_parallel else None
        mm, sharded = self.mesh_mgr, self._counted
        finite = bool(grads_finite(grads.values(), axis, mm))
        inv = 1.0 / state.loss_scale.scale
        with torch.no_grad():
            for g in grads.values():
                g.mul_(inv)
            if cfg.gradient_clipping and cfg.gradient_clipping > 0:
                grads, grad_norm = clip_grad_norm_(grads, cfg.gradient_clipping,
                                                   sharded=sharded, axis=axis, mesh=mm)
            else:
                grad_norm = global_norm(grads, sharded, axis, mm)
        lr_t = float(self.lr_schedule(state.step))
        lr_scale = lr_t / self.base_lr
        params, opt_state = state.params, state.opt_state
        if finite:
            params, opt_state = self.optimizer.update(params, grads, opt_state,
                                                      lr_scale=lr_scale, **self._layout_kw())
        new_scale = update_loss_scale(state.loss_scale, torch.tensor(finite))
        self.state = TrainState(step=state.step + int(finite), params=params,
                                opt_state=opt_state, loss_scale=new_scale,
                                skipped_steps=state.skipped_steps + int(not finite))
        self._zero_grads()
        return StepOutput(loss=loss, grad_norm=grad_norm, lr=lr_t,
                          loss_scale=new_scale.scale, overflow=not finite,
                          aux={} if aux is None else aux)

    def _layout_kw(self) -> Dict[str, Any]:
        """``layout=`` for an optimizer whose update takes it (every one of
        ``ops/optimizers.py``; a caller's own may not)."""
        params = inspect.signature(self.optimizer.update).parameters
        return {"layout": self.layout} if "layout" in params else {}

    def _split_micro(self, batch) -> List[Dict[str, torch.Tensor]]:
        """This rank's rows of each of the ``gas`` micro-batches."""
        gas = self.gradient_accumulation_steps()
        batch = self._to_device(batch)
        b = next(iter(batch.values())).shape[0]
        if b % gas:
            raise ValueError(f"batch dim {b} not divisible by gas={gas}")
        return [self._rank_rows({k: v[i * (b // gas):(i + 1) * (b // gas)]
                                 for k, v in batch.items()}) for i in range(gas)]

    def _finish_step(self, staged) -> StepOutput:
        """The GAS boundary: reduce, average over the staged micro-batches,
        update."""
        n = len(staged)
        self._reduce_boundary()
        grads = self._grads()
        if n > 1:
            with torch.no_grad():
                for g in grads.values():
                    g.div_(n)
        losses, auxes, weights = zip(*staged)
        out = self._apply_update(grads, self._global_loss(list(losses)),
                                 self._reduce_aux(list(auxes), list(weights)))
        self.global_steps += 1
        self._last_grad_norm = out.grad_norm
        return out

    def train_batch(self, batch) -> StepOutput:
        """One optimizer step from one global batch (all GAS micro-batches
        stacked in the leading dim, every rank given the same batch)."""
        self.global_tokens += _count_batch_tokens(batch)
        self._zero_grads()
        staged = [self._grads_one_micro(micro) for micro in self._split_micro(batch)]
        out = self._finish_step(staged)
        # train_batch alone moves the scheduler's counter, as in the JAX
        # engine (its step() leaves it)
        self.lr_scheduler.last_step = self.global_steps
        self._is_compiled = True
        if self.config.steps_per_print and \
                self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(out.loss):.4f} "
                     f"lr={out.lr:.3e} gnorm={float(out.grad_norm):.3f} "
                     f"scale={float(out.loss_scale):.0f}")
        return out

    # ------------------------------------------------------------------ #
    # forward/backward/step (DeepSpeedEngine API parity)
    # ------------------------------------------------------------------ #
    def forward(self, batch) -> torch.Tensor:
        """Loss and grads of one global micro-batch (the JAX engine computes
        them together); the grads are staged for :meth:`step`. Returns the
        global loss."""
        if not self._staged:
            self._zero_grads()
        staged = self._grads_one_micro(self._rank_rows(self._to_device(batch)))
        self._staged.append(staged)
        return comm.all_reduce(staged[0], self._axis, mesh=self.mesh_mgr)

    def backward(self, loss=None) -> torch.Tensor:
        """Returns the staged loss: :meth:`forward` already accumulated the
        micro-batch's grads. Counts the micro-step, as the JAX engine's
        ``backward`` does."""
        self.micro_steps += 1
        return self._staged[-1][0]

    def is_gradient_accumulation_boundary(self) -> bool:
        return len(self._staged) >= self.gradient_accumulation_steps()

    def step(self) -> Optional[StepOutput]:
        """Apply the optimizer step at the GAS boundary (no-op otherwise)."""
        if not self.is_gradient_accumulation_boundary():
            return None
        out = self._finish_step(self._staged)
        self._staged.clear()
        # commit any in-flight async checkpoint at the boundary (reference
        # decoupled-engine commit, runtime/engine.py:2797)
        ce = self.checkpoint_engine
        if ce is not None and getattr(ce, "_pending", None):
            ce.wait_all()
        return out

    def reset_accumulation(self) -> None:
        """Drop a partial gradient-accumulation window (the staged
        micro-batches and their grads)."""
        self._staged.clear()
        self._zero_grads()

    # ------------------------------------------------------------------ #
    # eval / compile / no_sync
    # ------------------------------------------------------------------ #
    def eval_batch(self, batch) -> torch.Tensor:
        """The loss of one global micro-batch, without grads: this rank's
        rows through the model (stage 3 gathers each leaf as the model
        reads it), weighted and summed over ranks as :meth:`forward`'s."""
        with torch.no_grad():
            micro = self._rank_rows(self._to_device(batch))
            out = self._raw_loss(self._compute_params(), micro)
            loss, aux = out if isinstance(out, tuple) else (out, {})
            loss = loss.float() * self._rank_weight(aux)
            return comm.all_reduce(loss, self._axis, mesh=self.mesh_mgr)

    def __call__(self, batch) -> torch.Tensor:
        return self.forward(batch)

    def compile(self, example_batch=None, backend: Optional[str] = None,
                **kw) -> "DeepSpeedTPUEngine":
        """Build every CUDA kernel the step launches (``ops/_build.py``: one
        ``nvcc`` a source, all at once), so the first ``train_batch`` pays
        no build. The step stays eager: nothing is traced and
        ``torch.compile`` is not called. On the CPU there is nothing to
        build."""
        if self.device.type == "cuda":
            from ..ops import _build

            _build.load()
        self._is_compiled = True
        return self

    @property
    def is_compiled(self) -> bool:
        return self._is_compiled

    @contextlib.contextmanager
    def no_sync(self):
        """Reference ``no_sync`` disables the grad all-reduce between
        accumulation steps; here the reduction already happens where the
        stage needs it, so this is a no-op kept for API parity (as in the
        JAX engine)."""
        yield

    # ------------------------------------------------------------------ #
    # checkpoints (runtime/checkpoint/)
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None, **kw) -> str:
        from .checkpoint.saver import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state or {})

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_universal: Optional[bool] = None, **kw):
        from .checkpoint.saver import load_checkpoint as _load

        return _load(self, load_dir, tag=tag, load_universal=load_universal)

    def save_universal_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                                  client_state: Optional[dict] = None,
                                  reason: Optional[str] = None) -> str:
        from .checkpoint.universal import save_universal_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state, reason=reason)

    def load_universal_checkpoint(self, load_dir: str, tag: Optional[str] = None):
        from .checkpoint.universal import load_universal_checkpoint as _load

        return _load(self, load_dir, tag=tag)

    def destroy(self) -> None:
        """Drain pending async checkpoint writes, so process exit cannot
        truncate an in-flight save. A failed background save is logged and
        raised: it was never published, and ``latest`` still names the
        previous good tag. Safe to call more than once."""
        ce = self.checkpoint_engine
        if ce is None:
            return
        try:
            ce.wait_all()
        except Exception as e:
            logger.error(f"async checkpoint write failed during shutdown: {e}")
            raise

    def deepspeed_io(self, dataset, batch_size: Optional[int] = None):
        return DeepSpeedTPUDataLoader(dataset,
                                      batch_size=batch_size or self.train_batch_size())


def _count_batch_tokens(batch) -> int:
    """Tokens in one global batch: the size of its ``tokens`` leaf, else
    the leading dim of its first leaf (JAX ``_count_batch_tokens``)."""
    if isinstance(batch, dict) and "tokens" in batch:
        return int(np.prod(np.shape(batch["tokens"])))
    leaves = list(batch.values()) if isinstance(batch, dict) else [batch]
    if leaves:
        shape = np.shape(leaves[0])
        return int(shape[0]) if shape else 1
    return 0


CARD_COMPUTE_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def check_compute_dtype(compute_dtype: Optional[torch.dtype],
                        device: torch.device) -> None:
    """Raise ``NotImplementedError`` for a compute dtype that the card path
    cannot run: on a CUDA device the kernels of the training path (flash
    attention, RMSNorm, LayerNorm) take bf16, fp16 and fp32
    (``CARD_COMPUTE_DTYPES``), so fp64 is refused there. On the CPU every
    dtype runs the plain versions."""
    if compute_dtype is not None and compute_dtype not in CARD_COMPUTE_DTYPES \
            and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"compute dtype {compute_dtype} has no CUDA kernel: the card path computes "
            "in bfloat16, float16 or float32, or pass device='cpu'")


def check_head_dim(model_cfg: Any, device: torch.device) -> None:
    """Raise ``NotImplementedError`` at build time for a family whose head
    dim the flash-attention kernels do not take (``ops/flash_attention.py``
    ``HEAD_DIMS``) on a CUDA device, rather than at the first step: GPT-J-6B
    (hd 256) is that case (ROADMAP queue B.1). On the CPU every head dim
    runs the plain version."""
    hd = getattr(model_cfg, "head_size", None)
    if hd is not None and hd not in HEAD_DIMS and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"head dim {hd} has no CUDA kernel yet on the flash-attention path (the "
            f"kernels take {HEAD_DIMS}; ROADMAP queue B.1): train on device='cpu'")


def mesh_sizes(cfg: DeepSpeedTPUConfig, world: int) -> Dict[str, int]:
    """The config's ``mesh``, or when none is given the ``expert`` axis of
    ``moe.expert_parallel_size`` and ``data`` over the rest (JAX
    ``initialize``, ``runtime/engine.py:2215-2225``)."""
    ep = int(cfg.moe.expert_parallel_size or 1)
    if cfg.raw.get("mesh") or ep == 1:
        return cfg.mesh.axis_sizes(world)
    if world % ep:
        raise ValueError(f"device count {world} not divisible by expert_parallel_size {ep}")
    return {"data": world // ep, "expert": ep}


def _training_mesh(cfg: DeepSpeedTPUConfig, world: int) -> MeshManager:
    """The mesh over the process group (the installed one when its sizes
    match), or one of sizes alone in a single process without one."""
    sizes = mesh_sizes(cfg, world)
    if not dist.is_initialized():
        return MeshManager.from_sizes(sizes)
    mm = get_mesh()
    full = MeshManager.from_sizes(sizes).sizes
    return mm if mm.sizes == full and mm.device_mesh is not None else init_mesh(sizes)


def initialize(args=None, model: Optional[ModelSpec] = None, optimizer=None,
               model_parameters=None, training_data=None, lr_scheduler=None,
               config=None, config_params=None, device="cuda",
               generator: Optional[torch.Generator] = None,
               mesh_mgr: Optional[MeshManager] = None, **kwargs):
    """Returns ``(engine, optimizer, training_dataloader, lr_scheduler)`` —
    the reference's 4-tuple. ``model`` is a :class:`ModelSpec` or a
    ``transformers`` model (``models/hf_import.py`` ``is_hf_model``; its
    weights imported into its family's spec, computing in the config's
    bf16 / fp16 / fp32). Runs on the GPU unless ``device="cpu"``; raises
    ``RuntimeError`` when no GPU is present, and ``NotImplementedError``
    for config blocks the port does not implement yet or a model that
    computes in a dtype no kernel takes on the GPU (:func:`check_compute_dtype`:
    bf16, fp16 and fp32 run) or whose head
    dim no flash kernel takes there (:func:`check_head_dim`). Over a
    process group (``comm.init_distributed``) the engine is data parallel
    over every rank; its mesh is ``mesh_mgr`` or a ``data`` mesh over the
    group."""
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if model is None:
        raise ValueError("model (ModelSpec) is required")
    hf_model = None
    if not isinstance(model, ModelSpec):
        # initialize(model=<transformers model>): the weights are imported
        # once the config is parsed, so the family computes in its precision
        from ..models.hf_import import is_hf_model

        if not is_hf_model(model):
            raise TypeError(f"model must be a ModelSpec or a transformers "
                            f"model, got {type(model)}")
        hf_model = model
    device = resolve_device(device)
    world = comm.get_world_size()
    if dist.is_initialized() and dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL process group needs device='cuda'")
    cfg = parse_config(config, world_size=world)
    check_ported(cfg, world_size=world)
    if hf_model is not None:
        from ..models.hf_import import spec_from_hf

        model = spec_from_hf(hf_model, compute_dtype=(
            torch.bfloat16 if cfg.bf16.enabled else
            torch.float16 if cfg.fp16.enabled else torch.float32))
    check_compute_dtype(model.compute_dtype, device)
    check_head_dim(model.config, device)
    engine = DeepSpeedTPUEngine(model=model, config=cfg, device=device,
                                optimizer=optimizer, lr_schedule=lr_scheduler,
                                training_data=training_data, generator=generator,
                                mesh_mgr=mesh_mgr or _training_mesh(cfg, world))
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
