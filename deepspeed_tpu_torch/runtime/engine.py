"""Training engine, single process — counterpart of
``deepspeed_tpu/runtime/engine.py`` (``ModelSpec`` :56, ``TrainState`` :89,
``StepOutput`` :105, ``_loss`` :1134, ``_grads_one_micro`` :1143,
``_accumulate`` :1258, ``_apply_update`` :1604, ``train_batch`` :1838,
``forward``/``backward``/``step`` :1906-1983, ``initialize`` :2170).

Same step semantics as the JAX engine:

- fp32 master params; each micro-batch casts them to the compute dtype
  (bf16/fp16/fp32) inside the differentiated function, so grads reach the
  masters in fp32 through the cast;
- a global batch ``[gas * micro, ...]`` is split into ``gas`` micro-batches;
  grads and losses are the mean over micro-batches;
- the update: overflow check on the (scaled) grads, unscale, global-norm
  clip ``min(1, clip / (norm + 1e-6))``, ``lr_scale = lr_t / base_lr`` with
  ``lr_t`` the schedule at ``state.step``, the optimizer step, and on
  overflow a skip that leaves params, optimizer state and step untouched
  while the fp16 scaler backs off.

PyTorch runs eagerly, so the step is Python over autograd rather than one
compiled program; grads accumulate in the masters' ``.grad`` and the
optimizer updates in place (see ``ops/optimizers.py``). The overflow check
reads one boolean back to the host per step.

Not ported yet (their config blocks raise at :func:`initialize`, see
``runtime/config.py``): distributed data parallelism and ZeRO sharding
(stages 0-3 are accepted at world size 1, where a stage changes no
arithmetic), offload and tiered memory, pipeline, sequence parallelism and
tiled loss, remat, comms overlap, MoE, telemetry, tuning, watchdog,
integrity, checkpoints, curriculum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.optimizers import Optimizer, get_optimizer
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .config import DeepSpeedTPUConfig, check_ported, parse_config
from .dataloader import DeepSpeedTPUDataLoader
from .lr_schedules import LRScheduler, Schedule, get_schedule
from .precision import (LossScaleState, PrecisionPolicy, grads_finite,
                        make_loss_scaler, scale_loss, update_loss_scale)
from .utils import clip_grad_norm_, global_norm

Params = Dict[str, torch.Tensor]


@dataclass
class ModelSpec:
    """What the engine needs from a user model: a loss function over a flat
    dict of params, and the params themselves or a function that draws them
    from a ``torch.Generator``."""

    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]
    init_fn: Optional[Callable[[torch.Generator], Params]] = None
    params: Optional[Params] = None
    name: str = "model"
    # the dtype loss_fn computes in (None: not stated); initialize refuses
    # one that no CUDA kernel takes (check_compute_dtype)
    compute_dtype: Optional[torch.dtype] = None

    def materialize(self, generator: torch.Generator) -> Params:
        if self.params is not None:
            return self.params
        if self.init_fn is None:
            raise ValueError("ModelSpec needs params or init_fn")
        return self.init_fn(generator)


class TrainState(NamedTuple):
    step: int                  # optimizer steps taken (skipped ones excluded)
    params: Params             # fp32 masters
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
                 training_data=None, generator: Optional[torch.Generator] = None):
        self.model = model
        self.config = config
        self.device = device
        self.global_steps = 0
        self.training_dataloader = None
        self.precision = PrecisionPolicy.from_config(config)

        if optimizer is None:
            optimizer = get_optimizer(config.optimizer.type or "adamw",
                                      **config.optimizer.params)
        self.optimizer = optimizer
        self.base_lr = float(optimizer.hyperparams.get("lr", 1.0)) or 1.0
        if lr_schedule is None:
            lr_schedule = get_schedule(config.scheduler.type,
                                       config.scheduler.params,
                                       base_lr=self.base_lr)
        self.lr_schedule = lr_schedule
        self.lr_scheduler = LRScheduler(lr_schedule)

        if generator is None:
            generator = torch.Generator(device=device).manual_seed(config.seed)
        own = model.params is None   # drawn here: no caller holds these tensors
        params = {}
        for name, p in model.materialize(generator).items():
            p = torch.as_tensor(p).detach()
            if p.is_floating_point():
                p = p.to(device=device, dtype=self.precision.param_dtype,
                         copy=not own)
            params[name] = p.to(device).requires_grad_(p.is_floating_point())
        self.state = TrainState(
            step=0, params=params, opt_state=optimizer.init(params),
            loss_scale=make_loss_scaler(config.fp16, device), skipped_steps=0)
        self._staged: List[Tuple[torch.Tensor, Dict[str, Any]]] = []

        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
        log_dist(f"engine ready: device={device} zero_stage="
                 f"{config.zero_config.stage} dtype={config.compute_dtype} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()}")

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
        return self.config.zero_config.stage

    @property
    def loss_scale(self) -> float:
        return float(self.state.loss_scale.scale)

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                .to(self.device) for k, v in batch.items()}

    def _grads_one_micro(self, batch: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Forward and backward of one micro-batch: the grads of the scaled
        loss ADD into the masters' ``.grad``; returns the unscaled loss."""
        compute = self.precision.cast_to_compute(self.state.params)
        out = self.model.loss_fn(compute, batch)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss = loss.float()
        scale_loss(loss, self.state.loss_scale).backward()
        return loss.detach(), aux

    def _zero_grads(self) -> None:
        for p in self.state.params.values():
            p.grad = None

    def _grads(self) -> Params:
        params = self.state.params
        return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                for k, p in params.items() if p.requires_grad}

    def _apply_update(self, grads: Params, loss: torch.Tensor,
                      aux: Optional[Dict[str, Any]] = None) -> StepOutput:
        """JAX ``_apply_update``: grads are the mean micro-batch grads of the
        scaled loss, modified in place here."""
        cfg, state = self.config, self.state
        finite = bool(grads_finite(grads.values()))
        inv = 1.0 / state.loss_scale.scale
        with torch.no_grad():
            for g in grads.values():
                g.mul_(inv)
            if cfg.gradient_clipping and cfg.gradient_clipping > 0:
                grads, grad_norm = clip_grad_norm_(grads, cfg.gradient_clipping)
            else:
                grad_norm = global_norm(grads)
        lr_t = float(self.lr_schedule(state.step))
        lr_scale = lr_t / self.base_lr
        params, opt_state = state.params, state.opt_state
        if finite:
            params, opt_state = self.optimizer.update(params, grads, opt_state,
                                                      lr_scale=lr_scale)
        new_scale = update_loss_scale(state.loss_scale, torch.tensor(finite))
        self.state = TrainState(step=state.step + int(finite), params=params,
                                opt_state=opt_state, loss_scale=new_scale,
                                skipped_steps=state.skipped_steps + int(not finite))
        self._zero_grads()
        return StepOutput(loss=loss, grad_norm=grad_norm, lr=lr_t,
                          loss_scale=new_scale.scale, overflow=not finite,
                          aux={} if aux is None else aux)

    def _split_micro(self, batch) -> List[Dict[str, torch.Tensor]]:
        gas = self.gradient_accumulation_steps()
        batch = self._to_device(batch)
        b = next(iter(batch.values())).shape[0]
        if b % gas:
            raise ValueError(f"batch dim {b} not divisible by gas={gas}")
        return [{k: v[i * (b // gas):(i + 1) * (b // gas)] for k, v in batch.items()}
                for i in range(gas)]

    def train_batch(self, batch) -> StepOutput:
        """One optimizer step from one global batch (all GAS micro-batches
        stacked in the leading dim)."""
        self._zero_grads()
        losses, auxes = [], []
        for micro in self._split_micro(batch):
            loss, aux = self._grads_one_micro(micro)
            losses.append(loss)
            auxes.append(aux)
        gas = len(losses)
        grads = self._grads()
        if gas > 1:
            with torch.no_grad():
                for g in grads.values():
                    g.div_(gas)
        out = self._apply_update(grads, torch.stack(losses).mean(),
                                 _mean_aux(auxes))
        self.global_steps += 1
        self.lr_scheduler.last_step = self.global_steps
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
        """Loss and grads of one micro-batch (the JAX engine computes them
        together); the grads are staged for :meth:`backward`."""
        if not self._staged:
            self._zero_grads()
        loss, aux = self._grads_one_micro(self._to_device(batch))
        self._staged.append((loss, aux))
        return loss

    def backward(self, loss=None) -> torch.Tensor:
        """A no-op returning the staged loss: :meth:`forward` already
        accumulated the micro-batch's grads."""
        return self._staged[-1][0]

    def is_gradient_accumulation_boundary(self) -> bool:
        return len(self._staged) >= self.gradient_accumulation_steps()

    def step(self) -> Optional[StepOutput]:
        """Apply the optimizer step at the GAS boundary (no-op otherwise)."""
        if not self.is_gradient_accumulation_boundary():
            return None
        n = len(self._staged)
        grads = self._grads()
        with torch.no_grad():
            for g in grads.values():
                g.div_(n)
        loss = torch.stack([l for l, _ in self._staged]).mean()
        out = self._apply_update(grads, loss, _mean_aux([a for _, a in self._staged]))
        self._staged.clear()
        self.global_steps += 1
        self.lr_scheduler.last_step = self.global_steps
        return out

    def deepspeed_io(self, dataset, batch_size: Optional[int] = None):
        return DeepSpeedTPUDataLoader(dataset,
                                      batch_size=batch_size or self.train_batch_size())


def _mean_aux(auxes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Mean over micro-batches for floating values, sum otherwise (token
    counts), as the JAX engine reduces its aux."""
    if not auxes or not auxes[0]:
        return {}
    out = {}
    for k in auxes[0]:
        vals = torch.stack([torch.as_tensor(a[k]) for a in auxes])
        out[k] = vals.float().mean() if vals.is_floating_point() else vals.sum()
    return out


def check_compute_dtype(compute_dtype: Optional[torch.dtype],
                        device: torch.device) -> None:
    """Raise ``NotImplementedError`` for a compute dtype that the card path
    cannot run: fp16 on a CUDA device, where the flash-attention kernels
    take bf16 and fp32 only (ROADMAP queue B.2; RMSNorm, LayerNorm and the
    int8 quantize and dequantize kernels take fp16 already). On the CPU,
    fp16 runs the plain versions."""
    if compute_dtype == torch.float16 and torch.device(device).type == "cuda":
        raise NotImplementedError(
            "an fp16 compute dtype has no CUDA kernel yet on the flash-attention "
            "path (ROADMAP queue B.2): compute in bf16, or pass device='cpu'")


def initialize(args=None, model: Optional[ModelSpec] = None, optimizer=None,
               model_parameters=None, training_data=None, lr_scheduler=None,
               config=None, config_params=None, device="cuda",
               generator: Optional[torch.Generator] = None, **kwargs):
    """Returns ``(engine, optimizer, training_dataloader, lr_scheduler)`` —
    the reference's 4-tuple. Runs on the GPU unless ``device="cpu"``; raises
    ``RuntimeError`` when no GPU is present, and ``NotImplementedError``
    for config blocks the port does not implement yet, a distributed
    world size above 1, or a model that computes in fp16 on the GPU
    (:func:`check_compute_dtype`)."""
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if not isinstance(model, ModelSpec):
        raise TypeError(f"model must be a ModelSpec, got {type(model)}")
    device = resolve_device(device)
    world = 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
    cfg = parse_config(config, world_size=world)
    check_ported(cfg, world_size=world)
    check_compute_dtype(model.compute_dtype, device)
    engine = DeepSpeedTPUEngine(model=model, config=cfg, device=device,
                                optimizer=optimizer, lr_schedule=lr_scheduler,
                                training_data=training_data, generator=generator)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
