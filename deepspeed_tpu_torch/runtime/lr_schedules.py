"""LR schedules — counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``
(LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR;
``get_schedule`` :130, ``LRScheduler`` :149).

A schedule is a function ``step -> lr`` of the optimizer step, evaluated on
the host in Python floats (the JAX package traces it in fp32 inside the
step); the engine multiplies the optimizer's base ``lr`` by
``lr / base_lr``. The formulas are the JAX package's, line for line.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[float], float]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _warmup(step, warmup_num_steps, warmup_type="log"):
    step = float(step)
    w = max(int(warmup_num_steps), 1)
    frac = _clip(step / w, 0.0, 1.0)
    if warmup_type == "log":
        # reference WarmupLR: log-spaced interpolation min→max
        return 1.0 if step >= w else math.log1p(step) / math.log1p(w)
    return frac


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> Schedule:
    def sched(step):
        f = _warmup(step, warmup_num_steps, warmup_type)
        return warmup_min_lr + f * (warmup_max_lr - warmup_min_lr)

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def sched(step):
        step = float(step)
        decay = _clip((total_num_steps - step)
                      / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return base(step) if step < warmup_num_steps else warmup_max_lr * decay

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_num_steps: int = 1000,
                     warmup_min_ratio: float = 0.0, cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 1e-3, **_) -> Schedule:
    def sched(step):
        step = float(step)
        wfrac = _clip(step / max(warmup_num_steps, 1), 0.0, 1.0)
        warm = warmup_min_ratio + wfrac * (1 - warmup_min_ratio)
        progress = _clip((step - warmup_num_steps)
                         / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        cos = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress))
        ratio = warm if step < warmup_num_steps else cos
        return warmup_max_lr * ratio

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0, **_) -> Schedule:
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size

    def sched(step):
        step = float(step)
        total_cycle = cycle_first_step_size + second
        up = _clip(step / cycle_first_step_size, 0.0, 1.0)
        down = _clip((step - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
        in_cycle = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
            up if step <= cycle_first_step_size else 1.0 - down)
        if decay_step_size > 0:
            decay_steps = max(step - total_cycle, 0.0) / decay_step_size
            decayed = cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
            return decayed if step > total_cycle else in_cycle
        return cycle_min_lr if step > total_cycle else in_cycle

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    def sched(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return sched


def constant(lr: float) -> Schedule:
    def sched(step):
        return float(lr)

    return sched


_FACTORY: Dict[str, Callable[..., Schedule]] = {
    WARMUP_LR.lower(): warmup_lr,
    WARMUP_DECAY_LR.lower(): warmup_decay_lr,
    WARMUP_COSINE_LR.lower(): warmup_cosine_lr,
    ONE_CYCLE.lower(): one_cycle,
    LR_RANGE_TEST.lower(): lr_range_test,
}


def get_schedule(type_name: Optional[str], params: Dict[str, Any],
                 base_lr: float) -> Schedule:
    """Build from a DeepSpeed-style scheduler config block. ``None`` →
    constant base LR."""
    if not type_name:
        return constant(base_lr)
    key = type_name.lower()
    if key not in _FACTORY:
        raise ValueError(f"unknown scheduler '{type_name}' (known: {sorted(_FACTORY)})")
    fn = _FACTORY[key]
    sig = inspect.signature(fn).parameters
    has_kwargs = any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.values())
    kwargs = {k: v for k, v in params.items() if has_kwargs or k in sig}
    return fn(**kwargs)


class LRScheduler:
    """Reference-compatible stateful wrapper (``step()`` / ``get_lr()``)."""

    def __init__(self, schedule: Schedule):
        self.schedule = schedule
        self.last_step = 0

    def step(self, increment: int = 1) -> None:
        self.last_step += increment

    def get_lr(self):
        return [float(self.schedule(self.last_step))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]
