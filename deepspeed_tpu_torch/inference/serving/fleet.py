"""Fleet resilience: replica health, circuit breaking, and overload
degradation — counterpart of ``deepspeed_tpu/inference/serving/fleet.py``.

The router's ``drain()`` covers replicas that leave gracefully; this module
supplies the pieces that make a fleet survive the other exits:

- :class:`FleetConfig` — the ``serving.fleet`` config block. **Default OFF**:
  with ``enabled=False`` the router's ``step()``/``submit()`` run the exact
  pre-fleet code paths (a tick error propagates to the caller, nothing is
  measured, no events are emitted) — pinned by parity tests.
- :class:`CircuitBreaker` — per-replica health state machine: CLOSED →
  (N consecutive tick faults) → OPEN → (backoff) → HALF_OPEN probe →
  CLOSED on success / re-OPEN with doubled backoff on failure. While not
  CLOSED the router never places new work on the replica.
- :class:`DegradationLadder` — hysteresis-guarded overload response driven
  by KV-headroom + queue-depth telemetry. Levels, applied in order and
  lifted in reverse as pressure clears: (1) shed lowest-priority
  admissions, (2) disable speculative decoding, (3) clamp
  ``max_new_tokens`` of new admissions. Pool exhaustion and queue collapse
  become controlled shedding instead of failures.

The router (``router.py``) owns one breaker + one ladder per replica and
drives both from ``step()``; failover itself (``ReplicaRouter.fail_over``)
re-homes a failed replica's requests by replaying prompt + already-emitted
tokens through the park/resume seam — see ``scheduler.abandon_all``.

With disaggregated tiers on (``serving.disagg``, ``disagg.py``), the same
machinery becomes tier-aware without growing any new state: breakers and
ladders stay per-replica, but re-homing targets the PREFILL tier
regardless of which tier failed — a replayed history is a prefill-shaped
job, so a dead decode replica's streams re-prefill behind the admission
door and then hand off again like fresh arrivals, while a dead prefill
replica's streams land on a surviving prefill peer. A KV export that
faults mid-handoff is charged to the source replica's breaker exactly
like a tick fault.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

# circuit-breaker states (string-valued like the RequestHandle states)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass
class FleetConfig:
    """``serving.fleet`` config block. Default OFF — the no-fleet router is
    byte-identical to pre-fleet behavior (parity-pinned)."""

    enabled: bool = False
    # -- circuit breaker (per replica) --------------------------------- #
    failure_threshold: int = 3     # consecutive tick faults → OPEN
    probe_backoff_ticks: int = 8   # router steps before the first half-open probe
    backoff_multiplier: float = 2.0  # backoff growth on a failed probe
    max_backoff_ticks: int = 256
    # a tick slower than this counts as a hang fault (0 = no deadline);
    # slower than slow_tick_s (but under the deadline) is only counted
    tick_deadline_s: float = 0.0
    slow_tick_s: float = 0.0
    # -- overload degradation ladder ------------------------------------ #
    degrade: bool = True           # run the ladder (only when enabled=True)
    queue_high: int = 8            # queue depth that reads as overload
    queue_low: int = 2             # queue depth that reads as clear
    headroom_low: float = 0.08     # headroom/total below this = overload
    headroom_high: float = 0.25    # headroom/total above this = clear
    up_ticks: int = 2              # consecutive hot ticks before escalating
    down_ticks: int = 8            # consecutive clear ticks before easing
    shed_priority: int = 1         # level>=1 sheds requests with priority >= this
    clamp_max_new_tokens: int = 16  # level 3 clamp for new admissions
    # tick-duration clock, injectable for tests (the fault harness advances
    # a fake clock so hang detection is deterministic — a first tick that
    # builds kernels and captures the decode graph must never read as a
    # hang)
    clock: Callable[[], float] = time.monotonic

    @classmethod
    def from_dict(cls, d) -> "FleetConfig":
        if isinstance(d, cls):
            return d
        d = dict(d or {})
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(f"unknown serving.fleet key(s): {sorted(unknown)}")
        return cls(**known)


class CircuitBreaker:
    """Per-replica health state machine (module docstring). The router calls
    :meth:`record_success`/:meth:`record_failure` around every tick it runs
    on the replica and :meth:`allow_probe` once per router step while OPEN;
    placement consults :attr:`state` (only CLOSED replicas take new work)."""

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.state = CLOSED
        self.consecutive_faults = 0
        self.cooldown = 0                       # steps until the next probe
        self._backoff = max(1, cfg.probe_backoff_ticks)
        self.opens = 0                          # lifetime OPEN transitions

    def record_success(self) -> bool:
        """A tick completed healthily. Returns True when this success CLOSED
        a half-open breaker (the probe passed — replica re-admitted)."""
        self.consecutive_faults = 0
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self._backoff = max(1, self.cfg.probe_backoff_ticks)
            return True
        return False

    def record_failure(self) -> bool:
        """A tick faulted (raised or blew the deadline). Returns True when
        this fault OPENED the breaker — the caller must fail the replica's
        requests over. A half-open probe failure re-opens immediately with
        the backoff doubled (up to ``max_backoff_ticks``)."""
        self.consecutive_faults += 1
        threshold = max(1, self.cfg.failure_threshold)
        if self.state == HALF_OPEN or self.consecutive_faults >= threshold:
            self.state = OPEN
            self.opens += 1
            self.cooldown = self._backoff
            self._backoff = min(
                max(1, int(self._backoff * self.cfg.backoff_multiplier)),
                max(1, self.cfg.max_backoff_ticks))
            self.consecutive_faults = 0
            return True
        return False

    def allow_probe(self) -> bool:
        """Tick the OPEN-state cooldown down one router step; True once the
        half-open probe is due (state moves to HALF_OPEN and the caller runs
        one guarded tick on the replica)."""
        if self.state != OPEN:
            return False
        self.cooldown -= 1
        if self.cooldown <= 0:
            self.state = HALF_OPEN
            return True
        return False


class DegradationLadder:
    """Hysteresis-guarded overload response for ONE replica (module
    docstring). ``update()`` runs once per router step before the replica's
    tick: pressure (queue depth >= ``queue_high``, or KV headroom fraction
    <= ``headroom_low`` with a backlog) must hold for ``up_ticks``
    consecutive steps to escalate one level, and the all-clear (queue <=
    ``queue_low`` AND headroom >= ``headroom_high``) for ``down_ticks``
    steps to ease one level — so a single bursty tick never flaps the
    ladder. Level effects are applied on entry and lifted in reverse on the
    way down; the speculative-decoding toggle restores the engine's original
    setting exactly."""

    MAX_LEVEL = 3

    def __init__(self, cfg: FleetConfig, sched,
                 on_shed: Optional[Callable[[List], None]] = None):
        self.cfg = cfg
        self.sched = sched
        self.level = 0
        self.shifts = 0                 # lifetime level transitions
        self._hot = 0
        self._clear = 0
        self._spec0: Optional[bool] = None  # engine spec flag before level 2
        self._on_shed = on_shed

    def pressure(self):
        """→ ``(hot, clear)`` from the replica's live telemetry: KV headroom
        (free + retained-evictable blocks over the pool) and queue depth."""
        st = self.sched.engine.state
        total = max(1, st.allocator.num_blocks - 1)
        frac = st.headroom_blocks / total
        qd = self.sched.queue_depth
        hot = qd >= self.cfg.queue_high or \
            (frac <= self.cfg.headroom_low and qd > self.cfg.queue_low)
        clear = qd <= self.cfg.queue_low and frac >= self.cfg.headroom_high
        return hot, clear

    def update(self) -> int:
        hot, clear = self.pressure()
        self._hot = self._hot + 1 if hot else 0
        self._clear = self._clear + 1 if clear else 0
        if hot and self._hot >= max(1, self.cfg.up_ticks) \
                and self.level < self.MAX_LEVEL:
            self._set_level(self.level + 1)
            self._hot = 0
        elif clear and self._clear >= max(1, self.cfg.down_ticks) \
                and self.level > 0:
            self._set_level(self.level - 1)
            self._clear = 0
        if self.level >= 1 and hot:
            shed = self.sched.shed(
                self.cfg.shed_priority,
                f"shed by overload degradation (level {self.level})")
            if shed and self._on_shed is not None:
                self._on_shed(shed)
        return self.level

    def _set_level(self, new: int) -> None:
        old, self.level = self.level, new
        self.shifts += 1
        eng = self.sched.engine
        if new >= 2 and old < 2:
            self._spec0 = eng.set_speculative(False)
        elif new < 2 and old >= 2 and self._spec0 is not None:
            eng.set_speculative(self._spec0)
            self._spec0 = None
        self.sched.degrade_max_new_tokens = \
            self.cfg.clamp_max_new_tokens if new >= 3 else None
        if self.sched.tracer.enabled:
            self.sched.tracer.instant("degrade", cat="serving",
                                      level=new, prev=old)
