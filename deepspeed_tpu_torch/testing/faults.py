"""Serving-fleet chaos — the serving injectors of
``deepspeed_tpu/testing/faults.py``, copied. Each patches one
``ServingScheduler`` instance's ``tick`` and restores it on exit:

- :func:`replica_crash` — every tick raises :class:`ReplicaCrash` (a
  survivable component failure) until the context exits;
- :func:`replica_hang` — ticks stall past the router's
  ``fleet.tick_deadline_s`` before completing (a wedged device sync as the
  router sees it);
- :func:`slow_replica` — persistent below-deadline degradation;
- :func:`flaky_tick` — every k-th tick raises (transient faults that must
  NOT open the breaker while successes interleave);
- :func:`chaos_soak` — replays a request list against a ``ReplicaRouter``
  under seeded randomized crash/hang injection and returns every handle so
  the caller can assert zero lost requests and token-exact failover.

The checkpoint, preemption, host-loss, non-finite and bit-flip injectors of
the JAX module wait for the port's checkpointing and integrity planes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


# --------------------------------------------------------------------------- #
# serving-fleet chaos
# --------------------------------------------------------------------------- #
class ReplicaCrash(RuntimeError):
    """A serving replica 'dies' mid-tick: a survivable COMPONENT failure,
    which the fleet layer (``ReplicaRouter`` health tracking) is expected to
    catch, open the replica's circuit breaker over, and fail its requests
    over to survivors."""


@contextlib.contextmanager
def replica_crash(sched, after_ticks: int = 0) -> Iterator[dict]:
    """``sched.tick`` raises :class:`ReplicaCrash` on every call after the
    first ``after_ticks`` healthy ones — the replica is down until the
    context exits (recovery is when the breaker's half-open probe next finds
    tick working). Yields ``{"ticks", "crashes"}`` counters."""
    orig = sched.tick
    state = {"ticks": 0, "crashes": 0}

    def dying(*args, **kwargs):
        state["ticks"] += 1
        if state["ticks"] > after_ticks:
            state["crashes"] += 1
            raise ReplicaCrash(
                f"injected replica crash (tick #{state['ticks']})")
        return orig(*args, **kwargs)

    sched.tick = dying
    try:
        yield state
    finally:
        sched.tick = orig


@contextlib.contextmanager
def replica_hang(sched, seconds: float, times: Optional[int] = None,
                 advance=None) -> Iterator[dict]:
    """Every tick (or the first ``times``) stalls ``seconds`` before doing
    its work — what a wedged collective or device sync looks like from the
    router: the tick eventually completes, but blows through
    ``fleet.tick_deadline_s``, so health tracking counts a hang fault.
    ``advance`` (a callable taking seconds) substitutes for the real sleep:
    pass a fake clock's advance — the same clock injected as
    ``FleetConfig.clock`` — and hang detection becomes deterministic
    (healthy ticks, the first one's kernel build and graph capture
    included, cost zero fake time)."""
    orig = sched.tick
    state = {"hangs": 0}

    def hung(*args, **kwargs):
        if times is None or state["hangs"] < times:
            state["hangs"] += 1
            (advance or time.sleep)(seconds)
        return orig(*args, **kwargs)

    sched.tick = hung
    try:
        yield state
    finally:
        sched.tick = orig


@contextlib.contextmanager
def slow_replica(sched, seconds: float, advance=None) -> Iterator[dict]:
    """Every tick stalls ``seconds`` — persistent degradation BELOW the hang
    deadline (cross-tenant interference, thermal throttling). Health
    tracking counts ``slow_ticks`` without opening the breaker. ``advance``
    as in :func:`replica_hang`."""
    orig = sched.tick
    state = {"slow": 0}

    def slow(*args, **kwargs):
        state["slow"] += 1
        (advance or time.sleep)(seconds)
        return orig(*args, **kwargs)

    sched.tick = slow
    try:
        yield state
    finally:
        sched.tick = orig


@contextlib.contextmanager
def flaky_tick(sched, fail_every: int = 3, exc_factory=None) -> Iterator[dict]:
    """Every ``fail_every``-th tick raises (:class:`ReplicaCrash` by
    default) — transient faults with successes interleaved, which
    consecutive-fault accounting must NOT escalate into an open breaker."""
    if fail_every < 2:
        raise ValueError("fail_every must be >= 2 (1 would never succeed)")
    orig = sched.tick
    state = {"ticks": 0, "failures": 0}

    def flaky(*args, **kwargs):
        state["ticks"] += 1
        if state["ticks"] % fail_every == 0:
            state["failures"] += 1
            raise (exc_factory() if exc_factory is not None else
                   ReplicaCrash(f"injected flaky tick "
                                f"#{state['ticks']}"))
        return orig(*args, **kwargs)

    sched.tick = flaky
    try:
        yield state
    finally:
        sched.tick = orig


def chaos_soak(router, requests, seed: int = 0, submits_per_step: int = 2,
               fault_rate: float = 0.08, crash_ticks=(4, 12),
               hang_s: float = 0.0, advance=None, max_steps: int = 4000):
    """Seeded chaos soak: drip ``requests`` into ``router`` while a seeded
    schedule of replica crashes (and hangs, when ``hang_s`` > 0 — pass
    ``advance`` = the injected ``FleetConfig.clock``'s advance so hangs are
    fake-clock time) hits ONE random replica at a time. A new fault starts
    only while every breaker is CLOSED, so at most one replica is ever
    unhealthy and the fleet always has a survivor to fail over to. Asserts
    nothing itself; returns ``{"handles", "faults", "steps"}`` for the
    caller to assert the zero-lost-requests and token-exact-failover
    acceptance criteria. The same seed replays the same fault schedule
    against the same trace."""
    import random

    rng = random.Random(seed)
    handles = []
    faults = []
    active_cm = None          # the one in-flight fault context
    fault_until = 0
    i = steps = 0

    def all_closed():
        return all(b.state == "closed"
                   for b in getattr(router, "_health", []))

    try:
        while (i < len(requests) or router.pending) and steps < max_steps:
            steps += 1
            for _ in range(submits_per_step):
                if i < len(requests):
                    handles.append(router.submit(requests[i]))
                    i += 1
            if active_cm is not None and steps >= fault_until:
                active_cm[0].__exit__(None, None, None)
                active_cm = None
            if active_cm is None and all_closed() and \
                    rng.random() < fault_rate:
                victim = rng.randrange(len(router.replicas))
                dur = rng.randint(*crash_ticks)
                if hang_s > 0 and rng.random() < 0.5:
                    cm = replica_hang(router.replicas[victim], hang_s,
                                      advance=advance)
                    kind = "hang"
                else:
                    cm = replica_crash(router.replicas[victim])
                    kind = "crash"
                cm.__enter__()
                active_cm = (cm, victim)
                fault_until = steps + dur
                faults.append({"step": steps, "replica": victim,
                               "kind": kind, "ticks": dur})
            router.step()
    finally:
        if active_cm is not None:
            active_cm[0].__exit__(None, None, None)
    # drain whatever recovery left behind (breaker probes need idle steps)
    extra = 0
    while router.pending and extra < max_steps:
        router.step()
        extra += 1
    return {"handles": handles, "faults": faults, "steps": steps + extra}
