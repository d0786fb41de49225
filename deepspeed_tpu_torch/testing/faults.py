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

The checkpoint injectors, copied too, attack the two-phase commit of
``runtime/checkpoint/`` (each patches one checkpoint engine's or the
fragment writer's ``save`` and restores it on exit, through
:func:`patch_attr`):

- :class:`SimulatedCrash` — process death (a ``BaseException`` no retry
  loop swallows);
- :func:`io_errors` — the first ``fail_times`` calls raise ``OSError``;
- :func:`crash_after_save` — the write lands, then the process dies before
  the commit;
- :func:`truncated_write` — the write lands torn, then the process dies;
- :func:`corrupt_file` / :func:`corrupt_fragment` — a committed tag's file
  truncated afterwards;
- :func:`write_delay` — every save stalls (inside the async writer thread).

The preemption, host-loss, non-finite and bit-flip injectors of the JAX
module wait for the port's reliability and integrity planes.
"""

from __future__ import annotations

import contextlib
import os
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


# --------------------------------------------------------------------------- #
# checkpoint faults
# --------------------------------------------------------------------------- #
class SimulatedCrash(BaseException):
    """Emulates sudden process death mid-operation. Deliberately a
    ``BaseException``: no retry loop or ``except Exception`` recovery path
    may swallow it — exactly like a real SIGKILL."""


def _dump_flight_recorders(reason: str) -> None:
    """Injected crashes dump every live flight recorder before the process
    'dies' — the same trace artifact a real crash leaves behind (see
    ``telemetry/trace.py``). Best-effort: tracing must never change what a
    fault test observes."""
    try:
        from ..telemetry.trace import dump_all

        dump_all(reason)
    except Exception:
        pass


def _save_host(ce):
    """The object whose ``save`` actually touches disk: the inner engine for
    the decoupled/async wrapper, the engine itself otherwise."""
    return getattr(ce, "inner", None) or ce


_MISSING = object()


def patch_attr(obj, name: str, replacement):
    """Install ``obj.name = replacement`` and return an ``undo()`` that
    restores the EXACT prior state: when the original lived on the class
    (the usual bound-method case) the shadowing instance attribute is
    removed again, instead of pinning a stale bound method onto the
    instance forever. Every injector here unwinds through this, so a test
    that raises mid-fault leaves the patched object indistinguishable from
    one that was never touched (the regression tests in
    ``tests/test_torch_checkpoint_faults.py`` assert exactly that)."""
    prior = obj.__dict__.get(name, _MISSING) if hasattr(obj, "__dict__") \
        else getattr(obj, name, _MISSING)
    setattr(obj, name, replacement)

    def undo():
        if prior is _MISSING:
            try:
                delattr(obj, name)
            except AttributeError:
                pass
        else:
            setattr(obj, name, prior)

    return undo


@contextlib.contextmanager
def io_errors(ce, fail_times: int = 1, op: str = "save",
              exc_factory=None) -> Iterator[dict]:
    """First ``fail_times`` calls of ``ce.<op>`` raise ``OSError``; later
    calls pass through. Yields a dict with ``calls``/``failures`` counters
    so tests can assert the retry policy's exact behavior."""
    target = getattr(ce, op)
    state = {"calls": 0, "failures": 0}

    def flaky(*args, **kwargs):
        state["calls"] += 1
        if state["failures"] < fail_times:
            state["failures"] += 1
            raise (exc_factory() if exc_factory is not None
                   else OSError(f"injected transient I/O error "
                                f"#{state['failures']}"))
        return target(*args, **kwargs)

    undo = patch_attr(ce, op, flaky)
    try:
        yield state
    finally:
        undo()


@contextlib.contextmanager
def crash_after_save(ce) -> Iterator[None]:
    """The state write completes, then :class:`SimulatedCrash` — the process
    dies BETWEEN save and commit. ``on_durable`` (the saver's
    manifest/publish/latest phase) is never invoked, so a crash-consistent
    saver must leave ``latest`` on the previous good tag."""
    orig = ce.save

    def dying(tree, path, on_durable=None, **kw):
        orig(tree, path, **kw)
        _dump_flight_recorders("fault_crash_after_save")
        raise SimulatedCrash(f"simulated crash after write of {path}")

    undo = patch_attr(ce, "save", dying)
    try:
        yield
    finally:
        undo()


@contextlib.contextmanager
def truncated_write(ce, keep_bytes: int = 64,
                    filename: Optional[str] = None) -> Iterator[None]:
    """The write lands torn — after the inner save returns, the largest file
    under the save path (or ``filename``) is truncated to ``keep_bytes`` and
    the process dies (:class:`SimulatedCrash`). No commit/publish happens."""
    orig = ce.save

    def torn(tree, path, on_durable=None, **kw):
        orig(tree, path, **kw)
        corrupt_file(path, keep_bytes=keep_bytes, filename=filename)
        _dump_flight_recorders("fault_truncated_write")
        raise SimulatedCrash(f"simulated crash mid-write of {path}")

    undo = patch_attr(ce, "save", torn)
    try:
        yield
    finally:
        undo()


def corrupt_file(root: str, keep_bytes: int = 64,
                 filename: Optional[str] = None) -> str:
    """Truncate one file under ``root`` (the largest, or the one named
    ``filename``) to ``keep_bytes`` — post-hoc corruption of a committed
    checkpoint that manifest verification must flag. Returns the path."""
    victim, size = None, -1
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            full = os.path.join(dirpath, fn)
            if filename is not None:
                if fn == filename:
                    victim = full
                    break
            elif os.path.getsize(full) > size:
                victim, size = full, os.path.getsize(full)
        if filename is not None and victim is not None:
            break
    if victim is None:
        raise FileNotFoundError(
            f"no file{f' named {filename}' if filename else ''} under {root}")
    with open(victim, "r+b") as f:
        f.truncate(keep_bytes)
    return victim


@contextlib.contextmanager
def write_delay(ce, seconds: float) -> Iterator[None]:
    """Every save stalls ``seconds`` before touching disk. For the async
    engine the delay runs inside the writer THREAD (the inner engine is
    patched), widening the window between a save's return and its commit."""
    host = _save_host(ce)
    orig = host.save

    def slow(tree, path, **kw):
        time.sleep(seconds)
        return orig(tree, path, **kw)

    undo = patch_attr(host, "save", slow)
    try:
        yield
    finally:
        undo()


def corrupt_fragment(universal_dir: str, name: Optional[str] = None,
                     keep_bytes: int = 16) -> str:
    """Truncate one fp32 fragment of a COMMITTED universal checkpoint tag
    (the named ``param/<name>`` fragment, or the largest one) — post-hoc bit
    rot that the verified elastic load must convert into a walk-back, never
    a resume from torn state. Returns the path of the corrupted file."""
    root = os.path.join(universal_dir, "param")
    if not os.path.isdir(root):
        root = universal_dir
    if name is not None:
        target = os.path.join(root, name, "fp32.npy")
        if not os.path.exists(target):
            raise FileNotFoundError(f"no fragment named {name} under {root}")
        with open(target, "r+b") as f:
            f.truncate(keep_bytes)
        return target
    return corrupt_file(root, keep_bytes=keep_bytes, filename="fp32.npy")
