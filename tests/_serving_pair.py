"""The serving layer of both packages over ``_v2_pair``'s engines, for the
port's serving parity tests (``test_torch_serving_*.py``,
``test_torch_disagg.py``, ``test_torch_trace.py``).

A :class:`Side` bundles one package's serving modules, its fault injectors
and its engine builder, so one scenario function runs unchanged against the
JAX package and against the port; the tests compare what the two runs
return. :func:`record` logs the engine calls a scheduler makes (admissions,
split admissions, parks, resumes, finishes) in order: the decision log.
"""

from types import SimpleNamespace

from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.testing import faults as jfaults
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.testing import faults as tfaults

_CALLS = {
    "put_many": lambda a, k: tuple(int(uid) for uid, _ in a[0]),
    "put_split": lambda a, k: int(a[0]),
    "park": lambda a, k: int(a[0]),
    "resume": lambda a, k: (int(a[0]["uid"]), bool(k.get("split", False))),
    "finish": lambda a, k: int(a[0]),
}


def record(eng) -> list:
    """Log every ``put_many`` / ``put_split`` / ``park`` / ``resume`` /
    ``finish`` call on ``eng`` (the engine's own inner calls included, which
    both packages make alike) as ``(call, uid or uids)``, in order."""
    log = []
    for name, key in _CALLS.items():
        orig = getattr(eng, name)

        def wrapped(*a, _orig=orig, _name=name, _key=key, **k):
            log.append((_name, _key(a, k)))
            return _orig(*a, **k)

        setattr(eng, name, wrapped)
    return log


class FakeClock:
    """An injectable clock that moves only when told to: scheduler clocks
    (deadlines, queue waits) and ``FleetConfig.clock`` (tick deadlines; its
    ``advance`` doubles as the hang injector's sleep)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


class Side:
    """One package's serving stack: ``serving`` (the ``inference.serving``
    package), ``faults`` (the chaos injectors) and ``engine(**conf)``."""

    def __init__(self, name, serving, faults, engine):
        self.name = name
        self.serving = serving
        self.faults = faults
        self.engine = engine

    def __repr__(self):
        return self.name


def sides(pair=None):
    """(JAX side, port side) over ``pair``'s engines (no engines without a
    pair)."""
    return (Side("jax", jserving, jfaults, pair and pair.jax),
            Side("port", tserving, tfaults, pair and pair.port))


def both(pair, scenario, *args, **kw):
    """``scenario(side, ...)`` on the JAX side and on the port's →
    (JAX result, port result)."""
    j, t = sides(pair)
    return scenario(j, *args, **kw), scenario(t, *args, **kw)


def requests(side, vocab, n, seed=9, gen_len=12, prompt_len=(8, 24),
             prios=(0,), deadline_ms=60000.0, **kw):
    """``n`` requests of a seeded ``TrafficGenerator`` (one per package, the
    same draws)."""
    s = side.serving
    gen = s.TrafficGenerator(s.WorkloadConfig(
        seed=seed, vocab_size=vocab, prompt_len=prompt_len, gen_len=gen_len,
        priorities=prios, deadline_ms=deadline_ms, **kw))
    return [gen.request() for _ in range(n)]


def outcome(handles) -> list:
    """What a client sees of each handle: state, tokens, error, SLO,
    preemptions and replica."""
    return [SimpleNamespace(state=h.state, tokens=list(h.tokens), error=h.error,
                            slo_met=h.slo_met, preemptions=h.preemptions,
                            replica=h.replica).__dict__ for h in handles]


def drive(sched, clock=None, dt=0.01, check=True, max_ticks=2000) -> int:
    """Tick ``sched`` until it drains, advancing ``clock`` by ``dt`` before
    each tick and checking the allocator's invariants after it; → ticks."""
    n = 0
    while sched.pending:
        assert n < max_ticks, "scheduler did not drain"
        if clock is not None:
            clock.advance(dt)
        sched.tick()
        if check:
            sched.engine.state.debug_check()
        n += 1
    return n


def port_oracle(pair, **conf):
    """One fault-free port scheduler on ``pair``'s engine with the prefix
    cache on (and ``conf``): greedy streams depend only on the prompt, so
    ``run(requests)`` gives the token-identity oracle of any placement,
    failover or handoff history."""
    sched = tserving.ServingScheduler(pair.port(prefix_cache={"enabled": True}, **conf))

    def run(reqs):
        hs = [sched.submit(tserving.Request(prompt=list(r.prompt),
                                            max_new_tokens=r.max_new_tokens))
              for r in reqs]
        sched.run()
        return [h.tokens for h in hs]
    return run
