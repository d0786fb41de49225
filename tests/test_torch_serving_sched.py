"""The serving scheduler, the traffic generator and the replica router of
the port against the JAX package's, on the same tiny Llama weights (fp32,
CPU) and fake clocks.

Arrivals are IDENTICAL element by element for every arrival process and
prompt kind. Scheduler runs (pool pressure with preemption, priority and
deadline order, drop-expired, chunked admission, streaming, rejects,
decode quanta) give identical per-request streams, ``stats`` and decision
logs (the ordered engine calls: admissions, parks, resumes, finishes), with
the allocator's invariants checked after every tick; router runs
(affinity, overload fallback, drain) identical streams, placements and
``stats``. Tolerance: none — every comparison is exact. Event names
validate against the JAX package's closed schema.
"""

import math

import numpy as np
import pytest
from _serving_pair import FakeClock, both, drive, outcome, record, requests, sides
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair

from deepspeed_tpu.telemetry.schema import SERVING_SERIES, validate_events
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.inference.ragged import UnknownSequenceError

PREFIX = {"prefix_cache": {"enabled": True}}


@pytest.fixture(scope="module")
def pair():
    return Pair()


# --------------------------------------------------------------------------- #
# traffic generator
# --------------------------------------------------------------------------- #
WORKLOADS = {
    "poisson": dict(rate_rps=20.0, prompt_len=(8, 24), gen_len=(4, 12),
                    priorities=(0, 1, 2), deadline_ms=500.0),
    "bursty": dict(process="bursty", burst_size=3, burst_interval_s=0.7),
    "diurnal": dict(process="diurnal", rate_rps=12.0, diurnal_amplitude=0.8,
                    diurnal_period_s=2.0),
    "burst_overlay": dict(rate_rps=6.0, burst_overlay=True, burst_size=5,
                          burst_interval_s=1.1),
    "shared_prefix": dict(prompt_kind="shared_prefix", shared_len=12,
                          prompt_len=(2, 6)),
    "repetitive": dict(prompt_kind="repetitive", pattern_len=3, prompt_len=(5, 17)),
    "multi_turn": dict(turns=3, think_time_s=0.5, followup_len=(2, 7)),
    "lognormal_turns": dict(turns_dist="lognormal", turns_mu=0.7, turns_sigma=1.2,
                            max_turns=9),
    "tenant_mix": dict(tenant_mix=(("gold", 1.0, 0), ("silver", 2.5, 1),
                                   ("bronze", 4.0, 2)), eos_token_id=7),
    "tenant": dict(tenant="acme", priorities=(3,), deadline_ms=250.0),
}


def _arrivals(side, kind):
    s = side.serving
    gen = s.TrafficGenerator(s.WorkloadConfig(seed=11, vocab_size=300,
                                              **WORKLOADS[kind]))
    arr = gen.arrivals(3.0)
    out = []
    for a in arr:
        r = a.request
        out.append((a.t, a.session_id, a.turn, a.turns, list(r.prompt),
                    r.max_new_tokens, r.priority, r.deadline_ms, r.session_id,
                    r.eos_token_id, r.tenant))
        # chain every session's follow-ups (the generator draws fresh user
        # tokens and, lognormal, nothing more)
        f = a
        while True:
            f = gen.followup(f, [1, 2, 3][:f.turn], now_s=f.t + 1.0)
            if f is None:
                break
            out.append(("followup", f.t, f.turn, f.turns, list(f.request.prompt),
                        f.request.max_new_tokens, f.request.priority))
    # closed-loop draws after the trace: prompts and requests
    out.append(gen.prompt_tokens())
    out.append(gen.gen_tokens())
    out.append(list(gen.shared_prefix))
    return out


@pytest.mark.parametrize("kind", sorted(WORKLOADS))
def test_arrivals_identical_to_jax(kind):
    want, got = (_arrivals(s, kind) for s in sides())
    assert len(got) > 3
    assert got == want


def test_workload_config_errors_match_jax():
    for bad in ({"prompt_kind": "nope"}, {"turns_dist": "pareto"},
                {"tenant_mix": (("a", 0.0, 0),)}):
        msgs = []
        for side in sides():
            with pytest.raises(ValueError) as e:
                side.serving.TrafficGenerator(side.serving.WorkloadConfig(**bad))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for bad in ({"process": "nope"}, {"rate_rps": 0.0}):
        msgs = []
        for side in sides():
            with pytest.raises(ValueError) as e:
                side.serving.TrafficGenerator(side.serving.WorkloadConfig(**bad)).arrivals(1.0)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------- #
# scheduler
# --------------------------------------------------------------------------- #
def _pressure(side, vocab, conf, sched_kw, n=7, gen_len=20):
    """``n`` requests through one scheduler on a pool too small for them."""
    eng = side.engine(**conf)
    log = record(eng)
    clock = FakeClock()
    sched = side.serving.ServingScheduler(
        eng, side.serving.SchedulerConfig(clock=clock, **sched_kw))
    handles = [sched.submit(r) for r in requests(side, vocab, n, gen_len=gen_len)]
    ticks = drive(sched, clock)
    assert not eng.state.seqs
    return {"out": outcome(handles), "stats": dict(sched.stats), "log": log,
            "ticks": ticks, "queue_wait": sched.queue_wait_summary(),
            "prefix": dict(eng.state.prefix_stats)}


@pytest.mark.parametrize("case", ["plain", "prefix", "quantum_split"])
def test_pressure_preemption_matches_jax(pair, case):
    """A 9-block pool under 7 requests of up to 44 tokens: admission control
    blocks, the preemption guard parks and resumes, every stream completes
    at full length — identically in both packages (streams, stats, the
    order of admissions / parks / resumes / finishes, queue waits); with
    ``decode_quantum`` 4 and 16-token chunks too."""
    conf = {"ragged": {"memory_config_blocks": 10}}
    kw = {}
    if case == "prefix":
        conf.update(PREFIX)
    if case == "quantum_split":
        conf.update(PREFIX, split_prefill_chunk=16)
        kw = {"decode_quantum": 4}
    want, got = both(pair, _pressure, pair.vocab, conf, kw)
    assert got == want
    s = got["stats"]
    assert s["completed"] == 7 and s["preempted"] >= 1
    assert s["resumed"] == s["preempted"]
    assert all(o["state"] == "done" and len(o["tokens"]) == 20 for o in got["out"])
    calls = [c for c, _ in got["log"]]
    assert "park" in calls and "resume" in calls
    if case == "quantum_split":
        assert s["chunked_admissions"] >= 1


def test_preemption_streams_equal_an_unpressured_run(pair):
    """The port's preempting scheduler emits the streams of an ample pool."""
    side = sides(pair)[1]
    tight = _pressure(side, pair.vocab, {"ragged": {"memory_config_blocks": 10}}, {})
    ample = _pressure(side, pair.vocab, {}, {})
    assert ample["stats"]["preempted"] == 0 and tight["stats"]["preempted"] >= 1
    assert [o["tokens"] for o in tight["out"]] == [o["tokens"] for o in ample["out"]]


def _order(side, vocab):
    rng = np.random.default_rng(3)
    S = side.serving
    res = []
    for kw_a, kw_b in (({"priority": 5}, {"priority": 0}),
                       ({"deadline_ms": 60000.0}, {"deadline_ms": 1000.0})):
        eng = side.engine(ragged={"max_tracked_sequences": 1})
        log = record(eng)
        clock = FakeClock()
        sched = S.ServingScheduler(eng, S.SchedulerConfig(clock=clock))
        mk = lambda **kw: S.Request(prompt=rng.integers(  # noqa: E731
            0, vocab, (12,)).tolist(), **{"max_new_tokens": 4, **kw})
        hs = [sched.submit(mk(max_new_tokens=8)), sched.submit(mk(**kw_a)),
              sched.submit(mk(**kw_b))]
        drive(sched, clock)
        res.append({"out": outcome(hs), "waits": [h.queue_wait_ms for h in hs],
                    "e2e": [h.e2e_ms for h in hs], "log": log})
    return res


def test_priority_and_deadline_order_matches_jax(pair):
    """One slot: the more urgent (then the earlier deadline) of two queued
    requests is admitted first although submitted later."""
    want, got = both(pair, _order, pair.vocab)
    assert got == want
    for r in got:
        assert r["waits"][2] < r["waits"][1]


def _expire_chunked(side, vocab):
    rng = np.random.default_rng(5)
    S = side.serving
    clock = FakeClock()
    eng = side.engine(ragged={"max_tracked_sequences": 1})
    sched = S.ServingScheduler(eng, S.SchedulerConfig(drop_expired=True, clock=clock))
    busy = sched.submit(S.Request(prompt=rng.integers(0, vocab, (10,)).tolist(),
                                  max_new_tokens=8))
    doomed = sched.submit(S.Request(prompt=rng.integers(0, vocab, (10,)).tolist(),
                                    deadline_ms=5.0))
    drive(sched, clock)
    first = {"out": outcome([busy, doomed]), "stats": dict(sched.stats)}
    eng = side.engine(split_prefill_chunk=16)
    log = record(eng)
    sched = S.ServingScheduler(eng, S.SchedulerConfig(clock=clock))
    hs = [sched.submit(S.Request(prompt=rng.integers(0, vocab, (n,)).tolist(),
                                 max_new_tokens=4)) for n in (12, 60, 9, 40)]
    drive(sched, clock)
    return first, {"out": outcome(hs), "stats": dict(sched.stats), "log": log}


def test_drop_expired_and_chunked_admission_match_jax(pair):
    want, got = both(pair, _expire_chunked, pair.vocab)
    assert got == want
    first, second = got
    assert first["out"][1]["state"] == "rejected" and "expired" in first["out"][1]["error"]
    assert first["stats"]["expired"] == 1 and first["out"][1]["slo_met"] is False
    assert second["stats"]["chunked_admissions"] == 2
    assert ("put_split", 2) in second["log"]


def _stream_rejects(side, vocab, max_len):
    rng = np.random.default_rng(4)
    S = side.serving
    eng = side.engine()
    sched = S.ServingScheduler(eng, S.SchedulerConfig(clock=FakeClock()))
    seen, drained = [], []
    h = sched.submit(S.Request(prompt=rng.integers(0, vocab, (10,)).tolist(),
                               max_new_tokens=6), on_token=seen.append)
    while not h.done:
        sched.tick()
        drained += h.drain()
    rej = [sched.submit(S.Request(prompt=[])),
           sched.submit(S.Request(prompt=list(range(max_len))))]
    small = S.ServingScheduler(side.engine(ragged={"memory_config_blocks": 8}),
                               S.SchedulerConfig(clock=FakeClock()))
    rej += [small.submit(S.Request(prompt=list(range(100)))),
            small.submit(S.Request(prompt=list(range(30)), max_new_tokens=200))]
    return {"seen": seen, "drained": drained, "tokens": h.tokens,
            "rejects": outcome(rej), "stats": (dict(sched.stats), dict(small.stats)),
            "events": sched.sched_events(3)}


def test_streaming_and_rejects_match_jax(pair):
    """drain() and on_token stream the same tokens; empty prompts, prompts
    past max_seq_len, prompts larger than the pool and completions that can
    never fit are rejected at submit with the same reasons."""
    want, got = both(pair, _stream_rejects, pair.vocab, pair.tcfg.max_seq_len)
    assert got == want
    assert got["seen"] == got["drained"] == got["tokens"] and len(got["tokens"]) == 6
    reasons = [r["error"] for r in got["rejects"]]
    assert "empty" in reasons[0] and "max_seq_len" in reasons[1]
    assert "pool holds 7" in reasons[2] and "never fit" in reasons[3]
    assert all(r["state"] == "rejected" for r in got["rejects"])
    assert validate_events(got["events"]) == []
    assert {n for n, _, _ in got["events"]} <= SERVING_SERIES


def test_preempt_unknown_uid_raises(pair):
    sched = tserving.ServingScheduler(pair.port())
    with pytest.raises(UnknownSequenceError, match="uid 3"):
        sched.preempt(3)


# --------------------------------------------------------------------------- #
# router
# --------------------------------------------------------------------------- #
def _affinity(side, vocab):
    rng = np.random.default_rng(6)
    S = side.serving
    scheds = [S.ServingScheduler(side.engine(**PREFIX), S.SchedulerConfig(clock=FakeClock()))
              for _ in range(2)]
    router = S.ReplicaRouter(scheds)
    p = rng.integers(0, vocab, (40,)).tolist()
    h1 = router.submit(S.Request(prompt=p, max_new_tokens=6, session_id=70))
    router.run()
    p2 = p + h1.tokens + rng.integers(0, vocab, (5,)).tolist()
    aff = [router.affinity_tokens(i, p2) for i in range(2)]
    h2 = router.submit(S.Request(prompt=p2, max_new_tokens=4, session_id=70))
    router.run()
    hs = [router.submit(S.Request(prompt=rng.integers(0, vocab, (24,)).tolist(),
                                  max_new_tokens=4, session_id=100 + i)) for i in range(4)]
    loads = [router.load(i) for i in range(2)]
    router.run()
    # overload: pile queued work on the affinity replica without ticking it
    router.cfg.load_slack = 2
    for _ in range(4):
        scheds[h1.replica].submit(S.Request(prompt=rng.integers(0, vocab, (10,)).tolist(),
                                            max_new_tokens=2))
    h3 = router.submit(S.Request(prompt=list(p), max_new_tokens=2, session_id=70))
    router.run()
    return {"aff": aff, "out": outcome([h1, h2, h3] + hs), "loads": loads,
            "stats": dict(router.stats), "events": router.router_events(1)}


def test_router_affinity_and_overload_fallback_match_jax(pair):
    """A repeat session lands on the replica holding its prefix; unrelated
    sessions spread by load; an affinity winner past ``load_slack`` loses to
    the least-loaded replica."""
    want, got = both(pair, _affinity, pair.vocab)
    assert got == want
    first = got["out"][0]["replica"]
    assert got["aff"][first] >= 32 and got["aff"][1 - first] == 0
    assert got["out"][1]["replica"] == first
    assert got["out"][2]["replica"] == 1 - first
    assert got["stats"]["affinity_hits"] == 1 and got["stats"]["load_fallbacks"] == 1
    assert all(n > 0 for n in got["loads"])
    assert validate_events(got["events"]) == []
    assert {n for n, _, _ in got["events"]} <= SERVING_SERIES


def _drain(side, vocab):
    S = side.serving
    scheds = [S.ServingScheduler(side.engine(), S.SchedulerConfig(clock=FakeClock()))
              for _ in range(2)]
    logs = [record(s.engine) for s in scheds]
    router = S.ReplicaRouter(scheds, S.RouterConfig(load_slack=100))
    handles = [router.submit(r) for r in requests(side, vocab, 6, seed=8,
                                                  prompt_len=20, gen_len=6)]
    for _ in range(2):
        router.step()
    moved = router.drain(0)
    vacated = not scheds[0].engine.state.seqs
    router.run()
    errs = []
    for idx in (1, 0):
        try:
            router.drain(idx)
        except ValueError as e:
            errs.append(str(e))
    return {"moved": moved, "vacated": vacated, "out": outcome(handles),
            "stats": dict(router.stats), "logs": logs, "errs": errs}


def test_router_drain_rehomes_live_and_queued_match_jax(pair):
    want, got = both(pair, _drain, pair.vocab)
    assert got == want
    assert got["moved"] >= 1 and got["vacated"]
    assert all(o["state"] == "done" and len(o["tokens"]) == 6 for o in got["out"])
    assert "last active replica" in got["errs"][0] and "already drained" in got["errs"][1]


def test_serving_package_exports_match_jax():
    """The port's serving package exports the JAX package's names, minus
    the fleet observability plane's."""
    from deepspeed_tpu.inference import serving as js

    want = {n for n in dir(js) if not n.startswith("_")} - {
        "FleetObsConfig", "FleetObservability", "TraceContext", "annotations"}
    got = {n for n in dir(tserving) if not n.startswith("_")}
    assert want - {"scheduler", "router", "fleet", "disagg", "workload"} <= got
    assert math.isinf(tserving.Request(prompt=[1]).deadline_ms)
