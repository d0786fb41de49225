"""Fleet fault tolerance of the port's router against the JAX package's, on
the same tiny Llama weights (fp32, CPU) and fake clocks: circuit breakers
over injected crashes, hangs, flaky and slow ticks, failover with
token-exact exactly-once replay, half-open probes, the degradation ladder,
the submit-time admission fallback, mid-split-prefill re-homing and a
seeded chaos soak.

Every scenario runs unchanged on both packages (``_serving_pair``); the
streams, ``fleet_stats``, router ``stats``, breaker states and ladder
levels are IDENTICAL, and each completed stream equals a fault-free run's
(token-exact) and what its ``on_token`` callback saw (exactly once).
Tolerance: none — every comparison is exact. The ``serving.fleet`` block
off is the bare router; ``serving.obs`` and ``serving.tuning`` parse as in
the JAX package and refuse to be enabled.
"""

import dataclasses
import math

import numpy as np
import pytest
from _serving_pair import FakeClock, both, outcome, port_oracle, requests, sides
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair

from deepspeed_tpu.inference.serving import RouterConfig as JRouterConfig
from deepspeed_tpu.telemetry.schema import SERVING_SERIES, validate_events
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.inference.serving.fleet import CLOSED, HALF_OPEN, OPEN

PREFIX = {"prefix_cache": {"enabled": True}}


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def oracle(pair):
    return port_oracle(pair)


def _router(side, n=2, fleet=None, scheds=None, **kw):
    S = side.serving
    scheds = scheds or [S.ServingScheduler(side.engine(**PREFIX)) for _ in range(n)]
    cfg = S.RouterConfig(fleet=S.FleetConfig(**fleet) if fleet is not None
                         else S.FleetConfig(), **kw)
    return S.ReplicaRouter(scheds, cfg), scheds


def _fleet_view(router):
    return {"fleet_stats": dict(router.fleet_stats), "stats": dict(router.stats),
            "breakers": [(b.state, b.opens) for b in router._health],
            "ladders": [(lad.level, lad.shifts) for lad in router._ladders],
            "events": router.fleet_events(2)}


# --------------------------------------------------------------------------- #
# config and breaker
# --------------------------------------------------------------------------- #
ROUTER_DICTS = [
    {},
    {"load_slack": 4, "fleet": {"enabled": True, "failure_threshold": 2,
                                "tick_deadline_s": 0.5}},
    {"affinity": False, "disagg": {"enabled": True, "num_prefill": 2, "wire": "int8",
                                   "wire_group": 32}},
    {"obs": {"burn_threshold": 4, "slo_targets": {"gold": 0.9},
             "tsdb": {"resolution_s": 0.5, "levels": 2}}},
    {"tuning": {"knobs": ["decode_quantum"], "steps_per_arm": 4, "seed": 3}},
]


def _plain(cfg):
    d = dataclasses.asdict(cfg)
    for block in ("fleet", "obs"):
        d[block].pop("clock")
    return d


@pytest.mark.parametrize("i", range(len(ROUTER_DICTS)))
def test_router_config_parses_as_in_jax(i):
    """A config dict naming any block (fleet, disagg, obs with its tsdb,
    tuning) builds the same config as in the JAX package."""
    d = ROUTER_DICTS[i]
    assert _plain(tserving.RouterConfig.from_dict(d)) == _plain(JRouterConfig.from_dict(d))


def test_config_errors_match_jax():
    for side in sides():
        S = side.serving
        with pytest.raises(ValueError, match="serving.fleet"):
            S.FleetConfig.from_dict({"failure_treshold": 2})
        with pytest.raises(ValueError, match="router"):
            S.RouterConfig.from_dict({"load_slak": 1})
        with pytest.raises(ValueError, match="serving.obs"):
            S.RouterConfig.from_dict({"obs": {"burn": 1}})
        with pytest.raises(ValueError, match="serving.obs.tsdb"):
            S.RouterConfig.from_dict({"obs": {"tsdb": {"res": 1}}})
        with pytest.raises(ValueError, match="tuning option"):
            S.RouterConfig.from_dict({"tuning": {"knob": 1}})


@pytest.mark.parametrize("block", ["obs", "tuning"])
def test_enabled_obs_and_tuning_are_refused(pair, block):
    """``serving.obs`` / ``serving.tuning`` enabled raise when the router is
    built, naming the block; disabled they build the bare router."""
    cfg = tserving.RouterConfig.from_dict({block: {"enabled": True}})
    assert cfg.unported_features() == [f"serving.{block}"]
    sched = tserving.ServingScheduler(pair.port())
    with pytest.raises(NotImplementedError, match=f"serving.{block}"):
        tserving.ReplicaRouter([sched], cfg)
    tserving.ReplicaRouter([sched], tserving.RouterConfig.from_dict({block: {}}))


def _breaker_walk(side, script):
    S = side.serving
    br = S.CircuitBreaker(S.FleetConfig(failure_threshold=3, probe_backoff_ticks=2,
                                        backoff_multiplier=2.0, max_backoff_ticks=8))
    out = []
    for op in script:
        r = {"f": br.record_failure, "s": br.record_success, "p": br.allow_probe}[op]()
        out.append((op, r, br.state, br.opens, br.cooldown))
    return out


def test_circuit_breaker_state_machine_matches_jax():
    """CLOSED → OPEN after 3 consecutive faults (a success resets the
    count), half-open after the backoff, CLOSED on a passing probe, OPEN
    again with the backoff doubled (capped) on a failing one."""
    script = "ffsfff" + "pp" + "f" + "pppp" + "s" + "fff" + "pp" + "fpppp" + "fpppppppp" + "s"
    want, got = (_breaker_walk(s, script) for s in sides())
    assert got == want
    states = [st for _, _, st, _, _ in got]
    assert OPEN in states and HALF_OPEN in states and states[-1] == CLOSED


# --------------------------------------------------------------------------- #
# default OFF: the bare router
# --------------------------------------------------------------------------- #
def _default_off(side, vocab):
    reqs = requests(side, vocab, 5, seed=5, gen_len=8, prompt_len=(10, 28))
    router, scheds = _router(side)
    handles = [router.submit(r) for r in reqs]
    raised = None
    with side.faults.replica_crash(scheds[0]):
        try:
            router.step()
        except side.faults.ReplicaCrash as e:
            raised = str(e)
    router.run()
    return {"raised": raised, "out": outcome(handles), **_fleet_view(router),
            "clamps": [s.degrade_max_new_tokens for s in scheds]}


def test_fleet_off_is_the_bare_router_and_matches_jax(pair, oracle):
    """Fleet off (the default): a tick error propagates to the caller,
    breakers, ladders and fleet events stay untouched, streams equal a
    plain scheduler's."""
    want, got = both(pair, _default_off, pair.vocab)
    assert got == want
    assert got["raised"] and "injected replica crash" in got["raised"]
    assert got["events"] == [] and all(v == 0 for v in got["fleet_stats"].values())
    assert all(b == (CLOSED, 0) for b in got["breakers"])
    assert all(lv == (0, 0) for lv in got["ladders"]) and got["clamps"] == [None, None]
    reqs = requests(sides()[1], pair.vocab, 5, seed=5, gen_len=8, prompt_len=(10, 28))
    assert [o["tokens"] for o in got["out"]] == oracle(reqs)


# --------------------------------------------------------------------------- #
# crash, hang, flaky, slow, half-open
# --------------------------------------------------------------------------- #
def _crash(side, vocab):
    reqs = requests(side, vocab, 6, seed=11, gen_len=8, prompt_len=(10, 28))
    router, scheds = _router(side, fleet=dict(enabled=True, failure_threshold=2,
                                              probe_backoff_ticks=50))
    streams = [[] for _ in reqs]
    handles = [router.submit(r, on_token=streams[k].append) for k, r in enumerate(reqs)]
    for _ in range(2):
        router.step()
    victim = handles[0].replica
    with side.faults.replica_crash(scheds[victim]) as st:
        router.run()
    scheds[1 - victim].engine.state.debug_check()
    return {"victim": victim, "crashes": st["crashes"], "out": outcome(handles),
            "streams": streams, **_fleet_view(router)}


def test_crash_failover_token_exact_exactly_once(pair, oracle):
    want, got = both(pair, _crash, pair.vocab)
    assert got == want
    assert got["crashes"] >= 2
    assert all(o["state"] == "done" for o in got["out"])
    toks = [o["tokens"] for o in got["out"]]
    assert toks == oracle(requests(sides()[1], pair.vocab, 6, seed=11, gen_len=8,
                                   prompt_len=(10, 28)))
    assert got["streams"] == toks                     # exactly once
    fs = got["fleet_stats"]
    assert fs["failovers"] >= 1 and fs["circuit_open"] >= 1 and fs["replayed_tokens"] > 0
    assert got["breakers"][got["victim"]][0] != CLOSED
    assert validate_events(got["events"]) == []
    assert {n for n, _, _ in got["events"]} <= SERVING_SERIES


def _hang_flaky(side, vocab):
    reqs = requests(side, vocab, 4, seed=13, gen_len=8, prompt_len=(10, 28))
    clock = FakeClock()
    router, scheds = _router(side, fleet=dict(
        enabled=True, failure_threshold=2, tick_deadline_s=0.01,
        probe_backoff_ticks=100, clock=clock))
    handles = [router.submit(r) for r in reqs]
    router.step()
    victim = handles[0].replica
    with side.faults.replica_hang(scheds[victim], seconds=0.03,
                                  advance=clock.advance) as st:
        for _ in range(3):
            router.step()
    mid = _fleet_view(router)
    router.run()
    hang = {"hangs": st["hangs"], "victim": victim, "mid": mid,
            "out": outcome(handles), **_fleet_view(router)}
    # flaky (below the consecutive threshold) and slow-but-under-deadline
    reqs = requests(side, vocab, 4, seed=23, gen_len=6, prompt_len=(10, 28))
    clock = FakeClock()
    router, scheds = _router(side, fleet=dict(
        enabled=True, failure_threshold=3, tick_deadline_s=0.5,
        slow_tick_s=0.001, clock=clock))
    handles = [router.submit(r) for r in reqs]
    with side.faults.flaky_tick(scheds[0], fail_every=3) as fl, \
            side.faults.slow_replica(scheds[1], seconds=0.005,
                                     advance=clock.advance) as sl:
        router.run()
    return hang, {"failures": fl["failures"], "slow": sl["slow"],
                  "out": outcome(handles), **_fleet_view(router)}


def test_hang_flaky_and_slow_ticks_match_jax(pair, oracle):
    """A replica whose ticks blow ``tick_deadline_s`` opens its breaker and
    fails over; flaky ticks below the threshold and slow ticks under the
    deadline degrade telemetry, not availability."""
    want, got = both(pair, _hang_flaky, pair.vocab)
    assert got == want
    hang, flaky = got
    assert hang["hangs"] >= 2 and hang["mid"]["fleet_stats"]["tick_faults"] >= 2
    assert hang["mid"]["breakers"][hang["victim"]][0] == OPEN
    assert hang["fleet_stats"]["failovers"] == 1
    assert all(o["replica"] == 1 - hang["victim"] for o in hang["out"])
    port = sides()[1]
    assert [o["tokens"] for o in hang["out"]] == oracle(
        requests(port, pair.vocab, 4, seed=13, gen_len=8, prompt_len=(10, 28)))
    assert flaky["failures"] >= 1 and flaky["slow"] >= 1
    assert all(b[0] == CLOSED for b in flaky["breakers"])
    fs = flaky["fleet_stats"]
    assert fs["circuit_open"] == 0 and fs["failovers"] == 0 and fs["slow_ticks"] >= 1
    assert fs["tick_faults"] >= flaky["failures"]
    assert [o["tokens"] for o in flaky["out"]] == oracle(
        requests(port, pair.vocab, 4, seed=23, gen_len=6, prompt_len=(10, 28)))


def _probe(side, vocab):
    router, scheds = _router(side, fleet=dict(enabled=True, failure_threshold=1,
                                              probe_backoff_ticks=3))
    mk = lambda seed: requests(side, vocab, 1, seed=seed, gen_len=8,  # noqa: E731
                               prompt_len=(10, 28))[0]
    h0 = router.submit(mk(17))
    router.step()
    victim = h0.replica
    with side.faults.replica_crash(scheds[victim]):
        router.step()
    opened = _fleet_view(router)
    h1 = router.submit(mk(18))
    for _ in range(5):
        router.step()
    closed = _fleet_view(router)
    hs = [router.submit(mk(19 + k)) for k in range(4)]
    router.run()
    # sole replica: requeue on itself, shed at the door while dark, recover
    sched = side.serving.ServingScheduler(side.engine(**PREFIX))
    solo, _ = _router(side, fleet=dict(enabled=True, failure_threshold=1,
                                       probe_backoff_ticks=2), scheds=[sched])
    sh = [solo.submit(r) for r in requests(side, vocab, 3, seed=29, gen_len=5)]
    solo.step()
    with side.faults.replica_crash(sched):
        solo.step()
        dark = solo.submit(mk(31))
    solo.run()
    sched.engine.state.debug_check()
    return {"victim": victim, "opened": opened, "closed": closed,
            "out": outcome([h0, h1] + hs), **_fleet_view(router),
            "solo": outcome(sh + [dark]), "solo_view": _fleet_view(solo)}


def test_half_open_probe_and_sole_replica_match_jax(pair):
    """An open replica gets no new work; after the backoff the half-open
    probe finds it healthy and closes the breaker. A sole replica re-queues
    its requests on itself, sheds new ones while dark, and drains after its
    probe passes."""
    want, got = both(pair, _probe, pair.vocab)
    assert got == want
    v = got["victim"]
    assert got["opened"]["breakers"][v][0] == OPEN
    assert got["out"][1]["replica"] == 1 - v
    assert got["closed"]["breakers"][v][0] == CLOSED
    assert got["closed"]["fleet_stats"]["circuit_closed"] == 1
    assert got["closed"]["fleet_stats"]["probe_ticks"] >= 1
    assert all(o["state"] == "done" for o in got["out"])
    dark = got["solo"][-1]
    assert dark["state"] == "rejected" and "no healthy replica" in dark["error"]
    assert all(o["state"] == "done" for o in got["solo"][:-1])
    assert got["solo_view"]["breakers"] == [(CLOSED, 1)]


# --------------------------------------------------------------------------- #
# degradation ladder, admission fallback, mid-split re-home
# --------------------------------------------------------------------------- #
def _ladder(side, vocab):
    rng = np.random.default_rng(7)
    S = side.serving
    sched = S.ServingScheduler(side.engine(
        **PREFIX, ragged={"memory_config_blocks": 20, "max_tracked_sequences": 3},
        speculative={"enabled": True, "max_draft_tokens": 3}))
    eng = sched.engine
    router, _ = _router(side, fleet=dict(enabled=True, queue_high=4, queue_low=1,
                                         up_ticks=1, down_ticks=3, shed_priority=2,
                                         clamp_max_new_tokens=4), scheds=[sched])
    handles = [router.submit(S.Request(prompt=rng.integers(0, vocab, (20,)).tolist(),
                                       max_new_tokens=30, priority=0 if k % 2 == 0 else 3))
               for k in range(16)]
    levels, spec, clamp = [], [], []
    for _ in range(6):
        router.step()
        levels.append(router._ladders[0].level)
        spec.append(eng._spec_on)
        clamp.append(sched.degrade_max_new_tokens)
    late = router.submit(S.Request(prompt=[1, 2, 3, 4], max_new_tokens=4, priority=5))
    router.run()
    for _ in range(12):
        router.step()
    eng.state.debug_check()
    return {"levels": levels, "spec": spec, "clamp": clamp, "late": outcome([late]),
            "out": outcome(handles), "spec_after": eng._spec_on,
            "clamp_after": sched.degrade_max_new_tokens, **_fleet_view(router)}


def test_degradation_ladder_matches_jax(pair):
    """Under queue pressure the ladder sheds low-priority admissions (1),
    turns speculative decoding off (2) and clamps new admissions (3), then
    eases back to 0, restoring speculation exactly; urgent requests all
    complete."""
    want, got = both(pair, _ladder, pair.vocab)
    assert got == want
    assert got["levels"][0] >= 1 and max(got["levels"]) == 3
    assert False in got["spec"] and 4 in got["clamp"]
    assert got["late"][0]["state"] == "rejected"
    assert "overload degradation" in got["late"][0]["error"]
    shed = [o for o in got["out"] if o["state"] == "rejected"]
    assert shed and all("overload degradation" in o["error"] for o in shed)
    assert all(o["state"] == "done" for o in got["out"][::2])
    assert 4 in {len(o["tokens"]) for o in got["out"] if o["state"] == "done"}
    assert got["ladders"][0][0] == 0 and got["spec_after"] is True
    assert got["clamp_after"] is None
    assert got["fleet_stats"]["shed_requests"] >= len(shed)


def _fallback_split(side, vocab):
    rng = np.random.default_rng(9)
    S = side.serving
    small = S.ServingScheduler(side.engine(**PREFIX, ragged={"memory_config_blocks": 8}))
    big = S.ServingScheduler(side.engine(**PREFIX))
    router, _ = _router(side, scheds=[small, big])
    for k in range(2):
        big.submit(S.Request(prompt=rng.integers(0, vocab, (10,)).tolist(),
                             max_new_tokens=2, uid=900 + k))
    h = router.submit(S.Request(prompt=rng.integers(0, vocab, (80,)).tolist(),
                                max_new_tokens=4))
    h2 = router.submit(S.Request(prompt=list(range(130)), max_new_tokens=4))
    router.run()
    res = {"out": outcome([h, h2]), "stats": dict(router.stats)}
    # mid-split-prefill re-home (drain, then fail_over) re-enters chunking
    shorts = [rng.integers(0, vocab, (10,)).tolist() for _ in range(2)]
    prompt = rng.integers(0, vocab, (64,)).tolist()
    for mode in ("drain", "fail_over"):
        scheds = [S.ServingScheduler(side.engine(**PREFIX, split_prefill_chunk=16))
                  for _ in range(2)]
        router, _ = _router(side, scheds=scheds, load_slack=100, fleet=dict(
            enabled=True, failure_threshold=1, probe_backoff_ticks=100))
        for p in shorts:
            router.submit(S.Request(prompt=list(p), max_new_tokens=8))
        h = router.submit(S.Request(prompt=list(prompt), max_new_tokens=4))
        router.step()
        src = h.replica
        seen0 = scheds[src].engine.state.seqs[h.uid].seen_tokens
        if mode == "drain":
            router.drain(src)
        else:
            with side.faults.replica_crash(scheds[src]):
                router.step()
        router.step()
        dd = scheds[h.replica].engine.state.seqs.get(h.uid)
        mid = (dd is not None and dd.prefilling, dd.seen_tokens if dd else None)
        router.run()
        res[mode] = {"src": src, "seen0": seen0, "mid": mid, "out": outcome([h]),
                     **_fleet_view(router)}
    return res


def test_admission_fallback_and_mid_split_rehome_match_jax(pair):
    """A request the least-loaded replica must reject lands on one that can
    serve it; a request re-homed mid-split-prefill re-enters the chunked
    path on its destination and finishes with the fault-free stream."""
    want, got = both(pair, _fallback_split, pair.vocab)
    assert got == want
    assert got["out"][0]["replica"] == 1 and got["stats"]["reject_fallbacks"] == 1
    assert got["out"][1]["state"] == "rejected" and got["out"][1]["error"]
    assert got["out"][0]["state"] == "done"
    for mode in ("drain", "fail_over"):
        r = got[mode]
        assert 0 < r["seen0"] < 64
        assert r["mid"][0] and r["mid"][1] < 64
        assert r["out"][0]["replica"] == 1 - r["src"]
    assert got["drain"]["out"][0]["tokens"] == got["fail_over"]["out"][0]["tokens"]
    assert got["fail_over"]["fleet_stats"]["failovers"] == 1


# --------------------------------------------------------------------------- #
# chaos soak
# --------------------------------------------------------------------------- #
def _soak(side, vocab):
    S = side.serving
    wl = S.WorkloadConfig(seed=41, vocab_size=vocab, prompt_len=(8, 24),
                          gen_len=(3, 8), deadline_ms=math.inf)
    gen = S.TrafficGenerator(wl)
    reqs = [gen.request() for _ in range(24)]
    clock = FakeClock()
    router, scheds = _router(side, fleet=dict(
        enabled=True, failure_threshold=1, probe_backoff_ticks=4,
        tick_deadline_s=0.02, degrade=False, clock=clock))
    streams = {}
    orig_submit = router.submit

    def submit(req):
        streams[len(streams)] = tap = []
        return orig_submit(req, on_token=tap.append)

    router.submit = submit
    rep = side.faults.chaos_soak(router, reqs, seed=7, submits_per_step=2,
                                 fault_rate=0.10, crash_ticks=(3, 8), hang_s=0.05,
                                 advance=clock.advance)
    for s in scheds:
        s.engine.state.debug_check()
    return {"faults": rep["faults"], "steps": rep["steps"],
            "out": outcome(rep["handles"]), "streams": [streams[k] for k in sorted(streams)],
            **_fleet_view(router)}


def test_chaos_soak_matches_jax_zero_lost_token_exact(pair, oracle):
    """A seeded trace under seeded crash and hang injection: the same fault
    schedule and the same outcome in both packages; no request is lost,
    every stream equals the fault-free run's and its callback's."""
    want, got = both(pair, _soak, pair.vocab)
    assert got == want
    assert {f["kind"] for f in got["faults"]} >= {"crash"}
    assert all(o["state"] == "done" for o in got["out"]) and len(got["out"]) == 24
    assert got["fleet_stats"]["failovers"] >= 1
    port = sides()[1]
    S = port.serving
    gen = S.TrafficGenerator(S.WorkloadConfig(seed=41, vocab_size=pair.vocab,
                                              prompt_len=(8, 24), gen_len=(3, 8)))
    toks = [o["tokens"] for o in got["out"]]
    assert toks == oracle([gen.request() for _ in range(24)])
    assert got["streams"] == toks
