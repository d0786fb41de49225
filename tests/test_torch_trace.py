"""Engine v2's request-trace plane and the span tracer under it — the port
against the JAX package, on the same tiny Llama weights (fp32, CPU).

``percentiles`` gives the same values; the tracer's Chrome-trace export
holds the same events (names, categories, phases, trace / span / parent
ids, args) for the same calls; an engine with ``trace`` on records the same
spans and instants, with the same parent links, as the JAX engine for the
same request sequence (one-shot and split prefill, decode steps and quanta,
speculative verify, park / resume, fork, the scheduler's ticks and
preemptions, the router's failover marks), and the same numbers of latency
samples. Times differ between runs and are not compared; everything else
is, exactly. ``trace`` off and on give identical streams and engine state.
"""

import json

import numpy as np
import pytest
import torch
from _serving_pair import FakeClock, both, outcome, requests
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair, ints

from deepspeed_tpu.telemetry import trace as jtrace
from deepspeed_tpu.telemetry.schema import SERVING_SERIES, validate_events
from deepspeed_tpu_torch.inference import InferenceConfig
from deepspeed_tpu_torch.telemetry import trace as ttrace

TRACE = {"trace": {"enabled": True, "ring_size": 1 << 16, "dump_on_crash": False}}
TIMES = {"ts", "dur", "ts_ns", "dur_ns", "tid", "pid"}


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _events(tracer):
    """The ring without its times: (ph, name, cat, trace, span, parent, args)."""
    return [(r["ph"], r["name"], r["cat"], r["trace"], r["span"], r["parent"],
             {k: v for k, v in r["args"].items() if k not in TIMES})
            for r in tracer.events()]


# --------------------------------------------------------------------------- #
# the tracer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("values", [[], [3.0], [5, 1, 4, 1, 5, 9, 2, 6],
                                    list(np.random.default_rng(0).exponential(3.0, 101))])
def test_percentiles_equal_jax(values):
    qs = (1, 50, 90, 99, 100)
    assert ttrace.percentiles(values, qs) == jtrace.percentiles(values, qs)
    assert ttrace.percentiles(values) == jtrace.percentiles(values)


def _tracer_script(mod, tmp):
    tr = mod.Tracer(mod.TraceConfig(enabled=True, ring_size=20, dump_on_crash=False),
                    name="unit")
    t = tr.new_trace(label="request:1")
    with tr.span("outer", cat="serving", uid=1) as sp:
        with tr.span("inner", k=2):
            tr.instant("mark", v=3)
        sp.set(extra=4)
    b = tr.begin("cross", trace=t, uid=9)
    tr.complete("batch", 10, 30, trace=t, parent=b.span_id, n=2)
    b.end(done=True)
    b.end(again=True)                              # idempotent
    for i in range(20):                            # the ring keeps the last 20
        tr.instant("tick", i=i)
    chrome = tr.to_chrome("unit")
    path = tr.dump("unit", path=str(tmp / f"{mod.__name__}.json"))
    tr.close(dump=False)
    off = mod.Tracer(None)
    null = off.span("x")
    return {"events": _events(tr), "len": len(tr),
            "chrome": [{k: v for k, v in e.items() if k not in TIMES}
                       for e in chrome["traceEvents"]],
            "loaded": len(json.load(open(path))["traceEvents"]),
            "closed": tr.enabled, "off": (off.enabled, off.new_trace("x"), null.span_id,
                                           off.dump("r"), len(off))}


def test_tracer_export_equals_jax(tmp_path):
    """Nested spans, cross-call spans, explicit completes and instants give
    the same ring (bounded to ``ring_size``) and the same Chrome-trace
    events; a disabled tracer records nothing."""
    want = _tracer_script(jtrace, tmp_path)
    got = _tracer_script(ttrace, tmp_path)
    assert got == want
    assert got["len"] == 20 and got["loaded"] == 20 and got["closed"] is False
    assert got["off"] == (False, 0, 0, None, 0)


def test_dump_all_reaches_live_tracers(tmp_path):
    cfg = ttrace.TraceConfig(enabled=True, export_path=str(tmp_path / "f.json"),
                             dump_on_crash=False)
    tr = ttrace.Tracer(cfg, name="live")
    tr.instant("boom")
    assert str(tmp_path / "f.json") in ttrace.dump_all("crash")
    tr.close(dump=False)
    assert str(tmp_path / "f.json") not in ttrace.dump_all("crash")


def test_trace_config_is_one_class_and_ported():
    """``inference.trace`` parses into the tracer's own config class, and
    enabling it no longer raises; ``compile_monitor`` still does."""
    cfg = InferenceConfig.from_dict({"trace": {"enabled": True, "ring_size": 64}})
    assert type(cfg.trace) is ttrace.TraceConfig and cfg.trace.ring_size == 64
    assert cfg.unported_features() == []
    assert InferenceConfig.from_dict(
        {"compile_monitor": {"enabled": True}}).unported_features() == ["compile_monitor"]


# --------------------------------------------------------------------------- #
# engine v2's request-trace plane
# --------------------------------------------------------------------------- #
def _engine_calls(eng, prompts):
    """One-shot and split admissions, decode steps and a quantum, park /
    resume (one-shot and split), fork and finish."""
    out = [eng.put_many([(1, prompts[0]), (2, prompts[1])])]
    eng.put_split(3, prompts[2])
    out += [eng.step() for _ in range(2)]
    out.append(eng.step_many(3))
    parked = eng.park(2)
    out.append(eng.step())
    out.append(eng.resume(parked))
    eng.fork(1, 7)
    out += [eng.step() for _ in range(2)]
    parked = eng.park(3)
    out.append(eng.resume(parked, split=True))
    out += [eng.step() for _ in range(3)]
    out += [eng.finish(u) for u in (7, 1, 2, 3)]
    return out


def _engine_trace(side, prompts, conf):
    eng = side.engine(**conf)
    if conf.get("speculative"):
        out = eng.generate(prompts, max_new_tokens=8)
    elif conf.get("split_prefill_chunk"):
        out = _engine_calls(eng, prompts)
    else:
        out = eng.generate(prompts, max_new_tokens=7, steps_per_sync=3)
    summary = eng.latency_summary()
    return {"out": ints(out) if isinstance(out[0], list) else repr(out),
            "events": _events(eng.tracer),
            "counts": {k: v["count"] for k, v in summary.items()},
            "names": [n for n, _, _ in eng.latency_events(5)]}


CASES = {"generate_quanta": {"split_prefill_chunk": 0},
         "calls": {"split_prefill_chunk": 16, "prefix_cache": {"enabled": True}},
         "spec": {"speculative": {"enabled": True, "max_draft_tokens": 3}}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_spans_and_parents_equal_jax(pair, case):
    """The same request sequence records the same spans, instants and
    parent links in both engines, and the same latency sample counts."""
    rs = np.random.RandomState(7)
    if case == "spec":
        span = rs.randint(0, pair.vocab, 5)
        prompts = [np.tile(span, 4).astype(np.int32), rs.randint(0, pair.vocab, 12)]
    else:
        prompts = [rs.randint(0, pair.vocab, n).astype(np.int32) for n in (9, 20, 41)]
    want, got = both(pair, _engine_trace, prompts, dict(TRACE, **CASES[case]))
    assert got == want
    names = {e[1] for e in got["events"]}
    assert {"request", "queue_wait", "first_token", "decode_token"} <= names
    if case == "calls":
        assert {"prefill_chunk", "parked", "resumed", "decode_quantum"} <= names
        assert got["counts"]["e2e_ms"] == 4.0
    if case == "spec":
        assert "spec_verify" in names
    assert validate_events([(n, 0.0, 5) for n in got["names"]]) == []
    assert set(got["names"]) <= SERVING_SERIES


def _sched_trace(side, vocab):
    S = side.serving
    eng = side.engine(**TRACE, ragged={"memory_config_blocks": 10})
    clock = FakeClock()
    sched = S.ServingScheduler(eng, S.SchedulerConfig(clock=clock))
    hs = [sched.submit(r) for r in requests(side, vocab, 5, gen_len=16)]
    while sched.pending:
        clock.advance(0.01)
        sched.tick()
    # router failover marks land in the first enabled replica's tracer
    scheds = [S.ServingScheduler(side.engine(**TRACE)) for _ in range(2)]
    router = S.ReplicaRouter(scheds, S.RouterConfig(fleet=S.FleetConfig(
        enabled=True, failure_threshold=1, probe_backoff_ticks=3)))
    rh = [router.submit(r) for r in requests(side, vocab, 3, seed=12, gen_len=6)]
    router.step()
    with side.faults.replica_crash(scheds[rh[0].replica]):
        router.step()
    router.run()
    return {"out": outcome(hs + rh), "stats": dict(sched.stats),
            "events": _events(eng.tracer),
            "router_events": [_events(s.tracer) for s in scheds],
            "counts": {k: v["count"] for k, v in eng.latency_summary().items()}}


def test_scheduler_and_router_spans_equal_jax(pair):
    """Scheduler ticks (``sched_tick``), preemptions (``sched_preempt``,
    ``parked``, ``resumed``) and the router's ``circuit_open`` /
    ``failover`` / ``rehome`` / ``circuit_closed`` marks match JAX's."""
    want, got = both(pair, _sched_trace, pair.vocab)
    assert got == want
    names = [e[1] for e in got["events"]]
    assert "sched_tick" in names and "sched_preempt" in names and "resumed" in names
    marks = {e[1] for ev in got["router_events"] for e in ev}
    assert {"circuit_open", "failover", "rehome", "circuit_closed"} <= marks
    assert got["counts"]["e2e_ms"] == 5.0


def test_trace_on_leaves_streams_and_state_unchanged(pair):
    """Tracing is host bookkeeping: the same calls with ``trace`` off and on
    give the same streams, KV pools and allocator state, and tracing off
    records nothing."""
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, pair.vocab, n).astype(np.int32) for n in (9, 20, 41)]
    conf = {"split_prefill_chunk": 16, "prefix_cache": {"enabled": True}}
    engines = [pair.port(**conf), pair.port(**conf, **TRACE)]
    outs = [repr(_engine_calls(e, prompts)) for e in engines]
    assert outs[0] == outs[1]
    off, on = engines
    for k in off.cache:
        assert torch.equal(off.cache[k], on.cache[k])
    assert off.state.prefix_stats == on.state.prefix_stats
    assert off.state.allocator.free_blocks == on.state.allocator.free_blocks
    assert off.forward_log and [f[0] for f in off.forward_log] == [f[0] for f in on.forward_log]
    assert len(off.tracer) == 0 and len(on.tracer) > 0
    assert all(v["count"] == 0 for v in off.latency_summary().values())


def test_export_trace_writes_chrome_json(pair, tmp_path):
    eng = pair.port(**TRACE)
    eng.generate([np.arange(1, 12, dtype=np.int32)], max_new_tokens=3)
    path = eng.export_trace(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    assert doc["otherData"]["tool"] == "deepspeed_tpu_torch.telemetry.trace"
    evs = doc["traceEvents"]
    assert {e["name"] for e in evs} >= {"request", "prefill", "decode_step", "first_token"}
    req = next(e for e in evs if e["name"] == "request")
    assert all(e["args"].get("trace_id") == req["args"]["trace_id"]
               for e in evs if e["name"] in ("prefill", "first_token"))
