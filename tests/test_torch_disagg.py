"""Disaggregated prefill/decode serving of the port's router against the
JAX package's, on the same tiny Llama weights (fp32, CPU): two-tier token
identity on the native wire, the int8 wire and int8 pools, shared-prefix
dedup and session-sticky decode placement, an import into an exhausted
pool, and a cross-package handoff (the crash cases are in
``test_torch_disagg_faults.py``).

Every scenario runs unchanged on both packages (``_serving_pair``): the
streams, ``disagg_stats`` (wire bytes, dedup blocks, fallbacks, failures)
and ``fleet_stats`` are IDENTICAL, and on float pools each stream equals a
single engine's fault-free run. The cross-package handoff: a JAX engine's
``export_kv_blocks`` payload (native, and the int8 wire) imports into a
port engine, whose resumed stream continues to the JAX disagg router's.
Tolerance: none — every comparison is exact.
"""

import numpy as np
import pytest
from _serving_pair import both, outcome, port_oracle, requests, sides
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair

from deepspeed_tpu.inference.serving import DisaggConfig as JDisaggConfig
from deepspeed_tpu.telemetry.schema import SERVING_SERIES, validate_events
from deepspeed_tpu_torch.inference import serving as tserving

PREFIX = {"prefix_cache": {"enabled": True}}
KVQ = {"kv_quant": {"enabled": True, "group_size": 8}}


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def oracle(pair):
    return port_oracle(pair)


def _reqs(side, vocab, n, seed):
    return requests(side, vocab, n, seed=seed, gen_len=6, prompt_len=(20, 44))


def _tiers(side, n=3, engine_kw=None, **disagg):
    S = side.serving
    scheds = [S.ServingScheduler(side.engine(**PREFIX, **(engine_kw or {})))
              for _ in range(n)]
    cfg = S.RouterConfig(disagg=S.DisaggConfig(enabled=True, num_prefill=1, **disagg))
    return S.ReplicaRouter(scheds, cfg), scheds


def _view(router, handles):
    for s in router.replicas:
        s.engine.state.debug_check()
    return {"out": outcome(handles), "wire": [h.kv_wire_bytes for h in handles],
            "disagg": dict(router.disagg_stats), "fleet": dict(router.fleet_stats),
            "events": router.disagg_events(4)}


# --------------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------------- #
def test_disagg_config_and_validation_match_jax(pair):
    d = {"enabled": True, "num_prefill": 2, "wire": "int8", "wire_group": 32}
    assert vars(tserving.DisaggConfig.from_dict(d)) == vars(JDisaggConfig.from_dict(d))
    for side in sides(pair):
        S = side.serving
        for bad, msg in (({"num_prefil": 1}, "unknown serving.disagg"),
                         ({"wire": "bf8"}, "wire"),
                         ({"enabled": True, "num_prefill": 0}, "num_prefill"),
                         ({"wire_group": 0}, "wire_group")):
            with pytest.raises(ValueError, match=msg):
                S.DisaggConfig.from_dict(bad)
    side = sides(pair)[1]
    S = side.serving
    two = [S.ServingScheduler(side.engine(**PREFIX)) for _ in range(2)]
    with pytest.raises(ValueError, match="num_prefill"):
        S.ReplicaRouter(two, S.RouterConfig(disagg=S.DisaggConfig(enabled=True,
                                                                  num_prefill=2)))
    nocache = [two[0], S.ServingScheduler(side.engine())]
    with pytest.raises(ValueError, match="prefix_cache"):
        S.ReplicaRouter(nocache, S.RouterConfig(disagg=S.DisaggConfig(enabled=True)))


# --------------------------------------------------------------------------- #
# two tiers: identity, wire formats, dedup, stickiness
# --------------------------------------------------------------------------- #
def _identity(side, vocab, case):
    kw = {"engine_kw": KVQ} if case == "kv_quant" else {}
    if case == "int8_wire":
        kw["wire"] = "int8"
    router, _ = _tiers(side, **kw)
    handles = [router.submit(side.serving.Request(prompt=list(r.prompt),
                                                  max_new_tokens=r.max_new_tokens,
                                                  session_id=k))
               for k, r in enumerate(_reqs(side, vocab, 5, 11))]
    router.run()
    return _view(router, handles)


@pytest.mark.parametrize("case", ["native", "int8_wire", "kv_quant"])
def test_two_tier_streams_match_jax(pair, oracle, case):
    """Every request prefills on the prefill tier and decodes on the decode
    tier, with the same streams, placements, wire bytes and stats as the
    JAX router; native streams equal a single engine's; the int8 wire and
    int8 pools ship (hd + 4 * hd / group) / (2 * hd) of the bf16 bytes."""
    want, got = both(pair, _identity, pair.vocab, case)
    assert got == want
    st = got["disagg"]
    assert st["handoffs"] == 5 and st["import_failures"] == 0
    assert all(o["state"] == "done" and o["replica"] in (1, 2) and o["preemptions"] == 0
               for o in got["out"])
    assert all(w > 0 for w in got["wire"]) and st["wire_bytes"] == sum(got["wire"])
    hd = pair.tcfg.head_size
    if case == "native":
        assert [o["tokens"] for o in got["out"]] == oracle(_reqs(sides()[1], pair.vocab, 5, 11))
        assert st["wire_bytes"] == 2 * st["bf16_equiv_bytes"]          # fp32 pools
    else:
        group = 8 if case == "kv_quant" else hd
        assert st["wire_bytes"] / st["bf16_equiv_bytes"] == pytest.approx(
            (hd + 4 * hd // group) / (2 * hd))
    assert validate_events(got["events"]) == []
    assert {n for n, _, _ in got["events"]} <= SERVING_SERIES


def _dedup_sticky(side, vocab):
    S = side.serving
    gen = S.TrafficGenerator(S.WorkloadConfig(
        seed=23, vocab_size=vocab, prompt_kind="shared_prefix", shared_len=24,
        prompt_len=(8, 16), gen_len=5, deadline_ms=60000.0))
    router, _ = _tiers(side)
    handles = []
    for k in range(4):
        handles.append(router.submit(S.Request(prompt=gen.prompt_tokens(),
                                               max_new_tokens=5, session_id=k)))
        router.run()
    shared = _view(router, handles)
    # multi-turn: turn 2 decodes where turn 1 did, shipping only its suffix
    router, _ = _tiers(side)
    gen = S.TrafficGenerator(S.WorkloadConfig(
        seed=7, vocab_size=vocab, prompt_len=(20, 30), gen_len=5, turns=2,
        deadline_ms=60000.0))
    arr = gen.arrivals(0.4)[:2]
    first = [router.submit(a.request) for a in arr]
    router.run()
    follow = [gen.followup(a, h.tokens, now_s=1.0) for a, h in zip(arr, first)]
    second = [router.submit(f.request) for f in follow]
    router.run()
    return shared, _view(router, first + second)


def test_shared_prefix_dedup_and_sticky_decode_match_jax(pair, oracle):
    want, got = both(pair, _dedup_sticky, pair.vocab)
    assert got == want
    shared, sticky = got
    st = shared["disagg"]
    assert st["dedup_blocks"] > 0
    assert st["dedup_bytes_saved"] == st["dedup_blocks"] * (st["wire_bytes"]
                                                            // st["blocks_shipped"])
    out = sticky["out"]
    assert [o["replica"] for o in out[2:]] == [o["replica"] for o in out[:2]]
    assert sticky["disagg"]["dedup_blocks"] > 0


# --------------------------------------------------------------------------- #
# engine seams
# --------------------------------------------------------------------------- #
def _exhausted(side, vocab):
    src = side.engine(**PREFIX)
    dst = side.engine(prefix_cache={"enabled": True, "max_retained_blocks": 0})
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, vocab, 40)]
    src.put(1, prompt)
    for _ in range(6):
        src.step()
    exp = src.export_kv_blocks(1)
    res = dst.import_kv_blocks(exp["hashes"], exp["blocks"])
    dst.state.debug_check()
    return res, len(exp["blocks"]), exp["wire_bytes"]


def test_import_into_exhausted_pool_drops_as_in_jax(pair):
    """Retention cap 0: adopted blocks cannot park in the retained pool, so
    every block is dropped (the resume re-prefills), none leaked."""
    want, got = both(pair, _exhausted, pair.vocab)
    assert got == want
    res, n, _ = got
    assert res == {"imported": 0, "dedup": 0, "dropped": n} and n > 0


def test_disagg_off_is_the_single_tier_router(pair, oracle):
    side = sides(pair)[1]
    S = side.serving
    router = S.ReplicaRouter([S.ServingScheduler(side.engine(**PREFIX)) for _ in range(2)])
    reqs = _reqs(side, pair.vocab, 4, 41)
    hs = [router.submit(r) for r in reqs]
    router.run()
    assert [h.tokens for h in hs] == oracle(reqs)
    assert not router._prefill_tier and router.disagg_events() == []
    assert all(v == 0 for v in router.disagg_stats.values())
    assert all(h.kv_wire_bytes == 0 for h in hs)


# --------------------------------------------------------------------------- #
# a JAX engine's payload continues in the port
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_jax_payload_continues_in_the_port_to_the_jax_router_stream(pair, wire):
    """The JAX disagg router serves one request; a JAX engine does what its
    prefill replica did (the prefill and one decode step of a tick) and
    exports the blocks; a port engine imports them, resumes the parked
    request as a prefix hit and decodes: the port's stream is the JAX
    router's, token for token."""
    jside, tside = sides(pair)
    req = _reqs(jside, pair.vocab, 1, 83)[0]
    router, _ = _tiers(jside, wire=wire)
    h = router.submit(req)
    router.run()
    want = [int(t) for t in h.tokens]
    src = jside.engine(**PREFIX)
    first = [int(src.put(1, req.prompt)), int(src.step()[1])]
    exp = src.export_kv_blocks(1, wire=wire, wire_group=64)
    parked = src.park(1)
    dst = tside.engine(**PREFIX)
    imp = dst.import_kv_blocks(exp["hashes"], exp["blocks"])
    assert imp["imported"] == len(exp["blocks"]) > 0
    hits0 = dst.state.prefix_stats["hit_tokens"]
    parked = dict(parked, sp=tserving.Request(prompt=[1]).sp)
    toks = first + dst.resume(parked)
    assert dst.state.prefix_stats["hit_tokens"] - hits0 == \
        len(exp["blocks"]) * dst.state.block_size
    while len(toks) < req.max_new_tokens:
        toks.append(dst.step()[1])
    assert toks == want
    dst.state.debug_check()
