"""Disaggregated prefill/decode serving under faults — the port's router
against the JAX package's, on the same tiny Llama weights (fp32, CPU): a
prefill replica and a decode replica crashing mid-pipeline, a KV export
that raises, imports that all fail, and no decode tier left.

Every scenario runs unchanged on both packages (``_serving_pair``): the
streams, ``disagg_stats`` and ``fleet_stats`` are IDENTICAL, and each
stream equals a single engine's fault-free run (token-exact failover and
re-prefill). Tolerance: none — every comparison is exact.
"""

import pytest
from _serving_pair import both, outcome, port_oracle, requests, sides
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair

PREFIX = {"prefix_cache": {"enabled": True}}


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def oracle(pair):
    return port_oracle(pair)


def _reqs(side, vocab, n, seed):
    return requests(side, vocab, n, seed=seed, gen_len=6, prompt_len=(20, 44))


def _tiers(side, n=3, num_prefill=1, fleet=False):
    S = side.serving
    scheds = [S.ServingScheduler(side.engine(**PREFIX)) for _ in range(n)]
    fc = S.FleetConfig(enabled=True, failure_threshold=1,
                       probe_backoff_ticks=10000) if fleet else S.FleetConfig()
    cfg = S.RouterConfig(fleet=fc, disagg=S.DisaggConfig(enabled=True,
                                                         num_prefill=num_prefill))
    return S.ReplicaRouter(scheds, cfg), scheds


def _view(router, handles):
    for s in router.replicas:
        s.engine.state.debug_check()
    return {"out": outcome(handles), "disagg": dict(router.disagg_stats),
            "fleet": dict(router.fleet_stats)}


def _replica_crashes(side, vocab):
    res = {}
    # prefill replica 0 of two dies mid-handoff
    router, scheds = _tiers(side, n=4, num_prefill=2, fleet=True)
    hs = [router.submit(r) for r in _reqs(side, vocab, 4, 53)]
    with side.faults.replica_crash(scheds[0]):
        for _ in range(3):
            router.step()
    router.run()
    res["prefill"] = _view(router, hs)
    # a decode replica dies after the first handoffs
    router, scheds = _tiers(side, n=3, num_prefill=1, fleet=True)
    hs = [router.submit(r) for r in _reqs(side, vocab, 4, 59)]
    for _ in range(2):
        router.step()
    victim = next(h.replica for h in hs if h.replica in (1, 2))
    caught = [k for k, h in enumerate(hs) if h.replica == victim and not h.done]
    with side.faults.replica_crash(scheds[victim]):
        for _ in range(3):
            router.step()
    router.run()
    res["decode"] = dict(_view(router, hs), victim=victim, caught=caught)
    return res


def test_replica_crashes_match_jax(pair, oracle):
    """A dead prefill replica's streams re-prefill on the surviving prefill
    replica and hand off again; a dead decode replica's fail over through
    the prefill tier to the surviving decode replica — token-exact."""
    want, got = both(pair, _replica_crashes, pair.vocab)
    assert got == want
    port = sides()[1]
    for key, seed in (("prefill", 53), ("decode", 59)):
        r = got[key]
        assert [o["tokens"] for o in r["out"]] == oracle(_reqs(port, pair.vocab, 4, seed))
        assert r["fleet"]["failovers"] >= 1
    assert all(o["replica"] in (2, 3) for o in got["prefill"]["out"])
    d = got["decode"]
    assert d["caught"] and all(d["out"][k]["replica"] != d["victim"] for k in d["caught"])


def _seam_faults(side, vocab):
    res = {}
    # the KV export raises on prefill replica 0: a fault like a tick's
    router, scheds = _tiers(side, n=4, num_prefill=2, fleet=True)
    hs = [router.submit(r) for r in _reqs(side, vocab, 3, 61)]
    broken = scheds[0].engine
    orig = broken.export_kv_blocks

    def down(*a, **k):
        raise RuntimeError("export wire down")
    broken.export_kv_blocks = down
    for _ in range(3):
        router.step()
    broken.export_kv_blocks = orig
    router.run()
    res["export"] = _view(router, hs)
    # every import fails: the decode replica re-prefills from history
    router, scheds = _tiers(side, n=2, num_prefill=1)

    def pool_fault(*a, **k):
        raise RuntimeError("import pool fault")
    scheds[1].engine.import_kv_blocks = pool_fault
    hs = [router.submit(r) for r in _reqs(side, vocab, 3, 67)]
    router.run()
    res["import"] = _view(router, hs)
    # no decode tier left: sequences keep decoding where they prefilled
    router, _ = _tiers(side, n=2, num_prefill=1)
    router.drain(1)
    hs = [router.submit(r) for r in _reqs(side, vocab, 3, 71)]
    router.run()
    res["no_decode"] = _view(router, hs)
    return res


def test_export_import_faults_and_no_decode_tier_match_jax(pair, oracle):
    want, got = both(pair, _seam_faults, pair.vocab)
    assert got == want
    port = sides()[1]
    for key, seed in (("export", 61), ("import", 67), ("no_decode", 71)):
        assert [o["tokens"] for o in got[key]["out"]] == oracle(
            _reqs(port, pair.vocab, 3, seed))
    assert got["export"]["fleet"]["tick_faults"] >= 1
    st = got["import"]["disagg"]
    assert st["import_failures"] == st["handoffs"] == 3
    st = got["no_decode"]["disagg"]
    assert st["handoffs"] == 0 and st["handoff_fallbacks"] > 0
    assert all(o["replica"] == 0 for o in got["no_decode"]["out"])
