"""Engine v2's serving core, part 1: ``step_many``, the CUDA-graph decode's
static buffers and split prefill — the PyTorch port against the JAX engine.

Greedy token streams of the port must be IDENTICAL to the JAX engine's on
the same weights, prompts and config (``_v2_pair``): k-token quanta
(``step_many``, ``generate(steps_per_sync=k)``) against k single steps and
against the JAX k-step scan, at the ``max_seq_len`` boundary too; split
prefill against one-shot prefill, with no live decode starved of a token.
``enable_cuda_graph`` and ``split_prefill_chunk`` each have an OFF-is-inert
test (the engine without the key gives the same streams and the same model
and cache state) and an ON-matches-JAX test. On the CPU there is no graph:
the decode forward runs eagerly over the buffers a graph would read, and
the test of its planted fault (lengths not advanced between ticks) holds
the buffers' bookkeeping to the same check the chip smoke makes.
"""

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair, ints

from deepspeed_tpu_torch.inference import SamplingParams

SP = SamplingParams(greedy=True)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def jax_plain(pair):
    """One JAX engine for the plain config, shared: every test drains it."""
    return pair.jax()


def _same_state(a, b) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.cache.keys() == b.cache.keys()
    assert all(torch.equal(a.cache[k], b.cache[k]) for k in a.cache)


def test_step_many_matches_per_step_and_jax(pair, jax_plain):
    """generate(steps_per_sync=k) — k forwards a host sync — gives the
    per-step tokens and the JAX engine's k-step scan's; an EOS inside a
    quantum trims the completion exactly there."""
    prompts = pair.prompts([4, 2, 3, 13, 7])          # 5 prompts, 4 slots
    per_step = pair.port().generate(prompts, max_new_tokens=6)
    eng = pair.port()
    fused = eng.generate(prompts, max_new_tokens=6, steps_per_sync=3)
    assert fused == per_step
    assert fused == ints(jax_plain.generate(prompts, max_new_tokens=6, steps_per_sync=3))
    assert any(kind == "decode_many" for kind, *_ in eng.forward_log)
    eos = per_step[0][2]
    ref_eos = pair.port().generate(prompts, max_new_tokens=6, eos_token_id=eos)
    fused_eos = pair.port().generate(prompts, max_new_tokens=6, eos_token_id=eos,
                                     steps_per_sync=4)
    assert fused_eos == ref_eos
    assert fused_eos[0][-1] == eos and len(fused_eos[0]) == 3


def test_step_many_direct_api(pair, jax_plain):
    """step_many returns {uid: [k tokens]}, reserves all k positions up
    front and advances the length k; the tokens are four single steps' and
    the JAX engine's step_many's."""
    eng = pair.port()
    first = eng.put(0, [5, 7, 11], SP)
    d = eng.state.seqs[0]
    seen0 = d.seen_tokens
    out = eng.step_many(4)
    assert list(out) == [0] and len(out[0]) == 4
    assert d.seen_tokens == seen0 + 4 and len(d.generated) == 5
    eng.state.debug_check()
    eng2 = pair.port()
    assert eng2.put(0, [5, 7, 11], SP) == first
    assert out[0] == [eng2.step()[0] for _ in range(4)]
    assert jax_plain.put(0, [5, 7, 11], SP) == first
    assert [int(t) for t in jax_plain.step_many(4)[0]] == out[0]
    jax_plain.finish(0)
    assert eng.step_many(0) == {}


def test_step_many_context_boundary(pair, jax_plain):
    """At the max_seq_len boundary k is clamped so the last tick writes the
    last position, as the per-step path does; a quantum ends the stream
    exactly where single steps do."""
    prompt = np.arange(pair.tcfg.max_seq_len - 2, dtype=np.int32) % pair.vocab
    ref = pair.port().generate([prompt], max_new_tokens=10)
    eng = pair.port()
    fused = eng.generate([prompt], max_new_tokens=10, steps_per_sync=8)
    assert fused == ref and len(ref[0]) >= 2
    assert fused == ints(jax_plain.generate([prompt], max_new_tokens=10, steps_per_sync=8))
    # a live sequence at seen == max_seq_len has no room: no quantum at all
    eng.put(3, prompt, SP)
    eng.step_many(8)
    assert eng.state.seqs[3].seen_tokens == pair.tcfg.max_seq_len
    assert eng.step_many(8) == {}
    eng.finish(3)


@pytest.mark.parametrize("steps_per_sync", [1, 4])
def test_cuda_graph_off_is_inert_and_on_matches_jax(pair, jax_plain, steps_per_sync):
    """``enable_cuda_graph: false`` is the engine without the key — same
    streams, same model and pools afterwards; on, the streams are the JAX
    engine's. Both engines accept the key and ignore it: the port's decode
    is a graph on any CUDA device, and on the CPU the decode forward runs
    eagerly over the buffers a graph would read."""
    prompts = pair.prompts([9, 3, 17, 5, 12], seed=1)
    kw = dict(max_new_tokens=7, steps_per_sync=steps_per_sync)
    base = pair.port()
    want = base.generate(prompts, **kw)
    off = pair.port(enable_cuda_graph=False)
    assert off.generate(prompts, **kw) == want
    _same_state(base, off)
    on = pair.port(enable_cuda_graph=True)
    assert on.generate(prompts, **kw) == want
    assert want == ints(jax_plain.generate(prompts, **kw))
    assert on.graph_replays == 0 and on._graph is None


def test_decode_buffers_must_advance_between_ticks(pair, monkeypatch):
    """The check the chip smoke makes of a replay whose context-length
    buffer is not advanced, on the CPU's eager decode: a quantum that feeds
    the tokens back but leaves the lengths must not give the per-step
    tokens."""
    prompts = pair.prompts([6, 11], seed=2)
    want = pair.port().generate(prompts, max_new_tokens=8)
    eng = pair.port(enable_cuda_graph=True)
    assert eng.generate(prompts, max_new_tokens=8, steps_per_sync=8) == want

    def stale_lengths(self, nxt):
        self._dec.tokens[:, 0].copy_(nxt)

    monkeypatch.setattr(type(eng), "_advance", stale_lengths)
    assert pair.port().generate(prompts, max_new_tokens=8, steps_per_sync=8) != want


def test_stochastic_step_many_is_per_step_sampling(pair):
    """Tick t of a quantum samples as ``step(seed=seed + t)`` does, so a
    stochastic quantum gives the single steps' draws."""
    sp = SamplingParams(temperature=0.9, top_k=20)
    prompts = pair.prompts([5, 8], seed=3)
    a, b = pair.port(), pair.port()
    a.put_many([(0, prompts[0]), (1, prompts[1])], sp, seed=4)
    b.put_many([(0, prompts[0]), (1, prompts[1])], sp, seed=4)
    quantum = a.step_many(5, seed=11)
    singles = [b.step(seed=11 + t) for t in range(5)]
    assert quantum == {u: [s[u] for s in singles] for u in (0, 1)}


def test_split_prefill_matches_one_shot_and_never_starves(pair):
    """A long prompt admitted with put_split enters the cache one chunk a
    step: its tokens equal the one-shot path's and the JAX engine's split
    path's, and the live short sequence gets a token on every step,
    chunk steps included."""
    long_prompt, short = pair.prompts([100, 8], seed=4)
    ref = pair.port()
    ref.put(1, short, SP)
    ref.put(2, long_prompt, SP)
    for _ in range(6):
        ref.step()
    ref_short, ref_long = ref.finish(1), ref.finish(2)

    eng = pair.port(split_prefill_chunk=32)            # 100 tokens: 4 chunks
    jeng = pair.jax(split_prefill_chunk=32)
    for e in (eng, jeng):
        e.put(1, short, SP)
        e.put_split(2, long_prompt, SP)
    per_step, jper_step = [], []
    first_long = None
    for i in range(10):
        out = eng.step()
        per_step.append(out)
        jper_step.append({u: int(t) for u, t in jeng.step().items()})
        if first_long is None and 2 in out:
            first_long = i
    assert per_step == jper_step
    assert all(1 in out for out in per_step)
    assert first_long == 3
    assert eng.finish(2)[:len(ref_long)] == ref_long
    assert eng.finish(1)[:len(ref_short)] == ref_short
    jeng.finish(1), jeng.finish(2)
    assert sum(kind == "prefill_chunk" for kind, *_ in eng.forward_log) == 4
    eng.state.debug_check()


def test_split_prefill_off_is_inert_and_on_matches_jax(pair, jax_plain):
    """generate() takes the split path for prompts longer than one
    effective chunk; its streams are the one-shot engine's and the JAX
    engine's with the same chunk. ``split_prefill_chunk: 0`` is the engine
    without the key."""
    prompts = pair.prompts([70, 9, 40, 120, 3], seed=5)
    kw = dict(max_new_tokens=5)
    base = pair.port()
    want = base.generate(prompts, **kw)
    off = pair.port(split_prefill_chunk=0)
    assert off.generate(prompts, **kw) == want
    _same_state(base, off)
    assert want == ints(jax_plain.generate(prompts, **kw))
    for spsync in (1, 3):
        on = pair.port(split_prefill_chunk=20)         # 32-token chunks
        got = on.generate(prompts, steps_per_sync=spsync, **kw)
        assert got == want
        assert any(kind == "prefill_chunk" for kind, *_ in on.forward_log)
        jon = pair.jax(split_prefill_chunk=20)
        assert got == ints(jon.generate(prompts, steps_per_sync=spsync, **kw))


def test_split_prefill_drains_when_no_decodes_live(pair):
    """With no live decode the one-chunk bound protects nothing: a split
    prompt completes its whole prefill in one step() (or step_many) call and
    its first token is the one-shot path's."""
    long_prompt = pair.prompts([100], seed=6)[0]
    want = pair.port().put(7, long_prompt, SP)
    for many in (False, True):
        eng = pair.port(split_prefill_chunk=32)
        eng.put_split(7, long_prompt, SP)
        out = eng.step_many(4) if many else eng.step()
        assert out == ({7: [want]} if many else {7: want})
        assert not eng._pending_prefill
        eng.finish(7)
        eng.state.debug_check()


def test_split_admission_respects_speculative_lists(pair):
    """In spec mode every step value is a list, a split prompt's first token
    included."""
    long_prompt = pair.prompts([50], seed=7)[0]
    eng = pair.port(split_prefill_chunk=16, speculative={"enabled": True})
    eng.put_split(1, long_prompt, SP)
    out = eng.step()
    assert list(out) == [1] and isinstance(out[1], list) and len(out[1]) == 1
    assert out[1] == [pair.port().put(1, long_prompt, SP)]
