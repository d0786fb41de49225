"""Engine v2's serving core, part 2: the prefix cache with copy-on-write,
fork, park / resume and the KV export / import handoff — the PyTorch port
against the JAX engine.

Greedy streams with the prefix cache on are IDENTICAL to those with it off
and to the JAX engine's, alone and crossed with speculative decoding and
int8 KV; shared-block decodes (single steps and quanta), multi-turn reuse
of retained blocks, a fork's copy-on-write of a partial tail, split prefill
from the first uncached token, park / resume and fork are held token for
token against the JAX engine driven the same way. The handoff lands native
payloads bit for bit, and the int8 wire payload of the port is BYTE-EQUAL
to the JAX engine's on the same blocks. A randomized soak checks the
allocator and cache invariants after every engine operation.
"""

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _v2_pair import Pair, ints

from deepspeed_tpu.inference.ragged import StateManager as JStateManager
from deepspeed_tpu_torch.inference import InferenceConfig, SamplingParams, StateManager

SP = SamplingParams(greedy=True)
PREFIX = {"prefix_cache": {"enabled": True}}
MODES = {"plain": {}, "spec": {"speculative": {"enabled": True, "fused_verify": True}},
         "kv_quant": {"kv_quant": {"enabled": True, "group_size": 8}},
         "spec_kv_quant": {"speculative": {"enabled": True, "fused_verify": True},
                           "kv_quant": {"enabled": True, "group_size": 8}}}


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _shared_prompts(pair, seed, shared_len, tails):
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, pair.vocab, shared_len)
    return [np.concatenate([shared, rs.randint(0, pair.vocab, n)]).astype(np.int32)
            for n in tails]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefix_cache_off_is_inert_and_on_matches_jax(pair, mode):
    """``prefix_cache`` defaults OFF and OFF is the engine without the key
    (same streams, model and pools); ON gives the same streams, hits the
    shared prefix, and equals the JAX engine with the cache on."""
    assert InferenceConfig().prefix_cache.enabled is False
    conf = MODES[mode]
    # 3 rounds through 4 slots: later admissions hit the shared 24 tokens
    prompts = _shared_prompts(pair, 1, 24, [9, 3, 17, 5, 12, 30, 1, 8, 6])
    kw = dict(max_new_tokens=6)
    base = pair.port(**conf)
    want = base.generate(prompts, **kw)
    off = pair.port(**conf, prefix_cache={"enabled": False})
    assert off.generate(prompts, **kw) == want
    for k in base.cache:
        assert torch.equal(base.cache[k], off.cache[k])
    on = pair.port(**conf, **PREFIX)
    assert on.generate(prompts, **kw) == want
    assert on.state.prefix_stats["hit_tokens"] >= 24 * 4
    jon = pair.jax(**conf, **PREFIX)
    assert want == ints(jon.generate(prompts, **kw))
    assert on.state.prefix_stats == jon.state.prefix_stats
    on.state.debug_check()
    on.debug_check_cache()


def _drive_shared(eng, pa, pb, quantum=0):
    """Admit pa, decode, admit pb (a prefix hit with the cache on), decode
    both; → (tokens a, tokens b, stats)."""
    eng.put(1, pa, SP)
    for _ in range(1 if quantum else 2):
        eng.step_many(quantum) if quantum else eng.step()
    eng.put(2, pb, SP)
    for _ in range(1 if quantum else 4):
        eng.step_many(quantum) if quantum else eng.step()
    a, b = eng.finish(1), eng.finish(2)
    eng.state.debug_check()
    return [int(t) for t in a], [int(t) for t in b], dict(eng.state.prefix_stats)


@pytest.mark.parametrize("quantum", [0, 4])
def test_shared_block_decode_parity(pair, quantum):
    """Two sequences decoding over the same 3 full prefix blocks (single
    steps, or step_many quanta) give the cache-off tokens and the JAX
    engine's."""
    pa, pb = _shared_prompts(pair, 2, 24, [5, 9])
    a0, b0, s0 = _drive_shared(pair.port(), pa, pb, quantum)
    a1, b1, s1 = _drive_shared(pair.port(**PREFIX), pa, pb, quantum)
    assert s0["hit_tokens"] == 0 and s1["hit_tokens"] == 24
    assert (a1, b1) == (a0, b0)
    ja, jb, js = _drive_shared(pair.jax(**PREFIX), pa, pb, quantum)
    assert (ja, jb) == (a1, b1) and js == s1


def test_retained_reuse_after_retire_and_multiturn(pair):
    """A second turn (prompt + reply + a new message) resolves the first
    turn's blocks, decode-written ones included, from the retained pool."""
    p = pair.prompts([40], seed=4)[0]
    ref, eng = pair.port(), pair.port(**PREFIX)
    want1 = ref.generate([p], max_new_tokens=10)[0]
    assert eng.generate([p], max_new_tokens=10)[0] == want1
    assert eng.state.retained_blocks > 0
    p2 = np.concatenate([p, np.asarray(want1, np.int32), pair.prompts([6], seed=5)[0]])
    want2 = ref.generate([p2], max_new_tokens=5)[0]
    assert eng.generate([p2], max_new_tokens=5)[0] == want2
    assert eng.state.prefix_stats["hit_tokens"] >= 48
    eng.state.debug_check()


def _fork_run(eng, prompt, vocab, steps=2):
    """put, step, fork, inject a different pending token into the child,
    then decode both → (first, second, [per-step outputs], parent, child)."""
    f0 = eng.put(1, prompt, SP)
    f1 = eng.step()[1]
    child = eng.fork(1, 2)
    inj = int((f1 + 1) % vocab)
    child.last_token = inj
    eng._slot_tokens[child.slot] = inj
    outs = [{u: int(t) for u, t in eng.step().items()} for _ in range(steps)]
    return f0, f1, outs, eng.state.seqs[1], child


@pytest.mark.parametrize("quant", [False, True])
def test_fork_cow_partial_shared_block_mid_decode(pair, quant):
    """A fork shares the partially filled tail block; the first divergent
    append copies it on write for the writer, and both continuations are
    the JAX engine's token for token (a missed copy corrupts the sibling's
    KV, a wrong copy the writer's). With int8 KV the copy carries codes and
    scales."""
    conf = dict(PREFIX, **(MODES["kv_quant"] if quant else {}))
    prompt = pair.prompts([20], seed=5)[0]
    eng = pair.port(**conf)
    f0, f1, outs, parent, child = _fork_run(eng, prompt, pair.vocab)
    assert eng.state.prefix_stats["cow_copies"] == 1
    assert parent.blocks[2] != child.blocks[2]         # block 2: positions 16..23
    eng.state.debug_check()
    eng.debug_check_cache()
    jf0, jf1, jouts, _, _ = _fork_run(pair.jax(**conf), prompt, pair.vocab)
    assert (f0, f1, outs) == (int(jf0), int(jf1), jouts)
    # the parent's stream is the unforked run's
    solo = pair.port(**conf)
    solo.put(1, prompt, SP)
    assert [solo.step()[1] for _ in range(3)] == [f1] + [o[1] for o in outs]


def test_fork_child_params_and_spec_over_forked_tail(pair):
    """A fork takes the parent's sampling params unless given its own; a
    greedy spec-decode step over the forked (shared) tail truncates into
    private copies and keeps both streams the JAX engine's."""
    prompt = np.tile(pair.prompts([6], seed=6)[0], 4)  # repetitive: drafts hit
    conf = dict(PREFIX, **MODES["spec"])
    eng, jeng = pair.port(**conf), pair.jax(**conf)
    for e in (eng, jeng):
        e.put(1, prompt, SP)
        e.fork(1, 2)
    assert eng._slot_sp[eng.state.seqs[2].slot] == SP
    for _ in range(4):
        got = eng.step()
        want = jeng.step()
        assert got == {u: [int(t) for t in v] for u, v in want.items()}
        eng.state.debug_check()
    assert eng.spec_stats == jeng.spec_stats
    assert eng.spec_events(3) == jeng.spec_events(3)
    eng.fork(1, 3, sp=SamplingParams(temperature=0.5))
    assert eng._slot_sp[eng.state.seqs[3].slot] == SamplingParams(temperature=0.5)


def test_split_prefill_starts_at_first_uncached_token(pair):
    """A split admission consults the cache: a warm prefix skips its chunks
    and the first token is still the one-shot one."""
    prompt = pair.prompts([64], seed=6)[0]
    eng = pair.port(split_prefill_chunk=16, **PREFIX)
    first_ref = eng.put(1, prompt, SP)                 # warms 7 full blocks (56)
    eng.finish(1)
    eng.put_split(2, prompt, SP)
    assert eng.state.seqs[2].seen_tokens == 56
    assert eng.step() == {2: first_ref}                # one chunk finishes it
    eng.finish(2)
    eng.state.debug_check()


@pytest.mark.parametrize("prefix_on", [False, True])
def test_park_resume_token_parity(pair, prefix_on):
    """A greedy park / resume cycle gives the uninterrupted stream, with the
    cache on (retained blocks resolve the history) and off (full
    re-prefill), and the JAX engine's parked record."""
    conf = PREFIX if prefix_on else {}
    prompt, other = (p.tolist() for p in pair.prompts([40, 20], seed=21))
    ref = pair.port(**conf)
    ref.put(1, prompt, SP)
    for _ in range(6):
        ref.step()
    want = ref.finish(1)
    eng, jeng = pair.port(**conf), pair.jax(**conf)
    for e in (eng, jeng):
        e.put(1, prompt, SP)
        for _ in range(3):
            e.step()
    hr0 = eng.kv_headroom()
    parked, jparked = eng.park(1), jeng.park(1)
    eng.state.debug_check()
    assert eng.kv_headroom()["headroom_blocks"] > hr0["headroom_blocks"]
    assert eng.kv_headroom() == jeng.kv_headroom()
    assert parked["generated"] == want[:4] == [int(t) for t in jparked["generated"]]
    assert parked["history"] == prompt + want[:4]
    eng.put(2, other, SP)                              # churn while parked
    eng.step()
    eng.finish(2)
    assert eng.resume(parked) == [want[4]]
    for _ in range(2):
        eng.step()
    assert eng.finish(1) == want
    eng.state.debug_check()


def test_park_resume_debug_check_invariants(pair):
    """Park mid split prefill, resume split, park mid decode, resume
    one-shot: the invariants hold after every operation and the stream is
    the one-shot one."""
    prompt = pair.prompts([64], seed=22)[0].tolist()
    first_ref = pair.port().put(9, prompt, SP)
    eng = pair.port(split_prefill_chunk=16, **PREFIX)
    eng.put(5, pair.prompts([10], seed=23)[0], SP)     # keeps chunks one a step
    eng.put_split(1, prompt, SP)
    eng.step()
    assert eng.state.seqs[1].prefilling and 0 < eng.state.seqs[1].seen_tokens < 64
    parked = eng.park(1)
    eng.state.debug_check()
    assert parked["generated"] == [] and parked["history"] == prompt
    assert eng.resume(parked, split=True) == []
    out = {}
    while 1 not in out:
        out = eng.step()
        eng.state.debug_check()
    assert out[1] == first_ref
    eng.finish(5)
    for _ in range(2):
        eng.step()
    parked = eng.park(1)
    eng.state.debug_check()
    eng.resume(parked)
    toks = eng.finish(1)
    assert toks[0] == first_ref and len(toks) == 4
    eng.state.debug_check()


def test_set_speculative_and_headroom(pair):
    """set_speculative toggles only what the config configured and returns
    the previous setting; kv_headroom counts as the JAX engine's does."""
    eng = pair.port(**MODES["spec"])
    assert eng.set_speculative(False) is True and eng._spec_on is False
    assert eng.set_speculative(True) is False and eng._spec_on is True
    plain = pair.port()
    assert plain.set_speculative(True) is False and plain._spec_on is False
    assert plain.kv_headroom() == pair.jax().kv_headroom()


def test_truncate_into_forked_tail_cows():
    """The JAX package's truncate-into-a-forked-tail case on both packages'
    StateManager: rolling a fresh fork back into the shared partial tail
    copies it; a fork that already copied on write needs no second copy."""
    results = []
    for cls in (StateManager, JStateManager):
        sm = cls(4, 32, 4, 16, prefix_cache=True)
        d, _ = sm.admit_prompt(1, list(range(10)))
        d.seen_tokens = 10
        sm.mark_filled(d)
        c = sm.fork(1, 2)
        shared_tail = d.blocks[2]
        pairs = sm.truncate(c, 9)
        assert pairs == [(shared_tail, c.blocks[2])] and c.blocks[2] != shared_tail
        assert sm.allocator.refcount(shared_tail) == 1 and d.blocks[2] == shared_tail
        c2 = sm.fork(1, 3)
        sm.ensure_writable(c2, 14)
        sm.extend(c2, n=4)
        c2.tokens.extend([77, 78, 79, 80])
        c2.seen_tokens = 14
        assert sm.truncate(c2, 9) == []
        for uid in (3, 2, 1):
            sm.retire(uid)
        sm.debug_check()
        results.append((pairs, sm.allocator.free_blocks, sm.retained_blocks))
    assert results[0] == results[1]


# --------------------------------------------------------------------------- #
# disaggregated handoff
# --------------------------------------------------------------------------- #
def _prefill_one(eng, prompt, decode=6):
    toks = [int(eng.put(1, prompt, SP))]
    for _ in range(decode):
        toks.append(int(eng.step()[1]))
    return toks


def test_native_wire_roundtrip_and_resume(pair):
    """Native export lands bit for bit in the destination's retained pool,
    re-import is pure dedup, and the parked request resumes there with the
    source's uninterrupted stream."""
    prompt = pair.prompts([40], seed=30)[0].tolist()
    ref = pair.port(**PREFIX)
    want = _prefill_one(ref, prompt, decode=10)
    src, dst = pair.port(**PREFIX), pair.port(**PREFIX)
    _prefill_one(src, prompt)
    hashes = src.kv_chain_hashes(1)
    assert len(hashes) == 5 and dst.resident_prefix(hashes) == 0
    assert src.resident_prefix(hashes) == 5
    exp = src.export_kv_blocks(1, wire="native")
    assert exp["wire_bytes"] == 5 * exp["block_wire_bytes"] > 0
    assert dst.import_kv_blocks(exp["hashes"], exp["blocks"]) == \
        {"imported": 5, "dedup": 0, "dropped": 0}
    assert dst.resident_prefix(hashes) == 5
    for h, payload in zip(exp["hashes"], exp["blocks"]):
        b = dst.state.index._by_hash[h]
        for name in sorted(dst.cache):
            assert np.array_equal(dst.cache[name][:, b].numpy(), payload[name])
    assert dst.import_kv_blocks(exp["hashes"], exp["blocks"]) == \
        {"imported": 0, "dedup": 5, "dropped": 0}
    parked = src.park(1)
    assert dst.resume(parked) == [want[7]]
    assert dst.state.prefix_stats["hit_tokens"] == 40
    for _ in range(3):
        dst.step()
    assert dst.finish(1) == want[:11]
    dst.state.debug_check()
    dst.debug_check_cache()
    # without the cache nothing is resident and nothing can be adopted
    plain = pair.port()
    assert plain.resident_prefix(hashes) == 0
    assert plain.import_kv_blocks(exp["hashes"], exp["blocks"])["dropped"] == 5
    with pytest.raises(ValueError, match="wire"):
        src.export_kv_blocks(2, wire="bf8")


def test_int8_wire_byte_equal_to_jax(pair):
    """On the same blocks (the JAX engine's pools copied into the port's),
    the port's int8 wire payload is byte for byte the JAX engine's, at every
    wire group; its bytes halve the bf16 equivalent's; imported into a float
    pool it dequantizes within half a scale step; a quantized-KV engine's
    native wire is its int8 pools."""
    prompt = pair.prompts([36], seed=31)[0].tolist()
    eng, jeng = pair.port(**PREFIX), pair.jax(**PREFIX)
    assert _prefill_one(eng, prompt) == _prefill_one(jeng, prompt)
    for name in eng.cache:
        eng.cache[name].copy_(torch.from_numpy(np.array(jeng.cache[name])))
    hd = pair.tcfg.head_size
    for group in (8, 16, 64):
        exp = eng.export_kv_blocks(1, wire="int8", wire_group=group)
        jexp = jeng.export_kv_blocks(1, wire="int8", wire_group=group)
        assert exp["hashes"] == jexp["hashes"] and len(exp["blocks"]) == 5
        for key in ("wire_bytes", "bf16_equiv_bytes", "block_wire_bytes", "skip"):
            assert exp[key] == jexp[key], key
        for pay, jpay in zip(exp["blocks"], jexp["blocks"]):
            assert pay.keys() == jpay.keys() == {"k", "v", "k_scale", "v_scale"}
            for n in pay:
                assert pay[n].dtype == jpay[n].dtype and pay[n].shape == jpay[n].shape
                assert pay[n].tobytes() == jpay[n].tobytes(), (group, n)
        ng = hd // min(group, hd)
        assert exp["wire_bytes"] / exp["bf16_equiv_bytes"] == \
            pytest.approx((hd + 4 * ng) / (2 * hd))
    skipped = eng.export_kv_blocks(1, skip=2, wire="int8", wire_group=16)
    assert skipped["hashes"] == exp["hashes"][2:] and len(skipped["blocks"]) == 3
    # into a float pool: within half a step of the group scale
    native = eng.export_kv_blocks(1)
    dst = pair.port(**PREFIX)
    assert dst.import_kv_blocks(exp["hashes"], exp["blocks"])["imported"] == 5
    for h, pay, nat in zip(exp["hashes"], exp["blocks"], native["blocks"]):
        b = dst.state.index._by_hash[h]
        for n in ("k", "v"):
            got = dst.cache[n][:, b].numpy()
            bound = np.repeat(pay[n + "_scale"], hd // ng, axis=-1) / 2
            assert (np.abs(got - nat[n]) <= bound + np.abs(nat[n]) * 1e-6).all()
    # into a quantized pool at another group: re-quantized, consistent
    qdst = pair.port(**PREFIX, **MODES["kv_quant"])
    assert qdst.import_kv_blocks(exp["hashes"], exp["blocks"])["imported"] == 5
    qdst.debug_check_cache()
    # a quantized engine's native wire is int8 already, and imports bitwise
    qsrc = pair.port(**PREFIX, **MODES["kv_quant"])
    _prefill_one(qsrc, prompt)
    qexp = qsrc.export_kv_blocks(1)
    assert qexp["blocks"][0]["k"].dtype == np.int8
    assert qsrc.export_kv_blocks(1, wire="int8")["wire_bytes"] == qexp["wire_bytes"]
    qdst2 = pair.port(**PREFIX, **MODES["kv_quant"])
    qdst2.import_kv_blocks(qexp["hashes"], qexp["blocks"])
    b = qdst2.state.index._by_hash[qexp["hashes"][0]]
    assert np.array_equal(qdst2.cache["k_scale"][:, b].numpy(), qexp["blocks"][0]["k_scale"])


def test_jax_payload_imports_into_the_port(pair):
    """A JAX engine's native (fp32) export lands in the port's pool bit for
    bit and the resumed stream is the JAX engine's — a handoff crosses the
    packages."""
    prompt = pair.prompts([33], seed=32)[0].tolist()
    jeng = pair.jax(**PREFIX)
    want = _prefill_one(jeng, prompt, decode=8)
    jsrc = pair.jax(**PREFIX)
    _prefill_one(jsrc, prompt)
    exp = jsrc.export_kv_blocks(1)
    dst = pair.port(**PREFIX)
    assert dst.import_kv_blocks(exp["hashes"], exp["blocks"])["imported"] == 4
    parked = jsrc.park(1)
    assert dst.resume(parked) == [want[7]]
    assert int(dst.step()[1]) == want[8]


# --------------------------------------------------------------------------- #
# counters and the randomized soak
# --------------------------------------------------------------------------- #
def test_event_lists_match_jax(pair):
    """prefix_cache_events and kv_quant_events carry the JAX engine's names
    and values after the same run (the dequantization bound to fp32
    rounding)."""
    conf = dict(PREFIX, **MODES["kv_quant"])
    prompts = _shared_prompts(pair, 40, 16, [3, 9, 5])
    eng, jeng = pair.port(**conf), pair.jax(**conf)
    assert eng.generate(prompts, max_new_tokens=4) == \
        ints(jeng.generate(prompts, max_new_tokens=4))
    assert eng.prefix_cache_events(2) == jeng.prefix_cache_events(2)
    got, want = eng.kv_quant_events(2), jeng.kv_quant_events(2)
    assert [(n, s) for n, _, s in got] == [(n, s) for n, _, s in want]
    np.testing.assert_allclose([v for _, v, _ in got], [v for _, v, _ in want], rtol=1e-5)
    assert pair.port().kv_quant_events() == []


def test_debug_check_soak(pair):
    """Randomized put / put_split / step / step_many / fork / park / resume
    / finish over a small pool with the prefix cache and int8 KV on: the
    allocator, index and cache invariants hold after every operation."""
    conf = dict(PREFIX, **MODES["kv_quant"], split_prefill_chunk=16,
                ragged={"memory_config_blocks": 40})
    eng = pair.port(**conf)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, pair.vocab, 16).tolist()
    parked, next_uid = [], 0
    for _ in range(60):
        live = [u for u, d in eng.state.seqs.items() if not d.prefilling]
        op = rng.integers(0, 7)
        try:
            if op <= 1 and eng.state.free_slots:
                prompt = shared[:int(rng.integers(0, 17))] + \
                    rng.integers(0, pair.vocab, int(rng.integers(1, 40))).tolist()
                if eng.state.can_admit(len(prompt)):
                    (eng.put_split if op else eng.put)(next_uid, prompt, SP)
                    next_uid += 1
            elif op == 2:
                eng.step()
            elif op == 3:
                eng.step_many(int(rng.integers(1, 5)))
            elif op == 4 and live and eng.state.free_slots:
                eng.fork(int(rng.choice(live)), next_uid)
                next_uid += 1
            elif op == 5 and eng.state.seqs:
                parked.append(eng.park(int(rng.choice(list(eng.state.seqs)))))
            elif op == 6 and parked and eng.state.free_slots:
                p = parked.pop()
                if eng.state.can_admit(len(p["history"])):
                    eng.resume(p, split=bool(rng.integers(0, 2)))
            for uid in list(eng.state.seqs):
                d = eng.state.seqs[uid]
                if d.seen_tokens >= pair.tcfg.max_seq_len - 8 or len(d.generated) > 12:
                    eng.finish(uid)
        except MemoryError:
            pass                              # a full pool refuses, cleanly
        eng.state.debug_check()
        eng.debug_check_cache()
    for uid in list(eng.state.seqs):
        eng.finish(uid)
    eng.state.debug_check()
    assert eng.state.allocator.free_blocks + eng.state.retained_blocks == 39
