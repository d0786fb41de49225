"""Speculative decoding with fused verification: the PyTorch port against
the JAX package.

- ``prompt_lookup_draft``: the JAX unit cases, and the same drafts as the
  JAX function on random histories.
- Op ``paged_spec_verify_attention`` (plain version) against the JAX Pallas
  kernel in interpret mode and ``paged_spec_verify_attention_xla``, on the
  same numpy inputs (fp32 and int8 pools with 1 or 4 scale groups, windows
  none / static / tensor, t = 1..5 rows, ``ctx + t - 1`` across a block
  edge, a ctx 0 slot on the trash block) at ``tests/test_kv_quant.py``'s
  tolerance (rtol 2e-5, atol 2e-6).
- The engine: greedy streams and ``spec_stats`` identical to the JAX
  ``engine_v2`` in fp32 for {kv_quant}, {speculative}, {speculative +
  fused_verify} and all three; greedy spec identical to plain greedy decode;
  ``speculative`` and ``fused_verify`` OFF inert. On a deterministic stub
  family (the JAX tests' pattern model): full acceptance emits k + 1 tokens
  a step, partial rejection rolls back and stays exact, the max_seq_len
  edge; stochastic acceptance by distribution (the rejection-sampling
  identity), never by stream: torch and JAX draw different numbers.
- ``filter_logits_batch`` against the JAX function (fp32 1e-6).
"""

import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu.comm import mesh as mesh_lib
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.engine import ModelFamily as JFamily
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.engine_v2 import prompt_lookup_draft as jdraft
from deepspeed_tpu.inference.sampling import filter_logits as jfilter
from deepspeed_tpu.inference.sampling import filter_logits_batch as jfilter_batch
from deepspeed_tpu.inference.sampling import SamplingParams as JSP
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_spec_verify_attention, paged_spec_verify_attention_xla)
from deepspeed_tpu_torch.inference import (SamplingParams, build_engine_v2,
                                           filter_logits, filter_logits_batch,
                                           prompt_lookup_draft, sp_arrays)
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import from_jax_params
from deepspeed_tpu_torch.ops import registry
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_spec_verify_attention_cuda, paged_spec_verify_attention_torch)

SP = SamplingParams(greedy=True)
RAGGED = {"max_tracked_sequences": 3, "max_ragged_batch_size": 3,
          "memory_config_blocks": 40, "block_size": 8}
SPEC = {"enabled": True, "max_draft_tokens": 4}


def config(**kw):
    return dict({"dtype": "float32", "prefill_bucket": 16, "ragged": RAGGED}, **kw)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny(max_seq_len=96)
    tcfg = tllama.LlamaConfig.tiny(max_seq_len=96)
    params = jax.tree.map(np.asarray, jllama.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params


def jax_engine(jcfg, params, conf):
    mesh_lib.set_mesh(None)
    return JEngine(JFamily.from_module(jllama, jcfg), params, JConfig.from_dict(conf),
                   init_paged_cache=partial(jllama.init_paged_cache, dtype=jnp.float32),
                   apply_paged=partial(jllama.apply_paged, compute_dtype=jnp.float32))


def port_engine(tcfg, params, conf):
    return build_engine_v2(tllama, tcfg, from_jax_params(tcfg, params), config=conf,
                           device="cpu")


def spec_prompts(vocab, seed=1):
    """Repetitive prompts the drafter matches, and random ones it does not;
    more prompts than slots, so admission continues while others verify."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, vocab, 6).tolist()
    pat2 = rng.integers(0, vocab, 4).tolist()
    return [(pat * 6)[:30], rng.integers(0, vocab, 13).tolist(), (pat2 * 5)[:17],
            rng.integers(0, vocab, 6).tolist(), (pat * 3)[:11]]


# --------------------------------------------------------------------------- #
# drafter
# --------------------------------------------------------------------------- #
def test_prompt_lookup_draft_cases():
    assert prompt_lookup_draft([1, 2, 3, 4, 1, 2, 3], 3) == [4, 1, 2]
    assert prompt_lookup_draft([1, 2, 3, 4, 1, 2, 3], 1) == [4]
    assert prompt_lookup_draft([1, 2, 3, 4, 5], 4) == []
    assert prompt_lookup_draft([7], 4) == []
    assert prompt_lookup_draft([1, 2], 0) == []
    # the most recent occurrence wins
    h = [5, 9, 1, 2, 7, 1, 2, 8, 1, 2]
    assert prompt_lookup_draft(h, 2, ngram_max=2)[0] == 8
    # min_match=2 rejects the 1-gram fallback that min_match=1 finds
    assert prompt_lookup_draft([3, 1, 4, 1], 2, ngram_max=2, min_match=1) == [4, 1]
    assert prompt_lookup_draft([3, 1, 4, 1], 2, ngram_max=2, min_match=2) == []
    # the trailing n-gram never matches itself
    assert prompt_lookup_draft([6, 6], 2, ngram_max=1) == [6]


@pytest.mark.parametrize("seed", range(4))
def test_prompt_lookup_draft_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        h = rng.integers(0, 5, int(rng.integers(1, 40))).tolist()
        k, n, m = int(rng.integers(0, 6)), int(rng.integers(1, 4)), int(rng.integers(1, 3))
        assert prompt_lookup_draft(h, k, n, m) == jdraft(h, k, n, m)


# --------------------------------------------------------------------------- #
# the spec-verify op (plain version) against the JAX kernel and reference
# --------------------------------------------------------------------------- #
NB, NKV, BS, HD, NH, MB = 14, 2, 8, 32, 4, 5


def verify_inputs(t, ng, seed=0):
    rng = np.random.default_rng(seed)
    cap = MB * BS
    ctx = np.array([0, BS - 2, 2 * BS + 3, cap - t], np.int32)   # row 1 crosses a block edge
    B = len(ctx)
    tables = rng.integers(1, NB, (B, MB)).astype(np.int32)
    tables[0] = 0                     # ctx 0: an inactive slot on the trash block
    q = rng.standard_normal((B, t, NH, HD)).astype(np.float32)
    if not ng:
        kp, vp = (rng.standard_normal((NB, NKV, BS, HD)).astype(np.float32) for _ in range(2))
        return (q, kp, vp, tables, ctx), {}
    kp, vp = (rng.integers(-127, 128, (NB, NKV, BS, HD)).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random((NB, NKV, BS, ng)) * 0.02).astype(np.float32) for _ in range(2))
    return (q, kp, vp, tables, ctx), {"k_scale": ks, "v_scale": vs}


@pytest.mark.parametrize("t,ng,window", [
    (5, 0, None), (5, 0, 3), (5, 0, "tensor"), (5, 1, None), (5, 1, 3),
    (5, 1, "tensor"), (5, 4, None), (5, 4, 6), (3, 4, "tensor"), (1, 0, None),
    (1, 1, 2)])
def test_spec_verify_matches_jax(t, ng, window):
    args, sc = verify_inputs(t, ng, seed=t + ng)
    tw = torch.tensor(4, dtype=torch.int32) if window == "tensor" else window
    jw = jnp.asarray(4, jnp.int32) if window == "tensor" else window
    got = paged_spec_verify_attention_torch(
        *map(torch.from_numpy, args), window=tw,
        **{k: torch.from_numpy(v) for k, v in sc.items()}).numpy()
    assert got.shape == args[0].shape
    jargs = [jnp.asarray(a) for a in args]
    jsc = {k: jnp.asarray(v) for k, v in sc.items()}
    for ref in (paged_spec_verify_attention(*jargs, window=jw, **jsc),
                paged_spec_verify_attention_xla(*jargs, window=jw, **jsc)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-6)


def test_spec_verify_rows_and_dispatch():
    """Row ti sees exactly the positions <= ctx + ti: with window 1 each
    row's output is its own position's V row. CPU tensors reach the plain
    version and launch nothing; the kernel's wrapper refuses them."""
    args, _ = verify_inputs(5, 0, seed=9)
    q, kp, vp, tables, ctx = map(torch.from_numpy, args)
    assert registry.get_op("paged_spec_verify_attention", q.device) is \
        paged_spec_verify_attention_torch
    before = paged_spec_verify_attention_cuda.launches
    got = paged_spec_verify_attention_torch(q, kp, vp, tables, ctx, window=1)
    b = 2
    for ti in range(5):
        pos = int(ctx[b]) + ti
        v = vp[tables[b, pos // BS], :, pos % BS]                 # [nkv, hd]
        torch.testing.assert_close(got[b, ti], v.repeat_interleave(NH // NKV, 0))
    assert paged_spec_verify_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        paged_spec_verify_attention_cuda(q, kp, vp, tables, ctx)
    with pytest.raises(ValueError, match=">= 1"):
        paged_spec_verify_attention_torch(q, kp, vp, tables, ctx, window=0)


# --------------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------------- #
COMBOS = {
    "kv_quant": {"kv_quant": {"enabled": True, "group_size": 8}},
    "speculative": {"speculative": SPEC},
    "speculative+fused_verify": {"speculative": dict(SPEC, fused_verify=True)},
    "all": {"speculative": dict(SPEC, fused_verify=True),
            "kv_quant": {"enabled": True, "group_size": 128}},
}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_greedy_streams_and_stats_match_jax(tiny, combo):
    jcfg, tcfg, params = tiny
    conf = config(**COMBOS[combo])
    prompts = spec_prompts(tcfg.vocab_size)
    jeng = jax_engine(jcfg, params, conf)
    want = jeng.generate(prompts, max_new_tokens=10)
    eng = port_engine(tcfg, params, conf)
    got = eng.generate(prompts, max_new_tokens=10)
    assert got == [list(map(int, w)) for w in want]
    assert eng.spec_stats == jeng.spec_stats
    if "speculative" in COMBOS[combo]:
        assert eng.spec_stats["verify_steps"] >= 3
        assert eng.spec_stats["rolled_back_tokens"] > 0
    eng.state.debug_check()
    assert eng.state.allocator.free_blocks == RAGGED["memory_config_blocks"] - 1


@pytest.mark.parametrize("quant", [False, True])
def test_greedy_spec_identical_to_plain_decode(tiny, quant):
    _, tcfg, params = tiny
    extra = {"kv_quant": {"enabled": True}} if quant else {}
    prompts = spec_prompts(tcfg.vocab_size, seed=5)
    want = port_engine(tcfg, params, config(**extra)).generate(prompts, max_new_tokens=12)
    for spec in (SPEC, dict(SPEC, fused_verify=True)):
        eng = port_engine(tcfg, params, config(speculative=spec, **extra))
        assert eng.generate(prompts, max_new_tokens=12) == want
        assert eng.spec_stats["drafted_tokens"] > 0 and eng.spec_stats["verify_steps"] > 0
        # steps_per_sync is subsumed by a verify step, as in the JAX engine
        assert eng.generate(prompts, max_new_tokens=12, steps_per_sync=4) == want


def _count_verify_calls(monkeypatch):
    calls = []
    plain = registry._REGISTRY["paged_spec_verify_attention"]["torch"]

    def counting(*a, **kw):
        calls.append(a[0].shape[1])
        return plain(*a, **kw)

    monkeypatch.setitem(registry._REGISTRY["paged_spec_verify_attention"], "torch", counting)
    return calls


def test_speculative_off_is_inert(tiny, monkeypatch):
    """``speculative.enabled: false`` (with every other knob set) is the
    engine without the block: the same streams, cache keys and dtypes,
    unwrapped tokens from ``step``, no verify, zero counters."""
    _, tcfg, params = tiny
    calls = _count_verify_calls(monkeypatch)
    prompts = spec_prompts(tcfg.vocab_size, seed=2)
    plain = port_engine(tcfg, params, config())
    off = port_engine(tcfg, params, config(speculative={
        "enabled": False, "max_draft_tokens": 6, "fused_verify": True}))
    assert off.generate(prompts, max_new_tokens=8) == plain.generate(prompts, max_new_tokens=8)
    assert {k: v.dtype for k, v in off.cache.items()} == \
        {k: v.dtype for k, v in plain.cache.items()}
    off.put(1, prompts[0])
    assert isinstance(off.step()[1], int)
    assert not any(off.spec_stats.values()) and not calls
    assert {k for k, *_ in off.forward_log} == {"prefill", "decode"}


@pytest.mark.parametrize("fused", [False, True])
def test_fused_verify_dispatch(tiny, monkeypatch, fused):
    """OFF: every verify forward takes the gathered-view prefill read (the
    spec-verify op is never called), and the streams and the cache dict are
    the engine's without the knob. ON: every layer of every verify step calls the op with
    t = k + 1 rows, and the streams do not change."""
    _, tcfg, params = tiny
    prompts = spec_prompts(tcfg.vocab_size, seed=3)
    unfused = port_engine(tcfg, params, config(speculative=SPEC))
    want = unfused.generate(prompts, max_new_tokens=10)
    calls = _count_verify_calls(monkeypatch)
    eng = port_engine(tcfg, params, config(speculative=dict(SPEC, fused_verify=fused)))
    assert eng.generate(prompts, max_new_tokens=10) == want
    assert {k: v.dtype for k, v in eng.cache.items()} == \
        {k: v.dtype for k, v in unfused.cache.items()}
    assert eng.spec_stats["verify_steps"] == unfused.spec_stats["verify_steps"]
    st = eng.spec_stats
    assert st["verify_steps"] > 0
    if fused:
        assert st["fused_verify_steps"] == st["verify_steps"]
        assert calls == [SPEC["max_draft_tokens"] + 1] * (tcfg.num_layers * st["verify_steps"])
    else:
        assert st["fused_verify_steps"] == 0 and calls == []


# --------------------------------------------------------------------------- #
# deterministic control through a stub family
# --------------------------------------------------------------------------- #
class _StubModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.w = nn.Parameter(torch.empty(4))


def pattern_module(vocab, break_every=0, fixed_logits=None, max_seq_len=128):
    """The JAX tests' fake family: after token t at position p comes
    (t + 1) % vocab, or (t + 2) % vocab where ``break_every`` divides p + 1;
    ``fixed_logits`` makes every position's distribution that vector."""
    fixed = None if fixed_logits is None else torch.as_tensor(fixed_logits, dtype=torch.float32)

    def apply_paged(cfg, model, tokens, cache, tables, ctx, *, valid=None):
        tokens = tokens.long()
        if fixed is not None:
            return fixed.expand(tokens.shape + fixed.shape).clone(), cache
        pos = ctx.long()[:, None] + torch.arange(tokens.shape[1])[None, :]
        nxt = (tokens + 1) % vocab
        if break_every:
            nxt = torch.where((pos + 1) % break_every == 0, (tokens + 2) % vocab, nxt)
        return 8.0 * F.one_hot(nxt, vocab).float(), cache

    mod = types.SimpleNamespace(
        build=_StubModel, apply_paged=apply_paged,
        init_paged_cache=lambda cfg, nb, bs, dtype, device: {"kv": torch.zeros(1, nb)})
    cfg = types.SimpleNamespace(max_seq_len=max_seq_len, vocab_size=vocab)
    return mod, cfg, {"w": np.zeros((4,), np.float32)}


def build_stub(vocab=8, break_every=0, fixed_logits=None, k=4, slots=2, blocks=32,
               block_size=8, spec_on=True, max_seq_len=128):
    mod, cfg, params = pattern_module(vocab, break_every, fixed_logits, max_seq_len)
    return build_engine_v2(mod, cfg, params, config={
        "dtype": "float32", "prefill_bucket": 8,
        "speculative": {"enabled": spec_on, "max_draft_tokens": k},
        "ragged": {"max_tracked_sequences": slots, "max_ragged_batch_size": slots,
                   "memory_config_blocks": blocks, "block_size": block_size}},
        device="cpu")


def stub_reference(prompt, n_new, vocab, break_every=0):
    seq, out = list(prompt), []
    for _ in range(n_new):
        p, t = len(seq) - 1, seq[-1]
        nxt = (t + 2) % vocab if break_every and (p + 1) % break_every == 0 \
            else (t + 1) % vocab
        out.append(nxt)
        seq.append(nxt)
    return out


def test_full_acceptance_emits_k_plus_one_per_step():
    V, k = 4, 4
    eng = build_stub(vocab=V, k=k)
    prompt = [0, 1, 2, 3, 0, 1, 2, 3]
    toks = [eng.put(1, prompt)]
    steps = 0
    while len(toks) < 17:
        toks += eng.step(seed=steps)[1]
        steps += 1
        eng.state.debug_check()
    assert toks == stub_reference(prompt, len(toks), V)
    s = eng.spec_stats
    assert s["decode_steps"] == 0 and s["verify_steps"] == steps
    assert s["accepted_tokens"] == s["drafted_tokens"] > 0 and s["rolled_back_tokens"] == 0
    assert s["emitted_tokens"] / s["step_seqs"] == k + 1
    assert {kind for kind, *_ in eng.forward_log} == {"prefill", "verify"}


def test_partial_rejection_rolls_back_and_stays_exact():
    V, brk = 5, 5
    eng = build_stub(vocab=V, break_every=brk, k=4, blocks=24, block_size=4)
    prompt = [0, 1, 2, 3, 0, 1, 2, 3]
    toks = [eng.put(1, prompt)]
    for i in range(12):
        toks += eng.step(seed=i).get(1, [])
        eng.state.debug_check()
    assert toks == stub_reference(prompt, len(toks), V, break_every=brk)
    s = eng.spec_stats
    assert s["rolled_back_tokens"] > 0 and s["accepted_tokens"] > 0
    d = eng.state.seqs[1]
    assert d.seen_tokens == len(prompt) + len(toks) - 1 == len(d.tokens)
    assert eng.finish(1) == toks


def test_spec_respects_max_seq_len_boundary():
    """Near max_seq_len the drafter clamps, so verification never writes
    past the last KV slot, and the rollback at the edge keeps the stream
    exact; the sequence reaches exactly max_seq_len."""
    V = 4
    eng = build_stub(vocab=V, max_seq_len=24, blocks=16, block_size=8)
    prompt = [0, 1, 2, 3, 0, 1, 2, 3]
    toks = [eng.put(1, prompt)]
    for i in range(40):
        toks += eng.step(seed=i).get(1, [])
        eng.state.debug_check()
        if eng.state.seqs[1].seen_tokens >= 24:
            break
    assert eng.state.seqs[1].seen_tokens == 24
    assert toks == stub_reference(prompt, len(toks), V)
    # a rollback at the edge: the breaking stub rejects the last window
    eng = build_stub(vocab=5, break_every=23, max_seq_len=24, blocks=16, block_size=8)
    toks = [eng.put(1, prompt)]
    while eng.state.seqs[1].seen_tokens < 24:
        toks += eng.step().get(1, [])
        eng.state.debug_check()
    assert toks == stub_reference(prompt, len(toks), 5, break_every=23)
    assert eng.spec_stats["rolled_back_tokens"] > 0


def test_generate_trims_a_verify_step_at_eos():
    """A verify step may emit tokens past the first EOS; ``generate`` cuts
    the stream there, as the JAX engine does."""
    V = 6
    eng = build_stub(vocab=V, k=4)
    prompt = [0, 1, 2, 3, 4, 5, 0, 1]
    out = eng.generate([prompt], max_new_tokens=20, eos_token_id=4)[0]
    assert out == [2, 3, 4]
    assert eng.spec_stats["verify_steps"] >= 1


def test_rejection_sampling_matches_plain_sampling_distribution():
    """With a fixed target distribution, the first token a verify step
    emits (an accepted draft or the residual correction) is distributed
    like plain sampling: the deterministic-drafter rejection-sampling
    identity (``tests/test_spec_decode.py``)."""
    V = 8
    L = np.asarray([2.0, 1.4, 0.9, 0.4, 0.0, -0.5, -1.2, -2.0], np.float32)
    sp = SamplingParams(temperature=0.9, top_k=5)
    p = torch.softmax(filter_logits(torch.from_numpy(L), sp), -1).numpy()

    def draw(spec_on, n=400):
        eng = build_stub(vocab=V, fixed_logits=L, k=3, slots=1, blocks=16, block_size=8,
                         spec_on=spec_on)
        counts = np.zeros(V)
        prompt = list(range(V)) + [0, 1]     # every token drafts through the 1-gram
        for i in range(n):
            eng.put(7, prompt, sp, seed=1000 + i)
            out = eng.step(seed=i)
            counts[out[7][0] if spec_on else out[7]] += 1
            eng.finish(7)
        if spec_on:
            assert eng.spec_stats["verify_steps"] == n
            assert eng.spec_stats["drafted_tokens"] >= n
        return counts / n

    f_spec, f_plain = draw(True), draw(False)
    assert np.abs(f_spec - p).max() < 0.08, (f_spec, p)
    assert np.abs(f_plain - p).max() < 0.08, (f_plain, p)
    assert 0.5 * np.abs(f_spec - f_plain).sum() < 0.10


def test_drafts_outside_top_k_are_always_rejected():
    V = 6
    L = np.asarray([3.0, 2.5, 2.0, 1.5, -8.0, -9.0], np.float32)
    sp = SamplingParams(temperature=1.0, top_k=2)
    eng = build_stub(vocab=V, fixed_logits=L, k=2, slots=1, blocks=16, block_size=8)
    prompt = [0, 4, 1, 4, 3]        # whatever comes first, the drafter proposes 4
    for i in range(60):
        eng.put(1, prompt, sp, seed=i)
        for t in eng.step(seed=i)[1]:
            assert t in (0, 1)
        eng.finish(1)
    assert eng.spec_stats["verify_steps"] == 60
    assert eng.spec_stats["accepted_tokens"] == 0


def test_spec_soak_mixed_requests():
    """Random admissions and finishes of draftable and random prompts under
    greedy and stochastic params: the allocator's invariants hold after
    every step."""
    V = 16
    rng = np.random.default_rng(4)
    eng = build_stub(vocab=V, break_every=7, k=3, slots=4, blocks=48, block_size=4)
    sps = [SP, SamplingParams(temperature=0.8, top_k=6),
           SamplingParams(temperature=1.2, top_p=0.9)]
    uid = 0
    for it in range(60):
        if len(eng.state.seqs) < 4 and rng.random() < 0.5:
            n = int(rng.integers(4, 14))
            prompt = (rng.integers(0, V, 3).tolist() * 6)[:n] if rng.random() < 0.5 \
                else rng.integers(0, V, n).tolist()
            if eng.state.can_admit(len(prompt)):
                eng.put(uid, prompt, sps[uid % 3], seed=it)
                uid += 1
        eng.step(seed=it)
        eng.state.debug_check()
        for u in list(eng.state.seqs):
            if len(eng.state.seqs[u].generated) >= 10 or rng.random() < .1:
                eng.finish(u)
        eng.state.debug_check()
    s = eng.spec_stats
    assert s["verify_steps"] > 0 and s["drafted_tokens"] > 0
    assert s["emitted_tokens"] >= s["accepted_tokens"]


# --------------------------------------------------------------------------- #
# sampling helpers
# --------------------------------------------------------------------------- #
def test_filter_logits_batch_matches_jax():
    rs = np.random.RandomState(3)
    logits = (rs.randn(6, 50) * 2).astype(np.float32)
    sps = [SamplingParams(0.7, 0, 1.0), SamplingParams(1.0, 5, 1.0),
           SamplingParams(1.3, 0, 0.8), SamplingParams(0.9, 12, 0.6),
           SamplingParams(0.0, 0, 1.0, True), SamplingParams(1.0, 80, 0.95)]
    arrs = sp_arrays(sps)
    assert [a.dtype for a in arrs] == [np.float32, np.int32, np.float32, bool]
    got = filter_logits_batch(torch.from_numpy(logits),
                              *map(torch.from_numpy, arrs[:3])).numpy()
    want = np.asarray(jfilter_batch(jnp.asarray(logits), *map(jnp.asarray, arrs[:3])))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    # each row is the static filter of its own params
    for i, sp in enumerate(sps[:4]):
        row = np.asarray(jfilter(jnp.asarray(logits[i]), JSP(*sp)))
        np.testing.assert_array_equal(np.isinf(got[i]), np.isinf(row))
