"""Continuous-batching engine v2: the PyTorch port against the JAX package.

Greedy token streams of the port's ``InferenceEngineV2`` must be IDENTICAL to
the JAX ``InferenceEngineV2`` on the same weights and prompts. The JAX
engine runs in fp32 by handing its constructor fp32 ``apply_paged`` /
``init_paged_cache`` partials; the port runs with ``dtype: float32`` on the
CPU. More prompts than sequence slots make continuous batching admit late.

The host-side bookkeeping (``ragged.py``) is checked in both packages by the
same tests, and op for op against each other in a randomized soak. Sampling
filters are held against the JAX ``filter_logits`` (a deterministic
function; fp32 1e-6).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.comm import mesh as mesh_lib
from deepspeed_tpu.inference import ragged as jragged
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.engine import ModelFamily as JFamily
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSP
from deepspeed_tpu.inference.sampling import filter_logits as jfilter
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.inference import (SamplingParams, UnknownSequenceError,
                                           build_engine_v2, filter_logits, sample)
from deepspeed_tpu_torch.inference import ragged as tragged
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import from_jax_params

CONFIG = {"dtype": "float32", "prefill_bucket": 16,
          "ragged": {"max_tracked_sequences": 3, "max_ragged_batch_size": 3,
                     "memory_config_blocks": 24, "block_size": 8}}


@pytest.fixture(scope="module")
def tiny():
    cfg_kw = dict(max_seq_len=64)
    jcfg = jllama.LlamaConfig.tiny(**cfg_kw)
    tcfg = tllama.LlamaConfig.tiny(**cfg_kw)
    params = jax.tree.map(np.asarray, jllama.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params


def _jax_engine(jcfg, params):
    mesh_lib.set_mesh(None)
    return JEngine(JFamily.from_module(jllama, jcfg), params,
                   JConfig.from_dict(CONFIG),
                   init_paged_cache=partial(jllama.init_paged_cache,
                                            dtype=jnp.float32),
                   apply_paged=partial(jllama.apply_paged,
                                       compute_dtype=jnp.float32))


def _prompts(vocab, lengths, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lengths]


def test_greedy_streams_identical_to_jax(tiny):
    jcfg, tcfg, params = tiny
    # one prefill bucket (16) keeps the JAX side to few compiled programs;
    # prompts still span up to two 8-token blocks
    prompts = _prompts(tcfg.vocab_size, [5, 1, 14, 16, 7, 12, 9])
    want = _jax_engine(jcfg, params).generate(prompts, max_new_tokens=6)
    eng = build_engine_v2(tllama, tcfg, from_jax_params(tcfg, params),
                          config=CONFIG, device="cpu")
    got = eng.generate(prompts, max_new_tokens=6)
    assert got == [list(map(int, w)) for w in want]
    # 7 prompts through 3 slots: at least three admission bursts
    assert sum(kind == "prefill" for kind, *_ in eng.forward_log) >= 3
    eng.state.debug_check()
    assert eng.state.allocator.free_blocks == CONFIG["ragged"]["memory_config_blocks"] - 1


def test_put_step_finish_and_errors(tiny):
    _, tcfg, params = tiny
    eng = build_engine_v2(tllama, tcfg, from_jax_params(tcfg, params),
                          config=CONFIG, device="cpu")
    p = _prompts(tcfg.vocab_size, [4, 9], seed=2)
    first = eng.put_many([(10, p[0]), (11, p[1])])
    assert set(first) == {10, 11}
    for _ in range(3):
        out = eng.step()
        assert set(out) == {10, 11}
    toks = eng.finish(10)
    assert len(toks) == 4 and all(0 <= t < tcfg.vocab_size for t in toks)
    with pytest.raises(UnknownSequenceError):
        eng.finish(10)
    # all-or-nothing admission: the third uid does not fit the slots
    with pytest.raises(MemoryError):
        eng.put_many([(12, p[0]), (13, p[0]), (14, p[0])])
    assert set(eng.state.seqs) == {11}
    eng.state.debug_check()
    # steps_per_sync > 1 runs step_many: the same tokens as one step a sync
    eng.finish(11)
    assert eng.generate(p, max_new_tokens=5, steps_per_sync=4) == \
        eng.generate(p, max_new_tokens=5)


def test_stochastic_generate_is_seeded(tiny):
    _, tcfg, params = tiny
    sd = from_jax_params(tcfg, params)
    prompts = _prompts(tcfg.vocab_size, [6, 3], seed=4)
    runs = []
    for _ in range(2):
        eng = build_engine_v2(tllama, tcfg, sd, config=CONFIG, device="cpu")
        runs.append(eng.generate(prompts, max_new_tokens=5, seed=7,
                                 temperature=0.8, top_k=20))
    assert runs[0] == runs[1]
    assert all(0 <= t < tcfg.vocab_size for r in runs[0] for t in r)


@pytest.mark.parametrize("sp", [SamplingParams(0.7, 0, 1.0),
                                SamplingParams(1.0, 5, 1.0),
                                SamplingParams(1.3, 0, 0.8),
                                SamplingParams(0.9, 12, 0.6)])
def test_filter_logits_matches_jax(sp):
    rs = np.random.RandomState(3)
    logits = rs.randn(4, 50).astype(np.float32) * 2
    got = filter_logits(torch.from_numpy(logits), sp).numpy()
    want = np.asarray(jfilter(jnp.asarray(logits), JSP(*sp)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    # every draw lands inside the kept set
    g = torch.Generator().manual_seed(0)
    ids = sample(torch.from_numpy(logits).expand(64, 4, 50), sp, g).numpy()
    assert np.all(fin[np.arange(4)[None, :], ids])
    assert torch.equal(sample(torch.from_numpy(logits), SamplingParams(greedy=True)),
                       torch.from_numpy(logits).argmax(-1))


# --------------------------------------------------------------------------- #
# ragged.py — the same checks on both packages' copies
# --------------------------------------------------------------------------- #
RAGGED = {"jax": jragged, "torch": tragged}


@pytest.mark.parametrize("pkg", sorted(RAGGED))
def test_blocked_allocator(pkg):
    alloc = RAGGED[pkg].BlockedAllocator(8)
    a = alloc.allocate(3)
    assert len(set(a)) == 3 and 0 not in a
    assert alloc.free_blocks == 4
    with pytest.raises(MemoryError):
        alloc.allocate(5)
    alloc.free(a)
    assert alloc.free_blocks == 7
    with pytest.raises(ValueError):
        alloc.free([0])
    with pytest.raises(ValueError):
        alloc.free([a[0]])


@pytest.mark.parametrize("pkg", sorted(RAGGED))
def test_state_manager_slots_and_tables(pkg):
    sm = RAGGED[pkg].StateManager(max_sequences=2, num_blocks=16, block_size=4,
                                  max_blocks_per_seq=4)
    d1 = sm.admit(10, prompt_len=6)  # needs ceil(6/4)+1 = 3 blocks
    assert len(d1.blocks) == 3
    table = sm.block_table(d1)
    assert table.shape == (4,) and (table[3:] == 0).all()
    sm.admit(11, prompt_len=1)
    assert not sm.can_admit(1)  # no slots left
    sm.retire(10)
    assert sm.can_admit(1)
    d1b = sm.admit(12, prompt_len=2)
    assert d1b.slot == d1.slot  # slot reused
    with pytest.raises(RAGGED[pkg].UnknownSequenceError):
        sm.lookup(10)
    sm.debug_check()


def test_state_manager_soak_matches_jax():
    """Random admit / extend / retire traffic through both copies: same
    slots, same block tables, same free counts, invariants held."""
    rs = np.random.RandomState(0)
    sms = [m.StateManager(max_sequences=4, num_blocks=32, block_size=4,
                          max_blocks_per_seq=8) for m in (jragged, tragged)]
    uid = 0
    for _ in range(300):
        live = sorted(sms[0].seqs)
        op = rs.randint(3)
        if op == 0:
            n = int(rs.randint(1, 20))
            ok = [sm.can_admit(n) for sm in sms]
            assert ok[0] == ok[1]
            if ok[0]:
                descs = [sm.admit_prompt(uid, list(range(n)))[0] for sm in sms]
                for d in descs:
                    d.seen_tokens = n
                uid += 1
        elif op == 1 and live:
            u = live[rs.randint(len(live))]
            descs = [sm.seqs[u] for sm in sms]
            if descs[0].seen_tokens + 1 > 8 * 4 or \
                    sms[0].growth_blocks_short([descs[0]]) > 0:
                continue
            for sm, d in zip(sms, descs):
                sm.extend(d)
                d.seen_tokens += 1
        elif live:
            u = live[rs.randint(len(live))]
            for sm in sms:
                sm.retire(u)
        for sm in sms:
            sm.debug_check()
        assert sorted(sms[0].seqs) == sorted(sms[1].seqs)
        for u in sms[0].seqs:
            a, b = sms[0].seqs[u], sms[1].seqs[u]
            assert a.slot == b.slot
            np.testing.assert_array_equal(sms[0].block_table(a), sms[1].block_table(b))
        assert sms[0].allocator.free_blocks == sms[1].allocator.free_blocks
