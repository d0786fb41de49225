"""The work items of the block-sparse dK/dV kernel on Hopper
(``ops/csrc/sparse_sm90.cu``), on the CPU.

- ``dkv_split_plan`` puts every (query head, q block) pair of a kv block's
  transposed list in exactly one chunk, in order, for the bigbird, fixed
  and sliding layouts, causal and not, groups 1 and 4; at the smoke's
  S 16384 bigbird layout column 0's 512 pairs become 16 chunks of 32.
- A plain-torch rendering of the kernel's split: each chunk's dK/dV partial
  (products in fp64, stored as fp32, as the kernel's fp32 partials), summed
  in chunk order in fp32, equals ``sparse_bwd_torch``'s dK/dV (fp32
  inputs; fp64 products rounded once) within 1e-6 of the output's largest
  magnitude: each fp32 partial and each fp32 add rounds by half an ulp of
  its largest term, so an element that cancels to near 0 keeps ~1e-6 of
  that term's size. With one chunk's partial dropped it does not. The same
  rendering against the JAX package's Pallas dK/dV kernel in interpret mode
  (MHA, where its widened dK/dV are the narrow ones) at the 2e-4 of
  ``tests/test_torch_sparse_attention.py``.
- ``sparse_source`` routes the three kernels (forward, dQ and dK/dV) by
  one rule: bf16 at block 128 to ``sparse_sm90.cu``, everything else it
  takes to ``sparse_attention.cu``; it raises on what neither takes, and
  every kernel wrapper, on either route, refuses CPU tensors (no plain
  version runs in a wrapper).
- ``sparse_attention.cu``'s dK/dV at blocks 16-64 takes the same plan: at
  the smoke's S 4096 layouts for blocks 16, 32 and 64 every pair is in
  exactly one chunk, and at block 32 the bigbird global column's 512 pairs
  become 16 chunks of 32. A rendering of that kernel's walk (each chunk's
  pairs in 32-row q sub-tiles, its partial stored as fp32, a column's
  partials summed in chunk order in fp32) at S 256, block 32, equals the
  plain version and the JAX Pallas dK/dV in interpret mode at the limits
  above; with the last chunk dropped (the kernel's planted fault) it does
  not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import sparse_attention as jpsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

LAYOUTS = {   # name: (builder over nb, causal)
    "bigbird_causal": (lambda nb: tsa.bigbird_layout(nb, 3, 1, 2, seed=1, causal=True), True),
    "bigbird_noncausal": (lambda nb: tsa.bigbird_layout(nb, 2, 1, 1, seed=2), False),
    "fixed_causal": (lambda nb: tsa.fixed_layout(nb, 2, 3, causal=True), True),
    "fixed_noncausal": (lambda nb: tsa.fixed_layout(nb, 4, 4, causal=False), False),
    "sliding_causal": (lambda nb: tsa.sliding_window_layout(nb, 3, causal=True), True),
    "sliding_noncausal": (lambda nb: tsa.sliding_window_layout(nb, 2, causal=False), False),
}
FIELDS = {name: i for i, name in enumerate(tsa.PLAN_FIELDS)}


def _entries(plan):
    return [dict(zip(tsa.PLAN_FIELDS, (int(x) for x in row[:len(FIELDS)]))) for row in plan]


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plan_puts_every_pair_in_exactly_one_chunk(name, group):
    builder, causal = LAYOUTS[name]
    _check_plan(builder(24), causal, group)


def _check_plan(lay, causal, group):
    _, cnt_t = tsa.compact_layout_t(lay, causal)
    info = tsa.dkv_split_plan(lay, causal, group)
    entries = _entries(info["plan"])
    seen = {kb: np.zeros(group * int(cnt_t[kb]), int) for kb in range(len(cnt_t))}
    chunks = {}
    for e in entries:
        seen[e["kv_block"]][e["pair_lo"]:e["pair_lo"] + e["pairs"]] += 1
        assert e["pairs"] <= info["chunk_pairs"]
        chunks.setdefault(e["kv_block"], []).append(e)
    for kb, hits in seen.items():
        assert (hits == 1).all(), f"kv block {kb}: pairs seen {hits.tolist()}"
        col = sorted(chunks[kb], key=lambda e: e["chunk"])
        assert [e["chunk"] for e in col] == list(range(len(col)))
        assert all(e["chunks"] == len(col) for e in col)
        # chunks are consecutive runs, in chunk order
        assert [e["pair_lo"] for e in col] == \
            [sum(c["pairs"] for c in col[:i]) for i in range(len(col))]
    # longest first; split columns own disjoint slots and one counter each
    lengths = [e["pairs"] for e in entries]
    assert lengths == sorted(lengths, reverse=True)
    split = [e for e in entries if e["chunks"] > 1]
    assert sorted(e["slot0"] + e["chunk"] for e in split) == list(range(info["slots"]))
    assert len({e["counter"] for e in split}) == info["split_columns"]
    assert all(e["slot0"] == e["counter"] == -1 for e in entries if e["chunks"] == 1)


def test_plan_at_the_smoke_layout():
    """S 16384, block 128, bigbird causal, g = 4: the global column's 512
    pairs become 16 chunks of 32 (twice the median column's 16 pairs); no
    other column splits, and column 0's chunks come first."""
    lay = tsa.bigbird_layout(128, 3, 1, 2, seed=0, causal=True)
    info = tsa.dkv_split_plan(lay, True, 4)
    entries = _entries(info["plan"])
    assert info["chunk_pairs"] == 32 and info["split_columns"] == 1 and info["slots"] == 16
    col0 = [e for e in entries if e["kv_block"] == 0]
    assert [e["pairs"] for e in col0] == [32] * 16 and entries[:16] == col0
    assert all(e["chunks"] == 1 for e in entries if e["kv_block"] != 0)
    assert len(entries) == 128 + 15
    assert tsa.dkv_split_plan(lay, True, 4)["plan"] is info["plan"]   # cached


SMOKE_S4096 = {   # chip_smoke.py's S 4096 layouts at layout block bs: name -> (layout, causal)
    "bigbird causal": (lambda nb: tsa.bigbird_layout(nb, 3, 1, 2, seed=0, causal=True), True),
    "fixed non-causal": (lambda nb: tsa.fixed_layout(nb, 4, 4, causal=False), False),
    "sliding window": (lambda nb: tsa.sliding_window_layout(nb, 4, causal=True), True),
}


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("name", sorted(SMOKE_S4096))
def test_plan_at_small_blocks_puts_every_pair_in_one_chunk(name, bs):
    """S 4096 at the blocks ``sparse_attention.cu``'s dK/dV serves, g = 4:
    every pair in exactly one chunk; at block 32 the bigbird layout is the
    S 16384 / block 128 one, so its global column is cut as there."""
    builder, causal = SMOKE_S4096[name]
    lay = builder(4096 // bs)
    _check_plan(lay, causal, 4)
    info = tsa.dkv_split_plan(lay, causal, 4)
    if name == "bigbird causal":
        col0 = [e for e in _entries(info["plan"]) if e["kv_block"] == 0]
        assert len(col0) > 1 and info["split_columns"] >= 1
        if bs == 32:
            assert [e["pairs"] for e in col0] == [32] * 16 and len(info["plan"]) == 143


def _inputs(b, s, h, hkv, d, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32))
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


def split_dkv(q, k, v, do, lse, delta, layout, bs, causal, drop_chunk=False):
    """``sparse_sm90.cu``'s split in plain torch: per (batch, kv head, plan
    entry) the chunk's pairs in order, each the 128-row kernel's step at
    block ``bs`` (p from lse, ds = p (dp - delta) scale; products in fp64),
    the chunk's dK/dV partial stored as fp32; a column's partials summed in
    chunk order in fp32 (``drop_chunk``: the last one left out, the
    kernel's planted fault 1)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g, scale = h // hkv, d ** -0.5
    idx_t, cnt_t = tsa.compact_layout_t(layout, causal)
    plan = _entries(tsa.dkv_split_plan(layout, causal, g)["plan"])
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    lse = lse.reshape(b, h, s).double()
    delta = delta.reshape(b, h, s).double()
    tri = torch.ones(bs, bs, dtype=torch.bool).tril()       # [q row, kv row] visible
    parts = {}
    for bb in range(b):
        for hk in range(hkv):
            for e in plan:
                kb = e["kv_block"]
                kr = slice(kb * bs, (kb + 1) * bs)
                pk = torch.zeros(bs, d, dtype=torch.float64)
                pv = torch.zeros(bs, d, dtype=torch.float64)
                for p in range(e["pair_lo"], e["pair_lo"] + e["pairs"]):
                    j, li = divmod(p, int(cnt_t[kb]))
                    hq, qb = hk * g + j, int(idx_t[kb, li])
                    qr = slice(qb * bs, (qb + 1) * bs)
                    pm = torch.exp(scale * qd[bb, qr, hq] @ kd[bb, kr, hk].T
                                   - lse[bb, hq, qr, None])
                    if causal and qb == kb:
                        pm = pm * tri
                    dp = dod[bb, qr, hq] @ vd[bb, kr, hk].T
                    ds = pm * (dp - delta[bb, hq, qr, None]) * scale
                    pv += pm.T @ dod[bb, qr, hq]
                    pk += ds.T @ qd[bb, qr, hq]
                parts.setdefault((bb, hk, kb), []).append((e["chunk"], pk.float(), pv.float()))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for (bb, hk, kb), col in parts.items():
        col.sort(key=lambda c: c[0])
        if drop_chunk and len(col) > 1:
            col = col[:-1]
        for _, pk, pv in col:   # fp32, in chunk order
            dk[bb, kb * bs:(kb + 1) * bs, hk] += pk
            dv[bb, kb * bs:(kb + 1) * bs, hk] += pv
    return dk, dv


@pytest.mark.parametrize("name,group", [("bigbird_causal", 4), ("bigbird_noncausal", 1),
                                        ("fixed_noncausal", 2)])
def test_split_sum_equals_plain_and_a_dropped_chunk_does_not(name, group):
    builder, causal = LAYOUTS[name]
    bs, nb, hkv, d = 16, 16, 2, 32
    lay = builder(nb)
    assert tsa.dkv_split_plan(lay, causal, group)["split_columns"] >= 1
    q, k, v, do = _inputs(1, nb * bs, hkv * group, hkv, d, seed=group)
    o, lse = tsa.sparse_fwd_torch(q, k, v, lay, bs, causal=causal)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(-1, nb * bs)
    _, dk_ref, dv_ref = tsa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)
    def close(got, ref):
        tol = 1e-6 * float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol)

    dk, dv = split_dkv(q, k, v, do, lse, delta, lay, bs, causal)
    close(dk, dk_ref)
    close(dv, dv_ref)
    dk_bad, dv_bad = split_dkv(q, k, v, do, lse, delta, lay, bs, causal, drop_chunk=True)
    for got, ref in ((dk_bad, dk_ref), (dv_bad, dv_ref)):
        with pytest.raises(AssertionError):
            close(got, ref)


def test_split_sum_matches_jax_kernel():
    """MHA, bigbird causal with a split global column: the split's dK/dV
    against ``sparse_flash_attention_bwd`` (interpret mode) from the same o
    and lse."""
    b, s, h, d, bs = 1, 256, 2, 32, 16
    lay = jsa.bigbird_layout(s // bs, 3, 1, 2, seed=1, causal=True)
    assert tsa.dkv_split_plan(lay, True, 1)["split_columns"] >= 1
    q, k, v, do = _inputs(b, s, h, h, d, seed=9)
    o_j, lse_j = jpsa._sparse_fwd_lse(*(jnp.asarray(t.numpy()) for t in (q, k, v)), lay, bs,
                                      causal=True, scale=d ** -0.5)
    _, dk_j, dv_j = jpsa.sparse_flash_attention_bwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), o_j, lse_j, jnp.asarray(do.numpy()),
        lay, bs, causal=True, scale=d ** -0.5)
    o = torch.from_numpy(np.array(o_j))
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy()).reshape(b * h, s)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(b * h, s)
    dk, dv = split_dkv(q, k, v, do, lse, delta, lay, bs, True)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_j), rtol=2e-4, atol=2e-4)


def mma_split_dkv(q, k, v, do, lse, delta, layout, bs, causal, drop_chunk=False):
    """``sparse_attention.cu``'s dK/dV at block ``bs`` in plain torch: per
    (batch, kv head, plan entry) the chunk's steps in the kernel's order
    (each pair's q block in sub-tiles of min(bs, 32) rows; products in
    fp64), the chunk's partial stored as fp32; a column's partials summed in
    chunk order in fp32 (``drop_chunk``: the last one left out, the
    kernel's planted fault 1)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g, scale, qt = h // hkv, d ** -0.5, min(bs, 32)
    idx_t, cnt_t = tsa.compact_layout_t(layout, causal)
    plan = _entries(tsa.dkv_split_plan(layout, causal, g)["plan"])
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    lse = lse.reshape(b, h, s).double()
    delta = delta.reshape(b, h, s).double()
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bb in range(b):
        for hk in range(hkv):
            cols = {}
            for e in plan:
                kb = e["kv_block"]
                kr = torch.arange(kb * bs, (kb + 1) * bs)
                pk = torch.zeros(bs, d, dtype=torch.float64)
                pv = torch.zeros(bs, d, dtype=torch.float64)
                for step in range(e["pairs"] * (bs // qt)):
                    p = e["pair_lo"] + step // (bs // qt)
                    j, li = divmod(p, int(cnt_t[kb]))
                    hq = hk * g + j
                    qr = torch.arange(qt) + int(idx_t[kb, li]) * bs + step % (bs // qt) * qt
                    pm = torch.exp(scale * qd[bb, qr, hq] @ kd[bb, kr, hk].T
                                   - lse[bb, hq, qr, None])
                    if causal:
                        pm = pm * (kr[None, :] <= qr[:, None])
                    dp = dod[bb, qr, hq] @ vd[bb, kr, hk].T
                    ds = pm * (dp - delta[bb, hq, qr, None]) * scale
                    pv += pm.T @ dod[bb, qr, hq]
                    pk += ds.T @ qd[bb, qr, hq]
                cols.setdefault(kb, []).append((e["chunk"], pk.float(), pv.float()))
            for kb, col in cols.items():
                col.sort(key=lambda c: c[0])
                if drop_chunk and len(col) > 1:
                    col = col[:-1]
                for _, pk, pv in col:   # fp32, in chunk order
                    dk[bb, kb * bs:(kb + 1) * bs, hk] += pk
                    dv[bb, kb * bs:(kb + 1) * bs, hk] += pv
    return dk, dv


@pytest.mark.parametrize("name,group", [("bigbird_causal", 4), ("fixed_causal", 2)])
def test_mma_split_at_block_32_equals_plain_and_a_dropped_chunk_does_not(name, group):
    builder, causal = LAYOUTS[name]
    bs, nb, hkv, d = 32, 8, 1, 32
    lay = builder(nb)
    assert tsa.dkv_split_plan(lay, causal, group)["split_columns"] >= 1
    q, k, v, do = _inputs(1, nb * bs, hkv * group, hkv, d, seed=10 + group)
    o, lse = tsa.sparse_fwd_torch(q, k, v, lay, bs, causal=causal)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(-1, nb * bs)
    _, dk_ref, dv_ref = tsa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)

    def close(got, ref):
        tol = 1e-6 * float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol)

    dk, dv = mma_split_dkv(q, k, v, do, lse, delta, lay, bs, causal)
    close(dk, dk_ref)
    close(dv, dv_ref)
    dk_bad, dv_bad = mma_split_dkv(q, k, v, do, lse, delta, lay, bs, causal, drop_chunk=True)
    for got, ref in ((dk_bad, dk_ref), (dv_bad, dv_ref)):
        with pytest.raises(AssertionError):
            close(got, ref)


def test_mma_split_at_block_32_matches_jax_kernel():
    """MHA, S 256, block 32, bigbird causal with a split global column: the
    rendering's dK/dV against ``sparse_flash_attention_bwd`` (interpret
    mode) from the same o and lse."""
    b, s, h, d, bs = 1, 256, 2, 32, 32
    lay = jsa.bigbird_layout(s // bs, 3, 1, 2, seed=1, causal=True)
    assert tsa.dkv_split_plan(lay, True, 1)["split_columns"] >= 1
    q, k, v, do = _inputs(b, s, h, h, d, seed=12)
    o_j, lse_j = jpsa._sparse_fwd_lse(*(jnp.asarray(t.numpy()) for t in (q, k, v)), lay, bs,
                                      causal=True, scale=d ** -0.5)
    _, dk_j, dv_j = jpsa.sparse_flash_attention_bwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), o_j, lse_j, jnp.asarray(do.numpy()),
        lay, bs, causal=True, scale=d ** -0.5)
    o = torch.from_numpy(np.array(o_j))
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy()).reshape(b * h, s)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(b * h, s)
    dk, dv = mma_split_dkv(q, k, v, do, lse, delta, lay, bs, True)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,block,d,source", [
    (torch.bfloat16, 128, 128, tsa.SPARSE_SM90), (torch.bfloat16, 128, 32, tsa.SPARSE_SM90),
    (torch.bfloat16, 128, 64, tsa.SPARSE_SM90), (torch.bfloat16, 64, 128, tsa.SPARSE_MMA),
    (torch.bfloat16, 32, 64, tsa.SPARSE_MMA), (torch.bfloat16, 16, 32, tsa.SPARSE_MMA),
    (torch.float32, 128, 128, tsa.SPARSE_MMA), (torch.float32, 16, 64, tsa.SPARSE_MMA)])
def test_sparse_dkv_source_routes_by_dtype_and_block(dtype, block, d, source):
    assert tsa.sparse_source(dtype, block, d) == source


def test_sparse_dkv_source_raises_on_what_no_source_takes():
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tsa.sparse_source(torch.float16, 128, 128)
    with pytest.raises(ValueError, match="head dim"):
        tsa.sparse_source(torch.bfloat16, 128, 96)
    with pytest.raises(ValueError, match="block size"):
        tsa.sparse_source(torch.bfloat16, 48, 128)
    q = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(2, 256)
    for wrapper in (tsa.sparse_bwd_dq_sm90_cuda, tsa.sparse_bwd_dkv_sm90_cuda):
        with pytest.raises(ValueError, match="CUDA"):   # CPU tensors: no kernel
            wrapper(q, q, q, q, lse, lse, np.ones((2, 2), bool), 128)


@pytest.mark.parametrize("dtype,block", [(torch.bfloat16, 128), (torch.bfloat16, 32),
                                         (torch.float32, 128)])
def test_every_sparse_wrapper_refuses_cpu_tensors_on_either_route(dtype, block):
    """The forward, dQ and dK/dV wrappers of both sources: CPU tensors get no
    kernel and no plain version, whichever source ``sparse_source`` names."""
    q = torch.zeros(1, 2 * block, 2, 64, dtype=dtype)
    lse = torch.zeros(2, 2 * block)
    lay = np.ones((2, 2), bool)
    for fwd in (tsa.sparse_fwd_cuda, tsa.sparse_fwd_sm90_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fwd(q, q, q, lay, block)
    for bwd in (tsa.sparse_bwd_dq_cuda, tsa.sparse_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            bwd(q, q, q, q, lse, lse, lay, block)
