"""Block-sparse attention: the PyTorch port against the JAX package, on the
CPU.

- The layout builders and the compacted block lists (``compact_layout``,
  ``compact_layout_t``) EQUAL to the JAX package's, and the empty-row
  ``ValueError``.
- The port's plain pieces (``sparse_fwd_torch`` / ``sparse_bwd_torch``, which
  the CUDA kernels are held against on the card) against the JAX package's
  Pallas block-sparse kernels in interpret mode (``_sparse_fwd_lse``,
  ``sparse_flash_attention_bwd``), fp32: o and lse at 2e-5, dq/dk/dv at
  2e-4, as ``tests/test_pallas_kernels.py`` holds the kernels.
- :class:`BlockSparseAttention` (the kernel path's autograd function, its
  plain pieces on CPU tensors) against JAX ``blocksparse_attention(...,
  use_kernel=True)``: output 2e-5, grads 2e-4, GQA grads narrowed by the
  query-group sum and a kv block nobody attends to getting exactly zero.
- ``use_kernel=False`` (the dense-masked path) against JAX's at 1e-5, and
  the entry point's refusals (CPU tensors on the kernel path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import sparse_attention as jpsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.attention import attention_torch
from deepspeed_tpu_torch.ops.sparse_attention import (
    BlockSparseAttention, blocksparse_attention, sparse_attention_bwd,
    sparse_attention_fwd, sparse_fwd_cuda)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nb", [1, 4, 8, 13])
def test_layouts_equal_jax(nb, causal):
    for args in ((), (1,), (2,), (5,)):
        np.testing.assert_array_equal(tsa.sliding_window_layout(nb, *args, causal=causal),
                                      jsa.sliding_window_layout(nb, *args, causal=causal))
    for args in ((), (2, 4), (3, 2), (1, 1)):
        np.testing.assert_array_equal(tsa.fixed_layout(nb, *args, causal=causal),
                                      jsa.fixed_layout(nb, *args, causal=causal))
    for args in ((), (3, 1, 2, 7), (1, 2, 1, 0), (2, 0, 3, 5)):
        got = tsa.bigbird_layout(nb, *args, causal=causal)
        np.testing.assert_array_equal(got, jsa.bigbird_layout(nb, *args, causal=causal))
        assert got.dtype == bool


@pytest.mark.parametrize("causal", [True, False])
def test_compacted_lists_equal_jax(causal):
    for lay in (jsa.bigbird_layout(16, 3, 1, 2, seed=4, causal=causal),
                jsa.fixed_layout(12, 4, 4, causal=causal),
                jsa.sliding_window_layout(9, 3, causal=causal)):
        for port, ref in ((tsa.compact_layout, jpsa.compact_layout),
                          (tsa.compact_layout_t, jpsa.compact_layout_t)):
            for got, want in zip(port(lay, causal), ref(lay, causal)):
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    # an empty column: legal in the transposed lists, zero count, slot 0
    lay = np.eye(4, dtype=bool)
    lay[:, 0] = True
    lay[1, 1] = False
    for got, want in zip(tsa.compact_layout_t(lay, False), jpsa.compact_layout_t(lay, False)):
        np.testing.assert_array_equal(got, want)
    assert tsa.compact_layout_t(lay, False)[1][1] == 0


def test_empty_row_raises():
    empty = np.zeros((8, 8), bool)
    empty[0, 0] = True
    for fn in (tsa.compact_layout, jpsa.compact_layout):
        with pytest.raises(ValueError, match="attend to no kv block"):
            fn(empty, True)
    # a row whose only block lies above the diagonal is empty once causal
    upper = np.eye(4, dtype=bool)
    upper[2, 2], upper[2, 3] = False, True
    with pytest.raises(ValueError, match="after causal masking"):
        tsa.compact_layout(upper, True)
    tsa.compact_layout(upper, False)
    q = torch.zeros(1, 128, 2, 32)
    for use_kernel in (False, True, None):
        with pytest.raises(ValueError, match="attend to no kv block"):
            blocksparse_attention(q, q, q, empty, 16, causal=True, use_kernel=use_kernel)


def _qkv(b, s, h, hkv, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


LAYOUTS = {   # name: (layout builder over nb, causal)
    "sliding_causal": (lambda nb: jsa.sliding_window_layout(nb, 2), True),
    "bigbird_noncausal": (lambda nb: jsa.bigbird_layout(nb, 2, 1, 1), False),
    "fixed_causal": (lambda nb: jsa.fixed_layout(nb, 2, 3, causal=True), True),
    "bigbird_causal": (lambda nb: jsa.bigbird_layout(nb, 3, 1, 2, seed=3, causal=True), True),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plain_pieces_match_jax_kernels(name):
    """``(o, lse)`` against ``_sparse_fwd_lse``; ``(dq, dk, dv)`` against
    ``sparse_flash_attention_bwd`` from the same o and lse (MHA, where the
    JAX kernels' widened dK/dV are the narrow ones)."""
    b, s, h, d, bs = 2, 128, 2, 32, 16
    builder, causal = LAYOUTS[name]
    lay = builder(s // bs)
    q, k, v, do = _qkv(b, s, h, h, d, seed=5)
    scale = d ** -0.5
    o_j, lse_j = jpsa._sparse_fwd_lse(*map(jnp.asarray, (q, k, v)), lay, bs, causal=causal,
                                      scale=scale)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o_t, lse_t = sparse_attention_fwd(*t[:3], lay, bs, causal=causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], rtol=2e-5, atol=2e-5)
    g_j = jpsa.sparse_flash_attention_bwd(*map(jnp.asarray, (q, k, v)), o_j, lse_j,
                                          jnp.asarray(do), lay, bs, causal=causal, scale=scale)
    g_t = sparse_attention_bwd(*t[:3], o_t, lse_t, t[3], lay, bs, causal=causal)
    for got, ref, what in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4,
                                   err_msg=what)


def _grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    o = fn(*ts)
    (o ** 2).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(lay, bs, causal, use_kernel, arrays):
    def loss(q, k, v):
        o = jsa.blocksparse_attention(q, k, v, lay, bs, causal=causal, use_kernel=use_kernel)
        return jnp.sum(o ** 2), o

    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, arrays))
    return np.asarray(o), [np.asarray(x) for x in g]


@pytest.mark.parametrize("name", ["sliding_causal", "bigbird_noncausal"])
def test_kernel_path_matches_jax_kernel_path(name):
    """The JAX test's cases (``test_blocksparse_kernel_matches_dense_mask``):
    the port's autograd function against JAX ``use_kernel=True``."""
    b, s, h, d, bs = 2, 128, 2, 32, 16
    builder, causal = LAYOUTS[name]
    lay = builder(s // bs)
    arrays = _qkv(b, s, h, h, d, seed=3)[:3]
    o_j, g_j = _jax_grads(lay, bs, causal, True, arrays)
    o_t, g_t = _grads(lambda *t: BlockSparseAttention.apply(*t, lay, bs, causal, None),
                      arrays)
    np.testing.assert_allclose(o_t, o_j, rtol=2e-5, atol=2e-5)
    for got, ref, what in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, err_msg=what)


def test_gqa_grads_narrow_and_empty_kv_column_is_zero():
    """The JAX test ``test_blocksparse_bwd_gqa_and_empty_kv_columns``: 4
    query heads on 2 kv heads, and row 1 attending only block 0, so kv
    block 1 has no attender: its dK/dV are exactly zero in both packages."""
    b, s, h, hkv, d, bs = 2, 128, 4, 2, 32, 16
    nb = s // bs
    lay = np.eye(nb, dtype=bool)
    lay[:, 0] = True
    lay[1, 1] = False
    arrays = _qkv(b, s, h, hkv, d, seed=7)[:3]
    o_j, g_j = _jax_grads(lay, bs, False, True, arrays)
    o_t, g_t = _grads(lambda *t: BlockSparseAttention.apply(*t, lay, bs, False, None), arrays)
    np.testing.assert_allclose(o_t, o_j, rtol=2e-5, atol=2e-5)
    for got, ref, what in zip(g_t, g_j, "qkv"):
        assert got.shape == ref.shape, what
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, err_msg=what)
    dk, dv = g_t[1], g_t[2]
    assert dk.shape == (b, s, hkv, d)
    assert (dk[:, bs:2 * bs] == 0).all() and (dv[:, bs:2 * bs] == 0).all()
    assert np.abs(dk).sum() > 0


@pytest.mark.parametrize("causal", [True, False])
def test_dense_masked_path_matches_jax(causal):
    """``use_kernel=False``: plain attention under the token mask, equal to
    JAX's dense-masked path; and the same as the kernel path's pieces."""
    b, s, h, hkv, d, bs = 1, 64, 4, 2, 16, 8
    lay = jsa.bigbird_layout(s // bs, 2, 1, 1, seed=1, causal=causal)
    arrays = _qkv(b, s, h, hkv, d, seed=2)[:3]
    o_j, g_j = _jax_grads(lay, bs, causal, False, arrays)
    o_t, g_t = _grads(lambda *t: blocksparse_attention(*t, lay, bs, causal=causal,
                                                       use_kernel=False), arrays)
    np.testing.assert_allclose(o_t, o_j, rtol=1e-5, atol=1e-5)
    for got, ref in zip(g_t, g_j):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    o_k, g_k = _grads(lambda *t: BlockSparseAttention.apply(*t, lay, bs, causal, None), arrays)
    np.testing.assert_allclose(o_k, o_t, rtol=1e-5, atol=1e-5)
    for got, ref in zip(g_k, g_t):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_full_layout_is_dense_attention_and_diagonal_restricts():
    """The JAX tests ``test_blocksparse_full_layout_matches_dense`` and
    ``test_blocksparse_restricts_attention`` on the kernel path's pieces."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(2, 32, 4, 4, 16, seed=0))
    got = BlockSparseAttention.apply(q, k, v, np.ones((4, 4), bool), 8, True, None)
    torch.testing.assert_close(got, attention_torch(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-5)
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 8, seed=1))
    diag = np.eye(2, dtype=bool)
    out = BlockSparseAttention.apply(q, k, v, diag, 8, True, None)
    k2, v2 = k.clone(), v.clone()
    k2[:, :8], v2[:, :8] = 0, 0
    out2 = BlockSparseAttention.apply(q, k2, v2, diag, 8, True, None)
    torch.testing.assert_close(out[:, 8:], out2[:, 8:], rtol=1e-5, atol=0)


def test_entry_point_defaults_to_the_card_and_refuses_bad_shapes():
    q = torch.zeros(1, 64, 2, 32)
    lay = np.ones((4, 4), bool)
    for use_kernel in (None, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            blocksparse_attention(q, q, q, lay, 16, use_kernel=use_kernel)
    with pytest.raises(ValueError, match="not divisible"):
        blocksparse_attention(q, q, q, lay, 48)
    with pytest.raises(ValueError, match="layout"):
        blocksparse_attention(q, q, q, np.ones((2, 2), bool), 16)
    before = sparse_fwd_cuda.launches
    blocksparse_attention(q, q, q, lay, 16, use_kernel=False)
    BlockSparseAttention.apply(q, q, q, lay, 16, True, None)
    assert sparse_fwd_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        sparse_fwd_cuda(q, q, q, lay, 16)


def test_device_lists_are_cached():
    lay = jsa.bigbird_layout(8, 2, 1, 1, seed=2)
    a = tsa.layout_lists(lay, True, "cpu")
    assert tsa.layout_lists(lay.copy(), True, "cpu") is a
    assert tsa.layout_lists(lay, False, "cpu") is not a
    idx, cnt, idx_t, cnt_t = a
    want = jpsa.compact_layout(lay, True) + jpsa.compact_layout_t(lay, True)
    for got, ref in zip(a, want):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_host_compaction_runs_once_per_layout(monkeypatch):
    """The entry point and the plain forward check a layout's rows through
    the cached compaction: one compaction per ``(layout, causal)``, however
    many calls."""
    calls = []
    real = tsa.compact_layout
    monkeypatch.setattr(tsa, "compact_layout", lambda *a: calls.append(1) or real(*a))
    tsa._compacted.cache_clear()
    lay = jsa.bigbird_layout(8, 2, 1, 1, seed=4)
    q = torch.from_numpy(_qkv(1, 128, 2, 2, 16, seed=6)[0])
    for _ in range(3):
        blocksparse_attention(q, q, q, lay, 16, causal=True, use_kernel=False)
        tsa.sparse_fwd_torch(q, q, q, lay, 16, causal=True)
    assert len(calls) == 1


@pytest.mark.parametrize("q_chunk", [16, 48, 100])
def test_chunked_plain_pieces_equal_whole(q_chunk):
    """``q_chunk`` (how the card holds the plain pieces at long sequences)
    computes the same rows: o, lse and dq equal, dK/dV summed over the
    chunks in fp64 and rounded once, within 1e-6."""
    b, s, h, hkv, d, bs = 2, 128, 4, 2, 32, 16
    builder, causal = LAYOUTS["bigbird_causal"]
    lay = builder(s // bs)
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(b, s, h, hkv, d, seed=7))
    o, lse = tsa.sparse_fwd_torch(q, k, v, lay, bs, causal=causal)
    o_c, lse_c = tsa.sparse_fwd_torch(q, k, v, lay, bs, causal=causal, q_chunk=q_chunk)
    torch.testing.assert_close(o_c, o, rtol=0, atol=0)
    torch.testing.assert_close(lse_c, lse, rtol=0, atol=0)
    whole = tsa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)
    chunked = tsa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal,
                                   q_chunk=q_chunk)
    torch.testing.assert_close(chunked[0], whole[0], rtol=0, atol=0)
    for got, ref in zip(chunked[1:], whole[1:]):
        assert got.shape == ref.shape == k.shape
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# the forward / dQ work items of sparse_attention.cu (mma_items)
# --------------------------------------------------------------------------- #
ITEM_LAYOUTS = {   # 16 blocks: name -> (layout, causal)
    "bigbird_causal": (lambda: tsa.bigbird_layout(16, 3, 1, 2, seed=0, causal=True), True),
    "fixed_noncausal": (lambda: tsa.fixed_layout(16, 4, 4, causal=False), False),
    "sliding_causal": (lambda: tsa.sliding_window_layout(16, 4, causal=True), True),
}
ITEM_ROUTES = [(torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 64),
               (torch.float32, 32), (torch.float32, 128)]


@pytest.mark.parametrize("dtype,block", ITEM_ROUTES)
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(ITEM_LAYOUTS))
def test_mma_items_hold_each_q_block_and_head_once_longest_first(name, group, dtype, block):
    """Every (q block, 64-row part, query head of the group) in exactly one
    item, an item's heads as many as fit ``MMA_ITEM_ROWS`` and divide the
    group, the q blocks longest compacted list first."""
    builder, causal = ITEM_LAYOUTS[name]
    lay = builder()
    plan = tsa.mma_items(lay, causal, block, group, dtype)
    items, heads, rows = plan["items"], plan["heads"], plan["rows"]
    assert items.dtype == np.int32 and items.shape[1] == len(tsa.ITEM_FIELDS)
    assert rows == min(block, 64) and group % heads == 0
    cap = tsa.MMA_ITEM_ROWS[dtype]
    assert heads * rows <= cap
    assert all(group % more or more * rows > cap for more in range(heads + 1, group + 1))
    got = sorted((qb, part, h) for qb, part, h0 in items.tolist()
                 for h in range(h0, h0 + heads))
    want = [(qb, part, h) for qb in range(16) for part in range(block // rows)
            for h in range(group)]
    assert got == want
    _, cnt = tsa.compact_layout(lay, causal)
    assert (np.diff(cnt[items[:, 0]]) <= 0).all()
    assert not items.flags.writeable


@pytest.mark.parametrize("group,block,dtype,heads", [
    (4, 32, torch.bfloat16, 4), (4, 16, torch.bfloat16, 4), (4, 64, torch.bfloat16, 2),
    (8, 32, torch.bfloat16, 4), (1, 64, torch.bfloat16, 1), (3, 64, torch.bfloat16, 1),
    (6, 32, torch.bfloat16, 3), (5, 16, torch.bfloat16, 5), (4, 32, torch.float32, 2),
    (4, 128, torch.float32, 1), (8, 16, torch.float32, 4)])
def test_mma_heads_per_item(group, block, dtype, heads):
    """Llama's 32/8 heads at block 32 stack all 4 query heads (8 warps);
    block 64 two items of 2; fp32 half the rows."""
    assert tsa.mma_heads_per_item(group, block, dtype) == heads


def test_mma_items_are_cached_per_layout():
    lay = tsa.bigbird_layout(16, 3, 1, 2, seed=0, causal=True)
    a = tsa.mma_items(lay, True, 32, 4, torch.bfloat16)["items"]
    assert tsa.mma_items(lay.copy(), True, 32, 4, torch.bfloat16)["items"] is a
    for other in ((lay, False, 32, 4, torch.bfloat16), (lay, True, 16, 4, torch.bfloat16),
                  (lay, True, 32, 2, torch.bfloat16), (lay, True, 32, 4, torch.float32)):
        assert tsa.mma_items(*other)["items"] is not a
