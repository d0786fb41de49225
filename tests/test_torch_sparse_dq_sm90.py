"""The work items and the tile walk of the block-sparse dQ kernel on Hopper
(``ops/csrc/sparse_sm90.cu``), on the CPU.

- The kernel's work items (its ``DqItem`` over ``dq_item_order``) hold
  every (q block, batch, head) exactly once, longest compacted list first,
  the heads of a q block together, at ``chip_smoke.py``'s S 16384 bigbird
  layout and its three S 4096 layouts; dealt over 132 SMs forward and
  backward in turn, as the persistent grid deals them, no SM's kv tiles
  exceed the mean by more than one item's, and the longest item is under a
  third of the mean (so no row needs a split; the fixed non-causal
  layout's global rows included).
- A plain-torch rendering of the kernel's walk: per item and consumer
  warpgroup (64 q rows), the two 64-row kv tiles of each listed kv block,
  where on a causal layout's diagonal block the tile below the rows is
  visible whole, the tile on them takes the element mask and the tile above
  them is skipped; products in fp64. It equals ``sparse_bwd_torch``'s dQ
  (fp32 inputs) within 1e-5 of the output's largest magnitude (fp32 against
  fp64 sums), and the JAX package's Pallas dQ kernel in interpret mode at
  the 2e-4 of ``tests/test_torch_sparse_attention.py``. Its planted faults 4
  (each list's last entry left out) and 6 (the diagonal block's mask left
  out) do not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas import sparse_attention as jpsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

BS, TILE = 128, 64   # the kernel's layout block and ring tile

SMOKE_LAYOUTS = {   # chip_smoke.py's: name -> (layout, causal)
    "S16384 bigbird causal": (lambda: tsa.bigbird_layout(128, 3, 1, 2, seed=0, causal=True),
                              True),
    "S4096 bigbird causal": (lambda: tsa.bigbird_layout(32, 3, 1, 2, seed=0, causal=True), True),
    "S4096 fixed non-causal": (lambda: tsa.fixed_layout(32, 4, 4, causal=False), False),
    "S4096 sliding window": (lambda: tsa.sliding_window_layout(32, 4, causal=True), True),
}


def work_items(layout, causal, batch, heads):
    """int64 ``[items, 3]``: (q block, batch, head) of each work item of the
    dQ kernel in item order, as its ``DqItem`` reads them."""
    order = tsa.dq_item_order(layout, causal).astype(np.int64)
    w = np.arange(len(order) * batch * heads)
    bh = w % (batch * heads)
    return np.stack([order[w // (batch * heads)], bh // heads, bh % heads], 1)


@pytest.mark.parametrize("batch,heads", [(1, 32), (2, 3)])
@pytest.mark.parametrize("name", sorted(SMOKE_LAYOUTS))
def test_dq_items_cover_each_block_and_head_once_longest_first(name, batch, heads):
    builder, causal = SMOKE_LAYOUTS[name]
    lay = builder()
    nb = lay.shape[0]
    _, cnt = tsa.compact_layout(lay, causal)
    items = work_items(lay, causal, batch, heads)
    assert items.shape == (nb * batch * heads, 3)
    keys = {tuple(int(x) for x in it) for it in items}
    assert keys == {(qb, b, h) for qb in range(nb) for b in range(batch) for h in range(heads)}
    lengths = cnt[items[:, 0]]
    assert (np.diff(lengths) <= 0).all()
    # all (batch, head) of one q block together, in order
    per_block = items.reshape(nb, batch * heads, 3)
    assert (per_block[:, :, 0] == per_block[:, :1, 0]).all()
    assert (per_block[:, :, 1] * heads + per_block[:, :, 2] == np.arange(batch * heads)).all()
    assert tsa.dq_item_order(lay, causal) is tsa.dq_item_order(lay, causal)   # cached


@pytest.mark.parametrize("name", sorted(SMOKE_LAYOUTS))
def test_dq_deal_over_132_sms_is_balanced(name):
    """Each SM's kv tiles (two per listed kv block and item) when the grid
    of 132 blocks takes round k's items k * 132 + c (even k) or k * 132 +
    131 - c (odd k), at 32 heads: the busiest within one item of the mean,
    the longest item under a third of it."""
    builder, causal = SMOKE_LAYOUTS[name]
    lay = builder()
    _, cnt = tsa.compact_layout(lay, causal)
    tiles = 2 * cnt[work_items(lay, causal, 1, 32)[:, 0]]
    sms, load = 132, np.zeros(132)
    for k in range(-(-len(tiles) // sms)):
        for c in range(sms):
            w = k * sms + (sms - 1 - c if k & 1 else c)
            if w < len(tiles):
                load[c] += tiles[w]
    mean = tiles.sum() / sms
    assert load.max() <= mean + tiles.max()
    assert tiles.max() < mean / 3


def dq_walk(q, k, v, do, lse, delta, layout, causal, fault=0):
    """``sparse_sm90.cu``'s dQ in plain torch: items in ``work_items``
    order, each consumer's 64 rows over the tiles the kernel issues (fault
    4: each list's last entry left out; 6: the diagonal mask left out)."""
    b, s, h, d = q.shape
    g, scale = h // k.shape[2], d ** -0.5
    idx, cnt = tsa.compact_layout(layout, causal)
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    lse = lse.reshape(b, h, s).double()
    delta = delta.reshape(b, h, s).double()
    tri = torch.ones(TILE, TILE, dtype=torch.bool).tril()   # [q row, kv col] visible
    dq = torch.zeros_like(qd)
    for qb, bb, hh in work_items(layout, causal, b, h).tolist():
        hk = hh // g
        for cw in range(BS // TILE):
            r = slice(qb * BS + cw * TILE, qb * BS + (cw + 1) * TILE)
            acc = torch.zeros(TILE, d, dtype=torch.float64)
            for j in range(int(cnt[qb]) - (fault == 4)):
                kb = int(idx[qb, j])
                diag = causal and kb == qb
                for t in range(BS // TILE):
                    if diag and t > cw:        # above the diagonal: skipped
                        continue
                    c = slice(kb * BS + t * TILE, kb * BS + (t + 1) * TILE)
                    p = torch.exp(scale * qd[bb, r, hh] @ kd[bb, c, hk].T
                                  - lse[bb, hh, r, None])
                    if diag and t == cw and fault != 6:
                        p = p * tri
                    dp = dod[bb, r, hh] @ vd[bb, c, hk].T
                    ds = p * (dp - delta[bb, hh, r, None]) * scale
                    acc += ds @ kd[bb, c, hk]
            dq[bb, r, hh] = acc
    return dq.float()


def _inputs(b, s, h, hkv, d, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32))
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


def _off_diagonal(nb):
    lay = np.zeros((nb, nb), bool)
    lay[:, 0] = True
    lay[np.arange(1, nb), np.arange(nb - 1)] = True
    return lay


WALK_LAYOUTS = {   # 6 blocks of 128: name -> (layout, causal)
    "bigbird_causal": (tsa.bigbird_layout(6, 2, 1, 1, seed=1, causal=True), True),
    "bigbird_noncausal": (tsa.bigbird_layout(6, 2, 1, 1, seed=2), False),
    "fixed_noncausal": (tsa.fixed_layout(6, 2, 3, causal=False), False),
    "sliding_causal": (tsa.sliding_window_layout(6, 2, causal=True), True),
    "off_diagonal_causal": (_off_diagonal(6), True),
}


@pytest.mark.parametrize("name", sorted(WALK_LAYOUTS))
def test_dq_walk_equals_plain_and_its_faults_do_not(name):
    lay, causal = WALK_LAYOUTS[name]
    s, h, hkv, d = 6 * BS, 4, 2, 32
    q, k, v, do = _inputs(1, s, h, hkv, d, seed=len(name))
    o, lse = tsa.sparse_fwd_torch(q, k, v, lay, BS, causal=causal)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(h, s)
    dq_ref, _, _ = tsa.sparse_bwd_torch(q, k, v, o, lse, do, lay, BS, causal=causal)
    tol = 1e-5 * float(dq_ref.abs().max())

    def close(got):
        np.testing.assert_allclose(got.numpy(), dq_ref.numpy(), rtol=0, atol=tol)

    close(dq_walk(q, k, v, do, lse, delta, lay, causal))
    faults = (4, 6) if causal and np.diag(lay).any() else (4,)
    for fault in faults:
        with pytest.raises(AssertionError):
            close(dq_walk(q, k, v, do, lse, delta, lay, causal, fault))


def test_dq_walk_matches_jax_kernel():
    """MHA, bigbird causal at block 128: the walk's dQ against
    ``sparse_flash_attention_bwd`` (interpret mode) from the same o and lse."""
    b, s, h, d = 1, 4 * BS, 2, 32
    lay = tsa.bigbird_layout(4, 2, 1, 1, seed=3, causal=True)
    q, k, v, do = _inputs(b, s, h, h, d, seed=4)
    o_j, lse_j = jpsa._sparse_fwd_lse(*(jnp.asarray(t.numpy()) for t in (q, k, v)), lay, BS,
                                      causal=True, scale=d ** -0.5)
    dq_j, _, _ = jpsa.sparse_flash_attention_bwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), o_j, lse_j, jnp.asarray(do.numpy()),
        lay, BS, causal=True, scale=d ** -0.5)
    o = torch.from_numpy(np.array(o_j))
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy()).reshape(b * h, s)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(b * h, s)
    dq = dq_walk(q, k, v, do, lse, delta, lay, True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=2e-4, atol=2e-4)
