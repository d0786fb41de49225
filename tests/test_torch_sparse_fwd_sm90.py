"""The work items and the tile walk of the block-sparse forward on Hopper
(``ops/csrc/sparse_sm90.cu``), on the CPU.

- The forward takes the dQ kernel's work items (``dq_item_order``: every
  (q block, batch, head) once, longest compacted list first, the heads of a
  q block together); dealt over 132 SMs forward and backward in turn, at
  ``chip_smoke.py``'s S 16384 and S 4096 layouts, no SM's kv tiles exceed
  the mean by more than one item's.
- A plain-torch rendering of the kernel's walk: per item and consumer
  warpgroup (64 q rows), the two 64-row kv tiles of each listed kv block in
  list order, where on a causal layout's diagonal block the tile below the
  rows is visible whole, the tile on them takes the element mask and the
  tile above them is skipped; an online softmax over the tiles in base-2
  units (running max, sum and accumulator rescaled at each tile, as the
  kernel's registers; fp64 here), then o = O / l and lse = m ln 2 + log l.
  It equals ``sparse_fwd_torch`` (fp32 inputs) within 1e-5 of the output's
  largest magnitude (fp32 against fp64 sums) and lse within 1e-5, and the
  JAX package's Pallas forward in interpret mode at the 2e-5 of
  ``tests/test_torch_sparse_attention.py``. Its planted faults 7 (each
  list's last entry left out) and 9 (the diagonal block's mask left out)
  do not.
"""

import math

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
    forward in item order, as its ``FwdItem`` reads them."""
    order = tsa.dq_item_order(layout, causal).astype(np.int64)
    w = np.arange(len(order) * batch * heads)
    bh = w % (batch * heads)
    return np.stack([order[w // (batch * heads)], bh // heads, bh % heads], 1)


@pytest.mark.parametrize("name", sorted(SMOKE_LAYOUTS))
def test_fwd_items_cover_each_block_once_and_deal_evenly(name):
    builder, causal = SMOKE_LAYOUTS[name]
    lay = builder()
    nb = lay.shape[0]
    _, cnt = tsa.compact_layout(lay, causal)
    items = work_items(lay, causal, 1, 32)
    assert {tuple(int(x) for x in it) for it in items} == \
        {(qb, 0, h) for qb in range(nb) for h in range(32)}
    tiles = 2 * cnt[items[:, 0]]
    assert (np.diff(tiles) <= 0).all()   # longest first
    sms, load = 132, np.zeros(132)
    for k in range(-(-len(tiles) // sms)):
        for c in range(sms):
            w = k * sms + (sms - 1 - c if k & 1 else c)
            if w < len(tiles):
                load[c] += tiles[w]
    assert load.max() <= tiles.sum() / sms + tiles.max()


def fwd_walk(q, k, v, layout, causal, fault=0):
    """``sparse_sm90.cu``'s forward in plain torch: ``(o, lse [B * H, S])``
    over the kernel's items and tiles (fault 7: each list's last entry left
    out; 9: the diagonal mask left out)."""
    b, s, h, d = q.shape
    g, sl2 = h // k.shape[2], d ** -0.5 * math.log2(math.e)
    idx, cnt = tsa.compact_layout(layout, causal)
    qd, kd, vd = (t.double() for t in (q, k, v))
    tri = torch.ones(TILE, TILE, dtype=torch.bool).tril()   # [q row, kv col] visible
    o = torch.zeros_like(qd)
    lse = torch.zeros(b, h, s, dtype=torch.float64)
    for qb, bb, hh in work_items(layout, causal, b, h).tolist():
        hk = hh // g
        for cw in range(BS // TILE):
            r = slice(qb * BS + cw * TILE, qb * BS + (cw + 1) * TILE)
            m = torch.full((TILE,), -math.inf, dtype=torch.float64)
            l = torch.zeros(TILE, dtype=torch.float64)
            acc = torch.zeros(TILE, d, dtype=torch.float64)
            for j in range(int(cnt[qb]) - (fault == 7)):
                kb = int(idx[qb, j])
                diag = causal and kb == qb
                for t in range(BS // TILE):
                    if diag and t > cw:        # above the diagonal: skipped
                        continue
                    c = slice(kb * BS + t * TILE, kb * BS + (t + 1) * TILE)
                    x = (qd[bb, r, hh] @ kd[bb, c, hk].T) * sl2
                    if diag and t == cw and fault != 9:
                        x = x.masked_fill(~tri, -math.inf)
                    mn = torch.maximum(m, x.max(1).values)
                    alpha = torch.exp2(m - mn)
                    p = torch.exp2(x - mn[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ vd[bb, c, hk]
                    m = mn
            o[bb, r, hh] = acc / l[:, None]
            lse[bb, hh, r] = m * math.log(2) + torch.log(l)
    return o.float(), lse.reshape(b * h, s).float()


def _inputs(b, s, h, hkv, d, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32))
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


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
def test_fwd_walk_equals_plain_and_its_faults_do_not(name):
    lay, causal = WALK_LAYOUTS[name]
    s, h, hkv, d = 6 * BS, 4, 2, 32
    q, k, v = _inputs(1, s, h, hkv, d, seed=len(name))
    o_ref, lse_ref = tsa.sparse_fwd_torch(q, k, v, lay, BS, causal=causal)
    tol = 1e-5 * float(o_ref.abs().max())

    def close(got):
        np.testing.assert_allclose(got[0].numpy(), o_ref.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(got[1].numpy(), lse_ref.numpy(), rtol=0, atol=1e-5)

    close(fwd_walk(q, k, v, lay, causal))
    faults = (7, 9) if causal and np.diag(lay).any() else (7,)
    for fault in faults:
        with pytest.raises(AssertionError):
            close(fwd_walk(q, k, v, lay, causal, fault))


def test_fwd_walk_matches_jax_kernel():
    """MHA, bigbird causal at block 128: the walk's o and lse against
    ``_sparse_fwd_lse`` (interpret mode)."""
    b, s, h, d = 1, 4 * BS, 2, 32
    lay = tsa.bigbird_layout(4, 2, 1, 1, seed=3, causal=True)
    q, k, v = _inputs(b, s, h, h, d, seed=5)
    o_j, lse_j = jpsa._sparse_fwd_lse(*(jnp.asarray(t.numpy()) for t in (q, k, v)), lay, BS,
                                      causal=True, scale=d ** -0.5)
    o, lse = fwd_walk(q, k, v, lay, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0].reshape(b * h, s),
                               rtol=2e-5, atol=2e-5)
