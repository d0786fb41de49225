"""The work items and the step walk of the block-sparse forward and dQ of
``ops/csrc/sparse_attention.cu`` (bf16 at blocks 16-64, fp32 at every
block), on the CPU.

- A plain-torch rendering of the two kernels' walk: per work item of
  ``mma_items`` (q rows of one q block, the query heads of one kv head
  stacked) and kv head, each 16-row warp of one query head takes the item's
  steps, its q block's list in kv sub-tiles of min(rows, KT) rows (KT 16
  and 32: the widths the two kernels step by), less the
  sub-tiles of a causal diagonal block wholly above the item's rows. A
  sub-tile after every row of the warp is skipped, one the diagonal crosses
  takes the element mask, the rest none: each asserted against the token
  mask, and the visited sub-tiles asserted to hold every visible key. The
  forward's online softmax runs in base-2 units (fp64), the dQ's p from
  lse.
- The walk equals ``sparse_fwd_torch`` (o within 1e-5 of its largest
  magnitude, lse within 1e-5) and ``sparse_bwd_torch``'s dq (within 1e-5 of
  its largest magnitude) on fp32 inputs, and the JAX package's Pallas
  kernels in interpret mode at the 2e-5 / 2e-4 of
  ``tests/test_torch_sparse_attention.py``. Its planted fault 3 (dQ leaves
  the item's last query head out) does not.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas import sparse_attention as jpsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa


def _steps(idx, cnt, qb, q0_in_block, rows, kt, bs, causal):
    """First kv row of each step of an item, as ``QItem`` counts them."""
    subs, n = bs // kt, int(cnt[qb]) * (bs // kt)
    if causal and idx[qb, cnt[qb] - 1] == qb:
        n -= subs - min(subs, (q0_in_block + rows - 1) // kt + 1)
    return [int(idx[qb, s // subs]) * bs + (s % subs) * kt for s in range(n)]


def walk(q, k, v, do, lse, delta, layout, bs, causal, dtype, kt=32, fault=0):
    """``(o, lse [B * H, S], dq)`` as the kernels' items and steps of
    ``min(rows, kt)`` kv rows compute them (``lse`` and ``delta`` feed the
    dQ walk); fault 3 leaves each item's last query head out of dQ."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g, scale = h // hkv, d ** -0.5
    sl2 = scale * math.log2(math.e)
    plan = tsa.mma_items(layout, causal, bs, g, dtype)
    rows, heads = plan["rows"], plan["heads"]
    kt = min(rows, kt)
    idx, cnt = tsa.compact_layout(layout, causal)
    vis = tsa.token_mask(layout, bs, causal, "cpu")
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    lse2 = lse.reshape(b, h, s).double() * math.log2(math.e)
    delta = delta.reshape(b, h, s).double()
    o, dq = torch.zeros_like(qd), torch.zeros_like(qd)
    lse_o = torch.zeros(b, h, s, dtype=torch.float64)
    for qb, part, h0 in plan["items"].tolist():
        q0 = qb * bs + part * rows
        starts = _steps(idx, cnt, qb, part * rows, rows, kt, bs, causal)
        for bb in range(b):
            for hk in range(hkv):
                for j in range(heads):
                    hq = hk * g + h0 + j
                    for w0 in range(q0, q0 + rows, 16):
                        r = torch.arange(w0, w0 + 16)
                        m = torch.full((16,), -math.inf, dtype=torch.float64)
                        l = torch.zeros(16, dtype=torch.float64)
                        acc = torch.zeros(16, d, dtype=torch.float64)
                        dqa = torch.zeros(16, d, dtype=torch.float64)
                        seen = torch.zeros(16, s, dtype=torch.bool)
                        for c0 in starts:
                            c = torch.arange(c0, c0 + kt)
                            sub = vis[r][:, c]
                            if causal and c0 > w0 + 15:    # every key after the rows
                                assert not sub.any()
                                continue
                            mask = causal and c0 + kt - 1 > w0
                            assert sub.any() if mask else sub.all()
                            seen[:, c] = True
                            sc = qd[bb, r, hq] @ kd[bb, c, hk].T
                            x = sc * sl2
                            if mask:
                                x = x.masked_fill(~sub, -math.inf)
                            mn = torch.maximum(m, x.max(1).values)
                            alpha = torch.exp2(m - mn)
                            p = torch.exp2(x - mn[:, None])
                            l = l * alpha + p.sum(1)
                            acc = acc * alpha[:, None] + p @ vd[bb, c, hk]
                            m = mn
                            if fault == 3 and j == heads - 1:
                                continue
                            pd = torch.exp2(x - lse2[bb, hq, r, None])
                            dp = dod[bb, r, hq] @ vd[bb, c, hk].T
                            dqa += (pd * (dp - delta[bb, hq, r, None]) * scale) @ kd[bb, c, hk]
                        assert not (vis[r] & ~seen).any()   # every visible key visited
                        o[bb, r, hq] = acc / l[:, None]
                        lse_o[bb, hq, r] = m * math.log(2) + torch.log(l)
                        dq[bb, r, hq] = dqa
    return o.float(), lse_o.reshape(b * h, s).float(), dq.float()


def _inputs(b, s, h, hkv, d, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32))
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


def _off_diagonal(nb):
    lay = np.zeros((nb, nb), bool)
    lay[:, 0] = True
    lay[np.arange(1, nb), np.arange(nb - 1)] = True
    return lay


WALK_LAYOUTS = {   # 6 blocks: name -> (layout, causal)
    "bigbird_causal": (tsa.bigbird_layout(6, 2, 1, 1, seed=1, causal=True), True),
    "fixed_noncausal": (tsa.fixed_layout(6, 2, 3, causal=False), False),
    "sliding_causal": (tsa.sliding_window_layout(6, 2, causal=True), True),
    "off_diagonal_causal": (_off_diagonal(6), True),
}
# (dtype, block): the routes sparse_source gives sparse_attention.cu; the
# dtype sets the heads an item stacks (fp32 at block 128: two 64-row parts)
ROUTES = [(torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 64),
          (torch.float32, 32), (torch.float32, 128)]


def _reference(q, k, v, do, lay, bs, causal):
    o, lse = tsa.sparse_fwd_torch(q, k, v, lay, bs, causal=causal)
    b, s, h, _ = q.shape
    delta = (do * o).sum(-1).transpose(1, 2).reshape(b * h, s)
    dq = tsa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)[0]
    return o, lse, delta, dq


def _close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()), err_msg=what)


@pytest.mark.parametrize("kt", [16, 32])
@pytest.mark.parametrize("dtype,bs", ROUTES)
@pytest.mark.parametrize("name", sorted(WALK_LAYOUTS))
def test_walk_equals_plain_pieces(name, dtype, bs, kt):
    """GQA 8/2: four query heads a kv head, stacked one to four an item."""
    lay, causal = WALK_LAYOUTS[name]
    q, k, v, do = _inputs(1, 6 * bs, 8, 2, 32, seed=bs + len(name))
    o_ref, lse_ref, delta, dq_ref = _reference(q, k, v, do, lay, bs, causal)
    o, lse, dq = walk(q, k, v, do, lse_ref, delta, lay, bs, causal, dtype, kt)
    _close(o, o_ref, "o")
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=0, atol=1e-5)
    _close(dq, dq_ref, "dq")


@pytest.mark.parametrize("h,hkv", [(3, 1), (2, 2), (16, 2)])
def test_walk_at_other_groups_and_its_fault_3(h, hkv):
    """Groups 3 (one head an item at block 64), 1 and 8 (two items of four
    heads at block 32); dQ without each item's last head fails."""
    lay, causal = WALK_LAYOUTS["bigbird_causal"]
    bs = 64 if h == 3 else 32
    q, k, v, do = _inputs(1, 6 * bs, h, hkv, 32, seed=h)
    o_ref, lse_ref, delta, dq_ref = _reference(q, k, v, do, lay, bs, causal)
    o, _, dq = walk(q, k, v, do, lse_ref, delta, lay, bs, causal, torch.bfloat16)
    _close(o, o_ref, "o")
    _close(dq, dq_ref, "dq")
    _, _, bad = walk(q, k, v, do, lse_ref, delta, lay, bs, causal, torch.bfloat16, fault=3)
    with pytest.raises(AssertionError):
        _close(bad, dq_ref, "dq")


def test_walk_matches_jax_kernels():
    """MHA, bigbird causal at block 32: the walk's o, lse and dq against
    ``_sparse_fwd_lse`` and ``sparse_flash_attention_bwd`` (interpret
    mode)."""
    b, bs, h, d = 1, 32, 2, 32
    s = 6 * bs
    lay, causal = WALK_LAYOUTS["bigbird_causal"]
    q, k, v, do = _inputs(b, s, h, h, d, seed=7)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    o_j, lse_j = jpsa._sparse_fwd_lse(jq, jk, jv, lay, bs, causal=causal, scale=d ** -0.5)
    dq_j = jpsa.sparse_flash_attention_bwd(jq, jk, jv, o_j, lse_j, jdo, lay, bs, causal=causal,
                                           scale=d ** -0.5)[0]
    lse_ref = torch.from_numpy(np.asarray(lse_j)[..., 0].reshape(b * h, s).copy())
    o_ref = torch.from_numpy(np.asarray(o_j).copy())
    delta = (do * o_ref).sum(-1).transpose(1, 2).reshape(b * h, s)
    o, lse, dq = walk(q, k, v, do, lse_ref, delta, lay, bs, causal, torch.bfloat16)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=2e-4, atol=2e-4)
