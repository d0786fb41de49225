"""Paged decode attention: the PyTorch port against the JAX package.

The port's plain ``paged_decode_attention_torch`` is held against JAX
``paged_decode_attention`` (the Pallas kernel in interpret mode, as
``tests/test_pallas_kernels.py`` runs it) and ``paged_decode_attention_xla``
on the same numpy inputs: GQA groups g in {1, 2, 4}, context lengths 0 (an
inactive slot on the trash block), bs-1, bs, bs+1 and the full table, a
shuffled block table that includes the trash block, and sliding windows
(static and as a tensor). The CUDA kernel is held against the plain version
on a GPU by ``tests/test_torch_cuda_kernels.py``.

Tolerance: fp32 2e-5, the JAX kernel tests' own bound for this op (online
vs one-shot softmax reassociate the sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_decode_attention, paged_decode_attention_xla)
from deepspeed_tpu_torch.ops import get_op
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_decode_attention_cuda, paged_decode_attention_torch)

NH, HD, BS, NBLOCKS, MAX_BLOCKS = 8, 64, 8, 24, 4


def _inputs(nkv, seed=0):
    rs = np.random.RandomState(seed)
    ctx = np.array([0, BS - 1, BS, BS + 1, MAX_BLOCKS * BS - 1], np.int32)
    B = len(ctx)
    q = rs.randn(B, NH, HD).astype(np.float32)
    kp = rs.randn(NBLOCKS, nkv, BS, HD).astype(np.float32)
    vp = rs.randn(NBLOCKS, nkv, BS, HD).astype(np.float32)
    # shuffled tables drawn from the whole pool, trash block 0 included
    tables = np.stack([rs.permutation(NBLOCKS)[:MAX_BLOCKS]
                       for _ in range(B)]).astype(np.int32)
    tables[0] = 0          # the inactive slot points at the trash block only
    tables[1, 1] = 0       # an unused table entry past the context (ctx = bs-1)
    return q, kp, vp, tables, ctx


def _port(q, kp, vp, tables, ctx, **kw):
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, ctx)]
    return paged_decode_attention_torch(*t, **kw).numpy()


@pytest.mark.parametrize("nkv", [8, 4, 2])     # g = 1, 2, 4
@pytest.mark.parametrize("window", [None, 1, 5, 64])
def test_paged_decode_matches_jax(nkv, window):
    q, kp, vp, tables, ctx = _inputs(nkv, seed=nkv)
    got = _port(q, kp, vp, tables, ctx, window=window)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, ctx)]
    kernel = np.asarray(paged_decode_attention(*args, window=window))
    xla = np.asarray(paged_decode_attention_xla(*args, window=window))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-5)


def test_paged_decode_ctx0_attends_position_zero():
    """An inactive slot (ctx = 0, trash block) attends exactly position 0:
    its output is V at block 0, offset 0, for every query row."""
    q, kp, vp, tables, ctx = _inputs(4, seed=1)
    got = _port(q, kp, vp, tables, ctx)
    g = NH // 4
    want = np.repeat(vp[0, :, 0], g, axis=0)           # [NH, HD]
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)


def test_paged_decode_tensor_window_and_dispatch():
    """A 0-d window tensor gives the static window's result; CPU tensors
    reach the plain version and launch nothing."""
    q, kp, vp, tables, ctx = _inputs(2, seed=5)
    before = paged_decode_attention_cuda.launches
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, ctx)]
    assert get_op("paged_decode_attention", t[0].device) is \
        paged_decode_attention_torch
    a = paged_decode_attention_torch(*t, window=torch.tensor(6, dtype=torch.int32))
    b = paged_decode_attention_torch(*t, window=6)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = paged_decode_attention_xla(*[jnp.asarray(x) for x in (q, kp, vp, tables, ctx)],
                                     window=jnp.asarray(6, jnp.int32))
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert paged_decode_attention_cuda.launches == before
    with pytest.raises(ValueError, match=">= 1"):
        paged_decode_attention_torch(*t, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_cuda(*t)
