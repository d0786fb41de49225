"""Flash attention's bias mode: the PyTorch port against the JAX package, on
the CPU.

The port's plain bias-mode pieces (``flash_fwd_torch`` / ``flash_bwd_torch``
with ``bias=``, which the CUDA kernels' bias mode is held against on the
card, and :class:`FlashAttentionBias` over them) against the JAX package's
Pallas flash kernels with ``has_bias`` (``_flash_fwd`` / ``_flash_bwd`` and
the public ``flash_attention(bias=...)``), run in interpret mode as
``tests/test_pallas_kernels.py`` runs them, on the same numpy inputs.
``DSTPU_FLASH_BLOCK=16`` makes the JAX kernels walk several q and kv blocks
at these small shapes. fp32 on both sides: o, lse, dq, dk, dv and dbias at
1e-4 (the same arithmetic in another summation order).

The port reads the bias in place at its broadcast shape and keeps GQA K/V
narrow; the JAX kernels take a materialised ``[B * H, Sq, Skv]`` bias and
widened K/V, so dK/dV are compared with the query group summed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops.attention import attention_torch
from deepspeed_tpu_torch.ops.flash_attention import (
    FlashAttentionBias, flash_attention, flash_attention_bwd, flash_attention_fwd,
    flash_bwd_dkv_bias_cuda, flash_bwd_dq_bias_cuda, flash_fwd_bias_cuda, flash_fwd_cuda)

# (B, Sq, Skv, H, Hkv, D, causal, bias shape)
CASES = {
    "alibi_causal": (2, 48, 48, 4, 4, 32, True, "h1k"),        # BLOOM: [H, 1, Skv]
    "full_causal_tail": (1, 40, 40, 2, 2, 32, True, "bhqk"),   # ragged last block
    "pair_noncausal": (3, 32, 32, 4, 4, 16, False, "1hqk"),    # evoformer's pair bias
    "full_noncausal_gqa": (1, 24, 56, 4, 2, 32, False, "bhqk"),
    "row_bias_gqa_causal": (2, 64, 64, 4, 1, 32, True, "b11k"),
}
SHAPES = {"h1k": lambda B, H, Sq, Skv: (H, 1, Skv),
          "bhqk": lambda B, H, Sq, Skv: (B, H, Sq, Skv),
          "1hqk": lambda B, H, Sq, Skv: (1, H, Sq, Skv),
          "b11k": lambda B, H, Sq, Skv: (B, 1, 1, Skv)}


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "16")


def _inputs(case, seed=0):
    B, sq, skv, h, hkv, d, _, kind = case
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(*s).astype(np.float32)
              for s in ((B, sq, h, d), (B, skv, hkv, d), (B, skv, hkv, d), (B, sq, h, d))]
    bias = (2 * rs.randn(*SHAPES[kind](B, h, sq, skv))).astype(np.float32)
    return arrays + [bias]


def _to_bh(x, h):
    """[B, S, Hx, D] numpy → the JAX kernels' [B * h, S, D] (widened to h)."""
    B, S, hx, D = x.shape
    x = np.repeat(x, h // hx, axis=2)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * h, S, D))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bias_pieces_match_jax_kernels(name, small_blocks):
    """``(o, lse)`` against ``_flash_fwd(bias)``; ``(dq, dk, dv, dbias)``
    against ``_flash_bwd(bias)`` from the same o and lse."""
    case = CASES[name]
    B, sq, skv, h, hkv, d, causal, _ = case
    q, k, v, do, bias = _inputs(case)
    scale = d ** -0.5
    bias_bh = jnp.asarray(np.broadcast_to(bias, (B, h, sq, skv)).reshape(B * h, sq, skv))
    o_j, lse_j = jfa._flash_fwd(_to_bh(q, h), _to_bh(k, h), _to_bh(v, h), bias_bh,
                                causal=causal, scale=scale, q_offset=0)
    t = [torch.from_numpy(a) for a in (q, k, v, do, bias)]
    o_t, lse_t = flash_attention_fwd(*t[:3], causal=causal, bias=t[4])
    np.testing.assert_allclose(o_t.numpy().transpose(0, 2, 1, 3).reshape(B * h, sq, d),
                               np.asarray(o_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], rtol=1e-4, atol=1e-4)

    dq_j, dk_j, dv_j, db_j = jfa._flash_bwd(
        _to_bh(q, h), _to_bh(k, h), _to_bh(v, h), o_j, lse_j, _to_bh(do, h), bias_bh,
        causal=causal, scale=scale, q_offset=0)
    dq_t, dk_t, dv_t, db_t = flash_attention_bwd(*t[:3], o_t, lse_t, t[3], causal=causal,
                                                 bias=t[4], need_dbias=True)

    def narrow(x):   # [B * h, S, D] → [B, S, hkv, D], the query group summed
        x = np.asarray(x).reshape(B, hkv, h // hkv, -1, d).sum(2)
        return x.transpose(0, 2, 1, 3)

    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j).reshape(B, h, sq, d)
                               .transpose(0, 2, 1, 3), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dk_t.numpy(), narrow(dk_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dv_t.numpy(), narrow(dv_j), rtol=1e-4, atol=1e-4)
    assert db_t.dtype == torch.float32 and tuple(db_t.shape) == (B, h, sq, skv)
    np.testing.assert_allclose(db_t.numpy().reshape(B * h, sq, skv), np.asarray(db_j),
                               rtol=1e-4, atol=1e-4)
    if causal:   # dbias above the diagonal: exactly zero on both sides
        above = np.triu(np.ones((sq, skv), bool), 1)
        assert not db_t.numpy()[..., above].any() and not np.asarray(db_j)[..., above].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_bias_autograd_matches_jax_flash_attention(name, small_blocks):
    """The public op under autograd: :class:`FlashAttentionBias` (through
    ``flash_attention``, the ``cuda`` backend, on CPU tensors) against JAX
    ``flash_attention(bias=...)``; the bias's grad comes back at its own
    broadcast shape on both sides."""
    case = CASES[name]
    causal = case[6]
    q, k, v, do, bias = _inputs(case, seed=1)

    def jloss(q, k, v, b):
        o = jfa.flash_attention(q, k, v, causal=causal, bias=b)
        return jnp.sum(o * do), o

    (_, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (q, k, v, bias)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    o_t = flash_attention(*ts[:3], causal=causal, bias=ts[3])
    (o_t * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), rtol=1e-4, atol=1e-4)
    for got, ref, what in zip(ts, g_j, ("dq", "dk", "dv", "dbias")):
        assert got.grad.shape == ref.shape, what
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4,
                                   err_msg=what)


def test_fully_masked_row_is_a_uniform_average(small_blocks):
    """A query row whose every key carries the -1e30 mask bias (evoformer's
    wholly masked residue) is not empty: m stays -1e30 and p = 1 on each
    key, so o is v's average over the keys, in both packages, and the
    backward (p = exp(s - lse) = 1 there, as in the JAX kernel) agrees too.
    S = 48 is whole 16-blocks: the JAX kernels pad nothing, so no padded
    key joins that average."""
    B, S, H, D = 2, 48, 2, 16
    rs = np.random.RandomState(3)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    bias = np.zeros((B, H, S, S), np.float32)
    bias[:, :, 5] = -1e30           # query row 5 sees only masked keys
    bias[0, :, :, 9] = -1e30        # key 9 masked for batch 0
    bias += 0.5 * rs.randn(B, H, S, S).astype(np.float32)

    def jloss(q, k, v, b):
        o = jfa.flash_attention(q, k, v, causal=False, bias=b)
        return jnp.sum(o * do), o

    (_, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (q, k, v, bias)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    o_t = FlashAttentionBias.apply(*ts, False, None, 0)
    (o_t * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o_t.detach().numpy()[:, 5], v.mean(1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(o_j)[:, 5], v.mean(1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), rtol=1e-4, atol=1e-4)
    for got, ref, what in zip(ts, g_j, ("dq", "dk", "dv", "dbias")):
        assert np.isfinite(got.grad.numpy()).all(), what
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4,
                                   err_msg=what)


@pytest.mark.parametrize("row", [0, 5, 37])
def test_masked_row_backward_and_dbias_zeros_causal(row, small_blocks):
    """Causal, the backward pieces on the same o and lse: a query row whose
    every visible key carries -1e30 (its lse rounds to -1e30, so p = 1 on
    each visible key) gets dq, dk, dv and dbias equal to JAX's
    ``_flash_bwd(bias)``, finite, and dbias is exactly zero above the
    diagonal on both sides (the JAX kernel zeroes the blocks it skips; the
    port's dQ kernel writes them). The forwards are not compared on that
    row: JAX's block mask puts its -1e30 on the diagonal block's masked
    keys too (ROADMAP queue C). fp32, rtol = atol = 1e-4 (the same
    arithmetic in another summation order)."""
    B, S, H, D = 1, 48, 2, 16
    rs = np.random.RandomState(row + 7)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    bias = (0.5 * rs.randn(B, H, S, S)).astype(np.float32)
    bias[:, :, row, : row + 1] = -1e30      # every key the row sees
    t = [torch.from_numpy(a) for a in (q, k, v, do, bias)]
    o_t, lse_t = flash_attention_fwd(*t[:3], causal=True, bias=t[4])
    assert float(lse_t.view(H, S)[0, row]) == float(np.float32(-1e30))
    dq_t, dk_t, dv_t, db_t = flash_attention_bwd(*t[:3], o_t, lse_t, t[3], causal=True,
                                                 bias=t[4], need_dbias=True)
    o_bh = jnp.asarray(o_t.numpy().transpose(0, 2, 1, 3).reshape(B * H, S, D))
    lse_bh = jnp.broadcast_to(jnp.asarray(lse_t.numpy())[..., None], (B * H, S, 128))
    dq_j, dk_j, dv_j, db_j = jfa._flash_bwd(
        _to_bh(q, H), _to_bh(k, H), _to_bh(v, H), o_bh, lse_bh, _to_bh(do, H),
        jnp.asarray(bias.reshape(B * H, S, S)), causal=True, scale=D ** -0.5, q_offset=0)

    def bsd(x):   # [B * H, S, D] -> [B, S, H, D]
        return np.asarray(x).reshape(B, H, S, D).transpose(0, 2, 1, 3)

    for got, ref, what in ((dq_t, bsd(dq_j), "dq"), (dk_t, bsd(dk_j), "dk"),
                           (dv_t, bsd(dv_j), "dv"),
                           (db_t, np.asarray(db_j).reshape(B, H, S, S), "dbias")):
        assert np.isfinite(got.numpy()).all(), what
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=what)
    above = np.triu(np.ones((S, S), bool), 1)
    assert not db_t.numpy()[..., above].any() and not np.asarray(db_j)[..., above].any()
    assert np.abs(db_t.numpy()[0, :, row, : row + 1]).sum() > 0   # p = 1 there


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_bias_matches_flash_bias(bias_dtype):
    """Op ``attention``'s ``torch`` backend adds the bias as the JAX
    ``attention_xla`` does (fp32, after the causal mask): the same output
    and grads as the flash pieces' bias mode, for an fp32 or a bf16 bias."""
    q, k, v, do, bias = _inputs(CASES["row_bias_gqa_causal"], seed=2)
    grads = []
    for fn in (lambda *t: attention_torch(*t[:3], causal=True, bias=t[3]),
               lambda *t: flash_attention(*t[:3], causal=True, bias=t[3])):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        b = torch.from_numpy(bias).to(bias_dtype).requires_grad_()
        o = fn(*ts, b)
        (o * torch.from_numpy(do)).sum().backward()
        grads.append([o.detach()] + [t.grad for t in ts] + [b.grad])
    assert grads[1][4].dtype == bias_dtype
    for got, ref in zip(*grads):
        torch.testing.assert_close(got.float(), ref.float(), rtol=1e-5, atol=1e-5)


def test_mask_and_window_with_bias_go_to_plain_attention():
    """As in the JAX ``flash_attention`` (:823): a mask, or a window with a
    bias, runs plain attention and launches no kernel."""
    q, k, v, _, bias = _inputs(CASES["alibi_causal"])
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    mask = torch.ones(1, 1, 48, 48, dtype=torch.bool).tril()
    before = (flash_fwd_cuda.launches, flash_fwd_bias_cuda.launches)
    for kw in (dict(mask=mask, causal=False), dict(bias=t[3], window=8)):
        torch.testing.assert_close(flash_attention(*t[:3], **kw),
                                   attention_torch(*t[:3], **kw), rtol=0, atol=0)
    assert (flash_fwd_cuda.launches, flash_fwd_bias_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_bias_cuda(*t)


@pytest.mark.parametrize("wrapper", ["fwd", "dq", "dkv"])
def test_bias_wrappers_refuse_a_window(wrapper):
    """The kernels' bias mode takes no window (the op runs window + bias in
    plain attention): each raw bias wrapper raises ``ValueError`` before it
    looks at the device."""
    q, k, v, _, bias = (torch.from_numpy(a) for a in _inputs(CASES["alibi_causal"]))
    lse = torch.zeros(q.shape[0] * q.shape[2], q.shape[1])
    call = {"fwd": lambda: flash_fwd_bias_cuda(q, k, v, bias, window=8),
            "dq": lambda: flash_bwd_dq_bias_cuda(q, k, v, q, lse, lse, bias, window=8),
            "dkv": lambda: flash_bwd_dkv_bias_cuda(q, k, v, q, lse, lse, bias, window=8)}
    with pytest.raises(ValueError, match="takes no window"):
        call[wrapper]()
