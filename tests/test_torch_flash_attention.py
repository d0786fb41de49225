"""Flash attention: the PyTorch port against the JAX package, on the CPU.

The port's plain pieces (op ``attention``'s ``torch`` backend, and
``flash_fwd_torch`` / ``flash_bwd_torch``, which the CUDA kernels are held
against on the card) are compared with the JAX package's Pallas flash
kernels run in interpret mode, as ``tests/test_pallas_kernels.py`` runs them,
on the same numpy inputs. ``DSTPU_FLASH_BLOCK=16`` makes the JAX kernels
walk several q and kv blocks (and a ragged tail) at these small shapes.

Tolerances: the public op as in ``tests/test_pallas_kernels.py`` (forward
2e-3, grads 5e-3); the raw pieces, fp32 on both sides, 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import get_op
from deepspeed_tpu_torch.ops.attention import attention, attention_torch
from deepspeed_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_bwd, flash_attention_fwd, flash_bwd_torch,
    flash_fwd_cuda, flash_fwd_torch)

# (B, Sq, Skv, H, Hkv, D, causal, q_offset, window)
CASES = {
    "mha_causal": (2, 64, 64, 4, 4, 32, True, 0, None),
    "gqa_noncausal": (1, 48, 48, 4, 2, 32, False, 0, None),
    "gqa_q_offset": (1, 24, 64, 4, 1, 32, True, 40, None),
    "gqa_window": (1, 64, 64, 4, 2, 32, True, 0, 8),
    "tail": (1, 40, 40, 2, 2, 32, True, 0, None),
    "tail_127_d64": (1, 127, 127, 2, 1, 64, True, 0, None),    # one row short of two 64-row tiles
    "tail_129_d32": (1, 129, 129, 2, 2, 32, False, 0, None),   # one row past a 128-row item
}


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "16")


def _inputs(case, seed=0):
    B, sq, skv, h, hkv, d = case[:6]
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32)
            for s in ((B, sq, h, d), (B, skv, hkv, d), (B, skv, hkv, d), (B, sq, h, d))]


def _kw(case):
    return dict(causal=case[6], q_offset=case[7], window=case[8])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_attention_and_grads_match_jax_flash(name, small_blocks):
    case = CASES[name]
    q, k, v, do = _inputs(case)
    kw = _kw(case)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, **kw)
        return jnp.sum(o * do), o

    (_, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o_t = attention(qt, kt, vt, **kw)
    (o_t * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), rtol=2e-3, atol=2e-3)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), g_j):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-3, atol=5e-3)


def _to_bh(x, h):
    """[B, S, Hx, D] numpy → the JAX kernels' [B * h, S, D] (widened to h)."""
    B, S, hx, D = x.shape
    x = np.repeat(x, h // hx, axis=2)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * h, S, D))


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_pieces_match_jax_kernels(name, small_blocks):
    """``(o, lse)`` against ``_flash_fwd``; ``(dq, dk, dv)`` against
    ``_flash_bwd`` from the same o and lse — the port's dK/dV come out
    narrow, the JAX kernels' widened, so the group is summed here."""
    case = CASES[name]
    B, sq, skv, h, hkv, d = case[:6]
    q, k, v, do = _inputs(case, seed=1)
    kw = _kw(case)
    scale = d ** -0.5
    o_j, lse_j = jfa._flash_fwd(_to_bh(q, h), _to_bh(k, h), _to_bh(v, h),
                                scale=scale, **kw)
    o_t, lse_t = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    o_t_bh = o_t.numpy().transpose(0, 2, 1, 3).reshape(B * h, sq, d)
    np.testing.assert_allclose(o_t_bh, np.asarray(o_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], rtol=1e-4, atol=1e-4)

    dq_j, dk_j, dv_j, _ = jfa._flash_bwd(
        _to_bh(q, h), _to_bh(k, h), _to_bh(v, h), o_j, lse_j, _to_bh(do, h),
        scale=scale, **kw)
    dq_t, dk_t, dv_t = flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)), o_t, lse_t, torch.from_numpy(do), **kw)

    def narrow(x):   # [B * h, S, D] → [B, S, hkv, D], the query group summed
        x = np.asarray(x).reshape(B, hkv, h // hkv, -1, d).sum(2)
        return x.transpose(0, 2, 1, 3)

    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j).reshape(B, h, sq, d)
                               .transpose(0, 2, 1, 3), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dk_t.numpy(), narrow(dk_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dv_t.numpy(), narrow(dv_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["gqa_q_offset", "gqa_window"])
def test_autograd_function_matches_plain_autograd(name):
    """On CPU tensors :class:`FlashAttention` runs the plain pieces; its
    grads are plain attention's under autograd (fp32, 1e-5)."""
    case = CASES[name]
    q, k, v, do = _inputs(case, seed=2)
    kw = _kw(case)
    grads = []
    for fn in (lambda *t: FlashAttention.apply(*t, kw["causal"], None, kw["q_offset"],
                                               kw["window"]),
               lambda *t: attention_torch(*t, **kw)):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = fn(*ts)
        (o * torch.from_numpy(do)).sum().backward()
        grads.append([o.detach()] + [t.grad for t in ts])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_row_that_sees_no_key():
    """A query past the window's reach of every key (q_offset 20, kv 8,
    window 4) gets o = 0 and lse = -1e30 + log 1, as the TPU kernel's
    ``_finish`` writes for rows whose every block is skipped."""
    q, k, v, do = _inputs((1, 4, 8, 2, 1, 32), seed=3)
    o, lse = flash_fwd_torch(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, q_offset=20, window=4)
    assert torch.all(o == 0) and torch.all(lse == -1e30)
    dq, dk, dv = flash_bwd_torch(*(torch.from_numpy(a) for a in (q, k, v)), o, lse,
                                 torch.from_numpy(do), causal=True, q_offset=20, window=4)
    assert not dq.any() and not dk.any() and not dv.any()


def test_op_dispatch_and_cpu_refusal():
    x = torch.zeros(1, 4, 2, 64)
    assert get_op("attention", x.device) is attention_torch
    before = flash_fwd_cuda.launches
    attention(x, x, x, causal=True)
    assert flash_fwd_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="window"):
        flash_attention_fwd(x, x, x, causal=False, window=2)


# chip_smoke.py's FLASH_TOL and FLASH_FLOOR: each flash output (bf16, kernels)
# against plain attention in fp32, as a share of the output row's RMS
# floored at FLOOR times the whole output's
CHIP_LIMIT = {"o": 0.05, "dq": 0.15, "dk": 0.05, "dv": 0.05}
CHIP_FLOOR = {"o": 0.01, "dq": 1.0, "dk": 0.01, "dv": 0.01}


def _row_err(got, ref, floor):
    diff = (got.float() - ref.float()).abs()
    rms = ref.float().pow(2).mean(-1).sqrt()
    rms = rms.clamp_min(floor * float(ref.float().pow(2).mean().sqrt()))
    return float((diff.amax(-1) / rms).max())


def test_flash_row_limits_separate_sound_from_faulty():
    """The simulation behind ``chip_smoke.py``'s flash limits. The kernels'
    plain pieces in bf16 stand in for a sound kernel (they round p, ds and
    the outputs where the kernels do) against plain attention in fp32 under
    autograd, at Llama-3-8B head dim (S 512, 8 heads on 2 kv heads, causal).
    Over S = 1024, three seeds and the smoke's mask kinds the sound outputs
    read <= 0.021 (o, dK, dV) and <= 0.063 (dQ, rows floored at the output's
    RMS: delta = rowsum(dO * O) from the bf16 O leaves a query that sees few
    keys with up to 0.34 of its own small RMS); one swapped 64-row K tile
    reads >= 2.6 on o and >= 4.2 on dQ."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 512, h, 128, generator=g).bfloat16() for h in (8, 2, 2, 8))

    def kernel_stand_in(k_):
        o, lse = flash_fwd_torch(q, k_, v)
        return [o, *flash_bwd_torch(q, k_, v, o, lse, do)]

    ts = [t.float().requires_grad_() for t in (q, k, v)]
    o = attention_torch(*ts, causal=True)
    (o * do.float()).sum().backward()
    plain = dict(zip(("o", "dq", "dk", "dv"), [o.detach()] + [t.grad for t in ts]))
    for name, got in zip(("o", "dq", "dk", "dv"), kernel_stand_in(k)):
        assert _row_err(got, plain[name], CHIP_FLOOR[name]) < 0.7 * CHIP_LIMIT[name], name
    bad = k.clone()
    bad[:, 128:192], bad[:, 256:320] = k[:, 256:320], k[:, 128:192]
    faulty = dict(zip(("o", "dq"), kernel_stand_in(bad)[:2]))
    for name in ("o", "dq"):
        assert _row_err(faulty[name], plain[name], CHIP_FLOOR[name]) > 10 * CHIP_LIMIT[name]
