"""fp16 flash attention: the PyTorch port against the JAX package, on the CPU.

The port's plain pieces in fp16 (``flash_fwd_torch`` / ``flash_bwd_torch``,
the functions the fp16 instantiations of ``flash_fwd_sm90.cu`` and
``flash_bwd_sm90.cu`` are held against on the card) against the JAX
package's Pallas flash kernels in fp16, run in interpret mode as
``tests/test_torch_flash_attention.py`` runs them, on the same numpy
inputs: every mode the kernels take (causal, non-causal, sliding window,
q_offset, GQA, the additive bias with its dbias). Both sides compute the
scores and the softmax in fp32 and round P and dS to fp16 where the Pallas
kernels do (``astype(float16)``: past 65504 that is inf, no saturation),
so an overflow under a large loss scale shows as inf / nan in the same
grad elements on both sides (the overflow case below).

Tolerances: each output row's largest error within 1% of that row's RMS
(floored at 1% of the whole output's). The two sides reduce in other orders
and the JAX kernels rescale p by a running max over 16-key blocks
(``DSTPU_FLASH_BLOCK=16``) where the plain version takes the row's max, so
a p rounds to fp16 at another point (2^-11 of it); sound rows read ~1e-3.
lse (fp32) 1e-4. Also the routing: ``bwd_source``, ``tma_refusal`` and
``tma_check`` take fp16, and the bias dtypes an fp16 call takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.flash_attention import (
    BWD_SM90, SM90_DTYPES, _bias_args, _sm90, bias_dtypes, bwd_source, flash_attention_bwd,
    flash_attention_fwd, tma_check, tma_refusal)

ROW_TOL = 0.01

# (B, Sq, Skv, H, Hkv, D, causal, q_offset, window)
CASES = {
    "mha_causal": (2, 64, 64, 4, 4, 32, True, 0, None),
    "gqa_noncausal": (1, 48, 48, 4, 2, 32, False, 0, None),
    "gqa_q_offset": (1, 24, 64, 4, 1, 32, True, 40, None),
    "gqa_window": (1, 64, 64, 4, 2, 32, True, 0, 8),
    "tail_d64": (1, 40, 40, 2, 1, 64, True, 0, None),
    "d96_gqa": (1, 32, 32, 4, 2, 96, True, 0, None),
}


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "16")


# the overflow case's scales of q, k, v and dO: tiny scores make p flat
# (1 / the keys a row sees), large v and dO make dp - delta ~1e7, so dS =
# p (dp - delta) scale passes 65504 on the rows that see few keys, while
# every finite output stays far below it (dq, dk < ~1200, dv < ~32000 at
# these shapes): which elements overflow is then decided by dS alone, not
# by a sum's rounding near the threshold
OVERFLOW = (1e-3, 1e-3, 300.0, 3e3)


def _inputs(case, seed=0, muls=(1.0, 1.0, 1.0, 1.0)):
    B, sq, skv, h, hkv, d = case[:6]
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * m).astype(np.float16)
            for s, m in zip(((B, sq, h, d), (B, skv, hkv, d), (B, skv, hkv, d), (B, sq, h, d)),
                            muls)]


def _to_bh(x, h):
    """[B, S, Hx, D] numpy → the JAX kernels' [B * h, S, D] (widened to h)."""
    B, S, hx, D = x.shape
    x = np.repeat(x, h // hx, axis=2)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * h, S, D))


def _from_bh(x, B, h):
    """The JAX kernels' [B * h, S, D] → [B, S, h, D] numpy (fp32)."""
    x = np.asarray(x).astype(np.float32)
    return x.reshape(B, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _narrow(x, B, h, hkv):
    """[B * h, S, D] grads → [B, S, hkv, D], each query group summed (h =
    hkv: nothing to sum; the bias mode's widened grads are summed in fp32)."""
    x = np.asarray(x).astype(np.float32)
    d = x.shape[-1]
    return x.reshape(B, hkv, h // hkv, -1, d).sum(2).transpose(0, 2, 1, 3)


def row_err(got, ref, floor=0.01):
    """Largest |got - ref| of each last-dim row over that row's RMS (floored
    at ``floor`` times the whole output's), the worst row."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    rms = np.sqrt((ref ** 2).mean(-1))
    rms = np.maximum(rms, floor * np.sqrt((ref ** 2).mean()))
    return float((np.abs(got - ref).max(-1) / rms).max())


def _both(case, seed, bias=None, **scale):
    """The port's plain pieces and the JAX kernels on the same fp16 inputs:
    ``((o, lse, dq, dk, dv, dbias), same from JAX)`` as fp32 numpy, o and
    dq [B, S, H, D], dk and dv narrow, dbias [B * H, Sq, Skv] or None."""
    B, sq, skv, h, hkv, d = case[:6]
    kw = dict(causal=case[6], q_offset=case[7], window=case[8])
    q, k, v, do = _inputs(case, seed, **scale)
    if bias is None and hkv != h:
        # JAX's native GQA path (``_flash_gqa``): q [B * hkv, g, Sq, D], K / V
        # narrow, the dK/dV kernel summing each group in fp32 as the port's
        # kernels do, then one rounding to fp16
        g = h // hkv

        def grouped(x):
            return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * hkv, g, sq, d))

        def kv(x):
            return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * hkv, skv, d))

        o_j, lse_j = jfa._flash_fwd(grouped(q), kv(k), kv(v), scale=d ** -0.5, g=g, **kw)
        dq_j, dk_j, dv_j, _ = jfa._flash_bwd(grouped(q), kv(k), kv(v), o_j, lse_j, grouped(do),
                                             scale=d ** -0.5, g=g, **kw)
        assert dk_j.shape == (B * hkv, skv, d)
        o_j, dq_j = (np.asarray(x).reshape(B * h, sq, d) for x in (o_j, dq_j))
        lse_j = np.asarray(lse_j).reshape(B * h, sq, -1)
        dk_j, dv_j = (np.asarray(x).reshape(B * hkv, 1, skv, d) for x in (dk_j, dv_j))
        db_j = None
        h_dkv = hkv
    else:
        jb = None if bias is None else jnp.asarray(
            np.broadcast_to(bias, (B, h, sq, skv)).reshape(B * h, sq, skv))
        o_j, lse_j = jfa._flash_fwd(_to_bh(q, h), _to_bh(k, h), _to_bh(v, h), jb,
                                    scale=d ** -0.5, **kw)
        dq_j, dk_j, dv_j, db_j = jfa._flash_bwd(
            _to_bh(q, h), _to_bh(k, h), _to_bh(v, h), o_j, lse_j, _to_bh(do, h), jb,
            scale=d ** -0.5, **kw)
        h_dkv = h
    assert o_j.dtype == jnp.float16 and dq_j.dtype == jnp.float16
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tb = None if bias is None else torch.from_numpy(bias)
    o_t, lse_t = flash_attention_fwd(*t[:3], bias=tb, **kw)
    out = flash_attention_bwd(*t[:3], o_t, lse_t, t[3], bias=tb, need_dbias=bias is not None,
                              **kw)
    assert o_t.dtype == torch.float16 and all(g.dtype == torch.float16 for g in out[:3])
    port = (o_t.float().numpy(), lse_t.numpy(), *(g.float().numpy() for g in out[:3]),
            None if bias is None else out[3].numpy().reshape(B * h, sq, skv))
    jax_ = (_from_bh(o_j, B, h), np.asarray(lse_j)[..., 0], _from_bh(dq_j, B, h),
            _narrow(dk_j, B, h_dkv, hkv), _narrow(dv_j, B, h_dkv, hkv),
            None if bias is None else np.asarray(db_j).astype(np.float32))
    return port, jax_


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp16_pieces_match_jax_kernels(name, small_blocks):
    """o, lse, dq, dk, dv in fp16 against the Pallas kernels in fp16, in
    every mask mode and at GQA (dK/dV narrow on the port's side)."""
    port, jax_ = _both(CASES[name], seed=1)
    np.testing.assert_allclose(port[1], jax_[1], rtol=1e-4, atol=1e-4)
    for what, got, ref in zip(("o", "dq", "dk", "dv"), port[:1] + port[2:5],
                              jax_[:1] + jax_[2:5]):
        assert got.shape == ref.shape, what
        assert np.isfinite(got).all(), what
        assert row_err(got, ref) <= ROW_TOL, (what, row_err(got, ref))


BIAS_CASES = {
    "alibi_causal": ((2, 48, 48, 4, 2, 32, True, 0, None), "alibi"),
    "full_noncausal": ((1, 40, 56, 4, 4, 64, False, 0, None), "full"),
}


@pytest.mark.parametrize("name", sorted(BIAS_CASES))
def test_fp16_bias_pieces_match_jax_kernels(name, small_blocks):
    """The bias mode in fp16 (an fp32 bias, as BLOOM's ALiBi and the MSA
    pair bias are summed): o, grads and dbias against the Pallas kernels."""
    case, form = BIAS_CASES[name]
    B, sq, skv, h = case[:4]
    rs = np.random.RandomState(7)
    if form == "alibi":
        bias = (-np.abs(rs.rand(h, 1, 1)) * np.arange(skv)[None, None, :]).astype(np.float32)
    else:
        bias = rs.randn(B, h, sq, skv).astype(np.float32)
    port, jax_ = _both(case, seed=2, bias=bias)
    np.testing.assert_allclose(port[1], jax_[1], rtol=1e-4, atol=1e-4)
    for what, got, ref in zip(("o", "dq", "dk", "dv", "dbias"), port[:1] + port[2:],
                              jax_[:1] + jax_[2:]):
        assert row_err(got, ref) <= ROW_TOL, (what, row_err(got, ref))


def test_fp16_overflow_is_inf_in_the_same_elements_as_jax(small_blocks):
    """dS past 65504 on the rows that see few keys (``OVERFLOW``'s scales):
    JAX's ``astype(float16)`` makes it inf, and so does the port's rounding;
    dq and dk then hold inf / nan in exactly the same elements on both sides
    (the engine's overflow check sees them), their finite rows agree, and
    dv = p^T dO stays finite and agrees."""
    case = (1, 64, 64, 4, 2, 64, True, 0, None)
    port, jax_ = _both(case, seed=3, muls=OVERFLOW)
    for what, got, ref in zip(("dq", "dk"), port[2:4], jax_[2:4]):
        bad_got, bad_ref = ~np.isfinite(got), ~np.isfinite(ref)
        assert bad_ref.any() and not bad_ref.all(), what
        np.testing.assert_array_equal(bad_got, bad_ref, err_msg=what)
        rows = ~bad_ref.any(-1)
        assert rows.any() and row_err(got[rows], ref[rows]) <= ROW_TOL, what
    assert np.isfinite(port[4]).all() and np.isfinite(jax_[4]).all()
    assert row_err(port[4], jax_[4]) <= ROW_TOL


def test_without_the_fp16_rounding_the_overflow_would_not_show(small_blocks):
    """The overflow case holds what it claims: dS computed in fp32 and not
    rounded (a ``satfinite`` or fp32 path) keeps every dq finite, so the
    check above fails a kernel that clips instead of overflowing."""
    case = (1, 64, 64, 4, 2, 64, True, 0, None)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=3, muls=OVERFLOW))
    o, lse = flash_attention_fwd(q, k, v)
    dq16, _, _ = flash_attention_bwd(q, k, v, o, lse, do)
    dq32, _, _ = flash_attention_bwd(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float())
    assert not torch.isfinite(dq16.float()).all()
    assert torch.isfinite(dq32).all()


# --------------------------------------------------------------------------- #
# routing: what the 16-bit kernels take
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("has_bias", [False, True])
def test_fp16_routes_to_the_hopper_kernels(d, has_bias):
    """fp16 runs ``flash_bwd_sm90.cu`` (and the forward's sm90 source) at
    every head dim the kernels take, with or without a bias; its dense
    inputs pass the TMA check."""
    assert torch.float16 in SM90_DTYPES
    assert bwd_source(torch.float16, d) == BWD_SM90
    assert (_build.CSRC / BWD_SM90).is_file()
    q, k, v, do = (torch.zeros(2, 16, n, d, dtype=torch.float16) for n in (4, 2, 2, 4))
    assert tma_refusal(q) is None
    tma_check("flash_fwd_cuda", q=q, k=k, v=v)
    bias = torch.zeros(4, 1, 16) if has_bias else None
    assert _sm90("flash_bwd_dq_cuda", q, k, v, do, bias)


@pytest.mark.parametrize("d", [16, 48, 256])
def test_fp16_at_a_head_dim_outside_the_kernels_raises(d):
    with pytest.raises(ValueError, match="head dim"):
        bwd_source(torch.float16, d)
    assert "D in" in tma_refusal(torch.zeros(1, 8, 2, d, dtype=torch.float16))


def test_fp16_misaligned_and_sliced_inputs_are_named():
    buf = torch.zeros(1 + 2 * 16 * 4 * 64, dtype=torch.float16)
    assert "16 bytes" in tma_refusal(buf[1:].view(2, 16, 4, 64))
    fused = torch.zeros(2, 16, 3, 4, 64, dtype=torch.float16)[:, :, 0]
    assert "dense" in tma_refusal(fused)
    q = torch.zeros(2, 16, 4, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="TMA cannot read dO"):
        tma_check("flash_bwd_dq_cuda", q=q, dO=fused)


@pytest.mark.parametrize("q_dtype,bias_dtype,ok", [
    (torch.float16, torch.float16, True), (torch.float16, torch.float32, True),
    (torch.float16, torch.bfloat16, False), (torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.float16, False), (torch.float32, torch.bfloat16, True),
    (torch.float32, torch.float16, False)])
def test_the_bias_dtypes_each_kernel_takes(q_dtype, bias_dtype, ok):
    """A 16-bit bias is read as the kernel's own 16-bit type (fp16 with fp16
    inputs, bf16 with bf16 and fp32 ones); an fp32 bias goes with any. Its
    is-fp32 flag is the bias code the kernels take."""
    bias = torch.zeros(4, 1, 16, dtype=bias_dtype)
    assert (bias_dtype in bias_dtypes(q_dtype)) == ok
    if not ok:
        with pytest.raises(ValueError, match="bias"):
            _bias_args(bias, "flash_fwd_bias_cuda", 2, 4, 16, 16, bias.device, q_dtype)
        return
    ptr, sb, sh, sq, sk, f32 = _bias_args(bias, "flash_fwd_bias_cuda", 2, 4, 16, 16,
                                          bias.device, q_dtype)
    assert ptr == bias.data_ptr() and (sb, sh, sq, sk) == (0, 16, 0, 1)
    assert f32 == int(bias_dtype == torch.float32)


def test_the_fp16_entry_points_are_bound():
    """The sm90 backward entry points take the element type (0 bf16, 2
    fp16) after the scale, as the forward's entry point always did; the
    paged entry point takes q's type after its split count."""
    vp, i, f = _build._VP, _build._I, _build._F
    assert _build.SIGNATURES["dstt_flash_bwd_dq_sm90"][-3:] == [f, i, vp]
    assert _build.SIGNATURES["dstt_flash_bwd_dkv_sm90"][-3:] == [f, i, vp]
    assert _build.SIGNATURES["dstt_paged_attention"][-4:] == [i, i, f, vp]
    assert (_build.CSRC / "hopper_types.cuh").is_file()
