"""fp16 paged attention: the PyTorch port against the JAX package, on the CPU.

The port's plain paged decode and fused verify (``paged_decode_attention_torch``
and ``paged_spec_verify_attention_torch``, the functions the fp16
instantiations of ``paged_sm90.cu`` are held against on the card) in fp16
against the JAX package's Pallas kernels (``_decode_kernel``,
``_spec_verify_kernel``) in fp16, run in interpret mode as the JAX package's
own tests run them on the CPU, on the same numpy inputs: fp16 q over fp16
pools, and fp16 q over int8 code pools at one scale group a vector (ng 1)
and at two (ng 2). The Pallas kernels dequantize a tile as ``(code *
scale).astype(q.dtype)`` and round P to the pools' dtype before P.V; at
ng > 1 the port's plain versions dequantize into fp16 the same way, and the
kernel (``paged_sm90.cu``) rounds code x scale to fp16 there too.

Tolerances: each output row's largest error within 1% of that row's RMS.
Sound rows read ~1e-3: the two sides sum in other orders, and at ng 1 the
plain versions keep code x scale in fp32 (the scale folded into the score,
as the JAX ``_xla`` reference does) where the Pallas kernel rounds it to
fp16, 2^-11 of each K/V element. Also the routing: ``paged_refusal`` takes
fp16 q with fp16 or int8 pools and refuses fp32 pools, mixed 16-bit types
and fp32 q.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_decode_attention, paged_spec_verify_attention)
from deepspeed_tpu_torch.ops.paged_attention import (
    KERNEL_DTYPES, paged_decode_attention_torch, paged_refusal,
    paged_spec_verify_attention_torch)

ROW_TOL = 0.01


def row_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    rms = np.sqrt((ref ** 2).mean(-1))
    return float((np.abs(got - ref).max(-1) / rms).max())


def inputs(ng, t=1, seed=1, ctx=(0, 13, 37, 70)):
    """q [B, t, nh, hd] fp16; pools fp16 (ng 0) or int8 codes with fp32
    scales in [0, 0.02) (scores of order 1); a ctx-0 slot on the trash
    block."""
    rng = np.random.default_rng(seed)
    nb, nkv, bs, hd, nh, mb = 12, 2, 16, 64, 8, 6
    B = len(ctx)
    q = rng.standard_normal((B, t, nh, hd)).astype(np.float16)
    tables = rng.integers(1, nb, (B, mb)).astype(np.int32)
    tables[np.asarray(ctx) == 0] = 0
    if ng == 0:
        kp, vp = (rng.standard_normal((nb, nkv, bs, hd)).astype(np.float16) for _ in range(2))
        sc = {}
    else:
        kp, vp = (rng.integers(-127, 128, (nb, nkv, bs, hd)).astype(np.int8) for _ in range(2))
        sc = {name: (rng.random((nb, nkv, bs, ng)) * 0.02).astype(np.float32)
              for name in ("k_scale", "v_scale")}
    return q, kp, vp, tables, np.asarray(ctx, np.int32), sc


def _run(fn_t, fn_j, q, kp, vp, tables, ctx, sc, window):
    got = fn_t(*map(torch.from_numpy, (q, kp, vp, tables, ctx)), window=window,
               **{k: torch.from_numpy(v) for k, v in sc.items()})
    ref = fn_j(*map(jnp.asarray, (q, kp, vp, tables, ctx)), window=window,
               **{k: jnp.asarray(v) for k, v in sc.items()})
    assert got.dtype == torch.float16 and ref.dtype == jnp.float16
    return got.float().numpy(), np.asarray(ref).astype(np.float32)


@pytest.mark.parametrize("ng", [0, 1, 2])
@pytest.mark.parametrize("window", [None, 20])
def test_fp16_paged_decode_matches_jax(ng, window):
    q, kp, vp, tables, ctx, sc = inputs(ng)
    got, ref = _run(paged_decode_attention_torch, paged_decode_attention, q[:, 0], kp, vp,
                    tables, ctx, sc, window)
    assert got.shape == ref.shape == q[:, 0].shape
    assert np.isfinite(got).all()
    assert row_err(got, ref) <= ROW_TOL, row_err(got, ref)


@pytest.mark.parametrize("ng", [0, 1, 2])
@pytest.mark.parametrize("t", [2, 5])
def test_fp16_paged_verify_matches_jax(ng, t):
    q, kp, vp, tables, ctx, sc = inputs(ng, t=t, seed=2, ctx=(0, 9, 40, 77))
    got, ref = _run(paged_spec_verify_attention_torch, paged_spec_verify_attention, q, kp, vp,
                    tables, ctx, sc, None)
    assert got.shape == ref.shape == q.shape
    assert row_err(got, ref) <= ROW_TOL, row_err(got, ref)


def test_ng2_rounds_code_times_scale_to_fp16():
    """At ng > 1 JAX dequantizes a tile as ``(code * scale).astype(fp16)``:
    the plain version does too. Held in fp32 instead, the values differ from
    JAX's by the fp16 rounding, which the check above must see as larger
    than the two sides' own difference."""
    q, kp, vp, tables, ctx, sc = inputs(2, seed=4)
    got, ref = _run(paged_decode_attention_torch, paged_decode_attention, q[:, 0], kp, vp,
                    tables, ctx, sc, None)
    t32 = paged_decode_attention_torch(
        torch.from_numpy(q[:, 0]).float(), *map(torch.from_numpy, (kp, vp, tables, ctx)),
        **{k: torch.from_numpy(v) for k, v in sc.items()}).numpy()
    assert np.abs(got - ref).max() < np.abs(t32 - ref).max()


# --------------------------------------------------------------------------- #
# routing: what paged_sm90.cu takes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("nh,nkv,hd,ng", [
    (71, 1, 64, 0), (71, 1, 64, 1), (32, 8, 128, 0), (32, 8, 128, 1), (32, 8, 128, 2),
    (32, 32, 64, 4)])
def test_fp16_refusal_takes_the_kernels_shapes(nh, nkv, hd, ng):
    pool = torch.int8 if ng else torch.float16
    assert KERNEL_DTYPES[torch.float16] == 2
    assert paged_refusal(q_dtype=torch.float16, pool_dtype=pool, hd=hd, nh=nh, nkv=nkv,
                         ng=ng) is None


@pytest.mark.parametrize("q_dtype,pool_dtype,ng,why", [
    (torch.float16, torch.float32, 0, "q-dtype pools"),     # fp32 pools: queue B.2
    (torch.float16, torch.bfloat16, 0, "q-dtype pools"),
    (torch.bfloat16, torch.float16, 0, "q-dtype pools"),
    (torch.float16, torch.float16, 2, "int8 pools"),
    (torch.float32, torch.float32, 0, "bf16 or fp16 q"),
    (torch.float64, torch.float64, 0, "bf16 or fp16 q")])
def test_fp16_refusal_names_what_the_kernel_does_not_take(q_dtype, pool_dtype, ng, why):
    got = paged_refusal(q_dtype=q_dtype, pool_dtype=pool_dtype, hd=128, nh=32, nkv=8, ng=ng)
    assert got is not None and why in got, got
