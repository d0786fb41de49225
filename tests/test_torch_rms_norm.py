"""RMSNorm: the PyTorch port against the JAX package.

The port's plain ``rms_norm_torch`` is held against JAX ``rms_norm_xla`` and
against the Pallas kernel ``rms_norm_pallas`` run in interpret mode (as
``tests/test_pallas_kernels.py`` runs it on the CPU), on the same inputs made
with numpy. The CUDA kernel is held against the plain version on a GPU by
``tests/test_torch_cuda_kernels.py``.

Tolerances: fp32 1e-5 (same arithmetic, only the order of the row sum
differs); bf16 1e-2 absolute and relative, one bf16 rounding step (2^-8
relative) of outputs of order 1, since both sides round the same fp32 value
and a different summation order can move it across a rounding boundary;
fp16 1e-3 likewise (one fp16 rounding step, 2^-11 relative, of outputs up
to ~4).

A plain-torch rendering of ``ops/csrc/rms_norm.cu``'s planted faults (lane
31's partial left out of the sum; the weight left off a row's first vector)
at ``chip_smoke.py``'s RMSNorm shapes reads above its row limit, so the
smoke's check can fail them; the sound rendering (the sum in the kernels'
lane order) reads below. At fp16 the sound rendering reads below the
smoke's fp16 limit and an RMSNorm that rounds through bf16 above it.
The backward (``rms_norm_bwd``, and the autograd function over it) is held
against ``jax.grad`` of ``rms_norm_pallas`` at 1e-4, as
``tests/test_pallas_kernels.py`` holds the Pallas VJP against XLA's.
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.norms import rms_norm_xla
from deepspeed_tpu.ops.pallas.norms import rms_norm_pallas
from deepspeed_tpu_torch.ops import get_op
from deepspeed_tpu_torch.ops.norms import (
    RMSNormFunction, rms_norm, rms_norm_bwd, rms_norm_cuda, rms_norm_torch)

D = 256
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-3}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _inputs(rows, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, D).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rs.randn(D)).astype(np.float32)
    # round to the working dtype once, so both packages see the same values
    x_t = torch.from_numpy(x).to(TORCH[dtype])
    w_t = torch.from_numpy(w).to(TORCH[dtype])
    x_j = jnp.asarray(x_t.float().numpy()).astype(JNP[dtype])
    w_j = jnp.asarray(w_t.float().numpy()).astype(JNP[dtype])
    return x_t, w_t, x_j, w_j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_rms_norm_matches_jax(rows, dtype):
    x_t, w_t, x_j, w_j = _inputs(rows, dtype)
    got = rms_norm_torch(x_t, w_t, 1e-5)
    assert got.dtype == TORCH[dtype] and got.shape == x_t.shape
    got = got.float().numpy()
    tol = TOL[dtype]
    for ref in (rms_norm_xla(x_j, w_j, 1e-5), rms_norm_pallas(x_j, w_j, 1e-5)):
        np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_rms_norm_leading_dims_and_dispatch():
    """The registry hands CPU tensors to the plain version, [b, t, d] inputs
    normalise over the last axis, and no kernel is launched."""
    x_t, w_t, x_j, w_j = _inputs(12, "float32", seed=3)
    before = rms_norm_cuda.launches
    assert get_op("rms_norm", x_t.device) is rms_norm_torch
    got = rms_norm(x_t.view(3, 4, D), w_t, 1e-6)
    ref = rms_norm_xla(x_j.reshape(3, 4, D), w_j, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert rms_norm_cuda.launches == before


def test_rms_norm_cuda_wrapper_refuses_cpu_tensors():
    x_t, w_t, _, _ = _inputs(2, "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_cuda(x_t, w_t)


@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 256)])
def test_rms_norm_backward_matches_jax_vjp(shape):
    rs = np.random.RandomState(11)
    x = rs.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: rms_norm_pallas(x, w, 1e-5), jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    dx, dw = rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy), 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=1e-4, atol=1e-4)
    # the autograd function (plain forward on CPU tensors) carries the same grads
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    RMSNormFunction.apply(xt, wt, 1e-5).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), rtol=1e-4, atol=1e-4)


def test_rms_norm_backward_dtypes():
    """dx comes back in x's dtype, dw in the weight's, as ``_rms_vjp_bwd``
    casts them."""
    x = torch.randn(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    dx, dw = rms_norm_bwd(x, w, torch.randn(4, 64, dtype=torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    assert dx.shape == x.shape and dw.shape == w.shape


# --------------------------------------------------------------------------- #
# rms_norm.cu's planted faults and the smoke's limits
# --------------------------------------------------------------------------- #
def _kernel_rendering(x, w, eps, fault=0):
    """The kernels' arithmetic in plain torch: each lane's partial sum of
    squares (the elements of 16-byte vectors i = lane mod 32; the scalar
    kernel's elements likewise), lane 31's left out under fault 1; y from
    the same values, the first vector unweighted under fault 2."""
    n, d = x.shape
    vec = 16 // x.element_size()
    xf, wf = x.float(), w.float()
    unit = torch.arange(d) // vec if d % vec == 0 else torch.arange(d)
    lane = unit % 32
    sq = xf * xf
    if fault == 1:
        sq = sq * (lane != 31)
    ss = torch.stack([sq[:, lane == ln].sum(-1) for ln in range(32)], -1).sum(-1, keepdim=True)
    r = torch.rsqrt(ss / d + eps)
    wv = wf.clone()
    if fault == 2:
        wv[:vec] = 1.0
    return ((xf * r) * wv).to(x.dtype)


def _row_err(got, ref):
    """``chip_smoke.py``'s ``row_err``: max over rows of max |got - ref| /
    RMS(ref row)."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return float((diff / ref.float().pow(2).mean(-1).sqrt()).max())


SMOKE_RMS_TOL = 0.05   # chip_smoke.py RMS_TOL
SMOKE_FP16_TOL = 0.005  # chip_smoke.py FP16_TOL


def _smoke_inputs(rows, dtype):
    g = torch.Generator().manual_seed(rows)
    x = (3 * torch.randn(rows, 4096, generator=g)).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g)).to(dtype)
    return x, w


@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rms_norm_planted_faults_exceed_the_smoke_limit(rows, dtype):
    """At d 4096 with the smoke's inputs (x = 3 N(0, 1), w = 1 + 0.1 N(0, 1)):
    the sound rendering reads below RMS_TOL and each fault above it."""
    x, w = _smoke_inputs(rows, dtype)
    ref = rms_norm_torch(x, w, 1e-5)
    assert _row_err(_kernel_rendering(x, w, 1e-5), ref) < SMOKE_RMS_TOL / 4
    for fault in (1, 2):
        assert _row_err(_kernel_rendering(x, w, 1e-5, fault), ref) > SMOKE_RMS_TOL


@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("through", ["inputs", "output"])
def test_rms_norm_fp16_limit_fails_bf16_rounding(rows, through):
    """At fp16 with the smoke's inputs the sound rendering reads below the
    smoke's FP16_TOL by more than twice, and an RMSNorm that rounds its
    inputs or its output through bf16 above it by more than twice."""
    x, w = _smoke_inputs(rows, torch.float16)
    ref = rms_norm_torch(x, w, 1e-5)
    assert _row_err(_kernel_rendering(x, w, 1e-5), ref) < SMOKE_FP16_TOL / 2
    if through == "inputs":
        bad = rms_norm_torch(x.bfloat16(), w.bfloat16(), 1e-5).half()
    else:
        bad = rms_norm_torch(x, w, 1e-5).bfloat16().half()
    assert _row_err(bad, ref) > 2 * SMOKE_FP16_TOL
