"""LayerNorm: the PyTorch port against the JAX package.

The port's plain ``layer_norm_torch`` is held against JAX ``layer_norm_xla``
and against the Pallas kernel ``layer_norm_pallas`` run in interpret mode (as
``tests/test_pallas_kernels.py`` runs it on the CPU), on the same inputs made
with numpy. The CUDA kernel is held against the plain version on a GPU by
``tests/test_torch_cuda_kernels.py``.

Tolerances: fp32 1e-5 (same arithmetic, only the order of the row sums
differs); bf16 1e-2 absolute and relative, one bf16 rounding step (2^-8
relative) of outputs of order 1, since both sides round the same fp32 value
and a different summation order can move it across a rounding boundary.
The backward (``layer_norm_bwd``, and the autograd function over it) is held
against ``jax.vjp`` of ``layer_norm_pallas`` at 1e-4 (dx, dw, db), as
``tests/test_pallas_kernels.py`` holds the Pallas VJP against XLA's.
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.norms import layer_norm_xla
from deepspeed_tpu.ops.pallas.norms import layer_norm_pallas
from deepspeed_tpu_torch.ops import get_op
from deepspeed_tpu_torch.ops.norms import (
    LayerNormFunction, layer_norm, layer_norm_bwd, layer_norm_cuda, layer_norm_torch)

D = 256
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rows, dtype, seed=0, mean=0.0):
    rs = np.random.RandomState(seed)
    arrays = (rs.randn(rows, D).astype(np.float32) * 3.0 + mean,
              (1.0 + 0.1 * rs.randn(D)).astype(np.float32),
              (0.2 * rs.randn(D)).astype(np.float32))
    # round to the working dtype once, so both packages see the same values
    ts = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(JNP[dtype]) for t in ts]
    return ts, js


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_layer_norm_matches_jax(rows, dtype):
    (x_t, w_t, b_t), (x_j, w_j, b_j) = _inputs(rows, dtype)
    got = layer_norm_torch(x_t, w_t, b_t, 1e-5)
    assert got.dtype == TORCH[dtype] and got.shape == x_t.shape
    got = got.float().numpy()
    tol = TOL[dtype]
    for ref in (layer_norm_xla(x_j, w_j, b_j, 1e-5), layer_norm_pallas(x_j, w_j, b_j, 1e-5)):
        np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_without_bias_matches_jax(dtype):
    (x_t, w_t, _), (x_j, w_j, _) = _inputs(7, dtype, seed=2)
    got = layer_norm_torch(x_t, w_t, None, 1e-5).float().numpy()
    tol = TOL[dtype]
    for ref in (layer_norm_xla(x_j, w_j, None, 1e-5), layer_norm_pallas(x_j, w_j, None, 1e-5)):
        np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_layer_norm_large_mean_uses_centred_variance():
    """Rows of mean 100 and spread 3: the centred variance keeps fp32's
    digits where E[x^2] - mean^2 would cancel four of them."""
    (x_t, w_t, b_t), (x_j, w_j, b_j) = _inputs(7, "float32", seed=5, mean=100.0)
    got = layer_norm_torch(x_t, w_t, b_t, 1e-5).numpy()
    ref = layer_norm_pallas(x_j, w_j, b_j, 1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_layer_norm_leading_dims_and_dispatch():
    """The registry hands CPU tensors to the plain version, [b, t, d] inputs
    normalise over the last axis, and no kernel is launched."""
    (x_t, w_t, b_t), (x_j, w_j, b_j) = _inputs(12, "float32", seed=3)
    before = layer_norm_cuda.launches
    assert get_op("layer_norm", x_t.device) is layer_norm_torch
    got = layer_norm(x_t.view(3, 4, D), w_t, b_t, 1e-6)
    ref = layer_norm_xla(x_j.reshape(3, 4, D), w_j, b_j, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert layer_norm_cuda.launches == before


def test_layer_norm_cuda_wrapper_refuses_cpu_tensors():
    (x_t, w_t, b_t), _ = _inputs(2, "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x_t, w_t, b_t)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x_t, w_t, None)


@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 256)])
def test_layer_norm_backward_matches_jax_vjp(shape):
    rs = np.random.RandomState(11)
    x = rs.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    b = (0.2 * rs.randn(shape[-1])).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: layer_norm_pallas(x, w, b, 1e-5),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = layer_norm_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy), 1e-5)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4)
    # the autograd function (plain forward on CPU tensors) carries the same grads
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    LayerNormFunction.apply(*leaves, 1e-5).backward(torch.from_numpy(dy))
    for leaf, r in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=1e-4, atol=1e-4)


def test_layer_norm_backward_without_bias_and_dtypes():
    """dx comes back in x's dtype, dw in the weight's, db in the bias's, as
    ``_ln_vjp_bwd`` casts them; without a bias the function hands back no
    bias gradient."""
    x = torch.randn(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    dx, dw, db = layer_norm_bwd(x, w, torch.randn(4, 64, dtype=torch.bfloat16),
                                bias_dtype=torch.float32)
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16, torch.float32)
    assert dx.shape == x.shape and dw.shape == w.shape and db.shape == w.shape
    xt, wt = x.float().requires_grad_(), w.float().requires_grad_()
    LayerNormFunction.apply(xt, wt, None, 1e-5).sum().backward()
    ref_x, ref_w = x.float().requires_grad_(), w.float().requires_grad_()
    torch.nn.functional.layer_norm(ref_x, (64,), ref_w, None, 1e-5).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref_x.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), ref_w.grad.numpy(), atol=1e-5)
