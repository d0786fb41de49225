"""RMSNorm: the PyTorch port against the JAX package.

The port's plain ``rms_norm_torch`` is held against JAX ``rms_norm_xla`` and
against the Pallas kernel ``rms_norm_pallas`` run in interpret mode (as
``tests/test_pallas_kernels.py`` runs it on the CPU), on the same inputs made
with numpy. The CUDA kernel is held against the plain version on a GPU by
``tests/test_torch_cuda_kernels.py``.

Tolerances: fp32 1e-5 (same arithmetic, only the order of the row sum
differs); bf16 1e-2 absolute and relative, one bf16 rounding step (2^-8
relative) of outputs of order 1, since both sides round the same fp32 value
and a different summation order can move it across a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.norms import rms_norm_xla
from deepspeed_tpu.ops.pallas.norms import rms_norm_pallas
from deepspeed_tpu_torch.ops import get_op
from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_cuda, rms_norm_torch

D = 256
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
