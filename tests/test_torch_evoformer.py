"""Evoformer attention: the PyTorch port against the JAX package, on the CPU.

Mirrors ``tests/test_evoformer.py`` (the einsum path against a naive numpy
softmax, masks, column attention, gradients) and
``tests/test_pallas_kernels.py::test_evoformer_kernel_path_matches_xla``
(the kernel path, incl. the pair bias's gradient). The port's kernel path
(MSA rows folded into the batch, biases summed in fp32, the flash pieces'
bias mode) runs here through its plain pieces, against JAX
``evoformer_attention(use_kernel=True)`` with its Pallas kernels in
interpret mode. fp32 throughout: outputs 2e-5, the pair bias's grad 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops import evoformer_attn as jevo
from deepspeed_tpu_torch.ops import evoformer_attn as tevo
from deepspeed_tpu_torch.ops.flash_attention import flash_fwd_bias_cuda


def _naive(q, k, v, biases):
    d = q.shape[-1]
    logits = np.einsum("bsqhd,bskhd->bshqk", q, k) / np.sqrt(d)
    for b in biases:
        logits = logits + b
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bshqk,bskhd->bsqhd", p, v)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_einsum_path_matches_naive_and_jax():
    rs = np.random.RandomState(0)
    B, S, R, H, D = 2, 3, 8, 4, 16
    q, k, v = [rs.randn(B, S, R, H, D).astype(np.float32) for _ in range(3)]
    mask_bias = np.where(rs.rand(B, 1, 1, 1, R) > 0.2, 0.0, -1e30).astype(np.float32)
    pair_bias = rs.randn(B, 1, H, R, R).astype(np.float32)
    got = tevo.evoformer_attention(*_t(q, k, v), _t(mask_bias, pair_bias), use_kernel=False)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, [mask_bias, pair_bias]),
                               rtol=2e-4, atol=2e-4)
    want = jevo.evoformer_attention(*map(jnp.asarray, (q, k, v)),
                                    [jnp.asarray(mask_bias), jnp.asarray(pair_bias)],
                                    use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    got = tevo.evoformer_attention(*_t(q, k, v), use_kernel=False)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, []), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_mask", [False, True])
def test_kernel_path_matches_jax_kernel_path(with_mask):
    """The JAX test's shapes (S 3, r 24, 2 heads of 16): output and the
    pair bias's gradient; with a residue mask the two biases are summed in
    fp32 before the kernel, as in the JAX package."""
    rs = np.random.RandomState(2)
    S, r, h, d = 3, 24, 2, 16
    q, k, v = (rs.randn(1, S, r, h, d).astype(np.float32) for _ in range(3))
    pair = rs.randn(1, 1, h, r, r).astype(np.float32)
    mask = np.where(rs.rand(1, S, 1, 1, r) > 0.25, 0.0, -1e30).astype(np.float32)

    def jfn(p):
        biases = ([jnp.asarray(mask)] if with_mask else []) + [p]
        return jevo.evoformer_attention(*map(jnp.asarray, (q, k, v)), biases,
                                        use_kernel=True)

    out_j, vjp = jax.vjp(jfn, jnp.asarray(pair))
    g_j = vjp(2 * out_j)[0]
    p_t = torch.from_numpy(pair).requires_grad_()
    biases = (_t(mask) if with_mask else []) + [p_t]
    out_t = tevo._kernel_path(*_t(q, k, v), biases, d ** -0.5)
    (out_t ** 2).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=2e-5, atol=2e-5)
    assert p_t.grad.shape == pair.shape
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(g_j), rtol=2e-4, atol=2e-4)
    # and the port's two paths agree
    out_e = tevo.evoformer_attention(*_t(q, k, v), biases, use_kernel=False)
    np.testing.assert_allclose(out_t.detach().numpy(), out_e.detach().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_wholly_masked_msa_row_is_a_uniform_average():
    """An MSA row whose every residue is masked: each query's keys all carry
    -1e30, so its output is v's average over the residues, as the JAX
    kernel computes it (r 32 is one whole JAX block: nothing padded joins
    the average), and the pair bias's grad matches the JAX kernel's."""
    rs = np.random.RandomState(4)
    S, r, h, d = 2, 32, 2, 16
    q, k, v = (rs.randn(1, S, r, h, d).astype(np.float32) for _ in range(3))
    pair = rs.randn(1, 1, h, r, r).astype(np.float32)
    msa_mask = np.ones((1, S, r), np.float32)
    msa_mask[:, 1] = 0
    msa_mask[:, 0, 5] = 0
    mask_bias = np.where(msa_mask[..., :, None, None, :] > 0, 0.0, -1e30).astype(np.float32)

    def jfn(p):
        return jevo.evoformer_attention(*map(jnp.asarray, (q, k, v)),
                                        [jnp.asarray(mask_bias), p], use_kernel=True)

    out_j, vjp = jax.vjp(jfn, jnp.asarray(pair))
    g_j = vjp(2 * out_j)[0]
    p_t = torch.from_numpy(pair).requires_grad_()
    out_t = tevo._kernel_path(*_t(q, k, v), [torch.from_numpy(mask_bias), p_t], d ** -0.5)
    (out_t ** 2).sum().backward()
    uniform = np.broadcast_to(v[:, 1].mean(1, keepdims=True), (1, r, h, d))
    np.testing.assert_allclose(out_t.detach().numpy()[:, 1], uniform, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(g_j), rtol=2e-4, atol=2e-4)


def _weights(rs, c, scale=0.1):
    return [rs.randn(c, c).astype(np.float32) * scale for _ in range(4)]


def test_msa_row_attention_matches_jax_and_mask_blocks_invalid():
    rs = np.random.RandomState(2)
    S, R, C, H = 2, 6, 16, 4
    msa = rs.randn(1, S, R, C).astype(np.float32)
    ws = _weights(rs, C)
    pair = rs.randn(1, H, R, R).astype(np.float32)
    mask = np.ones((1, S, R), np.float32)
    mask[:, :, -2:] = 0
    got = tevo.msa_row_attention(*_t(msa, *ws), pair_bias=torch.from_numpy(pair),
                                 mask=torch.from_numpy(mask), num_heads=H, use_kernel=False)
    want = jevo.msa_row_attention(*map(jnp.asarray, (msa, *ws)), pair_bias=jnp.asarray(pair),
                                  mask=jnp.asarray(mask), num_heads=H)
    assert got.shape == msa.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # masked residues as KEYS don't affect valid outputs
    out = tevo.msa_row_attention(*_t(msa, *ws), mask=torch.from_numpy(mask), num_heads=H,
                                 use_kernel=False)
    msa2 = msa.copy()
    msa2[:, :, -2:] *= 5.0
    out2 = tevo.msa_row_attention(*_t(msa2, *ws), mask=torch.from_numpy(mask), num_heads=H,
                                  use_kernel=False)
    np.testing.assert_allclose(out[:, :, :4].numpy(), out2[:, :, :4].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_msa_column_attention_matches_jax_and_mixes_over_rows():
    rs = np.random.RandomState(3)
    msa = rs.randn(1, 4, 6, 8).astype(np.float32)
    ws = _weights(rs, 8)
    mask = (rs.rand(1, 4, 6) > 0.2).astype(np.float32)
    got = tevo.msa_column_attention(*_t(msa, *ws), mask=torch.from_numpy(mask), num_heads=2,
                                    use_kernel=False)
    want = jevo.msa_column_attention(*map(jnp.asarray, (msa, *ws)), mask=jnp.asarray(mask),
                                     num_heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    out = tevo.msa_column_attention(*_t(msa, *ws), num_heads=2, use_kernel=False)
    msa2 = msa.copy()
    msa2[:, :, 0, :] *= 3.0
    out2 = tevo.msa_column_attention(*_t(msa2, *ws), num_heads=2, use_kernel=False)
    assert out.shape == msa.shape
    np.testing.assert_allclose(out[:, :, 1:].numpy(), out2[:, :, 1:].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_gradients_flow_and_the_entry_point_defaults_to_the_card():
    q = torch.ones(1, 1, 4, 2, 8, requires_grad=True)
    tevo.evoformer_attention(q, q, q, use_kernel=False).sum().backward()
    assert torch.isfinite(q.grad).all()
    x = torch.zeros(1, 2, 8, 2, 16)
    before = flash_fwd_bias_cuda.launches
    for use_kernel in (None, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            tevo.evoformer_attention(x, x, x, use_kernel=use_kernel)
    with pytest.raises(RuntimeError, match="CUDA"):
        tevo.msa_row_attention(torch.zeros(1, 2, 8, 16), *[torch.zeros(16, 16)] * 4,
                               num_heads=2)
    assert flash_fwd_bias_cuda.launches == before
