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
``tests/test_pallas_kernels.py`` holds the Pallas VJP against XLA's. fp16,
which the kernel takes too, is held to the Pallas kernel at bf16's 1e-2.

The kernel's arithmetic (each warp's mean and centred sum of squares over
its share of a row, the row's warps merged by Chan's formula) is
simulated in numpy and held to the plain version at 1e-5 (fp32; 1e-4 at a
mean of 100, as the GPU test holds the kernel there), and lane 31's share
left out of the centred sum (the warp kernel's planted fault) reads above
``chip_smoke.py``'s ``RMS_TOL`` of a row's RMS at the smoke's shape.
Training with an fp16 compute dtype: refused on a CUDA device (ROADMAP
queue B.2, ``check_compute_dtype``), run on the CPU.
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.norms import layer_norm_xla
from deepspeed_tpu.ops.pallas.norms import layer_norm_pallas
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops import get_op
from deepspeed_tpu_torch.ops.norms import (
    LayerNormFunction, layer_norm, layer_norm_bwd, layer_norm_cuda, layer_norm_torch)
from deepspeed_tpu_torch.runtime.engine import check_compute_dtype

D = 256
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
RMS_TOL = 0.05   # chip_smoke.py's limit: a row's largest error over its RMS


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


@pytest.mark.parametrize("rows", [1, 7, 33])
@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_fp16_matches_jax_pallas(rows, with_bias):
    """fp16, which the Pallas kernel and now the CUDA kernel take: the plain
    version against ``layer_norm_pallas`` in interpret mode at bf16's 1e-2."""
    (x_t, w_t, b_t), (x_j, w_j, b_j) = _inputs(rows, "float16", seed=rows)
    got = layer_norm_torch(x_t, w_t, b_t if with_bias else None, 1e-5)
    assert got.dtype == torch.float16
    ref = layer_norm_pallas(x_j, w_j, b_j if with_bias else None, 1e-5)
    assert ref.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def _warp_layer_norm(x, w, b, eps, vec, warps=1, drop_lane31=False):
    """numpy's fp32 rendering of ``layer_norm.cu``'s warp kernel: lane l of
    warp j holds the row's 16-byte vectors (c * warps + j) * 32 + l; each
    warp takes the sum of its share, its mean, and the centred sum of
    squares about that mean (``drop_lane31``: lane 31's part left out, the
    kernel's planted fault); the row's warps are merged pairwise by Chan's
    formula, as the kernel's tree does."""
    f32 = np.float32
    n, d = x.shape
    nv = d // vec
    per = -(-nv // (32 * warps))
    vi = ((np.arange(per)[:, None, None] * warps + np.arange(warps)[None, :, None]) * 32
          + np.arange(32)[None, None, :])                      # [c, warp, lane]
    live = vi < nv
    vals = np.where(live[None, ..., None],
                    x.reshape(n, nv, vec)[:, np.minimum(vi, nv - 1)], f32(0))
    cnt = (live.sum(axis=(0, 2)) * vec).astype(f32)             # [warp]
    mean = (vals.sum(axis=(1, 3, 4), dtype=f32) / cnt).astype(f32)       # [n, warp]
    dev = np.where(live[None, ..., None], vals - mean[:, None, :, None, None], f32(0))
    sq = (dev * dev).sum(axis=(1, 4), dtype=f32)                # [n, warp, lane]
    if drop_lane31:
        sq[..., 31] = 0
    q = sq.sum(axis=2, dtype=f32)
    st = [(cnt[j], mean[:, j], q[:, j]) for j in range(warps)]
    while len(st) > 1:   # Chan, pairwise: the variance stays centred
        nxt = []
        for (na, ma, qa), (nb, mb, qb) in zip(st[::2], st[1::2]):
            nn = na + nb
            delta = mb - ma
            fr = f32(nb / nn)
            nxt.append((nn, (ma + delta * fr).astype(f32),
                        (qa + qb + delta * delta * na * fr).astype(f32)))
        st = nxt
    _, ma, qa = st[0]
    r = (1 / np.sqrt(qa / f32(d) + f32(eps))).astype(f32)
    return ((x - ma[:, None]) * r[:, None]) * w + b


@pytest.mark.parametrize("d,vec,warps", [(2048, 8, 1), (768, 8, 1), (4096, 8, 2),
                                         (1024, 4, 1), (4096, 4, 4), (2048, 8, 8)])
def test_warp_merge_simulation_matches_plain(d, vec, warps):
    """The kernel's per-warp statistics and their Chan merge equal the plain
    two-pass version at the fp32 limit (1e-5); at a mean of 100, where
    E[x^2] - mean^2 would cancel, at the 1e-4 that the GPU tests hold the
    kernel to there (``test_layer_norm_kernel_large_mean``): the row's fp32
    sum of values near 100 moves the mean by a few 1e-6, which the plain
    version's cascaded sum does not."""
    rs = np.random.RandomState(d)
    for mean, tol in ((1.0, 1e-5), (100.0, 1e-4)):
        x = (rs.randn(64, d) * 3 + mean).astype(np.float32)
        w = (1 + 0.1 * rs.randn(d)).astype(np.float32)
        b = (0.2 * rs.randn(d)).astype(np.float32)
        got = _warp_layer_norm(x, w, b, 1e-5, vec, warps)
        ref = layer_norm_torch(*map(torch.from_numpy, (x, w, b)), 1e-5).numpy()
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_lane31_fault_exceeds_the_smoke_limit():
    """``chip_smoke.py``'s LayerNorm fault (lane 31's share left out of the
    centred sum) read as its check reads it: the worst row's largest error
    over the row's RMS, at OPT's serving step (64 rows of d 2048, bf16
    inputs, eight warps a row as the warp kernel runs it), must exceed
    ``RMS_TOL`` while the sound simulation stays far below it."""
    rs = np.random.RandomState(6)
    d = 2048
    x = torch.from_numpy((rs.randn(64, d) * 3 + 1).astype(np.float32)).bfloat16().float()
    w = torch.from_numpy((1 + 0.1 * rs.randn(d)).astype(np.float32)).bfloat16().float()
    b = torch.from_numpy((0.2 * rs.randn(d)).astype(np.float32)).bfloat16().float()
    ref = layer_norm_torch(x.bfloat16(), w.bfloat16(), b.bfloat16(), 1e-5).float()

    def row_err(y):
        y = torch.from_numpy(y).bfloat16().float()
        return float(((y - ref).abs().amax(-1) / ref.pow(2).mean(-1).sqrt()).max())

    args = (x.numpy(), w.numpy(), b.numpy(), 1e-5, 8, 8)
    assert row_err(_warp_layer_norm(*args)) < RMS_TOL / 2
    assert row_err(_warp_layer_norm(*args, drop_lane31=True)) > RMS_TOL


def test_model_specs_state_their_compute_dtype():
    for family, cfg in ((tllama, tllama.LlamaConfig.tiny()), (tgpt, tgpt.GPTConfig.tiny()),
                        (tbloom, tbloom.BloomConfig.tiny())):
        assert family.model_spec(cfg).compute_dtype == torch.bfloat16
        assert family.model_spec(cfg, compute_dtype=torch.float16).compute_dtype == \
            torch.float16


def test_fp16_compute_is_refused_on_cuda_and_trains_on_the_cpu():
    """No flash kernel takes fp16 yet (queue B.2): a CUDA device
    refuses it at ``initialize`` (the decision is ``check_compute_dtype``,
    called here with a CUDA device and no card); bf16 and fp32 pass, and on
    the CPU an fp16 OPT-style model trains with the fp16 loss scaler."""
    with pytest.raises(NotImplementedError, match="flash-attention path .*B.2"):
        check_compute_dtype(torch.float16, torch.device("cuda"))
    for ok in (torch.bfloat16, torch.float32, None):
        check_compute_dtype(ok, torch.device("cuda"))
    check_compute_dtype(torch.float16, torch.device("cpu"))
    cfg = tgpt.GPTConfig.tiny(activation="relu")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt.model_spec(cfg, compute_dtype=torch.float16),
        config={"train_batch_size": 4, "fp16": {"enabled": True, "initial_scale_power": 8},
                "optimizer": {"type": "adamw", "params": {"lr": 3e-3}}, "seed": 3,
                "steps_per_print": 0},
        device="cpu")
    batch = {"tokens": np.random.RandomState(5).randint(0, 256, (4, 17)).astype(np.int32)}
    losses = [float(eng.train_batch(batch).loss) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
