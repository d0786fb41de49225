"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips on a machine without a GPU (a
CUDA kernel has no CPU mode). The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Tolerances: RMSNorm fp32 1e-5, bf16 1e-2 (one bf16 rounding step of
outputs of order 1). Paged decode: each output row's largest error within
6% of that row's RMS. A row over n positions has an RMS of about
sqrt(e/n), so an absolute limit would pass a wrong block on a long row;
sound bf16 rows read <= 3% (the plain version rounds the probabilities to
bf16), one wrong 128-position block >= 50%.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import get_op
from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_cuda, rms_norm_torch
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_decode_attention_cuda, paged_decode_attention_torch)

pytestmark = pytest.mark.cuda

RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DECODE_ROW_TOL = 0.06


def assert_rows_close(got, ref, tol=DECODE_ROW_TOL):
    """max |got - ref| over each last-dim row within ``tol`` of its RMS."""
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt()
    worst = float((diff / rms).max())
    assert worst <= tol, f"row err / row RMS {worst:.4f} > {tol}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [1, 7, 64, 333])
@pytest.mark.parametrize("d", [4096, 256, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_matches_plain(cuda_device, rows, d, dtype):
    rs = np.random.RandomState(rows + d)
    x = torch.from_numpy(rs.randn(rows, d).astype(np.float32) * 3).to(cuda_device, dtype)
    w = torch.from_numpy(1 + 0.1 * rs.randn(d).astype(np.float32)).to(cuda_device, dtype)
    before = rms_norm_cuda.launches
    got = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches == before + 1
    ref = rms_norm_torch(x, w, 1e-5)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


NH, HD, BS, NBLOCKS, MAX_BLOCKS = 8, 64, 8, 24, 4


def _decode_inputs(nkv, seed, device, hd=HD, bs=BS):
    rs = np.random.RandomState(seed)
    ctx = np.array([0, bs - 1, bs, bs + 1, MAX_BLOCKS * bs - 1], np.int32)
    B = len(ctx)
    q = rs.randn(B, NH, hd).astype(np.float32)
    kp = rs.randn(NBLOCKS, nkv, bs, hd).astype(np.float32)
    vp = rs.randn(NBLOCKS, nkv, bs, hd).astype(np.float32)
    tables = np.stack([rs.permutation(NBLOCKS)[:MAX_BLOCKS]
                       for _ in range(B)]).astype(np.int32)
    tables[0] = 0
    t = [torch.from_numpy(a).to(device) for a in (q, kp, vp, tables, ctx)]
    for i in range(3):
        t[i] = t[i].to(torch.bfloat16)
    return t


@pytest.mark.parametrize("nkv", [8, 4, 2, 1])
@pytest.mark.parametrize("window", [None, 1, 5, "tensor"])
@pytest.mark.parametrize("hd,bs", [(64, 8), (128, 16), (256, 8)])
def test_paged_decode_kernel_matches_plain(cuda_device, nkv, window, hd, bs):
    t = _decode_inputs(nkv, nkv + hd, cuda_device, hd=hd, bs=bs)
    if window == "tensor":
        window = torch.tensor(9, dtype=torch.int32, device=cuda_device)
    before = paged_decode_attention_cuda.launches
    got = get_op("paged_decode_attention", cuda_device)(*t, window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 1
    ref = paged_decode_attention_torch(*t, window=window)
    assert_rows_close(got, ref)


def test_paged_decode_kernel_long_context(cuda_device):
    """Contexts spanning many 128-position tiles and blocks of 128."""
    rs = np.random.RandomState(0)
    B, nh, nkv, hd, bs, nblocks, mb = 6, 32, 8, 128, 128, 40, 16
    ctx = torch.tensor([0, 127, 128, 129, 1000, mb * bs - 1], dtype=torch.int32,
                       device=cuda_device)
    tables = torch.from_numpy(rs.randint(1, nblocks, (B, mb)).astype(np.int32)).to(cuda_device)
    q, kp, vp = (torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda_device, torch.bfloat16)
                 for s in ((B, nh, hd), (nblocks, nkv, bs, hd), (nblocks, nkv, bs, hd)))
    for window in (None, 300):
        got = paged_decode_attention_cuda(q, kp, vp, tables, ctx, window=window)
        ref = paged_decode_attention_torch(q, kp, vp, tables, ctx, window=window)
        assert_rows_close(got, ref)
    # one wrong table entry on the longest row must fail the same check
    bad = tables.clone()
    bad[-1, mb // 2] = bad[-1, mb // 2] % (nblocks - 1) + 1
    got = paged_decode_attention_cuda(q, kp, vp, bad, ctx)
    ref = paged_decode_attention_torch(q, kp, vp, tables, ctx)
    with pytest.raises(AssertionError, match="row err"):
        assert_rows_close(got[-1:], ref[-1:])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    t = _decode_inputs(4, 0, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention_cuda(t[0], t[1], t[2], t[3].long(), t[4])
    with pytest.raises(ValueError, match="bf16"):
        paged_decode_attention_cuda(t[0].float(), t[1], t[2], t[3], t[4])
    with pytest.raises(ValueError, match=">= 1"):
        paged_decode_attention_cuda(*t, window=0)
    x = torch.ones(4, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        rms_norm_cuda(x, torch.ones(64, device=cuda_device, dtype=torch.float16))
