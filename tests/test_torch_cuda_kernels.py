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
bf16), one wrong 128-position block >= 50%. The int8 mode of paged decode
and the spec-verify kernel (bf16 and int8) are held to the same 6%: the
kernels dequantize in fp32, the plain versions at one group per vector in
fp32 and otherwise into bf16 (one rounding step of each K/V element).

Flash attention (forward, dQ, dK/dV) against its plain pieces
(``flash_fwd_torch``/``flash_bwd_torch``, which round p, ds and the outputs
at the kernels' points): each output row's largest error within a share of
that row's RMS (floored at 1% of the output's), 0.05 in bf16 (summation
order moves a value across a rounding step at most) and 1e-4 in fp32 (FMA
against cuBLAS fp32 sums). Through op ``attention`` against plain attention
in fp32 under autograd, the limits of ``chip_smoke.py``'s ``FLASH_TOL``
(0.05, dQ 0.15 with its rows floored at the output's RMS), from the CPU
simulation in ``tests/test_torch_flash_attention.py``. RMSNorm
backward: the autograd function's grads against the plain version's, 1e-2
in bf16 (one rounding step), 1e-5 in fp32. LayerNorm forward and backward:
the same limits as RMSNorm, fp16 1e-3 (one fp16 rounding step of outputs
of order 1); lane 31's share left out of the centred sum (its planted
fault) must fail them. int8 quantize and dequantize (bf16, fp16, fp32):
codes, scales and values EQUAL to the plain versions' (the IEEE quotient's
codes, round half to even, one fp32 product), so no tolerance; the
quantize kernel's corrected product at exact ties and boundary quotients, and
each of ``quantize.cu``'s three planted faults breaking the equality. The OPT-1.3B shapes of the paged and flash
kernels (MHA: g = 1, 32 kv heads, hd 64, S 2048) at the limits above.
The one paged kernel (``paged_sm90.cu``) also at live lengths around its
split boundaries, at Falcon-7B's shapes (71 query heads over one kv head:
71 and 355 rows), giving identical bits on two calls, and failing the
row check under each of its planted faults.

The flash kernels' bias mode (forward, dQ with and without dbias, dK/dV)
against the plain pieces with the same bias, at the flash limits above
(dbias as a share of its row's RMS too); biases read with stride 0
(ALiBi's [H, 1, S], a pair bias shared over the batch) and in full, bf16
and fp32, hd 32/64/128. The block-sparse kernels (forward, dQ, dK/dV)
against their dense plain versions at the same limits, over blocks
16-128, sliding-window / fixed / bigbird layouts, causal and not, GQA and
a kv block nobody attends to (exactly zero dK/dV). The bf16 dK/dV at block
128 (``sparse_sm90.cu``: columns split over work items, TMA + wgmma) at
S 4096 for the three layouts, groups 1 and 4, hd 32/64/128, with the
global column split into >= 4 chunks, giving identical bits on two calls,
and failing the same limits under each of its three planted faults; its dQ
and forward likewise (the forward's o and lse against ``sparse_fwd_torch``
over the three layouts, causal and not, groups 1 and 4, hd 32/64/128; its
planted faults 7-9). ``sparse_attention.cu`` keeps blocks 16-64 and fp32;
its dK/dV splits the columns by the same plan: at blocks 16, 32 and 64, bf16
and fp32, against the plain pieces, two calls bit-identical, a column
nobody attends to exactly zero, and its planted fault (the merge dropping a
split column's last chunk) failing. Its forward and dQ (work items that
stack the query heads of a kv head, a cp.async K / V ring, bf16 P and dS in
registers): o, lse and dq against the plain pieces at blocks 16/32/64 bf16
and 16-128 fp32, groups 1, 2, 4 and 8 (a group over several items), causal
and not, the fixed layout's long rows; two calls bit-identical; planted
faults 2 (the forward's ring stage read early) and 3 (dQ's last head left
out) failing, the next call clean.

The bf16 backward without a bias (``flash_bwd_sm90.cu``, TMA + wgmma): dQ,
dK and dV against the plain pieces at the flash limits above over lengths
1-4096 on both sides (tails of both tiles), q_offset, windows, GQA 1/4/8,
hd 32/64/128, non-causal and rows that see no key; each of its three
planted faults must fail them. Its bias mode (the same source): dQ, dK, dV
and dbias against the plain pieces at the same limits over every broadcast
form of the bias (bf16 and fp32, with and without dbias), ragged tails, Sq
!= Skv, GQA 1/4/8 and hd 32/64/128; dbias zeros above the diagonal (written
by the kernel, over memory that held NaN), a query whose every key carries
-1e30, Sq = 0; its four planted faults (the bias read one kv tile off
among them) must fail at an ALiBi and a full-bias shape; and
``flash_bwd.cu``'s entry points refuse bf16 with a bias too.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu_torch.models.bloom import _alibi_bias
from deepspeed_tpu_torch.ops import _build, get_op
from deepspeed_tpu_torch.ops.attention import attention, attention_torch
from deepspeed_tpu_torch.ops.evoformer_attn import evoformer_attention
from deepspeed_tpu_torch.ops.flash_attention import (
    FlashAttentionBias, flash_attention, flash_bwd_dkv_bias_cuda, flash_bwd_dkv_cuda,
    flash_bwd_dq_bias_cuda, flash_bwd_dq_cuda, flash_bwd_torch, flash_fwd_bias_cuda,
    flash_fwd_cuda, flash_fwd_torch, sm90_planted_fault, tma_refusal)
from deepspeed_tpu_torch.ops.norms import (
    layer_norm, layer_norm_bwd, layer_norm_cuda, layer_norm_planted_fault, layer_norm_torch,
    rms_norm, rms_norm_bwd, rms_norm_cuda, rms_norm_planted_fault, rms_norm_torch)
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_decode_attention_cuda, paged_decode_attention_int8_cuda,
    paged_decode_attention_torch, paged_planted_fault, paged_spec_verify_attention_cuda,
    paged_spec_verify_attention_torch)
from deepspeed_tpu_torch.ops.quantization import (
    dequantize_int8_cuda, dequantize_int8_torch, quantize_int8_cuda, quantize_int8_torch,
    quantize_planted_fault)
from deepspeed_tpu_torch.ops.sparse_attention import (
    MMA_ITEM_ROWS, SPARSE_SM90, bigbird_layout, blocksparse_attention, dkv_split_plan,
    fixed_layout, mma_items, sliding_window_layout, sparse_attention_planted_fault,
    sparse_bwd_dkv_cuda, sparse_bwd_dkv_sm90_cuda, sparse_bwd_dq_cuda, sparse_bwd_dq_sm90_cuda,
    sparse_bwd_torch, sparse_fwd_cuda, sparse_fwd_sm90_cuda, sparse_fwd_torch,
    sparse_sm90_planted_fault, sparse_source)

pytestmark = pytest.mark.cuda

# chip_smoke.py's inputs of the quantize kernel's division
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
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


def _rms_inputs(rows, d, dtype, device):
    rs = np.random.RandomState(rows + d)
    x = torch.from_numpy(rs.randn(rows, d).astype(np.float32) * 3).to(device, dtype)
    w = torch.from_numpy(1 + 0.1 * rs.randn(d).astype(np.float32)).to(device, dtype)
    return x, w


@pytest.mark.parametrize("rows", [1, 7, 64, 333])
@pytest.mark.parametrize("d", [4096, 256, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rms_norm_kernel_matches_plain(cuda_device, rows, d, dtype):
    x, w = _rms_inputs(rows, d, dtype, cuda_device)
    before = rms_norm_cuda.launches
    got = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    ref = rms_norm_torch(x, w, 1e-5)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


# widths that reach each of rms_norm.cu's kernels: the vector kernel at 1-16
# 16-byte vectors a thread (bf16/fp16: d 256-2048 1, 4096 2, 8192 4, 16384 8,
# 18432 and 32768 16; fp32 a step further), the scalar kernel (d not a whole
# number of vectors, up to 8192: 100 and 4100 at bf16/fp16) and the wide
# kernel (bf16/fp16 d 65536, fp32 from 18432, 8193 at every dtype)
RMS_WIDTHS = [256, 2048, 4096, 8192, 16384, 18432, 32768, 65536, 100, 4100, 8193]


@pytest.mark.parametrize("d", RMS_WIDTHS)
@pytest.mark.parametrize("rows", [1, 64, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rms_norm_each_kernel_matches_plain(cuda_device, d, rows, dtype):
    """Every kernel of rms_norm.cu at each shape it runs: no width is
    refused."""
    x, w = _rms_inputs(rows, d, dtype, cuda_device)
    got = rms_norm_cuda(x, w, 1e-5)
    torch.cuda.synchronize()
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), rms_norm_torch(x, w, 1e-5).float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("fault", [1, 2])
@pytest.mark.parametrize("d", [2048, 4096, 16384, 1001, 65536, 8193])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_rms_norm_check_fails_a_planted_fault(cuda_device, fault, d, dtype):
    """Lane 31's partial left out of the sum (1), the weight left off a
    row's first vector (2): each kernel (vector, scalar at d 1001, wide at
    d 65536 and 8193) under each fault must fail the check that it passes
    on the same inputs."""
    x, w = _rms_inputs(64, d, dtype, cuda_device)
    ref = rms_norm_torch(x, w, 1e-5).float()
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(rms_norm_cuda(x, w, 1e-5).float(), ref, rtol=tol, atol=tol)
    with rms_norm_planted_fault(fault):
        bad = rms_norm_cuda(x, w, 1e-5)
        torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad.float(), ref, rtol=tol, atol=tol)


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
    x = torch.ones(4, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="bf16, fp16 or f32"):
        rms_norm_cuda(x, torch.ones(64, device=cuda_device, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rms_norm_kernel_backward(cuda_device, dtype):
    """The kernel's output carries gradients; they are the plain backward's."""
    rs = np.random.RandomState(7)
    x0 = torch.from_numpy(rs.randn(3, 5, 256).astype(np.float32) * 2).to(cuda_device, dtype)
    w0 = torch.from_numpy(1 + 0.1 * rs.randn(256).astype(np.float32)).to(cuda_device, dtype)
    dy = torch.from_numpy(rs.randn(3, 5, 256).astype(np.float32)).to(cuda_device, dtype)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    before = rms_norm_cuda.launches
    y = rms_norm(x, w, 1e-5)
    assert y.requires_grad and rms_norm_cuda.launches == before + 1
    y.backward(dy)
    dx_ref, dw_ref = rms_norm_bwd(x0, w0, dy, 1e-5)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(x.grad.float(), dx_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(w.grad.float(), dw_ref.float(), rtol=tol, atol=tol * 10)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    rms_norm_torch(xr, wr, 1e-5).backward(dy)
    torch.testing.assert_close(x.grad.float(), xr.grad.float(), rtol=tol, atol=tol)


FLASH_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-4}


def assert_flash_close(got, ref, tol, floor=0.01):
    """``assert_rows_close`` with each row's RMS floored at ``floor`` times
    the whole output's: a row whose exact value is 0 (dQ of a query that
    sees one key, where ds = p (dp - delta) cancels) holds only rounding
    noise on both sides."""
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt()
    rms = rms.clamp_min(floor * float(ref.float().pow(2).mean().sqrt()))
    worst = float((diff / rms).max())
    assert worst <= tol, f"row err / row RMS {worst:.4f} > {tol}"
# (B, Sq, Skv, H, Hkv, D, causal, q_offset, window)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, None),      # GQA g = 2, whole tiles
    (1, 100, 100, 8, 1, 128, True, 0, None),     # tail rows, g = 8
    (1, 37, 200, 4, 4, 64, True, 163, None),     # q_offset, kv longer than q
    (1, 256, 256, 8, 2, 128, True, 0, 50),       # sliding window
    (2, 70, 130, 2, 2, 64, False, 0, None),      # non-causal, tails on both sides
    (1, 64, 300, 4, 2, 128, True, 100, None),    # kv rows no query sees: dk = dv = 0
    (1, 192, 192, 4, 1, 64, True, 0, 3),         # narrow window: three keys a row
]


def flash_inputs(case, dtype, device, seed=0):
    B, sq, skv, h, hkv, d = case[:6]
    rs = np.random.RandomState(seed)
    t = [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device, dtype)
         for shape in ((B, sq, h, d), (B, skv, hkv, d), (B, skv, hkv, d), (B, sq, h, d))]
    return t   # q, k, v, dO


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, case, dtype):
    q, k, v, do = flash_inputs(case, dtype, cuda_device)
    kw = dict(causal=case[6], q_offset=case[7], window=case[8])
    counts = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_flash_close(o, o_ref, FLASH_TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
            flash_bwd_dkv_cuda.launches) == tuple(c + 1 for c in counts)
    refs = flash_bwd_torch(q, k, v, o, lse, do, **kw)
    for got, ref in zip((dq, dk, dv), refs):
        assert got.shape == ref.shape and got.dtype == dtype
        assert_flash_close(got, ref, FLASH_TOL[dtype])


# the Llama-3-8B attention shapes chip_smoke.py checks (32 q heads, hd 128)
LLAMA_CASES = [   # Sq, Skv, kv heads, causal, q_offset, window
    (4096, 4096, 8, True, 0, None),
    (1000, 1000, 8, True, 0, None),
    (512, 4096, 8, True, 3584, None),
    (4096, 4096, 8, True, 0, 1024),
    (4096, 4096, 8, False, 0, None),
    (4096, 4096, 32, True, 0, None),
]


@pytest.mark.parametrize("case", LLAMA_CASES)
def test_flash_kernels_match_plain_at_llama_shapes(cuda_device, case):
    sq, skv, hkv, causal, q_offset, window = case
    q, k, v, do = flash_inputs((1, sq, skv, 32, hkv, 128), torch.bfloat16, cuda_device,
                               seed=sq + hkv)
    kw = dict(causal=causal, q_offset=q_offset, window=window)
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    assert_flash_close(o, flash_fwd_torch(q, k, v, **kw)[0], FLASH_TOL[torch.bfloat16])
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    got = (flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw),
           *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))
    for g, ref in zip(got, flash_bwd_torch(q, k, v, o, lse, do, **kw)):
        assert_flash_close(g, ref, FLASH_TOL[torch.bfloat16])


def test_flash_op_autograd_matches_plain_attention(cuda_device):
    """Op ``attention`` on CUDA tensors is the flash autograd function; its
    output and grads are plain attention's under autograd (fp32 on the same
    bf16 inputs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    case = (2, 96, 96, 8, 2, 128, True, 0, None)
    q0, k0, v0, do = flash_inputs(case, torch.bfloat16, cuda_device, seed=3)
    assert get_op("attention", cuda_device) is flash_attention
    grads = []
    for fn, dtype in ((attention, torch.bfloat16), (attention_torch, torch.float32)):
        q, k, v = (t.detach().to(dtype).requires_grad_() for t in (q0, k0, v0))
        o = fn(q, k, v, causal=True)
        (o.float() * do.float()).sum().backward()
        grads.append((o.detach(), q.grad, k.grad, v.grad))
    for (tol, floor), got, ref in zip(((0.05, 0.01), (0.15, 1.0), (0.05, 0.01), (0.05, 0.01)),
                                      *grads):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert_flash_close(got, ref, tol, floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_rows_that_see_no_key(cuda_device, dtype):
    """q rows at positions 60..123 over 70 keys with a window of 8: rows
    past position 76 see no key and get o = 0, lse = -1e30 and no grads,
    as the TPU kernel's ``_finish`` writes; the others match the plain
    pieces."""
    q, k, v, do = flash_inputs((1, 64, 70, 4, 2, 64), dtype, cuda_device, seed=9)
    kw = dict(causal=True, q_offset=60, window=8)
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd_torch(q, k, v, **kw)
    empty = torch.arange(64, device=cuda_device) + 60 > 69 + 7
    assert not o[:, empty].any() and bool((lse.view(4, 64)[:, empty] == -1e30).all())
    assert_flash_close(o, o_ref, FLASH_TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(4, 64)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    assert not dq[:, empty].any()
    for got, ref in zip((dq, dk, dv), flash_bwd_torch(q, k, v, o, lse, do, **kw)):
        assert_flash_close(got, ref, FLASH_TOL[dtype])


def test_flash_check_fails_a_swapped_k_tile(cuda_device):
    case = (1, 256, 256, 4, 2, 128, True, 0, None)
    q, k, v, _ = flash_inputs(case, torch.bfloat16, cuda_device, seed=5)
    bad = k.clone()
    bad[:, 64:128], bad[:, 128:192] = k[:, 128:192], k[:, 64:128]
    o, _ = flash_fwd_cuda(q, bad, v)
    o_ref, _ = flash_fwd_torch(q, k, v)
    with pytest.raises(AssertionError, match="row err"):
        assert_flash_close(o, o_ref, FLASH_TOL[torch.bfloat16])


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, k, v, _ = flash_inputs((1, 8, 8, 2, 2, 64, True, 0, None), torch.bfloat16,
                              cuda_device)
    q96, k96, v96, _ = flash_inputs((1, 8, 8, 2, 2, 96), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd_cuda(q96, k96, v96)
    with pytest.raises(ValueError, match="dtypes"):
        flash_fwd_cuda(q, k.float(), v)
    with pytest.raises(ValueError, match="window"):
        flash_fwd_cuda(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q.cpu(), k.cpu(), v.cpu())
    # a mask goes to plain attention, as the JAX package hands it to XLA
    before = flash_fwd_cuda.launches
    mask = torch.ones(1, 1, 8, 8, dtype=torch.bool, device=cuda_device)
    out = flash_attention(q, k, v, mask=mask)
    assert flash_fwd_cuda.launches == before
    assert_flash_close(out, attention_torch(q, k, v, mask=mask), 1e-6)
    # the bias mode takes no window: the op runs window + bias in plain
    # attention, the raw bias wrappers refuse it
    bias = torch.randn(2, 1, 8, device=cuda_device)
    lse = torch.zeros(2, 8, device=cuda_device)
    for call in (lambda: flash_fwd_bias_cuda(q, k, v, bias, window=4),
                 lambda: flash_bwd_dq_bias_cuda(q, k, v, q, lse, lse, bias, window=4),
                 lambda: flash_bwd_dkv_bias_cuda(q, k, v, q, lse, lse, bias, window=4)):
        with pytest.raises(ValueError, match="takes no window"):
            call()
    before = flash_fwd_bias_cuda.launches
    out = flash_attention(q, k, v, bias=bias, window=4)
    assert flash_fwd_bias_cuda.launches == before
    assert_flash_close(out, attention_torch(q, k, v, bias=bias, window=4), 1e-6)


# --------------------------------------------------------------------------- #
# the bf16 forward on TMA + wgmma (ops/csrc/flash_fwd_sm90.cu)
# --------------------------------------------------------------------------- #
def _sm90_forward_close(device, case, seed, bias=None):
    """Run the bf16 forward on ``case`` = (B, Sq, Skv, H, Hkv, D, causal,
    q_offset, window) and hold o and lse to the plain version; returns
    (o, lse, o_ref, lse_ref)."""
    q, k, v, _ = flash_inputs(case, torch.bfloat16, device, seed=seed)
    kw = dict(causal=case[6], q_offset=case[7], window=case[8])
    if bias is None:
        before = flash_fwd_cuda.launches
        o, lse = flash_fwd_cuda(q, k, v, **kw)
        assert flash_fwd_cuda.launches == before + 1
    else:
        before = flash_fwd_bias_cuda.launches
        o, lse = flash_fwd_bias_cuda(q, k, v, bias, **kw)
        assert flash_fwd_bias_cuda.launches == before + 1
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_fwd_torch(q, k, v, bias=bias, **kw)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert_flash_close(o, o_ref, FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    return o, lse, o_ref, lse_ref


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 129, 200, 4096])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_forward_lengths(cuda_device, d, s, causal):
    """Sq = Skv at lengths below, at and past one 128-row tile and a long
    one: the tails are TMA's zero fill and the masked stores."""
    _sm90_forward_close(cuda_device, (1, s, s, 4, 2, d, causal, 0, None), seed=s + d)


@pytest.mark.parametrize("sq,skv", [(1, 4096), (127, 200), (129, 4096), (200, 129), (1, 127)])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_forward_unequal_lengths(cuda_device, sq, skv, d):
    """Sq != Skv, non-causal (every pair visible) and causal as a continued
    prefill (q row 0 at position Skv - Sq, where that is >= 0)."""
    _sm90_forward_close(cuda_device, (2, sq, skv, 4, 4, d, False, 0, None), seed=sq + skv)
    if skv >= sq:
        _sm90_forward_close(cuda_device, (2, sq, skv, 4, 4, d, True, skv - sq, None),
                            seed=sq * skv)


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_sm90_forward_gqa(cuda_device, g, d):
    """GQA read in place: query head h reads kv head h // g."""
    _sm90_forward_close(cuda_device, (2, 300, 300, 8, 8 // g, d, True, 0, None), seed=g * d)


@pytest.mark.parametrize("window", [1, 3, 100, 1024])
@pytest.mark.parametrize("d", [32, 128])
def test_sm90_forward_window(cuda_device, window, d):
    """The causal window: kv tiles before the band are not loaded, tiles
    across its edge are masked."""
    _sm90_forward_close(cuda_device, (1, 2000, 2000, 4, 1, d, True, 0, window),
                        seed=window + d)
    _sm90_forward_close(cuda_device, (1, 333, 2000, 4, 1, d, True, 1667, window),
                        seed=window * d)


BIAS_FORMS = {   # name: bias shape from (B, H, Sq, Skv); broadcast dims get stride 0
    "full": lambda b, h, sq, skv: (b, h, sq, skv),
    "alibi": lambda b, h, sq, skv: (h, 1, skv),
    "per row": lambda b, h, sq, skv: (1, h, sq, 1),
    "pair": lambda b, h, sq, skv: (1, h, sq, skv),
    "per batch": lambda b, h, sq, skv: (b, 1, 1, skv),
}


@pytest.mark.parametrize("form", sorted(BIAS_FORMS))
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,causal,skv", [(32, False, 256), (64, True, 129), (128, True, 300)])
def test_sm90_forward_bias_strides(cuda_device, form, bias_dtype, d, causal, skv):
    """The bias mode reads the bias in place through its four strides, any
    of which may be 0, with odd kv lengths (no paired loads) and even ones."""
    b, h, sq = 2, 4, 200
    rs = np.random.RandomState(d + skv)
    bias = torch.from_numpy(rs.randn(*BIAS_FORMS[form](b, h, sq, skv)).astype(np.float32))
    _sm90_forward_close(cuda_device,
                        (b, sq, skv, h, 2, d, causal, skv - sq if causal else 0, None),
                        seed=d, bias=bias.to(cuda_device, bias_dtype))


@pytest.mark.parametrize("d", [32, 64, 128])
def test_sm90_forward_rows_that_see_no_key(cuda_device, d):
    """No bias: q rows past the window's reach see no key and get o = 0,
    lse = -1e30 (the TPU kernel's ``_finish``)."""
    o, lse, _, _ = _sm90_forward_close(cuda_device, (1, 200, 150, 4, 2, d, True, 100, 16),
                                       seed=d)
    empty = torch.arange(200, device=cuda_device) + 100 > 149 + 15
    assert empty.any() and not o[:, empty].any()
    assert bool((lse.view(4, 200)[:, empty] == -1e30).all())


@pytest.mark.parametrize("d", [32, 128])
def test_sm90_forward_rows_whose_keys_all_carry_minus_1e30(cuda_device, d):
    """Bias mode: a row whose every key carries a -1e30 bias averages v
    uniformly, lse = -1e30 + log(Skv) (the rule of ROADMAP queue C)."""
    b, h, sq, skv = 2, 4, 130, 260
    bias = torch.zeros(b, 1, sq, skv, device=cuda_device)
    bias[1, :, 7] = -1e30
    q, k, v, _ = flash_inputs((b, sq, skv, h, h, d), torch.bfloat16, cuda_device, seed=d)
    o, lse = flash_fwd_bias_cuda(q, k, v, bias, causal=False)
    o_ref, lse_ref = flash_fwd_torch(q, k, v, bias=bias, causal=False)
    torch.cuda.synchronize()
    assert_flash_close(o, o_ref, FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(o[1, 7].float(), v[1].float().mean(0),
                               rtol=0, atol=0.02)
    rows = lse.view(b, h, sq)[1, :, 7]
    torch.testing.assert_close(rows, torch.full_like(rows, -1e30 + float(np.log(skv))))
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fault,what", [(1, "ring stage read one step late"),
                                        (2, "last kv tile of the causal band dropped")])
def test_sm90_forward_check_fails_a_planted_fault(cuda_device, fault, what):
    """The planted faults of ``sm90_planted_fault`` must fail the check the
    sound kernel passes, at Llama-3-8B's attention shape cut to S 1024."""
    case = (1, 1024, 1024, 32, 8, 128, True, 0, None)
    q, k, v, _ = flash_inputs(case, torch.bfloat16, cuda_device, seed=fault)
    o_ref, _ = flash_fwd_torch(q, k, v)
    o, _ = flash_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    assert_flash_close(o, o_ref, FLASH_TOL[torch.bfloat16])
    with sm90_planted_fault(fault):
        o_bad, _ = flash_fwd_cuda(q, k, v)
        torch.cuda.synchronize()
    with pytest.raises(AssertionError, match="row err"):
        assert_flash_close(o_bad, o_ref, FLASH_TOL[torch.bfloat16])


def test_sm90_forward_refuses_what_tma_cannot_read(cuda_device):
    """A bf16 q whose base is not 16-byte aligned raises before any launch
    (the kernel is not swapped for another path); a slice of a fused qkv
    tensor is made dense by the wrapper and runs."""
    case = (1, 64, 64, 2, 2, 64)
    q, k, v, _ = flash_inputs(case, torch.bfloat16, cuda_device)
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    assert q_odd.is_contiguous() and "16 bytes" in tma_refusal(q_odd)
    before = flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_fwd_cuda(q_odd, k, v)
    assert flash_fwd_cuda.launches == before
    fused = torch.stack([q, q, q], dim=2)[:, :, 0]      # a slice of a fused qkv tensor
    o, _ = flash_fwd_cuda(fused, k, v)                   # the wrapper makes it dense
    assert_flash_close(o, flash_fwd_torch(q, k, v)[0], FLASH_TOL[torch.bfloat16])


# --------------------------------------------------------------------------- #
# the bf16 backward on TMA + wgmma (ops/csrc/flash_bwd_sm90.cu)
# --------------------------------------------------------------------------- #
def _sm90_backward(q, k, v, do, kw):
    """The forward, then dQ and dK/dV (one launch each) on its o and lse:
    ``(o, lse, (dq, dk, dv))``."""
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    return o, lse, (dq, dk, dv)


ONE_KEY_DS = 1e-4   # |dq|, |dk| where every query sees one key: exactly 0, ~1e-6 of rounding


def _sm90_backward_close(device, case, seed, one_key=False):
    """Hold the bf16 backward's dq, dk, dv on ``case`` = (B, Sq, Skv, H,
    Hkv, D, causal, q_offset, window) to the plain pieces; returns
    (grads, refs). ``one_key``: every query sees exactly one key, so ds =
    p (dp - delta) is exactly 0 (p = 1, dp = delta), and so are dq = ds k
    and dk = ds^T q: both sides hold only rounding noise of O(1) inputs,
    held to ``ONE_KEY_DS`` instead, where a wrong value is O(1); dv = p^T dO
    is held as always."""
    q, k, v, do = flash_inputs(case, torch.bfloat16, device, seed=seed)
    kw = dict(causal=case[6], q_offset=case[7], window=case[8])
    o, lse, grads = _sm90_backward(q, k, v, do, kw)
    refs = flash_bwd_torch(q, k, v, o, lse, do, **kw)
    for i, (got, ref) in enumerate(zip(grads, refs)):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        if i < 2 and one_key:
            assert float(ref.float().abs().max()) <= ONE_KEY_DS
            assert float(got.float().abs().max()) <= ONE_KEY_DS
        else:
            assert_flash_close(got, ref, FLASH_TOL[torch.bfloat16])
    return grads, refs


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 129, 200, 4096])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_backward_lengths(cuda_device, d, s, causal):
    """Sq = Skv below, at and past one tile (64 and 128 rows) and a long
    one: the tails are TMA's zero fill, the element mask and the masked
    stores. At S = 1 the one query sees one key."""
    _sm90_backward_close(cuda_device, (1, s, s, 4, 2, d, causal, 0, None), seed=s + d,
                         one_key=s == 1)


@pytest.mark.parametrize("sq,skv", [(1, 4096), (127, 200), (129, 4096), (200, 129), (1, 127)])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_backward_unequal_lengths(cuda_device, sq, skv, d):
    """Sq != Skv, non-causal, and causal as a continued prefill (q row 0 at
    position Skv - Sq, where that is >= 0): kv rows before the first q
    tile's band see every q row, later ones fewer."""
    _sm90_backward_close(cuda_device, (2, sq, skv, 4, 4, d, False, 0, None), seed=sq + skv)
    if skv >= sq:
        _sm90_backward_close(cuda_device, (2, sq, skv, 4, 4, d, True, skv - sq, None),
                             seed=sq * skv)


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_sm90_backward_gqa(cuda_device, g, d):
    """GQA read in place; dK/dV narrow, each kv head summing its g query
    heads in registers."""
    _sm90_backward_close(cuda_device, (2, 300, 300, 8, 8 // g, d, True, 0, None), seed=g * d)


@pytest.mark.parametrize("window", [1, 3, 100, 1024])
@pytest.mark.parametrize("d", [32, 128])
def test_sm90_backward_window(cuda_device, window, d):
    """The causal window: tiles outside the band are not loaded, tiles
    across its edge are masked. A window of 1: each query sees itself."""
    _sm90_backward_close(cuda_device, (1, 2000, 2000, 4, 1, d, True, 0, window),
                         seed=window + d, one_key=window == 1)
    _sm90_backward_close(cuda_device, (1, 333, 2000, 4, 1, d, True, 1667, window),
                         seed=window * d, one_key=window == 1)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_sm90_backward_rows_that_see_no_key(cuda_device, d):
    """q rows past the window's reach see no key (lse = -1e30): their dq is
    exactly 0, and kv rows no query sees get dk = dv = 0."""
    (dq, dk, dv), _ = _sm90_backward_close(cuda_device, (1, 200, 150, 4, 2, d, True, 100, 16),
                                           seed=d)
    empty = torch.arange(200, device=cuda_device) + 100 > 149 + 15
    assert empty.any() and not dq[:, empty].any()
    (dq, dk, dv), _ = _sm90_backward_close(cuda_device, (1, 64, 300, 4, 2, d, True, 100, None),
                                           seed=d + 1)
    unseen = torch.arange(300, device=cuda_device) > 63 + 100
    assert not dk[:, unseen].any() and not dv[:, unseen].any()


@pytest.mark.parametrize("fault,what,keys", [
    (1, "ring stage read one step late", (0, 1)),
    (2, "last tile of each band dropped", (0, 2)),
    (3, "last query head of each GQA group skipped", (1, 2))])
def test_sm90_backward_check_fails_a_planted_fault(cuda_device, fault, what, keys):
    """The planted faults of ``sm90_planted_fault(.., "bwd")`` must fail the
    check the sound kernels pass, at Llama-3-8B's attention shape cut to
    S 1024 (dq, dk, dv: the grads each fault must break)."""
    case = (1, 1024, 1024, 32, 8, 128, True, 0, None)
    _, refs = _sm90_backward_close(cuda_device, case, seed=fault)
    q, k, v, do = flash_inputs(case, torch.bfloat16, cuda_device, seed=fault)
    with sm90_planted_fault(fault, "bwd"):
        _, _, bad = _sm90_backward(q, k, v, do, dict(causal=True))
    for i in keys:
        with pytest.raises(AssertionError, match="row err"):
            assert_flash_close(bad[i], refs[i], FLASH_TOL[torch.bfloat16])


def test_sm90_backward_takes_no_query_rows(cuda_device):
    """Sq = 0: dq is empty and dK/dV are zeros, as no query sees a key (a
    tensor map cannot span 0 rows, so the dK/dV entry point clears them)."""
    q, k, v, do = flash_inputs((1, 0, 70, 4, 2, 64), torch.bfloat16, cuda_device)
    _, lse = flash_fwd_cuda(q, k, v, causal=False)
    delta = torch.zeros(4, 0, device=cuda_device)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=False)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert not dk.any() and not dv.any()


def test_sm90_backward_refuses_what_tma_cannot_read(cuda_device):
    """A bf16 dO whose base is not 16-byte aligned raises before any launch
    (no other kernel takes the call); a slice of a wider tensor is made
    dense by the wrapper and runs."""
    case = (1, 64, 64, 2, 2, 64)
    q, k, v, do = flash_inputs(case, torch.bfloat16, cuda_device)
    o, lse = flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(2, 64)
    buf = torch.empty(do.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    do_odd = buf[1:].view(do.shape)
    do_odd.copy_(do)
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    for call in (lambda: flash_bwd_dq_cuda(q, k, v, do_odd, lse, delta),
                 lambda: flash_bwd_dkv_cuda(q, k, v, do_odd, lse, delta)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == before
    wide = torch.stack([do, do], dim=3)[:, :, :, 0]     # strided: made dense by the wrapper
    dq = flash_bwd_dq_cuda(q, k, v, wide, lse, delta)
    assert_flash_close(dq, flash_bwd_torch(q, k, v, o, lse, do)[0], FLASH_TOL[torch.bfloat16])


def test_old_backward_entry_points_refuse_bf16_without_bias(cuda_device):
    """``flash_bwd.cu`` no longer takes bf16 without a bias (its entry
    points return cudaErrorInvalidValue); the new source's take only that."""
    q, k, v, do = flash_inputs((1, 64, 64, 2, 2, 64), torch.bfloat16, cuda_device)
    lse = torch.zeros(2, 64, device=cuda_device)
    out = torch.empty_like(q)
    lib = _build.load()
    common = (1, 2, 2, 64, 64, 64, 0, 1, 0, 0.125)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            lse.data_ptr())
    assert lib.dstt_flash_bwd_dq(*ptrs, out.data_ptr(), *common, 0, None, 0, 0, 0, 0, 0, None,
                                 stream) == 1   # cudaErrorInvalidValue
    assert lib.dstt_flash_bwd_dkv(*ptrs, out.data_ptr(), out.data_ptr(), *common, 0, None, 0, 0,
                                  0, 0, 0, stream) == 1
    assert lib.dstt_flash_bwd_dq_sm90(*ptrs, out.data_ptr(), *common, stream) == 0
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# the bf16 backward's bias mode on TMA + wgmma (ops/csrc/flash_bwd_sm90.cu)
# --------------------------------------------------------------------------- #
def _sm90_bias_backward(q, k, v, do, bias, kw, need_dbias=True):
    """The bias-mode forward, then dQ (with dbias when asked) and dK/dV,
    one launch each and none of the no-bias wrappers': ``(o, lse, (dq, dk,
    dv), dbias)``."""
    o, lse = flash_fwd_bias_cuda(q, k, v, bias, **kw)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    wrappers = (flash_bwd_dq_bias_cuda, flash_bwd_dkv_bias_cuda, flash_bwd_dq_cuda,
                flash_bwd_dkv_cuda)
    before = [f.launches for f in wrappers]
    dq, dbias = flash_bwd_dq_bias_cuda(q, k, v, do, lse, delta, bias, need_dbias=need_dbias,
                                       **kw)
    dk, dv = flash_bwd_dkv_bias_cuda(q, k, v, do, lse, delta, bias, **kw)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [before[0] + 1, before[1] + 1, *before[2:]]
    return o, lse, (dq, dk, dv), dbias


def _sm90_bias_close(device, case, bias, seed, need_dbias=True):
    """Hold the bf16 bias-mode dq, dk, dv (and dbias) on ``case`` = (B, Sq,
    Skv, H, Hkv, D, causal, q_offset) to the plain pieces on the same o and
    lse; returns (grads, dbias, refs)."""
    q, k, v, do = flash_inputs(case, torch.bfloat16, device, seed=seed)
    kw = dict(causal=case[6], q_offset=case[7])
    o, lse, grads, dbias = _sm90_bias_backward(q, k, v, do, bias, kw, need_dbias)
    refs = flash_bwd_torch(q, k, v, o, lse, do, bias=bias, need_dbias=True, **kw)
    for got, ref in zip(grads, refs):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert_flash_close(got, ref, FLASH_TOL[torch.bfloat16])
    if need_dbias:
        assert dbias.shape == refs[3].shape and dbias.dtype == torch.float32
        assert_flash_close(dbias, refs[3], FLASH_TOL[torch.bfloat16])
    else:
        assert dbias is None
    return grads, dbias, refs


def _stored_bias(form, b, h, sq, skv, dtype, device, seed):
    rs = np.random.RandomState(seed)
    shape = BIAS_FORMS[form](b, h, sq, skv)
    return torch.from_numpy(2 * rs.randn(*shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("need_dbias", [True, False])
@pytest.mark.parametrize("form", sorted(BIAS_FORMS))
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,causal,sq,skv", [(32, False, 200, 256), (64, True, 129, 129),
                                             (128, True, 200, 300)])
def test_sm90_bias_backward_strides(cuda_device, d, causal, sq, skv, bias_dtype, form,
                                    need_dbias):
    """The bias read in place through its four strides, any of which may be
    0 (ALiBi's q stride 0 takes dK/dV's per-kv-row path), bf16 or fp32,
    odd and even kv lengths (pairs or single loads), with and without
    dbias; GQA 4 / 2."""
    b, h = 2, 4
    bias = _stored_bias(form, b, h, sq, skv, bias_dtype, cuda_device, seed=d + skv)
    _sm90_bias_close(cuda_device, (b, sq, skv, h, 2, d, causal, skv - sq if causal else 0),
                     bias, seed=d, need_dbias=need_dbias)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal", [(127, 127, True), (129, 129, False), (64, 300, True),
                                           (300, 64, False), (1000, 1000, True),
                                           (37, 4096, True)])
def test_sm90_bias_backward_lengths(cuda_device, d, sq, skv, causal):
    """Ragged tails of both tiles, Sq != Skv (causal as a continued prefill:
    q row 0 at position Skv - Sq), a long kv side; a full fp32 bias and an
    ALiBi one."""
    case = (1, sq, skv, 4, 2, d, causal, max(0, skv - sq) if causal else 0)
    for form in ("full", "alibi"):
        bias = _stored_bias(form, 1, 4, sq, skv, torch.float32, cuda_device, seed=sq + d)
        _sm90_bias_close(cuda_device, case, bias, seed=skv + d)


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_sm90_bias_backward_gqa(cuda_device, g, d):
    """GQA with a bias: each query head reads its own bias slice, and each
    kv head's dK/dV sums its g query heads in registers."""
    for form in ("pair", "alibi"):
        bias = _stored_bias(form, 2, 8, 300, 300, torch.float32, cuda_device, seed=g + d)
        _sm90_bias_close(cuda_device, (2, 300, 300, 8, 8 // g, d, True, 0), bias, seed=g * d)


def test_sm90_bias_dbias_is_zero_above_the_diagonal(cuda_device):
    """Causal: dbias is exact zeros where no key is visible, including the
    kv tiles the dQ kernel's band skips, which it writes itself (no memset):
    the allocator hands dbias a block that held NaN just before."""
    b, h, s = 1, 2, 300
    for d in (32, 128):
        q, k, v, do = flash_inputs((b, s, s, h, h, d), torch.bfloat16, cuda_device, seed=d)
        bias = _stored_bias("full", b, h, s, s, torch.float32, cuda_device, seed=d)
        kw = dict(causal=True)
        o, lse = flash_fwd_bias_cuda(q, k, v, bias, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)
        junk = torch.full((b, h, s, s), float("nan"), device=cuda_device)
        del junk
        _, dbias = flash_bwd_dq_bias_cuda(q, k, v, do, lse, delta, bias, need_dbias=True, **kw)
        torch.cuda.synchronize()
        above = torch.ones(s, s, dtype=torch.bool, device=cuda_device).triu(1)
        assert bool((dbias[:, :, above] == 0).all())
        assert bool(torch.isfinite(dbias).all()) and bool((dbias[:, :, ~above] != 0).any())
        ref = flash_bwd_torch(q, k, v, o, lse, do, bias=bias, need_dbias=True, **kw)[3]
        assert_flash_close(dbias, ref, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [32, 64, 128])
def test_sm90_bias_rows_whose_keys_all_carry_minus_1e30(cuda_device, d):
    """A query row whose every key carries -1e30 (lse = -1e30 + log n, which
    rounds to -1e30): p = 1 on each key, so its grads are n times the
    softmax's, as in the JAX package, and finite; a key masked for every
    row gets p = 0."""
    b, h, sq, skv = 2, 4, 130, 260
    bias = torch.zeros(b, 1, sq, skv, device=cuda_device)
    bias[1, :, 7] = -1e30
    bias[:, :, :, 11] = -1e30
    grads, dbias, refs = _sm90_bias_close(cuda_device, (b, sq, skv, h, 2, d, False, 0), bias,
                                          seed=d)
    for got in (*grads, dbias):
        assert torch.isfinite(got.float()).all()
    others = torch.arange(sq, device=cuda_device) != 7
    assert not dbias[0, :, :, 11].any() and not dbias[1, :, others, 11].any()
    assert bool((dbias[1, :, 7] != 0).any())


def test_sm90_bias_backward_takes_no_query_rows(cuda_device):
    """Sq = 0: dq and dbias are empty, dK/dV zeros."""
    q, k, v, do = flash_inputs((1, 0, 70, 4, 2, 64), torch.bfloat16, cuda_device)
    bias = torch.zeros(4, 1, 70, device=cuda_device)
    lse = torch.zeros(4, 0, device=cuda_device)
    dq, dbias = flash_bwd_dq_bias_cuda(q, k, v, do, lse, lse, bias, need_dbias=True,
                                       causal=False)
    dk, dv = flash_bwd_dkv_bias_cuda(q, k, v, do, lse, lse, bias, causal=False)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dbias.shape == (1, 4, 0, 70)
    assert dk.shape == k.shape and not dk.any() and not dv.any()


SM90_BIAS_FAULTS = [   # (fault, what, grads that must fail: 0 dq, 1 dk, 2 dv, 3 dbias)
    (1, "ring stage read one step late", (0, 1, 3)),
    (2, "last tile of each band dropped", (0, 2, 3)),
    (3, "last query head of each GQA group skipped", (1, 2)),
    (4, "bias read one kv tile off", (0, 1, 3)),
]


@pytest.mark.parametrize("form", ["alibi", "full"])
@pytest.mark.parametrize("fault,what,keys", SM90_BIAS_FAULTS)
def test_sm90_bias_backward_check_fails_a_planted_fault(cuda_device, fault, what, keys, form):
    """The planted faults of ``sm90_planted_fault(.., "bwd")`` reach the
    bias-mode launches and must fail the check the sound kernels pass: at
    BLOOM's ALiBi cut to S 1024 with GQA 32 / 8 (dK/dV's per-kv-row path),
    and with a full fp32 bias at hd 32 (its tile-ahead path)."""
    if form == "alibi":
        case = (1, 1024, 1024, 32, 8, 128, True, 0)
    else:
        case = (2, 256, 256, 8, 4, 32, False, 0)
    b, sq, skv, h = case[:4]
    if form == "alibi":
        bias = _alibi_bias(h, skv, cuda_device)           # [H, 1, S] fp32
    else:
        bias = _stored_bias(form, b, h, sq, skv, torch.float32, cuda_device, seed=fault)
    _, _, refs = _sm90_bias_close(cuda_device, case, bias, seed=fault)
    q, k, v, do = flash_inputs(case, torch.bfloat16, cuda_device, seed=fault)
    with sm90_planted_fault(fault, "bwd"):
        _, _, bad, dbias = _sm90_bias_backward(q, k, v, do, bias, dict(causal=case[6]))
    bad = (*bad, dbias)
    for i in keys:   # a row past its limit, or a value that is not finite
        with pytest.raises(AssertionError, match="row err|isfinite"):
            assert_flash_close(bad[i], refs[i], FLASH_TOL[torch.bfloat16])


def test_old_backward_entry_points_refuse_bf16_with_bias(cuda_device):
    """``flash_bwd.cu`` serves fp32 only: its entry points refuse bf16 with
    a bias too (cudaErrorInvalidValue); ``flash_bwd_sm90.cu``'s bias entry
    points take it."""
    q, k, v, do = flash_inputs((1, 64, 64, 2, 2, 64), torch.bfloat16, cuda_device)
    lse = torch.zeros(2, 64, device=cuda_device)
    bias = torch.zeros(2, 1, 64, device=cuda_device)
    out = torch.empty_like(q)
    dbias = torch.empty(1, 2, 64, 64, device=cuda_device)
    lib = _build.load()
    common = (1, 2, 2, 64, 64, 64, 0, 1, 0, 0.125)
    ba = (bias.data_ptr(), 0, 64, 0, 1, 1)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            lse.data_ptr())
    assert lib.dstt_flash_bwd_dq(*ptrs, out.data_ptr(), *common, 0, *ba, dbias.data_ptr(),
                                 stream) == 1   # cudaErrorInvalidValue
    assert lib.dstt_flash_bwd_dkv(*ptrs, out.data_ptr(), out.data_ptr(), *common, 0, *ba,
                                  stream) == 1
    assert lib.dstt_flash_bwd_dq_bias_sm90(*ptrs, out.data_ptr(), *common, *ba,
                                           dbias.data_ptr(), stream) == 0
    assert lib.dstt_flash_bwd_dkv_bias_sm90(*ptrs, out.data_ptr(), out.data_ptr(), *common,
                                            *ba, stream) == 0
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# int8 paged decode and the spec-verify kernel (ops/csrc/paged_sm90.cu)
# --------------------------------------------------------------------------- #
def _pools(rs, nblocks, nkv, bs, hd, device, ng=0):
    """bf16 pools (ng = 0) or int8 code pools with fp32 scale pools, as
    (k, v, k_scale, v_scale); scales in [0.005, 0.025) keep the scores of
    order 1."""
    shape = (nblocks, nkv, bs, hd)
    if not ng:
        k, v = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device, torch.bfloat16)
                for _ in range(2))
        return k, v, None, None
    k, v = (torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8)).to(device)
            for _ in range(2))
    ks, vs = (torch.from_numpy((0.005 + 0.02 * rs.rand(nblocks, nkv, bs, ng))
                               .astype(np.float32)).to(device) for _ in range(2))
    return k, v, ks, vs


def _rows_case(device, B, t, nh, nkv, hd, bs, nblocks, mb, ng, seed, ctx=None):
    rs = np.random.RandomState(seed)
    kp, vp, ks, vs = _pools(rs, nblocks, nkv, bs, hd, device, ng)
    if ctx is None:
        cap = mb * bs
        edge = [0, bs - 1, bs - t, bs - t + 1, bs, 2 * bs - 1, cap - t]
        ctx = np.array([c for c in edge if 0 <= c <= cap - t][:B], np.int32)
        ctx = np.concatenate([ctx, rs.randint(0, cap - t + 1, B - len(ctx))]).astype(np.int32)
    tables = rs.randint(1, nblocks, (B, mb)).astype(np.int32)
    tables[ctx == 0] = 0            # an inactive slot: trash block only
    q = torch.from_numpy(rs.randn(B, t, nh, hd).astype(np.float32)).to(device, torch.bfloat16)
    return (q, kp, vp, torch.from_numpy(tables).to(device),
            torch.from_numpy(ctx).to(device)), {"k_scale": ks, "v_scale": vs}


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("ng", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 1, 5, "tensor"])
@pytest.mark.parametrize("hd,bs", [(64, 8), (128, 16)])
def test_paged_decode_int8_kernel_matches_plain(cuda_device, g, ng, window, hd, bs):
    args, sc = _rows_case(cuda_device, 7, 1, 8, 8 // g, hd, bs, 24, 5, ng, seed=g + ng + hd)
    q = args[0][:, 0]
    if window == "tensor":
        window = torch.tensor(9, dtype=torch.int32, device=cuda_device)
    before = (paged_decode_attention_int8_cuda.launches, paged_decode_attention_cuda.launches)
    got = get_op("paged_decode_attention", cuda_device)(q, *args[1:], window=window, **sc)
    torch.cuda.synchronize()
    assert (paged_decode_attention_int8_cuda.launches,
            paged_decode_attention_cuda.launches) == (before[0] + 1, before[1])
    ref = paged_decode_attention_torch(q, *args[1:], window=window, **sc)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_rows_close(got, ref)


@pytest.mark.parametrize("g,t", [(1, 1), (1, 9), (2, 5), (4, 5), (8, 2), (8, 9), (4, 3)])
@pytest.mark.parametrize("ng", [0, 1, 2, 4])
@pytest.mark.parametrize("window", [None, 1, 7, "tensor"])
@pytest.mark.parametrize("hd,bs", [(64, 8), (128, 16)])
def test_paged_verify_kernel_matches_plain(cuda_device, g, t, ng, window, hd, bs):
    """Rows g-major, t-minor; contexts where ctx + t - 1 crosses a block
    edge, a ctx 0 slot on the trash block, the table's last position."""
    args, sc = _rows_case(cuda_device, 8, t, 8, 8 // g, hd, bs, 24, 5, ng, seed=g * t + ng + hd)
    if window == "tensor":
        window = torch.tensor(11, dtype=torch.int32, device=cuda_device)
    before = paged_spec_verify_attention_cuda.launches
    got = get_op("paged_spec_verify_attention", cuda_device)(*args, window=window, **sc)
    torch.cuda.synchronize()
    assert paged_spec_verify_attention_cuda.launches == before + 1
    ref = paged_spec_verify_attention_torch(*args, window=window, **sc)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert_rows_close(got, ref)


def test_paged_verify_t1_is_decode(cuda_device):
    """At t = 1 the verify kernel computes the decode kernel's function."""
    for ng in (0, 1):
        args, sc = _rows_case(cuda_device, 6, 1, 32, 8, 128, 16, 30, 6, ng, seed=ng)
        got = paged_spec_verify_attention_cuda(*args, **sc)[:, 0]
        ref = paged_decode_attention_torch(args[0][:, 0], *args[1:], **sc)
        assert_rows_close(got, ref)


def test_paged_rows_kernels_take_an_empty_batch(cuda_device):
    args, sc = _rows_case(cuda_device, 4, 5, 8, 2, 64, 8, 12, 4, 1, seed=1)
    empty = [a[:0] for a in (args[0], args[3], args[4])]
    before = (paged_spec_verify_attention_cuda.launches, paged_decode_attention_int8_cuda.launches)
    out = paged_spec_verify_attention_cuda(empty[0], args[1], args[2], empty[1], empty[2], **sc)
    assert out.shape == (0, 5, 8, 64)
    out = paged_decode_attention_int8_cuda(empty[0][:, 0], args[1], args[2], empty[1], empty[2],
                                           **sc)
    assert out.shape == (0, 8, 64)
    assert (paged_spec_verify_attention_cuda.launches,
            paged_decode_attention_int8_cuda.launches) == before


@pytest.mark.parametrize("ng", [0, 1, 4])
@pytest.mark.parametrize("window", [None, 1000])
def test_paged_rows_kernels_at_llama_shapes(cuda_device, ng, window):
    """The chip smoke's shapes: 64 slots, 32/8 heads, hd 128, 512 blocks of
    128, contexts up to the table's end; int8 decode (t = 1) and verify
    (t = 5). One wrong block's scales (or table entry) on the longest row
    must fail the same check."""
    for t in (1, 5):
        if t == 1 and not ng:
            continue                  # the bf16 decode kernel has its own tests above
        args, sc = _rows_case(cuda_device, 64, t, 32, 8, 128, 128, 512, 64, ng, seed=t + ng)
        q, kp, vp, tables, ctx = args
        if t == 1:
            got = paged_decode_attention_cuda(q[:, 0], kp, vp, tables, ctx, window=window, **sc)
            ref = paged_decode_attention_torch(q[:, 0], kp, vp, tables, ctx, window=window, **sc)
        else:
            got = paged_spec_verify_attention_cuda(*args, window=window, **sc)
            ref = paged_spec_verify_attention_torch(*args, window=window, **sc)
        assert_rows_close(got, ref)
        row = int(ctx.argmax())
        blk = int(tables[row, 32])
        if ng:
            bad = {k: v.clone() for k, v in sc.items()}
            for k in bad:
                bad[k][blk] = sc[k][blk % 511 + 1]
            kw = bad
            bad_args = args
        else:
            bad_tables = tables.clone()
            bad_tables[row, 32] = blk % 511 + 1
            kw, bad_args = sc, (q, kp, vp, bad_tables, ctx)
        if t == 1:
            got = paged_decode_attention_cuda(q[:, 0], *bad_args[1:], **kw)
            ref = paged_decode_attention_torch(q[:, 0], kp, vp, tables, ctx, **sc)
        else:
            got = paged_spec_verify_attention_cuda(*bad_args, **kw)
            ref = paged_spec_verify_attention_torch(*args, **sc)
        with pytest.raises(AssertionError, match="row err"):
            assert_rows_close(got[row:row + 1], ref[row:row + 1])


def test_paged_rows_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    args, sc = _rows_case(cuda_device, 3, 5, 8, 2, 64, 8, 12, 4, 1, seed=2)
    q, kp, vp, tables, ctx = args
    with pytest.raises(ValueError, match="together"):
        paged_spec_verify_attention_cuda(*args, k_scale=sc["k_scale"])
    with pytest.raises(ValueError, match="together"):
        paged_decode_attention_cuda(q[:, 0], kp, vp, tables, ctx, v_scale=sc["v_scale"])
    with pytest.raises(ValueError, match="int8"):            # int8 pools need scales
        paged_spec_verify_attention_cuda(*args)
    with pytest.raises(ValueError, match="fp32"):
        paged_spec_verify_attention_cuda(*args, k_scale=sc["k_scale"].half(),
                                         v_scale=sc["v_scale"].half())
    with pytest.raises(ValueError, match="int32"):
        paged_spec_verify_attention_cuda(q, kp, vp, tables.long(), ctx, **sc)
    with pytest.raises(ValueError, match="bf16"):
        paged_spec_verify_attention_cuda(q.float(), kp, vp, tables, ctx, **sc)
    with pytest.raises(ValueError, match=r"\[B, t, nh, hd\]"):
        paged_spec_verify_attention_cuda(q[:, 0], kp, vp, tables, ctx, **sc)
    with pytest.raises(ValueError, match="16 lanes"):        # groups of 8 lanes
        ks8 = torch.ones(*kp.shape[:3], 8, device=cuda_device)
        paged_spec_verify_attention_cuda(*args, k_scale=ks8, v_scale=ks8)
    with pytest.raises(ValueError, match=">= 1"):
        paged_spec_verify_attention_cuda(*args, window=0, **sc)
    with pytest.raises(ValueError, match="head dim 96"):
        q96 = torch.zeros(1, 5, 8, 96, device=cuda_device, dtype=torch.bfloat16)
        kp96 = torch.zeros(4, 2, 8, 96, device=cuda_device, dtype=torch.bfloat16)
        paged_spec_verify_attention_cuda(q96, kp96, kp96, tables[:1], ctx[:1])
    # 256 rows of hd 256 over one kv head: shared memory does not grow with
    # the rows, so the kernel takes it
    rs = np.random.RandomState(3)
    q256 = torch.from_numpy(rs.randn(1, 16, 16, 256).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    kp256, vp256 = (torch.from_numpy(rs.randn(4, 1, 8, 256).astype(np.float32)).to(
        cuda_device, torch.bfloat16) for _ in range(2))
    t256 = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32, device=cuda_device)
    c256 = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    assert_rows_close(paged_spec_verify_attention_cuda(q256, kp256, vp256, t256, c256),
                      paged_spec_verify_attention_torch(q256, kp256, vp256, t256, c256))
    with pytest.raises(ValueError, match="CUDA"):
        paged_spec_verify_attention_cuda(*(a.cpu() for a in args))


def _paged_call(args, sc, t, window=None):
    """(kernel, plain) over ``args`` from ``_rows_case``: decode at t = 1."""
    q, kp, vp, tables, ctx = args
    if t == 1:
        return (paged_decode_attention_cuda(q[:, 0], kp, vp, tables, ctx, window=window, **sc),
                paged_decode_attention_torch(q[:, 0], kp, vp, tables, ctx, window=window, **sc))
    return (paged_spec_verify_attention_cuda(*args, window=window, **sc),
            paged_spec_verify_attention_torch(*args, window=window, **sc))


# live lengths (ctx + t) around the kernel's split boundaries: 64 is one
# split of 4 subtiles, 65 two; 512 is 8 splits of 64 positions, 513 seven
# of 80; 4096 is 8 of 512, 4097 nine (split_positions, splits_of)
SPLIT_EDGES = [17, 63, 64, 65, 511, 512, 513, 4095, 4096, 4097]


def _split_edge_ctx(t, cap):
    """Contexts whose live positions end one before a split boundary, on it
    and one after; within one split; 0 on the trash block; the table's last
    position."""
    return np.array([0] + [e - t for e in SPLIT_EDGES + [cap]], np.int32)


@pytest.mark.parametrize("ng", [0, 1, 4])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("window", [None, 509, "tensor"])
def test_paged_kernel_at_split_edges(cuda_device, ng, t, window):
    """paged_sm90.cu cuts each sequence's live positions into splits and
    merges them: contexts around split boundaries, one split, the table's
    end, with and without a window."""
    mb, bs = 260, 16
    ctx = _split_edge_ctx(t, mb * bs)
    args, sc = _rows_case(cuda_device, len(ctx), t, 8, 2, 128, bs, 300, mb, ng,
                          seed=7 * t + ng, ctx=ctx)
    if window == "tensor":
        window = torch.tensor(4095, dtype=torch.int32, device=cuda_device)
    got, ref = _paged_call(args, sc, t, window)
    torch.cuda.synchronize()
    assert_rows_close(got, ref)


@pytest.mark.parametrize("ng", [0, 1])
@pytest.mark.parametrize("t", [1, 5])
def test_paged_kernel_at_falcon_shapes(cuda_device, ng, t):
    """Falcon-7B: 71 query heads over one kv head at hd 64 (decode: 71 rows;
    verify at t = 5: 355 rows), which the earlier kernels refused."""
    mb, bs = 12, 64
    ctx = np.array([0, 5, 63, 64, 300, 513 - t, mb * bs - t], np.int32)
    args, sc = _rows_case(cuda_device, len(ctx), t, 71, 1, 64, bs, 40, mb, ng,
                          seed=71 + t + ng, ctx=ctx)
    got, ref = _paged_call(args, sc, t)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert_rows_close(got, ref)


@pytest.mark.parametrize("ng", [0, 1, 4])
@pytest.mark.parametrize("t", [1, 5])
def test_paged_kernel_is_deterministic(cuda_device, ng, t):
    """Two calls on the same inputs give identical bits: the splits merge in
    split order, with no atomics on values."""
    mb, bs = 40, 16
    args, sc = _rows_case(cuda_device, 16, t, 32, 8, 128, bs, 64, mb, ng, seed=11 + ng)
    first = _paged_call(args, sc, t)[0].clone()
    for _ in range(3):
        again = _paged_call(args, sc, t)[0]
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.parametrize("fault,what,ng", [
    (1, "the merge drops the last split", 0),
    (1, "the merge drops the last split", 1),
    (2, "a ring stage read before its copy lands", 0),
    (2, "a ring stage read before its copy lands", 4),
    (3, "the K scale left out at ng = 1", 1)])
@pytest.mark.parametrize("t", [1, 5])
def test_paged_check_fails_a_planted_fault(cuda_device, fault, what, ng, t):
    """The planted faults of ``paged_planted_fault`` must fail the check the
    sound kernel passes, on rows of more than one split."""
    mb, bs = 40, 16
    ctx = np.array([70, 300, 513, mb * bs - t], np.int32)
    args, sc = _rows_case(cuda_device, len(ctx), t, 32, 8, 128, bs, 64, mb, ng,
                          seed=fault + ng, ctx=ctx)
    got, ref = _paged_call(args, sc, t)
    assert_rows_close(got, ref)
    with paged_planted_fault(fault):
        bad = _paged_call(args, sc, t)[0]
        torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        assert_rows_close(bad, ref)
    # and the counters left by the faulty launches do not disturb the next
    assert_rows_close(_paged_call(args, sc, t)[0], ref)


# --------------------------------------------------------------------------- #
# LayerNorm (ops/csrc/layer_norm.cu)
# --------------------------------------------------------------------------- #
def _ln_inputs(rows, d, dtype, device, mean=0.0):
    rs = np.random.RandomState(rows + d)
    x = torch.from_numpy(rs.randn(rows, d).astype(np.float32) * 3 + mean).to(device, dtype)
    w = torch.from_numpy(1 + 0.1 * rs.randn(d).astype(np.float32)).to(device, dtype)
    b = torch.from_numpy(0.2 * rs.randn(d).astype(np.float32)).to(device, dtype)
    return x, w, b


@pytest.mark.parametrize("rows", [0, 1, 7, 4096])
@pytest.mark.parametrize("d", [64, 768, 2048, 4096, 100, 20000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_kernel_matches_plain(cuda_device, rows, d, dtype, with_bias):
    """The warp kernel (1 and 7 rows at d 64 .. 2048, fp32 to 1024), the
    block kernel (4096 rows; d 4096 at any rows), the scalar kernel (d 100,
    and d 20000, too wide for 8 vectors a thread); zero rows launch
    nothing."""
    if rows == 4096 and d == 20000:
        rows = 64
    x, w, b = _ln_inputs(rows, d, dtype, cuda_device)
    b = b if with_bias else None
    before = layer_norm_cuda.launches
    got = layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert layer_norm_cuda.launches == before + (rows > 0)
    assert got.dtype == dtype and got.shape == x.shape
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), layer_norm_torch(x, w, b, 1e-5).float(),
                               rtol=tol, atol=tol)


def test_layer_norm_kernel_large_mean(cuda_device):
    """Rows of mean 100: the centred variance keeps the digits that
    E[x^2] - mean^2 would cancel (fp32 in, 1e-4)."""
    x, w, b = _ln_inputs(33, 2048, torch.float32, cuda_device, mean=100.0)
    got = layer_norm_cuda(x, w, b, 1e-5)
    ref = layer_norm_torch(x.double(), w.double(), b.double(), 1e-5)
    torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=1e-4)


def test_layer_norm_kernel_leading_dims_and_views(cuda_device):
    x, w, b = _ln_inputs(24, 768, torch.bfloat16, cuda_device)
    got = layer_norm(x.view(2, 3, 4, 768), w, b, 1e-5)
    assert got.shape == (2, 3, 4, 768)
    torch.testing.assert_close(got.view(24, 768).float(),
                               layer_norm_torch(x, w, b, 1e-5).float(), rtol=1e-2, atol=1e-2)
    wide = torch.cat([x, x], dim=-1)[:, :768]          # a non-contiguous view
    torch.testing.assert_close(layer_norm(wide, w, b, 1e-5).float(),
                               layer_norm_torch(x, w, b, 1e-5).float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_kernel_backward(cuda_device, dtype, with_bias):
    x, w, b = _ln_inputs(33, 768, dtype, cuda_device)
    dy = torch.randn(33, 768, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1)).to(dtype)
    leaves = [t.clone().requires_grad_() for t in ((x, w, b) if with_bias else (x, w))]
    layer_norm(leaves[0], leaves[1], leaves[2] if with_bias else None, 1e-5).backward(dy)
    want = layer_norm_bwd(x, w, dy, 1e-5)
    tol = RMS_TOL[dtype] if dtype == torch.float32 else 2e-2
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == leaf.shape
        torch.testing.assert_close(leaf.grad.float(), ref.float(), rtol=tol, atol=tol)


def test_layer_norm_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, w, b = _ln_inputs(4, 768, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="same dtype"):
        layer_norm_cuda(x, w.float(), b)
    with pytest.raises(ValueError, match="same dtype"):
        layer_norm_cuda(x, w, b.float())
    with pytest.raises(ValueError, match="same dtype"):
        layer_norm_cuda(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="shape"):
        layer_norm_cuda(x, w[:100], b)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x, w.cpu(), b)
    with pytest.raises(ValueError, match="aligned"):
        layer_norm_cuda(x, torch.cat([w, w])[1:769], b)


@pytest.mark.parametrize("d,dtype", [(2048, torch.bfloat16), (256, torch.bfloat16),
                                     (768, torch.bfloat16), (1024, torch.float32),
                                     (2048, torch.float16)])
def test_layer_norm_check_fails_a_planted_fault(cuda_device, d, dtype):
    """Lane 31's share of the centred sum of squares left out (the warp
    kernel at 64 rows: one warp a row at d 256, eight at d 2048) must fail
    the check that the sound kernel passes, on the same inputs."""
    x, w, b = _ln_inputs(64, d, dtype, cuda_device)
    ref = layer_norm_torch(x, w, b, 1e-5).float()
    tol = RMS_TOL[dtype] if dtype != torch.float32 else 1e-4
    torch.testing.assert_close(layer_norm_cuda(x, w, b, 1e-5).float(), ref, rtol=tol, atol=tol)
    with layer_norm_planted_fault(1):
        bad = layer_norm_cuda(x, w, b, 1e-5)
        torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad.float(), ref, rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# int8 quantize / dequantize (ops/csrc/quantize.cu)
# --------------------------------------------------------------------------- #
def _quant_input(shape, dtype, device, group_size, seed=0):
    """Rows of three magnitudes; row 0 all zero; the last group holds 127
    and exact .5 values over zeros, so its scale is 1 and they are ties."""
    rs = np.random.RandomState(seed)
    row_scale = rs.choice([1e-3, 1.0, 50.0], size=(shape[0],) + (1,) * (len(shape) - 1))
    x = (rs.randn(*shape) * row_scale).astype(np.float32)
    x[0] = 0                                        # all-zero groups
    flat = x.reshape(-1)
    flat[-group_size:] = 0
    flat[-8:] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]   # ties where amax = 127
    return torch.from_numpy(x).to(device, dtype)


# group sizes that reach each shape of quantize.cu's kernels: the vector
# quantize kernel at segments narrower than a warp (16-256: 1-16 lanes), of
# one warp of 1, 2 and 4 chunks a lane (512, 1024, 2048) and over 2 and 4
# warps (4096, 8192: one exchange through shared memory); the warp kernel
# (24 is a multiple of the fp32 vector only, 100 of neither); dequantize's
# vector kernel by shift (powers of two), by division (24 at fp32) and its
# scalar kernel (24 at bf16 / fp16, 100)
QUANT_GROUPS = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 24, 100]
QUANT_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("group_size", QUANT_GROUPS)
@pytest.mark.parametrize("dtype", QUANT_DTYPES)
def test_quantize_kernel_equals_plain(cuda_device, group_size, dtype):
    """Codes and scales equal the plain version's bit for bit: vector
    kernel (16 .. 8192), warp kernel (24, 100)."""
    rows = 48
    x = _quant_input((rows, group_size * 6), dtype, cuda_device, group_size, seed=group_size)
    before = quantize_int8_cuda.launches
    q, s = get_op("quantize_int8", cuda_device)(x, group_size)
    torch.cuda.synchronize()
    assert quantize_int8_cuda.launches == before + 1
    q_ref, s_ref = quantize_int8_torch(x, group_size)
    assert q.dtype == torch.int8 and q.shape == x.shape and s.shape == (rows * 6,)
    assert torch.equal(s, s_ref)
    assert torch.equal(q, q_ref)
    assert float(s[0]) == 1.0 and not q[0].any()
    assert q.view(-1)[-8:].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("group_size", QUANT_GROUPS)
@pytest.mark.parametrize("out", QUANT_DTYPES)
def test_dequantize_kernel_equals_plain(cuda_device, group_size, out):
    rs = np.random.RandomState(group_size)
    q = torch.from_numpy(rs.randint(-127, 128, (40, group_size * 5)).astype(np.int8)).to(cuda_device)
    s = torch.from_numpy((rs.rand(200) * 0.05).astype(np.float32)).to(cuda_device)
    before = dequantize_int8_cuda.launches
    got = get_op("dequantize_int8", cuda_device)(q, s, group_size, out)
    torch.cuda.synchronize()
    assert dequantize_int8_cuda.launches == before + 1
    assert got.dtype == out and got.shape == q.shape
    assert torch.equal(got, dequantize_int8_torch(q, s, group_size, out))


@pytest.mark.parametrize("group_size", [16, 128, 512, 2048, 8192, 100])
def test_quantize_exact_product_at_ties_and_boundaries(cuda_device, group_size):
    """The vector kernel's division (the product by the reciprocal,
    corrected twice by its residual) at exact ties, at quotients where the
    uncorrected product rounds the other way and where it is not faithful
    (``chip_smoke.division_boundary_groups``, fp32): codes equal the plain
    version's; the uncorrected product (planted fault 1) must break the
    equality."""
    x = torch.from_numpy(smoke.division_boundary_groups(64, group_size, seed=group_size)
                         ).to(cuda_device)
    q_ref, s_ref = quantize_int8_torch(x, group_size)
    q, s = quantize_int8_cuda(x, group_size)
    torch.cuda.synchronize()
    assert torch.equal(s, s_ref) and torch.equal(q, q_ref)
    with quantize_planted_fault(1):
        bad, _ = quantize_int8_cuda(x, group_size)
        torch.cuda.synchronize()
    assert int((bad != q_ref).sum()) > 0


@pytest.mark.parametrize("group_size", [16, 128, 2048, 8192, 100])
@pytest.mark.parametrize("dtype", QUANT_DTYPES)
def test_quantize_check_fails_a_lane_left_out_of_the_max(cuda_device, group_size, dtype):
    """Planted fault 2 (one lane of each segment, each warp in the warp
    kernel, left out of the group's max) must break the equality that the
    sound kernel keeps on the same inputs."""
    x = _quant_input((48, group_size * 6), dtype, cuda_device, group_size, seed=group_size + 1)
    q_ref, s_ref = quantize_int8_torch(x, group_size)
    q, s = quantize_int8_cuda(x, group_size)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    with quantize_planted_fault(2):
        bad_q, bad_s = quantize_int8_cuda(x, group_size)
        torch.cuda.synchronize()
    assert int((bad_s != s_ref).sum()) > 0 and int((bad_q != q_ref).sum()) > 0


@pytest.mark.parametrize("group_size", [16, 128, 2048, 24, 100])
@pytest.mark.parametrize("out", QUANT_DTYPES)
def test_dequantize_check_fails_the_previous_groups_scale(cuda_device, group_size, out):
    """Planted fault 3 (each group's first vector scaled by the previous
    group's scale) must break the equality, on both dequantize kernels."""
    rs = np.random.RandomState(group_size + 2)
    q = torch.from_numpy(rs.randint(-127, 128, (40, group_size * 5)).astype(np.int8)).to(cuda_device)
    s = torch.from_numpy((rs.rand(200) * 0.05 + 0.01).astype(np.float32)).to(cuda_device)
    ref = dequantize_int8_torch(q, s, group_size, out)
    assert torch.equal(dequantize_int8_cuda(q, s, group_size, out), ref)
    with quantize_planted_fault(3):
        bad = dequantize_int8_cuda(q, s, group_size, out)
        torch.cuda.synchronize()
    assert int((bad != ref).sum()) > 0


@pytest.mark.parametrize("dtype", QUANT_DTYPES)
def test_quantize_kernels_at_opt_shapes(cuda_device, dtype):
    """OPT-1.3B's w_up [2048, 8192] at groups 2048 and 128, and any shape
    (3-d, empty): equality throughout, and the round trip within half a
    code step."""
    x = _quant_input((2048, 8192), dtype, cuda_device, 2048, seed=3)
    for gs in (2048, 128):
        q, s = quantize_int8_cuda(x, gs)
        q_ref, s_ref = quantize_int8_torch(x, gs)
        assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
        for out in QUANT_DTYPES:
            assert torch.equal(dequantize_int8_cuda(q, s, gs, out),
                               dequantize_int8_torch(q, s, gs, out))
        back = dequantize_int8_cuda(q, s, gs)
        step = s.repeat_interleave(gs).view(x.shape)
        assert float(((back - x.float()).abs() / step).max()) <= 0.5 + 1e-4
    x3 = x[:6].reshape(3, 2, 8192)
    q, s = quantize_int8_cuda(x3, 512)
    assert q.shape == x3.shape and torch.equal(q, quantize_int8_torch(x3, 512)[0])
    before = (quantize_int8_cuda.launches, dequantize_int8_cuda.launches)
    q0, s0 = quantize_int8_cuda(x[:0], 128)
    assert q0.shape == (0, 8192) and s0.shape == (0,)
    assert dequantize_int8_cuda(q0, s0, 128).shape == (0, 8192)
    # an empty input launches nothing
    assert (quantize_int8_cuda.launches, dequantize_int8_cuda.launches) == before


@pytest.mark.parametrize("group_size", [128, 2048])
def test_quantize_kernels_at_llama_shape(cuda_device, group_size):
    """Llama-3-8B's MLP weight [4096, 14336] in bf16: codes, scales and the
    bf16 and fp32 values equal the plain versions'."""
    x = _quant_input((4096, 14336), torch.bfloat16, cuda_device, group_size, seed=8)
    q, s = quantize_int8_cuda(x, group_size)
    q_ref, s_ref = quantize_int8_torch(x, group_size)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    del x, q_ref
    for out in (torch.bfloat16, torch.float32):
        assert torch.equal(dequantize_int8_cuda(q, s, group_size, out),
                           dequantize_int8_torch(q, s, group_size, out))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_quantize_every_pair_of_a_16_bit_dtype(cuda_device, dtype):
    """Every (amax, x) pair of bf16 and of fp16 (``chip_smoke.
    every_pair_groups``, groups of 2048): the FMA division's codes and the
    scales equal the plain version's over the whole input domain, and the
    uncorrected product (planted fault 1) changes some."""
    n_fault = 0
    for x in smoke.every_pair_groups(dtype, 2048, cuda_device):
        q_ref, s_ref = quantize_int8_torch(x, 2048)
        q, s = quantize_int8_cuda(x, 2048)
        assert torch.equal(s, s_ref) and torch.equal(q, q_ref)
        with quantize_planted_fault(1):
            n_fault += int((quantize_int8_cuda(x, 2048)[0] != q_ref).sum())
    assert n_fault > 0


@pytest.mark.parametrize("group_size", [16, 24, 64, 100, 128, 512, 1024, 2048, 4096, 8192,
                                        16384, 32768])
@pytest.mark.parametrize("dtype", QUANT_DTYPES)
def test_quantize_kernel_writes_every_code_and_scale(cuda_device, group_size, dtype):
    """The C entry over buffers filled with what it never writes (code
    -128, NaN scales), at group sizes of every plan (segments of 1 to 256
    lanes of 1 to 4 chunks; the warp kernel at 24, 100 and 32768) and a
    group count that leaves the last block part empty: every code and scale
    is written, and equals the plain version's."""
    n_groups = 37
    x = _quant_input((n_groups, group_size), dtype, cuda_device, group_size, seed=group_size)
    q = torch.full(x.shape, -128, dtype=torch.int8, device=cuda_device)
    s = torch.full((n_groups,), float("nan"), device=cuda_device)
    code = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}[dtype]
    assert _build.load().dstt_quantize_int8(x.data_ptr(), q.data_ptr(), s.data_ptr(), n_groups,
                                            group_size, code,
                                            torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    q_ref, s_ref = quantize_int8_torch(x, group_size)
    assert int((q == -128).sum()) == 0 and not bool(s.isnan().any())
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


def test_quantize_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(4, 256, device=cuda_device)
    q, s = quantize_int8_cuda(x, 128)
    with pytest.raises(ValueError, match="does not divide"):
        quantize_int8_cuda(x, 100)
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        quantize_int8_cuda(x.double(), 128)
    with pytest.raises(ValueError, match="aligned"):
        quantize_int8_cuda(torch.zeros(1025, device=cuda_device)[1:], 128)
    with pytest.raises(ValueError, match="int8 codes"):
        dequantize_int8_cuda(x, s, 128)
    with pytest.raises(ValueError, match="int8 codes"):
        dequantize_int8_cuda(q, s.double(), 128)
    with pytest.raises(ValueError, match="scales shape"):
        dequantize_int8_cuda(q, s[:4], 128)
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        dequantize_int8_cuda(q, s, 128, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_int8_cuda(q, s.cpu(), 128)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8_cuda(x.cpu(), 128)


# --------------------------------------------------------------------------- #
# the OPT-1.3B shapes of the paged and flash kernels (MHA: g = 1, hd 64)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ng", [0, 1, 4])
@pytest.mark.parametrize("t", [1, 5])
def test_paged_kernels_at_opt_shapes(cuda_device, ng, t):
    """64 slots, 32 heads = 32 kv heads of 64, 512 blocks of 128, tables of
    16 blocks (2048 positions): bf16 decode, int8 decode and verify."""
    args, sc = _rows_case(cuda_device, 64, t, 32, 32, 64, 128, 512, 16, ng, seed=t + ng)
    q, kp, vp, tables, ctx = args
    if t == 1:
        got = get_op("paged_decode_attention", cuda_device)(q[:, 0], kp, vp, tables, ctx, **sc)
        ref = paged_decode_attention_torch(q[:, 0], kp, vp, tables, ctx, **sc)
    else:
        got = paged_spec_verify_attention_cuda(*args, **sc)
        ref = paged_spec_verify_attention_torch(*args, **sc)
    torch.cuda.synchronize()
    assert_rows_close(got, ref)


@pytest.mark.parametrize("b", [1, 4])
def test_flash_kernels_match_plain_at_opt_shapes(cuda_device, b):
    q, k, v, do = flash_inputs((b, 2048, 2048, 32, 32, 64), torch.bfloat16, cuda_device, seed=b)
    o, lse = flash_fwd_cuda(q, k, v, causal=True)
    assert_flash_close(o, flash_fwd_torch(q, k, v, causal=True)[0], FLASH_TOL[torch.bfloat16])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * 32, 2048)
    got = (flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=True),
           *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=True))
    for g, ref in zip(got, flash_bwd_torch(q, k, v, o, lse, do, causal=True)):
        assert_flash_close(g, ref, FLASH_TOL[torch.bfloat16])



# --------------------------------------------------------------------------- #
# the flash kernels' bias mode (ALiBi, evoformer)
# --------------------------------------------------------------------------- #
def _bias(kind, b, h, sq, skv, dtype, device, seed=0):
    """A bias of the given broadcast kind, as stored (it is expanded to
    [B, H, Sq, Skv] by strides only)."""
    g = torch.Generator().manual_seed(seed)
    shape = {"alibi": (h, 1, skv), "pair": (1, h, sq, skv), "full": (b, h, sq, skv),
             "row": (b, 1, 1, skv)}[kind]
    return (torch.randn(shape, generator=g) * 2).to(device, dtype)


def _bias_pieces(q, k, v, do, bias, kw, need_dbias):
    o, lse = flash_fwd_bias_cuda(q, k, v, bias, **kw)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    dq, dbias = flash_bwd_dq_bias_cuda(q, k, v, do, lse, delta, bias,
                                       need_dbias=need_dbias, **kw)
    dk, dv = flash_bwd_dkv_bias_cuda(q, k, v, do, lse, delta, bias, **kw)
    torch.cuda.synchronize()
    return o, lse, dq, dk, dv, dbias


# (B, Sq, Skv, H, Hkv, D, causal, bias kind)
BIAS_CASES = [
    (2, 128, 128, 4, 4, 128, True, "alibi"),     # BLOOM: [H, 1, S], strides (0, S, 0, 1)
    (1, 100, 100, 8, 2, 64, True, "full"),       # tails, GQA
    (3, 64, 64, 4, 4, 32, False, "pair"),        # evoformer: pair bias shared by the batch
    (2, 70, 130, 2, 1, 32, False, "row"),        # mask-like [B, 1, 1, Skv]
    (1, 37, 200, 4, 4, 64, False, "full"),
]


@pytest.mark.parametrize("need_dbias", [True, False])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BIAS_CASES)
def test_flash_bias_kernels_match_plain(cuda_device, case, dtype, bias_dtype, need_dbias):
    B, sq, skv, h, hkv, d, causal, kind = case
    q, k, v, do = flash_inputs(case, dtype, cuda_device, seed=11)
    bias = _bias(kind, B, h, sq, skv, bias_dtype, cuda_device)
    kw = dict(causal=causal)
    counts = [f.launches for f in (flash_fwd_bias_cuda, flash_bwd_dq_bias_cuda,
                                   flash_bwd_dkv_bias_cuda, flash_fwd_cuda)]
    o, lse, dq, dk, dv, dbias = _bias_pieces(q, k, v, do, bias, kw, need_dbias)
    assert [f.launches for f in (flash_fwd_bias_cuda, flash_bwd_dq_bias_cuda,
                                 flash_bwd_dkv_bias_cuda, flash_fwd_cuda)] == \
        [c + 1 for c in counts[:3]] + counts[3:]
    o_ref, lse_ref = flash_fwd_torch(q, k, v, bias=bias, **kw)
    assert_flash_close(o, o_ref, FLASH_TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    refs = flash_bwd_torch(q, k, v, o, lse, do, bias=bias, need_dbias=True, **kw)
    for got, ref in zip((dq, dk, dv), refs):
        assert got.shape == ref.shape and got.dtype == dtype
        assert_flash_close(got, ref, FLASH_TOL[dtype])
    if need_dbias:
        assert dbias.shape == (B, h, sq, skv) and dbias.dtype == torch.float32
        assert_flash_close(dbias, refs[3], FLASH_TOL[dtype])
    else:
        assert dbias is None


def test_flash_bias_dbias_is_zero_above_the_diagonal(cuda_device):
    """Causal: dbias is written as exact zeros where no key is visible,
    including the kv tiles the dQ kernel's band skips (S 300: five 64-row
    tiles)."""
    q, k, v, do = flash_inputs((1, 300, 300, 2, 2, 64), torch.bfloat16, cuda_device, seed=2)
    bias = _bias("full", 1, 2, 300, 300, torch.float32, cuda_device)
    *_, dbias = _bias_pieces(q, k, v, do, bias, dict(causal=True), True)
    above = torch.ones(300, 300, dtype=torch.bool, device=cuda_device).triu(1)
    assert bool((dbias[:, :, above] == 0).all())
    assert bool((dbias[:, :, ~above] != 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bias_fully_masked_row_averages_uniformly(cuda_device, dtype):
    """A query row whose every key carries the -1e30 mask bias (evoformer's
    wholly masked residue) averages v uniformly, as the JAX package's
    kernel does (m stays -1e30, p = 1); the backward stays finite."""
    q, k, v, do = flash_inputs((1, 64, 64, 4, 4, 32), dtype, cuda_device, seed=4)
    bias = torch.zeros(1, 4, 64, 64, device=cuda_device)
    bias[:, :, 5] = -1e30              # query row 5: every key masked
    bias[:, :, :, 7] = -1e30           # key 7 masked for every row
    o, lse, dq, dk, dv, dbias = _bias_pieces(q, k, v, do, bias, dict(causal=False), True)
    uniform = v.float().mean(1)[0]     # [H, D]
    torch.testing.assert_close(o[0, 5].float(), uniform, rtol=2e-2, atol=2e-2)
    o_ref, _ = flash_fwd_torch(q, k, v, bias=bias, causal=False)
    assert_flash_close(o, o_ref, FLASH_TOL[dtype])
    refs = flash_bwd_torch(q, k, v, o, lse, do, bias=bias, causal=False, need_dbias=True)
    for got, ref in zip((dq, dk, dv, dbias), refs):
        assert torch.isfinite(got.float()).all()
        assert_flash_close(got, ref, FLASH_TOL[dtype])


def test_flash_bias_op_autograd_reduces_dbias(cuda_device):
    """Op ``attention`` with a bias is :class:`FlashAttentionBias`: its
    output and grads (the bias's reduced to its broadcast shape and dtype)
    are plain attention's under autograd, in fp32, where both sides compute
    the same function to FMA rounding (the bf16 kernels are held against
    their plain pieces above); a bias that needs no grad gets no dbias
    written."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, D = 2, 96, 4, 64
    q0, k0, v0, do = flash_inputs((B, S, S, H, H, D), torch.float32, cuda_device, seed=6)
    b0 = _bias("pair", B, H, S, S, torch.float32, cuda_device)
    grads = []
    for fn in (attention, attention_torch):
        q, k, v = (t.detach().clone().requires_grad_() for t in (q0, k0, v0))
        bias = b0.detach().clone().requires_grad_()
        before = flash_fwd_bias_cuda.launches
        o = fn(q, k, v, causal=True, bias=bias)
        assert flash_fwd_bias_cuda.launches == before + (fn is attention)
        (o * do).sum().backward()
        grads.append((o.detach(), q.grad, k.grad, v.grad, bias.grad))
    assert grads[0][4].shape == b0.shape and grads[0][4].dtype == torch.float32
    # dQ and dbias rows floored at the output's RMS, as dQ's elsewhere: a
    # query that sees one key has ds = p (dp - delta) = 0 exactly under
    # autograd and rounding noise in the kernel
    for floor, got, ref in zip((0.01, 1.0, 0.01, 0.01, 1.0), *grads):
        assert_flash_close(got, ref, FLASH_TOL[torch.float32], floor)
    alibi = _bias("alibi", B, H, S, S, torch.float32, cuda_device)
    o = FlashAttentionBias.apply(*(t.detach().requires_grad_() for t in (q0, k0, v0)),
                                 alibi, True, None, 0)
    o.float().sum().backward()    # alibi needs no grad: the dQ kernel writes no dbias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_evoformer_kernel_path_matches_einsum(cuda_device, dtype):
    """``evoformer_attention`` on the card (flash bias mode) against its
    einsum path in fp32 on the same (rounded) inputs, the pair bias's grad
    included, with one residue masked in every MSA row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(1)
    S, R, H, D = 3, 40, 4, 32
    q0, k0, v0 = (torch.from_numpy(rs.randn(1, S, R, H, D).astype(np.float32)).to(
        cuda_device, dtype) for _ in range(3))
    mask = np.ones((1, S, 1, 1, R), np.float32)
    mask[..., 3] = 0
    mask_bias = torch.from_numpy(np.where(mask > 0, 0.0, -1e30).astype(np.float32)).to(cuda_device)
    pair0 = torch.from_numpy(rs.randn(1, 1, H, R, R).astype(np.float32)).to(cuda_device)
    res = []
    for use_kernel, dt in ((True, dtype), (False, torch.float32)):
        q, k, v = (t.to(dt) for t in (q0, k0, v0))
        pair = pair0.clone().requires_grad_()
        out = evoformer_attention(q, k, v, [mask_bias, pair], use_kernel=use_kernel)
        (out.float() ** 2).sum().backward()
        res.append((out.detach(), pair.grad))
    assert res[0][0].dtype == dtype
    bf16 = dtype == torch.bfloat16
    assert_flash_close(res[0][0], res[1][0], 0.05 if bf16 else 1e-4)
    assert_flash_close(res[0][1], res[1][1], 0.15 if bf16 else 1e-3, 1.0 if bf16 else 0.01)


# --------------------------------------------------------------------------- #
# block-sparse kernels
# --------------------------------------------------------------------------- #
def _layout(kind, nb, causal):
    if kind == "sliding":
        return sliding_window_layout(nb, 2, causal=causal)
    if kind == "fixed":
        return fixed_layout(nb, 2, 3, causal=causal)
    return bigbird_layout(nb, 2, 1, 1, seed=nb, causal=causal)


def _sparse_check(q, k, v, do, layout, bs, causal, dtype):
    kw = dict(causal=causal)
    o, lse = sparse_fwd_cuda(q, k, v, layout, bs, **kw)
    o_ref, lse_ref = sparse_fwd_torch(q, k, v, layout, bs, **kw)
    torch.cuda.synchronize()
    assert_flash_close(o, o_ref, FLASH_TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    b, s, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)
    dq = sparse_bwd_dq_cuda(q, k, v, do, lse, delta, layout, bs, **kw)
    dk, dv = sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, layout, bs, **kw)
    torch.cuda.synchronize()
    refs = sparse_bwd_torch(q, k, v, o, lse, do, layout, bs, **kw)
    for got, ref in zip((dq, dk, dv), refs):
        assert got.shape == ref.shape and got.dtype == dtype
        assert_flash_close(got, ref, FLASH_TOL[dtype])
    return dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["sliding", "fixed", "bigbird"])
@pytest.mark.parametrize("bs,d,h,hkv", [(16, 32, 4, 2), (32, 64, 4, 4), (64, 128, 8, 2),
                                        (128, 64, 2, 1), (128, 128, 4, 4)])
def test_sparse_kernels_match_plain(cuda_device, bs, d, h, hkv, kind, causal, dtype):
    nb = 6
    q, k, v, do = flash_inputs((2, nb * bs, nb * bs, h, hkv, d), dtype, cuda_device,
                               seed=bs + d)
    # the three kernels sparse_source names (bf16 at block 128: sparse_sm90.cu)
    sm90 = sparse_source(dtype, bs, d) == SPARSE_SM90
    ran = ((sparse_fwd_sm90_cuda, sparse_bwd_dq_sm90_cuda, sparse_bwd_dkv_sm90_cuda) if sm90
           else (sparse_fwd_cuda, sparse_bwd_dq_cuda, sparse_bwd_dkv_cuda))
    fns = (sparse_fwd_cuda, sparse_bwd_dq_cuda, sparse_bwd_dkv_cuda, sparse_fwd_sm90_cuda,
           sparse_bwd_dq_sm90_cuda, sparse_bwd_dkv_sm90_cuda)
    counts = [f.launches for f in fns]
    _sparse_check(q, k, v, do, _layout(kind, nb, causal), bs, causal, dtype)
    assert [f.launches for f in fns] == [c + (f in ran) for c, f in zip(counts, fns)]


@pytest.mark.parametrize("bs", [16, 64, 128])
def test_sparse_empty_kv_column_gets_zero_grads(cuda_device, bs):
    """Row 1 attends only block 0, so no q block attends to kv block 1:
    its dK/dV are written as exact zeros."""
    nb = 5
    layout = np.eye(nb, dtype=bool)
    layout[:, 0] = True
    layout[1, 1] = False
    q, k, v, do = flash_inputs((1, nb * bs, nb * bs, 4, 2, 64), torch.bfloat16, cuda_device)
    dk, dv = _sparse_check(q, k, v, do, layout, bs, False, torch.bfloat16)
    assert not dk[:, bs:2 * bs].any() and not dv[:, bs:2 * bs].any()
    assert dk.abs().sum() > 0


def test_blocksparse_autograd_matches_dense_masked(cuda_device):
    """``blocksparse_attention`` on the card (the kernels, bf16) against
    its dense-masked path in fp32 under autograd, narrow GQA grads."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bs, nb = 64, 8
    lay = bigbird_layout(nb, 3, 1, 2, seed=0, causal=True)
    q0, k0, v0, do = flash_inputs((1, nb * bs, nb * bs, 8, 2, 128), torch.bfloat16,
                                  cuda_device, seed=8)
    grads = []
    for use_kernel, dtype in ((None, torch.bfloat16), (False, torch.float32)):
        q, k, v = (t.detach().to(dtype).requires_grad_() for t in (q0, k0, v0))
        o = blocksparse_attention(q, k, v, lay, bs, causal=True, use_kernel=use_kernel)
        (o.float() * do.float()).sum().backward()
        grads.append((o.detach(), q.grad, k.grad, v.grad))
    for (tol, floor), got, ref in zip(((0.05, 0.01), (0.15, 1.0), (0.05, 0.01), (0.05, 0.01)),
                                      *grads):
        assert got.shape == ref.shape
        assert_flash_close(got, ref, tol, floor)


def test_sparse_check_fails_a_swapped_list_entry(cuda_device):
    bs, nb = 64, 6
    lay = sliding_window_layout(nb, 2, causal=True)
    q, k, v, _ = flash_inputs((1, nb * bs, nb * bs, 4, 4, 64), torch.bfloat16, cuda_device)
    bad = lay.copy()
    bad[4, 3], bad[4, 1] = False, True     # row 4 reads block 1 instead of block 3
    o, _ = sparse_fwd_cuda(q, k, v, bad, bs)
    o_ref, _ = sparse_fwd_torch(q, k, v, lay, bs)
    with pytest.raises(AssertionError, match="row err"):
        assert_flash_close(o, o_ref, FLASH_TOL[torch.bfloat16])


def test_bias_and_sparse_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, k, v, do = flash_inputs((1, 96, 96, 2, 2, 96), torch.bfloat16, cuda_device)
    lay = np.ones((2, 2), bool)
    with pytest.raises(ValueError, match="head dim"):
        sparse_fwd_cuda(q, k, v, lay, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd_bias_cuda(q, k, v, torch.zeros(2, 1, 96, device=cuda_device))
    q, k, v, do = flash_inputs((1, 96, 96, 2, 2, 64), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="block size 48"):
        sparse_fwd_cuda(q, k, v, lay, 48)
    with pytest.raises(ValueError, match="fp16|bf16 or fp32 bias"):
        flash_fwd_bias_cuda(q, k, v, torch.zeros(2, 1, 96, device=cuda_device,
                                                 dtype=torch.float16))
    with pytest.raises(ValueError, match="broadcast"):
        flash_fwd_bias_cuda(q, k, v, torch.zeros(3, 1, 96, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_fwd_cuda(q.cpu(), k.cpu(), v.cpu(), lay, 48)
    with pytest.raises(ValueError, match="attend to no kv block"):
        blocksparse_attention(q, k, v, np.zeros((2, 2), bool), 48)


# --------------------------------------------------------------------------- #
# block-sparse dK/dV on sparse_sm90.cu (bf16, block 128)
# --------------------------------------------------------------------------- #
SM90_LAYOUTS = {   # S 4096, block 128: name -> (layout of 32 blocks, causal)
    "bigbird causal": (lambda: bigbird_layout(32, 3, 1, 2, seed=0, causal=True), True),
    "fixed non-causal": (lambda: fixed_layout(32, 4, 4, causal=False), False),
    "sliding window": (lambda: sliding_window_layout(32, 4, causal=True), True),
}


def _dkv_inputs(lay, causal, h, hkv, d, seed=0):
    """bf16 q, k, v, dO at S 4096, batch 1, with the forward's lse and
    delta from the forward kernel, and the plain pieces' dK/dV."""
    bs = 128
    q, k, v, do = flash_inputs((1, 32 * bs, 32 * bs, h, hkv, d), torch.bfloat16,
                               torch.device("cuda"), seed=seed)
    o, lse = sparse_fwd_cuda(q, k, v, lay, bs, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(h, -1)
    _, dk_ref, dv_ref = sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)
    return (q, k, v, do, lse, delta), (dk_ref, dv_ref)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("name", sorted(SM90_LAYOUTS))
def test_sparse_dkv_sm90_matches_plain(cuda_device, name, h, hkv, d):
    """S 4096 at block 128, groups 1 and 4; the bigbird layout's global
    column is split into >= 4 chunks; routed by sparse_source."""
    builder, causal = SM90_LAYOUTS[name]
    lay = builder()
    if name.startswith("bigbird"):
        plan = dkv_split_plan(lay, causal, h // hkv)["plan"]
        assert (plan[:, 0] == 0).sum() >= 4 and plan[plan[:, 0] == 0, 4].min() >= 4
    args, refs = _dkv_inputs(lay, causal, h, hkv, d, seed=d + h // hkv)
    before = (sparse_bwd_dkv_cuda.launches, sparse_bwd_dkv_sm90_cuda.launches)
    got = sparse_bwd_dkv_cuda(*args, lay, 128, causal=causal)
    torch.cuda.synchronize()
    assert (sparse_bwd_dkv_cuda.launches, sparse_bwd_dkv_sm90_cuda.launches) == \
        (before[0], before[1] + 1)
    for g, r in zip(got, refs):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        assert_flash_close(g, r, FLASH_TOL[torch.bfloat16])


def test_sparse_dkv_sm90_empty_column_and_identical_bits(cuda_device):
    """kv block 1 seen by no q block gets exact zeros; two calls give the
    same bits (the split column's merge sums in chunk order)."""
    lay = bigbird_layout(32, 3, 1, 2, seed=0, causal=True)
    lay[:, 1] = False
    lay[1, 0] = True
    args, refs = _dkv_inputs(lay, True, 8, 2, 128)
    a = sparse_bwd_dkv_sm90_cuda(*args, lay, 128, causal=True)
    b = sparse_bwd_dkv_sm90_cuda(*args, lay, 128, causal=True)
    torch.cuda.synchronize()
    for x, y, r in zip(a, b, refs):
        assert torch.equal(x, y)
        assert not x[:, 128:256].any()
        assert_flash_close(x, r, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("fault,what", [(1, "merge drops a chunk"),
                                        (2, "ring stage read early"),
                                        (3, "query head skipped")])
def test_sparse_dkv_sm90_check_fails_a_planted_fault(cuda_device, fault, what):
    lay = bigbird_layout(32, 3, 1, 2, seed=0, causal=True)
    args, refs = _dkv_inputs(lay, True, 8, 2, 128, seed=fault)
    with sparse_sm90_planted_fault(fault):
        bad = sparse_bwd_dkv_sm90_cuda(*args, lay, 128, causal=True)
        torch.cuda.synchronize()
    with pytest.raises(AssertionError):   # a row beyond the limit, or not finite
        for g, r in zip(bad, refs):
            assert_flash_close(g, r, FLASH_TOL[torch.bfloat16])
    # and the counters left by the faulty launch do not disturb the next
    good = sparse_bwd_dkv_sm90_cuda(*args, lay, 128, causal=True)
    for g, r in zip(good, refs):
        assert_flash_close(g, r, FLASH_TOL[torch.bfloat16])


def test_sparse_dkv_sm90_refuses_what_it_does_not_take(cuda_device):
    lay = sliding_window_layout(4, 2, causal=True)
    q, k, v, do = flash_inputs((1, 256, 256, 2, 2, 64), torch.bfloat16, cuda_device)
    lse = torch.zeros(2, 256, device=cuda_device)
    with pytest.raises(ValueError, match="block 128"):
        sparse_bwd_dkv_sm90_cuda(q, k, v, do, lse, lse, lay, 64)
    with pytest.raises(ValueError, match="block 128"):
        sparse_bwd_dkv_sm90_cuda(*(t.float() for t in (q, k, v, do)), lse, lse,
                                 sliding_window_layout(2, 2), 128)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        sparse_bwd_dkv_cuda(*(t.half() for t in (q, k, v, do)), lse, lse,
                            sliding_window_layout(2, 2), 128)


# --------------------------------------------------------------------------- #
# block-sparse dQ on sparse_sm90.cu (bf16, block 128)
# --------------------------------------------------------------------------- #
def _off_diagonal_layout():
    """Causal, 32 blocks: row i sees block 0 and block i - 1, so only row 0
    holds its diagonal block."""
    lay = np.zeros((32, 32), bool)
    lay[:, 0] = True
    lay[np.arange(1, 32), np.arange(31)] = True
    return lay


DQ_LAYOUTS = {**SM90_LAYOUTS, "off-diagonal causal": (_off_diagonal_layout, True)}


def _dq_inputs(lay, causal, h, hkv, d, seed=0):
    """bf16 q, k, v, dO at S 4096, batch 1, the forward kernel's lse and
    delta, and the plain pieces' dQ."""
    bs = 128
    q, k, v, do = flash_inputs((1, 32 * bs, 32 * bs, h, hkv, d), torch.bfloat16,
                               torch.device("cuda"), seed=seed)
    o, lse = sparse_fwd_cuda(q, k, v, lay, bs, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(h, -1)
    dq_ref, _, _ = sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)
    return (q, k, v, do, lse, delta), dq_ref


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("name", sorted(DQ_LAYOUTS))
def test_sparse_dq_sm90_matches_plain(cuda_device, name, h, hkv, d):
    """S 4096 at block 128, groups 1 and 4, causal and not; a CUDA bf16
    call at block 128 launches the sparse_sm90.cu kernel, not the old one."""
    builder, causal = DQ_LAYOUTS[name]
    lay = builder()
    args, ref = _dq_inputs(lay, causal, h, hkv, d, seed=d + h // hkv)
    before = (sparse_bwd_dq_cuda.launches, sparse_bwd_dq_sm90_cuda.launches)
    got = sparse_bwd_dq_cuda(*args, lay, 128, causal=causal)
    torch.cuda.synchronize()
    assert (sparse_bwd_dq_cuda.launches, sparse_bwd_dq_sm90_cuda.launches) == \
        (before[0], before[1] + 1)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert_flash_close(got, ref, FLASH_TOL[torch.bfloat16])


def test_sparse_dq_sm90_gives_identical_bits(cuda_device):
    lay = bigbird_layout(32, 3, 1, 2, seed=0, causal=True)
    args, ref = _dq_inputs(lay, True, 8, 2, 128)
    a = sparse_bwd_dq_sm90_cuda(*args, lay, 128, causal=True)
    b = sparse_bwd_dq_sm90_cuda(*args, lay, 128, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert_flash_close(a, ref, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("fault,what", [(4, "last list entry left out"),
                                        (5, "ring stage read early"),
                                        (6, "diagonal mask left out")])
def test_sparse_dq_sm90_check_fails_a_planted_fault(cuda_device, fault, what):
    lay = bigbird_layout(32, 3, 1, 2, seed=0, causal=True)
    args, ref = _dq_inputs(lay, True, 8, 2, 128, seed=fault)
    with sparse_sm90_planted_fault(fault):
        bad = sparse_bwd_dq_sm90_cuda(*args, lay, 128, causal=True)
        torch.cuda.synchronize()
    with pytest.raises(AssertionError):   # a row beyond the limit, or not finite
        assert_flash_close(bad, ref, FLASH_TOL[torch.bfloat16])
    good = sparse_bwd_dq_sm90_cuda(*args, lay, 128, causal=True)
    assert_flash_close(good, ref, FLASH_TOL[torch.bfloat16])


def test_sparse_dq_sm90_refuses_what_it_does_not_take(cuda_device):
    lay = sliding_window_layout(4, 2, causal=True)
    q, k, v, do = flash_inputs((1, 256, 256, 2, 2, 64), torch.bfloat16, cuda_device)
    lse = torch.zeros(2, 256, device=cuda_device)
    with pytest.raises(ValueError, match="block 128"):
        sparse_bwd_dq_sm90_cuda(q, k, v, do, lse, lse, lay, 64)
    with pytest.raises(ValueError, match="block 128"):
        sparse_bwd_dq_sm90_cuda(*(t.float() for t in (q, k, v, do)), lse, lse,
                                sliding_window_layout(2, 2), 128)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        sparse_bwd_dq_cuda(*(t.half() for t in (q, k, v, do)), lse, lse,
                           sliding_window_layout(2, 2), 128)


# --------------------------------------------------------------------------- #
# block-sparse forward on sparse_sm90.cu (bf16, block 128)
# --------------------------------------------------------------------------- #
FWD_LAYOUTS = {   # 32 blocks of 128: name -> builder(causal)
    "bigbird": lambda causal: bigbird_layout(32, 3, 1, 2, seed=0, causal=causal),
    "fixed": lambda causal: fixed_layout(32, 4, 4, causal=causal),
    "sliding": lambda causal: sliding_window_layout(32, 4, causal=causal),
}


def _fwd_case(name, causal, h, hkv, d, seed=0):
    lay = FWD_LAYOUTS[name](causal)
    q, k, v, _ = flash_inputs((1, 32 * 128, 32 * 128, h, hkv, d), torch.bfloat16,
                              torch.device("cuda"), seed=seed)
    return (q, k, v), lay, sparse_fwd_torch(q, k, v, lay, 128, causal=causal)


def _fwd_close(got, ref):
    assert got[0].shape == ref[0].shape and got[0].dtype == torch.bfloat16
    assert_flash_close(got[0], ref[0], FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(FWD_LAYOUTS))
def test_sparse_fwd_sm90_matches_plain(cuda_device, name, causal, h, hkv, d):
    """S 4096 at block 128: o and lse against the plain forward; a CUDA
    bf16 call at block 128 launches the sparse_sm90.cu kernel, not the old
    one."""
    args, lay, ref = _fwd_case(name, causal, h, hkv, d, seed=d + h // hkv)
    before = (sparse_fwd_cuda.launches, sparse_fwd_sm90_cuda.launches)
    got = sparse_fwd_cuda(*args, lay, 128, causal=causal)
    torch.cuda.synchronize()
    assert (sparse_fwd_cuda.launches, sparse_fwd_sm90_cuda.launches) == \
        (before[0], before[1] + 1)
    _fwd_close(got, ref)


def test_sparse_fwd_sm90_gives_identical_bits(cuda_device):
    args, lay, ref = _fwd_case("bigbird", True, 8, 2, 128)
    a = sparse_fwd_sm90_cuda(*args, lay, 128, causal=True)
    b = sparse_fwd_sm90_cuda(*args, lay, 128, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _fwd_close(a, ref)


@pytest.mark.parametrize("fault,what", [(7, "last list entry left out"),
                                        (8, "ring stage read early"),
                                        (9, "diagonal mask left out")])
def test_sparse_fwd_sm90_check_fails_a_planted_fault(cuda_device, fault, what):
    args, lay, ref = _fwd_case("bigbird", True, 8, 2, 128, seed=fault)
    with sparse_sm90_planted_fault(fault):
        bad = sparse_fwd_sm90_cuda(*args, lay, 128, causal=True)
        torch.cuda.synchronize()
    with pytest.raises(AssertionError):   # a row beyond the limit, or not finite
        assert_flash_close(bad[0], ref[0], FLASH_TOL[torch.bfloat16])
    _fwd_close(sparse_fwd_sm90_cuda(*args, lay, 128, causal=True), ref)


def test_sparse_fwd_sm90_refuses_what_it_does_not_take(cuda_device):
    lay = sliding_window_layout(4, 2, causal=True)
    q, k, v, _ = flash_inputs((1, 256, 256, 2, 2, 64), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="block 128"):
        sparse_fwd_sm90_cuda(q, k, v, lay, 64)
    with pytest.raises(ValueError, match="block 128"):
        sparse_fwd_sm90_cuda(*(t.float() for t in (q, k, v)), sliding_window_layout(2, 2), 128)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        sparse_fwd_cuda(*(t.half() for t in (q, k, v)), sliding_window_layout(2, 2), 128)


# --------------------------------------------------------------------------- #
# block-sparse dK/dV on sparse_attention.cu (blocks 16-64; fp32): split columns
# --------------------------------------------------------------------------- #
# (dtype, block): bf16 below block 128; fp32 at block 128 too, the one route
# whose work items take two 64-row parts (the partial slots and tickets
# indexed by part and warp)
SPLIT_CASES = [(dt, bs) for dt in (torch.bfloat16, torch.float32) for bs in (16, 32, 64)] + \
    [(torch.float32, 128)]
def _split_inputs(bs, dtype, h, hkv, d, lay, causal, seed=0):
    """q, k, v, dO at S 2048, batch 2, the forward kernel's lse and delta,
    and the plain pieces' dK/dV."""
    s = 2048
    q, k, v, do = flash_inputs((2, s, s, h, hkv, d), dtype, torch.device("cuda"), seed=seed)
    o, lse = sparse_fwd_cuda(q, k, v, lay, bs, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(2 * h, s)
    _, dk_ref, dv_ref = sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)
    return (q, k, v, do, lse, delta), (dk_ref, dv_ref)


@pytest.mark.parametrize("d,h,hkv", [(128, 8, 2), (64, 8, 8), (32, 4, 1)])
@pytest.mark.parametrize("dtype,bs", SPLIT_CASES)
def test_sparse_dkv_split_matches_plain(cuda_device, bs, d, h, hkv, dtype):
    """S 2048, bigbird causal with its global column split; and fixed
    non-causal; routed to sparse_attention.cu (fp32 at block 128 too)."""
    for lay, causal in ((bigbird_layout(2048 // bs, 3, 1, 2, seed=0, causal=True), True),
                        (fixed_layout(2048 // bs, 4, 4, causal=False), False)):
        if causal:
            assert dkv_split_plan(lay, causal, h // hkv)["split_columns"] >= 1
        args, refs = _split_inputs(bs, dtype, h, hkv, d, lay, causal, seed=bs + d)
        before = (sparse_bwd_dkv_cuda.launches, sparse_bwd_dkv_sm90_cuda.launches)
        got = sparse_bwd_dkv_cuda(*args, lay, bs, causal=causal)
        torch.cuda.synchronize()
        assert (sparse_bwd_dkv_cuda.launches, sparse_bwd_dkv_sm90_cuda.launches) == \
            (before[0] + 1, before[1])
        for g, r in zip(got, refs):
            assert g.shape == r.shape and g.dtype == dtype
            assert_flash_close(g, r, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype,bs", SPLIT_CASES)
def test_sparse_dkv_split_empty_column_and_identical_bits(cuda_device, bs, dtype):
    """kv block 1 seen by no q block gets exact zeros; two calls give the
    same bits (the split column's merge sums in chunk order)."""
    lay = bigbird_layout(2048 // bs, 3, 1, 2, seed=0, causal=True)
    lay[:, 1] = False
    lay[1, 0] = True
    args, refs = _split_inputs(bs, dtype, 8, 2, 128, lay, True)
    a = sparse_bwd_dkv_cuda(*args, lay, bs, causal=True)
    b = sparse_bwd_dkv_cuda(*args, lay, bs, causal=True)
    torch.cuda.synchronize()
    for x, y, r in zip(a, b, refs):
        assert torch.equal(x, y)
        assert not x[:, bs:2 * bs].any()
        assert_flash_close(x, r, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype,bs", SPLIT_CASES)
def test_sparse_dkv_split_check_fails_a_planted_fault(cuda_device, bs, dtype):
    """The merge dropping a split column's last chunk fails the check; the
    counters it leaves do not disturb the next call."""
    lay = bigbird_layout(2048 // bs, 3, 1, 2, seed=0, causal=True)
    args, refs = _split_inputs(bs, dtype, 8, 2, 128, lay, True, seed=1)
    with sparse_attention_planted_fault(1):
        bad = sparse_bwd_dkv_cuda(*args, lay, bs, causal=True)
        torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        for g, r in zip(bad, refs):
            assert_flash_close(g, r, FLASH_TOL[dtype])
    for g, r in zip(sparse_bwd_dkv_cuda(*args, lay, bs, causal=True), refs):
        assert_flash_close(g, r, FLASH_TOL[dtype])


# --------------------------------------------------------------------------- #
# block-sparse forward and dQ on sparse_attention.cu (blocks 16-64; fp32)
# --------------------------------------------------------------------------- #
MMA_LAYOUTS = {   # name -> (builder over nb, causal)
    "bigbird causal": (lambda nb: bigbird_layout(nb, 3, 1, 2, seed=0, causal=True), True),
    "fixed non-causal": (lambda nb: fixed_layout(nb, 4, 4, causal=False), False),
    "sliding causal": (lambda nb: sliding_window_layout(nb, 4, causal=True), True),
}


def _mma_case(dtype, bs, h, hkv, d, lay, causal, seed=0):
    """q, k, v, dO at S 1024, batch 2, and the plain forward's o and lse."""
    q, k, v, do = flash_inputs((2, 1024, 1024, h, hkv, d), dtype, torch.device("cuda"),
                               seed=seed)
    return (q, k, v, do), sparse_fwd_torch(q, k, v, lay, bs, causal=causal)


def _mma_dq(args, o, lse, lay, bs, causal):
    """dq from the kernel with the given o and lse, and the plain dq."""
    q, k, v, do = args
    b, s, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)
    dq = sparse_bwd_dq_cuda(q, k, v, do, lse, delta, lay, bs, causal=causal)
    ref = sparse_bwd_torch(q, k, v, o, lse, do, lay, bs, causal=causal)[0]
    return dq, ref, delta


@pytest.mark.parametrize("name", sorted(MMA_LAYOUTS))
@pytest.mark.parametrize("h,hkv,d", [(4, 4, 64), (8, 4, 32), (8, 2, 128), (16, 2, 64)])
@pytest.mark.parametrize("dtype,bs", SPLIT_CASES)
def test_sparse_mma_fwd_dq_match_plain(cuda_device, bs, dtype, h, hkv, d, name):
    """Groups 1, 2, 4 and 8 (8 heads of 32 rows: two items of four); o, lse
    and dq of sparse_attention.cu against the plain pieces; one launch of
    each wrapper, none of sparse_sm90.cu's."""
    builder, causal = MMA_LAYOUTS[name]
    lay = builder(1024 // bs)
    args, (o_ref, lse_ref) = _mma_case(dtype, bs, h, hkv, d, lay, causal, seed=bs + h)
    plan = mma_items(lay, causal, bs, h // hkv, dtype)
    if h // hkv * plan["rows"] > MMA_ITEM_ROWS[dtype]:
        assert plan["heads"] < h // hkv   # the group takes several items
    fns = (sparse_fwd_cuda, sparse_bwd_dq_cuda, sparse_fwd_sm90_cuda, sparse_bwd_dq_sm90_cuda)
    before = [f.launches for f in fns]
    o, lse = sparse_fwd_cuda(*args[:3], lay, bs, causal=causal)
    dq, dq_ref, _ = _mma_dq(args, o, lse, lay, bs, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [before[0] + 1, before[1] + 1, before[2], before[3]]
    assert o.dtype == dq.dtype == dtype
    assert_flash_close(o, o_ref, FLASH_TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    assert_flash_close(dq, dq_ref, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype,bs", SPLIT_CASES)
def test_sparse_mma_fwd_dq_identical_bits(cuda_device, bs, dtype):
    lay = bigbird_layout(1024 // bs, 3, 1, 2, seed=0, causal=True)
    args, _ = _mma_case(dtype, bs, 8, 2, 128, lay, True)
    a = sparse_fwd_cuda(*args[:3], lay, bs, causal=True)
    b = sparse_fwd_cuda(*args[:3], lay, bs, causal=True)
    dq_a, _, delta = _mma_dq(args, *a, lay, bs, True)
    dq_b = sparse_bwd_dq_cuda(*args, a[1], delta, lay, bs, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(dq_a, dq_b)


@pytest.mark.parametrize("fault,what", [(2, "forward: ring stage read early"),
                                        (3, "dQ: last head of the item left out")])
@pytest.mark.parametrize("dtype,bs", SPLIT_CASES)
def test_sparse_mma_check_fails_a_planted_fault(cuda_device, bs, dtype, fault, what):
    lay = bigbird_layout(1024 // bs, 3, 1, 2, seed=0, causal=True)
    args, (o_ref, lse_ref) = _mma_case(dtype, bs, 8, 2, 128, lay, True, seed=fault)
    with sparse_attention_planted_fault(fault):
        o, lse = sparse_fwd_cuda(*args[:3], lay, bs, causal=True)
        dq, dq_ref, _ = _mma_dq(args, o_ref, lse_ref, lay, bs, True)
        torch.cuda.synchronize()
    bad, ref = (o, o_ref) if fault == 2 else (dq, dq_ref)
    with pytest.raises(AssertionError):   # a row beyond the limit, or not finite
        assert_flash_close(bad, ref, FLASH_TOL[dtype])
    # the next calls are sound
    o, lse = sparse_fwd_cuda(*args[:3], lay, bs, causal=True)
    dq, dq_ref, _ = _mma_dq(args, o, lse, lay, bs, True)
    assert_flash_close(o, o_ref, FLASH_TOL[dtype])
    assert_flash_close(dq, dq_ref, FLASH_TOL[dtype])
