"""Which kernel serves the flash backward, and what the bf16 kernels
(``ops/csrc/flash_bwd_sm90.cu``) need of their inputs, checked without a GPU.

``bwd_source`` is the pure function the dQ and dK/dV wrappers ask (through
``_sm90``) before a launch: bf16, with or without a bias, goes to the
Hopper kernels (TMA + wgmma), fp32 to ``flash_bwd.cu``. The bf16 kernels read q, k, v and dO
through TMA tensor maps; ``tma_check`` raises, naming the tensor it cannot
read, before any launch, on the bias route too (``_sm90``); the bias itself
is read in place through its strides at any broadcast shape
(``_bias_args``). The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.flash_attention import (
    BWD_MMA, BWD_SM90, HEAD_DIMS, _bias_args, _sm90, bwd_source, tma_check)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype,has_bias,source", [
    (torch.bfloat16, False, "flash_bwd_sm90.cu"),
    (torch.bfloat16, True, "flash_bwd_sm90.cu"),
    (torch.float32, False, "flash_bwd.cu"),
    (torch.float32, True, "flash_bwd.cu")])
def test_routing_table(d, dtype, has_bias, source):
    assert bwd_source(dtype, d) == source
    assert (_build.CSRC / source).is_file()
    q, k, v, do = (t.to(dtype) for t in _dense(d=d))
    bias = torch.zeros(q.shape[2], 1, k.shape[1]) if has_bias else None
    assert _sm90("flash_bwd_dq_cuda", q, k, v, do, bias) == (source == BWD_SM90)


@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("d", [16, 96, 256])
def test_an_unsupported_head_dim_raises(d, has_bias):
    assert d not in HEAD_DIMS
    with pytest.raises(ValueError, match="head dim"):
        bwd_source(torch.bfloat16, d)
    q, k, v, do = _dense(d=d)
    bias = torch.zeros(q.shape[2], 1, k.shape[1]) if has_bias else None
    with pytest.raises(ValueError, match="head dim"):
        _sm90("flash_bwd_dq_cuda", q, k, v, do, bias)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_an_unsupported_dtype_raises(dtype):
    with pytest.raises(ValueError, match="bf16 or fp32"):
        bwd_source(dtype, 64)


def test_both_sources_are_built_and_bound():
    """Both backward sources go into the library; the new entry points and
    the planted-fault hook have their argument types."""
    names = [p.name for p in _build.sources()]
    assert BWD_SM90 in names and BWD_MMA in names
    vp, i, f = _build._VP, _build._I, _build._F
    assert _build.SIGNATURES["dstt_flash_bwd_dq_sm90"] == [vp] * 7 + [i] * 9 + [f, vp]
    assert _build.SIGNATURES["dstt_flash_bwd_dkv_sm90"] == [vp] * 8 + [i] * 9 + [f, vp]
    assert _build.SIGNATURES["dstt_flash_bwd_sm90_plant"] == [i]


def test_the_bias_entry_points_are_bound():
    """The bias mode of the bf16 backward has entry points of its own, each
    the no-bias one's arguments, then the bias (pointer, four 64-bit
    strides, is-fp32) and, for dQ, the dbias pointer."""
    vp, i, f, ll = _build._VP, _build._I, _build._F, _build._LL
    bias = [vp, ll, ll, ll, ll, i]
    assert _build.SIGNATURES["dstt_flash_bwd_dq_bias_sm90"] == \
        [vp] * 7 + [i] * 9 + [f] + bias + [vp, vp]
    assert _build.SIGNATURES["dstt_flash_bwd_dkv_bias_sm90"] == \
        [vp] * 8 + [i] * 9 + [f] + bias + [vp]


def _dense(b=2, s=16, h=4, d=64):
    return [torch.zeros(b, s, n, d, dtype=torch.bfloat16) for n in (h, 2, 2, h)]


def test_dense_inputs_pass_the_tma_check():
    q, k, v, do = _dense()
    tma_check("flash_bwd_dq_cuda", q=q, k=k, v=v, dO=do)


@pytest.mark.parametrize("layout", ["b s two h d", "b s h two d"])
def test_the_tma_check_names_a_sliced_dO(layout):
    """dO sliced from a wider tensor is not dense: the check names dO (the
    wrapper makes it dense first, so a launch never sees it)."""
    q, k, v, _ = _dense()
    b, s, h, d = q.shape
    if layout == "b s two h d":
        do = torch.zeros(b, s, 2, h, d, dtype=torch.bfloat16)[:, :, 0]
    else:
        do = torch.zeros(b, s, h, 2, d, dtype=torch.bfloat16)[:, :, :, 0]
    assert do.shape == q.shape and not do.is_contiguous()
    with pytest.raises(ValueError, match=r"flash_bwd_dkv_cuda: TMA cannot read dO: strides"):
        tma_check("flash_bwd_dkv_cuda", q=q, k=k, v=v, dO=do)
    tma_check("flash_bwd_dkv_cuda", q=q, k=k, v=v, dO=do.contiguous())


def test_the_tma_check_names_a_misaligned_dO():
    q, k, v, do = _dense()
    buf = torch.zeros(do.numel() + 1, dtype=torch.bfloat16)
    odd = buf[1:].view(do.shape)
    with pytest.raises(ValueError, match="TMA cannot read dO: base address"):
        tma_check("flash_bwd_dq_cuda", q=q, k=k, v=v, dO=odd)


def test_the_tma_check_names_the_first_tensor_it_refuses():
    q, k, v, do = _dense()
    with pytest.raises(ValueError, match="TMA cannot read k: dtype"):
        tma_check("flash_bwd_dq_cuda", q=q, k=k.float(), v=v.float(), dO=do)


BIAS_FORMS = {   # name: bias shape from (B, H, Sq, Skv), as the GPU tests' forms
    "full": lambda b, h, sq, skv: (b, h, sq, skv),
    "alibi": lambda b, h, sq, skv: (h, 1, skv),
    "per row": lambda b, h, sq, skv: (1, h, sq, 1),
    "pair": lambda b, h, sq, skv: (1, h, sq, skv),
    "per batch": lambda b, h, sq, skv: (b, 1, 1, skv),
}


@pytest.mark.parametrize("wrapper", ["flash_bwd_dq_bias_cuda", "flash_bwd_dkv_bias_cuda"])
@pytest.mark.parametrize("layout", ["sliced", "misaligned"])
def test_the_bias_route_checks_dO_for_tma(wrapper, layout):
    """A bf16 bias-mode call goes to ``flash_bwd_sm90.cu`` through the TMA
    check: a sliced or misaligned dO is named, and no other kernel takes
    the call."""
    q, k, v, do = _dense()
    bias = torch.zeros(q.shape[2], 1, q.shape[1])
    if layout == "sliced":
        bad = torch.zeros(*do.shape[:3], 2, do.shape[3], dtype=torch.bfloat16)[..., 0, :]
        match = "TMA cannot read dO: strides"
    else:
        bad = torch.zeros(do.numel() + 1, dtype=torch.bfloat16)[1:].view(do.shape)
        match = "TMA cannot read dO: base address"
    with pytest.raises(ValueError, match=f"{wrapper}: {match}"):
        _sm90(wrapper, q, k, v, bad, bias)
    assert _sm90(wrapper, q, k, v, do, bias)


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", sorted(BIAS_FORMS))
def test_a_bias_at_every_stride_pattern_is_accepted(form, bias_dtype):
    """Each broadcast form goes to the bf16 kernels as it is stored: its
    broadcast dims get stride 0, the rest its own element strides, its
    pointer unmoved and nothing copied."""
    b, sq, h, d = 2, 16, 4, 64
    skv = 24
    q = torch.zeros(b, sq, h, d, dtype=torch.bfloat16)
    k, v = (torch.zeros(b, skv, 2, d, dtype=torch.bfloat16) for _ in range(2))
    bias = torch.zeros(BIAS_FORMS[form](b, h, sq, skv), dtype=bias_dtype)
    assert _sm90("flash_bwd_dq_bias_cuda", q, k, v, q, bias)
    ptr, *strides, f32 = _bias_args(bias, "flash_bwd_dq_bias_cuda", b, h, sq, skv, q.device)
    assert ptr == bias.data_ptr() and f32 == int(bias_dtype == torch.float32)
    expanded = bias.expand(b, h, sq, skv)
    assert tuple(strides) == expanded.stride()
    for dim, n in enumerate((b, h, sq, skv)):
        lead = 4 - bias.dim()
        broadcast = dim < lead or bias.shape[dim - lead] == 1
        if broadcast and n > 1:
            assert strides[dim] == 0
