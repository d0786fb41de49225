"""Which kernel serves the flash backward, and what the bf16 kernels
(``ops/csrc/flash_bwd_sm90.cu``) need of their inputs, checked without a GPU.

``bwd_source`` is the pure function the dQ and dK/dV wrappers ask before a
launch: bf16 without a bias goes to the Hopper kernels (TMA + wgmma), fp32
and every bias-mode call to ``flash_bwd.cu``. The bf16 kernels read q, k, v
and dO through TMA tensor maps; ``tma_check`` raises, naming the tensor it
cannot read, before any launch. The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.flash_attention import (
    BWD_MMA, BWD_SM90, HEAD_DIMS, bwd_source, tma_check)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype,has_bias,source", [
    (torch.bfloat16, False, "flash_bwd_sm90.cu"),
    (torch.bfloat16, True, "flash_bwd.cu"),
    (torch.float32, False, "flash_bwd.cu"),
    (torch.float32, True, "flash_bwd.cu")])
def test_routing_table(d, dtype, has_bias, source):
    assert bwd_source(dtype, d, has_bias) == source
    assert (_build.CSRC / source).is_file()


@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("d", [16, 96, 256])
def test_an_unsupported_head_dim_raises(d, has_bias):
    assert d not in HEAD_DIMS
    with pytest.raises(ValueError, match="head dim"):
        bwd_source(torch.bfloat16, d, has_bias)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_an_unsupported_dtype_raises(dtype):
    with pytest.raises(ValueError, match="bf16 or fp32"):
        bwd_source(dtype, 64, False)


def test_both_sources_are_built_and_bound():
    """Both backward sources go into the library; the new entry points and
    the planted-fault hook have their argument types."""
    names = [p.name for p in _build.sources()]
    assert BWD_SM90 in names and BWD_MMA in names
    vp, i, f = _build._VP, _build._I, _build._F
    assert _build.SIGNATURES["dstt_flash_bwd_dq_sm90"] == [vp] * 7 + [i] * 9 + [f, vp]
    assert _build.SIGNATURES["dstt_flash_bwd_dkv_sm90"] == [vp] * 8 + [i] * 9 + [f, vp]
    assert _build.SIGNATURES["dstt_flash_bwd_sm90_plant"] == [i]


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
