"""What the bf16 flash forward (``ops/csrc/flash_fwd_sm90.cu``) needs of its
inputs, checked without a GPU.

The kernel reads q, k and v through TMA tensor maps over dense
``[B, S, H, D]`` tensors: each base address and every stride must be a
multiple of 16 bytes. ``tma_refusal`` is the pure function the wrapper asks
before a launch; anything it refuses raises, never another path. The kernel
itself runs only on the card (``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.flash_attention import HEAD_DIMS, tma_refusal


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 127, 8), (1, 4096, 32)])
def test_dense_bf16_bshd_is_accepted(d, shape):
    t = torch.zeros(*shape, d, dtype=torch.bfloat16)
    assert t.data_ptr() % 16 == 0
    assert tma_refusal(t) is None


@pytest.mark.parametrize("offset", [1, 2, 4, 7])
def test_a_storage_offset_off_16_bytes_is_refused(offset):
    """A view that starts ``offset`` bf16 elements (2 * offset bytes) into an
    aligned buffer is dense but not 16-byte aligned."""
    buf = torch.zeros(offset + 2 * 16 * 4 * 64, dtype=torch.bfloat16)
    t = buf[offset:].view(2, 16, 4, 64)
    assert t.is_contiguous()
    why = tma_refusal(t)
    assert why is not None and "16 bytes" in why


def test_an_offset_of_16_bytes_is_accepted():
    buf = torch.zeros(8 + 16 * 4 * 64, dtype=torch.bfloat16)
    assert tma_refusal(buf[8:].view(1, 16, 4, 64)) is None


@pytest.mark.parametrize("layout", ["b s three h d", "b s h three d"])
def test_a_slice_of_fused_qkv_is_refused_until_made_dense(layout):
    """q sliced from a fused qkv projection has the strides of the fused
    tensor; ``.contiguous()`` (which the wrapper applies) makes it readable."""
    b, s, h, d = 2, 16, 4, 64
    if layout == "b s three h d":
        q = torch.zeros(b, s, 3, h, d, dtype=torch.bfloat16)[:, :, 0]
    else:
        q = torch.zeros(b, s, h, 3, d, dtype=torch.bfloat16)[:, :, :, 0]
    assert q.shape == (b, s, h, d)
    why = tma_refusal(q)
    assert why is not None and "dense" in why
    assert tma_refusal(q.contiguous()) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_other_dtypes_are_refused(dtype):
    """Only bf16 goes to the TMA kernel (fp32 stays on the FMA kernel)."""
    assert "bf16" in tma_refusal(torch.zeros(1, 8, 2, 64, dtype=dtype))


@pytest.mark.parametrize("d", [16, 96, 256])
def test_head_dims_outside_the_kernel_are_refused(d):
    assert d not in HEAD_DIMS
    assert "D in" in tma_refusal(torch.zeros(1, 8, 2, d, dtype=torch.bfloat16))


def test_three_dimensional_tensors_are_refused():
    assert tma_refusal(torch.zeros(8, 2, 64, dtype=torch.bfloat16)) is not None


def test_the_library_builds_the_sm90_source():
    """The bf16 forward's source is built beside the others and its
    planted-fault hook is bound."""
    names = [p.name for p in _build.sources()]
    assert "flash_fwd_sm90.cu" in names and "flash_fwd.cu" in names
    assert _build.SIGNATURES["dstt_flash_fwd_sm90_plant"] == [_build._I]


def test_an_edit_of_the_hopper_header_rebuilds(tmp_path, monkeypatch):
    """The build key hashes the headers too: an edit of hopper_common.cuh
    alone moves the library to a new build directory."""
    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._key()
    header = tmp_path / "hopper_common.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build._key() != before
