"""Flash attention — counterpart of
``deepspeed_tpu/ops/pallas/flash_attention.py`` (``_flash_fwd`` :361,
``_flash_bwd`` :592, the custom VJP :736-783, ``flash_attention`` :809).

Three hand-written kernels replace the three TPU kernels:

- ``ops/csrc/flash_fwd.cu`` (``_fwd_kernel`` :284): ``(o, lse)``;
- ``ops/csrc/flash_bwd.cu`` ``dq`` (``_bwd_dq_kernel`` :448);
- ``ops/csrc/flash_bwd.cu`` ``dkv`` (``_bwd_dkv_kernel`` :523), which writes
  NARROW dK/dV under GQA (no widen-then-sum).

Their wrappers, :func:`flash_fwd_cuda`, :func:`flash_bwd_dq_cuda` and
:func:`flash_bwd_dkv_cuda`, take CUDA tensors only and count their launches
(``.launches``). Beside them are the plain versions :func:`flash_fwd_torch`
and :func:`flash_bwd_torch`: the same functions in PyTorch, which serve CPU
tensors and are what the kernels are held against on the card.

:func:`flash_attention_fwd` ``-> (o, lse)`` and :func:`flash_attention_bwd`
``-> (dq, dk, dv)`` are the raw pieces (``sequence/fpdt.py`` and
``sequence/ring.py`` call them in the JAX package); :class:`FlashAttention`
is the autograd function over them, and :func:`flash_attention` the ``cuda``
backend of op ``attention``. Each picks the kernel for CUDA tensors and the
plain version for CPU tensors, by the device of ``q`` alone.

Layout: q/o ``[B, Sq, H, D]``, k/v ``[B, Skv, Hkv, D]`` with ``H % Hkv == 0``
(query head ``h`` reads kv head ``h // (H // Hkv)``), lse ``[B * H, Sq]``
fp32 (the TPU's 128-lane replication of lse is a Mosaic layout, not kept).
Masks: causal with ``q_offset`` (the absolute position of q row 0), a static
causal ``window``, and kv length. A row that sees no key gets o = 0 and
lse = -1e30, as the TPU kernel's ``_finish`` does. The additive-bias variant
(``_flash_b`` :787, evoformer) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF, widen_kv
from .registry import register

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 128)


def _visible(sq: int, skv: int, causal: bool, q_offset: int,
             window: Optional[int], device) -> torch.Tensor:
    """[Sq, Skv] bool: which keys each query row sees (the TPU's
    ``_block_mask``, over the whole matrix)."""
    if not causal:
        return torch.ones(sq, skv, dtype=torch.bool, device=device)
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    kv_pos = torch.arange(skv, device=device)[None, :]
    m = kv_pos <= q_pos
    if window is not None:
        m = m & (q_pos - kv_pos < window)
    return m


def _check_args(causal: bool, window: Optional[int]) -> Optional[int]:
    if window is None:
        return None
    if not causal or int(window) < 1:
        raise ValueError("window needs causal attention and window >= 1")
    return int(window)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def flash_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, Sq, H, D] in q's dtype, lse [B * H, Sq] fp32)``, computed as
    the kernel does: fp32 scores, p rounded to v's dtype for the P V
    product, normalised by the fp32 row sum."""
    window = _check_args(causal, window)
    b, sq, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    kw, vw = widen_kv(k, v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kw.float()) * scale
    vis = _visible(sq, k.shape[1], causal, q_offset, window, q.device)
    s = s.masked_fill(~vis, float("-inf"))
    m = s.amax(-1, keepdim=True)
    empty = m == float("-inf")
    p = torch.exp(s - torch.where(empty, torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vw.float())
    o = o / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(empty, torch.full_like(m, NEG_INF), m) + torch.log(l_safe)
    return o.to(q.dtype), lse.reshape(b * h, sq)


def flash_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse``, as the kernels
    compute them: p recomputed from lse, delta = rowsum(dO * O), ds rounded
    to the inputs' dtype; dK/dV summed over each kv head's query group."""
    window = _check_args(causal, window)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kw, vw = widen_kv(k, v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kw.float()) * scale
    vis = _visible(sq, skv, causal, q_offset, window, q.device)
    p = torch.exp(s - lse.reshape(b, h, sq, 1)).masked_fill(~vis, 0.0)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vw.float())
    ds = (p * (dp - delta) * scale).to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kw.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    g = h // hkv
    dk = dk.reshape(b, skv, hkv, g, d).sum(3)
    dv = dv.reshape(b, skv, hkv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------- #
def _kernel_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *rest: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """Check what the kernels take; returns (B, Sq, H, D, Skv, Hkv)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes bf16 or fp32 inputs, got {q.dtype}")
    for t in (k, v, *rest):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: dtypes {t.dtype} and {q.dtype} differ")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, S, H, D] / [B, S, Hkv, D]")
    b, sq, h, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (head dim in {HEAD_DIMS}, "
                         f"H % Hkv == 0)")
    for t in (q, k, v, *rest):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    return b, sq, h, d, skv, hkv


def _common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale, dtype, dev):
    window = _check_args(causal, window)
    return (b, h, hkv, sq, skv, d, int(q_offset), int(bool(causal)),
            0 if window is None else window,
            float(d ** -0.5 if scale is None else scale), _DTYPE_CODE[dtype],
            torch.cuda.current_stream(dev).cuda_stream)


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, scale: Optional[float] = None,
                   q_offset: int = 0, window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``ops/csrc/flash_fwd.cu``: ``(o, lse)``."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d, skv, hkv = _kernel_shapes("flash_fwd_cuda", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    err = _build.load().dstt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale,
                 q.dtype, q.device))
    _build.check(err, "flash_fwd kernel")
    flash_fwd_cuda.launches += 1
    return o, lse


def _lse_delta(lse: torch.Tensor, delta: torch.Tensor, b: int, h: int, sq: int):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b * h, sq):
            raise ValueError(f"{name} must be fp32 [{b * h}, {sq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return lse.contiguous(), delta.contiguous()


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      q_offset: int = 0, window: Optional[int] = None
                      ) -> torch.Tensor:
    """Launch the dQ kernel of ``ops/csrc/flash_bwd.cu``."""
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    b, sq, h, d, skv, hkv = _kernel_shapes("flash_bwd_dq_cuda", q, k, v, do)
    lse, delta = _lse_delta(lse, delta, b, h, sq)
    dq = torch.empty_like(q)
    err = _build.load().dstt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        *_common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale,
                 q.dtype, q.device))
    _build.check(err, "flash_bwd_dq kernel")
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                       causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0, window: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel of ``ops/csrc/flash_bwd.cu``: narrow
    ``(dk, dv)`` shaped like k and v."""
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    b, sq, h, d, skv, hkv = _kernel_shapes("flash_bwd_dkv_cuda", q, k, v, do)
    lse, delta = _lse_delta(lse, delta, b, h, sq)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load().dstt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale,
                 q.dtype, q.device))
    _build.check(err, "flash_bwd_dkv kernel")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_fwd_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0


# --------------------------------------------------------------------------- #
# raw pieces, autograd function, op backend
# --------------------------------------------------------------------------- #
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset: int = 0, window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the forward kernel on CUDA tensors, the plain version
    on CPU tensors."""
    fn = flash_fwd_cuda if q.device.type == "cuda" else flash_fwd_torch
    return fn(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
              window=window)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset: int = 0, window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the dQ and dK/dV kernels on CUDA tensors (delta =
    rowsum(dO * O) in torch, as JAX computes it in XLA), the plain version
    on CPU tensors."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, window=window)
    if q.device.type != "cuda":
        return flash_bwd_torch(q, k, v, o, lse, do, **kw)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the TPU package's ``_flash`` /
    ``_flash_gqa`` custom VJP): forward saves ``(q, k, v, o, lse)``,
    backward runs the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                      window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


@register("attention", backend="cuda")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None, q_offset: int = 0,
                    window: Optional[int] = None) -> torch.Tensor:
    """Op ``attention`` on CUDA tensors: :class:`FlashAttention`. The
    kernels take no mask; masked attention is ``attention_torch`` (the JAX
    package hands masked calls to XLA, never to its kernel)."""
    if mask is not None:
        raise ValueError("flash_attention takes no mask; call "
                         "ops.attention.attention_torch for masked attention")
    _check_args(causal, window)
    return FlashAttention.apply(q, k, v, causal, scale, q_offset, window)
