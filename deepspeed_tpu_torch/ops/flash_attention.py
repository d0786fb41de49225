"""Flash attention — counterpart of
``deepspeed_tpu/ops/pallas/flash_attention.py`` (``_flash_fwd`` :361,
``_flash_bwd`` :592, the custom VJPs :736-806, ``flash_attention`` :809).

Three hand-written kernels replace the three TPU kernels:

- the forward (``_fwd_kernel`` :284): ``(o, lse)``; bf16 runs
  ``ops/csrc/flash_fwd_sm90.cu`` (TMA loads, wgmma products), fp32
  ``ops/csrc/flash_fwd.cu`` (FMA products), one entry point routing by
  dtype. TMA reads q, k and v through tensor maps, whose base and strides
  must be multiples of 16 bytes: :func:`tma_refusal` says why a tensor
  cannot be read so, and the bf16 wrapper raises on it;
- ``dq`` (``_bwd_dq_kernel`` :448) and ``dkv`` (``_bwd_dkv_kernel`` :523),
  which writes NARROW dK/dV under GQA (no widen-then-sum): bf16, with or
  without a bias, runs ``ops/csrc/flash_bwd_sm90.cu`` (TMA loads, wgmma
  products, the forward's Hopper design), fp32 ``ops/csrc/flash_bwd.cu``
  (FMA products), as :func:`bwd_source` routes them; the bf16 kernels' q,
  k, v and dO pass :func:`tma_check` first.

Each has a bias mode (``has_bias``, driven by ``_flash_b`` :787): an
additive bf16/fp32 logits bias broadcastable to ``[B, H, Sq, Skv]``, added
after the scale and before the masks, read in place through its strides
(ALiBi's ``[H, 1, Skv]`` is never copied to ``[B * H, Sq, Skv]`` as the
TPU needs it); the dQ kernel also writes ``dbias = p * (dp - delta)``.
The bias mode takes no ``window``: op ``attention`` runs window + bias in
``attention_torch``, as the JAX package runs it in XLA.

Their wrappers take CUDA tensors only and count their launches
(``.launches``), the bias mode on wrappers of its own so a run can show
which mode it went through: :func:`flash_fwd_cuda`,
:func:`flash_bwd_dq_cuda`, :func:`flash_bwd_dkv_cuda` and
:func:`flash_fwd_bias_cuda`, :func:`flash_bwd_dq_bias_cuda`,
:func:`flash_bwd_dkv_bias_cuda`. Beside them are the plain versions
:func:`flash_fwd_torch` and :func:`flash_bwd_torch` (``bias=`` too): the
same functions in PyTorch, which serve CPU tensors and are what the
kernels are held against on the card.

:func:`flash_attention_fwd` ``-> (o, lse)`` and :func:`flash_attention_bwd`
``-> (dq, dk, dv[, dbias])`` are the raw pieces (``sequence/fpdt.py`` and
``sequence/ring.py`` call them in the JAX package); :class:`FlashAttention`
and :class:`FlashAttentionBias` are the autograd functions over them, and
:func:`flash_attention` the ``cuda`` backend of op ``attention``. Each picks
the kernel for CUDA tensors and the plain version for CPU tensors, by the
device of ``q`` alone.

Layout: q/o ``[B, Sq, H, D]``, k/v ``[B, Skv, Hkv, D]`` with ``H % Hkv == 0``
(query head ``h`` reads kv head ``h // (H // Hkv)``; with a bias too, where
the TPU widens K/V), lse ``[B * H, Sq]`` fp32 (the TPU's 128-lane
replication of lse is a Mosaic layout, not kept). Masks: causal with
``q_offset`` (the absolute position of q row 0), a static causal
``window``, and kv length. A row that sees no key gets o = 0 and
lse = -1e30, as the TPU kernel's ``_finish`` does; only these masks make a
row empty: a row whose every key carries a -1e30 bias averages v uniformly,
as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF, attention_torch, widen_kv
from .registry import register

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (32, 64, 128)


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
def _scores(q: torch.Tensor, kw: torch.Tensor, scale: float,
            bias: Optional[torch.Tensor], vis: torch.Tensor) -> torch.Tensor:
    """fp32 ``scale * q k^T (+ bias)`` [B, H, Sq, Skv], -inf where not visible."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kw.float()) * scale
    if bias is not None:
        s = s + bias.float()
    return s.masked_fill(~vis, float("-inf"))


def _fwd_plain(q, k, v, vis, scale, bias=None):
    """The forward over a given [Sq, Skv] (or broadcastable) visibility."""
    b, sq, h, d = q.shape
    kw, vw = widen_kv(k, v, h)
    s = _scores(q, kw, scale, bias, vis)
    m = s.amax(-1, keepdim=True)
    empty = m == float("-inf")
    p = torch.exp(s - torch.where(empty, torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vw.float())
    o = o / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(empty, torch.full_like(m, NEG_INF), m) + torch.log(l_safe)
    return o.to(q.dtype), lse.reshape(b * h, sq)


def _bwd_plain(q, k, v, o, lse, do, vis, scale, bias=None, need_dbias=False):
    """The backward over a given visibility: ``(dq, dk, dv, dbias or None)``."""
    dq, dk, dv, dbias = _bwd_plain_f32(q, k, v, o, lse, do, vis, scale, bias, need_dbias)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _bwd_plain_f32(q, k, v, o, lse, do, vis, scale, bias=None, need_dbias=False,
                   acc=torch.float32):
    """:func:`_bwd_plain` before dq, dk and dv are cast to the inputs' dtype;
    the dK/dV products sum over the query rows in ``acc``."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kw, vw = widen_kv(k, v, h)
    s = _scores(q, kw, scale, bias, vis)
    p = torch.exp(s - lse.reshape(b, h, sq, 1)).masked_fill(~vis, 0.0)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vw.float())
    ds_raw = p * (dp - delta)    # dL/dlogits: the bias gradient
    ds = (ds_raw * scale).to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kw.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), do.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(acc), q.to(acc))
    g = h // hkv
    dk = dk.reshape(b, skv, hkv, g, d).sum(3)
    dv = dv.reshape(b, skv, hkv, g, d).sum(3)
    return dq, dk, dv, ds_raw if need_dbias else None


def flash_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, Sq, H, D] in q's dtype, lse [B * H, Sq] fp32)``, computed as
    the kernel does: fp32 scores (plus ``bias``, broadcastable to
    ``[B, H, Sq, Skv]``, before the masks), p rounded to v's dtype for the
    P V product, normalised by the fp32 row sum."""
    window = _check_args(causal, window)
    d = q.shape[-1]
    vis = _visible(q.shape[1], k.shape[1], causal, q_offset, window, q.device)
    return _fwd_plain(q, k, v, vis, d ** -0.5 if scale is None else scale, bias)


def flash_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None, need_dbias: bool = False):
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse``, as the kernels
    compute them: p recomputed from lse, delta = rowsum(dO * O), ds rounded
    to the inputs' dtype; dK/dV summed over each kv head's query group. With
    ``need_dbias``, ``(dq, dk, dv, dbias)``: dbias = p * (dp - delta) fp32
    ``[B, H, Sq, Skv]``, 0 where nothing is visible."""
    window = _check_args(causal, window)
    d = q.shape[-1]
    vis = _visible(q.shape[1], k.shape[1], causal, q_offset, window, q.device)
    out = _bwd_plain(q, k, v, o, lse, do, vis, d ** -0.5 if scale is None else scale,
                     bias, need_dbias)
    return out if need_dbias else out[:3]


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


def tma_refusal(t: torch.Tensor) -> Optional[str]:
    """Why the bf16 forward's TMA tensor maps cannot read ``t`` as a dense
    ``[B, S, H, D]`` tensor, or None when they can: bf16, head dim in
    ``HEAD_DIMS``, dense row-major strides (a slice of a fused qkv tensor is
    not), a 16-byte aligned base pointer and every stride a multiple of 16
    bytes."""
    if t.dtype != torch.bfloat16:
        return f"dtype {t.dtype}, not bf16"
    if t.dim() != 4 or t.shape[-1] not in HEAD_DIMS:
        return f"shape {tuple(t.shape)} is not [B, S, H, D] with D in {HEAD_DIMS}"
    if not t.is_contiguous():
        return f"strides {t.stride()} are not those of a dense [B, S, H, D] tensor"
    if t.data_ptr() % 16:
        return f"base address {t.data_ptr():#x} is not a multiple of 16 bytes"
    bad = [st * t.element_size() for st in t.stride()[:-1] if st * t.element_size() % 16]
    if bad:
        return f"strides of {bad} bytes are not multiples of 16"
    return None


_NO_BIAS = (None, 0, 0, 0, 0, 0)


def tma_check(name: str, **tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` naming the first of ``tensors`` (label = tensor)
    that TMA cannot read (:func:`tma_refusal`); a refused launch never takes
    another kernel."""
    for label, t in tensors.items():
        why = tma_refusal(t)
        if why is not None:
            raise ValueError(f"{name}: TMA cannot read {label}: {why}")


BWD_SM90, BWD_MMA = "flash_bwd_sm90.cu", "flash_bwd.cu"


def bwd_source(dtype: torch.dtype, d: int) -> str:
    """The source under ``ops/csrc/`` whose dQ and dK/dV kernels serve the
    backward at this dtype and head dim, with or without a bias: bf16 runs
    the Hopper kernels of ``flash_bwd_sm90.cu`` (TMA + wgmma), fp32 (whose
    wgmma would be TF32) the kernels of ``flash_bwd.cu``. Raises on what
    neither takes."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash backward takes bf16 or fp32, not {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash backward takes head dim in {HEAD_DIMS}, not {d}")
    return BWD_SM90 if dtype == torch.bfloat16 else BWD_MMA


def _bias_args(bias: Optional[torch.Tensor], name: str, b: int, h: int, sq: int,
               skv: int, dev) -> tuple:
    """``(pointer, sb, sh, sq, sk, is_fp32)`` of a bias broadcastable to
    ``[B, H, Sq, Skv]``, read in place: a broadcast dimension gets stride 0,
    nothing is copied."""
    if bias is None:
        return _NO_BIAS
    if bias.device != dev:
        raise ValueError(f"{name}: bias on {bias.device}, q on {dev}")
    if bias.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes a bf16 or fp32 bias, got {bias.dtype}")
    try:
        bias4 = bias.expand(b, h, sq, skv)
    except RuntimeError:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not broadcast to "
                         f"[B, H, Sq, Skv] = {(b, h, sq, skv)}") from None
    return (bias4.data_ptr(), *bias4.stride(), _DTYPE_CODE[bias.dtype])   # 1: fp32


def _no_window(name: str, window: Optional[int]) -> None:
    """The bias mode takes no window: the op sends window + bias to
    ``attention_torch``, as the JAX package sends it to XLA."""
    if window is not None:
        raise ValueError(f"{name} takes no window; op attention runs window + bias in "
                         "plain attention")


def _common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale, dtype, dev):
    window = _check_args(causal, window)
    return (b, h, hkv, sq, skv, d, int(q_offset), int(bool(causal)),
            0 if window is None else window,
            float(d ** -0.5 if scale is None else scale), _DTYPE_CODE[dtype])


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_launch(q, k, v, bias, name, causal, scale, q_offset, window):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d, skv, hkv = _kernel_shapes(name, q, k, v)
    if q.dtype == torch.bfloat16:
        tma_check(name, q=q, k=k, v=v)
    ba = _bias_args(bias, name, b, h, sq, skv, q.device)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    err = _build.load().dstt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale,
                 q.dtype, q.device), *ba, _stream(q.device))
    _build.check(err, f"{name} kernel")
    return o, lse


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, scale: Optional[float] = None,
                   q_offset: int = 0, window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel (bf16: ``ops/csrc/flash_fwd_sm90.cu``,
    fp32: ``ops/csrc/flash_fwd.cu``): ``(o, lse)``."""
    out = _fwd_launch(q, k, v, None, "flash_fwd_cuda", causal, scale, q_offset, window)
    flash_fwd_cuda.launches += 1
    return out


def flash_fwd_bias_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, *, causal: bool = True,
                        scale: Optional[float] = None, q_offset: int = 0,
                        window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel in its bias mode: ``(o, lse)``."""
    _no_window("flash_fwd_bias_cuda", window)
    out = _fwd_launch(q, k, v, bias, "flash_fwd_bias_cuda", causal, scale, q_offset, window)
    flash_fwd_bias_cuda.launches += 1
    return out


def _lse_delta(lse: torch.Tensor, delta: torch.Tensor, b: int, h: int, sq: int):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b * h, sq):
            raise ValueError(f"{name} must be fp32 [{b * h}, {sq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return lse.contiguous(), delta.contiguous()


def _bwd_inputs(name, q, k, v, do, lse, delta, bias):
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    shapes = _kernel_shapes(name, q, k, v, do)
    b, sq, h, _, skv, _ = shapes
    lse, delta = _lse_delta(lse, delta, b, h, sq)
    return q, k, v, do, lse, delta, shapes, _bias_args(bias, name, b, h, sq, skv, q.device)


def _sm90(name, q, k, v, do, bias) -> bool:
    """Whether the backward runs ``flash_bwd_sm90.cu`` (with or without
    ``bias``); if so, q, k, v and dO must pass the TMA check, which raises
    rather than take another kernel."""
    if bwd_source(q.dtype, q.shape[-1]) != BWD_SM90:
        return False
    tma_check(name, q=q, k=k, v=v, dO=do)
    return True


def _dq_launch(q, k, v, do, lse, delta, bias, need_dbias, name, causal, scale,
               q_offset, window):
    q, k, v, do, lse, delta, (b, sq, h, d, skv, hkv), ba = _bwd_inputs(
        name, q, k, v, do, lse, delta, bias)
    dq = torch.empty_like(q)
    dbias = (torch.empty(b, h, sq, skv, dtype=torch.float32, device=q.device)
             if need_dbias else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr())
    common = _common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale, q.dtype, q.device)
    lib = _build.load()
    dbias_ptr = None if dbias is None else dbias.data_ptr()
    if not _sm90(name, q, k, v, do, bias):
        err = lib.dstt_flash_bwd_dq(*ptrs, *common, *ba, dbias_ptr, _stream(q.device))
    elif bias is None:
        err = lib.dstt_flash_bwd_dq_sm90(*ptrs, *common[:-1], _stream(q.device))
    else:
        err = lib.dstt_flash_bwd_dq_bias_sm90(*ptrs, *common[:-1], *ba, dbias_ptr,
                                              _stream(q.device))
    _build.check(err, f"{name} kernel")
    return dq, dbias


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      q_offset: int = 0, window: Optional[int] = None
                      ) -> torch.Tensor:
    """Launch the dQ kernel (bf16: ``ops/csrc/flash_bwd_sm90.cu``, fp32:
    ``ops/csrc/flash_bwd.cu``; :func:`bwd_source`)."""
    dq, _ = _dq_launch(q, k, v, do, lse, delta, None, False, "flash_bwd_dq_cuda",
                       causal, scale, q_offset, window)
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dq_bias_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                           bias: torch.Tensor, *, need_dbias: bool = False,
                           causal: bool = True, scale: Optional[float] = None,
                           q_offset: int = 0, window: Optional[int] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the dQ kernel in its bias mode (bf16:
    ``ops/csrc/flash_bwd_sm90.cu``, fp32: ``ops/csrc/flash_bwd.cu``):
    ``(dq, dbias)``, dbias fp32 ``[B, H, Sq, Skv]`` when ``need_dbias``,
    else None (not computed)."""
    _no_window("flash_bwd_dq_bias_cuda", window)
    out = _dq_launch(q, k, v, do, lse, delta, bias, need_dbias, "flash_bwd_dq_bias_cuda",
                     causal, scale, q_offset, window)
    flash_bwd_dq_bias_cuda.launches += 1
    return out


def _dkv_launch(q, k, v, do, lse, delta, bias, name, causal, scale, q_offset, window):
    q, k, v, do, lse, delta, (b, sq, h, d, skv, hkv), ba = _bwd_inputs(
        name, q, k, v, do, lse, delta, bias)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    common = _common(b, h, hkv, sq, skv, d, causal, window, q_offset, scale, q.dtype, q.device)
    lib = _build.load()
    if not _sm90(name, q, k, v, do, bias):
        err = lib.dstt_flash_bwd_dkv(*ptrs, *common, *ba, _stream(q.device))
    elif bias is None:
        err = lib.dstt_flash_bwd_dkv_sm90(*ptrs, *common[:-1], _stream(q.device))
    else:
        err = lib.dstt_flash_bwd_dkv_bias_sm90(*ptrs, *common[:-1], *ba, _stream(q.device))
    _build.check(err, f"{name} kernel")
    return dk, dv


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                       causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0, window: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel (bf16: ``ops/csrc/flash_bwd_sm90.cu``, fp32:
    ``ops/csrc/flash_bwd.cu``; :func:`bwd_source`): narrow ``(dk, dv)``
    shaped like k and v."""
    out = _dkv_launch(q, k, v, do, lse, delta, None, "flash_bwd_dkv_cuda", causal,
                      scale, q_offset, window)
    flash_bwd_dkv_cuda.launches += 1
    return out


def flash_bwd_dkv_bias_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                            bias: torch.Tensor, *, causal: bool = True,
                            scale: Optional[float] = None, q_offset: int = 0,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel in its bias mode (bf16:
    ``ops/csrc/flash_bwd_sm90.cu``, fp32: ``ops/csrc/flash_bwd.cu``): narrow
    ``(dk, dv)``."""
    _no_window("flash_bwd_dkv_bias_cuda", window)
    out = _dkv_launch(q, k, v, do, lse, delta, bias, "flash_bwd_dkv_bias_cuda", causal,
                      scale, q_offset, window)
    flash_bwd_dkv_bias_cuda.launches += 1
    return out


_PLANTS = {"fwd": "dstt_flash_fwd_sm90_plant", "bwd": "dstt_flash_bwd_sm90_plant"}


@contextlib.contextmanager
def sm90_planted_fault(fault: int, kernels: str = "fwd"):
    """For the tests that show a check can fail: the launches inside the
    block of the bf16 forward (``kernels="fwd"``) or of both bf16 backward
    kernels, with or without a bias (``"bwd"``), carry a planted fault. 1:
    each tile after an item's first is read from the ring stage one step
    late; 2: the last tile of each item's band (kv tiles in the forward and
    dQ, q tiles in dK/dV) is dropped; 3 (dK/dV): the last query head of
    each GQA group is skipped; 4 (backward, bias mode): the bias is read
    one 64-row kv tile off (kv row j reads row (j + 64) mod Skv)."""
    plant = getattr(_build.load(), _PLANTS[kernels])
    plant(int(fault))
    try:
        yield
    finally:
        plant(0)


for _fn in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda, flash_fwd_bias_cuda,
            flash_bwd_dq_bias_cuda, flash_bwd_dkv_bias_cuda):
    _fn.launches = 0


# --------------------------------------------------------------------------- #
# raw pieces, autograd functions, op backend
# --------------------------------------------------------------------------- #
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset: int = 0, window: Optional[int] = None,
                        bias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the forward kernel (its bias mode with a ``bias``) on
    CUDA tensors, the plain version on CPU tensors."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, window=window)
    if q.device.type != "cuda":
        return flash_fwd_torch(q, k, v, bias=bias, **kw)
    if bias is None:
        return flash_fwd_cuda(q, k, v, **kw)
    return flash_fwd_bias_cuda(q, k, v, bias, **kw)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset: int = 0, window: Optional[int] = None,
                        bias: Optional[torch.Tensor] = None, need_dbias: bool = False):
    """``(dq, dk, dv)``, or ``(dq, dk, dv, dbias)`` with ``need_dbias``
    (fp32 ``[B, H, Sq, Skv]``): the dQ and dK/dV kernels on CUDA tensors
    (delta = rowsum(dO * O) in torch, as JAX computes it in XLA), the plain
    version on CPU tensors."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, window=window)
    if q.device.type != "cuda":
        return flash_bwd_torch(q, k, v, o, lse, do, bias=bias, need_dbias=need_dbias, **kw)
    b, sq, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
    if bias is None:
        if need_dbias:
            raise ValueError("need_dbias without a bias")
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        return (dq, *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))
    dq, dbias = flash_bwd_dq_bias_cuda(q, k, v, do, lse, delta, bias,
                                       need_dbias=need_dbias, **kw)
    dk, dv = flash_bwd_dkv_bias_cuda(q, k, v, do, lse, delta, bias, **kw)
    return (dq, dk, dv, dbias) if need_dbias else (dq, dk, dv)


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


class FlashAttentionBias(torch.autograd.Function):
    """Flash attention with an additive bias (the TPU package's ``_flash_b``
    custom VJP). The bias is read in place at any broadcast shape; its
    gradient is computed only when autograd asks for it, as the kernel's
    fp32 ``[B, H, Sq, Skv]`` dbias reduced to the bias's shape
    (``sum_to_size``) and cast to its dtype."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, q_offset):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, bias=bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        need_dbias = ctx.needs_input_grad[3]
        out = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), bias=bias,
                                  need_dbias=need_dbias, **ctx.kw)
        dbias = out[3].sum_to_size(bias.shape).to(bias.dtype) if need_dbias else None
        return out[0], out[1], out[2], dbias, None, None, None


@register("attention", backend="cuda")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, q_offset: int = 0,
                    window: Optional[int] = None) -> torch.Tensor:
    """Op ``attention`` on CUDA tensors (the JAX ``flash_attention``):
    :class:`FlashAttention`, or :class:`FlashAttentionBias` with an additive
    ``bias`` (broadcastable to ``[B, H, Sq, Skv]``, differentiable). A
    ``mask``, or a ``window`` with a bias, goes to ``attention_torch``, as
    the JAX package hands those calls to XLA, never to its kernel."""
    if mask is not None or (window is not None and bias is not None):
        return attention_torch(q, k, v, causal=causal, scale=scale, mask=mask,
                               bias=bias, q_offset=q_offset, window=window)
    _check_args(causal, window)
    if bias is not None:
        return FlashAttentionBias.apply(q, k, v, bias, causal, scale, q_offset)
    return FlashAttention.apply(q, k, v, causal, scale, q_offset, window)
