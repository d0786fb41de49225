"""Paged (blocked-KV) attention — counterpart of
``deepspeed_tpu/ops/pallas/paged_attention.py``: one-token decode (op
``paged_decode_attention``) and fused speculative verification (op
``paged_spec_verify_attention``), each over 16-bit pools (bf16 or fp16, q's
dtype) or over int8 code pools with fp32 per-position scales
(``inference.kv_quant``), with bf16 or fp16 q.

Each op has two implementations, chosen by the input's device
(``ops/registry.py``):

- the plain versions, with the semantics of the JAX ``_xla`` references:
  :func:`paged_decode_attention_torch` (``paged_decode_attention_xla``
  :239: gather the pool rows the block table references into a dense view,
  mask positions past ``ctx`` and at or before ``ctx - window``, softmax in
  fp32; in int8 mode scores and probabilities carry the scales at one group
  per vector, the gathered view is dequantized otherwise) and
  :func:`paged_spec_verify_attention_torch`
  (``paged_spec_verify_attention_xla`` :479: the same expressions as the
  multi-token prefill read in ``models/_paged.py``). They serve CPU tensors
  and are the oracles the kernels are held against.
- the wrappers of the hand-written kernel ``ops/csrc/paged_sm90.cu`` (one
  source for both ops, both pool types and both element types; decode is
  its t = 1 case): :func:`paged_decode_attention_cuda` (16-bit pools,
  replacing
  ``_decode_kernel`` :74), :func:`paged_decode_attention_int8_cuda` (int8
  pools, the same kernel's ``quant=True`` mode) and
  :func:`paged_spec_verify_attention_cuda` (both modes, replacing
  ``_spec_verify_kernel`` :315). Each counts its calls that launch the
  kernel in ``.launches``. The kernel cuts each sequence's live positions
  into splits (:func:`split_positions`) and the query rows of a kv head
  into tiles of :data:`ROW_TILE` (:func:`split_plan`); what it does not
  take is refused by :func:`paged_refusal` with ``ValueError``.

Layout (as in the JAX package):
  q            [B, nh, hd] (decode) or [B, t, nh, hd] (verify: row ti sits at
               position ctx + ti)
  k/v pool     [num_blocks, nkv, bs, hd]   (block 0 = trash block), q's
               dtype (bf16 or fp16) or int8 codes
  k/v scale    [num_blocks, nkv, bs, ng]   fp32, int8 mode only (both or
               neither)
  block_tables [B, max_blocks] int32
  context_lens [B] int32 — tokens ALREADY cached; the current tokens' K/V
               are written to the pool before the call.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

from . import _build
from .attention import attention_torch
from .quantization import kv_dequantize_int8
from .registry import register

NEG_INF = -1e30

Window = Optional[Union[int, torch.Tensor]]


def _check_window(window: Window) -> Window:
    """Same ``window >= 1`` contract as the JAX kernel: a static value below
    1 is refused; a tensor is clamped to >= 1."""
    if window is None:
        return None
    if isinstance(window, torch.Tensor):
        if window.numel() != 1:
            raise ValueError(f"window tensor must hold one value, got shape "
                             f"{tuple(window.shape)}")
        return window
    window = int(window)
    if window < 1:
        raise ValueError(f"sliding window must be >= 1, got {window}")
    return window


def _check_scales(k_scale, v_scale) -> bool:
    """True in int8 mode; one scale pool without the other is refused, as
    the JAX kernel asserts (``paged_attention.py:167``)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    return k_scale is not None


def _window_value(window: Window, device):
    """The window as the plain versions compare with it."""
    if isinstance(window, torch.Tensor):
        return window.to(device).long().clamp(min=1)
    return window


def _gathered(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Dense [B, S, nkv, *] view of the pool rows the tables reference."""
    B, max_blocks = tables.shape
    g = pool[tables].transpose(2, 3)           # [B, mb, bs, nkv, *]
    return g.reshape((B, max_blocks * g.shape[2]) + tuple(g.shape[3:]))


@register("paged_decode_attention", backend="torch")
def paged_decode_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 context_lens: torch.Tensor, *,
                                 scale: Optional[float] = None,
                                 window: Window = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Dense-gather reference with the kernel's semantics. Returns
    [B, nh, hd] in q's dtype."""
    quant = _check_scales(k_scale, v_scale)
    B, nh, hd = q.shape
    num_blocks, nkv, bs, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    S = max_blocks * bs
    g = nh // nkv
    window = _check_window(window)
    tables = block_tables.long().clamp(0, num_blocks - 1)
    kv_pos = torch.arange(S, device=q.device)[None, :]
    cl = context_lens.long()[:, None]
    mask = kv_pos <= cl                                   # [B, S]
    if window is not None:
        mask = mask & (kv_pos > cl - _window_value(window, q.device))
    if quant and k_scale.shape[-1] > 1:
        # per-group scales: dequantize the gathered view, then attend
        kg = kv_dequantize_int8(_gathered(k_pool, tables),
                                _gathered(k_scale, tables), q.dtype)
        vg = kv_dequantize_int8(_gathered(v_pool, tables),
                                _gathered(v_scale, tables), q.dtype)
        return attention_torch(q[:, None], kg, vg, causal=False,
                               mask=mask[:, None, None, :], scale=scale)[:, 0]
    scale = hd ** -0.5 if scale is None else scale
    # [B, mb, nkv, bs, hd] -> [B, nkv, S, hd]
    kg = k_pool[tables].permute(0, 2, 1, 3, 4).reshape(B, nkv, S, hd)
    vg = v_pool[tables].permute(0, 2, 1, 3, 4).reshape(B, nkv, S, hd)
    # query head h = kv * g + gi attends kv head h // g
    qg = q.reshape(B, nkv, g, hd).float()
    s = torch.einsum("bngh,bnsh->bngs", qg, kg.float()) * scale
    if quant:
        # one scale per (position, kv head): folded into score space, and
        # the V scale into the probabilities, as the JAX reference does
        ks = k_scale[tables].permute(0, 2, 1, 3, 4).reshape(B, nkv, S)
        vs = v_scale[tables].permute(0, 2, 1, 3, 4).reshape(B, nkv, S)
        s = s * ks[:, :, None, :]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * vs[:, :, None, :]
        out = torch.einsum("bngs,bnsh->bngh", p, vg.float())
    else:
        out = torch.einsum("bngs,bnsh->bngh", p.to(v_pool.dtype).float(),
                           vg.float())
    return out.reshape(B, nh, hd).to(q.dtype)


def _window_args(window: Window, dev):
    """(pointer to a 0-d int32 device tensor or None, static window or 0,
    the tensor behind the pointer, to be held through the launch)."""
    window = _check_window(window)
    if isinstance(window, torch.Tensor):
        if window.device != dev:
            raise ValueError(f"window tensor on {window.device}, q on {dev}")
        window = window.to(torch.int32).reshape(())
        return window.data_ptr(), 0, window
    return None, (window or 0), None


# ``paged_sm90.cu``'s plan: a warp takes 16 positions at a time (a subtile)
# for 16 query rows (a row tile, the M of its mma.sync.m16n8k16); a split of
# a sequence is 4 subtiles at least, 32 at most, and a sequence has about 8
# splits in between
SUBTILE = 16
ROW_TILE = 16
SPLIT_SUBTILES = (4, 32)
SPLIT_TARGET = 8
KERNEL_HD = (64, 128, 256)
# q's dtype -> the kernel's element type code (0 bf16, 2 fp16): P, and code x
# scale at ng > 1, are rounded to q's dtype, as the Pallas kernel rounds them
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 2}


def split_positions(live: int) -> int:
    """Positions of each split of a sequence with ``live`` live positions
    (the last split takes the rest), as the kernel computes it on the
    device from the context length."""
    nsub = -(-max(live, 0) // SUBTILE)
    lo, hi = SPLIT_SUBTILES
    return SUBTILE * min(hi, max(lo, -(-nsub // SPLIT_TARGET)))


def splits_of(live: int) -> int:
    """Splits of a sequence with ``live`` live positions (at least 1)."""
    return max(1, -(-max(live, 0) // split_positions(live)))


def paged_refusal(*, q_dtype, pool_dtype, hd: int, nh: int, nkv: int,
                  ng: int = 0) -> Optional[str]:
    """Why ``paged_sm90.cu`` does not take these types and shapes (``ng``:
    scale groups per vector of int8 pools, 0 for 16-bit pools), or None: q
    bf16 or fp16, with pools of q's dtype or int8 (fp32 pools have no kernel
    yet: ROADMAP queue B.2). Any number of query rows per kv head runs:
    shared memory does not grow with them."""
    if q_dtype not in KERNEL_DTYPES:
        return f"takes bf16 or fp16 q, got {q_dtype}"
    want = torch.int8 if ng else q_dtype
    if pool_dtype != want:
        return (f"takes {'int8' if ng else 'q-dtype'} pools with {q_dtype} q, got "
                f"{pool_dtype}")
    if hd not in KERNEL_HD:
        return f"unsupported head dim {hd} (the kernel takes 64, 128 or 256)"
    if nkv < 1 or nh % nkv:
        return f"unsupported heads: nh={nh} is not a multiple of nkv={nkv}"
    if ng and hd % (16 * ng):
        return (f"{ng} scale groups of a {hd}-lane row: the kernel needs groups of a "
                "multiple of 16 lanes")
    return None


def split_plan(B: int, t: int, nh: int, nkv: int, hd: int, bs: int, max_blocks: int,
               window: Optional[int] = None) -> dict:
    """How ``paged_sm90.cu`` cuts one call: query rows per kv head (``rows``
    = g * t) in ``row_tiles`` of :data:`ROW_TILE`; a sequence's live
    positions (at most the table's ``max_blocks * bs``, or ``window + t -
    1`` with a static window) in at most ``splits`` (:func:`splits_of` of
    any length up to that). The scratch holds, where a sequence can have
    more than one split, fp32 partials (acc, then m and l) for every
    (sequence, split, kv head, row): ``partials`` floats; ``counters`` int32
    tickets, one per (sequence, kv head, row tile). One warp takes each
    (sequence, split, kv head, row tile): at most ``items_max``."""
    rows = nh // nkv * t
    row_tiles = -(-rows // ROW_TILE)
    span = max_blocks * bs
    if window is not None:
        span = min(span, window + t - 1)
    # splits_of is largest at the longest span past lo * SPLIT_TARGET
    # subtiles, and at most SPLIT_TARGET below it
    nsub = -(-span // SUBTILE)
    lo, hi = SPLIT_SUBTILES
    splits = max(1, -(-min(nsub, lo * SPLIT_TARGET) // lo), -(-nsub // hi))
    return {"rows": rows, "row_tiles": row_tiles, "splits": splits,
            "items_max": B * splits * nkv * row_tiles,
            "counters": B * nkv * row_tiles,
            "partials": B * splits * nkv * rows * (hd + 2) if splits > 1 else 0}


# per (device, stream): the ticket counters (zero between calls; the merging
# warp resets its own) and the fp32 partials scratch of this kernel and of
# sparse_sm90.cu's dK/dV (calls on one stream run in turn), grown before a
# launch that needs more
_WORKSPACE: dict = {}


def _workspace(dev, stream: int, counters: int, partials: int):
    key = (dev.index, stream)
    c, p = _WORKSPACE.get(key, (None, None))
    if c is None or c.numel() < counters:
        c = torch.zeros(max(counters, 1024), dtype=torch.int32, device=dev)
    if p is None or p.numel() < partials:
        p = torch.empty(max(partials, 1), dtype=torch.float32, device=dev)
    _WORKSPACE[key] = (c, p)
    return c, p


def workspace_of(dev, stream: int):
    """The (counters, partials) scratch that launches on ``stream`` use now,
    or None before the first. A CUDA graph captured on that stream reads
    these tensors at every replay, so its owner holds them."""
    return _WORKSPACE.get((torch.device(dev).index, stream))


@contextlib.contextmanager
def paged_planted_fault(fault: int):
    """For the tests that show a check can fail: the paged kernel's
    launches inside the block carry a planted fault. 1: the merge drops
    each sequence's last split; 2: each subtile is read from the ring stage
    after its own, before that copy has landed; 3: at one scale group per
    vector the K scale is left out of the scores."""
    plant = _build.load().dstt_paged_sm90_plant
    plant(int(fault))
    try:
        yield
    finally:
        plant(0)


def _check_args(name: str, q, k_pool, v_pool, block_tables, context_lens,
                k_scale, v_scale) -> int:
    """Device, dtype and shape checks of the kernel's wrappers (``q`` is
    [B, t, nh, hd]); returns ``ng`` (0 for bf16 pools)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for arg, x in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
                   ("context_lens", context_lens), ("k_scale", k_scale),
                   ("v_scale", v_scale)):
        if x is not None and x.device != dev:
            raise ValueError(f"{arg} on {x.device}, q on {dev}")
    quant = _check_scales(k_scale, v_scale)
    want = torch.int8 if quant else q.dtype
    if q.dtype not in KERNEL_DTYPES or k_pool.dtype != want or v_pool.dtype != want:
        raise ValueError(f"{name} takes bf16 or fp16 q and {'int8' if quant else 'q-dtype'} "
                         f"pools, got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables and context_lens must be int32")
    B, _, nh, hd = q.shape
    num_blocks, nkv, bs, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or context_lens.shape != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"match batch {B}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if num_blocks * nkv * bs >= 2 ** 31:
        raise ValueError(f"pools of {num_blocks * nkv * bs} rows: the kernel indexes "
                         "rows in 31 bits")
    ng = 0
    if quant:
        ng = k_scale.shape[-1]
        sshape = (num_blocks, nkv, bs, ng)
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or k_scale.shape != sshape or v_scale.shape != sshape:
            raise ValueError(f"scales must be fp32 {sshape}, got {k_scale.dtype} "
                             f"{tuple(k_scale.shape)} / {v_scale.dtype} "
                             f"{tuple(v_scale.shape)}")
        if not (k_scale.is_contiguous() and v_scale.is_contiguous()):
            raise ValueError("scales must be contiguous")
    why = paged_refusal(q_dtype=q.dtype, pool_dtype=k_pool.dtype, hd=hd, nh=nh, nkv=nkv,
                        ng=ng)
    if why:
        raise ValueError(f"{name} {why}")
    return ng


def _launch(q4, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale, window,
            scale, ng: int) -> torch.Tensor:
    """Launch ``paged_sm90.cu`` over q4 [B, t, nh, hd]."""
    dev = q4.device
    q4 = q4.contiguous()
    tables = block_tables.contiguous()
    ctx = context_lens.contiguous()
    window_ptr, window_static, _window = _window_args(window, dev)
    out = torch.empty_like(q4)
    B, t, nh, hd = q4.shape
    if B == 0:
        return out
    num_blocks, nkv, bs, _ = k_pool.shape
    plan = split_plan(B, t, nh, nkv, hd, bs, tables.shape[1], window_static or None)
    if plan["items_max"] >= 2 ** 31:
        raise ValueError(f"{plan['items_max']} work items: the kernel counts them in 31 bits")
    scale = hd ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, partials = _workspace(dev, stream, plan["counters"], plan["partials"])
    err = _build.load().dstt_paged_attention(
        q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if ng else None, v_scale.data_ptr() if ng else None,
        tables.data_ptr(), ctx.data_ptr(), window_ptr, window_static, out.data_ptr(),
        counters.data_ptr(), partials.data_ptr(), B, t, nh, nkv, hd, bs, num_blocks,
        tables.shape[1], ng, plan["splits"], KERNEL_DTYPES[q4.dtype], float(scale), stream)
    _build.check(err, "paged attention kernel (paged_sm90.cu)")
    return out


@register("paged_decode_attention", backend="cuda")
def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                context_lens: torch.Tensor, *,
                                scale: Optional[float] = None,
                                window: Window = None,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Launch ``ops/csrc/paged_sm90.cu`` at t = 1 on pools of q's dtype (bf16
    or fp16). Returns [B, nh, hd] in q's dtype. With ``k_scale``/``v_scale``
    (int8 pools) the int8 mode runs (:func:`paged_decode_attention_int8_cuda`)."""
    if _check_scales(k_scale, v_scale):
        return paged_decode_attention_int8_cuda(
            q, k_pool, v_pool, block_tables, context_lens, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale)
    if q.dim() != 3:
        raise ValueError(f"q must be [B, nh, hd], got {tuple(q.shape)}")
    q4 = q[:, None]
    _check_args("paged_decode_attention_cuda", q4, k_pool, v_pool, block_tables,
                context_lens, None, None)
    out = _launch(q4, k_pool, v_pool, block_tables, context_lens, None, None, window,
                  scale, 0)
    if q.shape[0]:
        paged_decode_attention_cuda.launches += 1
    return out[:, 0]


paged_decode_attention_cuda.launches = 0


def paged_decode_attention_int8_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     context_lens: torch.Tensor, *,
                                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                                     scale: Optional[float] = None,
                                     window: Window = None) -> torch.Tensor:
    """Launch the int8 mode of ``ops/csrc/paged_sm90.cu`` at t = 1 (int8
    code pools, fp32 scales applied in registers). Returns [B, nh, hd] in q's
    dtype (bf16 or fp16)."""
    if k_scale is None or v_scale is None:
        raise ValueError("k_scale and v_scale must be given together")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, nh, hd], got {tuple(q.shape)}")
    q4 = q[:, None]
    ng = _check_args("paged_decode_attention_int8_cuda", q4, k_pool, v_pool,
                     block_tables, context_lens, k_scale, v_scale)
    out = _launch(q4, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale,
                  window, scale, ng)
    if q.shape[0]:
        paged_decode_attention_int8_cuda.launches += 1
    return out[:, 0]


paged_decode_attention_int8_cuda.launches = 0


# --------------------------------------------------------------------------- #
# fused speculative verification (inference.speculative.fused_verify)
# --------------------------------------------------------------------------- #
@register("paged_spec_verify_attention", backend="torch")
def paged_spec_verify_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      block_tables: torch.Tensor,
                                      context_lens: torch.Tensor, *,
                                      scale: Optional[float] = None,
                                      window: Window = None,
                                      k_scale: Optional[torch.Tensor] = None,
                                      v_scale: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """q [B, t, nh, hd], row ti at position ``context_lens + ti`` (its K/V
    already in the pool) → [B, t, nh, hd] in q's dtype. The same expressions
    as the multi-token prefill read of ``models/_paged.py``, so a fused
    verify step on the CPU computes what the unfused one does."""
    quant = _check_scales(k_scale, v_scale)
    B, t, nh, hd = q.shape
    num_blocks, _, bs, _ = k_pool.shape
    S = block_tables.shape[1] * bs
    window = _check_window(window)
    tables = block_tables.long().clamp(0, num_blocks - 1)
    kg = _gathered(k_pool, tables)
    vg = _gathered(v_pool, tables)
    if quant:
        kg = kv_dequantize_int8(kg, _gathered(k_scale, tables), q.dtype)
        vg = kv_dequantize_int8(vg, _gathered(v_scale, tables), q.dtype)
    positions = context_lens.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    kv_pos = torch.arange(S, device=q.device)[None, None, None, :]
    q_abs = positions[:, None, :, None]
    mask = kv_pos <= q_abs
    if window is not None:
        mask = mask & (q_abs - kv_pos < _window_value(window, q.device))
    return attention_torch(q, kg, vg, causal=False, mask=mask, scale=scale)


@register("paged_spec_verify_attention", backend="cuda")
def paged_spec_verify_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     context_lens: torch.Tensor, *,
                                     scale: Optional[float] = None,
                                     window: Window = None,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Launch ``ops/csrc/paged_sm90.cu`` (pools of q's dtype, bf16 or fp16, or
    int8 pools with ``k_scale``/``v_scale``). Returns [B, t, nh, hd] in q's
    dtype."""
    _check_scales(k_scale, v_scale)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, t, nh, hd], got {tuple(q.shape)}")
    ng = _check_args("paged_spec_verify_attention_cuda", q, k_pool, v_pool,
                     block_tables, context_lens, k_scale, v_scale)
    out = _launch(q, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale,
                  window, scale, ng)
    if q.shape[0]:
        paged_spec_verify_attention_cuda.launches += 1
    return out


paged_spec_verify_attention_cuda.launches = 0
