"""Block-sparse attention — counterpart of ``deepspeed_tpu/ops/sparse_attention.py``
(layout builders :26-67, ``blocksparse_attention`` :81, ``_kernel_vjp`` :111)
and ``deepspeed_tpu/ops/pallas/sparse_attention.py`` (``compact_layout`` :170,
``compact_layout_t`` :193, the three kernels :39-167).

A layout is a static ``[S/bs, S/bs]`` bool matrix over q blocks (rows) and
kv blocks (columns); tokens attend iff their blocks are connected and, when
``causal``, the key is not after the query. The three layout builders
(``fixed``, ``sliding_window``, ``bigbird``) are the JAX package's, byte
for byte (bigbird draws from ``np.random.RandomState(seed)``).

Hand-written kernels replace the three TPU kernels; their wrappers take
CUDA tensors only and count their launches: :func:`sparse_fwd_cuda`
``-> (o, lse)`` and :func:`sparse_bwd_dq_cuda` walk each q block's
compacted list of active kv blocks (:func:`compact_layout`);
:func:`sparse_bwd_dkv_cuda` walks each kv block's transposed list
(:func:`compact_layout_t`), its long columns split over work items by
:func:`dkv_split_plan`, and writes NARROW dK/dV under GQA (the query group
summed in the kernel). The three wrappers route by :func:`sparse_source`:
bf16 at block 128 runs the Hopper kernels of ``ops/csrc/sparse_sm90.cu``
(TMA + wgmma; :func:`sparse_fwd_sm90_cuda` and
:func:`sparse_bwd_dq_sm90_cuda`, a work item per (q block, batch, head) in
:func:`dq_item_order`, and :func:`sparse_bwd_dkv_sm90_cuda`), every other
block and fp32 the ``mma.sync`` / FMA kernels of
``ops/csrc/sparse_attention.cu`` (forward and dQ over the work items of
:func:`mma_items`, which stack the query heads of a kv head). The plain
versions :func:`sparse_fwd_torch` and :func:`sparse_bwd_torch` compute the same
functions densely over the token mask, serve CPU tensors, and are what the
kernels are held against on the card. The compacted lists are cached per
``(layout bytes, causal)`` and uploaded to each device once.

:func:`blocksparse_attention` is the entry point: by default the kernel
path (:class:`BlockSparseAttention`, which needs CUDA tensors; the JAX
package's default on its accelerator), or with ``use_kernel=False`` the
dense-masked plain attention under autograd (the JAX package's XLA path).
Layout ``[B, S, H, D]`` for q, ``[B, S, Hkv, D]`` for k/v.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .attention import attention_torch
from .flash_attention import _bwd_plain_f32, _fwd_plain, tma_check
from .paged_attention import _workspace

# head dims of the block-sparse kernels (the flash kernels also take 96: ROADMAP B.1)
SPARSE_HEAD_DIMS = (32, 64, 128)
BLOCK_SIZES = (16, 32, 64, 128)
SPARSE_SM90, SPARSE_MMA = "sparse_sm90.cu", "sparse_attention.cu"
SM90_BLOCK = 128     # the layout block of sparse_sm90.cu: one work item's q or kv rows
SPLIT_FACTOR = 2     # a work item takes at most this many times the median column's pairs
PLAN_INTS = 8        # int32 fields of a plan entry (PLAN_FIELDS, then padding)
PLAN_FIELDS = ("kv_block", "pair_lo", "pairs", "chunk", "chunks", "slot0", "counter")
# the element types of the block-sparse kernels (0 bf16, 1 fp32): fp16 has
# no block-sparse kernel yet (ROADMAP queue B.2)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
FP16_REFUSAL = ("block-sparse attention has no fp16 CUDA kernel yet (ROADMAP queue B.2): "
                "run it in bf16 or fp32")
# q rows a forward / dQ work item of sparse_attention.cu holds at most (8 warps
# of 16 rows in bf16; 4 in fp32, whose tiles take twice the shared memory)
MMA_ITEM_ROWS = {torch.bfloat16: 128, torch.float32: 64}
ITEM_FIELDS = ("q_block", "part", "head0")   # int32 fields of such an item


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #
def sliding_window_layout(num_blocks: int, window_blocks: int = 3,
                          causal: bool = True) -> np.ndarray:
    lay = np.zeros((num_blocks, num_blocks), bool)
    for i in range(num_blocks):
        lo = max(0, i - window_blocks + 1)
        hi = i + 1 if causal else min(num_blocks, i + window_blocks)
        lay[i, lo:hi] = True
    return lay


def fixed_layout(num_blocks: int, local_blocks: int = 4, stride: int = 4,
                 causal: bool = True) -> np.ndarray:
    """Reference 'fixed' sparsity: local chunks + every stride-th block."""
    lay = np.zeros((num_blocks, num_blocks), bool)
    for i in range(num_blocks):
        chunk = i // local_blocks
        lay[i, chunk * local_blocks:(chunk + 1) * local_blocks] = True
        lay[i, ::stride] = True
    if causal:
        lay &= np.tril(np.ones((num_blocks, num_blocks), bool))
    else:
        lay |= lay.T
    return lay


def bigbird_layout(num_blocks: int, window_blocks: int = 3,
                   global_blocks: int = 1, random_blocks: int = 2,
                   seed: int = 0, causal: bool = False) -> np.ndarray:
    lay = sliding_window_layout(num_blocks, window_blocks, causal=causal)
    lay[:, :global_blocks] = True
    lay[:global_blocks, :] = True
    rs = np.random.RandomState(seed)
    for i in range(num_blocks):
        lay[i, rs.choice(num_blocks, size=min(random_blocks, num_blocks),
                         replace=False)] = True
    if causal:
        lay &= np.tril(np.ones((num_blocks, num_blocks), bool))
    return lay


def compact_layout(layout: np.ndarray, causal: bool) -> Tuple[np.ndarray, np.ndarray]:
    """[nb, nb] bool → (indices [nb, max_active] int32, counts [nb] int32).
    Every q row must keep ≥1 active block (an empty row has no well-defined
    softmax); padded slots repeat the row's last block."""
    lay = np.asarray(layout, bool).copy()
    nb = lay.shape[0]
    if causal:
        lay &= np.tril(np.ones((nb, nb), bool))
    counts = lay.sum(axis=1)
    if (counts == 0).any():
        bad = np.nonzero(counts == 0)[0]
        raise ValueError(
            f"layout rows {bad.tolist()} attend to no kv block"
            f"{' after causal masking' if causal else ''} — softmax over an "
            f"empty row is undefined; give every q block at least one target")
    max_a = int(counts.max())
    idx = np.zeros((nb, max_a), np.int32)
    for i in range(nb):
        act = np.nonzero(lay[i])[0]
        idx[i, :len(act)] = act
        idx[i, len(act):] = act[-1]
    return idx, counts.astype(np.int32)


def compact_layout_t(layout: np.ndarray, causal: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The transposed compaction for dK/dV: row j lists the q blocks that
    attend to kv block j. An empty column is legal (its kv block gets zero
    grads); padded slots repeat the last entry, or 0 for an empty column."""
    lay = np.asarray(layout, bool).copy()
    nb = lay.shape[0]
    if causal:
        lay &= np.tril(np.ones((nb, nb), bool))
    counts = lay.sum(axis=0)
    max_a = max(1, int(counts.max()))
    idx = np.zeros((nb, max_a), np.int32)
    for j in range(nb):
        act = np.nonzero(lay[:, j])[0]
        if len(act):
            idx[j, :len(act)] = act
            idx[j, len(act):] = act[-1]
    return idx, counts.astype(np.int32)


def _check_layout(layout: np.ndarray, s: int, block_size: int) -> np.ndarray:
    if s % block_size:
        raise ValueError(f"seq {s} not divisible by block {block_size}")
    nb = s // block_size
    lay = np.asarray(layout, bool)
    if lay.shape != (nb, nb):
        raise ValueError(f"layout {lay.shape} != ({nb},{nb})")
    return lay


@functools.lru_cache(maxsize=64)
def _compacted(layout_bytes: bytes, nb: int, causal: bool) -> Tuple[np.ndarray, ...]:
    lay = np.frombuffer(layout_bytes, bool).reshape(nb, nb)
    return compact_layout(lay, causal) + compact_layout_t(lay, causal)


def _host_lists(layout: np.ndarray, causal: bool) -> Tuple[np.ndarray, ...]:
    """``(idx, cnt, idx_t, cnt_t)`` numpy, compacted once per ``(layout
    bytes, causal)``; raises :func:`compact_layout`'s ``ValueError`` on a q
    row with no kv block."""
    lay = np.ascontiguousarray(layout, bool)
    return _compacted(lay.tobytes(), lay.shape[0], bool(causal))


@functools.lru_cache(maxsize=64)
def _device_lists(layout_bytes: bytes, nb: int, causal: bool, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in _compacted(layout_bytes, nb, causal))


def layout_lists(layout: np.ndarray, causal: bool, device) -> Tuple[torch.Tensor, ...]:
    """``(idx, cnt, idx_t, cnt_t)`` int32 tensors on ``device``: compacted
    once per ``(layout bytes, causal)`` and uploaded once per device (the
    JAX ``_kernel_vjp``'s cache)."""
    lay = np.ascontiguousarray(layout, bool)
    return _device_lists(lay.tobytes(), lay.shape[0], bool(causal), str(torch.device(device)))


def sparse_source(dtype: torch.dtype, block: int, d: int) -> str:
    """The source under ``ops/csrc/`` whose kernels compute block-sparse
    attention (the forward, dQ and dK/dV alike) at this dtype, layout block
    and head dim: bf16 at block 128 runs ``sparse_sm90.cu`` (TMA + wgmma; a
    work item is one 128-row layout block), bf16 at blocks 16-64 and all of
    fp32 (whose wgmma would be TF32) the ``mma.sync`` / FMA kernels of
    ``sparse_attention.cu``. Raises on what neither takes. A dispatch by
    shape, not a fallback."""
    if dtype == torch.float16:
        raise ValueError(FP16_REFUSAL)
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"block-sparse attention takes bf16 or fp32, not {dtype}")
    if d not in SPARSE_HEAD_DIMS:
        raise ValueError(f"block-sparse attention takes head dim in {SPARSE_HEAD_DIMS}, not {d}")
    if block not in BLOCK_SIZES:
        raise ValueError(f"block-sparse attention: block size {block} not in {BLOCK_SIZES}")
    return SPARSE_SM90 if dtype == torch.bfloat16 and block == SM90_BLOCK else SPARSE_MMA


@functools.lru_cache(maxsize=64)
def _dq_order(layout_bytes: bytes, nb: int, causal: bool) -> np.ndarray:
    _, cnt, _, _ = _compacted(layout_bytes, nb, causal)
    order = np.argsort(-cnt.astype(np.int64), kind="stable").astype(np.int32)
    order.setflags(write=False)
    return order


def dq_item_order(layout: np.ndarray, causal: bool) -> np.ndarray:
    """The q blocks in the order the forward and dQ kernels take them
    (``sparse_sm90.cu``'s, and ``sparse_attention.cu``'s through
    :func:`mma_items`): longest compacted list first (ties by block index),
    cached per ``(layout bytes, causal)``. In ``sparse_sm90.cu`` work item
    ``w`` of a launch over ``batch`` x ``heads`` is q block ``order[w //
    (batch * heads)]`` at ``(batch, head) = divmod(w % (batch * heads),
    heads)``: all heads of a q block together (the kernels' ``DqItem`` and
    ``FwdItem``), dealt by a persistent grid forward and backward in turn."""
    lay = np.ascontiguousarray(layout, bool)
    return _dq_order(lay.tobytes(), lay.shape[0], bool(causal))


@functools.lru_cache(maxsize=64)
def _device_order(layout_bytes: bytes, nb: int, causal: bool, device: str):
    return torch.from_numpy(_dq_order(layout_bytes, nb, causal).copy()).to(device)


def mma_heads_per_item(group: int, block_size: int, dtype: torch.dtype) -> int:
    """Query heads of one kv head that a forward / dQ work item of
    ``sparse_attention.cu`` stacks: the largest divisor of ``group`` whose
    heads, ``min(block_size, 64)`` q rows each, fit ``MMA_ITEM_ROWS``."""
    cap = MMA_ITEM_ROWS[dtype] // min(block_size, 64)
    return max(d for d in range(1, min(group, cap) + 1) if group % d == 0)


@functools.lru_cache(maxsize=64)
def _mma_items(layout_bytes: bytes, nb: int, causal: bool, block_size: int, group: int,
               heads: int) -> np.ndarray:
    order = _dq_order(layout_bytes, nb, causal)
    parts, firsts = block_size // min(block_size, 64), np.arange(0, group, heads)
    items = np.stack([np.repeat(order, parts * len(firsts)),
                      np.tile(np.repeat(np.arange(parts), len(firsts)), len(order)),
                      np.tile(firsts, len(order) * parts)], 1).astype(np.int32)
    items.setflags(write=False)
    return items


def mma_items(layout: np.ndarray, causal: bool, block_size: int, group: int,
              dtype: torch.dtype) -> dict:
    """The work items of ``sparse_attention.cu``'s forward and dQ over one
    layout, cached per ``(layout bytes, causal, block, group, heads an
    item)``. An item holds ``rows = min(block_size, 64)`` q rows (``part``
    of its q block) of ``heads`` (:func:`mma_heads_per_item`) query heads
    of one kv head, from ``head0`` within the group. ``items`` is int32
    ``[entries, 3]``, its fields ``ITEM_FIELDS``, the q blocks longest list
    first (:func:`dq_item_order`). The kernels run each entry once per
    (batch, kv head): work item ``w`` is entry ``w // (batch * kv_heads)``
    at ``(batch, kv head) = divmod(w % (batch * kv_heads), kv_heads)``."""
    lay = np.ascontiguousarray(layout, bool)
    heads = mma_heads_per_item(group, block_size, dtype)
    items = _mma_items(lay.tobytes(), lay.shape[0], bool(causal), int(block_size), int(group),
                       heads)
    return {"items": items, "heads": heads, "rows": min(int(block_size), 64)}


@functools.lru_cache(maxsize=64)
def _device_items(layout_bytes: bytes, nb: int, causal: bool, block_size: int, group: int,
                  heads: int, device: str):
    return torch.from_numpy(
        _mma_items(layout_bytes, nb, causal, block_size, group, heads).copy()).to(device)


@functools.lru_cache(maxsize=64)
def _split_plan(layout_bytes: bytes, nb: int, causal: bool, group: int):
    _, _, _, cnt_t = _compacted(layout_bytes, nb, causal)
    pairs = cnt_t.astype(np.int64) * group
    live = pairs[pairs > 0]
    chunk_pairs = max(1, int(SPLIT_FACTOR * np.median(live))) if len(live) else 1
    entries, slots, split = [], 0, 0
    for kb in range(nb):
        n = int(pairs[kb])
        chunks = max(1, -(-n // chunk_pairs))
        bounds = [n * c // chunks for c in range(chunks + 1)]   # runs within one pair
        slot0, ctr = (slots, split) if chunks > 1 else (-1, -1)
        if chunks > 1:
            slots, split = slots + chunks, split + 1
        entries += [(kb, bounds[c], bounds[c + 1] - bounds[c], c, chunks, slot0, ctr)
                    for c in range(chunks)]
    # longest first (stable: kv block, then chunk order)
    entries.sort(key=lambda e: -e[2])
    plan = np.zeros((len(entries), PLAN_INTS), np.int32)
    plan[:, :len(PLAN_FIELDS)] = np.asarray(entries, np.int64)
    plan.setflags(write=False)
    return plan, chunk_pairs, slots, split


def dkv_split_plan(layout: np.ndarray, causal: bool, group: int) -> dict:
    """The work items of the dK/dV kernels (``sparse_sm90.cu`` and
    ``sparse_attention.cu``) over one layout, cached per ``(layout bytes,
    causal, group)`` like the compacted lists. The plan counts in layout
    blocks, so one plan serves every block size.

    Kv block ``j``'s pairs are ``(query head, listed q block)`` of its
    transposed list (:func:`compact_layout_t`), numbered ``head * cnt_t[j] +
    list position`` for the ``group`` query heads of a kv head. A column of
    more than ``chunk_pairs`` (``SPLIT_FACTOR`` times the median non-empty
    column's pairs) is cut into that many near-equal runs of consecutive
    pairs, its chunks; every other column, an empty one included, is one
    chunk. ``plan`` is int32 ``[entries, PLAN_INTS]``, its fields
    ``PLAN_FIELDS``: kv block, first pair, pair count, chunk, chunks of the
    column, the column's first partial slot and its ticket counter (-1 for a
    column of one chunk), longest entries first. The kernels run each entry
    once per (batch, kv head); a split column's chunks write fp32 partials
    to slots ``slot0 + chunk`` and the last to finish sums them in chunk
    order. ``slots`` and ``split_columns`` size that scratch."""
    lay = np.ascontiguousarray(layout, bool)
    plan, chunk_pairs, slots, split = _split_plan(lay.tobytes(), lay.shape[0], bool(causal),
                                                  int(group))
    return {"plan": plan, "chunk_pairs": chunk_pairs, "slots": slots,
            "split_columns": split}


@functools.lru_cache(maxsize=64)
def _device_plan(layout_bytes: bytes, nb: int, causal: bool, group: int, device: str):
    return torch.from_numpy(_split_plan(layout_bytes, nb, causal, group)[0].copy()).to(device)


def token_mask(layout: np.ndarray, block_size: int, causal: bool, device) -> torch.Tensor:
    """[S, S] bool: the layout's blocks at token level, causal if asked."""
    lay = torch.as_tensor(np.asarray(layout, bool), device=device)
    m = lay.repeat_interleave(block_size, 0).repeat_interleave(block_size, 1)
    if causal:
        m = m & torch.ones_like(m).tril()
    return m


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _chunks(s: int, q_chunk: Optional[int]):
    step = s if q_chunk is None else int(q_chunk)
    return [(r0, min(s, r0 + step)) for r0 in range(0, s, step)]


def sparse_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout: np.ndarray, block_size: int, *, causal: bool = True,
                     scale: Optional[float] = None, q_chunk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse [B * H, S] fp32)`` as the kernel computes them, dense over
    the token mask: fp32 scores, p rounded to v's dtype for P V. With
    ``q_chunk``, ``q_chunk`` query rows at a time (the same rows, with the
    dense scores held for one chunk only)."""
    lay = _check_layout(layout, q.shape[1], block_size)
    _host_lists(lay, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    vis = token_mask(lay, block_size, causal, q.device)
    b, s, h, _ = q.shape
    parts = [_fwd_plain(q[:, r0:r1], k, v, vis[r0:r1], scale)
             for r0, r1 in _chunks(s, q_chunk)]
    o = torch.cat([p[0] for p in parts], 1)
    lse = torch.cat([p[1].reshape(b, h, -1) for p in parts], 2).reshape(b * h, s)
    return o, lse


def sparse_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     layout: np.ndarray, block_size: int, *, causal: bool = True,
                     scale: Optional[float] = None, q_chunk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` as the kernels compute them (p from lse, delta =
    rowsum(dO * O), ds rounded to the inputs' dtype), dK/dV narrow. The
    dK/dV products and their sum over ``q_chunk``-row chunks (all rows at
    once without it) run in fp64, so the chunking changes dK/dV by at most
    their last rounding to the inputs' dtype."""
    lay = _check_layout(layout, q.shape[1], block_size)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    vis = token_mask(lay, block_size, causal, q.device)
    b, s, h, _ = q.shape
    lse = lse.reshape(b, h, s)
    dq, dk, dv = [], 0.0, 0.0
    for r0, r1 in _chunks(s, q_chunk):
        dq_c, dk_c, dv_c, _ = _bwd_plain_f32(
            q[:, r0:r1], k, v, o[:, r0:r1], lse[:, :, r0:r1].reshape(b * h, r1 - r0),
            do[:, r0:r1], vis[r0:r1], scale, acc=torch.float64)
        dq.append(dq_c.to(q.dtype))
        dk, dv = dk + dk_c, dv + dv_c
    return torch.cat(dq, 1), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------- #
def _kernel_args(name: str, q, k, v, layout, block_size, causal, scale, *rest):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if q.dtype == torch.float16:
        raise ValueError(f"{name}: {FP16_REFUSAL}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes bf16 or fp32 inputs, got {q.dtype}")
    for t in (k, v, *rest):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: tensors must share q's device and dtype, got "
                             f"{t.device} {t.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, S, H, D] / [B, S, Hkv, D]")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or d not in SPARSE_HEAD_DIMS or h % hkv:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (head dim in {SPARSE_HEAD_DIMS}, H % Hkv == 0, "
                         f"one sequence length)")
    if block_size not in BLOCK_SIZES:
        raise ValueError(f"{name}: block size {block_size} not in {BLOCK_SIZES}")
    lay = _check_layout(layout, s, block_size)
    for t in (q, k, v, *rest):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    lists = layout_lists(lay, causal, dev)
    return (b, s, h, d, hkv), lists, (
        b, h, hkv, s, d, int(block_size), int(bool(causal)),
        float(d ** -0.5 if scale is None else scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)


def sparse_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    layout: np.ndarray, block_size: int, *, causal: bool = True,
                    scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse forward on the card: ``(o, lse)``. The kernel that
    :func:`sparse_source` names: bf16 at block 128 :func:`sparse_fwd_sm90_cuda`,
    otherwise the forward of ``ops/csrc/sparse_attention.cu``, whose
    launches this function counts."""
    if q.device.type == "cuda" and \
            sparse_source(q.dtype, block_size, q.shape[-1]) == SPARSE_SM90:
        return sparse_fwd_sm90_cuda(q, k, v, layout, block_size, causal=causal, scale=scale)
    name = "sparse_fwd_cuda"
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    (b, s, h, _, hkv), (idx, cnt, _, _), common = _kernel_args(
        name, q, k, v, layout, block_size, causal, scale)
    items, heads = _mma_args(name, layout, causal, block_size, b, h, hkv, q.dtype, q.device)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    err = _build.load().dstt_sparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        idx.data_ptr(), cnt.data_ptr(), items.data_ptr(), idx.shape[1], items.shape[0], heads,
        *common)
    _build.check(err, "sparse_fwd kernel")
    sparse_fwd_cuda.launches += 1
    return o, lse


def sparse_fwd_sm90_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         layout: np.ndarray, block_size: int, *, causal: bool = True,
                         scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward of ``ops/csrc/sparse_sm90.cu`` (bf16, block 128):
    one launch over the (q block, batch, head) work items in
    :func:`dq_item_order`; ``(o, lse)`` as :func:`sparse_fwd_cuda` gives them."""
    name = "sparse_fwd_sm90_cuda"
    (q, k, v), (b, s, h, d, hkv), (idx, cnt, _, _), common = _sm90_args(
        name, q, k, v, layout, block_size, causal, scale)
    order = _item_order(name, layout, causal, b, h, q.device)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    err = _build.load().dstt_sparse_fwd_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        idx.data_ptr(), cnt.data_ptr(), order.data_ptr(), idx.shape[1], b, h, hkv, s, d,
        int(bool(causal)), common[7], common[-1])
    _build.check(err, "sparse_fwd kernel (sparse_sm90.cu)")
    sparse_fwd_sm90_cuda.launches += 1
    return o, lse


def _stats(lse, delta, b, h, s):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b * h, s):
            raise ValueError(f"{name} must be fp32 [{b * h}, {s}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return lse.contiguous(), delta.contiguous()


def sparse_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                       layout: np.ndarray, block_size: int, *, causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse dQ on the card. The kernel that :func:`sparse_source`
    names: bf16 at block 128 :func:`sparse_bwd_dq_sm90_cuda`, otherwise the
    dQ kernel of ``ops/csrc/sparse_attention.cu``, whose launches this
    function counts."""
    if q.device.type == "cuda" and \
            sparse_source(q.dtype, block_size, q.shape[-1]) == SPARSE_SM90:
        return sparse_bwd_dq_sm90_cuda(q, k, v, do, lse, delta, layout, block_size,
                                       causal=causal, scale=scale)
    name = "sparse_bwd_dq_cuda"
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    (b, s, h, _, hkv), (idx, cnt, _, _), common = _kernel_args(
        name, q, k, v, layout, block_size, causal, scale, do)
    lse, delta = _stats(lse, delta, b, h, s)
    items, heads = _mma_args(name, layout, causal, block_size, b, h, hkv, q.dtype, q.device)
    dq = torch.empty_like(q)
    err = _build.load().dstt_sparse_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), idx.data_ptr(), cnt.data_ptr(), items.data_ptr(),
        idx.shape[1], items.shape[0], heads, *common)
    _build.check(err, "sparse_bwd_dq kernel")
    sparse_bwd_dq_cuda.launches += 1
    return dq


def _mma_args(name, layout, causal, block_size, b, h, hkv, dtype, device):
    """``sparse_attention.cu``'s forward / dQ work items (:func:`mma_items`,
    on ``device``) and the heads an item stacks."""
    lay = np.ascontiguousarray(layout, bool)
    heads = mma_heads_per_item(h // hkv, block_size, dtype)
    items = _device_items(lay.tobytes(), lay.shape[0], bool(causal), int(block_size), h // hkv,
                          heads, str(device))
    if items.shape[0] * b * hkv >= 2 ** 31:
        raise ValueError(f"{name}: {items.shape[0] * b * hkv} work items; the kernel counts "
                         "them in 31 bits")
    return items, heads


def _sm90_args(name, q, k, v, layout, block_size, causal, scale, *rest):
    """``sparse_sm90.cu``'s inputs (q, k, v and, for the backward, dO)
    checked as its three wrappers need them."""
    q, k, v, *rest = (t.contiguous() for t in (q, k, v, *rest))
    shape, lists, common = _kernel_args(name, q, k, v, layout, block_size, causal, scale, *rest)
    if q.dtype != torch.bfloat16 or block_size != SM90_BLOCK:
        raise ValueError(f"{name} takes bf16 at block {SM90_BLOCK}, got {q.dtype} at "
                         f"block {block_size} (sparse_source routes those)")
    tma_check(name, q=q, k=k, v=v, **dict(zip(("do",), rest)))
    return (q, k, v, *rest), shape, lists, common


def _item_order(name, layout, causal, b, h, device):
    """:func:`dq_item_order` on ``device``, for a launch of ``b * h`` items a
    q block."""
    lay = np.ascontiguousarray(layout, bool)
    if lay.shape[0] * b * h >= 2 ** 31:
        raise ValueError(f"{name}: {lay.shape[0] * b * h} work items; the kernel counts them "
                         "in 31 bits")
    return _device_order(lay.tobytes(), lay.shape[0], bool(causal), str(device))


def sparse_bwd_dq_sm90_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                            layout: np.ndarray, block_size: int, *, causal: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dQ kernel of ``ops/csrc/sparse_sm90.cu`` (bf16, block
    128): one launch over the (q block, batch, head) work items in
    :func:`dq_item_order`; dq shaped like q."""
    name = "sparse_bwd_dq_sm90_cuda"
    (q, k, v, do), (b, s, h, d, hkv), (idx, cnt, _, _), common = _sm90_args(
        name, q, k, v, layout, block_size, causal, scale, do)
    lse, delta = _stats(lse, delta, b, h, s)
    order = _item_order(name, layout, causal, b, h, q.device)
    dq = torch.empty_like(q)
    err = _build.load().dstt_sparse_bwd_dq_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), idx.data_ptr(), cnt.data_ptr(), order.data_ptr(),
        idx.shape[1], b, h, hkv, s, d, int(bool(causal)), common[7], common[-1])
    _build.check(err, "sparse_bwd_dq kernel (sparse_sm90.cu)")
    sparse_bwd_dq_sm90_cuda.launches += 1
    return dq


def sparse_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                        layout: np.ndarray, block_size: int, *, causal: bool = True,
                        scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse dK/dV on the card: narrow ``(dk, dv)`` shaped like k and
    v. The kernel that :func:`sparse_source` names: bf16 at block 128
    :func:`sparse_bwd_dkv_sm90_cuda`, otherwise the kernel of
    ``ops/csrc/sparse_attention.cu`` (one launch over the work items of
    :func:`dkv_split_plan`), whose launches this function counts."""
    if q.device.type == "cuda" and \
            sparse_source(q.dtype, block_size, q.shape[-1]) == SPARSE_SM90:
        return sparse_bwd_dkv_sm90_cuda(q, k, v, do, lse, delta, layout, block_size,
                                        causal=causal, scale=scale)
    name = "sparse_bwd_dkv_cuda"
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    (b, s, h, d, hkv), (_, _, idx_t, cnt_t), common = _kernel_args(
        name, q, k, v, layout, block_size, causal, scale, do)
    lse, delta = _stats(lse, delta, b, h, s)
    plan, (counters, partials) = _split_args(name, layout, causal, b, h, hkv, d, block_size,
                                             q.device, common[-1], max(1, block_size // 64))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load().dstt_sparse_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), idx_t.data_ptr(),
        cnt_t.data_ptr(), plan.data_ptr(), counters.data_ptr(), partials.data_ptr(),
        idx_t.shape[1], plan.shape[0], *common)
    _build.check(err, "sparse_bwd_dkv kernel")
    sparse_bwd_dkv_cuda.launches += 1
    return dk, dv


def _split_args(name, layout, causal, b, h, hkv, d, block_size, device, stream, parts=1):
    """The dK/dV kernels' plan (:func:`dkv_split_plan`, on ``device``) and
    scratch: ``(plan, (counters, partials))``, the scratch cached per
    (device, stream) and shared with the paged kernel's (a kernel leaves its
    counters at 0). ``parts``: blocks a work item takes (its kv rows in
    64-row parts)."""
    lay = np.ascontiguousarray(layout, bool)
    info = dkv_split_plan(lay, causal, h // hkv)
    plan = _device_plan(lay.tobytes(), lay.shape[0], bool(causal), h // hkv, str(device))
    blocks = plan.shape[0] * b * hkv * parts
    if blocks >= 2 ** 31:
        raise ValueError(f"{name}: {blocks} blocks; the kernel counts them in 31 bits")
    return plan, _workspace(device, stream, info["split_columns"] * b * hkv * 8,
                            info["slots"] * b * hkv * block_size * d * 2)


def sparse_bwd_dkv_sm90_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                             layout: np.ndarray, block_size: int, *, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel of ``ops/csrc/sparse_sm90.cu`` (bf16, block
    128): one launch over the work items of :func:`dkv_split_plan`; narrow
    ``(dk, dv)`` shaped like k and v."""
    name = "sparse_bwd_dkv_sm90_cuda"
    (q, k, v, do), (b, s, h, d, hkv), (_, _, idx_t, cnt_t), common = _sm90_args(
        name, q, k, v, layout, block_size, causal, scale, do)
    lse, delta = _stats(lse, delta, b, h, s)
    stream = common[-1]
    plan, (counters, partials) = _split_args(name, layout, causal, b, h, hkv, d, SM90_BLOCK,
                                             q.device, stream)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load().dstt_sparse_bwd_dkv_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), idx_t.data_ptr(), cnt_t.data_ptr(),
        plan.data_ptr(), counters.data_ptr(), partials.data_ptr(), idx_t.shape[1],
        plan.shape[0], b, h, hkv, s, d, int(bool(causal)), common[7], stream)
    _build.check(err, "sparse_bwd_dkv kernel (sparse_sm90.cu)")
    sparse_bwd_dkv_sm90_cuda.launches += 1
    return dk, dv


@contextlib.contextmanager
def sparse_sm90_planted_fault(fault: int):
    """For the tests that show a check can fail: the launches of
    ``sparse_sm90.cu`` inside the block carry a planted fault. dK/dV: 1 the
    merge of a split column drops its last chunk's partial; 2 each q tile is
    read from the ring stage after its own, before that copy has landed; 3
    the last query head of each GQA group is skipped. dQ: 4 each q block's
    list loses its last entry; 5 each kv tile is read from the ring stage
    after its own; 6 the causal diagonal block's element mask is left out.
    Forward: 7, 8 and 9, the same three faults as 4, 5 and 6."""
    plant = _build.load().dstt_sparse_sm90_plant
    plant(int(fault))
    try:
        yield
    finally:
        plant(0)


@contextlib.contextmanager
def sparse_attention_planted_fault(fault: int):
    """For the tests that show a check can fail: the launches of
    ``sparse_attention.cu`` inside the block carry a planted fault. dK/dV: 1
    the merge of a split column drops its last chunk's partial. Forward: 2
    each step reads K and V from the ring stage after its own, before that
    copy has landed. dQ: 3 the last query head of each work item is left
    out (its dq rows come back zero)."""
    plant = _build.load().dstt_sparse_attention_plant
    plant(int(fault))
    try:
        yield
    finally:
        plant(0)


sparse_fwd_cuda.launches = 0
sparse_fwd_sm90_cuda.launches = 0
sparse_bwd_dq_cuda.launches = 0
sparse_bwd_dq_sm90_cuda.launches = 0
sparse_bwd_dkv_cuda.launches = 0
sparse_bwd_dkv_sm90_cuda.launches = 0


# --------------------------------------------------------------------------- #
# raw pieces, autograd function, entry point
# --------------------------------------------------------------------------- #
def sparse_attention_fwd(q, k, v, layout, block_size, *, causal=True, scale=None):
    """``(o, lse)``: the forward kernel on CUDA tensors, the plain version
    on CPU tensors."""
    fn = sparse_fwd_cuda if q.device.type == "cuda" else sparse_fwd_torch
    return fn(q, k, v, layout, block_size, causal=causal, scale=scale)


def sparse_attention_bwd(q, k, v, o, lse, do, layout, block_size, *, causal=True,
                         scale=None):
    """``(dq, dk, dv)``, dK/dV narrow: the dQ and dK/dV kernels on CUDA
    tensors (delta = rowsum(dO * O) in torch, as JAX computes it in XLA),
    the plain version on CPU tensors."""
    kw = dict(causal=causal, scale=scale)
    if q.device.type != "cuda":
        return sparse_bwd_torch(q, k, v, o, lse, do, layout, block_size, **kw)
    b, s, h, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)
    dq = sparse_bwd_dq_cuda(q, k, v, do, lse, delta, layout, block_size, **kw)
    return (dq, *sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, layout, block_size, **kw))


class BlockSparseAttention(torch.autograd.Function):
    """Differentiable block-sparse attention (the JAX ``_kernel_vjp``
    closure): forward saves ``(q, k, v, o, lse)`` with K/V narrow, backward
    walks the same compacted lists; dK/dV come back narrow."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block_size, causal, scale):
        o, lse = sparse_attention_fwd(q, k, v, layout, block_size, causal=causal,
                                      scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (layout, block_size, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        layout, block_size, causal, scale = ctx.args
        dq, dk, dv = sparse_attention_bwd(q, k, v, o, lse, do.contiguous(), layout,
                                          block_size, causal=causal, scale=scale)
        return dq, dk, dv, None, None, None, None


def _dense_masked(q, k, v, layout, block_size, causal, scale):
    mask = token_mask(layout, block_size, causal, q.device)
    return attention_torch(q, k, v, causal=False, mask=mask[None, None], scale=scale)


def blocksparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          layout: np.ndarray, block_size: int, causal: bool = True,
                          scale: Optional[float] = None,
                          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q/k/v ``[batch, seq, heads, head_dim]`` (K/V may have fewer heads);
    layout ``[q_blocks, kv_blocks]`` (static). Tokens attend iff their
    blocks are connected AND (optionally) causally ordered.

    The kernel path is the default (``use_kernel`` None or True): the three
    CUDA kernels skip inactive blocks in both directions, so compute and
    memory scale with the layout's density; it needs CUDA tensors and raises
    ``RuntimeError`` on others. ``use_kernel=False`` is the dense-masked
    plain attention (the JAX package's XLA path), on any device."""
    lay = _check_layout(layout, q.shape[1], block_size)
    # every q row must keep >= 1 active block (empty-row softmax is undefined)
    _host_lists(lay, causal)
    if use_kernel is False:
        return _dense_masked(q, k, v, lay, block_size, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError("blocksparse_attention's kernel path runs on a CUDA GPU and "
                           f"got {q.device} tensors; pass use_kernel=False for the "
                           "dense-masked plain attention")
    return BlockSparseAttention.apply(q, k, v, lay, block_size, causal, scale)
