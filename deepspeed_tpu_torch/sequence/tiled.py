"""Tiled computation over the sequence dimension — counterpart of
``deepspeed_tpu/sequence/tiled.py`` (``sequence_tiled_compute`` :43,
``tiled_mlp`` :67, ``tiled_fused_logits_loss`` :77, the ``TiledMLP`` /
``TiledFusedLogitsLoss`` shims :131-150).

A position-wise function (an MLP, the logits and their loss) runs one
sequence tile at a time, each tile a loop step under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: only one
tile's activations are live in the forward, and the backward recomputes the
tiles one by one. :func:`tiled_fused_logits_loss` never holds the whole
``[B, S, V]`` logits, only one ``[B, S/shards, V]`` tile of them.

As in the JAX package the loss head computes in fp32: the unembedding is cast
once per call (not once per tile), so its fp32 copy and that copy's grad are
live for the whole loss. The unembedding is ``[V, H]``, the ``nn.Linear``
layout of the port's heads (the JAX function takes ``[H, V]``). ``S`` must
divide by ``shards``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def _tiles(x: torch.Tensor, shards: int, axis: int):
    S = x.shape[axis]
    if S % shards:
        raise ValueError(f"seq {S} not divisible by {shards} tiles")
    return x.split(S // shards, dim=axis)


def sequence_tiled_compute(fn: Callable, x: torch.Tensor, *fn_args, shards: int,
                           seq_axis: int = 1, remat: bool = True) -> torch.Tensor:
    """``fn(x_tile, *fn_args)`` on each sequence tile of ``x``, the results
    concatenated along ``seq_axis`` (the reference's
    ``SequenceTiledCompute``)."""
    if shards <= 1:
        return fn(x, *fn_args)
    if remat:
        out = [checkpoint(fn, t, *fn_args, use_reentrant=False)
               for t in _tiles(x, shards, seq_axis)]
    else:
        out = [fn(t, *fn_args) for t in _tiles(x, shards, seq_axis)]
    return torch.cat(out, dim=seq_axis)


def tiled_mlp(mlp_fn: Callable, params: Any, x: torch.Tensor, *, shards: int = 4,
              seq_axis: int = 1, remat: bool = True) -> torch.Tensor:
    """The reference's ``TiledMLP``: ``mlp_fn(params, x)`` a sequence tile
    at a time."""
    return sequence_tiled_compute(lambda t: mlp_fn(params, t), x, shards=shards,
                                  seq_axis=seq_axis, remat=remat)


def _tile_loss(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor], ignore_index: int,
               soft_cap: Optional[float]):
    """Summed NLL and the count of counted positions of one tile: h
    ``[B, s, H]``, w the fp32 ``[V, H]`` unembedding."""
    logits = torch.matmul(h.float(), w.t())
    if bias is not None:
        logits = logits + bias
    if soft_cap is not None:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    picked = logits.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return nll.sum(), valid.sum()


def tiled_fused_logits_loss(hidden: torch.Tensor, unembed: torch.Tensor,
                            labels: torch.Tensor, *, shards: int = 8,
                            ignore_index: int = -100,
                            logit_soft_cap: Optional[float] = None,
                            bias: Optional[torch.Tensor] = None,
                            reduction: str = "mean") -> torch.Tensor:
    """Cross-entropy over the vocabulary without the ``[B, S, V]`` logits
    (the reference's ``TiledFusedLogitsLoss``). hidden ``[B, S, H]``;
    unembed ``[V, H]``; labels ``[B, S]``, positions equal to
    ``ignore_index`` not counted; ``bias`` an optional ``[V]`` logit bias.
    Returns the mean NLL over counted positions (``reduction="sum"``: the
    sum), in fp32."""
    w = unembed.float()
    b = None if bias is None else bias.float()
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for h_t, l_t in zip(_tiles(hidden, shards, 1), _tiles(labels, shards, 1)):
        loss_t, n_t = checkpoint(_tile_loss, h_t, l_t, w, b, ignore_index,
                                 logit_soft_cap, use_reentrant=False)
        total = total + loss_t
        count = count + n_t
    if reduction == "sum":
        return total
    return total / count.clamp(min=1).float()


class TiledMLP:
    """The reference's class name over :func:`tiled_mlp`."""

    def __init__(self, mlp_fn: Callable, params: Any, shards: int = 4):
        self.mlp_fn, self.params, self.shards = mlp_fn, params, shards

    def __call__(self, x):
        return tiled_mlp(self.mlp_fn, self.params, x, shards=self.shards)


class TiledFusedLogitsLoss:
    """The reference's class name over :func:`tiled_fused_logits_loss`."""

    def __init__(self, unembed: torch.Tensor, shards: int = 8, ignore_index: int = -100):
        self.unembed, self.shards = unembed, shards
        self.ignore_index = ignore_index

    def __call__(self, hidden, labels):
        return tiled_fused_logits_loss(hidden, self.unembed, labels, shards=self.shards,
                                       ignore_index=self.ignore_index)
