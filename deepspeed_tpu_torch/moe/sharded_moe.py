"""Top-k gating for MoE — counterpart of ``deepspeed_tpu/moe/sharded_moe.py``
(``GatingOutput`` :25, ``CompactGating`` :32, ``compute_capacity`` :48,
``top_k_gating_compact`` :54, ``top_k_gating`` :108).

The same routine as the JAX package's: an fp32 softmax over the router
logits, the top-k experts of each token, their gates renormalized (unless
``norm_topk`` is off, Qwen2-MoE's ``norm_topk_prob=False``), positions in
each expert's capacity assigned level by level in token order, a drop past
the capacity, and the load-balancing loss
``E * sum_e mean(probs)_e * mean(top-1 one-hot)_e``.

``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so the choice here is a stable descending
sort (ties keep the lower index first). Every one-hot is a comparison with
``arange`` and every op has a static shape, so the gating runs inside a
captured CUDA graph (the v2 engine's decode).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GatingOutput(NamedTuple):
    combine_weights: torch.Tensor   # [tokens, experts, capacity] fp32
    dispatch_mask: torch.Tensor     # [tokens, experts, capacity] bool
    aux_loss: torch.Tensor          # 0-d load-balancing loss
    router_probs: torch.Tensor      # [tokens, experts]


class CompactGating(NamedTuple):
    """The O(k·T) gating result (no [T, E, C] tensor)."""

    topk_idx: torch.Tensor          # [T, k] int64: chosen expert per level
    gates: torch.Tensor             # [T, k] fp32: gates, 0 where dropped
    pos: torch.Tensor               # [T, k] int64: slot within the expert
    keep: torch.Tensor              # [T, k] bool: survived the capacity
    capacity: int
    aux_loss: torch.Tensor          # 0-d load-balancing loss
    router_probs: torch.Tensor      # [T, E] fp32


def compute_capacity(tokens: int, n_experts: int, k: int,
                     capacity_factor: float, min_capacity: int = 4) -> int:
    cap = int(math.ceil(k * tokens * capacity_factor / n_experts))
    return max(cap, min_capacity)


def one_hot(idx: torch.Tensor, n: int, dtype=torch.int32) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` is a row of zeros."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: values descending, the lower
    index first among equal ones."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_positions(topk_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[T, k] slot of each (token, level) in its expert: levels in turn,
    tokens in order within a level, each level after every earlier level's
    tokens of the same expert (``prior_count``)."""
    levels = []
    prior = torch.zeros((n_experts,), dtype=torch.int64, device=topk_idx.device)
    for level in range(topk_idx.shape[1]):
        idx = topk_idx[:, level]
        oh = one_hot(idx, n_experts, torch.int64)                      # [T, E]
        in_level = torch.cumsum(oh, dim=0) - oh
        levels.append(torch.gather(in_level, 1, idx[:, None])[:, 0] + prior[idx])
        prior = prior + oh.sum(0)
    return torch.stack(levels, dim=1)


def top_k_gating_compact(logits: torch.Tensor, k: int = 1, *,
                         capacity_factor: float = 1.0, min_capacity: int = 4,
                         drop_tokens: bool = True,
                         norm_topk: bool = True) -> CompactGating:
    """logits [tokens, experts] -> the compact assignment (JAX
    ``top_k_gating_compact``); ``drop_tokens=False`` raises the capacity to
    the token count, so nothing is dropped."""
    tokens, n_experts = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topk_probs, topk_idx = top_k(probs, k)
    if norm_topk:
        denom = topk_probs.sum(-1, keepdim=True)
        topk_gates = topk_probs / torch.clamp(denom, min=1e-9)
    else:
        topk_gates = topk_probs
    capacity = compute_capacity(tokens, n_experts, k, capacity_factor, min_capacity)
    if not drop_tokens:
        capacity = max(capacity, tokens)
    pos = expert_positions(topk_idx, n_experts)
    keep = pos < capacity
    me = probs.mean(0)
    ce = one_hot(topk_idx[:, 0], n_experts, torch.float32).mean(0)
    aux_loss = torch.sum(me * ce) * n_experts
    return CompactGating(topk_idx=topk_idx, gates=topk_gates * keep, pos=pos, keep=keep,
                         capacity=capacity, aux_loss=aux_loss, router_probs=probs)


def dense_combine(topk_idx: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
                  n_experts: int, capacity: int) -> torch.Tensor:
    """[T, E, C] fp32 combine weights of a compact assignment; a dropped
    entry has a zero gate and may sit past the capacity (a zero one-hot)."""
    combine = torch.zeros((topk_idx.shape[0], n_experts, capacity), dtype=torch.float32,
                          device=gates.device)
    for level in range(topk_idx.shape[1]):
        combine = combine + (gates[:, level, None, None]
                             * one_hot(topk_idx[:, level], n_experts, torch.float32)[:, :, None]
                             * one_hot(pos[:, level], capacity, torch.float32)[:, None, :])
    return combine


def top_k_gating(logits: torch.Tensor, k: int = 1, *, capacity_factor: float = 1.0,
                 min_capacity: int = 4, drop_tokens: bool = True,
                 norm_topk: bool = True) -> GatingOutput:
    """The dense [T, E, C] view of :func:`top_k_gating_compact`, the form
    the einsum dispatch contracts with."""
    cg = top_k_gating_compact(logits, k, capacity_factor=capacity_factor,
                              min_capacity=min_capacity, drop_tokens=drop_tokens,
                              norm_topk=norm_topk)
    combine = dense_combine(cg.topk_idx, cg.gates, cg.pos, logits.shape[1], cg.capacity)
    return GatingOutput(combine_weights=combine, dispatch_mask=combine > 0,
                        aux_loss=cg.aux_loss, router_probs=cg.router_probs)
