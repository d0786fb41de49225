"""MoE layer: gate, dispatch, the expert bank, combine — counterpart of
``deepspeed_tpu/moe/layer.py`` (``init_moe_ffn`` :24, ``moe_ffn_logical_axes``
:42, ``_expert_constraint`` :51, ``MoELayer`` :59).

In one process the layer is the JAX one op for op: ``einsum`` dispatch
contracts the [T, E, C] one-hots (``tec,th->ech`` in, ``tec,ech->th``
out), ``compact`` gathers tokens through an [E, C] token table and
scatter-adds the gated outputs back, with an extra trash row standing in for
JAX's out-of-bounds ``mode="drop"``. The expert SwiGLU bank is one batched
product over E (``torch.bmm``; the JAX package leaves it to XLA, outside any
Pallas kernel), and the Qwen2-MoE shared expert adds a dense SwiGLU scaled
by a sigmoid gate.

Over a process group (``mesh`` with more than one rank on the batch axes)
the layer keeps the JAX semantics, in which the gating sees the whole
batch: the capacity ``ceil(k * T * cf / E)``, the drop priority (token
order over the global batch) and the aux loss (a product of two global
means) are taken over every rank's tokens. Each rank all-gathers the
router logits ([T, E], small) over the batch axes, in the global token
order, and runs the same gating on them; the gather's backward is a
reduce-scatter, so the aux loss's gradient reaches every rank's logits.
A rank then dispatches its own tokens into [E, C_r] slots, C_r the most
kept entries any rank sends one expert (every rank knows it from the
global gating), and the expert-parallel exchange (JAX
``_expert_constraint``) is ``comm.all_to_all`` over ``expert``: chunk j of
the experts goes to expert rank j, which runs its own experts on every
rank's slots and sends the outputs back the same way. Each output row
depends on its own token alone, so the result is JAX's up to the order of
sums. At ``expert == 1`` the exchange is the identity.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..comm import comm
from ..comm.mesh import BATCH_AXES, MeshManager
from ..runtime.partitioning import LeafAxes
from .sharded_moe import dense_combine, expert_positions, top_k_gating_compact

Params = Dict[str, torch.Tensor]

DISPATCHES = ("einsum", "compact")


def moe_ffn_shapes(n_experts: int, hidden: int, intermediate: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """name -> (shape, fan_in) of the expert bank and router, in the JAX
    layout ``x @ W`` (``torch.bmm`` takes the bank so)."""
    e, h, i = n_experts, hidden, intermediate
    return {"router": ((h, e), h), "w_gate": ((e, h, i), h), "w_up": ((e, h, i), h),
            "w_down": ((e, i, h), i)}


@torch.no_grad()
def init_moe_ffn(generator: torch.Generator, n_experts: int, hidden: int,
                 intermediate: int, dtype=torch.float32, device=None) -> Params:
    """Expert SwiGLU bank [E, ...] and router [H, E], N(0, 1/fan_in)."""
    device = generator.device if device is None else device
    return {name: torch.randn(shape, generator=generator, dtype=torch.float32,
                              device=generator.device).mul_(fan_in ** -0.5)
            .to(device=device, dtype=dtype)
            for name, (shape, fan_in) in moe_ffn_shapes(n_experts, hidden, intermediate).items()}


def moe_ffn_logical_axes() -> Dict[str, LeafAxes]:
    return {"router": LeafAxes(("embed", None)),
            "w_gate": LeafAxes(("expert", "embed", "mlp")),
            "w_up": LeafAxes(("expert", "embed", "mlp")),
            "w_down": LeafAxes(("expert", "mlp", "embed"))}


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over the batch axes (rank order = the global
    batch order); backward reduce-scatters the summed grads."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: MeshManager) -> torch.Tensor:
        ctx.mesh = mesh
        return comm.all_gather(x, BATCH_AXES, gather_axis=0, mesh=mesh)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return comm.reduce_scatter(g.contiguous(), BATCH_AXES, scatter_axis=0,
                                   mesh=ctx.mesh), None


class _ExpertExchange(torch.autograd.Function):
    """``comm.all_to_all`` over ``expert``; backward sends the grads back by
    the inverse exchange."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: MeshManager, split: int, concat: int):
        ctx.mesh, ctx.split, ctx.concat = mesh, split, concat
        return comm.all_to_all(x, "expert", split_axis=split, concat_axis=concat, mesh=mesh)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return comm.all_to_all(g.contiguous(), "expert", split_axis=ctx.concat,
                               concat_axis=ctx.split, mesh=ctx.mesh), None, None, None


def _expert_exchange(x: torch.Tensor, mesh: Optional[MeshManager], split: int,
                     concat: int) -> torch.Tensor:
    """The expert-parallel exchange: a no-op at ``expert == 1``."""
    if mesh is None or mesh.ep_world_size <= 1:
        return x
    return _ExpertExchange.apply(x, mesh, split, concat)


def expert_ffn(params: Params, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU bank over [E, C, H] slots, one batched product a matrix."""
    dt = xe.dtype
    g = F.silu(torch.bmm(xe, params["w_gate"].to(dt)))
    u = torch.bmm(xe, params["w_up"].to(dt))
    return torch.bmm(g * u, params["w_down"].to(dt))


class _Dispatch:
    """One assignment's way in and out of the [E, C, H] slots."""

    def __init__(self, mode: str, tokens: torch.Tensor, idx: torch.Tensor,
                 gates: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor, E: int, C: int):
        self.mode, self.E, self.C = mode, E, C
        T, h = tokens.shape
        dev = tokens.device
        if mode == "einsum":
            self.combine = dense_combine(idx, gates, pos, E, C)
            self.expert_in = torch.einsum("tec,th->ech",
                                          (self.combine > 0).to(tokens.dtype), tokens)
            return
        # compact: [E * C] token and gate tables, slot E * C the trash row
        # taking the dropped entries (JAX's out-of-bounds scatter drops them)
        flat = torch.where(keep, idx * C + pos, E * C).reshape(-1)
        t_ids = torch.arange(T, device=dev)[:, None].expand(idx.shape).reshape(-1)
        self.token_for = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev) \
            .scatter(0, flat, t_ids)[:E * C]
        self.w_for = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev) \
            .scatter(0, flat, gates.reshape(-1))[:E * C]
        toks_z = torch.cat([tokens, tokens.new_zeros((1, h))])
        self.expert_in = toks_z[self.token_for].view(E, C, h)

    def combine_out(self, expert_out: torch.Tensor, T: int) -> torch.Tensor:
        dt = expert_out.dtype
        if self.mode == "einsum":
            return torch.einsum("tec,ech->th", self.combine.to(dt), expert_out)
        h = expert_out.shape[-1]
        gated = (expert_out * self.w_for.view(self.E, self.C, 1).to(dt)).reshape(-1, h)
        return expert_out.new_zeros((T + 1, h)).index_add(0, self.token_for, gated)[:T]


class MoELayer:
    """Functional MoE FFN over params from :func:`init_moe_ffn` (and the
    shared expert's ``shared_*`` leaves when present). Returns
    ``(output, aux_loss)``. ``mesh``: the training mesh, whose batch axes
    hold the global batch (None: one process holds it all)."""

    def __init__(self, n_experts: int, top_k: int = 2, capacity_factor: float = 1.25,
                 min_capacity: int = 4, drop_tokens: bool = True, norm_topk: bool = True,
                 dispatch: str = "einsum", mesh: Optional[MeshManager] = None):
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch must be 'einsum' or 'compact', got '{dispatch}'")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor, self.min_capacity = capacity_factor, min_capacity
        self.drop_tokens, self.norm_topk = drop_tokens, norm_topk
        self.dispatch = dispatch
        self.mesh = mesh if mesh is not None and mesh.dp_world_size > 1 else None

    def _gate_kw(self) -> Dict[str, Any]:
        return dict(capacity_factor=self.capacity_factor, min_capacity=self.min_capacity,
                    drop_tokens=self.drop_tokens, norm_topk=self.norm_topk)

    def __call__(self, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [batch, seq, hidden] -> ([batch, seq, hidden], aux_loss)."""
        b, s, h = x.shape
        tokens = x.reshape(b * s, h)
        T, E = tokens.shape[0], self.n_experts
        logits = tokens @ params["router"].to(tokens.dtype)
        if self.mesh is None:
            cg = top_k_gating_compact(logits, self.top_k, **self._gate_kw())
            d = _Dispatch(self.dispatch, tokens, cg.topk_idx, cg.gates, cg.pos, cg.keep, E,
                          cg.capacity)
            out = d.combine_out(expert_ffn(params, d.expert_in), T)
        else:
            out, cg = self._sharded(params, tokens, logits)
        if "shared_w_gate" in params:
            dt = tokens.dtype
            sg = F.silu(tokens @ params["shared_w_gate"].to(dt))
            su = tokens @ params["shared_w_up"].to(dt)
            shared = (sg * su) @ params["shared_w_down"].to(dt)
            out = out + torch.sigmoid(tokens @ params["shared_gate"].to(dt)) * shared
        return out.reshape(b, s, h), cg.aux_loss

    def _sharded(self, params: Params, tokens: torch.Tensor, logits: torch.Tensor):
        """The layer over the batch axes: global gating, this rank's tokens
        dispatched, the exchange over ``expert`` (module docstring)."""
        mm, E = self.mesh, self.n_experts
        T = tokens.shape[0]
        ep = mm.ep_world_size
        if E % ep or params["w_gate"].shape[0] != E // ep:
            raise ValueError(f"{E} experts over expert={ep}: the bank holds "
                             f"{params['w_gate'].shape[0]} on this rank")
        cg = top_k_gating_compact(_GatherRows.apply(logits, mm), self.top_k,
                                  **self._gate_kw())
        n_ranks = cg.topk_idx.shape[0] // T
        r = mm.axis_index(BATCH_AXES)
        rows = slice(r * T, (r + 1) * T)
        idx, gates, keep = cg.topk_idx[rows], cg.gates[rows], cg.keep[rows]
        # kept entries are a prefix of each expert's global order, so a
        # rank's kept entries take its first local slots
        pos = expert_positions(idx, E)
        src = torch.arange(n_ranks, device=idx.device).repeat_interleave(T)
        sent = torch.zeros((n_ranks * E,), dtype=torch.int64, device=idx.device).index_add_(
            0, (src[:, None] * E + cg.topk_idx).reshape(-1), cg.keep.reshape(-1).long())
        C = max(int(sent.max()), 1)
        d = _Dispatch(self.dispatch, tokens, idx, gates, pos, keep, E, C)
        expert_in = _expert_exchange(d.expert_in, mm, 0, 1)        # [E / ep, ep * C, H]
        expert_out = _expert_exchange(expert_ffn(params, expert_in), mm, 1, 0)
        return d.combine_out(expert_out, T), cg

