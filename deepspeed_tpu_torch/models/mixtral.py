"""Mixtral family: the Llama backbone with the MoE FFN — counterpart of
``deepspeed_tpu/models/mixtral.py`` (``MixtralConfig`` :39, ``init`` :83,
``param_logical_axes`` :129, ``_head_split`` / ``_head`` :158-171,
``apply`` :174, ``init_cache`` … ``apply_cached`` :231-288, ``loss_fn``
:291, ``tiled_loss_fn`` :303, ``model_spec`` :321, ``init_paged_cache`` /
``apply_paged`` :342-392), with the Qwen2-MoE options (QKV biases,
unnormalized top-k gates, a sigmoid-gated shared expert).

Each block is Llama's attention (RMSNorm, GQA, RoPE; the flash kernels on
CUDA tensors in training) followed by :class:`~..moe.layer.MoELayer`; the
per-layer load-balancing losses are summed and added to the LM loss as
``lm + aux_loss_coef * aux``. Training routes with the config's capacity
and drops; v1 and v2 route with no drop (``drop_tokens=False``: a dropped
decode token would corrupt its completion), as the JAX package does.

Parameter names follow the JAX tree with the layer dim unstacked: the
attention's matrices in ``nn.Linear`` layout ``[out, in]`` (``layers.<i>.wq``)
and the MoE block's leaves ``layers.<i>.moe.<leaf>`` in the JAX layout
``x @ W`` (router ``[h, E]``, bank ``[E, h, i]`` / ``[E, i, h]``, the shared
expert's ``[h, si]`` / ``[si, h]`` / ``[h, 1]``), which ``torch.bmm`` takes as
they are (``models/convert.py``). Under expert parallelism a rank's bank
leaves hold its own experts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..moe.layer import MoELayer, moe_ffn_logical_axes, moe_ffn_shapes
from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from ..runtime.activation_checkpointing import checkpointing as ac
from ..runtime.activation_checkpointing.checkpointing import checkpoint_name
from ..runtime.partitioning import LeafAxes, linear
from ._paged import init_paged_pools, join_kv, layer_kv, paged_attention_step, split_kv
from .llama import _split_batch, _write_cache, cache_mask, remat_policy

# the checkpoint names the training block attaches; the expert matmuls stay
# unnamed, as in the JAX package
CHECKPOINT_NAMES_EMITTED = ("qkv_proj", "attn_mix", "attn_out", "mlp_out")


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    min_capacity: int = 4
    drop_tokens: bool = True
    aux_loss_coef: float = 0.01
    max_seq_len: int = 4096
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-5
    remat: bool = False
    remat_policy: str = "none"  # none | full | dots | any registry policy
    # Qwen2-MoE: QKV biases, raw top-k gates, a sigmoid-gated shared expert
    attention_bias: bool = False
    norm_topk_prob: bool = True
    shared_expert_intermediate_size: int = 0
    moe_dispatch: str = "einsum"  # einsum | compact (moe/layer.py)

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_params(self) -> int:
        h = self.hidden_size
        per_layer = sum(math.prod(s) for s, _ in _layer_shapes(self).values())
        return self.num_layers * per_layer + 2 * self.vocab_size * h + h

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, num_experts=4,
                    top_k=2, max_seq_len=128, rope_theta=10000.0)
        base.update(kw)
        return cls(**base)


def _layer_shapes(cfg: MixtralConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, hd = cfg.hidden_size, cfg.head_size
    nh, nkv, si = cfg.num_heads, cfg.num_kv_heads, cfg.shared_expert_intermediate_size
    shapes = {"attn_norm": ((h,), 0), "wq": ((nh * hd, h), h), "wk": ((nkv * hd, h), h),
              "wv": ((nkv * hd, h), h), "wo": ((h, nh * hd), nh * hd),
              "mlp_norm": ((h,), 0)}
    shapes.update({f"moe.{k}": v for k, v in
                   moe_ffn_shapes(cfg.num_experts, h, cfg.intermediate_size).items()})
    if si:
        shapes.update({"moe.shared_w_gate": ((h, si), h), "moe.shared_w_up": ((h, si), h),
                       "moe.shared_w_down": ((si, h), si), "moe.shared_gate": ((h, 1), h)})
    if cfg.attention_bias:
        shapes.update({"bq": ((nh * hd,), 0), "bk": ((nkv * hd,), 0),
                       "bv": ((nkv * hd,), 0)})
    return shapes


def param_shapes(cfg: MixtralConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name -> (shape, fan_in); vectors with fan_in 0 (norms
    1, biases 0, as in the JAX ``init``)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    shapes = {"embed": ((v, h), h)}
    for l in range(cfg.num_layers):
        shapes.update({f"layers.{l}.{k}": s for k, s in _layer_shapes(cfg).items()})
    shapes["final_norm"] = ((h,), 0)
    shapes["lm_head"] = ((v, h), h)
    return shapes


def param_logical_axes(cfg: MixtralConfig) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes``), per
    layer; the bank's ``expert`` dim is the one expert parallelism splits."""
    per_layer = {"attn_norm": LeafAxes(("embed",)), "wq": linear("heads", "embed"),
                 "wk": linear("kv_heads", "embed"), "wv": linear("kv_heads", "embed"),
                 "wo": linear("embed", "heads"), "mlp_norm": LeafAxes(("embed",)),
                 "bq": LeafAxes(("heads",)), "bk": LeafAxes(("kv_heads",)),
                 "bv": LeafAxes(("kv_heads",)),
                 "moe.shared_w_gate": LeafAxes(("embed", "mlp")),
                 "moe.shared_w_up": LeafAxes(("embed", "mlp")),
                 "moe.shared_w_down": LeafAxes(("mlp", "embed")),
                 "moe.shared_gate": LeafAxes(("embed", None))}
    per_layer.update({f"moe.{k}": v for k, v in moe_ffn_logical_axes().items()})
    axes = {"embed": LeafAxes(("vocab", "embed")), "final_norm": LeafAxes(("embed",)),
            "lm_head": linear("vocab", "embed")}
    return {n: axes[n] if n in axes else per_layer[n.split(".", 2)[2]]
            for n in param_shapes(cfg)}


@torch.no_grad()
def init(cfg: MixtralConfig, generator: torch.Generator, dtype=torch.float32,
         device=None, keep=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution
    (matrices N(0, 1/fan_in), norms 1, biases 0), drawn on the generator's
    device; ``keep(name, leaf)`` as in ``models/llama.py`` ``init``."""
    gen_device = generator.device
    device = gen_device if device is None else device
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, fan_in) in param_shapes(cfg).items():
        if fan_in:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=gen_device).mul_(fan_in ** -0.5)
            out[name] = w.to(device=device, dtype=dtype)
            del w
        elif name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        if keep is not None:
            out[name] = keep(name, out[name])
    return out


def moe_layer(cfg: MixtralConfig, *, drop_tokens: Optional[bool] = None,
              mesh=None) -> MoELayer:
    """The config's MoE layer; inference passes ``drop_tokens=False``."""
    return MoELayer(cfg.num_experts, cfg.top_k, cfg.capacity_factor, cfg.min_capacity,
                    cfg.drop_tokens if drop_tokens is None else drop_tokens,
                    norm_topk=cfg.norm_topk_prob, dispatch=cfg.moe_dispatch, mesh=mesh)


def _moe_leaves(p: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[4:]: v for k, v in p.items() if k.startswith("moe.")}


def _qkv(cfg: MixtralConfig, y: torch.Tensor, w, cos, sin, positions, name: bool):
    """Projections (each marked ``qkv_proj`` in training), RoPE on q and k."""
    b, t, _ = y.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    mark = checkpoint_name if name else (lambda x, _: x)
    q = mark(F.linear(y, w("wq"), w("bq")), "qkv_proj").view(b, t, nh, hd)
    k = mark(F.linear(y, w("wk"), w("bk")), "qkv_proj").view(b, t, nkv, hd)
    v = mark(F.linear(y, w("wv"), w("bv")), "qkv_proj").view(b, t, nkv, hd)
    return apply_rotary(q, cos, sin, positions), apply_rotary(k, cos, sin, positions), v


def _block(cfg: MixtralConfig, x: torch.Tensor, p: Dict[str, torch.Tensor], cos, sin,
           positions, moe: MoELayer) -> Tuple[torch.Tensor, torch.Tensor]:
    """One training block (JAX ``apply``'s ``block``) -> (x, aux)."""
    b, s, _ = x.shape
    w = p.get
    y = rms_norm(x, w("attn_norm"), cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, y, w, cos, sin, positions, name=True)
    attn = checkpoint_name(attention(q, k, v, causal=True), "attn_mix")
    x = x + checkpoint_name(F.linear(attn.reshape(b, s, -1), w("wo")), "attn_out")
    out, aux = moe(_moe_leaves(p), rms_norm(x, w("mlp_norm"), cfg.rms_norm_eps))
    return x + checkpoint_name(out, "mlp_out"), aux


def _block_leaves(cfg: MixtralConfig, params: Mapping[str, torch.Tensor], l: int,
                  compute_dtype) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s leaves, read (ZeRO-3: gathered; v1: dequantized) and
    cast when the block is entered (JAX casts the layers, router included,
    to the compute dtype)."""
    pre = f"layers.{l}."
    return {k: params[pre + k].to(compute_dtype) for k in _layer_shapes(cfg)}


def _head_split(cfg: MixtralConfig, params: Mapping[str, torch.Tensor], x: torch.Tensor,
                compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    x = rms_norm(x, params["final_norm"].to(compute_dtype), cfg.rms_norm_eps)
    return x, params["lm_head"].to(compute_dtype)


def _head(cfg, params, x, compute_dtype) -> torch.Tensor:
    x, head = _head_split(cfg, params, x, compute_dtype)
    return F.linear(x, head).float()


def _batch_mesh():
    """The installed mesh over a process group of more than one rank (the
    MoE layer then gates over the global batch), else None."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    from ..comm.mesh import get_mesh

    return get_mesh()


def apply(cfg: MixtralConfig, params: Mapping[str, torch.Tensor], tokens: torch.Tensor, *,
          positions: Optional[torch.Tensor] = None, compute_dtype=torch.bfloat16,
          return_hidden: bool = False, mesh=None):
    """Training forward -> (logits [b, s, vocab] fp32, summed aux loss);
    with ``return_hidden`` -> (normed hidden, unembedding, aux). ``mesh``
    (default: the installed mesh over a process group) holds the global
    batch the gating sees. With ``cfg.remat`` each block runs under
    ``checkpoint`` with the policy of ``cfg.remat_policy``."""
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                device=x.device)
    moe = moe_layer(cfg, mesh=mesh if mesh is not None else _batch_mesh())

    def block(x, l):
        return _block(cfg, x, _block_leaves(cfg, params, l, compute_dtype), cos, sin,
                      positions, moe)

    policy = remat_policy(cfg.remat_policy)
    auxes = []
    for l in range(cfg.num_layers):
        x, aux = ac.checkpoint(block, x, l, policy=policy) if cfg.remat else block(x, l)
        auxes.append(aux)
    aux = torch.stack(auxes).sum()
    if return_hidden:
        return _head_split(cfg, params, x, compute_dtype) + (aux,)
    return _head(cfg, params, x, compute_dtype), aux


def _metrics(cfg, lm, aux, labels):
    loss = lm + cfg.aux_loss_coef * aux
    return loss, {"loss": loss.detach(), "lm_loss": lm.detach(), "aux_loss": aux.detach(),
                  "ntokens": (labels != -100).sum()}


def loss_fn(cfg: MixtralConfig, params: Mapping[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16):
    """``lm + aux_loss_coef * aux``: next-token cross-entropy in fp32 (mean
    over valid tokens, labels -100 ignored) plus the summed load-balancing
    loss; metrics ``loss`` / ``lm_loss`` / ``aux_loss``."""
    inputs, labels = _split_batch(batch)
    logits, aux = apply(cfg, params, inputs, compute_dtype=compute_dtype)
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                            ignore_index=-100, reduction="sum")
    lm = total / torch.clamp((labels != -100).sum(), min=1)
    return _metrics(cfg, lm, aux, labels)


def tiled_loss_fn(cfg: MixtralConfig, params: Mapping[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16,
                  shards: int = 8):
    """:func:`loss_fn` with the unembedding and the cross-entropy fused a
    sequence tile at a time (``sequence.tiled_loss``); the aux loss is
    added as in :func:`loss_fn`."""
    from ..sequence.tiled import tiled_fused_logits_loss

    inputs, labels = _split_batch(batch)
    hidden, head, aux = apply(cfg, params, inputs, compute_dtype=compute_dtype,
                              return_hidden=True)
    lm = tiled_fused_logits_loss(hidden, head, labels, shards=shards)
    return _metrics(cfg, lm, aux, labels)


def model_spec(cfg: MixtralConfig, compute_dtype=torch.bfloat16):
    """The engine-facing ModelSpec (JAX ``model_spec``; the MoE family has
    no pipeline path, ``pipeline_capable=False`` there)."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="mixtral",
        init_fn=lambda gen, **kw: init(cfg, gen, **kw),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch,
                                              compute_dtype=compute_dtype),
        tiled_loss_fn=lambda params, batch, shards=8: tiled_loss_fn(
            cfg, params, batch, compute_dtype=compute_dtype, shards=shards),
        compute_dtype=compute_dtype,
        logical_axes=param_logical_axes(cfg),
        config=cfg,
    )


# --------------------------------------------------------------------------- #
# v1 dense-cache serving (JAX ``init_cache`` / ``apply_cached``)
# --------------------------------------------------------------------------- #
def init_cache(cfg: MixtralConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Dense KV cache ``{"k", "v"}`` [layers, batch, max_len, kv_heads,
    head_dim] on ``device`` (the GPU unless ``device="cpu"``)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes(cfg: MixtralConfig) -> Dict[str, LeafAxes]:
    spec = LeafAxes(("layers", None, None, "kv_heads", None))
    return {"k": spec, "v": spec}


def apply_cached(cfg: MixtralConfig, params: Mapping[str, torch.Tensor],
                 tokens: torch.Tensor, cache: Dict[str, torch.Tensor], cache_len, *,
                 compute_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill or decode over the dense cache (JAX ``apply_cached``), the
    MoE routing with no drop; the attention is masked, so plain. Returns
    (logits [b, t, vocab] fp32, cache), the cache written in place."""
    b, t = tokens.shape
    cache_len = torch.as_tensor(cache_len, device=tokens.device).long().expand(b)
    x = embedding_lookup(params["embed"], tokens, compute_dtype)
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                device=x.device)
    positions = cache_len[:, None] + torch.arange(t, device=x.device)[None, :]
    moe = moe_layer(cfg, drop_tokens=False)
    mask = cache_mask(cache_len, t, cache["k"].shape[2])
    for l in range(cfg.num_layers):
        p = _block_leaves(cfg, params, l, compute_dtype)
        w = p.get
        q, k, v = _qkv(cfg, rms_norm(x, w("attn_norm"), cfg.rms_norm_eps), w, cos, sin,
                       positions, name=False)
        _write_cache(cache["k"][l], k, cache_len)
        _write_cache(cache["v"][l], v, cache_len)
        attn = attention(q, cache["k"][l], cache["v"][l], causal=False, mask=mask)
        x = x + F.linear(attn.reshape(b, t, -1), w("wo"))
        out, _ = moe(_moe_leaves(p), rms_norm(x, w("mlp_norm"), cfg.rms_norm_eps))
        x = x + out
    return _head(cfg, params, x, compute_dtype), cache


# --------------------------------------------------------------------------- #
# v2 paged serving (JAX ``init_paged_cache`` / ``apply_paged``)
# --------------------------------------------------------------------------- #
def init_paged_cache(cfg: MixtralConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda",
                     kv_quant_group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``{"k", "v"}`` pools ``[L, num_blocks, nkv, block_size, hd]`` (int8
    codes and fp32 scale pools with ``kv_quant_group``)."""
    return init_paged_pools(cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
                            cfg.head_size, dtype, device, kv_quant_group=kv_quant_group)


def _param(shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape))


class MixtralMoE(nn.Module):
    """A block's MoE leaves (``layers.<i>.moe.<leaf>``)."""

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        for name, (shape, _) in _layer_shapes(cfg).items():
            if name.startswith("moe."):
                setattr(self, name[4:], _param(shape))


class MixtralBlock(nn.Module):
    """One block over the paged cache; the MoE routes with no drop, in
    static shapes (no host sync), so the decode graph captures it."""

    def __init__(self, cfg: MixtralConfig, moe: MoELayer):
        super().__init__()
        self.cfg, self._moe = cfg, moe
        for name, (shape, _) in _layer_shapes(cfg).items():
            if not name.startswith("moe."):
                setattr(self, name, _param(shape))
        self.moe = MixtralMoE(cfg)

    def forward(self, x, k_cache, v_cache, block_tables, context_lens, valid, cos, sin,
                positions) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        w = lambda name: getattr(self, name, None)  # noqa: E731
        q, k, v = _qkv(cfg, rms_norm(x, self.attn_norm, cfg.rms_norm_eps), w, cos, sin,
                       positions, name=False)
        attn, _, _ = paged_attention_step(q, k, v, k_cache, v_cache, block_tables,
                                          context_lens, positions, valid)
        x = x + F.linear(attn.reshape(b, t, -1), self.wo)
        out, _ = self._moe(dict(self.moe.named_parameters()),
                           rms_norm(x, self.mlp_norm, cfg.rms_norm_eps))
        return x + out


class Mixtral(nn.Module):
    """The paged-serving Mixtral; ``forward`` is ``apply_paged``. The
    compute dtype is the parameters' dtype."""

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.cfg = cfg
        h, v = cfg.hidden_size, cfg.vocab_size
        moe = moe_layer(cfg, drop_tokens=False)
        self.embed = _param((v, h))
        self.layers = nn.ModuleList(MixtralBlock(cfg, moe) for _ in range(cfg.num_layers))
        self.final_norm = _param((h,))
        self.lm_head = _param((v, h))
        self._rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def rope(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._rope is None or self._rope[0].device != torch.device(device):
            cfg = self.cfg
            self._rope = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta,
                                          device=device)
        return self._rope

    def forward(self, tokens, cache, block_tables, context_lens, valid=None):
        cfg = self.cfg
        b, t = tokens.shape
        if valid is None:
            valid = torch.ones((b, t), dtype=torch.bool, device=tokens.device)
        x = embedding_lookup(self.embed, tokens, self.embed.dtype)
        cos, sin = self.rope(x.device)
        positions = context_lens.long()[:, None] + torch.arange(t, device=x.device)[None, :]
        k_pools, v_pools = split_kv(cache)
        for l, layer in enumerate(self.layers):
            x = layer(x, layer_kv(k_pools, l), layer_kv(v_pools, l), block_tables,
                      context_lens, valid, cos, sin, positions)
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        return F.linear(x, self.lm_head).float(), join_kv(k_pools, v_pools)


def build(cfg: MixtralConfig) -> Mixtral:
    """The module with uninitialised parameters."""
    return Mixtral(cfg)


def apply_paged(cfg: MixtralConfig, model: Mixtral, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], block_tables: torch.Tensor,
                context_lens: torch.Tensor, *, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Functional entry with the JAX ``apply_paged`` signature."""
    if model.cfg != cfg:
        raise ValueError("model was built for another config")
    with torch.no_grad():
        return model(tokens, cache, block_tables, context_lens, valid)
