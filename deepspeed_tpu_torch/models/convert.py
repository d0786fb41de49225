"""JAX parameter tree ↔ the port's ``state_dict``.

The JAX ``llama.init`` (``deepspeed_tpu/models/llama.py:121-155``),
``gpt.init`` (``deepspeed_tpu/models/gpt.py:88-119``) and ``bloom.init``
(``deepspeed_tpu/models/bloom.py:85-114``) build a nested tree
with the layer leaves stacked along a leading ``L`` dim and every matrix kept
as ``x @ W`` (``[in, out]``). The port's modules (:class:`~.llama.Llama`,
:class:`~.gpt.GPT`) unstack the layers (``layers.<i>.<name>``) and keep
matrices in ``nn.Linear`` layout ``[out, in]``. :func:`from_jax_params` maps
one to the other, given the tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), and :func:`to_jax_params` maps back
(numpy leaves, bf16 widened to fp32). The family is the config's type
(``LlamaConfig``, ``GPTConfig`` or ``BloomConfig``). Llama:

=================  ==================  ===========================
JAX leaf           JAX shape           port entry
=================  ==================  ===========================
embed              [v, h]              embed, as is (a lookup table)
layers/wq          [L, h, nh*hd]       layers.<i>.wq, transposed
layers/wk, wv      [L, h, nkv*hd]      layers.<i>.wk / wv, transposed
layers/wo          [L, nh*hd, h]       layers.<i>.wo, transposed
layers/w_gate, up  [L, h, i]           layers.<i>.w_gate / w_up, transposed
layers/w_down      [L, i, h]           layers.<i>.w_down, transposed
layers/*_norm, b*  [L, n]              layers.<i>.<name>, as is
final_norm         [h]                 final_norm, as is
lm_head            [h, v]              lm_head, transposed
=================  ==================  ===========================

GPT-2/OPT: ``layers/wqkv`` ``[L, h, 3h]`` (q | k | v along the output dim),
``wo``, ``w_up``, ``w_down`` and ``lm_head`` (untied only) are transposed;
``embed``, ``pos_embed``, the LayerNorm scales and biases and ``bqkv`` /
``bo`` / ``b_up`` / ``b_down`` go across as they are.

BLOOM: ``layers/wq``, ``wk``, ``wv``, ``wo``, ``w_up`` and ``w_down`` are
transposed; ``embed`` (also the tied head), ``embed_ln_*``, ``final_ln_*``,
the LayerNorm scales and biases and ``bq`` / ``bk`` / ``bv`` / ``bo`` /
``b_up`` / ``b_down`` go across as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from . import bloom, gpt, llama

# matrices the JAX trees keep as ``x @ W`` and the port as ``nn.Linear``
# (every family's names: no other leaf of any shares one)
TRANSPOSED = frozenset({"wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up",
                        "w_down", "lm_head"})


def _param_shapes(cfg: Any):
    """The config's family's ``param_shapes(cfg)``."""
    for family, cfg_type in ((llama, llama.LlamaConfig), (gpt, gpt.GPTConfig),
                             (bloom, bloom.BloomConfig)):
        if isinstance(cfg, cfg_type):
            return family.param_shapes(cfg)
    raise TypeError(f"no model family of the port takes a {type(cfg).__name__}")


def _to_torch(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact round trip via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))    # a copy: JAX buffers are read-only


def from_jax_params(cfg: Any,
                    params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``llama``, ``gpt`` or ``bloom`` params (numpy leaves) → the port's
    ``state_dict``. Raises if the tree does not hold exactly the config's
    parameters."""
    want = _param_shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    layers = params_np["layers"]
    for name, leaf in params_np.items():
        if name == "layers":
            continue
        t = _to_torch(leaf)
        out[name] = t.t().contiguous() if name in TRANSPOSED else t
    for name, stacked in layers.items():
        stacked = _to_torch(stacked)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{name} stacks {stacked.shape[0]} layers, "
                             f"config has {cfg.num_layers}")
        for l in range(cfg.num_layers):
            t = stacked[l]
            out[f"layers.{l}.{name}"] = (t.t() if name in TRANSPOSED else t).contiguous()
    if set(out) != set(want):
        raise ValueError(f"param tree does not match the config: missing "
                         f"{sorted(set(want) - set(out))}, unexpected "
                         f"{sorted(set(out) - set(want))}")
    for name, (shape, _) in want.items():
        if tuple(out[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != {shape}")
    return out


def to_jax_params(cfg: Any,
                  state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` (or a flat param dict) → the JAX family's
    tree with numpy leaves: layer leaves stacked along a leading ``L`` dim,
    matrices back in ``x @ W`` layout. The inverse of
    :func:`from_jax_params`; bf16 leaves come back as fp32 (numpy has no
    bf16), which is exact."""
    want = _param_shapes(cfg)
    if set(state) != set(want):
        raise ValueError(f"state does not match the config: missing "
                         f"{sorted(set(want) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(want))}")

    def np_leaf(name: str, t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.t() if name.rsplit(".", 1)[-1] in TRANSPOSED else t
        return t.contiguous().numpy()

    out: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for name in want:
        if name.startswith("layers."):
            _, l, leaf = name.split(".", 2)
            per_layer.setdefault(leaf, [None] * cfg.num_layers)[int(l)] = \
                np_leaf(name, state[name])
        else:
            out[name] = np_leaf(name, state[name])
    out["layers"] = {leaf: np.stack(ls) for leaf, ls in per_layer.items()}
    return out
