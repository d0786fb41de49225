"""JAX parameter tree → the port's ``state_dict``.

The JAX ``llama.init`` (``deepspeed_tpu/models/llama.py:121-155``) builds a
nested tree with the layer leaves stacked along a leading ``L`` dim and every
matrix kept as ``x @ W`` (``[in, out]``). The port's :class:`~.llama.Llama`
unstacks the layers (``layers.<i>.<name>``) and keeps matrices in
``nn.Linear`` layout ``[out, in]``. :func:`from_jax_params` maps one to the
other, given the tree as numpy arrays (``jax.tree.map(np.asarray, params)``):

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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .llama import LlamaConfig, param_shapes

# matrices the JAX tree keeps as ``x @ W`` and the port as ``nn.Linear``
TRANSPOSED = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                        "lm_head"})


def _to_torch(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact round trip via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))    # a copy: JAX buffers are read-only


def from_jax_params(cfg: LlamaConfig,
                    params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``llama`` params (numpy leaves) → the port's ``state_dict``.
    Raises if the tree does not hold exactly the config's parameters."""
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
    want = param_shapes(cfg)
    if set(out) != set(want):
        raise ValueError(f"param tree does not match the config: missing "
                         f"{sorted(set(want) - set(out))}, unexpected "
                         f"{sorted(set(out) - set(want))}")
    for name, (shape, _) in want.items():
        if tuple(out[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != {shape}")
    return out
