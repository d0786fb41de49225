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

EXAONE-4: ``layers/wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``,
``w_down`` and ``lm_head`` are transposed, as Llama's; ``q_norm`` /
``k_norm`` ``[L, hd]``, ``post_attn_norm`` / ``post_mlp_norm`` ``[L, h]``,
``embed`` and ``final_norm`` go across as they are.

Mixtral (and its Qwen2-MoE options): the attention leaves as Llama's
(``wq``, ``wk``, ``wv``, ``wo`` and ``lm_head`` transposed; the norms and
``bq`` / ``bk`` / ``bv`` as they are); the MoE block, the nested
``layers/moe`` dict, goes across as it is, its matrices kept ``x @ W``:

=====================  =============  ============================
JAX leaf               JAX shape      port entry
=====================  =============  ============================
layers/moe/router      [L, h, E]      layers.<i>.moe.router, as is
layers/moe/w_gate, up  [L, E, h, i]   layers.<i>.moe.w_gate / w_up
layers/moe/w_down      [L, E, i, h]   layers.<i>.moe.w_down
layers/moe/shared_*    [L, h, si] …   layers.<i>.moe.shared_*, as is
=====================  =============  ============================

Falcon: ``layers/wq``, ``wk``, ``wv`` (``[L, h, nkv*hd]``: one kv head
in Falcon-7B), ``wo``, ``w_up``, ``w_down`` and ``lm_head`` (untied only:
the tied head is ``embed``, and there is no ``lm_head`` leaf) are
transposed; ``embed`` and the LayerNorm scales and biases (``ln_attn_*``,
``ln_mlp_*``, ``final_ln_*``) go across as they are.

GPT-NeoX / GPT-J: ``layers/wq``, ``wk``, ``wv``, ``wo``, ``w_up``,
``w_down`` and ``lm_head`` are transposed; ``embed``, the LayerNorm scales
and biases, ``bq`` / ``bk`` / ``bv`` / ``bo`` / ``b_up`` / ``b_down`` and
``lm_head_bias`` go across as they are.

BERT: ``layers/wqkv``, ``wo``, ``w_up`` and ``w_down`` are transposed;
``embed`` (also the tied MLM head), ``pos_embed``, ``type_embed``, the
LayerNorm scales and biases, the block biases and the pooler (``pooler_w``
kept ``x @ W``) go across as they are.

CLIP nests two towers: ``text/layers/wq`` ``[L_t, h, h]`` is
``text.layers.<i>.wq`` (each tower's own layer count), its ``wq``, ``wk``,
``wv``, ``wo``, ``w_up`` and ``w_down`` transposed; ``text/embed``,
``vision/patch_embed`` ``[c*p*p, h]``, ``text_projection``,
``visual_projection``, ``logit_scale`` (0-d) and the rest go across as they
are, a nested key joined by dots (``vision.class_embed``).

:func:`jax_leaf` is the table the optimizers' layout seam reads
(``ops/optimizers.py`` :class:`Layout`): where each port leaf lives in the
JAX tree, for every family.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import bert, bloom, clip, exaone4, falcon, gpt, gptneox, llama, mixtral

# matrices the JAX trees keep as ``x @ W`` and the port as ``nn.Linear``
# (every family's names: no other leaf of any shares one outside a MoE
# block, whose leaves keep the JAX layout, see :func:`is_transposed`)
TRANSPOSED = frozenset({"wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up",
                        "w_down", "lm_head"})
MOE = "moe"   # the nested dict of a Mixtral layer's MoE leaves


def is_transposed(name: str) -> bool:
    """Whether the port keeps leaf ``name`` transposed against the JAX tree:
    a :data:`TRANSPOSED` matrix outside a MoE block."""
    parts = name.split(".")
    return parts[-1] in TRANSPOSED and MOE not in parts[:-1]


def _param_shapes(cfg: Any):
    """The config's family's ``param_shapes(cfg)``."""
    for family, cfg_type in ((llama, llama.LlamaConfig), (gpt, gpt.GPTConfig),
                             (bloom, bloom.BloomConfig),
                             (exaone4, exaone4.Exaone4Config),
                             (mixtral, mixtral.MixtralConfig),
                             (falcon, falcon.FalconConfig),
                             (gptneox, gptneox.GPTNeoXConfig),
                             (bert, bert.BertConfig), (clip, clip.CLIPConfig)):
        if isinstance(cfg, cfg_type):
            return family.param_shapes(cfg)
    raise TypeError(f"no model family of the port takes a {type(cfg).__name__}")


def _layer_at(parts) -> Optional[int]:
    """Index of the ``layers`` part followed by a layer number, or None."""
    for i in range(len(parts) - 1):
        if parts[i] == "layers" and parts[i + 1].isdigit():
            return i
    return None


def jax_leaf(name: str) -> Tuple[str, Optional[int], bool]:
    """Where port leaf ``name`` lives in the JAX tree: (the JAX path,
    '/'-joined as JAX ``utils/tree.py`` joins it, ``layers/wq``; the index
    along its stacked layer dim, None when not stacked; whether the port
    keeps it transposed). The same rule for every family of the port; a
    nested leaf (``layers.<i>.moe.w_gate``, ``text.layers.<i>.wq``) is
    ``layers/moe/w_gate``, ``text/layers/wq``."""
    transposed = is_transposed(name)
    parts = name.split(".")
    i = _layer_at(parts)
    if i is not None:
        return "/".join(parts[:i + 1] + parts[i + 2:]), int(parts[i + 1]), transposed
    return "/".join(parts), None, transposed


def jax_leaves(cfg: Any) -> Dict[str, Tuple[str, Optional[int], bool]]:
    """:func:`jax_leaf` of every parameter of ``cfg``'s family."""
    return {name: jax_leaf(name) for name in _param_shapes(cfg)}


def _to_torch(a: Any) -> torch.Tensor:
    """A view of ``a`` (numpy, or anything ``np.asarray`` takes) as a tensor,
    its memory shared where it can be: callers copy what they keep."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact round trip via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    with warnings.catch_warnings():  # JAX buffers are read-only: never written here
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def _own(t: torch.Tensor, transpose: bool) -> torch.Tensor:
    """A contiguous copy of ``t`` (of its transpose), in one pass on all the
    host's cores."""
    return (t.t() if transpose else t).clone(memory_format=torch.contiguous_format)


def _flat_tree(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    """(path parts, leaf) of every leaf of a nested dict tree."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat_tree(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_params(cfg: Any,
                    params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX family's params (numpy leaves; nested dicts such as a MoE
    layer's ``moe`` or CLIP's towers too) → the port's ``state_dict``: each
    ``layers`` leaf unstacked along its leading dim. Raises if the tree does
    not hold exactly the config's parameters."""
    want = _param_shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    for parts, leaf in _flat_tree(params_np):
        t = _to_torch(leaf)
        if "layers" not in parts:
            name = ".".join(parts)
            out[name] = _own(t, is_transposed(name))
            continue
        i = parts.index("layers")
        head, rest = ".".join(parts[:i + 1]), ".".join(parts[i + 1:])
        n_layers = len({k.split(".")[i + 1] for k in want
                        if k.startswith(head + ".") and _layer_at(k.split(".")) == i})
        if t.shape[0] != n_layers:
            raise ValueError(f"{'/'.join(parts)} stacks {t.shape[0]} layers, "
                             f"config has {n_layers}")
        for l in range(n_layers):
            name = f"{head}.{l}.{rest}"
            out[name] = _own(t[l], is_transposed(name))
    # the leaves outside the layers first, then the layers' a leaf name at a
    # time (the order the engine has always been handed them in)
    out = dict(sorted(out.items(), key=lambda kv: _layer_at(kv[0].split(".")) is not None))
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
        t = t.t() if is_transposed(name) else t
        return t.contiguous().numpy()

    out: Dict[str, Any] = {}
    by_path: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name in want:
        path, layer, _ = jax_leaf(name)
        leaf = np_leaf(name, state[name])
        if layer is None:
            by_path[tuple(path.split("/"))] = {None: leaf}
        else:
            by_path.setdefault(tuple(path.split("/")), {})[layer] = leaf
    for parts, leaves in by_path.items():
        d = out
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = leaves[None] if None in leaves else \
            np.stack([leaves[l] for l in sorted(leaves)])
    return out
