"""The port's ``Partitioner`` (``runtime/partitioning.py``) against the JAX
package's, leaf by leaf, in one process (a mesh of sizes alone).

The JAX trees stack the layers in a leading ``L`` dim and keep ``x @ W``
matrices ``[in, out]``; the port keeps each layer's leaf, matrices
``[out, in]`` (``models/convert.py``). So a JAX spec maps to the port's
by dropping its ``layers`` entry and reversing a transposed matrix's. JAX
shards the stacked ``layers`` dim only when no other dim divides; the port
has no such dim and keeps those leaves replicated: ``LAYERS_FALLBACK``
lists them. Tiny Llama (base, QKV bias, qk_norm, tied), GPT-2 and BLOOM at
ZeRO sizes 2, 4 and 8 and stages 0-3, and a Llama whose hidden 60 divides
by none of 8 at 8 layers, where the fallback happens. Then the
counterparts of JAX ``tests/test_partitioning.py:30-78``.
"""

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.comm.mesh import MeshManager as JaxMesh
from deepspeed_tpu.models import bloom as jbloom
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.partitioning import Partitioner as JaxPartitioner
from deepspeed_tpu_torch.comm.mesh import MeshManager
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import TRANSPOSED
from deepspeed_tpu_torch.runtime.partitioning import Partitioner, shard, shard_dim

INDIVISIBLE = dict(hidden_size=60, num_heads=4, num_kv_heads=2, intermediate_size=120,
                   num_layers=8)
MODELS = {
    "llama": (jl, tl, "LlamaConfig", {}),
    "llama_bias": (jl, tl, "LlamaConfig", {"attention_bias": True}),
    "llama_qk_norm": (jl, tl, "LlamaConfig", {"qk_norm": True}),
    "llama_tied": (jl, tl, "LlamaConfig", {"tie_embeddings": True}),
    "llama_indivisible": (jl, tl, "LlamaConfig", INDIVISIBLE),
    "gpt": (jgpt, tgpt, "GPTConfig", {}),
    "bloom": (jbloom, tbloom, "BloomConfig", {}),
}
# (model, ZeRO size) -> JAX leaves sharded on their stacked layers dim (the
# port keeps them replicated); none elsewhere
LAYERS_FALLBACK = {("llama_indivisible", 8): {"attn_norm", "mlp_norm", "wq", "wk", "wv",
                                              "wo"}}
SPECS = ("param_specs", "grad_specs", "opt_state_specs", "gathered_param_specs")


def _models(name):
    jmod, tmod, cls, kw = MODELS[name]
    return jmod, getattr(jmod, cls).tiny(**kw), tmod, getattr(tmod, cls).tiny(**kw)


def _jax_specs(jmod, cfg, zero, stage, method):
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          jax.eval_shape(lambda: jmod.init(cfg, jax.random.PRNGKey(0))))
    part = JaxPartitioner(JaxMesh.create({"data": zero}, jax.devices()[:zero]), stage)
    return getattr(part, method)(jmod.param_logical_axes(cfg), shapes)


def _port_specs(tmod, cfg, zero, stage, method):
    shapes = {k: s for k, (s, _) in tmod.param_shapes(cfg).items()}
    part = Partitioner(MeshManager.from_sizes({"data": zero}), stage)
    return getattr(part, method)(tmod.param_logical_axes(cfg), shapes)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("zero", [2, 4, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_specs_equal_jax_leaf_by_leaf(model, zero, stage):
    jmod, cfg_j, tmod, cfg_t = _models(model)
    fallback = set()
    for method in SPECS:
        want = _jax_specs(jmod, cfg_j, zero, stage, method)
        got = _port_specs(tmod, cfg_t, zero, stage, method)
        assert set(got) == set(tmod.param_shapes(cfg_t))
        for name, spec in got.items():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("layers."):
                w = tuple(want["layers"][leaf])
                if w[0] is not None:            # JAX shards the stacked dim
                    fallback.add(leaf)
                    assert spec == (None,) * (len(w) - 1), (name, spec)
                    continue
                w = w[1:]
            else:
                w = tuple(want[name])
            if leaf in TRANSPOSED:
                w = w[::-1]
            assert P(*spec) == P(*w), (model, zero, stage, method, name, spec, w)
    assert fallback == LAYERS_FALLBACK.get((model, zero), set()) if stage >= 1 else not fallback


def test_tensor_pipe_and_mics_axes_are_refused():
    """JAX ``test_tp_rules`` shards heads / mlp / vocab over 'tensor'; the
    port has no tensor parallelism yet and refuses such a mesh."""
    for sizes in ({"data": 4, "tensor": 2}, {"data": 4, "pipe": 2}, {"zero_shard": 2}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            Partitioner(MeshManager.from_sizes(sizes), 3)


def test_zero3_param_sharding():
    """JAX ``test_zero3_param_sharding`` at data 4 (without its tensor
    axis): wq's embed dim (the port's dim 1) and the norms shard."""
    part = Partitioner(MeshManager.from_sizes({"data": 4}), 3)
    cfg = tl.LlamaConfig.tiny()
    specs = part.param_specs(tl.param_logical_axes(cfg),
                             {k: s for k, (s, _) in tl.param_shapes(cfg).items()})
    assert specs["layers.0.wq"] == (None, ("data",))
    assert specs["layers.1.attn_norm"] == (("data",),)


def test_zero_stage_progression():
    cfg = tl.LlamaConfig.tiny()
    axes, shapes = tl.param_logical_axes(cfg), {k: s for k, (s, _) in
                                                tl.param_shapes(cfg).items()}
    for stage, flags in {0: (False, False, False), 1: (False, False, True),
                         2: (False, True, True), 3: (True, True, True)}.items():
        part = Partitioner(MeshManager.from_sizes({"data": 8}), stage)
        got = tuple(shard_dim(getattr(part, m)(axes, shapes)["layers.0.wq"]) is not None
                    for m in ("param_specs", "grad_specs", "opt_state_specs"))
        assert got == flags, (stage, got)


def test_no_tensor_axis_drops_tp_rules():
    cfg = tl.LlamaConfig.tiny()
    part = Partitioner(MeshManager.from_sizes({"data": 8}), 0)
    specs = part.param_specs(tl.param_logical_axes(cfg),
                             {k: s for k, (s, _) in tl.param_shapes(cfg).items()})
    assert all(all(e is None for e in s) for s in specs.values())


def test_indivisible_dim_stays_replicated():
    cfg = tl.LlamaConfig.tiny(hidden_size=60, num_heads=4, num_kv_heads=2,
                              intermediate_size=120)
    part = Partitioner(MeshManager.from_sizes({"data": 8}), 3)
    specs = part.param_specs(tl.param_logical_axes(cfg),
                             {k: s for k, (s, _) in tl.param_shapes(cfg).items()})
    assert specs["final_norm"] == (None,)
    assert specs["layers.0.w_down"] == (None, ("data",))     # 120 divides by 8


def test_shards_cover_the_leaf():
    """JAX ``test_sharded_placement_end_to_end``: 8 shards of wq along its
    sharded dim are 1/8 of it each and concatenate back to it."""
    cfg = tl.LlamaConfig.tiny()
    wq = tl.init(cfg, torch.Generator().manual_seed(0))["layers.0.wq"]
    part = Partitioner(MeshManager.from_sizes({"data": 8}), 3)
    spec = part.param_specs(tl.param_logical_axes(cfg),
                            {k: s for k, (s, _) in tl.param_shapes(cfg).items()})["layers.0.wq"]
    dim = shard_dim(spec)
    pieces = [shard(wq, dim, i, 8) for i in range(8)]
    assert pieces[0].shape[dim] == wq.shape[dim] // 8
    np.testing.assert_array_equal(torch.cat(pieces, dim).numpy(), wq.numpy())
    assert P(*[None, ("data",)]) == P(*spec)
