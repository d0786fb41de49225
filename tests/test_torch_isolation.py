"""The PyTorch port stands alone: it imports neither ``jax`` nor
``deepspeed_tpu``, runs on the GPU unless the CPU is asked for, and refuses
features it has not ported instead of ignoring them (``kv_quant`` and
``speculative`` are ported and build)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu_torch.inference import InferenceConfig, build_engine_v2
import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import modules
from deepspeed_tpu_torch.models import gpt, llama

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def _tiny_params():
    cfg = llama.LlamaConfig.tiny()
    return cfg, llama.init(cfg, torch.Generator().manual_seed(0))


def test_default_device_is_the_gpu():
    cfg, params = _tiny_params()
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine_v2(llama, cfg, params, config={"dtype": "float32"})
    eng = build_engine_v2(llama, cfg, params, config={"dtype": "float32"},
                          device="cpu")
    assert eng.model.embed.device.type == "cpu"


def test_pools_default_to_the_gpu():
    cfg = llama.LlamaConfig.tiny()
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_paged_cache(cfg, 4, 8)
    cache = llama.init_paged_cache(cfg, 4, 8, device="cpu")
    assert {t.device.type for t in cache.values()} == {"cpu"}
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_paged_cache(cfg, 4, 8, kv_quant_group=8)
    cache = llama.init_paged_cache(cfg, 4, 8, device="cpu", kv_quant_group=8)
    assert {t.device.type for t in cache.values()} == {"cpu"}


def test_gpt_entry_points_default_to_the_gpu():
    """The GPT family's engine, pools and trainer run on the card unless the
    CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    cfg = gpt.GPTConfig.tiny()
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine_v2(gpt, cfg, params, config={"dtype": "float32"})
    eng = build_engine_v2(gpt, cfg, params, config={"dtype": "float32"}, device="cpu")
    assert eng.model.pos_embed.device.type == "cpu"
    for kw in ({}, {"kv_quant_group": 8}):
        with pytest.raises(RuntimeError, match="CUDA"):
            gpt.init_paged_cache(cfg, 4, 8, **kw)
        cache = gpt.init_paged_cache(cfg, 4, 8, device="cpu", **kw)
        assert {t.device.type for t in cache.values()} == {"cpu"}
    conf = {"train_batch_size": 1, "steps_per_print": 0}
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=gpt.model_spec(cfg), config=conf)
    eng, *_ = deepspeed_tpu_torch.initialize(model=gpt.model_spec(cfg), config=conf,
                                             device="cpu")
    assert {p.device.type for p in eng.state.params.values()} == {"cpu"}


def test_gpt_card_path_refuses_dtypes_without_a_kernel(monkeypatch):
    cfg = gpt.GPTConfig.tiny()
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="bfloat16"):
        build_engine_v2(gpt, cfg, params, config={"dtype": "float32"}, device="cuda")


def test_new_modules_are_covered_by_the_import_checks():
    mods = _port_modules()
    for name in ("deepspeed_tpu_torch.models.gpt", "deepspeed_tpu_torch.inference.modules",
                 "deepspeed_tpu_torch.models.bloom", "deepspeed_tpu_torch.ops.evoformer_attn",
                 "deepspeed_tpu_torch.ops.sparse_attention",
                 "deepspeed_tpu_torch.telemetry.trace", "deepspeed_tpu_torch.telemetry.fleet",
                 "deepspeed_tpu_torch.testing.faults", "deepspeed_tpu_torch.tuning",
                 "deepspeed_tpu_torch.inference.serving",
                 "deepspeed_tpu_torch.inference.serving.scheduler",
                 "deepspeed_tpu_torch.inference.serving.router",
                 "deepspeed_tpu_torch.inference.serving.fleet",
                 "deepspeed_tpu_torch.inference.serving.disagg",
                 "deepspeed_tpu_torch.inference.serving.workload"):
        assert name in mods
    # the module system resolves on CPU tensors without building anything
    norm = modules.registry.instantiate("norm", modules.NormConfig(kind="layer"))
    assert norm(torch.ones(2, 8), torch.ones(8), torch.zeros(8)).abs().max() == 0


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_card_path_refuses_dtypes_without_a_kernel(dtype, monkeypatch):
    # the CUDA device check passes; the dtype check must refuse before any
    # weight or pool lands on the card
    cfg, params = _tiny_params()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="bfloat16"):
        build_engine_v2(llama, cfg, params, config={"dtype": dtype}, device="cuda")


UNPORTED = {
    "prefix_cache.host_spill": {"prefix_cache": {"enabled": True, "host_spill": True}},
    "quant": {"quant": {"enabled": True}},
    "tensor_parallel.tp_size": {"tensor_parallel": 2},
    "compile_monitor": {"compile_monitor": {"enabled": True}},
}


@pytest.mark.parametrize("feature", sorted(UNPORTED))
def test_unported_feature_raises(feature):
    cfg, params = _tiny_params()
    conf = dict({"dtype": "float32"}, **UNPORTED[feature])
    assert InferenceConfig.from_dict(conf).unported_features() == [feature]
    with pytest.raises(NotImplementedError, match=feature):
        build_engine_v2(llama, cfg, params, config=conf, device="cpu")


def test_ported_serving_features_build():
    """``kv_quant``, ``speculative`` (with ``fused_verify``), the prefix cache,
    split prefill, ``trace`` and the CUDA-graph decode are ported: enabling
    them builds an engine instead of raising."""
    cfg, params = _tiny_params()
    conf = {"dtype": "float32", "kv_quant": {"enabled": True},
            "speculative": {"enabled": True, "fused_verify": True},
            "prefix_cache": {"enabled": True}, "split_prefill_chunk": 32,
            "enable_cuda_graph": True, "trace": {"enabled": True, "dump_on_crash": False}}
    assert InferenceConfig.from_dict(conf).unported_features() == []
    eng = build_engine_v2(llama, cfg, params, config=conf, device="cpu")
    assert eng.cache["k"].dtype == torch.int8 and eng._spec_fused
    assert eng.state.prefix_cache and eng.tracer.enabled
    # no graph on the CPU: the decode forward runs eagerly over its buffers
    assert not eng._graph_on


@pytest.mark.parametrize("block", ["serving.obs", "serving.tuning"])
def test_unported_router_block_raises(block):
    """The serving router's unported blocks parse and, enabled, raise when
    the router is built (before any engine is touched)."""
    from deepspeed_tpu_torch.inference import ReplicaRouter, RouterConfig

    conf = RouterConfig.from_dict({block.split(".")[1]: {"enabled": True}})
    assert conf.unported_features() == [block]
    with pytest.raises(NotImplementedError, match=block):
        ReplicaRouter([object()], conf)


def test_bloom_evoformer_and_blocksparse_default_to_the_gpu():
    """BLOOM's trainer and the two attention entry points run on the card
    unless the CPU is asked for (``device="cpu"``, ``use_kernel=False``),
    and raise without one instead of falling back."""
    import numpy as np

    from deepspeed_tpu_torch.models import bloom
    from deepspeed_tpu_torch.ops import blocksparse_attention, evoformer_attention

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    cfg = bloom.BloomConfig.tiny()
    conf = {"train_batch_size": 1, "steps_per_print": 0}
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=bloom.model_spec(cfg), config=conf)
    eng, *_ = deepspeed_tpu_torch.initialize(model=bloom.model_spec(cfg), config=conf,
                                             device="cpu")
    assert {p.device.type for p in eng.state.params.values()} == {"cpu"}
    x = torch.zeros(1, 2, 16, 2, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        evoformer_attention(x, x, x)
    assert evoformer_attention(x, x, x, use_kernel=False).shape == x.shape
    q, lay = torch.zeros(1, 32, 2, 32), np.ones((2, 2), bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        blocksparse_attention(q, q, q, lay, 16)
    assert blocksparse_attention(q, q, q, lay, 16, use_kernel=False).shape == q.shape
