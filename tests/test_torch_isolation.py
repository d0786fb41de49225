"""The PyTorch port stands alone: it imports neither ``jax`` nor
``deepspeed_tpu``, runs on the GPU unless the CPU is asked for, and refuses
features it has not ported instead of ignoring them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepspeed_tpu_torch.inference import InferenceConfig, build_engine_v2
from deepspeed_tpu_torch.models import llama

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
    "kv_quant": {"kv_quant": {"enabled": True}},
    "prefix_cache": {"prefix_cache": {"enabled": True}},
    "speculative": {"speculative": {"enabled": True}},
    "split_prefill_chunk": {"split_prefill_chunk": 32},
    "quant": {"quant": {"enabled": True}},
    "tensor_parallel.tp_size": {"tensor_parallel": 2},
    "trace": {"trace": {"enabled": True}},
    "compile_monitor": {"compile_monitor": {"enabled": True}},
    "enable_cuda_graph": {"enable_cuda_graph": True},
}


@pytest.mark.parametrize("feature", sorted(UNPORTED))
def test_unported_feature_raises(feature):
    cfg, params = _tiny_params()
    conf = dict({"dtype": "float32"}, **UNPORTED[feature])
    assert InferenceConfig.from_dict(conf).unported_features() == [feature]
    with pytest.raises(NotImplementedError, match=feature):
        build_engine_v2(llama, cfg, params, config=conf, device="cpu")
