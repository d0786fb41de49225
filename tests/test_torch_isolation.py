"""The PyTorch port stands alone: it imports neither ``jax`` nor
``deepspeed_tpu``, runs on the GPU unless the CPU is asked for, and refuses
features it has not ported instead of ignoring them (``kv_quant`` and
``speculative`` are ported and build)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
                 "deepspeed_tpu_torch.inference.serving.workload",
                 "deepspeed_tpu_torch.comm", "deepspeed_tpu_torch.comm.comm",
                 "deepspeed_tpu_torch.comm.mesh", "deepspeed_tpu_torch.runtime.partitioning",
                 "deepspeed_tpu_torch.runtime.zero_init", "deepspeed_tpu_torch.models.falcon",
                 "deepspeed_tpu_torch.models.gptneox", "deepspeed_tpu_torch.ops.rotary"):
        assert name in mods
    # the module system resolves on CPU tensors without building anything
    norm = modules.registry.instantiate("norm", modules.NormConfig(kind="layer"))
    assert norm(torch.ones(2, 8), torch.ones(8), torch.zeros(8)).abs().max() == 0


@pytest.mark.parametrize("dtype", ["float32", "fp32"])
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


def test_falcon_and_gptneox_entry_points_default_to_the_gpu():
    """Falcon's and GPT-NeoX's trainers, v1 and Falcon's v2 engine and
    pools run on the card unless the CPU is asked for."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import falcon, gptneox

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    conf = {"train_batch_size": 1, "steps_per_print": 0}
    for fam, cfg in ((falcon, falcon.FalconConfig.tiny()),
                     (gptneox, gptneox.GPTNeoXConfig.tiny())):
        with pytest.raises(RuntimeError, match="CUDA"):
            deepspeed_tpu_torch.initialize(model=fam.model_spec(cfg), config=conf)
        params = fam.init(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            init_inference(fam, model_cfg=cfg, params=params)
    cfg = falcon.FalconConfig.tiny()
    params = falcon.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine_v2(falcon, cfg, params, config={"dtype": "float32"})
    with pytest.raises(RuntimeError, match="CUDA"):
        falcon.init_paged_cache(cfg, 4, 8)
    eng = build_engine_v2(falcon, cfg, params, config={"dtype": "float32"}, device="cpu")
    assert eng.model.embed.device.type == "cpu"


def test_init_distributed_defaults_to_nccl_and_gloo_only_when_asked():
    """``comm.init_distributed()`` takes NCCL on the card and raises without
    a GPU instead of falling back; ``dist_backend="gloo"`` runs on the CPU
    (a one-rank group on a free local port). In a subprocess, so no process
    group outlives the check."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    code = ("import torch.distributed as dist\n"
            "from deepspeed_tpu_torch import comm\n"
            "try:\n"
            "    comm.init_distributed()\n"
            "    raise SystemExit('nccl on a box without a GPU did not raise')\n"
            "except RuntimeError as e:\n"
            "    assert 'gloo' in str(e) and not dist.is_initialized(), e\n"
            "comm.init_distributed(dist_backend='gloo')\n"
            "assert dist.get_backend() == 'gloo' and comm.get_world_size() == 1\n"
            "mm = comm.get_mesh()\n"
            "assert mm.device_mesh is not None and mm.dp_world_size == 1\n"
            "import torch\n"
            "assert comm.all_reduce(torch.ones(2), 'data').tolist() == [1.0, 1.0]\n"
            "assert comm.counts.snapshot() == {'all_reduce_sum': {'count': 1, 'bytes': 8}}\n"
            "dist.destroy_process_group()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "DSTPU_COORDINATOR",
                "DSTPU_NUM_PROCESSES", "DSTPU_PROCESS_ID"):
        env.pop(var, None)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_init_inference_defaults_to_the_gpu_and_refuses_what_is_not_ported():
    """``init_inference`` runs on the card unless the CPU is asked for; on
    the v1 engine ``quant`` builds (int8, packed int4, fp8), while tensor
    parallelism still raises, and v2 keeps refusing ``quant``."""
    from deepspeed_tpu_torch import init_inference

    cfg, params = _tiny_params()
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_inference(llama, model_cfg=cfg, params=params, config={"dtype": "float32"})
    for quant in ({"enabled": True}, {"enabled": True, "bits": 4},
                  {"enabled": True, "dtype": "fp8"}):
        conf = {"dtype": "float32", "quant": quant}
        assert InferenceConfig.from_dict(conf).unported_features("v1") == []
        eng = init_inference(llama, model_cfg=cfg, params=params, config=conf, device="cpu")
        assert eng.weight_bytes() < sum(t.numel() * 4 for t in params.values())
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        init_inference(llama, model_cfg=cfg, params=params, device="cpu",
                       config={"dtype": "float32", "tensor_parallel": {"tp_size": 2}})
    with pytest.raises(NotImplementedError, match="quant"):
        build_engine_v2(llama, cfg, params, device="cpu",
                        config={"dtype": "float32", "quant": {"enabled": True}})


def test_v1_takes_fp16_and_refuses_tensor_parallel_on_the_card_at_build(monkeypatch):
    """v1's no-cache forward reaches the flash kernels, which take bf16,
    fp16 and fp32: an fp16 ``dtype`` passes the build checks on CUDA (as
    ``initialize`` and v2 pass it), while tensor parallelism still raises
    ``NotImplementedError`` there before any weight lands on the card; fp16
    on the CPU keeps working."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import exaone4

    cfg, params = _tiny_params()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        init_inference(llama, model_cfg=cfg, params=params, device="cuda",
                       config={"dtype": "float16", "tensor_parallel": {"tp_size": 2}})
    monkeypatch.undo()
    eng = init_inference(llama, model_cfg=cfg, params=params, config={"dtype": "float16"},
                         device="cpu")
    eng.device = torch.device("cuda")
    eng._check()   # the dtype is no reason to refuse the card
    eng.device = torch.device("cpu")
    out = eng.generate(np.ones((1, 4), np.int32), max_new_tokens=2)
    assert out.shape == (1, 2)
    assert eng.params["embed"].dtype == torch.float16
    # the new modules are covered by the import checks, and EXAONE-4's entry
    # points default to the card
    mods = _port_modules()
    for name in ("deepspeed_tpu_torch.models.exaone4", "deepspeed_tpu_torch.ops.onebit",
                 "deepspeed_tpu_torch.comm.compressed"):
        assert name in mods
    ecfg = exaone4.Exaone4Config.tiny()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            exaone4.init_paged_cache(ecfg, 4, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            deepspeed_tpu_torch.initialize(model=exaone4.model_spec(ecfg), config={})


FP16_TEST_FILES = ("test_torch_fp16_flash.py", "test_torch_fp16_paged.py",
                   "test_torch_fp16_engines.py", "test_torch_fp16_limits.py")


def test_the_fp16_files_are_named_and_the_card_side_imports_no_jax():
    """fp16 on the card: the CPU parity files exist (they import JAX, as the
    parity tests do), while the files that run where JAX is absent — the
    GPU tests, the fp16 limits' simulation, the smoke — import none of it;
    both 16-bit Hopper sources include the element-type header."""
    tests = REPO / "tests"
    for name in FP16_TEST_FILES:
        assert (tests / name).is_file(), name
    for path in (tests / "test_torch_cuda_kernels.py", tests / "test_torch_fp16_limits.py",
                 tests / "_torch_threads.py", REPO / "chip_smoke.py"):
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.name} imports {sorted(bad)}"
    csrc = PKG / "ops" / "csrc"
    for src in ("flash_fwd_sm90.cu", "flash_bwd_sm90.cu"):
        assert '#include "hopper_types.cuh"' in (csrc / src).read_text(), src
    mods = _port_modules()
    for name in ("deepspeed_tpu_torch.ops.flash_attention",
                 "deepspeed_tpu_torch.ops.paged_attention",
                 "deepspeed_tpu_torch.ops.sparse_attention",
                 "deepspeed_tpu_torch.ops.evoformer_attn"):
        assert name in mods


def test_hf_importer_stands_alone_and_its_entry_points_default_to_the_gpu(tmp_path):
    """``models/hf_import.py`` imports neither ``transformers`` nor
    ``safetensors`` (the card's machine has neither): not in its source, and
    not in ``sys.modules`` after reading a directory in a fresh process.
    ``build_hf_engine``, ``init_inference(checkpoint=)`` and ``initialize``
    on an HF model run on the card unless the CPU is asked for."""
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.engine_v2 import build_hf_engine

    mods = _port_modules()
    for name in ("deepspeed_tpu_torch.models.hf_import", "deepspeed_tpu_torch.models.bert",
                 "deepspeed_tpu_torch.models.clip"):
        assert name in mods
    src = PKG / "models" / "hf_import.py"
    assert not set(_imported_roots(src)) & {"transformers", "safetensors"}
    hf_cfg = transformers.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                                      num_hidden_layers=1, num_attention_heads=2,
                                      max_position_embeddings=64)
    model = transformers.LlamaForCausalLM(hf_cfg)
    model.save_pretrained(tmp_path / "hf")
    code = ("import sys\n"
            "from deepspeed_tpu_torch.models import hf_import\n"
            f"fam, mod, cfg, tree = hf_import.load_checkpoint_dir_module({str(tmp_path / 'hf')!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('transformers', 'safetensors', 'jax', 'deepspeed_tpu')]\n"
            "assert fam == 'llama' and not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
    if torch.cuda.is_available():
        pytest.skip("the default-device half is for a machine without a GPU")
    path = str(tmp_path / "hf")
    conf = {"dtype": "float32"}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_hf_engine(path, config=conf)
    assert build_hf_engine(path, config=conf, device="cpu").model.embed.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        init_inference(checkpoint=path, config=conf)
    assert init_inference(checkpoint=path, config=conf, device="cpu").device.type == "cpu"
    train = {"train_batch_size": 1, "steps_per_print": 0}
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=model, config=train)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=train, device="cpu")
    assert {p.device.type for p in eng.state.params.values()} == {"cpu"}
