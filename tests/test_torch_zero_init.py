"""``zero.Init`` of the PyTorch port (``runtime/zero_init.py``).

- ``materialize_sharded`` at stage 3 on 2 gloo ranks: each rank holds half
  of every leaf that divides, and the shards gathered equal the unsharded
  init from the same seed bit for bit (Llama and GPT-2 tiny); the engine's
  masters at stages 1 and 3, drawn sharded from ``config.seed``, likewise.
- ``GatheredParameters``: whole leaves, and with ``modifier_rank`` that
  rank's edit written back into every rank's shards.
- ``on_device``: meta tensors of the init's shapes and dtypes, nothing
  drawn; ``Init``'s stage from a config dict or file; ``tp_model_init``
  refused (no tensor parallelism yet).
"""

import json

import numpy as np
import pytest
import torch
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt, llama

FAMILIES = {"llama": (llama, llama.LlamaConfig.tiny()), "gpt": (gpt, gpt.GPTConfig.tiny())}
SEED = 3


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def ranks(request, tmp_path_factory):
    family, cfg = FAMILIES[request.param]
    tmp = tmp_path_factory.mktemp(f"zero_init_{request.param}")
    kw = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    return family, cfg, spawn({"scenario": "zero_init", "family": request.param, "cfg": kw,
                               "seed": SEED}, 2, tmp)


def test_materialize_sharded_gathers_to_the_unsharded_init(ranks):
    family, cfg, got = ranks
    want = family.init(cfg, torch.Generator().manual_seed(SEED))
    for name, w in want.items():
        for r in range(2):
            np.testing.assert_array_equal(got[r][f"full/{name}"], w.numpy(), err_msg=name)
        shard = got[0][f"shard/{name}"]
        if max(w.shape) % 2 == 0:       # every leaf of these models divides by 2
            assert shard.size == w.numel() // 2, name
    # the two ranks hold different halves
    assert not np.array_equal(got[0]["shard/embed"], got[1]["shard/embed"])


def test_engine_draws_its_masters_sharded(ranks):
    family, cfg, got = ranks
    want = family.init(cfg, torch.Generator().manual_seed(SEED))
    total = sum(w.numel() for w in want.values())
    for stage in (1, 3):
        assert int(got[0][f"engine{stage}/numel"]) == total // 2
        for name, w in want.items():
            np.testing.assert_array_equal(got[1][f"engine{stage}/{name}"], w.numpy(),
                                          err_msg=f"stage {stage} {name}")


def test_gathered_parameters_modifier_rank(ranks):
    """Both ranks add to the whole leaves; only rank 1's edit (+2) lands."""
    family, cfg, got = ranks
    for r in range(2):
        for name in family.param_shapes(cfg):
            np.testing.assert_array_equal(got[r][f"edited/{name}"],
                                          got[r][f"full/{name}"] + 2.0, err_msg=name)


def test_on_device_allocates_nothing():
    cfg = llama.LlamaConfig.tiny()
    gen = torch.Generator().manual_seed(SEED)
    state = gen.get_state()
    meta = dst.zero.on_device(lambda g: llama.init(cfg, g), gen)
    assert torch.equal(gen.get_state(), state), "the generator advanced"
    real = llama.init(cfg, torch.Generator().manual_seed(SEED))
    assert set(meta) == set(real)
    for k, t in meta.items():
        assert t.device.type == "meta" and t.shape == real[k].shape and t.dtype == real[k].dtype


def test_one_process_materialize_is_the_init():
    """Without a process group the mesh has one member: nothing is sharded."""
    cfg = gpt.GPTConfig.tiny()
    got = dst.zero.materialize_sharded(
        lambda g, **kw: gpt.init(cfg, g, **kw), torch.Generator().manual_seed(SEED),
        gpt.param_logical_axes(cfg), mesh_mgr=dst.comm.MeshManager.from_sizes({"data": 1}))
    want = gpt.init(cfg, torch.Generator().manual_seed(SEED))
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_init_stage_from_config(tmp_path):
    assert dst.zero.Init().zero_stage == 3
    assert dst.zero.Init(config_dict_or_path={"zero_optimization": {"stage": 2}}).zero_stage == 2
    path = tmp_path / "ds.json"
    path.write_text(json.dumps({"zero_optimization": {"stage": 1}}))
    with dst.zero.Init(config_dict_or_path=str(path)) as zi:
        assert zi.zero_stage == 1


def test_tp_model_init_is_refused():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        dst.zero.tp_model_init(llama.model_spec(llama.LlamaConfig.tiny()), tp_size=2)
