"""LAMB, Muon and 1-bit Adam under ZeRO stages 1-3 of the PyTorch port, data
parallel over 2 gloo ranks on the CPU (4 ranks:
``test_torch_zero_optimizers_w4.py``), against the JAX engine at dp = 2
(stage 0: whole leaves).

These optimizers reduce over a whole JAX leaf (LAMB's norms, Muon's
Newton-Schulz and its scale, the 1-bit scale), while a rank holds shards
of unstacked, transposed leaves: the engine's layout takes the reductions
over the leaf's layers and the data axis, and Muon gathers each momentum
leaf (``ops/optimizers.py`` :class:`Layout`). The configuration is
``tests/test_torch_zero_stages.py``'s (tiny Llama, batch 16 of 32 tokens,
clipping 1.0, fp32); 10 steps; losses and grad norms rtol / atol 2e-4,
final params 2e-4 absolute, as AdamW is held there. 1-bit Adam freezes
after step 3, so 7 of its steps compress; its params are held as
``_check_onebit`` says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_zero_stages import LLAMA, STEPS, TOL, _check, _inputs

import deepspeed_tpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import to_jax_params
from test_torch_zero_stages import BATCHES, _leaves

OPTIMIZERS = {
    "lamb": {"type": "lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "muon": {"type": "muon", "params": {"lr": 0.02, "weight_decay": 0.01}},
    "onebitadam": {"type": "onebitadam", "params": {"lr": 1e-3, "freeze_step": 3}},
}


def _check_onebit(cfg_t, got, name, want):
    """Losses and grad norms at 2e-4, as AdamW. After the freeze, an element
    whose ``g + e`` lies within rounding of 0 takes either sign, and the
    frozen variance turns that sign into a step of up to ~1e-2 here
    (``lr (1 - b1) 2 scale / sqrt(v)``); the grads of the two packages differ
    by rounding (the port's single-process stage 0 shows the same 14 of
    8192 ``embed`` elements moved against JAX's), so up to 0.5% of a leaf's
    elements may stand outside 2e-4. On identical grads the update is
    JAX's within 1e-5 everywhere (``tests/test_torch_optimizers.py``)."""
    np.testing.assert_allclose(got[f"{name}/losses"], want["losses"], **TOL, err_msg=name)
    np.testing.assert_allclose(got[f"{name}/grad_norm"], want["grad_norm"], **TOL,
                               err_msg=name)
    params = {k.split("/", 2)[2]: v for k, v in got.items() if k.startswith(f"{name}/param/")}
    params = _leaves(to_jax_params(cfg_t, {k: torch.from_numpy(v) for k, v in params.items()}))
    assert set(params) == set(want["params"])
    for leaf, w in want["params"].items():
        off = np.abs(params[leaf] - w) > 2e-4
        assert off.mean() <= 0.005, (name, leaf, int(off.sum()), off.size)


def _config(stage, opt):
    return {"train_batch_size": 16, "optimizer": OPTIMIZERS[opt],
            "zero_optimization": {"stage": stage}, "gradient_clipping": 1.0,
            "steps_per_print": 0}


def _jax_run(cfg, params, opt):
    eng, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params, logical_axes=jl.param_logical_axes(cfg),
                           loss_fn=lambda p, b: jl.loss_fn(cfg, p, b,
                                                           compute_dtype=jnp.float32)),
        config=_config(0, opt), devices=jax.devices()[:2])
    outs = [eng.train_batch(b) for b in BATCHES["batch"][:STEPS]]
    return {"losses": np.array([float(o.loss) for o in outs]),
            "grad_norm": np.array([float(o.grad_norm) for o in outs]),
            "params": _leaves(eng.state.params)}


def spawn_runs(world: int, tmp_path_factory):
    """JAX dp = 2 at stage 0 for each optimizer, and the port at stages 1-3
    on ``world`` gloo ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp(f"zero_opt{world}")
    cfg_j, cfg_t = jl.LlamaConfig(**LLAMA, use_pipeline=False), tl.LlamaConfig(**LLAMA)
    params_j = jl.init(cfg_j, jax.random.PRNGKey(0))
    want = {opt: _jax_run(cfg_j, params_j, opt) for opt in OPTIMIZERS}
    jobs = [{"name": f"{opt}_s{s}", "config": _config(s, opt), "steps": STEPS}
            for opt in OPTIMIZERS for s in (1, 2, 3)]
    ranks = spawn({"scenario": "train", "family": "llama", "cfg": LLAMA, "runs": jobs,
                   "npz": _inputs(tmp, cfg_t, params_j)}, world, tmp, timeout=300.0)
    return cfg_t, want, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_runs(2, tmp_path_factory)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_matches_jax_dp2(runs, opt, stage):
    check_stage(runs, opt, stage)


def check_stage(runs, opt, stage):
    cfg_t, want, ranks = runs
    name = f"{opt}_s{stage}"
    assert want[opt]["losses"][-1] < want[opt]["losses"][0], "did not train"
    if opt != "onebitadam":
        _check(cfg_t, ranks[0], name, want[opt])
    else:
        _check_onebit(cfg_t, ranks[0], name, want[opt])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{opt}_s{stage}/losses"],
                                      ranks[0][f"{opt}_s{stage}/losses"])
