"""ZeRO stages 0-3 of the PyTorch port, data parallel over gloo ranks on the
CPU, against the JAX engine at dp = 2 (``deepspeed_tpu.initialize(...,
devices=jax.devices()[:2])``).

The configuration is JAX ``tests/test_zero_stages.py:21-37``'s (tiny
Llama: vocab 128, hidden 64, 2 layers, 4 heads on 2 kv heads; batch 16 of
32 tokens; AdamW, here with weight decay 0.1; clipping 1.0; fp32 compute).
The weights go to the ranks through ``models/convert.py``, the batches as
they are; every rank gets the whole batch and takes its rows
(``tests/_torch_dist_worker.py``).

- 10 ``train_batch`` steps at each stage against JAX's stage-0 trajectory,
  the oracle also for stage 3 (JAX's stage 3 drifts from the replicated
  run on the CPU mesh); stages 1 and 2 also against JAX's own stages 1 and
  2. Tolerance: losses and grad norms rtol 2e-4, atol 2e-4 (the JAX
  package's own, ``test_zero_stages.py:103-104``); final params 2e-4
  absolute (Adam moves a leaf whose grads are rounding noise by up to lr
  either way).
- GAS 2 at stages 0 and 2, and through ``forward`` / ``backward`` /
  ``step`` at stages 1 and 3; labels with -100 in unequal numbers on the two
  ranks (the loss is the global token mean: each rank's loss is weighted
  by its share of the valid tokens); aux ``ntokens`` summed over ranks and
  micro-batches.
- At 4 ranks: persistent state bytes per rank (masters and AdamW moments)
  shrink with the stage, and the stage-2 grad accumulator at GAS 4 holds a
  quarter of the grad bytes.
- GPT-2 (tiny) at stages 2 and 3 against JAX's stage 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64, rope_theta=10000.0)
GPT = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
           num_heads=4, max_seq_len=64)
BATCH, SEQ, STEPS, GAS_STEPS = 16, 32, 10, 6
TOL = dict(rtol=2e-4, atol=2e-4)


def _config(stage, gas=1, batch=BATCH):
    return {"train_batch_size": batch, "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "zero_optimization": {"stage": stage}, "gradient_clipping": 1.0,
            "steps_per_print": 0}


def _tokens(step, batch=BATCH):
    rng = np.random.default_rng(1000 + step)
    return rng.integers(0, LLAMA["vocab_size"], (batch, SEQ + 1), dtype=np.int32)


def _labelled(step):
    """tokens / labels with -100 in unequal numbers on the two ranks' rows."""
    t = _tokens(step)
    labels = t[:, 1:].copy()
    labels[:BATCH // 2, :20 + step] = -100       # rank 0 keeps 12 - step a row
    labels[BATCH // 2:, :3] = -100               # rank 1 keeps 29
    return {"tokens": t[:, :-1], "labels": labels}


BATCHES = {"batch": [{"tokens": _tokens(i)} for i in range(STEPS)],
           "lab": [_labelled(i) for i in range(GAS_STEPS)]}


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_run(family, cfg, params, stage, data="batch", steps=STEPS, gas=1):
    eng, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params, logical_axes=family.param_logical_axes(cfg),
                           loss_fn=lambda p, b: family.loss_fn(cfg, p, b,
                                                               compute_dtype=jnp.float32)),
        config=_config(stage, gas), devices=jax.devices()[:2])
    outs = [eng.train_batch(b) for b in BATCHES[data][:steps]]
    return {"losses": np.array([float(o.loss) for o in outs]),
            "grad_norm": np.array([float(o.grad_norm) for o in outs]),
            "ntokens": np.array([int(o.aux.get("ntokens", -1)) for o in outs]),
            "params": _leaves(eng.state.params)}


def _inputs(tmp, cfg_t, params_j, data=("batch",)):
    arrs = {f"param/{k}": v.numpy()
            for k, v in from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j)).items()}
    for name in data:
        for i, b in enumerate(BATCHES[name]):
            arrs.update({f"{name}/{i}/{k}": v for k, v in b.items()})
    path = tmp / "in.npz"
    np.savez(path, **arrs)
    return str(path)


@pytest.fixture(scope="module")
def llama_runs(tmp_path_factory):
    """JAX at stages 0-2 and the port at stages 0-3 on 2 ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp("zero_llama")
    cfg_j, cfg_t = jl.LlamaConfig(**LLAMA, use_pipeline=False), tl.LlamaConfig(**LLAMA)
    params_j = jl.init(cfg_j, jax.random.PRNGKey(0))
    jax_runs = {f"s{s}": _jax_run(jl, cfg_j, params_j, s) for s in (0, 1, 2)}
    jax_runs["gas2"] = _jax_run(jl, cfg_j, params_j, 0, steps=GAS_STEPS, gas=2)
    jax_runs["lab"] = _jax_run(jl, cfg_j, params_j, 0, data="lab", steps=GAS_STEPS)
    runs = [{"name": f"s{s}", "config": _config(s), "steps": STEPS} for s in range(4)]
    runs += [{"name": f"gas2_s{s}", "config": _config(s, gas=2), "steps": GAS_STEPS}
             for s in (0, 2)]
    runs += [{"name": f"micro_s{s}", "config": _config(s, gas=2), "steps": GAS_STEPS,
              "api": "micro"} for s in (1, 3)]
    runs += [{"name": f"lab_s{s}", "config": _config(s), "steps": GAS_STEPS, "data": "lab"}
             for s in range(4)]
    ranks = spawn({"scenario": "train", "family": "llama", "cfg": LLAMA, "runs": runs,
                   "npz": _inputs(tmp, cfg_t, params_j, ("batch", "lab"))}, 2, tmp)
    return cfg_t, jax_runs, ranks


def _check(cfg_t, got, name, want, noise=None):
    """Losses, grad norms and final params of run ``name`` against JAX's;
    ``noise``: (leaf, slice of its last dim) whose exact grad is zero, so
    that Adam moves it by rounding noise of lr size, left out as in
    ``test_torch_gpt.py``."""
    np.testing.assert_allclose(got[f"{name}/losses"], want["losses"], **TOL, err_msg=name)
    np.testing.assert_allclose(got[f"{name}/grad_norm"], want["grad_norm"], **TOL,
                               err_msg=name)
    params = {k.split("/", 2)[2]: v for k, v in got.items() if k.startswith(f"{name}/param/")}
    params = _leaves(to_jax_params(cfg_t, {k: torch.from_numpy(v) for k, v in params.items()}))
    assert set(params) == set(want["params"])
    for leaf, w in want["params"].items():
        p = params[leaf]
        if noise and leaf == noise[0]:
            p, w = np.delete(p, noise[1], axis=-1), np.delete(w, noise[1], axis=-1)
        np.testing.assert_allclose(p, w, rtol=0, atol=2e-4, err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_ten_steps_match_jax_stage0(llama_runs, stage):
    cfg_t, jax_runs, ranks = llama_runs
    assert jax_runs["s0"]["losses"][-1] < jax_runs["s0"]["losses"][0], "did not train"
    _check(cfg_t, ranks[0], f"s{stage}", jax_runs["s0"])
    # every rank reports the same global values and holds the same params
    for key in ("losses", "grad_norm"):
        np.testing.assert_array_equal(ranks[1][f"s{stage}/{key}"], ranks[0][f"s{stage}/{key}"])


@pytest.mark.parametrize("stage", [1, 2])
def test_stages_match_jax_own_stage(llama_runs, stage):
    cfg_t, jax_runs, ranks = llama_runs
    _check(cfg_t, ranks[0], f"s{stage}", jax_runs[f"s{stage}"])


@pytest.mark.parametrize("stage", [0, 2])
def test_gas2_matches_jax(llama_runs, stage):
    cfg_t, jax_runs, ranks = llama_runs
    _check(cfg_t, ranks[0], f"gas2_s{stage}", jax_runs["gas2"])
    # counts sum over both micro-batches and both ranks
    assert list(ranks[0][f"gas2_s{stage}/ntokens"]) == [BATCH * SEQ] * GAS_STEPS
    assert list(jax_runs["gas2"]["ntokens"]) == [BATCH * SEQ] * GAS_STEPS


@pytest.mark.parametrize("stage", [1, 3])
def test_forward_backward_step_matches_jax(llama_runs, stage):
    """The reference's micro-batch API (``forward`` on each global
    micro-batch, ``backward``, ``step`` at the boundary) at GAS 2."""
    cfg_t, jax_runs, ranks = llama_runs
    _check(cfg_t, ranks[0], f"micro_s{stage}", jax_runs["gas2"])


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_uneven_ignored_labels_match_jax(llama_runs, stage):
    """Ranks hold 12 - step and 29 valid tokens a row, so the mean of the
    two ranks' token means is not JAX's global token mean."""
    cfg_t, jax_runs, ranks = llama_runs
    want = jax_runs["lab"]
    _check(cfg_t, ranks[0], f"lab_s{stage}", want)
    assert list(ranks[0][f"lab_s{stage}/ntokens"]) == list(want["ntokens"])
    assert want["ntokens"][0] == BATCH // 2 * (SEQ - 20) + BATCH // 2 * (SEQ - 3)


@pytest.mark.parametrize("stage,ops", [
    (0, {"all_reduce_sum"}),
    (1, {"all_gather", "all_reduce_sum", "all_reduce_min"}),
    (2, {"all_gather", "reduce_scatter", "all_reduce_sum", "all_reduce_min"}),
    (3, {"all_gather", "reduce_scatter", "all_reduce_sum", "all_reduce_min"}),
])
def test_each_stage_runs_its_collectives(llama_runs, stage, ops):
    """The collectives of one step, read from the port's comm layer: stage 0
    all-reduces the grads; from stage 1 every leaf's compute copy is
    all-gathered once a micro-batch; from stage 2 every grad is
    reduce-scattered (every leaf of this model divides by 2)."""
    cfg_t, _, ranks = llama_runs
    got = {k.split("/")[-1]: v for k, v in ranks[0].items() if k.startswith(f"s{stage}/comm/")}
    assert set(got) == ops
    leaves = len(tl.param_shapes(tl.LlamaConfig(**LLAMA)))
    grad_bytes = sum(4 * int(np.prod(s)) for s, _ in tl.param_shapes(
        tl.LlamaConfig(**LLAMA)).values())
    if stage >= 1:
        # a shard's fp32 compute copy a leaf, half the model's bytes
        assert list(got["all_gather"]) == [leaves, grad_bytes // 2]
    if stage >= 2:
        assert list(got["reduce_scatter"]) == [leaves, grad_bytes]
    if stage == 0:
        # the grads, the ntokens weight, the losses and the two aux values
        assert got["all_reduce_sum"][0] == leaves + 4


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_bytes")
    cfg_j, cfg_t = jl.LlamaConfig(**LLAMA, use_pipeline=False), tl.LlamaConfig(**LLAMA)
    params_j = jl.init(cfg_j, jax.random.PRNGKey(0))
    runs = [{"name": f"s{s}", "config": _config(s, gas=4), "steps": 1,
             "accumulator": True} for s in range(4)]
    ranks = spawn({"scenario": "train", "family": "llama", "cfg": LLAMA, "runs": runs,
                   "npz": _inputs(tmp, cfg_t, params_j)}, 4, tmp)
    return cfg_t, ranks


def test_state_bytes_shrink_with_stage(four_ranks):
    """Masters + AdamW moments on each of 4 ranks: whole at stage 0, a
    quarter from stage 1 (every leaf of this model divides by 4)."""
    cfg_t, ranks = four_ranks
    sizes = {s: int(ranks[0][f"s{s}/state_bytes"]) for s in range(4)}
    full = 3 * 4 * sum(int(np.prod(s)) for s, _ in tl.param_shapes(cfg_t).values())
    assert sizes[0] == full
    assert sizes[1] < 0.3 * sizes[0], sizes
    assert sizes[2] <= sizes[1] and sizes[3] <= sizes[2], sizes
    assert all(int(r["s1/state_bytes"]) == sizes[1] for r in ranks)


def test_stage2_accumulator_is_sharded(four_ranks):
    """After 3 of GAS 4's micro-batches the accumulated fp32 grads are whole
    at stage 1 and a quarter at stage 2 (no leaf stays replicated here)."""
    cfg_t, ranks = four_ranks
    grad_bytes = 4 * sum(int(np.prod(s)) for s, _ in tl.param_shapes(cfg_t).values())
    acc = {s: int(ranks[0][f"s{s}/acc_bytes"]) for s in (1, 2, 3)}
    assert acc[1] == grad_bytes
    assert acc[2] == grad_bytes // 4 and acc[3] == grad_bytes // 4
    # and the step still trains: one step's loss equal on every rank
    losses = {float(r["s2/losses"][0]) for r in ranks}
    assert len(losses) == 1


@pytest.fixture(scope="module")
def gpt_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_gpt")
    cfg_j, cfg_t = jgpt.GPTConfig(**GPT), tgpt.GPTConfig(**GPT)
    params_j = jgpt.init(cfg_j, jax.random.PRNGKey(1))
    want = _jax_run(jgpt, cfg_j, params_j, 0, steps=GAS_STEPS)
    ranks = spawn({"scenario": "train", "family": "gpt", "cfg": GPT,
                   "runs": [{"name": f"g{s}", "config": _config(s), "steps": GAS_STEPS}
                            for s in (2, 3)],
                   "npz": _inputs(tmp, cfg_t, params_j)}, 2, tmp)
    return cfg_t, want, ranks


@pytest.mark.parametrize("stage", [2, 3])
def test_gpt_matches_jax_stage0(gpt_runs, stage):
    """GPT's loss has no ``ntokens``: each rank's mean weighs 1/2. The K
    bias slice of ``bqkv`` is left out of the final params (zero exact
    grad)."""
    cfg_t, want, ranks = gpt_runs
    h = cfg_t.hidden_size
    _check(cfg_t, ranks[0], f"g{stage}", want,
           noise=("['layers']['bqkv']", np.s_[h:2 * h]))
