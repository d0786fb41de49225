"""``optimizer.param_groups`` in the PyTorch port against the JAX package, on
the CPU (JAX ``ops/optimizers.py`` ``grouped_optimizer``, JAX
``runtime/engine.py:163-197`` and ``set_lr`` :955-980).

- The patterns match JAX paths ('/'-joined, ``layers/w_up``), never the
  port's ``layers.<i>.w_up``: the port's groups are JAX's, leaf for leaf.
- Tiny Llama (2 layers), fp32: 10 engine steps with per-group lr and weight
  decay against the JAX engine (losses and grad norms rtol 1e-5, params
  2e-4 absolute, ``test_torch_universal.py``'s tolerances); ``set_lr``
  mid-run pins every group in both; a grouped LAMB and a grouped Muon
  trajectory, whose reductions run over whole JAX leaves of one group.
- A passed optimizer object wins over the config's groups, with the JAX
  engine's warning; a group without ``pattern`` or with a bad regex raises
  JAX's ``ValueError``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu.utils.tree import path_to_str
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params, jax_leaves, to_jax_params
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import engine as tengine

CFG_J, CFG_T = jl.LlamaConfig.tiny(num_layers=2), tl.LlamaConfig.tiny(num_layers=2)
GROUPS = [{"pattern": "(norm|bias)", "weight_decay": 0.0},
          {"pattern": "layers/w_(up|down)", "lr": 3e-3},
          {"pattern": "^embed$", "lr": 5e-4, "weight_decay": 0.3}]
_RS = np.random.RandomState(0)
BATCHES = [{"tokens": _RS.randint(0, CFG_T.vocab_size, (4, 17)).astype(np.int32)}
           for _ in range(10)]


def _config(groups=GROUPS, opt="adamw", **params):
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "optimizer": {"type": opt, "params": {"lr": 1e-3, "weight_decay": 0.1, **params},
                          "param_groups": groups},
            "gradient_clipping": 1.0, "steps_per_print": 0}


def _engines(config):
    params = jl.init(CFG_J, jax.random.PRNGKey(0))
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params, loss_fn=lambda p, b: jl.loss_fn(
            CFG_J, p, b, compute_dtype=jnp.float32)),
        config=config, devices=jax.devices()[:1])
    spec = tl.model_spec(CFG_T, compute_dtype=torch.float32)
    spec.params, spec.init_fn = from_jax_params(CFG_T, jax.tree.map(np.asarray, params)), None
    eng_t, *_ = deepspeed_tpu_torch.initialize(model=spec, config=config, device="cpu")
    return eng_j, eng_t


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _hold(eng_j, eng_t, outs_j, outs_t):
    np.testing.assert_allclose([float(o.loss) for o in outs_t],
                               [float(o.loss) for o in outs_j], rtol=1e-5)
    np.testing.assert_allclose([float(o.grad_norm) for o in outs_t],
                               [float(o.grad_norm) for o in outs_j], rtol=1e-5)
    got = _leaves(to_jax_params(CFG_T, {k: v.detach() for k, v in eng_t.state.params.items()}))
    want = _leaves(eng_j.state.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4, err_msg=k)


def test_groups_select_jax_paths():
    """Each port leaf lands in the group of its JAX leaf."""
    params = jax.tree.map(np.asarray, jl.init(CFG_J, jax.random.PRNGKey(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    rx = [re.compile(g["pattern"]) for g in GROUPS]
    want = {}
    for path, _ in flat:
        name = path_to_str(path, sep="/")
        want[name] = next((i for i, r in enumerate(rx) if r.search(name)), len(GROUPS))
    port = from_jax_params(CFG_T, params)
    opt = topt.grouped_optimizer("adamw", port, GROUPS,
                                 leaf_paths={k: p for k, (p, _, _) in jax_leaves(CFG_T).items()},
                                 lr=1e-3)
    state = opt.init(port)
    got = {}
    for g, st in enumerate(state):
        for name in st.mu:
            got.setdefault(jax_leaves(CFG_T)[name][0], set()).add(g)
    assert {k: v.pop() for k, v in got.items() if len(v) == 1} == want
    assert len(want) == len(got) and set(want.values()) == {0, 1, 2, 3}
    # the port's own names would select other leaves: w_up / w_down only
    # through the JAX path
    plain = topt.grouped_optimizer("adamw", port, GROUPS, lr=1e-3).init(port)
    assert not plain[1].mu


def test_per_group_lr_and_decay_match_jax_engine():
    eng_j, eng_t = _engines(_config())
    assert eng_t.optimizer.name == eng_j.optimizer.name == "adamw+groups"
    assert eng_t.optimizer.hyperparams == eng_j.optimizer.hyperparams
    outs_j = [eng_j.train_batch(b) for b in BATCHES]
    outs_t = [eng_t.train_batch(b) for b in BATCHES]
    _hold(eng_j, eng_t, outs_j, outs_t)


def test_set_lr_pins_every_group():
    eng_j, eng_t = _engines(_config())
    outs_j = [eng_j.train_batch(b) for b in BATCHES[:4]]
    outs_t = [eng_t.train_batch(b) for b in BATCHES[:4]]
    eng_j.set_lr(2e-3)
    eng_t.set_lr(2e-3)
    assert all(g.get("lr") is None for g in eng_t.optimizer.hyperparams["param_groups"])
    assert eng_t.base_lr == eng_j.base_lr == 2e-3
    outs_j += [eng_j.train_batch(b) for b in BATCHES[4:]]
    outs_t += [eng_t.train_batch(b) for b in BATCHES[4:]]
    _hold(eng_j, eng_t, outs_j, outs_t)


@pytest.mark.parametrize("opt", ["lamb", "muon"])
def test_grouped_whole_leaf_reductions_match_jax_engine(opt):
    groups = [{"pattern": "norm", "weight_decay": 0.0}, {"pattern": "layers/w", "lr": 2e-3}]
    eng_j, eng_t = _engines(_config(groups, opt=opt, weight_decay=0.01))
    outs_j = [eng_j.train_batch(b) for b in BATCHES[:6]]
    outs_t = [eng_t.train_batch(b) for b in BATCHES[:6]]
    _hold(eng_j, eng_t, outs_j, outs_t)


def test_passed_optimizer_wins_with_the_warning(monkeypatch):
    said = []
    monkeypatch.setattr(tengine.logger, "warning", lambda msg, *a, **k: said.append(msg))
    opt = topt.get_optimizer("sgd", lr=0.1)
    eng, got, *_ = deepspeed_tpu_torch.initialize(
        model=tl.model_spec(CFG_T, compute_dtype=torch.float32), optimizer=opt,
        config=_config(), device="cpu")
    assert got is opt and eng.optimizer.name == "sgd"
    assert any("param_groups in the config are IGNORED" in m for m in said)


@pytest.mark.parametrize("groups,match", [
    ([{"weight_decay": 0.0}], "has no 'pattern'"),
    ([{"pattern": "(norm", "weight_decay": 0.0}], "is not a valid regex"),
])
def test_bad_groups_raise_as_in_jax(groups, match):
    tree = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match=match):
        jopt.grouped_optimizer("adamw", tree, groups, lr=1e-3)
    with pytest.raises(ValueError, match=match):
        topt.grouped_optimizer("adamw", {"w": torch.zeros(2, 2)}, groups, lr=1e-3)
    with pytest.raises(ValueError, match=match):
        deepspeed_tpu_torch.initialize(model=tl.model_spec(CFG_T, compute_dtype=torch.float32),
                                       config=_config(groups), device="cpu")
