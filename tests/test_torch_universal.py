"""Universal checkpoints between the PyTorch port and the JAX package, on the
CPU: the fragments are the one format both read.

Tiny Llama (2 layers), fp32, AdamW with weight decay, clipping that bites,
GAS 2 and a warm-up schedule (the configuration of
``tests/test_torch_train_llama.py::test_engine_ten_steps_match_jax_engine``);
the JAX engine on one device (dp = 1).

- A tag the JAX engine wrote after 3 steps loads into the port, and the
  port's next 3 steps follow JAX's own continuation: losses and grad norms
  rtol 1e-5, final params 2e-4 absolute (that test's tolerances). The same
  from a port-written tag into the JAX engine.
- For the same state (moved across with ``from_jax_params``: masters and
  both moments, the step counters), the port's fragment files equal the JAX
  engine's byte for byte (names, shapes, dtypes, ``.npy`` headers, values);
  ``meta.json`` agrees on every key but ``config`` and ``topology``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params

CONFIG = {
    "train_batch_size": 4,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    "gradient_clipping": 0.5,
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                             "warmup_num_steps": 4, "warmup_type": "linear"}},
    "steps_per_print": 0,
}
CFG_J, CFG_T = jl.LlamaConfig.tiny(num_layers=2), tl.LlamaConfig.tiny(num_layers=2)
_RS = np.random.RandomState(0)
BATCHES = [{"tokens": _RS.randint(0, CFG_T.vocab_size, (4, 17)).astype(np.int32)}
           for _ in range(6)]


def _jax_engine(seed=0):
    params = jl.init(CFG_J, jax.random.PRNGKey(seed))
    eng, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params, loss_fn=lambda p, b: jl.loss_fn(
            CFG_J, p, b, compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    return eng


def _port_engine(params_np=None, seed=None):
    """The port's engine from ``params_np`` (JAX's tree), else drawn from
    ``seed`` (the config's default seed when None)."""
    spec = tl.model_spec(CFG_T, compute_dtype=torch.float32)
    if params_np is not None:
        spec.params, spec.init_fn = from_jax_params(CFG_T, params_np), None
    conf = CONFIG if seed is None else dict(CONFIG, seed=seed)
    eng, *_ = deepspeed_tpu_torch.initialize(model=spec, config=conf, device="cpu")
    return eng


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _continue(eng, batches):
    outs = [eng.train_batch(b) for b in batches]
    return [float(o.loss) for o in outs], [float(o.grad_norm) for o in outs]


def _hold(port_eng, losses_t, norms_t, losses_j, norms_j, jax_params):
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    np.testing.assert_allclose(norms_t, norms_j, rtol=1e-5)
    got = _leaves(to_jax_params(CFG_T, {k: v.detach() for k, v in
                                        port_eng.state.params.items()}))
    want = _leaves(jax_params)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=2e-4, err_msg=name)


def test_jax_written_tag_continues_in_the_port(tmp_path):
    eng_j = _jax_engine()
    for b in BATCHES[:3]:
        eng_j.train_batch(b)
    eng_j.save_universal_checkpoint(str(tmp_path), tag="u3")
    losses_j, norms_j = _continue(eng_j, BATCHES[3:])

    eng_t = _port_engine(seed=5)                 # other weights, overwritten by the load
    path, client = eng_t.load_universal_checkpoint(str(tmp_path))
    assert path.endswith("u3") and client == {}
    assert eng_t.global_steps == 3 and eng_t.state.step == 3
    assert eng_t.state.opt_state.step == 3 and eng_t.lr_scheduler.state_dict() == {"last_step": 3}
    assert eng_t.global_tokens == 3 * 4 * 17
    losses_t, norms_t = _continue(eng_t, BATCHES[3:])
    _hold(eng_t, losses_t, norms_t, losses_j, norms_j, eng_j.state.params)
    assert eng_t.state.step == int(eng_j.state.step) == 6


def test_port_written_tag_continues_in_jax(tmp_path):
    params_j = _np(jl.init(CFG_J, jax.random.PRNGKey(0)))
    eng_t = _port_engine(params_j)
    for b in BATCHES[:3]:
        eng_t.train_batch(b)
    eng_t.save_universal_checkpoint(str(tmp_path), tag="p3")
    losses_t, norms_t = _continue(eng_t, BATCHES[3:])

    eng_j = _jax_engine(seed=1)                  # other weights, overwritten by the load
    path, _ = eng_j.load_universal_checkpoint(str(tmp_path))
    assert path.endswith("p3") and eng_j.global_steps == 3
    assert int(eng_j.state.opt_state.step) == 3
    losses_j, norms_j = _continue(eng_j, BATCHES[3:])
    _hold(eng_t, losses_t, norms_t, losses_j, norms_j, eng_j.state.params)


def _carry(eng_j):
    """A port engine holding the JAX engine's state exactly: masters and
    both moments through ``from_jax_params``, and the counters."""
    eng_t = _port_engine()
    st_j = eng_j.state
    with torch.no_grad():
        for tree, dst in ((st_j.params, eng_t.state.params),
                          (st_j.opt_state.mu, eng_t.state.opt_state.mu),
                          (st_j.opt_state.nu, eng_t.state.opt_state.nu)):
            for k, v in from_jax_params(CFG_T, _np(tree)).items():
                dst[k].copy_(v)
    eng_t.state = eng_t.state._replace(
        step=int(st_j.step), skipped_steps=int(st_j.skipped_steps),
        opt_state=eng_t.state.opt_state._replace(step=int(st_j.opt_state.step)))
    eng_t.global_steps, eng_t.micro_steps = eng_j.global_steps, eng_j.micro_steps
    eng_t.global_tokens = eng_j.global_tokens
    eng_t.lr_scheduler.load_state_dict(eng_j.lr_scheduler.state_dict())
    return eng_t


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fragments_are_byte_identical_to_jax(tmp_path):
    eng_j = _jax_engine()
    for b in BATCHES[:2]:
        eng_j.train_batch(b)
    pj = eng_j.save_universal_checkpoint(str(tmp_path / "jax"), tag="t")
    pt = _carry(eng_j).save_universal_checkpoint(str(tmp_path / "port"), tag="t")
    files = _files(pj)
    assert files == _files(pt)
    fragments = [f for f in files if f.endswith("fp32.npy")]
    assert len(fragments) == 1 + 3 * 12       # step, and 12 leaves x (param, mu, nu)
    assert "param/layers.wq/fp32.npy" in fragments and "optim/mu.layers.wq/fp32.npy" in fragments
    for f in fragments:
        with open(os.path.join(pj, f), "rb") as a, open(os.path.join(pt, f), "rb") as b:
            assert a.read() == b.read(), f
    wq = np.load(os.path.join(pt, "param/layers.wq/fp32.npy"))
    assert wq.shape == (2, CFG_T.hidden_size, CFG_T.num_heads * CFG_T.head_size)
    assert np.load(os.path.join(pt, "optim/step/fp32.npy")).dtype == np.int32
    with open(os.path.join(pj, "meta.json")) as f:
        meta_j = json.load(f)
    with open(os.path.join(pt, "meta.json")) as f:
        meta_t = json.load(f)
    assert meta_j.keys() == meta_t.keys()
    for k in meta_j.keys() - {"config", "topology"}:
        assert meta_t[k] == meta_j[k], k


OTHER_OPTIMIZERS = {
    "lion": {"type": "lion", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "muon": {"type": "muon", "params": {"lr": 0.02, "weight_decay": 0.01}},
    "grouped_adamw": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1},
                      "param_groups": [{"pattern": "(norm|bias)", "weight_decay": 0.0},
                                       {"pattern": "layers/w_(up|down)", "lr": 3e-3}]},
}


def _engines_for(opt, params_np):
    config = dict(CONFIG, optimizer=OTHER_OPTIMIZERS[opt])
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=jax.tree.map(jnp.asarray, params_np),
                           loss_fn=lambda p, b: jl.loss_fn(CFG_J, p, b,
                                                           compute_dtype=jnp.float32)),
        config=config, devices=jax.devices()[:1])
    spec = tl.model_spec(CFG_T, compute_dtype=torch.float32)
    spec.params, spec.init_fn = from_jax_params(CFG_T, params_np), None
    eng_t, *_ = deepspeed_tpu_torch.initialize(model=spec, config=config, device="cpu")
    return eng_j, eng_t


@pytest.mark.parametrize("opt", sorted(OTHER_OPTIMIZERS))
def test_other_optimizer_tags_move_between_packages(tmp_path, opt):
    """Lion, Muon (its ``fb_state``) and a grouped AdamW (``<g>.mu.<i>``):
    a JAX tag continues in the port and a port tag in JAX, at the
    tolerances above; the port rewrites JAX's fragments byte for byte."""
    p0 = _np(jl.init(CFG_J, jax.random.PRNGKey(0)))
    p1 = _np(jl.init(CFG_J, jax.random.PRNGKey(1)))
    eng_j, eng_t = _engines_for(opt, p0)
    for b in BATCHES[:3]:
        eng_j.train_batch(b)
    pj = eng_j.save_universal_checkpoint(str(tmp_path / "jax"), tag="u3")
    losses_j, norms_j = _continue(eng_j, BATCHES[3:])
    eng_t2 = _engines_for(opt, p1)[1]
    eng_t2.load_universal_checkpoint(str(tmp_path / "jax"))
    pt = eng_t2.save_universal_checkpoint(str(tmp_path / "port"), tag="u3")
    files = _files(pj)
    assert files == _files(pt)
    fragments = [f for f in files if f.endswith("fp32.npy")]
    for f in fragments:
        with open(os.path.join(pj, f), "rb") as a, open(os.path.join(pt, f), "rb") as b:
            assert a.read() == b.read(), f
    losses_t, norms_t = _continue(eng_t2, BATCHES[3:])
    _hold(eng_t2, losses_t, norms_t, losses_j, norms_j, eng_j.state.params)

    # and back: the port's run from p0, its tag into a JAX engine from p1
    for b in BATCHES[:3]:
        eng_t.train_batch(b)
    eng_t.save_universal_checkpoint(str(tmp_path / "back"), tag="p3")
    losses_t, norms_t = _continue(eng_t, BATCHES[3:])
    eng_j2 = _engines_for(opt, p1)[0]
    eng_j2.load_universal_checkpoint(str(tmp_path / "back"))
    losses_j, norms_j = _continue(eng_j2, BATCHES[3:])
    _hold(eng_t, losses_t, norms_t, losses_j, norms_j, eng_j2.state.params)
