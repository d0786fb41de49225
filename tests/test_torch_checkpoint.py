"""Training checkpoints of the PyTorch port on the CPU, port to port
(``runtime/checkpoint/``; JAX ``tests/test_checkpoint.py`` and the loader
and RNG cases of ``tests/test_elastic_runtime.py``). No JAX: the
cross-package cases are in ``test_torch_universal.py``.

Tiny Llama (2 layers), fp32, AdamW with weight decay, clipping, GAS 2. A
resume at the same topology must continue the uninterrupted run exactly
(losses, grad norms and every master bit for bit), for each engine
(``default``, ``fast``, ``async``) and for both formats; a load copies
into the engine's own tensors, which stay contiguous ``requires_grad``
leaves.
"""

import os

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.runtime.checkpoint import (
    DecoupledCheckpointEngine, FastCheckpointEngine, SyncCheckpointEngine,
    convert_checkpoint_to_fp32_state_dict, derive_host_rng, ds_to_universal,
    get_checkpoint_engine, get_fp32_state_dict_from_checkpoint, verify_manifest)
from deepspeed_tpu_torch.runtime.checkpoint import universal, zero_to_fp32
from deepspeed_tpu_torch.runtime.checkpoint.engines import Part, StateTree
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedTPUDataLoader

CFG = tl.LlamaConfig.tiny(num_layers=2)
_RS = np.random.RandomState(0)
BATCHES = [{"tokens": _RS.randint(0, CFG.vocab_size, (4, 17)).astype(np.int32)}
           for _ in range(6)]


def _engine(ckpt_engine="default", seed=0, spec=None, cfg=CFG, **conf):
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1}},
              "gradient_clipping": 0.5, "checkpoint": {"engine": ckpt_engine},
              "steps_per_print": 0, "seed": seed, **conf}
    spec = spec or tl.model_spec(cfg, compute_dtype=torch.float32)
    eng, *_ = dst.initialize(model=spec, config=config, device="cpu")
    return eng


def _run(eng, batches):
    outs = [eng.train_batch(b) for b in batches]
    return [(float(o.loss), float(o.grad_norm)) for o in outs]


def _snapshot(eng):
    st = eng.state
    return ({k: v.detach().clone() for k, v in st.params.items()},
            {k: v.clone() for k, v in st.opt_state.mu.items()},
            {k: v.clone() for k, v in st.opt_state.nu.items()},
            (st.step, st.opt_state.step, st.skipped_steps, eng.global_steps))


def _assert_state(eng, snap):
    params, mu, nu, counters = snap
    st = eng.state
    for want, got in ((params, st.params), (mu, st.opt_state.mu), (nu, st.opt_state.nu)):
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert (st.step, st.opt_state.step, st.skipped_steps, eng.global_steps) == counters


@pytest.mark.parametrize("ckpt_engine", ["default", "fast", "async"])
def test_save_load_roundtrip(tmp_path, ckpt_engine):
    """JAX ``test_save_load_roundtrip``, and the resume held to the
    uninterrupted run bit for bit."""
    eng = _engine(ckpt_engine)
    _run(eng, BATCHES[:3])
    eng.save_checkpoint(str(tmp_path), tag="t3")
    if ckpt_engine == "async":
        eng.checkpoint_engine.wait_all()
    snap = _snapshot(eng)
    ref = _run(eng, BATCHES[3:])

    path, client = eng.load_checkpoint(str(tmp_path))      # back over the diverged state
    assert path.endswith("t3") and client == {} and eng.global_steps == 3
    _assert_state(eng, snap)
    fresh = _engine(ckpt_engine, seed=9)
    fresh.load_checkpoint(str(tmp_path), tag="t3")
    _assert_state(fresh, snap)
    assert _run(fresh, BATCHES[3:]) == ref
    assert verify_manifest(path)[0] == "verified"


def test_universal_resume_is_exact_and_in_place(tmp_path):
    eng = _engine()
    _run(eng, BATCHES[:3])
    eng.save_universal_checkpoint(str(tmp_path), tag="u3")
    snap = _snapshot(eng)
    ref = _run(eng, BATCHES[3:])

    fresh = _engine(seed=9)
    before = {k: (p.data_ptr(), p) for k, p in fresh.state.params.items()}
    mu_ptrs = {k: m.data_ptr() for k, m in fresh.state.opt_state.mu.items()}
    path, _ = fresh.load_universal_checkpoint(str(tmp_path))
    assert path.endswith("u3")
    _assert_state(fresh, snap)
    for k, p in fresh.state.params.items():
        ptr, obj = before[k]
        assert p is obj and p.data_ptr() == ptr, k           # copied into, not replaced
        assert p.is_leaf and p.requires_grad and p.is_contiguous(), k
        assert fresh.state.opt_state.mu[k].data_ptr() == mu_ptrs[k]
    assert _run(fresh, BATCHES[3:]) == ref


def test_load_refuses_another_model(tmp_path):
    """A tag of a 2-layer model into a 1-layer engine, or one of another
    width: the load raises, through both formats."""
    eng = _engine()
    _run(eng, BATCHES[:1])
    eng.save_checkpoint(str(tmp_path / "r"), tag="t")
    eng.save_universal_checkpoint(str(tmp_path / "u"), tag="t")
    shallow = _engine(cfg=tl.LlamaConfig.tiny(num_layers=1))
    with pytest.raises(ValueError, match="leaves do not match"):
        shallow.load_checkpoint(str(tmp_path / "r"), tag="t")
    with pytest.raises(ValueError, match="shape"):
        shallow.load_universal_checkpoint(str(tmp_path / "u"), tag="t")
    wide = _engine(cfg=tl.LlamaConfig.tiny(num_layers=2, intermediate_size=96))
    with pytest.raises(ValueError, match="shape"):
        wide.load_checkpoint(str(tmp_path / "r"), tag="t")
    with pytest.raises(ValueError, match="shape"):
        wide.load_universal_checkpoint(str(tmp_path / "u"), tag="t")


def test_port_layout_fragments_without_a_config(tmp_path):
    """A ModelSpec without ``config`` writes the port's names and
    ``[out, in]`` layout, and resumes exactly from them."""
    spec = tl.model_spec(CFG, compute_dtype=torch.float32)
    spec.config = None
    eng = _engine(spec=spec)
    _run(eng, BATCHES[:2])
    path = eng.save_universal_checkpoint(str(tmp_path), tag="p")
    names = sorted(os.listdir(os.path.join(path, "param")))
    assert "layers.0.wq" in names and "layers.wq" not in names
    wq = np.load(os.path.join(path, "param", "layers.0.wq", "fp32.npy"))
    np.testing.assert_array_equal(wq, eng.state.params["layers.0.wq"].detach().numpy())
    ref = _run(eng, BATCHES[2:4])
    fresh = _engine(seed=4, spec=spec)
    fresh.load_universal_checkpoint(str(tmp_path))
    assert _run(fresh, BATCHES[2:4]) == ref


def test_ds_to_universal_and_load_universal_flag(tmp_path):
    """JAX ``test_universal_checkpoint_roundtrip``: a regular tag converted
    offline (JAX layout, from the model config the tag records) loads
    through ``load_checkpoint(..., load_universal=True)``."""
    eng = _engine()
    _run(eng, BATCHES[:2])
    eng.save_checkpoint(str(tmp_path), tag="u1")
    uni = ds_to_universal(str(tmp_path), tag="u1")
    assert uni.endswith(os.path.join("u1", "universal"))
    assert os.path.isfile(os.path.join(uni, "param", "layers.wq", "fp32.npy"))
    fresh = _engine(seed=5)
    fresh.load_checkpoint(str(tmp_path), tag="u1", load_universal=True)
    assert fresh.global_steps == 2 and fresh.state.step == 2
    for k, p in eng.state.params.items():
        assert torch.equal(fresh.state.params[k], p), k
        assert torch.equal(fresh.state.opt_state.nu[k], eng.state.opt_state.nu[k]), k
    # the command line, into an exact output folder
    out = tmp_path / "converted"
    assert universal.main(["--input_folder", str(tmp_path), "--tag", "u1",
                           "--output_folder", str(out)]) == 0
    for f in ("param/layers.wq/fp32.npy", "optim/nu.embed/fp32.npy", "optim/step/fp32.npy"):
        with open(out / f, "rb") as a, open(os.path.join(uni, f), "rb") as b:
            assert a.read() == b.read(), f


def test_zero_to_fp32(tmp_path):
    eng = _engine()
    _run(eng, BATCHES[:1])
    eng.save_checkpoint(str(tmp_path), tag="z")
    sd = get_fp32_state_dict_from_checkpoint(str(tmp_path), tag="z")
    assert sd.keys() == eng.state.params.keys()
    assert sd["embed"].dtype == np.float32 and sd["layers.0.wq"].shape == (
        CFG.num_heads * CFG.head_size, CFG.hidden_size)
    out = convert_checkpoint_to_fp32_state_dict(str(tmp_path), str(tmp_path / "fp32"), tag="z")
    assert out.endswith(".npz")
    assert zero_to_fp32.main([str(tmp_path), str(tmp_path / "cli.npz")]) == 0   # latest: z
    with open(out, "rb") as a, open(tmp_path / "cli.npz", "rb") as b:
        assert a.read() == b.read()
    with np.load(out) as loaded:
        assert sorted(loaded.files) == sorted(sd)
        model = tl.build(CFG)
        model.load_state_dict({k: torch.from_numpy(loaded[k]) for k in loaded.files}, strict=True)
    for k, p in eng.state.params.items():
        np.testing.assert_array_equal(sd[k], p.detach().numpy())
        assert torch.equal(model.state_dict()[k], p.detach())


def test_engine_factory():
    assert isinstance(get_checkpoint_engine("default"), SyncCheckpointEngine)
    for alias in ("torch", "orbax", "nebula", "datastates"):
        assert isinstance(get_checkpoint_engine(alias), SyncCheckpointEngine)
    assert isinstance(get_checkpoint_engine("fast"), FastCheckpointEngine)
    for alias in ("async", "decoupled"):
        assert isinstance(get_checkpoint_engine(alias), DecoupledCheckpointEngine)
    with pytest.raises(ValueError):
        get_checkpoint_engine("nope")
    for name in ("default", "fast", "async"):       # the config knob builds each
        assert _engine(name).checkpoint_engine is None
    with pytest.raises(ValueError, match="unknown checkpoint engine"):
        _engine("nope").save_checkpoint("/nonexistent-dir-never-written")


def _tree(x):
    return StateTree({"x": Part(x, tuple(x.shape), None, 0)}, {"n": 1})


def test_async_commit_tag_is_exact_component(tmp_path):
    """Regression: commit('global_step1') must not join 'global_step10'."""
    eng = DecoupledCheckpointEngine()
    t = _tree(np.ones((4,), np.float32))
    eng.save(t, str(tmp_path / "global_step1" / "state"))
    eng.save(t, str(tmp_path / "global_step10" / "state"))
    eng.commit("global_step1")
    assert any("global_step10" in p for p in eng._pending)
    assert not any(p.endswith("global_step1/state") for p in eng._pending)
    eng.commit("global_step10")
    assert not eng._pending
    # the saver stages a tag under <tag>.tmp.stage: commit(tag) finds it there
    eng.save(t, str(tmp_path / "global_step1.tmp.stage" / "state"))
    eng.save(t, str(tmp_path / "global_step10.tmp.stage" / "state"))
    eng.commit("global_step1")
    assert [os.path.basename(os.path.dirname(p)) for p in eng._pending] == [
        "global_step10.tmp.stage"]
    eng.wait_all()
    back = eng.load(str(tmp_path / "global_step10" / "state"))
    np.testing.assert_array_equal(back.full("x"), t.leaves["x"].data)
    assert back.header == {"n": 1}


def test_async_snapshot_survives_the_next_step(tmp_path):
    """``train_batch`` right after an async ``save``, before the write is
    durable: the tag holds the state at the save."""
    from deepspeed_tpu_torch.testing import faults

    eng = _engine("async")
    _run(eng, BATCHES[:2])
    snap = _snapshot(eng)
    with faults.write_delay(_prime(eng), 0.3):
        eng.save_checkpoint(str(tmp_path), tag="a2")
        assert not os.path.exists(tmp_path / "latest")       # not durable yet
        _run(eng, BATCHES[2:4])                                # updates in place
        eng.checkpoint_engine.commit("a2")
    fresh = _engine("async", seed=3)
    fresh.load_checkpoint(str(tmp_path))
    _assert_state(fresh, snap)


def _prime(eng):
    from deepspeed_tpu_torch.runtime.checkpoint.saver import _engine_for

    return _engine_for(eng)


def test_dataloader_cursor_exact_fast_forward():
    """JAX ``test_dataloader_cursor_exact_fast_forward``."""
    ds = [{"x": np.full((2,), i, np.float32)} for i in range(64)]
    l1 = DeepSpeedTPUDataLoader(ds, batch_size=8, seed=3)
    it = iter(l1)
    assert len([next(it) for _ in range(3)]) == 3
    sd = l1.state_dict()
    assert sd["batch"] == 3
    l2 = DeepSpeedTPUDataLoader(ds, batch_size=8, seed=3)
    l2.load_state_dict(sd)
    rest_ref, rest = list(it), list(iter(l2))
    assert len(rest) == len(rest_ref) > 0
    for a, b in zip(rest, rest_ref):
        np.testing.assert_array_equal(a["x"], b["x"])
    l3 = DeepSpeedTPUDataLoader(iter(list(ds)), batch_size=8, shuffle=False)
    l4 = DeepSpeedTPUDataLoader(iter(list(ds)), batch_size=8, shuffle=False)
    ref = list(l3)[2:]
    l4.load_state_dict({"epoch": 0, "batch": 2, "seed": 0, "shuffle": False, "batch_size": 8})
    got = list(l4)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["x"], b["x"])


def test_rng_rederivation_for_new_topology():
    """JAX ``test_rng_rederivation_for_new_topology``: deterministic and
    distinct per host, step and host count (not equal to JAX's threefry
    streams, which Philox never reproduces)."""
    draw = lambda *a: torch.randint(0, 2**31 - 1, (8,), generator=derive_host_rng(*a))  # noqa: E731
    assert torch.equal(draw(42, 10, 0, 4), draw(42, 10, 0, 4))
    hosts = [draw(42, 10, i, 4) for i in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(hosts[i], hosts[j])
    assert not torch.equal(draw(42, 11, 0, 4), hosts[0])
    assert not torch.equal(draw(42, 10, 0, 2), hosts[0])


def test_universal_load_fast_forwards_loader_and_rng(tmp_path):
    """JAX ``test_engine_universal_load_fast_forwards_loader_and_rng``."""
    rng = np.random.default_rng(0)
    ds = [{"tokens": rng.integers(0, CFG.vocab_size, (17,)).astype(np.int32)}
          for _ in range(64)]
    spec = tl.model_spec(CFG, compute_dtype=torch.float32)
    conf = {"train_batch_size": 4, "steps_per_print": 0, "seed": 42}
    e1, _, loader1, _ = dst.initialize(model=spec, config=conf, training_data=ds, device="cpu")
    it = iter(loader1)
    for _ in range(3):
        e1.train_batch(next(it))
    e1.save_universal_checkpoint(str(tmp_path), tag="dl")
    next_ref = next(it)
    e2, _, loader2, _ = dst.initialize(model=spec, config=conf, training_data=ds, device="cpu")
    e2.load_universal_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(next(iter(loader2))["tokens"], next_ref["tokens"])
    assert torch.equal(torch.randint(0, 1000, (4,), generator=e2.host_rng),
                       torch.randint(0, 1000, (4,), generator=derive_host_rng(42, 3, 0, 1)))


OPTIMIZERS = {
    "adam": {"type": "adam", "params": {"lr": 1e-2, "weight_decay": 0.1}},
    "lion": {"type": "lion", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    "lamb": {"type": "lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}},
    "adagrad": {"type": "adagrad", "params": {"lr": 1e-2}},
    "sgd": {"type": "sgd", "params": {"lr": 1e-2, "momentum": 0.9, "nesterov": True}},
    "muon": {"type": "muon", "params": {"lr": 0.02, "weight_decay": 0.01}},
    "onebitadam": {"type": "onebitadam", "params": {"lr": 1e-3, "freeze_step": 2}},
    "onebitlamb": {"type": "onebitlamb", "params": {"lr": 1e-2, "freeze_step": 2}},
    "zerooneadam": {"type": "zerooneadam", "params": {"lr": 1e-3, "var_freeze_step": 2}},
    "grouped_muon": {"type": "muon", "params": {"lr": 0.02, "weight_decay": 0.01},
                     "param_groups": [{"pattern": "norm", "weight_decay": 0.0},
                                      {"pattern": "layers/w_up", "lr": 0.01}]},
}


def _state_snapshot(eng):
    from deepspeed_tpu_torch.ops.optimizers import state_scalars, state_tensors

    st = eng.state
    tensors = {f"{g}/{k}": v.detach().clone() for g, ts in
               [("params", st.params)] + list(state_tensors(st.opt_state).items())
               for k, v in ts.items()}
    return tensors, state_scalars(st.opt_state), (st.step, st.skipped_steps, eng.global_steps)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("universal", [False, True])
def test_every_optimizer_resumes_bit_for_bit(tmp_path, opt, universal):
    """Every optimizer's state (each tensor by its state path, each step)
    round-trips through a regular tag and a universal one, and the resumed
    run is the uninterrupted one bit for bit."""
    eng = _engine(optimizer=OPTIMIZERS[opt])
    _run(eng, BATCHES[:3])
    save = eng.save_universal_checkpoint if universal else eng.save_checkpoint
    save(str(tmp_path), tag="t3")
    snap = _state_snapshot(eng)
    ref = _run(eng, BATCHES[3:])
    fresh = _engine(seed=9, optimizer=OPTIMIZERS[opt])
    (fresh.load_universal_checkpoint if universal else fresh.load_checkpoint)(str(tmp_path))
    got = _state_snapshot(fresh)
    assert got[0].keys() == snap[0].keys() and got[1:] == snap[1:]
    for k, v in snap[0].items():
        assert torch.equal(got[0][k], v), k
    assert _run(fresh, BATCHES[3:]) == ref
