"""The two-phase commit of the port's checkpoints under planted faults, on the
CPU — the checkpoint cases of JAX ``tests/test_fault_tolerance.py``
(:67-346) and ``tests/test_elastic_runtime.py`` (:244-325, :483-533),
through the port's injectors (``deepspeed_tpu_torch.testing.faults``): a
crash mid-save keeps the previous tag, corrupt state or manifest walks
back, nothing verifiable is a fresh start, a corrupt tag named explicitly
raises, a missing ``latest`` dir is scanned past, I/O retries with
backoff, ``keep_last_n``, the async commit before ``latest``, out-of-order
finalizes, the ``latest`` write retried without a re-save, ``destroy``
draining the writer (and raising its failure), the universal fragments'
crash, GC and corruption cases.

The model is JAX's fault-test model (one leaf ``w`` of 8, loss
``sum((w * x)^2)``) under AdamW (the port has no SGD yet).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.runtime.checkpoint import (MANIFEST_NAME, is_universal_tag,
                                                    newest_verifiable_tag, tag_candidates,
                                                    verify_manifest)
from deepspeed_tpu_torch.runtime.checkpoint import saver as saver_mod
from deepspeed_tpu_torch.runtime.checkpoint import universal as uni
from deepspeed_tpu_torch.runtime.checkpoint.manifest import retention_sweep, with_io_retries
from deepspeed_tpu_torch.runtime.checkpoint.saver import _engine_for
from deepspeed_tpu_torch.testing import faults

STATE_FILE = "state.r0.bin"      # the fast engine's file of rank 0


def _spec():
    return dst.ModelSpec(loss_fn=lambda p, b: ((p["w"] * b["x"]) ** 2).sum(),
                         init_fn=lambda g: {"w": torch.ones(8)})


def _mk_engine(ckpt_engine="fast", checkpoint=None):
    config = {"train_batch_size": 8, "optimizer": {"type": "adamw", "params": {"lr": 0.1}},
              "steps_per_print": 0, "checkpoint": {"engine": ckpt_engine, **(checkpoint or {})}}
    eng, *_ = dst.initialize(model=_spec(), config=config, device="cpu")
    return eng


_BATCH = {"x": np.linspace(0.5, 1.5, 8, dtype=np.float32)}


def _w(engine):
    return engine.state.params["w"].detach().clone()


def _rel_count(engine, name):
    return engine.reliability_counts.get(f"Reliability/{name}", 0)


def _latest(tmp_path):
    with open(tmp_path / "latest") as f:
        return f.read().strip()


# --------------------------------------------------------------------------- #
# crash-consistent save (two-phase commit)
# --------------------------------------------------------------------------- #
def test_atomic_save_writes_verified_manifest(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    path = engine.save_checkpoint(str(tmp_path), tag="a1")
    assert path.endswith("a1") and os.path.isdir(path)
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        files = json.load(f)["files"]
    assert f"state/{STATE_FILE}" in files and "meta.json" in files
    assert len(files[f"state/{STATE_FILE}"]["sha256"]) == 64
    assert verify_manifest(path)[0] == "verified"
    assert _latest(tmp_path) == "a1"
    assert _rel_count(engine, "checkpoint_saved") == 1


@pytest.mark.parametrize("fault", ["crash_after_save", "truncated_write"])
def test_crash_mid_save_preserves_previous_checkpoint(tmp_path, fault):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="good")
    ref_w = _w(engine)
    engine.train_batch(_BATCH)  # diverge past the checkpoint

    ce = _engine_for(engine)
    with getattr(faults, fault)(ce):
        with pytest.raises(faults.SimulatedCrash):
            engine.save_checkpoint(str(tmp_path), tag="torn")
    assert "save" not in ce.__dict__            # the injector unwound exactly

    assert _latest(tmp_path) == "good"
    assert tag_candidates(str(tmp_path)) == ["good"]
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert path.endswith("good") and engine.global_steps == 1
    assert torch.equal(_w(engine), ref_w)
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="torn")   # reclaims the stale stage
    assert verify_manifest(str(tmp_path / "torn"))[0] == "verified"


def test_corrupt_state_triggers_walkback_restore(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="t1")
    w1 = _w(engine)
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="t2")

    faults.corrupt_file(str(tmp_path / "t2"), filename=STATE_FILE)
    assert verify_manifest(str(tmp_path / "t2"))[0] == "corrupt"
    path, _ = engine.load_checkpoint(str(tmp_path))     # latest → t2 (corrupt)
    assert path.endswith("t1") and engine.global_steps == 1
    assert torch.equal(_w(engine), w1)
    assert _rel_count(engine, "checkpoint_rollback") == 1
    assert _rel_count(engine, "checkpoint_loaded") == 1
    shutil.rmtree(tmp_path / "t1")
    with pytest.raises(RuntimeError, match="corrupt"):   # named, no fallback left
        engine.load_checkpoint(str(tmp_path), tag="t2")


def test_corrupt_manifest_triggers_walkback(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="m1")
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="m2")
    mpath = tmp_path / "m2" / MANIFEST_NAME
    with open(mpath) as f:
        doc = json.load(f)
    doc["files"][f"state/{STATE_FILE}"]["sha256"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(doc, f)
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert path.endswith("m1")
    assert newest_verifiable_tag(str(tmp_path)) == "m1"


def test_no_verifiable_checkpoint_returns_fresh_start(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="only")
    faults.corrupt_file(str(tmp_path / "only"), filename=STATE_FILE)
    w = _w(engine)
    path, client = engine.load_checkpoint(str(tmp_path))
    assert path is None and client == {}
    assert torch.equal(_w(engine), w)                   # untouched
    assert engine.load_checkpoint(str(tmp_path / "empty")) == (None, {})


def test_missing_latest_tag_dir_falls_back_to_scan(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="keep")
    engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="gone")
    shutil.rmtree(tmp_path / "gone")
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert path.endswith("keep") and engine.global_steps == 1


def test_io_retry_backoff_then_success(tmp_path):
    engine = _mk_engine(checkpoint={"io_retries": 3, "io_backoff_s": 0.01})
    engine.train_batch(_BATCH)
    ce = _engine_for(engine)
    with faults.io_errors(ce, fail_times=2) as state:
        engine.save_checkpoint(str(tmp_path), tag="r1")
    assert state["calls"] == 3 and state["failures"] == 2
    assert verify_manifest(str(tmp_path / "r1"))[0] == "verified"
    assert _rel_count(engine, "checkpoint_io_retry") == 2
    with faults.io_errors(ce, fail_times=10):
        with pytest.raises(OSError):
            engine.save_checkpoint(str(tmp_path), tag="r2")
    assert _latest(tmp_path) == "r1"


def test_with_io_retries_backoff_units():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    retried = []
    assert with_io_retries(flaky, retries=4, backoff_s=0.001,
                           on_retry=lambda n, e: retried.append(n)) == "ok"
    assert calls["n"] == 3 and retried == [1, 2]
    with pytest.raises(faults.SimulatedCrash):
        with_io_retries(lambda: (_ for _ in ()).throw(faults.SimulatedCrash("boom")),
                        retries=5, backoff_s=0.001)


def test_keep_last_n_retention(tmp_path):
    engine = _mk_engine(checkpoint={"keep_last_n": 2})
    for i in range(4):
        engine.train_batch(_BATCH)
        engine.save_checkpoint(str(tmp_path), tag=f"s{i}")
    assert tag_candidates(str(tmp_path)) == ["s3", "s2"]
    assert _latest(tmp_path) == "s3"
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert path.endswith("s3")
    assert _rel_count(engine, "checkpoint_gc") == 2


def test_retention_sweep_protects_latest(tmp_path):
    for i, tag in enumerate(["a", "b", "c"]):
        os.makedirs(tmp_path / tag / "state")
        with open(tmp_path / tag / "meta.json", "w") as f:
            json.dump({"global_steps": i}, f)
    with open(tmp_path / "latest", "w") as f:
        f.write("a")
    assert retention_sweep(str(tmp_path), keep_last_n=1) == 1
    assert sorted(os.listdir(tmp_path)) == ["a", "c", "latest"]


def test_async_engine_commit_before_latest(tmp_path):
    engine = _mk_engine(ckpt_engine="async")
    engine.train_batch(_BATCH)
    ce = _engine_for(engine)
    with faults.write_delay(ce, 0.3):
        engine.save_checkpoint(str(tmp_path), tag="bg")
        assert not os.path.exists(tmp_path / "latest")
        ce.wait_all()
    assert verify_manifest(str(tmp_path / "bg"))[0] == "verified"
    assert _latest(tmp_path) == "bg"
    # a background failure is never published and raises at the next commit
    engine.train_batch(_BATCH)
    with faults.io_errors(ce.inner, fail_times=1):
        engine.save_checkpoint(str(tmp_path), tag="fail")
        with pytest.raises(OSError):
            ce.wait_all()
    assert _latest(tmp_path) == "bg"


def test_async_out_of_order_finalize_keeps_latest_monotonic(tmp_path):
    engine = _mk_engine(ckpt_engine="async")
    ce = _engine_for(engine)
    engine.train_batch(_BATCH)
    with faults.write_delay(ce, 0.5):
        engine.save_checkpoint(str(tmp_path), tag="old_slow")  # step 1
        engine.train_batch(_BATCH)
    engine.save_checkpoint(str(tmp_path), tag="new_fast")      # step 2
    ce.wait_all()
    assert _latest(tmp_path) == "new_fast"
    assert verify_manifest(str(tmp_path / "old_slow"))[0] == "verified"
    assert verify_manifest(str(tmp_path / "new_fast"))[0] == "verified"


def test_failed_latest_write_retries_without_resave(tmp_path, monkeypatch):
    engine = _mk_engine(checkpoint={"io_retries": 2, "io_backoff_s": 0.01})
    engine.train_batch(_BATCH)
    ce = _engine_for(engine)
    saves = {"n": 0}
    orig_save = ce.save

    def counting_save(*a, **kw):
        saves["n"] += 1
        return orig_save(*a, **kw)

    orig_latest = saver_mod.write_latest
    fails = {"n": 0}

    def flaky_latest(save_dir, tag):
        if fails["n"] < 1:
            fails["n"] += 1
            raise OSError("injected 'latest' write failure")
        return orig_latest(save_dir, tag)

    undo = faults.patch_attr(ce, "save", counting_save)
    monkeypatch.setattr(saver_mod, "write_latest", flaky_latest)
    try:
        path = engine.save_checkpoint(str(tmp_path), tag="p1")
    finally:
        undo()
    assert "save" not in ce.__dict__
    assert saves["n"] == 1 and fails["n"] == 1
    assert verify_manifest(path)[0] == "verified"
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    assert _latest(tmp_path) == "p1"
    assert _rel_count(engine, "checkpoint_io_retry") == 1


def test_engine_destroy_drains_async_writer(tmp_path):
    engine = _mk_engine(ckpt_engine="async")
    engine.train_batch(_BATCH)
    ce = _engine_for(engine)
    with faults.write_delay(ce, 0.3):
        engine.save_checkpoint(str(tmp_path), tag="d1")
        engine.destroy()
    assert verify_manifest(str(tmp_path / "d1"))[0] == "verified"
    assert _latest(tmp_path) == "d1"
    # a failed background save is raised (and logged), not swallowed
    with faults.io_errors(ce.inner, fail_times=1):
        engine.save_checkpoint(str(tmp_path), tag="d2")
        with pytest.raises(OSError):
            engine.destroy()
    engine.destroy()                            # drained: safe to call again
    assert _latest(tmp_path) == "d1"


def test_default_checkpoint_artifacts_deterministic(tmp_path):
    """JAX ``test_default_checkpoint_artifacts_byte_identical_pin``: the
    artifact set of a save, and its state bytes, are deterministic."""
    def run(sub):
        e = _mk_engine()
        e.train_batch(_BATCH)
        path = e.save_checkpoint(str(tmp_path / sub), tag="t")
        e.load_checkpoint(str(tmp_path / sub))
        assert not any(k.startswith("Reliability/elastic/") for k in e.reliability_counts)
        return path

    p1, p2 = run("a"), run("b")
    inv = sorted(os.path.relpath(os.path.join(dp, f), p1)
                 for dp, _dn, fns in os.walk(p1) for f in fns)
    assert inv == ["manifest.json", "meta.json", f"state/{STATE_FILE}"]
    with open(os.path.join(p1, "state", STATE_FILE), "rb") as f1, \
            open(os.path.join(p2, "state", STATE_FILE), "rb") as f2:
        assert f1.read() == f2.read()


# --------------------------------------------------------------------------- #
# universal fragments
# --------------------------------------------------------------------------- #
def test_crash_mid_universal_save_walks_back(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    engine.save_universal_checkpoint(str(tmp_path), tag="good")
    ref_w = _w(engine)
    engine.train_batch(_BATCH)
    with faults.crash_after_save(uni.FRAGMENT_WRITER):
        with pytest.raises(faults.SimulatedCrash):
            engine.save_universal_checkpoint(str(tmp_path), tag="torn")
    assert "save" not in uni.FRAGMENT_WRITER.__dict__
    assert _latest(tmp_path) == "good"
    assert tag_candidates(str(tmp_path)) == ["good"]
    path, _ = engine.load_universal_checkpoint(str(tmp_path))
    assert path.endswith("good") and engine.global_steps == 1
    assert torch.equal(_w(engine), ref_w)
    engine.train_batch(_BATCH)
    engine.save_universal_checkpoint(str(tmp_path), tag="torn")
    assert verify_manifest(str(tmp_path / "torn"))[0] == "verified"


def test_universal_save_failure_gcs_stage_dir(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    with faults.io_errors(uni.FRAGMENT_WRITER, fail_times=5):
        with pytest.raises(OSError):
            engine.save_universal_checkpoint(str(tmp_path), tag="g1")
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    engine.config.checkpoint.io_retries = 2
    engine.config.checkpoint.io_backoff_s = 0.01
    with faults.io_errors(uni.FRAGMENT_WRITER, fail_times=1) as st:
        engine.save_universal_checkpoint(str(tmp_path), tag="g2")
    assert st["failures"] == 1
    assert verify_manifest(str(tmp_path / "g2"))[0] == "verified"


def test_corrupt_fragment_walks_back_to_older_universal_tag(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    engine.save_universal_checkpoint(str(tmp_path), tag="u1")
    w1 = _w(engine)
    engine.train_batch(_BATCH)
    engine.save_universal_checkpoint(str(tmp_path), tag="u2")
    faults.corrupt_fragment(str(tmp_path / "u2"), name="w")
    assert verify_manifest(str(tmp_path / "u2"))[0] == "corrupt"
    path, _ = engine.load_universal_checkpoint(str(tmp_path))
    assert path.endswith("u1") and engine.global_steps == 1
    assert torch.equal(_w(engine), w1)
    assert _rel_count(engine, "checkpoint_rollback") == 1


def test_universal_fragments_carry_sha256_and_fsync_index(tmp_path):
    engine = _mk_engine()
    engine.train_batch(_BATCH)
    path = engine.save_universal_checkpoint(str(tmp_path), tag="s1")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "universal2"
    ent = meta["index"]["param"]["w"]
    assert len(ent["sha256"]) == 64 and ent["bytes"] > 0
    assert verify_manifest(path)[0] == "verified"
    assert is_universal_tag(path)


def test_regular_load_checkpoint_delegates_to_universal_loader(tmp_path):
    e1 = _mk_engine()
    e1.train_batch(_BATCH)
    e1.save_universal_checkpoint(str(tmp_path), tag="u")
    ref_w = _w(e1)
    e2 = _mk_engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("u") and e2.global_steps == 1
    assert torch.equal(_w(e2), ref_w)
    assert _rel_count(e2, "elastic/resumes") == 1
