"""Checkpoints of the PyTorch port across topologies, over gloo ranks on the
CPU (``tests/_torch_dist_worker.py``'s ``ckpt`` scenario; no JAX).

Tiny Llama (hidden 64, 2 layers, 4 heads on 2 kv heads, vocab 128), AdamW
with weight decay, clipping, GAS 2, fp32; 3 steps, a regular and a
universal tag, then 3 more steps.

- At the saving topology each tag resumes the uninterrupted run bit for
  bit (losses, grad norms, every master).
- At another world size and ZeRO stage (2 ranks at stage 3 ↔ 4 ranks at
  stages 1 and 2) the continuation matches the uninterrupted run within
  the ZeRO limit of ``PERF.md`` §2 (rtol / atol 2e-4): the sums run in
  other orders, the state is the same.
"""

import numpy as np
import pytest
import torch
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu_torch.models import llama as tl

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64, rope_theta=10000.0)
BEFORE, STEPS = 3, 6
TOL = dict(rtol=2e-4, atol=2e-4)


def _config(stage):
    return {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "zero_optimization": {"stage": stage}, "gradient_clipping": 0.5,
            "steps_per_print": 0, "seed": 3}


def _inputs(tmp):
    cfg = tl.LlamaConfig(**LLAMA)
    params = tl.init(cfg, torch.Generator().manual_seed(11))
    rng = np.random.default_rng(5)
    arrays = {f"param/{k}": v.numpy() for k, v in params.items()}
    for i in range(STEPS):
        arrays[f"batch/{i}/tokens"] = rng.integers(0, LLAMA["vocab_size"], (8, 17),
                                                   dtype=np.int32)
    path = tmp / "inputs.npz"
    np.savez(path, **arrays)
    return str(path)


def _job(tmp, mode, stage, **kw):
    return dict({"scenario": "ckpt", "family": "llama", "cfg": LLAMA, "npz": _inputs(tmp),
                 "dir": str(tmp / "ckpt"), "before": BEFORE, "steps": STEPS, "mode": mode,
                 "config": _config(stage)}, **kw)


def _equal(got, want, prefix_got, prefix_want, exact):
    keys = [k[len(prefix_want):] for k in want if k.startswith(prefix_want)]
    assert keys
    for k in keys:
        a, b = got[prefix_got + k], want[prefix_want + k]
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=prefix_got + k)
        else:
            np.testing.assert_allclose(a, b, err_msg=prefix_got + k, **TOL)


@pytest.fixture(scope="module")
def saved_at_2(tmp_path_factory):
    """2 ranks at ZeRO-3: the uninterrupted run and both tags."""
    tmp = tmp_path_factory.mktemp("save2")
    return tmp, spawn(_job(tmp, "save", 3), 2, _spawn_out(tmp, "save2"))


def _spawn_out(tmp, name):
    out = tmp / name
    out.mkdir()
    return out


def test_same_topology_resume_is_exact(saved_at_2):
    _, ranks = saved_at_2
    for r in ranks:
        for kind in ("reg", "uni"):
            _equal(r, ranks[0], f"{kind}/", "run/", exact=True)
            np.testing.assert_array_equal(r[f"{kind}/step"], [STEPS, STEPS])


@pytest.fixture(scope="module")
def resumed_at_4(saved_at_2):
    """Both tags resumed by 4 ranks in one job: the regular tag at stage 1,
    the universal tag at stage 2."""
    tmp, _ = saved_at_2
    job = _job(tmp, "load", 1, resumes=[["reg", _config(1)], ["uni", _config(2)]])
    return spawn(job, 4, _spawn_out(tmp, "load4"))


@pytest.mark.parametrize("kind", ["reg", "uni"])
def test_resume_at_four_ranks(saved_at_2, resumed_at_4, kind):
    """Saved by 2 ranks at stage 3, resumed by 4 at stage 1 (regular tag)
    or 2 (universal tag)."""
    _, ranks = saved_at_2
    for r in resumed_at_4:
        _equal(r, ranks[0], f"{kind}/", "run/", exact=False)
        np.testing.assert_array_equal(r[f"{kind}/step"], [STEPS, STEPS])


def test_save_at_four_ranks_resume_at_two(tmp_path):
    """The other way round: 4 ranks at stage 1 save, 2 at stage 3 resume
    the regular tag."""
    saved = spawn(_job(tmp_path, "save", 1), 4, _spawn_out(tmp_path, "save4"))
    for r in saved:
        _equal(r, saved[0], "reg/", "run/", exact=True)
    got = spawn(_job(tmp_path, "load", 3, resumes=[["reg", _config(3)]]), 2,
                _spawn_out(tmp_path, "load2"))
    for r in got:
        _equal(r, saved[0], "reg/", "run/", exact=False)
