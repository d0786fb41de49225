"""Activation checkpointing of the PyTorch port
(``deepspeed_tpu_torch/runtime/activation_checkpointing``) against the JAX
package's, on the CPU.

- The registry: names, saved names and policy names equal JAX's;
  ``configure`` / ``reset``; an unknown policy raises.
- ``checkpoint(f)`` under every policy against plain autograd at rtol 1e-6
  (the oracle of JAX ``TestRematPolicies::test_checkpoint_matches_plain``),
  and the offload policy's grads against JAX's offload grads (1e-5).
- Llama and GPT with ``remat`` on both sides: the loss and every leaf grad
  against JAX's under the same policy (loss 1e-5 relative, grads 1e-5
  absolute + 1e-4 relative), and bit for bit equal across all the port's
  policies and the port without remat (the recompute runs the same ops on
  the same inputs).
- ``saved_bytes``: none >= save_big_matmuls >= save_attn_out >= full = 0 on
  a Llama block; the lint that every name a policy saves is marked by the
  port's families.
- The engine: ``activation_checkpointing.policy`` sets the default of
  ``checkpoint()`` and nothing else (a family's blocks follow its own
  ``remat``): state dicts after 3 steps equal those of an engine without
  the block; a family with ``remat`` trains bit for bit as without, and
  within 1e-5 of the JAX engine with remat.
- ZeRO stage 3 with remat on 2 gloo ranks equals stage 0 within 2e-4, and
  the recompute gathers each block's leaves again: one more all-gather per
  sharded block leaf and step, the same reduce-scatters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jac
from deepspeed_tpu.runtime.engine import ModelSpec as JaxModelSpec
from deepspeed_tpu_torch.comm.mesh import MeshManager
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models.convert import from_jax_params, to_jax_params
from deepspeed_tpu_torch.ops.rotary import rope_frequencies
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ac
from deepspeed_tpu_torch.runtime.partitioning import Partitioner, shard_dim

POLICIES = sorted(p for p in ac.POLICIES if p != "none")


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #
def test_policy_names_equal_jax():
    assert ac.CHECKPOINT_NAMES == jac.CHECKPOINT_NAMES
    assert ac.MATMUL_CHECKPOINT_NAMES == jac.MATMUL_CHECKPOINT_NAMES
    assert ac.POLICY_SAVED_NAMES == jac.POLICY_SAVED_NAMES
    assert set(ac.POLICIES) == set(jac.POLICIES)
    assert ac.get_policy("none") is None
    with pytest.raises(ValueError, match="unknown remat policy"):
        ac.get_policy("definitely_not_a_policy")
    try:
        cfg = ac.configure(checkpoint_in_cpu=True)
        assert cfg.policy == "offload" and ac.is_configured()
        assert ac.get_policy().name == "offload"
    finally:
        ac.reset()
    assert not ac.is_configured() and ac.get_policy().name == "full"
    gen = ac.model_parallel_cuda_manual_seed(5, device="cpu")
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(5)))


# --------------------------------------------------------------------------- #
# checkpoint() on a small function
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoint_matches_plain(policy):
    rs = np.random.RandomState(0)
    W = torch.from_numpy(rs.randn(16, 16).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rs.randn(4, 16).astype(np.float32)).requires_grad_()

    def f(x):
        h = ac.checkpoint_name(torch.tanh(x @ W), "attn_out")
        return torch.tanh(ac.checkpoint_name(h @ W, "attn_mix")).sum()

    g_plain = torch.autograd.grad(f(x), (x, W))
    g_remat = torch.autograd.grad(ac.checkpoint(f, x, policy=policy), (x, W))
    for a, b in zip(g_plain, g_remat):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)
    # the wrapper form and the reference's autograd.Function name agree
    g_wrap = torch.autograd.grad(ac.checkpoint_wrapper(f, policy=policy)(x), (x, W))
    for a, b in zip(g_remat, g_wrap):
        assert torch.equal(a, b)


def test_offload_grads_match_jax():
    rs = np.random.RandomState(1)
    W, x = rs.randn(8, 8).astype(np.float32), rs.randn(4, 8).astype(np.float32)
    from jax.ad_checkpoint import checkpoint_name

    def fj(x):
        h = checkpoint_name(jnp.tanh(x @ W), "residual")
        return (h @ W).sum()

    g_j = jax.jit(jax.grad(lambda x: jac.checkpoint(fj, x, policy="offload")))(x)
    Wt = torch.from_numpy(W)

    def ft(x):
        return (ac.checkpoint_name(torch.tanh(x @ Wt), "residual") @ Wt).sum()

    xt = torch.from_numpy(x).requires_grad_()
    parked = ac.saved_bytes(ft, xt, policy="offload")
    assert parked > 0
    (g_t,) = torch.autograd.grad(ac.checkpoint(ft, xt, policy="offload"), (xt,))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# the families under remat
# --------------------------------------------------------------------------- #
FAMILIES = {"llama": (jl, tl, jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()),
            "gpt": (jgpt, tgpt, jgpt.GPTConfig.tiny(), tgpt.GPTConfig.tiny())}


def _port_grads(tmod, cfg_t, params_np, tokens):
    params = {k: v.clone().requires_grad_() for k, v in params_np.items()}
    loss, _ = tmod.loss_fn(cfg_t, params, {"tokens": torch.from_numpy(tokens)},
                           compute_dtype=torch.float32)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in params.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_remat_matches_jax_and_is_bit_identical_across_policies(family):
    jmod, tmod, cfg_j, cfg_t = FAMILIES[family]
    params_j = jmod.init(cfg_j, jax.random.PRNGKey(0))
    params_t = from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j))
    tokens = np.random.RandomState(3).randint(0, cfg_t.vocab_size, (2, 17)).astype(np.int32)
    ref_loss, ref_grads = _port_grads(tmod, cfg_t, params_t, tokens)
    for policy in POLICIES + ["none", "dots"]:
        rc_t = dataclasses.replace(cfg_t, remat=True, remat_policy=policy)
        loss, grads = _port_grads(tmod, rc_t, params_t, tokens)
        assert torch.equal(loss, ref_loss), (family, policy)
        for k, g in grads.items():
            assert torch.equal(g, ref_grads[k]), (family, policy, k)
    for policy in ("full", "save_big_matmuls", "dots"):
        rc_j = dataclasses.replace(cfg_j, remat=True, remat_policy=policy)
        jbatch = {"tokens": jnp.asarray(tokens)}
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p: jmod.loss_fn(rc_j, p, jbatch, compute_dtype=jnp.float32)[0]))(params_j)
        rc_t = dataclasses.replace(cfg_t, remat=True, remat_policy=policy)
        loss_t, grads_t = _port_grads(tmod, rc_t, params_t, tokens)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        got, want = _leaves(to_jax_params(cfg_t, grads_t)), _leaves(grads_j)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{family} {policy} {name}")


def _llama_block_args(seq=64):
    cfg = tl.LlamaConfig.tiny()
    params = tl.init(cfg, torch.Generator().manual_seed(0))
    p = {name: params[f"layers.0.{name}"] for name in tl._layer_shapes(cfg)}
    cos, sin = rope_frequencies(cfg.head_size, cfg.max_seq_len, cfg.rope_theta)
    x = torch.randn(2, seq, cfg.hidden_size, generator=torch.Generator().manual_seed(1))

    def block(x, p):
        return tl._block(cfg, x, p, cos, sin, None)

    return block, x.requires_grad_(), {k: v.requires_grad_() for k, v in p.items()}


def test_saved_bytes_order():
    block, x, p = _llama_block_args()
    vals = {pol: ac.saved_bytes(block, x, p, policy=pol)
            for pol in ("none", "save_big_matmuls", "save_attn_out", "full",
                        "dots_saveable", "offload")}
    assert vals["none"] >= vals["save_big_matmuls"] >= vals["save_attn_out"] \
        > vals["full"] == 0, vals
    assert vals["dots_saveable"] >= vals["save_big_matmuls"], vals
    # save_attn_out keeps exactly one [b, s, hidden] fp32 value
    assert vals["save_attn_out"] == x.numel() * 4, vals
    assert vals["offload"] > 0, vals


class _Names(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is ac._NAMED_OP:
            self.names.append(args[1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_policy_names_are_marked_by_the_families(family):
    """Lint: each family's CHECKPOINT_NAMES_EMITTED is what its training
    forward marks (seen as ``dstt::checkpoint_name`` ops in a region that
    saves every matmul name), equal to JAX's list, and every name a policy
    saves (``residual`` and ``block_out`` apart, reserved for user models
    as in JAX) is marked by some family."""
    jmod, tmod, _, cfg_t = FAMILIES[family]
    assert tmod.CHECKPOINT_NAMES_EMITTED == jmod.CHECKPOINT_NAMES_EMITTED
    params = tmod.init(cfg_t, torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 17), dtype=torch.long)
    lint = ac.Policy("lint", marked=ac.MATMUL_CHECKPOINT_NAMES)
    mode = _Names()
    with mode:
        ac._region(lambda: tmod.loss_fn(cfg_t, params, {"tokens": tokens},
                                        compute_dtype=torch.float32), lint)()
    assert set(mode.names) == set(tmod.CHECKPOINT_NAMES_EMITTED), mode.names
    emitted = set(tl.CHECKPOINT_NAMES_EMITTED) | set(tgpt.CHECKPOINT_NAMES_EMITTED)
    for policy, names in ac.POLICY_SAVED_NAMES.items():
        assert set(names) - {"residual", "block_out"} <= emitted, policy
    for policy in ("save_attn_out", "save_big_matmuls"):
        assert set(tmod.CHECKPOINT_NAMES_EMITTED) & set(ac.POLICY_SAVED_NAMES[policy])


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 0.5,
          "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
          "steps_per_print": 0}


def _batches(vocab, n=3):
    rs = np.random.RandomState(0)
    return [{"tokens": rs.randint(0, vocab, (4, 17)).astype(np.int32)} for _ in range(n)]


def _port_engine(cfg, params, conf=CONFIG):
    spec = deepspeed_tpu_torch.ModelSpec(
        params=params, loss_fn=lambda p, b: tl.loss_fn(cfg, p, b, compute_dtype=torch.float32))
    eng, *_ = deepspeed_tpu_torch.initialize(model=spec, config=conf, device="cpu")
    return eng


def test_engine_policy_sets_the_default_only_and_family_remat_matches():
    cfg_j, cfg_t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    params_j = jl.init(cfg_j, jax.random.PRNGKey(0))
    params_t = from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j))
    batches = _batches(cfg_t.vocab_size)
    base = _port_engine(cfg_t, params_t)
    base_losses = [float(base.train_batch(b).loss) for b in batches]
    try:
        # the config's policy alone: inert for a family without remat
        off = _port_engine(cfg_t, params_t,
                           dict(CONFIG, activation_checkpointing={"policy": "save_attn_out"}))
        assert ac.is_configured() and ac.get_policy().name == "save_attn_out"
        assert [float(off.train_batch(b).loss) for b in batches] == base_losses
        for k, p in base.state.params.items():
            assert torch.equal(p, off.state.params[k]), k
    finally:
        ac.reset()
    # the family's remat: the same step, bit for bit
    rc_t = dataclasses.replace(cfg_t, remat=True, remat_policy="full")
    on = _port_engine(rc_t, params_t)
    assert [float(on.train_batch(b).loss) for b in batches] == base_losses
    for k, p in base.state.params.items():
        assert torch.equal(p, on.state.params[k]), k
    # and JAX's engine with remat
    rc_j = dataclasses.replace(cfg_j, remat=True, remat_policy="full")
    eng_j, *_ = deepspeed_tpu.initialize(
        model=JaxModelSpec(params=params_j, loss_fn=lambda p, b: jl.loss_fn(
            rc_j, p, b, compute_dtype=jnp.float32)),
        config=CONFIG, devices=jax.devices()[:1])
    losses_j = [float(eng_j.train_batch(b).loss) for b in batches]
    np.testing.assert_allclose(base_losses, losses_j, rtol=1e-5)
    got = _leaves(to_jax_params(cfg_t, {k: v.detach() for k, v in on.state.params.items()}))
    for name, want in _leaves(eng_j.state.params).items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=2e-4, err_msg=name)


LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64, rope_theta=10000.0)


def _zero_config(stage):
    return {"train_batch_size": 8, "zero_optimization": {"stage": stage},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "steps_per_print": 0}


def _zero_job(tmp, cfg, runs, steps=4):
    cfg_t = tl.LlamaConfig(**LLAMA)
    arrs = {f"param/{k}": v.numpy()
            for k, v in tl.init(cfg_t, torch.Generator().manual_seed(0)).items()}
    rs = np.random.RandomState(5)
    for i in range(steps):
        arrs[f"batch/{i}/tokens"] = rs.randint(0, LLAMA["vocab_size"], (8, 33)).astype(np.int32)
    np.savez(tmp / "in.npz", **arrs)
    return {"scenario": "train", "family": "llama", "cfg": cfg, "npz": str(tmp / "in.npz"),
            "runs": [{"name": n, "config": _zero_config(s), "steps": steps} for n, s in runs]}


def test_zero3_with_remat_equals_stage0_and_regathers(tmp_path):
    remat = dict(LLAMA, remat=True, remat_policy="full")
    # one spawn of two ranks runs all three jobs (remat at stages 0 and 3,
    # plain stage 3 under its own cfg): each spawn pays its ranks' start and
    # the group's set-up, and two spawns under a loaded lane met the spawn
    # deadline
    job = _zero_job(tmp_path, remat, [("s0", 0), ("s3", 3)])
    job["runs"].append({"name": "plain_s3", "config": _zero_config(3),
                        "steps": job["runs"][0]["steps"], "cfg": LLAMA})
    got = spawn(job, 2, tmp_path)
    plain = [{k[len("plain_"):]: v for k, v in g.items() if k.startswith("plain_")}
             for g in got]
    for r in range(2):
        np.testing.assert_allclose(got[r]["s3/losses"], got[r]["s0/losses"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got[r]["s3/grad_norm"], got[r]["s0/grad_norm"],
                                   rtol=2e-4, atol=2e-4)
        for k in got[r]:
            if k.startswith("s0/param/"):
                np.testing.assert_allclose(got[r]["s3/" + k[3:]], got[r][k], rtol=0,
                                           atol=2e-4, err_msg=k)
        # remat and plain stage 3 take the same steps
        np.testing.assert_array_equal(got[r]["s3/losses"], plain[r]["s3/losses"])
    # the recompute re-gathers every sharded block leaf once more a step;
    # the backward reduce-scatters each sharded leaf once, as without remat
    cfg_t = tl.LlamaConfig(**LLAMA)
    shapes = {k: s for k, (s, _) in tl.param_shapes(cfg_t).items()}
    part = Partitioner(MeshManager.from_sizes({"data": 2}), 3, keep_trivial=True)
    dims = {k: shard_dim(s) for k, s in
            part.opt_state_specs(tl.param_logical_axes(cfg_t), shapes).items()}
    block_sharded = sum(1 for k, d in dims.items() if d is not None and k.startswith("layers."))
    assert block_sharded > 0
    ag_remat, ag_plain = got[0]["s3/comm/all_gather"][0], plain[0]["s3/comm/all_gather"][0]
    assert ag_remat - ag_plain == block_sharded, (ag_remat, ag_plain, block_sharded)
    np.testing.assert_array_equal(got[0]["s3/comm/reduce_scatter"],
                                  plain[0]["s3/comm/reduce_scatter"])
