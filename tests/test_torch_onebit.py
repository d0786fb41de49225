"""The port's 1-bit optimizers (``ops/onebit.py``) and ``onebit_compress``
(``comm/compressed.py``) against the JAX package's, on the CPU.

- ``onebit_compress``: signs, scale and new error bit for bit against JAX
  on inputs whose sums fp32 holds exactly (dyadic values), and signs
  equal, scale within 1e-6 on normal draws (6144 fp32 values summed in
  another order).
- In warmup (before ``freeze_step``) OnebitAdam is Adam without bias
  correction, and OnebitLamb's moments are LAMB's; the error feedback stays
  zero. After the freeze, 12 steps match JAX's at the tolerances of
  ``tests/test_torch_optimizers.py``, the scale over the JAX leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_optimizers import _port, assert_matches, run_both
from test_torch_optimizers import tree  # noqa: F401 (fixture)

from deepspeed_tpu.comm.compressed import onebit_compress as jax_compress
from deepspeed_tpu_torch.comm.compressed import onebit_compress
from deepspeed_tpu_torch.ops import optimizers as topt


@pytest.mark.parametrize("shape", [(7,), (16, 24), (3, 5, 8)])
def test_onebit_compress_bit_for_bit(shape):
    rs = np.random.RandomState(len(shape))
    x = (rs.randint(-512, 512, shape) / 1024).astype(np.float32)
    e = (rs.randint(-64, 64, shape) / 1024).astype(np.float32)
    x.flat[0] = -e.flat[0]          # a zero after the correction: sign +1
    sj, scj, ej = jax_compress(jnp.asarray(x), jnp.asarray(e))
    st, sct, et = onebit_compress(torch.from_numpy(x), torch.from_numpy(e))
    assert st.dtype == torch.int8 and st.numpy().tolist() == np.asarray(sj).tolist()
    assert st.numpy().flat[0] == 1
    assert sct.item() == float(scj)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_onebit_compress_normal_draws():
    rs = np.random.RandomState(3)
    x, e = rs.randn(64, 96).astype(np.float32), 0.1 * rs.randn(64, 96).astype(np.float32)
    sj, scj, ej = jax_compress(jnp.asarray(x), jnp.asarray(e))
    st, sct, et = onebit_compress(torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(sct.item(), float(scj), rtol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=1e-6)
    # a given scale (the JAX leaf's mean, when x is a layer or a shard of it)
    _, s2, e2 = onebit_compress(torch.from_numpy(x), torch.from_numpy(e),
                                scale=torch.tensor(0.5))
    assert s2.item() == 0.5
    torch.testing.assert_close(e2, torch.from_numpy(x + e) - st.float() * 0.5)


def test_onebit_adam_warmup_is_adam_without_bias_correction(tree):  # noqa: F811
    cfg_t, params, grads = tree
    a = topt.get_optimizer("adamw", lr=1e-3, weight_decay=0.01, bias_correction=False)
    o = topt.get_optimizer("onebitadam", lr=1e-3, weight_decay=0.01, freeze_step=100)
    pa, po = _port(cfg_t, params), _port(cfg_t, params)
    sa, so = a.init(pa), o.init(po)
    for g in grads[:5]:
        pa, sa = a.update(pa, _port(cfg_t, g), sa)
        po, so = o.update(po, _port(cfg_t, g), so)
    for k in pa:
        torch.testing.assert_close(po[k], pa[k], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(so.mu[k], sa.mu[k], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(so.nu[k], sa.nu[k], rtol=1e-6, atol=1e-7)
        assert not so.error[k].any(), k


def test_onebit_lamb_warmup_moments_are_lamb(tree):  # noqa: F811
    cfg_t, params, grads = tree
    a = topt.get_optimizer("lamb", lr=1e-2)
    o = topt.get_optimizer("onebitlamb", lr=1e-2, freeze_step=100)
    pa, po = _port(cfg_t, params), _port(cfg_t, params)
    sa, so = a.init(pa), o.init(po)
    layout = topt.Layout.for_model(cfg_t, pa)
    for g in grads[:4]:
        pa, sa = a.update(pa, _port(cfg_t, g), sa, layout=layout)
        po, so = o.update(po, _port(cfg_t, g), so, layout=layout)
    for k in pa:
        torch.testing.assert_close(so.mu[k], sa.mu[k], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(so.nu[k], sa.nu[k], rtol=1e-6, atol=1e-7)
        assert not so.error[k].any(), k


@pytest.mark.parametrize("name,kw", [
    ("onebitadam", {"lr": 1e-3, "freeze_step": 2}),
    ("onebitlamb", {"lr": 1e-2, "freeze_step": 2, "weight_decay": 0.01}),
    ("zerooneadam", {"lr": 1e-3, "var_freeze_step": 2, "var_update_scaler": 3,
                     "weight_decay": 0.01}),
])
def test_after_the_freeze_matches_jax(tree, name, kw):  # noqa: F811
    cfg_t, params, grads = tree
    grads = grads + [{k: v[::-1].copy() if isinstance(v, np.ndarray) else
                      {kk: vv[::-1].copy() for kk, vv in v.items()}
                      for k, v in g.items()} for g in grads[:4]]
    _, _, pj, sj, pt, st = run_both(cfg_t, params, grads, name, kw)
    assert st.step == 14
    assert all(e.any() for e in st.error.values())
    assert_matches(cfg_t, pj, sj, pt, st)
