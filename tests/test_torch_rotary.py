"""Rotary position embedding of the PyTorch port (``ops/rotary.py``) against
the JAX package's (``deepspeed_tpu/ops/rotary.py``), on the CPU, in fp32.

The same x (numpy, seeded) through ``apply_rotary``,
``apply_rotary_interleaved`` and ``apply_rotary_partial`` in both packages,
with and without explicit positions, at GPT-NeoX-20B's partial rotary (24
of 96 dims, split halves), GPT-J's (64 of 256, interleaved pairs) and
smaller widths; cos/sin tables over the rotated dims, as the families build
them. Tolerance 1e-6 absolute (fp32 rotations of values of order 1; the two
packages evaluate the same products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops import rotary as jrot
from deepspeed_tpu_torch.ops import rotary as trot

TOL = dict(rtol=0, atol=1e-6)


def _inputs(b, s, h, d, seed=0, positions=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, d).astype(np.float32)
    pos = rs.randint(0, 64, (b, s)).astype(np.int32) if positions else None
    return x, pos


def _run(rot_dim, fn_j, fn_t, x, pos, **kw):
    cj, sj = jrot.rope_frequencies(rot_dim, 64)
    ct, st = trot.rope_frequencies(rot_dim, 64)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    want = fn_j(jnp.asarray(x), cj, sj, None if pos is None else jnp.asarray(pos), **kw)
    got = fn_t(torch.from_numpy(x), ct, st, None if pos is None else torch.from_numpy(pos)
               .long(), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("d", [8, 64, 256])
def test_interleaved_matches_jax(d, positions):
    x, pos = _inputs(2, 11, 3, d, positions=positions)
    _run(d, jrot.apply_rotary_interleaved, trot.apply_rotary_interleaved, x, pos)


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("d,rot", [(96, 24), (256, 64), (16, 4), (32, 32), (32, None)])
def test_partial_matches_jax(d, rot, interleaved, positions):
    """GPT-NeoX-20B (24 of 96) and GPT-J-6B (64 of 256); a rotary_dim of the
    whole head, or None, is the full rotation."""
    x, pos = _inputs(2, 9, 2, d, seed=1, positions=positions)
    kw = dict(rotary_dim=rot, interleaved=interleaved)
    got = _run(rot or d, jrot.apply_rotary_partial, trot.apply_rotary_partial, x, pos, **kw)
    if rot is not None and rot < d:      # the tail passes through untouched
        np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])


def test_partial_keeps_bf16():
    x, pos = _inputs(1, 5, 2, 96, seed=2, positions=True)
    ct, st = trot.rope_frequencies(24, 64)
    xb = torch.from_numpy(x).bfloat16()
    got = trot.apply_rotary_partial(xb, ct, st, torch.from_numpy(pos).long(), rotary_dim=24)
    assert got.dtype == torch.bfloat16
    want = trot.apply_rotary_partial(xb.float(), ct, st, torch.from_numpy(pos).long(),
                                     rotary_dim=24)
    torch.testing.assert_close(got.float(), want.bfloat16().float(), rtol=0, atol=0)
