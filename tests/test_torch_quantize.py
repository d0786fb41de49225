"""Per-group int8 quantize / dequantize: the PyTorch port against the JAX
package.

The port's plain ``quantize_int8_torch`` / ``dequantize_int8_torch`` are held
against JAX ``quantize_int8_xla`` / ``dequantize_int8_xla`` and against the
Pallas kernels ``quantize_int8_pallas`` / ``dequantize_int8_pallas`` run in
interpret mode, on the same inputs made with numpy. Codes, scales and
dequantized values must be EQUAL to the Pallas kernels' and to the jitted
XLA functions', not close: both sides take the scale as ``amax`` times the
fp32 reciprocal of 127 (what XLA compiles ``amax / 127.0`` to), divide by it
in IEEE fp32 and round half to even, so there is no tolerance to state. The
CUDA kernels are held to the same equality against the plain versions on a
GPU by ``tests/test_torch_cuda_kernels.py``.

The vector quantize kernel's division (the product by the reciprocal,
corrected twice by its residual, four FMAs) is rendered in numpy fp32 on
``chip_smoke.py``'s ``division_boundary_groups``: at exact ties, at
quotients where the uncorrected product rounds to another code, and where
it is not even a faithful rounding of the quotient. There it must give the
IEEE quotient, its first correction a faithful one, and the uncorrected
product other codes.

One exception, which is the JAX package's own: run op by op, outside
``jax.jit``, ``quantize_int8_xla`` really divides by 127, which moves about
3% of its scales by one ulp against the same function jitted. Against that
eager version the scales are held to one ulp, the codes to equality in every
group whose scale agrees, and to one code step in the others (a quotient on
a rounding boundary).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu.ops.pallas.quantize import (dequantize_int8_pallas,
                                               quantize_int8_pallas)
from deepspeed_tpu.ops.quantization import dequantize_int8_xla, quantize_int8_xla
from deepspeed_tpu_torch.ops import dequantize_int8, get_op, quantize_int8
from deepspeed_tpu_torch.ops.quantization import (
    dequantize_int8_cuda, dequantize_int8_torch, group_quantize_int8, quantize_int8_cuda,
    quantize_int8_torch)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _assert_quantize_matches_jax(x_t, x_j, group_size):
    q, s = quantize_int8_torch(x_t, group_size)
    q, s = q.numpy(), s.numpy()
    for fn in (quantize_int8_pallas, jax.jit(quantize_int8_xla, static_argnums=1)):
        q_j, s_j = fn(x_j, group_size)
        np.testing.assert_array_equal(q, np.asarray(q_j))
        np.testing.assert_array_equal(s, np.asarray(s_j))
    q_j, s_j = (np.asarray(a) for a in quantize_int8_xla(x_j, group_size))   # op by op
    np.testing.assert_array_max_ulp(s, s_j, maxulp=1)
    same = np.repeat(s == s_j, group_size).reshape(q.shape)
    np.testing.assert_array_equal(q[same], q_j[same])
    assert np.abs(q.astype(np.int32) - q_j.astype(np.int32)).max() <= 1
    assert same.any()


def _inputs(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    row_scale = rs.choice([1e-3, 1.0, 50.0], size=(shape[0],) + (1,) * (len(shape) - 1))
    x = (rs.randn(*shape) * row_scale).astype(np.float32)
    x_t = torch.from_numpy(x).to(TORCH[dtype])
    x_j = jnp.asarray(x_t.float().numpy()).astype(JNP[dtype])
    return x_t, x_j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("group_size", [64, 128, 2048])
def test_quantize_equals_jax(group_size, dtype):
    x_t, x_j = _inputs((12, 4096), dtype, seed=group_size)
    q, s = quantize_int8_torch(x_t, group_size)
    assert q.dtype == torch.int8 and q.shape == x_t.shape
    assert s.dtype == torch.float32 and s.shape == (x_t.numel() // group_size,)
    _assert_quantize_matches_jax(x_t, x_j, group_size)


@pytest.mark.parametrize("out", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("group_size", [64, 128, 2048])
def test_dequantize_equals_jax(group_size, out):
    rs = np.random.RandomState(group_size + 1)
    q = rs.randint(-127, 128, (6, 4096)).astype(np.int8)
    s = (rs.rand(q.size // group_size) * 0.05).astype(np.float32)
    got = dequantize_int8_torch(torch.from_numpy(q), torch.from_numpy(s), group_size,
                                TORCH[out])
    assert got.dtype == TORCH[out] and got.shape == q.shape
    for fn in (dequantize_int8_xla, dequantize_int8_pallas):
        ref = fn(jnp.asarray(q), jnp.asarray(s), group_size, JNP[out])
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def test_zero_group_and_half_ties():
    """An all-zero group gets scale 1 (not 1e-8 / 127, the KV quantizer's
    floor) and codes 0; exact .5 quotients round half to even."""
    gs = 128
    x = np.zeros((3, gs), np.float32)
    # group 1: amax 127 -> scale 1, so the values are their own quotients
    x[1, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    x[2] = np.random.RandomState(0).randn(gs)
    q, s = quantize_int8_torch(torch.from_numpy(x), gs)
    assert s[0] == 1.0 and not q[0].any()
    assert s[1] == 1.0
    assert q[1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    _assert_quantize_matches_jax(torch.from_numpy(x), jnp.asarray(x), gs)
    q_p, s_p = quantize_int8_pallas(jnp.asarray(x), gs)
    assert float(s_p[0]) == 1.0 and not np.asarray(q_p[0]).any()
    # the KV quantizer keeps its own formula
    _, s_kv = group_quantize_int8(torch.from_numpy(x))
    assert float(s_kv[0, 0]) == pytest.approx(1e-8 / 127.0)


def _fma32(a, b, c):
    """fp32 ``fma(a, b, c)``, rounded once: the product is exact in fp64,
    TwoSum gives the fp64 sum's error ``t``, and where the fp64 sum is a
    midpoint of two fp32 neighbours ``t`` decides the side."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    t = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r.astype(np.float64), np.inf, -np.inf).astype(np.float32))
    mid = (s - r) * 2 == other.astype(np.float64) - r
    toward = np.sign(t) == np.sign(other.astype(np.float64) - r)
    return np.where(mid & (t != 0) & toward, other, r)


def _fma_division(x, scales):
    """``quantize.cu``'s ``chunk_codes`` in numpy fp32: y = RN(1/s), q0 =
    RN(x y), q1 = RN(q0 + y RN(x - s q0)), q = RN(q1 + y (x - s q1)) (four
    FMAs), rounded half to even by adding 1.5 * 2^23 (the sum's low byte is
    the code). Returns (s, q0, q1, q, codes)."""
    s = np.broadcast_to(scales[:, None], x.shape).astype(np.float32)
    y = np.float32(1.0) / s
    q0 = x * y
    q1 = _fma32(_fma32(-s, q0, x), y, q0)
    q = _fma32(_fma32(-s, q1, x), y, q1)
    codes = ((q + np.float32(12582912.0)).view(np.int32) & 0xFF).astype(np.uint8).view(np.int8)
    return s, q0, q1, q, codes


# rows of division_boundary_groups(32, 128) by what they reach (its g % 4),
# and random rows
DIVISION_CASES = {"half_integer_neighbours": (0, 1), "unfaithful_product": (2,),
                  "exact_ties": (3,), "random": ()}


@pytest.mark.parametrize("case", list(DIVISION_CASES))
def test_exact_product_gives_the_ieee_quotients_codes(case):
    """The quantize kernel's division, case by case: the quotient is the
    IEEE one wherever it is 1/4 or more in size, the first correction a
    faithful rounding of it, and the codes equal the plain version's and
    the Pallas kernel's. Each case must reach what it is for: products by
    the reciprocal that round to another code, products that are not
    faithful, exact ties."""
    gs = 128
    if case == "random":
        x = _inputs((4, 1024), "float32", seed=5)[0].numpy().reshape(-1, gs)
    else:
        rows = smoke.division_boundary_groups(32, gs, seed=3)
        x = np.concatenate([rows[g::4] for g in DIVISION_CASES[case]])
    q, sc = quantize_int8_torch(torch.from_numpy(x), gs)
    q_p, s_p = quantize_int8_pallas(jnp.asarray(x), gs)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_p))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(s_p))
    s, q0, q1, quot, codes = _fma_division(x, sc.numpy())
    ieee = x / s
    big = np.abs(ieee) >= 0.25
    np.testing.assert_array_equal(quot[big], ieee[big])
    assert smoke._faithful(x, s, q1)[big].all()
    np.testing.assert_array_equal(codes, q.numpy())
    uncorrected = np.clip(np.rint(q0), -127, 127).astype(np.int8)
    if case == "half_integer_neighbours":
        assert (uncorrected != q.numpy()).sum() > 500
    elif case == "unfaithful_product":
        assert (~smoke._faithful(x, s, q0)).sum() > 500
    elif case == "exact_ties":
        ties = x[:, 1:] / s[:, 1:]
        assert (np.abs(ties - np.rint(ties)) == 0.5).sum() > 500


def test_round_trip_error_within_half_a_step():
    x_t, _ = _inputs((8, 2048), "float32", seed=4)
    q, s = quantize_int8(x_t, 256)
    back = dequantize_int8(q, s, 256)
    step = s.repeat_interleave(256).view(x_t.shape)
    assert float(((back - x_t).abs() / step).max()) <= 0.5 + 1e-6


def test_any_shape_and_dispatch():
    """Any shape whose size the group divides; CPU tensors reach the plain
    versions and launch nothing."""
    x_t, x_j = _inputs((3, 5, 64), "float32", seed=7)
    assert get_op("quantize_int8", x_t.device) is quantize_int8_torch
    assert get_op("dequantize_int8", x_t.device) is dequantize_int8_torch
    before = (quantize_int8_cuda.launches, dequantize_int8_cuda.launches)
    q, s = quantize_int8(x_t, 32)
    q_j, s_j = jax.jit(quantize_int8_xla, static_argnums=1)(x_j, 32)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(dequantize_int8(q, s, 32).numpy(),
                                  np.asarray(dequantize_int8_xla(q_j, s_j, 32)))
    assert (quantize_int8_cuda.launches, dequantize_int8_cuda.launches) == before


@pytest.mark.parametrize("group_size", [0, 7, 4096])
def test_bad_group_size_raises(group_size):
    x = torch.zeros(4, 100)
    with pytest.raises(ValueError, match="does not divide"):
        quantize_int8_torch(x, group_size)
    with pytest.raises(ValueError, match="does not divide"):
        dequantize_int8_torch(x.to(torch.int8), torch.ones(4), group_size)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8_cuda(x, 128)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_int8_cuda(x.to(torch.int8), torch.ones(4), 128)
