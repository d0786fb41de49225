"""The port's collectives (``deepspeed_tpu_torch/comm``) on 4 gloo ranks
against the JAX package's (``deepspeed_tpu/comm/comm.py``) under
``shard_map`` on 4 CPU devices, on the same integer-valued fp32 inputs
made from a seed, so every sum is exact: each rank's result must EQUAL
its member's. Two meshes: ``data`` = 4, and ``data`` = 2 x ``seq`` = 2 with
the collectives over the tuple axis ``("data", "seq")``. Also the object
helpers and ``monitored_barrier``: a rank that arrives 4 s late makes the
others' barrier with a 1 s timeout raise."""

import jax
import numpy as np
import pytest
from _torch_dist_worker import spawn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.comm.mesh import MeshManager

N = 4
MESHES = {"data4": ({"data": 4}, "data"),
          "data2_seq2": ({"data": 2, "seq": 2}, ("data", "seq"))}
rs = np.random.RandomState(0)
X = rs.randint(-8, 8, (N, 8, 12, 3)).astype(np.float32)     # member i's x is X[i]
S = rs.randint(-8, 8, (N, N, 5)).astype(np.float32)         # scatter's [n, ...] input

OPS = {
    "all_reduce_sum": lambda x, a: jcomm.all_reduce(x, a, "sum"),
    "all_reduce_max": lambda x, a: jcomm.all_reduce(x, a, "max"),
    "all_reduce_min": lambda x, a: jcomm.all_reduce(x, a, "min"),
    "all_reduce_mean": lambda x, a: jcomm.all_reduce(x, a, "mean"),
    "all_gather_0": lambda x, a: jcomm.all_gather(x, a, gather_axis=0),
    "all_gather_1": lambda x, a: jcomm.all_gather(x, a, gather_axis=1),
    "all_gather_untiled_0": lambda x, a: jcomm.all_gather(x, a, tiled=False, gather_axis=0),
    "all_gather_untiled_1": lambda x, a: jcomm.all_gather(x, a, tiled=False, gather_axis=1),
    "reduce_scatter_0": lambda x, a: jcomm.reduce_scatter(x, a, scatter_axis=0),
    "reduce_scatter_1": lambda x, a: jcomm.reduce_scatter(x, a, scatter_axis=1),
    # Ulysses: seq -> heads splits dim 1 and concatenates dim 0; the inverse swaps
    "all_to_all_10": lambda x, a: jcomm.all_to_all(x, a, split_axis=1, concat_axis=0),
    "all_to_all_01": lambda x, a: jcomm.all_to_all(x, a, split_axis=0, concat_axis=1),
    "ppermute": lambda x, a: jcomm.ppermute(x, a, [(i, (i + 1) % N) for i in range(N - 1)]),
    "ring_shift": lambda x, a: jcomm.ring_shift(x, a, N, shift=-1),
    "broadcast": lambda x, a: jcomm.broadcast(x, a, src_index=N - 1),
    "send_recv": lambda x, a: jcomm.send_recv(x, a, src=N - 1, dst=0),
    "gather": lambda x, a: jcomm.gather(x, a, dst=1),
    "inference_all_reduce": lambda x, a: jcomm.inference_all_reduce(x, a),
}


def _jax_members(sizes, axis, fn, inputs):
    """Each member's result of ``fn`` on its block of ``inputs`` ([N, ...])."""
    mm = MeshManager.create(sizes, jax.devices()[:N])
    spec = P(axis)
    f = jcomm.shard_map(lambda x: fn(x[0], axis)[None], mesh=mm.mesh, in_specs=spec,
                        out_specs=spec)
    return np.asarray(jax.jit(f)(inputs))


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, tmp_path_factory):
    sizes, axis = MESHES[request.param]
    tmp = tmp_path_factory.mktemp(f"comm_{request.param}")
    np.savez(tmp / "in.npz", x=X, s=S)
    return request.param, spawn({"scenario": "comm", "mesh": sizes, "axis": axis,
                                 "npz": str(tmp / "in.npz")}, N, tmp)


@pytest.mark.parametrize("op", sorted(OPS))
def test_collective_equals_jax(ranks, op):
    name, got = ranks
    sizes, axis = MESHES[name]
    want = _jax_members(sizes, axis, OPS[op], X)
    for r in range(N):
        np.testing.assert_array_equal(got[r][op], want[r], err_msg=f"{name} {op} rank {r}")


def test_scatter_and_axis_index_equal_jax(ranks):
    name, got = ranks
    sizes, axis = MESHES[name]
    want = _jax_members(sizes, axis, lambda x, a: jcomm.scatter(x, a, src=2), S)
    idx = _jax_members(sizes, axis, lambda x, a: jcomm.axis_index(a)[None], X)
    for r in range(N):
        np.testing.assert_array_equal(got[r]["scatter"], want[r])
        assert int(got[r]["axis_index"]) == int(idx[r][0]) == r
        assert int(got[r]["axis_size"]) == N


def test_object_helpers_and_monitored_barrier(ranks):
    _, got = ranks
    for r in range(N):
        assert list(got[r]["objects"]) == list(range(N))
        assert list(got[r]["broadcast_object"]) == [10]
        assert list(got[r]["broadcast_host"]) == [102]
        assert got[r]["barrier_s"][0] >= 0
        # every collective that ran was counted
        assert int(got[r]["counts"][0]) == len(OPS) + 1
    for r in range(N - 1):
        assert 0.9 < got[r]["late"][0] < 3.5, got[r]["late"]
