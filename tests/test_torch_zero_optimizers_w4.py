"""``test_torch_zero_optimizers.py``'s cases on 4 gloo ranks: LAMB, Muon and
1-bit Adam at ZeRO stages 1-3 against the JAX engine at dp = 2, at that
file's tolerances (a file of its own, to keep each file's time down)."""

import pytest
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_zero_optimizers import OPTIMIZERS, check_stage, spawn_runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_runs(4, tmp_path_factory)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_matches_jax_dp2_on_4_ranks(runs, opt, stage):
    check_stage(runs, opt, stage)
