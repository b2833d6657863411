"""Slice parity: the port's ``GoalOptimizer.optimize`` (16 default goals, heavy
goals on) against the JAX package's on gate config #1 and ``unbalanced()``,
plus the optimizer's own options (deadline, fast mode, hard-goal failure,
goal-list checks).

The remaining ``tests/fixtures.py`` clusters are in
``test_torch_optimizer_fixtures.py`` so their cold JAX compiles run on another
test worker; config2_small is there too, marked ``slow``.
"""

import numpy as np
import pytest

from cruise_control_tpu_torch import synthetic as PSY
from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer, OptimizationFailure
from tests import fixtures
from tests.torch_optimizer_parity import (
    assert_same_solution,
    fixture_case,
    run_both,
    synthetic_case,
)
from tests.torch_port_helpers import CONFIG1, port_ctx, port_state
from tests.torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse: one thread)


def test_config1_matches_jax():
    jfinal, jres, pfinal, pres = run_both(*synthetic_case(CONFIG1))
    assert_same_solution(jfinal, jres, pfinal, pres)
    # the gate's committed CPU numbers for config #1
    assert pres.total_moves == 16
    assert pres.residual_hard_violations == 0
    assert round(pres.balancedness_score, 2) == 77.89


def test_unbalanced_matches_jax():
    jfinal, jres, pfinal, pres = run_both(*fixture_case("unbalanced"))
    assert_same_solution(jfinal, jres, pfinal, pres)
    assert pres.total_moves > 0


def _config1_port():
    state, maps = PSY.generate(PSY.SyntheticSpec(**CONFIG1), device="cpu")
    return state, GoalContext.build(state.num_topics, state.num_brokers, device="cpu"), maps


def test_optimize_is_deterministic_and_leaves_its_input_alone():
    state, ctx, maps = _config1_port()
    before = state.replica_broker.clone()
    f1, r1 = GoalOptimizer(device="cpu").optimize(state, ctx, maps=maps)
    f2, r2 = GoalOptimizer(device="cpu").optimize(state, ctx, maps=maps)
    assert np.array_equal(f1.replica_broker.numpy(), f2.replica_broker.numpy())
    assert r1.total_moves == r2.total_moves and r1.num_host_syncs == r2.num_host_syncs
    assert np.array_equal(state.replica_broker.numpy(), before.numpy())


def test_deadline_stops_the_walk_degraded():
    state, ctx, _ = _config1_port()
    final, res = GoalOptimizer(device="cpu", deadline_s=0.0).optimize(state, ctx)
    assert res.degraded and res.goal_reports == [] and res.total_moves == 0
    assert final.num_brokers == state.num_brokers


def test_fast_mode_caps_rounds_per_phase():
    state, _, _ = _config1_port()
    ctx = GoalContext.build(state.num_topics, state.num_brokers, fast_mode=True, device="cpu")
    _, res = GoalOptimizer(device="cpu", max_rounds_per_phase=5).optimize(state, ctx)
    for r in res.goal_reports:
        assert r.rounds <= 5 * 4 * 8  # rounds/phase x phases x passes


def test_hard_goal_failure_raises_when_asked():
    jstate, _ = fixtures.rack_aware_unsatisfiable().to_arrays()
    from cruise_control_tpu.analyzer import GoalContext as JGoalContext

    jctx = JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    opt = GoalOptimizer(device="cpu")
    _, res = opt.optimize(port_state(jstate), port_ctx(jctx))
    assert "RackAwareGoal" in res.violated_hard_goals
    assert res.provision.status == "UNDER_PROVISIONED"
    with pytest.raises(OptimizationFailure, match="RackAwareGoal"):
        opt.optimize(port_state(jstate), port_ctx(jctx), raise_on_hard_failure=True)


def test_kafka_assigner_goal_must_come_first():
    with pytest.raises(ValueError, match="FIRST"):
        GoalOptimizer(goal_ids=(0, 22), device="cpu")
    GoalOptimizer(goal_ids=(22, 0, 16), device="cpu")


@pytest.mark.parametrize("bad", [24, -1])
def test_goal_ids_outside_the_table_raise(bad):
    with pytest.raises(ValueError, match="unknown goal ids"):
        GoalOptimizer(goal_ids=(0, bad), device="cpu")
