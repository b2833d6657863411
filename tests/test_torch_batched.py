"""The port's batched and incremental solves against the JAX package, on the
CPU: ``GoalOptimizer.batched_optimize``, ``batched_violations``,
``incremental_optimize``, ``batched_incremental_optimize`` and
``sim.deep_sweep``.

The port runs a stack's lanes one after another through the single-cluster
steps, so each lane must equal the JAX direct solve of that lane exactly:
placements, leaders, per-goal violations, rounds and moves, movement,
provision and balancedness.  The JAX vmapped solve gives the same per-lane
round counters as its direct solve (its while loops keep a finished lane's
carry), and the port matches both (``test_two_lanes_match_jax_batched``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu import sim as JSIM
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.analyzer.context import GoalContext as JGoalContext
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JGoalOptimizer
from cruise_control_tpu.model.arrays import stack_arrays as j_stack
from cruise_control_tpu.synthetic import SyntheticSpec, generate
from cruise_control_tpu_torch import sim as PSIM
from cruise_control_tpu_torch.analyzer import GoalOptimizer
from cruise_control_tpu_torch.model import arrays as PA
from tests.torch_port_helpers import assert_records_match, clear_records, port_ctx, port_state, to_np
from tests.torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse: one thread)

LIGHT = dict(mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08, mean_nw_out=0.06)
#: tests/test_sim.py's goal subset and hard goals
GOALS = (JG.RACK_AWARE, JG.DISK_CAPACITY, JG.REPLICA_DISTRIBUTION)
HARD = (JG.RACK_AWARE, JG.DISK_CAPACITY)
BUCKET = 16


def small_cluster(seed=2, rf=2):
    spec = SyntheticSpec(
        num_racks=5, num_brokers=10, num_topics=5, num_partitions=50,
        replication_factor=rf, seed=seed, **LIGHT,
    )
    return generate(spec)[0]


def jax_opt(goals=GOALS, hard=HARD):
    return JGoalOptimizer(goal_ids=goals, hard_ids=hard, enable_heavy_goals=False, bucket_brokers=False)


def port_opt(goals=GOALS, hard=HARD):
    return GoalOptimizer(
        goal_ids=goals, hard_ids=hard, enable_heavy_goals=False, bucket_brokers=False, device="cpu",
    )


def lanes_of(jbase, scenarios):
    """(JAX lane states, JAX context) of scenarios padded to one bucket."""
    return (
        [JSIM.apply_scenario(jbase, s, bucket_brokers=BUCKET) for s in scenarios],
        JGoalContext.build(jbase.num_topics, BUCKET),
    )


def _tensors(state):
    return {
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state) if isinstance(getattr(state, f.name), torch.Tensor)
    }


def _reports(result):
    return [
        (r.name, r.is_hard, r.violations_before, r.violations_after, r.rounds, r.moves_applied)
        for r in result.goal_reports
    ]


def assert_lane_equals(pfinal, i, pres, jfinal, jres, jlane=None):
    """Lane ``i`` of the port's stack against a JAX solve (direct, or lane
    ``jlane`` of a JAX stack)."""
    for f in ("replica_broker", "partition_leader", "replica_disk"):
        want = np.asarray(getattr(jfinal, f))
        np.testing.assert_array_equal(to_np(getattr(pfinal, f))[i], want if jlane is None else want[jlane], f)
    assert _reports(pres) == _reports(jres)
    assert pres.violations_before == jres.violations_before
    assert pres.violations_after == jres.violations_after
    assert pres.total_moves == jres.total_moves
    assert dataclasses.asdict(pres.movement) == dataclasses.asdict(jres.movement)
    assert dataclasses.asdict(pres.provision) == dataclasses.asdict(jres.provision)
    assert pres.balancedness_score == jres.balancedness_score


SCENARIOS = [
    JSIM.Scenario(name="kill1", kill_brokers=(1,), load_factor=1.2),
    JSIM.Scenario(name="add2", add_brokers=2, load_factor=1.4),
    JSIM.Scenario(name="heavy", load_factor=2.0),
]


def test_three_lanes_match_jax_direct_solves():
    jlanes, jctx = lanes_of(small_cluster(), SCENARIOS)
    stack = PA.stack_arrays([port_state(s) for s in jlanes])
    before = _tensors(stack)
    pfinal, pres = port_opt().batched_optimize(stack, port_ctx(jctx))
    assert pres.batch_size == 3 and pfinal.replica_broker.shape == stack.replica_broker.shape
    for i, jlane in enumerate(jlanes):
        jfinal, jres = jax_opt().optimize(jlane, jctx)
        assert_lane_equals(pfinal, i, pres.results[i], jfinal, jres)
        assert pres.results[i].num_host_syncs == pres.num_host_syncs
        assert pres.results[i].stats_before == {} and pres.results[i].proposals == []
    # the caller's stack is untouched, and a second call gives the same lanes
    for k, v in _tensors(stack).items():
        assert torch.equal(v, before[k]), k
    again, res2 = port_opt().batched_optimize(stack, port_ctx(jctx))
    assert torch.equal(again.replica_broker, pfinal.replica_broker)
    assert [_reports(r) for r in res2.results] == [_reports(r) for r in pres.results]


def test_two_lanes_match_jax_batched():
    """Against the JAX vmapped solve itself: per-goal rounds too (its
    counters equal its direct solve's), and the JAX docstring's note that
    vmapped counters may absorb the batch's trip count does not show."""
    scs = [JSIM.Scenario(name="rack", drop_rack=2), JSIM.Scenario(name="kill", kill_brokers=(0, 5), load_factor=1.3)]
    jlanes, jctx = lanes_of(small_cluster(seed=4), scs)
    clear_records()
    jfinal, jres = jax_opt().batched_optimize(j_stack(jlanes), jctx)
    jax.clear_caches()
    pfinal, pres = port_opt().batched_optimize(PA.stack_arrays([port_state(s) for s in jlanes]), port_ctx(jctx))
    for i in range(2):
        assert_lane_equals(pfinal, i, pres.results[i], jfinal, jres.results[i], jlane=i)
    # one batched "optimize" flight record each, of one shape
    assert_records_match("optimize", count=1)
    assert any(r.moves_applied for r in pres.results[1].goal_reports)


def _drop_one_replica_per_partition(jstate):
    """The JAX state with every partition's last non-leader replica invalid:
    replication factor 3 -> 2, the leader kept."""
    rp = np.asarray(jstate.replica_partition)
    leader = np.asarray(jstate.partition_leader)
    valid = np.asarray(jstate.replica_valid).copy()
    for p in range(jstate.num_partitions):
        rows = [r for r in np.flatnonzero(rp == p) if r != leader[p]]
        valid[rows[-1]] = False
    return jstate.replace(replica_valid=valid)


def test_kafka_assigner_lane_with_a_lower_replication_factor():
    """Every lane runs the batch's largest replication factor of position
    passes; a lane with RF 2 in an RF-3 batch places nothing in its third
    pass and equals its own direct solve."""
    base = small_cluster(rf=3)
    jlanes, jctx = lanes_of(base, [JSIM.Scenario(name="rf3")])
    jlanes.append(_drop_one_replica_per_partition(jlanes[0]))
    goals, hard = (JG.KAFKA_ASSIGNER_RACK, JG.KAFKA_ASSIGNER_DISK), (JG.KAFKA_ASSIGNER_RACK,)
    pfinal, pres = port_opt(goals, hard).batched_optimize(
        PA.stack_arrays([port_state(s) for s in jlanes]), port_ctx(jctx)
    )
    for i, jlane in enumerate(jlanes):
        jfinal, jres = jax_opt(goals, hard).optimize(jlane, jctx)
        assert_lane_equals(pfinal, i, pres.results[i], jfinal, jres)
    assert pres.results[1].violations_after["KafkaAssignerEvenRackAwareGoal"] == 0


def test_batched_violations_match_jax():
    jlanes, jctx = lanes_of(small_cluster(), SCENARIOS + [JSIM.Scenario(name="rack", drop_rack=1)])
    goals = tuple(g for g in JG.DEFAULT_GOAL_ORDER if g not in JG.HEAVY_GOALS)
    want = JGoalOptimizer(goal_ids=goals, enable_heavy_goals=False).batched_violations(j_stack(jlanes), jctx)
    got = GoalOptimizer(goal_ids=goals, enable_heavy_goals=False, device="cpu").batched_violations(
        PA.stack_arrays([port_state(s) for s in jlanes]), port_ctx(jctx)
    )
    assert got.dtype == torch.float32 and got.shape == (4, JG.NUM_GOALS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_deep_sweep_batched_equals_sequential_and_jax():
    """A custom goal order forms its own group; every verdict equals the
    port's sequential loop and the JAX package's."""
    jbase = small_cluster()
    scs = [
        JSIM.Scenario(name="kill0", kill_brokers=(0,)),
        JSIM.Scenario(name="add2", add_brokers=2, load_factor=1.4),
        JSIM.Scenario(name="perm", kill_brokers=(1,), goal_order=(JG.DISK_CAPACITY, JG.RACK_AWARE)),
        JSIM.Scenario(name="noop"),
    ]
    pscs = [PSIM.Scenario(**dataclasses.asdict(s)) for s in scs]
    pbase = port_state(jbase)
    rb = PSIM.deep_sweep(pbase, pscs, goal_ids=GOALS, hard_ids=HARD, device="cpu")
    clear_records()
    rs = PSIM.deep_sweep(pbase, pscs, goal_ids=GOALS, hard_ids=HARD, batched=False, device="cpu")
    rj = JSIM.deep_sweep(jbase, scs, goal_ids=GOALS, hard_ids=HARD, batched=False)
    # the sequential sweeps' "simulate" records: one span per scenario
    assert_records_match("simulate", count=1)
    assert rb.deep and rb.sweep_size == 4 and rb.bucket == rj.bucket
    assert [v.to_dict() for v in rb.scenarios] == [v.to_dict() for v in rs.scenarios]
    assert [v.to_dict() for v in rb.scenarios] == [v.to_dict() for v in rj.scenarios]
    assert set(rb.scenarios[2].violations) == {"DiskCapacityGoal", "RackAwareGoal"}
    assert rb.num_host_syncs > 0 and not rs.bucket_hit


# -- incremental ------------------------------------------------------------------

INC_GOALS = GOALS + (JG.DISK_USAGE_DIST,)
#: per-lane drift of a solved cluster: a lane overloaded past its disk
#: capacity (DiskCapacityGoal drifts there only), topic shifts, and a quiet lane
DRIFTS = [
    JSIM.Scenario(topic_load_factors=((0, 2.0),), load_factor=1.1),
    JSIM.Scenario(load_factor=5.5),
    JSIM.Scenario(topic_load_factors=((1, 3.0), (2, 1.5))),
    JSIM.Scenario(),
]


@pytest.fixture(scope="module")
def drifted():
    """(JAX lanes, JAX context): one solve of the 10-broker cluster under
    ``INC_GOALS``, then each drift of ``DRIFTS`` applied to its placement."""
    jctx = JGoalContext.build(5, BUCKET)
    solved, _ = jax_opt(INC_GOALS).optimize(JSIM.apply_scenario(small_cluster(), JSIM.Scenario(), BUCKET), jctx)
    return [JSIM.apply_scenario(solved, d, bucket_brokers=BUCKET) for d in DRIFTS], jctx


def _inc_fields(r):
    return (r.goals_run, r.total_moves, r.total_rounds, r.violations_before.tolist(),
            r.violations_after.tolist())


def test_incremental_optimize_matches_jax(drifted):
    jlanes, jctx = drifted
    jopt, popt = jax_opt(INC_GOALS), port_opt(INC_GOALS)
    ran = set()
    for jlane in jlanes:
        jfinal, jres = jopt.incremental_optimize(jlane, jctx, max_rounds=16)
        pstate = port_state(jlane)
        pfinal, pres = popt.incremental_optimize(pstate, port_ctx(jctx), max_rounds=16)
        assert _inc_fields(pres) == _inc_fields(jres)
        for f in ("replica_broker", "partition_leader"):
            np.testing.assert_array_equal(to_np(getattr(pfinal, f)), np.asarray(getattr(jfinal, f)), f)
        # the caller's probe saves the leading one and changes nothing else
        viol = popt.violations(pstate, port_ctx(jctx))
        again, res2 = popt.incremental_optimize(pstate, port_ctx(jctx), max_rounds=16, violations=viol)
        assert torch.equal(again.replica_broker, pfinal.replica_broker)
        assert _inc_fields(res2) == _inc_fields(pres)
        assert res2.num_host_syncs == pres.num_host_syncs
        ran |= set(pres.goals_run)
    assert {"DiskCapacityGoal", "DiskUsageDistributionGoal"} <= ran


def test_batched_incremental_optimize_matches_jax(drifted):
    """Union goals a lane did not drift on still run on it (zero moves, its
    rounds counted); each lane equals the JAX batched lane and the port's
    single-lane solve."""
    jlanes, jctx = drifted
    jfinal, jres = jax_opt(INC_GOALS).batched_incremental_optimize(j_stack(jlanes), jctx, max_rounds=16)
    jax.clear_caches()
    popt = port_opt(INC_GOALS)
    stack = PA.stack_arrays([port_state(s) for s in jlanes])
    pfinal, pres = popt.batched_incremental_optimize(stack, port_ctx(jctx), max_rounds=16)
    assert pres.goals_run == jres.goals_run and pres.batch_size == 4
    assert "DiskCapacityGoal" in pres.goals_run
    assert "DiskCapacityGoal" not in pres.results[0].goals_run
    for i in range(4):
        assert _inc_fields(pres.results[i]) == _inc_fields(jres.results[i])
        for f in ("replica_broker", "partition_leader"):
            np.testing.assert_array_equal(
                to_np(getattr(pfinal, f))[i], np.asarray(getattr(jfinal, f))[i], f
            )
    # one lane's solve alone drives only its own drifted goals
    single, sres = popt.incremental_optimize(port_state(jlanes[3]), port_ctx(jctx), max_rounds=16)
    assert sres.goals_run == pres.results[3].goals_run
    assert torch.equal(single.replica_broker, pfinal.replica_broker[3])
    # union_lanes narrows the walk to lane 0's drifted goals
    _, narrow = popt.batched_incremental_optimize(stack, port_ctx(jctx), max_rounds=16, union_lanes=[0])
    assert narrow.goals_run == pres.results[0].goals_run


def test_batched_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GoalOptimizer(goal_ids=GOALS)
    opt = port_opt()
    assert opt.device.type == "cpu"
    opt.warm_incremental_programs(port_state(small_cluster()), port_ctx(JGoalContext.build(5, 10)), 8)
