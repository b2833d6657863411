"""JBOD solves in the port against the JAX package, on the CPU.

* the north-star goal list (the 16 default goals, then both intra-broker disk
  goals) on a small skewed cluster with two logdirs per broker;
* the REMOVE_DISKS solve (IntraBrokerDiskCapacityGoal alone, hard) after
  marking logdirs removed (capacity 0, as ``ClusterModel.to_arrays`` encodes a
  removed logdir) on a balanced cluster with room to drain them.

Identical placements, leaders, logdirs, proposals and per-goal reports.  The
``config2_small``-sized runs are marked ``slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import GoalContext as JGoalContext
from cruise_control_tpu.analyzer import goals_base as JG
from tests.torch_optimizer_parity import assert_same_solution, run_both
from tests.torch_port_helpers import CONFIG2_SMALL, to_np
from tests.torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse: one thread)

#: capacityJBOD.json: two logdirs per broker, CPU 100, NW 100k, disk 1M in all
JBOD_CAPACITY = dict(
    disks_per_broker=2, capacity_cpu=100.0, capacity_disk=1_000_000.0,
    capacity_nw_in=100_000.0, capacity_nw_out=100_000.0,
)
NORTH_STAR = tuple(JG.DEFAULT_GOAL_ORDER) + (JG.INTRA_DISK_CAPACITY, JG.INTRA_DISK_USAGE_DIST)
REMOVE_DISKS = (JG.INTRA_DISK_CAPACITY,)
SMALL_JBOD = dict(
    num_racks=3, num_brokers=6, num_topics=4, num_partitions=60, replication_factor=3,
    distribution="exponential", skew_brokers=4, mean_cpu=0.25, mean_disk=0.1,
    mean_nw_in=0.15, mean_nw_out=0.15, seed=13, **JBOD_CAPACITY,
)


def _case(spec):
    jstate, maps = JS.generate(JS.SyntheticSpec(**spec))
    return jstate, JGoalContext.build(jstate.num_topics, jstate.num_brokers), maps


def _remove_second_logdirs(jstate, brokers):
    """Mark each broker's second logdir removed: capacity 0."""
    cap = np.asarray(jstate.disk_capacity).copy()
    cap[[2 * b + 1 for b in brokers]] = 0.0
    return jstate.replace(disk_capacity=jnp.asarray(cap))


def _check_remove_disks(jstate, pfinal, pres, removed):
    """Goal 16 met, no replica left its broker, none left on a removed logdir."""
    assert pres.violations_after["IntraBrokerDiskCapacityGoal"] == 0
    assert pres.violations_before["IntraBrokerDiskCapacityGoal"] >= len(removed)
    assert pres.movement.num_inter_broker_moves == 0
    assert pres.movement.num_intra_broker_moves > 0
    disk = to_np(pfinal.replica_disk)[to_np(pfinal.replica_valid)]
    assert not np.isin(disk, [2 * b + 1 for b in removed]).any()


def test_north_star_goal_list_matches_jax():
    jstate, jctx, maps = _case(SMALL_JBOD)
    jfinal, jres, pfinal, pres = run_both(jstate, jctx, maps, goal_ids=NORTH_STAR)
    assert_same_solution(jfinal, jres, pfinal, pres)
    assert pres.residual_hard_violations == 0
    assert pres.movement.num_intra_broker_moves > 0 or any(
        r.moves_applied > 0 for r in pres.goal_reports[-2:]
    )


def test_remove_disks_matches_jax():
    jstate, jctx, maps = _case(dict(SMALL_JBOD, skew_brokers=0))
    removed = (0, 3)
    jstate = _remove_second_logdirs(jstate, removed)
    out = run_both(jstate, jctx, maps, goal_ids=REMOVE_DISKS, hard_ids=REMOVE_DISKS)
    assert_same_solution(*out)
    _check_remove_disks(jstate, out[2], out[3], removed)


@pytest.mark.slow
def test_config2_small_jbod_solves_match_jax():
    spec = dict(CONFIG2_SMALL, **JBOD_CAPACITY)
    jstate, jctx, maps = _case(spec)
    assert_same_solution(*run_both(jstate, jctx, maps, goal_ids=NORTH_STAR))
    jstate, jctx, maps = _case(dict(spec, skew_brokers=0, mean_disk=0.1))
    removed = tuple(range(4))
    jstate = _remove_second_logdirs(jstate, removed)
    out = run_both(jstate, jctx, maps, goal_ids=REMOVE_DISKS, hard_ids=REMOVE_DISKS)
    assert_same_solution(*out)
    _check_remove_disks(jstate, out[2], out[3], removed)
