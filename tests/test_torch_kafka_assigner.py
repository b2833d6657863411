"""The port's kafka-assigner mode against the JAX package's, on the CPU.

* ``replica_positions`` on states with padded and invalid replica rows;
* ``even_rack_aware_assign`` (the per-position passes, on the CPU through the
  plain version of the ``even_assign`` kernel) on several states: new
  brokers, new disks, move count and unassigned slots all equal;
* ``GoalOptimizer.optimize`` with the assigner goal first, on every cluster of
  ``tests/test_kafka_assigner.py``: identical placements, leaders, proposals
  and per-goal reports.

Every compared value is an integer or a count, so equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import GoalContext as JGoalContext
from cruise_control_tpu.analyzer import GoalOptimizer as JGoalOptimizer
from cruise_control_tpu.analyzer import kafka_assigner as JK
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.analyzer.optimizer import OptimizationFailure as JOptimizationFailure
from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizationFailure
from cruise_control_tpu_torch.analyzer import goals_base as PG
from cruise_control_tpu_torch.analyzer import kafka_assigner as PK
from cruise_control_tpu_torch.ops import assign as PA
from tests import fixtures
from tests.torch_optimizer_parity import assert_same_solution, run_both
from tests.torch_port_helpers import assert_same, port_ctx, port_state, to_np

ASSIGNER = (JG.KAFKA_ASSIGNER_RACK,)


def _piled_but_rack_aware(pad=None):
    """6 brokers over 3 racks; 6 RF-2 partitions all on brokers 0 (leader) and
    1 (follower): rack-aware yet maximally uneven."""
    cluster = fixtures.homogeneous_cluster(fixtures.RACK_BY_BROKER4)
    for p in range(6):
        cluster.create_replica(0, ("T1", p), 0, True)
        cluster.create_replica(1, ("T1", p), 1, False)
        cluster.set_replica_load(0, ("T1", p), fixtures.load(5.0, 100.0, 10.0, 75.0))
        cluster.set_replica_load(1, ("T1", p), fixtures.load(1.0, 100.0, 0.0, 75.0))
    return cluster.to_arrays(**(pad or {}))


def _synthetic(**kw):
    spec = dict(num_racks=4, num_brokers=12, num_topics=6, num_partitions=300,
                replication_factor=3, distribution="exponential", skew_brokers=4, seed=5)
    spec.update(kw)
    return JS.generate(JS.SyntheticSpec(**spec))


def _with_alive(jstate, dead):
    alive = np.asarray(jstate.broker_alive).copy()
    alive[list(dead)] = False
    return jstate.replace(broker_alive=jnp.asarray(alive))


def _invalidated(jstate, every):
    valid = np.asarray(jstate.replica_valid).copy()
    valid[::every] = False
    return jstate.replace(replica_valid=jnp.asarray(valid))


# -- replica positions ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["padded", "invalid_rows"])
def test_replica_positions_match_jax(case):
    if case == "padded":
        jstate, _ = _piled_but_rack_aware(dict(pad_replicas_to=16, pad_partitions_to=8))
    else:
        jstate = _invalidated(_synthetic()[0], 7)
    want = np.asarray(JK.replica_positions(jstate))
    got = PK.replica_positions(port_state(jstate))
    assert_same(got, want, "positions")
    assert (want == -1).any() and want.max() >= 1


# -- the placement -------------------------------------------------------------------


def _assign_case(name):
    """(jax state, jax ctx) for one placement case."""
    if name == "12b_4r_300p":
        jstate, _ = _synthetic()
        return jstate, JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    if name == "dead_excluded":
        jstate = _with_alive(_synthetic()[0], [5])
        return jstate, JGoalContext.build(
            jstate.num_topics, jstate.num_brokers, excluded_topic_ids=(2,),
            excluded_brokers_for_leadership=(3,),
        )
    if name == "fewer_racks_than_rf":
        jstate, _ = _synthetic(num_racks=2, num_partitions=120, seed=3)
        return jstate, JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    if name == "fewer_eligible_than_rf":
        jstate = _with_alive(_synthetic(num_brokers=6, num_partitions=60, seed=4)[0], [2, 3, 4, 5])
        return jstate, JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    if name == "jbod":
        jstate, _ = _synthetic(disks_per_broker=2, num_partitions=200, seed=8)
        disk_alive = np.asarray(jstate.disk_alive).copy()
        disk_alive[[0, 7]] = False      # broker 0's first logdir and broker 3's second
        jstate = jstate.replace(disk_alive=jnp.asarray(disk_alive))
        return jstate, JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["12b_4r_300p", "dead_excluded", "fewer_racks_than_rf", "fewer_eligible_than_rf", "jbod"]
)
def test_even_rack_aware_assign_matches_jax(name):
    jstate, jctx = _assign_case(name)
    max_rf = int(np.bincount(np.asarray(jstate.replica_partition)[np.asarray(jstate.replica_valid)]).max())
    jnew, jmoves, junassigned = JK.even_rack_aware_assign(jstate, jctx, max_rf=max_rf)
    pnew, pmoves, punassigned = PK.even_rack_aware_assign(port_state(jstate), port_ctx(jctx), max_rf)
    assert_same(pnew.replica_broker, jnew.replica_broker, "replica_broker")
    assert_same(pnew.replica_disk, jnew.replica_disk, "replica_disk")
    assert int(pmoves) == int(jmoves) > 0
    assert int(punassigned) == int(junassigned)
    if name == "fewer_eligible_than_rf":
        assert int(punassigned) > 0
    else:
        assert int(punassigned) == 0


def test_even_assign_checks_its_inputs():
    B, P = 4, 3
    good = dict(
        counts=torch.zeros(B, dtype=torch.int32), chosen=torch.full((P, 2), -1, dtype=torch.int32),
        pos=0, rf=torch.full((P,), 2, dtype=torch.int32), excluded_part=torch.zeros(P, dtype=torch.bool),
        broker_rack=torch.arange(B, dtype=torch.int32), eligible=torch.ones(B, dtype=torch.bool),
    )
    PA.even_assign(**good)
    # three partitions, one replica each at position 0: brokers 0, 1, 2 by (count, id)
    assert good["chosen"][:, 0].tolist() == [0, 1, 2]
    assert good["counts"].tolist() == [1, 1, 1, 0]
    for bad in (dict(rf=good["rf"].long()), dict(pos=2), dict(eligible=good["eligible"][:3])):
        with pytest.raises(ValueError):
            PA.even_assign(**{**good, **bad})


# -- the optimizer ---------------------------------------------------------------------


def _ctx(jstate, **kw):
    return JGoalContext.build(jstate.num_topics, jstate.num_brokers, **kw)


def _optimizer_case(name):
    """(jax state, jax ctx, maps or None, goal ids) for one cluster of
    ``tests/test_kafka_assigner.py``."""
    if name == "piled":
        jstate, maps = _piled_but_rack_aware()
        return jstate, _ctx(jstate), maps, ASSIGNER
    if name == "dead_broker":
        jstate, maps = _piled_but_rack_aware()
        jstate = _with_alive(jstate, [0])
        return jstate, _ctx(jstate), maps, ASSIGNER
    if name == "rack_exhaustion":
        jstate, maps = JS.generate(JS.SyntheticSpec(
            num_racks=2, num_brokers=6, num_topics=4, num_partitions=40,
            replication_factor=3, seed=3, skew_brokers=2,
        ))
        return jstate, _ctx(jstate), maps, ASSIGNER
    if name == "excluded_destination":
        jstate, maps = _piled_but_rack_aware()
        return jstate, _ctx(jstate, excluded_brokers_for_replica_move=(5,)), maps, ASSIGNER
    if name == "disk_goal_keeps_evenness":
        jstate, maps = JS.generate(JS.SyntheticSpec(
            num_racks=4, num_brokers=12, num_topics=6, num_partitions=120,
            replication_factor=2, distribution="exponential", skew_brokers=4, seed=11,
            mean_disk=0.3,
        ))
        return jstate, _ctx(jstate), maps, ASSIGNER + (JG.KAFKA_ASSIGNER_DISK,)
    if name == "excluded_topics":
        cluster = fixtures.homogeneous_cluster(fixtures.RACK_BY_BROKER4)
        for p in range(4):
            cluster.create_replica(0, ("T1", p), 0, True)
            cluster.create_replica(1, ("T1", p), 1, False)
            cluster.create_replica(2, ("T2", p), 0, True)
            cluster.create_replica(4, ("T2", p), 1, False)
        jstate, maps = cluster.to_arrays()
        return jstate, _ctx(jstate, excluded_topic_ids=(maps.topic_index["T1"],)), maps, ASSIGNER
    raise KeyError(name)


@pytest.mark.parametrize(
    "name",
    ["piled", "dead_broker", "rack_exhaustion", "excluded_destination",
     "disk_goal_keeps_evenness", "excluded_topics"],
)
def test_assigner_mode_matches_jax(name):
    jstate, jctx, maps, goal_ids = _optimizer_case(name)
    out = run_both(jstate, jctx, maps, goal_ids=goal_ids, hard_ids=ASSIGNER)
    assert_same_solution(*out)
    pres = out[3]
    assert pres.goal_reports[0].rounds == 1
    if name == "rack_exhaustion":
        assert pres.violated_hard_goals       # 2 racks, RF 3: reported, not hidden
    elif name == "excluded_topics":
        # the excluded topic's replicas stay put (and their pile-up stays counted)
        topic = np.asarray(jstate.partition_topic)[np.asarray(jstate.replica_partition)]
        excl = np.asarray(jstate.replica_valid) & (topic == int(np.nonzero(np.asarray(jctx.excluded_topics))[0][0]))
        np.testing.assert_array_equal(to_np(out[2].replica_broker)[excl], np.asarray(jstate.replica_broker)[excl])
        assert pres.total_moves > 0
    else:
        assert pres.violations_after["KafkaAssignerEvenRackAwareGoal"] == 0
        assert pres.total_moves > 0


def test_unassignable_replica_fails_fast_in_both():
    jstate, maps = _piled_but_rack_aware()
    jstate = _with_alive(jstate, range(2, 6))       # brokers 0 and 1 remain
    jctx = _ctx(jstate, excluded_brokers_for_replica_move=(1,))
    with pytest.raises(JOptimizationFailure, match="no eligible broker"):
        JGoalOptimizer(goal_ids=ASSIGNER, hard_ids=ASSIGNER).optimize(
            jstate, jctx, raise_on_hard_failure=True
        )
    opt = GoalOptimizer(goal_ids=ASSIGNER, hard_ids=ASSIGNER, device="cpu")
    with pytest.raises(OptimizationFailure, match="no eligible broker"):
        opt.optimize(port_state(jstate), port_ctx(jctx), raise_on_hard_failure=True)
    out = run_both(jstate, jctx, maps, goal_ids=ASSIGNER, hard_ids=ASSIGNER)
    assert_same_solution(*out)
    assert out[3].violated_hard_goals


def test_position_unevenness_metric_matches_jax():
    jstate, _ = _piled_but_rack_aware()
    assert float(PG.assigner_position_unevenness(port_state(jstate))) == float(
        JG.assigner_position_unevenness(jstate)
    ) == 10.0
    assert_same(PG.assigner_position_counts(port_state(jstate)), JG.assigner_position_counts(jstate))
    assert to_np(PG.assigner_position_counts(port_state(jstate))).sum() == 12
