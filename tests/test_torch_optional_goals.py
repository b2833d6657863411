"""The optional goals 16-23 in the port against the JAX package, on the CPU.

* ``GoalOptimizer.optimize`` on every cluster of ``tests/test_optional_goals.py``
  (preferred leader, rack-aware distribution, broker sets, topic-leader
  distribution, the kafka-assigner pair) and on a list where a leadership
  goal runs after PreferredLeaderElectionGoal: identical placements, leaders,
  proposals and per-goal reports;
* module by module at a JBOD cluster with broker sets and a removed logdir:
  the snapshot field by field, the violation vector over all 24 goal ids, one round of every optional
  goal's round functions with no prior goal and with every goal prior (the
  batch, ``accept_all`` and ``admit``), and the destination, swap and
  leadership matrices with every goal prior.

JAX runs eagerly for the module cases.  Ints and bools are exact; the few
float fields (scores) within rtol=1e-6, atol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import GoalContext as JGoalContext
from cruise_control_tpu.analyzer import acceptance as JAcc
from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import goal_rounds as JR
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.analyzer import moves as JM
from cruise_control_tpu.analyzer import optimizer as JO
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBalancingConstraint
from cruise_control_tpu.model import arrays as JA
from cruise_control_tpu_torch.analyzer import acceptance as PAcc
from cruise_control_tpu_torch.analyzer import context as PC
from cruise_control_tpu_torch.analyzer import goal_rounds as PRounds
from cruise_control_tpu_torch.analyzer import goals_base as PG
from cruise_control_tpu_torch.analyzer import moves as PM
from cruise_control_tpu_torch.analyzer import optimizer as PO
from tests import fixtures
from tests.torch_optimizer_parity import assert_same_solution, run_both
from tests.torch_port_helpers import assert_fields_same, assert_same, port_ctx, port_state, to_np

TOL = dict(rtol=1e-6, atol=1e-6)
PAD = dict(pad_replicas_to=16, pad_partitions_to=8, pad_topics_to=2)
OPTIONAL = tuple(range(16, 24))
EVERY = tuple(range(JG.NUM_GOALS))


def _ctx(jstate, **kw):
    return JGoalContext.build(jstate.num_topics, jstate.num_brokers, **kw)


def _two_replica_partitions(n, leader_second=True):
    cluster = fixtures.homogeneous_cluster({0: "0", 1: "1", 2: "0"})
    for i in range(n):
        cluster.create_replica(0, ("T1", i), 0, not leader_second)
        cluster.create_replica(1, ("T1", i), 1, leader_second)
        cluster.set_replica_load(0, ("T1", i), fixtures.load(1, 10, 10, 100))
        cluster.set_replica_load(1, ("T1", i), fixtures.load(1, 10, 10, 100))
    return cluster


def _optimizer_case(name):
    """(jax state, jax ctx, maps, goal ids, hard ids) for one cluster of
    ``tests/test_optional_goals.py``."""
    if name == "preferred_leader":
        jstate, maps = _two_replica_partitions(2).to_arrays(**PAD)
        return jstate, _ctx(jstate), maps, (JG.PREFERRED_LEADER_ELECTION,), ()
    if name == "preferred_leader_dead_head":
        jstate, maps = _two_replica_partitions(1).to_arrays(**PAD)
        jstate = jstate.replace(broker_alive=jstate.broker_alive.at[0].set(False))
        return jstate, _ctx(jstate), maps, (JG.PREFERRED_LEADER_ELECTION,), ()
    if name == "preferred_leader_then_leader_dist":
        jstate, maps = _two_replica_partitions(6).to_arrays(**PAD)
        goals = (JG.PREFERRED_LEADER_ELECTION, JG.LEADER_REPLICA_DIST)
        return jstate, _ctx(jstate), maps, goals, ()
    if name == "rack_distribution":
        cluster = fixtures.homogeneous_cluster({0: "0", 1: "0", 2: "0", 3: "1", 4: "1"})
        for b in (0, 1, 2):
            cluster.create_replica(b, ("T1", 0), b, b == 0)
            cluster.set_replica_load(b, ("T1", 0), fixtures.load(1, 10, 10, 100))
        jstate, maps = cluster.to_arrays(**PAD)
        return jstate, _ctx(jstate), maps, (JG.RACK_AWARE_DISTRIBUTION,), ()
    if name == "broker_set":
        cluster = fixtures.homogeneous_cluster({0: "0", 1: "1", 2: "0", 3: "1"})
        cluster.create_replica(0, ("T1", 0), 0, True)
        cluster.set_replica_load(0, ("T1", 0), fixtures.load(1, 10, 10, 100))
        cluster.create_replica(2, ("T2", 0), 0, True)
        cluster.set_replica_load(2, ("T2", 0), fixtures.load(1, 10, 10, 100))
        jstate, maps = cluster.to_arrays(**PAD)
        set_of_topic = [0] * jstate.num_topics
        set_of_topic[maps.topic_index["T1"]] = 1
        ctx = _ctx(jstate, broker_set_of_broker=[0, 1, 0, 1], broker_set_of_topic=set_of_topic)
        return jstate, ctx, maps, (JG.BROKER_SET_AWARE,), ()
    if name == "topic_leader_distribution":
        cluster = fixtures.homogeneous_cluster({0: "0", 1: "1", 2: "0"})
        for i in range(6):
            cluster.create_replica(0, ("T1", i), 0, True)
            cluster.create_replica(1 + i % 2, ("T1", i), 1, False)
            cluster.set_replica_load(0, ("T1", i), fixtures.load(1, 10, 10, 100))
            cluster.set_replica_load(1 + i % 2, ("T1", i), fixtures.load(1, 10, 0, 100))
        jstate, maps = cluster.to_arrays(**PAD)
        constraint = JBalancingConstraint.default(
            topic_replica_balance_threshold=1.1, topic_replica_balance_min_gap=1
        )
        return jstate, _ctx(jstate, constraint=constraint), maps, (JG.TOPIC_LEADER_DIST,), ()
    if name == "kafka_assigner_pair":
        jstate, maps = fixtures.rack_aware_satisfiable().to_arrays(
            pad_replicas_to=8, pad_partitions_to=8, pad_topics_to=2
        )
        goals = (JG.KAFKA_ASSIGNER_RACK, JG.KAFKA_ASSIGNER_DISK)
        return jstate, _ctx(jstate), maps, goals, (JG.KAFKA_ASSIGNER_RACK,)
    raise KeyError(name)


@pytest.mark.parametrize(
    "name",
    ["preferred_leader", "preferred_leader_dead_head", "preferred_leader_then_leader_dist",
     "rack_distribution", "broker_set", "topic_leader_distribution", "kafka_assigner_pair"],
)
def test_optional_goal_solve_matches_jax(name):
    jstate, jctx, maps, goal_ids, hard_ids = _optimizer_case(name)
    out = run_both(jstate, jctx, maps, goal_ids=goal_ids, hard_ids=hard_ids)
    assert_same_solution(*out)
    pres = out[3]
    first = pres.goal_reports[0]
    assert first.violations_before > 0 or first.moves_applied > 0
    if name != "topic_leader_distribution":
        assert first.violations_after == 0


# -- module by module at a JBOD cluster with broker sets ---------------------------------

JBOD = dict(
    num_racks=4, num_brokers=12, num_topics=6, num_partitions=120, replication_factor=3,
    distribution="exponential", skew_brokers=10, mean_cpu=0.25, mean_disk=0.2,
    mean_nw_in=0.15, mean_nw_out=0.15, seed=11, disks_per_broker=2, capacity_disk=1_000_000.0,
)


@pytest.fixture(scope="module")
def jbod():
    """(jax state, jax ctx, port state, port ctx): the broker axis bucketed as
    ``optimize`` pads it; broker 0's second logdir removed (capacity 0),
    broker 4's first dead; every fifth partition led by its second replica;
    brokers and topics in two broker sets by parity, topic 5 in none."""
    jstate, _ = JS.generate(JS.SyntheticSpec(**JBOD))
    cap = np.asarray(jstate.disk_capacity).copy()
    cap[1] = 0.0
    alive = np.asarray(jstate.disk_alive).copy()
    alive[8] = False
    leader = np.asarray(jstate.partition_leader).copy()
    rp = np.asarray(jstate.replica_partition)
    for p in range(0, jstate.num_partitions, 5):
        leader[p] = np.nonzero(rp == p)[0][1]
    jstate = jstate.replace(
        disk_capacity=jnp.asarray(cap), disk_alive=jnp.asarray(alive),
        partition_leader=jnp.asarray(leader),
    )
    topic_sets = [t % 2 for t in range(jstate.num_topics)]
    topic_sets[5] = -1
    jctx = _ctx(
        jstate, broker_set_of_broker=[b % 2 for b in range(jstate.num_brokers)],
        broker_set_of_topic=topic_sets,
    )
    bucket = JA.broker_bucket(jstate.num_brokers)
    jstate = jax.tree_util.tree_map(jnp.asarray, JA.pad_brokers(jstate, bucket))
    jctx = JC.pad_context_brokers(jctx, bucket)
    return jstate, jctx, port_state(jstate), port_ctx(jctx)


def test_snapshot_field_by_field_at_jbod(jbod):
    """Every snapshot field the optional goals read (logdir loads, limits,
    bands and counts, preferred leaders, broker-set need) is the JAX
    package's."""
    jstate, jctx, pstate, pctx = jbod
    want = JC.take_snapshot(jstate, jctx, True)
    got = PC.take_snapshot(pstate, pctx, True)
    assert_fields_same(got, want, skip=("enable_heavy",), **TOL)
    assert to_np(got.disk_replica_counts).sum() > 0 and (to_np(got.broker_set_need) > 0).any()


@pytest.mark.parametrize("heavy", [False, True])
def test_violations_over_every_goal_match_jax(jbod, heavy):
    jstate, jctx, pstate, pctx = jbod
    want = JO._violations_fn(jstate, jctx, heavy, None)
    got = PO._violations_fn(pstate, pctx, heavy, None)
    assert_same(got, want, "violations")
    # the cluster gives most optional goals something to count
    assert (to_np(got)[list(OPTIONAL)] > 0).sum() >= 5


def _round_cases():
    for gid in OPTIONAL:
        for i in range(len(JR.GOAL_ROUNDS[gid])):
            yield pytest.param(gid, i, id=f"{JG.GOAL_NAMES[gid]}-{i}")


@pytest.mark.parametrize("gid,i", list(_round_cases()))
def test_one_round_per_optional_goal(jbod, gid, i):
    """One round with no prior goal and with every goal prior: the same
    batch, the same ``accept_all`` mask and the same ``admit`` keep-set."""
    jstate, jctx, pstate, pctx = jbod
    jsnap = JC.take_snapshot(jstate, jctx, True)
    proposed = 0
    for prior_ids in ((), EVERY):
        prior = PO._np_mask(prior_ids)
        admit_ids = PO._np_mask(prior_ids + (gid,))
        needs = PG.goal_snapshot_needs(gid) | PG.prior_acceptance_needs(prior_ids)
        psnap = PC.take_snapshot(pstate, pctx, True, needs)
        jm = JR.GOAL_ROUNDS[gid][i](jstate, jctx, jsnap, prior, jnp.int32(3))
        pm = PRounds.GOAL_ROUNDS[gid][i](pstate, pctx, psnap, prior, 3)
        assert pm.kind == int(jm.kind)
        for name in ("replica", "dst_broker", "dst_replica"):
            assert_same(getattr(pm, name), getattr(jm, name), name)
        assert (pm.dst_disk is None) == (jm.dst_disk is None)
        if pm.dst_disk is not None:
            assert_same(pm.dst_disk, jm.dst_disk, "dst_disk")
        assert_same(pm.score, jm.score, "score", **TOL)
        jeff = JM.move_effects(jstate, jm, jsnap)
        peff = PM.move_effects(pstate, pm, psnap)
        assert_fields_same(peff, jeff, **TOL)
        jok = jm.valid & JAcc.accept_all(jstate, jctx, jsnap, jm, jeff, prior)
        pok = pm.valid & PAcc.accept_all(pstate, pctx, psnap, pm, peff, prior)
        assert_same(pok, jok, "accept_all")
        jkeep = JM.admit(jstate, jctx, jsnap, jm, jok, jeff, admit_ids)
        pkeep = PM.admit(pstate, pctx, psnap, pm, pok, peff, admit_ids)
        assert_same(pkeep, jkeep, "admit")
        proposed += int(to_np(pm.valid).sum())
    assert proposed > 0


def test_accept_all_every_goal_on_every_batch_kind(jbod):
    """``accept_all`` with all 24 goals enabled on the batches of a replica
    move, a leadership, a swap and an intra-broker round."""
    jstate, jctx, pstate, pctx = jbod
    jsnap = JC.take_snapshot(jstate, jctx, True)
    psnap = PC.take_snapshot(pstate, pctx, True)
    none, every = PO._np_mask(()), PO._np_mask(EVERY)
    kinds = set()
    for gid, i in ((JG.DISK_USAGE_DIST, 0), (JG.LEADER_REPLICA_DIST, 0),
                   (JG.DISK_USAGE_DIST, 2), (JG.INTRA_DISK_CAPACITY, 0)):
        jm = JR.GOAL_ROUNDS[gid][i](jstate, jctx, jsnap, none, jnp.int32(0))
        pm = PRounds.GOAL_ROUNDS[gid][i](pstate, pctx, psnap, none, 0)
        assert_same(pm.replica, jm.replica, "replica")
        jeff, peff = JM.move_effects(jstate, jm, jsnap), PM.move_effects(pstate, pm, psnap)
        want = jm.valid & JAcc.accept_all(jstate, jctx, jsnap, jm, jeff, every)
        got = pm.valid & PAcc.accept_all(pstate, pctx, psnap, pm, peff, every)
        assert_same(got, want, f"accept_all {JG.GOAL_NAMES[gid]}-{i}")
        assert int(to_np(pm.valid).sum()) > 0
        kinds.add(pm.kind)
    assert kinds == {PM.KIND_REPLICA_MOVE, PM.KIND_LEADERSHIP, PM.KIND_SWAP, PM.KIND_INTRA_MOVE}


def test_acceptance_matrices_with_every_goal_prior(jbod):
    jstate, jctx, pstate, pctx = jbod
    prior = PO._np_mask(EVERY)
    jsnap = JC.take_snapshot(jstate, jctx, True)
    psnap = PC.take_snapshot(pstate, pctx, True)
    R, B = pstate.num_replicas, pstate.num_brokers
    rng = np.random.default_rng(4)
    cand = rng.integers(0, R, size=40).astype(np.int32)
    valid = rng.random(40) < 0.9
    partner = rng.integers(0, R, size=B).astype(np.int32)
    pvalid = rng.random(B) < 0.8
    J, P = jnp.asarray, torch.from_numpy
    for dst in (None, np.asarray([3, 0, 11, 9, 14], np.int32)):
        assert_same(
            PAcc.move_dst_matrix(pstate, pctx, psnap, P(cand), P(valid), prior,
                                 dst_brokers=None if dst is None else P(dst)),
            JAcc.move_dst_matrix(jstate, jctx, jsnap, J(cand), J(valid), prior,
                                 dst_brokers=None if dst is None else J(dst)),
            f"move_dst_matrix cols={dst}",
        )
    assert_same(
        PAcc.swap_dst_matrix(pstate, pctx, psnap, P(cand), P(valid), P(partner), P(pvalid), prior),
        JAcc.swap_dst_matrix(jstate, jctx, jsnap, J(cand), J(valid), J(partner), J(pvalid), prior),
        "swap_dst_matrix",
    )
    got = PAcc.leadership_target_ok(pstate, pctx, psnap, prior)
    assert_same(got, JAcc.leadership_target_ok(jstate, jctx, jsnap, prior), "leadership_target_ok")
    assert to_np(got).any()
