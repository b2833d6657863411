"""Goal registry and per-goal violation counters.

Port of ``cruise_control_tpu/analyzer/goals_base.py``: the reference's goal
classes become integer goal ids, each with a violation counter (here), an
acceptance kernel (:mod:`.acceptance`) and improvement rounds
(:mod:`.goal_rounds`).  The full id table is kept so goal ids and names match
the JAX package: the 16 default goals (ids 0-15) and the optional goals 16-23
(JBOD intra-disk, preferred leader, rack-aware distribution, topic-leader
distribution, broker sets, the kafka-assigner mode).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer.context import (
    GoalContext,
    Snapshot,
    rack_fair_share,
    topic_leader_upper,
)
from cruise_control_tpu_torch.analyzer.kafka_assigner import replica_positions
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops.index import xla_sums
from cruise_control_tpu_torch.ops.segments import segment_sums
from cruise_control_tpu_torch.parallel.spmd import global_iota

# -- goal ids (priority-list members) ---------------------------------------------

RACK_AWARE = 0
MIN_TOPIC_LEADERS = 1
REPLICA_CAPACITY = 2
DISK_CAPACITY = 3
NW_IN_CAPACITY = 4
NW_OUT_CAPACITY = 5
CPU_CAPACITY = 6
REPLICA_DISTRIBUTION = 7
POTENTIAL_NW_OUT = 8
DISK_USAGE_DIST = 9
NW_IN_USAGE_DIST = 10
NW_OUT_USAGE_DIST = 11
CPU_USAGE_DIST = 12
TOPIC_REPLICA_DIST = 13
LEADER_REPLICA_DIST = 14
LEADER_BYTES_IN_DIST = 15
INTRA_DISK_CAPACITY = 16
INTRA_DISK_USAGE_DIST = 17
PREFERRED_LEADER_ELECTION = 18
RACK_AWARE_DISTRIBUTION = 19
TOPIC_LEADER_DIST = 20
BROKER_SET_AWARE = 21
KAFKA_ASSIGNER_RACK = 22
KAFKA_ASSIGNER_DISK = 23
NUM_GOALS = 24

GOAL_NAMES: Tuple[str, ...] = (
    "RackAwareGoal",
    "MinTopicLeadersPerBrokerGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
    "PreferredLeaderElectionGoal",
    "RackAwareDistributionGoal",
    "TopicLeaderReplicaDistributionGoal",
    "BrokerSetAwareGoal",
    "KafkaAssignerEvenRackAwareGoal",
    "KafkaAssignerDiskUsageDistributionGoal",
)
GOAL_ID_BY_NAME: Dict[str, int] = {n: i for i, n in enumerate(GOAL_NAMES)}

#: Goals needing [B, T] tensors — skipped unless heavy goals are enabled.
HEAVY_GOALS: Tuple[int, ...] = (MIN_TOPIC_LEADERS, TOPIC_REPLICA_DIST, TOPIC_LEADER_DIST)

#: Default ``hard.goals`` (AnalyzerConfig.java:337-344).
HARD_GOALS: Tuple[int, ...] = (
    RACK_AWARE,
    MIN_TOPIC_LEADERS,
    REPLICA_CAPACITY,
    DISK_CAPACITY,
    NW_IN_CAPACITY,
    NW_OUT_CAPACITY,
    CPU_CAPACITY,
)

#: Default goal priority order (AnalyzerConfig.java:352-368): the 16 inter-broker goals.
DEFAULT_GOAL_ORDER: Tuple[int, ...] = tuple(range(16))

#: Goal list of the REMOVE_DISKS flow: drain marked logdirs to their broker's
#: remaining disks, then balance across them.
INTRA_BROKER_GOALS: Tuple[int, ...] = (INTRA_DISK_CAPACITY, INTRA_DISK_USAGE_DIST)

CAPACITY_RESOURCE: Dict[int, int] = {
    DISK_CAPACITY: Resource.DISK,
    NW_IN_CAPACITY: Resource.NW_IN,
    NW_OUT_CAPACITY: Resource.NW_OUT,
    CPU_CAPACITY: Resource.CPU,
}
DIST_RESOURCE: Dict[int, int] = {
    DISK_USAGE_DIST: Resource.DISK,
    NW_IN_USAGE_DIST: Resource.NW_IN,
    NW_OUT_USAGE_DIST: Resource.NW_OUT,
    CPU_USAGE_DIST: Resource.CPU,
}


#: Goals whose round set includes leadership-transfer rounds (they read the
#: snapshot's per-partition leader tables).
LEADERSHIP_ROUND_GOALS: Tuple[int, ...] = (
    MIN_TOPIC_LEADERS, NW_OUT_CAPACITY, CPU_CAPACITY,
    NW_OUT_USAGE_DIST, CPU_USAGE_DIST,
    LEADER_REPLICA_DIST, LEADER_BYTES_IN_DIST, TOPIC_LEADER_DIST,
)


def goal_snapshot_needs(gid: int) -> frozenset:
    """Optional snapshot groups (``context.NEED_*``) goal ``gid``'s rounds,
    acceptance terms and violation counter read; the others are not computed
    during its step."""
    if gid in (PREFERRED_LEADER_ELECTION, KAFKA_ASSIGNER_RACK, KAFKA_ASSIGNER_DISK):
        return C.ALL_NEEDS
    n = set()
    if gid == RACK_AWARE:
        n.add(C.NEED_RACK_FIRST)
    if gid in LEADERSHIP_ROUND_GOALS:
        n.add(C.NEED_LEADER)
    if gid == BROKER_SET_AWARE:
        n.add(C.NEED_BROKER_SET)
    return frozenset(n)


def prior_acceptance_needs(prior_ids) -> frozenset:
    """Optional snapshot groups the acceptance terms of the prior goals
    ``prior_ids`` read: PreferredLeaderElectionGoal's leadership term reads
    the preferred leaders, whatever goal's rounds propose the transfer."""
    return frozenset({C.NEED_PREF}) if PREFERRED_LEADER_ELECTION in prior_ids else frozenset()


def violation_needs(subset) -> frozenset:
    """Optional snapshot groups the :func:`violations_all` rows of ``subset`` read."""
    gids = range(NUM_GOALS) if subset is None else subset
    n = set()
    for g in gids:
        if g == RACK_AWARE:
            n.add(C.NEED_RACK_FIRST)
        elif g == BROKER_SET_AWARE:
            n.add(C.NEED_BROKER_SET)
        elif g == PREFERRED_LEADER_ELECTION:
            n.add(C.NEED_PREF)
        elif g in (KAFKA_ASSIGNER_RACK, KAFKA_ASSIGNER_DISK):
            return C.ALL_NEEDS
    return frozenset(n)


def check_goal_ids(goal_ids) -> None:
    """Raise for ids outside the goal table."""
    bad = [g for g in goal_ids if not 0 <= g < NUM_GOALS]
    if bad:
        raise ValueError(f"unknown goal ids {bad}: goal ids run from 0 to {NUM_GOALS - 1}")


# -- rack-awareness helpers --------------------------------------------------------


def rack_violating_replicas(state: ClusterArrays, snap: Snapshot) -> torch.Tensor:
    """bool[R]: replicas that must move for rack uniqueness: every member of a
    (partition, rack) group of size > 1 except its lowest-index one, and every
    offline replica."""
    rack = state.broker_rack[state.replica_broker]
    group = state.replica_partition * state.num_racks + rack
    gidx = global_iota(state, snap.spmd)
    group_size = snap.rack_counts.reshape(-1)[group]
    first = snap.rack_first2[group] // 2
    crowded = (group_size > 1) & (gidx != first) & state.replica_valid
    return crowded | snap.offline


# -- violations -------------------------------------------------------------------

_EPS = 1e-6


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32).to(torch.float32)


def _viol_rack_aware(state, ctx, snap):
    if snap.spmd is None:
        return _count(rack_violating_replicas(state, snap))
    # sharded: counted from the MERGED group tables instead of a second merge
    # over the per-replica mask.  |crowded | offline| = sum over groups of
    # max(size - 1, 0), plus the groups whose first member is offline: the
    # same integer (every offline non-first member is crowded already)
    crowded = torch.clamp(snap.rack_counts.reshape(-1) - 1, min=0).sum(dtype=torch.int32)
    first2 = snap.rack_first2
    first_off = ((first2 < C._BIG) & (first2 % 2 == 1)).sum(dtype=torch.int32)
    return (crowded + first_off).to(torch.float32)


def _viol_replica_capacity(state, ctx, snap):
    over = snap.replica_counts > ctx.constraint.max_replicas_per_broker
    return _count(over & state.broker_alive)


def _viol_capacity(res: int):
    def fn(state, ctx, snap):
        over = snap.broker_load[:, res] > snap.cap_limits[:, res] * (1 + _EPS) + _EPS
        return _count(over & state.broker_alive)

    return fn


def _viol_replica_dist(state, ctx, snap):
    counts = snap.replica_counts
    lo, up = snap.replica_band[0], snap.replica_band[1]
    return _count(((counts > up) | (counts < lo)) & state.broker_alive)


def _viol_potential_nw_out(state, ctx, snap):
    pnw_limit = snap.cap_limits[:, Resource.NW_OUT]
    over = snap.potential_nw_out > pnw_limit * (1 + _EPS) + _EPS
    return _count(over & state.broker_alive)


def _viol_dist(res: int):
    def fn(state, ctx, snap):
        outside = (
            snap.broker_load[:, res] > snap.res_upper[:, res] * (1 + _EPS) + _EPS
        ) | (snap.broker_load[:, res] < snap.res_lower[:, res] * (1 - _EPS) - _EPS)
        return _count(outside & state.broker_alive & ~snap.low_util[res])

    return fn


def _viol_leader_dist(state, ctx, snap):
    llo, lup = snap.leader_band[0], snap.leader_band[1]
    lcounts = snap.leader_counts
    return _count(((lcounts > lup) | (lcounts < llo)) & state.broker_alive)


def _viol_leader_bytes_in(state, ctx, snap):
    over = snap.leader_nw_in > snap.leader_nw_in_upper * (1 + _EPS) + _EPS
    return _count(over & state.broker_alive)


def _zero(state):
    return torch.zeros((), dtype=torch.float32, device=state.device)


def _viol_topic_replica_dist(state, ctx, snap):
    if not snap.enable_heavy:
        return _zero(state)
    t_over = (snap.topic_counts > snap.topic_band[1][None, :]) & state.broker_alive[:, None]
    return _count(t_over)


def _viol_min_topic_leaders(state, ctx, snap):
    if not snap.enable_heavy:
        return _zero(state)
    need = ctx.constraint.min_topic_leaders_per_broker
    deficit = torch.clamp(need - snap.topic_leader_counts, min=0) * ctx.min_leader_topics[None, :]
    deficit = torch.where(state.broker_alive[:, None], deficit, 0)
    return deficit.sum(dtype=torch.int32).to(torch.float32)


def _viol_topic_leader_dist(state, ctx, snap):
    if not snap.enable_heavy:
        return _zero(state)
    lt_up = topic_leader_upper(state, ctx, snap)
    return _count((snap.topic_leader_counts > lt_up[None, :]) & state.broker_alive[:, None])


def _refuse_sharded(snap, what: str) -> None:
    if snap.spmd is not None:
        raise NotImplementedError(
            f"{what} reads replica rows outside the merged candidate tables; "
            "ShardedGoalOptimizer routes such goal lists to its gather path"
        )


def _viol_preferred_leader(state, ctx, snap):
    # partitions not led by their replica-list head while the head sits on an
    # alive broker
    _refuse_sharded(snap, "PreferredLeaderElectionGoal")
    pref = snap.preferred_leader
    pref_ok = (pref >= 0) & state.broker_alive[state.replica_broker[torch.clamp(pref, min=0)]]
    return _count(pref_ok & (state.partition_leader != pref))


def _viol_rack_dist(state, ctx, snap):
    # a rack holding more than ceil(RF / alive racks) of a partition's replicas
    rf_p = snap.rack_counts.sum(dim=1, dtype=torch.int32)
    parts = torch.arange(state.num_partitions, device=state.device)
    fair = rack_fair_share(state, snap, parts)
    return _count((snap.rack_counts.amax(dim=1) > fair) & (rf_p > 0))


def _viol_broker_set(state, ctx, snap):
    if snap.spmd is not None:
        # already merged per broker in the snapshot's merge
        return snap.broker_set_need.sum()
    want = ctx.broker_set_of_topic[state.partition_topic[state.replica_partition]]
    have = ctx.broker_set_of_broker[state.replica_broker]
    return _count(state.replica_valid & (want >= 0) & (have != want))


def _viol_intra_disk_capacity(state, ctx, snap):
    if state.num_disks == 0:
        return _zero(state)
    usable = snap.disk_usable
    d_over = (snap.disk_load > snap.disk_limits * (1 + _EPS) + _EPS) & usable
    # any replica on a dead or removed logdir violates the goal, whatever its size
    stranded = snap.disk_replica_counts > 0
    return _count(d_over | (stranded & ~usable))


def _viol_intra_disk_dist(state, ctx, snap):
    if state.num_disks == 0:
        return _zero(state)
    d_out = (
        (snap.disk_load > snap.disk_upper * (1 + _EPS) + _EPS)
        | (snap.disk_load < snap.disk_lower * (1 - _EPS) - _EPS)
    ) & snap.disk_usable
    return _count(d_out)


#: positions tracked by the kafka-assigner evenness metric (replicas at higher
#: positions do not count)
ASSIGNER_POS_CAP = 8


def assigner_position_counts(state: ClusterArrays) -> torch.Tensor:
    """i32[ASSIGNER_POS_CAP, B]: valid replicas per (position, broker).  One
    integer segment-sum call: on the card, one launch of the counting kernel."""
    B = state.num_brokers
    pos = replica_positions(state)
    ok = state.replica_valid & (pos >= 0) & (pos < ASSIGNER_POS_CAP)
    group = torch.where(ok, pos * B + state.replica_broker, -1)
    (counts,) = segment_sums([ok], group, ASSIGNER_POS_CAP * B)
    return counts.view(ASSIGNER_POS_CAP, B)


def assigner_position_unevenness(
    state: ClusterArrays,
    eligible: Optional[torch.Tensor] = None,
    p0_eligible: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32: sum over positions of max(0, max - min - 1) of the per-broker
    counts over ``eligible`` brokers (default: alive); position 0 carries
    leadership and is scored over ``p0_eligible`` (default: ``eligible``).
    0 when every tracked position is as even as integer counts allow."""
    if eligible is None:
        eligible = state.broker_alive
    if p0_eligible is None:
        p0_eligible = eligible
    counts = assigner_position_counts(state)
    el = torch.cat([p0_eligible[None, :], eligible[None, :].expand(ASSIGNER_POS_CAP - 1, -1)])
    cmax = torch.where(el, counts, -1).amax(dim=1)
    cmin = torch.where(el, counts, 2**30).amin(dim=1)
    has_pos = counts.sum(dim=1, dtype=torch.int32) > 0
    spread = torch.where(has_pos, torch.clamp(cmax - cmin - 1, min=0), 0)
    return spread.sum(dtype=torch.int32).to(torch.float32)


def _viol_assigner_rack(state, ctx, snap):
    _refuse_sharded(snap, "KafkaAssignerEvenRackAwareGoal")
    # rack validity of the replicas the mode may move, the even-placement
    # objective over the brokers it may place on (excluded topics' replicas
    # still count in the per-position totals), and replicas stranded outside
    # that destination set
    eligible = state.broker_alive & ~ctx.excluded_for_replica_move
    p0_eligible = eligible & ~ctx.excluded_for_leadership
    topic_excl = ctx.excluded_topics[state.partition_topic[state.replica_partition]]
    rack_bad = rack_violating_replicas(state, snap) & ~topic_excl
    stranded = state.replica_valid & ~topic_excl & ~eligible[state.replica_broker]
    return (
        _count(rack_bad)
        + assigner_position_unevenness(state, eligible, p0_eligible)
        + _count(stranded)
    )


def _viol_assigner_disk(state, ctx, snap):
    _refuse_sharded(snap, "KafkaAssignerDiskUsageDistributionGoal")
    # brokers whose disk utilization leaves [mean (1 - m), mean (1 + m)],
    # m = (balance threshold - 1) * margin, mean = total load / total capacity
    # over alive brokers (summed in the JAX reference's order); 0 when disk
    # is a low-utilization resource, as the goal's own rounds skip it then
    alive = state.broker_alive
    cap = state.broker_capacity[:, Resource.DISK]
    load = snap.broker_load[:, Resource.DISK]
    total_load, total_cap = xla_sums([torch.where(alive, load, 0.0), torch.where(alive, cap, 0.0)])
    mean = total_load / torch.clamp(total_cap, min=_EPS)
    c = ctx.constraint
    margin = (c.resource_balance_threshold[Resource.DISK] - 1.0) * c.balance_margin
    util = load / torch.clamp(cap, min=_EPS)
    outside = (util > mean * (1 + margin) + _EPS) | (
        util < mean * torch.clamp(1 - margin, min=0.0) - _EPS
    )
    return torch.where(snap.low_util[Resource.DISK], 0.0, _count(outside & alive))


_VIOLATION_FNS = {
    RACK_AWARE: _viol_rack_aware,
    MIN_TOPIC_LEADERS: _viol_min_topic_leaders,
    REPLICA_CAPACITY: _viol_replica_capacity,
    DISK_CAPACITY: _viol_capacity(Resource.DISK),
    NW_IN_CAPACITY: _viol_capacity(Resource.NW_IN),
    NW_OUT_CAPACITY: _viol_capacity(Resource.NW_OUT),
    CPU_CAPACITY: _viol_capacity(Resource.CPU),
    REPLICA_DISTRIBUTION: _viol_replica_dist,
    POTENTIAL_NW_OUT: _viol_potential_nw_out,
    DISK_USAGE_DIST: _viol_dist(Resource.DISK),
    NW_IN_USAGE_DIST: _viol_dist(Resource.NW_IN),
    NW_OUT_USAGE_DIST: _viol_dist(Resource.NW_OUT),
    CPU_USAGE_DIST: _viol_dist(Resource.CPU),
    TOPIC_REPLICA_DIST: _viol_topic_replica_dist,
    LEADER_REPLICA_DIST: _viol_leader_dist,
    LEADER_BYTES_IN_DIST: _viol_leader_bytes_in,
    INTRA_DISK_CAPACITY: _viol_intra_disk_capacity,
    INTRA_DISK_USAGE_DIST: _viol_intra_disk_dist,
    PREFERRED_LEADER_ELECTION: _viol_preferred_leader,
    RACK_AWARE_DISTRIBUTION: _viol_rack_dist,
    TOPIC_LEADER_DIST: _viol_topic_leader_dist,
    BROKER_SET_AWARE: _viol_broker_set,
    KAFKA_ASSIGNER_RACK: _viol_assigner_rack,
    KAFKA_ASSIGNER_DISK: _viol_assigner_disk,
}


def violations_one(
    gid: int, state: ClusterArrays, ctx: GoalContext, snap: Snapshot
) -> torch.Tensor:
    """f32: violating-entity count for ONE goal id (0 => satisfied)."""
    return _VIOLATION_FNS[gid](state, ctx, snap)


def violations_all(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    subset: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """f32[NUM_GOALS]: violating-entity count per goal id.  Rows outside
    ``subset`` (default: every goal) stay 0; the heavy [B, T] goals report 0
    when the snapshot was taken without ``enable_heavy``."""
    gids = range(NUM_GOALS) if subset is None else subset
    rows = torch.zeros(NUM_GOALS, dtype=torch.float32, device=state.device)
    for gid in sorted(set(gids)):
        rows[gid] = _VIOLATION_FNS[gid](state, ctx, snap)
    return rows
