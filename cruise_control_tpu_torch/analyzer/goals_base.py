"""Goal registry and per-goal violation counters.

Port of ``cruise_control_tpu/analyzer/goals_base.py``: the reference's goal
classes become integer goal ids, each with a violation counter (here), an
acceptance kernel (:mod:`.acceptance`) and improvement rounds
(:mod:`.goal_rounds`).  The full id table is kept so goal ids and names match
the JAX package; this slice of the port runs the 16 default goals (ids 0-15).
The optional goals 16-23 (JBOD intra-disk, preferred leader, rack-aware
distribution, topic-leader distribution, broker sets, kafka assigner) have ids
and names here but no kernels yet: asking for them raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer.context import GoalContext, Snapshot
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model.arrays import ClusterArrays

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

#: Goal ids this port supports (the default list).
SUPPORTED_GOALS = frozenset(DEFAULT_GOAL_ORDER)

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


def check_supported(goal_ids) -> None:
    """Raise for goal ids this slice of the port does not run yet."""
    missing = [GOAL_NAMES[g] for g in goal_ids if g not in SUPPORTED_GOALS]
    if missing:
        raise NotImplementedError(
            f"goals not ported yet: {', '.join(missing)} (the port runs the 16 default goals)"
        )


# -- rack-awareness helpers --------------------------------------------------------


def rack_violating_replicas(state: ClusterArrays, snap: Snapshot) -> torch.Tensor:
    """bool[R]: replicas that must move for rack uniqueness: every member of a
    (partition, rack) group of size > 1 except its lowest-index one, and every
    offline replica."""
    rack = state.broker_rack[state.replica_broker]
    group = state.replica_partition * state.num_racks + rack
    gidx = torch.arange(state.num_replicas, dtype=torch.int32, device=state.device)
    group_size = snap.rack_counts.reshape(-1)[group]
    first = snap.rack_first2[group] // 2
    crowded = (group_size > 1) & (gidx != first) & state.replica_valid
    return crowded | snap.offline


# -- violations -------------------------------------------------------------------

_EPS = 1e-6


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32).to(torch.float32)


def _viol_rack_aware(state, ctx, snap):
    return _count(rack_violating_replicas(state, snap))


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
}


def violations_one(
    gid: int, state: ClusterArrays, ctx: GoalContext, snap: Snapshot
) -> torch.Tensor:
    """f32: violating-entity count for ONE goal id (0 => satisfied)."""
    check_supported((gid,))
    return _VIOLATION_FNS[gid](state, ctx, snap)


def violations_all(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    subset: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """f32[NUM_GOALS]: violating-entity count per goal id.  Rows outside
    ``subset`` (default: every supported goal) stay 0; the heavy [B, T] goals
    report 0 when the snapshot was taken without ``enable_heavy``."""
    gids = tuple(sorted(SUPPORTED_GOALS)) if subset is None else tuple(subset)
    check_supported(gids)
    rows = torch.zeros(NUM_GOALS, dtype=torch.float32, device=state.device)
    for gid in sorted(set(gids)):
        rows[gid] = _VIOLATION_FNS[gid](state, ctx, snap)
    return rows
