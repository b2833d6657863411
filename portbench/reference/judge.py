"""The plain reference: a proposal's loads, counts, goal violations and movement.

Straightforward numpy, independent of the program: from a cell's input
arrays (``portbench/traffic``) and a delivered placement (each replica's
broker and logdir, each partition's leader) it works out everything a
proposal claims.  It follows upstream cruise-control's definitions, as the
JAX package's ``analyzer/goals_base.py`` and ``analyzer/context.py`` write
them, frozen here:

* a replica's load is its follower-equivalent base load plus, on the leader,
  its partition's leadership delta; a broker's load is the sum over the
  replicas it holds, in float64;
* a capacity goal is violated on an alive broker whose load passes
  ``capacity_threshold x capacity`` (with the goals' epsilon, 1e-6 relative
  and absolute); a usage-distribution goal where the load leaves the band
  ``avg_util x (1 -/+ (balance_threshold - 1) x 0.9) x capacity``, the
  average over alive brokers; the count goals' bands (replicas, leaders,
  topic replicas per broker) are integers, worked out in float32 as upstream
  and the JAX package do, so they are exact here too;
* RackAwareGoal counts every valid replica that shares its (partition, rack)
  with a lower-index replica, and every replica on a dead broker.

A float comparison near its threshold can go either way between float32 and
float64 sums, so each goal's count comes as ``(nominal, strict, lenient)``:
nominal at the goals' epsilon, strict counting only what passes the
threshold by more than ``REL_MARGIN`` of it, lenient counting what comes
within ``REL_MARGIN`` of it.  A count goal has all three equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

CPU, NW_IN, NW_OUT, DISK = range(4)
#: the goals' epsilon (upstream's Resource epsilon; ``goals_base._EPS``)
EPS = 1e-6
#: the relative room a float threshold gets between float32 and float64 sums
REL_MARGIN = 1e-4
MAX_BALANCEDNESS = 100.0

CAPACITY_GOALS = {
    "DiskCapacityGoal": DISK, "NetworkInboundCapacityGoal": NW_IN,
    "NetworkOutboundCapacityGoal": NW_OUT, "CpuCapacityGoal": CPU,
}
DIST_GOALS = {
    "DiskUsageDistributionGoal": DISK, "NetworkInboundUsageDistributionGoal": NW_IN,
    "NetworkOutboundUsageDistributionGoal": NW_OUT, "CpuUsageDistributionGoal": CPU,
}


@dataclasses.dataclass
class Placement:
    """A delivered proposal: each replica's broker and logdir, each
    partition's leader (a replica index, -1 when leaderless)."""

    replica_broker: np.ndarray
    replica_disk: np.ndarray
    partition_leader: np.ndarray


@dataclasses.dataclass
class Sums:
    """What a snapshot of the placement sums: per broker its load [B, 4],
    potential NW-out (every replica as leader), leader bytes-in, replicas and
    leaders; per (partition, rack) the replicas; per (broker, topic) the
    replicas and leaders (with heavy goals)."""

    broker_load: np.ndarray
    potential_nw_out: np.ndarray
    leader_nw_in: np.ndarray
    replica_counts: np.ndarray
    leader_counts: np.ndarray
    rack_counts: np.ndarray
    topic_counts: np.ndarray = None
    topic_leader_counts: np.ndarray = None


def _f32(x) -> np.float32:
    return np.float32(x)


def is_leader(inp: Mapping, pl: Placement) -> np.ndarray:
    R = inp["replica_partition"].shape[0]
    lead_of = pl.partition_leader[inp["replica_partition"]]
    return (lead_of == np.arange(R)) & inp["replica_valid"]


def sums(inp: Mapping, pl: Placement, heavy: bool) -> Sums:
    """The snapshot's sums, the loads in float64."""
    B = inp["broker_rack"].shape[0]
    P = inp["partition_topic"].shape[0]
    T, racks = int(inp["num_topics"]), int(inp["num_racks"])
    rp = inp["replica_partition"].astype(np.int64)
    rb = pl.replica_broker.astype(np.int64)
    valid = inp["replica_valid"]
    lead = is_leader(inp, pl)
    base = inp["base_load"].astype(np.float64)
    delta = inp["leadership_delta"].astype(np.float64)[rp]
    eff = np.where(valid[:, None], base + np.where(lead[:, None], delta, 0.0), 0.0)
    load = np.stack([np.bincount(rb, weights=eff[:, k], minlength=B) for k in range(4)], axis=1)
    pnw = np.bincount(rb, weights=np.where(valid, base[:, NW_OUT] + delta[:, NW_OUT], 0.0), minlength=B)
    lbi = np.bincount(rb, weights=np.where(lead, eff[:, NW_IN], 0.0), minlength=B)
    rack = inp["broker_rack"].astype(np.int64)[rb]
    out = Sums(
        broker_load=load,
        potential_nw_out=pnw,
        leader_nw_in=lbi,
        replica_counts=np.bincount(rb[valid], minlength=B),
        leader_counts=np.bincount(rb[lead], minlength=B),
        rack_counts=np.bincount((rp * racks + rack)[valid], minlength=P * racks).reshape(P, racks),
    )
    if heavy:
        topic = inp["partition_topic"].astype(np.int64)[rp]
        cell = rb * T + topic
        out.topic_counts = np.bincount(cell[valid], minlength=B * T).reshape(B, T)
        out.topic_leader_counts = np.bincount(cell[lead], minlength=B * T).reshape(B, T)
    return out


def placement_faults(inp: Mapping, pl: Placement) -> int:
    """Structural faults of a placement: a replica off the broker axis, on
    a logdir on a cluster without JBOD, two replicas of a partition on one
    broker, a leader that is not a valid replica of its partition, a
    partition the input gave a leader left leaderless."""
    B = inp["broker_rack"].shape[0]
    R = inp["replica_partition"].shape[0]
    P = inp["partition_topic"].shape[0]
    rb = pl.replica_broker.astype(np.int64)
    valid = inp["replica_valid"]
    faults = int(((rb < 0) | (rb >= B))[valid].sum())
    if inp["disk_broker"].shape[0] == 0:
        faults += int((pl.replica_disk[valid] != -1).sum())
    ok = valid & (rb >= 0) & (rb < B)
    pairs = inp["replica_partition"].astype(np.int64)[ok] * B + rb[ok]
    faults += int(pairs.size - np.unique(pairs).size)
    lead = pl.partition_leader.astype(np.int64)
    has = lead >= 0
    in_range = has & (lead < R)
    safe = np.where(in_range, lead, 0)
    good = in_range & (inp["replica_partition"][safe] == np.arange(P)) & valid[safe]
    faults += int((has & ~good).sum())
    faults += int((~has & (inp["partition_leader"] >= 0)).sum())
    return faults


def _count_bands(total: int, n_alive: int, threshold: float, margin: float) -> Tuple[int, int]:
    """(lower, upper) count band, in float32 as upstream's and the JAX
    package's arithmetic: pct = (threshold - 1) x margin, upper =
    ceil(avg (1 + pct)), lower = floor(avg max(0, 1 - pct))."""
    avg = _f32(total) / _f32(n_alive)
    pct = (_f32(threshold) * _f32(1.0) - _f32(1.0)) * _f32(margin)
    up = int(np.ceil(avg * (_f32(1.0) + pct)))
    lo = int(np.floor(avg * max(_f32(1.0) - pct, _f32(0.0))))
    return lo, up


def _over(x: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(nominal, strict, lenient) masks of ``x`` past the upper threshold
    ``t`` with the goals' epsilon."""
    nominal = x > t * (1 + EPS) + EPS
    strict = x > (t * (1 + EPS) + EPS) * (1 + REL_MARGIN) + EPS
    lenient = x > (t * (1 + EPS) + EPS) * (1 - REL_MARGIN) - EPS
    return nominal, strict, lenient


def _under(x: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    nominal = x < t * (1 - EPS) - EPS
    strict = x < (t * (1 - EPS) - EPS) * (1 - REL_MARGIN) - EPS
    lenient = x < (t * (1 - EPS) - EPS) * (1 + REL_MARGIN) + EPS
    return nominal, strict, lenient


def _counts(masks, alive) -> Tuple[int, int, int]:
    return tuple(int((m & alive).sum()) for m in masks)


def violations(inp: Mapping, pl: Placement, goals: Sequence[str], constraint: Mapping,
               s: Sums) -> Dict[str, Tuple[int, int, int]]:
    """Each goal's violation count after the proposal, ``(nominal, strict,
    lenient)``."""
    c = constraint
    alive = inp["broker_alive"]
    n_alive = max(int(alive.sum()), 1)
    cap = inp["broker_capacity"].astype(np.float64)
    cap_thr = np.asarray(c["capacity_threshold"], np.float64)
    bal_thr = np.asarray(c["balance_threshold"], np.float64)
    margin = float(c["balance_margin"])
    low_thr = np.asarray(c["low_utilization_threshold"], np.float64)
    cap_limit = cap_thr[None, :] * cap
    total_load = np.where(alive[:, None], s.broker_load, 0).sum(axis=0)
    total_cap = np.where(alive[:, None], cap, 0).sum(axis=0)
    avg_pct = total_load / np.maximum(total_cap, 1e-9)
    bpm = (bal_thr - 1.0) * margin
    low = avg_pct <= low_thr
    lower_pct = np.where(low, 0.0, avg_pct * np.maximum(1.0 - bpm, 0.0))
    upper_pct = avg_pct * (1.0 + bpm)
    upper_pct = np.where(low, np.maximum(upper_pct, low_thr * margin), upper_pct)

    out: Dict[str, Tuple[int, int, int]] = {}
    for g in goals:
        if g == "RackAwareGoal":
            n = rack_violations(inp, pl)
            out[g] = (n, n, n)
        elif g == "MinTopicLeadersPerBrokerGoal":
            # topics subject to the goal: ``min_topic_leader_topics`` (none by default)
            topics = np.zeros(int(inp["num_topics"]), bool)
            topics[list(c.get("min_topic_leader_topics", []))] = True
            need = int(c["min_topic_leaders_per_broker"])
            deficit = np.maximum(need - s.topic_leader_counts, 0) * topics[None, :]
            n = int(deficit[alive].sum())
            out[g] = (n, n, n)
        elif g == "ReplicaCapacityGoal":
            n = int(((s.replica_counts > int(c["max_replicas_per_broker"])) & alive).sum())
            out[g] = (n, n, n)
        elif g in CAPACITY_GOALS:
            r = CAPACITY_GOALS[g]
            out[g] = _counts(_over(s.broker_load[:, r], cap_limit[:, r]), alive)
        elif g == "ReplicaDistributionGoal":
            lo, up = _count_bands(int(s.replica_counts.sum()), n_alive, c["replica_balance_threshold"], margin)
            n = int((((s.replica_counts > up) | (s.replica_counts < lo)) & alive).sum())
            out[g] = (n, n, n)
        elif g == "LeaderReplicaDistributionGoal":
            lo, up = _count_bands(int(s.leader_counts.sum()), n_alive,
                                  c["leader_replica_balance_threshold"], margin)
            n = int((((s.leader_counts > up) | (s.leader_counts < lo)) & alive).sum())
            out[g] = (n, n, n)
        elif g == "PotentialNwOutGoal":
            out[g] = _counts(_over(s.potential_nw_out, cap_limit[:, NW_OUT]), alive)
        elif g in DIST_GOALS:
            r = DIST_GOALS[g]
            if low[r]:
                out[g] = (0, 0, 0)
                continue
            hi = _over(s.broker_load[:, r], upper_pct[r] * cap[:, r])
            lo_ = _under(s.broker_load[:, r], lower_pct[r] * cap[:, r])
            out[g] = _counts(tuple(a | b for a, b in zip(hi, lo_)), alive)
        elif g == "TopicReplicaDistributionGoal":
            n = int(topic_violations(s.topic_counts, n_alive, c, alive))
            out[g] = (n, n, n)
        elif g == "LeaderBytesInDistributionGoal":
            lbi_total = np.where(alive, s.leader_nw_in, 0).sum()
            up = lbi_total / n_alive * (1.0 + bpm[NW_IN])
            out[g] = _counts(_over(s.leader_nw_in, np.full_like(s.leader_nw_in, up)), alive)
        else:
            raise ValueError(f"the reference does not judge {g!r}")
    return out


def rack_violations(inp: Mapping, pl: Placement) -> int:
    """RackAwareGoal: valid replicas sharing their (partition, rack) with a
    lower-index replica, and every valid replica on a dead broker."""
    racks = int(inp["num_racks"])
    rb = pl.replica_broker.astype(np.int64)
    valid = inp["replica_valid"]
    group = inp["replica_partition"].astype(np.int64) * racks + inp["broker_rack"].astype(np.int64)[rb]
    idx = np.arange(rb.shape[0])
    first = np.full(int(inp["partition_topic"].shape[0]) * racks, rb.shape[0], np.int64)
    np.minimum.at(first, group[valid], idx[valid])
    crowded = valid & (idx != first[group])
    offline = valid & ~inp["broker_alive"][rb]
    return int((crowded | offline).sum())


def topic_violations(topic_counts: np.ndarray, n_alive: int, c: Mapping, alive: np.ndarray) -> int:
    """TopicReplicaDistributionGoal: (alive broker, topic) cells above the
    topic's upper band, the band worked out in float32 as upstream."""
    totals = topic_counts.sum(axis=0)
    avg = totals.astype(np.float32) / np.float32(n_alive)
    pct = (_f32(c["topic_replica_balance_threshold"]) * _f32(1.0) - _f32(1.0)) * _f32(c["balance_margin"])
    gap = np.ceil(avg * pct).astype(np.int64)
    gap = np.minimum(np.maximum(gap, int(c["topic_replica_balance_min_gap"])), int(c["topic_replica_balance_max_gap"]))
    up = np.floor(avg).astype(np.int64) + gap
    return int(((topic_counts > up[None, :]) & alive[:, None]).sum())


@dataclasses.dataclass
class Movement:
    """What executing the proposal moves: replicas that change broker, the
    data they carry (their disk load, summed exactly), partitions whose
    leader ends on another broker."""

    inter_broker_moves: int
    data_moved: float
    leadership_moves: int


def movement(inp: Mapping, pl: Placement) -> Movement:
    valid = inp["replica_valid"]
    b0 = inp["replica_broker"]
    moved = valid & (b0 != pl.replica_broker)
    disk = inp["base_load"][:, DISK].astype(np.float64)
    l0, l1 = inp["partition_leader"], pl.partition_leader
    has = (l0 >= 0) & (l1 >= 0)
    lead_moved = has & (b0[np.maximum(l0, 0)] != pl.replica_broker[np.maximum(l1, 0)])
    return Movement(int(moved.sum()), math.fsum(disk[moved]), int(lead_moved.sum()))


def balancedness(goals: Sequence[str], hard: Sequence[str], violated: Sequence[str],
                 priority_weight: float = 1.1, strictness_weight: float = 1.5) -> float:
    """Upstream's score (``balancednessCostByGoal``): 100 less the cost of
    each violated goal, the costs summing to 100, each goal's weight 1.1
    times the next one's in priority order and 1.5 times more when hard."""
    costs, weight = {}, 1.0
    for g in reversed(list(goals)):
        costs[g] = weight * (strictness_weight if g in hard else 1.0)
        weight *= priority_weight
    total = sum(costs.values())
    return MAX_BALANCEDNESS - sum(MAX_BALANCEDNESS * costs[g] / total for g in violated)
