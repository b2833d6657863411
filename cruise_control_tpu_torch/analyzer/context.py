"""Optimization options and the per-round snapshot shared by goal kernels.

Port of ``cruise_control_tpu/analyzer/context.py``.
``GoalContext`` is the tensor form of the reference's
``OptimizationOptions.java`` plus the :class:`BalancingConstraint`;
``Snapshot`` bundles every derived tensor the goal kernels read (effective
loads, per-broker loads and counts, rack occupancy, capacity limits, balance
bands), computed once per optimizer round.

Every replica-axis sum here goes through :func:`ops.segments.segment_sums`,
so on the card it runs the hand-written segment-sum kernels: the broker-keyed
sums share one call, the (broker, topic) tables another.  The cross-broker
sums behind the balance bands add in the JAX reference's order
(:func:`ops.index.xla_sums`).  The [B, T] per-topic tables are built only when
``enable_heavy`` is set, and the optional groups (``NEED_*``) only when the
caller's ``needs`` names them.

Under the sharded solver (``spmd``, :mod:`parallel.spmd`) the replica-axis
tensors are this rank's block: every replica-axis reduction becomes a local
partial (the same kernel calls on the block) and every field past the merges
is replicated.  The sums run as ONE fold over the ranks in rank order
(``chained_segment_sums``: the float sums round as the single-device
row-order sums do) and the mins merge in ONE ``merge_mins``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops.index import lane_xla_sums, segment_max, segment_min
from cruise_control_tpu_torch.ops.segments import segment_sums as _segment_sums
from cruise_control_tpu_torch.parallel.spmd import chained_segment_sums, merge_mins

I32 = torch.int32
F32 = torch.float32
NEG = -3e38
_BIG = 2**30


@dataclasses.dataclass
class GoalContext:
    constraint: BalancingConstraint
    excluded_topics: torch.Tensor            # bool[T]
    excluded_for_leadership: torch.Tensor    # bool[B]
    excluded_for_replica_move: torch.Tensor  # bool[B]
    only_move_immigrants: bool
    triggered_by_violation: bool             # widens distribution bands
    #: bool[T] topics subject to MinTopicLeadersPerBrokerGoal (all False: off)
    min_leader_topics: torch.Tensor
    fast_mode: bool
    #: i32[B]/[T] broker-set membership for BrokerSetAwareGoal; -1 = unassigned
    broker_set_of_broker: torch.Tensor
    broker_set_of_topic: torch.Tensor
    #: candidate actions nominated per broker per round
    top_k: int = 8
    #: maximum brokers acting as sources/destinations in one round
    max_active_brokers: int = 256

    @property
    def device(self) -> torch.device:
        return self.excluded_topics.device

    def replace(self, **changes) -> "GoalContext":
        return dataclasses.replace(self, **changes)

    def to(self, device: DeviceLike) -> "GoalContext":
        dev = resolve_device(device)
        out = {
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return self.replace(constraint=self.constraint.to(dev), **out)

    @classmethod
    def build(
        cls,
        num_topics: int,
        num_brokers: int,
        constraint: Optional[BalancingConstraint] = None,
        excluded_topic_ids: Sequence[int] = (),
        excluded_brokers_for_leadership: Sequence[int] = (),
        excluded_brokers_for_replica_move: Sequence[int] = (),
        only_move_immigrants: bool = False,
        triggered_by_violation: bool = False,
        min_leader_topic_ids: Sequence[int] = (),
        fast_mode: bool = False,
        top_k: int = 8,
        max_active_brokers: int = 256,
        broker_set_of_broker: Sequence[int] = (),
        broker_set_of_topic: Sequence[int] = (),
        device: DeviceLike = None,
    ) -> "GoalContext":
        dev = resolve_device(device)

        def mask(n, ids):
            m = np.zeros(n, bool)
            if ids:
                m[list(ids)] = True
            return torch.from_numpy(m).to(dev)

        def sets(n, ids):
            arr = np.asarray(list(ids), np.int32) if ids else np.full(n, -1, np.int32)
            return torch.from_numpy(arr).to(dev)

        return cls(
            constraint=(
                constraint.to(dev) if constraint is not None
                else BalancingConstraint.default(device=dev)
            ),
            excluded_topics=mask(num_topics, excluded_topic_ids),
            excluded_for_leadership=mask(num_brokers, excluded_brokers_for_leadership),
            excluded_for_replica_move=mask(num_brokers, excluded_brokers_for_replica_move),
            only_move_immigrants=bool(only_move_immigrants),
            triggered_by_violation=bool(triggered_by_violation),
            min_leader_topics=mask(num_topics, min_leader_topic_ids),
            fast_mode=bool(fast_mode),
            top_k=top_k,
            max_active_brokers=max_active_brokers,
            broker_set_of_broker=sets(num_brokers, broker_set_of_broker),
            broker_set_of_topic=sets(num_topics, broker_set_of_topic),
        )


def pad_context_brokers(ctx: GoalContext, num_brokers: int) -> GoalContext:
    """Pad the context's broker-axis masks to a bucketed broker dimension:
    padding slots are not excluded and carry no broker set (-1)."""
    B = ctx.excluded_for_leadership.shape[0]
    if num_brokers == B:
        return ctx
    if num_brokers < B:
        raise ValueError(f"pad_context_brokers: target {num_brokers} smaller than current {B}")
    pad = num_brokers - B
    false_pad = torch.zeros(pad, dtype=torch.bool, device=ctx.device)
    return ctx.replace(
        excluded_for_leadership=torch.cat([ctx.excluded_for_leadership, false_pad]),
        excluded_for_replica_move=torch.cat([ctx.excluded_for_replica_move, false_pad]),
        broker_set_of_broker=torch.cat([
            ctx.broker_set_of_broker,
            torch.full((pad,), -1, dtype=I32, device=ctx.device),
        ]),
    )


@dataclasses.dataclass
class Snapshot:
    """Derived tensors for one optimizer round (pure functions of the state)."""

    eff_load: torch.Tensor        # f32[R, 4]
    is_leader: torch.Tensor       # bool[R]
    broker_load: torch.Tensor     # f32[B, 4]
    replica_counts: torch.Tensor  # i32[B]
    leader_counts: torch.Tensor   # i32[B]
    potential_nw_out: torch.Tensor  # f32[B]
    rack_counts: torch.Tensor     # i32[P, num_racks]
    util_pct: torch.Tensor        # f32[B, 4] utilization / capacity
    movable: torch.Tensor         # bool[R] replica may be relocated at all
    topic_allowed: torch.Tensor   # bool[R] replica's topic is not excluded
    leader_movable: torch.Tensor  # bool[R] leadership may move *to* this replica
    dest_ok: torch.Tensor         # bool[B] broker eligible as move destination
    offline: torch.Tensor         # bool[R] replica must leave its broker/disk

    avg_util_pct: torch.Tensor    # f32[4]
    cap_limits: torch.Tensor      # f32[B, 4] capacity_threshold * capacity
    res_lower: torch.Tensor       # f32[B, 4] distribution band lower bound
    res_upper: torch.Tensor       # f32[B, 4] distribution band upper bound
    low_util: torch.Tensor        # bool[4]
    replica_band: torch.Tensor    # i32[2] (lower, upper) replicas per broker
    leader_band: torch.Tensor     # i32[2] (lower, upper) leaders per broker
    leader_nw_in: torch.Tensor    # f32[B] bytes-in of leader replicas per broker
    leader_nw_in_upper: torch.Tensor  # f32 upper band for leader bytes-in

    disk_load: torch.Tensor           # f32[D]
    disk_limits: torch.Tensor         # f32[D]
    disk_lower: torch.Tensor          # f32[D]
    disk_upper: torch.Tensor          # f32[D]
    disk_usable: torch.Tensor         # bool[D]
    disk_replica_counts: torch.Tensor  # i32[D]

    offline_per_broker: torch.Tensor  # f32[B]

    # optional groups (take_snapshot ``needs``): None when trimmed away
    #: i32[P] lowest-index valid replica of each partition (-1 if none)
    preferred_leader: Optional[torch.Tensor]
    leader_broker: Optional[torch.Tensor]    # i32[P] broker hosting each leader
    leader_eff: Optional[torch.Tensor]       # f32[P, 4] effective load of each leader
    #: i32[P*racks] per-(partition, rack) min of (replica_idx << 1 | offline)
    rack_first2: Optional[torch.Tensor]
    rack_viol_need: Optional[torch.Tensor]   # f32[B]
    broker_set_need: Optional[torch.Tensor]  # f32[B]

    topic_counts: Optional[torch.Tensor] = None        # i32[B, T]
    topic_band: Optional[torch.Tensor] = None          # i32[2, T]
    topic_leader_counts: Optional[torch.Tensor] = None  # i32[B, T]
    enable_heavy: bool = False
    #: replica-axis sharding (parallel.spmd.SpmdInfo): None single-device;
    #: under the sharded solver the per-replica fields above are this rank's
    #: rows while every reduction field is already merged and replicated
    spmd: Optional[object] = None

    def replace(self, **changes) -> "Snapshot":
        return dataclasses.replace(self, **changes)


#: optional snapshot groups (take_snapshot ``needs``): tables only some goal
#: steps read.  The port runs eagerly, with no compiler to drop an unused
#: output, so each goal step names the groups its rounds, acceptance terms and
#: violation counter read (goals_base.goal_snapshot_needs) and the rest are
#: never computed.
NEED_RACK_FIRST = "rack_first"    # rack_first2, rack_viol_need (RackAwareGoal)
NEED_LEADER = "leader"            # leader_broker / leader_eff (leadership rounds)
NEED_PREF = "pref"                # preferred_leader (PreferredLeaderElectionGoal)
NEED_BROKER_SET = "broker_set"    # broker_set_need (BrokerSetAwareGoal)
ALL_NEEDS = frozenset({NEED_RACK_FIRST, NEED_LEADER, NEED_PREF, NEED_BROKER_SET})


def _sums(columns, seg: torch.Tensor, num_segments: int, lanes: Optional[int]):
    """The segment sums of one state, or of every lane of a stack in one
    call (``model.arrays.lane_segment_sums``)."""
    if lanes is None:
        return _segment_sums(columns, seg, num_segments)
    return A.lane_segment_sums(columns, seg, num_segments, lanes)


#: positions tracked by the kafka-assigner evenness metric
#: (``goals_base.assigner_position_counts``)
ASSIGNER_POS_CAP = 8
#: columns of the snapshot's widest call: the broker call's four loads, two
#: counts and up to five float columns
_BROKER_COLUMNS = 11
_INT32_MAX = 2**31 - 1


def lane_span(state: ClusterArrays, enable_heavy: bool) -> int:
    """The most one lane adds to any int32 count of a lane-form snapshot and
    violation pass: a call's rows or segments times its columns, or a
    lane-offset segment id.  A stack's lanes times this must fit in int32."""
    B = state.num_brokers
    span = max(
        state.num_replicas * _BROKER_COLUMNS, B * _BROKER_COLUMNS, ASSIGNER_POS_CAP * B,
        state.num_partitions * max(state.num_racks, 1), state.num_disks,
    )
    return max(span, 2 * B * state.num_topics) if enable_heavy else span


def check_lane_span(lanes: int, span: int) -> None:
    """Raise, before anything is allocated, when ``lanes`` lanes of ``span``
    (:func:`lane_span`) would pass int32 indexing: a lane-offset id would
    wrap into another lane's segments."""
    if lanes * span > _INT32_MAX:
        raise ValueError(
            f"{lanes} lanes x {span:,} (the widest lane-form call of one lane) exceed int32 indexing "
            f"({_INT32_MAX:,}): evaluate at most {max(_INT32_MAX // span, 1)} lanes of this shape at once"
        )


def take_snapshot(
    state: ClusterArrays,
    ctx: GoalContext,
    enable_heavy: bool = False,
    needs: frozenset = ALL_NEEDS,
    spmd=None,
) -> Snapshot:
    """Derive one round's tensors.  A group left out of ``needs`` is None in
    the snapshot, so an unexpected reader fails loudly instead of reading a
    stale table.  ``spmd`` (parallel.spmd.SpmdInfo) switches the replica
    axis to this rank's block: ``partition_leader`` holds GLOBAL replica
    ids, and every reduction merges over the ranks.

    A stack (``model.arrays.stack_arrays``) gives every lane's snapshot at
    once, the JAX package's ``vmap`` of this function: each field gains a
    leading lane axis, and each segment-sum call covers every lane (ids
    offset past the last lane's segments, each lane's rows in their order,
    so each lane's float sums round as its own call's), the cross-broker sums
    add each lane in XLA's order (``xla_sums(lanes=)``)."""
    dev = state.device
    L = A.lanes_of(state)
    if L is not None:
        if spmd is not None:
            raise ValueError("take_snapshot: a stack of lanes is never sharded over ranks")
        check_lane_span(L, lane_span(state, enable_heavy))
    lanes = A.lane_shape(state)
    if spmd is None:
        eff = A.effective_load(state)
        lead = A.is_leader(state)
        gidx = torch.arange(state.num_replicas, dtype=I32, device=dev)
    else:
        gidx = spmd.iota()
        lead = (state.partition_leader[state.replica_partition] == gidx) & state.replica_valid
        delta_r = state.leadership_delta[state.replica_partition]
        eff = state.base_load + torch.where(lead[:, None], delta_r, 0.0)
        eff = torch.where(state.replica_valid[:, None], eff, 0.0)
    topic = A.take(state.partition_topic, state.replica_partition, L)
    offline = state.replica_offline_mask()
    immigrant = state.replica_broker != state.original_broker
    topic_allowed = state.replica_valid & ~ctx.excluded_topics[topic]
    movable = topic_allowed & (immigrant | offline) if ctx.only_move_immigrants else topic_allowed
    dest_ok = state.broker_alive & ~ctx.excluded_for_replica_move
    rb = state.replica_broker
    rp = state.replica_partition
    rvalid = state.replica_valid
    leader_movable = (
        rvalid
        & A.take(state.broker_alive, rb, L)
        & ~A.take(state.broker_demoted, rb, L)
        & ~ctx.excluded_for_leadership[rb]
        & ~offline
    )
    cap = torch.clamp(state.broker_capacity, min=1e-9)

    B = state.num_brokers
    P = state.num_partitions
    D = state.num_disks

    rack = A.take(state.broker_rack, rb, L)
    group = rp * state.num_racks + rack
    on_disk = state.replica_disk >= 0

    leader_broker = leader_eff = preferred = rack_first2 = rack_viol = bs_bad = None
    if NEED_LEADER in needs:
        # leaderless partitions read replica row 0, as the JAX package does
        ltarget = torch.clamp(state.partition_leader, min=0)
        if spmd is None:
            leader_broker = A.take(rb, ltarget, L)
            leader_eff = A.take(eff, ltarget, L)
        else:
            # the rank owning partition_leader[p] contributes the row, every
            # other rank zeros: the merged sum adds to zeros only (exact)
            loc = ltarget - spmd.offset()
            mine = (loc >= 0) & (loc < state.num_replicas)
            safe = torch.where(mine, loc, 0)
            leader_broker = torch.where(mine, rb[safe], 0)
            leader_eff = torch.where(mine[:, None], eff[safe], 0.0)
    if NEED_BROKER_SET in needs:
        want_set = ctx.broker_set_of_topic[topic]
        have_set = ctx.broker_set_of_broker[rb]
        bs_bad = rvalid & (want_set >= 0) & (have_set != want_set)
    # the mins merge FIRST: the rack-violation rows read the merged
    # group-first table, and their per-broker count joins the sums' merge
    mins = {}
    if NEED_PREF in needs:
        mins["pref"] = segment_min(torch.where(rvalid, gidx, _BIG), rp, P, L)
    if NEED_RACK_FIRST in needs:
        mins["rack_first2"] = segment_min(
            torch.where(rvalid, gidx * 2 + offline.to(I32), _BIG), group, P * state.num_racks, L
        )
    mins = merge_mins(spmd, mins)
    if NEED_PREF in needs:
        pref = mins["pref"]
        preferred = torch.where(pref < _BIG, pref, -1)
    if NEED_RACK_FIRST in needs:
        rack_first2 = mins["rack_first2"]
        # a valid row that is not its (partition, rack) group's first member
        # sits in a group of size > 1: rack-violating, as is every offline row
        rack_viol = (rvalid & (gidx != A.take(rack_first2, group, L) // 2)) | offline

    # every broker-keyed sum in one call: float columns in row order, the
    # bool columns counted into int32
    optional = [x.to(F32) for x in (bs_bad, rack_viol) if x is not None]
    broker_columns = [
        eff,
        rvalid,
        lead,
        torch.where(
            rvalid,
            state.base_load[..., Resource.NW_OUT] + A.take(state.leadership_delta[..., Resource.NW_OUT], rp, L),
            0.0,
        ),
        torch.where(lead, eff[..., Resource.NW_IN], 0.0),
        offline.to(F32),
        *optional,
    ]
    T = state.num_topics

    def topic_tables():
        return _sums([rvalid, lead], rb * T + topic, B * T, L)

    if spmd is None:
        broker_sums = _sums(broker_columns, rb, B, L)
    (rack_counts,) = _sums([rvalid], group, P * state.num_racks, L)
    if spmd is None:
        dload = A.disk_load(state)
    if D > 0:
        (d_counts,) = _sums([on_disk & rvalid], state.replica_disk, D, L)
    else:
        d_counts = torch.zeros(lanes + (0,), dtype=I32, device=dev)
    topic_counts = topic_leader_counts = None
    if spmd is not None:
        if enable_heavy:
            topic_counts, topic_leader_counts = topic_tables()
        # ONE fold over the ranks in rank order: the broker-keyed and disk
        # sums continue the single-device row-order sums rank after rank, so
        # their floats round as single-device; the integer partials and the
        # leader rows (one rank contributes each) add up exactly on the way
        calls = [(broker_columns, rb, B)]
        if D > 0:
            du, disk_idx = A.disk_load_terms(state)
            calls.append(([du], disk_idx, D))
        optional_parts = dict(
            leader_broker=leader_broker, leader_eff=leader_eff,
            topic_counts=topic_counts, topic_leader_counts=topic_leader_counts,
        )
        parts = dict(rack_counts=rack_counts, d_counts=d_counts)
        parts.update({k: v for k, v in optional_parts.items() if v is not None})
        chained, merged = chained_segment_sums(spmd, calls, parts)
        broker_sums = chained[0]
        dload = chained[1][0] if D > 0 else torch.zeros((0,), dtype=F32, device=dev)
        rack_counts, d_counts = merged["rack_counts"], merged["d_counts"]
        leader_broker, leader_eff, topic_counts, topic_leader_counts = (
            merged.get(k) for k in optional_parts
        )
    bload, replica_counts, leader_counts, pnw, lbi, offline_per_broker, *needs_sums = broker_sums
    broker_set_need = needs_sums.pop(0) if bs_bad is not None else None
    rack_viol_need = needs_sums.pop(0) if rack_viol is not None else None

    # cross-broker sums in the JAX reference's (XLA CPU) order: the bands
    # they set decide which brokers are over or under
    alive = state.broker_alive
    n_alive = torch.clamp(alive.sum(dim=-1, dtype=I32), min=1)
    total_load, total_cap, lbi_total = lane_xla_sums([
        torch.where(alive[..., None], bload, 0.0),
        torch.where(alive[..., None], state.broker_capacity, 0.0),
        torch.where(alive, lbi, 0.0),
    ], L)
    avg_pct = total_load / torch.clamp(total_cap, min=1e-9)

    c = ctx.constraint
    tv = ctx.triggered_by_violation
    lower_pct, upper_pct = c.utilization_bands(avg_pct, tv)
    res_lower = lower_pct[..., None, :] * state.broker_capacity
    res_upper = upper_pct[..., None, :] * state.broker_capacity
    res_lower = torch.where(ctx.excluded_for_replica_move[:, None], 0.0, res_lower)
    low_util = avg_pct <= c.low_utilization_threshold

    r_lo, r_up = c.count_band(
        replica_counts.sum(dim=-1, dtype=I32).to(F32) / n_alive, c.replica_balance_threshold, tv
    )
    l_lo, l_up = c.count_band(
        leader_counts.sum(dim=-1, dtype=I32).to(F32) / n_alive, c.leader_replica_balance_threshold, tv
    )

    lbi_avg = lbi_total / n_alive
    bpm = c.balance_percentage_with_margin(tv)
    lbi_upper = lbi_avg * (1.0 + bpm[Resource.NW_IN])

    d_usable = state.disk_alive & (state.disk_capacity > 0.0)
    d_limit = c.resource_capacity_threshold[Resource.DISK] * state.disk_capacity
    if D > 0:
        per_b_load, per_b_cap = _sums(
            [torch.where(d_usable, dload, 0.0), torch.where(d_usable, state.disk_capacity, 0.0)],
            state.disk_broker, B, L,
        )
        avg_d_pct = per_b_load / torch.clamp(per_b_cap, min=1e-9)
        bpm_d = bpm[Resource.DISK]
        d_avg = A.take(avg_d_pct, state.disk_broker, L)
        d_lower = torch.clamp(d_avg * (1.0 - bpm_d), min=0.0) * state.disk_capacity
        d_upper = d_avg * (1.0 + bpm_d) * state.disk_capacity
        d_lower = torch.where(d_usable, d_lower, 0.0)
        d_upper = torch.where(d_usable, d_upper, 0.0)
    else:
        d_lower = torch.zeros(lanes + (0,), dtype=F32, device=dev)
        d_upper = torch.zeros(lanes + (0,), dtype=F32, device=dev)

    topic_band = None
    if enable_heavy:
        if spmd is None:
            topic_counts, topic_leader_counts = topic_tables()
        topic_counts = topic_counts.reshape(lanes + (B, T))
        topic_leader_counts = topic_leader_counts.reshape(lanes + (B, T))
        totals = topic_counts.sum(dim=-2, dtype=I32)
        avg_t = totals.to(F32) / n_alive[..., None]
        mult = c.distribution_threshold_multiplier if tv else 1.0
        pct = (c.topic_replica_balance_threshold * mult - 1.0) * c.balance_margin
        gap = torch.ceil(avg_t * pct).to(I32)
        gap = torch.minimum(
            torch.maximum(gap, c.topic_replica_balance_min_gap), c.topic_replica_balance_max_gap
        )
        t_up = torch.floor(avg_t).to(I32) + gap
        t_lo = torch.clamp(torch.ceil(avg_t).to(I32) - gap, min=0)
        topic_band = torch.stack([t_lo, t_up], dim=-2)

    return Snapshot(
        eff_load=eff,
        is_leader=lead,
        broker_load=bload,
        replica_counts=replica_counts,
        leader_counts=leader_counts,
        potential_nw_out=pnw,
        rack_counts=rack_counts.reshape(lanes + (P, state.num_racks)),
        util_pct=bload / cap,
        movable=movable,
        topic_allowed=topic_allowed,
        leader_movable=leader_movable,
        dest_ok=dest_ok,
        offline=offline,
        avg_util_pct=avg_pct,
        cap_limits=c.resource_capacity_threshold[None, :] * state.broker_capacity,
        res_lower=res_lower,
        res_upper=res_upper,
        low_util=low_util,
        replica_band=torch.stack([r_lo, r_up], dim=-1),
        leader_band=torch.stack([l_lo, l_up], dim=-1),
        leader_nw_in=lbi,
        leader_nw_in_upper=lbi_upper,
        disk_load=dload,
        disk_limits=d_limit,
        disk_lower=d_lower,
        disk_upper=d_upper,
        disk_usable=d_usable,
        disk_replica_counts=d_counts,
        preferred_leader=preferred,
        leader_broker=leader_broker,
        leader_eff=leader_eff,
        rack_first2=rack_first2,
        offline_per_broker=offline_per_broker,
        broker_set_need=broker_set_need,
        rack_viol_need=rack_viol_need,
        topic_counts=topic_counts,
        topic_band=topic_band,
        topic_leader_counts=topic_leader_counts,
        enable_heavy=enable_heavy,
        spmd=spmd,
    )


# ---------------------------------------------------------------------------
# Small shared kernels.
# ---------------------------------------------------------------------------


def topic_leader_upper(state: ClusterArrays, ctx: GoalContext, snap: Snapshot) -> torch.Tensor:
    """i32[T] (i32[S, T] of a stack): per-topic leader-count upper band
    (TopicLeaderReplicaDistributionGoal)."""
    lt = snap.topic_leader_counts
    c = ctx.constraint
    alive_n = torch.clamp(state.broker_alive.sum(dim=-1, dtype=I32), min=1).to(F32)
    avg_lt = lt.sum(dim=-2, dtype=I32).to(F32) / alive_n[..., None]
    pct = (c.topic_replica_balance_threshold - 1.0) * c.balance_margin
    gap = torch.ceil(avg_lt * pct).to(I32)
    gap = torch.minimum(
        torch.maximum(gap, c.topic_replica_balance_min_gap), c.topic_replica_balance_max_gap
    )
    return torch.floor(avg_lt).to(I32) + gap


def rack_fair_share(
    state: ClusterArrays, snap: Snapshot, partition: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """i32[...]: ceil(RF / alive racks) per given partition id, or of every
    partition (``partition`` None; ``[S, P]`` of a stack) -- relaxed rack
    awareness, RackAwareDistributionGoal."""
    racks_alive = segment_max(state.broker_alive.to(I32), state.broker_rack, state.num_racks, A.lanes_of(state))
    n_racks_avail = torch.clamp(racks_alive.sum(dim=-1, dtype=I32), min=1)
    counts = snap.rack_counts if partition is None else snap.rack_counts[partition]
    rf_p = torch.clamp(counts.sum(dim=-1, dtype=I32), min=1)
    return torch.ceil(rf_p.to(F32) / n_racks_avail[..., None]).to(I32)


def segment_argmax(
    scores: torch.Tensor, seg: torch.Tensor, num_segments: int, eligible: torch.Tensor,
    lanes: Optional[int] = None,
) -> torch.Tensor:
    """i32[S]: index of the max-score eligible element per segment, -1 if none.
    Deterministic: ties break to the lowest index.  With ``lanes`` every
    input is ``[L, n]`` and each lane's segments get the lowest index within
    that lane, ``[L, S]``."""
    s = torch.where(eligible, scores, NEG)
    smax = segment_max(s, seg, num_segments, lanes)
    idx = torch.arange(scores.shape[-1], dtype=I32, device=scores.device)
    # rows with an out-of-range segment drop out of both reductions, so any
    # in-range gather index serves them
    in_range = (seg >= 0) & (seg < num_segments)
    hit = eligible & (s >= A.take(smax, torch.where(in_range, seg, 0), lanes)) & (s > NEG / 2)
    best = segment_min(torch.where(hit, idx, _BIG), seg, num_segments, lanes)
    return torch.where(best < _BIG, best, -1)
