"""Vectorized per-goal action acceptance.

Port of ``cruise_control_tpu/analyzer/acceptance.py`` for all 24 goals: an
action is applied only if every previously optimized goal accepts it
(``Goal.actionAcceptance``, Goal.java:81).  Acceptance comes in three forms,
all reading the pre-round :class:`Snapshot`:

* per-slot kernels over a :class:`MoveBatch` (:func:`accept_all`);
* a ``bool[S, B]`` destination-eligibility matrix for replica moves
  (:func:`move_dst_matrix`) and its swap twin (:func:`swap_dst_matrix`), which
  the proposers consult before choosing a destination;
* a ``bool[R]`` leadership-target mask (:func:`leadership_target_ok`).

Goal masks are numpy bool vectors chosen on the host, so a disabled goal's
term is skipped in Python and builds no ``[slots, B]`` matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.context import (
    GoalContext,
    Snapshot,
    rack_fair_share,
    topic_leader_upper,
)
from cruise_control_tpu_torch.analyzer.kafka_assigner import replica_positions
from cruise_control_tpu_torch.analyzer.moves import (
    KIND_INTRA_MOVE,
    KIND_LEADERSHIP,
    KIND_REPLICA_MOVE,
    KIND_SWAP,
    MoveBatch,
    MoveEffects,
)
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model.arrays import ClusterArrays

I32 = torch.int32


def _on(mask: np.ndarray, gid: int) -> bool:
    return bool(mask[gid])


def _rack_ok_one_direction(state, snap, partition, src_broker, dst_broker):
    """Moving one replica of ``partition`` src->dst keeps rack uniqueness."""
    src_rack = state.broker_rack[src_broker]
    dst_rack = state.broker_rack[dst_broker]
    occupied = snap.rack_counts[partition, dst_rack] - (src_rack == dst_rack).to(I32)
    return occupied == 0


def _ones(moves: MoveBatch) -> torch.Tensor:
    return torch.ones(moves.num_slots, dtype=torch.bool, device=moves.replica.device)


def accept_rack_aware(state, ctx, snap, moves, eff):
    """RackAwareGoal: reject replica moves/swaps into a rack that already hosts
    another replica of the partition."""
    if moves.kind == KIND_LEADERSHIP:
        return _ones(moves)
    fwd = _rack_ok_one_direction(state, snap, eff.partition, eff.src_broker, eff.dst_broker)
    if moves.kind != KIND_SWAP:
        return fwd
    partner = torch.where(moves.dst_replica >= 0, moves.dst_replica, 0)
    p2 = state.replica_partition[partner]
    return fwd & _rack_ok_one_direction(state, snap, p2, eff.dst_broker, eff.src_broker)


def accept_min_topic_leaders(state, ctx, snap, moves, eff):
    """MinTopicLeadersPerBrokerGoal: don't drop a broker's leader count for a
    protected topic below the minimum."""
    if not snap.enable_heavy:
        return _ones(moves)
    topic = state.partition_topic[eff.partition]
    protected = ctx.min_leader_topics[topic]
    loses = eff.leader_delta_src < 0
    after = snap.topic_leader_counts[eff.src_broker, topic] + eff.leader_delta_src
    ok = after >= ctx.constraint.min_topic_leaders_per_broker
    return ~(protected & loses) | ok


def accept_replica_capacity(state, ctx, snap, moves, eff):
    """ReplicaCapacityGoal: destination stays within max replicas per broker."""
    after = snap.replica_counts[eff.dst_broker] + eff.count_delta
    return after <= ctx.constraint.max_replicas_per_broker


def accept_capacity(state, ctx, snap, moves, eff, res: int):
    """CapacityGoal: both endpoints stay under ``capacity_threshold * capacity``;
    load-reducing deltas are always fine."""
    limit = snap.cap_limits[:, res]
    d_dst = eff.delta_dst[:, res]
    dst_after = snap.broker_load[eff.dst_broker, res] + d_dst
    ok_dst = (dst_after <= limit[eff.dst_broker]) | (d_dst <= 0.0)
    d_src = eff.delta_src[:, res]
    src_after = snap.broker_load[eff.src_broker, res] + d_src
    ok_src = (src_after <= limit[eff.src_broker]) | (d_src <= 0.0)
    return ok_dst & ok_src


def accept_potential_nw_out(state, ctx, snap, moves, eff):
    """PotentialNwOutGoal: each endpoint's potential outbound stays within the
    NW_OUT capacity threshold."""
    limit = snap.cap_limits[:, Resource.NW_OUT]
    after = snap.potential_nw_out[eff.dst_broker] + eff.pnw_delta_dst
    ok_dst = (after <= limit[eff.dst_broker]) | (eff.pnw_delta_dst <= 0.0)
    src_delta = -eff.pnw_delta_dst
    src_after = snap.potential_nw_out[eff.src_broker] + src_delta
    ok_src = (src_after <= limit[eff.src_broker]) | (src_delta <= 0.0)
    return ok_dst & ok_src


def accept_replica_count_dist(state, ctx, snap, moves, eff):
    """ReplicaDistributionGoal: destination stays in band or strictly less
    crowded than the source was."""
    upper = snap.replica_band[1]
    dst_after = snap.replica_counts[eff.dst_broker] + eff.count_delta
    src_before = snap.replica_counts[eff.src_broker]
    return (eff.count_delta <= 0) | (dst_after <= upper) | (dst_after <= src_before - 1)


def accept_resource_dist(state, ctx, snap, moves, eff, res: int):
    """ResourceDistributionGoal (ResourceDistributionGoal.java:100-160): if both
    endpoints were inside the band they stay inside; otherwise the destination
    may not end more utilized than the source was.  Swaps check both ways."""
    lower, upper = snap.res_lower, snap.res_upper
    low = snap.low_util[res]
    cap = torch.clamp(state.broker_capacity[:, res], min=1e-9)

    src, dst = eff.src_broker, eff.dst_broker
    src_before = snap.broker_load[src, res]
    dst_before = snap.broker_load[dst, res]
    src_after = src_before + eff.delta_src[:, res]
    dst_after = dst_before + eff.delta_dst[:, res]

    within_before = (src_before >= lower[src, res]) & (dst_before <= upper[dst, res])
    ok_within = (dst_after <= upper[dst, res]) & (src_after >= lower[src, res])
    ok_fallback = dst_after / cap[dst] <= src_before / cap[src]
    no_load = torch.abs(eff.delta_dst[:, res]) <= 0.0
    ok_fwd = low | no_load | torch.where(within_before, ok_within, ok_fallback)

    src_gains = eff.delta_src[:, res] > 0.0
    within_before_b = (dst_before >= lower[dst, res]) & (src_before <= upper[src, res])
    ok_within_b = (src_after <= upper[src, res]) & (dst_after >= lower[dst, res])
    ok_fallback_b = src_after / cap[src] <= dst_before / cap[dst]
    ok_bwd = ~src_gains | low | torch.where(within_before_b, ok_within_b, ok_fallback_b)
    return ok_fwd & ok_bwd


def accept_leader_count_dist(state, ctx, snap, moves, eff):
    """LeaderReplicaDistributionGoal: whichever endpoint gains leaders stays in
    band or below the other endpoint's pre-move count."""
    upper = snap.leader_band[1]
    dst_after = snap.leader_counts[eff.dst_broker] + eff.leader_delta_dst
    src_before = snap.leader_counts[eff.src_broker]
    ok_dst = (eff.leader_delta_dst <= 0) | (dst_after <= upper) | (dst_after <= src_before - 1)
    src_after = snap.leader_counts[eff.src_broker] + eff.leader_delta_src
    dst_before = snap.leader_counts[eff.dst_broker]
    ok_src = (eff.leader_delta_src <= 0) | (src_after <= upper) | (src_after <= dst_before - 1)
    return ok_dst & ok_src


def accept_topic_replica_dist(state, ctx, snap, moves, eff):
    """TopicReplicaDistributionGoal: per-topic destination count stays in band
    or below the source's."""
    if not snap.enable_heavy:
        return _ones(moves)
    bt = snap.topic_counts
    topic = state.partition_topic[eff.partition]
    tup = snap.topic_band[1]
    dst_after = bt[eff.dst_broker, topic] + eff.count_delta
    src_before = bt[eff.src_broker, topic]
    return (eff.count_delta <= 0) | (dst_after <= tup[topic]) | (dst_after <= src_before - 1)


def accept_leader_bytes_in(state, ctx, snap, moves, eff):
    """LeaderBytesInDistributionGoal: the endpoint gaining leader bytes-in stays
    under the upper band or under the other endpoint's pre-move value."""
    after = snap.leader_nw_in[eff.dst_broker] + eff.lbi_delta_dst
    ok_dst = (
        (eff.lbi_delta_dst <= 0.0)
        | (after <= snap.leader_nw_in_upper)
        | (after <= snap.leader_nw_in[eff.src_broker])
    )
    src_delta = -eff.lbi_delta_dst
    src_after = snap.leader_nw_in[eff.src_broker] + src_delta
    ok_src = (
        (src_delta <= 0.0)
        | (src_after <= snap.leader_nw_in_upper)
        | (src_after <= snap.leader_nw_in[eff.dst_broker])
    )
    return ok_dst & ok_src


def accept_preferred_leader(state, ctx, snap, moves, eff):
    """PreferredLeaderElectionGoal: leadership may only transfer to the
    partition's replica-list head while that head lives on an alive broker."""
    if moves.kind != KIND_LEADERSHIP:
        return _ones(moves)
    pref = snap.preferred_leader[eff.partition]
    pref_ok = (pref >= 0) & state.broker_alive[state.replica_broker[torch.clamp(pref, min=0)]]
    return ~pref_ok | (moves.dst_replica == pref)


def _rack_dist_ok(state, snap, partition, src_broker, dst_broker):
    """Moving one replica of ``partition`` src->dst keeps the destination rack
    at or under its fair share, or under the source rack's count."""
    fair = rack_fair_share(state, snap, partition)
    src_rack = state.broker_rack[src_broker]
    dst_rack = state.broker_rack[dst_broker]
    occ_dst = snap.rack_counts[partition, dst_rack] - (src_rack == dst_rack).to(I32)
    occ_src = snap.rack_counts[partition, src_rack]
    return (occ_dst + 1 <= fair) | (occ_dst + 1 <= occ_src - 1)


def accept_rack_aware_dist(state, ctx, snap, moves, eff):
    """RackAwareDistributionGoal: every rack stays at or under its fair share
    ceil(RF / alive racks) of the partition; swaps check both directions."""
    if moves.kind == KIND_LEADERSHIP:
        return _ones(moves)
    fwd = _rack_dist_ok(state, snap, eff.partition, eff.src_broker, eff.dst_broker)
    if moves.kind != KIND_SWAP:
        return fwd
    partner = torch.where(moves.dst_replica >= 0, moves.dst_replica, 0)
    p2 = state.replica_partition[partner]
    return fwd & _rack_dist_ok(state, snap, p2, eff.dst_broker, eff.src_broker)


def accept_broker_set_aware(state, ctx, snap, moves, eff):
    """BrokerSetAwareGoal: replica moves and swaps stay within the topic's
    broker set (topics without one are unconstrained)."""
    if moves.kind == KIND_LEADERSHIP:
        return _ones(moves)
    want = ctx.broker_set_of_topic[state.partition_topic[eff.partition]]
    ok = (want < 0) | (ctx.broker_set_of_broker[eff.dst_broker] == want)
    if moves.kind != KIND_SWAP:
        return ok
    partner = torch.where(moves.dst_replica >= 0, moves.dst_replica, 0)
    want2 = ctx.broker_set_of_topic[state.partition_topic[state.replica_partition[partner]]]
    return ok & ((want2 < 0) | (ctx.broker_set_of_broker[eff.src_broker] == want2))


def accept_topic_leader_dist(state, ctx, snap, moves, eff):
    """TopicLeaderReplicaDistributionGoal: whichever endpoint gains a leader of
    a topic stays within that topic's band or under the other endpoint's count
    (per topic: a swap of two leaders moves one leader of each topic)."""
    if not snap.enable_heavy:
        return _ones(moves)
    kind = moves.kind
    r = torch.where(eff.valid, moves.replica, 0)
    partner = torch.where(moves.dst_replica >= 0, moves.dst_replica, 0)
    t_out = state.partition_topic[eff.partition]
    t_in = state.partition_topic[state.replica_partition[partner]]
    lt = snap.topic_leader_counts
    lt_up = topic_leader_upper(state, ctx, snap)

    # the destination gains a leader of t_out when the moving replica leads,
    # and on every leadership transfer
    dst_gains = _ones(moves) if kind == KIND_LEADERSHIP else snap.is_leader[r]
    after_dst = lt[eff.dst_broker, t_out] + 1
    ok_dst = (after_dst <= lt_up[t_out]) | (after_dst <= lt[eff.src_broker, t_out] - 1)
    ok = ~dst_gains | ok_dst
    if kind != KIND_SWAP:
        return ok
    # the source gains a leader of t_in only when a swap's partner leads
    src_gains = snap.is_leader[partner] & (moves.dst_replica >= 0)
    after_src = lt[eff.src_broker, t_in] + 1
    ok_src = (after_src <= lt_up[t_in]) | (after_src <= lt[eff.dst_broker, t_in] - 1)
    return ok & (~src_gains | ok_src)


def accept_intra_disk_capacity(state, ctx, snap, moves, eff):
    """IntraBrokerDiskCapacityGoal: an intra-broker logdir move lands under the
    destination disk's capacity threshold on a usable disk.  Other kinds touch
    no logdir (an inter-broker move resets it) and pass."""
    if moves.dst_disk is None or state.num_disks == 0:
        return _ones(moves)
    r = torch.where(eff.valid, moves.replica, 0)
    dd = torch.where(moves.dst_disk >= 0, moves.dst_disk, 0)
    after = snap.disk_load[dd] + state.base_load[r, Resource.DISK]
    return (after <= snap.disk_limits[dd]) & snap.disk_usable[dd] | ~eff.valid


def accept_intra_disk_dist(state, ctx, snap, moves, eff):
    """IntraBrokerDiskUsageDistributionGoal: the destination disk stays within
    its broker's band, or under the source disk's pre-move load."""
    if moves.dst_disk is None or state.num_disks == 0:
        return _ones(moves)
    r = torch.where(eff.valid, moves.replica, 0)
    dd = torch.where(moves.dst_disk >= 0, moves.dst_disk, 0)
    sd = torch.clamp(state.replica_disk[r], min=0)
    after = snap.disk_load[dd] + state.base_load[r, Resource.DISK]
    return (after <= snap.disk_upper[dd]) | (after <= snap.disk_load[sd]) | ~eff.valid


def _assigner_even_state(state):
    """(per-position counts i32[PC, B], positions clipped to [0, PC)) read by
    the even-placement terms of every acceptance form."""
    pc = G.assigner_position_counts(state)
    pos = torch.clamp(replica_positions(state), 0, G.ASSIGNER_POS_CAP - 1)
    return pc, pos


def accept_assigner_even(state, ctx, snap, moves, eff):
    """KafkaAssignerEvenRackAwareGoal as a prior goal: rack validity plus
    even placement -- a replica move lands only where the destination stays
    strictly below the source's count at the replica's position; leadership
    transfers and swaps exchange two positions between the endpoints and must
    hold it both ways (same-position exchanges and logdir moves change no
    count)."""
    rack_ok = accept_rack_aware(state, ctx, snap, moves, eff)
    if moves.kind == KIND_INTRA_MOVE:
        return rack_ok
    counts, pos = _assigner_even_state(state)
    q_out = pos[torch.where(moves.replica >= 0, moves.replica, 0)]
    src, dst = eff.src_broker, eff.dst_broker
    fwd = counts[q_out, dst] + 1 <= counts[q_out, src]
    if moves.kind == KIND_REPLICA_MOVE:
        return rack_ok & fwd
    q_in = pos[torch.where(moves.dst_replica >= 0, moves.dst_replica, 0)]
    bwd = counts[q_in, src] + 1 <= counts[q_in, dst]
    return rack_ok & ((fwd & bwd) | (q_out == q_in) | (src == dst))


_KERNELS = {
    G.RACK_AWARE: accept_rack_aware,
    G.MIN_TOPIC_LEADERS: accept_min_topic_leaders,
    G.REPLICA_CAPACITY: accept_replica_capacity,
    G.REPLICA_DISTRIBUTION: accept_replica_count_dist,
    G.POTENTIAL_NW_OUT: accept_potential_nw_out,
    G.TOPIC_REPLICA_DIST: accept_topic_replica_dist,
    G.LEADER_REPLICA_DIST: accept_leader_count_dist,
    G.LEADER_BYTES_IN_DIST: accept_leader_bytes_in,
    G.INTRA_DISK_CAPACITY: accept_intra_disk_capacity,
    G.INTRA_DISK_USAGE_DIST: accept_intra_disk_dist,
    G.PREFERRED_LEADER_ELECTION: accept_preferred_leader,
    G.RACK_AWARE_DISTRIBUTION: accept_rack_aware_dist,
    G.TOPIC_LEADER_DIST: accept_topic_leader_dist,
    G.BROKER_SET_AWARE: accept_broker_set_aware,
    G.KAFKA_ASSIGNER_RACK: accept_assigner_even,
}


def accept_all(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    moves: MoveBatch,
    eff: MoveEffects,
    prior_mask: np.ndarray,
) -> torch.Tensor:
    """bool[K]: every goal enabled in ``prior_mask`` accepts each slot.

    Sharded, the batch carries its candidate-row table (``moves.rows``): the
    kernels then run against the replicated surrogate view with the slot ids
    translated to table positions, touching no sharded tensor."""
    if moves.rows is not None:
        from cruise_control_tpu_torch.analyzer.moves import batch_views

        state, snap, r_ids, rb_ids = batch_views(state, snap, moves)
        moves = dataclasses.replace(
            moves, replica=r_ids, dst_replica=rb_ids, rows=None, view_replica=None, view_dst_replica=None,
        )
    ok = eff.valid
    for gid, fn in _KERNELS.items():
        if _on(prior_mask, gid):
            ok = ok & fn(state, ctx, snap, moves, eff)
    for gid, res in G.CAPACITY_RESOURCE.items():
        if _on(prior_mask, gid):
            ok = ok & accept_capacity(state, ctx, snap, moves, eff, res)
    for gid, res in G.DIST_RESOURCE.items():
        if _on(prior_mask, gid):
            ok = ok & accept_resource_dist(state, ctx, snap, moves, eff, res)
    # the kafka-assigner disk goal shares DiskUsageDistributionGoal's acceptance
    if _on(prior_mask, G.KAFKA_ASSIGNER_DISK):
        ok = ok & accept_resource_dist(state, ctx, snap, moves, eff, Resource.DISK)
    return ok


# ---------------------------------------------------------------------------
# Factorized destination eligibility (per-(slot, destination-broker) matrices).
# ---------------------------------------------------------------------------


def move_dst_matrix(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    cand: torch.Tensor,        # i32[S] candidate replica per slot (clamped)
    cand_valid: torch.Tensor,  # bool[S]
    prior_mask: np.ndarray,    # bool[NUM_GOALS]
    dst_brokers=None,          # i32[M] restricts columns to these broker ids
) -> torch.Tensor:
    """bool[S, B|M]: would every prior goal accept moving ``cand[s]`` to the
    column's broker?  Each prior goal contributes one broadcast comparison."""
    S = cand.shape[0]
    B = state.num_brokers
    db = dst_brokers

    def gb(x):
        return x if db is None else x[db]

    ncols = B if db is None else db.shape[0]
    r = torch.where(cand_valid, cand, 0)
    p = state.replica_partition[r]
    topic = state.partition_topic[p]
    src = state.replica_broker[r]
    eff = snap.eff_load[r]                      # f32[S, 4]
    leads = snap.is_leader[r]

    ok = torch.ones((S, ncols), dtype=torch.bool, device=cand.device)

    if _on(prior_mask, G.RACK_AWARE) or _on(prior_mask, G.RACK_AWARE_DISTRIBUTION) or _on(
        prior_mask, G.KAFKA_ASSIGNER_RACK
    ):
        dst_rack = gb(state.broker_rack)[None, :]
        src_rack = state.broker_rack[src][:, None]
        occ = snap.rack_counts[p][:, gb(state.broker_rack)] - (src_rack == dst_rack).to(I32)
        # RackAwareGoal and the kafka-assigner mode: no other replica in the rack
        if _on(prior_mask, G.RACK_AWARE) or _on(prior_mask, G.KAFKA_ASSIGNER_RACK):
            ok = ok & (occ == 0)
        # RackAwareDistributionGoal: the rack stays within its fair share
        if _on(prior_mask, G.RACK_AWARE_DISTRIBUTION):
            fair = rack_fair_share(state, snap, p)[:, None]
            occ_src = snap.rack_counts[p, state.broker_rack[src]][:, None]
            ok = ok & ((occ + 1 <= fair) | (occ + 1 <= occ_src - 1))

    # the kafka-assigner mode's even half: the destination stays strictly
    # below the source's count at the replica's position
    if _on(prior_mask, G.KAFKA_ASSIGNER_RACK):
        pc, pos_all = _assigner_even_state(state)
        q = pos_all[r]
        c_dst = pc[q] if db is None else pc[q][:, db]
        ok = ok & (c_dst + 1 <= pc[q, src][:, None])

    # BrokerSetAwareGoal: the destination is in the topic's broker set
    if _on(prior_mask, G.BROKER_SET_AWARE):
        want = ctx.broker_set_of_topic[topic][:, None]
        ok = ok & ((want < 0) | (gb(ctx.broker_set_of_broker)[None, :] == want))

    if snap.enable_heavy and _on(prior_mask, G.MIN_TOPIC_LEADERS):
        protected = ctx.min_leader_topics[topic]
        after_src = snap.topic_leader_counts[src, topic] - leads.to(I32)
        mtl_ok = ~(protected & leads) | (after_src >= ctx.constraint.min_topic_leaders_per_broker)
        ok = ok & mtl_ok[:, None]

    counts = snap.replica_counts
    if _on(prior_mask, G.REPLICA_CAPACITY):
        ok = ok & (gb(counts)[None, :] + 1 <= ctx.constraint.max_replicas_per_broker)

    for gid, res in G.CAPACITY_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        ok = ok & (
            gb(snap.broker_load[:, res])[None, :] + eff[:, None, res]
            <= gb(snap.cap_limits[:, res])[None, :]
        )

    if _on(prior_mask, G.REPLICA_DISTRIBUTION):
        upper = snap.replica_band[1]
        dst_after = gb(counts)[None, :] + 1
        ok = ok & ((dst_after <= upper) | (dst_after <= counts[src][:, None] - 1))

    if _on(prior_mask, G.POTENTIAL_NW_OUT):
        leader_nw = (
            state.base_load[r, Resource.NW_OUT] + state.leadership_delta[p, Resource.NW_OUT]
        )
        pnw_after = gb(snap.potential_nw_out)[None, :] + leader_nw[:, None]
        ok = ok & (pnw_after <= gb(snap.cap_limits[:, Resource.NW_OUT])[None, :])

    for gid, res in G.DIST_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        low = snap.low_util[res]
        cap = torch.clamp(state.broker_capacity[:, res], min=1e-9)
        src_before = snap.broker_load[src, res]
        dst_before = gb(snap.broker_load[:, res])[None, :]
        src_after = src_before - eff[:, res]
        dst_after_l = dst_before + eff[:, None, res]
        within_before = (src_before >= snap.res_lower[src, res])[:, None] & (
            dst_before <= gb(snap.res_upper[:, res])[None, :]
        )
        ok_within = (dst_after_l <= gb(snap.res_upper[:, res])[None, :]) & (
            src_after >= snap.res_lower[src, res]
        )[:, None]
        ok_fb = dst_after_l / gb(cap)[None, :] <= (src_before / cap[src])[:, None]
        no_load = (eff[:, res] <= 0.0)[:, None]
        ok = ok & (low | no_load | torch.where(within_before, ok_within, ok_fb))

    if snap.enable_heavy and _on(prior_mask, G.TOPIC_REPLICA_DIST):
        bt = snap.topic_counts
        tup = snap.topic_band[1]
        dst_t_after = gb(bt)[:, topic].T + 1                  # [S, cols]
        ok = ok & ((dst_t_after <= tup[topic][:, None]) | (dst_t_after <= bt[src, topic][:, None] - 1))

    if _on(prior_mask, G.LEADER_REPLICA_DIST):
        lupper = snap.leader_band[1]
        l_after = gb(snap.leader_counts)[None, :] + 1
        ok = ok & ((~leads)[:, None] | (l_after <= lupper) | (
            l_after <= snap.leader_counts[src][:, None] - 1
        ))

    if _on(prior_mask, G.LEADER_BYTES_IN_DIST):
        nw_in = eff[:, Resource.NW_IN]
        lbi_after = gb(snap.leader_nw_in)[None, :] + torch.where(leads, nw_in, 0.0)[:, None]
        ok = ok & ((~leads)[:, None] | (lbi_after <= snap.leader_nw_in_upper) | (
            lbi_after <= snap.leader_nw_in[src][:, None]
        ))

    return ok & cand_valid[:, None]


def leadership_target_ok(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
) -> torch.Tensor:
    """bool[R]: would every prior goal accept transferring its partition's
    leadership TO this replica?  Source-side checks use the partition's current
    leader broker (``snap.leader_broker``)."""
    R = state.num_replicas
    p = state.replica_partition
    topic = state.partition_topic[p]
    b = state.replica_broker
    cur_leader = state.partition_leader[p]
    leader_b = snap.leader_broker[p]
    ldelta = state.leadership_delta[p]          # f32[R, 4]

    ok = torch.ones(R, dtype=torch.bool, device=b.device)

    if snap.enable_heavy and _on(prior_mask, G.MIN_TOPIC_LEADERS):
        protected = ctx.min_leader_topics[topic]
        after_src = snap.topic_leader_counts[leader_b, topic] - 1
        ok = ok & (~protected | (after_src >= ctx.constraint.min_topic_leaders_per_broker))

    for gid, res in G.CAPACITY_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        fits = snap.broker_load[b, res] + ldelta[:, res] <= snap.cap_limits[b, res]
        ok = ok & (fits | (ldelta[:, res] <= 0.0))

    for gid, res in G.DIST_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        low = snap.low_util[res]
        cap = torch.clamp(state.broker_capacity[:, res], min=1e-9)
        src_before = snap.broker_load[leader_b, res]
        dst_before = snap.broker_load[b, res]
        src_after = src_before - ldelta[:, res]
        dst_after = dst_before + ldelta[:, res]
        within_before = (src_before >= snap.res_lower[leader_b, res]) & (
            dst_before <= snap.res_upper[b, res]
        )
        ok_within = (dst_after <= snap.res_upper[b, res]) & (
            src_after >= snap.res_lower[leader_b, res]
        )
        ok_fb = dst_after / cap[b] <= src_before / cap[leader_b]
        ok = ok & (low | (ldelta[:, res] <= 0.0) | torch.where(within_before, ok_within, ok_fb))

    if _on(prior_mask, G.LEADER_REPLICA_DIST):
        l_after = snap.leader_counts[b] + 1
        ok = ok & ((l_after <= snap.leader_band[1]) | (l_after <= snap.leader_counts[leader_b] - 1))

    if _on(prior_mask, G.LEADER_BYTES_IN_DIST):
        nw_in = snap.eff_load[:, Resource.NW_IN]
        lbi_after = snap.leader_nw_in[b] + nw_in
        ok = ok & ((lbi_after <= snap.leader_nw_in_upper) | (lbi_after <= snap.leader_nw_in[leader_b]))

    # PreferredLeaderElectionGoal: only the replica-list head takes leadership
    if _on(prior_mask, G.PREFERRED_LEADER_ELECTION):
        pref = snap.preferred_leader[p]
        pref_alive = (pref >= 0) & state.broker_alive[state.replica_broker[torch.clamp(pref, min=0)]]
        ok = ok & (~pref_alive | (torch.arange(R, dtype=I32, device=b.device) == pref))

    # TopicLeaderReplicaDistributionGoal: the gaining broker stays in its band
    if snap.enable_heavy and _on(prior_mask, G.TOPIC_LEADER_DIST):
        lt = snap.topic_leader_counts
        lt_up = topic_leader_upper(state, ctx, snap)
        after = lt[b, topic] + 1
        ok = ok & ((after <= lt_up[topic]) | (after <= lt[leader_b, topic] - 1))

    # the kafka-assigner mode: a transfer exchanges position 0 and the target's
    # position between the two brokers, so both must keep the gaining broker
    # strictly below the losing one (same-broker transfers change no count)
    if _on(prior_mask, G.KAFKA_ASSIGNER_RACK):
        pc, q = _assigner_even_state(state)
        ok = ok & ((
            (pc[0, b] + 1 <= pc[0, leader_b]) & (pc[q, leader_b] + 1 <= pc[q, b])
        ) | (q == 0) | (b == leader_b))

    return ok & state.replica_valid & (cur_leader >= 0)


def swap_dst_matrix(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    cand: torch.Tensor,           # i32[S] outgoing replica per slot (clamped)
    cand_valid: torch.Tensor,     # bool[S]
    partner: torch.Tensor,        # i32[B|M] incoming partner replica per dst (clamped)
    partner_valid: torch.Tensor,  # bool[B|M]
    prior_mask: np.ndarray,
    dst_brokers=None,             # i32[M] restricts columns to these broker ids
) -> torch.Tensor:
    """bool[S, B|M]: would every prior goal accept swapping ``cand[s]`` with
    the column broker's ``partner``?  Threshold goals see the swap's net
    deltas; replica counts never change in a swap.  ``dst_brokers``
    restricts the columns (the sharded solver's column slice); the caller
    then passes ``partner`` / ``partner_valid`` restricted to them."""
    S = cand.shape[0]
    B = state.num_brokers
    db = dst_brokers

    def gb(x):
        return x if db is None else x[db]

    col_ids = torch.arange(B, dtype=I32, device=cand.device) if db is None else db
    ncols = col_ids.shape[0]
    r = torch.where(cand_valid, cand, 0)
    q = torch.where(partner_valid, partner, 0)
    p_out = state.replica_partition[r]
    p_in = state.replica_partition[q]
    src = state.replica_broker[r]
    e_out = snap.eff_load[r]           # [S, 4]
    e_in = snap.eff_load[q]            # [cols, 4]
    leads_out = snap.is_leader[r]      # [S]
    leads_in = snap.is_leader[q]       # [cols]
    t_out = state.partition_topic[p_out]
    t_in = state.partition_topic[p_in]

    ok = torch.ones((S, ncols), dtype=torch.bool, device=cand.device)

    if _on(prior_mask, G.RACK_AWARE) or _on(prior_mask, G.KAFKA_ASSIGNER_RACK):
        dst_rack = gb(state.broker_rack)[None, :]
        src_rack = state.broker_rack[src][:, None]
        occ_fwd = snap.rack_counts[p_out][:, gb(state.broker_rack)] - (src_rack == dst_rack).to(I32)
        # occ_bwd[s, d] = replicas of partner[d]'s partition in slot s's source rack
        occ_bwd = snap.rack_counts[p_in][:, state.broker_rack[src]].T - (dst_rack == src_rack).to(I32)
        ok = ok & (occ_fwd == 0) & (occ_bwd == 0)

    # the kafka-assigner mode's even half: a swap exchanges the two replicas'
    # positions between the endpoints; unless the positions match, both
    # directions keep the gaining broker strictly below the losing one
    if _on(prior_mask, G.KAFKA_ASSIGNER_RACK):
        pc, pos_all = _assigner_even_state(state)
        q_out = pos_all[r]                              # [S]
        q_in = pos_all[q]                               # [cols]
        c_out_d = pc[q_out] if db is None else pc[q_out][:, db]
        fwd = c_out_d + 1 <= pc[q_out, src][:, None]  # counts[q_out_s, d] vs counts[q_out_s, src_s]
        bwd = pc[q_in][:, src].T + 1 <= pc[q_in, col_ids][None, :]
        same_pos = q_out[:, None] == q_in[None, :]
        same_broker = src[:, None] == col_ids[None, :]
        ok = ok & (same_pos | same_broker | (fwd & bwd))

    if snap.enable_heavy and _on(prior_mask, G.MIN_TOPIC_LEADERS):
        min_l = ctx.constraint.min_topic_leaders_per_broker
        prot_out = ctx.min_leader_topics[t_out]
        src_ok = ~(prot_out & leads_out) | (snap.topic_leader_counts[src, t_out] - 1 >= min_l)
        prot_in = ctx.min_leader_topics[t_in]
        dst_ok = ~(prot_in & leads_in) | (snap.topic_leader_counts[col_ids, t_in] - 1 >= min_l)
        ok = ok & src_ok[:, None] & dst_ok[None, :]

    for gid, res in G.CAPACITY_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        net = e_out[:, None, res] - e_in[None, :, res]      # dst gains this
        after = gb(snap.broker_load)[None, :, res] + net
        fits = (after <= gb(snap.cap_limits)[None, :, res]) | (net <= 0.0)
        src_after = snap.broker_load[src, res][:, None] - net
        src_fits = (src_after <= snap.cap_limits[src, res][:, None]) | (net >= 0.0)
        ok = ok & fits & src_fits

    for gid, res in G.DIST_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        low = snap.low_util[res]
        cap = torch.clamp(state.broker_capacity[:, res], min=1e-9)
        net = e_out[:, None, res] - e_in[None, :, res]
        src_before = snap.broker_load[src, res][:, None]
        dst_before = gb(snap.broker_load[:, res])[None, :]
        src_after = src_before - net
        dst_after = dst_before + net
        within_before = (src_before >= snap.res_lower[src, res][:, None]) & (
            dst_before <= gb(snap.res_upper)[None, :, res]
        )
        ok_within = (dst_after <= gb(snap.res_upper)[None, :, res]) & (
            src_after >= snap.res_lower[src, res][:, None]
        )
        ok_fb = dst_after / gb(cap)[None, :] <= src_before / cap[src][:, None]
        ok = ok & (low | (net <= 0.0) | torch.where(within_before, ok_within, ok_fb))

    if _on(prior_mask, G.POTENTIAL_NW_OUT):
        lnw_out = state.base_load[r, Resource.NW_OUT] + state.leadership_delta[p_out, Resource.NW_OUT]
        lnw_in = state.base_load[q, Resource.NW_OUT] + state.leadership_delta[p_in, Resource.NW_OUT]
        pnw_net = lnw_out[:, None] - lnw_in[None, :]
        pnw_after = gb(snap.potential_nw_out)[None, :] + pnw_net
        ok = ok & ((pnw_after <= gb(snap.cap_limits)[None, :, Resource.NW_OUT]) | (pnw_net <= 0.0))

    if _on(prior_mask, G.LEADER_REPLICA_DIST):
        net_lead = leads_out.to(I32)[:, None] - leads_in.to(I32)[None, :]
        l_after = gb(snap.leader_counts)[None, :] + net_lead
        ok = ok & ((net_lead <= 0) | (l_after <= snap.leader_band[1]) | (
            l_after <= snap.leader_counts[src][:, None] - 1
        ))

    if _on(prior_mask, G.LEADER_BYTES_IN_DIST):
        lbi_out = torch.where(leads_out, e_out[:, Resource.NW_IN], 0.0)
        lbi_in = torch.where(leads_in, e_in[:, Resource.NW_IN], 0.0)
        lbi_net = lbi_out[:, None] - lbi_in[None, :]
        lbi_after = gb(snap.leader_nw_in)[None, :] + lbi_net
        ok = ok & ((lbi_net <= 0.0) | (lbi_after <= snap.leader_nw_in_upper) | (
            lbi_after <= snap.leader_nw_in[src][:, None]
        ))

    return ok & cand_valid[:, None] & partner_valid[None, :]
