"""Vectorized per-goal action acceptance.

Port of ``cruise_control_tpu/analyzer/acceptance.py`` for the default goals:
an action is applied only if every previously optimized goal accepts it
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

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.context import GoalContext, Snapshot
from cruise_control_tpu_torch.analyzer.moves import (
    KIND_LEADERSHIP,
    KIND_SWAP,
    MoveBatch,
    MoveEffects,
)
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model.arrays import ClusterArrays

I32 = torch.int32


def _on(mask: np.ndarray, gid: int) -> bool:
    return bool(mask[gid])


def _check_mask(mask: np.ndarray) -> None:
    G.check_supported([g for g in range(G.NUM_GOALS) if mask[g]])


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


_KERNELS = {
    G.RACK_AWARE: accept_rack_aware,
    G.MIN_TOPIC_LEADERS: accept_min_topic_leaders,
    G.REPLICA_CAPACITY: accept_replica_capacity,
    G.REPLICA_DISTRIBUTION: accept_replica_count_dist,
    G.POTENTIAL_NW_OUT: accept_potential_nw_out,
    G.TOPIC_REPLICA_DIST: accept_topic_replica_dist,
    G.LEADER_REPLICA_DIST: accept_leader_count_dist,
    G.LEADER_BYTES_IN_DIST: accept_leader_bytes_in,
}


def accept_all(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    moves: MoveBatch,
    eff: MoveEffects,
    prior_mask: np.ndarray,
) -> torch.Tensor:
    """bool[K]: every goal enabled in ``prior_mask`` accepts each slot."""
    _check_mask(prior_mask)
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
    _check_mask(prior_mask)
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

    if _on(prior_mask, G.RACK_AWARE):
        dst_rack = gb(state.broker_rack)[None, :]
        src_rack = state.broker_rack[src][:, None]
        occ = snap.rack_counts[p][:, gb(state.broker_rack)] - (src_rack == dst_rack).to(I32)
        ok &= occ == 0

    if snap.enable_heavy and _on(prior_mask, G.MIN_TOPIC_LEADERS):
        protected = ctx.min_leader_topics[topic]
        after_src = snap.topic_leader_counts[src, topic] - leads.to(I32)
        mtl_ok = ~(protected & leads) | (after_src >= ctx.constraint.min_topic_leaders_per_broker)
        ok &= mtl_ok[:, None]

    counts = snap.replica_counts
    if _on(prior_mask, G.REPLICA_CAPACITY):
        ok &= (gb(counts)[None, :] + 1 <= ctx.constraint.max_replicas_per_broker)

    for gid, res in G.CAPACITY_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        ok &= (
            gb(snap.broker_load[:, res])[None, :] + eff[:, None, res]
            <= gb(snap.cap_limits[:, res])[None, :]
        )

    if _on(prior_mask, G.REPLICA_DISTRIBUTION):
        upper = snap.replica_band[1]
        dst_after = gb(counts)[None, :] + 1
        ok &= (dst_after <= upper) | (dst_after <= counts[src][:, None] - 1)

    if _on(prior_mask, G.POTENTIAL_NW_OUT):
        leader_nw = (
            state.base_load[r, Resource.NW_OUT] + state.leadership_delta[p, Resource.NW_OUT]
        )
        pnw_after = gb(snap.potential_nw_out)[None, :] + leader_nw[:, None]
        ok &= pnw_after <= gb(snap.cap_limits[:, Resource.NW_OUT])[None, :]

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
        ok &= low | no_load | torch.where(within_before, ok_within, ok_fb)

    if snap.enable_heavy and _on(prior_mask, G.TOPIC_REPLICA_DIST):
        bt = snap.topic_counts
        tup = snap.topic_band[1]
        dst_t_after = gb(bt)[:, topic].T + 1                  # [S, cols]
        ok &= (dst_t_after <= tup[topic][:, None]) | (dst_t_after <= bt[src, topic][:, None] - 1)

    if _on(prior_mask, G.LEADER_REPLICA_DIST):
        lupper = snap.leader_band[1]
        l_after = gb(snap.leader_counts)[None, :] + 1
        ok &= (~leads)[:, None] | (l_after <= lupper) | (
            l_after <= snap.leader_counts[src][:, None] - 1
        )

    if _on(prior_mask, G.LEADER_BYTES_IN_DIST):
        nw_in = eff[:, Resource.NW_IN]
        lbi_after = gb(snap.leader_nw_in)[None, :] + torch.where(leads, nw_in, 0.0)[:, None]
        ok &= (~leads)[:, None] | (lbi_after <= snap.leader_nw_in_upper) | (
            lbi_after <= snap.leader_nw_in[src][:, None]
        )

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
    _check_mask(prior_mask)
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
        ok &= ~protected | (after_src >= ctx.constraint.min_topic_leaders_per_broker)

    for gid, res in G.CAPACITY_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        fits = snap.broker_load[b, res] + ldelta[:, res] <= snap.cap_limits[b, res]
        ok &= fits | (ldelta[:, res] <= 0.0)

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
        ok &= low | (ldelta[:, res] <= 0.0) | torch.where(within_before, ok_within, ok_fb)

    if _on(prior_mask, G.LEADER_REPLICA_DIST):
        l_after = snap.leader_counts[b] + 1
        ok &= (l_after <= snap.leader_band[1]) | (l_after <= snap.leader_counts[leader_b] - 1)

    if _on(prior_mask, G.LEADER_BYTES_IN_DIST):
        nw_in = snap.eff_load[:, Resource.NW_IN]
        lbi_after = snap.leader_nw_in[b] + nw_in
        ok &= (lbi_after <= snap.leader_nw_in_upper) | (lbi_after <= snap.leader_nw_in[leader_b])

    return ok & state.replica_valid & (cur_leader >= 0)


def swap_dst_matrix(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    cand: torch.Tensor,           # i32[S] outgoing replica per slot (clamped)
    cand_valid: torch.Tensor,     # bool[S]
    partner: torch.Tensor,        # i32[B] incoming partner replica per dst (clamped)
    partner_valid: torch.Tensor,  # bool[B]
    prior_mask: np.ndarray,
) -> torch.Tensor:
    """bool[S, B]: would every prior goal accept swapping ``cand[s]`` with the
    column broker's ``partner``?  Threshold goals see the swap's net deltas;
    replica counts never change in a swap."""
    _check_mask(prior_mask)
    S = cand.shape[0]
    B = state.num_brokers
    col_ids = torch.arange(B, dtype=I32, device=cand.device)
    r = torch.where(cand_valid, cand, 0)
    q = torch.where(partner_valid, partner, 0)
    p_out = state.replica_partition[r]
    p_in = state.replica_partition[q]
    src = state.replica_broker[r]
    e_out = snap.eff_load[r]           # [S, 4]
    e_in = snap.eff_load[q]            # [B, 4]
    leads_out = snap.is_leader[r]      # [S]
    leads_in = snap.is_leader[q]       # [B]
    t_out = state.partition_topic[p_out]
    t_in = state.partition_topic[p_in]

    ok = torch.ones((S, B), dtype=torch.bool, device=cand.device)

    if _on(prior_mask, G.RACK_AWARE):
        dst_rack = state.broker_rack[None, :]
        src_rack = state.broker_rack[src][:, None]
        occ_fwd = snap.rack_counts[p_out][:, state.broker_rack] - (src_rack == dst_rack).to(I32)
        # occ_bwd[s, d] = replicas of partner[d]'s partition in slot s's source rack
        occ_bwd = snap.rack_counts[p_in][:, state.broker_rack[src]].T - (dst_rack == src_rack).to(I32)
        ok &= (occ_fwd == 0) & (occ_bwd == 0)

    if snap.enable_heavy and _on(prior_mask, G.MIN_TOPIC_LEADERS):
        min_l = ctx.constraint.min_topic_leaders_per_broker
        prot_out = ctx.min_leader_topics[t_out]
        src_ok = ~(prot_out & leads_out) | (snap.topic_leader_counts[src, t_out] - 1 >= min_l)
        prot_in = ctx.min_leader_topics[t_in]
        dst_ok = ~(prot_in & leads_in) | (snap.topic_leader_counts[col_ids, t_in] - 1 >= min_l)
        ok &= src_ok[:, None] & dst_ok[None, :]

    for gid, res in G.CAPACITY_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        net = e_out[:, None, res] - e_in[None, :, res]      # dst gains this
        after = snap.broker_load[None, :, res] + net
        fits = (after <= snap.cap_limits[None, :, res]) | (net <= 0.0)
        src_after = snap.broker_load[src, res][:, None] - net
        src_fits = (src_after <= snap.cap_limits[src, res][:, None]) | (net >= 0.0)
        ok &= fits & src_fits

    for gid, res in G.DIST_RESOURCE.items():
        if not _on(prior_mask, gid):
            continue
        low = snap.low_util[res]
        cap = torch.clamp(state.broker_capacity[:, res], min=1e-9)
        net = e_out[:, None, res] - e_in[None, :, res]
        src_before = snap.broker_load[src, res][:, None]
        dst_before = snap.broker_load[:, res][None, :]
        src_after = src_before - net
        dst_after = dst_before + net
        within_before = (src_before >= snap.res_lower[src, res][:, None]) & (
            dst_before <= snap.res_upper[None, :, res]
        )
        ok_within = (dst_after <= snap.res_upper[None, :, res]) & (
            src_after >= snap.res_lower[src, res][:, None]
        )
        ok_fb = dst_after / cap[None, :] <= src_before / cap[src][:, None]
        ok &= low | (net <= 0.0) | torch.where(within_before, ok_within, ok_fb)

    if _on(prior_mask, G.POTENTIAL_NW_OUT):
        lnw_out = state.base_load[r, Resource.NW_OUT] + state.leadership_delta[p_out, Resource.NW_OUT]
        lnw_in = state.base_load[q, Resource.NW_OUT] + state.leadership_delta[p_in, Resource.NW_OUT]
        pnw_net = lnw_out[:, None] - lnw_in[None, :]
        pnw_after = snap.potential_nw_out[None, :] + pnw_net
        ok &= (pnw_after <= snap.cap_limits[None, :, Resource.NW_OUT]) | (pnw_net <= 0.0)

    if _on(prior_mask, G.LEADER_REPLICA_DIST):
        net_lead = leads_out.to(I32)[:, None] - leads_in.to(I32)[None, :]
        l_after = snap.leader_counts[None, :] + net_lead
        ok &= (net_lead <= 0) | (l_after <= snap.leader_band[1]) | (
            l_after <= snap.leader_counts[src][:, None] - 1
        )

    if _on(prior_mask, G.LEADER_BYTES_IN_DIST):
        lbi_out = torch.where(leads_out, e_out[:, Resource.NW_IN], 0.0)
        lbi_in = torch.where(leads_in, e_in[:, Resource.NW_IN], 0.0)
        lbi_net = lbi_out[:, None] - lbi_in[None, :]
        lbi_after = snap.leader_nw_in[None, :] + lbi_net
        ok &= (lbi_net <= 0.0) | (lbi_after <= snap.leader_nw_in_upper) | (
            lbi_after <= snap.leader_nw_in[src][:, None]
        )

    return ok & cand_valid[:, None] & partner_valid[None, :]
