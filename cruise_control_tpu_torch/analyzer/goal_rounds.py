"""Per-goal round functions: each default goal's ``rebalanceForBroker`` as
batched tensor rounds.

Port of ``cruise_control_tpu/analyzer/goal_rounds.py`` for all 24 goal ids plus
the offline-repair pre-phase (the kafka-assigner goal's placement itself is
:mod:`.kafka_assigner`; its rounds here keep the rack rule afterwards).  :data:`GOAL_ROUNDS` maps a goal id to an ordered
tuple of round functions ``(state, ctx, snap, prior_mask, salt) -> MoveBatch``;
the optimizer drives each round type to convergence in order (leadership
before replica moves, as ResourceDistributionGoal.java:380 phases them).
Round functions only propose; the optimizer layers acceptance and admission.

Sharded solver (``snap.spmd`` set): the per-replica score and eligibility
tensors handed to the proposers are this rank's rows; the ``dst_fn`` /
``fit_fn`` / ``gain_fn`` closures receive the merged view ``(vs, vsnap,
cand, ...)`` and derive every per-replica value from it (broker, partition
and disk tensors -- bands, limits, merged counts -- may be captured: they
are replicated).  ``cols`` is this rank's destination-column slice
(``None`` single-device).  ``src_need`` / ``dst_need`` are replicated: pure
functions of merged snapshot fields, or one :func:`parallel.spmd.spmd_segment_sum`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.acceptance import leadership_target_ok
from cruise_control_tpu_torch.analyzer.context import rack_fair_share, topic_leader_upper
from cruise_control_tpu_torch.analyzer.moves import KIND_LEADERSHIP, MoveBatch
from cruise_control_tpu_torch.analyzer.proposers import (
    fill_round,
    intra_disk_round,
    leadership_fill_round,
    leadership_shed_round,
    shed_round,
    swap_round,
    topk_segment_argmax,
)
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.parallel.spmd import spmd_segment_sum

RoundFn = Callable[..., MoveBatch]

NEG = -3e38
I32 = torch.int32
F32 = torch.float32


def _counts_f(snap) -> torch.Tensor:
    return snap.replica_counts.to(F32)


def _bcast(row: torch.Tensor, n: int) -> torch.Tensor:
    """[B] -> [n, B] broadcast view."""
    return row[None, :].expand(n, row.shape[0])


def _c(x: torch.Tensor, cols) -> torch.Tensor:
    """Restrict a destination-broker-axis tensor to the rank's column slice
    ``cols`` (``None`` single-device: the tensor passes through)."""
    return x if cols is None else x[cols]


def _zeros_r(state) -> torch.Tensor:
    return torch.zeros(state.num_replicas, dtype=F32, device=state.device)


# -- offline repair (pre-phase) ----------------------------------------------------


def offline_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """Move replicas off dead brokers/disks to rack-safe destinations under
    every capacity limit."""

    def dst_fn(vs, vsnap, cand, cols=None):
        p = vs.replica_partition[cand]
        src_rack = vs.broker_rack[vs.replica_broker[cand]]
        dst_rack = _c(vs.broker_rack, cols)
        occ = vsnap.rack_counts[p][:, dst_rack]
        occ = occ - (src_rack[:, None] == dst_rack[None, :]).to(I32)
        rack_ok = occ == 0
        load_after = _c(vsnap.broker_load, cols)[None, :, :] + vsnap.eff_load[cand][:, None, :]
        fits = torch.all(load_after <= _c(vsnap.cap_limits, cols)[None, :, :], dim=-1)
        count_ok = _c(vsnap.replica_counts + 1 <= ctx.constraint.max_replicas_per_broker, cols)[None, :]
        score = _bcast(_c(-vsnap.util_pct.amax(dim=-1), cols), cand.shape[0])
        return rack_ok & fits & count_ok, score

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=snap.offline_per_broker,
        cand_score=_zeros_r(state),
        cand_ok=snap.offline,
        dst_fn=dst_fn,
    )


def offline_round_relaxed(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """Fallback offline repair needing only an alive destination without a
    replica of the partition."""

    def dst_fn(vs, vsnap, cand, cols=None):
        score = _bcast(_c(-vsnap.util_pct.amax(dim=-1), cols), cand.shape[0])
        return torch.ones(score.shape, dtype=torch.bool, device=score.device), score

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=snap.offline_per_broker,
        cand_score=_zeros_r(state),
        cand_ok=snap.offline,
        dst_fn=dst_fn,
    )


# -- RackAwareGoal ------------------------------------------------------------------


def rack_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    viol = G.rack_violating_replicas(state, snap)

    def dst_fn(vs, vsnap, cand, cols=None):
        p = vs.replica_partition[cand]
        src_rack = vs.broker_rack[vs.replica_broker[cand]]
        dst_rack = _c(vs.broker_rack, cols)
        occ = vsnap.rack_counts[p][:, dst_rack]
        occ = occ - (src_rack[:, None] == dst_rack[None, :]).to(I32)
        return occ == 0, _bcast(_c(-_counts_f(vsnap), cols), cand.shape[0])

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=snap.rack_viol_need,
        cand_score=_zeros_r(state),
        cand_ok=viol & (snap.movable | snap.offline),
        dst_fn=dst_fn,
    )


# -- ReplicaCapacityGoal ------------------------------------------------------------


def replica_capacity_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    max_r = ctx.constraint.max_replicas_per_broker
    src_need = (snap.replica_counts - max_r).to(F32)

    def dst_fn(vs, vsnap, cand, cols=None):
        ok = _bcast(_c(vsnap.replica_counts + 1 <= max_r, cols), cand.shape[0])
        return ok, _bcast(_c(-_counts_f(vsnap), cols), cand.shape[0])

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        cand_score=-snap.eff_load[:, Resource.DISK],  # cheapest moves first
        cand_ok=snap.movable,
        dst_fn=dst_fn,
    )


# -- CapacityGoal family --------------------------------------------------------------


def _capacity_leadership_round(res: int) -> RoundFn:
    def fn(state, ctx, snap, prior_mask, salt):
        limit = snap.cap_limits[:, res]
        src_need = snap.broker_load[:, res] - limit
        ldelta = state.leadership_delta[state.replica_partition, res]
        fb = state.replica_broker
        fits = snap.broker_load[fb, res] + ldelta <= limit[fb]
        return leadership_shed_round(
            state, ctx, snap, prior_mask, salt,
            src_need=src_need,
            leader_score=ldelta,
            leader_ok=snap.movable,
            follower_score=-snap.util_pct[fb, res],
            follower_ok=fits & (ldelta > 0),
        )

    return fn


def _capacity_move_round(res: int) -> RoundFn:
    def fn(state, ctx, snap, prior_mask, salt):
        limit = snap.cap_limits[:, res]
        src_need = snap.broker_load[:, res] - limit
        headroom = torch.where(snap.dest_ok, limit - snap.broker_load[:, res], NEG)
        max_headroom = torch.max(headroom)
        load = snap.eff_load[:, res]

        def dst_fn(vs, vsnap, cand, cols=None):
            cload = vsnap.eff_load[cand, res]
            n = cand.shape[0]
            fits = _bcast(_c(vsnap.broker_load[:, res], cols), n) + cload[:, None] <= _bcast(_c(limit, cols), n)
            return fits, _bcast(_c(-vsnap.util_pct[:, res], cols), n)

        return shed_round(
            state, ctx, snap, prior_mask, salt,
            src_need=src_need,
            cand_score=load,
            cand_ok=snap.movable & (load <= max_headroom) & (load > 0),
            dst_fn=dst_fn,
        )

    return fn


# -- ReplicaDistributionGoal --------------------------------------------------------


def replica_dist_shed(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    up = snap.replica_band[1]
    src_need = (snap.replica_counts - up).to(F32)

    def dst_fn(vs, vsnap, cand, cols=None):
        ok = _bcast(_c(vsnap.replica_counts + 1 <= up, cols), cand.shape[0])
        return ok, _bcast(_c(-_counts_f(vsnap), cols), cand.shape[0])

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        cand_score=-snap.eff_load[:, Resource.DISK],
        cand_ok=snap.movable,
        dst_fn=dst_fn,
    )


def replica_dist_relieve(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """Swap disk headroom onto under-band brokers pinned at the disk capacity
    limit so the next pass's fill can land (a count-neutral swap is the one
    move that helps when every inbound move is vetoed by DiskCapacityGoal and
    every outbound move would leave the band).  Sources: under-band brokers
    above 95% of their disk limit; gain = net disk shed."""
    lo = snap.replica_band[0]
    counts = snap.replica_counts
    disk_frac = (
        snap.broker_load[:, Resource.DISK]
        / torch.clamp(snap.cap_limits[:, Resource.DISK], min=1e-9)
    )
    src_need = torch.where(counts < lo, torch.clamp(disk_frac - 0.95, min=0.0), 0.0).to(F32)
    eff_disk = snap.eff_load[:, Resource.DISK]
    # a swap must free at least 0.1% of the source's limit, or the phase grinds
    # near-zero-gain swaps until its round cap
    min_gain = 1e-3 * snap.cap_limits[:, Resource.DISK]

    def gain_fn(vs, vsnap, r_out, partner, cols=None):
        e_out = vsnap.eff_load[r_out, Resource.DISK]
        e_in = vsnap.eff_load[partner, Resource.DISK]
        net = e_out[:, None] - e_in[None, :]
        src = vs.replica_broker[r_out]
        # heavy replicas land on count-healthy brokers only
        return (net > min_gain[src][:, None]) & _c(counts >= lo, cols)[None, :], net

    return swap_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        out_score=eff_disk,
        out_ok=snap.movable,
        in_score=-eff_disk,
        in_ok=snap.movable,
        gain_fn=gain_fn,
    )


def replica_dist_fill(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    lo = snap.replica_band[0]
    dst_need = (lo - snap.replica_counts).to(F32)
    donor_keeps = snap.replica_counts[state.replica_broker] - 1 >= lo

    def fit_fn(vs, vsnap, cand, rows):
        donor_counts = vsnap.replica_counts[vs.replica_broker[cand]]
        dst_counts = vsnap.replica_counts if rows is None else vsnap.replica_counts[rows]
        improves = donor_counts[None, :] >= dst_counts[:, None] + 2
        return improves, _bcast(donor_counts.to(F32), dst_counts.shape[0])

    return fill_round(
        state, ctx, snap, prior_mask, salt,
        dst_need=dst_need,
        donor_score=-snap.eff_load[:, Resource.DISK],
        donor_ok=snap.movable & donor_keeps,
        fit_fn=fit_fn,
    )


# -- PotentialNwOutGoal -------------------------------------------------------------


def potential_nw_out_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    limit = snap.cap_limits[:, Resource.NW_OUT]
    src_need = snap.potential_nw_out - limit
    leader_nw = (
        state.base_load[:, Resource.NW_OUT]
        + state.leadership_delta[state.replica_partition, Resource.NW_OUT]
    )
    headroom = torch.where(snap.dest_ok, limit - snap.potential_nw_out, NEG)
    max_headroom = torch.max(headroom)

    def dst_fn(vs, vsnap, cand, cols=None):
        lnw = (
            vs.base_load[cand, Resource.NW_OUT]
            + vs.leadership_delta[vs.replica_partition[cand], Resource.NW_OUT]
        )
        n = cand.shape[0]
        fits = _bcast(_c(vsnap.potential_nw_out, cols), n) + lnw[:, None] <= _bcast(_c(limit, cols), n)
        cap = torch.clamp(vs.broker_capacity[:, Resource.NW_OUT], min=1e-9)
        return fits, _bcast(_c(-(vsnap.potential_nw_out / cap), cols), n)

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        cand_score=leader_nw,
        cand_ok=snap.movable & (leader_nw <= max_headroom),
        dst_fn=dst_fn,
    )


# -- ResourceDistributionGoal family ------------------------------------------------


def _dist_leadership_round(res: int) -> RoundFn:
    def fn(state, ctx, snap, prior_mask, salt):
        upper = snap.res_upper[:, res]
        src_need = torch.where(snap.low_util[res], 0.0, snap.broker_load[:, res] - upper)
        ldelta = state.leadership_delta[state.replica_partition, res]
        fb = state.replica_broker
        fits = snap.broker_load[fb, res] + ldelta <= upper[fb]
        return leadership_shed_round(
            state, ctx, snap, prior_mask, salt,
            src_need=src_need,
            leader_score=ldelta,
            leader_ok=snap.movable,
            follower_score=-snap.util_pct[fb, res],
            follower_ok=fits & (ldelta > 0),
        )

    return fn


def _dist_shed_round(res: int) -> RoundFn:
    def fn(state, ctx, snap, prior_mask, salt):
        lower, upper = snap.res_lower[:, res], snap.res_upper[:, res]
        src_need = torch.where(snap.low_util[res], 0.0, snap.broker_load[:, res] - upper)
        load = snap.eff_load[:, res]
        src_b = state.replica_broker
        keeps_src = load <= snap.broker_load[src_b, res] - lower[src_b]
        headroom = torch.where(snap.dest_ok, upper - snap.broker_load[:, res], NEG)
        max_headroom = torch.max(headroom)

        def dst_fn(vs, vsnap, cand, cols=None):
            cload = vsnap.eff_load[cand, res]
            n = cand.shape[0]
            fits = _bcast(_c(vsnap.broker_load[:, res], cols), n) + cload[:, None] <= _bcast(_c(upper, cols), n)
            return fits, _bcast(_c(-vsnap.util_pct[:, res], cols), n)

        return shed_round(
            state, ctx, snap, prior_mask, salt,
            src_need=src_need,
            cand_score=load,
            cand_ok=snap.movable & keeps_src & (load > 0) & (load <= max_headroom),
            dst_fn=dst_fn,
        )

    return fn


def _dist_fill_round(res: int) -> RoundFn:
    def fn(state, ctx, snap, prior_mask, salt):
        lower, upper = snap.res_lower[:, res], snap.res_upper[:, res]
        dst_need = torch.where(snap.low_util[res], 0.0, lower - snap.broker_load[:, res])
        load = snap.eff_load[:, res]
        src_b = state.replica_broker
        donor_keeps = load <= snap.broker_load[src_b, res] - lower[src_b]

        def fit_fn(vs, vsnap, cand, rows):
            dst_load = vsnap.broker_load[:, res] if rows is None else vsnap.broker_load[rows, res]
            dst_upper = upper if rows is None else upper[rows]
            cload = vsnap.eff_load[cand, res]
            fits = dst_load[:, None] + cload[None, :] <= dst_upper[:, None]
            src_score = _bcast(vsnap.util_pct[vs.replica_broker[cand], res], dst_load.shape[0])
            return fits, src_score

        return fill_round(
            state, ctx, snap, prior_mask, salt,
            dst_need=dst_need,
            donor_score=load,
            donor_ok=snap.movable & donor_keeps & (load > 0),
            fit_fn=fit_fn,
        )

    return fn


def _swap_shed_round(res: int, capacity_bound: bool) -> RoundFn:
    """Pairwise swap fallback against the balance band's upper edge
    (``capacity_bound=False``, rebalanceBySwappingLoadOut :599) or against the
    capacity limit (``True``), for clusters whose eligible destinations are full."""

    def fn(state, ctx, snap, prior_mask, salt):
        if capacity_bound:
            bound = snap.cap_limits[:, res]
            src_need = snap.broker_load[:, res] - bound
        else:
            bound = snap.res_upper[:, res]
            src_need = torch.where(snap.low_util[res], 0.0, snap.broker_load[:, res] - bound)
        load = snap.eff_load[:, res]

        def gain_fn(vs, vsnap, r_out, partner, cols=None):
            e_out = vsnap.eff_load[r_out, res][:, None]
            e_in = vsnap.eff_load[partner, res][None, :]
            gain = e_out - e_in                       # net load shed from the source
            dst_after = _c(vsnap.broker_load[:, res], cols)[None, :] + gain
            return (gain > 0.0) & (dst_after <= _c(bound, cols)[None, :]), gain

        return swap_round(
            state, ctx, snap, prior_mask, salt,
            src_need=src_need,
            out_score=load,
            out_ok=snap.movable & (load > 0),
            in_score=-load,
            in_ok=snap.movable,
            gain_fn=gain_fn,
        )

    return fn


def _dist_swap_round(res: int) -> RoundFn:
    return _swap_shed_round(res, capacity_bound=False)


def _capacity_swap_round(res: int) -> RoundFn:
    return _swap_shed_round(res, capacity_bound=True)


# -- TopicReplicaDistributionGoal ---------------------------------------------------


def topic_dist_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    bt = snap.topic_counts
    tup = snap.topic_band[1]
    topic = state.partition_topic[state.replica_partition]
    excess = (bt - tup[None, :]).to(F32)  # [B, T]
    r_excess = excess[state.replica_broker, topic]
    src_need = torch.where(state.broker_alive, excess.amax(dim=1), 0.0)

    def dst_fn(vs, vsnap, cand, cols=None):
        t = vs.partition_topic[vs.replica_partition[cand]]
        btc = _c(bt, cols)
        ok = btc[:, t].T + 1 <= tup[t][:, None]
        return ok, -btc[:, t].T.to(F32)

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        cand_score=r_excess,
        cand_ok=snap.movable & (r_excess > 0),
        dst_fn=dst_fn,
    )


# -- LeaderReplicaDistributionGoal --------------------------------------------------


def leader_dist_shed(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    lup = snap.leader_band[1]
    src_need = (snap.leader_counts - lup).to(F32)
    fb = state.replica_broker
    return leadership_shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        leader_score=_zeros_r(state),
        leader_ok=snap.movable,
        follower_score=-snap.leader_counts[fb].to(F32),
        follower_ok=snap.leader_counts[fb] + 1 <= lup,
    )


def leader_dist_fill(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    llo = snap.leader_band[0]
    dst_need = (llo - snap.leader_counts).to(F32)
    p = state.replica_partition
    cur_leader = state.partition_leader[p]
    leader_broker = snap.leader_broker[p]
    donor_rich = snap.leader_counts[leader_broker] - 1 >= llo
    return leadership_fill_round(
        state, ctx, snap, prior_mask, salt,
        dst_need=dst_need,
        follower_score=snap.leader_counts[leader_broker].to(F32),
        follower_ok=donor_rich & (cur_leader >= 0),
    )


# -- LeaderBytesInDistributionGoal --------------------------------------------------


def leader_bytes_in_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    upper = snap.leader_nw_in_upper
    src_need = snap.leader_nw_in - upper
    nw_in = snap.eff_load[:, Resource.NW_IN]
    fb = state.replica_broker
    return leadership_shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        leader_score=nw_in,
        leader_ok=snap.movable,
        follower_score=-snap.leader_nw_in[fb],
        follower_ok=snap.leader_nw_in[fb] + nw_in <= upper,
    )


# -- MinTopicLeadersPerBrokerGoal ---------------------------------------------------


def min_topic_leaders_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    lead_bt = snap.topic_leader_counts
    need = ctx.constraint.min_topic_leaders_per_broker
    topic = state.partition_topic[state.replica_partition]
    protected = ctx.min_leader_topics[topic]
    deficit = (need - lead_bt).to(F32)  # [B, T]
    deficit = torch.where(ctx.min_leader_topics[None, :], deficit, 0.0)
    deficit = torch.where(state.broker_alive[:, None], deficit, 0.0)
    dst_need = deficit.amax(dim=1)

    p = state.replica_partition
    cur_leader = state.partition_leader[p]
    leader_broker = snap.leader_broker[p]
    donor_spare = lead_bt[leader_broker, topic] - 1 >= need
    r_deficit = deficit[state.replica_broker, topic]
    return leadership_fill_round(
        state, ctx, snap, prior_mask, salt,
        dst_need=dst_need,
        follower_score=r_deficit,
        follower_ok=protected & (r_deficit > 0) & donor_spare & (cur_leader >= 0),
    )


def _count_per_broker(state, snap, mask: torch.Tensor) -> torch.Tensor:
    """f32[B]: rows of ``mask`` per broker (an exact integer count), merged
    over the ranks when the replica axis is sharded."""
    return spmd_segment_sum(snap.spmd, mask, state.replica_broker, state.num_brokers).to(F32)


# -- JBOD intra-broker goals --------------------------------------------------------


def intra_disk_capacity_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """Drain overfull and unusable (removed or dead) logdirs to sibling disks
    of the same broker; an unusable disk drains completely (its need counts
    replicas, not load, so empty replicas move too)."""
    over = snap.disk_load - snap.disk_limits
    src_need = torch.where(
        snap.disk_usable, torch.clamp(over, min=0.0), snap.disk_replica_counts.to(F32)
    )
    du = state.base_load[:, Resource.DISK]
    on_dead_disk = (state.replica_disk >= 0) & ~snap.disk_usable[torch.clamp(state.replica_disk, min=0)]

    def dst_fn(vs, vsnap, cand):
        cdu = vs.base_load[cand, Resource.DISK]
        fits = vsnap.disk_load[None, :] + cdu[:, None] <= vsnap.disk_limits[None, :]
        cap = torch.clamp(vs.disk_capacity, min=1e-9)
        return fits, _bcast(-(vsnap.disk_load / cap), cand.shape[0])

    return intra_disk_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        cand_score=du,
        cand_ok=snap.movable & ((du > 0) | on_dead_disk),
        dst_fn=dst_fn,
    )


def intra_disk_dist_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """Balance disk usage across each broker's own logdirs: shed from disks
    over their broker-relative band toward under-loaded siblings."""
    src_need = torch.where(snap.disk_usable, snap.disk_load - snap.disk_upper, 0.0)
    du = state.base_load[:, Resource.DISK]
    sd = torch.clamp(state.replica_disk, min=0)
    keeps_src = du <= snap.disk_load[sd] - snap.disk_lower[sd]

    def dst_fn(vs, vsnap, cand):
        cdu = vs.base_load[cand, Resource.DISK]
        fits = vsnap.disk_load[None, :] + cdu[:, None] <= vsnap.disk_upper[None, :]
        cap = torch.clamp(vs.disk_capacity, min=1e-9)
        return fits, _bcast(-(vsnap.disk_load / cap), cand.shape[0])

    return intra_disk_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        cand_score=du,
        cand_ok=snap.movable & (du > 0) & keeps_src,
        dst_fn=dst_fn,
    )


# -- optional goals -------------------------------------------------------------------


def preferred_leader_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """PreferredLeaderElectionGoal: transfer leadership back to each
    partition's replica-list head where that head can take it."""
    if snap.spmd is not None:
        raise NotImplementedError(
            "PreferredLeaderElectionGoal reads replica rows at preferred-leader ids; "
            "ShardedGoalOptimizer routes such goal lists to its gather path"
        )
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    pref = snap.preferred_leader
    pref_of_r = pref[state.replica_partition]
    target_ok = leadership_target_ok(state, ctx, snap, prior_mask)
    pref_safe = torch.clamp(pref_of_r, min=0)
    # the head must be electable: alive, leadership-movable, prior-acceptable
    pref_usable = (
        (pref_of_r >= 0)
        & state.broker_alive[state.replica_broker[pref_safe]]
        & snap.leader_movable[pref_safe]
        & target_ok[pref_safe]
    )
    idx = torch.arange(state.num_replicas, dtype=I32, device=dev)
    wrong = snap.is_leader & pref_usable & (pref_of_r != idx) & snap.leader_movable
    src_need = _count_per_broker(state, snap, wrong)
    cands = topk_segment_argmax(_zeros_r(state), state.replica_broker, B, wrong, k)
    cand = cands.reshape(-1)
    valid = cand >= 0
    cand_safe = torch.where(valid, cand, 0)
    dst_rep = pref[state.replica_partition[cand_safe]]
    dst_rep_safe = torch.clamp(dst_rep, min=0)
    replica = torch.where(valid & (dst_rep >= 0), cand_safe, -1)
    src_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
    return MoveBatch(
        kind=KIND_LEADERSHIP,
        replica=replica,
        dst_broker=torch.where(replica >= 0, state.replica_broker[dst_rep_safe], -1),
        dst_replica=torch.where(replica >= 0, dst_rep, -1),
        score=torch.where(replica >= 0, src_need[src_of_slot], 0.0),
    )


def rack_dist_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """RackAwareDistributionGoal: even out each partition's replicas across
    the alive racks (fair share ceil(RF / alive racks))."""
    p_of_r = state.replica_partition
    fair = rack_fair_share(state, snap, torch.arange(state.num_partitions, device=state.device))
    occ_r = snap.rack_counts[p_of_r, state.broker_rack[state.replica_broker]]
    viol = state.replica_valid & (occ_r > fair[p_of_r])

    def dst_fn(vs, vsnap, cand, cols=None):
        p = vs.replica_partition[cand]
        src_rack = vs.broker_rack[vs.replica_broker[cand]]
        dst_rack = _c(vs.broker_rack, cols)
        occ = vsnap.rack_counts[p][:, dst_rack]
        occ = occ - (src_rack[:, None] == dst_rack[None, :]).to(I32)
        score = -occ.to(F32) - 1e-3 * _c(_counts_f(vsnap), cols)[None, :]
        return occ + 1 <= fair[p][:, None], score

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=_count_per_broker(state, snap, viol),
        cand_score=_zeros_r(state),
        cand_ok=viol & snap.movable,
        dst_fn=dst_fn,
    )


def topic_leader_dist_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """TopicLeaderReplicaDistributionGoal: shed per-topic leadership from
    brokers above the per-topic band onto followers below it."""
    lt = snap.topic_leader_counts
    lt_up = topic_leader_upper(state, ctx, snap)
    topic = state.partition_topic[state.replica_partition]
    fb = state.replica_broker
    r_excess = (lt[fb, topic] - lt_up[topic]).to(F32)
    src_need = torch.where(
        state.broker_alive, torch.clamp(lt - lt_up[None, :], min=0).amax(dim=1), 0
    ).to(F32)
    return leadership_shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=src_need,
        leader_score=r_excess,
        leader_ok=snap.movable & (r_excess > 0),
        follower_score=-lt[fb, topic].to(F32),
        follower_ok=lt[fb, topic] + 1 <= lt_up[topic],
    )


def broker_set_round(state, ctx, snap, prior_mask, salt) -> MoveBatch:
    """BrokerSetAwareGoal: move replicas back inside their topic's broker set."""
    topic = state.partition_topic[state.replica_partition]
    want = ctx.broker_set_of_topic[topic]
    have = ctx.broker_set_of_broker[state.replica_broker]
    viol = state.replica_valid & (want >= 0) & (have != want)

    def dst_fn(vs, vsnap, cand, cols=None):
        want_c = ctx.broker_set_of_topic[vs.partition_topic[vs.replica_partition[cand]]]
        elig = _c(ctx.broker_set_of_broker, cols)[None, :] == want_c[:, None]
        return elig, _bcast(_c(-vsnap.util_pct.amax(dim=-1), cols), cand.shape[0])

    return shed_round(
        state, ctx, snap, prior_mask, salt,
        src_need=snap.broker_set_need,
        cand_score=_zeros_r(state),
        cand_ok=viol & snap.movable,
        dst_fn=dst_fn,
    )


# -- registry ----------------------------------------------------------------------

GOAL_ROUNDS: Dict[int, Tuple[RoundFn, ...]] = {
    G.RACK_AWARE: (rack_round,),
    G.MIN_TOPIC_LEADERS: (min_topic_leaders_round,),
    G.REPLICA_CAPACITY: (replica_capacity_round,),
    G.DISK_CAPACITY: (
        _capacity_move_round(Resource.DISK),
        _capacity_swap_round(Resource.DISK),
    ),
    G.NW_IN_CAPACITY: (
        _capacity_move_round(Resource.NW_IN),
        _capacity_swap_round(Resource.NW_IN),
    ),
    G.NW_OUT_CAPACITY: (
        _capacity_leadership_round(Resource.NW_OUT),
        _capacity_move_round(Resource.NW_OUT),
        _capacity_swap_round(Resource.NW_OUT),
    ),
    G.CPU_CAPACITY: (
        _capacity_leadership_round(Resource.CPU),
        _capacity_move_round(Resource.CPU),
        _capacity_swap_round(Resource.CPU),
    ),
    # shed/fill/relieve cycle: relieve's swaps free headroom that the next
    # pass's shed/fill moves consume
    G.REPLICA_DISTRIBUTION: (
        replica_dist_shed,
        replica_dist_fill,
        replica_dist_relieve,
    ),
    G.POTENTIAL_NW_OUT: (potential_nw_out_round,),
    G.DISK_USAGE_DIST: (
        _dist_shed_round(Resource.DISK),
        _dist_fill_round(Resource.DISK),
        _dist_swap_round(Resource.DISK),
    ),
    G.NW_IN_USAGE_DIST: (
        _dist_shed_round(Resource.NW_IN),
        _dist_fill_round(Resource.NW_IN),
        _dist_swap_round(Resource.NW_IN),
    ),
    G.NW_OUT_USAGE_DIST: (
        _dist_leadership_round(Resource.NW_OUT),
        _dist_shed_round(Resource.NW_OUT),
        _dist_fill_round(Resource.NW_OUT),
        _dist_swap_round(Resource.NW_OUT),
    ),
    G.CPU_USAGE_DIST: (
        _dist_leadership_round(Resource.CPU),
        _dist_shed_round(Resource.CPU),
        _dist_fill_round(Resource.CPU),
        _dist_swap_round(Resource.CPU),
    ),
    G.TOPIC_REPLICA_DIST: (topic_dist_round,),
    G.LEADER_REPLICA_DIST: (leader_dist_shed, leader_dist_fill),
    G.LEADER_BYTES_IN_DIST: (leader_bytes_in_round,),
    G.INTRA_DISK_CAPACITY: (intra_disk_capacity_round,),
    G.INTRA_DISK_USAGE_DIST: (intra_disk_dist_round,),
    G.PREFERRED_LEADER_ELECTION: (preferred_leader_round,),
    G.RACK_AWARE_DISTRIBUTION: (rack_dist_round,),
    G.TOPIC_LEADER_DIST: (topic_leader_dist_round,),
    G.BROKER_SET_AWARE: (broker_set_round,),
    # the kafka-assigner mode after its placement: the strict rack goal runs the
    # rack round, the disk goal the disk-distribution rounds (swaps included)
    G.KAFKA_ASSIGNER_RACK: (rack_round,),
    G.KAFKA_ASSIGNER_DISK: (
        _dist_shed_round(Resource.DISK),
        _dist_fill_round(Resource.DISK),
        _dist_swap_round(Resource.DISK),
    ),
}
