"""Generic batched round proposers: shed, fill, leadership transfer, swap and
intra-broker logdir moves.

Port of ``cruise_control_tpu/analyzer/proposers.py`` (single device).  One
round: every source broker nominates its top-k candidate replicas (a
segmented top-k, the array form of the reference's sorted-replica walk), each
candidate picks its best destination among those every prior goal accepts
(``move_dst_matrix``), and the optimizer admits the cumulative-safe subset.
Tie-breaking jitter is salted with the round number so equal-scored choices
rotate across rounds instead of colliding again.

The goal-round closures receive ``(state, snap, cand, ...)`` and return
``[S, B]`` eligibility and score matrices; all proposers return a
:class:`MoveBatch`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.acceptance import (
    leadership_target_ok,
    move_dst_matrix,
    swap_dst_matrix,
)
from cruise_control_tpu_torch.analyzer.context import NEG, GoalContext, Snapshot, segment_argmax
from cruise_control_tpu_torch.analyzer.moves import (
    KIND_INTRA_MOVE,
    KIND_LEADERSHIP,
    KIND_REPLICA_MOVE,
    KIND_SWAP,
    MoveBatch,
)
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops.index import scatter_last, scatter_set

I32 = torch.int32
F32 = torch.float32

#: Tie-break magnitude for destination choice (below meaningful score gaps).
TIEBREAK = 1e-4

DstFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _i32(x, device) -> torch.Tensor:
    """int32 tensor from a Python int (a fill: no host-to-device copy, which
    would wait on the stream) or an int32 view of a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(I32)
    return torch.full((), x, dtype=I32, device=device)


def _pair_jitter(a: torch.Tensor, b: torch.Tensor, salt=0) -> torch.Tensor:
    """f32 in (-TIEBREAK, 0]: deterministic jitter from an (a, b, salt) index
    tuple (broadcasting).  Every operand is int32 so the hash wraps exactly as
    the JAX package's does; ``>>`` is arithmetic on int32."""
    dev = a.device
    a = a.to(I32)
    b = _i32(b, dev)
    s = _i32(salt, dev)
    h = a * _i32(1103515245, dev) + b * _i32(40503, dev) + s * _i32(1013904223, dev)
    h = torch.bitwise_and(h ^ (h >> 7), _i32(1023, dev))
    return -TIEBREAK * h.to(F32) / 1024.0


def topk_segment_argmax(
    scores: torch.Tensor, seg: torch.Tensor, num_segments: int, eligible: torch.Tensor, k: int
) -> torch.Tensor:
    """i32[k, num_segments]: top-k eligible elements per segment by score, -1-padded."""
    rows = []
    el = eligible
    oob = scores.shape[0]
    for _ in range(k):
        idx = segment_argmax(scores, seg, num_segments, el)
        rows.append(idx)
        el = scatter_set(el, torch.where(idx >= 0, idx, oob), False)
    return torch.stack(rows)


def _partition_occupancy(
    state: ClusterArrays,
    cand_part: torch.Tensor,
    cand_valid: torch.Tensor,
    dst_brokers: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """bool[S, B|M]: does candidate s's partition already have a replica on the
    column's broker?  A broker holds at most one replica of a partition.

    Slots whose partition lost the inverse-map race (two candidates sharing a
    partition; the last slot wins, as in the JAX CPU scatter) are fully masked
    and retry next round.  ``dst_brokers`` (unique ids) restricts the columns."""
    dev = cand_part.device
    S = cand_part.shape[0]
    P = state.num_partitions
    p_cand = torch.where(cand_valid, cand_part, P)
    slot = scatter_last(
        torch.full((P,), -1, dtype=I32, device=dev), p_cand,
        torch.arange(S, dtype=I32, device=dev),
    )
    p_safe = torch.where(cand_valid, p_cand, 0)
    unique = cand_valid & (slot[p_safe] == torch.arange(S, dtype=I32, device=dev))
    r_slot = slot[state.replica_partition]
    if dst_brokers is None:
        ncols = state.num_brokers
        cols = state.replica_broker
    else:
        ncols = dst_brokers.shape[0]
        # broker id -> column position; brokers outside the window go to ncols (dropped)
        col_of_broker = scatter_set(
            torch.full((state.num_brokers,), ncols, dtype=I32, device=dev),
            dst_brokers, torch.arange(ncols, dtype=I32, device=dev),
        )
        cols = col_of_broker[state.replica_broker]
    rows = torch.where((r_slot >= 0) & state.replica_valid, r_slot, S)
    # flat (row, col) scatter into an [S+1, ncols+1] grid: the extra row and
    # column take the dropped writes
    flat = rows.long() * (ncols + 1) + cols.long()
    occupied = torch.zeros((S + 1) * (ncols + 1), dtype=torch.bool, device=dev)
    occupied[flat] = True
    occupied = occupied.view(S + 1, ncols + 1)[:S, :ncols]
    return occupied | ~unique[:, None]


def _cap_sources(need: torch.Tensor, max_active: int, salt=0):
    """(ids, windows): i32[M] ids of M needy sources (None: no cap required)
    plus the rotation length (i32 0-d >= 1).  Round r serves ranks
    [r*M, r*M + M) cyclically over the need-sorted active sources, so every
    active source gets a round within ``windows`` rounds."""
    B = need.shape[0]
    dev = need.device
    one = _i32(1, dev)
    if B <= max_active:
        return None, one
    order = torch.argsort(-need, stable=True).to(I32)   # need-descending broker ids
    n_active = torch.clamp((need > 0).sum(dtype=I32), min=1)
    windows = torch.clamp((n_active + max_active - 1) // max_active, min=1).to(I32)
    start = (_i32(salt, dev) % windows) * max_active
    pos = (start + torch.arange(max_active, dtype=I32, device=dev)) % torch.clamp(
        n_active, min=max_active
    )
    return order[pos % B], windows


def _argmax_rows(score: torch.Tensor):
    """(col i32[S], found bool[S]): each row's max column (first on ties)."""
    dst = torch.argmax(score, dim=1).to(I32)
    found = torch.gather(score, 1, dst[:, None].long())[:, 0] > NEG / 2
    return dst, found


def shed_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    src_need: torch.Tensor,    # f32[B] > 0 => broker must shed
    cand_score: torch.Tensor,  # f32[R] preference among its broker's replicas
    cand_ok: torch.Tensor,     # bool[R]
    dst_fn: DstFn,
) -> MoveBatch:
    """One replica-move round pushing load out of violating brokers."""
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    active = src_need > 0
    cands = topk_segment_argmax(cand_score, state.replica_broker, B, cand_ok, k)
    chosen, windows = _cap_sources(src_need, ctx.max_active_brokers, salt)
    if chosen is None:
        cand = cands.reshape(-1)                               # slot = j*B + b
        src_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
    else:
        cand = cands[:, chosen].reshape(-1)                    # slot = j*M + m
        src_of_slot = chosen.repeat(k)
    S = cand.shape[0]
    valid = active[src_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    cols = torch.arange(B, dtype=I32, device=dev)

    occupied = _partition_occupancy(state, state.replica_partition[cand_safe], valid)
    elig, score = dst_fn(state, snap, cand_safe)
    not_self = cols[None, :] != src_of_slot[:, None]
    elig = elig & snap.dest_ok[None, :] & not_self & valid[:, None]
    elig = elig & move_dst_matrix(state, ctx, snap, cand_safe, valid, prior_mask)
    # occupancy claims only from valid slots: an inactive broker's candidate
    # must not steal the partition slot from an active source
    elig = elig & ~occupied
    score = score + _pair_jitter(cand_safe[:, None], cols[None, :], salt)
    score = torch.where(elig, score, NEG)
    dst, found = _argmax_rows(score)

    replica = torch.where(valid & found, cand_safe, -1)
    return MoveBatch(
        kind=KIND_REPLICA_MOVE,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dst, -1),
        dst_replica=torch.full((S,), -1, dtype=I32, device=dev),
        score=torch.where(replica >= 0, src_need[src_of_slot], 0.0),
        windows=windows,
    )


def fill_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    dst_need: torch.Tensor,     # f32[B] > 0 => broker wants load in
    donor_score: torch.Tensor,  # f32[R] preference among a donor broker's replicas
    donor_ok: torch.Tensor,     # bool[R]
    fit_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
    # fit_fn(state, snap, cand i32[B], rows i32[M] | None)
    #   -> (fits bool[M|B, B], src_score f32[M|B, B]); rows = destination brokers
) -> MoveBatch:
    """One replica-move round pulling load into under-limit brokers: each needy
    broker picks its top-k donor brokers, and donor replicas rotate across
    destinations so simultaneous fills rarely collide on one replica."""
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    active = dst_need > 0
    cands_k = topk_segment_argmax(donor_score, state.replica_broker, B, donor_ok, k)
    cand0 = cands_k[0]
    cand0_safe = torch.where(cand0 >= 0, cand0, 0)

    cap_rows, windows = _cap_sources(dst_need, ctx.max_active_brokers, salt)
    row_brokers = cap_rows if cap_rows is not None else torch.arange(B, dtype=I32, device=dev)
    M = row_brokers.shape[0]
    cols = torch.arange(B, dtype=I32, device=dev)

    occ_full = _partition_occupancy(
        state, state.replica_partition[cand0_safe], cand0 >= 0, dst_brokers=cap_rows
    )                                                      # [B donors, M]
    fits, sscore = fit_fn(state, snap, cand0_safe, cap_rows)
    has_cand = (cand0 >= 0)[None, :]
    not_self = cols[None, :] != row_brokers[:, None]
    dst_is_ok = (snap.dest_ok & active)[row_brokers][:, None]
    fits = fits & has_cand & not_self & dst_is_ok
    fits = fits & move_dst_matrix(
        state, ctx, snap, cand0_safe, cand0 >= 0, prior_mask, dst_brokers=cap_rows
    ).T
    fits = fits & ~occ_full.T
    sscore = sscore + _pair_jitter(row_brokers[:, None], cols[None, :], salt)
    sscore = torch.where(fits, sscore, NEG)

    replicas, dsts, needs = [], [], []
    n_cands = torch.clamp((cands_k >= 0).sum(dim=0, dtype=I32), min=1)   # per donor
    rows_idx = torch.arange(M, dtype=torch.int64, device=dev)
    masked = sscore
    salt_t = _i32(salt, dev)
    for j in range(k):
        donor, found = _argmax_rows(masked)
        masked = masked.clone()
        masked[rows_idx, donor.long()] = NEG
        # rotate which of the donor's top candidates this destination takes,
        # modulo the donor's actual candidate count
        rot = (row_brokers + j + salt_t) % n_cands[donor]
        r_j = cands_k[rot, donor]
        ok = active[row_brokers] & found & (r_j >= 0)
        replicas.append(torch.where(ok, r_j, -1))
        dsts.append(torch.where(ok, row_brokers, -1))
        needs.append(torch.where(ok, dst_need[row_brokers], 0.0))
    replica = torch.cat(replicas)
    dstv = torch.cat(dsts)
    need = torch.cat(needs)

    # the donor columns were vetted with each donor's TOP candidate; rotated
    # replicas must re-pass prior-goal acceptance and occupancy for their
    # specific destination
    K = k * M
    slot_valid = replica >= 0
    r_safe = torch.where(slot_valid, replica, 0)
    d_safe = torch.where(slot_valid, dstv, 0)
    slot_idx = torch.arange(K, dtype=torch.int64, device=dev)
    col = slot_idx % M if cap_rows is not None else d_safe.long()
    pair_ok = move_dst_matrix(
        state, ctx, snap, r_safe, slot_valid, prior_mask, dst_brokers=cap_rows
    )[slot_idx, col]
    pair_ok &= ~_partition_occupancy(
        state, state.replica_partition[r_safe], slot_valid, dst_brokers=cap_rows
    )[slot_idx, col]
    pair_ok &= d_safe != state.replica_broker[r_safe]
    replica = torch.where(slot_valid & pair_ok, replica, -1)
    return MoveBatch(
        kind=KIND_REPLICA_MOVE,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dstv, -1),
        dst_replica=torch.full((K,), -1, dtype=I32, device=dev),
        score=torch.where(replica >= 0, need, 0.0),
        windows=windows,
    )


def leadership_shed_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    src_need: torch.Tensor,        # f32[B] > 0 => broker must shed leadership load
    leader_score: torch.Tensor,    # f32[R] preference among the broker's leaders
    leader_ok: torch.Tensor,       # bool[R] leader may surrender leadership
    follower_score: torch.Tensor,  # f32[R] preference among takeover candidates
    follower_ok: torch.Tensor,     # bool[R] replica may take leadership
) -> MoveBatch:
    """One leadership-transfer round (leadership movement first,
    ResourceDistributionGoal.java:380)."""
    B, P = state.num_brokers, state.num_partitions
    dev = state.device
    k = ctx.top_k
    take_ok = (
        follower_ok & snap.leader_movable & ~snap.is_leader
        & snap.topic_allowed & state.replica_valid
        & leadership_target_ok(state, ctx, snap, prior_mask)
    )
    # per-partition jitter among equal-scored takeover brokers
    tb = _pair_jitter(state.replica_partition, state.replica_broker, salt)
    best_follower = segment_argmax(follower_score + tb, state.replica_partition, P, take_ok)

    has_follower = best_follower[state.replica_partition] >= 0
    give_ok = leader_ok & snap.is_leader & has_follower
    cands = topk_segment_argmax(leader_score, state.replica_broker, B, give_ok, k)
    cand = cands.reshape(-1)
    src_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
    active = src_need > 0
    valid = active[src_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    p = state.replica_partition[cand_safe]
    dst_rep = best_follower[p]
    dst_rep_safe = torch.where(dst_rep >= 0, dst_rep, 0)
    dst_broker = state.replica_broker[dst_rep_safe]

    replica = torch.where(valid & (dst_rep >= 0), cand_safe, -1)
    return MoveBatch(
        kind=KIND_LEADERSHIP,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dst_broker, -1),
        dst_replica=torch.where(replica >= 0, dst_rep, -1),
        score=torch.where(replica >= 0, src_need[src_of_slot], 0.0),
    )


def leadership_fill_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    dst_need: torch.Tensor,        # f32[B] > 0 => broker wants more leadership
    follower_score: torch.Tensor,  # f32[R] preference among the broker's followers
    follower_ok: torch.Tensor,     # bool[R] follower may take leadership here
) -> MoveBatch:
    """One leadership round pulling leadership onto needy brokers: each needy
    broker promotes its top-k followers whose leaders sit elsewhere."""
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    take_ok = (
        follower_ok & snap.leader_movable & ~snap.is_leader
        & snap.topic_allowed & state.replica_valid
        & leadership_target_ok(state, ctx, snap, prior_mask)
    )
    cands = topk_segment_argmax(follower_score, state.replica_broker, B, take_ok, k)
    cand = cands.reshape(-1)
    dst_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
    active = dst_need > 0
    valid = active[dst_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    p = state.replica_partition[cand_safe]
    cur_leader = state.partition_leader[p]
    ok = valid & (cur_leader >= 0)

    replica = torch.where(ok, cur_leader, -1)   # the leader surrendering
    return MoveBatch(
        kind=KIND_LEADERSHIP,
        replica=replica,
        dst_broker=torch.where(ok, dst_of_slot, -1),
        dst_replica=torch.where(ok, cand_safe, -1),
        score=torch.where(ok, dst_need[dst_of_slot], 0.0),
    )


def swap_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    src_need: torch.Tensor,   # f32[B] > 0 => broker must improve by swapping load out
    out_score: torch.Tensor,  # f32[R] preference for the outgoing replica
    out_ok: torch.Tensor,     # bool[R]
    in_score: torch.Tensor,   # f32[R] preference for the incoming partner
    in_ok: torch.Tensor,      # bool[R]
    gain_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
    # gain_fn(state, snap, r_out i32[S], partner i32[B]) -> (ok bool[S, B], gain f32[S, B])
) -> MoveBatch:
    """One pairwise-swap round: overloaded brokers exchange a heavy replica for
    an underloaded broker's light one (rebalanceBySwappingLoadOut,
    ResourceDistributionGoal.java:599).  Each destination nominates one partner
    per round (rotated by ``salt``); each source its top-k outgoing replicas."""
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    active = src_need > 0

    gidx = torch.arange(state.num_replicas, dtype=I32, device=dev)
    pj = _pair_jitter(gidx, 97, salt)
    partner = topk_segment_argmax(in_score + pj, state.replica_broker, B, in_ok, 1)[0]
    partner_valid = partner >= 0
    partner_safe = torch.where(partner_valid, partner, 0)

    cands = topk_segment_argmax(out_score, state.replica_broker, B, out_ok, k)
    chosen, windows = _cap_sources(src_need, ctx.max_active_brokers, salt)
    if chosen is None:
        cand = cands.reshape(-1)
        src_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
    else:
        cand = cands[:, chosen].reshape(-1)
        src_of_slot = chosen.repeat(k)
    valid = active[src_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    p_out = state.replica_partition[cand_safe]
    p_in = state.replica_partition[partner_safe]

    # occupancy both directions (a broker holds one replica per partition)
    occ_out = _partition_occupancy(state, p_out, valid)
    occ_in = _partition_occupancy(state, p_in, partner_valid, dst_brokers=chosen)
    cols = torch.arange(B, dtype=I32, device=dev)

    ok, gain = gain_fn(state, snap, cand_safe, partner_safe)  # [S, B]
    not_self = cols[None, :] != src_of_slot[:, None]
    ok = ok & partner_valid[None, :] & valid[:, None] & not_self
    ok = ok & snap.dest_ok[None, :] & snap.dest_ok[src_of_slot][:, None]
    ok = ok & (p_out[:, None] != p_in[None, :])
    if chosen is None:
        ok = ok & ~occ_out & ~occ_in[:, src_of_slot].T
    else:
        S_ = src_of_slot.shape[0]
        m_of_slot = torch.arange(S_, dtype=torch.int64, device=dev) % chosen.shape[0]
        ok = ok & ~occ_out & ~occ_in[:, m_of_slot].T
    # prior-goal acceptance with the swap's NET deltas
    ok = ok & swap_dst_matrix(
        state, ctx, snap, cand_safe, valid, partner_safe, partner_valid, prior_mask
    )

    score = gain + _pair_jitter(cand_safe[:, None], cols[None, :], salt)
    score = torch.where(ok, score, NEG)
    dst, found = _argmax_rows(score)

    replica = torch.where(valid & found, cand_safe, -1)
    dst_safe = torch.where(replica >= 0, dst, 0)
    return MoveBatch(
        kind=KIND_SWAP,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dst, -1),
        dst_replica=torch.where(replica >= 0, partner[dst_safe], -1),
        score=torch.where(replica >= 0, src_need[src_of_slot], 0.0),
        windows=windows,
    )


def intra_disk_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    src_need: torch.Tensor,    # f32[D] > 0 => logdir must shed
    cand_score: torch.Tensor,  # f32[R] preference among the disk's replicas
    cand_ok: torch.Tensor,     # bool[R]
    dst_fn: DstFn,             # dst_fn(state, snap, cand i32[S]) -> (elig, score) [S, D]
) -> MoveBatch:
    """One intra-broker logdir-move round (the IntraBrokerDisk* goals).
    Sources and destinations are disks and every move stays on the replica's
    broker, so no broker-level quantity changes and no prior goal's
    destination matrix applies: eligibility is the goal's own ``dst_fn`` plus
    the same-broker and usable-disk masks."""
    D = state.num_disks
    dev = state.device
    k = ctx.top_k
    on_disk = state.replica_disk >= 0
    seg = torch.where(on_disk, state.replica_disk, D)
    active = src_need > 0
    cands = topk_segment_argmax(cand_score, seg, D, cand_ok & on_disk, k)
    chosen, windows = _cap_sources(src_need, ctx.max_active_brokers, salt)
    if chosen is None:
        cand = cands.reshape(-1)                                # slot = j*D + d
        src_disk_of_slot = torch.arange(D, dtype=I32, device=dev).repeat(k)
    else:
        cand = cands[:, chosen].reshape(-1)
        src_disk_of_slot = chosen.repeat(k)
    S = cand.shape[0]
    valid = active[src_disk_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)

    elig, score = dst_fn(state, snap, cand_safe)
    cols = torch.arange(D, dtype=I32, device=dev)
    same_broker = state.disk_broker[None, :] == state.replica_broker[cand_safe][:, None]
    not_self = cols[None, :] != src_disk_of_slot[:, None]
    elig = elig & same_broker & not_self & snap.disk_usable[None, :] & valid[:, None]
    score = score + _pair_jitter(cand_safe[:, None], cols[None, :], salt)
    score = torch.where(elig, score, NEG)
    dst, found = _argmax_rows(score)

    replica = torch.where(valid & found, cand_safe, -1)
    return MoveBatch(
        kind=KIND_INTRA_MOVE,
        replica=replica,
        dst_broker=torch.where(replica >= 0, state.replica_broker[cand_safe], -1),
        dst_replica=torch.full((S,), -1, dtype=I32, device=dev),
        score=torch.where(replica >= 0, src_need[src_disk_of_slot], 0.0),
        dst_disk=torch.where(replica >= 0, dst, -1),
        windows=windows,
    )
