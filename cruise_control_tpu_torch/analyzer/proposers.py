"""Generic batched round proposers: shed, fill, leadership transfer, swap and
intra-broker logdir moves.

Port of ``cruise_control_tpu/analyzer/proposers.py``.  One round: every
source broker nominates its top-k candidate replicas (a segmented top-k, the
array form of the reference's sorted-replica walk), each candidate picks its
best destination among those every prior goal accepts (``move_dst_matrix``),
and the optimizer admits the cumulative-safe subset.  Tie-breaking jitter is
salted with the round number so equal-scored choices rotate across rounds
instead of colliding again.

The goal-round closures receive the replica-axis view ``(vs, vsnap, cand,
...)`` and return ``[S, B]`` eligibility and score matrices; all proposers
return a :class:`MoveBatch`.

Sharded solver (``snap.spmd`` set, :mod:`parallel.spmd`): per-replica
scoring and the segmented top-k run on each rank's LOCAL rows and ONE
all_gather merges the per-rank winners (score descending, global id
ascending: the single-device walk's order) together with each winner's row
payload.  The slot pipeline below the merge (destination matrices,
occupancy, prior-goal acceptance) then runs replicated against the row
table through the surrogate view, and the wide destination axis is
column-sharded: each rank scores its ``B/n`` destination columns
(``dst_fn(vs, vsnap, cand, cols)``, ``gain_fn(..., cols)``) and one small
merge picks the global destination with ``torch.argmax``'s first-maximum
rule.  The closures must derive every per-replica value from the view,
never from a captured ``[R]`` tensor (that would index a local block with a
global position).
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
from cruise_control_tpu_torch.ops.index import even_significand, fresh_index_fill, scatter_last, scatter_set
from cruise_control_tpu_torch.parallel import spmd as SP

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


def _pair_hash(a: torch.Tensor, b, salt=0) -> torch.Tensor:
    """i32 in [0, 1023]: the jitter's hash of an (a, b, salt) index tuple
    (broadcasting).  Every operand is int32 so the hash wraps exactly as the
    JAX package's does; ``>>`` is arithmetic on int32."""
    dev = a.device
    a = a.to(I32)
    b = _i32(b, dev)
    s = _i32(salt, dev)
    h = a * _i32(1103515245, dev) + b * _i32(40503, dev) + s * _i32(1013904223, dev)
    return torch.bitwise_and(h ^ (h >> 7), _i32(1023, dev))


def _pair_jitter(a: torch.Tensor, b, salt=0) -> torch.Tensor:
    """f32 in (-TIEBREAK, 0]: deterministic jitter from an (a, b, salt) index
    tuple (broadcasting), rounded on its own, as the JAX function returns it.
    The rounds add it to their scores through :func:`_plus_jitter`."""
    return -TIEBREAK * _pair_hash(a, b, salt).to(F32) / 1024.0


#: the jitter's one factor, as XLA folds ``-TIEBREAK * h / 1024``: the
#: float32 constant over 1,024 (exact)
_JITTER_STEP = float(np.float32(-TIEBREAK)) / 1024.0


def _plus_jitter(x: torch.Tensor, a: torch.Tensor, b, salt=0) -> torch.Tensor:
    """``x + _pair_jitter(a, b, salt)`` rounded as the JAX package's compiled
    rounds compute it.  XLA folds the jitter's two constant factors into one
    and fuses the product into the add, a fused multiply-add with a single
    rounding: f32(x + h * _JITTER_STEP).  The plain sum rounds the jitter
    first and differs in the last bit for about one element in 8,000, which
    flips a near-tie in an argmax (the ReplicaDistributionGoal swap rounds at
    1,000 brokers).  The product is exact in float64; the sum is rounded to
    odd in float64 (TwoSum gives its exact error) and then to float32, which
    rounds once, exactly, on the CPU and on the card alike."""
    x64 = x.to(torch.float64)
    p = _pair_hash(a, b, salt).to(torch.float64) * _JITTER_STEP
    s = x64 + p
    bb = s - x64
    err = (x64 - (s - bb)) + (p - bb)
    even = even_significand(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even & torch.isfinite(s), torch.nextafter(s, toward), s)
    return s.to(F32)


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


def _topk_with_rows(state, snap, scores, seg, num_segments, eligible, k):
    """``(ids [k, num_segments] global, rows | None)``: the segmented top-k on
    either path.  Single-device the iterative argmax walk and no row table
    (the state is the view); sharded the local top-k plus one merge."""
    if snap.spmd is None:
        return topk_segment_argmax(scores, seg, num_segments, eligible, k), None
    return SP.topk_rows_merge(snap.spmd, state, snap, scores, seg, num_segments, eligible, k)


def _views(state, snap, rows):
    """``(vs, vsnap)``: the replica-axis view of the slot pipeline."""
    if rows is None:
        return state, snap
    return SP.surrogate_views(state, snap, rows)


def _partition_occupancy(
    state: ClusterArrays,
    cand_part: torch.Tensor,
    cand_valid: torch.Tensor,
    dst_brokers: Optional[torch.Tensor] = None,
    spmd=None,
    merge: bool = True,
):
    """bool[S, B|M]: does candidate s's partition already have a replica on the
    column's broker?  A broker holds at most one replica of a partition.

    Slots whose partition lost the inverse-map race (two candidates sharing a
    partition; the last slot wins, as in the JAX CPU scatter) are fully masked
    and retry next round.  ``dst_brokers`` (unique ids) restricts the columns.

    Sharded (``spmd``): the replica scatter runs over this rank's rows as an
    int32 count and the ``[S, cols]`` partial merges in one collective; with
    ``merge=False`` the caller gets ``(partial, unique)`` to batch several
    partials into one merge."""
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
    if spmd is None:
        occupied = torch.zeros((S + 1) * (ncols + 1), dtype=torch.bool, device=dev)
        occupied = fresh_index_fill(occupied, flat, True).view(S + 1, ncols + 1)[:S, :ncols]
        return occupied | ~unique[:, None]
    partial = torch.zeros((S + 1) * (ncols + 1), dtype=I32, device=dev)
    partial.index_add_(0, flat, torch.ones_like(flat, dtype=I32))
    partial = partial.view(S + 1, ncols + 1)[:S, :ncols]
    if not merge:
        return partial, unique
    merged = SP.merge_sums(spmd, {"occ": partial})["occ"]
    return (merged > 0) | ~unique[:, None]


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


def _columns(spmd, B: int, dev):
    """``(col0, cols)``: this rank's slice of the destination-broker axis
    when the axis splits evenly over the ranks, else ``(None, all B)``."""
    if spmd is not None and B % spmd.n == 0:
        col0, cols, _ = SP.own_cols(spmd, B)
        return col0, cols
    return None, torch.arange(B, dtype=I32, device=dev)


def _pick_dst(spmd, score: torch.Tensor, col0):
    """(col i32[S], found bool[S]): the best destination column, merged over
    the ranks' column slices when the axis is column-sharded."""
    if col0 is None:
        return _argmax_rows(score)
    best_s, dst = SP.colmax_merge(spmd, score, col0)
    return dst, best_s > NEG / 2


def shed_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    src_need: torch.Tensor,    # f32[B] > 0 => broker must shed (replicated)
    cand_score: torch.Tensor,  # f32[R] preference among its broker's replicas
    cand_ok: torch.Tensor,     # bool[R]
    dst_fn: DstFn,
) -> MoveBatch:
    """One replica-move round pushing load out of violating brokers."""
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    spmd = snap.spmd
    active = src_need > 0
    cands, rows = _topk_with_rows(state, snap, cand_score, state.replica_broker, B, cand_ok, k)
    chosen, windows = _cap_sources(src_need, ctx.max_active_brokers, salt)
    if chosen is None:
        cand = cands.reshape(-1)                               # slot = j*B + b
        src_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
        view = None if rows is None else torch.arange(k * B, dtype=I32, device=dev)
    else:
        cand = cands[:, chosen].reshape(-1)                    # slot = j*M + m
        src_of_slot = chosen.repeat(k)
        view = None if rows is None else (
            torch.arange(k, dtype=I32, device=dev)[:, None] * B + chosen[None, :]
        ).reshape(-1)
    S = cand.shape[0]
    valid = active[src_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    vs, vsnap = _views(state, snap, rows)
    cv_safe = cand_safe if view is None else torch.where(cand >= 0, view, 0)

    # occupancy is a cheap [S, B] merge; the per-(slot, destination) work
    # below it is column-sharded
    occupied = _partition_occupancy(state, vs.replica_partition[cv_safe], valid, spmd=spmd)
    col0, cols = _columns(spmd, B, dev)
    dst_cols = None if col0 is None else cols
    elig, score = dst_fn(vs, vsnap, cv_safe, dst_cols)
    not_self = cols[None, :] != src_of_slot[:, None]
    dest_ok = snap.dest_ok if col0 is None else snap.dest_ok[cols]
    elig = elig & dest_ok[None, :] & not_self & valid[:, None]
    elig = elig & move_dst_matrix(vs, ctx, vsnap, cv_safe, valid, prior_mask, dst_brokers=dst_cols)
    # occupancy claims only from valid slots: an inactive broker's candidate
    # must not steal the partition slot from an active source
    elig = elig & ~SP.slice_cols(col0 is not None, occupied, col0, cols.shape[0])
    score = _plus_jitter(score, cand_safe[:, None], cols[None, :], salt)
    score = torch.where(elig, score, NEG)
    dst, found = _pick_dst(spmd, score, col0)

    replica = torch.where(valid & found, cand_safe, -1)
    return MoveBatch(
        kind=KIND_REPLICA_MOVE,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dst, -1),
        dst_replica=torch.full((S,), -1, dtype=I32, device=dev),
        score=torch.where(replica >= 0, src_need[src_of_slot], 0.0),
        windows=windows,
        rows=rows,
        view_replica=None if rows is None else torch.where(replica >= 0, view, -1),
        view_dst_replica=None if rows is None else torch.full((S,), -1, dtype=I32, device=dev),
    )


def fill_round(
    state: ClusterArrays,
    ctx: GoalContext,
    snap: Snapshot,
    prior_mask: np.ndarray,
    salt: int,
    dst_need: torch.Tensor,     # f32[B] > 0 => broker wants load in (replicated)
    donor_score: torch.Tensor,  # f32[R] preference among a donor broker's replicas
    donor_ok: torch.Tensor,     # bool[R]
    fit_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
    # fit_fn(vs, vsnap, cand i32[C], rows i32[M] | None)
    #   -> (fits bool[M|B, C], src_score f32[M|B, C]); rows = destination brokers,
    #   columns = the donors of ``cand``
) -> MoveBatch:
    """One replica-move round pulling load into under-limit brokers: each needy
    broker picks its top-k donor brokers, and donor replicas rotate across
    destinations so simultaneous fills rarely collide on one replica."""
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    spmd = snap.spmd
    active = dst_need > 0
    cands_k, tbl = _topk_with_rows(state, snap, donor_score, state.replica_broker, B, donor_ok, k)
    vs, vsnap = _views(state, snap, tbl)
    cand0 = cands_k[0]
    cand0_safe = torch.where(cand0 >= 0, cand0, 0)
    cv0_safe = cand0_safe if tbl is None else torch.where(
        cand0 >= 0, torch.arange(B, dtype=I32, device=dev), 0
    )

    cap_rows, windows = _cap_sources(dst_need, ctx.max_active_brokers, salt)
    row_brokers = cap_rows if cap_rows is not None else torch.arange(B, dtype=I32, device=dev)
    M = row_brokers.shape[0]

    # the donor axis (columns) is the wide one: occupancy merges once at
    # [B, M], the broadcast terms evaluate on this rank's donor columns
    occ_full = _partition_occupancy(
        state, vs.replica_partition[cv0_safe], cand0 >= 0, dst_brokers=cap_rows, spmd=spmd
    )                                                      # [B donors, M]
    col0, cols = _columns(spmd, B, dev)
    if col0 is None:
        cv0_cols, c0_valid_cols, occ = cv0_safe, cand0 >= 0, occ_full
    else:
        nloc = cols.shape[0]
        cv0_cols = cv0_safe[col0:col0 + nloc]
        c0_valid_cols = (cand0 >= 0)[col0:col0 + nloc]
        occ = occ_full[col0:col0 + nloc]
    fits, sscore = fit_fn(vs, vsnap, cv0_cols, cap_rows)
    has_cand = c0_valid_cols[None, :]
    not_self = cols[None, :] != row_brokers[:, None]
    dst_is_ok = (snap.dest_ok & active)[row_brokers][:, None]
    fits = fits & has_cand & not_self & dst_is_ok
    fits = fits & move_dst_matrix(
        vs, ctx, vsnap, cv0_cols, c0_valid_cols, prior_mask, dst_brokers=cap_rows
    ).T
    fits = fits & ~occ.T
    sscore = _plus_jitter(sscore, row_brokers[:, None], cols[None, :], salt)
    sscore = torch.where(fits, sscore, NEG)

    # top-k donor columns per destination row
    donor_scores = donor_cols = None
    if col0 is not None:
        donor_scores, donor_cols = SP.coltopk_merge(spmd, sscore, col0, k)
    replicas, views, dsts, needs = [], [], [], []
    n_cands = torch.clamp((cands_k >= 0).sum(dim=0, dtype=I32), min=1)   # per donor
    masked = sscore
    salt_t = _i32(salt, dev)
    for j in range(k):
        if donor_cols is None:
            donor, found = _argmax_rows(masked)
            masked = torch.where(cols[None, :] == donor[:, None], NEG, masked)
        else:
            donor = donor_cols[j]
            found = donor_scores[j] > NEG / 2
        # rotate which of the donor's top candidates this destination takes,
        # modulo the donor's actual candidate count
        rot = (row_brokers + j + salt_t) % n_cands[donor]
        r_j = cands_k[rot, donor]
        ok = active[row_brokers] & found & (r_j >= 0)
        replicas.append(torch.where(ok, r_j, -1))
        views.append(torch.where(ok, rot * B + donor, -1))
        dsts.append(torch.where(ok, row_brokers, -1))
        needs.append(torch.where(ok, dst_need[row_brokers], 0.0))
    replica = torch.cat(replicas)
    viewv = torch.cat(views)
    dstv = torch.cat(dsts)
    need = torch.cat(needs)

    # the donor columns were vetted with each donor's TOP candidate; rotated
    # replicas must re-pass prior-goal acceptance and occupancy for their
    # specific destination
    K = k * M
    slot_valid = replica >= 0
    r_safe = torch.where(slot_valid, replica, 0)
    rv_safe = r_safe if tbl is None else torch.where(slot_valid, viewv, 0)
    d_safe = torch.where(slot_valid, dstv, 0)
    slot_idx = torch.arange(K, dtype=torch.int64, device=dev)
    col = slot_idx % M if cap_rows is not None else d_safe.long()
    pair_ok = move_dst_matrix(
        vs, ctx, vsnap, rv_safe, slot_valid, prior_mask, dst_brokers=cap_rows
    )[slot_idx, col]
    pair_ok = pair_ok & ~_partition_occupancy(
        state, vs.replica_partition[rv_safe], slot_valid, dst_brokers=cap_rows, spmd=spmd
    )[slot_idx, col]
    pair_ok = pair_ok & (d_safe != vs.replica_broker[rv_safe])
    replica = torch.where(slot_valid & pair_ok, replica, -1)
    return MoveBatch(
        kind=KIND_REPLICA_MOVE,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dstv, -1),
        dst_replica=torch.full((K,), -1, dtype=I32, device=dev),
        score=torch.where(replica >= 0, need, 0.0),
        windows=windows,
        rows=tbl,
        view_replica=None if tbl is None else torch.where(replica >= 0, viewv, -1),
        view_dst_replica=None if tbl is None else torch.full((K,), -1, dtype=I32, device=dev),
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
    spmd = snap.spmd
    take_ok = (
        follower_ok & snap.leader_movable & ~snap.is_leader
        & snap.topic_allowed & state.replica_valid
        & leadership_target_ok(state, ctx, snap, prior_mask)
    )
    # per-partition jitter among equal-scored takeover brokers
    jittered = _plus_jitter(follower_score, state.replica_partition, state.replica_broker, salt)
    if spmd is None:
        best_follower = segment_argmax(jittered, state.replica_partition, P, take_ok)
    else:
        best_follower = SP.argmax_ids_merge(spmd, jittered, state.replica_partition, P, take_ok)

    has_follower = best_follower[state.replica_partition] >= 0
    give_ok = leader_ok & snap.is_leader & has_follower
    cands, leader_rows = _topk_with_rows(state, snap, leader_score, state.replica_broker, B, give_ok, k)
    cand = cands.reshape(-1)
    src_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
    active = src_need > 0
    valid = active[src_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    S = cand.shape[0]
    rows = view_r = view_d = None
    if spmd is None:
        p = state.replica_partition[cand_safe]
        dst_rep = best_follower[p]
        dst_rep_safe = torch.where(dst_rep >= 0, dst_rep, 0)
        dst_broker = state.replica_broker[dst_rep_safe]
    else:
        slots = torch.arange(S, dtype=I32, device=dev)
        p = leader_rows.partition[torch.where(cand >= 0, slots, 0)]
        dst_rep = best_follower[p]
        dst_rep_safe = torch.where(dst_rep >= 0, dst_rep, 0)
        # the follower rows this round's slots reference (one merge)
        follower_rows, _ = SP.fetch_rows(spmd, state, snap, dst_rep_safe)
        dst_broker = follower_rows.broker
        rows = SP.concat_rows([leader_rows, follower_rows])
        view_r = slots
        view_d = S + slots

    replica = torch.where(valid & (dst_rep >= 0), cand_safe, -1)
    return MoveBatch(
        kind=KIND_LEADERSHIP,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dst_broker, -1),
        dst_replica=torch.where(replica >= 0, dst_rep, -1),
        score=torch.where(replica >= 0, src_need[src_of_slot], 0.0),
        rows=rows,
        view_replica=None if rows is None else torch.where(replica >= 0, view_r, -1),
        view_dst_replica=None if rows is None else torch.where(replica >= 0, view_d, -1),
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
    cands, follower_rows = _topk_with_rows(state, snap, follower_score, state.replica_broker, B, take_ok, k)
    cand = cands.reshape(-1)
    dst_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
    active = dst_need > 0
    valid = active[dst_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    S = cand.shape[0]
    rows = view_r = view_d = None
    if follower_rows is None:
        p = state.replica_partition[cand_safe]
    else:
        slots = torch.arange(S, dtype=I32, device=dev)
        p = follower_rows.partition[torch.where(cand >= 0, slots, 0)]
        # the surrendering leaders' rows come from the snapshot's merged
        # per-partition leader table: no extra collective
        has_leader = state.partition_leader[p] >= 0
        leader_rows = SP.ReplicaRows(
            partition=p,
            broker=snap.leader_broker[p],
            disk=torch.full((S,), -1, dtype=I32, device=dev),
            valid=has_leader,
            is_leader=has_leader,
            base_load=snap.leader_eff[p],
            eff_load=snap.leader_eff[p],
        )
        rows = SP.concat_rows([follower_rows, leader_rows])
        view_d = slots
        view_r = S + slots
    cur_leader = state.partition_leader[p]
    ok = valid & (cur_leader >= 0)

    replica = torch.where(ok, cur_leader, -1)   # the leader surrendering
    return MoveBatch(
        kind=KIND_LEADERSHIP,
        replica=replica,
        dst_broker=torch.where(ok, dst_of_slot, -1),
        dst_replica=torch.where(ok, cand_safe, -1),
        score=torch.where(ok, dst_need[dst_of_slot], 0.0),
        rows=rows,
        view_replica=None if rows is None else torch.where(ok, view_r, -1),
        view_dst_replica=None if rows is None else torch.where(ok, view_d, -1),
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
    # gain_fn(vs, vsnap, r_out i32[S], partner i32[B|C], cols) -> (ok bool[S, B|C], gain f32[S, B|C])
) -> MoveBatch:
    """One pairwise-swap round: overloaded brokers exchange a heavy replica for
    an underloaded broker's light one (rebalanceBySwappingLoadOut,
    ResourceDistributionGoal.java:599).  Each destination nominates one partner
    per round (rotated by ``salt``); each source its top-k outgoing replicas."""
    B = state.num_brokers
    dev = state.device
    k = ctx.top_k
    spmd = snap.spmd
    active = src_need > 0

    # one incoming partner per destination broker, rotated across rounds
    # (jitter keyed on the global replica index so in-segment ties rotate)
    gidx = SP.global_iota(state, spmd)
    partner_k, partner_rows = _topk_with_rows(
        state, snap, _plus_jitter(in_score, gidx, 97, salt), state.replica_broker, B, in_ok, 1
    )
    partner = partner_k[0]
    partner_valid = partner >= 0
    partner_safe = torch.where(partner_valid, partner, 0)

    cands, out_rows = _topk_with_rows(state, snap, out_score, state.replica_broker, B, out_ok, k)
    chosen, windows = _cap_sources(src_need, ctx.max_active_brokers, salt)
    if chosen is None:
        cand = cands.reshape(-1)
        src_of_slot = torch.arange(B, dtype=I32, device=dev).repeat(k)
        view = None if out_rows is None else torch.arange(k * B, dtype=I32, device=dev)
    else:
        cand = cands[:, chosen].reshape(-1)
        src_of_slot = chosen.repeat(k)
        view = None if out_rows is None else (
            torch.arange(k, dtype=I32, device=dev)[:, None] * B + chosen[None, :]
        ).reshape(-1)
    valid = active[src_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)

    if out_rows is None:
        vs, vsnap = state, snap
        rows = None
        cv_safe, pv_safe = cand_safe, partner_safe
    else:
        rows = SP.concat_rows([out_rows, partner_rows])
        vs, vsnap = _views(state, snap, rows)
        cv_safe = torch.where(cand >= 0, view, 0)
        pv_safe = torch.where(partner_valid, k * B + torch.arange(B, dtype=I32, device=dev), 0)
    p_out = vs.replica_partition[cv_safe]
    p_in = vs.replica_partition[pv_safe]

    # occupancy both directions (a broker holds one replica per partition);
    # sharded, both partials merge in ONE collective
    if spmd is None:
        occ_out = _partition_occupancy(state, p_out, valid)
        occ_in = _partition_occupancy(state, p_in, partner_valid, dst_brokers=chosen)
    else:
        part_out, uniq_out = _partition_occupancy(state, p_out, valid, spmd=spmd, merge=False)
        part_in, uniq_in = _partition_occupancy(
            state, p_in, partner_valid, dst_brokers=chosen, spmd=spmd, merge=False
        )
        merged = SP.merge_sums(spmd, {"out": part_out, "in": part_in})
        occ_out = (merged["out"] > 0) | ~uniq_out[:, None]
        occ_in = (merged["in"] > 0) | ~uniq_in[:, None]

    # the wide per-(slot, partner broker) work is column-sharded
    col0, cols = _columns(spmd, B, dev)
    if col0 is None:
        pv_cols, pvalid_cols, p_in_cols, occ_in_cols = pv_safe, partner_valid, p_in, occ_in
        dest_ok_cols = snap.dest_ok
    else:
        nloc = cols.shape[0]
        pvalid_cols = partner_valid[col0:col0 + nloc]
        pv_cols = torch.where(pvalid_cols, pv_safe[col0:col0 + nloc], 0)
        p_in_cols = p_in[col0:col0 + nloc]
        occ_in_cols = occ_in[cols] if chosen is None else occ_in
        dest_ok_cols = snap.dest_ok[cols]
    dst_cols = None if col0 is None else cols

    ok, gain = gain_fn(vs, vsnap, cv_safe, pv_cols, dst_cols)  # [S, B|C]
    not_self = cols[None, :] != src_of_slot[:, None]
    ok = ok & pvalid_cols[None, :] & valid[:, None] & not_self
    ok = ok & dest_ok_cols[None, :] & snap.dest_ok[src_of_slot][:, None]
    ok = ok & (p_out[:, None] != p_in_cols[None, :])
    occ_out_c = SP.slice_cols(col0 is not None, occ_out, col0, cols.shape[0])
    if chosen is None:
        ok = ok & ~occ_out_c & ~occ_in_cols[:, src_of_slot].T
    else:
        S_ = src_of_slot.shape[0]
        m_of_slot = torch.arange(S_, dtype=torch.int64, device=dev) % chosen.shape[0]
        term = occ_in[:, m_of_slot].T
        ok = ok & ~occ_out_c & SP.slice_cols(col0 is not None, ~term, col0, cols.shape[0])
    # prior-goal acceptance with the swap's NET deltas
    ok = ok & swap_dst_matrix(
        vs, ctx, vsnap, cv_safe, valid, pv_cols, pvalid_cols, prior_mask, dst_brokers=dst_cols
    )

    score = _plus_jitter(gain, cand_safe[:, None], cols[None, :], salt)
    score = torch.where(ok, score, NEG)
    dst, found = _pick_dst(spmd, score, col0)

    replica = torch.where(valid & found, cand_safe, -1)
    dst_safe = torch.where(replica >= 0, dst, 0)
    return MoveBatch(
        kind=KIND_SWAP,
        replica=replica,
        dst_broker=torch.where(replica >= 0, dst, -1),
        dst_replica=torch.where(replica >= 0, partner[dst_safe], -1),
        score=torch.where(replica >= 0, src_need[src_of_slot], 0.0),
        windows=windows,
        rows=rows,
        view_replica=None if rows is None else torch.where(replica >= 0, view, -1),
        view_dst_replica=None if rows is None else torch.where(replica >= 0, k * B + dst_safe, -1),
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
    dst_fn: DstFn,             # dst_fn(vs, vsnap, cand i32[S]) -> (elig, score) [S, D]
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
    cands, rows = _topk_with_rows(state, snap, cand_score, seg, D, cand_ok & on_disk, k)
    chosen, windows = _cap_sources(src_need, ctx.max_active_brokers, salt)
    if chosen is None:
        cand = cands.reshape(-1)                                # slot = j*D + d
        src_disk_of_slot = torch.arange(D, dtype=I32, device=dev).repeat(k)
        view = None if rows is None else torch.arange(k * D, dtype=I32, device=dev)
    else:
        cand = cands[:, chosen].reshape(-1)
        src_disk_of_slot = chosen.repeat(k)
        view = None if rows is None else (
            torch.arange(k, dtype=I32, device=dev)[:, None] * D + chosen[None, :]
        ).reshape(-1)
    S = cand.shape[0]
    valid = active[src_disk_of_slot] & (cand >= 0)
    cand_safe = torch.where(cand >= 0, cand, 0)
    vs, vsnap = _views(state, snap, rows)
    cv_safe = cand_safe if view is None else torch.where(cand >= 0, view, 0)

    elig, score = dst_fn(vs, vsnap, cv_safe)
    cols = torch.arange(D, dtype=I32, device=dev)
    same_broker = state.disk_broker[None, :] == vs.replica_broker[cv_safe][:, None]
    not_self = cols[None, :] != src_disk_of_slot[:, None]
    elig = elig & same_broker & not_self & snap.disk_usable[None, :] & valid[:, None]
    score = _plus_jitter(score, cand_safe[:, None], cols[None, :], salt)
    score = torch.where(elig, score, NEG)
    dst, found = _argmax_rows(score)

    replica = torch.where(valid & found, cand_safe, -1)
    return MoveBatch(
        kind=KIND_INTRA_MOVE,
        replica=replica,
        dst_broker=torch.where(replica >= 0, vs.replica_broker[cv_safe], -1),
        dst_replica=torch.full((S,), -1, dtype=I32, device=dev),
        score=torch.where(replica >= 0, src_need[src_disk_of_slot], 0.0),
        dst_disk=torch.where(replica >= 0, dst, -1),
        windows=windows,
        rows=rows,
        view_replica=None if rows is None else torch.where(replica >= 0, view, -1),
        view_dst_replica=None if rows is None else torch.full((S,), -1, dtype=I32, device=dev),
    )
