"""Batched balancing actions and round admission.

Port of ``cruise_control_tpu/analyzer/moves.py``.  A
:class:`MoveBatch` is a fixed-shape batch of K candidate actions of one kind;
invalid slots carry ``replica == -1``.  Admission keeps at most one action per
partition per round and checks per-broker budgets against score-ordered
cumulative deltas, so many actions per broker can land in one round while
each stays acceptable to every prior goal.  Swaps keep one action per broker.

Under the sharded solver a batch also carries its replicated candidate-row
table (``rows``, :class:`parallel.spmd.ReplicaRows`) and each slot's position
in it: the slot pipeline reads the table through :func:`batch_views`, and
:func:`apply_moves` writes only the rows this rank owns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops.index import cumsum, fresh_index_put, scatter_set, segment_max, segment_min

I32 = torch.int32
F32 = torch.float32
_NEG = -3e38
_BIG = 2**30

# ActionType (ActionType.java:23-28).
KIND_REPLICA_MOVE = 0
KIND_LEADERSHIP = 1
KIND_SWAP = 2
KIND_INTRA_MOVE = 3


@dataclasses.dataclass
class MoveBatch:
    """K candidate actions of a single kind (slots with replica < 0 are no-ops).

    ``kind`` is a Python int: a round function builds one kind of batch, so
    the per-kind branches below are host-side choices, not tensor selects."""

    kind: int
    replica: torch.Tensor      # i32[K] source replica (LEADERSHIP: current leader)
    dst_broker: torch.Tensor   # i32[K] destination broker
    dst_replica: torch.Tensor  # i32[K] swap partner / new leader replica; -1 otherwise
    score: torch.Tensor        # f32[K] admission priority (higher admits first)
    dst_disk: Optional[torch.Tensor] = None
    #: i32 0-d: rotating source windows this round's cap spans; the phase loop
    #: needs that many zero-move rounds in a row before it declares convergence
    windows: Optional[torch.Tensor] = None
    #: sharded solver: the replicated candidate-row table the replica /
    #: dst_replica ids were drawn from and each slot's position in it (-1: a
    #: hole).  None single-device: consumers gather from the replica axis.
    rows: Optional[object] = None
    view_replica: Optional[torch.Tensor] = None
    view_dst_replica: Optional[torch.Tensor] = None

    @property
    def num_slots(self) -> int:
        return self.replica.shape[0]

    @property
    def valid(self) -> torch.Tensor:
        return self.replica >= 0


@dataclasses.dataclass
class MoveEffects:
    """Per-slot state deltas shared by all acceptance kernels (single-action
    deltas, or score-ordered cumulative ones during admission)."""

    src_broker: torch.Tensor   # i32[K]
    dst_broker: torch.Tensor   # i32[K]
    partition: torch.Tensor    # i32[K]
    delta_src: torch.Tensor    # f32[K, 4]
    delta_dst: torch.Tensor    # f32[K, 4]
    count_delta: torch.Tensor       # i32[K] replica-count change at dst
    leader_delta_src: torch.Tensor  # i32[K]
    leader_delta_dst: torch.Tensor  # i32[K]
    pnw_delta_dst: torch.Tensor     # f32[K]
    lbi_delta_dst: torch.Tensor     # f32[K]
    valid: torch.Tensor        # bool[K]


def batch_views(state: ClusterArrays, snap, moves: MoveBatch):
    """``(vs, vsnap, r_ids, rb_ids)``: the replica axis this batch's slot ids
    index.  Single-device the real state and snapshot with the global ids;
    sharded the surrogate whose replica axis is the batch's row table, with
    the slot ids translated to table positions."""
    if moves.rows is None:
        return state, snap, moves.replica, moves.dst_replica
    from cruise_control_tpu_torch.parallel.spmd import surrogate_views

    vs, vsnap = surrogate_views(state, snap, moves.rows)
    return vs, vsnap, moves.view_replica, moves.view_dst_replica


def move_effects(state: ClusterArrays, moves: MoveBatch, snap=None) -> MoveEffects:
    """Per-broker load/count deltas of each candidate action.  A moved replica
    carries its effective load (base + is_leader * delta); a leadership move
    carries the partition's leadership delta.  ``snap`` supplies the round's
    effective loads and, sharded, the candidate-row view."""
    if snap is None:
        eff = A.effective_load(state)
        lead = A.is_leader(state)
        r_ids, rb_ids = moves.replica, moves.dst_replica
    else:
        state, snap, r_ids, rb_ids = batch_views(state, snap, moves)
        eff = snap.eff_load
        lead = snap.is_leader
    ok = moves.replica >= 0
    r = torch.where(ok, r_ids, 0)
    p = state.replica_partition[r]
    src = state.replica_broker[r]
    kind = moves.kind
    has_partner = moves.dst_replica >= 0
    rb = torch.where(has_partner, rb_ids, 0)
    ldelta = state.leadership_delta[p]
    zero_f = torch.zeros_like(ldelta)

    if kind == KIND_REPLICA_MOVE:
        delta_src, delta_dst = -eff[r], eff[r]
    elif kind == KIND_LEADERSHIP:
        delta_src, delta_dst = -ldelta, ldelta
    elif kind == KIND_SWAP:
        delta_src, delta_dst = eff[rb] - eff[r], eff[r] - eff[rb]
    else:  # intra-broker logdir moves change no broker-level quantity
        delta_src, delta_dst = zero_f, zero_f

    r_leads = lead[r].to(I32)
    rb_leads = (lead[rb] & has_partner).to(I32)
    if kind == KIND_REPLICA_MOVE:
        lsrc = -r_leads
    elif kind == KIND_LEADERSHIP:
        lsrc = torch.full_like(r_leads, -1)
    elif kind == KIND_SWAP:
        lsrc = rb_leads - r_leads
    else:
        lsrc = torch.zeros_like(r_leads)
    ldst = -lsrc
    cnt = torch.full_like(r_leads, 1 if kind == KIND_REPLICA_MOVE else 0)

    leader_nw = state.base_load[r, Resource.NW_OUT] + state.leadership_delta[p, Resource.NW_OUT]
    partner_nw = (
        state.base_load[rb, Resource.NW_OUT]
        + state.leadership_delta[state.replica_partition[rb], Resource.NW_OUT]
    )
    nw_in_r = eff[r, Resource.NW_IN]
    nw_in_rb = eff[rb, Resource.NW_IN]
    r_lead_b = r_leads.bool()
    zero = torch.zeros_like(leader_nw)
    if kind == KIND_REPLICA_MOVE:
        pnw = leader_nw
        lbi = torch.where(r_lead_b, nw_in_r, 0.0)
    elif kind == KIND_LEADERSHIP:
        pnw = zero
        lbi = nw_in_r
    elif kind == KIND_SWAP:
        pnw = leader_nw - partner_nw
        lbi = torch.where(r_lead_b, nw_in_r, 0.0) - torch.where(rb_leads.bool(), nw_in_rb, 0.0)
    else:
        pnw = zero
        lbi = zero

    return MoveEffects(
        src_broker=src,
        dst_broker=torch.where(ok, moves.dst_broker, 0),
        partition=p,
        delta_src=torch.where(ok[:, None], delta_src, 0.0),
        delta_dst=torch.where(ok[:, None], delta_dst, 0.0),
        count_delta=torch.where(ok, cnt, 0),
        leader_delta_src=torch.where(ok, lsrc, 0),
        leader_delta_dst=torch.where(ok, ldst, 0),
        pnw_delta_dst=torch.where(ok, pnw, 0.0),
        lbi_delta_dst=torch.where(ok, lbi, 0.0),
        valid=ok,
    )


def _keep_best_per_key(
    keep: torch.Tensor, key: torch.Tensor, score: torch.Tensor, num_keys: int
) -> torch.Tensor:
    """bool[K]: among slots with equal ``key``, keep only the highest-score one
    (exact-score ties: lowest slot index)."""
    k = torch.where(keep, key, 0)
    s = torch.where(keep, score, _NEG)
    best = segment_max(s, k, num_keys)
    hit = keep & (s >= best[k]) & (s > _NEG / 2)
    idx = torch.arange(key.shape[0], dtype=I32, device=key.device)
    first = segment_min(torch.where(hit, idx, _BIG), k, num_keys)
    return hit & (idx == first[k])


def _score_rank(moves: MoveBatch, candidate: torch.Tensor) -> torch.Tensor:
    """i32[K]: admission order (0 = first), non-candidates last, ties by index."""
    s = torch.where(candidate, moves.score, _NEG)
    order = torch.argsort(-s, stable=True)
    K = moves.num_slots
    rank = torch.empty(K, dtype=I32, device=s.device)
    return fresh_index_put(rank, order, torch.arange(K, dtype=I32, device=s.device))


def _segment_rank_cumsum(vals: torch.Tensor, key: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """f32[K, C]: per-slot inclusive cumsum of ``vals`` (>= 0) over slots sharing
    ``key``, accumulated in ``rank`` order."""
    K = vals.shape[0]
    # lexsort((rank, key)): stable sort by rank, then stable sort by key
    by_rank = torch.argsort(rank, stable=True)
    order = by_rank[torch.argsort(key[by_rank], stable=True)]
    v = vals[order]
    kk = key[order]
    c = cumsum(v)
    e = c - v  # exclusive cumsum, nondecreasing per channel within a segment
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=kk.device), kk[1:] != kk[:-1]])
    seg_id = torch.cumsum(is_start.to(I32), 0, dtype=I32) - 1
    base = segment_min(e, seg_id, K)  # value at segment start
    cum_incl = e - base[seg_id] + v
    out = torch.empty_like(vals)
    out[order] = cum_incl
    return out


def cumulative_effects(
    state: ClusterArrays, moves: MoveBatch, eff: MoveEffects, candidate: torch.Tensor
) -> MoveEffects:
    """MoveEffects whose deltas are score-ordered cumulative sums per broker:
    positive parts summed at destinations, negative parts at sources."""
    rank = _score_rank(moves, candidate)
    cmask = candidate[:, None]

    dst_pos = torch.cat(
        [
            torch.clamp(eff.delta_dst, min=0.0),
            torch.clamp(eff.count_delta, min=0)[:, None].to(F32),
            torch.clamp(eff.leader_delta_dst, min=0)[:, None].to(F32),
            torch.clamp(eff.pnw_delta_dst, min=0.0)[:, None],
            torch.clamp(eff.lbi_delta_dst, min=0.0)[:, None],
        ],
        dim=1,
    )
    dst_pos = torch.where(cmask, dst_pos, 0.0)
    src_neg = torch.cat(
        [
            torch.clamp(-eff.delta_src, min=0.0),
            torch.clamp(-eff.leader_delta_src, min=0)[:, None].to(F32),
        ],
        dim=1,
    )
    src_neg = torch.where(cmask, src_neg, 0.0)

    cum_dst = _segment_rank_cumsum(dst_pos, eff.dst_broker, rank)
    cum_src = _segment_rank_cumsum(src_neg, eff.src_broker, rank)

    return MoveEffects(
        src_broker=eff.src_broker,
        dst_broker=eff.dst_broker,
        partition=eff.partition,
        delta_src=-cum_src[:, :4],
        delta_dst=cum_dst[:, :4],
        count_delta=torch.round(cum_dst[:, 4]).to(I32),
        leader_delta_src=-torch.round(cum_src[:, 4]).to(I32),
        leader_delta_dst=torch.round(cum_dst[:, 5]).to(I32),
        pnw_delta_dst=cum_dst[:, 6],
        lbi_delta_dst=cum_dst[:, 7],
        valid=eff.valid & candidate,
    )


def admit(
    state: ClusterArrays,
    ctx,
    snap,
    moves: MoveBatch,
    accepted: torch.Tensor,
    eff: Optional[MoveEffects] = None,
    admit_mask=None,
) -> torch.Tensor:
    """bool[K]: the subset of accepted slots safe to apply together.

    ``accepted`` is the per-slot single-action acceptance against the pre-round
    snapshot; ``admit_mask`` names the goals whose per-broker budgets bound the
    cumulative admission (normally prior goals plus the round's own goal)."""
    from cruise_control_tpu_torch.analyzer.acceptance import accept_all

    if eff is None:
        eff = move_effects(state, moves, snap)
    vstate, _, r_ids, rb_ids = batch_views(state, snap, moves)
    keep = accepted & eff.valid
    # exactly one action per partition per round (partition-level invariants)
    keep = _keep_best_per_key(keep, eff.partition, moves.score, state.num_partitions)

    if moves.dst_disk is not None:
        # intra-broker logdir moves: serialize per destination and source disk
        nd = max(state.num_disks, 1)
        dd = torch.where(keep, moves.dst_disk, 0)
        keep = _keep_best_per_key(keep, dd, moves.score, nd)
        src_disk = vstate.replica_disk[torch.where(keep, r_ids, 0)]
        sd = torch.where(keep & (src_disk >= 0), src_disk, 0)
        return _keep_best_per_key(keep, sd, moves.score, nd)

    if moves.kind == KIND_SWAP:
        # swaps exchange signed loads: one action per broker keeps single-action
        # acceptance against the pre-round snapshot exact
        k2 = _keep_best_per_key(keep, eff.dst_broker, moves.score, state.num_brokers)
        k2 = _keep_best_per_key(k2, eff.src_broker, moves.score, state.num_brokers)
        dst_part = vstate.replica_partition[torch.where(moves.dst_replica >= 0, rb_ids, 0)]
        return _keep_best_per_key(k2, dst_part, moves.score, state.num_partitions)

    if admit_mask is None:
        return keep
    eff_cum = cumulative_effects(state, moves, eff, keep)
    return keep & accept_all(state, ctx, snap, moves, eff_cum, admit_mask)


def resolve_conflicts(
    state: ClusterArrays,
    moves: MoveBatch,
    accepted: torch.Tensor,
    eff: Optional[MoveEffects] = None,
) -> torch.Tensor:
    """Conservative resolution: at most one action per source broker,
    destination broker and partition (and, for swaps, partner partition)."""
    if eff is None:
        eff = move_effects(state, moves)
    keep = accepted & eff.valid
    keep = _keep_best_per_key(keep, eff.partition, moves.score, state.num_partitions)
    keep = _keep_best_per_key(keep, eff.dst_broker, moves.score, state.num_brokers)
    keep = _keep_best_per_key(keep, eff.src_broker, moves.score, state.num_brokers)
    if moves.kind == KIND_SWAP:
        dst_part = state.replica_partition[torch.where(moves.dst_replica >= 0, moves.dst_replica, 0)]
        keep = _keep_best_per_key(keep, dst_part, moves.score, state.num_partitions)
    return keep


def apply_moves(state: ClusterArrays, moves: MoveBatch, keep: torch.Tensor, spmd=None) -> ClusterArrays:
    """Apply the surviving slots as batched scatters.

    Sharded (``spmd``): the ids are global and each rank applies only the
    updates that land in its own rows, with no communication; the
    partition-axis update (``partition_leader``) is replicated and reads
    every replica attribute from the batch's row table, so all ranks write
    the same values.  A negative index wraps in a PyTorch (and a JAX
    ``mode="drop"``) scatter, so an id owned by a lower rank, negative after
    the offset shift, is sent out of range explicitly."""
    sel = torch.where(keep, moves.replica, -1)
    if spmd is None:
        sel_local = sel
    else:
        sel_local = torch.where(sel >= 0, sel - spmd.offset(), -1)
    if moves.dst_disk is not None:
        return A.relocate_replica_disks(state, sel_local, moves.dst_disk)
    if moves.kind == KIND_REPLICA_MOVE:
        return A.relocate_replicas(state, sel_local, moves.dst_broker)
    if moves.kind == KIND_LEADERSHIP:
        if moves.rows is None:
            p = torch.where(sel >= 0, state.replica_partition[torch.clamp(sel, min=0)], -1)
        else:
            p = torch.where(sel >= 0, moves.rows.partition[torch.clamp(moves.view_replica, min=0)], -1)
        return A.relocate_leadership(state, p, moves.dst_replica)
    if moves.kind == KIND_SWAP:
        partner = torch.where(keep, moves.dst_replica, -1)
        if moves.rows is None:
            return A.swap_replicas(state, sel, partner)
        # each endpoint's NEW broker comes from the row table; both scatters
        # write owner-local rows only
        ok = (sel >= 0) & (partner >= 0)
        n = state.num_replicas
        ba = moves.rows.broker[torch.clamp(moves.view_replica, min=0)]
        bb = moves.rows.broker[torch.clamp(moves.view_dst_replica, min=0)]
        off = spmd.offset() if spmd is not None else 0
        la = sel - off
        lb = partner - off
        sa = torch.where(ok & (la >= 0), la, n)
        sb = torch.where(ok & (lb >= 0), lb, n)
        brokers = scatter_set(state.replica_broker, sa, bb)
        brokers = scatter_set(brokers, sb, ba)
        disks = scatter_set(state.replica_disk, sa, -1)
        disks = scatter_set(disks, sb, -1)
        return state.replace(replica_broker=brokers, replica_disk=disks)
    raise ValueError(f"apply_moves: unknown move kind {moves.kind}")
