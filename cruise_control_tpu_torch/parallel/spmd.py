"""Replica-axis SPMD support for the solver kernels (the sharded fast path).

Port of ``cruise_control_tpu/parallel/spmd.py``.  Each rank runs the same
solver step on its own block of the replica axis; the kernels consult a
:class:`SpmdInfo` (``None`` single-device: every kernel keeps its exact
single-device path) and merge through the rank mesh:

* :func:`merge_sums` / :func:`merge_mins` -- every partial of one dataflow
  point flattened into ONE ``all_reduce`` each.  Only partials whose sum is
  exact in any order merge this way -- integer and bool counts (riding as
  float32, exact below 2**24) and rows one rank contributes while the others
  send zeros -- so every rank holds the same bits and takes the same
  host-side decisions.
* :func:`chained_segment_sums` -- the float sums: a sum of per-rank float
  partials rounds differently from the single-device sum, which adds every
  row in row order, and at config #2 that difference flipped a decision.
  The snapshot's sums therefore run as ONE fold over the ranks in rank order
  (:meth:`Mesh.fold_ranks`): each rank's kernel call starts from the sums of
  the ranks before it, so the float sums are the single-device row-order
  sums bit for bit, and the snapshot's integer partials ride the same fold.
* :func:`topk_rows_merge` / :func:`argmax_ids_merge` -- candidate selection:
  each rank takes its LOCAL top-k per segment (global replica ids) plus each
  winner's row payload, and ONE all_gather merges them in the single-device
  order (score descending, global id ascending).
* :class:`ReplicaRows` + :func:`surrogate_views` -- the gathered candidate
  rows double as a surrogate replica axis: the slot pipeline (destination
  matrices, acceptance, admission) runs replicated against the table and
  touches no sharded tensor.
* :func:`own_cols` / :func:`colmax_merge` / :func:`coltopk_merge` -- the
  destination-broker axis of the proposer matrices is column-sharded: each
  rank scores its ``B/n`` columns and one small merge recovers the global
  choice with ``torch.argmax``'s first-maximum rule.

The JAX package counts the collectives of a lowered program
(``LOGICAL_COLLECTIVE_OPS``); the port runs eagerly and counts the calls
themselves (:data:`~cruise_control_tpu_torch.parallel.mesh.COLLECTIVES`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.ops.index import scatter_set, segment_max, segment_min
from cruise_control_tpu_torch.ops.segments import segment_sums
from cruise_control_tpu_torch.parallel.mesh import Mesh

#: float32 holds integers exactly below 2**24; candidate ids and integer row
#: fields ride the float32 payloads, so the padded replica axis must stay
#: under this (assert early instead of corrupting ids silently).
MAX_EXACT_F32_INT = 1 << 24

I32 = torch.int32
F32 = torch.float32
NEG = -3e38
_BIG = 2**30


@dataclasses.dataclass(frozen=True)
class SpmdInfo:
    """Replica-axis sharding of one solve: the rank mesh and the PADDED
    global replica count (:func:`~.mesh.pad_replicas` pads to a multiple of
    ``n``).  Rank ``r`` owns rows ``[r * local_R, (r + 1) * local_R)``."""

    mesh: Mesh
    n: int
    global_R: int

    @property
    def local_R(self) -> int:
        return self.global_R // self.n

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def offset(self) -> int:
        """Global index of this rank's first replica row."""
        return self.mesh.rank * self.local_R

    def iota(self) -> torch.Tensor:
        """i32[local_R]: the global replica index of each local row."""
        return torch.arange(self.local_R, dtype=I32, device=self.mesh.device) + self.offset()


def global_iota(state, spmd: Optional[SpmdInfo]) -> torch.Tensor:
    """i32[R_local]: global replica indices (plain ``arange`` single-device)."""
    if spmd is None:
        return torch.arange(state.num_replicas, dtype=I32, device=state.device)
    return spmd.iota()


# -- batched reduction merges -------------------------------------------------------


def merge_sums(spmd: Optional[SpmdInfo], parts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge per-rank partial SUMS in ONE ``all_reduce``.

    ``parts`` maps name -> partial (any shape; float32, int32 or bool) whose
    sum is exact in any order: counts and ids below 2**24, or float rows that
    one rank contributes while every other rank sends zeros.  Integer and
    bool partials ride as float32 and come back in their dtype (bool as "any
    rank").  A float sum that must round as the single-device sum does goes
    through :func:`chained_segment_sums`.  Single-device the partials already
    are the totals."""
    if spmd is None or not parts:
        return dict(parts)
    names = sorted(parts)
    flat = torch.cat([parts[k].to(F32).reshape(-1) for k in names])
    merged = spmd.mesh.all_reduce(flat, "sum")
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for k in names:
        x = parts[k]
        piece = merged[pos:pos + x.numel()].reshape(x.shape)
        if x.dtype == torch.bool:
            piece = piece > 0
        elif not x.dtype.is_floating_point:
            piece = torch.round(piece).to(x.dtype)
        out[k] = piece
        pos += x.numel()
    return out


def merge_mins(spmd: Optional[SpmdInfo], parts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge per-rank partial MINS (int32, big-sentinel convention) in ONE
    ``all_reduce`` (an integer min is exact in any order)."""
    if spmd is None or not parts:
        return dict(parts)
    names = sorted(parts)
    flat = torch.cat([parts[k].to(I32).reshape(-1) for k in names])
    merged = spmd.mesh.all_reduce(flat, "min")
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for k in names:
        n = parts[k].numel()
        out[k] = merged[pos:pos + n].reshape(parts[k].shape)
        pos += n
    return out


def chained_segment_sums(
    spmd: Optional[SpmdInfo],
    calls: Sequence[Tuple[Sequence[torch.Tensor], torch.Tensor, int]],
    parts: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[List[List[torch.Tensor]], Dict[str, torch.Tensor]]:
    """:func:`ops.segments.segment_sums` of each ``(columns, ids, num_segments)``
    call over the whole (possibly sharded) replica axis, in global row order,
    plus the merged sums of ``parts`` (per-rank partials whose sum is exact
    in any order: integer counts below 2**24, rows one rank contributes).

    Sharded, everything runs as ONE fold over the ranks: rank ``r`` receives
    the sums of ranks ``0 .. r-1`` and prepends them to its own block as one
    row per segment, so its kernel call (the fixed-order path, which adds
    each segment's rows in row order) continues the single-device sum where
    the previous rank stopped; it adds its ``parts`` to theirs; the last
    rank's sums go to every rank.  The carry is float32, which holds both
    the float sums and the integers exactly.  Bool columns count into int32,
    as the kernels count them."""
    parts = dict(parts or {})
    if spmd is None:
        return [segment_sums(cols, ids, S) for cols, ids, S in calls], parts
    dev = spmd.mesh.device
    layout = []                      # (shape, dtype) of every carried tensor, in order
    for cols, ids, S in calls:
        layout += [((S,) if c.dim() == 1 else (S, c.shape[1]), F32 if c.dtype.is_floating_point else I32)
                   for c in cols]
    names = sorted(parts)
    layout += [(tuple(parts[k].shape), parts[k].dtype) for k in names]
    sizes = [int(np.prod(shape)) for shape, _ in layout]

    def unpack(flat):
        out = []
        for (shape, dtype), piece in zip(layout, torch.split(flat, sizes)):
            piece = piece.reshape(shape)
            if dtype == torch.bool:
                piece = piece > 0
            elif not dtype.is_floating_point:
                piece = torch.round(piece).to(dtype)
            out.append(piece)
        return out

    def step(carry):
        prev = unpack(carry)
        sums, k = [], 0
        for cols, ids, S in calls:
            seg = torch.cat([torch.arange(S, dtype=I32, device=dev), ids.to(I32)])
            joined = [torch.cat([p, c.to(p.dtype)]) for p, c in zip(prev[k:k + len(cols)], cols)]
            sums += segment_sums(joined, seg, S)
            k += len(cols)
        sums += [p.to(F32) + parts[name].to(F32) for p, name in zip(prev[k:], names)]
        return torch.cat([x.reshape(-1).to(F32) for x in sums])

    flat = spmd.mesh.fold_ranks(torch.zeros(sum(sizes), dtype=F32, device=dev), step)
    merged = unpack(flat)
    out, k = [], 0
    for cols, _, _ in calls:
        out.append(merged[k:k + len(cols)])
        k += len(cols)
    return out, dict(zip(names, merged[k:]))


def spmd_segment_sum(
    spmd: Optional[SpmdInfo], vals: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """One replicated segment sum over the (possibly sharded) replica axis,
    for the round reductions whose inputs depend on earlier merges.  An
    integer or bool column: the local partial through the integer kernel
    (sums come back int32), then one :func:`merge_sums`.  A float column:
    the fold of :func:`chained_segment_sums`, so the sum rounds as the
    single-device row-order sum."""
    if spmd is None or vals.dtype.is_floating_point:
        ((out,),), _ = chained_segment_sums(spmd, [([vals], seg, num_segments)])
        return out
    (local,) = segment_sums([vals], seg, num_segments)
    return merge_sums(spmd, {"s": local})["s"]


# -- candidate rows (the surrogate replica axis) ------------------------------------

#: per-candidate row fields shipped through the collective payloads: every
#: replica-axis value the slot pipeline ever gathers
_ROW_FIELDS = (
    "partition", "broker", "disk", "valid", "is_leader",
    "bl0", "bl1", "bl2", "bl3", "ef0", "ef1", "ef2", "ef3",
)
ROW_F = len(_ROW_FIELDS)


@dataclasses.dataclass
class ReplicaRows:
    """Gathered per-candidate replica fields (replicated; slot-pipeline food)."""

    partition: torch.Tensor   # i32[K]
    broker: torch.Tensor      # i32[K]
    disk: torch.Tensor        # i32[K]
    valid: torch.Tensor       # bool[K]
    is_leader: torch.Tensor   # bool[K]
    base_load: torch.Tensor   # f32[K, 4]
    eff_load: torch.Tensor    # f32[K, 4]


def pack_rows(state, snap, ids_local: torch.Tensor) -> torch.Tensor:
    """f32[..., ROW_F]: row payload at LOCAL replica positions ``ids_local``
    (clamped; callers mask invalid slots downstream)."""
    i = torch.clamp(ids_local, 0, state.num_replicas - 1).long()
    cols = [
        state.replica_partition[i], state.replica_broker[i], state.replica_disk[i],
        state.replica_valid[i], snap.is_leader[i],
        state.base_load[i, 0], state.base_load[i, 1], state.base_load[i, 2], state.base_load[i, 3],
        snap.eff_load[i, 0], snap.eff_load[i, 1], snap.eff_load[i, 2], snap.eff_load[i, 3],
    ]
    return torch.stack([c.to(F32) for c in cols], dim=-1)


def unpack_rows(payload: torch.Tensor) -> ReplicaRows:
    """Inverse of :func:`pack_rows` for a flat ``[K, ROW_F]`` payload."""
    def i32(c):
        return torch.round(payload[..., c]).to(I32)

    return ReplicaRows(
        partition=i32(0), broker=i32(1), disk=i32(2),
        valid=payload[..., 3] > 0, is_leader=payload[..., 4] > 0,
        base_load=payload[..., 5:9].contiguous(), eff_load=payload[..., 9:13].contiguous(),
    )


def concat_rows(rows: Sequence[ReplicaRows]) -> ReplicaRows:
    def cat(f):
        return torch.cat([getattr(r, f) for r in rows])

    return ReplicaRows(**{f.name: cat(f.name) for f in dataclasses.fields(ReplicaRows)})


def surrogate_views(state, snap, rows: ReplicaRows):
    """``(state', snap')`` whose replica axis is the candidate-row table.

    Every slot-pipeline function (the destination matrices, the acceptance
    kernels, ``move_effects``, ``admit``) reads replica data only through
    ``state.replica_*[ids]`` / ``snap.eff_load[ids]`` / ``snap.is_leader[ids]``
    gathers: pointing those tensors at the table and the ids at table
    positions reproduces the single-device math bit for bit.  Broker,
    partition and disk tensors pass through (replicated already)."""
    state_v = state.replace(
        replica_partition=rows.partition,
        replica_broker=rows.broker,
        replica_disk=rows.disk,
        replica_valid=rows.valid,
        base_load=rows.base_load,
        original_broker=rows.broker,
    )
    snap_v = snap.replace(eff_load=rows.eff_load, is_leader=rows.is_leader, spmd=None)
    return state_v, snap_v


# -- merged candidate selection -----------------------------------------------------


def _order_by_score_then_id(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Permutation along dim 0 sorting by (score descending, id ascending):
    two stable sorts, the secondary key first (``lexsort``'s order)."""
    by_id = torch.sort(ids, dim=0, stable=True).indices
    s = torch.gather(scores, 0, by_id)
    by_score = torch.sort(-s, dim=0, stable=True).indices
    return torch.gather(by_id, 0, by_score)


def _local_topk(
    scores: torch.Tensor, seg: torch.Tensor, num_segments: int,
    eligible: torch.Tensor, k: int, gids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local per-segment top-k by (score desc, global id asc): ``(ids,
    scores)``, each ``[k, num_segments]``; ids are GLOBAL, -1 (score NEG)
    where exhausted.  The iterative masked-argmax walk of
    ``proposers.topk_segment_argmax`` on this rank's rows."""
    dev = scores.device
    idx_local = torch.arange(scores.shape[0], dtype=I32, device=dev)
    in_range = (seg >= 0) & (seg < num_segments)
    seg_safe = torch.where(in_range, seg, 0)
    el = eligible
    oob = scores.shape[0]
    out_ids, out_scores = [], []
    for _ in range(k):
        s = torch.where(el, scores, NEG)
        smax = segment_max(s, seg, num_segments)
        hit = el & (s >= smax[seg_safe]) & (s > NEG / 2)
        best_local = segment_min(torch.where(hit, idx_local, _BIG), seg, num_segments)
        found = best_local < _BIG
        safe = torch.where(found, best_local, 0)
        out_ids.append(torch.where(found, gids[safe.long()], -1))
        out_scores.append(torch.where(found, smax, NEG))
        el = scatter_set(el, torch.where(found, best_local, oob), False)
    return torch.stack(out_ids), torch.stack(out_scores)


def _check_exact_ids(spmd: SpmdInfo) -> None:
    assert spmd.global_R < MAX_EXACT_F32_INT, (
        f"replica axis {spmd.global_R} overflows the exact-f32 id payload"
    )


def topk_rows_merge(
    spmd: SpmdInfo, state, snap,
    scores: torch.Tensor, seg: torch.Tensor, num_segments: int,
    eligible: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, ReplicaRows]:
    """Global per-segment top-k over the sharded replica axis, ONE all_gather.

    Returns ``(ids [k, num_segments] global, rows [k * num_segments])``, the
    rows flattened in the ``cands.reshape(-1)`` slot layout.  ``scores``,
    ``seg`` and ``eligible`` are this rank's rows; segment ids are replicated
    quantities (the broker or disk of each local replica)."""
    _check_exact_ids(spmd)
    ids_l, scores_l = _local_topk(scores, seg, num_segments, eligible, k, spmd.iota())
    payload_l = pack_rows(state, snap, ids_l - spmd.offset())        # [k, S, ROW_F]
    bundle = torch.cat([ids_l.to(F32)[..., None], scores_l[..., None], payload_l], dim=-1)
    gathered = spmd.mesh.all_gather(bundle)                          # [n, k, S, 2+ROW_F]
    n, S = gathered.shape[0], gathered.shape[2]
    flat = gathered.reshape(n * k, S, 2 + ROW_F)
    ids_all = torch.round(flat[..., 0]).to(I32)
    sort_id = torch.where(ids_all >= 0, ids_all, _BIG)
    perm = _order_by_score_then_id(flat[..., 1], sort_id)[:k]       # [k, S]
    ids = torch.gather(ids_all, 0, perm)
    payload = torch.gather(flat[..., 2:], 0, perm[..., None].expand(k, S, ROW_F))
    return ids, unpack_rows(payload.reshape(k * S, ROW_F))


def argmax_ids_merge(
    spmd: SpmdInfo, scores: torch.Tensor, seg: torch.Tensor, num_segments: int,
    eligible: torch.Tensor,
) -> torch.Tensor:
    """i32[num_segments]: global segment argmax ids (ties to the lowest
    global id) through one payload-free all_gather -- for LARGE segment
    counts (per-partition follower election), where shipping rows for every
    segment would not scale; :func:`fetch_rows` fetches the rows in use."""
    _check_exact_ids(spmd)
    ids_l, scores_l = _local_topk(scores, seg, num_segments, eligible, 1, spmd.iota())
    bundle = torch.stack([ids_l[0].to(F32), scores_l[0]], dim=-1)
    gathered = spmd.mesh.all_gather(bundle)                          # [n, S, 2]
    ids_all = torch.round(gathered[..., 0]).to(I32)
    sort_id = torch.where(ids_all >= 0, ids_all, _BIG)
    perm = _order_by_score_then_id(gathered[..., 1], sort_id)[:1]
    return torch.gather(ids_all, 0, perm)[0]


def own_cols(spmd: SpmdInfo, ncols: int) -> Tuple[int, torch.Tensor, int]:
    """``(col0, ids, n_local)``: this rank's contiguous slice of a column
    axis.  Each rank evaluates destination eligibility and score for its
    ``ncols / n`` columns only, and ONE small merge recovers the global
    choice.  Requires ``n | ncols`` (the broker bucket ladder is powers of
    two; callers take full columns otherwise)."""
    nloc = ncols // spmd.n
    col0 = spmd.rank * nloc
    return col0, torch.arange(col0, col0 + nloc, dtype=I32, device=spmd.mesh.device), nloc


def colmax_merge(spmd: SpmdInfo, score_own: torch.Tensor, col0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(best_score [S], best_col [S])``: the global per-row column argmax
    from each rank's ``[S, ncols/n]`` slice, ties to the lowest global column
    -- ``torch.argmax`` over the full row (first maximum)."""
    local_c = torch.argmax(score_own, dim=1).to(I32)
    local_s = torch.gather(score_own, 1, local_c[:, None].long())[:, 0]
    bundle = torch.stack([local_s, (local_c + col0).to(F32)], dim=-1)
    gathered = spmd.mesh.all_gather(bundle)                          # [n, S, 2]
    perm = _order_by_score_then_id(gathered[..., 0], gathered[..., 1])[:1]
    best = torch.gather(gathered, 0, perm[..., None].expand(1, perm.shape[1], 2))[0]
    return best[:, 0], torch.round(best[:, 1]).to(I32)


def coltopk_merge(
    spmd: SpmdInfo, score_own: torch.Tensor, col0: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores [k, S], cols [k, S])``: the global per-row top-k columns by
    (score desc, col asc) from each rank's column slice -- the merge form of
    the iterative argmax-then-mask column walk."""
    S, nloc = score_own.shape
    dev = score_own.device
    kk = min(k, nloc)
    sc = score_own
    rows = torch.arange(S, dtype=torch.int64, device=dev)
    loc_s, loc_c = [], []
    for _ in range(kk):
        c = torch.argmax(sc, dim=1)
        loc_s.append(torch.gather(sc, 1, c[:, None])[:, 0])
        loc_c.append(c.to(I32) + col0)
        sc = sc.clone()
        sc[rows, c] = NEG
    for _ in range(k - kk):
        loc_s.append(torch.full((S,), NEG, dtype=F32, device=dev))
        loc_c.append(torch.zeros(S, dtype=I32, device=dev))
    bundle = torch.stack([torch.stack(loc_s), torch.stack(loc_c).to(F32)], dim=-1)   # [k, S, 2]
    gathered = spmd.mesh.all_gather(bundle)                          # [n, k, S, 2]
    flat = gathered.reshape(-1, S, 2)
    perm = _order_by_score_then_id(flat[..., 0], flat[..., 1])[:k]
    s_sorted = torch.gather(flat[..., 0], 0, perm)
    c_sorted = torch.gather(flat[..., 1], 0, perm)
    return s_sorted, torch.round(c_sorted).to(I32)


def slice_cols(spmd_active: bool, x: torch.Tensor, col0, nloc: int) -> torch.Tensor:
    """``x[..., col0:col0 + nloc]`` (a no-op single-device)."""
    if not spmd_active:
        return x
    return x[..., col0:col0 + nloc]


def fetch_rows(
    spmd: SpmdInfo, state, snap, ids: torch.Tensor,
    extra_parts: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[ReplicaRows, Dict[str, torch.Tensor]]:
    """Rows for replicated global ``ids`` (i32[K], -1 = hole) in ONE merge:
    each rank contributes the rows it owns (zero elsewhere), so the merged
    sum adds each row to zeros only and is exact.  ``extra_parts`` batches
    other sum merges into the same collective."""
    local = ids - spmd.offset()
    m = state.num_replicas
    mine = (local >= 0) & (local < m) & (ids >= 0)
    payload = pack_rows(state, snap, torch.where(mine, local, 0))
    payload = torch.where(mine[:, None], payload, 0.0)
    parts = {"__rows__": payload}
    if extra_parts:
        parts.update(extra_parts)
    merged = merge_sums(spmd, parts)
    rows = unpack_rows(merged.pop("__rows__"))
    return rows, merged
