"""Explicit replica-axis collectives: the four primitives of a sharded axis.

Port of ``cruise_control_tpu/parallel/sharded.py``.  Each rank passes its
own contiguous block of a replica-axis tensor (rank ``r`` owns global rows
``[r * n, (r + 1) * n)``); replicated inputs (ids, updates) are the same on
every rank, and every result is replicated unless it is a block:

* :func:`sharded_segment_sum` -- per-broker aggregation through the
  segment-sum kernels: float values fold over the ranks in rank order (the
  single-device row-order sum, bit for bit), integer and bool values sum
  locally and merge in one ``all_reduce``;
* :func:`sharded_segment_argmax` -- candidate selection: ties go to the
  lowest GLOBAL index, as ``analyzer.context.segment_argmax`` breaks them;
* :func:`sharded_gather` -- read at global ids: each rank contributes the
  ids it owns, zero elsewhere (negative ids read 0), one merge;
* :func:`sharded_scatter_set` -- write back to this rank's block: only the
  updates whose global id falls in its range apply; no communication.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.ops.index import scatter_set
from cruise_control_tpu_torch.parallel.mesh import Mesh
from cruise_control_tpu_torch.parallel.spmd import SpmdInfo, argmax_ids_merge, merge_sums, spmd_segment_sum


def _info(mesh: Mesh, local_rows: int) -> SpmdInfo:
    return SpmdInfo(mesh=mesh, n=mesh.world, global_R=local_rows * mesh.world)


def sharded_segment_sum(mesh: Mesh, vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment sum of this rank's ``vals`` [n] / [n, k] under ``seg``, merged
    over the ranks: float32 for float values, int32 for integer and bool."""
    return spmd_segment_sum(_info(mesh, vals.shape[0]), vals, seg, num_segments)


def sharded_segment_argmax(
    mesh: Mesh, scores: torch.Tensor, seg: torch.Tensor, num_segments: int, eligible: torch.Tensor
) -> torch.Tensor:
    """Replicated i32[num_segments]: global argmax per segment, -1 when
    empty; ties break to the lowest global index."""
    return argmax_ids_merge(_info(mesh, scores.shape[0]), scores, seg, num_segments, eligible)


def _mine(mesh: Mesh, n: int, ids: torch.Tensor):
    local = ids - mesh.rank * n
    return local, (local >= 0) & (local < n) & (ids >= 0)


def sharded_gather(mesh: Mesh, arr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Replicated ``arr[ids]`` of a sharded ``arr`` at replicated global
    ``ids`` (negative ids read 0): one ``[|ids|]``-sized merge instead of
    gathering the replica axis."""
    n = arr.shape[0]
    local, mine = _mine(mesh, n, ids)
    vals = arr[torch.clamp(local, 0, n - 1).long()]
    keep = mine if vals.dim() == 1 else mine.view((-1,) + (1,) * (vals.dim() - 1))
    picked = torch.where(keep, vals, torch.zeros_like(vals))
    return merge_sums(_info(mesh, n), {"g": picked})["g"]


def sharded_scatter_set(mesh: Mesh, arr: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``arr.at[ids].set(vals)``: the replicated updates
    whose global id this rank owns; ids < 0 are no-ops."""
    n = arr.shape[0]
    local, mine = _mine(mesh, n, ids)
    return scatter_set(arr, torch.where(mine, local, n), vals)

