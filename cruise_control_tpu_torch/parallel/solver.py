"""Rank-sharded goal optimizer: the scale-out solver.

Port of ``cruise_control_tpu/parallel/solver.py``.  ``ShardedGoalOptimizer``
runs the exact solver of :mod:`analyzer.optimizer` with the replica axis
sharded over the ranks of a :class:`~.mesh.Mesh` (each rank a process; every
rank calls ``optimize`` on the same host-side state and keeps its own
contiguous block).  Two paths:

* **SPMD (default)**: the same step functions run on each rank's block with
  a :class:`~.spmd.SpmdInfo`, which switches the kernels to local-block
  mode: per snapshot one min merge and one fold over the ranks (every
  snapshot sum, the float sums in global row order), then per round the
  gathers of the candidate top-k and of the column-sharded destination
  choice and one merge for partition occupancy.
* **Gather path**: for goal lists the SPMD kernels do not cover
  (PreferredLeaderElectionGoal and the kafka-assigner goals read replica rows
  outside the merged candidate tables) and under ``CC_TPU_SHARDED_SPMD=0``.
  The JAX package sends these to GSPMD, which has no PyTorch counterpart;
  here ONE counted all_gather assembles the replica axis and the
  single-device solver runs replicated on every rank.

Either way the result equals the single-device solve: sharding is an
execution detail, never a semantics change.  ``optimize`` returns the whole
final state on every rank, its replica axis padded to a multiple of the
world (trim it to the input's ``num_replicas``), as the JAX solver returns
its sharded global arrays.
"""

from __future__ import annotations

import os
from typing import Optional

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.parallel.mesh import Mesh, gather_state, replicate, shard_state, solver_mesh
from cruise_control_tpu_torch.parallel.spmd import SpmdInfo

#: goals whose kernels need replica-axis work outside the merged candidate
#: tables (whole-axis sorts, gathers at preferred-leader ids): goal lists
#: holding any of them take the gather path
UNSUPPORTED_SPMD_GOALS = frozenset(
    {G.PREFERRED_LEADER_ELECTION, G.KAFKA_ASSIGNER_RACK, G.KAFKA_ASSIGNER_DISK}
)


def spmd_supported(goal_ids) -> bool:
    """Whether the SPMD path covers this goal list."""
    return not (set(goal_ids) & UNSUPPORTED_SPMD_GOALS)


class ShardedGoalOptimizer(GoalOptimizer):
    """GoalOptimizer over a rank mesh (replica-axis data parallelism).  Call
    ``optimize`` on every rank of the mesh with the same inputs; ``device``
    is the mesh's."""

    def __init__(self, mesh: Optional[Mesh] = None, **kwargs) -> None:
        mesh = mesh if mesh is not None else solver_mesh(device=kwargs.get("device"))
        kwargs["device"] = mesh.device
        super().__init__(**kwargs)
        self.mesh = mesh

    @property
    def use_spmd(self) -> bool:
        """The SPMD path is on: the goal list is supported and
        ``CC_TPU_SHARDED_SPMD`` is not ``0`` / ``false`` (the A/B switch)."""
        if os.environ.get("CC_TPU_SHARDED_SPMD", "1") in ("0", "false"):
            return False
        return spmd_supported(self.goal_ids)

    def _whole(self, state: ClusterArrays) -> ClusterArrays:
        if self._spmd is None:
            return state
        return gather_state(state, self.mesh)

    def optimize(self, state: ClusterArrays, ctx: GoalContext, maps=None, **kw):
        # bucket BEFORE sharding: the broker padding is host-side, and each
        # rank then cuts its block out of the same padded state
        state, ctx = state.to(self.device), ctx.to(self.device)
        state, ctx, unbucket = self._bucketed(state, ctx)
        local = shard_state(state, self.mesh)
        ctx = replicate(ctx, self.mesh)
        if not self.use_spmd:
            whole = gather_state(local, self.mesh)
            final, result = self._optimize_core(whole, ctx, maps=maps, **kw)
            return unbucket(final), result
        self._spmd = SpmdInfo(mesh=self.mesh, n=self.mesh.world, global_R=local.num_replicas * self.mesh.world)
        try:
            final, result = self._optimize_core(local, ctx, maps=maps, **kw)
        finally:
            self._spmd = None
        return unbucket(final), result
