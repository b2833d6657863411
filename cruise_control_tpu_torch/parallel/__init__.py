"""Scale-out layer: the rank mesh, replica-axis sharding, the collectives.

Port of ``cruise_control_tpu/parallel/`` on ``torch.distributed``:
``parallel.mesh`` (the :class:`Mesh` of a process group, the layout and the
counted collective layer), ``parallel.launch`` (:func:`run_ranks`, one
process per rank), ``parallel.spmd`` (the merges the solver kernels consult
on a rank's block), ``parallel.sharded`` (the explicit primitives) and
``parallel.solver`` (the sharded GoalOptimizer).
"""

from cruise_control_tpu_torch.parallel.mesh import (
    REPLICA_AXIS,
    Mesh,
    pad_replicas,
    replicate,
    shard_state,
    solver_mesh,
)

__all__ = [
    "REPLICA_AXIS",
    "Mesh",
    "ShardedGoalOptimizer",
    "pad_replicas",
    "replicate",
    "run_ranks",
    "shard_state",
    "solver_mesh",
]


def __getattr__(name):
    # lazy: parallel.solver imports analyzer.optimizer, whose modules import
    # parallel.spmd; resolving the solver on first attribute access keeps
    # the package import acyclic
    if name == "ShardedGoalOptimizer":
        from cruise_control_tpu_torch.parallel.solver import ShardedGoalOptimizer

        return ShardedGoalOptimizer
    if name == "run_ranks":
        from cruise_control_tpu_torch.parallel.launch import run_ranks

        return run_ranks
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
