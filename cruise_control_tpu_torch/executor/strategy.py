"""Replica movement strategies: ordering of inter-broker move tasks.

Port of ``cruise_control_tpu/executor/strategy.py``.

Counterpart of ``executor/strategy/`` — the chainable ``ReplicaMovementStrategy``
SPI with the reference's shipped implementations (ExecutionTaskPlanner.java:68 uses
the configured chain, defaulting to ``BaseReplicaMovementStrategy``).  A strategy
produces a sort key per task; chaining compares lexicographically, exactly like the
reference's ``ReplicaMovementStrategy.chain``.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence, Set

from cruise_control_tpu_torch.backend.base import TopicPartition
from cruise_control_tpu_torch.executor.tasks import ExecutionTask


class StrategyContext:
    """Cluster facts strategies may consult (URP/minISR sets, partition sizes)."""

    def __init__(
        self,
        under_replicated: Optional[Set[TopicPartition]] = None,
        under_min_isr: Optional[Set[TopicPartition]] = None,
        one_above_min_isr: Optional[Set[TopicPartition]] = None,
    ) -> None:
        self.under_replicated = under_replicated or set()
        self.under_min_isr = under_min_isr or set()
        self.one_above_min_isr = one_above_min_isr or set()


class ReplicaMovementStrategy(abc.ABC):
    @abc.abstractmethod
    def sort_key(self, task: ExecutionTask, ctx: StrategyContext):
        """Lower sorts earlier."""

    def chain(self, nxt: "ReplicaMovementStrategy") -> "ReplicaMovementStrategy":
        return _Chained(self, nxt)

    @property
    def name(self) -> str:
        return type(self).__name__


class _Chained(ReplicaMovementStrategy):
    def __init__(self, first: ReplicaMovementStrategy, second: ReplicaMovementStrategy):
        self.first, self.second = first, second

    def sort_key(self, task, ctx):
        return (self.first.sort_key(task, ctx), self.second.sort_key(task, ctx))

    @property
    def name(self) -> str:
        return f"{self.first.name}->{self.second.name}"


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    """Default: stable task-id order (BaseReplicaMovementStrategy.java)."""

    def sort_key(self, task, ctx):
        return task.task_id


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    def sort_key(self, task, ctx):
        return task.proposal.partition_size


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    def sort_key(self, task, ctx):
        return -task.proposal.partition_size


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move healthy (fully-replicated) partitions first."""

    def sort_key(self, task, ctx):
        return 1 if task.proposal.tp in ctx.under_replicated else 0


class PrioritizeMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    """(At/Under)-minISR partitions with offline replicas go first."""

    def sort_key(self, task, ctx):
        return 0 if task.proposal.tp in ctx.under_min_isr else 1


class PrioritizeOneAboveMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    def sort_key(self, task, ctx):
        return 0 if task.proposal.tp in ctx.one_above_min_isr else 1


def chain_strategies(
    strategies: Sequence[ReplicaMovementStrategy],
) -> ReplicaMovementStrategy:
    """Fold a list into one lexicographic strategy, always ending with the base
    strategy as the deterministic tiebreaker (reference appends it when absent)."""
    chain: ReplicaMovementStrategy = BaseReplicaMovementStrategy()
    if not strategies:
        return chain
    out = strategies[0]
    for s in strategies[1:]:
        out = out.chain(s)
    if not isinstance(strategies[-1], BaseReplicaMovementStrategy):
        out = out.chain(chain)
    return out
