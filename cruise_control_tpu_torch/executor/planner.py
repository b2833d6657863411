"""ExecutionTaskPlanner: proposals → ordered, concurrency-capped task batches.

Port of ``cruise_control_tpu/executor/planner.py``.

Counterpart of ``executor/ExecutionTaskPlanner.java:68``: splits each
:class:`ExecutionProposal` into inter-broker / intra-broker / leadership tasks,
orders inter-broker moves via the configured movement-strategy chain, and hands out
ready tasks subject to per-broker and cluster concurrency caps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.concurrency import ExecutionConcurrencyManager
from cruise_control_tpu_torch.executor.strategy import (
    ReplicaMovementStrategy,
    StrategyContext,
    chain_strategies,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskState, TaskType


class ExecutionTaskPlanner:
    def __init__(
        self,
        strategies: Sequence[ReplicaMovementStrategy] = (),
        strategy_ctx: Optional[StrategyContext] = None,
    ) -> None:
        self._strategy = chain_strategies(list(strategies))
        self._ctx = strategy_ctx or StrategyContext()
        self.inter_broker: List[ExecutionTask] = []
        self.intra_broker: List[ExecutionTask] = []
        self.leadership: List[ExecutionTask] = []

    def add_proposals(
        self,
        proposals: Sequence[ExecutionProposal],
        logdir_moves: Optional[Dict] = None,
    ) -> None:
        """Split proposals into task pools (ExecutionTaskPlanner.addExecutionProposals)."""
        for p in proposals:
            # a proposal may carry BOTH actions (follower move + leadership
            # transfer merged by diff()); the reference plans a task per action
            # and the phase ordering (replicas before leadership) sequences them
            if p.has_replica_action:
                self.inter_broker.append(
                    ExecutionTask(p, TaskType.INTER_BROKER_REPLICA_ACTION)
                )
            if p.has_leader_action:
                self.leadership.append(ExecutionTask(p, TaskType.LEADER_ACTION))
        by_tp = {p.tp: p for p in proposals}
        for (tp, broker), path in (logdir_moves or {}).items():
            p = by_tp.get(tp)
            if p is None:
                # logdir-only change: no placement diff exists, so synthesize a
                # no-op proposal to carry the task (the reference plans intra-
                # broker tasks from ExecutionProposal logdir info directly)
                p = ExecutionProposal(
                    tp=tp, partition_size=0.0, old_leader=None,
                    old_replicas=(broker,), new_replicas=(broker,),
                )
            t = ExecutionTask(p, TaskType.INTRA_BROKER_REPLICA_ACTION)
            t.logdir_move = (broker, path)
            self.intra_broker.append(t)
        self.inter_broker.sort(key=lambda t: self._strategy.sort_key(t, self._ctx))

    # -- ready-task selection ------------------------------------------------

    def ready_inter_broker_tasks(
        self,
        concurrency: ExecutionConcurrencyManager,
        in_flight: Sequence[ExecutionTask],
    ) -> List[ExecutionTask]:
        """Next strategy-ordered PENDING moves that fit under the caps
        (ExecutionTaskPlanner.getInterBrokerReplicaMovementTasks)."""
        in_flight_by_broker: Dict[int, int] = {}
        for t in in_flight:
            for b in t.brokers_involved:
                in_flight_by_broker[b] = in_flight_by_broker.get(b, 0) + 1
        budget = concurrency.cluster_cap - len(in_flight)

        out: List[ExecutionTask] = []
        for task in self.inter_broker:
            if budget <= 0:
                break
            if task.state is not TaskState.PENDING:
                continue
            brokers = task.brokers_involved
            if any(
                in_flight_by_broker.get(b, 0) >= concurrency.per_broker_cap(b)
                for b in brokers
            ):
                continue
            for b in brokers:
                in_flight_by_broker[b] = in_flight_by_broker.get(b, 0) + 1
            out.append(task)
            budget -= 1
        return out

    def ready_leadership_batch(self, batch_size: int) -> List[ExecutionTask]:
        out = [t for t in self.leadership if t.state is TaskState.PENDING]
        return out[:batch_size]

    def ready_intra_broker_tasks(self, cap: int) -> List[ExecutionTask]:
        out = [t for t in self.intra_broker if t.state is TaskState.PENDING]
        return out[:cap]

    # -- accounting ----------------------------------------------------------

    @property
    def all_tasks(self) -> List[ExecutionTask]:
        return self.inter_broker + self.intra_broker + self.leadership

    def remaining(self, pool: List[ExecutionTask]) -> int:
        return sum(1 for t in pool if not t.done)
