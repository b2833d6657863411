"""Executor layer: 3-phase proposal execution against the cluster backend.

Port of ``cruise_control_tpu/executor`` (the counterpart of the reference's
``executor/``).  The execution thread touches only the backend, never the
device.
"""

from cruise_control_tpu_torch.executor.concurrency import (
    ConcurrencyAdjuster,
    ConcurrencyConfig,
    ExecutionConcurrencyManager,
)
from cruise_control_tpu_torch.executor.engine import (
    ExecutionSummary,
    Executor,
    ExecutorNotifier,
    ExecutorState,
    OngoingExecutionError,
)
from cruise_control_tpu_torch.executor.journal import ExecutionJournal, OpenExecution
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import (
    BaseReplicaMovementStrategy,
    PostponeUrpReplicaMovementStrategy,
    PrioritizeLargeReplicaMovementStrategy,
    PrioritizeMinIsrWithOfflineReplicasStrategy,
    PrioritizeOneAboveMinIsrWithOfflineReplicasStrategy,
    PrioritizeSmallReplicaMovementStrategy,
    ReplicaMovementStrategy,
    StrategyContext,
    chain_strategies,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskState, TaskType
from cruise_control_tpu_torch.executor.throttle import ReplicationThrottleHelper

__all__ = [
    "BaseReplicaMovementStrategy",
    "ConcurrencyAdjuster",
    "ConcurrencyConfig",
    "ExecutionConcurrencyManager",
    "ExecutionJournal",
    "ExecutionSummary",
    "ExecutionTask",
    "ExecutionTaskPlanner",
    "OpenExecution",
    "Executor",
    "ExecutorNotifier",
    "ExecutorState",
    "OngoingExecutionError",
    "PostponeUrpReplicaMovementStrategy",
    "PrioritizeLargeReplicaMovementStrategy",
    "PrioritizeMinIsrWithOfflineReplicasStrategy",
    "PrioritizeOneAboveMinIsrWithOfflineReplicasStrategy",
    "PrioritizeSmallReplicaMovementStrategy",
    "ReplicaMovementStrategy",
    "ReplicationThrottleHelper",
    "StrategyContext",
    "TaskState",
    "TaskType",
    "chain_strategies",
]
