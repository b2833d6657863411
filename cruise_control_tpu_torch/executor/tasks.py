"""Execution tasks and their lifecycle.

Port of ``cruise_control_tpu/executor/tasks.py``.

Counterpart of ``executor/ExecutionTask.java`` + ``ExecutionTaskState.java``:
PENDING → IN_PROGRESS → {COMPLETED, ABORTING → ABORTED, DEAD}.  A task wraps one
:class:`ExecutionProposal` restricted to one action type.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, Optional

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal


class TaskType(enum.Enum):
    INTER_BROKER_REPLICA_ACTION = "INTER_BROKER_REPLICA_ACTION"
    INTRA_BROKER_REPLICA_ACTION = "INTRA_BROKER_REPLICA_ACTION"
    LEADER_ACTION = "LEADER_ACTION"


class TaskState(enum.Enum):
    PENDING = "PENDING"
    IN_PROGRESS = "IN_PROGRESS"
    ABORTING = "ABORTING"
    ABORTED = "ABORTED"
    DEAD = "DEAD"
    COMPLETED = "COMPLETED"


#: legal transitions (ExecutionTask.java VALID_TRANSFER map)
_VALID = {
    TaskState.PENDING: {TaskState.IN_PROGRESS, TaskState.ABORTED},
    TaskState.IN_PROGRESS: {TaskState.ABORTING, TaskState.DEAD, TaskState.COMPLETED},
    TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
}

_task_ids = itertools.count()


@dataclasses.dataclass
class ExecutionTask:
    proposal: ExecutionProposal
    task_type: TaskType
    task_id: int = dataclasses.field(default_factory=lambda: next(_task_ids))
    state: TaskState = TaskState.PENDING
    start_ms: Optional[int] = None
    end_ms: Optional[int] = None
    #: logdir destination for intra-broker moves: (broker, path)
    logdir_move: Optional[tuple] = None
    #: transition hook (the execution journal): called with the task after
    #: every state change.  An observer that raises aborts the transition's
    #: caller — WAL semantics, a state change that cannot be journaled must
    #: not proceed silently (this is also the chaos crash-point seam)
    observer: Optional[Callable[["ExecutionTask"], None]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def transition(self, new_state: TaskState, now_ms: int = 0) -> None:
        allowed = _VALID.get(self.state, set())
        if new_state not in allowed:
            raise ValueError(f"illegal task transition {self.state} -> {new_state}")
        prev = (self.state, self.start_ms, self.end_ms)
        self.state = new_state
        if new_state is TaskState.IN_PROGRESS:
            self.start_ms = now_ms
        if new_state in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD):
            self.end_ms = now_ms
        if self.observer is not None:
            try:
                self.observer(self)
            except BaseException:
                # WAL semantics both ways: an unjournalable transition did not
                # happen — reverting keeps memory and journal agreeing on the
                # task's state, so a later recovery pass never double-counts
                self.state, self.start_ms, self.end_ms = prev
                raise

    @property
    def done(self) -> bool:
        return self.state in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD)

    @property
    def brokers_involved(self):
        p = self.proposal
        if self.task_type is TaskType.LEADER_ACTION:
            return {p.new_leader} if p.new_leader is not None else set()
        return set(p.replicas_to_add) | set(p.replicas_to_remove)
