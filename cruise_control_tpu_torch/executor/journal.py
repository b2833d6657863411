"""Execution journal: the executor's durable intent + progress record.

Port of ``cruise_control_tpu/executor/journal.py``.

The reference survives a controller restart because its executor state is
external — the accepted reassignments live in ZooKeeper/the controller quorum
and ``Executor`` reconciles against ``listPartitionReassignments`` on startup.
This framework runs the whole control plane in one process, so without a
journal a crash mid-rebalance would orphan every in-flight reassignment on the
backend and forget the proposal set entirely.

This module closes that gap: every execution journals, through the generic
:class:`~cruise_control_tpu_torch.core.journal.Journal` WAL,

* ``execution_started`` — the execution id plus the **accepted proposal set**
  (full :class:`ExecutionProposal` wire form + logdir moves), written before
  the first southbound call;
* ``task`` — every task state transition (PENDING→IN_PROGRESS→COMPLETED/
  DEAD/ABORTED/…), hooked via :attr:`ExecutionTask.observer`;
* ``execution_finished`` — the summary counts (present ⇒ the execution ended
  inside a live process; absent ⇒ it was interrupted and needs recovery).

:meth:`ExecutionJournal.open_executions` replays the WAL and reconstructs
every interrupted execution — proposals, logdir moves, and each task's last
journaled state — for :meth:`Executor.recover` to reconcile against the
backend's actual ongoing reassignments.  Task identity across the restart is
``(task_type, tp)`` (a proposal yields at most one task per action type), so
process-local task ids never leak into recovery decisions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.backend.base import TopicPartition
from cruise_control_tpu_torch.core.journal import Journal
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskState


def proposal_to_record(p: ExecutionProposal) -> dict:
    """One proposal in journal wire form — shared by the execution WAL and
    the controller's standing-proposal-set WAL (controller/standing.py), so
    both planes replay the same encoding."""
    return {
        "tp": list(p.tp),
        "partition_size": p.partition_size,
        "old_leader": p.old_leader,
        "old_replicas": list(p.old_replicas),
        "new_replicas": list(p.new_replicas),
    }


def proposal_from_record(d: dict) -> ExecutionProposal:
    return ExecutionProposal(
        tp=(d["tp"][0], int(d["tp"][1])),
        partition_size=float(d["partition_size"]),
        old_leader=None if d["old_leader"] is None else int(d["old_leader"]),
        old_replicas=tuple(int(b) for b in d["old_replicas"]),
        new_replicas=tuple(int(b) for b in d["new_replicas"]),
    )


@dataclasses.dataclass
class OpenExecution:
    """One interrupted execution reconstructed from the journal."""

    execution_id: int
    proposals: List[ExecutionProposal]
    #: (tp, broker) -> target logdir
    logdir_moves: Dict[Tuple[TopicPartition, int], str]
    #: (task_type name, tp) -> last journaled TaskState
    task_states: Dict[Tuple[str, TopicPartition], TaskState]


@dataclasses.dataclass
class ReplayStats:
    records: int = 0
    skipped: int = 0
    max_execution_id: int = 0


class ExecutionJournal:
    """Typed record layer over one :class:`Journal` directory."""

    def __init__(self, journal: Journal) -> None:
        self.journal = journal

    @staticmethod
    def _now_ms() -> int:
        return int(time.time() * 1000)

    # -- write side ----------------------------------------------------------

    def execution_started(
        self,
        execution_id: int,
        proposals: List[ExecutionProposal],
        logdir_moves: Optional[Dict] = None,
    ) -> None:
        self.journal.append(
            {
                "type": "execution_started",
                "execution_id": execution_id,
                "proposals": [proposal_to_record(p) for p in proposals],
                "logdir_moves": [
                    [list(tp), broker, path]
                    for (tp, broker), path in (logdir_moves or {}).items()
                ],
                "ts_ms": self._now_ms(),
            }
        )

    def task_transition(self, execution_id: int, task: ExecutionTask) -> None:
        self.journal.append(
            {
                "type": "task",
                "execution_id": execution_id,
                "task_type": task.task_type.value,
                "tp": list(task.proposal.tp),
                "state": task.state.value,
                "ts_ms": self._now_ms(),
            }
        )

    def execution_finished(self, summary, recovered: bool = False) -> None:
        self.journal.append(
            {
                "type": "execution_finished",
                "execution_id": summary.execution_id,
                "completed": summary.completed,
                "dead": summary.dead,
                "aborted": summary.aborted,
                "failed": summary.failed,
                "stopped": summary.stopped,
                "error": summary.error,
                "recovered": recovered,
                "ts_ms": self._now_ms(),
            }
        )
        # executions are strictly sequential (OngoingExecutionError), so once
        # a finished record lands NOTHING in the journal is live state —
        # compact so the WAL stays bounded by one execution, not the process
        # lifetime.  Best-effort: a failed truncate just replays more history
        try:
            self.journal.truncate()
        except Exception:
            pass

    def close(self) -> None:
        self.journal.close()

    # -- replay side ---------------------------------------------------------

    def open_executions(self) -> Tuple[List[OpenExecution], ReplayStats]:
        """Interrupted executions (started, never finished) in start order.

        The journal is the process's memory, not the cluster's truth: a task
        journaled PENDING may have launched on the backend before the crash
        (the journal write races the southbound call), and one journaled
        IN_PROGRESS may have completed while the process was down — the
        recovery pass reconciles both against the backend."""
        records = self.journal.replay()
        stats = ReplayStats(records=len(records), skipped=records.skipped)
        opens: Dict[int, OpenExecution] = {}
        order: List[int] = []
        for rec in records:
            rtype = rec.get("type")
            exec_id = int(rec.get("execution_id", 0))
            stats.max_execution_id = max(stats.max_execution_id, exec_id)
            if rtype == "execution_started":
                opens[exec_id] = OpenExecution(
                    execution_id=exec_id,
                    proposals=[proposal_from_record(d) for d in rec["proposals"]],
                    logdir_moves={
                        ((tp[0], int(tp[1])), int(broker)): path
                        for tp, broker, path in rec.get("logdir_moves", [])
                    },
                    task_states={},
                )
                order.append(exec_id)
            elif rtype == "task" and exec_id in opens:
                tp = (rec["tp"][0], int(rec["tp"][1]))
                opens[exec_id].task_states[(rec["task_type"], tp)] = TaskState(
                    rec["state"]
                )
            elif rtype == "execution_finished":
                opens.pop(exec_id, None)
        return [opens[i] for i in order if i in opens], stats
