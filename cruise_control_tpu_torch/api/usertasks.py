"""Async user-task tracking.

Port of ``cruise_control_tpu/api/usertasks.py`` (pure Python, copied whole; its WAL is the port's ``core/journal.Journal``).

Counterpart of ``servlet/UserTaskManager.java:69`` (getOrCreateUserTask:222,
markTaskExecutionBegan/Finished:397,422): a POST that needs background work gets a
UUID and a 202 response carrying the ``User-Task-ID`` header; repeating the request
(or polling with the task id) returns the current progress until the future
completes, then the final response.  Completed tasks are retained for a
configurable period per endpoint type.

Durability: with a :class:`~cruise_control_tpu_torch.core.journal.Journal`, task
creation and completion (including the completed task's final response body,
the same JSON ``USER_TASKS`` serves as ``result``) are journaled, and a
restarted manager replays them — a client polling a task id across a process
restart gets its answer instead of a 404.  Tasks caught mid-flight by the
crash are resurrected as ``CompletedWithError`` ("interrupted by restart"):
the honest answer, since their work died with the process.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.api.progress import OperationProgress
from cruise_control_tpu_torch.core.journal import Journal


class TaskStatus(enum.Enum):
    ACTIVE = "Active"
    IN_EXECUTION = "InExecution"
    COMPLETED = "Completed"
    COMPLETED_WITH_ERROR = "CompletedWithError"


class TooManyUserTasksError(RuntimeError):
    """The active-task cap is reached.  A ``RuntimeError`` subclass (the
    pre-overload-plane type) so existing callers keep catching it, but typed
    so the API layer can map it to ``429`` + ``Retry-After`` instead of
    letting it escape as a 500 — overload is the *client's* signal to back
    off, not a server fault."""

    def __init__(self, active: int, cap: int) -> None:
        super().__init__(
            f"too many active user tasks ({active} active, cap {cap})"
        )
        self.active = active
        self.cap = cap


@dataclasses.dataclass
class UserTask:
    task_id: str
    endpoint: str
    request_key: Tuple
    progress: OperationProgress
    future: Future
    created_ms: int
    status: TaskStatus = TaskStatus.ACTIVE
    #: response formatter installed by the API layer; lets USER_TASKS serve a
    #: completed task's final body, so clients never have to re-issue the
    #: original (possibly mutating) request just to read the result
    result_to_json: Optional[Callable[[object], dict]] = None
    #: correlation id of the REST request that created the task (inbound
    #: ``X-Request-Id`` or server-generated); every flight-recorder trace the
    #: task's work emits inherits it as ``parent_id``, so GET /TRACES walks
    #: request → user task → optimize → execution on one id.  A deduped
    #: re-submission keeps the FIRST request's id (the task is one operation).
    parent_id: Optional[str] = None
    #: the completed task's final response body in already-serialized form —
    #: set when the result is journaled at completion, and on journal replay
    #: (a recovered task has no live Future to re-serialize from)
    result_json: Optional[dict] = None
    #: error string of a failed/interrupted task (journal replay carries it;
    #: live failures keep raising through the Future as before)
    error: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "UserTaskId": self.task_id,
            "RequestURL": self.endpoint,
            "Status": self.status.value,
            "StartMs": self.created_ms,
            "Progress": self.progress.to_list(),
        }
        if self.parent_id is not None:
            d["RequestId"] = self.parent_id
        if self.error is not None:
            d["error"] = self.error
        if self.status is TaskStatus.COMPLETED:
            if self.result_json is not None:
                d["result"] = self.result_json
            elif self.result_to_json is not None and self.future is not None:
                try:
                    d["result"] = self.result_to_json(self.future.result(timeout=0))
                except Exception:
                    pass  # formatting must not break the task listing
        return d


class UserTaskManager:
    def __init__(
        self,
        max_workers: int = 4,
        completed_retention_ms: int = 6 * 3600 * 1000,
        max_active_tasks: int = 25,
        journal: Optional[Journal] = None,
    ) -> None:
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._tasks: Dict[str, UserTask] = {}
        self._by_key: Dict[Tuple, str] = {}
        self._lock = threading.Lock()
        self.completed_retention_ms = completed_retention_ms
        self.max_active_tasks = max_active_tasks
        #: user-task WAL (None = tasks die with the process, pre-PR-6 behavior)
        self._journal = journal
        self.recovered_records = 0
        self.recovered_tasks = 0
        self.replay_skipped = 0
        if journal is not None:
            self._replay_journal()
            self._compact_journal()

    def _compact_journal(self) -> None:
        """Startup compaction: rewrite the WAL to exactly the retained task
        set, so the journal (and the next boot's replay) stays bounded by the
        retention window instead of growing with lifetime traffic.
        Best-effort — a failed compaction only means replaying more history
        next time."""
        try:
            self._journal.truncate()
            records = []
            for t in sorted(self._tasks.values(), key=lambda t: t.created_ms):
                records.append(
                    {
                        "type": "user_task_created", "task_id": t.task_id,
                        "endpoint": t.endpoint, "created_ms": t.created_ms,
                        "parent_id": t.parent_id,
                    }
                )
                finished = {
                    "type": "user_task_finished", "task_id": t.task_id,
                    "status": t.status.value, "ts_ms": int(time.time() * 1000),
                }
                if t.error is not None:
                    finished["error"] = t.error
                if t.result_json is not None:
                    finished["result"] = t.result_json
                records.append(finished)
            self._journal.append_many(records)
        except Exception:
            pass

    def _replay_journal(self) -> None:
        """Resurrect journaled tasks: finished ones come back whole (status +
        embedded result body); ones caught mid-flight come back as
        ``CompletedWithError`` — their work died with the process."""
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            USER_TASKS_RECOVERED_COUNTER,
        )

        records = self._journal.replay()
        self.recovered_records = len(records)
        self.replay_skipped = records.skipped
        created: Dict[str, dict] = {}
        finished: Dict[str, dict] = {}
        order: List[str] = []
        for rec in records:
            tid = rec.get("task_id")
            if rec.get("type") == "user_task_created" and tid:
                if tid not in created:
                    order.append(tid)
                created[tid] = rec
            elif rec.get("type") == "user_task_finished" and tid:
                finished[tid] = rec
        now = int(time.time() * 1000)
        for tid in order:
            c = created[tid]
            if now - int(c.get("created_ms", 0)) > self.completed_retention_ms:
                continue   # would have been expired anyway
            f = finished.get(tid)
            if f is not None:
                status = TaskStatus(f["status"])
                error = f.get("error")
                result_json = f.get("result")
            else:
                status = TaskStatus.COMPLETED_WITH_ERROR
                error = "interrupted by process restart"
                result_json = None
            progress = OperationProgress()
            progress.complete()
            self._tasks[tid] = UserTask(
                task_id=tid,
                endpoint=c.get("endpoint", ""),
                request_key=None,
                progress=progress,
                future=None,  # type: ignore[arg-type]
                created_ms=int(c.get("created_ms", 0)),
                status=status,
                parent_id=c.get("parent_id"),
                result_json=result_json,
                error=error,
            )
            self.recovered_tasks += 1
            REGISTRY.counter(USER_TASKS_RECOVERED_COUNTER).inc()

    def peek(self, request_key: Tuple) -> Optional[UserTask]:
        """The task already registered for this request key, if any — the
        admission layer's dedupe pre-check (a re-submitted request rides its
        existing task and must not consume quota or queue capacity).

        Expires first: a key whose retained task just aged out must read as
        a MISS, or the caller would skip admission while ``get_or_create``
        (which also expires) goes on to create a brand-new unticketed task —
        a solve running outside every slot and quota."""
        with self._lock:
            self._expire_locked()
            existing_id = self._by_key.get(request_key)
            if existing_id:
                return self._tasks.get(existing_id)
            return None

    def get_or_create(
        self,
        endpoint: str,
        request_key: Tuple,
        work: Callable[[OperationProgress], object],
        parent_id: Optional[str] = None,
        result_to_json: Optional[Callable[[object], dict]] = None,
        admission_ticket=None,
    ) -> UserTask:
        """Dedupe by request key: re-submitting the same request returns the same
        task (getOrCreateUserTask:222's session semantics, keyed by parameters).
        ``parent_id`` is the request's correlation id — the worker thread runs
        inside its trace scope and emits a ``user_task`` flight record, so the
        id links the task to every optimize/execution trace it caused.
        ``result_to_json`` must be passed HERE (not assigned after the fact)
        when the journal is on: the completion record embeds the serialized
        result, and the worker may finish before the caller's next statement.
        ``admission_ticket`` (api/admission.py) is released when the task
        completes — or immediately on a dedupe hit / refused creation, so a
        request that created no work never holds an execution slot."""
        with self._lock:
            self._expire_locked()
            existing_id = self._by_key.get(request_key)
            if existing_id and existing_id in self._tasks:
                # dedupe hit: no new work — the caller's admission slot (won
                # in a race against the thread that actually created the
                # task) must be handed back, not leaked until "completion"
                # of a task it doesn't own
                if admission_ticket is not None:
                    admission_ticket.release()
                return self._tasks[existing_id]
            active = sum(
                1 for t in self._tasks.values()
                if t.status in (TaskStatus.ACTIVE, TaskStatus.IN_EXECUTION)
            )
            if active >= self.max_active_tasks:
                if admission_ticket is not None:
                    admission_ticket.release()
                raise TooManyUserTasksError(active, self.max_active_tasks)
            task_id = str(uuid.uuid4())
            progress = OperationProgress()
            task = UserTask(
                task_id=task_id,
                endpoint=endpoint,
                request_key=request_key,
                progress=progress,
                future=None,  # type: ignore[arg-type]
                created_ms=int(time.time() * 1000),
                parent_id=parent_id,
                result_to_json=result_to_json,
            )
            self._tasks[task_id] = task
            self._by_key[request_key] = task_id
            if self._journal is not None:
                # creation write may raise (full disk, crash point): refusing
                # the request beats accepting work whose durability promise is
                # broken — but the refused task must be unregistered, or dedupe
                # would pin a permanently-ACTIVE zombie that also counts
                # against max_active_tasks forever.  Registration + journal +
                # rollback happen under ONE lock hold, so a concurrent
                # duplicate request can never dedupe onto a task that is about
                # to be popped (the journal lock nests inside ours, leaf-only
                # — no deadlock)
                try:
                    self._journal.append(
                        {
                            "type": "user_task_created",
                            "task_id": task_id,
                            "endpoint": endpoint,
                            "created_ms": task.created_ms,
                            "parent_id": parent_id,
                        }
                    )
                except Exception:
                    self._tasks.pop(task_id, None)
                    self._by_key.pop(request_key, None)
                    if admission_ticket is not None:
                        admission_ticket.release()
                    raise

        def _run():
            from cruise_control_tpu_torch.obs import recorder as obs

            task.status = TaskStatus.IN_EXECUTION
            # the pool thread has no ambient scope — re-open the request's
            # here so the work's optimize/execution traces correlate
            with obs.parent_scope(task.parent_id):
                token = obs.start_trace("user_task")
                error: Optional[str] = None
                result = None
                try:
                    result = work(progress)
                    task.status = TaskStatus.COMPLETED
                    return result
                except Exception as e:
                    task.status = TaskStatus.COMPLETED_WITH_ERROR
                    error = f"{type(e).__name__}: {e}"
                    raise
                finally:
                    progress.complete()
                    self._journal_finished(task, result, error)
                    if admission_ticket is not None:
                        # the slot frees when the WORK ends, not when the HTTP
                        # response goes out — admission gates solver
                        # concurrency, and a 202'd task is still running
                        admission_ticket.release()
                    obs.finish_trace(
                        token,
                        attrs={
                            "endpoint": endpoint,
                            "task_id": task_id,
                            "status": task.status.value,
                        },
                    )

        try:
            task.future = self._pool.submit(_run)
        except RuntimeError:
            # pool shut down mid-request: unregister and hand the slot back
            with self._lock:
                self._tasks.pop(task_id, None)
                self._by_key.pop(request_key, None)
            if admission_ticket is not None:
                admission_ticket.release()
            raise
        return task

    def _journal_finished(self, task: UserTask, result, error: Optional[str]) -> None:
        """Journal a completion (with the serialized result body a future
        USER_TASKS poll will serve).  Best-effort: the work already happened —
        a failed write loses durability, it must not fail the task."""
        if self._journal is None:
            return
        rec: dict = {
            "type": "user_task_finished",
            "task_id": task.task_id,
            "status": task.status.value,
            "ts_ms": int(time.time() * 1000),
        }
        if error is not None:
            rec["error"] = error
        if task.status is TaskStatus.COMPLETED and task.result_to_json is not None:
            try:
                rec["result"] = task.result_to_json(result)
                task.result_json = rec["result"]
            except Exception:
                pass
        try:
            self._journal.append(rec)
        except Exception:
            pass

    def get(self, task_id: str) -> Optional[UserTask]:
        with self._lock:
            return self._tasks.get(task_id)

    def all_tasks(self) -> List[UserTask]:
        with self._lock:
            self._expire_locked()
            return sorted(self._tasks.values(), key=lambda t: t.created_ms)

    def _expire_locked(self) -> None:
        now = int(time.time() * 1000)
        expired = [
            tid for tid, t in self._tasks.items()
            if t.status in (TaskStatus.COMPLETED, TaskStatus.COMPLETED_WITH_ERROR)
            and now - t.created_ms > self.completed_retention_ms
        ]
        for tid in expired:
            t = self._tasks.pop(tid)
            self._by_key.pop(t.request_key, None)

    def shutdown(self) -> None:
        self.kill()
        if self._journal is not None:
            try:
                self._journal.close()
            except Exception:
                pass

    def kill(self) -> None:
        """Stop the worker pool WITHOUT sealing the journal (crash simulation)."""
        self._pool.shutdown(wait=False)
