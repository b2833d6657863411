"""Executor: applies proposals to the cluster in three phases.

Port of ``cruise_control_tpu/executor/engine.py``.

Counterpart of ``executor/Executor.java:84`` (``executeProposals``:810, phase logic
``execute``:1442-1503): **inter-broker moves → intra-broker (logdir) moves →
leadership moves**, each driven by a progress-check loop against the backend, under
per-broker/cluster concurrency caps with auto-adjustment, replication throttles set
for the duration, partition sampling paused during inter-broker movement
(``adjustSamplingModeBeforeExecution``:1414), and a stop signal that aborts pending
tasks (STOP_PROPOSAL_EXECUTION).  One execution at a time
(``_noOngoingExecutionSemaphore``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.backend.base import ClusterBackend, ReassignmentInProgress
from cruise_control_tpu_torch.core.retry import RetryPolicy
from cruise_control_tpu_torch.executor.concurrency import (
    ConcurrencyAdjuster,
    ConcurrencyConfig,
    ExecutionConcurrencyManager,
)
from cruise_control_tpu_torch.executor.journal import ExecutionJournal, OpenExecution
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import ReplicaMovementStrategy, StrategyContext
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskState, TaskType
from cruise_control_tpu_torch.executor.throttle import ReplicationThrottleHelper


class ExecutorState:
    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    INTER_BROKER_REPLICA_MOVEMENT = "INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    INTRA_BROKER_REPLICA_MOVEMENT = "INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    LEADER_MOVEMENT = "LEADER_MOVEMENT_TASK_IN_PROGRESS"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


class ExecutorNotifier:
    """ExecutorNotifier SPI (ExecutorNotifier.java); default is a no-op."""

    def on_execution_finished(self, summary: "ExecutionSummary") -> None:  # pragma: no cover
        pass


@dataclasses.dataclass
class ExecutionSummary:
    execution_id: int
    stopped: bool
    completed: int
    dead: int
    aborted: int
    duration_s: float
    #: tasks still IN_PROGRESS/ABORTING when the execution unwound (fatal
    #: backend error or thread teardown) — no other bucket claims them, so
    #: completed + dead + aborted + failed == total always holds
    failed: int = 0
    #: fatal error that degraded the execution (None on a clean run)
    error: Optional[str] = None

    @property
    def total(self) -> int:
        return self.completed + self.dead + self.aborted + self.failed

    @property
    def succeeded(self) -> bool:
        return (
            not self.stopped
            and self.dead == 0
            and self.aborted == 0
            and self.failed == 0
            and self.error is None
        )


class OngoingExecutionError(Exception):
    """An execution is already in progress (Executor.executeProposals rejects)."""


class _RetryingBackend:
    """Engine-internal proxy: southbound calls run under the executor's
    :class:`RetryPolicy`; everything else delegates untouched.  Duck-typed
    (not a :class:`ClusterBackend` subclass) so test-helper attributes on the
    wrapped backend stay reachable."""

    _RETRIED = frozenset(
        {
            "describe_cluster",
            "describe_topics",
            "describe_logdirs",
            "alter_partition_reassignments",
            "list_partition_reassignments",
            "list_ongoing_reassignments",
            "elect_leaders",
            "alter_replica_logdirs",
            "set_replication_throttles",
            "clear_replication_throttles",
        }
    )

    def __init__(self, inner: ClusterBackend, policy: RetryPolicy) -> None:
        self._inner = inner
        self._policy = policy

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in self._RETRIED and callable(attr):
            policy = self._policy
            # a replayed reassignment answered with ReassignmentInProgress
            # means the lost-response attempt actually applied — success, not
            # a fatal conflict (alter is the one non-idempotent retried call)
            assume_applied = (
                (ReassignmentInProgress,)
                if name == "alter_partition_reassignments"
                else ()
            )

            def retried(*args, **kwargs):
                return policy.call(
                    attr,
                    *args,
                    op_name=f"backend.{name}",
                    assume_applied_on=assume_applied,
                    **kwargs,
                )

            return retried
        return attr


class Executor:
    def __init__(
        self,
        backend: ClusterBackend,
        concurrency: Optional[ConcurrencyConfig] = None,
        strategies: Sequence[ReplicaMovementStrategy] = (),
        throttle_rate_bytes: Optional[float] = None,
        progress_check_interval_s: float = 0.05,
        max_progress_checks: int = 10_000,
        notifier: Optional[ExecutorNotifier] = None,
        pause_sampling: Optional[Callable[[str], None]] = None,
        resume_sampling: Optional[Callable[[str], None]] = None,
        min_insync_replicas: int = 1,
        retry_policy: Optional[RetryPolicy] = None,
        task_timeout_s: Optional[float] = None,
        rollback_stuck_tasks: bool = False,
        journal: Optional[ExecutionJournal] = None,
        recovery_timeout_s: float = 30.0,
    ) -> None:
        self.min_insync_replicas = min_insync_replicas
        self.retry_policy = retry_policy
        #: execution WAL: accepted proposal set + every task transition
        #: (None = no durability; a crash orphans in-flight reassignments)
        self.journal = journal
        #: wall budget of the startup resume-supervision loop: journaled
        #: reassignments still moving past it get the stuck-task treatment
        self.recovery_timeout_s = recovery_timeout_s
        #: in-flight tasks stuck longer than this are marked DEAD instead of
        #: spinning the phase to max_progress_checks (None = no timeout)
        self.task_timeout_s = task_timeout_s
        #: on stuck-task timeout, also cancel the reassignment (None target,
        #: Kafka empty-target semantics) so replicas revert to old_replicas
        self.rollback_stuck_tasks = rollback_stuck_tasks
        self.backend = backend if retry_policy is None else _RetryingBackend(backend, retry_policy)
        self.concurrency = ExecutionConcurrencyManager(concurrency or ConcurrencyConfig())
        self.adjuster = ConcurrencyAdjuster(self.concurrency)
        self.strategies = list(strategies)
        self.throttle_rate_bytes = throttle_rate_bytes
        self.progress_check_interval_s = progress_check_interval_s
        self.max_progress_checks = max_progress_checks
        self.notifier = notifier or ExecutorNotifier()
        self._pause_sampling = pause_sampling
        self._resume_sampling = resume_sampling

        self._state = ExecutorState.NO_TASK_IN_PROGRESS
        self._stop_signal = threading.Event()
        self._lock = threading.Lock()
        self._execution_thread: Optional[threading.Thread] = None
        self._execution_ids = iter(range(1, 1 << 31))
        self._last_summary: Optional[ExecutionSummary] = None
        self._planner: Optional[ExecutionTaskPlanner] = None
        #: degraded summaries awaiting the ExecutionFailureDetector's drain —
        #: a queue (not just last_summary) so a degraded run isn't lost when a
        #: newer execution overwrites the summary before the next detector cycle
        self._degraded_summaries: List[ExecutionSummary] = []
        self._degraded_cap = 16
        #: journal replay accounting of the last recover() (ReplayStats)
        self.last_recovery_stats = None

    # -- public API ----------------------------------------------------------

    @property
    def state(self) -> str:
        # STOPPING is derived, not stored: a stop request must never be able
        # to pin the state past the execution thread's death (the thread owns
        # every stored-state transition; once it exits, this reverts to the
        # stored NO_TASK_IN_PROGRESS)
        if self._stop_signal.is_set() and self.has_ongoing_execution:
            return ExecutorState.STOPPING_EXECUTION
        return self._state

    @property
    def has_ongoing_execution(self) -> bool:
        return self._execution_thread is not None and self._execution_thread.is_alive()

    @property
    def last_summary(self) -> Optional[ExecutionSummary]:
        return self._last_summary

    def drain_degraded_summaries(self) -> List[ExecutionSummary]:
        """Hand pending degraded summaries to the caller exactly once
        (consumed by the ExecutionFailureDetector)."""
        with self._lock:
            out, self._degraded_summaries = self._degraded_summaries, []
        return out

    def execute_proposals(
        self,
        proposals: Sequence[ExecutionProposal],
        strategy_ctx: Optional[StrategyContext] = None,
        wait: bool = True,
        logdir_moves: Optional[Dict] = None,
    ) -> ExecutionSummary:
        """Run the 3-phase execution; rejects when one is ongoing
        (Executor.java:810 synchronized semantics)."""
        from cruise_control_tpu_torch.obs import recorder as obs

        # capture the submitter's request id NOW: the execution runs in its
        # own thread, which has no ambient trace scope — _run_execution
        # re-opens the scope so the execution trace correlates to the request
        parent_id = obs.current_parent_id()
        with self._lock:
            if self.has_ongoing_execution:
                raise OngoingExecutionError("an execution is already in progress")
            planner = ExecutionTaskPlanner(self.strategies, strategy_ctx)
            planner.add_proposals(list(proposals), logdir_moves=logdir_moves)
            execution_id = next(self._execution_ids)
            if self.journal is not None:
                # intent first (write-ahead): the accepted proposal set lands
                # in the journal before any southbound call, so a crash at any
                # later point can reconstruct what was being executed; every
                # task transition then journals through the observer hook.
                # This write precedes EVERY stored-state mutation — a refused
                # journal (full disk) rejects the request without leaving a
                # phantom STARTING_EXECUTION/_planner behind
                self.journal.execution_started(
                    execution_id, list(proposals), logdir_moves
                )
                for t in planner.all_tasks:
                    t.observer = (
                        lambda task, _id=execution_id:
                        self.journal.task_transition(_id, task)
                    )
            self._stop_signal.clear()
            self._state = ExecutorState.STARTING_EXECUTION
            self._planner = planner
            self._execution_thread = threading.Thread(
                target=self._run_execution,
                args=(execution_id, planner, parent_id),
                daemon=True,
            )
            self._execution_thread.start()
        if wait:
            self._execution_thread.join()
            assert self._last_summary is not None
            return self._last_summary
        return ExecutionSummary(
            execution_id, stopped=False, completed=0, dead=0, aborted=0, duration_s=0.0
        )

    def stop_execution(self) -> None:
        """STOP_PROPOSAL_EXECUTION endpoint (sets ``_stopSignal``).

        No-op on an idle executor — otherwise the state would read
        STOPPING_EXECUTION forever with nothing to stop.  Only the signal is
        set here; the STOPPING state is derived in :attr:`state` so a stop
        racing the execution thread's teardown can't outlive the thread."""
        from cruise_control_tpu_torch.core.sensors import EXECUTION_STOPPED_COUNTER, REGISTRY

        with self._lock:
            if not self.has_ongoing_execution:
                return
            self._stop_signal.set()
        REGISTRY.counter(EXECUTION_STOPPED_COUNTER).inc()

    def await_completion(self, timeout_s: float = 60.0) -> Optional[ExecutionSummary]:
        t = self._execution_thread
        if t is not None:
            t.join(timeout=timeout_s)
        return self._last_summary

    # -- crash recovery ------------------------------------------------------

    def recover(self) -> List[ExecutionSummary]:
        """Startup recovery pass: replay the execution journal, reconcile
        every interrupted execution against the backend's actual ongoing
        reassignments, and close it out with exactly one recovered
        :class:`ExecutionSummary` per execution — pushed through the
        degraded-summary drain queue so the ``ExecutionFailureDetector``
        reports the interruption like any other degraded run.

        Per task, the backend is the truth and the journal the memory:

        * journaled terminal states (COMPLETED/DEAD/ABORTED) stand;
        * an inter-broker task journaled IN_PROGRESS whose partition is no
          longer reassigning **completed while the process was down**;
        * one still reassigning is genuinely in flight: it is rolled back
          (cancel → DEAD, replicas revert) when ``rollback_stuck_tasks`` is
          set, otherwise supervision resumes — bounded by
          ``recovery_timeout_s``, after which the stuck-task policy applies;
        * a PENDING task whose partition is reassigning toward exactly its
          target launched before the crash outran the journal — it is
          adopted as in-flight; any other PENDING task is aborted (recovery
          never launches new work);
        * leadership tasks re-trigger the idempotent preferred election once
          their reorder (if any) is done; intra-broker (logdir) tasks caught
          mid-call are unverifiable through the SPI and marked DEAD.

        No-op without a journal.  Must run before the first execution."""
        if self.journal is None:
            return []
        from cruise_control_tpu_torch.core.sensors import (
            RECOVERY_EXECUTIONS_COUNTER,
            REGISTRY,
        )

        with self._lock:
            if self.has_ongoing_execution:
                raise OngoingExecutionError("cannot recover during an execution")
        opens, stats = self.journal.open_executions()
        self.last_recovery_stats = stats
        if stats.max_execution_id:
            # journaled ids survive the restart; never hand one out twice
            self._execution_ids = iter(range(stats.max_execution_id + 1, 1 << 31))
        summaries = []
        for ex in opens:
            summaries.append(self._recover_one(ex))
            REGISTRY.counter(RECOVERY_EXECUTIONS_COUNTER).inc()
        if opens:
            # the crashed execution applied replication throttles it never got
            # to clear (the live path clears them in its finally); on a real
            # backend these are persistent configs that would silently cap
            # replication forever.  Best-effort: a backend that can't clear
            # still gets the recovered summaries
            try:
                self.backend.clear_replication_throttles()
            except Exception:
                pass
        return summaries

    def _recover_one(self, ex: OpenExecution) -> ExecutionSummary:
        from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
        from cruise_control_tpu_torch.obs import recorder as obs

        token = obs.start_trace("recovery")
        t0 = time.monotonic()

        # -- reconstruct the task set exactly as the planner built it --------
        tasks: List[ExecutionTask] = []
        for p in ex.proposals:
            if p.has_replica_action:
                tasks.append(ExecutionTask(p, TaskType.INTER_BROKER_REPLICA_ACTION))
            if p.has_leader_action:
                tasks.append(ExecutionTask(p, TaskType.LEADER_ACTION))
        by_tp = {p.tp: p for p in ex.proposals}
        for (tp, broker), path in ex.logdir_moves.items():
            p = by_tp.get(tp) or ExecutionProposal(
                tp=tp, partition_size=0.0, old_leader=None,
                old_replicas=(broker,), new_replicas=(broker,),
            )
            t = ExecutionTask(p, TaskType.INTRA_BROKER_REPLICA_ACTION)
            t.logdir_move = (broker, path)
            tasks.append(t)
        for t in tasks:
            st = ex.task_states.get((t.task_type.value, t.proposal.tp))
            if st is not None:
                t.state = st   # journal replay, not a transition
            # recovery's own transitions journal like live ones
            t.observer = (
                lambda task, _id=ex.execution_id:
                self.journal.task_transition(_id, task)
            )

        # -- reconcile against the backend's actual state ---------------------
        # a backend that dies mid-reconciliation (past the retry budget) must
        # degrade THIS execution's recovery — unresolved tasks land in the
        # failed bucket and no finished record is written, so the next
        # restart retries — never unwind app startup half-done
        recovery_error: Optional[str] = None
        in_flight: List[ExecutionTask] = []
        adopted = completed_while_down = 0
        resumed = rolled_back = 0
        now = self._now_ms()
        try:
            ongoing = dict(self.backend.list_ongoing_reassignments())
            for t in tasks:
                if t.done:
                    continue
                tp = t.proposal.tp
                if t.task_type is TaskType.INTER_BROKER_REPLICA_ACTION:
                    target = ongoing.get(tp)
                    if t.state is TaskState.PENDING:
                        if target is not None and set(target) == set(t.proposal.new_replicas):
                            # launched before the crash outran the journal write
                            t.transition(TaskState.IN_PROGRESS, now)
                            in_flight.append(t)
                            adopted += 1
                        else:
                            t.transition(TaskState.ABORTED, now)
                    elif t.state is TaskState.IN_PROGRESS:
                        if target is None:
                            t.transition(TaskState.COMPLETED, now)
                            completed_while_down += 1
                        else:
                            in_flight.append(t)
                    else:   # ABORTING: mid-cancel at crash time, unverifiable
                        t.transition(TaskState.DEAD, now)
                elif t.task_type is TaskType.LEADER_ACTION:
                    if t.state is TaskState.PENDING:
                        t.transition(TaskState.ABORTED, now)
                    elif t.state is TaskState.IN_PROGRESS:
                        if tp in ongoing:
                            in_flight.append(t)   # replica-list reorder in flight
                        else:
                            # reorder done (or never submitted) — the preferred
                            # election is idempotent, re-trigger and complete;
                            # a refused election is a DEAD task, not a dead app
                            try:
                                self.backend.elect_leaders([tp])
                                t.transition(TaskState.COMPLETED, now)
                            except Exception:
                                t.transition(TaskState.DEAD, now)
                    else:
                        t.transition(TaskState.DEAD, now)
                else:   # intra-broker logdir move caught mid-call
                    if t.state is TaskState.PENDING:
                        t.transition(TaskState.ABORTED, now)
                    else:
                        t.transition(TaskState.DEAD, now)

            # -- resume or roll back the genuinely in-flight reassignments ----
            if in_flight and self.rollback_stuck_tasks:
                for t in in_flight:
                    self._kill_stuck_task(t, now)   # DEAD + server-side cancel
                    rolled_back += 1
                in_flight = []
            elif in_flight:
                deadline = time.monotonic() + self.recovery_timeout_s
                while in_flight and time.monotonic() < deadline:
                    still_ongoing = set(self.backend.list_partition_reassignments())
                    still: List[ExecutionTask] = []
                    now = self._now_ms()
                    for t in in_flight:
                        if t.proposal.tp not in still_ongoing:
                            if t.task_type is TaskType.LEADER_ACTION:
                                try:
                                    self.backend.elect_leaders([t.proposal.tp])
                                except Exception:
                                    self._kill_stuck_task(t, now)
                                    continue
                            t.transition(TaskState.COMPLETED, now)
                            resumed += 1
                        else:
                            still.append(t)
                    in_flight = still
                    if in_flight:
                        time.sleep(self.progress_check_interval_s)
                now = self._now_ms()
                for t in in_flight:
                    self._kill_stuck_task(t, now)
        except Exception as e:
            recovery_error = f"recovery reconciliation failed: {type(e).__name__}: {e}"

        counts = {s: 0 for s in TaskState}
        for t in tasks:
            counts[t.state] += 1
        summary = ExecutionSummary(
            execution_id=ex.execution_id,
            stopped=False,
            completed=counts[TaskState.COMPLETED],
            dead=counts[TaskState.DEAD],
            aborted=counts[TaskState.ABORTED] + counts[TaskState.PENDING],
            failed=counts[TaskState.IN_PROGRESS] + counts[TaskState.ABORTING],
            duration_s=time.monotonic() - t0,
            error=(
                recovery_error
                or "execution interrupted by process restart; recovered"
            ),
        )
        with self._lock:
            self._degraded_summaries.append(summary)
            del self._degraded_summaries[: -self._degraded_cap]
        self._last_summary = summary
        if recovery_error is None:
            # only a fully-reconciled execution gets its finished record; a
            # degraded recovery leaves the journal open so the next restart
            # retries the reconciliation against a (hopefully) live backend
            try:
                self.journal.execution_finished(summary, recovered=True)
            except Exception:
                pass
        obs.finish_trace(
            token,
            attrs={
                "execution_id": ex.execution_id,
                "tasks": len(tasks),
                "completed": summary.completed,
                "dead": summary.dead,
                "aborted": summary.aborted,
                "failed": summary.failed,
                "adopted": adopted,
                "completed_while_down": completed_while_down,
                "resumed": resumed,
                "rolled_back": rolled_back,
                "error": recovery_error,
            },
        )
        return summary

    # -- execution phases ----------------------------------------------------

    def _run_execution(
        self,
        execution_id: int,
        planner: ExecutionTaskPlanner,
        parent_id: Optional[str] = None,
    ) -> None:
        from cruise_control_tpu_torch.core.sensors import (
            EXECUTION_FAILED_COUNTER,
            EXECUTION_STARTED_COUNTER,
            PROPOSAL_EXECUTION_TIMER,
            REGISTRY,
        )
        from cruise_control_tpu_torch.obs import recorder as obs

        trace_token = obs.start_trace("execution", parent_id=parent_id)
        phase_spans = []
        t0 = time.monotonic()
        REGISTRY.counter(EXECUTION_STARTED_COUNTER).inc()
        throttle = ReplicationThrottleHelper(self.backend, self.throttle_rate_bytes)
        error: Optional[str] = None
        cleanup_errors: List[str] = []

        def _cleanup(label: str, fn: Callable[[], None]) -> None:
            # cleanup steps run independently: one failing step (e.g. a
            # throttle-clear whose retries exhaust) must not skip the rest
            try:
                fn()
            except Exception as ce:
                cleanup_errors.append(f"{label}: {type(ce).__name__}: {ce}")

        if self._pause_sampling and planner.inter_broker:
            # pause partition sampling while replicas move (:1414)
            _cleanup(
                "pause_sampling",
                lambda: self._pause_sampling("executor: inter-broker replica movement"),
            )
        try:
            for name, tasks, phase in (
                ("inter_broker", planner.inter_broker,
                 lambda: self._inter_broker_phase(planner, throttle)),
                ("intra_broker", planner.intra_broker,
                 lambda: self._intra_broker_phase(planner)),
                ("leadership", planner.leadership,
                 lambda: self._leadership_phase(planner)),
            ):
                p0 = time.monotonic()
                phase()
                phase_spans.append(
                    obs.Span(
                        name, "phase", time.monotonic() - p0,
                        attrs={"tasks": len(tasks)},
                    )
                )
        except Exception as e:
            # a fatal backend error degrades to a summary with error set —
            # never a silently-dead daemon thread
            error = f"{type(e).__name__}: {e}"
            REGISTRY.counter(EXECUTION_FAILED_COUNTER).inc()
        finally:
            _cleanup("clear_throttles", throttle.clear_throttles)
            if self._resume_sampling and planner.inter_broker:
                _cleanup(
                    "resume_sampling",
                    lambda: self._resume_sampling("executor: execution finished"),
                )
            counts = {s: 0 for s in TaskState}
            for t in planner.all_tasks:
                counts[t.state] += 1
            self._last_summary = ExecutionSummary(
                execution_id=execution_id,
                stopped=self._stop_signal.is_set(),
                completed=counts[TaskState.COMPLETED],
                dead=counts[TaskState.DEAD],
                aborted=counts[TaskState.ABORTED] + counts[TaskState.PENDING],
                failed=counts[TaskState.IN_PROGRESS] + counts[TaskState.ABORTING],
                duration_s=time.monotonic() - t0,
                error=error,
            )
            s = self._last_summary
            if not s.stopped and (s.error is not None or s.dead or s.failed):
                with self._lock:
                    self._degraded_summaries.append(s)
                    del self._degraded_summaries[: -self._degraded_cap]
            _cleanup(
                "execution_timer",
                lambda: REGISTRY.timer(PROPOSAL_EXECUTION_TIMER).update(
                    self._last_summary.duration_s
                ),
            )
            if self.journal is not None:
                # guarded like every cleanup step: a journal that can no
                # longer be written (disk full, simulated crash) must not
                # skip the remaining teardown — the missing finished record
                # is exactly what recovery keys on after a real crash
                _cleanup(
                    "journal_finish",
                    lambda: self.journal.execution_finished(self._last_summary),
                )
            self._state = ExecutorState.NO_TASK_IN_PROGRESS
            obs.finish_trace(       # never raises (observability contract)
                trace_token,
                spans=phase_spans,
                attrs={
                    "execution_id": execution_id,
                    "stopped": self._last_summary.stopped,
                    "completed": self._last_summary.completed,
                    "dead": self._last_summary.dead,
                    "aborted": self._last_summary.aborted,
                    "failed": self._last_summary.failed,
                    "error": error,
                    "cleanup_errors": cleanup_errors,
                },
            )
            _cleanup(
                "notifier",
                lambda: self.notifier.on_execution_finished(self._last_summary),
            )

    def _now_ms(self) -> int:
        return int(time.time() * 1000)

    def _inter_broker_phase(
        self, planner: ExecutionTaskPlanner, throttle: ReplicationThrottleHelper
    ) -> None:
        """interBrokerMoveReplicas (Executor.java:1607)."""
        in_flight: List[ExecutionTask] = []
        checks = 0
        while not self._stop_signal.is_set():
            ready = planner.ready_inter_broker_tasks(self.concurrency, in_flight)
            if ready:
                throttle.set_throttles(ready)
                reassignments = {
                    t.proposal.tp: t.proposal.new_replicas for t in ready
                }
                self.backend.alter_partition_reassignments(reassignments)
                now = self._now_ms()
                for t in ready:
                    t.transition(TaskState.IN_PROGRESS, now)
                in_flight.extend(ready)
                self._state = ExecutorState.INTER_BROKER_REPLICA_MOVEMENT
            if not in_flight and not ready:
                if planner.remaining(planner.inter_broker) == 0:
                    break
                # remaining tasks exist but none ready (caps); loop continues
            in_flight = self._progress_check(planner, in_flight)
            checks += 1
            if checks >= self.max_progress_checks:
                self._mark_dead(in_flight)
                break
            if in_flight or planner.remaining(planner.inter_broker):
                time.sleep(self.progress_check_interval_s)
            else:
                break
        if self._stop_signal.is_set():
            self._abort_pending(planner.inter_broker)
            # in-flight reassignments finish server-side; wait them out (bounded)
            drain_checks = 0
            while in_flight and drain_checks < self.max_progress_checks:
                in_flight = self._progress_check(planner, in_flight)
                drain_checks += 1
                if in_flight:
                    time.sleep(self.progress_check_interval_s)
            self._mark_dead(in_flight)

    def _progress_check(
        self, planner: ExecutionTaskPlanner, in_flight: List[ExecutionTask]
    ) -> List[ExecutionTask]:
        """One progress-check interval: completed = no longer listed as reassigning;
        dead = a destination broker died (ExecutionUtils progress semantics) or
        the task sat in flight past ``task_timeout_s`` (stuck reassignment)."""
        ongoing = set(self.backend.list_partition_reassignments().keys())
        alive = {
            b for b, i in self.backend.describe_cluster().brokers.items() if i.alive
        }
        still: List[ExecutionTask] = []
        now = self._now_ms()
        for t in in_flight:
            if t.proposal.tp not in ongoing:
                t.transition(TaskState.COMPLETED, now)
            elif not set(t.proposal.replicas_to_add) <= alive:
                t.transition(TaskState.DEAD, now)
            elif self._task_expired(t, now):
                self._kill_stuck_task(t, now)
            else:
                still.append(t)
        # concurrency auto-adjustment tick from cluster health (AIMD)
        under_min = at_min = 0
        for infos in self.backend.describe_topics().values():
            for i in infos:
                if len(i.isr) < self.min_insync_replicas:
                    under_min += 1
                elif len(i.isr) == self.min_insync_replicas and len(i.isr) < len(i.replicas):
                    at_min += 1
        self.adjuster.tick(num_under_min_isr=under_min, num_at_min_isr=at_min)
        return still

    def _intra_broker_phase(self, planner: ExecutionTaskPlanner) -> None:
        """intraBrokerMoveReplicas (:1679) — logdir moves via the backend."""
        if self._stop_signal.is_set() or not planner.intra_broker:
            return
        self._state = ExecutorState.INTRA_BROKER_REPLICA_MOVEMENT
        while not self._stop_signal.is_set():
            batch = planner.ready_intra_broker_tasks(self.concurrency.config.intra_broker_moves)
            if not batch:
                break
            moves = {}
            now = self._now_ms()
            for t in batch:
                broker, path = t.logdir_move
                moves[(t.proposal.tp, broker)] = path
                t.transition(TaskState.IN_PROGRESS, now)
            self.backend.alter_replica_logdirs(moves)
            now = self._now_ms()
            for t in batch:
                t.transition(TaskState.COMPLETED, now)

    def _leadership_phase(self, planner: ExecutionTaskPlanner) -> None:
        """moveLeaderships in batches (:1742,1769) → backend.elect_leaders."""
        if self._stop_signal.is_set():
            self._abort_pending(planner.leadership)
            return
        if planner.leadership:
            self._state = ExecutorState.LEADER_MOVEMENT
        # partitions whose inter-broker move died/aborted never reached
        # new_replicas — "reordering" them would submit a fresh data move
        failed_moves = {
            t.proposal.tp
            for t in planner.inter_broker
            if t.state in (TaskState.DEAD, TaskState.ABORTED)
        }
        while not self._stop_signal.is_set():
            batch = planner.ready_leadership_batch(self.concurrency.config.leadership_batch)
            if not batch:
                break
            now = self._now_ms()
            live = []
            for t in batch:
                if t.proposal.tp in failed_moves:
                    t.transition(TaskState.ABORTED, now)
                else:
                    live.append(t)
            batch = live
            if not batch:
                continue
            for t in batch:
                t.transition(TaskState.IN_PROGRESS, now)
            # a leadership change = replica-list reorder (preferred leader first)
            # then preferred-leader election — the reassignment carries no data
            # (same broker set), matching how PLE picks replicas[0]
            reorder = {
                t.proposal.tp: t.proposal.new_replicas
                for t in batch
                if t.proposal.new_replicas != t.proposal.old_replicas
            }
            stuck_tps = set()
            if reorder:
                self.backend.alter_partition_reassignments(reorder)
                checks = 0
                t_reorder0 = time.monotonic()
                while checks < self.max_progress_checks:
                    pending = set(self.backend.list_partition_reassignments()) & set(reorder)
                    if not pending:
                        break
                    if (
                        self.task_timeout_s is not None
                        and time.monotonic() - t_reorder0 >= self.task_timeout_s
                    ):
                        # stalled reorders get the same stuck-task treatment
                        # as inter-broker moves: DEAD, never fake-COMPLETED
                        stuck_tps = pending
                        break
                    checks += 1
                    time.sleep(self.progress_check_interval_s)
            now = self._now_ms()
            live = []
            for t in batch:
                if t.proposal.tp in stuck_tps:
                    self._kill_stuck_task(t, now)
                else:
                    live.append(t)
            if live:
                self.backend.elect_leaders([t.proposal.tp for t in live])
            now = self._now_ms()
            for t in live:
                t.transition(TaskState.COMPLETED, now)
        if self._stop_signal.is_set():
            self._abort_pending(planner.leadership)

    # -- helpers -------------------------------------------------------------

    def _task_expired(self, t: ExecutionTask, now_ms: int) -> bool:
        return (
            self.task_timeout_s is not None
            and t.start_ms is not None
            and now_ms - t.start_ms >= self.task_timeout_s * 1000.0
        )

    def _kill_stuck_task(self, t: ExecutionTask, now_ms: int) -> None:
        """A reassignment that outlived ``task_timeout_s`` is DEAD; optionally
        cancel it server-side so the partition reverts to ``old_replicas``."""
        from cruise_control_tpu_torch.core.sensors import REGISTRY, STUCK_TASKS_COUNTER

        t.transition(TaskState.DEAD, now_ms)
        REGISTRY.counter(STUCK_TASKS_COUNTER).inc()
        if self.rollback_stuck_tasks:
            try:
                self.backend.alter_partition_reassignments({t.proposal.tp: None})
            except Exception:
                # best-effort: a backend that can't cancel still gets the DEAD
                # marking; the reassignment finishes (or not) server-side
                pass

    def _abort_pending(self, pool: List[ExecutionTask]) -> None:
        now = self._now_ms()
        for t in pool:
            if t.state is TaskState.PENDING:
                t.transition(TaskState.ABORTED, now)

    def _mark_dead(self, in_flight: List[ExecutionTask]) -> None:
        now = self._now_ms()
        for t in in_flight:
            if t.state is TaskState.IN_PROGRESS:
                t.transition(TaskState.DEAD, now)
