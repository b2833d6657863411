"""The port's executor against the JAX package.

The cases of the JAX package's ``tests/test_executor.py`` and the executor
recovery cases of ``tests/test_recovery.py`` run against the port; the
cases that need a failing, stalled or unreachable backend wrap the fake in
the port's ``ChaosBackend`` with a ``FaultPlan``, as the JAX cases do.  The parity
cases run the same seeded proposals and journals through both packages'
executors: the summaries' counts, the backend's admin log and its final
replica lists and leaders must be equal.
"""

import dataclasses

import numpy as np
import pytest

from chip_smoke import backend_placement
from cruise_control_tpu.analyzer.proposals import ExecutionProposal as JProposal
from cruise_control_tpu.backend import FakeClusterBackend as JFake
from cruise_control_tpu.core.journal import Journal as JJournal
from cruise_control_tpu.executor import ExecutionJournal as JExecutionJournal
from cruise_control_tpu.executor import Executor as JExecutor
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.backend import ChaosBackend, FakeClusterBackend, FaultPlan
from cruise_control_tpu_torch.core.journal import Journal, SimulatedCrash
from cruise_control_tpu_torch.executor import (
    ConcurrencyConfig,
    ExecutionConcurrencyManager,
    ExecutionJournal,
    ExecutionTaskPlanner,
    Executor,
    ExecutorNotifier,
    OngoingExecutionError,
    PrioritizeSmallReplicaMovementStrategy,
    TaskState,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskType

# -- the JAX package's executor cases -------------------------------------------------


def make_backend(latency=1):
    backend = FakeClusterBackend(reassignment_latency_polls=latency)
    for b in range(4):
        backend.add_broker(b, rack=str(b % 2))
    for p in range(6):
        backend.create_partition(("T", p), [p % 4, (p + 1) % 4], load=[1.0, 10.0, 10.0, 100.0])
    return backend


def move_proposal(tp, old, new, size=100.0):
    return ExecutionProposal(
        tp=tp, partition_size=size, old_leader=old[0],
        old_replicas=tuple(old), new_replicas=tuple(new),
    )


class TestPlanner:
    def test_split_and_order_by_strategy(self):
        p_small = move_proposal(("T", 0), [0, 1], [2, 1], size=10.0)
        p_big = move_proposal(("T", 1), [1, 2], [3, 2], size=500.0)
        p_lead = move_proposal(("T", 2), [2, 3], [3, 2])  # leadership only
        planner = ExecutionTaskPlanner([PrioritizeSmallReplicaMovementStrategy()])
        planner.add_proposals([p_big, p_small, p_lead])
        assert [t.proposal.tp for t in planner.inter_broker] == [("T", 0), ("T", 1)]
        # p_small/p_big also change the leader, so they plan a leadership task too
        assert {t.proposal.tp for t in planner.leadership} == {
            ("T", 0), ("T", 1), ("T", 2)
        }

    def test_concurrency_caps_respected(self):
        proposals = [
            move_proposal(("T", i), [0, 1], [2 + (i % 2), 1]) for i in range(6)
        ]
        planner = ExecutionTaskPlanner()
        planner.add_proposals(proposals)
        mgr = ExecutionConcurrencyManager(ConcurrencyConfig(per_broker_moves=2, cluster_moves=10))
        ready = planner.ready_inter_broker_tasks(mgr, in_flight=[])
        # every task touches broker 0 (remove) — per-broker cap of 2 binds
        assert len(ready) == 2


class TestExecution:
    def test_three_phase_execution_applies_to_backend(self):
        backend = make_backend()
        executor = Executor(backend, throttle_rate_bytes=1e6)
        proposals = [
            move_proposal(("T", 0), [0, 1], [2, 1]),
            move_proposal(("T", 1), [1, 2], [1, 3]),
            move_proposal(("T", 2), [2, 3], [3, 2]),  # leadership
        ]
        summary = executor.execute_proposals(proposals)
        assert summary.succeeded, vars(summary)
        topics = backend.describe_topics()
        by_tp = {i.tp: i for infos in topics.values() for i in infos}
        assert set(by_tp[("T", 0)].replicas) == {1, 2}
        assert set(by_tp[("T", 1)].replicas) == {1, 3}
        assert by_tp[("T", 2)].leader == 3
        # throttles set then cleared
        kinds = [k for k, _ in backend.admin_log]
        assert "throttle" in kinds and kinds[-1] != "throttle"
        assert backend.current_throttle is None

    def test_execution_pauses_and_resumes_sampling(self):
        backend = make_backend()
        events = []
        executor = Executor(
            backend,
            pause_sampling=lambda r: events.append(("pause", r)),
            resume_sampling=lambda r: events.append(("resume", r)),
        )
        executor.execute_proposals([move_proposal(("T", 0), [0, 1], [2, 1])])
        assert events[0][0] == "pause" and events[-1][0] == "resume"

    def test_reject_concurrent_execution(self):
        backend = make_backend(latency=50)
        executor = Executor(backend, progress_check_interval_s=0.01)
        executor.execute_proposals(
            [move_proposal(("T", 0), [0, 1], [2, 1])], wait=False
        )
        with pytest.raises(OngoingExecutionError):
            executor.execute_proposals([move_proposal(("T", 1), [1, 2], [1, 3])])
        executor.stop_execution()
        executor.await_completion()

    def test_stop_execution_aborts_pending(self):
        backend = make_backend(latency=100)
        executor = Executor(
            backend,
            concurrency=ConcurrencyConfig(per_broker_moves=1, cluster_moves=1),
            progress_check_interval_s=0.01,
        )
        proposals = [
            move_proposal(("T", i), [0, 1], [2 + (i % 2), 1]) for i in range(4)
        ]
        executor.execute_proposals(proposals, wait=False)
        import time

        time.sleep(0.05)
        executor.stop_execution()
        summary = executor.await_completion(timeout_s=30)
        assert summary is not None and summary.stopped

    def test_stop_execution_on_idle_executor_is_noop(self):
        """Regression: stop on an idle executor used to pin the state to
        STOPPING_EXECUTION forever with nothing to stop."""
        backend = make_backend()
        executor = Executor(backend)
        executor.stop_execution()
        assert executor.state == "NO_TASK_IN_PROGRESS"
        # and a fresh execution still starts normally afterwards
        summary = executor.execute_proposals([move_proposal(("T", 0), [0, 1], [2, 1])])
        assert summary.succeeded
        assert not summary.stopped
        executor.stop_execution()   # after completion: also a no-op
        assert executor.state == "NO_TASK_IN_PROGRESS"

    def test_lost_task_accounting_on_thread_unwind(self):
        """Regression: tasks still IN_PROGRESS when the execution thread
        unwinds used to land in no bucket; they must be counted as failed so
        completed + dead + aborted + failed == total."""

        inner = FakeClusterBackend()
        for b in range(4):
            inner.add_broker(b, rack=str(b % 2))
        for p in range(3):
            inner.create_partition(("T", p), [p % 4, (p + 1) % 4], load=[1.0] * 4)
        plan = FaultPlan(seed=7).raise_every(
            "list_partition_reassignments", 1, exc=lambda m: ValueError("metadata fetch exploded")
        )
        backend = ChaosBackend(inner, plan)
        executor = Executor(backend, progress_check_interval_s=0.01)
        proposals = [move_proposal(("T", 0), [0, 1], [2, 1])]
        summary = executor.execute_proposals(proposals)
        assert summary.error is not None and "ValueError" in summary.error
        assert not summary.succeeded
        tasks = executor._planner.all_tasks
        assert summary.total == len(tasks)
        assert summary.failed >= 1      # the in-flight move when the error hit
        # executor is reusable after the degraded run
        assert executor.state == "NO_TASK_IN_PROGRESS"
        assert not executor.has_ongoing_execution

    def test_cleanup_steps_run_independently(self):
        """One failing cleanup step (resume callback) must not skip the rest:
        throttles still cleared, summary still produced, notifier still told."""
        backend = make_backend()
        finished = []

        class Note(ExecutorNotifier):
            def on_execution_finished(self, summary):
                finished.append(summary)

        def bad_resume(reason):
            raise RuntimeError("monitor is gone")

        executor = Executor(
            backend,
            throttle_rate_bytes=1e6,
            notifier=Note(),
            pause_sampling=lambda r: None,
            resume_sampling=bad_resume,
        )
        summary = executor.execute_proposals([move_proposal(("T", 0), [0, 1], [2, 1])])
        assert summary.succeeded
        assert backend.current_throttle is None
        assert finished == [summary]

    def test_dead_destination_marks_task_dead(self):
        backend = make_backend(latency=3)
        executor = Executor(backend, progress_check_interval_s=0.01)
        import threading, time

        def killer():
            time.sleep(0.015)
            backend.kill_broker(2)

        t = threading.Thread(target=killer)
        t.start()
        # leader stays 0, so only a single replica-move task is planned
        summary = executor.execute_proposals([move_proposal(("T", 0), [0, 1], [0, 2])])
        t.join()
        # either it completed before the kill or it was marked dead — never hangs
        assert summary.completed + summary.dead == 1


class TestCombinedProposal:
    def test_replica_move_with_leadership_change(self):
        """A proposal carrying both a follower move AND a leadership transfer must
        apply both (planner emits one task per action)."""
        backend = make_backend()
        executor = Executor(backend)
        # (T,0): replicas [0,1] leader 0 -> replicas (2,0): 1 moves to 2, leader 2
        summary = executor.execute_proposals([move_proposal(("T", 0), [0, 1], [2, 0])])
        assert summary.succeeded
        by_tp = {i.tp: i for infos in backend.describe_topics().values() for i in infos}
        assert set(by_tp[("T", 0)].replicas) == {0, 2}
        assert by_tp[("T", 0)].leader == 2


class TestIntraBrokerExecution:
    def test_logdir_only_moves_execute_via_intra_phase(self):
        """A logdir-moves map with no matching placement proposal still plans and
        executes intra-broker tasks (Executor.intraBrokerMoveReplicas :1679)."""
        backend = FakeClusterBackend()
        backend.add_broker(0, rack="0", logdirs={"/d1": 1e6, "/d2": 1e6})
        backend.add_broker(1, rack="1", logdirs={"/d1": 1e6})
        backend.create_partition(("T", 0), [0, 1], load=[1.0, 10.0, 10.0, 100.0])
        executor = Executor(backend)
        summary = executor.execute_proposals(
            [], logdir_moves={(("T", 0), 0): "/d2"}
        )
        assert summary.completed >= 1
        assert ("logdir", (("T", 0), 0, "/d2")) in backend.admin_log


# -- the JAX package's executor recovery cases (tests/test_recovery.py) ----------------


def make_recovery_backend(cls=FakeClusterBackend, latency=1, partitions=3, brokers=4):
    b = cls(reassignment_latency_polls=latency)
    for i in range(brokers):
        b.add_broker(i, rack=str(i % 2))
    for p in range(partitions):
        b.create_partition(("T", p), [p % 2, (p % 2 + 1) % brokers], load=[1.5, 4e3, 6e3, 3e4])
    return b


def prop(tp, old, new, cls=ExecutionProposal):
    return cls(tp=tp, partition_size=1.0, old_leader=old[0], old_replicas=tuple(old), new_replicas=tuple(new))


def stalling_backend():
    """Reassignments never finish on their own; a cancel (None target) still
    drops them."""
    return ChaosBackend(make_recovery_backend(), FaultPlan(seed=7).stall_reassignments())


def down_backend():
    """A backend dead from the first call: every call raises."""
    return ChaosBackend(make_recovery_backend(), FaultPlan(seed=7).crash_after("*", 0))


class TestExecutorRecovery:
    def _journal(self, tmp_path, *proposals, execution_id=7):
        j = ExecutionJournal(Journal(str(tmp_path)))
        j.execution_started(execution_id, list(proposals))
        return j

    def _mark(self, j, execution_id, p, state, task_type=TaskType.INTER_BROKER_REPLICA_ACTION):
        t = ExecutionTask(p, task_type)
        t.state = state
        j.task_transition(execution_id, t)

    def test_in_progress_completed_while_down(self, tmp_path):
        p1 = prop(("T", 0), [0, 1], [2, 1])
        j = self._journal(tmp_path, p1)
        self._mark(j, 7, p1, TaskState.IN_PROGRESS)
        ex = Executor(make_recovery_backend(), journal=j)
        s = ex.recover()[0]
        assert s.execution_id == 7
        assert s.completed == 1
        assert s.completed + s.dead + s.aborted + s.failed == s.total
        assert len(ex.drain_degraded_summaries()) == 1
        assert ex.drain_degraded_summaries() == []
        assert ex.recover() == []

    def test_pending_never_launched_aborts(self, tmp_path):
        p1 = prop(("T", 0), [0, 1], [2, 1])
        j = self._journal(tmp_path, p1)
        ex = Executor(make_recovery_backend(), journal=j)
        s = ex.recover()[0]
        assert s.aborted == s.total

    def test_pending_that_launched_is_adopted_and_resumed(self, tmp_path):
        p1 = prop(("T", 0), [0, 1], [2, 1])
        j = self._journal(tmp_path, p1)
        backend = make_recovery_backend(latency=3)
        backend.alter_partition_reassignments({("T", 0): [2, 1]})
        ex = Executor(backend, journal=j, progress_check_interval_s=0.01)
        s = ex.recover()[0]
        assert s.completed >= 1 and s.dead == 0
        replicas = {i.tp: i.replicas for infos in backend.describe_topics().values() for i in infos}
        assert replicas[("T", 0)] == (2, 1)

    def test_stalled_in_flight_rolled_back(self, tmp_path):
        p1 = prop(("T", 0), [0, 1], [2, 1])
        j = self._journal(tmp_path, p1)
        backend = stalling_backend()
        backend.alter_partition_reassignments({("T", 0): [2, 1]})
        self._mark(j, 7, p1, TaskState.IN_PROGRESS)
        ex = Executor(backend, journal=j, rollback_stuck_tasks=True)
        s = ex.recover()[0]
        assert s.dead >= 1
        assert not backend.stalled_reassignments   # the cancel cleared the stall
        replicas = {i.tp: i.replicas for infos in backend.describe_topics().values() for i in infos}
        assert replicas[("T", 0)] == (0, 1)   # reverted to old_replicas

    def test_stalled_in_flight_without_rollback_times_out_dead(self, tmp_path):
        p1 = prop(("T", 0), [0, 1], [2, 1])
        j = self._journal(tmp_path, p1)
        backend = stalling_backend()
        backend.alter_partition_reassignments({("T", 0): [2, 1]})
        self._mark(j, 7, p1, TaskState.IN_PROGRESS)
        ex = Executor(backend, journal=j, rollback_stuck_tasks=False,
                      recovery_timeout_s=0.05, progress_check_interval_s=0.01)
        s = ex.recover()[0]
        assert s.dead >= 1
        assert backend.stalled_reassignments   # no cancel without the policy

    def test_unreachable_backend_degrades_recovery_not_startup(self, tmp_path):
        p1 = prop(("T", 0), [0, 1], [2, 1])
        j = self._journal(tmp_path, p1)
        self._mark(j, 7, p1, TaskState.IN_PROGRESS)
        backend = down_backend()
        summaries = Executor(backend, journal=j).recover()   # must NOT raise
        assert len(summaries) == 1
        s = summaries[0]
        assert "reconciliation failed" in s.error
        assert s.failed >= 1
        assert s.completed + s.dead + s.aborted + s.failed == s.total
        # no finished record: the next restart retries against a live backend
        ex2 = Executor(make_recovery_backend(), journal=ExecutionJournal(Journal(str(tmp_path))))
        s2 = ex2.recover()[0]
        assert "recovered" in s2.error and s2.failed == 0
        assert ex2.recover() == []

    def test_execution_ids_continue_past_journal(self, tmp_path):
        j = self._journal(tmp_path, prop(("T", 0), [0, 1], [2, 1]), execution_id=41)
        ex = Executor(make_recovery_backend(), journal=j)
        ex.recover()
        s = ex.execute_proposals([prop(("T", 1), [1, 2], [1, 3])])
        assert s.execution_id > 41

    def test_live_execution_journals_then_compacts(self, tmp_path):
        j = ExecutionJournal(Journal(str(tmp_path)))
        ex = Executor(make_recovery_backend(), journal=j)
        s = ex.execute_proposals([prop(("T", 0), [0, 1], [2, 1])])
        assert s.succeeded
        assert j.journal.appends >= 4
        opens, stats = j.open_executions()
        assert opens == [] and stats.records == 0
        assert j.journal.replay() == []

    def test_journal_write_failure_rejects_without_phantom_state(self, tmp_path):
        j = ExecutionJournal(Journal(str(tmp_path)))
        j.journal.crash_after_appends = 0
        ex = Executor(make_recovery_backend(), journal=j)
        with pytest.raises(SimulatedCrash):
            ex.execute_proposals([prop(("T", 0), [0, 1], [2, 1])])
        assert ex.state == "NO_TASK_IN_PROGRESS"
        assert ex._planner is None and not ex.has_ongoing_execution

    def test_transition_reverts_when_journal_append_fails(self):
        def observer(task):
            raise OSError("disk full")

        t = ExecutionTask(prop(("T", 0), [0, 1], [2, 1]), TaskType.INTER_BROKER_REPLICA_ACTION)
        t.observer = observer
        with pytest.raises(OSError):
            t.transition(TaskState.IN_PROGRESS, 123)
        assert t.state is TaskState.PENDING and t.start_ms is None


# -- the port against the JAX executor, same inputs ------------------------------------


def _summary_key(s):
    d = dataclasses.asdict(s)
    d.pop("duration_s")
    return d


def _seeded(seed, fake_cls, proposal_cls):
    """A 12-broker backend and 40 proposals drawn from one numpy seed:
    replica moves, leadership swaps and both at once."""
    rng = np.random.default_rng(seed)
    backend = fake_cls(reassignment_latency_polls=1 + seed % 3)
    for b in range(12):
        backend.add_broker(b, rack=str(b % 3))
    placements = {}
    for p in range(40):
        reps = [int(x) for x in rng.choice(12, size=3, replace=False)]
        placements[("T", p)] = reps
        backend.create_partition(("T", p), reps, load=[1.0, 10.0, 10.0, 100.0 + p])
    proposals = []
    for tp, old in placements.items():
        new = list(old)
        kind = rng.integers(0, 3)
        if kind != 1:
            new[int(rng.integers(0, 3))] = int(rng.choice([b for b in range(12) if b not in old]))
        if kind != 0:
            new = new[1:] + new[:1]
        proposals.append(proposal_cls(tp=tp, partition_size=float(rng.integers(1, 1000)),
                                      old_leader=old[0], old_replicas=tuple(old), new_replicas=tuple(new)))
    return backend, proposals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_execution_equals_the_jax_executor(seed):
    cfg = dict(per_broker_moves=2, cluster_moves=6)
    jb, jp = _seeded(seed, JFake, JProposal)
    pb, pp = _seeded(seed, FakeClusterBackend, ExecutionProposal)
    from cruise_control_tpu.executor import ConcurrencyConfig as JConcurrencyConfig

    js = JExecutor(jb, concurrency=JConcurrencyConfig(**cfg), throttle_rate_bytes=1e6,
                   progress_check_interval_s=0.001).execute_proposals(jp)
    ps = Executor(pb, concurrency=ConcurrencyConfig(**cfg), throttle_rate_bytes=1e6,
                  progress_check_interval_s=0.001).execute_proposals(pp)
    assert ps.succeeded and _summary_key(ps) == _summary_key(js)
    assert pb.admin_log == jb.admin_log
    assert backend_placement(pb) == backend_placement(jb)
    assert all(backend_placement(pb)[p.tp] == (p.new_replicas, p.new_replicas[0]) for p in pp)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recovery_of_either_packages_journal_equals_the_jax_recovery(tmp_path, writer):
    """A journal left by a crash mid-execution (one move landed while down,
    one still in flight, one never launched) written by either package:
    both executors recover it to the same summary and placement."""
    mods = {"jax": (JExecutionJournal, JJournal, JProposal), "port": (ExecutionJournal, Journal, ExecutionProposal)}
    EJ, J, P = mods[writer]
    j = EJ(J(str(tmp_path / "w")))
    props = [prop(("T", 0), [0, 1], [2, 1], P), prop(("T", 1), [1, 0], [1, 3], P),
             prop(("T", 2), [0, 1], [3, 1], P)]
    j.execution_started(9, props)
    for p, st in zip(props[:2], ("IN_PROGRESS", "IN_PROGRESS")):
        j.journal.append({"type": "task", "execution_id": 9, "task_type": "INTER_BROKER_REPLICA_ACTION",
                          "tp": list(p.tp), "state": st, "ts_ms": 0})
    j.close()
    out = {}
    for side, (ex_cls, ej, jn, fake) in {
        "jax": (JExecutor, JExecutionJournal, JJournal, JFake),
        "port": (Executor, ExecutionJournal, Journal, FakeClusterBackend),
    }.items():
        d = tmp_path / side
        d.mkdir()
        for f in (tmp_path / "w").iterdir():
            (d / f.name).write_bytes(f.read_bytes())
        backend = make_recovery_backend(fake, latency=2)
        backend.alter_partition_reassignments({("T", 1): [1, 3]})   # still in flight
        ex = ex_cls(backend, journal=ej(jn(str(d))), progress_check_interval_s=0.001)
        out[side] = ([_summary_key(s) for s in ex.recover()], backend_placement(backend), backend.admin_log)
    assert out["port"] == out["jax"]
    summary = out["port"][0][0]
    # the two moves complete; the never-launched move and both leadership
    # tasks abort (recovery launches no new work)
    assert summary["completed"] == 2 and summary["aborted"] == 3 and summary["failed"] == 0
