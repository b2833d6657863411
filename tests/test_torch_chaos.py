"""The port's chaos backend, chaos journal and circuit breaker against the
JAX package, on the CPU.

The cases of the JAX package's ``tests/test_chaos.py`` (the fault matrix,
determinism, detector resilience, stop under chaos) run against the port's
executor, detector manager and ``ChaosBackend``.  Across packages: one seed
gives one ``fault_log``; one journal fault plan leaves the same wreck on
disk, which both packages' journals recover to the same records; and one
breaker script on a fake clock walks both breakers through the same states
and counters.  (The JAX case that reads retry events over the HTTP API
needs the app, which the port does not have yet.)
"""

import os
import threading
import time

import pytest

from cruise_control_tpu.backend import ChaosBackend as JChaosBackend
from cruise_control_tpu.backend import ChaosInjectedError as JChaosInjectedError
from cruise_control_tpu.backend import FakeClusterBackend as JFake
from cruise_control_tpu.backend import FaultPlan as JFaultPlan
from cruise_control_tpu.backend.breaker import BreakerOpenError as JBreakerOpenError
from cruise_control_tpu.backend.breaker import CircuitBreaker as JCircuitBreaker
from cruise_control_tpu.backend.chaos import ChaosJournal as JChaosJournal
from cruise_control_tpu.core.journal import Journal as JJournal
from cruise_control_tpu.core.journal import SimulatedCrash as JSimulatedCrash
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.backend import (
    BreakerBackend,
    BreakerOpenError,
    ChaosBackend,
    ChaosInjectedError,
    CircuitBreaker,
    FakeClusterBackend,
    FaultPlan,
    ReassignmentInProgress,
)
from cruise_control_tpu_torch.backend.chaos import ChaosJournal
from cruise_control_tpu_torch.core.journal import Journal, SimulatedCrash
from cruise_control_tpu_torch.core.retry import RetryPolicy
from cruise_control_tpu_torch.core.sensors import (
    CHAOS_FAULTS_COUNTER,
    REGISTRY,
    RETRY_COUNTER,
    STUCK_TASKS_COUNTER,
)
from cruise_control_tpu_torch.detector import (
    Anomaly,
    AnomalyDetectorManager,
    AnomalyNotifier,
    AnomalyType,
    ExecutionFailure,
    ExecutionFailureDetector,
    NotificationResult,
)
from cruise_control_tpu_torch.executor import Executor, TaskState
from cruise_control_tpu_torch.obs import RECORDER

pytestmark = pytest.mark.chaos


# -- scaffolding (tests/test_chaos.py) -----------------------------------------------


def make_backend(latency=1, cls=FakeClusterBackend):
    backend = cls(reassignment_latency_polls=latency)
    for b in range(4):
        backend.add_broker(b, rack=str(b % 2))
    for p in range(6):
        backend.create_partition(("T", p), [p % 4, (p + 1) % 4], load=[1.0, 10.0, 10.0, 100.0])
    return backend


def move_proposal(tp, old, new, size=100.0):
    return ExecutionProposal(
        tp=tp, partition_size=size, old_leader=old[0], old_replicas=tuple(old), new_replicas=tuple(new),
    )


def fast_retry(**kw):
    kw.setdefault("max_attempts", 5)
    kw.setdefault("base_backoff_s", 0.001)
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("seed", 42)
    return RetryPolicy(**kw)


def make_executor(chaos, sampling_events=None, **kw):
    ev = sampling_events if sampling_events is not None else []
    kw.setdefault("retry_policy", fast_retry())
    kw.setdefault("progress_check_interval_s", 0.005)
    kw.setdefault("throttle_rate_bytes", 1e6)
    return Executor(
        chaos,
        pause_sampling=lambda r: ev.append(("pause", r)),
        resume_sampling=lambda r: ev.append(("resume", r)),
        **kw,
    ), ev


PROPOSALS = [
    (("T", 0), [0, 1], [2, 1]),
    (("T", 1), [1, 2], [1, 3]),
    (("T", 2), [2, 3], [3, 2]),   # leadership-only
]


def run_plan(plan, sampling_events=None, latency=1, **executor_kw):
    chaos = ChaosBackend(make_backend(latency=latency), plan)
    executor, events = make_executor(chaos, sampling_events, **executor_kw)
    summary = executor.execute_proposals([move_proposal(tp, old, new) for tp, old, new in PROPOSALS])
    return chaos, executor, summary, events


def assert_invariants(chaos, executor, summary, events):
    """The hardening contract every fault plan must leave intact."""
    assert summary is not None
    assert executor.last_summary is summary
    assert not executor.has_ongoing_execution
    assert executor.state == "NO_TASK_IN_PROGRESS"
    tasks = executor._planner.all_tasks
    counts = {s: 0 for s in TaskState}
    for t in tasks:
        counts[t.state] += 1
    assert summary.completed == counts[TaskState.COMPLETED]
    assert summary.dead == counts[TaskState.DEAD]
    assert summary.aborted == counts[TaskState.ABORTED] + counts[TaskState.PENDING]
    assert summary.failed == counts[TaskState.IN_PROGRESS] + counts[TaskState.ABORTING]
    assert summary.total == len(tasks)
    assert chaos.current_throttle is None
    pauses = [e for e in events if e[0] == "pause"]
    resumes = [e for e in events if e[0] == "resume"]
    assert len(pauses) == len(resumes)
    if events:
        assert events[-1][0] == "resume"


# -- the fault matrix ----------------------------------------------------------------


class TestFaultMatrix:
    def test_raise_n_times_absorbed_by_retry(self):
        before = REGISTRY.counter(RETRY_COUNTER).snapshot()
        plan = FaultPlan(seed=7).raise_n_times("alter_partition_reassignments", 2)
        chaos, executor, summary, events = run_plan(plan)
        assert_invariants(chaos, executor, summary, events)
        assert summary.succeeded, vars(summary)
        assert chaos.faults_by_kind().get("error") == 2
        # retries land in the sensors and in the flight recorder
        assert REGISTRY.counter(RETRY_COUNTER).snapshot() >= before + 2
        assert REGISTRY.counter(CHAOS_FAULTS_COUNTER).snapshot() >= 2
        retries = RECORDER.recent(100, kind="retry")
        assert retries and retries[0].attrs["op"] == "backend.alter_partition_reassignments"

    def test_raise_every_kth_on_progress_checks(self):
        plan = FaultPlan(seed=7).raise_every("list_partition_reassignments", 2)
        chaos, executor, summary, events = run_plan(plan, latency=3)
        assert_invariants(chaos, executor, summary, events)
        assert summary.succeeded, vars(summary)
        assert chaos.faults_by_kind().get("error", 0) >= 1

    def test_injected_latency(self):
        plan = FaultPlan(seed=7).latency("alter_partition_reassignments", 0.02)
        chaos, executor, summary, events = run_plan(plan)
        assert_invariants(chaos, executor, summary, events)
        assert summary.succeeded, vars(summary)
        assert chaos.faults_by_kind().get("latency", 0) >= 1

    def test_broker_flap_during_execution(self):
        plan = FaultPlan(seed=7).flap_broker(3, start_call=2, end_call=30)
        chaos, executor, summary, events = run_plan(plan)
        assert_invariants(chaos, executor, summary, events)
        assert summary.total == len(executor._planner.all_tasks)
        assert chaos.faults_by_kind().get("flap", 0) >= 1

    def test_stalled_reassignment_marked_dead_not_spinning(self):
        plan = FaultPlan(seed=7).stall_reassignments(tps=[("T", 0)])
        chaos, executor, summary, events = run_plan(plan, task_timeout_s=0.05)
        assert_invariants(chaos, executor, summary, events)
        assert summary.dead >= 1
        assert summary.duration_s < 30.0
        assert REGISTRY.counter(STUCK_TASKS_COUNTER).snapshot() >= 1

    def test_stalled_reassignment_rollback_restores_old_replicas(self):
        plan = FaultPlan(seed=7).stall_reassignments(tps=[("T", 0)])
        chaos, executor, summary, events = run_plan(plan, task_timeout_s=0.05, rollback_stuck_tasks=True)
        assert_invariants(chaos, executor, summary, events)
        assert summary.dead >= 1
        by_tp = {i.tp: i for infos in chaos.describe_topics().values() for i in infos}
        assert set(by_tp[("T", 0)].replicas) == {0, 1}
        assert not chaos.stalled_reassignments

    def test_metric_feed_gap_degrades_to_empty_fetch(self):
        chaos = ChaosBackend(make_backend(), FaultPlan(seed=7).metric_gap(1, 3))
        assert chaos.fetch_raw_metrics(0, 60_000)
        assert chaos.fetch_raw_metrics(0, 60_000) == []
        assert chaos.fetch_raw_metrics(0, 60_000) == []
        assert chaos.fetch_raw_metrics(0, 60_000)
        assert chaos.faults_by_kind().get("metric_gap") == 2

    def test_retry_exhausted_degrades_to_error_summary(self):
        plan = FaultPlan(seed=7).raise_n_times("alter_partition_reassignments", 99)
        chaos, executor, summary, events = run_plan(plan, retry_policy=fast_retry(max_attempts=3))
        assert_invariants(chaos, executor, summary, events)
        assert not summary.succeeded
        assert summary.error is not None and "RetryExhaustedError" in summary.error

    def test_stalled_leadership_reorder_marked_dead_not_completed(self):
        plan = FaultPlan(seed=7).stall_reassignments(tps=[("T", 2)])
        chaos, executor, summary, events = run_plan(plan, task_timeout_s=0.05)
        assert_invariants(chaos, executor, summary, events)
        assert summary.dead >= 1
        lead = [t for t in executor._planner.leadership if t.proposal.tp == ("T", 2)]
        assert lead and lead[0].state is TaskState.DEAD

    def test_replayed_alter_conflict_assumed_applied(self):
        state = {"applied": 0, "calls": 0}

        def flaky_alter(reassignments):
            state["calls"] += 1
            if state["calls"] == 1:
                state["applied"] += 1
                raise ChaosInjectedError("response lost")
            raise ReassignmentInProgress("already reassigning")

        policy = fast_retry()
        result = policy.call(
            flaky_alter, {("T", 0): (2, 1)}, op_name="backend.alter_partition_reassignments",
            assume_applied_on=(ReassignmentInProgress,),
        )
        assert result is None and state["applied"] == 1 and state["calls"] == 2
        with pytest.raises(ReassignmentInProgress):
            policy.call(lambda r: (_ for _ in ()).throw(ReassignmentInProgress("busy")), {},
                        assume_applied_on=(ReassignmentInProgress,))

    def test_fatal_error_mid_flight_counts_failed_tasks(self):
        plan = FaultPlan(seed=7).raise_n_times("list_partition_reassignments", 99, exc=lambda m: ValueError("fatal"))
        chaos, executor, summary, events = run_plan(plan)
        assert_invariants(chaos, executor, summary, events)
        assert summary.error is not None and "ValueError" in summary.error
        assert summary.failed >= 1
        trace = RECORDER.recent(50, kind="execution")[0]
        assert trace.attrs["error"] == summary.error and trace.attrs["failed"] == summary.failed

    def test_crash_after_is_deterministic_and_fatal(self):
        chaos = ChaosBackend(make_backend(), FaultPlan(seed=7).crash_after("describe_topics", 2))
        chaos.describe_topics()
        chaos.describe_topics()
        for _ in range(2):
            with pytest.raises(SimulatedCrash):
                chaos.describe_topics()
        assert [k for _, k, _ in chaos.fault_log] == ["crash", "crash"]


# -- determinism, across packages ------------------------------------------------------


def _coin_log(chaos_cls, plan_cls, fake_cls, err, seed, p=0.5, calls=20):
    chaos = chaos_cls(make_backend(cls=fake_cls), plan_cls(seed=seed).raise_with_probability("describe_topics", p))
    for _ in range(calls):
        try:
            chaos.describe_topics()
        except err:
            pass
    return list(chaos.fault_log)


class TestDeterminism:
    def test_same_seed_same_fault_log(self):
        logs = [_coin_log(ChaosBackend, FaultPlan, FakeClusterBackend, ChaosInjectedError, 123) for _ in range(2)]
        assert logs[0] == logs[1] and logs[0]

    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_fault_log_equals_the_jax_backends(self, seed):
        port = _coin_log(ChaosBackend, FaultPlan, FakeClusterBackend, ChaosInjectedError, seed, p=0.3, calls=40)
        jax = _coin_log(JChaosBackend, JFaultPlan, JFake, JChaosInjectedError, seed, p=0.3, calls=40)
        assert port == jax and port

    def test_execution_under_one_plan_equals_the_jax_execution(self):
        """One fault plan (a stall, every other progress check failing, a
        flap) through both packages' executors: the same fault log, summary
        counts, admin log and placement."""
        from cruise_control_tpu.analyzer.proposals import ExecutionProposal as JProposal
        from cruise_control_tpu.core.retry import RetryPolicy as JRetryPolicy
        from cruise_control_tpu.executor import Executor as JExecutor

        out = {}
        for side, (chaos_cls, plan_cls, fake, ex_cls, prop, retry) in {
            "jax": (JChaosBackend, JFaultPlan, JFake, JExecutor, JProposal, JRetryPolicy),
            "port": (ChaosBackend, FaultPlan, FakeClusterBackend, Executor, ExecutionProposal, RetryPolicy),
        }.items():
            plan = (plan_cls(seed=7).stall_reassignments(tps=[("T", 1)])
                    .raise_every("list_partition_reassignments", 2).flap_broker(0, 40, 45))
            chaos = chaos_cls(make_backend(cls=fake), plan)
            ex = ex_cls(chaos, retry_policy=retry(max_attempts=5, base_backoff_s=0.0, sleep=lambda s: None, seed=42),
                        progress_check_interval_s=0.001, task_timeout_s=10.0, max_progress_checks=20)
            s = ex.execute_proposals([prop(tp=tp, partition_size=100.0, old_leader=old[0], old_replicas=tuple(old),
                                           new_replicas=tuple(new)) for tp, old, new in PROPOSALS])
            placement = {i.tp: (i.replicas, i.leader) for infos in chaos.describe_topics().values() for i in infos}
            out[side] = (chaos.fault_log, (s.completed, s.dead, s.aborted, s.failed, s.total), chaos.admin_log,
                         placement)
        assert out["port"] == out["jax"]


# -- the chaos journal: the same wreck on disk -----------------------------------------


def _wreck(journal_cls, crash, plan, path, **kw):
    j = journal_cls(str(path), plan=plan, **kw)
    n = 0
    with pytest.raises(crash):
        while n < 10:
            j.append({"i": n})
            n += 1
    files = {f: (path / f).read_bytes() for f in sorted(os.listdir(path))}
    return j.fault_log, files


@pytest.mark.parametrize("fault", ["torn_tail", "lose_fsync_suffix", "rotation_crash"])
def test_chaos_journal_wreck_equals_the_jax_wreck(tmp_path, fault):
    """Each journal fault shape leaves byte-identical files in both
    packages, and each package's journal recovers either wreck to the same
    clean prefix."""
    def plan(cls):
        p = cls(seed=7)
        return {"torn_tail": lambda: p.torn_tail(after_appends=2),
                "lose_fsync_suffix": lambda: p.lose_fsync_suffix(after_appends=3, lose=2),
                "rotation_crash": lambda: p.rotation_crash(rotation_no=1)}[fault]()

    kw = {"max_segment_records": 3} if fault == "rotation_crash" else {}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jlog, jfiles = _wreck(JChaosJournal, JSimulatedCrash, plan(JFaultPlan), tmp_path / "jax", **kw)
    plog, pfiles = _wreck(ChaosJournal, SimulatedCrash, plan(FaultPlan), tmp_path / "port", **kw)
    assert plog == jlog and [k for k, _ in plog] == [{"lose_fsync_suffix": "fsync_lost_suffix"}.get(fault, fault)]
    assert pfiles == jfiles
    if fault == "rotation_crash":
        assert "segment-000000.jsonl.open" in pfiles
    want = {"torn_tail": [0, 1], "lose_fsync_suffix": [0], "rotation_crash": [0, 1, 2]}[fault]
    for side in ("jax", "port"):
        for journal_cls in (Journal, JJournal):
            d = tmp_path / f"{side}-{journal_cls.__module__.split('.')[0]}"
            d.mkdir()
            for name, data in (pfiles if side == "port" else jfiles).items():
                (d / name).write_bytes(data)
            assert [r["i"] for r in journal_cls(str(d), **kw).replay()] == want


# -- the circuit breaker on a fake clock, against the JAX breaker -----------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _breaker(cls, clock, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("open_s", 10.0)
    kw.setdefault("backoff_multiplier", 2.0)
    kw.setdefault("max_open_s", 60.0)
    kw.setdefault("jitter", 0.0)
    return cls(clock=clock, **kw)


def _script(breaker_cls, open_error, jitter):
    """A fixed walk through the state machine: trips, fast failures, probes
    that fail, hang and succeed.  Returns every observable after each step."""
    clock = FakeClock()
    br = _breaker(breaker_cls, clock, jitter=jitter, seed=5)
    err = ConnectionError("down")
    trail = []

    def look(step, out=None):
        trail.append((step, out, br.state, br.is_open, round(br.retry_after_s(), 9), br.snapshot()))

    def call(op="describe_cluster"):
        try:
            return br.before_call(op)
        except open_error as e:
            return ("open", round(e.retry_after_s, 9))

    for step in range(2):
        br.record_failure(err)
        look(f"fail{step}")
    br.record_success()
    look("reset")
    for step in range(3):
        br.record_failure(err)
        look(f"trip{step}")
    look("fast", call())
    clock.t += 10.01 * (1 + jitter)
    look("probe", call())
    look("guarded", call())
    br.record_failure(err, probe=True)
    look("probe-failed")
    clock.t += 25.0 * (1 + jitter)
    look("probe2", call())
    clock.t += 25.0 * (1 + jitter)
    look("reclaimed", call())
    br.record_success(probe=True)
    look("closed", call())
    return trail


@pytest.mark.parametrize("jitter", [0.0, 0.1])
def test_breaker_transitions_equal_the_jax_breaker(jitter):
    assert _script(CircuitBreaker, BreakerOpenError, jitter) == _script(JCircuitBreaker, JBreakerOpenError, jitter)


class TestCircuitBreaker:
    def test_fail_fast_then_single_probe_then_close(self):
        clock = FakeClock()
        br = _breaker(CircuitBreaker, clock)
        for _ in range(3):
            br.record_failure(ConnectionError("down"))
        with pytest.raises(BreakerOpenError) as exc:
            br.before_call("describe_cluster")
        assert exc.value.retry_after_s == pytest.approx(10.0, abs=0.1) and br.fast_failures == 1
        clock.t += 10.01
        assert br.before_call("describe_cluster") is True
        with pytest.raises(BreakerOpenError):
            br.before_call("describe_cluster")
        br.record_success(probe=True)
        assert not br.is_open and br.closes == 1
        assert br.before_call("describe_cluster") is False

    def test_breaker_backend_guards_and_delegates(self):
        clock = FakeClock()
        br = _breaker(CircuitBreaker, clock, failure_threshold=2)
        inner = ChaosBackend(make_backend(), FaultPlan(seed=7).raise_n_times("describe_cluster", 2))
        bb = BreakerBackend(inner, br)
        for _ in range(2):
            with pytest.raises(ChaosInjectedError):
                bb.describe_cluster()
        assert br.is_open
        with pytest.raises(BreakerOpenError):
            bb.describe_cluster()
        assert inner.calls["describe_cluster"] == 2      # fail-fast never touched the backend
        bb.kill_broker(1)                                  # unknown attributes delegate
        clock.t += 10.01
        assert 1 not in bb.describe_cluster().alive_ids()  # the probe closes it
        assert not br.is_open

    def test_retry_policy_treats_open_breaker_as_fatal(self):
        policy = RetryPolicy(max_attempts=5, base_backoff_s=0.0, sleep=lambda s: None)
        calls = []

        def fn():
            calls.append(1)
            raise BreakerOpenError("backend.describe_cluster", 5.0)

        with pytest.raises(BreakerOpenError):
            policy.call(fn, op_name="backend.describe_cluster")
        assert len(calls) == 1


# -- detector resilience -----------------------------------------------------------------


class _FixCounting(Anomaly):
    def __init__(self, box):
        super().__init__()
        self.anomaly_type = AnomalyType.MAINTENANCE_EVENT
        self.box = box

    def fix_with(self, cc):
        self.box.append(self.anomaly_id)
        return "fixed"


class _RaiseOnceNotifier(AnomalyNotifier):
    def __init__(self):
        self.raised = False

    def on_anomaly(self, anomaly):
        if not self.raised:
            self.raised = True
            raise RuntimeError("notifier webhook exploded")
        return NotificationResult.fix()


class TestDetectorResilience:
    def test_handler_loop_survives_raising_notifier(self):
        fixed = []
        manager = AnomalyDetectorManager(cruise_control=None, notifier=_RaiseOnceNotifier(), detectors=[])
        manager.start_detection()
        try:
            manager._enqueue(_FixCounting(fixed))
            manager._enqueue(_FixCounting(fixed))
            deadline = time.monotonic() + 5.0
            while len(fixed) < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            handler = manager._threads[-1]
            assert handler.is_alive(), "handler thread died on a raising notifier"
            assert len(fixed) == 1
            assert manager.num_self_healing_failed >= 1
        finally:
            manager.shutdown()
        assert not any(t.is_alive() for t in threading.enumerate() if t is handler)

    def test_execution_failure_detector_emits_once(self):
        plan = FaultPlan(seed=7).raise_n_times("alter_partition_reassignments", 99, exc=lambda m: ValueError("fatal"))
        chaos, executor, summary, events = run_plan(plan)
        det = ExecutionFailureDetector(executor)
        (a,) = det.run()
        assert isinstance(a, ExecutionFailure)
        assert a.execution_id == summary.execution_id and a.error == summary.error
        assert det.run() == []

    def test_degraded_summary_not_lost_to_newer_execution(self):
        plan = FaultPlan(seed=7).raise_n_times("alter_partition_reassignments", 1, exc=lambda m: ValueError("fatal"))
        chaos = ChaosBackend(make_backend(), plan)
        executor, events = make_executor(chaos)
        det = ExecutionFailureDetector(executor)
        degraded = executor.execute_proposals([move_proposal(("T", 0), [0, 1], [2, 1])])
        assert degraded.error is not None
        clean = executor.execute_proposals([move_proposal(("T", 1), [1, 2], [1, 3])])
        assert clean.succeeded and executor.last_summary is clean
        assert [a.execution_id for a in det.run()] == [degraded.execution_id]
        assert det.run() == []

    def test_execution_failure_detector_ignores_clean_and_stopped(self):
        chaos, executor, summary, events = run_plan(FaultPlan())
        assert summary.succeeded
        assert ExecutionFailureDetector(executor).run() == []

    def test_open_breaker_skips_the_detection_pass(self):
        """A pass against a blacked-out backend is skipped with a counted
        reason and a ``detector`` record, not run."""
        from cruise_control_tpu_torch.detector import BrokerFailureDetector

        clock = FakeClock()
        br = _breaker(CircuitBreaker, clock, failure_threshold=1)
        br.record_failure(ConnectionError("down"))
        det = BrokerFailureDetector(make_backend(), os.devnull + ".missing", now_ms=lambda: 0)
        manager = AnomalyDetectorManager(None, AnomalyNotifier(), detectors=[], breaker=br)
        before = REGISTRY.counter("AnomalyDetector.passes-skipped-breaker-open").snapshot()
        assert manager.run_detector_once(det) == 0
        assert REGISTRY.counter("AnomalyDetector.passes-skipped-breaker-open").snapshot() == before + 1
        rec = RECORDER.recent(1, kind="detector")[0]
        assert rec.attrs == {"detector": "BrokerFailureDetector", "skipped": "breaker-open"}


# -- stop semantics under chaos --------------------------------------------------------


class TestStopUnderChaos:
    def test_stop_mid_execution_with_faults_still_accounts(self):
        plan = FaultPlan(seed=7).raise_every("list_partition_reassignments", 2)
        chaos = ChaosBackend(make_backend(latency=50), plan)
        executor, events = make_executor(chaos)
        executor.execute_proposals([move_proposal(tp, old, new) for tp, old, new in PROPOSALS], wait=False)
        time.sleep(0.03)
        executor.stop_execution()
        summary = executor.await_completion(timeout_s=30)
        assert summary is not None and summary.stopped
        assert_invariants(chaos, executor, summary, events)
