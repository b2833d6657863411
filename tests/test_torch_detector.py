"""The port's detector layer and self-healing loop against the JAX package, on
the CPU.

One scripted scenario runs on both packages' stacks over the JAX detector
tests' fake cluster (``tests/test_detector.py::build_cc``, with
``tests.fixtures.service_test_goals()``): a goal-violation detection and its
fix, a broker failure held back by the notifier's grace period and then
fixed, an offline logdir and its fix.  The anomalies, the notifier's
actions, every fix's proposals, the backend's admin log and final placement,
``manager.state()`` and the flight records' shapes must be identical.  Then
the cases of ``tests/test_detector.py`` run on the port (the two the JAX
package marks ``slow`` stay ``slow``; the app's readiness wiring waits for
the port's app), and the threaded manager self-heals a dead broker within a
bounded wait.
"""

import dataclasses
import time

import pytest

from chip_smoke import backend_placement
from cruise_control_tpu import detector as JD
from cruise_control_tpu.backend import FakeClusterBackend as JFake
from cruise_control_tpu.core.resources import Resource as JResource
from cruise_control_tpu.executor import Executor as JExecutor
from cruise_control_tpu.facade import CruiseControl as JCruiseControl
from cruise_control_tpu.monitor import BackendMetricSampler as JSampler
from cruise_control_tpu.monitor import LoadMonitor as JLoadMonitor
from cruise_control_tpu.monitor import StaticCapacityResolver as JStatic
from cruise_control_tpu_torch import detector as PD
from cruise_control_tpu_torch.analyzer.optimizer import MAX_BALANCEDNESS_SCORE
from cruise_control_tpu_torch.backend import FakeClusterBackend
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.detector import (
    AnomalyDetectorManager,
    AnomalyNotifier,
    BrokerFailureDetector,
    DiskFailureDetector,
    GoalViolationDetector,
    MaintenanceEvent,
    MaintenanceEventDetector,
    MaintenanceEventType,
    NoopNotifier,
    SelfHealingNotifier,
    TopicReplicationFactorAnomalyFinder,
)
from cruise_control_tpu_torch.detector.detectors import Detector
from cruise_control_tpu_torch.executor import Executor
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor import BackendMetricSampler, LoadMonitor, StaticCapacityResolver
from tests.fixtures import service_test_goals
from tests.torch_port_helpers import clear_records, recorded_shapes

WINDOW_MS = 60_000
GOALS = service_test_goals()
SIDES = {
    "jax": (JFake, JSampler, JStatic, JLoadMonitor, JExecutor, JCruiseControl, JResource, JD, {}),
    "port": (FakeClusterBackend, BackendMetricSampler, StaticCapacityResolver, LoadMonitor, Executor,
             CruiseControl, Resource, PD, {"device": "cpu"}),
}


def build_cc(side="port", num_brokers=6, partitions=24, skew=3):
    """``tests/test_detector.py::build_cc`` for either package."""
    fake, sampler, static, monitor_cls, executor_cls, cc_cls, res, _, kw = SIDES[side]
    backend = fake()
    for b in range(num_brokers):
        backend.add_broker(b, rack=str(b % 3))
    for p in range(partitions):
        reps = [(p % skew), (p % skew + 1) % num_brokers]
        backend.create_partition(("T", p), reps, load=[1.5, 4e3, 6e3, 3e4])
    capacity = {res.CPU: 100.0, res.NW_IN: 1e6, res.NW_OUT: 1e6, res.DISK: 1e7}
    monitor = monitor_cls(backend, sampler(backend), static(capacity), num_windows=4, window_ms=WINDOW_MS)
    executor = executor_cls(backend, pause_sampling=monitor.pause_sampling, resume_sampling=monitor.resume_sampling)
    cc = cc_cls(backend, monitor, executor, goal_ids=GOALS, enable_heavy_goals=False, **kw)
    cc.start()
    for w in range(6):
        monitor.sample_once(now_ms=(w + 1) * WINDOW_MS)
    return backend, monitor, cc


def _anomaly(a) -> dict:
    """An anomaly as plain data, without its id, clock and fix result."""
    d = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)
         if f.name not in ("anomaly_id", "detected_ms", "fix_result")}
    d["anomaly_type"] = a.anomaly_type.name
    d["description"] = a.description()
    return d


def _fix(a) -> tuple:
    """A fix result: its proposals and execution counts."""
    res = a.fix_result
    s = res.execution
    return ([dataclasses.astuple(p) for p in res.optimizer_result.proposals],
            s and (s.completed, s.dead, s.aborted, s.failed, s.total, s.succeeded))


def _detect(manager, detector):
    """One detection pass through the manager (its ``detector`` record), and
    the anomaly it queued."""
    assert manager.run_detector_once(detector) == 1
    return manager._next_anomaly(timeout_s=0.0)


def scenario(side, tmp_path):
    """The scripted self-healing pass on one package; everything it saw as
    plain data."""
    D = SIDES[side][7]
    backend, monitor, cc = build_cc(side, skew=2)
    clock = {"now": 1_000_000}
    notifier = D.SelfHealingNotifier(
        broker_failure_alert_threshold_ms=10_000, broker_failure_self_healing_threshold_ms=20_000,
        now_ms=lambda: clock["now"],
    )
    manager = D.AnomalyDetectorManager(cc, notifier, detectors=[])
    out = {}

    # 1. goal violations on the skewed start, fixed by a rebalance
    gv = D.GoalViolationDetector(cc, GOALS)
    a = _detect(manager, gv)
    out["goal"] = (_anomaly(a), gv.balancedness_score, manager.handle_anomaly(a), _fix(a))
    out["goal_after"] = [_anomaly(x) for x in gv.run()]

    # 2. a dead broker: CHECK inside the grace period, FIXED after it
    backend.kill_broker(1)
    bf = D.BrokerFailureDetector(backend, str(tmp_path / side / "fb.json"), now_ms=lambda: clock["now"])
    first = manager.handle_anomaly(_detect(manager, bf))
    clock["now"] += 25_000
    a = _detect(manager, bf)
    out["broker"] = (_anomaly(a), first, manager.handle_anomaly(a), _fix(a))

    # 3. broker 5's only logdir goes offline: its replicas are offline on a
    #    live broker, and the fix relocates them.  A dry run of the fix with
    #    no goals is the offline pre-phase alone: which partitions it moves
    #    off broker 5
    offline = sorted(tp for tp, (replicas, _) in backend_placement(backend).items() if 5 in replicas)
    backend.kill_logdir(5, "/data/d0")
    a = _detect(manager, D.DiskFailureDetector(backend))
    pre = cc.fix_offline_replicas(dryrun=True, goal_ids=()).optimizer_result.proposals
    out["pre_phase_moved_off"] = sorted(p.tp for p in pre if 5 in p.old_replicas and 5 not in p.new_replicas)
    out["disk"] = (_anomaly(a), manager.handle_anomaly(a), _fix(a), offline)

    st = dataclasses.asdict(manager.state())
    st.pop("mean_time_between_anomalies_ms")
    out["state"] = st
    out["admin_log"] = backend.admin_log
    out["placement"] = backend_placement(backend)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("detector")
    out = {}
    for side in ("jax", "port"):
        clear_records()
        out[side] = scenario(side, tmp)
        out[side + "_records"] = {k: recorded_shapes(k)[side == "port"] for k in ("detector", "anomaly")}
    return out


def test_goal_violations_and_their_fix_equal_the_jax_detector(both):
    j, p = both["jax"]["goal"], both["port"]["goal"]
    assert p == j
    anomaly, score, action, (proposals, execution) = p
    assert anomaly["violated_goals"] and anomaly["fixable"] and score < MAX_BALANCEDNESS_SCORE
    assert action == "FIXED" and proposals and execution[-1]
    # re-detection after the fix finds fewer violated goals
    after = both["port"]["goal_after"]
    assert after == both["jax"]["goal_after"]
    assert (len(after[0]["violated_goals"]) if after else 0) < len(anomaly["violated_goals"])


def test_broker_failure_waits_out_the_grace_period_then_drains(both):
    assert both["port"]["broker"] == both["jax"]["broker"]
    anomaly, first, action, (proposals, execution) = both["port"]["broker"]
    assert anomaly["failed_brokers"] == {1: 1_000_000}
    assert (first, action) == ("CHECK", "FIXED") and execution[-1]
    assert all(1 not in replicas for replicas, _ in both["port"]["placement"].values())


def test_offline_logdir_is_fixed_like_the_jax_detector(both):
    """The fix's offline pre-phase moves every replica off the dead logdir,
    but the goals after it refill the broker (alive, BAD_DISKS).  A
    partition whose replica they put back on it is not moved at all, so that
    replica never leaves the dead logdir; the others land on it, offline
    again.  The JAX package does exactly the same (ROADMAP Queue C, C4)."""
    assert both["port"]["disk"] == both["jax"]["disk"]
    anomaly, action, (proposals, execution), offline = both["port"]["disk"]
    assert anomaly["failed_disks"] == {5: ["/data/d0"]}
    assert action == "FIXED" and proposals and execution[-1] and offline
    for side in ("jax", "port"):
        assert both[side]["pre_phase_moved_off"] == offline
    on_5 = {side: [tp for tp, (replicas, _) in both[side]["placement"].items() if 5 in replicas]
            for side in ("jax", "port")}
    assert on_5["port"] == on_5["jax"]
    never_left = {side: [tp for tp in offline if tp in on_5[side]] for side in ("jax", "port")}
    assert never_left["jax"] and never_left["port"] == never_left["jax"]
    assert len(never_left["port"]) < len(offline)


def test_admin_log_placement_state_and_records_equal_the_jax_run(both):
    j, p = both["jax"], both["port"]
    assert p["admin_log"] == j["admin_log"] and p["placement"] == j["placement"]
    assert p["state"] == j["state"]
    assert p["state"]["num_self_healing_started"] == 3 and p["state"]["num_self_healing_failed"] == 0
    assert both["port_records"] == both["jax_records"]
    assert [r[0] for r in both["port_records"]["anomaly"]] == ["anomaly"] * 4
    assert [r[0] for r in both["port_records"]["detector"]] == ["detector"] * 4


# -- the cases of tests/test_detector.py on the port --------------------------------------


class TestBrokerFailureDetector:
    def test_detects_and_persists_failure_times(self, tmp_path):
        backend, monitor, cc = build_cc()
        path = str(tmp_path / "failed_brokers.json")
        det = BrokerFailureDetector(backend, path, now_ms=lambda: 12345)
        assert det.run() == []
        backend.kill_broker(1)
        (anomaly,) = det.run()
        assert anomaly.failed_brokers == {1: 12345}
        det2 = BrokerFailureDetector(backend, path, now_ms=lambda: 99999)
        assert det2.run()[0].failed_brokers == {1: 12345}

    def test_recovered_broker_cleared(self, tmp_path):
        backend, monitor, cc = build_cc()
        det = BrokerFailureDetector(backend, str(tmp_path / "fb.json"))
        backend.kill_broker(2)
        assert det.run()
        backend.restart_broker(2)
        assert det.run() == []


class TestSelfHealingLoop:
    @pytest.mark.slow
    def test_broker_failure_grace_period(self, tmp_path):
        backend, monitor, cc = build_cc()
        clock = {"now": 1_000_000}
        notifier = SelfHealingNotifier(
            broker_failure_alert_threshold_ms=10_000, broker_failure_self_healing_threshold_ms=20_000,
            now_ms=lambda: clock["now"],
        )
        det = BrokerFailureDetector(backend, str(tmp_path / "fb.json"), now_ms=lambda: clock["now"])
        manager = AnomalyDetectorManager(cc, notifier, detectors=[])
        backend.kill_broker(1)
        (anomaly,) = det.run()
        assert manager.handle_anomaly(anomaly) == "CHECK"
        clock["now"] += 25_000
        (anomaly2,) = det.run()
        assert manager.handle_anomaly(anomaly2) == "FIXED"
        for infos in backend.describe_topics().values():
            for i in infos:
                assert 1 not in i.replicas, f"{i.tp} still on dead broker"

    def test_noop_notifier_ignores(self, tmp_path):
        backend, monitor, cc = build_cc()
        det = BrokerFailureDetector(backend, str(tmp_path / "fb.json"))
        manager = AnomalyDetectorManager(cc, NoopNotifier(), detectors=[])
        backend.kill_broker(1)
        (anomaly,) = det.run()
        assert manager.handle_anomaly(anomaly) == "IGNORE"
        assert manager.num_self_healing_started == 0


class TestDiskFailure:
    def test_offline_logdir_detected(self):
        backend = FakeClusterBackend()
        backend.add_broker(0, rack="0", logdirs={"/d0": 1e12, "/d1": 1e12})
        backend.add_broker(1, rack="1")
        backend.kill_logdir(0, "/d1")
        (anomaly,) = DiskFailureDetector(backend).run()
        assert anomaly.failed_disks == {0: ["/d1"]}


class TestGoalViolationDetector:
    @pytest.mark.slow
    def test_skewed_cluster_reports_violations_and_balancedness(self):
        backend, monitor, cc = build_cc(skew=2)
        det = GoalViolationDetector(cc)
        anomalies = det.run()
        assert anomalies and anomalies[0].violated_goals
        assert det.balancedness_score < MAX_BALANCEDNESS_SCORE

    def test_goal_violation_fix_rebalances(self):
        backend, monitor, cc = build_cc(skew=2)
        det = GoalViolationDetector(cc, GOALS)
        manager = AnomalyDetectorManager(cc, AnomalyNotifier(), detectors=[])
        (anomaly,) = det.run()
        assert manager.handle_anomaly(anomaly) == "FIXED"
        assert anomaly.fix_result.execution is not None
        anomalies_after = det.run()
        after = len(anomalies_after[0].violated_goals) if anomalies_after else 0
        assert after < len(anomaly.violated_goals)


class TestTopicAnomaly:
    def test_rf_mismatch_detected(self):
        backend = FakeClusterBackend()
        for b in range(3):
            backend.add_broker(b, rack=str(b))
        backend.create_partition(("good", 0), [0, 1, 2], load=[1, 1, 1, 1])
        backend.create_partition(("bad", 0), [0], load=[1, 1, 1, 1])
        (anomaly,) = TopicReplicationFactorAnomalyFinder(backend, target_rf=3).run()
        assert anomaly.bad_topics == {"bad": 1}


class TestMaintenanceEvents:
    def test_dedupe_and_fix(self):
        det = MaintenanceEventDetector()
        det.submit(MaintenanceEvent(event_type=MaintenanceEventType.REBALANCE))
        det.submit(MaintenanceEvent(event_type=MaintenanceEventType.REBALANCE))
        assert len(det.run()) == 1


class TestManagerState:
    def test_state_reporting(self, tmp_path):
        out = {}
        for side in ("jax", "port"):
            D = SIDES[side][7]
            backend, monitor, cc = build_cc(side)
            det = D.BrokerFailureDetector(backend, str(tmp_path / f"{side}.json"))
            manager = D.AnomalyDetectorManager(cc, D.SelfHealingNotifier(), detectors=[(det, 60.0)])
            backend.kill_broker(1)
            manager.run_detector_once(det)
            st = dataclasses.asdict(manager.state())
            out[side] = (st, sorted(st))
        st = out["port"][0]
        assert st["queue_size"] == 1
        assert st["recent_anomalies"]["BROKER_FAILURE"]
        assert st["self_healing_enabled"]["GOAL_VIOLATION"] is True
        assert out["port"] == out["jax"]


class TestInitialDetectionPass:
    class _CountingDetector(Detector):
        name = "CountingDetector"

        def __init__(self):
            self.runs = 0

        def run(self):
            self.runs += 1
            return []

    def _poll(self, fn, timeout_s=10.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if fn():
                return True
            time.sleep(0.02)
        return False

    def test_immediate_pass_fires_once_ready(self):
        det = self._CountingDetector()
        ready = {"ok": False}
        manager = AnomalyDetectorManager(None, NoopNotifier(), detectors=[(det, 3_600.0)],
                                         initial_pass=True, ready_probe=lambda: ready["ok"])
        manager.start_detection()
        try:
            time.sleep(0.3)
            assert det.runs == 0
            ready["ok"] = True
            assert self._poll(lambda: det.runs >= 1)
            time.sleep(0.3)
            assert det.runs == 1
        finally:
            manager.shutdown()

    def test_default_behavior_unchanged_without_initial_pass(self):
        det = self._CountingDetector()
        manager = AnomalyDetectorManager(None, NoopNotifier(), detectors=[(det, 3_600.0)])
        manager.start_detection()
        try:
            time.sleep(0.4)
            assert det.runs == 0
        finally:
            manager.shutdown()

    def test_raising_probe_reads_as_not_ready(self):
        det = self._CountingDetector()

        def probe():
            raise RuntimeError("backend down")

        manager = AnomalyDetectorManager(None, NoopNotifier(), detectors=[(det, 3_600.0)],
                                         initial_pass=True, ready_probe=probe)
        manager.start_detection()
        try:
            time.sleep(0.3)
            assert det.runs == 0
        finally:
            manager.shutdown()


def test_threaded_manager_drains_a_dead_broker(tmp_path):
    """``start_detection`` with the broker-failure and goal-violation
    detectors on short intervals: a killed broker is drained by the
    handler thread while the goal detector keeps solving, within a bounded
    wait; ``shutdown`` stops every thread."""
    backend, monitor, cc = build_cc()
    notifier = SelfHealingNotifier(broker_failure_alert_threshold_ms=0, broker_failure_self_healing_threshold_ms=0)
    detectors = [(BrokerFailureDetector(backend, str(tmp_path / "fb.json")), 0.05),
                 (GoalViolationDetector(cc, GOALS), 0.05)]
    manager = AnomalyDetectorManager(cc, notifier, detectors=detectors)
    backend.kill_broker(3)
    manager.start_detection()
    threads = list(manager._threads)
    try:
        deadline = time.monotonic() + 60.0
        drained = False
        while not drained and time.monotonic() < deadline:
            time.sleep(0.05)
            drained = not cc.executor.has_ongoing_execution and all(
                3 not in replicas for replicas, _ in backend_placement(backend).values())
        assert drained, "broker 3 was not drained within 60 s"
    finally:
        manager.shutdown()
        for t in threads:           # a pass in the middle of a solve ends first
            t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    assert manager.num_self_healing_started >= 1
