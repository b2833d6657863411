"""The periodic anomaly detectors.

Port of ``cruise_control_tpu/detector/detectors.py`` (copied).
:class:`GoalViolationDetector` solves through ``cc.rebalance(dryrun=True)``,
so on the facade's device; the others read only the backend, the monitor or
the executor, on the host.  :class:`SelfMetricAnomalyFinder` takes its SLO
engine as an argument.

Counterparts (detector/ package, SURVEY §2.3):

* :class:`GoalViolationDetector` — GoalViolationDetector.java:54: dry solver run
  over the detection goals on a fresh model; maintains the balancedness gauge.
* :class:`BrokerFailureDetector` — KafkaBrokerFailureDetector.java:42 +
  AbstractBrokerFailureDetector.java:36: metadata diff against known brokers with
  failure times persisted to a local file so grace periods survive restarts.
* :class:`DiskFailureDetector` — DiskFailureDetector.java: offline logdirs.
* :class:`SlowBrokerFinder` — SlowBrokerFinder.java:109: log-flush-time p999
  screened by absolute threshold, own history, and peer comparison.
* :class:`TopicReplicationFactorAnomalyFinder` — topics off the target RF.
* :class:`MaintenanceEventDetector` — reads planned ops from a pluggable queue
  with idempotence-cache dedupe.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.optimizer import (
    MAX_BALANCEDNESS_SCORE,
    balancedness_cost_by_goal,
)
from cruise_control_tpu_torch.backend.base import ClusterBackend
from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    MaintenanceEvent,
    SlowBrokers,
    TopicReplicationFactorAnomaly,
)
from cruise_control_tpu_torch.monitor.completeness import NotEnoughValidSnapshotsError


class Detector:
    """One periodic detector: ``run()`` returns newly found anomalies."""

    name = "Detector"

    def run(self) -> List[Anomaly]:  # pragma: no cover - abstract
        raise NotImplementedError


class GoalViolationDetector(Detector):
    name = "GoalViolationDetector"

    def __init__(
        self,
        cruise_control,
        detection_goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
        provisioner=None,
        planner=None,
    ) -> None:
        self.cc = cruise_control
        self.detection_goal_ids = tuple(detection_goal_ids)
        self.balancedness_score: float = MAX_BALANCEDNESS_SCORE
        self.last_result = None
        #: optional Provisioner consulted on non-RIGHT_SIZED verdicts
        #: (GoalViolationDetector.java:227 rightsize hook)
        self.provisioner = provisioner
        self.last_provisioner_result = None
        #: optional zero-arg capacity planner (facade.plan_capacity) run before
        #: rightsize so the recommendation carries sweep-backed numbers instead
        #: of the optimizer's single-model heuristic
        self.planner = planner
        #: last planner exception (also counted by the
        #: GoalViolationDetector.planner-failures sensor)
        self.last_planner_error: Optional[Exception] = None

    def run(self) -> List[Anomaly]:
        try:
            op = self.cc.rebalance(
                dryrun=True,
                goal_ids=self.detection_goal_ids,
                triggered_by_violation=True,
            )
        except NotEnoughValidSnapshotsError:
            return []
        result = op.optimizer_result
        self.last_result = result
        # Gauge semantics follow GoalViolationDetector.java:283-285: start from
        # the max score and subtract each *detected* (pre-fix) violated goal's
        # priority/strictness-weighted cost.
        ids = [r.goal_id for r in result.goal_reports]
        hard = {r.goal_id for r in result.goal_reports if r.is_hard}
        costs = balancedness_cost_by_goal(ids, hard)
        self.balancedness_score = MAX_BALANCEDNESS_SCORE - sum(
            costs[r.goal_id] for r in result.goal_reports if r.violations_before > 0
        )
        from cruise_control_tpu_torch.core.sensors import BALANCEDNESS_GAUGE, REGISTRY

        REGISTRY.gauge(BALANCEDNESS_GAUGE).set(self.balancedness_score)
        if self.provisioner is not None and result.provision.status != "RIGHT_SIZED":
            rec = result.provision
            if self.planner is not None:
                try:
                    plan = self.planner()
                    # the sweep-backed recommendation carries measured numbers;
                    # keep the optimizer's violated-goal list (the sweep has no
                    # notion of which goal refused)
                    plan.recommendation.violated_hard_goals = rec.violated_hard_goals
                    rec = plan.recommendation
                except Exception as e:
                    # planner failure must not break detection, but it must be
                    # visible — a systematic crash here silently downgrades
                    # every rightsize to the unquantified placeholder
                    from cruise_control_tpu_torch.core.sensors import (
                        PLANNER_FAILURES_COUNTER,
                    )

                    REGISTRY.counter(PLANNER_FAILURES_COUNTER).inc()
                    self.last_planner_error = e
            self.last_provisioner_result = self.provisioner.rightsize(rec)
        violated = [
            name for name, v in result.violations_before.items() if v > 0
        ]
        if not violated:
            return []
        unfixable = set(result.violated_hard_goals)
        return [
            GoalViolations(violated_goals=violated, fixable=not unfixable)
        ]


class BrokerFailureDetector(Detector):
    name = "BrokerFailureDetector"

    def __init__(
        self,
        backend: ClusterBackend,
        failed_brokers_file: str,
        now_ms: Optional[Callable[[], int]] = None,
    ) -> None:
        self.backend = backend
        self.path = failed_brokers_file
        self._now = now_ms or (lambda: int(time.time() * 1000))
        self._known: Set[int] = set()
        self._failed: Dict[int, int] = self._load()
        # brokers seen alive at least once — metadata diff baseline
        self._known = set(self._failed)

    def _load(self) -> Dict[int, int]:
        """Failure times survive restarts (persistFailedBrokerList:93)."""
        if os.path.exists(self.path):
            with open(self.path) as fh:
                return {int(k): int(v) for k, v in json.load(fh).items()}
        return {}

    def _persist(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as fh:
            json.dump({str(k): v for k, v in self._failed.items()}, fh)

    @property
    def failed_brokers(self) -> Dict[int, int]:
        return dict(self._failed)

    def run(self) -> List[Anomaly]:
        desc = self.backend.describe_cluster()
        alive = set(desc.alive_ids())
        all_known = set(desc.brokers) | self._known
        self._known = all_known
        now = self._now()
        changed = False
        for b in all_known - alive:
            if b not in self._failed:
                self._failed[b] = now
                changed = True
        for b in list(self._failed):
            if b in alive:
                del self._failed[b]
                changed = True
        if changed:
            self._persist()
        if self._failed:
            return [BrokerFailures(failed_brokers=dict(self._failed))]
        return []


class DiskFailureDetector(Detector):
    name = "DiskFailureDetector"

    def __init__(self, backend: ClusterBackend) -> None:
        self.backend = backend

    def run(self) -> List[Anomaly]:
        offline: Dict[int, List[str]] = {}
        alive = set(self.backend.describe_cluster().alive_ids())
        for broker, dirs in self.backend.describe_logdirs().items():
            if broker not in alive:
                continue
            bad = [path for path, d in dirs.items() if d.offline]
            if bad:
                offline[broker] = bad
        if offline:
            return [DiskFailures(failed_disks=offline)]
        return []


class SlowBrokerFinder(Detector):
    """Screens brokers by log-flush-time p999 (SlowBrokerFinder.java:109):

    a broker is slow when its latest value exceeds (1) an absolute threshold,
    (2) its own history percentile × margin, and (3) the peer percentile × margin.
    Repeated detections escalate DEMOTE → REMOVE (reference's score tracking)."""

    name = "SlowBrokerFinder"

    def __init__(
        self,
        monitor,
        metric_name: str = "BROKER_LOG_FLUSH_TIME_MS_999TH",
        absolute_threshold_ms: float = 1000.0,
        history_percentile: float = 90.0,
        history_margin: float = 3.0,
        peer_percentile: float = 50.0,
        peer_margin: float = 3.0,
        remove_after_detections: int = 3,
    ) -> None:
        self.monitor = monitor
        self.metric_name = metric_name
        self.absolute_threshold_ms = absolute_threshold_ms
        self.history_percentile = history_percentile
        self.history_margin = history_margin
        self.peer_percentile = peer_percentile
        self.peer_margin = peer_margin
        self.remove_after_detections = remove_after_detections
        self._scores: Dict[int, int] = {}

    def run(self) -> List[Anomaly]:
        hist = self.monitor.broker_metric_history()
        if hist is None:
            return []
        values, brokers, metric_def = hist
        mid = metric_def.metric_info(self.metric_name).id
        series = values[:, :, mid]          # [E, W]
        latest = series[:, -1]
        slow: Dict[int, int] = {}
        now = int(time.time() * 1000)
        peers = np.percentile(latest, self.peer_percentile) if len(latest) else 0.0
        for e, broker in enumerate(brokers):
            v = latest[e]
            if v < self.absolute_threshold_ms:
                continue
            own = np.percentile(series[e], self.history_percentile)
            if own > 0 and v < own * self.history_margin:
                continue
            if peers > 0 and v < peers * self.peer_margin:
                continue
            slow[broker] = now
        for b in list(self._scores):
            if b not in slow:
                del self._scores[b]
        if not slow:
            return []
        for b in slow:
            self._scores[b] = self._scores.get(b, 0) + 1
        from cruise_control_tpu_torch.detector.anomalies import SlowBrokerAction

        persistent = {b for b, s in self._scores.items() if s >= self.remove_after_detections}
        action = SlowBrokerAction.REMOVE if persistent == set(slow) and persistent else SlowBrokerAction.DEMOTE
        return [SlowBrokers(slow_brokers=slow, action=action)]


class TopicReplicationFactorAnomalyFinder(Detector):
    name = "TopicReplicationFactorAnomalyFinder"

    def __init__(self, backend: ClusterBackend, target_rf: int = 3,
                 topic_filter: Optional[Callable[[str], bool]] = None) -> None:
        self.backend = backend
        self.target_rf = target_rf
        self.topic_filter = topic_filter or (lambda t: True)

    def run(self) -> List[Anomaly]:
        bad: Dict[str, int] = {}
        for topic, infos in self.backend.describe_topics().items():
            if not self.topic_filter(topic):
                continue
            rfs = {len(i.replicas) for i in infos}
            wrong = {rf for rf in rfs if rf != self.target_rf}
            if wrong:
                bad[topic] = min(wrong)
        if bad:
            return [
                TopicReplicationFactorAnomaly(bad_topics=bad, target_rf=self.target_rf)
            ]
        return []


class ExecutionFailureDetector(Detector):
    """Surfaces degraded execution summaries as :class:`ExecutionFailure`
    anomalies so self-healing can converge the cluster after a botched
    execution.

    Consumes the executor's degraded-summary queue
    (:meth:`Executor.drain_degraded_summaries`) rather than polling
    ``last_summary``, so a degraded run is never lost when a newer execution
    overwrites the summary between detector cycles; each summary is reported
    exactly once.  Stopped-by-operator executions never enter the queue."""

    name = "ExecutionFailureDetector"

    def __init__(self, executor) -> None:
        self.executor = executor

    def run(self) -> List[Anomaly]:
        from cruise_control_tpu_torch.detector.anomalies import ExecutionFailure

        return [
            ExecutionFailure(
                execution_id=s.execution_id,
                error=s.error,
                dead_tasks=s.dead,
                failed_tasks=s.failed,
            )
            for s in self.executor.drain_degraded_summaries()
        ]


class MaintenanceEventDetector(Detector):
    """Continuous reader of a maintenance-event source with idempotence dedupe
    (MaintenanceEventDetector + IdempotenceCache)."""

    name = "MaintenanceEventDetector"

    def __init__(self, retention_ms: int = 60 * 60_000) -> None:
        self._queue: List[MaintenanceEvent] = []
        self._seen: Dict[tuple, int] = {}
        self.retention_ms = retention_ms
        self._lock = threading.Lock()

    def submit(self, event: MaintenanceEvent) -> None:
        with self._lock:
            self._queue.append(event)

    def run(self) -> List[Anomaly]:
        now = int(time.time() * 1000)
        with self._lock:
            events, self._queue = self._queue, []
            self._seen = {
                k: ts for k, ts in self._seen.items() if now - ts < self.retention_ms
            }
            out: List[Anomaly] = []
            for e in events:
                key = e.dedupe_key()
                if key in self._seen:
                    continue
                self._seen[key] = now
                out.append(e)
            return out


class PartitionSizeAnomalyFinder(Detector):
    """Flags partitions whose disk footprint exceeds a limit
    (detector/PartitionSizeAnomalyFinder counterpart): oversized partitions slow
    every reassignment touching them and skew per-broker balance granularity."""

    name = "PartitionSizeAnomalyFinder"

    def __init__(
        self,
        monitor,
        size_limit: float = 1e9,
        topic_filter: Optional[Callable[[str], bool]] = None,
    ) -> None:
        self.monitor = monitor
        self.size_limit = size_limit
        self.topic_filter = topic_filter or (lambda t: True)

    def run(self) -> List[Anomaly]:
        from cruise_control_tpu_torch.core.resources import Resource
        from cruise_control_tpu_torch.detector.anomalies import PartitionSizeAnomaly
        from cruise_control_tpu_torch.monitor.loadmonitor import NotEnoughValidSnapshotsError

        try:
            model = self.monitor.cluster_model()
        except NotEnoughValidSnapshotsError:
            return []
        oversized: Dict[tuple, float] = {}
        for tp, broker_id, replica in model.all_replicas():
            if not replica.is_leader or replica.load is None:
                continue
            if not self.topic_filter(tp[0]):
                continue
            size = replica.load[Resource.DISK]
            if size > self.size_limit:
                oversized[tp] = float(size)
        if oversized:
            return [
                PartitionSizeAnomaly(oversized=oversized, size_limit=self.size_limit)
            ]
        return []


class SelfMetricAnomalyFinder(Detector):
    """The detector layer watching the watcher: evaluates the SLO burn-rate
    engine (``obs/slo.py``) each cycle and surfaces firing alerts as
    :class:`SloBurnAnomaly` — notification, cooldown, and a bounded
    self-heal ride the same :class:`AnomalyDetectorManager` pipeline as
    every cluster anomaly.

    Self-heal is symmetric and non-ratcheting: when this finder's anomaly
    pauses the controller/fleet (``SloBurnAnomaly.fix_with``), the finder
    remembers it owns the pause and resumes both as soon as every alert
    clears; an operator pause (different reason string) is never touched.
    ``cooldown_s`` rate-limits re-emission while the same burn keeps firing
    so one sustained incident is one anomaly, not one per detection cycle."""

    name = "SelfMetricAnomalyFinder"

    #: pause-reason prefix marking a pause as ours to undo
    REASON_PREFIX = "slo-burn"

    def __init__(
        self,
        engine,
        controller=None,
        fleet=None,
        cooldown_s: float = 300.0,
        now: Optional[Callable[[], float]] = None,
    ) -> None:
        self.engine = engine
        self.controller = controller
        self.fleet = fleet
        self.cooldown_s = cooldown_s
        self._now = now or time.monotonic
        #: frozenset of firing (slo, pair) keys at last emission + its time
        self._last_emit_keys: frozenset = frozenset()
        self._last_emit_t: Optional[float] = None
        self.anomalies_emitted = 0
        self.resumes = 0

    def _maybe_resume(self) -> None:
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            SLO_SELF_HEAL_RESUMES_COUNTER,
        )

        for target in (self.controller, self.fleet):
            if target is None or not getattr(target, "paused", False):
                continue
            reason = getattr(target, "pause_reason", "") or ""
            if reason.startswith(self.REASON_PREFIX):
                target.resume("slo recovered")
                self.resumes += 1
                REGISTRY.counter(SLO_SELF_HEAL_RESUMES_COUNTER).inc()

    def run(self) -> List[Anomaly]:
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            SLO_SELF_HEALS_COUNTER,
        )
        from cruise_control_tpu_torch.detector.anomalies import SloBurnAnomaly

        self.engine.evaluate()
        firing = self.engine.firing()
        if not firing:
            self._maybe_resume()
            self._last_emit_keys = frozenset()
            return []
        keys = frozenset((a.slo, a.pair) for a in firing)
        now = self._now()
        in_cooldown = (
            self._last_emit_t is not None
            and now - self._last_emit_t < self.cooldown_s
        )
        # re-emit on any new (slo, pair) even mid-cooldown — a second
        # objective starting to burn is new information, not the same page
        if in_cooldown and keys <= self._last_emit_keys:
            return []
        self._last_emit_keys = keys
        self._last_emit_t = now
        self.anomalies_emitted += 1
        REGISTRY.counter(SLO_SELF_HEALS_COUNTER).inc()
        return [
            SloBurnAnomaly(
                alerts=[a.to_dict() for a in firing],
                controller=self.controller,
                fleet=self.fleet,
            )
        ]
