"""Observability sensor registry: timers, gauges, counters per subsystem.

Port of ``cruise_control_tpu/core/sensors.py`` (pure Python, copied whole):
the counterpart of the reference's Dropwizard ``MetricRegistry`` (sensor
families documented in ``docs/wiki/User Guide/Sensors.md``).  One
process-wide :class:`SensorRegistry` of named metrics with GIL-atomic
updates, snapshot export for a status payload, and a ``timer()`` context
manager for the hot paths.  The port's registry is its own: the JAX
package's ``REGISTRY`` never sees the port's sensors.
"""

from __future__ import annotations

import bisect
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class Timer:
    """Duration histogram: count, mean, max, last, p50/p95 over a ring buffer."""

    def __init__(self, window: int = 256) -> None:
        self._lock = threading.Lock()
        self._ring: List[float] = []
        self._sorted: Optional[List[float]] = None
        self._window = window
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.last_s = 0.0

    def update(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.last_s = seconds
            self.max_s = max(self.max_s, seconds)
            self._ring.append(seconds)
            evicted = None
            if len(self._ring) > self._window:
                evicted = self._ring.pop(0)
            # once a snapshot has built the sorted view, keep it current
            # incrementally (bisect is O(log n) + a C memmove) instead of
            # invalidating: the self-monitoring sampler then never pays a
            # full re-sort, even for timers updated between samples
            if self._sorted is not None:
                bisect.insort(self._sorted, seconds)
                if evicted is not None:
                    del self._sorted[bisect.bisect_left(self._sorted, evicted)]

    @contextmanager
    def time(self):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.update(time.monotonic() - t0)

    def _sorted_ring(self) -> List[float]:
        # caller must hold self._lock; idle timers keep their sorted copy
        # between self-monitoring samples, so repeated snapshots are O(1)
        if self._sorted is None:
            self._sorted = sorted(self._ring)
        return self._sorted

    def _percentile(self, q: float) -> float:
        with self._lock:
            data = self._sorted_ring()
            if not data:
                return 0.0
            idx = min(int(q * len(data)), len(data) - 1)
            return data[idx]

    def snapshot(self) -> Dict[str, float]:
        # one sorted copy serves all three percentiles: the self-monitoring
        # sampler snapshots every timer each period, and three separate
        # _percentile() calls tripled the dominant sort cost
        with self._lock:
            data = self._sorted_ring()
        n = len(data)

        def pct(q: float) -> float:
            return data[min(int(q * n), n - 1)] if n else 0.0

        return {
            "count": self.count,
            "mean_s": self.total_s / self.count if self.count else 0.0,
            "max_s": self.max_s,
            "last_s": self.last_s,
            "p50_s": pct(0.50),
            "p95_s": pct(0.95),
            "p99_s": pct(0.99),
            # samples currently in the percentile ring — a p95 over 3 samples
            # and one over 256 are not the same confidence, and dashboards
            # could not tell them apart before this key existed
            "window_n": n,
        }


class Gauge:
    """Last-written value (e.g. balancedness score, valid-window count)."""

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> float:
        return self.value


class Counter:
    """Monotonic event count (e.g. proposals computed, anomalies handled)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> int:
        return self.value


class Meter:
    """Event rate over a sliding window (mean rate + 1-minute-ish rate)."""

    def __init__(self, window_s: float = 60.0) -> None:
        self._lock = threading.Lock()
        self._events: List[float] = []
        self.window_s = window_s
        self.total = 0

    def mark(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self.total += n
            self._events.extend([now] * n)
            cutoff = now - self.window_s
            while self._events and self._events[0] < cutoff:
                self._events.pop(0)

    def snapshot(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            recent = sum(1 for t in self._events if t >= now - self.window_s)
        return {"total": self.total, "rate_per_s": recent / self.window_s}


class SensorRegistry:
    """Named sensors, grouped dot-separated like the reference's JMX names
    (``LoadMonitor.cluster-model-creation-timer`` & co)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._timers: Dict[str, Timer] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._counters: Dict[str, Counter] = {}
        self._meters: Dict[str, Meter] = {}

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def meter(self, name: str) -> Meter:
        with self._lock:
            return self._meters.setdefault(name, Meter())

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, object]:
        """Export for the STATE endpoint / scrapers (Sensors.md families)."""
        out: Dict[str, object] = {}
        with self._lock:
            groups = [
                ("timers", self._timers),
                ("gauges", self._gauges),
                ("counters", self._counters),
                ("meters", self._meters),
            ]
            for kind, group in groups:
                sub = {
                    name: sensor.snapshot()
                    for name, sensor in group.items()
                    if prefix is None or name.startswith(prefix)
                }
                if sub:
                    out[kind] = sub
        return out


#: Process-wide default registry (the reference's singleton MetricRegistry).
REGISTRY = SensorRegistry()

# Sensor names used across subsystems — mirrors Sensors.md so operators can map
# dashboards one-to-one.
PROPOSAL_COMPUTATION_TIMER = "GoalOptimizer.proposal-computation-timer"
CLUSTER_MODEL_CREATION_TIMER = "LoadMonitor.cluster-model-creation-timer"
PROPOSAL_EXECUTION_TIMER = "Executor.proposal-execution-timer"
GOAL_VIOLATION_DETECTION_TIMER = "GoalViolationDetector.detection-timer"
BALANCEDNESS_GAUGE = "AnomalyDetector.balancedness-score"
MTBA_GAUGE = "AnomalyDetector.mean-time-between-anomalies-ms"
ANOMALY_RATE_METER = "AnomalyDetector.anomaly-rate"
SAMPLE_FETCH_TIMER = "MetricFetcherManager.samples-fetch-timer"
VALID_WINDOWS_GAUGE = "LoadMonitor.valid-windows"
MONITORED_PARTITIONS_GAUGE = "LoadMonitor.monitored-partitions-percentage"
EXECUTION_STARTED_COUNTER = "Executor.execution-started"
EXECUTION_STOPPED_COUNTER = "Executor.execution-stopped"
EXECUTION_FAILED_COUNTER = "Executor.execution-failed"
STUCK_TASKS_COUNTER = "Executor.stuck-tasks-timed-out"
RETRY_COUNTER = "RetryPolicy.retries"
RETRY_EXHAUSTED_COUNTER = "RetryPolicy.retries-exhausted"
RETRY_FATAL_COUNTER = "RetryPolicy.fatal-errors"
CHAOS_FAULTS_COUNTER = "ChaosBackend.faults-injected"
FETCHER_REPLACED_COUNTER = "MetricFetcherManager.hung-fetchers-replaced"
FLIGHT_TRACES_COUNTER = "FlightRecorder.traces-recorded"
FLIGHT_RING_GAUGE = "FlightRecorder.ring-size"
SIM_SWEEPS_COUNTER = "ScenarioPlanner.sweeps"
SIM_SCENARIOS_COUNTER = "ScenarioPlanner.scenarios-evaluated"
SIM_BUCKET_HITS_COUNTER = "ScenarioPlanner.bucket-hits"
SIM_BUCKET_MISSES_COUNTER = "ScenarioPlanner.bucket-misses"
SIM_SWEEP_TIMER = "ScenarioPlanner.sweep-timer"
PLANNER_FAILURES_COUNTER = "GoalViolationDetector.planner-failures"
EXPORTER_RENDER_TIMER = "MetricsExporter.render-timer"
METRICS_SCRAPES_COUNTER = "MetricsExporter.scrapes"
JOURNAL_APPENDS_COUNTER = "Journal.records-appended"
JOURNAL_SKIPPED_COUNTER = "Journal.replay-records-skipped"
RECOVERY_EXECUTIONS_COUNTER = "Recovery.executions-recovered"
RECOVERY_RECORDS_GAUGE = "Recovery.records-replayed"
RECOVERY_WALL_GAUGE = "Recovery.wall-seconds"
USER_TASKS_RECOVERED_COUNTER = "UserTaskManager.tasks-recovered"
READY_GAUGE = "Readiness.ready"
SAMPLE_STORE_SKIPPED_COUNTER = "SampleStore.replay-records-skipped"
OPTIMIZE_DEADLINE_COUNTER = "GoalOptimizer.deadline-expirations"
# continuous controller (controller/loop.py): the reaction-latency timer is
# the headline metric — p50/p95 time from a load-shift window delta landing
# to the corrective standing proposal set being published
CONTROLLER_REACTION_TIMER = "Controller.reaction-latency-timer"
CONTROLLER_TICKS_COUNTER = "Controller.ticks"
CONTROLLER_IDLE_TICKS_COUNTER = "Controller.idle-ticks"
CONTROLLER_TICK_ERRORS_COUNTER = "Controller.tick-errors"
CONTROLLER_PUBLISHED_COUNTER = "Controller.proposal-sets-published"
CONTROLLER_DRAINED_COUNTER = "Controller.proposal-sets-drained"
CONTROLLER_DRIFT_GAUGE = "Controller.drift"
CONTROLLER_BALANCEDNESS_GAUGE = "Controller.balancedness"
CONTROLLER_STANDING_VERSION_GAUGE = "Controller.standing-version"
CONTROLLER_STANDING_PROPOSALS_GAUGE = "Controller.standing-proposals"
CONTROLLER_STALENESS_GAUGE = "Controller.staleness-seconds"
CONTROLLER_REBUILDS_COUNTER = "Controller.topology-rebuilds"
CONTROLLER_BREAKER_SKIPS_COUNTER = "Controller.breaker-open-skips"
# fleet controller (fleet/controller.py): coordinator-level series.  Tenant
# control loops re-namespace their Controller.* sensors to Fleet.<suffix>
# (fleet aggregate) + Fleet.tenant.<name>.<suffix> (per-tenant series); the
# Fleet.coordinator.* names below are the fleet tick machinery itself, so
# they never collide with the aggregated suffixes
FLEET_TICKS_COUNTER = "Fleet.coordinator.ticks"
FLEET_TICK_ERRORS_COUNTER = "Fleet.coordinator.tick-errors"
FLEET_TENANTS_GAUGE = "Fleet.coordinator.tenants"
FLEET_GROUPS_GAUGE = "Fleet.coordinator.goal-order-groups"
FLEET_PROBE_DISPATCHES_COUNTER = "Fleet.coordinator.probe-dispatches"
FLEET_OPTIMIZE_DISPATCHES_COUNTER = "Fleet.coordinator.optimize-dispatches"
FLEET_DRAINS_COUNTER = "Fleet.coordinator.drains-granted"
FLEET_DRAIN_DEFERRALS_COUNTER = "Fleet.coordinator.drain-deferrals"
FLEET_BREAKER_SKIPS_COUNTER = "Fleet.coordinator.breaker-open-skips"
FLEET_MIGRATIONS_COUNTER = "Fleet.coordinator.legacy-namespaces-adopted"
# overload plane (api/admission.py): every authenticated request passes the
# admission controller — sheds are the load-shedding contract (429 +
# Retry-After, never a 500), accounted by reason
ADMISSION_ADMITTED_COUNTER = "Admission.admitted"
ADMISSION_SHED_COUNTER = "Admission.shed"
ADMISSION_SHED_RATE_COUNTER = "Admission.shed-rate-limited"
ADMISSION_SHED_QUOTA_COUNTER = "Admission.shed-principal-quota"
ADMISSION_SHED_QUEUE_FULL_COUNTER = "Admission.shed-queue-full"
ADMISSION_SHED_DEADLINE_COUNTER = "Admission.shed-deadline"
ADMISSION_QUEUED_COUNTER = "Admission.queued"
ADMISSION_DEDUPE_HITS_COUNTER = "Admission.dedupe-hits"
ADMISSION_QUEUE_DEPTH_GAUGE = "Admission.queue-depth"
ADMISSION_ACTIVE_GAUGE = "Admission.active-operations"
ADMISSION_WAIT_TIMER = "Admission.queue-wait-timer"
ADMISSION_DRAIN_METER = "Admission.drain-rate"
# backend circuit breaker (backend/breaker.py)
BREAKER_OPENS_COUNTER = "CircuitBreaker.opens"
BREAKER_CLOSES_COUNTER = "CircuitBreaker.closes"
BREAKER_PROBES_COUNTER = "CircuitBreaker.probes"
BREAKER_FAST_FAILURES_COUNTER = "CircuitBreaker.fast-failures"
BREAKER_STATE_GAUGE = "CircuitBreaker.state"      # 0 closed, 1 half-open, 2 open
DETECTOR_BREAKER_SKIPS_COUNTER = "AnomalyDetector.passes-skipped-breaker-open"
# window-listener failures (monitor/loadmonitor.py _notify_windows) — a
# listener raising must never break ingest, but it must not vanish either
MONITOR_LISTENER_ERRORS_COUNTER = "LoadMonitor.listener-errors"
# replication plane (replication/, controller/standing.py fencing)
REPLICATION_EPOCH_GAUGE = "Replication.writer-epoch"
REPLICATION_FENCE_REFUSALS_COUNTER = "Replication.fence-refusals"
REPLICATION_STALENESS_GAUGE = "Replication.follower-staleness-ms"
REPLICATION_APPLIED_COUNTER = "Replication.records-applied"
REPLICATION_WATCHERS_GAUGE = "Replication.watchers"
REPLICATION_DELTAS_COUNTER = "Replication.deltas-published"
REPLICATION_STALE_503_COUNTER = "Replication.lag-bound-503s"
REPLICATION_RESETS_COUNTER = "Replication.tail-resets"
# time-series scenario engine (traces/)
TRACE_ROLLOUTS_COUNTER = "TraceEngine.rollouts"
TRACE_PAIRS_COUNTER = "TraceEngine.pairs-evaluated"
TRACE_ROLLOUT_TIMER = "TraceEngine.rollout-timer"
TRACE_REPLAYS_COUNTER = "TraceEngine.replays"
TRACE_REPLAY_STEPS_COUNTER = "TraceEngine.replay-steps"
# self-monitoring plane (obs/selfmon.py, obs/slo.py): the sampler that turns
# the registry itself into windowed time-series, and the SLO burn-rate engine
# watching those series
SELFMON_SAMPLES_COUNTER = "SelfMonitor.samples"
SELFMON_SAMPLE_TIMER = "SelfMonitor.sample-timer"
SELFMON_SERIES_GAUGE = "SelfMonitor.series"
SELFMON_SPOOL_BYTES_GAUGE = "SelfMonitor.spool-bytes"
SELFMON_SPOOL_ROTATIONS_COUNTER = "SelfMonitor.spool-rotations"
SLO_EVALUATIONS_COUNTER = "SloEngine.evaluations"
SLO_ALERTS_FIRING_GAUGE = "SloEngine.alerts-firing"
SLO_SELF_HEALS_COUNTER = "SloEngine.self-heals"
SLO_SELF_HEAL_RESUMES_COUNTER = "SloEngine.self-heal-resumes"
