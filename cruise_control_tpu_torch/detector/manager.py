"""AnomalyDetectorManager: scheduling, queueing, and the self-healing loop.

Port of ``cruise_control_tpu/detector/manager.py`` (copied): the same
threads, queue and flight records (``detector`` and ``anomaly``).

Counterpart of ``detector/AnomalyDetectorManager.java`` (queue :73, startDetection
:234-243, AnomalyHandlerTask :342, fixAnomalyInProgress :533): periodic detectors
feed a priority queue; the handler consults the :class:`AnomalyNotifier` (IGNORE /
CHECK(delay) / FIX) and invokes ``anomaly.fix_with(cruise_control)`` — the same
optimize→execute pipeline user requests go through.  Tracks per-type counts,
self-healing enable state, and mean time between anomalies for the STATE endpoint
(AnomalyDetectorState, AnomalyMetrics/MeanTimeBetweenAnomaliesMs).
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    NotificationAction,
)
from cruise_control_tpu_torch.detector.detectors import Detector
from cruise_control_tpu_torch.detector.notifier import AnomalyNotifier
from cruise_control_tpu_torch.executor.engine import OngoingExecutionError


@dataclasses.dataclass
class AnomalyDetectorState:
    """STATE endpoint payload (AnomalyDetectorState.java)."""

    self_healing_enabled: Dict[str, bool]
    recent_anomalies: Dict[str, List[str]]
    num_self_healing_started: int
    num_self_healing_failed: int
    mean_time_between_anomalies_ms: Dict[str, float]
    queue_size: int


class AnomalyDetectorManager:
    def __init__(
        self,
        cruise_control,
        notifier: AnomalyNotifier,
        detectors: Sequence[Tuple[Detector, float]],
        history_limit: int = 10,
        initial_pass: bool = False,
        ready_probe=None,
        breaker=None,
    ) -> None:
        """``detectors``: (detector, interval_s) pairs (the reference schedules 5
        periodic detectors + 1 continuous, :234-243).

        ``initial_pass=True`` runs one immediate detection pass per detector
        as soon as ``ready_probe()`` returns truthy (or immediately with no
        probe) instead of sleeping a full ``interval_s`` first — a broker
        that died during the restart window would otherwise go unnoticed for
        up to a whole cadence (``anomaly.detection.initial.pass``; the app
        shell passes the readiness ladder as the probe so the pass never
        races journal recovery or an unwarmed monitor).

        ``breaker`` is the shared backend circuit breaker
        (:class:`~cruise_control_tpu_torch.backend.breaker.CircuitBreaker`): while
        it is open a detection pass is *skipped with a counted reason*
        instead of run — every detector's first act is a southbound call that
        would fail fast anyway, and a failed pass against a blacked-out
        backend reads as a storm of anomalies that are really one outage."""
        self.cc = cruise_control
        self.notifier = notifier
        self.detectors = list(detectors)
        self.history_limit = history_limit
        self.initial_pass = initial_pass
        self.ready_probe = ready_probe
        self.breaker = breaker

        self._queue: List[Anomaly] = []
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._recent: Dict[AnomalyType, List[Anomaly]] = {t: [] for t in AnomalyType}
        self._detection_times: Dict[AnomalyType, List[int]] = {t: [] for t in AnomalyType}
        self._checked: Dict[int, int] = {}   # anomaly_id -> not-before ms
        self.num_self_healing_started = 0
        self.num_self_healing_failed = 0

    # -- lifecycle -----------------------------------------------------------

    def start_detection(self) -> None:
        """Spawn detector schedules + the handler task (startDetection:234)."""
        self._stop.clear()
        for detector, interval_s in self.detectors:
            t = threading.Thread(
                target=self._detector_loop, args=(detector, interval_s), daemon=True
            )
            t.start()
            self._threads.append(t)
        handler = threading.Thread(target=self._handler_loop, daemon=True)
        handler.start()
        self._threads.append(handler)

    def shutdown(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    # -- detection -----------------------------------------------------------

    def _detector_loop(self, detector: Detector, interval_s: float) -> None:
        if self.initial_pass and self._await_ready():
            self.run_detector_once(detector)
        while not self._stop.wait(interval_s):
            self.run_detector_once(detector)

    def _await_ready(self) -> bool:
        """Poll the readiness probe until it opens (the probe is the lazy
        ``monitor_warming`` → ``ready`` edge — polling it is what flips it).
        Returns False when shutdown wins the race."""
        while not self._stop.is_set():
            probe = self.ready_probe
            if probe is None:
                return True
            try:
                if probe():
                    return True
            except Exception:
                pass   # a raising probe reads as not-ready; keep waiting
            self._stop.wait(1.0)
        return False

    def run_detector_once(self, detector: Detector) -> int:
        """One detection cycle (exposed for tests / synchronous drives)."""
        from cruise_control_tpu_torch.obs import recorder as obs

        if self.breaker is not None and self.breaker.is_open:
            # blacked-out backend: skip the pass with a counted reason — the
            # next cadence (or the breaker's probe closing it) retries
            from cruise_control_tpu_torch.core.sensors import (
                DETECTOR_BREAKER_SKIPS_COUNTER,
                REGISTRY,
            )

            REGISTRY.counter(DETECTOR_BREAKER_SKIPS_COUNTER).inc()
            token = obs.start_trace("detector")
            obs.finish_trace(
                token,
                attrs={
                    "detector": type(detector).__name__,
                    "skipped": "breaker-open",
                },
            )
            return 0
        token = obs.start_trace("detector")
        try:
            anomalies = detector.run()
        except Exception as e:
            obs.finish_trace(
                token,
                attrs={"detector": type(detector).__name__, "error": str(e)},
            )
            return 0
        for a in anomalies:
            self._enqueue(a)
        obs.finish_trace(
            token,
            attrs={
                "detector": type(detector).__name__,
                "anomalies": len(anomalies),
                "anomaly_types": sorted(
                    {a.anomaly_type.name for a in anomalies}
                ),
            },
        )
        return len(anomalies)

    def _enqueue(self, anomaly: Anomaly) -> None:
        with self._cv:
            heapq.heappush(self._queue, anomaly)
            hist = self._recent[anomaly.anomaly_type]
            hist.append(anomaly)
            del hist[: -self.history_limit]
            times = self._detection_times[anomaly.anomaly_type]
            times.append(anomaly.detected_ms)
            del times[: -max(self.history_limit, 100)]
            self._cv.notify_all()

    # -- handling ------------------------------------------------------------

    def _handler_loop(self) -> None:
        while not self._stop.is_set():
            anomaly = self._next_anomaly(timeout_s=0.2)
            if anomaly is None:
                continue
            try:
                self.handle_anomaly(anomaly)
            except Exception:
                # a raising notifier/anomaly must never kill the self-healing
                # loop for the rest of the process lifetime — count and go on
                self.num_self_healing_failed += 1

    def _next_anomaly(self, timeout_s: float) -> Optional[Anomaly]:
        with self._cv:
            if not self._queue:
                self._cv.wait(timeout=timeout_s)
            now = int(time.time() * 1000)
            ready_idx = None
            for i, a in enumerate(self._queue):
                if self._checked.get(a.anomaly_id, 0) <= now:
                    ready_idx = i
                    break
            if ready_idx is None:
                if self._queue:
                    # everything queued is CHECK-delayed: sleep until the
                    # earliest not-before time (or a new enqueue) rather than
                    # returning immediately and busy-spinning in the handler
                    earliest = min(
                        self._checked.get(a.anomaly_id, 0) for a in self._queue
                    )
                    delay_s = min(max((earliest - now) / 1000.0, 0.0), timeout_s)
                    if delay_s > 0:
                        self._cv.wait(timeout=delay_s)
                return None
            a = self._queue.pop(ready_idx)
            heapq.heapify(self._queue)
            # prune the not-before entry: re-queues write a fresh one, and
            # leaving stale ids would grow the map for the process lifetime
            self._checked.pop(a.anomaly_id, None)
            return a

    def handle_anomaly(self, anomaly: Anomaly) -> str:
        """Notifier consult + fix (AnomalyHandlerTask :385-412 → :533).

        Returns the action taken ("IGNORE" | "CHECK" | "FIXED" | "FIX_FAILED").
        """
        from cruise_control_tpu_torch.obs import recorder as obs

        token = obs.start_trace("anomaly")
        try:
            action = self._handle_anomaly(anomaly)
        except Exception as e:
            obs.finish_trace(
                token,
                attrs={
                    "anomaly_type": anomaly.anomaly_type.name,
                    "anomaly_id": anomaly.anomaly_id,
                    "error": str(e),
                },
            )
            raise
        obs.finish_trace(
            token,
            attrs={
                "anomaly_type": anomaly.anomaly_type.name,
                "anomaly_id": anomaly.anomaly_id,
                "action": action,
            },
        )
        return action

    def _handle_anomaly(self, anomaly: Anomaly) -> str:
        result = self.notifier.on_anomaly(anomaly)
        if result.action is NotificationAction.IGNORE:
            return "IGNORE"
        if result.action is NotificationAction.CHECK:
            with self._cv:
                self._checked[anomaly.anomaly_id] = (
                    int(time.time() * 1000) + result.delay_ms
                )
                heapq.heappush(self._queue, anomaly)
            return "CHECK"
        self.num_self_healing_started += 1
        try:
            anomaly.fix_result = anomaly.fix_with(self.cc)
            return "FIXED"
        except OngoingExecutionError:
            # retry after the running execution finishes (reference re-queues)
            with self._cv:
                self._checked[anomaly.anomaly_id] = int(time.time() * 1000) + 1000
                heapq.heappush(self._queue, anomaly)
            return "CHECK"
        except Exception:
            self.num_self_healing_failed += 1
            return "FIX_FAILED"

    # -- state ---------------------------------------------------------------

    def _mtba(self) -> Dict[str, float]:
        out = {}
        for t, times in self._detection_times.items():
            if len(times) >= 2:
                gaps = [b - a for a, b in zip(times, times[1:])]
                out[t.name] = sum(gaps) / len(gaps)
            else:
                out[t.name] = float("inf")
        return out

    def state(self) -> AnomalyDetectorState:
        with self._cv:
            return AnomalyDetectorState(
                self_healing_enabled={
                    t.name: v for t, v in self.notifier.self_healing_enabled.items()
                },
                recent_anomalies={
                    t.name: [a.description() for a in hist]
                    for t, hist in self._recent.items()
                },
                num_self_healing_started=self.num_self_healing_started,
                num_self_healing_failed=self.num_self_healing_failed,
                mean_time_between_anomalies_ms=self._mtba(),
                queue_size=len(self._queue),
            )
