"""Broker-side metrics reporter (the L1 layer).

Port of ``cruise_control_tpu/monitor/reporter.py`` (pure Python, copied whole).

Counterpart of ``cruise-control-metrics-reporter``'s
``CruiseControlMetricsReporter.java:65`` (init :96, reporting loop ``run()``
:391, producer send :463): a plugin that runs INSIDE each broker process,
samples that broker's metrics on an interval, serializes them with the
versioned wire format (:mod:`cruise_control_tpu_torch.monitor.wire`), and publishes
batches to a transport — the reference's ``__CruiseControlMetrics`` topic.

The transport is an SPI so the same reporter serves an in-memory queue (the
embedded-harness equivalent, used by :class:`TransportMetricSampler` below), a
file spool, or a real message bus.  ``collect_fn`` supplies the raw metrics per
tick; :func:`process_metrics_collector` is a ready-made collector reading the
local process/host (CPU via cgroup-aware utilization).
"""

from __future__ import annotations

import abc
import collections
import os
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.backend.base import RawMetric
from cruise_control_tpu_torch.monitor.container import effective_cores
from cruise_control_tpu_torch.monitor.samples import MetricSampler, SampleBatch
from cruise_control_tpu_torch.monitor.wire import deserialize, serialize


class MetricsTransport(abc.ABC):
    """Where serialized metric batches go (the metrics topic equivalent)."""

    @abc.abstractmethod
    def publish(self, payload: bytes) -> None: ...

    @abc.abstractmethod
    def poll(self, from_ms: int, to_ms: int) -> List[bytes]: ...


class InMemoryTransport(MetricsTransport):
    """Bounded in-process queue — the embedded-test-harness transport.

    A batch is stamped with the wall clock when it is published, and
    :meth:`poll` filters on that stamp: it serves samplers that ask for
    wall-clock ranges.  A harness on a fake clock implements
    :class:`MetricsTransport` itself and stamps each batch with the interval
    it reports."""

    def __init__(self, max_batches: int = 10_000) -> None:
        self._lock = threading.Lock()
        self._batches: Deque[Tuple[int, bytes]] = collections.deque(maxlen=max_batches)

    def publish(self, payload: bytes) -> None:
        with self._lock:
            self._batches.append((int(time.time() * 1000), payload))

    def poll(self, from_ms: int, to_ms: int) -> List[bytes]:
        with self._lock:
            return [p for ts, p in self._batches if from_ms <= ts < to_ms]


def process_metrics_collector(broker_id: int) -> Callable[[], List[RawMetric]]:
    """Collector reading this process's host: cgroup-aware CPU utilization
    (ContainerMetricUtils semantics).  IO/network rates need broker internals
    and come from the embedding application's own collector."""
    state = {"last": None}

    def collect() -> List[RawMetric]:
        now_ms = int(time.time() * 1000)
        try:
            ticks = os.times()
            busy = ticks.user + ticks.system
            wall = time.monotonic()
            prev = state["last"]
            state["last"] = (busy, wall)
            if prev is None:
                return []
            dbusy = busy - prev[0]
            dwall = max(wall - prev[1], 1e-9)
            cores = effective_cores()
            cpu_util = max(0.0, min(1.0, dbusy / (dwall * cores)))
        except OSError:
            return []
        return [RawMetric("BROKER_CPU_UTIL", "BROKER", broker_id, cpu_util, now_ms)]

    return collect


class MetricsReporter:
    """Periodic collect → serialize → publish loop (the broker plugin)."""

    def __init__(
        self,
        broker_id: int,
        transport: MetricsTransport,
        collect_fn: Optional[Callable[[], List[RawMetric]]] = None,
        interval_s: float = 10.0,
    ) -> None:
        self.broker_id = broker_id
        self.transport = transport
        self.collect_fn = collect_fn or process_metrics_collector(broker_id)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches_published = 0

    def report_once(self) -> int:
        metrics = self.collect_fn()
        if not metrics:
            return 0
        self.transport.publish(serialize(metrics))
        self.batches_published += 1
        return len(metrics)

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.report_once()
                except Exception:
                    pass  # reporting must never take the broker down

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"metrics-reporter-{self.broker_id}"
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class TransportMetricSampler(MetricSampler):
    """Sampler consuming reporter batches from a transport — the counterpart of
    ``CruiseControlMetricsReporterSampler.java:35`` (seek/poll :63-117)."""

    def __init__(self, transport: MetricsTransport, describe_topics, cpu_weights=None):
        from cruise_control_tpu_torch.monitor.processor import MetricsProcessor

        self.transport = transport
        self.describe_topics = describe_topics
        self.processor = (
            MetricsProcessor(cpu_weights) if cpu_weights else MetricsProcessor()
        )

    def get_samples(self, from_ms: int, to_ms: int) -> SampleBatch:
        raw: List[RawMetric] = []
        for payload in self.transport.poll(from_ms, to_ms):
            raw.extend(deserialize(payload))
        return self.processor.process(raw, self.describe_topics())
