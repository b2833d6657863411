"""Metric samples and the MetricSampler SPI.

Port of ``cruise_control_tpu/monitor/samples.py``.

Counterparts: ``PartitionMetricSample``/``BrokerMetricSample`` (monitor/sampling/holder)
and the ``MetricSampler`` SPI (``monitor/sampling/MetricSampler.java``), whose default
implementation consumes the metrics-reporter topic
(``CruiseControlMetricsReporterSampler.java:35``).  Here the default sampler reads the
:class:`ClusterBackend`'s raw-metric feed and runs the derivation processor.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Tuple

from cruise_control_tpu_torch.backend.base import ClusterBackend, TopicPartition


@dataclasses.dataclass(frozen=True)
class PartitionMetricSample:
    """One partition's metric vector at a timestamp (leader-side measurement)."""

    tp: TopicPartition
    broker_id: int                    # leader broker at sample time
    ts_ms: int
    values: Tuple[float, ...]         # indexed by COMMON_METRIC_DEF ids

    def to_record(self) -> dict:
        return {
            "type": "partition",
            "topic": self.tp[0],
            "partition": self.tp[1],
            "broker": self.broker_id,
            "ts": self.ts_ms,
            "values": list(self.values),
        }


@dataclasses.dataclass(frozen=True)
class BrokerMetricSample:
    broker_id: int
    ts_ms: int
    values: Tuple[float, ...]         # indexed by BROKER_METRIC_DEF ids

    def to_record(self) -> dict:
        return {
            "type": "broker",
            "broker": self.broker_id,
            "ts": self.ts_ms,
            "values": list(self.values),
        }


@dataclasses.dataclass
class SampleBatch:
    partition_samples: List[PartitionMetricSample]
    broker_samples: List[BrokerMetricSample]

    def __len__(self) -> int:
        return len(self.partition_samples) + len(self.broker_samples)


class MetricSampler(abc.ABC):
    """Pluggable metric source (MetricSampler SPI)."""

    @abc.abstractmethod
    def get_samples(self, from_ms: int, to_ms: int) -> SampleBatch: ...

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class NoopSampler(MetricSampler):
    """NoopSampler.java equivalent — returns nothing, used to isolate subsystems."""

    def get_samples(self, from_ms: int, to_ms: int) -> SampleBatch:
        return SampleBatch([], [])


class BackendMetricSampler(MetricSampler):
    """Default sampler: backend raw metrics → processor → samples."""

    def __init__(self, backend: ClusterBackend) -> None:
        from cruise_control_tpu_torch.monitor.processor import MetricsProcessor

        self.backend = backend
        self.processor = MetricsProcessor()

    def get_samples(self, from_ms: int, to_ms: int) -> SampleBatch:
        raw = self.backend.fetch_raw_metrics(from_ms, to_ms)
        topics = self.backend.describe_topics()
        return self.processor.process(raw, topics)
