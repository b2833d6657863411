"""ClusterBackend SPI — the framework's only window onto the managed cluster.

Port of ``cruise_control_tpu/backend/base.py``.

Mirrors the AdminClient surface the reference actually uses (verified against
``executor/ExecutionUtils.java`` reassignments :485 / leader election :435,
``executor/ExecutorAdminUtils.java`` logdir ops, ``detector/KafkaBrokerFailureDetector``
describeCluster :42, ``detector/DiskFailureDetector`` describeLogDirs) plus the raw
metric feed the metrics-reporter topic provides (``CruiseControlMetricsReporter``).
Implementations: :class:`~cruise_control_tpu_torch.backend.fake.FakeClusterBackend` (tests,
demos); a real Kafka implementation can be slotted in without touching any other
layer.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

TopicPartition = Tuple[str, int]


@dataclasses.dataclass(frozen=True)
class BrokerInfo:
    broker_id: int
    rack: str
    host: str
    alive: bool


@dataclasses.dataclass(frozen=True)
class ClusterDescription:
    brokers: Dict[int, BrokerInfo]
    controller: Optional[int] = None

    def alive_ids(self) -> List[int]:
        return sorted(b for b, i in self.brokers.items() if i.alive)


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    tp: TopicPartition
    leader: Optional[int]             # broker id; None when leaderless
    replicas: Tuple[int, ...]         # ordered broker ids (preferred leader first)
    isr: Tuple[int, ...]
    #: broker id -> logdir hosting the replica (JBOD; None when not reported)
    logdir_by_broker: Optional[Dict[int, str]] = None


@dataclasses.dataclass(frozen=True)
class LogdirInfo:
    path: str
    capacity_bytes: float
    offline: bool


@dataclasses.dataclass(frozen=True)
class RawMetric:
    """One raw metric datum (metric/RawMetricType.java scope model)."""

    name: str                         # RawMetricType-style name, e.g. "TOPIC_BYTES_IN"
    scope: str                        # "BROKER" | "TOPIC" | "PARTITION"
    broker_id: int
    value: float
    ts_ms: int
    topic: Optional[str] = None
    partition: Optional[int] = None


class ReassignmentInProgress(Exception):
    """An overlapping reassignment exists (Kafka's semantics)."""


class ClusterBackend(abc.ABC):
    """Narrow southbound interface; every method may raise on backend failure."""

    # -- metadata ----------------------------------------------------------

    @abc.abstractmethod
    def describe_cluster(self) -> ClusterDescription: ...

    @abc.abstractmethod
    def describe_topics(self) -> Dict[str, List[PartitionInfo]]: ...

    @abc.abstractmethod
    def describe_logdirs(self) -> Dict[int, Dict[str, LogdirInfo]]: ...

    # -- metric feed -------------------------------------------------------

    @abc.abstractmethod
    def fetch_raw_metrics(self, from_ms: int, to_ms: int) -> List[RawMetric]:
        """All raw metrics produced in [from_ms, to_ms) — the consumer-side of the
        __CruiseControlMetrics topic."""

    # -- admin operations (executor southbound) ----------------------------

    @abc.abstractmethod
    def alter_partition_reassignments(
        self, reassignments: Mapping[TopicPartition, Optional[Sequence[int]]]
    ) -> None:
        """tp -> target replica list.  A ``None`` target *cancels* an in-flight
        reassignment for that partition (Kafka's AlterPartitionReassignments
        empty-target semantics), leaving the pre-reassignment replica set."""

    @abc.abstractmethod
    def list_partition_reassignments(self) -> Dict[TopicPartition, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
        """tp -> (adding, removing) broker sets still in flight."""

    def list_ongoing_reassignments(self) -> Dict[TopicPartition, Tuple[int, ...]]:
        """tp -> full TARGET replica set of every in-flight reassignment.

        The recovery pass reconciles its journal against this: a journaled
        task whose partition is still listed here is genuinely in flight on
        the backend, whatever the journal last recorded.  Default derives the
        target from metadata + (adding, removing); backends that track the
        target directly should override."""
        ongoing = self.list_partition_reassignments()
        if not ongoing:
            return {}
        current = {
            i.tp: i.replicas
            for infos in self.describe_topics().values()
            for i in infos
        }
        out: Dict[TopicPartition, Tuple[int, ...]] = {}
        for tp, (adding, removing) in ongoing.items():
            cur = current.get(tp, ())
            out[tp] = tuple(b for b in cur if b not in removing) + tuple(
                b for b in adding if b not in cur
            )
        return out

    @abc.abstractmethod
    def elect_leaders(self, partitions: Sequence[TopicPartition]) -> None:
        """Trigger preferred leader election for the partitions."""

    @abc.abstractmethod
    def alter_replica_logdirs(
        self, moves: Mapping[Tuple[TopicPartition, int], str]
    ) -> None:
        """(tp, broker) -> target logdir (intra-broker disk move)."""

    # -- throttle / config management --------------------------------------

    @abc.abstractmethod
    def set_replication_throttles(
        self, rate_bytes: float, tp_by_broker: Mapping[int, Sequence[TopicPartition]]
    ) -> None: ...

    @abc.abstractmethod
    def clear_replication_throttles(self) -> None: ...
