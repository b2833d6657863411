"""Metric definitions and the raw metric taxonomy.

Port of ``cruise_control_tpu/core/metricdef.py``.

Counterpart of the reference's two-level metric schema:

* ``RawMetricType`` — the 43-entry wire taxonomy emitted by the broker-side reporter
  (``cruise-control-metrics-reporter/.../metric/RawMetricType.java:27``), scoped
  BROKER / TOPIC / PARTITION.
* ``MetricDef`` / ``KafkaMetricDef`` — the aggregation-facing registry mapping raw
  types onto ~57 metric ids with a value-computing strategy
  (``cruise-control-core/.../metricdef/MetricDef.java``,
  ``cruise-control/.../monitor/metricdefinition/KafkaMetricDef.java:41``).

Design note: a metric id here IS the column index of the dense
``[entity, window, metric]`` sample tensors the aggregator produces — the registry is
the schema of the array layout, not an object graph.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from cruise_control_tpu_torch.core.resources import Resource


class MetricScope(enum.Enum):
    BROKER = "broker"
    TOPIC = "topic"
    PARTITION = "partition"


class ValueStrategy(enum.Enum):
    """How windowed samples reduce to one value (MetricDef strategies AVG/MAX/LATEST)."""

    AVG = "avg"
    MAX = "max"
    LATEST = "latest"


@dataclasses.dataclass(frozen=True)
class MetricInfo:
    """One metric id in the registry (reference: metricdef/MetricInfo.java)."""

    name: str
    id: int
    strategy: ValueStrategy
    group: Optional[Resource]  # resource group this metric contributes to, if any
    to_predict: bool = False   # participates in the trainable CPU model


class MetricDef:
    """Ordered metric registry; id == column index (metricdef/MetricDef.java)."""

    def __init__(self) -> None:
        self._by_name: Dict[str, MetricInfo] = {}
        self._by_id: List[MetricInfo] = []

    def define(
        self,
        name: str,
        strategy: ValueStrategy = ValueStrategy.AVG,
        group: Optional[Resource] = None,
        to_predict: bool = False,
    ) -> "MetricDef":
        if name in self._by_name:
            raise ValueError(f"metric {name} defined twice")
        info = MetricInfo(name, len(self._by_id), strategy, group, to_predict)
        self._by_name[name] = info
        self._by_id.append(info)
        return self

    def metric_info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def info_for_id(self, metric_id: int) -> MetricInfo:
        return self._by_id[metric_id]

    def size(self) -> int:
        return len(self._by_id)

    def all(self) -> List[MetricInfo]:
        return list(self._by_id)

    def ids_for_group(self, group: Resource) -> List[int]:
        return [m.id for m in self._by_id if m.group is group]

    def strategies_array(self) -> List[ValueStrategy]:
        return [m.strategy for m in self._by_id]


# ---------------------------------------------------------------------------
# Raw metric taxonomy (wire level).
# ---------------------------------------------------------------------------

_BROKER_TIME_FAMILIES = [
    "PRODUCE_REQUEST_QUEUE_TIME_MS",
    "CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS",
    "FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS",
    "PRODUCE_TOTAL_TIME_MS",
    "CONSUMER_FETCH_TOTAL_TIME_MS",
    "FOLLOWER_FETCH_TOTAL_TIME_MS",
    "PRODUCE_LOCAL_TIME_MS",
    "CONSUMER_FETCH_LOCAL_TIME_MS",
    "FOLLOWER_FETCH_LOCAL_TIME_MS",
]
_TIME_SUFFIXES = ["MAX", "MEAN", "50TH", "999TH"]


def _raw_metric_types() -> List[Tuple[str, MetricScope]]:
    """Full RawMetricType catalogue (RawMetricType.java:27-...)."""
    types: List[Tuple[str, MetricScope]] = [
        ("ALL_TOPIC_BYTES_IN", MetricScope.BROKER),
        ("ALL_TOPIC_BYTES_OUT", MetricScope.BROKER),
        ("TOPIC_BYTES_IN", MetricScope.TOPIC),
        ("TOPIC_BYTES_OUT", MetricScope.TOPIC),
        ("PARTITION_SIZE", MetricScope.PARTITION),
        ("BROKER_CPU_UTIL", MetricScope.BROKER),
        ("ALL_TOPIC_REPLICATION_BYTES_IN", MetricScope.BROKER),
        ("ALL_TOPIC_REPLICATION_BYTES_OUT", MetricScope.BROKER),
        ("ALL_TOPIC_PRODUCE_REQUEST_RATE", MetricScope.BROKER),
        ("ALL_TOPIC_FETCH_REQUEST_RATE", MetricScope.BROKER),
        ("ALL_TOPIC_MESSAGES_IN_PER_SEC", MetricScope.BROKER),
        ("TOPIC_REPLICATION_BYTES_IN", MetricScope.TOPIC),
        ("TOPIC_REPLICATION_BYTES_OUT", MetricScope.TOPIC),
        ("TOPIC_PRODUCE_REQUEST_RATE", MetricScope.TOPIC),
        ("TOPIC_FETCH_REQUEST_RATE", MetricScope.TOPIC),
        ("TOPIC_MESSAGES_IN_PER_SEC", MetricScope.TOPIC),
        ("BROKER_PRODUCE_REQUEST_RATE", MetricScope.BROKER),
        ("BROKER_CONSUMER_FETCH_REQUEST_RATE", MetricScope.BROKER),
        ("BROKER_FOLLOWER_FETCH_REQUEST_RATE", MetricScope.BROKER),
        ("BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT", MetricScope.BROKER),
        ("BROKER_REQUEST_QUEUE_SIZE", MetricScope.BROKER),
        ("BROKER_RESPONSE_QUEUE_SIZE", MetricScope.BROKER),
    ]
    for family in _BROKER_TIME_FAMILIES:
        for suffix in ["MAX", "MEAN"]:
            types.append((f"BROKER_{family}_{suffix}", MetricScope.BROKER))
    types.append(("BROKER_LOG_FLUSH_RATE", MetricScope.BROKER))
    types.append(("BROKER_LOG_FLUSH_TIME_MS_MAX", MetricScope.BROKER))
    types.append(("BROKER_LOG_FLUSH_TIME_MS_MEAN", MetricScope.BROKER))
    for family in _BROKER_TIME_FAMILIES:
        for suffix in ["50TH", "999TH"]:
            types.append((f"BROKER_{family}_{suffix}", MetricScope.BROKER))
    types.append(("BROKER_LOG_FLUSH_TIME_MS_50TH", MetricScope.BROKER))
    types.append(("BROKER_LOG_FLUSH_TIME_MS_999TH", MetricScope.BROKER))
    return types


#: Wire-level raw metric types; value is (id, scope).
RawMetricType = enum.Enum(
    "RawMetricType",
    {name: (i, scope) for i, (name, scope) in enumerate(_raw_metric_types())},
)


def raw_metric_scope(t: "RawMetricType") -> MetricScope:
    return t.value[1]


def raw_types_for_scope(scope: MetricScope) -> List["RawMetricType"]:
    return [t for t in RawMetricType if t.value[1] is scope]


# ---------------------------------------------------------------------------
# Aggregation-facing metric defs (KafkaMetricDef.java:41 equivalent).
# ---------------------------------------------------------------------------

#: Metric names in the "common" def scope — defined for both partition and broker
#: entities (KafkaMetricDef COMMON defs).
COMMON_METRIC_NAMES: List[str] = [
    "CPU_USAGE",
    "DISK_USAGE",
    "LEADER_BYTES_IN",
    "LEADER_BYTES_OUT",
    "PRODUCE_RATE",
    "FETCH_RATE",
    "MESSAGE_IN_RATE",
    "REPLICATION_BYTES_IN_RATE",
    "REPLICATION_BYTES_OUT_RATE",
]

_COMMON_GROUPS: Dict[str, Resource] = {
    "CPU_USAGE": Resource.CPU,
    "DISK_USAGE": Resource.DISK,
    "LEADER_BYTES_IN": Resource.NW_IN,
    "LEADER_BYTES_OUT": Resource.NW_OUT,
    "REPLICATION_BYTES_IN_RATE": Resource.NW_IN,
    "REPLICATION_BYTES_OUT_RATE": Resource.NW_OUT,
}


def _broker_only_names() -> List[str]:
    names = [
        "BROKER_PRODUCE_REQUEST_RATE",
        "BROKER_CONSUMER_FETCH_REQUEST_RATE",
        "BROKER_FOLLOWER_FETCH_REQUEST_RATE",
        "BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT",
        "BROKER_REQUEST_QUEUE_SIZE",
        "BROKER_RESPONSE_QUEUE_SIZE",
    ]
    for family in _BROKER_TIME_FAMILIES:
        for suffix in ["MAX", "MEAN"]:
            names.append(f"BROKER_{family}_{suffix}")
    names += ["BROKER_LOG_FLUSH_RATE", "BROKER_LOG_FLUSH_TIME_MS_MAX", "BROKER_LOG_FLUSH_TIME_MS_MEAN"]
    for family in _BROKER_TIME_FAMILIES:
        for suffix in ["50TH", "999TH"]:
            names.append(f"BROKER_{family}_{suffix}")
    names += ["BROKER_LOG_FLUSH_TIME_MS_50TH", "BROKER_LOG_FLUSH_TIME_MS_999TH"]
    return names


def build_common_metric_def() -> MetricDef:
    """Partition-entity metric def (the COMMON slice of KafkaMetricDef)."""
    d = MetricDef()
    for name in COMMON_METRIC_NAMES:
        strategy = ValueStrategy.LATEST if name == "DISK_USAGE" else ValueStrategy.AVG
        # Only CPU_USAGE is the prediction target of the trainable linear CPU
        # model (KafkaMetricDef.java: CPU_USAGE(..., true)); others are features.
        d.define(name, strategy, _COMMON_GROUPS.get(name), to_predict=name == "CPU_USAGE")
    return d


def build_broker_metric_def() -> MetricDef:
    """Broker-entity metric def: common defs plus broker-only defs."""
    d = build_common_metric_def()
    for name in _broker_only_names():
        # All broker-only defs aggregate with AVG in the reference
        # (KafkaMetricDef.java:61-101) — even the *_MAX/_999TH raw metrics are
        # averaged across samples within a window.
        d.define(name, ValueStrategy.AVG, None)
    return d


#: Shared singletons (cheap, immutable after construction).
COMMON_METRIC_DEF = build_common_metric_def()
BROKER_METRIC_DEF = build_broker_metric_def()


def resource_to_metric_ids(metric_def: MetricDef) -> Dict[Resource, List[int]]:
    """Map each Resource to the metric ids contributing to it (KafkaMetricDef.resourceToMetricIds)."""
    return {r: metric_def.ids_for_group(r) for r in Resource}
