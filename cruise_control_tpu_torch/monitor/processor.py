"""Raw metrics → partition/broker samples.

Port of ``cruise_control_tpu/monitor/processor.py``.

Counterpart of ``CruiseControlMetricsProcessor`` (monitor/sampling/
CruiseControlMetricsProcessor.java:36) and the derivation rules in
``docs/wiki/Developer Guide/Build-the-cluster-workload-model.md``:

* partition bytes-in/out are apportioned from the (broker, topic) byte rates over
  that broker's leader partitions of the topic — weighted by partition size when
  available, evenly otherwise;
* partition leader CPU is the broker CPU scaled by the partition's share of the
  broker's weighted byte throughput (the static a/b/c model, ``model/ModelUtils.java``);
* broker samples carry the broker-level aggregates plus replication byte rates
  reconstructed from follower placements.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

from cruise_control_tpu_torch.backend.base import PartitionInfo, RawMetric, TopicPartition
from cruise_control_tpu_torch.core.metricdef import BROKER_METRIC_DEF, COMMON_METRIC_DEF
from cruise_control_tpu_torch.model.model_utils import DEFAULT_CPU_WEIGHTS
from cruise_control_tpu_torch.monitor.samples import (
    BrokerMetricSample,
    PartitionMetricSample,
    SampleBatch,
)

_P_IDX = {info.name: info.id for info in COMMON_METRIC_DEF.all()}
_B_IDX = {info.name: info.id for info in BROKER_METRIC_DEF.all()}


class MetricsProcessor:
    """One call handles one fetch window; CPU apportioning weights are the only
    state (replaced by TRAIN via LoadMonitor.set_cpu_model)."""

    def __init__(self, cpu_weights=DEFAULT_CPU_WEIGHTS) -> None:
        self.cpu_weights = cpu_weights

    def process(
        self,
        raw: List[RawMetric],
        topics: Dict[str, List[PartitionInfo]],
    ) -> SampleBatch:
        by_ts: Dict[int, List[RawMetric]] = collections.defaultdict(list)
        for m in raw:
            by_ts[m.ts_ms].append(m)

        leader_of: Dict[TopicPartition, int] = {}
        followers_of: Dict[TopicPartition, Tuple[int, ...]] = {}
        for t, infos in topics.items():
            for info in infos:
                if info.leader is not None:
                    leader_of[info.tp] = info.leader
                    followers_of[info.tp] = tuple(
                        b for b in info.replicas if b != info.leader
                    )

        psamples: List[PartitionMetricSample] = []
        bsamples: List[BrokerMetricSample] = []
        for ts in sorted(by_ts):
            p, b = self._process_one(ts, by_ts[ts], leader_of, followers_of)
            psamples.extend(p)
            bsamples.extend(b)
        return SampleBatch(psamples, bsamples)

    def _process_one(self, ts, metrics, leader_of, followers_of):
        broker_cpu: Dict[int, float] = {}
        broker_in: Dict[int, float] = {}
        broker_out: Dict[int, float] = {}
        topic_in: Dict[Tuple[int, str], float] = {}
        topic_out: Dict[Tuple[int, str], float] = {}
        psize: Dict[TopicPartition, float] = {}

        for m in metrics:
            if m.scope == "BROKER":
                if m.name == "BROKER_CPU_UTIL":
                    broker_cpu[m.broker_id] = m.value
                elif m.name == "ALL_TOPIC_BYTES_IN":
                    broker_in[m.broker_id] = m.value
                elif m.name == "ALL_TOPIC_BYTES_OUT":
                    broker_out[m.broker_id] = m.value
            elif m.scope == "TOPIC" and m.topic is not None:
                if m.name == "TOPIC_BYTES_IN":
                    topic_in[(m.broker_id, m.topic)] = m.value
                elif m.name == "TOPIC_BYTES_OUT":
                    topic_out[(m.broker_id, m.topic)] = m.value
            elif m.scope == "PARTITION" and m.topic is not None:
                if m.name == "PARTITION_SIZE":
                    psize[(m.topic, m.partition)] = m.value

        # leader partitions per (broker, topic), for byte apportioning
        group: Dict[Tuple[int, str], List[TopicPartition]] = collections.defaultdict(list)
        for tp, leader in leader_of.items():
            group[(leader, tp[0])].append(tp)

        w = self.cpu_weights
        psamples: List[PartitionMetricSample] = []
        part_in: Dict[TopicPartition, float] = {}
        for (broker, topic), tps in group.items():
            tin = topic_in.get((broker, topic), 0.0)
            tout = topic_out.get((broker, topic), 0.0)
            sizes = [max(psize.get(tp, 0.0), 0.0) for tp in tps]
            total_size = sum(sizes)
            n = len(tps)
            bin_, bout = broker_in.get(broker, 0.0), broker_out.get(broker, 0.0)
            bcpu = broker_cpu.get(broker, 0.0)
            denom = w.leader_bytes_in * bin_ + w.leader_bytes_out * bout
            for tp, size in zip(tps, sizes):
                share = size / total_size if total_size > 0 else 1.0 / n
                p_in, p_out = tin * share, tout * share
                part_in[tp] = p_in
                cpu = (
                    bcpu * (w.leader_bytes_in * p_in + w.leader_bytes_out * p_out) / denom
                    if denom > 0
                    else 0.0
                )
                values = [0.0] * COMMON_METRIC_DEF.size()
                values[_P_IDX["CPU_USAGE"]] = cpu
                values[_P_IDX["DISK_USAGE"]] = psize.get(tp, 0.0)
                values[_P_IDX["LEADER_BYTES_IN"]] = p_in
                values[_P_IDX["LEADER_BYTES_OUT"]] = p_out
                psamples.append(
                    PartitionMetricSample(tp, broker, ts, tuple(values))
                )

        # broker samples: aggregates + replication bytes from follower placements
        repl_in: Dict[int, float] = collections.defaultdict(float)
        repl_out: Dict[int, float] = collections.defaultdict(float)
        for tp, fols in followers_of.items():
            v = part_in.get(tp, 0.0)
            for f in fols:
                repl_in[f] += v
            repl_out[leader_of[tp]] += v * len(fols)

        disk: Dict[int, float] = collections.defaultdict(float)
        for tp, leader in leader_of.items():
            disk[leader] += psize.get(tp, 0.0)
            for f in followers_of.get(tp, ()):
                disk[f] += psize.get(tp, 0.0)

        bsamples: List[BrokerMetricSample] = []
        for broker in set(broker_cpu) | set(broker_in) | set(broker_out):
            values = [0.0] * BROKER_METRIC_DEF.size()
            values[_B_IDX["CPU_USAGE"]] = broker_cpu.get(broker, 0.0)
            values[_B_IDX["DISK_USAGE"]] = disk.get(broker, 0.0)
            values[_B_IDX["LEADER_BYTES_IN"]] = broker_in.get(broker, 0.0)
            values[_B_IDX["LEADER_BYTES_OUT"]] = broker_out.get(broker, 0.0)
            values[_B_IDX["REPLICATION_BYTES_IN_RATE"]] = repl_in.get(broker, 0.0)
            values[_B_IDX["REPLICATION_BYTES_OUT_RATE"]] = repl_out.get(broker, 0.0)
            bsamples.append(BrokerMetricSample(broker, ts, tuple(values)))
        return psamples, bsamples
