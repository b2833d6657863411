"""In-process fake cluster backend.

Port of ``cruise_control_tpu/backend/fake.py``.

The test/demo stand-in for a real Kafka cluster — the role the reference's embedded
test kit plays (``CCEmbeddedBroker``/``CCKafkaIntegrationTestHarness``,
cruise-control-metrics-reporter/src/test, SURVEY §4 tier 4), but deterministic and
dependency-free.  It owns a mutable topology + per-partition leader loads, emits raw
metrics like the broker-side reporter plugin would, and *simulates* admin operations:
reassignments complete after a configurable number of progress polls, leader
elections follow the preferred order, broker/disk failures are injectable.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.backend.base import (
    BrokerInfo,
    ClusterBackend,
    ClusterDescription,
    LogdirInfo,
    PartitionInfo,
    RawMetric,
    ReassignmentInProgress,
    TopicPartition,
)


@dataclasses.dataclass
class _Partition:
    tp: TopicPartition
    replicas: List[int]               # ordered, preferred leader first
    leader: Optional[int]
    # leader-replica load [CPU%, NW_IN B/s, NW_OUT B/s, DISK bytes]
    load: np.ndarray
    logdir_by_broker: Dict[int, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Reassignment:
    target: List[int]
    polls_left: int
    adding: Tuple[int, ...]
    removing: Tuple[int, ...]


class FakeClusterBackend(ClusterBackend):
    """Deterministic fake cluster with injectable failures."""

    def __init__(
        self,
        reassignment_latency_polls: int = 1,
        metric_interval_ms: int = 10_000,
        noise: float = 0.0,
        seed: int = 0,
    ) -> None:
        self._brokers: Dict[int, BrokerInfo] = {}
        self._logdirs: Dict[int, Dict[str, LogdirInfo]] = {}
        self._partitions: Dict[TopicPartition, _Partition] = {}
        self._reassignments: Dict[TopicPartition, _Reassignment] = {}
        self._throttle: Optional[float] = None
        self._throttled: Dict[int, List[TopicPartition]] = {}
        self.reassignment_latency_polls = reassignment_latency_polls
        self.metric_interval_ms = metric_interval_ms
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        self._lock = threading.RLock()
        #: history of admin calls for assertions
        self.admin_log: List[Tuple[str, object]] = []

    # -- topology construction / fault injection ---------------------------

    def add_broker(
        self,
        broker_id: int,
        rack: str,
        host: Optional[str] = None,
        logdirs: Optional[Mapping[str, float]] = None,
    ) -> None:
        with self._lock:
            self._brokers[broker_id] = BrokerInfo(
                broker_id, rack, host or f"host-{broker_id}", alive=True
            )
            dirs = logdirs or {"/data/d0": 1e12}
            self._logdirs[broker_id] = {
                path: LogdirInfo(path, cap, offline=False) for path, cap in dirs.items()
            }

    def seed_demo(
        self,
        num_brokers: int = 8,
        num_racks: int = 2,
        num_partitions: int = 64,
        replication_factor: int = 2,
        num_topics: int = 4,
    ) -> "FakeClusterBackend":
        """Populate a deterministic demo topology (skewed loads so the analyzer
        has real work): the out-of-box equivalent of pointing the reference at
        a live cluster.
        """
        if num_brokers <= 0:
            raise ValueError(f"seed_demo needs num_brokers >= 1, got {num_brokers}")
        for b in range(num_brokers):
            self.add_broker(b, rack=str(b % num_racks))
        rf = min(replication_factor, num_brokers)
        for p in range(num_partitions):
            topic = f"demo-{p % max(num_topics, 1)}"
            # skew leaders onto the first half of the brokers
            first = p % max(num_brokers // 2, 1)
            replicas = [(first + i * num_racks + (i > 0)) % num_brokers for i in range(rf)]
            # dedupe while preserving order (tiny clusters can collide)
            seen: List[int] = []
            for r in replicas:
                while r in seen:
                    r = (r + 1) % num_brokers
                seen.append(r)
            scale = 1.0 + (p * 7919 % 13) / 4.0
            self.create_partition(
                (topic, p // max(num_topics, 1)),
                seen,
                load=[0.8 * scale, 2e3 * scale, 3e3 * scale, 2e4 * scale],
            )
        return self

    def create_partition(
        self,
        tp: TopicPartition,
        replicas: Sequence[int],
        load: Sequence[float],
        leader: Optional[int] = None,
    ) -> None:
        """Register a partition; ``load`` is the leader-replica [CPU, NW_IN, NW_OUT,
        DISK] utilization vector."""
        with self._lock:
            reps = list(replicas)
            # JBOD brokers place new replicas on their first logdir by default
            # (the broker's own placement policy; moved via alterReplicaLogDirs)
            logdirs = {
                b: sorted(self._logdirs[b])[0]
                for b in reps
                if self._logdirs.get(b)
            }
            self._partitions[tp] = _Partition(
                tp=tp,
                replicas=reps,
                leader=leader if leader is not None else reps[0],
                load=np.asarray(load, np.float64),
                logdir_by_broker=logdirs,
            )

    def kill_broker(self, broker_id: int) -> None:
        with self._lock:
            b = self._brokers[broker_id]
            self._brokers[broker_id] = dataclasses.replace(b, alive=False)
            for p in self._partitions.values():
                if p.leader == broker_id:
                    alive = [
                        r for r in p.replicas
                        if r != broker_id and self._brokers[r].alive
                    ]
                    p.leader = alive[0] if alive else None

    def restart_broker(self, broker_id: int) -> None:
        with self._lock:
            b = self._brokers[broker_id]
            self._brokers[broker_id] = dataclasses.replace(b, alive=True)

    def kill_logdir(self, broker_id: int, path: str) -> None:
        with self._lock:
            d = self._logdirs[broker_id][path]
            self._logdirs[broker_id][path] = dataclasses.replace(d, offline=True)

    def set_partition_load(self, tp: TopicPartition, load: Sequence[float]) -> None:
        with self._lock:
            self._partitions[tp].load = np.asarray(load, np.float64)

    # -- metadata ----------------------------------------------------------

    def describe_cluster(self) -> ClusterDescription:
        with self._lock:
            alive = [b for b, i in self._brokers.items() if i.alive]
            return ClusterDescription(
                brokers=dict(self._brokers),
                controller=min(alive) if alive else None,
            )

    def describe_topics(self) -> Dict[str, List[PartitionInfo]]:
        with self._lock:
            self._tick_reassignments()
            out: Dict[str, List[PartitionInfo]] = {}
            for tp, p in self._partitions.items():
                isr = tuple(r for r in p.replicas if self._brokers[r].alive)
                out.setdefault(tp[0], []).append(
                    PartitionInfo(
                        tp=tp, leader=p.leader, replicas=tuple(p.replicas), isr=isr,
                        logdir_by_broker=dict(p.logdir_by_broker) or None,
                    )
                )
            for infos in out.values():
                infos.sort(key=lambda i: i.tp[1])
            return out

    def describe_logdirs(self) -> Dict[int, Dict[str, LogdirInfo]]:
        with self._lock:
            return {b: dict(d) for b, d in self._logdirs.items()}

    # -- metric feed -------------------------------------------------------

    def fetch_raw_metrics(self, from_ms: int, to_ms: int) -> List[RawMetric]:
        """Emit reporter-style raw metrics for each interval in [from_ms, to_ms).

        Per broker: CPU util + bytes in/out (+ request metrics); per topic:
        bytes-in/out; per partition: size.  Matches the derivation inputs the
        reference's CruiseControlMetricsProcessor expects (SURVEY §2.3).
        """
        with self._lock:
            out: List[RawMetric] = []
            step = self.metric_interval_ms
            start = (from_ms // step) * step
            for ts in range(int(start), int(to_ms), step):
                if ts < from_ms:
                    continue
                out.extend(self._metrics_at(ts))
            return out

    def _noise(self) -> float:
        if self.noise <= 0:
            return 1.0
        return float(1.0 + self._rng.normal(0.0, self.noise))

    def _metrics_at(self, ts: int) -> List[RawMetric]:
        out: List[RawMetric] = []
        # per-broker / per-topic accumulators from partition loads
        broker_cpu: Dict[int, float] = {b: 0.0 for b in self._brokers}
        broker_in: Dict[int, float] = {b: 0.0 for b in self._brokers}
        broker_out: Dict[int, float] = {b: 0.0 for b in self._brokers}
        topic_in: Dict[Tuple[int, str], float] = {}
        topic_out: Dict[Tuple[int, str], float] = {}

        for tp, p in self._partitions.items():
            if p.leader is None or not self._brokers[p.leader].alive:
                continue
            cpu, nw_in, nw_out, disk = p.load
            lead = p.leader
            broker_cpu[lead] += cpu
            broker_in[lead] += nw_in
            broker_out[lead] += nw_out
            topic_in[(lead, tp[0])] = topic_in.get((lead, tp[0]), 0.0) + nw_in
            topic_out[(lead, tp[0])] = topic_out.get((lead, tp[0]), 0.0) + nw_out
            # follower replication contributes to follower CPU/bytes-in
            for r in p.replicas:
                if r != lead and self._brokers[r].alive:
                    broker_in[r] += nw_in
                    broker_cpu[r] += cpu * 0.15  # follower share, ModelUtils default c
            out.append(
                RawMetric(
                    "PARTITION_SIZE", "PARTITION", lead, float(disk) * self._noise(),
                    ts, topic=tp[0], partition=tp[1],
                )
            )

        for b, info in self._brokers.items():
            if not info.alive:
                continue
            out.append(RawMetric("ALL_TOPIC_BYTES_IN", "BROKER", b, broker_in[b] * self._noise(), ts))
            out.append(RawMetric("ALL_TOPIC_BYTES_OUT", "BROKER", b, broker_out[b] * self._noise(), ts))
            out.append(RawMetric("BROKER_CPU_UTIL", "BROKER", b, broker_cpu[b] * self._noise(), ts))
        for (b, t), v in topic_in.items():
            out.append(RawMetric("TOPIC_BYTES_IN", "TOPIC", b, v * self._noise(), ts, topic=t))
        for (b, t), v in topic_out.items():
            out.append(RawMetric("TOPIC_BYTES_OUT", "TOPIC", b, v * self._noise(), ts, topic=t))
        return out

    # -- admin operations --------------------------------------------------

    def alter_partition_reassignments(
        self, reassignments: Mapping[TopicPartition, Optional[Sequence[int]]]
    ) -> None:
        with self._lock:
            cancels = {tp for tp, target in reassignments.items() if target is None}
            for tp in cancels:
                # None target = cancel (Kafka empty-target semantics): drop the
                # in-flight reassignment, replicas stay at the pre-move set
                self._reassignments.pop(tp, None)
                self.admin_log.append(("cancel", tp))
            reassignments = {
                tp: target for tp, target in reassignments.items() if target is not None
            }
            for tp in reassignments:
                if tp in self._reassignments:
                    raise ReassignmentInProgress(f"{tp} already reassigning")
            for tp, target in reassignments.items():
                p = self._partitions[tp]
                old, new = set(p.replicas), set(target)
                self._reassignments[tp] = _Reassignment(
                    target=list(target),
                    polls_left=self.reassignment_latency_polls,
                    adding=tuple(sorted(new - old)),
                    removing=tuple(sorted(old - new)),
                )
                self.admin_log.append(("reassign", (tp, tuple(target))))

    def list_partition_reassignments(self):
        with self._lock:
            self._tick_reassignments()
            return {
                tp: (r.adding, r.removing) for tp, r in self._reassignments.items()
            }

    def list_ongoing_reassignments(self):
        """tp -> target replica set (exact — the fake tracks targets)."""
        with self._lock:
            self._tick_reassignments()
            return {tp: tuple(r.target) for tp, r in self._reassignments.items()}

    def _tick_reassignments(self) -> None:
        done = []
        for tp, r in self._reassignments.items():
            r.polls_left -= 1
            if r.polls_left <= 0:
                p = self._partitions[tp]
                p.replicas = list(r.target)
                if p.leader not in p.replicas:
                    alive = [b for b in p.replicas if self._brokers[b].alive]
                    p.leader = alive[0] if alive else None
                # logdir assignments follow the replica set: arriving JBOD
                # brokers place on their first logdir, departed entries drop
                p.logdir_by_broker = {
                    b: p.logdir_by_broker.get(b) or sorted(self._logdirs[b])[0]
                    for b in p.replicas
                    if self._logdirs.get(b)
                }
                done.append(tp)
        for tp in done:
            del self._reassignments[tp]

    def elect_leaders(self, partitions: Sequence[TopicPartition]) -> None:
        with self._lock:
            for tp in partitions:
                p = self._partitions[tp]
                for b in p.replicas:
                    if self._brokers[b].alive:
                        p.leader = b
                        break
                self.admin_log.append(("elect", tp))

    def alter_replica_logdirs(self, moves) -> None:
        with self._lock:
            for (tp, broker), path in moves.items():
                self._partitions[tp].logdir_by_broker[broker] = path
                self.admin_log.append(("logdir", (tp, broker, path)))

    def set_replication_throttles(self, rate_bytes, tp_by_broker) -> None:
        with self._lock:
            self._throttle = float(rate_bytes)
            self._throttled = {b: list(tps) for b, tps in tp_by_broker.items()}
            self.admin_log.append(("throttle", rate_bytes))

    def clear_replication_throttles(self) -> None:
        with self._lock:
            self._throttle = None
            self._throttled = {}
            self.admin_log.append(("unthrottle", None))

    @property
    def current_throttle(self) -> Optional[float]:
        return self._throttle
