"""Host-side cluster model: ingest, topology bookkeeping, array snapshots.

Port of ``cruise_control_tpu/model/cluster.py``, the counterpart of the
mutable side of ``model/ClusterModel.java:48`` and its topology nodes.  The
class is deliberately thin: it owns the name-to-index maps and ingest-time
state (capacities, measured loads, lifecycle flags) and produces
:class:`~cruise_control_tpu_torch.model.arrays.ClusterArrays` snapshots via
:meth:`ClusterModel.to_arrays`, built in numpy exactly as the JAX package
builds them.  It never runs in the solver's hot path.

The reference's test fixtures (``DeterministicCluster.java:32``) drive this
API: create_rack/create_broker/create_replica/set_replica_load, then hand the
model to the analyzer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.core.device import DeviceLike
from cruise_control_tpu_torch.core.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.model import model_utils
from cruise_control_tpu_torch.model.model_utils import DEFAULT_CPU_WEIGHTS, CpuModelWeights

TopicPartition = Tuple[str, int]


class BrokerState:
    ALIVE = "ALIVE"
    DEAD = "DEAD"
    NEW = "NEW"
    DEMOTED = "DEMOTED"
    BAD_DISKS = "BAD_DISKS"


@dataclasses.dataclass
class _Replica:
    tp: TopicPartition
    broker_id: int
    index: int                      # position in the partition's replica list
    is_leader: bool
    load: Optional[np.ndarray] = None   # measured f64[4], set by set_replica_load
    logdir: Optional[str] = None
    is_original: bool = True        # False for replicas added after snapshot


@dataclasses.dataclass
class _Broker:
    broker_id: int
    rack: str
    host: str
    capacity: np.ndarray            # f64[4]
    state: str = BrokerState.ALIVE
    logdirs: Dict[str, float] = dataclasses.field(default_factory=dict)  # capacity per dir
    dead_logdirs: set = dataclasses.field(default_factory=set)
    #: logdirs marked for REMOVE_DISKS: still alive (their replicas are healthy)
    #: but zero-capacity, so the intra-broker goals drain them to siblings
    removed_logdirs: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class IndexMaps:
    """Dense-index dictionaries tying ClusterArrays axes back to names/ids."""

    broker_ids: List[int]                    # axis B -> broker id
    broker_index: Dict[int, int]
    rack_names: List[str]
    rack_index: Dict[str, int]
    host_names: List[str]
    host_index: Dict[str, int]
    topic_names: List[str]
    topic_index: Dict[str, int]
    partitions: List[TopicPartition]         # axis P -> (topic, partition)
    partition_index: Dict[TopicPartition, int]
    replicas: List[Tuple[TopicPartition, int]]   # axis R -> (tp, broker_id)
    disks: List[Tuple[int, str]]             # axis D -> (broker_id, logdir)
    disk_index: Dict[Tuple[int, str], int]


class ClusterModel:
    """Mutable ingest-side cluster model."""

    def __init__(self, cpu_weights: CpuModelWeights = DEFAULT_CPU_WEIGHTS) -> None:
        self._brokers: Dict[int, _Broker] = {}
        self._racks: Dict[str, List[int]] = {}
        self._replicas: Dict[Tuple[TopicPartition, int], _Replica] = {}
        self._partitions: Dict[TopicPartition, List[_Replica]] = {}
        self._cpu_weights = cpu_weights
        self.generation = 0

    # -- topology construction ----------------------------------------------

    def create_rack(self, rack: str) -> None:
        self._racks.setdefault(rack, [])
        self.generation += 1

    def create_broker(
        self,
        rack: str,
        broker_id: int,
        capacity: Mapping[Resource, float],
        host: Optional[str] = None,
        logdirs: Optional[Mapping[str, float]] = None,
    ) -> None:
        """Register a broker (ClusterModel.createBroker).

        ``capacity`` maps each Resource to its capacity (DISK MB, CPU %, NW KB/s —
        the units of ``config/capacity.json``).  ``logdirs`` adds JBOD disks whose
        capacities should sum to the DISK capacity (capacityJBOD.json).
        """
        if broker_id in self._brokers:
            raise ValueError(f"broker {broker_id} already exists")
        self.create_rack(rack)
        cap = np.zeros(NUM_RESOURCES, np.float64)
        for r in Resource:
            cap[r] = float(capacity[r])
        self._brokers[broker_id] = _Broker(
            broker_id=broker_id,
            rack=rack,
            host=host if host is not None else f"host-{broker_id}",
            capacity=cap,
            logdirs=dict(logdirs or {}),
        )
        self._racks[rack].append(broker_id)
        self.generation += 1

    def create_replica(
        self,
        broker_id: int,
        tp: TopicPartition,
        index: int,
        is_leader: bool,
        logdir: Optional[str] = None,
        is_original: bool = True,
    ) -> None:
        """Place a replica of ``tp`` on ``broker_id`` (ClusterModel.createReplica)."""
        if broker_id not in self._brokers:
            raise ValueError(f"unknown broker {broker_id}")
        key = (tp, broker_id)
        if key in self._replicas:
            raise ValueError(f"replica of {tp} already on broker {broker_id}")
        if logdir is not None and logdir not in self._brokers[broker_id].logdirs:
            raise ValueError(f"unknown logdir {logdir} on broker {broker_id}")
        plist = self._partitions.setdefault(tp, [])
        if is_leader and any(r.is_leader for r in plist):
            raise ValueError(f"partition {tp} already has a leader")
        replica = _Replica(tp, broker_id, index, is_leader, logdir=logdir, is_original=is_original)
        self._replicas[key] = replica
        plist.append(replica)
        self.generation += 1

    def delete_replica(self, broker_id: int, tp: TopicPartition) -> None:
        replica = self._replicas.pop((tp, broker_id), None)
        if replica is None:
            raise ValueError(f"no replica of {tp} on broker {broker_id}")
        self._partitions[tp].remove(replica)
        if not self._partitions[tp]:
            del self._partitions[tp]
        self.generation += 1

    def set_replica_load(self, broker_id: int, tp: TopicPartition, load: Sequence[float]) -> None:
        """Attach measured utilization [CPU, NW_IN, NW_OUT, DISK] to a replica
        (ClusterModel.setReplicaLoad, :738)."""
        replica = self._replicas.get((tp, broker_id))
        if replica is None:
            raise ValueError(f"no replica of {tp} on broker {broker_id}")
        arr = np.asarray(load, np.float64)
        if arr.shape != (NUM_RESOURCES,):
            raise ValueError(f"load must have {NUM_RESOURCES} entries")
        replica.load = arr
        self.generation += 1

    def set_broker_state(self, broker_id: int, state: str) -> None:
        """Set lifecycle state (ClusterModel.setBrokerState, :297)."""
        self._brokers[broker_id].state = state
        self.generation += 1

    def mark_disk_dead(self, broker_id: int, logdir: str) -> None:
        broker = self._brokers[broker_id]
        if logdir not in broker.logdirs:
            raise ValueError(f"unknown logdir {logdir}")
        broker.dead_logdirs.add(logdir)
        if broker.state == BrokerState.ALIVE:
            broker.state = BrokerState.BAD_DISKS
        self.generation += 1

    def mark_disk_removed(self, broker_id: int, logdir: str) -> None:
        """Mark a healthy logdir for removal (REMOVE_DISKS): it stays alive but
        its capacity reads as zero, so IntraBrokerDiskCapacityGoal drains it to
        the broker's remaining disks (RemoveDisksRunnable semantics)."""
        broker = self._brokers[broker_id]
        if logdir not in broker.logdirs:
            raise ValueError(f"unknown logdir {logdir}")
        broker.removed_logdirs.add(logdir)
        self.generation += 1

    # -- queries -------------------------------------------------------------

    def brokers(self) -> List[int]:
        return sorted(self._brokers)

    def broker_state(self, broker_id: int) -> str:
        return self._brokers[broker_id].state

    def partitions(self) -> List[TopicPartition]:
        return sorted(self._partitions)

    def all_replicas(self):
        """[(tp, broker_id, replica)] — iteration surface for finders/serializers."""
        return [(tp, b, r) for (tp, b), r in self._replicas.items()]

    def replicas_of(self, tp: TopicPartition) -> List[Tuple[int, bool]]:
        """[(broker_id, is_leader)] sorted by replica-list index."""
        return [
            (r.broker_id, r.is_leader)
            for r in sorted(self._partitions.get(tp, []), key=lambda r: r.index)
        ]

    def leader_of(self, tp: TopicPartition) -> Optional[int]:
        for r in self._partitions.get(tp, []):
            if r.is_leader:
                return r.broker_id
        return None

    def replica_distribution(self) -> Dict[TopicPartition, List[int]]:
        """tp -> ordered broker list (ClusterModel.getReplicaDistribution, :167)."""
        return {tp: [b for b, _ in self.replicas_of(tp)] for tp in self._partitions}

    def leader_distribution(self) -> Dict[TopicPartition, int]:
        """tp -> leader broker (ClusterModel.getLeaderDistribution, :187)."""
        return {tp: self.leader_of(tp) for tp in self._partitions}

    # -- snapshot ------------------------------------------------------------

    def to_arrays(
        self,
        pad_replicas_to: Optional[int] = None,
        pad_partitions_to: Optional[int] = None,
        pad_topics_to: Optional[int] = None,
        device: DeviceLike = None,
    ):
        """Flatten into an immutable :class:`ClusterArrays` + :class:`IndexMaps`.

        Replicas missing a measured load get zeros (the reference raises on
        incomplete load during model build; the monitor layer enforces completeness
        before snapshotting, so zeros here only occur in hand-built test models).

        The ``pad_*`` arguments round axis sizes up (padded replicas are masked by
        ``replica_valid``; padded partitions carry no replicas and leader −1) so
        differently-sized models can share one solver shape.  The arrays are
        built in numpy, exactly as the JAX package builds them, and land on
        ``device`` (``cuda`` unless ``device="cpu"``) in one copy per leaf.
        """
        from cruise_control_tpu_torch.model.bridge import arrays_from_numpy

        broker_ids = sorted(self._brokers)
        broker_index = {b: i for i, b in enumerate(broker_ids)}
        rack_names = sorted(self._racks)
        rack_index = {r: i for i, r in enumerate(rack_names)}
        host_names = sorted({self._brokers[b].host for b in broker_ids})
        host_index = {h: i for i, h in enumerate(host_names)}
        topic_names = sorted({tp[0] for tp in self._partitions})
        topic_index = {t: i for i, t in enumerate(topic_names)}
        partitions = sorted(self._partitions)
        partition_index = {tp: i for i, tp in enumerate(partitions)}

        disks: List[Tuple[int, str]] = []
        for b in broker_ids:
            for logdir in sorted(self._brokers[b].logdirs):
                disks.append((b, logdir))
        disk_index = {d: i for i, d in enumerate(disks)}

        replica_keys: List[Tuple[TopicPartition, int]] = []
        for tp in partitions:
            for r in sorted(self._partitions[tp], key=lambda r: r.index):
                replica_keys.append((tp, r.broker_id))
        n_live = len(replica_keys)
        R = pad_replicas_to if pad_replicas_to is not None else n_live
        if R < n_live:
            raise ValueError(f"pad_replicas_to={R} < live replicas {n_live}")

        B, D = len(broker_ids), len(disks)
        P = max(pad_partitions_to or 0, len(partitions))
        num_topics = max(pad_topics_to or 0, len(topic_names))
        replica_partition = np.zeros(R, np.int32)
        replica_broker = np.zeros(R, np.int32)
        replica_disk = np.full(R, -1, np.int32)
        replica_valid = np.zeros(R, bool)
        base_load = np.zeros((R, NUM_RESOURCES), np.float32)
        partition_topic = np.zeros(P, np.int32)
        partition_leader = np.full(P, -1, np.int32)
        leadership_delta = np.zeros((P, NUM_RESOURCES), np.float32)

        for tp in partitions:
            partition_topic[partition_index[tp]] = topic_index[tp[0]]

        # leadership delta from the ingest-time leader's measured load
        for tp, plist in self._partitions.items():
            leader = next((r for r in plist if r.is_leader), None)
            if leader is None or leader.load is None:
                continue
            cpu, nw_in, nw_out = (
                leader.load[Resource.CPU],
                leader.load[Resource.NW_IN],
                leader.load[Resource.NW_OUT],
            )
            follower_cpu = model_utils.follower_cpu_from_leader_load(
                nw_in, nw_out, cpu, self._cpu_weights
            )
            p = partition_index[tp]
            leadership_delta[p, Resource.CPU] = cpu - follower_cpu
            leadership_delta[p, Resource.NW_OUT] = nw_out

        for i, (tp, broker_id) in enumerate(replica_keys):
            r = self._replicas[(tp, broker_id)]
            p = partition_index[tp]
            replica_partition[i] = p
            replica_broker[i] = broker_index[broker_id]
            replica_valid[i] = True
            if r.logdir is not None:
                replica_disk[i] = disk_index[(broker_id, r.logdir)]
            measured = r.load if r.load is not None else np.zeros(NUM_RESOURCES)
            if r.is_leader:
                partition_leader[p] = i
                base_load[i] = measured - leadership_delta[p]
            else:
                base_load[i] = measured

        broker_capacity = np.stack([self._brokers[b].capacity for b in broker_ids]).astype(
            np.float32
        )
        broker_rack = np.array([rack_index[self._brokers[b].rack] for b in broker_ids], np.int32)
        broker_host = np.array([host_index[self._brokers[b].host] for b in broker_ids], np.int32)
        broker_alive = np.array(
            [self._brokers[b].state != BrokerState.DEAD for b in broker_ids], bool
        )
        broker_new = np.array([self._brokers[b].state == BrokerState.NEW for b in broker_ids], bool)
        broker_demoted = np.array(
            [self._brokers[b].state == BrokerState.DEMOTED for b in broker_ids], bool
        )

        disk_broker = np.array([broker_index[b] for b, _ in disks], np.int32)
        disk_capacity = np.array(
            [
                0.0 if d in self._brokers[b].removed_logdirs else self._brokers[b].logdirs[d]
                for b, d in disks
            ],
            np.float32,
        )
        disk_alive = np.array(
            [d not in self._brokers[b].dead_logdirs for b, d in disks], bool
        )

        state = arrays_from_numpy(
            dict(
                replica_partition=replica_partition,
                replica_broker=replica_broker,
                replica_disk=replica_disk,
                replica_valid=replica_valid,
                base_load=base_load,
                original_broker=replica_broker,
                partition_topic=partition_topic,
                partition_leader=partition_leader,
                leadership_delta=leadership_delta,
                broker_rack=broker_rack,
                broker_host=broker_host,
                broker_capacity=broker_capacity,
                broker_alive=broker_alive,
                broker_new=broker_new,
                broker_demoted=broker_demoted,
                disk_broker=disk_broker,
                disk_capacity=disk_capacity,
                disk_alive=disk_alive,
            ),
            num_racks=len(rack_names),
            num_topics=num_topics,
            num_hosts=len(host_names),
            device=device,
        )
        maps = IndexMaps(
            broker_ids=broker_ids,
            broker_index=broker_index,
            rack_names=rack_names,
            rack_index=rack_index,
            host_names=host_names,
            host_index=host_index,
            topic_names=topic_names,
            topic_index=topic_index,
            partitions=partitions,
            partition_index=partition_index,
            replicas=replica_keys,
            disks=disks,
            disk_index=disk_index,
        )
        return state, maps
