"""LoadMonitor: sampling orchestration and cluster-model construction.

Port of ``cruise_control_tpu/monitor/loadmonitor.py``.

Counterpart of ``monitor/LoadMonitor.java:78`` and its task runner
(``monitor/task/LoadMonitorTaskRunner.java:33``):

* owns the partition- and broker-entity sliding-window aggregators
  (LoadMonitor.java:164-165 → :mod:`cruise_control_tpu_torch.core.aggregator`);
* drives the sampling state machine NOT_STARTED → RUNNING(SAMPLING) with
  PAUSED / BOOTSTRAPPING / LOADING excursions, pause/resume with a reason
  (LoadMonitorTaskRunner states);
* ``cluster_model()`` (LoadMonitor.java:491-543) aggregates the windows, checks
  completeness, joins live topology metadata + broker capacities, and emits the
  host-side :class:`ClusterModel` whose ``to_arrays(device=)`` feeds the solver on the device;
* a semaphore bounds concurrent model generations
  (``_clusterModelSemaphore``, LoadMonitor.java:94).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from cruise_control_tpu_torch.backend.base import ClusterBackend, TopicPartition
from cruise_control_tpu_torch.core.aggregator import (
    AggregationOptions,
    MetricSampleAggregator,
    NotEnoughValidWindowsError,
)
from cruise_control_tpu_torch.core.metricdef import (
    BROKER_METRIC_DEF,
    COMMON_METRIC_DEF,
)
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model.cluster import BrokerState, ClusterModel
from cruise_control_tpu_torch.model.model_utils import (
    DEFAULT_CPU_WEIGHTS,
    CpuModelWeights,
    follower_cpu_from_leader_load,
)
from cruise_control_tpu_torch.monitor.capacity import BrokerCapacityResolver
from cruise_control_tpu_torch.monitor.completeness import (
    ModelCompletenessRequirements,
    NotEnoughValidSnapshotsError,
)
from cruise_control_tpu_torch.monitor.samples import MetricSampler, SampleBatch
from cruise_control_tpu_torch.monitor.samplestore import NoopSampleStore, SampleStore

_P_IDX = {info.name: info.id for info in COMMON_METRIC_DEF.all()}

LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class WindowDelta:
    """One metric-window delta as it lands in the aggregators.

    Pushed to :meth:`LoadMonitor.add_window_listener` subscribers after every
    non-empty sample ingest — the event surface the continuous controller
    (``controller/``) consumes instead of polling ``cluster_model()`` per
    request.  ``window_id`` is the newest window the batch touched
    (``ts // window_ms``); ``new_window`` marks the first delta of a window
    (the previous window is complete by the aggregator's ring semantics).
    ``ingest_monotonic`` anchors reaction-latency measurement: time from this
    load evidence landing to a corrective proposal being published."""

    window_id: int
    ts_ms: int
    num_samples: int
    new_window: bool
    ingest_monotonic: float


class MonitorState:
    NOT_STARTED = "NOT_STARTED"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    LOADING = "LOADING"


@dataclasses.dataclass
class LoadMonitorState:
    """STATE-endpoint payload (LoadMonitorState.java)."""

    state: str
    reason_of_latest_pause_or_resume: Optional[str]
    num_valid_windows: int
    monitored_windows: List[int]
    num_monitored_partitions: int
    total_num_partitions: int
    monitoring_coverage_pct: float
    last_sample_ts_ms: int


class LoadMonitor:
    def __init__(
        self,
        backend: ClusterBackend,
        sampler: MetricSampler,
        capacity_resolver: BrokerCapacityResolver,
        num_windows: int = 5,
        window_ms: int = 60_000,
        min_samples_per_window: int = 1,
        sample_store: Optional[SampleStore] = None,
        max_concurrent_model_generations: int = 1,
        clock=None,
    ) -> None:
        self.backend = backend
        self.sampler = sampler
        self.capacity_resolver = capacity_resolver
        #: monotonic time source stamped onto WindowDelta.ingest_monotonic —
        #: injectable so the replay harness shares one fake clock with the
        #: controller and reaction latency stays deterministic
        self._clock = clock if clock is not None else time.monotonic
        self.window_ms = window_ms
        self.num_windows = num_windows
        self.sample_store = sample_store or NoopSampleStore()
        #: CPU apportioning weights; replaced by TRAIN when a fitted linear
        #: model is accepted (ModelParameters.updateModelCoefficient semantics)
        self.cpu_weights = DEFAULT_CPU_WEIGHTS
        self._partition_agg: MetricSampleAggregator[TopicPartition] = MetricSampleAggregator(
            num_windows, window_ms, min_samples_per_window, COMMON_METRIC_DEF
        )
        self._broker_agg: MetricSampleAggregator[int] = MetricSampleAggregator(
            num_windows, window_ms, min_samples_per_window, BROKER_METRIC_DEF
        )
        self._state = MonitorState.NOT_STARTED
        self._pause_reason: Optional[str] = None
        self._last_sample_ts = 0
        self._lock = threading.RLock()
        self._model_semaphore = threading.Semaphore(max_concurrent_model_generations)
        self._sampling_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: window-completion subscribers (see :meth:`add_window_listener`)
        self._window_listeners: List = []
        self._last_window_id = -1

    # -- lifecycle ----------------------------------------------------------

    def start(self, sampling_interval_ms: int = 0) -> None:
        """Replay persisted samples (LOADING), then mark RUNNING.  When
        ``sampling_interval_ms`` > 0, spawn the periodic sampling thread
        (LoadMonitorTaskRunner scheduled sampling)."""
        with self._lock:
            self._state = MonitorState.LOADING
        replay_tail: List[SampleBatch] = []

        def _ingest_replayed(batch: SampleBatch) -> None:
            self._ingest_batch(batch)
            if len(batch):
                replay_tail[:] = [batch]

        replayed = self.sample_store.replay(_ingest_replayed)
        with self._lock:
            self._state = MonitorState.RUNNING
        if replay_tail:
            # startup replay rebuilt the window ring: push ONE delta for the
            # newest replayed batch so push subscribers (the continuous
            # controller) wake into the warm windows instead of idling until
            # the next live sample
            self._notify_windows(replay_tail[0])
        if sampling_interval_ms > 0:
            self._stop.clear()
            self._sampling_thread = threading.Thread(
                target=self._sampling_loop, args=(sampling_interval_ms,), daemon=True
            )
            self._sampling_thread.start()
        return None

    def shutdown(self) -> None:
        self._stop.set()
        if self._sampling_thread:
            self._sampling_thread.join(timeout=5)
        self.sampler.close()
        self.sample_store.close()

    def set_cpu_model(self, weights: CpuModelWeights) -> None:
        """Adopt TRAIN-fitted CPU weights: every subsequent cluster model derives
        follower CPU and leadership deltas from them (ModelParameters semantics —
        the trained model replaces the static ModelUtils heuristic)."""
        self.cpu_weights = weights
        processor = getattr(self.sampler, "processor", None)
        if processor is not None:
            processor.cpu_weights = weights

    def _sampling_loop(self, interval_ms: int) -> None:
        while not self._stop.wait(interval_ms / 1000.0):
            if self._state == MonitorState.PAUSED:
                continue
            self.sample_once()

    # -- sampling -----------------------------------------------------------

    def pause_sampling(self, reason: str) -> None:
        """PAUSE_SAMPLING endpoint / executor pause (LoadMonitor pause)."""
        with self._lock:
            self._state = MonitorState.PAUSED
            self._pause_reason = reason

    def resume_sampling(self, reason: str) -> None:
        with self._lock:
            self._state = MonitorState.RUNNING
            self._pause_reason = reason

    def sample_once(self, now_ms: Optional[int] = None) -> int:
        """One sampling task execution: fetch → store → aggregate."""
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        with self._lock:
            if self._state == MonitorState.PAUSED:
                return 0
            prev = self._state
            self._state = MonitorState.SAMPLING
        try:
            # never ask the sampler for more history than the window ring holds
            # (first tick starts from wall-clock time, not from epoch 0)
            horizon = now_ms - (self._partition_agg.num_windows + 1) * self.window_ms
            from_ms = max(self._last_sample_ts, horizon, 0)
            batch = self.sampler.get_samples(from_ms, now_ms)
            self.sample_store.store(batch)
            self._ingest_batch(batch)
            self._last_sample_ts = now_ms
            self._notify_windows(batch)
            return len(batch)
        finally:
            with self._lock:
                # only restore if nobody (e.g. pause_sampling) changed state meanwhile
                if self._state == MonitorState.SAMPLING:
                    self._state = prev

    def bootstrap(self, from_ms: int, to_ms: int) -> int:
        """BOOTSTRAP endpoint: rebuild windows from a historical range
        (LoadMonitorTaskRunner.bootstrap:137-174)."""
        with self._lock:
            prev = self._state
            self._state = MonitorState.BOOTSTRAPPING
        try:
            batch = self.sampler.get_samples(from_ms, to_ms)
            self._ingest_batch(batch)
            self._last_sample_ts = max(self._last_sample_ts, to_ms)
            self._notify_windows(batch)
            return len(batch)
        finally:
            with self._lock:
                if self._state == MonitorState.BOOTSTRAPPING:
                    self._state = prev

    def _ingest_batch(self, batch: SampleBatch) -> None:
        for s in batch.partition_samples:
            self._partition_agg.add_sample(s.tp, s.ts_ms, s.values)
        for s in batch.broker_samples:
            self._broker_agg.add_sample(s.broker_id, s.ts_ms, s.values)

    # -- window-completion events --------------------------------------------

    def add_window_listener(self, fn) -> None:
        """Subscribe to metric-window deltas (push, not poll).

        ``fn(delta: WindowDelta)`` is invoked synchronously after every
        non-empty sample ingest (``sample_once`` / ``bootstrap`` / startup
        replay), on the ingesting thread — listeners must be cheap (record
        and wake; the continuous controller does exactly that).  A raising
        listener is swallowed: the sampling loop must never die to a
        subscriber bug."""
        self._window_listeners.append(fn)

    def _notify_windows(self, batch: SampleBatch) -> None:
        if not self._window_listeners or len(batch) == 0:
            return
        ts = max(
            [s.ts_ms for s in batch.partition_samples]
            + [s.ts_ms for s in batch.broker_samples]
        )
        window_id = ts // self.window_ms
        new_window = window_id > self._last_window_id
        self._last_window_id = max(self._last_window_id, window_id)
        delta = WindowDelta(
            window_id=int(window_id),
            ts_ms=int(ts),
            num_samples=len(batch),
            new_window=new_window,
            ingest_monotonic=self._clock(),
        )
        for fn in list(self._window_listeners):
            try:
                fn(delta)
            except Exception:
                # swallowed by design (the sampling loop must survive a
                # subscriber bug) but never silently: counted + named
                from cruise_control_tpu_torch.core.sensors import (
                    MONITOR_LISTENER_ERRORS_COUNTER,
                    REGISTRY,
                )

                REGISTRY.counter(MONITOR_LISTENER_ERRORS_COUNTER).inc()
                LOG.debug(
                    "window listener %s raised",
                    getattr(fn, "__qualname__", repr(fn)),
                    exc_info=True,
                )

    # -- model generation ---------------------------------------------------

    def acquire_for_model_generation(self, timeout_s: float = 60.0):
        """Context manager bounding concurrent model builds (semaphore :94)."""
        monitor = self

        class _Guard:
            def __enter__(self):
                if not monitor._model_semaphore.acquire(timeout=timeout_s):
                    raise TimeoutError("cluster model semaphore")
                return monitor

            def __exit__(self, *exc):
                monitor._model_semaphore.release()

        return _Guard()

    def cluster_model(
        self,
        from_ms: int = 0,
        to_ms: Optional[int] = None,
        requirements: ModelCompletenessRequirements = ModelCompletenessRequirements(),
    ) -> ClusterModel:
        """Build the host-side ClusterModel (LoadMonitor.clusterModel:491-543).

        Joins: aggregated partition windows (load), live metadata (placement,
        leadership, broker aliveness), capacity resolver (per-broker capacities,
        JBOD logdirs).  Raises :class:`NotEnoughValidSnapshotsError` when the
        completeness requirements cannot be met.
        """
        from cruise_control_tpu_torch.core.sensors import (
            CLUSTER_MODEL_CREATION_TIMER,
            REGISTRY,
        )
        from cruise_control_tpu_torch.obs import recorder as obs

        token = obs.start_trace("model")
        try:
            with self.acquire_for_model_generation():
                with REGISTRY.timer(CLUSTER_MODEL_CREATION_TIMER).time():
                    model = self._cluster_model_locked(from_ms, to_ms, requirements)
        except Exception as e:
            # a failed build (e.g. not enough valid windows during warm-up) is
            # exactly the kind of run that must leave a flight record
            obs.finish_trace(token, attrs={"error": str(e)})
            raise
        obs.finish_trace(
            token,
            attrs={
                "num_brokers": len(model.brokers()),
                "num_partitions": len(model.partitions()),
            },
        )
        return model

    def _cluster_model_locked(
        self,
        from_ms: int,
        to_ms: Optional[int],
        requirements: ModelCompletenessRequirements,
    ) -> ClusterModel:
        description = self.backend.describe_cluster()
        topics = self.backend.describe_topics()
        all_partitions = [i.tp for infos in topics.values() for i in infos]

        try:
            vae, completeness = self._partition_agg.aggregate(
                from_ms=from_ms,
                to_ms=to_ms,
                options=AggregationOptions(include_invalid_entities=False),
            )
        except NotEnoughValidWindowsError as e:
            raise NotEnoughValidSnapshotsError(str(e)) from e

        # enforce against the completeness report (windows that actually meet
        # coverage), not just the retention ring's window ids
        if completeness.num_valid_windows < requirements.min_required_num_windows:
            raise NotEnoughValidSnapshotsError(
                f"{completeness.num_valid_windows} valid windows < required "
                f"{requirements.min_required_num_windows}"
            )
        coverage = len(vae.entities) / max(len(all_partitions), 1)
        from cruise_control_tpu_torch.core.sensors import (
            MONITORED_PARTITIONS_GAUGE,
            REGISTRY,
            VALID_WINDOWS_GAUGE,
        )

        REGISTRY.gauge(MONITORED_PARTITIONS_GAUGE).set(coverage * 100.0)
        REGISTRY.gauge(VALID_WINDOWS_GAUGE).set(completeness.num_valid_windows)
        if coverage < requirements.min_monitored_partitions_percentage or not vae.entities:
            raise NotEnoughValidSnapshotsError(
                f"monitored partition coverage {coverage:.2%} below required "
                f"{requirements.min_monitored_partitions_percentage:.2%}"
            )

        loads = self._reduce_windows(vae)

        model = ClusterModel(cpu_weights=self.cpu_weights)
        logdirs_by_broker = self.backend.describe_logdirs()
        model_dirs: Dict[int, Dict[str, float]] = {}
        for broker_id, info in sorted(description.brokers.items()):
            cap = self.capacity_resolver.capacity_for(broker_id)
            dirs = dict(cap.disk_capacity_by_logdir or {})
            if not dirs:
                # no per-logdir capacities configured (plain capacity.json) but
                # the backend reports JBOD logdirs: split the broker's disk
                # capacity evenly so logdir-level operations stay available
                reported = logdirs_by_broker.get(broker_id, {})
                if reported:
                    per = cap.capacity.get(Resource.DISK, 0.0) / max(len(reported), 1)
                    dirs = {path: per for path in reported}
            model_dirs[broker_id] = dirs
            model.create_broker(
                info.rack,
                broker_id,
                cap.capacity,
                host=info.host,
                logdirs=dirs,
            )
            if not info.alive:
                model.set_broker_state(broker_id, BrokerState.DEAD)
            else:
                for path, d in logdirs_by_broker.get(broker_id, {}).items():
                    if d.offline and path in dirs:
                        model.mark_disk_dead(broker_id, path)

        monitored = set(vae.entities)
        for topic, infos in sorted(topics.items()):
            for pinfo in infos:
                if requirements.include_all_topics is False and pinfo.tp not in monitored:
                    continue
                leader = pinfo.leader
                load = loads.get(pinfo.tp)
                dirs_of = pinfo.logdir_by_broker or {}
                for pos, broker_id in enumerate(pinfo.replicas):
                    if broker_id not in description.brokers:
                        continue
                    is_leader = broker_id == leader
                    logdir = dirs_of.get(broker_id)
                    if logdir is not None and logdir not in model_dirs.get(broker_id, {}):
                        logdir = None
                    model.create_replica(
                        broker_id, pinfo.tp, pos, is_leader, logdir=logdir
                    )
                    if load is None:
                        continue
                    cpu, nw_in, nw_out, disk = load
                    if is_leader:
                        model.set_replica_load(
                            broker_id, pinfo.tp, [cpu, nw_in, nw_out, disk]
                        )
                    else:
                        fcpu = float(
                            follower_cpu_from_leader_load(
                                nw_in, nw_out, cpu, self.cpu_weights
                            )
                        )
                        model.set_replica_load(
                            broker_id, pinfo.tp, [fcpu, nw_in, 0.0, disk]
                        )
        return model

    def _reduce_windows(self, vae) -> Dict[TopicPartition, Tuple[float, float, float, float]]:
        """Windows → expected utilization (Load.expectedUtilizationFor, Load.java:81-98):
        AVG metrics average over valid windows, LATEST (disk) takes the newest."""
        values = vae.values  # [E, W, M]
        out: Dict[TopicPartition, Tuple[float, float, float, float]] = {}
        cpu_i, disk_i = _P_IDX["CPU_USAGE"], _P_IDX["DISK_USAGE"]
        in_i, out_i = _P_IDX["LEADER_BYTES_IN"], _P_IDX["LEADER_BYTES_OUT"]
        for e, tp in enumerate(vae.entities):
            v = values[e]
            out[tp] = (
                float(v[:, cpu_i].mean()),
                float(v[:, in_i].mean()),
                float(v[:, out_i].mean()),
                float(v[-1, disk_i]),   # LATEST: newest window
            )
        return out

    def current_partition_loads(
        self,
    ) -> Dict[TopicPartition, Tuple[float, float, float, float]]:
        """tp → (cpu, nw_in, nw_out, disk) expected utilization over the
        current valid windows — the load join of ``cluster_model()`` without
        the topology/capacity work.  The continuous controller's delta-ingest
        surface: it refreshes its device-resident load arrays from this map
        instead of rebuilding the whole model per tick.  Empty until the
        window ring holds a stable window."""
        try:
            vae, _ = self._partition_agg.aggregate(
                options=AggregationOptions(include_invalid_entities=False)
            )
        except NotEnoughValidWindowsError:
            return {}
        return self._reduce_windows(vae)

    def broker_metric_history(self):
        """(values f32[E, W, M], broker_ids, metric_def) for anomaly finders
        (the broker-aggregator view SlowBrokerFinder consumes); None when no
        stable windows exist yet."""
        try:
            vae, _ = self._broker_agg.aggregate(
                options=AggregationOptions(include_invalid_entities=True)
            )
        except NotEnoughValidWindowsError:
            return None
        return vae.values, list(vae.entities), self._broker_agg.metric_def

    # -- state --------------------------------------------------------------

    def state(self) -> LoadMonitorState:
        # STATE is an observability surface: a dead/blacked-out backend (open
        # circuit breaker, blackout chaos) must degrade it to the last-known
        # partition total, not take it down — the operator reads this exact
        # endpoint to diagnose the outage
        try:
            description = self.backend.describe_topics()
            total = sum(len(v) for v in description.values())
            self._last_known_total_partitions = total
        except Exception:
            total = getattr(self, "_last_known_total_partitions", 0)
        try:
            vae, completeness = self._partition_agg.aggregate(
                options=AggregationOptions(include_invalid_entities=False)
            )
            valid_windows = vae.window_ids
            monitored = len(vae.entities)
        except NotEnoughValidWindowsError:
            valid_windows, monitored = [], 0
        return LoadMonitorState(
            state=self._state,
            reason_of_latest_pause_or_resume=self._pause_reason,
            num_valid_windows=len(valid_windows),
            monitored_windows=list(valid_windows),
            num_monitored_partitions=monitored,
            total_num_partitions=total,
            monitoring_coverage_pct=monitored / max(total, 1),
            last_sample_ts_ms=self._last_sample_ts,
        )
