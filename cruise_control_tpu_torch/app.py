"""Application shell: assemble the whole system from a properties file.

Port of ``cruise_control_tpu/app.py``.  ``device`` is where every solve,
sweep, rollout and tick runs: ``cuda`` unless the caller passes ``cpu``; with
no GPU and no explicit CPU the constructor raises.  The facade, the
controller, the fleet and every fleet tenant get the same device; the monitor,
the executor, the detectors' own reads and the self-monitoring plane run on
the host.

Counterpart of ``KafkaCruiseControlMain.main`` (KafkaCruiseControlMain.java:26-40)
→ ``KafkaCruiseControlApp`` (KafkaCruiseControlApp.java:16): read + validate the
config, build backend → monitor → optimizer/facade → executor → detectors →
REST server, start the sampling loop and detection schedules, serve HTTP.

The southbound boundary is the :class:`ClusterBackend` SPI instead of a Kafka
AdminClient; the default backend is the in-process fake cluster (the embedded-
harness equivalent), with real backends pluggable via ``cluster.backend.class``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Mapping, Optional

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.api.security import BasicSecurityProvider, SecurityProvider
from cruise_control_tpu_torch.api.server import (
    CruiseControlApp,
    ReadinessController,
    ReadinessState,
    make_server,
)
from cruise_control_tpu_torch.backend.base import ClusterBackend
from cruise_control_tpu_torch.core.journal import Journal
from cruise_control_tpu_torch.core.config import Config, ConfigException, resolve_class
from cruise_control_tpu_torch.core.config_defs import cruise_control_config
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.core.retry import RetryPolicy
from cruise_control_tpu_torch.detector.detectors import (
    BrokerFailureDetector,
    DiskFailureDetector,
    ExecutionFailureDetector,
    GoalViolationDetector,
    SelfMetricAnomalyFinder,
    SlowBrokerFinder,
    TopicReplicationFactorAnomalyFinder,
)
from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
from cruise_control_tpu_torch.detector.notifier import AnomalyNotifier
from cruise_control_tpu_torch.detector.provisioner import Provisioner
from cruise_control_tpu_torch.executor import ExecutionJournal, Executor
from cruise_control_tpu_torch.executor.concurrency import ConcurrencyConfig
from cruise_control_tpu_torch.executor.engine import ExecutorNotifier
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.capacity import (
    BrokerCapacityResolver,
    FileCapacityResolver,
    StaticCapacityResolver,
)
from cruise_control_tpu_torch.monitor.samples import MetricSampler
from cruise_control_tpu_torch.monitor.samplestore import SampleStore


def _goal_ids(names, default):
    names = [n for n in (names or []) if n]
    if not names:
        return default
    try:
        return tuple(G.GOAL_ID_BY_NAME[n] for n in names)
    except KeyError as e:
        raise ConfigException(f"Unknown goal name {e.args[0]!r}") from None


def _constraint(cfg: Config, device: DeviceLike) -> BalancingConstraint:
    res = {
        "cpu": Resource.CPU,
        "disk": Resource.DISK,
        "network.inbound": Resource.NW_IN,
        "network.outbound": Resource.NW_OUT,
    }
    return BalancingConstraint.default(
        resource_balance_threshold={
            r: cfg.get(f"{n}.balance.threshold") for n, r in res.items()
        },
        resource_capacity_threshold={
            r: cfg.get(f"{n}.capacity.threshold") for n, r in res.items()
        },
        low_utilization_threshold={
            r: cfg.get(f"{n}.low.utilization.threshold") for n, r in res.items()
        },
        replica_balance_threshold=cfg.get("replica.count.balance.threshold"),
        leader_replica_balance_threshold=cfg.get("leader.replica.count.balance.threshold"),
        topic_replica_balance_threshold=cfg.get("topic.replica.count.balance.threshold"),
        max_replicas_per_broker=cfg.get("max.replicas.per.broker"),
        distribution_threshold_multiplier=cfg.get(
            "goal.violation.distribution.threshold.multiplier"
        ),
        min_topic_leaders_per_broker=cfg.get("min.topic.leaders.per.broker"),
        topic_replica_balance_min_gap=cfg.get("topic.replica.count.balance.min.gap"),
        topic_replica_balance_max_gap=cfg.get("topic.replica.count.balance.max.gap"),
        device=device,
    )


def _security(cfg: Config) -> Optional[SecurityProvider]:
    if not cfg.get("webserver.security.enable"):
        return None
    from cruise_control_tpu_torch.api.security import Role

    provider_spec = cfg.get("webserver.security.provider.class")
    if provider_spec:
        cls = resolve_class(provider_spec)
        if hasattr(cls, "from_config"):
            return cls.from_config(cfg)
        return cls()

    path = cfg.get("webserver.auth.credentials.file")
    users = {}
    if path:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                # Jetty realm format: "user: password, ROLE"
                user, _, rest = line.partition(":")
                password, _, role = rest.partition(",")
                role_name = (role.strip() or "USER").upper()
                users[user.strip()] = (password.strip(), Role[role_name])
    return BasicSecurityProvider(users)


class CruiseControlTpuApp:
    """The running service: facade + detectors + HTTP server + sampling loop."""

    def __init__(
        self,
        props: Mapping[str, object],
        backend: Optional[ClusterBackend] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        cfg = Config(cruise_control_config(), props)
        self.config = cfg

        # the kernels' build directory: a restarted server loads the
        # libraries it built instead of running nvcc again (compile.cache.dir;
        # the default build/kernels/ when unset)
        from cruise_control_tpu_torch.core.compile_cache import configure_compile_cache

        self.compile_cache_dir = configure_compile_cache(
            cfg.get("compile.cache.dir") or None
        )

        # device/executable profiler (obs/profiler.py): config wins unless the
        # CC_TPU_PROFILER env override is present (ops kill-switch semantics,
        # same precedence as the compile cache above)
        from cruise_control_tpu_torch.obs.profiler import PROFILER

        if os.environ.get("CC_TPU_PROFILER") is None:
            PROFILER.enabled = bool(cfg.get("profiler.enable"))

        self._demo_backend = False
        if backend is None:
            spec = props.get("cluster.backend.class")
            if spec:
                backend = resolve_class(spec)()
            else:
                from cruise_control_tpu_torch.backend import FakeClusterBackend

                # no real cluster configured: boot against a seeded in-process
                # demo cluster (the embedded-harness equivalent) so the REST
                # surface serves real responses out of the box
                backend = FakeClusterBackend()
                if cfg.get("demo.cluster.brokers") > 0:
                    backend.seed_demo(
                        num_brokers=cfg.get("demo.cluster.brokers"),
                        num_racks=cfg.get("demo.cluster.racks"),
                        num_partitions=cfg.get("demo.cluster.partitions"),
                        replication_factor=cfg.get("demo.cluster.replication.factor"),
                    )
                    self._demo_backend = True

        # backend circuit breaker (breaker.enable): ONE shared breaker guards
        # every southbound seam — monitor sampling, executor, detectors,
        # controller all see the same open/closed state, so a blackout fails
        # fast everywhere instead of stacking each caller in its own retry
        # backoff.  Wrapped BEFORE anything captures the backend reference.
        self.breaker = None
        if cfg.get("breaker.enable"):
            from cruise_control_tpu_torch.backend.breaker import (
                BreakerBackend,
                CircuitBreaker,
            )

            self.breaker = CircuitBreaker(
                failure_threshold=cfg.get("breaker.failure.threshold"),
                open_s=cfg.get("breaker.open.ms") / 1000.0,
                max_open_s=cfg.get("breaker.max.open.ms") / 1000.0,
            )
            backend = BreakerBackend(backend, self.breaker)
        self.backend = backend

        sampler_cls = resolve_class(cfg.get("metric.sampler.class"))
        try:
            sampler: MetricSampler = sampler_cls(backend)
        except TypeError:
            sampler = sampler_cls()
        resolver_cls = resolve_class(cfg.get("broker.capacity.config.resolver.class"))
        if issubclass(resolver_cls, FileCapacityResolver):
            resolver: BrokerCapacityResolver = resolver_cls(cfg.get("capacity.config.file"))
        elif issubclass(resolver_cls, StaticCapacityResolver):
            resolver = resolver_cls({r: 1.0 for r in Resource})
        else:
            resolver = resolver_cls()
        store_cls = resolve_class(cfg.get("sample.store.class"))
        try:
            store: SampleStore = store_cls(cfg.get("sample.store.dir"))
        except TypeError:
            store = store_cls()

        self.monitor = LoadMonitor(
            backend,
            sampler,
            resolver,
            num_windows=cfg.get("num.partition.metrics.windows"),
            window_ms=cfg.get("partition.metrics.window.ms"),
            min_samples_per_window=cfg.get("min.samples.per.partition.metrics.window"),
            sample_store=store if not cfg.get("skip.loading.samples") else None,
        )
        # crash-recovery journals (journal.dir): the executor's execution WAL
        # and the user-task WAL live side by side under one base directory so
        # "restart on the same dirs" is one knob.  Empty = durability off.
        jdir = cfg.get("journal.dir") or ""
        #: replication.role: 'writer' owns the WALs and the control loop;
        #: 'follower' tails the writer's controller WAL read-only and never
        #: opens a journal for writing (two processes appending to one WAL
        #: would be exactly the split-brain the epoch fence exists to stop)
        self.replication_role = cfg.get("replication.role")
        if self.replication_role == "follower" and not jdir:
            raise ValueError(
                "replication.role=follower requires journal.dir (the WAL "
                "the follower tails)"
            )
        self.execution_journal: Optional[ExecutionJournal] = None
        self._user_task_journal: Optional[Journal] = None
        jkw = dict(
            max_segment_records=cfg.get("journal.max.segment.records"),
            fsync=cfg.get("journal.fsync"),
        )
        if jdir:
            jdir = os.path.expanduser(jdir)
        if jdir and self.replication_role == "writer":
            self.execution_journal = ExecutionJournal(
                Journal(os.path.join(jdir, "executor"), **jkw)
            )
            self._user_task_journal = Journal(os.path.join(jdir, "usertasks"), **jkw)

        max_retries = cfg.get("backend.request.max.retries")
        retry_policy = (
            RetryPolicy(
                # the knob counts retries *after* the first attempt
                max_attempts=max_retries + 1,
                base_backoff_s=cfg.get("backend.request.retry.backoff.ms") / 1000.0,
                deadline_s=cfg.get("backend.request.retry.deadline.ms") / 1000.0,
            )
            if max_retries and max_retries > 0
            else None
        )
        task_timeout_ms = cfg.get("execution.task.timeout.ms")
        self.executor = Executor(
            backend,
            concurrency=ConcurrencyConfig(
                per_broker_moves=cfg.get("num.concurrent.partition.movements.per.broker"),
                cluster_moves=cfg.get("max.num.cluster.partition.movements"),
                intra_broker_moves=cfg.get("num.concurrent.intra.broker.partition.movements"),
                leadership_batch=cfg.get("num.concurrent.leader.movements"),
            ),
            throttle_rate_bytes=cfg.get("default.replication.throttle"),
            notifier=cfg.get_configured_instance("executor.notifier.class", ExecutorNotifier),
            pause_sampling=self.monitor.pause_sampling,
            resume_sampling=self.monitor.resume_sampling,
            retry_policy=retry_policy,
            task_timeout_s=(task_timeout_ms / 1000.0) if task_timeout_ms else None,
            rollback_stuck_tasks=cfg.get("execution.task.rollback.on.timeout"),
            journal=self.execution_journal,
            recovery_timeout_s=cfg.get("recovery.timeout.ms") / 1000.0,
        )
        deadline_ms = cfg.get("optimize.deadline.ms")
        self.cruise_control = CruiseControl(
            backend,
            self.monitor,
            self.executor,
            goal_ids=_goal_ids(cfg.get("default.goals"), G.DEFAULT_GOAL_ORDER),
            hard_ids=_goal_ids(cfg.get("hard.goals"), G.HARD_GOALS),
            constraint=_constraint(cfg, self.device),
            optimize_deadline_s=(deadline_ms / 1000.0) if deadline_ms else None,
            device=self.device,
        )

        # readiness ladder: monitor_warming → ready flips once the window
        # ring holds at least one valid window (the weakest completeness any
        # model consumer needs) — evaluated lazily on probe, no poll thread.
        # Built BEFORE the detector manager: its probe gates the detectors'
        # immediate first pass
        def _monitor_warm() -> bool:
            try:
                return self.monitor.state().num_valid_windows >= 1
            except Exception:
                return False

        self.readiness = ReadinessController(
            monitor_probe=_monitor_warm,
            retry_after_default_s=cfg.get("retry.after.default.s"),
            # the warming rung cannot end before the next sampling pass
            # completes a window — that interval IS the honest Retry-After
            warming_hint_s=cfg.get("metric.sampling.interval.ms") / 1000.0,
        )

        # continuous control loop (controller.enable): streaming drift-
        # triggered incremental rebalancing with a durable standing proposal
        # set (journal.dir namespace <dir>/controller)
        self.controller = None
        if (
            cfg.get("controller.enable")
            and not cfg.get("fleet.enable")
            and self.replication_role == "writer"
        ):
            from cruise_control_tpu_torch.controller import (
                ContinuousController,
                ControllerConfig,
                ControllerJournal,
            )

            controller_journal = None
            if jdir:
                controller_journal = ControllerJournal(
                    Journal(os.path.join(jdir, "controller"), **jkw)
                )
            self.controller = ContinuousController(
                self.cruise_control,
                journal=controller_journal,
                breaker=self.breaker,
                config=ControllerConfig(
                    tick_interval_s=cfg.get("controller.tick.interval.ms") / 1000.0,
                    drift_threshold=cfg.get("controller.drift.threshold"),
                    max_rounds_per_tick=cfg.get("controller.max.rounds.per.tick"),
                    stale_after_s=cfg.get("controller.stale.after.ms") / 1000.0,
                    execute=cfg.get("controller.execute.enable"),
                ),
                device=self.device,
            )
            self.monitor.add_window_listener(self.controller.on_window_delta)

        # replicated read plane (replication/): with a controller WAL on
        # disk, every process carries a ReplicationState — the writer feeds
        # it through the journal's append listener (same records, same
        # order as the WAL), a follower through the tailer thread below —
        # and the API stamps every read with {setVersion, epoch,
        # stalenessMs, degraded}
        self._replication = None
        self._follower_tailer = None
        if jdir:
            from cruise_control_tpu_torch.replication import (
                FollowerTailer,
                ReplicationState,
            )

            if self.replication_role == "follower":
                self._replication = ReplicationState(writer=False)
                self._follower_tailer = FollowerTailer(
                    os.path.join(jdir, "controller"),
                    self._replication,
                    poll_interval_s=(
                        cfg.get("replication.poll.interval.ms") / 1000.0
                    ),
                )
            elif self.controller is not None and self.controller.journal is not None:
                self._replication = ReplicationState(writer=True)
                self.controller.journal.listener = self._replication.apply

        # self-monitoring plane (selfmon.enable): a fixed-cadence sampler
        # turns the sensor registry (plus flight-recorder summary and
        # profiler census) into windowed time-series, and the SLO burn-rate
        # engine watches those series.  The spool is writer-only for the
        # same reason the WALs are: two processes appending one file.
        self.selfmon = None
        self.slo_engine = None
        self._selfmon_finder = None
        if cfg.get("selfmon.enable"):
            from cruise_control_tpu_torch.obs.selfmon import SelfMonitor
            from cruise_control_tpu_torch.obs.slo import (
                SloEngine,
                build_pairs,
                set_global_engine,
                shipped_specs,
            )

            self.selfmon = SelfMonitor(
                interval_s=cfg.get("selfmon.sample.interval.ms") / 1000.0,
                num_windows=cfg.get("selfmon.num.windows"),
                window_ms=cfg.get("selfmon.window.ms"),
                spool_dir=(
                    os.path.join(jdir, "selfmon")
                    if jdir and self.replication_role == "writer"
                    else None
                ),
                spool_max_bytes=cfg.get("selfmon.spool.max.bytes"),
            )
            self.slo_engine = SloEngine(
                shipped_specs(cfg.get), self.selfmon, pairs=build_pairs(cfg.get)
            )
            # the module hook lets a bare render_prometheus() (the API
            # server's existing call) pick up SLO families with no plumbing
            set_global_engine(self.slo_engine)

        interval = cfg.get("anomaly.detection.interval.ms") / 1000.0

        def _iv(key):
            v = cfg.get(key)
            return (v / 1000.0) if v is not None else interval

        self.provisioner: Provisioner = cfg.get_configured_instance(
            "provisioner.class", Provisioner
        )
        detectors = [
            (
                GoalViolationDetector(
                    self.cruise_control,
                    detection_goal_ids=_goal_ids(
                        cfg.get("anomaly.detection.goals"), G.DEFAULT_GOAL_ORDER
                    ),
                    provisioner=(
                        self.provisioner if cfg.get("provisioner.enable") else None
                    ),
                    # capacity sweeps (sim/planner.py) back every rightsize
                    # with measured numbers instead of the single-model guess
                    planner=(
                        self.cruise_control.plan_capacity
                        if cfg.get("provisioner.enable")
                        else None
                    ),
                ),
                _iv("goal.violation.detection.interval.ms"),
            ),
            (
                BrokerFailureDetector(backend, cfg.get("failed.brokers.file.path")),
                _iv("broker.failure.detection.interval.ms"),
            ),
            (DiskFailureDetector(backend), _iv("disk.failure.detection.interval.ms")),
            (SlowBrokerFinder(self.monitor), _iv("metric.anomaly.detection.interval.ms")),
            (
                TopicReplicationFactorAnomalyFinder(backend),
                _iv("topic.anomaly.detection.interval.ms"),
            ),
            (
                ExecutionFailureDetector(self.executor),
                _iv("execution.failure.detection.interval.ms"),
            ),
        ]
        if self.slo_engine is not None:
            # the fleet handle is attached after the fleet block below —
            # the finder reads self.fleet per run(), so late binding is safe
            self._selfmon_finder = SelfMetricAnomalyFinder(
                self.slo_engine,
                controller=self.controller,
                cooldown_s=cfg.get("slo.selfheal.cooldown.ms") / 1000.0,
            )
            detectors.append(
                (self._selfmon_finder, _iv("slo.detection.interval.ms"))
            )
        notifier_cls = resolve_class(cfg.get("anomaly.notifier.class"))
        try:
            notifier: AnomalyNotifier = notifier_cls(
                broker_failure_alert_threshold_ms=cfg.get("broker.failure.alert.threshold.ms"),
                broker_failure_self_healing_threshold_ms=cfg.get(
                    "broker.failure.self.healing.threshold.ms"
                ),
            )
        except TypeError:
            notifier = notifier_cls()
        if not cfg.get("self.healing.enabled") and hasattr(notifier, "_enabled"):
            for t in list(notifier._enabled):
                notifier._enabled[t] = False
        self.anomaly_manager = AnomalyDetectorManager(
            self.cruise_control, notifier, detectors,
            # one immediate pass per detector once the readiness ladder
            # reaches ready (anomaly.detection.initial.pass) — without it the
            # first detection waits a full interval after every restart
            initial_pass=cfg.get("anomaly.detection.initial.pass"),
            ready_probe=lambda: self.readiness.is_ready,
            # while the breaker is open a pass is skipped with a counted
            # reason — one outage must not read as a storm of anomalies
            breaker=self.breaker,
        )

        # admission controller (admission.enable): rate limits, per-principal
        # quotas, and the bounded priority queue in front of the user-task
        # plane.  max_concurrent defaults to the user-task active cap, so the
        # queue fills exactly when the task table would have 500'd before.
        from cruise_control_tpu_torch.api.admission import (
            AdmissionConfig,
            AdmissionController,
        )

        self.admission = AdmissionController(
            AdmissionConfig(
                enabled=cfg.get("admission.enable"),
                rate_qps=cfg.get("admission.rate.limit.qps"),
                rate_burst=cfg.get("admission.rate.burst"),
                max_tasks_per_principal=cfg.get("admission.max.tasks.per.principal"),
                max_concurrent=cfg.get("max.active.user.tasks"),
                queue_capacity=cfg.get("admission.queue.capacity"),
                queue_timeout_s=cfg.get("admission.queue.timeout.ms") / 1000.0,
                default_retry_after_s=cfg.get("retry.after.default.s"),
            )
        )
        # multi-tenant fleet controller (fleet.enable): N tenant clusters,
        # one batched control plane.  Supersedes the single-tenant loop
        # (controller.enable is ignored) — the app's primary cluster becomes
        # the 'default' tenant, adopting a pre-fleet journal.dir/controller
        # WAL on first startup; extra fleet.tenants get demo-seeded clusters
        # sampled by the same sampling loop.
        self.fleet = None
        self._fleet_monitors = []
        if cfg.get("fleet.enable") and self.replication_role == "writer":
            from cruise_control_tpu_torch.fleet import FleetConfig, FleetController

            tiers = {}
            for part in (cfg.get("fleet.tenant.tiers") or "").split(","):
                part = part.strip()
                if part:
                    tname, _, tval = part.partition(":")
                    tiers[tname.strip()] = int(tval)
            self.fleet = FleetController(
                config=FleetConfig(
                    tick_interval_s=cfg.get("fleet.tick.interval.ms") / 1000.0,
                    drift_threshold=cfg.get("fleet.drift.threshold"),
                    max_rounds_per_tick=cfg.get("fleet.max.rounds.per.tick"),
                    stale_after_s=cfg.get("fleet.stale.after.ms") / 1000.0,
                    execute=cfg.get("fleet.execute.enable"),
                    max_concurrent_drains=cfg.get("fleet.max.concurrent.drains"),
                    drain_stagger_s=cfg.get("fleet.drain.stagger.ms") / 1000.0,
                ),
                journal_dir=jdir or None,
                journal_kwargs=jkw,
                breaker=self.breaker,
                admission=self.admission,
                device=self.device,
            )
            self.fleet.add_tenant(
                "default", self.cruise_control, tier=tiers.get("default")
            )
            from cruise_control_tpu_torch.backend import FakeClusterBackend
            from cruise_control_tpu_torch.monitor.samples import BackendMetricSampler

            for name in cfg.get("fleet.tenants") or []:
                if not name or name == "default":
                    continue
                tb = FakeClusterBackend()
                tb.seed_demo(
                    num_brokers=cfg.get("demo.cluster.brokers") or 8,
                    num_racks=cfg.get("demo.cluster.racks"),
                    num_partitions=cfg.get("demo.cluster.partitions"),
                    replication_factor=cfg.get("demo.cluster.replication.factor"),
                )
                tmon = LoadMonitor(
                    tb,
                    BackendMetricSampler(tb),
                    resolver,
                    num_windows=cfg.get("num.partition.metrics.windows"),
                    window_ms=cfg.get("partition.metrics.window.ms"),
                    min_samples_per_window=cfg.get(
                        "min.samples.per.partition.metrics.window"
                    ),
                )
                tcc = CruiseControl(
                    tb,
                    tmon,
                    Executor(tb),
                    goal_ids=_goal_ids(cfg.get("default.goals"), G.DEFAULT_GOAL_ORDER),
                    hard_ids=_goal_ids(cfg.get("hard.goals"), G.HARD_GOALS),
                    constraint=_constraint(cfg, self.device),
                    device=self.device,
                )
                self.fleet.add_tenant(name, tcc, tier=tiers.get(name))
                self._fleet_monitors.append(tmon)
            if (
                jdir
                and self._replication is None
                and self.replication_role == "writer"
            ):
                # the replicated read plane follows the DEFAULT tenant's WAL
                # (the fleet-mode home of the pre-fleet controller namespace)
                dflt = self.fleet.tenant("default").controller
                if dflt.journal is not None:
                    from cruise_control_tpu_torch.replication import ReplicationState

                    self._replication = ReplicationState(writer=True)
                    dflt.journal.listener = self._replication.apply

        if self._selfmon_finder is not None and self.fleet is not None:
            # fleet is built after the detector list: late-bind the handle
            # so a burning SLO can pause fleet drains too
            self._selfmon_finder.fleet = self.fleet

        self.app = CruiseControlApp(
            self.cruise_control,
            anomaly_manager=self.anomaly_manager,
            provisioner=self.provisioner if cfg.get("provisioner.enable") else None,
            security=_security(cfg),
            two_step_verification=cfg.get("two.step.verification.enabled"),
            proposal_cache_ttl_s=cfg.get("proposal.expiration.ms") / 1000.0,
            readiness=self.readiness,
            user_task_journal=self._user_task_journal,
            controller=self.controller,
            fleet=self.fleet,
            admission=self.admission,
            breaker=self.breaker,
            # max.active.user.tasks was defined but never wired pre-overload-
            # plane: the task table cap and the admission slot count now both
            # come from the one knob
            max_active_user_tasks=cfg.get("max.active.user.tasks"),
            selfmon=self.selfmon,
            slo_engine=self.slo_engine,
            replication=self._replication,
            replication_opts={
                "lag.bound.ms": cfg.get("replication.lag.bound.ms"),
                "degraded.after.ms": cfg.get("replication.degraded.after.ms"),
                "watch.max.wait.ms": cfg.get("replication.watch.max.wait.ms"),
            },
        )
        self._server = None
        self._sampling_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self, serve_http: bool = True) -> None:
        """startUp(): crash recovery first, then sampling + detection (+ HTTP
        unless embedded).  The readiness ladder walks ``recovering`` (journal
        replay + backend reconciliation of interrupted executions) →
        ``monitor_warming`` → ``ready`` (first valid window); optimize-family
        endpoints 503 until the last step."""
        from cruise_control_tpu_torch.core.sensors import (
            RECOVERY_RECORDS_GAUGE,
            RECOVERY_WALL_GAUGE,
            REGISTRY,
        )

        # the HTTP server comes up FIRST: /healthz must answer (liveness) and
        # the readiness gate must 503 — not connection-refuse — while the
        # recovery pass below runs, or a k8s livenessProbe would kill the pod
        # mid-recovery on any journal large or stalled enough to outlast the
        # probe budget
        if serve_http:
            self._server = make_server(
                self.app,
                self.config.get("webserver.http.address"),
                self.config.get("webserver.http.port"),
            )
            threading.Thread(target=self._server.serve_forever, daemon=True).start()

        t_rec = time.monotonic()
        self.readiness.set_phase(ReadinessState.RECOVERING)
        recovered, recovery_error = [], None
        if self.execution_journal is not None:
            # an unreadable journal must not strand a half-started process
            # (HTTP already up, ladder pinned "recovering"): surface the
            # error through /healthz and proceed — the journal stays on disk
            # for the next restart to retry
            try:
                recovered = self.executor.recover()
            except Exception as e:
                recovery_error = f"{type(e).__name__}: {e}"
        def _seed_replication(s):
            # seed the writer's replicated view with the recovered set:
            # the journal listener only sees appends made from now on
            # (the startup rewrite feeds it when compaction ran; this
            # covers the already-compact WAL)
            from cruise_control_tpu_torch.executor.journal import proposal_to_record

            self._replication.apply({
                "type": "published", "version": s.version,
                "created_ms": s.created_ms, "trigger": s.trigger,
                "drift": s.drift, "reaction_s": s.reaction_s,
                "epoch": s.epoch,
                "proposals": [proposal_to_record(p) for p in s.proposals],
            })

        controller_records = 0
        if self.controller is not None:
            # the standing proposal set rides the same recovery phase: a
            # crashed controller resumes its journaled set, not a cold loop
            try:
                controller_records = self.controller.recover()
            except Exception as e:
                if recovery_error is None:
                    recovery_error = f"{type(e).__name__}: {e}"
            if (
                self._replication is not None
                and self.controller.standing is not None
                and self._replication.set_version == 0
            ):
                _seed_replication(self.controller.standing)
        if self.fleet is not None:
            # every tenant's standing set rides the same recovery phase
            # (fencing each tenant's epoch); the replicated read plane
            # follows the default tenant
            try:
                controller_records += self.fleet.recover()
            except Exception as e:
                if recovery_error is None:
                    recovery_error = f"{type(e).__name__}: {e}"
            dflt = self.fleet.tenant("default").controller
            if (
                self._replication is not None
                and dflt.standing is not None
                and self._replication.set_version == 0
            ):
                _seed_replication(dflt.standing)
        if self._follower_tailer is not None:
            # the follower's recovery phase IS the first tail catch-up: one
            # synchronous poll so reads answer from the journaled set the
            # moment the ladder opens, then the background cadence takes over
            try:
                controller_records = self._follower_tailer.poll_once()
            except Exception as e:
                if recovery_error is None:
                    recovery_error = f"{type(e).__name__}: {e}"
            self._follower_tailer.start()
        wall = time.monotonic() - t_rec
        stats = self.executor.last_recovery_stats
        records = (
            (stats.records if stats else 0)
            + self.app.user_tasks.recovered_records
            + controller_records
        )
        REGISTRY.gauge(RECOVERY_RECORDS_GAUGE).set(records)
        REGISTRY.gauge(RECOVERY_WALL_GAUGE).set(wall)
        self.readiness.recovery = {
            "wall_s": round(wall, 3),
            "records_replayed": records,
            "executions_recovered": len(recovered),
            "user_tasks_recovered": self.app.user_tasks.recovered_tasks,
        }
        if recovery_error is not None:
            self.readiness.recovery["error"] = recovery_error
        self.readiness.set_phase(ReadinessState.MONITOR_WARMING)

        self.cruise_control.start()
        if self.replication_role == "writer":
            # followers serve reads — they never run detectors (whose
            # passes can solve) or fix anything; one writer owns reaction
            self.anomaly_manager.start_detection()
        interval_s = self.config.get("metric.sampling.interval.ms") / 1000.0

        if self._demo_backend and self.config.get("demo.bootstrap.on.start"):
            # backfill one full window ring of demo metrics (BOOTSTRAP
            # semantics, LoadMonitorTaskRunner.bootstrap:137-174) so
            # LOAD/PROPOSALS have stable windows immediately instead of after
            # num_windows · window_ms of wall clock
            now_ms = int(time.time() * 1000)
            span = (self.monitor.num_windows + 1) * self.monitor.window_ms
            self.monitor.bootstrap(now_ms - span, now_ms)
        if self._fleet_monitors and self.config.get("demo.bootstrap.on.start"):
            # extra fleet tenants are always demo-seeded: backfill their
            # window rings too, so the fleet loop warms every lane at once
            now_ms = int(time.time() * 1000)
            for tmon in self._fleet_monitors:
                span = (tmon.num_windows + 1) * tmon.window_ms
                tmon.bootstrap(now_ms - span, now_ms)

        def _sampling_loop():
            while not self._stop.wait(interval_s):
                try:
                    self.monitor.sample_once()
                except Exception:   # sampling must survive transient backend errors
                    pass
                for tmon in self._fleet_monitors:
                    try:
                        tmon.sample_once()
                    except Exception:
                        pass

        self._sampling_thread = threading.Thread(target=_sampling_loop, daemon=True)
        self._sampling_thread.start()
        if self.selfmon is not None:
            # one immediate sample so STATE/SLO answer from real data the
            # moment the ladder opens, then the background cadence takes over
            try:
                self.selfmon.sample()
            except Exception:
                pass
            self.selfmon.start()
        if self.controller is not None:
            # the loop thread wakes on window deltas (and on cadence); it
            # warm-starts itself lazily once the monitor has a stable window
            self.controller.start()
        if self.fleet is not None:
            # same lazy-warm contract, one loop thread for every tenant
            self.fleet.start()
        if self.replication_role == "writer":
            # the precompute refresher runs the solver — not follower work
            self.app.start_proposal_refresher()

    def _stop_selfmon(self) -> None:
        if self.selfmon is not None:
            self.selfmon.stop()
        if self.slo_engine is not None:
            # drop the module hook so a later app (or test) never renders
            # SLO families from a stopped engine
            from cruise_control_tpu_torch.obs.slo import GLOBAL_ENGINE, set_global_engine

            if GLOBAL_ENGINE is self.slo_engine:
                set_global_engine(None)

    def stop(self) -> None:
        self._stop.set()
        self._stop_selfmon()
        if self._follower_tailer is not None:
            self._follower_tailer.stop()
        if self.controller is not None:
            self.controller.stop()   # seals the controller journal
        if self.fleet is not None:
            self.fleet.stop()        # seals every tenant's journal
        self.app.stop_proposal_refresher()
        if self._server is not None:
            self._server.shutdown()
        self.anomaly_manager.shutdown()
        self.monitor.shutdown()
        # graceful shutdown seals the journals' active segments; an ungraceful
        # drop leaves .open segments, which the next boot seals and replays
        if self.execution_journal is not None:
            try:
                self.execution_journal.close()
            except Exception:
                pass
        self.app.user_tasks.shutdown()

    def kill(self) -> None:
        """Crash simulation: take down every background thread with NONE of
        the graceful journal work — no segment sealing, no completion
        records, ``.open`` segments left exactly as a dead process leaves
        them.  A crash kills threads too: a test that merely drops a running
        app leaks its detector/refresher threads into later tests, where
        their periodic optimizes launch kernels inside unrelated
        flight-record windows."""
        self._stop.set()
        self._stop_selfmon()
        if self._follower_tailer is not None:
            self._follower_tailer.stop()
        if self.controller is not None:
            self.controller.kill()   # loop thread down, journal un-sealed
        if self.fleet is not None:
            self.fleet.kill()        # loop down, tenant journals un-sealed
        self.app.stop_proposal_refresher()
        if self._server is not None:
            self._server.shutdown()
        self.anomaly_manager.shutdown()
        self.monitor.shutdown()
        self.app.user_tasks.kill()   # worker pool down, journal un-sealed

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]


def load_properties(path: str) -> dict:
    """Parse a java-style .properties file (KafkaCruiseControlUtils.readConfig)."""
    props: dict = {}
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith(("#", "!")):
                continue
            key, _, value = line.partition("=")
            props[key.strip()] = value.strip()
    return props


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m cruise_control_tpu_torch")
    ap.add_argument("--config", help="properties file (cruisecontrol.properties)")
    ap.add_argument("--device", default=None,
                    help="torch device to solve on (default: cuda; the CPU only "
                         "when asked for with --device cpu)")
    ap.add_argument("--print-config-docs", action="store_true",
                    help="print the config doc table and exit")
    args = ap.parse_args(argv)

    if args.print_config_docs:
        print(cruise_control_config().doc_table())
        return 0

    # the device must answer before anything is built on it: the probe runs
    # in a killable child and raises, naming the device, when it does not
    from cruise_control_tpu_torch.core.backend_probe import ensure_live_backend

    print(f"cruise-control-tpu-torch device: {ensure_live_backend(args.device)}", flush=True)

    props = load_properties(args.config) if args.config else {}
    app = CruiseControlTpuApp(props, device=args.device)
    app.start()
    print(
        f"cruise-control-tpu-torch serving on "
        f"{app.config.get('webserver.http.address')}:{app.port} ({app.device})",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        app.stop()
    return 0
