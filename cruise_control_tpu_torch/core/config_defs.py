"""Grouped configuration definitions with the reference's key names.

Port of ``cruise_control_tpu/core/config_defs.py``: the same keys, types,
defaults, importances and validators, so one properties file resolves the
same in either package.  Every ``Type.CLASS`` default names the port's class
(:func:`~cruise_control_tpu_torch.core.config.resolve_class` refuses the JAX
package's).  Keys that only the JAX package reads (``compile.cache.dir``)
are kept, and the port ignores them.

Counterpart of ``config/constants/{MonitorConfig,AnalyzerConfig,ExecutorConfig,
AnomalyDetectorConfig,WebServerConfig}.java`` and ``KafkaCruiseControlConfig``:
each group is a ``ConfigDef`` built on the typed kernel in
:mod:`cruise_control_tpu_torch.core.config`; :func:`cruise_control_config` merges them
into the one registry the app shell resolves a properties file against
(``KafkaCruiseControlMain.java:26``).

Key names, defaults, and bounds mirror the reference wherever the knob maps onto
this framework (file:line cited per group); knobs tied to JVM/Kafka-client
plumbing (admin client timeouts, ZK paths, Jetty internals) are intentionally
absent — the backend SPI replaces them.
"""

from __future__ import annotations

from cruise_control_tpu_torch.core.config import (
    ConfigDef,
    Importance,
    Type,
    in_range,
    in_values,
)

H, M, L = Importance.HIGH, Importance.MEDIUM, Importance.LOW


def monitor_config() -> ConfigDef:
    """MonitorConfig.java — sampling / windowing / capacity resolution."""
    d = ConfigDef()
    d.define("num.partition.metrics.windows", Type.INT, 5, H,
             "Number of partition-metric windows the aggregator retains.",
             in_range(lo=1))
    d.define("partition.metrics.window.ms", Type.LONG, 3_600_000, H,
             "Span of one partition-metric window in milliseconds.", in_range(lo=1))
    d.define("min.samples.per.partition.metrics.window", Type.INT, 1, M,
             "Samples a window needs before it counts as valid.", in_range(lo=1))
    d.define("metric.sampling.interval.ms", Type.LONG, 120_000, M,
             "Interval between metric sampling runs.", in_range(lo=1))
    d.define("min.valid.partition.ratio", Type.DOUBLE, 0.995, M,
             "Monitored-partition coverage required to serve a cluster model.",
             in_range(0.0, 1.0))
    d.define("broker.capacity.config.resolver.class", Type.CLASS,
             "cruise_control_tpu_torch.monitor.capacity.FileCapacityResolver", M,
             "BrokerCapacityResolver implementation.")
    d.define("demo.cluster.brokers", Type.INT, 8, L,
             "Brokers the default in-process demo backend seeds when no "
             "cluster.backend.class is configured (0 = boot empty).",
             in_range(lo=0))
    d.define("demo.cluster.racks", Type.INT, 2, L,
             "Racks of the demo backend topology.", in_range(lo=1))
    d.define("demo.cluster.partitions", Type.INT, 64, L,
             "Partitions of the demo backend topology.", in_range(lo=0))
    d.define("demo.cluster.replication.factor", Type.INT, 2, L,
             "Replication factor of the demo backend topology.", in_range(lo=1))
    d.define("demo.bootstrap.on.start", Type.BOOLEAN, True, L,
             "Backfill a full window ring of demo metrics at startup "
             "(BOOTSTRAP semantics) so LOAD/PROPOSALS serve immediately.")
    d.define("capacity.config.file", Type.STRING, "config/capacity.json", M,
             "Capacity file for the file resolver (capacity.json / capacityJBOD.json).")
    d.define("metric.sampler.class", Type.CLASS,
             "cruise_control_tpu_torch.monitor.samples.BackendMetricSampler", M,
             "MetricSampler implementation.")
    d.define("sample.store.class", Type.CLASS,
             "cruise_control_tpu_torch.monitor.samplestore.FileSampleStore", M,
             "SampleStore implementation for persist/replay of samples.")
    d.define("sample.store.dir", Type.STRING, "/tmp/cruise-control-tpu-samples", L,
             "Directory for the file sample store.")
    d.define("skip.loading.samples", Type.BOOLEAN, False, L,
             "Skip replaying persisted samples on startup.")
    d.define("use.linear.regression.model", Type.BOOLEAN, False, L,
             "Use the TRAIN-fitted linear CPU model instead of the static weights.")
    d.define("leader.network.inbound.weight.for.cpu.util", Type.DOUBLE, 0.7, L,
             "Static CPU model weight a (ModelUtils).", in_range(0.0, 1.0))
    d.define("leader.network.outbound.weight.for.cpu.util", Type.DOUBLE, 0.15, L,
             "Static CPU model weight b.", in_range(0.0, 1.0))
    d.define("follower.network.inbound.weight.for.cpu.util", Type.DOUBLE, 0.15, L,
             "Static CPU model weight c.", in_range(0.0, 1.0))
    return d


def analyzer_config() -> ConfigDef:
    """AnalyzerConfig.java — goal list, thresholds, balancedness weights."""
    d = ConfigDef()
    d.define("default.goals", Type.LIST, "", H,
             "Goal names (reference class names) in priority order; empty = framework default list.")
    d.define("hard.goals", Type.LIST, "", H,
             "Hard-goal names; empty = framework default hard goals.")
    d.define("intra.broker.goals", Type.LIST,
             "IntraBrokerDiskCapacityGoal,IntraBrokerDiskUsageDistributionGoal", M,
             "JBOD intra-broker goal names.")
    for res in ("cpu", "disk", "network.inbound", "network.outbound"):
        d.define(f"{res}.balance.threshold", Type.DOUBLE, 1.10, M,
                 f"Balanced-ness band multiplier for {res}.", in_range(lo=1.0))
        d.define(f"{res}.low.utilization.threshold", Type.DOUBLE, 0.0, L,
                 f"Below this average utilization {res} is not balanced.",
                 in_range(0.0, 1.0))
    d.define("cpu.capacity.threshold", Type.DOUBLE, 0.7, M,
             "Usable fraction of CPU capacity.", in_range(0.0, 1.0))
    d.define("disk.capacity.threshold", Type.DOUBLE, 0.8, M,
             "Usable fraction of disk capacity.", in_range(0.0, 1.0))
    d.define("network.inbound.capacity.threshold", Type.DOUBLE, 0.8, M,
             "Usable fraction of inbound network capacity.", in_range(0.0, 1.0))
    d.define("network.outbound.capacity.threshold", Type.DOUBLE, 0.8, M,
             "Usable fraction of outbound network capacity.", in_range(0.0, 1.0))
    d.define("replica.count.balance.threshold", Type.DOUBLE, 1.10, M,
             "Replica-count band multiplier.", in_range(lo=1.0))
    d.define("leader.replica.count.balance.threshold", Type.DOUBLE, 1.10, M,
             "Leader-count band multiplier.", in_range(lo=1.0))
    d.define("topic.replica.count.balance.threshold", Type.DOUBLE, 3.0, L,
             "Per-topic replica-count band multiplier.", in_range(lo=1.0))
    d.define("topic.replica.count.balance.min.gap", Type.INT, 2, L,
             "Minimum per-topic count gap.", in_range(lo=0))
    d.define("topic.replica.count.balance.max.gap", Type.INT, 40, L,
             "Maximum per-topic count gap.", in_range(lo=0))
    d.define("max.replicas.per.broker", Type.LONG, 10_000, M,
             "ReplicaCapacityGoal limit.", in_range(lo=1))
    d.define("min.topic.leaders.per.broker", Type.INT, 1, L,
             "MinTopicLeadersPerBrokerGoal minimum.", in_range(lo=0))
    d.define("topics.with.min.leaders.per.broker", Type.STRING, "", L,
             "Regex of topics subject to MinTopicLeadersPerBrokerGoal.")
    d.define("goal.violation.distribution.threshold.multiplier", Type.DOUBLE, 1.0, L,
             "Detector band widening multiplier.", in_range(lo=1.0))
    d.define("goal.balancedness.priority.weight", Type.DOUBLE, 1.1, L,
             "Per-priority-level balancedness weight.", in_range(lo=0.0))
    d.define("goal.balancedness.strictness.weight", Type.DOUBLE, 1.5, L,
             "Hard-goal balancedness weight.", in_range(lo=0.0))
    d.define("proposal.expiration.ms", Type.LONG, 900_000, M,
             "Cached proposal freshness horizon.", in_range(lo=0))
    d.define("num.proposal.precompute.threads", Type.INT, 1, L,
             "Background proposal precompute workers.", in_range(lo=0))
    d.define("max.moves.per.broker.per.round", Type.INT, 8, L,
             "Solver top-k: candidate actions nominated per broker per round "
             "(TPU-specific; the depth of the parallel SortedReplicas walk).",
             in_range(lo=1))
    d.define("compile.cache.dir", Type.STRING, "", M,
             "Directory the CUDA kernels' shared libraries are built into "
             "and loaded from (core/compile_cache.py): a restarted server "
             "loads the libraries it built instead of running nvcc again "
             "(empty = build/kernels/ beside the checkout).")
    d.define("optimize.deadline.ms", Type.LONG, None, M,
             "Per-request optimize wall budget, checked between goal steps: "
             "on expiry the best-so-far placement is returned marked "
             "degraded=true instead of hanging the request (TPU-specific; "
             "unset = no deadline).")
    d.define("profiler.enable", Type.BOOLEAN, True, L,
             "Device/executable profiler (obs/profiler.py): per-compiled-"
             "program FLOPs/bytes/call counts in STATE, /METRICS and trace "
             "cost attrs.  Host-side only — warm paths gain zero dispatches "
             "and zero compiles either way (env override CC_TPU_PROFILER=0).")
    return d


def executor_config() -> ConfigDef:
    """ExecutorConfig.java — movement concurrency, throttles, progress checks."""
    d = ConfigDef()
    d.define("num.concurrent.partition.movements.per.broker", Type.INT, 5, H,
             "Per-broker inter-broker move cap.", in_range(lo=1))
    d.define("max.num.cluster.partition.movements", Type.INT, 1250, M,
             "Cluster-wide inter-broker move cap.", in_range(lo=1))
    d.define("num.concurrent.intra.broker.partition.movements", Type.INT, 2, M,
             "Intra-broker (logdir) move cap.", in_range(lo=1))
    d.define("num.concurrent.leader.movements", Type.INT, 1000, M,
             "Leadership-change batch size.", in_range(lo=1))
    d.define("execution.progress.check.interval.ms", Type.LONG, 10_000, M,
             "Interval between execution progress checks.", in_range(lo=1))
    d.define("default.replication.throttle", Type.LONG, None, L,
             "Replication throttle (bytes/s) applied during executions; unset = none.")
    d.define("concurrency.adjuster.interval.ms", Type.LONG, 360_000, L,
             "AIMD concurrency adjuster tick.", in_range(lo=1))
    d.define("concurrency.adjuster.min.isr.check.enabled", Type.BOOLEAN, True, L,
             "Gate concurrency increases on (At/Under)MinISR state.")
    d.define("executor.notifier.class", Type.CLASS,
             "cruise_control_tpu_torch.executor.engine.ExecutorNotifier", L,
             "ExecutorNotifier implementation.")
    d.define("demotion.history.retention.time.ms", Type.LONG, 86_400_000, L,
             "Retention of broker demotion history.", in_range(lo=0))
    d.define("removal.history.retention.time.ms", Type.LONG, 86_400_000, L,
             "Retention of broker removal history.", in_range(lo=0))
    d.define("backend.request.max.retries", Type.INT, 4, M,
             "Retries per southbound backend call after the first attempt "
             "(0 disables retry).", in_range(lo=0))
    d.define("backend.request.retry.backoff.ms", Type.LONG, 100, L,
             "Base exponential-backoff delay between backend-call retries.",
             in_range(lo=1))
    d.define("backend.request.retry.deadline.ms", Type.LONG, 30_000, L,
             "Overall wall budget per backend call across retries.", in_range(lo=1))
    d.define("execution.task.timeout.ms", Type.LONG, None, M,
             "In-flight reassignments stuck longer than this are marked DEAD "
             "instead of spinning the phase; unset = no per-task timeout.")
    d.define("execution.task.rollback.on.timeout", Type.BOOLEAN, False, L,
             "Cancel a timed-out reassignment server-side so the partition "
             "reverts to its pre-move replica set.")
    d.define("journal.dir", Type.STRING, "", H,
             "Base directory of the crash-recovery journals (executor "
             "execution WAL under <dir>/executor, user tasks under "
             "<dir>/usertasks).  Empty = durability disabled: a crash "
             "orphans in-flight reassignments and drops user tasks.")
    d.define("journal.fsync", Type.STRING, "rotate", M,
             "Journal fsync policy: 'always' (per append), 'rotate' "
             "(at segment seal; default), 'never' (OS buffering only).")
    d.define("journal.max.segment.records", Type.INT, 10_000, L,
             "Records per journal segment before the atomic seal-and-rotate.",
             in_range(lo=1))
    d.define("recovery.timeout.ms", Type.LONG, 30_000, M,
             "Wall budget of the startup resume-supervision loop: journaled "
             "reassignments still moving past it get the stuck-task "
             "treatment (DEAD, rolled back per "
             "execution.task.rollback.on.timeout).", in_range(lo=1))
    return d


def controller_config() -> ConfigDef:
    """Continuous controller (controller/ — TPU-specific, no reference
    counterpart): streaming drift-triggered incremental rebalancing."""
    d = ConfigDef()
    d.define("controller.enable", Type.BOOLEAN, False, H,
             "Run the continuous control loop: warm device-resident cluster "
             "state fed by monitor window deltas, drift-gated bounded "
             "incremental re-optimizes, and a durable standing proposal set "
             "(journaled under journal.dir/controller when journal.dir is "
             "set).")
    d.define("controller.tick.interval.ms", Type.LONG, 30_000, M,
             "Cadence of the control loop: even sub-threshold drift gets a "
             "corrective tick at this interval when violations are "
             "outstanding.", in_range(lo=1))
    d.define("controller.drift.threshold", Type.DOUBLE, 1.0, M,
             "Violation-count drift (vs the last published solve's residual) "
             "that triggers an immediate tick ahead of the cadence.",
             in_range(lo=0.0))
    d.define("controller.max.rounds.per.tick", Type.INT, 64, M,
             "Round cap per goal phase of a tick's bounded incremental "
             "re-optimize — the knob that keeps a tick's correction "
             "incremental instead of a full from-scratch-quality walk.",
             in_range(lo=1))
    d.define("controller.stale.after.ms", Type.LONG, 300_000, L,
             "With no fresh metric-window delta for this long, the "
             "controller flags itself stale in STATE//metrics and stops "
             "reacting (the standing set stays intact — no thrash on a "
             "reporter-feed outage).", in_range(lo=1))
    d.define("controller.execute.enable", Type.BOOLEAN, False, M,
             "Let the controller hand its standing proposal set to the "
             "executor (under the existing concurrency/throttle policy "
             "knobs).  Off = the set stands for operators / the CONTROLLER "
             "endpoint to inspect and drain manually.")
    return d


def fleet_config() -> ConfigDef:
    """Multi-tenant fleet controller (fleet/ — TPU-specific, no reference
    counterpart): N tenant clusters optimized together through one batched
    control plane."""
    d = ConfigDef()
    d.define("fleet.enable", Type.BOOLEAN, False, H,
             "Run the fleet controller instead of the single-tenant "
             "continuous controller: every tenant cluster keeps its own "
             "warm state, standing proposal set and journal namespace "
             "(journal.dir/<tenant>), while drift probes and incremental "
             "re-optimizes are batched across tenants into one vmapped "
             "dispatch per goal-order group.  The app's primary cluster "
             "becomes the 'default' tenant (adopting a pre-fleet "
             "journal.dir/controller WAL on first startup).")
    d.define("fleet.tenants", Type.LIST, "", M,
             "Extra tenant names to host beside 'default'; each gets its "
             "own demo-seeded cluster backend and monitor (a real "
             "deployment registers tenants programmatically via "
             "FleetController.add_tenant).")
    d.define("fleet.tick.interval.ms", Type.LONG, 30_000, M,
             "Cadence of the fleet loop: one evaluation covers every "
             "tenant.", in_range(lo=1))
    d.define("fleet.drift.threshold", Type.DOUBLE, 1.0, M,
             "Per-tenant violation-count drift that triggers that tenant's "
             "lane ahead of the cadence.", in_range(lo=0.0))
    d.define("fleet.max.rounds.per.tick", Type.INT, 64, M,
             "Round cap per goal phase of the batched incremental "
             "re-optimize (shared by every lane of a group).", in_range(lo=1))
    d.define("fleet.stale.after.ms", Type.LONG, 300_000, L,
             "Per-tenant staleness horizon (same semantics as "
             "controller.stale.after.ms, applied per tenant).", in_range(lo=1))
    d.define("fleet.execute.enable", Type.BOOLEAN, False, M,
             "Let the fleet drain published standing sets to the tenants' "
             "executors, under the cross-tenant arbitration below.  Tenant "
             "loops never drain on their own.")
    d.define("fleet.max.concurrent.drains", Type.INT, 1, M,
             "Cross-tenant capacity arbitration: standing sets granted a "
             "drain per fleet tick; the rest stay published and are "
             "superseded or drained on a later tick.", in_range(lo=1))
    d.define("fleet.drain.stagger.ms", Type.LONG, 0, L,
             "Staggered execution windows: minimum milliseconds between "
             "two drains of the same tenant (0 = no stagger).",
             in_range(lo=0))
    d.define("fleet.tenant.tiers", Type.STRING, "", M,
             "Tenant admission tiers as 'name:tier,...' (lower tier = "
             "served first within an endpoint class).  Threads each tenant "
             "principal's requests through the admission queue at its "
             "tier, so one noisy tenant cannot starve the fleet.")
    return d


def admission_config() -> ConfigDef:
    """Overload-resilient serving plane (api/admission.py + backend/breaker.py
    — TPU-specific, no reference counterpart): admission control, per-principal
    quotas, priority queueing, and the backend circuit breaker."""
    d = ConfigDef()
    d.define("admission.enable", Type.BOOLEAN, True, H,
             "Pass every authenticated request through the admission "
             "controller: per-principal token-bucket rate limits, active-"
             "operation quotas, and a global bounded priority queue feeding "
             "the user-task plane.  Rejected work gets 429 + Retry-After "
             "(derived from queue depth and drain rate), never a 500.")
    d.define("admission.rate.limit.qps", Type.DOUBLE, 0.0, M,
             "Per-principal request rate (token bucket refill, requests/s) "
             "on non-cheap endpoints; 0 = unlimited.  Cheap reads "
             "(STATE/METRICS/HEALTHZ/TRACES/...) and operator escape hatches "
             "always bypass.", in_range(lo=0.0))
    d.define("admission.rate.burst", Type.DOUBLE, 0.0, L,
             "Token-bucket depth (burst allowance); 0 = max(2 x qps, 1).",
             in_range(lo=0.0))
    d.define("admission.max.tasks.per.principal", Type.INT, 0, M,
             "Per-principal cap on concurrently in-flight solver operations "
             "(REBALANCE family, SIMULATE, RIGHTSIZE); 0 = no quota.  A "
             "principal at its quota is shed with 429 immediately — queueing "
             "it would let one tenant starve the rest.", in_range(lo=0))
    d.define("admission.queue.capacity", Type.INT, 64, M,
             "Bound of the global priority queue solver-class requests wait "
             "in when all execution slots are busy; arrivals past it shed "
             "instantly with 429 + Retry-After.", in_range(lo=1))
    d.define("admission.queue.timeout.ms", Type.LONG, 5_000, M,
             "Longest a queued request waits for an execution slot before "
             "shedding (also bounded by the request's own deadline_ms "
             "budget — an over-deadline queued request never reaches the "
             "solver).", in_range(lo=1))
    d.define("retry.after.default.s", Type.INT, 5, L,
             "Retry-After fallback (seconds) for 429/503 responses when no "
             "better estimate exists yet (no observed drain rate, "
             "zero-progress recovery).", in_range(lo=1))
    d.define("breaker.enable", Type.BOOLEAN, True, H,
             "Guard every southbound backend call with a shared circuit "
             "breaker (closed -> open -> half-open): after "
             "breaker.failure.threshold consecutive failures callers fail "
             "fast instead of stacking in retry backoff; deterministic "
             "seeded probes close it again.  While open, detectors skip "
             "their pass (counted), the controller holds position, and "
             "REBALANCE-family requests degrade to the journaled standing "
             "proposal set marked degraded=true.")
    d.define("breaker.failure.threshold", Type.INT, 5, M,
             "Consecutive southbound failures that open the breaker (any "
             "success resets the streak).", in_range(lo=1))
    d.define("breaker.open.ms", Type.LONG, 10_000, M,
             "Cooldown before the first half-open probe; doubles per failed "
             "probe (seeded jitter) up to breaker.max.open.ms.",
             in_range(lo=1))
    d.define("breaker.max.open.ms", Type.LONG, 60_000, L,
             "Ceiling of the probe-backoff cooldown.", in_range(lo=1))
    return d


def anomaly_detector_config() -> ConfigDef:
    """AnomalyDetectorConfig.java — detection cadence, self-healing, notifier."""
    d = ConfigDef()
    d.define("anomaly.detection.interval.ms", Type.LONG, 300_000, H,
             "Default detector cadence.", in_range(lo=1))
    d.define("anomaly.detection.initial.pass", Type.BOOLEAN, True, M,
             "Run one immediate detection pass per detector as soon as the "
             "readiness ladder reaches ready, instead of sleeping a full "
             "interval first (a broker that died during the restart window "
             "would otherwise go unnoticed for up to a whole cadence).")
    d.define("goal.violation.detection.interval.ms", Type.LONG, None, M,
             "Goal-violation detector cadence; unset = anomaly.detection.interval.ms.")
    d.define("broker.failure.detection.interval.ms", Type.LONG, None, M,
             "Broker-failure detector cadence; unset = anomaly.detection.interval.ms.")
    d.define("disk.failure.detection.interval.ms", Type.LONG, None, M,
             "Disk-failure detector cadence; unset = anomaly.detection.interval.ms.")
    d.define("metric.anomaly.detection.interval.ms", Type.LONG, None, M,
             "Metric-anomaly (slow broker) cadence; unset = anomaly.detection.interval.ms.")
    d.define("topic.anomaly.detection.interval.ms", Type.LONG, None, M,
             "Topic-anomaly cadence; unset = anomaly.detection.interval.ms.")
    d.define("execution.failure.detection.interval.ms", Type.LONG, None, M,
             "Execution-failure detector cadence; unset = anomaly.detection.interval.ms.")
    d.define("anomaly.detection.goals", Type.LIST, "", M,
             "Goal names the violation detector re-optimizes; empty = default list.")
    d.define("anomaly.notifier.class", Type.CLASS,
             "cruise_control_tpu_torch.detector.notifier.SelfHealingNotifier", M,
             "AnomalyNotifier implementation.")
    d.define("self.healing.enabled", Type.BOOLEAN, False, H,
             "Master switch for self-healing across anomaly types.")
    d.define("broker.failure.alert.threshold.ms", Type.LONG, 900_000, M,
             "Grace period before a broker failure alerts.", in_range(lo=0))
    d.define("broker.failure.self.healing.threshold.ms", Type.LONG, 1_800_000, M,
             "Grace period before a broker failure self-heals.", in_range(lo=0))
    d.define("failed.brokers.file.path", Type.STRING,
             "/tmp/cruise-control-tpu-failed-brokers.txt", L,
             "Persisted failed-broker times (survive restarts).")
    d.define("provisioner.class", Type.CLASS,
             "cruise_control_tpu_torch.detector.provisioner.BasicProvisioner", L,
             "Provisioner implementation for rightsizing.")
    d.define("provisioner.enable", Type.BOOLEAN, True, L,
             "Whether rightsizing consults the provisioner.")
    return d


def webserver_config() -> ConfigDef:
    """WebServerConfig.java — HTTP endpoint, auth, two-step verification."""
    d = ConfigDef()
    d.define("webserver.http.address", Type.STRING, "127.0.0.1", H,
             "Bind address of the REST API.")
    d.define("webserver.http.port", Type.INT, 9090, H,
             "Port of the REST API (0 = ephemeral).", in_range(0, 65535))
    d.define("webserver.api.urlprefix", Type.STRING, "/kafkacruisecontrol/*", L,
             "URL prefix of the API.")
    d.define("webserver.security.enable", Type.BOOLEAN, False, M,
             "Enable HTTP authentication.")
    d.define("webserver.auth.credentials.file", Type.STRING, "", M,
             "Credentials file: 'user: password, ROLE' per line (Jetty realm format).")
    d.define("webserver.security.provider.class", Type.STRING, "", M,
             "SecurityProvider implementation (dotted module.Class path). Empty = HTTP Basic from "
             "the credentials file; api.security_providers ships JWT, trusted-proxy "
             "and SPNEGO providers (servlet/security/ counterparts).")
    d.define("webserver.security.jwt.secret", Type.STRING, "", M,
             "HS256 secret for JwtSecurityProvider.")
    d.define("webserver.security.trusted.proxy.secret", Type.STRING, "", M,
             "Shared secret for TrustedProxySecurityProvider's proxy handshake.")
    d.define("webserver.security.spnego.principal", Type.STRING, "", M,
             "Service principal for SpnegoSecurityProvider (empty = default keytab credential).")
    d.define("two.step.verification.enabled", Type.BOOLEAN, False, M,
             "Park POSTs in the purgatory until reviewed.")
    d.define("two.step.purgatory.retention.time.ms", Type.LONG, 1_209_600_000, L,
             "Retention of reviewed requests.", in_range(lo=0))
    d.define("two.step.purgatory.max.requests", Type.INT, 25, L,
             "Maximum pending review requests.", in_range(lo=1))
    d.define("max.active.user.tasks", Type.INT, 25, L,
             "Concurrent async user tasks.", in_range(lo=1))
    return d


def replication_config() -> ConfigDef:
    """Replicated read plane (replication/ — TPU-specific, no reference
    counterpart): WAL-tailing follower processes, writer epoch fencing, and
    long-poll watch subscriptions over the standing proposal set."""
    d = ConfigDef()
    d.define("replication.role", Type.STRING, "writer", H,
             "Process role.  'writer' (default) owns optimize/execute and "
             "the controller WAL write path.  'follower' tails the writer's "
             "journal.dir read-only, serves the read surface + WATCH, and "
             "refuses every mutating endpoint — promote one by restarting "
             "it as a writer on the same journal.dir (it fences the old "
             "writer's epoch).", in_values("writer", "follower"))
    d.define("replication.poll.interval.ms", Type.LONG, 50, M,
             "Follower WAL-tail poll cadence.  Lower = fresher reads and "
             "faster watch delta fan-out, at more filesystem stats.",
             in_range(lo=1))
    d.define("replication.lag.bound.ms", Type.LONG, 5_000, H,
             "Staleness budget: a follower whose last successful tail poll "
             "is older than this answers 503 + Retry-After instead of "
             "silently-stale data (the admission plane's shed discipline applied to "
             "replication lag).", in_range(lo=1))
    d.define("replication.degraded.after.ms", Type.LONG, 10_000, M,
             "With no writer WAL activity for this long, follower reads are "
             "stamped degraded=true — still served (the journaled set is "
             "authoritative) but flagged so clients know the writer may be "
             "down.", in_range(lo=1))
    d.define("replication.watch.max.wait.ms", Type.LONG, 30_000, L,
             "Ceiling on a WATCH long-poll's timeout_ms parameter; a poll "
             "with no delta by then returns an empty page (clients just "
             "re-arm with the same cursor).", in_range(lo=1))
    return d


def selfmon_config() -> ConfigDef:
    """Self-monitoring plane (obs/selfmon.py + obs/slo.py — TPU-specific, no
    reference counterpart): the sensor-registry sampler, its windowed
    aggregation/spool, and the SLO burn-rate engine + self-heal detector."""
    d = ConfigDef()
    d.define("selfmon.enable", Type.BOOLEAN, True, H,
             "Sample the process's own sensor registry (plus flight-recorder "
             "summary and profiler census) on a fixed cadence into windowed "
             "time-series; feeds GET /METRICS?window=, the SLO endpoint, and "
             "the SelfMetricAnomalyFinder.")
    d.define("selfmon.sample.interval.ms", Type.LONG, 10_000, M,
             "Sampler cadence.  Pure host-side work (no device dispatches); "
             "the bench holds one sample under 1% of a warm controller tick.",
             in_range(lo=1))
    d.define("selfmon.num.windows", Type.INT, 60, M,
             "Stable aggregation windows retained per series (the L0 "
             "aggregator ring, current window excluded).", in_range(lo=1))
    d.define("selfmon.window.ms", Type.LONG, 60_000, M,
             "Width of one self-monitoring aggregation window.",
             in_range(lo=1))
    d.define("selfmon.spool.max.bytes", Type.LONG, 8 * 1024 * 1024, L,
             "Size cap of the journal.dir/selfmon JSONL spool; on overflow "
             "the active file rotates to selfmon.jsonl.1 (one generation "
             "kept).", in_range(lo=1))
    d.define("slo.burn.budget", Type.DOUBLE, 0.01, M,
             "Error budget: the allowed bad-sample fraction per SLO (burn "
             "rate 1.0 = spending exactly the budget).")
    d.define("slo.fast.long.window.s", Type.DOUBLE, 3600.0, M,
             "Fast (page) burn pair: long window seconds.")
    d.define("slo.fast.short.window.s", Type.DOUBLE, 300.0, M,
             "Fast (page) burn pair: short window seconds.")
    d.define("slo.fast.burn.threshold", Type.DOUBLE, 14.4, M,
             "Fast pair firing threshold (14.4 = 2% of a 30-day budget in "
             "one hour, SRE Workbook table 5-2).")
    d.define("slo.slow.long.window.s", Type.DOUBLE, 259_200.0, M,
             "Slow (ticket) burn pair: long window seconds.")
    d.define("slo.slow.short.window.s", Type.DOUBLE, 21_600.0, M,
             "Slow (ticket) burn pair: short window seconds.")
    d.define("slo.slow.burn.threshold", Type.DOUBLE, 1.0, M,
             "Slow pair firing threshold.")
    d.define("slo.reaction.p99.objective.s", Type.DOUBLE, 2.0, M,
             "SLO: controller reaction-latency p99 must stay at or under "
             "this many seconds.")
    d.define("slo.shed.ratio.objective", Type.DOUBLE, 0.05, M,
             "SLO: admission sheds / (sheds + admitted) per sampling period "
             "must stay at or under this fraction.")
    d.define("slo.degraded.ratio.objective", Type.DOUBLE, 0.05, M,
             "SLO: deadline-expired (degraded=true) optimizes per optimize "
             "must stay at or under this fraction.")
    d.define("slo.dispatch.budget", Type.DOUBLE, 10.0, M,
             "SLO: device dispatches of a warm controller tick must stay at "
             "or under this budget (the controller contract is "
             "len(goals)+3).")
    d.define("slo.recompile.objective", Type.DOUBLE, 0.0, M,
             "SLO: XLA compile events between samples in warm steady state "
             "(0 = the warm-path zero-recompile contract).")
    d.define("slo.replication.staleness.objective.ms", Type.DOUBLE, 5_000.0, M,
             "SLO: follower staleness ms (live delta-propagation proxy) "
             "must stay at or under this bound.")
    d.define("slo.detection.interval.ms", Type.LONG, 30_000, M,
             "SelfMetricAnomalyFinder cadence (each pass evaluates every "
             "SLO's burn rates).", in_range(lo=1))
    d.define("slo.selfheal.cooldown.ms", Type.LONG, 300_000, M,
             "Minimum gap between SloBurnAnomaly emissions while the same "
             "alert set keeps firing (a new slo/pair re-emits immediately).",
             in_range(lo=0))
    return d


def cruise_control_config() -> ConfigDef:
    """The merged registry (KafkaCruiseControlConfig)."""
    d = ConfigDef()
    for group in (
        monitor_config(),
        analyzer_config(),
        executor_config(),
        controller_config(),
        fleet_config(),
        admission_config(),
        anomaly_detector_config(),
        webserver_config(),
        replication_config(),
        selfmon_config(),
    ):
        d.merge(group)
    return d
