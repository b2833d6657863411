"""REST API: the full endpoint surface on the stdlib HTTP server.

Port of ``cruise_control_tpu/api/server.py``.  The handlers run on the
server's request threads and the user-task pool; every solve runs on the
facade's device, and LOAD / PARTITION_LOAD build their arrays there too and
bring the results to the host once (``.cpu()``) before the rows are read.

Counterpart of the servlet/vertx front-ends (``servlet/CruiseControlEndPoint.java:16-39``
lists the 22 endpoints; dispatch mirrors ``KafkaCruiseControlRequestHandler.doGetOrPost``):

GET  STATE LOAD PARTITION_LOAD PROPOSALS KAFKA_CLUSTER_STATE USER_TASKS
     REVIEW_BOARD PERMISSIONS BOOTSTRAP TRAIN TRACES METRICS
POST REBALANCE ADD_BROKER REMOVE_BROKER DEMOTE_BROKER FIX_OFFLINE_REPLICAS
     STOP_PROPOSAL_EXECUTION PAUSE_SAMPLING RESUME_SAMPLING TOPIC_CONFIGURATION
     RIGHTSIZE REMOVE_DISKS ADMIN REVIEW SIMULATE

SIMULATE (no reference counterpart) evaluates a batch of hypothetical clusters
— broker adds/removals/failures, rack loss, load and capacity scaling — with
one host sync (``sim/``); RIGHTSIZE runs the sweep-backed capacity planner.
METRICS serves the Prometheus text exposition of the whole telemetry plane
(``obs/exporter.py``); every request carries a correlation id (inbound
``X-Request-Id`` or generated) that links its user-task/optimize/execution
flight-recorder traces — walk them with GET /traces?parent_id=.

Long-running POSTs flow through the :class:`UserTaskManager` (202 + ``User-Task-ID``
until done), optionally parked in the :class:`Purgatory` when two-step verification
is on; authn/z via the pluggable :class:`SecurityProvider`.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlparse

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.api import admission as adm
from cruise_control_tpu_torch.api.admission import (
    AdmissionController,
    AdmissionRefused,
    CHEAP_ENDPOINTS,
    RequestContext,
    principal_of,
)
from cruise_control_tpu_torch.api.purgatory import Purgatory
from cruise_control_tpu_torch.api.security import (
    AuthenticationError,
    NoSecurityProvider,
    SecurityProvider,
)
from cruise_control_tpu_torch.api.usertasks import (
    TaskStatus,
    TooManyUserTasksError,
    UserTaskManager,
)
from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.detector import AnomalyType
from cruise_control_tpu_torch.facade import CruiseControl, OperationResult
from cruise_control_tpu_torch.model import arrays as A

API_PREFIX = "/kafkacruisecontrol/"

GET_ENDPOINTS = {
    "STATE", "LOAD", "PARTITION_LOAD", "PROPOSALS", "KAFKA_CLUSTER_STATE",
    "USER_TASKS", "REVIEW_BOARD", "PERMISSIONS", "BOOTSTRAP", "TRAIN",
    "TRACES", "METRICS", "HEALTHZ", "CONTROLLER", "WATCH", "FLEET", "SLO",
}
#: endpoints whose 200 body is plain text, not JSON (Prometheus exposition)
TEXT_ENDPOINTS = {"METRICS"}
POST_ENDPOINTS = {
    "REBALANCE", "ADD_BROKER", "REMOVE_BROKER", "DEMOTE_BROKER",
    "FIX_OFFLINE_REPLICAS", "STOP_PROPOSAL_EXECUTION", "PAUSE_SAMPLING",
    "RESUME_SAMPLING", "TOPIC_CONFIGURATION", "RIGHTSIZE", "REMOVE_DISKS",
    "ADMIN", "REVIEW", "SIMULATE", "CONTROLLER", "TRACES", "FLEET",
}
#: POSTs that change cluster state and thus go through two-step verification
#: (SIMULATE and TRACES are pure what-if evaluations — nothing to review;
#: CONTROLLER/FLEET pause/resume flips a control loop, never the cluster —
#: parking it in the purgatory would leave the loop unpausable during an
#: incident)
REVIEWABLE = POST_ENDPOINTS - {"REVIEW", "SIMULATE", "CONTROLLER", "TRACES", "FLEET"}
#: optimize-family endpoints: anything that would build a cluster model and
#: run the solver is refused with 503 + Retry-After until the process is
#: ready (journal recovery finished, monitor windows warm) — the k8s-probe
#: contract that keeps traffic off a replica that would only throw
#: NotEnoughValidSnapshotsError or race its own recovery
READINESS_GATED = {
    "REBALANCE", "ADD_BROKER", "REMOVE_BROKER", "DEMOTE_BROKER",
    "FIX_OFFLINE_REPLICAS", "TOPIC_CONFIGURATION", "RIGHTSIZE",
    "REMOVE_DISKS", "SIMULATE", "PROPOSALS", "TRACES",
}
#: REBALANCE-family endpoints that, with the backend circuit breaker OPEN,
#: degrade to the journaled standing proposal set (marked ``degraded=true``)
#: instead of queueing a solve behind a dead backend — the continuous-
#: reconfiguration posture (arxiv 1602.03770): keep answering from the warm
#: standing state while the world is on fire
BREAKER_DEGRADED = {
    "REBALANCE", "ADD_BROKER", "REMOVE_BROKER", "DEMOTE_BROKER",
    "FIX_OFFLINE_REPLICAS", "PROPOSALS",
}


class ReadinessState:
    STARTING = "starting"
    RECOVERING = "recovering"
    MONITOR_WARMING = "monitor_warming"
    READY = "ready"


class ReadinessController:
    """The startup readiness ladder: ``starting`` → ``recovering`` (journal
    replay + backend reconciliation) → ``monitor_warming`` (until the load
    monitor's completeness probe passes) → ``ready``.

    Liveness and readiness are distinct: ``GET /healthz`` always answers
    (liveness), its body — and the 503 gate on optimize-family endpoints —
    carry the readiness state.  The ``monitor_warming`` → ``ready`` edge is
    evaluated lazily on query via ``monitor_probe`` (no polling thread); the
    explicit phases are set by the app shell.  Every transition is appended
    to ``history`` so a post-hoc probe can verify the whole ladder ran."""

    def __init__(
        self,
        monitor_probe=None,
        start_ready: bool = False,
        retry_after_default_s: int = 5,
        warming_hint_s: Optional[float] = None,
    ) -> None:
        self.monitor_probe = monitor_probe
        self._lock = threading.Lock()
        self._phase = ReadinessState.READY if start_ready else ReadinessState.STARTING
        self.history: List[Tuple[str, float]] = [(self._phase, time.time())]
        #: recovery accounting surfaced by /healthz and STATE (set by the app)
        self.recovery: Dict[str, object] = {}
        #: Retry-After floor/fallback for not-ready 503s (retry.after.default.s)
        self.retry_after_default_s = max(int(retry_after_default_s), 1)
        #: expected seconds until the monitor can complete a window (the app
        #: shell passes the sampling interval) — the warming-rung estimate
        self.warming_hint_s = warming_hint_s
        self._export_gauge()

    def retry_after_s(self) -> int:
        """Retry-After for a not-ready 503, derived from where the ladder
        actually is instead of a hardcoded constant:

        * ``recovering`` — a replay that has already run *T* seconds is, to a
          first order, about half-way through (the doubling estimate), so the
          suggestion is ~*T* more, floored at the default and capped at 60 s
          so a pathological recovery can't tell clients to go away for hours.
        * ``monitor_warming`` — the monitor cannot become ready before its
          next sampling pass lands, so the suggestion is the sampling
          interval (``warming_hint_s``), capped at 300 s; default without a
          hint.
        * anything else (starting, or a race with ready) — the default."""
        with self._lock:
            phase = self._phase
            entered = self.history[-1][1] if self.history else time.time()
        if phase == ReadinessState.RECOVERING:
            elapsed = max(time.time() - entered, 0.0)
            return int(
                min(max(elapsed, self.retry_after_default_s), 60.0) + 0.999
            )
        if phase == ReadinessState.MONITOR_WARMING and self.warming_hint_s:
            return int(min(max(self.warming_hint_s, 1.0), 300.0) + 0.999)
        return self.retry_after_default_s

    def _export_gauge(self) -> None:
        from cruise_control_tpu_torch.core.sensors import READY_GAUGE, REGISTRY

        REGISTRY.gauge(READY_GAUGE).set(
            1.0 if self._phase == ReadinessState.READY else 0.0
        )

    def set_phase(self, phase: str) -> None:
        with self._lock:
            if phase != self._phase:
                self._phase = phase
                self.history.append((phase, time.time()))
        self._export_gauge()

    def current_phase(self, probe: bool = True) -> str:
        """The ladder state.  ``probe=True`` may evaluate the monitor probe
        (real backend metadata + aggregation work, warmup-only — once READY
        is stored it never runs again) to flip ``monitor_warming`` →
        ``ready``; ``probe=False`` never touches the backend — the LIVENESS
        path, which must answer even when the backend hangs (a liveness
        probe that blocks on a slow cluster gets the pod killed mid-warmup,
        the exact failure this controller exists to prevent)."""
        with self._lock:
            phase = self._phase
            fn = self.monitor_probe
        if probe and phase == ReadinessState.MONITOR_WARMING and fn is not None:
            ok = False
            try:
                ok = bool(fn())
            except Exception:
                ok = False
            if ok:
                self.set_phase(ReadinessState.READY)
                return ReadinessState.READY
        return phase

    @property
    def phase(self) -> str:
        return self.current_phase(probe=True)

    @property
    def is_ready(self) -> bool:
        return self.phase == ReadinessState.READY

    def snapshot(self, probe: bool = True) -> dict:
        phase = self.current_phase(probe=probe)
        return {
            "state": phase,
            "ready": phase == ReadinessState.READY,
            "history": [
                {"state": s, "ts": round(ts, 3)} for s, ts in self.history
            ],
            "recovery": dict(self.recovery),
        }


def _qbool(params: Dict[str, List[str]], name: str, default: bool) -> bool:
    v = params.get(name, [None])[0]
    if v is None:
        return default
    return v.lower() in ("true", "1", "yes")


def _qint_list(params: Dict[str, List[str]], name: str) -> List[int]:
    v = params.get(name, [None])[0]
    return [int(x) for x in v.split(",")] if v else []


def _goal_ids(params: Dict[str, List[str]]) -> Optional[List[int]]:
    v = params.get("goals", [None])[0]
    if not v:
        return None
    out = []
    for name in v.split(","):
        if name not in G.GOAL_ID_BY_NAME:
            raise ValueError(f"unknown goal {name!r}")
        out.append(G.GOAL_ID_BY_NAME[name])
    return out


def _op_result_json(op: OperationResult) -> dict:
    r = op.optimizer_result
    return {
        "dryrun": op.dryrun,
        # deadline-expired solve: the placement is the best-so-far state, not
        # the full goal walk (optimize.deadline.ms)
        "degraded": r.degraded,
        "proposals": [
            {
                "topic": p.tp[0],
                "partition": p.tp[1],
                "oldLeader": p.old_leader,
                "oldReplicas": list(p.old_replicas),
                "newReplicas": list(p.new_replicas),
            }
            for p in r.proposals[:1000]
        ],
        "numProposals": len(r.proposals),
        "violationsBefore": r.violations_before,
        "violationsAfter": r.violations_after,
        "violatedHardGoals": r.violated_hard_goals,
        "provisionStatus": r.provision.status if r.provision else None,
        "balancedness": r.balancedness_score if r.goal_reports else None,
        "goalSummary": [
            {
                "goal": g.name,
                "hard": g.is_hard,
                "violationsBefore": g.violations_before,
                "violationsAfter": g.violations_after,
                "moves": g.moves_applied,
                "durationS": round(g.duration_s, 3),
            }
            for g in r.goal_reports
        ],
        "execution": (
            None
            if op.execution is None
            else {
                "completed": op.execution.completed,
                "dead": op.execution.dead,
                "aborted": op.execution.aborted,
                "failed": op.execution.failed,
                "stopped": op.execution.stopped,
                "error": op.execution.error,
                "durationS": round(op.execution.duration_s, 3),
            }
        ),
    }


class CruiseControlApp:
    """Wires facade + detector manager + provisioner + API state (the
    ``KafkaCruiseControlApp``/``AsyncKafkaCruiseControl`` role)."""

    def __init__(
        self,
        cruise_control: CruiseControl,
        anomaly_manager=None,
        provisioner=None,
        security: Optional[SecurityProvider] = None,
        two_step_verification: bool = False,
        proposal_cache_ttl_s: float = 900.0,   # proposal.expiration.ms default
        readiness: Optional[ReadinessController] = None,
        user_task_journal=None,
        controller=None,
        fleet=None,
        admission: Optional[AdmissionController] = None,
        breaker=None,
        max_active_user_tasks: int = 25,
        replication=None,
        replication_opts: Optional[dict] = None,
        selfmon=None,
        slo_engine=None,
    ) -> None:
        self.cc = cruise_control
        self.anomaly_manager = anomaly_manager
        self.provisioner = provisioner
        #: the continuous control loop (controller/loop.py), None unless
        #: controller.enable — serves the CONTROLLER endpoint + STATE block
        self.controller = controller
        #: the multi-tenant fleet controller (fleet/controller.py), None
        #: unless fleet.enable — serves the FLEET endpoint + STATE block
        self.fleet = fleet
        #: the self-monitoring sampler (obs/selfmon.py) and SLO burn-rate
        #: engine (obs/slo.py), None unless selfmon.enable — serve the SLO
        #: endpoint, the STATE SelfMonitor block, and METRICS ?window=
        self.selfmon = selfmon
        self.slo_engine = slo_engine
        self.security = security or NoSecurityProvider()
        self.two_step = two_step_verification
        # embedded/test construction defaults to always-ready; the app shell
        # passes its real readiness ladder
        self.readiness = readiness or ReadinessController(start_ready=True)
        #: admission controller (api/admission.py): every authenticated
        #: request passes it; permissive defaults when not configured
        self.admission = admission or AdmissionController()
        #: shared backend circuit breaker (backend/breaker.py), None = no
        #: breaker on this seam (embedded/test construction)
        self.breaker = breaker
        #: replicated standing-set view (replication/state.py): present on
        #: followers (fed by the WAL tailer) and on writers with the
        #: controller journal listener wired; None in embedded/test
        #: construction — WATCH then 404s and reads go unstamped
        self.replication = replication
        opts = dict(replication_opts or {})
        self.replication_lag_bound_ms = int(opts.get("lag.bound.ms", 5_000))
        self.replication_degraded_after_ms = int(
            opts.get("degraded.after.ms", 10_000)
        )
        self.replication_watch_max_wait_ms = int(
            opts.get("watch.max.wait.ms", 30_000)
        )
        #: follower processes serve reads only — every POST is refused with
        #: a pointer at the writer (split-brain guard: even a confused
        #: client cannot make a follower mutate anything)
        self.read_only = replication is not None and not replication.writer
        self.user_tasks = UserTaskManager(
            journal=user_task_journal, max_active_tasks=max_active_user_tasks
        )
        self.purgatory = Purgatory()
        self.proposal_cache_ttl_s = proposal_cache_ttl_s
        self._proposal_cache: Optional[Tuple[float, dict]] = None
        self._lock = threading.Lock()
        self._refresher_stop: Optional[threading.Event] = None

    # -- proposal precompute (GoalOptimizer.java:153 run()/ProposalCandidateComputer) --

    def start_proposal_refresher(self, interval_s: float = 30.0) -> None:
        """Background thread keeping the cached proposals fresh so GET /proposals
        answers instantly (the reference's precompute scheduler wakes every 30 s,
        GoalOptimizer.java:67,153)."""
        if self._refresher_stop is not None:
            return
        stop = threading.Event()
        self._refresher_stop = stop

        def loop() -> None:
            while not stop.wait(interval_s):
                with self._lock:
                    cached = self._proposal_cache
                if (
                    cached is not None
                    and time.monotonic() - cached[0] < self.proposal_cache_ttl_s / 2
                ):
                    continue
                try:
                    op = self.cc.rebalance(dryrun=True)
                except Exception:
                    continue   # monitor not ready yet — retry next tick
                body = _op_result_json(op)
                # a stop() issued while the rebalance ran invalidates the write
                # (a superseding refresher may already be computing fresher data)
                if stop.is_set():
                    return
                with self._lock:
                    self._proposal_cache = (time.monotonic(), body)

        threading.Thread(target=loop, daemon=True, name="proposal-refresher").start()

    def stop_proposal_refresher(self) -> None:
        if self._refresher_stop is not None:
            self._refresher_stop.set()
            self._refresher_stop = None

    # -- GET handlers --------------------------------------------------------

    def get_state(self, params) -> Tuple[int, dict]:
        from cruise_control_tpu_torch.core.sensors import REGISTRY
        from cruise_control_tpu_torch.obs.profiler import PROFILER

        body = self.cc.state()
        if self.anomaly_manager is not None:
            body["AnomalyDetectorState"] = dataclasses.asdict(self.anomaly_manager.state())
        # sensor families (Sensors.md): timers/gauges/counters per subsystem
        body["Sensors"] = REGISTRY.snapshot()
        # device-cost surface (obs/profiler.py): per-executable FLOPs/bytes,
        # call counts, attributed compiles, memory watermark
        body["Profiler"] = PROFILER.snapshot()
        # readiness ladder + recovery accounting (journal replay, wall)
        body["Readiness"] = self.readiness.snapshot()
        # overload plane: admission accounting + breaker state machine
        body["Admission"] = self.admission.snapshot()
        if self.breaker is not None:
            body["Breaker"] = self.breaker.snapshot()
        # continuous control loop: drift, standing set, reaction latency
        if self.controller is not None:
            body["Controller"] = self.controller.status()
        if self.fleet is not None:
            body["Fleet"] = self.fleet.status()
        # self-monitoring plane: sampler cadence/spool accounting + the SLO
        # engine's firing summary (full per-spec detail lives on GET /SLO)
        if self.selfmon is not None:
            block = self.selfmon.status()
            if self.slo_engine is not None:
                s = self.slo_engine.status()
                block["slo"] = {
                    "evaluations": s["evaluations"],
                    "firing": s["firing"],
                }
            body["SelfMonitor"] = block
        return 200, body

    def get_healthz(self, params) -> Tuple[int, dict]:
        """Liveness + readiness probe.  Always 200 when the process answers
        (liveness); ``?readiness=true`` makes it a k8s readinessProbe — 503
        until the startup ladder (recovering → monitor_warming → ready) is
        done, so traffic stays off a replica mid-recovery.

        Liveness mode never runs the monitor probe (``probe=False``): it must
        answer from process state alone even when the backend is hung, or the
        kubelet would kill a pod for its cluster's slowness.  Readiness mode
        probes — that's what flips ``monitor_warming`` → ``ready``."""
        readiness_mode = _qbool(params, "readiness", False)
        snap = self.readiness.snapshot(probe=readiness_mode)
        body = {"status": "alive", **snap}
        if readiness_mode and not snap["ready"]:
            return 503, body
        return 200, body

    def get_load(self, params) -> Tuple[int, dict]:
        model = self.cc.cluster_model()
        state, maps = model.to_arrays(device=self.cc.device)
        um = A.utilization_matrix(state).cpu().numpy()     # [8, B]
        alive = state.broker_alive.cpu().numpy()
        host = state.broker_host.cpu().numpy()
        rows = []
        for i, broker_id in enumerate(maps.broker_ids):
            rows.append(
                {
                    "Broker": broker_id,
                    "Host": maps.host_names[int(host[i])],
                    "DiskMB": float(um[0, i]),
                    "CpuPct": float(um[1, i]),
                    "LeaderNwInRate": float(um[2, i]),
                    "FollowerNwInRate": float(um[3, i]),
                    "NwOutRate": float(um[4, i]),
                    "PnwOutRate": float(um[5, i]),
                    "Leaders": int(um[6, i]),
                    "Replicas": int(um[7, i]),
                    "Alive": bool(alive[i]),
                }
            )
        return 200, {"brokers": rows}

    def get_partition_load(self, params) -> Tuple[int, dict]:
        res_name = params.get("resource", ["DISK"])[0].upper()
        res = Resource[res_name] if res_name in Resource.__members__ else Resource.DISK
        limit = int(params.get("entries", ["100"])[0])
        model = self.cc.cluster_model()
        state, maps = model.to_arrays(device=self.cc.device)
        eff = A.effective_load(state).cpu().numpy()
        lead = A.is_leader(state).cpu().numpy()
        rp = state.replica_partition.cpu().numpy()
        rows = []
        for p_idx, tp in enumerate(maps.partitions):
            mask = rp == p_idx
            rows.append(
                {
                    "topic": tp[0],
                    "partition": tp[1],
                    "leader": model.leader_of(tp),
                    "followers": [b for b, is_l in model.replicas_of(tp) if not is_l],
                    "cpu": float(eff[mask & lead, Resource.CPU].sum()),
                    "networkInbound": float(eff[mask & lead, Resource.NW_IN].sum()),
                    "networkOutbound": float(eff[mask & lead, Resource.NW_OUT].sum()),
                    "disk": float(eff[mask & lead, Resource.DISK].sum()),
                    "_sort": float(eff[mask & lead, res].sum()),
                }
            )
        rows.sort(key=lambda r: -r["_sort"])
        for r in rows:
            del r["_sort"]
        return 200, {"records": rows[:limit]}

    def get_proposals(self, params) -> Tuple[int, dict]:
        goal_ids = _goal_ids(params)
        # the cache (and the background refresher feeding it) holds DEFAULT-goal
        # proposals only; a custom goal list must bypass it — the reference
        # likewise ignores the cached result for non-default goals
        ignore_cache = _qbool(params, "ignore_proposal_cache", False) or goal_ids is not None
        with self._lock:
            cached = self._proposal_cache
            if (
                not ignore_cache
                and cached is not None
                and time.monotonic() - cached[0] < self.proposal_cache_ttl_s
            ):
                return 200, {**cached[1], "cached": True}
        op = self.cc.rebalance(dryrun=True, goal_ids=goal_ids)
        body = _op_result_json(op)
        if goal_ids is None:
            with self._lock:
                self._proposal_cache = (time.monotonic(), body)
        return 200, {**body, "cached": False}

    def get_kafka_cluster_state(self, params) -> Tuple[int, dict]:
        desc = self.cc.backend.describe_cluster()
        topics = self.cc.backend.describe_topics()
        return 200, {
            "brokers": [
                {"id": b, "rack": i.rack, "host": i.host, "alive": i.alive}
                for b, i in sorted(desc.brokers.items())
            ],
            "topics": {
                t: [
                    {
                        "partition": i.tp[1],
                        "leader": i.leader,
                        "replicas": list(i.replicas),
                        "isr": list(i.isr),
                    }
                    for i in infos
                ]
                for t, infos in sorted(topics.items())
            },
        }

    def get_user_tasks(self, params) -> Tuple[int, dict]:
        return 200, {"userTasks": [t.to_dict() for t in self.user_tasks.all_tasks()]}

    def get_review_board(self, params) -> Tuple[int, dict]:
        return 200, {"requestInfo": [r.to_dict() for r in self.purgatory.board()]}

    def get_permissions(self, params, role=None) -> Tuple[int, dict]:
        return 200, {"role": role.name if role is not None else "ADMIN"}

    def get_bootstrap(self, params) -> Tuple[int, dict]:
        start = int(params.get("start", ["0"])[0])
        end = int(params.get("end", [str(int(time.time() * 1000))])[0])
        n = self.cc.monitor.bootstrap(start, end)
        return 200, {"samplesLoaded": n, "from": start, "to": end}

    def get_traces(self, params) -> Tuple[int, dict]:
        """Flight-recorder ring: newest-first solver/executor/detector traces
        (``obs/recorder.py``) — the decision record behind every number the
        STATE sensors aggregate.  ``parent_id`` filters by the request
        correlation id (``X-Request-Id``): one id walks request → user task →
        optimize → execution; ``trace_id`` pins a single record."""
        from cruise_control_tpu_torch.obs import RECORDER

        kind = params.get("kind", [None])[0]
        trace_id = params.get("trace_id", [None])[0]
        parent_id = params.get("parent_id", [None])[0]
        limit = int(params.get("limit", ["50"])[0])
        return 200, {
            "traces": [
                t.to_dict()
                for t in RECORDER.recent(
                    limit, kind=kind, trace_id=trace_id, parent_id=parent_id
                )
            ],
            "recorder": RECORDER.snapshot(),
        }

    def get_metrics(self, params) -> Tuple[int, str]:
        """Prometheus text exposition of the whole telemetry plane
        (``obs/exporter.py``): every sensor family, flight-recorder and gate
        summaries, per-executable device cost, device memory, SLO burn
        state.  Plain text — the one endpoint a ``scrape_configs`` stanza
        points at.  ``window=N`` additionally renders the self-monitoring
        plane's last N windowed means per series
        (``cruise_control_tpu_selfmon_window_value``)."""
        from cruise_control_tpu_torch.obs.exporter import render_prometheus

        window = params.get("window", [None])[0]
        selfmon_window = None
        if window is not None:
            try:
                selfmon_window = int(window)
                if selfmon_window < 0:
                    raise ValueError
            except ValueError:
                selfmon_window = None
        return 200, render_prometheus(
            selfmon=self.selfmon, selfmon_window=selfmon_window
        )

    def get_controller(self, params) -> Tuple[int, dict]:
        """Continuous-controller status: drift, staleness, the standing
        proposal set's version/size, reaction-latency p50/p95.  Answers
        ``{"enabled": false}`` when the loop is not configured
        (``controller.enable``)."""
        if self.controller is None:
            return 200, {"enabled": False}
        return 200, {"enabled": True, **self.controller.status()}

    def get_fleet(self, params) -> Tuple[int, dict]:
        """Fleet-controller status: coordinator state, last-tick batching
        census (tenants per dispatch, goal-order groups), and one
        per-tenant status block.  ``tenant=<name>`` narrows the answer to
        that tenant's block.  Answers ``{"enabled": false}`` when no fleet
        is configured (``fleet.enable``)."""
        if self.fleet is None:
            return 200, {"enabled": False}
        body = {"enabled": True, **self.fleet.status()}
        tenant = params.get("tenant", [None])[0]
        if tenant is not None:
            block = body["tenants"].get(tenant)
            if block is None:
                return 404, {
                    "error": f"unknown tenant {tenant!r}",
                    "tenants": sorted(body["tenants"]),
                }
            return 200, {"enabled": True, "tenant": tenant, **block}
        return 200, body

    def get_slo(self, params) -> Tuple[int, dict]:
        """SLO burn-rate engine status (``obs/slo.py``): every declared SLO
        with its objective, latest value, and per-window-pair burn rates +
        alert state; plus the sampler's own accounting.  ``slo=<name>``
        narrows to one spec's block.  Answers ``{"enabled": false}`` when
        the self-monitoring plane is not configured (``selfmon.enable``)."""
        if self.slo_engine is None:
            return 200, {"enabled": False}
        body = {"enabled": True, **self.slo_engine.status()}
        if self.selfmon is not None:
            body["selfmon"] = self.selfmon.status()
        name = params.get("slo", [None])[0]
        if name is not None:
            block = next(
                (s for s in body["specs"] if s.get("name") == name), None
            )
            if block is None:
                return 404, {
                    "error": f"unknown slo {name!r}",
                    "slos": sorted(s.get("name") for s in body["specs"]),
                }
            return 200, {
                "enabled": True,
                "slo": name,
                **block,
                "alerts": [
                    a for a in body["alerts"] if a.get("slo") == name
                ],
            }
        return 200, body

    def get_watch(self, params) -> Tuple[int, dict]:
        """Long-poll watch over the standing proposal set: standing-set
        deltas (published/superseded/drained, keyed by version) since the
        client's cursor, instead of the USER_TASKS polling loop.

        ``since`` — last delta seq the client has seen (0 = from the start
        of the ring); ``timeout_ms`` — how long to park when no delta is
        pending (capped by replication.watch.max.wait.ms; 0 = answer
        immediately).  A cursor that fell off the bounded ring gets
        ``resync=true`` + a snapshot delta of the current set — slow
        watchers converge, they don't error."""
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            REPLICATION_WATCHERS_GAUGE,
        )
        from cruise_control_tpu_torch.obs import recorder as obs

        if self.replication is None:
            return 404, {"error": "replication is not enabled on this process"}
        try:
            since = int(params.get("since", ["0"])[0])
            timeout_ms = int(params.get("timeout_ms", ["0"])[0])
            if since < 0 or timeout_ms < 0:
                raise ValueError
        except ValueError:
            return 400, {
                "error": "since and timeout_ms must be non-negative integers"
            }
        timeout_ms = min(timeout_ms, self.replication_watch_max_wait_ms)
        token = obs.start_trace("watch")
        gauge = REGISTRY.gauge(REPLICATION_WATCHERS_GAUGE)
        gauge.set(gauge.value + 1)
        try:
            deltas, next_since, resync = self.replication.watch(
                since, timeout_ms / 1000.0
            )
        finally:
            gauge.set(max(0.0, gauge.value - 1))
            obs.finish_trace(
                token,
                attrs={"since": since, "timeout_ms": timeout_ms},
            )
        return 200, {
            "deltas": deltas,
            "since": next_since,
            "resync": resync,
            "replication": self.replication.stamp(
                self.replication_degraded_after_ms
            ),
        }

    def get_train(self, params) -> Tuple[int, dict]:
        start = int(params.get("start", ["0"])[0])
        end = int(params.get("end", [str(int(time.time() * 1000))])[0])
        ok = self.cc.train_cpu_model(start, end)
        return 200, {"trained": ok}

    # -- POST handlers -------------------------------------------------------

    def _async_op(
        self, endpoint: str, params, work, to_json=_op_result_json
    ) -> Tuple[int, dict, Dict[str, str]]:
        from cruise_control_tpu_torch.obs import recorder as obs

        key = (endpoint, tuple(sorted((k, tuple(v)) for k, v in params.items())))
        # admission (api/admission.py): a dedupe hit rides its existing task
        # and consumes NO quota or queue capacity (re-POST is the reference's
        # poll idiom); a miss acquires an execution slot, waiting in the
        # bounded priority queue when all slots are busy — bounded by the
        # queue timeout AND the request's own deadline_ms budget, so an
        # over-deadline request sheds here, before it ever reaches the solver
        ticket = None
        if self.user_tasks.peek(key) is None:
            ctx = adm.current_request_context()
            ticket = self.admission.acquire(
                ctx.principal if ctx else adm.ANONYMOUS_PRINCIPAL,
                endpoint,
                role=ctx.role if ctx else None,
                anonymous=ctx.anonymous if ctx else True,
                deadline_s=ctx.remaining_s() if ctx else None,
            )
        else:
            self.admission.note_dedupe_hit()
        # the request id in scope (handle() opened it) rides into the task so
        # the pool thread's traces correlate; a deduped resubmission keeps the
        # first request's id — the task is one operation, whoever polls it.
        # The formatter goes in WITH the work (not assigned afterwards): the
        # journal embeds the serialized result in the completion record, and
        # a fast task can finish before this function's next statement.  The
        # ticket's release is owned by get_or_create from here on (dedupe
        # race, refused creation, completion).
        task = self.user_tasks.get_or_create(
            endpoint, key, work, parent_id=obs.current_parent_id(),
            result_to_json=to_json, admission_ticket=ticket,
        )
        headers = {"User-Task-ID": task.task_id}
        if task.status in (TaskStatus.COMPLETED, TaskStatus.COMPLETED_WITH_ERROR):
            try:
                result = task.future.result(timeout=0)
                return 200, to_json(result), headers
            except (AdmissionRefused, TooManyUserTasksError):
                raise   # shed inside the work: surfaces as 429, never a 500
            except Exception as e:
                return 500, {"error": str(e), "progress": task.progress.to_list()}, headers
        # wait briefly so fast operations answer synchronously (reference's
        # session wait inside getOrCreateUserTask)
        try:
            result = task.future.result(timeout=1.0)
            return 200, to_json(result), headers
        except (AdmissionRefused, TooManyUserTasksError):
            raise
        except Exception:
            pass
        return 202, {"progress": task.progress.to_list(), "userTaskId": task.task_id}, headers

    def post_rebalance(self, params):
        dryrun = _qbool(params, "dryrun", True)
        goal_ids = _goal_ids(params)
        excluded = params.get("excluded_topics", [None])[0]
        excluded_topics = excluded.split(",") if excluded else ()
        # the client budget (deadline_ms) follows the request into the solver:
        # whatever the admission queue didn't spend becomes this request's
        # optimize.deadline.ms, so a tight-budget solve returns best-so-far
        # degraded=true instead of overrunning
        ctx = adm.current_request_context()

        def work(progress):
            progress.add_step("WaitingForClusterModel")
            progress.add_step("OptimizationForGoals")
            deadline_s = ctx.remaining_s() if ctx is not None else None
            if deadline_s is not None and deadline_s <= 0:
                # accounted shed (counters + trace), same as every other path
                self.admission.shed_deadline(
                    ctx.principal, "REBALANCE",
                    "REBALANCE: client budget exhausted before the solve",
                )
            return self.cc.rebalance(
                dryrun=dryrun, goal_ids=goal_ids,
                excluded_topics=excluded_topics, deadline_s=deadline_s,
            )

        return self._async_op("REBALANCE", params, work)

    def post_add_broker(self, params):
        ids = _qint_list(params, "brokerid")
        dryrun = _qbool(params, "dryrun", True)
        return self._async_op(
            "ADD_BROKER", params, lambda p: self.cc.add_brokers(ids, dryrun=dryrun)
        )

    def post_remove_broker(self, params):
        ids = _qint_list(params, "brokerid")
        dryrun = _qbool(params, "dryrun", True)
        return self._async_op(
            "REMOVE_BROKER", params, lambda p: self.cc.remove_brokers(ids, dryrun=dryrun)
        )

    def post_demote_broker(self, params):
        ids = _qint_list(params, "brokerid")
        dryrun = _qbool(params, "dryrun", True)
        return self._async_op(
            "DEMOTE_BROKER", params, lambda p: self.cc.demote_brokers(ids, dryrun=dryrun)
        )

    def post_fix_offline_replicas(self, params):
        dryrun = _qbool(params, "dryrun", True)
        return self._async_op(
            "FIX_OFFLINE_REPLICAS", params, lambda p: self.cc.fix_offline_replicas(dryrun=dryrun)
        )

    def post_topic_configuration(self, params):
        pattern = params.get("topic", [".*"])[0]
        rf = int(params.get("replication_factor", ["3"])[0])
        dryrun = _qbool(params, "dryrun", True)
        return self._async_op(
            "TOPIC_CONFIGURATION",
            params,
            lambda p: self.cc.update_topic_replication_factor(pattern, rf, dryrun=dryrun),
        )

    def post_stop_proposal_execution(self, params):
        self.cc.stop_execution()
        return 200, {"message": "Proposal execution stopped."}, {}

    def post_pause_sampling(self, params):
        reason = params.get("reason", ["No reason provided"])[0]
        self.cc.pause_sampling(reason)
        return 200, {"message": f"Sampling paused: {reason}"}, {}

    def post_resume_sampling(self, params):
        reason = params.get("reason", ["No reason provided"])[0]
        self.cc.resume_sampling(reason)
        return 200, {"message": f"Sampling resumed: {reason}"}, {}

    def post_simulate(self, params):
        """SIMULATE: batched what-if evaluation (sim/ — no reference analogue).

        ``scenarios`` carries a JSON list of scenario specs
        (``sim.scenario.Scenario.from_dict``); without it, the shorthand
        parameters build a capacity cross-product sweep:
        ``add_broker_counts`` × ``load_factors``, each scenario also applying
        ``remove_brokerid``/``kill_brokerid``/``drop_rack``.  ``deep=true``
        runs the full optimizer per scenario instead of the single-dispatch
        as-is evaluation."""
        from cruise_control_tpu_torch.sim.scenario import Scenario

        deep = _qbool(params, "deep", False)
        goal_ids = _goal_ids(params)
        raw = params.get("scenarios", [None])[0]
        if raw:
            specs = json.loads(raw)
            if not isinstance(specs, list):
                raise ValueError("scenarios must be a JSON list")
            scenarios = [Scenario.from_dict(d) for d in specs]
        else:
            adds = _qint_list(params, "add_broker_counts") or [0]
            lf_raw = params.get("load_factors", [None])[0]
            factors = [float(x) for x in lf_raw.split(",")] if lf_raw else [1.0]
            removes = tuple(_qint_list(params, "remove_brokerid"))
            kills = tuple(_qint_list(params, "kill_brokerid"))
            drop_rack = params.get("drop_rack", [None])[0]
            scenarios = [
                Scenario(
                    name=f"add={a},load={f:g}",
                    add_brokers=a,
                    remove_brokers=removes,
                    kill_brokers=kills,
                    drop_rack=None if drop_rack is None else int(drop_rack),
                    load_factor=f,
                )
                for f in factors
                for a in adds
            ]

        def work(progress):
            progress.add_step("WaitingForClusterModel")
            progress.add_step("ScenarioSweep")
            return self.cc.simulate(scenarios, deep=deep, goal_ids=goal_ids)

        return self._async_op(
            "SIMULATE", params, work, to_json=lambda r: r.to_dict()
        )

    def post_traces(self, params):
        """POST TRACES: batched autoscaling-policy rollouts (traces/ — no
        reference analogue).

        ``traces`` carries a JSON list of :class:`~cruise_control_tpu_torch.traces
        .trace.LoadTrace` specs and ``policies`` a JSON list of
        :class:`~cruise_control_tpu_torch.traces.policy.AutoscalePolicy` specs; the
        (trace × policy) cross product is stepped through time with one
        host sync, returning per-pair SLO-violation steps,
        broker-hours, scale actions, drawdown — and per-trace winners."""
        from cruise_control_tpu_torch.traces.policy import policies_from_wire
        from cruise_control_tpu_torch.traces.trace import traces_from_wire

        goal_ids = _goal_ids(params)
        raw_traces = params.get("traces", [None])[0]
        if not raw_traces:
            raise ValueError("POST TRACES requires a traces JSON list")
        traces = traces_from_wire(json.loads(raw_traces))
        raw_pols = params.get("policies", [None])[0]
        if not raw_pols:
            raise ValueError("POST TRACES requires a policies JSON list")
        policies = policies_from_wire(json.loads(raw_pols))

        def work(progress):
            progress.add_step("WaitingForClusterModel")
            progress.add_step("TraceRollout")
            return self.cc.trace_rollout(traces, policies, goal_ids=goal_ids)

        return self._async_op(
            "TRACES", params, work, to_json=lambda r: r.to_dict()
        )

    def post_rightsize(self, params):
        """RIGHTSIZE: run the batched capacity planner and hand its
        sweep-backed recommendation to the provisioner — the verdict carries
        measured numbers (sim/planner.py), not the reference's placeholder.
        A ``trace`` JSON spec adds a planning horizon: the trace evaluated at
        the current broker count, with peak min-brokers-needed over the
        horizon (capacity pre-positioned before the predicted peak)."""
        if self.provisioner is None:
            return 400, {"error": "no provisioner configured"}, {}
        load_factor = float(params.get("load_factor", ["1.0"])[0])
        extra = params.get("broker_number", [None])[0]
        raw_trace = params.get("trace", [None])[0]
        horizon_trace = None
        if raw_trace:
            from cruise_control_tpu_torch.traces.trace import LoadTrace

            horizon_trace = LoadTrace.from_dict(json.loads(raw_trace))

        def work(progress):
            progress.add_step("CapacitySweep")
            plan = self.cc.plan_capacity(
                load_factor=load_factor,
                max_extra_brokers=int(extra) if extra else None,
            )
            result = self.provisioner.rightsize(plan.recommendation)
            out = {
                "state": result.state.value,
                "summary": result.summary,
                "plan": plan.to_dict(),
            }
            if horizon_trace is not None:
                progress.add_step("TraceHorizon")
                out["horizon"] = self.cc.trace_horizon(horizon_trace)
            return out

        return self._async_op("RIGHTSIZE", params, work, to_json=lambda r: r)

    def post_remove_disks(self, params):
        spec = params.get("brokerid_and_logdirs", [""])[0]
        pairs = []
        for part in spec.split(","):
            if "-" in part:
                b, logdir = part.split("-", 1)
                pairs.append((int(b), logdir))
        dryrun = _qbool(params, "dryrun", True)

        def work(progress):
            return self.cc.remove_disks(pairs, dryrun=dryrun)

        return self._async_op("REMOVE_DISKS", params, work)

    def post_controller(self, params):
        """Operator switch on the control loop: ``action=pause`` /
        ``resume`` (with optional ``reason``) or ``tick`` (force one
        synchronous control-loop evaluation — ops escape hatch when waiting
        for drift/cadence is the wrong answer)."""
        if self.controller is None:
            return 400, {"error": "no controller configured (controller.enable)"}, {}
        action = params.get("action", [None])[0]
        reason = params.get("reason", ["operator request"])[0]
        if action == "pause":
            self.controller.pause(reason)
        elif action == "resume":
            self.controller.resume(reason)
        elif action == "tick":
            self.controller.maybe_tick(force=True)
        else:
            return 400, {"error": f"action must be pause|resume|tick, got {action!r}"}, {}
        return 200, {"enabled": True, "action": action, **self.controller.status()}, {}

    def post_fleet(self, params):
        """Operator switch on the fleet: ``action=pause`` / ``resume`` (the
        whole fleet, or one tenant via ``tenant=<name>``, with optional
        ``reason``) or ``tick`` (force one synchronous fleet evaluation;
        with ``tenant`` only that tenant's lane is forced — the others
        still ride the batched dispatch and trigger on their own drift)."""
        if self.fleet is None:
            return 400, {"error": "no fleet configured (fleet.enable)"}, {}
        action = params.get("action", [None])[0]
        reason = params.get("reason", ["operator request"])[0]
        tenant = params.get("tenant", [None])[0]
        if tenant is not None and tenant not in self.fleet.tenant_names:
            return 404, {
                "error": f"unknown tenant {tenant!r}",
                "tenants": sorted(self.fleet.tenant_names),
            }, {}
        if action == "pause":
            self.fleet.pause(reason, tenant=tenant)
        elif action == "resume":
            self.fleet.resume(reason, tenant=tenant)
        elif action == "tick":
            self.fleet.maybe_tick(force=True, tenant=tenant)
        else:
            return 400, {"error": f"action must be pause|resume|tick, got {action!r}"}, {}
        return 200, {"enabled": True, "action": action, **self.fleet.status()}, {}

    def post_admin(self, params):
        changed = {}
        for action, enabled in (
            ("enable_self_healing_for", True),
            ("disable_self_healing_for", False),
        ):
            v = params.get(action, [None])[0]
            if v and self.anomaly_manager is not None:
                for name in v.split(","):
                    t = AnomalyType[name.upper()]
                    self.anomaly_manager.notifier.set_self_healing(t, enabled)
                    changed[name] = enabled
        conc = params.get("concurrent_partition_movements_per_broker", [None])[0]
        if conc:
            self.cc.executor.concurrency.set_per_broker_cap(None, int(conc))
            changed["perBrokerConcurrency"] = int(conc)
        return 200, {"updated": changed}, {}

    def post_review(self, params):
        approve = _qint_list(params, "approve")
        discard = _qint_list(params, "discard")
        reason = params.get("reason", [""])[0]
        infos = self.purgatory.review(approve, discard, reason)
        return 200, {"reviewed": [i.to_dict() for i in infos]}, {}

    # -- dispatch ------------------------------------------------------------

    def handle(
        self, method: str, endpoint: str, params: Dict[str, List[str]], headers
    ) -> Tuple[int, Union[dict, str], Dict[str, str]]:
        """Authenticate, authorize, dispatch.  Every request runs inside a
        correlation scope: the inbound ``X-Request-Id`` (or a generated one)
        becomes the ``parent_id`` of every flight-recorder trace the request
        causes — synchronously in this thread, or via the user-task pool and
        the executor thread — and is echoed back as a response header."""
        from cruise_control_tpu_torch.obs import recorder as obs

        # liveness/readiness probes run unauthenticated (k8s probes carry no
        # credentials) and expose only the readiness ladder, never cluster data
        if method == "GET" and endpoint == "HEALTHZ":
            status, body = self.get_healthz(params)
            headers_out = {} if status != 503 else {
                # derived from recovery/warming progress, not a constant — a
                # probe told "5" during a 10-minute replay just burns probes
                "Retry-After": str(self.readiness.retry_after_s())
            }
            return status, body, headers_out

        try:
            user, role = self.security.authenticate(headers)
        except AuthenticationError as e:
            challenge = getattr(self.security, "challenge_header", None)
            return 401, {"error": str(e)}, dict([challenge] if challenge else [])
        if not self.security.authorize(role, endpoint, method):
            return 403, {"error": f"role {role.name} may not {method} {endpoint}"}, {}

        # request context for the admission layer: principal (security.py
        # user; anonymous under NoSecurityProvider), tier role, and the
        # client budget (deadline_ms) that bounds queue wait AND becomes the
        # per-request optimize deadline.  A malformed budget is a 400 HTTP
        # answer, never an unhandled exception — the socket must always
        # carry a response (the same contract the deep listen backlog keeps)
        deadline_ms = params.get("deadline_ms", [None])[0]
        deadline_mono = None
        if deadline_ms:
            try:
                budget_ms = int(deadline_ms)
                if budget_ms <= 0:
                    raise ValueError(deadline_ms)
            except ValueError:
                return (
                    400,
                    {"error": f"deadline_ms must be a positive integer, "
                              f"got {deadline_ms!r}"},
                    {},
                )
            deadline_mono = time.monotonic() + budget_ms / 1000.0
        ctx = RequestContext(
            principal=principal_of(user),
            role=role,
            anonymous=user is None,
            deadline_mono=deadline_mono,
        )
        request_id = headers.get("X-Request-Id") or f"req-{uuid.uuid4().hex[:16]}"
        ctx_token = adm.set_request_context(ctx)
        try:
            with obs.parent_scope(request_id):
                status, body, out_headers = self._dispatch_authorized(
                    method, endpoint, params, user, role
                )
        finally:
            adm.reset_request_context(ctx_token)
        out_headers = dict(out_headers)
        out_headers.setdefault("X-Request-Id", request_id)
        return status, body, out_headers

    def _retry_after_header(self, seconds: float) -> Dict[str, str]:
        return {"Retry-After": str(max(int(seconds + 0.999), 1))}

    def _degraded_standing(self, endpoint: str) -> Tuple[int, dict, Dict[str, str]]:
        """Breaker-open answer for REBALANCE-family requests: the journaled
        standing proposal set (controller/standing.py) marked
        ``degraded=true`` — the best placement knowledge the control plane
        has, served warm instead of queueing a solve behind a dead backend.
        Without a standing set the honest answer is 503 + Retry-After (the
        breaker's next probe window)."""
        retry_s = max(
            self.breaker.retry_after_s() if self.breaker is not None else 0.0,
            1.0,
        )
        standing = self.controller.standing if self.controller is not None else None
        if standing is None:
            return (
                503,
                {
                    "error": (
                        f"{endpoint}: backend unavailable (circuit breaker "
                        "open) and no standing proposal set to degrade to"
                    ),
                    "breakerOpen": True,
                },
                self._retry_after_header(retry_s),
            )
        return (
            200,
            {
                "degraded": True,
                "breakerOpen": True,
                "standingVersion": standing.version,
                "trigger": standing.trigger,
                "createdMs": standing.created_ms,
                "proposals": [
                    {
                        "topic": p.tp[0],
                        "partition": p.tp[1],
                        "oldLeader": p.old_leader,
                        "oldReplicas": list(p.old_replicas),
                        "newReplicas": list(p.new_replicas),
                    }
                    for p in standing.proposals[:1000]
                ],
                "numProposals": len(standing.proposals),
            },
            self._retry_after_header(retry_s),
        )

    #: endpoints a lagging follower still answers: process-local state
    #: (liveness, telemetry, flight recorder), not replicated data — a 503
    #: here would blind the operator exactly when they need the gauges
    REPLICATION_LAG_EXEMPT = {"HEALTHZ", "METRICS", "TRACES", "PERMISSIONS"}

    def _replication_read_gate(
        self, endpoint: str
    ) -> Optional[Tuple[int, dict, Dict[str, str]]]:
        """Follower staleness contract: past the lag bound, replicated reads
        answer 503 + Retry-After (PR 8 shed discipline) — never
        silently-stale data.  Returns None when the read may proceed."""
        from cruise_control_tpu_torch.core.sensors import (
            REGISTRY,
            REPLICATION_STALE_503_COUNTER,
        )

        stale_ms = self.replication.staleness_ms()
        if stale_ms <= self.replication_lag_bound_ms:
            return None
        REGISTRY.counter(REPLICATION_STALE_503_COUNTER).inc()
        # the tail is not keeping up (writer-side disk stall, follower I/O
        # starvation): back clients off proportionally to the lag, bounded
        # like the breaker's probe window
        retry_s = min(30.0, max(1.0, stale_ms / 1000.0))
        return (
            503,
            {
                "error": (
                    f"{endpoint}: follower is {stale_ms} ms behind the WAL "
                    f"(lag bound {self.replication_lag_bound_ms} ms)"
                ),
                "replication": self.replication.stamp(
                    self.replication_degraded_after_ms
                ),
            },
            self._retry_after_header(retry_s),
        )

    def _dispatch_authorized(
        self, method: str, endpoint: str, params: Dict[str, List[str]], user, role
    ) -> Tuple[int, Union[dict, str], Dict[str, str]]:
        # follower role (replication.role=follower): reads only.  POSTs are
        # refused outright — exactly one fenced writer owns mutation, and a
        # follower must stay incapable of split-brain even when misaddressed
        if self.read_only:
            if method == "POST":
                return (
                    503,
                    {
                        "error": (
                            f"{endpoint}: this process is a replication "
                            "follower (reads + WATCH only); send mutations "
                            "to the writer"
                        ),
                        "replication": self.replication.stamp(
                            self.replication_degraded_after_ms
                        ),
                    },
                    self._retry_after_header(
                        self.admission.retry_after_estimate()
                    ),
                )
            if endpoint not in self.REPLICATION_LAG_EXEMPT:
                refused = self._replication_read_gate(endpoint)
                if refused is not None:
                    return refused
        # admission: the token bucket is the first, cheapest refusal — it
        # must fire before any readiness/breaker/model work (overload
        # protection that itself does work per request protects nothing).
        # Cheap reads and operator escape hatches bypass (admission.py).
        if endpoint not in CHEAP_ENDPOINTS:
            try:
                self.admission.check_rate(principal_of(user), endpoint)
            except AdmissionRefused as e:
                return (
                    429,
                    {"error": str(e), "reason": e.reason},
                    self._retry_after_header(e.retry_after_s),
                )
        # TRACES is gated only as a POST (the rollout solves against the
        # cluster model); the GET reads the flight recorder, which must stay
        # reachable while the process is still warming up
        if (
            endpoint in READINESS_GATED
            and not (endpoint == "TRACES" and method == "GET")
            and not self.readiness.is_ready
        ):
            # optimize-family requests are refused, not queued, until the
            # readiness ladder completes — a solve against a recovering
            # executor or an empty monitor window ring can only mislead
            phase = self.readiness.phase
            return (
                503,
                {
                    "error": f"not ready: {phase}; retry after readiness",
                    "readiness": phase,
                },
                {"Retry-After": str(self.readiness.retry_after_s())},
            )
        if (
            endpoint in BREAKER_DEGRADED
            and self.breaker is not None
            and self.breaker.is_open
        ):
            # a dead backend must not accumulate queued solves: answer from
            # the warm standing state, marked degraded, and tell the client
            # when the breaker will probe again
            return self._degraded_standing(endpoint)
        try:
            if method == "GET":
                if endpoint == "PERMISSIONS":
                    status, body = self.get_permissions(params, role=role)
                else:
                    fn = getattr(self, f"get_{endpoint.lower()}", None)
                    if fn is None:
                        return 404, {"error": f"unknown endpoint {endpoint}"}, {}
                    status, body = fn(params)
                if self.replication is not None and isinstance(body, dict):
                    # every read carries {setVersion, epoch, stalenessMs,
                    # degraded}: clients can always tell how current the
                    # answer is (schemas allow additive keys)
                    body.setdefault(
                        "replication",
                        self.replication.stamp(
                            self.replication_degraded_after_ms
                        ),
                    )
                return status, body, {}

            # POST: two-step verification parks reviewable requests
            if self.two_step and endpoint in REVIEWABLE:
                review_id = params.get("review_id", [None])[0]
                if review_id is None:
                    info = self.purgatory.park(
                        endpoint, {k: v for k, v in params.items()}, user or "anonymous"
                    )
                    return 202, {"reviewId": info.review_id, "status": info.status.value}, {}
                claimed = self.purgatory.take_approved(int(review_id), endpoint)
                if claimed is None:
                    return 403, {"error": f"review {review_id} not approved for {endpoint}"}, {}
                # Execute the stored approved parameters VERBATIM (the reference's
                # Purgatory.submit uses the parked RequestInfo's parameters; letting
                # the submitter merge new params post-approval would bypass review).
                params = dict(claimed.params)

            fn = getattr(self, f"post_{endpoint.lower()}", None)
            if fn is None:
                return 404, {"error": f"unknown endpoint {endpoint}"}, {}
            return fn(params)
        except AdmissionRefused as e:
            # load shed: a real 429 with a Retry-After derived from queue
            # depth and drain rate — never a 500
            return (
                429,
                {"error": str(e), "reason": e.reason},
                self._retry_after_header(e.retry_after_s),
            )
        except TooManyUserTasksError as e:
            # the user-task cap is the admission queue's backstop; crossing
            # it is still overload, not a server fault
            return (
                429,
                {"error": str(e), "reason": "max-active-tasks"},
                self._retry_after_header(self.admission.retry_after_estimate()),
            )
        except Exception as e:  # uniform error envelope (reference's error response)
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}


class _Handler(BaseHTTPRequestHandler):
    app: CruiseControlApp = None  # set by make_server

    def _dispatch(self, method: str) -> None:
        parsed = urlparse(self.path)
        if not parsed.path.startswith(API_PREFIX):
            self._respond(404, {"error": "not found"}, {})
            return
        endpoint = parsed.path[len(API_PREFIX):].strip("/").upper()
        params = parse_qs(parsed.query)
        if method == "POST" and self.headers.get("Content-Length"):
            length = int(self.headers["Content-Length"])
            body = self.rfile.read(length).decode()
            for k, v in parse_qs(body).items():
                params.setdefault(k, v)
        valid = GET_ENDPOINTS if method == "GET" else POST_ENDPOINTS
        if endpoint not in valid:
            self._respond(404, {"error": f"unknown {method} endpoint {endpoint!r}"}, {})
            return
        status, body, headers = self.app.handle(method, endpoint, params, self.headers)
        self._respond(status, body, headers)

    def _respond(
        self, status: int, body: Union[dict, str], headers: Dict[str, str]
    ) -> None:
        if isinstance(body, str):
            # plain-text endpoints (METRICS): Prometheus exposition format
            payload = body.encode()
            content_type = "text/plain; version=0.0.4; charset=utf-8"
        else:
            payload = json.dumps(body, default=str).encode()
            content_type = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def log_message(self, fmt, *args) -> None:  # quiet
        pass


class _Server(ThreadingHTTPServer):
    # the stdlib default listen backlog is 5: under a concurrent-client burst
    # the kernel refuses the 6th SYN while the accept loop is busy, which
    # surfaces as a connection reset — a shed without a 429, exactly what the
    # admission layer exists to prevent.  Deepen the backlog so overload is
    # always answered by admission control, never by the kernel.
    request_queue_size = 512


def make_server(app: CruiseControlApp, host: str = "127.0.0.1", port: int = 9090):
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return _Server((host, port), handler)
