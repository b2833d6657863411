"""Programmatic REST client with async-task polling.

Port of ``cruise_control_tpu/client/client.py`` (plain ``urllib``, copied whole).

Mirrors the behavior of the reference client (``cruise-control-client``,
``Endpoint.py`` + ``Responder``/``ExecutionContext``): every endpoint is a typed
method; POSTs that return 202 carry a ``User-Task-ID`` which the client polls via
USER_TASKS until the operation completes (or ``wait=False`` returns the task id
immediately).  Stdlib-only (urllib) — the client must work in bare environments.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


class ClientError(Exception):
    """Non-2xx response; carries the HTTP status, decoded body, and — for
    429/503 shed/not-ready answers — the server's ``Retry-After`` seconds
    (``retry_after_s``, None when the header was absent)."""

    def __init__(self, status: int, body: Any, retry_after_s: Optional[float] = None):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body
        self.retry_after_s = retry_after_s


class CruiseControlClient:
    API_PREFIX = "/kafkacruisecontrol"

    def __init__(
        self,
        base_url: str = "http://127.0.0.1:9090",
        username: Optional[str] = None,
        password: Optional[str] = None,
        poll_interval_s: float = 0.5,
        poll_timeout_s: float = 600.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.poll_interval_s = poll_interval_s
        self.poll_timeout_s = poll_timeout_s
        self._auth = None
        if username is not None:
            token = base64.b64encode(f"{username}:{password or ''}".encode()).decode()
            self._auth = f"Basic {token}"

    # -- transport -----------------------------------------------------------

    def _request(
        self,
        method: str,
        endpoint: str,
        params: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
        raw: bool = False,
    ) -> Tuple[int, Any, Dict[str, str]]:
        qs = urllib.parse.urlencode(
            {k: v for k, v in (params or {}).items() if v is not None}
        )
        url = f"{self.base_url}{self.API_PREFIX}/{endpoint}"
        if qs:
            url += f"?{qs}"
        req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
        if self._auth:
            req.add_header("Authorization", self._auth)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req) as resp:
                payload = resp.read()
                body = (
                    payload.decode()
                    if raw
                    else json.loads(payload or b"{}")
                )
                return resp.status, body, dict(resp.headers)
        except urllib.error.HTTPError as e:
            data = e.read()
            try:
                body = json.loads(data) if data else {}
            except json.JSONDecodeError:
                body = {"raw": data.decode(errors="replace")}
            if e.code >= 400:
                retry_after = e.headers.get("Retry-After")
                raise ClientError(
                    e.code, body,
                    retry_after_s=float(retry_after) if retry_after else None,
                ) from None
            return e.code, body, dict(e.headers)

    def _get(self, endpoint: str, **params) -> Any:
        status, body, _ = self._request("GET", endpoint, params)
        if status >= 400:
            raise ClientError(status, body)
        return body

    def _post(
        self,
        endpoint: str,
        wait: bool = True,
        request_id: Optional[str] = None,
        **params,
    ) -> Any:
        headers = {"X-Request-Id": request_id} if request_id else None
        status, body, headers = self._request(
            "POST", endpoint, params, headers=headers
        )
        if status >= 400:
            raise ClientError(status, body)
        if status == 202:
            task_id = headers.get("User-Task-ID") or body.get("userTaskId")
            if not wait:
                return {"userTaskId": task_id, "accepted": True}
            return self._await_task(endpoint, params, task_id)
        return body

    def _await_task(self, endpoint: str, params: Dict[str, Any], task_id: str) -> Any:
        """Poll USER_TASKS until the task completes (Responder's retry loop).

        The server embeds the completed task's final response body as
        ``result`` — never re-issue the original request to fetch it, a
        re-POST could re-execute a mutating operation if the completed task
        was already evicted from the server's task map."""
        deadline = time.monotonic() + self.poll_timeout_s
        while time.monotonic() < deadline:
            body = self._get("user_tasks", user_task_ids=task_id)
            tasks = body.get("userTasks", [])
            for t in tasks:
                if t.get("UserTaskId") != task_id:
                    continue
                status = t.get("Status")
                if status == "Completed":
                    return t.get("result", t)
                if status == "CompletedWithError":
                    raise ClientError(500, t)
            time.sleep(self.poll_interval_s)
        raise TimeoutError(f"user task {task_id} did not complete in {self.poll_timeout_s}s")

    # -- GET endpoints (CruiseControlEndPoint.java:16-26) --------------------

    def state(self) -> Any:
        return self._get("state")

    def load(self) -> Any:
        return self._get("load")

    def partition_load(self, resource: str = "DISK", start: int = 0, entries: int = 20) -> Any:
        return self._get("partition_load", resource=resource, start=start, entries=entries)

    def proposals(
        self, ignore_proposal_cache: bool = False, goals: Optional[Sequence[str]] = None
    ) -> Any:
        """``goals`` names a goal list in place of the defaults (such a
        request bypasses the proposal cache on the server)."""
        return self._get(
            "proposals", ignore_proposal_cache=str(ignore_proposal_cache).lower(),
            goals=self._csv(goals),
        )

    def kafka_cluster_state(self) -> Any:
        return self._get("kafka_cluster_state")

    def user_tasks(self, user_task_ids: Optional[str] = None) -> Any:
        return self._get("user_tasks", user_task_ids=user_task_ids)

    def review_board(self) -> Any:
        return self._get("review_board")

    def permissions(self) -> Any:
        return self._get("permissions")

    def bootstrap(self, start: Optional[int] = None, end: Optional[int] = None) -> Any:
        return self._get("bootstrap", start=start, end=end)

    def train(self, start: Optional[int] = None, end: Optional[int] = None) -> Any:
        return self._get("train", start=start, end=end)

    def traces(
        self,
        kind: Optional[str] = None,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        limit: int = 50,
    ) -> Any:
        """GET /traces: flight-recorder records; ``parent_id`` walks one
        ``X-Request-Id`` through request → user task → optimize → execution."""
        return self._get(
            "traces", kind=kind, trace_id=trace_id, parent_id=parent_id,
            limit=limit,
        )

    def metrics(self) -> str:
        """GET /metrics: the Prometheus text exposition page, verbatim."""
        status, body, _ = self._request("GET", "metrics", raw=True)
        if status >= 400:
            raise ClientError(status, body)
        return body

    def controller_status(self) -> Any:
        """GET /controller: the continuous control loop's status — drift,
        staleness, standing proposal set, reaction-latency p50/p95.
        ``{"enabled": false}`` when ``controller.enable`` is off."""
        return self._get("controller")

    def controller_pause(self, reason: str = "client request") -> Any:
        """POST /controller?action=pause: stop the loop from ticking (the
        standing set keeps standing)."""
        return self._post("controller", action="pause", reason=reason)

    def controller_resume(self, reason: str = "client request") -> Any:
        return self._post("controller", action="resume", reason=reason)

    def controller_tick(self) -> Any:
        """POST /controller?action=tick: force one synchronous control-loop
        evaluation instead of waiting for drift/cadence."""
        return self._post("controller", action="tick")

    def fleet_status(self, tenant: Optional[str] = None) -> Any:
        """GET /fleet: the fleet controller's status — coordinator state,
        the last tick's batching census (tenants per dispatch, goal-order
        groups), and one control-loop block per tenant.  ``tenant`` narrows
        the answer to that tenant's block.  ``{"enabled": false}`` when
        ``fleet.enable`` is off."""
        return self._get("fleet", tenant=tenant)

    def fleet_pause(
        self, reason: str = "client request", tenant: Optional[str] = None
    ) -> Any:
        """POST /fleet?action=pause: stop the fleet (or one tenant's lane)
        from ticking — every standing set keeps standing."""
        return self._post("fleet", action="pause", reason=reason, tenant=tenant)

    def fleet_resume(
        self, reason: str = "client request", tenant: Optional[str] = None
    ) -> Any:
        return self._post("fleet", action="resume", reason=reason, tenant=tenant)

    def fleet_tick(self, tenant: Optional[str] = None) -> Any:
        """POST /fleet?action=tick: force one synchronous fleet evaluation;
        with ``tenant`` only that tenant's lane is forced (the others still
        ride the batched dispatch and trigger on their own drift)."""
        return self._post("fleet", action="tick", tenant=tenant)

    def slo(self, name: Optional[str] = None) -> Any:
        """GET /slo: the SLO burn-rate engine's status — every declared
        objective with its latest value and per-window-pair burn rates +
        alert state, plus the self-monitoring sampler's accounting.
        ``name`` narrows to one spec's block.  ``{"enabled": false}`` when
        ``selfmon.enable`` is off."""
        return self._get("slo", slo=name)

    def watch(self, since: int = 0, timeout_ms: int = 0) -> Any:
        """GET /watch: long-poll standing-proposal-set deltas (published /
        superseded / drained / epoch, keyed by version) since the ``since``
        cursor.  Re-arm with the returned ``since``; ``resync=true`` means
        the cursor fell off the delta ring and the single delta is a
        snapshot of the current set."""
        return self._get("watch", since=since, timeout_ms=timeout_ms)

    def watch_iter(self, since: int = 0, timeout_ms: int = 30_000):
        """Generator of deltas, re-arming the long-poll forever — the
        replacement for a USER_TASKS polling loop."""
        while True:
            page = self.watch(since=since, timeout_ms=timeout_ms)
            for delta in page.get("deltas", []):
                yield delta
            since = page.get("since", since)

    def healthz(self, readiness: bool = False) -> Any:
        """GET /healthz: liveness + the startup readiness ladder
        (``recovering`` → ``monitor_warming`` → ``ready``).  With
        ``readiness=True`` a not-ready server answers 503 (raised as
        :class:`ClientError`) — the k8s readinessProbe contract."""
        return self._get(
            "healthz", readiness=str(readiness).lower() if readiness else None
        )

    # -- POST endpoints (:27-39) ---------------------------------------------

    @staticmethod
    def _csv(values: Optional[Iterable[Any]]) -> Optional[str]:
        if values is None:
            return None
        vals = list(values)
        return ",".join(str(v) for v in vals) if vals else None

    def rebalance(
        self,
        dryrun: bool = True,
        goals: Optional[Sequence[str]] = None,
        excluded_topics: Optional[str] = None,
        wait: bool = True,
        request_id: Optional[str] = None,
        deadline_ms: Optional[int] = None,
    ) -> Any:
        """``request_id`` rides the ``X-Request-Id`` header: every trace the
        rebalance causes (user task, optimize, execution) carries it as
        ``parent_id`` — retrieve the whole story with :meth:`traces`.
        ``deadline_ms`` is the client budget: it bounds the server-side
        admission-queue wait (over-deadline ⇒ 429 + Retry-After, raised here
        as :class:`ClientError`) and becomes the per-request optimize
        deadline (an expiring solve returns ``degraded=true`` best-so-far)."""
        return self._post(
            "rebalance", wait=wait, request_id=request_id,
            dryrun=str(dryrun).lower(),
            goals=self._csv(goals), excluded_topics=excluded_topics,
            deadline_ms=deadline_ms,
        )

    def add_broker(self, broker_ids: Sequence[int], dryrun: bool = True, wait: bool = True) -> Any:
        return self._post(
            "add_broker", wait=wait, brokerid=self._csv(broker_ids),
            dryrun=str(dryrun).lower(),
        )

    def remove_broker(self, broker_ids: Sequence[int], dryrun: bool = True, wait: bool = True) -> Any:
        return self._post(
            "remove_broker", wait=wait, brokerid=self._csv(broker_ids),
            dryrun=str(dryrun).lower(),
        )

    def demote_broker(self, broker_ids: Sequence[int], dryrun: bool = True, wait: bool = True) -> Any:
        return self._post(
            "demote_broker", wait=wait, brokerid=self._csv(broker_ids),
            dryrun=str(dryrun).lower(),
        )

    def fix_offline_replicas(self, dryrun: bool = True, wait: bool = True) -> Any:
        return self._post("fix_offline_replicas", wait=wait, dryrun=str(dryrun).lower())

    def topic_configuration(
        self, topic: str, replication_factor: int, dryrun: bool = True, wait: bool = True
    ) -> Any:
        return self._post(
            "topic_configuration", wait=wait, topic=topic,
            replication_factor=replication_factor, dryrun=str(dryrun).lower(),
        )

    def rightsize(
        self,
        dryrun: bool = True,
        load_factor: Optional[float] = None,
        trace: Optional[Dict[str, Any]] = None,
        wait: bool = True,
    ) -> Any:
        """POST /rightsize; ``trace`` (a LoadTrace dict) adds the planning
        horizon — peak min-brokers-needed over the trace at the current
        broker count."""
        return self._post(
            "rightsize", wait=wait, dryrun=str(dryrun).lower(),
            load_factor=load_factor,
            trace=json.dumps(trace) if trace is not None else None,
        )

    def simulate(
        self,
        scenarios: Optional[Sequence[Dict[str, Any]]] = None,
        add_broker_counts: Optional[Sequence[int]] = None,
        load_factors: Optional[Sequence[float]] = None,
        remove_brokers: Optional[Sequence[int]] = None,
        kill_brokers: Optional[Sequence[int]] = None,
        drop_rack: Optional[int] = None,
        deep: bool = False,
        goals: Optional[Sequence[str]] = None,
        wait: bool = True,
    ) -> Any:
        """POST /simulate: batched what-if sweep (sim/ subsystem).

        ``scenarios`` is a list of scenario dicts (the Scenario wire format);
        the shorthand arguments instead build an add-brokers × load-factor
        cross product, each scenario also applying the removals/failures."""
        return self._post(
            "simulate", wait=wait,
            scenarios=json.dumps(scenarios) if scenarios is not None else None,
            add_broker_counts=self._csv(add_broker_counts),
            load_factors=self._csv(load_factors),
            remove_brokerid=self._csv(remove_brokers),
            kill_brokerid=self._csv(kill_brokers),
            drop_rack=drop_rack,
            deep=str(deep).lower(),
            goals=self._csv(goals),
        )

    def trace_rollout(
        self,
        traces: Sequence[Dict[str, Any]],
        policies: Sequence[Dict[str, Any]],
        goals: Optional[Sequence[str]] = None,
        wait: bool = True,
    ) -> Any:
        """POST /traces: batched autoscaling-policy rollouts (traces/
        subsystem).  ``traces`` is a list of LoadTrace dicts and ``policies``
        a list of AutoscalePolicy dicts (both wire formats); every
        (trace × policy) pair is scanned through time in one compiled
        dispatch, returning per-pair verdicts and per-trace winners."""
        return self._post(
            "traces", wait=wait,
            traces=json.dumps(list(traces)),
            policies=json.dumps(list(policies)),
            goals=self._csv(goals),
        )

    def remove_disks(
        self, broker_id_and_logdirs: Sequence[Tuple[int, str]], dryrun: bool = True,
        wait: bool = True,
    ) -> Any:
        spec = ",".join(f"{b}-{d}" for b, d in broker_id_and_logdirs)
        return self._post(
            "remove_disks", wait=wait, brokerid_and_logdirs=spec,
            dryrun=str(dryrun).lower(),
        )

    def stop_proposal_execution(self) -> Any:
        return self._post("stop_proposal_execution")

    def pause_sampling(self, reason: str = "client request") -> Any:
        return self._post("pause_sampling", reason=reason)

    def resume_sampling(self, reason: str = "client request") -> Any:
        return self._post("resume_sampling", reason=reason)

    def admin(self, **params) -> Any:
        return self._post("admin", **params)

    def review(
        self,
        approve: Optional[Sequence[int]] = None,
        discard: Optional[Sequence[int]] = None,
        reason: Optional[str] = None,
    ) -> Any:
        return self._post(
            "review", approve=self._csv(approve), discard=self._csv(discard),
            reason=reason,
        )
