"""OpenAPI 3 document generated from the live endpoint registry + schemas.

Port of ``cruise_control_tpu/api/openapi.py`` (pure Python, copied whole): it renders the same contract, ``docs/openapi.yaml``, byte for byte.

The reference ships a hand-maintained OpenAPI YAML
(``src/main/resources/yaml/base.yaml`` + per-endpoint files) that its servlet
tests schema-check responses against.  Here the spec is *derived* from the
same registries the server actually dispatches on (``server.GET_ENDPOINTS`` /
``POST_ENDPOINTS``) and validates with (``schemas.RESPONSE_SCHEMAS``), so the
published contract cannot drift from the implementation.

``python -m cruise_control_tpu_torch.api.openapi [out.yaml]`` writes the document;
the committed copy lives at ``docs/openapi.yaml``.
"""

from __future__ import annotations

from typing import Any, Dict

from cruise_control_tpu_torch.api.admission import CHEAP_ENDPOINTS
from cruise_control_tpu_torch.api.schemas import RESPONSE_SCHEMAS
from cruise_control_tpu_torch.api.server import (
    API_PREFIX,
    GET_ENDPOINTS,
    POST_ENDPOINTS,
    REVIEWABLE,
)

#: common query parameters (CruiseControlParameters subclasses)
_COMMON_PARAMS = [
    {"name": "json", "in": "query", "required": False,
     "schema": {"type": "boolean"},
     "description": "JSON response (always true here; kept for CLI parity)"},
    {"name": "X-Request-Id", "in": "header", "required": False,
     "schema": {"type": "string"},
     "description": ("correlation id attached (as parent_id) to every "
                     "flight-recorder trace this request causes — user task, "
                     "optimize, execution; generated and echoed back when "
                     "absent.  Retrieve the walk with GET /traces?parent_id=")},
]

#: endpoints whose 200 body is text/plain, not JSON
_TEXT_ENDPOINTS = {"METRICS": "Prometheus text exposition format 0.0.4"}
_ASYNC_PARAMS = [
    {"name": "dryrun", "in": "query", "required": False,
     "schema": {"type": "boolean"},
     "description": "compute proposals without executing them"},
    {"name": "goals", "in": "query", "required": False,
     "schema": {"type": "string"},
     "description": "comma-separated goal names overriding the default list"},
    {"name": "review_id", "in": "query", "required": False,
     "schema": {"type": "integer"},
     "description": "approved two-step-verification request to execute"},
    {"name": "deadline_ms", "in": "query", "required": False,
     "schema": {"type": "integer"},
     "description": ("client budget in milliseconds: bounds the admission-"
                     "queue wait (an over-deadline queued request sheds with "
                     "429 before reaching the solver) and becomes the "
                     "per-request optimize deadline — an expiring solve "
                     "returns best-so-far marked degraded=true")},
]

#: the load-shedding contract (api/admission.py): every shed is a 429 with a
#: Retry-After derived from queue depth and drain rate — never a 500
_SHED_RESPONSE = {
    "description": (
        "shed by admission control (rate limit, per-principal quota, full "
        "queue, over-deadline queue wait, or the active-task cap); the "
        "Retry-After header is derived from live queue depth and drain rate"
    ),
    "headers": {
        "Retry-After": {
            "schema": {"type": "integer"},
            "description": "seconds until a retry is likely to be admitted",
        }
    },
    "content": {"application/json": {"schema": {"type": "object"}}},
}

#: POSTs that answer synchronously in the handler thread — no user task, no
#: 202, no async params (CONTROLLER/FLEET pause/resume/tick is a switch on
#: a control loop, never a long-running operation)
_SYNC_POST_ENDPOINTS = {"CONTROLLER", "FLEET"}

#: endpoint-specific query parameters beyond the common/async sets.  A param
#: carrying a ``"methods"`` key is emitted only for those methods (needed by
#: dual-method endpoints whose POST switch params mean nothing on GET).
_ENDPOINT_PARAMS = {
    "SIMULATE": [
        {"name": "scenarios", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("JSON list of scenario specs (sim.scenario.Scenario "
                         "wire format: add_brokers, remove_brokers, "
                         "kill_brokers, drop_rack, load_factor, "
                         "topic_load_factors, capacity_factors, goal_order)")},
        {"name": "add_broker_counts", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": "shorthand sweep: comma-separated added-broker counts"},
        {"name": "load_factors", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": "shorthand sweep: comma-separated load multipliers"},
        {"name": "remove_brokerid", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": "brokers decommissioned in every shorthand scenario"},
        {"name": "kill_brokerid", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": "brokers failed in every shorthand scenario"},
        {"name": "drop_rack", "in": "query", "required": False,
         "schema": {"type": "integer"},
         "description": "rack whose brokers all fail in every shorthand scenario"},
        {"name": "deep", "in": "query", "required": False,
         "schema": {"type": "boolean"},
         "description": "run the full goal optimizer per scenario"},
    ],
    "RIGHTSIZE": [
        {"name": "load_factor", "in": "query", "required": False,
         "schema": {"type": "number"},
         "description": "plan capacity for current load × this factor"},
        {"name": "broker_number", "in": "query", "required": False,
         "schema": {"type": "integer"},
         "description": "cap on extra brokers the capacity sweep may probe"},
        {"name": "trace", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("JSON LoadTrace spec (traces.trace wire format): "
                         "adds a planning horizon — the trace evaluated at "
                         "the current broker count, with peak min-brokers-"
                         "needed over the horizon in the response")},
    ],
    "HEALTHZ": [
        {"name": "readiness", "in": "query", "required": False,
         "schema": {"type": "boolean"},
         "description": ("readinessProbe mode: 503 (+ Retry-After) until the "
                         "startup ladder recovering -> monitor_warming -> "
                         "ready completes; default liveness mode always "
                         "answers 200 with the ladder state in the body")},
    ],
    "WATCH": [
        {"name": "since", "in": "query", "required": False,
         "schema": {"type": "integer"},
         "description": ("delta cursor: last seq this client has seen "
                         "(0 = from the start of the ring; a cursor past "
                         "the ring answers resync=true + a snapshot of the "
                         "current standing set)"),
         "methods": ["get"]},
        {"name": "timeout_ms", "in": "query", "required": False,
         "schema": {"type": "integer"},
         "description": ("long-poll park time when no delta is pending "
                         "(capped by replication.watch.max.wait.ms; 0 = "
                         "answer immediately)"),
         "methods": ["get"]},
    ],
    "CONTROLLER": [
        {"name": "action", "in": "query", "required": False,
         "schema": {"type": "string", "enum": ["pause", "resume", "tick"]},
         "description": ("pause/resume the continuous control loop, or "
                         "force one synchronous tick (GET returns the "
                         "status: drift, staleness, standing proposal set, "
                         "reaction-latency p50/p95)"),
         "methods": ["post"]},
        {"name": "reason", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": "operator note recorded with pause/resume",
         "methods": ["post"]},
    ],
    "FLEET": [
        {"name": "action", "in": "query", "required": False,
         "schema": {"type": "string", "enum": ["pause", "resume", "tick"]},
         "description": ("pause/resume the fleet controller, or force one "
                         "synchronous fleet evaluation (GET returns the "
                         "status: per-tenant control-loop blocks plus the "
                         "last tick's batching census)"),
         "methods": ["post"]},
        {"name": "reason", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": "operator note recorded with pause/resume",
         "methods": ["post"]},
        {"name": "tenant", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("narrow to one tenant: GET answers that tenant's "
                         "status block; POST pause/resume flips only that "
                         "tenant, tick forces only that tenant's lane")},
    ],
    "TRACES": [
        {"name": "kind", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("trace kind filter: optimize | execution | detector "
                         "| model | simulate | rollout | replay | user_task "
                         "| retry | admission | ..."),
         "methods": ["get"]},
        {"name": "trace_id", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": "exact trace id",
         "methods": ["get"]},
        {"name": "parent_id", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("request correlation id (X-Request-Id): returns the "
                         "user task, optimize and execution traces it caused"),
         "methods": ["get"]},
        {"name": "limit", "in": "query", "required": False,
         "schema": {"type": "integer"},
         "description": "newest-first record cap (default 50)",
         "methods": ["get"]},
        {"name": "traces", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("JSON list of LoadTrace specs (traces.trace wire "
                         "format: num_steps, step_s, base_factor, seed, "
                         "segments) — the time axis of the rollout"),
         "methods": ["post"]},
        {"name": "policies", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("JSON list of AutoscalePolicy specs (traces.policy "
                         "wire format: scale_out_threshold, "
                         "scale_in_threshold, min_balancedness, "
                         "cooldown_ticks, step_brokers, min/max/"
                         "initial_brokers) — evaluated against every trace "
                         "in one batched dispatch"),
         "methods": ["post"]},
    ],
    "METRICS": [
        {"name": "window", "in": "query", "required": False,
         "schema": {"type": "integer"},
         "description": ("additionally render the self-monitoring plane's "
                         "last N stable windowed means per series "
                         "(cruise_control_tpu_selfmon_window_value, "
                         "labels series + window_id); requires "
                         "selfmon.enable"),
         "methods": ["get"]},
    ],
    "SLO": [
        {"name": "slo", "in": "query", "required": False,
         "schema": {"type": "string"},
         "description": ("narrow to one declared SLO: answers that spec's "
                         "block plus only its alerts"),
         "methods": ["get"]},
    ],
}


def _schema_to_openapi(schema: Any) -> Dict[str, Any]:
    """Translate the schemas.py mini-language into an OpenAPI schema object."""
    if schema is None:
        return {"nullable": True}
    if isinstance(schema, tuple):
        alts = [_schema_to_openapi(s) for s in schema]
        nullable = any(a == {"nullable": True} for a in alts)
        alts = [a for a in alts if a != {"nullable": True}]
        if len(alts) == 1:
            out = dict(alts[0])
        else:
            out = {"oneOf": alts}
        if nullable:
            out["nullable"] = True
        return out
    if isinstance(schema, type):
        return {
            bool: {"type": "boolean"},
            int: {"type": "integer"},
            float: {"type": "number"},
            str: {"type": "string"},
            dict: {"type": "object"},
            list: {"type": "array", "items": {}},
        }.get(schema, {"type": "object"})
    if isinstance(schema, dict):
        props = {}
        required = []
        for key, sub in schema.items():
            optional = key.startswith("?")
            name = key[1:] if optional else key
            props[name] = _schema_to_openapi(sub)
            if not optional:
                required.append(name)
        out: Dict[str, Any] = {"type": "object", "properties": props}
        if required:
            out["required"] = sorted(required)
        return out
    if isinstance(schema, list):
        return {"type": "array", "items": _schema_to_openapi(schema[0])}
    return {"type": "object"}


def generate_openapi() -> Dict[str, Any]:
    """The OpenAPI 3.0 document for the live REST surface."""
    paths: Dict[str, Any] = {}
    for name in sorted(GET_ENDPOINTS | POST_ENDPOINTS):
        # an endpoint can serve both methods (CONTROLLER: GET status, POST
        # pause/resume/tick) — emit one operation per registered method
        methods = [m for m, reg in (("get", GET_ENDPOINTS), ("post", POST_ENDPOINTS))
                   if name in reg]
        ops: Dict[str, Any] = {}
        for method in methods:
            # method-qualified schema ("POST TRACES") wins over the bare
            # endpoint name — dual-method endpoints may answer different
            # bodies per method
            body_schema = RESPONSE_SCHEMAS.get(
                f"{method.upper()} {name}", RESPONSE_SCHEMAS.get(name)
            )
            if name in _TEXT_ENDPOINTS:
                content = {
                    "text/plain": {
                        "schema": {
                            "type": "string",
                            "description": _TEXT_ENDPOINTS[name],
                        }
                    }
                }
            else:
                content = {
                    "application/json": {
                        "schema": _schema_to_openapi(body_schema)
                        if body_schema is not None
                        else {"type": "object"}
                    }
                }
            responses: Dict[str, Any] = {
                "200": {"description": "success", "content": content}
            }
            if name not in CHEAP_ENDPOINTS:
                # every non-cheap endpoint can be shed by admission control;
                # cheap reads and operator escape hatches always bypass
                responses["429"] = _SHED_RESPONSE
            params = list(_COMMON_PARAMS)
            if method == "post" and name not in _SYNC_POST_ENDPOINTS:
                responses["202"] = {
                    "description": (
                        "accepted — async operation in progress; poll with the "
                        "returned User-Task-ID header/userTaskId field"
                    ),
                    "content": {"application/json": {"schema": {"type": "object"}}},
                }
                params = params + _ASYNC_PARAMS
                if name in REVIEWABLE:
                    responses["202"]["description"] += (
                        "; may instead return a pending review entry when "
                        "two-step verification is enabled"
                    )
            params = params + [
                {k: v for k, v in p.items() if k != "methods"}
                for p in _ENDPOINT_PARAMS.get(name, [])
                if method in p.get("methods", ("get", "post"))
            ]
            op_id = name.lower() if len(methods) == 1 else f"{method}_{name.lower()}"
            ops[method] = {
                "operationId": op_id,
                "summary": name,
                "parameters": params,
                "responses": responses,
            }
        paths[API_PREFIX + name.lower()] = ops

    return {
        "openapi": "3.0.3",
        "info": {
            "title": "cruise-control-tpu REST API",
            "description": (
                "TPU-native Cruise Control: the reference's 22-endpoint "
                "surface (servlet/CruiseControlEndPoint.java:16-39) plus "
                "identical async 202/User-Task-ID semantics "
                "(servlet/UserTaskManager.java:222)."
            ),
            "version": "0.4.0",
        },
        "paths": paths,
    }


def write_yaml(path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(generate_openapi(), f, sort_keys=False)


def check_yaml(path: str) -> int:
    """Drift check (CI): regenerate and diff against the committed copy.

    The committed ``docs/openapi.yaml`` is generated, but nothing used to
    refuse a stale commit — an endpoint added to the server silently left
    the published contract behind.  Returns 0 when identical, 1 with a
    unified diff on stderr when stale."""
    import difflib
    import sys

    import yaml

    want = yaml.safe_dump(generate_openapi(), sort_keys=False)
    try:
        with open(path) as f:
            have = f.read()
    except OSError:
        have = ""
    if want == have:
        return 0
    sys.stderr.write(
        f"{path} is stale — regenerate with: "
        f"python -m cruise_control_tpu_torch.api.openapi {path}\n"
    )
    sys.stderr.writelines(
        difflib.unified_diff(
            have.splitlines(True), want.splitlines(True),
            fromfile=path, tofile="generated",
        )
    )
    return 1


if __name__ == "__main__":
    import sys

    if "--check" in sys.argv:
        args = [a for a in sys.argv[1:] if a != "--check"]
        sys.exit(check_yaml(args[0] if args else "docs/openapi.yaml"))
    write_yaml(sys.argv[1] if len(sys.argv) > 1 else "docs/openapi.yaml")
