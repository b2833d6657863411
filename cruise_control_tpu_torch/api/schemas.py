"""Response schemas: the REST surface's typed contract.

Port of ``cruise_control_tpu/api/schemas.py`` (pure Python, copied whole; ``numDispatches`` stays required: the port writes it).

Counterpart of the reference's response discipline — ``servlet/response/*`` with
``@JsonResponseField`` annotations, schema-checked in tests against the OpenAPI
YAML (``src/main/resources/yaml/``).  Python-idiomatic: each endpoint declares a
lightweight structural schema; :func:`validate` walks a live response against it
and raises :class:`SchemaViolation` naming the offending path.  The API test
tier validates every endpoint's response once, so response-shape regressions
fail loudly instead of surfacing in clients.

Schema mini-language:
  type                      — value must be an instance (int also accepts float)
  {"k": schema, ...}        — dict with required keys (extra keys allowed,
                              mirroring the reference's additive JSON evolution)
  {"?k": schema}            — optional key
  [schema]                  — list of schema
  (s1, s2)                  — any one of the alternatives
  None                      — JSON null
"""

from __future__ import annotations

from typing import Any, Dict


class SchemaViolation(Exception):
    pass


def validate(schema: Any, body: Any, path: str = "$") -> None:
    """Raise SchemaViolation when ``body`` doesn't match ``schema``."""
    if schema is None:
        if body is not None:
            raise SchemaViolation(f"{path}: expected null, got {type(body).__name__}")
        return
    if isinstance(schema, tuple):
        errors = []
        for alt in schema:
            try:
                validate(alt, body, path)
                return
            except SchemaViolation as e:
                errors.append(str(e))
        raise SchemaViolation(f"{path}: no alternative matched ({'; '.join(errors)})")
    if isinstance(schema, type):
        if schema is float and isinstance(body, int) and not isinstance(body, bool):
            return
        if schema is int and isinstance(body, bool):
            raise SchemaViolation(f"{path}: expected int, got bool")
        if not isinstance(body, schema):
            raise SchemaViolation(
                f"{path}: expected {schema.__name__}, got {type(body).__name__}"
            )
        return
    if isinstance(schema, dict):
        if not isinstance(body, dict):
            raise SchemaViolation(f"{path}: expected object, got {type(body).__name__}")
        for key, sub in schema.items():
            optional = key.startswith("?")
            name = key[1:] if optional else key
            if name not in body:
                if optional:
                    continue
                raise SchemaViolation(f"{path}.{name}: required field missing")
            validate(sub, body[name], f"{path}.{name}")
        return
    if isinstance(schema, list):
        if not isinstance(body, list):
            raise SchemaViolation(f"{path}: expected array, got {type(body).__name__}")
        for i, item in enumerate(body):
            validate(schema[0], item, f"{path}[{i}]")
        return
    raise SchemaViolation(f"{path}: unsupported schema node {schema!r}")


_BROKER_LOAD = {
    "Broker": int,
    "Host": str,
    "DiskMB": float,
    "CpuPct": float,
    "LeaderNwInRate": float,
    "FollowerNwInRate": float,
    "NwOutRate": float,
    "PnwOutRate": float,
    "Leaders": int,
    "Replicas": int,
    "Alive": bool,
}

_PROPOSAL = {
    "topic": str,
    "partition": int,
    "oldLeader": (int, None),
    "oldReplicas": [int],
    "newReplicas": [int],
}

_USER_TASK = {
    "UserTaskId": str,
    "RequestURL": str,
    "Status": str,
    "StartMs": int,
    "?Progress": [dict],
    #: the creating request's X-Request-Id — GET /TRACES?parent_id=… walks it
    "?RequestId": str,
    #: the completed task's final response body (also journal-replayed across
    #: restarts, so a poll after a crash still gets its answer)
    "?result": dict,
    #: failure/interruption cause ("interrupted by process restart", …)
    "?error": str,
}

_CONTROLLER_STATUS = {
    "enabled": bool,
    #: fields below only when the controller is configured
    "?state": str,                   # running | paused | warming
    "?paused": bool,
    "?pauseReason": (str, None),
    "?warmed": bool,
    "?stalenessS": float,
    "?stale": bool,
    "?epoch": int,                   # fenced writer regime (0 = unfenced)
    "?drift": float,
    "?balancedness": (float, None),
    "?violatedGoals": [str],
    "?standing": (
        {
            "version": int,
            "createdMs": int,
            "trigger": str,
            "drift": float,
            "numProposals": int,
            "reactionS": (float, None),
        },
        None,
    ),
    "?reaction": {"p50S": float, "p95S": float, "count": int},
    "?lastTick": (dict, None),
    "?topology": dict,
    "?config": dict,
    "?action": str,                  # echoed by POST
}

_FLEET_STATUS = {
    "enabled": bool,
    #: fields below only when the fleet is configured (fleet.enable)
    "?state": str,                   # running | paused
    "?paused": bool,
    "?pauseReason": (str, None),
    "?tenantCount": int,
    #: tenant name -> that tenant's _CONTROLLER_STATUS-shaped block (+tier)
    "?tenants": dict,
    #: the batching census of the last fleet tick: tenants, goal-order
    #: groups, probe/optimize dispatch counts, tenants_per_dispatch
    "?lastTick": (dict, None),
    "?config": dict,
    "?action": str,                  # echoed by POST
    #: present when the answer was narrowed with ?tenant=<name>
    "?tenant": str,
}

_SLO_STATUS = {
    "enabled": bool,
    #: fields below only when the self-monitoring plane is configured
    #: (selfmon.enable)
    "?specs": [dict],                # SloSpec.to_dict per declared objective
    "?pairs": [dict],                # WindowPair.to_dict (fast/slow)
    #: one block per (slo, pair) as of the last evaluation pass
    "?alerts": [
        {
            "slo": str,
            "pair": str,
            "firing": bool,
            "burn_long": (float, None),
            "burn_short": (float, None),
            "threshold": float,
            "since_ms": (int, None),
        }
    ],
    "?firing": int,
    "?evaluations": int,
    "?lastEvalMs": (int, None),
    #: sampler accounting (obs/selfmon.py SelfMonitor.status())
    "?selfmon": dict,
    #: present when the answer was narrowed with ?slo=<name>
    "?slo": str,
    "?name": str,
    "?series": str,
    "?objective": float,
    "?comparison": str,
    "?budget": float,
    "?description": str,
}

_READINESS = {
    "state": str,
    "ready": bool,
    "history": [{"state": str, "ts": float}],
    "recovery": dict,
}

#: STATE.Admission (api/admission.py): the overload plane's accounting
_ADMISSION = {
    "enabled": bool,
    "admitted": int,
    "shed": int,
    "shedByReason": dict,
    "active": int,
    "activeByPrincipal": dict,
    "queueDepth": int,
    "queueCapacity": int,
    "maxConcurrent": int,
    "rateQps": float,
    "maxTasksPerPrincipal": int,
}

#: the per-read replication stamp (replication/state.py): present on every
#: dict GET answer when the process carries a ReplicationState — how current
#: the answer is, and under which fenced writer regime
_REPLICATION_STAMP = {
    "setVersion": int,
    "epoch": int,
    "stalenessMs": int,
    "degraded": bool,
    "role": str,                     # writer | follower
}

#: STATE.Breaker (backend/breaker.py): the circuit-breaker state machine
_BREAKER = {
    "state": str,                    # closed | open | half_open
    "consecutiveFailures": int,
    "opens": int,
    "closes": int,
    "probes": int,
    "fastFailures": int,
    "cooldownS": float,
    "lastError": (str, None),
}

#: endpoint name (CruiseControlEndPoint.java:16-39) -> response schema
RESPONSE_SCHEMAS: Dict[str, Any] = {
    "STATE": {
        "MonitorState": dict,
        "ExecutorState": dict,
        "uptime_s": float,
        "?AnomalyDetectorState": dict,
        "?Profiler": {
            "enabled": bool,
            "executables": [dict],
            "memory": [dict],
        },
        "?Readiness": _READINESS,
        "?Admission": _ADMISSION,
        "?Breaker": _BREAKER,
        "?Controller": dict,
        "?Fleet": dict,
        #: self-monitoring plane (selfmon.enable): sampler status + SLO
        #: firing summary
        "?SelfMonitor": dict,
    },
    "HEALTHZ": {"status": str, **_READINESS},
    "CONTROLLER": _CONTROLLER_STATUS,
    "FLEET": _FLEET_STATUS,
    "SLO": _SLO_STATUS,
    "LOAD": {"brokers": [_BROKER_LOAD], "?hosts": [dict]},
    "PARTITION_LOAD": {"records": [dict], "?resource": str},
    "PROPOSALS": {
        "proposals": [_PROPOSAL],
        "?cached": bool,
        "?dryrun": bool,
        #: true when optimize.deadline.ms expired mid-walk (best-so-far body)
        #: OR when the breaker-open degraded path served the standing set
        "?degraded": bool,
        #: breaker-open degraded answer: served from the journaled standing
        #: proposal set instead of a fresh solve (backend unavailable)
        "?breakerOpen": bool,
        "?standingVersion": int,
        "?trigger": str,
        "?createdMs": int,
        "?numProposals": int,
        "?violations_before": dict,
        "?violations_after": dict,
        "?provision": (dict, str),
        "?balancedness": (float, None),
    },
    "KAFKA_CLUSTER_STATE": {"brokers": [dict], "topics": dict},
    "SIMULATE": {
        "sweep": {
            "size": int,
            "bucketBrokers": int,
            "numDispatches": int,
            "bucketHit": bool,
            "durationS": float,
            "deep": bool,
        },
        "scenarios": [
            {
                "name": str,
                "verdict": str,
                "violations": dict,
                "hard_violations": float,
                "violated_hard_goals": [str],
                "balancedness": float,
                "satisfiable": bool,
                "min_brokers_needed": int,
                "offline_moves": int,
                "offline_data_to_move": float,
                "?movement": (dict, None),
                "?provision_status": (str, None),
            }
        ],
    },
    "RIGHTSIZE": {
        "state": str,
        "summary": str,
        "?plan": {
            "minBrokers": (int, None),
            "currentBrokers": int,
            "loadFactor": float,
            "numDispatches": int,
            "durationS": float,
            "probes": [dict],
            "recommendation": dict,
        },
        #: planning horizon (trace= param): the trace evaluated at the
        #: current broker count, peak min-brokers-needed over the horizon
        "?horizon": {
            "horizonSteps": int,
            "stepS": float,
            "currentBrokers": int,
            "peakBrokersNeeded": int,
            "peakStep": int,
            "brokersToAdd": int,
            "violationSteps": int,
            "numDispatches": int,
        },
    },
    "USER_TASKS": {"userTasks": [_USER_TASK]},
    "REVIEW_BOARD": {"requestInfo": [dict]},
    "PERMISSIONS": {"role": str},
    #: long-poll watch over the standing proposal set (replication/):
    #: deltas since the client's cursor, plus the per-read replication stamp
    "WATCH": {
        "deltas": [
            {
                "seq": int,
                "kind": str,        # published | superseded | drained | epoch
                "version": int,
                "epoch": int,
                "tsMs": int,
                "?numProposals": int,
                "?trigger": str,
                "?drift": float,
                "?superseded": int,
                "?reason": (str, None),
                "?completed": (int, None),
            }
        ],
        #: the cursor to re-arm with (last delta seq on this process)
        "since": int,
        #: true when the cursor predated the delta ring: the single delta is
        #: a snapshot of the current set, not the missed history
        "resync": bool,
        "replication": _REPLICATION_STAMP,
    },
    "BOOTSTRAP": {"samplesLoaded": int, "from": int, "to": int},
    "TRAIN": {"trained": bool},
    "TRACES": {
        "traces": [
            {
                "kind": str,
                "trace_id": str,
                "started_at": float,
                "duration_s": float,
                "platform": str,
                "attrs": dict,
                "spans": [
                    {
                        "name": str,
                        "kind": str,
                        "duration_s": float,
                        "dispatches": int,
                        "attrs": dict,
                    }
                ],
                "compile_events": [dict],
                "?parent_id": (str, None),
                "schema": int,
            }
        ],
        "recorder": {
            "size": int,
            "capacity": int,
            "dropped": int,
            "by_kind": dict,
            "jsonl_path": (str, None),
        },
    },
    #: POST TRACES (batched autoscaling rollouts) answers a different body
    #: than the GET (flight-recorder read) — method-qualified keys win over
    #: the bare endpoint name in validate_endpoint / the OpenAPI generator
    "POST TRACES": {
        "rollout": {
            "numPairs": int,
            "numSteps": int,
            "bucketBrokers": int,
            "numDispatches": int,
            "bucketHit": bool,
            "durationS": float,
        },
        #: per trace: the violation-free policy with the fewest broker-hours
        "winners": dict,
        "verdicts": [
            {
                "trace": str,
                "policy": str,
                "steps": int,
                "violation_steps": int,
                "violation_free": bool,
                "broker_hours": float,
                "scale_ups": int,
                "scale_downs": int,
                "max_drawdown": int,
                "peak_brokers": int,
                "final_brokers": int,
                "min_balancedness": float,
                "brokers_by_step": [int],
                "needed_by_step": [int],
            }
        ],
    },
}


def validate_endpoint(endpoint: str, body: Any) -> None:
    """Validate a response body against the endpoint's registered schema.

    Unregistered endpoints pass (schemas are additive, like the reference's
    OpenAPI coverage)."""
    schema = RESPONSE_SCHEMAS.get(endpoint.upper())
    if schema is not None:
        validate(schema, body, f"$({endpoint})")
