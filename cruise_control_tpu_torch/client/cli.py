"""``cctpu`` — command-line front-end for the REST API.

Port of ``cruise_control_tpu/client/cli.py`` (copied whole).

Counterpart of the reference's ``cccli`` (``cruisecontrolclient/client/cccli.py``):
one subcommand per endpoint, JSON output, ``--add-parameter`` escape hatch.
Run as ``python -m cruise_control_tpu_torch.client.cli <endpoint> [options]``.
"""

from __future__ import annotations

import argparse
import json
import sys

from cruise_control_tpu_torch.client.client import ClientError, CruiseControlClient


def _int_list(spec: str):
    return [int(x) for x in spec.split(",") if x]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cctpu", description=__doc__)
    ap.add_argument("-a", "--address", default="http://127.0.0.1:9090",
                    help="cruise-control-tpu base URL")
    ap.add_argument("-u", "--user", default=None)
    ap.add_argument("-p", "--password", default=None)
    ap.add_argument("--no-wait", action="store_true",
                    help="return the User-Task-ID instead of polling to completion")
    sub = ap.add_subparsers(dest="endpoint", required=True)

    for name in ("state", "load", "proposals", "kafka_cluster_state", "user_tasks",
                 "review_board", "permissions", "bootstrap", "train"):
        sub.add_parser(name)

    sub.add_parser(
        "metrics",
        help="print the Prometheus text exposition page (GET /metrics)",
    )

    hz = sub.add_parser(
        "health",
        help="liveness + readiness ladder (GET /healthz): recovering -> "
             "monitor_warming -> ready, with recovery accounting",
    )
    hz.add_argument("--readiness", action="store_true",
                    help="probe mode: exit 1 (HTTP 503) until the server is ready")

    ct = sub.add_parser(
        "controller",
        help="continuous control loop: status (default), pause, resume, or "
             "force one tick (GET/POST /controller)",
    )
    ct.add_argument("action", nargs="?", default="status",
                    choices=["status", "pause", "resume", "tick"])
    ct.add_argument("--reason", default="cctpu",
                    help="operator note recorded with pause/resume")

    fl = sub.add_parser(
        "fleet",
        help="multi-tenant fleet controller: status (default), pause, "
             "resume, or force one fleet tick (GET/POST /fleet); --tenant "
             "narrows status to one tenant or flips/forces just its lane",
    )
    fl.add_argument("action", nargs="?", default="status",
                    choices=["status", "pause", "resume", "tick"])
    fl.add_argument("--tenant", default=None,
                    help="tenant name (default: the whole fleet)")
    fl.add_argument("--reason", default="cctpu",
                    help="operator note recorded with pause/resume")

    sl = sub.add_parser(
        "slo",
        help="SLO burn-rate engine (GET /slo): every declared objective "
             "with its latest value, per-window-pair burn rates, and alert "
             "state, plus the self-monitoring sampler's accounting",
    )
    sl.add_argument("--slo", default=None,
                    help="narrow to one declared SLO by name")

    wt = sub.add_parser(
        "watch",
        help="standing-proposal-set deltas via long-poll (GET /watch): "
             "published/superseded/drained events keyed by version, instead "
             "of polling user_tasks",
    )
    wt.add_argument("--since", type=int, default=0,
                    help="delta cursor: last seq already seen (default 0)")
    wt.add_argument("--timeout-ms", type=int, default=30_000,
                    help="long-poll park time per request (server-capped)")
    wt.add_argument("--follow", action="store_true",
                    help="re-arm forever, printing one JSON delta per line")

    tr = sub.add_parser(
        "traces",
        help="flight-recorder records (GET), or — with --traces-json and "
             "--policies-json — a batched autoscaling-policy rollout (POST): "
             "every (trace × policy) pair stepped through time with one "
             "host sync",
    )
    tr.add_argument("--kind", default=None,
                    help="optimize | execution | user_task | simulate | "
                         "rollout | replay | admission | ...")
    tr.add_argument("--trace-id", default=None)
    tr.add_argument("--parent-id", default=None,
                    help="X-Request-Id: walks request -> task -> optimize -> execution")
    tr.add_argument("--limit", type=int, default=50)
    tr.add_argument("--traces-json", default=None,
                    help="JSON list of LoadTrace specs (segments: diurnal | "
                         "ramp | spike | topic_growth | topic_spike | noise) "
                         "— switches to the rollout POST")
    tr.add_argument("--policies-json", default=None,
                    help="JSON list of AutoscalePolicy specs "
                         "(scale_out_threshold, scale_in_threshold, "
                         "cooldown_ticks, step_brokers, min/max_brokers)")
    tr.add_argument("--goals", default=None, help="comma-separated goal names")

    pl = sub.add_parser("partition_load")
    pl.add_argument("--resource", default="DISK")
    pl.add_argument("--entries", type=int, default=20)

    for name in ("rebalance", "fix_offline_replicas", "rightsize"):
        p = sub.add_parser(name)
        p.add_argument("--dryrun", action="store_true", default=False)
        p.add_argument("--execute", dest="dryrun", action="store_false")
        if name == "rebalance":
            p.add_argument("--goals", default=None, help="comma-separated goal names")
            p.add_argument("--excluded-topics", default=None)
            p.add_argument("--request-id", default=None,
                           help="X-Request-Id to correlate the operation's traces")
            p.add_argument("--deadline-ms", type=int, default=None,
                           help="client budget: bounds the admission-queue "
                                "wait (over-deadline = 429 + Retry-After) "
                                "and the solve itself (expiry returns "
                                "best-so-far marked degraded=true)")
        if name == "rightsize":
            p.add_argument("--load-factor", type=float, default=None,
                           help="plan capacity for current load × this factor")
            p.add_argument("--trace-json", default=None,
                           help="JSON LoadTrace spec: adds the planning "
                                "horizon (peak min-brokers-needed over the "
                                "trace at the current broker count)")

    for name in ("add_broker", "remove_broker", "demote_broker"):
        p = sub.add_parser(name)
        p.add_argument("brokers", help="comma-separated broker ids")
        p.add_argument("--dryrun", action="store_true", default=False)
        p.add_argument("--execute", dest="dryrun", action="store_false")

    td = sub.add_parser("topic_configuration")
    td.add_argument("topic")
    td.add_argument("replication_factor", type=int)
    td.add_argument("--dryrun", action="store_true", default=False)
    td.add_argument("--execute", dest="dryrun", action="store_false")

    rd = sub.add_parser("remove_disks")
    rd.add_argument("spec", help="brokerid-logdir[,brokerid-logdir...]")
    rd.add_argument("--dryrun", action="store_true", default=False)
    rd.add_argument("--execute", dest="dryrun", action="store_false")

    sub.add_parser("stop_proposal_execution")
    for name in ("pause_sampling", "resume_sampling"):
        p = sub.add_parser(name)
        p.add_argument("--reason", default="cctpu")

    rv = sub.add_parser("review")
    rv.add_argument("--approve", default=None, help="comma-separated review ids")
    rv.add_argument("--discard", default=None, help="comma-separated review ids")
    rv.add_argument("--reason", default=None)

    sm = sub.add_parser(
        "simulate",
        help="batched what-if sweep: hypothetical broker/load/capacity changes",
    )
    sm.add_argument("--scenarios-json", default=None,
                    help="JSON list of scenario specs (full Scenario wire format)")
    sm.add_argument("--add-broker-counts", default=None,
                    help="comma-separated added-broker counts to sweep")
    sm.add_argument("--load-factors", default=None,
                    help="comma-separated global load multipliers to sweep")
    sm.add_argument("--remove-brokers", default=None,
                    help="comma-separated broker ids to decommission in every scenario")
    sm.add_argument("--kill-brokers", default=None,
                    help="comma-separated broker ids to fail in every scenario")
    sm.add_argument("--drop-rack", type=int, default=None,
                    help="rack id whose brokers all fail in every scenario")
    sm.add_argument("--deep", action="store_true",
                    help="run the full goal optimizer per scenario")
    sm.add_argument("--goals", default=None, help="comma-separated goal names")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    client = CruiseControlClient(args.address, args.user, args.password)
    wait = not args.no_wait
    try:
        ep = args.endpoint
        if ep in ("state", "load", "proposals", "kafka_cluster_state", "user_tasks",
                  "review_board", "permissions", "bootstrap", "train"):
            out = getattr(client, ep)()
        elif ep == "metrics":
            # exposition format IS the output format — no JSON re-wrap
            print(client.metrics(), end="")
            return 0
        elif ep == "health":
            out = client.healthz(readiness=args.readiness)
        elif ep == "controller":
            if args.action == "status":
                out = client.controller_status()
            elif args.action == "pause":
                out = client.controller_pause(reason=args.reason)
            elif args.action == "resume":
                out = client.controller_resume(reason=args.reason)
            else:
                out = client.controller_tick()
        elif ep == "fleet":
            if args.action == "status":
                out = client.fleet_status(tenant=args.tenant)
            elif args.action == "pause":
                out = client.fleet_pause(reason=args.reason, tenant=args.tenant)
            elif args.action == "resume":
                out = client.fleet_resume(reason=args.reason, tenant=args.tenant)
            else:
                out = client.fleet_tick(tenant=args.tenant)
        elif ep == "slo":
            out = client.slo(name=args.slo)
        elif ep == "watch":
            if args.follow:
                for delta in client.watch_iter(
                    since=args.since, timeout_ms=args.timeout_ms
                ):
                    print(json.dumps(delta))
                return 0
            out = client.watch(since=args.since, timeout_ms=args.timeout_ms)
        elif ep == "traces":
            if args.traces_json or args.policies_json:
                if not (args.traces_json and args.policies_json):
                    raise SystemExit(
                        "rollout needs BOTH --traces-json and --policies-json"
                    )
                out = client.trace_rollout(
                    traces=json.loads(args.traces_json),
                    policies=json.loads(args.policies_json),
                    goals=args.goals.split(",") if args.goals else None,
                    wait=wait,
                )
            else:
                out = client.traces(kind=args.kind, trace_id=args.trace_id,
                                    parent_id=args.parent_id, limit=args.limit)
        elif ep == "partition_load":
            out = client.partition_load(resource=args.resource, entries=args.entries)
        elif ep == "rebalance":
            goals = args.goals.split(",") if args.goals else None
            out = client.rebalance(dryrun=args.dryrun, goals=goals,
                                   excluded_topics=args.excluded_topics, wait=wait,
                                   request_id=args.request_id,
                                   deadline_ms=args.deadline_ms)
        elif ep in ("add_broker", "remove_broker", "demote_broker"):
            out = getattr(client, ep)(_int_list(args.brokers), dryrun=args.dryrun, wait=wait)
        elif ep == "fix_offline_replicas":
            out = client.fix_offline_replicas(dryrun=args.dryrun, wait=wait)
        elif ep == "rightsize":
            out = client.rightsize(
                dryrun=args.dryrun, load_factor=args.load_factor,
                trace=json.loads(args.trace_json) if args.trace_json else None,
                wait=wait,
            )
        elif ep == "simulate":
            out = client.simulate(
                scenarios=json.loads(args.scenarios_json) if args.scenarios_json else None,
                add_broker_counts=_int_list(args.add_broker_counts) if args.add_broker_counts else None,
                load_factors=[float(x) for x in args.load_factors.split(",")] if args.load_factors else None,
                remove_brokers=_int_list(args.remove_brokers) if args.remove_brokers else None,
                kill_brokers=_int_list(args.kill_brokers) if args.kill_brokers else None,
                drop_rack=args.drop_rack,
                deep=args.deep,
                goals=args.goals.split(",") if args.goals else None,
                wait=wait,
            )
        elif ep == "topic_configuration":
            out = client.topic_configuration(args.topic, args.replication_factor,
                                             dryrun=args.dryrun, wait=wait)
        elif ep == "remove_disks":
            pairs = []
            for part in args.spec.split(","):
                b, _, d = part.partition("-")
                pairs.append((int(b), d))
            out = client.remove_disks(pairs, dryrun=args.dryrun, wait=wait)
        elif ep == "stop_proposal_execution":
            out = client.stop_proposal_execution()
        elif ep in ("pause_sampling", "resume_sampling"):
            out = getattr(client, ep)(reason=args.reason)
        elif ep == "review":
            out = client.review(
                approve=_int_list(args.approve) if args.approve else None,
                discard=_int_list(args.discard) if args.discard else None,
                reason=args.reason,
            )
        else:  # pragma: no cover - argparse guards
            raise SystemExit(2)
    except ClientError as e:
        err = {"status": e.status, "error": e.body}
        if e.retry_after_s is not None:
            # shed (429) / not-ready (503): surface the server's backoff hint
            err["retryAfterS"] = e.retry_after_s
        print(json.dumps(err, indent=2), file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
