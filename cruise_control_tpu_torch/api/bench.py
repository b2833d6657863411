"""Serving-plane load-generator bench: overload behavior as a number.

Port of ``cruise_control_tpu/api/bench.py``: ``run_bench(device=)`` builds the port's app on that device (``cuda`` unless ``cpu`` is asked for).

Boots the whole app (fake backend, trimmed goal list, admission knobs
tightened so overload actually happens), then slams it with hundreds of
concurrent REST clients — each a real thread holding a real HTTP connection —
issuing a mix of cheap reads (STATE) and solver-class work (unique-keyed
POST REBALANCE dryruns carrying a client ``deadline_ms`` budget).  Measured:

* **p95 admitted latency** — the wall metric the ``serving`` gate tier
  enforces (>25 % regression vs ``benchmarks/BENCH_SERVING_cpu.json`` fails).
* **goodput** — admitted requests per second of bench wall.
* **shed accuracy** — the overload *contract*: zero 5xx anywhere (admitted
  work answers 2xx, overload answers 429 — never a stack trace), and every
  shed response carries a ``Retry-After`` header.  Either violation is a
  hard error, not a threshold.

The workload is sized so both populations are guaranteed non-empty: far more
concurrent solver posts than execution slots + queue capacity, so the queue
fills, sheds fire (queue-full instantly, deadline for over-budget waiters),
and the admitted minority drains through the priority queue.  A bench run
where nothing was shed (or nothing was admitted) measured nothing — both are
infrastructure errors.

Shared by ``scripts/bench_serving.py`` (the CLI with the committed-baseline
gate) and the ``serving`` tier in ``obs/gate.py`` — one harness, one number.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device

WINDOW_MS = 60_000
TRIMMED_GOALS = "RackAwareGoal,ReplicaCapacityGoal,ReplicaDistributionGoal"

#: pinned workload (changing these requires --update-baseline)
CLIENTS = 200
STATE_READS_PER_CLIENT = 2
#: admission shape: slots + queue far below the client count so overload is
#: guaranteed (the burst sheds queue-full instantly; queued stragglers shed
#: on the queue timeout), and small enough that the 1-core box's GIL isn't
#: drowned in admitted solves — the bench measures the overload CONTRACT and
#: the admitted tail, not how many solves a laptop can grind through
MAX_ACTIVE_TASKS = 4
QUEUE_CAPACITY = 8
QUEUE_TIMEOUT_MS = 500
CLIENT_DEADLINE_MS = 30_000


def _build_app(device):
    from cruise_control_tpu_torch.app import CruiseControlTpuApp
    from cruise_control_tpu_torch.backend import FakeClusterBackend
    from cruise_control_tpu_torch.core.resources import Resource
    from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver

    backend = FakeClusterBackend()
    for b in range(4):
        backend.add_broker(b, rack=str(b % 2))
    for p in range(12):
        backend.create_partition(
            ("T", p), [p % 2, (p % 2 + 1) % 4], load=[1.5, 4e3, 6e3, 3e4]
        )
    props = {
        "partition.metrics.window.ms": WINDOW_MS,
        "num.partition.metrics.windows": 4,
        "metric.sampling.interval.ms": 3_600_000,
        "anomaly.detection.interval.ms": 3_600_000,
        "anomaly.detection.initial.pass": False,
        "broker.capacity.config.resolver.class":
            "cruise_control_tpu_torch.monitor.capacity.StaticCapacityResolver",
        "sample.store.class":
            "cruise_control_tpu_torch.monitor.samplestore.NoopSampleStore",
        "webserver.http.port": 0,
        "min.valid.partition.ratio": 0.5,
        "default.goals": TRIMMED_GOALS,
        # the overload shape under test
        "max.active.user.tasks": MAX_ACTIVE_TASKS,
        "admission.queue.capacity": QUEUE_CAPACITY,
        "admission.queue.timeout.ms": QUEUE_TIMEOUT_MS,
    }
    app = CruiseControlTpuApp(props, backend=backend, device=device)
    app.monitor.capacity_resolver = StaticCapacityResolver(
        {Resource.CPU: 100.0, Resource.NW_IN: 1e6, Resource.NW_OUT: 1e6,
         Resource.DISK: 1e7}
    )
    now = int(time.time() * 1000)
    for w in range(6):
        app.monitor.sample_once(now_ms=now + w * WINDOW_MS)
    return app


def _request(url: str, method: str = "GET") -> Dict[str, object]:
    t0 = time.monotonic()
    record: Dict[str, object] = {"method": method}
    try:
        req = urllib.request.Request(
            url, method=method, data=b"" if method == "POST" else None
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            resp.read()
            record["status"] = resp.status
            record["retry_after"] = resp.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        e.read()
        record["status"] = e.code
        record["retry_after"] = e.headers.get("Retry-After")
    except Exception as e:
        # transport failure (connection refused/reset, client timeout): a
        # shed without a 429, counted as a 5xx-equivalent contract violation
        record["status"] = 599
        record["retry_after"] = None
        record["error"] = f"{type(e).__name__}: {e}"
    record["latency_s"] = time.monotonic() - t0
    return record


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    data = sorted(values)
    idx = min(int(q * len(data)), len(data) - 1)
    return data[idx]


def run_bench(clients: int = CLIENTS, device: DeviceLike = None) -> dict:
    """One full serving bench: boot, warm, slam, account.  Returns the
    measurement doc (no gating — callers compare against their baseline).
    The app solves on ``device`` (``cuda`` unless ``device="cpu"``)."""
    app = _build_app(resolve_device(device))
    app.start(serve_http=True)
    records: List[Dict[str, object]] = []
    rec_lock = threading.Lock()
    try:
        base = f"http://127.0.0.1:{app.port}/kafkacruisecontrol"
        # warmup: build the kernels once outside the timed window — the
        # bench measures serving behavior, not the cold nvcc build.  Wait for
        # the warmup TASK to finish (not just its 202): a half-warm pool
        # would charge the first admitted clients the build wall
        warm = _request(f"{base}/rebalance?dryrun=true&warmup=1", "POST")
        if warm["status"] >= 500:
            raise RuntimeError(f"warmup rebalance failed: {warm}")
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"{base}/user_tasks", timeout=30) as resp:
                tasks = json.loads(resp.read()).get("userTasks", [])
            if tasks and all(
                t["Status"] in ("Completed", "CompletedWithError") for t in tasks
            ):
                break
            time.sleep(0.2)

        start_barrier = threading.Barrier(clients + 1)

        def client_thread(i: int) -> None:
            mine: List[Dict[str, object]] = []
            start_barrier.wait()
            # unique tag per client: every POST is a distinct user-task key,
            # so dedupe cannot collapse the overload away
            r = _request(
                f"{base}/rebalance?dryrun=true&client_tag={i}"
                f"&deadline_ms={CLIENT_DEADLINE_MS}",
                "POST",
            )
            r["class"] = "solver"
            mine.append(r)
            for _ in range(STATE_READS_PER_CLIENT):
                r = _request(f"{base}/state")
                r["class"] = "cheap"
                mine.append(r)
            with rec_lock:
                records.extend(mine)

        threads = [
            threading.Thread(target=client_thread, args=(i,), daemon=True)
            for i in range(clients)
        ]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        start_barrier.wait()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.monotonic() - t0
    finally:
        app.stop()

    admitted = [r for r in records if int(r["status"]) < 400]
    shed = [r for r in records if int(r["status"]) == 429]
    http_5xx = [r for r in records if int(r["status"]) >= 500]
    status_counts: Dict[str, int] = {}
    for r in records:
        k = str(r["status"])
        status_counts[k] = status_counts.get(k, 0) + 1
    failure_samples = [r.get("error") for r in http_5xx if r.get("error")][:3]
    other_4xx = [
        r for r in records if 400 <= int(r["status"]) < 500 and int(r["status"]) != 429
    ]
    sheds_missing_retry_after = [r for r in shed if not r["retry_after"]]
    admitted_lat = [float(r["latency_s"]) for r in admitted]
    solver_admitted = [r for r in admitted if r.get("class") == "solver"]

    return {
        "schema": 1,
        "platform": app.device.type,
        "workload": {
            "clients": clients,
            "state_reads_per_client": STATE_READS_PER_CLIENT,
            "max_active_tasks": MAX_ACTIVE_TASKS,
            "queue_capacity": QUEUE_CAPACITY,
            "queue_timeout_ms": QUEUE_TIMEOUT_MS,
            "client_deadline_ms": CLIENT_DEADLINE_MS,
        },
        "requests": len(records),
        "admitted": len(admitted),
        "solver_admitted": len(solver_admitted),
        "shed": len(shed),
        "http_5xx": len(http_5xx),
        "status_counts": status_counts,
        "failure_samples": failure_samples,
        "other_4xx": len(other_4xx),
        "sheds_missing_retry_after": len(sheds_missing_retry_after),
        "p50_admitted_s": round(_percentile(admitted_lat, 0.50), 4),
        "p95_admitted_s": round(_percentile(admitted_lat, 0.95), 4),
        "max_admitted_s": round(max(admitted_lat), 4) if admitted_lat else 0.0,
        "goodput_rps": round(len(admitted) / wall_s, 2) if wall_s > 0 else 0.0,
        "wall_s": round(wall_s, 4),
    }


def check_contract(m: dict) -> List[str]:
    """The hard (threshold-free) overload contract; empty list == pass."""
    errors: List[str] = []
    if m["http_5xx"]:
        errors.append(f"{m['http_5xx']} HTTP 5xx response(s) — overload must "
                      "shed with 429, never 500")
    if m["sheds_missing_retry_after"]:
        errors.append(f"{m['sheds_missing_retry_after']} shed response(s) "
                      "missing the Retry-After header")
    if not m["shed"]:
        errors.append("no request was shed — the workload did not overload "
                      "the server, the bench measured nothing")
    if not m["solver_admitted"]:
        errors.append("no solver-class request was admitted — the queue "
                      "never drained")
    return errors


if __name__ == "__main__":  # pragma: no cover - debugging entry
    print(json.dumps(run_bench(), indent=2))
