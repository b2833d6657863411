"""Replicated-read-plane fan-out bench: delta propagation as a number.

Port of ``cruise_control_tpu/replication/bench.py``: the follower children run the port's app with ``--device cpu`` (they only tail and serve WATCH, as the reference's children run on the CPU); ``run_bench(device=)`` names the writer side's device.

The first genuinely multi-process measurement in the codebase: the bench
process plays the fenced **writer** (a :class:`ControllerJournal` it appends
published standing sets to), boots ≥2 real **follower processes** — each a
full :class:`CruiseControlTpuApp` in ``replication.role=follower`` tailing
the same journal directory — and opens hundreds of concurrent long-poll
**watchers** against their WATCH endpoints.  Measured:

* **delta-propagation p95** — writer append wall-clock → watcher receipt,
  across every (watcher × published version) pair; the wall metric the
  ``replication`` gate tier enforces (>25 % regression vs
  ``benchmarks/BENCH_REPLICATION_cpu.json`` fails).
* **fan-out goodput** — delta deliveries per second of bench wall.
* **the replication contract** (threshold-free hard errors): zero 5xx
  anywhere on the watch path, zero version regressions observed by any
  watcher, and complete delivery — every watcher sees every published
  version.  A bench where fewer than 2 followers answered or fewer than the
  pinned watcher count ran measured nothing (infrastructure error).

Shared by ``scripts/bench_serving.py --replication`` (the CLI with the
committed-baseline gate) and the ``replication`` tier in ``obs/gate.py`` —
one harness, one number.  Follower children re-enter this module via
``python -m cruise_control_tpu_torch.replication.bench --follower-child``: they
write their bound port to ``--port-file`` and serve until stdin closes
(parent death ⇒ follower death, no orphans).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device

WINDOW_MS = 60_000
TRIMMED_GOALS = "RackAwareGoal,ReplicaCapacityGoal,ReplicaDistributionGoal"

#: pinned workload (changing these requires --update-baseline)
FOLLOWERS = 2
WATCHERS = 500
PUBLISHES = 10
PUBLISH_INTERVAL_S = 0.25
WATCH_TIMEOUT_MS = 2_000
#: per-watcher give-up deadline — generous vs the ~3 s publish phase; a
#: watcher that still hasn't seen the final version by then records the
#: missing deliveries as contract violations instead of hanging the bench
WATCH_DEADLINE_S = 60.0
FOLLOWER_BOOT_TIMEOUT_S = 120.0
#: the follower children's device: they only tail the journal and serve
#: WATCH, so they run on the CPU, as the reference's children do
FOLLOWER_DEVICE = "cpu"


def _follower_props(journal_dir: str) -> Dict[str, object]:
    return {
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
        "journal.dir": journal_dir,
        "replication.role": "follower",
    }


def follower_child_main(
    journal_dir: str, port_file: str, extra_props: Optional[dict] = None,
    device: DeviceLike = None,
) -> int:
    """``--follower-child`` entry: boot a follower app on the shared journal
    directory, on ``device``, publish the bound port, serve until stdin
    closes."""
    from cruise_control_tpu_torch.app import CruiseControlTpuApp
    from cruise_control_tpu_torch.backend import FakeClusterBackend

    backend = FakeClusterBackend()
    for b in range(4):
        backend.add_broker(b, rack=str(b % 2))
    props = _follower_props(journal_dir)
    props.update(extra_props or {})
    app = CruiseControlTpuApp(props, backend=backend, device=device)
    app.start(serve_http=True)
    try:
        tmp = port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(app.port))
        os.replace(tmp, port_file)   # atomic: the parent never reads a torn port
        sys.stdin.read()             # parent closes the pipe (or dies) ⇒ exit
    finally:
        app.stop()
    return 0


def _spawn_follower(
    journal_dir: str, port_file: str, extra_props: Optional[dict] = None
) -> subprocess.Popen:
    env = dict(os.environ)
    root = os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
    )
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "cruise_control_tpu_torch.replication.bench",
           "--follower-child", "--journal-dir", journal_dir,
           "--port-file", port_file, "--device", FOLLOWER_DEVICE]
    if extra_props:
        cmd += ["--extra-props", json.dumps(extra_props)]
    return subprocess.Popen(
        cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, env=env, cwd=root,
    )


def _await_port(port_file: str, proc: subprocess.Popen,
                deadline: float) -> int:
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            err = (proc.stderr.read() or b"").decode(errors="replace")
            raise RuntimeError(
                f"follower child died rc={proc.returncode}: {err[-2000:]}"
            )
        try:
            with open(port_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            time.sleep(0.1)
    raise RuntimeError(f"follower never wrote {port_file}")


def _get(url: str, timeout: float) -> Dict[str, object]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return {"status": resp.status, "body": json.loads(resp.read())}
    except urllib.error.HTTPError as e:
        e.read()
        return {"status": e.code, "body": None}
    except Exception as e:
        # transport failure: a 5xx-equivalent contract violation
        return {"status": 599, "body": None,
                "error": f"{type(e).__name__}: {e}"}


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    data = sorted(values)
    idx = min(int(q * len(data)), len(data) - 1)
    return data[idx]


class _Watcher:
    """One long-poll subscriber: re-arms against its follower until it has
    seen the final version (or the deadline), recording receipt times."""

    def __init__(self, port: int, stop_version: int) -> None:
        self.port = port
        self.stop_version = stop_version
        self.seen: Dict[int, float] = {}      # version -> receipt monotonic
        self.requests = 0
        self.http_5xx = 0
        self.regressions = 0
        self.resyncs = 0
        self.last_version = -1

    def run(self, barrier: threading.Barrier) -> None:
        base = f"http://127.0.0.1:{self.port}/kafkacruisecontrol/watch"
        since = 0
        barrier.wait()
        deadline = time.monotonic() + WATCH_DEADLINE_S
        while time.monotonic() < deadline:
            r = _get(f"{base}?since={since}&timeout_ms={WATCH_TIMEOUT_MS}",
                     timeout=WATCH_TIMEOUT_MS / 1000.0 + 30.0)
            self.requests += 1
            if r["status"] >= 500:
                self.http_5xx += 1
                time.sleep(0.1)
                continue
            body = r["body"]
            if r["status"] != 200 or not isinstance(body, dict):
                continue
            now = time.monotonic()
            if body.get("resync"):
                self.resyncs += 1
            for d in body.get("deltas", ()):
                if d.get("kind") != "published":
                    continue
                v = int(d["version"])
                if v < self.last_version:
                    self.regressions += 1
                self.last_version = max(self.last_version, v)
                self.seen.setdefault(v, now)
            since = int(body.get("since", since))
            if self.last_version >= self.stop_version:
                return


def run_bench(
    followers: int = FOLLOWERS,
    watchers: int = WATCHERS,
    publishes: int = PUBLISHES,
    device: DeviceLike = None,
) -> dict:
    """One full replication bench: spawn followers, open watchers, publish,
    account.  Returns the measurement doc (no gating — callers compare
    against their baseline).  ``device`` is the writer side's (``cuda``
    unless ``device="cpu"``; the writer here only appends to the journal);
    the followers run on :data:`FOLLOWER_DEVICE`."""
    writer_device = resolve_device(device)
    from cruise_control_tpu_torch.controller.standing import (
        ControllerJournal,
        StandingProposalSet,
    )
    from cruise_control_tpu_torch.core.journal import Journal

    tmp = tempfile.mkdtemp(prefix="ccrepl-bench-")
    journal = ControllerJournal(Journal(os.path.join(tmp, "controller")))
    journal.fence(1)

    def _set(version: int) -> StandingProposalSet:
        return StandingProposalSet(
            version=version, created_ms=int(time.time() * 1000),
            trigger="bench", drift=1.0, proposals=[],
        )

    # version 1 exists before any follower boots: every follower starts with
    # a live standing set, and v1 receipt times would predate their watchers
    # — propagation is measured on versions 2..publishes+1 only
    journal.published(_set(1))

    procs: List[subprocess.Popen] = []
    t_bench0 = time.monotonic()
    try:
        boot_deadline = time.monotonic() + FOLLOWER_BOOT_TIMEOUT_S
        ports: List[int] = []
        for i in range(followers):
            procs.append(_spawn_follower(tmp, os.path.join(tmp, f"port-{i}")))
        for i, proc in enumerate(procs):
            ports.append(
                _await_port(os.path.join(tmp, f"port-{i}"), proc, boot_deadline)
            )
        # followers answer WATCH before the clock starts (boot ≠ propagation)
        for port in ports:
            while time.monotonic() < boot_deadline:
                r = _get(
                    f"http://127.0.0.1:{port}/kafkacruisecontrol/watch"
                    "?since=0&timeout_ms=0", timeout=10.0,
                )
                if r["status"] == 200:
                    break
                time.sleep(0.1)

        stop_version = publishes + 1
        subs = [_Watcher(ports[i % len(ports)], stop_version)
                for i in range(watchers)]
        barrier = threading.Barrier(watchers + 1)
        threads = [threading.Thread(target=s.run, args=(barrier,), daemon=True)
                   for s in subs]
        for t in threads:
            t.start()
        barrier.wait()

        t_pub: Dict[int, float] = {}
        for v in range(2, stop_version + 1):
            t_pub[v] = time.monotonic()
            journal.published(_set(v))
            time.sleep(PUBLISH_INTERVAL_S)
        for t in threads:
            t.join(timeout=WATCH_DEADLINE_S + 30)
        wall_s = time.monotonic() - t_bench0
    finally:
        for proc in procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()

    latencies: List[float] = []
    deliveries = 0
    for s in subs:
        for v, t0 in t_pub.items():
            t_seen = s.seen.get(v)
            if t_seen is not None:
                deliveries += 1
                latencies.append(max(0.0, t_seen - t0))
    expected = watchers * len(t_pub)
    return {
        "schema": 1,
        "platform": writer_device.type,
        "follower_device": FOLLOWER_DEVICE,
        "workload": {
            "followers": followers,
            "watchers": watchers,
            "publishes": publishes,
            "publish_interval_ms": int(PUBLISH_INTERVAL_S * 1000),
            "watch_timeout_ms": WATCH_TIMEOUT_MS,
        },
        "followers_serving": len(set(s.port for s in subs)),
        "watch_requests": sum(s.requests for s in subs),
        "deliveries": deliveries,
        "missing_deliveries": expected - deliveries,
        "http_5xx": sum(s.http_5xx for s in subs),
        "version_regressions": sum(s.regressions for s in subs),
        "resyncs": sum(s.resyncs for s in subs),
        "p50_propagation_s": round(_percentile(latencies, 0.50), 4),
        "p95_propagation_s": round(_percentile(latencies, 0.95), 4),
        "max_propagation_s": round(max(latencies), 4) if latencies else 0.0,
        "goodput_deliveries_per_s": (
            round(deliveries / wall_s, 2) if wall_s > 0 else 0.0
        ),
        "wall_s": round(wall_s, 4),
    }


def check_contract(m: dict) -> List[str]:
    """The hard (threshold-free) replication contract; empty list == pass."""
    errors: List[str] = []
    if m["http_5xx"]:
        errors.append(f"{m['http_5xx']} HTTP 5xx/transport failure(s) on the "
                      "watch path — followers must answer or 503-with-"
                      "Retry-After, never break")
    if m["version_regressions"]:
        errors.append(f"{m['version_regressions']} watcher(s) observed a "
                      "version regression — the one invariant replication "
                      "must never break")
    if m["missing_deliveries"]:
        errors.append(f"{m['missing_deliveries']} (watcher × version) "
                      "deliveries never arrived — fan-out is incomplete")
    if m["followers_serving"] < 2:
        errors.append(f"only {m['followers_serving']} follower process(es) "
                      "served watchers — the bench needs ≥2 real processes")
    if m["workload"]["watchers"] < 2 or not m["deliveries"]:
        errors.append("no fan-out happened — the bench measured nothing")
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="replication-bench")
    ap.add_argument("--follower-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--journal-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--extra-props", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None,
                    help="the writer side's device (a follower child's own)")
    ap.add_argument("--watchers", type=int, default=WATCHERS)
    ap.add_argument("--followers", type=int, default=FOLLOWERS)
    args = ap.parse_args(argv)
    if args.follower_child:
        return follower_child_main(
            args.journal_dir, args.port_file,
            json.loads(args.extra_props) if args.extra_props else None,
            device=args.device,
        )
    print(json.dumps(
        run_bench(followers=args.followers, watchers=args.watchers,
                  device=args.device), indent=2
    ))
    return 0


if __name__ == "__main__":  # pragma: no cover - debugging / child entry
    sys.exit(main())
