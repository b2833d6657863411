"""Benchmark cold-restart-to-ready over a populated crash-recovery journal.

Port of ``scripts/bench_recovery.py``, with its pinned workload: 50 finished
executions of 8 tasks (start, per-task transitions, finish), one interrupted
execution with its 8 tasks in flight, and 2,000 completed user tasks with
embedded result bodies.  Measured: the recovery wall a restarted process
pays before it can serve -- ``Executor.recover()`` (journal replay and
backend reconciliation) plus the ``UserTaskManager`` journal replay -- and
the records, executions, tasks and user tasks recovered.  Host only: no
tensor is made.

Gate (the JAX script's): the best wall of ``--repeats`` runs against the
port's committed ``obs/baselines/BENCH_RECOVERY_<device>.json``, where the
device names the host the baseline was taken on (``cuda``: a card's host,
the default; ``cpu``: a host without one).  A wall more than 25 % over it
(after a 0.25 s floor, times ``CC_TPU_GATE_WALL_SLACK``) exits 1; a
record-count mismatch or wrong recovered counts exit 2.

    python -m cruise_control_tpu_torch.executor.recovery_bench [--device cpu] [--update-baseline]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.api.usertasks import UserTaskManager
from cruise_control_tpu_torch.backend import FakeClusterBackend
from cruise_control_tpu_torch.core.journal import Journal
from cruise_control_tpu_torch.executor import ExecutionJournal, Executor
from cruise_control_tpu_torch.executor.engine import ExecutionSummary
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskState, TaskType

SCHEMA = 1
#: pinned workload (changing these requires --update-baseline).  The
#: execution journal compacts itself after every finished execution, so the
#: replayed state is the interrupted execution plus the user-task retention
#: window, which carries the bulk of the record count
EXECUTIONS = 50
TASKS_PER_EXECUTION = 8
USER_TASKS = 2000
PARTITIONS = 64
BROKERS = 8

MAX_WALL_RATIO = 1.25
WALL_FLOOR_S = 0.25


def baseline_path(device: str = "cuda") -> str:
    from cruise_control_tpu_torch.obs import gate

    return os.path.join(gate._repo_root(), gate.baseline_path(device, "BENCH_RECOVERY"))


def _backend() -> FakeClusterBackend:
    b = FakeClusterBackend()
    for i in range(BROKERS):
        b.add_broker(i, rack=str(i % 2))
    for p in range(PARTITIONS):
        b.create_partition(("T", p), [p % BROKERS, (p + 1) % BROKERS], load=[1.0, 1e3, 1e3, 1e4])
    return b


def _prop(p: int) -> ExecutionProposal:
    # replica action only (the leader stays): recovering the interrupted
    # execution then needs no leader election, so the measurement is journal
    # replay and reconciliation
    lead = p % BROKERS
    return ExecutionProposal(
        tp=("T", p % PARTITIONS), partition_size=1.0, old_leader=lead,
        old_replicas=(lead, (p + 1) % BROKERS), new_replicas=(lead, (p + 2) % BROKERS),
    )


def populate(journal_dir: str) -> dict:
    t0 = time.monotonic()
    ej = ExecutionJournal(Journal(os.path.join(journal_dir, "executor")))
    for e in range(1, EXECUTIONS + 1):
        props = [_prop(e * TASKS_PER_EXECUTION + i) for i in range(TASKS_PER_EXECUTION)]
        ej.execution_started(e, props)
        for p in props:
            t = ExecutionTask(p, TaskType.INTER_BROKER_REPLICA_ACTION)
            t.state = TaskState.IN_PROGRESS
            ej.task_transition(e, t)
            t.state = TaskState.COMPLETED
            ej.task_transition(e, t)
        ej.execution_finished(ExecutionSummary(
            execution_id=e, stopped=False, completed=len(props), dead=0, aborted=0, duration_s=0.1,
        ))
    # the interrupted one: started, tasks IN_PROGRESS, no finished record
    interrupted = EXECUTIONS + 1
    props = [_prop(i) for i in range(TASKS_PER_EXECUTION)]
    ej.execution_started(interrupted, props)
    for p in props:
        t = ExecutionTask(p, TaskType.INTER_BROKER_REPLICA_ACTION)
        t.state = TaskState.IN_PROGRESS
        ej.task_transition(interrupted, t)
    ej.close()

    uj = Journal(os.path.join(journal_dir, "usertasks"))
    for i in range(USER_TASKS):
        uj.append({"type": "user_task_created", "task_id": f"task-{i}", "endpoint": "REBALANCE",
                   "created_ms": int(time.time() * 1000), "parent_id": f"req-{i}"})
        uj.append({"type": "user_task_finished", "task_id": f"task-{i}", "status": "Completed",
                   "ts_ms": int(time.time() * 1000), "result": {"numProposals": i, "proposals": []}})
    uj.close()
    return {"populate_s": round(time.monotonic() - t0, 3)}


def measure(journal_dir: str) -> dict:
    backend = _backend()
    t0 = time.monotonic()
    executor = Executor(backend, journal=ExecutionJournal(Journal(os.path.join(journal_dir, "executor"))))
    recovered = executor.recover()
    manager = UserTaskManager(journal=Journal(os.path.join(journal_dir, "usertasks")))
    wall = time.monotonic() - t0
    manager.shutdown()
    return {
        "wall_s": round(wall, 4),
        "records": executor.last_recovery_stats.records + manager.recovered_records,
        "executions_recovered": len(recovered),
        "recovered_tasks": sum(s.total for s in recovered),
        "user_tasks_recovered": manager.recovered_tasks,
    }


def run_bench(repeats: int = 2) -> dict:
    """The best (least wall) of ``repeats`` populate-and-recover runs."""
    results = []
    for _ in range(max(repeats, 1)):
        tmp = tempfile.mkdtemp(prefix="cc-bench-recovery-")
        try:
            pop = populate(tmp)
            m = measure(tmp)
            m.update(pop)
            results.append(m)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    best = min(results, key=lambda r: r["wall_s"])
    return {
        "schema": SCHEMA,
        "workload": {"executions": EXECUTIONS, "tasks_per_execution": TASKS_PER_EXECUTION, "user_tasks": USER_TASKS},
        **best,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="recovery_bench")
    ap.add_argument("--device", default="cuda",
                    help="the host whose baseline applies: cuda (a card's host) or cpu")
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--repeats", type=int, default=2, help="recovery runs; the best wall is gated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    doc = run_bench(args.repeats)
    print(json.dumps(doc), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
    path = baseline_path(args.device)
    if args.update_baseline:
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"baseline written: {path}", file=sys.stderr)
        return 0
    if not os.path.exists(path):
        print(f"missing baseline {path}; run --update-baseline", file=sys.stderr)
        return 2
    with open(path) as f:
        base = json.load(f)
    if base.get("records") != doc["records"]:
        print(f"workload mismatch: baseline {base.get('records')} records vs measured {doc['records']} "
              "-- regenerate the baseline", file=sys.stderr)
        return 2
    if doc["executions_recovered"] != 1 or doc["user_tasks_recovered"] != USER_TASKS:
        print("recovery self-check failed (wrong recovered counts)", file=sys.stderr)
        return 2
    slack = float(os.environ.get("CC_TPU_GATE_WALL_SLACK", "1.0"))
    budget = base["wall_s"] * MAX_WALL_RATIO * slack + WALL_FLOOR_S
    if doc["wall_s"] > budget:
        print(f"RECOVERY REGRESSION: wall {doc['wall_s']:.3f}s > budget {budget:.3f}s (baseline "
              f"{base['wall_s']:.3f}s × {MAX_WALL_RATIO} × slack {slack} + {WALL_FLOOR_S}s floor)", file=sys.stderr)
        return 1
    print(f"recovery gate OK: wall {doc['wall_s']:.3f}s <= budget {budget:.3f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
