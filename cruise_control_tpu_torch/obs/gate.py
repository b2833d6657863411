"""Self-enforcing regression gate over the port's committed baselines.

Port of ``cruise_control_tpu/obs/gate.py``.  The gate runs bench tiers --
BASELINE.md config #1, a scaled-down config #2, the 8-rank sharded solve,
and the harnesses of the service's planes -- each in a child process under a
**hard timeout**, then compares wall-clock, host syncs, residual hard
violations and balancedness against committed baselines:

- ``cruise_control_tpu_torch/obs/baselines/GATE_BASELINE_<device>.json``:
  this gate's own tier numbers on ``cpu`` or ``cuda``, regenerated with
  ``--update-baseline --device <device>`` whenever a change legitimately
  moves them (commit the diff; the review is the approval).  A ``cuda``
  baseline names the card and its power limit (``nvidia-smi``).
- ``BENCH_<HARNESS>_<device>.json`` beside it: the harness tiers'
  artifacts, written by ``python -m cruise_control_tpu_torch.obs.bench_baselines``;
  the controller, fleet, serving, replication, traces and slo tiers fall
  back to them when the gate baseline has no entry (as the JAX gate falls
  back to its ``benchmarks/BENCH_*_cpu.json``), and the sharded tier
  validates ``BENCH_SHARDED_<device>.json``.
- ``BENCH_FLAGSHIP_<device>.json``: config #2's solve on the device (the
  flagship record); residual hard violations and host syncs are
  cross-checked so the gate cannot drift away from it.

The gate reads no JAX number.  The port's measures keep the JAX keys:
``num_dispatches`` is the optimizer's host syncs, ``span_dispatch_sum`` the
sum over the port's flight record's spans, and ``warm_compile_events`` the
``nvcc`` builds in the warm run's record (0 when warm).

    python -m cruise_control_tpu_torch.obs.gate [--device cuda|cpu] [--tiers a,b] [--update-baseline]

Tiers run on ``--device`` (``cuda`` unless ``cpu`` is asked for); without a
card the gate raises naming the device (``core/backend_probe.py``).  Each
child is ``python -m cruise_control_tpu_torch.obs.gate --run-tier NAME
--device DEV``.

Exit codes: 0 pass, 1 regression/timeout/tier error, 2 infrastructure error
(missing baseline, unknown tier).  Thresholds: >25 % wall regression (after
an absolute noise floor), any hard-violation increase, any host-sync
increase over the gate baseline (+2 over the flagship record), a
balancedness drop >1.0, or ANY kernel build during the timed warm run fail
the gate.  ``CC_TPU_GATE_WALL_SLACK`` multiplies the wall allowance for
shared or noisy hosts -- the sync and violation gates stay exact
everywhere.  The harness tiers keep the JAX contracts verbatim, the JAX
dispatch budgets among them: the port's warm controller tick makes more
host syncs than its budget (ROADMAP C5), so the ``controller`` and ``fleet``
tiers report that breach as a tier error until the ticks make fewer.

Test hooks: ``--inject-sleep S`` sleeps inside the timed window (a
synthetic slowdown), ``--baseline`` points at a tampered baseline,
``--in-process`` skips the subprocess isolation (no hard timeout).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Mapping, Optional

GATE_SCHEMA = 1
DEFAULT_TIMEOUT_S = float(os.environ.get("CC_TPU_GATE_TIMEOUT_S", "600"))
#: the gate's device unless ``--device`` says otherwise
DEFAULT_DEVICE = "cuda"
#: the port's committed numbers, relative to the repository root
BASELINE_DIR = os.path.join("cruise_control_tpu_torch", "obs", "baselines")
#: dispatch-layout slack against the flagship record only: a committed
#: record may predate a deliberate layout change by one round
BENCH_DISPATCH_SLACK = 2


def baseline_path(device: str, kind: str = "GATE_BASELINE") -> str:
    """``BASELINE_DIR/<kind>_<device type>.json``, relative to the repository root."""
    return os.path.join(BASELINE_DIR, f"{kind}_{str(device).split(':')[0]}.json")


#: the baseline the gate reads when neither ``--baseline`` nor ``--device`` is given
DEFAULT_BASELINE = baseline_path(DEFAULT_DEVICE)


@dataclasses.dataclass(frozen=True)
class GateThresholds:
    """What counts as a regression (>25 % wall or any hard-violation
    increase fails)."""

    max_wall_ratio: float = 1.25
    #: absolute allowance added to the wall budget -- sub-100 ms tiers are
    #: scheduler-noise-dominated and must not flap
    wall_floor_s: float = 0.25
    max_extra_dispatches: int = 0
    max_balancedness_drop: float = 1.0
    #: absolute allowance on the sharded tier's overhead ratio (sharded /
    #: single-device warm wall) -- sub-second warm walls make the ratio jumpy
    overhead_floor: float = 0.75


@dataclasses.dataclass(frozen=True)
class GateTier:
    name: str
    description: str
    #: ``build(device) -> (optimizer, state, ctx)``
    build: Optional[Callable]
    #: measure a second (post-build) run as the wall metric; single-run
    #: tiers gate total wall including the kernels' build and the spawn
    warm_runs: bool = True
    #: cross-check scale-independent metrics against the flagship record
    bench_comparable: bool = True
    #: self-contained tiers: ``runner(inject_sleep_s, device) -> record``
    #: replacing the build/optimize flow entirely
    runner: Optional[Callable[[float, object], dict]] = None


# -- tier builders ------------------------------------------------------------------

#: BASELINE.md config #1: the deterministic tiny fixture scale (3 brokers / 20 partitions)
CONFIG1 = dict(
    num_racks=2, num_brokers=3, num_topics=2, num_partitions=20,
    replication_factor=2, distribution="exponential", skew_brokers=1,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=3,
)
#: bench.py's config #2 shape at 40 brokers / 2k partitions instead of 100 / 10k
CONFIG2_SMALL = dict(
    num_racks=5, num_brokers=40, num_topics=20, num_partitions=2000,
    replication_factor=3, distribution="exponential", skew_brokers=10,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)
#: the multichip dryrun's cluster, sharded over 8 ranks
MESH8 = dict(
    num_racks=4, num_brokers=32, num_topics=8, num_partitions=256,
    replication_factor=3, distribution="exponential", skew_brokers=8,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=5,
)
MESH8_RANKS = 8
#: the test-only tier's cluster
SMOKE = dict(
    num_racks=2, num_brokers=4, num_topics=2, num_partitions=24,
    replication_factor=2, distribution="exponential", skew_brokers=1,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=9,
)
#: the sharded tier's cluster and goals
SHARDED = dict(
    num_racks=4, num_brokers=12, num_topics=8, num_partitions=1500,
    replication_factor=3, distribution="exponential", skew_brokers=3,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=13,
)
SHARDED_RANKS = 8


def _synthetic(device, **kw):
    from cruise_control_tpu_torch.analyzer import GoalContext
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, _ = generate(SyntheticSpec(**kw), device=device)
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device=device)
    return state, ctx


def _build_config1(device):
    """BASELINE.md config #1, full default goal list."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    state, ctx = _synthetic(device, **CONFIG1)
    return GoalOptimizer(enable_heavy_goals=True, device=device), state, ctx


def _build_config2_small(device):
    """Scaled-down BASELINE.md config #2: the same skewed-exponential
    feasible-but-tight instance, full default goals."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    state, ctx = _synthetic(device, **CONFIG2_SMALL)
    return GoalOptimizer(enable_heavy_goals=True, device=device), state, ctx


def _smoke_goals():
    from cruise_control_tpu_torch.analyzer import goals_base as G

    goals = (G.RACK_AWARE, G.REPLICA_CAPACITY, G.DISK_CAPACITY, G.REPLICA_DISTRIBUTION)
    return dict(goal_ids=goals, hard_ids=tuple(g for g in goals if g in G.HARD_GOALS), enable_heavy_goals=False)


def _build_smoke(device):
    """Test-only tier: tiny cluster, trimmed goal list -- exercises the whole
    gate in seconds.  Not in DEFAULT_TIERS; not bench-comparable."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    state, ctx = _synthetic(device, **SMOKE)
    return GoalOptimizer(device=device, **_smoke_goals()), state, ctx


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _last_record(kind: str = "optimize"):
    from cruise_control_tpu_torch.obs.recorder import RECORDER

    return next(iter(RECORDER.recent(1, kind=kind)), None)


def _placement_digest(final, num_replicas: int) -> str:
    from cruise_control_tpu_torch.bench_scale import digest

    return digest(final.replica_broker.cpu().numpy()[:num_replicas], final.partition_leader.cpu().numpy())


def _mesh8_rank(mesh) -> dict:
    """One rank of the mesh8 tier: the sharded solve of :data:`MESH8` with
    the 16 default goals, and what the gate reads of it."""
    from cruise_control_tpu_torch.parallel import ShardedGoalOptimizer

    state, ctx = _synthetic(mesh.device, **MESH8)
    opt = ShardedGoalOptimizer(mesh=mesh, enable_heavy_goals=True)
    final, result = opt.optimize(state, ctx)
    _sync(mesh.device)
    trace = _last_record()
    return dict(
        num_dispatches=result.num_host_syncs,
        span_dispatch_sum=trace.total_dispatches if trace else -1,
        compile_s=trace.compile_s if trace else 0.0,
        residual_hard_violations=float(result.residual_hard_violations),
        residual_soft_violations=float(result.residual_soft_violations),
        balancedness=round(result.balancedness_score, 4),
        total_moves=result.total_moves,
        num_goals=len(result.goal_reports),
        digest=_placement_digest(final, state.num_replicas),
    )


def _build_kernels(device) -> None:
    """Build the kernels in this process before ranks on the card start (each
    rank then loads the built libraries)."""
    import torch

    if torch.device(device).type == "cuda":
        from cruise_control_tpu_torch.ops import _build

        _build.build_all(["segment_sum"])


def _run_mesh8_tier(inject_sleep_s: float, device) -> dict:
    """The multichip dryrun as a gated tier: the whole solver sharded over
    8 ranks (``parallel.run_ranks``; on one card the ranks share it over
    gloo).  Single-run: the gated wall INCLUDES the ranks' spawn and the
    kernels' build, because the failure this tier exists to refuse was the
    whole dryrun no longer fitting its window.  Every rank must reach the
    same placement; rank 0's numbers are the tier's."""
    from cruise_control_tpu_torch.parallel import run_ranks

    t0 = time.monotonic()
    _build_kernels(device)
    ranks = run_ranks(_mesh8_rank, MESH8_RANKS, device=device, timeout_s=DEFAULT_TIMEOUT_S)
    wall = time.monotonic() - t0
    digests = {r["digest"] for r in ranks}
    if len(digests) != 1:
        return {"tier": "mesh8", "error": f"the {MESH8_RANKS} ranks reached {len(digests)} different placements"}
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        wall += inject_sleep_s
    m = ranks[0]
    return {
        "tier": "mesh8",
        "platform": _platform(device),
        "wall_s": round(wall, 4),
        "cold_s": round(wall, 4),
        "num_dispatches": m["num_dispatches"],
        "span_dispatch_sum": m["span_dispatch_sum"],
        "residual_hard_violations": m["residual_hard_violations"],
        "residual_soft_violations": m["residual_soft_violations"],
        "balancedness": m["balancedness"],
        "total_moves": m["total_moves"],
        "num_goals": m["num_goals"],
        "compile_s": round(m["compile_s"], 3),
        "warm_compile_events": None,
    }


def _run_exporter_tier(inject_sleep_s: float, device) -> dict:
    """Render wall of /METRICS over a FULLY-populated telemetry plane.

    The scrape path must stay cheap -- Prometheus hits it every few seconds,
    and a rendering slowdown is invisible to the solver benches.  This tier
    builds a worst-case realistic registry (every Sensors.md family populated,
    full timer rings, a full flight-recorder ring, dozens of profiled
    programs), measures the best-of-N render, and round-trips the output
    through the strict exposition parser -- an unparseable page fails the gate
    outright, not just a slow one.  Host-only: ``device`` names the baseline."""
    from cruise_control_tpu_torch.core.sensors import SensorRegistry
    from cruise_control_tpu_torch.obs.exporter import parse_exposition, render_prometheus
    from cruise_control_tpu_torch.obs.profiler import DeviceProfiler
    from cruise_control_tpu_torch.obs.recorder import FlightRecorder, Span, TraceRecord

    registry = SensorRegistry()
    families = ("GoalOptimizer", "LoadMonitor", "Executor", "AnomalyDetector",
                "ScenarioPlanner", "RetryPolicy", "FlightRecorder", "ChaosBackend")
    for fam in families:
        for i in range(8):
            t = registry.timer(f"{fam}.timer-{i}")
            for k in range(256):          # full percentile ring
                t.update(0.001 * ((k * 37) % 101))
            registry.gauge(f"{fam}.gauge-{i}").set(i * 1.5)
            registry.counter(f"{fam}.counter-{i}").inc(i * 1000 + 1)
        registry.meter(f"{fam}.meter").mark(32)

    recorder = FlightRecorder(capacity=256)
    for i in range(256):
        recorder.record(TraceRecord(
            kind=("optimize", "execution", "detector", "simulate")[i % 4],
            trace_id=f"t-{i}", started_at=0.0, duration_s=0.1, platform=_platform(device),
            spans=[Span("s", "goal", 0.1, 1)],
        ))

    profiler = DeviceProfiler()
    for i in range(24):
        profiler.on_call(f"optimizer.program_{i % 6}", ("k", i), f"sig-{i}", 0.01, [])
        profiler.set_analysis(("k", i), {"flops": 1e9 + i, "bytes accessed": 2e9 + i})

    # a single render is ~ms -- far below the gate's absolute noise floor -- so
    # the gated wall is a 500-render batch (best of 2)
    renders = 500
    best = float("inf")
    text = ""
    for _ in range(2):
        t0 = time.monotonic()
        for _i in range(renders):
            text = render_prometheus(registry=registry, recorder=recorder, profiler=profiler)
        best = min(best, time.monotonic() - t0)
    parsed = parse_exposition(text)        # malformed page => gate failure
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        best += inject_sleep_s
    return {
        "tier": "exporter",
        "platform": _platform(device),
        "wall_s": round(best, 4),
        "renders": renders,
        "series": sum(len(m["samples"]) for m in parsed.values()),
        "metric_families": len(parsed),
    }


def _run_controller_tier(inject_sleep_s: float, device) -> dict:
    """Continuous-controller tier: reaction-latency p50 over deterministic
    load shifts + the warm-tick zero-build contract.

    Measured by the harness that writes ``BENCH_CONTROLLER_<device>.json``
    (``controller/bench.py``) and gated against that artifact (see
    ``_controller_baseline``): >25 % reaction-p50 regression or ANY kernel
    build attributed to a measured tick fails.  A warm tick over the JAX
    dispatch budget (``#goals + 3``; here host syncs) is a tier error, as
    is a shift that fails to publish a standing set."""
    from cruise_control_tpu_torch.controller import bench

    return controller_record(bench.run_bench(device=device), device, inject_sleep_s)


def controller_record(m: dict, device, inject_sleep_s: float = 0.0) -> dict:
    """The controller tier's record (or error) from a ``controller/bench.py``
    result doc."""
    if m["published"] < m["shifts"]:
        return {"tier": "controller", "error": f"{m['published']} published sets < {m['shifts']} shifts"}
    if m["warm_tick_dispatches"] > m["dispatch_budget"]:
        return {
            "tier": "controller",
            "error": f"{m['warm_tick_dispatches']} tick dispatches > budget {m['dispatch_budget']}",
        }
    wall = m["reaction_p50_s"]
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        wall += inject_sleep_s
    return {
        "tier": "controller",
        "platform": _platform(device),
        "wall_s": round(wall, 4),
        "reaction_p95_s": m["reaction_p95_s"],
        "warm_tick_dispatches": m["warm_tick_dispatches"],
        "warm_compile_events": m["warm_compile_events"],
        "published": m["published"],
    }


def _run_fleet_tier(inject_sleep_s: float, device) -> dict:
    """Fleet-controller tier: the batched multi-tenant contract.

    Runs the harness that writes ``BENCH_FLEET_<device>.json``
    (``fleet/bench.py``): identical tenant clusters on one fleet, every
    tenant drift-triggered per shift.  Hard contracts -- one goal-order
    group and ONE probe for the whole fleet, the grouped incremental solve
    within the ``#goals + 4`` budget, ANY kernel build on a warm fleet tick
    fails, and every triggered tenant must publish.  The gated wall is the
    warm fleet-tick p50."""
    from cruise_control_tpu_torch.fleet import bench

    return fleet_record(bench.run_bench(device=device), device, inject_sleep_s)


def fleet_record(m: dict, device, inject_sleep_s: float = 0.0) -> dict:
    """The fleet tier's record (or error) from a ``fleet/bench.py`` result doc."""
    want_published = m["num_tenants"] * m["shifts"]
    if m["published"] < want_published:
        return {
            "tier": "fleet",
            "error": (f"{m['published']} published sets < {want_published} "
                      f"({m['num_tenants']} tenants x {m['shifts']} shifts)"),
        }
    if m["groups"] != 1 or m["warm_probe_dispatches"] != 1:
        return {
            "tier": "fleet",
            "error": (f"identical tenants must share ONE group/probe dispatch, "
                      f"got groups={m['groups']} probes={m['warm_probe_dispatches']}"),
        }
    if m["warm_tick_dispatches"] > m["dispatch_budget"]:
        return {
            "tier": "fleet",
            "error": f"{m['warm_tick_dispatches']} tick dispatches > budget {m['dispatch_budget']}",
        }
    wall = m["tick_wall_p50_s"]
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        wall += inject_sleep_s
    return {
        "tier": "fleet",
        "platform": _platform(device),
        "wall_s": round(wall, 4),
        "tick_wall_p95_s": m["tick_wall_p95_s"],
        "num_tenants": m["num_tenants"],
        "tenants_per_dispatch": m["tenants_per_dispatch"],
        "warm_tick_dispatches": m["warm_tick_dispatches"],
        "warm_compile_events": m["warm_compile_events"],
        "published": m["published"],
    }


def _run_serving_tier(inject_sleep_s: float, device) -> dict:
    """Serving-plane overload tier: p95 admitted latency + the shed contract
    (``api/bench.py``: hundreds of concurrent REST clients against the fake
    backend with tight admission knobs).  Any HTTP 5xx, a shed (429) missing
    Retry-After, a workload that failed to overload or to serve is an
    error; the p95 admitted latency is the gated wall."""
    from cruise_control_tpu_torch.api import bench

    m = bench.run_bench(device=device)
    contract = bench.check_contract(m)
    if contract:
        return {"tier": "serving", "error": "; ".join(contract)}
    wall = m["p95_admitted_s"]
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        wall += inject_sleep_s
    return {
        "tier": "serving",
        "platform": _platform(device),
        "wall_s": round(wall, 4),
        "admitted": m["admitted"],
        "shed": m["shed"],
        "http_5xx": m["http_5xx"],
        "sheds_missing_retry_after": m["sheds_missing_retry_after"],
        "goodput_rps": m["goodput_rps"],
    }


def _run_replication_tier(inject_sleep_s: float, device) -> dict:
    """Replicated-read-plane tier: delta-propagation p95 + the fan-out
    contract (``replication/bench.py``: a fenced writer, two or more follower
    processes tailing the journal, hundreds of long-poll watchers).  Any 5xx
    on the watch path, a version regression, an incomplete delivery or
    fewer than 2 follower processes is an error; the p95 writer-append to
    watcher-receipt propagation is the gated wall."""
    from cruise_control_tpu_torch.replication import bench

    m = bench.run_bench(device=device)
    contract = bench.check_contract(m)
    if contract:
        return {"tier": "replication", "error": "; ".join(contract)}
    wall = m["p95_propagation_s"]
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        wall += inject_sleep_s
    return {
        "tier": "replication",
        "platform": _platform(device),
        "wall_s": round(wall, 4),
        "followers_serving": m["followers_serving"],
        "watchers": m["workload"]["watchers"],
        "deliveries": m["deliveries"],
        "http_5xx": m["http_5xx"],
        "version_regressions": m["version_regressions"],
        "goodput_deliveries_per_s": m["goodput_deliveries_per_s"],
    }


def _run_traces_tier(inject_sleep_s: float, device) -> dict:
    """Trace-engine tier: batched-rollout warm wall + the one-sync budget
    (``traces/bench.py``: a 16-pair x 64-step batched rollout).  Warm host
    syncs over the budget, ANY kernel build during the warm rollout, or a
    missed shape bucket is an error; the warm wall is the gated metric."""
    from cruise_control_tpu_torch.traces import bench

    m = bench.run_bench(device=device)
    errors = []
    if m["warm_dispatches"] > m["dispatch_budget"]:
        errors.append(f"{m['warm_dispatches']} warm dispatches > budget {m['dispatch_budget']}")
    if m["warm_compile_events"]:
        errors.append(f"{m['warm_compile_events']} kernel build(s) during the warm rollout")
    if not m["bucket_hit"]:
        errors.append("warm rollout missed the shape bucket")
    if errors:
        return {"tier": "traces", "error": "; ".join(errors)}
    wall = m["warm_s"]
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        wall += inject_sleep_s
    return {
        "tier": "traces",
        "platform": _platform(device),
        "wall_s": round(wall, 4),
        "cold_s": m["cold_s"],
        "pairs": m["pairs"],
        "steps": m["steps"],
        "warm_dispatches": m["warm_dispatches"],
        "warm_compile_events": m["warm_compile_events"],
        "bucket_hit": m["bucket_hit"],
    }


#: the sharded contract: one sharded goal step's collectives stay single-digit
_SHARDED_MAX_COLLECTIVES = 9


def _sharded_goals():
    from cruise_control_tpu_torch.analyzer import goals_base as G

    goals = (G.RACK_AWARE, G.REPLICA_CAPACITY, G.DISK_CAPACITY)
    return dict(goal_ids=goals, hard_ids=tuple(g for g in goals if g in G.HARD_GOALS), enable_heavy_goals=False)


def _sharded_rank(mesh) -> dict:
    """One rank of the sharded tier: the census of one sharded RackAware
    goal step of one round (the JAX census counts the lowered step: its
    snapshots and the round loop's body once), then the goal list sharded,
    cold and warm."""
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.analyzer.goal_rounds import GOAL_ROUNDS
    from cruise_control_tpu_torch.analyzer.optimizer import HostSyncs, _goal_step_fn
    from cruise_control_tpu_torch.parallel import ShardedGoalOptimizer
    from cruise_control_tpu_torch.parallel.mesh import COLLECTIVES, reset_collective_counts, shard_state
    from cruise_control_tpu_torch.parallel.spmd import SpmdInfo

    state, ctx = _synthetic(mesh.device, **SHARDED)
    local = shard_state(state, mesh)
    spmd = SpmdInfo(mesh=mesh, n=mesh.world, global_R=local.num_replicas * mesh.world)
    reset_collective_counts()
    _goal_step_fn(
        local, ctx, gid=G.RACK_AWARE, round_fns=GOAL_ROUNDS[G.RACK_AWARE], max_rounds=1,
        enable_heavy=False, prior_ids=(), admit_ids=(G.RACK_AWARE,), syncs=HostSyncs(), spmd=spmd,
    )
    census = dict(COLLECTIVES)
    opt = ShardedGoalOptimizer(mesh=mesh, **_sharded_goals())
    opt.optimize(state, ctx)                      # cold: builds, first touch
    _sync(mesh.device)
    t0 = time.monotonic()
    final, result = opt.optimize(state, ctx)
    _sync(mesh.device)
    warm_s = time.monotonic() - t0
    trace = _last_record()
    return dict(
        census=census, use_spmd=opt.use_spmd, warm_s=warm_s, total_moves=result.total_moves,
        host_syncs=result.num_host_syncs, digest=_placement_digest(final, state.num_replicas),
        warm_compile_events=len(trace.compile_events) if trace else None,
    )


def sharded_measure(device, inject_sleep_s: float = 0.0) -> dict:
    """The sharded tier's live measurement (no artifact check): the census
    of one sharded RackAware goal step on :data:`SHARDED_RANKS` ranks, the
    warm single-device and warm sharded walls of the tier's goal list, and
    proposal identity between them.  ``errors`` lists what broke."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.parallel import run_ranks

    state, ctx = _synthetic(device, **SHARDED)
    single = GoalOptimizer(device=device, **_sharded_goals())
    single.optimize(state, ctx)                   # cold
    _sync(device)
    t0 = time.monotonic()
    final, r1 = single.optimize(state, ctx)
    _sync(device)
    single_s = time.monotonic() - t0
    single_digest = _placement_digest(final, state.num_replicas)

    _build_kernels(device)
    ranks = run_ranks(_sharded_rank, SHARDED_RANKS, device=device, timeout_s=DEFAULT_TIMEOUT_S)
    errors: List[str] = []
    censuses = [sum(r["census"].values()) for r in ranks]
    census = max(censuses)
    if census > _SHARDED_MAX_COLLECTIVES:
        errors.append(f"live sharded goal step runs {census} collectives > {_SHARDED_MAX_COLLECTIVES} "
                      f"({ranks[0]['census']}; the per-reduction-site regression)")
    if not all(r["use_spmd"] for r in ranks):
        errors.append("sharded optimizer did not take the SPMD path")
    sharded_s = max(r["warm_s"] for r in ranks)
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        sharded_s += inject_sleep_s
    r8 = ranks[0]
    identity = all(r["digest"] == single_digest and r["total_moves"] == r1.total_moves for r in ranks)
    if not identity:
        errors.append(f"proposal identity broken: sharded {r8['total_moves']} moves (placements "
                      f"{sorted({r['digest'][:12] for r in ranks})}) != single-device {r1.total_moves} "
                      f"({single_digest[:12]})")
    warm_c = max((r["warm_compile_events"] or 0) for r in ranks)
    return {
        "tier": "sharded",
        "platform": _platform(device),
        "wall_s": round(sharded_s, 4),
        "single_device_s": round(single_s, 4),
        "overhead_x": round(sharded_s / max(single_s, 1e-9), 2),
        "collectives_per_goal_step": census,
        "collectives_by_kind": ranks[0]["census"],
        "warm_compile_events": warm_c,
        "total_moves": r8["total_moves"],
        "sharded_dispatches": r8["host_syncs"],
        "proposal_identity": identity,
        "ranks": SHARDED_RANKS,
        "errors": errors,
    }


def _run_sharded_tier(inject_sleep_s: float, device) -> dict:
    """Replica-sharded solver tier: collective census + identity + walls.

    The committed ``BENCH_SHARDED_<device>.json`` records the sharded
    solver's contract -- single-digit collectives per goal step, proposal
    identity with the single-device solver, zero warm builds.  This tier
    re-measures all three LIVE at a gate-affordable shape (12 brokers, 1,500
    partitions, 8 ranks; the census is ``parallel.mesh.COLLECTIVES`` over
    one sharded RackAware goal step) and validates the committed artifact
    itself, so neither the code nor the artifact can silently rot.  The
    gated wall is the warm sharded solve; ``overhead_x`` (sharded /
    single-device warm wall on the same host) is compared against the
    committed gate baseline too: on one card the ranks share it over gloo,
    so the ratio measures the staging overhead, and any growth means the
    communication design regressed."""
    errors: List[str] = []
    art: dict = {}
    rel = artifact_path("sharded", device)
    try:
        with open(os.path.join(_repo_root(), rel)) as f:
            art = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        errors.append(f"committed {rel} unreadable: {e}")
    if art:
        if not art.get("ok"):
            errors.append(f"committed {rel} has ok != true")
        if art.get("proposal_identity") is not True:
            errors.append("committed artifact proposal_identity != true")
        if art.get("warm_compile_events") not in (0, None):
            errors.append(f"committed artifact warm_compile_events = {art.get('warm_compile_events')} (must be 0)")
        art_census = art.get("collectives_per_goal_step_total")
        if art_census is None or art_census > _SHARDED_MAX_COLLECTIVES:
            errors.append(f"committed artifact collectives_per_goal_step_total {art_census} > "
                          f"{_SHARDED_MAX_COLLECTIVES} (single-digit contract)")
    m = sharded_measure(device, inject_sleep_s)
    errors += m.pop("errors")
    art_census = art.get("collectives_per_goal_step_total")
    if art_census is not None and m["collectives_per_goal_step"] > art_census:
        errors.append(f"live census {m['collectives_per_goal_step']} > committed artifact's {art_census} "
                      "(collective-count growth)")
    if errors:
        return {"tier": "sharded", "error": "; ".join(errors)}
    return m


def _run_slo_tier(inject_sleep_s: float, device) -> dict:
    """Self-monitoring plane tier: sampler overhead + SLO burn alerting
    (``obs/selfmon_bench.py``).  Any sampler kernel call or build, a quiet-run
    false positive, a fast-window alert later than 2 sampling periods into
    the burn, a missing self-heal or auto-resume is an error; the sampler
    wall p50 is the gated metric."""
    from cruise_control_tpu_torch.obs import selfmon_bench as bench

    m = bench.run_bench(device=device)
    errors = []
    if m["sampler_dispatches"] or m["sampler_compile_events"]:
        errors.append(f"sampler made {m['sampler_dispatches']} dispatch(es) / "
                      f"{m['sampler_compile_events']} compile event(s) (must be host-only)")
    if m["quiet_false_positives"]:
        errors.append(f"{m['quiet_false_positives']} false-positive alert(s) on the quiet run")
    if m["burn_periods_to_alert"] is None or m["burn_periods_to_alert"] > bench.MAX_PERIODS_TO_ALERT:
        errors.append(f"fast-window alert after {m['burn_periods_to_alert']} burn period(s) "
                      f"(bound {bench.MAX_PERIODS_TO_ALERT})")
    if not m["paused_by_heal"] or not m["auto_resumed"]:
        errors.append(f"self-heal incomplete (paused_by_heal={m['paused_by_heal']}, "
                      f"auto_resumed={m['auto_resumed']})")
    if errors:
        return {"tier": "slo", "error": "; ".join(errors)}
    wall = m["sample_p50_s"]
    if inject_sleep_s:
        time.sleep(inject_sleep_s)
        wall += inject_sleep_s
    return {
        "tier": "slo",
        "platform": _platform(device),
        "wall_s": round(wall, 6),
        "overhead_ratio": m["overhead_ratio"],
        "series_count": m["series_count"],
        "sampler_dispatches": m["sampler_dispatches"],
        "sampler_compile_events": m["sampler_compile_events"],
        "quiet_false_positives": m["quiet_false_positives"],
        "burn_periods_to_alert": m["burn_periods_to_alert"],
        "anomalies_emitted": m["anomalies_emitted"],
        "auto_resumed": m["auto_resumed"],
    }


#: each harness tier's artifact and the key of it the tier gates as its wall
HARNESS_WALL_KEYS = {
    "controller": "reaction_p50_s",
    "fleet": "tick_wall_p50_s",
    "serving": "p95_admitted_s",
    "replication": "p95_propagation_s",
    "traces": "warm_s",
    "slo": "sample_p50_s",
}


def artifact_path(name: str, device) -> str:
    """A committed artifact's path relative to the repository root:
    ``BENCH_<NAME>_<device>.json`` (the slo tier's is ``BENCH_SELFMON``, as
    in the JAX package)."""
    return baseline_path(device, "BENCH_SELFMON" if name == "slo" else f"BENCH_{name.upper()}")


def _artifact_baseline(root: str, tier: str, device: str) -> Optional[dict]:
    """Gate baseline for a harness tier, derived from its committed artifact
    (one number, one file)."""
    try:
        with open(os.path.join(root, artifact_path(tier, device))) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return {"wall_s": doc.get(HARNESS_WALL_KEYS[tier])}


def _serving_baseline(root: str, device: str = DEFAULT_DEVICE) -> Optional[dict]:
    return _artifact_baseline(root, "serving", device)


def _traces_baseline(root: str, device: str = DEFAULT_DEVICE) -> Optional[dict]:
    return _artifact_baseline(root, "traces", device)


def _replication_baseline(root: str, device: str = DEFAULT_DEVICE) -> Optional[dict]:
    return _artifact_baseline(root, "replication", device)


def _selfmon_baseline(root: str, device: str = DEFAULT_DEVICE) -> Optional[dict]:
    return _artifact_baseline(root, "slo", device)


def _controller_baseline(root: str, device: str = DEFAULT_DEVICE) -> Optional[dict]:
    return _artifact_baseline(root, "controller", device)


def _fleet_baseline(root: str, device: str = DEFAULT_DEVICE) -> Optional[dict]:
    return _artifact_baseline(root, "fleet", device)


TIERS: Dict[str, GateTier] = {
    t.name: t
    for t in (
        GateTier("config1", "3 brokers / 20 partitions, default goals", _build_config1),
        GateTier("config2_small", "40 brokers / 2k partitions RF3, default goals", _build_config2_small),
        GateTier("mesh8", "8-rank sharded solve (spawn and build included)",
                 build=None, warm_runs=False, bench_comparable=False, runner=_run_mesh8_tier),
        GateTier("smoke", "test-only: 4 brokers / 24 partitions, 4 goals", _build_smoke, bench_comparable=False),
        GateTier("exporter", "/METRICS render wall, fully-populated registry",
                 build=None, bench_comparable=False, runner=_run_exporter_tier),
        GateTier("controller", "reaction-latency p50 + warm-tick 0-build contract vs BENCH_CONTROLLER",
                 build=None, bench_comparable=False, runner=_run_controller_tier),
        GateTier("serving", "overload plane: p95 admitted latency + shed contract vs BENCH_SERVING",
                 build=None, bench_comparable=False, runner=_run_serving_tier),
        GateTier("sharded", "replica-sharded solver: collective census + proposal identity vs BENCH_SHARDED",
                 build=None, bench_comparable=False, runner=_run_sharded_tier),
        GateTier("traces", "batched rollout warm wall + one-sync budget vs BENCH_TRACES",
                 build=None, bench_comparable=False, runner=_run_traces_tier),
        GateTier("replication", "multi-process fan-out: delta-propagation p95 + watch contract "
                 "vs BENCH_REPLICATION", build=None, bench_comparable=False, runner=_run_replication_tier),
        GateTier("fleet", "multi-tenant batched tick: 1 probe for every tenant + 0-build warm tick "
                 "vs BENCH_FLEET", build=None, bench_comparable=False, runner=_run_fleet_tier),
        GateTier("slo", "self-monitoring plane: sampler overhead + burn alerting vs BENCH_SELFMON",
                 build=None, bench_comparable=False, runner=_run_slo_tier),
    )
}
DEFAULT_TIERS = (
    "config1", "config2_small", "mesh8", "exporter", "controller", "serving",
    "sharded", "traces", "replication", "fleet", "slo",
)


# -- measurement --------------------------------------------------------------------


def _platform(device) -> str:
    import torch

    return torch.device(device).type


def _device(device):
    """The torch device, probed (``core/backend_probe.py``): raises naming
    the device when it does not answer; never falls back to the CPU."""
    from cruise_control_tpu_torch.core.backend_probe import ensure_live_backend
    from cruise_control_tpu_torch.core.device import resolve_device

    ensure_live_backend(device)
    return resolve_device(device)


def run_tier(name: str, inject_sleep_s: float = 0.0, device=None) -> dict:
    """Build + run one tier on ``device`` (``cuda`` unless ``cpu`` is asked
    for), returning the measurement record.

    ``inject_sleep_s`` sleeps inside the timed window -- the documented test
    hook for simulating a wall-clock regression without touching the solver.
    """
    from cruise_control_tpu_torch.core.device import resolve_device

    tier = TIERS[name]
    # the command line probes the device once, in the parent (``main``); a
    # child runs under the parent's hard timeout
    dev = resolve_device(device)
    if tier.runner is not None:
        return tier.runner(inject_sleep_s, dev)

    opt, state, ctx = tier.build(dev)
    t0 = time.monotonic()
    _, result = opt.optimize(state, ctx)
    _sync(dev)
    cold_s = time.monotonic() - t0
    cold_trace = _last_record()
    compile_s = cold_trace.compile_s if cold_trace else 0.0
    if tier.warm_runs:
        t0 = time.monotonic()
        _, result = opt.optimize(state, ctx)
        _sync(dev)
        if inject_sleep_s:
            time.sleep(inject_sleep_s)
        wall_s = time.monotonic() - t0
    else:
        wall_s = cold_s + inject_sleep_s
        if inject_sleep_s:
            time.sleep(inject_sleep_s)

    # recorder self-check: the record's per-goal spans must account for every
    # host sync the optimizer reports -- a drifted recorder is itself a
    # regression the gate refuses
    trace = _last_record()
    span_dispatch_sum = trace.total_dispatches if trace else -1
    # warm-build accounting: the newest optimize record after a warm run
    # carries exactly the kernel builds that run caused -- a warm run must
    # cause NONE (single-run tiers report None)
    warm_compile_events = len(trace.compile_events) if (tier.warm_runs and trace) else None
    return {
        "tier": name,
        "platform": dev.type,
        "wall_s": round(wall_s, 4),
        "cold_s": round(cold_s, 4),
        "num_dispatches": result.num_host_syncs,
        "span_dispatch_sum": span_dispatch_sum,
        "residual_hard_violations": float(result.residual_hard_violations),
        "residual_soft_violations": float(result.residual_soft_violations),
        "balancedness": round(result.balancedness_score, 4),
        "total_moves": result.total_moves,
        "num_goals": len(result.goal_reports),
        "compile_s": round(compile_s, 3),
        "warm_compile_events": warm_compile_events,
    }


# -- comparison ---------------------------------------------------------------------


def compare(
    baseline: Mapping,
    measured: Mapping,
    thresholds: GateThresholds = GateThresholds(),
    wall_slack: float = 1.0,
) -> List[str]:
    """Regression verdicts for one tier; empty list == pass."""
    failures: List[str] = []
    tier = measured.get("tier", "?")

    base_wall = baseline.get("wall_s")
    if base_wall is not None:
        allowed = base_wall * thresholds.max_wall_ratio * wall_slack + thresholds.wall_floor_s
        if measured["wall_s"] > allowed:
            failures.append(
                f"{tier}: wall {measured['wall_s']:.3f}s exceeds {allowed:.3f}s (baseline {base_wall:.3f}s × "
                f"{thresholds.max_wall_ratio} × slack {wall_slack} + {thresholds.wall_floor_s}s floor)"
            )

    base_hard = baseline.get("residual_hard_violations")
    if base_hard is not None and measured["residual_hard_violations"] > base_hard:
        failures.append(
            f"{tier}: residual hard violations {measured['residual_hard_violations']} > baseline {base_hard} "
            "(any increase fails)"
        )

    base_disp = baseline.get("num_dispatches")
    if base_disp is not None:
        extra = baseline.get("dispatch_slack", thresholds.max_extra_dispatches)
        if measured["num_dispatches"] > base_disp + extra:
            failures.append(
                f"{tier}: {measured['num_dispatches']} dispatches > baseline {base_disp} + {extra} "
                "(host-sync budget)"
            )

    base_bal = baseline.get("balancedness")
    if base_bal is not None and measured["balancedness"] < base_bal - thresholds.max_balancedness_drop:
        failures.append(
            f"{tier}: balancedness {measured['balancedness']:.2f} < baseline {base_bal:.2f} − "
            f"{thresholds.max_balancedness_drop}"
        )

    # sharded tier: the overhead ratio must not grow past the committed
    # baseline -- wall_s alone can mask a communication regression when the
    # whole host got faster or slower
    base_ov = baseline.get("overhead_x")
    if base_ov is not None and measured.get("overhead_x") is not None:
        allowed_ov = base_ov * thresholds.max_wall_ratio * wall_slack + thresholds.overhead_floor
        if measured["overhead_x"] > allowed_ov:
            failures.append(
                f"{tier}: overhead_x {measured['overhead_x']:.2f} exceeds {allowed_ov:.2f} (baseline "
                f"{base_ov:.2f} × {thresholds.max_wall_ratio} × slack {wall_slack} + "
                f"{thresholds.overhead_floor} floor)"
            )

    span_sum = measured.get("span_dispatch_sum", -1)
    if span_sum >= 0 and span_sum != measured["num_dispatches"]:
        failures.append(
            f"{tier}: flight-recorder span dispatches {span_sum} != reported num_dispatches "
            f"{measured['num_dispatches']} (recorder drift)"
        )

    # absolute, baseline-independent: the timed warm run reuses the kernels
    # the cold run built -- any build event in its flight record means a
    # build was keyed on something that changed between identical calls
    warm_c = measured.get("warm_compile_events")
    if warm_c:
        failures.append(f"{tier}: {warm_c} compile event(s) (nvcc kernel builds) during the timed warm "
                        "run (warm run ⇒ zero builds)")
    return failures


def latest_bench_baseline(root: str) -> Optional[dict]:
    """Newest ``BENCH_r*.json`` ``parsed`` payload under ``root``, if any."""
    best: Optional[dict] = None
    best_n = -1
    for path in glob.glob(os.path.join(root, "BENCH_r*.json")):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        parsed = doc.get("parsed")
        n = doc.get("n", -1)
        if parsed and n > best_n:
            best, best_n = parsed, n
    return best


def flagship_baseline(root: str, device) -> Optional[dict]:
    """The port's flagship record on ``device`` (``BENCH_FLAGSHIP_<device>.json``:
    config #2's solve), if committed."""
    try:
        with open(os.path.join(root, artifact_path("flagship", device))) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc.get("parsed", doc)


def compare_bench(bench: Mapping, measured: Mapping) -> List[str]:
    """Scale-independent cross-check against the flagship record: hard
    violations must not exceed the committed run's, and the host syncs must
    stay within BENCH_DISPATCH_SLACK of it."""
    failures: List[str] = []
    tier = measured.get("tier", "?")
    bench_hard = bench.get("residual_hard_violations")
    if bench_hard is not None and measured["residual_hard_violations"] > bench_hard:
        failures.append(
            f"{tier}: residual hard violations {measured['residual_hard_violations']} > flagship bench's "
            f"{bench_hard}"
        )
    bench_disp = bench.get("num_dispatches")
    if bench_disp is not None and measured["num_dispatches"] > bench_disp + BENCH_DISPATCH_SLACK:
        failures.append(
            f"{tier}: {measured['num_dispatches']} dispatches > flagship bench's {bench_disp} + "
            f"{BENCH_DISPATCH_SLACK}"
        )
    return failures


# -- orchestration ------------------------------------------------------------------


def _repo_root() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))


def card() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def child_command(name: str, device, inject_sleep_s: float = 0.0) -> List[str]:
    """The command line of one tier's child process."""
    return [
        sys.executable, "-m", "cruise_control_tpu_torch.obs.gate",
        "--run-tier", name, "--inject-sleep", str(inject_sleep_s),
        "--device", str(device if device is not None else DEFAULT_DEVICE),
    ]


def run_tier_subprocess(name: str, timeout_s: float, inject_sleep_s: float = 0.0, device=None) -> dict:
    """Run one tier in a child under a HARD timeout (the child gets killed --
    a hang becomes a gate failure, not a silent finding)."""
    env = dict(os.environ)
    root = _repo_root()
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            child_command(name, device, inject_sleep_s), env=env, cwd=root,
            capture_output=True, text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return {"tier": name, "error": f"hard timeout after {timeout_s:.0f}s"}
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-5:]
        return {"tier": name, "error": f"exit {proc.returncode}: " + " | ".join(tail)}
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return {"tier": name, "error": "no measurement line in child output"}


def load_gate_baseline(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def write_gate_baseline(path: str, measurements: List[dict]) -> None:
    """Merge measurements into the baseline doc: a --tiers subset refresh must
    not discard the committed baselines of the tiers it didn't run.  A card's
    baseline names the card and its power limit."""
    tiers: Dict[str, dict] = {}
    try:
        tiers = load_gate_baseline(path).get("tiers", {})
    except (OSError, json.JSONDecodeError):
        pass
    tiers.update({m["tier"]: m for m in measurements})
    platform = next((m["platform"] for m in measurements if "platform" in m), "cpu")
    doc = {
        "schema": GATE_SCHEMA,
        "platform": platform,
        "generated_by": f"python -m cruise_control_tpu_torch.obs.gate --update-baseline --device {platform}",
        "tiers": tiers,
    }
    if platform == "cuda":
        doc["card"] = card()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def _status(m: dict) -> str:
    if m.get("error"):
        return m["error"]
    if "num_dispatches" in m:
        return (f"wall={m['wall_s']}s dispatches={m['num_dispatches']} "
                f"hard={m['residual_hard_violations']} bal={m['balancedness']}")
    if "series" in m:   # exporter tier gates render wall only
        return f"wall={m['wall_s']}s series={m.get('series')}"
    if "overhead_x" in m:   # sharded tier: census + identity + overhead
        return (f"wall={m['wall_s']}s overhead_x={m.get('overhead_x')} "
                f"collectives={m.get('collectives_per_goal_step')} warm_compiles={m.get('warm_compile_events')}")
    if "bucket_hit" in m:   # traces tier: warm rollout wall + budget
        return (f"wall={m['wall_s']}s pairs={m.get('pairs')} dispatches={m.get('warm_dispatches')} "
                f"warm_compiles={m.get('warm_compile_events')}")
    if "tenants_per_dispatch" in m:   # fleet tier
        return (f"tick_p50={m['wall_s']}s tenants/dispatch={m.get('tenants_per_dispatch')} "
                f"tick_dispatches={m.get('warm_tick_dispatches')} warm_compiles={m.get('warm_compile_events')} "
                f"published={m.get('published')}")
    if "deliveries" in m:   # replication tier
        return (f"p95_propagation={m['wall_s']}s deliveries={m.get('deliveries')} "
                f"followers={m.get('followers_serving')} 5xx={m.get('http_5xx')} "
                f"regressions={m.get('version_regressions')}")
    if "quiet_false_positives" in m:   # slo tier
        return (f"sample_p50={m['wall_s']}s overhead={m.get('overhead_ratio', 0) * 100:.2f}% "
                f"alert_in={m.get('burn_periods_to_alert')} false_positives={m.get('quiet_false_positives')} "
                f"resumed={m.get('auto_resumed')}")
    if "goodput_rps" in m:   # serving tier
        return (f"p95_admitted={m['wall_s']}s admitted={m.get('admitted')} shed={m.get('shed')} "
                f"5xx={m.get('http_5xx')} goodput={m.get('goodput_rps')}rps")
    return (f"reaction_p50={m['wall_s']}s warm_compiles={m.get('warm_compile_events')} "
            f"published={m.get('published')}")


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """The gate's command line.  ``device`` is the default of ``--device``
    (``cuda`` when not given)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="gate", description="Run the bench tiers and refuse regressions against committed baselines.",
    )
    p.add_argument("--tiers", default=",".join(DEFAULT_TIERS), help="comma-separated tier names (default: %(default)s)")
    p.add_argument("--device", default=str(device) if device is not None else DEFAULT_DEVICE,
                   help="cuda or cpu (default: %(default)s)")
    p.add_argument("--baseline", default=None,
                   help="gate baseline JSON (default: GATE_BASELINE_<device>.json under " + BASELINE_DIR + ")")
    p.add_argument("--bench-baseline", default=None,
                   help="flagship record for the cross-check; 'none' disables (default: "
                        "BENCH_FLAGSHIP_<device>.json beside the baselines)")
    p.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                   help="hard per-tier timeout in seconds (default: %(default)s; env CC_TPU_GATE_TIMEOUT_S)")
    p.add_argument("--update-baseline", action="store_true",
                   help="run the tiers and (re)write the gate baseline instead of comparing")
    p.add_argument("--in-process", action="store_true", help="run tiers in this process (no hard timeout; tests)")
    p.add_argument("--inject-sleep", type=float, default=0.0,
                   help="TEST HOOK: sleep this many seconds inside each tier's timed window")
    p.add_argument("--run-tier", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    # child mode: measure one tier, print one JSON line
    if args.run_tier:
        print(json.dumps(run_tier(args.run_tier, args.inject_sleep, device=args.device)))
        return 0

    root = _repo_root()
    baseline_path_ = args.baseline or os.path.join(root, baseline_path(args.device))
    tier_names = [t for t in args.tiers.split(",") if t]
    unknown = [t for t in tier_names if t not in TIERS]
    if unknown:
        print(f"gate: unknown tier(s) {unknown}; have {sorted(TIERS)}")
        return 2
    dev = _device(args.device)
    print(f"gate: device {dev}" + (f" ({card()})" if dev.type == "cuda" else ""), flush=True)

    measurements: List[dict] = []
    for name in tier_names:
        t0 = time.monotonic()
        if args.in_process:
            try:
                m = run_tier(name, args.inject_sleep, device=args.device)
            except Exception as e:
                m = {"tier": name, "error": f"{type(e).__name__}: {e}"}
        else:
            m = run_tier_subprocess(name, args.timeout, args.inject_sleep, device=args.device)
        m.setdefault("gate_wall_s", round(time.monotonic() - t0, 1))
        measurements.append(m)
        print(f"gate: [{name}] {_status(m)}", flush=True)

    errors = [m for m in measurements if "error" in m]
    if args.update_baseline:
        if errors:
            print("gate: refusing to write a baseline from failed tiers")
            return 2
        write_gate_baseline(baseline_path_, measurements)
        print(f"gate: baseline written to {baseline_path_}")
        return 0

    try:
        gate_doc = load_gate_baseline(baseline_path_)
    except (OSError, json.JSONDecodeError) as e:
        print(f"gate: cannot load gate baseline {baseline_path_}: {e}")
        print("gate: generate one with --update-baseline (and commit it)")
        return 2
    gate_tiers = gate_doc.get("tiers", {})

    bench: Optional[dict] = None
    if args.bench_baseline != "none":
        if args.bench_baseline:
            with open(args.bench_baseline) as f:
                doc = json.load(f)
            bench = doc.get("parsed", doc)
        else:
            bench = flagship_baseline(root, args.device)

    wall_slack = float(os.environ.get("CC_TPU_GATE_WALL_SLACK", "1.0"))
    thresholds = GateThresholds()
    failures: List[str] = [f"{m['tier']}: {m['error']}" for m in errors]
    for m in measurements:
        if "error" in m:
            continue
        base = gate_tiers.get(m["tier"])
        if base is None and m["tier"] in HARNESS_WALL_KEYS:
            # the harness tiers gate against their committed artifacts
            # (BENCH_<TIER>_<device>.json, written by obs/bench_baselines.py)
            base = _artifact_baseline(root, m["tier"], args.device)
        if base is None:
            failures.append(f"{m['tier']}: no committed gate baseline for this tier (run --update-baseline and commit)")
            continue
        failures += compare(base, m, thresholds, wall_slack)
        if bench is not None and TIERS[m["tier"]].bench_comparable:
            failures += compare_bench(bench, m)

    if failures:
        print("gate: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"gate: PASS ({len(measurements)} tier(s), wall slack {wall_slack})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
