"""Self-monitoring plane bench harness.

Port of ``cruise_control_tpu/obs/selfmon_bench.py``, with the same pinned
workload and phases.  One thing differs: the overhead's denominator is the
port's own warm controller tick, the reaction p50 of the controller harness
(``controller/bench.py``) run in the same process on ``device``, never the
JAX package's committed CPU number.

Four phases, one result doc:

1. **Overhead** — a private :class:`SensorRegistry` seeded at real-app scale
   (~85 series: 5 warm timers, gauges, counters, meters, a controller-tick
   flight record) is sampled ``OVERHEAD_SAMPLES`` times on a synthetic clock
   with realistic between-sample activity (every timer updated), spooling to
   a size-capped JSONL so at least one rotation happens under load.  The
   headline: ``sample_p50_s / tick_p50_s`` — sampler wall p50 as a fraction
   of the warm controller tick p50 (the JAX contract is ≤ 1 %).  Zero kernel
   calls and zero compile events across the whole sampling run are read from
   the process-wide profiler census, the wrappers' launch counters and the
   flight recorder's compile-event log: the sampler is host-only by
   construction.
2. **Quiet** — the SLO engine (second-scale window pairs, synthetic clock)
   evaluates after every healthy sample; any firing alert is a false
   positive and fails the bench.
3. **Burn** — each period injects one bad reaction latency (a *real*
   ``time.sleep(inject_sleep_s)`` measured by the timer when
   ``inject_sleep_s > 0``, a synthetic update otherwise); the fast-pair
   alert for ``reaction-latency-p99`` must fire within
   ``MAX_PERIODS_TO_ALERT`` sampling periods.  The
   :class:`SelfMetricAnomalyFinder` runs the same cycle: it must emit
   exactly one :class:`SloBurnAnomaly` (cooldown dedups the sustained burn)
   whose ``fix_with`` pauses the controller.
4. **Recovery** — healthy traffic flushes the timer ring; the short window
   going clean stops the alert (the multi-window property: a recovered
   incident stops paging before the long window forgets), and the finder
   auto-resumes the controller it paused.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from cruise_control_tpu_torch.core.device import DeviceLike
from cruise_control_tpu_torch.core.sensors import (
    ADMISSION_ADMITTED_COUNTER,
    CONTROLLER_REACTION_TIMER,
    SensorRegistry,
)
from cruise_control_tpu_torch.detector.detectors import SelfMetricAnomalyFinder
from cruise_control_tpu_torch.obs import recorder as _rec
from cruise_control_tpu_torch.obs.profiler import PROFILER, DeviceProfiler
from cruise_control_tpu_torch.obs.recorder import FlightRecorder, TraceRecord
from cruise_control_tpu_torch.obs.selfmon import SelfMonitor
from cruise_control_tpu_torch.obs.slo import SloEngine, WindowPair, shipped_specs

# -- pinned workload (change => regenerate the baseline) -----------------------

OVERHEAD_SAMPLES = 200
WARMUP_SAMPLES = 25             # unmeasured (fresh-process first-touch costs)
SAMPLE_PERIOD_S = 1.0           # synthetic-clock sampling period
QUIET_PERIODS = 30
BURN_PERIODS = 6
#: bad latencies injected per burn period — a burn is a storm (every tick
#: slow), and the 256-sample p99 ring needs 3 tail entries to flip
BURN_BAD_PER_PERIOD = 3
RECOVERY_PERIODS = 12
MAX_PERIODS_TO_ALERT = 2        # the acceptance bound on the fast pair
SPOOL_CAP_BYTES = 256 * 1024    # forces >= 1 rotation across the overhead run
GOOD_LATENCY_S = 0.010
INJECT_SLEEP_S = 0.12           # default injected bad latency (real sleep)

#: second-scale window pairs — same engine, bench-speed windows
BENCH_PAIRS = (
    WindowPair("fast", long_s=10.0, short_s=3.0, threshold=14.4),
    WindowPair("slow", long_s=60.0, short_s=10.0, threshold=1.0),
)

#: config the shipped specs are bound to for the bench (dict.get-compatible)
BENCH_SLO_CONFIG = {
    "slo.burn.budget": 0.01,
    "slo.reaction.p99.objective.s": 0.050,
    "slo.shed.ratio.objective": 0.05,
    "slo.degraded.ratio.objective": 0.05,
    "slo.dispatch.budget": 7.0,
    "slo.recompile.objective": 0.0,
    "slo.replication.staleness.objective.ms": 2000.0,
}



class _StubController:
    """pause/resume surface of the continuous controller (loop.py), nothing
    else — the finder and the anomaly only touch these four members."""

    def __init__(self) -> None:
        self.paused = False
        self.pause_reason: Optional[str] = None
        self.pauses: List[str] = []
        self.resumes: List[str] = []

    def pause(self, reason: str = "operator request") -> None:
        self.paused = True
        self.pause_reason = reason
        self.pauses.append(reason)

    def resume(self, reason: str = "operator request") -> None:
        self.paused = False
        self.pause_reason = reason
        self.resumes.append(reason)


def _seeded_registry() -> SensorRegistry:
    """A private registry at real-app scale (~85 flattened series)."""
    reg = SensorRegistry()
    for name in (
        CONTROLLER_REACTION_TIMER,
        "GoalOptimizer.proposal-computation-timer",
        "Executor.execution-timer",
        "Api.request-timer",
        "AnomalyDetector.detection-timer",
    ):
        t = reg.timer(name)
        for k in range(256):
            t.update(0.001 * (k % 17 + 1))
    for i in range(12):
        reg.gauge(f"Bench.g{i}").set(float(i))
    reg.counter(ADMISSION_ADMITTED_COUNTER).inc(100)
    for i in range(9):
        reg.counter(f"Bench.c{i}").inc(3)
    for i in range(2):
        reg.meter(f"Bench.m{i}").mark(2)
    return reg


def _tick_record(now_s: float, dispatches: int = 5) -> TraceRecord:
    return TraceRecord(
        kind="controller_tick", trace_id="bench-tick", started_at=now_s,
        duration_s=0.01, platform="cpu",
        attrs={"num_dispatches": dispatches},
    )


def controller_tick_p50_s(device: DeviceLike = None) -> float:
    """The port's warm controller tick p50 on ``device`` — the overhead
    denominator: the controller harness's reaction p50 (``controller/bench.py``
    at its pinned workload), measured now in this process."""
    from cruise_control_tpu_torch.controller.bench import run_bench as run_controller_bench

    return float(run_controller_bench(device=device)["reaction_p50_s"])


def _kernel_launches() -> int:
    """Kernel launches so far, over every wrapper's counter."""
    from cruise_control_tpu_torch.ops import assign, segments

    return sum(segments.LAUNCHES.values()) + sum(assign.LAUNCHES.values())


def _percentile(sorted_vals: List[float], q: float) -> float:
    return sorted_vals[min(int(q * len(sorted_vals)), len(sorted_vals) - 1)]


def run_overhead_phase(tick_p50_s: float) -> Dict[str, object]:
    """Phase 1: sampler wall vs the warm tick, dispatch/compile census."""
    reg = _seeded_registry()
    rec = FlightRecorder()
    prof = DeviceProfiler()
    rec.record(_tick_record(0.0))
    # registry has no public timer iterator: re-resolve by name (cheap, cached)
    timers = [reg.timer(n) for n in sorted(reg.snapshot().get("timers", {}))]
    spool_dir = tempfile.mkdtemp(prefix="selfmon-bench-")
    mon = SelfMonitor(
        registry=reg, recorder=rec, profiler=prof,
        interval_s=SAMPLE_PERIOD_S, num_windows=30, window_ms=5_000,
        spool_dir=spool_dir, spool_max_bytes=SPOOL_CAP_BYTES,
    )
    # the census covers the whole sampling run, warmup included
    prof_mark = prof.mark()
    census_mark = PROFILER.mark()
    launches = _kernel_launches()
    compile_mark = _rec.compile_mark()
    clock_ms = 1_000_000
    try:
        # warmup: first samples in a fresh process pay interpreter/numpy
        # first-touch costs that say nothing about steady-state overhead
        for _ in range(WARMUP_SAMPLES):
            clock_ms += int(SAMPLE_PERIOD_S * 1000)
            mon.sample(now_ms=clock_ms)
        walls: List[float] = []
        for n in range(OVERHEAD_SAMPLES):
            # between-sample activity: a busy app, every timer hot
            for t in timers:
                t.update(0.002)
            reg.counter("Bench.c0").inc()
            reg.gauge("Bench.g0").set(float(n))
            clock_ms += int(SAMPLE_PERIOD_S * 1000)
            t0 = time.perf_counter()
            mon.sample(now_ms=clock_ms)
            walls.append(time.perf_counter() - t0)
        walls.sort()
        sample_p50 = _percentile(walls, 0.50)
        spool_bytes = os.path.getsize(mon.spool_path) if mon.spool_path else 0
        return {
            "overhead_samples": OVERHEAD_SAMPLES,
            "series_count": len(mon.series_names()),
            "sample_p50_s": sample_p50,
            "sample_p95_s": _percentile(walls, 0.95),
            "sample_mean_s": sum(walls) / len(walls),
            "tick_p50_s": tick_p50_s,
            "overhead_ratio": sample_p50 / tick_p50_s,
            "sampler_dispatches": prof.mark().calls - prof_mark.calls + PROFILER.mark().calls - census_mark.calls,
            "sampler_kernel_launches": _kernel_launches() - launches,
            "sampler_compile_events": len(_rec.compile_events_since(compile_mark)),
            "spool_rotations": mon.spool_rotations,
            "spool_errors": mon.spool_errors,
            "spool_bytes": spool_bytes,
            "stable_windows": mon.status()["windows"]["stable"],
        }
    finally:
        mon.stop()
        shutil.rmtree(spool_dir, ignore_errors=True)


def run_slo_phases(inject_sleep_s: float = 0.0) -> Dict[str, object]:
    """Phases 2-4: quiet (no false positives), burn (fast pair fires in ≤ 2
    periods, finder emits one anomaly whose heal pauses the controller),
    recovery (short window clears, finder auto-resumes)."""
    reg = _seeded_registry()
    rec = FlightRecorder()
    prof = DeviceProfiler()
    rec.record(_tick_record(0.0))
    mon = SelfMonitor(
        registry=reg, recorder=rec, profiler=prof,
        interval_s=SAMPLE_PERIOD_S, num_windows=30, window_ms=5_000,
    )
    clock_ms = 2_000_000
    engine = SloEngine(
        shipped_specs(BENCH_SLO_CONFIG.get), mon, pairs=list(BENCH_PAIRS),
        now_ms=lambda: clock_ms,
    )
    controller = _StubController()
    finder_clock = [0.0]
    finder = SelfMetricAnomalyFinder(
        engine, controller=controller, cooldown_s=300.0,
        now=lambda: finder_clock[0],
    )
    reaction = reg.timer(CONTROLLER_REACTION_TIMER)

    def step(latency_s: Optional[float], real_sleep: bool = False,
             repeats: int = 1) -> list:
        nonlocal clock_ms
        clock_ms += int(SAMPLE_PERIOD_S * 1000)
        finder_clock[0] += SAMPLE_PERIOD_S
        for _ in range(repeats if latency_s is not None else 0):
            if real_sleep:
                with reaction.time():
                    time.sleep(latency_s)
            else:
                reaction.update(latency_s)
        mon.sample(now_ms=clock_ms)
        return finder.run()

    # -- quiet: healthy latencies, zero alerts allowed ----------------------
    quiet_false_positives = 0
    for _ in range(QUIET_PERIODS):
        anomalies = step(GOOD_LATENCY_S)
        quiet_false_positives += len(anomalies)
        quiet_false_positives += len(engine.firing())

    # -- burn: one bad latency per period until the fast pair fires ---------
    burn_periods_to_alert = None
    anomalies_emitted = 0
    heal_actions: List[str] = []
    for period in range(1, BURN_PERIODS + 1):
        anomalies = step(
            inject_sleep_s if inject_sleep_s > 0 else 10 * GOOD_LATENCY_S,
            real_sleep=inject_sleep_s > 0,
            repeats=BURN_BAD_PER_PERIOD,
        )
        for anomaly in anomalies:
            anomalies_emitted += 1
            fix = anomaly.fix_with(None)
            heal_actions.extend(fix["actions"])
        fast_firing = [
            a for a in engine.firing()
            if a.slo == "reaction-latency-p99" and a.pair == "fast"
        ]
        if fast_firing and burn_periods_to_alert is None:
            burn_periods_to_alert = period
    paused_by_heal = bool(
        controller.pauses
        and controller.pauses[0].startswith(SelfMetricAnomalyFinder.REASON_PREFIX)
    )

    # -- recovery: healthy traffic flushes the ring; short window clears ----
    recovery_periods = None
    for period in range(1, RECOVERY_PERIODS + 1):
        for _ in range(300):        # normal traffic resumed at good latency
            reaction.update(GOOD_LATENCY_S)
        step(None)
        if not engine.firing() and recovery_periods is None:
            recovery_periods = period
    auto_resumed = bool(controller.resumes) and not controller.paused

    return {
        "quiet_periods": QUIET_PERIODS,
        "quiet_false_positives": quiet_false_positives,
        "inject_sleep_s": inject_sleep_s,
        "burn_periods": BURN_PERIODS,
        "burn_periods_to_alert": burn_periods_to_alert,
        "anomalies_emitted": anomalies_emitted,
        "finder_anomalies_emitted": finder.anomalies_emitted,
        "heal_actions": sorted(set(heal_actions)),
        "paused_by_heal": paused_by_heal,
        "recovery_periods": recovery_periods,
        "auto_resumed": auto_resumed,
        "slo_evaluations": engine.evaluations,
    }


def run_bench(
    inject_sleep_s: float = INJECT_SLEEP_S,
    tick_p50_s: Optional[float] = None,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """The full bench: overhead + quiet/burn/recovery, one flat result doc.
    Without ``tick_p50_s`` the controller harness runs first on ``device``
    (``cuda`` unless ``device="cpu"``) to measure it."""
    if tick_p50_s is None:
        tick_p50_s = controller_tick_p50_s(device)
    t0 = time.perf_counter()
    doc: Dict[str, object] = {}
    doc.update(run_overhead_phase(tick_p50_s))
    doc.update(run_slo_phases(inject_sleep_s))
    doc["wall_s"] = time.perf_counter() - t0
    return doc


#: the overhead bound of the JAX bench's acceptance (``scripts/bench_selfmon.py``)
MAX_OVERHEAD_RATIO = 0.01


def contract_failures(doc: Dict[str, object]) -> List[str]:
    """The bench's absolute acceptance bounds (those of the JAX package's
    ``scripts/bench_selfmon.py``), one message per broken bound: the
    sampler's overhead, no kernel call, launch or compile event while
    sampling, no alert in the quiet phase, the fast pair within
    ``MAX_PERIODS_TO_ALERT`` periods of the burn, one or two anomalies for
    the sustained burn (the slow pair, then the fast one joining), the
    heal's pause and the resume after recovery."""
    failures = []
    if doc["overhead_ratio"] > MAX_OVERHEAD_RATIO:
        failures.append(f"sampler overhead {doc['overhead_ratio']:.4f} of the warm tick p50 > {MAX_OVERHEAD_RATIO}")
    if doc["sampler_dispatches"] or doc["sampler_kernel_launches"] or doc["sampler_compile_events"]:
        failures.append(
            f"the sampler made {doc['sampler_dispatches']} kernel call(s), "
            f"{doc['sampler_kernel_launches']} launch(es) and {doc['sampler_compile_events']} compile event(s)"
        )
    if doc["quiet_false_positives"]:
        failures.append(f"{doc['quiet_false_positives']} false positive(s) in the quiet phase")
    if doc["burn_periods_to_alert"] is None or doc["burn_periods_to_alert"] > MAX_PERIODS_TO_ALERT:
        failures.append(f"the fast pair fired after {doc['burn_periods_to_alert']} burn period(s)")
    if not 1 <= doc["anomalies_emitted"] <= 2:
        failures.append(f"{doc['anomalies_emitted']} anomalies for one sustained burn")
    if not doc["paused_by_heal"]:
        failures.append("the heal did not pause the controller")
    if doc["recovery_periods"] is None or not doc["auto_resumed"]:
        failures.append(f"no resume after recovery ({doc['recovery_periods']}, {doc['auto_resumed']})")
    return failures
