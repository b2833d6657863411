"""The port's self-monitoring plane against the JAX package's.

``obs/selfmon.py`` (the sampler), ``obs/slo.py`` (burn-rate SLOs),
``detector.SelfMetricAnomalyFinder`` and ``obs/selfmon_bench.py``.  The JAX
test classes of ``tests/test_selfmon.py`` run unchanged against the port
(``port_test_module``; ``TestSloApi`` over the port's HTTP app, bound to
``device="cpu"`` explicitly).  Then one seeded registry, recorder and profiler census per package
on one fake clock: the sampled series, their windows, and the SLO statuses and
alerts are equal across packages; and the port's bench meets the JAX bench's
acceptance on the CPU, with the port's own controller tick as denominator.
"""

from __future__ import annotations

import numpy as np

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_selfmon", device="cpu")
TestTimerPercentiles = _PORTED.TestTimerPercentiles
TestBatchedAggregator = _PORTED.TestBatchedAggregator
TestSelfMonitor = _PORTED.TestSelfMonitor
TestFlightJsonlRotation = _PORTED.TestFlightJsonlRotation
TestSloEngine = _PORTED.TestSloEngine
TestSelfMetricAnomalyFinder = _PORTED.TestSelfMetricAnomalyFinder
served_app = _PORTED.served_app
TestSloApi = _PORTED.TestSloApi


def _package(name: str):
    """The classes and functions one package's plane is built from."""
    import types

    if name == "jax":
        from cruise_control_tpu.core import sensors
        from cruise_control_tpu.obs import profiler, recorder, selfmon, slo
    else:
        from cruise_control_tpu_torch.core import sensors
        from cruise_control_tpu_torch.obs import profiler, recorder, selfmon, slo
    return types.SimpleNamespace(sensors=sensors, profiler=profiler, recorder=recorder, selfmon=selfmon, slo=slo)


#: the SLO config the shipped specs are bound to (the JAX bench's)
SLO_CONFIG = {
    "slo.burn.budget": 0.01,
    "slo.reaction.p99.objective.s": 0.050,
    "slo.shed.ratio.objective": 0.05,
    "slo.degraded.ratio.objective": 0.05,
    "slo.dispatch.budget": 7.0,
    "slo.recompile.objective": 0.0,
    "slo.replication.staleness.objective.ms": 2000.0,
}


def _seeded_run(name: str, seed: int = 5, samples: int = 24):
    """One package's registry, recorder and profiler, driven by the same
    seeded activity between samples on one fake clock; the shipped SLOs
    evaluated after every sample.  Returns (series per sample, windows,
    statuses per evaluation, firing alerts at the end)."""
    P = _package(name)
    s = P.sensors
    reg = s.SensorRegistry()
    rec = P.recorder.FlightRecorder()
    prof = P.profiler.DeviceProfiler()
    mon = P.selfmon.SelfMonitor(registry=reg, recorder=rec, profiler=prof, num_windows=6, window_ms=4_000)
    engine = P.slo.SloEngine(P.slo.shipped_specs(SLO_CONFIG.get), mon,
                             pairs=[P.slo.WindowPair("fast", 10.0, 3.0, 14.4),
                                    P.slo.WindowPair("slow", 60.0, 10.0, 1.0)])
    rng = np.random.default_rng(seed)
    out_series, statuses = [], []
    for n in range(samples):
        now = 1_000_000 + 1_000 * n
        for _ in range(int(rng.integers(1, 4))):
            reg.timer(s.CONTROLLER_REACTION_TIMER).update(float(rng.choice([0.01, 0.02, 0.3])))
        reg.timer(s.PROPOSAL_COMPUTATION_TIMER).update(float(rng.uniform(0.1, 2.0)))
        reg.counter(s.ADMISSION_ADMITTED_COUNTER).inc(int(rng.integers(5, 50)))
        reg.counter(s.ADMISSION_SHED_COUNTER).inc(int(rng.integers(0, 3)))
        reg.counter(s.OPTIMIZE_DEADLINE_COUNTER).inc(int(rng.integers(0, 2)))
        reg.gauge(s.REPLICATION_STALENESS_GAUGE).set(float(rng.uniform(0, 3_000)))
        reg.meter("Bench.m0").mark(int(rng.integers(1, 5)))
        rec.record(P.recorder.TraceRecord(kind="controller_tick", trace_id=f"t{n}", started_at=float(n),
                                          duration_s=0.01, platform="cpu",
                                          attrs={"num_dispatches": int(rng.integers(3, 12))}))
        key = ("segment_sum_f32", n % 3)
        _, fresh = prof.on_call("segment_sum_f32", key, f"shape {n % 3}", 0.0, [])
        if fresh:
            prof.set_analysis(key, {"flops": 1_000.0 * (n % 3 + 1), "bytes accessed": 4_000.0})
        out_series.append(mon.sample(now_ms=now))
        statuses.append(engine.evaluate(now_ms=now))
    windows = mon.windows()
    firing = sorted((a.slo, a.pair, a.since_ms) for a in engine.firing())
    return out_series, windows, statuses, firing


def test_series_windows_and_alerts_equal_across_packages():
    """The same seeded activity on one fake clock: every sample's series
    (names and values), the window view, every SLO status and the firing
    alerts are the JAX package's."""
    j_series, j_windows, j_status, j_firing = _seeded_run("jax")
    p_series, p_windows, p_status, p_firing = _seeded_run("port")
    assert [sorted(s) for s in p_series] == [sorted(s) for s in j_series]
    assert p_series == j_series
    assert p_windows == j_windows and p_windows["window_ids"]
    assert p_status == j_status
    assert p_firing == j_firing and p_firing   # the seeded burn fires


def test_shipped_specs_equal_but_for_descriptions():
    """The shipped objectives are the JAX package's (names, series,
    objectives, comparisons, budgets); only the wording of a description
    names the port's counterpart of a JAX term."""
    J, P = _package("jax"), _package("port")

    def strip(specs):
        return [{k: v for k, v in sp.to_dict().items() if k != "description"} for sp in specs]

    assert strip(P.slo.shipped_specs(SLO_CONFIG.get)) == strip(J.slo.shipped_specs(SLO_CONFIG.get))
    assert [p.to_dict() for p in P.slo.DEFAULT_PAIRS] == [p.to_dict() for p in J.slo.DEFAULT_PAIRS]


def test_spool_records_read_back_in_the_other_package(tmp_path):
    """A spool the port's sampler writes reads back through the JAX
    ``read_spool``, and the other way round: the schema is one."""
    J, P = _package("jax"), _package("port")
    for writer, reader in ((P, J), (J, P)):
        reg = writer.sensors.SensorRegistry()
        reg.gauge("F.g").set(3.0)
        d = tmp_path / writer.selfmon.__name__.split(".")[0]
        mon = writer.selfmon.SelfMonitor(registry=reg, recorder=writer.recorder.FlightRecorder(),
                                         profiler=writer.profiler.DeviceProfiler(), spool_dir=str(d))
        series = [mon.sample(now_ms=1_000 * (i + 1)) for i in range(3)]
        mon.stop()
        assert [r["series"] for r in reader.selfmon.read_spool(mon.spool_path)] == series


def test_selfmon_bench_meets_its_contract_on_the_cpu():
    """``run_bench`` on the CPU port: the controller harness's warm tick p50
    measured in this process as the denominator, the JAX bench's acceptance
    bounds (overhead under 1 %, no kernel call, launch or compile event
    while sampling, no false positive, the fast pair within two periods,
    the heal's pause and resume); the SLO phases' result equals the JAX
    bench's."""
    from cruise_control_tpu.obs import selfmon_bench as jbench
    from cruise_control_tpu_torch.obs import selfmon_bench as bench

    doc = bench.run_bench(inject_sleep_s=0.0, device="cpu")
    assert bench.contract_failures(doc) == []
    assert doc["tick_p50_s"] > 0 and doc["series_count"] == 85
    slo_keys = set(jbench.run_slo_phases(0.0))
    assert {k: doc[k] for k in slo_keys} == jbench.run_slo_phases(0.0)


def test_bench_contract_flags_a_sampler_that_launched():
    """The acceptance check is not vacuous: a doc with a kernel launch in
    the sampling run or a quiet-phase alert fails it."""
    from cruise_control_tpu_torch.obs import selfmon_bench as bench

    good = {"overhead_ratio": 0.001, "sampler_dispatches": 0, "sampler_kernel_launches": 0,
            "sampler_compile_events": 0, "quiet_false_positives": 0, "burn_periods_to_alert": 1,
            "anomalies_emitted": 2, "paused_by_heal": True, "recovery_periods": 3, "auto_resumed": True}
    assert bench.contract_failures(good) == []
    for bad in ({"sampler_kernel_launches": 1}, {"quiet_false_positives": 1}, {"overhead_ratio": 0.5},
                {"burn_periods_to_alert": None}):
        assert len(bench.contract_failures({**good, **bad})) == 1
