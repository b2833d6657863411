"""The port's exporter and profiler census against the JAX package's.

``obs/exporter.py`` renders the telemetry plane as Prometheus text and parses
it back strictly.  The JAX test classes ``TestExporterRender`` and
``TestExpositionParser`` of ``tests/test_telemetry.py`` run unchanged against
the port (``port_test_module``); the gate family carries the port's own
committed gate baseline (``obs/gate.py``) for the process's device, and a
test here pins its label set.  ``TestServedTelemetry`` runs over the port's HTTP app (the JAX
``tests/test_api.py`` builder, ported, bound to ``device="cpu"``).  For one seeded registry, recorder, profiler and SLO engine the
port's page is the JAX page, line for line, but for that family's samples.  Then the
census (``obs/profiler.py``): a CPU solve's ``cost`` block sums its kernel
calls' reckoned work.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_telemetry", device="cpu")
TestExpositionParser = _PORTED.TestExpositionParser
served = _PORTED.served
TestServedTelemetry = _PORTED.TestServedTelemetry


class TestExporterRender(_PORTED.TestExporterRender):
    def test_no_gate_family_until_the_port_has_a_gate(self):
        """The port has its gate: the family is on the page, one sample a
        (tier, metric) of the port's committed baseline for this process's
        device, with the JAX exporter's metrics."""
        from cruise_control_tpu_torch.core.sensors import SensorRegistry
        from cruise_control_tpu_torch.obs.exporter import parse_exposition, render_prometheus
        from cruise_control_tpu_torch.obs.profiler import DeviceProfiler
        from cruise_control_tpu_torch.obs.recorder import FlightRecorder

        text = render_prometheus(registry=SensorRegistry(), recorder=FlightRecorder(), profiler=DeviceProfiler())
        samples = parse_exposition(text)["cruise_control_tpu_gate_baseline"]["samples"]
        assert {tuple(sorted(dict(labels))) for labels, _ in samples} == {("metric", "tier")}
        assert {(dict(labels)["tier"], dict(labels)["metric"]): v for labels, v in samples} == _port_gate_samples()


def _port_gate_samples() -> dict:
    """(tier, metric) -> value of the port's committed gate baseline for this
    process's device (the CPU without a card), for the metrics the JAX
    exporter renders."""
    import json
    import os

    from cruise_control_tpu.obs.exporter import _GATE_METRICS
    from cruise_control_tpu_torch.obs import gate

    device = "cuda" if torch.cuda.is_available() else "cpu"
    doc = json.load(open(os.path.join(gate._repo_root(), gate.baseline_path(device))))
    return {(tier, metric): float(m[metric]) for tier, m in doc["tiers"].items()
            for metric in _GATE_METRICS if m.get(metric) is not None}


def _package(name: str):
    import types

    if name == "jax":
        from cruise_control_tpu.core import sensors
        from cruise_control_tpu.obs import exporter, profiler, recorder, selfmon, slo
    else:
        from cruise_control_tpu_torch.core import sensors
        from cruise_control_tpu_torch.obs import exporter, profiler, recorder, selfmon, slo
    return types.SimpleNamespace(sensors=sensors, exporter=exporter, profiler=profiler, recorder=recorder,
                                 selfmon=selfmon, slo=slo)


def _seeded_page(name: str, seed: int = 9) -> str:
    """One package's page for a registry, recorder, profiler and SLO engine
    seeded from numpy: timers, gauges, counters, meters with dotted and bare
    names and a label value that needs escaping; flight records of three
    kinds over a small ring; a census of two kernels; the readiness gauges;
    the shipped SLOs over a sampled self-monitor, with its window view."""
    P = _package(name)
    s = P.sensors
    rng = np.random.default_rng(seed)
    reg = s.SensorRegistry()
    for i in range(6):
        t = reg.timer(f"Family{i % 3}.timer-{i}")
        for v in rng.uniform(0.001, 2.0, size=int(rng.integers(1, 40))):
            t.update(float(v))
    reg.timer(s.CONTROLLER_REACTION_TIMER).update(0.25)
    for i in range(5):
        reg.gauge(f"Family{i % 2}.gauge-{i}").set(float(rng.normal() * 1e3))
    reg.gauge('Weird.a"b\\c').set(1.5)
    reg.gauge("bare-gauge").set(7.0)
    reg.gauge(s.READY_GAUGE).set(1.0)
    reg.gauge(s.RECOVERY_WALL_GAUGE).set(0.125)
    reg.gauge(s.RECOVERY_RECORDS_GAUGE).set(12.0)
    reg.gauge(s.REPLICATION_STALENESS_GAUGE).set(250.0)
    for i in range(4):
        reg.counter(f"Family{i}.counter").inc(int(rng.integers(0, 100)))
    reg.counter(s.REPLICATION_APPLIED_COUNTER).inc(5)
    reg.meter("Family0.meter").mark(int(rng.integers(1, 9)))
    rec = P.recorder.FlightRecorder(capacity=5)
    for i, kind in enumerate(["optimize", "model", "controller_tick"] * 3):
        rec.record(P.recorder.TraceRecord(kind=kind, trace_id=f"t{i}", started_at=float(i), duration_s=0.1,
                                          platform="cpu", attrs={"num_dispatches": 5}))
    prof = P.profiler.DeviceProfiler()
    for i, program in enumerate(["segment_sum_f32", "segment_sum_i32", "segment_sum_f32"]):
        key = (program, i)
        prof.on_call(program, key, f"shape {i}", 0.001 * (i + 1), [])
        prof.set_analysis(key, {"flops": 100.0 * (i + 1), "bytes accessed": 64.0 * (i + 1)})
    mon = P.selfmon.SelfMonitor(registry=reg, recorder=rec, profiler=prof, num_windows=4, window_ms=2_000)
    engine = P.slo.SloEngine(P.slo.shipped_specs({
        "slo.burn.budget": 0.01, "slo.reaction.p99.objective.s": 0.05, "slo.shed.ratio.objective": 0.05,
        "slo.degraded.ratio.objective": 0.05, "slo.dispatch.budget": 7.0, "slo.recompile.objective": 0.0,
        "slo.replication.staleness.objective.ms": 2000.0}.get), mon)
    for n in range(8):
        reg.gauge("Family1.gauge-1").set(float(n))
        mon.sample(now_ms=10_000 + 1_000 * n)
        engine.evaluate(now_ms=10_000 + 1_000 * n)
    return P.exporter.render_prometheus(registry=reg, recorder=rec, profiler=prof, slo_engine=engine,
                                        selfmon=mon, selfmon_window=3)


def _drop_family(text: str, family: str) -> str:
    """``text`` without the HELP, TYPE and sample lines of ``family``."""
    heads = (f"# HELP {family} ", f"# TYPE {family} ", f"{family}{{", f"{family} ")
    return "\n".join(ln for ln in text.split("\n") if not ln.startswith(heads))


def test_the_page_equals_the_jax_page_less_the_gate_family():
    """Line for line the JAX page, but for the gate family's samples: the
    same HELP and TYPE, and the JAX labels over the port's own baseline."""
    jax_page, port_page = _seeded_page("jax"), _seeded_page("port")
    gate = "cruise_control_tpu_gate_baseline"
    assert _drop_family(port_page, gate) == _drop_family(jax_page, gate)
    heads = [ln for ln in port_page.split("\n") if ln.startswith(("# HELP " + gate, "# TYPE " + gate))]
    assert heads == [ln for ln in jax_page.split("\n") if ln.startswith(("# HELP " + gate, "# TYPE " + gate))]
    parsed = _package("port").exporter.parse_exposition(port_page)
    jax_labels = {tuple(sorted(dict(labels))) for labels, _ in
                  _package("jax").exporter.parse_exposition(jax_page)[gate]["samples"]}
    assert {tuple(sorted(dict(labels))) for labels, _ in parsed[gate]["samples"]} == jax_labels
    assert {(dict(labels)["tier"], dict(labels)["metric"]): v
            for labels, v in parsed[gate]["samples"]} == _port_gate_samples()
    assert {"cruise_control_tpu_slo_alert_firing", "cruise_control_tpu_executable_flops_total",
            "cruise_control_tpu_selfmon_window_value", "cruise_control_tpu_ready"} <= set(parsed)


def _census_totals():
    from cruise_control_tpu_torch.obs.profiler import PROFILER

    return {k: dict(v) for k, v in PROFILER.per_program_totals().items()}


def test_a_cpu_solve_cost_block_is_the_sum_of_its_kernel_calls():
    """A CPU solve's ``cost`` block: its kernel calls (plain calls on the CPU,
    under the path a CUDA tensor would launch) and the operations and bytes
    reckoned from their shapes, equal to the census totals' growth over the
    solve, per-signature reckoning times calls."""
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.obs import RECORDER
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from tests.torch_port_helpers import CONFIG1

    state, maps = generate(SyntheticSpec(**CONFIG1), device="cpu")
    goals = (G.RACK_AWARE, G.REPLICA_CAPACITY, G.DISK_CAPACITY, G.REPLICA_DISTRIBUTION, G.LEADER_REPLICA_DIST)
    opt = GoalOptimizer(goal_ids=goals, hard_ids=tuple(g for g in goals if g in G.HARD_GOALS), device="cpu")
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cpu")
    before = _census_totals()
    opt.optimize(state, ctx, maps=maps)
    after = _census_totals()
    cost = RECORDER.recent(1, kind="optimize")[0].attrs["cost"]
    grown = {k: {f: after[k][f] - before.get(k, {}).get(f, 0) for f in ("calls", "flops_total", "bytes_total")}
             for k in after}
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0 and cost["unanalyzed_calls"] == 0
    assert cost["profiled_calls"] == sum(g["calls"] for g in grown.values())
    assert cost["flops"] == pytest.approx(sum(g["flops_total"] for g in grown.values()), rel=1e-12)
    assert cost["bytes_accessed"] == pytest.approx(sum(g["bytes_total"] for g in grown.values()), rel=1e-12)
    assert grown["segment_sum_f32"]["calls"] > 0 and grown["segment_sum_i32"]["calls"] > 0


def test_one_call_is_reckoned_by_the_smoke_bound_formula():
    """The census's reckoning of one call is the smoke's ``bound_ms`` input:
    ``R * columns`` additions, and the ids, value columns and sums read or
    written once (int32 ids, f32 / i32 sums, a bool column one byte a row)."""
    from cruise_control_tpu_torch.obs.profiler import PROFILER
    from cruise_control_tpu_torch.ops import assign, segments

    R, S = 1_000, 7
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, S, R))
    mark = PROFILER.mark()
    segments.segment_sums([torch.ones(R, 4), torch.ones(R, dtype=torch.bool)], ids, S)
    segments.segment_sums([torch.ones(R, dtype=torch.int32)], ids, S)
    segments.segment_sums([torch.ones(R)], ids, 0)                    # no segments: no kernel, no call
    cost = PROFILER.cost_since(mark)
    assert cost["profiled_calls"] == 2
    f32 = (R * 5, 4 * R + R * (4 * 4 + 1) + 4 * S * 5)
    i32 = (R, 4 * R + 4 * R + 4 * S)
    assert (cost["flops"], cost["bytes_accessed"]) == (f32[0] + i32[0], f32[1] + i32[1])
    P, B, pos = 12, 6, 1
    counts = torch.zeros(B, dtype=torch.int32)
    chosen = torch.full((P, 3), -1, dtype=torch.int32)
    chosen[:, 0] = torch.arange(P, dtype=torch.int32) % B
    mark = PROFILER.mark()
    assign.even_assign(counts, chosen, pos, torch.full((P,), 3, dtype=torch.int32), torch.zeros(P, dtype=torch.bool),
                       torch.arange(B, dtype=torch.int32) % 3, torch.ones(B, dtype=torch.bool))
    cost = PROFILER.cost_since(mark)
    assert (cost["profiled_calls"], cost["flops"]) == (1, 2 * P * B)
    assert cost["bytes_accessed"] == 8 * B + 4 * P * pos + 4 * P + 5 * P + 5 * B


def test_a_disabled_profiler_records_no_kernel_call(monkeypatch):
    from cruise_control_tpu_torch.obs.profiler import PROFILER
    from cruise_control_tpu_torch.ops import segments

    monkeypatch.setattr(PROFILER, "_enabled", False)
    mark = PROFILER.mark()
    segments.segment_sum(torch.ones(10), torch.arange(10) % 3, 3)
    assert PROFILER.mark() == mark


def test_the_census_window_is_running_totals_without_a_cap():
    """``mark`` / ``cost_since`` difference running totals: a window longer
    than any log cap counts every call, a reckoning attached after a call
    (``set_analysis``, the JAX contract) moves that call from unanalysed to
    reckoned, and the two registration forms of ``on_call`` agree."""
    from cruise_control_tpu_torch.obs.profiler import DeviceProfiler

    prof = DeviceProfiler()
    prof.enabled = True
    mark = prof.mark()
    n = 70_000
    for i in range(n):
        prof.on_call("segment_sum_f32", ("segment_sum_f32", i % 2), lambda: ("sig", 3.0, 8.0), 0.0)
    cost = prof.cost_since(mark)
    assert (cost["profiled_calls"], cost["unanalyzed_calls"]) == (n, 0)
    assert (cost["flops"], cost["bytes_accessed"]) == (3.0 * n, 8.0 * n)
    mark = prof.mark()
    prof.on_call("segment_sum_i32", ("late",), "sig", 0.0)
    assert prof.cost_since(mark)["unanalyzed_calls"] == 1
    prof.set_analysis(("late",), {"flops": 5.0, "bytes accessed": 7.0})
    prof.on_call("segment_sum_i32", ("late",), "sig", 0.0)
    cost = prof.cost_since(mark)
    assert (cost["profiled_calls"], cost["unanalyzed_calls"], cost["flops"], cost["bytes_accessed"]) == (2, 0, 10.0, 14.0)
    assert prof.per_program_totals()["segment_sum_i32"]["flops_total"] == 10.0


class TestProfiler:
    """``test_telemetry.TestProfiler`` with the port's ``profile_jit``: it
    wraps a callable (the port has no compiler, so no cost analysis), counts
    calls per argument-shape signature and is transparent when disabled."""

    def _entries(self, program):
        from cruise_control_tpu_torch.obs.profiler import PROFILER

        return [e for e in PROFILER.snapshot()["executables"] if e["program"] == program]

    def test_wrapper_registers_without_analysis(self):
        from cruise_control_tpu_torch.obs.profiler import PROFILER, profile_jit

        fn = profile_jit("test.square", lambda x: (x * x).sum())
        x = torch.arange(64, dtype=torch.float32)
        mark = PROFILER.mark()
        assert float(fn(x)) == float((x * x).sum())
        cost = PROFILER.cost_since(mark)
        assert (cost["profiled_calls"], cost["unanalyzed_calls"], cost["flops"]) == (1, 1, 0.0)
        (entry,) = self._entries("test.square")
        assert entry["calls"] == 1 and entry["analysis"] == "unavailable" and entry["flops"] is None
        assert PROFILER.per_program_totals()["test.square"]["calls"] == 1

    def test_warm_calls_count_and_new_shapes_are_new_signatures(self):
        from cruise_control_tpu_torch.obs.profiler import profile_jit

        fn = profile_jit("test.shapes", lambda x: x * 2)
        for n in (4, 4, 4, 16):
            fn(torch.ones(n))
        assert sorted(e["calls"] for e in self._entries("test.shapes")) == [1, 3]

    def test_disabled_profiler_is_transparent(self, monkeypatch):
        from cruise_control_tpu_torch.obs.profiler import PROFILER, profile_jit

        monkeypatch.setattr(PROFILER, "_enabled", False)
        assert float(profile_jit("test.off", lambda x: x - 1)(torch.ones(1))) == 0.0
        assert self._entries("test.off") == []
