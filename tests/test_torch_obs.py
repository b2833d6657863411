"""The port's flight recorder and device-memory profiler against the JAX package.

The cases of ``tests/test_obs.py`` (``TestRecorder``, ``TestOptimizeTrace``,
``TestSubsystemTraces::test_executor_trace``) run against the port, where a
span's ``dispatches`` and the ``num_dispatches`` attribute count host syncs.
The compile log holds one event per ``nvcc`` build (``ops/_build.py``), so
its trim case drives :func:`record_compile_event` and a fake compiler.  A
sink written by either package reads back in the other, and the executor's
record has the JAX record's attribute and span names.  The recorder's ring
and the compile log are process-wide: each test that reads them clears the
ring first.
"""

import os
import stat

import numpy as np
import pytest
import torch

from cruise_control_tpu.obs import recorder as JR
from cruise_control_tpu_torch.obs import recorder as R
from cruise_control_tpu_torch.obs.profiler import DeviceProfiler
from cruise_control_tpu_torch.obs.recorder import (
    RECORDER,
    FlightRecorder,
    Span,
    TraceRecord,
    read_jsonl,
)
from tests.torch_port_helpers import port_state


def _sample_trace(kind="optimize", n_spans=3):
    return TraceRecord(
        kind=kind,
        trace_id=f"{kind}-test-1",
        started_at=1_700_000_000.0,
        duration_s=1.5,
        platform="cpu",
        attrs={"num_dispatches": n_spans, "balancedness": 98.5},
        spans=[Span(f"goal{i}", "goal", 0.5, 1, attrs={"moves": i}) for i in range(n_spans)],
        compile_events=[{"event": "nvcc/segment_sum", "duration_s": 0.25}],
    )


class TestRecorder:
    def test_ring_capacity_and_recent_order(self):
        rec = FlightRecorder(capacity=3)
        for i in range(5):
            t = _sample_trace()
            t.trace_id = f"t{i}"
            rec.record(t)
        assert [t.trace_id for t in rec.recent(10)] == ["t4", "t3", "t2"]
        assert rec.snapshot()["size"] == 3
        assert rec.snapshot()["dropped"] == 2

    def test_kind_filter(self):
        rec = FlightRecorder()
        rec.record(_sample_trace(kind="optimize"))
        rec.record(_sample_trace(kind="execution"))
        assert [t.kind for t in rec.recent(10, kind="execution")] == ["execution"]

    def test_multi_record_trim_counts_every_drop(self):
        rec = FlightRecorder(capacity=10)
        for _ in range(10):
            rec.record(_sample_trace())
        rec.capacity = 4
        rec.record(_sample_trace())
        snap = rec.snapshot()
        assert snap["size"] == 4
        assert snap["dropped"] == 7

    def test_read_jsonl_tolerates_truncated_trailing_line(self, tmp_path):
        path = str(tmp_path / "flight.jsonl")
        rec = FlightRecorder(jsonl_path=path)
        rec.record(_sample_trace())
        rec.record(_sample_trace(kind="execution"))
        whole = open(path).read()
        open(path, "w").write(whole[: len(whole) - 40].rstrip("\n") + "\n")
        loaded = read_jsonl(path)
        assert len(loaded) == 1 and loaded[0].kind == "optimize"
        assert loaded.skipped == 1

    def test_read_jsonl_clean_sink_reports_zero_skipped(self, tmp_path):
        path = str(tmp_path / "flight.jsonl")
        rec = FlightRecorder(jsonl_path=path)
        rec.record(_sample_trace())
        loaded = read_jsonl(path)
        assert len(loaded) == 1 and loaded.skipped == 0

    def test_jsonl_round_trip(self, tmp_path):
        path = str(tmp_path / "flight.jsonl")
        rec = FlightRecorder(jsonl_path=path)
        orig = _sample_trace()
        rec.record(orig)
        rec.record(_sample_trace(kind="execution", n_spans=1))
        loaded = read_jsonl(path)
        assert len(loaded) == 2
        assert loaded[0].to_dict() == orig.to_dict()
        assert loaded[0].total_dispatches == orig.total_dispatches
        assert loaded[0].compile_s == pytest.approx(0.25)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_sinks_read_back_in_the_other_package(self, tmp_path, writer):
        path = str(tmp_path / "flight.jsonl")
        mod = JR if writer == "jax" else R
        rec = mod.FlightRecorder(jsonl_path=path)
        rec.record(mod.TraceRecord.from_dict(_sample_trace().to_dict()))
        for reader in (JR, R):
            (got,) = reader.read_jsonl(path)
            assert got.to_dict() == _sample_trace().to_dict()

    def test_sink_append_only(self, tmp_path):
        path = str(tmp_path / "flight.jsonl")
        rec = FlightRecorder(jsonl_path=path)
        rec.record(_sample_trace())
        first = open(path).read()
        rec.record(_sample_trace(kind="detector"))
        assert open(path).read().startswith(first)

    def test_compile_marks_survive_log_trim(self, monkeypatch):
        monkeypatch.setattr(R, "_COMPILE_LOG", [])
        monkeypatch.setattr(R, "_COMPILE_BASE", 0)
        monkeypatch.setattr(R, "_COMPILE_LOG_CAP", 4)
        for i in range(3):
            R.record_compile_event(f"nvcc/pre{i}", 0.1)
        mark = R.compile_mark()
        for i in range(6):   # crosses the cap: pre* and early mine* trimmed
            R.record_compile_event(f"nvcc/mine{i}", 0.1)
        events = [e["event"].rsplit("/", 1)[-1] for e in R.compile_events_since(mark)]
        assert events == ["mine2", "mine3", "mine4", "mine5"]

    def test_finish_trace_never_raises(self, monkeypatch):
        token = R.start_trace("optimize")
        monkeypatch.setattr(
            R.RECORDER, "record", lambda trace: (_ for _ in ()).throw(RuntimeError("sink down"))
        )
        assert R.finish_trace(token, attrs={"x": 1}) is None

    def test_sensors_registered(self):
        from cruise_control_tpu_torch.core.sensors import (
            FLIGHT_RING_GAUGE,
            FLIGHT_TRACES_COUNTER,
            REGISTRY,
        )

        rec = FlightRecorder()
        before = REGISTRY.counter(FLIGHT_TRACES_COUNTER).snapshot()
        rec.record(_sample_trace())
        assert REGISTRY.counter(FLIGHT_TRACES_COUNTER).snapshot() == before + 1
        assert REGISTRY.gauge(FLIGHT_RING_GAUGE).snapshot() >= 1


def test_a_kernel_build_is_one_compile_event_of_the_trace_around_it(tmp_path, monkeypatch):
    """``ops._build.build`` records one event per ``nvcc`` run, and a trace
    open around the build carries it; a cached library records none."""
    from cruise_control_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    token = R.start_trace("optimize")
    path = _build.build("segment_sum")
    assert path.exists() and path.parent == tmp_path / "kernels"
    _build.build("segment_sum")   # up to date: no compiler run
    RECORDER.clear()
    trace = R.finish_trace(token)
    assert [e["event"] for e in trace.compile_events] == ["nvcc/segment_sum"]
    assert trace.compile_s >= 0.0


def test_platform_and_device_fields_name_the_torch_device(monkeypatch):
    assert R.mesh_metadata("cpu") == {"platform": "cpu", "device_count": 1, "process_count": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R._platform() == "cpu"
    RECORDER.clear()
    assert R.finish_trace(R.start_trace("model"), device=torch.device("cpu")).platform == "cpu"


def test_memory_sample_is_empty_on_the_cpu_and_when_disabled(monkeypatch):
    prof = DeviceProfiler()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert prof.sample_memory() == [] and prof.memory_peak_bytes() is None
    assert prof.snapshot() == {"enabled": True, "executables": [], "memory": []}
    monkeypatch.setenv("CC_TPU_PROFILER", "0")
    assert DeviceProfiler().enabled is False and DeviceProfiler().sample_memory() == []


# -- the optimize record (TestOptimizeTrace) ----------------------------------------


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from tests.fixtures import service_test_goals, unbalanced2

    path = str(tmp_path_factory.mktemp("obs") / "flight.jsonl")
    old_path = RECORDER.jsonl_path
    RECORDER.configure(path)
    try:
        jstate, maps = unbalanced2().to_arrays()
        state = port_state(jstate)
        ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cpu")
        goals = service_test_goals()
        opt = GoalOptimizer(goal_ids=goals, hard_ids=tuple(g for g in goals if g in G.HARD_GOALS),
                            enable_heavy_goals=False, device="cpu")
        _, result = opt.optimize(state, ctx, maps=maps)
    finally:
        RECORDER.configure(old_path)
    return result, path, len(goals)


class TestOptimizeTrace:
    def test_goal_spans_match_goal_list(self, traced_run):
        result, path, n_goals = traced_run
        trace = read_jsonl(path)[-1]
        goal_spans = [s for s in trace.spans if s.kind == "goal"]
        assert len(goal_spans) == n_goals == len(result.goal_reports)
        assert [s.name for s in goal_spans] == [r.name for r in result.goal_reports]
        assert [s.kind for s in trace.spans] == ["setup"] + ["goal"] * n_goals + ["finalize"]

    def test_span_dispatches_sum_to_num_dispatches(self, traced_run):
        result, path, _ = traced_run
        trace = read_jsonl(path)[-1]
        assert trace.total_dispatches == result.num_host_syncs
        assert trace.attrs["num_dispatches"] == trace.attrs["num_host_syncs"] == result.num_host_syncs
        assert all(s.dispatches >= 0 for s in trace.spans)

    def test_span_attrs_mirror_goal_reports(self, traced_run):
        result, path, _ = traced_run
        trace = read_jsonl(path)[-1]
        goal_spans = [s for s in trace.spans if s.kind == "goal"]
        for span, rep in zip(goal_spans, result.goal_reports):
            assert span.attrs["moves"] == rep.moves_applied
            assert span.attrs["rounds"] == rep.rounds
            assert span.attrs["violations_after"] == rep.violations_after

    def test_trace_metadata(self, traced_run):
        result, path, _ = traced_run
        trace = read_jsonl(path)[-1]
        assert trace.kind == "optimize"
        assert trace.platform == "cpu"
        assert trace.attrs["device_count"] >= 1
        assert trace.attrs["balancedness"] == pytest.approx(result.balancedness_score)
        cost = trace.attrs["cost"]
        # no CUDA memory on the CPU; the kernels' census counts the plain calls
        assert cost["memory_peak_bytes"] is None
        assert cost["flops"] > 0 and cost["bytes_accessed"] > 0 and cost["profiled_calls"] > 0

    def test_aborted_optimize_keeps_dispatch_invariant(self):
        from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
        from cruise_control_tpu_torch.analyzer import goals_base as G
        from cruise_control_tpu_torch.analyzer.optimizer import OptimizationFailure
        from tests.test_kafka_assigner import _piled_but_rack_aware

        jstate, _ = _piled_but_rack_aware()
        state = port_state(jstate)
        alive = state.broker_alive.clone()
        alive[2:] = False
        state = state.replace(broker_alive=alive)
        ctx = GoalContext.build(state.num_topics, state.num_brokers,
                                excluded_brokers_for_replica_move=(1,), device="cpu")
        opt = GoalOptimizer(goal_ids=(G.KAFKA_ASSIGNER_RACK,), hard_ids=(G.KAFKA_ASSIGNER_RACK,), device="cpu")
        RECORDER.clear()
        with pytest.raises(OptimizationFailure):
            opt.optimize(state, ctx, raise_on_hard_failure=True)
        trace = RECORDER.recent(1, kind="optimize")[0]
        assert "error" in trace.attrs
        aborted = [s for s in trace.spans if s.kind == "aborted"]
        assert [s.name for s in aborted] == [G.GOAL_NAMES[G.KAFKA_ASSIGNER_RACK]]
        assert trace.total_dispatches == trace.attrs["num_dispatches"] > 0


# -- the span tree of a solve --------------------------------------------------------

#: the child spans of each top-level span on the host driver (the CPU)
CHILDREN = {
    "setup": ["violations", "offline_repair"],
    "goal": ["snapshot", "rounds", "snapshot"],
    "finalize": ["violations", "fetch", "to_host", "report"],
}


@pytest.fixture(scope="module")
def batched_trace():
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.model.arrays import stack_arrays
    from tests.fixtures import service_test_goals, unbalanced2

    jstate, _ = unbalanced2().to_arrays()
    state = port_state(jstate)
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cpu")
    goals = service_test_goals()
    opt = GoalOptimizer(goal_ids=goals, hard_ids=tuple(g for g in goals if g in G.HARD_GOALS),
                        enable_heavy_goals=False, device="cpu")
    _, result = opt.batched_optimize(stack_arrays([state, state]), ctx)
    return result, RECORDER.recent(1, kind="optimize")[0]


@pytest.fixture(params=["optimize", "batched_optimize"])
def solve_trace(request, traced_run, batched_trace):
    """An optimize record read back from its JSONL sink, and a batched one
    from the ring, with the host syncs the call reported."""
    if request.param == "optimize":
        result, path, _ = traced_run
        return result.num_host_syncs, read_jsonl(path)[-1]
    result, trace = batched_trace
    return result.num_host_syncs, trace


def _walk(span):
    yield span
    for c in span.children:
        yield from _walk(c)


class TestSolveSpans:
    def test_top_level_spans_and_their_children(self, solve_trace):
        syncs, trace = solve_trace
        kinds = [s.kind for s in trace.spans]
        assert kinds == ["setup"] + ["goal"] * (len(kinds) - 2) + ["finalize"] and len(kinds) > 2
        assert trace.total_dispatches == trace.attrs["num_dispatches"] == syncs
        for s in trace.spans:
            assert [c.name for c in s.children] == CHILDREN[s.kind], s.name
            assert all(not c.children for c in s.children)

    def test_children_lie_inside_their_parents(self, solve_trace):
        _, trace = solve_trace
        eps = 1e-9
        for top in trace.spans:
            for s in _walk(top):
                assert s.start_s is not None and s.duration_s >= 0.0
                assert s.self_s >= -eps, s.name
                for c in s.children:
                    assert s.start_s <= c.start_s
                    assert c.start_s + c.duration_s <= s.start_s + s.duration_s + eps, (s.name, c.name)
        ends = [s.start_s + s.duration_s for s in trace.spans]
        assert all(a <= b.start_s + eps for a, b in zip(ends, trace.spans[1:]))
        assert ends[-1] <= trace.duration_s

    def test_host_wait_and_device_time_on_the_host_driver(self, solve_trace):
        _, trace = solve_trace
        assert 0.0 <= trace.attrs["host_wait_s"] <= trace.duration_s
        # no graph launched on the CPU: no device time, no stamps
        assert trace.attrs["graph_device_s"] is None
        assert all(s.attrs["device_s"] is None for s in trace.spans if s.kind == "goal")
        assert trace.spans[0].children[1].attrs["device_s"] is None
        assert trace.attrs.get("stamps_supported", False) is False


def test_self_time_is_the_duration_less_what_the_children_cover():
    parent = Span("p", "goal", 10.0, start_s=5.0, children=[
        Span("a", "step", 2.0, start_s=6.0), Span("b", "step", 1.5, start_s=8.0),
        Span("c", "step", 4.0, start_s=11.0),
    ])
    assert parent.self_s == pytest.approx(10.0 - 2.0 - 1.5 - 4.0)
    assert Span("leaf", "step", 1.5, start_s=0.0).self_s == 1.5
    assert Span("p", "goal", 3.0, children=[Span("a", "step", 1.0)]).self_s == 2.0


def test_goal_reports_take_the_goal_spans_wall_on_the_host_driver(traced_run):
    """No graph on the CPU: each goal's reported duration is its span's."""
    result, path, _ = traced_run
    goals = [s for s in read_jsonl(path)[-1].spans if s.kind == "goal"]
    assert [r.duration_s for r in result.goal_reports] == [s.duration_s for s in goals]


def test_span_tree_nests_in_order_and_names_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    tree = R.SpanTree("optimize")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tree.span("setup", "setup") as setup:
            with tree.span("violations"):
                torch.ones(4).sum()
        with tree.span("Goal", "goal"):
            with tree.span("snapshot"):
                pass
    assert [s.name for s in tree.root.children] == ["setup", "Goal"]
    assert [c.name for c in setup.children] == ["violations"]
    assert tree.root.children[1].children[0].start_s >= setup.start_s + setup.duration_s
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"cc/optimize/setup", "cc/setup/violations", "cc/optimize/Goal", "cc/goal/snapshot"} <= names


def test_host_syncs_time_their_waits():
    from cruise_control_tpu_torch.analyzer.optimizer import HostSyncs

    syncs = HostSyncs()
    assert syncs.tolist(torch.arange(3)) == [0, 1, 2]
    assert syncs.count == 1 and syncs.wait_s > 0.0
    # a call that writes no record keeps no span tree
    assert syncs.spans is None
    with syncs.span("snapshot") as s:
        assert s is None


class TestSpanSinks:
    def _tree_trace(self):
        child = Span("snapshot", "step", 0.25, start_s=0.5)
        goal = Span("RackAwareGoal", "goal", 1.0, 2, attrs={"moves": 3}, start_s=0.25,
                    children=[child, Span("launch", "step", 0.5, start_s=0.75, children=[
                        Span("inner", "step", 0.1, start_s=0.8)])])
        trace = _sample_trace()
        trace.spans = [Span("setup", "setup", 0.25, 1, start_s=0.0), goal]
        return trace

    def test_jsonl_round_trip_keeps_children(self, tmp_path):
        path = str(tmp_path / "flight.jsonl")
        orig = self._tree_trace()
        FlightRecorder(jsonl_path=path).record(orig)
        (got,) = read_jsonl(path)
        assert got.to_dict() == orig.to_dict()
        goal = got.spans[1]
        assert [c.name for c in goal.children] == ["snapshot", "launch"]
        assert goal.children[1].children[0].start_s == 0.8
        assert goal.self_s == pytest.approx(0.25) and got.total_dispatches == 3

    def test_a_span_without_start_or_children_still_loads(self):
        old = {"name": "goal0", "kind": "goal", "duration_s": 0.5, "dispatches": 1, "attrs": {"moves": 0}}
        span = Span.from_dict(old)
        assert span.start_s is None and span.children == [] and span.self_s == 0.5
        assert span.to_dict() == old
        rec = TraceRecord.from_dict({**_sample_trace().to_dict(), "spans": [old]})
        assert rec.spans[0].to_dict() == old and rec.total_dispatches == 1

    def test_the_jax_package_reads_a_tree_without_its_children(self, tmp_path):
        path = str(tmp_path / "flight.jsonl")
        FlightRecorder(jsonl_path=path).record(self._tree_trace())
        (got,) = JR.read_jsonl(path)
        assert [s.name for s in got.spans] == ["setup", "RackAwareGoal"]
        assert got.total_dispatches == 3


# -- the executor record ------------------------------------------------------------


def _execute(pkg):
    import importlib

    backend_mod = importlib.import_module(f"{pkg}.backend")
    executor_mod = importlib.import_module(f"{pkg}.executor")
    proposals = importlib.import_module(f"{pkg}.analyzer.proposals")
    recorder = importlib.import_module(f"{pkg}.obs.recorder")
    backend = backend_mod.FakeClusterBackend()
    for b in range(3):
        backend.add_broker(b, rack=str(b))
    backend.create_partition(("T", 0), [0, 1], load=[1.0, 1.0, 1.0, 1.0])
    recorder.RECORDER.clear()
    summary = executor_mod.Executor(backend).execute_proposals([
        proposals.ExecutionProposal(tp=("T", 0), partition_size=1.0, old_leader=0,
                                    old_replicas=(0, 1), new_replicas=(0, 2)),
    ])
    return summary, recorder.RECORDER.recent(5, kind="execution")


def test_executor_trace():
    summary, traces = _execute("cruise_control_tpu_torch")
    assert traces, "executor emitted no flight record"
    t = traces[0]
    assert t.attrs["completed"] == summary.completed == 1
    assert {s.name for s in t.spans} == {"inter_broker", "intra_broker", "leadership"}
    _, jtraces = _execute("cruise_control_tpu")
    j = jtraces[0]
    assert sorted(t.attrs) == sorted(j.attrs) and t.attrs["completed"] == j.attrs["completed"]
    assert [(s.name, s.kind, s.attrs) for s in t.spans] == [(s.name, s.kind, s.attrs) for s in j.spans]


def test_no_recorder_state_leaks_between_the_packages():
    JR.RECORDER.clear()
    RECORDER.clear()
    _execute("cruise_control_tpu_torch")
    assert JR.RECORDER.recent(5) == [] and len(RECORDER.recent(5)) == 1
    assert np.isfinite(RECORDER.recent(1)[0].duration_s)
    assert os.getpid() == int(RECORDER.recent(1)[0].trace_id.rsplit("-", 1)[1])
