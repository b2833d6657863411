"""The metrics that read the program's own records and counters, fed a fake
run on the CPU: the value from synthetic flight records, none from the
traced pass's calls, and no reading where no record carries the field."""

import types
from pathlib import Path

import pytest

from cruise_control_tpu_torch.obs import recorder as R
from portbench.run import load_module

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _metric(name):
    return load_module(METRICS / f"{name}.py", f"portbench_metric_{name}_test")


def _record(duration, wait, device, snapshots, violations=0.0):
    goal = R.Span("Goal", "goal", 1.0, start_s=0.1, children=[
        R.Span("snapshot", "step", snapshots / 2, start_s=0.1),
        R.Span("launch", "step", 0.01, start_s=0.2),
        R.Span("snapshot", "step", snapshots / 2, start_s=0.3),
    ])
    setup = R.Span("setup", "setup", 0.1, start_s=0.0, children=[R.Span("violations", "step", violations, start_s=0.0)])
    return R.TraceRecord(kind="optimize", trace_id="t", started_at=0.0, duration_s=duration, platform="cuda",
                         attrs={"host_wait_s": wait, "graph_device_s": device}, spans=[setup, goal])


@pytest.fixture
def ring(monkeypatch):
    rec = R.FlightRecorder()
    monkeypatch.setattr(R, "RECORDER", rec)
    return rec


def _run(calls, inputs=2):
    return types.SimpleNamespace(calls=[object()] * calls, inputs=[object()] * inputs,
                                 device=types.SimpleNamespace(type="cuda"), notes={})


def test_the_records_of_the_untraced_calls_are_read(ring):
    # the traced pass's two calls read 100 s; the three after it are the window's
    for _ in range(2):
        ring.record(_record(100.0, 0.0, 100.0, 100.0))
    for d, w, g, s in ((0.30, 0.10, 0.15, 0.02), (0.40, 0.20, 0.25, 0.04), (0.20, 0.00, 0.05, 0.03)):
        ring.record(_record(d, w, g, s, violations=0.01))
    ring.record(R.TraceRecord(kind="execution", trace_id="e", started_at=0.0, duration_s=9.0, platform="cpu"))
    run = _run(5)
    assert _metric("host_outside_waits_ms_per_call").read(run) == pytest.approx(200.0)
    assert _metric("graph_device_ms_per_call").read(run) == pytest.approx(150.0)
    assert _metric("snapshot_wall_ms_per_call").read(run) == pytest.approx(40.0)


@pytest.mark.parametrize("name", ["host_outside_waits_ms_per_call", "graph_device_ms_per_call", "snapshot_wall_ms_per_call"])
def test_no_record_is_no_reading(ring, name):
    assert _metric(name).read(_run(6)) is None
    # only the traced pass's calls
    ring.record(_record(1.0, 0.5, 0.2, 0.1))
    assert _metric(name).read(_run(2)) is None
    # records without the program's fields: a program that does not write them
    for _ in range(4):
        ring.record(R.TraceRecord(kind="optimize", trace_id="p", started_at=0.0, duration_s=1.0, platform="cuda",
                                  attrs={"graph_device_s": None}, spans=[R.Span("setup", "setup", 0.1)]))
    assert _metric(name).read(_run(6)) is None
    # spans of a program whose Span has no children field at all
    for _ in range(4):
        ring.record(R.TraceRecord(kind="optimize", trace_id="q", started_at=0.0, duration_s=1.0, platform="cuda",
                                  spans=[types.SimpleNamespace(name="setup", duration_s=0.1)]))
    assert _metric(name).read(_run(6)) is None


def test_capture_s_reads_the_device_loops_counter_after_the_warm_up(monkeypatch):
    from cruise_control_tpu_torch.analyzer import device_loop

    m = _metric("capture_s")
    monkeypatch.setattr(device_loop, "device_loops", lambda dev: types.SimpleNamespace(capture_s=3.5))
    run = _run(4)
    m.before_window(run)
    assert m.read(run) == 3.5
    cpu = types.SimpleNamespace(calls=[], inputs=[], device=types.SimpleNamespace(type="cpu"), notes={})
    m.before_window(cpu)
    assert m.read(cpu) is None
