"""The port's controller replay and its three bench harnesses against the JAX
package, on the CPU.

* ``traces.replay.run_replay`` on the JAX replay tests' traces
  (``tests/test_traces.py::TestReplay``): a drift storm and a quiet trace
  through the real monitor into a live controller on a fake clock.  The
  report must equal the JAX one but for the walls and the dispatch counts,
  which are the port's host syncs (a count of another kind); the flight
  records (one ``replay`` record, its ticks nested under it) must have the
  JAX records' shapes.
* ``controller.bench``, ``fleet.bench`` and ``traces.bench``: each dict holds
  the JAX keys, and the fields that do not depend on the clock or on what a
  dispatch is are equal, at fewer shifts and tenants than the pinned
  workload where the JAX compile is slow.
"""

import dataclasses
import importlib

import pytest

from cruise_control_tpu.controller import bench as JCB
from cruise_control_tpu.fleet import bench as JFB
from cruise_control_tpu.traces import LoadTrace as JLoadTrace
from cruise_control_tpu.traces import drift_storm_trace as j_drift_storm
from cruise_control_tpu.traces import run_replay as j_run_replay
from cruise_control_tpu_torch.controller import bench as PCB
from cruise_control_tpu_torch.fleet import bench as PFB
from cruise_control_tpu_torch.obs import RECORDER
from cruise_control_tpu_torch.traces import FakeClock, LoadTrace, drift_storm_trace, run_replay
from cruise_control_tpu_torch.traces.replay import TICK_QUANTUM_S
from tests.torch_port_helpers import assert_keys_superset, assert_records_match, clear_records

JTB = importlib.import_module("cruise_control_tpu.traces.bench")
PTB = importlib.import_module("cruise_control_tpu_torch.traces.bench")

#: the report's fields that count dispatches (the port's: host syncs)
DISPATCH_FIELDS = ("totalDispatches", "num_dispatches")


def _comparable(report) -> dict:
    """``ReplayReport.to_dict()`` without the wall and the dispatch counts."""
    d = report.to_dict()
    d["replay"] = {k: v for k, v in d["replay"].items() if k not in ("durationS",) + DISPATCH_FIELDS}
    d["steps"] = [{k: v for k, v in s.items() if k not in DISPATCH_FIELDS} for s in d["steps"]]
    return d


def _replay_both(jtrace, ptrace):
    clear_records()
    j = j_run_replay(jtrace)
    p = run_replay(ptrace, device="cpu")
    assert _comparable(p) == _comparable(j)
    assert_keys_superset(p.to_dict(), j.to_dict())
    assert_records_match("replay", count=1)
    assert_records_match("controller_tick", count=p.steps)
    return j, p


def test_fake_clock():
    clock = FakeClock(start=5.0)
    assert clock() == 5.0
    clock.advance(2.5)
    assert clock() == 7.5
    with pytest.raises(ValueError):
        clock.advance(-1.0)


def test_drift_storm_replay_matches_jax():
    """A 3-phase drift storm: at least one publish, at most one a phase,
    reaction latencies whole tick quanta, no kernel build once warm -- and
    every step as the JAX controller took it."""
    phases, hold = 3, 3
    _, report = _replay_both(
        j_drift_storm(phases=phases, hold=hold, magnitude=20.0),
        drift_storm_trace(phases=phases, hold=hold, magnitude=20.0),
    )
    assert report.steps == phases * hold and report.windows_fed == 2 * report.steps
    assert 1 <= report.published <= phases and report.final_version == report.published
    assert report.reactions
    for r in report.reactions:
        assert r >= TICK_QUANTUM_S
        assert r == pytest.approx(round(r / TICK_QUANTUM_S) * TICK_QUANTUM_S, abs=1e-9)
    assert report.max_reaction_s == max(report.reactions)
    assert report.warm_compile_events == 0 and report.total_dispatches > 0
    # the replay record nests every step's tick; its dispatch count is theirs
    (replay_rec,) = RECORDER.recent(1, kind="replay")
    ticks = RECORDER.recent(report.steps + 4, kind="controller_tick", parent_id=replay_rec.trace_id)
    assert len(ticks) == report.steps
    assert replay_rec.attrs["num_dispatches"] == report.total_dispatches == sum(
        t.attrs["num_dispatches"] for t in ticks if not t.attrs["skipped"]
    )
    assert replay_rec.platform == "cpu"


def test_quiet_trace_replay_matches_jax():
    """A flat trace earns at most the one publish the initial imbalance
    justifies, on its first evidence."""
    _, report = _replay_both(
        JLoadTrace(name="flat", num_steps=6, step_s=60.0), LoadTrace(name="flat", num_steps=6, step_s=60.0)
    )
    assert report.published <= 1 and report.final_version == report.published
    assert [o for o in report.outcomes[2:] if o.published] == []
    assert all(dataclasses.asdict(o)["compile_events"] == 0 for o in report.outcomes)


def _same_fields(port: dict, jax: dict, skip) -> None:
    assert_keys_superset(port, jax)
    assert {k: v for k, v in port.items() if k in jax and k not in skip} == {
        k: v for k, v in jax.items() if k not in skip
    }
    for key, value in port.items():
        if key.endswith("_host_syncs"):
            assert value == port[key.replace("_host_syncs", "_dispatches")], key


#: clock readings, and dispatch counts (the port's: host syncs)
CLOCK_AND_DISPATCHES = ("reaction_p50_s", "reaction_p95_s", "warm_start_s", "warm_s", "cold_s",
                        "tick_wall_p50_s", "tick_wall_p95_s", "warm_tick_dispatches",
                        "warm_dispatches")


def test_controller_bench_matches_jax():
    j = JCB.run_bench(shifts=2)
    p = PCB.run_bench(shifts=2, device="cpu")
    _same_fields(p, j, CLOCK_AND_DISPATCHES)
    assert p["published"] == 2 and p["warm_compile_events"] == 0
    assert p["warm_tick_host_syncs"] > 0 and p["dispatch_budget"] == len(PCB.GOALS) + 3


def test_fleet_bench_matches_jax():
    j = JFB.run_bench(num_tenants=2, shifts=1)
    p = PFB.run_bench(num_tenants=2, shifts=1, device="cpu")
    _same_fields(p, j, CLOCK_AND_DISPATCHES)
    assert p["published"] == 2 and p["groups"] == 1 and p["warm_probe_dispatches"] == 1
    assert p["warm_tick_host_syncs"] > 0


def test_traces_bench_matches_jax():
    j = JTB.run_bench(warm_repeats=1)
    p = PTB.run_bench(warm_repeats=1, device="cpu")
    _same_fields(p, j, CLOCK_AND_DISPATCHES)
    assert p["warm_host_syncs"] == p["warm_dispatches"] == 1 and p["bucket_hit"]
