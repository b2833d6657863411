"""The port's scale ladder (``bench_scale.py``) and recovery bench against
the JAX package.

``bench_scale``'s workloads are the root ``bench_scale.py``'s; its record of
a solve on the CPU must equal the JAX package's solve of the same spec key
for key (``bench_scale.differences``: placements and leaders through the
digest, per-goal rounds, moves and violations, movement, balancedness).  The
default goal subset runs at 200 brokers (bucket 256) with a window of 64
active brokers, so the active-broker cut rotates its sources as it does at
config #3.  The fast tests hold the port to the JAX records committed beside
the gate's baselines (``SCALE_REFERENCE_<name>.json``, written by
``tests/torch_scale_reference.py`` on this tree); ``slow`` tests make them
again from the JAX package and hold the committed ones to them, and run
config #3's 16 goals on the CPU port against its record (ROADMAP C6).
``executor/recovery_bench.py`` recovers the JAX script's pinned journal to
the same counts.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch

from cruise_control_tpu_torch import bench_scale
from tests.torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse: one thread)
from tests.torch_scale_reference import jax_record

#: the default subset at bucket 256 with the source window cut to 64 brokers
SMALL = dict(brokers=200, partitions=4000, max_active=64)
#: the committed JAX records and the workloads they hold
REFERENCES = {
    "bucket256": SMALL, "config3": {}, "config3_fullgoals": dict(full_goals=True),
    "config4_small": dict(config4=True, brokers=48, partitions=1500),
    "2500b": dict(config4=True, brokers=2500, partitions=250_000),
}


@pytest.fixture(scope="module")
def small_reference():
    return json.load(open(bench_scale.reference_path("bucket256")))


def test_default_subset_at_bucket_256_equals_the_jax_solve(small_reference):
    from cruise_control_tpu_torch.model.arrays import broker_bucket

    assert broker_bucket(SMALL["brokers"]) == 256 > SMALL["max_active"]
    line, artifact = bench_scale.run(**SMALL, warmup=False, device="cpu")
    assert bench_scale.differences(artifact, small_reference) == []
    assert artifact["max_active_brokers"] == 64 and artifact["goals"] == 6
    assert artifact["residual_hard_violations"] == 0.0 and artifact["total_moves"] > 0
    assert [r["rounds"] for r in artifact["goal_reports"]] == [r["rounds"] for r in small_reference["goal_reports"]]
    assert line["digest"] == small_reference["digest"] and line["platform"] == "cpu"
    assert line["num_dispatches"] == line["num_host_syncs"] > 0


def test_check_fails_on_a_record_with_one_move_changed(small_reference, tmp_path, capsys):
    """``--check`` against the JAX record with one goal's moves changed exits
    1 naming that goal alone; the artifact it wrote equals the record."""
    tampered = json.loads(json.dumps(small_reference))
    tampered["goal_reports"][0]["moves"] += 1
    bad, out = tmp_path / "bad.json", tmp_path / "out.json"
    bad.write_text(json.dumps(tampered))
    argv = ["--device", "cpu", "--no-warmup", "--brokers", "200", "--partitions", "4000", "--max-active", "64"]
    assert bench_scale.main(argv + ["--out", str(out), "--check", str(bad)]) == 1
    err = capsys.readouterr().err
    assert "1 difference(s)" in err and "goal_reports[0]" in err
    assert bench_scale.differences(json.load(open(out)), small_reference) == []


def test_check_takes_a_committed_reference_by_name(capsys):
    """``--check bucket256`` reads ``SCALE_REFERENCE_bucket256.json`` beside
    the gate's baselines, as ``--check 2500b`` does on the card."""
    argv = ["--device", "cpu", "--no-warmup", "--brokers", "200", "--partitions", "4000", "--max-active", "64"]
    assert bench_scale.main(argv + ["--check", "bucket256"]) == 0
    assert "equal to bucket256" in capsys.readouterr().err


def test_progress_reference_holds_the_first_goals():
    """The JAX package's config #4 progress (its 7 hard goals on this tree)
    against goal reports: equal ones pass, one changed move count or a
    missing goal is named."""
    reference = json.load(open(bench_scale.reference_path("config4_hard_goals")))
    progress = reference["goal_progress"]
    assert [p["goal"] for p in progress][3:4] == ["DiskCapacityGoal"] and len(progress) == 7
    assert progress[3]["rounds"] == 1359 and progress[3]["moves"] == 926_303
    reports = [{"name": p["goal"], "rounds": p["rounds"], "moves": p["moves"],
                "violations_after": p["violations_after"], "hard": True} for p in progress]
    doc = {"goal_reports": reports + [{"name": "ReplicaDistributionGoal", "rounds": 9, "moves": 9,
                                       "violations_after": 0.0}]}
    assert bench_scale.progress_differences(doc, reference) == []
    reports[3]["moves"] += 1
    diffs = bench_scale.progress_differences({"goal_reports": reports[:6]}, reference)
    assert len(diffs) == 2 and "DiskCapacityGoal" in diffs[0] and "CpuCapacityGoal" in diffs[1]


def test_the_cuda_default_raises_naming_the_device_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_scale.run(brokers=20, partitions=100)


def test_workloads_are_the_root_scripts():
    """config #3, its full goal list and config #4 as the root
    ``bench_scale.py`` builds them (its source, read as text)."""
    from cruise_control_tpu_torch.analyzer import goals_base as G

    spec, goals, heavy = bench_scale.workload()
    assert (spec["num_brokers"], spec["num_racks"], spec["num_topics"], spec["num_partitions"],
            spec["replication_factor"], spec["skew_brokers"], spec["seed"]) == (1000, 20, 1000, 100_000, 3, 250, 11)
    assert goals == (0, 2, 3, 4, 5, 6) and not heavy
    assert bench_scale.workload(full_goals=True)[1:] == (tuple(range(16)), True)
    spec4, goals4, heavy4 = bench_scale.workload(config4=True)
    assert (spec4["num_brokers"], spec4["num_partitions"], spec4["disks_per_broker"]) == (10_000, 1_000_000, 2)
    assert goals4 == tuple(range(16)) + (G.INTRA_DISK_CAPACITY, G.INTRA_DISK_USAGE_DIST) and heavy4
    root = open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench_scale.py")).read()
    for key in ("num_racks=20", "num_topics=1000", "seed=11", "num_racks=40", "num_topics=2_000",
                "capacity_disk=1_000_000.0", "disks_per_broker=2"):
        assert key in root


@pytest.mark.slow
def test_config4_small_equals_the_jax_solve():
    """config #4's goal list (18 goals, heavy goals on, two logdirs a broker)
    cut to 48 brokers and 1,500 partitions."""
    kw = dict(config4=True, brokers=48, partitions=1500)
    _, artifact = bench_scale.run(**kw, warmup=False, device="cpu")
    assert bench_scale.differences(artifact, jax_record(**kw)) == []


@pytest.mark.slow
def test_config3_full_goals_equals_the_jax_record():
    """ROADMAP C6: config #3 with the 16 default goals (heavy goals on) on
    the CPU port equals the JAX package's solve on this tree (292,905 moves,
    2,097 rounds; minutes on a CPU)."""
    assert bench_scale.main(["--full-goals", "--device", "cpu", "--no-warmup", "--check", "config3_fullgoals"]) == 0


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(REFERENCES))
def test_committed_references_are_the_jax_solves_on_this_tree(name):
    """Make each committed record again from the JAX package (config #3:
    minutes on a CPU, 2,500 brokers: about 18 minutes) and hold the committed
    one to it."""
    committed = json.load(open(bench_scale.reference_path(name)))
    assert bench_scale.differences(jax_record(**REFERENCES[name]), committed) == []


def _jax_recovery_script():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts", "bench_recovery.py")
    spec = importlib.util.spec_from_file_location("jax_bench_recovery", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_recovery_bench_counts_equal_the_jax_scripts(tmp_path, monkeypatch):
    from cruise_control_tpu_torch.executor import recovery_bench

    jax = _jax_recovery_script()
    jdir = tmp_path / "jax"
    jax.populate(str(jdir))
    want = jax.measure(str(jdir))
    got = recovery_bench.run_bench(repeats=1)
    keys = ("records", "executions_recovered", "recovered_tasks", "user_tasks_recovered")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys} == {
        "records": 4009, "executions_recovered": 1, "recovered_tasks": 8, "user_tasks_recovered": 2000}
    # the gate against the committed CPU baseline (walls on a shared host: the
    # slack knob widens the wall allowance only), then a record-count mismatch
    monkeypatch.setenv("CC_TPU_GATE_WALL_SLACK", "10")
    assert recovery_bench.main(["--device", "cpu", "--repeats", "1"]) == 0
    base = json.load(open(recovery_bench.baseline_path("cpu")))
    assert base["records"] == 4009
    monkeypatch.setattr(recovery_bench, "USER_TASKS", recovery_bench.USER_TASKS - 1)
    assert recovery_bench.main(["--device", "cpu", "--repeats", "1"]) == 2
