"""The harness on the CPU: what it may import, what ``BENCHMARK.json`` may say,
that new cells, mixes and metrics are files found by name, and that a run's
control flow reaches ``correct`` -- true for a sound run, false with the
timed path broken underneath."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import guard, peaks, trace
from portbench.run import RunFailed, run_cell

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = dict(num_brokers=16, num_racks=4, num_topics=8, num_partitions=400, skew_brokers=4)
HARD_CAPACITY = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal", "NetworkInboundCapacityGoal",
                 "NetworkOutboundCapacityGoal", "CpuCapacityGoal"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_warm_pass(monkeypatch):
    """One warm-up pass: these runs judge proposals, they time nothing."""
    monkeypatch.setattr("portbench.run.WARM_S", 0.0)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            assert guard.top_level(name) not in guard.FORBIDDEN, f"{f}: imports {name}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((PB / "reference").rglob("*.py")):
        for name in _imports(f):
            assert guard.top_level(name) not in guard.FORBIDDEN + ("cruise_control_tpu_torch",), f"{f}: {name}"
            assert name.split(".")[0] in ("numpy", "portbench", "dataclasses", "math", "typing", "__future__"), name
            if name.startswith("portbench"):
                assert name.startswith("portbench.reference"), f"{f}: {name}"


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["cruise_control_tpu_torch", "cruise_control_tpu_torch.ops", "jaxtyping"]) == []
    assert guard.forbidden_modules(["jax.numpy", "cruise_control_tpu.analyzer", "flax", "jaxlib"]) == [
        "cruise_control_tpu.analyzer", "flax", "jax.numpy", "jaxlib"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1].startswith("portbench/")
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (PB / "traffic" / "mixes" / f"{w['traffic']}.json").is_file()
        assert (PB / "cells" / f"{w['name']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert (PB / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]] and "\n" not in m["layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def _tree(tmp_path: Path, **spec) -> Path:
    """A copy of the benchmark with every configuration cut to ``SMALL``."""
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in (tmp_path / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg["spec"].update(SMALL, **spec)
        p.write_text(json.dumps(cfg))
    return tmp_path


def _few_scenarios(root: Path, count: int = 4) -> None:
    """The what-if mix cut for the CPU: fewer scenarios and inputs, and the
    hard goals alone (the soft goals' rounds on a 16-broker stack run for
    minutes on one CPU thread)."""
    p = root / "portbench" / "traffic" / "mixes" / "whatif16.json"
    mix = json.loads(p.read_text())
    mix["scenarios"]["count"] = count
    mix.update(inputs=2, goals=HARD_CAPACITY, heavy_goals=False)
    p.write_text(json.dumps(mix))


CPU = torch.device("cpu")


def test_a_run_reaches_correct_on_the_cpu(tmp_path):
    root = _tree(tmp_path)
    result, run = run_cell(root, "testconstants.rebalance", 2**31 + 11, 0.0, False, CPU)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 4
    assert set(result["metrics"]) == {"proposals_per_s", "balancedness", "data_moved_mb", "setup_s"}
    assert list(result)[-1] == "checks" and run.passes == 1
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())
    again, _ = run_cell(root, "testconstants.rebalance", 2**31 + 11, 0.0, False, CPU)
    for k in ("balancedness", "data_moved_mb"):
        assert again["metrics"][k] == result["metrics"][k]


def test_a_toy_config_mix_cell_and_metric_are_found_without_edits(tmp_path):
    root = _tree(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "testconstants.json").read_text())
    cfg["name"] = "toy"
    cfg["spec"].update(num_brokers=12, num_partitions=240)
    (pb / "configs" / "toy.json").write_text(json.dumps(cfg))
    goals = ["RackAwareGoal", "DiskCapacityGoal", "ReplicaDistributionGoal"]
    (pb / "traffic" / "mixes" / "toymix.json").write_text(json.dumps(
        {"why": "toy", "entry": "optimize", "goals": goals, "heavy_goals": False, "inputs": 2, "pool_seed": 3}))
    shutil.copy(pb / "cells" / "testconstants.rebalance.json", pb / "cells" / "toy.toymix.json")
    (pb / "metrics" / "toy_calls.py").write_text("def read(run):\n    return float(len(run.calls))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test", "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.toymix", "config": "toy", "traffic": "toymix", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "toy_calls", "unit": "calls", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["toy.toymix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, run = run_cell(root, "toy.toymix", 3, 0.0, False, CPU)
    assert result["correct"] and result["metrics"]["toy_calls"]["value"] == 2.0
    assert result["metrics"]["balancedness"]["value"] > 0
    other, _ = run_cell(root, "testconstants.rebalance", 3, 0.0, False, CPU)
    assert "toy_calls" not in other["metrics"]


def test_a_metric_with_no_reading_fails_the_run(tmp_path):
    root = _tree(tmp_path)
    (root / "portbench" / "metrics" / "silent.py").write_text("def read(run):\n    return None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "silent", "unit": "s", "better": "lower", "bound": 0.01,
                                "source": "host_clock", "workloads": ["testconstants.rebalance"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(RunFailed, match="no reading for silent"):
        run_cell(root, "testconstants.rebalance", 5, 0.0, False, CPU)


def _unchanged(monkeypatch):
    """The timed path broken: every goal step returns its state unchanged
    (and reports so: no rounds, no moves, its violations as they were)."""
    from cruise_control_tpu_torch.analyzer import optimizer as O

    def run_goal(self, gid, state, ctx, *, prior, max_rounds, max_rf, syncs):
        v = O._violations_fn(state, ctx, self.enable_heavy_goals, (gid,))[..., gid]
        z = torch.zeros(v.shape, dtype=torch.int32)
        return state, z, z, v, v, None

    monkeypatch.setattr(O.GoalOptimizer, "_run_goal", run_goal)
    monkeypatch.setattr(O.GoalOptimizer, "_offline_repair", lambda self, state, ctx, max_rounds, syncs: state)


def test_a_step_that_returns_its_state_unchanged_fails(tmp_path, monkeypatch):
    root = _tree(tmp_path)
    _unchanged(monkeypatch)
    result, _ = run_cell(root, "testconstants.rebalance", 17, 0.0, False, CPU)
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert result["checks"]["hard_violations"]["value"] > 0


def test_an_answer_altered_where_it_is_produced_fails(tmp_path):
    root = _tree(tmp_path)

    def alter(run, call):
        """One replica that stayed put is delivered on another broker."""
        p = call.proposals[0]
        inp = run.inputs[p.input_index].lanes[p.lane]
        rb, rp = p.placement.replica_broker, inp["replica_partition"]
        r = int(np.flatnonzero(rb == inp["replica_broker"])[0])
        held = set(rb[rp == rp[r]].tolist())
        rb[r] = next(b for b in range(inp["broker_rack"].size) if b not in held)

    result, _ = run_cell(root, "testconstants.rebalance", 19, 0.0, False, CPU, fault=alter)
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert result["checks"]["move_count_gap"]["value"] >= 1


def test_half_of_the_batch_left_out_fails(tmp_path):
    root = _tree(tmp_path)
    _few_scenarios(root)

    def half(run, call):
        """The lanes past the first half come back as they went in, and are
        reported so: no moves, their violations as they were."""
        entry = run.entry
        stack = entry.stacks[call.input_index]
        viol = entry.opt.batched_violations(stack, entry.ctx).numpy()
        lanes = len(call.proposals)
        for k in range(lanes // 2, lanes):
            p = call.proposals[k]
            p.placement.replica_broker = stack.replica_broker[k].numpy().copy()
            p.placement.partition_leader = stack.partition_leader[k].numpy().copy()
            p.violations = {g: float(viol[k, i]) for g, i in zip(run.cell.mix["goals"], entry.goal_ids)}
            p.inter_broker_moves, p.leadership_moves, p.data_moved = 0, 0, 0.0

    result, _ = run_cell(root, "testconstants.whatif16", 23, 0.0, False, CPU, fault=half)
    assert not result["correct"]
    assert result["checks"]["hard_violations"]["value"] > 0
    assert result["failed"] == result["attempted"] // 2


def test_without_a_card_a_run_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "testconstants.rebalance", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "testconstants.rebalance", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_trace_reading_from_intervals():
    graphs = [(1.0, 2.0), (3.0, 4.5)]
    device = [(1.2, 1.3, "in_graph"), (2.2, 2.4, "copy"), (4.8, 5.0, "copy"), (5.5, 5.6, "fill")]
    cpu = [(0.0, 6.0, "portbench.call"), (2.0, 3.0, "aten::item"), (2.05, 2.15, "cudaStreamSynchronize")]
    r = trace.analyse((0.5, 6.0), graphs, device, cpu)
    assert r.window_s == pytest.approx(5.5)
    assert r.graph_s == pytest.approx(2.5)
    assert r.busy_s == pytest.approx(2.5 + 0.2 + 0.2 + 0.1)
    assert r.device_ops[0] == ["goal graphs (CUDA-event windows)", pytest.approx(2.5)]
    assert dict(map(tuple, r.device_ops[1:])) == {"copy": pytest.approx(0.4), "fill": pytest.approx(0.1)}
    idle = dict(map(tuple, r.idle_gaps))
    # gaps: 0.5-1.0, 2.0-2.2 (mid in cudaStreamSynchronize), 2.4-3.0 (aten::item), 4.5-4.8, 5.0-5.5, 5.6-6.0
    assert idle["cudaStreamSynchronize"] == pytest.approx(0.2)
    assert idle["aten::item"] == pytest.approx(0.6)
    assert idle["portbench.call"] == pytest.approx(0.5 + 0.3 + 0.5 + 0.4)


def test_segment_sum_bytes_count_each_input_once_and_each_output_once():
    # K1 at config #2's broker call: ids, [R, 4] f32, 2 bool, 3 f32 in; 4 f32 + 2 i32 + 3 f32 sums out
    kinds = [("f32", 4), ("bool", 1), ("bool", 1), ("f32", 1), ("f32", 1), ("f32", 1)]
    assert peaks.segment_sum_bytes(30000, 128, kinds) == 30000 * (4 + 16 + 1 + 1 + 12) + 128 * 4 * 9
    assert peaks.segment_sum_bytes(10, 5, [("bool", 1)]) == 10 * 5 + 5 * 4
    assert peaks.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
