"""The port's regression gate (``cruise_control_tpu_torch/obs/gate.py``).

The JAX test classes ``TestGateCompare``, ``TestGateEndToEnd`` and
``TestExporterGateTier`` of ``tests/test_obs.py`` run unchanged against the
port (``port_test_module``, which binds the gate's ``run_tier`` and
``main`` to ``device="cpu"``).  ``test_exit_zero_on_committed_numbers``
among them fails in the JAX package on every run of the suite; the port's
copy passes.  Then what is the port's own: the committed baselines of both
devices cover the default tiers, the children get ``--device`` and the
port's module path, the controller tier reports the warm tick's host syncs
over the JAX dispatch budget (ROADMAP C5), and the mesh8 tier on 8 CPU
ranks.
"""

from __future__ import annotations

import json
import os
import subprocess

import pytest

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_obs", device="cpu")
TestGateCompare = _PORTED.TestGateCompare
TestGateEndToEnd = _PORTED.TestGateEndToEnd
TestExporterGateTier = _PORTED.TestExporterGateTier

from cruise_control_tpu_torch.obs import gate  # noqa: E402


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_committed_baselines_cover_the_default_tiers(device):
    """Each device's committed gate baseline has every default tier but
    the harness tiers that fall back to their committed artifacts (on the
    CPU the controller and fleet tiers must: the host loop's warm ticks
    breach the JAX dispatch budget, and ``--update-baseline`` refuses a
    failed tier; on the card the device loop meets the budgets, so they are
    in its baseline); the solver tiers leave no hard violation and made no
    warm build."""
    root = gate._repo_root()
    doc = json.load(open(os.path.join(root, gate.baseline_path(device))))
    assert doc["schema"] == gate.GATE_SCHEMA and doc["platform"] == device
    if device == "cuda":
        assert doc["card"] and "H100" in doc["card"]
    for tier in gate.DEFAULT_TIERS:
        if tier not in doc["tiers"]:
            assert tier in gate.HARNESS_WALL_KEYS, tier
            base = gate._artifact_baseline(root, tier, device)
            assert base is not None and base["wall_s"] > 0, tier
            continue
        m = doc["tiers"][tier]
        assert m["wall_s"] > 0 and m["platform"] == device
        if "num_dispatches" in m:
            assert m["residual_hard_violations"] == 0.0
            assert m["span_dispatch_sum"] == m["num_dispatches"]
            assert m["warm_compile_events"] in (0, None)
    for tier in ("controller", "fleet"):
        if device == "cpu":
            assert tier not in doc["tiers"]
            continue
        m = doc["tiers"][tier]
        art = json.load(open(os.path.join(root, gate.artifact_path(tier, device))))
        assert m["warm_compile_events"] == art["warm_compile_events"] == 0
        assert m["warm_tick_dispatches"] <= art["dispatch_budget"]
        assert art["warm_tick_host_syncs"] <= art["dispatch_budget"]
    sharded = json.load(open(os.path.join(root, gate.baseline_path(device, "BENCH_SHARDED"))))
    assert sharded["ok"] and sharded["proposal_identity"] is True
    assert sharded["warm_compile_events"] == 0
    assert sharded["collectives_per_goal_step_total"] <= gate._SHARDED_MAX_COLLECTIVES


def test_children_get_the_device_and_the_ports_module(monkeypatch):
    """Each tier's child runs the port's gate module with ``--device``; no
    JAX module path and no JAX platform variable reach it."""
    seen = []

    def fake_run(cmd, env=None, **kw):
        seen.append((cmd, env))
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps({"tier": cmd[4], "wall_s": 1.0}), stderr="")

    monkeypatch.setattr(gate.subprocess, "run", fake_run)
    for device in ("cpu", "cuda"):
        m = gate.run_tier_subprocess("exporter", 30.0, device=device)
        assert m == {"tier": "exporter", "wall_s": 1.0}
    assert gate.run_tier_subprocess("config1", 30.0)["tier"] == "config1"
    devices = []
    for cmd, env in seen:
        assert cmd[1:3] == ["-m", "cruise_control_tpu_torch.obs.gate"]
        assert "--device" in cmd
        devices.append(cmd[cmd.index("--device") + 1])
        assert not any("cruise_control_tpu." in c or c == "cruise_control_tpu" for c in cmd)
        assert "XLA_FLAGS" not in env or env["XLA_FLAGS"] == os.environ.get("XLA_FLAGS")
        assert env.get("JAX_PLATFORMS") == os.environ.get("JAX_PLATFORMS")
    assert devices == ["cpu", "cuda", "cuda"]


def test_the_cuda_default_raises_naming_the_device_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        gate.run_tier("smoke")
    with pytest.raises(RuntimeError, match="the CUDA device cuda:0 is not available"):
        gate.main(["--tiers", "smoke", "--in-process", "--bench-baseline", "none"])


def test_controller_tier_reports_the_warm_tick_budget_breach():
    """ROADMAP C5 as the gate sees it: the port's controller harness on the
    CPU makes more host syncs a warm tick than the JAX dispatch budget
    (``#goals + 3``), and the tier turns that into an error naming both."""
    from cruise_control_tpu_torch.controller import bench

    m = gate.run_tier("controller", device="cpu")
    budget = len(bench.GOALS) + 3
    assert set(m) == {"tier", "error"} and m["tier"] == "controller"
    syncs = int(m["error"].split()[0])
    assert m["error"] == f"{syncs} tick dispatches > budget {budget}" and syncs > budget


@pytest.mark.slow
@pytest.mark.parametrize("tier", ["mesh8", "sharded"])
def test_rank_tiers_on_eight_cpu_ranks(tier):
    """The two 8-rank tiers on gloo CPU ranks: mesh8's sharded 16-goal solve
    (every rank the same placement, no hard violation, its spans summing to
    its host syncs) and the sharded tier's census, identity and committed
    artifact."""
    m = gate.run_tier(tier, device="cpu")
    assert "error" not in m, m
    if tier == "mesh8":
        assert m["residual_hard_violations"] == 0.0 and m["span_dispatch_sum"] == m["num_dispatches"]
        assert m["num_goals"] == 16 and m["warm_compile_events"] is None
    else:
        assert m["proposal_identity"] is True and m["warm_compile_events"] == 0
        assert m["collectives_per_goal_step"] <= gate._SHARDED_MAX_COLLECTIVES
