"""The plain reference on CPU solves of a small spec: a sound solve passes every
limit; a placement broken after the solve, or a solve fed lower-precision
loads, fails one."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer.optimizer import balancedness_cost_by_goal

from portbench.entries import _program as P
from portbench.reference import compare, judge
from portbench.run import lower_precision
from portbench.traffic import synthetic

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "testconstants.json").read_text())
GOALS = json.loads((ROOT / "portbench" / "traffic" / "mixes" / "rebalance.json").read_text())["goals"]
HARD = [g for g in CONFIG["hard_goals"] if g in GOALS]
LIMITS = json.loads((ROOT / "portbench" / "cells" / "testconstants.rebalance.json").read_text())["limits"]
SPEC = dict(CONFIG["spec"], num_brokers=16, num_racks=4, num_topics=8, num_partitions=400, skew_brokers=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solve(arrays):
    """A CPU solve of ``arrays``: (delivered proposal, its claim)."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer

    opt = GoalOptimizer(goal_ids=P.goal_ids(GOALS), hard_ids=P.goal_ids(CONFIG["hard_goals"]),
                        enable_heavy_goals=True, device="cpu")
    st, ctx = P.state(arrays, "cpu"), P.context(arrays, CONFIG, "cpu")
    final, result = opt.optimize(st, ctx)
    d = P.delivered(0, 0, P.host(final.replica_broker), P.host(final.replica_disk),
                    P.host(final.partition_leader), result)
    call = P.Call(input_index=0, proposals=[d], num_host_syncs=result.num_host_syncs)
    (claims,) = P.claims([call], [st], ctx, True, P.goal_ids(GOALS), None)
    return d, claims[0], result


@pytest.fixture(scope="module")
def solved():
    arrays = synthetic.generate(SPEC, 5)
    d, claim, result = _solve(arrays)
    return arrays, d, claim, result


def _judge(arrays, placement, claim):
    return compare.judge_proposal(arrays, placement, claim, GOALS, HARD, CONFIG["constraint"], True)


def test_a_sound_solve_passes_every_limit(solved):
    arrays, d, claim, result = solved
    j = _judge(arrays, d.placement, claim)
    assert not compare.failed(j, LIMITS), j.numbers
    assert j.numbers["load_gap"] < 1e-5
    # the reference's own counts are the program's
    assert j.violations == {g: int(result.violations_after[g]) for g in GOALS}
    assert j.data_moved > 0


def test_the_reference_counts_the_unsolved_input_as_the_program_does(solved):
    arrays, _, _, result = solved
    pl = judge.Placement(arrays["replica_broker"], arrays["replica_disk"], arrays["partition_leader"])
    counts = judge.violations(arrays, pl, GOALS, CONFIG["constraint"], judge.sums(arrays, pl, True))
    assert {g: c[0] for g, c in counts.items()} == {g: int(result.violations_before[g]) for g in GOALS}
    assert sum(counts[g][1] for g in HARD) > 0   # the skewed start breaks the capacity goals


def test_a_replica_moved_onto_its_own_rack_fails(solved):
    arrays, d, claim, _ = solved
    rb = d.placement.replica_broker.copy()
    rack = arrays["broker_rack"]
    rp = arrays["replica_partition"]
    r = 0
    sibling = rb[(rp == rp[r]) & (np.arange(rp.size) != r)][0]
    held = set(rb[rp == rp[r]].tolist())
    rb[r] = next(b for b in range(rack.size) if rack[b] == rack[sibling] and b not in held)
    pl = judge.Placement(rb, d.placement.replica_disk, d.placement.partition_leader)
    j = _judge(arrays, pl, claim)
    assert compare.failed(j, LIMITS)
    assert j.numbers["hard_violations"] >= 1 and j.numbers["violation_gap"] >= 1


def test_a_broker_over_its_disk_capacity_fails(solved):
    arrays, d, claim, _ = solved
    rb = d.placement.replica_broker.copy()
    rp = arrays["replica_partition"]
    limit = 0.8 * arrays["broker_capacity"][0, synthetic.DISK]
    load, moved = 0.0, set()
    for r in np.argsort(-arrays["base_load"][:, synthetic.DISK]):
        if rb[r] == 0 or rp[r] in moved:
            continue
        rb[r] = 0
        moved.add(rp[r])
        load += arrays["base_load"][r, synthetic.DISK]
        if load > limit:
            break
    pl = judge.Placement(rb, d.placement.replica_disk, d.placement.partition_leader)
    j = _judge(arrays, pl, claim)
    assert compare.failed(j, LIMITS)
    assert j.numbers["hard_violations"] >= 1


def test_a_stack_s_lifted_snapshot_is_judged_too(solved):
    """A stack's second snapshot, taken inside the program's lift, is held to
    the reference as its lane-form one is: one count off fails."""
    import dataclasses

    arrays, d, claim, _ = solved
    counts = claim.sums.replica_counts.copy()
    counts[0] += 1
    lifted = dataclasses.replace(claim.sums, replica_counts=counts)
    j = _judge(arrays, d.placement, dataclasses.replace(claim, lifted_sums=lifted))
    assert compare.failed(j, LIMITS) and j.numbers["count_gap"] == 1


def test_the_same_solve_fed_bfloat16_loads_fails(solved):
    arrays, _, _, _ = solved
    d, claim, _ = _solve(lower_precision(arrays))
    j = _judge(arrays, d.placement, claim)
    assert compare.failed(j, LIMITS)
    assert j.numbers["load_gap"] > 3 * LIMITS["load_gap"]


def test_balancedness_is_upstreams_score():
    ids = list(range(len(GOALS)))
    hard_ids = {GOALS.index(g) for g in HARD}
    costs = balancedness_cost_by_goal(ids, hard_ids)
    violated = [GOALS[3], GOALS[9], GOALS[15]]
    want = 100.0 - sum(costs[GOALS.index(g)] for g in violated)
    assert judge.balancedness(GOALS, HARD, violated) == pytest.approx(want, rel=1e-12)
    assert judge.balancedness(GOALS, HARD, []) == 100.0


def test_bfloat16_rounding_is_nearest_even():
    x = {"base_load": np.array([[1.0, 1.00390625, 1.005859375, 3.0e5]], np.float32),
         "leadership_delta": np.array([[0.0, -2.5, 1.0 + 2**-8, 1.0 + 3 * 2**-8]], np.float32)}
    y = lower_precision(x)
    want = torch.from_numpy(x["base_load"]).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(y["base_load"], want)
    want = torch.from_numpy(x["leadership_delta"]).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(y["leadership_delta"], want)
