"""Slice parity for the port's ``GoalOptimizer.optimize`` (shared by the
``test_torch_optimizer*.py`` files, which split the JAX reference runs across
test workers: each cold JAX optimize compiles its own programs).

The port must reproduce the JAX run exactly: the same final
``replica_broker`` / ``partition_leader`` (and ``replica_disk`` on a JBOD
cluster), the same proposals, and per goal the same violations before/after,
rounds and applied moves.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import GoalContext as JGoalContext
from cruise_control_tpu.analyzer import GoalOptimizer as JGoalOptimizer
from cruise_control_tpu_torch.analyzer import GoalOptimizer as PGoalOptimizer
from cruise_control_tpu_torch.model.cluster import IndexMaps as PIndexMaps
from tests import fixtures
from tests.torch_port_helpers import port_ctx, port_state, to_np


def synthetic_case(spec):
    jstate, jmaps = JS.generate(JS.SyntheticSpec(**spec))
    jctx = JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    return jstate, jctx, jmaps


def fixture_case(name):
    jstate, jmaps = getattr(fixtures, name)().to_arrays()
    jctx = JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    return jstate, jctx, jmaps


def _proposal_rows(proposals):
    return [
        (p.tp, p.partition_size, p.old_leader, tuple(p.old_replicas), tuple(p.new_replicas))
        for p in proposals
    ]


def run_both(jstate, jctx, jmaps, **opt_kw):
    """(jax final, jax result, port final, port result) on the same input."""
    jfinal, jres = JGoalOptimizer(enable_heavy_goals=True, **opt_kw).optimize(
        jstate, jctx, maps=jmaps
    )
    jax.clear_caches()  # each cold run compiles its own executables; free them
    pmaps = PIndexMaps(**dataclasses.asdict(jmaps))
    pfinal, pres = PGoalOptimizer(enable_heavy_goals=True, device="cpu", **opt_kw).optimize(
        port_state(jstate), port_ctx(jctx), maps=pmaps
    )
    return jfinal, jres, pfinal, pres


def assert_same_solution(jfinal, jres, pfinal, pres):
    np.testing.assert_array_equal(to_np(pfinal.replica_broker), np.asarray(jfinal.replica_broker))
    np.testing.assert_array_equal(
        to_np(pfinal.partition_leader), np.asarray(jfinal.partition_leader)
    )
    assert pfinal.num_brokers == jfinal.num_brokers
    if jfinal.num_disks > 0:
        np.testing.assert_array_equal(to_np(pfinal.replica_disk), np.asarray(jfinal.replica_disk))
    assert _proposal_rows(pres.proposals) == _proposal_rows(jres.proposals)
    got = [
        (r.name, r.is_hard, r.violations_before, r.violations_after, r.rounds, r.moves_applied)
        for r in pres.goal_reports
    ]
    want = [
        (r.name, r.is_hard, r.violations_before, r.violations_after, r.rounds, r.moves_applied)
        for r in jres.goal_reports
    ]
    assert got == want
    assert pres.violations_before == jres.violations_before
    assert pres.violations_after == jres.violations_after
    assert pres.total_moves == jres.total_moves
    assert dataclasses.asdict(pres.movement) == dataclasses.asdict(jres.movement)
    assert pres.provision.status == jres.provision.status
    assert pres.balancedness_score == jres.balancedness_score
    # one wait per round plus the end-of-run fetches
    assert pres.num_host_syncs >= sum(r.rounds for r in pres.goal_reports)
