"""The solver's loops as carry, body and condition (``analyzer/optimizer.py``).

The card runs :func:`phase_body` inside CUDA graph WHILE nodes
(``analyzer/device_loop.py``); the CPU drives the same body from the host.
Here, on the CPU:

* the host driver equals the JAX package's jitted ``_phase_loop`` and
  ``_goal_step_fn`` exactly (rounds, moves, placement): capped sources with
  more than one rotation window, the ``max_rounds`` cap, and a multi-phase
  goal whose passes unlock each other (ReplicaDistribution's relieve);
* every goal's round types run with every host read patched to raise and
  every operation that waits on the device or copies host data refused, so
  the body can be captured into a graph;
* the census arithmetic the device loop uses: one round's recorded kernel
  calls times the trip counts give the host loop's census for the same solve
  (the plain calls record the kernel wrapper's own replay closure here, as
  the wrapper does under a capture on the card).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import GoalContext as JGoalContext
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.analyzer import optimizer as JO
from cruise_control_tpu.analyzer.goal_rounds import GOAL_ROUNDS as JGOAL_ROUNDS
from cruise_control_tpu_torch import synthetic as PSY
from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer import optimizer as O
from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.analyzer.goal_rounds import GOAL_ROUNDS, offline_round, offline_round_relaxed
from cruise_control_tpu_torch.obs.profiler import PROFILER
from cruise_control_tpu_torch.ops import graph_loop as GL
from cruise_control_tpu_torch.ops import segments as SEG
from tests.torch_port_helpers import CONFIG1, SMALL20, port_ctx, port_state, to_np

#: SMALL20 re-seeded: ReplicaDistribution takes three passes from it (the
#: first pass's relieve swaps free room that the second pass's moves use)
PASSES3 = dict(SMALL20, seed=0)


def _jax_case(spec, max_active=None):
    jstate, _ = JS.generate(JS.SyntheticSpec(**spec))
    jctx = JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    if max_active is not None:
        jctx = dataclasses.replace(jctx, max_active_brokers=max_active)
    pctx = port_ctx(jctx)
    if max_active is not None:
        pctx = pctx.replace(max_active_brokers=max_active)
    return jstate, jctx, port_state(jstate), pctx


def _same_placement(pstate, jstate):
    np.testing.assert_array_equal(to_np(pstate.replica_broker), np.asarray(jstate.replica_broker))
    np.testing.assert_array_equal(to_np(pstate.partition_leader), np.asarray(jstate.partition_leader))
    np.testing.assert_array_equal(to_np(pstate.replica_disk), np.asarray(jstate.replica_disk))


@pytest.mark.parametrize(
    "case,spec,gid,phase,max_rounds,max_active",
    [
        # sources capped at 2 a round: a zero-move round proves only its window stuck
        ("capped", SMALL20, G.DISK_USAGE_DIST, 0, 2000, 2),
        ("cap", SMALL20, G.REPLICA_DISTRIBUTION, 0, 3, None),
    ],
)
def test_host_phase_loop_equals_jax(case, spec, gid, phase, max_rounds, max_active):
    jstate, jctx, pstate, pctx = _jax_case(spec, max_active)
    prior = tuple(range(gid))
    jneeds = JG.goal_snapshot_needs(gid)          # as the JAX goal step passes it
    jfinal, jit, jtotal = JO._phase(
        jstate, jctx, round_fn=JGOAL_ROUNDS[gid][phase], max_rounds=max_rounds, enable_heavy=True,
        prior_ids=prior, admit_ids=prior + (gid,), spmd=None, needs=jneeds,
    )
    jax.clear_caches()
    syncs = O.HostSyncs()
    pfinal, it, total = O._phase_loop(
        pstate, pctx, round_fn=GOAL_ROUNDS[gid][phase], max_rounds=max_rounds, enable_heavy=True,
        prior_ids=prior, admit_ids=prior + (gid,), needs=O._goal_needs(gid, prior), syncs=syncs,
    )
    assert (it, total) == (int(jit), int(jtotal))
    assert syncs.count == it                       # one host read a round
    _same_placement(pfinal, jfinal)
    if case == "cap":
        assert it == max_rounds and total > 0
    else:
        # the first round reports more than one rotation window
        first = O.phase_body(
            O.phase_carry(pstate), pctx, round_fn=GOAL_ROUNDS[gid][phase], enable_heavy=True,
            prior_mask=O._np_mask(prior), admit_mask=O._np_mask(prior + (gid,)),
            needs=O._goal_needs(gid, prior),
        )
        assert int(first.windows) > 1 and it > int(first.windows)


def test_host_goal_step_equals_jax_through_three_passes(monkeypatch):
    gid = G.REPLICA_DISTRIBUTION
    jstate, jctx, pstate, pctx = _jax_case(PASSES3)
    prior = tuple(range(gid))
    jfinal, jrounds, jmoves, jbefore, jafter = JO._goal_step(
        jstate, jctx, gid=gid, round_fns=JGOAL_ROUNDS[gid], max_rounds=2000, enable_heavy=True,
        prior_ids=prior, admit_ids=prior + (gid,), spmd=None,
    )
    jax.clear_caches()
    phases = []
    host_loop = O._phase_loop

    def counted(*a, **k):
        out = host_loop(*a, **k)
        phases.append(out[2])
        return out

    monkeypatch.setattr(O, "_phase_loop", counted)
    pfinal, rounds, moves, before, after = O._goal_step_fn(
        pstate, pctx, gid=gid, round_fns=GOAL_ROUNDS[gid], max_rounds=2000, enable_heavy=True,
        prior_ids=prior, admit_ids=prior + (gid,), syncs=O.HostSyncs(),
    )
    assert len(phases) == 3 * len(GOAL_ROUNDS[gid])          # three passes
    assert sum(phases[3:6]) > 0 and sum(phases[6:]) == 0     # the second pass still moved
    assert (rounds, moves) == (int(jrounds), int(jmoves))
    assert (float(before), float(after)) == (float(jbefore), float(jafter))
    _same_placement(pfinal, jfinal)


# -- (b) the body can be captured ----------------------------------------------------

#: operations that wait on the device, size their output from its data or
#: copy host data to it: none may run inside a round
_REFUSED = {
    "_local_scalar_dense", "nonzero", "masked_select", "_unique2", "unique_dim", "unique_consecutive",
    "bincount", "repeat_interleave", "lift_fresh", "lift_fresh_copy", "histc", "equal", "is_nonzero",
    "allclose", "item",
}
_HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "numpy", "cpu")


class _RefuseHostWork(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        bool_index = name in ("index", "index_put", "index_put_", "_index_put_impl_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] if i is not None
        )
        if name in _REFUSED or bool_index:
            raise AssertionError(f"{func._schema.name} inside a round")
        return func(*args, **(kwargs or {}))


def _round_cases():
    cases = [(g, k) for g in sorted(GOAL_ROUNDS) for k in range(len(GOAL_ROUNDS[g]))]
    return cases + [("offline", 0), ("offline", 1)]


@pytest.fixture(scope="module")
def config1_states():
    state, _ = PSY.generate(PSY.SyntheticSpec(**CONFIG1), device="cpu")
    jbod, _ = PSY.generate(PSY.SyntheticSpec(**CONFIG1, disks_per_broker=2), device="cpu")
    # broker 0 dead: the offline rounds have replicas to move
    dead = state.replace(broker_alive=torch.tensor([False, True, True]))
    return dict(plain=state, jbod=jbod, dead=dead)


@pytest.mark.parametrize("gid,phase", _round_cases())
def test_round_has_no_host_read(config1_states, monkeypatch, gid, phase):
    if gid == "offline":
        state, fn, prior, admit = config1_states["dead"], (offline_round, offline_round_relaxed)[phase], (), ()
        needs = frozenset()
    else:
        jbod = gid in (G.INTRA_DISK_CAPACITY, G.INTRA_DISK_USAGE_DIST)
        state = config1_states["jbod" if jbod else "plain"]
        fn, prior = GOAL_ROUNDS[gid][phase], tuple(G.DEFAULT_GOAL_ORDER[:gid])
        admit, needs = prior + (gid,), O._goal_needs(gid, prior)
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cpu")
    carry = O.phase_carry(state)

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"Tensor.{name} inside a round")
        return read

    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    with _RefuseHostWork():
        out = O.phase_body(
            carry, ctx, round_fn=fn, enable_heavy=True, prior_mask=O._np_mask(prior),
            admit_mask=O._np_mask(admit), needs=needs,
        )
        O.phase_cond(out, 2000)
    monkeypatch.undo()
    assert int(out.it) == 1 and int(out.windows) >= 1


# -- (c) the census arithmetic -------------------------------------------------------


def test_recorded_calls_times_trips_equal_the_host_loop_census(monkeypatch):
    """Config1's full solve on the host loop: the census calls made inside
    every phase loop equal each phase's one recorded round times its rounds
    (as the device loop adds them after its fetch).  A plain call made while
    recording appends the closure the CUDA wrapper appends under a capture
    (``segments._replays``), so the launch and replay counts grow with it."""
    state, _ = PSY.generate(PSY.SyntheticSpec(**SMALL20), device="cpu")
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cpu")
    host_loop = O._phase_loop
    inside = []           # the census growth inside each phase loop
    trips = {}            # (round_fn, prior, admit, needs) -> (a state and context it ran on, rounds)

    def counted(state, ctx, **k):
        m0 = PROFILER.mark()
        out = host_loop(state, ctx, **k)
        m1 = PROFILER.mark()
        inside.append((m1.calls - m0.calls, m1.flops - m0.flops, m1.bytes_accessed - m0.bytes_accessed))
        key = (k["round_fn"], k["prior_ids"], k["admit_ids"], k["needs"])
        trips[key] = (state, ctx, trips.get(key, (None, None, 0))[2] + out[1])
        return out

    monkeypatch.setattr(O, "_phase_loop", counted)
    O.GoalOptimizer(device="cpu").optimize(state, ctx)
    monkeypatch.undo()
    want = tuple(sum(x[i] for x in inside) for i in range(3))

    census = SEG._census

    def recorded(path, rows, segments, layout, wall_s, events=(), graph_calls=0):
        rec = GL.recording()
        if rec is None or graph_calls:
            return census(path, rows, segments, layout, wall_s, events, graph_calls)
        rec.calls.append(SEG._replays(path, len(layout), rows, segments, layout))

    monkeypatch.setattr(SEG, "_census", recorded)
    SEG.reset_launch_counts()
    m0 = PROFILER.mark()
    for (fn, prior, admit, needs), (start, start_ctx, rounds) in trips.items():
        rec = GL.Recording()
        with GL._recording(rec):
            O.phase_body(
                O.phase_carry(start), start_ctx, round_fn=fn, enable_heavy=True, prior_mask=O._np_mask(prior),
                admit_mask=O._np_mask(admit), needs=needs,
            )
        assert rec.calls                       # every round calls the segment sums
        rec.account(rounds)
    m1 = PROFILER.mark()
    assert (m1.calls - m0.calls, m1.flops - m0.flops, m1.bytes_accessed - m0.bytes_accessed) == want
    assert want[0] > 0
    assert sum(SEG.LAUNCHES.values()) == sum(SEG.REPLAYED.values()) == want[0]


def test_card_without_conditional_nodes_raises_naming_the_versions():
    with pytest.raises(RuntimeError, match=r"CUDA runtime 12\.2 and driver 12\.2"):
        GL.check_versions(12020, 12020)
    with pytest.raises(RuntimeError, match=r"driver 12\.1"):
        GL.check_versions(12090, 12010)
    GL.check_versions(12030, 13000)


def test_cpu_solve_takes_the_host_driver():
    """The device and ``spmd`` choose the driver, in code: a CPU optimizer
    never reaches the device loop, and its record says so."""
    opt = O.GoalOptimizer(device="cpu")
    assert opt._device_loops() is None
