"""The port's trace engine (``cruise_control_tpu_torch/traces``) against the
JAX package, on the CPU.

Traces are numpy data: the same wire form must materialize bit-equal factor
arrays in both packages.  Rollouts must give identical verdicts and, on the
JAX traces harness's 10-broker cluster (``traces/bench.py``, 16 pairs x 64
steps), identical per-step ``viol`` / ``sat`` / ``needed`` / ``alive`` /
``action`` series: ints and bools exact, float32 bitwise.  The JAX package
computes them in one ``lax.scan`` inside a ``jax.vmap``; the port steps a
stack of pairs through a Python loop.  Two float sums decide actions and
must round alike: the satisfiability totals (XLA's reduce inside the scan
windows each lane as the unbatched reduce does) and the per-step
balancedness (left to right over the goals), both pinned bitwise below.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.context import GoalContext as JGoalContext
from cruise_control_tpu.analyzer.optimizer import balancedness_cost_by_goal
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.model.arrays import broker_bucket
from cruise_control_tpu.synthetic import SyntheticSpec, generate
from cruise_control_tpu.traces import bench as JBENCH
from cruise_control_tpu.traces import policy as JP
from cruise_control_tpu.traces import trace as JT
from cruise_control_tpu_torch import sim as PSIM
from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.sim import batch as PB
from cruise_control_tpu_torch.traces import policy as PP
from cruise_control_tpu_torch.traces import trace as PT
from tests import fixtures
from tests.torch_port_helpers import assert_keys_superset, assert_records_match, clear_records, port_state

# the packages export a function named ``rollout`` over the module's name
JR = importlib.import_module("cruise_control_tpu.traces.rollout")
PR = importlib.import_module("cruise_control_tpu_torch.traces.rollout")

LIGHT = dict(mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08, mean_nw_out=0.06)


def small_cluster(seed=2, partitions=50, **kw):
    """``tests/test_traces.py``'s 10-broker cluster (JAX state)."""
    spec = SyntheticSpec(
        num_racks=5, num_brokers=10, num_topics=5, num_partitions=partitions,
        replication_factor=2, seed=seed, **{**LIGHT, **kw},
    )
    return generate(spec)[0]


def p_trace(tr):
    return PT.LoadTrace.from_dict(json.loads(json.dumps(tr.to_dict())))


def p_policy(p):
    return PP.AutoscalePolicy(**dataclasses.asdict(p))


def both(state, traces, policies, **kw):
    """The JAX rollout and the port's on the CPU, same inputs; both write one
    ``rollout`` flight record of one shape."""
    clear_records()
    j = JR.rollout(state, traces, policies, **kw)
    p = PR.rollout(port_state(state), [p_trace(t) for t in traces],
                   [p_policy(x) for x in policies], device="cpu", **kw)
    assert [v.to_dict() for v in p.verdicts] == [v.to_dict() for v in j.verdicts]
    assert p.winners() == j.winners()
    assert (p.num_pairs, p.num_steps, p.bucket) == (j.num_pairs, j.num_steps, j.bucket)
    assert p.num_host_syncs == 1
    # the JAX wire keys (numDispatches, which the API schemas require) beside the port's
    assert_keys_superset(p.to_dict(), j.to_dict())
    assert_records_match("rollout", count=1)
    return j, p


MIX = JT.LoadTrace(
    name="mix", num_steps=48, step_s=1800.0, base_factor=1.2, seed=7,
    segments=(
        JT.TraceSegment(kind="diurnal", amplitude=0.3, period=24),
        JT.TraceSegment(kind="ramp", start=8, steps=16, rate=0.05),
        JT.TraceSegment(kind="spike", start=20, magnitude=2.0, decay=0.6),
        JT.TraceSegment(kind="topic_spike", start=4, steps=4, topic=1, magnitude=3.0),
        JT.TraceSegment(kind="topic_growth", topic=0, rate=0.01),
        JT.TraceSegment(kind="noise", sigma=0.02),
        JT.TraceSegment(kind="noise", start=30, sigma=0.5),
    ),
)


# -- the trace DSL and the policies ----------------------------------------------


def test_wire_round_trips_between_the_packages():
    pt = p_trace(MIX)
    assert pt.to_dict() == MIX.to_dict()
    back = JT.LoadTrace.from_dict(json.loads(json.dumps(pt.to_dict())))
    assert back == MIX
    assert PT.LoadTrace.from_dict(pt.to_dict()) == pt


@pytest.mark.parametrize("trace", [
    MIX,
    JT.diurnal_trace(num_steps=32, amplitude=0.4, sigma=0.1, seed=11),
    JT.drift_storm_trace(num_topics=3, phases=5, hold=3, seed=4),
    JT.LoadTrace(num_steps=8, segments=(JT.TraceSegment(kind="ramp", rate=-10.0),)),
], ids=["mix", "noisy-diurnal", "drift-storm", "floored"])
def test_materialize_is_bit_equal(trace):
    """One ``default_rng(seed)`` consumed in segment order: the factors of
    both packages are the same float32 bits."""
    want = trace.materialize(4)
    got = p_trace(trace).materialize(4)
    for name in ("global_factor", "topic_factor"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got.num_steps == want.num_steps


def test_scenario_at_matches():
    arrs = MIX.materialize(4)
    pt = p_trace(MIX)
    for k in (0, 5, 20, 47):
        assert pt.scenario_at(arrs, k).to_dict() == MIX.scenario_at(arrs, k).to_dict()


def test_canned_generators_match():
    for name in ("diurnal_trace", "ramp_trace", "spike_trace", "drift_storm_trace"):
        assert getattr(PT, name)().to_dict() == getattr(JT, name)().to_dict(), name


@pytest.mark.parametrize("bad", [
    {"kind": "ramp", "slope": 0.1},
    {"kind": "nope"},
    {"kind": "diurnal", "period": 0},
    {"kind": "spike", "decay": 1.5},
    {"kind": "topic_spike", "magnitude": 2.0},
])
def test_segment_wire_validation_matches(bad):
    with pytest.raises(ValueError):
        JT.TraceSegment.from_dict(bad)
    with pytest.raises(ValueError):
        PT.TraceSegment.from_dict(bad)


def test_trace_and_policy_validation():
    with pytest.raises(ValueError, match="unknown"):
        PT.LoadTrace.from_dict({"num_steps": 4, "length": 4})
    with pytest.raises(ValueError):
        PT.LoadTrace(num_steps=0).validate()
    with pytest.raises(ValueError):
        PT.LoadTrace(num_steps=4, segments=(PT.TraceSegment(kind="topic_spike", topic=9, magnitude=2.0),)
                     ).materialize(2)
    with pytest.raises(ValueError, match="unknown"):
        PP.AutoscalePolicy.from_dict({"scale_out_thresh": 0.9})
    for bad in (dict(scale_out_threshold=0.0), dict(scale_in_threshold=0.9, scale_out_threshold=0.8),
                dict(step_brokers=0), dict(min_brokers=4, max_brokers=2)):
        with pytest.raises(ValueError):
            PP.AutoscalePolicy(**bad).validate()
    with pytest.raises(ValueError):
        PT.traces_from_wire({"not": "a list"})
    with pytest.raises(ValueError):
        PP.policies_from_wire("nope")
    assert PT.traces_from_wire([MIX.to_dict()])[0] == p_trace(MIX)
    assert PP.policies_from_wire([JP.AutoscalePolicy(name="p").to_dict()])[0].name == "p"


def test_pack_policies_matches():
    """``[N]`` int32 / float32 tensors on the device, the JAX arrays' values."""
    pols = [JP.AutoscalePolicy(), JP.AutoscalePolicy(max_brokers=64, initial_brokers=100),
            JP.AutoscalePolicy(min_balancedness=70.0, cooldown_ticks=2, step_brokers=3),
            JP.frozen_policy(7)]
    want = JP.pack_policies(pols, base_brokers=10, bucket=16)
    got = PP.pack_policies([p_policy(p) for p in pols], base_brokers=10, bucket=16, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        assert str(got[k].dtype) == f"torch.{w.dtype}"
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert PP.frozen_policy(7) == p_policy(JP.frozen_policy(7))


# -- rollout cases of tests/test_traces.py::TestRolloutEquivalence ------------------


def test_frozen_rollout_equals_fast_sweep():
    """A frozen one-pair rollout's per-step verdicts equal ``fast_sweep`` over
    the trace's own scenarios (the port's and the JAX package's)."""
    state, _ = fixtures.unbalanced2().to_arrays()
    B = state.num_brokers
    tr = JT.diurnal_trace(amplitude=0.5, num_steps=8, seed=3)
    arrs = tr.materialize(state.num_topics)
    bucket = broker_bucket(B)
    _, res = both(state, [tr], [JP.frozen_policy(B)], bucket_brokers=bucket)
    v = res.verdicts[0]
    pt = p_trace(tr)
    scens = [pt.scenario_at(arrs, k) for k in range(arrs.num_steps)]
    sweep = PSIM.fast_sweep(port_state(state), scens, bucket_brokers=bucket, device="cpu")
    assert [s.min_brokers_needed for s in sweep.scenarios] == v.needed_by_step
    assert sum(0 if s.satisfiable else 1 for s in sweep.scenarios) == v.violation_steps
    assert min(s.balancedness for s in sweep.scenarios) == v.min_balancedness
    assert v.brokers_by_step == [B] * arrs.num_steps
    assert v.scale_ups == 0 and v.scale_downs == 0
    # per step: the rollout's violation vector is the sweep's
    for k, s in enumerate(sweep.scenarios):
        row = res.series["viol"][0, k]
        assert {JG.GOAL_NAMES[g]: float(row[g]) for g in JG.DEFAULT_GOAL_ORDER} == s.violations


def test_mixed_trace_lengths_masked():
    state = small_cluster()
    short = JT.ramp_trace(name="short", num_steps=4, rate=0.0)
    long = JT.ramp_trace(name="long", num_steps=12, rate=0.0)
    _, res = both(state, [short, long], [JP.frozen_policy(state.num_brokers)])
    by_trace = {v.trace: v for v in res.verdicts}
    assert by_trace["short"].steps == 4 and by_trace["long"].steps == 12
    hours = state.num_brokers * short.step_s / 3600.0
    assert by_trace["short"].broker_hours == pytest.approx(hours * 4)
    assert by_trace["long"].broker_hours == pytest.approx(hours * 12)
    assert len(by_trace["short"].brokers_by_step) == 4


def test_policy_scales_out_under_ramp():
    state = small_cluster(mean_disk=0.5)
    tr = JT.ramp_trace(num_steps=16, rate=0.25)
    reactive = JP.AutoscalePolicy(
        name="reactive", scale_out_threshold=0.7, scale_in_threshold=0.2,
        cooldown_ticks=0, step_brokers=2, max_brokers=32,
    )
    _, res = both(state, [tr], [JP.frozen_policy(state.num_brokers), reactive], bucket_brokers=32)
    frozen_v = next(v for v in res.verdicts if v.policy == "frozen")
    react_v = next(v for v in res.verdicts if v.policy == "reactive")
    assert react_v.scale_ups > 0
    assert react_v.peak_brokers > state.num_brokers
    assert react_v.violation_steps <= frozen_v.violation_steps
    assert react_v.max_drawdown <= frozen_v.max_drawdown


def test_cooldown_gates_actions():
    state = small_cluster(mean_disk=0.5)
    tr = JT.ramp_trace(num_steps=12, rate=0.3)
    kw = dict(step_brokers=1, max_brokers=32, scale_out_threshold=0.7, scale_in_threshold=0.1)
    eager = JP.AutoscalePolicy(name="eager", cooldown_ticks=0, **kw)
    cooled = JP.AutoscalePolicy(name="cooled", cooldown_ticks=3, **kw)
    _, res = both(state, [tr], [eager, cooled], bucket_brokers=32)
    by = {v.policy: v for v in res.verdicts}
    assert by["cooled"].scale_ups + by["cooled"].scale_downs <= (12 + 3) // 4
    assert by["eager"].scale_ups >= by["cooled"].scale_ups


def test_min_max_bounds_hold():
    state = small_cluster()
    tr = JT.spike_trace(num_steps=10, at=2, magnitude=6.0, decay=0.9)
    bounded = JP.AutoscalePolicy(
        name="bounded", min_brokers=8, max_brokers=12, cooldown_ticks=0,
        step_brokers=4, scale_out_threshold=0.6, scale_in_threshold=0.5,
    )
    _, res = both(state, [tr], [bounded], bucket_brokers=16)
    assert all(8 <= b <= 12 for b in res.verdicts[0].brokers_by_step)


def test_winners_prefers_cheapest_violation_free():
    state = small_cluster()
    tr = JT.ramp_trace(name="flat", num_steps=6, rate=0.0)
    big = JP.frozen_policy(10, name="big")
    small = JP.AutoscalePolicy(name="small", min_brokers=8, max_brokers=8, initial_brokers=8,
                               cooldown_ticks=0)
    _, res = both(state, [tr], [big, small], bucket_brokers=16)
    by = {v.policy: v for v in res.verdicts}
    free = [p for p, v in by.items() if v.violation_free]
    want = min(free, key=lambda p: by[p].broker_hours) if free else None
    assert res.winners()["flat"] == want


def test_balancedness_floor_gates_scale_out():
    """A policy with ``min_balancedness`` set acts on the device-side f32
    balancedness; the actions must be the JAX package's."""
    state = small_cluster(mean_disk=0.4)
    tr = JT.diurnal_trace(num_steps=12, amplitude=0.6, seed=5)
    pols = [JP.AutoscalePolicy(name=f"bal{x}", min_balancedness=x, cooldown_ticks=1,
                               scale_out_threshold=0.95, scale_in_threshold=0.3, max_brokers=16)
            for x in (50.0, 80.0, 99.0)]
    _, res = both(state, [tr], pols, bucket_brokers=16)
    assert any(v.scale_ups for v in res.verdicts)


def test_horizon_requirements():
    state = small_cluster(mean_disk=0.5)
    tr = JT.spike_trace(num_steps=8, at=4, magnitude=4.0, decay=0.5)
    want = JR.horizon_requirements(state, tr)
    got = PR.horizon_requirements(port_state(state), p_trace(tr), device="cpu")
    assert_keys_superset(got, want)
    assert got.pop("numHostSyncs") == 1 and want.pop("numDispatches") == 1
    assert got.pop("numDispatches") == 1
    assert got == want
    assert got["brokersToAdd"] == max(got["peakBrokersNeeded"] - state.num_brokers, 0)


# -- the harness's per-step series -----------------------------------------------------


def _jax_series(state, traces, policies, bucket):
    """The JAX rollout's own per-step outputs (its kernel, as ``rollout``
    calls it)."""
    goal_ids = tuple(JG.DEFAULT_GOAL_ORDER)
    full, B_pad = JR._full_headroom_state(state, bucket, max(p.max_brokers for p in policies))
    ctx = JGoalContext.build(state.num_topics, B_pad)
    mats = [t.materialize(state.num_topics) for t in traces]
    T = max(m.num_steps for m in mats)
    pairs = [(ti, pi) for ti in range(len(traces)) for pi in range(len(policies))]
    gf = np.ones((len(pairs), T), np.float32)
    tf = np.ones((len(pairs), T, state.num_topics), np.float32)
    for row, (ti, _) in enumerate(pairs):
        gf[row, :mats[ti].num_steps] = mats[ti].global_factor
        tf[row, :mats[ti].num_steps] = mats[ti].topic_factor
    packed = JP.pack_policies([policies[pi] for _, pi in pairs], state.num_brokers, B_pad)
    costs = balancedness_cost_by_goal(list(goal_ids), set(JG.HARD_GOALS))
    cost_vec = np.zeros(JG.NUM_GOALS, np.float32)
    for g, c in costs.items():
        cost_vec[g] = c
    out = JR._rollout_kernel(full, ctx, gf, tf, packed, cost_vec,
                             base_brokers=state.num_brokers, subset=goal_ids)
    return dict(zip(("viol", "sat", "needed", "alive", "action"), (np.asarray(x) for x in out)))


def test_harness_series_identical():
    """The JAX traces harness (``traces/bench.py``: 4 traces x 4 policies, 64
    steps, bucket 16): every per-step series bitwise, every verdict equal."""
    state, traces, policies = JBENCH._workload()
    _, res = both(state, traces, policies, bucket_brokers=JBENCH.BUCKET)
    want = _jax_series(state, traces, policies, JBENCH.BUCKET)
    assert res.num_pairs == 16 and res.num_steps == 64
    for k, w in want.items():
        g = res.series[k]
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (want["action"] != 0).any()


# -- the two float sums that decide actions ---------------------------------------


def test_step_totals_bitwise_inside_the_scan():
    """The satisfiability totals of every pair at every step: XLA's reduce
    inside ``scan(vmap)`` against the port's ``sweep_totals`` on the stepped
    stack (1,200 replica rows: 38 windows, then a second level)."""
    state = small_cluster(partitions=600, seed=5)
    B_pad = 32
    full, _ = JR._full_headroom_state(state, B_pad, 0)
    ctx = JGoalContext.build(state.num_topics, B_pad)
    rng = np.random.default_rng(3)
    N, T = 3, 4
    gf = (0.5 + rng.random((N, T))).astype(np.float32)
    tf = (0.5 + rng.random((N, T, state.num_topics))).astype(np.float32)
    ns = np.array([[10, 14, 7, 20], [10, 10, 12, 31], [3, 10, 16, 9]], np.int32)

    def one(gf_p, tf_p, n_p):
        def step(c, xs):
            f_t, tf_t, n = xs
            s = JR._step_cluster(full, state.num_brokers, n, f_t, tf_t)
            valid = s.replica_valid
            rf = jax.ops.segment_sum(valid.astype(jnp.int32), s.replica_partition,
                                     num_segments=s.num_partitions)
            total = jnp.where(valid[:, None], s.base_load, 0.0).sum(axis=0)
            total = total + jnp.where((rf > 0)[:, None], s.leadership_delta, 0.0).sum(axis=0)
            thr = ctx.constraint.resource_capacity_threshold
            usable = (jnp.where(s.broker_alive[:, None], s.broker_capacity, 0.0) * thr[None, :]).sum(axis=0)
            return c, (total, usable)
        return jax.lax.scan(step, 0, (gf_p, tf_p, n_p))[1]

    want_total, want_usable = (np.asarray(x) for x in jax.jit(jax.vmap(one))(gf, tf, ns))
    pfull = PR._full_headroom_state(port_state(state), B_pad, 0)[0]
    pctx = GoalContext.build(state.num_topics, B_pad, device="cpu")
    for t in range(T):
        stack = PR._step_cluster(pfull, state.num_brokers, torch.from_numpy(ns[:, t].copy()),
                                 torch.from_numpy(gf[:, t].copy()), torch.from_numpy(tf[:, t].copy()))
        total, usable, _, _, _ = PB.sweep_totals(stack, pctx)
        np.testing.assert_array_equal(total.numpy(), want_total[:, t])
        np.testing.assert_array_equal(usable.numpy(), want_usable[:, t])


def test_balancedness_sums_left_to_right_as_the_scan_does():
    """The per-step f32 balancedness that gates scale-out: the JAX reduce of
    ``[N, NUM_GOALS]`` inside ``scan(vmap)`` (costs of mixed magnitudes, so
    any other order would round differently) against the port's."""
    rng = np.random.default_rng(0)
    N, T = 16, 64
    cost = (rng.random(JG.NUM_GOALS) * 10.0 ** rng.integers(-4, 4, JG.NUM_GOALS)).astype(np.float32)
    viol = (rng.random((N, T, JG.NUM_GOALS)) < 0.5).astype(np.float32)

    def one(v):
        def step(c, x):
            return c, 100.0 - jnp.where(x > 0, cost, 0.0).sum()
        return jax.lax.scan(step, 0, v)[1]

    want = np.asarray(jax.jit(jax.vmap(one))(viol))
    cost_t = torch.from_numpy(cost)
    for t in range(T):
        got = PR._balancedness(torch.from_numpy(viol[:, t].copy()), cost_t)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want[:, t])


def test_policy_step_is_the_scan_body():
    """The threshold update on crafted lanes: each trigger, the cooldown and
    the clamp, against the JAX scan body's arithmetic."""
    packed = JP.pack_policies(
        [JP.AutoscalePolicy(scale_out_threshold=0.8, scale_in_threshold=0.4, min_balancedness=mb,
                            cooldown_ticks=2, step_brokers=s, min_brokers=2, max_brokers=12)
         for mb, s in ((0.0, 1), (60.0, 3), (0.0, 5), (90.0, 2), (0.0, 4), (0.0, 1))],
        base_brokers=8, bucket=16,
    )
    n = np.array([8, 8, 11, 4, 3, 12], np.int32)
    cool = np.array([0, 0, 0, 1, 0, 0], np.int32)
    sat = np.array([True, True, False, True, True, True])
    needed = np.array([7, 2, 5, 1, 1, 3], np.int32)
    alive = np.array([8, 8, 11, 4, 3, 12], np.int32)
    bal = np.array([99.0, 50.0, 99.0, 80.0, 95.0, 99.0], np.float32)

    a_f = alive.astype(np.float32)
    want_out = (~sat) | (needed.astype(np.float32) > packed["out_thr"] * a_f) | (
        (packed["min_bal"] > 0) & (bal < packed["min_bal"]))
    want_in = (~want_out) & (needed.astype(np.float32) < packed["in_thr"] * a_f)
    delta = np.where(want_out, packed["step"], np.where(want_in, -packed["step"], 0))
    delta = np.where(cool <= 0, delta, 0)
    n_next = np.clip(n + delta, packed["min_b"], packed["max_b"])
    cool_next = np.where(n_next != n, packed["cooldown"], np.maximum(cool - 1, 0))

    ptorch = {k: torch.from_numpy(v) for k, v in packed.items()}
    got_n, got_cool = PR._policy_step(
        torch.from_numpy(n), torch.from_numpy(cool), torch.from_numpy(sat), torch.from_numpy(needed),
        torch.from_numpy(alive), torch.from_numpy(bal), ptorch,
    )
    np.testing.assert_array_equal(got_n.numpy(), n_next)
    np.testing.assert_array_equal(got_cool.numpy(), cool_next)
    assert got_n.dtype == torch.int32 and len(set((n_next - n).tolist())) >= 3


def test_rollout_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    state = port_state(small_cluster())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.rollout(state, [PT.ramp_trace(num_steps=2)], [PP.frozen_policy(10)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.horizon_requirements(state, PT.ramp_trace(num_steps=2))
