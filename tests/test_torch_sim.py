"""The port's what-if planner (``cruise_control_tpu_torch/sim``) and drift
math against the JAX package, on the CPU.

Scenario states must equal the JAX ``apply_scenario`` leaf by leaf (dtypes
and values exact).  Sweep verdicts must be identical field by field: ints,
bools, violations and balancedness exact, and the float totals behind
``satisfiable`` / ``min_brokers_needed`` / ``offline_data_to_move`` bitwise.
The JAX package sums them inside ``vmap``; XLA's CPU reduce over the middle
axis of ``[S, n, k]`` windows each lane into 32-row windows, zero padding
split before and after, recursively -- the unbatched order -- and the port
reproduces it with lane-offset windows (``ops.index.xla_sums(lanes=)``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import sim as JSIM
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.analyzer.context import GoalContext as JGoalContext
from cruise_control_tpu.controller.drift import evaluate_drift as j_evaluate_drift
from cruise_control_tpu.model import arrays as JA
from cruise_control_tpu.ops.segments import segment_sum as j_segment_sum
from cruise_control_tpu.synthetic import SyntheticSpec, generate
from cruise_control_tpu_torch import sim as PSIM
from cruise_control_tpu_torch.analyzer.context import GoalContext, take_snapshot
from cruise_control_tpu_torch.analyzer import goals_base as PG
from cruise_control_tpu_torch.controller import evaluate_drift
from cruise_control_tpu_torch.model import arrays as PA
from cruise_control_tpu_torch.ops import index as IX
from cruise_control_tpu_torch.ops.index import segment_max
from cruise_control_tpu_torch.ops.segments import segment_sum_plain
from cruise_control_tpu_torch.sim import batch as PB
from tests.torch_port_helpers import port_ctx, port_state

LIGHT = dict(mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08, mean_nw_out=0.06)
SUBSET = tuple(JG.DEFAULT_GOAL_ORDER)


def small_cluster(seed=2, partitions=50, **kw):
    """``tests/test_sim.py``'s 10-broker cluster (JAX state)."""
    spec = SyntheticSpec(
        num_racks=5, num_brokers=10, num_topics=5, num_partitions=partitions,
        replication_factor=2, seed=seed, **{**LIGHT, **kw},
    )
    return generate(spec)[0]


def port_scenario(sc):
    return PSIM.Scenario(**dataclasses.asdict(sc))


def assert_same_state(pstate, jstate):
    """Every leaf equal, dtype included; static counts equal."""
    for f in dataclasses.fields(jstate):
        want, got = getattr(jstate, f.name), getattr(pstate, f.name)
        if isinstance(got, torch.Tensor):
            w = np.asarray(want)
            assert got.device.type == "cpu", f.name
            assert got.numpy().dtype == w.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f.name)
        else:
            assert got == want, f.name


# -- scenario semantics -------------------------------------------------------------


SCENARIOS = {
    "add": JSIM.Scenario(name="add", add_brokers=3),
    "remove": JSIM.Scenario(name="remove", remove_brokers=(1, 4)),
    "kill_failover": JSIM.Scenario(name="kill", kill_brokers=(0, 7)),
    "drop_rack": JSIM.Scenario(name="rack", drop_rack=2),
    "load": JSIM.Scenario(name="load", load_factor=1.37),
    "topic": JSIM.Scenario(name="topic", topic_load_factors=((0, 4.0), (3, 0.3))),
    "capacity": JSIM.Scenario(name="cap", capacity_factors=(1.0, 2.0, 0.7, 3.0)),
    "mixed": JSIM.Scenario(
        name="mixed", add_brokers=2, kill_brokers=(3,), remove_brokers=(5,), drop_rack=1,
        load_factor=1.3, topic_load_factors=((2, 2.5),), capacity_factors=(0.9, 1.1, 1.0, 0.5),
    ),
}


@pytest.mark.parametrize("kind", sorted(SCENARIOS))
@pytest.mark.parametrize("bucket", [None, 32])
def test_apply_scenario_matches_jax_leaf_by_leaf(kind, bucket):
    jbase = small_cluster()
    sc = SCENARIOS[kind]
    jstate = JSIM.apply_scenario(jbase, sc, bucket_brokers=bucket)
    pstate = PSIM.apply_scenario(port_state(jbase), port_scenario(sc), bucket_brokers=bucket)
    assert_same_state(pstate, jstate)


def test_kill_over_base_dead_brokers_matches_jax():
    """Failover never elects a replica on a broker already dead in the base:
    every partition the killed broker led, with its other replicas on
    base-dead brokers, becomes leaderless (-1)."""
    jbase = small_cluster()
    rb = np.asarray(jbase.replica_broker)
    lb = rb[np.asarray(jbase.partition_leader)]
    target = int(lb[0])
    rp = np.asarray(jbase.replica_partition)
    victims = set()
    for p in np.flatnonzero(lb == target):
        victims |= {int(b) for b in rb[rp == p] if b != target}
    for b in victims:
        jbase = JA.set_broker_state(jbase, b, alive=False)
    sc = JSIM.Scenario(kill_brokers=(target,))
    jstate = JSIM.apply_scenario(jbase, sc)
    pstate = PSIM.apply_scenario(port_state(jbase), port_scenario(sc))
    assert_same_state(pstate, jstate)
    assert (pstate.partition_leader.numpy()[lb == target] == -1).all()


def test_wire_round_trip_and_format():
    sc = JSIM.Scenario(
        name="x", add_brokers=2, remove_brokers=(1,), kill_brokers=(3, 4), drop_rack=1,
        load_factor=1.5, topic_load_factors=((2, 3.0),), capacity_factors=(1.0, 2.0, 1.0, 0.5),
        goal_order=(JG.RACK_AWARE, JG.DISK_CAPACITY),
    )
    psc = port_scenario(sc)
    assert psc.to_dict() == sc.to_dict()
    assert PSIM.Scenario.from_dict(sc.to_dict()) == psc
    assert PSIM.Scenario.from_dict({"goal_order": [0, "DiskCapacityGoal"]}).goal_order == (0, 3)


@pytest.mark.parametrize(
    "bad",
    [
        dict(kill_brokers=(99,)), dict(remove_brokers=(-1,)), dict(load_factor=0.0),
        dict(drop_rack=77), dict(add_brokers=-1), dict(capacity_factors=(1.0, 0.0, 1.0, 1.0)),
        dict(topic_load_factors=((9, 1.0),)), dict(topic_load_factors=((0, -1.0),)),
    ],
)
def test_validation_errors(bad):
    pbase = port_state(small_cluster())
    with pytest.raises(ValueError):
        PSIM.Scenario(**bad).validate(pbase)
    with pytest.raises(ValueError):
        PSIM.apply_scenario(pbase, PSIM.Scenario(**bad))


def test_wire_rejects_unknown_keys_and_goals():
    with pytest.raises(ValueError, match="load_factorr"):
        PSIM.Scenario.from_dict({"load_factorr": 2.0})
    with pytest.raises(ValueError, match="unknown goal"):
        PSIM.Scenario.from_dict({"goal_order": ["NoSuchGoal"]})
    with pytest.raises(ValueError):
        PSIM.apply_scenario(port_state(small_cluster()), PSIM.Scenario(add_brokers=30), bucket_brokers=16)


# -- fast sweep ---------------------------------------------------------------------


def _sweep_scenarios(n):
    """The JAX sweep harness's mix (scripts/bench_sim.py make_scenarios:
    adds, spot failures, load scaling) on the 10-broker cluster, with a load
    spread wide enough for unsatisfiable lanes, a rack drop and a capacity
    cut among them."""
    out = []
    for i in range(n):
        out.append(JSIM.Scenario(
            name=f"s{i}", add_brokers=i % 4, kill_brokers=(i % 5,) if i % 3 == 0 else (),
            load_factor=1.0 + 1.6 * i,
            drop_rack=1 if i == 4 else None,
            capacity_factors=(1.0, 1.0, 1.0, 0.6) if i == 2 else (1.0, 1.0, 1.0, 1.0),
        ))
    return out


@pytest.mark.parametrize("lanes", [1, 5, 8])
def test_fast_sweep_matches_jax(lanes):
    jbase = small_cluster()
    scs = _sweep_scenarios(lanes)
    jr = JSIM.fast_sweep(jbase, scs, goal_ids=SUBSET)
    pr = PSIM.fast_sweep(port_state(jbase), [port_scenario(s) for s in scs], goal_ids=SUBSET, device="cpu")
    assert pr.sweep_size == jr.sweep_size == lanes and pr.bucket == jr.bucket
    assert [v.to_dict() for v in pr.scenarios] == [v.to_dict() for v in jr.scenarios]
    assert pr.num_host_syncs == 1
    assert len({v.satisfiable for v in pr.scenarios}) == (1 if lanes == 1 else 2)


def _jax_totals(states, ctx):
    """The float totals of ``cruise_control_tpu/sim/batch.py``'s
    ``_hard_satisfiability`` and ``_sweep_kernel_fn``, written as there and
    vmapped over the scenario axis."""
    from cruise_control_tpu.core.resources import Resource

    def one(state):
        valid = state.replica_valid
        rf = j_segment_sum(valid.astype(jnp.int32), state.replica_partition, num_segments=state.num_partitions)
        total = jnp.where(valid[:, None], state.base_load, 0.0).sum(axis=0)
        total = total + jnp.where((rf > 0)[:, None], state.leadership_delta, 0.0).sum(axis=0)
        thr = ctx.constraint.resource_capacity_threshold
        usable = (jnp.where(state.broker_alive[:, None], state.broker_capacity, 0.0) * thr[None, :]).sum(axis=0)
        offline = state.replica_offline_mask()
        off_bytes = jnp.where(offline, state.base_load[:, Resource.DISK], 0.0).sum()
        return total, usable, rf, off_bytes

    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(states)]


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_sweep_totals_bitwise_in_the_vmapped_xla_order(lanes):
    """1,200 replica rows: 38 windows of 32, then a second level."""
    jbase = small_cluster(partitions=600, seed=5)
    scs = _sweep_scenarios(lanes)
    jb = JSIM.build_batch(jbase, scs)
    jctx = JGoalContext.build(jbase.num_topics, jb.bucket[0])
    want_total, want_usable, want_rf, want_off = _jax_totals(jb.states, jctx)
    pb = PSIM.build_batch(port_state(jbase), [port_scenario(s) for s in scs], device="cpu")
    total, usable, rf, offline, off_bytes = PB.sweep_totals(pb.states, port_ctx(jctx))
    np.testing.assert_array_equal(total.numpy(), want_total)
    np.testing.assert_array_equal(usable.numpy(), want_usable)
    np.testing.assert_array_equal(rf.numpy(), want_rf)
    np.testing.assert_array_equal(off_bytes.numpy(), want_off)
    assert int(offline.sum()) > 0


@pytest.mark.parametrize("lane_call_windows", [1, 40, 100, 10**9])
def test_lane_batched_xla_sums_split_into_calls_keep_the_order(monkeypatch, lane_call_windows):
    """However a level's lanes are split into calls, every lane's sum is
    bitwise its own unbatched ``xla_sums`` (1,200 rows: 38 windows, then 2)."""
    rng = np.random.default_rng(7)
    lanes, n = 5, 1200
    load = torch.from_numpy((rng.exponential(size=(lanes * n, 4)) * 1000).astype(np.float32))
    off = torch.from_numpy((rng.exponential(size=lanes * n) * 10).astype(np.float32))
    monkeypatch.setattr(IX, "LANE_CALL_WINDOWS", lane_call_windows)
    got_load, got_off = IX.xla_sums([load, off], lanes=lanes)
    assert got_load.shape == (lanes, 4) and got_off.shape == (lanes,)
    for i in range(lanes):
        want_load, want_off = IX.xla_sums([load[i * n:(i + 1) * n], off[i * n:(i + 1) * n]])
        assert torch.equal(got_load[i], want_load) and torch.equal(got_off[i], want_off)


def test_padding_is_inert():
    """A no-op scenario padded to the bucket equals the unpadded base."""
    jbase = small_cluster()
    pbase = port_state(jbase)
    r = PSIM.fast_sweep(pbase, [PSIM.Scenario(name="noop")], goal_ids=SUBSET, device="cpu")
    assert r.bucket[0] == 16 and pbase.num_brokers == 10
    ctx = GoalContext.build(pbase.num_topics, pbase.num_brokers, device="cpu")
    direct = PG.violations_all(pbase, ctx, take_snapshot(pbase, ctx), subset=SUBSET)
    for g in SUBSET:
        assert r.scenarios[0].violations[PG.GOAL_NAMES[g]] == float(direct[g])


def test_bucket_16_and_32_give_identical_verdicts():
    pbase = port_state(small_cluster())
    scs = [PSIM.Scenario(name="a", add_brokers=2, load_factor=1.4),
           PSIM.Scenario(name="b", kill_brokers=(0,)), PSIM.Scenario(name="c", drop_rack=3)]
    r16 = PSIM.fast_sweep(pbase, scs, bucket_brokers=16, goal_ids=SUBSET, device="cpu")
    r32 = PSIM.fast_sweep(pbase, scs, bucket_brokers=32, goal_ids=SUBSET, device="cpu")
    assert r16.bucket[0] == 16 and r32.bucket[0] == 32
    assert [v.to_dict() for v in r16.scenarios] == [v.to_dict() for v in r32.scenarios]


def test_lane_offset_calls_equal_per_lane_plain_versions():
    """The sweep's two batch-wide calls: replication factors (integer
    segment sum, ids ``lane * P + partition``) and alive racks (segment max,
    ids ``lane * racks + rack``) against each lane's own plain call."""
    pbase = port_state(small_cluster(partitions=300))
    scs = [PSIM.Scenario(kill_brokers=(1,)), PSIM.Scenario(drop_rack=0), PSIM.Scenario(add_brokers=5)]
    states = PSIM.build_batch(pbase, scs, device="cpu").states
    rf = PA.replication_factors(states)
    S, P = states.partition_topic.shape
    racks = states.num_racks
    alive_racks = segment_max(
        states.broker_alive.to(torch.int32).reshape(-1), PA.lane_ids(states.broker_rack, racks), S * racks
    ).view(S, racks)
    for i in range(S):
        lane = PA.index_arrays(states, i)
        want_rf = segment_sum_plain(lane.replica_valid.to(torch.int32), lane.replica_partition, P)
        assert torch.equal(rf[i], want_rf)
        want_racks = segment_max(lane.broker_alive.to(torch.int32), lane.broker_rack, racks)
        assert torch.equal(alive_racks[i], want_racks)
    assert int(alive_racks[1, 0]) == 0 and int(alive_racks[0].min()) == 1
    # an id out of range drops; it never lands in the next lane's segments
    ids = PA.lane_ids(torch.tensor([[0, 3, -1], [2, 3, 1]], dtype=torch.int32), 3)
    assert ids.tolist() == [0, -1, -1, 5, -1, 4]


# -- capacity planner ---------------------------------------------------------------


def _message_shape(msg):
    """A recommendation message with the host-sync / dispatch count cut out."""
    return msg.split(" scenarios, ")[0]


@pytest.mark.parametrize("load_factor", [1.0, 3.0, 40.0])
def test_plan_capacity_matches_jax(load_factor):
    """40x is unsatisfiable up to the search cap (20 brokers)."""
    jbase = small_cluster()
    jp = JSIM.plan_capacity(jbase, load_factor=load_factor)
    pp = PSIM.plan_capacity(port_state(jbase), load_factor=load_factor, device="cpu")
    assert [dataclasses.astuple(p) for p in pp.probes] == [dataclasses.astuple(p) for p in jp.probes]
    assert pp.min_brokers == jp.min_brokers and pp.current_brokers == jp.current_brokers
    jrec, prec = jp.recommendation, pp.recommendation
    assert (prec.status, prec.num_brokers_to_add, prec.num_brokers_to_remove) == (
        jrec.status, jrec.num_brokers_to_add, jrec.num_brokers_to_remove
    )
    assert _message_shape(prec.message) == _message_shape(jrec.message)
    jmeta = {k: v for k, v in jrec.sweep.items() if k != "num_dispatches"}
    pmeta = {k: v for k, v in prec.sweep.items() if k != "num_host_syncs"}
    assert pmeta == jmeta
    assert prec.sweep["num_host_syncs"] == pp.num_host_syncs >= 1
    if load_factor == 40.0:
        assert pp.min_brokers is None and prec.status == "UNDER_PROVISIONED"


# -- drift ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_drift_matches_jax(seed):
    rng = np.random.default_rng(seed)
    now = (rng.integers(0, 4, size=PG.NUM_GOALS) * (rng.random(PG.NUM_GOALS) < 0.5)).astype(np.float32)
    then = (rng.integers(0, 3, size=PG.NUM_GOALS) * (rng.random(PG.NUM_GOALS) < 0.5)).astype(np.float32)
    goals = tuple(range(16)) if seed != 2 else (0, 3, 7, 18, 9)
    for baseline in (then, None):
        got = evaluate_drift(now, baseline, goals, PG.HARD_GOALS)
        want = j_evaluate_drift(now, baseline, goals, JG.HARD_GOALS)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- devices -------------------------------------------------------------------------


def test_sweep_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    pbase = port_state(small_cluster())
    sc = [PSIM.Scenario(name="a")]
    state = PSIM.apply_scenario(pbase, sc[0])          # host work: a CPU state
    assert state.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: PSIM.build_batch(pbase, sc),
        lambda: PSIM.fast_sweep(pbase, sc),
        lambda: PSIM.deep_sweep(pbase, sc),
        lambda: PSIM.plan_capacity(pbase),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
