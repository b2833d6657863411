"""The lane axis of the evaluation (``analyzer/context.py`` ``take_snapshot``,
``analyzer/goals_base.py`` ``violations_all`` over a stack), on the CPU.

The JAX package evaluates a stack of clusters as one program, ``vmap`` over
the single-cluster evaluator (``_violations_b_fn``, the sweep kernel, the
rollout's ``scan(vmap)``, the fleet's drift probe).  The port takes the same
lane axis: one lane-form snapshot and one violation pass for a whole stack,
each segment-sum call covering every lane under lane-offset ids.  Here:

* the lane form against the JAX vmapped program and against the port's
  single-cluster ``_violations_fn`` on each lane, bitwise, with lanes that
  differ in alive brokers, a dropped rack, offline replicas, dead JBOD
  logdirs, heavy goals on and off and the kafka-assigner goals;
* the evaluations that consume a stack -- ``fast_sweep``, a rollout step and
  the fleet's drift probe -- take one snapshot, one violation pass and as
  many kernel host calls at 3 lanes as at 9;
* the int32 limit of lane-offset ids, raised before anything is allocated;
* the rollout step reads nothing from the host, so the card can capture it.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import sim as JSIM
from cruise_control_tpu.analyzer.context import GoalContext as JGoalContext
from cruise_control_tpu.analyzer.context import take_snapshot as j_take_snapshot
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JGoalOptimizer
from cruise_control_tpu.model.arrays import stack_arrays as j_stack
from cruise_control_tpu.synthetic import SyntheticSpec, generate
from cruise_control_tpu_torch import sim as PSIM
from cruise_control_tpu_torch.analyzer import context as PC
from cruise_control_tpu_torch.analyzer import goals_base as PG
from cruise_control_tpu_torch.analyzer import optimizer as PO
from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.model import arrays as PA
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from tests.test_torch_device_loop import _HOST_READS, _RefuseHostWork
from tests.torch_port_helpers import port_ctx, port_state

BUCKET = 16
LIGHT = dict(mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08, mean_nw_out=0.06)
#: every goal: the kafka-assigner goals first (a constructive placement must
#: lead a goal list), then the 16 defaults and the optional goals 16-21
ALL_GOALS = (PG.KAFKA_ASSIGNER_RACK, PG.KAFKA_ASSIGNER_DISK) + tuple(range(PG.KAFKA_ASSIGNER_RACK))


def _cluster(disks: int):
    spec = SyntheticSpec(num_racks=5, num_brokers=10, num_topics=5, num_partitions=60, replication_factor=3,
                         seed=4, disks_per_broker=disks, **LIGHT)
    return generate(spec)[0]


def _lanes(disks: int):
    """JAX lane states padded to one bucket: the base, a killed broker
    (offline replicas), a dropped rack, added brokers under more load, and on
    JBOD a dead logdir (offline replicas on an alive broker)."""
    base = _cluster(disks)
    scenarios = [
        JSIM.Scenario(name="base"),
        JSIM.Scenario(name="kill", kill_brokers=(1,), load_factor=1.2),
        JSIM.Scenario(name="rack", drop_rack=2),
        JSIM.Scenario(name="add", add_brokers=3, load_factor=2.5),
    ]
    lanes = [JSIM.apply_scenario(base, s, bucket_brokers=BUCKET) for s in scenarios]
    if disks:
        dead = np.asarray(lanes[0].disk_alive).copy()
        dead[[3, 8]] = False
        lanes.append(lanes[0].replace(disk_alive=jnp.asarray(dead)))
    return lanes, JGoalContext.build(base.num_topics, BUCKET)


#: every violation counter; heavy goals on and off; single-disk and JBOD
CASES = [
    pytest.param(disks, heavy, id=f"{'jbod' if disks else 'plain'}-{'heavy' if heavy else 'light'}")
    for disks in (0, 2) for heavy in (False, True)
]
#: the snapshot fields that are sums over replicas or brokers
SUM_FIELDS = (
    "broker_load", "replica_counts", "leader_counts", "potential_nw_out", "rack_counts", "leader_nw_in",
    "offline_per_broker", "rack_viol_need", "broker_set_need", "avg_util_pct", "disk_load",
    "disk_replica_counts", "topic_counts", "topic_leader_counts",
)


@pytest.mark.parametrize("disks,heavy", CASES)
def test_lane_form_equals_the_jax_vmap_and_each_lane_alone(disks, heavy):
    """Every lane of the lane form against two references, bitwise: the JAX
    package's vmapped program (``GoalOptimizer.batched_violations`` and the
    vmapped ``take_snapshot``) and the port's single-cluster
    ``_violations_fn`` / ``take_snapshot`` on that lane.

    Where the two JAX programs agree (every case here), so do all three.
    Where XLA's single-cluster and vmapped orders of a float sum could part,
    the JAX vmapped program is the reference of a stack: the lane form's
    cross-broker sums take ``xla_sums(lanes=)``, the order of XLA's reduce
    over the middle axis of ``[S, n, k]``, and its segment sums keep each
    lane's rows in order (``test_torch_sim.py``
    ``test_sweep_totals_bitwise_in_the_vmapped_xla_order``)."""
    jlanes, jctx = _lanes(disks)
    jstack = j_stack(jlanes)
    want = np.asarray(JGoalOptimizer(goal_ids=ALL_GOALS, enable_heavy_goals=heavy).batched_violations(jstack, jctx))
    jsnap = jax.jit(jax.vmap(lambda s: j_take_snapshot(s, jctx, heavy)))(jstack)

    lanes = [port_state(s) for s in jlanes]
    stack, ctx = PA.stack_arrays(lanes), port_ctx(jctx)
    opt = PO.GoalOptimizer(goal_ids=ALL_GOALS, enable_heavy_goals=heavy, device="cpu")
    got = opt.batched_violations(stack, ctx)
    assert got.shape == (len(lanes), PG.NUM_GOALS) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    snap = PC.take_snapshot(stack, ctx, heavy)
    for name in SUM_FIELDS:
        j = getattr(jsnap, name)
        if j is None or getattr(snap, name) is None:
            assert (j is None or not np.asarray(j).size) == (getattr(snap, name) is None), name
            continue
        np.testing.assert_array_equal(getattr(snap, name).numpy(), np.asarray(j), err_msg=name)
    for i, lane in enumerate(lanes):
        assert torch.equal(got[i], PO._violations_fn(lane, ctx, heavy, opt.goal_ids)), i
        one = PC.take_snapshot(lane, ctx, heavy)
        for f in dataclasses.fields(one):
            x = getattr(one, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(getattr(snap, f.name)[i], x), (i, f.name)
    # the lanes differ: each case above changes what its lane violates
    assert len({tuple(r) for r in want.tolist()}) == len(lanes)
    assert want[:, PG.KAFKA_ASSIGNER_RACK].min() > 0 and want[1, PG.RACK_AWARE] > 0


# -- one evaluation for the whole stack -------------------------------------------------


class _Calls:
    """Counts ``take_snapshot`` and ``violations_all`` calls (as the
    optimizer calls them) and the kernel wrappers' host calls (the
    profiler's census counts a plain CPU call under the path a card would
    launch)."""

    def __init__(self, monkeypatch):
        from cruise_control_tpu_torch.obs.profiler import PROFILER

        self.snapshots = self.passes = 0
        take, viol = PO.take_snapshot, PG.violations_all

        def counted_take(*a, **k):
            self.snapshots += 1
            return take(*a, **k)

        def counted_viol(*a, **k):
            self.passes += 1
            return viol(*a, **k)

        monkeypatch.setattr(PO, "take_snapshot", counted_take)
        monkeypatch.setattr(PG, "violations_all", counted_viol)
        self._profiler = PROFILER
        self._mark = PROFILER.mark()

    def kernel_calls(self) -> int:
        return self._profiler.mark().calls - self._mark.calls


def _port_cluster():
    return port_state(_cluster(0))


def _sweep_scenarios(n):
    return [PSIM.Scenario(name=f"s{i}", load_factor=1.0 + 0.1 * i, kill_brokers=(i % 10,) if i % 3 else ())
            for i in range(n)]


def _rollout_workload(pairs_per_trace):
    from cruise_control_tpu_torch.traces import AutoscalePolicy, diurnal_trace, spike_trace

    traces = [diurnal_trace(name="d", num_steps=3, amplitude=0.4),
              spike_trace(name="s", num_steps=3, at=1, magnitude=1.5),
              diurnal_trace(name="n", num_steps=3, amplitude=0.3, sigma=0.05, seed=9)]
    policies = [AutoscalePolicy(name=f"p{i}", scale_out_threshold=0.6 + 0.08 * i, scale_in_threshold=0.3,
                                cooldown_ticks=i, step_brokers=1, max_brokers=16) for i in range(pairs_per_trace)]
    return traces, policies


def _evaluate(what, lanes, monkeypatch):
    """(snapshots, violation passes, kernel host calls) of one evaluation at ``lanes`` lanes."""
    R = importlib.import_module("cruise_control_tpu_torch.traces.rollout")
    base = _port_cluster()
    calls = _Calls(monkeypatch)
    if what == "fast_sweep":
        PSIM.fast_sweep(base, _sweep_scenarios(lanes), goal_ids=PG.DEFAULT_GOAL_ORDER, device="cpu")
    elif what == "rollout":
        # 3 traces x (lanes / 3) policies, 3 steps: counted over the rollout, per step
        R.rollout(base, *_rollout_workload(lanes // 3), bucket_brokers=16, device="cpu")
    elif what == "sharded_block":
        # one rank's block of a sweep over 3 ranks (sim/batch.py _sharded_sweep); the
        # gather stands in for the collective, which this rank's count does not depend on
        PB = importlib.import_module("cruise_control_tpu_torch.sim.batch")
        batch = PSIM.build_batch(base, _sweep_scenarios(lanes), device="cpu")
        ctx = GoalContext.build(base.num_topics, batch.bucket[0], device="cpu")
        rank = type("Rank", (), dict(world=3, rank=1, all_gather=lambda self, t: torch.cat([t] * 3)))()
        PB._sharded_sweep(batch.states, ctx, rank, batch.size, False, PG.DEFAULT_GOAL_ORDER, PO.HostSyncs())
    else:
        # the fleet's drift probe (fleet/controller.py): one batched_violations of the group's stack
        probes = PA.stack_arrays([PSIM.apply_scenario(base, s, bucket_brokers=BUCKET) for s in _sweep_scenarios(lanes)])
        PO.GoalOptimizer(enable_heavy_goals=True, device="cpu").batched_violations(
            probes, GoalContext.build(base.num_topics, BUCKET, device="cpu"))
    monkeypatch.undo()
    return calls.snapshots, calls.passes, calls.kernel_calls()


@pytest.mark.parametrize("what", ["fast_sweep", "sharded_block", "rollout", "fleet_probe"])
def test_one_snapshot_and_one_violation_pass_for_the_whole_stack(what, monkeypatch):
    """At 3 lanes and at 9 (a rank's block of 1 and of 3): one
    ``take_snapshot`` and one ``violations_all`` an evaluation (a rollout's
    each of its 3 steps), and the same kernel host calls -- nothing on these
    paths walks the lanes."""
    few, many = _evaluate(what, 3, monkeypatch), _evaluate(what, 9, monkeypatch)
    steps = 3 if what == "rollout" else 1
    assert few[:2] == many[:2] == (steps, steps)
    assert few[2] == many[2] > 0


# -- the int32 limit ----------------------------------------------------------------------


def _expanded_stack(lanes, replicas, partitions, brokers, topics, disks, racks) -> ClusterArrays:
    """A stack at full width that holds no memory: every leaf one element expanded."""
    def leaf(shape, dtype):
        return torch.zeros((), dtype=dtype).expand((lanes,) + shape)

    i32, f32, b = torch.int32, torch.float32, torch.bool
    return ClusterArrays(
        replica_partition=leaf((replicas,), i32), replica_broker=leaf((replicas,), i32),
        replica_disk=leaf((replicas,), i32), replica_valid=leaf((replicas,), b),
        base_load=leaf((replicas, 4), f32), original_broker=leaf((replicas,), i32),
        partition_topic=leaf((partitions,), i32), partition_leader=leaf((partitions,), i32),
        leadership_delta=leaf((partitions, 4), f32), broker_rack=leaf((brokers,), i32),
        broker_host=leaf((brokers,), i32), broker_capacity=leaf((brokers, 4), f32),
        broker_alive=leaf((brokers,), b), broker_new=leaf((brokers,), b), broker_demoted=leaf((brokers,), b),
        disk_broker=leaf((disks,), i32), disk_capacity=leaf((disks,), f32), disk_alive=leaf((disks,), b),
        num_racks=racks, num_topics=topics, num_hosts=brokers,
    )


@pytest.mark.parametrize("heavy", [False, True])
def test_lane_offset_ids_never_pass_int32(heavy):
    """Config #4's width (3M replicas, 1M partitions x 40 racks, bucket
    16,384 x 2,000 topics, 20,000 logdirs): one lane's widest call is its
    40M rack-count segments (heavy: also 2 x 32.8M topic-table columns), so
    53 lanes fit and 54 would pass 2**31 - 1.  The lane form raises a
    ValueError naming the limit before it allocates anything (the stack here
    is expanded views: an attempt to build a table would need hundreds of
    GB)."""
    shape = dict(replicas=3_000_000, partitions=1_000_000, brokers=16_384, topics=2_000, disks=20_000, racks=40)
    span = 40_000_000 if not heavy else 2 * 16_384 * 2_000
    assert PC.lane_span(_expanded_stack(1, **shape), heavy) == span
    fits = (2**31 - 1) // span
    PC.check_lane_span(fits, span)
    ctx = GoalContext.build(shape["topics"], shape["brokers"], device="cpu")
    with pytest.raises(ValueError, match=rf"{fits + 1} lanes x {span:,} .* int32 indexing \(2,147,483,647\)"):
        PO.lane_violations(_expanded_stack(fits + 1, **shape), ctx, heavy, PG.DEFAULT_GOAL_ORDER)
    # the sweep, the rollout and the fleet probe evaluate through the same snapshot
    with pytest.raises(ValueError, match="int32 indexing"):
        PC.take_snapshot(_expanded_stack(66, **shape), ctx, heavy)


# -- the rollout step can be captured -------------------------------------------------------


def test_rollout_step_has_no_host_read(monkeypatch):
    """The rollout's step, the body the card captures and runs T times in a
    counted WHILE node, with every host read patched to raise and every
    operation that waits on the device or copies host data refused; its
    outputs then equal the CPU rollout's first step."""
    R = importlib.import_module("cruise_control_tpu_torch.traces.rollout")
    from cruise_control_tpu_torch.traces.policy import pack_policies

    base = _port_cluster()
    traces, policies = _rollout_workload(2)
    want = R.rollout(base, traces, policies, bucket_brokers=16, device="cpu")
    full, B_pad = R._full_headroom_state(base, 16, 16)
    ctx = GoalContext.build(base.num_topics, B_pad, device="cpu")
    pairs = [(t, p) for t in traces for p in policies]
    N, T = len(pairs), 3
    gf = torch.stack([torch.from_numpy(t.materialize(base.num_topics).global_factor) for t, _ in pairs])
    tf = torch.stack([torch.from_numpy(t.materialize(base.num_topics).topic_factor) for t, _ in pairs])
    packed = pack_policies([p for _, p in pairs], base.num_brokers, B_pad, device="cpu")
    cost = torch.from_numpy(np.asarray(
        [R.balancedness_cost_by_goal(list(PG.DEFAULT_GOAL_ORDER), set(PG.HARD_GOALS)).get(g, 0.0)
         for g in range(PG.NUM_GOALS)], np.float32))
    bufs = R._step_inputs(full, ctx, gf, tf, cost, packed, packed["init_b"].clone())
    bufs.update({f"out_{k}": torch.zeros((N, T) + shape, dtype=dtype) for k, (shape, dtype) in R._OUTPUTS.items()})
    ctl = torch.zeros(2, dtype=torch.int32)

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"Tensor.{name} inside the rollout step")
        return read

    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    with _RefuseHostWork():
        R._rollout_step(bufs, ctl, full=full, ctx=ctx, base_brokers=base.num_brokers,
                        goal_ids=PG.DEFAULT_GOAL_ORDER)
    monkeypatch.undo()
    for k in R._OUTPUTS:
        np.testing.assert_array_equal(bufs[f"out_{k}"][:, 0].numpy(), want.series[k][:, 0], err_msg=k)


def test_segment_argmax_takes_the_first_index_in_each_lane():
    """The lane form of ``segment_argmax``: each lane's segments keep the
    lowest index of their best eligible row within that lane, as the lane's
    own call gives (ties and out-of-range ids included)."""
    rng = np.random.default_rng(5)
    L, n, S = 4, 300, 17
    scores = torch.from_numpy(rng.integers(0, 6, size=(L, n)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(-2, S + 2, size=(L, n)).astype(np.int32))
    eligible = torch.from_numpy(rng.random((L, n)) < 0.8)
    got = PC.segment_argmax(scores, seg, S, eligible, lanes=L)
    assert got.shape == (L, S)
    for i in range(L):
        assert torch.equal(got[i], PC.segment_argmax(scores[i], seg[i], S, eligible[i])), i
