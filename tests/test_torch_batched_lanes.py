"""The solver's lane form (``analyzer/lanes.py``): a stack of clusters solved
as ONE program, as the JAX package's ``vmap`` of its goal steps solves it, on
the CPU.

``GoalOptimizer.batched_optimize`` and ``batched_incremental_optimize`` run
each goal once for the whole stack: every round is one lane-form snapshot and
one round lifted over the lanes with ``torch.func.vmap``; each lane runs its
own phases and pass cycle, and a lane that has ended is frozen until every
lane is done.  The stack here is built so that its lanes end at different
rounds: a balanced lane that applies nothing, lanes that hit a round cap of
6, a lane whose ReplicaDistributionGoal takes three passes where another
takes two, and a lane with a dead broker (the offline pre-phases).  Checked:

* per module -- the index scatters and the XLA-order scan, the replica
  relocations and swaps, a round of each proposer family with its prior
  goals' acceptance, admission and apply, and the kafka-assigner pass --
  the lane form against each lane alone, bitwise; the scatters' negative and
  out-of-range indices beside a lane boundary stay in their lane;
* one phase against ``jax.vmap`` of the JAX phase loop;
* the whole solves against each lane's single solve and against the JAX
  batched solves (placements, leaders, logdirs, rounds, moves, violations);
* the host driver reads once a round for the stack; the int32 limit of a
  round's widest call; vmap's per-lane fallback raises instead of walking
  the lanes.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import GoalContext as JGoalContext
from cruise_control_tpu.analyzer import optimizer as JO
from cruise_control_tpu.analyzer.goal_rounds import GOAL_ROUNDS as JGOAL_ROUNDS
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JGoalOptimizer
from cruise_control_tpu.model.arrays import stack_arrays as j_stack
from cruise_control_tpu_torch.analyzer import context as PC
from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer import optimizer as O
from cruise_control_tpu_torch.analyzer.acceptance import accept_all
from cruise_control_tpu_torch.analyzer.context import GoalContext, take_snapshot
from cruise_control_tpu_torch.analyzer.goal_rounds import GOAL_ROUNDS, offline_round
from cruise_control_tpu_torch.analyzer.lanes import lift
from cruise_control_tpu_torch.analyzer.moves import admit, apply_moves, move_effects
from cruise_control_tpu_torch.model import arrays as PA
from cruise_control_tpu_torch.ops import assign as ASG
from cruise_control_tpu_torch.ops.index import cumsum, scatter_last, scatter_set, segment_max, segment_min
from cruise_control_tpu_torch.ops.segments import lane_ids, segment_sums
from tests.test_torch_device_loop import _HOST_READS, _RefuseHostWork
from tests.test_torch_lanes import _expanded_stack
from tests.torch_port_helpers import SMALL20, one_intra_op_thread, port_ctx, port_state, to_np  # noqa: F401

GOALS = (G.RACK_AWARE, G.REPLICA_DISTRIBUTION)
HARD = (G.RACK_AWARE,)
#: a round cap some phases of the skewed lanes reach
CAP = 6
FIELDS = ("replica_broker", "partition_leader", "replica_disk")


def _jax_lane(seed, dead=()):
    jstate, _ = JS.generate(JS.SyntheticSpec(**dict(SMALL20, seed=seed)))
    if dead:
        alive = np.asarray(jstate.broker_alive).copy()
        alive[list(dead)] = False
        jstate = jstate.replace(broker_alive=jnp.asarray(alive))
    return jstate


def _port_opt(**kw):
    kw = {"goal_ids": GOALS, "hard_ids": HARD, "max_rounds_per_phase": CAP, **kw}
    return O.GoalOptimizer(enable_heavy_goals=False, bucket_brokers=False, device="cpu", **kw)


def _jax_opt(**kw):
    kw = {"goal_ids": GOALS, "hard_ids": HARD, "max_rounds_per_phase": CAP, **kw}
    return JGoalOptimizer(enable_heavy_goals=False, bucket_brokers=False, **kw)


@pytest.fixture(scope="module")
def lanes():
    """(JAX lanes, JAX context, port lanes, port context): seed 0 solved by
    the port (a balanced lane: it applies nothing, one pass a goal); seed 0
    after the rack goal and one pass of ReplicaDistributionGoal's phases (its
    cycle takes two passes); seed 3 (three passes, its first phase stops at
    the cap); seed 11 with broker 2 dead (offline replicas for the
    pre-phases)."""
    raw = [_jax_lane(0), _jax_lane(0), _jax_lane(3), _jax_lane(11, dead=(2,))]
    jctx = JGoalContext.build(raw[0].num_topics, raw[0].num_brokers)
    pctx = port_ctx(jctx)
    solved, res = _port_opt().optimize(port_state(raw[0]), pctx)
    assert res.total_moves > 0
    gid, prior = G.REPLICA_DISTRIBUTION, (G.RACK_AWARE,)
    one_pass, _ = _port_opt(goal_ids=prior).optimize(port_state(raw[1]), pctx)
    for fn in GOAL_ROUNDS[gid]:
        one_pass, _, _ = O._phase_loop(
            one_pass, pctx, round_fn=fn, max_rounds=CAP, enable_heavy=False, prior_ids=prior,
            admit_ids=prior + (gid,), needs=O._goal_needs(gid, prior), syncs=O.HostSyncs(),
        )
    for i, placed in ((0, solved), (1, one_pass)):
        raw[i] = raw[i].replace(**{f: jnp.asarray(to_np(getattr(placed, f))) for f in FIELDS})
    return raw, jctx, [port_state(s) for s in raw], pctx


def _reports(result):
    return [(r.name, r.rounds, r.moves_applied, r.violations_before, r.violations_after)
            for r in result.goal_reports]


def _assert_lane(pfinal, i, want, jlane=None):
    for f in FIELDS:
        got = to_np(getattr(pfinal, f))[i]
        ref = to_np(getattr(want, f)) if isinstance(getattr(want, f), torch.Tensor) else np.asarray(getattr(want, f))
        np.testing.assert_array_equal(got, ref if jlane is None else ref[jlane], f"lane {i}: {f}")


# -- per module: the lane form against each lane alone -------------------------------------


def test_scatters_and_scan_over_lanes_stay_in_their_lane():
    """``scatter_set`` / ``scatter_last`` / ``segment_max`` / ``segment_min``
    / ``cumsum`` lifted over three lanes of five rows: each lane equals its
    own call, bitwise.  A ``-1`` wraps to its own lane's last row and an
    index past the lane's end (5, 7, or -6 before the wrap) is dropped in its
    lane -- never written into the next lane's rows -- and the lane-offset
    ids of one segment call drop them the same way."""
    torch.manual_seed(0)
    target = torch.arange(15, dtype=torch.int32).view(3, 5)
    idx = torch.tensor([[-1, 5, 0], [7, -6, 4], [-1, 0, 5]])
    vals = torch.tensor([[100, 101, 102], [103, 104, 105], [106, 107, 108]], dtype=torch.int32)
    dup = torch.tensor([[1, 1, 3], [4, 4, 4], [0, 2, 0]])
    floats = torch.randn(3, 40)
    seg = torch.randint(-1, 6, (3, 40))
    lifted = [
        vmap(scatter_set)(target, idx, vals), vmap(scatter_last)(target, dup, vals),
        vmap(lambda d, s: segment_max(d, s, 5))(floats, seg), vmap(lambda d, s: segment_min(d, s, 5))(floats, seg),
        vmap(cumsum)(floats),
    ]
    for i in range(3):
        alone = [
            scatter_set(target[i], idx[i], vals[i]), scatter_last(target[i], dup[i], vals[i]),
            segment_max(floats[i], seg[i], 5), segment_min(floats[i], seg[i], 5), cumsum(floats[i]),
        ]
        for got, want in zip(lifted, alone):
            assert torch.equal(got[i], want)
    # lane 1 wrote only its own row 4 (index 7 and -6 dropped); lane 0 its rows 4 and 0
    assert lifted[0][1].tolist() == [5, 6, 7, 8, 105]
    assert lifted[0][0].tolist() == [102, 1, 2, 3, 100]
    ids = lane_ids(torch.tensor([[-1, 5, 4], [0, 7, -3]]), 5)
    assert ids.tolist() == [-1, -1, 4, 5, -1, -1]
    # a lifted segment-sum call is one call over lane-offset ids
    counts = vmap(lambda m, s: segment_sums([m], s, 5)[0])(seg >= 2, seg)
    for i in range(3):
        assert torch.equal(counts[i], segment_sums([seg[i] >= 2], seg[i], 5)[0])


def test_relocations_and_swaps_over_lanes(lanes):
    _, _, plist, _ = lanes
    stack = PA.stack_arrays(plist)
    R = stack.num_replicas
    a = torch.tensor([[0, 5, -1], [R - 1, 3, 2], [-1, -1, 7], [4, R, 9]], dtype=torch.int32)
    b = torch.tensor([[1, -1, 6], [0, 2, 8], [5, 6, 7], [3, 2, R + 3]], dtype=torch.int32)
    dst = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 1, 2]], dtype=torch.int32)

    def both(state, _, a, b, dst):
        # a relocation drops an index past the end; a swap takes -1 only, as the solver passes it
        moved = PA.relocate_replicas(state, a, dst)
        swapped = PA.swap_replicas(state, torch.where(a < R, a, -1), torch.where(b < R, b, -1))
        led = PA.relocate_leadership(state, torch.where(a < stack.num_partitions, a, -1), b)
        return moved.replica_broker, moved.replica_disk, swapped.replica_broker, led.partition_leader

    out = lift(both, stack, None, a, b, dst)
    for i, state in enumerate(plist):
        want = both(state, None, a[i], b[i], dst[i])
        for got, w in zip(out, want):
            assert torch.equal(got[i], w)


@pytest.fixture(scope="module")
def family_stacks():
    """The lanes of the per-family rounds: ``plain`` SMALL20 at seeds 0, 3
    and 11 (broker 2 dead) with NW_OUT at 0.2 (leadership must shed);
    ``jbod`` the same seeds with two logdirs a broker; ``relieve`` each
    seed's state where ReplicaDistributionGoal's relieve phase swaps: its
    prior goals solved, then its shed and fill phases run."""
    def lane(seed, **kw):
        state, _ = JS.generate(JS.SyntheticSpec(**dict(SMALL20, seed=seed, mean_nw_out=0.2, **kw)))
        state = port_state(state)
        if seed == 11:
            state = state.replace(broker_alive=state.broker_alive.clone().index_fill_(0, torch.tensor([2]), False))
        return state

    plain = [lane(s) for s in (0, 3, 11)]
    ctx = GoalContext.build(plain[0].num_topics, plain[0].num_brokers, device="cpu")
    gid = G.REPLICA_DISTRIBUTION
    prior = (G.RACK_AWARE, G.DISK_CAPACITY)
    relieve = []
    for seed in (1, 2, 3):
        state, _ = JS.generate(JS.SyntheticSpec(**dict(SMALL20, seed=seed)))
        state, _ = _port_opt(goal_ids=prior, max_rounds_per_phase=2000).optimize(port_state(state), ctx)
        for fn in GOAL_ROUNDS[gid][:2]:
            state, _, _ = O._phase_loop(
                state, ctx, round_fn=fn, max_rounds=2000, enable_heavy=True, prior_ids=prior,
                admit_ids=prior + (gid,), needs=O._goal_needs(gid, prior), syncs=O.HostSyncs(),
            )
        relieve.append(state)
    return dict(plain=plain, jbod=[lane(s, disks_per_broker=2) for s in (0, 3, 11)], relieve=relieve), ctx


#: a round of each proposer family: (name, goal, phase, lanes); the names of
#: rounds that admit nothing from their lanes' state (their proposals and
#: acceptance are still held bitwise)
FAMILIES = [
    ("shed", G.DISK_CAPACITY, 0, "plain"),
    ("capacity_swap", G.DISK_CAPACITY, 1, "plain"),
    ("fill", G.REPLICA_DISTRIBUTION, 1, "plain"),
    ("relieve_swap", G.REPLICA_DISTRIBUTION, 2, "relieve"),
    ("leadership_shed", G.NW_OUT_CAPACITY, 0, "plain"),
    ("leadership_fill", G.LEADER_REPLICA_DIST, 1, "plain"),
    ("topic", G.TOPIC_REPLICA_DIST, 0, "plain"),
    ("preferred_leader", G.PREFERRED_LEADER_ELECTION, 0, "plain"),
    ("rack_dist_counts", G.RACK_AWARE_DISTRIBUTION, 0, "plain"),
    ("intra_disk", G.INTRA_DISK_USAGE_DIST, 0, "jbod"),
    ("offline", None, 0, "plain"),
]
ADMIT_NOTHING = ("capacity_swap", "leadership_fill", "preferred_leader")


@pytest.mark.parametrize("name,gid,phase,kind", FAMILIES, ids=[c[0] for c in FAMILIES])
def test_round_of_each_family_over_lanes(family_stacks, name, gid, phase, kind):
    """Proposal (the ``MoveBatch``), every prior goal's acceptance
    (``accept_all``), admission and the apply, lifted over three lanes with
    each lane's round number as its salt, against each lane alone."""
    stacks, pctx = family_stacks
    plist = stacks[kind]
    if gid is None:
        fn, prior, admit_ids, needs = offline_round, (), tuple(HARD), frozenset()
    elif kind == "relieve":
        fn, prior = GOAL_ROUNDS[gid][phase], (G.RACK_AWARE, G.DISK_CAPACITY)
        admit_ids, needs = prior + (gid,), O._goal_needs(gid, prior)
    else:
        fn, prior = GOAL_ROUNDS[gid][phase], tuple(g for g in G.DEFAULT_GOAL_ORDER if g < gid)
        admit_ids, needs = prior + (gid,), O._goal_needs(gid, prior)
    pm, am = O._np_mask(prior), O._np_mask(admit_ids)
    stack = PA.stack_arrays(plist)
    salts = torch.arange(len(plist), dtype=torch.int32) + 3

    def one(state, snap, it):
        moves = fn(state, pctx, snap, pm, it)
        eff = move_effects(state, moves, snap)
        ok = moves.valid & accept_all(state, pctx, snap, moves, eff, pm)
        keep = admit(state, pctx, snap, moves, ok, eff, am)
        new = apply_moves(state, moves, keep)
        return (moves.replica, moves.dst_broker, moves.dst_replica, moves.score, ok, keep,
                new.replica_broker, new.partition_leader, new.replica_disk)

    out = lift(one, stack, take_snapshot(stack, pctx, True, needs), salts)
    moved = 0
    for i, state in enumerate(plist):
        want = one(state, take_snapshot(state, pctx, True, needs), salts[i])
        for k, (got, w) in enumerate(zip(out, want)):
            assert torch.equal(got[i], w), (name, i, k)
        moved += int(want[5].sum())
    assert (moved == 0) == (name in ADMIT_NOTHING), (name, moved)


def test_even_assign_plain_over_lanes():
    gen = torch.Generator().manual_seed(1)
    S, P, B, RF = 3, 60, 12, 3
    counts = torch.randint(0, 3, (S, B), generator=gen, dtype=torch.int32)
    rf = torch.randint(1, RF + 1, (S, P), generator=gen, dtype=torch.int32)
    excl = torch.rand((S, P), generator=gen) < 0.1
    rack = torch.randint(0, 4, (S, B), generator=gen, dtype=torch.int32)
    el = torch.rand((S, B), generator=gen) < 0.9
    c, ch = counts.clone(), torch.full((S, P, RF), -1, dtype=torch.int32)
    for p in range(RF):
        ASG.even_assign(c, ch, p, rf, excl, rack, el)
    for i in range(S):
        ci, chi = counts[i].clone(), torch.full((P, RF), -1, dtype=torch.int32)
        for p in range(RF):
            ASG.even_assign(ci, chi, p, rf[i], excl[i], rack[i], el[i])
        assert torch.equal(c[i], ci) and torch.equal(ch[i], chi)


# -- one phase against the JAX vmap ------------------------------------------------------------


def test_one_phase_equals_jax_vmap(lanes):
    raw, jctx, plist, pctx = lanes
    gid, prior = G.REPLICA_DISTRIBUTION, (G.RACK_AWARE, G.DISK_CAPACITY)
    jfinal, jit, jtotal = JO._phase_b(
        j_stack(raw), jctx, round_fn=JGOAL_ROUNDS[gid][0], max_rounds=CAP, enable_heavy=False,
        prior_ids=prior, admit_ids=prior + (gid,), spmd=None, needs=None,
    )
    jax.clear_caches()
    every = torch.ones(len(plist), dtype=torch.bool)
    carry, _ = O._lane_phase(
        PA.stack_arrays(plist), pctx, round_fn=GOAL_ROUNDS[gid][0], max_rounds=CAP, enable_heavy=False,
        prior_mask=O._np_mask(prior), admit_mask=O._np_mask(prior + (gid,)), needs=O._goal_needs(gid, prior),
        syncs=O.HostSyncs(), live=every, pass_moves=torch.zeros(len(plist), dtype=torch.int32),
    )
    assert carry.it.tolist() == np.asarray(jit).tolist()
    assert carry.total.tolist() == np.asarray(jtotal).tolist()
    assert max(carry.it.tolist()) == CAP and carry.total[0] == 0
    for i in range(len(plist)):
        _assert_lane(carry.state, i, jfinal, jlane=i)


# -- the whole solves ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_batched(lanes):
    """The JAX batched solve and batched incremental solve of the lanes, run
    once (the second reuses the first's compiled goal steps)."""
    raw, jctx, _, _ = lanes
    opt = _jax_opt()
    out = opt.batched_optimize(j_stack(raw), jctx), opt.batched_incremental_optimize(j_stack(raw), jctx, max_rounds=CAP)
    jax.clear_caches()
    return out


def test_batched_optimize_equals_each_lane_and_the_jax_batched_solve(lanes, jax_batched, monkeypatch):
    """Every lane of one stack solve equals its own solve and the JAX batched
    solve's lane, though the lanes end at different rounds: the balanced lane
    moves nothing, ReplicaDistributionGoal's pass cycle runs more passes on
    one lane than on another, and a phase stops at the round cap."""
    raw, jctx, plist, pctx = lanes
    (jfinal, jres), _ = jax_batched
    pfinal, pres = _port_opt().batched_optimize(PA.stack_arrays(plist), pctx)
    assert pres.results[0].total_moves == 0 and all(r.total_moves > 0 for r in pres.results[1:])
    phases, host_loop = [], O._phase_loop

    def counted(*a, **k):
        out = host_loop(*a, **k)
        phases.append((k["round_fn"], out[1]))
        return out

    monkeypatch.setattr(O, "_phase_loop", counted)
    passes = []
    for i, state in enumerate(plist):
        phases.clear()
        single, sres = _port_opt()._optimize_core(state, pctx)
        rd = [n for fn, n in phases if fn in GOAL_ROUNDS[G.REPLICA_DISTRIBUTION]]
        passes.append(len(rd) // len(GOAL_ROUNDS[G.REPLICA_DISTRIBUTION]))
        if i == 2:
            assert rd[0] == CAP
        _assert_lane(pfinal, i, single)
        _assert_lane(pfinal, i, jfinal, jlane=i)
        assert _reports(pres.results[i]) == _reports(sres) == _reports(jres.results[i])
        assert pres.results[i].violations_after == sres.violations_after == jres.results[i].violations_after
        assert pres.results[i].movement == sres.movement
    assert passes[:3] == [1, 2, 3], passes


def test_batched_incremental_equals_each_lane_and_the_jax_batched_solve(lanes, jax_batched):
    raw, jctx, plist, pctx = lanes
    _, (jfinal, jres) = jax_batched
    opt = _port_opt()
    pfinal, pres = opt.batched_incremental_optimize(PA.stack_arrays(plist), pctx, max_rounds=CAP)
    assert pres.goals_run == jres.goals_run and pres.results[0].goals_run == []
    for i, state in enumerate(plist):
        _assert_lane(pfinal, i, jfinal, jlane=i)
        got, want = pres.results[i], jres.results[i]
        assert (got.total_moves, got.total_rounds) == (want.total_moves, want.total_rounds)
        np.testing.assert_array_equal(got.violations_after, np.asarray(want.violations_after))
    # a lane alone, walking the union's goals as the batch does
    single, _ = opt.incremental_optimize(plist[2], pctx, max_rounds=CAP)
    _assert_lane(pfinal, 2, single)


def test_kafka_assigner_lanes_with_a_lower_replication_factor():
    """The batch runs its largest replication factor of position passes,
    each one call for the stack; the RF-2 lane places nothing at position 2
    and equals its own solve."""
    rf3, _ = JS.generate(JS.SyntheticSpec(**dict(SMALL20, seed=5)))
    rp, leader = np.asarray(rf3.replica_partition), np.asarray(rf3.partition_leader)
    valid = np.asarray(rf3.replica_valid).copy()
    for p in range(rf3.num_partitions):
        valid[[r for r in np.flatnonzero(rp == p) if r != leader[p]][-1]] = False
    plist = [port_state(rf3), port_state(rf3.replace(replica_valid=jnp.asarray(valid)))]
    pctx = port_ctx(JGoalContext.build(rf3.num_topics, rf3.num_brokers))
    goals = (G.KAFKA_ASSIGNER_RACK, G.KAFKA_ASSIGNER_DISK)
    opt = _port_opt(goal_ids=goals, hard_ids=(G.KAFKA_ASSIGNER_RACK,), max_rounds_per_phase=2000)
    ASG.reset_launch_counts()
    pfinal, pres = opt.batched_optimize(PA.stack_arrays(plist), pctx)
    for i, state in enumerate(plist):
        single, sres = opt._optimize_core(state, pctx)
        _assert_lane(pfinal, i, single)
        assert _reports(pres.results[i]) == _reports(sres)
    assert pres.results[1].violations_after["KafkaAssignerEvenRackAwareGoal"] == 0


# -- host syncs, the int32 limit, no quiet walk over the lanes ----------------------------------


def test_host_driver_reads_once_a_round_for_the_stack(lanes):
    """A one-phase goal over the stack: one host read a round of its
    longest-running lane, where solving the lanes one after another reads
    once a round of every lane."""
    _, _, plist, pctx = lanes
    gid = G.RACK_AWARE
    syncs = O.HostSyncs()
    _, rounds, _, _, _ = O._goal_step_fn(
        PA.stack_arrays(plist), pctx, gid=gid, round_fns=GOAL_ROUNDS[gid], max_rounds=2000,
        enable_heavy=False, prior_ids=(), admit_ids=(gid,), syncs=syncs,
    )
    rounds = rounds.tolist()
    assert syncs.count == max(rounds) < sum(rounds)
    walked = 0
    for state in plist:
        one = O.HostSyncs()
        O._goal_step_fn(state, pctx, gid=gid, round_fns=GOAL_ROUNDS[gid], max_rounds=2000,
                        enable_heavy=False, prior_ids=(), admit_ids=(gid,), syncs=one)
        walked += one.count
    assert walked == sum(rounds)


def test_a_round_wider_than_int32_raises_before_anything_is_allocated():
    """4,096 brokers, every one a round's source (``max_active_brokers`` 4,096,
    top-k 8): a round's occupancy grid is 32,769 x 4,097 cells a lane, wider
    than the snapshot's widest call, so 15 lanes fit and 16 raise -- naming the
    15 -- where the snapshot alone would take 16 (expanded views: nothing
    allocated)."""
    shape = dict(replicas=3_000, partitions=1_000, brokers=4_096, topics=20, disks=0, racks=10)
    ctx = GoalContext.build(20, 4_096, max_active_brokers=4_096, device="cpu")
    span = PC.round_span(_expanded_stack(1, **shape), ctx, False)
    assert span == 32_769 * 4_097 > PC.lane_span(_expanded_stack(1, **shape), False)
    fits = (2**31 - 1) // span
    assert fits == 15
    PC.check_lane_span(16, PC.lane_span(_expanded_stack(1, **shape), False))
    opt = O.GoalOptimizer(goal_ids=GOALS, enable_heavy_goals=False, bucket_brokers=False, device="cpu")
    with pytest.raises(ValueError, match=r"16 lanes x .* evaluate at most 15 lanes"):
        opt.batched_optimize(_expanded_stack(16, **shape), ctx)
    with pytest.raises(ValueError, match="int32 indexing"):
        opt.batched_incremental_optimize(_expanded_stack(16, **shape), ctx, max_rounds=4)


def test_an_operator_without_a_batching_rule_raises_instead_of_walking_the_lanes(lanes):
    _, _, plist, _ = lanes

    def unbatchable(state, _):
        out = state.replica_broker.clone()
        out.scatter_(0, torch.zeros(1, dtype=torch.int64), 7)   # no batching rule for scatter_.value
        return out

    functorch = torch._C._functorch
    was = functorch._is_vmap_fallback_enabled()
    stack = PA.stack_arrays(plist)
    with pytest.raises(RuntimeError, match="vmap fallback"):
        lift(unbatchable, stack, None)
    assert functorch._is_vmap_fallback_enabled() == was      # the process's setting is back
    lift(lambda state, _: state.replica_broker + 1, stack, None)
    assert functorch._is_vmap_fallback_enabled() == was


def _round_cases():
    cases = [(g, k) for g in sorted(GOAL_ROUNDS) for k in range(len(GOAL_ROUNDS[g]))]
    return cases + [("offline", 0)]


@pytest.mark.parametrize("gid,phase", _round_cases())
def test_lane_round_has_no_host_read(family_stacks, monkeypatch, gid, phase):
    """Every round type's lane form with every host read patched to raise and
    every operation that waits on the device or copies host data refused, as
    ``test_torch_device_loop`` holds the one-state round: the card captures
    the lane round into the goal graph."""
    stacks, ctx = family_stacks
    jbod = gid in (G.INTRA_DISK_CAPACITY, G.INTRA_DISK_USAGE_DIST)
    stack = PA.stack_arrays(stacks["jbod" if jbod else "plain"])
    if gid == "offline":
        fn, prior, admit_ids, needs = offline_round, (), (), frozenset()
    else:
        fn, prior = GOAL_ROUNDS[gid][phase], tuple(g for g in G.DEFAULT_GOAL_ORDER if g < gid)
        admit_ids, needs = prior + (gid,), O._goal_needs(gid, prior)
    carry = O.phase_carry(stack, live=torch.tensor([True, False, True]))

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"Tensor.{name} inside a round")
        return read

    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    with _RefuseHostWork():
        out = O.phase_body(
            carry, ctx, round_fn=fn, enable_heavy=True, prior_mask=O._np_mask(prior),
            admit_mask=O._np_mask(admit_ids), needs=needs,
        )
        O.phase_cond(out, 2000)
    monkeypatch.undo()
    assert out.it.tolist() == [1, 0, 1]
    for f in FIELDS:      # the lane that is not live is frozen
        assert torch.equal(getattr(out.state, f)[1], getattr(stack, f)[1])
