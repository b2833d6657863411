"""The port's sharded solver (``cruise_control_tpu_torch/parallel/``) against
the JAX package's ``parallel`` on the CPU.

The port's ranks are processes (gloo on the CPU) started by its own
launcher, ``parallel.launch.run_ranks``; the JAX side runs on the 8 virtual
CPU devices ``tests/conftest.py`` forces.  Rank functions live in
``tests/torch_parallel_tasks.py`` (no JAX there: each rank imports torch and
the port only).  Spawned ranks are expensive, so the fast tier starts two
sets of 4 ranks (the primitives with the swap apply and the collective
count; the solver cases) and one of 2 (a failing rank); the 8-rank runs are
``slow``.

Tolerances: exact (``assert_array_equal`` / ``==``) everywhere except the
float sums held against JAX's ``psum`` of 8 partials, which adds in another
order than the port's fold or ``all_reduce`` (``rtol=1e-5``, the JAX test's
own, and ``rtol=1e-6`` for the merges).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import GoalContext as JGoalContext
from cruise_control_tpu.analyzer import GoalOptimizer as JGoalOptimizer
from cruise_control_tpu.model import arrays as JA
from cruise_control_tpu.parallel import ShardedGoalOptimizer as JSharded
from cruise_control_tpu.parallel import pad_replicas as jpad_replicas
from cruise_control_tpu.parallel import solver_mesh as jsolver_mesh
from cruise_control_tpu.parallel.mesh import REPLICA_AXIS
from cruise_control_tpu.parallel.sharded import (
    sharded_gather,
    sharded_scatter_set,
    sharded_segment_argmax,
    sharded_segment_sum,
)
from cruise_control_tpu.parallel.spmd import SpmdInfo as JSpmdInfo
from cruise_control_tpu.parallel.spmd import merge_mins as jmerge_mins
from cruise_control_tpu.parallel.spmd import merge_sums as jmerge_sums
from cruise_control_tpu_torch.analyzer.context import segment_argmax as psegment_argmax
from cruise_control_tpu_torch.analyzer.proposers import topk_segment_argmax as ptopk
from cruise_control_tpu_torch.model import arrays as PA
from cruise_control_tpu_torch.ops.segments import segment_sum_plain
from cruise_control_tpu_torch.parallel import Mesh, pad_replicas, run_ranks
from cruise_control_tpu_torch.parallel.mesh import REPLICA_FIELDS
from cruise_control_tpu_torch.parallel.solver import ShardedGoalOptimizer
from tests import torch_parallel_tasks as T
from tests.torch_port_helpers import port_state
from tests.torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse: one thread)

try:  # jax >= 0.4.35 exports shard_map from jax.experimental; newer jax from jax
    from jax.experimental.shard_map import shard_map
except ImportError:  # pragma: no cover
    from jax import shard_map
from jax.sharding import PartitionSpec as P

RANKS = 4
N_DEV = 8
R, B = 512, 16
SWAP_SPEC = dict(num_racks=2, num_brokers=8, num_topics=2, num_partitions=32, replication_factor=2,
                 distribution="uniform", skew_brokers=0, seed=41)


@pytest.fixture(scope="module")
def jmesh():
    return jsolver_mesh(jax.devices()[:N_DEV])


def _data(seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=R).astype(np.float32)
    return dict(
        segments=B,
        vals=vals,
        vals2=rng.normal(size=(R, 4)).astype(np.float32),
        seg=rng.integers(0, B, size=R, dtype=np.int32),
        elig=rng.random(R) < 0.7,
        # score ties exercise the lowest-global-index rule
        tied=(np.round(vals * 4) / 4).astype(np.float32),
        ids=np.array([0, 5, 511, 128, -1, 64, 63, 65, 200, 383], np.int32),
        set_ids=np.array([3, 200, 511, -1, 64], np.int32),
        set_vals=np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32),
        swap_spec=SWAP_SPEC,
        swap_ids=(3, 62),
    )


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def prims(data):
    """Every rank's results of the primitives task (4 gloo ranks)."""
    return run_ranks(T.primitives, RANKS, device="cpu", args=(data,), timeout_s=300)


def _same_on_every_rank(prims, key):
    first = prims[0][key]
    for other in prims[1:]:
        np.testing.assert_array_equal(other[key], first)
    return first


# -- the primitives ------------------------------------------------------------------


@pytest.mark.parametrize("key,column", [("sum_1d", "vals"), ("sum_2d", "vals2")])
def test_sharded_segment_sum_matches_jax(prims, data, jmesh, key, column):
    """Float values fold over the ranks: the port's single-device row-order
    sum bit for bit, and JAX's sum of 8 partials to ``rtol=1e-5``."""
    got = _same_on_every_rank(prims, key)
    want = sharded_segment_sum(jmesh, jnp.asarray(data[column]), jnp.asarray(data["seg"]), B)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    row_order = segment_sum_plain(torch.from_numpy(data[column]), torch.from_numpy(data["seg"]), B)
    np.testing.assert_array_equal(got, row_order.numpy())


def test_sharded_segment_sum_counts_exact(prims, data, jmesh):
    got = _same_on_every_rank(prims, "sum_int")
    want = sharded_segment_sum(jmesh, jnp.asarray(data["elig"].astype(np.int32)), jnp.asarray(data["seg"]), B)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sharded_segment_argmax_matches_jax_including_ties(prims, data, jmesh):
    got = _same_on_every_rank(prims, "argmax")
    args = (jnp.asarray(data["tied"]), jnp.asarray(data["seg"]), B, jnp.asarray(data["elig"]))
    np.testing.assert_array_equal(got, np.asarray(sharded_segment_argmax(jmesh, *args)))
    single = psegment_argmax(*(torch.from_numpy(np.array(a)) if not isinstance(a, int) else a for a in args))
    np.testing.assert_array_equal(got, single.numpy())


def test_sharded_gather_matches_jax(prims, data, jmesh):
    got = _same_on_every_rank(prims, "gather")
    want = sharded_gather(jmesh, jnp.asarray(data["vals"]), jnp.asarray(data["ids"]))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sharded_scatter_set_matches_jax(prims, data, jmesh):
    got = _same_on_every_rank(prims, "scatter")
    want = sharded_scatter_set(
        jmesh, jnp.asarray(data["vals"]), jnp.asarray(data["set_ids"]), jnp.asarray(data["set_vals"])
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def test_merge_sums_and_merge_mins_match_jax(prims, data, jmesh):
    """Each shard's partial is its block's segment sums / mins; the merges
    over 4 ranks and over JAX's 8 devices give the same totals (counts and
    mins exact, float sums to ``rtol=1e-6``)."""
    spmd = JSpmdInfo(axis=REPLICA_AXIS, n=N_DEV, global_R=R)

    def kernel(v, s, e):
        part_f = jax.ops.segment_sum(v, s, num_segments=B)
        part_i = jax.ops.segment_sum(e.astype(jnp.int32), s, num_segments=B)
        part_m = jax.ops.segment_min(spmd.iota(), s, num_segments=B)
        sums = jmerge_sums(spmd, {"f": part_f, "i": part_i, "b": part_i > 0})
        return sums["f"], sums["i"], sums["b"], jmerge_mins(spmd, {"m": part_m})["m"]

    f, i, b, m = shard_map(
        kernel, mesh=jmesh, in_specs=(P(REPLICA_AXIS),) * 3, out_specs=(P(),) * 4, check_rep=False,
    )(jnp.asarray(data["vals"]), jnp.asarray(data["seg"]), jnp.asarray(data["elig"]))
    np.testing.assert_allclose(_same_on_every_rank(prims, "merge_f"), np.asarray(f), rtol=1e-6)
    np.testing.assert_array_equal(_same_on_every_rank(prims, "merge_i"), np.asarray(i))
    np.testing.assert_array_equal(_same_on_every_rank(prims, "merge_b"), np.asarray(b))
    np.testing.assert_array_equal(_same_on_every_rank(prims, "merge_min"), np.asarray(m))


def test_chained_sums_equal_the_row_order_sum_bitwise(prims, data):
    """The snapshot's float sums fold over the ranks in rank order, so they
    equal the single-device row-order sum bit for bit -- which a sum of the
    ranks' partials does not (this data shows a difference)."""
    seg = torch.from_numpy(data["seg"])
    want_f = segment_sum_plain(torch.from_numpy(data["vals2"]), seg, B).numpy()
    want_i = segment_sum_plain(torch.from_numpy(data["elig"].astype(np.int32)), seg, B).numpy()
    np.testing.assert_array_equal(_same_on_every_rank(prims, "chained_f"), want_f)
    np.testing.assert_array_equal(_same_on_every_rank(prims, "chained_i"), want_i)
    np.testing.assert_array_equal(_same_on_every_rank(prims, "chained_part_i"), want_i)
    partials = _same_on_every_rank(prims, "ordered_partials_f")
    assert (partials != want_f).any()
    np.testing.assert_allclose(partials, want_f, rtol=1e-5)


def test_topk_rows_merge_matches_the_single_device_walk(prims):
    state, _, _ = T.case(T.ACCOUNTING)
    padded = pad_replicas(state, RANKS)
    score = torch.from_numpy(prims[0]["topk_score"])
    elig = torch.from_numpy(prims[0]["topk_elig"])
    want = ptopk(score, padded.replica_broker, state.num_brokers, elig, 4)
    ids = _same_on_every_rank(prims, "topk_ids")
    np.testing.assert_array_equal(ids, want.numpy())
    flat = ids.reshape(-1)
    hit = flat >= 0
    safe = np.where(hit, flat, 0)
    eff = PA.effective_load(padded).numpy()
    np.testing.assert_array_equal(_same_on_every_rank(prims, "topk_partition")[hit],
                                  padded.replica_partition.numpy()[safe][hit])
    np.testing.assert_array_equal(_same_on_every_rank(prims, "topk_broker")[hit],
                                  padded.replica_broker.numpy()[safe][hit])
    np.testing.assert_array_equal(_same_on_every_rank(prims, "topk_eff")[hit], eff[safe][hit])
    np.testing.assert_array_equal(_same_on_every_rank(prims, "gathered_state_broker"),
                                  padded.replica_broker.numpy())


def test_cross_shard_swap_matches_single_device(prims):
    """A kept swap whose endpoints sit on the first and the last rank: on
    every rank above the owner of ``a`` its local index is negative, which
    wraps in a scatter unless the apply sends it out of range.  The sharded
    apply equals the single-device ``swap_replicas`` of both packages."""
    a, b = 3, 62
    state, _, _ = T.case(SWAP_SPEC)
    assert state.num_replicas % RANKS == 0 and b // (state.num_replicas // RANKS) == RANKS - 1
    idx = lambda v: torch.tensor([v], dtype=torch.int32)
    want = PA.swap_replicas(state, idx(a), idx(b))
    jstate, _ = JS.generate(JS.SyntheticSpec(**SWAP_SPEC))
    jwant = JA.swap_replicas(jstate, jnp.asarray([a], jnp.int32), jnp.asarray([b], jnp.int32))
    for rank_out in prims:
        brokers, disks = rank_out["swap"]
        np.testing.assert_array_equal(brokers, want.replica_broker.numpy())
        np.testing.assert_array_equal(disks, want.replica_disk.numpy())
        np.testing.assert_array_equal(brokers, np.asarray(jwant.replica_broker))


#: JAX's design budget for the lowered RackAwareGoal step (tests/test_parallel.py:315)
MAX_COLLECTIVES = 9


def test_rack_goal_step_collectives_pinned(prims):
    """One RackAwareGoal step on the JAX accounting cluster (already rack
    safe: one round, no move): the before and after snapshots and the
    round's snapshot cost one min merge (an all_reduce) and one fold each,
    and the round's proposer one all_gather each for the candidate top-k and
    the destination column merge and one all_reduce sum for the partition
    occupancy -- 9, JAX's design budget (JAX counts its lowered program's
    ops, the loop body once)."""
    counts, rounds, moves, before, after = prims[0]["rack_step"]
    assert all(p["rack_step"] == prims[0]["rack_step"] for p in prims)
    assert (rounds, moves, before, after) == (1, 0, 0.0, 0.0)
    assert counts == {"all_gather": 2, "all_reduce": 4, "fold": 3}
    assert sum(counts.values()) == MAX_COLLECTIVES


# -- padding and the launcher ------------------------------------------------------


def test_padding_preserves_semantics():
    jstate, _ = JS.generate(JS.SyntheticSpec(**T.UNEVEN))
    state = port_state(jstate)
    padded = pad_replicas(state, 7)
    jpadded = jpad_replicas(jstate, 7)
    assert padded.num_replicas % 7 == 0 and padded.num_replicas == jpadded.num_replicas
    assert int(padded.replica_valid.sum()) == state.num_replicas
    for f in dataclasses.fields(padded):
        got = getattr(padded, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jpadded, f.name)), err_msg=f.name)
    assert REPLICA_FIELDS == {"replica_partition", "replica_broker", "replica_disk", "replica_valid",
                              "base_load", "original_broker"}


def test_run_ranks_raises_when_a_rank_fails():
    """Rank 1 raises while rank 0 waits in a collective: the launcher stops
    the survivor and raises with rank 1's traceback, well inside its limit."""
    import time

    import chip_smoke

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(chip_smoke.failing_rank, 2, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_spmd_switch_and_goal_support_without_ranks(monkeypatch):
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.parallel.solver import UNSUPPORTED_SPMD_GOALS, spmd_supported

    mesh = Mesh(rank=0, world=1, device=torch.device("cpu"), backend="gloo")
    assert ShardedGoalOptimizer(mesh=mesh, enable_heavy_goals=False).use_spmd
    assert not ShardedGoalOptimizer(mesh=mesh, **T.ple_goals()).use_spmd
    monkeypatch.setenv("CC_TPU_SHARDED_SPMD", "0")
    assert not ShardedGoalOptimizer(mesh=mesh, enable_heavy_goals=False).use_spmd
    assert UNSUPPORTED_SPMD_GOALS == {G.PREFERRED_LEADER_ELECTION, G.KAFKA_ASSIGNER_RACK, G.KAFKA_ASSIGNER_DISK}
    assert spmd_supported(G.DEFAULT_GOAL_ORDER)


# -- the solver ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def solver_runs():
    return run_ranks(T.solver_cases, RANKS, device="cpu", timeout_s=600)


def _jax_single(spec, goal_kw):
    jstate, jmaps = JS.generate(JS.SyntheticSpec(**spec))
    jctx = JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    final, res = JGoalOptimizer(**goal_kw).optimize(jstate, jctx, maps=jmaps)
    jax.clear_caches()
    return jstate, final, res


def _assert_same(got, jstate, jfinal, jres):
    np.testing.assert_array_equal(got["replica_broker"], np.asarray(jfinal.replica_broker))
    np.testing.assert_array_equal(got["partition_leader"], np.asarray(jfinal.partition_leader))
    assert got["proposals"] == [(p.tp, tuple(p.old_replicas), tuple(p.new_replicas)) for p in jres.proposals]
    assert got["violations_after"] == jres.violations_after
    assert got["balancedness"] == jres.balancedness_score
    assert got["goals"] == [(r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied)
                            for r in jres.goal_reports]


def test_uneven_replica_count_matches_jax_single_device(solver_runs):
    """1,527 replicas over 4 ranks (padded to 1,528): placements, leaders,
    proposals, violations and balancedness equal the JAX single-device solve
    on every rank."""
    jstate, jfinal, jres = _jax_single(T.UNEVEN, T.uneven_goals())
    assert jstate.num_replicas % RANKS != 0
    for run in solver_runs:
        out = run["uneven"]
        assert out["use_spmd"]
        _assert_same(out["solution"], jstate, jfinal, jres)
        assert out["collectives"]["fold"] > 0 and out["launches"]["segment_sum_f32"] == 0  # CPU: plain path


def test_gather_path_for_preferred_leader_election_matches_single_device(solver_runs):
    """Goal lists with PreferredLeaderElectionGoal take the gather path (one
    all_gather, then the single-device solver on every rank)."""
    jstate, jfinal, jres = _jax_single(T.GATHER, T.ple_goals())
    for run in solver_runs:
        out = run["ple"]
        assert not out["use_spmd"]
        assert out["collectives"] == {"all_gather": 1, "all_reduce": 0, "fold": 0}
        _assert_same(out["solution"], jstate, jfinal, jres)
        assert out["solution"]["total_moves"] == jres.total_moves > 0


def test_spmd_switch_off_takes_the_gather_path(solver_runs):
    for run in solver_runs:
        off = run["switch_off"]
        assert not off["use_spmd"]
        assert off["collectives"] == {"all_gather": 1, "all_reduce": 0, "fold": 0}
        for k, v in run["uneven"]["solution"].items():
            np.testing.assert_array_equal(np.asarray(off["solution"][k], dtype=object),
                                          np.asarray(v, dtype=object), err_msg=k)


def test_config2_partials_added_rank0_first_diverge_where_the_fold_does_not():
    """Config #2 on 4 ranks.  With the snapshot's float sums merged as
    per-rank partials added rank 0 first, the bits of the broker-load sums
    differ from the single-device row-order sums, the move scores with them,
    and from the 216th round of the solve (ReplicaDistributionGoal's relieve
    phase) the score order of the moves into one broker changes, so the
    DiskCapacityGoal budget of the cumulative admission keeps another move:
    the solve diverges (13,728 moves of that goal against 13,718).  The fold
    the solver runs equals the single-device solve exactly."""
    from chip_smoke import CONFIG2

    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    runs = run_ranks(T.config2_fold_and_added_partials, RANKS, device="cpu", timeout_s=600)
    state, ctx, maps = T.case(CONFIG2)
    final, res = GoalOptimizer(enable_heavy_goals=True, device="cpu").optimize(state, ctx, maps=maps)
    single = T.solution(final, res, state.num_replicas)
    for run in runs:
        for k, v in single.items():
            np.testing.assert_array_equal(np.asarray(run["fold"][k], dtype=object),
                                          np.asarray(v, dtype=object), err_msg=k)
        assert run["added"]["goals"] == runs[0]["added"]["goals"]
    added = runs[0]["added"]["goals"]
    first = next(i for i, (a, b) in enumerate(zip(added, single["goals"])) if a != b)
    assert added[:first] == single["goals"][:first]
    assert (added[first][0], added[first][4], single["goals"][first][4]) == ("ReplicaDistributionGoal", 13_728, 13_718)
    assert runs[0]["added"]["total_moves"] != single["total_moves"]


# -- the slow tier: 8 ranks ----------------------------------------------------------


@pytest.mark.slow
def test_mesh8_matches_the_jax_sharded_optimizer(jmesh):
    """The gate's mesh8 workload (32 brokers, 256 partitions, RF 3, seed 5,
    16 goals) on 8 port ranks against JAX's ShardedGoalOptimizer on its 8
    devices and against the port's single-device solve."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    runs = run_ranks(T.mesh8_solve, N_DEV, device="cpu", timeout_s=900)
    jstate, jmaps = JS.generate(JS.SyntheticSpec(**T.MESH8))
    jctx = JGoalContext.build(jstate.num_topics, jstate.num_brokers)
    jfinal, jres = JSharded(mesh=jmesh, enable_heavy_goals=True).optimize(jstate, jctx, maps=jmaps)
    jax.clear_caches()
    jfinal = jfinal.replace(replica_broker=jfinal.replica_broker[: jstate.num_replicas])
    state, ctx, maps = T.case(T.MESH8)
    pfinal, pres = GoalOptimizer(enable_heavy_goals=True, device="cpu").optimize(state, ctx, maps=maps)
    single = T.solution(pfinal, pres, state.num_replicas)
    for run in runs:
        assert run["use_spmd"]
        _assert_same(run["solution"], jstate, jfinal, jres)
        for k, v in single.items():
            np.testing.assert_array_equal(np.asarray(run["solution"][k], dtype=object),
                                          np.asarray(v, dtype=object), err_msg=k)


@pytest.mark.slow
def test_eight_ranks_uneven_matches_jax_single_device():
    runs = run_ranks(partial(T.sharded_solve, spec=T.UNEVEN, goal_kw=T.uneven_goals()), N_DEV,
                     device="cpu", timeout_s=600)
    jstate, jfinal, jres = _jax_single(T.UNEVEN, T.uneven_goals())
    for run in runs:
        _assert_same(run["solution"], jstate, jfinal, jres)
        assert run["collectives"]["fold"] > 0
