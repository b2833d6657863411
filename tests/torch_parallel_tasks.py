"""Rank functions for the port's sharded tests (``tests/test_torch_parallel.py``
and the card tests).

``parallel.launch.run_ranks`` starts each rank as a fresh process and
imports the rank function by name, so the functions live here, in a module
that imports neither JAX nor the JAX package: a rank loads only torch and
the port.  Each returns host values (numpy arrays, numbers) that pickle.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

#: the JAX TestSpmdSolverEquivalence cluster (tests/test_parallel.py:165-172):
#: 509 partitions x RF 3 = 1,527 replicas, not a multiple of 4 or 8
UNEVEN = dict(
    num_racks=4, num_brokers=12, num_topics=6, num_partitions=509, replication_factor=3,
    distribution="exponential", skew_brokers=3, seed=23, mean_disk=0.2, mean_nw_in=0.15,
)
#: the JAX TestCollectiveAccounting cluster (tests/test_parallel.py:321-325)
ACCOUNTING = dict(
    num_racks=4, num_brokers=8, num_topics=4, num_partitions=256, replication_factor=3,
    distribution="exponential", skew_brokers=2, seed=29, mean_disk=0.2, mean_nw_in=0.15,
)
#: the gate's mesh8 tier (cruise_control_tpu/obs/gate.py:142-147)
MESH8 = dict(
    num_racks=4, num_brokers=32, num_topics=8, num_partitions=256, replication_factor=3,
    distribution="exponential", skew_brokers=8, mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15,
    mean_nw_out=0.15, seed=5,
)


def _one_thread() -> None:
    """A rank's solves on one intra-op thread: the ranks of a set and the
    suite's other workers share the CPU, and torch's default of a thread a
    core each oversubscribes it (config #2 on 4 ranks took 808 s in a loaded
    tier-1 run against 229-249 s alone)."""
    torch.set_num_threads(1)

def uneven_goals():
    from cruise_control_tpu_torch.analyzer import goals_base as G

    goals = (G.RACK_AWARE, G.REPLICA_CAPACITY, G.DISK_CAPACITY, G.REPLICA_DISTRIBUTION)
    return dict(goal_ids=goals, hard_ids=tuple(g for g in goals if g in G.HARD_GOALS),
                enable_heavy_goals=False)


#: the JAX gather-path case's cluster (tests/test_parallel.py:205): 128
#: partitions on 8 brokers
GATHER = dict(UNEVEN, num_partitions=128, num_brokers=8)


def ple_goals():
    """A preferred-leader goal list that moves replicas and leaders on
    :data:`GATHER` (the JAX case's RackAware, ReplicaCapacity, Preferred
    leader list moves nothing there)."""
    from cruise_control_tpu_torch.analyzer import goals_base as G

    return dict(goal_ids=(G.RACK_AWARE, G.REPLICA_DISTRIBUTION, G.LEADER_REPLICA_DIST,
                          G.PREFERRED_LEADER_ELECTION),
                hard_ids=(G.RACK_AWARE,), enable_heavy_goals=False)


def case(spec, device="cpu"):
    """(state, ctx, maps) of a synthetic spec on ``device``."""
    from cruise_control_tpu_torch.analyzer import GoalContext
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, maps = generate(SyntheticSpec(**spec), device=device)
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device=device)
    return state, ctx, maps


def solution(final, res, num_replicas: int) -> dict:
    """A solve's outcome as host values: placements (the replica axis trimmed
    to the input's replicas), leaders, proposals as (tp, old, new),
    violations after, balancedness and the per-goal walk."""
    return dict(
        replica_broker=final.replica_broker.cpu().numpy()[:num_replicas],
        partition_leader=final.partition_leader.cpu().numpy(),
        proposals=[(p.tp, tuple(p.old_replicas), tuple(p.new_replicas)) for p in res.proposals],
        violations_after=dict(res.violations_after),
        balancedness=res.balancedness_score,
        residual_hard_violations=res.residual_hard_violations,
        total_moves=res.total_moves,
        goals=[(r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied)
               for r in res.goal_reports],
    )


def sharded_solve(mesh, spec, goal_kw, env=None):
    """One ShardedGoalOptimizer solve on this rank: the solution, whether the
    SPMD path ran, the rank's collectives and segment-sum host calls."""
    _one_thread()
    from cruise_control_tpu_torch.ops import segments as SEG
    from cruise_control_tpu_torch.parallel import ShardedGoalOptimizer
    from cruise_control_tpu_torch.parallel.mesh import COLLECTIVES, reset_collective_counts

    for k, v in (env or {}).items():
        os.environ[k] = v
    state, ctx, maps = case(spec, mesh.device)
    opt = ShardedGoalOptimizer(mesh=mesh, **goal_kw)
    reset_collective_counts()
    SEG.reset_launch_counts()
    t0 = time.monotonic()
    final, res = opt.optimize(state, ctx, maps=maps)
    wall = time.monotonic() - t0
    return dict(
        solution=solution(final, res, state.num_replicas), use_spmd=opt.use_spmd,
        collectives=dict(COLLECTIVES), launches=dict(SEG.LAUNCHES), wall_s=wall,
    )


def solver_cases(mesh):
    """The fast tier's solver runs on one set of ranks: the uneven cluster on
    the SPMD path, the preferred-leader list on the gather path, and the
    uneven cluster again with the CC_TPU_SHARDED_SPMD=0 switch."""
    _one_thread()
    out = dict(
        uneven=sharded_solve(mesh, UNEVEN, uneven_goals()),
        ple=sharded_solve(mesh, GATHER, ple_goals()),
    )
    out["switch_off"] = sharded_solve(mesh, UNEVEN, uneven_goals(), env={"CC_TPU_SHARDED_SPMD": "0"})
    return out


def mesh8_solve(mesh):
    """The gate's mesh8 workload: 16 default goals, heavy goals on."""
    _one_thread()
    return sharded_solve(mesh, MESH8, dict(enable_heavy_goals=True))


def primitives(mesh, data):
    """The explicit primitives and the merges on this rank's block of each
    input of ``data`` (whole arrays, the same on every rank); each result
    whole (replicated results as they are, blocks gathered back)."""
    _one_thread()
    from cruise_control_tpu_torch.ops.index import segment_min
    from cruise_control_tpu_torch.parallel import sharded as SH
    from cruise_control_tpu_torch.parallel.mesh import gather_state
    from cruise_control_tpu_torch.parallel.spmd import (
        SpmdInfo,
        chained_segment_sums,
        merge_mins,
        merge_sums,
        topk_rows_merge,
    )

    n = data["vals"].shape[0] // mesh.world
    lo, hi = mesh.rank * n, (mesh.rank + 1) * n

    def block(x):
        return torch.from_numpy(np.ascontiguousarray(x[lo:hi]))

    def whole(x):
        return torch.from_numpy(np.asarray(x))

    S = data["segments"]
    out = {
        "sum_1d": SH.sharded_segment_sum(mesh, block(data["vals"]), block(data["seg"]), S),
        "sum_2d": SH.sharded_segment_sum(mesh, block(data["vals2"]), block(data["seg"]), S),
        "sum_int": SH.sharded_segment_sum(mesh, block(data["elig"]), block(data["seg"]), S),
        "argmax": SH.sharded_segment_argmax(
            mesh, block(data["tied"]), block(data["seg"]), S, block(data["elig"])
        ),
        "gather": SH.sharded_gather(mesh, block(data["vals"]), whole(data["ids"])),
        "scatter": mesh.all_gather(
            SH.sharded_scatter_set(mesh, block(data["vals"]), whole(data["set_ids"]), whole(data["set_vals"]))
        ).reshape(-1),
    }
    spmd = SpmdInfo(mesh=mesh, n=mesh.world, global_R=n * mesh.world)
    # the merges over per-rank partials: rank r's partial is its block's
    # segment sums / mins
    seg_b = block(data["seg"]).long()
    part_f = torch.zeros(S, dtype=torch.float32).index_add_(0, seg_b, block(data["vals"]))
    part_i = torch.zeros(S, dtype=torch.int32).index_add_(0, seg_b, block(data["elig"]).to(torch.int32))
    part_m = segment_min(torch.arange(lo, hi, dtype=torch.int32), block(data["seg"]), S)
    sums = merge_sums(spmd, {"f": part_f, "i": part_i, "b": part_i > 0})
    out.update(merge_f=sums["f"], merge_i=sums["i"], merge_b=sums["b"],
               merge_min=merge_mins(spmd, {"m": part_m})["m"])
    # the fold: the float sums in global row order
    (chained,), merged = chained_segment_sums(
        spmd, [([block(data["vals2"]), block(data["elig"])], block(data["seg"]), S)], {"i": part_i}
    )
    out["chained_f"], out["chained_i"] = chained
    out["chained_part_i"] = merged["i"]
    # the merge the fold replaced: every rank's partial gathered, then added
    # rank 0 first
    partials = mesh.all_gather(torch.zeros((S, 4), dtype=torch.float32).index_add_(0, seg_b, block(data["vals2"])))
    acc = partials[0]
    for r in range(1, mesh.world):
        acc = acc + partials[r]
    out["ordered_partials_f"] = acc
    # the candidate top-k merge against the single-device walk
    state, ctx, _ = case(ACCOUNTING)
    from cruise_control_tpu_torch.analyzer.context import take_snapshot
    from cruise_control_tpu_torch.parallel.mesh import shard_state

    local = shard_state(state, mesh)
    tspmd = SpmdInfo(mesh=mesh, n=mesh.world, global_R=local.num_replicas * mesh.world)
    snap = take_snapshot(local, ctx, False, frozenset(), tspmd)
    rng = np.random.default_rng(5)
    score = torch.from_numpy(np.round(rng.normal(size=tspmd.global_R) * 4).astype(np.float32) / 4)
    elig = torch.from_numpy(rng.random(tspmd.global_R) < 0.6)
    off = tspmd.offset()
    ids, rows = topk_rows_merge(
        tspmd, local, snap, score[off:off + local.num_replicas], local.replica_broker,
        state.num_brokers, elig[off:off + local.num_replicas], 4,
    )
    out.update(topk_ids=ids, topk_partition=rows.partition, topk_broker=rows.broker,
               topk_eff=rows.eff_load, topk_score=score, topk_elig=elig)
    out["gathered_state_broker"] = gather_state(local, mesh).replica_broker
    out = {k: v.numpy() for k, v in out.items()}
    out["swap"] = swap_apply(mesh, data["swap_spec"], *data["swap_ids"])
    out["rack_step"] = rack_goal_step_collectives(mesh)
    return out


def swap_apply(mesh, spec, a: int, b: int):
    """A kept cross-rank swap of global replicas ``a`` and ``b`` through the
    sharded ``apply_moves``; the whole replica_broker / replica_disk after."""
    _one_thread()
    from cruise_control_tpu_torch.analyzer.moves import KIND_SWAP, MoveBatch, apply_moves
    from cruise_control_tpu_torch.parallel.mesh import gather_state, shard_state
    from cruise_control_tpu_torch.parallel.spmd import ReplicaRows, SpmdInfo

    state, _, _ = case(spec)
    ab = torch.tensor([a, b])
    rows = ReplicaRows(
        partition=state.replica_partition[ab], broker=state.replica_broker[ab],
        disk=state.replica_disk[ab], valid=torch.ones(2, dtype=torch.bool),
        is_leader=torch.zeros(2, dtype=torch.bool), base_load=state.base_load[ab],
        eff_load=state.base_load[ab],
    )
    moves = MoveBatch(
        kind=KIND_SWAP, replica=torch.tensor([a], dtype=torch.int32),
        dst_broker=state.replica_broker[torch.tensor([b])],
        dst_replica=torch.tensor([b], dtype=torch.int32), score=torch.ones(1),
        rows=rows, view_replica=torch.zeros(1, dtype=torch.int32),
        view_dst_replica=torch.ones(1, dtype=torch.int32),
    )
    local = shard_state(state, mesh)
    spmd = SpmdInfo(mesh=mesh, n=mesh.world, global_R=local.num_replicas * mesh.world)
    out = gather_state(apply_moves(local, moves, torch.ones(1, dtype=torch.bool), spmd), mesh)
    return out.replica_broker.numpy(), out.replica_disk.numpy()


def rack_goal_step_collectives(mesh):
    """The collectives of ONE RackAwareGoal goal step on the accounting
    cluster, and the step's rounds."""
    _one_thread()
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.analyzer.goal_rounds import GOAL_ROUNDS
    from cruise_control_tpu_torch.analyzer.optimizer import HostSyncs, _goal_step_fn
    from cruise_control_tpu_torch.parallel.mesh import COLLECTIVES, reset_collective_counts, shard_state
    from cruise_control_tpu_torch.parallel.spmd import SpmdInfo

    state, ctx, _ = case(ACCOUNTING)
    local = shard_state(state, mesh)
    spmd = SpmdInfo(mesh=mesh, n=mesh.world, global_R=local.num_replicas * mesh.world)
    reset_collective_counts()
    _, rounds, moves, before, after = _goal_step_fn(
        local, ctx, gid=G.RACK_AWARE, round_fns=GOAL_ROUNDS[G.RACK_AWARE], max_rounds=2000,
        enable_heavy=False, prior_ids=(), admit_ids=(G.RACK_AWARE,), syncs=HostSyncs(), spmd=spmd,
    )
    return dict(COLLECTIVES), rounds, moves, float(before), float(after)


def sweep_scenarios(factors):
    """One scenario per load factor, then one without broker 0."""
    from cruise_control_tpu_torch.sim import Scenario

    return [Scenario(name=f"x{f}", load_factor=f) for f in factors] + [
        Scenario(name="minus1", remove_brokers=(0,))
    ]


def sweep(mesh, spec, factors, goal_ids):
    """fast_sweep on the mesh and whole on this rank: both verdict lists and
    the sharded sweep's host syncs."""
    _one_thread()
    from cruise_control_tpu_torch.sim import fast_sweep

    state, _, _ = case(spec)
    scenarios = sweep_scenarios(factors)
    sharded = fast_sweep(state, scenarios, goal_ids=goal_ids, device=mesh.device, mesh=mesh)
    whole = fast_sweep(state, scenarios, goal_ids=goal_ids, device=mesh.device)
    return ([v.to_dict() for v in sharded.scenarios], [v.to_dict() for v in whole.scenarios],
            sharded.num_host_syncs)


def facade_stack(classes, spec, goal_ids, hard_ids, window_ms, device_kw):
    """A started facade over a ``FakeClusterBackend`` seeded with ``spec``,
    its monitor sampled over 5 windows.  ``classes`` are one package's
    (backend, sampler, capacity resolver, monitor, executor, facade,
    Resource), so the JAX facade test builds both packages' stacks here and
    a rank builds the port's without importing JAX."""
    from chip_smoke import seed_fake_backend

    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    fake, sampler, static, monitor_cls, executor_cls, cc_cls, res = classes
    syn = SyntheticSpec(**spec)
    state, maps = generate(syn, device="cpu")
    backend = seed_fake_backend(fake(metric_interval_ms=window_ms // 2), state, maps, syn.num_racks)
    capacity = {res.CPU: syn.capacity_cpu, res.NW_IN: syn.capacity_nw_in,
                res.NW_OUT: syn.capacity_nw_out, res.DISK: syn.capacity_disk}
    monitor = monitor_cls(backend, sampler(backend), static(capacity), num_windows=3, window_ms=window_ms)
    executor = executor_cls(backend, progress_check_interval_s=0.001,
                            pause_sampling=monitor.pause_sampling, resume_sampling=monitor.resume_sampling)
    cc = cc_cls(backend, monitor, executor, goal_ids=goal_ids, hard_ids=hard_ids, **device_kw)
    cc.start()
    start = 28_000_000 * window_ms
    for w in range(5):
        monitor.sample_once(now_ms=start + w * window_ms)
    return cc


def port_facade_classes():
    from cruise_control_tpu_torch.backend import FakeClusterBackend
    from cruise_control_tpu_torch.core.resources import Resource
    from cruise_control_tpu_torch.executor import Executor
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.monitor import BackendMetricSampler, LoadMonitor, StaticCapacityResolver

    return (FakeClusterBackend, BackendMetricSampler, StaticCapacityResolver, LoadMonitor, Executor,
            CruiseControl, Resource)


def facade_sweep(mesh, spec, goal_ids, hard_ids, window_ms, factors):
    """The port facade's fast sweep (``CruiseControl.simulate``) with and
    without the mesh, on the facade test's stack over ``spec``."""
    _one_thread()
    from cruise_control_tpu_torch.sim import Scenario

    cc = facade_stack(port_facade_classes(), spec, goal_ids, hard_ids, window_ms, {"device": mesh.device})
    try:
        scenarios = [Scenario(name=f"x{f}", load_factor=f) for f in factors]
        sharded = cc.simulate(scenarios, mesh=mesh)
        whole = cc.simulate(scenarios)
    finally:
        cc.shutdown()
    return [v.to_dict() for v in sharded.scenarios], [v.to_dict() for v in whole.scenarios]

def _added_rank0_first(spmd, calls, parts=None):
    """``chained_segment_sums`` as the sharded snapshot first had it: each
    rank's own segment sums, then the float sums gathered and added rank 0
    first (the same bits on every rank), the counts merged exactly."""
    from cruise_control_tpu_torch.ops.segments import segment_sums
    from cruise_control_tpu_torch.parallel.spmd import merge_sums

    def merged(x):
        if not x.dtype.is_floating_point:
            return merge_sums(spmd, {"x": x})["x"]
        partials = spmd.mesh.all_gather(x)
        acc = partials[0]
        for r in range(1, spmd.mesh.world):
            acc = acc + partials[r]
        return acc

    sums = [[merged(x) for x in segment_sums(cols, ids, S)] for cols, ids, S in calls]
    return sums, merge_sums(spmd, dict(parts or {}))


def config2_fold_and_added_partials(mesh):
    """Config #2 (heavy goals on) sharded on this rank twice: as the solver
    is (the snapshot's sums fold over the ranks in row order) and with the
    snapshot's float sums merged as partials added rank 0 first."""
    _one_thread()
    from chip_smoke import CONFIG2

    from cruise_control_tpu_torch.analyzer import context

    kw = dict(enable_heavy_goals=True)
    out = {"fold": sharded_solve(mesh, CONFIG2, kw)["solution"]}
    fold = context.chained_segment_sums
    context.chained_segment_sums = _added_rank0_first
    try:
        out["added"] = sharded_solve(mesh, CONFIG2, kw)["solution"]
    finally:
        context.chained_segment_sums = fold
    return out
