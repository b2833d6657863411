"""Batched autoscaling-policy rollouts: N (trace x policy) pairs on the device.

Port of ``cruise_control_tpu/traces/rollout.py``.  The rollout answers "which
policy holds the hard goals through this trace with the fewest broker-hours"
by stepping every pair through time on the device.

The JAX package runs the whole batch as one program, a ``lax.scan`` over time
inside a ``jax.vmap`` over pairs.  Here:

* **Pairs are the lane axis of a stack** (``model.arrays.stack_arrays``'s
  layout): the base replica/partition leaves are shared by every lane
  (expanded views, no copies), the stepped leaves carry one row per pair.
* **A step is one pass over every pair** (:func:`_rollout_step`): it reads
  its step index from an int32 word on the device, (1) rebuilds every pair's
  stepped cluster from the full-headroom state in tensor ops
  (:func:`_step_cluster`, the in-loop twin of ``sim.apply_scenario``), (2)
  takes ONE lane-form snapshot and violation pass for all pairs
  (``optimizer.lane_violations``, as ``sim.fast_sweep`` does), (3) the
  sweep's batch-wide satisfiability sums for all lanes
  (``sim.batch._sweep_reductions``: one integer segment-sum call for every
  lane's replication factors, the float totals in XLA's order), (4) the
  policy's threshold update, and writes the step's column of the
  preallocated ``[N, T, ...]`` outputs.  The carry -- each pair's target
  broker count ``n`` and cooldown -- stays in int32 ``[N]`` tensors.
* **Time, on the card, is one device program**: the step is captured once
  into a CUDA graph and run T times in a counted WHILE node
  (``analyzer.device_loop.DeviceLoops.run_counted``, ``csrc/graph_loop.cu``),
  the counterpart of the JAX ``lax.scan``: one graph launch and one host
  sync a rollout.  On the CPU the same step runs in a Python loop of T
  steps, as the CPU solver keeps its host loop.
* **Outputs** are fetched once at the end: a rollout makes ONE host sync
  (``num_host_syncs``, in place of the JAX result's ``num_dispatches``).

A trace step is therefore bit-identical to the scenario ``fast_sweep`` would
build for it (``LoadTrace.scenario_at``): a frozen one-pair rollout's per-step
verdicts equal ``fast_sweep`` over the trace's own scenarios.  The per-step
balancedness that gates scale-out under ``min_balancedness`` is summed over
the goals left to right (``ops.index.xla_sums``), the order XLA's CPU reduce
takes for it inside the JAX package's scan and vmap.

Each rollout writes the JAX package's flight record (``kind="rollout"``) and
updates the ``TraceEngine.*`` sensors.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.analyzer.device_loop import _ctx_tensors, _state_tensors, shape_key
from cruise_control_tpu_torch.analyzer.optimizer import (
    MAX_BALANCEDNESS_SCORE,
    HostSyncs,
    balancedness_cost_by_goal,
    host_fetch,
    lane_violations,
)
from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.model.arrays import ClusterArrays, broker_bucket
from cruise_control_tpu_torch.ops import graph_loop as GL
from cruise_control_tpu_torch.ops.index import xla_sums
from cruise_control_tpu_torch.sim.batch import _note_shape, _sweep_reductions
from cruise_control_tpu_torch.sim.scenario import Scenario, apply_scenario
from cruise_control_tpu_torch.traces.policy import AutoscalePolicy, frozen_policy, pack_policies
from cruise_control_tpu_torch.traces.trace import LoadTrace

I32 = torch.int32
F32 = torch.float32

#: the leaves a step rebuilds per pair; every other leaf is the base's, shared
_STEPPED = ("base_load", "leadership_delta", "broker_alive", "broker_capacity", "broker_new")


# -- the step -------------------------------------------------------------------------


def _step_cluster(
    full: ClusterArrays, base_brokers: int, n: torch.Tensor, f_t: torch.Tensor, tf_t: torch.Tensor
) -> ClusterArrays:
    """Every pair's stepped cluster as one stack: pair ``i`` at target broker
    count ``n[i]`` and factors ``(f_t[i], tf_t[i])`` -- the twin of
    ``apply_scenario``, op for op:

    * slots ``[0, base)`` are the base brokers (scale-in disables the tail,
      keeping capacity, exactly REMOVE_BROKER semantics);
    * slots ``[base, n)`` are activated headroom brokers (alive-mean
      capacity, NEW flag -- ADD_BROKER semantics);
    * slots ``[n, bucket)`` beyond the base are inert padding (zero capacity,
      not new).

    ``n``: i32[N]; ``f_t``: f32[N]; ``tf_t``: f32[N, topics]."""
    N = n.shape[0]
    ar = torch.arange(full.num_brokers, dtype=I32, device=n.device)
    enabled = ar[None, :] < n[:, None]
    alive = full.broker_alive[None, :] & enabled
    cap_on = enabled | (ar < base_brokers)[None, :]
    cap = torch.where(cap_on[..., None], full.broker_capacity[None], 0.0)
    new = full.broker_new[None, :] & enabled

    # global x per-topic factor on the follower-equivalent base and the
    # leadership delta, the f32 products apply_scenario takes
    pfac = f_t[:, None] * tf_t[:, full.partition_topic.long()]
    rfac = pfac[:, full.replica_partition.long()]
    shared = {
        f.name: getattr(full, f.name).expand((N,) + tuple(getattr(full, f.name).shape))
        for f in dataclasses.fields(full)
        if isinstance(getattr(full, f.name), torch.Tensor) and f.name not in _STEPPED
    }
    return ClusterArrays(
        **shared,
        base_load=full.base_load[None] * rfac[..., None],
        leadership_delta=full.leadership_delta[None] * pfac[..., None],
        broker_alive=alive,
        broker_capacity=cap,
        broker_new=new,
        num_racks=full.num_racks,
        num_topics=full.num_topics,
        num_hosts=full.num_hosts,
    )


#: the outputs a step writes, one column of ``[N, T, ...]`` each: name -> (trailing shape, dtype)
_OUTPUTS = {
    "viol": ((G.NUM_GOALS,), F32), "sat": ((), torch.bool), "needed": ((), I32),
    "alive": ((), I32), "action": ((), I32),
}


def _step_inputs(full: ClusterArrays, ctx: GoalContext, gf, tf, cost, policy, n0) -> Dict[str, torch.Tensor]:
    """Every tensor a step reads, by name: the full-headroom state (``s.``),
    the context (``x.``), the factors, the cost vector, the packed policies
    (``p.``) and the carry's start (``n``, ``cooldown``)."""
    out = {f"s.{k}": v for k, v in _state_tensors(full).items()}
    out.update({f"x.{k}": v for k, v in _ctx_tensors(ctx).items()})
    out.update({f"p.{k}": v for k, v in policy.items()})
    out.update(gf=gf, tf=tf, cost=cost, n=n0, cooldown=torch.zeros_like(n0))
    return out


def _rollout_step(bufs: Dict[str, torch.Tensor], ctl: torch.Tensor, *, full: ClusterArrays, ctx: GoalContext,
                  base_brokers: int, goal_ids: Tuple[int, ...]) -> None:
    """One time step of every pair, in place on ``bufs`` (:func:`_step_inputs`
    plus the ``[N, T, ...]`` outputs): the step index is ``ctl[STEP]``, read
    on the device; ``full`` and ``ctx`` give the static fields around the
    buffers.  Nothing here reads the host or sizes a tensor from the data, so
    the step can be captured."""
    t = ctl[GL.STEP:GL.STEP + 1].long()
    state = full.replace(**{k[2:]: v for k, v in bufs.items() if k.startswith("s.")})
    cx = {k[2:]: v for k, v in bufs.items() if k.startswith("x.")}
    constraint = dataclasses.replace(ctx.constraint, **{k[2:]: v for k, v in cx.items() if k.startswith("c.")})
    ctx = ctx.replace(constraint=constraint, **{k: v for k, v in cx.items() if not k.startswith("c.")})
    policy = {k[2:]: v for k, v in bufs.items() if k.startswith("p.")}
    n, cooldown = bufs["n"], bufs["cooldown"]

    states = _step_cluster(
        state, base_brokers, n, bufs["gf"].index_select(1, t)[:, 0], bufs["tf"].index_select(1, t)[:, 0]
    )
    viol = lane_violations(states, ctx, False, goal_ids)
    sat, needed, _, _ = _sweep_reductions(states, ctx)
    alive_n = states.broker_alive.sum(1, dtype=I32)
    bal = _balancedness(viol, bufs["cost"])
    n_next, cooldown_next = _policy_step(n, cooldown, sat, needed, alive_n, bal, policy)
    for name, x in (("viol", viol), ("sat", sat), ("needed", needed), ("alive", alive_n), ("action", n_next - n)):
        bufs[f"out_{name}"].index_copy_(1, t, x[:, None])
    n.copy_(n_next)
    cooldown.copy_(cooldown_next)


def _time_loop(inputs, outputs, step, T: int, dev: torch.device, key: tuple, syncs: HostSyncs):
    """The T steps and their outputs: on the card ONE launch of a counted
    loop (its ctl words fetched with the outputs by the caller's
    ``host_fetch``), ``key`` naming every shape and value the step bakes in;
    on the CPU :func:`_host_loop`."""
    if dev.type != "cuda":
        return _host_loop(inputs, outputs, step, T, dev)
    from cruise_control_tpu_torch.analyzer.device_loop import device_loops

    outs, run = device_loops(dev).run_counted(key, inputs, outputs, step, T, name="rollout")
    syncs.runs.append(run)
    return outs


def _host_loop(inputs, outputs, step, T: int, dev: torch.device):
    """The T steps driven from the host (the CPU's time loop, and the plain
    version of the card's counted loop): no host read between steps."""
    outs = {k: torch.empty(shape, dtype=dtype, device=dev) for k, (shape, dtype) in outputs.items()}
    bufs, ctl = {**inputs, **outs}, torch.zeros(2, dtype=I32, device=dev)
    for _ in range(T):
        step(bufs, ctl)
        ctl[GL.STEP] += 1
    return outs


def _balancedness(viol: torch.Tensor, cost_vec: torch.Tensor) -> torch.Tensor:
    """f32[N]: ``MAX_BALANCEDNESS_SCORE`` less the cost of every violated
    goal, each lane's costs added left to right over the goal axis (the order
    of the JAX package's reduce of ``[N, NUM_GOALS]`` inside its scan)."""
    N = viol.shape[0]
    violated = torch.where(viol > 0, cost_vec[None, :], 0.0)
    (total,) = xla_sums([violated.reshape(-1)], lanes=N)
    return MAX_BALANCEDNESS_SCORE - total


def _policy_step(n, cooldown, sat, needed, alive_n, bal, policy):
    """The threshold controller over the capacity-pressure signal, in int32
    and float32 tensor ops: ``(n_next, cooldown_next)``."""
    a_f = alive_n.to(F32)
    pressure = needed.to(F32)
    want_out = (
        (~sat)
        | (pressure > policy["out_thr"] * a_f)
        | ((policy["min_bal"] > 0) & (bal < policy["min_bal"]))
    )
    want_in = (~want_out) & (pressure < policy["in_thr"] * a_f)
    step = policy["step"]
    delta = torch.where(want_out, step, torch.where(want_in, -step, torch.zeros_like(step)))
    delta = torch.where(cooldown <= 0, delta, torch.zeros_like(delta))
    n_next = torch.clamp(n + delta, policy["min_b"], policy["max_b"])
    acted = n_next != n
    cooldown_next = torch.where(acted, policy["cooldown"], torch.clamp(cooldown - 1, min=0))
    return n_next, cooldown_next


# -- results ----------------------------------------------------------------------


@dataclasses.dataclass
class RolloutVerdict:
    """One (trace, policy) pair's outcome."""

    trace: str
    policy: str
    steps: int
    #: steps where NO placement of the then-alive brokers could satisfy the
    #: hard goals (the satisfiability check's verdict -- placement-independent)
    violation_steps: int
    broker_hours: float
    scale_ups: int
    scale_downs: int
    #: worst capacity deficit over the trace: max(min-brokers-needed - alive)
    max_drawdown: int
    peak_brokers: int
    final_brokers: int
    min_balancedness: float
    #: per-step series (trimmed to ``steps``)
    brokers_by_step: List[int] = dataclasses.field(default_factory=list)
    needed_by_step: List[int] = dataclasses.field(default_factory=list)

    @property
    def violation_free(self) -> bool:
        return self.violation_steps == 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["violation_free"] = self.violation_free
        return d


@dataclasses.dataclass
class RolloutResult:
    """Outcome of one batched rollout.  ``series`` holds the per-step device
    outputs as host arrays, ``[pairs, T, ...]``: ``viol`` f32[.., NUM_GOALS],
    ``sat`` bool, ``needed``, ``alive`` and ``action`` i32."""

    verdicts: List[RolloutVerdict]
    num_pairs: int
    num_steps: int
    bucket: Tuple[int, int, int]
    #: points in this rollout where the host waited on the device
    num_host_syncs: int
    bucket_hit: bool
    duration_s: float
    series: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict, repr=False)

    def winners(self) -> Dict[str, Optional[str]]:
        """Per trace: the violation-free policy with the fewest broker-hours
        (None when no policy holds the hard goals through the trace)."""
        best: Dict[str, RolloutVerdict] = {}
        for v in self.verdicts:
            if not v.violation_free:
                continue
            cur = best.get(v.trace)
            if cur is None or v.broker_hours < cur.broker_hours:
                best[v.trace] = v
        return {
            t: (best[t].policy if t in best else None)
            for t in dict.fromkeys(v.trace for v in self.verdicts)
        }

    def to_dict(self) -> dict:
        return {
            "rollout": {
                "numPairs": self.num_pairs,
                "numSteps": self.num_steps,
                "bucketBrokers": self.bucket[0],
                "numHostSyncs": self.num_host_syncs,
                "numDispatches": self.num_host_syncs,
                "bucketHit": self.bucket_hit,
                "durationS": round(self.duration_s, 4),
            },
            "winners": self.winners(),
            "verdicts": [v.to_dict() for v in self.verdicts],
        }


# -- the public rollout -----------------------------------------------------------


def _full_headroom_state(
    base: ClusterArrays, bucket_brokers: Optional[int], max_needed: int
) -> Tuple[ClusterArrays, int]:
    """The base cluster with EVERY headroom slot activated (ADD semantics up
    to the bucket), on the CPU -- the shared state every pair's step masks
    down from."""
    B = base.num_brokers
    need = max(B, max_needed)
    B_pad = broker_bucket(need) if bucket_brokers is None else int(bucket_brokers)
    if B_pad < need:
        raise ValueError(
            f"bucket_brokers={B_pad} smaller than the policies' max {need}"
        )
    full = apply_scenario(
        base, Scenario(name="headroom", add_brokers=B_pad - B), bucket_brokers=B_pad,
    )
    return full, B_pad


def rollout(
    base: ClusterArrays,
    traces: Sequence[LoadTrace],
    policies: Sequence[AutoscalePolicy],
    constraint: Optional[BalancingConstraint] = None,
    goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
    hard_ids: Sequence[int] = G.HARD_GOALS,
    bucket_brokers: Optional[int] = None,
    device: DeviceLike = None,
) -> RolloutResult:
    """Evaluate the (trace x policy) cross product on ``device`` (``cuda``
    unless ``device="cpu"``), with one host sync.

    Traces of different lengths share the batch: shorter traces pad their
    factors with 1.0 and their tail steps are masked out of every aggregate.
    The broker bucket covers the largest ``max_brokers`` any policy can
    reach."""
    from cruise_control_tpu_torch.core.sensors import (
        REGISTRY,
        TRACE_PAIRS_COUNTER,
        TRACE_ROLLOUT_TIMER,
        TRACE_ROLLOUTS_COUNTER,
    )
    from cruise_control_tpu_torch.obs import recorder as obs
    from cruise_control_tpu_torch.obs.profiler import PROFILER

    dev = resolve_device(device)
    if not traces:
        raise ValueError("rollout needs at least one trace")
    if not policies:
        raise ValueError("rollout needs at least one policy")
    token = obs.start_trace("rollout")
    cost_mark = PROFILER.mark()
    t0 = time.monotonic()
    goal_ids = tuple(goal_ids)
    hard_ids = tuple(hard_ids)
    base = base.to("cpu")

    max_policy_b = max((p.max_brokers or 0) for p in policies)
    full_cpu, B_pad = _full_headroom_state(base, bucket_brokers, max_policy_b)
    full = full_cpu.to(dev)
    ctx = GoalContext.build(base.num_topics, B_pad, constraint=constraint, device=dev)

    # materialize every trace once; stack the cross product [N, T]
    mats = [tr.materialize(base.num_topics) for tr in traces]
    T = max(m.num_steps for m in mats)
    topics = max(base.num_topics, 1)
    pairs = [(ti, pi) for ti in range(len(traces)) for pi in range(len(policies))]
    N = len(pairs)
    gf = np.ones((N, T), np.float32)
    tf = np.ones((N, T, topics), np.float32)
    valid = np.zeros((N, T), bool)
    for row, (ti, _) in enumerate(pairs):
        m = mats[ti]
        S = m.num_steps
        gf[row, :S] = m.global_factor
        tf[row, :S, :] = m.topic_factor
        valid[row, :S] = True
    packed = pack_policies([policies[pi] for _, pi in pairs], base.num_brokers, B_pad, device=dev)

    costs = balancedness_cost_by_goal(list(goal_ids), set(hard_ids))
    cost_vec = np.zeros(G.NUM_GOALS, np.float32)
    for g, c in costs.items():
        cost_vec[g] = c
    build_s = time.monotonic() - t0

    hit = _note_shape(("rollout", N, T, B_pad, base.num_replicas, base.num_partitions, goal_ids))

    # -- the time loop: one device program on the card, a host loop on the CPU ----
    t1 = time.monotonic()
    inputs = _step_inputs(
        full, ctx, torch.from_numpy(gf).to(dev), torch.from_numpy(tf).to(dev), torch.from_numpy(cost_vec).to(dev),
        packed, packed["init_b"].clone(),
    )
    outputs = {f"out_{k}": ((N, T) + shape, dtype) for k, (shape, dtype) in _OUTPUTS.items()}
    step = functools.partial(_rollout_step, full=full, ctx=ctx, base_brokers=base.num_brokers, goal_ids=goal_ids)
    syncs = HostSyncs()
    key = (shape_key(full, ctx), N, T, topics, base.num_brokers, goal_ids)
    outs = _time_loop(inputs, outputs, step, T, dev, key, syncs)
    viol, sat, needed, alive, action = host_fetch(syncs, [outs[f"out_{k}"] for k in _OUTPUTS])
    sweep_s = time.monotonic() - t1

    verdicts: List[RolloutVerdict] = []
    for row, (ti, pi) in enumerate(pairs):
        v = valid[row]
        S = int(v.sum())
        step_h = traces[ti].step_s / 3600.0
        slo = (~sat[row]) & v
        # host-side f64 score, the exact sum sim.batch._verdicts computes --
        # a frozen rollout's min_balancedness is bit-equal to fast_sweep's
        bal = [
            MAX_BALANCEDNESS_SCORE
            - sum(costs[g] for g in goal_ids if viol[row, k, g] > 0)
            for k in range(S)
        ]
        drawdown = np.maximum(needed[row] - alive[row], 0) * v
        verdicts.append(
            RolloutVerdict(
                trace=traces[ti].name or f"trace-{ti}",
                policy=policies[pi].name or f"policy-{pi}",
                steps=S,
                violation_steps=int(slo.sum()),
                broker_hours=float((alive[row] * v).sum() * step_h),
                scale_ups=int(((action[row] > 0) & v).sum()),
                scale_downs=int(((action[row] < 0) & v).sum()),
                max_drawdown=int(drawdown.max()),
                peak_brokers=int((alive[row] * v).max()),
                final_brokers=int(alive[row][S - 1]),
                min_balancedness=float(min(bal)),
                brokers_by_step=[int(x) for x in alive[row][:S]],
                needed_by_step=[int(x) for x in needed[row][:S]],
            )
        )

    result = RolloutResult(
        verdicts=verdicts,
        num_pairs=N,
        num_steps=T,
        bucket=(B_pad, base.num_replicas, base.num_partitions),
        num_host_syncs=syncs.count,
        bucket_hit=hit,
        duration_s=time.monotonic() - t0,
        series=dict(viol=viol, sat=sat, needed=needed, alive=alive, action=action),
    )
    REGISTRY.counter(TRACE_ROLLOUTS_COUNTER).inc()
    REGISTRY.counter(TRACE_PAIRS_COUNTER).inc(N)
    REGISTRY.timer(TRACE_ROLLOUT_TIMER).update(result.duration_s)
    obs.finish_trace(
        token,
        spans=[
            obs.Span("build-batch", "setup", build_s, 0),
            obs.Span("rollout", "sweep", sweep_s, syncs.count),
        ],
        attrs={
            "num_pairs": N,
            "num_traces": len(traces),
            "num_policies": len(policies),
            "num_steps": T,
            "bucket_brokers": B_pad,
            "num_dispatches": syncs.count,
            "bucket_hit": hit,
            "num_goals": len(goal_ids),
            "cost": PROFILER.cost_since(cost_mark),
        },
        device=dev,
    )
    return result


def horizon_requirements(
    base: ClusterArrays,
    trace: LoadTrace,
    constraint: Optional[BalancingConstraint] = None,
    goal_ids: Sequence[int] = G.DEFAULT_GOAL_ORDER,
    hard_ids: Sequence[int] = G.HARD_GOALS,
    device: DeviceLike = None,
) -> dict:
    """The RIGHTSIZE planning-horizon substrate (arxiv 1602.03770): evaluate
    the trace at the CURRENT broker count (a frozen policy) on ``device``
    (``cuda`` unless ``device="cpu"``) and report the peak
    min-brokers-needed over the horizon -- capacity to pre-position before
    the predicted peak, not after it hits."""
    B = base.num_brokers
    result = rollout(
        base, [trace], [frozen_policy(B)],
        constraint=constraint, goal_ids=goal_ids, hard_ids=hard_ids,
        # headroom so "needed" can exceed the current size meaningfully
        bucket_brokers=broker_bucket(max(B + 1, B * 2)),
        device=device,
    )
    v = result.verdicts[0]
    needed = np.asarray(v.needed_by_step, np.int64)
    peak_step = int(needed.argmax())
    return {
        "horizonSteps": v.steps,
        "stepS": trace.step_s,
        "currentBrokers": B,
        "peakBrokersNeeded": int(needed.max()),
        "peakStep": peak_step,
        "brokersToAdd": max(int(needed.max()) - B, 0),
        "violationSteps": v.violation_steps,
        "numHostSyncs": result.num_host_syncs,
        "numDispatches": result.num_host_syncs,
    }
