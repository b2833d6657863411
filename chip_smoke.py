#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout; any failure exits non-zero before the result:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA version,
   and the build of both kernel sources (``csrc/segment_sum.cu``,
   ``csrc/even_assign.cu``: one ``nvcc`` each, started together) into
   ``build/kernels/``;
2. kernels: both segment-sum paths against their plain PyTorch version at
   the solver's shapes (among them the assigner's 8 x 128 position counts, the
   sweep's 64 x 10,000 replication factors and the first level of its float
   totals, 64 x 938 windows, each as one call and as 64 per-lane calls; the
   one float call is timed over 3 calls, not 30 or 200),
   the skewed case (all rows in one segment) and the snapshot's multi-column
   calls: every output bitwise equal to the CPU's sequential sum (floats; ints
   exact), two launches bitwise equal.  For the kernel, the plain version and
   one ``index_add_`` call (a yardstick the port never calls): ``device_ms``,
   the summed kernel and memset durations of one call under
   ``torch.profiler`` (median of 30); ``call_ms``, CUDA events around 200
   back-to-back calls over the count; and ``latency_ms``, the median of CUDA
   events around one call (host and device of one call);
3. assign: the kafka-assigner pass (``even_assign``) at config #2's shape
   (10,000 partitions, 128 brokers, RF 3) and at 2,048 brokers, every pass
   equal to the plain CPU loop exactly, with its device and call times;
4. config2: one full rebalance proposal (``GoalOptimizer.optimize``, the 16
   default goals, heavy goals on) at the benchmark's config #2 -- 100 brokers,
   10 racks, 100 topics, 10,000 partitions, RF 3, exponential load skewed onto
   25 brokers, seed 7 -- cold and warm; host calls per kernel path and the
   value tensors they carried; fails unless every hard goal is met, the
   placement is valid, both kernel paths launched during the solve and the
   totals are the JAX reference's (24,019 / 22,245 / 7,497 moves, 310 rounds,
   balancedness 97.666);
5. the optional-goal paths at config #2 width, each cold and warm with its
   own launch counts: P1 the kafka-assigner mode (goals 22, 23; both kernels
   must launch, every position even), P2 the JBOD north-star list (the 16
   default goals then goals 16, 17, two logdirs per broker in the
   capacityJBOD.json shape), P3 REMOVE_DISKS (goal 16 alone, hard, the second
   logdir of brokers 0-9 removed from a balanced JBOD cluster with room to
   drain them);
6. sim: the what-if planner and the incremental solves on the JAX sweep
   harness's cluster (100 brokers, 10,000 partitions, RF 3, light load) at
   full width -- S1 ``fast_sweep`` of its 64 scenarios cold, warm and warm
   under ``torch.profiler`` (host calls per lane, the batch-wide integer call
   at 640,000 segments, the device idle share; every lane must equal the CPU
   port's sweep of all 64 and lanes s0-s7 its sweep of those 8, and the
   batch-wide float totals of every lane the CPU port's bitwise), S2 ``deep_sweep`` of s0-s3 (valid
   placements; lane 0 equal to its direct solve), S3 ``plan_capacity`` at
   load 1.0, S4 ``evaluate_drift`` and ``incremental_optimize`` on phase 4's
   solved placement with topics 0-9 scaled, and a 4-lane
   ``batched_incremental_optimize`` whose every lane must equal its own solve;
7. profile: one warm config #2 solve under ``torch.profiler`` -- device busy
   time, idle share, kernel launches per round, top kernels by device time;
8. card vs CPU: the same solve on the CPU port for config1 and config2_small
   (default goals) and for P1-P4 at config2_small (P2 and P3 with two
   logdirs, P4 = goals 19, 21, 20, 18 with two broker sets); placements,
   leaders and logdirs must be identical (P4 capped at 200 rounds a phase);
   then the sim entry points at config2_small (fast sweep of 8, deep sweep of
   4 in two goal orders, a capacity plan with ``deep_verify``, single and
   batched incremental solves), identical on card and CPU;
9. the ``kernels`` JSON line, the ``nvidia-smi`` line, then the result line.
   ``launches`` and ``host_calls`` are the wrapper's count of host calls in
   phase 4's cold solve (phase 5's P1 for ``even_assign``), ``sim_launches``
   those of phase 6's cold S1 sweep, ``sim_shape`` phase 2's times at the
   sweep's shape; ``kernel_launches`` are the kernels
   those calls enqueued in phase 7's solve (the fixed-order path enqueues
   three per pass), beside that solve's own host calls.

Config #2 walls of two trees are compared with
``python3 -m cruise_control_tpu_torch.bench_walls``, run in each checkout.

Needs the CUDA toolkit's ``nvcc`` and one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12        # non-tensor-core float32 peak, H100 SXM data sheet
CONFIG2 = dict(
    num_racks=10, num_brokers=100, num_topics=100, num_partitions=10_000,
    replication_factor=3, distribution="exponential", skew_brokers=25,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)
CONFIG1 = dict(
    num_racks=2, num_brokers=3, num_topics=2, num_partitions=20,
    replication_factor=2, distribution="exponential", skew_brokers=1,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=3,
)
CONFIG2_SMALL = dict(
    num_racks=5, num_brokers=40, num_topics=20, num_partitions=2000,
    replication_factor=3, distribution="exponential", skew_brokers=10,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)
#: capacityJBOD.json: two logdirs per broker, CPU 100, NW 100k, disk 1M in all
JBOD = dict(
    disks_per_broker=2, capacity_cpu=100.0, capacity_disk=1_000_000.0,
    capacity_nw_in=100_000.0, capacity_nw_out=100_000.0,
)
#: REMOVE_DISKS needs room on the remaining logdirs: a balanced cluster at half
#: config #2's disk load (at mean_disk 0.2 and RF 3 a broker fills 60 % of its
#: disk, so losing half of it leaves 120 % of what remains)
REMOVE_DISKS_LOAD = dict(skew_brokers=0, mean_disk=0.1)
DEFAULT_GOALS = tuple(range(16))
NORTH_STAR = DEFAULT_GOALS + (16, 17)
#: the JAX package's sweep harness cluster (scripts/bench_sim.py:60-68), full width
SIM = dict(
    num_racks=10, num_brokers=100, num_topics=20, num_partitions=10_000,
    replication_factor=3, seed=7, mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08,
    mean_nw_out=0.06, build_maps=False,
)
SIM_SCENARIOS = 64
#: the round cap of the incremental solves (a controller tick's bound)
SIM_MAX_ROUNDS = 64
KERNEL_SOURCES = {
    "segment_sum_f32": "cruise_control_tpu_torch/csrc/segment_sum.cu",
    "segment_sum_i32": "cruise_control_tpu_torch/csrc/segment_sum.cu",
    "even_assign": "cruise_control_tpu_torch/csrc/even_assign.cu",
}
REPLACES = {
    "segment_sum_f32": "cruise_control_tpu/ops/segments.py:98 (segment_sum_pallas, pallas_call :127)",
    "segment_sum_i32": "cruise_control_tpu/ops/segments.py:196 (segment_sum_radix, pallas_call :227)",
    "even_assign": "cruise_control_tpu/analyzer/kafka_assigner.py:111 (the lax.scan of "
                   "_assign_position, :61; not a Pallas kernel)",
}
#: config #2's default path in the JAX reference (BASELINE config #2)
CONFIG2_TOTALS = dict(total_moves=24_019, inter_broker_moves=22_245, leadership_moves=7_497,
                      rounds=310, balancedness=97.666)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def latency_ms(fn, reps: int = 30) -> float:
    """Median single-call latency: CUDA events around ONE call, ``reps`` times
    (after warm-up).  The device idles while the host runs the wrapper, so this
    is host plus device time of one call, not kernel time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def call_ms(fn, calls: int = 200) -> float:
    """Time per call of ``calls`` back-to-back calls (CUDA events around the
    run, divided by the count): what a caller that issues them in a loop pays,
    the larger of host and device time."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fns, calls: int = 30):
    """Per function, the median over ``calls`` calls of the device time one
    call enqueues: the durations of all its kernels and memsets under
    ``torch.profiler``, summed.  Each call runs in its own profiler range,
    ends in a synchronize and is followed by a 2 ms pause.  Also returns the
    first function's device time per call by kernel name."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(calls):
                with record_function("smoke_call"):
                    fn()
                    torch.cuda.synchronize()
                time.sleep(0.002)
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.name == "smoke_call" and e.device_type == DeviceType.CPU)
    check(len(starts) == calls * len(fns), f"profiler: {len(starts)} ranges for {calls * len(fns)} calls")
    # a call's device events start between its range's start and the next
    # range's (less 1 ms for the offset between the two clocks; calls are 2 ms
    # apart); the median over calls tolerates an event the profiler drops
    edges = [x - 1000.0 for x in starts] + [float("inf")]
    per_call = [0.0] * len(starts)
    by_name = {}     # the first function's time by kernel name
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name != "smoke_call":
            q = bisect.bisect_right(edges, e.time_range.start) - 1
            check(q >= 0, f"profiler: device event {e.name} before the first call")
            per_call[q] += e.time_range.elapsed_us()
            if q < calls:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0][-40:]
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / calls / 1e3
    out = []
    for i in range(len(fns)):
        us = sorted(per_call[i * calls:(i + 1) * calls])
        check(us[calls // 2] > 0.0, "profiler: most calls show no device time")
        out.append(us[calls // 2] / 1e3)
    return out, by_name


def _kernel_cases(gen):
    """(label, path, value columns, ids, segments) at the solver's shapes."""
    from cruise_control_tpu_torch.ops.index import _window_ids

    R = 30_000

    def ids(S):
        x = torch.randint(0, S, (R,), generator=gen, dtype=torch.int32)
        x[::997] = -1          # dropped ids ride along, as in the solver's sinks
        return x

    def f32(*shape):
        return torch.empty(shape).exponential_(generator=gen) * 1000.0

    def bits(p):
        return torch.rand((R,), generator=gen) < p

    rb = ids(128)
    return [
        ("bload [30000,4] S=128", "segment_sum_f32", [f32(R, 4)], rb, 128),
        ("topic counts [30000] S=12800", "segment_sum_i32",
         [torch.randint(0, 2, (R,), generator=gen, dtype=torch.int32)], ids(12_800), 12_800),
        ("rack counts [30000] bool S=100000", "segment_sum_i32", [bits(0.95)], ids(100_000), 100_000),
        ("[30000,1] S=2048", "segment_sum_f32", [f32(R, 1)], ids(2_048), 2_048),
        ("skewed: all rows in segment 5, [30000,4] S=128", "segment_sum_f32", [f32(R, 4)],
         torch.full((R,), 5, dtype=torch.int32), 128),
        ("snapshot broker call: [30000,4] + 2 bool + 5 f32 -> S=128", "segment_sum_f32",
         [f32(R, 4), bits(0.95), bits(0.33), f32(R), f32(R), f32(R),
          bits(0.05).float(), bits(0.05).float()], rb, 128),
        ("snapshot topic call: 2 bool [30000] -> S=12800", "segment_sum_i32",
         [bits(0.95), bits(0.33)], ids(12_800), 12_800),
        ("assigner position counts: bool [30000] -> 8 x 128 = 1024", "segment_sum_i32",
         [bits(0.97)], ids(1_024), 1_024),
        ("band sums, first level: [128,4] x2 + [128] -> 4 windows", "segment_sum_f32",
         [f32(128, 4), f32(128, 4), f32(128)],
         torch.arange(128, dtype=torch.int32) // 32, 4),
        # the sweep's replication factors (JAX sim/batch.py:88): every lane's
        # replica_valid under ids lane * 10,000 + partition, one call
        (SWEEP_CASE + " bool", "segment_sum_i32", [torch.ones(SIM_SCENARIOS * R, dtype=torch.bool)],
         sweep_ids(), SIM_SCENARIOS * 10_000),
        (SWEEP_CASE + " i32", "segment_sum_i32",
         [torch.randint(0, 2, (SIM_SCENARIOS * R,), generator=gen, dtype=torch.int32)],
         sweep_ids(), SIM_SCENARIOS * 10_000),
        # the first level of the sweep's float totals (sim.batch.sweep_totals):
        # every lane's must-serve load and offline bytes into XLA's 32-row
        # windows, each lane's windows after the last lane's, as one call; the
        # sweep makes it one call a lane (ops.index.LANE_CALL_WINDOWS)
        (SWEEP_TOTALS_CASE, "segment_sum_f32",
         [f32(SIM_SCENARIOS * R, 4), f32(SIM_SCENARIOS * R)],
         _window_ids(R, torch.device("cpu"), SIM_SCENARIOS), SIM_SCENARIOS * SWEEP_WINDOWS),
    ]


SWEEP_CASE = "sweep replication factors: [64 x 30000] -> 64 x 10000 = 640000"
#: XLA's 32-row windows over one lane's 30,000 replicas
SWEEP_WINDOWS = -(-30_000 // 32)
SWEEP_TOTALS_CASE = (f"sweep totals, first level: [64 x 30000,4] + [64 x 30000] -> 64 x {SWEEP_WINDOWS} = "
                     f"{SIM_SCENARIOS * SWEEP_WINDOWS} windows")
#: the sweep cases and one lane's segments in each
SWEEP_LANE_SEGMENTS = {SWEEP_CASE: 10_000, SWEEP_TOTALS_CASE: SWEEP_WINDOWS}


def sweep_ids():
    """The sweep's ids at the harness's shape: lane * P + partition, each
    partition's 3 replicas together, as the synthetic cluster lays them out."""
    rp = torch.arange(10_000, dtype=torch.int32).repeat_interleave(3)
    return (torch.arange(SIM_SCENARIOS, dtype=torch.int32)[:, None] * 10_000 + rp).reshape(-1)


def phase_kernels(dev):
    """Every kernel path against its plain version at the solver's shapes:
    floats bitwise equal to the CPU's sequential sum, ints exact, two launches
    bitwise equal; then device time, call time and single-call latency of the
    kernel, the plain version and one ``index_add_`` call (a yardstick the
    port never calls).  Returns the per-case records."""
    from cruise_control_tpu_torch.ops import segments as SEG

    gen = torch.Generator().manual_seed(0)
    records = []
    for label, path, cols_cpu, ids_cpu, S in _kernel_cases(gen):
        cols, ids = [c.to(dev) for c in cols_cpu], ids_cpu.to(dev)
        SEG.reset_launch_counts()
        a = SEG.segment_sums(cols, ids, S)
        b = SEG.segment_sums(cols, ids, S)
        torch.cuda.synchronize()
        check(SEG.LAUNCHES[path] == 2 and sum(SEG.LAUNCHES.values()) == 2,
              f"{label}: {SEG.LAUNCHES} host calls for two calls on {path}")
        plain = SEG.segment_sums_plain(cols, ids, S)
        cpu = SEG.segment_sums_plain(cols_cpu, ids_cpu, S)
        err = 0.0
        for x, y, p, c in zip(a, b, plain, cpu):
            check(torch.isfinite(x.float()).all().item(), f"{label}: non-finite kernel output")
            check(torch.equal(x, y), f"{label}: two launches differ")
            check(x.dtype == c.dtype and x.shape == c.shape, f"{label}: dtype or shape differs")
            check(torch.equal(x.cpu(), c), f"{label}: differs from the CPU sequential sum")
            e = (x.double() - p.double()).abs().max().item() if x.numel() else 0.0
            check(e == 0.0 or x.dtype.is_floating_point, f"{label}: int sums differ by {e}")
            err = max(err, e)

        lib_dtype = torch.float32 if path == "segment_sum_f32" else torch.int32
        flat = torch.cat([c.reshape(c.shape[0], -1).to(lib_dtype) for c in cols], dim=1)
        lib_ids = ids.clamp(min=0).long()
        lib_out = torch.zeros((S, flat.shape[1]), dtype=lib_dtype, device=dev)
        fns = [
            lambda: SEG.segment_sums(cols, ids, S),
            lambda: SEG.segment_sums_plain(cols, ids, S),
            lambda: lib_out.index_add_(0, lib_ids, flat),
        ]
        # the one call for all lanes of the sweep's totals runs ~0.25 s: few reps
        reps = 3 if label == SWEEP_TOTALS_CASE else None
        dev_ms, phases = device_ms(fns, calls=reps or 30)
        calls = [call_ms(fn, calls=reps or 200) for fn in fns]
        lat = latency_ms(fns[0], reps=reps or 30)
        per_lane = {}
        lane_segments = next((n for k, n in SWEEP_LANE_SEGMENTS.items() if label.startswith(k)), None)
        if lane_segments:
            # beside it, one call per lane (lane 0's ids are every lane's, less the offset)
            lane_ids = ids.view(SIM_SCENARIOS, -1)[0]
            lane_cols = [c.view(SIM_SCENARIOS, -1, *c.shape[1:]) for c in cols]

            def per_lane_fn():
                return [SEG.segment_sums([c[i] for c in lane_cols], lane_ids, lane_segments)
                        for i in range(SIM_SCENARIOS)]

            outs = per_lane_fn()
            check(all(torch.equal(torch.cat([o[j] for o in outs]), x) for j, x in enumerate(a)),
                  f"{label}: per-lane calls differ")
            (pl_dev,), _ = device_ms([per_lane_fn], calls=10)
            per_lane = dict(per_lane_calls=SIM_SCENARIOS, per_lane_device_ms=pl_dev,
                            per_lane_call_ms=call_ms(per_lane_fn, calls=20),
                            per_lane_latency_ms=latency_ms(per_lane_fn, reps=10))
        width = flat.shape[1]
        nbytes = (sum(c.element_size() * c.numel() for c in cols) + 4 * ids.numel()
                  + sum(x.element_size() * x.numel() for x in a))
        ops = ids.numel() * width
        t_bytes, t_ops = nbytes / H100_HBM_BYTES_PER_S, ops / H100_FP32_OPS_PER_S
        rec = dict(
            case=label, path=path, fields=len(cols), columns=width, max_abs_err=err,
            bitwise_repeat=True, bitwise_vs_cpu_sequential=True,
            device_ms=dev_ms[0], call_ms=calls[0], latency_ms=lat,
            plain_device_ms=dev_ms[1], plain_call_ms=calls[1],
            library_device_ms=dev_ms[2], library_call_ms=calls[2],
            bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
            device_ms_by_kernel=phases, **per_lane,
        )
        say("kernels", **rec)
        records.append(rec)
    return records


def _valid_placement(state) -> bool:
    """Every partition's replicas sit on distinct alive brokers and its leader
    is one of its replicas."""
    rp = state.replica_partition.cpu().numpy()
    rb = state.replica_broker.cpu().numpy()
    alive = state.broker_alive.cpu().numpy()
    leader = state.partition_leader.cpu().numpy()
    pairs = set(zip(rp.tolist(), rb.tolist()))
    return (
        len(pairs) == len(rp)
        and bool(alive[rb].all())
        and bool((rp[leader] == list(range(len(leader)))).all())
    )


def _solve(spec, device, maps=True):
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    state, ctx, idx_maps = _case(spec, device)
    opt = GoalOptimizer(enable_heavy_goals=True, device=device)
    return state, ctx, opt, (idx_maps if maps else None)


def _reset_counts() -> None:
    from cruise_control_tpu_torch.ops import assign as PA
    from cruise_control_tpu_torch.ops import segments as SEG

    SEG.reset_launch_counts()
    PA.reset_launch_counts()


def _counts() -> dict:
    """Host calls per kernel path since the last :func:`_reset_counts`."""
    from cruise_control_tpu_torch.ops import assign as PA
    from cruise_control_tpu_torch.ops import segments as SEG

    return {**SEG.LAUNCHES, **PA.LAUNCHES}


def _case(spec, device, removed=(), broker_sets=False):
    """(state, ctx, maps) of a synthetic spec on ``device``: the second logdir
    of each broker in ``removed`` at capacity 0 (a removed logdir), brokers and
    topics in two broker sets by parity when ``broker_sets``."""
    from cruise_control_tpu_torch.analyzer import GoalContext
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, maps = generate(SyntheticSpec(**spec), device=device)
    if removed:
        cap = state.disk_capacity.clone()
        cap[[2 * b + 1 for b in removed]] = 0.0
        state = state.replace(disk_capacity=cap)
    kw = {}
    if broker_sets:
        kw = dict(broker_set_of_broker=[b % 2 for b in range(state.num_brokers)],
                  broker_set_of_topic=[t % 2 for t in range(state.num_topics)])
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device=device, **kw)
    return state, ctx, maps


def _goal_rows(res):
    return [[r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied,
             round(r.duration_s, 3)] for r in res.goal_reports]


def phase_config2(dev):
    from cruise_control_tpu_torch.ops import segments as SEG

    state, ctx, opt, maps = _solve(CONFIG2, dev)
    SEG.reset_launch_counts()
    t0 = time.monotonic()
    final, res = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches, fields = dict(SEG.LAUNCHES), dict(SEG.FIELDS)
    t0 = time.monotonic()
    _, warm = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    say(
        "config2", cold_wall_s=cold_s, warm_wall_s=warm_s,
        brokers=state.num_brokers, replicas=state.num_replicas,
        total_moves=res.total_moves,
        inter_broker_moves=res.movement.num_inter_broker_moves,
        leadership_moves=res.movement.num_leadership_moves,
        proposals=len(res.proposals),
        residual_hard_violations=res.residual_hard_violations,
        residual_soft_violations=res.residual_soft_violations,
        balancedness=res.balancedness_score,
        num_host_syncs=res.num_host_syncs,
        rounds=sum(r.rounds for r in res.goal_reports),
        host_calls=launches, fields_carried=fields,
        warm_total_moves=warm.total_moves,
        goals=[[r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied,
                round(r.duration_s, 3)] for r in res.goal_reports],
    )
    check(res.residual_hard_violations == 0, f"config2: hard goals violated {res.violated_hard_goals}")
    check(warm.total_moves == res.total_moves, "config2: warm run differs from cold run")
    check(_valid_placement(final), "config2: invalid final placement")
    for path, n in launches.items():
        check(n > 0, f"config2: kernel path {path} never launched on the main path")
    got = dict(total_moves=res.total_moves, inter_broker_moves=res.movement.num_inter_broker_moves,
               leadership_moves=res.movement.num_leadership_moves,
               rounds=sum(r.rounds for r in res.goal_reports),
               balancedness=round(res.balancedness_score, 3))
    check(got == CONFIG2_TOTALS, f"config2: {got} differ from the JAX reference's {CONFIG2_TOTALS}")
    return launches, final


def phase_assign(dev):
    """The kafka-assigner pass against its plain version: three passes (RF 3)
    on the card and in the CPU loop, counts and picks equal exactly; then the
    kernel's device time, call time and single-call latency per launch, and
    the plain loop's time per pass on the CPU.  Returns the per-shape records."""
    from cruise_control_tpu_torch.ops import assign as PA

    gen = torch.Generator().manual_seed(1)
    records = []
    for label, P, B, alive, racks in (
        ("config #2: P=10000, B=128 (100 eligible), RF 3, 10 racks", 10_000, 128, 100, 10),
        ("P=10000, B=2048, RF 3, 40 racks", 10_000, 2_048, 2_048, 40),
    ):
        rf = torch.full((P,), 3, dtype=torch.int32)
        excluded = torch.rand(P, generator=gen) < 0.02
        rack = torch.arange(B, dtype=torch.int32) % racks
        eligible = torch.arange(B) < alive
        cpu_in, gpu_in = (rf, excluded, rack, eligible), tuple(x.to(dev) for x in (rf, excluded, rack, eligible))
        counts_c = torch.zeros((3, B), dtype=torch.int32)
        chosen_c = torch.full((P, 3), -1, dtype=torch.int32)
        counts_g, chosen_g = counts_c.to(dev), chosen_c.to(dev)
        t0 = time.monotonic()
        for pos in range(3):
            PA.even_assign(counts_c[pos], chosen_c, pos, *cpu_in)
        plain_ms = (time.monotonic() - t0) * 1e3 / 3

        def passes():
            for pos in range(3):
                PA.even_assign(counts_g[pos], chosen_g, pos, *gpu_in)

        PA.reset_launch_counts()
        passes()
        torch.cuda.synchronize()
        check(PA.LAUNCHES["even_assign"] == 3, f"{label}: {PA.LAUNCHES} launches for three passes")
        check(torch.equal(counts_g.cpu(), counts_c), f"{label}: counts differ from the plain version")
        check(torch.equal(chosen_g.cpu(), chosen_c), f"{label}: picks differ from the plain version")
        spread = [int(counts_c[pos, :alive].max() - counts_c[pos, :alive].min()) for pos in range(3)]
        check(max(spread) <= 1, f"{label}: uneven counts {spread}")
        (dev_ms,), by_kernel = device_ms([passes], calls=10)
        call = call_ms(passes, calls=10)
        lat = latency_ms(passes, reps=10)
        # per pass: counts in and out, earlier picks read (pos columns), picks
        # written, rf, excluded, racks, eligibility; two argmins over B a partition
        nbytes = sum(8 * B + 4 * P * pos + 4 * P + 5 * P + 5 * B for pos in range(3)) / 3
        ops = 2 * P * B
        t_bytes, t_ops = nbytes / H100_HBM_BYTES_PER_S, ops / H100_FP32_OPS_PER_S
        rec = dict(
            case=label, partitions=P, brokers=B, max_abs_err=0.0, equal_to_plain=True,
            position_spread=spread, device_ms=dev_ms / 3, call_ms=call / 3, latency_ms=lat / 3,
            plain_ms=plain_ms, us_per_partition=dev_ms / 3 / P * 1e3,
            bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
            device_ms_by_kernel=by_kernel,
        )
        say("assign", **rec)
        records.append(rec)
    return records


def _run_path(label, spec, dev, goal_ids, hard_ids, removed=(), broker_sets=False):
    """One optional-goal path at full width, cold then warm, the launch
    counts read around the cold solve.  Hard-goal failure raises."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizationFailure

    state, ctx, maps = _case(spec, dev, removed, broker_sets)
    opt = GoalOptimizer(goal_ids=goal_ids, hard_ids=hard_ids, enable_heavy_goals=True, device=dev)
    _reset_counts()
    t0 = time.monotonic()
    try:
        final, res = opt.optimize(state, ctx, maps=maps, raise_on_hard_failure=True)
    except OptimizationFailure as exc:
        raise SmokeFailure(f"{label}: {exc}") from exc
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = _counts()
    t0 = time.monotonic()
    _, warm = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    say(
        "path", path=label, goal_ids=list(goal_ids), hard_ids=list(hard_ids),
        cold_wall_s=cold_s, warm_wall_s=warm_s, brokers=state.num_brokers,
        replicas=state.num_replicas, disks=state.num_disks,
        total_moves=res.total_moves, inter_broker_moves=res.movement.num_inter_broker_moves,
        intra_broker_moves=res.movement.num_intra_broker_moves,
        leadership_moves=res.movement.num_leadership_moves, proposals=len(res.proposals),
        violated_hard_goals=res.violated_hard_goals, balancedness=res.balancedness_score,
        num_host_syncs=res.num_host_syncs, rounds=sum(r.rounds for r in res.goal_reports),
        host_calls=launches, goals=_goal_rows(res), warm_total_moves=warm.total_moves,
    )
    check(not res.violated_hard_goals, f"{label}: hard goals violated {res.violated_hard_goals}")
    check(warm.total_moves == res.total_moves, f"{label}: warm run differs from cold run")
    check(_valid_placement(final), f"{label}: invalid final placement")
    for path in ("segment_sum_f32", "segment_sum_i32"):
        check(launches[path] > 0, f"{label}: kernel path {path} never launched")
    return state, final, res, launches


def phase_paths(dev):
    """P1-P3 at config #2 width.  Returns P1's launch counts."""
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.analyzer.kafka_assigner import replica_positions

    # P1: the kafka-assigner mode
    _, final, res, p1 = _run_path("P1 kafka assigner", CONFIG2, dev, (22, 23), (22,))
    check(res.violations_after["KafkaAssignerEvenRackAwareGoal"] == 0, "P1: goal 22 not met")
    check(p1["even_assign"] == 3, f"P1: {p1['even_assign']} even_assign launches, want 3 (RF 3)")
    pos = replica_positions(final).cpu().numpy()
    rb = final.replica_broker.cpu().numpy()
    alive = final.broker_alive.cpu().numpy()
    for q in range(3):
        per_broker = np.bincount(rb[pos == q], minlength=final.num_brokers)[alive]
        check(per_broker.max() - per_broker.min() <= 1, f"P1: position {q} uneven: {per_broker.min()}-{per_broker.max()}")

    # P2: the JBOD north-star list, the default hard goals
    _run_path("P2 JBOD north star", dict(CONFIG2, **JBOD), dev, NORTH_STAR, G.HARD_GOALS)

    # P3: REMOVE_DISKS of the second logdir of brokers 0-9
    removed = tuple(range(10))
    _, final, res, _ = _run_path("P3 remove disks", dict(CONFIG2, **JBOD, **REMOVE_DISKS_LOAD), dev,
                                 (16,), (16,), removed=removed)
    check(res.violations_after["IntraBrokerDiskCapacityGoal"] == 0, "P3: goal 16 not met")
    check(res.movement.num_inter_broker_moves == 0, "P3: replicas left their brokers")
    disk = final.replica_disk.cpu().numpy()[final.replica_valid.cpu().numpy()]
    check(not np.isin(disk, [2 * b + 1 for b in removed]).any(), "P3: replicas left on removed logdirs")
    check(res.movement.num_intra_broker_moves > 0, "P3: nothing drained")
    return p1


def make_scenarios(n: int, brokers: int = 100):
    """The JAX sweep harness's scenarios (scripts/bench_sim.py:45-58): broker
    adds x load scaling x spot failures."""
    from cruise_control_tpu_torch.sim import Scenario

    return [
        Scenario(
            name=f"s{i}", add_brokers=i % 8,
            kill_brokers=(i % min(5, brokers),) if i % 3 == 0 else (),
            load_factor=1.0 + 0.02 * i,
        )
        for i in range(n)
    ]


def _verdict_rows(sweep):
    return [[v.name, v.verdict, v.hard_violations, v.balancedness, v.min_brokers_needed,
             v.offline_moves, (v.movement or {}).get("num_inter_broker_moves"), v.provision_status]
            for v in sweep.scenarios]


def _same_placement(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("replica_broker", "partition_leader", "replica_disk"))


def _drift_lanes(final, factors):
    """Each factor's drift of a solved placement: topics 0-9 scaled by it."""
    from cruise_control_tpu_torch.sim import Scenario, apply_scenario

    return [apply_scenario(final, Scenario(topic_load_factors=tuple((t, f) for t in range(10))))
            for f in factors]


def _incremental_lanes(opt, lanes, ctx, dev):
    """Each lane's own incremental solve, then the batched solve of all of
    them: (singles, batched final, batched result, wall of the batched solve).
    Fails unless every lane of the batch equals its own solve."""
    from cruise_control_tpu_torch.model.arrays import index_arrays, stack_arrays

    singles = [opt.incremental_optimize(x, ctx, max_rounds=SIM_MAX_ROUNDS) for x in lanes]
    t0 = time.monotonic()
    bfinal, bres = opt.batched_incremental_optimize(stack_arrays(lanes), ctx, max_rounds=SIM_MAX_ROUNDS)
    _sync(dev)
    wall = time.monotonic() - t0
    for i, ((final, res), lane) in enumerate(zip(singles, bres.results)):
        check(_same_placement(index_arrays(bfinal, i), final), f"batched incremental lane {i} placement differs")
        check(lane.total_moves == res.total_moves and (lane.violations_after == res.violations_after).all(),
              f"batched incremental lane {i}: {lane.total_moves} moves against {res.total_moves}")
    return singles, bfinal, bres, wall


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _profiled(fn):
    """One call of ``fn`` under ``torch.profiler`` (device activity only: the
    host-op events of ~10^6 launches would take minutes to post-process):
    ``(its result, wall s, the device events)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    return out, wall_s, [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def phase_sim(dev, config2_final):
    """The what-if planner and the incremental solves on the card.

    S1 ``fast_sweep`` of the JAX sweep harness's 64 scenarios on its
    100-broker, 10,000-partition cluster (bucket 128), cold then warm; S2
    ``deep_sweep`` of s0-s3 (default goals, heavy goals off); S3
    ``plan_capacity`` at load 1.0; S4 ``evaluate_drift``,
    ``incremental_optimize`` and ``batched_incremental_optimize`` on config
    #2's solved placement with topics 0-9 scaled.  Returns the kernel host
    calls of S1's cold sweep."""
    from cruise_control_tpu_torch import sim
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.controller import evaluate_drift
    from cruise_control_tpu_torch.sim import batch as SB
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    base, _ = generate(SyntheticSpec(**SIM), device="cpu")
    scs = make_scenarios(SIM_SCENARIOS)

    # S1: the fast sweep, cold then warm
    _reset_counts()
    t0 = time.monotonic()
    cold = sim.fast_sweep(base, scs, device=dev)
    _sync(dev)
    cold_s = time.monotonic() - t0
    calls = _counts()
    t0 = time.monotonic()
    warm = sim.fast_sweep(base, scs, device=dev)
    _sync(dev)
    warm_s = time.monotonic() - t0
    prof, prof_s, events = _profiled(lambda: sim.fast_sweep(base, scs, device=dev))
    busy_s = sum(e.device_time_total for e in events) / 1e6
    # the batch-wide sums alone: one integer call at the sweep shape
    batch = sim.build_batch(base, scs, device=dev)
    ctx = GoalContext.build(base.num_topics, batch.bucket[0], device=dev)
    _reset_counts()
    SB._sweep_reductions(batch.states, ctx)
    _sync(dev)
    batch_calls = _counts()
    per_lane = {p: (calls[p] - batch_calls[p]) / SIM_SCENARIOS for p in ("segment_sum_f32", "segment_sum_i32")}
    # the CPU port: every lane's verdict, and the batch-wide totals bitwise
    t0 = time.monotonic()
    cpu64 = sim.fast_sweep(base, scs, device="cpu")
    cpu64_s = time.monotonic() - t0
    cpu8 = sim.fast_sweep(base, scs[:8], device="cpu")
    cpu_batch = sim.build_batch(base, scs, device="cpu")
    totals = [SB.sweep_totals(batch.states, ctx), SB.sweep_totals(cpu_batch.states, ctx.to("cpu"))]
    same_totals = [torch.equal(x.cpu(), y) for x, y in zip(*totals)]
    say("sim", step="S1 fast_sweep", scenarios=len(scs), bucket=list(cold.bucket),
        cold_wall_s=cold_s, warm_wall_s=warm_s, num_host_syncs=warm.num_host_syncs,
        host_calls=calls, host_calls_batch_wide=batch_calls, host_calls_per_lane=per_lane,
        profiled_wall_s=prof_s, device_busy_s=busy_s, device_idle_share=1.0 - busy_s / prof_s,
        kernel_launches=len(events), cpu_port_wall_s=cpu64_s,
        satisfiable=sum(v.satisfiable for v in warm.scenarios),
        min_brokers_needed=sorted({v.min_brokers_needed for v in warm.scenarios}),
        totals_bitwise_vs_cpu=same_totals, verdicts=_verdict_rows(warm)[:8])
    for other, what in ((warm, "warm sweep"), (prof, "profiled sweep")):
        check([v.to_dict() for v in other.scenarios] == [v.to_dict() for v in cold.scenarios], f"S1: {what} differs")
    check([v.to_dict() for v in cold.scenarios] == [v.to_dict() for v in cpu64.scenarios],
          "S1: lanes differ from the CPU port's sweep of all 64")
    check([v.to_dict() for v in cold.scenarios[:8]] == [v.to_dict() for v in cpu8.scenarios],
          "S1: lanes s0-s7 differ from the CPU port's sweep of them")
    check(all(same_totals), f"S1: batch-wide totals differ from the CPU port's ({same_totals})")
    check(batch_calls["segment_sum_i32"] == 1 and calls["segment_sum_i32"] > SIM_SCENARIOS,
          f"S1: the sweep-shape integer call did not launch once ({batch_calls})")

    # S2: the deep sweep of s0-s3; lane 0 against a direct solve on the card
    t0 = time.monotonic()
    deep = sim.deep_sweep(base, scs[:4], device=dev)
    _sync(dev)
    deep_s = time.monotonic() - t0
    bucket = deep.bucket[0]
    t0 = time.monotonic()
    direct, direct_res = GoalOptimizer(enable_heavy_goals=False, bucket_brokers=False, device=dev).optimize(
        sim.apply_scenario(base, scs[0], bucket_brokers=bucket),
        GoalContext.build(base.num_topics, bucket, device=dev),
    )
    _sync(dev)
    say("sim", step="S2 deep_sweep", scenarios=4, wall_s=deep_s, num_host_syncs=deep.num_host_syncs,
        lane0_direct_wall_s=time.monotonic() - t0, verdicts=_verdict_rows(deep))
    for v, st in zip(deep.scenarios, deep.states):
        check(_valid_placement(st), f"S2 {v.name}: invalid placement")
    check(_same_placement(deep.states[0], direct), "S2: lane 0 differs from its direct solve")
    check(deep.scenarios[0].balancedness == direct_res.balancedness_score, "S2: lane 0 balancedness differs")

    # S3: the capacity plan at load 1.0
    t0 = time.monotonic()
    plan = sim.plan_capacity(base, load_factor=1.0, device=dev)
    _sync(dev)
    rec = plan.recommendation
    say("sim", step="S3 plan_capacity", wall_s=time.monotonic() - t0, probes=len(plan.probes),
        min_brokers=plan.min_brokers, sweeps=plan.num_host_syncs, num_host_syncs=plan.num_host_syncs,
        status=rec.status, message=rec.message, bucket=rec.sweep["bucket_brokers"])
    check(plan.min_brokers is not None and plan.min_brokers <= plan.current_brokers, "S3: no satisfiable count")

    # S4: drift and the incremental solves on config #2's solved placement
    opt = GoalOptimizer(enable_heavy_goals=True, device=dev)
    ctx2 = GoalContext.build(config2_final.num_topics, sim.broker_bucket(config2_final.num_brokers), device=dev)
    solved = sim.apply_scenario(config2_final, sim.Scenario())
    lanes = _drift_lanes(config2_final, (1.1, 1.2, 1.3, 1.4))
    at_solve = opt.violations(solved, ctx2).cpu().numpy()
    now = opt.violations(lanes[2], ctx2).cpu().numpy()
    drift = evaluate_drift(now, at_solve, opt.goal_ids, opt.hard_ids)
    _reset_counts()
    t0 = time.monotonic()
    inc_final, inc = opt.incremental_optimize(lanes[2], ctx2, max_rounds=SIM_MAX_ROUNDS, violations=now)
    _sync(dev)
    inc_s = time.monotonic() - t0
    inc_calls = _counts()
    singles, _, bres, batched_s = _incremental_lanes(opt, lanes, ctx2, dev)
    check(_same_placement(singles[2][0], inc_final), "S4: the probe-fed solve differs from the probing one")
    say("sim", step="S4 incremental", drift_score=drift.score, drift_hard_score=drift.hard_score,
        drifted_goals=drift.violated_goals, balancedness_drop=drift.balancedness_drop,
        goals_run=inc.goals_run, moves=inc.total_moves, rounds=inc.total_rounds,
        num_host_syncs=inc.num_host_syncs, wall_s=inc_s, host_calls=inc_calls,
        residual=inc.residual_violations,
        batched=dict(lanes=4, wall_s=batched_s, goals_run=bres.goals_run, num_host_syncs=bres.num_host_syncs,
                     moves=[r.total_moves for r in bres.results], rounds=[r.total_rounds for r in bres.results],
                     lane_goals_run=[r.goals_run for r in bres.results]))
    check(drift.score > 0 and inc.goals_run, "S4: the drift ran no goal")
    return calls


def _plan_outcome(plan) -> dict:
    """A capacity plan without its wall and host-sync counts: the card counts
    one sync per copy of a state to the host, the CPU none, so the counts
    (and the message that quotes them) differ by device."""
    d = plan.to_dict()
    del d["durationS"], d["numHostSyncs"]
    d["recommendation"]["message"] = d["recommendation"]["message"].split(" scenarios, ")[0]
    sweep = dict(plan.recommendation.sweep)
    del sweep["num_host_syncs"]
    if "deep_verify" in sweep:
        sweep["deep_verify"] = {k: v for k, v in sweep["deep_verify"].items() if k != "num_host_syncs"}
    d["sweep"] = sweep
    return d


def phase_sim_card_vs_cpu(dev, small_final):
    """The what-if planner and the incremental solves at config2_small on the
    CPU port and on the card: a fast sweep of 8 scenarios, a deep sweep of 4
    (one in its own goal order: two groups), a capacity plan with the edge
    verified by the full solver, and single and batched incremental solves of
    the config2_small solve drifted.  Every verdict, plan and placement must
    be identical."""
    from cruise_control_tpu_torch import sim
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    base, _ = generate(SyntheticSpec(**CONFIG2_SMALL), device="cpu")
    scs = make_scenarios(8, brokers=base.num_brokers)
    deep_scs = scs[:3] + [sim.Scenario(name="order", kill_brokers=(2,),
                                       goal_order=(G.DISK_CAPACITY, G.RACK_AWARE, G.REPLICA_DISTRIBUTION))]
    lanes = _drift_lanes(small_final, (1.2, 1.5))
    out = {}
    for where in (torch.device("cpu"), dev):
        walls = {}
        t0 = time.monotonic()
        fast = sim.fast_sweep(base, scs, device=where)
        walls["fast_sweep"] = time.monotonic() - t0
        t0 = time.monotonic()
        deep = sim.deep_sweep(base, deep_scs, device=where)
        walls["deep_sweep"] = time.monotonic() - t0
        t0 = time.monotonic()
        plan = sim.plan_capacity(base, deep_verify=True, device=where)
        walls["plan_capacity"] = time.monotonic() - t0
        opt = GoalOptimizer(enable_heavy_goals=True, device=where)
        ctx = GoalContext.build(base.num_topics, sim.broker_bucket(base.num_brokers), device=where)
        t0 = time.monotonic()
        singles, bfinal, bres, _ = _incremental_lanes(opt, lanes, ctx, where)
        walls["incremental"] = time.monotonic() - t0
        out[where.type] = (fast, deep, plan, singles, bfinal, bres, walls)
    (fc, dc, pc, sc, bc, rc, wc), (fg, dg, pg, sg, bg, rg, wg) = out["cpu"], out[dev.type]
    plan_c, plan_g = _plan_outcome(pc), _plan_outcome(pg)
    say("sim_card_vs_cpu", config="config2_small", cpu_walls_s=wc, gpu_walls_s=wg,
        fast=_verdict_rows(fg), deep=_verdict_rows(dg), plan=plan_g,
        host_syncs=dict(cpu=pc.num_host_syncs, gpu=pg.num_host_syncs),
        incremental=[[r.goals_run, r.total_moves, r.total_rounds] for _, r in sg],
        batched_incremental=[[r.goals_run, r.total_moves, r.total_rounds] for r in rg.results])
    check([v.to_dict() for v in fg.scenarios] == [v.to_dict() for v in fc.scenarios], "fast_sweep: card differs")
    check([v.to_dict() for v in dg.scenarios] == [v.to_dict() for v in dc.scenarios], "deep_sweep: card differs")
    check(all(_same_placement(a, b) for a, b in zip(dg.states, dc.states)), "deep_sweep: card placement differs")
    check(plan_g == plan_c, f"plan_capacity: card differs: {plan_g} against {plan_c}")
    check(all(_same_placement(a[0], b[0]) for a, b in zip(sg, sc)), "incremental: card placement differs")
    check([(r.goals_run, r.total_moves, r.total_rounds) for _, r in sg]
          == [(r.goals_run, r.total_moves, r.total_rounds) for _, r in sc], "incremental: card result differs")
    check(_same_placement(bg, bc) and [r.total_rounds for r in rg.results] == [r.total_rounds for r in rc.results],
          "batched incremental: card differs")


def phase_profile(dev):
    """Where a warm config #2 solve spends its time: ``torch.profiler`` over one
    optimize -- device busy time (sum of kernel times on the one stream), the
    idle share of the profiled wall, kernel launches per round and the top
    kernels by device time.  The profiler slows the host side, so its wall is
    longer than phase 3's warm wall; phase 3's warm wall is the one to divide
    the busy time by."""
    from cruise_control_tpu_torch.ops import segments as SEG

    state, ctx, opt, _ = _solve(CONFIG2, dev, maps=False)
    opt.optimize(state, ctx)
    torch.cuda.synchronize()
    SEG.reset_launch_counts()
    (_, res), wall_s, kernels = _profiled(lambda: opt.optimize(state, ctx))
    host_calls = dict(SEG.LAUNCHES)
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    rounds = sum(r.rounds for r in res.goal_reports)
    # the kernels each segment-sum path enqueued in this solve
    seg_kernels = {
        path: sum(n for name, (n, _) in by_name.items() if any(k in name for k in names))
        for path, names in (("segment_sum_f32", ("group_count", "group_scatter", "group_walk")),
                            ("segment_sum_i32", ("int_sums",)))
    }
    say(
        "profile", profiled_wall_s=wall_s, device_busy_s=busy_us / 1e6,
        device_idle_share=1.0 - busy_us / 1e6 / wall_s if wall_s > 0 else None,
        kernel_launches=len(kernels), rounds=rounds,
        launches_per_round=len(kernels) / max(rounds, 1),
        segment_sum_host_calls=host_calls, segment_sum_kernel_launches=seg_kernels,
        top_kernels=[[name[:80], n, t / 1e3] for name, (n, t) in top],
    )
    return host_calls, seg_kernels


def phase_card_vs_cpu(dev):
    """The same solve on the CPU port and on the card: identical placements,
    leaders and logdirs, no hard goal violated on either.  Returns the CPU
    port's config2_small solve."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G

    small_jbod = dict(CONFIG2_SMALL, **JBOD)
    # (name, spec, goal ids, hard ids, case options, round cap per phase).  P4's
    # topic-leader goal cycles leadership until the cap (as the JAX reference
    # does), so its depth is cut to 200 rounds a phase on both sides.
    cases = (
        ("config1", CONFIG1, DEFAULT_GOALS, G.HARD_GOALS, {}, 2000),
        ("config2_small", CONFIG2_SMALL, DEFAULT_GOALS, G.HARD_GOALS, {}, 2000),
        ("P1 config2_small", CONFIG2_SMALL, (22, 23), (22,), {}, 2000),
        ("P2 config2_small JBOD", small_jbod, NORTH_STAR, G.HARD_GOALS, {}, 2000),
        ("P3 config2_small JBOD", dict(small_jbod, **REMOVE_DISKS_LOAD), (16,), (16,),
         dict(removed=tuple(range(4))), 2000),
        ("P4 config2_small", CONFIG2_SMALL, (19, 21, 20, 18), (), dict(broker_sets=True), 200),
    )
    for name, spec, goal_ids, hard_ids, kw, max_rounds in cases:
        out = {}
        for where in ("cpu", dev):
            state, ctx, _ = _case(spec, where, **kw)
            opt = GoalOptimizer(goal_ids=goal_ids, hard_ids=hard_ids, enable_heavy_goals=True,
                                max_rounds_per_phase=max_rounds, device=where)
            t0 = time.monotonic()
            final, res = opt.optimize(state, ctx)
            out[str(where)] = (final, res, time.monotonic() - t0)
        (fc, rc, tc), (fg, rg, tg) = out["cpu"], out[str(dev)]
        differ = int((fc.replica_broker != fg.replica_broker.cpu()).sum().item())
        leaders = int((fc.partition_leader != fg.partition_leader.cpu()).sum().item())
        disks = int((fc.replica_disk != fg.replica_disk.cpu()).sum().item())
        say(
            "card_vs_cpu", config=name, goal_ids=list(goal_ids), cpu_wall_s=tc, gpu_wall_s=tg,
            replicas_placed_differently=differ, leaders_differ=leaders, disks_differ=disks,
            cpu_moves=rc.total_moves, gpu_moves=rg.total_moves,
            cpu_balancedness=rc.balancedness_score, gpu_balancedness=rg.balancedness_score,
            gpu_violated_hard=rg.violated_hard_goals, goals=_goal_rows(rg),
        )
        check(_valid_placement(fg), f"{name}: invalid placement on the card")
        check(not rg.violated_hard_goals and not rc.violated_hard_goals,
              f"{name}: hard goals violated (cpu {rc.violated_hard_goals}, gpu {rg.violated_hard_goals})")
        check(abs(rg.balancedness_score - rc.balancedness_score) <= 1.0, f"{name}: balancedness differs")
        check(differ == 0 and leaders == 0 and disks == 0,
              f"{name}: card placement differs from the CPU port")
        if name == "config2_small":
            small_final = fc
    return small_final


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.monotonic()
    libs = _build.build_all(["segment_sum", "even_assign"])
    build_s = time.monotonic() - t0
    ptxas = {
        name: [ln for ln in _build.BUILD_LOG.get(name, (path, 0.0, ""))[2].splitlines()
               if "registers" in ln or "smem" in ln]
        for name, path in libs.items()
    }
    say("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        kernel_build_s=build_s, libraries={k: os.path.relpath(v) for k, v in libs.items()},
        ptxas=ptxas)

    records = phase_kernels(dev)
    assign_records = phase_assign(dev)
    launches, config2_final = phase_config2(dev)
    p1_launches = phase_paths(dev)
    sim_launches = phase_sim(dev, config2_final)
    profile_calls, profile_kernels = phase_profile(dev)
    small_final = phase_card_vs_cpu(dev)
    phase_sim_card_vs_cpu(dev, small_final)

    kernels = []
    for path in ("segment_sum_f32", "segment_sum_i32"):
        rec = next(r for r in records if r["path"] == path)   # the main path's shape
        sweep = next(r for r in records if r["path"] == path and r["case"].startswith("sweep"))
        kernels.append({
            "name": path, "route": "cuda", "source": KERNEL_SOURCES[path], "replaces": REPLACES[path],
            "launches": launches[path], "host_calls": launches[path],
            "kernel_launches": profile_kernels[path], "kernel_launches_host_calls": profile_calls[path],
            "max_abs_err": max(r["max_abs_err"] for r in records if r["path"] == path),
            "ms": rec["device_ms"], "plain_ms": rec["plain_device_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_device_ms"],
            "device_ms": rec["device_ms"], "call_ms": rec["call_ms"], "latency_ms": rec["latency_ms"],
            "plain_call_ms": rec["plain_call_ms"], "library_call_ms": rec["library_call_ms"],
            "shape": rec["case"], "sim_launches": sim_launches[path],
            "sim_shape": {k: sweep[k] for k in ("case", "device_ms", "call_ms", "latency_ms", "plain_device_ms",
                                                "library_device_ms", "bound_ms", "bound_by", "per_lane_calls",
                                                "per_lane_device_ms", "per_lane_call_ms")},
        })
    # one kernel per host call; "plain" is the CPU loop (no PyTorch call computes it)
    rec = assign_records[0]                                    # config #2's shape
    kernels.append({
        "name": "even_assign", "route": "cuda", "source": KERNEL_SOURCES["even_assign"],
        "replaces": REPLACES["even_assign"],
        "launches": p1_launches["even_assign"], "host_calls": p1_launches["even_assign"],
        "kernel_launches": p1_launches["even_assign"],
        "kernel_launches_host_calls": p1_launches["even_assign"],
        "max_abs_err": max(r["max_abs_err"] for r in assign_records),
        "ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        "device_ms": rec["device_ms"], "call_ms": rec["call_ms"], "latency_ms": rec["latency_ms"],
        "us_per_partition": rec["us_per_partition"], "shape": rec["case"],
        "sim_launches": sim_launches["even_assign"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
