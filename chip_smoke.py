#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout; any failure exits non-zero before the result:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA version,
   and the build of ``csrc/segment_sum.cu`` into ``build/kernels/``;
2. kernels: the segment-sum kernel against its plain PyTorch version at the
   solver's shapes (floats within rtol=1e-5, ints exact, two launches bitwise
   equal), with CUDA-event medians for the kernel, the plain version and one
   ``index_add_`` call (a yardstick the port never calls);
3. config2: one full rebalance proposal (``GoalOptimizer.optimize``, the 16
   default goals, heavy goals on) at the benchmark's config #2 -- 100 brokers,
   10 racks, 100 topics, 10,000 partitions, RF 3, exponential load skewed onto
   25 brokers, seed 7 -- cold and warm; fails unless every hard goal is met,
   the placement is valid and the kernel launched during the solve;
4. profile: one warm config #2 solve under ``torch.profiler`` -- device busy
   time, idle share, kernel launches per round, top kernels by device time;
5. card vs CPU: the same solve on the CPU port for config1 (placement must be
   identical) and config2_small (same hard goals satisfied, balancedness
   within 1.0);
6. the ``kernels`` JSON line, the ``nvidia-smi`` line, then the result line.

Needs the CUDA toolkit's ``nvcc`` and one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
KERNEL_SOURCE = "cruise_control_tpu_torch/csrc/segment_sum.cu"
REPLACES = (
    "cruise_control_tpu/ops/segments.py:98 (segment_sum_pallas, kernel :62) and "
    ":196 (segment_sum_radix, kernel :157)"
)


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


def median_ms(fn, reps: int = 30) -> float:
    """Median of per-call CUDA-event times over ``reps`` calls (after warm-up)."""
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


def phase_kernels(dev):
    """Kernel vs plain at the solver's shapes; returns the per-path records."""
    from cruise_control_tpu_torch.ops import segments as SEG

    cases = [
        # (label, kernel path, rows, cols, segments): where the solver meets it
        ("bload [30000,4] S=128", "segment_sum_f32", 30_000, 4, 128),
        ("topic counts [30000] S=12800", "segment_sum_i32", 30_000, 0, 12_800),
        ("rack counts [30000] S=100000", "segment_sum_i32", 30_000, 0, 100_000),
        ("[30000,1] S=2048", "segment_sum_f32", 30_000, 1, 2_048),
    ]
    gen = torch.Generator().manual_seed(0)
    records = {}
    for label, path, R, C, S in cases:
        ids_cpu = torch.randint(0, S, (R,), generator=gen, dtype=torch.int32)
        ids_cpu[:: 997] = -1          # dropped ids ride along, as in the solver's sinks
        if path == "segment_sum_f32":
            vals_cpu = torch.empty((R, C)).exponential_(generator=gen) * 1000.0
        else:
            vals_cpu = torch.randint(0, 2, (R,), generator=gen, dtype=torch.int32)
        vals, ids = vals_cpu.to(dev), ids_cpu.to(dev)
        a = SEG.segment_sum_cuda(vals, ids, S)
        b = SEG.segment_sum_cuda(vals, ids, S)
        plain = SEG.segment_sum_plain(vals, ids, S)
        torch.cuda.synchronize()
        check(torch.isfinite(a.float()).all().item(), f"{label}: non-finite kernel output")
        check(torch.equal(a, b), f"{label}: two launches differ")
        err = (a.double() - plain.double()).abs().max().item()
        if path == "segment_sum_f32":
            check(torch.allclose(a, plain, rtol=1e-5, atol=1e-5), f"{label}: max abs err {err}")
            cpu_order = torch.equal(a.cpu(), SEG.segment_sum_plain(vals_cpu, ids_cpu, S))
        else:
            check(torch.equal(a, plain), f"{label}: int sums differ (max abs err {err})")
            cpu_order = True
        ms = median_ms(lambda: SEG.segment_sum_cuda(vals, ids, S))
        plain_ms = median_ms(lambda: SEG.segment_sum_plain(vals, ids, S))
        ids_long = ids.clamp(min=0).long()
        lib_out = torch.zeros_like(a)
        library_ms = median_ms(lambda: lib_out.index_add_(0, ids_long, vals))
        cols = max(C, 1)
        nbytes = vals.element_size() * R * cols + 4 * R + a.element_size() * S * cols
        ops = R * cols
        bound_ms = max(nbytes / H100_HBM_BYTES_PER_S, ops / H100_FP32_OPS_PER_S) * 1e3
        bound_by = "bytes" if nbytes / H100_HBM_BYTES_PER_S >= ops / H100_FP32_OPS_PER_S else "operations"
        say("kernels", case=label, path=path, max_abs_err=err, bitwise_repeat=True,
            bitwise_vs_cpu_sequential=cpu_order, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        rec = records.setdefault(path, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if "ms" not in rec:   # the first case of each path is its main-path shape
            rec.update(case=label, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
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
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, idx_maps = generate(SyntheticSpec(**spec), device=device)
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device=device)
    opt = GoalOptimizer(enable_heavy_goals=True, device=device)
    return state, ctx, opt, (idx_maps if maps else None)


def phase_config2(dev):
    from cruise_control_tpu_torch.ops import segments as SEG

    state, ctx, opt, maps = _solve(CONFIG2, dev)
    SEG.reset_launch_counts()
    t0 = time.monotonic()
    final, res = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = dict(SEG.LAUNCHES)
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
        launches=launches,
        warm_total_moves=warm.total_moves,
        goals=[[r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied,
                round(r.duration_s, 3)] for r in res.goal_reports],
    )
    check(res.residual_hard_violations == 0, f"config2: hard goals violated {res.violated_hard_goals}")
    check(warm.total_moves == res.total_moves, "config2: warm run differs from cold run")
    check(_valid_placement(final), "config2: invalid final placement")
    for path, n in launches.items():
        check(n > 0, f"config2: kernel path {path} never launched on the main path")
    return launches


def phase_profile(dev):
    """Where a warm config #2 solve spends its time: ``torch.profiler`` over one
    optimize -- device busy time (sum of kernel times on the one stream), the
    idle share of the profiled wall, kernel launches per round and the top
    kernels by device time.  The profiler slows the host side, so its wall is
    longer than phase 3's warm wall; phase 3's warm wall is the one to divide
    the busy time by."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, ctx, opt, _ = _solve(CONFIG2, dev, maps=False)
    opt.optimize(state, ctx)
    torch.cuda.synchronize()
    # device activity only: the host-op events of ~10^6 launches would take
    # minutes to post-process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, res = opt.optimize(state, ctx)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    rounds = sum(r.rounds for r in res.goal_reports)
    say(
        "profile", profiled_wall_s=wall_s, device_busy_s=busy_us / 1e6,
        device_idle_share=1.0 - busy_us / 1e6 / wall_s if wall_s > 0 else None,
        kernel_launches=len(kernels), rounds=rounds,
        launches_per_round=len(kernels) / max(rounds, 1),
        top_kernels=[[name[:80], n, t / 1e3] for name, (n, t) in top],
    )


def phase_card_vs_cpu(dev):
    for name, spec in (("config1", CONFIG1), ("config2_small", CONFIG2_SMALL)):
        out = {}
        for where in ("cpu", dev):
            state, ctx, opt, maps = _solve(spec, where, maps=False)
            t0 = time.monotonic()
            final, res = opt.optimize(state, ctx)
            out[str(where)] = (final, res, time.monotonic() - t0)
        (fc, rc, tc), (fg, rg, tg) = out["cpu"], out[str(dev)]
        differ = int((fc.replica_broker != fg.replica_broker.cpu()).sum().item())
        leaders = int((fc.partition_leader != fg.partition_leader.cpu()).sum().item())
        say(
            "card_vs_cpu", config=name, cpu_wall_s=tc, gpu_wall_s=tg,
            replicas_placed_differently=differ, leaders_differ=leaders,
            cpu_moves=rc.total_moves, gpu_moves=rg.total_moves,
            cpu_balancedness=rc.balancedness_score, gpu_balancedness=rg.balancedness_score,
            gpu_violated_hard=rg.violated_hard_goals,
        )
        check(_valid_placement(fg), f"{name}: invalid placement on the card")
        check(not rg.violated_hard_goals and not rc.violated_hard_goals,
              f"{name}: hard goals violated (cpu {rc.violated_hard_goals}, gpu {rg.violated_hard_goals})")
        check(abs(rg.balancedness_score - rc.balancedness_score) <= 1.0, f"{name}: balancedness differs")
        if name == "config1":
            check(differ == 0 and leaders == 0, "config1: card placement differs from the CPU port")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.monotonic()
    lib_path = _build.build("segment_sum")
    build_s = time.monotonic() - t0
    log = _build.BUILD_LOG.get("segment_sum", (lib_path, build_s, ""))[2]
    say("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        kernel_build_s=build_s, library=os.path.relpath(lib_path),
        ptxas=[ln for ln in log.splitlines() if "registers" in ln or "smem" in ln])

    records = phase_kernels(dev)
    launches = phase_config2(dev)
    phase_profile(dev)
    phase_card_vs_cpu(dev)

    kernels = []
    for path in ("segment_sum_f32", "segment_sum_i32"):
        rec = records[path]
        kernels.append({
            "name": path, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": launches[path], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"], "shape": rec["case"],
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
