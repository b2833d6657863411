"""The sweep's batch-wide float totals on one card, by how their calls are cut.

    python3 -m cruise_control_tpu_torch.bench_sweep [--settings 1000000000,8192,1024,256]

On the JAX package's sweep harness cluster (100 brokers, 10 racks, 20 topics,
10,000 partitions, RF 3, seed 7) and its 64 scenarios, times
``sim.batch.sweep_totals`` and a warm ``sim.fast_sweep`` at each setting of
``ops.index.LANE_CALL_WINDOWS`` (the most windows one lane-batched
``xla_sums`` call carries; 1,000,000,000 is one call a level for all lanes):
the segment-sum host calls of one ``sweep_totals``, its time per call over
back-to-back calls and one call's latency (CUDA events), the device time of
each fixed-order kernel under ``torch.profiler``, and four warm sweep walls.
Every setting must give the first one's totals bitwise.  Prints one JSON line
per setting, with the card's ``nvidia-smi`` name and power limit first and
last.  The kernels build into this checkout's ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

SIM = dict(
    num_racks=10, num_brokers=100, num_topics=20, num_partitions=10_000,
    replication_factor=3, seed=7, mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08,
    mean_nw_out=0.06, build_maps=False,
)
SCENARIOS = 64


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _scenarios():
    """The harness's scenarios (JAX ``scripts/bench_sim.py:45-58``): broker
    adds x load scaling x spot failures."""
    from cruise_control_tpu_torch.sim import Scenario

    return [
        Scenario(name=f"s{i}", add_brokers=i % 8, kill_brokers=(i % 5,) if i % 3 == 0 else (),
                 load_factor=1.0 + 0.02 * i)
        for i in range(SCENARIOS)
    ]


def _call_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _latency_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms_by_kernel(fn) -> dict:
    """Device time of one call by kernel name (profiler, device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][-40:]
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings", default="1000000000,8192,2048,1024,512,256,1024,1000000000")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sweep: no CUDA device", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch import sim
    from cruise_control_tpu_torch.analyzer import GoalContext
    from cruise_control_tpu_torch.ops import _build
    from cruise_control_tpu_torch.ops import index as IX
    from cruise_control_tpu_torch.ops import segments as SEG
    from cruise_control_tpu_torch.sim import batch as SB
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    print(_nvidia_smi(), flush=True)
    _build.build_all(["segment_sum"])
    dev = torch.device("cuda")
    base, _ = generate(SyntheticSpec(**SIM), device="cpu")
    scs = _scenarios()
    batch = sim.build_batch(base, scs, device=dev)
    ctx = GoalContext.build(base.num_topics, batch.bucket[0], device=dev)

    def totals():
        return SB.sweep_totals(batch.states, ctx)

    first = None
    for setting in (int(x) for x in args.settings.split(",")):
        IX.LANE_CALL_WINDOWS = setting
        got = [x.cpu() for x in totals()]
        first = got if first is None else first
        same = all(torch.equal(a, b) for a, b in zip(got, first))
        SEG.reset_launch_counts()
        totals()
        torch.cuda.synchronize()
        calls = dict(SEG.LAUNCHES)
        walls = []
        for _ in range(4):
            t0 = time.monotonic()
            sim.fast_sweep(base, scs, device=dev)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        print(json.dumps(dict(
            lane_call_windows=setting, bitwise_equal_to_first=same, host_calls=calls,
            totals_call_ms=_call_ms(totals, 5 if setting > 4096 else 20),
            totals_latency_ms=_latency_ms(totals),
            totals_device_ms_by_kernel=_device_ms_by_kernel(totals),
            s1_warm_walls_s=walls, s1_warm_median_s=statistics.median(walls),
        )), flush=True)
        if not same:
            print(f"bench_sweep: setting {setting} changes the totals", file=sys.stderr)
            return 1
    print(_nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
