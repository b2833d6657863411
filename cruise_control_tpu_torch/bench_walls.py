"""Config #2 proposal walls of this checkout on one card, for comparing trees.

    python3 -m cruise_control_tpu_torch.bench_walls [--warm N] [--label NAME]

Solves the benchmark's config #2 (100 brokers, 10,000 partitions, RF 3,
seed 7; ``GoalOptimizer.optimize`` with the 16 default goals, heavy goals on)
once cold and ``N`` times warm, then once more with the host time of
``take_snapshot``, of the segment-sum kernel wrappers and of the XLA-order
band sums attributed (``time.perf_counter`` around each call; the calls
return before their kernels run, so this is host time).  Beside each warm
wall it gives the main thread's CPU time, which other processes on a shared
host stretch less than the wall.  Prints one JSON line, with the card's
``nvidia-smi`` name and power limit.

To compare two trees, run it in each checkout in turns (A, B, B, A, ...) on
one machine.  It reads and writes only the checkout it sits in: the kernels
build into that checkout's ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List

import torch

CONFIG2 = dict(
    num_racks=10, num_brokers=100, num_topics=100, num_partitions=10_000,
    replication_factor=3, distribution="exponential", skew_brokers=25,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)
# (label, module, function); the first function a module has is timed
_ATTRIBUTED = [
    ("take_snapshot", "cruise_control_tpu_torch.analyzer.context", ("take_snapshot",)),
    ("segment_sum_wrappers", "cruise_control_tpu_torch.ops.segments",
     ("segment_sums_cuda", "segment_sum_cuda")),
    ("xla_sums", "cruise_control_tpu_torch.ops.index", ("xla_sums",)),
]


def _solve_setup():
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, maps = generate(SyntheticSpec(**CONFIG2), device="cuda")
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cuda")
    return state, ctx, GoalOptimizer(enable_heavy_goals=True, device="cuda"), maps


def _timed_solve(opt, state, ctx, maps):
    """(wall s, host CPU s of the main thread, result) of one solve."""
    t0, c0 = time.monotonic(), time.thread_time()
    _, res = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    return time.monotonic() - t0, time.thread_time() - c0, res


def _attribute() -> Dict[str, List[float]]:
    """Wrap each function of ``_ATTRIBUTED`` that this tree has, wherever a
    module of the package holds it; returns label -> [calls, host seconds]."""
    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("cruise_control_tpu_torch") and m is not None]
    stats: Dict[str, List[float]] = {}
    for label, modname, names in _ATTRIBUTED:
        mod = sys.modules.get(modname)
        fn = next((getattr(mod, n) for n in names if mod is not None and hasattr(mod, n)), None)
        if fn is None:
            continue
        rec = stats[label] = [0, 0.0]

        def timed(*args, _fn=fn, _rec=rec, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                _rec[0] += 1
                _rec[1] += time.perf_counter() - t0

        for m in mods:
            for attr, value in list(vars(m).items()):
                if value is fn:
                    setattr(m, attr, timed)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=5, help="warm solves to time")
    ap.add_argument("--label", default="tree", help="name of this checkout in the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_walls: no CUDA device", file=sys.stderr)
        return 2
    state, ctx, opt, maps = _solve_setup()
    cold_s, _, res = _timed_solve(opt, state, ctx, maps)
    warm, warm_cpu = [], []
    for _ in range(args.warm):
        wall_s, cpu_s, warm_res = _timed_solve(opt, state, ctx, maps)
        if warm_res.total_moves != res.total_moves:
            print("bench_walls: a warm solve differs from the cold one", file=sys.stderr)
            return 1
        warm.append(wall_s)
        warm_cpu.append(cpu_s)
    stats = _attribute()
    attributed_s, _, _ = _timed_solve(opt, state, ctx, maps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "cold_wall_s": cold_s, "warm_wall_s": warm,
        "warm_median_s": statistics.median(warm) if warm else None,
        "warm_min_s": min(warm, default=None), "warm_max_s": max(warm, default=None),
        "warm_thread_cpu_s": warm_cpu,
        "total_moves": res.total_moves,
        "attributed_wall_s": attributed_s,
        "host_calls_and_s": stats,
        "nvidia_smi": smi.splitlines()[0],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
