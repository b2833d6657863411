"""Write the committed artifacts the gate's harness tiers fall back to.

The counterpart of the JAX package's ``scripts/bench_*.py --update-baseline``
for the port: each harness runs at its pinned workload on ``--device`` and
its result doc is written to ``obs/baselines/BENCH_<NAME>_<device>.json``
(``gate.artifact_path``), best of ``--repeats`` by the key the gate reads as
the tier's wall (``gate.HARNESS_WALL_KEYS``).  Besides the six harnesses:

- ``sharded``: the sharded tier's live measurement (``gate.sharded_measure``)
  with ``ok`` and ``collectives_per_goal_step_total``, the artifact the tier
  validates;
- ``flagship``: config #2's solve (100 brokers, 10,000 partitions, the 16
  default goals, heavy goals on), cold then warm, as ``{"parsed": ...}``:
  the record the gate cross-checks its solver tiers against.

    python -m cruise_control_tpu_torch.obs.bench_baselines --device cuda [--only controller,fleet]

A card's artifacts name the card and its power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

from cruise_control_tpu_torch.obs import gate

SCHEMA = 1
#: config #2 (bench.py:30-57)
CONFIG2 = dict(
    num_racks=10, num_brokers=100, num_topics=100, num_partitions=10_000,
    replication_factor=3, distribution="exponential", skew_brokers=25,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)


def _harness(module: str) -> Callable:
    def run(device) -> dict:
        import importlib

        return importlib.import_module(module).run_bench(device=device)

    return run


def _sharded(device) -> dict:
    m = gate.sharded_measure(device)
    errors = m.pop("errors")
    m.update(ok=not errors, errors=errors, collectives_per_goal_step_total=m["collectives_per_goal_step"])
    return m


def _flagship(device) -> dict:
    """Config #2 cold then warm on ``device``: the warm run's numbers."""
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, _ = generate(SyntheticSpec(**CONFIG2), device=device)
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device=device)
    opt = GoalOptimizer(enable_heavy_goals=True, device=device)
    t0 = time.monotonic()
    opt.optimize(state, ctx)
    gate._sync(device)
    cold_s = time.monotonic() - t0
    t0 = time.monotonic()
    _, res = opt.optimize(state, ctx)
    gate._sync(device)
    wall = time.monotonic() - t0
    return {"parsed": {
        "metric": "rebalance_wall_s_100brokers_10000partitions",
        "value": round(wall, 3), "cold_s": round(cold_s, 3),
        "residual_hard_violations": float(res.residual_hard_violations),
        "num_dispatches": res.num_host_syncs, "num_host_syncs": res.num_host_syncs,
        "total_moves": res.total_moves, "balancedness": round(res.balancedness_score, 4),
        "rounds": sum(r.rounds for r in res.goal_reports), "platform": gate._platform(device),
    }}


#: artifact name -> what measures it; the harnesses' best run is the one
#: with the least wall the gate reads (``gate.HARNESS_WALL_KEYS``)
ARTIFACTS: Dict[str, Callable] = {
    "controller": _harness("cruise_control_tpu_torch.controller.bench"),
    "fleet": _harness("cruise_control_tpu_torch.fleet.bench"),
    "traces": _harness("cruise_control_tpu_torch.traces.bench"),
    "serving": _harness("cruise_control_tpu_torch.api.bench"),
    "replication": _harness("cruise_control_tpu_torch.replication.bench"),
    "slo": _harness("cruise_control_tpu_torch.obs.selfmon_bench"),
    "sharded": _sharded,
    "flagship": _flagship,
}


def write_artifact(name: str, device, repeats: int = 1) -> str:
    """Measure ``name`` on ``device`` (a harness ``repeats`` times) and write
    the best run's doc; returns the path written."""
    dev = gate._device(device)
    key = gate.HARNESS_WALL_KEYS.get(name)
    runs = [ARTIFACTS[name](dev) for _ in range(max(1, repeats) if key else 1)]
    best = min(runs, key=lambda r: r[key]) if key else runs[0]
    doc = {"schema": SCHEMA, **best, "generated_by":
           f"python -m cruise_control_tpu_torch.obs.bench_baselines --device {dev.type} --only {name}"}
    if dev.type == "cuda":
        doc["card"] = gate.card()
    path = os.path.join(gate._repo_root(), gate.artifact_path(name, dev.type))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bench_baselines", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=gate.DEFAULT_DEVICE, help="cuda or cpu (default: %(default)s)")
    ap.add_argument("--only", default=",".join(ARTIFACTS), help="comma-separated artifacts (default: %(default)s)")
    ap.add_argument("--repeats", type=int, default=1, help="harness runs; the best is written")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n]
    unknown = [n for n in names if n not in ARTIFACTS]
    if unknown:
        print(f"bench_baselines: unknown artifact(s) {unknown}; have {sorted(ARTIFACTS)}")
        return 2
    for name in names:
        t0 = time.monotonic()
        path = write_artifact(name, args.device, args.repeats)
        print(f"bench_baselines: [{name}] {os.path.relpath(path, gate._repo_root())} "
              f"({time.monotonic() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
