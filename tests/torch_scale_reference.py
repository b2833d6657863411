"""The JAX package's solves of the port's scale workloads (``bench_scale``).

``jax_record(...)`` runs the JAX ``GoalOptimizer`` on the CPU over the spec
and goal list that ``cruise_control_tpu_torch.bench_scale.workload`` gives
(the root ``bench_scale.py``'s own) and returns the record the port's
``bench_scale.record`` builds from a result, so the two compare key for key
(``bench_scale.differences``).  Run as a script it writes a reference record
for ``bench_scale --check``, with the command and the commit it came from:

    python tests/torch_scale_reference.py config3            # default goals
    python tests/torch_scale_reference.py config3_fullgoals --full-goals
    python tests/torch_scale_reference.py config4_small --config4 --brokers 48 --partitions 1500
    python tests/torch_scale_reference.py 2500b --config4 --brokers 2500 --partitions 250000

The record of config #3 takes the JAX package minutes on a CPU (its compile
and ~300 rounds over 300,000 replicas), 2,500 brokers about 18 minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _jax_cpu():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_record(config4=False, full_goals=False, brokers=None, partitions=None, max_active=None,
               max_rounds=None) -> dict:
    """The JAX package's record of one scale workload (one cold solve)."""
    _jax_cpu()
    from cruise_control_tpu.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch import bench_scale

    spec, goal_ids, heavy = bench_scale.workload(config4, full_goals, brokers, partitions)
    state, _ = generate(SyntheticSpec(**spec))
    ctx_kw = {} if max_active is None else {"max_active_brokers": max_active}
    ctx = GoalContext.build(state.num_topics, state.num_brokers, **ctx_kw)
    opt_kw = {} if max_rounds is None else {"max_rounds_per_phase": max_rounds}
    opt = GoalOptimizer(goal_ids=goal_ids, enable_heavy_goals=heavy, **opt_kw)
    t0 = time.monotonic()
    final, result = opt.optimize(state, ctx)
    wall = time.monotonic() - t0
    rec = bench_scale.record(result, state, final, spec, goal_ids, int(ctx.max_active_brokers))
    rec["jax_cpu_wall_s"] = round(wall, 3)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="write a bench_scale reference record from the JAX package")
    ap.add_argument("name", help="the record's name: SCALE_REFERENCE_<name>.json")
    ap.add_argument("--config4", action="store_true")
    ap.add_argument("--full-goals", action="store_true")
    ap.add_argument("--brokers", type=int, default=None)
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--max-active", type=int, default=None)
    ap.add_argument("--max-rounds", type=int, default=None)
    ap.add_argument("--out", default=None, help="default: bench_scale.reference_path(name)")
    args = ap.parse_args(argv)
    from cruise_control_tpu_torch import bench_scale

    rec = jax_record(args.config4, args.full_goals, args.brokers, args.partitions, args.max_active,
                     args.max_rounds)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_ROOT, capture_output=True, text=True).stdout.strip()
    rec["generated_by"] = "python tests/torch_scale_reference.py " + " ".join(argv or sys.argv[1:])
    rec["jax_commit"] = commit or None
    out = args.out or bench_scale.reference_path(args.name)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({k: rec[k] for k in ("total_moves", "total_rounds", "balancedness", "digest",
                                          "jax_cpu_wall_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
