"""Scale benchmarks beyond the flagship config: BASELINE.md configs #3 and #4.

Port of the root ``bench_scale.py``, with the same workloads and flags:

* config #3 (the default): 1,000 brokers, 20 racks, 1,000 topics, 100,000
  partitions, RF 3, exponential load skewed onto a quarter of the brokers,
  seed 11; RackAware and the five capacity goals (``--full-goals``: the 16
  default goals, heavy goals on);
* ``--config4``, the north star: 10,000 brokers, 1M partitions, 3M replicas,
  the 16 default goals and the two intra-broker JBOD goals with heavy goals
  on, two logdirs a broker in the ``config/capacityJBOD.json`` shape.

    python -m cruise_control_tpu_torch.bench_scale [--full-goals|--config4] \\
        [--device cuda] [--check REF] [--out FILE] ...

The solve runs on ``--device`` (``cuda`` unless ``cpu`` is asked for; with
no card it raises naming the device, where the JAX script falls back to the
CPU).  It prints one JSON line with the JAX line's keys, the port's host
syncs (``num_dispatches`` carries them, as every port record does), each
kernel path's host calls in the measured run, peak device memory, and a
digest (sha256) of the final ``replica_broker`` and ``partition_leader``;
``--out`` writes the JAX artifact's keys besides, and the movement with its
data volumes summed exactly (``movement_exact``).  ``--check REF`` holds the
solution against a reference record, a path or the name of a committed one
(``reference_path``: ``--check 2500b``): every
key of :func:`solution` must be equal, or the run exits 1 naming each
difference.  The references are the JAX package's solves of the same specs
on a CPU (``tests/torch_scale_reference.py`` writes them).  A progress
reference (``goal_progress``: a JAX run's per-goal lines for the first goals
of the list, ``SCALE_REFERENCE_config4_hard_goals.json``) holds those goals'
rounds, moves and violations after (:func:`progress_differences`).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: the committed reference records, one a workload: ``SCALE_REFERENCE_<name>.json``
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "obs", "baselines")
#: the keys of a record that a reference holds the solve to
SOLUTION_KEYS = (
    "total_moves", "total_rounds", "inter_broker_moves",
    "residual_hard_violations", "residual_soft_violations", "balancedness",
    "provision", "violations_before", "violations_after", "movement_exact",
    "goal_reports", "digest",
)


def reference_path(name: str) -> str:
    return os.path.join(REFERENCE_DIR, f"SCALE_REFERENCE_{name}.json")


def workload(
    config4: bool = False,
    full_goals: bool = False,
    brokers: Optional[int] = None,
    partitions: Optional[int] = None,
) -> Tuple[Dict[str, object], Tuple[int, ...], bool]:
    """``(SyntheticSpec keyword arguments, goal ids, heavy goals on)`` of a
    scale workload, as the root ``bench_scale.py`` builds them."""
    from cruise_control_tpu_torch.analyzer import goals_base as G

    if config4:
        brokers = brokers or 10_000
        spec = dict(
            num_racks=40, num_brokers=brokers, num_topics=2_000,
            num_partitions=partitions or 1_000_000, replication_factor=3,
            distribution="exponential", skew_brokers=brokers // 4,
            mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15,
            capacity_cpu=100.0, capacity_disk=1_000_000.0,
            capacity_nw_in=100_000.0, capacity_nw_out=100_000.0,
            disks_per_broker=2, build_maps=False, seed=11,
        )
        return spec, tuple(G.DEFAULT_GOAL_ORDER) + (G.INTRA_DISK_CAPACITY, G.INTRA_DISK_USAGE_DIST), True
    brokers = brokers or 1_000
    spec = dict(
        num_racks=20, num_brokers=brokers, num_topics=1000,
        num_partitions=partitions or 100_000, replication_factor=3,
        distribution="exponential", skew_brokers=brokers // 4,
        mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15,
        seed=11, build_maps=False,
    )
    if full_goals:
        return spec, tuple(G.DEFAULT_GOAL_ORDER), True
    goals = (G.RACK_AWARE, G.REPLICA_CAPACITY, G.DISK_CAPACITY,
             G.NW_IN_CAPACITY, G.NW_OUT_CAPACITY, G.CPU_CAPACITY)
    return spec, goals, False


def digest(replica_broker, partition_leader) -> str:
    """sha256 of the final placement: ``replica_broker`` then
    ``partition_leader``, each as little-endian int32."""
    h = hashlib.sha256()
    for x in (replica_broker, partition_leader):
        h.update(np.ascontiguousarray(np.asarray(x), dtype="<i4").tobytes())
    return h.hexdigest()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def movement_exact(initial, final) -> dict:
    """The movement of a solve with its data volumes summed exactly
    (``math.fsum`` of the float32 disk loads): the optimizer's own
    ``movement`` sums them in float32 with numpy, whose reduction order (so
    the last bit) differs between numpy builds and machines."""
    valid = _host(initial.replica_valid) & _host(final.replica_valid)
    b0, b1 = _host(initial.replica_broker), _host(final.replica_broker)
    d0, d1 = _host(initial.replica_disk), _host(final.replica_disk)
    from cruise_control_tpu_torch.core.resources import Resource

    disk = _host(initial.base_load)[:, Resource.DISK].astype(np.float64)
    inter = valid & (b0 != b1)
    intra = valid & (b0 == b1) & (d0 != d1)
    return {"num_inter_broker_moves": int(inter.sum()), "num_intra_broker_moves": int(intra.sum()),
            "inter_broker_data_to_move": math.fsum(disk[inter]), "intra_broker_data_to_move": math.fsum(disk[intra])}


def record(result, initial, final, spec: Dict[str, object], goal_ids: Sequence[int],
           max_active_brokers: int) -> dict:
    """The workload's record from an optimize result and the initial and
    final states (the port's or, duck typed, the JAX package's): the JAX
    artifact's keys, the exact movement, the spec and the digest."""
    movement = {k: int(v) if k.startswith("num_") else float(v)
                for k, v in dataclasses.asdict(result.movement).items()}
    return {
        "residual_hard_violations": float(sum(result.violations_after[n] for n in result.violated_hard_goals)),
        "residual_soft_violations": float(result.residual_soft_violations),
        "total_moves": int(result.total_moves),
        "total_rounds": int(sum(r.rounds for r in result.goal_reports)),
        "inter_broker_moves": int(result.movement.num_inter_broker_moves),
        "data_to_move": round(float(result.movement.inter_broker_data_to_move), 3),
        "goals": len(goal_ids),
        "provision": result.provision.status,
        "balancedness": round(float(result.balancedness_score), 4),
        "spec": {k: v for k, v in spec.items() if not isinstance(v, (list, dict))},
        "max_active_brokers": int(max_active_brokers),
        "violations_before": {k: float(v) for k, v in result.violations_before.items()},
        "violations_after": {k: float(v) for k, v in result.violations_after.items()},
        "movement": movement,
        "movement_exact": movement_exact(initial, final),
        "goal_reports": [
            {
                "name": r.name, "hard": bool(r.is_hard), "rounds": int(r.rounds),
                "moves": int(r.moves_applied), "violations_before": float(r.violations_before),
                "violations_after": float(r.violations_after), "duration_s": round(float(r.duration_s), 3),
            }
            for r in result.goal_reports
        ],
        "digest": digest(_host(final.replica_broker), _host(final.partition_leader)),
    }


def solution(doc: dict) -> dict:
    """What a reference holds a record to: :data:`SOLUTION_KEYS`, the goal
    reports without their durations."""
    out = {k: doc.get(k) for k in SOLUTION_KEYS}
    out["goal_reports"] = [{k: v for k, v in r.items() if k != "duration_s"} for r in doc.get("goal_reports") or []]
    return out


def differences(doc: dict, reference: dict) -> list:
    """Each key of :func:`solution` where ``doc`` and ``reference`` differ,
    with both values (the goal reports goal by goal)."""
    got, want = solution(doc), solution(reference)
    out = []
    for k in SOLUTION_KEYS:
        if k == "goal_reports":
            for i in range(max(len(got[k]), len(want[k]))):
                g = got[k][i] if i < len(got[k]) else None
                w = want[k][i] if i < len(want[k]) else None
                if g != w:
                    out.append(f"goal_reports[{i}]: {g} != reference {w}")
        elif got[k] != want[k]:
            out.append(f"{k}: {got[k]} != reference {want[k]}")
    if doc.get("spec") != reference.get("spec") or doc.get("max_active_brokers") != reference.get("max_active_brokers"):
        out.append(f"workload: spec {doc.get('spec')} / max_active {doc.get('max_active_brokers')} != reference "
                   f"{reference.get('spec')} / {reference.get('max_active_brokers')}")
    return out


def progress_differences(doc: dict, reference: dict) -> list:
    """Each goal of a progress reference -- a run's ``--progress-out`` lines
    under ``goal_progress``, the first goals of the list -- whose name,
    rounds, moves or violations after differ from ``doc``'s goal report at
    the same place."""
    reports = doc.get("goal_reports") or []
    out = []
    for i, want in enumerate(reference["goal_progress"]):
        got = reports[i] if i < len(reports) else {}
        pairs = [(got.get("name"), want["goal"])] + [(got.get(k), want[k]) for k in ("rounds", "moves",
                                                                                     "violations_after")]
        if any(g != w for g, w in pairs):
            out.append(f"goal {i} {want['goal']}: {[g for g, _ in pairs]} != reference {[w for _, w in pairs]}")
    return out


def run(
    config4: bool = False,
    full_goals: bool = False,
    brokers: Optional[int] = None,
    partitions: Optional[int] = None,
    max_active: Optional[int] = None,
    max_rounds: Optional[int] = None,
    profile: bool = False,
    progress_out: Optional[str] = None,
    warmup: bool = True,
    device=None,
) -> Tuple[dict, dict]:
    """One scale workload on ``device``: ``(the printed line, the artifact)``.

    With ``warmup`` the first solve builds the kernels and is timed as
    ``first_run_s``; the measured solve follows, with its host syncs, each
    kernel path's host calls (counted from 0 around it) and peak device
    memory."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.core.backend_probe import ensure_live_backend
    from cruise_control_tpu_torch.core.device import resolve_device
    from cruise_control_tpu_torch.ops import assign as PA
    from cruise_control_tpu_torch.ops import segments as SEG
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    if progress_out:
        profile = True
        open(progress_out, "a").close()    # fail fast on an unwritable path
    ensure_live_backend(device)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    spec_kw, goal_ids, heavy = workload(config4, full_goals, brokers, partitions)

    t0 = time.monotonic()
    state, _ = generate(SyntheticSpec(**spec_kw), device=dev)
    gen_s = time.monotonic() - t0
    ctx_kw = {} if max_active is None else {"max_active_brokers": max_active}
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device=dev, **ctx_kw)
    opt_kw = {} if max_rounds is None else {"max_rounds_per_phase": max_rounds}
    opt = GoalOptimizer(goal_ids=goal_ids, enable_heavy_goals=heavy, device=dev, **opt_kw)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    first_run_s = None
    if warmup:
        t0 = time.monotonic()
        opt.optimize(state, ctx)
        sync()
        first_run_s = time.monotonic() - t0
    run_t0 = time.monotonic()

    def progress(name, rounds, moves, after, dur):
        print(f"# goal {name}: rounds={rounds} moves={moves} violations_after={after:.0f} {dur:.1f}s",
              file=sys.stderr, flush=True)
        if progress_out:
            with open(progress_out, "a") as f:
                f.write(json.dumps({"goal": name, "rounds": rounds, "moves": moves, "violations_after": after,
                                    "duration_s": round(dur, 1),
                                    "elapsed_s": round(time.monotonic() - run_t0, 1)}) + "\n")

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    SEG.reset_launch_counts()
    PA.reset_launch_counts()
    t0 = time.monotonic()
    final, result = opt.optimize(state, ctx, profile_goals=profile, on_goal_done=progress if profile else None)
    sync()
    wall = time.monotonic() - t0
    host_calls = {**SEG.LAUNCHES, **PA.LAUNCHES}

    rec = record(result, state, final, spec_kw, goal_ids, int(ctx.max_active_brokers))
    line = {
        "metric": f"rebalance_wall_s_{spec_kw['num_brokers']}brokers_{spec_kw['num_partitions']}partitions",
        "value": round(wall, 3),
        "unit": "s",
        **{k: rec[k] for k in ("residual_hard_violations", "residual_soft_violations", "total_moves",
                               "total_rounds", "inter_broker_moves", "data_to_move")},
        "num_dispatches": result.num_host_syncs,
        "num_host_syncs": result.num_host_syncs,
        **{k: rec[k] for k in ("goals", "provision", "balancedness")},
        "platform": dev.type,
        "host_calls": host_calls,
        "peak_device_mib": torch.cuda.max_memory_allocated(dev) / 2**20 if cuda else None,
        "digest": rec["digest"],
    }
    if first_run_s is not None:
        line["first_run_s"] = round(first_run_s, 3)
    artifact = {**line, **rec, "generate_s": round(gen_s, 3)}
    return line, artifact


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bench_scale", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--config4", action="store_true",
                    help="north-star preset: 10k brokers / 1M partitions, all goals, JBOD")
    ap.add_argument("--full-goals", action="store_true", help="run all 16 goals")
    ap.add_argument("--brokers", type=int, default=None)
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--max-active", type=int, default=None,
                    help="GoalContext.max_active_brokers (per-round source window)")
    ap.add_argument("--profile", action="store_true", help="block per goal for per-goal durations")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up run (the reported wall includes the kernels' build)")
    ap.add_argument("--out", default=None, help="write the full per-goal artifact JSON here")
    ap.add_argument("--max-rounds", type=int, default=None, help="GoalOptimizer.max_rounds_per_phase")
    ap.add_argument("--progress-out", default=None,
                    help="append one JSON line per finished goal (implies --profile)")
    ap.add_argument("--check", default=None, metavar="REF",
                    help="hold the solution to this reference record (a path, or a name: "
                         "SCALE_REFERENCE_<name>.json beside the gate's baselines); exit 1 on any difference")
    args = ap.parse_args(argv)

    line, artifact = run(
        config4=args.config4, full_goals=args.full_goals, brokers=args.brokers,
        partitions=args.partitions, max_active=args.max_active, max_rounds=args.max_rounds,
        profile=args.profile, progress_out=args.progress_out, warmup=not args.no_warmup,
        device=args.device,
    )
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    if args.check:
        path = args.check if os.path.exists(args.check) else reference_path(args.check)
        with open(path) as f:
            reference = json.load(f)
        compare = progress_differences if "goal_progress" in reference else differences
        diffs = compare(artifact, reference)
        if diffs:
            print(f"bench_scale: {len(diffs)} difference(s) from {args.check}:", file=sys.stderr)
            for d in diffs:
                print(f"  - {d}", file=sys.stderr)
            return 1
        print(f"bench_scale: equal to {args.check}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
