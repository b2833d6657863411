"""Shared trace-engine bench harness: batched-rollout wall + dispatch budget.

Port of ``cruise_control_tpu/traces/bench.py``, with the same pinned
workload: 16 (trace × policy) pairs over a 64-step trace on a seeded
10-broker synthetic cluster, bucketed to 16 brokers, on ``device`` (``cuda``
unless ``device="cpu"``).  Measured: cold wall (the first call builds the
kernels on the card), best-of-N warm wall, the warm rollout's dispatch count
(the port's host syncs; ``warm_host_syncs`` is its twin) and attributed
kernel builds (both from the ``kind="rollout"`` flight record), and the
shape-bucket hit.  A warm rollout makes one host sync and builds nothing.
"""

from __future__ import annotations

import time
from typing import Dict

from cruise_control_tpu_torch.core.device import DeviceLike

#: pinned workload: the JAX harness's own, so the two packages' dicts compare
PAIRS = 16
STEPS = 64
BUCKET = 16
DISPATCH_BUDGET = 2

LIGHT = dict(mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08, mean_nw_out=0.06)


def _workload():
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch.traces.policy import AutoscalePolicy
    from cruise_control_tpu_torch.traces.trace import (
        diurnal_trace,
        ramp_trace,
        spike_trace,
    )

    spec = SyntheticSpec(
        num_racks=5, num_brokers=10, num_topics=5, num_partitions=50,
        replication_factor=2, seed=2, **LIGHT,
    )
    state, _ = generate(spec, device="cpu")
    traces = [
        diurnal_trace(name="diurnal", num_steps=STEPS, amplitude=0.4),
        ramp_trace(name="ramp", num_steps=STEPS, rate=0.02),
        spike_trace(name="spike", num_steps=STEPS, at=16, magnitude=1.5),
        diurnal_trace(name="noisy", num_steps=STEPS, amplitude=0.3,
                      sigma=0.05, seed=9),
    ]
    policies = [
        AutoscalePolicy(
            name=f"p{i}", scale_out_threshold=0.6 + 0.08 * i,
            scale_in_threshold=0.3, cooldown_ticks=i,
            step_brokers=1 + i % 2, max_brokers=BUCKET,
        )
        for i in range(4)
    ]
    return state, traces, policies


def run_bench(warm_repeats: int = 2, device: DeviceLike = None) -> Dict:
    """Cold + warm batched rollouts on ``device``; warm numbers from the
    flight record."""
    from cruise_control_tpu_torch.obs.recorder import RECORDER
    from cruise_control_tpu_torch.traces.rollout import rollout

    state, traces, policies = _workload()

    t0 = time.monotonic()
    cold = rollout(state, traces, policies, bucket_brokers=BUCKET, device=device)
    cold_s = time.monotonic() - t0

    warm_s = float("inf")
    warm = cold
    for _ in range(max(warm_repeats, 1)):
        t0 = time.monotonic()
        warm = rollout(state, traces, policies, bucket_brokers=BUCKET, device=device)
        warm_s = min(warm_s, time.monotonic() - t0)

    record = next(iter(RECORDER.recent(1, kind="rollout")), None)
    warm_dispatches = (
        int(record.attrs.get("num_dispatches", -1)) if record else -1
    )
    warm_compiles = len(record.compile_events) if record else -1

    return {
        "pairs": warm.num_pairs,
        "steps": warm.num_steps,
        "bucket_brokers": BUCKET,
        "cold_s": round(cold_s, 4),
        "warm_s": round(warm_s, 4),
        "warm_dispatches": warm_dispatches,
        "warm_host_syncs": warm_dispatches,
        "dispatch_budget": DISPATCH_BUDGET,
        "warm_compile_events": warm_compiles,
        "bucket_hit": bool(warm.bucket_hit),
        "violation_free_pairs": sum(
            1 for v in warm.verdicts if v.violation_free
        ),
    }
