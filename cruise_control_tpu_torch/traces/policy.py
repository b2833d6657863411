"""AutoscalePolicy: the broker-count controller a rollout evaluates.

Port of ``cruise_control_tpu/traces/policy.py``.  The multi-objective
broker-autoscaling formulation of arxiv 2402.06085, reduced to the knobs a
threshold controller actually has: scale-out/in thresholds on the
*capacity-pressure* signal (min brokers needed, from the satisfiability
check, over brokers alive), a balancedness floor, a cooldown, a step size,
and hard min/max bounds.  Every field is a dynamic scalar on the
device side: :func:`pack_policies` stacks N policies into ``[N]`` tensors, one
lane per (trace, policy) pair of a rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.sim.scenario import check_wire_keys


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """One autoscaling rule set (all fields optional)."""

    name: str = ""
    #: scale OUT when min-brokers-needed > threshold × alive brokers (a
    #: fraction: 0.85 means "act when within 15% of the satisfiability edge");
    #: an unsatisfiable step always wants out, threshold or not
    scale_out_threshold: float = 0.85
    #: scale IN when min-brokers-needed < threshold × alive brokers
    scale_in_threshold: float = 0.5
    #: also scale OUT when the as-is balancedness score drops below this
    #: (0 disables the balancedness trigger)
    min_balancedness: float = 0.0
    #: steps after any action before the next may fire (anti-thrash)
    cooldown_ticks: int = 3
    #: brokers added/removed per action
    step_brokers: int = 1
    min_brokers: int = 1
    #: hard ceiling; 0 = the rollout bucket's capacity
    max_brokers: int = 0
    #: starting broker count; 0 = the base cluster's size
    initial_brokers: int = 0

    def validate(self) -> None:
        n = self.name or "policy"
        if not (0.0 < self.scale_out_threshold <= 1.0):
            raise ValueError(f"{n}: scale_out_threshold must be in (0, 1]")
        if not (0.0 <= self.scale_in_threshold < self.scale_out_threshold):
            raise ValueError(
                f"{n}: scale_in_threshold must be in [0, scale_out_threshold)"
            )
        if self.cooldown_ticks < 0:
            raise ValueError(f"{n}: cooldown_ticks < 0")
        if self.step_brokers <= 0:
            raise ValueError(f"{n}: step_brokers must be > 0")
        if self.min_brokers <= 0:
            raise ValueError(f"{n}: min_brokers must be > 0")
        if self.max_brokers and self.max_brokers < self.min_brokers:
            raise ValueError(f"{n}: max_brokers < min_brokers")
        if self.initial_brokers < 0:
            raise ValueError(f"{n}: initial_brokers < 0")

    # -- wire format (REST TRACES body) --------------------------------------

    _WIRE_KEYS = (
        "name", "scale_out_threshold", "scale_in_threshold",
        "min_balancedness", "cooldown_ticks", "step_brokers", "min_brokers",
        "max_brokers", "initial_brokers",
    )

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._WIRE_KEYS}

    @classmethod
    def from_dict(cls, d: Mapping) -> "AutoscalePolicy":
        check_wire_keys(d, cls._WIRE_KEYS, f"policy {d.get('name', '')!r}")
        policy = cls(
            name=str(d.get("name", "")),
            scale_out_threshold=float(d.get("scale_out_threshold", 0.85)),
            scale_in_threshold=float(d.get("scale_in_threshold", 0.5)),
            min_balancedness=float(d.get("min_balancedness", 0.0)),
            cooldown_ticks=int(d.get("cooldown_ticks", 3)),
            step_brokers=int(d.get("step_brokers", 1)),
            min_brokers=int(d.get("min_brokers", 1)),
            max_brokers=int(d.get("max_brokers", 0)),
            initial_brokers=int(d.get("initial_brokers", 0)),
        )
        policy.validate()
        return policy


def frozen_policy(brokers: int, name: str = "frozen") -> AutoscalePolicy:
    """A policy that never acts: min = max = initial.  The rollout under it
    measures the trace itself (per-step min-brokers-needed at a fixed size) —
    the RIGHTSIZE horizon substrate."""
    return AutoscalePolicy(
        name=name, min_brokers=brokers, max_brokers=brokers,
        initial_brokers=brokers, cooldown_ticks=0,
    )


def policies_from_wire(specs: Sequence[Mapping]) -> Tuple[AutoscalePolicy, ...]:
    """Parse a JSON list of policy dicts (the TRACES endpoint body)."""
    if not isinstance(specs, (list, tuple)):
        raise ValueError("policies must be a JSON list")
    return tuple(AutoscalePolicy.from_dict(d) for d in specs)


def pack_policies(
    policies: Sequence[AutoscalePolicy], base_brokers: int, bucket: int,
    device: DeviceLike = None,
) -> dict:
    """Stack N policies into the rollout's per-lane scalars: ``[N]`` int32 /
    float32 tensors on ``device`` (``cuda`` unless ``device="cpu"``).

    Bounds are resolved here (0-defaults → base size / bucket capacity) and
    clamped to the bucket -- the rollout never sees a broker index past the
    padded axis."""
    dev = resolve_device(device)
    n = len(policies)
    out = {
        "out_thr": np.zeros(n, np.float32),
        "in_thr": np.zeros(n, np.float32),
        "min_bal": np.zeros(n, np.float32),
        "cooldown": np.zeros(n, np.int32),
        "step": np.zeros(n, np.int32),
        "min_b": np.zeros(n, np.int32),
        "max_b": np.zeros(n, np.int32),
        "init_b": np.zeros(n, np.int32),
    }
    for i, p in enumerate(policies):
        p.validate()
        max_b = min(p.max_brokers or bucket, bucket)
        min_b = min(p.min_brokers, max_b)
        init = p.initial_brokers or base_brokers
        out["out_thr"][i] = p.scale_out_threshold
        out["in_thr"][i] = p.scale_in_threshold
        out["min_bal"][i] = p.min_balancedness
        out["cooldown"][i] = p.cooldown_ticks
        out["step"][i] = p.step_brokers
        out["min_b"][i] = min_b
        out["max_b"][i] = max_b
        out["init_b"][i] = int(np.clip(init, min_b, max_b))
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}
