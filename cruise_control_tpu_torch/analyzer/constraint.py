"""Balancing constraint: the analyzer's threshold bundle.

Port of ``cruise_control_tpu/analyzer/constraint.py`` (the reference's
``BalancingConstraint.java`` built from ``AnalyzerConfig.java``'s knobs).
Thresholds are tensors on the solver's device: f32[4] vectors indexed by
:class:`Resource` ([CPU, NW_IN, NW_OUT, DISK]) and 0-d f32/i32 scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.core.resources import NUM_RESOURCES, Resource

#: Reference ``ResourceDistributionGoal.BALANCE_MARGIN`` (:57).
BALANCE_MARGIN = 0.9


@dataclasses.dataclass
class BalancingConstraint:
    """Thresholds driving goal feasibility and acceptance."""

    resource_balance_threshold: torch.Tensor      # f32[4]
    resource_capacity_threshold: torch.Tensor     # f32[4]
    low_utilization_threshold: torch.Tensor       # f32[4]
    replica_balance_threshold: torch.Tensor       # f32
    leader_replica_balance_threshold: torch.Tensor  # f32
    topic_replica_balance_threshold: torch.Tensor   # f32
    max_replicas_per_broker: torch.Tensor         # i32
    distribution_threshold_multiplier: torch.Tensor  # f32
    balance_margin: torch.Tensor                  # f32
    min_topic_leaders_per_broker: torch.Tensor    # i32
    topic_replica_balance_min_gap: torch.Tensor   # i32
    topic_replica_balance_max_gap: torch.Tensor   # i32

    @classmethod
    def default(
        cls,
        *,
        resource_balance_threshold: Optional[Mapping[Resource, float]] = None,
        resource_capacity_threshold: Optional[Mapping[Resource, float]] = None,
        low_utilization_threshold: Optional[Mapping[Resource, float]] = None,
        replica_balance_threshold: float = 1.10,
        leader_replica_balance_threshold: float = 1.10,
        topic_replica_balance_threshold: float = 3.00,
        max_replicas_per_broker: int = 10000,
        distribution_threshold_multiplier: float = 1.0,
        balance_margin: float = BALANCE_MARGIN,
        min_topic_leaders_per_broker: int = 1,
        topic_replica_balance_min_gap: int = 2,
        topic_replica_balance_max_gap: int = 40,
        device: DeviceLike = None,
    ) -> "BalancingConstraint":
        """Defaults mirror AnalyzerConfig.java (balance 1.10, CPU capacity 0.7,
        other capacities 0.8, low utilization 0.0, topic replica balance 3.0,
        max replicas per broker 10000)."""
        dev = resolve_device(device)
        bal = torch.ones(NUM_RESOURCES, dtype=torch.float32) * 1.10
        cap = torch.tensor([0.7, 0.8, 0.8, 0.8], dtype=torch.float32)
        low = torch.zeros(NUM_RESOURCES, dtype=torch.float32)
        for vec, over in (
            (bal, resource_balance_threshold),
            (cap, resource_capacity_threshold),
            (low, low_utilization_threshold),
        ):
            for r, v in (over or {}).items():
                vec[r] = v

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        return cls(
            resource_balance_threshold=bal.to(dev),
            resource_capacity_threshold=cap.to(dev),
            low_utilization_threshold=low.to(dev),
            replica_balance_threshold=f32(replica_balance_threshold),
            leader_replica_balance_threshold=f32(leader_replica_balance_threshold),
            topic_replica_balance_threshold=f32(topic_replica_balance_threshold),
            max_replicas_per_broker=i32(max_replicas_per_broker),
            distribution_threshold_multiplier=f32(distribution_threshold_multiplier),
            balance_margin=f32(balance_margin),
            min_topic_leaders_per_broker=i32(min_topic_leaders_per_broker),
            topic_replica_balance_min_gap=i32(topic_replica_balance_min_gap),
            topic_replica_balance_max_gap=i32(topic_replica_balance_max_gap),
        )

    def to(self, device: DeviceLike) -> "BalancingConstraint":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(dev) for f in dataclasses.fields(self)}
        )

    # -- derived band helpers (GoalUtils.java:550-575) ----------------------------

    def _multiplier(self, triggered_by_violation: bool):
        return self.distribution_threshold_multiplier if triggered_by_violation else 1.0

    def balance_percentage_with_margin(self, triggered_by_violation: bool) -> torch.Tensor:
        """f32[4]: (threshold - 1) * margin, widened for the violation detector."""
        mult = self._multiplier(triggered_by_violation)
        return (self.resource_balance_threshold * mult - 1.0) * self.balance_margin

    def utilization_bands(self, avg_utilization_pct: torch.Tensor, triggered_by_violation: bool):
        """(lower_pct f32[4], upper_pct f32[4]) balance band around the average;
        below the low-utilization threshold the lower bound is 0 and the upper
        bound is floored at ``low_util_threshold * margin``."""
        bpm = self.balance_percentage_with_margin(triggered_by_violation)
        is_low = avg_utilization_pct <= self.low_utilization_threshold
        lower = torch.where(
            is_low, 0.0, avg_utilization_pct * torch.clamp(1.0 - bpm, min=0.0)
        )
        upper = avg_utilization_pct * (1.0 + bpm)
        upper = torch.where(
            is_low,
            torch.maximum(upper, self.low_utilization_threshold * self.balance_margin),
            upper,
        )
        return lower, upper

    def count_band(self, avg_count: torch.Tensor, threshold: torch.Tensor, triggered_by_violation: bool):
        """(lower i32, upper i32) band for count goals: upper = ceil(avg*(1+pct)),
        lower = floor(avg*max(0, 1-pct)), pct = (threshold*mult - 1)*margin."""
        mult = self._multiplier(triggered_by_violation)
        pct = (threshold * mult - 1.0) * self.balance_margin
        upper = torch.ceil(avg_count * (1.0 + pct)).to(torch.int32)
        lower = torch.floor(avg_count * torch.clamp(1.0 - pct, min=0.0)).to(torch.int32)
        return lower, upper
