"""Cluster-level aggregate statistics.

Port of ``cruise_control_tpu/model/stats.py`` (the reference's
``ClusterModelStats``): per-resource utilization avg/max/min/std over alive
brokers, replica/leader count dispersion and balanced-broker counts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cruise_control_tpu_torch.core.resources import Resource
from cruise_control_tpu_torch.model import arrays as A
from cruise_control_tpu_torch.model.arrays import ClusterArrays
from cruise_control_tpu_torch.ops.index import xla_sums

_F32_MAX = torch.finfo(torch.float32).max


def _masked_stats(values: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """avg/max/min/std of ``values`` over ``mask`` (reduced along dim 0; the
    sums in the JAX reference's order)."""
    n = torch.clamp(mask.sum(dtype=torch.int32), min=1)
    (total,) = xla_sums([torch.where(mask, values, 0.0)])
    avg = total / n
    mx = torch.where(mask, values, -_F32_MAX).amax(dim=0)
    mn = torch.where(mask, values, _F32_MAX).amin(dim=0)
    (sq,) = xla_sums([torch.where(mask, (values - avg) ** 2, 0.0)])
    var = sq / n
    return {"avg": avg, "max": mx, "min": mn, "std": torch.sqrt(var)}


def cluster_model_stats(
    state: ClusterArrays, balance_percentage: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """Aggregate stats over alive brokers, as a flat dict of tensors:
    ``util_*`` / ``cap_util_*`` (f32[4]), ``replicas_*`` / ``leaders_*``,
    ``num_balanced_by_resource`` (when ``balance_percentage`` is given),
    ``num_alive_brokers`` and ``total_replicas``."""
    alive = state.broker_alive
    mask2 = alive[:, None]

    load = A.broker_load(state)
    cap = torch.clamp(state.broker_capacity, min=1e-9)
    cap_util = load / cap

    out: Dict[str, torch.Tensor] = {}
    for key, val, m in (("util", load, mask2), ("cap_util", cap_util, mask2)):
        for stat_name, v in _masked_stats(val, m).items():
            out[f"{key}_{stat_name}"] = v

    replicas = A.broker_replica_counts(state).to(torch.float32)
    leaders = A.broker_leader_counts(state).to(torch.float32)
    for key, val in (("replicas", replicas), ("leaders", leaders)):
        for stat_name, v in _masked_stats(val, alive).items():
            out[f"{key}_{stat_name}"] = v

    if balance_percentage is not None:
        avg = out["util_avg"][None, :]
        pct = torch.as_tensor(balance_percentage, dtype=torch.float32, device=load.device)
        within = (load <= avg * pct) & (load >= avg * (2.0 - pct))
        out["num_balanced_by_resource"] = (within & mask2).sum(dim=0, dtype=torch.int32)

    out["num_alive_brokers"] = alive.sum(dtype=torch.int32)
    out["total_replicas"] = state.replica_valid.sum(dtype=torch.int32)
    return out


def utilization_std(state: ClusterArrays, resource: Resource) -> torch.Tensor:
    """Std-dev of one resource's utilization over alive brokers."""
    load = A.broker_load(state)[:, resource]
    return _masked_stats(load, state.broker_alive)["std"]
