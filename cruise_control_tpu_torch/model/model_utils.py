"""CPU estimation heuristics.

Port of ``cruise_control_tpu/model/model_utils.py`` (the reference's
``ModelUtils.java``): a replica's CPU is apportioned between leadership and
followership with three weights -- leader-bytes-in (a=0.7), leader-bytes-out
(b=0.15), follower-bytes-in (c=0.15).  A follower of a partition whose leader
shows ``(in, out, cpu)`` is estimated to burn::

    follower_cpu = cpu * (c * in) / (a * in + b * out)

The functions work elementwise on python floats, numpy arrays and torch
tensors, dispatching on the input type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CpuModelWeights:
    leader_bytes_in: float = 0.7
    leader_bytes_out: float = 0.15
    follower_bytes_in: float = 0.15


DEFAULT_CPU_WEIGHTS = CpuModelWeights()


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def follower_cpu_from_leader_load(
    leader_bytes_in_rate,
    leader_bytes_out_rate,
    leader_cpu_util,
    weights: CpuModelWeights = DEFAULT_CPU_WEIGHTS,
):
    """Estimated CPU a follower replica burns, from its leader's load: zero when
    the leader moves no bytes, else the follower-bytes-in share of the leader's
    weighted byte throughput (ModelUtils.getFollowerCpuUtilFromLeaderLoad)."""
    a, b, c = weights.leader_bytes_in, weights.leader_bytes_out, weights.follower_bytes_in
    denom = a * leader_bytes_in_rate + b * leader_bytes_out_rate
    positive = denom > 0.0
    safe = _where(positive, denom, 1.0)
    return _where(positive, leader_cpu_util * (c * leader_bytes_in_rate) / safe, 0.0)


def leader_cpu_from_follower_load(
    leader_bytes_in_rate,
    leader_bytes_out_rate,
    follower_cpu_util,
    weights: CpuModelWeights = DEFAULT_CPU_WEIGHTS,
):
    """Inverse estimate: CPU the replica would burn as leader, given follower CPU."""
    a, b, c = weights.leader_bytes_in, weights.leader_bytes_out, weights.follower_bytes_in
    denom = c * leader_bytes_in_rate
    positive = denom > 0.0
    safe = _where(positive, denom, 1.0)
    num = a * leader_bytes_in_rate + b * leader_bytes_out_rate
    return _where(positive, follower_cpu_util * num / safe, 0.0)
