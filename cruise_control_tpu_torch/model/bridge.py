"""Build the port's state from plain numpy arrays.

The port never sees a JAX object.  A caller holding the JAX package's
``ClusterArrays`` / ``GoalContext`` turns each field into numpy
(``np.asarray(getattr(obj, f.name))``) and hands the mapping here; the same
path takes clusters assembled by any other numpy producer.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.model.arrays import ClusterArrays

_DTYPES = {
    "replica_partition": torch.int32,
    "replica_broker": torch.int32,
    "replica_disk": torch.int32,
    "replica_valid": torch.bool,
    "base_load": torch.float32,
    "original_broker": torch.int32,
    "partition_topic": torch.int32,
    "partition_leader": torch.int32,
    "leadership_delta": torch.float32,
    "broker_rack": torch.int32,
    "broker_host": torch.int32,
    "broker_capacity": torch.float32,
    "broker_alive": torch.bool,
    "broker_new": torch.bool,
    "broker_demoted": torch.bool,
    "disk_broker": torch.int32,
    "disk_capacity": torch.float32,
    "disk_alive": torch.bool,
}


def _tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def arrays_from_numpy(
    fields: Mapping[str, np.ndarray],
    num_racks: int,
    num_topics: int,
    num_hosts: int,
    device: DeviceLike = None,
) -> ClusterArrays:
    """The port's ``ClusterArrays`` from one numpy array per tensor field."""
    dev = resolve_device(device)
    missing = set(_DTYPES) - set(fields)
    if missing:
        raise ValueError(f"arrays_from_numpy: missing fields {sorted(missing)}")
    return ClusterArrays(
        **{name: _tensor(fields[name], dt, dev) for name, dt in _DTYPES.items()},
        num_racks=int(num_racks),
        num_topics=int(num_topics),
        num_hosts=int(num_hosts),
    )


def arrays_to_numpy(state: ClusterArrays) -> dict:
    """Inverse of :func:`arrays_from_numpy`: one numpy array per tensor field."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in _DTYPES}


def context_from_numpy(
    fields: Mapping[str, np.ndarray],
    constraint: Mapping[str, np.ndarray],
    top_k: int = 8,
    max_active_brokers: int = 256,
    device: DeviceLike = None,
):
    """The port's ``GoalContext`` from numpy masks (``fields``: every context
    field but ``constraint``) and numpy thresholds (``constraint``: every
    ``BalancingConstraint`` field)."""
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.context import GoalContext

    dev = resolve_device(device)
    cons = {}
    for f in dataclasses.fields(BalancingConstraint):
        arr = np.asarray(constraint[f.name])
        dt = torch.int32 if np.issubdtype(arr.dtype, np.integer) else torch.float32
        cons[f.name] = _tensor(arr, dt, dev)
    return GoalContext(
        constraint=BalancingConstraint(**cons),
        excluded_topics=_tensor(fields["excluded_topics"], torch.bool, dev),
        excluded_for_leadership=_tensor(fields["excluded_for_leadership"], torch.bool, dev),
        excluded_for_replica_move=_tensor(fields["excluded_for_replica_move"], torch.bool, dev),
        only_move_immigrants=bool(fields["only_move_immigrants"]),
        triggered_by_violation=bool(fields["triggered_by_violation"]),
        min_leader_topics=_tensor(fields["min_leader_topics"], torch.bool, dev),
        fast_mode=bool(fields["fast_mode"]),
        broker_set_of_broker=_tensor(fields["broker_set_of_broker"], torch.int32, dev),
        broker_set_of_topic=_tensor(fields["broker_set_of_topic"], torch.int32, dev),
        top_k=int(top_k),
        max_active_brokers=int(max_active_brokers),
    )
