"""Multi-tenant fleet controller (port of ``cruise_control_tpu.fleet``): N
clusters, one batched probe and one batched solve per group a tick."""

from cruise_control_tpu_torch.fleet.controller import (
    RESERVED_TENANT_NAMES,
    FleetConfig,
    FleetController,
    adopt_legacy_namespace,
)

__all__ = [
    "FleetConfig",
    "FleetController",
    "RESERVED_TENANT_NAMES",
    "adopt_legacy_namespace",
]
