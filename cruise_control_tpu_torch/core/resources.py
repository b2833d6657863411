"""Resource axes of the cluster load model.

TPU-native counterpart of the reference's resource taxonomy
(``cruise-control/src/main/java/com/linkedin/kafka/cruisecontrol/common/Resource.java:20``):
four balanceable resources (CPU, NETWORK_INBOUND, NETWORK_OUTBOUND, DISK), each with a
host/broker-level flag and an epsilon policy for float comparisons at ~800k-replica sums
(Resource.java:29).  Here the resources are *array axes*: every per-replica /
per-broker load tensor carries a trailing dimension of size ``NUM_RESOURCES`` indexed by
these constants, so goal kernels are written once and vmapped over the resource axis.

The derived 8-row space used by the utilization matrix
(``model/RawAndDerivedResource.java``) is represented by ``DerivedResource``.
"""

from __future__ import annotations

import enum
from typing import Tuple


class Resource(enum.IntEnum):
    """Balanceable resource; value is the array-axis index."""

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3

    @property
    def is_host_resource(self) -> bool:
        # Reference: CPU and NW are host-level, DISK is broker-level
        # (Resource.java: _isHostResource / _isBrokerResource flags).
        return self in (Resource.CPU, Resource.NW_IN, Resource.NW_OUT)

    @property
    def is_broker_resource(self) -> bool:
        return self in (Resource.CPU, Resource.DISK, Resource.NW_IN, Resource.NW_OUT)

    @property
    def epsilon_scale(self) -> float:
        """Relative epsilon used when comparing summed utilizations.

        Mirrors Resource.java's per-resource epsilon: large replica counts
        accumulate float error, so equality checks are scaled by value magnitude.
        """
        return 1e-6 if self is Resource.CPU else 1e-5

    def epsilon(self, v1: float, v2: float) -> float:
        return self.epsilon_scale * max(abs(v1), abs(v2), 1.0)


NUM_RESOURCES: int = 4

#: Resources whose utilization depends on leadership (leadership movement changes
#: broker load for these; follower replicas contribute ~nothing to NW_OUT and a
#: reduced CPU share).  Reference: ResourceDistributionGoal.java:380 moves
#: leadership first for NW_OUT/CPU.
LEADERSHIP_AFFECTED: Tuple[Resource, ...] = (Resource.CPU, Resource.NW_OUT)


class DerivedResource(enum.IntEnum):
    """Rows of the dense utilization matrix.

    Mirrors ``model/RawAndDerivedResource.java`` (8-row derived space used by
    ``ClusterModel.utilizationMatrix()`` at ClusterModel.java:1332).
    """

    DISK = 0
    CPU = 1
    LEADER_NW_IN = 2
    FOLLOWER_NW_IN = 3
    NW_OUT = 4
    PNW_OUT = 5  # potential NW_OUT: outbound if every replica became leader
    LEADER_REPLICAS = 6
    REPLICAS = 7


NUM_DERIVED_RESOURCES: int = 8
