"""Name/index maps tying the port's tensor axes back to cluster names.

The port's own copy of the ``IndexMaps`` / ``TopicPartition`` types of
``cruise_control_tpu/model/cluster.py``; the ingest-side ``ClusterModel``
stays in the JAX package for now.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

TopicPartition = Tuple[str, int]


@dataclasses.dataclass
class IndexMaps:
    """Dense-index dictionaries tying ClusterArrays axes back to names/ids."""

    broker_ids: List[int]                    # axis B -> broker id
    broker_index: Dict[int, int]
    rack_names: List[str]
    rack_index: Dict[str, int]
    host_names: List[str]
    host_index: Dict[str, int]
    topic_names: List[str]
    topic_index: Dict[str, int]
    partitions: List[TopicPartition]         # axis P -> (topic, partition)
    partition_index: Dict[TopicPartition, int]
    replicas: List[Tuple[TopicPartition, int]]   # axis R -> (tp, broker_id)
    disks: List[Tuple[int, str]]             # axis D -> (broker_id, logdir)
    disk_index: Dict[Tuple[int, str], int]
