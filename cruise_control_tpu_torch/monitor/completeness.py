"""Model completeness requirements.

Port of ``cruise_control_tpu/monitor/completeness.py`` (copied whole); the
counterpart of ``monitor/ModelCompletenessRequirements.java``: a model consumer
(goal, detector, endpoint) states how many valid windows and what fraction of
monitored partitions it needs; requirements combine via ``weaker``/``stronger``
exactly as the reference does when merging per-goal requirements.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelCompletenessRequirements:
    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.0
    include_all_topics: bool = False

    def weaker(self, other: "ModelCompletenessRequirements") -> "ModelCompletenessRequirements":
        """Relax to the weaker of both (ModelCompletenessRequirements.weaker)."""
        return ModelCompletenessRequirements(
            min(self.min_required_num_windows, other.min_required_num_windows),
            min(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage,
            ),
            self.include_all_topics and other.include_all_topics,
        )

    def stronger(self, other: "ModelCompletenessRequirements") -> "ModelCompletenessRequirements":
        return ModelCompletenessRequirements(
            max(self.min_required_num_windows, other.min_required_num_windows),
            max(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage,
            ),
            self.include_all_topics or other.include_all_topics,
        )


class NotEnoughValidSnapshotsError(Exception):
    """Monitor cannot satisfy the completeness requirements yet."""
