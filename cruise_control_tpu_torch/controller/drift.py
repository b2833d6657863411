"""Drift detection: is the live cluster far enough from the last solve?

Port of ``cruise_control_tpu/controller/drift.py``.  The measure is the
per-goal violation vector (one probe of the candidate state, fetched to the
host); this module is the host math over it.  The baseline is the last
solve's OUTPUT residual, so violations a bounded solve could not fix never
re-trigger a tick: only violations rising above what the last answer left
behind count as drift.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from cruise_control_tpu_torch.analyzer import goals_base as G
from cruise_control_tpu_torch.analyzer.optimizer import (
    MAX_BALANCEDNESS_SCORE,
    balancedness_cost_by_goal,
)


@dataclasses.dataclass
class DriftReport:
    """One drift evaluation (host math over a fetched violation vector)."""

    #: sum of max(0, violations_now - violations_at_last_solve) over the goal
    #: list: the threshold-gated score
    score: float
    #: the hard-goal share of ``score``
    hard_score: float
    #: goals violated NOW (drifted or still standing): the tick's work list
    violated_goal_ids: Tuple[int, ...]
    violated_goals: List[str]
    #: weighted balancedness of the current state, in [0, 100]
    balancedness: float
    #: balancedness at the last solve minus now (positive = got worse)
    balancedness_drop: float


def evaluate_drift(
    viol_now,
    viol_at_solve,
    goal_ids: Sequence[int],
    hard_ids: Sequence[int],
) -> DriftReport:
    """Host math over two violation vectors indexed by goal id (numpy arrays
    or sequences; ``viol_at_solve`` may be None: no baseline)."""
    hard = set(hard_ids)
    score = 0.0
    hard_score = 0.0
    violated: List[int] = []
    for g in goal_ids:
        now = float(viol_now[g])
        base = float(viol_at_solve[g]) if viol_at_solve is not None else 0.0
        d = max(0.0, now - base)
        score += d
        if g in hard:
            hard_score += d
        if now > 0:
            violated.append(g)

    costs = balancedness_cost_by_goal(list(goal_ids), hard)

    def _balancedness(viol) -> float:
        if viol is None:
            return MAX_BALANCEDNESS_SCORE
        s = MAX_BALANCEDNESS_SCORE
        for g in goal_ids:
            if float(viol[g]) > 0:
                s -= costs[g]
        return s

    bal_now = _balancedness(viol_now)
    bal_then = _balancedness(viol_at_solve)
    return DriftReport(
        score=score,
        hard_score=hard_score,
        violated_goal_ids=tuple(violated),
        violated_goals=[G.GOAL_NAMES[g] for g in violated],
        balancedness=bal_now,
        balancedness_drop=bal_then - bal_now,
    )
