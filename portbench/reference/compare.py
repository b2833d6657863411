"""The comparison that decides ``correct``: each proposal's claims against the reference.

For every proposal the window delivered, the program's claims (its reported
violation count of each goal, its movement, and the sums its snapshot makes
of the delivered placement) are set against what :mod:`.judge` works out from
the inputs and the placement.  Each comparison gives one number; the run's
number is the worst proposal's, and each is held to its limit (a cell's
``portbench/cells/<cell>.json``):

* ``placement_faults``: structural faults of the placement (exact: 0);
* ``hard_violations``: the hard goals of the list left clearly violated, by
  the reference's strict count (0: a proposal must meet them);
* ``violation_gap``: how far a goal's reported count lies outside the
  reference's ``[strict, lenient]`` counts (exact: 0);
* ``count_gap``: the largest difference of a replica, leader, rack or topic
  count the program's snapshot made from the reference's (exact: 0); for a
  stack, over both of its snapshots (in lane form and inside the lift);
* ``load_gap``: the largest gap of a per-broker load sum (the four
  resources, potential NW-out, leader bytes-in) from the reference's float64
  sum, relative to the larger of that broker's sum and the mean over brokers;
* ``move_count_gap``: the difference in replicas and leaders moved (exact: 0);
* ``data_moved_gap``: the relative gap of the reported data to move from the
  reference's exact sum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from portbench.reference import judge

NUMBERS = (
    "placement_faults", "hard_violations", "violation_gap", "count_gap",
    "load_gap", "move_count_gap", "data_moved_gap",
)


@dataclasses.dataclass
class Claim:
    """What the program claims of one delivered proposal, in plain numbers."""

    violations: Dict[str, float]
    inter_broker_moves: int
    data_moved: float
    leadership_moves: int
    #: the program's snapshot sums of the delivered placement (None: not read)
    sums: Optional[judge.Sums] = None
    #: a stack's same sums taken lane by lane inside the program's lift (None: a single solve)
    lifted_sums: Optional[judge.Sums] = None


@dataclasses.dataclass
class Judged:
    """The reference's reading of one proposal and its compared numbers."""

    numbers: Dict[str, float]
    balancedness: float
    data_moved: float
    violations: Dict[str, int]


def _load_gap(p: judge.Sums, r: judge.Sums) -> float:
    gap = 0.0
    cols_p = [p.broker_load[:, k] for k in range(4)] + [p.potential_nw_out, p.leader_nw_in]
    cols_r = [r.broker_load[:, k] for k in range(4)] + [r.potential_nw_out, r.leader_nw_in]
    for a, b in zip(cols_p, cols_r):
        a = np.asarray(a, np.float64)
        scale = np.maximum(np.abs(b), max(float(np.abs(b).mean()), 1e-30))
        gap = max(gap, float((np.abs(a - b) / scale).max(initial=0.0)))
    return gap


def _count_gap(p: judge.Sums, r: judge.Sums) -> int:
    gap = 0
    for name in ("replica_counts", "leader_counts", "rack_counts", "topic_counts", "topic_leader_counts"):
        a, b = getattr(p, name), getattr(r, name)
        if a is None and b is None:
            continue
        if a is None or b is None or np.shape(a) != np.shape(b):
            return 2**31 - 1
        gap = max(gap, int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).max(initial=0)))
    return gap


def judge_proposal(
    inp: Mapping, placement: judge.Placement, claim: Claim, goals: Sequence[str],
    hard: Sequence[str], constraint: Mapping, heavy: bool,
) -> Judged:
    """The compared numbers of one proposal, and the reference's quality
    readings (balancedness over ``goals``, data to move)."""
    ref = judge.sums(inp, placement, heavy)
    counts = judge.violations(inp, placement, goals, constraint, ref)
    moved = judge.movement(inp, placement)
    read = [s for s in (claim.sums, claim.lifted_sums) if s is not None]
    gap = 0.0
    for g in goals:
        v = float(claim.violations.get(g, np.inf))
        _, strict, lenient = counts[g]
        gap = max(gap, strict - v, v - lenient)
    numbers = {
        "placement_faults": judge.placement_faults(inp, placement),
        "hard_violations": sum(counts[g][1] for g in goals if g in hard),
        "violation_gap": gap,
        "count_gap": max((_count_gap(s, ref) for s in read), default=2**31 - 1),
        "load_gap": max((_load_gap(s, ref) for s in read), default=float("inf")),
        "move_count_gap": abs(claim.inter_broker_moves - moved.inter_broker_moves)
        + abs(claim.leadership_moves - moved.leadership_moves),
        "data_moved_gap": abs(claim.data_moved - moved.data_moved) / max(moved.data_moved, 1.0),
    }
    violated = [g for g in goals if counts[g][0] > 0]
    return Judged(
        numbers=numbers,
        balancedness=judge.balancedness(goals, hard, violated),
        data_moved=moved.data_moved,
        violations={g: counts[g][0] for g in goals},
    )


def worst(judged: Sequence[Judged]) -> Dict[str, float]:
    """Each number at its worst over the proposals."""
    return {k: max(float(j.numbers[k]) for j in judged) for k in NUMBERS}


def failed(j: Judged, limits: Mapping[str, float]) -> bool:
    return any(float(j.numbers[k]) > float(limits[k]) for k in NUMBERS)
