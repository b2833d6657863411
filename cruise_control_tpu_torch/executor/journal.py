"""Proposal journal encoding.

Port of ``proposal_to_record`` / ``proposal_from_record`` from
``cruise_control_tpu/executor/journal.py``: the wire form of one
:class:`~cruise_control_tpu_torch.analyzer.proposals.ExecutionProposal`,
shared by the execution journal and the controller's standing-proposal-set
journal (``controller/standing.py``), so both replay one encoding -- and a
journal either package wrote replays in the other.  The execution journal
itself (``ExecutionJournal``, task records) is not ported yet.
"""

from __future__ import annotations

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal


def proposal_to_record(p: ExecutionProposal) -> dict:
    """One proposal in journal wire form."""
    return {
        "tp": list(p.tp),
        "partition_size": p.partition_size,
        "old_leader": p.old_leader,
        "old_replicas": list(p.old_replicas),
        "new_replicas": list(p.new_replicas),
    }


def proposal_from_record(d: dict) -> ExecutionProposal:
    return ExecutionProposal(
        tp=(d["tp"][0], int(d["tp"][1])),
        partition_size=float(d["partition_size"]),
        old_leader=None if d["old_leader"] is None else int(d["old_leader"]),
        old_replicas=tuple(int(b) for b in d["old_replicas"]),
        new_replicas=tuple(int(b) for b in d["new_replicas"]),
    )
