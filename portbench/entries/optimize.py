"""Entry ``optimize``: one rebalance proposal a call, ``GoalOptimizer.optimize``.

A call solves one input with the cell's goal list and delivers the proposal
once its final ``replica_broker``, ``replica_disk`` and ``partition_leader``
are on the host (the copy is in the timed path).
"""

from __future__ import annotations

from typing import List, Mapping, Sequence

from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer

from portbench.entries import _program as P


class Entry:
    def __init__(self, config: Mapping, mix: Mapping, program_inputs: Sequence, device) -> None:
        self.goal_ids = P.goal_ids(mix["goals"])
        self.heavy = bool(mix["heavy_goals"])
        self.opt = GoalOptimizer(
            goal_ids=self.goal_ids, hard_ids=P.goal_ids(config["hard_goals"]),
            enable_heavy_goals=self.heavy, device=device,
        )
        self.states = [P.state(inp.lanes[0], device) for inp in program_inputs]
        self.ctx = P.context(program_inputs[0].lanes[0], config, device)

    def call(self, i: int) -> P.Call:
        final, result = self.opt.optimize(self.states[i], self.ctx)
        proposal = P.delivered(
            i, 0, P.host(final.replica_broker), P.host(final.replica_disk),
            P.host(final.partition_leader), result,
        )
        return P.Call(input_index=i, proposals=[proposal], num_host_syncs=int(result.num_host_syncs))

    def claims(self, calls: Sequence[P.Call]) -> List[list]:
        return P.claims(calls, self.states, self.ctx, self.heavy, self.goal_ids, None)
