"""Entry ``batched_optimize``: one batched solve a call, ``GoalOptimizer.batched_optimize``.

A call solves one input's stack of scenarios (``model.arrays.stack_arrays``)
with the cell's goal list, one proposal a lane, each delivered once its
lane's final ``replica_broker``, ``replica_disk`` and ``partition_leader``
are on the host (the copy of the whole stack is in the timed path).
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
        self.stacks = [P.stack(inp.lanes, device) for inp in program_inputs]
        self.proposals_per_call = len(program_inputs[0].lanes)
        self.ctx = P.context(program_inputs[0].lanes[0], config, device)

    def call(self, i: int) -> P.Call:
        final, result = self.opt.batched_optimize(self.stacks[i], self.ctx)
        rb, rd, pl = (P.host(final.replica_broker), P.host(final.replica_disk),
                      P.host(final.partition_leader))
        proposals = [P.delivered(i, k, rb[k], rd[k], pl[k], r) for k, r in enumerate(result.results)]
        return P.Call(input_index=i, proposals=proposals, num_host_syncs=int(result.num_host_syncs))

    def claims(self, calls: Sequence[P.Call]) -> List[list]:
        return P.claims(calls, self.stacks, self.ctx, self.heavy, self.goal_ids, self.proposals_per_call)
