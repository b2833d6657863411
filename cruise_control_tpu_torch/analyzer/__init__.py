"""Analyzer layer: the PyTorch GoalOptimizer (port of ``cruise_control_tpu.analyzer``)."""

from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import GoalContext
from cruise_control_tpu_torch.analyzer.optimizer import (
    GoalOptimizer,
    GoalReport,
    MovementStats,
    OptimizationFailure,
    OptimizerResult,
)
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal, diff

__all__ = [
    "BalancingConstraint",
    "GoalContext",
    "GoalOptimizer",
    "GoalReport",
    "MovementStats",
    "OptimizationFailure",
    "OptimizerResult",
    "ExecutionProposal",
    "diff",
]
