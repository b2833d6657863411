"""What-if scenario planner (port of ``cruise_control_tpu.sim``).

* :mod:`.scenario` -- the declarative :class:`Scenario` and the padded,
  bucketed batch of scenarios (one device copy per stacked leaf);
* :mod:`.batch` -- :func:`fast_sweep` (violations, balancedness,
  satisfiability and movement floor of each scenario as it is) and
  :func:`deep_sweep` (the full goal walk per scenario through
  ``GoalOptimizer.batched_optimize``);
* :mod:`.planner` -- :func:`plan_capacity`, the batched bisection for the
  minimum broker count under load x f, with optional full-solver
  verification of the edge.

Every entry that puts tensors on a device takes ``device``: ``cuda`` unless
``device="cpu"``, and without a GPU it raises.
"""

from cruise_control_tpu_torch.sim.scenario import (
    Scenario,
    ScenarioBatch,
    apply_scenario,
    broker_bucket,
    build_batch,
)
from cruise_control_tpu_torch.sim.batch import (
    ScenarioVerdict,
    SweepResult,
    deep_sweep,
    fast_sweep,
)
from cruise_control_tpu_torch.sim.planner import CapacityPlan, plan_capacity

__all__ = [
    "CapacityPlan",
    "Scenario",
    "ScenarioBatch",
    "ScenarioVerdict",
    "SweepResult",
    "apply_scenario",
    "broker_bucket",
    "build_batch",
    "deep_sweep",
    "fast_sweep",
    "plan_capacity",
]
