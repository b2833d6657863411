"""Executor engine errors.

Port of ``OngoingExecutionError`` from
``cruise_control_tpu/executor/engine.py``: the continuous controller's drain
catches it when another execution holds the executor.  The engine itself is
not ported yet; the controller reaches an executor through its facade
(``cruise_control.executor.execute_proposals``).
"""


class OngoingExecutionError(Exception):
    """An execution is already in progress (Executor.executeProposals rejects)."""
