"""PyTorch/CUDA port of ``cruise_control_tpu``: the goal-based rebalance solver.

The package mirrors the JAX package's layout (``core/``, ``model/``, ``ops/``,
``analyzer/``, ``synthetic.py``) and public names, written as plain PyTorch:
dataclasses of tensors and functions on tensors.  Every entry point takes a
``device``; it defaults to ``cuda`` and raises when no GPU is present, so a run
never falls back to the CPU silently (pass ``device="cpu"`` to ask for it).

The per-broker segment sums run through the hand-written CUDA kernel in
``csrc/segment_sum.cu`` on the card (``ops.segments``).  The JAX package is the
reference this port is held against; this package imports nothing from it.
"""
