"""The solver's lane form: one round of a phase for every lane of a stack.

The JAX package solves a stack of clusters (``model.arrays.stack_arrays``)
as one program: ``_vmap_step`` lifts each goal step over the leading lane
axis with ``jax.vmap`` (``cruise_control_tpu/analyzer/optimizer.py:491``).
The port lifts the same per-cluster code with ``torch.func.vmap``, its
PyTorch counterpart, so one code serves one state and a stack, and every
lane computes exactly what it computes alone:

* the snapshot is taken outside the lift, in its lane form (one segment-sum
  call for every lane, ``analyzer.context.take_snapshot`` over a stack);
* the round -- proposal, acceptance against the prior goals, admission and
  the apply -- runs under ``vmap``: every PyTorch operation batches over the
  lanes, each lane's sorts, scans, ties and scatters stay its own, and the
  kernel wrapper it calls (``ops.segments.segment_sums``) is an operator
  whose batching rule makes the lanes' calls ONE call of the kernels;
* a lane whose phase has ended (``live`` false) is frozen: its admitted set
  is masked to nothing, so the apply writes none of its rows.  That is the
  JAX batched ``while_loop``'s select of the old carry, lane by lane.

vmap's per-lane fallback (an operator without a batching rule, run lane
after lane) is switched off while a lift runs, and restored after it: such
an operator raises instead of quietly walking the lanes.  The flag is one
for the whole process, and lifts run on several threads at once (the
user-task pool's deep SIMULATEs, the fleet's re-optimize): a lock and a
count of the lifts running keep it off until the last of them returns, and
that one restores it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from cruise_control_tpu_torch.analyzer.acceptance import accept_all
from cruise_control_tpu_torch.analyzer.context import GoalContext, Snapshot
from cruise_control_tpu_torch.analyzer.moves import admit, apply_moves, move_effects
from cruise_control_tpu_torch.model.arrays import ClusterArrays

I32 = torch.int32

#: the state fields a round may write (``moves.apply_moves``)
WRITTEN = ("replica_broker", "replica_disk", "partition_leader")

#: guards the fallback flag: the lifts running, and the flag's value before the first
_FALLBACK_LOCK = threading.Lock()
_fallback = {"depth": 0, "was": True}


def _tensor_fields(obj) -> Dict[str, torch.Tensor]:
    return {
        f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    }


def _rebuild(template, tensors: Dict[str, torch.Tensor]):
    """``template`` (a dataclass whose tensors have a lane axis) with one
    lane's ``tensors`` in their place, inside the lift."""
    return dataclasses.replace(template, **tensors)


def lift(fn: Callable, states: ClusterArrays, snap: Optional[Snapshot], *per_lane):
    """``fn(state, snap, *args)`` on every lane of ``states`` (and of its
    lane-form ``snap``, or None) as ONE lifted program: each output gains a
    leading lane axis.  ``per_lane`` tensors are split along their first
    axis, one element a lane.  vmap's per-lane fallback is off: an operator
    without a batching rule raises.  The first lift in saves and clears the
    process's fallback flag and the last one out restores it, so lifts on
    other threads stay without the fallback and other ``vmap`` users in the
    process are not affected once none runs."""
    state_t = _tensor_fields(states)
    snap_t = {} if snap is None else _tensor_fields(snap)

    def one(state_t, snap_t, *args):
        return fn(_rebuild(states, state_t), None if snap is None else _rebuild(snap, snap_t), *args)

    functorch = torch._C._functorch
    with _FALLBACK_LOCK:
        if _fallback["depth"] == 0:
            _fallback["was"] = functorch._is_vmap_fallback_enabled()
            functorch._set_vmap_fallback_enabled(False)
        _fallback["depth"] += 1
    try:
        return vmap(one)(state_t, snap_t, *per_lane)
    finally:
        with _FALLBACK_LOCK:
            _fallback["depth"] -= 1
            if _fallback["depth"] == 0:
                functorch._set_vmap_fallback_enabled(_fallback["was"])


def lane_round(
    states: ClusterArrays, ctx: GoalContext, snap: Snapshot, it: torch.Tensor, live: torch.Tensor, *,
    round_fn: Callable, prior_mask: np.ndarray, admit_mask: np.ndarray,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One round of ``round_fn`` on every lane of ``states`` (its lane-form
    snapshot ``snap``, each lane's round number ``it`` [S] as its salt):
    ``(written fields [S, ...], moves applied [S], windows [S])``.  A lane
    with ``live`` false applies nothing."""

    def one(state, sn, it, live):
        moves = round_fn(state, ctx, sn, prior_mask, it)
        eff = move_effects(state, moves, sn)
        ok = moves.valid & accept_all(state, ctx, sn, moves, eff, prior_mask)
        keep = admit(state, ctx, sn, moves, ok, eff, admit_mask) & live
        new = apply_moves(state, moves, keep)
        windows = moves.windows.to(I32) if moves.windows is not None else torch.ones((), dtype=I32, device=it.device)
        return {k: getattr(new, k) for k in WRITTEN}, keep.sum(dtype=I32), windows

    return lift(one, states, snap, it, live)
