"""``analyzer.lanes.lift`` on two threads at once.

vmap's per-lane fallback flag is one for the whole process.  A lift clears
it so that an operator without a batching rule raises instead of walking
the lanes; lifts run on several threads at once (the user-task pool's deep
SIMULATEs, the fleet's re-optimize).  Here two lifts overlap (a barrier
inside each lifted function), the first returns while the second is still
inside its lift, and the second must still find the fallback off; after
both return, whichever way each ended, the flag is back at the value it
had before the first began.
"""

from __future__ import annotations

import threading

import pytest
import torch

from cruise_control_tpu_torch.analyzer.lanes import lift
from cruise_control_tpu_torch.model.arrays import stack_arrays
from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
from tests.torch_port_helpers import SMALL20, one_intra_op_thread  # noqa: F401 (autouse: one thread)

_WAIT_S = 60.0


@pytest.fixture(scope="module")
def stack():
    return stack_arrays([generate(SyntheticSpec(**dict(SMALL20, seed=s)), device="cpu")[0] for s in (0, 3)])


@pytest.fixture
def fallback_at():
    """Sets the process's fallback flag for a test and puts back the value it had."""
    functorch = torch._C._functorch
    before = functorch._is_vmap_fallback_enabled()

    def set_to(value: bool) -> None:
        functorch._set_vmap_fallback_enabled(value)

    yield set_to
    functorch._set_vmap_fallback_enabled(before)


def _unbatchable(state):
    out = state.replica_broker.clone()
    out.scatter_(0, torch.zeros(1, dtype=torch.int64), 7)   # no batching rule for scatter_.value
    return out


def _overlapping_lifts(stack, second_catches: bool):
    """Two lifts on two threads, both inside their lifted functions at once
    (a barrier); the first raises out of its lift, and the second runs an
    operator without a batching rule only after the first has returned.
    With ``second_catches`` the second catches the error inside its lifted
    function and its lift returns; otherwise it raises out of the lift too.
    Returns what each thread saw."""
    inside = threading.Barrier(2, timeout=_WAIT_S)
    first_out = threading.Event()
    seen = {}

    def first():
        def fn(state, _):
            inside.wait()
            return _unbatchable(state)

        try:
            lift(fn, stack, None)
            seen["first"] = "returned"
        except RuntimeError as exc:
            seen["first"] = str(exc)
        finally:
            first_out.set()

    def second():
        def fn(state, _):
            inside.wait()
            assert first_out.wait(_WAIT_S)
            if not second_catches:
                return _unbatchable(state)
            try:
                _unbatchable(state)
                seen["second_inside"] = "walked the lanes"
            except RuntimeError as exc:
                seen["second_inside"] = str(exc)
            return state.replica_broker + 1

        try:
            out = lift(fn, stack, None)
            seen["second"] = ("returned", tuple(out.shape))
        except RuntimeError as exc:
            seen["second"] = str(exc)

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(_WAIT_S)
    assert not any(t.is_alive() for t in threads)
    return seen


@pytest.mark.parametrize("initial", [True, False], ids=["fallback-on", "fallback-off"])
@pytest.mark.parametrize("second_catches", [False, True], ids=["both-raise", "second-returns"])
def test_two_overlapping_lifts_keep_the_fallback_off_and_restore_it(stack, fallback_at, initial, second_catches):
    fallback_at(initial)
    seen = _overlapping_lifts(stack, second_catches)
    assert "vmap fallback" in seen["first"], seen
    if second_catches:
        assert "vmap fallback" in seen["second_inside"], seen
        assert seen["second"] == ("returned", tuple(stack.replica_broker.shape)), seen
    else:
        assert "vmap fallback" in seen["second"], seen
    assert torch._C._functorch._is_vmap_fallback_enabled() == initial


def test_a_lift_after_overlapping_ones_still_refuses_the_fallback(stack, fallback_at):
    fallback_at(True)
    _overlapping_lifts(stack, second_catches=True)
    with pytest.raises(RuntimeError, match="vmap fallback"):
        lift(lambda state, _: _unbatchable(state), stack, None)
    assert torch._C._functorch._is_vmap_fallback_enabled()
