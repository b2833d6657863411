"""One position pass of the kafka-assigner placement: the CUDA kernel and its
plain version.

The kafka-assigner mode (:mod:`cruise_control_tpu_torch.analyzer.kafka_assigner`)
places replicas position by position.  Within a position it walks the
partitions in index order and gives each the eligible broker with the fewest
replicas already placed at that position (ties to the lowest id), barring the
brokers the partition already holds at earlier positions and their racks; when
every rack is barred it drops the rack rule but never the broker rule.  The
JAX package runs each pass as one ``lax.scan`` over partitions
(``cruise_control_tpu/analyzer/kafka_assigner.py:111``); here a pass is one
launch of ``csrc/even_assign.cu`` (its note gives the design and the bound).

:func:`even_assign` updates ``counts`` and column ``pos`` of ``chosen`` in
place.  A stack of clusters (every buffer with a leading lane axis, the
solver's lane form) is one launch with one block a lane; its plain version
walks the lanes.  CPU tensors take :func:`even_assign_plain`, the same greedy as a
Python loop over partitions; CUDA tensors launch the kernel or raise.  Each
launch adds one to :data:`LAUNCHES` and reports to the profiler's census
(each plain pass on the CPU too), with the work reckoned from the shape: two
argmins over the brokers a partition, and the bytes of the counts, the
earlier picks, the picks written and the per-partition and per-broker
inputs, each once.  The kernel keeps no state between
launches (no scratch: every buffer it touches is the caller's), so the launch
itself needs no lock; the count does, since the server's request threads solve
at once and ``+= 1`` is a read, then a write.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.obs.profiler import PROFILER
from cruise_control_tpu_torch.obs.recorder import compile_events_since, compile_mark
from cruise_control_tpu_torch.ops import _build

#: kernel launches since :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"even_assign": 0}

_MAX_BROKERS = 64 * 1024
_LIB = None
_PACK = struct.Struct("12q").pack
#: guards :data:`LAUNCHES` against host threads that launch at once
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCHES["even_assign"] = 0


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("even_assign")
        lib.cc_even_assign.argtypes = [ctypes.c_char_p]
        lib.cc_even_assign.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _census(partitions: int, brokers: int, pos: int, wall_s: float, events=(), lanes: int = 1) -> None:
    """Report one pass to the profiler's census (the smoke's bound formula)."""
    def describe():
        nbytes = 8 * brokers + 4 * partitions * pos + 4 * partitions + 5 * partitions + 5 * brokers
        where = f"{partitions} partitions x {brokers} brokers, position {pos}"
        if lanes > 1:
            where = f"{lanes} lanes of {where}"
        return where, 2 * partitions * brokers * lanes, nbytes * lanes

    key = ("even_assign", partitions, brokers, pos) + ((lanes,) if lanes > 1 else ())
    PROFILER.on_call("even_assign", key, describe, wall_s, events)


def _check(counts, chosen, pos, rf, excluded_part, broker_rack, eligible) -> None:
    P, max_rf = chosen.shape[-2:]
    B = counts.shape[-1]
    lead = tuple(chosen.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"even_assign: at most one lane axis, got chosen of shape {tuple(chosen.shape)}")
    for name, t, dtype, shape in (
        ("counts", counts, torch.int32, lead + (B,)),
        ("chosen", chosen, torch.int32, lead + (P, max_rf)),
        ("rf", rf, torch.int32, lead + (P,)),
        ("excluded_part", excluded_part, torch.bool, lead + (P,)),
        ("broker_rack", broker_rack, torch.int32, lead + (B,)),
        ("eligible", eligible, torch.bool, lead + (B,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != counts.device:
            raise ValueError(
                f"even_assign: {name} must be {dtype} {shape} on {counts.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"even_assign: {name} must be contiguous")
    if not 0 <= pos < max_rf:
        raise ValueError(f"even_assign: position {pos} outside [0, {max_rf})")
    if not 0 < B <= _MAX_BROKERS:
        raise ValueError(f"even_assign: {B} brokers outside (0, {_MAX_BROKERS}]")


def even_assign_plain(
    counts: torch.Tensor, chosen: torch.Tensor, pos: int, rf: torch.Tensor,
    excluded_part: torch.Tensor, broker_rack: torch.Tensor, eligible: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on CPU tensors: the greedy as a Python loop over
    partitions, in place (numpy views share the tensors' memory); a stack's
    lanes one after another."""
    if chosen.dim() == 3:
        for i in range(chosen.shape[0]):
            even_assign_plain(counts[i], chosen[i], pos, rf[i], excluded_part[i], broker_rack[i], eligible[i])
        return counts, chosen
    cnt, ch = counts.numpy(), chosen.numpy()
    rack, el = broker_rack.numpy(), eligible.numpy()
    active = (rf.numpy() > pos) & ~excluded_part.numpy()
    ids = np.arange(cnt.shape[0])
    big = np.iinfo(np.int32).max
    for p in range(ch.shape[0]):
        if not active[p]:
            ch[p, pos] = -1
            continue
        relaxed = el.copy()
        rack_free = np.ones_like(el)
        for b in ch[p, :pos]:
            relaxed &= ids != b
            if b >= 0:
                rack_free &= rack != rack[b]
        strict = relaxed & rack_free
        pick = -1
        for mask in (strict, relaxed):
            c = np.where(mask, cnt, big)
            b = int(np.argmin(c))    # the first of the least counts: (count, id) order
            if c[b] < big:
                pick = b
                break
        if pick >= 0:
            cnt[pick] += 1
        ch[p, pos] = pick
    return counts, chosen


def even_assign_cuda(
    counts: torch.Tensor, chosen: torch.Tensor, pos: int, rf: torch.Tensor,
    excluded_part: torch.Tensor, broker_rack: torch.Tensor, eligible: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: one launch on the current stream, in place."""
    _check(counts, chosen, pos, rf, excluded_part, broker_rack, eligible)
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"even_assign_cuda takes CUDA tensors, got {dev}")
    P, max_rf = chosen.shape[-2:]
    lanes = chosen.shape[0] if chosen.dim() == 3 else 1
    t0 = time.perf_counter()
    mark = compile_mark() if _LIB is None else None   # the first call builds
    lib = _library()
    with torch.cuda.device(dev.index):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cc_even_assign(_PACK(
            counts.data_ptr(), chosen.data_ptr(), rf.data_ptr(), excluded_part.data_ptr(),
            broker_rack.data_ptr(), eligible.data_ptr(), P, counts.shape[-1], max_rf, pos, stream, lanes,
        ))
    if err != 0:
        raise RuntimeError(f"even_assign kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES["even_assign"] += 1
    _census(P, counts.shape[-1], pos, time.perf_counter() - t0,
            compile_events_since(mark) if mark is not None else (), lanes)
    return counts, chosen


def even_assign(
    counts: torch.Tensor, chosen: torch.Tensor, pos: int, rf: torch.Tensor,
    excluded_part: torch.Tensor, broker_rack: torch.Tensor, eligible: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place position ``pos`` of every partition (see the module docstring).

    counts: i32[B] replicas already at this position per broker (updated);
    chosen: i32[P, maxRF] brokers picked so far, -1 unassigned (column ``pos``
    written); rf: i32[P] replicas per partition; excluded_part: bool[P];
    broker_rack: i32[B]; eligible: bool[B] possible destinations.  A stack
    passes each with a leading lane axis ``[S, ...]``, all contiguous."""
    if counts.device.type == "cpu":
        _check(counts, chosen, pos, rf, excluded_part, broker_rack, eligible)
        t0 = time.perf_counter()
        out = even_assign_plain(counts, chosen, pos, rf, excluded_part, broker_rack, eligible)
        _census(chosen.shape[-2], counts.shape[-1], pos, time.perf_counter() - t0,
                lanes=chosen.shape[0] if chosen.dim() == 3 else 1)
        return out
    if counts.device.type == "cuda":
        return even_assign_cuda(counts, chosen, pos, rf, excluded_part, broker_rack, eligible)
    raise ValueError(f"even_assign: unsupported device {counts.device}")
