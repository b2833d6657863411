"""Segment sums: the hand-written CUDA kernels and their plain PyTorch version.

The solver's hot reductions are per-broker segment sums over the replica axis:
broker loads, replica/leader counts, potential NW-out, leader bytes-in, the
(broker, topic) and (partition, rack) count tables (``analyzer.context
.take_snapshot``, ``model.arrays``).  The JAX package ran them through two
Pallas TPU kernels, ``segment_sum_pallas`` and ``segment_sum_radix``
(``cruise_control_tpu/ops/segments.py``), one-hot contractions on the MXU.  On
Hopper the same function is ``csrc/segment_sum.cu`` (its note gives the design
and the bound), with two paths, each one host call however many columns it
carries:

* ``segment_sum_f32``, the fixed-order path, for any call with a float32
  column: a stable counting sort groups the rows by segment, then one warp per
  segment adds each column's rows in row order.  Every float sum is the
  left-to-right f32 sum -- bitwise the same on every launch and the same as
  the sequential CPU scatter-add of :func:`segment_sum_plain`.  The solver
  breaks ties by comparing float scores, so an atomic float sum, whose order
  changes from run to run, could flip a tie.
* ``segment_sum_i32``, for integer and bool columns only: each block owns a
  range of segments and adds its rows with shared-memory int32 atomics, exact
  in any order.

:func:`segment_sums` takes several value tensors under one id vector, so the
snapshot's broker-keyed sums cost one call.  A float column sums in float32;
a bool, uint8 or int32 column sums into int32 (a bool column counts its true
rows).  :func:`segment_sum` is the one-tensor form with the JAX contract:
integers keep their dtype and a bool column comes back as "any row".

CPU tensors take the plain version; CUDA tensors launch a kernel or raise.
Each host call that launches adds one to :data:`LAUNCHES` for its path, and
the number of value tensors it carried to :data:`FIELDS`.  A call made while
the device loop captures a round (``ops.graph_loop``) launches nothing then:
it is recorded, and counted once for every replay after the solve fetches its
trip counts, so the counts stay the kernel calls the device ran; those derived
replays are also kept apart in :data:`REPLAYED`.  Each such call
(on the CPU: each call of the plain version where a kernel would have
launched) also reports to the profiler's census
(:meth:`~cruise_control_tpu_torch.obs.profiler.DeviceProfiler.on_call`)
under its path's name, with its shape and the work reckoned from it: ``R *
columns`` additions and the bytes of the ids, the value columns and the
sums, each once.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from cruise_control_tpu_torch.obs.profiler import PROFILER
from cruise_control_tpu_torch.obs.recorder import compile_events_since, compile_mark
from cruise_control_tpu_torch.ops import _build, graph_loop

#: host calls that launched a kernel path since :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"segment_sum_f32": 0, "segment_sum_i32": 0}
#: value tensors those calls carried (one call per tensor would make this many)
FIELDS: Dict[str, int] = {"segment_sum_f32": 0, "segment_sum_i32": 0}
#: of :data:`LAUNCHES`, the calls replayed inside device loop graphs: each
#: captured call times its round's fetched trip count, not counted at a launch
REPLAYED: Dict[str, int] = {"segment_sum_f32": 0, "segment_sum_i32": 0}

_INT32_MAX = 2**31 - 1
_F32, _I32, _U8 = 0, 1, 2          # the kernel's field types
_FIELD_TYPE = {torch.float32: _F32, torch.int32: _I32, torch.bool: _U8, torch.uint8: _U8}
_FIELD_BYTES = {_F32: 4, _I32: 4, _U8: 1}
_MAX_FIELDS = 16
_MAX_COLS = 64
_MAX_TILES = 264                  # blocks of a fixed-order pass (two an SM of an H100)
_PASS_SEGMENTS = 28_672           # segments one fixed-order pass holds
_LIB = None
_PACKERS: Dict[int, Callable[..., bytes]] = {}
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
#: held from a call's scratch lookup until its kernels are enqueued (see _scratch)
_LAUNCH_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for d in (LAUNCHES, FIELDS, REPLAYED):
        for k in d:
            d[k] = 0


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("segment_sum")
        for fn in (lib.cc_segment_sums, lib.cc_segment_counts):
            fn.argtypes = [ctypes.c_char_p]   # the packed int64 arguments
            fn.restype = ctypes.c_int
        lib.cc_segment_sums_plan.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong)]
        lib.cc_segment_sums_plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _census(path: str, rows: int, segments: int, layout: tuple, wall_s: float, events=(), graph_calls: int = 0) -> None:
    """Report one host call to the profiler's census, or ``graph_calls``
    replays of a captured one: ``layout`` is the value columns' ``(field
    type, width)`` pairs as the kernel reads them."""
    key = (path, rows, segments, layout)

    def describe():
        columns = sum(w for _, w in layout)
        nbytes = 4 * rows + rows * sum(w * _FIELD_BYTES[k] for k, w in layout) + 4 * segments * columns
        return f"[{rows}] ids, {columns} columns -> {segments} segments", rows * columns, nbytes

    if graph_calls:
        PROFILER.on_graph_calls(path, key, describe, graph_calls)
    else:
        PROFILER.on_call(path, key, describe, wall_s, events)


def _plain_census(columns: Sequence[torch.Tensor], rows: int, segments: int, wall_s: float) -> None:
    """The census of a plain call, under the path its kernel would take."""
    layout = tuple(
        (_FIELD_TYPE.get(c.dtype, _F32 if c.dtype.is_floating_point else _I32), 1 if c.dim() == 1 else c.shape[1])
        for c in columns
    )
    if segments and any(w for _, w in layout):
        path = "segment_sum_f32" if any(k == _F32 for k, _ in layout) else "segment_sum_i32"
        _census(path, rows, segments, layout, wall_s)


def segment_sum_plain(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The plain version: ``index_add_`` into a sink row for out-of-range ids.

    On the CPU floats accumulate in f32, row by row in index order (the
    rounding of the JAX package's CPU scatter-add); on the card in float64 and
    then cast.  Integer and bool inputs come back in their own dtype (bool as
    "any row"), 1-D inputs come back 1-D.
    """
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    S = int(num_segments)
    ids = segment_ids.long()
    idx = torch.where((ids >= 0) & (ids < S), ids, S)
    if values.dtype.is_floating_point:
        acc = values.dtype if values.device.type == "cpu" else torch.float64
        out = torch.zeros((S + 1, v.shape[1]), dtype=acc, device=v.device)
        out = out.index_add_(0, idx, v.to(acc))[:S].to(values.dtype)
    else:
        out = torch.zeros((S + 1, v.shape[1]), dtype=torch.int64, device=v.device)
        out = out.index_add_(0, idx, v.to(torch.int64))[:S]
        out = out > 0 if values.dtype == torch.bool else out.to(values.dtype)
    return out[:, 0] if squeeze else out


def segment_sums_plain(
    columns: Sequence[torch.Tensor], segment_ids: torch.Tensor, num_segments: int
) -> List[torch.Tensor]:
    """The plain version of :func:`segment_sums`, one column at a time."""
    return [
        segment_sum_plain(
            c if c.dtype.is_floating_point else c.to(torch.int32), segment_ids, num_segments
        )
        for c in columns
    ]


def segment_sums_cuda(
    columns: Sequence[torch.Tensor], segment_ids: torch.Tensor, num_segments: int
) -> List[torch.Tensor]:
    """The kernels' wrapper: one host call for every column (same contract as
    :func:`segment_sums`).  The solver's loop is bound by host time, so the
    wrapper reads each tensor's metadata once, copies nothing that already has
    the kernel's layout, allocates one output buffer and hands the kernel all
    its arguments in one packed array."""
    ids = segment_ids
    dev = ids.device
    if dev.type != "cuda" or ids.dim() != 1:
        raise ValueError(f"segment sums on the card take 1-D CUDA ids, got {tuple(ids.shape)} on {dev}")
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    R, S = ids.shape[0], int(num_segments)
    if not 0 < len(columns) <= _MAX_FIELDS:
        raise ValueError(f"a call takes 1 to {_MAX_FIELDS} value tensors, got {len(columns)}")
    fields, floats, total, layout = [], False, 0, []
    for c in columns:
        kind = _FIELD_TYPE.get(c.dtype)
        if kind is None:
            if c.dtype.is_floating_point:
                raise TypeError(f"the segment-sum kernels take float32 floats, got {c.dtype}")
            c, kind = c.to(torch.int32), _I32
        shape = c.shape
        if c.device != dev or len(shape) not in (1, 2) or shape[0] != R:
            raise ValueError(f"values {tuple(shape)} on {c.device} do not match ids [{R}] on {dev}")
        if not c.is_contiguous():
            c = c.contiguous()
        w = 1 if len(shape) == 1 else shape[1]
        fields.append((c, kind, w, len(shape)))
        layout.append((kind, w))
        floats = floats or kind == _F32
        total += w
    if total > _MAX_COLS:
        raise ValueError(f"a call takes at most {_MAX_COLS} columns, got {total}")
    if R * total > _INT32_MAX or S * total > _INT32_MAX:
        raise ValueError(f"segment sums: {R} rows x {total} columns -> {S} exceed int32 indexing")
    # one output buffer, one contiguous region per field
    buf = torch.empty(S * total, dtype=torch.float32 if floats else torch.int32, device=dev)
    parts = [buf] if len(fields) == 1 else buf.split([S * w for _, _, w, _ in fields])
    outs, spec, addr = [], [], buf.data_ptr()
    for (c, kind, w, ndim), part in zip(fields, parts):
        if floats and kind != _F32:
            part = part.view(torch.int32)
        outs.append(part if ndim == 1 else part.view(S, w))
        if w:
            spec += (c.data_ptr(), addr, w, kind)
        addr += 4 * S * w
    if S == 0 or not spec:
        return outs
    t0 = time.perf_counter()
    mark = compile_mark() if _LIB is None else None   # the first call builds
    lib = _library()
    index = dev.index
    path = "segment_sum_f32" if floats else "segment_sum_i32"
    with _LAUNCH_LOCK:
        if index == torch._C._cuda_getDevice():
            err = _launch(lib, floats, ids, R, S, total, spec, index)
        else:  # the launch goes to the current device's stream
            with torch.cuda.device(index):
                err = _launch(lib, floats, ids, R, S, total, spec, index)
        rec = graph_loop.recording()
        if err == 0 and rec is None:
            LAUNCHES[path] += 1
            FIELDS[path] += len(spec) // 4
    if err != 0:
        raise RuntimeError(f"segment-sum kernel launch failed: CUDA error {err}")
    if rec is not None:
        # captured into a device loop's round: counted per replay instead
        rec.calls.append(_replays(path, len(spec) // 4, R, S, tuple(layout)))
        return outs
    _census(path, R, S, tuple(layout), time.perf_counter() - t0,
            compile_events_since(mark) if mark is not None else ())
    return outs


def _replays(path: str, fields: int, rows: int, segments: int, layout: tuple):
    """The counts of one captured call, added ``times`` over (no host wall)."""
    def account(times: int) -> None:
        with _LAUNCH_LOCK:
            LAUNCHES[path] += times
            REPLAYED[path] += times
            FIELDS[path] += fields * times
        _census(path, rows, segments, layout, 0.0, graph_calls=times)

    return account


def _launch(lib, floats, ids, R, S, columns, spec, index) -> int:
    stream = torch._C._cuda_getCurrentRawStream(index)
    nfields = len(spec) // 4
    if not floats:
        return lib.cc_segment_counts(_pack((ids.data_ptr(), R, S, stream, nfields, *spec)))
    # every column in segment order, a pass's per-(block, segment) counts,
    # each segment's first row and the offsets kernel's ticket
    n = R * columns + (_MAX_TILES + 1) * min(S, _PASS_SEGMENTS) + 2
    scratch = _scratch(index, stream, n)
    return lib.cc_segment_sums(
        _pack((ids.data_ptr(), R, S, stream, scratch.data_ptr(), scratch.numel(), nfields, *spec))
    )


def _pack(values) -> bytes:
    """The kernels' argument array: int64 values, packed."""
    pack = _PACKERS.get(len(values))
    if pack is None:
        pack = _PACKERS[len(values)] = struct.Struct(f"{len(values)}q").pack
    return pack(*values)


def _scratch(index: int, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 of scratch for the fixed-order path on this device
    and stream; it only grows.  Kernels on one stream run in the order they
    were enqueued, so one buffer serves every call on it as long as each
    call's kernels are enqueued back to back.  Host threads share the
    default stream and ``cc_segment_sums`` runs without the GIL, so the
    caller holds :data:`_LAUNCH_LOCK` from this lookup until the kernels are
    enqueued: two threads' kernels never interleave on the buffer (the
    detector's threads and the anomaly handler solve at the same time).

    Under a device loop's capture the buffer must exist already (the eager
    round before each capture sizes it, outside the graphs' pool), and the
    captured round holds it (``graph_loop.keep_alive``): a larger buffer
    may replace it here, and the old one lives on for the graphs that read
    it."""
    key = (index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        if graph_loop.recording() is not None:
            raise RuntimeError(
                f"segment sums: no scratch of {n} int32 for the stream under capture "
                "(the eager round before a capture allocates it)"
            )
        buf = _SCRATCH[key] = torch.empty(n, dtype=torch.int32, device=torch.device("cuda", index))
    return graph_loop.keep_alive(buf)


def segment_sums_plan(rows: int, segments: int, device) -> Dict[str, int]:
    """How the fixed-order path cuts a call of ``rows`` ids into ``segments``
    on a card (``cc_segment_sums`` launches by the same plan): the passes over
    the segment range, and the first pass's blocks, scatter warps a block and
    rows a block."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the fixed-order plan is a card's, got {device}")
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        err = _library().cc_segment_sums_plan(_pack((int(rows), int(segments))), out)
    if err != 0:
        raise RuntimeError(f"segment-sum plan failed: CUDA error {err}")
    return dict(zip(("passes", "blocks", "warps", "block_rows"), out))


def segment_sums(
    columns: Sequence[torch.Tensor], segment_ids: torch.Tensor, num_segments: int
) -> List[torch.Tensor]:
    """Segment sums of several ``[R]`` / ``[R, k]`` tensors under one id
    vector (ids outside ``[0, num_segments)`` dropped), ``[S]`` / ``[S, k]``
    each.  float32 columns give float32 sums in row order; bool, uint8 and
    int32 columns give int32 sums (a bool column counts its true rows).  On
    the card one host call: the fixed-order path if any column is float, the
    integer path otherwise."""
    if segment_ids.device.type == "cpu":
        t0 = time.perf_counter()
        out = segment_sums_plain(columns, segment_ids, num_segments)
        _plain_census(columns, segment_ids.shape[0], int(num_segments), time.perf_counter() - t0)
        return out
    if segment_ids.device.type == "cuda":
        return segment_sums_cuda(columns, segment_ids, num_segments)
    raise ValueError(f"segment_sums: unsupported device {segment_ids.device}")


def segment_sum_cuda(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """One tensor through the kernels, with :func:`segment_sum_plain`'s
    contract (integers keep their dtype, bool comes back as "any row")."""
    if values.device.type != "cuda":
        raise ValueError("segment_sum_cuda needs values and ids on one CUDA device")
    (out,) = segment_sums_cuda([values], segment_ids, num_segments)
    if values.dtype == torch.bool:
        return out > 0
    if not values.dtype.is_floating_point and values.dtype != torch.int32:
        return out.to(values.dtype)
    return out


def segment_sum(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Segment sum (ids outside ``[0, num_segments)`` dropped).

    CPU tensors take :func:`segment_sum_plain`; CUDA tensors take the kernel,
    which raises if it cannot build or launch.
    """
    if values.device.type == "cpu":
        t0 = time.perf_counter()
        out = segment_sum_plain(values, segment_ids, num_segments)
        _plain_census([values], segment_ids.shape[0], int(num_segments), time.perf_counter() - t0)
        return out
    if values.device.type == "cuda":
        return segment_sum_cuda(values, segment_ids, num_segments)
    raise ValueError(f"segment_sum: unsupported device {values.device}")
