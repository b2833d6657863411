"""Segment sums: the hand-written CUDA kernel and its plain PyTorch version.

The solver's hot reductions are per-broker segment sums over the replica axis:
broker loads, replica/leader counts, potential NW-out, leader bytes-in, the
(broker, topic) and (partition, rack) count tables (``analyzer.context
.take_snapshot``, ``model.arrays``).  The JAX package ran them through two
Pallas TPU kernels, ``segment_sum_pallas`` and ``segment_sum_radix``
(``cruise_control_tpu/ops/segments.py``), one-hot contractions on the MXU.  On
Hopper the same function is ``csrc/segment_sum.cu``, one kernel source for any
segment count and any column count, with two paths:

* float32 inputs take a fixed-order path: one warp per segment walks the rows
  in index order, so each sum is the left-to-right f32 sum -- bitwise the same
  on every run and the same as the sequential CPU scatter-add of
  :func:`segment_sum_plain`.  The solver breaks ties by comparing float scores,
  so an atomic float sum, whose order changes from run to run, could flip a tie.
* integer and bool inputs take an int32 atomic path, exact in any order.

What bounds it: at the solver's shapes (30,000 rows, four columns, 128
segments) the kernel moves about 600 KB, under a microsecond of HBM time; the
launch and the serial per-segment walk bound it, not bandwidth.  Making it
fast (more segments per warp, tensor-core one-hots) is later work.

:func:`segment_sum` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each launch adds one to
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from cruise_control_tpu_torch.ops import _build

#: kernel launches since the last :func:`reset_launch_counts`, by kernel path
LAUNCHES: Dict[str, int] = {"segment_sum_f32": 0, "segment_sum_i32": 0}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("segment_sum")
    for fn in (lib.cc_segment_sum_f32, lib.cc_segment_sum_i32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


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


def segment_sum_cuda(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The CUDA kernel's wrapper (same contract as :func:`segment_sum_plain`)."""
    if values.device.type != "cuda" or segment_ids.device != values.device:
        raise ValueError("segment_sum_cuda needs values and ids on one CUDA device")
    if segment_ids.dim() != 1 or segment_ids.shape[0] != values.shape[0]:
        raise ValueError(
            f"ids {tuple(segment_ids.shape)} do not match values {tuple(values.shape)}"
        )
    if values.dim() not in (1, 2):
        raise ValueError(f"values must be [R] or [R, C], got {tuple(values.shape)}")
    is_float = values.dtype.is_floating_point
    if is_float and values.dtype != torch.float32:
        raise TypeError(f"segment_sum_cuda takes float32 floats, got {values.dtype}")
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    R, C = v.shape
    S = int(num_segments)
    if R * C > _INT32_MAX or S * C > _INT32_MAX:
        raise ValueError(f"segment_sum_cuda: shape {R}x{C} -> {S} exceeds int32 indexing")
    out_dtype = torch.float32 if is_float else torch.int32
    if S == 0 or C == 0:
        out = torch.zeros((S, C), dtype=out_dtype, device=v.device)
    else:
        ids = segment_ids.to(torch.int32).contiguous()
        lib = _library()
        with torch.cuda.device(v.device):
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            if is_float:
                src = v.contiguous()
                out = torch.empty((S, C), dtype=torch.float32, device=v.device)
                err = lib.cc_segment_sum_f32(
                    src.data_ptr(), ids.data_ptr(), out.data_ptr(), R, C, S, stream
                )
                LAUNCHES["segment_sum_f32"] += 1
            else:
                src = v.to(torch.int32).contiguous()
                out = torch.zeros((S, C), dtype=torch.int32, device=v.device)
                err = 0
                if R > 0:
                    err = lib.cc_segment_sum_i32(
                        src.data_ptr(), ids.data_ptr(), out.data_ptr(), R, C, S, stream
                    )
                    LAUNCHES["segment_sum_i32"] += 1
        if err != 0:
            raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    if not is_float:
        out = out > 0 if values.dtype == torch.bool else out.to(values.dtype)
    return out[:, 0] if squeeze else out


def segment_sum(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Segment sum (ids outside ``[0, num_segments)`` dropped).

    CPU tensors take :func:`segment_sum_plain`; CUDA tensors take the kernel,
    which raises if it cannot build or launch.
    """
    if values.device.type == "cpu":
        return segment_sum_plain(values, segment_ids, num_segments)
    if values.device.type == "cuda":
        return segment_sum_cuda(values, segment_ids, num_segments)
    raise ValueError(f"segment_sum: unsupported device {values.device}")
