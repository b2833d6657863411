"""The chip's peaks and the bytes a segment-sum call must move.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3.  A roofline share is the least time the call could take,
its bytes over the peak, divided by the time it took.  The bytes are counted
from the call's shapes: every input read once and every output written once,
whatever route the program's kernel takes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

H100_HBM_BYTES_PER_S = 3.35e12

#: bytes an element of each column kind takes in and out of a segment sum:
#: float32 in, float32 out; bool in, int32 count out
_IN_BYTES = {"f32": 4, "i32": 4, "bool": 1}
_OUT_BYTES = {"f32": 4, "i32": 4, "bool": 4}


def segment_sum_bytes(rows: int, segments: int, columns: Sequence[Tuple[str, int]]) -> int:
    """Bytes of one segment-sum call: ``rows`` int32 ids and each column's
    ``(kind, width)`` values read once, ``segments`` sums a column written
    once."""
    read = 4 * rows + sum(_IN_BYTES[k] * w * rows for k, w in columns)
    written = sum(_OUT_BYTES[k] * w * segments for k, w in columns)
    return read + written


def roofline_pct(nbytes: int, seconds: float) -> float:
    """The share of the bytes roofline a call of ``seconds`` reaches, in %."""
    return 100.0 * nbytes / H100_HBM_BYTES_PER_S / seconds
