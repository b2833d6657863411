"""Gathers, scatters and segment reductions with the JAX package's semantics.

PyTorch and JAX differ where an index is out of range, where a scatter writes
one slot twice, where a segment is empty and in the order a float scan adds.
The solver relies on JAX's answer in each case, so the port routes those
sites through the functions here:

* :func:`scatter_set` drops writes at indices ``>= n`` (JAX ``mode="drop"``;
  negative indices wrap first, as in JAX); PyTorch raises on the CPU and
  device-asserts on CUDA;
* inside the solver's lane form (one lane of a stack lifted by
  ``torch.func.vmap``, ``ops.segments.in_lanes``) a scatter into a fresh
  buffer runs out of place, which vmap batches, and in place otherwise: every
  such scatter goes through :func:`fresh_index_put`,
  :func:`fresh_scatter_reduce` or :func:`fresh_index_fill`, which decide;
  each lane's negative index wraps, and an out-of-range one drops, within
  that lane;
* :func:`scatter_last` resolves duplicate indices to the LAST write, the
  winner of the JAX CPU scatter, deterministically on every device;
* :func:`segment_max` / :func:`segment_min` give empty segments the identity
  (-inf / INT_MIN, +inf / INT_MAX), as ``jax.ops.segment_max/min`` do, and
  take a stack's lanes in one reduction (:func:`lane_ids`);
* :func:`cumsum` adds in the order of XLA's CPU scan (16-wide blocks, each
  summed left to right, block carries scanned the same way, recursively), so
  the card, the CPU port and the JAX reference round alike;
* :func:`xla_sums` reduces along dim 0 in the order of XLA's CPU reduce: up
  to 32 rows left to right; above that, the rows padded with zeros (half the
  padding before them, the rest after) into 32-row windows, each summed left
  to right, and the window sums reduced the same way, recursively.  Each level
  is one call of the fixed-order segment sum (a window is a segment), so the
  card rounds as the CPU does.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from cruise_control_tpu_torch.ops import graph_loop
from cruise_control_tpu_torch.ops.segments import in_lanes, lane_ids, segment_sums

_BLOCK = 16
_WINDOW = 32
#: windows one lane-batched ``xla_sums`` call carries at most (see there): by
#: default every lane in one call a level
LANE_CALL_WINDOWS = 1_000_000_000


def _identity(dtype: torch.dtype, largest: bool):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def _out_of_place(buf: torch.Tensor, *writes) -> bool:
    """Whether a write of ``writes`` into ``buf`` must run out of place: it
    comes from one lane of a stack while ``buf`` is shared by the lanes (a
    buffer made inside the lift has no lane axis), which vmap cannot write
    in place."""
    return in_lanes(*writes) and not in_lanes(buf)


def fresh_index_put(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``buf[idx] = vals`` along dim 0 of a buffer the caller has just made
    (nothing else holds it); returns the written buffer, ``buf`` itself
    outside the lane form."""
    if _out_of_place(buf, idx, vals):
        return buf.index_put((idx,), vals)
    return buf.index_put_((idx,), vals)


def fresh_scatter_reduce(buf: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, reduce: str) -> torch.Tensor:
    """``buf.scatter_reduce_(0, idx, src, reduce, include_self=True)`` on a
    buffer the caller has just made, as :func:`fresh_index_put`."""
    if _out_of_place(buf, idx, src):
        return buf.scatter_reduce(0, idx, src, reduce, include_self=True)
    return buf.scatter_reduce_(0, idx, src, reduce, include_self=True)


def fresh_index_fill(buf: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``buf.index_fill_(0, idx, value)`` on a buffer the caller has just
    made, as :func:`fresh_index_put`."""
    if _out_of_place(buf, idx):
        return buf.index_fill(0, idx, value)
    return buf.index_fill_(0, idx, value)


def even_significand(s: torch.Tensor) -> torch.Tensor:
    """bool: float64 ``s`` has an even significand (its last bit clear).  One
    lane of a stack reads it by arithmetic -- ``|s|`` over its spacing is the
    significand, an exact integer -- since vmap does not reinterpret a lane's
    bits; both forms agree exactly on every finite value."""
    if not in_lanes(s):
        return torch.bitwise_and(s.view(torch.int64), 1) == 0
    u = s.abs()
    return torch.fmod(u / (torch.nextafter(u, torch.full_like(u, torch.inf)) - u), 2.0) == 0


def _segment_reduce(data, seg, num_segments: int, reduce: str):
    S = int(num_segments)
    ids = seg.long()
    idx = torch.where((ids >= 0) & (ids < S), ids, S)
    fill = _identity(data.dtype, largest=(reduce == "amin"))
    out = torch.full((S + 1,) + tuple(data.shape[1:]), fill, dtype=data.dtype, device=data.device)
    if data.dim() > 1:
        idx = idx.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return fresh_scatter_reduce(out, idx, data, reduce)[:S]


def _lane_reduce(data, seg, num_segments: int, reduce: str, lanes: Optional[int]):
    if lanes is None:
        return _segment_reduce(data, seg, num_segments, reduce)
    flat = data.reshape((-1,) + tuple(data.shape[2:]))
    out = _segment_reduce(flat, lane_ids(seg, num_segments), lanes * num_segments, reduce)
    return out.view((lanes, num_segments) + tuple(out.shape[1:]))


def segment_max(data: torch.Tensor, seg: torch.Tensor, num_segments: int, lanes: Optional[int] = None) -> torch.Tensor:
    """``jax.ops.segment_max``: per-segment max, -inf/INT_MIN where empty.
    With ``lanes``, ``data`` and ``seg`` are ``[S, n, ...]`` and each lane
    reduces into its own segments (one reduction for all), ``[S, num_segments, ...]``."""
    return _lane_reduce(data, seg, num_segments, "amax", lanes)


def segment_min(data: torch.Tensor, seg: torch.Tensor, num_segments: int, lanes: Optional[int] = None) -> torch.Tensor:
    """``jax.ops.segment_min``: per-segment min, +inf/INT_MAX where empty;
    ``lanes`` as in :func:`segment_max`."""
    return _lane_reduce(data, seg, num_segments, "amin", lanes)


def _keep_mask(idx: torch.Tensor, n: int):
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx, 0), ok


def scatter_set(target: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``target.at[idx].set(values, mode="drop")`` along dim 0, out of place.

    Callers pass unique in-range indices (the solver's invariant); duplicates
    among them would be resolved arbitrarily on CUDA -- use
    :func:`scatter_last` where duplicates are possible."""
    n = target.shape[0]
    safe, ok = _keep_mask(idx, n)
    if isinstance(values, torch.Tensor):
        vals = values.to(target.dtype)
    else:  # a fill, not a host-to-device copy (which would wait on the stream)
        vals = torch.full((), values, dtype=target.dtype, device=target.device)
    vals = vals.expand(tuple(idx.shape) + tuple(target.shape[1:]))
    # dropped writes land in a sink row past the end (no host-side masking)
    out = torch.cat([target, target.new_zeros((1,) + tuple(target.shape[1:]))])
    sink = torch.where(ok, safe, n)
    return fresh_index_put(out, sink, vals)[:n]


def scatter_last(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """1-D ``target.at[idx].set(values, mode="drop")`` where duplicate indices
    keep the value of the LAST (highest-position) write, as the JAX CPU
    scatter does."""
    n = target.shape[0]
    safe, ok = _keep_mask(idx, n)
    pos = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    sink = torch.where(ok, safe, n)
    last = fresh_scatter_reduce(last, sink, pos, "amax")[:n]
    hit = last >= 0
    return torch.where(hit, values[last.clamp(min=0)].to(target.dtype), target)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along dim 0 in XLA's CPU order (see module docstring)."""
    n = x.shape[0]
    if n == 0:
        return x.clone()
    if n <= _BLOCK:
        parts = [x[0]]
        for i in range(1, n):
            parts.append(parts[-1] + x[i])
        return torch.stack(parts) if parts else x.clone()
    m = -(-n // _BLOCK)
    pad = torch.zeros((m * _BLOCK - n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    blocks = torch.cat([x, pad]).reshape((m, _BLOCK) + tuple(x.shape[1:]))
    cols = [blocks[:, 0]]
    for i in range(1, _BLOCK):
        cols.append(cols[-1] + blocks[:, i])
    local = torch.stack(cols, dim=1)                      # [m, 16, ...]
    carry = cumsum(local[:, -1])                          # inclusive scan of block sums
    carry = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])
    out = local + carry[:, None]
    return out.reshape((m * _BLOCK,) + tuple(x.shape[1:]))[:n]


@functools.lru_cache(maxsize=64)
def _window_ids(n: int, device: torch.device, lanes: int = 1) -> torch.Tensor:
    """i32[lanes * n]: XLA's 32-row window of each of ``n`` rows (all 0 when
    n <= 32), repeated for each lane with the lane's windows after the last
    lane's."""
    if n <= _WINDOW:
        ids = torch.zeros(n, dtype=torch.int32, device=device)
        windows = 1
    else:
        pad = -(-n // _WINDOW) * _WINDOW - n
        ids = torch.div(
            torch.arange(n, dtype=torch.int32, device=device) + pad // 2, _WINDOW, rounding_mode="floor"
        )
        windows = -(-n // _WINDOW)
    if lanes == 1:
        return ids
    lane = torch.arange(lanes, dtype=torch.int32, device=device)[:, None] * windows
    return (lane + ids[None, :]).reshape(-1)


def xla_sums(columns: Sequence[torch.Tensor], lanes: Optional[int] = None) -> List[torch.Tensor]:
    """Sum each float32 ``[n]`` / ``[n, k]`` tensor (one ``n`` for all) over
    dim 0 in XLA's CPU order (see module docstring): one segment-sum call per
    level for all of them, ``[]`` / ``[k]`` each.

    With ``lanes``, each tensor is ``lanes`` runs of ``n`` rows, one after
    another (``[lanes * n]`` / ``[lanes * n, k]``), and each run is summed on
    its own in that order -- the order of XLA's reduce over the middle axis of
    ``[lanes, n, k]`` (a ``vmap``-ed sum), which windows each lane alike.  The
    result is ``[lanes]`` / ``[lanes, k]`` each.  A level's call takes as many
    lanes as keep it at :data:`LANE_CALL_WINDOWS` windows (at least one
    lane); however the lanes are cut, each lane's sums are the same.  The
    default puts every lane in one call a level: since the fixed-order
    kernel's plan takes its blocks from the rows, one call of S1's 64 lanes
    (60,032 windows) costs 2.5 ms a call against 7.0 ms for one a lane
    (``bench_sweep``, NVIDIA H100 80GB HBM3, 700.00 W)."""
    cols = list(columns)
    L = 1 if lanes is None else int(lanes)
    n = cols[0].shape[0] // L
    while True:
        windows = max(-(-n // _WINDOW), 1)
        per_call = max(1, LANE_CALL_WINDOWS // windows)
        parts = []
        for l0 in range(0, L, per_call):
            k = min(per_call, L - l0)
            part = cols if k == L else [c[l0 * n:(l0 + k) * n] for c in cols]
            ids = graph_loop.keep_alive(_window_ids(n, cols[0].device, k))   # a cached entry may be evicted
            parts.append(segment_sums(part, ids, k * windows))
        cols = parts[0] if len(parts) == 1 else [torch.cat(x) for x in zip(*parts)]
        if windows == 1:
            return [c[0] for c in cols] if lanes is None else cols
        n = windows


def lane_xla_sums(columns: Sequence[torch.Tensor], lanes: Optional[int]) -> List[torch.Tensor]:
    """:func:`xla_sums` of one state's ``[n]`` / ``[n, k]`` columns, or of
    every lane of ``[S, n]`` / ``[S, n, k]`` columns (``lanes`` = S) in the
    lane-batched calls, ``[S]`` / ``[S, k]`` each."""
    if lanes is None:
        return xla_sums(columns)
    return xla_sums([c.reshape((-1,) + tuple(c.shape[2:])) for c in columns], lanes=lanes)
