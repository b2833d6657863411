"""Gathers, scatters and segment reductions with the JAX package's semantics.

PyTorch and JAX differ where an index is out of range, where a scatter writes
one slot twice, where a segment is empty and in the order a float scan adds.
The solver relies on JAX's answer in each case, so the port routes those
sites through the functions here:

* :func:`scatter_set` drops writes at indices ``>= n`` (JAX ``mode="drop"``;
  negative indices wrap first, as in JAX); PyTorch raises on the CPU and
  device-asserts on CUDA;
* :func:`scatter_last` resolves duplicate indices to the LAST write, the
  winner of the JAX CPU scatter, deterministically on every device;
* :func:`segment_max` / :func:`segment_min` give empty segments the identity
  (-inf / INT_MIN, +inf / INT_MAX), as ``jax.ops.segment_max/min`` do;
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
from typing import List, Sequence

import torch

from cruise_control_tpu_torch.ops.segments import segment_sums

_BLOCK = 16
_WINDOW = 32


def _identity(dtype: torch.dtype, largest: bool):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def _segment_reduce(data, seg, num_segments: int, reduce: str):
    S = int(num_segments)
    ids = seg.long()
    idx = torch.where((ids >= 0) & (ids < S), ids, S)
    fill = _identity(data.dtype, largest=(reduce == "amin"))
    out = torch.full((S + 1,) + tuple(data.shape[1:]), fill, dtype=data.dtype, device=data.device)
    if data.dim() > 1:
        idx = idx.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce, include_self=True)
    return out[:S]


def segment_max(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: per-segment max, -inf/INT_MIN where empty."""
    return _segment_reduce(data, seg, num_segments, "amax")


def segment_min(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min``: per-segment min, +inf/INT_MAX where empty."""
    return _segment_reduce(data, seg, num_segments, "amin")


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
    out.index_put_((torch.where(ok, safe, n),), vals)
    return out[:n]


def scatter_last(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """1-D ``target.at[idx].set(values, mode="drop")`` where duplicate indices
    keep the value of the LAST (highest-position) write, as the JAX CPU
    scatter does."""
    n = target.shape[0]
    safe, ok = _keep_mask(idx, n)
    pos = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, torch.where(ok, safe, n), pos, "amax", include_self=True)
    last = last[:n]
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
def _window_ids(n: int, device: torch.device) -> torch.Tensor:
    """i32[n]: XLA's 32-row window of each of ``n`` rows (all 0 when n <= 32)."""
    if n <= _WINDOW:
        return torch.zeros(n, dtype=torch.int32, device=device)
    pad = -(-n // _WINDOW) * _WINDOW - n
    return torch.div(
        torch.arange(n, dtype=torch.int32, device=device) + pad // 2, _WINDOW, rounding_mode="floor"
    )


def xla_sums(columns: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each float32 ``[n]`` / ``[n, k]`` tensor (one ``n`` for all) over
    dim 0 in XLA's CPU order (see module docstring): one segment-sum call per
    level for all of them, ``[]`` / ``[k]`` each."""
    cols = list(columns)
    n = cols[0].shape[0]
    while True:
        windows = -(-n // _WINDOW)
        cols = segment_sums(cols, _window_ids(n, cols[0].device), max(windows, 1))
        if windows <= 1:
            return [c[0] for c in cols]
        n = windows
