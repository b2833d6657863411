"""The rank mesh, replica-axis sharding and the collective layer.

Port of ``cruise_control_tpu/parallel/mesh.py``.  The JAX package runs one
process over a ``Mesh`` of devices and ``shard_map`` traces the per-shard
body.  PyTorch is SPMD by processes: every rank calls the same ``optimize``
on the same host-side state and keeps its own contiguous block of the
replica axis.  The layout is the JAX one:

* the replica-axis fields (:data:`REPLICA_FIELDS`) are sharded: rank ``r``
  owns rows ``[r * R/n, (r + 1) * R/n)`` after :func:`pad_replicas`;
* broker, partition and disk axes are replicated: per-broker aggregates are
  the *outputs* of the merges in :mod:`.spmd`.

:class:`Mesh` wraps a ``torch.distributed`` process group and is the one
place every collective of the sharded solver goes through
(:meth:`Mesh.all_gather`, :meth:`Mesh.all_reduce`, :meth:`Mesh.fold_ranks`);
:data:`COLLECTIVES` counts them per operation and :data:`COLLECTIVE_WALL_S`
keeps the host wall spent inside each (a fold's includes its ranks' steps and
the waits between them).

The backend is chosen by one rule (:func:`choose_backend`), and the mesh
records it: ``nccl`` when every rank has a card of its own
(``cuda:<local rank>``), ``gloo`` when ranks share one card or run on the
CPU -- NCCL refuses two ranks on one GPU.  PyTorch documents gloo's GPU side
for ``broadcast`` and ``all_reduce`` only, so on the card the gloo mesh
stages every collective through host copies: the tensor is copied to the
host, the collective runs there, and the result is copied back.  Nothing
falls back quietly: a collective that fails raises.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from cruise_control_tpu_torch.core.device import DeviceLike, resolve_device
from cruise_control_tpu_torch.model.arrays import ClusterArrays

REPLICA_AXIS = "replicas"

#: ClusterArrays fields laid out replica-major (sharded over the ranks).
#: Matched by NAME, not leading-dim size: an RF-1 cluster has as many
#: partitions as replicas, and its partition arrays must stay replicated.
REPLICA_FIELDS = frozenset({
    "replica_partition",
    "replica_broker",
    "replica_disk",
    "replica_valid",
    "base_load",
    "original_broker",
})

#: collectives issued since :func:`reset_collective_counts`, per operation
COLLECTIVES: Dict[str, int] = {"all_gather": 0, "all_reduce": 0, "fold": 0}
#: host seconds spent inside each operation since the last reset
COLLECTIVE_WALL_S: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
        COLLECTIVE_WALL_S[k] = 0.0


def _counted(op: str):
    """Count a call of the decorated collective under ``op`` and add its
    host wall (two clock reads) to :data:`COLLECTIVE_WALL_S`."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            COLLECTIVES[op] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                COLLECTIVE_WALL_S[op] += time.perf_counter() - t0

        return run

    return wrap


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def choose_backend(world: int, device: DeviceLike) -> str:
    """``nccl`` when the ranks run on cards and every rank has one of its
    own; ``gloo`` otherwise (ranks sharing one card, or the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_device(device: DeviceLike, local_rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the replica-axis mesh: its process group, ``rank``
    and ``world`` (the JAX mesh's ``devices.size``), the device its tensors
    live on and the backend that carries its collectives."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def staged(self) -> bool:
        """Whether collectives stage through host copies (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _peer(self, rank: int) -> int:
        """The process-group-global rank of this mesh's ``rank`` (the
        point-to-point calls address global ranks)."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged else t

    @_counted("all_gather")
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t``, in rank order."""
        src = self._host(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.stack(parts)
        return out.to(self.device) if self.staged else out

    @_counted("all_reduce")
    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Element-wise ``sum``, ``min`` or ``max`` of ``t`` over the ranks
        (out of place).  A float ``sum`` depends on the order the backend
        adds in, so the solver sums through it only what is exact in any
        order (integers below 2**24, rows one rank contributes); float sums
        that must round one way go through :meth:`fold_ranks`."""
        buf = self._host(t).clone()
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=self.group)
        return buf.to(self.device) if self.staged else buf

    @_counted("fold")
    def fold_ranks(self, carry0: torch.Tensor, step: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """Run ``step`` on the ranks one after another: rank 0 applies it to
        ``carry0``, rank ``r`` to rank ``r - 1``'s output; every rank returns
        the last rank's output.  ``step`` keeps the carry's shape and dtype.
        One fold is ``world - 1`` point-to-point hops and one broadcast, and
        the ranks' steps run in turn, not at once: it is for a reduction that
        must add in one global order (the snapshot's float sums, which must
        round as the single-device row-order sum does)."""
        if self.rank == 0:
            carry = carry0
        else:
            buf = torch.empty_like(self._host(carry0))
            dist.recv(buf, src=self._peer(self.rank - 1), group=self.group)
            carry = buf.to(self.device) if self.staged else buf
        out = step(carry)
        last = self.world - 1
        if self.rank < last:
            dist.send(self._host(out), dst=self._peer(self.rank + 1), group=self.group)
            buf = torch.empty_like(self._host(carry0))
        else:
            buf = self._host(out).clone()
        dist.broadcast(buf, src=self._peer(last), group=self.group)
        return buf.to(self.device) if self.staged else buf


def solver_mesh(group=None, device: DeviceLike = None) -> Mesh:
    """The mesh of the initialized default process group (or ``group``):
    rank, world and backend from ``torch.distributed``; the device is
    ``cuda`` unless ``device="cpu"`` is passed (and raises without a GPU, as
    every entry point of the port does), ``cuda:<local rank>`` on a host
    with a card per rank."""
    if not dist.is_initialized():
        raise RuntimeError(
            "solver_mesh needs an initialized process group: start the ranks with "
            "parallel.launch.run_ranks or call torch.distributed.init_process_group first"
        )
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    return Mesh(rank=rank, world=world, device=dev, backend=dist.get_backend(group), group=group)


def pad_replicas(state: ClusterArrays, multiple: int) -> ClusterArrays:
    """Pad the replica axis to a multiple of the mesh size.  Padding rows
    are invalid and scatter-neutral: partition 0, broker 0, disk 0, zero
    load, ``replica_valid`` False; every kernel masks on validity."""
    R = state.num_replicas
    pad = (-R) % multiple
    if pad == 0:
        return state

    def pad_leaf(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return state.replace(**{f: pad_leaf(getattr(state, f)) for f in REPLICA_FIELDS})


def shard_state(state: ClusterArrays, mesh: Mesh) -> ClusterArrays:
    """This rank's block: the state padded to a multiple of the world, its
    replica-axis fields cut to rows ``[rank * R/n, (rank + 1) * R/n)``, on the
    mesh's device; every other field whole."""
    state = pad_replicas(state, mesh.world).to(mesh.device)
    n = state.num_replicas // mesh.world
    lo = mesh.rank * n
    return state.replace(**{f: getattr(state, f)[lo:lo + n] for f in REPLICA_FIELDS})


def replicate(tree, mesh: Mesh):
    """A state, context or tensor whole on the mesh's device (every rank
    already holds the same host-side value)."""
    return tree.to(mesh.device)


def gather_state(local: ClusterArrays, mesh: Mesh) -> ClusterArrays:
    """The whole (padded) state from every rank's block, in ONE all_gather:
    the replica-axis fields ride as one float64 matrix (exact for int32 and
    float32), rank 0's rows first."""
    names = sorted(REPLICA_FIELDS)
    cols = []
    for f in names:
        x = getattr(local, f)
        cols.append(x.reshape(x.shape[0], -1).to(torch.float64))
    gathered = mesh.all_gather(torch.cat(cols, dim=1))          # [world, n, C]
    flat = gathered.reshape(-1, gathered.shape[-1])
    out, pos = {}, 0
    for f in names:
        x = getattr(local, f)
        width = 1 if x.dim() == 1 else x.shape[1]
        piece = flat[:, pos:pos + width]
        piece = piece[:, 0] if x.dim() == 1 else piece
        out[f] = piece.to(x.dtype)
        pos += width
    return local.replace(**out)
