"""Start the ranks of a sharded run: one process per rank.

    results = run_ranks(fn, world=4, device="cuda", args=(...))

``fn(mesh, *args)`` runs in every rank with that rank's
:class:`~cruise_control_tpu_torch.parallel.mesh.Mesh`; ``run_ranks`` returns
the ranks' results in rank order.  A result crosses a process boundary, so
it must pickle: return host values (numpy arrays, numbers), never CUDA
tensors.

* The ranks start under the **spawn** method: the parent may already hold a
  CUDA context, which a forked child cannot use.  ``fn`` must therefore be
  importable by name (a module-level function).
* They meet through a ``file://`` rendezvous in a fresh temporary
  directory, not a TCP port, so several runs at once (parallel test
  workers) never collide.
* ``init_process_group`` gets ``timeout_s`` too, so a collective that waits
  on a dead peer raises instead of blocking.
* If a rank raises or dies, the launcher stops the others and raises with
  the traceback of every rank that failed: a failed rank would otherwise
  leave its peers blocked in a collective until the caller's own clock runs
  out.  If the
  ranks outlast ``timeout_s`` the launcher stops them all and raises
  :class:`TimeoutError`.

The backend defaults to :func:`~cruise_control_tpu_torch.parallel.mesh.choose_backend`:
``nccl`` with a card per rank, ``gloo`` when the ranks share one card or run
on the CPU.  Build the CUDA kernels in the parent before starting ranks on
the card (``ops._build.build_all``): the ranks then only load them, instead
of racing each other's ``nvcc`` into the same build directory.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch.multiprocessing as mp

from cruise_control_tpu_torch.core.device import DeviceLike

#: default limit of a whole run, and of one collective's wait
DEFAULT_TIMEOUT_S = 600.0


def _rank_main(fn, rank, world, device, backend, init_file, timeout_s, results, args):
    import torch.distributed as dist

    from cruise_control_tpu_torch.parallel.mesh import solver_mesh

    try:
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            out = fn(solver_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def _failures(results, world: int, failed: dict, grace_s: float = 2.0) -> str:
    """The message of a failed run: the first failure's peers usually fail
    next (their collective loses its connection), so the reports that
    arrive within ``grace_s`` are collected and every traceback is shown,
    in rank order."""
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            rank, ok, value = results.get(timeout=max(end - time.monotonic(), 0.01))
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = value
    ranks = sorted(failed)
    return f"run_ranks: rank(s) {ranks} of {world} failed:\n" + "\n".join(
        f"-- rank {r}:\n{failed[r]}" for r in ranks
    )


def run_ranks(
    fn: Callable,
    world: int,
    device: DeviceLike = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    args: Sequence = (),
) -> List:
    """Run ``fn(mesh, *args)`` on ``world`` ranks; their results in rank order."""
    from cruise_control_tpu_torch.core.device import resolve_device
    from cruise_control_tpu_torch.parallel.mesh import choose_backend

    dev = resolve_device(device)
    if backend is None:
        backend = choose_backend(world, dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs ranks on CUDA devices")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    workdir = tempfile.mkdtemp(prefix="cc-ranks-")
    init_file = os.path.join(workdir, "rendezvous")
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, world, str(dev), backend, init_file, timeout_s, results, tuple(args)),
            daemon=True,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout_s
    out = [None] * world
    done = set()
    try:
        for p in procs:
            p.start()
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(done)} of {world} ranks still running after {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"run_ranks: rank {dead[0]} exited with code {procs[dead[0]].exitcode} before reporting"
                    )
                continue
            if not ok:
                raise RuntimeError(_failures(results, world, {rank: value}))
            out[rank] = value
            done.add(rank)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(workdir, ignore_errors=True)
