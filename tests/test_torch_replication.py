"""The port's replicated read plane against the JAX package's.

``core/journal.py``'s live cursor (``Journal.tail`` / ``JournalTail``),
epoch fencing, ``replication.ReplicationState`` and ``FollowerTailer``.  The
JAX test classes of ``tests/test_replication.py`` run unchanged against the
port (``port_test_module``; the HTTP-served ``TestFollowerServing`` over the
port's writer and follower apps, bound to ``device="cpu"`` explicitly).  Then the two packages on one directory: a journal either
one writes is tailed by the other record for record, through rotations, torn
tails and a compaction; and the same controller-WAL records folded by both
packages' ``ReplicationState`` give the same sets, stamps and watch deltas.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_replication", device="cpu")
TestJournalTail = _PORTED.TestJournalTail
TestEpochFencing = _PORTED.TestEpochFencing
TestReplicationState = _PORTED.TestReplicationState
TestChaosJournalFaults = _PORTED.TestChaosJournalFaults
repl_pair = _PORTED.repl_pair
TestFollowerServing = _PORTED.TestFollowerServing


def _packages():
    import cruise_control_tpu.core.journal as jj
    import cruise_control_tpu_torch.core.journal as pj

    return {"jax": jj, "port": pj}


def _records(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [
        {"i": i, "v": float(rng.normal()), "tag": f"r{int(rng.integers(0, 1000))}",
         "nested": {"k": [int(x) for x in rng.integers(0, 9, size=3)]}}
        for i in range(n)
    ]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_journal_one_package_writes_the_other_tails(tmp_path, writer, reader):
    """Appends across rotations, polled between batches, a torn ``.open``
    tail (parked, then completed), then a compaction: the reader of the other
    package sees every record once, in order, and one reset."""
    pkgs = _packages()
    w = pkgs[writer].Journal(str(tmp_path), max_segment_records=4)
    tail = pkgs[reader].JournalTail(str(tmp_path))
    recs = _records(3, 23)
    got = []
    for batch in (recs[:3], recs[3:11], recs[11:19]):
        for r in batch:
            w.append(r)
        got.extend(tail.poll())
    assert got == recs[:19] and tail.resets == 0 and tail.skipped == 0
    # a torn tail: half a line in the active segment parks the cursor
    open_seg = [f for f in os.listdir(tmp_path) if f.endswith(".open")]
    assert len(open_seg) == 1
    line = json.dumps({"c": "00000000", "r": recs[19]}, separators=(",", ":"))
    with open(tmp_path / open_seg[0], "a") as f:
        f.write(line[: len(line) // 2])
        f.flush()
    assert tail.poll() == [] and tail.skipped == 0
    w.close()
    # the writer's restart seals the torn segment: the torn line is skipped
    # for good, and the WAL flows on in the next segment
    w2 = pkgs[writer].Journal(str(tmp_path), max_segment_records=4)
    for r in recs[19:]:
        w2.append(r)
    assert tail.poll() == recs[19:] and tail.skipped == 1 and tail.resets == 0
    # compaction: the writer truncates and re-appends the live record
    w2.truncate()
    w2.append(recs[-1])
    assert tail.poll() == [recs[-1]] and tail.resets == 1
    w2.close()


def _controller_journal(pkg: str, directory: str):
    if pkg == "jax":
        from cruise_control_tpu.controller.standing import ControllerJournal
        from cruise_control_tpu.core.journal import Journal
    else:
        from cruise_control_tpu_torch.controller.standing import ControllerJournal
        from cruise_control_tpu_torch.core.journal import Journal
    return ControllerJournal(Journal(directory))


def _standing(pkg: str, version: int, seed: int):
    if pkg == "jax":
        from cruise_control_tpu.analyzer.proposals import ExecutionProposal
        from cruise_control_tpu.controller.standing import StandingProposalSet
    else:
        from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
        from cruise_control_tpu_torch.controller.standing import StandingProposalSet
    rng = np.random.default_rng(seed)
    proposals = []
    for p in range(int(rng.integers(1, 6))):
        old = tuple(int(b) for b in rng.choice(8, size=3, replace=False))
        new = tuple(int(b) for b in rng.choice(8, size=3, replace=False))
        proposals.append(ExecutionProposal(tp=(f"T{seed}", p), partition_size=float(rng.uniform(1, 9)),
                                           old_leader=old[0], old_replicas=old, new_replicas=new))
    return StandingProposalSet(version=version, created_ms=1_000 * version, trigger="drift",
                               drift=float(rng.uniform(1, 3)), proposals=proposals, reaction_s=0.5, epoch=0)


def _state_view(state) -> dict:
    """A ``ReplicationState`` as plain data: the set (proposal records), the
    version and epoch, and the watch deltas without their wall-clock stamps."""
    import cruise_control_tpu_torch.executor.journal as pej

    s = state.standing
    deltas, _, resync = state.watch(0, 0.0)
    return {
        "set_version": state.set_version, "epoch": state.epoch, "seq": state.seq, "applied": state.applied,
        "standing": None if s is None else (s.version, s.trigger, s.drift, s.epoch, s.reaction_s,
                                            [pej.proposal_to_record(p) for p in s.proposals]),
        "deltas": [{k: v for k, v in d.items() if k != "tsMs"} for d in deltas], "resync": resync,
        "role": state.stamp()["role"],
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_followers_of_both_packages_fold_one_wal_alike(tmp_path, writer):
    """A writer of either package publishes, invalidates, re-fences and
    compacts its controller WAL; a JAX and a port follower tail it, and a
    writer-side state of each package is fed by the journal's listener.
    Followers and writers each end equal across packages, and the followers'
    sets equal the writers'."""
    from cruise_control_tpu.replication import FollowerTailer as JFollower
    from cruise_control_tpu.replication import ReplicationState as JState
    from cruise_control_tpu_torch.replication import FollowerTailer, ReplicationState

    directory = str(tmp_path / "controller")
    cj = _controller_journal(writer, directory)
    writers = {"jax": JState(writer=True), "port": ReplicationState(writer=True)}
    cj.listener = lambda rec: [s.apply(rec) for s in writers.values()]
    followers = {"jax": JFollower(directory, JState()), "port": FollowerTailer(directory, ReplicationState())}
    cj.fence(1)
    for v in (1, 2, 3):
        cj.published(_standing(writer, v, seed=v))
        applied = {k: f.poll_once() for k, f in followers.items()}
        assert applied["jax"] == applied["port"] > 0
    cj.invalidated(3, "drift")
    cj.fence(2)
    cj.published(_standing(writer, 4, seed=4))
    for f in followers.values():
        f.poll_once()
    views = {k: _state_view(f.state) for k, f in followers.items()}
    assert views["port"] == views["jax"]
    assert {k: _state_view(s) for k, s in writers.items()}["port"] == _state_view(writers["jax"])
    assert views["port"]["standing"] == _state_view(writers["port"])["standing"]
    assert views["port"]["set_version"] == 4 and views["port"]["epoch"] == 2
    # compaction: each follower sees one reset, applies no delta, keeps the set
    standing4 = _standing(writer, 4, seed=4)
    standing4.epoch = 2
    seqs = {k: f.state.seq for k, f in followers.items()}
    cj.rewrite(standing4)
    for k, f in followers.items():
        f.poll_once()
        assert f.tail.resets == 1 and f.state.seq == seqs[k]
    after = {k: _state_view(f.state) for k, f in followers.items()}
    assert after["port"]["standing"] == after["jax"]["standing"] == views["port"]["standing"]
    cj.close()


def test_replication_state_deltas_match_the_jax_state():
    """One seeded record stream (publishes, duplicates, regressions, epochs,
    invalidations, drains) through both packages' ``apply``, then a
    ``rebase``: equal views after every record."""
    from cruise_control_tpu.replication import ReplicationState as JState
    from cruise_control_tpu_torch.replication import ReplicationState

    rng = np.random.default_rng(11)
    states = (JState(ring_size=8), ReplicationState(ring_size=8))
    version, epoch, stream = 0, 1, []
    for _ in range(60):
        kind = rng.choice(["published", "published", "dup", "epoch", "invalidated", "drained"])
        if kind == "published":
            version += 1
            stream.append({"type": "published", "version": version, "epoch": epoch, "created_ms": version,
                           "trigger": "drift", "drift": float(rng.uniform()), "reaction_s": 0.1,
                           "proposals": [{"tp": ["T", int(rng.integers(9))], "partition_size": 1.0,
                                          "old_leader": 0, "old_replicas": [0, 1], "new_replicas": [1, 2]}]})
        elif kind == "dup" and version:
            stream.append({"type": "published", "version": int(rng.integers(1, version + 1)), "epoch": epoch,
                           "proposals": []})
        elif kind == "epoch":
            epoch += int(rng.integers(0, 2))
            stream.append({"type": "epoch", "epoch": epoch})
        elif version:
            stream.append({"type": kind, "version": version, "epoch": epoch, "reason": "r", "completed": 3})
    for rec in stream:
        for s in states:
            s.apply(dict(rec))
        assert _state_view(states[1]) == _state_view(states[0])
    tail = [r for r in stream if r["type"] == "published"][-3:]
    for s in states:
        s.rebase([dict(r) for r in tail])
    assert _state_view(states[1]) == _state_view(states[0])
