"""The port's analyzer layer against the JAX package, module by module.

* ``take_snapshot`` field by field and the ``[NUM_GOALS]`` violation vector,
  with ``enable_heavy`` on and off;
* one round of every round function of every default goal, at its place in
  the default order: the same ``MoveBatch``, the same ``accept_all`` mask and
  the same ``admit`` keep-set;
* focused cases for the places PyTorch and JAX differ (int32 wraparound,
  stable-sort ties, duplicate-index scatters, out-of-range drops, empty
  segments, the float scan order).

JAX runs eagerly on the CPU (no Pallas kernel is reached there).  Ints and
bools must be exact.  Floats within rtol=1e-6, atol=1e-6.  The per-broker
sums, the scan and the cross-broker sums behind the balance bands add in the
JAX CPU order; ``test_torch_snapshot_bands.py`` holds the snapshot to the
JAX package's bit for bit.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import acceptance as JAcc
from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.analyzer import goal_rounds as JR
from cruise_control_tpu.analyzer import goals_base as JG
from cruise_control_tpu.analyzer import moves as JM
from cruise_control_tpu.analyzer import optimizer as JO
from cruise_control_tpu.analyzer import proposers as JP
from cruise_control_tpu.model import arrays as JA
from cruise_control_tpu_torch.analyzer import acceptance as PAcc
from cruise_control_tpu_torch.analyzer import context as PC
from cruise_control_tpu_torch.analyzer import goal_rounds as PRounds
from cruise_control_tpu_torch.analyzer import goals_base as PG
from cruise_control_tpu_torch.analyzer import moves as PM
from cruise_control_tpu_torch.analyzer import optimizer as PO
from cruise_control_tpu_torch.analyzer import proposers as PP
from cruise_control_tpu_torch.ops import index as PI
from tests.torch_port_helpers import (
    CONFIG1,
    SMALL20,
    assert_fields_same,
    assert_same,
    port_ctx,
    port_state,
    to_np,
)

TOL = dict(rtol=1e-6, atol=1e-6)
DEFAULT = tuple(range(16))
_NO_SPMD = types.SimpleNamespace(spmd=None)   # single-device JAX snapshot view


def _case(spec, **ctx_kw):
    """(jax state, jax ctx, port state, port ctx), broker axis bucketed as
    ``optimize`` pads it."""
    jstate, _ = JS.generate(JS.SyntheticSpec(**spec))
    jctx = JC.GoalContext.build(jstate.num_topics, jstate.num_brokers, **ctx_kw)
    bucket = JA.broker_bucket(jstate.num_brokers)
    jstate = JA.pad_brokers(jstate, bucket)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    jctx = JC.pad_context_brokers(jctx, bucket)
    return jstate, jctx, port_state(jstate), port_ctx(jctx)


@pytest.fixture(scope="module")
def small20():
    return _case(SMALL20)


@pytest.fixture(scope="module")
def small20_capped():
    """max_active_brokers=4: every round caps and rotates its sources."""
    return _case(SMALL20, max_active_brokers=4)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("spec", [CONFIG1, SMALL20], ids=["config1", "small20"])
def test_snapshot_field_by_field(spec, heavy):
    jstate, jctx, pstate, pctx = _case(spec)
    want = JC.take_snapshot(jstate, jctx, heavy)
    got = PC.take_snapshot(pstate, pctx, heavy)
    assert_fields_same(got, want, skip=("enable_heavy",), **TOL)
    assert got.enable_heavy == want.enable_heavy


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("spec", [CONFIG1, SMALL20], ids=["config1", "small20"])
def test_violation_vector(spec, heavy):
    jstate, jctx, pstate, pctx = _case(spec)
    want = JO._violations_fn(jstate, jctx, heavy, DEFAULT)
    got = PO._violations_fn(pstate, pctx, heavy, DEFAULT)
    assert_same(got, want, "violations")


def test_snapshot_needs_match_jax():
    """Each goal's optional snapshot groups, for its step and for the
    violation vector, are the JAX package's."""
    for gid in range(JG.NUM_GOALS):
        assert PG.goal_snapshot_needs(gid) == JG.goal_snapshot_needs(gid), gid
        assert PG.violation_needs((gid,)) == JG.violation_needs((gid,)), gid
    assert PG.violation_needs(DEFAULT) == JG.violation_needs(DEFAULT)
    assert PG.violation_needs(None) == JG.violation_needs(None)
    assert PC.ALL_NEEDS == JC.ALL_NEEDS


@pytest.mark.parametrize("gid", DEFAULT, ids=[JG.GOAL_NAMES[g] for g in DEFAULT])
def test_trimmed_snapshot_computes_only_what_the_goal_needs(small20, gid):
    """A goal step's snapshot leaves out the groups it does not need (None)
    and keeps every other field equal to the full snapshot's."""
    _, _, pstate, pctx = small20
    full = PC.take_snapshot(pstate, pctx, True)
    trimmed = PC.take_snapshot(pstate, pctx, True, PG.goal_snapshot_needs(gid))
    groups = {
        PC.NEED_RACK_FIRST: ("rack_first2", "rack_viol_need"),
        PC.NEED_LEADER: ("leader_broker", "leader_eff"),
        PC.NEED_PREF: ("preferred_leader",),
        PC.NEED_BROKER_SET: ("broker_set_need",),
    }
    optional = {f for fields in groups.values() for f in fields}
    for need, fields in groups.items():
        for f in fields:
            assert (getattr(trimmed, f) is None) == (need not in PG.goal_snapshot_needs(gid)), f
    kept = [f for f in vars(full) if f not in optional]
    for f in kept:
        a, b = getattr(trimmed, f), getattr(full, f)
        assert a is None and b is None or a is b or torch.equal(a, b), f


def test_triggered_by_violation_widens_bands():
    jstate, jctx, pstate, pctx = _case(SMALL20, triggered_by_violation=True)
    jctx = jctx.replace(
        constraint=jctx.constraint.replace(
            distribution_threshold_multiplier=jnp.float32(1.5)
        )
    )
    pctx = port_ctx(jctx)
    assert_fields_same(
        PC.take_snapshot(pstate, pctx, True), JC.take_snapshot(jstate, jctx, True),
        skip=("enable_heavy",), **TOL,
    )


def _round_cases():
    for pos, gid in enumerate(DEFAULT):
        for i in range(len(JR.GOAL_ROUNDS[gid])):
            yield pytest.param(pos, gid, i, id=f"{JG.GOAL_NAMES[gid]}-{i}")


def _compare_round(case, pos, gid, i, salt):
    """One round of goal ``gid``: the JAX package's full snapshot against the
    port's, trimmed to the groups the goal's step computes."""
    jstate, jctx, pstate, pctx = case
    prior = PO._np_mask(DEFAULT[:pos])
    admit_ids = PO._np_mask(DEFAULT[: pos + 1])
    jsnap = JC.take_snapshot(jstate, jctx, True)
    psnap = PC.take_snapshot(pstate, pctx, True, PG.goal_snapshot_needs(gid))
    jm = JR.GOAL_ROUNDS[gid][i](jstate, jctx, jsnap, prior, jnp.int32(salt))
    pm = PRounds.GOAL_ROUNDS[gid][i](pstate, pctx, psnap, prior, salt)
    assert pm.kind == int(jm.kind)
    for name in ("replica", "dst_broker", "dst_replica"):
        assert_same(getattr(pm, name), getattr(jm, name), name)
    assert_same(pm.score, jm.score, "score", **TOL)
    assert_same(1 if pm.windows is None else pm.windows, jm.windows, "windows")

    jeff = JM.move_effects(jstate, jm, jsnap)
    peff = PM.move_effects(pstate, pm, psnap)
    assert_fields_same(peff, jeff, **TOL)
    jok = jm.valid & JAcc.accept_all(jstate, jctx, jsnap, jm, jeff, prior)
    pok = pm.valid & PAcc.accept_all(pstate, pctx, psnap, pm, peff, prior)
    assert_same(pok, jok, "accept_all")
    jkeep = JM.admit(jstate, jctx, jsnap, jm, jok, jeff, admit_ids)
    pkeep = PM.admit(pstate, pctx, psnap, pm, pok, peff, admit_ids)
    assert_same(pkeep, jkeep, "admit")
    return int(to_np(pm.valid).sum())


@pytest.mark.parametrize("pos,gid,i", list(_round_cases()))
def test_one_round_per_default_goal(small20, small20_capped, pos, gid, i):
    _compare_round(small20, pos, gid, i, salt=0)
    _compare_round(small20_capped, pos, gid, i, salt=3)


def test_rounds_have_work_to_compare(small20):
    """The parity cases above are not vacuous: most round types propose moves
    on the skewed 20-broker cluster."""
    proposing = sum(
        _compare_round(small20, pos, gid, i, salt=0) > 0
        for pos, gid in enumerate(DEFAULT)
        for i in range(len(JR.GOAL_ROUNDS[gid]))
    )
    assert proposing >= 12


@pytest.mark.parametrize("fn", ["offline_round", "offline_round_relaxed"])
def test_offline_rounds_with_a_dead_broker(fn):
    jstate, jctx, _, _ = _case(SMALL20)
    jstate = JA.set_broker_state(jstate, 1, alive=False)
    pstate, pctx = port_state(jstate), port_ctx(jctx)
    jsnap = JC.take_snapshot(jstate, jctx, True)
    psnap = PC.take_snapshot(pstate, pctx, True, frozenset())   # as the pre-phase takes it
    prior = PO._np_mask(())
    jm = getattr(JR, fn)(jstate, jctx, jsnap, prior, jnp.int32(0))
    pm = getattr(PRounds, fn)(pstate, pctx, psnap, prior, 0)
    assert int(to_np(pm.valid).sum()) > 0
    for name in ("replica", "dst_broker"):
        assert_same(getattr(pm, name), getattr(jm, name), name)


def test_resolve_conflicts_matches(small20):
    jstate, jctx, pstate, pctx = small20
    jsnap = JC.take_snapshot(jstate, jctx, True)
    psnap = PC.take_snapshot(pstate, pctx, True)
    prior = PO._np_mask(())
    jm = JR.GOAL_ROUNDS[JG.DISK_USAGE_DIST][0](jstate, jctx, jsnap, prior, jnp.int32(0))
    pm = PRounds.GOAL_ROUNDS[PG.DISK_USAGE_DIST][0](pstate, pctx, psnap, prior, 0)
    assert_same(
        PM.resolve_conflicts(pstate, pm, pm.valid),
        JM.resolve_conflicts(jstate, jm, jm.valid),
        "resolve_conflicts",
    )


# -- places where PyTorch and JAX differ ----------------------------------------------


def test_pair_jitter_int32_wraparound():
    rng = np.random.default_rng(0)
    a = rng.integers(2**30, 2**31 - 1, size=500).astype(np.int32)
    b = rng.integers(0, 2**31 - 1, size=500).astype(np.int32)
    for salt in (0, 7, 2**31 - 1):
        want = JP._pair_jitter(jnp.asarray(a), jnp.asarray(b), jnp.int32(salt))
        got = PP._pair_jitter(torch.from_numpy(a), torch.from_numpy(b), salt)
        assert_same(got, want, f"jitter salt={salt}")
    # broadcast form used by the destination choice
    want = JP._pair_jitter(jnp.asarray(a[:7])[:, None], jnp.arange(9, dtype=jnp.int32)[None, :], 5)
    got = PP._pair_jitter(torch.from_numpy(a[:7])[:, None], torch.arange(9, dtype=torch.int32)[None, :], 5)
    assert_same(got, want, "jitter broadcast")


def _near_tie_rows(rng, S: int, B: int, salt: int):
    """``(candidate ids [S], gains [S, B])``: in each row two columns of one
    gain ``g`` (every other column far below), chosen so that ``g`` plus the
    jitter rounded twice ties the two (the first wins) while the sum rounded
    once puts the second first.  Which hash values can do that depends on
    ``g``'s exponent, so each row draws its candidate id until its hashes
    hold such a pair."""
    hs = np.arange(1024)
    cand = np.zeros(S, np.int32)
    x = np.full((S, B), -1e4, np.float32)
    cols = torch.arange(B, dtype=torch.int32)
    for i in range(S):
        while True:
            c = int(rng.integers(0, 300_000))
            hv, col = np.unique(PP._pair_hash(torch.tensor([c], dtype=torch.int32), cols, salt).numpy(),
                                return_index=True)     # each hash value's first column
            g = np.float32(2.0 ** rng.integers(2, 12) * (1 + rng.random()))
            twice = (g + (np.float32(-PP.TIEBREAK) * hs.astype(np.float32)) / np.float32(1024))[hv]
            once = (np.float64(g) + hs * PP._JITTER_STEP).astype(np.float32)[hv]
            pairs = np.argwhere((col[:, None] < col[None, :]) & (twice[:, None] >= twice[None, :])
                                & (once[:, None] < once[None, :]))
            if len(pairs):
                cand[i] = c
                x[i, col[pairs[0]]] = g
                break
    return cand, x


@pytest.mark.parametrize("near_ties", [True, False])
def test_jitter_sums_round_as_the_compiled_jax_rounds(near_ties):
    """ROADMAP C6: a destination score plus its jitter, as the JAX package's
    compiled rounds compute it.  XLA folds the jitter's constants and fuses
    the product into the add (one rounding), so the plain f32 sum differs in
    the last bit for about one element in 8,000 -- at config #3's 300,000
    replicas that flipped a swap round's argmax of ReplicaDistributionGoal.
    The input: candidate replicas (ids below 300,000) against config #3's
    1,024 broker columns; with ``near_ties`` each row holds two columns of
    equal gain whose order only that last bit decides."""
    rng = np.random.default_rng(6)
    S, B, salt = (16 if near_ties else 1024), 1024, 31
    if near_ties:
        cand, x = _near_tie_rows(rng, S, B, salt)
    else:
        cand = rng.integers(0, 300_000, size=S).astype(np.int32)
        x = (rng.standard_normal((S, B)) * 1000).astype(np.float32)
    cols = np.arange(B, dtype=np.int32)
    a, b = torch.from_numpy(cand)[:, None], torch.from_numpy(cols)[None, :]

    @jax.jit
    def jax_round(x, a, b):
        score = x + JP._pair_jitter(a[:, None], b[None, :], jnp.int32(salt))
        return score, jnp.argmax(score, axis=1).astype(jnp.int32)

    want, want_dst = (np.asarray(v) for v in jax_round(jnp.asarray(x), jnp.asarray(cand), jnp.asarray(cols)))
    got = PP._plus_jitter(torch.from_numpy(x), a, b, salt)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(PP._argmax_rows(got)[0].numpy(), want_dst)
    # the input shows the fault: the sum rounded twice differs
    plain = torch.from_numpy(x) + PP._pair_jitter(a, b, salt)
    assert (plain.numpy() != want).any()
    if near_ties:
        assert (PP._argmax_rows(plain)[0].numpy() != want_dst).all()


def test_stable_argsort_ties():
    scores = np.asarray([3, 1, 3, 3, 0, 1, 3, 2, 2, 3], np.float32)
    cand = np.asarray([1, 1, 0, 1, 1, 1, 1, 1, 0, 1], bool)
    jm = JM.MoveBatch.empty(10, 0).replace(score=jnp.asarray(scores))
    none = torch.full((10,), -1, dtype=torch.int32)
    pm = PM.MoveBatch(kind=0, replica=none, dst_broker=none, dst_replica=none,
                      score=torch.from_numpy(scores))
    assert_same(
        PM._score_rank(pm, torch.from_numpy(cand)),
        JM._score_rank(jm, jnp.asarray(cand)), "rank",
    )
    need = np.asarray([2, 5, 2, 0, 5, 2, 2, 0, 1, 5, 2, 2], np.float32)
    for salt in range(4):
        jids, jwin = JP._cap_sources(jnp.asarray(need), 3, jnp.int32(salt))
        pids, pwin = PP._cap_sources(torch.from_numpy(need), 3, salt)
        assert_same(pids, jids, "cap ids")
        assert_same(pwin, jwin, "windows")
    key = np.asarray([4, 1, 4, 1, 4, 2, 1, 4], np.int32)
    rank = np.asarray([7, 0, 3, 5, 1, 2, 6, 4], np.int32)
    vals = np.random.default_rng(1).exponential(size=(8, 3)).astype(np.float32)
    assert_same(
        PM._segment_rank_cumsum(torch.from_numpy(vals), torch.from_numpy(key), torch.from_numpy(rank)),
        JM._segment_rank_cumsum(jnp.asarray(vals), jnp.asarray(key), jnp.asarray(rank)),
        "segment cumsum",
    )


def test_duplicate_partition_scatter_last_write_wins(small20):
    """Candidates sharing a partition: the JAX CPU scatter keeps the last
    slot, and only that slot stays unmasked."""
    jstate, _, pstate, _ = small20
    part = np.asarray([5, 9, 5, 3, 9, 5, 0, 3], np.int32)
    valid = np.asarray([1, 1, 1, 1, 1, 0, 1, 1], bool)
    want = JP._partition_occupancy(jstate, _NO_SPMD, jnp.asarray(part), jnp.asarray(valid))
    got = PP._partition_occupancy(pstate, torch.from_numpy(part), torch.from_numpy(valid))
    assert_same(got, want, "occupancy")
    dst = jnp.asarray([4, 0, 9, 2], jnp.int32)
    want = JP._partition_occupancy(jstate, _NO_SPMD, jnp.asarray(part), jnp.asarray(valid), dst_brokers=dst)
    got = PP._partition_occupancy(
        pstate, torch.from_numpy(part), torch.from_numpy(valid), dst_brokers=torch.tensor([4, 0, 9, 2], dtype=torch.int32)
    )
    assert_same(got, want, "occupancy restricted")
    slot = PI.scatter_last(torch.full((12,), -1, dtype=torch.int32), torch.from_numpy(part), torch.arange(8, dtype=torch.int32))
    ref = jnp.full(12, -1, jnp.int32).at[jnp.asarray(part)].set(jnp.arange(8, dtype=jnp.int32), mode="drop")
    assert_same(slot, ref, "scatter_last")


def test_out_of_range_writes_drop():
    target = np.arange(6, dtype=np.int32)
    idx = np.asarray([2, 6, 99, -1, 0], np.int32)
    vals = np.asarray([20, 60, 990, -10, 100], np.int32)
    want = jnp.asarray(target).at[jnp.asarray(idx)].set(jnp.asarray(vals), mode="drop")
    got = PI.scatter_set(torch.from_numpy(target), torch.from_numpy(idx), torch.from_numpy(vals))
    assert_same(got, want, "scatter_set")
    scores = np.asarray([1, 5, 2, 7, 3], np.float32)
    seg = np.asarray([0, 0, 1, 1, 1], np.int32)
    el = np.asarray([1, 1, 0, 1, 1], bool)
    assert_same(
        PP.topk_segment_argmax(torch.from_numpy(scores), torch.from_numpy(seg), 3, torch.from_numpy(el), 3),
        JP.topk_segment_argmax(jnp.asarray(scores), jnp.asarray(seg), 3, jnp.asarray(el), 3),
        "topk",
    )


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_empty_segments_get_the_identity(dtype):
    data = np.asarray([4, -2, 7, 1], dtype)
    seg = np.asarray([0, 0, 3, 9], np.int32)   # segments 1, 2 empty; 9 dropped
    for pfn, jfn in ((PI.segment_max, jax.ops.segment_max), (PI.segment_min, jax.ops.segment_min)):
        assert_same(
            pfn(torch.from_numpy(data), torch.from_numpy(seg), 5),
            jfn(jnp.asarray(data), jnp.asarray(seg), num_segments=5),
            pfn.__name__,
        )
    scores = np.asarray([1, 1, 2, 0], np.float32)
    elig = np.asarray([1, 1, 1, 0], bool)
    assert_same(
        PC.segment_argmax(torch.from_numpy(scores), torch.from_numpy(seg), 5, torch.from_numpy(elig)),
        JC.segment_argmax(jnp.asarray(scores), jnp.asarray(seg), 5, jnp.asarray(elig)),
        "segment_argmax",
    )


@pytest.mark.parametrize("n", [1, 16, 17, 100, 257, 1000, 4100])
def test_cumsum_adds_in_the_xla_cpu_order(n):
    x = (np.random.default_rng(n).exponential(size=(n, 8)) * 1000).astype(np.float32)
    np.testing.assert_array_equal(
        PI.cumsum(torch.from_numpy(x)).numpy(), np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
    )


def test_acceptance_matrices_with_every_default_goal_prior(small20):
    jstate, jctx, pstate, pctx = small20
    prior = PO._np_mask(DEFAULT)
    jsnap = JC.take_snapshot(jstate, jctx, True)
    psnap = PC.take_snapshot(pstate, pctx, True)
    R, B = pstate.num_replicas, pstate.num_brokers
    rng = np.random.default_rng(2)
    cand = rng.integers(0, R, size=40).astype(np.int32)
    valid = rng.random(40) < 0.9
    partner = rng.integers(0, R, size=B).astype(np.int32)
    pvalid = rng.random(B) < 0.8
    cols = np.asarray([3, 0, 17, 9, 30], np.int32)
    J, P = jnp.asarray, torch.from_numpy
    for dst in (None, cols):
        assert_same(
            PAcc.move_dst_matrix(pstate, pctx, psnap, P(cand), P(valid), prior,
                                 dst_brokers=None if dst is None else P(dst)),
            JAcc.move_dst_matrix(jstate, jctx, jsnap, J(cand), J(valid), prior,
                                 dst_brokers=None if dst is None else J(dst)),
            f"move_dst_matrix cols={dst}",
        )
    assert_same(
        PAcc.swap_dst_matrix(pstate, pctx, psnap, P(cand), P(valid), P(partner), P(pvalid), prior),
        JAcc.swap_dst_matrix(jstate, jctx, jsnap, J(cand), J(valid), J(partner), J(pvalid), prior),
        "swap_dst_matrix",
    )
    assert_same(
        PAcc.leadership_target_ok(pstate, pctx, psnap, prior),
        JAcc.leadership_target_ok(jstate, jctx, jsnap, prior),
        "leadership_target_ok",
    )


def test_topic_leader_upper_and_rack_fair_share(small20):
    jstate, jctx, pstate, pctx = small20
    jsnap = JC.take_snapshot(jstate, jctx, True)
    psnap = PC.take_snapshot(pstate, pctx, True)
    assert_same(
        PC.topic_leader_upper(pstate, pctx, psnap),
        JC.topic_leader_upper(jstate, jctx, jsnap), "topic_leader_upper",
    )
    parts = np.asarray([0, 5, 77, 119, 5], np.int32)
    assert_same(
        PC.rack_fair_share(pstate, psnap, torch.from_numpy(parts)),
        JC.rack_fair_share(jstate, jsnap, jnp.asarray(parts)), "rack_fair_share",
    )
