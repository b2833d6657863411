"""The port's segment sum against the JAX package's Pallas kernels and XLA.

Every case of ``tests/test_ops.py`` (flat shapes, radix shapes, out-of-range
ids, 1-D squeeze, int dtype) is run through the port's ``segment_sum`` on the
CPU (its plain version) and held against ``segment_sum_pallas`` /
``segment_sum_radix`` in interpret mode and ``jax.ops.segment_sum``.  Ints must
be exact.  Floats within rtol=1e-5, atol=1e-5 against the Pallas kernels, the
tolerance ``test_ops.py`` uses (the one-hot contraction sums in another
order); against the XLA CPU scatter, which adds row by row as the plain
version does, floats must be bitwise equal.

The CUDA kernel itself is exercised on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.ops.segments import segment_sum_pallas, segment_sum_radix
from cruise_control_tpu_torch.ops import segments as PS

RTOL = ATOL = 1e-5


def _port(vals, seg, S):
    return PS.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), S).numpy()


def _check(vals, seg, S, kernel):
    got = _port(vals, seg, S)
    want_k = np.asarray(kernel(jnp.asarray(vals), jnp.asarray(seg), S, interpret=True))
    want_x = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=S))
    assert got.shape == want_x.shape and got.dtype == want_x.dtype
    np.testing.assert_allclose(got, want_k, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, want_x)


@pytest.mark.parametrize("R,B,C", [(37, 5, 4), (512, 128, 1), (1000, 40, 7)])
def test_flat_shapes_match_pallas_and_xla(R, B, C):
    rng = np.random.default_rng(R + B + C)
    vals = rng.normal(size=(R, C)).astype(np.float32)
    seg = rng.integers(0, B, size=R).astype(np.int32)
    _check(vals, seg, B, segment_sum_pallas)


def test_flat_drops_out_of_range():
    vals = np.ones((10, 2), np.float32)
    seg = np.asarray([0, 1, 2, 3, -1, 99, 4, 4, 2, -7], np.int32)
    _check(vals, seg, 5, segment_sum_pallas)


def test_flat_1d_and_int():
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 17, size=300).astype(np.int32)
    _check(np.ones(300, np.float32), seg, 17, segment_sum_pallas)
    ints = rng.integers(-5, 9, size=300).astype(np.int32)
    got = _port(ints, seg, 17)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(ints), jnp.asarray(seg), num_segments=17))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R,B,C", [(64, 2500, 3), (700, 4000, 7), (300, 3000, 1)])
def test_radix_shapes_match_pallas_and_xla(R, B, C):
    rng = np.random.default_rng(R + B + C)
    vals = rng.normal(size=(R, C)).astype(np.float32)
    seg = rng.integers(0, B, size=R).astype(np.int32)
    _check(vals, seg, B, segment_sum_radix)


def test_radix_drops_out_of_range():
    vals = np.ones((12, 2), np.float32)
    seg = np.asarray([0, 1, 2500, 3000, -1, 9999, 4, 4, 2, -7, 2048, 2049], np.int32)
    _check(vals, seg, 2600, segment_sum_radix)


def test_radix_1d_squeeze():
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 3001, size=400).astype(np.int32)
    got = _port(np.ones(400, np.float32), seg, 3001)
    assert got.shape == (3001,)
    _check(np.ones(400, np.float32), seg, 3001, segment_sum_radix)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_int_and_bool_keep_their_dtype(dtype):
    rng = np.random.default_rng(5)
    seg = rng.integers(-2, 9, size=200).astype(np.int32)
    vals = rng.integers(0, 2, size=200).astype(dtype)
    got = _port(vals, seg, 9)
    assert got.dtype == np.dtype(dtype)
    counts = np.zeros(9, np.int64)
    for v, s in zip(vals.astype(np.int64), seg):
        if 0 <= s < 9:
            counts[s] += v
    np.testing.assert_array_equal(got, counts > 0 if dtype is np.bool_ else counts.astype(dtype))


def test_rack_count_scale_int_exact():
    """S = 100,000 with int input, the (partition, rack) count table's size at
    config #2 (10,000 partitions x 10 racks)."""
    rng = np.random.default_rng(9)
    R, S = 30_000, 100_000
    seg = rng.integers(0, S, size=R).astype(np.int32)
    ones = np.ones(R, np.int32)
    got = _port(ones, seg, S)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(ones), jnp.asarray(seg), num_segments=S))
    np.testing.assert_array_equal(got, want)


def test_config2_shapes_float_bitwise_vs_xla():
    """[30000, 4] f32 over 128 segments (broker loads at config #2): the plain
    version adds in row order, like the XLA CPU scatter, so the sums agree
    bit for bit."""
    rng = np.random.default_rng(13)
    vals = (rng.exponential(size=(30_000, 4)) * 1000).astype(np.float32)
    seg = rng.integers(0, 128, size=30_000).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=128))
    np.testing.assert_array_equal(_port(vals, seg, 128), want)


def test_cpu_path_never_launches_the_kernel():
    PS.reset_launch_counts()
    _port(np.ones(50, np.float32), np.zeros(50, np.int32), 3)
    _port(np.ones(50, np.int32), np.zeros(50, np.int32), 3)
    assert PS.LAUNCHES == {"segment_sum_f32": 0, "segment_sum_i32": 0}


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        PS.segment_sum_cuda(torch.ones(4), torch.zeros(4, dtype=torch.int32), 2)


def _mixed_columns(R, seed):
    rng = np.random.default_rng(seed)
    return [
        (rng.exponential(size=(R, 4)) * 1000).astype(np.float32),   # broker loads
        rng.random(R) < 0.9,                                        # bool: counted
        rng.normal(size=R).astype(np.float32),
        rng.integers(0, 3, size=R).astype(np.uint8),
        rng.integers(-4, 9, size=(R, 2)).astype(np.int32),
    ]


def test_multi_column_plain_equals_per_column_and_xla():
    """Several tensors under one id vector: each output equals the one-tensor
    plain sum bit for bit (float columns stay f32, the others sum into int32,
    a bool column counting its true rows), and the XLA CPU scatter."""
    R, S = 3000, 128
    seg = np.random.default_rng(1).integers(-2, S + 2, size=R).astype(np.int32)
    cols = _mixed_columns(R, 2)
    got = PS.segment_sums([torch.from_numpy(c) for c in cols], torch.from_numpy(seg), S)
    for g, c in zip(got, cols):
        as_int = c if c.dtype == np.float32 else c.astype(np.int32)
        one = PS.segment_sum_plain(torch.from_numpy(as_int), torch.from_numpy(seg), S)
        assert g.dtype == one.dtype == (torch.float32 if c.dtype == np.float32 else torch.int32)
        assert g.shape == one.shape
        assert torch.equal(g, one)
        want = jax.ops.segment_sum(jnp.asarray(as_int), jnp.asarray(seg), num_segments=S)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_segment_sums_int_only_and_empty():
    seg = torch.tensor([0, 2, 2, 5, -1], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    (counts,) = PS.segment_sums([mask], seg, 3)
    assert counts.dtype == torch.int32 and counts.tolist() == [1, 0, 1]
    (none,) = PS.segment_sums([torch.zeros((0, 2))], torch.zeros(0, dtype=torch.int32), 4)
    assert none.shape == (4, 2) and not none.any()


def test_snapshot_host_calls():
    """The snapshot's segment sums at one optimizer round of a 40-broker
    cluster (64 after bucketing), heavy goals on, every optional group: one
    call for the broker-keyed sums, one for the (partition, rack) counts, one
    for the (broker, topic) tables and two levels of the XLA-order band sums."""
    from cruise_control_tpu_torch.analyzer import context as PC
    from cruise_control_tpu_torch.model import arrays as PA
    from cruise_control_tpu_torch.ops import index as PI
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from tests.torch_port_helpers import CONFIG2_SMALL

    state, _ = generate(SyntheticSpec(**dict(CONFIG2_SMALL, num_partitions=200)), device="cpu")
    state = PA.pad_brokers(state, PA.broker_bucket(state.num_brokers))
    ctx = PC.pad_context_brokers(
        PC.GoalContext.build(state.num_topics, 40, device="cpu"), state.num_brokers
    )
    calls = []

    def counting(columns, ids, S):
        calls.append((len(columns), S))
        return PS.segment_sums(columns, ids, S)

    real_ctx, real_idx = PC._segment_sums, PI.segment_sums
    PC._segment_sums = PI.segment_sums = counting
    try:
        PC.take_snapshot(state, ctx, True)
    finally:
        PC._segment_sums, PI.segment_sums = real_ctx, real_idx
    B, T, P = state.num_brokers, state.num_topics, state.num_partitions
    assert calls == [(8, B), (1, P * state.num_racks), (3, 2), (3, 1), (2, B * T)]


@pytest.mark.parametrize("rows,segments,columns,fields", [(30_000, 128, 11, 8), (300_000, 1_024, 4, 1),
                                                          (300_000, 1_024, 11, 8), (480_000, 2_048, 11, 8),
                                                          (3_000_000, 16_384, 11, 8), (3_000_000, 20_000, 1, 1),
                                                          (100_000, 16_384, 4, 1), (5_000, 40_000, 2, 2),
                                                          (1_920_000, 60_032, 5, 2), (0, 3, 1, 1)])
def test_fixed_order_scratch_follows_the_route(rows, segments, columns, fields):
    """The wrapper sizes the fixed-order scratch for the route the kernel's
    plan takes: one_pass (the columns in segment order, the blocks' counts,
    the starts, a ticket) up to 28,672 segments unless 400,000+ rows come with
    more than ``ONE_PASS_SEGMENTS`` segments or 3+ fields, the digits
    otherwise (two
    buffers of (key, row) pairs, a block's digit counts a 2,048 rows, the
    starts, the columns in segment order, and from 3 fields the rows'
    columns packed); a forced route sizes its own."""
    one_pass = rows * columns + 265 * min(segments, 28_672) + 2   # refused above 28,672
    tiles = max(1, -(-rows // 2048))
    digits = 4 * rows + 256 * tiles + 258 + segments + 1 + (2 if fields >= 3 else 1) * rows * columns
    big = rows >= 400_000 and (segments > PS.ONE_PASS_SEGMENTS or fields >= 3)
    want = digits if segments > 28_672 or big else one_pass
    assert PS.scratch_ints(rows, segments, columns, fields) == want
    assert PS.scratch_ints(rows, segments, columns, fields, 1) == one_pass
    assert PS.scratch_ints(rows, segments, columns, fields, 2) == digits


@pytest.mark.parametrize("path", sorted(PS.ROUTES))
def test_forced_route_is_restored_and_checked(path):
    assert PS._FORCED[path] == 0
    first, second = PS.ROUTES[path]
    with PS.forced_route(path, second):
        assert PS._FORCED[path] == 2
        with PS.forced_route(path, first):
            assert PS._FORCED[path] == 1
        assert PS._FORCED[path] == 2
    assert PS._FORCED[path] == 0
    with pytest.raises(ValueError):
        with PS.forced_route(path, "no such route"):
            pass
    assert PS._FORCED[path] == 0


def test_plans_are_a_cards():
    for plan in (PS.segment_sums_plan, PS.segment_counts_plan):
        with pytest.raises(ValueError, match="a card's"):
            plan(30_000, 128, "cpu")
