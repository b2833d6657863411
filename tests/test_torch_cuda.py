"""The port's CUDA kernels and solver on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernel has no
CPU mode).  This file imports nothing of JAX, so the machine with the card can
run it alone, without the repository's JAX test setup:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The fixed-order path adds each segment's rows in index order, so it must
equal the plain version's sequential CPU sum bit for bit, and two launches
must agree; the integer path is exact.  Every case is held against the CPU
plain version bitwise.  The kafka-assigner pass (``csrc/even_assign.cu``) is
integer-only and must equal its plain version exactly.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.ops import assign as PA
from cruise_control_tpu_torch.ops import segments as PS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _cpu(vals, seg, S):
    return PS.segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(seg), S).numpy()


def _card_vs_cpu(cols, seg, S, dev, path):
    """segment_sums of numpy columns on the card (one host call on ``path``)
    against the CPU plain version, bitwise."""
    PS.reset_launch_counts()
    got = PS.segment_sums([torch.from_numpy(c).to(dev) for c in cols], torch.from_numpy(seg).to(dev), S)
    torch.cuda.synchronize()
    assert PS.LAUNCHES[path] == 1 and sum(PS.LAUNCHES.values()) == 1
    want = PS.segment_sums_plain([torch.from_numpy(c) for c in cols], torch.from_numpy(seg), S)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R,C,S",
    [(30_000, 4, 128), (30_000, 1, 2048), (1000, 7, 40), (5, 40, 3), (0, 2, 4),
     (30_001, 3, 1), (257, 2, 1793), (33, 2, 40_000), (30_000, 1, 100_000)],
)
def test_float_kernel_matches_cpu_order_bitwise(cuda_device, R, C, S):
    rng = np.random.default_rng(R + C + S)
    vals = (rng.exponential(size=(R, C)) * 1000).astype(np.float32)
    seg = rng.integers(-3, S + 3, size=R).astype(np.int32)
    dv, ds = torch.from_numpy(vals).to(cuda_device), torch.from_numpy(seg).to(cuda_device)
    PS.reset_launch_counts()
    a = PS.segment_sum(dv, ds, S)
    b = PS.segment_sum(dv, ds, S)
    torch.cuda.synchronize()
    assert PS.LAUNCHES["segment_sum_f32"] == 2
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.cpu().numpy(), _cpu(vals, seg, S))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [12_800, 100_000])
@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
def test_int_kernel_exact(cuda_device, S, dtype):
    rng = np.random.default_rng(S)
    seg = rng.integers(-5, S + 5, size=30_000).astype(np.int32)
    vals = rng.integers(0, 2, size=30_000).astype(dtype)
    got = PS.segment_sum(
        torch.from_numpy(vals).to(cuda_device), torch.from_numpy(seg).to(cuda_device), S
    )
    assert got.dtype == torch.from_numpy(vals).dtype and got.shape == (S,)
    np.testing.assert_array_equal(got.cpu().numpy(), _cpu(vals, seg, S))


@pytest.mark.cuda
def test_kernel_rejects_float64(cuda_device):
    with pytest.raises(TypeError):
        PS.segment_sum(torch.ones(4, dtype=torch.float64, device=cuda_device),
                       torch.zeros(4, dtype=torch.int32, device=cuda_device), 2)


@pytest.mark.cuda
def test_config1_solve_on_the_card_equals_the_cpu_port(cuda_device):
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    spec = SyntheticSpec(
        num_racks=2, num_brokers=3, num_topics=2, num_partitions=20,
        replication_factor=2, distribution="exponential", skew_brokers=1,
        mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=3,
    )
    out = {}
    for dev in ("cpu", cuda_device):
        state, maps = generate(spec, device=dev)
        ctx = GoalContext.build(state.num_topics, state.num_brokers, device=dev)
        PS.reset_launch_counts()
        final, res = GoalOptimizer(device=dev).optimize(state, ctx, maps=maps)
        out[str(dev)] = (final.to("cpu"), res, dict(PS.LAUNCHES))
    (fc, rc, lc), (fg, rg, lg) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(fc.replica_broker, fg.replica_broker)
    assert torch.equal(fc.partition_leader, fg.partition_leader)
    assert rc.total_moves == rg.total_moves == 16
    assert lc == {"segment_sum_f32": 0, "segment_sum_i32": 0}
    assert lg["segment_sum_f32"] > 0 and lg["segment_sum_i32"] > 0


@pytest.mark.cuda
def test_all_rows_in_one_segment(cuda_device):
    """The worst case of the fixed order: one segment, 30,000 dependent adds."""
    rng = np.random.default_rng(7)
    vals = (rng.exponential(size=(30_000, 4)) * 1000).astype(np.float32)
    seg = np.full(30_000, 5, np.int32)
    _card_vs_cpu([vals], seg, 128, cuda_device, "segment_sum_f32")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["segment_sum_f32", "segment_sum_i32"])
def test_every_id_out_of_range(cuda_device, path):
    rng = np.random.default_rng(8)
    seg = np.concatenate([np.full(500, -1), np.full(500, 64)]).astype(np.int32)
    vals = rng.normal(size=(1000, 2)).astype(np.float32) if path == "segment_sum_f32" else (
        rng.integers(0, 5, size=1000).astype(np.int32))
    _card_vs_cpu([vals], seg, 64, cuda_device, path)


@pytest.mark.cuda
def test_snapshot_column_set_one_call(cuda_device):
    """The snapshot's broker-keyed call: [R, 4] loads, two bool counts and five
    float columns under one id vector, bitwise per column."""
    rng = np.random.default_rng(9)
    R, S = 30_000, 128
    seg = rng.integers(-1, S, size=R).astype(np.int32)
    cols = [
        (rng.exponential(size=(R, 4)) * 1000).astype(np.float32),
        rng.random(R) < 0.95,
        rng.random(R) < 0.33,
        *[(rng.exponential(size=R) * 100).astype(np.float32) for _ in range(3)],
        *[(rng.random(R) < 0.05).astype(np.float32) for _ in range(2)],
    ]
    _card_vs_cpu(cols, seg, S, cuda_device, "segment_sum_f32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int32])
def test_int_path_reads_bool_uint8_int32(cuda_device, dtype):
    rng = np.random.default_rng(10)
    seg = rng.integers(-3, 12_803, size=30_000).astype(np.int32)
    a = rng.integers(0, 2 if dtype is np.bool_ else 7, size=30_000).astype(dtype)
    b = rng.integers(0, 2, size=(30_000, 2)).astype(dtype)
    _card_vs_cpu([a, b], seg, 12_800, cuda_device, "segment_sum_i32")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [28_672, 28_673, 57_345])
def test_grouping_counters_either_side_of_the_shared_memory_switch(cuda_device, S):
    """Segment counts around 28,672, the most the one_pass route's shared
    memory can hold (one scatter warp a block there), and past it, where
    even a small call takes the digits route."""
    rng = np.random.default_rng(S)
    seg = rng.integers(-2, S + 2, size=20_000).astype(np.int32)
    seg[:3000] = S - 1          # the last segment holds many rows
    vals = (rng.exponential(size=(20_000, 2)) * 1000).astype(np.float32)
    assert PS.segment_sums_plan(20_000, S, cuda_device, columns=3, fields=2)["route"] == (
        "one_pass" if S <= 28_672 else "digits")
    _card_vs_cpu([vals, rng.random(20_000) < 0.5], seg, S, cuda_device, "segment_sum_f32")


def _digits_for(S):
    """Radix digits of a digits-route call into ``S`` segments: the bits of
    ``S`` itself (a dropped id's key), 8 at most a digit."""
    return -(-int(S).bit_length() // 8)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(300_000, 1_024), (750_000, 4_096), (3_000_000, 16_384), (1_000_000, 28_673)])
def test_fixed_order_path_at_thousands_of_segments(cuda_device, R, S):
    """K1 at the scale ladder's broker buckets (config #3, 2,500 brokers,
    config #4) and one segment past what one_pass could hold: the loads and
    a counted bool under one id vector, bitwise the CPU's sequential sum, two
    launches bitwise equal, and the plan (``digits_route``: one_pass at
    300,000 rows into 1,024, the radix digits from 400,000 rows above
    ``ONE_PASS_SEGMENTS``), spread over the card."""
    rng = np.random.default_rng(R + S)
    seg = rng.integers(-2, S + 2, size=R).astype(np.int32)
    seg[: R // 10] = S // 2          # one segment holds a tenth of the rows
    vals = (rng.exponential(size=(R, 4)) * 1000).astype(np.float32)
    flags = rng.random(R) < 0.5
    cols = [torch.from_numpy(vals).to(cuda_device), torch.from_numpy(flags).to(cuda_device)]
    ids = torch.from_numpy(seg).to(cuda_device)
    PS.reset_launch_counts()
    a = PS.segment_sums(cols, ids, S)
    b = PS.segment_sums(cols, ids, S)
    torch.cuda.synchronize()
    assert PS.LAUNCHES["segment_sum_f32"] == 2
    want = PS.segment_sums_plain([torch.from_numpy(vals), torch.from_numpy(flags)], torch.from_numpy(seg), S)
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        np.testing.assert_array_equal(x.cpu().numpy(), w.numpy())
    plan = PS.segment_sums_plan(R, S, cuda_device, columns=5, fields=2)
    digits = PS.digits_route(R, S, 2)
    assert digits == (S > 1_024)
    assert plan["route"] == ("digits" if digits else "one_pass"), plan
    assert plan["digits"] == (_digits_for(S) if digits else 0), plan
    assert plan["blocks"] >= 132 and (not digits or plan["warps"] == 8), plan


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(100_000, 1_024), (100_000, 16_384), (100_000, 28_672), (480_000, 4_096),
                                 (480_000, 16_384), (480_000, 1_024)])
def test_fixed_order_plan_fills_the_card_from_100000_rows(cuda_device, R, S):
    """The plan takes its blocks from the rows and the card, not from the
    segment count: on one_pass at least one a streaming multiprocessor from
    100,000 rows and fewer scatter warps a block as the segments grow; on
    digits (from 400,000 rows above 2,048 segments or with 3+ fields) a block
    a 2,048 rows and 8 warps whatever the segments, the gather reading
    packed rows from 3 fields; the scratch is what the wrapper sizes."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for fields in (1, 3):
        digits = PS.digits_route(R, S, fields)
        plan = PS.segment_sums_plan(R, S, cuda_device, columns=3, fields=fields)
        assert plan["route"] == ("digits" if digits else "one_pass"), plan
        assert plan["blocks"] == -(-R // 2048) if digits else plan["blocks"] >= min(132, sms), plan
        assert plan["warps"] == (8 if digits else min(8, 57_344 // S)), plan
        assert plan["blocks"] * plan["block_rows"] >= R
        assert plan["packed"] == (digits and fields == 3)
        assert plan["scratch_ints"] == PS.scratch_ints(R, S, 3, fields)
        for code, route in enumerate(PS.ROUTES["segment_sum_f32"], 1):
            forced = PS.segment_sums_plan(R, S, cuda_device, columns=3, fields=fields, route=route)
            assert forced["route"] == route
            assert forced["scratch_ints"] == PS.scratch_ints(R, S, 3, fields, code)


def _ladder_replicas(partitions, brokers, rng):
    """A JBOD ladder rung's replicas as ``bench_scale.workload`` skews them:
    every partition's RF 3 replicas on consecutive brokers of the first
    quarter (``skew_brokers = brokers // 4``), each replica on one of its
    broker's two logdirs.  Returns (broker ids, logdir ids)."""
    m = brokers // 4
    base = rng.integers(0, m, size=partitions)
    broker = ((base[:, None] + np.arange(3)[None, :]) % m).reshape(-1).astype(np.int32)
    disk = (broker * 2 + rng.integers(0, 2, size=broker.size)).astype(np.int32)
    return broker, disk


def _twice_vs_cpu(cols, seg, S, dev, path):
    """Two launches on ``path`` bitwise equal to each other and to the CPU's
    plain version."""
    got = [PS.segment_sums([torch.from_numpy(c).to(dev) for c in cols], torch.from_numpy(seg).to(dev), S)
           for _ in range(2)]
    torch.cuda.synchronize()
    want = PS.segment_sums_plain([torch.from_numpy(c) for c in cols], torch.from_numpy(seg), S)
    for a, b, w in zip(*got, want):
        assert torch.equal(a, b)
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["broker call", "logdirs", "one segment", "out of range", "sweep windows"])
def test_fixed_order_digits_route_at_config4_rows(cuda_device, case):
    """K1 at config #4's 3M replicas, ids skewed onto a quarter of the
    segments as the ladder skews them: the snapshot's broker call into the
    16,384-broker bucket, the logdirs (20,000), every row in one segment,
    ids out of range on both sides, and 60,032 windows of 50 rows in one
    call; bitwise the CPU's sequential sum, two launches equal."""
    rng = np.random.default_rng(len(case))
    broker, disk = _ladder_replicas(1_000_000, 10_000, rng)
    R = broker.size

    def f32(*shape):
        return (rng.exponential(size=shape) * 1000).astype(np.float32)

    def bits(p):
        return rng.random(R) < p

    if case == "broker call":
        cols, seg, S = [f32(R, 4), bits(0.95), bits(0.33), f32(R), f32(R), f32(R),
                        bits(0.05).astype(np.float32), bits(0.05).astype(np.float32)], broker, 16_384
    elif case == "logdirs":
        cols, seg, S = [f32(R)], disk, 20_000
    elif case == "one segment":
        cols, seg, S = [f32(R, 4)], np.full(R, 9_999, np.int32), 16_384
    elif case == "out of range":
        seg = broker.copy()
        seg[::7] = -1 - broker[::7]
        seg[3::7] = 16_384 + broker[3::7]
        cols, S = [f32(R, 4), bits(0.5)], 16_384
    else:
        cols, seg, S = [f32(R, 4), f32(R)], (np.arange(R, dtype=np.int64) // 50).astype(np.int32), 60_032
    assert PS.segment_sums_plan(R, S, cuda_device, columns=4, fields=len(cols))["route"] == "digits"
    _twice_vs_cpu(cols, seg, S, cuda_device, "segment_sum_f32")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 1_024, 2_048, 16_384, 28_672])
def test_both_fixed_order_routes_give_the_same_bits(cuda_device, S):
    """Where both routes can take a call, forcing either gives the same
    bits: the CPU's sequential sum."""
    rng = np.random.default_rng(S)
    seg = rng.integers(-3, S + 3, size=200_000).astype(np.int32)
    vals = (rng.exponential(size=(200_000, 4)) * 1000).astype(np.float32)
    want = PS.segment_sums_plain([torch.from_numpy(vals)], torch.from_numpy(seg), S)[0]
    for route in PS.ROUTES["segment_sum_f32"]:
        with PS.forced_route("segment_sum_f32", route):
            got = PS.segment_sums([torch.from_numpy(vals).to(cuda_device)], torch.from_numpy(seg).to(cuda_device), S)
        np.testing.assert_array_equal(got[0].cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["topic tables", "rack counts", "lane stack"])
def test_integer_path_at_config4_segments(cuda_device, case):
    """K2 at config #4's 3M replicas on the skewed ladder placement: the
    topic tables (16,384 x 2,000 = 32,768,000 segments, two bools) and the
    rack counts (1M partitions x 40 racks = 40,000,000), and a lane-form
    stack (16 lanes of config #2's topic tables in one call); exact against
    the plain version, two launches equal, and the ids read once a row
    (the plan's blocks come from the rows, not the segments)."""
    rng = np.random.default_rng(len(case))
    if case == "lane stack":
        lanes, R, S = 16, 30_000, 12_800
        x = rng.integers(0, S, size=R).astype(np.int32)
        x[::997] = -1
        seg = np.where(x >= 0, np.arange(lanes, dtype=np.int32)[:, None] * S + x, -1).reshape(-1)
        cols, S = [rng.random(seg.size) < 0.95, rng.random(seg.size) < 0.33], lanes * S
    else:
        broker, _ = _ladder_replicas(1_000_000, 10_000, rng)
        part = np.repeat(np.arange(1_000_000, dtype=np.int32), 3)
        if case == "topic tables":
            seg, S = broker * 2_000 + part % 2_000, 16_384 * 2_000
            cols = [rng.random(seg.size) < 0.95, rng.random(seg.size) < 0.33]
        else:
            seg, S = part * 40 + broker % 40, 1_000_000 * 40
            cols = [rng.random(seg.size) < 0.95]
    plan = PS.segment_counts_plan(seg.size, S, cuda_device, columns=len(cols))
    assert plan["route"] == "direct" and plan["blocks"] <= 8 * 132, plan
    _twice_vs_cpu(cols, seg, S, cuda_device, "segment_sum_i32")


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,cols", [(30_000, 128, 1), (30_000, 1_024, 1), (30_000, 12_800, 2), (7_500, 128, 1),
                                      (1_920_000, 8_192, 1)])
def test_both_integer_routes_give_the_same_counts(cuda_device, R, S, cols):
    """Where every bin fits shared memory, the direct and the shared route
    give the same exact counts; the plan takes shared only where rows
    outnumber bins 4 to 1."""
    rng = np.random.default_rng(R + S)
    seg = rng.integers(-2, S + 2, size=R).astype(np.int32)
    vals = [rng.integers(0, 3, size=R).astype(np.int32) for _ in range(cols)]
    want = PS.segment_sums_plain([torch.from_numpy(v) for v in vals], torch.from_numpy(seg), S)
    plan = PS.segment_counts_plan(R, S, cuda_device, columns=cols)
    assert plan["route"] == ("shared" if R >= 4 * S * cols else "direct"), plan
    for route in PS.ROUTES["segment_sum_i32"]:
        with PS.forced_route("segment_sum_i32", route):
            got = PS.segment_sums([torch.from_numpy(v).to(cuda_device) for v in vals],
                                  torch.from_numpy(seg).to(cuda_device), S)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("S,cols", [(100, 64), (12_800, 40), (100_000, 3)])
def test_int_path_wide_and_large(cuda_device, S, cols):
    """Blocks own segment ranges sized to fit shared memory: many columns,
    many segments."""
    rng = np.random.default_rng(S + cols)
    seg = rng.integers(-2, S + 2, size=30_000).astype(np.int32)
    vals = [rng.integers(0, 3, size=(30_000, cols)).astype(np.int32)]
    _card_vs_cpu(vals, seg, S, cuda_device, "segment_sum_i32")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 32, 33, 64, 100, 128, 300, 5000])
def test_xla_order_sums_on_the_card(cuda_device, B):
    from cruise_control_tpu_torch.ops.index import xla_sums

    rng = np.random.default_rng(B)
    x = (rng.exponential(size=(B, 4)) * 1000).astype(np.float32)
    y = (rng.exponential(size=B) * 1000).astype(np.float32)
    got = xla_sums([torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)])
    want = xla_sums([torch.from_numpy(x), torch.from_numpy(y)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _assign_inputs(B, P, max_rf, racks, seed):
    """Random inputs of the assigner's passes: pre-seeded counts, replica
    counts 1..max_rf, 5 % of partitions excluded, ``racks`` racks, one
    broker in ten not eligible (B = 3: only brokers 0 and 1 eligible, so a
    third replica has nowhere to go)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, size=(max_rf, B)).astype(np.int32)
    rf = rng.integers(1, max_rf + 1, size=P).astype(np.int32)
    excluded = rng.random(P) < 0.05
    rack = (np.arange(B) % racks).astype(np.int32)
    eligible = rng.random(B) >= 0.1 if B > 3 else np.array([True, True, False])
    return counts, rf, excluded, rack, eligible


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 100, 128, 1000, 2048])
@pytest.mark.parametrize("racks", [2, 10])
def test_even_assign_equals_its_plain_version(cuda_device, B, racks):
    """Every position pass on the card against the CPU loop: counts and picks
    identical.  Two racks against RF 3 exercise the relaxed (rack-ignoring)
    choice."""
    P, max_rf = 3000, 3
    counts, rf, excluded, rack, eligible = _assign_inputs(B, P, max_rf, racks, B + racks)
    cpu = [torch.from_numpy(x) for x in (rf, excluded, rack, eligible)]
    gpu = [x.to(cuda_device) for x in cpu]
    chosen_c = torch.full((P, max_rf), -1, dtype=torch.int32)
    chosen_g = chosen_c.to(cuda_device)
    PA.reset_launch_counts()
    for pos in range(max_rf):
        c_cpu = torch.from_numpy(counts[pos].copy())
        c_gpu = c_cpu.to(cuda_device)
        PA.even_assign(c_cpu, chosen_c, pos, *cpu)
        PA.even_assign(c_gpu, chosen_g, pos, *gpu)
        torch.cuda.synchronize()
        assert torch.equal(c_gpu.cpu(), c_cpu), pos
        assert torch.equal(chosen_g.cpu(), chosen_c), pos
    assert PA.LAUNCHES["even_assign"] == max_rf
    picks = chosen_c.numpy()
    assert (picks[excluded] == -1).all()
    if B == 3:
        assert ((picks == -1) & (np.arange(max_rf)[None, :] < rf[:, None]) & ~excluded[:, None]).any()


@pytest.mark.cuda
def test_assigner_position_counts_through_the_integer_kernel(cuda_device):
    """The assigner's per-(position, broker) counts: a bool column of 30,000
    rows into 8 x 128 segments, one host call on the integer path."""
    rng = np.random.default_rng(11)
    ok = rng.random(30_000) < 0.97
    group = np.where(ok, rng.integers(0, 3, 30_000) * 128 + rng.integers(0, 128, 30_000), -1)
    _card_vs_cpu([ok], group.astype(np.int32), 8 * 128, cuda_device, "segment_sum_i32")


@pytest.mark.cuda
def test_config2_small_kafka_mode_on_the_card_equals_the_cpu_port(cuda_device):
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    spec = SyntheticSpec(
        num_racks=5, num_brokers=40, num_topics=20, num_partitions=2000,
        replication_factor=3, distribution="exponential", skew_brokers=10,
        mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
    )
    out = {}
    for dev in ("cpu", cuda_device):
        state, maps = generate(spec, device=dev)
        ctx = GoalContext.build(state.num_topics, state.num_brokers, device=dev)
        PA.reset_launch_counts()
        PS.reset_launch_counts()
        final, res = GoalOptimizer(goal_ids=(22, 23), hard_ids=(22,), device=dev).optimize(
            state, ctx, maps=maps
        )
        out[str(dev)] = (final.to("cpu"), res, PA.LAUNCHES["even_assign"], PS.LAUNCHES["segment_sum_i32"])
    (fc, rc, ac, _), (fg, rg, ag, ig) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(fc.replica_broker, fg.replica_broker)
    assert torch.equal(fc.partition_leader, fg.partition_leader)
    assert rc.total_moves == rg.total_moves > 0
    assert rg.violations_after["KafkaAssignerEvenRackAwareGoal"] == 0
    assert ac == 0 and ag == 3 and ig > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
def test_int_kernel_at_the_sweep_shape(cuda_device, dtype):
    """The sweep's replication factors: 64 lanes x 30,000 replica rows into
    64 x 10,000 = 640,000 segments (ids lane * P + partition), one host call
    on the integer path, exact against the plain version."""
    rng = np.random.default_rng(12)
    rp = np.repeat(np.arange(10_000, dtype=np.int32), 3)
    seg = (np.arange(64, dtype=np.int32)[:, None] * 10_000 + rp[None, :]).reshape(-1)
    vals = rng.random(seg.size) < 0.99 if dtype is np.bool_ else rng.integers(0, 3, seg.size).astype(np.int32)
    _card_vs_cpu([vals], seg, 640_000, cuda_device, "segment_sum_i32")


@pytest.mark.cuda
def test_float_kernel_at_the_sweep_totals_shape(cuda_device):
    """The first level of the sweep's float totals: 64 lanes x 30,000 rows
    of load [.., 4] and offline bytes into XLA's 32-row windows, each lane's
    938 windows after the last lane's (60,032 segments), one host call on the
    fixed-order path, bitwise equal to the CPU's sequential sum."""
    from cruise_control_tpu_torch.ops.index import _window_ids

    rng = np.random.default_rng(13)
    seg = _window_ids(30_000, torch.device("cpu"), 64).numpy()
    load = (rng.exponential(size=(seg.size, 4)) * 1000).astype(np.float32)
    off = np.where(rng.random(seg.size) < 0.1, load[:, 1], 0.0).astype(np.float32)
    _card_vs_cpu([load, off], seg, 64 * 938, cuda_device, "segment_sum_f32")


def _sim_base():
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    spec = SyntheticSpec(
        num_racks=5, num_brokers=10, num_topics=5, num_partitions=400, replication_factor=3,
        seed=2, mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08, mean_nw_out=0.06,
    )
    return generate(spec, device="cpu")[0]


@pytest.mark.cuda
def test_fast_sweep_on_the_card_equals_the_cpu_port(cuda_device):
    from cruise_control_tpu_torch import sim

    base = _sim_base()
    scs = [sim.Scenario(name=f"s{i}", add_brokers=i % 4, kill_brokers=(i % 5,) if i % 3 == 0 else (),
                        load_factor=1.0 + 0.8 * i) for i in range(12)]
    PS.reset_launch_counts()
    card = sim.fast_sweep(base, scs, device=cuda_device)
    assert PS.LAUNCHES["segment_sum_i32"] > 0 and PS.LAUNCHES["segment_sum_f32"] > 0
    cpu = sim.fast_sweep(base, scs, device="cpu")
    assert [v.to_dict() for v in card.scenarios] == [v.to_dict() for v in cpu.scenarios]
    assert len({v.satisfiable for v in card.scenarios}) == 2


@pytest.mark.cuda
def test_deep_sweep_on_the_card_equals_the_cpu_port(cuda_device):
    from cruise_control_tpu_torch import sim

    base = _sim_base()
    scs = [sim.Scenario(name="kill", kill_brokers=(1,)), sim.Scenario(name="add", add_brokers=3, load_factor=1.5),
           sim.Scenario(name="order", drop_rack=2, goal_order=(3, 0, 7))]
    goals, hard = (0, 3, 7), (0, 3)
    card = sim.deep_sweep(base, scs, goal_ids=goals, hard_ids=hard, device=cuda_device)
    cpu = sim.deep_sweep(base, scs, goal_ids=goals, hard_ids=hard, device="cpu")
    assert [v.to_dict() for v in card.scenarios] == [v.to_dict() for v in cpu.scenarios]
    for a, b in zip(card.states, cpu.states):
        assert torch.equal(a.replica_broker.cpu(), b.replica_broker)
        assert torch.equal(a.partition_leader.cpu(), b.partition_leader)


# -- trace rollouts, the controller and the fleet ---------------------------------


def _config1():
    import chip_smoke as SM
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    return generate(SyntheticSpec(**SM.CONFIG1), device="cpu")


@pytest.mark.cuda
def test_rollout_on_the_card_equals_the_cpu_port(cuda_device):
    """The JAX traces harness (10 brokers, 4 traces x 4 policies, 64 steps):
    every per-step series bitwise and every verdict, one host sync."""
    import chip_smoke as SM
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch.traces import rollout

    base, _ = generate(SyntheticSpec(num_racks=5, num_brokers=10, num_topics=5, num_partitions=50,
                                     replication_factor=2, seed=2, mean_cpu=0.08, mean_disk=0.08,
                                     mean_nw_in=0.08, mean_nw_out=0.06), device="cpu")
    traces, policies = SM.trace_workload(max_brokers=16)
    PS.reset_launch_counts()
    card = rollout(base, traces, policies, bucket_brokers=16, device=cuda_device)
    assert PS.LAUNCHES["segment_sum_f32"] > 0 and PS.LAUNCHES["segment_sum_i32"] >= 64
    cpu = rollout(base, traces, policies, bucket_brokers=16, device="cpu")
    assert card.num_host_syncs == 1
    assert SM._same_rollout(card, cpu)


@pytest.mark.cuda
def test_controller_tick_on_the_card_equals_the_cpu_port(cuda_device):
    import chip_smoke as SM

    state, maps = _config1()
    loads = SM.partition_loads(state, maps)
    PS.reset_launch_counts()
    card, ctl = SM._standalone_tick(state, maps, loads, 1.3, cuda_device)
    assert PS.LAUNCHES["segment_sum_f32"] > 0 and PS.LAUNCHES["segment_sum_i32"] > 0
    cpu, _ = SM._standalone_tick(state, maps, loads, 1.3, torch.device("cpu"))
    assert card is not None and SM._set_key(card) == SM._set_key(cpu)
    assert ctl._state.device.type == "cuda" and ctl._state_host.device.type == "cpu"


@pytest.mark.cuda
def test_fleet_tick_on_the_card_equals_the_cpu_port(cuda_device):
    import chip_smoke as SM

    state, maps = _config1()
    loads = SM.partition_loads(state, maps)
    sets = {}
    for where in (cuda_device, torch.device("cpu")):
        fleet, attrs, _, _ = SM._fleet_tick(state, maps, loads, (1.1, 1.2, 1.3), where)
        assert attrs["groups"] == 1 and attrs["published"] == 3
        sets[where.type] = [SM._set_key(fleet.tenant(f"t{i}").controller.standing) for i in range(3)]
    assert sets["cuda"] == sets["cpu"]


#: a 20-broker skewed cluster for the facade's path (every default goal has work)
FACADE_SPEC = dict(
    num_racks=4, num_brokers=20, num_topics=6, num_partitions=120,
    replication_factor=3, distribution="exponential", skew_brokers=6,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=11,
)


@pytest.mark.cuda
def test_facade_rebalance_on_the_card_equals_the_cpu_port(cuda_device):
    """Monitor, solve and execution through ``CruiseControl`` on the card and
    on the CPU port: the same proposals, admin calls and final placement."""
    import chip_smoke as SM

    out = {}
    for where in (cuda_device, torch.device("cpu")):
        PS.reset_launch_counts()
        cc, _ = SM.build_facade(FACADE_SPEC, where)
        done = cc.rebalance(dryrun=False)
        if where.type == "cuda":
            assert PS.LAUNCHES["segment_sum_f32"] > 0 and PS.LAUNCHES["segment_sum_i32"] > 0
        assert done.execution.succeeded and done.optimizer_result.residual_hard_violations == 0
        out[where.type] = (done.optimizer_result.proposals, cc.backend.admin_log,
                           SM.backend_placement(cc.backend))
    assert out["cuda"] == out["cpu"]
    placement = out["cuda"][2]
    assert all(placement[p.tp] == (p.new_replicas, p.new_replicas[0]) for p in out["cuda"][0])


@pytest.mark.cuda
def test_facade_defaults_to_the_card_and_records_it(cuda_device):
    import chip_smoke as SM
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.obs import RECORDER

    cc, _ = SM.build_facade(FACADE_SPEC, cuda_device)
    assert CruiseControl(cc.backend, cc.monitor, cc.executor).device.type == "cuda"
    RECORDER.clear()
    res = cc.rebalance(dryrun=True).optimizer_result
    trace = RECORDER.recent(1, kind="optimize")[0]
    assert trace.platform == "cuda" and trace.attrs["device_count"] >= 1
    assert trace.total_dispatches == trace.attrs["num_dispatches"] == res.num_host_syncs
    assert trace.attrs["cost"]["memory_peak_bytes"] > 0


def _race_calls(n: int = 200):
    """``n`` segment-sum calls of different shapes and ids (the fixed-order
    path, which keeps one scratch buffer a stream, and the integer path):
    (float columns, int columns, ids, segments)."""
    rng = np.random.default_rng(2024)
    calls = []
    for i in range(n):
        R = int(rng.integers(1, 40_000))
        S = int(rng.choice([1, 40, 128, 2048, 12_800]))
        floats = [(rng.exponential(size=(R, int(rng.integers(1, 4)))) * 1000).astype(np.float32)]
        ints = [rng.integers(0, 3, size=R).astype(np.int32)]
        if i % 3 == 2:
            floats = []          # an integer-path call now and then
        seg = rng.integers(-2, S + 2, size=R).astype(np.int32)
        calls.append((floats + ints, seg, S))
    return calls


@pytest.mark.cuda
def test_segment_sums_are_safe_under_concurrent_host_threads(cuda_device):
    """4 host threads x 50 calls on the default stream at once: every output
    bitwise equal to the same call made alone (the fixed-order path's
    scratch is held under a lock from lookup to enqueue)."""
    import sys
    import threading

    calls = _race_calls(200)
    dev_calls = [([torch.from_numpy(c).to(cuda_device) for c in cols], torch.from_numpy(seg).to(cuda_device), S)
                 for cols, seg, S in calls]
    alone = []
    for cols, seg, S in dev_calls:
        out = PS.segment_sums(cols, seg, S)
        torch.cuda.synchronize()
        alone.append([o.cpu().numpy() for o in out])
    got = [None] * len(calls)
    errors = []
    barrier = threading.Barrier(4)

    def worker(k):
        try:
            barrier.wait(timeout=60)
            for i in range(k, len(calls), 4):
                got[i] = PS.segment_sums(*dev_calls[i])
        except Exception as e:     # reported below, with the thread's index
            errors.append((k, repr(e)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    bad = [i for i, (g, w) in enumerate(zip(got, alone))
           if any(not np.array_equal(a.cpu().numpy(), b) for a, b in zip(g, w))]
    assert not bad, f"{len(bad)} of {len(calls)} calls differ from the same call made alone, e.g. {bad[:5]}"


@pytest.mark.cuda
def test_broker_failure_self_heal_on_the_card_equals_the_cpu_port(cuda_device, tmp_path):
    """At config2_small: a dead broker detected, held back by the notifier's
    grace period, then drained through ``remove_brokers`` on the card and on
    the CPU port (the smoke's ``SelfHealDrive.broker_failure``, which checks
    the drain and 0 hard violations after it) -- the same anomaly, actions,
    proposals, admin calls and final placement."""
    import chip_smoke as SM

    out = {}
    for where in (cuda_device, torch.device("cpu")):
        drive = SM.SelfHealDrive(SM.CONFIG2_SMALL, where, str(tmp_path))
        drive.broker_failure()
        if where.type == "cuda":
            assert drive.host_calls["segment_sum_f32"] > 0 and drive.host_calls["segment_sum_i32"] > 0
        outcome, _ = drive.outcome()
        out[where.type] = {k: outcome[k] for k in ("anomalies", "actions", "fixes", "admin_log", "placement")}
    assert out["cuda"] == out["cpu"]
    assert out["cuda"]["actions"] == ["CHECK", "FIXED"]
    assert all(SM.DEAD_BROKER not in replicas for replicas, _ in out["cuda"]["placement"].values())


@pytest.mark.cuda
def test_ingest_route_rebalance_on_the_card_equals_the_cpu_port(cuda_device):
    """At config2_small: the smoke's ingest route (a reporter per broker, the
    wire format, the fetcher pool) fills the windows and a dry-run rebalance
    runs on the card and on the CPU port -- the same bytes on the wire, the
    same loads and proposals, both segment-sum paths launched on the card,
    and the optimize record's ``cost`` equal to the census of its calls."""
    import chip_smoke as SM
    from cruise_control_tpu_torch.obs import RECORDER

    cfg, _ = SM.ingest_config()
    out = {}
    for where in (cuda_device, torch.device("cpu")):
        run = SM.build_ingest_facade(SM.CONFIG2_SMALL, where, cfg)
        census = SM._census()
        PS.reset_launch_counts()
        res = run.cc.rebalance(dryrun=True).optimizer_result
        torch.cuda.synchronize()
        launches = dict(PS.LAUNCHES)
        grown = SM._census_grown(census, SM._census())
        cost = RECORDER.recent(1, kind="optimize")[0].attrs["cost"]
        assert cost["profiled_calls"] == sum(n for n, _, _ in grown.values()) > 0
        assert cost["flops"] == sum(f for _, f, _ in grown.values())
        if where.type == "cuda":
            assert launches["segment_sum_f32"] > 0 and launches["segment_sum_i32"] > 0
            assert {k: v[0] for k, v in grown.items()} == {k: v for k, v in launches.items() if v}
        out[where.type] = (run.fleet.transport.batches, run.cc.monitor.current_partition_loads(),
                           [(p.tp, p.old_replicas, p.new_replicas) for p in res.proposals],
                           res.residual_hard_violations)
        run.cc.shutdown()
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][2] and out["cuda"][3] == 0


@pytest.mark.cuda
def test_app_on_the_card_answers_proposals_as_the_cpu_app(cuda_device):
    """The served app (``CruiseControlTpuApp`` on ``cuda``, its default)
    answers PROPOSALS over HTTP with the CPU app's body, wall-clock fields
    aside, and the solve launched both segment-sum paths."""
    import chip_smoke as SM

    bodies = {}
    for where in (cuda_device, torch.device("cpu")):
        app = SM.build_api_app(SM.CONFIG2_SMALL, where)
        try:
            assert app.device.type == where.type and app.cruise_control.device.type == where.type
            PS.reset_launch_counts()
            bodies[where.type] = SM._strip_wall_clock(SM.api_client(app.port).proposals())
            if where.type == "cuda":
                assert PS.LAUNCHES["segment_sum_f32"] > 0 and PS.LAUNCHES["segment_sum_i32"] > 0
        finally:
            app.stop()
    assert bodies["cuda"]["numProposals"] > 0 and not bodies["cuda"]["violatedHardGoals"]
    assert bodies["cuda"] == bodies["cpu"]


@pytest.mark.cuda
def test_concurrent_kafka_assigner_proposals_equal_the_serial_result(cuda_device):
    """Two kafka-assigner PROPOSALS at once, each solved on its own server
    request thread on the card, give the serial answer, and every
    ``even_assign`` launch is counted (the count's lock)."""
    import sys
    import threading

    import chip_smoke as SM

    app = SM.build_api_app(SM.CONFIG2_SMALL, cuda_device)
    try:
        PA.reset_launch_counts()
        serial = SM.api_client(app.port).proposals(goals=SM.API_ASSIGNER_GOALS)
        per_solve = PA.LAUNCHES["even_assign"]
        assert per_solve > 0
        got, errors = [None, None], []
        barrier = threading.Barrier(2)

        def worker(k):
            try:
                barrier.wait(timeout=60)
                got[k] = SM.api_client(app.port).proposals(goals=SM.API_ASSIGNER_GOALS)
            except Exception as e:     # reported below, with the thread's index
                errors.append((k, repr(e)))

        PA.reset_launch_counts()
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        finally:
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert PA.LAUNCHES["even_assign"] == 2 * per_solve
    finally:
        app.stop()
    for body in got:
        assert SM._strip_wall_clock(body) == SM._strip_wall_clock(serial)


@pytest.mark.cuda
def test_the_entry_point_with_the_card_hidden_exits_naming_the_device(cuda_device):
    """With ``CUDA_VISIBLE_DEVICES=""`` the process entry point exits non-zero
    and names the device; it does not serve on the CPU."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "cruise_control_tpu_torch", "--config",
         os.path.join(root, "config", "cruisecontrol.properties")],
        cwd=root, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "the CUDA device cuda:0 is not available" in proc.stderr
    assert "serving on" not in proc.stdout


# -- the sharded solver on the card -------------------------------------------------


@pytest.mark.cuda
def test_sharded_mesh8_on_the_card_equals_the_cpu_port(cuda_device):
    """The smoke's mesh8 step (the gate's 16-goal workload) on 4 ranks
    sharing the card over gloo and on 4 gloo ranks on the CPU port: every
    rank's placements, leaders, proposals, violations and balancedness
    identical on both sides and equal to the single-device card solve (the
    step raises otherwise)."""
    import chip_smoke as SM
    from cruise_control_tpu_torch.ops import _build

    _build.build_all(["segment_sum"])
    card, cpu = SM.mesh8_card_vs_cpu(cuda_device, ranks=4)
    assert all(r["backend"] == "gloo" and r["use_spmd"] for r in card)
    for c, h in zip(card, cpu):
        assert c["solution"] == h["solution"]
        assert c["launches"]["segment_sum_f32"] > 0 and c["launches"]["segment_sum_i32"] > 0


@pytest.mark.cuda
def test_run_ranks_raises_when_a_card_rank_fails(cuda_device):
    """A rank that raises while its peer waits in a collective on the card:
    ``run_ranks`` stops the peer and raises within its limit, not hangs."""
    import time

    import chip_smoke as SM
    from cruise_control_tpu_torch.parallel import run_ranks

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(SM.failing_rank, 2, device="cuda", timeout_s=120)
    assert time.monotonic() - t0 < 90


@pytest.mark.cuda
def test_gate_config1_tier_on_the_card_equals_the_cpu_port(cuda_device):
    """The gate's config1 tier on the card: the CPU port's moves and
    balancedness, no hard violation, its record's spans summing to its host
    syncs -- at most #goals + 4 on the card's device loop, fewer than the CPU
    port's one a round -- and no kernel build or capture in the warm run."""
    from cruise_control_tpu_torch.obs import gate

    card = gate.run_tier("config1", device="cuda")
    cpu = gate.run_tier("config1", device="cpu")
    assert card["platform"] == "cuda" and cpu["platform"] == "cpu"
    for key in ("total_moves", "balancedness", "residual_hard_violations", "residual_soft_violations", "num_goals"):
        assert card[key] == cpu[key], key
    assert card["span_dispatch_sum"] == card["num_dispatches"] <= card["num_goals"] + 4 < cpu["num_dispatches"]
    assert card["residual_hard_violations"] == 0.0 and card["warm_compile_events"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bload", "broker call", "topic tables", "rack counts"])
def test_kernels_at_config3_shapes_equal_the_cpu_sequential_sum(cuda_device, case):
    """K1 and K2 at config #3's snapshot shapes (300,000 replicas; broker
    bucket 1,024; topic tables 1,024 x 1,000; rack counts 100,000 x 20),
    bitwise against the CPU's sequential sum."""
    R, B, BT, PR = 300_000, 1024, 1_024_000, 2_000_000
    rng = np.random.default_rng(len(case))

    def ids(S):
        x = rng.integers(0, S, size=R).astype(np.int32)
        x[::997] = -1
        return x

    def f32(*shape):
        return (rng.exponential(size=shape) * 1000).astype(np.float32)

    def bits(p):
        return rng.random(R) < p

    if case == "bload":
        _card_vs_cpu([f32(R, 4)], ids(B), B, cuda_device, "segment_sum_f32")
    elif case == "broker call":
        cols = [f32(R, 4), bits(0.95), bits(0.33), f32(R), f32(R), f32(R),
                bits(0.05).astype(np.float32), bits(0.05).astype(np.float32)]
        _card_vs_cpu(cols, ids(B), B, cuda_device, "segment_sum_f32")
    elif case == "topic tables":
        _card_vs_cpu([bits(0.95), bits(0.33)], ids(BT), BT, cuda_device, "segment_sum_i32")
    else:
        _card_vs_cpu([bits(0.95)], ids(PR), PR, cuda_device, "segment_sum_i32")


# -- the device loop (analyzer/device_loop.py): a goal as one graph launch ----------


def _solve_both(spec, **opt_kw):
    """The default goals on the CPU port and on the card's device loop."""
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    out = []
    for dev in ("cpu", "cuda"):
        state, maps = generate(SyntheticSpec(**spec), device=dev)
        ctx = GoalContext.build(state.num_topics, state.num_brokers, device=dev)
        out.append(GoalOptimizer(device=dev, **opt_kw).optimize(state, ctx, maps=maps))
    return out


def _same_solve(a, b):
    (fa, ra), (fb, rb) = a, b
    for f in ("replica_broker", "partition_leader", "replica_disk"):
        assert torch.equal(getattr(fa, f).cpu(), getattr(fb, f).cpu()), f
    rows = [[(r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied)
             for r in res.goal_reports] for res in (ra, rb)]
    assert rows[0] == rows[1]
    assert ra.violations_after == rb.violations_after and ra.proposals == rb.proposals


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CONFIG1", "CONFIG2_SMALL"])
def test_device_loop_solve_equals_the_cpu_port_bitwise(cuda_device, name):
    import chip_smoke as SM
    from cruise_control_tpu_torch.ops import graph_loop as GL

    GL.reset_launch_counts()
    cpu, card = _solve_both(getattr(SM, name))
    _same_solve(cpu, card)
    goals = len(card[1].goal_reports)
    assert GL.LAUNCHES["graph_loop"] == goals + 1          # the goals and the offline pre-phases
    assert card[1].num_host_syncs <= goals + 4 < cpu[1].num_host_syncs
    # the control kernels' own count on the device equals what the fetched trip counts imply
    assert GL.LAUNCHES["loop_ctl"] == GL.LAUNCHES["loop_ctl_by_layout"] > 0


@pytest.mark.cuda
def test_the_registry_keeps_at_most_max_shapes_and_frees_the_rest(cuda_device, monkeypatch):
    """Five clusters of distinct shapes through a registry of two shapes:
    it holds two and has evicted three, the card's allocated memory after
    the fifth stays within half a shape of what it was after the second,
    and the first shape, captured again, solves as it did."""
    import gc

    import chip_smoke as SM
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import device_loop as DL
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    dev = torch.device("cuda", torch.cuda.current_device())
    loops = DL.DeviceLoops(dev, max_shapes=2)
    monkeypatch.setitem(DL._REGISTRY, dev, loops)

    def solve(i):
        state, maps = generate(SyntheticSpec(**dict(SM.CONFIG2_SMALL, num_partitions=2000 + 40 * i)), device="cuda")
        ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cuda")
        final, res = GoalOptimizer(device="cuda").optimize(state, ctx, maps=maps)
        return final.to("cpu"), res

    gc.collect()
    torch.cuda.synchronize()
    held = [torch.cuda.memory_allocated()]
    results = []
    for i in range(5):
        results.append(solve(i))
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert loops.shapes() == 2 and loops.evictions == 3
    shape_bytes = (held[2] - held[0]) / 2
    assert shape_bytes > 0 and max(held[3:]) - held[2] < shape_bytes / 2, held
    _same_solve(results[0], solve(0))
    assert loops.evictions == 4


@pytest.mark.cuda
def test_warm_config2_tick_within_the_dispatch_budget(cuda_device):
    """ROADMAP C5's pin: a warm controller tick at config #2 width makes at
    most ``slo.dispatch.budget`` (10) host syncs, ``warm-tick-dispatches``
    stays quiet and the tick captures nothing."""
    import chip_smoke as SM

    state, ctx, opt, maps = SM._solve(SM.CONFIG2, cuda_device)
    final, _ = opt.optimize(state, ctx)
    loads = SM.partition_loads(final, maps)
    facade = SM.SmokeFacade(final, maps, loads)
    c = SM._controller(facade, cuda_device)
    c.warm_start()
    facade.loads = SM.shifted(loads, maps, SM.SHIFT_FACTORS[2])
    facade.deliver(1)
    assert c.maybe_tick() is not None
    syncs, slo, events = SM.check_tick_budget(c, "config #2 tick")
    assert syncs <= 10 and slo["ok"] and events == 0


@pytest.mark.cuda
@pytest.mark.parametrize("harness,budget", [("controller", 7), ("fleet", 8)])
def test_controller_and_fleet_harnesses_within_budget(cuda_device, harness, budget):
    import importlib

    m = importlib.import_module(f"cruise_control_tpu_torch.{harness}.bench").run_bench(device="cuda")
    assert m["dispatch_budget"] == budget
    assert m["warm_tick_dispatches"] <= budget and m["warm_compile_events"] == 0


@pytest.mark.cuda
def test_two_threads_solving_at_once_give_the_serial_results(cuda_device):
    """Host threads on the device loop at once (one registry, one set of
    slots a shape), two a cluster, with a short switch interval: each equals
    its serial solve."""
    import sys
    import threading

    import chip_smoke as SM
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    specs = [SM.CONFIG2_SMALL, dict(SM.CONFIG2_SMALL, seed=8)]

    def solve(spec):
        state, maps = generate(SyntheticSpec(**spec), device="cuda")
        ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cuda")
        return GoalOptimizer(device="cuda").optimize(state, ctx, maps=maps)

    serial = [solve(s) for s in specs]
    got = [None] * 4

    def run(i):
        got[i] = solve(specs[i % 2])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, b in enumerate(got):
        assert b is not None
        _same_solve(serial[i % 2], b)


@pytest.mark.cuda
def test_a_deadline_still_degrades(cuda_device):
    """A deadline is read once the last launched goal has ended (one counted
    wait): an expired one stops the walk as on the CPU port."""
    import chip_smoke as SM

    cpu, card = _solve_both(SM.CONFIG1, deadline_s=0.0)
    for _, res in (cpu, card):
        assert res.degraded and res.goal_reports == []
    _same_solve(cpu, card)


# -- the lane axis: one evaluation a stack, the rollout as one device program -------------


@pytest.mark.cuda
def test_warm_rollout_is_one_graph_launch_equal_to_the_cpu_port(cuda_device):
    """The JAX traces harness's rollout (10 brokers, 4 traces x 4 policies,
    64 steps): the warm run is one launch of the counted loop, one host sync
    and no segment-sum host call (the step's calls replay in the graph: the
    captured step's calls times the 64 steps), its control kernels count
    themselves once a step and once to start, and every verdict and series
    equals the CPU port's bitwise."""
    import chip_smoke as SM
    from cruise_control_tpu_torch.ops import graph_loop as GL
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch.traces import rollout

    base, _ = generate(SyntheticSpec(num_racks=5, num_brokers=10, num_topics=5, num_partitions=50,
                                     replication_factor=2, seed=2, mean_cpu=0.08, mean_disk=0.08,
                                     mean_nw_in=0.08, mean_nw_out=0.06), device="cpu")
    traces, policies = SM.trace_workload(max_brokers=16)
    rollout(base, traces, policies, bucket_brokers=16, device=cuda_device)        # captures the step
    PS.reset_launch_counts()
    GL.reset_launch_counts()
    card = rollout(base, traces, policies, bucket_brokers=16, device=cuda_device)
    cpu = rollout(base, traces, policies, bucket_brokers=16, device="cpu")
    T = card.num_steps
    assert card.num_host_syncs == 1 and GL.LAUNCHES["count_loop"] == 1
    assert GL.LAUNCHES["count_ctl"] == GL.LAUNCHES["count_ctl_by_layout"] == T + 1
    assert PS.LAUNCHES == PS.REPLAYED and all(n >= T and n % T == 0 for n in PS.REPLAYED.values())
    assert SM._same_rollout(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [64, 16])
@pytest.mark.parametrize("case", ["bload", "topic tables", "rack counts"])
def test_lane_stacked_calls_equal_the_cpu_sequential_sum(cuda_device, lanes, case):
    """K1 and K2 at the lane-form snapshot's shapes on the sim cluster
    (30,000 replicas a lane, bucket 128, 20 topics, 10,000 partitions x 10
    racks): S1's 64 lanes and the rollout's 16 in one call each, ids offset
    lane by lane, bitwise against the CPU's sequential sum and against one
    call a lane."""
    R, n = 30_000, {"bload": 128, "topic tables": 128 * 20, "rack counts": 10_000 * 10}[case]
    rng = np.random.default_rng(lanes + n)
    lane = rng.integers(0, n, size=R).astype(np.int32)
    lane[::997] = -1
    ids = np.where(lane >= 0, np.arange(lanes, dtype=np.int32)[:, None] * n + lane, -1).reshape(-1)
    if case == "bload":
        cols, path = [(rng.exponential(size=(lanes * R, 4)) * 1000).astype(np.float32)], "segment_sum_f32"
    else:
        bits = [rng.random(lanes * R) < 0.95, rng.random(lanes * R) < 0.33]
        cols, path = bits[:2 if case == "topic tables" else 1], "segment_sum_i32"
    _card_vs_cpu(cols, ids, lanes * n, cuda_device, path)
    d_cols = [torch.from_numpy(c).to(cuda_device) for c in cols]
    stacked = PS.segment_sums(d_cols, torch.from_numpy(ids).to(cuda_device), lanes * n)
    d_lane = torch.from_numpy(lane).to(cuda_device)
    for i in (0, lanes - 1):
        one = PS.segment_sums([torch.from_numpy(c[i * R:(i + 1) * R]).to(cuda_device) for c in cols], d_lane, n)
        for a, b in zip(stacked, one):
            assert torch.equal(a[i * n:(i + 1) * n], b)


# -- the lane form of the solve (a stack as one solve) ---------------------------------------


def _solver_lanes(device):
    """Three 10-broker lanes that end at different rounds: skewed, spread,
    and skewed with broker 1 dead (offline replicas for the pre-phases)."""
    from cruise_control_tpu_torch import synthetic as PSY
    from cruise_control_tpu_torch.analyzer import GoalContext
    from cruise_control_tpu_torch.model import arrays as PA

    lanes = []
    for seed in (1, 2, 3):
        state, _ = PSY.generate(PSY.SyntheticSpec(
            num_racks=5, num_brokers=10, num_topics=5, num_partitions=60, replication_factor=3, seed=seed,
            mean_cpu=0.3, mean_disk=0.3, mean_nw_in=0.3, mean_nw_out=0.2, skew_brokers=0 if seed == 2 else 4,
        ), device="cpu")
        if seed == 3:
            state = PA.set_broker_state(state, 1, alive=False)
        lanes.append(state)
    return lanes, GoalContext.build(5, 10, device=device)


def _goal_rows(res):
    return [(r.name, r.rounds, r.moves_applied, r.violations_before, r.violations_after) for r in res.goal_reports]


@pytest.mark.cuda
@pytest.mark.parametrize("goals,max_rounds", [
    (tuple(range(16)), 2000), (tuple(range(16)), 3), ((22, 23, 0, 7), 2000),
], ids=["defaults", "cap3", "assigner"])
def test_batched_solve_is_one_graph_launch_a_goal_and_equals_each_lane(cuda_device, goals, max_rounds):
    """A stack's batched solve on the card: one goal graph launch a goal for
    the whole stack (and one for the offline pre-phases; the kafka-assigner
    goal is a placement, no graph), every lane equal to its own solve on the
    card, and the stack equal to the CPU port's batched solve."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.model import arrays as PA
    from cruise_control_tpu_torch.ops import graph_loop as GL

    lanes, ctx = _solver_lanes(cuda_device)
    stack = PA.stack_arrays(lanes)
    card = GoalOptimizer(goal_ids=goals, bucket_brokers=False, max_rounds_per_phase=max_rounds, device="cuda")
    cpu = GoalOptimizer(goal_ids=goals, bucket_brokers=False, max_rounds_per_phase=max_rounds, device="cpu")
    card.batched_optimize(stack, ctx)
    GL.reset_launch_counts()
    final, res = card.batched_optimize(stack, ctx)
    graphs = sum(1 for g in goals if g != 22) + 1
    assert GL.LAUNCHES["graph_loop"] == graphs
    assert GL.LAUNCHES["loop_ctl"] == GL.LAUNCHES["loop_ctl_by_layout"] > 0
    cfinal, cres = cpu.batched_optimize(stack, ctx.to("cpu"))
    for f in ("replica_broker", "partition_leader", "replica_disk"):
        assert torch.equal(getattr(final, f).cpu(), getattr(cfinal, f))
    for i, lane in enumerate(lanes):
        single, sres = card._optimize_core(lane.to("cuda"), ctx)
        assert torch.equal(single.replica_broker.cpu(), final.replica_broker[i].cpu())
        assert torch.equal(single.partition_leader.cpu(), final.partition_leader[i].cpu())
        assert _goal_rows(sres) == _goal_rows(res.results[i]) == _goal_rows(cres.results[i])
    assert len({r.total_moves for r in res.results}) > 1


@pytest.mark.cuda
def test_batched_incremental_on_the_card_equals_the_cpu_port(cuda_device):
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.model import arrays as PA
    from cruise_control_tpu_torch.ops import graph_loop as GL

    lanes, ctx = _solver_lanes(cuda_device)
    stack = PA.stack_arrays(lanes)
    card = GoalOptimizer(bucket_brokers=False, device="cuda")
    GL.reset_launch_counts()
    final, res = card.batched_incremental_optimize(stack, ctx, max_rounds=8)
    assert GL.LAUNCHES["graph_loop"] == len(res.goals_run)
    cfinal, cres = GoalOptimizer(bucket_brokers=False, device="cpu").batched_incremental_optimize(
        stack, ctx.to("cpu"), max_rounds=8)
    assert torch.equal(final.replica_broker.cpu(), cfinal.replica_broker)
    assert [(r.total_moves, r.total_rounds, r.goals_run) for r in res.results] == [
        (r.total_moves, r.total_rounds, r.goals_run) for r in cres.results]


@pytest.mark.cuda
def test_even_assign_lane_grid_is_one_launch_equal_to_its_plain_version(cuda_device):
    gen = torch.Generator().manual_seed(3)
    S, P, B, RF = 5, 900, 96, 3
    counts = torch.randint(0, 3, (S, B), generator=gen, dtype=torch.int32)
    rf = torch.randint(1, RF + 1, (S, P), generator=gen, dtype=torch.int32)
    excl = torch.rand((S, P), generator=gen) < 0.05
    rack = torch.randint(0, 7, (S, B), generator=gen, dtype=torch.int32)
    el = torch.rand((S, B), generator=gen) < 0.9
    cc, ch = counts.clone(), torch.full((S, P, RF), -1, dtype=torch.int32)
    gc, gch = counts.cuda(), ch.clone().cuda()
    PA.reset_launch_counts()
    for pos in range(RF):
        PA.even_assign(cc, ch, pos, rf, excl, rack, el)
        PA.even_assign(gc, gch, pos, rf.cuda(), excl.cuda(), rack.cuda(), el.cuda())
    torch.cuda.synchronize()
    assert PA.LAUNCHES["even_assign"] == RF
    assert torch.equal(gc.cpu(), cc) and torch.equal(gch.cpu(), ch)


# -- the solve's spans and its graphs' device time --------------------------------------


def _warm_solve(kind):
    """A solve of config2_small on the card (one state, or a stack of two),
    run once to capture its graphs; returns a callable that solves again and
    returns the call's result."""
    import chip_smoke as SM
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.model import arrays as A
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, maps = generate(SyntheticSpec(**SM.CONFIG2_SMALL), device="cuda")
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cuda")
    opt = GoalOptimizer(device="cuda")
    if kind == "optimize":
        def solve():
            return opt.optimize(state, ctx, maps=maps)[1]
    else:
        stack = A.stack_arrays([state, state])

        def solve():
            return opt.batched_optimize(stack, ctx)[1]
    solve()
    return solve


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["optimize", "batched_optimize"])
def test_goal_spans_carry_their_graph_launches_device_time(cuda_device, kind, monkeypatch):
    """A warm solve's record: each goal span has the children ``snapshot``,
    ``launch``, ``snapshot`` and its launch's device time from the program's
    CUDA events; the launches' device times (the goals' and the offline
    pre-phases') add up to ``graph_device_s``, within 5 % of CUDA events put
    around ``GoalGraph.launch`` from outside; the call still makes 3 host
    syncs (the bulk fetch and two host copies), and the host's wait lies
    within the call.  ``optimize`` says ``stamps_supported``, and each goal
    report's duration is its launch's device time."""
    from cruise_control_tpu_torch.obs import RECORDER
    from cruise_control_tpu_torch.ops import graph_loop as GL

    solve = _warm_solve(kind)
    windows = []
    launch = GL.GoalGraph.launch

    def timed(graph, stream):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch(graph, stream)
        end.record(stream)
        windows.append((start, end))

    monkeypatch.setattr(GL.GoalGraph, "launch", timed)
    RECORDER.clear()
    result = solve()
    torch.cuda.synchronize()
    (trace,) = RECORDER.recent(5, kind="optimize")
    outside = sum(a.elapsed_time(b) for a, b in windows) / 1e3
    goals = [s for s in trace.spans if s.kind == "goal"]
    assert goals and all([c.name for c in s.children] == ["snapshot", "launch", "snapshot"] for s in goals)
    assert all(s.attrs["device_s"] > 0 for s in goals)
    repair = trace.spans[0].children[1]
    assert repair.name == "offline_repair" and repair.attrs["device_s"] > 0
    total = trace.attrs["graph_device_s"]
    assert sum(s.attrs["device_s"] for s in goals) + repair.attrs["device_s"] == pytest.approx(total, rel=1e-9)
    assert len(windows) == len(goals) + 1 and abs(total - outside) <= 0.05 * outside
    assert result.num_host_syncs == trace.total_dispatches == 3
    assert 0.0 < trace.attrs["host_wait_s"] <= trace.duration_s
    reports = result.goal_reports if kind == "optimize" else result.results[0].goal_reports
    assert [r.duration_s for r in reports] == [s.attrs["device_s"] for s in goals]
    if kind == "optimize":
        assert trace.attrs["stamps_supported"] is True
    else:
        assert "stamps_supported" not in trace.attrs


#: a warm solve under ``torch.profiler`` in a process of its own (a profiler
#: session before a graph's capture made a profiled replay fault); prints the
#: span ranges the profiler saw on the device and on the host
PROFILED_SOLVE = """
import json, torch, chip_smoke as SM
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
state, maps = generate(SyntheticSpec(**SM.CONFIG2_SMALL), device="cuda")
ctx = GoalContext.build(state.num_topics, state.num_brokers, device="cuda")
opt = GoalOptimizer(device="cuda")
opt.optimize(state, ctx, maps=maps)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
ev = [(e.name(), e.device_type() == DeviceType.CUDA) for e in prof.profiler.kineto_results.events()]
print(json.dumps({side: sorted({n for n, d in ev if d == dev and n.startswith("cc/")})
                  for side, dev in (("device", True), ("host", False))}))
"""


@pytest.mark.cuda
def test_a_profiled_solve_names_host_time_and_puts_no_span_on_the_device(cuda_device):
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", PROFILED_SOLVE], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["device"] == []
    assert {"cc/optimize/setup", "cc/goal/snapshot", "cc/goal/launch", "cc/finalize/fetch",
            "cc/finalize/to_host", "cc/finalize/report"} <= set(seen["host"])
