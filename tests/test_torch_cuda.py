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
    """A fixed-order pass keeps its counters in shared memory, which holds
    28,672 segments; above that the call makes one pass per chunk of the
    segment range (two and three passes here)."""
    rng = np.random.default_rng(S)
    seg = rng.integers(-2, S + 2, size=20_000).astype(np.int32)
    seg[:3000] = S - 1          # the last segment holds many rows
    vals = (rng.exponential(size=(20_000, 2)) * 1000).astype(np.float32)
    _card_vs_cpu([vals, rng.random(20_000) < 0.5], seg, S, cuda_device, "segment_sum_f32")


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
