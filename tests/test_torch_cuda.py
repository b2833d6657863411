"""The port's CUDA kernel and solver on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernel has no
CPU mode).  This file imports nothing of JAX, so the machine with the card can
run it alone, without the repository's JAX test setup:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The float kernel adds each segment's rows in index order, so it must equal the
plain version's sequential CPU sum bit for bit, and two launches must agree.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.ops import segments as PS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _cpu(vals, seg, S):
    return PS.segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(seg), S).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R,C,S", [(30_000, 4, 128), (30_000, 1, 2048), (1000, 7, 40), (5, 40, 3), (0, 2, 4)]
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
