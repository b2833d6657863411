"""The snapshot's cross-broker float sums add in the JAX reference's order.

``take_snapshot`` turns per-broker sums into cluster totals (load, capacity,
leader bytes-in) and from them the balance bands that decide which brokers
are over or under.  XLA's CPU reduce adds up to 32 rows left to right and
splits longer axes into 32-row windows; PyTorch's ``sum`` uses its own order.
A last-bit difference in a band can flip a comparison, so the port sums in
XLA's order (``ops.index.xla_sums``) and the bands must be bitwise equal to
the JAX package's on the fixtures, on config2_small (40 brokers, bucketed to
64) and on a JBOD cluster (the disk bands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.analyzer import context as JC
from cruise_control_tpu.model import arrays as JA
from cruise_control_tpu.model import stats as JST
from cruise_control_tpu_torch.analyzer import context as PC
from cruise_control_tpu_torch.model import stats as PST
from cruise_control_tpu_torch.ops import index as PI
from tests import fixtures
from tests.torch_port_helpers import CONFIG2_SMALL, assert_fields_same, port_ctx, port_state, to_np

BANDS = ("avg_util_pct", "res_lower", "res_upper", "low_util", "leader_nw_in_upper",
         "disk_lower", "disk_upper", "replica_band", "leader_band")
JBOD = dict(CONFIG2_SMALL, num_partitions=600, disks_per_broker=3, seed=5)


def _bucketed(jstate):
    jctx = JC.GoalContext.build(jstate.num_topics, jstate.num_brokers)
    bucket = JA.broker_bucket(jstate.num_brokers)
    jstate = jax.tree_util.tree_map(jnp.asarray, JA.pad_brokers(jstate, bucket))
    return jstate, JC.pad_context_brokers(jctx, bucket)


def _case(name):
    if name in ("unbalanced", "rack_aware_satisfiable"):
        jstate, _ = getattr(fixtures, name)().to_arrays()
    else:
        spec = CONFIG2_SMALL if name == "config2_small" else JBOD
        jstate, _ = JS.generate(JS.SyntheticSpec(**spec))
    jstate, jctx = _bucketed(jstate)
    return jstate, jctx, port_state(jstate), port_ctx(jctx)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("name", ["unbalanced", "rack_aware_satisfiable", "config2_small", "jbod"])
def test_snapshot_bands_bitwise(name, heavy):
    jstate, jctx, pstate, pctx = _case(name)
    want = JC.take_snapshot(jstate, jctx, heavy)
    got = PC.take_snapshot(pstate, pctx, heavy)
    for f in BANDS:
        g, w = to_np(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    # with the bands in the JAX order, every other field agrees bit for bit too
    assert_fields_same(got, want, skip=("enable_heavy",))


def test_jbod_case_has_disk_bands():
    """The JBOD case is not vacuous: it has disks and nonzero disk bands."""
    _, _, pstate, pctx = _case("jbod")
    snap = PC.take_snapshot(pstate, pctx, False)
    assert pstate.num_disks == 3 * 40
    assert float(snap.disk_upper.max()) > 0.0


def test_cluster_model_stats_bitwise():
    jstate, _, pstate, _ = _case("config2_small")
    want = JST.cluster_model_stats(jstate, jnp.asarray([1.1, 1.1, 1.1, 1.1], jnp.float32))
    got = PST.cluster_model_stats(pstate, torch.tensor([1.1, 1.1, 1.1, 1.1]))
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("B", [3, 32, 33, 64, 100, 128, 300])
def test_sum_over_brokers_bitwise(B):
    rng = np.random.default_rng(B)
    x = (rng.exponential(size=(B, 4)) * 1000).astype(np.float32)
    y = (rng.exponential(size=B) * 1000).astype(np.float32)
    got_x, got_y = PI.xla_sums([torch.from_numpy(x), torch.from_numpy(y)])
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(jnp.asarray(x).sum(axis=0)))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(jnp.asarray(y).sum()))
    assert got_x.shape == (4,) and got_y.shape == ()


@pytest.mark.parametrize("n", [0, 1, 1025, 5000, 40_000])
def test_xla_sums_recursive_windows(n):
    """Empty, single-row, and sums whose window sums need a second level
    (more than 32 windows)."""
    rng = np.random.default_rng(n)
    x = (rng.exponential(size=(n, 3)) * 1000).astype(np.float32)
    (got,) = PI.xla_sums([torch.from_numpy(x)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x).sum(axis=0)))


def test_xla_order_is_not_left_to_right():
    """The divergence the helper exists for: above 32 rows, XLA's sum and a
    left-to-right sum differ in the last bit on some inputs."""
    differ = 0
    for seed in range(20):
        x = (np.random.default_rng(seed).exponential(size=(300, 4)) * 1000).astype(np.float32)
        seq = np.zeros(4, np.float32)
        for row in x:
            seq = seq + row
        differ += not np.array_equal(seq, np.asarray(jnp.asarray(x).sum(axis=0)))
    assert differ > 0
