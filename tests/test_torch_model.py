"""The port's model layer against the JAX package: synthetic generation, every
``model/arrays.py`` query, broker bucketing, stats, the numpy bridge, and the
package-level contracts (no JAX imports, CUDA by default).

Ints and bools must be exact.  Floats within rtol=1e-6, atol=1e-6: the port's
per-broker sums add rows in the same order as the JAX CPU scatter and agree
bitwise, but the cross-broker reductions in ``model.stats`` (sums, means,
variances over B) go through PyTorch's and XLA's own reduction orders, which
differ in the last float32 bit.
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu import synthetic as JS
from cruise_control_tpu.model import arrays as JA
from cruise_control_tpu.model import stats as JST
from cruise_control_tpu_torch import synthetic as PSY
from cruise_control_tpu_torch.model import arrays as PA
from cruise_control_tpu_torch.model import stats as PST
from cruise_control_tpu_torch.model.bridge import arrays_to_numpy
from tests import fixtures
from tests.torch_port_helpers import (
    CONFIG1,
    CONFIG2_SMALL,
    SMALL20,
    assert_fields_same,
    assert_same,
    port_state,
)

TOL = dict(rtol=1e-6, atol=1e-6)
SPECS = {"config1": CONFIG1, "small20": SMALL20}


def _pair(spec):
    jstate, jmaps = JS.generate(JS.SyntheticSpec(**spec))
    pstate, pmaps = PSY.generate(PSY.SyntheticSpec(**spec), device="cpu")
    return jstate, jmaps, pstate, pmaps


@pytest.mark.parametrize("spec", [CONFIG1, SMALL20, CONFIG2_SMALL], ids=["config1", "small20", "config2_small"])
def test_synthetic_generate_equal_arrays(spec):
    jstate, jmaps, pstate, pmaps = _pair(spec)
    assert_fields_same(pstate, jstate)
    assert dataclasses.asdict(pmaps) == dataclasses.asdict(jmaps)


QUERIES = [
    "is_leader", "effective_load", "broker_load", "host_load",
    "broker_replica_counts", "broker_leader_counts", "potential_nw_out",
    "disk_load", "utilization_matrix", "topic_replica_counts_by_broker",
    "replicas_per_rack_per_partition",
]


@pytest.mark.parametrize("name", QUERIES)
@pytest.mark.parametrize("which", list(SPECS))
def test_array_queries_match(name, which):
    jstate, _, pstate, _ = _pair(SPECS[which])
    assert_same(getattr(PA, name)(pstate), getattr(JA, name)(jstate), name, **TOL)


def test_jbod_queries_match():
    spec = dict(SMALL20, disks_per_broker=3)
    jstate, _, pstate, _ = _pair(spec)
    assert_same(PA.disk_load(pstate), JA.disk_load(jstate), "disk_load", **TOL)
    jdead = jstate.replace(disk_alive=jnp.asarray(np.arange(pstate.num_disks) % 4 != 0))
    pdead = port_state(jdead)
    assert_same(pdead.replica_offline_mask(), jdead.replica_offline_mask(), "offline")


def test_mutations_match():
    jstate, _, pstate, _ = _pair(SMALL20)
    idx = np.asarray([3, -1, 17, 40], np.int32)
    dst = np.asarray([5, 9, 2, 11], np.int32)
    for name, args in (
        ("relocate_replicas", (idx, dst)),
        ("relocate_leadership", (np.asarray([0, 7, -1], np.int32), np.asarray([1, 22, 5], np.int32))),
        ("swap_replicas", (np.asarray([3, 8, -1], np.int32), np.asarray([30, -1, 4], np.int32))),
    ):
        want = getattr(JA, name)(jstate, *(jnp.asarray(a) for a in args))
        got = getattr(PA, name)(pstate, *(torch.from_numpy(a) for a in args))
        assert_fields_same(got, want)
    assert_fields_same(
        PA.set_broker_state(pstate, 2, alive=False, demoted=True),
        JA.set_broker_state(jstate, 2, alive=False, demoted=True),
    )


@pytest.mark.parametrize("n", [3, 8, 9, 40, 100, 128, 129])
def test_broker_bucket_ladder(n):
    assert PA.broker_bucket(n) == JA.broker_bucket(n)


def test_pad_and_unpad_brokers_match():
    jstate, _, pstate, _ = _pair(SMALL20)
    want = JA.pad_brokers(jstate, 32)
    got = PA.pad_brokers(pstate, 32)
    assert_fields_same(got, want)
    assert_fields_same(
        PA.unpad_brokers(got, 20, pstate.num_hosts),
        JA.unpad_brokers(want, 20, jstate.num_hosts),
    )


def test_stack_and_index_arrays():
    _, _, a, _ = _pair(CONFIG1)
    b = PA.relocate_replicas(a, torch.tensor([0], dtype=torch.int32), torch.tensor([2], dtype=torch.int32))
    stacked = PA.stack_arrays([a, b], goal_orders=[(0, 1), (0, 1)])
    assert stacked.replica_broker.shape == (2, a.num_replicas)
    assert torch.equal(PA.index_arrays(stacked, 1).replica_broker, b.replica_broker)
    with pytest.raises(ValueError):
        PA.stack_arrays([a, b], goal_orders=[(0, 1), (1, 0)])


@pytest.mark.parametrize("which", list(SPECS))
def test_cluster_model_stats_match(which):
    jstate, _, pstate, _ = _pair(SPECS[which])
    pct = np.float32(1.1)
    want = JST.cluster_model_stats(jstate, jnp.asarray(pct))
    got = PST.cluster_model_stats(pstate, torch.tensor(pct))
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k], k, **TOL)
    for res in range(4):
        assert_same(PST.utilization_std(pstate, res), JST.utilization_std(jstate, res), "std", **TOL)


@pytest.mark.parametrize(
    "name", ["unbalanced", "unbalanced2", "rack_aware_satisfiable", "unbalanced_with_a_follower"]
)
def test_fixture_clusters_bridge_round_trip(name):
    jstate, _ = getattr(fixtures, name)().to_arrays()
    pstate = port_state(jstate)
    assert_fields_same(pstate, jstate)
    for k, v in arrays_to_numpy(pstate).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jstate, k)))
    assert_same(PA.broker_load(pstate), JA.broker_load(jstate), "broker_load", **TOL)


# -- package contracts --------------------------------------------------------------

_PKG = pathlib.Path(__file__).resolve().parents[1] / "cruise_control_tpu_torch"
_FORBIDDEN = ("jax", "jaxlib", "flax", "cruise_control_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_from_jax_or_the_jax_package():
    files = sorted(_PKG.rglob("*.py")) + [_PKG.parent / "chip_smoke.py"]
    assert len(files) > 10
    walked = {p.relative_to(_PKG).parts[0] for p in files if _PKG in p.parents}
    assert {"analyzer", "controller", "core", "model", "ops", "sim"} <= walked
    bad = []
    for path in files:
        for mod in _imported_roots(path):
            root = mod.split(".")[0]
            if root in _FORBIDDEN:
                bad.append(f"{path.relative_to(_PKG.parent)}: {mod}")
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        PSY.generate(PSY.SyntheticSpec(**CONFIG1))
    with pytest.raises(RuntimeError):
        GoalContext.build(2, 3)
    with pytest.raises(RuntimeError):
        GoalOptimizer()
    state, _ = PSY.generate(PSY.SyntheticSpec(**CONFIG1), device="cpu")
    with pytest.raises(RuntimeError):
        state.to(None)
    assert GoalOptimizer(device="cpu").device == torch.device("cpu")


def test_state_hash_tracks_the_placement():
    """The JAX package's hash needs 64-bit mode (it overflows int32 with x64
    off); the port hashes in int64.  Equal placements hash equal; a move
    changes the hash."""
    _, _, pstate, _ = _pair(CONFIG1)
    h0 = PA.self_satisfied_state_hash(pstate)
    assert h0.dtype == torch.int64
    assert torch.equal(h0, PA.self_satisfied_state_hash(PA.pad_brokers(pstate, 8)))
    moved = PA.relocate_replicas(pstate, torch.tensor([0], dtype=torch.int32), torch.tensor([2], dtype=torch.int32))
    assert not torch.equal(h0, PA.self_satisfied_state_hash(moved))


def test_logdir_moves_and_diff_match():
    from cruise_control_tpu.analyzer import proposals as JP
    from cruise_control_tpu_torch.analyzer import proposals as PP
    from cruise_control_tpu_torch.model.cluster import IndexMaps

    spec = dict(SMALL20, disks_per_broker=2)
    jstate, jmaps, pstate, pmaps = _pair(spec)
    assert isinstance(pmaps, IndexMaps)
    rows = np.asarray([1, 4, 9], np.int32)
    jfin = JA.relocate_replica_disks(jstate, jnp.asarray(rows), jnp.asarray([0, 1, 3], jnp.int32))
    jfin = JA.relocate_leadership(jfin, jnp.asarray([2], jnp.int32), jnp.asarray([7], jnp.int32))
    jfin = JA.relocate_replicas(jfin, jnp.asarray([30], jnp.int32), jnp.asarray([19], jnp.int32))
    pfin = port_state(jfin)
    assert PP.logdir_moves(pstate, pfin, pmaps) == JP.logdir_moves(jstate, jfin, jmaps)
    assert PP.diff(pstate, pfin, pmaps) == [
        PP.ExecutionProposal(**dataclasses.asdict(p)) for p in JP.diff(jstate, jfin, jmaps)
    ]
