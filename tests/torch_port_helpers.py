"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are built once in numpy (synthetic specs, the gate configs,
``tests/fixtures.py`` clusters through the JAX ``ClusterModel.to_arrays``) and
handed to both packages: the JAX objects' fields become numpy arrays and go
into the port through ``cruise_control_tpu_torch.model.bridge``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.model.bridge import arrays_from_numpy, context_from_numpy

_STATIC = ("num_racks", "num_topics", "num_hosts")

#: gate config #1 (obs/gate.py: 3 brokers / 20 partitions, skewed)
CONFIG1 = dict(
    num_racks=2, num_brokers=3, num_topics=2, num_partitions=20,
    replication_factor=2, distribution="exponential", skew_brokers=1,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=3,
)
#: a ~20-broker skewed synthetic cluster: every default goal has work
SMALL20 = dict(
    num_racks=4, num_brokers=20, num_topics=6, num_partitions=120,
    replication_factor=3, distribution="exponential", skew_brokers=6,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=11,
)
#: gate config2_small (obs/gate.py: 40 brokers / 2k partitions)
CONFIG2_SMALL = dict(
    num_racks=5, num_brokers=40, num_topics=20, num_partitions=2000,
    replication_factor=3, distribution="exponential", skew_brokers=10,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)



@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The port's solves of a test module on one intra-op thread (a module
    that imports this fixture takes it): the suite's workers share the CPU,
    and torch's default of a thread a core each oversubscribes it -- a 3 s
    port solve took 96 s in a loaded run.  The port's results do not depend
    on the thread count: its float sums run in a fixed order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_state(jax_state, device="cpu"):
    """The port's ClusterArrays built from a JAX ClusterArrays' numpy fields."""
    fields = {
        f.name: np.asarray(getattr(jax_state, f.name))
        for f in dataclasses.fields(jax_state)
        if f.name not in _STATIC
    }
    return arrays_from_numpy(
        fields, jax_state.num_racks, jax_state.num_topics, jax_state.num_hosts, device
    )


def port_ctx(jax_ctx, device="cpu"):
    """The port's GoalContext built from a JAX GoalContext's numpy fields."""
    skip = ("constraint", "top_k", "max_active_brokers")
    fields = {
        f.name: np.asarray(getattr(jax_ctx, f.name))
        for f in dataclasses.fields(jax_ctx)
        if f.name not in skip
    }
    cons = {
        f.name: np.asarray(getattr(jax_ctx.constraint, f.name))
        for f in dataclasses.fields(jax_ctx.constraint)
    }
    return context_from_numpy(
        fields, cons, top_k=jax_ctx.top_k,
        max_active_brokers=jax_ctx.max_active_brokers, device=device,
    )


def assert_same(got, want, name="", rtol=0.0, atol=0.0):
    """Ints/bools exact; floats within (rtol, atol); shapes equal."""
    g, w = to_np(got), np.asarray(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}"
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)


def assert_fields_same(port_obj, jax_obj, rtol=0.0, atol=0.0, skip=()):
    """Every tensor field of a port dataclass against the JAX object's field
    of the same name (both None allowed)."""
    for f in dataclasses.fields(port_obj):
        if f.name in skip:
            continue
        got = getattr(port_obj, f.name)
        want = getattr(jax_obj, f.name)
        if got is None or want is None:
            assert got is None and want is None, f"{f.name}: {got!r} vs {want!r}"
            continue
        if not isinstance(got, torch.Tensor):
            assert got == (want if not hasattr(want, "shape") else np.asarray(want)), f.name
            continue
        assert_same(got, want, f.name, rtol=rtol, atol=atol)


def port_cluster_model(jmodel):
    """The port's ``ClusterModel`` replaying a JAX ``ClusterModel`` through
    the public methods: racks, brokers (capacity, host, logdirs, state, dead
    and removed logdirs), replicas in the JAX model's order with their index,
    leadership, logdir and original flag, and their measured loads."""
    from cruise_control_tpu_torch.core.resources import Resource as PResource
    from cruise_control_tpu_torch.model.cluster import ClusterModel as PClusterModel
    from cruise_control_tpu_torch.model.model_utils import CpuModelWeights

    w = jmodel._cpu_weights
    model = PClusterModel(cpu_weights=CpuModelWeights(
        leader_bytes_in=w.leader_bytes_in, leader_bytes_out=w.leader_bytes_out,
        follower_bytes_in=w.follower_bytes_in,
    ))
    for rack in jmodel._racks:
        model.create_rack(rack)
    for broker_id, b in jmodel._brokers.items():
        model.create_broker(
            b.rack, broker_id, {r: float(b.capacity[int(r)]) for r in PResource},
            host=b.host, logdirs=dict(b.logdirs),
        )
    for (tp, broker_id), r in jmodel._replicas.items():
        model.create_replica(broker_id, tp, r.index, r.is_leader, logdir=r.logdir,
                             is_original=r.is_original)
        if r.load is not None:
            model.set_replica_load(broker_id, tp, r.load)
    for broker_id, b in jmodel._brokers.items():
        model.set_broker_state(broker_id, b.state)
        for d in sorted(b.dead_logdirs):
            model.mark_disk_dead(broker_id, d)
        for d in sorted(b.removed_logdirs):
            model.mark_disk_removed(broker_id, d)
        model.set_broker_state(broker_id, b.state)
    return model


def assert_keys_superset(port, jax, path="$"):
    """Every key of the JAX wire dict is in the port's, recursively (the port
    may add keys of its own, as the API schemas allow)."""
    if isinstance(jax, dict):
        assert isinstance(port, dict), f"{path}: {type(port).__name__} is not a dict"
        missing = set(jax) - set(port)
        assert not missing, f"{path}: the port lacks the JAX keys {sorted(missing)}"
        for k, v in jax.items():
            assert_keys_superset(port[k], v, f"{path}.{k}")
    elif isinstance(jax, list) and jax and isinstance(jax[0], dict):
        assert len(port) == len(jax), path
        for i, (p, j) in enumerate(zip(port, jax)):
            assert_keys_superset(p, j, f"{path}[{i}]")


def clear_records() -> None:
    """Empty the JAX package's and the port's flight-record rings."""
    from cruise_control_tpu.obs import RECORDER as JRECORDER
    from cruise_control_tpu_torch.obs import RECORDER

    JRECORDER.clear()
    RECORDER.clear()


def recorded_shapes(kind: str):
    """The JAX package's and the port's flight records of ``kind`` (oldest
    first) as ``chip_smoke._record_shape`` gives them: (kind, attribute names,
    spans' (kind, name, attribute names))."""
    from chip_smoke import _record_shape
    from cruise_control_tpu.obs import RECORDER as JRECORDER
    from cruise_control_tpu_torch.obs import RECORDER

    return tuple(
        _record_shape(reversed(rec.recent(rec.capacity, kind=kind))) for rec in (JRECORDER, RECORDER)
    )


#: what the port's "optimize" records carry beyond the JAX package's: the
#: host's blocked seconds and the graph launches' device time on the record,
#: each goal's launch's device time on its span
PORT_OPTIMIZE_ATTRS = ("host_wait_s", "graph_device_s")
PORT_GOAL_SPAN_ATTRS = ("device_s",)


def _jax_shape(record_shape):
    """A port record's shape (``chip_smoke._record_shape``) less the port's
    own attributes, which an "optimize" record must carry."""
    kind, attrs, spans = record_shape
    if kind != "optimize":
        return record_shape
    assert set(PORT_OPTIMIZE_ATTRS) <= set(attrs), attrs
    goals = [names for k, _, names in spans if k == "goal"]
    assert all(set(PORT_GOAL_SPAN_ATTRS) <= set(names) for names in goals), goals
    return (
        kind, [a for a in attrs if a not in PORT_OPTIMIZE_ATTRS],
        [(k, n, [a for a in names if k != "goal" or a not in PORT_GOAL_SPAN_ATTRS]) for k, n, names in spans],
    )


def assert_records_match(kind: str, count: int = None):
    """The port wrote the records of ``kind`` the JAX package wrote, shape for
    shape (``recorded_shapes``), ``count`` of them when given; an "optimize"
    record of the port carries :data:`PORT_OPTIMIZE_ATTRS` and its goal spans
    :data:`PORT_GOAL_SPAN_ATTRS` besides."""
    jax_shapes, port_shapes = recorded_shapes(kind)
    assert [_jax_shape(s) for s in port_shapes] == list(jax_shapes)
    assert jax_shapes and (count is None or len(jax_shapes) == count), jax_shapes


#: the port's callables that take ``device``, as the JAX test sources call
#: them: the app's and the facade's constructors, the gate's ``run_tier`` and
#: its command line ``gate_mod.main``
_DEVICE_BOUND = r"(?<![\w.])(CruiseControlTpuApp|CruiseControl|(?:gate_mod\.)?run_tier|gate_mod\.main)\("


def port_test_module(name: str, device=None):
    """The JAX package's test module ``tests/<name>.py`` with every
    ``cruise_control_tpu.`` module path in it (imports and dotted class names)
    pointed at ``cruise_control_tpu_torch.``: a port test file binds the
    classes it runs, whose cases then run unchanged against the port.  The
    module is compiled from the JAX file's source, so its names stay the JAX
    test's; pytest's assertion rewriting does not apply to it.

    The JAX sources build the app and the facade and run the gate with no
    device, and the port's default is the GPU.  With ``device`` given, every
    call of ``CruiseControlTpuApp(...)``, ``CruiseControl(...)``, the gate's
    ``run_tier(...)`` or ``gate_mod.main(...)`` in the source gets
    ``device=device`` explicitly; nothing in the port defaults to the CPU.
    A ``tests.test_<x>`` module the source imports (``tests.test_api``'s
    ``build_app``) is its ported copy on the same device."""
    import functools
    import pathlib
    import re
    import sys
    import types

    path = pathlib.Path(__file__).resolve().parent / f"{name}.py"
    source = re.sub(r"\bcruise_control_tpu\.", "cruise_control_tpu_torch.", path.read_text())
    for dep in sorted(set(re.findall(r"\btests\.(test_\w+)\b", source)) - {name}):
        if f"tests.{dep}_on_the_port" not in sys.modules:
            port_test_module(dep, device)
    source = re.sub(r"\btests\.(test_\w+)\b", r"tests.\1_on_the_port", source)
    module = types.ModuleType(f"tests.{name}_on_the_port")
    module.__file__ = str(path)
    if device is not None:
        source = re.sub(_DEVICE_BOUND, r"_on_device(\1)(", source)
        module.__dict__["_on_device"] = lambda cls: functools.partial(cls, device=device)
    sys.modules[module.__name__] = module
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module
