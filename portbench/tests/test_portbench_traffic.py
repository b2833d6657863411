"""The frozen inputs: the benchmark's numpy generator and scenario arithmetic
equal the program's ``synthetic.generate`` and ``sim.scenario.apply_scenario``
at small sizes, field by field and bit by bit."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import synthetic as PS
from cruise_control_tpu_torch.model.bridge import arrays_to_numpy
from cruise_control_tpu_torch.sim import scenario as PSC

from portbench.traffic import input_seeds, make_inputs, scenario, synthetic

ROOT = Path(__file__).resolve().parents[2]

SPEC = dict(
    num_racks=4, num_brokers=12, num_topics=7, num_partitions=90, replication_factor=3,
    distribution="exponential", mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15,
    capacity_cpu=100.0, capacity_disk=300000.0, capacity_nw_in=300000.0, capacity_nw_out=200000.0,
    skew_brokers=3,
)


def _assert_same(ours: dict, theirs: dict) -> None:
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
        assert ours[k].dtype == v.dtype, k


@pytest.mark.parametrize("distribution", ["exponential", "uniform", "linear"])
@pytest.mark.parametrize("skew", [0, 3])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_generator_equals_the_programs(distribution, skew, seed):
    spec = dict(SPEC, distribution=distribution, skew_brokers=skew)
    ours = synthetic.generate(spec, seed)
    state, _ = PS.generate(PS.SyntheticSpec(**spec, seed=seed, build_maps=False), device="cpu")
    _assert_same(ours, arrays_to_numpy(state))
    assert (ours["num_racks"], ours["num_topics"], ours["num_hosts"]) == (
        state.num_racks, state.num_topics, state.num_hosts)


@pytest.mark.parametrize("sc", [
    {"add_brokers": 0, "kill_brokers": [], "load_factor": 1.0},
    {"add_brokers": 3, "kill_brokers": [], "load_factor": 1.14},
    {"add_brokers": 1, "kill_brokers": [2], "load_factor": 1.3},
    {"add_brokers": 7, "kill_brokers": [0], "load_factor": 1.02},
])
def test_scenario_equals_the_programs(sc):
    base = synthetic.generate(SPEC, 11)
    state, _ = PS.generate(PS.SyntheticSpec(**SPEC, seed=11, build_maps=False), device="cpu")
    bucket = scenario.broker_bucket(SPEC["num_brokers"] + 7)
    ours = scenario.apply_scenario(base, sc, bucket)
    theirs = PSC.apply_scenario(state, PSC.Scenario(
        add_brokers=sc["add_brokers"], kill_brokers=tuple(sc["kill_brokers"]), load_factor=sc["load_factor"],
    ), bucket_brokers=bucket)
    _assert_same(ours, arrays_to_numpy(theirs))
    assert ours["num_hosts"] == theirs.num_hosts


def test_the_sweep_harness_scenarios():
    rule = {"count": 16, "add_mod": 8, "kill_every": 3, "kill_mod": 5, "load_step": 0.02}
    scs = scenario.scenarios_from(rule)
    assert [s["add_brokers"] for s in scs] == [i % 8 for i in range(16)]
    assert [s["kill_brokers"] for s in scs] == [[i % 5] if i % 3 == 0 else [] for i in range(16)]
    assert [s["load_factor"] for s in scs] == [1.0 + 0.02 * i for i in range(16)]


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    mix = {"inputs": 4, "scenarios": {"count": 3, "add_mod": 8, "kill_every": 3, "kill_mod": 5, "load_step": 0.02}}
    a = make_inputs(SPEC, mix, 3_000_000_019)
    b = make_inputs(SPEC, mix, 3_000_000_019)
    c = make_inputs(SPEC, mix, 3_000_000_020)
    assert len(a) == 4 and all(len(i.lanes) == 3 for i in a)
    for x, y in zip(a, b):
        for lx, ly in zip(x.lanes, y.lanes):
            _assert_same(lx, {k: v for k, v in ly.items() if isinstance(v, np.ndarray)})
    assert len({s for s in input_seeds(3_000_000_019, 4)}) == 4
    assert not np.array_equal(a[0].lanes[0]["base_load"], c[0].lanes[0]["base_load"])
    assert input_seeds(-5, 2) == input_seeds(2**64 - 5, 2)
    assert torch.from_numpy(a[0].lanes[1]["broker_capacity"]).shape[0] == scenario.broker_bucket(12 + 2)


@pytest.mark.parametrize("config", sorted((ROOT / "portbench" / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_a_configuration_draws_its_sources_cluster(config):
    """The spec is the source's cluster: its racks, brokers, topics and
    replicas, its capacities, each partition's leader carrying the source's
    mean loads (followers its disk and NW in), rack-aware placement."""
    cfg = json.loads(config.read_text())
    src, spec = cfg["source_properties"], cfg["spec"]
    rf = spec["replication_factor"]
    assert src["MIN_REPLICATION"] == src["MAX_REPLICATION"] == rf
    assert (spec["num_racks"], spec["num_brokers"], spec["num_topics"]) == (
        src["NUM_RACKS"], src["NUM_BROKERS"], src["NUM_TOPICS"])
    assert spec["num_partitions"] * rf == src["NUM_REPLICAS"]
    a = synthetic.generate(spec, 2**31 + 3)
    cap = src["BROKER_CAPACITY"]
    np.testing.assert_array_equal(a["broker_capacity"][0], [cap["CPU"], cap["NW_IN"], cap["NW_OUT"], cap["DISK"]])
    lead = a["partition_leader"]
    base, delta = a["base_load"].astype(np.float64), a["leadership_delta"].astype(np.float64)
    means = {
        "MEAN_CPU": (base[lead, synthetic.CPU] + delta[:, synthetic.CPU]).mean(),
        "MEAN_NW_IN": base[lead, synthetic.NW_IN].mean(),
        "MEAN_NW_OUT": delta[:, synthetic.NW_OUT].mean(),
        "MEAN_DISK": base[lead, synthetic.DISK].mean(),
    }
    for k, v in means.items():
        assert v == pytest.approx(src[k], rel=1e-5), k
    racks = a["broker_rack"][a["replica_broker"]].reshape(-1, rf)
    assert all(len(set(r)) == rf for r in racks.tolist())
