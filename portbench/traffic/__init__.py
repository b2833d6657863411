"""Traffic: the inputs of a cell, made by one general generator from a data file.

A traffic mix is a data file, ``portbench/traffic/mixes/<name>.json``, that
:func:`make_inputs` reads: the entry it drives, the goal list, whether heavy
goals are on, how many inputs a run cycles through and the seed of that pool
of inputs (``pool_seed``), and (for a batched entry) the rule of its
scenarios.  A solve's work depends on its input's data (its rounds vary by
some 15 % from one draw to the next), so every run of a cell solves the same
pool, and ``--seed`` sets the order in which the run cycles through it
(:func:`order`): the same work in another order.  The inputs are numpy
arrays (``synthetic.py``, ``scenario.py``); the entry turns them into the
program's tensors, and the reference reads the same arrays.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np

from portbench.traffic import scenario, synthetic

MIXES_DIR = Path(__file__).resolve().parent / "mixes"


def load_mix(name: str, root: Path = MIXES_DIR) -> dict:
    """The traffic mix ``name`` from its data file."""
    path = Path(root) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Input:
    """One input of a cell: the arrays of each lane (one for a single
    solve, ``count`` scenarios of one base cluster for a batched one)."""

    seed: int
    lanes: List[Dict[str, np.ndarray]]


def input_seeds(seed: int, count: int) -> List[int]:
    """The data seeds of ``count`` inputs, derived from ``seed`` (any
    integer, negative or past 32 bits)."""
    ss = np.random.SeedSequence(int(seed) % 2**64)
    return [int(s) for s in ss.generate_state(count, dtype=np.uint64)]


def order(seed: int, count: int) -> List[int]:
    """The order in which a run cycles through its ``count`` inputs."""
    return [int(i) for i in np.random.default_rng(int(seed) % 2**64).permutation(count)]


def make_inputs(spec: Mapping, mix: Mapping, seed: int) -> List[Input]:
    """The pool of ``mix["inputs"]`` inputs: the configuration's spec drawn
    at seeds derived from ``seed``, each under the mix's scenarios if it has
    any.  The same seed gives the same arrays."""
    out = []
    for s in input_seeds(seed, int(mix["inputs"])):
        base = synthetic.generate(spec, s)
        rule = mix.get("scenarios")
        if rule is None:
            out.append(Input(seed=s, lanes=[base]))
            continue
        scs = scenario.scenarios_from(rule)
        B = base["broker_rack"].shape[0]
        bucket = scenario.broker_bucket(max(B + sc["add_brokers"] for sc in scs))
        out.append(Input(seed=s, lanes=[scenario.apply_scenario(base, sc, bucket) for sc in scs]))
    return out
