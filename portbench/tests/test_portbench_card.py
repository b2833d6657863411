"""On the card: each cell at its own size is correct, and its control is not.

The control is the program fed its loads rounded to bfloat16, the step below
the float32 the configurations state; it must fail at least one compared
number (``load_gap``, the snapshot's per-broker sums against the reference's
float64 sums).  Each seed draws its own pool of inputs: three for the
control, a dozen for sound runs, whose printed readings set the lower end
of each limit and the control's its upper end.  Run on the chip:

    python -m pytest portbench/tests/test_portbench_card.py -q -s
"""

import json
from pathlib import Path

import pytest
import torch

from portbench.run import run_cell

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (101, 202, 303)
SOUND_SEEDS = tuple(range(401, 413))


@pytest.fixture(autouse=True)
def _one_warm_pass(monkeypatch):
    """One warm-up pass: these runs judge proposals, they time nothing."""
    monkeypatch.setattr("portbench.run.WARM_S", 0.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _readings(tag, cell, seed, result):
    print(json.dumps({"tag": tag, "cell": cell, "seed": seed, "correct": result["correct"],
                      "checks": {k: v["value"] for k, v in result["checks"].items()}}))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell, seed):
    result, _ = run_cell(ROOT, cell, seed, 0.0, False, card, control=True, data_seed=seed)
    _readings("control", cell, seed, result)
    assert not result["correct"]


@pytest.mark.parametrize("seed", SOUND_SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_at_the_cells_size(card, cell, seed):
    result, _ = run_cell(ROOT, cell, 7, 0.0, False, card, data_seed=seed)
    _readings("sound", cell, seed, result)
    assert result["correct"] and result["failed"] == 0
