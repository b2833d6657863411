"""Slice parity on the remaining ``tests/fixtures.py`` clusters and on the gate's
config2_small (see ``test_torch_optimizer.py``).  config2_small's cold JAX
compile and 40-broker solve take minutes on one CPU, so it is marked ``slow``.
"""

import pytest

from tests.torch_optimizer_parity import (
    assert_same_solution,
    fixture_case,
    run_both,
    synthetic_case,
)
from tests.torch_port_helpers import CONFIG2_SMALL
from tests.torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse: one thread)


@pytest.mark.parametrize("name", ["unbalanced2", "rack_aware_satisfiable"])
def test_fixture_matches_jax(name):
    jfinal, jres, pfinal, pres = run_both(*fixture_case(name))
    assert_same_solution(jfinal, jres, pfinal, pres)
    assert pres.total_moves > 0


@pytest.mark.slow
def test_config2_small_matches_jax():
    jfinal, jres, pfinal, pres = run_both(*synthetic_case(CONFIG2_SMALL))
    assert_same_solution(jfinal, jres, pfinal, pres)
    assert pres.residual_hard_violations == 0
