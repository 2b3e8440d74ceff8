"""The control on the card: each cell with the program's precision
stepped down one rung (TF32 on for the factor and the solve, the TF32
reference in place of the SpMV) comes out not correct, and the same run
at the configuration's precision correct.  Sizes a test run can hold;
``benchmark/calibrate.py`` runs the same at the cells' own sizes."""

import pytest

from conftest import copy_root

from benchmark import harness

CELLS = ["poisson3d_g48.factor", "poisson3d_g48.solve", "poisson3d_g200.spmv"]


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return copy_root(str(tmp_path_factory.mktemp("small")),
                     {"poisson3d_g48": 24, "poisson3d_g200": 48})


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, small_root, cell, seed):
    sound = harness.run_cell(small_root, cell, seed, 1.0, False)
    control = harness.run_cell(small_root, cell, seed, 1.0, False,
                               control=True)
    print(cell, seed, "sound", sound["checks"], "control", control["checks"])
    assert sound["correct"] is True, sound["checks"]
    assert control["correct"] is False, control["checks"]
