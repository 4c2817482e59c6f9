"""On the card, at each cell's own size: the program's answers within the
cell's limits and the float8 control's outside them, on three seeds."""

import pytest

from vtbench import harness
from vtbench.calibrate import readings
from vtbench_tiny import cells

CELLS = cells()
SEEDS = (2**33 + 101, 2**33 + 102, 2**33 + 103)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_within_and_control_outside_the_limits(card, name):
    cell = harness.load_cell(name)
    limits = cell.traffic["check"]["limits"]
    prog = harness.build_program(cell, SEEDS[0], card, {})
    for seed in SEEDS:
        r = readings(cell, prog, seed, control=True)
        assert all(r["program"][k] <= limits[k] for k in limits), (seed, r)
        assert any(r["control"][k] > limits[k] for k in limits), (seed, r)
