"""The check that decides ``correct``, shown to fail: a whole run of each
cell at a tiny size on the CPU (the harness's look for a card skipped),
with the timed path broken underneath by each fault the cell's reference
module names (``faults``), reads ``correct`` false; the sound run reads it
true; the float8 control, put in the program's place, fails each cell's
limits. The limits are the cells' own. Each cell's check numbers at a
fixed seed are pinned in its own file under ``pinned/``."""

import json
from pathlib import Path

import pytest
import torch

from vtbench import harness
from vtbench_tiny import SPEC, cells, make

torch.set_num_threads(2)
CELLS = cells()
SEED = 2**41 + 17
# The check's numbers of each tiny cell at SEED, pinned in a file of its
# own, ``pinned/<cell>.json``: its sampled units issued through the timed
# entry and judged as a run's check does (read on an x86-64 CPU with two
# threads; a CPU whose kernels round otherwise reads other values). A change
# of the harness or of a reference module that moves them changes what a
# run judges; a cell without its file fails.
PINNED = Path(__file__).resolve().parent / "pinned"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make(tmp_path_factory.mktemp("vtbench"))


def run(bench, name, fault=None):
    cell = harness.load_cell(name, SPEC, bench)
    if fault is not None:
        fault = cell.reference.faults(cell.traffic)[fault]
    return harness.run_cell(cell, SEED, 0.3, False, "cpu", fault=fault)


def cell_faults():
    """(cell, fault) for every fault each cell's module names."""
    out = []
    for name in CELLS:
        cell = harness.load_cell(name)
        out += [(name, f) for f in cell.reference.faults(cell.traffic)]
    return out


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(bench, name):
    r = run(bench, name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("name,fault", cell_faults())
def test_fault_makes_run_incorrect(bench, name, fault):
    r = run(bench, name, fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_check_numbers_are_pinned(bench, name):
    path = PINNED / f"{name}.json"
    assert path.is_file(), f"cell {name!r} has no pin file {path}"
    pinned = json.loads(path.read_text())
    cell = harness.load_cell(name, SPEC, bench)
    prog = harness.build_program(cell, SEED, torch.device("cpu"), {})
    per, kept = prog.traffic.per_unit, {}
    for u in sorted(harness.sample_indices(SEED, cell.traffic["check"])):
        prog.traffic.cache = None
        for i in range(u * per, (u + 1) * per):
            kept[i] = prog.traffic.issue(i)
    checks = harness.judge(cell, SEED, kept, per, torch.device("cpu"))
    assert set(checks) == set(pinned)
    for k, c in checks.items():
        assert abs(c["value"] - pinned[k]) <= 1e-12, (k, c["value"], pinned[k])


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_fails_the_limits(bench, name):
    """The reference in float8, in the program's place, on three seeds."""
    from vtbench.reference.work import chunk_bounds

    cell = harness.load_cell(name, SPEC, bench)
    per = len(chunk_bounds(cell.traffic["clip"][2], cell.traffic["chunk_frames"])) \
        if cell.traffic["entry"] == "encode_chunk" else 1
    dev = torch.device("cpu")
    for seed in (SEED, SEED + 1, SEED + 2):
        idx = list(range(per))
        ref = harness.reference_answers(cell, seed, idx, per, dev)
        ctl = harness.reference_answers(cell, seed, idx, per, dev, "fp8")
        checks = harness.compare(cell, ctl, ref)
        assert any(c["value"] > c["limit"] for c in checks.values()), checks
