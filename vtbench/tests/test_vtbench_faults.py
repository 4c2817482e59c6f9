"""The check that decides ``correct``, shown to fail: a whole run of each
cell at a tiny size on the CPU (the harness's look for a card skipped),
with the timed path broken underneath, reads ``correct`` false; the sound
run reads it true; the float8 control, put in the program's place, fails
each cell's limits. The limits are the cells' own."""

import pytest
import torch

from vtbench import harness
from vtbench.reference import model as R
from vtbench_tiny import SPEC, make

torch.set_num_threads(2)
CELLS = ["flagship-t201-pipelined", "v1_1-tiled-t201-pipelined", "flagship-t17-latency",
         "v1_1-stream16-latency"]
SEED = 2**41 + 17
# the faults a cell can have: an answer altered where it is produced, in
# every cell; a step that returns its state unchanged, where state is
# carried between chunks (the tiled forward and the stream). Every cell
# serves a batch of one on one chip, so it cannot leave out half of a
# batch nor an exchange between chips.
FAULTS = {c: ["answer"] for c in CELLS}
FAULTS["v1_1-tiled-t201-pipelined"].append("state")
FAULTS["v1_1-stream16-latency"].append("state")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make(tmp_path_factory.mktemp("vtbench"))


def answer_altered(tok):
    """The last latent frame of every z negated where the regularizer
    produces it (channels-last [B, T', H', W', C])."""
    core = tok.core
    regularize = core.regularize

    def altered(*a, **k):
        z, log = regularize(*a, **k)
        z = z.clone()
        z[:, -1] = -z[:, -1]
        return z, log

    core.regularize = altered


def state_unchanged(tok):
    """Every chunk step after the first returns the cache it was given."""
    core = tok.core
    encode_raw, decode = core.encode_raw, core.decode

    def enc(x, fused=False, streaming=False, first_chunk=True, cache=None):
        out = encode_raw(x, fused, streaming, first_chunk, cache)
        if streaming and cache is not None:
            return out[0], cache
        return out

    def dec(z, *a, streaming=False, cache=None, **k):
        out = decode(z, *a, streaming=streaming, cache=cache, **k)
        if streaming and cache is not None:
            return out[0], cache
        return out

    core.encode_raw, core.decode = enc, dec


PLANT = {"answer": answer_altered, "state": state_unchanged}


def run(bench, name, fault=None):
    cell = harness.load_cell(name, SPEC, bench)
    return harness.run_cell(cell, SEED, 0.3, False, "cpu", fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(bench, name):
    r = run(bench, name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_fault_makes_run_incorrect(bench, name, fault):
    r = run(bench, name, PLANT[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_fails_the_limits(bench, name):
    """The reference in float8, in the program's place, on three seeds."""
    cell = harness.load_cell(name, SPEC, bench)
    per = len(R.chunk_bounds(cell.traffic["clip"][2], cell.traffic["chunk_frames"])) \
        if cell.traffic["entry"] == "encode_chunk" else 1
    dev = torch.device("cpu")
    for seed in (SEED, SEED + 1, SEED + 2):
        idx = list(range(per))
        ref = harness.reference_answers(cell, seed, idx, per, dev)
        ctl = harness.reference_answers(cell, seed, idx, per, dev, "fp8")
        checks = harness.compare(cell, ctl, ref)
        assert any(c["value"] > c["limit"] for c in checks.values()), checks
