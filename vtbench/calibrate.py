#!/usr/bin/env python3
"""Read the numbers that set a cell's correctness limits, on the card.

    python3 vtbench/calibrate.py --workload NAME --seeds S1,S2,... [--control]

from the root of a checkout. One process builds the cell's program once;
for each seed it loads that seed's weights, runs the requests a run of the
seed would judge (the sampled request, or the sampled stream's chunks)
through the timed entry at the cell's sizes, and compares them with the
plain float32 reference, as a run's check does. With ``--control`` the
reference in float8 (``quant="fp8"``), put in the program's place, is
compared the same way. One JSON line per seed on standard output:
``{"seed", "program": {number: value}, "control": {...}}``.

The lower reading of a limit is the largest ``program`` value over the
seeds, the upper the smallest ``control`` value (PERF.md).
"""

import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))


def readings(cell, prog, seed: int, control: bool) -> dict:
    """The numbers a run of ``seed`` compares, for the program (its
    weights and clips reloaded from the seed) and, with ``control``, for
    the float8 reference in its place."""
    import torch

    from vtbench import harness
    from vtbench.reference import weights as W

    traffic, w, dev, module = prog.traffic, cell.traffic, prog.device, cell.reference
    per = traffic.per_unit
    module.load(prog.tok, module.weights(prog.spec, seed, dev), w)
    traffic.clips = [W.clip(seed, k, tuple(w["clip"]), dev) for k in range(w["pool"])]
    kept = {}
    for u in sorted(harness.sample_indices(seed, w["check"])):
        traffic.cache = None
        for i in range(u * per, (u + 1) * per):
            kept[i] = traffic.issue(i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ref = harness.reference_answers(cell, seed, sorted(kept), per, dev)
    out = {"program": {k: c["value"] for k, c in harness.compare(cell, kept, ref).items()}}
    if control:
        ctl = harness.reference_answers(cell, seed, sorted(kept), per, dev, "fp8")
        out["control"] = {k: c["value"] for k, c in harness.compare(cell, ctl, ref).items()}
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from vtbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("calibrate: no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    prog = harness.build_program(cell, seeds[0], dev, {})
    for i in range(cell.traffic["warmup"] * prog.traffic.per_unit):
        prog.traffic.issue(i)
    for seed in seeds:
        t0 = time.perf_counter()
        line = {"seed": seed, "workload": cell.name, **readings(cell, prog, seed, args.control)}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
