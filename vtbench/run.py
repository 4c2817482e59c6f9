#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vidtok_tpu_torch`` once.

    python3 vtbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result's JSON object; the
numbers that decide ``correct`` are the last lines of standard error.
Without CUDA, or with fewer cards than the cell asks for, it exits with
code 2 and prints no result; if a module of JAX or of the JAX package is
loaded once the window has closed, with code 3.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.time()
CHECKOUT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program at a fixed path in the
# checkout (the kernel library builds into build/vidtok_tpu_torch)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CHECKOUT / "build" / "vtbench" / sub)
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    import argparse
    import json

    from vtbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_process = min(harness.process_start(), T_START)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"vtbench: {args.workload} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", t_process)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"vtbench: modules loaded that the port must not load: {bad}")
        return 3
    info = result.pop("info")
    print("info " + json.dumps(info), flush=True)
    harness.log(f"vtbench: card {info['card']}; {info['requests']} requests in "
                f"{info['window_s']:.3f} s; setup phases {info['setup_phases_s']}")
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
