"""Compare two checkouts of the port on one card, in turns.

    python3 -m chip_smoke.ab_trees NAME=DIR [NAME=DIR ...]

e.g. ``parent=build/parent change=. change=. parent=build/parent``: each
DIR is a checkout (its own ``vidtok_tpu_torch`` and ``chip_smoke``
package), run in the order given, each in a process of its own that
builds the checkout's kernels and measures, with ``chip_smoke``'s own
functions:

* kernels A-I and D' (bf16): ms per forward of the v1.0, v1.1 and tiled
  T=65 paths (G, H, I and D' in the forms that run them), each call shape timed by
  CUDA events (``chip_smoke.kernels.cuda_ms``) and weighted by its calls
  per forward (``chip_smoke.kernels.kernel_cases``);
* the request latency, s: ``chip_smoke.N_REQUESTS`` requests of
  ``REQUEST`` on the v1.0 kernel path and of ``TILED_REQUEST`` on the
  tiled v1.1 kernel path (``chip_smoke.serving.serve``), the best after
  the first;
* the temporal microbenchmark's rows of kernel B, T1 and T2 (``v0
  shipped``, ``v1 fat``, ``v2 mm-only``, ``v3 ln-only``), ms per call, at
  each of ``chip_smoke.TOOL_RUNS`` (the tool's ``main``: median, L2
  flushed).

Prints one JSON line per run, then a table of the runs side by side with
each run's ratio to the first name's mean. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import defaultdict

KERNELS = ("fused_spatial_resblock", "fused_temporal_resblock", "subpixel_interleave",
           "decoder_tail_rgb", "parity_up2x_fused", "fused_temporal_resblock_stream",
           "parity_blend_interleave", "parity_blend_interleave4", "subpixel_interleave_z",
           "decoder_tail_rgb_taps")
PATHS = ("v1_0", "v1_1", "tiled", "v1_0_forms", "v1_0_split", "tiled_forms")
TOOL_ROWS = ("v0 shipped", "v1 fat", "v2 mm-only", "v3 ln-only")

# What each run executes, from the root of its checkout.
CHILD = r'''
import json, subprocess, sys
from collections import defaultdict
import torch
import chip_smoke as cs
from chip_smoke import kernels as ck, serving as sv
from vidtok_tpu_torch.ops.kernels import _lib

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
_lib.library()
kernels, paths, TOOL_ROWS = json.loads(sys.argv[1])
per = defaultdict(lambda: defaultdict(float))
for case in ck.kernel_cases(dev):
    if case.name in kernels and any(case.calls.get(p, 0) for p in paths):
        ms = ck.cuda_ms(lambda: case.kernel(*case.args))
        for path, n in case.calls.items():
            per[case.name][path] += n * ms
    del case
torch.cuda.empty_cache()
out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip(),
       "ms_per_forward": {k: dict(v) for k, v in per.items()}}
tok = sv.make_tokenizer(cs.V1_0_CFG, dev)
out["v1_0_latency_s"] = sv.serve(tok, cs.N_REQUESTS, cs.REQUEST,
                                 cs.PER_FORWARD["v1_0"])["latency_s"]
del tok
torch.cuda.empty_cache()
tok = sv.make_tokenizer(cs.V1_1_CFG, dev)
tok.use_tiling, tok.use_overlap = True, True
out["tiled_latency_s"] = sv.serve(tok, cs.N_REQUESTS, cs.TILED_REQUEST,
                                  cs.tiled_per_forward(cs.TILED_REQUEST[2]))["latency_s"]
del tok
torch.cuda.empty_cache()
from vidtok_tpu_torch.tools import microbench_temporal as tm
out["tool_ms"] = {" ".join(argv): {r["name"]: r["ms"] for r in tm.main(argv)
                                   if r["name"] in TOOL_ROWS}
                  for argv in cs.TOOL_RUNS}
print("AB " + json.dumps(out), flush=True)
'''


def run(directory: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD,
                           json.dumps([KERNELS, PATHS, TOOL_ROWS])],
                          cwd=directory, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {directory} failed:\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    line = next(ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("AB "))
    return json.loads(line[3:])


def rows(result: dict) -> dict:
    """{row name: value} of one run: ms per forward by kernel and path, and
    the best request latency after the first."""
    out = {}
    for name in KERNELS:
        for path in PATHS:
            v = result["ms_per_forward"].get(name, {}).get(path, 0.0)
            if v:
                out[f"{name} {path} ms/fwd"] = v
    for key in ("v1_0_latency_s", "tiled_latency_s"):
        out[key] = min(result[key][1:])
    for argv, per in result["tool_ms"].items():
        for name in TOOL_ROWS:
            out[f"{name} [{argv}] ms"] = per[name]
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    runs = [a.split("=", 1) for a in argv]
    if not runs or any(len(r) != 2 for r in runs):
        raise SystemExit(__doc__)
    table = []
    for name, directory in runs:
        result = run(directory)
        print(f"{name} ({directory}): " + json.dumps(result), flush=True)
        table.append((name, rows(result)))
    base = defaultdict(list)
    for name, r in table:
        if name == runs[0][0]:
            for k, v in r.items():
                base[k].append(v)
    print("row | " + " | ".join(name for name, _ in table) + " | ratio to "
          + runs[0][0] + " (each run)")
    for k in table[0][1]:
        ref = sum(base[k]) / len(base[k])
        vals = [r.get(k, float("nan")) for _, r in table]
        print(f"{k} | " + " | ".join(f"{v:.4f}" for v in vals) + " | "
              + " ".join(f"{v / ref:.3f}" for v in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
