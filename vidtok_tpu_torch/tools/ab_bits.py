"""Compare the wgmma conv loop's outputs of two checkouts bit for bit.

    python3 -m vidtok_tpu_torch.tools.ab_bits DIR_A DIR_B

e.g. ``build/parent .``: each DIR is a checkout (its own
``vidtok_tpu_torch`` and ``chip_smoke.py``), run in a process of its own
that builds the checkout's kernels and runs, on ``chip_smoke``'s inputs
(the same seeds in both checkouts), every call shape of the kernels that
launch the loop: A, B, E and F in bf16 (``chip_smoke.kernel_cases``) and
in f32 (``f32_kernel_cases``), and the tools' T1 and T2 with kernel B at
the tools' shapes (``tool_cases``). Each output is fingerprinted on the
card: its elements' bits as integers (16- or 32-bit words), their sum and
a position-weighted sum in 64-bit integers. Prints each case whose
fingerprints differ and a summary line; exits 1 on any difference, or when
the two runs did not run the same cases. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys

CONV_KERNELS = ("fused_spatial_resblock", "fused_temporal_resblock",
                "fused_temporal_resblock_stream", "parity_up2x_fused")
CONV_TOOLS = ("fused_temporal_resblock", "fused_fat", "fused_diag")

# What each run executes, from the root of its checkout.
CHILD = r'''
import json, sys
import torch
import chip_smoke as cs
from vidtok_tpu_torch.ops.kernels import _lib

kernels, tools = json.loads(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
_lib.library()
weights = {}


def fingerprint(t):
    word = torch.int16 if t.element_size() == 2 else torch.int32
    w = t.contiguous().view(word).reshape(-1).to(torch.int64)
    n = w.numel()
    if n not in weights:
        weights.clear()
        weights[n] = torch.arange(n, device=t.device, dtype=torch.int64) % 65521 + 1
    return [str(t.dtype), list(t.shape), int(w.sum()), int((w * weights[n]).sum())]


prints = {}
for dtype, cases in (("bf16", cs.kernel_cases), ("f32", cs.f32_kernel_cases)):
    for i, case in enumerate(cases(dev)):
        if case.name in kernels:
            outs = cs._outs(case.kernel(*case.args))
            prints[f"{dtype} {i} {case.name} {case.key} mean {case.mean}"] = [
                fingerprint(o) for o in outs]
            del outs
        del case
        torch.cuda.empty_cache()
for i, case in enumerate(cs.tool_cases(dev, set(tools))):
    prints[f"tool {i} {case.name} {case.row} {case.shape}"] = [
        fingerprint(case.kernel(*case.args))]
    del case
torch.cuda.synchronize()
print("BITS " + json.dumps(prints), flush=True)
'''


def run(directory: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD,
                           json.dumps([CONV_KERNELS, CONV_TOOLS])],
                          cwd=directory, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {directory} failed:\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    line = next(ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("BITS "))
    return json.loads(line[5:])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit(__doc__)
    a, b = (run(d) for d in argv)
    differ = [k for k in a if k in b and a[k] != b[k]]
    for k in differ:
        print(f"DIFFERS {k}: {argv[0]} {a[k]} {argv[1]} {b[k]}", flush=True)
    same_cases = sorted(a) == sorted(b)
    outputs = sum(len(v) for v in a.values())
    print(f"ab_bits: {len(a)} cases, {outputs} outputs; {len(differ)} differ; "
          f"the same cases in both: {same_cases}", flush=True)
    return 0 if same_cases and not differ else 1


if __name__ == "__main__":
    sys.exit(main())
