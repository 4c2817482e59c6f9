"""Time the launches of kernels D's and D''s f32 forms apart on the card.

    python3 -m vidtok_tpu_torch.tools.tail_split
    PYTHONPATH=DIR python3 vidtok_tpu_torch/tools/tail_split.py

The f32 tail is two launches in one C entry: a row pass
(``act_rows_kernel``), then the tail (``tail_f32_kernel``). For every f32
call shape of D and D' that ``chip_smoke.f32_kernel_cases`` times (the
phase-19 requests' calls), this prints the whole call's time by CUDA events
(``chip_smoke.cuda_ms``) and each launch's device time per call from
``torch.profiler`` (5 calls after a warm-up), then both per forward of each
request path, beside the bound of ``chip_smoke.f32_work``. The second form
runs it on the checkout DIR (its ``vidtok_tpu_torch`` and ``chip_smoke.py``,
its kernels built under DIR): the way to time an earlier tree's f32 tail
the same way. A kernel whose wrapper refuses f32 there is skipped. Prints
one ``SPLIT`` JSON line at the end. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from collections import Counter, defaultdict

KERNELS = ("decoder_tail_rgb", "decoder_tail_rgb_taps")
ITERS = 5


def _parts(call) -> dict:
    """{launch: device ms per call} of ``call`` under torch.profiler:
    ``rows`` the row pass, ``tail`` the tail kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            call()
        torch.cuda.synchronize()
    total, count = defaultdict(float), Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            part = ("rows" if "_rows_kernel" in e.key else
                    "tail" if "tail" in e.key else "other")
            total[part] += e.self_device_time_total / 1e3
            count[part] += e.count
    return {part: total[part] / ITERS for part in total}, dict(count)


def main() -> dict:
    import torch

    import chip_smoke as cs
    from vidtok_tpu_torch.ops.kernels import _lib
    from vidtok_tpu_torch.tools import bound_ms

    if not torch.cuda.is_available():
        raise RuntimeError("tail_split needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _lib.library()
    per = defaultdict(lambda: defaultdict(lambda: defaultdict(float)))
    for case in cs.f32_kernel_cases(device):
        if case.name not in KERNELS or not any(case.calls.values()):
            continue
        try:
            case.kernel(*case.args)
        except ValueError as e:
            print(f"{case.name} {case.key}: skipped ({e})", flush=True)
            continue
        ms = cs.cuda_ms(lambda: case.kernel(*case.args))
        parts, seen = _parts(lambda: case.kernel(*case.args))
        bound = bound_ms(*cs.f32_work(case.name, case.key))[0]
        print(f"{case.name} f32 {case.key}: call {ms:.4f} ms (CUDA events); "
              + "; ".join(f"{k} {v:.4f} ms ({seen[k]} launches in {ITERS} calls)"
                          for k, v in sorted(parts.items()))
              + f"; bound {bound:.4f} ms; calls/forward {case.calls}", flush=True)
        for path, n in case.calls.items():
            for k, v in list(parts.items()) + [("call", ms), ("bound", bound)]:
                per[case.name][path][k] += n * v
        del case
    out = {name: {path: dict(v) for path, v in paths.items() if v.get("call")}
           for name, paths in per.items()}
    for name, paths in out.items():
        for path, v in paths.items():
            print(f"{name} f32 per forward of {path}: "
                  + ", ".join(f"{k} {x:.4f} ms" for k, x in sorted(v.items())), flush=True)
    print("SPLIT " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
