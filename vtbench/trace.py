"""Reading a ``torch.profiler`` trace of the measured window.

The traced window is one ``record_function`` span, ``vtbench.window``, on
the host thread that drives the requests. From the Chrome trace the
profiler writes, :func:`summarize` takes:

* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills) inside the window;
* ``port_kernel_s``: the summed time of the kernels whose names match a
  pattern of ``kernel_names/*.json`` (the port's hand-written kernels),
  ``plain_s`` that of every other device operation;
* ``device_ops``: device time by operation name, the largest first;
* ``idle_gaps``: the device's idle time inside the window, by what the host
  was doing during each gap (the innermost host span or operation that
  covers the gap's middle), the largest first.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "vtbench.window"
NAME_CHARS = 120


def kernel_patterns(directory: Path) -> dict:
    """{family: [compiled pattern, ...]} from ``directory/*.json``."""
    out = {}
    for path in sorted(Path(directory).glob("*.json")):
        spec = json.loads(path.read_text())
        out[path.stem] = [re.compile(p) for p in spec["patterns"]]
    return out


def family_of(name: str, patterns: dict):
    """The kernel-name family whose pattern matches ``name``, or None."""
    for family, pats in patterns.items():
        if any(p.search(name) for p in pats):
            return family
    return None


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host):
    """The innermost host event covering each gap's middle; ``host`` is a
    list of (start, end, name) on one thread, properly nested."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    labels, stack, k = [], [], 0
    for s, e in gaps:  # gaps come sorted
        mid = 0.5 * (s + e)
        hi = bisect.bisect_right(starts, mid)
        while k < hi:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        labels.append(stack[-1][2] if stack else "host: no span")
    return labels


def summarize(trace_path: Path, patterns: dict, top: int = 10) -> dict:
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    win = spans[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev, by_name = [], defaultdict(float)
    port = plain = 0.0
    families = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        dur = (t - s) * 1e-6
        dev.append((s, t))
        name = e["name"]
        by_name[name[:NAME_CHARS]] += dur
        fam = family_of(name, patterns) if e["cat"] == "kernel" else None
        if fam is None:
            plain += dur
        else:
            port += dur
            families[fam] += dur
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("tid") == win.get("tid") and e is not win
            and float(e["ts"]) < w1 and float(e["ts"]) + float(e.get("dur", 0.0)) > w0]
    idle = defaultdict(float)
    for (s, e), label in zip(gaps, _label_gaps(gaps, host)):
        idle[label[:NAME_CHARS]] += (e - s) * 1e-6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s, "port_kernel_s": port,
            "plain_s": plain, "families": dict(families),
            "device_ops": ranked(by_name), "idle_gaps": ranked(idle),
            "n_device_ops": len(dev)}
