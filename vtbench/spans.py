"""The program's own spans in the traced window, and the device time under each.

``vidtok_tpu_torch`` marks its layer boundaries with ``RecordFunction``
ranges named ``vt.<layer>.<part>`` (``utils/profiling.span``), recorded
only while a profiler records. From the Chrome trace of the traced window
:func:`read` takes the ``vt.*`` spans on the window's thread with their
nesting, joins each device operation (kernel, copy, fill) to the host call
that launched it (``cuda_runtime`` or ``cuda_driver``) through
``args.correlation``, and attributes the operation's device time inside the
window to every ``vt.*`` span that encloses that launch. An operation with
no launch on the window's thread, or launched outside every ``vt.*`` span,
stays unattributed. A trace with no ``vt.*`` span (a program without
spans) reads as None. Each trace file is parsed once.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from vtbench.trace import DEVICE_CATS, WINDOW

PREFIX = "vt."
SPAN_CATS = ("cpu_op", "user_annotation")  # the C++ RecordFunction's, record_function's
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Span:
    name: str
    start: float            # us, on the trace's clock
    end: float
    parent: Optional[int]   # index of the enclosing vt.* span, or None
    ops: int = 0            # device operations launched under it, nested spans included


@dataclass
class Op:
    name: str
    cat: str                # kernel, gpu_memcpy or gpu_memset
    start: float            # us, on the device
    seconds: float          # its time inside the window
    launched: Optional[float]  # us, its launch on the window's thread, or None
    under: frozenset        # the names of the vt.* spans enclosing the launch


@dataclass
class Spans:
    spans: list             # every vt.* span of the window, by start
    ops: list               # every device operation of the window, as an Op

    def device_under(self, name: str) -> float:
        """Device seconds of the operations launched under a span called
        ``name``; a ``name`` that ends in ``.`` takes every span whose name
        starts with it. Each operation counts once."""
        if name.endswith("."):
            return sum(o.seconds for o in self.ops if any(n.startswith(name) for n in o.under))
        return sum(o.seconds for o in self.ops if name in o.under)

    @property
    def unattributed_s(self) -> float:
        """Device seconds launched outside every vt.* span, or not from the
        window's thread."""
        return sum(o.seconds for o in self.ops if not o.under)

    @property
    def device_s(self) -> float:
        return sum(o.seconds for o in self.ops)


def read(path) -> Optional[Spans]:
    """:func:`attribute` of the Chrome trace at ``path``."""
    st = os.stat(path)
    return _read(str(path), st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=2)
def _read(path: str, mtime_ns: int, size: int) -> Optional[Spans]:
    return attribute(json.loads(Path(path).read_text())["traceEvents"])


def _x(e, cats) -> bool:
    return e.get("ph") == "X" and e.get("cat") in cats


def attribute(events: list) -> Optional[Spans]:
    """The ``vt.*`` spans of the window in ``events`` (a Chrome trace's
    ``traceEvents``) and the device time under them; None without one."""
    win = next((e for e in events if _x(e, ("user_annotation",)) and e["name"] == WINDOW),
               None)
    if win is None:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    tid, w0 = win.get("tid"), float(win["ts"])
    w1 = w0 + float(win["dur"])
    found = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                    for e in events if _x(e, SPAN_CATS) and e.get("tid") == tid
                    and e["name"].startswith(PREFIX)), key=lambda s: (s[0], -s[1]))
    if not found:
        return None
    spans, stack = [], []
    for s, e, name in found:
        while stack and spans[stack[-1]].end < e:
            stack.pop()
        spans.append(Span(name, s, e, stack[-1] if stack else None))
        stack.append(len(spans) - 1)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if _x(e, LAUNCH_CATS) and e.get("tid") == tid
                and "correlation" in e.get("args", {})}
    ops = []
    for e in events:
        if not _x(e, DEVICE_CATS):
            continue
        t0 = float(e["ts"])
        dur = min(t0 + float(e.get("dur", 0.0)), w1) - max(t0, w0)
        if dur > 0:
            ops.append(Op(e["name"], e["cat"], t0, dur * 1e-6,
                          launched.get(e.get("args", {}).get("correlation")), frozenset()))
    # in launch order: the innermost span enclosing a launch is the last one
    # started before it, or the first of that one's ancestors still open
    k = 0
    for op in sorted((o for o in ops if o.launched is not None), key=lambda o: o.launched):
        while k < len(spans) and spans[k].start <= op.launched:
            k += 1
        i = k - 1 if k else None
        while i is not None and spans[i].end < op.launched:
            i = spans[i].parent
        chain = []
        while i is not None:
            chain.append(i)
            spans[i].ops += 1
            i = spans[i].parent
        op.under = frozenset(spans[i].name for i in chain)
    return Spans(spans, ops)
