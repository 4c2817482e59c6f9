"""The benchmark of ``vidtok_tpu_torch``: one cell, one seed, one run.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Everything that
belongs to it is data the harness finds by name: its traffic mix and
entry in ``traffic/<traffic>.json``, its model in ``configs/<config>.json``, the
reference module that configuration names in ``reference/<module>.py``, each
per-layer metric's reader in ``metrics/<metric>.py``, the port's kernel
names in ``kernel_names/*.json``. Whatever depends on the model is read
through the reference module, chosen when the cell is loaded.

A run: set-up (import, CUDA, the kernel library, the model from its
config, seeded weights and clips made on the device, warm-up requests of
the cell's own shapes), then the window: requests for ``seconds``, in a
closed loop (the next request after the last one's synchronize) or
pipelined (launch request i, then wait for request i - depth). With
``trace`` a second window of the workload's ``trace_seconds`` runs under
``torch.profiler``. Then the program is freed and the plain reference
recomputes a sample of the window's requests, drawn from the seed, which
decides ``correct``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vidtok_tpu")
# what a configuration's reference module provides (reference/causal_kl.py)
CONTRACT = ("read_config", "PROGRAM_OPTIONS", "weights", "load", "shapes", "NUMBERS",
            "context", "ENTRIES", "kernel_calls", "model_flops", "faults", "tiny")


@dataclass
class Cell:
    name: str
    traffic: dict
    config: dict
    chips: int
    end_to_end: list
    per_layer: list
    bench_dir: Path
    reference: object  # the configuration's reference module
    spec: object       # its reading of the configuration


def _reports(metric: dict, cell: str, cell_e2e: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in cell_e2e if "moves" in metric else True


def load_reference(bench_dir: Path, name: str):
    """The reference module ``reference/<name>.py`` of ``bench_dir``."""
    path = Path(bench_dir) / "reference" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reference module {path}")
    modname = f"vtbench_reference_{name}"
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[modname] = module  # a dataclass's module has to be registered
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, benchmark: Path = CHECKOUT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``benchmark``, with its data files and its
    configuration's reference module from ``bench_dir``. Refuses, before
    any set-up, a configuration that names no reference module, a module
    that lacks a name of the contract or the traffic's entry, and limits
    on numbers the module does not give."""
    spec = json.loads(Path(benchmark).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {name!r} names no config of the benchmark")
    traffic = json.loads((Path(bench_dir) / "traffic" / f"{w['traffic']}.json").read_text())
    config = json.loads((Path(bench_dir) / "configs" / f"{w['config']}.json").read_text())
    if "reference" not in config:
        raise ValueError(f"configuration {w['config']!r} names no reference module")
    ref = load_reference(bench_dir, config["reference"])
    missing = [k for k in CONTRACT if not hasattr(ref, k)]
    if missing:
        raise ValueError(f"reference module {config['reference']!r} lacks {missing}")
    if traffic["entry"] not in ref.ENTRIES:
        raise ValueError(f"reference module {config['reference']!r} has no answer for "
                         f"the entry {traffic['entry']!r} of traffic {w['traffic']!r}")
    unknown = sorted(set(traffic["check"]["limits"]) - set(ref.NUMBERS))
    if unknown:
        raise ValueError(f"reference module {config['reference']!r} gives no {unknown}")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name, traffic, config, w["chips"], e2e, per_layer, Path(bench_dir), ref,
                ref.read_config(config))


def process_start() -> float:
    """Wall time at which this process started (from /proc; the time of
    this call where that cannot be read)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = float(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# -- requests -----------------------------------------------------------------

@dataclass
class Record:
    index: int
    kind: str
    frames: int
    issued: float
    returned: float = 0.0
    done: float = 0.0


@dataclass
class Window:
    start: float
    end: float
    records: List[Record] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def frames_per_s(w: Window) -> float:
    """Every frame of every request over the whole window."""
    return sum(r.frames for r in w.records) / w.seconds


def latency_p95_ms(w: Window) -> float:
    """The 95th percentile of the latency of every request in the window."""
    lat = [(r.done - r.issued) * 1e3 for r in w.records]
    if len(lat) < 2:
        return lat[0]
    return statistics.quantiles(lat, n=20, method="inclusive")[18]


class Traffic:
    """The requests of a cell: ``issue(i)`` runs request ``i`` through the
    program's entry and returns its outputs without waiting for the
    device; ``kind(i)`` and ``frames(i)`` say what it is. Request ``i``
    takes clip ``i % pool`` (a stream: stream ``i // chunks``).
    ``shapes(frames)`` gives the shapes of the outputs of a request over
    ``frames`` input frames."""

    def __init__(self, tok, traffic: dict, clips: list, shapes: Callable):
        self.tok = tok
        self.w = traffic
        self.clips = clips
        self.entry = traffic["entry"]
        self.cache = None
        self.bounds = [(0, traffic["clip"][2])]
        if self.entry == "encode_chunk":
            from vtbench.reference.work import chunk_bounds

            self.bounds = chunk_bounds(traffic["clip"][2], traffic["chunk_frames"])
        self.expected = [list(map(tuple, shapes(e - s))) for s, e in self.bounds]

    @property
    def per_unit(self) -> int:
        """Requests per unit of the check: a stream's chunks, else 1."""
        return len(self.bounds)

    def stream_of(self, i: int):
        return divmod(i, len(self.bounds))

    def shapes(self, i: int) -> list:
        """The shapes of request ``i``'s outputs."""
        return self.expected[self.stream_of(i)[1]]

    def kind(self, i: int) -> str:
        if self.entry != "encode_chunk":
            return "request"
        return "first_chunk" if self.stream_of(i)[1] == 0 else "chunk"

    def frames(self, i: int) -> int:
        if self.entry != "encode_chunk":
            return self.w["clip"][0] * self.w["clip"][2]
        s, e = self.bounds[self.stream_of(i)[1]]
        return self.w["clip"][0] * (e - s)

    def issue(self, i: int):
        if self.entry != "encode_chunk":
            z, rec, _ = self.tok(self.clips[i % len(self.clips)])
            return z, rec
        stream, j = self.stream_of(i)
        s, e = self.bounds[j]
        x = self.clips[stream % len(self.clips)][:, :, s:e]
        z, _, self.cache = self.tok.encode_chunk(x, None if j == 0 else self.cache)
        return (z,)


def _waiter(device):
    import torch

    if device.type == "cuda":
        def mark():
            ev = torch.cuda.Event()
            ev.record()
            return ev.synchronize
        return mark
    return lambda: (lambda: None)


def run_window(traffic: Traffic, seconds: float, start_index: int, device, loop: str,
               depth: int = 2, keep: Callable = None, span=None) -> Window:
    """Requests from ``start_index`` on until ``seconds`` have passed, then
    every request issued runs to its end, which closes the window.
    ``keep(i, outputs)`` sees every request's outputs; ``span(name)`` wraps
    the harness's phases for a trace."""
    span = span or (lambda name: contextlib.nullcontext())
    mark = _waiter(device)
    w = Window(time.perf_counter(), 0.0)
    inflight = []
    i = start_index
    while time.perf_counter() - w.start < seconds:
        rec = Record(i, traffic.kind(i), traffic.frames(i), time.perf_counter())
        with span("vtbench.issue"):
            out = traffic.issue(i)
        rec.returned = time.perf_counter()
        if keep is not None:
            keep(i, out)
        del out
        w.records.append(rec)
        inflight.append((rec, mark()))
        limit = depth if loop == "pipelined" else 0
        with span("vtbench.wait"):
            while len(inflight) > limit:
                r, wait = inflight.pop(0)
                wait()
                r.done = time.perf_counter()
        i += 1
    with span("vtbench.wait"):
        for r, wait in inflight:
            wait()
            r.done = time.perf_counter()
    w.end = time.perf_counter()
    return w


# -- the run ------------------------------------------------------------------

def load_metric(bench_dir: Path, name: str):
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vtbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def sample_indices(seed: int, check: dict) -> set:
    """The requests (streams, for a stream cell) whose answers are kept:
    ``sample`` drawn from the seed among the first ``within``."""
    from vtbench.reference.weights import derive

    rng = random.Random(derive(seed, "sample"))
    return set(rng.sample(range(check["within"]), check["sample"]))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


@dataclass
class Program:
    """The system under test as set-up leaves it: the tokenizer with the
    seed's weights, the cell's requests over the seed's clips, and the
    reference module's reading of its configuration."""
    tok: object
    traffic: Traffic
    spec: object
    device: object


def build_program(cell: Cell, seed: int, device, phases: dict,
                  fault: Optional[Callable] = None) -> Program:
    """Set-up up to the warm-up: the kernel library, the model from its
    config, the seed's weights and clips on the device. ``fault`` (tests
    only) is called with the tokenizer once it is built."""
    import torch

    import vidtok_tpu_torch

    from vtbench.reference import weights as W

    def phase(name, t0):
        phases[name] = time.perf_counter() - t0

    dev = torch.device(device)
    w, ref = cell.traffic, cell.reference
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from vidtok_tpu_torch.ops.kernels import _lib

        phases["kernel_build"] = _lib.library().build_seconds
    phase("kernel_library", t0)
    t0 = time.perf_counter()
    dtype = getattr(torch, w["compute_dtype"])
    tok = vidtok_tpu_torch.load_model_from_config(cell.config, device=dev, compute_dtype=dtype,
                                                  **ref.PROGRAM_OPTIONS)
    phase("model", t0)
    t0 = time.perf_counter()
    ref.load(tok, ref.weights(cell.spec, seed, dev), w)
    if fault is not None:
        fault(tok)
    phase("weights", t0)
    t0 = time.perf_counter()
    clips = [W.clip(seed, k, tuple(w["clip"]), dev) for k in range(w["pool"])]
    phase("clips", t0)
    traffic = Traffic(tok, w, clips, lambda frames: ref.shapes(cell.spec, w, frames))
    return Program(tok, traffic, cell.spec, dev)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: Optional[float] = None, fault: Optional[Callable] = None) -> dict:
    """One run of ``cell``; returns the result line's object (with ``info``
    and ``checks``). ``fault`` (tests only) is called with the tokenizer
    once it is built."""
    t_process = t_process if t_process is not None else time.time()
    phases = {"process_start": time.time() - t_process}
    t0 = time.perf_counter()
    import torch

    from vidtok_tpu_torch.ops import kernels as K

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    phases["import_and_init"] = time.perf_counter() - t0
    prog = build_program(cell, seed, dev, phases, fault)
    traffic, w = prog.traffic, cell.traffic
    t0 = time.perf_counter()
    per = traffic.per_unit
    for i in range(w["warmup"] * per):
        traffic.issue(i)
    traffic.cache = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases["warmup"] = time.perf_counter() - t0

    # the answers kept for the check: the sampled units (requests, or
    # streams of a stream cell) and, where the traffic asks, the window's
    # last unit
    chosen = sample_indices(seed, w["check"])
    kept, last, failed = {}, {}, [0]

    def keep(i, out):
        if [tuple(o.shape) for o in out] != traffic.shapes(i):
            failed[0] += 1
        unit = i // per
        if unit in chosen:
            kept[i] = out
        if w["check"]["last"]:
            last.setdefault(unit, {})[i] = out
            for u in [u for u in last if u < unit]:
                del last[u]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    setup_s = time.time() - t_process
    win = run_window(traffic, seconds, 0, dev, w["loop"], w.get("depth", 0), keep)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    launches = {k: v for k, v in K.counts("launches" if dev.type == "cuda" else "calls").items()
                if v}
    for unit, outs in last.items():
        kept.update(outs)

    traced = None
    if trace:
        traced = traced_window(traffic, w, win.records[-1].index + 1
                               if win.records else 0, dev, cell)
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    n_units = (win.records[-1].index // per + 1) if win.records else 0
    del prog, traffic
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    checks = judge(cell, seed, kept, per, dev)
    check_s = time.perf_counter() - t0
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    ctx = RunContext(cell=cell, window=win, traced=traced)
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = end_to_end_value(m["name"], win, setup_s, peak)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx.work = request_work(cell, win.records + traced["records"])
        for m in cell.per_layer:
            value = load_metric(cell.bench_dir, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": card,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(win.records), "failed": failed[0],
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = traced["summary"]["busy_s"]
        device_info["window_s"] = traced["summary"]["window_s"]
        result["breakdown"] = {"device_ops": traced["summary"]["device_ops"],
                               "idle_gaps": traced["summary"]["idle_gaps"]}
    lat = sorted((r.done - r.issued) * 1e3 for r in win.records)
    result["info"] = {"requests": len(win.records), "units": n_units,
                      "window_s": win.seconds, "setup_s": setup_s, "check_s": check_s,
                      "latency_median_ms": statistics.median(lat) if lat else None,
                      "setup_phases_s": phases, "launches": launches,
                      "launches_frozen": frozen_launches(cell, win.records),
                      "card": power_limit() if dev.type == "cuda" else None}
    if trace:
        result["info"]["trace"] = {k: traced["summary"][k] for k in
                                   ("port_kernel_s", "plain_s", "families", "n_device_ops")}
        result["info"]["trace"]["parse_s"] = traced["parse_s"]
    result["checks"] = checks
    return result


@dataclass
class RunContext:
    """What a per-layer metric's reader reads."""
    cell: Cell
    window: Window
    traced: Optional[dict]
    work: dict = field(default_factory=dict)


def end_to_end_value(name: str, win: Window, setup_s: float, peak: int) -> float:
    if name == "frames_per_s":
        return frames_per_s(win)
    if name == "latency_p95_ms":
        return latency_p95_ms(win)
    if name == "peak_mem_gb":
        return peak / 1e9
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def _request(cell: Cell, kind: str) -> tuple:
    """(input shape, first of its stream) of a request of ``kind``."""
    w = cell.traffic
    shape = tuple(w["clip"])
    if w["entry"] == "encode_chunk":
        first = kind == "first_chunk"
        frames = 1 if first else w["chunk_frames"]
        return (shape[0], shape[1], frames) + shape[3:], first
    return shape, True


def request_calls(cell: Cell, kind: str):
    """The frozen kernel calls of one request of ``kind``."""
    return cell.reference.kernel_calls(cell.spec, cell.traffic, *_request(cell, kind))


def request_work(cell: Cell, records) -> dict:
    """{request kind: (least kernel seconds, model FLOP)} for the kinds in
    ``records``, from the frozen counters."""
    from vtbench.reference import work as Wk

    out = {}
    for kind in sorted({r.kind for r in records}):
        out[kind] = (Wk.least_seconds(request_calls(cell, kind)),
                     cell.reference.model_flops(cell.spec, cell.traffic, *_request(cell, kind)))
    return out


def frozen_launches(cell: Cell, records) -> dict:
    """{kernel: launches} that the frozen call model gives ``records``."""
    from collections import Counter

    from vtbench.reference.work import launches

    per = {kind: launches(request_calls(cell, kind)) for kind in {r.kind for r in records}}
    total = Counter()
    for r in records:
        total.update(per[r.kind])
    return dict(total)


def traced_window(traffic: Traffic, w: dict, start: int, dev, cell: Cell) -> dict:
    """A second window of ``trace_seconds`` under ``torch.profiler``; the
    trace goes to ``$TMPDIR``."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from vtbench import trace as T

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(T.WINDOW):
            win = run_window(traffic, w["trace_seconds"], start, dev, w["loop"],
                             w.get("depth", 0), span=record_function)
    path = Path(tempfile.gettempdir()) / f"vtbench_trace_{cell.name}.json"
    prof.export_chrome_trace(str(path))
    t0 = time.perf_counter()
    summary = T.summarize(path, T.kernel_patterns(cell.bench_dir / "kernel_names"))
    return {"records": win.records, "window": win, "summary": summary, "path": str(path),
            "parse_s": time.perf_counter() - t0}


def reference_answers(cell: Cell, seed: int, indices, per: int, dev,
                      quant: str = "none") -> dict:
    """{request index: outputs} of the plain reference for ``indices``,
    from the seed's weights and clips, with TF32 off: the answer the
    configuration's reference module gives for the traffic's entry. A
    stream's chunks run in order from its first, up to the last one asked
    for. ``quant`` "fp8" gives the control."""
    import torch

    from vtbench.reference import weights as W
    from vtbench.reference.work import chunk_bounds

    w, ref = cell.traffic, cell.reference
    answer = ref.ENTRIES[w["entry"]]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctx = ref.context(ref.weights(cell.spec, seed, dev), cell.spec, quant)
    out = {}
    try:
        if w["entry"] == "encode_chunk":
            bounds = chunk_bounds(w["clip"][2], w["chunk_frames"])
            for s in sorted({i // per for i in indices}):
                x = W.clip(seed, s % w["pool"], tuple(w["clip"]), dev)
                upto = max(i for i in indices if i // per == s) - s * per
                state = None
                for j, (a, b) in enumerate(bounds[:upto + 1]):
                    out[s * per + j], state = answer(ctx, x[:, :, a:b], w, state)
        else:
            for i in sorted(indices):
                x = W.clip(seed, i % w["pool"], tuple(w["clip"]), dev)
                out[i], _ = answer(ctx, x, w, None)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {i: out[i] for i in indices}


def compare(cell: Cell, answers: dict, want: dict) -> dict:
    """{number: {"value", "limit"}}: for each number the traffic limits,
    the worst over the answers of the reference module's measure of it
    (each lower is better); inf where there is no answer to judge."""
    limits = cell.traffic["check"]["limits"]
    numbers = cell.reference.NUMBERS
    worst = {k: (0.0 if answers else float("inf")) for k in limits}
    for i, got in answers.items():
        for k in limits:
            worst[k] = max(worst[k], numbers[k](got, want[i]))
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}


def judge(cell: Cell, seed: int, kept: dict, per: int, dev) -> dict:
    """The kept answers against the plain reference in float32."""
    return compare(cell, kept, reference_answers(cell, seed, sorted(kept), per, dev))
