"""The harness on the CPU: its data files, the contract of BENCHMARK.json,
what a later PR adds by files alone, the window's statistics, the trace
reader, the kernel names and the modules a run loads."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from vtbench import harness
from vtbench import trace as T
from vtbench.reference import model as R
from vtbench_tiny import BENCH, CHECKOUT, SPEC, make

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_SOURCES = ("host_clock", "device_trace")
SOURCES = E2E_SOURCES + ("program_span", "program_counter")


def spec() -> dict:
    return json.loads(SPEC.read_text())


def test_benchmark_json_meets_the_contract():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["vtbench"] and b["command"][1] == "vtbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"] == f"vtbench/configs/{c['name']}.json"
        assert (CHECKOUT / c["file"]).is_file() and len(c["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in E2E_SOURCES and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = e2e[m["moves"]].get("workloads", list(cells))
        assert "workloads" in m and set(m["workloads"]) <= set(moved), m["name"]
    for name in cells:
        cell = harness.load_cell(name)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer, name


def test_every_data_file_loads():
    b = spec()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        R.spec_of(cell.config)
        assert cell.traffic["entry"] in ("forward", "forward_tiled", "encode_chunk")
        assert set(cell.traffic["check"]["limits"]) <= {"z_rel", "rec_rel"}
    for m in b["per_layer"]:
        assert callable(harness.load_metric(BENCH, m["name"]))
    for path in (BENCH / "configs").glob("*.json"):
        assert json.loads(path.read_text())["source"]
    assert T.kernel_patterns(BENCH / "kernel_names")


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path):
    """A later PR adds a cell, its traffic, its configuration and a
    per-layer metric by adding files and entries: no file is edited."""
    bench = tmp_path / "vtbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = spec()
    cfg = json.loads((bench / "configs" / "vidtok_kl_causal_488_16chn.json").read_text())
    cfg["model"]["params"]["encoder_config"]["params"]["ch"] = 96
    (bench / "configs" / "flagship_ch96.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "t17-latency.json").read_text())
    traffic["clip"][3] = traffic["clip"][4] = 512
    (bench / "traffic" / "t17-512.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "requests.lat.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.records))\n")
    b["configs"].append({"name": "flagship_ch96", "source": "x", "reduced": [],
                         "file": "vtbench/configs/flagship_ch96.json", "why": "x"})
    b["workloads"].append({"name": "ch96-t17-512", "config": "flagship_ch96",
                           "traffic": "t17-512", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "requests.lat", "unit": "requests", "better": "higher",
                           "source": "host_clock", "layer": "x", "moves": "latency_p95_ms",
                           "workloads": ["ch96-t17-512"]})
    lat = next(m for m in b["end_to_end"] if m["name"] == "latency_p95_ms")
    lat["workloads"].append("ch96-t17-512")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell("ch96-t17-512", tmp_path / "BENCHMARK.json", bench)
    assert cell.traffic["clip"][3] == 512
    assert cell.config["model"]["params"]["encoder_config"]["params"]["ch"] == 96
    assert {m["name"] for m in cell.end_to_end} == {"latency_p95_ms", "peak_mem_gb", "setup_s"}
    assert "requests.lat" in {m["name"] for m in cell.per_layer}
    read = harness.load_metric(bench, "requests.lat")
    win = harness.Window(0.0, 1.0, [harness.Record(0, "request", 17, 0.0, 0.1, 0.5)])
    assert read(harness.RunContext(cell, win, None)) == 1.0
    old = harness.load_cell("flagship-t17-latency", tmp_path / "BENCHMARK.json", bench)
    assert "requests.lat" not in {m["name"] for m in old.per_layer}


def _window(latencies, frames=17, gap=0.0):
    recs, t = [], 0.0
    for i, lat in enumerate(latencies):
        recs.append(harness.Record(i, "request", frames, t, t + 0.001, t + lat))
        t += lat + gap
    return harness.Window(0.0, t, recs)


def test_statistics_take_all_work_over_all_time():
    steady = _window([0.05] * 100)
    stalled = _window([0.05] * 94 + [1.0] * 6)
    assert harness.frames_per_s(steady) == pytest.approx(17 * 100 / 5.0)
    assert harness.frames_per_s(stalled) == pytest.approx(17 * 100 / (0.05 * 94 + 6.0))
    assert harness.latency_p95_ms(steady) == pytest.approx(50.0)
    assert harness.latency_p95_ms(stalled) > 500.0
    # one stall outside every request, in the window, lowers the rate too
    idle = _window([0.05] * 100)
    idle.end += 2.0
    assert harness.frames_per_s(idle) < 0.75 * harness.frames_per_s(steady)


class _Clock:
    """Requests that take ``dt`` each, one of them ``stall`` more."""

    def __init__(self, dt, stall_at=None, stall=0.0):
        self.dt, self.stall_at, self.stall, self.w = dt, stall_at, stall, {"entry": "forward"}

    def kind(self, i):
        return "request"

    def frames(self, i):
        return 10

    def issue(self, i):
        time.sleep(self.dt + (self.stall if i == self.stall_at else 0.0))
        return ()


@pytest.mark.parametrize("loop", ["closed", "pipelined"])
def test_window_counts_every_request_to_its_end(loop):
    import torch

    w = harness.run_window(_Clock(0.01), 0.3, 0, torch.device("cpu"), loop, 2)
    assert w.records and all(r.issued <= r.returned <= r.done <= w.end for r in w.records)
    assert w.records[-1].issued < w.start + 0.3 <= w.end
    slow = harness.run_window(_Clock(0.01, 3, 0.3), 0.3, 0, torch.device("cpu"), loop, 2)
    assert harness.latency_p95_ms(slow) >= 0.0 and harness.frames_per_s(slow) < \
        harness.frames_per_s(w)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types

    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "vidtok_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("x"))
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "vidtok_tpu.fake", types.ModuleType("x"))
    assert "vidtok_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A whole run of a tiny cell, in a process of its own, then the loaded
    modules' top-level names."""
    bench = make(tmp_path / "bench")
    code = f"""
import sys, json
sys.path.insert(0, {str(CHECKOUT)!r})
import torch
torch.set_num_threads(2)
from pathlib import Path
from vtbench import harness
cell = harness.load_cell("v1_1-stream16-latency", Path({str(SPEC)!r}), Path({str(bench)!r}))
r = harness.run_cell(cell, 2**40 + 3, 0.3, True, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert "vidtok_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "vtbench/run.py", "--workload", "flagship-t17-latency",
                        "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(?:void\s+)?(\w+)\s*\(")


def test_kernel_names_match_every_global_of_the_port():
    patterns = T.kernel_patterns(BENCH / "kernel_names")
    csrc = CHECKOUT / "vidtok_tpu_torch" / "csrc"
    found = set()
    for path in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        found |= set(GLOBAL.findall(path.read_text()))
    assert {"conv_kernel", "act_rows_kernel", "tail_kernel"} <= found
    for name in found:
        for shown in (f"void vt::wg::{name}<128, 2>(CUtensorMap, int)",
                      f"void (anonymous namespace)::{name}<__nv_bfloat16>(int)",
                      f"{name}(float const*, int)"):
            assert T.family_of(shown, patterns), shown
    for other in ("void at::native::vectorized_elementwise_kernel<4, silu_kernel>(int)",
                  "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
                  "void cutlass::Kernel<conv_kernel>(int)", "Memcpy DtoD (Device -> Device)"):
        assert T.family_of(other, patterns) is None, other


def _event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_trace_summary(tmp_path):
    events = [_event(T.WINDOW, "user_annotation", 0, 1000),
              _event("vtbench.issue", "user_annotation", 0, 300),
              _event("aten::conv3d", "cpu_op", 10, 200),
              _event("vtbench.wait", "user_annotation", 300, 700),
              _event("void vt::wg::conv_kernel<128>(int)", "kernel", 100, 300, 7),
              _event("void vt::wg::conv_kernel<128>(int)", "kernel", 350, 100, 8),
              _event("cudnn_conv", "kernel", 600, 100, 7),
              _event("Memcpy DtoD", "gpu_memcpy", 900, 200, 7)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = T.summarize(path, T.kernel_patterns(BENCH / "kernel_names"))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((350 + 100 + 100) * 1e-6)  # [100,450] [600,700] [900,1000]
    assert s["port_kernel_s"] == pytest.approx(400e-6)
    assert s["plain_s"] == pytest.approx(200e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::conv3d"] == pytest.approx(100e-6)  # [0, 100], its middle in conv3d
    assert gaps["vtbench.wait"] == pytest.approx(150e-6 + 200e-6)
    assert len(gaps) == 2
    assert s["device_ops"][0][0].startswith("void vt::wg::conv_kernel")
