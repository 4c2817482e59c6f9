"""The harness on the CPU: its data files, the contract of BENCHMARK.json,
what a later PR adds by files alone (a cell, a configuration with its own
reference module, a metric, a model that runs no port kernel), the refusals of a cell before set-up, the
window's statistics, the trace reader, the kernel names and the modules a
run loads."""

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
        assert cell.spec is not None and cell.traffic["entry"] in cell.reference.ENTRIES
        assert set(cell.traffic["check"]["limits"]) <= set(cell.reference.NUMBERS)
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
    cfg = harness.load_reference(bench, cfg["reference"]).tiny(cfg, 96)
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
    assert cell.config == cfg and cell.reference.read_config(cfg).ch == 96
    assert {m["name"] for m in cell.end_to_end} == {"latency_p95_ms", "peak_mem_gb", "setup_s"}
    assert "requests.lat" in {m["name"] for m in cell.per_layer}
    read = harness.load_metric(bench, "requests.lat")
    win = harness.Window(0.0, 1.0, [harness.Record(0, "request", 17, 0.0, 0.1, 0.5)])
    assert read(harness.RunContext(cell, win, None)) == 1.0
    old = harness.load_cell("flagship-t17-latency", tmp_path / "BENCHMARK.json", bench)
    assert "requests.lat" not in {m["name"] for m in old.per_layer}


# A reference module a later PR adds as a file: the causal KL model with a
# number of its own, the largest absolute difference of z
ABS_MODULE = """from vtbench.reference.causal_kl import *  # noqa: F401,F403


def z_abs(got, want):
    return float((got[0].double() - want[0].double()).abs().max())


NUMBERS = {"z_abs": z_abs}
"""


def add_cell(tmp_path, module: str, traffic: str, limits: dict, config_keys=None):
    """The tiny bench under ``tmp_path`` with a configuration ``added``
    naming ``reference/added.py`` (``module``'s text), a traffic ``added``
    (the tiny ``traffic`` with ``limits``) and a cell ``added-cell``, all
    new files and entries; returns (BENCHMARK.json, bench directory)."""
    bench = make(tmp_path / "vtbench")
    (bench / "reference" / "added.py").write_text(module)
    cfg = json.loads((bench / "configs" / "vidtok_kl_causal_488_16chn.json").read_text())
    cfg.update({"reference": "added", **(config_keys or {})})
    cfg = {k: v for k, v in cfg.items() if v is not None}
    (bench / "configs" / "added.json").write_text(json.dumps(cfg))
    t = json.loads((bench / "traffic" / f"{traffic}.json").read_text())
    t["check"]["limits"] = limits
    (bench / "traffic" / "added.json").write_text(json.dumps(t))
    b = spec()
    b["configs"].append({"name": "added", "source": "x", "reduced": [],
                         "file": "vtbench/configs/added.json", "why": "x"})
    b["workloads"].append({"name": "added-cell", "config": "added", "traffic": "added",
                           "chips": 1, "why": "x"})
    lat = next(m for m in b["end_to_end"] if m["name"] == "latency_p95_ms")
    lat["workloads"].append("added-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path / "BENCHMARK.json", bench


def test_a_configuration_with_its_own_reference_module_runs(tmp_path):
    """A configuration naming a reference module added as a file runs
    through ``run_cell``: the module's own number is the one compared, and
    no file that was there is edited."""
    benchmark, bench = add_cell(tmp_path, ABS_MODULE, "t17-latency", {"z_abs": 1e-3})
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cell = harness.load_cell("added-cell", benchmark, bench)
    assert cell.reference.__file__ == str(bench / "reference" / "added.py")
    r = harness.run_cell(cell, 2**40 + 7, 0.3, False, "cpu")
    assert set(r["checks"]) == {"z_abs"} and r["correct"], r["checks"]
    assert 0.0 < r["checks"]["z_abs"]["value"] < 1e-3
    assert {p: p.read_bytes() for p in before} == before


# A module of the contract for VidTwin, which runs no port kernel, written
# for the test below alone: its answers are the port's own, in float32 on the
# CPU, so it tests the plumbing and is no reference (BENCHMARK.json names it
# nowhere; a reference module imports nothing of the program)
VIDTWIN_MODULE = '''"""VidTwin through the port in float32: the contract's plumbing only."""

import copy
from collections import Counter
from types import SimpleNamespace

import torch

from vtbench.reference import weights as W
from vtbench.reference.compare import output_rel_l2

import vidtok_tpu_torch
from vidtok_tpu_torch.models.vidtwin.vidtwin_ae import build_vidtwin_from_config


def read_config(config):
    enc = config["model"]["params"]["encoder_config"]["params"]
    return SimpleNamespace(config=config, hidden=enc["hidden_size"],
                           patch=tuple(enc["patch_size"]))


PROGRAM_OPTIONS = {}
NORMAL = {"scale_shift_table": (0.0, 0.1), "query_embeds": (0.0, 0.1),
          "LayerNorm.weight": (1.0, 0.1), "LayerNorm.bias": (0.0, 0.1),
          "layernorm.weight": (1.0, 0.1), "layernorm.bias": (0.0, 0.1)}


def weights(spec, seed, device):
    model, _ = build_vidtwin_from_config(spec.config["model"])
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return W.state_dict(shapes, seed, device, NORMAL)


def load(tok, params, traffic):
    tok.model.load_state_dict(params, strict=True)


def shapes(spec, traffic, frames):
    b, c, _, h, w = traffic["clip"]
    pt, ph, pw = spec.patch
    return [(b, spec.hidden, frames // pt, h // ph, w // pw), (b, c, frames, h, w)]


NUMBERS = {"z_rel": output_rel_l2(0), "rec_rel": output_rel_l2(1)}


def context(params, spec, quant):
    if quant != "none":
        raise ValueError("the port in float32 has no control")
    device = next(iter(params.values())).device
    tok = vidtok_tpu_torch.load_model_from_config(spec.config, device=device,
                                                  compute_dtype=torch.float32)
    tok.model.load_state_dict(params, strict=True)
    return tok


ENTRIES = {"forward": lambda tok, x, traffic, state: (tuple(tok(x)[:2]), None)}


def kernel_calls(spec, traffic, shape, first):
    return Counter()


def model_flops(spec, traffic, shape, first):
    raise NotImplementedError("not counted: the plumbing test traces nothing")


def _answer_altered(tok):
    forward = tok.model.forward

    def altered(*a, **k):
        z, rec, log, latents = forward(*a, **k)
        z = z.clone()
        z[:, :, -1] = -z[:, :, -1]
        return z, rec, log, latents

    tok.model.forward = altered


def faults(traffic):
    return {"answer": _answer_altered}


def tiny(config):
    cfg = copy.deepcopy(config)
    p = cfg["model"]["params"]
    for k in ("encoder_config", "decoder_config"):
        d = p[k]["params"]
        d.update(hidden_size=64, depth=2, num_heads=4, input_size=[d["input_size"][0], 32, 32])
    p["temporal_qformer_config"]["params"]["encoder_hidden_size"] = 64
    return cfg
'''

VIDTWIN_YAML = CHECKOUT / "configs" / "vidtwin" / "vidtwin_structure_7_7_8_dynamics_7_8.yaml"


def test_a_model_that_runs_no_port_kernel_enters_by_new_files(tmp_path):
    """VidTwin: a 16-frame clip at batch 32, a tokenizer that is no
    ``VideoTokenizer`` and runs no port kernel. Its configuration (the
    shipped model section, cut by its module's ``tiny``), its traffic at
    full size (cut by ``tiny_traffic``), its module and its cell are new
    files and entries of the tiny bench; the cell runs through ``run_cell``
    and reads ``correct``, and no file that was there changes. The answer
    fault makes it incorrect."""
    from vidtok_tpu_torch import load_config
    from vtbench_tiny import tiny_traffic

    bench = make(tmp_path / "vtbench")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "reference" / "vidtwin_port.py").write_text(VIDTWIN_MODULE)
    module = harness.load_reference(bench, "vidtwin_port")
    config = module.tiny({"source": "x", "reference": "vidtwin_port",
                          "model": load_config(str(VIDTWIN_YAML))["model"]})
    (bench / "configs" / "vidtwin_tiny.json").write_text(json.dumps(config))
    traffic = tiny_traffic({"entry": "forward", "loop": "pipelined", "depth": 2,
                            "clip": [32, 3, 16, 224, 224], "compute_dtype": "bfloat16",
                            "pool": 4, "warmup": 2, "trace_seconds": 3,
                            "check": {"sample": 1, "within": 6, "last": False,
                                      "limits": {"z_rel": 1e-6, "rec_rel": 1e-6}}})
    assert traffic["clip"] == [4, 3, 16, 32, 32] and traffic["compute_dtype"] == "float32"
    (bench / "traffic" / "t16-pipelined.json").write_text(json.dumps(traffic))
    b = spec()
    b["configs"].append({"name": "vidtwin_tiny", "source": "x", "reduced": [],
                         "file": "vtbench/configs/vidtwin_tiny.json", "why": "x"})
    b["workloads"].append({"name": "vidtwin-t16-pipelined", "config": "vidtwin_tiny",
                           "traffic": "t16-pipelined", "chips": 1, "why": "x"})
    fps = next(m for m in b["end_to_end"] if m["name"] == "frames_per_s")
    fps["workloads"].append("vidtwin-t16-pipelined")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.load_cell("vidtwin-t16-pipelined", tmp_path / "BENCHMARK.json", bench)
    # a seed whose sampled request is the window's first, which a window
    # reaches however slowly a loaded CPU runs
    seed = 2**40 + 10
    assert harness.sample_indices(seed, cell.traffic["check"]) == {0}
    r = harness.run_cell(cell, seed, 0.3, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == {"z_rel", "rec_rel"}
    frames = r["metrics"]["frames_per_s"]["value"] * r["info"]["window_s"]
    assert frames == pytest.approx(4 * 16 * r["attempted"])
    assert r["info"]["launches_frozen"] == {} and r["info"]["launches"] == {}
    assert {p: p.read_bytes() for p in before} == before
    fault = module.faults(cell.traffic)["answer"]
    r = harness.run_cell(cell, seed, 0.3, False, "cpu", fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("case",["no_reference", "no_entry", "no_contract_name",
                                  "unknown_number"])
def test_load_cell_refuses_before_set_up(tmp_path, case):
    """A configuration that names no module, a module without the answer
    the traffic's entry needs or without a name of the contract, and limits
    on a number the module does not give are refused when the cell loads."""
    module, limits, keys = ABS_MODULE, {"z_abs": 1e-3}, None
    if case == "no_reference":
        keys = {"reference": None}
    elif case == "no_entry":
        module += 'ENTRIES = {k: v for k, v in ENTRIES.items() if k != "encode_chunk"}\n'
    elif case == "no_contract_name":
        module += "del faults\n"
    else:
        limits = {"z_abs": 1e-3, "rec_rel": 0.1}
    benchmark, bench = add_cell(tmp_path, module, "stream16-latency", limits, keys)
    with pytest.raises(ValueError, match={"no_reference": "names no reference",
                                          "no_entry": "encode_chunk",
                                          "no_contract_name": "lacks",
                                          "unknown_number": "gives no"}[case]):
        harness.load_cell("added-cell", benchmark, bench)


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
