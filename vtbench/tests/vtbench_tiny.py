"""A copy of the benchmark's data at a size the CPU tests can run: every
configuration in its reference module's tiny form (``tiny``), 32x32
frames, short clips and chunks, the benchmark's reference modules, metric
readers and kernel names as they are."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
SPEC = CHECKOUT / "BENCHMARK.json"
FRAMES = {201: 33, 17: 17, 193: 33}


def cells() -> list:
    """The names of the benchmark's cells."""
    return [w["name"] for w in json.loads(SPEC.read_text())["workloads"]]


def tiny_traffic(traffic: dict, dtype: str = "float32") -> dict:
    t = json.loads(json.dumps(traffic))
    t["clip"][2] = FRAMES[t["clip"][2]]
    t["clip"][3] = t["clip"][4] = 32
    t["compute_dtype"] = dtype
    t["warmup"] = 1
    t["trace_seconds"] = 0.5
    t["check"].update(sample=1, within=2)
    if "chunk_latents" in t["check"]:
        t["check"]["chunk_latents"] = 2
    if "chunk_frames" in t:
        t["chunk_frames"] = 8
    if "tiling" in t:
        t["tiling"]["t_chunk_enc"] = 8
    return t


def make(tmp: Path, dtype: str = "float32") -> Path:
    """A bench directory under ``tmp`` holding the tiny copy; returns it."""
    from vtbench import harness

    tmp = Path(tmp)
    for d in ("metrics", "kernel_names", "reference"):
        shutil.copytree(BENCH / d, tmp / d, ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "configs").mkdir()
    (tmp / "traffic").mkdir()
    for path in (BENCH / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        ref = harness.load_reference(BENCH, config["reference"])
        (tmp / "configs" / path.name).write_text(json.dumps(ref.tiny(config)))
    for path in (BENCH / "traffic").glob("*.json"):
        (tmp / "traffic" / path.name).write_text(
            json.dumps(tiny_traffic(json.loads(path.read_text()), dtype)))
    return tmp
