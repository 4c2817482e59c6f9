"""A copy of the benchmark's data at a size the CPU tests can run: every
configuration in its reference module's tiny form (``tiny``), 32x32
frames, short clips and chunks, the benchmark's reference modules, metric
readers and kernel names as they are.

A traffic's clip ``[B, 3, T, H, W]`` becomes ``[min(B, 4), 3, T', 32, 32]``:
T' is 33 for 201 and 193 frames and 17 for 17 (``FRAMES``), and any other
T is kept, since a model may take only its own clip length (VidTwin's 16
frames, a non-causal model's multiple of 4). A batch over 4 becomes 4, so
a fault on half of a batch still shows. A module's ``tiny(config)`` gives
the configuration that takes such clips (VidTwin: ``input_size``
``[16, 32, 32]``)."""

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
    t["clip"][0] = min(t["clip"][0], 4)
    t["clip"][2] = FRAMES.get(t["clip"][2], t["clip"][2])
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
