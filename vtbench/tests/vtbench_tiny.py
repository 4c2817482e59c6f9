"""A copy of the benchmark's data at a size the CPU tests can run: every
configuration at ch 32 (the CPU tests' width; the published topology and
factors kept), 32x32 frames, short clips and chunks, the benchmark's
metric readers and kernel names as they are."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
SPEC = CHECKOUT / "BENCHMARK.json"
FRAMES = {201: 33, 17: 17, 193: 33}


def tiny_config(config: dict, ch: int = 32) -> dict:
    cfg = json.loads(json.dumps(config))
    for k in ("encoder_config", "decoder_config"):
        cfg["model"]["params"][k]["params"]["ch"] = ch
    return cfg


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
    tmp = Path(tmp)
    for d in ("metrics", "kernel_names"):
        shutil.copytree(BENCH / d, tmp / d)
    (tmp / "configs").mkdir()
    (tmp / "traffic").mkdir()
    for path in (BENCH / "configs").glob("*.json"):
        (tmp / "configs" / path.name).write_text(
            json.dumps(tiny_config(json.loads(path.read_text()))))
    for path in (BENCH / "traffic").glob("*.json"):
        (tmp / "traffic" / path.name).write_text(
            json.dumps(tiny_traffic(json.loads(path.read_text()), dtype)))
    return tmp
