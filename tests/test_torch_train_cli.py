"""The port's train CLI, ``python -m vidtok_tpu_torch.scripts.train
--device cpu``, in a subprocess on the tiny KL model and two written
clips: 2 steps with image logs, a checkpoint and a validation (training
weights and EMA; a monitor checkpoint), then ``--resume`` to step 3 from
the newest checkpoint. The JSONL holds steps 1-3 and both validations;
the resumed run starts at step 2; the checkpoints directory keeps step 2
and 3 and the monitor ledger.
"""

import json
import os
import subprocess
import sys

import numpy as np
import yaml

from tests.test_torch_train_common import config, lpips_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(data_dir):
    cfg = config("kl", "2d")
    cfg["model"]["params"]["monitor"] = "val/rec_loss"
    vp = {"input_height": 32, "input_width": 32, "sample_num_frames": 5, "sample_fps": 30}
    meta = str(data_dir / "meta.csv")
    cfg["data"] = {"target": "DataModuleFromConfig", "params": {
        "batch_size": 2, "num_workers": 2,
        "train": {"target": "VidTokDataset", "params": {
            "data_dir": str(data_dir), "meta_path": meta, "video_params": vp}},
        "validation": {"target": "VidTokValDataset", "params": {
            "data_dir": str(data_dir), "meta_path": meta, "video_params": vp}}}}
    cfg["training"].update(max_steps=2, val_check_interval=2, checkpoint_every=2,
                           log_images_every=2, log_every=1)
    return cfg


def _run(*args):
    r = subprocess.run([sys.executable, "-m", "vidtok_tpu_torch.scripts.train", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_train_cli_and_resume(tmp_path):
    from vidtok_tpu_torch.data.video_reader import write_video

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    for name in ("a.mp4", "b.mp4"):
        write_video(str(data / name), (rng.rand(12, 32, 32, 3) * 255).astype(np.uint8), fps=30)
    (data / "meta.csv").write_text("videos\na.mp4\nb.mp4\n")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg(data)))
    lp = lpips_npz(tmp_path / "lpips.npz")
    common = ["-b", str(cfg_path), "-l", str(tmp_path / "logs"), "-n", "tiny",
              "--device", "cpu", "--lpips_weights", lp]
    out = _run(*common)
    assert "start step 0" in out and "[val] step 2" in out and "[val_ema] step 2" in out
    out = _run(*common, "--resume", "--max_steps", "3")
    assert "start step 2" in out
    (run,) = os.listdir(tmp_path / "logs")
    rundir = tmp_path / "logs" / run
    rows = [json.loads(line) for line in open(rundir / "metrics.jsonl")]
    train = [r["step"] for r in rows if "train/aeloss" in r]
    assert train == [1, 2, 3]
    val = [r for r in rows if "val/psnr" in r or "val_ema/psnr" in r]
    assert len(val) == 2 and all(np.isfinite(v) for r in val for v in r.values())
    assert all(np.isfinite(r["train/aeloss"]) for r in rows if "train/aeloss" in r)
    ckpts = sorted(os.listdir(rundir / "checkpoints"))
    assert ckpts == ["monitor.json", "step_00000002.pt", "step_00000003.pt"]
    assert sorted(os.listdir(rundir / "images")) == ["train_gs00000002_b0.gif",
                                                     "train_gs00000002_b0.png",
                                                     "train_gs00000002_b1.gif",
                                                     "train_gs00000002_b1.png"]
