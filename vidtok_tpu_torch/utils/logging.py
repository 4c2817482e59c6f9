"""Run logs (``vidtok_tpu/utils/logging.py``): scalars to JSONL always, to
TensorBoard and wandb where those packages import; input and
reconstruction grids (PNG) and side-by-side GIFs through ``imageio`` where
it imports (reference vidtok/modules/logger.py)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True,
                 wandb_project: Optional[str] = None,
                 wandb_run_id: Optional[str] = None):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._tb = self._wandb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, dir=logdir,
                                         id=wandb_run_id,
                                         resume="allow" if wandb_run_id else None)
            except Exception:
                self._wandb = None
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    @property
    def wandb_run_id(self) -> Optional[str]:
        """The wandb run's id, which the train CLI keeps so that a resumed
        run re-attaches to it."""
        return getattr(self._wandb, "id", None) if self._wandb else None

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        self._jsonl.close()


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> uint8."""
    return ((np.clip(x, -1, 1) + 1) * 127.5).astype(np.uint8)


def frame_grid(video: np.ndarray, n_cols: int = 8) -> np.ndarray:
    """``[T, H, W, C]`` -> one image of the frames in rows of ``n_cols``."""
    t, h, w, c = video.shape
    n_cols = min(n_cols, t)
    n_rows = -(-t // n_cols)
    grid = np.zeros((n_rows * h, n_cols * w, c), video.dtype)
    for i in range(t):
        r, col = divmod(i, n_cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = video[i]
    return grid


class ImageVideoLogger:
    """Input/reconstruction PNG grids and side-by-side GIFs every
    ``batch_frequency`` steps (and at 1, 2, 4, ... with
    ``increase_log_steps``)."""

    def __init__(self, logdir: str, batch_frequency: int = 5000, max_samples: int = 2,
                 disabled: bool = False, increase_log_steps: bool = False,
                 log_first_step: bool = False, **_):
        self.dir = os.path.join(logdir, "images")
        os.makedirs(self.dir, exist_ok=True)
        self.freq = batch_frequency
        self.max_samples = max_samples
        self.disabled = disabled
        self.log_first_step = log_first_step
        self.steps = set()
        if increase_log_steps:
            s = 1
            while s < batch_frequency:
                self.steps.add(s)
                s *= 2

    def should_log(self, step: int) -> bool:
        if self.disabled:
            return False
        if step == 0:
            return self.log_first_step
        return step % self.freq == 0 or step in self.steps

    def log(self, step: int, inputs: np.ndarray, recons: np.ndarray,
            split: str = "train") -> None:
        """inputs, recons: ``[B, T, H, W, C]`` in [-1, 1]. Writes nothing,
        once with a notice, where ``imageio`` does not import."""
        if self.disabled:
            return
        try:
            import imageio
        except ImportError:
            print("[logger] imageio is not installed: no image logs")
            self.disabled = True
            return
        for b in range(min(self.max_samples, inputs.shape[0])):
            xin, xrec = to_uint8(inputs[b]), to_uint8(recons[b])
            name = os.path.join(self.dir, f"{split}_gs{step:08d}_b{b}")
            imageio.imwrite(name + ".png",
                            np.concatenate([frame_grid(xin), frame_grid(xrec)], axis=0))
            imageio.mimsave(name + ".gif", list(np.concatenate([xin, xrec], axis=2)),
                            duration=0.125)
