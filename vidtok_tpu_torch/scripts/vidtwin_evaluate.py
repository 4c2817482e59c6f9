"""VidTwin evaluation, PSNR and SSIM over a directory of videos: the port
of ``scripts/vidtwin_evaluate.py`` (reference vidtwin/scripts/
inference_evaluate.py), with the same flags and printed lines.

  python -m vidtok_tpu_torch.scripts.vidtwin_evaluate \
      --config configs/vidtwin/vidtwin_structure_7_7_8_dynamics_7_8.yaml \
      --ckpt model.ckpt --data_dir /path/to/videos [--device cpu]

Each video gives one clip of the model's T frames at ``--sample_fps``
(``VidTokValDataset``, non-causal windows), transformed on ``--device``
and scored by :func:`evaluate_clip`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.dataset import VidTokValDataset
from ..models.vidtwin.engine import VidTwinTokenizer
from ..ops.metrics import compute_psnr, compute_ssim
from .common import add_port_args


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--meta_path", default=None)
    p.add_argument("--sample_fps", type=int, default=8)
    add_port_args(p)
    return p


@torch.no_grad()
def evaluate_clip(tok: VidTwinTokenizer, frames):
    """``frames`` [T, H, W, 3] in [-1, 1] on the tokenizer's device ->
    (PSNR, SSIM) of its reconstruction, on [0, 1]."""
    x = frames[None].permute(0, 4, 1, 2, 3)
    _, xrec, _ = tok(x)
    a = ((x + 1) / 2).clamp(0, 1)
    b = ((xrec + 1) / 2).clamp(0, 1)
    return float(compute_psnr(a, b)), float(compute_ssim(a, b))


def main(argv=None):
    args = get_parser().parse_args(argv)
    tok = VidTwinTokenizer.from_config(args.config, ckpt=args.ckpt, device=args.device,
                                       full_pickle=args.full_pickle)
    t, h, w = tok.input_size
    ds = VidTokValDataset(
        data_dir=args.data_dir, meta_path=args.meta_path,
        video_params=dict(input_height=h, input_width=w, sample_num_frames=t,
                          sample_fps=args.sample_fps),
        pre_load_frames=False, is_causal=False, device=args.device)
    psnrs, ssims = [], []
    for i in range(len(ds)):
        psnr, ssim = evaluate_clip(tok, ds[i]["jpg"])
        psnrs.append(psnr)
        ssims.append(ssim)
        print(f"[{i+1}/{len(ds)}] psnr={psnr:.2f} ssim={ssim:.4f}")
    print(f"\nmean PSNR: {np.mean(psnrs):.4f}\nmean SSIM: {np.mean(ssims):.4f}")


if __name__ == "__main__":
    main()
