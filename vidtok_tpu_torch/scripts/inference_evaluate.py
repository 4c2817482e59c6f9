"""Evaluate reconstruction quality (PSNR, SSIM, LPIPS) over a directory of
videos: the port of ``scripts/inference_evaluate.py`` (reference
scripts/inference_evaluate.py), with the same flags and printed lines.

  python -m vidtok_tpu_torch.scripts.inference_evaluate --config configs/... \
      --ckpt model.ckpt --data_dir /path/to/videos [--bf16] [--device cpu]
      [--input_height 256 --input_width 256] [--sample_fps 30 --num_frames 17]
      [--read_long_video --chunk_size 16] [--lpips_weights vgg_lpips.npz]

Frames are decoded on the host and transformed on ``--device``; each window
goes through the tokenizer and is scored in 16-frame splits
(:func:`evaluate_window`). Without LPIPS weights (JAX's converted ``.npz``,
default ``checkpoints/lpips/vgg_lpips.npz``) LPIPS is skipped.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import VidTokValDataset
from ..modules.lpips import LPIPS, load_lpips_params
from ..ops.metrics import compute_psnr, compute_ssim
from .common import Clock, add_port_args, load_tokenizer, set_tiling

SPLIT = 16  # frames scored together (reference inference_evaluate.py:183-186)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--meta_path", type=str, default=None)
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=256)
    p.add_argument("--sample_fps", type=int, default=30)
    p.add_argument("--num_frames", type=int, default=None,
                   help="default: 17 causal / 16 non-causal")
    p.add_argument("--read_long_video", action="store_true")
    p.add_argument("--chunk_size", type=int, default=16)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--bf16", action="store_true")
    add_port_args(p)
    return p


def load_lpips(path: Optional[str], device) -> Optional[LPIPS]:
    """LPIPS with the converted weights at ``path`` (the default path when
    None) on ``device``, or None when the file is absent."""
    sd = load_lpips_params(path) if path else load_lpips_params()
    if sd is None:
        return None
    lpips = LPIPS()
    lpips.load_state_dict(sd)
    return lpips.to(device).eval()


def splits(t: int) -> List[Tuple[int, int]]:
    """The frame ranges scored together: 16 frames, the last one shorter (a
    causal 17-frame window ends in a 1-frame split)."""
    return [(s, min(t, s + SPLIT)) for s in range(0, t, SPLIT)]


@torch.no_grad()
def evaluate_window(tok, frames, lpips: Optional[LPIPS] = None,
                    clock: Optional[Clock] = None) -> List[tuple]:
    """One window: ``frames`` [T,H,W,3] in [-1, 1] on the tokenizer's
    device -> (psnr, ssim, lpips or None) for each split. ``clock`` times
    the tokenizer, the PSNR and SSIM, and LPIPS apart."""
    x = frames[None].permute(0, 4, 1, 2, 3)
    _, xrec, _ = tok(x)
    a = (x + 1) / 2
    b = (xrec.clamp(-1, 1) + 1) / 2
    if clock:
        clock.lap("tokenizer")
    out = []
    for s, e in splits(a.shape[2]):
        av, bv = a[:, :, s:e], b[:, :, s:e]
        psnr, ssim = float(compute_psnr(av, bv)), float(compute_ssim(av, bv))
        if clock:
            clock.lap("psnr_ssim")
        lp = None
        if lpips is not None:
            # [B, C, t, H, W] -> B*t images [C, H, W]
            af, bf = (v.transpose(1, 2).flatten(0, 1) for v in (av, bv))
            lp = float(lpips(af * 2 - 1, bf * 2 - 1).mean())
            if clock:
                clock.lap("lpips")
        out.append((psnr, ssim, lp))
    return out


def main(argv=None):
    args = get_parser().parse_args(argv)
    tok = load_tokenizer(args)
    num_frames = args.num_frames or (17 if tok.is_causal else 16)
    if args.read_long_video:
        set_tiling(tok, args.chunk_size)

    ds = VidTokValDataset(
        data_dir=args.data_dir, meta_path=args.meta_path,
        video_params=dict(input_height=args.input_height,
                          input_width=args.input_width,
                          sample_num_frames=num_frames,
                          sample_fps=args.sample_fps),
        pre_load_frames=False, read_long_video=args.read_long_video,
        chunk_size=args.chunk_size, is_causal=tok.is_causal, device=args.device)
    lpips = load_lpips(args.lpips_weights, args.device)

    psnrs, ssims, lpipss = [], [], []
    for i in range(len(ds)):
        item = ds[i]
        for psnr, ssim, lp in evaluate_window(tok, item["jpg"], lpips):
            psnrs.append(psnr)
            ssims.append(ssim)
            if lp is not None:
                lpipss.append(lp)
        print(f"[{i+1}/{len(ds)}] {os.path.basename(item['path'])}  "
              f"psnr={psnrs[-1]:.2f} ssim={ssims[-1]:.4f}")

    print(f"\nmean PSNR: {np.mean(psnrs):.4f}")
    print(f"mean SSIM: {np.mean(ssims):.4f}")
    if lpipss:
        print(f"mean LPIPS: {np.mean(lpipss):.4f}")
    else:
        print("LPIPS: skipped (no converted weights; see tools/convert_lpips.py)")


if __name__ == "__main__":
    main()
