"""VidTwin reconstruction and cross-reenactment: the port of
``scripts/vidtwin_reconstruct.py`` (reference vidtwin/scripts/
inference_reconstruct.py and inference_vidtwin_cross_reconstruct.py), with
the same flags and printed line.

  python -m vidtok_tpu_torch.scripts.vidtwin_reconstruct \
      --config configs/vidtwin/vidtwin_structure_7_7_8_dynamics_7_8.yaml \
      --ckpt model.ckpt --input_video_path a.mp4 [--device cpu]
      [--dynamics_video_path b.mp4]   # structure of a, dynamics of b

The model's first T frames at ``--sample_fps`` (the last one repeated to T)
are transformed on ``--device``; :func:`reconstruct` writes input |
reconstruction side by side as ``<name>_recon.mp4`` (``<name>_cross.mp4``
with a dynamics video).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data.transforms import transform_u8
from ..data.video_reader import read_frames_u8, video_info, write_video
from ..models.vidtwin.engine import VidTwinTokenizer
from .common import add_port_args


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--input_video_path", required=True)
    p.add_argument("--dynamics_video_path", default=None)
    p.add_argument("--sample_fps", type=int, default=8)
    p.add_argument("--output_video_dir", default="outputs")
    add_port_args(p)
    return p


def load_clip(path: str, tok: VidTwinTokenizer, sample_fps: int):
    """Every ``round(fps / sample_fps)``-th frame of ``path``, the first T,
    the last repeated up to T -> [1, 3, T, H, W] in [-1, 1] on the
    tokenizer's device."""
    t, h, w = tok.input_size
    total, fps = video_info(path)
    ids = list(range(0, total, max(1, round(fps / sample_fps))))[:t]
    frames = transform_u8(read_frames_u8(path, ids), h, w, tok.device)
    if frames.shape[0] < t:
        frames = torch.cat([frames, frames[-1:].expand(t - frames.shape[0], -1, -1, -1)])
    return frames[None].permute(0, 4, 1, 2, 3)


def _to_u8(a):
    return ((a.clamp(-1, 1) + 1) * 127.5).to(torch.uint8)


@torch.no_grad()
def reconstruct(tok: VidTwinTokenizer, xa, xb=None):
    """uint8 [T, H, 2W, 3] on the device: ``xa`` beside its reconstruction,
    or, given ``xb``, beside the structure of ``xa`` decoded with the
    dynamics of ``xb``."""
    xrec = tok.cross_reenact(xa, xb) if xb is not None else tok(xa)[1]
    a, r = (_to_u8(v)[0].permute(1, 2, 3, 0) for v in (xa, xrec))
    return torch.cat([a, r], dim=2)


def main(argv=None):
    args = get_parser().parse_args(argv)
    tok = VidTwinTokenizer.from_config(args.config, ckpt=args.ckpt, device=args.device,
                                       full_pickle=args.full_pickle)
    xa = load_clip(args.input_video_path, tok, args.sample_fps)
    xb = (load_clip(args.dynamics_video_path, tok, args.sample_fps)
          if args.dynamics_video_path else None)
    side = reconstruct(tok, xa, xb)
    os.makedirs(args.output_video_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.input_video_path))[0]
    out = os.path.join(args.output_video_dir, f"{name}_{'cross' if xb is not None else 'recon'}.mp4")
    write_video(out, side.cpu().numpy(), fps=args.sample_fps)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
