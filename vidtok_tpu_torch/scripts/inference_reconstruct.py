"""Reconstruct a video through a tokenizer and write input | reconstruction
side by side: the port of ``scripts/inference_reconstruct.py`` (reference
scripts/inference_reconstruct.py), with the same flags and printed lines.

  python -m vidtok_tpu_torch.scripts.inference_reconstruct --config configs/... \
      --ckpt model.ckpt --input_video_path video.mp4 [--bf16] [--device cpu]
      [--input_height 256 --input_width 256 --sample_fps 30]
      [--chunk_size 16] [--read_long_video] [--pad_gen_frames]

The frames are decoded on the host and transformed on ``--device``;
:func:`reconstruct` runs the tokenizer and builds the side-by-side frames
there; the mp4 is written with OpenCV.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..data.transforms import transform_u8
from ..data.video_reader import read_frames_u8, video_info, write_video
from .common import add_port_args, frame_ids, load_tokenizer, set_tiling, sync


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--input_video_path", type=str, required=True)
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=256)
    p.add_argument("--sample_fps", type=int, default=30)
    p.add_argument("--chunk_size", type=int, default=16,
                   help="frames per inference batch (+1 if causal)")
    p.add_argument("--read_long_video", action="store_true",
                   help="tiled streaming inference over the whole video")
    p.add_argument("--pad_gen_frames", action="store_true",
                   help="feed last generated frames back as context")
    p.add_argument("--output_video_dir", type=str, default="outputs")
    p.add_argument("--bf16", action="store_true")
    add_port_args(p)
    return p


def _to_u8(a):
    return ((a.clamp(-1, 1) + 1) * 127.5).to(torch.uint8)


@torch.no_grad()
def reconstruct(tok, frames, chunk_size: int, read_long_video: bool = False,
                pad_gen_frames: bool = False):
    """``frames`` [N,H,W,3] in [-1, 1] on the tokenizer's device (every
    sampled frame) -> uint8 [T,H,2W,3], input | reconstruction, on the
    device. With ``read_long_video`` the tokenizer (tiled) takes all N
    frames at once; otherwise batches of ``chunk_size`` frames (+1 when
    causal), a short last batch dropped. ``pad_gen_frames`` (causal, not
    long): each batch after the first is preceded by the last ``tdf - 1``
    reconstructed frames of the one before, and only its own frames are
    kept (reference inference_reconstruct.py:213-219)."""
    tdf = tok.time_downsample_factor
    n = frames.shape[0]
    if read_long_video:
        batches = [(0, n)]
    else:
        n_per = chunk_size + (1 if tok.is_causal else 0)
        batches = [(i, i + n_per) for i in range(0, n - n_per + 1, n_per)]
    pad_gen = pad_gen_frames and tok.is_causal and not read_long_video
    ins, outs, prev_gen = [], [], None
    for s, e in batches:
        x = frames[s:e]
        model_in = torch.cat([prev_gen, x]) if pad_gen and prev_gen is not None else x
        _, xrec, _ = tok(model_in[None].permute(0, 4, 1, 2, 3))
        xrec = xrec[0].permute(1, 2, 3, 0).clamp(-1, 1)[-x.shape[0]:]
        if pad_gen:
            prev_gen = xrec[xrec.shape[0] - (tdf - 1):]
        ins.append(x)
        outs.append(xrec)
    return torch.cat([_to_u8(torch.cat(ins)), _to_u8(torch.cat(outs))], dim=2)


def main(argv=None):
    args = get_parser().parse_args(argv)
    tok = load_tokenizer(args)
    tdf = tok.time_downsample_factor
    if args.chunk_size % tdf:
        raise ValueError(f"chunk_size must be divisible by time_downsample_factor {tdf}")

    total, fps = video_info(args.input_video_path)
    ids = frame_ids(total, fps, args.sample_fps, args.chunk_size, tok.is_causal,
                    args.read_long_video)
    if args.read_long_video:
        set_tiling(tok, args.chunk_size)
    frames = transform_u8(read_frames_u8(args.input_video_path, ids),
                          args.input_height, args.input_width, args.device)

    tic = time.time()
    side = reconstruct(tok, frames, args.chunk_size, args.read_long_video,
                       args.pad_gen_frames)
    sync(args.device)
    print(f"inference time: {time.time() - tic:.2f}s for {side.shape[0]} frames")

    os.makedirs(args.output_video_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.input_video_path))[0]
    out_path = os.path.join(args.output_video_dir, f"{name}_recon.mp4")
    write_video(out_path, side.cpu().numpy(), fps=args.sample_fps)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
