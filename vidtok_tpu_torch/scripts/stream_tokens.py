"""Streaming tokenization: push a video through the causal (v1.1) encoder
one chunk at a time, memory flat in the video's length, and report each
chunk's latency; the port of ``scripts/stream_tokens.py``, with the same
flags and printed lines.

  python -m vidtok_tpu_torch.scripts.stream_tokens --config configs/v1_1/... \
      [--ckpt ...] --input_video_path video.mp4 [--chunk_size 16]
      [--out tokens.npz] [--bf16] [--device cpu]

Each chunk is one ``VideoTokenizer.encode_chunk`` step (:func:`stream_encode`),
whose cache is the only state carried. ``--out`` writes z (NCTHW) as f32
whatever the compute dtype: the JAX script writes bf16 z as numpy's raw
2-byte void, which only ``ml_dtypes`` reads back.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..data.transforms import transform_u8
from ..data.video_reader import read_frames_u8, video_info
from .common import add_port_args, frame_ids, load_tokenizer, set_tiling, sync


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--input_video_path", required=True)
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=256)
    p.add_argument("--sample_fps", type=int, default=30)
    p.add_argument("--chunk_size", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--bf16", action="store_true")
    add_port_args(p)
    return p


def stream_encode(tok, read_chunk: Callable, n_frames: int) -> Iterator[tuple]:
    """Encode ``n_frames`` frames chunk by chunk over the tokenizer's
    schedule (``build_chunk_start_end``: frame 0, then ``t_chunk_enc``
    frames). ``read_chunk(s, e)`` gives frames ``s:e`` as [t,H,W,3] in
    [-1, 1] on the device. Yields (i, s, e, z, reg_log, read seconds,
    encode seconds) per chunk, z f32 [B,Cz,t',H',W'] on the host."""
    cache = None
    for i, (s, e) in enumerate(tok.build_chunk_start_end(n_frames)):
        t0 = time.perf_counter()
        x = read_chunk(s, e)
        sync(x.device)
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        z, log, cache = tok.encode_chunk(x[None].permute(0, 4, 1, 2, 3), cache)
        z = z.cpu()
        yield i, s, e, z, log, t_read, time.perf_counter() - t0


def main(argv=None):
    args = get_parser().parse_args(argv)
    tok = load_tokenizer(args)
    if tok.meta.get("variant") != "causal_v1_1":
        raise SystemExit("streaming tokenization requires a v1.1 model")
    set_tiling(tok, args.chunk_size)

    total, fps = video_info(args.input_video_path)
    ids = frame_ids(total, fps, args.sample_fps, args.chunk_size, True, True)
    print(f"streaming {len(ids)} frames in chunks of {args.chunk_size} "
          f"(+1 causal anchor frame)")

    def read_chunk(s, e):
        return transform_u8(read_frames_u8(args.input_video_path, ids[s:e]),
                            args.input_height, args.input_width, args.device)

    zs = []
    for i, s, e, z, log, t_read, t_enc in stream_encode(tok, read_chunk, len(ids)):
        zs.append(z)
        extra = f" tokens={log['indices'].numel()}" if tok.discrete else ""
        # the shape as the JAX script prints it: channels-last
        print(f"chunk {i:3d} [{s:4d}:{e:4d}]: read {t_read*1e3:6.1f} ms  "
              f"encode {t_enc*1e3:7.1f} ms  z{tuple(z.permute(0, 2, 3, 4, 1).shape)}"
              f"{extra}")

    z_all = torch.cat(zs, dim=2).numpy()  # [B, Cz, T', H', W']
    print(f"total latents (NCTHW): {z_all.shape}")
    if args.out:
        np.savez(args.out, z=z_all)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
