"""The H-sharded forward (``VideoTokenizer.forward_sharded``) over 1, 2 and
4 processes, one card each, against the one-process run.

    python3 -m vidtok_tpu_torch.tools.sharded_scaling [--size 256]
        [--frames 17] [--dtype float32] [--device cuda]

For each world W of WORLDS, W processes (``torch.multiprocessing``, a
``tcp://localhost`` rendezvous) form one group: NCCL with rank r on card
r, or gloo with ``--device cpu`` (a rehearsal on the CPU). Each builds the
v1.0 KL 16-channel flagship (``configs/vidtok_kl_causal_488_16chn.yaml``;
reading it needs PyYAML) with ``load_model_from_config``'s seeded weights
and runs ``forward_sharded`` on one seeded clip ``[1, 3, frames, size,
size]`` (f32 with TF32 off, the plain path; or ``--dtype bfloat16`` on
the card, where the nearest temporal upsample takes kernel E on each
slab): one warm-up, then ITERS timed runs, each on the host clock from a
barrier to a synchronize. The one process also times the tokenizer's own
forward (in bf16 on the card the whole kernel path). Prints the card's
name and power limit, then one JSON line per world: the median and every
wall time (rank 0's), rank 0's peak memory and kernel E's launches a run,
and z's and the reconstruction's relative L2 against the first world's.
W ranks need W cards.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WORLDS = (1, 2, 4)
ITERS = 3
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "vidtok_kl_causal_488_16chn.yaml")


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _rank_run(rank: int, world: int, port: int, args: dict, out: str) -> None:
    import torch.distributed as dist

    from vidtok_tpu_torch import load_model_from_config
    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.parallel.distributed import init_distributed
    from vidtok_tpu_torch.parallel.mesh import make_mesh

    cuda = args["device"] == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("nccl" if cuda else "gloo", f"tcp://localhost:{port}", world, rank,
                     device_index=rank if cuda else None)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    tok = load_model_from_config(CONFIG, seed=0, device=device,
                                 compute_dtype=getattr(torch, args["dtype"]))
    shape = (1, 3, args["frames"], args["size"], args["size"])
    x = np.clip(np.random.RandomState(0).randn(*shape) * 0.5, -1, 1).astype(np.float32)
    mesh = make_mesh()

    def run(fn):
        _barrier()
        t0 = time.perf_counter()
        res = fn()
        if cuda:
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(lambda: tok.forward_sharded(x, mesh))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    times = []
    for _ in range(ITERS):
        (z, dec, _), dt = run(lambda: tok.forward_sharded(x, mesh))
        times.append(dt)
    launches = K.counts()["parity_up2x_fused"] // ITERS
    peak = torch.cuda.max_memory_allocated() if cuda else None
    forward = [run(lambda: tok(x))[1] for _ in range(ITERS + 1)][1:] if world == 1 else None
    if rank == 0:
        torch.save({"z": z.cpu(), "dec": dec.cpu(), "times": times, "forward": forward,
                    "e_launches": launches, "peak": peak}, out)
    _barrier()
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--frames", type=int, default=17)
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        if torch.cuda.device_count() < max(WORLDS):
            raise RuntimeError(f"{max(WORLDS)} ranks need {max(WORLDS)} cards; "
                               f"{torch.cuda.device_count()} visible")
        from vidtok_tpu_torch.ops.kernels import _lib

        _lib.library()  # built once here, not by every rank
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    else:
        print("device cpu (gloo): host times, no device metric", flush=True)
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        for world in WORLDS:
            out = os.path.join(tmp, f"world{world}.pt")
            mp.spawn(_rank_run, args=(world, _free_port(), vars(args), out), nprocs=world,
                     join=True)
            got = torch.load(out, weights_only=True)
            first = first or got
            print(json.dumps({
                "world": world, "backend": "nccl" if args.device == "cuda" else "gloo",
                "clip": [1, 3, args.frames, args.size, args.size], "dtype": args.dtype,
                "wall_s_median": float(np.median(got["times"])), "wall_s": got["times"],
                "peak_mem_bytes_rank0": got["peak"], "e_launches": got["e_launches"],
                **({"one_process_forward_s": got["forward"]} if got["forward"] else {}),
                "z_rel_l2": _rel(got["z"], first["z"]),
                "reconstruction_rel_l2": _rel(got["dec"], first["dec"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
