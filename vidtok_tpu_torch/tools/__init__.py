"""Card microbenchmarks: the port's counterparts of the JAX package's
``tools/microbench_temporal.py`` and ``tools/probe_silu_bf16.py``, with
their Pallas kernels (T1-T4) hand-written for Hopper.

    python -m vidtok_tpu_torch.tools.microbench_temporal [C T S] [--device cpu]
    python -m vidtok_tpu_torch.tools.probe_silu_bf16 [N H W] [--device cpu]

Both run on the card unless ``--device cpu`` is given, and raise without a
card. This module holds what they share: the arguments, the timer and the
bound of a row.
"""

from __future__ import annotations

import statistics
import time

# one H100 SXM at 700 W (NVIDIA's data sheet): dense bf16 tensor-core rate,
# f32 rate outside the tensor cores, HBM rate
PEAK_MMA_FLOPS = 989e12
PEAK_VEC_FLOPS = 67e12
PEAK_BYTES = 3.35e12
L2_FLUSH_BYTES = 1 << 30  # 20x the H100's 50 MB L2


def parse_args(argv, defaults: tuple) -> tuple:
    """``[n ...] [--device cpu|cuda]`` -> (ints, with ``defaults`` for
    those not given, and the torch device)."""
    import torch

    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 == len(argv):
            raise ValueError("--device needs a value: cpu or cuda")
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) > len(defaults):
        raise ValueError(f"at most {len(defaults)} sizes, got {argv}")
    sizes = tuple(int(a) for a in argv) + tuple(defaults[len(argv):])
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain "
                           "versions on the CPU")
    return sizes, device


def bound_ms(nbytes: float, mma_flops: float = 0.0, vec_flops: float = 0.0) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the FLOP over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (mma_flops / PEAK_MMA_FLOPS + vec_flops / PEAK_VEC_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Time of one call of ``fn`` in ms. On the card: the median over
    ``iters`` calls after a warm-up, each between two CUDA events, with the
    L2 cache flushed before each (a 1 GiB write), so every call reads its
    inputs from HBM. The flush also keeps the card busy for about 0.3 ms
    while the host enqueues the call, so the host's launch latency does not
    fall between the events. On the CPU: the host clock, one call, no
    warm-up."""

    def __init__(self, device):
        import torch

        self.device = device
        self.flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
                      if device.type == "cuda" else None)

    def __call__(self, fn, iters: int = 20, warmup: int = 2) -> float:
        import torch

        if self.flush is None:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def report(name: str, ms: float, bound: tuple, device, rate: str = "") -> dict:
    """Print one row: time, rate, bound and the share of the bound reached
    (on the card; a CPU row is the plain version's host time)."""
    b, by = bound
    if device.type == "cuda":
        print(f"{name:16s} {ms:9.4f} ms  {rate:>16s}  bound {b:.4g} ms ({by}), "
              f"{b / ms:6.1%} of it (median, L2 flushed)", flush=True)
    else:
        print(f"{name:16s} {ms:9.4f} ms host (cpu, plain version)  H100 bound "
              f"{b:.4g} ms ({by})", flush=True)
    return dict(name=name, ms=ms, bound_ms=b, bound_by=by)
