"""Phases 1 and 2 of the card gate: the kernels against their plain
versions.

1. build the sixteen hand-written kernels from ``vidtok_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source) and print the build time and the
   ``-Xptxas -v`` report (``build``);
2. hold every kernel against its plain PyTorch version at every shape the
   serving paths give it, in both stream-start modes where it has them
   (bf16 inputs and f32 parameters from a seed; the plain version in f32
   with TF32 off); gate relative L2 <= 1e-2, and no further from the f32 plain
   version than the plain version in bf16 is (x 1.1); time both (CUDA
   events) and, for A, B and F, cuDNN's convs of the block alone; compute
   each call's bound (bytes over 3.35 TB/s, FLOP over 989 TFLOP/s); and
   hold kernel E at bench.py's T=201 shape, whose output passes 2^31
   elements, kernel A at its T=201 call whose input does, and kernel D at
   its T=201 call (TAIL_LONG, runs of frames with warm-up) against their
   plain versions on a window of frames. A, F, B, E, D and D' also at
   frames whose sides are not multiples of their tiles (PARTIAL_SPATIAL,
   PARTIAL_TEMPORAL, PARTIAL_B, PARTIAL_PARITY, PARTIAL_TAIL: 33² to 264²,
   F at both ``first_chunk`` values and offsets 1 and 4, B, E, D and D' in
   both modes and with two clips), checked, not timed. Kernel F
   (the streaming temporal resblock) is held at every chunk shape of the
   tiled T=65 request, with ``first_chunk`` True and False at each of its
   cache offsets (0, 1, 2, 4), on y and both new caches; A, C and D also
   at their chunk shapes. The trilinear temporal upsample's blend at every
   call shape of the v1.1 paths (a later chunk's with its carried front
   sums and predecessor frame, on drawn base convs),
   also at two clips of 33² at C 200 and 37 (PARTIAL_LINEAR, checked, not
   timed). The kernels of
   the decoder's other forms
   (``KernelForms``): G and H at E's shapes, I at C's and D' at D's, the
   tiled chunk shapes included, in both stream-start modes where they have
   them; then the forms against each other per call and per v1.0 forward at
   the flagship's shapes, the convs included: E against one conv + H
   against two convs + G, four convs + C against one conv + I, D against D'
   (``compare_forms``); then the tools' kernels (``tool_kernels``); then the
   f32 forms
   of A-I and D' (the wgmma loop's f32 scheme in A, B, E and F, the
   tail's in D and D', the templates of C, G, H and I) against their plain
   versions in f32, TF32 off on both sides, at every call shape of phase
   19's requests (the forms' too), the other stream-start mode of B, E, G,
   H, D and D', F at both ``first_chunk`` values, one partial-tile shape
   each (F32_PARTIAL, 33²; F there at cache offsets 0, 1, 2 and 4, on y
   and both new caches) and A's, E's, D's and D''s T=201 calls; gate
   relative L2 <= F32_GATE (2e-5); each timed by CUDA events beside
   cuDNN's f32 convs of the block, its bound from ``f32_work`` (f32 bytes
   over 3.35 TB/s, or the function's FLOP over the bf16 tensor-core rate
   / 6, the scheme's six products); and A, B, F, D and D' on rows of mean
   F32_ROW_MEAN (the two-pass statistics; checked, not timed); then, in
   bf16 and in f32 (``width_cases``, checked, not timed), A, B, E, F, D
   and D' at every channel count of WIDTHS_CHECKED (8 to 1024: partial K
   steps and N tiles, masked row vectors, the tail's partial boxes and, past
   128 channels, its channel groups), A also at its shortcut pairs
   (SHORTCUT_PAIRS: 96 -> 192 among them), D and D' at TAIL_RUNS_WIDTH (256
   channels in runs with warm-up frames) and each at a 33² partial-tile
   shape at PARTIAL_WIDTH (96) channels; and, in bf16, every call shape
   of phase 20's models (WIDTH_PATHS, timed per forward of their paths).

Phase 2 also holds every call shape of phases 9-12 that the earlier
phases do not give (``model_calls``: A at 16² x 512 channels and at 256²
with 128 -> 256 channels, B at the 41616 and 444 shapes, F at the 888
chunks' shapes and offsets, C, and D on [2 cached | chunk] with
``t_chunk_dec`` 2), timed per forward of its path.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, NamedTuple

import numpy as np

from chip_smoke import (BF16_SLACK, CONFIG_PATHS, F32_GATE, F32_OFFSETS, F32_PARTIAL,
                        F32_PATHS, F32_ROW_MEAN, FORMS, KERNEL_GATE, MODE_PATH, PARITY_LONG,
                        PARITY_SHAPES, PARITY_WINDOW, PARTIAL_B, PARTIAL_LINEAR,
                        PARTIAL_OFFSETS, PARTIAL_PARITY, PARTIAL_SPATIAL, PARTIAL_TAIL,
                        PARTIAL_TEMPORAL, PATHS, SHARDED_WORLD, SPATIAL_LONG, SPATIAL_SHAPES,
                        SPATIAL_WINDOW, SUBPIXEL_SHAPES, TAIL_LONG, TAIL_SHAPES,
                        TEMPORAL_SHAPES, TILED_REQUEST, WIDTH_PATHS, f32_calls, f32_work,
                        form_swaps, model_calls, rel_l2, tiled_calls, work)

# the bound of a call: bytes over the HBM rate or FLOP over the peak rate
# of their type, of one H100 SXM at 700 W
from vidtok_tpu_torch.tools import bound_ms


def build() -> None:
    """Phase 1: the kernel library, built once for the process; its build
    time and each kernel's ``-Xptxas -v`` registers, shared memory and
    spills."""
    import time

    from vidtok_tpu_torch.ops.kernels import _lib

    t0 = time.perf_counter()
    lib = _lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {lib.build_seconds:.1f} s)"
          f" -> {lib.path.name}", flush=True)
    for line in lib.build_log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                or "spill" in line):
            print(line, flush=True)


def cuda_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Params:
    """Random parameters from one numpy seed and activations from a torch
    generator of the same seed (drawn on ``device``: the largest are 3e8
    values), on ``device``."""

    def __init__(self, seed: int, device):
        import torch

        self.rng = np.random.RandomState(seed)
        self.gen = torch.Generator(device).manual_seed(seed)
        self.device = device

    def t(self, a, dtype=None):
        import torch

        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device, dtype or torch.float32)

    def x(self, shape, dtype):
        import torch

        return torch.randn(shape, generator=self.gen, device=self.device).to(dtype)

    def norm(self, c):
        return (self.t(1.0 + 0.1 * self.rng.randn(c)),
                self.t(0.1 * self.rng.randn(c)))

    def conv(self, shape):
        bound = 1.0 / np.sqrt(np.prod(shape[1:]))
        return (self.t(self.rng.uniform(-bound, bound, shape)),
                self.t(self.rng.uniform(-bound, bound, shape[0])))


def f32(args):
    """Upcast every tensor in a nested tuple of call arguments."""
    import torch

    if isinstance(args, torch.Tensor):
        return args.float()
    if isinstance(args, tuple):
        return tuple(f32(a) for a in args)
    return args


class Case(NamedTuple):
    """One call shape of a kernel: its wrapper and plain version on the
    same arguments, the calls per forward of each path, the work of the
    call, and cuDNN's convs of the block alone (A, B, F) as a yardstick."""
    name: str
    key: tuple
    calls: dict
    kernel: Callable
    plain: Callable
    args: tuple
    convs: Callable = None
    mean: float = 0.0  # the rows' offset (F32_ROW_MEAN cases), else 0


def kernel_cases(device):
    """Yield a ``Case`` for every call shape of each kernel on the three
    paths (non-tiled v1.0 and v1.1 requests of REQUEST, the tiled v1.1
    request of TILED_REQUEST), with bf16 activations and f32 parameters on
    ``device``. Kernel F's shapes come from ``tiled_calls``, each with
    ``first_chunk`` True and False at its cache offset."""
    import torch
    import torch.nn.functional as F

    from vidtok_tpu_torch.ops.kernels import (decoder_tail, fused_spatial,
                                              fused_temporal,
                                              parity_upsample as pu,
                                              subpixel as sp,
                                              upsample_epilogue as ue)

    bf = torch.bfloat16
    p = Params(0, device)
    q = Params(2, device)  # the other forms' own inputs: A-F's stay as they were
    tiled = tiled_calls(TILED_REQUEST[2])
    shapes = defaultdict(lambda: defaultdict(dict))  # kernel -> key -> calls
    for shape, calls in SPATIAL_SHAPES:
        shapes["fused_spatial_resblock"][shape].update(v1_0=calls, v1_1=calls)
    for shape, calls in SUBPIXEL_SHAPES:
        shapes["subpixel_interleave"][shape].update(v1_0=calls, v1_1=calls)
    for shape, calls in TAIL_SHAPES:
        for mode, path in MODE_PATH.items():
            shapes["decoder_tail_rgb"][shape, mode][path] = calls
    for shape, calls in TEMPORAL_SHAPES:
        for mode, path in MODE_PATH.items():
            shapes["fused_temporal_resblock"][shape, mode][path] = calls
    for shape, calls in PARITY_SHAPES:
        for mode in MODE_PATH:  # v1.0 serves zero mode; replicate is checked
            shapes["parity_up2x_fused"][shape, mode]["v1_0"] = calls if mode == "zero" else 0
    runs = [("tiled", tiled)] + [(path, model_calls(*run))
                                 for path, run in (CONFIG_PATHS | WIDTH_PATHS).items()]
    for path, run in runs:
        for (name, key), calls in run.items():
            shapes[name][key][path] = calls
            if name == "fused_temporal_resblock_stream":
                shapes[name][key[0], not key[1], key[2]].setdefault(path, 0)

    def tconvs(x, conv1, conv2):
        # the two k=3 time convs as cuDNN runs them (symmetric pad 1: the
        # same FLOP as the causal convs)
        xp = x.permute(0, 4, 1, 2, 3)
        w1, w2 = (cw[0][..., None, None].to(bf) for cw in (conv1, conv2))
        return lambda: F.conv3d(F.conv3d(xp, w1, None, 1, (1, 0, 0)), w2, None, 1,
                                (1, 0, 0))

    for key, calls in shapes["fused_spatial_resblock"].items():
        n, h, w, cin, c = key
        nin = p.conv((c, cin, 1, 1)) if cin != c else None
        args = (p.x((n, h, w, cin), bf), p.norm(cin), p.conv((c, cin, 3, 3)),
                p.norm(c), p.conv((c, c, 3, 3)), nin)
        xp = args[0].permute(0, 3, 1, 2)
        w1, w2 = args[2][0].to(bf), args[4][0].to(bf)
        wn = nin[0].to(bf) if nin else None

        def convs(xp=xp, w1=w1, w2=w2, wn=wn):
            y = F.conv2d(F.conv2d(xp, w1, None, 1, 1), w2, None, 1, 1)
            return y if wn is None else (y, F.conv2d(xp, wn))

        yield Case("fused_spatial_resblock", key, dict(calls),
                   fused_spatial.fused_spatial_resblock,
                   fused_spatial.fused_spatial_resblock_plain, args, convs)
    for (shape, mode), calls in shapes["fused_temporal_resblock"].items():
        c = shape[-1]
        args = (p.x(shape, bf), p.norm(c), p.conv((c, c, 3)), p.norm(c),
                p.conv((c, c, 3)), mode)
        yield Case("fused_temporal_resblock", (shape, mode), dict(calls),
                   fused_temporal.fused_temporal_resblock,
                   fused_temporal.fused_temporal_resblock_plain, args,
                   tconvs(args[0], args[2], args[4]))
    for key, calls in shapes["fused_temporal_resblock_stream"].items():
        (b, t, h, w, c), first, off = key
        cache = None if first else p.x((b, 2, h, w, c), bf)
        cache2 = None if first else p.x((b, 2, h, w, c), bf)
        args = (p.x((b, t, h, w, c), bf), p.norm(c), p.conv((c, c, 3)), p.norm(c),
                p.conv((c, c, 3)), cache, cache2, first, off)
        yield Case("fused_temporal_resblock_stream", key, dict(calls),
                   fused_temporal.fused_temporal_resblock_stream,
                   fused_temporal.fused_temporal_resblock_stream_plain, args,
                   tconvs(args[0], args[2], args[4]))
    for key, calls in shapes["subpixel_interleave"].items():
        ys = tuple(p.x(key, bf) for _ in range(4))
        args = ys + (p.t(0.1 * p.rng.randn(key[-1])),)
        yield Case("subpixel_interleave", key, dict(calls), sp.subpixel_interleave,
                   sp.subpixel_interleave_plain, args)
        n, h, w, c = key
        yield Case("subpixel_interleave_z", key,
                   form_calls(calls, "subpixel_interleave_z"),
                   sp.subpixel_interleave_z, sp.subpixel_interleave_z_plain,
                   (q.x((n, h + 1, w + 1, 4 * c), bf), args[-1]))
    for (shape, mode), calls in shapes["decoder_tail_rgb"].items():
        c = shape[-1]
        args = (p.x(shape, bf), p.norm(c), p.conv((3, c, 3, 3, 3)), mode)
        yield Case("decoder_tail_rgb", (shape, mode), dict(calls),
                   decoder_tail.decoder_tail_rgb,
                   decoder_tail.decoder_tail_rgb_plain, args)
        yield Case("decoder_tail_rgb_taps", (shape, mode),
                   form_calls(calls, "decoder_tail_rgb_taps"),
                   decoder_tail.decoder_tail_rgb_taps,
                   decoder_tail.decoder_tail_rgb_taps_plain, args)
    for (shape, mode), calls_e in shapes["parity_up2x_fused"].items():
        b, t, h, w, c = shape
        args = (p.x(shape, bf), *p.conv((c, c, 3, 3, 3)),
                p.t(1 / (1 + np.exp(-(2.0 + 0.5 * p.rng.randn(1))))), mode)
        yield Case("parity_up2x_fused", (shape, mode), dict(calls_e),
                   pu.parity_up2x_fused, pu.parity_up2x_fused_plain, args)
        # G and H on E's s, bias and alpha, with the parity convs' outputs
        # drawn as activations
        s, bias, alpha = args[0], args[2], args[3]
        ys = tuple(q.x((b, t, h, w, 2 * c), bf) for _ in range(2))
        yield Case("parity_blend_interleave", (shape, mode),
                   form_calls(calls_e, "parity_blend_interleave"),
                   ue.parity_blend_interleave,
                   ue.parity_blend_interleave_plain, (s, *ys, bias, alpha, mode))
        del ys
        yield Case("parity_blend_interleave4", (shape, mode),
                   form_calls(calls_e, "parity_blend_interleave4"),
                   ue.parity_blend_interleave4,
                   ue.parity_blend_interleave4_plain,
                   (s, q.x((b, t, h, w, 4 * c), bf), bias, alpha, mode))
    # the trilinear upsamples' blend at its call shapes, on drawn base convs
    for key, calls in shapes["temporal_linear_blend"].items():
        yield _blend_case(p, key, dict(calls), bf)
    # partial tiles of A, F, B, E, D and D', on inputs of their own:
    # checked, not timed
    r = Params(4, device)
    for key in PARTIAL_SPATIAL:
        n, h, w, cin, c = key
        nin = r.conv((c, cin, 1, 1)) if cin != c else None
        yield Case("fused_spatial_resblock", key, {}, fused_spatial.fused_spatial_resblock,
                   fused_spatial.fused_spatial_resblock_plain,
                   (r.x((n, h, w, cin), bf), r.norm(cin), r.conv((c, cin, 3, 3)),
                    r.norm(c), r.conv((c, c, 3, 3)), nin))
    for shape in PARTIAL_TEMPORAL:
        b, t, h, w, c = shape
        for first in (True, False):
            for off in PARTIAL_OFFSETS:
                caches = ((None, None) if first else
                          tuple(r.x((b, 2, h, w, c), bf) for _ in range(2)))
                yield Case("fused_temporal_resblock_stream", (shape, first, off), {},
                           fused_temporal.fused_temporal_resblock_stream,
                           fused_temporal.fused_temporal_resblock_stream_plain,
                           (r.x(shape, bf), r.norm(c), r.conv((c, c, 3)), r.norm(c),
                            r.conv((c, c, 3)), *caches, first, off))
    for shape in PARTIAL_B:
        c = shape[-1]
        for mode in MODE_PATH:
            yield Case("fused_temporal_resblock", (shape, mode), {},
                       fused_temporal.fused_temporal_resblock,
                       fused_temporal.fused_temporal_resblock_plain,
                       (r.x(shape, bf), r.norm(c), r.conv((c, c, 3)), r.norm(c),
                        r.conv((c, c, 3)), mode))
    for shape in PARTIAL_PARITY:
        c = shape[-1]
        for mode in MODE_PATH:
            yield Case("parity_up2x_fused", (shape, mode), {}, pu.parity_up2x_fused,
                       pu.parity_up2x_fused_plain,
                       (r.x(shape, bf), *r.conv((c, c, 3, 3, 3)), r.t([0.88]), mode))
    for b, t, h, w, c in (shape for shape, _ in PARITY_SHAPES):
        # phase 17b's calls: a rank's slab of SHARDED_REQUEST with its halo rows
        shape = (b, t, h // SHARDED_WORLD + 2, w, c)
        yield Case("parity_up2x_fused", (shape, "zero"), {}, pu.parity_up2x_fused,
                   pu.parity_up2x_fused_plain,
                   (r.x(shape, bf), *r.conv((c, c, 3, 3, 3)), r.t([0.88]), "zero"))
    for shape in PARTIAL_TAIL:
        c = shape[-1]
        for mode in MODE_PATH:
            args = (r.x(shape, bf), r.norm(c), r.conv((3, c, 3, 3, 3)), mode)
            yield Case("decoder_tail_rgb", (shape, mode), {}, decoder_tail.decoder_tail_rgb,
                       decoder_tail.decoder_tail_rgb_plain, args)
            yield Case("decoder_tail_rgb_taps", (shape, mode), {},
                       decoder_tail.decoder_tail_rgb_taps,
                       decoder_tail.decoder_tail_rgb_taps_plain, args)
    for key in partial_linear_keys():
        yield _blend_case(r, key, {}, bf)
    yield from width_cases(device, bf, 5)


def partial_linear_keys() -> list:
    """The blend's keys at PARTIAL_LINEAR's clips (cache offset 2): a
    stream's first chunk (split 1), a later one, and one segment with the
    zero front."""
    keys = []
    for shape in PARTIAL_LINEAR:
        t = shape[1]
        keys += [(shape, 1, "replicate", (2 * t - 2, t - 1)),
                 (shape, 0, "carried", (2 * t - 2, t - 2)), (shape, t, "zero", None)]
    return keys


def _blend_case(p, key, calls: dict, dtype) -> Case:
    """The trilinear upsample's blend at ``key`` (x's shape, split, front,
    next front) on drawn base convs, predecessor frame and front sums: the
    output, and the next front sums where the call writes them."""
    from vidtok_tpu_torch.ops.kernels import temporal_linear as tl

    (b, t, h, w, c), split, front, nxt = key
    carried = front == "carried"
    args = (p.x((b, t, h, w, c), dtype), p.x((b, t, h, w, 3 * c), dtype),
            p.t(0.1 * p.rng.randn(c)), p.t(1 / (1 + np.exp(-(2.0 + 0.5 * p.rng.randn(1))))),
            split, p.x((b, 1, h, w, c), dtype) if carried else None,
            p.x((b, 3, h, w, c), dtype) if carried else front, nxt)

    def outputs(blend):
        return lambda *a: tuple(o for o in blend(*a) if o is not None)

    return Case("temporal_linear_blend", key, calls, outputs(tl.temporal_linear_blend),
                outputs(tl.temporal_linear_blend_plain), args)


# Phase 2 at the widths the kernels take beside the released ones (checked,
# not timed), in bf16 and in f32: A, B, E, F, D and D' at every C of
# WIDTHS_CHECKED (B, E, D and D' in both stream-start modes, F at both
# ``first_chunk`` values and cache offsets 0 and 2), A also at its
# shortcut pairs, D and D' at TAIL_RUNS_WIDTH too (runs with warm-up frames
# in channel groups), and one 33² partial-tile shape of each at
# PARTIAL_WIDTH channels.
WIDTHS_CHECKED = (8, 32, 64, 96, 192, 256, 384, 1024)
SHORTCUT_PAIRS = ((32, 64), (64, 128), (96, 192), (192, 384))
TAIL_RUNS_WIDTH = (1, 40, 64, 64, 256)
PARTIAL_WIDTH = 96


def width_cases(device, dtype, seed: int):
    """Yield the ``Case`` of every WIDTHS_CHECKED check (see above) on
    ``dtype`` activations and f32 parameters drawn from ``seed``."""
    from vidtok_tpu_torch.ops.kernels import (decoder_tail, fused_spatial, fused_temporal,
                                              parity_upsample as pu)

    r = Params(seed, device)

    def spatial(key):
        n, h, w, cin, c = key
        nin = r.conv((c, cin, 1, 1)) if cin != c else None
        return Case("fused_spatial_resblock", key, {}, fused_spatial.fused_spatial_resblock,
                    fused_spatial.fused_spatial_resblock_plain,
                    (r.x((n, h, w, cin), dtype), r.norm(cin), r.conv((c, cin, 3, 3)),
                     r.norm(c), r.conv((c, c, 3, 3)), nin))

    def temporal(shape):
        c = shape[-1]
        for mode in MODE_PATH:
            yield Case("fused_temporal_resblock", (shape, mode), {},
                       fused_temporal.fused_temporal_resblock,
                       fused_temporal.fused_temporal_resblock_plain,
                       (r.x(shape, dtype), r.norm(c), r.conv((c, c, 3)), r.norm(c),
                        r.conv((c, c, 3)), mode))

    def stream(shape, offsets):
        b, t, h, w, c = shape
        for first in (True, False):
            for off in offsets:
                caches = ((None, None) if first else
                          tuple(r.x((b, 2, h, w, c), dtype) for _ in range(2)))
                yield Case("fused_temporal_resblock_stream", (shape, first, off), {},
                           fused_temporal.fused_temporal_resblock_stream,
                           fused_temporal.fused_temporal_resblock_stream_plain,
                           (r.x(shape, dtype), r.norm(c), r.conv((c, c, 3)), r.norm(c),
                            r.conv((c, c, 3)), *caches, first, off))

    def parity(shape):
        c = shape[-1]
        for mode in MODE_PATH:
            yield Case("parity_up2x_fused", (shape, mode), {}, pu.parity_up2x_fused,
                       pu.parity_up2x_fused_plain,
                       (r.x(shape, dtype), *r.conv((c, c, 3, 3, 3)), r.t([0.88]), mode))

    def tails(shape):
        c = shape[-1]
        for mode in MODE_PATH:
            args = (r.x(shape, dtype), r.norm(c), r.conv((3, c, 3, 3, 3)), mode)
            yield Case("decoder_tail_rgb", (shape, mode), {}, decoder_tail.decoder_tail_rgb,
                       decoder_tail.decoder_tail_rgb_plain, args)
            yield Case("decoder_tail_rgb_taps", (shape, mode), {},
                       decoder_tail.decoder_tail_rgb_taps,
                       decoder_tail.decoder_tail_rgb_taps_plain, args)

    for c in WIDTHS_CHECKED:
        yield spatial((4, 32, 32, c, c))
        yield from temporal((1, 6, 32, 32, c))
        yield from stream((1, 5, 16, 16, c), (0, 2))
        yield from parity((1, 4, 32, 32, c))
        yield from tails((1, 6, 32, 32, c))
    for cin, c in SHORTCUT_PAIRS:
        yield spatial((4, 32, 32, cin, c))
    yield from tails(TAIL_RUNS_WIDTH)
    c = PARTIAL_WIDTH
    yield spatial((5, 33, 33, c, c))
    yield spatial((5, 33, 33, c, 2 * c))
    yield from temporal((2, 5, 33, 33, c))
    yield from stream((1, 5, 33, 33, c), (1, 4))
    yield from parity((2, 5, 33, 33, c))
    yield from tails((2, 6, 33, 33, c))



def f32_kernel_cases(device):
    """Yield a ``Case`` for every f32 call shape of A-I, D' and the
    trilinear upsample's blend (see F32_GATE): f32 activations and
    parameters on ``device``, cuDNN's f32 convs of the block (A, B, F), E's
    per-frame conv C -> 3C and D's and D''s 3x3x3 conv as the yardstick."""
    import torch
    import torch.nn.functional as F

    from vidtok_tpu_torch.modules.conv import conv3d_cl
    from vidtok_tpu_torch.ops.kernels import (decoder_tail, fused_spatial, fused_temporal,
                                              parity_upsample as pu, subpixel as sp,
                                              upsample_epilogue as ue)

    f32 = torch.float32
    p = Params(9, device)
    shapes = defaultdict(lambda: defaultdict(dict))  # kernel -> key -> calls per path
    for path, calls in f32_calls().items():
        for (name, key), n in calls.items():
            shapes[name][key][path] = n
    other = {"zero": "replicate", "replicate": "zero"}
    for name in ("fused_temporal_resblock", "parity_up2x_fused", "decoder_tail_rgb",
                 "parity_blend_interleave", "parity_blend_interleave4",
                 "decoder_tail_rgb_taps"):
        for shape, mode in list(shapes[name]):
            shapes[name][shape, other[mode]].setdefault(F32_PATHS[0], 0)
        shape = F32_PARTIAL[name]
        for mode in other:
            shapes[name][shape, mode].setdefault(F32_PATHS[0], 0)
    stream = shapes["fused_temporal_resblock_stream"]
    for shape, first, off in list(stream):
        stream[shape, not first, off].setdefault(F32_PATHS[1], 0)
    for first in (True, False):
        for off in F32_OFFSETS:
            stream[F32_PARTIAL["fused_temporal_resblock_stream"], first, off].setdefault(
                F32_PATHS[1], 0)
    for name in ("fused_spatial_resblock", "subpixel_interleave", "subpixel_interleave_z"):
        shapes[name][F32_PARTIAL[name]].setdefault(F32_PATHS[0], 0)

    def tconvs(x, conv1, conv2):
        xp = x.permute(0, 4, 1, 2, 3)
        w1, w2 = (cw[0][..., None, None] for cw in (conv1, conv2))
        return lambda: F.conv3d(F.conv3d(xp, w1, None, 1, (1, 0, 0)), w2, None, 1,
                                (1, 0, 0))

    for key, calls in shapes["fused_spatial_resblock"].items():
        n, h, w, cin, c = key
        nin = p.conv((c, cin, 1, 1)) if cin != c else None
        args = (p.x((n, h, w, cin), f32), p.norm(cin), p.conv((c, cin, 3, 3)),
                p.norm(c), p.conv((c, c, 3, 3)), nin)
        xp = args[0].permute(0, 3, 1, 2)

        def convs(xp=xp, w1=args[2][0], w2=args[4][0], wn=nin[0] if nin else None):
            y = F.conv2d(F.conv2d(xp, w1, None, 1, 1), w2, None, 1, 1)
            return y if wn is None else (y, F.conv2d(xp, wn))

        yield Case("fused_spatial_resblock", key, dict(calls),
                   fused_spatial.fused_spatial_resblock,
                   fused_spatial.fused_spatial_resblock_plain, args, convs)
    for (shape, mode), calls in shapes["fused_temporal_resblock"].items():
        c = shape[-1]
        args = (p.x(shape, f32), p.norm(c), p.conv((c, c, 3)), p.norm(c),
                p.conv((c, c, 3)), mode)
        yield Case("fused_temporal_resblock", (shape, mode), dict(calls),
                   fused_temporal.fused_temporal_resblock,
                   fused_temporal.fused_temporal_resblock_plain, args,
                   tconvs(args[0], args[2], args[4]))
    for key, calls in stream.items():
        (b, t, h, w, c), first, off = key
        caches = ((None, None) if first else
                  tuple(p.x((b, 2, h, w, c), f32) for _ in range(2)))
        args = (p.x((b, t, h, w, c), f32), p.norm(c), p.conv((c, c, 3)), p.norm(c),
                p.conv((c, c, 3)), *caches, first, off)
        yield Case("fused_temporal_resblock_stream", key, dict(calls),
                   fused_temporal.fused_temporal_resblock_stream,
                   fused_temporal.fused_temporal_resblock_stream_plain, args,
                   tconvs(args[0], args[2], args[4]))
    for key, calls in shapes["subpixel_interleave"].items():
        args = tuple(p.x(key, f32) for _ in range(4)) + (p.t(0.1 * p.rng.randn(key[-1])),)
        yield Case("subpixel_interleave", key, dict(calls), sp.subpixel_interleave,
                   sp.subpixel_interleave_plain, args)
    for key, calls in shapes["subpixel_interleave_z"].items():
        n, h, w, c = key
        yield Case("subpixel_interleave_z", key, dict(calls), sp.subpixel_interleave_z,
                   sp.subpixel_interleave_z_plain,
                   (p.x((n, h + 1, w + 1, 4 * c), f32), p.t(0.1 * p.rng.randn(c))))
    tails = {"decoder_tail_rgb": (decoder_tail.decoder_tail_rgb,
                                  decoder_tail.decoder_tail_rgb_plain),
             "decoder_tail_rgb_taps": (decoder_tail.decoder_tail_rgb_taps,
                                       decoder_tail.decoder_tail_rgb_taps_plain)}
    for name, (kernel, plain) in tails.items():
        for (shape, mode), calls in shapes[name].items():
            c = shape[-1]
            args = (p.x(shape, f32), p.norm(c), p.conv((3, c, 3, 3, 3)), mode)
            yield Case(name, (shape, mode), dict(calls), kernel, plain, args,
                       lambda x=args[0], w=args[2][0]: conv3d_cl(x, w, padding=(1, 1, 1)))
    for (shape, mode), calls in shapes["parity_up2x_fused"].items():
        b, t, h, w, c = shape
        args = (p.x(shape, f32), *p.conv((c, c, 3, 3, 3)),
                p.t(1 / (1 + np.exp(-(2.0 + 0.5 * p.rng.randn(1))))), mode)
        kb = args[1].permute(2, 0, 1, 3, 4).reshape(3 * c, c, 3, 3)
        yield Case("parity_up2x_fused", (shape, mode), dict(calls), pu.parity_up2x_fused,
                   pu.parity_up2x_fused_plain, args,
                   lambda s=args[0].reshape(b * t, h, w, c).permute(0, 3, 1, 2), kb=kb:
                   F.conv2d(s, kb, None, 1, 1))
    # G and H on inputs of their own: s, the bias and alpha, the parity
    # convs' outputs drawn as activations
    for (shape, mode), calls in shapes["parity_blend_interleave"].items():
        b, t, h, w, c = shape
        args = (p.x(shape, f32), p.x((b, t, h, w, 2 * c), f32), p.x((b, t, h, w, 2 * c), f32),
                p.t(0.1 * p.rng.randn(c)), p.t([0.88]), mode)
        yield Case("parity_blend_interleave", (shape, mode), dict(calls),
                   ue.parity_blend_interleave, ue.parity_blend_interleave_plain, args)
    for (shape, mode), calls in shapes["parity_blend_interleave4"].items():
        b, t, h, w, c = shape
        args = (p.x(shape, f32), p.x((b, t, h, w, 4 * c), f32), p.t(0.1 * p.rng.randn(c)),
                p.t([0.88]), mode)
        yield Case("parity_blend_interleave4", (shape, mode), dict(calls),
                   ue.parity_blend_interleave4, ue.parity_blend_interleave4_plain, args)
    for key, calls in shapes["temporal_linear_blend"].items():
        yield _blend_case(p, key, dict(calls), f32)
    for key in partial_linear_keys():
        if key[0] == F32_PARTIAL["temporal_linear_blend"]:
            yield _blend_case(p, key, {}, f32)
    # the row passes' statistics on rows of a large mean, at the partial
    # shapes, not timed
    mean = F32_ROW_MEAN
    n, h, w, cin, c = F32_PARTIAL["fused_spatial_resblock"]
    yield Case("fused_spatial_resblock", (n, h, w, cin, c), {},
               fused_spatial.fused_spatial_resblock,
               fused_spatial.fused_spatial_resblock_plain,
               (p.x((n, h, w, cin), f32) + mean, p.norm(cin), p.conv((c, cin, 3, 3)),
                p.norm(c), p.conv((c, c, 3, 3)), None), mean=mean)
    shape = F32_PARTIAL["fused_temporal_resblock"]
    c = shape[-1]
    yield Case("fused_temporal_resblock", (shape, "replicate"), {},
               fused_temporal.fused_temporal_resblock,
               fused_temporal.fused_temporal_resblock_plain,
               (p.x(shape, f32) + mean, p.norm(c), p.conv((c, c, 3)), p.norm(c),
                p.conv((c, c, 3)), "replicate"), mean=mean)
    shape = F32_PARTIAL["fused_temporal_resblock_stream"]
    b, t, h, w, c = shape
    yield Case("fused_temporal_resblock_stream", (shape, False, 1), {},
               fused_temporal.fused_temporal_resblock_stream,
               fused_temporal.fused_temporal_resblock_stream_plain,
               (p.x(shape, f32) + mean, p.norm(c), p.conv((c, c, 3)), p.norm(c),
                p.conv((c, c, 3)), *(p.x((b, 2, h, w, c), f32) for _ in range(2)), False, 1),
               mean=mean)
    for name, (kernel, plain) in tails.items():
        shape = F32_PARTIAL[name]
        c = shape[-1]
        yield Case(name, (shape, "replicate"), {}, kernel, plain,
                   (p.x(shape, f32) + mean, p.norm(c), p.conv((3, c, 3, 3, 3)), "replicate"),
                   mean=mean)
    yield from width_cases(device, f32, 10)


def form_calls(calls: dict, kernel: str) -> dict:
    """Calls per forward of ``kernel``, a non-default form's, on each FORMS
    path that runs it, at a call shape whose default-form kernel has
    ``calls`` (per path)."""
    return {path: calls.get(base, 0) for path, (_, base) in FORMS.items()
            if kernel in form_swaps(path).values()}


def gate(what: str, rel: float, plain_rel: float) -> None:
    if not (rel <= KERNEL_GATE and rel <= BF16_SLACK * plain_rel):
        raise AssertionError(
            f"{what}: rel_l2 {rel} > {KERNEL_GATE}, or > "
            f"{BF16_SLACK} x plain bf16 rel_l2 {plain_rel}")


def f32_gate(what: str, rel: float) -> None:
    if not rel <= F32_GATE:
        raise AssertionError(f"{what}: rel_l2 {rel} > {F32_GATE}")


def _outs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def check_kernels(device, names=None, in_f32: bool = False) -> dict:
    """Phase 2: every kernel (or those in ``names``) against its plain
    version, every gate checked before the first failure is raised; returns {kernel:
    {max_abs_err, max_rel_l2, and per path: ms, plain_ms, convs_ms (cuDNN's
    convs of the block alone), bound_ms, and bound_by_bytes_ms /
    bound_by_ops_ms (the part of the bound from calls that bytes or
    operations bound)}}, times summed per forward of each path.

    Every output is gated: kernel F's y and both new caches. Besides the
    fixed bound KERNEL_GATE, each kernel is held to the plain version's own
    bf16 error: a fault on a frame's border (a padding tap that reads
    ln_silu(0) = silu(bias) instead of 0) stays under 1e-2 at 256x256 but
    doubles that error.

    ``in_f32``: the f32 forms at ``f32_kernel_cases``' shapes, each held
    to its plain version in f32 (TF32 off) at F32_GATE, timed against the
    plain f32 version and cuDNN's f32 convs, the bound from ``f32_work``,
    per forward of F32_PATHS.
    """
    import torch

    sums = ("ms", "plain_ms", "convs_ms", "bound_ms", "bound_by_bytes_ms",
            "bound_by_ops_ms")
    paths = F32_PATHS if in_f32 else PATHS
    label, plain_dt = (" f32", "f32") if in_f32 else ("", "bf16")
    results, failed = {}, []
    for case in (f32_kernel_cases if in_f32 else kernel_cases)(device):
        name, args = case.name, case.args
        if names is not None and name not in names:
            continue
        out = _outs(case.kernel(*args))
        ref = _outs(case.plain(*f32(args)))
        if case.mean and not name.startswith("decoder_tail_rgb"):
            # the residual branch, which x's offset would dwarf
            out = (out[0] - args[0], *out[1:])
            ref = (ref[0] - args[0], *ref[1:])
        plain_bf16 = ref if in_f32 else _outs(case.plain(*args))
        torch.cuda.synchronize()
        errs, rels, plain_rels = [], [], []
        for o, r, pb in zip(out, ref, plain_bf16, strict=True):
            if o.shape != r.shape or o.dtype != args[0].dtype:
                raise AssertionError(f"{name}{case.key}: {o.shape}/{o.dtype} "
                                     f"vs {r.shape}")
            errs.append(float((o.float() - r).abs().max()))
            rels.append(rel_l2(o.float(), r))
            plain_rels.append(rel_l2(pb.float(), r))
        ms = plain_ms = convs_ms = 0.0
        if any(case.calls.values()):
            reps = dict(warmup=1, iters=3) if in_f32 else {}
            ms = cuda_ms(lambda: case.kernel(*args), **reps)
            plain_ms = cuda_ms(lambda: case.plain(*args), **reps)
            if case.convs is not None:
                convs_ms = cuda_ms(case.convs, **reps)
        bound, by = bound_ms(*(f32_work if in_f32 else work)(name, case.key))
        print(f"kernel {name}{label} {case.key}"
              + (f" rows of mean {case.mean}" if case.mean else "")
              + ": max_abs_err "
              + "/".join(f"{e:.4g}" for e in errs) + " rel_l2 "
              + "/".join(f"{r:.4g}" for r in rels)
              + ("" if in_f32 else " plain_bf16_rel_l2 "
                 + "/".join(f"{r:.4g}" for r in plain_rels))
              + f" kernel_ms {ms:.4f} plain_{plain_dt}_ms {plain_ms:.4f} cudnn_convs_ms "
              f"{convs_ms:.4f} bound_ms {bound:.4f} ({by}) calls/forward "
              f"{case.calls}", flush=True)
        for i, (rel, plain_rel) in enumerate(zip(rels, plain_rels)):
            try:
                if in_f32:
                    f32_gate(f"{name} f32 {case.key} mean {case.mean} output {i}", rel)
                else:
                    gate(f"{name}{case.key} output {i}", rel, plain_rel)
            except AssertionError as e:
                print(f"GATE FAILED {e}", flush=True)
                failed.append(str(e))
        r = results.setdefault(name, dict(
            max_abs_err=0.0, max_rel_l2=0.0,
            **{k: dict.fromkeys(paths, 0.0) for k in sums}))
        r["max_abs_err"] = max(r["max_abs_err"], *errs)
        r["max_rel_l2"] = max(r["max_rel_l2"], *rels)
        part = "bound_by_bytes_ms" if by == "bytes" else "bound_by_ops_ms"
        for path, n in case.calls.items():
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("convs_ms", convs_ms),
                         ("bound_ms", bound), (part, bound)):
                r[k][path] += n * v
        del out, ref, plain_bf16, args, case
    for name, r in results.items():
        print(f"kernel {name}{label} per forward: " + "; ".join(
            f"{path} " + " ".join(f"{k} {r[k][path]:.4f}" for k in sums)
            for path in paths if r["bound_ms"][path]), flush=True)
    if failed:
        raise AssertionError(f"{len(failed)} kernel gates failed:\n" + "\n".join(failed))
    return results


def _long_rels(got, ref, plain_bf16) -> tuple:
    """(rel_l2, the plain bf16 version's, or None for a kernel's f32 form)
    of a window of a T=201 call against the plain f32 version."""
    return rel_l2(got, ref), None if plain_bf16 is None else rel_l2(plain_bf16.float(), ref)


def _long_line(rel: float, plain_rel) -> str:
    return f"rel_l2 {rel:.4g}" + ("" if plain_rel is None else
                                  f" plain_bf16_rel_l2 {plain_rel:.4g}")


def _long_gate(what: str, rel: float, plain_rel) -> None:
    """``gate`` for a bf16 kernel, ``f32_gate`` for an f32 form."""
    if plain_rel is None:
        f32_gate(what, rel)
    else:
        gate(what, rel, plain_rel)


def check_parity_long(device, in_f32: bool = False) -> None:
    """Kernel E at PARITY_LONG, zero mode: its output frames 192-203 (past
    2^31 elements) against the plain version of the window s[95:] with the
    first output pair dropped, in f32 and in bf16; E's time at this shape.
    ``in_f32``: E's f32 form (its byte offsets pass 2^31 at half the
    elements), held to the plain f32 version at F32_GATE."""
    import torch

    from vidtok_tpu_torch.ops.kernels import parity_upsample as pu

    b, t, h, w, c = PARITY_LONG
    p = Params(1, device)
    weight, bias = p.conv((c, c, 3, 3, 3))
    alpha = p.t([0.88])
    g = torch.Generator(device).manual_seed(1)
    s = torch.randn(PARITY_LONG, generator=g, device=device,
                    dtype=torch.float32 if in_f32 else torch.bfloat16)
    out = pu.parity_up2x_fused(s, weight, bias, alpha, "zero")
    win = s[:, PARITY_WINDOW:].contiguous()
    ref = pu.parity_up2x_fused_plain(win.float(), weight, bias, alpha, "zero")[:, 2:]
    plain_bf16 = (None if in_f32 else
                  pu.parity_up2x_fused_plain(win, weight, bias, alpha, "zero")[:, 2:])
    got = out[:, 2 * (PARITY_WINDOW + 1):].float()
    torch.cuda.synchronize()
    if out.shape != (b, 2 * t, h, w, c) or got.shape != ref.shape or out.dtype != s.dtype:
        raise AssertionError(f"parity long: {tuple(out.shape)}, window "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    label = " f32" if in_f32 else ""
    rels = _long_rels(got, ref, plain_bf16)
    del out, got, ref, plain_bf16, win
    ms = cuda_ms(lambda: pu.parity_up2x_fused(s, weight, bias, alpha, "zero"),
                 warmup=1, iters=3)
    print(f"kernel parity_up2x_fused{label} {PARITY_LONG} zero, output frames "
          f"{2 * (PARITY_WINDOW + 1)}-{2 * t - 1} (past 2^31 elements): "
          f"{_long_line(*rels)} kernel_ms {ms:.4f} (plain not timed at this shape)",
          flush=True)
    _long_gate(f"parity_up2x_fused{label}{PARITY_LONG} window", *rels)


def check_spatial_long(device, in_f32: bool = False) -> None:
    """Kernel A at SPATIAL_LONG with its nin_shortcut (an input of 3.42e9
    elements): its last SPATIAL_WINDOW frames against the plain version of
    those input frames, in f32 and in bf16; A's time at this shape.
    ``in_f32``: A's f32 form (13.7 GB of input, 41 GB of bf16 pieces),
    held to the plain f32 version at F32_GATE."""
    import torch

    from vidtok_tpu_torch.ops.kernels import fused_spatial as fs

    n, h, w, cin, c = SPATIAL_LONG
    p = Params(6, device)
    params = (p.norm(cin), p.conv((c, cin, 3, 3)), p.norm(c), p.conv((c, c, 3, 3)),
              p.conv((c, cin, 1, 1)))
    x = p.x((n, h, w, cin), torch.float32 if in_f32 else torch.bfloat16)
    out = fs.fused_spatial_resblock(x, *params)
    got = out[-SPATIAL_WINDOW:].float()
    win = x[-SPATIAL_WINDOW:]
    ref = fs.fused_spatial_resblock_plain(win.float(), *params)
    plain_bf16 = None if in_f32 else fs.fused_spatial_resblock_plain(win, *params)
    torch.cuda.synchronize()
    if out.shape != (n, h, w, c) or got.shape != ref.shape or out.dtype != x.dtype:
        raise AssertionError(f"spatial long: {tuple(out.shape)}, window "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    rels = _long_rels(got, ref, plain_bf16)
    del out, got, ref, plain_bf16, win
    ms = cuda_ms(lambda: fs.fused_spatial_resblock(x, *params), warmup=1, iters=3)
    label = " f32" if in_f32 else ""
    print(f"kernel fused_spatial_resblock{label} {SPATIAL_LONG} nin, frames "
          f"{n - SPATIAL_WINDOW}-{n - 1} (input past 2^31 elements): {_long_line(*rels)} "
          f"kernel_ms {ms:.4f} (plain not timed at this shape)", flush=True)
    _long_gate(f"fused_spatial_resblock{label}{SPATIAL_LONG} window", *rels)


def check_tail_long(device, in_f32: bool = False, taps: bool = False) -> None:
    """Kernel D at TAIL_LONG, zero mode (its input 3.4 GB, in runs of frames
    that start with warm-up frames): the output frames of its last run
    against the plain version of the input window that holds them and the
    two warm-up frames before, whose outputs are dropped, in f32 and in
    bf16; D's time at this shape. ``in_f32``: D's f32 form (6.8 GB of
    input) on the same window, held to the plain f32 version at
    F32_GATE. ``taps``: kernel D' in place of D."""
    import torch

    from vidtok_tpu_torch.ops.kernels import decoder_tail, plan

    name = "decoder_tail_rgb_taps" if taps else "decoder_tail_rgb"
    kernel, plain = getattr(decoder_tail, name), getattr(decoder_tail, name + "_plain")
    b, t, h, w, c = TAIL_LONG
    pl = plan.tail_plan(*TAIL_LONG)
    p = Params(8, device)
    params = (p.norm(c), p.conv((3, c, 3, 3, 3)), "zero")
    x = p.x(TAIL_LONG, torch.float32 if in_f32 else torch.bfloat16)
    out = kernel(x, *params)
    t0 = (pl.runs - 1) * pl.run  # the last run's first output frame
    s0 = max(t0 - 2, 0)
    win = x[:, s0:]
    ref = plain(win.float(), *params)[:, t0 - s0:]
    plain_bf16 = None if in_f32 else plain(win, *params)[:, t0 - s0:]
    got = out[:, t0:].float()
    torch.cuda.synchronize()
    if out.shape != (b, t, h, w, 3) or got.shape != ref.shape or out.dtype != x.dtype:
        raise AssertionError(f"tail long: {tuple(out.shape)}, window "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    rels = _long_rels(got, ref, plain_bf16)
    del out, got, ref, plain_bf16, win
    ms = cuda_ms(lambda: kernel(x, *params), warmup=1, iters=3)
    label = " f32" if in_f32 else ""
    print(f"kernel {name}{label} {TAIL_LONG} zero, output frames {t0}-{t - 1} "
          f"(the last of {pl.runs} runs of {pl.run} frames of the bf16 plan): "
          f"{_long_line(*rels)} kernel_ms {ms:.4f} (plain not timed at this shape)",
          flush=True)
    _long_gate(f"{name}{label}{TAIL_LONG} window", *rels)


def compare_forms(device, card: str) -> None:
    """The decoder's kernel forms against each other at the v1.0 flagship's
    shapes, zero mode, bf16, by CUDA events, per call and per forward, the
    convs included: TimeUpsampleRes2x (nearest) with E, with one C->4C
    conv + H and with two C->2C convs + G; SpatialUpsample with four
    parity convs + C and with one VALID 2x2 conv + I; the tail with D and
    with D'. Each form's output is held to the default form's (relative L2
    <= KERNEL_GATE), and the parity convs' cuDNN output must already be
    the channels-last layout the kernels read (no copy between)."""
    import torch
    import torch.nn.functional as F

    from vidtok_tpu_torch import KernelForms
    from vidtok_tpu_torch.modules.blocks import SpatialUpsample, TimeUpsampleRes2x
    from vidtok_tpu_torch.ops.kernels import decoder_tail

    bf = torch.bfloat16
    p = Params(3, device)
    per_fwd = defaultdict(float)
    rows = []

    def compare(site, key, calls, runs):
        outs, ms = {}, {}
        with torch.no_grad():
            for form, fn in runs.items():
                outs[form] = fn()
                ms[form] = cuda_ms(fn)
                per_fwd[site, form] += calls * ms[form]
        torch.cuda.synchronize()
        default = next(iter(outs.values()))
        rels = {f: rel_l2(o.float(), default.float()) for f, o in outs.items()}
        print(f"forms {site} {key} x{calls}/forward: " + "; ".join(
            f"{f} {ms[f]:.4f} ms (rel_l2 vs {next(iter(runs))} {rels[f]:.3g})"
            for f in runs), flush=True)
        for f, rel in rels.items():
            if not rel <= KERNEL_GATE:
                raise AssertionError(f"forms {site}{key}: {f} vs default {rel}")
        rows.append((site, key))

    for shape, calls in PARITY_SHAPES:
        b, t, h, w, c = shape
        m = TimeUpsampleRes2x(c, c, first_pad_mode="zero",
                              interpolation_mode="nearest").to(device)
        m.conv.reset_params(torch.Generator().manual_seed(3))
        x = p.x(shape, bf)
        xf = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        y = F.conv2d(xf, torch.zeros(4 * c, c, 3, 3, device=device, dtype=bf), None, 1, 1)
        if not y.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"parity conv at {shape}: cuDNN output is not "
                                 "channels-last; the kernels would read a copy")
        del y
        compare("parity", shape, calls, {
            f: (lambda f=f: m(x, fused=True, forms=KernelForms(parity=f)))
            for f in ("fused", "merged", "split")})
    for shape, calls in SUBPIXEL_SHAPES:
        m = SpatialUpsample(shape[-1]).to(device)
        m.conv.reset_params(torch.Generator().manual_seed(4))
        x = p.x((1,) + shape, bf)
        compare("subpixel", shape, calls, {
            f: (lambda f=f: m(x, fused=True, forms=KernelForms(subpixel=f)))
            for f in ("split", "merged")})
    for shape, calls in TAIL_SHAPES:
        c = shape[-1]
        args = (p.x(shape, bf), p.norm(c), p.conv((3, c, 3, 3, 3)), "zero")
        compare("tail", shape, calls, {
            "packed": lambda: decoder_tail.decoder_tail_rgb(*args),
            "taps": lambda: decoder_tail.decoder_tail_rgb_taps(*args)})
    print(f"forms per v1.0 forward ({card}): " + "; ".join(
        f"{site} {form} {v:.4f} ms" for (site, form), v in per_fwd.items()),
        flush=True)
