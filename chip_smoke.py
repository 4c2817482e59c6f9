#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vidtok_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. build the fourteen hand-written kernels from ``vidtok_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source) and print the build time and the
   ``-Xptxas -v`` report;
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
   at their chunk shapes. The kernels of the decoder's other forms
   (``KernelForms``): G and H at E's shapes, I at C's and D' at D's, the
   tiled chunk shapes included, in both stream-start modes where they have
   them; then the forms against each other per call and per v1.0 forward at
   the flagship's shapes, the convs included: E against one conv + H
   against two convs + G, four convs + C against one conv + I, D against D';
   then the tools' kernels (``vidtok_tpu_torch/tools``): kernel B in zero
   mode, T1 (``fused_fat``), T2 (``fused_diag``, modes mm, ln, copy) and T3
   (``copy_min``, the five tilings that divide) at the temporal
   microbenchmark's default [1, 9, 64, 64, 512] and at B's
   [1, 20, 256, 256, 128], T1 and T2's mm and ln also at two clips of
   33 x 33 (TOOL_PARTIAL, checked, not timed), T4 (``silu_probe``, three
   modes) at [64, 512, 512], each gated as above (T4's bf16 modes against
   f32 SiLU and value by value against the plain bf16 version, see
   SILU_UNITS; every copy equal to x), the plain version and ``x.clone()``
   (T3, T2's copy) or ``F.silu`` (T4's f32 form) timed with the L2 flushed
   before each call, and for T2's mm a cuDNN yardstick (two k=(3,1,1)
   convs and the add, ``mm_yardstick``); then both tools' mains on the card
   at the same shapes, whose rows give the kernels' times and bounds and
   whose launches of T1-T4 the result line reports;
3. serve the causal v1.0 KL 4x8x8 16-channel flagship at full width with
   seeded random weights in bf16: 3 requests of [1, 3, 17, 256, 256],
   per-request latency, frames/s and peak memory, and the kernels' launch
   counts per forward (20 / 20 / 3 / 1 / 2); then the same requests through
   the plain path (no kernel launched), a torch.profiler breakdown of one
   kernel-path request, and the end-to-end gate: on z and on the
   reconstruction the kernel path (bf16) must be no further from the f32
   plain run than the plain bf16 path is (x 1.1), the kernel path with
   the launches above, at REQUEST and at PARTIAL_REQUEST ([1, 3, 17, 264,
   264], a 33² latent: partial tiles in A-E); then the wgmma loop's GEMM
   TFLOP/s and the row passes' share of their byte bound in A at 128, 256
   and 512 channels, in B at its two heaviest shapes and in E at both of
   its shapes, and D's and D''s share of their byte bound at their v1.0
   shape (``loop_rates``, torch.profiler);
4. serve one [1, 3, 201, 256, 256] clip (bench.py's protocol) through the
   v1.0 kernel path after one warm-up of the same shape;
5. serve one request through the v1.0 FSQ 4096 tokenizer's kernel path and
   check its indices, ``indices_to_latent`` and decoding from indices;
6. the causal v1.1 KL 4x8x8 16-channel tokenizer as in 3 (launches
   20 / 20 / 3 / 1 / 0);
7. the same v1.1 tokenizer tiled (``use_tiling``, ``use_overlap``,
   ``t_chunk_enc`` 16): 3 requests of [1, 3, 65, 256, 256] with the launch
   counts per forward derived from the chunk schedule (F 100, A 100, C 15,
   D 5, B and E 0), a profile of one request, one [1, 3, 201, 256, 256]
   request whose peak memory may be at most 1.25x the T=65 peak, one T=65
   request in the ``merged`` subpixel and ``taps`` tail forms (I 15, D' 5),
   the end-to-end gates at T=65 against the non-tiled f32 plain run (the
   forms' request against the tiled f32 plain run), and one tiled
   [1, 3, 17, 264, 264] request (a 33² latent: partial tiles in A, C, D,
   F; launches A 40, C 6, D 2, F 40) held to the tiled f32 plain run by
   the same rule;
8. serve the v1.0 flagship in the forms ``KernelForms("merged", "merged",
   "taps")``: 3 requests (launches per forward A 20, B 20, H 2, I 3, D' 1,
   C, D, E and G 0), a profile of one, then one request in the ``split``
   parity form (G 2), and the end-to-end gate for both forms.

``python3 chip_smoke.py --kernels NAME[,NAME...]`` runs phases 1 and 2 for
the named kernels of SOURCES and TOOL_SOURCES alone (and D's T=201 window
when D is named; a tool's kernel at the tools' shapes),
reports every gate that fails and exits 1 if any did, with no result line:
the check to run from a copy of the checkout with a planted fault.

It never falls back to the CPU or to a plain version. The last two lines of
standard output are a JSON object with the per-kernel results (``headers``:
the shared GEMM loop, and B's and F's shared block, a kernel is built on
besides its source; launches
from phase 3's kernel-path run for A-E, phase 7's for F, and phase 8's for
G (its ``split`` request), H, I and D', and the tools' runs for T1-T4,
whose numbers are those of one row of the tool at its first shape, with
every row beside) and ``{"ok": true, "device": {...}}``. Needs one CUDA device;
imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter, defaultdict
from typing import Callable, NamedTuple

import numpy as np

# the bound of a call: bytes over the HBM rate or FLOP over the peak rate
# of their type, of one H100 SXM at 700 W
from vidtok_tpu_torch.tools import bound_ms

# Model sections, resolved, so no YAML parser is needed. The v1.0 KL 4x8x8
# 16-channel flagship (configs/vidtok_kl_causal_488_16chn.yaml, the model of
# bench.py), the v1.0 FSQ 4096 tokenizer (configs/vidtok_fsq_causal_488_4096
# .yaml) and the v1.1 KL 4x8x8 16-channel tokenizer
# (configs/v1_1/vidtok_kl_causal_488_16chn_v1_1.yaml).
_ENC = {"double_z": True, "z_channels": 16, "in_channels": 3, "out_ch": 3,
        "ch": 128, "num_res_blocks": 2, "dropout": 0.0,
        "use_checkpoint": False, "norm_type": "layernorm",
        "ch_mult": [1, 2, 4, 4], "time_downsample_factor": 4,
        "init_pad_mode": "replicate"}
_ENC_FSQ = dict(_ENC, double_z=False, z_channels=4)
_ENC_V1_1 = dict(_ENC, interpolation_mode="trilinear")


def _model(target: str, enc: str, dec: str, params: dict, reg: dict,
           **extra) -> dict:
    return {"model": {"target": target, "params": {
        "encoder_config": {"target": enc, "params": dict(params)},
        "decoder_config": {"target": dec, "params": dict(params)},
        "regularizer_config": reg, **extra}}}


V1_0_CFG = _model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                  _ENC, {"target": "DiagonalGaussianRegularizer"})
FSQ_CFG = _model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                 _ENC_FSQ, {"target": "FSQRegularizer", "params": {
        "levels": [8, 8, 8, 8], "entropy_loss_weight": 0.1,
        "entropy_loss_annealing_steps": 2000,
        "entropy_loss_annealing_factor": 3, "commitment_loss_weight": 0.25}})
V1_1_CFG = _model("AutoencodingEngineV1_1", "EncoderCausal3DV1_1",
                  "DecoderCausal3DV1_1", _ENC_V1_1,
                  {"target": "DiagonalGaussianRegularizer"},
                  use_tiling=False, t_chunk_enc=16)
REQUEST = (1, 3, 17, 256, 256)
LONG_REQUEST = (1, 3, 201, 256, 256)  # bench.py:46
N_REQUESTS = 3
# kernel -> (its source, the TPU kernel it replaces, the shared GEMM loop
# it is built on besides)
_WGMMA = ("vidtok_tpu_torch/csrc/wgmma_conv.cuh",)
_TEMPORAL = _WGMMA + ("vidtok_tpu_torch/csrc/temporal_block.cuh",)
SOURCES = {
    "fused_spatial_resblock": ("vidtok_tpu_torch/csrc/fused_spatial.cu",
                               "vidtok_tpu/ops/pallas/fused_spatial_v2.py:183", _WGMMA),
    "fused_temporal_resblock": ("vidtok_tpu_torch/csrc/fused_temporal.cu",
                                "vidtok_tpu/ops/pallas/fused_temporal.py:205", _TEMPORAL),
    "subpixel_interleave": ("vidtok_tpu_torch/csrc/subpixel.cu",
                            "vidtok_tpu/ops/pallas/subpixel_epilogue.py:100", ()),
    "decoder_tail_rgb": ("vidtok_tpu_torch/csrc/decoder_tail.cu",
                         "vidtok_tpu/ops/pallas/decoder_tail.py:245", ()),
    "parity_up2x_fused": ("vidtok_tpu_torch/csrc/parity_upsample.cu",
                          "vidtok_tpu/ops/pallas/parity_upsample_fused.py:108", _WGMMA),
    "fused_temporal_resblock_stream": (
        "vidtok_tpu_torch/csrc/fused_temporal_stream.cu",
        "vidtok_tpu/ops/pallas/fused_temporal.py:274", _TEMPORAL),
    "parity_blend_interleave": ("vidtok_tpu_torch/csrc/parity_blend.cu",
                                "vidtok_tpu/ops/pallas/upsample_epilogue.py:49", ()),
    "parity_blend_interleave4": ("vidtok_tpu_torch/csrc/parity_blend.cu",
                                 "vidtok_tpu/ops/pallas/upsample_epilogue.py:96", ()),
    "subpixel_interleave_z": ("vidtok_tpu_torch/csrc/subpixel.cu",
                              "vidtok_tpu/ops/pallas/subpixel_epilogue.py:57", ()),
    "decoder_tail_rgb_taps": ("vidtok_tpu_torch/csrc/decoder_tail.cu",
                              "vidtok_tpu/ops/pallas/decoder_tail.py:160", ()),
}
# The decoder's kernel forms, KernelForms(parity, subpixel, tail), served by
# phase 8 (v1.0) and by the tiled forms request of phase 7, with the path
# whose default-form run gives the same call shapes; and the kernel each
# non-default form runs in place of the default form's.
FORM_FIELDS = ("parity", "subpixel", "tail")
FORMS = {"v1_0_forms": (("merged", "merged", "taps"), "v1_0"),
         "v1_0_split": (("split", "split", "packed"), "v1_0"),
         "tiled_forms": (("fused", "merged", "taps"), "tiled")}
FORM_KERNEL = {("parity", "merged"): ("parity_up2x_fused", "parity_blend_interleave4"),
               ("parity", "split"): ("parity_up2x_fused", "parity_blend_interleave"),
               ("subpixel", "merged"): ("subpixel_interleave", "subpixel_interleave_z"),
               ("tail", "taps"): ("decoder_tail_rgb", "decoder_tail_rgb_taps")}


def form_swaps(path: str) -> dict:
    """{default-form kernel: the kernel that replaces it} on a FORMS path."""
    forms = FORMS[path][0]
    return dict(FORM_KERNEL[f, v] for f, v in zip(FORM_FIELDS, forms)
                if (f, v) in FORM_KERNEL)


def in_forms(per: dict, path: str) -> dict:
    """Launches per forward ``per`` of the default forms, moved to the
    kernels of the FORMS ``path``."""
    per = dict(per)
    for default, kernel in form_swaps(path).items():
        per[kernel], per[default] = per[default], 0
    return per


PER_FORWARD = {"v1_0": dict(dict.fromkeys(SOURCES, 0), fused_spatial_resblock=20,
                            fused_temporal_resblock=20, subpixel_interleave=3,
                            decoder_tail_rgb=1, parity_up2x_fused=2)}
PER_FORWARD["v1_1"] = dict(PER_FORWARD["v1_0"], parity_up2x_fused=0)
for _path in ("v1_0_forms", "v1_0_split"):
    PER_FORWARD[_path] = in_forms(PER_FORWARD["v1_0"], _path)
KERNEL_GATE = 1e-2
# a kernel, and the kernel path, vs the f32 plain run may be at most
# BF16_SLACK x as far from it as the plain version in bf16 is
BF16_SLACK = 1.1
FSQ_CODES = 4096
FSQ_DECODE_GATE = 1e-6

# Every call shape of each kernel in one forward of REQUEST (17 frames are
# padded to 20; v1.0 and v1.1 give the same shapes): spatial
# (N, H, W, Cin, C), temporal (B, T, H, W, C), subpixel (N, H, W, C), tail
# (B, T, H, W, C), parity upsample (B, T, H, W, C); with calls per forward.
# Stream-start modes: v1.0 serves ``zero``, v1.1 ``replicate``.
SPATIAL_SHAPES = [((20, 256, 256, 128, 128), 4), ((20, 128, 128, 128, 256), 1),
                  ((20, 128, 128, 256, 256), 1), ((10, 64, 64, 256, 512), 1),
                  ((10, 64, 64, 512, 512), 1), ((5, 32, 32, 512, 512), 5),
                  ((5, 64, 64, 512, 512), 3), ((10, 128, 128, 512, 256), 1),
                  ((10, 128, 128, 256, 256), 2), ((20, 256, 256, 256, 128), 1)]
TEMPORAL_SHAPES = [((1, 20, 256, 256, 128), 5), ((1, 20, 128, 128, 256), 2),
                   ((1, 10, 64, 64, 512), 2), ((1, 5, 32, 32, 512), 5),
                   ((1, 5, 64, 64, 512), 3), ((1, 10, 128, 128, 256), 3)]
SUBPIXEL_SHAPES = [((5, 32, 32, 512), 1), ((5, 64, 64, 512), 1),
                   ((10, 128, 128, 256), 1)]
TAIL_SHAPES = [((1, 20, 256, 256, 128), 1)]
PARITY_SHAPES = [((1, 5, 128, 128, 512), 1), ((1, 10, 256, 256, 256), 1)]
MODE_PATH = {"zero": "v1_0", "replicate": "v1_1"}
# kernel E's second call at T=201: the output has 3.42e9 elements; the
# window s[95:] gives output frames 192-203 once its first pair is dropped
PARITY_LONG = (1, 102, 256, 256, 256)
PARITY_WINDOW = 95
# kernel A's call at T=201 (204 frames) whose input has 3.42e9 elements;
# A is per frame, so its last SPATIAL_WINDOW frames are held against the
# plain version of those frames alone
SPATIAL_LONG = (204, 256, 256, 256, 128)
SPATIAL_WINDOW = 2
# Partial tiles: frames whose sides are not multiples of the tiles (33² is
# the latent of a 264² request), checked, not timed: A and F; F at both
# ``first_chunk`` values and cache offsets 1 and 4; B and E (the v1.0
# decoder's shapes at 264², and two clips) in both stream-start modes.
PARTIAL_SPATIAL = [(5, 33, 33, 512, 512), (10, 66, 66, 512, 512),
                   (20, 132, 132, 256, 256), (16, 264, 264, 128, 128)]
PARTIAL_TEMPORAL = [(1, 5, 33, 33, 512), (1, 20, 264, 264, 128)]
PARTIAL_OFFSETS = (1, 4)
PARTIAL_B = [(2, 5, 33, 33, 512), (1, 20, 264, 264, 128)]
PARTIAL_PARITY = [(2, 5, 33, 33, 512), (1, 10, 132, 132, 256)]
# kernels D and D' at partial patches (two clips of a 33² frame; the
# 264² frame of the v1.0 decoder), both modes
PARTIAL_TAIL = [(2, 6, 33, 33, 128), (1, 20, 264, 264, 128)]
# kernel D's tail call of a non-tiled T=201 v1.0 request (204 frames, 3.4 GB
# of input, in runs of frames that start with 2 warm-up frames): its last
# run's output frames against the plain version of those frames and the 2
# before them
TAIL_LONG = (1, 204, 256, 256, 128)
# one request at a 33² latent, tiled v1.1 and non-tiled v1.0, each held to
# its f32 plain run
PARTIAL_REQUEST = (1, 3, 17, 264, 264)
# kernel A's calls (no nin_shortcut) at which ``loop_rates`` reads the
# wgmma loop's rate and the row pass's share of its byte bound, at 128, 256
# and 512 channels; then B's at its two heaviest serving shapes and E's
LOOP_SHAPES = ((20, 256, 256, 128, 128), (10, 128, 128, 256, 256),
               (10, 64, 64, 512, 512))

# Tiled v1.1 serving (phase 7): 65 = 1 + 4 x 16 frames give 5 encoder and
# 5 decoder chunks (T' = 17); 201 is bench.py's length, whose last encoder
# chunk has 8 frames.
TILED_REQUEST = (1, 3, 65, 256, 256)
TILED_LONG = (1, 3, 201, 256, 256)
T_CHUNK_ENC = 16
TDF = 4
TILED_MEM_RATIO = 1.25
# The encoder is causal, so tiling leaves z as it is up to rounding. The
# decoder's trilinear upsample is not: its first chunk caches its last ntu
# frames, which with overlap are look-ahead frames, computed there from
# edge-clamped interpolation (vidtok_tpu blocks.py:538-553, mirrored), so
# the tiled decode departs from the non-tiled one in JAX too. At this
# configuration and seed the departure is 1.2e-4 (PERF.md); the gate leaves
# room for it, and the kernel path is also held to the tiled f32 run.
TILED_Z_GATE = 1e-4
TILED_RECON_GATE = 1e-3
PATHS = ("v1_0", "v1_1", "tiled") + tuple(FORMS)

# the path whose serving run gives each kernel's launches and times in the
# result line
MAIN_PATH = dict.fromkeys(SOURCES, "v1_0")
MAIN_PATH.update(fused_temporal_resblock_stream="tiled",
                 parity_blend_interleave="v1_0_split",
                 parity_blend_interleave4="v1_0_forms",
                 subpixel_interleave_z="v1_0_forms",
                 decoder_tail_rgb_taps="v1_0_forms")

# The tools' kernels (vidtok_tpu_torch/tools), run by the tools' mains, not
# by a serving path: T1-T3 at the temporal microbenchmark's default shape
# and at kernel B's heaviest serving shape, T4 at the SiLU probe's. Each
# kernel's entry in the result line takes its numbers from the named row of
# its tool at the first shape, and lists every row.
TOOL_SOURCES = {
    "fused_fat": ("vidtok_tpu_torch/csrc/microbench_temporal.cu",
                  "tools/microbench_temporal.py:53", "v1 fat", _WGMMA),
    "fused_diag": ("vidtok_tpu_torch/csrc/microbench_temporal.cu",
                   "tools/microbench_temporal.py:102", "v2 mm-only", _WGMMA),
    "copy_min": ("vidtok_tpu_torch/csrc/microbench_temporal.cu",
                 "tools/microbench_temporal.py:130", "copy min128", ()),
    "silu_probe": ("vidtok_tpu_torch/csrc/probe_silu.cu", "tools/probe_silu_bf16.py:48",
                   "f32_logistic", ()),
}
TOOL_SHAPES = ((1, 9, 64, 64, 512), TEMPORAL_SHAPES[0][0])
# T1 and T2's mm and ln also at two clips of 33 x 33 (S = 1089, not a
# multiple of the loop's 128-row tiles, so M tiles straddle frames): checked,
# not timed
TOOL_PARTIAL = (2, 5, 33, 33, 256)
TOOL_PARTIAL_ROWS = ("v1 fat", "v2 mm-only", "v3 ln-only")
# the microbenchmark's [C T S] for each of TOOL_SHAPES (the first is its default)
TOOL_RUNS = tuple([str(c), str(t), str(h)] for _, t, h, _, c in TOOL_SHAPES)
SILU_SHAPE = (64, 512, 512)
# T4's bf16 forms against their plain version, value by value. Both compute
# y = x * s(x) in bf16 steps; tanh.approx.bf16x2 and the bf16 exp and
# reciprocal may land one grid step of s away from torch's correctly
# rounded steps. So a difference is counted in units of |x| times s's grid
# step at that x, plus one ulp of the plain output: bf16_tanh's s is
# (1 + t) / 2 with t = tanh(x / 2) in bf16, whose step is max(ulp(t),
# ulp(1 + t)) / 2 (near t = -1 the sum is exact and t's own last place
# limits it); bf16_logistic's steps carry no cancellation, so its unit is
# one ulp of the output alone. The bound, in those units: one step of s,
# plus the rounding of y on both sides (half an ulp of y each, k's ulp up
# to twice p's where they straddle a power of 2). It catches bf16_tanh
# wrong by one more step of s wherever its s is 2 or more steps from 0,
# so a zero output for x < -4.5 (PERF.md).
SILU_UNITS = 1.5


def _cut(n: int, chunk: int):
    """``VideoTokenizer.build_chunk_start_end``: [0, 1], then ``chunk``
    frames at a time."""
    se = [(0, 1)]
    while se[-1][1] < n:
        se.append((se[-1][1], min(n, se[-1][1] + chunk)))
    return se


def chunk_schedule(t: int):
    """A tiled, overlapped forward of ``t`` frames: frames per encoder
    chunk (the first is frame 0 padded to TDF) and latent frames per
    decoder chunk (one look-ahead frame on each but the last)."""
    enc = [TDF] + [e - s for s, e in _cut(t, T_CHUNK_ENC)[1:]]
    t_lat = sum(f // TDF for f in enc)
    dec = [e - s + (e + 1 <= t_lat) for s, e in _cut(t_lat, T_CHUNK_ENC // TDF)]
    return enc, dec


def tiled_calls(t: int, size: int = 256) -> Counter:
    """Kernel calls of one tiled forward of a [1, 3, t, size, size] clip,
    by (kernel, call key); with s = size: per encoder chunk of f frames, 2
    spatial and 2 temporal blocks at each of the levels (f, s², 128),
    (f, (s/2)², 256), (f/2, (s/4)², 512), (f/4, (s/8)², 512). Per decoder
    chunk of n latents: 3 of each at (n, (s/8)², 512), (n, (s/4)², 512),
    (2n, (s/2)², 256), (4n, s², 128) with cache offsets 1, 1, 2, 4; a
    spatial upsample after each of the first three; the tail on 4n + 2
    frames (2 cached)."""
    enc, dec = chunk_schedule(t)
    s2, s4, s8 = size // 2, size // 4, size // 8
    calls = Counter()
    for i, f in enumerate(enc):
        for n, hw, cin, c in ((f, size, 128, 128), (f, s2, 128, 256),
                              (f // 2, s4, 256, 512), (f // 4, s8, 512, 512)):
            calls["fused_spatial_resblock", (n, hw, hw, cin, c)] += 1
            calls["fused_spatial_resblock", (n, hw, hw, c, c)] += 1
            calls["fused_temporal_resblock_stream", ((1, n, hw, hw, c), i == 0, 0)] += 2
    for i, n in enumerate(dec):
        for frames, hw, cin, c, off in ((n, s8, 512, 512, 1), (n, s4, 512, 512, 1),
                                        (2 * n, s2, 512, 256, 2),
                                        (4 * n, size, 256, 128, 4)):
            calls["fused_spatial_resblock", (frames, hw, hw, cin, c)] += 1
            calls["fused_spatial_resblock", (frames, hw, hw, c, c)] += 2
            calls["fused_temporal_resblock_stream",
                  ((1, frames, hw, hw, c), i == 0, off)] += 3
            if hw < size:
                calls["subpixel_interleave", (frames, hw, hw, c)] += 1
        calls["decoder_tail_rgb", ((1, 4 * n + 2, size, size, 128), "replicate")] += 1
    return calls


def long_spatial_shapes() -> list:
    """Kernel A's call shapes and calls in one non-tiled v1.0 forward of
    LONG_REQUEST: SPATIAL_SHAPES with their frames scaled from REQUEST's 20
    (17 padded by TDF - 1) to LONG_REQUEST's 204."""
    frames, long_frames = REQUEST[2] + TDF - 1, LONG_REQUEST[2] + TDF - 1
    return [((k[0] * long_frames // frames,) + k[1:], calls)
            for k, calls in SPATIAL_SHAPES]


def tiled_per_forward(t: int, size: int = 256) -> dict:
    """Launches per tiled forward, summed from ``tiled_calls`` and checked
    against the formula: with E encoder and D decoder chunks, F = A =
    8E + 12D, C = 3D, D's tail D, B = E's kernel = 0 (T=65: 100, 100, 15,
    5, 0, 0)."""
    per = dict.fromkeys(SOURCES, 0)
    for (name, _), n in tiled_calls(t, size).items():
        per[name] += n
    n_enc, n_dec = map(len, chunk_schedule(t))
    want = dict(per, fused_temporal_resblock_stream=8 * n_enc + 12 * n_dec,
                fused_spatial_resblock=8 * n_enc + 12 * n_dec,
                subpixel_interleave=3 * n_dec, decoder_tail_rgb=n_dec,
                fused_temporal_resblock=0, parity_up2x_fused=0)
    if per != want:
        raise AssertionError(f"tiled launches {per} != formula {want}")
    return per


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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


def _nel(*shapes) -> int:
    return sum(int(np.prod(s)) for s in shapes)


def work(name: str, key) -> tuple:
    """(bytes, tensor-core FLOP, other FLOP) one call must move and do:
    each bf16 input read once, each output written once, the f32
    parameters read once; the FLOP of the function (E: the three base 3x3
    convs of each input frame, 27 C^2 MACs per half-rate position, which
    give both output frames as ``parity_up2x_fused_plain`` computes them,
    not E's own 36 C^2 nor a 3x3x3 conv at the output rate, 54 C^2; D and
    D': the 3-channel conv, not D''s products padded to 8 channels)."""
    if name == "fused_spatial_resblock":
        n, h, w, cin, c = key
        m, k = n * h * w, 9 * cin * c + 9 * c * c + (cin * c if cin != c else 0)
        return 2 * m * (cin + c) + 4 * (k + 2 * cin + 5 * c), 2 * m * k, 0
    if name in ("fused_temporal_resblock", "fused_temporal_resblock_stream"):
        (b, t, h, w, c), first = key[0], key[1]
        m = b * t * h * w
        caches = 0 if name == "fused_temporal_resblock" else (2 if first else 4)
        return (2 * (2 * m * c + caches * b * 2 * h * w * c)
                + 4 * (6 * c * c + 6 * c), 12 * m * c * c, 0)
    if name in ("subpixel_interleave", "subpixel_interleave_z"):
        # I: the 4HWC of z it needs (z holds 4(H+1)(W+1)C)
        n, h, w, c = key
        return 2 * 8 * n * h * w * c + 4 * c, 0, 4 * n * h * w * c
    if name in ("parity_blend_interleave", "parity_blend_interleave4"):
        # s, the cur and prev halves (4C) read, 2C written; 5 FLOP a value
        b, t, h, w, c = key[0]
        m = b * t * h * w
        return 2 * 7 * m * c + 4 * (c + 1), 0, 5 * 2 * m * c
    if name in ("decoder_tail_rgb", "decoder_tail_rgb_taps"):
        b, t, h, w, c = key[0]
        m = b * t * h * w
        return 2 * m * (c + 3) + 4 * (2 * c + 81 * c + 3), 2 * m * 81 * c, 0
    b, t, h, w, c = key[0]  # parity_up2x_fused
    m = b * t * h * w
    return 2 * 3 * m * c + 4 * (27 * c * c + c + 1), 2 * m * 27 * c * c, 0


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
    for (name, key), calls in tiled.items():
        shapes[name][key]["tiled"] = calls
        if name == "fused_temporal_resblock_stream":
            shapes[name][key[0], not key[1], key[2]].setdefault("tiled", 0)

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
    for shape, calls in TEMPORAL_SHAPES:
        c = shape[-1]
        for mode, path in MODE_PATH.items():
            args = (p.x(shape, bf), p.norm(c), p.conv((c, c, 3)), p.norm(c),
                    p.conv((c, c, 3)), mode)
            yield Case("fused_temporal_resblock", (shape, mode), {path: calls},
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
    for shape, calls in PARITY_SHAPES:
        b, t, h, w, c = shape
        for mode in MODE_PATH:
            # v1.0 serves zero mode; replicate is checked, not timed
            calls_e = {"v1_0": calls if mode == "zero" else 0}
            args = (p.x(shape, bf), *p.conv((c, c, 3, 3, 3)),
                    p.t(1 / (1 + np.exp(-(2.0 + 0.5 * p.rng.randn(1))))), mode)
            yield Case("parity_up2x_fused", (shape, mode), calls_e,
                       pu.parity_up2x_fused, pu.parity_up2x_fused_plain, args)
            # G and H on E's s, bias and alpha, with the parity convs'
            # outputs drawn as activations
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
    for shape in PARTIAL_TAIL:
        c = shape[-1]
        for mode in MODE_PATH:
            args = (r.x(shape, bf), r.norm(c), r.conv((3, c, 3, 3, 3)), mode)
            yield Case("decoder_tail_rgb", (shape, mode), {}, decoder_tail.decoder_tail_rgb,
                       decoder_tail.decoder_tail_rgb_plain, args)
            yield Case("decoder_tail_rgb_taps", (shape, mode), {},
                       decoder_tail.decoder_tail_rgb_taps,
                       decoder_tail.decoder_tail_rgb_taps_plain, args)


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


def _outs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def check_kernels(device, names=None) -> dict:
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
    """
    import torch

    sums = ("ms", "plain_ms", "convs_ms", "bound_ms", "bound_by_bytes_ms",
            "bound_by_ops_ms")
    results, failed = {}, []
    for case in kernel_cases(device):
        name, args = case.name, case.args
        if names is not None and name not in names:
            continue
        out = _outs(case.kernel(*args))
        ref = _outs(case.plain(*f32(args)))
        plain_bf16 = _outs(case.plain(*args))
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
            ms = cuda_ms(lambda: case.kernel(*args))
            plain_ms = cuda_ms(lambda: case.plain(*args))
            if case.convs is not None:
                convs_ms = cuda_ms(case.convs)
        bound, by = bound_ms(*work(name, case.key))
        print(f"kernel {name} {case.key}: max_abs_err "
              + "/".join(f"{e:.4g}" for e in errs) + " rel_l2 "
              + "/".join(f"{r:.4g}" for r in rels) + " plain_bf16_rel_l2 "
              + "/".join(f"{r:.4g}" for r in plain_rels)
              + f" kernel_ms {ms:.4f} plain_bf16_ms {plain_ms:.4f} cudnn_convs_ms "
              f"{convs_ms:.4f} bound_ms {bound:.4f} ({by}) calls/forward "
              f"{case.calls}", flush=True)
        for i, (rel, plain_rel) in enumerate(zip(rels, plain_rels)):
            try:
                gate(f"{name}{case.key} output {i}", rel, plain_rel)
            except AssertionError as e:
                print(f"GATE FAILED {e}", flush=True)
                failed.append(str(e))
        r = results.setdefault(name, dict(
            max_abs_err=0.0, max_rel_l2=0.0,
            **{k: dict.fromkeys(PATHS, 0.0) for k in sums}))
        r["max_abs_err"] = max(r["max_abs_err"], *errs)
        r["max_rel_l2"] = max(r["max_rel_l2"], *rels)
        part = "bound_by_bytes_ms" if by == "bytes" else "bound_by_ops_ms"
        for path, n in case.calls.items():
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("convs_ms", convs_ms),
                         ("bound_ms", bound), (part, bound)):
                r[k][path] += n * v
        del out, ref, plain_bf16, args, case
    for name, r in results.items():
        print(f"kernel {name} per forward: " + "; ".join(
            f"{path} " + " ".join(f"{k} {r[k][path]:.4f}" for k in sums)
            for path in PATHS if r["bound_ms"][path]), flush=True)
    if failed:
        raise AssertionError(f"{len(failed)} kernel gates failed:\n" + "\n".join(failed))
    return results


def check_parity_long(device) -> None:
    """Kernel E at PARITY_LONG, zero mode: its output frames 192-203 (past
    2^31 elements) against the plain version of the window s[95:] with the
    first output pair dropped, in f32 and in bf16; E's time at this shape."""
    import torch

    from vidtok_tpu_torch.ops.kernels import parity_upsample as pu

    b, t, h, w, c = PARITY_LONG
    p = Params(1, device)
    weight, bias = p.conv((c, c, 3, 3, 3))
    alpha = p.t([0.88])
    g = torch.Generator(device).manual_seed(1)
    s = torch.randn(PARITY_LONG, generator=g, device=device, dtype=torch.bfloat16)
    out = pu.parity_up2x_fused(s, weight, bias, alpha, "zero")
    win = s[:, PARITY_WINDOW:].contiguous()
    ref = pu.parity_up2x_fused_plain(win.float(), weight, bias, alpha, "zero")[:, 2:]
    plain_bf16 = pu.parity_up2x_fused_plain(win, weight, bias, alpha, "zero")[:, 2:]
    got = out[:, 2 * (PARITY_WINDOW + 1):].float()
    torch.cuda.synchronize()
    if out.shape != (b, 2 * t, h, w, c) or got.shape != ref.shape:
        raise AssertionError(f"parity long: {tuple(out.shape)}, window "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    rel, plain_rel = rel_l2(got, ref), rel_l2(plain_bf16.float(), ref)
    del out, got, ref, plain_bf16, win
    ms = cuda_ms(lambda: pu.parity_up2x_fused(s, weight, bias, alpha, "zero"),
                 warmup=1, iters=3)
    print(f"kernel parity_up2x_fused {PARITY_LONG} zero, output frames "
          f"{2 * (PARITY_WINDOW + 1)}-{2 * t - 1} (past 2^31 elements): rel_l2 "
          f"{rel:.4g} plain_bf16_rel_l2 {plain_rel:.4g} kernel_ms {ms:.4f} "
          "(plain not timed at this shape)", flush=True)
    gate(f"parity_up2x_fused{PARITY_LONG} window", rel, plain_rel)


def check_spatial_long(device) -> None:
    """Kernel A at SPATIAL_LONG with its nin_shortcut (an input of 3.42e9
    elements): its last SPATIAL_WINDOW frames against the plain version of
    those input frames, in f32 and in bf16; A's time at this shape."""
    import torch

    from vidtok_tpu_torch.ops.kernels import fused_spatial as fs

    n, h, w, cin, c = SPATIAL_LONG
    p = Params(6, device)
    params = (p.norm(cin), p.conv((c, cin, 3, 3)), p.norm(c), p.conv((c, c, 3, 3)),
              p.conv((c, cin, 1, 1)))
    x = p.x((n, h, w, cin), torch.bfloat16)
    out = fs.fused_spatial_resblock(x, *params)
    got = out[-SPATIAL_WINDOW:].float()
    win = x[-SPATIAL_WINDOW:]
    ref = fs.fused_spatial_resblock_plain(win.float(), *params)
    plain_bf16 = fs.fused_spatial_resblock_plain(win, *params)
    torch.cuda.synchronize()
    if out.shape != (n, h, w, c) or got.shape != ref.shape:
        raise AssertionError(f"spatial long: {tuple(out.shape)}, window "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    rel, plain_rel = rel_l2(got, ref), rel_l2(plain_bf16.float(), ref)
    del out, got, ref, plain_bf16, win
    ms = cuda_ms(lambda: fs.fused_spatial_resblock(x, *params), warmup=1, iters=3)
    print(f"kernel fused_spatial_resblock {SPATIAL_LONG} nin, frames {n - SPATIAL_WINDOW}-"
          f"{n - 1} (input past 2^31 elements): rel_l2 {rel:.4g} plain_bf16_rel_l2 "
          f"{plain_rel:.4g} kernel_ms {ms:.4f} (plain not timed at this shape)", flush=True)
    gate(f"fused_spatial_resblock{SPATIAL_LONG} window", rel, plain_rel)


def check_tail_long(device) -> None:
    """Kernel D at TAIL_LONG, zero mode (its input 3.4 GB, in runs of frames
    that start with warm-up frames): the output frames of its last run
    against the plain version of the input window that holds them and the
    two warm-up frames before, whose outputs are dropped, in f32 and in
    bf16; D's time at this shape."""
    import torch

    from vidtok_tpu_torch.ops.kernels import decoder_tail, plan

    b, t, h, w, c = TAIL_LONG
    pl = plan.tail_plan(*TAIL_LONG)
    p = Params(8, device)
    params = (p.norm(c), p.conv((3, c, 3, 3, 3)), "zero")
    x = p.x(TAIL_LONG, torch.bfloat16)
    out = decoder_tail.decoder_tail_rgb(x, *params)
    t0 = (pl.runs - 1) * pl.run  # the last run's first output frame
    s0 = max(t0 - 2, 0)
    win = x[:, s0:]
    ref = decoder_tail.decoder_tail_rgb_plain(win.float(), *params)[:, t0 - s0:]
    plain_bf16 = decoder_tail.decoder_tail_rgb_plain(win, *params)[:, t0 - s0:]
    got = out[:, t0:].float()
    torch.cuda.synchronize()
    if out.shape != (b, t, h, w, 3) or got.shape != ref.shape:
        raise AssertionError(f"tail long: {tuple(out.shape)}, window "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    rel, plain_rel = rel_l2(got, ref), rel_l2(plain_bf16.float(), ref)
    del out, got, ref, plain_bf16, win
    ms = cuda_ms(lambda: decoder_tail.decoder_tail_rgb(x, *params), warmup=1, iters=3)
    print(f"kernel decoder_tail_rgb {TAIL_LONG} zero, output frames {t0}-{t - 1} "
          f"(the last of {pl.runs} runs of {pl.run} frames): rel_l2 {rel:.4g} "
          f"plain_bf16_rel_l2 {plain_rel:.4g} kernel_ms {ms:.4f} (plain not timed at "
          "this shape)", flush=True)
    gate(f"decoder_tail_rgb{TAIL_LONG} window", rel, plain_rel)


def loop_rates(device) -> None:
    """The wgmma loop inside the kernels that run it with row passes or an
    epilogue of their own, 5 calls each under torch.profiler after a
    warm-up: the device time per call of the GEMM launches
    (``wg::conv_kernel``) and of the row passes (``act_rows_kernel``), the
    mean of the launches the trace recorded times the launches of a call
    (a trace may miss some, which a sum over 5 calls would count as time
    not spent: the recorded counts are printed beside); the
    GEMMs' rate, each kernel's own GEMM FLOP over their time, and the row
    passes' share of their byte bound (what they read and write, bf16, over
    3.35 TB/s). Kernel A at LOOP_SHAPES: 2 * 2 * M * 9 * C^2 FLOP, two
    passes reading and writing M * C. Kernel B at TEMPORAL_SHAPES[0] and
    [1], zero mode: 2 * 2 * M * 3 * C^2 FLOP, two passes reading M * C and
    writing the scratch, B * (T + 2) * H * W * C (the 2-frame front
    included). Kernel E at PARITY_SHAPES, zero mode: its own products,
    2 * M * 18C * 2C FLOP (not the 27 C^2 MACs of ``work``), no row
    pass. Kernels D and D' at TAIL_SHAPES, zero mode: one launch
    (``tail_kernel``) a call, and its share of the call's byte bound
    (``work``: x read once, the RGB output written once). The tools' T1
    and T2 ``mm`` at TOOL_SHAPES: 2 * 2 * M * 3 * C^2 FLOP (T1's over the
    explicit [M, 3C] operand), and T1's two fat-row passes
    (``fat_rows_kernel``), reading x (bf16) and h (f32) and writing the fat
    operand (bf16, 3C a row): 18 * M * C bytes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vidtok_tpu_torch.ops.kernels import decoder_tail as dt
    from vidtok_tpu_torch.ops.kernels import fused_spatial as fs
    from vidtok_tpu_torch.ops.kernels import fused_temporal as ft
    from vidtok_tpu_torch.ops.kernels import parity_upsample as pu
    from vidtok_tpu_torch.tools import PEAK_BYTES
    from vidtok_tpu_torch.tools import microbench_temporal as tm

    bf = torch.bfloat16
    p = Params(7, device)
    iters = 5

    def runs():
        # (kernel, key, call, GEMM FLOP, bytes of the row passes or of the
        # tail, launches per call of each part)
        for key in LOOP_SHAPES:
            n, h, w, _, c = key
            m = n * h * w
            args = (p.x((n, h, w, c), bf), p.norm(c), p.conv((c, c, 3, 3)),
                    p.norm(c), p.conv((c, c, 3, 3)), None)
            yield ("A", key, lambda args=args: fs.fused_spatial_resblock(*args),
                   2 * 2 * m * 9 * c * c, 2 * 2 * m * c * 2, {"gemm": 2, "rows": 2})
        for key, _ in TEMPORAL_SHAPES[:2]:
            b, t, h, w, c = key
            m = b * t * h * w
            args = (p.x(key, bf), p.norm(c), p.conv((c, c, 3)), p.norm(c),
                    p.conv((c, c, 3)), "zero")
            yield ("B", key, lambda args=args: ft.fused_temporal_resblock(*args),
                   2 * 2 * m * 3 * c * c, 2 * (m + b * (t + 2) * h * w) * c * 2,
                   {"gemm": 2, "rows": 2})
        for key, _ in PARITY_SHAPES:
            b, t, h, w, c = key
            args = (p.x(key, bf), *p.conv((c, c, 3, 3, 3)), p.t([0.88]), "zero")
            yield ("E", key, lambda args=args: pu.parity_up2x_fused(*args),
                   2 * (b * t * h * w) * 18 * c * 2 * c, 0, {"gemm": 1})
        for key, _ in TAIL_SHAPES:
            c = key[-1]
            args = (p.x(key, bf), p.norm(c), p.conv((3, c, 3, 3, 3)), "zero")
            nbytes = work("decoder_tail_rgb", (key, "zero"))[0]
            yield ("D", key, lambda args=args: dt.decoder_tail_rgb(*args), 0, nbytes,
                   {"tail": 1})
            yield ("D'", key, lambda args=args: dt.decoder_tail_rgb_taps(*args), 0, nbytes,
                   {"tail": 1})
        for key in TOOL_SHAPES:
            b, t, h, w, c = key
            m = b * t * h * w
            x = p.x(key, bf)
            params = {"norm1": p.norm(c), "conv1": p.conv((c, c, 3)),
                      "norm2": p.norm(c), "conv2": p.conv((c, c, 3))}
            yield ("T1", key, lambda x=x, params=params: tm.fused_fat(x, params),
                   tm.block_flops(key), 18 * m * c, {"gemm": 2, "rows": 2})
            yield ("T2 mm", key, lambda x=x, params=params: tm.fused_diag(x, params, "mm"),
                   tm.block_flops(key), 0, {"gemm": 2})
            del x, params

    for kernel, key, call, flop, nbytes, per_call in runs():
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        total, count = defaultdict(float), Counter()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                part = ("gemm" if "wg::conv_kernel" in e.key else
                        "rows" if "_rows_kernel" in e.key else  # act_rows, fat_rows
                        "tail" if "tail_kernel" in e.key else "other")
                total[part] += e.self_device_time_total / 1e3
                count[part] += e.count
        if any(not count[part] for part in per_call):
            print(f"loop {kernel} {key}: no device time recorded (not measured)",
                  flush=True)
            continue
        ms = {part: total[part] / count[part] * n for part, n in per_call.items()}
        seen = ", ".join(f"{part} {count[part]} of {iters * n}"
                         for part, n in per_call.items())
        parts = []
        if "gemm" in per_call:
            parts.append(f"gemm {ms['gemm']:.4f} ms/call "
                         f"({flop / ms['gemm'] / 1e9:.1f} TFLOP/s)")
        for part, label in (("rows", "row passes"), ("tail", "tail")):
            if part in per_call:
                parts.append(f"{label} {ms[part]:.4f} ms/call "
                             f"({nbytes / PEAK_BYTES * 1e3 / ms[part]:.3f} of the byte bound)")
        if per_call.keys() == {"gemm"}:
            parts.append("no row pass")
        print(f"loop {kernel} {key}: {', '.join(parts)}; launches recorded: {seen}",
              flush=True)


def randomize_(core, seed: int) -> None:
    """Seeded random weights that exercise every parameter: kaiming-uniform
    convs (the temporal conv2 included, which init leaves at zero), norm
    scales 1 +- 0.1 and non-zero norm biases, mix factors around 2."""
    import torch
    from torch import nn

    from vidtok_tpu_torch.models.autoencoder import reset_params_
    from vidtok_tpu_torch.modules.conv import CausalConv1d, reset_conv_

    g = torch.Generator().manual_seed(seed)
    reset_params_(core, g)

    def randn(p, scale, mean=0.0):
        p.copy_(mean + scale * torch.randn(p.shape, generator=g))

    with torch.no_grad():
        for m in core.modules():
            if isinstance(m, CausalConv1d) and m.zero_init:
                reset_conv_(m.conv.weight, m.conv.bias, g)
            elif isinstance(m, nn.LayerNorm):
                randn(m.weight, 0.1, 1.0)
                randn(m.bias, 0.1)
            if isinstance(getattr(m, "mix_factor", None), nn.Parameter):
                randn(m.mix_factor, 0.5, 2.0)


def serve(tok, n_requests: int, shape, per_forward: dict) -> dict:
    """Answer ``n_requests`` requests; host-clock latency per request ending
    in ``torch.cuda.synchronize()``; each forward must launch the kernels
    ``per_forward`` times. The counts are set to 0 before the first request
    and returned as ``launches``; ``last`` is (x, z, x_rec, reg_log) of the
    last request."""
    import torch

    from vidtok_tpu_torch.ops import kernels

    z_ch = tok.core.decoder.conv_in.conv.in_channels
    loss = "aux_loss" if tok.meta["discrete"] else "kl_loss"
    reqs = [np.clip(np.random.RandomState(1 + i).randn(*shape) * 0.5, -1, 1)
            .astype(np.float32) for i in range(n_requests)]
    torch.cuda.reset_peak_memory_stats()
    lat = []
    kernels.reset_counts()
    for x in reqs:
        before = kernels.counts()
        t0 = time.perf_counter()
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        after = kernels.counts()
        per = {k: after[k] - before[k] for k in after}
        if per != per_forward:
            raise AssertionError(f"launches per forward {per} != {per_forward}")
        t_lat = shape[2] // 4 + (shape[2] % 4 > 0)
        if (tuple(dec.shape) != tuple(shape)
                or tuple(z.shape) != (shape[0], z_ch, t_lat, shape[3] // 8,
                                      shape[4] // 8)):
            raise AssertionError(f"shapes z {tuple(z.shape)} dec {tuple(dec.shape)}")
        if not (torch.isfinite(z).all() and torch.isfinite(dec).all()
                and torch.isfinite(log[loss])):
            raise AssertionError("non-finite output")
    launches = kernels.counts()
    steady = min(lat[1:]) if len(lat) > 1 else lat[0]
    return dict(latency_s=lat, launches=launches,
                frames_per_s=shape[0] * shape[2] / steady,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                last=(x, z, dec, log))


def report(what: str, r: dict, shape) -> None:
    print(f"serve {what}; request {list(shape)} bf16; latency_s "
          + " ".join(f"{v:.4f}" for v in r["latency_s"])
          + f"; frames_per_s (best after the first) {r['frames_per_s']:.2f};"
          f" peak_mem_bytes {r['peak_mem_bytes']}; launches {r['launches']}",
          flush=True)


def profile_request(tok, shape) -> None:
    """Device time by kernel over one request (torch.profiler), and the
    device's busy share of the request's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = np.zeros(shape, np.float32)
    tok(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print("profile: no device time recorded (not measured)", flush=True)
        return
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    kernels_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile: wall {wall_ms:.2f} ms, device kernels {kernels_ms:.2f} ms "
          f"(busy share {kernels_ms / wall_ms:.3f})", flush=True)
    for e in rows[:12]:
        print(f"profile: {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:100]}", flush=True)


def kernel_forms(path: str = None):
    """The ``KernelForms`` of a FORMS path; the default forms for None."""
    from vidtok_tpu_torch import KernelForms

    return KernelForms() if path is None else KernelForms(*FORMS[path][0])


def e2e_check(core, meta, shape, path: str, kernels=("kernel",)) -> dict:
    """The kernel path against the plain path, in bf16 and in f32.

    Two bf16 evaluations of this 60-block network differ by 2-3% relative
    L2 whatever the kernels do (bf16 rounding accumulated through the
    residual stream), so the kernel path is held to the plain bf16 path's
    own distance from the f32 plain run: it must be no further from f32
    than the plain bf16 path is (x BF16_SLACK), on z and on the
    reconstruction. The kernel path's distance from the plain bf16 path is
    printed beside it. ``kernels`` names the kernel-path runs: ``kernel``
    in the default forms, whose launches must be PER_FORWARD[path], or a
    FORMS path in its forms, with its own.
    """
    import torch

    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer
    from vidtok_tpu_torch.ops import kernels as K

    x = np.clip(np.random.RandomState(100).randn(*shape) * 0.5, -1, 1) \
        .astype(np.float32)
    outs = {}
    runs = [(key, torch.bfloat16, True, None if key == "kernel" else key)
            for key in kernels]
    for key, dtype, fused, forms in runs + [("plain", torch.bfloat16, False, None),
                                            ("plain_f32", torch.float32, False, None)]:
        K.reset_counts()
        z, dec, log = VideoTokenizer(core, meta, dtype, fused=fused,
                                     forms=kernel_forms(forms))(x)
        torch.cuda.synchronize()
        want = PER_FORWARD[forms or path] if fused else dict.fromkeys(K.WRAPPERS, 0)
        if K.counts() != want:
            raise AssertionError(f"e2e {list(shape)} {key}: launches {K.counts()} "
                                 f"!= {want}")
        for t in (z, dec, log["kl_loss"]):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{key}: non-finite output")
        outs[key] = (z, dec)
    res = {}
    for i, what in enumerate(("z", "recon")):
        for key in kernels:
            res[f"{what}_{key}_vs_plain"] = rel_l2(outs[key][i], outs["plain"][i])
            res[f"{what}_{key}_vs_f32"] = rel_l2(outs[key][i], outs["plain_f32"][i])
        res[f"{what}_plain_vs_f32"] = rel_l2(outs["plain"][i], outs["plain_f32"][i])
    print(f"e2e {list(shape)} rel_l2 " + json.dumps(res), flush=True)
    for what in ("z", "recon"):
        p_f32 = res[f"{what}_plain_vs_f32"]
        for key in kernels:
            k_f32 = res[f"{what}_{key}_vs_f32"]
            if not k_f32 <= BF16_SLACK * p_f32:
                raise AssertionError(
                    f"e2e {what}: {key} vs f32 {k_f32} > {BF16_SLACK} x plain "
                    f"bf16 vs f32 {p_f32}")
    return res


def make_tokenizer(cfg: dict, device, seed: int = 0):
    """A full-width engine with ``randomize_`` weights, built on the CPU
    and moved to ``device``, bf16 compute, the kernel path on."""
    import torch

    from vidtok_tpu_torch import load_model_from_config
    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer

    tok = load_model_from_config(cfg, seed=seed, device="cpu",
                                 compute_dtype=torch.bfloat16)
    randomize_(tok.core, seed=seed)
    return VideoTokenizer(tok.core.to(device), tok.meta, torch.bfloat16,
                          fused=True)


def serve_both_paths(name: str, cfg: dict, path: str, device) -> dict:
    """Phases 3 and 6: N_REQUESTS requests on the kernel path, then on the
    plain path, a profile of one kernel-path request and the end-to-end
    gate. Returns the kernel path's ``serve`` result."""
    tok = make_tokenizer(cfg, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    per = PER_FORWARD[path]
    runs = {}
    for label, fused, want in (("kernel path", True, per),
                               ("plain path", False, dict.fromkeys(per, 0))):
        tok.fused = fused
        runs[label] = serve(tok, N_REQUESTS, REQUEST, want)
        report(f"{label}: {name}, {n_params} params", runs[label], REQUEST)
    k = runs["kernel path"]
    for kernel, n in k["launches"].items():
        if n != N_REQUESTS * per[kernel]:
            raise AssertionError(f"{kernel}: {n} launches in the serving run")
    tok.fused = True
    profile_request(tok, REQUEST)
    e2e_check(tok.core, tok.meta, REQUEST, path)
    if path == "v1_0":
        # a 33² latent: partial tiles in A, B, C, D and E
        e2e_check(tok.core, tok.meta, PARTIAL_REQUEST, path)
    return k


def serve_long_clip(device) -> None:
    """Phase 4: one LONG_REQUEST through the v1.0 kernel path, after one
    warm-up request of the same shape."""
    tok = make_tokenizer(V1_0_CFG, device)
    r = serve(tok, 2, LONG_REQUEST, PER_FORWARD["v1_0"])
    report("long clip, kernel path: v1.0 kl 4x8x8 16chn (request 1 is the "
           "warm-up)", r, LONG_REQUEST)


def check_fsq(device) -> None:
    """Phase 5: N_REQUESTS requests through the v1.0 FSQ 4096 kernel path
    (the first pays cuDNN's algorithm search, so the latency to compare is
    the best after it); on the last, integer indices in [0, 4096) of the
    latent's shape, ``indices_to_latent`` equal to the quantized z,
    decoding from indices equal to the reconstruction (relative L2 <=
    FSQ_DECODE_GATE), a finite ``aux_loss``."""
    import torch

    tok = make_tokenizer(FSQ_CFG, device)
    r = serve(tok, N_REQUESTS, REQUEST, PER_FORWARD["v1_0"])
    report("fsq 4096, kernel path: v1.0 fsq 4x8x8 4096 codes", r, REQUEST)
    x, z, dec, log = r["last"]
    idx = log["indices"]
    want = (REQUEST[0], z.shape[2], REQUEST[3] // 8, REQUEST[4] // 8)
    if (idx.dtype not in (torch.int32, torch.int64) or tuple(idx.shape) != want
            or int(idx.min()) < 0 or int(idx.max()) >= FSQ_CODES):
        raise AssertionError(f"fsq indices {idx.dtype} {tuple(idx.shape)} "
                             f"[{int(idx.min())}, {int(idx.max())}]")
    latent = tok.indices_to_latent(idx)
    dec_idx = tok.decode(idx, decode_from_indices=True)
    torch.cuda.synchronize()
    rel = rel_l2(dec_idx, dec)
    print(f"fsq: indices {tuple(idx.shape)} in [{int(idx.min())}, "
          f"{int(idx.max())}], {int(idx.unique().numel())} distinct codes; "
          f"indices_to_latent == z: {torch.equal(latent, z)}; decode from "
          f"indices vs forward rel_l2 {rel:.4g}; aux_loss "
          f"{float(log['aux_loss']):.6g}", flush=True)
    if not torch.equal(latent, z):
        raise AssertionError("fsq: indices_to_latent(indices) != quantized z")
    if not rel <= FSQ_DECODE_GATE:
        raise AssertionError(f"fsq: decode from indices rel_l2 {rel}")
    if not torch.isfinite(log["aux_loss"]):
        raise AssertionError("fsq: non-finite aux_loss")


def tiled_e2e_check(core, meta, shape) -> dict:
    """The tiled paths at ``shape`` against the non-tiled f32 plain run,
    each run alone with its outputs moved to the host.

    * The tiled kernel path (bf16) is no further from the non-tiled f32
      plain run than BF16_SLACK x the tiled plain bf16 path is, on z and on
      the reconstruction; the same against the tiled f32 plain run, which
      takes tiling's own departure out of the comparison.
    * The tiled kernel path in the forms of ``tiled_forms``, the same
      against the tiled f32 plain run.
    * The tiled f32 plain run is within TILED_Z_GATE of the non-tiled one
      on z, and within TILED_RECON_GATE on the reconstruction (see there).
    """
    import torch

    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer

    x = np.clip(np.random.RandomState(100).randn(*shape) * 0.5, -1, 1) \
        .astype(np.float32)
    outs = {}
    for key, dtype, fused, tiled in (("kernel", torch.bfloat16, True, True),
                                     ("tiled_forms", torch.bfloat16, True, True),
                                     ("plain", torch.bfloat16, False, True),
                                     ("tiled_f32", torch.float32, False, True),
                                     ("untiled_f32", torch.float32, False, False)):
        tok = VideoTokenizer(core, meta, dtype, fused=fused,
                             forms=kernel_forms(key if key in FORMS else None))
        tok.use_tiling, tok.use_overlap = tiled, True
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        for t in (z, dec, log["kl_loss"]):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{key}: non-finite output")
        outs[key] = (z.cpu(), dec.cpu())
        del tok, z, dec, log
        torch.cuda.empty_cache()
    res = {}
    for i, what in enumerate(("z", "recon")):
        for ref in ("untiled_f32", "tiled_f32"):
            for key in ("kernel", "tiled_forms", "plain"):
                res[f"{what}_{key}_vs_{ref}"] = rel_l2(outs[key][i], outs[ref][i])
        res[f"{what}_tiled_f32_vs_untiled_f32"] = rel_l2(outs["tiled_f32"][i],
                                                         outs["untiled_f32"][i])
    print("tiled e2e rel_l2 " + json.dumps(res), flush=True)
    for what, bound in (("z", TILED_Z_GATE), ("recon", TILED_RECON_GATE)):
        for key, ref in (("kernel", "untiled_f32"), ("kernel", "tiled_f32"),
                         ("tiled_forms", "tiled_f32")):
            k, pl = res[f"{what}_{key}_vs_{ref}"], res[f"{what}_plain_vs_{ref}"]
            if not k <= BF16_SLACK * pl:
                raise AssertionError(f"tiled e2e {what}: {key} vs {ref} {k} > "
                                     f"{BF16_SLACK} x plain bf16 vs {ref} {pl}")
        d = res[f"{what}_tiled_f32_vs_untiled_f32"]
        if not d <= bound:
            raise AssertionError(f"tiled e2e {what}: tiled f32 vs non-tiled f32 "
                                 f"{d} > {bound}")
    return res


def serve_tiled(device) -> tuple:
    """Phase 7: the v1.1 tokenizer with ``use_tiling`` and ``use_overlap``:
    N_REQUESTS requests of TILED_REQUEST with the launches per forward of
    ``tiled_per_forward``, a profile of one, one TILED_LONG request whose
    peak memory may be at most TILED_MEM_RATIO x the TILED_REQUEST peak, one
    TILED_REQUEST in the forms of ``tiled_forms``, and the end-to-end
    gates. Returns the ``serve`` results of the TILED_REQUEST runs in the
    default forms and in ``tiled_forms``."""
    import torch

    tok = make_tokenizer(V1_1_CFG, device)
    tok.use_tiling, tok.use_overlap = True, True
    if (tok.t_chunk_enc, tok.t_chunk_dec) != (T_CHUNK_ENC, T_CHUNK_ENC // TDF):
        raise AssertionError(f"chunks {tok.t_chunk_enc}/{tok.t_chunk_dec}")
    for t in (TILED_REQUEST[2], TILED_LONG[2]):
        enc, dec = chunk_schedule(t)
        t_lat = sum(f // TDF for f in enc)
        if ([e - s for s, e in tok.build_chunk_start_end(t)][1:] != enc[1:]
                or [e - s for s, e in tok.build_chunk_start_end(t_lat, True)]
                != [n - (i < len(dec) - 1) for i, n in enumerate(dec)]):
            raise AssertionError(f"T={t}: the engine's chunks differ from "
                                 f"{enc} / {dec}")
        print(f"tiled T={t}: encoder chunks {enc} frames, decoder chunks {dec} "
              f"latents; launches per forward {tiled_per_forward(t)}", flush=True)
    name = "tiled, kernel path: v1.1 kl 4x8x8 16chn, use_overlap, t_chunk_enc 16"
    r = serve(tok, N_REQUESTS, TILED_REQUEST, tiled_per_forward(TILED_REQUEST[2]))
    report(name, r, TILED_REQUEST)
    profile_request(tok, TILED_REQUEST)
    torch.cuda.empty_cache()
    long = serve(tok, 1, TILED_LONG, tiled_per_forward(TILED_LONG[2]))
    report(name + " (one request, the first at T=201)", long, TILED_LONG)
    ratio = long["peak_mem_bytes"] / r["peak_mem_bytes"]
    print(f"tiled peak memory T=201 / T=65: {ratio:.4f}", flush=True)
    if not ratio <= TILED_MEM_RATIO:
        raise AssertionError(f"tiled peak memory grows with the clip: {ratio}")
    del long
    torch.cuda.empty_cache()
    tok.forms = kernel_forms("tiled_forms")
    r_forms = serve(tok, 1, TILED_REQUEST,
                    in_forms(tiled_per_forward(TILED_REQUEST[2]), "tiled_forms"))
    report(f"{name}, {tok.forms}", r_forms, TILED_REQUEST)
    tok.forms = kernel_forms()
    torch.cuda.empty_cache()
    tiled_e2e_check(tok.core, tok.meta, TILED_REQUEST)
    torch.cuda.empty_cache()
    tiled_partial_check(tok.core, tok.meta)
    return r, r_forms


def tiled_partial_check(core, meta) -> dict:
    """One tiled PARTIAL_REQUEST (a 33² latent: partial tiles in every
    kernel of the tiled path) on the kernel path, with the launches of
    ``tiled_per_forward``, against the tiled f32 plain run: no further from
    it than BF16_SLACK x the tiled plain bf16 path, on z and on the
    reconstruction."""
    import torch

    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer
    from vidtok_tpu_torch.ops import kernels

    x = np.clip(np.random.RandomState(101).randn(*PARTIAL_REQUEST) * 0.5, -1, 1) \
        .astype(np.float32)
    want = tiled_per_forward(PARTIAL_REQUEST[2], PARTIAL_REQUEST[3])
    outs = {}
    for key, dtype, fused in (("kernel", torch.bfloat16, True),
                              ("plain", torch.bfloat16, False),
                              ("tiled_f32", torch.float32, False)):
        tok = VideoTokenizer(core, meta, dtype, fused=fused)
        tok.use_tiling, tok.use_overlap = True, True
        kernels.reset_counts()
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        launches = kernels.counts()
        if launches != (want if fused else dict.fromkeys(want, 0)):
            raise AssertionError(f"partial request, {key}: launches {launches}")
        t_lat = -(-PARTIAL_REQUEST[2] // TDF)
        if (tuple(dec.shape) != PARTIAL_REQUEST or tuple(z.shape)[2:]
                != (t_lat, PARTIAL_REQUEST[3] // 8, PARTIAL_REQUEST[4] // 8)):
            raise AssertionError(f"partial request: z {tuple(z.shape)} dec {tuple(dec.shape)}")
        for t in (z, dec, log["kl_loss"]):
            if not torch.isfinite(t).all():
                raise AssertionError(f"partial request, {key}: non-finite output")
        outs[key] = (z.cpu(), dec.cpu())
        del tok, z, dec, log
        torch.cuda.empty_cache()
    res = {}
    for i, what in enumerate(("z", "recon")):
        for key in ("kernel", "plain"):
            res[f"{what}_{key}_vs_tiled_f32"] = rel_l2(outs[key][i], outs["tiled_f32"][i])
    print(f"tiled partial request {list(PARTIAL_REQUEST)} launches {want}; rel_l2 "
          + json.dumps(res), flush=True)
    for what in ("z", "recon"):
        k, pl = res[f"{what}_kernel_vs_tiled_f32"], res[f"{what}_plain_vs_tiled_f32"]
        if not k <= BF16_SLACK * pl:
            raise AssertionError(f"tiled partial {what}: kernel vs tiled f32 {k} > "
                                 f"{BF16_SLACK} x plain bf16 vs tiled f32 {pl}")
    return res


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


def serve_forms(device) -> dict:
    """Phase 8: the v1.0 flagship in the forms of ``v1_0_forms`` (N_REQUESTS
    requests and a profile of one) and of ``v1_0_split`` (one request),
    each with its launches per forward, then the end-to-end gate for both.
    Returns the ``serve`` results by FORMS path."""
    tok = make_tokenizer(V1_0_CFG, device)
    runs = {}
    for path, n in (("v1_0_forms", N_REQUESTS), ("v1_0_split", 1)):
        tok.forms = kernel_forms(path)
        runs[path] = serve(tok, n, REQUEST, PER_FORWARD[path])
        report(f"forms {tok.forms}, kernel path: v1.0 kl 4x8x8 16chn", runs[path],
               REQUEST)
        if path == "v1_0_forms":
            profile_request(tok, REQUEST)
    e2e_check(tok.core, tok.meta, REQUEST, "v1_0", kernels=("v1_0_forms", "v1_0_split"))
    return runs


class ToolCase(NamedTuple):
    """One row of a tool at one shape: the wrapper and plain version on the
    same bf16 arguments, one PyTorch call for the same function (or None),
    a cuDNN yardstick (or None), and whether the row is timed (the tools'
    mains run it) or only checked."""
    name: str
    row: str
    shape: tuple
    kernel: Callable
    plain: Callable
    args: tuple
    library: Callable = None
    yardstick: Callable = None
    timed: bool = True


def mm_yardstick(x, params):
    """T2 ``mm``'s function as cuDNN runs it: two ``F.conv3d`` k=(3, 1, 1)
    on the zero-front-padded input (x padded once, here; h in the call),
    plus the residual add."""
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)  # [B, C, T, H, W], channels last in memory
    xp = F.pad(xc, (0, 0, 0, 0, 2, 0))
    w1, w2 = (params[n][0][..., None, None].to(x.dtype) for n in ("conv1", "conv2"))

    def run():
        h = F.conv3d(xp, w1)
        return xc + F.conv3d(F.pad(h, (0, 0, 0, 0, 2, 0)), w2)

    return run


def tool_cases(device, names=None):
    """Yield a ``ToolCase`` for kernel B in zero mode (the tool's ``v0
    shipped``), T1, T2 in its three modes (``mm`` with ``mm_yardstick``) and
    T3 at every tiling that divides the shape, at each of TOOL_SHAPES with
    ``Params`` inputs (random norm and conv parameters); T1, T2 ``mm`` and
    ``ln`` at TOOL_PARTIAL, not timed; T4 in its three modes at SILU_SHAPE.
    Rows are named as the tools' mains name them; ``names`` keeps those
    kernels' cases alone."""
    import torch
    import torch.nn.functional as F

    from vidtok_tpu_torch.ops.kernels import fused_temporal
    from vidtok_tpu_torch.tools import microbench_temporal as tm
    from vidtok_tpu_torch.tools import probe_silu_bf16 as tp

    def keep(name):
        return names is None or name in names

    p = Params(5, device)
    for shape in TOOL_SHAPES + (TOOL_PARTIAL,):
        timed = shape != TOOL_PARTIAL
        c = shape[-1]
        x = p.x(shape, torch.bfloat16)
        params = {"norm1": p.norm(c), "conv1": p.conv((c, c, 3)),
                  "norm2": p.norm(c), "conv2": p.conv((c, c, 3))}
        cases = [ToolCase("fused_temporal_resblock", "v0 shipped", shape,
                          fused_temporal.fused_temporal_resblock,
                          fused_temporal.fused_temporal_resblock_plain,
                          (x, *(params[n] for n in ("norm1", "conv1", "norm2", "conv2")),
                           "zero")),
                 ToolCase("fused_fat", "v1 fat", shape, tm.fused_fat, tm.fused_fat_plain,
                          (x, params))]
        for row, mode in tm.DIAG_ROWS:
            cases.append(ToolCase(
                "fused_diag", row, shape, tm.fused_diag, tm.fused_diag_plain,
                (x, params, mode), (lambda x=x: x.clone()) if mode == "copy" else None,
                mm_yardstick(x, params) if mode == "mm" and timed else None))
        b, t, h, w, _ = shape
        for row, tile_s, tile_t in tm.COPY_TILINGS if timed else ():
            if (h * w) % tile_s or t % (tile_t or t):
                if keep("copy_min"):
                    print(f"tools copy_min {shape} {row}: not run, the tile does not "
                          "divide the shape", flush=True)
                continue
            cases.append(ToolCase("copy_min", row, shape, tm.copy_min, tm.copy_min_plain,
                                  (x, tile_s, tile_t), lambda x=x: x.clone()))
        for case in cases:
            if keep(case.name) and (timed or case.row in TOOL_PARTIAL_ROWS):
                yield case._replace(timed=timed)
        del x, cases
    x = tp.probe_input(SILU_SHAPE, device)
    for mode in tp.MODES:
        lib = (lambda: F.silu(x)) if mode == "f32_logistic" else None
        case = ToolCase("silu_probe", mode, SILU_SHAPE, tp.silu_probe, tp.silu_probe_plain,
                        (x, mode), lib)
        if keep(case.name):
            yield case


def ulp_bf16(a):
    """The spacing of bf16 values at |a| (8 significant bits), in f32."""
    import torch

    e = torch.floor(torch.log2(a.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def silu_units(x, plain_out, mode: str):
    """The unit of SILU_UNITS at each value of bf16 x: one ulp of the plain
    output, plus for ``bf16_tanh`` |x| times the grid step of its s, from
    t = tanh(x / 2) in bf16 steps as its plain form takes it."""
    import torch

    unit = ulp_bf16(plain_out)
    if mode == "bf16_tanh":
        t = torch.tanh(x * 0.5)
        unit = unit + x.float().abs() * torch.maximum(ulp_bf16(t), ulp_bf16(t + 1.0)) / 2
    return unit


def check_tools(device, names=None) -> dict:
    """The tools' kernels (B, T1-T4; or those in ``names``) against their
    plain versions at the shapes of ``tool_cases``: relative L2 <=
    KERNEL_GATE against the plain version run in f32 (TF32 off) and <=
    BF16_SLACK x the plain bf16 version's own, and every copy equal to x.
    T4's bf16 forms: relative L2 <= KERNEL_GATE against SiLU in f32, and
    every value within SILU_UNITS of the plain bf16 version
    (``silu_units``). Every gate is checked before the first failure is
    raised. Times (the tools' ``Timer``: the median of CUDA event pairs, the
    L2 flushed before each call) of the plain version in bf16, of the
    library call and of the yardstick, for the timed rows; the kernels' own
    times are their tools' rows (``run_tools``). Returns {kernel: {(shape,
    row): {max_abs_err, plain_ms, library_ms, yardstick_ms}}} of the timed
    rows."""
    import torch
    import torch.nn.functional as F

    from vidtok_tpu_torch.tools import Timer

    timer = Timer(device)
    results, failed = {}, []
    for case in tool_cases(device, names):
        name, row, shape, args = case.name, case.row, case.shape, case.args
        out = case.kernel(*args)
        plain_bf16 = case.plain(*args)
        x = args[0]
        bf16_silu = name == "silu_probe" and row != "f32_logistic"
        ref = F.silu(x.float()) if bf16_silu else case.plain(*f32(args))
        torch.cuda.synchronize()
        if out.shape != x.shape or out.dtype != x.dtype:
            raise AssertionError(f"{name} {shape} {row}: {out.shape}/{out.dtype}")
        err = float((out.float() - ref).abs().max())
        rel, plain_rel = rel_l2(out.float(), ref), rel_l2(plain_bf16.float(), ref)
        note, problem = "", None
        if bf16_silu:
            diff = (out.float() - plain_bf16.float()).abs()
            units = float((diff / silu_units(x, plain_bf16, row)).max())
            ulps = float((diff / ulp_bf16(plain_bf16)).max())
            note = (f" max |kernel - plain bf16| {units:.3g} units ({ulps:.3g} ulps of "
                    "the plain output)")
            if not (rel <= KERNEL_GATE and units <= SILU_UNITS):
                problem = (f"silu_probe {row}: rel_l2 vs f32 silu {rel} > {KERNEL_GATE}, "
                           f"or {units} > {SILU_UNITS} units")
        else:
            try:
                gate(f"{name}{shape} {row}", rel, plain_rel)
            except AssertionError as e:
                problem = str(e)
            if (name == "copy_min" or row == "v4 copy-only") and not torch.equal(out, x):
                problem = f"{name} {shape} {row}: the copy differs from x"
        if problem is not None:
            print(f"GATE FAILED {problem}", flush=True)
            failed.append(problem)
        del out, plain_bf16, ref
        times = ""
        if case.timed:
            plain_ms = timer(lambda: case.plain(*args), iters=10)
            lib_ms, yard_ms = (None if fn is None else timer(fn, iters=10)
                               for fn in (case.library, case.yardstick))
            times = "".join(f" {k} {'none' if v is None else f'{v:.4f}'}" for k, v in (
                ("plain_bf16_ms", plain_ms), ("library_ms", lib_ms),
                ("cudnn_yardstick_ms", yard_ms))) + " (median, L2 flushed)"
            results.setdefault(name, {})[shape, row] = dict(
                max_abs_err=err, plain_ms=plain_ms, library_ms=lib_ms, yardstick_ms=yard_ms)
        print(f"tools {name} {shape} {row}: max_abs_err {err:.4g} rel_l2 {rel:.4g} "
              f"plain_bf16_rel_l2 {plain_rel:.4g}{note}{times or ' (checked, not timed)'}",
              flush=True)
        del args, case
    if failed:
        raise AssertionError(f"{len(failed)} tool gates failed:\n" + "\n".join(failed))
    return results


def run_tools() -> tuple:
    """Both tools' mains on the card (the microbenchmark at TOOL_RUNS, the
    probe at its default), their rows printed. Returns the T1-T4 launches
    of these runs, each of which must be > 0, and the rows by (shape, row
    name)."""
    from vidtok_tpu_torch.tools import microbench_temporal as tm
    from vidtok_tpu_torch.tools import probe_silu_bf16 as tp

    wrappers = {**tm.WRAPPERS, **tp.WRAPPERS}
    for fn in wrappers.values():
        fn.calls = fn.launches = 0
    rows = {}
    for shape, argv in zip(TOOL_SHAPES, TOOL_RUNS):
        print(f"tool microbench_temporal {' '.join(argv)}:", flush=True)
        rows.update(((shape, r["name"]), r) for r in tm.main(argv))
    print("tool probe_silu_bf16 (defaults):", flush=True)
    rows.update(((SILU_SHAPE, r["name"]), r) for r in tp.main([]))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"tools launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch in the tools' run")
    return launches, rows


def tool_entry(name: str, checked: dict, launches: int, rows: dict) -> dict:
    """The result line's entry of a tool kernel: its numbers from its row
    named in TOOL_SOURCES at its first shape (T1-T3: TOOL_SHAPES[0], T4:
    SILU_SHAPE), and each of its rows under ``rows``: the time and bound
    from the tool's run, the error, plain and library times from
    ``check_tools``."""
    source, replaces, first_row, headers = TOOL_SOURCES[name]
    first = SILU_SHAPE if name == "silu_probe" else TOOL_SHAPES[0]
    per_row = []
    for (shape, row), c in checked.items():
        r = rows[shape, row]
        per_row.append(dict(shape=list(shape), row=row, ms=r["ms"], plain_ms=c["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=c["library_ms"], yardstick_ms=c["yardstick_ms"],
                            max_abs_err=c["max_abs_err"]))
    head = next(r for r in per_row if r["shape"] == list(first) and r["row"] == first_row)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "headers": list(headers), "launches": launches, "max_abs_err": head["max_abs_err"],
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": list(first), "row": first_row, "rows": per_row}


def phase(name: str, t0: float) -> float:
    t = time.perf_counter()
    print(f"phase {name}: {t - t0:.1f} s", flush=True)
    return t


def check_only(device, names) -> int:
    """``--kernels``: phase 2 for the named kernels alone (D's T=201 window
    too when D is named; a tool's kernels at the tools' shapes), every gate
    reported; 1 if any failed."""
    checks = []
    if set(names) & set(SOURCES):
        checks.append(lambda: check_kernels(device, names))
    if "decoder_tail_rgb" in names:
        checks.append(lambda: check_tail_long(device))
    if set(names) & set(TOOL_SOURCES):
        checks.append(lambda: check_tools(device, names))
    failed = 0
    for check in checks:
        try:
            check()
        except AssertionError as e:
            print(f"FAILED: {e}", flush=True)
            failed += 1
    print(f"checked {', '.join(names)}: {'FAILED' if failed else 'every gate passed'}",
          flush=True)
    return int(failed > 0)


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    names = None
    if argv:
        known = set(SOURCES) | set(TOOL_SOURCES)
        if len(argv) != 2 or argv[0] != "--kernels" or not set(argv[1].split(",")) <= known:
            print(f"usage: chip_smoke.py [--kernels NAME[,NAME...]], names from "
                  f"{', '.join(list(SOURCES) + list(TOOL_SOURCES))}", file=sys.stderr)
            return 2
        names = argv[1].split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vidtok_tpu_torch.ops.kernels import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = _lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {lib.build_seconds:.1f} s)"
          f" -> {lib.path.name}", flush=True)
    for line in lib.build_log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                or "spill" in line):
            print(line, flush=True)
    t = phase("build", t0)
    if names is not None:
        return check_only(device, names)

    kres = check_kernels(device)
    check_parity_long(device)
    check_spatial_long(device)
    check_tail_long(device)
    torch.cuda.empty_cache()
    t = phase("kernels", t)
    compare_forms(device, card)
    t = phase("forms", t)
    tool_checks = check_tools(device)
    tool_launches, tool_rows = run_tools()
    torch.cuda.empty_cache()
    t = phase("tools", t)
    main_path = serve_both_paths("v1.0 kl 4x8x8 16chn", V1_0_CFG, "v1_0", device)
    torch.cuda.empty_cache()
    t = phase("v1.0 kl serve", t)
    loop_rates(device)  # after serve's profile: the profiler is started
    t = phase("loop rates", t)
    serve_long_clip(device)
    torch.cuda.empty_cache()
    t = phase("long clip", t)
    check_fsq(device)
    torch.cuda.empty_cache()
    t = phase("fsq", t)
    serve_both_paths("v1.1 kl 4x8x8 16chn", V1_1_CFG, "v1_1", device)
    torch.cuda.empty_cache()
    t = phase("v1.1 kl serve", t)
    runs = {"v1_0": main_path}
    runs["tiled"], runs["tiled_forms"] = serve_tiled(device)
    torch.cuda.empty_cache()
    t = phase("v1.1 kl tiled serve", t)
    runs.update(serve_forms(device))
    phase("v1.0 kl forms serve", t)
    phase("total", t0)

    kernels = []
    for name, (source, replaces, headers) in SOURCES.items():
        r, path = kres[name], MAIN_PATH[name]
        by_bytes = r["bound_by_bytes_ms"][path] >= r["bound_by_ops_ms"][path]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "headers": list(headers), "launches": runs[path]["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"][path],
            "plain_ms": r["plain_ms"][path], "bound_ms": r["bound_ms"][path],
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": None})
    kernels += [tool_entry(name, tool_checks[name], tool_launches[name], tool_rows)
                for name in TOOL_SOURCES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
