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
   parity form (G 2), and the end-to-end gate for both forms;
9. the non-causal KL 4x8x8 16-channel model as in 3 at [1, 3, 16, 256,
   256] (launches A 20, C 3, B, D, E and F 0: they are causal-only);
10. one [1, 3, 17, 256, 256] request through the v1.1 FSQ 4x16x16 262144
    model (a fifth level, a 16² latent; A 25, B 25, C 4, D 1), checked as
    in 5 (indices in [0, 262144)), with its peak memory beside the entropy
    loss's [positions, 262144] f32 matrix;
11. the v1.1 FSQ 8x8x8 32768 model tiled (``t_chunk_dec`` 2, cache offsets
    up to 8): one [1, 3, 33, 256, 256] request (A 60, F 60, C 9, D 3)
    checked as in 5, then its latent before quantization and its
    reconstruction from the f32 run's codes held to the tiled f32 plain
    run (``serve_tiled_888``);
12. one [1, 3, 17, 256, 256] request through the v1.0 KL 4x4x4 model
    (256² at two levels, a 64² latent; A 20, B 20, C 2, D 1, E 2) and the
    end-to-end gate;
13. the checkpoint round trip: the flagship saved with
    ``VideoTokenizer.save``, loaded back through ``load_model_from_config(
    cfg, ckpt=...)``, its reconstruction bit-equal; the load time;
14. the CLIs (``vidtok_tpu_torch/scripts``) through the compute functions
    their mains call, in bf16 on seeded frames (two clips of 51 frames of
    360 x 640 at 30 fps, ``cli_clip``), files under CKPT_DIR: (a)
    ``inference_evaluate``, the slice's main path: the flagship saved as a
    ``.ckpt`` and loaded by the CLI's parser and loader (``--ckpt --bf16
    --lpips_weights``, random LPIPS weights in JAX's converted layout), 6
    windows of 17 frames, each transformed on the card (resize 360 -> 256,
    crop 455 -> 256), reconstructed and scored (PSNR, SSIM, LPIPS) with its
    time split into those parts and its launches (A 20, B 20, C 3, D 1,
    E 2); frames/s, peak memory, a profile of one window; gates: the
    card's transform bit-equal to the CPU's, PSNR and SSIM within 1e-4 and
    f32 LPIPS within 1e-3 (relative) of the CPU's on the same tensors; (b)
    ``--read_long_video`` on the v1.1 KL model, one 65-frame window tiled
    (F 100, A 100, C 15, D 5); (c) ``inference_reconstruct
    --pad_gen_frames`` on the flagship, output uint8 [51, 256, 512, 3];
    (d) ``stream_tokens`` on the v1.1 FSQ 32768 model over 65 frames, each
    chunk's latency, launches (A 8, F 8) and tokens, z bit-equal to the
    tiled encode; (e) one evaluate window of the v1.0 FSQ 262144 model
    with its peak memory beside the entropy loss's [5120, 262144] f32
    matrices; (f) each CLI as a subprocess on an mp4 where OpenCV and
    PyYAML import, else a line saying which is missing.

Phase 2 also holds every call shape of phases 9-12 that the earlier
phases do not give (``model_calls``: A at 16² x 512 channels and at 256²
with 128 -> 256 channels, B at the 41616 and 444 shapes, F at the 888
chunks' shapes and offsets, C, and D on [2 cached | chunk] with
``t_chunk_dec`` 2), timed per forward of its path.

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
_FSQ_LOSSES = {"entropy_loss_weight": 0.1, "entropy_loss_annealing_steps": 2000,
               "entropy_loss_annealing_factor": 3, "commitment_loss_weight": 0.25}
_KL = {"target": "DiagonalGaussianRegularizer"}


def _model(target: str, enc: str, dec: str, params: dict, reg: dict,
           **extra) -> dict:
    return {"model": {"target": target, "params": {
        "encoder_config": {"target": enc, "params": dict(params)},
        "decoder_config": {"target": dec, "params": dict(params)},
        "regularizer_config": reg, **extra}}}


V1_0_CFG = _model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                  _ENC, _KL)
FSQ_CFG = _model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                 _ENC_FSQ, {"target": "FSQRegularizer", "params": {
                     "levels": [8, 8, 8, 8], **_FSQ_LOSSES}})
V1_1_CFG = _model("AutoencodingEngineV1_1", "EncoderCausal3DV1_1",
                  "DecoderCausal3DV1_1", _ENC_V1_1, _KL, use_tiling=False, t_chunk_enc=16)
# The other configurations' shapes (phases 9-12): the non-causal KL 4x8x8
# 16-channel model (configs/vidtok_kl_noncausal_488_16chn.yaml), the v1.1
# FSQ 4x16x16 262144 model with a fifth level (configs/v1_1/vidtok_fsq_causal_
# 41616_262144_v1_1.yaml), the v1.1 FSQ 8x8x8 32768 model (configs/v1_1/
# vidtok_fsq_causal_888_32768_v1_1.yaml: tdf 8, so t_chunk_dec 2 when tiled)
# and the v1.0 KL 4x4x4 4-channel model (configs/vidtok_kl_causal_444_4chn
# .yaml: levels 0 and 1 at full resolution).
NONCAUSAL_CFG = _model("AutoencodingEngine", "Encoder3D", "Decoder3D",
                       {k: v for k, v in _ENC.items() if k != "init_pad_mode"}, _KL)
FSQ_41616_CFG = _model(
    "AutoencodingEngineV1_1", "EncoderCausal3DV1_1", "DecoderCausal3DV1_1",
    dict(_ENC_V1_1, double_z=False, z_channels=6, ch_mult=[1, 2, 4, 4, 4]),
    {"target": "FSQRegularizer", "params": {"levels": [8] * 6, **_FSQ_LOSSES}},
    use_tiling=False, t_chunk_enc=16)
FSQ_888_CFG = _model(
    "AutoencodingEngineV1_1", "EncoderCausal3DV1_1", "DecoderCausal3DV1_1",
    dict(_ENC_V1_1, double_z=False, z_channels=5, tempo_ds=[0, 1, 2], tempo_us=[1, 2, 3],
         time_downsample_factor=8),
    {"target": "FSQRegularizer", "params": {"levels": [8] * 5, **_FSQ_LOSSES}},
    use_tiling=False, t_chunk_enc=16)
KL_444_CFG = _model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                    dict(_ENC, z_channels=4, spatial_ds=[1, 2], spatial_us=[1, 2]), _KL)
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
# The other configurations' serving paths, path -> (config, request, tiled):
# the non-causal model (no input padding: 16 frames), the FSQ 262144 model
# and the 444 model at REQUEST, the 888 model tiled over 33 = 1 + 2 x 16
# frames (3 encoder chunks of 8, 16, 16 frames, 3 decoder chunks of 2, 3, 2
# latents). Their launches per forward and call shapes come from
# ``model_calls``; the serving runs check the launches against the counters.
CONFIG_PATHS = {"noncausal": (NONCAUSAL_CFG, (1, 3, 16, 256, 256), False),
                "fsq_41616": (FSQ_41616_CFG, REQUEST, False),
                "tiled_888": (FSQ_888_CFG, (1, 3, 33, 256, 256), True),
                "kl_444": (KL_444_CFG, REQUEST, False)}
PATHS = ("v1_0", "v1_1", "tiled") + tuple(FORMS) + tuple(CONFIG_PATHS)

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


def chunk_schedule(t: int, tdf: int = TDF):
    """A tiled, overlapped forward of ``t`` frames: frames per encoder
    chunk (the first is frame 0 padded to ``tdf``) and latent frames per
    decoder chunk (one look-ahead frame on each but the last)."""
    enc = [tdf] + [e - s for s, e in _cut(t, T_CHUNK_ENC)[1:]]
    t_lat = sum(f // tdf for f in enc)
    dec = [e - s + (e + 1 <= t_lat) for s, e in _cut(t_lat, T_CHUNK_ENC // tdf)]
    return enc, dec


def model_calls(cfg: dict, shape, tiled: bool = False) -> Counter:
    """Kernel calls of one forward of a ``[B, 3, T, H, H]`` request through
    the model of ``cfg`` (a resolved config, layernorm) with ``fused`` on,
    by (kernel, call key) as ``kernel_cases`` keys them: the walk of
    ``modules/encoder.py`` and ``modules/decoder.py``, or with ``tiled``
    the chunk loop with overlap (``chunk_schedule``, each decoder stage at
    its cache offset). Kernel A at every spatial resblock (N, H, W, Cin,
    C); in a causal model B (non-tiled; key (shape, mode)) or F (tiled;
    (shape, first_chunk, offset)) at every temporal resblock, E (v1.0) at
    every temporal upsample and D on the decoder's last activations
    (tiled: with the 2 cached frames); C at every spatial upsample."""
    from vidtok_tpu_torch.models.autoencoder import _ENC_VARIANTS

    p = cfg["model"]["params"]
    ep, dp = p["encoder_config"]["params"], p["decoder_config"]["params"]
    variant = _ENC_VARIANTS[p["encoder_config"]["target"]]
    causal = variant != "noncausal"
    mode = "replicate" if variant == "causal_v1_1" else "zero"
    ch, mult, nrb, tdf = ep["ch"], ep["ch_mult"], ep["num_res_blocks"], ep["time_downsample_factor"]
    n = len(mult)
    last = range(n - 1)
    s_ds = tuple(last if ep.get("spatial_ds") is None or not causal else ep["spatial_ds"])
    t_ds = tuple(ep.get("tempo_ds") or (n - 2, n - 3))
    s_us = tuple(range(1, n) if dp.get("spatial_us") is None or not causal
                 else dp["spatial_us"])
    t_us = tuple(dp.get("tempo_us") or (1, 2))
    b, _, t, size, _ = shape
    calls = Counter()

    def temporal(f, s, c, first, off):
        if not causal:
            return
        x = (b, f, s, s, c)
        if tiled:
            calls["fused_temporal_resblock_stream", (x, first, off)] += 1
        else:
            calls["fused_temporal_resblock", (x, mode)] += 1

    def encode(f, first):
        s, c = size, ch
        for i in range(n):
            for _ in range(nrb):
                calls["fused_spatial_resblock", (b * f, s, s, c, ch * mult[i])] += 1
                c = ch * mult[i]
                temporal(f, s, c, first, 0)
            if i in s_ds:
                s //= 2
                f //= 2 if i in t_ds else 1
        return f, s

    def decode(f, s, first):
        c, cur, offs = ch * mult[-1], 1, {}
        for i in reversed(range(n)):
            offs[i] = cur
            cur *= 2 if i in t_us else 1
        for i in reversed(range(n)):
            for _ in range(nrb + 1):
                calls["fused_spatial_resblock", (b * f, s, s, c, ch * mult[i])] += 1
                c = ch * mult[i]
                temporal(f, s, c, first, offs[i])
            if i in s_us:
                calls["subpixel_interleave", (b * f, s, s, c)] += 1
                s *= 2
                if i in t_us:
                    if variant == "causal":
                        calls["parity_up2x_fused", ((b, f, s, s, c), mode)] += 1
                    f *= 2
        if causal:
            frames = f + 2 if tiled else f
            calls["decoder_tail_rgb", ((b, frames, s, s, c), mode)] += 1

    if not tiled:
        if variant == "causal" and t % tdf:
            t += tdf - 1
        elif variant == "causal_v1_1":
            t = -(-t // tdf) * tdf
        decode(*encode(t, True), True)
        return calls
    enc, dec = chunk_schedule(t, tdf)
    lat = [encode(f, i == 0) for i, f in enumerate(enc)][0][1]
    for i, f in enumerate(dec):
        decode(f, lat, i == 0)
    return calls


def per_forward(calls: Counter) -> dict:
    """Launches per forward of each kernel of SOURCES, from ``model_calls``."""
    per = dict.fromkeys(SOURCES, 0)
    for (name, _), k in calls.items():
        per[name] += k
    return per


def tiled_calls(t: int, size: int = 256) -> Counter:
    """``model_calls`` of one tiled forward of a [1, 3, t, size, size] clip
    through the v1.1 model: per encoder chunk of f frames, 2 spatial and 2
    temporal blocks at each of the levels (f, s², 128), (f, (s/2)², 256),
    (f/2, (s/4)², 512), (f/4, (s/8)², 512). Per decoder chunk of n
    latents: 3 of each at (n, (s/8)², 512), (n, (s/4)², 512), (2n, (s/2)²,
    256), (4n, s², 128) with cache offsets 1, 1, 2, 4; a spatial upsample
    after each of the first three; the tail on 4n + 2 frames (2 cached)."""
    return model_calls(V1_1_CFG, (1, 3, t, size, size), tiled=True)


for _path, (_cfg, _shape, _tiled) in CONFIG_PATHS.items():
    PER_FORWARD[_path] = per_forward(model_calls(_cfg, _shape, _tiled))


def long_spatial_shapes() -> list:
    """Kernel A's call shapes and calls in one non-tiled v1.0 forward of
    LONG_REQUEST: SPATIAL_SHAPES with their frames scaled from REQUEST's 20
    (17 padded by TDF - 1) to LONG_REQUEST's 204."""
    frames, long_frames = REQUEST[2] + TDF - 1, LONG_REQUEST[2] + TDF - 1
    return [((k[0] * long_frames // frames,) + k[1:], calls)
            for k, calls in SPATIAL_SHAPES]


def tiled_per_forward(t: int, size: int = 256) -> dict:
    """Launches per tiled forward of the v1.1 model, summed from
    ``tiled_calls`` and checked against the formula: with E encoder and D
    decoder chunks, F = A = 8E + 12D, C = 3D, D's tail D, B = E's kernel =
    0 (T=65: 100, 100, 15, 5, 0, 0)."""
    per = per_forward(tiled_calls(t, size))
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
    for shape, calls in TEMPORAL_SHAPES:
        for mode, path in MODE_PATH.items():
            shapes["fused_temporal_resblock"][shape, mode][path] = calls
    for shape, calls in PARITY_SHAPES:
        for mode in MODE_PATH:  # v1.0 serves zero mode; replicate is checked
            shapes["parity_up2x_fused"][shape, mode]["v1_0"] = calls if mode == "zero" else 0
    runs = [("tiled", tiled)] + [(path, model_calls(*run)) for path, run in CONFIG_PATHS.items()]
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

    z_ch = next(tok.core.decoder.conv_in.parameters()).shape[1]
    down = 2 ** len(tok.core.encoder.spatial_ds)
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
        t_lat = -(-shape[2] // tok.time_downsample_factor)
        if (tuple(dec.shape) != tuple(shape)
                or tuple(z.shape) != (shape[0], z_ch, t_lat, shape[3] // down,
                                      shape[4] // down)):
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
    x = np.zeros(shape, np.float32)
    tok(x)
    profile_call(lambda: tok(x))


def profile_call(fn, label: str = "profile") -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler; warm
    it up first), and the device's busy share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print(f"{label}: no device time recorded (not measured)", flush=True)
        return
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    kernels_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"{label}: wall {wall_ms:.2f} ms, device kernels {kernels_ms:.2f} ms "
          f"(busy share {kernels_ms / wall_ms:.3f})", flush=True)
    for e in rows[:12]:
        print(f"{label}: {e.self_device_time_total / 1e3:9.3f} ms "
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


def serve_both_paths(name: str, cfg: dict, path: str, device, shape=REQUEST) -> dict:
    """Phases 3, 6 and 9: N_REQUESTS requests of ``shape`` on the kernel
    path, then on the plain path, a profile of one kernel-path request and
    the end-to-end gate. Returns the kernel path's ``serve`` result."""
    tok = make_tokenizer(cfg, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    per = PER_FORWARD[path]
    runs = {}
    for label, fused, want in (("kernel path", True, per),
                               ("plain path", False, dict.fromkeys(per, 0))):
        tok.fused = fused
        runs[label] = serve(tok, N_REQUESTS, shape, want)
        report(f"{label}: {name}, {n_params} params", runs[label], shape)
    k = runs["kernel path"]
    for kernel, n in k["launches"].items():
        if n != N_REQUESTS * per[kernel]:
            raise AssertionError(f"{kernel}: {n} launches in the serving run")
    tok.fused = True
    profile_request(tok, shape)
    e2e_check(tok.core, tok.meta, shape, path)
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


def check_fsq(device, name="fsq 4096, kernel path: v1.0 fsq 4x8x8 4096 codes",
              path="v1_0", n_requests=N_REQUESTS, tok=None) -> dict:
    """Phase 5 (and 10, 11): ``n_requests`` requests through an FSQ kernel
    path (the v1.0 FSQ 4096 model's at REQUEST, or a CONFIG_PATHS path's;
    the first pays cuDNN's algorithm search, so the latency to compare is
    the best after it); on the last, integer indices in [0, codebook size)
    of the latent's shape, ``indices_to_latent`` equal to the quantized z,
    decoding from indices equal to the reconstruction (relative L2 <=
    FSQ_DECODE_GATE), a finite ``aux_loss``. Returns the ``serve``
    result."""
    import torch

    cfg, shape, _ = CONFIG_PATHS.get(path, (FSQ_CFG, REQUEST, False))
    tok = tok or make_tokenizer(cfg, device)
    codes = tok.core.regularization.fsq.codebook_size
    r = serve(tok, n_requests, shape, PER_FORWARD[path])
    report(name, r, shape)
    x, z, dec, log = r["last"]
    idx = log["indices"]
    want = (shape[0],) + tuple(z.shape[2:])
    if (idx.dtype not in (torch.int32, torch.int64) or tuple(idx.shape) != want
            or int(idx.min()) < 0 or int(idx.max()) >= codes):
        raise AssertionError(f"fsq indices {idx.dtype} {tuple(idx.shape)} "
                             f"[{int(idx.min())}, {int(idx.max())}]")
    latent = tok.indices_to_latent(idx)
    # v1.1 decodes tdf * T' frames, of which the forward keeps the last T
    dec_idx = tok.decode(idx, decode_from_indices=True)[:, :, -dec.shape[2]:]
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
    return r


def check_fsq_41616(device) -> None:
    """Phase 10: one request through the v1.1 FSQ 262144 model's kernel
    path (five levels, a 16² latent), checked as in ``check_fsq``; its peak
    memory beside the f32 ``[positions, 262144]`` matrix of the entropy
    loss, which it computes on every call as JAX does."""
    r = check_fsq(device, "fsq 262144, kernel path: v1.1 fsq 4x16x16 262144 codes",
                  "fsq_41616", n_requests=1)
    positions, codes = int(np.prod(r["last"][1].shape[2:])), 8 ** 6
    print(f"fsq 262144: {positions} latent positions, entropy-loss matrix "
          f"[{positions}, {codes}] f32 = {positions * codes * 4} bytes; "
          f"peak_mem_bytes {r['peak_mem_bytes']}", flush=True)


class _Unquantized:
    """A stand-in regularizer that returns the encoder's output as it is,
    so the tiled engine's encode gives the latent before quantization."""

    def __call__(self, z, sample=None, generator=None):
        return z, {"kl_loss": z.new_zeros(())}


def serve_tiled_888(device) -> None:
    """Phase 11: the v1.1 FSQ 8x8x8 32768 model tiled (``use_tiling``,
    ``use_overlap``, ``t_chunk_enc`` 16, so ``t_chunk_dec`` 2): one request
    of its CONFIG_PATHS shape, checked as in ``check_fsq``, then held to the
    tiled f32 plain run with the encoder and the decoder apart (a code that
    flips at a rounding boundary would swamp a comparison of codes): the
    latent before quantization, and the reconstruction decoded from the f32
    run's codes, of the kernel path (bf16) no further from the f32 plain
    run than BF16_SLACK x the plain bf16 path is."""
    import torch

    from vidtok_tpu_torch.models.autoencoder import TokenizerCore, VideoTokenizer

    tok = make_tokenizer(FSQ_888_CFG, device)
    tok.use_tiling, tok.use_overlap = True, True
    if (tok.t_chunk_enc, tok.t_chunk_dec) != (T_CHUNK_ENC, T_CHUNK_ENC // 8):
        raise AssertionError(f"chunks {tok.t_chunk_enc}/{tok.t_chunk_dec}")
    shape = CONFIG_PATHS["tiled_888"][1]
    print(f"tiled 888 T={shape[2]}: encoder and decoder chunks "
          f"{chunk_schedule(shape[2], 8)}", flush=True)
    check_fsq(device, "tiled 888, kernel path: v1.1 fsq 8x8x8 32768 codes, use_overlap, "
              "t_chunk_enc 16", "tiled_888", n_requests=1, tok=tok)
    core, meta = tok.core, tok.meta
    raw = TokenizerCore(core.encoder, core.decoder, _Unquantized())
    x = np.clip(np.random.RandomState(102).randn(*shape) * 0.5, -1, 1).astype(np.float32)
    ref = VideoTokenizer(core, meta, torch.float32, fused=False)
    ref.use_tiling, ref.use_overlap = True, True
    codes = ref.encode(x)
    del ref
    outs = {}
    for key, dtype, fused in (("kernel", torch.bfloat16, True),
                              ("plain", torch.bfloat16, False),
                              ("tiled_f32", torch.float32, False)):
        t = VideoTokenizer(raw, dict(meta, discrete=False), dtype, fused=fused)
        t.use_tiling, t.use_overlap = True, True
        latent, dec = t.encode(x), t.decode(codes)
        torch.cuda.synchronize()
        for v in (latent, dec):
            if not torch.isfinite(v).all():
                raise AssertionError(f"tiled 888, {key}: non-finite output")
        outs[key] = (latent.cpu(), dec.cpu())
        del t, latent, dec
        torch.cuda.empty_cache()
    res = {f"{what}_{key}_vs_tiled_f32": rel_l2(outs[key][i], outs["tiled_f32"][i])
           for i, what in enumerate(("latent", "recon")) for key in ("kernel", "plain")}
    print(f"tiled 888 {list(shape)} rel_l2 " + json.dumps(res), flush=True)
    for what in ("latent", "recon"):
        k, pl = res[f"{what}_kernel_vs_tiled_f32"], res[f"{what}_plain_vs_tiled_f32"]
        if not k <= BF16_SLACK * pl:
            raise AssertionError(f"tiled 888 {what}: kernel vs tiled f32 {k} > "
                                 f"{BF16_SLACK} x plain bf16 vs tiled f32 {pl}")


def serve_444(device) -> None:
    """Phase 12: one request through the v1.0 KL 4x4x4 model's kernel path
    (levels 0 and 1 at 256², a 64² latent) with its launches, then the
    end-to-end gate."""
    tok = make_tokenizer(KL_444_CFG, device)
    r = serve(tok, 1, REQUEST, PER_FORWARD["kl_444"])
    report("kl 444, kernel path: v1.0 kl 4x4x4 4chn", r, REQUEST)
    e2e_check(tok.core, tok.meta, REQUEST, "kl_444")


# where the checkpoint phase writes its file: inside the checkout, git-ignored
CKPT_DIR = "build/chip_smoke"


def checkpoint_round_trip(device) -> None:
    """Phase 13: the v1.0 flagship saved with ``VideoTokenizer.save`` and
    loaded back through ``load_model_from_config(cfg, ckpt=...)`` (read on
    the CPU, moved to the card); the weights and one request's z and
    reconstruction bit-equal to the model it was saved from; the save and
    load times and the file's size. The file is removed."""
    import os

    import torch

    from vidtok_tpu_torch import load_model_from_config

    tok = make_tokenizer(V1_0_CFG, device)
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, "flagship.ckpt")
    try:
        t0 = time.perf_counter()
        tok.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = load_model_from_config(V1_0_CFG, ckpt=path, device=device,
                                      compute_dtype=torch.bfloat16, fused=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    same_weights = all(torch.equal(a, b) for a, b in zip(
        tok.core.state_dict().values(), back.core.state_dict().values()))
    x = np.clip(np.random.RandomState(103).randn(*REQUEST) * 0.5, -1, 1).astype(np.float32)
    z, dec, _ = tok(x)
    z2, dec2, _ = back(x)
    torch.cuda.synchronize()
    same = torch.equal(z, z2) and torch.equal(dec, dec2)
    print(f"checkpoint: {size} bytes; save {save_s:.3f} s, load_model_from_config "
          f"with ckpt {load_s:.3f} s; weights equal {same_weights}; z and "
          f"reconstruction bit-equal {same}", flush=True)
    if not (same_weights and same):
        raise AssertionError("checkpoint round trip changed the model")


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


# The CLIs (phase 14, ``vidtok_tpu_torch/scripts``), each driven through
# the compute function its ``main`` calls, on frames made here (no video
# backend is needed): two clips of CLI_FRAMES frames at CLI_FPS, decoded
# size CLI_SIZE, which the CLIs' transform resizes to 256 x 455 and crops
# to 256², windows of 17 frames (three a clip); one clip of
# TILED_REQUEST's 65 frames for ``--read_long_video`` and for
# ``stream_tokens``. Two more configurations: the v1.0 FSQ 4x8x8 262144
# model (configs/vidtok_fsq_causal_488_262144.yaml, six levels of 8) and
# the v1.1 FSQ 4x8x8 32768 model (configs/v1_1/vidtok_fsq_causal_488_32768
# _v1_1.yaml), whose tokens ``stream_tokens`` emits.
FSQ_262144_CFG = _model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                        dict(_ENC, double_z=False, z_channels=6),
                        {"target": "FSQRegularizer", "params": {"levels": [8] * 6,
                                                                **_FSQ_LOSSES}})
FSQ_32768_V1_1_CFG = _model(
    "AutoencodingEngineV1_1", "EncoderCausal3DV1_1", "DecoderCausal3DV1_1",
    dict(_ENC_V1_1, double_z=False, z_channels=5),
    {"target": "FSQRegularizer", "params": {"levels": [8] * 5, **_FSQ_LOSSES}},
    use_tiling=False, t_chunk_enc=16)
CLI_SIZE = (360, 640)
CLI_CROP = 256
CLI_FPS = 30.0
CLI_FRAMES = 51
CLI_VIDEO = dict(sample_num_frames=17, sample_fps=30)
# the metrics on the card against the same functions on the CPU, relative
METRIC_GATE = 1e-4
LPIPS_GATE = 1e-3
# an encoder chunk of the tiled v1.1 model: 2 spatial and 2 temporal blocks
# at each of its 4 levels
PER_ENCODER_CHUNK = dict(dict.fromkeys(SOURCES, 0), fused_spatial_resblock=8,
                         fused_temporal_resblock_stream=8)


def cli_clip(seed: int, t: int, size=CLI_SIZE) -> np.ndarray:
    """uint8 [t, H, W, 3] frames from ``seed``: a smooth pattern of three
    sinusoids per channel drifting across the frame, plus noise."""
    rng = np.random.RandomState(seed)
    h, w = size
    yy, xx = (a.astype(np.float32) for a in np.mgrid[0:h, 0:w] / np.float32(h))
    freq, phase = rng.uniform(2, 9, (3, 3, 2)), rng.uniform(0, 6.3, (3, 3))
    out = np.empty((t, h, w, 3), np.uint8)
    for i in range(t):
        for c in range(3):
            v = sum(np.sin(fx * (xx - 0.02 * i) + fy * (yy + 0.01 * i) + p)
                    for (fx, fy), p in zip(freq[c], phase[c]))
            v = 0.5 + 0.15 * v + 0.03 * rng.standard_normal((h, w)).astype(np.float32)
            out[i, :, :, c] = (np.clip(v, 0, 1) * 255).astype(np.uint8)
    return out


def lpips_npz(path: str, seed: int = 0) -> None:
    """Random LPIPS weights in the JAX package's converted layout
    (``tools/convert_lpips.py``: HWIO kernels, ``[1,1,C,1]`` heads): He
    normal convs, zero biases, non-negative heads, as trained ones are."""
    from vidtok_tpu_torch.modules.lpips import _CHNS, _VGG16_PLAN

    rng = np.random.RandomState(seed)
    flat, cin = {}, 3
    for j, (ch, _) in enumerate(_VGG16_PLAN):
        flat[f"vgg/conv{j}/kernel"] = (rng.randn(3, 3, cin, ch) * np.sqrt(2 / (9 * cin))
                                      ).astype(np.float32)
        flat[f"vgg/conv{j}/bias"] = np.zeros(ch, np.float32)
        cin = ch
    for k, ch in enumerate(_CHNS):
        flat[f"lin{k}/kernel"] = np.abs(rng.randn(1, 1, ch, 1) / ch).astype(np.float32)
    np.savez(path, **flat)


def _launch_diff(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _window_line(what: str, clock, res, per: dict) -> str:
    """A window's times by part, its splits' metrics and its launches."""
    ms = " ".join(f"{k} {v * 1e3:.2f} ms" for k, v in clock.seconds.items())
    q = "; ".join(f"psnr {p:.4f} ssim {q:.4f}" + ("" if lp is None else f" lpips {lp:.4f}")
                  for p, q, lp in res)
    return f"cli {what}: {ms}; {q}; launches {{{_nonzero(per)}}}"


def _nonzero(per: dict) -> str:
    return ", ".join(f"{k}: {v}" for k, v in per.items() if v)


def cli_evaluate(device, tmp: str):
    """Phase 14a, the slice's main path: ``inference_evaluate`` on the v1.0
    flagship, its weights saved as a ``.ckpt`` and loaded through the CLI's
    own parser and loader (``--ckpt --bf16 --lpips_weights``, the LPIPS
    weights written by ``lpips_npz``). Every window: uint8 frames moved to
    the card and transformed there, the tokenizer, PSNR and SSIM, LPIPS
    (``evaluate_window``), each timed (host clock ending in a synchronize),
    its launches equal to PER_FORWARD["v1_0"]. The counts are set to 0
    before the first window and read after the last. Then the gates: the
    card's transform bit-equal to the CPU's, PSNR and SSIM within
    METRIC_GATE and f32 LPIPS within LPIPS_GATE of the same functions on
    the CPU on the same tensors; and a profile of one window. Returns
    (the tokenizer, the LPIPS module, the first clip)."""
    import os

    import torch

    from vidtok_tpu_torch.data import window_frame_ids
    from vidtok_tpu_torch.data.transforms import transform_u8
    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.scripts import inference_evaluate as PE
    from vidtok_tpu_torch.scripts.common import Clock, load_tokenizer

    ckpt, lp_path = os.path.join(tmp, "flagship.ckpt"), os.path.join(tmp, "lpips.npz")
    make_tokenizer(V1_0_CFG, torch.device("cpu")).save(ckpt)
    lpips_npz(lp_path)
    args = PE.get_parser().parse_args(["--config", "(resolved dict)", "--ckpt", ckpt,
                                       "--data_dir", tmp, "--lpips_weights", lp_path,
                                       "--bf16", "--device", str(device)])
    args.config = V1_0_CFG  # the card has no YAML parser: the resolved section
    t0 = time.perf_counter()
    tok = load_tokenizer(args)
    lpips = PE.load_lpips(args.lpips_weights, args.device)
    torch.cuda.synchronize()
    print(f"cli evaluate: flagship from --ckpt {os.path.getsize(ckpt)} bytes and "
          f"LPIPS loaded in {time.perf_counter() - t0:.3f} s; fused {tok.fused}, "
          f"{tok.compute_dtype}; cuDNN TF32 {torch.backends.cudnn.allow_tf32} "
          f"(LPIPS runs in f32)", flush=True)
    clips = [cli_clip(c, CLI_FRAMES) for c in range(2)]
    windows = [(c, ids) for c, u8 in enumerate(clips) for ids in window_frame_ids(
        CLI_FRAMES, CLI_FPS, CLI_VIDEO, is_causal=tok.is_causal)]
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t_all, seen, card_frames = time.perf_counter(), [], []
    for w, (c, ids) in enumerate(windows):
        before = K.counts()
        clock = Clock(device)
        frames = transform_u8(clips[c][ids], CLI_CROP, CLI_CROP, device)
        clock.lap("transform")
        res = PE.evaluate_window(tok, frames, lpips, clock)
        per = _launch_diff(before, K.counts())
        print(_window_line(f"evaluate window {w} (clip {c}, frames {ids[0]}-{ids[-1]})",
                           clock, res, per), flush=True)
        if per != PER_FORWARD["v1_0"]:
            raise AssertionError(f"cli evaluate window {w}: launches {per}")
        seen.append(sum(clock.seconds.values()))
        card_frames.append(frames)
    total = time.perf_counter() - t_all
    launches = K.counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(windows) * CLI_VIDEO["sample_num_frames"]
    print(f"cli evaluate: {len(windows)} windows, {n} frames in {total:.4f} s, "
          f"{n / total:.2f} frames/s ({(n - 17) / sum(seen[1:]):.2f} after the first "
          f"window); window s " + " ".join(f"{v:.4f}" for v in seen)
          + f"; peak_mem_bytes {peak}; launches {{{_nonzero(launches)}}}", flush=True)
    for name, n_launch in launches.items():
        if n_launch != len(windows) * PER_FORWARD["v1_0"][name]:
            raise AssertionError(f"cli evaluate: {name} launched {n_launch} times")
    for (c, ids), frames in zip(windows, card_frames):
        cpu = transform_u8(clips[c][ids], CLI_CROP, CLI_CROP, "cpu")
        if not torch.equal(frames.cpu(), cpu):
            d = (frames.cpu() - cpu).abs()
            raise AssertionError(f"cli transform: card != CPU on clip {c} frame {ids[0]}: "
                                 f"{int((d > 0).sum())} values differ, by up to "
                                 f"{float(d.max())}")
    print(f"cli transform: card bit-equal to the CPU on all {len(windows)} windows",
          flush=True)
    cli_metric_gates(tok, lpips, card_frames[-1])
    profile_call(lambda: PE.evaluate_window(tok, card_frames[0], lpips),
                 "profile evaluate window")
    return tok, lpips, clips[0]


def cli_metric_gates(tok, lpips, frames) -> None:
    """PSNR and SSIM of each split of one window, and LPIPS of its first
    split, on the card against the same functions on the CPU applied to
    the same tensors."""
    import copy

    import torch

    from vidtok_tpu_torch.ops.metrics import compute_psnr, compute_ssim
    from vidtok_tpu_torch.scripts.inference_evaluate import splits

    with torch.no_grad():
        x = frames[None].permute(0, 4, 1, 2, 3)
        a, b = (x + 1) / 2, (tok(x)[1].clamp(-1, 1) + 1) / 2
        rels = {}
        for s, e in splits(a.shape[2]):
            for name, fn in (("psnr", compute_psnr), ("ssim", compute_ssim)):
                card = float(fn(a[:, :, s:e], b[:, :, s:e]))
                cpu = float(fn(a[:, :, s:e].cpu(), b[:, :, s:e].cpu()))
                rels[f"{name}_{s}_{e}"] = abs(card - cpu) / abs(cpu)
        af, bf = (v[:, :, :16].transpose(1, 2).flatten(0, 1) * 2 - 1 for v in (a, b))
        card = lpips(af, bf)
        cpu = copy.deepcopy(lpips).cpu()(af.cpu(), bf.cpu())
        rels["lpips"] = rel_l2(card.cpu(), cpu)
        # what a caller with PyTorch's default (cuDNN TF32 on) gets
        tf32 = torch.backends.cudnn.allow_tf32
        ms = {}
        for on in (False, True):
            torch.backends.cudnn.allow_tf32 = on
            ms[on] = cuda_ms(lambda: lpips(af, bf))
            if on:
                rels["lpips_tf32_on"] = rel_l2(lpips(af, bf).cpu(), cpu)
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"cli lpips over {af.shape[0]} frame pairs of {list(af.shape[1:])}: "
          f"{ms[False]:.3f} ms with cuDNN TF32 off (the gated form), {ms[True]:.3f} "
          f"ms with it on", flush=True)
    print("cli metrics, card vs CPU relative " + json.dumps(rels), flush=True)
    for k, v in rels.items():
        if k != "lpips_tf32_on" and not v <= (LPIPS_GATE if k == "lpips" else METRIC_GATE):
            raise AssertionError(f"cli metrics: {k} card vs CPU {v}")


def cli_long_video(device, lpips) -> None:
    """Phase 14b: ``inference_evaluate --read_long_video --chunk_size 16``
    on the v1.1 KL model: one window of the whole 65-frame clip, tiled,
    with tiled_per_forward(65)'s launches (F 100, A 100, C 15, D 5)."""
    from vidtok_tpu_torch.data import window_frame_ids
    from vidtok_tpu_torch.data.transforms import transform_u8
    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.scripts.common import Clock, set_tiling
    from vidtok_tpu_torch.scripts.inference_evaluate import evaluate_window

    tok = make_tokenizer(V1_1_CFG, device)
    set_tiling(tok, T_CHUNK_ENC)
    t = TILED_REQUEST[2]
    u8 = cli_clip(2, t)
    (ids,) = window_frame_ids(t, CLI_FPS, CLI_VIDEO, read_long_video=True,
                              chunk_size=T_CHUNK_ENC, is_causal=tok.is_causal)
    want = tiled_per_forward(t)
    for run in ("first", "second"):
        K.reset_counts()
        clock = Clock(device)
        frames = transform_u8(u8[ids], CLI_CROP, CLI_CROP, device)
        clock.lap("transform")
        res = evaluate_window(tok, frames, lpips, clock)
        per = K.counts()
        print(_window_line(f"evaluate --read_long_video ({run} run, {len(ids)} frames, "
                           f"v1.1 kl tiled)", clock, res, per), flush=True)
        if per != want:
            raise AssertionError(f"cli long video: launches {per} != {want}")


def cli_reconstruct(device, tok, clip) -> None:
    """Phase 14c: ``inference_reconstruct --pad_gen_frames`` on the
    flagship over one clip: batches of 17 frames, each after the first
    preceded by the previous batch's last 3 reconstructed frames; the
    output uint8 [51, 256, 512, 3]; the launches 3 forwards' worth."""
    import torch

    from vidtok_tpu_torch.data.transforms import transform_u8
    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.scripts.inference_reconstruct import reconstruct

    frames = transform_u8(clip, CLI_CROP, CLI_CROP, device)
    for run in ("first", "second"):
        K.reset_counts()
        t0 = time.perf_counter()
        side = reconstruct(tok, frames, 16, pad_gen_frames=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per = K.counts()
        print(f"cli reconstruct --pad_gen_frames ({run} run): {side.shape[0]} frames in "
              f"{dt:.4f} s ({side.shape[0] / dt:.2f} frames/s); output "
              f"{list(side.shape)} {side.dtype}; launches {{{_nonzero(per)}}}", flush=True)
    if tuple(side.shape) != (CLI_FRAMES, CLI_CROP, 2 * CLI_CROP, 3) or side.dtype != torch.uint8:
        raise AssertionError(f"cli reconstruct: output {tuple(side.shape)} {side.dtype}")
    if per != {k: 3 * v for k, v in PER_FORWARD["v1_0"].items()}:
        raise AssertionError(f"cli reconstruct: launches {per}")


def cli_stream(device) -> None:
    """Phase 14d: ``stream_tokens`` on the v1.1 FSQ 32768 model over the
    65-frame clip: 5 ``encode_chunk`` steps (1 + 4 x 16 frames), each
    chunk's encode latency, launches (PER_ENCODER_CHUNK) and tokens; the
    z of the chunks bit-equal to the tiled ``encode`` of the whole clip."""
    import torch

    from vidtok_tpu_torch.data.transforms import transform_u8
    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.scripts.common import set_tiling
    from vidtok_tpu_torch.scripts.stream_tokens import stream_encode

    tok = make_tokenizer(FSQ_32768_V1_1_CFG, device)
    set_tiling(tok, T_CHUNK_ENC)
    t = TILED_REQUEST[2]
    u8 = cli_clip(3, t)
    zs, tokens = [], 0
    K.reset_counts()
    before = K.counts()
    for i, s, e, z, log, t_read, t_enc in stream_encode(
            tok, lambda s, e: transform_u8(u8[s:e], CLI_CROP, CLI_CROP, device), t):
        after = K.counts()
        per = _launch_diff(before, after)
        before = after
        n_tok = log["indices"].numel()
        tokens += n_tok
        zs.append(z)
        print(f"cli stream chunk {i} [{s}:{e}]: read+transform {t_read * 1e3:.2f} ms, "
              f"encode {t_enc * 1e3:.2f} ms, z {list(z.shape)}, tokens {n_tok}; "
              f"launches {{{_nonzero(per)}}}", flush=True)
        if per != PER_ENCODER_CHUNK:
            raise AssertionError(f"cli stream chunk {i}: launches {per}")
    z_stream = torch.cat(zs, dim=2)
    x = transform_u8(u8, CLI_CROP, CLI_CROP, device)[None].permute(0, 4, 1, 2, 3)
    z_tiled = tok.encode(x).cpu()
    same = torch.equal(z_stream, z_tiled)
    print(f"cli stream: {tokens} tokens, z {list(z_stream.shape)}; bit-equal to the "
          f"tiled encode of the clip: {same}", flush=True)
    if not same:
        raise AssertionError("cli stream: z != the tiled encode")


def cli_fsq_262144(device, lpips, clip) -> None:
    """Phase 14e: one evaluate window through the v1.0 FSQ 262144 model
    (the flagship's shapes, A-E launches as PER_FORWARD["v1_0"]), its peak
    memory beside the entropy loss's [positions, 262144] f32 matrices,
    which it computes in full on every call as JAX does."""
    import torch

    from vidtok_tpu_torch.data.transforms import transform_u8
    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.scripts.common import Clock
    from vidtok_tpu_torch.scripts.inference_evaluate import evaluate_window

    tok = make_tokenizer(FSQ_262144_CFG, device)
    codes = tok.core.regularization.fsq.codebook_size
    frames = transform_u8(clip[:17], CLI_CROP, CLI_CROP, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    clock = Clock(device)
    res = evaluate_window(tok, frames, lpips, clock)
    per = K.counts()
    peak = torch.cuda.max_memory_allocated()
    positions = 5 * (CLI_CROP // 8) ** 2  # 17 frames padded to 20, 4x8x8
    print(_window_line("evaluate fsq 262144 window (v1.0 fsq 4x8x8, 6 levels)",
                       clock, res, per) + f"; peak_mem_bytes {peak}; the entropy "
          f"loss's [{positions}, {codes}] f32 matrix {positions * codes * 4} bytes, "
          f"its chain of 3 {3 * positions * codes * 4}", flush=True)
    if per != PER_FORWARD["v1_0"]:
        raise AssertionError(f"cli fsq 262144: launches {per}")


def cli_subprocesses(device, tmp: str) -> None:
    """Phase 14f: each CLI as a subprocess on an mp4 written here, when
    this machine can write one (OpenCV) and read a YAML config (PyYAML);
    otherwise one line saying what is missing. The compute above ran
    either way; nothing here picks a kernel or a device."""
    import importlib.util
    import os

    from vidtok_tpu_torch.data import native_reader

    missing = [name for mod, name in (("cv2", "OpenCV (cv2) to write the mp4"),
                                      ("yaml", "PyYAML to read --config"))
               if importlib.util.find_spec(mod) is None]
    native = native_reader.available()
    if missing:
        print(f"cli subprocesses: the CLIs' file I/O did not run on this machine: it "
              f"lacks {' and '.join(missing)}; the native decoder "
              f"{'loads' if native else 'does not load'}", flush=True)
        return
    import yaml

    from vidtok_tpu_torch.data import write_video

    video_dir = os.path.join(tmp, "videos")
    os.makedirs(video_dir, exist_ok=True)
    clip = os.path.join(video_dir, "clip.mp4")
    write_video(clip, cli_clip(4, CLI_FRAMES), fps=CLI_FPS)
    cfgs = {}
    for name, cfg in (("flagship", V1_0_CFG), ("fsq_32768", FSQ_32768_V1_1_CFG)):
        cfgs[name] = os.path.join(tmp, f"{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump(cfg, f)
    runs = {
        "inference_evaluate": ["--config", cfgs["flagship"], "--data_dir", video_dir,
                               "--ckpt", os.path.join(tmp, "flagship.ckpt"),
                               "--lpips_weights", os.path.join(tmp, "lpips.npz")],
        "inference_reconstruct": ["--config", cfgs["flagship"], "--input_video_path", clip,
                                  "--pad_gen_frames", "--output_video_dir", tmp],
        "stream_tokens": ["--config", cfgs["fsq_32768"], "--input_video_path", clip,
                          "--out", os.path.join(tmp, "z.npz")]}
    for name, args in runs.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"vidtok_tpu_torch.scripts.{name}",
                            "--bf16", "--device", str(device), "--input_height",
                            str(CLI_CROP), "--input_width", str(CLI_CROP)] + args,
                           capture_output=True, text=True, timeout=600)
        tail = r.stdout.strip().splitlines()[-3:]
        print(f"cli subprocess {name}: rc {r.returncode} in {time.perf_counter() - t0:.1f} s"
              f" (native decoder {'on' if native else 'off'}): " + " | ".join(tail),
              flush=True)
        if r.returncode:
            raise AssertionError(f"cli subprocess {name} failed: {r.stderr[-2000:]}")


def serve_clis(device, t: float) -> float:
    """Phase 14: the CLIs (14a-14f); its files under CKPT_DIR, removed
    after."""
    import os
    import shutil
    import tempfile

    import torch

    os.makedirs(CKPT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=CKPT_DIR)
    try:
        tok, lpips, clip = cli_evaluate(device, tmp)
        t = phase("cli evaluate", t)
        cli_reconstruct(device, tok, clip)
        del tok
        torch.cuda.empty_cache()
        t = phase("cli reconstruct", t)
        cli_long_video(device, lpips)
        torch.cuda.empty_cache()
        t = phase("cli evaluate long video", t)
        cli_stream(device)
        torch.cuda.empty_cache()
        t = phase("cli stream_tokens", t)
        cli_fsq_262144(device, lpips, clip)
        torch.cuda.empty_cache()
        t = phase("cli evaluate fsq 262144", t)
        cli_subprocesses(device, tmp)
        t = phase("cli subprocesses", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return t


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
    torch.cuda.empty_cache()
    t = phase("v1.0 kl forms serve", t)
    serve_both_paths("non-causal kl 4x8x8 16chn", NONCAUSAL_CFG, "noncausal", device,
                     CONFIG_PATHS["noncausal"][1])
    torch.cuda.empty_cache()
    t = phase("non-causal kl serve", t)
    check_fsq_41616(device)
    torch.cuda.empty_cache()
    t = phase("v1.1 fsq 41616 262144 serve", t)
    serve_tiled_888(device)
    torch.cuda.empty_cache()
    t = phase("v1.1 fsq 888 tiled serve", t)
    serve_444(device)
    torch.cuda.empty_cache()
    t = phase("v1.0 kl 444 serve", t)
    checkpoint_round_trip(device)
    t = phase("checkpoint", t)
    serve_clis(device, t)
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
