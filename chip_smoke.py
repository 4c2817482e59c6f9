#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vidtok_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. build the sixteen hand-written kernels from ``vidtok_tpu_torch/csrc``
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
   at their chunk shapes. J and K (the trilinear temporal upsample's
   interpolation and blend) at every call shape of the v1.1 paths, J's
   later chunks with their cached frames, both also at two clips of 33²
   at C 200 and 37 (PARTIAL_LINEAR, checked, not timed). The kernels of
   the decoder's other forms
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
   whose launches of T1-T4 the result line reports; then the f32 forms
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
   of phase 20's models (WIDTH_PATHS, timed per forward of their paths);
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
10b. the v1.0 FSQ 4096 flagship with FSQ's other options (FSQ_OPTIONS:
    project_in 4 -> 8 onto two codebooks of 4096, project_out 8 -> 4,
    ``diversity_gamma`` 0.5, ``inv_temperature`` 10): 3 requests of
    [1, 3, 17, 256, 256] checked as in 5 (indices [1, 5, 32, 32, 2],
    decoding from them equal to the forward's), latency and peak memory,
    and the end-to-end gate, which also holds the kernel path's share of
    indices unlike the f32 plain run's to 1.1x the plain bf16 path's;
10c. one [1, 3, 16, 256, 256] request through the non-causal FSQ 262144
    model (configs/vidtok_fsq_noncausal_488_262144.yaml; A 20, C 3),
    checked as in 5, with its peak memory beside the entropy loss's
    [4096, 262144] f32 matrix;
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
    PyYAML import, else a line saying which is missing;
15. training (``vidtok_tpu_torch/train``, ``serve_training``) at the
    recipe of the configs (``loss_config``, ``training``: bf16-mixed,
    activation checkpointing on) with ``disc_start`` 0 and an EMA: (a) the
    flagship at batch 2 of [17, 256, 256], seeded random weights and LPIPS
    weights: its first step against the same step in fp32 (each loss of
    TRAIN_LOGS within TRAIN_SLACK x the reconstruction's bf16 spread),
    1 warm-up + 4 timed steps (s/step, peak memory), a profile of one
    step; gates: finite logs, generator, discriminator and logvar moved,
    ``d_weight`` > 0, the adaptive weight's norm ratio before its clip
    inside (0, 1e4) in both runs and within the same bf16 bound (the
    discriminator's last conv at TRAIN_DISC_GAIN x its init, so that the
    clip does not hide the ratio); (b) validation of the trained weights and of their
    EMA through the serving engine (kernels A-E, 20/20/3/1/2 a forward),
    each held to the f32 plain run by ``e2e_check`` and bit-equal after the
    kernels' operand cache is rebuilt (a stale cache would score the old
    weights); (c) the train state saved and restored into another trainer,
    whose next step is bit-equal to the continued run's; (d) one step of
    the v1.0 FSQ 4096 model: the reconstruction loss reaches the encoder
    (straight-through rounding), indices in range, finite aux_loss; (e) one
    v1.1 step at batch 2 of [33, 256, 256] and its peak memory; (f) the
    train CLI as a subprocess on written clips: the tiny model 3 steps with
    a checkpoint and a validation, ``--resume`` to step 5 (the JSONL holds
    steps 1-5), and the flagship's config for 2 steps;
16. VidTwin (``vidtok_tpu_torch/models/vidtwin``, ``serve_vidtwin``) at
    the full width of configs/vidtwin/vidtwin_structure_7_7_8_dynamics_7_8
    .yaml (311,518,770 parameters; VIDTWIN_CFG), seeded weights with the
    zero-initialised ones drawn too (``fill_zero_init_``): (a) 3 requests
    of [4, 3, 16, 224, 224] in bf16 (weights bf16 at rest): latency,
    frames/s, peak memory, no launch of the sixteen kernels, a profile of
    one; one request in f32 (f32 attention, TF32 off), the bf16 run within
    VIDTWIN_BF16_GATE of it on z and the reconstruction; ``only_part``
    and ``cross_reenact`` shapes, the cross result unlike both
    self-reconstructions; the encoder's causality in f32; the model cut to
    depth 2 in f32 on the card against the CPU (relative L2 1e-4); (b) a
    reference-named ``.ckpt`` with the keys JAX's converter drops, loaded
    through ``load_model_from_config(cfg, ckpt=...)``, bit-equal; (c)
    ``vidtwin_evaluate`` and ``vidtwin_reconstruct`` (and its
    cross-reenactment) as subprocesses on two written mp4s, finite PSNR
    and SSIM; (d) ``VidTwinTrainer`` at the config's recipe with
    ``disc_start`` 0 and ``warmup_steps`` 2: one fp32 step, 6 bf16-mixed
    steps at batch 2 of [16, 224, 224] (s/step, peak memory, a profile),
    gated as phase 15a (finite logs, parameters moved by step 2,
    ``d_weight`` > 0 inside its clip, first-step losses within the
    reconstruction's bf16 spread of fp32's).
17. the last modules of the port (``serve_ladder_and_sharding``; no
    launch of the sixteen kernels but (b)'s E): (a) VidTwin's ablation ladder,
    each of ABLATION_TARGETS at VIDTWIN_CFG's width with its target
    changed (the other Q-Formers at JAX's defaults), seeded weights with
    the zero-initialised ones drawn: its parameter count, one cold and
    ABLATION_TIMED bf16 requests of VIDTWIN_REQUEST (latency, frames/s,
    peak memory), one f32 request (f32 attention) with the bf16 run
    within VIDTWIN_BF16_GATE of it, and the model cut to depth 2 on the
    card against the CPU (VIDTWIN_CPU_GATE); the Qformer's reference-named
    ``.ckpt`` through ``load_model_from_config(cfg, ckpt=...)``,
    bit-equal; ``VidTwinTrainer`` on SymDis, one fp32 and
    ABLATION_TRAIN_STEPS bf16-mixed steps at batch 2 (finite logs,
    parameters moved, ``d_weight`` > 0, ``kl_loss`` 0); (b)
    ``forward_sharded`` of the v1.0 flagship and the FSQ 4096 model at
    SHARDED_REQUEST in f32 (TF32 off), SHARDED_WORLD gloo processes on the
    card (NCCL refuses two ranks on one device), against the
    single-process plain f32 run: z and the reconstruction within
    SHARDED_GATE, kl_loss and aux_loss too, FSQ's indices but for
    SHARDED_FLIP_SHARE of them, each rank's whole results equal; the
    flagship also in bf16 with the nearest temporal upsample's kernel E on
    each rank's slab (its halo rows included), as JAX's sharded graph takes
    Pallas E: E launched PER_FORWARD["v1_0"] times a rank and no other
    kernel, no further from the f32 run than BF16_SLACK x the plain bf16
    run is; the wall times (two ranks on one card measure correctness, not
    scaling); (c)
    ``utils/profiling.trace`` around one flagship f32 request writes a
    trace file, ``device_memory_report()``'s peak equals
    ``max_memory_allocated``.
18. the public surface (``serve_public_surface``): the v1.0 flagship built
    from ``merge_configs(FLAGSHIP_YAML, DECODER_TARGET)`` (its decoder
    target ``Decoder``, which names no variant and so takes the
    encoder's, as JAX's ``build_core_from_config`` does) through ``load_model_from_config(...,
    device="cuda", compute_dtype=torch.bfloat16)``, so the kernel path is on;
    against the flagship built from the file alone with the same seed: both
    157,949,351 parameters, the state dicts equal (as built, and after
    ``randomize_``), z and the reconstruction bit-equal on N_REQUESTS
    requests of REQUEST; the request latency, busy share (a profile of one
    request) and peak memory on a line of their own, the launches per
    forward (PER_FORWARD["v1_0"]) and the end-to-end gate of phase 3; then
    ``core.regularize(core.encode_raw(x, fused=True))`` bit-equal to
    ``core.encode(x, fused=True)`` (the mode: ``sample=False``), and the
    posterior's ``var`` and ``nll(mode)`` finite.
19. f32 through the kernels (``serve_f32``), the engine's default on the
    card, as JAX's default engine serves f32 through its Pallas kernels:
    the v1.0 flagship from ``load_model_from_config(cfg, device=...,
    compute_dtype=torch.float32)`` (``fused`` unset: on), 3 requests of
    [1, 3, 17, 256, 256] (launches A 20, B 20, C 3, D 1, E 2 a forward)
    with latency, frames/s, peak memory and the busy share of a profiled
    one, 2 requests on the plain f32 path for comparison; z and the
    reconstruction within F32_E2E_GATE (2e-4, README's golden tolerance)
    of the plain f32 path at that shape and at [1, 3, 17, 264, 264]; one
    f32 request in the forms ("merged", "merged", "taps") (H 2, I 3, D' 1
    a forward) and one in ("split", "split", "packed") (G 2, C 3, D 1),
    each timed with its launches and held to the plain f32 path at
    F32_E2E_GATE at both shapes; then the v1.1 model tiled, 3 requests of
    [1, 3, 65, 256, 256] (F 100, A 100, C 15, D 5), the same records and
    the gate against the tiled plain f32 path, and one request in
    ("fused", "merged", "taps") (I 15, D' 5) held to it likewise.
20. other channel widths through the kernels (``serve_widths``): the
    flagship at ch 96 (88,995,399 parameters; levels of 96, 192 and 384
    channels) and at ch 64 (39,685,863; 64, 128, 256), each the file loaded
    and passed through ``merge_configs`` with ``ch`` set in both the
    encoder's and the decoder's params (``width_override``), with the
    flagship's launches (A 20, B 20, C 3, D 1, E 2 a forward): N_REQUESTS
    bf16 requests of REQUEST on the kernel and the plain path, a profile of
    one, the end-to-end gate of phase 3 at REQUEST and at PARTIAL_REQUEST,
    then one f32 request on the default f32 kernel path held to the plain
    f32 path at F32_E2E_GATE at both shapes; and the CPU tests' ch-32 v1.1
    model (CH32_CFG, tests/test_torch_model.py's) at CH32_REQUEST:
    N_REQUESTS bf16 requests (A 6, B 6, C 1, D 1 a forward), the end-to-end
    gate, one f32 request and its gate.

Phase 2 also holds every call shape of phases 9-12 that the earlier
phases do not give (``model_calls``: A at 16² x 512 channels and at 256²
with 128 -> 256 channels, B at the 41616 and 444 shapes, F at the 888
chunks' shapes and offsets, C, and D on [2 cached | chunk] with
``t_chunk_dec`` 2), timed per forward of its path.

``python3 chip_smoke.py --kernels NAME[,NAME...]`` runs phases 1 and 2 for
the named kernels of SOURCES and TOOL_SOURCES alone, in bf16 and f32 (and
D's T=201 window when D is named, in both, D''s in f32 when D' is; a
tool's kernel at the tools' shapes),
reports every gate that fails and exits 1 if any did, with no result line:
the check to run from a copy of the checkout with a planted fault.

It never falls back to the CPU or to a plain version. The last two lines of
standard output are a JSON object with the per-kernel results (``headers``:
the shared GEMM loop, and B's and F's shared block, a kernel is built on
besides its source; launches
from phase 3's kernel-path run for A-E, phase 7's for F, and phase 8's for
G (its ``split`` request), H, I and D', and the tools' runs for T1-T4,
whose numbers are those of one row of the tool at its first shape, with
every row beside; then the f32 forms of A-I and D', named "<kernel>
(f32)", with phase 19's launches and times per forward of its request
that runs them: the v1.0 f32 request's, F the tiled one's, G the
``split`` forms' request's, H, I and D' the ``merged`` forms' one's) and ``{"ok": true, "device": {...}}``. Needs one CUDA device;
imports no JAX.
"""

from __future__ import annotations

import functools
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
# Phase 10b: the FSQ 4096 flagship with FSQ's other options, which no config
# sets: z_channels 4 through project_in (4 -> 8) onto two codebooks of the
# file's four levels, project_out (8 -> 4); ``dim`` is named because it
# defaults to the codebooks' 8 values, which would leave out the projections.
# Phase 10c: the non-causal FSQ 262144 model (configs/vidtok_fsq_noncausal_
# 488_262144.yaml), the one configuration no earlier phase serves.
FSQ_OPTIONS = {"dim": 4, "num_codebooks": 2, "diversity_gamma": 0.5,
               "inv_temperature": 10.0}
FSQ_OPTIONS_CFG = _model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                         _ENC_FSQ, {"target": "FSQRegularizer", "params": {
                             "levels": [8, 8, 8, 8], **_FSQ_LOSSES, **FSQ_OPTIONS}})
NONCAUSAL_FSQ_CFG = _model(
    "AutoencodingEngine", "Encoder3D", "Decoder3D",
    {k: v for k, v in _ENC.items() if k != "init_pad_mode"} | dict(double_z=False,
                                                                    z_channels=6),
    {"target": "FSQRegularizer", "params": {"levels": [8] * 6, **_FSQ_LOSSES}})
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
    # J and K replace no TPU kernel: XLA fuses the JAX module's chain
    "temporal_linear_up2x": ("vidtok_tpu_torch/csrc/temporal_linear.cu",
                             "none (vidtok_tpu/modules/blocks.py:538-571, XLA)", ()),
    "linear_blend": ("vidtok_tpu_torch/csrc/temporal_linear.cu",
                     "none (vidtok_tpu/modules/blocks.py:571, XLA)", ()),
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
PER_FORWARD["v1_1"] = dict(PER_FORWARD["v1_0"], parity_up2x_fused=0, temporal_linear_up2x=2,
                           linear_blend=2)
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
# kernels J and K at two clips of a 33² frame, at a width that is a multiple
# of 8 and not a power of 2 (vectors) and at one that is not a multiple of 8
# (a channel a thread): J's head and tail segments, one segment, a later
# chunk
PARTIAL_LINEAR = [(2, 5, 33, 33, 200), (2, 5, 33, 33, 37)]
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
# Phase 20: the flagship at other channel widths, as a user makes one: the
# loaded file (``load_config``) through ``merge_configs`` with ``ch`` set in
# both the encoder's and the decoder's params (the file's decoder params
# are a reference to the encoder's, resolved when the file is loaded), and
# the CPU tests' ch-32 v1.1 model (tests/test_torch_model.py's CFG). Each
# width -> (ch, parameters); the paths' configs as dicts for model_calls.
WIDTHS = {"ch96": (96, 88_995_399), "ch64": (64, 39_685_863)}


def width_override(ch: int) -> dict:
    """The ``merge_configs`` override that sets the flagship's width."""
    return {"model": {"params": {"encoder_config": {"params": {"ch": ch}},
                                 "decoder_config": {"params": {"ch": ch}}}}}


def _width_cfg(ch: int) -> dict:
    from vidtok_tpu_torch.config import merge_configs

    return merge_configs(V1_0_CFG, width_override(ch))


_CH32 = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 32,
         "ch_mult": [1, 2], "time_downsample_factor": 2, "num_res_blocks": 1,
         "norm_type": "layernorm", "interpolation_mode": "trilinear", "tempo_ds": [0],
         "tempo_us": [1]}
CH32_CFG = _model("AutoencodingEngineV1_1", "EncoderCausal3DV1_1", "DecoderCausal3DV1_1",
                  _CH32, _KL)
CH32_REQUEST = (1, 3, 17, 128, 128)
WIDTH_PATHS = {name: (_width_cfg(ch), REQUEST, False) for name, (ch, _) in WIDTHS.items()}
WIDTH_PATHS["ch32"] = (CH32_CFG, CH32_REQUEST, False)
PATHS = ("v1_0", "v1_1", "tiled") + tuple(FORMS) + tuple(CONFIG_PATHS) + tuple(WIDTH_PATHS)

# The kernels on f32 activations (phase 19, ``serve_f32``, and phase 2's
# f32 checks): the wgmma loop's f32 scheme (csrc/wgmma_conv.cuh: bf16
# pieces, six products) in A, B, E and F, the tail's (decoder_tail.cu) in D
# and D', the templates of C, G, H and I. The engine serves f32 through
# them by default on the card (``load_model_from_config(...,
# compute_dtype=torch.float32)``), as JAX's default engine serves f32
# through its Pallas kernels, in every form. Requests: the v1.0 flagship at
# REQUEST (F32_PATHS[0]) and the tiled v1.1 model at TILED_REQUEST
# (F32_PATHS[1]), then each in the forms of F32_FORMS, each held to its
# plain f32 path (TF32 off) at F32_E2E_GATE, the golden tolerance of
# README.md; each kernel's f32 form to its plain version in f32 at
# F32_GATE at every call shape of those requests (``f32_calls``), the
# other stream-start mode of B, E, G, H, D and D', F at both
# ``first_chunk`` values, one partial-tile shape each (F32_PARTIAL: a 33²
# latent; F there at every offset of F32_OFFSETS) and A's, E's, D's and
# D''s T=201 calls (SPATIAL_LONG, PARITY_LONG, TAIL_LONG). A, B, F, D and
# D' are also held there on rows offset by F32_ROW_MEAN, a mean beside
# which E[x^2] - mean^2 loses about 1e-4 of the activation in f32: the
# residual blocks' first output less x, F's caches and D's and D''s output
# as they are.
F32_GATE = 2e-5
F32_ROW_MEAN = 50.0
F32_E2E_GATE = 2e-4
# the forms' f32 requests: path -> the FORMS path whose forms they take
F32_FORMS = {"v1_0_forms_f32": "v1_0_forms", "v1_0_split_f32": "v1_0_split",
             "tiled_forms_f32": "tiled_forms"}
F32_PATHS = ("v1_0_f32", "tiled_f32") + tuple(F32_FORMS)
F32_OFFSETS = (0, 1, 2, 4)
F32_PARTIAL = {"fused_spatial_resblock": (5, 33, 33, 512, 512),
               "fused_temporal_resblock": (2, 5, 33, 33, 512),
               "fused_temporal_resblock_stream": (1, 5, 33, 33, 512),
               "subpixel_interleave": (5, 33, 33, 512),
               "decoder_tail_rgb": (2, 6, 33, 33, 128),
               "parity_up2x_fused": (2, 5, 33, 33, 512),
               "parity_blend_interleave": (2, 5, 33, 33, 512),
               "parity_blend_interleave4": (2, 5, 33, 33, 512),
               "subpixel_interleave_z": (5, 33, 33, 512),
               "decoder_tail_rgb_taps": (2, 6, 33, 33, 128)}
F32_KERNELS = tuple(F32_PARTIAL)
# each f32 kernel's path in the result line (launches, times)
F32_MAIN_PATH = dict.fromkeys(F32_KERNELS, "v1_0_f32") | {
    "fused_temporal_resblock_stream": "tiled_f32",
    "parity_blend_interleave": "v1_0_split_f32",
    "parity_blend_interleave4": "v1_0_forms_f32",
    "subpixel_interleave_z": "v1_0_forms_f32",
    "decoder_tail_rgb_taps": "v1_0_forms_f32"}

# the path whose serving run gives each kernel's launches and times in the
# result line
MAIN_PATH = dict.fromkeys(SOURCES, "v1_0")
MAIN_PATH.update(fused_temporal_resblock_stream="tiled", temporal_linear_up2x="tiled",
                 linear_blend="tiled",
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
    (tiled: with the 2 cached frames); C at every spatial upsample; J and K
    at every trilinear (v1.1) temporal upsample, J keyed (shape, split,
    cached front: a later chunk), K by its y's shape."""
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
        c, cur, offs, ntu = ch * mult[-1], 1, {}, 1
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
                    elif variant == "causal_v1_1":
                        later = tiled and not first
                        calls["temporal_linear_up2x",
                              ((b, f, s, s, c), 0 if later else ntu, later)] += 1
                        calls["linear_blend", (b, 2 * f, s, s, c)] += 1
                    f *= 2
                    ntu *= 2
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


for _path, (_cfg, _shape, _tiled) in (CONFIG_PATHS | WIDTH_PATHS).items():
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
    decoder chunks, F = A = 8E + 12D, C = 3D, D's tail D, J = K = 2D, B =
    E's kernel = 0 (T=65: 100, 100, 15, 5, 10, 10, 0, 0)."""
    per = per_forward(tiled_calls(t, size))
    n_enc, n_dec = map(len, chunk_schedule(t))
    want = dict(per, fused_temporal_resblock_stream=8 * n_enc + 12 * n_dec,
                fused_spatial_resblock=8 * n_enc + 12 * n_dec,
                subpixel_interleave=3 * n_dec, decoder_tail_rgb=n_dec,
                temporal_linear_up2x=2 * n_dec, linear_blend=2 * n_dec,
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


def work(name: str, key, elem: int = 2) -> tuple:
    """(bytes, tensor-core FLOP, other FLOP) one call must move and do:
    each input read once, each output written once, in ``elem``-byte
    elements (bf16), the f32 parameters read once; the FLOP of the function (E: the three base 3x3
    convs of each input frame, 27 C^2 MACs per half-rate position, which
    give both output frames as ``parity_up2x_fused_plain`` computes them,
    not E's own 36 C^2 nor a 3x3x3 conv at the output rate, 54 C^2; D and
    D': the 3-channel conv, not D''s products padded to 8 channels)."""
    if name == "fused_spatial_resblock":
        n, h, w, cin, c = key
        m, k = n * h * w, 9 * cin * c + 9 * c * c + (cin * c if cin != c else 0)
        return elem * m * (cin + c) + 4 * (k + 2 * cin + 5 * c), 2 * m * k, 0
    if name in ("fused_temporal_resblock", "fused_temporal_resblock_stream"):
        (b, t, h, w, c), first = key[0], key[1]
        m = b * t * h * w
        caches = 0 if name == "fused_temporal_resblock" else (2 if first else 4)
        return (elem * (2 * m * c + caches * b * 2 * h * w * c)
                + 4 * (6 * c * c + 6 * c), 12 * m * c * c, 0)
    if name in ("subpixel_interleave", "subpixel_interleave_z"):
        # I: the 4HWC of z it needs (z holds 4(H+1)(W+1)C)
        n, h, w, c = key
        return elem * 8 * n * h * w * c + 4 * c, 0, 4 * n * h * w * c
    if name in ("parity_blend_interleave", "parity_blend_interleave4"):
        # s, the cur and prev halves (4C) read, 2C written; 5 FLOP a value
        b, t, h, w, c = key[0]
        m = b * t * h * w
        return elem * 7 * m * c + 4 * (c + 1), 0, 5 * 2 * m * c
    if name in ("decoder_tail_rgb", "decoder_tail_rgb_taps"):
        b, t, h, w, c = key[0]
        m = b * t * h * w
        return elem * m * (c + 3) + 4 * (2 * c + 81 * c + 3), 2 * m * 81 * c, 0
    if name == "temporal_linear_up2x":
        # x read, [front | up] written (2T + 2 frames); a later chunk reads
        # its 2 cached front frames and 1 previous frame; 4 FLOP a value
        (b, t, h, w, c), _, cached = key
        frame = b * h * w * c
        return elem * (t * frame + (2 * t + 2) * frame + 3 * cached * frame), 0, 8 * t * frame
    if name == "linear_blend":
        # up and y read, y written; the f32 bias and alpha; 5 FLOP a value
        m = _nel(key)
        return elem * 3 * m + 4 * (key[-1] + 1), 0, 5 * m
    b, t, h, w, c = key[0]  # parity_up2x_fused
    m = b * t * h * w
    return elem * 3 * m * c + 4 * (27 * c * c + c + 1), 2 * m * 27 * c * c, 0


def f32_work(name: str, key) -> tuple:
    """``work`` of a kernel's f32 form: f32 activations (4 bytes), and the
    function's FLOP at the rate of the f32 scheme: the tensor-core FLOP
    times the scheme's products (the bf16 rate over len(PRODUCTS)); C, G,
    H and I none."""
    from vidtok_tpu_torch.ops.kernels.split import PRODUCTS

    nbytes, mma, vec = work(name, key, 4)
    return nbytes, len(PRODUCTS) * mma, vec


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
    # J and K at the trilinear upsamples' call shapes (J of a later chunk
    # with its cached frames; K writes its y in place, so its kernel runs on
    # a copy made here, once)
    for key, calls in shapes["temporal_linear_up2x"].items():
        yield _linear_up_case(p, key, dict(calls), bf)
    for key, calls in shapes["linear_blend"].items():
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
    for shape in PARTIAL_LINEAR:
        for split, cached in ((1, False), (shape[1], False), (0, True)):
            yield _linear_up_case(r, (shape, split, cached), {}, bf)
        b, t, h, w, c = shape
        yield _blend_case(r, (b, 2 * t, h, w, c), {}, bf)
    yield from width_cases(device, bf, 5)


def _linear_up_case(p, key, calls: dict, dtype) -> Case:
    """Kernel J at ``key`` (shape, split, cached): a later chunk's call
    reads a cache of 2 input frames and the 2 cached up-frames."""
    from vidtok_tpu_torch.ops.kernels import temporal_linear as tl

    (b, t, h, w, c), split, cached = key
    prev = p.x((b, 2, h, w, c), dtype) if cached else None
    front = p.x((b, 2, h, w, c), dtype) if cached else "replicate"
    return Case("temporal_linear_up2x", key, calls, tl.temporal_linear_up2x,
                tl.temporal_linear_up2x_plain, (p.x((b, t, h, w, c), dtype), split, prev,
                                                front))


def _blend_case(p, key, calls: dict, dtype) -> Case:
    """Kernel K on y ``key``: the kernel writes into a copy of y made once,
    so that the plain version reads y as drawn."""
    from vidtok_tpu_torch.ops.kernels import temporal_linear as tl

    b, ty, h, w, c = key
    y = p.x(key, dtype)
    out = y.clone()
    alpha = p.t(1 / (1 + np.exp(-(2.0 + 0.5 * p.rng.randn(1)))))
    return Case("linear_blend", key, calls,
                lambda full, y, bias, alpha: tl.linear_blend(full, out, bias, alpha),
                tl.linear_blend_plain,
                (p.x((b, ty + 2, h, w, c), dtype), y, p.t(0.1 * p.rng.randn(c)), alpha))


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


def swap_calls(calls: Counter, path: str) -> Counter:
    """``model_calls`` of the default forms moved to the kernels of the
    FORMS ``path`` (the same call keys)."""
    swaps = form_swaps(path)
    out = Counter()
    for (name, key), n in calls.items():
        out[swaps.get(name, name), key] += n
    return out


def f32_calls() -> dict:
    """F32_PATHS' path -> ``model_calls`` of one forward of its request."""
    calls = {"v1_0_f32": model_calls(V1_0_CFG, REQUEST),
             "tiled_f32": tiled_calls(TILED_REQUEST[2])}
    for path, forms in F32_FORMS.items():
        calls[path] = swap_calls(calls[FORMS[forms][1] + "_f32"], forms)
    return calls


def f32_kernel_cases(device):
    """Yield a ``Case`` for every f32 call shape of A-I and D' (see
    F32_GATE): f32 activations and parameters on ``device``, cuDNN's f32
    convs of the block (A, B, F), E's per-frame conv C -> 3C and D's and
    D''s 3x3x3 conv as the yardstick."""
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


def report(what: str, r: dict, shape, dtype: str = "bf16") -> None:
    print(f"serve {what}; request {list(shape)} {dtype}; latency_s "
          + " ".join(f"{v:.4f}" for v in r["latency_s"])
          + f"; frames_per_s (best after the first) {r['frames_per_s']:.2f};"
          f" peak_mem_bytes {r['peak_mem_bytes']}; launches {r['launches']}",
          flush=True)


def profile_request(tok, shape):
    """Device time by kernel over one request (torch.profiler), and the
    device's busy share of the request's wall time, which it returns."""
    x = np.zeros(shape, np.float32)
    tok(x)
    return profile_call(lambda: tok(x))


def profile_call(fn, label: str = "profile"):
    """Device time by kernel over one call of ``fn`` (torch.profiler; warm
    it up first), and the device's busy share of the call's wall time,
    which it returns (None where no device time was recorded)."""
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
        return None
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    kernels_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"{label}: wall {wall_ms:.2f} ms, device kernels {kernels_ms:.2f} ms "
          f"(busy share {kernels_ms / wall_ms:.3f})", flush=True)
    for e in rows[:12]:
        print(f"{label}: {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:100]}", flush=True)
    return kernels_ms / wall_ms


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
    FORMS path in its forms, with its own. An FSQ model's result also
    gives, for each bf16 run, the share of its indices unlike the f32
    run's (``indices_{run}_vs_f32``).
    """
    import torch

    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer
    from vidtok_tpu_torch.ops import kernels as K

    x = np.clip(np.random.RandomState(100).randn(*shape) * 0.5, -1, 1) \
        .astype(np.float32)
    outs, indices = {}, {}
    loss = "aux_loss" if meta["discrete"] else "kl_loss"
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
        for t in (z, dec, log[loss]):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{key}: non-finite output")
        outs[key] = (z, dec)
        if "indices" in log:
            indices[key] = log["indices"]
    res = {}
    for i, what in enumerate(("z", "recon")):
        for key in kernels:
            res[f"{what}_{key}_vs_plain"] = rel_l2(outs[key][i], outs["plain"][i])
            res[f"{what}_{key}_vs_f32"] = rel_l2(outs[key][i], outs["plain_f32"][i])
        res[f"{what}_plain_vs_f32"] = rel_l2(outs["plain"][i], outs["plain_f32"][i])
    for key in indices:
        if key != "plain_f32":
            res[f"indices_{key}_vs_f32"] = float(
                (indices[key] != indices["plain_f32"]).float().mean())
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


def serve_both_paths(name: str, cfg: dict, path: str, device, shape=REQUEST,
                     n_params_want: int = None) -> dict:
    """Phases 3, 6, 9 and 20: N_REQUESTS requests of ``shape`` on the kernel
    path, then on the plain path, a profile of one kernel-path request and
    the end-to-end gate (v1.0 and phase 20's flagship widths: also at
    PARTIAL_REQUEST); ``n_params_want``: the parameters the model must have.
    Returns the kernel path's ``serve`` result."""
    tok = make_tokenizer(cfg, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    if n_params_want is not None and n_params != n_params_want:
        raise AssertionError(f"{name}: {n_params} parameters, not {n_params_want}")
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
    if path == "v1_0" or path in WIDTHS:
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
    """Phase 5 (and 10-11): ``n_requests`` requests through an FSQ kernel
    path (the v1.0 FSQ 4096 model's at REQUEST, or a CONFIG_PATHS path's,
    or ``tok``'s at the shape of ``path``; the first pays cuDNN's algorithm
    search, so the latency to compare is the best after it); on the last, integer indices in [0, codebook size)
    of the latent's shape, ``indices_to_latent`` equal to the quantized z,
    decoding from indices equal to the reconstruction (relative L2 <=
    FSQ_DECODE_GATE), a finite ``aux_loss``. Returns the ``serve``
    result."""
    import torch

    cfg, shape, _ = CONFIG_PATHS.get(path, (FSQ_CFG, REQUEST, False))
    tok = tok or make_tokenizer(cfg, device)
    reg = tok.core.regularization
    codes = reg.fsq.codebook_size
    r = serve(tok, n_requests, shape, PER_FORWARD[path])
    report(name, r, shape)
    x, z, dec, log = r["last"]
    idx = log["indices"]
    want = (shape[0],) + tuple(z.shape[2:]) + ((reg.num_codebooks,)
                                               if reg.num_codebooks > 1 else ())
    if (idx.dtype not in (torch.int32, torch.int64) or tuple(idx.shape) != want
            or int(idx.min()) < 0 or int(idx.max()) >= codes):
        raise AssertionError(f"fsq indices {idx.dtype} {tuple(idx.shape)} "
                             f"[{int(idx.min())}, {int(idx.max())}]")
    # the f32 latent, rounded as the forward rounds it (codes are exact in
    # bf16; project_out's f32 output is not)
    latent = tok.indices_to_latent(idx).to(tok.compute_dtype).float()
    # v1.1 decodes tdf * T' frames, of which the forward keeps the last T
    dec_idx = tok.decode(idx, decode_from_indices=True)[:, :, -dec.shape[2]:]
    torch.cuda.synchronize()
    rel = rel_l2(dec_idx, dec)
    print(f"fsq: indices {tuple(idx.shape)} in [{int(idx.min())}, "
          f"{int(idx.max())}], {int(idx.unique().numel())} distinct codes; "
          f"indices_to_latent == z: {torch.equal(latent, z)}; decode from "
          f"indices vs forward rel_l2 {rel:.4g} (bit-equal: "
          f"{torch.equal(dec_idx, dec)}); aux_loss {float(log['aux_loss']):.6g}",
          flush=True)
    if not torch.equal(latent, z):
        raise AssertionError("fsq: indices_to_latent(indices) != quantized z")
    if not rel <= FSQ_DECODE_GATE:
        raise AssertionError(f"fsq: decode from indices rel_l2 {rel}")
    if not torch.isfinite(log["aux_loss"]):
        raise AssertionError("fsq: non-finite aux_loss")
    return r


def check_fsq_262144(device, label: str, name: str, path: str, tok=None) -> None:
    """Phases 10 and 10c: one request through an FSQ 262144 model's kernel
    path (the v1.1 41616 model's, five levels and a 16² latent; or the
    non-causal model's), checked as in ``check_fsq``; its peak memory
    beside the f32 ``[positions, 262144]`` matrix of the entropy loss,
    which it computes on every call as JAX does."""
    r = check_fsq(device, name, path, n_requests=1, tok=tok)
    positions, codes = int(np.prod(r["last"][1].shape[2:])), 8 ** 6
    print(f"{label}: {positions} latent positions, entropy-loss matrix "
          f"[{positions}, {codes}] f32 = {positions * codes * 4} bytes; "
          f"peak_mem_bytes {r['peak_mem_bytes']}", flush=True)


def serve_fsq_options(device) -> None:
    """Phase 10b: FSQ_OPTIONS_CFG, the FSQ 4096 flagship with projections,
    two codebooks, ``diversity_gamma`` and ``inv_temperature``: N_REQUESTS
    requests checked as in ``check_fsq`` (indices ``[1, 5, 32, 32, 2]``,
    decoding from them equal to the forward's), then ``e2e_check``: the
    kernel path within BF16_SLACK x the plain bf16 distance from the f32
    plain run on z and the reconstruction, and with at most BF16_SLACK x
    the plain bf16 path's share of indices unlike the f32 run's (bf16's
    spread moves 5-6% of them on either path: no fixed share holds)."""
    tok = make_tokenizer(FSQ_OPTIONS_CFG, device)
    reg = tok.core.regularization
    if not (reg.has_projections and reg.num_codebooks == 2
            and reg.inv_temperature == FSQ_OPTIONS["inv_temperature"]
            and reg.diversity_gamma == FSQ_OPTIONS["diversity_gamma"]):
        raise AssertionError(f"fsq options not built: {reg}")
    check_fsq(device, "fsq options, kernel path: v1.0 fsq 4x8x8, project_in 4 -> 2 "
              "codebooks of 4096, diversity_gamma 0.5, inv_temperature 10", tok=tok)
    res = e2e_check(tok.core, tok.meta, REQUEST, "v1_0")
    flips, plain = res["indices_kernel_vs_f32"], res["indices_plain_vs_f32"]
    if not flips <= BF16_SLACK * plain:
        raise AssertionError(f"fsq options: {flips} of the kernel path's indices differ "
                             f"from the f32 plain run's, > {BF16_SLACK} x the plain "
                             f"bf16 path's {plain}")


class _Unquantized:
    """A stand-in regularizer that returns the encoder's output as it is,
    so the tiled engine's encode gives the latent before quantization."""

    def __call__(self, z, sample=None, generator=None, n_steps=0, global_batch=False):
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
# Phase 18: the flagship's own file, its decoder target replaced by a name
# that is no variant's
FLAGSHIP_YAML = "configs/vidtok_kl_causal_488_16chn.yaml"
DECODER_TARGET = {"model": {"params": {"decoder_config": {"target": "Decoder"}}}}
FLAGSHIP_PARAMS = 157_949_351


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


def serve_public_surface(device) -> None:
    """Phase 18 (see the module's docstring)."""
    import os

    import torch

    from vidtok_tpu_torch import load_model_from_config, merge_configs
    from vidtok_tpu_torch.modules.regularizers import DiagonalGaussian

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), FLAGSHIP_YAML)
    toks = {name: load_model_from_config(cfg, seed=0, device=device,
                                         compute_dtype=torch.bfloat16)
            for name, cfg in (("merged", merge_configs(path, DECODER_TARGET)),
                              ("file", path))}
    tok, ref = toks["merged"], toks["file"]
    n_params = sum(p.numel() for p in tok.core.parameters())
    variants = (tok.core.encoder.variant, tok.core.decoder.variant)
    if not tok.fused or variants != ("causal", "causal") or n_params != FLAGSHIP_PARAMS:
        raise AssertionError(f"merged flagship: fused {tok.fused}, variants {variants}, "
                             f"{n_params} params")

    def same_weights():
        a, b = tok.core.state_dict(), ref.core.state_dict()
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    built_equal = same_weights()
    for t in toks.values():
        randomize_(t.core, seed=0)
    if not (built_equal and same_weights()):
        raise AssertionError(f"state dicts unlike: as built {built_equal}, randomized "
                             f"{same_weights()}")
    reqs = [np.clip(np.random.RandomState(1 + i).randn(*REQUEST) * 0.5, -1, 1)
            .astype(np.float32) for i in range(N_REQUESTS)]
    for i, x in enumerate(reqs):
        z, dec, _ = tok(x)
        z2, dec2, _ = ref(x)
        if not (torch.equal(z, z2) and torch.equal(dec, dec2)):
            raise AssertionError(f"request {i}: the merged flagship's z or "
                                 "reconstruction unlike the file's")
    r = serve(tok, N_REQUESTS, REQUEST, PER_FORWARD["v1_0"])
    report(f"kernel path: v1.0 kl flagship merged with decoder target Decoder, "
           f"{n_params} params", r, REQUEST)
    busy = profile_request(tok, REQUEST)
    print("public surface: request latency_s "
          + " ".join(f"{v:.4f}" for v in r["latency_s"])
          + f"; busy share {'not measured' if busy is None else f'{busy:.3f}'};"
          f" peak_mem_bytes {r['peak_mem_bytes']}; state dicts equal; z and "
          f"reconstruction bit-equal to the file's flagship on {N_REQUESTS} requests",
          flush=True)
    e2e_check(tok.core, tok.meta, REQUEST, "v1_0")
    x = tok._input(reqs[0])
    with torch.no_grad():
        zp = tok.core.encode_raw(x, fused=True)
        z_a, log_a = tok.core.regularize(zp, sample=False)
        z_b, log_b = tok.core.encode(x, sample=False, fused=True)
        post = DiagonalGaussian(zp)
        nll, var = post.nll(post.mode()), post.var
    torch.cuda.synchronize()
    split_equal = torch.equal(z_a, z_b) and torch.equal(log_a["kl_loss"], log_b["kl_loss"])
    finite = bool(torch.isfinite(nll).all() and torch.isfinite(var).all())
    print(f"public surface: regularize(encode_raw(x)) bit-equal to encode(x) "
          f"{split_equal}; moments {list(zp.shape)} {zp.dtype}; nll(mode) "
          f"{[round(float(v), 1) for v in nll]}; var in [{float(var.min()):.4g}, "
          f"{float(var.max()):.4g}]", flush=True)
    if not (split_equal and finite and nll.shape == (REQUEST[0],)):
        raise AssertionError("encode_raw / regularize unlike encode, or a non-finite "
                             "nll or var")


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


# Training (phase 15, ``vidtok_tpu_torch/train``): the recipe of the
# flagship, FSQ 4096 and v1.1 configs (their ``loss_config`` and
# ``training`` sections, the same in all three), with ``disc_start`` 0 so
# that the discriminator, the adaptive weight and LeCAM run from the first
# step, and an EMA of the weights (LitEma's default decay; no config sets
# one) so that validation has EMA weights to score.
TRAIN_LOSS = {"target": "GeneralLPIPSWithDiscriminator", "params": {
    "dims": 3, "perceptual_weight": 1.0, "disc_start": 0, "disc_weight": 0.2,
    "disc_type": "2d", "learn_logvar": True, "gen_loss_cross_entropy": True,
    "lecam_loss_weight": 0.005,
    "regularization_weights": {"aux_loss": 1.0, "kl_loss": 1.0e-06}}}
TRAIN_BATCH = (2, 17, 256, 256, 3)      # batch_size 2, sample_num_frames 17
TRAIN_BATCH_V1_1 = (2, 33, 256, 256, 3)  # the v1.1 recipe's 33 frames
TRAIN_STEPS = 4                          # timed, after one warm-up step
# the bf16-mixed first step's losses against fp32's: at most TRAIN_SLACK x
# the forward's own bf16 spread (the reconstruction's relative L2 between
# the two runs), relative to each loss, floored at TRAIN_FLOOR of it
TRAIN_SLACK = 1.0
TRAIN_FLOOR = 1e-3
TRAIN_LOGS = ("train/aeloss", "train/nll_loss", "train/rec_loss", "train/p_loss",
              "train/kl_loss", "train/d_weight", "train/discloss")
# the discriminator's last conv at TRAIN_DISC_GAIN x its ``weights_init``
# draw. At the recipe's N(0, 0.02) the adaptive weight's norm ratio on these
# random weights lies past its 1e4 clip at the flagship's batch, so
# ``d_weight`` would show only the clip (2000 = 1e4 x disc_weight). BatchNorm
# takes out the scale of every conv but the last, so the generator loss's
# gradient grows with this gain and the ratio falls; at 300x it lies inside
# the clip (about 2.4e3 on an H100), and the gates read both gradients
TRAIN_DISC_GAIN = 300.0


def train_cfg(model: dict, precision: str = "bf16-mixed") -> dict:
    """A resolved model section with the recipe's loss and training
    sections."""
    import copy

    cfg = copy.deepcopy(model)
    p = cfg["model"]["params"]
    p["loss_config"] = copy.deepcopy(TRAIN_LOSS)
    p["ema_decay"] = 0.9999
    cfg["model"]["base_learning_rate"] = 1.0e-05
    cfg["training"] = {"precision": precision, "use_checkpoint": True, "grad_clip": 20.0}
    return cfg


def train_clip(shape, seed: int = 7):
    """A batch of smooth moving frames plus noise in [-1, 1], channels-last."""
    b, t, h, w, _ = shape
    clips = [cli_clip(seed + i, t, (h, w)) for i in range(b)]
    return np.stack(clips).astype(np.float32) / 127.5 - 1.0


def make_trainer(cfg: dict, device, lpips: str, seed: int = 0):
    """A trainer with ``randomize_`` weights in the core (every parameter
    exercised), the discriminator's last conv times TRAIN_DISC_GAIN, and
    its EMA copies equal to them."""
    import torch

    from vidtok_tpu_torch.train.trainer import VidTokTrainer

    tr = VidTokTrainer(cfg, device=device, lpips_weights=lpips, seed=seed).init_state()
    randomize_(tr.core, seed)
    with torch.no_grad():
        tr.disc.main[-1].weight.mul_(TRAIN_DISC_GAIN)
    if tr.ema is not None:
        tr.ema["core"].load_state_dict(tr.core.state_dict())
        tr.ema["disc"].load_state_dict(tr.disc.state_dict())
    return tr


def recorded_ratios(fn):
    """(``fn()``, the adaptive weight's norm ratios before their clip, one a
    generator loss ``fn`` ran): ``train.losses.adaptive_ratio`` wrapped
    while ``fn`` runs."""
    from vidtok_tpu_torch.train import losses

    ratios, ratio = [], losses.adaptive_ratio

    def recorded(*args):
        r = ratio(*args)
        ratios.append(float(r))
        return r

    losses.adaptive_ratio = recorded
    try:
        return fn(), ratios
    finally:
        losses.adaptive_ratio = ratio


def _finite_logs(logs: dict, what: str) -> dict:
    logs = {k: float(v) for k, v in logs.items()}
    bad = [k for k, v in logs.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite logs {bad}")
    return logs


def _flat(module) -> "torch.Tensor":
    import torch

    return torch.cat([p.detach().float().reshape(-1) for p in module.parameters()])


def train_flagship(device, lpips: str):
    """Phase 15a: the flagship's bf16-mixed step at its recipe (batch 2 of
    17 x 256², remat on): the first step against the same step in fp32
    (TF32 off) on the same weights and batch, then 1 warm-up + TRAIN_STEPS
    timed steps (host clock ending in a synchronize), the peak memory, and a
    profile of one step. Gates: finite logs, the generator, discriminator
    and logvar moved, ``d_weight`` > 0, and each first-step loss of
    TRAIN_LOGS within the bf16 bound, and so the adaptive weight's norm
    ratio before its clip, which must also lie inside the clip. Returns (trainer, batch, the kernel
    path's reconstruction on the weights before training)."""
    import torch

    from vidtok_tpu_torch.ops import kernels as K

    x = torch.from_numpy(train_clip(TRAIN_BATCH)).to(device)
    # fp32 first step (TF32 off, as main sets it), then the bf16 trainer on
    # the same weights and batch
    f32 = make_trainer(train_cfg(V1_0_CFG, "fp32"), device, lpips)
    with torch.no_grad():
        xrec32 = f32.core.forward_train(
            x, generator=torch.Generator(device).manual_seed(1))[1].float()
    t0 = time.perf_counter()
    logs32, (ratio32,) = recorded_ratios(lambda: _finite_logs(f32.fit_step(x), "fp32 step"))
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    del f32
    torch.cuda.empty_cache()
    tr = make_trainer(train_cfg(V1_0_CFG), device, lpips)
    with torch.no_grad():
        xrec16 = tr.core.forward_train(x.bfloat16(),
                                       generator=torch.Generator(device).manual_seed(1))[1]
    spread = rel_l2(xrec16.float(), xrec32)
    # the kernel path once before training: the operand cache holds the
    # weights as they were
    tok = tr.tokenizer()
    K.reset_counts()
    before = tok(x[:1].permute(0, 4, 1, 2, 3))[1]
    if K.counts() != PER_FORWARD["v1_0"]:
        raise AssertionError(f"train validation launches {K.counts()}")
    tr.core.train()
    g0, d0, lv0 = _flat(tr.core), _flat(tr.disc), float(tr.logvar.detach())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs16, (ratio16,) = recorded_ratios(lambda: _finite_logs(tr.fit_step(x), "bf16 step"))
    torch.cuda.synchronize()
    t16 = time.perf_counter() - t0
    print(f"train flagship: first step fp32 {t32:.3f} s, bf16-mixed {t16:.3f} s (first "
          f"calls); bf16 spread of the reconstruction {spread:.5f}", flush=True)
    # the adaptive weight's norm ratio before its clip: finite, inside the
    # clip (so d_weight is not the clip), and held to fp32 as the losses are
    for what, r in (("fp32", ratio32), ("bf16", ratio16)):
        if not 0 < r < 1e4:
            raise AssertionError(f"train: {what} adaptive weight ratio {r} outside (0, 1e4)")
    logs16["adaptive_ratio"], logs32["adaptive_ratio"] = ratio16, ratio32
    for k in ("adaptive_ratio",) + TRAIN_LOGS:
        a, b = logs16[k], logs32[k]
        bound = max(TRAIN_SLACK * spread, TRAIN_FLOOR) * abs(b)
        print(f"train flagship: {k} bf16 {a:.6g} fp32 {b:.6g} |diff| {abs(a - b):.4g} "
              f"bound {bound:.4g}", flush=True)
        if not abs(a - b) <= bound:
            raise AssertionError(f"train {k}: bf16 {a} vs fp32 {b} beyond {bound}")
    lat = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        logs = _finite_logs(tr.fit_step(x), "bf16 step")
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    moved = {"generator": float((_flat(tr.core) - g0).abs().max()),
             "discriminator": float((_flat(tr.disc) - d0).abs().max()),
             "logvar": abs(float(tr.logvar.detach()) - lv0)}
    print(f"train flagship: batch {list(TRAIN_BATCH)} bf16-mixed remat; s/step "
          + " ".join(f"{v:.4f}" for v in lat)
          + f" (mean {np.mean(lat):.4f}); peak_mem_bytes {peak}; "
          f"moved (max |change|) {json.dumps(moved)}; step {tr.step}; logs "
          + json.dumps({k: round(v, 6) for k, v in logs.items()}), flush=True)
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train: parameters did not move: {moved}")
    if not logs["train/d_weight"] > 0:
        raise AssertionError(f"train: d_weight {logs['train/d_weight']}")
    profile_call(lambda: tr.fit_step(x), "profile train step")
    return tr, x, before


def train_validation(tr, x, before) -> None:
    """Phase 15b: validation on the trained weights and on their EMA through
    the serving engine, kernels A-E, which read weights the optimizer
    changed in place: each held by ``e2e_check`` (launches 20/20/3/1/2 a
    forward; no further from the f32 plain run than the plain bf16 path,
    x BF16_SLACK, on z and on the reconstruction), the kernel path
    bit-equal after the operand cache is dropped, and the CLI's
    ``evaluate`` (PSNR, SSIM, val/rec_loss) on the batch."""
    import torch

    from vidtok_tpu_torch.ops.kernels import _lib
    from vidtok_tpu_torch.scripts.train import evaluate

    class Batches:
        def epoch(self, _):
            return iter([{"jpg": x[:1]}, {"jpg": x[1:]}])

    for ema in (False, True):
        core = tr.ema["core"] if ema else tr.core
        what = "ema" if ema else "trained"
        e2e_check(core, tr.meta, REQUEST, "v1_0")
        tok = tr.tokenizer(ema)
        xin = x[:1].permute(0, 4, 1, 2, 3)
        cached = tok(xin)[1]
        _lib.clear_operands()
        fresh = tok(xin)[1]
        if not torch.equal(cached, fresh):
            raise AssertionError(f"validation {what}: the cached operands are stale "
                                 f"(rel_l2 {rel_l2(cached, fresh)} after a rebuild)")
        psnr, ssim, rec = evaluate(tr, tok, Batches(), 8)
        print(f"train validation {what}: kernel path bit-equal after the operand "
              f"cache is rebuilt; training moved its reconstruction by rel_l2 "
              f"{rel_l2(cached, before):.5f}; PSNR {psnr:.4f} SSIM {ssim:.5f} "
              f"val/rec_loss {rec:.5f}", flush=True)
        if not all(np.isfinite(v) for v in (psnr, ssim, rec)):
            raise AssertionError(f"validation {what}: non-finite metrics")
    tr.core.train()


def train_resume(tr, x, tmp: str, lpips: str) -> None:
    """Phase 15c: the train state saved after step k and restored into a
    fresh trainer; step k+1 there bit-equal to step k+1 of the run that
    continued (deterministic cuDNN and cuBLAS, ``torch.
    use_deterministic_algorithms``, the attention's SDPA on its math
    backend, whose backward is deterministic where the memory-efficient
    one is not; the same RNG states)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vidtok_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

    t0 = time.perf_counter()
    path = save_train_state(tmp, tr, tr.step)
    torch.cuda.synchronize()
    t_save = time.perf_counter() - t0
    import os
    import warnings

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, sdpa_kernel(SDPBackend.MATH):
            warnings.simplefilter("always")
            logs_a = tr.fit_step(x)
            other = make_trainer(train_cfg(V1_0_CFG), x.device, lpips, seed=1)
            t0 = time.perf_counter()
            step = restore_train_state(path, other)
            t_load = time.perf_counter() - t0
            logs_b = other.fit_step(x)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    nondet = sorted({str(w.message)[:160] for w in caught if "deterministic" in str(w.message)})
    for m in nondet:
        print(f"train resume: no deterministic form: {m}", flush=True)

    diffs = [k for k in logs_a if not torch.equal(logs_a[k], logs_b[k])]
    for name in ("core", "disc"):
        a, b = getattr(tr, name).state_dict(), getattr(other, name).state_dict()
        diffs += [f"{name}.{k}" for k in a if not torch.equal(a[k], b[k])]
    print(f"train resume: {os.path.getsize(path)} bytes saved in {t_save:.3f} s, restored "
          f"(step {step}) in {t_load:.3f} s; step {tr.step} after the restore "
          f"{'bit-equal' if not diffs else 'DIFFERS'} to the continued run "
          f"(logs, core, discriminator)", flush=True)
    if diffs:
        raise AssertionError(f"train resume: not bit-equal: {diffs[:8]}")
    del other
    torch.cuda.empty_cache()


def train_fsq(device, lpips: str) -> None:
    """Phase 15d: one step of the v1.0 FSQ 4096 model at the recipe
    (batch 2 of 17 x 256²). Gates: the reconstruction loss alone gives the
    encoder a non-zero gradient (through FSQ's straight-through rounding),
    the indices lie in [0, 4096), the step's logs (aux_loss among them)
    are finite."""
    import torch

    x = torch.from_numpy(train_clip(TRAIN_BATCH, seed=11)).to(device)
    tr = make_trainer(train_cfg(FSQ_CFG), device, lpips)
    _, xrec, _, log = tr.core.forward_train(x.bfloat16())
    enc = list(tr.core.encoder.parameters())
    grads = torch.autograd.grad((xrec.float() - x).abs().mean(), enc)
    gnorm = float(torch.sqrt(sum(g.float().square().sum() for g in grads)))
    idx = log["indices"]
    lo, hi = int(idx.min()), int(idx.max())
    del xrec, log, grads
    logs = _finite_logs(tr.fit_step(x), "fsq step")
    print(f"train fsq 4096: the reconstruction loss's encoder gradient norm {gnorm:.6g}; "
          f"indices in [{lo}, {hi}]; aux_loss {logs['train/aux_loss']:.6g}, aeloss "
          f"{logs['train/aeloss']:.6g}, d_weight {logs['train/d_weight']:.6g}", flush=True)
    if not gnorm > 0:
        raise AssertionError("train fsq: no gradient reaches the encoder")
    if not (0 <= lo and hi < 4096):
        raise AssertionError(f"train fsq: indices in [{lo}, {hi}]")


def train_v1_1(device, lpips: str) -> None:
    """Phase 15e: one v1.1 step at its recipe shape, batch 2 of 33 x 256²,
    and its peak memory."""
    import torch

    x = torch.from_numpy(train_clip(TRAIN_BATCH_V1_1, seed=13)).to(device)
    tr = make_trainer(train_cfg(V1_1_CFG), device, lpips)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs = _finite_logs(tr.fit_step(x), "v1.1 step")
    torch.cuda.synchronize()
    print(f"train v1.1: batch {list(TRAIN_BATCH_V1_1)} bf16-mixed remat; first step "
          f"{time.perf_counter() - t0:.3f} s; peak_mem_bytes "
          f"{torch.cuda.max_memory_allocated()} of {torch.cuda.get_device_properties(0).total_memory}; "
          f"aeloss {logs['train/aeloss']:.6g}", flush=True)


def train_cli(device, tmp: str, lpips: str) -> None:
    """Phase 15f: ``python -m vidtok_tpu_torch.scripts.train`` in a
    subprocess on two written clips of CLI_FRAMES frames of CLI_SIZE and
    their ``meta.csv``: a two-level model (``ch`` 128, one resblock a
    level) at the recipe's video size (17 x 256², batch 2) for 3 steps with a checkpoint and a
    validation, then ``--resume`` to step 5 (gates: exit 0, the JSONL holds
    steps 1-5, the resumed run starts at step 3); then the flagship's
    config for 2 steps (``--max_steps 2``)."""
    import importlib.util
    import os

    missing = [m for m in ("cv2", "yaml") if importlib.util.find_spec(m) is None]
    if missing:
        raise AssertionError(f"train cli: this machine lacks {missing}")
    import yaml

    from vidtok_tpu_torch.data import write_video

    data = os.path.join(tmp, "train_videos")
    os.makedirs(data, exist_ok=True)
    for c in range(2):
        write_video(os.path.join(data, f"clip{c}.mp4"), cli_clip(20 + c, CLI_FRAMES),
                    fps=CLI_FPS)
    meta = os.path.join(data, "meta.csv")
    with open(meta, "w") as f:
        f.write("videos\nclip0.mp4\nclip1.mp4\n")
    vp = {"input_height": CLI_CROP, "input_width": CLI_CROP, "sample_num_frames": 17,
          "sample_fps": 8}
    # two levels, one resblock each, at the flagship's level-0 width: the
    # validation's kernels take the released configs' widths (D takes
    # 64 or 128 channels), not the CPU tests' 32
    tiny = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 128,
            "ch_mult": [1, 2], "time_downsample_factor": 2, "num_res_blocks": 1,
            "norm_type": "layernorm", "tempo_ds": [0], "tempo_us": [1]}
    cfg = train_cfg(_model("AutoencodingEngine", "EncoderCausal3D", "DecoderCausal3D",
                           tiny, _KL, monitor="val/rec_loss"))
    cfg["data"] = {"target": "DataModuleFromConfig", "params": {
        "batch_size": 2, "num_workers": 2,
        "train": {"target": "VidTokDataset", "params": {
            "data_dir": data, "meta_path": meta, "video_params": vp}},
        "validation": {"target": "VidTokValDataset", "params": {
            "data_dir": data, "meta_path": meta, "video_params": vp}}}}
    cfg["training"].update(max_steps=3, val_check_interval=3, checkpoint_every=3,
                           log_images_every=3, log_every=1)
    cfg_path = os.path.join(tmp, "tiny_train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    logdir = os.path.join(tmp, "train_logs")

    def run(what, *args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "vidtok_tpu_torch.scripts.train",
                            "-l", logdir, "--device", str(device),
                            "--lpips_weights", lpips, *args],
                           capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        print(f"train cli {what}: rc {r.returncode} in {time.perf_counter() - t0:.1f} s: "
              + " | ".join(l for l in lines if l.startswith(("step ", "[val", "[train] run")))
              [-1500:], flush=True)
        if r.returncode:
            raise AssertionError(f"train cli {what} failed: {r.stderr[-3000:]}")
        return r.stdout

    run("tiny, 3 steps", "-b", cfg_path, "-n", "tiny")
    out = run("tiny, --resume to 5", "-b", cfg_path, "-n", "tiny", "--resume",
              "--max_steps", "5")
    if "start step 3" not in out:
        raise AssertionError("train cli: the resumed run did not start at step 3")
    (run_dir,) = [d for d in os.listdir(logdir) if d.endswith("tiny")]
    with open(os.path.join(logdir, run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows if "train/aeloss" in r]
    if steps != [1, 2, 3, 4, 5] or not any("val/psnr" in r for r in rows):
        raise AssertionError(f"train cli: JSONL steps {steps}, validation "
                             f"{[r for r in rows if 'val/psnr' in r]}")
    root = os.path.dirname(os.path.abspath(__file__))
    flagship = os.path.join(root, "configs", "vidtok_kl_causal_488_16chn.yaml")
    over = [f"data.params.{split}.params.{k}={v}" for split in ("train", "validation")
            for k, v in (("data_dir", data), ("meta_path", meta))]
    run("flagship, 2 steps", "-b", flagship, "-n", "flagship", "--max_steps", "2", *over)


def serve_training(device, t: float) -> float:
    """Phase 15: training (15a-15f); its files under CKPT_DIR, removed
    after."""
    import os
    import shutil
    import tempfile

    import torch

    os.makedirs(CKPT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=CKPT_DIR)
    lpips = os.path.join(tmp, "lpips.npz")
    lpips_npz(lpips)
    try:
        tr, x, before = train_flagship(device, lpips)
        t = phase("train flagship", t)
        train_validation(tr, x, before)
        t = phase("train validation", t)
        train_resume(tr, x, tmp, lpips)
        del tr, x, before
        torch.cuda.empty_cache()
        t = phase("train resume", t)
        train_fsq(device, lpips)
        torch.cuda.empty_cache()
        t = phase("train fsq", t)
        train_v1_1(device, lpips)
        torch.cuda.empty_cache()
        t = phase("train v1.1", t)
        train_cli(device, tmp, lpips)
        t = phase("train cli", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return t


# VidTwin (phase 16, ``vidtok_tpu_torch/models/vidtwin``): the model section
# of configs/vidtwin/vidtwin_structure_7_7_8_dynamics_7_8.yaml, resolved, and
# its training precision. Full width, seeded random weights.
_STT = {"in_channels": 3, "input_size": [16, 224, 224], "patch_size": [1, 16, 16],
        "hidden_size": 768, "depth": 16, "num_heads": 12, "temporal_casual": True}
_WARMUP_COSINE = "LambdaWarmUpCosineScheduler"
VIDTWIN_CFG = {"model": {"base_learning_rate": 1.6e-4, "target": "VidTwinVAE", "params": {
    "monitor": "val/rec_loss", "expect_ch": 8, "cont_num_blocks": 1,
    "downsample_motion": True, "motion_num_blocks": 1, "d_dim": 8,
    "temporal_qformer_config": {"target": "QFormerInterface", "params": {
        "num_query_tokens": 16, "query_hidden_size": 64, "encoder_hidden_size": 768}},
    "encoder_config": {"target": "STTEncoder", "params": dict(_STT)},
    "decoder_config": {"target": "STTDecoder", "params": dict(_STT)},
    "regularizer_config": {"target": "DiagonalGaussianRegularizer",
                           "params": {"sample": True}},
    "loss_config": {"target": "GeneralLPIPSWithDiscriminator", "params": {
        "perceptual_weight": 0.05, "disc_start": 20001, "disc_weight": 0.05,
        "learn_logvar": True, "dims": 3, "disc_type": "2d",
        "regularization_weights": {"kl_loss": 0.001}}},
    "lr_scheduler_config_g": {"target": _WARMUP_COSINE, "params": {
        "lr_min": 0, "lr_max": 3.0e-5, "lr_start": 0, "warmup_steps": 5000}},
    "lr_scheduler_config_d": {"target": _WARMUP_COSINE, "params": {
        "lr_min": 0, "lr_max": 1.5e-5, "lr_start": 1.0e-5, "warmup_steps": 5000}},
    "optimizer_config": {"target": "torch.optim.AdamW", "params": {
        "betas": [0, 0.9], "weight_decay": 0.0001}}}},
    "training": {"precision": "bf16-mixed"}}
VIDTWIN_REQUEST = (4, 3, 16, 224, 224)
VIDTWIN_Z = (4, 768, 16, 14, 14)
VIDTWIN_LATENTS = ((4, 16, 7, 7, 8), (4, 8, 16, 7), (4, 8, 16, 7))
# bf16 serving (weights bf16 at rest) against the f32 run (f32 attention,
# TF32 off), relative L2 on z and on the reconstruction. Measured on an
# NVIDIA H100 80GB HBM3 at 700 W: 0.0118 on z, 0.0188 on the
# reconstruction, equal in two runs (the weights and the request are
# seeded). The gate is about twice the larger, so a cast or precision
# fault that doubles the error fails, and a wrong layout, attention
# pattern or cast (O(1)) fails by far; the run prints the spread beside it.
VIDTWIN_BF16_GATE = 4e-2
VIDTWIN_DEPTH_CUT = 2      # the depth of the card-against-CPU check
VIDTWIN_CPU_GATE = 1e-4    # f32 on the card against f32 on the CPU, relative L2
VIDTWIN_CAUSAL_FRAME = 8   # frames from here on are zeroed in the causality check
VIDTWIN_TRAIN_BATCH = (2, 16, 224, 224, 3)
VIDTWIN_TRAIN_STEPS = 6    # bf16-mixed; the first held to the f32 step
VIDTWIN_CLI_SIZE = (240, 320)
VIDTWIN_CLI_FRAMES = 72    # 18 frames at the CLIs' 8 fps from 30 fps


def vidtwin_cfg(depth: int = None, precision: str = None, disc_start: int = None,
                warmup_steps: int = None) -> dict:
    """VIDTWIN_CFG with the given changes."""
    import copy

    cfg = copy.deepcopy(VIDTWIN_CFG)
    p = cfg["model"]["params"]
    if depth is not None:
        for part in ("encoder_config", "decoder_config"):
            p[part]["params"]["depth"] = depth
    if precision is not None:
        cfg["training"]["precision"] = precision
    if disc_start is not None:
        p["loss_config"]["params"]["disc_start"] = disc_start
    if warmup_steps is not None:
        for part in ("lr_scheduler_config_g", "lr_scheduler_config_d"):
            p[part]["params"]["warmup_steps"] = warmup_steps
    return cfg


def fill_zero_init_(model, generator) -> None:
    """Draw what ``vidtok_tpu``'s init leaves at zero, so that every
    parameter matters: the decoder's final linear and every temporal
    attention's output projection (xavier uniform), and every bias
    (N(0, 0.02²))."""
    import torch

    from vidtok_tpu_torch.models.vidtwin import st_transformer as S

    for m in model.modules():
        if isinstance(m, S.Attention) and m.zero_init_proj:
            S.init_(m.proj.weight, "xavier", generator)
        elif isinstance(m, S.T2IFinalLayer):
            S.init_(m.linear.weight, "xavier", generator)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") and not p.any():
                S.init_(p, "normal", generator, 0.02)


def make_vidtwin(cfg: dict, device, dtype, seed: int = 0, f32_attention: bool = False):
    """A VidTwin engine with seeded weights (``vidtok_tpu``'s init, then
    ``fill_zero_init_``), built on the CPU and moved to ``device`` in
    ``dtype``; ``f32_attention`` sets the attention's dtype to f32."""
    import torch

    from vidtok_tpu_torch.models.vidtwin.engine import VidTwinTokenizer
    from vidtok_tpu_torch.models.vidtwin.vidtwin_ae import (build_vidtwin_from_config,
                                                            reset_params_)

    model, meta = build_vidtwin_from_config(cfg["model"])
    g = torch.Generator().manual_seed(seed)
    reset_params_(model, g)
    fill_zero_init_(model, g)
    if f32_attention:
        model.encoder.set_attn_dtype(None)
        model.decoder.set_attn_dtype(None)
    return VidTwinTokenizer(model.to(device, dtype), meta, dtype)


def _check_finite(what: str, *tensors) -> None:
    import torch

    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise AssertionError(f"{what}: non-finite output")


def vidtwin_serve(device):
    """Phase 16a: VIDTWIN_REQUEST requests in bf16 (weights bf16 at rest):
    host-clock latency ending in a synchronize, frames/s, peak memory, no
    launch of the sixteen kernels, a profile of one; one request in f32
    (f32 attention, TF32 off) and the bf16 gate; ``only_part`` and
    ``cross_reenact`` shapes, the cross result unlike both
    self-reconstructions; causality of the encoder in f32. Returns the f32
    engine and the last request."""
    import torch

    from vidtok_tpu_torch.ops import kernels as K

    reqs = [np.clip(np.random.RandomState(300 + i).randn(*VIDTWIN_REQUEST) * 0.5, -1, 1)
            .astype(np.float32) for i in range(N_REQUESTS)]
    tok = make_vidtwin(VIDTWIN_CFG, device, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    lat = []
    for x in reqs:
        t0 = time.perf_counter()
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        _check_finite("vidtwin bf16 request", z, dec, log["kl_loss"])
        if tuple(z.shape) != VIDTWIN_Z or tuple(dec.shape) != VIDTWIN_REQUEST:
            raise AssertionError(f"vidtwin shapes z {tuple(z.shape)} dec {tuple(dec.shape)}")
    peak = torch.cuda.max_memory_allocated()
    if any(K.counts().values()):
        raise AssertionError(f"vidtwin launched kernels {K.counts()}")
    b, _, t = VIDTWIN_REQUEST[:3]
    n = sum(p.numel() for p in tok.model.parameters())
    print(f"serve vidtwin 7x7x8 / 7x8 ({n} parameters); request "
          f"{list(VIDTWIN_REQUEST)} bf16, weights bf16; latency_s "
          + " ".join(f"{v:.4f}" for v in lat)
          + f"; frames_per_s (best after the first) {b * t / min(lat[1:]):.2f}; "
          f"peak_mem_bytes {peak}; launches of the sixteen kernels 0", flush=True)
    profile_call(lambda: tok(x), "profile vidtwin bf16 request")

    tok32 = make_vidtwin(VIDTWIN_CFG, device, torch.float32, f32_attention=True)
    t0 = time.perf_counter()
    z32, dec32, log32 = tok32(x)
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    _check_finite("vidtwin f32 request", z32, dec32)
    spread = {"z": rel_l2(z, z32), "reconstruction": rel_l2(dec, dec32),
              "kl_loss": abs(float(log["kl_loss"]) / float(log32["kl_loss"]) - 1)}
    print(f"serve vidtwin f32 (attention f32, TF32 off): first request {t32:.4f} s; "
          f"bf16 against it (relative): {json.dumps(spread)}; gate "
          f"{VIDTWIN_BF16_GATE}", flush=True)
    if not max(spread["z"], spread["reconstruction"]) <= VIDTWIN_BF16_GATE:
        raise AssertionError(f"vidtwin bf16 against f32: {spread}")

    u_s, u_dx, u_dy, _ = tok.encode(x)
    if (tuple(u_s.shape), tuple(u_dx.shape), tuple(u_dy.shape)) != VIDTWIN_LATENTS:
        raise AssertionError(f"vidtwin latents {u_s.shape} {u_dx.shape} {u_dy.shape}")
    for part in ("content", "motion"):
        out = tok.decode(u_s, u_dx, u_dy, only_part=part)
        _check_finite(f"vidtwin only_part {part}", out)
        if tuple(out.shape) != VIDTWIN_REQUEST:
            raise AssertionError(f"vidtwin only_part {part}: {tuple(out.shape)}")
    xa, xb = x[:2], x[2:]
    cross = tok.cross_reenact(xa, xb)
    self_a, self_b = tok(xa)[1], tok(xb)[1]
    apart = (rel_l2(cross, self_a), rel_l2(cross, self_b))
    print(f"serve vidtwin: only_part content and motion {list(VIDTWIN_REQUEST)}; "
          f"cross_reenact {list(cross.shape)}, relative L2 from the self-reconstructions "
          f"{apart[0]:.4f} (structure's clip) {apart[1]:.4f} (dynamics' clip)", flush=True)
    _check_finite("vidtwin cross_reenact", cross)
    if tuple(cross.shape) != (2,) + VIDTWIN_REQUEST[1:] or not min(apart) > 1e-3:
        raise AssertionError(f"vidtwin cross_reenact: shape {tuple(cross.shape)}, {apart}")

    x1 = torch.from_numpy(x[:1]).to(device)
    x2 = x1.clone()
    x2[:, :, VIDTWIN_CAUSAL_FRAME:] = 0.0
    with torch.no_grad():
        z1, z2 = tok32.model.encoder(x1), tok32.model.encoder(x2)
    k = VIDTWIN_CAUSAL_FRAME
    before = float((z1[:, :, :k] - z2[:, :, :k]).abs().max())
    after = float((z1[:, :, k:] - z2[:, :, k:]).abs().max())
    print(f"serve vidtwin causality (f32): frames {k}.. zeroed; tokens of frames "
          f"0..{k - 1} max |change| {before:.3g}, of later frames {after:.3g}", flush=True)
    if not (before <= 1e-5 * float(z1.abs().max()) and after > 1e-3):
        raise AssertionError(f"vidtwin causality: before {before}, after {after}")
    return tok32, x


def vidtwin_cpu_check(device, x) -> None:
    """Phase 16a: the full-width model cut to VIDTWIN_DEPTH_CUT blocks, f32
    (attention too), on the card against the CPU, one clip."""
    import torch

    cfg = vidtwin_cfg(depth=VIDTWIN_DEPTH_CUT)
    cpu = make_vidtwin(cfg, "cpu", torch.float32, seed=5, f32_attention=True)
    card = make_vidtwin(cfg, device, torch.float32, seed=5, f32_attention=True)
    t0 = time.perf_counter()
    zc, dc, _ = cpu(x[:1])
    t_cpu = time.perf_counter() - t0
    zg, dg, _ = card(x[:1])
    rel = {"z": rel_l2(zg.cpu(), zc), "reconstruction": rel_l2(dg.cpu(), dc)}
    print(f"serve vidtwin depth {VIDTWIN_DEPTH_CUT} f32, card against CPU ({t_cpu:.1f} s "
          f"there): relative L2 {json.dumps(rel)}; gate {VIDTWIN_CPU_GATE}", flush=True)
    if not max(rel.values()) <= VIDTWIN_CPU_GATE:
        raise AssertionError(f"vidtwin card against CPU: {rel}")


def vidtwin_checkpoint(device, tok32, x, tmp: str) -> str:
    """Phase 16b: the f32 engine's weights as a reference-named ``.ckpt``
    with the keys JAX's converter drops (loss, EMA, sincos buffers, the
    encoder's final layer, the decoder's patch embedding, the Q-Former's
    text FFN), loaded through ``load_model_from_config(cfg, ckpt=...)``
    (strict): weights equal, one clip's z and reconstruction bit-equal.
    Returns the file's path (the CLIs read it)."""
    import os

    import torch

    from vidtok_tpu_torch import load_model_from_config

    hidden = _STT["hidden_size"]
    extra = {"loss.logvar": torch.zeros(()), "model_ema.decay": torch.tensor(0.9999),
             "encoder.pos_embed": torch.zeros(1, 196, hidden),
             "decoder.pos_embed_temporal": torch.zeros(1, 16, hidden),
             "encoder.final_layer.linear.weight": torch.zeros(hidden, hidden),
             "decoder.x_embedder.proj.weight": torch.zeros(hidden, 3, 1, 16, 16),
             "temporal_qformer.qformer.encoder.layer.0.intermediate.dense.weight":
                 torch.zeros(hidden, 64)}
    path = os.path.join(tmp, "vidtwin.ckpt")
    sd = {k: v.detach().cpu() for k, v in tok32.model.state_dict().items()}
    t0 = time.perf_counter()
    torch.save({"state_dict": {**sd, **extra}}, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_model_from_config(VIDTWIN_CFG, ckpt=path, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    back.model.encoder.set_attn_dtype(None)
    back.model.decoder.set_attn_dtype(None)
    same_w = all(torch.equal(a, b) for a, b in zip(tok32.model.state_dict().values(),
                                                   back.model.state_dict().values()))
    (za, da, _), (zb, db, _) = tok32(x[:1]), back(x[:1])
    same = torch.equal(za, zb) and torch.equal(da, db)
    print(f"checkpoint vidtwin: {os.path.getsize(path)} bytes with "
          f"{len(extra)} reference keys the loader drops; save {save_s:.3f} s, "
          f"load_model_from_config with ckpt {load_s:.3f} s; weights equal {same_w}; "
          f"z and reconstruction bit-equal {same}", flush=True)
    if not (same_w and same):
        raise AssertionError("vidtwin checkpoint round trip changed the model")
    return path


def vidtwin_clis(device, ckpt: str, tmp: str) -> None:
    """Phase 16c: ``vidtwin_evaluate`` and ``vidtwin_reconstruct`` (a
    reconstruction and a cross-reenactment) as subprocesses, side by side,
    on two written mp4s of VIDTWIN_CLI_FRAMES frames of VIDTWIN_CLI_SIZE at
    30 fps, with the ``.ckpt`` of 16b, when OpenCV and PyYAML import (as in
    phase 14f); gates: exit 0, finite mean PSNR and SSIM, both mp4s
    written."""
    import importlib.util
    import os

    missing = [m for m in ("cv2", "yaml") if importlib.util.find_spec(m) is None]
    if missing:
        print(f"cli vidtwin: the CLIs did not run on this machine: it lacks "
              f"{' and '.join(missing)}", flush=True)
        return
    import yaml

    from vidtok_tpu_torch.data import write_video

    videos = os.path.join(tmp, "vidtwin_videos")
    os.makedirs(videos, exist_ok=True)
    clips = [os.path.join(videos, f"clip{i}.mp4") for i in range(2)]
    for i, path in enumerate(clips):
        write_video(path, cli_clip(40 + i, VIDTWIN_CLI_FRAMES, VIDTWIN_CLI_SIZE), fps=CLI_FPS)
    cfg = os.path.join(tmp, "vidtwin.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(VIDTWIN_CFG, f)
    common = ["--config", cfg, "--ckpt", ckpt, "--device", str(device)]
    out = os.path.join(tmp, "vidtwin_out")
    runs = {"vidtwin_evaluate": ["--data_dir", videos],
            "vidtwin_reconstruct": ["--input_video_path", clips[0], "--output_video_dir", out],
            "vidtwin_reconstruct cross": ["--input_video_path", clips[0],
                                          "--dynamics_video_path", clips[1],
                                          "--output_video_dir", out]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"vidtok_tpu_torch.scripts.{name.split()[0]}"] + common + args,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in runs.items()}
    results = {name: p.communicate(timeout=600) + (p.returncode,) for name, p in procs.items()}
    wall = time.perf_counter() - t0
    for name, (stdout, stderr, rc) in results.items():
        print(f"cli subprocess {name}: rc {rc} (three side by side, {wall:.1f} s): "
              + " | ".join(stdout.strip().splitlines()[-3:]), flush=True)
        if rc:
            raise AssertionError(f"cli {name} failed: {stderr[-2000:]}")
    means = {line.split()[1].rstrip(":"): float(line.split()[-1])
             for line in results["vidtwin_evaluate"][0].splitlines()
             if line.startswith("mean ")}
    written = [os.path.exists(os.path.join(out, f"clip0_{tag}.mp4")) for tag in ("recon", "cross")]
    if set(means) != {"PSNR", "SSIM"} or not all(np.isfinite(list(means.values()))):
        raise AssertionError(f"cli vidtwin_evaluate: means {means}")
    if not all(written):
        raise AssertionError(f"cli vidtwin_reconstruct: mp4s written {written}")


def make_vidtwin_trainer(cfg: dict, device, lpips: str, seed: int = 0):
    """A VidTwin trainer at ``cfg`` with seeded weights (its init, then
    ``fill_zero_init_``), f32 attention when it trains in fp32, and the
    discriminator's last conv at TRAIN_DISC_GAIN x its init (phase 15's
    reason)."""
    import torch

    from vidtok_tpu_torch.models.vidtwin.trainer import VidTwinTrainer

    tr = VidTwinTrainer(cfg, device=device, lpips_weights=lpips, seed=seed).init_state()
    fill_zero_init_(tr.model, torch.Generator().manual_seed(seed + 7))
    if tr.compute_dtype is None:
        tr.model.encoder.set_attn_dtype(None)
        tr.model.decoder.set_attn_dtype(None)
    with torch.no_grad():
        tr.disc.main[-1].weight.mul_(TRAIN_DISC_GAIN)
    return tr


VIDTWIN_TRAIN_LOGS = ("train/aeloss", "train/nll_loss", "train/rec_loss", "train/p_loss",
                      "train/kl_loss", "train/d_weight", "train/discloss")


def vidtwin_train(device, lpips: str) -> None:
    """Phase 16d: ``VidTwinTrainer`` at the config's recipe (AdamW betas
    (0, 0.9), weight decay 1e-4, clip 20, bf16-mixed) with two changes so
    that every term runs and the generator moves: ``disc_start`` 0 and
    ``warmup_steps`` 2 in both schedules. Batch VIDTWIN_TRAIN_BATCH of
    ``train_clip``s. One fp32 step (f32 attention, TF32 off), then
    VIDTWIN_TRAIN_STEPS bf16-mixed steps on the same weights: s/step, peak
    memory, a profile of one more step. Gates: finite logs; the generator,
    discriminator and logvar moved by step 2; ``d_weight`` > 0 and the
    adaptive weight's norm ratio inside (0, 1e4) in both runs; each first
    step loss of VIDTWIN_TRAIN_LOGS and that ratio within TRAIN_SLACK x
    the reconstruction's bf16 spread (floored at TRAIN_FLOOR) of fp32's."""
    import torch

    x = torch.from_numpy(train_clip(VIDTWIN_TRAIN_BATCH, seed=17)).to(device)
    xin = x.permute(0, 4, 1, 2, 3)
    f32 = make_vidtwin_trainer(vidtwin_cfg(precision="fp32", disc_start=0, warmup_steps=2),
                               device, lpips)
    with torch.no_grad():
        rec32 = f32.model(xin, sample=False)[1].float()
    t0 = time.perf_counter()
    logs32, (ratio32,) = recorded_ratios(lambda: _finite_logs(f32.fit_step(x), "fp32 step"))
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    del f32
    torch.cuda.empty_cache()
    tr = make_vidtwin_trainer(vidtwin_cfg(disc_start=0, warmup_steps=2), device, lpips)
    with torch.no_grad():
        rec16 = tr.model(xin.bfloat16(), sample=False)[1]
    spread = rel_l2(rec16.float(), rec32)
    del rec16, rec32
    g0, d0, lv0 = _flat(tr.model), _flat(tr.disc), float(tr.logvar.detach())
    torch.cuda.reset_peak_memory_stats()
    lat, moved = [], None
    for i in range(VIDTWIN_TRAIN_STEPS):
        t0 = time.perf_counter()
        if i == 0:
            logs, (ratio16,) = recorded_ratios(lambda: _finite_logs(tr.fit_step(x), "bf16 step"))
            logs16 = dict(logs)
        else:
            logs = _finite_logs(tr.fit_step(x), "bf16 step")
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if i == 1:
            moved = {"generator": float((_flat(tr.model) - g0).abs().max()),
                     "discriminator": float((_flat(tr.disc) - d0).abs().max()),
                     "logvar": abs(float(tr.logvar.detach()) - lv0)}
            del g0, d0
    peak = torch.cuda.max_memory_allocated()
    print(f"train vidtwin: batch {list(VIDTWIN_TRAIN_BATCH)}; fp32 first step {t32:.3f} s; "
          f"bf16-mixed s/step " + " ".join(f"{v:.4f}" for v in lat)
          + f" (mean after the first {np.mean(lat[1:]):.4f}); peak_mem_bytes {peak}; "
          f"moved by step 2 (max |change|) {json.dumps(moved)}; bf16 spread of the "
          f"reconstruction {spread:.5f}; last logs "
          + json.dumps({k: round(v, 6) for k, v in logs.items()}), flush=True)
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train vidtwin: parameters did not move: {moved}")
    for what, r in (("fp32", ratio32), ("bf16", ratio16)):
        if not 0 < r < 1e4:
            raise AssertionError(f"train vidtwin: {what} adaptive weight ratio {r}")
    if not logs16["train/d_weight"] > 0:
        raise AssertionError(f"train vidtwin: d_weight {logs16['train/d_weight']}")
    logs16["adaptive_ratio"], logs32["adaptive_ratio"] = ratio16, ratio32
    for k in ("adaptive_ratio",) + VIDTWIN_TRAIN_LOGS:
        a, b = logs16[k], logs32[k]
        bound = max(TRAIN_SLACK * spread, TRAIN_FLOOR) * abs(b)
        print(f"train vidtwin: {k} bf16 {a:.6g} fp32 {b:.6g} |diff| {abs(a - b):.4g} "
              f"bound {bound:.4g}", flush=True)
        if not abs(a - b) <= bound:
            raise AssertionError(f"train vidtwin {k}: bf16 {a} vs fp32 {b} beyond {bound}")
    profile_call(lambda: tr.fit_step(x), "profile vidtwin train step")


def serve_vidtwin(device, t: float) -> float:
    """Phase 16: VidTwin (16a-16d); its files under CKPT_DIR, removed after."""
    import os
    import shutil
    import tempfile

    import torch

    os.makedirs(CKPT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=CKPT_DIR)
    try:
        tok32, x = vidtwin_serve(device)
        vidtwin_cpu_check(device, x)
        t = phase("vidtwin serve", t)
        ckpt = vidtwin_checkpoint(device, tok32, x, tmp)
        del tok32
        torch.cuda.empty_cache()
        t = phase("vidtwin checkpoint", t)
        vidtwin_clis(device, ckpt, tmp)
        t = phase("vidtwin clis", t)
        lpips = os.path.join(tmp, "lpips.npz")
        lpips_npz(lpips)
        vidtwin_train(device, lpips)
        torch.cuda.empty_cache()
        t = phase("vidtwin train", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return t


# Phase 17: the last modules of the port. VidTwin's ablation ladder
# (``models/vidtwin/ablations.py``) at the shipped VidTwin width (VIDTWIN_CFG
# with the target changed; the other Q-Formers at JAX's defaults); the
# H-sharded forward (``VideoTokenizer.forward_sharded`` over
# ``parallel/mesh.py``) of the v1.0 flagship and the FSQ 4096 model in
# SHARDED_WORLD gloo processes on the one card (NCCL refuses two ranks on one
# device), in f32 on the plain path and the flagship in bf16 with kernel E on
# each slab; the profiling helpers (``utils/profiling.py``). Nothing else of
# it runs a kernel of the sixteen.
ABLATION_TARGETS = ("VidAutoEncoderQformer", "VidAutoEncoderQformerCompact",
                    "VidAutoEncoderQformerCompactSym", "VidAutoEncoderQformerCompactSymDis")
ABLATION_TIMED = 2            # bf16 requests after a cold one
ABLATION_TRAIN_STEPS = 3      # bf16-mixed, after one fp32 step
SHARDED_WORLD = 2
SHARDED_REQUEST = (1, 3, 17, 256, 256)
# the flagship's sharded run on the kernel path: bf16, kernel E on each slab
SHARDED_KERNEL = "v1.0 kl 4x8x8 16chn, kernel E"
# the sharded f32 run against the single-process f32 plain run (TF32 off),
# relative L2 on z and the reconstruction and relative on kl_loss: the two
# differ only where cuDNN picks another algorithm for a slab's shape
SHARDED_GATE = 1e-4
# FSQ indices of the sharded run that may differ from the single process's:
# a code whose latent lies within rounding of a level boundary flips
SHARDED_FLIP_SHARE = 1e-3


def ablation_cfg(target: str, **changes) -> dict:
    """``vidtwin_cfg(**changes)`` with the model's target changed to the
    reference's dotted path of ``target``, as a reference config names it
    (``load_model_from_config`` dispatches VidTwin targets by it)."""
    cfg = vidtwin_cfg(**changes)
    cfg["model"]["target"] = f"vidtwin.models.vidtwin_ae.{target}"
    return cfg


def make_ablation(cfg: dict, seed: int):
    """The ladder model of ``cfg`` on the CPU in f32 with ``vidtok_tpu``'s
    init, then ``fill_zero_init_``; and its meta."""
    import torch

    from vidtok_tpu_torch.models.vidtwin.vidtwin_ae import (build_vidtwin_from_config,
                                                            reset_params_)

    model, meta = build_vidtwin_from_config(cfg["model"])
    g = torch.Generator().manual_seed(seed)
    reset_params_(model, g)
    fill_zero_init_(model, g)
    return model, meta


def _f32_attention(model):
    model.encoder.set_attn_dtype(None)
    model.decoder.set_attn_dtype(None)
    return model


def serve_ablation(target: str, device, seed: int, x):
    """Phase 17a, one target: its parameter count; one cold and
    ABLATION_TIMED timed bf16 requests of VIDTWIN_REQUEST (weights bf16 at
    rest; host clock ending in a synchronize), frames/s, peak memory, no
    launch of the sixteen kernels; one f32 request (f32 attention) on the
    same weights and draws, the bf16 run within VIDTWIN_BF16_GATE of it;
    the model cut to VIDTWIN_DEPTH_CUT blocks in f32 on the card against
    the CPU within VIDTWIN_CPU_GATE (SymDis at ``shuffle_ratio`` 0 there:
    the CPU's and the card's generators draw different permutations).
    Returns the f32 engine."""
    import copy

    import torch

    from vidtok_tpu_torch.models.vidtwin.engine import VidTwinTokenizer
    from vidtok_tpu_torch.ops import kernels as K

    model, meta = make_ablation(ablation_cfg(target), seed)
    n = sum(p.numel() for p in model.parameters())
    tok = VidTwinTokenizer(copy.deepcopy(model).to(device, torch.bfloat16), meta,
                           torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    lat = []
    for _ in range(1 + ABLATION_TIMED):
        t0 = time.perf_counter()
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        _check_finite(f"{target} bf16 request", z, dec)
    peak = torch.cuda.max_memory_allocated()
    if any(K.counts().values()):
        raise AssertionError(f"{target} launched kernels {K.counts()}")
    want_z = (2 * VIDTWIN_REQUEST[0] if target.endswith("Dis") else VIDTWIN_REQUEST[0],)
    if tuple(dec.shape) != VIDTWIN_REQUEST or tuple(z.shape) != want_z + VIDTWIN_Z[1:]:
        raise AssertionError(f"{target} shapes z {tuple(z.shape)} dec {tuple(dec.shape)}")
    if float(log["kl_loss"]) != 0.0:
        raise AssertionError(f"{target} kl_loss {float(log['kl_loss'])}")
    b, _, t = VIDTWIN_REQUEST[:3]
    print(f"serve ablation {target} ({n} parameters): request {list(VIDTWIN_REQUEST)} "
          f"bf16, weights bf16; latency_s " + " ".join(f"{v:.4f}" for v in lat)
          + f"; frames_per_s (best after the cold one) {b * t / min(lat[1:]):.2f}; "
          f"peak_mem_bytes {peak}; launches of the sixteen kernels 0", flush=True)

    tok32 = VidTwinTokenizer(_f32_attention(model).to(device), meta)
    tok.generator.manual_seed(0)  # the same draws (SymDis) in both runs
    z16, dec16, _ = tok(x)
    t0 = time.perf_counter()
    z32, dec32, _ = tok32(x)
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    _check_finite(f"{target} f32 request", z32, dec32)
    spread = {"z": rel_l2(z16, z32), "reconstruction": rel_l2(dec16, dec32)}
    del tok, z16, dec16
    torch.cuda.empty_cache()

    cut = ablation_cfg(target, depth=VIDTWIN_DEPTH_CUT)
    cpu, cpu_meta = make_ablation(cut, seed + 1)
    card = VidTwinTokenizer(_f32_attention(copy.deepcopy(cpu)).to(device), cpu_meta)
    cpu = VidTwinTokenizer(_f32_attention(cpu), cpu_meta)
    for m in (cpu.model, card.model):
        if hasattr(m, "shuffle_ratio"):
            m.shuffle_ratio = 0.0
    zc, dc, _ = cpu(x[:1])
    zg, dg, _ = card(x[:1])
    spread_cpu = {"z": rel_l2(zg.cpu(), zc), "reconstruction": rel_l2(dg.cpu(), dc)}
    print(f"serve ablation {target}: f32 request (attention f32) {t32:.4f} s; bf16 "
          f"against it (relative L2) {json.dumps(spread)}, gate {VIDTWIN_BF16_GATE}; "
          f"depth {VIDTWIN_DEPTH_CUT} f32 card against CPU {json.dumps(spread_cpu)}, "
          f"gate {VIDTWIN_CPU_GATE}", flush=True)
    if not max(spread.values()) <= VIDTWIN_BF16_GATE:
        raise AssertionError(f"{target} bf16 against f32: {spread}")
    if not max(spread_cpu.values()) <= VIDTWIN_CPU_GATE:
        raise AssertionError(f"{target} card against CPU: {spread_cpu}")
    return tok32


def ablation_checkpoint(device, tok32, target: str, x, tmp: str) -> None:
    """Phase 17a: the f32 ablation's weights as a reference-named ``.ckpt``
    with keys the reader drops (its Q-Formers' text FFN, the loss, the
    sincos buffers), loaded through ``load_model_from_config(cfg,
    ckpt=...)`` (strict): one clip's reconstruction bit-equal."""
    import os

    import torch

    from vidtok_tpu_torch import load_model_from_config

    extra = {"loss.logvar": torch.zeros(()), "encoder.pos_embed": torch.zeros(1, 196, 768)}
    for name, m in tok32.model.named_children():
        if name.endswith("_qformer") and hasattr(m, "query_embeds"):
            extra[f"{name}.qformer.encoder.layer.0.intermediate.dense.weight"] = \
                torch.zeros(768, 64)
    path = os.path.join(tmp, "ablation.ckpt")
    sd = {k: v.detach().cpu() for k, v in tok32.model.state_dict().items()}
    torch.save({"state_dict": {**sd, **extra}}, path)
    t0 = time.perf_counter()
    back = load_model_from_config(ablation_cfg(target), ckpt=path, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _f32_attention(back.model)
    tok32.generator.manual_seed(0)
    (_, da, _), (_, db, _) = tok32(x[:1]), back(x[:1])
    same = torch.equal(da, db)
    print(f"checkpoint ablation {target}: {os.path.getsize(path)} bytes with "
          f"{len(extra)} keys the reader drops (the Q-Formers' text FFN among them); "
          f"load_model_from_config with ckpt {load_s:.3f} s; reconstruction bit-equal "
          f"{same}", flush=True)
    if not same:
        raise AssertionError(f"{target} checkpoint round trip changed the model")


def ablation_train(device, lpips: str) -> None:
    """Phase 17a: ``VidTwinTrainer`` on SymDis at VidTwin's recipe with
    ``disc_start`` 0 and ``warmup_steps`` 2 (as phase 16d): one fp32 step
    (f32 attention), then ABLATION_TRAIN_STEPS bf16-mixed steps at batch
    VIDTWIN_TRAIN_BATCH; gates: finite logs, generator, discriminator and
    logvar moved by step 2, ``d_weight`` > 0, ``kl_loss`` 0."""
    import torch

    target = ABLATION_TARGETS[-1]
    x = torch.from_numpy(train_clip(VIDTWIN_TRAIN_BATCH, seed=18)).to(device)
    f32 = make_vidtwin_trainer(ablation_cfg(target, precision="fp32", disc_start=0,
                                            warmup_steps=2), device, lpips)
    t0 = time.perf_counter()
    logs32 = _finite_logs(f32.fit_step(x), f"{target} fp32 step")
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    del f32
    torch.cuda.empty_cache()
    tr = make_vidtwin_trainer(ablation_cfg(target, disc_start=0, warmup_steps=2), device,
                              lpips)
    g0, d0, lv0 = _flat(tr.model), _flat(tr.disc), float(tr.logvar.detach())
    torch.cuda.reset_peak_memory_stats()
    lat, moved, logs = [], None, None
    for i in range(ABLATION_TRAIN_STEPS):
        t0 = time.perf_counter()
        logs = _finite_logs(tr.fit_step(x), f"{target} bf16 step")
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if i == 1:
            moved = {"generator": float((_flat(tr.model) - g0).abs().max()),
                     "discriminator": float((_flat(tr.disc) - d0).abs().max()),
                     "logvar": abs(float(tr.logvar.detach()) - lv0)}
            del g0, d0
    peak = torch.cuda.max_memory_allocated()
    print(f"train ablation {target}: batch {list(VIDTWIN_TRAIN_BATCH)}; fp32 first step "
          f"{t32:.3f} s (d_weight {logs32['train/d_weight']:.6g}); bf16-mixed s/step "
          + " ".join(f"{v:.4f}" for v in lat) + f"; peak_mem_bytes {peak}; moved by step 2 "
          f"{json.dumps(moved)}; last logs "
          + json.dumps({k: round(v, 6) for k, v in logs.items()}), flush=True)
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train {target}: parameters did not move: {moved}")
    for what, lg in (("fp32", logs32), ("bf16", logs)):
        if not (lg["train/d_weight"] > 0 and lg["train/kl_loss"] == 0.0):
            raise AssertionError(f"train {target} {what}: d_weight {lg['train/d_weight']}, "
                                 f"kl_loss {lg['train/kl_loss']}")


def sharded_clip() -> np.ndarray:
    return np.clip(np.random.RandomState(170).randn(*SHARDED_REQUEST) * 0.5, -1, 1
                   ).astype(np.float32)


def plain_f32_tokenizer(cfg: dict, device, seed: int = 0):
    """``make_tokenizer``'s weights in f32 on the plain path."""
    import torch

    from vidtok_tpu_torch import load_model_from_config
    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer

    tok = load_model_from_config(cfg, seed=seed, device="cpu")
    randomize_(tok.core, seed=seed)
    return VideoTokenizer(tok.core.to(device), tok.meta, torch.float32, fused=False)


SHARDED_MODELS = (("v1.0 kl 4x8x8 16chn", V1_0_CFG), ("v1.0 fsq 4096", FSQ_CFG))


def _sharded_runs(name: str, tok):
    """(key, tokenizer) of phase 17b's runs of SHARDED_MODELS' ``name``:
    its f32 plain tokenizer; the flagship's also on the kernel path in
    bf16 (SHARDED_KERNEL), where the nearest temporal upsample takes
    kernel E on each slab."""
    import torch

    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer

    runs = [(name, tok)]
    if name == SHARDED_MODELS[0][0]:
        runs.append((SHARDED_KERNEL, VideoTokenizer(tok.core, tok.meta, torch.bfloat16,
                                                    fused=True)))
    return runs


def _sharded_worker(rank: int, world: int, init: str, out: str) -> None:
    """One rank of phase 17b: each of ``_sharded_runs`` (TF32 off)
    through ``forward_sharded`` on the whole SHARDED_REQUEST, once to warm
    up and once timed; its whole results, wall time and the timed run's
    kernel launches to ``out.{rank}``."""
    import torch
    import torch.distributed as dist

    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.parallel.distributed import init_distributed
    from vidtok_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo", init, world, rank, device_index=0)
    device = torch.device("cuda", 0)
    mesh = make_mesh(n_spatial=world)
    x = sharded_clip()
    got = {}
    for name, cfg in SHARDED_MODELS:
        for key, tok in _sharded_runs(name, plain_f32_tokenizer(cfg, device)):
            tok.forward_sharded(x, mesh)
            torch.cuda.synchronize()
            dist.barrier()
            K.reset_counts()
            t0 = time.perf_counter()
            z, dec, log = tok.forward_sharded(x, mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got[key] = {"z": z.float().cpu(), "dec": dec.float().cpu(), "wall": wall,
                        "launches": dict(K.counts()),
                        **{k: v.cpu() for k, v in log.items()}}
            del tok, z, dec
        torch.cuda.empty_cache()
    got["mesh"] = (tuple(mesh.shape), mesh.index, mesh.size)
    torch.save(got, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


def serve_sharded(device, tmp: str) -> None:
    """Phases 17b and 17c. The single-process f32 plain run of each of
    SHARDED_MODELS on SHARDED_REQUEST (TF32 off), the flagship's inside
    ``profiling.trace`` (17c: a trace file written;
    ``device_memory_report()``'s peak equal to ``max_memory_allocated``),
    and the flagship's plain bf16 run; then SHARDED_WORLD gloo processes
    on the card (``torch.multiprocessing``, a file ``init_method``) run
    ``forward_sharded`` (``_sharded_runs``); gates: every rank's whole
    results equal; the f32 runs' z and reconstruction within SHARDED_GATE
    (relative L2) of the single process, kl_loss and FSQ's aux_loss within
    it (relative), FSQ's indices equal but for at most SHARDED_FLIP_SHARE
    of them (the count printed), no kernel launched; the bf16 kernel run
    no further from the single-process f32 run than BF16_SLACK x the plain
    bf16 run is, on z and the reconstruction, each rank launching kernel E
    PER_FORWARD["v1_0"] times and no other kernel."""
    import os

    import torch
    import torch.multiprocessing as mp

    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer
    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.utils import profiling

    x = sharded_clip()
    single = {}
    K.reset_counts()
    for name, cfg in SHARDED_MODELS:
        tok = plain_f32_tokenizer(cfg, device)
        tok(x)  # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok(x)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        if name == SHARDED_MODELS[0][0]:
            torch.cuda.reset_peak_memory_stats()
            logdir = os.path.join(tmp, "trace")
            t0 = time.perf_counter()
            with profiling.trace(logdir):
                z, dec, log = tok(x)
            trace_s = time.perf_counter() - t0
            report = profiling.device_memory_report()
            peak = torch.cuda.max_memory_allocated()
            files = sorted(os.listdir(logdir))
            size = sum(os.path.getsize(os.path.join(logdir, f)) for f in files)
            mem = report.get(str(device), {})
            print(f"profiling: trace of one {name} f32 request {list(SHARDED_REQUEST)} "
                  f"({trace_s:.3f} s with the profiler on): {files} {size} bytes; "
                  f"device_memory_report {json.dumps(report)}; max_memory_allocated "
                  f"{peak}; {profiling.param_memory_report(tok.core)}", flush=True)
            if not files or size == 0 or mem.get("peak_bytes_in_use") != peak:
                raise AssertionError(f"profiling: trace files {files} ({size} bytes), "
                                     f"report {report} against peak {peak}")
            zb, decb, _ = VideoTokenizer(tok.core, tok.meta, torch.bfloat16, fused=False)(x)
            single[SHARDED_KERNEL] = {"z": zb.float().cpu(), "dec": decb.float().cpu()}
            del zb, decb
        else:
            z, dec, log = tok(x)
        single[name] = {"z": z.cpu(), "dec": dec.cpu(), "wall": single_s,
                        **{k: v.cpu() for k, v in log.items()}}
        del tok, z, dec
        torch.cuda.empty_cache()
    if any(K.counts().values()):
        raise AssertionError(f"phase 17 single-process runs launched kernels {K.counts()}")

    out = os.path.join(tmp, "sharded")
    t0 = time.perf_counter()
    mp.spawn(_sharded_worker, args=(SHARDED_WORLD, f"file://{os.path.abspath(tmp)}/init",
                                    out), nprocs=SHARDED_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}", weights_only=True) for r in range(SHARDED_WORLD)]
    keys = [name for name, _ in SHARDED_MODELS] + [SHARDED_KERNEL]
    e_only = dict(dict.fromkeys(K.WRAPPERS, 0),
                  parity_up2x_fused=PER_FORWARD["v1_0"]["parity_up2x_fused"])
    for r, got in enumerate(ranks):
        if tuple(got["mesh"]) != ((1, SHARDED_WORLD), r, SHARDED_WORLD):
            raise AssertionError(f"sharded rank {r}: mesh {got['mesh']}")
        for key in keys:
            want = e_only if key == SHARDED_KERNEL else dict.fromkeys(K.WRAPPERS, 0)
            if got[key]["launches"] != want:
                raise AssertionError(f"sharded rank {r} {key}: launches "
                                     f"{got[key]['launches']} != {want}")
            for k, v in got[key].items():
                if k not in ("wall", "launches") and not torch.equal(v, ranks[0][key][k]):
                    raise AssertionError(f"sharded rank {r} {key} {k} differs from rank 0's")

    def walls(key):
        return ("wall per rank " + " ".join(f"{r[key]['wall']:.3f}" for r in ranks)
                + " s (two ranks on one card measure correctness, not scaling)")

    slabs = (f"over {SHARDED_WORLD} gloo ranks on one card (H {SHARDED_REQUEST[3]} in "
             f"slabs of {SHARDED_REQUEST[3] // SHARDED_WORLD})")
    for name, _ in SHARDED_MODELS:
        got, want = ranks[0][name], single[name]
        loss = "aux_loss" if "aux_loss" in want else "kl_loss"
        err = {"z": rel_l2(got["z"], want["z"]), "reconstruction": rel_l2(got["dec"], want["dec"]),
               loss: abs(float(got[loss]) / float(want[loss]) - 1)}
        line = (f"sharded {name}: forward_sharded {slabs}, f32, TF32 off: {walls(name)}, "
                f"one process {want['wall']:.3f} s; meshes "
                f"{[tuple(r['mesh']) for r in ranks]}; against the single process "
                f"{json.dumps(err)}, gate {SHARDED_GATE}")
        if "indices" in want:
            flips = int((got["indices"] != want["indices"]).sum())
            line += (f"; indices differing {flips} of {want['indices'].numel()}, gate "
                     f"{SHARDED_FLIP_SHARE} of them")
            if flips > SHARDED_FLIP_SHARE * want["indices"].numel():
                raise AssertionError(f"sharded {name}: {flips} indices differ")
        print(line, flush=True)
        if not max(err.values()) <= SHARDED_GATE:
            raise AssertionError(f"sharded {name}: {err}")
    got, f32, plain = ranks[0][SHARDED_KERNEL], single[SHARDED_MODELS[0][0]], \
        single[SHARDED_KERNEL]
    err = {}
    for k, what in (("z", "z"), ("dec", "recon")):
        err[f"{what}_sharded_vs_f32"] = rel_l2(got[k], f32[k])
        err[f"{what}_plain_vs_f32"] = rel_l2(plain[k], f32[k])
        err[f"{what}_sharded_vs_plain"] = rel_l2(got[k], plain[k])
    print(f"sharded {SHARDED_KERNEL}: forward_sharded {slabs}, bf16, kernel E on each "
          f"slab ({got['launches']['parity_up2x_fused']} launches a rank): {walls(SHARDED_KERNEL)}; "
          f"kl_loss {float(got['kl_loss']):.6g} (f32 single process "
          f"{float(f32['kl_loss']):.6g}); rel_l2 {json.dumps(err)}, gate {BF16_SLACK} x plain "
          f"bf16 vs f32", flush=True)
    for what in ("z", "recon"):
        if not err[f"{what}_sharded_vs_f32"] <= BF16_SLACK * err[f"{what}_plain_vs_f32"]:
            raise AssertionError(f"sharded {SHARDED_KERNEL} {what}: {err}")
    print(f"sharded: {SHARDED_WORLD} processes spawned, built and run in {spawn_s:.1f} s",
          flush=True)


def serve_ladder_and_sharding(device, t: float) -> float:
    """Phase 17 (17a-17c); its files under CKPT_DIR, removed after."""
    import os
    import shutil
    import tempfile

    import torch

    t17 = t
    os.makedirs(CKPT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=CKPT_DIR)
    try:
        x = np.clip(np.random.RandomState(310).randn(*VIDTWIN_REQUEST) * 0.5, -1, 1
                    ).astype(np.float32)
        for i, target in enumerate(ABLATION_TARGETS):
            tok32 = serve_ablation(target, device, 20 + i, x)
            if i == 0:
                ablation_checkpoint(device, tok32, target, x, tmp)
            del tok32
            torch.cuda.empty_cache()
        t = phase("ablation serve", t)
        lpips = os.path.join(tmp, "lpips.npz")
        lpips_npz(lpips)
        ablation_train(device, lpips)
        torch.cuda.empty_cache()
        t = phase("ablation train", t)
        serve_sharded(device, tmp)
        t = phase("sharded and profiling", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("17 (ablations, sharded forward, profiling)", t17)
    return t


def f32_e2e_check(tok, shape, per_forward: dict, what: str) -> dict:
    """The f32 engine ``tok`` on its kernel path against itself with
    ``fused`` off (the plain f32 path; TF32 off), one request of ``shape``
    each: the launches (``per_forward``; none on the plain path), finite
    outputs, z and the reconstruction within F32_E2E_GATE."""
    import torch

    from vidtok_tpu_torch.ops import kernels as K

    x = np.clip(np.random.RandomState(100).randn(*shape) * 0.5, -1, 1).astype(np.float32)
    outs = {}
    for key, fused in (("kernel_f32", True), ("plain_f32", False)):
        tok.fused = fused
        K.reset_counts()
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        want = per_forward if fused else dict.fromkeys(per_forward, 0)
        if K.counts() != want:
            raise AssertionError(f"f32 e2e {what} {key}: launches {K.counts()} != {want}")
        for t in (z, dec, log["kl_loss"]):
            if not torch.isfinite(t).all():
                raise AssertionError(f"f32 e2e {what} {key}: non-finite output")
        outs[key] = (z.cpu(), dec.cpu())
        del z, dec, log
    tok.fused = True
    res = {f"{w}_kernel_f32_vs_plain_f32": rel_l2(outs["kernel_f32"][i], outs["plain_f32"][i])
           for i, w in enumerate(("z", "recon"))}
    print(f"f32 e2e {what} {list(shape)} rel_l2 " + json.dumps(res), flush=True)
    for k, v in res.items():
        if not v <= F32_E2E_GATE:
            raise AssertionError(f"f32 e2e {what} {list(shape)}: {k} {v} > {F32_E2E_GATE}")
    return res


def f32_tokenizer(cfg: dict, device, seed: int = 0):
    """``load_model_from_config(cfg, device=device,
    compute_dtype=torch.float32)`` as a user calls it (``fused`` at its
    default, which must be on), with ``randomize_`` weights (drawn on a CPU
    copy and loaded)."""
    import torch

    from vidtok_tpu_torch import load_model_from_config

    tok = load_model_from_config(cfg, seed=seed, device=device,
                                 compute_dtype=torch.float32)
    if not tok.fused:
        raise AssertionError("f32 on the card: fused is off by default")
    cpu = load_model_from_config(cfg, seed=seed, device="cpu", compute_dtype=torch.float32)
    randomize_(cpu.core, seed=seed)
    tok.core.load_state_dict(cpu.core.state_dict())
    return tok


def serve_f32_forms(tok, path: str, label: str, shapes) -> dict:
    """One f32 request of ``tok`` in the forms of F32_FORMS ``path``, timed
    with its launches per forward (``f32_calls``), then ``f32_e2e_check``
    against the plain f32 path at each of ``shapes`` (the first the
    request's); the default forms again after. Returns the ``serve``
    result."""
    from vidtok_tpu_torch import KernelForms

    tok.forms = kernel_forms(F32_FORMS[path])
    per = per_forward(f32_calls()[path])
    r = serve(tok, 1, shapes[0], per)
    del r["last"]
    report(f"f32 kernel path in forms {tok.forms}: {label}", r, shapes[0], "f32")
    for shape in shapes:
        f32_e2e_check(tok, shape, per, f"{label}, forms {tok.forms}")
    tok.forms = KernelForms()
    return r


def serve_f32(device) -> dict:
    """Phase 19: f32 through the kernels, the engine's default on the card.
    (a) the v1.0 flagship from ``f32_tokenizer`` (FLAGSHIP_PARAMS
    parameters): N_REQUESTS requests of REQUEST with PER_FORWARD["v1_0"]
    launches each (latency, frames/s, peak memory), a profile of one (the
    busy share), 2 requests on the plain f32 path (the same engine, ``fused``
    off), ``f32_e2e_check`` at REQUEST and at PARTIAL_REQUEST (a 33²
    latent), then ``serve_f32_forms`` in the forms of ``v1_0_forms_f32``
    and ``v1_0_split_f32`` at both shapes; (b) the v1.1 model tiled
    (``use_overlap``, ``t_chunk_enc`` 16): N_REQUESTS requests of
    TILED_REQUEST with ``tiled_per_forward``'s launches, a profile, 2
    requests on the tiled plain f32 path, ``f32_e2e_check`` against it,
    then ``serve_f32_forms`` in the forms of ``tiled_forms_f32``. Returns
    {F32_PATHS' path: the kernel path's ``serve`` result, the default
    forms' with its ``busy_share``}."""
    import torch

    runs = {}
    tok = f32_tokenizer(V1_0_CFG, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    if n_params != FLAGSHIP_PARAMS:
        raise AssertionError(f"flagship: {n_params} parameters, not {FLAGSHIP_PARAMS}")
    for path, label, shape, per, tiled in (
            ("v1_0_f32", f"v1.0 kl 4x8x8 16chn, {n_params} params", REQUEST,
             PER_FORWARD["v1_0"], False),
            ("tiled_f32", "tiled v1.1 kl 4x8x8 16chn, use_overlap, t_chunk_enc 16",
             TILED_REQUEST, tiled_per_forward(TILED_REQUEST[2]), True)):
        if tiled:
            del tok
            torch.cuda.empty_cache()
            tok = f32_tokenizer(V1_1_CFG, device)
            tok.use_tiling, tok.use_overlap = True, True
        r = serve(tok, N_REQUESTS, shape, per)
        report(f"f32 kernel path (the default): {label}", r, shape, "f32")
        r["busy_share"] = profile_request(tok, shape)
        print(f"f32 kernel path {label}: busy share {r['busy_share']}", flush=True)
        tok.fused = False
        plain = serve(tok, 2, shape, dict.fromkeys(per, 0))
        report(f"f32 plain path: {label}", plain, shape, "f32")
        tok.fused = True
        print(f"f32 {label}: kernel path {min(r['latency_s'][1:]):.4f} s against plain "
              f"{min(plain['latency_s']):.4f} s a request", flush=True)
        runs[path] = r
        del r["last"], plain
        torch.cuda.empty_cache()
        f32_e2e_check(tok, shape, per, label)
        if tiled:
            runs["tiled_forms_f32"] = serve_f32_forms(tok, "tiled_forms_f32", label, [shape])
        else:
            f32_e2e_check(tok, PARTIAL_REQUEST, per, label)
            for fpath in ("v1_0_forms_f32", "v1_0_split_f32"):
                runs[fpath] = serve_f32_forms(tok, fpath, label, [shape, PARTIAL_REQUEST])
            torch.cuda.empty_cache()
    del tok
    torch.cuda.empty_cache()
    return runs


def serve_width_f32(cfg: dict, path: str, label: str, device, shapes,
                    n_params_want: int = None) -> dict:
    """One f32 request of ``shapes[0]`` through the engine of ``cfg`` on
    its default f32 kernel path (``f32_tokenizer``), PER_FORWARD[path]
    launches, then ``f32_e2e_check`` against its plain f32 path at each of
    ``shapes``. Returns the ``serve`` result."""
    import torch

    tok = f32_tokenizer(cfg, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    if n_params_want is not None and n_params != n_params_want:
        raise AssertionError(f"{label}: {n_params} parameters, not {n_params_want}")
    r = serve(tok, 1, shapes[0], PER_FORWARD[path])
    del r["last"]
    report(f"f32 kernel path (the default): {label}, {n_params} params", r, shapes[0], "f32")
    for shape in shapes:
        f32_e2e_check(tok, shape, PER_FORWARD[path], label)
    del tok
    torch.cuda.empty_cache()
    return r


def serve_widths(device) -> dict:
    """Phase 20: the kernel path at channel widths other than the released
    models'. (a) For each of WIDTHS, the flagship from its file, loaded
    (``load_config``) and merged (``merge_configs``) with ``ch`` set in
    both the encoder's and the decoder's params (``width_override``), its
    launches per forward from ``model_calls`` those of the flagship (A 20,
    B 20, C 3, D 1, E 2): ``serve_both_paths`` (N_REQUESTS bf16 requests
    of REQUEST on each path, a profile, the end-to-end gate at REQUEST and
    at PARTIAL_REQUEST) with its parameters checked, then
    ``serve_width_f32`` at both shapes; (b) the CPU tests' ch-32 v1.1 model
    (CH32_CFG; A 6, B 6, C 1, D 1) at CH32_REQUEST: N_REQUESTS bf16
    requests, the end-to-end gate, and ``serve_width_f32``. Returns {path: the kernel
    path's ``serve`` result} (f32 runs under path + "_f32")."""
    import os

    import torch

    from vidtok_tpu_torch import load_config, merge_configs

    file = os.path.join(os.path.dirname(os.path.abspath(__file__)), FLAGSHIP_YAML)
    runs = {}
    for name, (ch, n_params) in WIDTHS.items():
        cfg = merge_configs(load_config(file), width_override(ch))
        label = f"v1.0 kl 4x8x8 16chn at ch {ch} (merge_configs of {FLAGSHIP_YAML})"
        per = per_forward(model_calls(cfg, REQUEST))
        if not per == PER_FORWARD[name] == PER_FORWARD["v1_0"]:
            raise AssertionError(f"{label}: launches per forward {per}, not the flagship's "
                                 f"{PER_FORWARD['v1_0']}")
        runs[name] = serve_both_paths(label, cfg, name, device, n_params_want=n_params)
        del runs[name]["last"]
        torch.cuda.empty_cache()
        runs[name + "_f32"] = serve_width_f32(cfg, name, label, device,
                                              [REQUEST, PARTIAL_REQUEST], n_params)
    label = "v1.1 kl ch 32 (the CPU tests' model)"
    tok = make_tokenizer(CH32_CFG, device)
    r = serve(tok, N_REQUESTS, CH32_REQUEST, PER_FORWARD["ch32"])
    del r["last"]
    report(f"kernel path: {label}, {sum(p.numel() for p in tok.core.parameters())} params",
           r, CH32_REQUEST)
    e2e_check(tok.core, tok.meta, CH32_REQUEST, "ch32")
    runs["ch32"] = r
    del tok
    runs["ch32_f32"] = serve_width_f32(CH32_CFG, "ch32", label, device, [CH32_REQUEST])
    torch.cuda.empty_cache()
    return runs


def phase(name: str, t0: float) -> float:
    t = time.perf_counter()
    print(f"phase {name}: {t - t0:.1f} s", flush=True)
    return t


def check_only(device, names) -> int:
    """``--kernels``: phase 2 for the named kernels alone (D's T=201 window
    too when D is named, in bf16 and f32, D''s in f32 when D' is; a tool's
    kernels at the tools' shapes), every gate reported; 1 if any failed."""
    checks = []
    if set(names) & set(SOURCES):
        checks.append(lambda: check_kernels(device, names))
    if set(names) & set(F32_KERNELS):
        checks.append(lambda: check_kernels(device, names, in_f32=True))
    if "decoder_tail_rgb" in names:
        checks.append(lambda: check_tail_long(device))
        checks.append(lambda: check_tail_long(device, in_f32=True))
    if "decoder_tail_rgb_taps" in names:
        checks.append(lambda: check_tail_long(device, in_f32=True, taps=True))
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
    import os

    # cuBLAS's deterministic workspace, read when its handle is made (the
    # train resume of phase 15 runs under torch.use_deterministic_algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    kres32 = check_kernels(device, in_f32=True)
    for check in (check_parity_long, check_spatial_long, check_tail_long,
                  functools.partial(check_tail_long, taps=True)):
        check(device, in_f32=True)
        torch.cuda.empty_cache()
    t = phase("kernels f32", t)
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
    check_fsq_262144(device, "fsq 262144", "fsq 262144, kernel path: v1.1 fsq 4x16x16 "
                     "262144 codes", "fsq_41616")
    torch.cuda.empty_cache()
    t = phase("v1.1 fsq 41616 262144 serve", t)
    serve_fsq_options(device)
    torch.cuda.empty_cache()
    t = phase("v1.0 fsq options serve", t)
    check_fsq_262144(device, "fsq 262144 non-causal", "fsq 262144 non-causal, kernel "
                     "path: non-causal fsq 4x8x8 262144 codes", "noncausal",
                     make_tokenizer(NONCAUSAL_FSQ_CFG, device))
    torch.cuda.empty_cache()
    t = phase("non-causal fsq 262144 serve", t)
    serve_tiled_888(device)
    torch.cuda.empty_cache()
    t = phase("v1.1 fsq 888 tiled serve", t)
    serve_444(device)
    torch.cuda.empty_cache()
    t = phase("v1.0 kl 444 serve", t)
    checkpoint_round_trip(device)
    t = phase("checkpoint", t)
    t = serve_clis(device, t)
    t = serve_training(device, t)
    t = serve_vidtwin(device, t)
    t = serve_ladder_and_sharding(device, t)
    serve_public_surface(device)
    torch.cuda.empty_cache()
    t = phase("18 (public surface)", t)
    runs.update(serve_f32(device))
    t = phase("19 (f32 through the kernels)", t)
    runs.update(serve_widths(device))
    phase("20 (other widths through the kernels)", t)
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
    for name in F32_KERNELS:
        (source, replaces, headers), r = SOURCES[name], kres32[name]
        path = F32_MAIN_PATH[name]
        by_bytes = r["bound_by_bytes_ms"][path] >= r["bound_by_ops_ms"][path]
        kernels.append({
            "name": f"{name} (f32)", "route": "cuda", "source": source,
            "replaces": replaces, "headers": list(headers),
            "launches": runs[path]["launches"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"][path], "plain_ms": r["plain_ms"][path],
            "bound_ms": r["bound_ms"][path],
            "bound_by": "bytes" if by_bytes else "operations", "library_ms": None})
    kernels += [tool_entry(name, tool_checks[name], tool_launches[name], tool_rows)
                for name in TOOL_SOURCES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
