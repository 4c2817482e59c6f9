"""The card gate of the PyTorch/CUDA port (``vidtok_tpu_torch``): drive it
once on one NVIDIA GPU.

    python3 -m chip_smoke [--kernels NAME[,NAME...]]

Phases, each of which raises on failure (exit code != 0, no result line),
in this order (``__main__``):

1-2. build the hand-written kernels and hold each against its plain
     PyTorch version at every shape the serving paths give it, in bf16
     and f32, and the decoder's kernel forms against each other
     (``kernels``); the tools' kernels and both tools' mains
     (``tool_kernels``);
3-13. serve every configuration on its kernel path with its launches
     counted, each held end to end to its plain path, and the checkpoint
     round trip (``serving``);
14. the CLIs (``clis``); 15. training (``training``); 16 and 17a.
     VidTwin and its ablation ladder (``vidtwin``); 17b-c. the H-sharded
     forward and the profiling helpers (``sharding``);
18-20. the public surface, f32 through the kernels and other channel
     widths (``serving``).

Each module's docstring says what its phases run and gate.

``python3 -m chip_smoke --kernels NAME[,NAME...]`` runs phases 1 and 2
for the named kernels of SOURCES and TOOL_SOURCES alone, in bf16 and f32
(and D's T=201 window when D is named, in both, D''s in f32 when D' is;
a tool's kernel at the tools' shapes), reports every gate that fails and
exits 1 if any did, with no result line: the check to run from a copy of
the checkout with a planted fault.

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

This module holds what the phases, the CPU tests and ``vtbench``'s
reference test read: the resolved configurations, request and call
shapes, gates and limits, the model of each forward's kernel calls
(``model_calls``) and of each call's work (``work``). Importing it
touches no CUDA device.
"""

from __future__ import annotations

import os
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    # the trilinear upsample's blend replaces no TPU kernel: XLA fuses the
    # JAX module's chain
    "temporal_linear_blend": ("vidtok_tpu_torch/csrc/temporal_linear.cu",
                              "none (vidtok_tpu/modules/blocks.py:538-571, XLA)", ()),
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
PER_FORWARD["v1_1"] = dict(PER_FORWARD["v1_0"], parity_up2x_fused=0, temporal_linear_blend=2)
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
# the trilinear upsample's blend at two clips of a 33² frame, at a width
# that is a multiple of 8 and not a power of 2 (vectors) and at one that is
# not a multiple of 8 (a channel a thread): a stream's first and later
# chunk, and one segment with the zero front
PARTIAL_LINEAR = [(2, 5, 33, 33, 200), (2, 5, 33, 33, 37)]
# kernel D's tail call of a non-tiled T=201 v1.0 request (204 frames, 3.4 GB
# of input, in runs of frames that start with 2 warm-up frames): its last
# run's output frames against the plain version of those frames and the 2
# before them
TAIL_LONG = (1, 204, 256, 256, 128)
# phase 17b's sharded forward: SHARDED_WORLD ranks, each on a slab of the
# request's rows (kernel E's calls there are phase 2's too)
SHARDED_WORLD = 2
SHARDED_REQUEST = (1, 3, 17, 256, 256)
# one request at a 33² latent, tiled v1.1 and non-tiled v1.0, each held to
# its f32 plain run
PARTIAL_REQUEST = (1, 3, 17, 264, 264)



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
               "decoder_tail_rgb_taps": (2, 6, 33, 33, 128),
               "temporal_linear_blend": (2, 5, 33, 33, 200)}
F32_KERNELS = tuple(F32_PARTIAL)
# each f32 kernel's path in the result line (launches, times)
F32_MAIN_PATH = dict.fromkeys(F32_KERNELS, "v1_0_f32") | {
    "fused_temporal_resblock_stream": "tiled_f32",
    "parity_blend_interleave": "v1_0_split_f32",
    "parity_blend_interleave4": "v1_0_forms_f32",
    "subpixel_interleave_z": "v1_0_forms_f32",
    "decoder_tail_rgb_taps": "v1_0_forms_f32",
    "temporal_linear_blend": "tiled_f32"}

# the path whose serving run gives each kernel's launches and times in the
# result line
MAIN_PATH = dict.fromkeys(SOURCES, "v1_0")
MAIN_PATH.update(fused_temporal_resblock_stream="tiled", temporal_linear_blend="tiled",
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
    (tiled: with the 2 cached frames); C at every spatial upsample; the
    blend at every trilinear (v1.1) temporal upsample, keyed (x's shape,
    split, the front: ``replicate``, or ``carried`` on a later chunk, and
    the next front's rows and predecessor on a tiled chunk)."""
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
                        split = 0 if later else min(ntu, f)
                        front = "carried" if later else mode
                        nxt = ((2 * f - 2 * offs[i], f - ntu - 1 if later else f - 1)
                               if tiled else None)
                        calls["temporal_linear_blend", ((b, f, s, s, c), split, front, nxt)] += 1
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
    decoder chunks, F = A = 8E + 12D, C = 3D, D's tail D, the blend 2D, B =
    E's kernel = 0 (T=65: 100, 100, 15, 5, 10, 0, 0)."""
    per = per_forward(tiled_calls(t, size))
    n_enc, n_dec = map(len, chunk_schedule(t))
    want = dict(per, fused_temporal_resblock_stream=8 * n_enc + 12 * n_dec,
                fused_spatial_resblock=8 * n_enc + 12 * n_dec,
                subpixel_interleave=3 * n_dec, decoder_tail_rgb=n_dec,
                temporal_linear_blend=2 * n_dec,
                fused_temporal_resblock=0, parity_up2x_fused=0)
    if per != want:
        raise AssertionError(f"tiled launches {per} != formula {want}")
    return per


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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
    if name == "temporal_linear_blend":
        # x and its base convs (3C) read, 2T output frames written; a
        # carried front's 3 sums and predecessor read, the next front's 3
        # sums written; 24 FLOP a base-conv value (4 rows x 3 taps), 5 an
        # output value
        (b, t, h, w, c), _, front, nxt = key
        frame = b * h * w * c
        frames = 4 * t + 2 * t + 4 * (front == "carried") + 3 * (nxt is not None)
        return elem * frames * frame + 4 * (c + 1), 0, (24 * t + 10 * t) * frame
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


# The CLIs' two more configurations (phase 14): the v1.0 FSQ 4x8x8 262144
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


# where phases 13-17 write their files: inside the checkout, git-ignored
CKPT_DIR = "build/chip_smoke"


def phase(name: str, t0: float) -> float:
    t = time.perf_counter()
    print(f"phase {name}: {t - t0:.1f} s", flush=True)
    return t
