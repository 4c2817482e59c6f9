"""Phase 14 of the card gate: the CLIs (``vidtok_tpu_torch/scripts``)
through the compute functions their mains call, in bf16 on seeded frames
(``cli_clip``), files under CKPT_DIR (``serve_clis``): (a)
``inference_evaluate``, the slice's main path (``cli_evaluate``,
``cli_metric_gates``); (b) ``--read_long_video`` (``cli_long_video``); (c)
``inference_reconstruct --pad_gen_frames`` (``cli_reconstruct``); (d)
``stream_tokens`` (``cli_stream``); (e) one evaluate window of the v1.0
FSQ 262144 model (``cli_fsq_262144``); (f) each CLI as a subprocess on an
mp4 where OpenCV and PyYAML import, else a line saying which is missing
(``cli_subprocesses``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from chip_smoke import (CKPT_DIR, FSQ_262144_CFG, FSQ_32768_V1_1_CFG, PER_FORWARD, SOURCES,
                        TILED_REQUEST, T_CHUNK_ENC, V1_0_CFG, V1_1_CFG, phase, rel_l2,
                        tiled_per_forward)
from chip_smoke.kernels import cuda_ms
from chip_smoke.serving import make_tokenizer

# The CLIs (phase 14, ``vidtok_tpu_torch/scripts``), each driven through
# the compute function its ``main`` calls, on frames made here (no video
# backend is needed): two clips of CLI_FRAMES frames at CLI_FPS, decoded
# size CLI_SIZE, which the CLIs' transform resizes to 256 x 455 and crops
# to 256², windows of 17 frames (three a clip); one clip of
# TILED_REQUEST's 65 frames for ``--read_long_video`` and for
# ``stream_tokens``.
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
    the CPU on the same tensors. Returns (the tokenizer, the LPIPS module,
    the first clip)."""
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
