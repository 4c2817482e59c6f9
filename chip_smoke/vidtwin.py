"""Phases 16 and 17a of the card gate: VidTwin and its ablation ladder,
no launch of the sixteen kernels.

16. VidTwin (``vidtok_tpu_torch/models/vidtwin``, ``serve_vidtwin``) at
    the full width of configs/vidtwin/vidtwin_structure_7_7_8_dynamics_7_8
    .yaml (311,518,770 parameters; VIDTWIN_CFG), seeded weights with the
    zero-initialised ones drawn too (``fill_zero_init_``): serving in bf16
    held to f32 and the CPU (``vidtwin_serve``, ``vidtwin_cpu_check``), the
    checkpoint (``vidtwin_checkpoint``), the CLIs (``vidtwin_clis``) and
    training (``vidtwin_train``);
17a. each of ABLATION_TARGETS at VIDTWIN_CFG's width with its target
    changed (the other Q-Formers at JAX's defaults): served
    (``serve_ablation``), the first's checkpoint (``ablation_checkpoint``),
    and SymDis trained (``ablation_train``); ``sharding``'s
    ``serve_ladder_and_sharding`` runs them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from chip_smoke import CKPT_DIR, N_REQUESTS, VIDTWIN_CFG, _STT, phase, rel_l2
from chip_smoke.clis import CLI_FPS, cli_clip, lpips_npz
from chip_smoke.training import (TRAIN_DISC_GAIN, TRAIN_FLOOR, TRAIN_SLACK, _finite_logs,
                                 _flat, recorded_ratios, train_clip)

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
    launch of the sixteen kernels; one request in f32
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
    memory. Gates: finite logs; the generator,
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


ABLATION_TARGETS = ("VidAutoEncoderQformer", "VidAutoEncoderQformerCompact",
                    "VidAutoEncoderQformerCompactSym", "VidAutoEncoderQformerCompactSymDis")
ABLATION_TIMED = 2            # bf16 requests after a cold one
ABLATION_TRAIN_STEPS = 3      # bf16-mixed, after one fp32 step


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
