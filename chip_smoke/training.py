"""Phase 15 of the card gate: training (``vidtok_tpu_torch/train``,
``serve_training``) at the recipe of the configs (``loss_config``,
``training``: bf16-mixed, activation checkpointing on) with
``disc_start`` 0 and an EMA: (a) the flagship's steps against fp32
(``train_flagship``); (b) validation of the trained weights and of their
EMA through the serving engine (``train_validation``); (c) the train state
saved and restored (``train_resume``); (d) one FSQ 4096 step
(``train_fsq``); (e) one v1.1 step (``train_v1_1``); (f) the train CLI as
a subprocess (``train_cli``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from chip_smoke import (CKPT_DIR, FSQ_CFG, PER_FORWARD, REQUEST, ROOT, V1_0_CFG, V1_1_CFG, _KL,
                        _model, phase, randomize_, rel_l2)
from chip_smoke.clis import CLI_CROP, CLI_FPS, CLI_FRAMES, cli_clip, lpips_npz
from chip_smoke.serving import e2e_bf16, e2e_gate


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
    timed steps (host clock ending in a synchronize) and the peak memory.
    Gates: finite logs, the generator, discriminator
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
    return tr, x, before


def train_validation(tr, x, before) -> None:
    """Phase 15b: validation on the trained weights and on their EMA through
    the serving engine, kernels A-E, which read weights the optimizer
    changed in place: each held by ``e2e_bf16`` (launches 20/20/3/1/2 a
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
        e2e_gate(core, tr.meta, REQUEST, e2e_bf16(REQUEST, "v1_0"))
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
    flagship = os.path.join(ROOT, "configs", "vidtok_kl_causal_488_16chn.yaml")
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
