"""Training CLI (``scripts/train.py``; the reference's ``main.py``).

    python -m vidtok_tpu_torch.scripts.train -b configs/vidtok_kl_causal_488_4chn.yaml \\
        [--logdir logs] [--name run1] [--resume] [--max_steps N] \\
        [--device cuda|cpu] [nested.key=value ...]

Configs merge left to right, then the ``key=value`` overrides; the run
directory is ``<logdir>/<timestamp>_<name>`` (``--resume`` takes the newest
one ending in the name and its newest checkpoint, ``--resume_from_checkpoint``
a file; the restored step is the truth). Every ``training.log_every`` (50)
steps the logs go to ``metrics.jsonl`` (and TensorBoard / wandb where they
import); images,
checkpoints and validation (PSNR, SSIM, ``val/rec_loss`` on the training
weights and their EMA, through the serving engine) at their intervals;
SIGUSR1 or an exception writes a checkpoint. Several processes under
``torchrun`` train data-parallel, each on its own data seed.
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import time

import numpy as np
import torch

from ..config import merge_configs


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="+", required=True,
                   help="config yaml(s), merged left to right")
    p.add_argument("-l", "--logdir", default="logs")
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-r", "--resume", action="store_true")
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--val_every", type=int, default=None)
    p.add_argument("--ckpt_every", type=int, default=None)
    p.add_argument("--scale_lr", action="store_true",
                   help="lr = processes * batch_size * base_lr (reference main.py:1025-1031)")
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of steps 10-13")
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="a train-state file to resume from")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_project", default="vidtok_tpu")
    p.add_argument("--device", default="cuda",
                   help="where the model trains (cpu for a machine without a card)")
    p.add_argument("--full_pickle", action="store_true",
                   help="load a torch ckpt_path with its full pickle (runs code "
                        "from the file: only for a file you trust)")
    return p


def _run_dir(args, name: str) -> str:
    if args.resume and os.path.isdir(args.logdir):
        runs = sorted(d for d in os.listdir(args.logdir) if d.endswith(name))
        if runs:
            return os.path.join(args.logdir, runs[-1])
    stamp = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    return os.path.join(args.logdir, f"{stamp}_{name}")


def main(argv=None):
    args, unknown = get_parser().parse_known_args(argv)
    from ..data.pipeline import device_prefetch, upload
    from ..parallel.distributed import init_distributed, is_main_process, rank, world_size
    from ..registry import instantiate_from_config
    from ..train.trainer import VidTokTrainer
    from ..utils.checkpoint import latest_checkpoint, restore_train_state, save_train_state
    from ..utils.logging import ImageVideoLogger, MetricLogger

    cfg = merge_configs(*args.base, dotlist=[a for a in unknown if "=" in a])
    tcfg = cfg.get("training", {}) or {}
    max_steps = args.max_steps or tcfg.get("max_steps", 50000)
    val_every = args.val_every or tcfg.get("val_check_interval", 2000)
    ckpt_every = args.ckpt_every or tcfg.get("checkpoint_every", 5000)
    log_every = tcfg.get("log_every", 50)

    init_distributed()
    device = torch.device(args.device)
    if device.type == "cuda" and world_size() > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    main_proc = is_main_process()
    name = args.name or os.path.splitext(os.path.basename(args.base[0]))[0]
    rundir = _run_dir(args, name)
    ckptdir = os.path.join(rundir, "checkpoints")
    os.makedirs(ckptdir, exist_ok=True)

    trainer = VidTokTrainer(cfg, device=device, lpips_weights=args.lpips_weights,
                            seed=args.seed, full_pickle=args.full_pickle)
    if not trainer.lpips_pretrained:
        print("[train] WARNING: no converted LPIPS weights found: the perceptual "
              "loss uses random VGG features (tools/convert_lpips.py).")
    # per-process data seed (reference SetupCallback, main.py:331-338)
    cfg.setdefault("data", {}).setdefault("params", {})["seed"] = args.seed + 1000 * rank()
    data = instantiate_from_config(cfg["data"]).setup()
    train_loader = data.train_dataloader()
    val_loader = data.val_dataloader()
    trainer.init_state()
    if args.scale_lr:
        trainer.set_lr(world_size() * data.batch_size * trainer.lr)
        print(f"[train] scaled lr to {trainer.lr}")

    path = args.resume_from_checkpoint or latest_checkpoint(ckptdir)[0]
    if path is not None:
        print(f"[train] resuming from {path}")
        restore_train_state(path, trainer)

    wandb_id_file = os.path.join(rundir, "wandb_id.txt")
    wandb_run_id = None
    if (args.resume or args.resume_from_checkpoint) and os.path.exists(wandb_id_file):
        with open(wandb_id_file) as f:
            wandb_run_id = f.read().strip() or None
    metrics = MetricLogger(rundir, use_tensorboard=main_proc,
                           wandb_project=args.wandb_project if args.wandb and main_proc else None,
                           wandb_run_id=wandb_run_id)
    if metrics.wandb_run_id:
        with open(wandb_id_file, "w") as f:
            f.write(metrics.wandb_run_id)
    images = ImageVideoLogger(rundir, batch_frequency=tcfg.get("log_images_every", 5000),
                              disabled=not main_proc)

    def save(step, monitor_value=None):
        if main_proc:
            p = save_train_state(ckptdir, trainer, step, monitor_value=monitor_value)
            print(f"[train] checkpoint -> {p}")

    def melk(*_):
        save(trainer.step)

    try:
        signal.signal(signal.SIGUSR1, melk)
    except (ValueError, OSError, AttributeError):
        pass

    gstep = start = trainer.step
    print(f"[train] run dir {rundir}; {len(train_loader)} batches/epoch; "
          f"{world_size()} process(es); start step {gstep}")
    prof = None
    t0 = time.time()
    epoch = 0
    try:
        while gstep < max_steps:
            for batch in device_prefetch(train_loader.epoch(epoch),
                                         lambda b: upload(b, device)):
                if args.profile and gstep == start + 10:
                    prof = torch.profiler.profile(record_shapes=False)
                    prof.__enter__()
                logs = trainer.fit_step(batch["jpg"])
                gstep = trainer.step
                if prof is not None and gstep >= start + 14:
                    prof.__exit__(None, None, None)
                    if main_proc:
                        prof.export_chrome_trace(os.path.join(rundir, "trace.json"))
                    prof = None
                if gstep % log_every == 0:
                    logs = {k: float(v) for k, v in logs.items()}
                    dt = (time.time() - t0) / log_every
                    t0 = time.time()
                    if main_proc:
                        metrics.log_scalars(gstep, {**logs, "perf/sec_per_step": dt})
                    print(f"step {gstep}: aeloss={logs['train/aeloss']:.3f} "
                          f"discloss={logs['train/discloss']:.3f} ({dt:.2f}s/step)")
                if images.should_log(gstep):
                    x = batch["jpg"][: images.max_samples]
                    with torch.no_grad():
                        xrec = trainer.tokenizer()(x.permute(0, 4, 1, 2, 3))[1]
                    trainer.core.train()
                    images.log(gstep, x.float().cpu().numpy(),
                               xrec.permute(0, 2, 3, 4, 1).cpu().numpy())
                if gstep % ckpt_every == 0 or gstep >= max_steps:
                    save(gstep)
                if val_every and gstep % val_every == 0 and val_loader is not None:
                    monitor = validate(trainer, val_loader, metrics if main_proc else None, gstep)
                    if monitor is not None and trainer.meta.get("monitor"):
                        save(gstep, monitor_value=monitor)
                if gstep >= max_steps:
                    break
            epoch += 1
    except Exception:
        melk()
        raise
    metrics.close()
    print("[train] done")


def validate(trainer, val_loader, metrics, gstep: int, max_batches: int = 8):
    """PSNR, SSIM and ``val/rec_loss`` (L1 + perceptual, the monitor) of at
    most ``max_batches`` validation batches, on the training weights and
    on their EMA (reference ``ema_scope`` validation,
    autoencoder.py:300-341), through the serving engine (on the card in
    bf16 with the kernels, where JAX validates unfused). Returns the
    training weights' ``val/rec_loss``."""
    monitor = None
    for postfix, ema in (("", False), ("_ema", True)):
        if ema and trainer.ema is None:
            continue
        psnr, ssim, rec = evaluate(trainer, trainer.tokenizer(ema), val_loader, max_batches)
        if psnr is None:
            continue
        if not ema:
            monitor = rec
        if metrics is not None:
            metrics.log_scalars(gstep, {f"val{postfix}/psnr": psnr,
                                        f"val{postfix}/ssim": ssim,
                                        f"val{postfix}/rec_loss": rec})
        print(f"[val{postfix}] step {gstep}: PSNR {psnr:.3f} SSIM {ssim:.4f} "
              f"rec_loss {rec:.4f}")
    trainer.core.train()
    return monitor


@torch.no_grad()
def evaluate(trainer, tok, val_loader, max_batches: int):
    """(mean PSNR, mean SSIM, mean val/rec_loss) of ``tok`` over the first
    ``max_batches`` batches, or Nones when there are none."""
    from ..ops.metrics import compute_psnr, compute_ssim
    from ..train.losses import fold_frames, perceptual_loss

    psnrs, ssims, recs = [], [], []
    for i, batch in enumerate(val_loader.epoch(0)):
        if i >= max_batches:
            break
        x = batch["jpg"].to(trainer.device, torch.float32)            # [B, T, H, W, C]
        xrec = tok(x.permute(0, 4, 1, 2, 3))[1].permute(0, 2, 3, 4, 1)
        rec = (fold_frames(x) - fold_frames(xrec)).abs()
        if trainer.loss_cfg.perceptual_weight > 0:
            rec = rec + trainer.loss_cfg.perceptual_weight * perceptual_loss(
                trainer.lpips, fold_frames(x), fold_frames(xrec),
                trainer.loss_cfg._replace(lpips_remat=False))
        recs.append(float(rec.mean()))
        a = ((x + 1) / 2).permute(0, 4, 1, 2, 3)
        b = ((xrec.clamp(-1, 1) + 1) / 2).permute(0, 4, 1, 2, 3)
        psnrs.append(float(compute_psnr(a, b)))
        ssims.append(float(compute_ssim(a, b)))
    if not psnrs:
        return None, None, None
    return float(np.mean(psnrs)), float(np.mean(ssims)), float(np.mean(recs))


if __name__ == "__main__":
    main()
