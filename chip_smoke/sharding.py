"""Phase 17b-c of the card gate (``serve_ladder_and_sharding`` runs 17a,
VidTwin's ablation ladder, before them): (b) the H-sharded forward
(``VideoTokenizer.forward_sharded`` over ``parallel/mesh.py``) of the v1.0
flagship and the FSQ 4096 model in SHARDED_WORLD gloo processes on the one
card (NCCL refuses two ranks on one device), in f32 on the plain path and
the flagship in bf16 with kernel E on each slab, as JAX's sharded graph
takes Pallas E; (c) the profiling helpers (``utils/profiling.py``). No
launch of the sixteen kernels but (b)'s E. ``serve_sharded`` says what
is gated.
"""

from __future__ import annotations

import json
import time

import numpy as np

from chip_smoke import (BF16_SLACK, CKPT_DIR, FSQ_CFG, PER_FORWARD, SHARDED_REQUEST,
                        SHARDED_WORLD, V1_0_CFG, phase, randomize_, rel_l2)
from chip_smoke.clis import lpips_npz
from chip_smoke.serving import e2e_rule, slack
from chip_smoke.vidtwin import (ABLATION_TARGETS, VIDTWIN_REQUEST, ablation_checkpoint,
                                ablation_train, serve_ablation)

# the flagship's sharded run on the kernel path: bf16, kernel E on each slab
SHARDED_KERNEL = "v1.0 kl 4x8x8 16chn, kernel E"
# the sharded f32 run against the single-process f32 plain run (TF32 off),
# relative L2 on z and the reconstruction and relative on kl_loss: the two
# differ only where cuDNN picks another algorithm for a slab's shape
SHARDED_GATE = 1e-4
# FSQ indices of the sharded run that may differ from the single process's:
# a code whose latent lies within rounding of a level boundary flips
SHARDED_FLIP_SHARE = 1e-3


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
    e2e_rule(err, slack("sharded", "f32"), f"sharded {SHARDED_KERNEL}")
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
