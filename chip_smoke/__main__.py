"""``python3 -m chip_smoke [--kernels NAME[,NAME...]]``: the card gate's
phases in order, then its two result lines (see the package's
docstring)."""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

from chip_smoke import (CONFIG_PATHS, F32_KERNELS, F32_MAIN_PATH, MAIN_PATH, NONCAUSAL_CFG,
                        NONCAUSAL_FSQ_CFG, SOURCES, TOOL_SOURCES, V1_0_CFG, V1_1_CFG, phase)
from chip_smoke.clis import serve_clis
from chip_smoke.kernels import (build, check_kernels, check_parity_long, check_spatial_long,
                                check_tail_long, compare_forms)
from chip_smoke.serving import (check_fsq, check_fsq_262144, checkpoint_round_trip,
                                make_tokenizer, serve_444, serve_both_paths, serve_f32,
                                serve_forms, serve_fsq_options, serve_long_clip,
                                serve_public_surface, serve_tiled, serve_tiled_888,
                                serve_widths)
from chip_smoke.sharding import serve_ladder_and_sharding
from chip_smoke.tool_kernels import check_tools, run_tools, tool_entry
from chip_smoke.training import serve_training
from chip_smoke.vidtwin import serve_vidtwin


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
            print(f"usage: python3 -m chip_smoke [--kernels NAME[,NAME...]], names from "
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
    build()
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
