"""Build and load the hand-written Hopper kernels of ``vidtok_tpu_torch/csrc``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build
runs at the first kernel launch of a process, into
``build/vidtok_tpu_torch/`` beside the package, under a name that hashes
the sources and flags, so an edited source rebuilds and an unchanged one
is loaded as it is. A failed build raises. Nothing here runs at import.

Every C entry launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()`` (or, for the wgmma loop of kernels A, B, E,
F, T1 and T2 and the tail of D and D', a refused tensor map or plan);
:func:`call` raises when that is not 0.

:func:`wrapper` makes a kernel wrapper: its span ``vt.kernel.<name>``
and its counters (:func:`count_conv` those of its wgmma conv launches). :func:`operands` caches the weights of A, B, D, D', E
and F (and of B's parts, T1 and T2) as their kernels read them, per
parameter;
:func:`weight_map` encodes the tensor maps of such a weight for the wgmma
loop, which reads it as :func:`weight_layout` describes (the true channel
extents, so TMA zero-fills a partial K step or N tile).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from ...utils.profiling import span

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vidtok_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry -> argument types (pointers and the stream as void*, sizes as int)
_SIGNATURES = {
    # x, out, h1, act, g1, b1, w1 map, bias1, g2, b2, w2 map, bias2,
    # N, H, W, Cin, C, has_nin, th, tw, bn, stages, smem, grid, stream
    "vt_fused_spatial_resblock": [_P] * 12 + [_I] * 12 + [_P],
    # the same with the f32 scheme: x, out, h1, act, xs (raw x's pieces, or
    # null), g1, ... bias2, the same sizes and plan, stream
    "vt_fused_spatial_resblock_f32": [_P] * 13 + [_I] * 12 + [_P],
    # x, out, h1, act, g1, b1, w1 map, bias1, g2, b2, w2 map, bias2,
    # B, T, S, C, replicate, bn, stages, smem, grid, stream
    "vt_fused_temporal_resblock": [_P] * 12 + [_I] * 9 + [_P],
    "vt_fused_temporal_resblock_f32": [_P] * 12 + [_I] * 9 + [_P],
    # x, c1, c2, out, nc1, nc2, h1, act, g1, b1, w1 map, bias1, g2, b2,
    # w2 map, bias2, B, T, S, C, first, offset, bn, stages, smem, grid, stream
    "vt_fused_temporal_resblock_stream": [_P] * 16 + [_I] * 10 + [_P],
    "vt_fused_temporal_resblock_stream_f32": [_P] * 16 + [_I] * 10 + [_P],
    # y00, y01, y10, y11, bias, out, N, H, W, C, stream
    "vt_subpixel_interleave": [_P] * 6 + [_I] * 4 + [_P],
    "vt_subpixel_interleave_f32": [_P] * 6 + [_I] * 4 + [_P],
    # x, stats, acc (f32 scratch past 128 channels, else null), out, g, b,
    # w, bias, B, T, H, W, C, replicate, th, tw, run, stages, smem, grid,
    # stream (D; D' the same)
    "vt_decoder_tail_rgb": [_P] * 8 + [_I] * 12 + [_P],
    # x, stats (f32 scratch), out, g, b, w, bias, B, T, H, W, C, replicate,
    # th, tw, run, stages, smem, grid, stream (D in f32; D' the same)
    "vt_decoder_tail_rgb_f32": [_P] * 7 + [_I] * 12 + [_P],
    "vt_decoder_tail_rgb_taps_f32": [_P] * 7 + [_I] * 12 + [_P],
    # s, out, w map, bias, alpha, B, T, H, W, C, replicate, th, tw, bn,
    # stages, smem, grid, stream
    "vt_parity_up2x": [_P] * 5 + [_I] * 12 + [_P],
    # s, sp (s's pieces), out, w map, bias, alpha, then as vt_parity_up2x
    "vt_parity_up2x_f32": [_P] * 6 + [_I] * 12 + [_P],
    # s, ycur, yprev, bias, alpha, out, ld, B, T, S, C, replicate, stream
    "vt_parity_blend": [_P] * 6 + [_I] * 6 + [_P],
    "vt_parity_blend_f32": [_P] * 6 + [_I] * 6 + [_P],
    # z, bias, out, N, H, W, C, stream
    "vt_subpixel_interleave_z": [_P] * 3 + [_I] * 4 + [_P],
    "vt_subpixel_interleave_z_f32": [_P] * 3 + [_I] * 4 + [_P],
    "vt_decoder_tail_rgb_taps": [_P] * 8 + [_I] * 12 + [_P],
    # x, p, prev, front sums, out, next sums, bias, alpha, B, T, S, C, split,
    # front, nf, q, vec, stream
    "vt_temporal_linear_blend": [_P] * 8 + [_I] * 9 + [_P],
    "vt_temporal_linear_blend_f32": [_P] * 8 + [_I] * 9 + [_P],
    # the tools' kernels (vidtok_tpu_torch/tools):
    # x, out, B, T, S, C, tile_t, tile_s, stream
    "vt_copy_units": [_P] * 2 + [_I] * 6 + [_P],
    # x, out, h, g1, b1, w1 map, g2, b2, w2 map, B, T, S, C, mode, bn,
    # stages, smem, grid, stream
    "vt_microbench_diag": [_P] * 9 + [_I] * 9 + [_P],
    # x, out, fat, h, g1, b1, w1 map, bias1, g2, b2, w2 map, bias2, B, T, S,
    # C, bn, stages, smem, grid, stream
    "vt_microbench_fat": [_P] * 12 + [_I] * 8 + [_P],
    # x, out, n, mode, stream
    "vt_silu_probe": [_P] * 2 + [ctypes.c_longlong, _I, _P],
    # w, cin, taps, cs, pieces, cout, parities, bn, maps (2 x 128 bytes,
    # written); no stream
    "vt_weight_map": [_P] + [_I] * 7 + [_P],
}
TENSOR_MAP_BYTES = 128  # sizeof(CUtensorMap)


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_log: str       # nvcc output, including -Xptxas -v
    build_seconds: float  # 0.0 when a cached build was loaded


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    so = BUILD_DIR / f"libvidtok_kernels-{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        objs = [so.with_suffix(f".{os.getpid()}.{f.stem}.o") for f in sources]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for f, o in zip(sources, objs)]
        log = "".join(proc.communicate()[0] for proc in procs)
        bad = [f.name for f, proc in zip(sources, procs) if proc.returncode != 0]
        if not bad:
            link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            bad = ["link"] if link.returncode != 0 else []
        seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
        if bad:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({', '.join(bad)}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib, so, log, seconds)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().lib.vt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def call(name: str, *args) -> None:
    """Run C entry ``name`` on the current CUDA stream; raise on error.
    Tensors are passed as their data pointers, tensor maps (ctypes buffers)
    as their addresses."""
    import torch

    lib = library().lib
    stream = torch.cuda.current_stream().cuda_stream
    args = [a.data_ptr() if isinstance(a, torch.Tensor)
            else ctypes.addressof(a) if isinstance(a, ctypes.Array) else a
            for a in args]
    _raise_on(name, getattr(lib, name)(*args, stream))


def weight_layout(cin: int, taps: int, cs: int = 0, pieces: int = 1, cout: int = None,
                  parities: int = 1) -> tuple:
    """How the wgmma loop reads a K-major weight ``[parities * cout, pieces
    * K]``, K = taps * cin + cs: ``taps`` taps of ``cin`` channels, then a
    1x1 term's ``cs`` channels, ``pieces`` bf16 pieces side by side
    (``split.py``), ``parities`` row blocks of ``cout`` (kernel E's output
    frames). (cin, taps, cs, pieces, cout, parities)."""
    return (cin, taps, cs, pieces, cin if cout is None else cout, parities)


def weight_map(w, layout: tuple, bn: int):
    """The tensor maps (a 256-byte ctypes buffer: the taps' map, then the
    1x1 term's) of the K-major bf16 weight ``w`` read as ``layout``
    (:func:`weight_layout`) for the wgmma loop's loads of ``bn`` rows
    (``csrc/wgmma_conv.cuh``: weight_maps); raises when the CUDA driver
    refuses them."""
    cin, taps, cs, pieces, cout, parities = layout
    if tuple(w.shape) != (parities * cout, pieces * (taps * cin + cs)):
        raise ValueError(f"weight {tuple(w.shape)} is not the layout {layout}")
    buf = ctypes.create_string_buffer(2 * TENSOR_MAP_BYTES)
    _raise_on("vt_weight_map", library().lib.vt_weight_map(
        w.data_ptr(), *layout, bn, ctypes.addressof(buf)))
    return buf


def weight_maps(op: dict, bn: int, *names) -> tuple:
    """The tensor maps of the K-major weights ``op[name]`` read as
    ``op["layouts"][name]``, for loads of ``bn`` rows, encoded at the first
    call for ``bn`` and kept in ``op["maps"]`` beside them."""
    if bn not in op["maps"]:
        op["maps"][bn] = tuple(weight_map(op[n], op["layouts"][n], bn) for n in names)
    return op["maps"][bn]


_OPERANDS = None  # parameter (weakly) -> {kind: (stamp, other sources, value)}
_BUILDS = 0  # entries operands() has built, read by the wrappers' ``builds``


def wrapper(fn):
    """``fn``, a kernel wrapper, under the span ``vt.kernel.<fn's name>``
    from entry to return (plan, operands, tensor maps, allocation and
    launch), with seven counters: ``calls`` (every call), ``launches``
    (counted by ``fn`` where it launches its kernel), ``builds`` (the
    operand relayouts :func:`operands` built during its calls because no
    cached entry was served: none on a repeated call with unchanged
    parameters), ``conv_tiles`` / ``conv_blocks`` (the output tiles and
    the blocks of its wgmma conv launches, :func:`count_conv`), and
    ``base_frames`` / ``up_frames`` (the trilinear upsample's blend: the
    input frames whose base convs it read and the output frames it wrote)."""
    name = "vt.kernel." + fn.__name__

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        wrapped.calls += 1
        built = _BUILDS
        try:
            with span(name):
                return fn(*args, **kwargs)
        finally:
            wrapped.builds += _BUILDS - built

    wrapped.calls = wrapped.launches = wrapped.builds = 0
    wrapped.conv_tiles = wrapped.conv_blocks = 0
    wrapped.base_frames = wrapped.up_frames = 0
    return wrapped


def count_conv(fn, pl, launches: int = 1) -> None:
    """Count ``launches`` wgmma conv launches of plan ``pl`` on wrapper
    ``fn``: its tiles and its blocks (the plan's grid), whose ratio is the
    tiles a block walks."""
    fn.conv_tiles += launches * pl.tiles
    fn.conv_blocks += launches * pl.grid


def _stamp(t):
    return None if t is None else (id(t), t._version, t.data_ptr(), t.device,
                                   t.dtype, tuple(t.shape))


def operands(kind: str, sources: tuple, build):
    """``build(*sources)`` under ``torch.no_grad()``, cached on
    ``sources[0]`` (a parameter, held weakly) under ``kind``.

    The cache is the kernels' relayout of a block's weights (K-major bf16
    GEMM operands, f32 vectors, the tensor maps :func:`weight_maps` adds to
    the value), made once instead of at every call. An entry is
    served while every source is the same tensor at the same
    ``_version``, data pointer, device, dtype and shape; an in-place update
    under ``no_grad`` (``load_state_dict``, ``nn.init``,
    ``state_dict_from_jax`` loaded into the module), ``.to()`` or a new
    tensor rebuilds it. A write through ``param.data`` is outside PyTorch's
    version counter and is not seen: call :func:`clear_operands` after one.
    ``None`` sources stand for absent parameters."""
    import torch

    global _OPERANDS, _BUILDS
    if _OPERANDS is None:
        from torch.utils.weak import WeakIdKeyDictionary

        _OPERANDS = WeakIdKeyDictionary()
    stamp = tuple(map(_stamp, sources))
    per = _OPERANDS.setdefault(sources[0], {})
    hit = per.get(kind)
    if hit is not None and hit[0] == stamp:
        return hit[2]
    with torch.no_grad():
        value = build(*sources)
    _BUILDS += 1
    # the other sources are held so that their ids stay theirs
    per[kind] = (stamp, sources[1:], value)
    return value


def clear_operands() -> None:
    """Drop every cached operand."""
    if _OPERANDS is not None:
        _OPERANDS.clear()


def f32(t):
    """A parameter as the contiguous f32 vector a kernel reads."""
    return t.float().contiguous()


def kernel_dtype(x, kernel: str):
    """x's dtype where the kernels take it (bf16, or f32 under the f32
    scheme); else raise, naming ``kernel``."""
    import torch

    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel {kernel} takes bf16 or f32 activations, got {x.dtype}")
    return x.dtype


def require(x, dtype, shape) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if x.dtype != dtype:
        raise ValueError(f"kernel input must be {dtype}, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"kernel input must be a CUDA tensor, got {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"kernel input shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")


def same_device(t, x) -> None:
    if t.device != x.device:
        raise ValueError(f"parameter on {t.device}, input on {x.device}")
