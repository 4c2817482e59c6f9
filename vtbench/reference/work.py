"""What the work of a request is, counted from the configuration's shapes.

* :func:`kernel_calls`: the port's kernel calls of one request, by
  (kernel, call key): a frozen copy of ``chip_smoke.model_calls`` (the walk
  of the encoder and decoder, or the tiled schedule), with the encoder
  stream's single chunk added.
* :func:`work`: the bytes and FLOP each call's *function* needs (each input
  read once, each output written once; kernel E counted as the three base
  convs of each input frame, 27 C^2 MACs a position, not its own 36 C^2):
  a frozen copy of ``chip_smoke.work``.
* :func:`least_seconds`: the least time of a set of calls on the chip, each
  call the larger of its bytes over the HBM rate and its FLOP over the
  peak rate of their type (``PEAKS``, NVIDIA's data sheet for one H100
  SXM at 700 W, dense).
* :func:`model_flops`: the FLOP of the model's function for one request,
  counted by ``torch.utils.flop_counter`` over the plain reference on the
  meta device (every convolution and matrix product), with the upsamples'
  convs counted as their function needs them (``FUNCTION_SHARE``), as
  :func:`work` counts kernel E.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

import torch

from . import model as R

# one H100 SXM at 700 W (NVIDIA's data sheet), dense rates
PEAKS = {"bf16_tensor_flops": 989e12, "f32_vector_flops": 67e12, "hbm_bytes": 3.35e12}


def chunk_schedule(t: int, tdf: int = 4, t_chunk_enc: int = 16):
    """A tiled, overlapped forward of ``t`` frames: frames per encoder chunk
    (the first is frame 0 padded to ``tdf``) and latent frames per decoder
    chunk (one look-ahead frame on each but the last)."""
    enc = [tdf] + [e - s for s, e in R.chunk_bounds(t, t_chunk_enc)[1:]]
    t_lat = sum(f // tdf for f in enc)
    dec = [e - s + (e + 1 <= t_lat) for s, e in R.chunk_bounds(t_lat, t_chunk_enc // tdf)]
    return enc, dec


def kernel_calls(config: dict, shape, entry: str = "forward", first: bool = True,
                 t_chunk_enc: int = 16) -> Counter:
    """Kernel calls of one request of ``shape`` [B, 3, T, H, W] through the
    causal layernorm model of ``config`` with the kernels on. ``entry``:
    ``forward`` (non-tiled: B at every temporal resblock, key (shape,
    mode)), ``forward_tiled`` (the overlapped chunk loop: F, key (shape,
    first_chunk, offset)) or ``encode_chunk`` (one encoder chunk of T
    frames, the stream's first when ``first``). A at every spatial
    resblock (N, H, W, Cin, C), E (v1.0) at every temporal upsample, C at
    every spatial upsample, D on the decoder's last activations (tiled:
    with the 2 cached frames)."""
    spec = R.spec_of(config)
    mode = "replicate" if spec.variant == "v1_1" else "zero"
    ch, mult, nrb, tdf = spec.ch, spec.ch_mult, spec.num_res_blocks, spec.tdf
    n = len(mult)
    b, _, t, size, _ = shape
    stream = entry != "forward"
    calls = Counter()

    def temporal(f, s, c, first_chunk, off):
        x = (b, f, s, s, c)
        if stream:
            calls["fused_temporal_resblock_stream", (x, first_chunk, off)] += 1
        else:
            calls["fused_temporal_resblock", (x, mode)] += 1

    def encode(f, first_chunk):
        s, c = size, ch
        for i in range(n):
            for _ in range(nrb):
                calls["fused_spatial_resblock", (b * f, s, s, c, ch * mult[i])] += 1
                c = ch * mult[i]
                temporal(f, s, c, first_chunk, 0)
            if i in spec.spatial_ds:
                s //= 2
                f //= 2 if i in spec.tempo_ds else 1
        return f, s

    def decode(f, s, first_chunk):
        c, cur, offs = ch * mult[-1], 1, {}
        for i in reversed(range(n)):
            offs[i] = cur
            cur *= 2 if i in spec.tempo_us else 1
        for i in reversed(range(n)):
            for _ in range(nrb + 1):
                calls["fused_spatial_resblock", (b * f, s, s, c, ch * mult[i])] += 1
                c = ch * mult[i]
                temporal(f, s, c, first_chunk, offs[i])
            if i in spec.spatial_us:
                calls["subpixel_interleave", (b * f, s, s, c)] += 1
                s *= 2
                if i in spec.tempo_us:
                    if spec.variant == "v1_0":
                        calls["parity_up2x_fused", ((b, f, s, s, c), mode)] += 1
                    f *= 2
        frames = f + 2 if stream else f
        calls["decoder_tail_rgb", ((b, frames, s, s, c), mode)] += 1

    if entry == "encode_chunk":
        if first:
            t = -(-t // tdf) * tdf
        encode(t, first)
        return calls
    if entry == "forward":
        if spec.variant == "v1_0" and t % tdf:
            t += tdf - 1
        elif spec.variant == "v1_1":
            t = -(-t // tdf) * tdf
        decode(*encode(t, True), True)
        return calls
    if entry != "forward_tiled":
        raise ValueError(f"unknown entry {entry!r}")
    enc, dec = chunk_schedule(t, tdf, t_chunk_enc)
    lat = [encode(f, i == 0) for i, f in enumerate(enc)][0][1]
    for i, f in enumerate(dec):
        decode(f, lat, i == 0)
    return calls


def launches(calls: Counter) -> Counter:
    """Calls per kernel."""
    per = Counter()
    for (name, _), k in calls.items():
        per[name] += k
    return per


def _nel(*shapes) -> int:
    out = 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        out += n
    return out


def work(name: str, key, elem: int = 2) -> tuple:
    """(bytes, tensor-core FLOP, other FLOP) one call must move and do:
    each input read once, each output written once, in ``elem``-byte
    elements, the f32 parameters read once; the FLOP of the function (E:
    the three base 3x3 convs of each input frame, 27 C^2 MACs per
    half-rate position; D: the 3-channel conv)."""
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
        n, h, w, c = key
        return elem * 8 * n * h * w * c + 4 * c, 0, 4 * n * h * w * c
    if name in ("parity_blend_interleave", "parity_blend_interleave4"):
        b, t, h, w, c = key[0]
        m = b * t * h * w
        return elem * 7 * m * c + 4 * (c + 1), 0, 5 * 2 * m * c
    if name in ("decoder_tail_rgb", "decoder_tail_rgb_taps"):
        b, t, h, w, c = key[0]
        m = b * t * h * w
        return elem * m * (c + 3) + 4 * (2 * c + 81 * c + 3), 2 * m * 81 * c, 0
    if name == "parity_up2x_fused":
        b, t, h, w, c = key[0]
        m = b * t * h * w
        return elem * 3 * m * c + 4 * (27 * c * c + c + 1), 2 * m * 27 * c * c, 0
    raise ValueError(f"no work model for kernel {name!r}")


def least_seconds(calls: Counter, elem: int = 2) -> float:
    """The least time of ``calls`` on one H100: per call the larger of its
    bytes over the HBM rate and its FLOP over the rate of their type."""
    total = 0.0
    for (name, key), k in calls.items():
        nbytes, mma, vec = work(name, key, elem)
        t_ops = mma / PEAKS["bf16_tensor_flops"] + vec / PEAKS["f32_vector_flops"]
        total += k * max(nbytes / PEAKS["hbm_bytes"], t_ops)
    return total


# The share of an upsample's counted FLOP that its function needs. The
# reference convolves the doubled tensor, as the published model does: a
# spatial upsample's 3x3 conv on the nearest-doubled frame is four 2x2
# convs of the input frame, one for each output parity (4/9 of it); a
# temporal upsample's causal 3-frame conv on the doubled (nearest or
# linear) frames is a blend of the three base convs of each input frame
# (1/2 of it), as kernel E computes it.
FUNCTION_SHARE = {"spatial_up": 4 / 9, "time_up": 1 / 2}


@contextmanager
def _function_flops(counted: dict):
    """Count each upsample of the reference apart: ``counted[name]`` gets
    the FLOP its calls were counted at."""
    from torch.utils.flop_counter import FlopCounterMode

    saved = {name: getattr(R, name) for name in FUNCTION_SHARE}

    def apart(name, fn):
        def run(*args, **kwargs):
            with FlopCounterMode(display=False) as c:
                out = fn(*args, **kwargs)
            counted[name] = counted.get(name, 0) + c.get_total_flops()
            return out
        return run

    try:
        for name, fn in saved.items():
            setattr(R, name, apart(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(R, name, fn)


def model_flops(config: dict, shape, entry: str = "forward", first: bool = True,
                t_chunk_enc: int = 16) -> float:
    """FLOP of the model's function for one request (see the module
    docstring), counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = R.spec_of(config)
    params = {k: torch.empty(s, device="meta") for k, s in R.param_shapes(spec).items()}
    ctx = R.Ctx(params, spec)
    x = torch.empty(shape, device="meta")
    old = None
    if entry == "encode_chunk" and not first:  # the cache of a first chunk
        _, old = R.encode_chunk(ctx, x[:, :, :1], None)
    counted = {}
    with _function_flops(counted), FlopCounterMode(display=False) as counter:
        if entry == "forward":
            R.forward(ctx, x)
        elif entry == "forward_tiled":
            R.forward_tiled(ctx, x, t_chunk_enc)
        elif entry == "encode_chunk":
            R.encode_chunk(ctx, x, old)
        else:
            raise ValueError(f"unknown entry {entry!r}")
    total = counter.get_total_flops()
    for name, flops in counted.items():
        total -= (1 - FUNCTION_SHARE[name]) * flops
    return float(total)
