"""What the work of a kernel call is, and the chip's peaks: shared by every
reference module.

* :func:`work`: the bytes and FLOP each call's *function* needs (each input
  read once, each output written once; kernel E counted as the three base
  convs of each input frame, 27 C^2 MACs a position, not its own 36 C^2):
  a frozen copy of ``chip_smoke.work``.
* :func:`least_seconds`: the least time of a set of calls on the chip, each
  call the larger of its bytes over the HBM rate and its FLOP over the
  peak rate of their type (``PEAKS``, NVIDIA's data sheet for one H100
  SXM at 700 W, dense).
* :func:`launches`: calls per kernel.
* :func:`chunk_bounds`, :func:`chunk_schedule`: the engine's chunks of a
  stream and of a tiled, overlapped forward.

A reference module's ``kernel_calls`` gives the calls of one request, by
(kernel, call key), as the functions here key them.
"""

from __future__ import annotations

from collections import Counter

# one H100 SXM at 700 W (NVIDIA's data sheet), dense rates
PEAKS = {"bf16_tensor_flops": 989e12, "f32_vector_flops": 67e12, "hbm_bytes": 3.35e12}


def chunk_bounds(n: int, size: int):
    """[(0, 1), (1, 1 + size), ...]: the first frame alone, then ``size``
    frames at a time."""
    out = [(0, 1)]
    while out[-1][1] < n:
        out.append((out[-1][1], min(n, out[-1][1] + size)))
    return out


def chunk_schedule(t: int, time_factor: int = 4, t_chunk_enc: int = 16):
    """A tiled, overlapped forward of ``t`` frames: frames per encoder chunk
    (the first is frame 0 padded to ``time_factor``) and latent frames per
    decoder chunk (one look-ahead frame on each but the last)."""
    enc = [time_factor] + [e - s for s, e in chunk_bounds(t, t_chunk_enc)[1:]]
    t_lat = sum(f // time_factor for f in enc)
    dec = [e - s + (e + 1 <= t_lat)
           for s, e in chunk_bounds(t_lat, t_chunk_enc // time_factor)]
    return enc, dec


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
    half-rate position; D: the 3-channel conv; J and K: 4 and 5 FLOP a
    value)."""
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
    if name == "temporal_linear_up2x":
        # x read, [front | up] written (2T + 2 frames); a later chunk reads
        # its 2 cached front frames and 1 previous frame
        (b, t, h, w, c), _, cached = key
        frame = b * h * w * c
        return elem * (t * frame + (2 * t + 2) * frame + 3 * cached * frame), 0, 8 * t * frame
    if name == "linear_blend":
        # up and y read, y written; the f32 bias and blend factor
        m = _nel(key)
        return elem * 3 * m + 4 * (key[-1] + 1), 0, 5 * m
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
