"""The v1.1 trilinear temporal upsample on the base convs of its input frames.

``TimeUpsampleRes2x`` in trilinear mode (``modules/blocks.py``) computes
``alpha * up + (1 - alpha) * conv(up)``: ``up`` the linear 2x interpolation
of x along T (``modules/interp.temporal_linear_up2x``), its first ntu
frames apart from the rest, and the conv causal with a 2-frame front. The
chain as the module wrote it stays here as the reference:
:func:`temporal_linear_up2x_plain` builds the conv's fronted input ``full =
[front (2) | up (2T)]`` and :func:`linear_blend_plain` blends the conv's
output.

A spatial conv commutes with the interpolation: each up frame is ``a x[p] +
b x[q]``, so the conv of the doubled frames is a blend of the three per-tap
3x3 convs ``P_k = W_k * x`` of each INPUT frame. With ``fused``,
:func:`temporal_linear_upsample` runs cuDNN's (1,3,3) conv with the taps
stacked on the output channels (``P = [W_0 x | W_1 x | W_2 x]``, half the
FLOP of the conv on the doubled frames) and :func:`temporal_linear_blend`
(CUDA: ``csrc/temporal_linear.cu``, ``linear_blend_kernel``) writes the
output from P and x in one pass. It replaces no TPU kernel (XLA fuses the
JAX module's chain). P holds 3C a frame, 1.5x the doubled frames' bytes; in
the tiled benchmark cell the upsample is still not where the peak memory is
reached (a spatial resblock of the next level is).

A stream's later chunk reads what the blend needs of the frames before it:
its predecessor frame (``prev``) and the front sums ``R [B, 3, H, W, C]``,
what those frames add to the conv of y[0], y[1] and y[2] (``W_0 f0 + W_1 f1
+ 0.25 W_2 xp``, ``W_0 f1 + 0.25 W_1 xp``, ``0.25 W_0 xp``; f0 and f1 the
front frames, xp ``prev``); the blend writes the next chunk's sums.
"""

from __future__ import annotations

import torch

from ...modules import interp
from . import _lib

FRONTS = ("zero", "replicate")  # the front modes besides carried sums
_FRONT_CODE = {"zero": 0, "replicate": 1}  # csrc/temporal_linear.cu TemporalFront
_FRONT_CARRIED = 2


def temporal_linear_up2x_plain(x, split: int, prev=None, front="replicate"):
    """The chain's interpolation: the segments ``x[:, :split]`` and ``x[:,
    split:]`` interpolated apart (``interp.temporal_linear_up2x`` of each,
    concatenated), frame 0's predecessor the last frame of ``prev`` ``[B, n,
    H, W, C]`` when given, then the conv's front prepended: ``front`` a
    cached ``[B, 2, H, W, C]`` tensor, ``zero`` or ``replicate`` (up-frame
    0 twice). -> ``[B, 2 + 2T, H, W, C]``."""
    t = x.shape[1]
    split = min(max(split, 0), t)
    ups = []
    for s, e in ((0, split), (split, t)):
        seg = x[:, s:e]
        if seg.shape[1] == 0:
            continue
        if s == 0 and prev is not None:
            ups.append(interp.temporal_linear_up2x(
                torch.cat([prev[:, -1:].to(x.dtype), seg], dim=1))[:, 2:])
        else:
            ups.append(interp.temporal_linear_up2x(seg))
    up = torch.cat(ups, dim=1)
    if isinstance(front, torch.Tensor):
        head = front.to(x.dtype)
    elif front == "replicate":
        head = up[:, :1].expand(-1, 2, *up.shape[2:])
    else:
        head = up.new_zeros((up.shape[0], 2) + tuple(up.shape[2:]))
    return torch.cat([head, up], dim=1)


def linear_blend_plain(full, y, bias, alpha):
    """The chain's blend: ``alpha * up + (1 - alpha) * (y + bias)`` in y's
    dtype, ``up`` the last ``y.shape[1]`` frames of ``full``, y the conv's
    output without its bias; ``alpha`` a one-element tensor, ``bias``
    ``[C]``."""
    a = alpha.to(y.dtype)
    up = full[:, full.shape[1] - y.shape[1]:]
    return a * up + (1 - a) * (y + bias.to(y.dtype))


def up_rows(t: int, split: int, prev: bool, front: str) -> torch.Tensor:
    """``[2 + 2t, t]`` f32: row m holds the coefficients of x's frames in
    frame m of ``full = [front | up]`` (the kernel's ``up_coef``): up[2i] =
    0.25 prev(i) + 0.75 x[i], up[2i+1] = 0.75 x[i] + 0.25 next(i), prev(i)
    and next(i) within the segments [0, split) and [split, t), the frame
    itself at a segment's edge; up-frame 0's predecessor is ``prev`` (no
    frame of x) when given; the front rows are up-frame 0's (``replicate``)
    or 0 (``zero``, ``carried`` sums)."""
    split = min(max(split, 0), t)
    rows = [[0.0] * t for _ in range(2 + 2 * t)]
    for i in range(t):
        edge = not prev if i == 0 else i == split
        terms = [(2, i, 0.75), (3, i, 0.75),
                 (3, i if i == t - 1 or i + 1 == split else i + 1, 0.25)]
        if edge or i > 0:  # up-frame 0's 0.25 of ``prev`` is no frame of x
            terms.append((2, i if edge else i - 1, 0.25))
        for r, j, c in terms:
            rows[r + 2 * i][j] += c
    if front == "replicate":
        rows[0] = rows[1] = rows[2]
    return torch.tensor(rows, dtype=torch.float32).reshape(2 + 2 * t, t)


def _vectors(c: int, dt, *tensors) -> int:
    """1 when 16-byte vectors cover C and every pointer is 16-byte aligned."""
    per = 16 // (2 if dt == torch.bfloat16 else 4)
    return int(c % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check(x, p, prev, front, next_front) -> None:
    """Raise on what the blend does not take (CPU and CUDA alike)."""
    b, t, h, w, c = x.shape
    if t == 0:
        raise ValueError("the blend needs at least one frame")
    carried = isinstance(front, torch.Tensor)
    if not carried and front not in FRONTS:
        raise ValueError(f"unknown front {front!r}; carried sums or one of {FRONTS}")
    if prev is not None and not carried:
        raise ValueError("a predecessor frame needs the carried front sums that hold its "
                         "share of the conv")
    for name, v, shape in (("p", p, (b, t, h, w, 3 * c)), ("prev", prev, (b, 1, h, w, c)),
                           ("front", front if carried else None, (b, 3, h, w, c))):
        if v is None:
            continue
        if v.dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype}, got {v.dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} shape {tuple(v.shape)} != {shape}")
    if next_front is not None:
        nf, q = next_front
        if not 0 <= nf <= 2 * t or not -1 <= q < t or (q < 0 and prev is None):
            raise ValueError(f"next front rows {nf} or predecessor {q} outside the chunk")


def temporal_linear_blend_plain(x, p, bias, alpha, split: int, prev=None, front="replicate",
                                next_front=None):
    """Plain PyTorch form of :func:`temporal_linear_blend`, in f32, rounded
    once to x's dtype."""
    b, t, h, w, c = x.shape
    split = min(max(split, 0), t)
    carried = isinstance(front, torch.Tensor)
    rows = up_rows(t, split, prev is not None, "carried" if carried else front).to(x.device)
    taps = [p[..., k * c:(k + 1) * c].float() for k in range(3)]

    def mix(row, k):  # sum_j row[j] * P_k[j]
        return torch.einsum("...j,bjhwc->b...hwc", row, taps[k])

    conv = sum(mix(rows[k:k + 2 * t], k) for k in range(3))
    sums = front.float() if carried else None
    if carried:
        conv[:, :3] += sums[:, :min(3, 2 * t)]
    xp = None if prev is None else prev.float()
    up = temporal_linear_up2x_plain(x.float(), split, xp, "zero")[:, 2:]
    a = alpha.reshape(()).float()
    y = (a * up + (1 - a) * (conv + bias.float())).to(x.dtype)
    if next_front is None:
        return y, None
    nf, q = next_front
    zero = torch.zeros_like(taps[0][:, 0])
    nx = [zero, zero, zero]
    if carried and nf <= 2:
        nx = [sums[:, nf + r] if nf + r <= 2 else zero for r in range(3)]
    nx[0] = nx[0] + mix(rows[nf], 0) + mix(rows[nf + 1], 1)
    nx[1] = nx[1] + mix(rows[nf + 1], 0)
    if q >= 0:
        nx = [v + 0.25 * taps[2 - r][:, q] for r, v in enumerate(nx)]
    return y, torch.stack(nx, dim=1).to(x.dtype)


@_lib.wrapper
def temporal_linear_blend(x, p, bias, alpha, split: int, prev=None, front="replicate",
                          next_front=None):
    """The trilinear upsample's output ``[B, 2T, H, W, C]`` of x ``[B, T, H,
    W, C]`` from ``p`` ``[B, T, H, W, 3C]``, x's base convs (the three taps'
    3x3 convs side by side, no bias), and the next chunk's front sums (None
    without ``next_front``).

    ``split``: the first ntu frames are interpolated apart; ``prev`` ``[B,
    1, H, W, C]``: frame 0's predecessor (a later stream chunk); ``front``:
    ``zero``, ``replicate`` or the carried sums ``[B, 3, H, W, C]`` (needed
    with ``prev``); ``next_front`` ``(nf, q)``: the next chunk's front is
    rows nf and nf + 1 of ``full`` and its predecessor frame q (-1:
    ``prev``, whose share the sums leave out unless nf is 0, where they pass
    the carried sums on). ``bias`` ``[C]`` and ``alpha`` (one element, read
    on the device) in f32. A CPU tensor runs
    :func:`temporal_linear_blend_plain`; a CUDA tensor (contiguous bf16 or
    f32) runs the kernel or raises. Counts ``base_frames`` (T) and
    ``up_frames`` (2T)."""
    _check(x, p, prev, front, next_front)
    b, t, h, w, c = x.shape
    _COUNTED.base_frames += t
    _COUNTED.up_frames += 2 * t
    if x.device.type == "cpu":
        return temporal_linear_blend_plain(x, p, bias, alpha, split, prev, front, next_front)
    dt = _lib.kernel_dtype(x, "temporal_linear_blend")
    carried = isinstance(front, torch.Tensor)
    given = [v for v in (x, p, prev, front if carried else None) if v is not None]
    for v in given:
        _lib.require(v, dt, v.shape)
    bias, alpha = _lib.f32(bias), _lib.f32(alpha.reshape(1))
    for v in (bias, alpha):
        _lib.same_device(v, x)
    out = x.new_empty((b, 2 * t, h, w, c))
    sums = None if next_front is None else x.new_empty((b, 3, h, w, c))
    nf, q = (0, -1) if next_front is None else next_front
    _lib.call("vt_temporal_linear_blend" + ("_f32" if dt == torch.float32 else ""), x, p,
              prev, front if carried else None, out, sums, bias, alpha, b, t, h * w, c,
              min(max(split, 0), t), _FRONT_CARRIED if carried else _FRONT_CODE[front], nf, q,
              _vectors(c, dt, out, *given, *([] if sums is None else [sums])))
    _COUNTED.launches += 1
    return out, sums


_COUNTED = temporal_linear_blend  # the wrapper its body counts on, however it is looked up


def front_sums(frames, prev, weight):
    """The carried front sums ``[B, 3, H, W, C]`` (f32) of the front frames
    ``frames`` ``[B, 2, H, W, C]`` and the predecessor frame ``prev`` ``[B, 1,
    H, W, C]`` (or None) under the 3x3x3 conv ``weight``: ``W_0 f0 + W_1 f1
    + 0.25 W_2 xp``, ``W_0 f1 + 0.25 W_1 xp``, ``0.25 W_0 xp``, each ``W_k``
    the tap's 3x3 conv, zero padded, no bias. Plain PyTorch in f32: what a
    stream's fused chunk carries where the plain one caches those frames."""
    w = weight.float()
    f = frames.float()

    def conv(v, k):  # [B, H, W, C] under tap k
        y = torch.nn.functional.conv2d(v.permute(0, 3, 1, 2), w[:, :, k], None, 1, 1)
        return y.permute(0, 2, 3, 1)

    xp = prev.float()[:, 0] if prev is not None else None
    share = [0.25 * conv(xp, k) if xp is not None else 0 for k in range(3)]
    return torch.stack([conv(f[:, 0], 0) + conv(f[:, 1], 1) + share[2],
                        conv(f[:, 1], 0) + share[1],
                        share[0] + torch.zeros_like(f[:, 0])], dim=1)


def temporal_linear_upsample(x, base_conv, bias, alpha, split: int, prev=None,
                             front="replicate", next_front=None):
    """The trilinear upsample's output ``[B, 2T, H, W, C]`` of x ``[B, T, H,
    W, C]``, and the next chunk's front sums (None without ``next_front``).

    ``base_conv(frames)`` gives the base convs ``[B, n, H, W, 3C]`` of
    frames ``[B, n, H, W, C]`` (cuDNN's (1,3,3) conv with the stacked taps,
    no bias); :func:`temporal_linear_blend` blends them with x. ``split``,
    ``prev``, ``front`` and ``next_front`` as the blend takes them. The
    carried sums hold ``prev``'s share of the conv mixed with the front's,
    so where the next front is this chunk's front and the next predecessor
    is not ``prev``, or the other way round (a later chunk of ntu frames),
    ``prev``'s base convs are taken once more and its share moved."""
    c = x.shape[-1]
    out, sums = temporal_linear_blend(x, base_conv(x), bias, alpha, split, prev, front,
                                      next_front)
    if sums is None:
        return out, None
    nf, q = next_front
    move = (q < 0) - (nf == 0 and isinstance(front, torch.Tensor))
    if move and prev is not None:
        px = base_conv(prev).float()[:, 0]
        share = torch.stack([px[..., k * c:(k + 1) * c] for k in (2, 1, 0)], dim=1)
        sums = (sums.float() + 0.25 * move * share).to(x.dtype)
    return out, sums
