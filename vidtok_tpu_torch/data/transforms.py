"""Frame transforms on tensors (``vidtok_tpu/data/transforms.py``): the
reference's torchvision pipeline Resize(shorter side, antialias) ->
CenterCrop -> Normalize(0.5, 0.5) (vidtok/data/vidtok.py:51-59).

Channels-last ``[T, H, W, C]`` frames in [0, 1], on whatever device they
are given. The JAX package resizes with Pillow's BILINEAR filter on uint8
images; :func:`resize_shorter_side` computes Pillow's own integer
arithmetic without Pillow (``_pillow_weights``), so its frames equal the
JAX package's bit for bit on the CPU and on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# Pillow's fixed-point precision for 8-bit images (PRECISION_BITS = 32 - 8 - 2)
_BITS = 22


@functools.lru_cache(maxsize=16)
def _pillow_weights(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's BILINEAR coefficients for one axis (``precompute_coeffs``
    and ``normalize_coeffs_8bpc`` of its Resample.c) as a dense float64
    ``[out, in]`` matrix of integers: support ``max(in/out, 1)``, taps
    ``[int(center - support + 0.5), int(center + support + 0.5))``
    clamped, weights normalized, then rounded to ``2**22`` fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    ss = 1.0 / filterscale
    m = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax - xmin)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            m[xx, xmin + x] = int(0.5 + v * (1 << _BITS)) if v >= 0 else int(-0.5 + v * (1 << _BITS))
    return m


def _div255(x):
    """``x / 255`` rounded once, as numpy divides. The divisor is a tensor
    on x's device: PyTorch's CUDA division by a Python (CPU) scalar
    multiplies by its reciprocal, which can land one ulp away."""
    return x / torch.full((), 255.0, dtype=x.dtype, device=x.device)


def _resample(x, weights: np.ndarray, dim: int):
    """One Pillow pass over ``dim`` of a float64 tensor of uint8 values:
    an exact integer matmul (every product and partial sum is an integer
    below 2**53), then ``(s + 2**21) >> 22`` clamped to [0, 255]."""
    w = torch.as_tensor(weights, device=x.device)
    s = torch.tensordot(x.movedim(dim, -1), w, dims=([-1], [1])).movedim(-1, dim)
    return torch.floor((s + (1 << (_BITS - 1))) / (1 << _BITS)).clamp_(0, 255)


def resize_shorter_side(frames, size: int):
    """Scale so the shorter side is ``size``, keeping the aspect ratio
    (torchvision Resize(size)), with Pillow's BILINEAR on the frames
    quantized to uint8 as the JAX package does; unchanged sizes pass
    through untouched."""
    t, h, w, c = frames.shape
    if h <= w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    if (nh, nw) == (h, w):
        return frames
    x = (frames.clamp(0, 1) * 255).to(torch.uint8).to(torch.float64)
    if nw != w:  # Pillow's horizontal pass first, then the vertical
        x = _resample(x, _pillow_weights(w, nw), 2)
    if nh != h:
        x = _resample(x, _pillow_weights(h, nh), 1)
    return _div255(x.to(torch.float32))


def center_crop(frames, ch: int, cw: int):
    """The central ``ch x cw`` window, zero-padded (split evenly, the extra
    row or column after) where the frames are smaller."""
    t, h, w, c = frames.shape
    top = max(0, (h - ch) // 2)
    left = max(0, (w - cw) // 2)
    out = frames[:, top: top + ch, left: left + cw]
    if out.shape[1] != ch or out.shape[2] != cw:
        pad_h, pad_w = ch - out.shape[1], cw - out.shape[2]
        out = F.pad(out, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                          pad_h // 2, pad_h - pad_h // 2))
    return out


def normalize(frames, mean: float = 0.5, std: float = 0.5):
    return (frames - mean) / std


def to_unit(frames_u8):
    """uint8 frames -> float32 in [0, 1], as the JAX package's readers scale
    them."""
    return _div255(frames_u8.to(torch.float32))


def default_transform(frames, input_height: int, input_width: int):
    """[0, 1] frames -> resized, cropped and normalized [-1, 1] frames."""
    frames = resize_shorter_side(frames, input_height)
    frames = center_crop(frames, input_height, input_width)
    return normalize(frames)


def transform_u8(frames_u8: np.ndarray, height: int, width: int, device="cpu"):
    """Decoded uint8 [T,H,W,3] frames from the host -> transformed [-1, 1]
    f32 frames [T,height,width,3] on ``device``, moved there as uint8."""
    x = to_unit(torch.from_numpy(frames_u8).to(device))
    return default_transform(x, height, width)
