"""Resampling on ``[B, T, H, W, C]`` (``vidtok_tpu/modules/interp.py``)."""

from __future__ import annotations

import torch


def spatial_nearest_up2x(x):
    """[B,T,H,W,C] -> [B,T,2H,2W,C] by duplicating each pixel (dtype kept)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def spatial_avg_pool2x(x):
    """2x2 average pooling per frame (the reference's Downsample without
    conv)."""
    b, t, h, w, c = x.shape
    return x.reshape(b, t, h // 2, 2, w // 2, 2, c).mean(dim=(3, 5))


def temporal_nearest_up2x(x):
    """[B,T,H,W,C] -> [B,2T,H,W,C] by duplicating each frame (dtype kept)."""
    return x.repeat_interleave(2, dim=1)


def temporal_linear_up2x(x):
    """1D linear 2x upsampling along T, align_corners=False, edge clamp,
    computed in f32 (torch ``F.interpolate`` trilinear with H/W scale 1):

        out[2i]   = 0.25*in[i-1] + 0.75*in[i]
        out[2i+1] = 0.75*in[i]   + 0.25*in[i+1]
    """
    xf = x.float()
    prev = torch.cat([xf[:, :1], xf[:, :-1]], dim=1)
    nxt = torch.cat([xf[:, 1:], xf[:, -1:]], dim=1)
    even = 0.25 * prev + 0.75 * xf
    odd = 0.75 * xf + 0.25 * nxt
    b, t = x.shape[:2]
    out = torch.stack([even, odd], dim=2).reshape((b, 2 * t) + tuple(x.shape[2:]))
    return out.to(x.dtype)


def temporal_avg_pool3_stride2(x):
    """Average over 3-frame windows at temporal stride 2, VALID (torch
    ``nn.AvgPool3d((3,1,1), stride=(2,1,1))``); the caller pads."""
    n_out = (x.shape[1] - 3) // 2 + 1
    a = x[:, 0:2 * n_out - 1:2]
    b = x[:, 1:2 * n_out:2]
    c = x[:, 2:2 * n_out + 1:2]
    return (a + b + c) / 3.0
