"""LPIPS distance: frozen VGG16 features and learned 1x1 heads
(``vidtok_tpu/modules/lpips.py``; reference vidtok/modules/lpips.py:61-172).

VGG16's ``features`` at its five relu taps, each tap unit-normalised over
channels (statistics in f32), the squared difference weighted by a 1x1
head without bias, a spatial mean, summed over the taps. Images are NCHW
in [-1, 1]; the result is ``[N, 1, 1, 1]`` f32.

The weights are JAX's converted file (``tools/convert_lpips.py``:
``vgg/conv{j}/kernel`` HWIO and ``/bias``, ``lin{k}/kernel`` ``[1,1,C,1]``),
read by :func:`load_lpips_params`; nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 'features' conv plan: (out_channels, pool_before)
_VGG16_PLAN = [
    (64, False), (64, False),                  # relu1_2 (tap 0)
    (128, True), (128, False),                 # relu2_2 (tap 1)
    (256, True), (256, False), (256, False),   # relu3_3 (tap 2)
    (512, True), (512, False), (512, False),   # relu4_3 (tap 3)
    (512, True), (512, False), (512, False),   # relu5_3 (tap 4)
]
_TAPS = [1, 3, 6, 9, 12]  # conv indices whose relu output is tapped
_CHNS = [64, 128, 256, 512, 512]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = "checkpoints/lpips/vgg_lpips.npz"


def _unit(f):
    """``f`` over its channel norm (+1e-10), computed in f32, in f's dtype."""
    f32 = f.float()
    return (f32 / (f32.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)).to(f.dtype)


class LPIPS(nn.Module):
    """LPIPS distance of two NCHW image batches in [-1, 1] -> [N,1,1,1] f32."""

    def __init__(self):
        super().__init__()
        chans, convs = 3, []
        for ch, _ in _VGG16_PLAN:
            convs.append(nn.Conv2d(chans, ch, 3, padding=1))
            chans = ch
        self.vgg = nn.ModuleList(convs)
        self.lin = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False) for c in _CHNS)
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def features(self, x):
        taps = []
        for i, ((_, pool), conv) in enumerate(zip(_VGG16_PLAN, self.vgg)):
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(conv(x))
            if i in _TAPS:
                taps.append(x)
        return taps

    def forward(self, x, y):
        # the constants in the input's dtype, as JAX has them
        shift, scale = self.shift.to(x.dtype), self.scale.to(x.dtype)
        fx = self.features((x - shift) / scale)
        fy = self.features((y - shift) / scale)
        val = 0.0
        for a, b, lin in zip(fx, fy, self.lin):
            diff = (_unit(a) - _unit(b)).square()
            val = val + lin(diff).float().mean(dim=(2, 3), keepdim=True)
        return val


def state_dict_from_npz(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX's flat LPIPS layout (HWIO kernels) -> :class:`LPIPS`'s state dict
    (OIHW)."""
    sd = {}
    for j in range(len(_VGG16_PLAN)):
        sd[f"vgg.{j}.weight"] = flat[f"vgg/conv{j}/kernel"].transpose(3, 2, 0, 1)
        sd[f"vgg.{j}.bias"] = flat[f"vgg/conv{j}/bias"]
    for k in range(len(_CHNS)):
        sd[f"lin.{k}.weight"] = flat[f"lin{k}/kernel"].transpose(3, 2, 0, 1)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def load_lpips_params(path: str = DEFAULT_WEIGHTS) -> Optional[Dict[str, torch.Tensor]]:
    """The converted weights at ``path`` as :class:`LPIPS`'s state dict, or
    None when the file is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as f:
        return state_dict_from_npz({k: f[k] for k in f.files})
