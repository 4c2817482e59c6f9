"""Quality metrics, PSNR and SSIM (``vidtok_tpu/ops/metrics.py``).

Inputs are in [0, 1]; a video ``[B, C, T, H, W]`` is folded to ``B*T``
frames before the per-frame means. Plain functions on tensors: they run on
the device of their inputs and return 0-d f32 tensors (the ``ssim_per_*``
functions return per-channel tensors).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _fold_video(x):
    if x.ndim == 5:
        b, c, t, h, w = x.shape
        return x.transpose(1, 2).reshape(b * t, c, h, w)
    return x


def compute_psnr(x, y):
    """Mean per-frame PSNR (reference util.py:146-154)."""
    x = _fold_video(x.float())
    y = _fold_video(y.float())
    mse = (x - y).square().mean(dim=(1, 2, 3))
    return (-10.0 * torch.log10(mse + 1e-8)).mean()


def _gaussian_kernel(kernel_size: int = 11, sigma: float = 1.5, device=None):
    """The normalized 2D Gaussian, built in float64 and cast to f32."""
    coords = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(coords[None, :] ** 2 + coords[:, None] ** 2) / (2 * sigma**2))
    g /= g.sum()
    return torch.as_tensor(g, dtype=torch.float32, device=device)


def _blur(x, kernel):
    """Depthwise VALID conv of [N,C,H,W] with a 2D kernel."""
    c, k = x.shape[1], kernel.shape[0]
    return F.conv2d(x, kernel.expand(c, 1, k, k), groups=c)


def _avg_pool2d(x, f: int):
    """Mean over f x f blocks, the rows and columns past a multiple of f
    cropped."""
    n, c, h, w = x.shape
    x = x[:, :, : h // f * f, : w // f * f]
    return x.reshape(n, c, h // f, f, w // f, f).mean(dim=(3, 5))


def ssim_per_channel(x, y, k1: float = 0.01, k2: float = 0.03):
    """Per-channel SSIM and contrast sensitivity of [N,C,H,W] inputs (11x11
    Gaussian VALID window, alpha = beta = gamma = 1). Returns (ssim [N,C],
    cs [N,C])."""
    x, y = x.float(), y.float()
    kernel = _gaussian_kernel(11, 1.5, x.device)
    c1, c2 = k1**2, k2**2

    mu_x = _blur(x, kernel)
    mu_y = _blur(y, kernel)
    mu_xx, mu_yy, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
    sigma_xx = _blur(x * x, kernel) - mu_xx
    sigma_yy = _blur(y * y, kernel) - mu_yy
    sigma_xy = _blur(x * y, kernel) - mu_xy

    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ss = (2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1) * cs
    return ss.mean(dim=(-1, -2)), cs.mean(dim=(-1, -2))


def ssim_per_channel_complex(x, y, k1: float = 0.01, k2: float = 0.03):
    """Per-channel SSIM and CS of complex [N,C,H,W,2] inputs (last axis:
    real, imag; reference util.py:234-302). Returns (ssim [N,C,2],
    cs [N,C,2]) in the reference's stacking: (imag, real) for the
    covariance, (real, imag) for the product of the means."""
    x, y = x.float(), y.float()
    kernel = _gaussian_kernel(11, 1.5, x.device)
    c1, c2 = k1**2, k2**2

    xr, xi = x[..., 0], x[..., 1]
    yr, yi = y[..., 0], y[..., 1]

    mu1r, mu1i = _blur(xr, kernel), _blur(xi, kernel)
    mu2r, mu2i = _blur(yr, kernel), _blur(yi, kernel)

    mu1_sq = mu1r**2 + mu1i**2
    mu2_sq = mu2r**2 + mu2i**2
    mu12r = mu1r * mu2r - mu1i * mu2i
    mu12i = mu1r * mu2i + mu1i * mu2r

    x_sq = xr**2 + xi**2
    y_sq = yr**2 + yi**2
    xyr = xr * yr - xi * yi
    xyi = xr * yi + xi * yr

    sigma1_sq = _blur(x_sq, kernel) - mu1_sq
    sigma2_sq = _blur(y_sq, kernel) - mu2_sq
    sigma12r = _blur(xyr, kernel) - mu12r
    sigma12i = _blur(xyi, kernel) - mu12i

    # the reference stacks (imag, real) for sigma12 and (real, imag) for
    # mu1_mu2 (util.py:292-294), kept as it is
    sigma12 = torch.stack((sigma12i, sigma12r), dim=-1)
    mu1_mu2 = torch.stack((mu12r, mu12i), dim=-1)
    cs_map = (sigma12 * 2 + c2) / (sigma1_sq[..., None] + sigma2_sq[..., None] + c2)
    ssim_map = (mu1_mu2 * 2 + c1) / (mu1_sq[..., None] + mu2_sq[..., None] + c1) * cs_map
    return ssim_map.mean(dim=(-2, -3)), cs_map.mean(dim=(-2, -3))


def compute_ssim(x, y):
    """Mean per-frame SSIM, 11x11 Gaussian window; frames whose shorter
    side is about 512 or more are first averaged down by
    ``f = round(min(H, W) / 256)`` (reference util.py:157-231)."""
    x = _fold_video(x.float())
    y = _fold_video(y.float())
    f = max(1, round(min(x.shape[-2:]) / 256))
    if f > 1:
        x = _avg_pool2d(x, f)
        y = _avg_pool2d(y, f)
    ss, _ = ssim_per_channel(x, y)
    return ss.mean(dim=1).mean()
