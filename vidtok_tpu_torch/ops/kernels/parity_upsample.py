"""Kernel E: nearest 2x temporal upsample + causal 3x3x3 conv + blend.

Replaces ``vidtok_tpu/ops/pallas/parity_upsample_fused.py:108``
(``parity_up2x_fused``), the parity form of ``TimeUpsampleRes2x`` in
nearest mode (``vidtok_tpu/modules/blocks.py:598-668``). With ``Kj`` the
3x3 spatial taps of time tap j and ``s`` the half-rate input::

    y[2a]   = K2 (*) s[a] + (K0+K1) (*) s[a-1]
    y[2a+1] = (K1+K2) (*) s[a] + K0 (*) s[a-1]
    out[2a+p] = alpha * s[a] + (1 - alpha) * (y[2a+p] + bias)

spatial SAME padding with zeros (``s`` is not activated, so zero is exact);
``s[-1]`` is zeros (``zero``, v1.0) or ``s[0]`` (``replicate``). CUDA:
``csrc/parity_upsample.cu``, one implicit GEMM over 18 taps (2 frames x
3x3) on the TMA + wgmma loop of ``csrc/wgmma_conv.cuh`` (tap set
``kParity``), launched with ``plan.conv_plan_parity``'s plan, with the
weights ``[[K0+K1, K0], [K2, K1+K2]]`` summed in f32 and rounded to bf16
once, K-major, per parameter (``_lib.operands``); one f32 accumulator per
output, where the TPU kernel rounds the previous-frame taps to the
activation dtype before adding them. f32 s runs the loop's f32 scheme
(``split.py``): a split pass writes s's bf16 pieces, the summed weight is
split once per parameter (:func:`parity_operands_f32`), the blend is in f32.
JAX's kernel declines f32 at 256+ channels (a TPU VMEM limit,
``parity_upsample_fused.py:134``); this one takes f32 wherever it takes
bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib, plan
from .split import PIECES, kmajor_pieces


def parity_up2x_fused_plain(s, weight, bias, alpha, first_pad_mode: str):
    """Plain PyTorch form. s: ``[B, T, H, W, C]``; ``weight`` the causal
    conv's OIDHW ``[C, C, 3, 3, 3]``, ``bias`` ``[C]``, ``alpha`` a scalar
    tensor. The three base convs run as one per-frame conv C -> 3C in
    s.dtype; the previous-frame terms are shifted one frame later (the
    front rule at frame 0), then bias and blend in f32, rounded once."""
    b, t, h, w, c = s.shape
    dt = s.dtype
    k = weight.to(dt)
    kb = torch.cat([k[:, :, 0], k[:, :, 1], k[:, :, 2]])    # [3C, C, 3, 3]
    y = F.conv2d(s.reshape(b * t, h, w, c).permute(0, 3, 1, 2), kb, None, 1, 1)
    y0, y1, y2 = y.permute(0, 2, 3, 1).float().reshape(b, t, h, w, 3, c).unbind(4)
    cur = torch.stack([y2, y1 + y2], dim=4)                  # [B,T,H,W,2,C]
    prev = torch.stack([y0 + y1, y0], dim=4)
    if first_pad_mode == "replicate":
        front = prev[:, :1]
    else:
        front = torch.zeros_like(prev[:, :1])
    yc = cur + torch.cat([front, prev[:, :-1]], dim=1) + bias.float()
    a = alpha.float()
    out = (a * s.float()[:, :, :, :, None] + (1 - a) * yc).to(dt)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * t, h, w, c)


def _summed(weight):
    """``[[K0+K1, K0], [K2, K1+K2]]`` in f32, K-major ``[2C, 18C]``."""
    c = weight.shape[0]
    k0, k1, k2 = weight.float().permute(2, 3, 4, 1, 0)      # [3, 3, Ci, Co]
    wm = torch.stack([torch.cat([k0 + k1, k0], dim=-1),
                      torch.cat([k2, k1 + k2], dim=-1)])    # [2, 3, 3, Ci, 2Co]
    return wm.reshape(18 * c, 2 * c).t()


def parity_operands(weight, bias) -> dict:
    """Kernel E's parameters as it reads them: the K-major bf16 weight
    ``[(parity, co), (frame, dy, dx, ci)]`` ``[2C, 18C]``, frame 0 being
    s[a-1], the transpose of ``[[K0+K1, K0], [K2, K1+K2]]`` summed in f32
    and rounded once; the bias once per parity, f32; ``maps`` holds the
    weight's tensor maps by BN."""
    return {"w": _summed(weight).to(torch.bfloat16).contiguous(),
            "bias": _lib.f32(torch.cat([bias, bias])), "maps": {}}


def parity_operands_f32(weight, bias) -> dict:
    """E's f32 operands: the summed f32 weight split into its bf16 pieces,
    ``[2C, 3 * 18C]``; the bias as in :func:`parity_operands`."""
    return {"w": kmajor_pieces(_summed(weight)),
            "bias": _lib.f32(torch.cat([bias, bias])), "maps": {}}


def parity_up2x_fused(s, weight, bias, alpha, first_pad_mode: str):
    """s: ``[B, T, H, W, C]`` -> ``[B, 2T, H, W, C]``.

    A CPU tensor runs :func:`parity_up2x_fused_plain`. Otherwise s must be
    a contiguous bf16 or f32 CUDA tensor whose channels the plan takes
    (``plan.conv_plan_parity``: C % 128 == 0); it runs the kernel or
    raises. ``alpha`` is read at every call (the module computes it from
    its mix factor at every forward); the weight and bias are relaid out
    once per parameter.
    """
    parity_up2x_fused.calls += 1
    if first_pad_mode not in ("zero", "replicate"):
        raise ValueError(f"unknown first_pad_mode {first_pad_mode!r}")
    if s.device.type == "cpu":
        return parity_up2x_fused_plain(s, weight, bias, alpha, first_pad_mode)
    b, t, h, w, c = s.shape
    f32 = _lib.kernel_dtype(s, "E") == torch.float32
    pl = plan.conv_plan_parity(b, t, h, w, c, f32)
    _lib.require(s, s.dtype, (b, t, h, w, c))
    if tuple(weight.shape) != (c, c, 3, 3, 3):
        raise ValueError(f"kernel E takes a [C, C, 3, 3, 3] conv, got C={c}, "
                         f"{tuple(weight.shape)}")
    op = _lib.operands("parity_up2x_fused_f32" if f32 else "parity_up2x_fused",
                       (weight, bias), parity_operands_f32 if f32 else parity_operands)
    alpha = _lib.f32(alpha.reshape(1))
    for v in (op["w"], op["bias"], alpha):
        _lib.same_device(v, s)
    (wmap,) = _lib.weight_maps(op, pl.bn, "w")
    out = s.new_empty((b, 2 * t, h, w, c))
    sizes = (b, t, h, w, c, int(first_pad_mode == "replicate"), pl.th, pl.tw, pl.bn,
             pl.stages, pl.smem, pl.grid)
    if f32:
        sp = s.new_empty((b, t, h, w, PIECES * c), dtype=torch.bfloat16)  # s's pieces
        _lib.call("vt_parity_up2x_f32", s, sp, out, wmap, op["bias"], alpha, *sizes)
    else:
        _lib.call("vt_parity_up2x", s, out, wmap, op["bias"], alpha, *sizes)
    parity_up2x_fused.launches += 1
    return out


parity_up2x_fused.calls = 0
parity_up2x_fused.launches = 0
