"""VidTwin's factorized space-time transformer
(``vidtok_tpu/models/vidtwin/st_transformer.py``; reference
vidtwin/modules/st_transformer.py).

A clip ``[B, C, T, H, W]`` is cut into ``patch_size`` patches by a Conv3d
(``PatchEmbed3D``), the tokens run through ``STBlock``s (attention over the
H'W' positions of each frame, then attention over the T' frames of each
position, causal by default, then an MLP, each branch modulated and gated
by the block's ``scale_shift_table``), and the decoder's modulated linear
head (``T2IFinalLayer``) and ``unpatchify`` give a clip back. Inside, tokens
are ``[B, T', S, C]`` with ``S = H' W'``; the encoder returns and the
decoder takes the token grid as ``[B, C, T', H', W']``.

Precision, as in JAX: the model's dtype for everything but attention,
whose q, k and v are cast to ``attn_dtype`` (bf16 by default, also in an
f32 model; ``None`` keeps the model's dtype) with the softmax in f32
inside ``F.scaled_dot_product_attention``. Layer norms compute their
statistics in f32. The layers cast their weights to the input's dtype, so
bf16-mixed training runs a bf16 clip through f32 master weights; the
position embeddings and modulation tables are cast too, so a bf16 clip
stays bf16 (JAX promotes it to f32 at the first f32 embedding).

The module names and parameter layouts are the reference torch model's
(``encoder.blocks.3.attn_temp.qkv.weight``), so its state dict loads as it
is; the sincos position embeddings are non-persistent buffers.

Spans (``utils/profiling.span``): ``vt.model.encoder`` and
``vt.model.decoder`` (with its head and ``unpatchify``) around the two
transformers, and in each ``STBlock`` ``vt.model.attn.spatial`` (the
first norm through the spatial branch's gated add) and
``vt.model.attn.temporal`` (the layout copies to and from ``[B S, T, C]``,
the ``tpe`` add, the causal attention and the gated add); the MLP branch
has no span of its own.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.profiling import span

# -- layers that compute in their input's dtype ------------------------------


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x),
                            _cast(self.bias, x), self.eps)


# -- initialization as flax's initializers draw, on the CPU from a generator


def _fans(shape) -> Tuple[int, int]:
    """(fan_in, fan_out) of a torch weight ``[out, in, *kernel]``."""
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def init_(p: torch.Tensor, kind: str, generator: torch.Generator = None,
          std: float = 1.0) -> None:
    """Fill ``p`` in place: ``xavier`` (uniform), ``lecun`` (truncated
    normal, flax's default kernel init), ``normal`` (N(0, std^2)) or
    ``zeros``; drawn in f32 on the CPU."""
    with torch.no_grad():
        if kind == "zeros":
            p.zero_()
            return
        r = torch.empty(p.shape, dtype=torch.float32)
        if kind == "xavier":
            fan_in, fan_out = _fans(p.shape)
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            r.uniform_(-bound, bound, generator=generator)
        elif kind == "lecun":
            # flax's truncated normal at 2 sigma, rescaled to unit variance
            s = math.sqrt(1.0 / _fans(p.shape)[0]) / 0.87962566103423978
            r.normal_(0.0, 1.0, generator=generator).clamp_(-2.0, 2.0).mul_(s)
        elif kind == "normal":
            r.normal_(0.0, std, generator=generator)
        else:
            raise ValueError(kind)
        p.copy_(r)


def reset_linear_(m: nn.Module, generator=None, kernel: str = "xavier") -> None:
    init_(m.weight, kernel, generator)
    if m.bias is not None:
        init_(m.bias, "zeros")


# -- helpers (st_transformer.py:37-73) ----------------------------------------


def t2i_modulate(x, shift, scale):
    return x * (1 + scale) + shift


def layer_norm_noaffine(x, eps: float = 1e-6):
    """LayerNorm without weights over the last axis, f32 statistics."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def get_1d_sincos_pos_embed(embed_dim, length, scale: float = 1.0):
    """Positions ``0..length-1`` over ``scale``, in f64 (``:43-48``)."""
    pos = np.arange(0, length, dtype=np.float64)[:, None] / scale
    return get_1d_sincos_pos_embed_from_grid(embed_dim, pos)


def get_2d_sincos_pos_embed(embed_dim, grid_size, scale: float = 1.0):
    """The reference's grid: ``meshgrid(w, h)`` reshaped ``(2, 1, gw, gh)``,
    as written (a square grid hides the transposition); positions over
    ``scale``, in f32 (``:51-58``)."""
    gh = np.arange(grid_size[0], dtype=np.float32) / scale
    gw = np.arange(grid_size[1], dtype=np.float32) / scale
    grid = np.meshgrid(gw, gh)
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size[1], grid_size[0])
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_1d_sincos_pos_embed_from_grid(embed_dim, pos):
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = pos.reshape(-1)[:, None] * omega[None]
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


# -- attention (st_transformer.py:76-154) -------------------------------------


class Attention(nn.Module):
    """Multi-head attention with a fused qkv projection, by
    ``F.scaled_dot_product_attention`` on q, k, v in ``attn_dtype``."""

    def __init__(self, dim: int, num_heads: int = 8, zero_init_proj: bool = False,
                 attn_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.zero_init_proj = zero_init_proj
        self.attn_dtype = attn_dtype
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def reset_params(self, generator=None):
        reset_linear_(self.qkv, generator)
        reset_linear_(self.proj, generator, "zeros" if self.zero_init_proj else "xavier")

    def attend(self, x, causal: bool):
        """[N, n, C] -> [N, n, C] before the output projection."""
        n_, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(n_, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.to(self.attn_dtype or x.dtype).unbind(0)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return out.transpose(1, 2).reshape(n_, n, c).to(x.dtype)

    def forward(self, x, causal: bool = False):
        return self.proj(self.attend(x, causal))


class GroupAttention(Attention):
    """Attention within contiguous groups of ``group_size`` tokens, each
    group causal on its own under ``causal`` (the reference's flash path,
    ``flash_attn_func`` on ``[B*G, group_size]``)."""

    def __init__(self, dim: int, num_heads: int = 8, group_size: int = 4,
                 zero_init_proj: bool = False,
                 attn_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__(dim, num_heads, zero_init_proj, attn_dtype)
        self.group_size = group_size

    def forward(self, x, causal: bool = False):
        b, n, c = x.shape
        if n % self.group_size:
            raise ValueError(f"sequence length {n} not divisible by group_size "
                             f"{self.group_size}")
        out = self.attend(x.reshape(b * (n // self.group_size), self.group_size, c), causal)
        return self.proj(out.reshape(b, n, c))


def drop_path(x, rate: float, deterministic: bool, generator: torch.Generator = None):
    """Stochastic depth of a residual branch: each sample's branch kept
    with probability ``1 - rate`` and rescaled by ``1 / (1 - rate)``."""
    if rate == 0.0 or deterministic:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def reset_params(self, generator=None):
        reset_linear_(self.fc1, generator)
        reset_linear_(self.fc2, generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class STBlock(nn.Module):
    """Spatial attention over ``(B T) S C``, temporal (causal by default)
    attention over ``(B S) T C``, modulated MLP (``:182-248``). Both
    attention branches are gated by ``gate_msa``; the temporal branch takes
    the unmodulated ``x`` plus ``tpe`` (block 0 only). ``no_temporal``
    drops the temporal branch and its ``attn_temp``."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 temporal_causal: bool = True, temporal_group: bool = False,
                 group_size: int = 1, drop_path_rate: float = 0.0,
                 attn_dtype: Optional[torch.dtype] = torch.bfloat16,
                 no_temporal: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.temporal_causal = temporal_causal
        self.no_temporal = no_temporal
        self.drop_path_rate = drop_path_rate
        self.scale_shift_table = nn.Parameter(torch.empty(6, hidden_size))
        self.attn = Attention(hidden_size, num_heads, attn_dtype=attn_dtype)
        if not no_temporal:
            self.attn_temp = (
                GroupAttention(hidden_size, num_heads, group_size, zero_init_proj=True,
                               attn_dtype=attn_dtype) if temporal_group else
                Attention(hidden_size, num_heads, zero_init_proj=True,
                          attn_dtype=attn_dtype))
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))

    def reset_params(self, generator=None):
        init_(self.scale_shift_table, "normal", generator, self.hidden_size ** -0.5)

    def forward(self, x, tpe=None, deterministic: bool = True,
                generator: torch.Generator = None):
        """x: [B, T, S, C]."""
        b, t, s, c = x.shape
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.scale_shift_table.to(x.dtype).unbind(0)

        def dp(branch):
            return drop_path(branch, self.drop_path_rate, deterministic, generator)

        with span("vt.model.attn.spatial"):
            x_m = t2i_modulate(layer_norm_noaffine(x), shift_msa, scale_msa)
            x_s = self.attn(x_m.reshape(b * t, s, c))
            x = x + dp(gate_msa * x_s.reshape(b, t, s, c))
        if not self.no_temporal:
            with span("vt.model.attn.temporal"):
                x_t = x.transpose(1, 2).reshape(b * s, t, c)
                if tpe is not None:
                    x_t = x_t + tpe.to(x.dtype)
                x_t = self.attn_temp(x_t, causal=self.temporal_causal)
                x = x + dp(gate_msa * x_t.reshape(b, s, t, c).transpose(1, 2))
        h = t2i_modulate(layer_norm_noaffine(x), shift_mlp, scale_mlp)
        return x + dp(gate_mlp * self.mlp(h))


class T2IFinalLayer(nn.Module):
    """Modulated linear head; ``linear`` starts at zero (``:251-274``)."""

    def __init__(self, hidden_size: int, num_patch: int, out_channels: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.scale_shift_table = nn.Parameter(torch.empty(2, hidden_size))
        self.linear = Linear(hidden_size, num_patch * out_channels)

    def reset_params(self, generator=None):
        init_(self.scale_shift_table, "normal", generator, self.hidden_size ** -0.5)
        reset_linear_(self.linear, generator, "zeros")

    def forward(self, x):
        shift, scale = self.scale_shift_table.to(x.dtype).unbind(0)
        return self.linear(t2i_modulate(layer_norm_noaffine(x), shift, scale))


class PatchEmbed3D(nn.Module):
    """Conv patchify ``[B, C, T, H, W]`` -> ``[B, N, C_emb]``, the clip
    zero-padded at the end of T, H and W to whole patches (``:277-294``)."""

    def __init__(self, patch_size: Sequence[int], in_channels: int, embed_dim: int):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = Conv3d(in_channels, embed_dim, self.patch_size, stride=self.patch_size)

    def reset_params(self, generator=None):
        reset_linear_(self.proj, generator)

    def forward(self, x):
        pt, ph, pw = self.patch_size
        pads = ((-x.shape[2]) % pt, (-x.shape[3]) % ph, (-x.shape[4]) % pw)
        if any(pads):
            x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
        return self.proj(x).flatten(2).transpose(1, 2)


class STTransformer(nn.Module):
    def __init__(self, input_size: Sequence[int] = (16, 224, 224), in_channels: int = 3,
                 patch_size: Sequence[int] = (1, 16, 16), hidden_size: int = 768,
                 depth: int = 16, num_heads: int = 12, mlp_ratio: float = 4.0,
                 temporal_causal: bool = True, temporal_group: bool = False,
                 group_size: int = 1, drop_path: float = 0.0,
                 attn_dtype: Optional[torch.dtype] = torch.bfloat16,
                 no_temporal: bool = False, space_scale: float = 1.0,
                 time_scale: float = 1.0):
        super().__init__()
        self.input_size = tuple(input_size)
        self.in_channels = in_channels
        self.patch_size = tuple(patch_size)
        self.hidden_size = hidden_size
        self.depth = depth
        self.temporal_causal = temporal_causal
        self.no_temporal = no_temporal
        self.space_scale, self.time_scale = space_scale, time_scale
        self.grid = tuple(self.input_size[i] // self.patch_size[i] for i in range(3))
        t, gh, gw = self.grid
        self.register_buffer("pos_embed", torch.tensor(get_2d_sincos_pos_embed(
            hidden_size, (gh, gw), space_scale), dtype=torch.float32), persistent=False)
        self.register_buffer("pos_embed_temporal", torch.tensor(get_1d_sincos_pos_embed(
            hidden_size, t, time_scale), dtype=torch.float32)[None], persistent=False)
        # per-block stochastic depth: linspace(0, drop_path, depth)
        self.blocks = nn.ModuleList(
            STBlock(hidden_size, num_heads, mlp_ratio, temporal_causal,
                    temporal_group, group_size,
                    drop_path * i / max(depth - 1, 1) if drop_path > 0 else 0.0,
                    attn_dtype, no_temporal)
            for i in range(depth))

    @property
    def num_temporal(self) -> int:
        return self.grid[0]

    @property
    def num_spatial(self) -> int:
        return self.grid[1] * self.grid[2]

    def spatial_pos_embed(self) -> torch.Tensor:
        """The f32 sincos embedding of the H'W' grid, ``[S, hidden]``."""
        return self.pos_embed

    def temporal_pos_embed(self) -> torch.Tensor:
        """The f32 sincos embedding of the T' frames, ``[T', hidden]``."""
        return self.pos_embed_temporal[0]

    def set_attn_dtype(self, attn_dtype: Optional[torch.dtype]) -> None:
        """Every attention's q, k, v dtype (None: the model's)."""
        for m in self.modules():
            if isinstance(m, Attention):
                m.attn_dtype = attn_dtype

    def run_blocks(self, x, deterministic: bool = True, generator: torch.Generator = None):
        """x: [B, N=(T S), C] -> same."""
        b = x.shape[0]
        t, s = self.num_temporal, self.num_spatial
        x = x.reshape(b, t, s, self.hidden_size) + self.pos_embed.to(x.dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, self.pos_embed_temporal if i == 0 else None, deterministic, generator)
        return x.reshape(b, t * s, self.hidden_size)


class STTEncoder(STTransformer):
    """Clip ``[B, C, T, H, W]`` -> token grid ``[B, hidden, T', H', W']``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.x_embedder = PatchEmbed3D(self.patch_size, self.in_channels, self.hidden_size)

    def forward(self, x, deterministic: bool = True, generator: torch.Generator = None):
        with span("vt.model.encoder"):
            y = self.run_blocks(self.x_embedder(x), deterministic, generator)
            return y.transpose(1, 2).reshape((y.shape[0], self.hidden_size) + self.grid)


class STTDecoder(STTransformer):
    """Token grid ``[B, hidden, T', H', W']`` -> clip ``[B, C, T, H, W]``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.final_layer = T2IFinalLayer(self.hidden_size, int(np.prod(self.patch_size)),
                                         self.in_channels)

    def forward(self, z, deterministic: bool = True, generator: torch.Generator = None):
        with span("vt.model.decoder"):
            y = self.run_blocks(z.flatten(2).transpose(1, 2), deterministic, generator)
            return self.unpatchify(self.final_layer(y))

    def unpatchify(self, y):
        """[B, N, prod(patch) * C] -> [B, C, T, H, W]."""
        b = y.shape[0]
        nt, nh, nw = self.grid
        pt, ph, pw = self.patch_size
        c = self.in_channels
        y = y.reshape(b, nt, nh, nw, pt, ph, pw, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return y.reshape(b, c, nt * pt, nh * ph, nw * pw)
