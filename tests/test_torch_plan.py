"""The wgmma loop's tile plans and the kernels' cached weight operands.

Kernels A, B, E and F of the port run the warp-specialised TMA + wgmma
conv of ``csrc/wgmma_conv.cuh`` with a plan made in ``ops/kernels/plan.py``,
and read their weights from ``_lib.operands``, relaid out once per
parameter. Neither needs the card: the plans are checked at every A, B, E
and F call shape ``chip_smoke.py`` serves or gates (each output position,
and for E each output frame, in exactly one tile, BN dividing Cout (E: C),
the shared memory and the grid within the H100's limits), the cache
against the relayouts it stands for and against the ways a parameter
changes. The wrappers' refusals follow the plan (the meta device stands in
for a card: a wrapper given a tensor off the CPU launches its kernel or
raises).
"""

import copy
import dataclasses
import gc
import re
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import vidtok_tpu.modules.blocks as JB
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels import _lib, plan
from vidtok_tpu_torch.ops.kernels.fused_spatial import spatial_operands
from vidtok_tpu_torch.ops.kernels.fused_temporal import (gemm_weight, kmajor_weight,
                                                         temporal_operands)
from vidtok_tpu_torch.ops.kernels.parity_upsample import parity_operands
from vidtok_tpu_torch.ops.kernels.split import PIECES, PRODUCTS
from vidtok_tpu_torch.utils.checkpoint import load_into

torch.set_num_threads(2)


def _spatial_sources(m):
    nin = m.nin_shortcut if hasattr(m, "nin_shortcut") else None
    return (m.conv1.weight, m.norm1.norm.weight, m.norm1.norm.bias, m.conv1.bias,
            m.norm2.norm.weight, m.norm2.norm.bias, m.conv2.weight, m.conv2.bias,
            None if nin is None else nin.weight, None if nin is None else nin.bias)


def _temporal_sources(m):
    return (m.conv1.conv.weight, m.norm1.norm.weight, m.norm1.norm.bias,
            m.conv1.conv.bias, m.norm2.norm.weight, m.norm2.norm.bias,
            m.conv2.conv.weight, m.conv2.conv.bias)


def _randomized(m, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return m


# -- the operands, as the kernels read them ---------------------------------

@pytest.mark.parametrize("cin,c", [(64, 128), (128, 128)])
def test_spatial_operands_layout(cin, c):
    """A's operands: K-major [C, (dy, dx, ci)] bf16, the nin_shortcut's Cin
    columns after conv2's and its bias folded into conv2's; f32 vectors."""
    m = _randomized(TB.ResnetBlockSpatial(cin, c), 0)
    op = spatial_operands(*_spatial_sources(m))
    w1, w2 = m.conv1.weight, m.conv2.weight
    assert op["w1"].dtype == op["w2"].dtype == torch.bfloat16
    assert op["w1"].is_contiguous() and op["w2"].is_contiguous()
    for dy in range(3):
        for dx in range(3):
            tap = dy * 3 + dx
            assert torch.equal(op["w1"][:, tap * cin:(tap + 1) * cin],
                               w1[:, :, dy, dx].to(torch.bfloat16))
            assert torch.equal(op["w2"][:, tap * c:(tap + 1) * c],
                               w2[:, :, dy, dx].to(torch.bfloat16))
    bias2 = m.conv2.bias.float()
    if cin != c:
        assert op["w2"].shape == (c, 9 * c + cin)
        assert torch.equal(op["w2"][:, 9 * c:],
                           m.nin_shortcut.weight[:, :, 0, 0].to(torch.bfloat16))
        bias2 = bias2 + m.nin_shortcut.bias.float()
    else:
        assert op["w2"].shape == (c, 9 * c)
    assert torch.equal(op["bias2"], bias2)
    for k, t in (("g1", m.norm1.norm.weight), ("b2", m.norm2.norm.bias),
                 ("bias1", m.conv1.bias)):
        assert op[k].dtype == torch.float32 and torch.equal(op[k], t)


def test_temporal_operands_layout():
    """B's and F's operands (one cache entry per block, which both read)
    are K-major [co, (k, ci)] bf16, the transpose of the tools'
    ``gemm_weight`` (tap-major [(k, ci), co]), beside the f32 vectors."""
    m = _randomized(TB.ResnetBlockTemporal(32, 32), 1)
    op = temporal_operands(*_temporal_sources(m))
    for name, conv in (("w1", m.conv1), ("w2", m.conv2)):
        w = conv.conv.weight
        assert op[name].is_contiguous() and op[name].dtype == torch.bfloat16
        assert torch.equal(op[name], kmajor_weight(w))
        assert torch.equal(op[name], gemm_weight(w).t())
        for k in range(3):
            assert torch.equal(op[name][:, 32 * k:32 * (k + 1)],
                               w[:, :, k].to(torch.bfloat16))
    assert op["maps"] == {}
    assert torch.equal(op["bias2"], m.conv2.conv.bias)
    assert op["g1"].dtype == torch.float32


def _parity_relayout(weight):
    """E's GEMM operand as its wmma form built it at every call:
    ``[(frame, dy, dx, ci), (parity, co)]``, frame 0 = s[a-1], the weights
    ``[[K0+K1, K0], [K2, K1+K2]]`` summed in f32, rounded to bf16 once."""
    c = weight.shape[0]
    k0, k1, k2 = weight.float().permute(2, 3, 4, 1, 0)
    wm = torch.stack([torch.cat([k0 + k1, k0], dim=-1),
                      torch.cat([k2, k1 + k2], dim=-1)])
    return wm.reshape(18 * c, 2 * c).to(torch.bfloat16).contiguous()


def test_parity_operands_layout():
    """E's operand is K-major [(parity, co), (frame, dy, dx, ci)] [2C, 18C]:
    the transpose of the tap-major relayout, block by block the summed time
    taps of each parity and frame; the bias once per parity, f32."""
    c = 16
    g = torch.Generator().manual_seed(8)
    weight = torch.randn((c, c, 3, 3, 3), generator=g)
    bias = torch.randn((c,), generator=g)
    op = parity_operands(weight, bias)
    assert op["w"].shape == (2 * c, 18 * c) and op["w"].is_contiguous()
    assert op["w"].dtype == torch.bfloat16
    assert torch.equal(op["w"], _parity_relayout(weight).t())
    k = weight.float()
    want = {(0, 0): k[:, :, 0] + k[:, :, 1], (1, 0): k[:, :, 0],
            (0, 1): k[:, :, 2], (1, 1): k[:, :, 1] + k[:, :, 2]}
    for (par, f), kk in want.items():
        for dy in range(3):
            for dx in range(3):
                col = ((f * 3 + dy) * 3 + dx) * c
                assert torch.equal(op["w"][par * c:(par + 1) * c, col:col + c],
                                   kk[:, :, dy, dx].to(torch.bfloat16))
    assert op["bias"].dtype == torch.float32
    assert torch.equal(op["bias"], torch.cat([bias, bias])) and op["maps"] == {}


PARITY_UPDATES = {
    "weight": lambda m: _no_grad(lambda: m.conv.conv.weight.mul_(-0.5)),
    "bias": lambda m: _no_grad(lambda: m.conv.conv.bias.add_(1.0)),
    "mix_factor": lambda m: _no_grad(lambda: m.mix_factor.add_(1.0)),
}


@pytest.mark.parametrize("update", sorted(PARITY_UPDATES))
def test_parity_operands_cached_then_rebuilt(update):
    """E's cache entry, keyed as its wrapper keys it (the conv's weight and
    bias), is served while they stand still and rebuilt, equal to a fresh
    relayout, after an in-place update of either. The blend weight alpha =
    sigmoid(mix_factor) is a new tensor at every forward and is read by the
    kernel at every call, so it is not in the entry: an update of the mix
    factor keeps the entry."""
    m = TB.TimeUpsampleRes2x(16, 16, interpolation_mode="nearest")
    _randomized(m, 9)

    def get():
        return _lib.operands("parity_up2x_fused", (m.conv.conv.weight, m.conv.conv.bias),
                             parity_operands)

    first = get()
    assert get() is first
    PARITY_UPDATES[update](m)
    again = get()
    if update == "mix_factor":
        assert again is first
        return
    assert again is not first
    fresh = parity_operands(m.conv.conv.weight, m.conv.conv.bias)
    assert torch.equal(again["w"], fresh["w"]) and torch.equal(again["bias"], fresh["bias"])
    assert torch.equal(again["w"], _parity_relayout(m.conv.conv.weight).t())


# -- the cache ----------------------------------------------------------------

def _jax_update(m, seed):
    """New weights for m through ``state_dict_from_jax``, as a JAX
    checkpoint reaches the port."""
    x = jnp.zeros((1, 1, 8, 8, 32))
    p = JB.ResnetBlockSpatial(32, norm_type="layernorm").init(
        jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.RandomState(seed)
    p = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), p)
    prefix = "encoder.down.0.block.0."
    sd = state_dict_from_jax({"encoder": {"down_0_block_0": p}})
    m.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v))
                       for k, v in sd.items()})


UPDATES = {
    "no_grad_copy": lambda m: _no_grad(lambda: m.conv1.weight.copy_(
        torch.randn(m.conv1.weight.shape))),
    "detach_copy": lambda m: m.conv2.bias.detach().copy_(torch.randn(32)),
    "in_place_op": lambda m: _no_grad(lambda: m.norm1.norm.weight.mul_(2.0)),
    "load_state_dict": lambda m: m.load_state_dict(
        _randomized(TB.ResnetBlockSpatial(32, 32), 7).state_dict()),
    "state_dict_from_jax": lambda m: _jax_update(m, 3),
    "load_into": lambda m: load_into(
        m, _randomized(TB.ResnetBlockSpatial(32, 32), 8).state_dict()),
    "to_dtype": lambda m: m.to(torch.float64),
    "data_copy_then_clear": lambda m: (m.conv1.weight.data.copy_(
        torch.randn(m.conv1.weight.shape)), _lib.clear_operands()),
}


def _no_grad(fn):
    with torch.no_grad():
        fn()


@pytest.mark.parametrize("update", sorted(UPDATES))
def test_operands_cached_then_rebuilt(update):
    """Served from the cache while the parameters stand still; rebuilt, and
    equal to a fresh relayout, after each way they change. A write through
    ``param.data`` bypasses PyTorch's version counter, so it needs
    ``clear_operands``."""
    m = _randomized(TB.ResnetBlockSpatial(32, 32), 2)
    first = _lib.operands("test_spatial", _spatial_sources(m), spatial_operands)
    assert _lib.operands("test_spatial", _spatial_sources(m), spatial_operands) is first
    UPDATES[update](m)
    again = _lib.operands("test_spatial", _spatial_sources(m), spatial_operands)
    assert again is not first
    fresh = spatial_operands(*_spatial_sources(m))
    for k in ("w1", "w2", "g1", "b1", "bias1", "g2", "b2", "bias2"):
        assert torch.equal(again[k], fresh[k]), k


def test_operands_stale_data_write_is_not_seen():
    """The limit of the key, stated: PyTorch does not count a write through
    ``param.data``, so the cached operand stays as it was."""
    m = _randomized(TB.ResnetBlockSpatial(32, 32), 4)
    first = _lib.operands("test_spatial", _spatial_sources(m), spatial_operands)
    m.conv1.weight.data.mul_(2.0)
    assert _lib.operands("test_spatial", _spatial_sources(m), spatial_operands) is first


def test_operands_per_device_dtype_and_kind():
    """Two copies of the same weights on two devices or in two dtypes, and
    one parameter under two kinds, are separate entries; an entry does not
    keep its parameter alive."""
    m = _randomized(TB.ResnetBlockTemporal(32, 32), 5)
    m64 = copy.deepcopy(m).double()
    meta = copy.deepcopy(m).to("meta")
    b = _lib.operands("test_b", _temporal_sources(m), temporal_operands)
    b64 = _lib.operands("test_b", _temporal_sources(m64), temporal_operands)
    bmeta = _lib.operands("test_b", _temporal_sources(meta), temporal_operands)
    f = _lib.operands("test_f", _temporal_sources(m), temporal_operands)
    assert len({id(b), id(b64), id(bmeta), id(f)}) == 4
    assert bmeta["w1"].device.type == "meta" and b["w1"].device.type == "cpu"
    assert torch.equal(b["w1"], b64["w1"])  # the same bf16 operand
    assert b64["g1"].dtype == torch.float32
    assert _lib.operands("test_b", _temporal_sources(m), temporal_operands) is b
    assert _lib.operands("test_f", _temporal_sources(m), temporal_operands) is f
    key = weakref.ref(m.conv1.conv.weight)
    del m, b, f
    gc.collect()
    assert key() is None


# -- the plans ----------------------------------------------------------------

def _f32_keys(name):
    """The f32 call shapes of kernel ``name`` that chip_smoke.py serves or
    gates: phase 19's two requests, F32_PARTIAL and the T=201 calls."""
    keys = {k for calls in cs.f32_calls().values() for (n, k) in calls if n == name}
    part = cs.F32_PARTIAL[name]
    if name == "fused_spatial_resblock":
        return sorted(keys | {part, cs.SPATIAL_LONG})
    if name == "parity_up2x_fused":
        return sorted({k[0] for k in keys} | {part, cs.PARITY_LONG})
    return sorted({k[0] for k in keys} | {part})


def _spatial_keys(which):
    if which == "f32":
        return _f32_keys("fused_spatial_resblock")
    if which == "serving":
        return [k for k, _ in cs.SPATIAL_SHAPES]
    if which == "long":
        return [k for k, _ in cs.long_spatial_shapes()] + [cs.SPATIAL_LONG]
    if which == "partial":
        return list(cs.PARTIAL_SPATIAL)
    if which in cs.CONFIG_PATHS:
        return [k for (name, k) in cs.model_calls(*cs.CONFIG_PATHS[which])
                if name == "fused_spatial_resblock"]
    t, size = {"tiled65": (65, 256), "tiled201": (201, 256),
               "tiled264": (cs.PARTIAL_REQUEST[2], cs.PARTIAL_REQUEST[3])}[which]
    return [k for (name, k) in cs.tiled_calls(t, size) if name == "fused_spatial_resblock"]


def _temporal_keys(which):
    """Kernel F's shapes (tiled, partial) and kernel B's (serving, its
    partial and two-clip shapes, and its calls in one non-tiled forward of
    LONG_REQUEST: TEMPORAL_SHAPES with their 20 frames scaled to 204)."""
    if which == "partial":
        return list(cs.PARTIAL_TEMPORAL)
    if which == "f32":
        return sorted(set(_f32_keys("fused_temporal_resblock"))
                      | set(_f32_keys("fused_temporal_resblock_stream")))
    if which == "b_serving":
        return [k for k, _ in cs.TEMPORAL_SHAPES] + [k for k in cs.TOOL_SHAPES]
    if which == "b_partial":
        return list(cs.PARTIAL_B)
    if which == "b_long":
        frames = cs.REQUEST[2] + cs.TDF - 1
        long_frames = cs.LONG_REQUEST[2] + cs.TDF - 1
        return [(b, t * long_frames // frames, h, w, c)
                for (b, t, h, w, c), _ in cs.TEMPORAL_SHAPES]
    if which in cs.CONFIG_PATHS:
        return sorted({k[0] for (name, k) in cs.model_calls(*cs.CONFIG_PATHS[which])
                       if name.startswith("fused_temporal_resblock")})
    t, size = {"tiled65": (65, 256), "tiled201": (201, 256),
               "tiled264": (cs.PARTIAL_REQUEST[2], cs.PARTIAL_REQUEST[3])}[which]
    return sorted({k[0] for (name, k) in cs.tiled_calls(t, size)
                   if name == "fused_temporal_resblock_stream"})


def _check_limits(pl, cout):
    """BN from {64, 128, 256}, N tiles that cover ``cout`` output channels
    (E: each parity's), dividing it where it is a multiple of 128 (the
    released widths keep whole tiles); the H100's limits."""
    assert pl.bn in (64, 128, 256) and pl.cout == cout
    assert pl.n_tiles == pl.parities * -(-cout // pl.bn)
    assert cout % 128 or cout % pl.bn == 0
    assert pl.smem <= plan.SMEM_LIMIT
    assert plan.BLOCKS_PER_SM * (pl.smem + 1024) <= plan.SMEM_PER_SM
    assert pl.smem >= plan.smem_bytes(pl.bn, pl.stages)
    assert pl.tiles == pl.m_tiles * pl.n_tiles <= plan.GRID_LIMIT
    assert 0 < pl.grid == min(pl.tiles, plan.SMS * plan.BLOCKS_PER_SM)
    assert pl.th * pl.tw == plan.BM


def _count(counts, idx):
    np.add.at(counts, idx, 1)


def _walk(pl):
    """The persistent walk (the union of every block's ``block + k *
    grid`` tiles), checked to take each tile exactly once; (tiles, their M
    tile, their N tile)."""
    walk = plan.walk(pl)
    assert len(walk) == pl.tiles
    assert (np.bincount(walk, minlength=pl.tiles) == 1).all()
    for block in (0, pl.grid - 1):
        tiles = plan.block_tiles(pl, block)
        assert tiles[0] == block and (np.diff(tiles) == pl.grid).all()
        assert tiles[-1] + pl.grid >= pl.tiles
    mt, nt = np.divmod(walk, pl.n_tiles)
    return walk, mt, nt


CHUNK = 4096  # blocks per numpy pass


@pytest.mark.parametrize("which", ["serving", "tiled65", "tiled201", "tiled264",
                                   "partial", "long", "f32"] + sorted(cs.CONFIG_PATHS))
def test_spatial_plans_cover_each_position_once(which):
    """Every output position of every frame in exactly one M tile of N tile
    0 (the N tiles repeat the M tiles) of the persistent walk, which takes
    each tile once, at every kernel-A call shape of the served paths
    (``f32``: the f32 plans of A's f32 call shapes). Shapes past 2M
    positions are checked on their first and last two frames, whose tiles
    the decode reaches last."""
    keys = _spatial_keys(which)
    assert keys
    for key in keys:
        n, h, w, cin, c = key
        cs_ = cin if cin != c else 0
        pl = plan.conv_plan_spatial(n, h, w, cin, c, cs_, which == "f32")
        _check_limits(pl, c)
        assert pl.tiles_x == -(-w // pl.tw) and pl.tiles_y == -(-h // pl.th)
        assert pl.m_tiles == n * pl.tiles_x * pl.tiles_y
        frames = range(n) if n * h * w <= 2_000_000 else [0, 1, n - 2, n - 1]
        per = pl.tiles_x * pl.tiles_y
        counts = np.zeros(len(frames) * h * w, np.int32)
        slot = {f: i for i, f in enumerate(frames)}
        walk, mt, nt = _walk(pl)
        tiles = walk[(nt == 0) & np.isin(mt // per, frames)]
        r = np.arange(plan.BM)
        for i in range(0, len(tiles), CHUNK):
            (img, y0, x0), n0 = plan.tile_origin(pl, tiles[i:i + CHUNK])
            assert (n0 == 0).all()
            y = y0[:, None] + r[None, :] // pl.tw
            x = x0[:, None] + r[None, :] % pl.tw
            ok = (y < h) & (x < w)
            s = np.vectorize(slot.get)(img)
            _count(counts, ((s[:, None] * h + y) * w + x)[ok])
        assert counts.min() == 1 and counts.max() == 1, key
        # the N tiles of one M tile: neighbouring blocks, every channel once
        _, n0s = plan.tile_origin(pl, np.arange(pl.n_tiles))
        assert sorted(n0s.tolist()) == list(range(0, c, pl.bn))


@pytest.mark.parametrize("which", ["tiled65", "tiled201", "tiled264", "partial",
                                   "b_serving", "b_partial", "b_long", "fsq_41616",
                                   "tiled_888", "kl_444", "f32"])
def test_temporal_plans_cover_each_row_once(which):
    """Every output row of every clip in exactly one M tile of the
    persistent walk, at every kernel-F call shape of the tiled paths and
    the partial shapes, and at every kernel-B shape served, gated or run at
    T=201 (``f32``: the f32 plans of B's and F's f32 call shapes)."""
    keys = _temporal_keys(which)
    assert keys
    for key in keys:
        b, t, h, w, c = key
        pl = plan.conv_plan_temporal(b, t, h * w, c, which == "f32")
        _check_limits(pl, c)
        rows = t * h * w
        assert pl.tiles_x * plan.BM >= rows > (pl.tiles_x - 1) * plan.BM
        walk, _, nt = _walk(pl)
        (clip, r0), n0 = plan.tile_origin(pl, walk[nt == 0])
        rr = r0[:, None] + np.arange(plan.BM)[None, :]
        ok = rr < rows
        counts = np.zeros(b * rows, np.int32)
        _count(counts, (clip[:, None] * rows + rr)[ok])
        assert (n0 == 0).all() and counts.min() == 1 and counts.max() == 1, key


def _parity_keys(which):
    if which == "f32":
        return _f32_keys("parity_up2x_fused")
    return {"serving": [k for k, _ in cs.PARITY_SHAPES],
            "partial": list(cs.PARTIAL_PARITY), "long": [cs.PARITY_LONG]}[which]


@pytest.mark.parametrize("which", ["serving", "partial", "long", "f32"])
def test_parity_plans_cover_each_output_once(which):
    """Kernel E: every position of each input frame in exactly one M tile
    per N tile, so every position of both output frames (2a: the N tiles
    below C, 2a+1: those from C) in C / BN blocks, whose columns are each
    parity's C channels once, over the persistent walk. At every E shape
    served, gated at partial tiles and with two clips, and at its T=201
    call (whose first and last two input frames are checked)."""
    for key in _parity_keys(which):
        b, t, h, w, c = key
        pl = plan.conv_plan_parity(b, t, h, w, c, which == "f32")
        _check_limits(pl, c)
        assert pl.taps == "parity" and pl.parities == 2
        per = pl.tiles_x * pl.tiles_y
        assert pl.tiles_x == -(-w // pl.tw) and pl.tiles_y == -(-h // pl.th)
        assert pl.m_tiles == b * t * per
        n = b * t
        frames = range(n) if n * h * w <= 1_000_000 else [0, 1, n - 2, n - 1]
        slot = {f: i for i, f in enumerate(frames)}
        counts = np.zeros(len(frames) * 2 * h * w, np.int32)
        walk, mt, _ = _walk(pl)
        tiles = walk[np.isin(mt // per, frames)]
        r = np.arange(plan.BM)
        for i in range(0, len(tiles), CHUNK):
            (img, y0, x0), n0 = plan.tile_origin(pl, tiles[i:i + CHUNK])
            par = (n0 >= c).astype(np.int64)
            y = y0[:, None] + r[None, :] // pl.tw
            x = x0[:, None] + r[None, :] % pl.tw
            ok = (y < h) & (x < w)
            out_frame = np.vectorize(slot.get)(img) * 2 + par
            _count(counts, ((out_frame[:, None] * h + y) * w + x)[ok])
        assert counts.min() == counts.max() == pl.n_tiles // 2, key
        _, n0s = plan.tile_origin(pl, np.arange(pl.n_tiles))
        for par in (0, 1):
            cols = sorted(n0 - par * c for n0 in n0s.tolist() if (n0 >= c) == par)
            assert cols == list(range(0, c, pl.bn)), key


@pytest.mark.parametrize("name", ["fused_spatial_resblock", "fused_temporal_resblock",
                                  "fused_temporal_resblock_stream", "parity_up2x_fused"])
def test_f32_plans_are_the_bf16_plans_with_pieces(name):
    """Under the f32 scheme a ring stage holds the bytes it holds in bf16
    (the K steps are 6x, 6 products), so A, B, E and F's f32 plans are
    their bf16 plans (tiles, BN, stages, shared memory, grid) with an A
    operand of the activation's 3 bf16 pieces side by side, at every f32
    call shape chip_smoke.py serves or gates."""
    assert len(PRODUCTS) == 6 and PIECES == 3
    for key in _f32_keys(name):
        if name == "fused_spatial_resblock":
            n, h, w, cin, c = key
            # conv2's taps, the 1x1 term's columns after
            taps, tap_c, cs = 9, c, (cin if cin != c else 0)
            args = (n, h, w, cin, c, cs)
            p16, p32 = plan.conv_plan_spatial(*args), plan.conv_plan_spatial(*args, True)
        elif name == "parity_up2x_fused":
            cin = c = tap_c = key[-1]
            taps, cs = 18, 0
            p16, p32 = plan.conv_plan_parity(*key), plan.conv_plan_parity(*key, True)
        else:
            b, t, h, w, cin = key
            c = tap_c = cin
            taps, cs = 3, 0
            p16 = plan.conv_plan_temporal(b, t, h * w, c)
            p32 = plan.conv_plan_temporal(b, t, h * w, c, True)
        _check_limits(p32, c)
        assert (p16.a_channels, p32.a_channels) == (cin, PIECES * cin), key
        assert dataclasses.replace(p32, a_channels=cin) == p16, key
        # whole K steps in each product: 64-channel boxes, each (tap,
        # channel) of the product's columns in exactly one of them
        reads = plan.k_step_reads(taps, tap_c, cs)
        assert all(0 < c1 - c0 <= plan.BK and c0 % plan.BK == 0 for _, c0, c1 in reads)
        assert sum(c1 - c0 for _, c0, c1 in reads) == taps * tap_c + cs, key


@pytest.mark.parametrize("key", sorted(
    {k[0] for calls in cs.f32_calls().values() for (n, k) in calls
     if n in ("decoder_tail_rgb", "decoder_tail_rgb_taps")}
    | {cs.F32_PARTIAL["decoder_tail_rgb"], cs.TAIL_LONG, (1, 7, 40, 50, 64)}))
def test_tail_f32_plan_covers_each_output_once(key):
    """Kernels D's and D''s f32 form: tail_plan's blocks (every output
    position of every frame of every clip in exactly one block's patch and
    run, each frame read from two before its run's first) at the f32 call
    shapes chip_smoke.py serves (phase 19's requests in every form, the
    partial shape, the T=201 call) and at 64 channels; the raw stages and
    the shared memory within a block's limit, one block per SM."""
    b, t, h, w, c = key
    pl, p16 = plan.tail_plan_f32(*key), plan.tail_plan(*key)
    assert dataclasses.replace(pl, stages=p16.stages, smem=p16.smem) == p16
    assert 2 <= pl.stages <= plan.TAIL_MAX_STAGES
    assert pl.smem == plan.tail_f32_smem_bytes(c, pl.stages) <= plan.SMEM_LIMIT
    assert plan.tail_f32_smem_bytes(c, pl.stages + 1) > plan.SMEM_LIMIT or \
        pl.stages == plan.TAIL_MAX_STAGES
    assert plan.TAIL_BLOCKS_PER_SM * (pl.smem + 1024) <= plan.SMEM_PER_SM
    assert 0 < pl.grid == b * pl.tiles_x * pl.tiles_y * pl.runs <= plan.GRID_LIMIT
    counts = np.zeros((b, t, pl.tiles_y, pl.tiles_x), np.int32)
    for block in range(pl.grid):
        clip, y0, x0, t0, t1, first = plan.tail_block(pl, block, t)
        assert 0 <= t0 < t1 <= t and first == max(t0 - plan.TAIL_WARMUP, 0)
        counts[clip, t0:t1, y0 // pl.th, x0 // pl.tw] += 1
    assert (counts == 1).all(), key
    assert pl.tiles_x * pl.tw >= w > (pl.tiles_x - 1) * pl.tw
    assert pl.tiles_y * pl.th >= h > (pl.tiles_y - 1) * pl.th


def test_tail_f32_plan_refusals():
    """The f32 tail refuses a width outside the kernels' domain (C % 8 != 0:
    TMA's 16-byte strides; C > 1024) and empty clips; 32 and 256 channels,
    which it refused before its channel groups, it takes."""
    for shape, match in ((1, 4, 8, 8, 36), "C % 8 == 0, got C=36: TMA"), \
            ((1, 4, 8, 8, 1032), "C <= 1024"), ((1, 0, 8, 8, 128), "empty"):
        with pytest.raises(ValueError, match=match):
            plan.tail_plan_f32(*shape)
    assert plan.tail_plan_f32(1, 4, 8, 8, 32).groups == 1
    assert plan.tail_plan_f32(1, 4, 8, 8, 256).groups == 2


def test_plan_picks():
    """BN 256 only where the tiles still fill the card; the patch with the
    fewest tiles; the ring's stages by BN; the grid one block a tile below
    the card's slots (SMS x BLOCKS_PER_SM), the slots above."""
    small = plan.conv_plan_spatial(5, 32, 32, 512, 512)
    assert (small.bn, small.tiles, small.grid, small.stages) == (128, 160, 132, 6)
    big = plan.conv_plan_spatial(5, 64, 64, 512, 512)
    assert (big.bn, big.tiles, big.grid, big.stages) == (256, 320, 132, 4)
    a = plan.conv_plan_spatial(20, 256, 256, 128, 128)
    assert (a.bn, a.tiles, a.grid) == (128, 20 * 512, 132)
    assert (plan.conv_plan_spatial(1, 4, 128, 64, 128).th,
            plan.conv_plan_spatial(1, 4, 128, 64, 128).tw) == (4, 32)
    t = plan.conv_plan_temporal(1, 2, 32 * 32, 512)
    assert t.tiles == t.grid == 16 * 4
    # E: 10,240 and 2,560 tiles at BN 256, a block an SM; BN 128 where C is 128
    e = plan.conv_plan_parity(1, 10, 256, 256, 256)
    assert (e.bn, e.tiles, e.grid, e.n_tiles, e.th, e.tw) == (256, 10240, 132, 2, 8, 16)
    e = plan.conv_plan_parity(1, 5, 128, 128, 512)
    assert (e.bn, e.tiles, e.grid) == (256, 2560, 132)
    assert plan.conv_plan_parity(4, 10, 64, 64, 128).bn == 128


@pytest.mark.parametrize("key,tiles", [
    ((1, 8, 8, 128, 128), 1), ((1, 16, 16, 512, 512), 8), ((5, 32, 32, 512, 512), 160),
    ((20, 256, 256, 128, 128), 10_240), ((204, 256, 256, 128, 128), 104_448),
    ((10, 64, 64, 256, 256), 320)])
def test_persistent_grid(key, tiles):
    """The grid never exceeds the card's slots (SMS x blocks a SM); a
    launch with fewer tiles than slots runs one tile a block,
    as the loop did before it walked; a larger one walks every tile once,
    each block ceil or floor(tiles / grid) of them."""
    pl = plan.conv_plan_spatial(*key)
    slots = plan.SMS * plan.BLOCKS_PER_SM
    assert pl.tiles == tiles and pl.grid == min(tiles, slots) <= slots
    per_block = [len(plan.block_tiles(pl, b)) for b in range(pl.grid)]
    if tiles <= slots:
        assert per_block == [1] * tiles
    else:
        assert {min(per_block), max(per_block)} <= {tiles // pl.grid, -(-tiles // pl.grid)}
    assert sum(per_block) == tiles and sorted(plan.walk(pl)) == list(range(tiles))


@pytest.mark.parametrize("key,frame_tiles", [
    ((1, 20, 256 * 256, 128), 512), ((1, 204, 128 * 128, 256), 128), ((2, 5, 32 * 32, 512), 8),
    ((2, 5, 33 * 33, 512), 0), ((1, 9, 3 * 3, 128), 0)])
def test_temporal_walk_goes_band_by_band(key, frame_tiles):
    """Where a frame is whole M tiles (S % BM == 0) a temporal clip is
    walked band by band, the frames of a band fastest, so a tile's three
    taps read frames its neighbours in the walk read too (wgmma_conv.cuh:
    tile_at); otherwise in row order. Either way every row once (the
    coverage tests)."""
    b, t, s, c = key
    pl = plan.conv_plan_temporal(*key)
    assert pl.frame_tiles == frame_tiles
    (clip, r0), _ = plan.tile_origin(pl, np.arange(pl.tiles))
    mt = np.arange(pl.tiles) // pl.n_tiles
    assert (clip == mt // pl.tiles_x).all()
    rt = mt % pl.tiles_x
    if frame_tiles:
        assert pl.tiles_x == t * frame_tiles
        assert (r0 // s == rt % t).all() and ((r0 % s) // plan.BM == rt // t).all()
    else:
        assert (r0 == rt * plan.BM).all()
    counts = np.zeros(b * t * s, np.int32)
    rows = (clip * t * s + r0)[:, None] + np.arange(plan.BM)[None, :]
    _count(counts, rows[(r0[:, None] + np.arange(plan.BM)[None, :]) < t * s])
    assert (counts == pl.n_tiles).all()


STAGING_SOURCE = re.compile(r"constexpr int kChunk = (\d+);")


@pytest.mark.parametrize("bn", [64, 128, 256])
def test_shared_memory_layout_fits(bn):
    """At BN 64, 128 and 256 the block's shared memory (1 KB of alignment,
    the ring of STAGES[bn] stages, the epilogue's own staging, two barriers
    a stage) fits a block's limit, BLOCKS_PER_SM blocks fit an SM, and
    the staging is the one ``wgmma_conv.cuh`` lays out: 2 consumer
    warpgroups x 64 rows x a chunk of columns, f32."""
    stages = plan.STAGES[bn]
    smem = plan.smem_bytes(bn, stages)
    assert smem == 1024 + stages * plan.stage_bytes(bn) + plan.STAGING_BYTES + 16 * stages
    assert smem <= plan.SMEM_LIMIT
    assert plan.BLOCKS_PER_SM * (smem + 1024) <= plan.SMEM_PER_SM
    src = (Path(_lib.CSRC) / "wgmma_conv.cuh").read_text()
    chunk = int(STAGING_SOURCE.search(src).group(1))
    assert chunk == plan.EPILOGUE_CHUNK and bn % chunk == 0
    assert plan.STAGING_BYTES == 2 * 64 * chunk * 4
    assert "constexpr int kBlocksPerSM = 1;" in src
    assert plan.BLOCKS_PER_SM == 1


# -- refusals -------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _spatial_args(cin, c, nin):
    return (_meta(1, 8, 8, cin), (_meta(cin), _meta(cin)), (_meta(c, cin, 3, 3), _meta(c)),
            (_meta(c), _meta(c)), (_meta(c, c, 3, 3), _meta(c)),
            (_meta(c, cin, 1, 1), _meta(c)) if nin else None)


def _stream_args(c):
    return (_meta(1, 2, 8, 8, c), (_meta(c), _meta(c)), (_meta(c, c, 3), _meta(c)),
            (_meta(c), _meta(c)), (_meta(c, c, 3), _meta(c)), None, None, True, 1)


def _temporal_args(c):
    return (_meta(1, 2, 8, 8, c), (_meta(c), _meta(c)), (_meta(c, c, 3), _meta(c)),
            (_meta(c), _meta(c)), (_meta(c, c, 3), _meta(c)), "zero")


def _parity_args(c):
    return (_meta(1, 2, 8, 8, c), _meta(c, c, 3, 3, 3), _meta(c), _meta(1), "zero")


@pytest.mark.parametrize("name,args,match", [
    ("fused_spatial_resblock", _spatial_args(100, 128, True), "Cin % 8 == 0, got Cin=100"),
    ("fused_spatial_resblock", _spatial_args(128, 196, True), "Cout % 8 == 0, got Cout=196"),
    ("fused_spatial_resblock", _spatial_args(1280, 1280, False), "Cin <= 1024"),
    ("fused_spatial_resblock", _spatial_args(128, 256, True), "CUDA tensor"),
    ("fused_spatial_resblock", _spatial_args(96, 128, True), "CUDA tensor"),
    ("fused_spatial_resblock", _spatial_args(96, 192, True), "CUDA tensor"),
    ("fused_spatial_resblock", _spatial_args(32, 32, False), "CUDA tensor"),
    ("fused_temporal_resblock_stream", _stream_args(196), "multiple of 16 bytes"),
    ("fused_temporal_resblock_stream", _stream_args(1280), "<= 1024"),
    ("fused_temporal_resblock_stream", _stream_args(128), "CUDA tensor"),
    ("fused_temporal_resblock_stream", _stream_args(192), "CUDA tensor"),
    ("fused_temporal_resblock", _temporal_args(196), "% 8 == 0, got Cin=196"),
    ("fused_temporal_resblock", _temporal_args(1280), "<= 1024"),
    ("fused_temporal_resblock", _temporal_args(128), "CUDA tensor"),
    ("fused_temporal_resblock", _temporal_args(192), "CUDA tensor"),
    ("parity_up2x_fused", _parity_args(196), "C % 8 == 0, got C=196"),
    ("parity_up2x_fused", _parity_args(256), "CUDA tensor"),
    ("parity_up2x_fused", _parity_args(192), "CUDA tensor"),
])
def test_wrappers_refuse_what_the_plan_cannot_take(name, args, match):
    """Off the CPU, A, B, E and F raise on a shape their plan refuses before
    they look at the device; a shape the plan takes goes on to the device
    check.
    Nothing is launched and no plain version runs."""
    fn = K.WRAPPERS[name]
    K.reset_counts()
    with pytest.raises(ValueError, match=match):
        fn(*args)
    assert K.counts("calls")[name] == 1 and K.counts()[name] == 0


CONV_WRAPPERS = {  # name: (plan function, arguments, conv launches a call)
    "fused_spatial_resblock": ("conv_plan_spatial", _spatial_args(64, 128, True), 2),
    "fused_temporal_resblock": ("conv_plan_temporal", _temporal_args(128), 2),
    "fused_temporal_resblock_stream": ("conv_plan_temporal", _stream_args(128), 2),
    "parity_up2x_fused": ("conv_plan_parity", _parity_args(128), 1),
}


@pytest.mark.parametrize("name", sorted(CONV_WRAPPERS))
def test_wrappers_count_conv_tiles_and_blocks(name, monkeypatch):
    """A, B, E and F add their plan's tiles and grid, once per conv launch,
    to ``conv_tiles`` and ``conv_blocks`` (a stub plan: 1,000 tiles on 7
    blocks), and ``reset_counts()`` zeroes both. The meta device stands in
    for a card, with the launch and the device checks stubbed out."""
    fn_name, args, convs = CONV_WRAPPERS[name]
    real = getattr(plan, fn_name)
    stub = {}

    def stub_plan(*a, **k):
        pl = real(*a, **k)
        stub["plan"] = dataclasses.replace(pl, m_tiles=1000 // pl.n_tiles, grid=7)
        return stub["plan"]

    monkeypatch.setattr(plan, fn_name, stub_plan)
    monkeypatch.setattr(_lib, "operands", lambda kind, sources, build: build(*sources))
    monkeypatch.setattr(_lib, "weight_maps", lambda op, bn, *names: (None,) * len(names))
    for check in ("require", "same_device", "call"):
        monkeypatch.setattr(_lib, check, lambda *a, **k: None)
    fn = K.WRAPPERS[name]
    K.reset_counts()
    fn(*args)
    fn(*args)
    pl = stub["plan"]
    assert (fn.launches, fn.conv_tiles, fn.conv_blocks) == (
        2, 2 * convs * pl.tiles, 2 * convs * 7)
    assert pl.tiles in (1000, 999)  # whole N tiles
    others = [n for n in K.WRAPPERS if n != name]
    assert not any(K.counts("conv_tiles")[n] or K.counts("conv_blocks")[n] for n in others)
    K.reset_counts()
    assert not any(K.counts("conv_tiles").values()) and not any(K.counts("conv_blocks").values())


def test_plan_refuses_empty_and_odd_shapes():
    with pytest.raises(ValueError, match="Cs % 8"):
        plan.conv_plan_spatial(1, 8, 8, 128, 128, cs=36)
    assert plan.conv_plan_spatial(1, 8, 8, 128, 128, cs=32).bn == 128
    with pytest.raises(ValueError, match="empty"):
        plan.conv_plan_spatial(0, 8, 8, 128, 128)
    with pytest.raises(ValueError, match="empty"):
        plan.conv_plan_temporal(1, 0, 64, 128)
    with pytest.raises(ValueError, match="empty"):
        plan.conv_plan_parity(1, 2, 0, 8, 128)
    for c in range(8, plan.C_MAX + 1, 8):
        plan.check_row_channels(c)
    for c in (4, 12, 1032):
        with pytest.raises(ValueError, match="the kernels take C"):
            plan.check_row_channels(c)


# -- the temporal microbenchmark's products (T1 dense, T2 mm temporal) -------

TOOL_PLANS = {
    # shape: (dense (bn, tiles, grid, stages, smem), T2's temporal (bn, tiles, grid))
    (1, 9, 64, 64, 512): ((256, 576, 132, 4, 230_464), (256, 576, 132)),
    (1, 20, 256, 256, 128): ((128, 10_240, 132, 6, 230_496), (128, 10_240, 132)),
    (2, 5, 33, 33, 256): ((128, 172, 132, 6, 230_496), (128, 172, 132)),
}


@pytest.mark.parametrize("shape", list(cs.TOOL_SHAPES) + [cs.TOOL_PARTIAL])
def test_tool_plans(shape):
    """T1's dense plan (``[M, 3C] x [3C, C]``) and T2 ``mm``'s temporal
    plan at the tools' shapes and the two-clip partial one: BN, grid,
    stages and shared memory as the picks give them, within the H100's
    limits, every output row in exactly one M tile (T2: per clip; M tiles
    straddle frames where S % 128 != 0)."""
    assert set(TOOL_PLANS) == set(cs.TOOL_SHAPES) | {cs.TOOL_PARTIAL}
    b, t, h, w, c = shape
    m = b * t * h * w
    (bn, tiles, grid, stages, smem), (tbn, ttiles, tgrid) = TOOL_PLANS[shape]
    dense = plan.conv_plan_dense(m, 3 * c, c)
    _check_limits(dense, c)
    assert (dense.taps, dense.bn, dense.tiles, dense.grid, dense.stages, dense.smem) == (
        "dense", bn, tiles, grid, stages, smem)
    assert dense.m_tiles == dense.tiles_x == -(-m // plan.BM)
    walk, _, nt = _walk(dense)
    (clip, r0), n0 = plan.tile_origin(dense, walk[nt == 0])
    assert (clip == 0).all() and (n0 == 0).all()
    rr = r0[:, None] + np.arange(plan.BM)[None, :]
    counts = np.zeros(m, np.int32)
    _count(counts, rr[rr < m])
    assert counts.min() == counts.max() == 1
    temporal = plan.conv_plan_temporal(b, t, h * w, c)
    _check_limits(temporal, c)
    assert (temporal.bn, temporal.tiles, temporal.grid, temporal.stages) == (
        tbn, ttiles, tgrid, plan.STAGES[tbn])
    _walk(temporal)
    assert temporal.tiles_x == -(-t * h * w // plan.BM)
    _, n0s = plan.tile_origin(dense, np.arange(dense.n_tiles))
    assert sorted(n0s.tolist()) == list(range(0, c, dense.bn))


@pytest.mark.parametrize("args,match", [
    ((100, 100, 128), "K % 8"),
    ((100, 384, 196), "Cout % 8"),
    ((0, 384, 128), "empty"),
    ((plan.ROW_COORD_LIMIT + 1, 384, 128), "row coordinate"),
])
def test_dense_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        plan.conv_plan_dense(*args)
    assert plan.conv_plan_dense(plan.ROW_COORD_LIMIT, 384, 128).bn == 128
    # the widths refused before partial K steps and N tiles
    assert plan.conv_plan_dense(100, 96, 128).n_tiles == 1
    assert plan.conv_plan_dense(100, 384, 192).n_tiles == 3


def test_temporal_plan_refuses_a_clip_past_the_row_coordinate():
    """A clip (with B's and F's 2-frame front) must stay inside TMA's
    32-bit row coordinate."""
    s = 2 ** 20
    with pytest.raises(ValueError, match="row coordinate"):
        plan.conv_plan_temporal(1, 2 ** 31 // s - 1, s, 128)
    assert plan.conv_plan_temporal(1, 2 ** 31 // s - 3, s, 128).bn == 128
