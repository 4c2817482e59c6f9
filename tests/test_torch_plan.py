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
import weakref

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
    assert pl.bn in (128, 256) and cout % pl.bn == 0 and pl.n_tiles * pl.bn == cout
    assert pl.smem <= plan.SMEM_LIMIT
    assert plan.BLOCKS_PER_SM[pl.bn] * (pl.smem + 1024) <= plan.SMEM_PER_SM
    assert pl.smem >= plan.smem_bytes(pl.bn, pl.stages)
    assert pl.stages * plan.stage_bytes(pl.bn) >= plan.epilogue_bytes(pl.bn)
    assert 0 < pl.grid <= plan.GRID_LIMIT and pl.grid == pl.m_tiles * pl.n_tiles
    assert pl.th * pl.tw == plan.BM


def _count(counts, idx):
    np.add.at(counts, idx, 1)


CHUNK = 4096  # blocks per numpy pass


@pytest.mark.parametrize("which", ["serving", "tiled65", "tiled201", "tiled264",
                                   "partial", "long", "f32"] + sorted(cs.CONFIG_PATHS))
def test_spatial_plans_cover_each_position_once(which):
    """Every output position of every frame in exactly one M tile of N tile
    0 (the N tiles repeat the M tiles), at every kernel-A call shape of the
    served paths (``f32``: the f32 plans of A's f32 call shapes). Shapes
    past 2M positions are checked on their first and last two frames, whose
    tiles the decode reaches last."""
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
        blocks = np.concatenate([np.arange(f * per, (f + 1) * per) for f in frames])
        r = np.arange(plan.BM)
        for i in range(0, len(blocks), CHUNK):
            (img, y0, x0), n0 = plan.tile_origin(pl, blocks[i:i + CHUNK] * pl.n_tiles)
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
    """Every output row of every clip in exactly one M tile, at every
    kernel-F call shape of the tiled paths and the partial shapes, and at
    every kernel-B shape served, gated or run at T=201 (``f32``: the f32
    plans of B's and F's f32 call shapes)."""
    keys = _temporal_keys(which)
    assert keys
    for key in keys:
        b, t, h, w, c = key
        pl = plan.conv_plan_temporal(b, t, h * w, c, which == "f32")
        _check_limits(pl, c)
        rows = t * h * w
        assert pl.tiles_x * plan.BM >= rows > (pl.tiles_x - 1) * plan.BM
        (clip, r0), n0 = plan.tile_origin(pl, np.arange(0, pl.grid, pl.n_tiles))
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
    parity's C channels once. At every E shape served, gated at partial
    tiles and with two clips, and at its T=201 call (whose first and last
    two input frames are checked)."""
    for key in _parity_keys(which):
        b, t, h, w, c = key
        pl = plan.conv_plan_parity(b, t, h, w, c, which == "f32")
        _check_limits(pl, 2 * c)
        assert pl.taps == "parity" and c % pl.bn == 0
        per = pl.tiles_x * pl.tiles_y
        assert pl.tiles_x == -(-w // pl.tw) and pl.tiles_y == -(-h // pl.th)
        assert pl.m_tiles == b * t * per
        n = b * t
        frames = range(n) if n * h * w <= 1_000_000 else [0, 1, n - 2, n - 1]
        slot = {f: i for i, f in enumerate(frames)}
        counts = np.zeros(len(frames) * 2 * h * w, np.int32)
        blocks = np.concatenate([np.arange(f * per * pl.n_tiles, (f + 1) * per * pl.n_tiles)
                                 for f in frames])
        r = np.arange(plan.BM)
        for i in range(0, len(blocks), CHUNK):
            (img, y0, x0), n0 = plan.tile_origin(pl, blocks[i:i + CHUNK])
            par = (n0 >= c).astype(np.int64)
            y = y0[:, None] + r[None, :] // pl.tw
            x = x0[:, None] + r[None, :] % pl.tw
            ok = (y < h) & (x < w)
            out_frame = np.vectorize(slot.get)(img) * 2 + par
            _count(counts, ((out_frame[:, None] * h + y) * w + x)[ok])
        assert counts.min() == counts.max() == c // pl.bn, key
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
            k_base = 9 * c + (cin if cin != c else 0)  # conv2's, the 1x1 term's columns after
            args = (n, h, w, cin, c, cin if cin != c else 0)
            p16, p32 = plan.conv_plan_spatial(*args), plan.conv_plan_spatial(*args, True)
        elif name == "parity_up2x_fused":
            cin, c, k_base = key[-1], 2 * key[-1], 18 * key[-1]
            p16, p32 = plan.conv_plan_parity(*key), plan.conv_plan_parity(*key, True)
        else:
            b, t, h, w, cin = key
            c, k_base = cin, 3 * cin
            p16 = plan.conv_plan_temporal(b, t, h * w, c)
            p32 = plan.conv_plan_temporal(b, t, h * w, c, True)
        _check_limits(p32, c)
        assert (p16.a_channels, p32.a_channels) == (cin, PIECES * cin), key
        assert dataclasses.replace(p32, a_channels=cin) == p16, key
        assert k_base % plan.BK == 0, key  # whole K steps in each product


@pytest.mark.parametrize("key", sorted(
    {k[0] for calls in cs.f32_calls().values() for (n, k) in calls if n == "decoder_tail_rgb"}
    | {cs.F32_PARTIAL["decoder_tail_rgb"], cs.TAIL_LONG, (1, 7, 40, 50, 64)}))
def test_tail_f32_plan_covers_each_output_once(key):
    """Kernel D's f32 form: every output position of every frame of every
    clip in exactly one block's patch, at D's f32 call shapes (phase 19's
    requests, its partial shape, its T=201 call) and at 64 channels;
    shared memory within a block's limit."""
    b, t, h, w, c = key
    pl = plan.tail_plan_f32(*key)
    assert (pl.th, pl.tw) == (plan.TAIL_F32_TH, plan.TAIL_F32_TW)
    assert pl.smem == plan.tail_f32_smem_bytes(c) <= plan.SMEM_LIMIT
    assert pl.grid == b * t * pl.tiles_x * pl.tiles_y <= plan.GRID_LIMIT
    assert plan.TAIL_F32_THREADS * plan.TAIL_F32_PX == pl.th * pl.tw
    blocks = np.arange(pl.grid)
    if pl.grid > 200_000:  # the first and last two frames of each clip
        blocks = blocks[np.isin(blocks % t, [0, 1, t - 2, t - 1])]
    clip, y0, x0, f = plan.tail_f32_block(pl, blocks, t)
    frames = np.unique(f)
    slot = np.searchsorted(frames, f)
    counts = np.zeros((b, len(frames), h, w), np.int32)
    r = np.arange(pl.th * pl.tw)
    y = y0[:, None] + r[None, :] // pl.tw
    x = x0[:, None] + r[None, :] % pl.tw
    ok = (y < h) & (x < w)
    _count(counts, (np.broadcast_to(clip[:, None], y.shape)[ok],
                    np.broadcast_to(slot[:, None], y.shape)[ok], y[ok], x[ok]))
    assert counts.min() == counts.max() == 1, key


def test_tail_f32_plan_refusals():
    for shape, match in ((1, 4, 8, 8, 32), "C in"), ((1, 4, 8, 8, 256), "C in"), \
            ((1, 0, 8, 8, 128), "empty"):
        with pytest.raises(ValueError, match=match):
            plan.tail_plan_f32(*shape)


def test_plan_picks():
    """BN 256 only where the grid still fills the card; the patch with the
    fewest tiles; the ring's stages by BN."""
    small = plan.conv_plan_spatial(5, 32, 32, 512, 512)
    assert (small.bn, small.grid, small.stages) == (128, 160, 3)
    big = plan.conv_plan_spatial(5, 64, 64, 512, 512)
    assert (big.bn, big.grid, big.stages) == (256, 320, 4)
    assert plan.conv_plan_spatial(20, 256, 256, 128, 128).bn == 128
    assert (plan.conv_plan_spatial(1, 4, 128, 64, 128).th,
            plan.conv_plan_spatial(1, 4, 128, 64, 128).tw) == (4, 32)
    assert plan.conv_plan_temporal(1, 2, 32 * 32, 512).grid == 16 * 4
    # E: 10,240 and 2,560 blocks at BN 256; BN 128 where C is 128
    e = plan.conv_plan_parity(1, 10, 256, 256, 256)
    assert (e.bn, e.grid, e.n_tiles, e.th, e.tw) == (256, 10240, 2, 8, 16)
    assert (plan.conv_plan_parity(1, 5, 128, 128, 512).bn,
            plan.conv_plan_parity(1, 5, 128, 128, 512).grid) == (256, 2560)
    assert plan.conv_plan_parity(4, 10, 64, 64, 128).bn == 128


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
    ("fused_spatial_resblock", _spatial_args(96, 128, True), "Cin % 64"),
    ("fused_spatial_resblock", _spatial_args(128, 192, True), "Cout % 128"),
    ("fused_spatial_resblock", _spatial_args(1280, 1280, False), "row pass"),
    ("fused_spatial_resblock", _spatial_args(128, 256, True), "CUDA tensor"),
    ("fused_temporal_resblock_stream", _stream_args(192), "Cout % 128"),
    ("fused_temporal_resblock_stream", _stream_args(1280), "row pass"),
    ("fused_temporal_resblock_stream", _stream_args(128), "CUDA tensor"),
    ("fused_temporal_resblock", _temporal_args(192), "Cout % 128"),
    ("fused_temporal_resblock", _temporal_args(1280), "row pass"),
    ("fused_temporal_resblock", _temporal_args(128), "CUDA tensor"),
    ("parity_up2x_fused", _parity_args(192), "C % 128"),
    ("parity_up2x_fused", _parity_args(256), "CUDA tensor"),
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


def test_plan_refuses_empty_and_odd_shapes():
    with pytest.raises(ValueError, match="Cin % 64"):
        plan.conv_plan_spatial(1, 8, 8, 128, 128, cs=32)
    with pytest.raises(ValueError, match="empty"):
        plan.conv_plan_spatial(0, 8, 8, 128, 128)
    with pytest.raises(ValueError, match="empty"):
        plan.conv_plan_temporal(1, 0, 64, 128)
    with pytest.raises(ValueError, match="empty"):
        plan.conv_plan_parity(1, 2, 0, 8, 128)
    for c in plan.ROW_CHANNELS:
        plan.check_row_channels(c)


# -- the temporal microbenchmark's products (T1 dense, T2 mm temporal) -------

TOOL_PLANS = {
    # shape: (dense (bn, grid, stages, smem), T2's temporal (bn, grid))
    (1, 9, 64, 64, 512): ((256, 576, 4, 197_696), (256, 576)),
    (1, 20, 256, 256, 128): ((128, 10_240, 3, 99_376), (128, 10_240)),
    (2, 5, 33, 33, 256): ((128, 172, 3, 99_376), (128, 172)),
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
    (bn, grid, stages, smem), (tbn, tgrid) = TOOL_PLANS[shape]
    dense = plan.conv_plan_dense(m, 3 * c, c)
    _check_limits(dense, c)
    assert (dense.taps, dense.bn, dense.grid, dense.stages, dense.smem) == (
        "dense", bn, grid, stages, smem)
    assert dense.m_tiles == dense.tiles_x == -(-m // plan.BM)
    (clip, r0), n0 = plan.tile_origin(dense, np.arange(0, dense.grid, dense.n_tiles))
    assert (clip == 0).all() and (n0 == 0).all()
    rr = r0[:, None] + np.arange(plan.BM)[None, :]
    counts = np.zeros(m, np.int32)
    _count(counts, rr[rr < m])
    assert counts.min() == counts.max() == 1
    temporal = plan.conv_plan_temporal(b, t, h * w, c)
    _check_limits(temporal, c)
    assert (temporal.bn, temporal.grid, temporal.stages) == (tbn, tgrid, plan.STAGES[tbn])
    assert temporal.tiles_x == -(-t * h * w // plan.BM)
    _, n0s = plan.tile_origin(dense, np.arange(dense.n_tiles))
    assert sorted(n0s.tolist()) == list(range(0, c, dense.bn))


@pytest.mark.parametrize("args,match", [
    ((100, 96, 128), "Cin % 64"),
    ((100, 384, 192), "Cout % 128"),
    ((0, 384, 128), "empty"),
    ((plan.ROW_COORD_LIMIT + 1, 384, 128), "row coordinate"),
])
def test_dense_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        plan.conv_plan_dense(*args)
    assert plan.conv_plan_dense(plan.ROW_COORD_LIMIT, 384, 128).bn == 128


def test_temporal_plan_refuses_a_clip_past_the_row_coordinate():
    """A clip (with B's and F's 2-frame front) must stay inside TMA's
    32-bit row coordinate."""
    s = 2 ** 20
    with pytest.raises(ValueError, match="row coordinate"):
        plan.conv_plan_temporal(1, 2 ** 31 // s - 1, s, 128)
    assert plan.conv_plan_temporal(1, 2 ** 31 // s - 3, s, 128).bn == 128
