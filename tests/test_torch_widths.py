"""Every channel width the port's kernels take: C % 8 == 0, 8 <= C <= 1024.

Kernels A, B, E, F, D and D' take any such C, Cin and Cout alike, with
partial K steps and N tiles in the wgmma loop, masked vectors in the row
passes and a partial last box (past 128 channels: channel groups) in the
decoder tail. The kernels run only on the card (``chip_smoke`` phases 2
and 20); here, on the CPU:

* the plans at every C of the domain (A also with Cin != Cout): no
  refusal, shared memory and grid within the H100's limits, the N tiles and
  K steps covering the channels exactly once as the kernels decode them
  (``plan.tile_columns``, ``plan.k_step_reads``), the row layout and the
  tail's channel groups; C % 8 != 0 and C > 1024 refused with the reason;
* the operands as the loop reads them: the weights the wrappers' own
  operand functions build, read box by box through their tensor maps'
  layouts (``_lib.weight_layout``: 64 channels of one tap, one piece, BN
  rows of one parity, TMA's zero fill past the true extents), the
  activations box by box from their piece planes, reassembled as the GEMM
  the loop runs, equal to the convs on the unpadded operands in f32 (the
  bf16 operand and the f32 scheme's pieces, summed as
  ``split.product_sum`` sums them);
* the port's A (with the 96 -> 192 shortcut), B, E, F (cache offsets 0
  and 2), D and D' against the JAX package's Pallas kernels in interpret
  mode, as ``tests/test_fast_paths.py`` runs them, at C in {32, 96, 192,
  384}, in f32; and a narrow v1.0 model (ch 48) against JAX end to end.

Tolerance: rtol 1e-4, atol 2e-4 (the repo's golden bound) against JAX;
relative L2 2e-5 (``chip_smoke.F32_GATE``) for the GEMM models, whose sums
differ from the convs' in order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vidtok_tpu.modules.blocks as JB
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.ops.pallas.decoder_tail import decoder_tail_rgb as j_tail
from vidtok_tpu.ops.pallas.fused_spatial_v2 import fused_spatial_resblock_v2
from vidtok_tpu.ops.pallas.fused_temporal import fused_temporal_resblock as j_temporal
from vidtok_tpu.ops.pallas.fused_temporal import fused_temporal_resblock_stream as j_stream
from vidtok_tpu.ops.pallas.parity_upsample_fused import parity_up2x_fused as j_parity
from vidtok_tpu.utils.checkpoint import convert_torch_state_dict
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels import plan
from vidtok_tpu_torch.ops.kernels.fused_spatial import spatial_operands
from vidtok_tpu_torch.ops.kernels.fused_temporal import temporal_operands
from vidtok_tpu_torch.ops.kernels.parity_upsample import (parity_operands,
                                                          parity_operands_f32,
                                                          parity_up2x_fused_plain)
from vidtok_tpu_torch.ops.kernels.split import PRODUCTS, split

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)
REL = 2e-5
WIDTHS = list(range(plan.C_ALIGN, plan.C_MAX + 1, plan.C_ALIGN))
BAD = (4, 12, 100, 1028, 1032, 2048)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


# -- the plans at every width ---------------------------------------------------

def _check_conv_plan(pl, cout, parities=1):
    """Limits, and the N tiles of one M tile storing each output column of
    each parity exactly once (the last tile's columns past Cout unstored)."""
    assert pl.bn in (64, 128, 256) and pl.cout == cout and pl.parities == parities
    assert pl.smem == plan.smem_bytes(pl.bn, pl.stages) <= plan.SMEM_LIMIT
    assert plan.BLOCKS_PER_SM * (pl.smem + 1024) <= plan.SMEM_PER_SM
    assert 0 < pl.grid == min(pl.tiles, plan.SMS * plan.BLOCKS_PER_SM)
    assert pl.tiles == pl.m_tiles * pl.n_tiles <= plan.GRID_LIMIT
    first, end = plan.tile_columns(pl, np.arange(pl.n_tiles))
    counts = np.zeros(parities * cout, np.int32)
    for a, b in zip(first.tolist(), end.tolist()):
        assert 0 < b - a <= pl.bn
        counts[a:b] += 1
    assert (counts == 1).all()
    assert pl.n_tiles == parities * -(-cout // pl.bn)  # no tile stores nothing


def _check_k_steps(taps, cin, cs=0):
    """The K steps of one product: 64-channel boxes, every (tap, channel)
    of the taps' and the 1x1 term's columns in exactly one."""
    seen = set()
    for tap, c0, c1 in plan.k_step_reads(taps, cin, cs):
        assert c0 % plan.BK == 0 and 0 < c1 - c0 <= plan.BK
        for c in range(c0, c1):
            assert (tap, c) not in seen
            seen.add((tap, c))
    assert len(seen) == taps * cin + cs


@pytest.mark.parametrize("c", WIDTHS)
def test_plans_take_every_width(c):
    """A (C -> C, and C -> another width with its 1x1 term), B and F, E, T1,
    D and D' at every C % 8 == 0 up to 1024, in bf16 and f32."""
    other = 2 * c if 2 * c <= plan.C_MAX else c // 2 // plan.C_ALIGN * plan.C_ALIGN
    for split_ in (False, True):
        for cin, cout in ((c, c), (c, other), (other, c)):
            cs = cin if cin != cout else 0
            pl = plan.conv_plan_spatial(2, 33, 33, cin, cout, cs, split_)
            _check_conv_plan(pl, cout)
            assert pl.a_channels == (3 if split_ else 1) * cin
            _check_k_steps(9, cin)
            _check_k_steps(9, cout, cs)
        _check_conv_plan(plan.conv_plan_temporal(2, 5, 33 * 33, c, split_), c)
        _check_k_steps(3, c)
        _check_conv_plan(plan.conv_plan_parity(2, 5, 33, 33, c, split_), c, 2)
        _check_k_steps(18, c)
    _check_conv_plan(plan.conv_plan_dense(1000, 3 * c, c), c)
    for tail in (plan.tail_plan(2, 6, 33, 33, c), plan.tail_plan_f32(2, 6, 33, 33, c)):
        assert 2 <= tail.stages <= plan.TAIL_MAX_STAGES and tail.smem <= plan.SMEM_LIMIT
        assert tail.groups == len(plan.tail_groups(c)) == -(-c // plan.TAIL_GROUP)
    groups = plan.tail_groups(c)
    assert groups[0][0] == 0 and groups[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all(0 < c1 - c0 <= plan.TAIL_GROUP for c0, c1 in groups)
    lpr, vpl, _ = plan.row_layout(c)
    assert 8 * lpr * (vpl - 1) < c <= 8 * lpr * vpl


@pytest.mark.parametrize("c", BAD)
def test_plans_refuse_outside_the_domain(c):
    """C % 8 != 0 (TMA's 16-byte global strides) and C > 1024 raise, the
    message naming the reason, in every plan."""
    why = "TMA needs a global stride" if c % plan.C_ALIGN else "<= 1024"
    calls = [lambda: plan.conv_plan_spatial(1, 8, 8, c, 128),
             lambda: plan.conv_plan_spatial(1, 8, 8, 128, c, 128),
             lambda: plan.conv_plan_temporal(1, 2, 64, c),
             lambda: plan.conv_plan_parity(1, 2, 8, 8, c),
             lambda: plan.conv_plan_dense(100, 384, c),
             lambda: plan.tail_plan(1, 2, 8, 8, c),
             lambda: plan.tail_plan_f32(1, 2, 8, 8, c),
             lambda: plan.check_row_channels(c)]
    for call in calls:
        with pytest.raises(ValueError, match=why):
            call()


# -- the operands as the loop reads them ------------------------------------------

def weight_box(w, layout, tap, c0, piece, n0, par, bn):
    """A K step's weight box as TMA loads it through the weight's maps
    (wgmma_conv.cuh: weight_maps): BN rows from n0 of parity ``par``, 64
    channels from c0 of tap ``tap`` (the 1x1 term's columns for tap ==
    taps), piece ``piece``; zeros past Cout and past the tap's channels."""
    cin, taps, cs, pieces, cout, parities = layout
    k = taps * cin + cs
    v = w.float().reshape(parities, cout, pieces, k)[par, :, piece]
    seg = v[:, tap * cin:(tap + 1) * cin] if tap < taps else v[:, taps * cin:]
    box = torch.zeros(bn, plan.BK)
    rows, cols = min(bn, cout - n0), min(plan.BK, seg.shape[1] - c0)
    box[:rows, :cols] = seg[n0:n0 + rows, c0:c0 + cols]
    return box


def channel_box(a, c0):
    """64 channels of ``a`` [..., C] from c0, zeros past C."""
    box = a.new_zeros(*a.shape[:-1], plan.BK)
    cols = min(plan.BK, a.shape[-1] - c0)
    box[..., :cols] = a[..., c0:c0 + cols]
    return box


def loop_gemm(pl, op, name, a_boxes, products):
    """The loop's output columns, N tile by N tile, summed over the
    products and K steps the producer issues: ``a_boxes(piece, tap, c0)``
    the activation box [M, 64] of a K step. [M, parities * Cout]."""
    cin, taps, cs, pieces, cout, parities = op["layouts"][name]
    per = pl.n_tiles // pl.parities
    out = None
    for nt in range(pl.n_tiles):
        par, n0 = divmod(nt, per)
        n0 *= pl.bn
        acc = None
        for ia, jw in products:
            for tap, c0, _ in plan.k_step_reads(taps, cin, cs):
                y = a_boxes(ia, tap, c0) @ weight_box(op[name], op["layouts"][name], tap, c0,
                                                      jw, n0, par, pl.bn).t()
                acc = y if acc is None else acc + y
        if out is None:
            out = acc.new_zeros(acc.shape[0], parities * cout)
        cols = min(pl.bn, cout - n0)
        out[:, par * cout + n0:par * cout + n0 + cols] = acc[:, :cols]
    return out


def planes(x, f32):
    """The activation's planes as a kernel's scratch holds them: x itself
    (bf16 scheme; f32 values here), or its three bf16 pieces, a plane each."""
    return split(x).float() if f32 else x[None].float()


def shifted(a, dy, dx):
    """[N, H, W, C] shifted by (dy, dx) with zeros outside the frame: a
    spatial tap's box over every position."""
    n, h, w, c = a.shape
    p = F.pad(a, (0, 0, 1, 1, 1, 1))
    return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("cin,c", [(8, 8), (32, 32), (96, 96), (96, 192), (40, 72),
                                   (200, 136), (128, 128), (64, 128)])
def test_spatial_operands_read_as_the_convs(cin, c, f32):
    """A's two convs (conv2 with the 1x1 term after its taps) from
    ``spatial_operands``' weights read through their maps' layouts and the
    activations' planes, against the f32 convs of the unpadded operands."""
    rng = np.random.RandomState(cin + c)
    n, h, w = 2, 5, 7
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32))
    a2 = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(c, cin, 3, 3).astype(np.float32) * 0.1)
    w2 = torch.from_numpy(rng.randn(c, c, 3, 3).astype(np.float32) * 0.1)
    wn = torch.from_numpy(rng.randn(c, cin, 1, 1).astype(np.float32) * 0.1) if cin != c \
        else None
    vec = torch.zeros(c)
    op = spatial_operands(w1, torch.ones(cin), torch.zeros(cin), vec, torch.ones(c), vec,
                          w2, vec, wn, None if wn is None else vec, split=f32)
    pl = plan.conv_plan_spatial(n, h, w, cin, c, cin if wn is not None else 0, f32)
    products = PRODUCTS if f32 else ((0, 0),)
    if not f32:  # the bf16 operands hold bf16 values
        x, a2 = x.bfloat16().float(), a2.bfloat16().float()
        w1, w2 = w1.bfloat16().float(), w2.bfloat16().float()
        wn = None if wn is None else wn.bfloat16().float()
    xp, ap = planes(x, f32), planes(a2, f32)

    def boxes(act, raw):
        def box(piece, tap, c0):
            src = act[piece] if tap < 9 else raw[piece]
            dy, dx = (tap // 3 - 1, tap % 3 - 1) if tap < 9 else (0, 0)
            return channel_box(shifted(src, dy, dx), c0).reshape(-1, plan.BK)
        return box

    got1 = loop_gemm(pl, op, "w1", boxes(xp, None), products)
    want1 = F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1).permute(0, 2, 3, 1)
    assert rel_l2(got1, want1.reshape(-1, c)) < REL
    got2 = loop_gemm(pl, op, "w2", boxes(ap, xp), products)
    want2 = F.conv2d(a2.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    if wn is not None:
        want2 = want2 + F.conv2d(x.permute(0, 3, 1, 2), wn).permute(0, 2, 3, 1)
    assert rel_l2(got2, want2.reshape(-1, c)) < REL


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("c", [8, 96, 200, 384])
def test_temporal_operands_read_as_the_conv(c, f32):
    """B's and F's k=3 time conv from ``temporal_operands``' weights over a
    scratch of T + 2 frames (tap k reading k frames on), its planes and
    weights read as the loop reads them, against the f32 conv."""
    rng = np.random.RandomState(c)
    b, tt, s = 2, 4, 6
    scratch = torch.from_numpy(rng.randn(b, tt + 2, s, c).astype(np.float32))
    wc = torch.from_numpy(rng.randn(c, c, 3).astype(np.float32) * 0.1)
    vec = torch.zeros(c)
    op = temporal_operands(wc, torch.ones(c), vec, vec, torch.ones(c), vec, wc, vec,
                           split=f32)
    if not f32:
        scratch, wc = scratch.bfloat16().float(), wc.bfloat16().float()
    pl = plan.conv_plan_temporal(b, tt, s, c, f32)
    sp = planes(scratch, f32)

    def box(piece, tap, c0):
        return channel_box(sp[piece][:, tap:tap + tt], c0).reshape(-1, plan.BK)

    got = loop_gemm(pl, op, "w1", box, PRODUCTS if f32 else ((0, 0),))
    want = sum(scratch[:, k:k + tt] @ wc[:, :, k].t() for k in range(3))
    assert rel_l2(got, want.reshape(-1, c)) < REL


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("mode", ["zero", "replicate"])
@pytest.mark.parametrize("c", [8, 96, 136])
def test_parity_operands_read_as_the_upsample(c, mode, f32):
    """E's summed weight (``parity_operands``, f32: ``_f32``) read through
    its map (each parity's C rows a dimension of their own, N tiles of one
    parity), 18 taps over s's planes (frame t - 1 zero or frame 0 at the
    stream start), then the blend: against ``parity_up2x_fused_plain`` in
    f32."""
    rng = np.random.RandomState(c + 1)
    b, tt, h, w = 1, 3, 4, 5
    s = torch.from_numpy(rng.randn(b, tt, h, w, c).astype(np.float32))
    weight = torch.from_numpy(rng.randn(c, c, 3, 3, 3).astype(np.float32) * 0.05)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)
    alpha = torch.tensor([0.3])
    op = (parity_operands_f32 if f32 else parity_operands)(weight, bias)
    pl = plan.conv_plan_parity(b, tt, h, w, c, f32)
    if not f32:
        s = s.bfloat16().float()
    sp = planes(s, f32)  # [P, B, T, H, W, C]

    def box(piece, tap, c0):
        f, st = divmod(tap, 9)
        frames = sp[piece].reshape(b, tt, h, w, c)
        if f == 0:  # frame t - 1: the front at t = 0
            front = frames[:, :1] if mode == "replicate" else torch.zeros_like(frames[:, :1])
            frames = torch.cat([front, frames[:, :-1]], dim=1)
        a = shifted(frames.reshape(b * tt, h, w, c), st // 3 - 1, st % 3 - 1)
        return channel_box(a, c0).reshape(-1, plan.BK)

    acc = loop_gemm(pl, op, "w", box, PRODUCTS if f32 else ((0, 0),))
    y = acc.reshape(b, tt, h, w, 2, c) + op["bias"].reshape(2, c)
    out = alpha * s[:, :, :, :, None] + (1 - alpha) * y
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * tt, h, w, c)
    wref = weight if f32 else weight.bfloat16().float()
    want = parity_up2x_fused_plain(s, wref, bias, alpha, mode)
    assert rel_l2(out, want) < (REL if f32 else 5e-3)  # bf16: the summed weight's rounding


# -- the port against JAX at new widths --------------------------------------------

JAX_WIDTHS = (32, 96, 192, 384)


def randomize(tree, rng):
    """Random leaves: norm scales 1 +- 0.2, everything else N(0, 0.1)."""
    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.1 * r

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load_port(module, params, path, prefix):
    tree = params
    for name in reversed(path):
        tree = {name: tree}
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(tree).items()}
    module.load_state_dict(sd, strict=True)
    return module


@pytest.mark.parametrize("cin,c", [(c, c) for c in JAX_WIDTHS] + [(96, 192)])
def test_kernel_a_against_jax(cin, c):
    """H = 32: the Pallas kernel's two row tiles of 16."""
    rng = np.random.RandomState(cin + c)
    x = rng.randn(1, 2, 32, 8, cin).astype(np.float32)
    jm = JB.ResnetBlockSpatial(c, norm_type="layernorm")
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = fused_spatial_resblock_v2(jnp.asarray(x.reshape(2, 32, 8, cin)), p, interpret=True)
    assert want is not None
    tm = load_port(TB.ResnetBlockSpatial(cin, c), p, ("encoder", "down_0_block_0"),
                   "encoder.down.0.block.0.")
    K.reset_counts()
    with torch.no_grad():
        got = tm(t(x), fused=True)
    assert K.counts("calls")["fused_spatial_resblock"] == 1
    assert K.counts()["fused_spatial_resblock"] == 0  # CPU: nothing launched
    close(got.reshape(2, 32, 8, c), want)


def _temporal_port(p, c, mode, off=0):
    tm = load_port(TB.ResnetBlockTemporal(c, c, first_pad_mode=mode, cache_offset=off), p,
                   ("encoder", "down_temporal_0_block_0"), "encoder.down_temporal.0.block.0.")
    return tm, ((tm.norm1.norm.weight, tm.norm1.norm.bias),
                (tm.conv1.conv.weight, tm.conv1.conv.bias),
                (tm.norm2.norm.weight, tm.norm2.norm.bias),
                (tm.conv2.conv.weight, tm.conv2.conv.bias))


@pytest.mark.parametrize("mode", ["zero", "replicate"])
@pytest.mark.parametrize("c", JAX_WIDTHS)
def test_kernel_b_against_jax(c, mode):
    rng = np.random.RandomState(c)
    x = rng.randn(1, 5, 4, 4, c).astype(np.float32)
    jm = JB.ResnetBlockTemporal(c, causal=True, norm_type="layernorm", first_pad_mode=mode)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = j_temporal(jnp.asarray(x), p, mode, interpret=True)
    tm, _ = _temporal_port(p, c, mode)
    K.reset_counts()
    with torch.no_grad():
        close(tm(t(x), fused=True), want)
    assert K.counts("calls")["fused_temporal_resblock"] == 1


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("c", JAX_WIDTHS)
def test_kernel_f_against_jax(c, offset):
    """Three chunks of a stream (the first with ``first_chunk``), y and both
    new caches at each."""
    rng = np.random.RandomState(c + offset)
    chunks = [rng.randn(1, n, 4, 4, c).astype(np.float32) for n in (2, 4, 3)]
    jm = JB.ResnetBlockTemporal(c, causal=True, norm_type="layernorm",
                                first_pad_mode="replicate", cache_offset=offset)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(chunks[0]))["params"], rng)
    _, args = _temporal_port(p, c, "replicate", offset)
    jc1 = jc2 = jnp.zeros((1, 2, 4, 4, c), jnp.float32)
    c1 = c2 = None
    K.reset_counts()
    with torch.no_grad():
        for i, x in enumerate(chunks):
            jy, jc1, jc2 = j_stream(jnp.asarray(x), p, jc1, jc2, first_chunk=i == 0,
                                    offset=offset, interpret=True)
            y, c1, c2 = K.fused_temporal_resblock_stream(t(x), *args, c1, c2, i == 0, offset)
            for got, ref in ((y, jy), (c1, jc1), (c2, jc2)):
                close(got, ref)
    assert K.counts("calls")["fused_temporal_resblock_stream"] == 3


@pytest.mark.parametrize("mode", ["zero", "replicate"])
@pytest.mark.parametrize("c", JAX_WIDTHS)
def test_kernel_e_against_jax(c, mode):
    """JAX's E takes C in chunks of ``chunk_c`` that divide it (its default
    256 does not divide 384): C itself up to 256, 128 at 384."""
    rng = np.random.RandomState(c + 5)
    s = rng.randn(1, 3, 4, 8, c).astype(np.float32)
    k = rng.randn(3, 3, 3, c, c).astype(np.float32) * 0.05
    bias = rng.randn(c).astype(np.float32) * 0.1
    want = j_parity(jnp.asarray(s), jnp.asarray(k), jnp.asarray(bias), 0.3, mode,
                    chunk_c=c if c <= 256 else 128, interpret=True)
    assert want is not None
    weight = t(k.transpose(4, 3, 0, 1, 2))  # OIDHW
    K.reset_counts()
    close(K.parity_up2x_fused(t(s), weight, t(bias), torch.tensor([0.3]), mode), want)
    assert K.counts("calls")["parity_up2x_fused"] == 1


@pytest.mark.parametrize("taps", [False, True])
@pytest.mark.parametrize("mode", ["zero", "replicate"])
@pytest.mark.parametrize("c", JAX_WIDTHS)
def test_kernels_d_against_jax(c, mode, taps):
    """D (JAX's default tap-packed body) and D' (``tap_pack=False``)."""
    rng = np.random.RandomState(c + 3)
    x = (rng.randn(1, 5, 8, 12, c) * 0.5).astype(np.float32)
    norm = {"scale": 1 + 0.2 * rng.randn(c).astype(np.float32),
            "bias": 0.2 * rng.randn(c).astype(np.float32)}
    conv = {"kernel": 0.05 * rng.randn(3, 3, 3, c, 3).astype(np.float32),
            "bias": 0.1 * rng.randn(3).astype(np.float32)}
    want = j_tail(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, norm),
                  jax.tree_util.tree_map(jnp.asarray, conv), mode, interpret=True,
                  tap_pack=not taps)
    sd = state_dict_from_jax({"decoder": {"norm_out": norm, "conv_out": conv}})
    tnorm = (t(sd["decoder.norm_out.norm.weight"]), t(sd["decoder.norm_out.norm.bias"]))
    tconv = (t(sd["decoder.conv_out.conv.weight"]), t(sd["decoder.conv_out.conv.bias"]))
    fn = K.decoder_tail_rgb_taps if taps else K.decoder_tail_rgb
    close(fn(t(x), tnorm, tconv, mode), want)


# -- a narrow model end to end -----------------------------------------------------

_P48 = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
        "ch": 48, "ch_mult": [1, 2], "time_downsample_factor": 2,
        "num_res_blocks": 1, "norm_type": "layernorm",
        "init_pad_mode": "replicate", "tempo_ds": [0], "tempo_us": [1]}
CFG48 = {"params": {
    "encoder_config": {"target": "EncoderCausal3D", "params": dict(_P48)},
    "decoder_config": {"target": "DecoderCausal3D", "params": dict(_P48)},
    "regularizer_config": {"target": "DiagonalGaussianRegularizer"},
}}


def test_ch48_v1_0_model_against_jax():
    """The v1.0 model at ch 48 (levels of 48 and 96 channels: A, B, C, D and
    E all at widths that are not multiples of 64), the port's kernel call
    sites on (their plain versions on the CPU) against JAX's fused graph
    (its Pallas kernels in interpret mode), on a [1, 3, 5, 16, 24] clip.
    The parameters are drawn in the port (norm scales 1 +- 0.2, the rest
    N(0, 0.08)) and converted to JAX's tree (``convert_torch_state_dict``),
    which spares JAX's init."""
    core, _ = j_build(CFG48)
    rng = np.random.RandomState(48)
    x = np.clip(rng.randn(1, 3, 5, 16, 24) * 0.5, -1, 1).astype(np.float32)
    tok = load_model_from_config({"model": CFG48}, device="cpu", fused=True)
    with torch.no_grad():
        for name, prm in tok.core.named_parameters():
            r = torch.from_numpy(rng.randn(*prm.shape).astype(np.float32))
            prm.copy_(1.0 + 0.2 * r if name.endswith("norm.weight") else 0.08 * r)
    params = convert_torch_state_dict({k: v.numpy() for k, v in tok.core.state_dict().items()})
    K.reset_counts()
    z, dec, log = tok(x)
    calls = K.counts("calls")
    assert calls["fused_spatial_resblock"] == 6 and calls["fused_temporal_resblock"] == 6
    assert calls["parity_up2x_fused"] == 1 and calls["decoder_tail_rgb"] == 1
    assert all(n == 0 for n in K.counts().values())
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    zj, dj, lj = core.apply({"params": params}, xt, sample_override=False, fused=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj).transpose(0, 4, 1, 2, 3), **TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dj).transpose(0, 4, 1, 2, 3), **TOL)
    np.testing.assert_allclose(float(log["kl_loss"]), float(lj["kl_loss"]), rtol=1e-4)
