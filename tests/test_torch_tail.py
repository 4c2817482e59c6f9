"""Kernels D and D' (the decoder tail): their plan, operands and schedule.

Both kernels are one CUDA template (``csrc/decoder_tail.cu``) launched with
``plan.tail_plan``'s plan: a block walks the frames of one output patch of
one clip over a run, reads and activates each input frame's halo box once,
multiplies it by the weights with the 27 (time tap, dx, out channel)
columns packed onto N, and gathers the partials into a ring of three output
accumulators. Nothing here needs the card:

* the plan at every call shape ``chip_smoke.py`` serves or gates covers
  each output (clip, frame, y, x) exactly once, within the H100's shared
  memory, and fills the card at the serving shapes;
* the packed weights match the OIDHW conv weight tap by tap, and are
  cached per parameter and rebuilt after an update;
* the plan and the wrappers refuse the same shapes;
* :func:`schedule_model`, a PyTorch model of the kernel's walk (per-frame
  packed partials, the dx gather, the 3-slot output ring, warm-up frames at
  a run's start, both stream-start rules), is held in f32 to the Pallas
  kernel in interpret mode, with tap packing on (the fast LN+SiLU, D) and
  off (the exact one, D');
* :func:`schedule_model_f32`, the same walk as the f32 forms of D and D'
  take it (the statistics pass, each 32-channel slice activated from the
  statistics and split into three bf16 pieces, the six products against
  the weight pieces), is held to the Pallas kernel on f32 inputs at
  relative L2 2e-5, also on rows of mean 50, and the hi piece alone is
  shown to miss that tolerance.

Parameters are random, with non-zero norm biases, so a halo that is not
zeroed after the activation shows. The tolerances are those of
``test_torch_kernels.py`` (D) and ``test_torch_forms.py`` (D').
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
import vidtok_tpu.ops.pallas.decoder_tail as JT
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.modules.conv import CausalConv3d
from vidtok_tpu_torch.modules.norms import ChannelLayerNorm
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels import _lib, plan
from vidtok_tpu_torch.ops.kernels.act import ln_silu_exact, ln_silu_fast
from vidtok_tpu_torch.ops.kernels.decoder_tail import tail_operands, tail_operands_f32
from vidtok_tpu_torch.ops.kernels.split import PRODUCTS, split

torch.set_num_threads(2)
FAST_TOL = dict(rtol=1e-4, atol=2e-4)     # test_torch_kernels.py
EXACT_TOL = dict(rtol=1e-5, atol=1e-5)    # test_torch_forms.py
MODES = ["zero", "replicate"]


def packed_weight(weight):
    """The OIDHW ``[3, C, 3, 3, 3]`` weight as ``[3 dy, 27, C]``, row
    ``9j + 3dx + co`` = ``weight[co, :, j, dy, dx]``, in its own dtype."""
    return weight.permute(3, 2, 4, 0, 1).reshape(3, plan.TAIL_COLS, weight.shape[1])


# -- the operands -------------------------------------------------------------

def test_tail_operands_layout():
    c = 64
    g = torch.Generator().manual_seed(11)
    weight, bias = torch.randn((3, c, 3, 3, 3), generator=g), torch.randn(3, generator=g)
    ng, nb = torch.randn(c, generator=g), torch.randn(c, generator=g)
    op = tail_operands(weight, bias, ng, nb)
    assert op["w"].shape == (3, plan.TAIL_BN, c) and op["w"].dtype == torch.bfloat16
    assert op["w"].is_contiguous()
    for j in range(3):
        for dy in range(3):
            for dx in range(3):
                for co in range(3):
                    assert torch.equal(op["w"][dy, 9 * j + 3 * dx + co],
                                       weight[co, :, j, dy, dx].to(torch.bfloat16))
    assert torch.equal(op["w"][:, plan.TAIL_COLS:], torch.zeros(3, 5, c, dtype=torch.bfloat16))
    assert torch.equal(op["w"][:, :plan.TAIL_COLS], packed_weight(weight).to(torch.bfloat16))
    for k, v in (("bias", bias), ("g", ng), ("b", nb)):
        assert op[k].dtype == torch.float32 and torch.equal(op[k], v)


def _tail_modules(c, seed):
    m = torch.nn.ModuleDict({"norm_out": ChannelLayerNorm(c), "conv_out": CausalConv3d(c, 3)})
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return m


def _tail_sources(m):
    return (m.conv_out.conv.weight, m.conv_out.conv.bias, m.norm_out.norm.weight,
            m.norm_out.norm.bias)


def _no_grad(fn):
    with torch.no_grad():
        fn()


TAIL_UPDATES = {
    "conv_weight": lambda m: _no_grad(lambda: m.conv_out.conv.weight.mul_(-0.5)),
    "conv_bias": lambda m: _no_grad(lambda: m.conv_out.conv.bias.add_(1.0)),
    "norm_weight": lambda m: _no_grad(lambda: m.norm_out.norm.weight.mul_(2.0)),
    "norm_bias": lambda m: m.norm_out.norm.bias.detach().copy_(torch.randn(64)),
    "load_state_dict": lambda m: m.load_state_dict(_tail_modules(64, 5).state_dict()),
    "to_dtype": lambda m: m.to(torch.float64),
    "data_copy_then_clear": lambda m: (m.conv_out.conv.weight.data.copy_(
        torch.randn(m.conv_out.conv.weight.shape)), _lib.clear_operands()),
}


@pytest.mark.parametrize("update", sorted(TAIL_UPDATES))
def test_tail_operands_cached_then_rebuilt(update):
    """Keyed as the wrappers key it (the conv's weight and bias, the norm's
    scale and bias): served while they stand still, rebuilt and equal to a
    fresh relayout after each way one of them changes."""
    m = _tail_modules(64, 4)

    def get():
        return _lib.operands("decoder_tail", _tail_sources(m), tail_operands)

    first = get()
    assert get() is first
    TAIL_UPDATES[update](m)
    again = get()
    assert again is not first
    fresh = tail_operands(*_tail_sources(m))
    for k in ("w", "bias", "g", "b"):
        assert torch.equal(again[k], fresh[k]), k


# -- the plan -----------------------------------------------------------------

def _tail_keys(which):
    """Call shapes of kernels D and D' that chip_smoke.py serves or gates."""
    if which == "serving":
        return [k for k, _ in cs.TAIL_SHAPES]
    if which == "tiled":
        keys = {k[0] for (name, k) in cs.tiled_calls(cs.TILED_REQUEST[2])
                if name == "decoder_tail_rgb"}
        assert sorted(k[1] for k in keys) == [10, 18, 22]
        return sorted(keys)
    if which == "tiled201":
        return sorted({k[0] for (name, k) in cs.tiled_calls(cs.TILED_LONG[2])
                       if name == "decoder_tail_rgb"})
    if which == "long":
        return [cs.TAIL_LONG]
    if which in cs.CONFIG_PATHS:
        return sorted({k[0] for (name, k) in cs.model_calls(*cs.CONFIG_PATHS[which])
                       if name == "decoder_tail_rgb"})
    return list(cs.PARTIAL_TAIL)


@pytest.mark.parametrize("which", ["serving", "tiled", "tiled201", "long", "partial",
                                   "fsq_41616", "tiled_888", "kl_444"])
def test_tail_plans_cover_each_output_once(which):
    for key in _tail_keys(which):
        b, t, h, w, c = key
        pl = plan.tail_plan(*key)
        assert (pl.th, pl.tw) == (plan.TAIL_TH, plan.TAIL_TW)
        assert pl.tiles_x * pl.tw >= w > (pl.tiles_x - 1) * pl.tw
        assert pl.tiles_y * pl.th >= h > (pl.tiles_y - 1) * pl.th
        assert pl.runs == -(-t // pl.run) and pl.grid == b * pl.tiles_x * pl.tiles_y * pl.runs
        assert 2 <= pl.stages <= plan.TAIL_MAX_STAGES
        assert pl.smem == plan.tail_smem_bytes(c, pl.stages) <= plan.SMEM_LIMIT
        assert plan.TAIL_BLOCKS_PER_SM * (pl.smem + 1024) <= plan.SMEM_PER_SM
        assert 0 < pl.grid <= plan.GRID_LIMIT
        if which != "partial":  # the serving shapes fill the card
            assert pl.grid >= plan.SMS * plan.TAIL_BLOCKS_PER_SM
        # every (clip, frame, patch) written by one block, each frame read
        # from two before its run's first
        counts = np.zeros((b, t, pl.tiles_y, pl.tiles_x), np.int32)
        for block in range(pl.grid):
            clip, y0, x0, t0, t1, first = plan.tail_block(pl, block, t)
            assert 0 <= t0 < t1 <= t and first == max(t0 - plan.TAIL_WARMUP, 0)
            assert t1 - t0 <= pl.run
            counts[clip, t0:t1, y0 // pl.th, x0 // pl.tw] += 1
        assert (counts == 1).all(), key


def test_tail_plan_picks():
    # one run per clip where the patches alone fill the card; runs with
    # warm-up frames where they do not
    assert plan.tail_plan(1, 20, 256, 256, 128).runs == 1
    assert plan.tail_plan(1, 20, 256, 256, 128).stages == plan.TAIL_MAX_STAGES
    assert plan.tail_plan(2, 6, 33, 33, 128).runs > 1
    assert plan.tail_plan(1, 1, 8, 8, 64).grid == 1


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _tail_args(shape):
    c = shape[-1]
    return (_meta(*shape), (_meta(c), _meta(c)), (_meta(3, c, 3, 3, 3), _meta(3)), "zero")


REFUSED = [((1, 4, 8, 8, 44), "C % 8"), ((1, 4, 8, 8, 1032), "C <= 1024"),
           ((1, 4, 8, 8, 4), "multiple of 16 bytes"), ((1, 0, 8, 8, 128), "empty"),
           ((0, 4, 8, 8, 128), "empty"), ((1, 4, 8, 0, 128), "empty")]


@pytest.mark.parametrize("shape,match", REFUSED)
def test_tail_plan_refuses(shape, match):
    with pytest.raises(ValueError, match=match):
        plan.tail_plan(*shape)


@pytest.mark.parametrize("name", ["decoder_tail_rgb", "decoder_tail_rgb_taps"])
@pytest.mark.parametrize("shape,match", REFUSED + [
    ((1, 4, 8, 8, c), "CUDA tensor") for c in (128, 40, 32, 256)])
def test_tail_wrappers_refuse_what_the_plan_cannot_take(name, shape, match):
    """Off the CPU, D and D' raise on a shape the plan refuses before they
    look at the device; a shape the plan takes goes on to the device check
    (the meta device stands in for a card). Nothing is launched and no
    plain version runs."""
    fn = K.WRAPPERS[name]
    K.reset_counts()
    with pytest.raises(ValueError, match=match):
        fn(*_tail_args(shape))
    assert K.counts("calls")[name] == 1 and K.counts()[name] == 0


# -- the kernel's schedule, modelled, against JAX ------------------------------

def schedule_model(x, norm, conv, first_pad_mode, act, pl=None, zero_halo=True):
    """The output of kernels D and D' computed as their blocks compute it,
    in x's dtype: per ``plan.tail_block``, the halo box of each input frame
    from the run's first read frame on, activated (``act``) and, where
    ``zero_halo``, zero outside the frame; one product per dy of the box's
    rows shifted by 16 dy against the packed weights; each output position
    gathers its 3 dx neighbours' columns; a ring of three accumulators
    (outputs f, f + 1, f + 2 take time taps 2, 1, 0) that starts at zero in
    every block; output f written, bias added, once frame f is in and only
    from the run's first frame on. Asserts that every output is written
    exactly once."""
    b, t, h, w, c = x.shape
    pl = pl or plan.tail_plan(b, t, h, w, c)
    th, tw, hx = pl.th, pl.tw, pl.tw + 2
    wp = packed_weight(conv[0].to(x.dtype))
    pads = (0, 0, 1, pl.tiles_x * tw + 1 - w, 1, pl.tiles_y * th + 1 - h)
    a = (F.pad(act(x, norm[0], norm[1]), pads) if zero_halo
         else act(F.pad(x, pads), norm[0], norm[1]))
    out = torch.zeros((b, t, h, w, 3), dtype=x.dtype)
    written = torch.zeros((b, t, h, w), dtype=torch.int32)
    for block in range(pl.grid):
        clip, y0, x0, t0, t1, first = plan.tail_block(pl, block, t)
        ring = [torch.zeros((th, tw, 3), dtype=x.dtype) for _ in range(3)]
        hh, ww = min(th, h - y0), min(tw, w - x0)
        for f in range(first, t1):
            box = a[clip, f, y0:y0 + th + 2, x0:x0 + hx].reshape(-1, c)
            p = sum(box[hx * dy:hx * dy + th * hx] @ wp[dy].T for dy in range(3))
            p = p.reshape(th, hx, plan.TAIL_COLS)
            g = [sum(p[:, dx:dx + tw, 9 * j + 3 * dx:9 * j + 3 * dx + 3] for dx in range(3))
                 for j in range(3)]
            ring[0] += g[2]
            ring[1] += g[1]
            ring[2] += g[0]
            if first_pad_mode == "replicate" and f == 0:
                ring[0] += g[0] + g[1]
                ring[1] += g[0]
            if f >= t0:
                out[clip, f, y0:y0 + hh, x0:x0 + ww] = ring[0][:hh, :ww] + conv[1].to(x.dtype)
                written[clip, f, y0:y0 + hh, x0:x0 + ww] += 1
            ring = [ring[1], ring[2], torch.zeros_like(ring[0])]
    assert (written == 1).all()
    return out


def _inputs(shape, seed):
    """x, and the tail's JAX and port parameters, from numpy."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 0.5).astype(np.float32)
    norm = {"scale": 1 + 0.2 * rng.randn(c).astype(np.float32),
            "bias": 0.3 * rng.randn(c).astype(np.float32)}
    conv = {"kernel": 0.05 * rng.randn(3, 3, 3, c, 3).astype(np.float32),
            "bias": 0.1 * rng.randn(3).astype(np.float32)}
    sd = state_dict_from_jax({"decoder": {"norm_out": norm, "conv_out": conv}})
    tnorm = tuple(torch.from_numpy(np.array(sd[f"decoder.norm_out.norm.{k}"]))
                  for k in ("weight", "bias"))
    tconv = tuple(torch.from_numpy(np.array(sd[f"decoder.conv_out.conv.{k}"]))
                  for k in ("weight", "bias"))
    return x, norm, conv, tnorm, tconv


def _jax_tail(x, norm, conv, mode, tap_pack):
    return np.asarray(JT.decoder_tail_rgb(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, norm),
        jax.tree_util.tree_map(jnp.asarray, conv), mode, tap_pack=tap_pack,
        interpret=True))


# (B, T, H, W, C): two clips, 10 x 17 frames (partial patches in both
# directions; the Pallas kernel takes H % 2 == 0) and T longer than a run;
# T = 1; T = 2 with two clips; whole patches at C = 128
SCHEDULE_SHAPES = {"two_clips_t9": (2, 9, 10, 17, 64), "t1": (1, 1, 10, 17, 64),
                   "t2": (2, 2, 10, 30, 64), "c128": (1, 4, 16, 28, 128)}
TAP_PACK = {"packed": (True, ln_silu_fast, FAST_TOL), "taps": (False, ln_silu_exact, EXACT_TOL)}


@pytest.mark.parametrize("form", sorted(TAP_PACK))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(SCHEDULE_SHAPES))
def test_schedule_model_matches_pallas(case, mode, form):
    """The modelled walk against ``decoder_tail_rgb(..., tap_pack=...,
    interpret=True)``, at the plan's own runs and at runs of 4 frames (a
    short last run, warm-up frames at the others' starts)."""
    shape = SCHEDULE_SHAPES[case]
    tap_pack, act, tol = TAP_PACK[form]
    x, norm, conv, tnorm, tconv = _inputs(shape, seed=sum(shape))
    want = _jax_tail(x, norm, conv, mode, tap_pack)
    pl = plan.tail_plan(*shape)
    b, t = shape[:2]
    runs4 = -(-t // 4)
    plans = [pl, dataclasses.replace(pl, run=4, runs=runs4,
                                     grid=b * pl.tiles_x * pl.tiles_y * runs4)]
    for p in plans:
        got = schedule_model(torch.from_numpy(x), tnorm, tconv, mode, act, p)
        np.testing.assert_allclose(got.numpy(), want, **tol)


def test_schedule_model_sees_an_unzeroed_halo():
    """The halo left as the activation of TMA's zero fill, silu(norm bias),
    is far outside the tolerance: the comparison above can see it."""
    shape = SCHEDULE_SHAPES["two_clips_t9"]
    x, norm, conv, tnorm, tconv = _inputs(shape, seed=sum(shape))
    want = _jax_tail(x, norm, conv, "zero", True)
    got = schedule_model(torch.from_numpy(x), tnorm, tconv, "zero", ln_silu_fast,
                         zero_halo=False).numpy()
    assert not np.allclose(got, want, **FAST_TOL)
    border = np.ones(shape[2:4], bool)
    border[1:-1, 1:-1] = False
    np.testing.assert_allclose(got[:, :, ~border], want[:, :, ~border], **FAST_TOL)


# -- the f32 forms' walk, modelled, against JAX ---------------------------------

F32_REL = 2e-5        # chip_smoke.F32_GATE
F32_ROW_MEAN = 50.0   # chip_smoke.F32_ROW_MEAN
EPS = 1e-6


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def schedule_model_f32(x, norm, conv, first_pad_mode, exact, pl=None, products=PRODUCTS):
    """The f32 output of kernels D (``exact`` False: the SiLU through tanh)
    and D' (True: through the sigmoid) computed as their f32 forms compute
    it: each position's (mean, rstd) from the statistics pass (the mean,
    then the mean of squared deviations); per ``plan.tail_block`` of
    ``plan.tail_plan_f32``, the raw halo box of each input frame (zero
    outside the frame), 32 channels at a time, activated from the
    statistics, zero outside the frame, split into three bf16 pieces; the
    ``products`` (pieces of the activation, of the weight) of each dy's
    shifted rows against the weight pieces, summed in f32 over the slices;
    then :func:`schedule_model`'s gather and ring, the output not rounded.
    Asserts that every output is written exactly once."""
    b, t, h, w, c = x.shape
    pl = pl or plan.tail_plan_f32(b, t, h, w, c)
    th, tw, hx, kc = pl.th, pl.tw, pl.tw + 2, plan.TAIL_F32_KC
    wp = tail_operands_f32(*conv, *norm)["w"].float()[:, :, :plan.TAIL_COLS]
    mu = x.mean(-1, keepdim=True)
    rs = torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + EPS)
    pads = (0, 0, 1, pl.tiles_x * tw + 1 - w, 1, pl.tiles_y * th + 1 - h)
    xp, mup, rsp = (F.pad(v, pads) for v in (x, mu, rs))
    inside = F.pad(torch.ones(b, t, h, w, 1), pads)
    out = torch.zeros((b, t, h, w, 3))
    written = torch.zeros((b, t, h, w), dtype=torch.int32)
    for block in range(pl.grid):
        clip, y0, x0, t0, t1, first = plan.tail_block(pl, block, t)
        ring = [torch.zeros((th, tw, 3)) for _ in range(3)]
        hh, ww = min(th, h - y0), min(tw, w - x0)
        for f in range(first, t1):
            box = (slice(y0, y0 + th + 2), slice(x0, x0 + hx))
            p = torch.zeros((th * hx, plan.TAIL_COLS))
            for c0 in range(0, c, kc):
                raw = xp[clip, f, box[0], box[1], c0:c0 + kc]
                y = ((raw - mup[clip, f, box[0], box[1]]) * rsp[clip, f, box[0], box[1]]
                     * norm[0][c0:c0 + kc] + norm[1][c0:c0 + kc])
                a = y * torch.sigmoid(y) if exact else y * (torch.tanh(0.5 * y) * 0.5 + 0.5)
                a = (a * inside[clip, f, box[0], box[1]]).reshape(-1, kc)
                pieces = split(a).float()
                for ia, jw in products:
                    for dy in range(3):
                        p += (pieces[ia, hx * dy:hx * dy + th * hx]
                              @ wp[jw, dy, :, c0:c0 + kc].T)
            p = p.reshape(th, hx, plan.TAIL_COLS)
            g = [sum(p[:, dx:dx + tw, 9 * j + 3 * dx:9 * j + 3 * dx + 3] for dx in range(3))
                 for j in range(3)]
            ring[0] += g[2]
            ring[1] += g[1]
            ring[2] += g[0]
            if first_pad_mode == "replicate" and f == 0:
                ring[0] += g[0] + g[1]
                ring[1] += g[0]
            if f >= t0:
                out[clip, f, y0:y0 + hh, x0:x0 + ww] = ring[0][:hh, :ww] + conv[1].float()
                written[clip, f, y0:y0 + hh, x0:x0 + ww] += 1
            ring = [ring[1], ring[2], torch.zeros_like(ring[0])]
    assert (written == 1).all()
    return out


def _f32_case(shape, mode, form, mean=0.0, products=PRODUCTS):
    """(the modelled f32 walk, JAX's f32 tail) on inputs of ``shape`` offset
    by ``mean``, at the plan's own runs and at runs of 4 frames."""
    tap_pack, exact = form == "packed", form == "taps"
    x, norm, conv, tnorm, tconv = _inputs(shape, seed=sum(shape) + 1)
    x = x + np.float32(mean)
    # JAX's exact statistics where the one-pass form would lose the
    # variance's digits to the mean (tap_pack's default is the fast form)
    want = np.asarray(JT.decoder_tail_rgb(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, norm),
        jax.tree_util.tree_map(jnp.asarray, conv), mode, tap_pack=tap_pack, interpret=True,
        silu_fast=False if mean else None))
    pl = plan.tail_plan_f32(*shape)
    b, t = shape[:2]
    runs4 = -(-t // 4)
    plans = [pl, dataclasses.replace(pl, run=4, runs=runs4,
                                     grid=b * pl.tiles_x * pl.tiles_y * runs4)]
    return [(schedule_model_f32(torch.from_numpy(x), tnorm, tconv, mode, exact, p, products),
             want) for p in plans]


@pytest.mark.parametrize("form", sorted(TAP_PACK))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(SCHEDULE_SHAPES))
def test_schedule_model_f32_matches_pallas(case, mode, form):
    """The f32 forms' modelled walk (D: ``packed``, D': ``taps``) against
    ``decoder_tail_rgb(..., tap_pack=..., interpret=True)`` on f32 inputs,
    at relative L2 F32_REL."""
    for got, want in _f32_case(SCHEDULE_SHAPES[case], mode, form):
        assert got.dtype == torch.float32
        assert rel_l2(got, want) <= F32_REL


@pytest.mark.parametrize("form", sorted(TAP_PACK))
@pytest.mark.parametrize("mode", MODES)
def test_schedule_model_f32_at_a_large_row_mean(mode, form):
    """On rows of mean F32_ROW_MEAN the statistics pass's two-pass
    statistics keep the walk within F32_REL of JAX's exact kernel."""
    for got, want in _f32_case(SCHEDULE_SHAPES["two_clips_t9"], mode, form, F32_ROW_MEAN):
        assert rel_l2(got, want) <= F32_REL


def test_schedule_model_f32_sees_a_dropped_product():
    """With the hi pieces' product alone (bf16 operands) the walk misses
    F32_REL by far: the comparison above sees a product left out."""
    rels = [rel_l2(got, want) for got, want in
            _f32_case(SCHEDULE_SHAPES["two_clips_t9"], "replicate", "packed",
                      products=((0, 0),))]
    assert min(rels) > 10 * F32_REL
