"""The port's temporal microbenchmark and SiLU probe (T1-T4) against the JAX
package's tools (``tools/microbench_temporal.py``, ``tools/probe_silu_bf16.py``).

The JAX tools' Pallas kernels run in interpret mode on the CPU; the port's
wrappers, given CPU tensors, run their plain versions. Parameters are
random, norm and conv biases included (``ln_silu(0) != 0``). T1-T3 in fp32
at rtol 1e-4, atol 2e-4 (the repo's golden bound; copies exactly); T4 in
bf16, its own tolerance below.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vidtok_tpu.ops.pallas.fused_temporal import _ln_silu
from vidtok_tpu_torch.ops.kernels import plan
from vidtok_tpu_torch.ops.kernels.act import ln_silu_exact_f32
from vidtok_tpu_torch.ops.kernels.fused_temporal import gemm_weight, kmajor_weight
from vidtok_tpu_torch.tools import microbench_temporal as TM
from vidtok_tpu_torch.tools import probe_silu_bf16 as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import microbench_temporal as MT  # noqa: E402  (the JAX tool)
import probe_silu_bf16 as PS  # noqa: E402  (the JAX tool)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)
SHAPE = (1, 5, 8, 8, 32)  # S = 64 positions: one tile_s = 64 grid step
TWO_CLIPS = (2, 5, 8, 8, 32)  # no tap may reach into the other clip
TILE_S = 64


def block_params(c, rng, ci=None):
    """Flax-layout params of the tool's block, all random: norm scales
    1 +- 0.2, norm biases, conv kernels and conv biases N(0, 0.1)."""
    ci = ci or c

    def norm():
        return {"scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
                "bias": (0.1 * rng.randn(c)).astype(np.float32)}

    def conv():
        return {"kernel": (0.1 * rng.randn(3, 1, 1, ci, c)).astype(np.float32),
                "bias": (0.1 * rng.randn(c)).astype(np.float32)}

    return {"norm1": norm(), "conv1": conv(), "norm2": norm(), "conv2": conv()}


def inputs(seed=0, shape=SHAPE):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    p = block_params(shape[-1], rng)
    return x, p, jax.tree_util.tree_map(jnp.asarray, p), TM.params_from_jax(p)


def test_ln_silu_exact_f32():
    """The plain form of ``fused_temporal.py:32``'s exact LN+SiLU."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 32) * 2 + 0.5).astype(np.float32)
    g, b = (1 + 0.2 * rng.randn(32)).astype(np.float32), rng.randn(32).astype(np.float32)
    want = _ln_silu(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = ln_silu_exact_f32(*(torch.from_numpy(a) for a in (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_jax():
    """kernel ``[3, 1, 1, Ci, Co]`` -> Conv1d ``[Co, Ci, 3]``; Ci != Co
    catches a transpose."""
    rng = np.random.RandomState(1)
    p = block_params(16, rng, ci=8)
    got = TM.params_from_jax(p)
    for n in ("conv1", "conv2"):
        w, bias = got[n]
        assert tuple(w.shape) == (16, 8, 3) and w.is_contiguous()
        k = p[n]["kernel"]
        for o, i, j in ((0, 0, 0), (15, 7, 2), (3, 5, 1)):
            assert float(w[o, i, j]) == k[j, 0, 0, i, o]
        np.testing.assert_array_equal(bias.numpy(), p[n]["bias"])
    for n in ("norm1", "norm2"):
        np.testing.assert_array_equal(got[n][0].numpy(), p[n]["scale"])
        np.testing.assert_array_equal(got[n][1].numpy(), p[n]["bias"])


def test_gemm_weight_layout():
    """Conv1d ``[Co, Ci, k]`` -> ``[(k, ci), co]``, the operand kernels B,
    F, T1 and T2 read and the plain forms multiply by."""
    w = torch.from_numpy(np.random.RandomState(5).randn(16, 8, 3).astype(np.float32))
    got = gemm_weight(w, torch.float32)
    assert tuple(got.shape) == (24, 16) and got.is_contiguous()
    for o, i, k in ((0, 0, 0), (15, 7, 2), (3, 5, 1)):
        assert float(got[k * 8 + i, o]) == float(w[o, i, k])
    assert gemm_weight(w).dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [SHAPE, TWO_CLIPS])
def test_t1_fused_fat(shape):
    x, _, jp, tp = inputs(0, shape)
    want = MT.fused_fat(jnp.asarray(x), jp, tile_s=TILE_S)
    calls, launches = TM.fused_fat.calls, TM.fused_fat.launches
    got = TM.fused_fat(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (TM.fused_fat.calls, TM.fused_fat.launches) == (calls + 1, launches)


@pytest.mark.parametrize("shape", [SHAPE, TWO_CLIPS])
@pytest.mark.parametrize("mode", ["copy", "mm", "ln"])
def test_t2_fused_diag(mode, shape):
    x, _, jp, tp = inputs(1, shape)
    want = MT.fused_diag(jnp.asarray(x), jp, tile_s=TILE_S, mode=mode)
    calls, launches = TM.fused_diag.calls, TM.fused_diag.launches
    got = TM.fused_diag(torch.from_numpy(x), tp, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (TM.fused_diag.calls, TM.fused_diag.launches) == (calls + 1, launches)


@pytest.mark.parametrize("tile_s,tile_t", [(64, None), (32, None), (16, 1), (64, 3),
                                           (8, 2), (64, 6)])
def test_t3_copy_min(tile_s, tile_t):
    """Every tiling that divides ``[1, 6, 8, 8, 32]`` copies exactly."""
    x = np.random.RandomState(2).randn(1, 6, 8, 8, 32).astype(np.float32)
    want = np.asarray(MT.copy_min(jnp.asarray(x), tile_s=tile_s, tile_t=tile_t))
    got = TM.copy_min(torch.from_numpy(x), tile_s, tile_t).numpy()
    np.testing.assert_array_equal(want, x)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("tile_s,tile_t", [(48, None), (64, 4), (0, None), (128, None)])
def test_t3_refuses_non_dividing_tile(tile_s, tile_t):
    """A tile that does not divide H*W or T raises (JAX's grid would leave
    the remainder uncopied: a deliberate divergence)."""
    x = torch.zeros(1, 6, 8, 8, 32)
    with pytest.raises(ValueError, match="does not divide"):
        TM.copy_min(x, tile_s, tile_t)


def test_unknown_modes_raise():
    x, _, _, tp = inputs(0)
    with pytest.raises(ValueError, match="unknown mode"):
        TM.fused_diag(torch.from_numpy(x), tp, "fat")
    with pytest.raises(ValueError, match="unknown mode"):
        TP.silu_probe(torch.zeros(8, dtype=torch.bfloat16), "bf16_exp")


@pytest.mark.parametrize("call", ["fat", "diag", "copy", "silu"])
def test_wrappers_take_no_plain_path_off_the_cpu(call):
    """A tensor that is not on the CPU reaches the kernel's checks, never
    the plain version (a meta tensor stands for a CUDA one here)."""
    x = torch.empty(SHAPE, device="meta", dtype=torch.bfloat16)
    tp = TM.params_from_jax(block_params(SHAPE[-1], np.random.RandomState(0)))
    fn = {"fat": lambda: TM.fused_fat(x, tp), "diag": lambda: TM.fused_diag(x, tp, "ln"),
          "copy": lambda: TM.copy_min(x, 64), "silu": lambda: TP.silu_probe(x, "bf16_tanh")}
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fn[call]()


def _ulp_bf16(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.float32(2.0 ** -126))))
    return np.exp2(e - 7)


@pytest.mark.parametrize("mode", ["f32_logistic", "bf16_tanh", "bf16_logistic"])
def test_t4_silu_probe(mode):
    """The JAX probe's kernel (``make_kernel``) in interpret mode with the
    BlockSpecs of its ``run`` on a small bf16 tensor, against the port's
    plain version on the same bf16 values. The two frameworks may round
    bf16 at different places, so each value may differ by at most 2 bf16
    ulps of the JAX value (on this CPU they agree exactly)."""
    shape = (4, 16, 128)
    xs = jnp.asarray(np.random.RandomState(4).randn(*shape).astype(np.float32) * 3,
                     jnp.bfloat16)
    fn = pl.pallas_call(
        PS.make_kernel(mode),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.bfloat16),
        grid=(shape[0],),
        in_specs=[pl.BlockSpec((1,) + shape[1:], lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1,) + shape[1:], lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True)
    want = np.asarray(fn(xs).astype(jnp.float32))
    x = torch.from_numpy(np.array(xs.astype(jnp.float32))).to(torch.bfloat16)
    calls, launches = TP.silu_probe.calls, TP.silu_probe.launches
    got = TP.silu_probe(x, mode)
    assert got.dtype == torch.bfloat16
    assert (TP.silu_probe.calls, TP.silu_probe.launches) == (calls + 1, launches)
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= 2 * _ulp_bf16(want)), float((diff / _ulp_bf16(want)).max())


def test_microbench_main_cpu(capsys):
    """The tool's main at a tiny size on the CPU: every row that can run at
    it, the non-dividing copy tilings reported as not run, and v1 == v0."""
    rows = TM.main(["32", "4", "16", "--device", "cpu"])
    names = [r["name"] for r in rows]
    assert names == ["copy min128", "copy min256", "torch roundtrip", "v0 shipped",
                     "v1 fat", "v2 mm-only", "v3 ln-only", "v4 copy-only"]
    assert all(r["bound_ms"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert out.count("not run: tile") == 3 and "v1 == v0 within atol" in out


def test_probe_main_cpu():
    rows = TP.main(["2", "8", "16", "--device", "cpu"])
    assert [r["name"] for r in rows] == list(TP.MODES)
    assert all(r["bound_by"] == "bytes" for r in rows)


def test_tools_need_a_card_by_default(monkeypatch):
    """Naming no device means the card; without one the tools raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (TM.main, TP.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["8"])


def test_tools_run_as_modules():
    """``python -m`` on both tools, on the CPU, in a fresh process that
    never imports JAX."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for mod, args in (("microbench_temporal", ["16", "3", "8"]),
                      ("probe_silu_bf16", ["2", "4", "8"])):
        r = subprocess.run([sys.executable, "-m", f"vidtok_tpu_torch.tools.{mod}", *args,
                            "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "host (cpu, plain version)" in r.stdout


# -- CPU models of the card's walks (the kernels themselves run on the card) --

def _row_walk(rows, c, t, s):
    """(row, frame, channels) for every row a thread of the exact row passes
    (``csrc/microbench_temporal.cu``) touches, as it walks: blocks of
    ``plan.ROW_WARPS`` warps, a row on LPR lanes, RPT rows a thread RPW
    apart, the frame of its first row by one division and then stepped;
    a lane's vectors from channel C on are masked, touching nothing."""
    lpr, vpl, rpt = plan.row_layout(c)
    rpw = 32 // lpr
    per_block = plan.ROW_WARPS * rpw * rpt
    for block in range(-(-rows // per_block)):
        for warp in range(plan.ROW_WARPS):
            for lane in range(32):
                row0 = (block * plan.ROW_WARPS + warp) * rpw * rpt + lane // lpr
                q = row0 // s
                pos, f = row0 - q * s, q % t
                for k in range(rpt):
                    if k:
                        pos += rpw
                        while pos >= s:
                            pos -= s
                            f = (f + 1) % t
                    row = row0 + k * rpw
                    if row < rows:
                        l = lane % lpr
                        yield row, f, [8 * l + 8 * lpr * i + e for i in range(vpl)
                                       for e in range(8) if 8 * l + 8 * lpr * i < c]


def fat_rows_model(a, t, s):
    """T1's fat-row pass on activated rows ``a`` ``[M, C]``: each row into
    block 2 of its own row, block 1 of the next frame's, block 0 of the one
    after, the blocks before frame 0 zeroed; NaN where nothing wrote."""
    m, c = a.shape
    fat = torch.full((m, 3 * c), float("nan"))
    for row, f, ch in _row_walk(m, c, t, s):
        assert f == (row // s) % t
        if not ch:
            continue
        ch = torch.tensor(ch)
        fat[row, 2 * c + ch] = a[row, ch]
        if f + 1 < t:
            fat[row + s, c + ch] = a[row, ch]
        if f + 2 < t:
            fat[row + 2 * s, ch] = a[row, ch]
        if f < 2:
            fat[row, ch] = 0.0
        if f < 1:
            fat[row, c + ch] = 0.0
    return fat


@pytest.mark.parametrize("shape", [(2, 5, 3, 3, 128), (1, 4, 1, 1, 64), (2, 3, 2, 5, 512),
                                   (1, 3, 2, 2, 768), (2, 5, 3, 3, 96), (1, 4, 1, 1, 40),
                                   (1, 3, 2, 2, 384)])
def test_fat_rows_model_places_each_row(shape):
    """The fat-row walk fills the whole operand exactly as ``_fat`` lays
    it out, with several clips, frames shorter than a warp's rows (S = 1)
    and row layouts of ``plan.row_layout`` with and without masked
    vectors (96, 40, 384 channels)."""
    b, t, h, w, c = shape
    a = torch.randn(shape)
    got = fat_rows_model(a.reshape(-1, c), t, h * w)
    want = TM._fat(a).reshape(-1, 3 * c)
    assert not torch.isnan(got).any()
    assert torch.equal(got, want)


def causal_conv_model(x, weight, pl):
    """T2 ``mm``'s products as the ``kCausal`` loop reads them, tile by tile
    of ``plan.conv_plan_temporal``'s plan: tap k of tile row r is row
    r0 + r + (k - 2) S of the same clip, zero below row 0 (TMA's zero fill)
    or past the clip; rows past the clip are not stored."""
    b, t, h, w, c = x.shape
    s = h * w
    rows = x.reshape(b, t * s, c)
    wk = kmajor_weight(weight, torch.float32)  # [C, 3C], the K-major operand
    out = torch.full((b, t * s, c), float("nan"))
    walk = plan.walk(pl)  # every block's tiles, in the blocks' order
    (clip, r0), n0 = plan.tile_origin(pl, walk[walk % pl.n_tiles == 0])
    assert (n0 == 0).all()
    r = torch.arange(plan.BM)
    for cl, start in zip(clip.tolist(), r0.tolist()):
        acc = torch.zeros(plan.BM, c)
        for k in range(3):
            src = start + r + (k - 2) * s
            ok = (src >= 0) & (src < t * s)
            tile = torch.zeros(plan.BM, c)
            tile[ok] = rows[cl, src[ok]]
            acc += tile @ wk[:, k * c:(k + 1) * c].t()
        keep = start + r < t * s
        out[cl, (start + r)[keep]] = acc[keep]
    return out.reshape(x.shape)


@pytest.mark.parametrize("shape", [(2, 5, 33, 33, 128), (2, 5, 3, 3, 128), (1, 4, 16, 16, 256)])
def test_causal_model_matches_the_plain_mm(shape):
    """T2 ``mm`` built from the ``kCausal`` reads (h rounded as the kernel
    stores it, x added in the second epilogue) against
    ``fused_diag_plain``: M tiles that straddle frames (S = 1089, 9), a
    clip shorter than a tile, two clips, in f32."""
    b, t, h, w, c = shape
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    tp = TM.params_from_jax(block_params(c, rng))
    pl = plan.conv_plan_temporal(b, t, h * w, c)
    hh = causal_conv_model(x, tp["conv1"][0], pl)
    got = x + causal_conv_model(hh, tp["conv2"][0], pl)
    want = TM.fused_diag_plain(x, tp, "mm")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_dense_model_matches_the_fat_product():
    """T1's ``kDense`` product over ``conv_plan_dense``'s M tiles of the
    fat operand (rows past M not stored) equals the plain fat product."""
    b, t, h, w, c = 2, 5, 3, 3, 128
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(b, t, h, w, c).astype(np.float32))
    weight = torch.from_numpy(rng.randn(c, c, 3).astype(np.float32) * 0.1)
    fat = TM._fat(a).reshape(-1, 3 * c)
    m = fat.shape[0]
    pl = plan.conv_plan_dense(m, 3 * c, c)
    walk = plan.walk(pl)
    (clip, r0), _ = plan.tile_origin(pl, walk[walk % pl.n_tiles == 0])
    assert (clip == 0).all()
    out = torch.full((m, c), float("nan"))
    wk = kmajor_weight(weight, torch.float32)
    for start in r0.tolist():
        rows = torch.arange(start, min(start + plan.BM, m))
        out[rows] = fat[rows] @ wk.t()
    want = TM._tconv(a, weight).reshape(m, c)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


def row_stats_model(x, lpr):
    """The exact two-pass statistics of ``row_stats_exact`` (``common.cuh``)
    over rows ``x`` ``[R, C]`` in f32: lane l sums channels 8l + 8 LPR i + e
    in order, the lanes' sums reduced by xor shuffles over LPR lanes; the
    mean, then the mean of squared deviations, of which a masked vector
    (from channel C on: zeros) adds none. Returns (mu, rs), each
    ``[R, LPR]``: every lane's copy."""
    x = x.astype(np.float32)
    r, c = x.shape
    vpl = -(-c // (8 * lpr))
    pad = 8 * lpr * vpl - c
    x = np.concatenate([x, np.zeros((r, pad), np.float32)], axis=1)
    valid = np.arange(8 * lpr * vpl) < c
    lanes = x.reshape(r, vpl, lpr, 8).transpose(0, 2, 1, 3).reshape(r, lpr, 8 * vpl)
    lane_ok = valid.reshape(vpl, lpr, 8).transpose(1, 0, 2).reshape(lpr, 8 * vpl)

    def reduce(v):
        s = np.zeros((r, lpr), np.float32)
        for j in range(v.shape[-1]):
            s = s + v[..., j]
        o = lpr // 2
        while o:
            s = s + s[:, np.arange(lpr) ^ o]
            o //= 2
        return s

    mu = reduce(lanes) / np.float32(c)
    d = reduce(np.where(lane_ok, (lanes - mu[..., None]) ** 2, np.float32(0)))
    rs = np.float32(1) / np.sqrt(d / np.float32(c) + np.float32(1e-6))
    return mu, rs


ROW_WIDTHS = (8, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


@pytest.mark.parametrize("c", ROW_WIDTHS)
def test_row_stats_model_matches_ln_silu_exact(c):
    """The exact statistics split over LPR lanes (every lane of a row with
    the same pair) give ``ln_silu_exact_f32`` at each row layout, masked
    vectors included (8, 32, 96, 192, 384 channels), on rows whose mean is
    far from 0 (the two-pass form's case)."""
    rng = np.random.RandomState(c)
    x = (rng.randn(6, c) * 3 + 40).astype(np.float32)
    g = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    lpr = plan.row_layout(c)[0]
    mu, rs = row_stats_model(x, lpr)
    assert (mu == mu[:, :1]).all() and (rs == rs[:, :1]).all()
    y = (x - mu[:, :1]) * rs[:, :1] * g + b
    got = y / (1 + np.exp(-y))
    want = ln_silu_exact_f32(*(torch.from_numpy(v) for v in (x, g, b))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_row_layout_matches_the_source():
    """``plan.row_layout`` is ``common.cuh``'s VT_ROW_LAYOUTS, which every
    row pass (``act_rows_kernel``, T1's and T2's exact passes) launches
    with, at every C % 8 == 0 up to 1024: LPR a power of two from 8 to 32
    (the xor shuffles stay within a row), the fewest vectors that hold C,
    none for another C."""
    src = open(os.path.join(ROOT, "vidtok_tpu_torch", "csrc", "common.cuh")).read()
    macro = src[src.index("#define VT_ROW_LAYOUTS"):]
    macro = macro[:macro.index("\n\n")]
    guard = re.search(r"\(C\) % (\d+) == 0 && \(C\) >= (\d+) && \(C\) <= (\d+)", macro)
    assert tuple(map(int, guard.groups())) == (plan.C_ALIGN, plan.C_ALIGN, plan.C_MAX)
    cases = [(int(n), tuple(map(int, lvr))) for n, *lvr in re.findall(
        r"if \(\(C\) <= (\d+)\) CASE\((\d+), (\d+), (\d+)\)", macro)]
    last = re.search(r"else CASE\((\d+), (\d+), (\d+)\)\s*\\", macro)
    cases.append((plan.C_MAX, tuple(map(int, last.groups()))))
    for c in range(plan.C_ALIGN, plan.C_MAX + 1, plan.C_ALIGN):
        got = next(layout for top, layout in cases if c <= top)
        assert got == plan.row_layout(c), c
        lpr, vpl, _ = got
        assert lpr in (8, 16, 32) and 8 * lpr * (vpl - 1) < c <= 8 * lpr * vpl
        assert lpr == 32 or c <= 8 * lpr


def test_no_wmma_loop_left():
    """T1 and T2 run the TMA + wgmma loop: no source of the port uses the
    older ``wmma`` loop."""
    csrc = os.path.join(ROOT, "vidtok_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        text = open(os.path.join(csrc, name)).read()
        assert "wmma::" not in text and "igemm" not in text, name
