"""The port's temporal microbenchmark and SiLU probe (T1-T4) against the JAX
package's tools (``tools/microbench_temporal.py``, ``tools/probe_silu_bf16.py``).

The JAX tools' Pallas kernels run in interpret mode on the CPU; the port's
wrappers, given CPU tensors, run their plain versions. Parameters are
random, norm and conv biases included (``ln_silu(0) != 0``). T1-T3 in fp32
at rtol 1e-4, atol 2e-4 (the repo's golden bound; copies exactly); T4 in
bf16, its own tolerance below.
"""

import os
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
from vidtok_tpu_torch.ops.kernels.act import ln_silu_exact_f32
from vidtok_tpu_torch.ops.kernels.fused_temporal import gemm_weight
from vidtok_tpu_torch.tools import microbench_temporal as TM
from vidtok_tpu_torch.tools import probe_silu_bf16 as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import microbench_temporal as MT  # noqa: E402  (the JAX tool)
import probe_silu_bf16 as PS  # noqa: E402  (the JAX tool)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)
SHAPE = (1, 5, 8, 8, 32)  # S = 64 positions: one tile_s = 64 grid step
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


def test_t1_fused_fat():
    x, _, jp, tp = inputs(0)
    want = MT.fused_fat(jnp.asarray(x), jp, tile_s=TILE_S)
    calls, launches = TM.fused_fat.calls, TM.fused_fat.launches
    got = TM.fused_fat(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (TM.fused_fat.calls, TM.fused_fat.launches) == (calls + 1, launches)


@pytest.mark.parametrize("mode", ["copy", "mm", "ln"])
def test_t2_fused_diag(mode):
    x, _, jp, tp = inputs(1)
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
