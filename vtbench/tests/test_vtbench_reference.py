"""The benchmark's yardstick on the CPU: the plain reference against the
port's plain path at ch 32, and the frozen kernel-call model against the
port's recorded calls and ``chip_smoke``'s launch counts."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from vtbench.reference import model as R
from vtbench.reference import weights as W
from vtbench.reference import work as Wk
from vtbench_tiny import BENCH, CHECKOUT, tiny_config

torch.set_num_threads(2)
CPU = torch.device("cpu")
TOL = 2e-5  # relative L2 of two f32 evaluations in different op orders
V1_0, V1_1 = "vidtok_kl_causal_488_16chn", "vidtok_kl_causal_488_16chn_v1_1"


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def port(cfg: dict, seed: int, fused: bool = False):
    import vidtok_tpu_torch

    tok = vidtok_tpu_torch.load_model_from_config(cfg, device="cpu",
                                                  compute_dtype=torch.float32, fused=fused)
    tok.core.load_state_dict(W.state_dict(R.spec_of(cfg), seed, CPU), strict=True)
    return tok


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("name", [V1_0, V1_1])
def test_forward_matches_port(name):
    cfg = tiny_config(config(name))
    tok = port(cfg, 11)
    x = W.clip(11, 0, (1, 3, 17, 32, 32), CPU)
    z, rec, _ = tok(x)
    ctx = R.Ctx(W.state_dict(R.spec_of(cfg), 11, CPU), R.spec_of(cfg))
    z_ref, rec_ref = R.forward(ctx, x)
    assert z.shape == z_ref.shape and rec.shape == rec_ref.shape == x.shape
    assert rel(z, z_ref) < TOL and rel(rec, rec_ref) < TOL


def test_v1_0_chunked_forward_is_the_whole_clip():
    cfg = tiny_config(config(V1_0))
    ctx = R.Ctx(W.state_dict(R.spec_of(cfg), 3, CPU), R.spec_of(cfg))
    x = W.clip(3, 1, (1, 3, 21, 32, 32), CPU)
    z, rec = R.forward(ctx, x)
    zc, recc = R.forward(ctx, x, chunk_latents=2)
    assert rel(zc, z) < TOL and rel(recc, rec) < TOL


def test_tiled_forward_and_stream_match_port():
    cfg = tiny_config(config(V1_1))
    tok = port(cfg, 5)
    tok.use_tiling, tok.use_overlap, tok.t_chunk_enc, tok.t_chunk_dec = True, True, 8, 2
    x = W.clip(5, 2, (1, 3, 33, 32, 32), CPU)
    z, rec, _ = tok(x)
    ctx = R.Ctx(W.state_dict(R.spec_of(cfg), 5, CPU), R.spec_of(cfg))
    z_ref, rec_ref = R.forward_tiled(ctx, x, 8)
    assert z.shape == z_ref.shape and rec.shape == rec_ref.shape == x.shape
    assert rel(z, z_ref) < TOL and rel(rec, rec_ref) < TOL
    cache = old = None
    for s, e in R.chunk_bounds(33, 8):
        zc, _, cache = tok.encode_chunk(x[:, :, s:e], cache)
        zr, old = R.encode_chunk(ctx, x[:, :, s:e], old)
        assert rel(zc, zr) < TOL


def test_fp8_control_departs_from_the_reference():
    cfg = tiny_config(config(V1_0))
    sd = W.state_dict(R.spec_of(cfg), 9, CPU)
    x = W.clip(9, 0, (1, 3, 17, 32, 32), CPU)
    z, rec = R.forward(R.Ctx(sd, R.spec_of(cfg)), x)
    zq, recq = R.forward(R.Ctx(sd, R.spec_of(cfg), "fp8"), x)
    assert rel(zq, z) > 0.05 and rel(recq, rec) > 0.1


def test_launch_counts_of_chip_smoke():
    """20/20/3/1/2 launches of A/B/C/D/E per v1.0 [1,3,17,256^2] forward;
    100/100/15/5 of A/F/C/D per tiled v1.1 T=65 forward (E and B none)."""
    v10 = Wk.launches(Wk.kernel_calls(config(V1_0), (1, 3, 17, 256, 256)))
    assert dict(v10) == {"fused_spatial_resblock": 20, "fused_temporal_resblock": 20,
                         "subpixel_interleave": 3, "decoder_tail_rgb": 1,
                         "parity_up2x_fused": 2}
    tiled = Wk.launches(Wk.kernel_calls(config(V1_1), (1, 3, 65, 256, 256), "forward_tiled"))
    assert dict(tiled) == {"fused_spatial_resblock": 100,
                           "fused_temporal_resblock_stream": 100,
                           "subpixel_interleave": 15, "decoder_tail_rgb": 5}


@pytest.mark.parametrize("name,entry,t", [(V1_0, "forward", 17), (V1_1, "forward", 17),
                                          (V1_1, "forward_tiled", 33),
                                          (V1_1, "encode_chunk", 1),
                                          (V1_1, "encode_chunk", 8)])
def test_kernel_calls_match_the_port(name, entry, t):
    """The frozen call model gives the calls, keys and all, that the port's
    wrappers record (their plain versions on the CPU)."""
    from vidtok_tpu_torch.ops import kernels as K

    cfg = tiny_config(config(name))
    tok = port(cfg, 1, fused=True)
    x = W.clip(1, 0, (1, 3, 33, 32, 32), CPU)
    first = True
    if entry == "forward_tiled":
        tok.use_tiling, tok.use_overlap, tok.t_chunk_enc, tok.t_chunk_dec = True, True, 8, 2
    cache = None
    if entry == "encode_chunk" and t > 1:
        _, _, cache = tok.encode_chunk(x[:, :, :1])
        first = False
    K.reset_counts()
    if entry == "encode_chunk":
        tok.encode_chunk(x[:, :, 1:1 + t] if cache is not None else x[:, :, :t], cache)
    else:
        tok(x[:, :, :t])
    want = Wk.launches(Wk.kernel_calls(cfg, (1, 3, t, 32, 32), entry, first, 8))
    assert {k: v for k, v in K.counts("calls").items() if v} == dict(want)


def test_work_counts_flops_of_the_model():
    """The FLOP counter's total of a v1.0 request is at least the kernels'
    share of it (the kernels do part of the model's convs)."""
    cfg = config(V1_0)
    shape = (1, 3, 17, 256, 256)
    flops = Wk.model_flops(cfg, shape)
    kernel = sum(k * Wk.work(n, key)[1] for (n, key), k in Wk.kernel_calls(cfg, shape).items())
    assert 0.5 * flops < kernel < flops
    assert 15e12 < flops < 30e12


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("vidtok_tpu_torch", "vidtok_tpu", "jax",
                                               "jaxlib", "flax"), (path.name, n)
    code = ("import sys, vtbench.reference.model, vtbench.reference.weights, "
            "vtbench.reference.work; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & {"vidtok_tpu_torch", "vidtok_tpu", "jax", "jaxlib", "flax"}
