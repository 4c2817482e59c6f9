"""The port's VidTwin against the benchmark's plain float32 reference of it
(``vtbench/reference/vidtwin.py``), on the CPU at the module's tiny size
(width 64, depth 2, 4 heads, 16 x 32 x 32 clips in 4 x 4 patches) with the
reference's seeded weights.

* ``forward``'s z and x_rec and ``encode``'s u_S, u_Dx, u_Dy agree with the
  reference's with the port's attention in float32, and stay within twice
  the reference's own bf16 distance with the port's bf16 attention.
* The reference's parameters are the port's full-width state dict, key by
  key and shape by shape: 311,518,770 in all.
* The reference encoder is causal in time.
* The reference's FLOP count of a ``[32,3,16,224²]`` request is the hand
  count's ~63 TFLOP.
"""

import json
from pathlib import Path

import pytest
import torch

from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.models.vidtwin.vidtwin_ae import build_vidtwin_from_config
from vtbench.reference import vidtwin as R
from vtbench.reference import weights as W

torch.set_num_threads(2)
CPU = torch.device("cpu")
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "vtbench" / "configs"
                     / "vidtwin_structure_7_7_8_dynamics_7_8.json").read_text())
TINY = R.tiny(CONFIG)
SEED = 2**40 + 29
CLIP = (2, 3, 16, 32, 32)
# Two float32 evaluations of the same function in different op orders (SDPA
# and a written-out softmax, fused and split qkv heads) differ by ~2e-7 of
# the norm at this size; 1e-4 leaves room for another CPU's kernels and is
# still far below the 1e-3 that bf16 attention alone gives.
F32_RTOL = 1e-4


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def setup():
    spec = R.read_config(TINY)
    params = R.weights(spec, SEED, CPU)
    tok = load_model_from_config(TINY, device="cpu", compute_dtype=torch.float32)
    R.load(tok, params, {})
    x = W.clip(SEED, 0, CLIP, CPU)
    return spec, params, tok, x


def set_attn(tok, dtype):
    tok.model.encoder.set_attn_dtype(dtype)
    tok.model.decoder.set_attn_dtype(dtype)


def answers(tok, x):
    z, rec, _ = tok(x)
    return (z, rec) + tuple(tok.encode(x)[:3])


def reference(params, spec, x, quant="none"):
    ctx = R.Ctx(params, spec, quant)
    z, rec = R.forward(ctx, x)
    return (z, rec) + R.encode(ctx, x)[1:]


def test_port_matches_reference_in_f32(setup):
    spec, params, tok, x = setup
    set_attn(tok, None)
    try:
        got = answers(tok, x)
    finally:
        set_attn(tok, torch.bfloat16)
    want = reference(params, spec, x)
    names = ("z", "x_rec", "u_S", "u_Dx", "u_Dy")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert rel(g, w) < F32_RTOL, (name, rel(g, w))
    assert want[0].shape == (2, 64, 16, 8, 8) and want[1].shape == CLIP
    assert want[2].shape == (2, 16, 4, 4, 8)
    assert want[3].shape == want[4].shape == (2, 8, 16, 4)


def test_port_in_bf16_attention_within_the_references_bf16_distance(setup):
    """The port's default rounds q, k and v to bf16; the reference's bf16
    rounds both operands of every product, so its distance from its own
    float32 answer bounds the port's, with a factor 2 for the different
    places the two round."""
    spec, params, tok, x = setup
    got = answers(tok, x)
    want = reference(params, spec, x)
    bf16 = reference(params, spec, x, "bf16")
    for name, g, w, b in zip(("z", "x_rec", "u_S", "u_Dx", "u_Dy"), got, want, bf16):
        assert 0 < rel(g, w) <= 2 * rel(b, w), (name, rel(g, w), rel(b, w))


def test_param_shapes_are_the_ports_full_width_state_dict():
    spec = R.read_config(CONFIG)
    with torch.device("meta"):
        model, _ = build_vidtwin_from_config(CONFIG["model"])
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert R.param_shapes(spec) == got
    n = sum(torch.Size(s).numel() for s in R.param_shapes(spec).values())
    assert n == CONFIG["parameters"] == 311_518_770


def test_reference_encoder_is_causal(setup):
    """Changing frame k leaves the tokens of frames before k as they were
    (exactly: the masked scores add exact zeros) and moves frame k's."""
    spec, params, _, x = setup
    ctx = R.Ctx(params, spec)
    k = 9
    y = x.clone()
    y[:, :, k] = -y[:, :, k]
    z, zy = R.encoder(ctx, x), R.encoder(ctx, y)
    assert torch.equal(z[:, :, :k], zy[:, :, :k])
    assert rel(zy[:, :, k], z[:, :, k]) > 0.01


def test_model_flops_is_the_hand_count():
    """~63 TFLOP a [32,3,16,224²] request: per block 0.47 TFLOP for each
    attention's qkv and projection, 0.95 for the MLP, 0.06 for the spatial
    attention's two products; 32 blocks and ~0.6 TFLOP of patch embedding,
    head, Q-Former and pyramid (the motion path's strided conv the most)."""
    spec = R.read_config(CONFIG)
    flops = R.model_flops(spec, {"entry": "forward"}, (32, 3, 16, 224, 224), True)
    assert abs(flops / 63e12 - 1) < 0.1, flops
    tokens = 32 * 16 * 196
    per_block = 2 * tokens * 768 * (2 * (3 * 768 + 768) + 2 * 3072)
    assert flops > 32 * per_block
