"""The PyTorch port's non-causal variant and GroupNorm against ``vidtok_tpu``.

* ``GroupNorm`` in its four statistic modes against JAX's (2e-5).
* The non-causal blocks (temporal and 3D resblocks, attention, the
  temporal down- and upsample), with layernorm and groupnorm, against
  their JAX modules (2e-4).
* A tiny non-causal KL model and a tiny non-causal FSQ model
  (``tests/test_parity.py``'s ``noncausal_kl`` shape) end to end, the
  port with ``fused`` False and True against JAX with ``fused`` False and
  True (JAX's A and C in interpret mode); the kernel call sites: A and C
  only (B, D, E and F are causal-only).
* A small causal v1.0 groupnorm model (``tests/test_parity.py``'s
  ``causal_v1_groupnorm``, at 128 channels) with ``fused`` on: A, B and D stay off (they
  compute LayerNorm), as JAX's gates have it.
* Tiling a non-causal model raises.

Weights are random from numpy seeds, carried across by
``convert.state_dict_from_jax`` and the port's checkpoint loader; fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu.modules.blocks as JB
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.modules.norms import GroupNorm as JGroupNorm
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.modules.norms import GroupNorm
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.utils.checkpoint import canonical, load_into

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)

# tests/test_parity.py:22-29 and its noncausal_kl case (T = 8)
_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2, 2], "time_downsample_factor": 4,
      "num_res_blocks": 1, "dropout": 0.0, "norm_type": "layernorm",
      "tempo_ds": [0, 1], "tempo_us": [1, 2]}
FSQ_REG = {"target": "FSQRegularizer", "params": {
    "levels": [8, 8, 8, 5, 5, 5], "entropy_loss_weight": 0.1,
    "commitment_loss_weight": 0.25}}


def model_cfg(enc, dec, params, reg=None):
    return {"params": {
        "encoder_config": {"target": enc, "params": dict(params)},
        "decoder_config": {"target": dec, "params": dict(params)},
        "regularizer_config": reg or {"target": "DiagonalGaussianRegularizer"}}}


NONCAUSAL = {"kl": model_cfg("Encoder3D", "Decoder3D", _P),
             "fsq": model_cfg("vidtok.modules.model_3dnoncausal.Encoder3D",
                              "vidtok.modules.model_3dnoncausal.Decoder3D",
                              dict(_P, double_z=False, z_channels=6), FSQ_REG)}
# tests/test_parity.py:69-71 at ch 128: at 32 and 64 channels the causal
# temporal blocks' per-position statistics span 1 or 2 channels a group,
# where f32 rounding is amplified (JAX and the port both land 5e-2 (ch 32)
# and 3e-3 (ch 64) from a float64 run of the port); at 128 both are within
# 3e-5 of it
GROUPNORM = model_cfg("EncoderCausal3D", "DecoderCausal3D", dict(
    _P, ch=128, ch_mult=[1, 2], tempo_ds=[0], tempo_us=[1], norm_type="groupnorm",
    time_downsample_factor=2))


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def randomize(tree, rng):
    """Random leaves: norm scales 1 +- 0.2, everything else N(0, 0.08)
    (non-zero norm biases and temporal conv2)."""
    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.08 * r

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load_port(module, params, path=(), prefix=""):
    """A JAX tree placed at ``path`` of the model (torch prefix ``prefix``)
    into ``module``, through ``state_dict_from_jax`` and the checkpoint
    loader's key matching."""
    for name in reversed(path):
        params = {name: params}
    sd = {canonical(k)[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(params).items()}
    load_into(module, sd)
    return module


@pytest.mark.parametrize("mode", ["frame", "video", "position", "column"])
def test_group_norm(mode):
    x = rand(2, 3, 4, 5, 64) * 2 + 0.5
    jm = JGroupNorm(mode=mode)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                  np.random.RandomState(0))
    tm = GroupNorm(64, mode)
    tm.load_state_dict({"weight": torch.from_numpy(np.array(p["scale"])),
                        "bias": torch.from_numpy(np.array(p["bias"]))})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": p}, x)),
                               rtol=2e-5, atol=2e-5)


def _block(name, c, norm_type):
    """(JAX module, port module, input shape, JAX path, torch prefix)."""
    nt = dict(norm_type=norm_type)
    if name == "temporal":
        return (JB.ResnetBlockTemporal(c, causal=False, **nt),
                TB.ResnetBlockTemporal(c, c, causal=False, **nt), (1, 6, 4, 3, c),
                ("encoder", "down_temporal_1_block_0"), "encoder.down_temporal.1.block.0.")
    if name == "3d":
        return (JB.ResnetBlock3D(c, causal=False, **nt),
                TB.ResnetBlock3D(c, c, causal=False, **nt), (1, 4, 5, 6, c),
                ("encoder", "mid_block_1"), "encoder.mid.block_1.")
    if name == "attention":
        return (JB.AttnBlock(causal=False, **nt), TB.AttnBlock(c, causal=False, **nt),
                (2, 3, 4, 5, c), ("decoder", "mid_attn_1"), "decoder.mid.attn_1.")
    if name == "downsample":
        return (JB.TimeDownsampleRes2x(c, causal=False),
                TB.TimeDownsampleRes2x(c, c, causal=False), (1, 6, 4, 5, c),
                ("encoder", "down_temporal_1_downsample"),
                "encoder.down_temporal.1.downsample.")
    return (JB.TimeUpsampleRes2x(c, causal=False), TB.TimeUpsampleRes2x(c, c, causal=False),
            (1, 3, 4, 5, c), ("decoder", "up_temporal_1_upsample"),
            "decoder.up_temporal.1.upsample.")


@pytest.mark.parametrize("name,norm_type", [
    (name, nt) for name in ("temporal", "3d", "attention")
    for nt in ("layernorm", "groupnorm")] + [("downsample", None), ("upsample", None)])
def test_noncausal_block(name, norm_type):
    """The resamplers hold no norm."""
    jm, tm, shape, path, prefix = _block(name, 64, norm_type)
    x = rand(*shape) * 0.5
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                  np.random.RandomState(0))
    load_port(tm, p, path, prefix)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": p}, x)),
                               **TOL)


def _jax_model(cfg, x, seed=0):
    """JAX core, meta and random params of ``cfg`` on the NCTHW clip x."""
    core, meta = j_build(cfg)
    v = jax.eval_shape(lambda: core.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)), sample_override=False))
    return core, meta, randomize(v["params"], np.random.RandomState(seed))


def _check_model(cfg, x, fused, want_calls):
    """The port's forward (``fused`` as given) against JAX's with ``fused``
    False and True; the kernel wrappers' calls must be ``want_calls``."""
    core, meta, params = _jax_model(cfg, x)
    tok = load_model_from_config({"model": cfg}, device="cpu", fused=fused)
    load_port(tok.core, params)
    assert tok.meta["is_causal"] == (meta["variant"] != "noncausal")
    K.reset_counts()
    z, dec, log = tok(x)
    want = dict.fromkeys(K.WRAPPERS, 0)
    if fused:
        want.update(want_calls)
    assert K.counts("calls") == want
    assert dec.shape == x.shape
    loss = "aux_loss" if meta["discrete"] else "kl_loss"
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    for j_fused in (False, True):
        zj, dj, lj = jax.jit(lambda p, x: core.apply(
            {"params": p}, x, sample_override=False, fused=j_fused))(params, xt)
        np.testing.assert_allclose(z.numpy(), np.asarray(zj).transpose(0, 4, 1, 2, 3),
                                   **TOL)
        np.testing.assert_allclose(dec.numpy(), np.asarray(dj).transpose(0, 4, 1, 2, 3),
                                   **TOL)
        np.testing.assert_allclose(float(log[loss]), float(lj[loss]), rtol=1e-4)
    return tok, log


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["kl", "fsq"])
def test_tiny_noncausal_end_to_end(kind, fused):
    """Kernel A in every spatial resblock (3 encoder, 6 decoder), C in both
    spatial upsamples; no B, D, E or F."""
    x = np.clip(rand(1, 3, 8, 16, 16) * 0.5, -1, 1)
    tok, log = _check_model(NONCAUSAL[kind], x, fused,
                            dict(fused_spatial_resblock=9, subpixel_interleave=2))
    assert tok.meta["variant"] == "noncausal" and not tok.meta["is_causal"]
    if kind == "fsq":
        assert log["indices"].shape == (1, 2, 4, 4)


def test_tiny_causal_groupnorm_fused():
    """GroupNorm with ``fused`` on: A, B and D (LayerNorm kernels) are never
    called; C and E, which hold no norm, are."""
    x = np.clip(rand(1, 3, 5, 16, 16, seed=2) * 0.5, -1, 1)
    _check_model(GROUPNORM, x, True, dict(subpixel_interleave=1, parity_up2x_fused=1))


def test_noncausal_refuses_tiling():
    """Chunks of a non-causal clip carry no state: the engine and the
    modules refuse to stream it."""
    tok = load_model_from_config({"model": NONCAUSAL["kl"]}, device="cpu")
    tok.use_tiling = True
    with pytest.raises(ValueError, match="needs a causal model"):
        tok.encode(np.zeros((1, 3, 8, 16, 16), np.float32))
    with pytest.raises(ValueError, match="no streaming form"):
        tok.core.encode(torch.zeros(1, 8, 16, 16, 3), streaming=True)
