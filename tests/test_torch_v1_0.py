"""The PyTorch port's v1.0 causal path against ``vidtok_tpu``.

* Kernel E's plain version (``parity_up2x_fused_plain``) against the JAX
  package's ``parity_up2x_fused`` in interpret mode, against its XLA form
  (``_parity_up2x_conv_blend(..., allow_pallas=False)``) and against the
  port's own nearest upsample + ``CausalConv3d`` + blend.
* ``TimeUpsampleRes2x`` in nearest mode against the JAX module.
* The tiny v1.0 KL model of ``tests/test_fast_paths.py`` with random
  parameters: T=5 (padded by tdf-1) and T=4 (not padded), the port with
  ``fused`` True and False against JAX with ``fused`` False and True.
* The tiny v1.0 FSQ model (entropy and commitment losses on): indices and
  codes exactly equal to JAX's, ``aux_loss`` within rtol 1e-4 (also under
  entropy-weight annealing), ``decode_indices`` exactly equal, and
  decoding from indices equal to the forward's reconstruction.
* FSQ's options one by one (two codebooks, a projection, the diversity
  gamma, the inverse temperature) against JAX's regularizer.
* Weights: the converter round trip for v1.0, and the full-width shapes
  of the v1.0 KL 16-channel and FSQ 4096 models against ``jax.eval_shape``.

fp32; rtol 1e-4, atol 2e-4 (the repo's golden bound). On CPU tensors the
kernel wrappers run their plain versions and launch nothing.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu.modules.blocks as JB
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.ops.pallas.parity_upsample_fused import parity_up2x_fused as j_parity
from vidtok_tpu.utils.checkpoint import convert_torch_state_dict
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.models.autoencoder import build_core_from_config
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.modules.conv import CausalConv3d
from vidtok_tpu_torch.modules.interp import temporal_nearest_up2x
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels.parity_upsample import parity_up2x_fused_plain

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=2e-4)

# tests/test_fast_paths.py:205-211, v1.0
_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2], "time_downsample_factor": 2,
      "num_res_blocks": 1, "norm_type": "layernorm",
      "init_pad_mode": "replicate", "tempo_ds": [0], "tempo_us": [1]}
CFG = {"params": {
    "encoder_config": {"target": "EncoderCausal3D", "params": dict(_P)},
    "decoder_config": {"target": "DecoderCausal3D", "params": dict(_P)},
    "regularizer_config": {"target": "DiagonalGaussianRegularizer"},
}}
# the same model with the FSQ bottleneck of configs/vidtok_fsq_causal_488_*
# (even and odd levels; losses on, annealing over 2000 steps)
_PQ = dict(_P, double_z=False, z_channels=4)
FSQ_PARAMS = {"levels": [8, 5, 5, 5], "entropy_loss_weight": 0.1,
              "entropy_loss_annealing_steps": 2000,
              "entropy_loss_annealing_factor": 3,
              "commitment_loss_weight": 0.25}
FSQ_CFG = {"params": {
    "encoder_config": {"target": "EncoderCausal3D", "params": dict(_PQ)},
    "decoder_config": {"target": "DecoderCausal3D", "params": dict(_PQ)},
    "regularizer_config": {"target": "FSQRegularizer", "params": FSQ_PARAMS},
}}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def random_params(core, x, seed=0):
    """Random leaves in the shapes of the JAX init on ``x`` (channels-last):
    norm scales 1 +- 0.2, everything else N(0, 0.08) (non-zero norm biases
    and temporal conv2)."""
    rng = np.random.RandomState(seed)
    v = jax.eval_shape(lambda: core.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.asarray(x), sample_override=False))

    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.08 * r

    return jax.tree_util.tree_map_with_path(leaf, v["params"])


def load_jax_params(module, params):
    sd = {k: t(v) for k, v in state_dict_from_jax(params).items()}
    module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_kernel_e_plain(mode):
    """test_fast_paths.py:159-176's shapes and seed, C=64."""
    from vidtok_tpu.modules.blocks import _parity_up2x_conv_blend

    rng = np.random.RandomState(1)
    s = rng.randn(1, 3, 8, 16, 64).astype("float32")
    k = rng.randn(3, 3, 3, 64, 64).astype("float32") * 0.05
    bias = rng.randn(64).astype("float32") * 0.1
    want = j_parity(jnp.asarray(s), jnp.asarray(k), jnp.asarray(bias), 0.3, mode,
                    interpret=True)
    want_xla = _parity_up2x_conv_blend(jnp.asarray(s), jnp.asarray(k),
                                       jnp.asarray(bias), 0.3, mode,
                                       allow_pallas=False)
    weight = t(k.transpose(4, 3, 0, 1, 2))                  # OIDHW
    alpha = torch.tensor([0.3])
    got = parity_up2x_fused_plain(t(s), weight, t(bias), alpha, mode)
    assert got.shape == (1, 6, 8, 16, 64)
    close(got, want)
    close(got, want_xla)
    # the unfactored form: duplicate frames, causal 3x3x3 conv, blend
    conv = CausalConv3d(64, 64, 3, first_pad_mode=mode)
    conv.load_state_dict({"conv.weight": weight, "conv.bias": t(bias)})
    with torch.no_grad():
        up = temporal_nearest_up2x(t(s))
        close(got, 0.3 * up + 0.7 * conv(up))
    K.reset_counts()
    close(K.parity_up2x_fused(t(s), weight, t(bias), alpha, mode), want)
    assert K.counts("calls")["parity_up2x_fused"] == 1
    assert K.counts()["parity_up2x_fused"] == 0             # CPU: no launch


@pytest.mark.parametrize("dtype,mode", [
    (torch.bfloat16, "edge"), (torch.bfloat16, "zero"), (torch.float16, "zero")])
def test_kernel_e_wrapper_refuses(dtype, mode):
    """Off the CPU the wrapper launches the kernel or raises: an unknown
    mode, a dtype it does not take (bf16 and f32 it does), or a tensor that
    is not on a CUDA device (the meta device stands in here), never reaches
    the plain version."""
    c = 64
    s = torch.empty((1, 2, 4, 4, c), dtype=dtype, device="meta")
    weight = torch.empty((c, c, 3, 3, 3), device="meta")
    bias = torch.empty((c,), device="meta")
    K.reset_counts()
    with pytest.raises(ValueError):
        K.parity_up2x_fused(s, weight, bias, torch.ones(1, device="meta"), mode)
    assert K.counts("calls")["parity_up2x_fused"] == 1
    assert K.counts()["parity_up2x_fused"] == 0


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_time_upsample_nearest(mode):
    """The parity form, kernel E's wrapper when fused; JAX runs its Pallas
    kernel in interpret mode."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 3, 6, 8, 16).astype(np.float32)
    jm = JB.TimeUpsampleRes2x(16, interpolation_mode="nearest", first_pad_mode=mode)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.randn(*a.shape).astype(np.float32)), v)
    want = jm.apply({"params": p}, jnp.asarray(x))
    tm = TB.TimeUpsampleRes2x(16, 16, first_pad_mode=mode,
                              interpolation_mode="nearest")
    sd = state_dict_from_jax({"decoder": {"up_temporal_1_upsample": p}})
    prefix = "decoder.up_temporal.1.upsample."
    tm.load_state_dict({k[len(prefix):]: t(a) for k, a in sd.items()}, strict=True)
    for fused in (False, True):
        K.reset_counts()
        with torch.no_grad():
            close(tm(t(x), fused=fused), want)
        assert K.counts("calls")["parity_up2x_fused"] == int(fused)
    with pytest.raises(ValueError):
        TB.TimeUpsampleRes2x(8, 16, interpolation_mode="nearest")


@pytest.fixture(scope="module")
def tiny():
    """JAX core, random params, a [1, 3, 5, 32, 32] clip, and the JAX
    outputs (z, dec, kl_loss) by (frames, fused), computed once."""
    core, _ = j_build(CFG)
    x = np.clip(np.random.RandomState(0).randn(1, 3, 5, 32, 32) * 0.5, -1, 1)
    x = x.astype(np.float32)
    params = random_params(core, x.transpose(0, 2, 3, 4, 1))
    outs = {}

    def jax_out(frames, fused):
        if (frames, fused) not in outs:
            xt = jnp.asarray(x[:, :, :frames].transpose(0, 2, 3, 4, 1))
            z, dec, log = jax.jit(lambda p, v: core.apply(
                {"params": p}, v, sample_override=False, fused=fused))(params, xt)
            outs[frames, fused] = (np.asarray(z).transpose(0, 4, 1, 2, 3),
                                   np.asarray(dec).transpose(0, 4, 1, 2, 3),
                                   float(log["kl_loss"]))
        return outs[frames, fused]

    return params, x, jax_out


@pytest.mark.parametrize("frames", [5, 4])
@pytest.mark.parametrize("fused", [True, False])
def test_tiny_v1_0_end_to_end(tiny, fused, frames):
    """T=5 is padded by tdf-1 = 1 frame and decodes 5 frames; T=4 is not
    padded and decodes 4 - (tdf-1) = 3 frames, as in JAX."""
    params, x, jax_out = tiny
    x = x[:, :, :frames]
    tok = load_model_from_config({"model": CFG}, device="cpu", fused=fused)
    assert tok.meta["variant"] == "causal" and not tok.meta["discrete"]
    load_jax_params(tok.core, params)
    K.reset_counts()
    z, dec, log = tok(x)
    calls = K.counts("calls")
    want = dict.fromkeys(K.WRAPPERS, 0)
    if fused:
        want.update(fused_spatial_resblock=6, fused_temporal_resblock=6,
                    subpixel_interleave=1, decoder_tail_rgb=1,
                    parity_up2x_fused=1)
    assert calls == want
    assert all(n == 0 for n in K.counts().values())
    assert z.shape == (1, 4, 3 if frames == 5 else 2, 16, 16)
    assert dec.shape == (1, 3, frames if frames == 5 else 3, 32, 32)
    for j_fused in (False, True):
        zj, dj, kl = jax_out(frames, j_fused)
        close(z, zj)
        close(dec, dj)
        np.testing.assert_allclose(float(log["kl_loss"]), kl, rtol=1e-4)


def test_tiny_v1_0_fsq():
    """Port (plain path) against JAX (fused=False) on a padded 5-frame clip."""
    from vidtok_tpu.models.autoencoder import TokenizerCore

    core, _ = j_build(FSQ_CFG)
    x = np.clip(np.random.RandomState(3).randn(1, 3, 5, 32, 32) * 0.5, -1, 1)
    x = x.astype(np.float32)
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    params = random_params(core, xt, seed=1)
    zj, dj, lj = jax.jit(lambda p, v: core.apply(
        {"params": p}, v, sample_override=False))(params, xt)
    tok = load_model_from_config({"model": FSQ_CFG}, device="cpu")
    assert tok.meta["variant"] == "causal" and tok.meta["discrete"]
    load_jax_params(tok.core, params)
    z, dec, log = tok(x)
    idx = log["indices"]
    assert idx.dtype == torch.int32 and idx.shape == (1, 3, 16, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(lj["indices"]))
    np.testing.assert_array_equal(z.numpy(), np.asarray(zj).transpose(0, 4, 1, 2, 3))
    close(dec, np.asarray(dj).transpose(0, 4, 1, 2, 3))
    np.testing.assert_allclose(float(log["aux_loss"]), float(lj["aux_loss"]), rtol=1e-4)
    # indices -> latent -> frames
    want = core.apply({"params": params}, lj["indices"],
                      method=TokenizerCore.decode_indices)
    np.testing.assert_array_equal(tok.indices_to_latent(idx).numpy(),
                                  np.asarray(want).transpose(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(tok.indices_to_latent(idx).numpy(), z.numpy())
    np.testing.assert_array_equal(tok.decode(idx, decode_from_indices=True).numpy(),
                                  dec.numpy())
    # the entropy weight anneals from 3 x 0.1 to 0.1 over 2000 steps
    from vidtok_tpu.modules.regularizers import FSQRegularizer as JFSQ

    zp = np.random.RandomState(4).randn(2, 3, 4, 4, 4).astype(np.float32)
    jreg = JFSQ(levels=(8, 5, 5, 5), **{k: v for k, v in FSQ_PARAMS.items()
                                        if k != "levels"})
    for n_steps in (0, 1000, 3000):
        _, jl = jreg.apply({}, jnp.asarray(zp), n_steps=n_steps)
        _, tl = tok.core.regularization(t(zp), n_steps=n_steps)
        np.testing.assert_allclose(float(tl["aux_loss"]), float(jl["aux_loss"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("extra", [
    {"num_codebooks": 2}, {"dim": 8}, {"diversity_gamma": 0.5},
    {"inv_temperature": 10.0}])
def test_fsq_unported_options_raise(extra):
    """No config sets these options, and the port once refused them; each is
    now held to JAX's regularizer (``test_torch_fsq_options.py``'s
    ``check_fsq_options``: indices, output, aux_loss, decode_indices and
    the gradients)."""
    from tests.test_torch_fsq_options import check_fsq_options

    check_fsq_options(extra)


def test_state_dict_round_trip_v1_0(tiny):
    params = tiny[0]
    tok = load_model_from_config({"model": CFG}, device="cpu")
    load_jax_params(tok.core, params)
    back = convert_torch_state_dict(
        {k: v.numpy() for k, v in tok.core.state_dict().items()})
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert state_dict_from_jax(params).keys() == tok.core.state_dict().keys()


@pytest.mark.parametrize("name,n_params", [
    ("vidtok_kl_causal_488_16chn.yaml", 157_949_351),
    ("vidtok_fsq_causal_488_4096.yaml", 157_396_363)])
def test_full_width_v1_0_shapes(name, n_params):
    """Parameter shapes of the port's full-width v1.0 models (meta device)
    equal the JAX init's, with no forward pass."""
    from vidtok_tpu.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", name))["model"]
    with torch.device("meta"):
        core, meta = build_core_from_config(cfg)
    assert meta["variant"] == "causal"
    assert meta["discrete"] == ("fsq" in name)
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, v.shape) for k, v in core.state_dict().items()}
    port = {k: v.shape for k, v in flat(convert_torch_state_dict(sd)).items()}
    jcore, _ = j_build(cfg)
    shapes = jax.eval_shape(
        lambda: jcore.init({"params": jax.random.PRNGKey(0),
                            "sample": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 4, 16, 16, 3)), sample_override=False))
    ref = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert port == ref
    assert sum(int(np.prod(s)) for s in ref.values()) == n_params
    assert sum(p.numel() for p in core.parameters()) == n_params
