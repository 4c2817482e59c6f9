"""The PyTorch port's slice modules against ``vidtok_tpu`` (``fused=False``).

Same random parameters (numpy seed, carried across by
``state_dict_from_jax``) and same inputs through the JAX module and its
port; fp32, rtol 1e-4, atol 2e-4 (the repo's golden bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu.modules.blocks as JB
import vidtok_tpu.modules.conv as JC
from vidtok_tpu.modules.interp import (temporal_avg_pool3_stride2,
                                       temporal_linear_up2x)
from vidtok_tpu.modules.norms import ChannelLayerNorm as JNorm
from vidtok_tpu.modules.regularizers import DiagonalGaussianRegularizer as JReg
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.modules import conv as TC
from vidtok_tpu_torch.modules import interp as TI
from vidtok_tpu_torch.modules.norms import ChannelLayerNorm
from vidtok_tpu_torch.modules.regularizers import DiagonalGaussianRegularizer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)


def randomize(tree, rng):
    """Random leaves: norm scales 1 +- 0.2, everything else N(0, 0.1)."""
    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.1 * r

    return jax.tree_util.tree_map_with_path(leaf, tree)


def check(jmod, tmod, x, path, prefix, seed=0, jkw=None, tkw=None):
    """Init ``jmod`` on x, randomize, load into ``tmod`` via the converter
    with the module placed at ``path``; compare outputs."""
    rng = np.random.RandomState(seed)
    p = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tree = p
    for name in reversed(path):
        tree = {name: tree}
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(tree).items()}
    tmod.load_state_dict(sd, strict=True)
    want = jmod.apply({"params": p}, jnp.asarray(x), **(jkw or {}))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), **(tkw or {}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_channel_layer_norm():
    check(JNorm(), ChannelLayerNorm(16), rand(2, 3, 4, 5, 16),
          ("encoder", "norm_out"), "encoder.norm_out.")


@pytest.mark.parametrize("mode", ["zero", "replicate"])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_causal_conv3d(mode, k, stride):
    check(JC.CausalConv3d(12, (k, k, k), stride=(stride, 1, 1),
                          first_pad_mode=mode),
          TC.CausalConv3d(8, 12, k, (stride, 1, 1), first_pad_mode=mode),
          rand(1, 5, 6, 7, 8), ("encoder", "conv_in"), "encoder.conv_in.")


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_causal_conv1d(mode):
    check(JC.CausalConv1d(12, 3, first_pad_mode=mode),
          TC.CausalConv1d(8, 12, 3, first_pad_mode=mode),
          rand(1, 5, 4, 3, 8), ("encoder", "down_temporal_0_block_0", "conv1"),
          "encoder.down_temporal.0.block.0.conv1.")


@pytest.mark.parametrize("k,stride,padding", [(3, 1, None), (3, 2, (0, 1, 0, 1)),
                                              (1, 1, None)])
def test_spatial_conv(k, stride, padding):
    check(JC.SpatialConv(12, k, stride=stride, padding=padding),
          TC.SpatialConv(8, 12, k, stride=stride, padding=padding),
          rand(2, 2, 8, 9, 8), ("encoder", "down_0_block_0", "conv1"),
          "encoder.down.0.block.0.conv1.")


def test_conv3d_symmetric():
    rng = np.random.RandomState(0)
    x = rand(1, 4, 6, 5, 8)
    jm = JC.Conv3d(12, (3, 3, 3))
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = TC.Conv3d(8, 12, (3, 3, 3))
    tm.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(
            p["kernel"].transpose(4, 3, 0, 1, 2))),
        "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": p}, x)),
                               **TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_interp(t):
    x = rand(2, t, 3, 4, 5)
    np.testing.assert_allclose(TI.temporal_linear_up2x(torch.from_numpy(x)).numpy(),
                               np.asarray(temporal_linear_up2x(jnp.asarray(x))), **TOL)
    x = rand(2, 2 * t + 1, 3, 4, 5)
    np.testing.assert_allclose(
        TI.temporal_avg_pool3_stride2(torch.from_numpy(x)).numpy(),
        np.asarray(temporal_avg_pool3_stride2(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("cin,cout", [(16, 16), (8, 16)])
def test_resnet_block_spatial_plain(cin, cout):
    check(JB.ResnetBlockSpatial(cout, norm_type="layernorm"),
          TB.ResnetBlockSpatial(cin, cout), rand(1, 2, 6, 5, cin),
          ("encoder", "down_0_block_0"), "encoder.down.0.block.0.")


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_resnet_block_temporal_plain(mode):
    check(JB.ResnetBlockTemporal(16, norm_type="layernorm", first_pad_mode=mode),
          TB.ResnetBlockTemporal(16, 16, first_pad_mode=mode),
          rand(1, 5, 4, 3, 16), ("decoder", "up_temporal_1_block_0"),
          "decoder.up_temporal.1.block.0.")


def test_resnet_block_3d():
    check(JB.ResnetBlock3D(16, norm_type="layernorm", first_pad_mode="replicate"),
          TB.ResnetBlock3D(16, 16, first_pad_mode="replicate"),
          rand(1, 4, 5, 6, 16), ("encoder", "mid_block_1"), "encoder.mid.block_1.")


def test_attn_block():
    check(JB.AttnBlock(norm_type="layernorm"), TB.AttnBlock(16),
          rand(2, 3, 4, 5, 16), ("decoder", "mid_attn_1"), "decoder.mid.attn_1.")


def test_spatial_downsample():
    check(JB.SpatialDownsample(), TB.SpatialDownsample(8), rand(1, 2, 8, 10, 8),
          ("encoder", "down_0_downsample"), "encoder.down.0.downsample.")


def test_spatial_upsample_plain():
    check(JB.SpatialUpsample(), TB.SpatialUpsample(8), rand(1, 2, 5, 6, 8),
          ("decoder", "up_1_upsample"), "decoder.up.1.upsample.")


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_time_downsample(mode):
    check(JB.TimeDownsampleRes2x(8, first_pad_mode=mode),
          TB.TimeDownsampleRes2x(8, 8, first_pad_mode=mode), rand(1, 8, 3, 4, 8),
          ("encoder", "down_temporal_1_downsample"),
          "encoder.down_temporal.1.downsample.")


@pytest.mark.parametrize("ntu,t", [(1, 3), (2, 5), (2, 2)])
def test_time_upsample_trilinear(ntu, t):
    """Plain, and with ``fused`` through kernels J and K's plain forms."""
    for fused in (False, True):
        check(JB.TimeUpsampleRes2x(8, interpolation_mode="trilinear",
                                   num_temp_upsample=ntu, first_pad_mode="replicate"),
              TB.TimeUpsampleRes2x(8, 8, ntu, "replicate"), rand(1, t, 3, 4, 8),
              ("decoder", "up_temporal_2_upsample"), "decoder.up_temporal.2.upsample.",
              tkw={"fused": fused})


def test_diagonal_gaussian_regularizer_mode_and_kl():
    z = rand(2, 3, 4, 5, 8) * 3.0
    out_j, log_j = JReg(sample=False).apply({}, jnp.asarray(z))
    out_t, log_t = DiagonalGaussianRegularizer(sample=False)(torch.from_numpy(z))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(log_t["kl_loss"]), float(log_j["kl_loss"]),
                               rtol=1e-5)
    # sampling: mean + std * eps with the logvar clip, from a torch generator
    g = torch.Generator().manual_seed(0)
    s = DiagonalGaussianRegularizer()(torch.from_numpy(z), generator=g)[0]
    eps = torch.randn(s.shape, generator=torch.Generator().manual_seed(0))
    std = np.exp(0.5 * np.clip(z[..., 4:], -30, 20))
    np.testing.assert_allclose(s.numpy(), z[..., :4] + std * eps.numpy(), **TOL)
