"""Kernels A-D of the PyTorch port against the JAX package's Pallas kernels.

Each Pallas kernel runs in interpret mode on the CPU, as the JAX package's
own tests run it. The port's side is the plain PyTorch version beside each
CUDA kernel, and the port module that calls the kernel wrapper with
``fused=True`` (on a CPU tensor the wrapper runs the plain version and
launches nothing). Parameters are random, with non-zero norm biases and
temporal conv2, so the zero-after-activation padding is exercised. fp32;
tolerance rtol 1e-4, atol 2e-4 (the repo's golden bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu.modules.blocks as JB
from vidtok_tpu.ops.pallas.decoder_tail import decoder_tail_rgb as j_tail
from vidtok_tpu.ops.pallas.fused_spatial_v2 import fused_spatial_resblock_v2
from vidtok_tpu.ops.pallas.fused_temporal import fused_temporal_resblock as j_temporal
from vidtok_tpu.ops.pallas.subpixel_epilogue import subpixel_interleave as j_subpixel
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels.decoder_tail import decoder_tail_rgb_plain
from vidtok_tpu_torch.ops.kernels.fused_spatial import fused_spatial_resblock_plain
from vidtok_tpu_torch.ops.kernels.fused_temporal import fused_temporal_resblock_plain
from vidtok_tpu_torch.ops.kernels.subpixel import subpixel_interleave_plain

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


def load_port(module, params, path, prefix):
    """Load a JAX module's params into the port module through
    ``state_dict_from_jax``, placing the module at ``path`` in the tree."""
    tree = params
    for name in reversed(path):
        tree = {name: tree}
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(tree).items()}
    module.load_state_dict(sd, strict=True)
    return module


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w,cin,cout", [(32, 8, 32, 32), (32, 8, 16, 32),
                                          (32, 24, 32, 16)])
def test_kernel_a_fused_spatial(h, w, cin, cout):
    """H=32 gives the Pallas kernel two row tiles; Cin != C adds the
    nin_shortcut."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, h, w, cin).astype(np.float32)
    jm = JB.ResnetBlockSpatial(cout, norm_type="layernorm")
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = fused_spatial_resblock_v2(jnp.asarray(x.reshape(2, h, w, cin)), p,
                                     interpret=True)
    want_xla = jm.apply({"params": p}, jnp.asarray(x))

    tm = load_port(TB.ResnetBlockSpatial(cin, cout), p,
                   ("encoder", "down_0_block_0"), "encoder.down.0.block.0.")
    nin = ((tm.nin_shortcut.weight, tm.nin_shortcut.bias)
           if cin != cout else None)
    args = ((tm.norm1.norm.weight, tm.norm1.norm.bias),
            (tm.conv1.weight, tm.conv1.bias),
            (tm.norm2.norm.weight, tm.norm2.norm.bias),
            (tm.conv2.weight, tm.conv2.bias), nin)
    with torch.no_grad():
        close(fused_spatial_resblock_plain(t(x.reshape(2, h, w, cin)), *args), want)
        K.reset_counts()
        got = tm(t(x), fused=True)
    assert K.counts("calls")["fused_spatial_resblock"] == 1
    assert K.counts()["fused_spatial_resblock"] == 0  # CPU: nothing launched
    close(got.reshape(2, h, w, cout), want)
    close(got, want_xla)


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_kernel_b_fused_temporal(mode):
    rng = np.random.RandomState(1)
    x = rng.randn(1, 5, 8, 8, 32).astype(np.float32)
    jm = JB.ResnetBlockTemporal(32, causal=True, norm_type="layernorm",
                                first_pad_mode=mode)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    assert np.abs(p["conv2"]["kernel"]).max() > 0
    want = j_temporal(jnp.asarray(x), p, mode, interpret=True)

    tm = load_port(TB.ResnetBlockTemporal(32, 32, first_pad_mode=mode), p,
                   ("encoder", "down_temporal_0_block_0"),
                   "encoder.down_temporal.0.block.0.")
    args = ((tm.norm1.norm.weight, tm.norm1.norm.bias),
            (tm.conv1.conv.weight, tm.conv1.conv.bias),
            (tm.norm2.norm.weight, tm.norm2.norm.bias),
            (tm.conv2.conv.weight, tm.conv2.conv.bias))
    with torch.no_grad():
        close(fused_temporal_resblock_plain(t(x), *args, mode), want)
        K.reset_counts()
        close(tm(t(x), fused=True), want)
    assert K.counts("calls")["fused_temporal_resblock"] == 1
    assert K.counts()["fused_temporal_resblock"] == 0


def test_kernel_c_subpixel_interleave():
    rng = np.random.RandomState(2)
    ys = [rng.randn(3, 4, 6, 16).astype(np.float32) for _ in range(4)]
    bias = rng.randn(16).astype(np.float32)
    want = j_subpixel(*map(jnp.asarray, ys), jnp.asarray(bias), interpret=True)
    close(subpixel_interleave_plain(*map(t, ys), t(bias)), want)

    # the module: nearest 2x + 3x3 conv as four parity convs + the tail
    x = rng.randn(1, 3, 12, 20, 16).astype(np.float32)
    jm = JB.SpatialUpsample()
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = jm.apply({"params": p}, jnp.asarray(x), fused=True)
    tm = load_port(TB.SpatialUpsample(16), p, ("decoder", "up_1_upsample"),
                   "decoder.up.1.upsample.")
    K.reset_counts()
    with torch.no_grad():
        close(tm(t(x), fused=True), want)
    assert K.counts("calls")["subpixel_interleave"] == 1
    assert K.counts()["subpixel_interleave"] == 0


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_kernel_d_decoder_tail(mode):
    rng = np.random.RandomState(3)
    c = 32
    x = (rng.randn(1, 5, 16, 24, c) * 0.5).astype(np.float32)
    norm = {"scale": 1 + 0.2 * rng.randn(c).astype(np.float32),
            "bias": 0.2 * rng.randn(c).astype(np.float32)}
    conv = {"kernel": 0.05 * rng.randn(3, 3, 3, c, 3).astype(np.float32),
            "bias": 0.1 * rng.randn(3).astype(np.float32)}
    want = j_tail(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, norm),
                  jax.tree_util.tree_map(jnp.asarray, conv), mode,
                  interpret=True)
    sd = state_dict_from_jax({"decoder": {"norm_out": norm, "conv_out": conv}})
    tnorm = (t(sd["decoder.norm_out.norm.weight"]), t(sd["decoder.norm_out.norm.bias"]))
    tconv = (t(sd["decoder.conv_out.conv.weight"]), t(sd["decoder.conv_out.conv.bias"]))
    close(decoder_tail_rgb_plain(t(x), tnorm, tconv, mode), want)
    K.reset_counts()
    close(K.decoder_tail_rgb(t(x), tnorm, tconv, mode), want)
    assert K.counts("calls")["decoder_tail_rgb"] == 1
    assert K.counts()["decoder_tail_rgb"] == 0
