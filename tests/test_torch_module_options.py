"""Module options of ``vidtok_tpu`` that no shipped config sets, in the
port against JAX (fp32, CPU, rtol 1e-4, atol 2e-4; seeded numpy inputs,
JAX's weights carried across by the converters).

* ``SpatialDownsample(with_conv=False)``: a 2x2 average pool, no parameter.
* ``SpatialUpsample(with_conv=False)``: the nearest 2x upsample alone, no
  parameter, no kernel call under ``fused`` in any subpixel form;
  ``SpatialUpsample(subpixel=False)``: the naive upsample-then-conv path,
  plain under ``fused``, equal to the subpixel form.
* ``ActNorm(logdet=True)``: its data-dependent init, output and
  log-determinant on 4-D and 5-D input.
* VidTwin's ST transformer: ``STTEncoder`` / ``STTDecoder`` at depth 2,
  hidden 64 under ``no_temporal`` (no ``attn_temp`` in either tree, the
  converter maps it) and under ``space_scale`` / ``time_scale`` != 1 (the
  sincos embeddings exactly); ``build_vidtwin_from_config`` reads none of
  the keys, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu.modules.blocks as JB
from tests.test_torch_modules import check, rand
from tests.test_torch_vidtwin import init, ncthw, small_cfg, sub_sd, t
from vidtok_tpu.models.vidtwin import st_transformer as JS
from vidtok_tpu.models.vidtwin.vidtwin_ae import build_vidtwin_from_config as j_build_twin
from vidtok_tpu.modules.discriminator import ActNorm as JActNorm
from vidtok_tpu_torch.models.vidtwin import st_transformer as S
from vidtok_tpu_torch.models.vidtwin.vidtwin_ae import build_vidtwin_from_config
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.modules.discriminator import ActNorm
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels import KernelForms

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)
FORMS = [KernelForms(), KernelForms(subpixel="merged")]


def _no_params(jmod, tmod, x):
    """Neither module holds a parameter; the outputs agree."""
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert not v.get("params") and not list(tmod.parameters()) and not tmod.state_dict()
    return np.asarray(jmod.apply(v, jnp.asarray(x)))


def test_spatial_downsample_pool():
    x = rand(1, 2, 8, 10, 8)
    want = _no_params(JB.SpatialDownsample(with_conv=False),
                      TB.SpatialDownsample(8, with_conv=False), x)
    got = TB.SpatialDownsample(8, with_conv=False)(torch.from_numpy(x))
    assert got.shape == (1, 2, 4, 5, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("forms", FORMS, ids=["split", "merged"])
@pytest.mark.parametrize("fused", [False, True])
def test_spatial_upsample_without_conv(fused, forms):
    x = rand(1, 2, 5, 6, 8)
    tm = TB.SpatialUpsample(8, with_conv=False)
    want = _no_params(JB.SpatialUpsample(with_conv=False), tm, x)
    K.reset_counts()
    got = tm(torch.from_numpy(x), fused=fused, forms=forms)
    assert all(n == 0 for n in K.counts("calls").values())
    assert got.shape == (1, 2, 10, 12, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spatial_upsample_naive():
    x = rand(1, 2, 5, 6, 8)
    naive = TB.SpatialUpsample(8, subpixel=False)
    check(JB.SpatialUpsample(subpixel=False), naive, x,
          ("decoder", "up_1_upsample"), "decoder.up.1.upsample.")
    sub = TB.SpatialUpsample(8)
    sub.load_state_dict(naive.state_dict())
    with torch.no_grad():
        want = sub(torch.from_numpy(x))
        for fused, forms in ((False, FORMS[0]), (True, FORMS[0]), (True, FORMS[1])):
            K.reset_counts()
            got = naive(torch.from_numpy(x), fused=fused, forms=forms)
            assert all(n == 0 for n in K.counts("calls").values())
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("shape", [(4, 6, 5, 8), (2, 3, 4, 5, 6)], ids=["2d", "3d"])
def test_actnorm_logdet(shape):
    """JAX initialises from the batch it is given at ``init`` (channels
    last); the port from its first training batch (channels first). A
    second batch then runs through the same parameters."""
    x, x2 = rand(*shape, seed=2) * 3 + 1, rand(*shape, seed=3)
    jm = JActNorm(logdet=True)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = ActNorm(shape[-1], len(shape), logdet=True).train()
    first = (0, len(shape) - 1) + tuple(range(1, len(shape) - 1))
    back = (0,) + tuple(range(2, len(shape))) + (1,)
    for batch in (x, x2):
        h_j, ld_j = jm.apply(v, jnp.asarray(batch))
        with torch.no_grad():
            h, ld = tm(torch.from_numpy(batch.transpose(first)))
        np.testing.assert_allclose(h.numpy().transpose(back), np.asarray(h_j), **TOL)
        assert ld.shape == (shape[0],)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-5)
    assert ActNorm(shape[-1], len(shape))(torch.from_numpy(x.transpose(first))).shape \
        == x.transpose(first).shape


def test_sincos_scale():
    for dim, grid, scale in ((64, (3, 5), 2.0), (48, (4, 4), 0.5), (64, (2, 7), 3.0)):
        np.testing.assert_array_equal(S.get_2d_sincos_pos_embed(dim, grid, scale),
                                      JS.get_2d_sincos_pos_embed(dim, grid, scale=scale))
        np.testing.assert_array_equal(S.get_1d_sincos_pos_embed(dim, 7, scale),
                                      JS.get_1d_sincos_pos_embed(dim, 7, scale=scale))


_STT = dict(input_size=(4, 32, 32), patch_size=(1, 8, 8), hidden_size=64, depth=2,
            num_heads=4, attn_dtype=None)


@pytest.mark.parametrize("opts", [
    dict(no_temporal=True), dict(space_scale=2.0, time_scale=0.5),
    dict(no_temporal=True, space_scale=0.5, time_scale=3.0)],
    ids=["no_temporal", "scales", "both"])
def test_st_transformer_options(opts):
    x = (np.random.RandomState(8).randn(2, 4, 32, 32, 3) * 0.5).astype(np.float32)
    jenc, jdec = JS.STTEncoder(**_STT, **opts), JS.STTDecoder(**_STT, **opts)
    enc, dec = S.STTEncoder(**_STT, **opts), S.STTDecoder(**_STT, **opts)
    for jm, tm in ((jenc, enc), (jdec, dec)):
        np.testing.assert_array_equal(tm.spatial_pos_embed().numpy(),
                                      np.asarray(jm.spatial_pos_embed()))
        np.testing.assert_array_equal(tm.temporal_pos_embed().numpy(),
                                      np.asarray(jm.temporal_pos_embed()))
    ep = init(jenc, 8, jnp.asarray(x))
    z = jenc.apply({"params": ep}, jnp.asarray(x))
    dp = init(jdec, 9, z)
    for params, name, tm in ((ep, "encoder", enc), (dp, "decoder", dec)):
        temporal = any("attn_temp" in blk for key, blk in params.items()
                       if key.startswith("blocks_"))
        assert temporal == (not opts.get("no_temporal", False))
        sd = sub_sd(params, name, f"{name}.")
        assert any("attn_temp" in k for k in sd) == temporal
        tm.load_state_dict(sd, strict=True)
    rec = jdec.apply({"params": dp}, z)
    with torch.no_grad():
        np.testing.assert_allclose(enc(t(ncthw(x))), ncthw(z), **TOL)
        np.testing.assert_allclose(dec(t(ncthw(z))), ncthw(rec), **TOL)


def test_config_ignores_the_options():
    """A config's ``no_temporal`` / ``space_scale`` / ``time_scale`` reach
    neither package's model (JAX's ``build_vidtwin_from_config`` reads
    none of them)."""
    cfg = small_cfg(True)
    for part in ("encoder_config", "decoder_config"):
        cfg["params"][part]["params"].update(no_temporal=True, space_scale=2.0,
                                             time_scale=2.0)
    jm, _ = j_build_twin(cfg)
    tm, _ = build_vidtwin_from_config(cfg)
    for jpart, tpart in ((jm.encoder, tm.encoder), (jm.decoder, tm.decoder)):
        assert (jpart.no_temporal, jpart.space_scale, jpart.time_scale) == (False, 1.0, 1.0)
        assert (tpart.no_temporal, tpart.space_scale, tpart.time_scale) == (False, 1.0, 1.0)
        assert all(hasattr(b, "attn_temp") for b in tpart.blocks)
