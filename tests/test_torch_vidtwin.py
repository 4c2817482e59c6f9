"""The port's VidTwin (``vidtok_tpu_torch/models/vidtwin``) against
``vidtok_tpu``'s, on the CPU at ``tests/test_vidtwin.py``'s small size
(hidden 64, depth 2, 4 heads, [4, 32, 32] clips, patch 1 x 8 x 8).

The same seeded numpy inputs and the same JAX weights go through both.
Every weight is drawn (``random_params``), so the zero-initialised
``final_layer.linear`` and ``attn_temp.proj`` and the zero biases are
exercised. With f32 attention on both sides (JAX's ``attn_dtype=None``,
the port's ``set_attn_dtype(None)``) the port's standard applies: rtol
1e-4, atol 2e-4. With both sides at their bf16 default the test bounds the
relative L2 between them by twice JAX's own bf16-against-f32 distance
(each side rounds q, k, v and the probabilities to bf16 at its own
places, so each lies about that far from the f32 result).

* building blocks: the sincos embeddings (exactly, on a non-square grid),
  ``Attention`` and ``GroupAttention`` (causal and not), ``PatchEmbed3D``
  on a clip it pads, ``STBlock``, ``T2IFinalLayer`` with ``unpatchify``;
* ``STTEncoder``, ``STTDecoder``, ``QFormerInterface``; ``VidTwinVAE``
  (causal and not): encode, decode with each ``only_part``, the forward;
  the SymVid ``vae=False`` model; causality of the encoder;
* randomness, on its own (the bits cannot match JAX's): ``shuffle_content``
  permutes the frames the Q-Former sees and not the motion path's;
  drop-path;
* the shipped config's full-width parameter tree (311,518,770
  parameters) built on the meta device, and ``chip_smoke.py``'s copy of
  its model section.

The engine, the weights' sources and the CLIs are in
``test_torch_vidtwin_engine.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_vidtwin import small_cfg
from vidtok_tpu.config import load_config as j_load_config
from vidtok_tpu.models.vidtwin import qformer as JQ
from vidtok_tpu.models.vidtwin import st_transformer as JS
from vidtok_tpu.models.vidtwin.vidtwin_ae import VidTwinVAE as JVAE
from vidtok_tpu.models.vidtwin.vidtwin_ae import build_vidtwin_from_config as j_build
from vidtok_tpu_torch.models.vidtwin import st_transformer as S
from vidtok_tpu_torch.models.vidtwin.convert import vidtwin_state_dict_from_jax
from vidtok_tpu_torch.models.vidtwin.qformer import QFormerInterface
from vidtok_tpu_torch.models.vidtwin.vidtwin_ae import build_vidtwin_from_config, reset_params_

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=2e-4)
SHIPPED = os.path.join(ROOT, "configs", "vidtwin", "vidtwin_structure_7_7_8_dynamics_7_8.yaml")


def random_params(shapes, seed):
    """Values for a tree of ``jax.ShapeDtypeStruct`` leaves: kernels
    N(0, 1 / fan_in), norm scales 1 + N(0, 0.1²), every other leaf (biases,
    tables, queries) N(0, 0.05²): no parameter left at zero."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base, std = (1.0, 0.1) if name == "scale" else (0.0, 0.05)
        return (base + std * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init(module, seed, *args, **kw):
    """Random parameters (:func:`random_params`) in ``module``'s tree for
    ``args`` (shapes by ``jax.eval_shape``, nothing run)."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)}, *args, **kw))
    return random_params(shapes["params"], seed)


def to_torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def sub_sd(params, name, prefix):
    """The reference state dict of one top-level part of a VidTwinVAE
    tree, its ``prefix`` stripped."""
    sd = vidtwin_state_dict_from_jax({name: params})
    return to_torch({k[len(prefix):]: v for k, v in sd.items()})


def block_sd(tree, prefix=""):
    """A flax subtree of Dense / Conv / tables -> torch keys: ``kernel``
    [in, out] -> ``weight`` [out, in], a 5-D DHWIO kernel -> OIDHW."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(block_sd(v, f"{prefix}{k}."))
        elif k == "kernel":
            v = np.asarray(v)
            out[prefix + "weight"] = v.T if v.ndim == 2 else v.transpose(4, 3, 0, 1, 2)
        else:
            out[prefix + k] = np.asarray(v)
    return to_torch(out)


def ncthw(a):
    return np.transpose(np.asarray(a), (0, 4, 1, 2, 3))


def t(x):
    return torch.from_numpy(np.array(x))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def clip(seed=0, shape=(2, 4, 32, 32, 3)):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(np.float32)


def f32_jax(cfg):
    model, _ = j_build(cfg)
    return model.clone(encoder=model.encoder.clone(attn_dtype=None),
                       decoder=model.decoder.clone(attn_dtype=None), sample=False)


def port_like(cfg, params, attn_dtype=None):
    """The port's model holding JAX's ``params``, attention in
    ``attn_dtype`` (None: the model's f32), sampling off."""
    model, _ = build_vidtwin_from_config(cfg)
    model.load_state_dict(to_torch(vidtwin_state_dict_from_jax(params)), strict=True)
    model.encoder.set_attn_dtype(attn_dtype)
    model.decoder.set_attn_dtype(attn_dtype)
    model.sample = False
    return model.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["noncausal", "causal"])
def pair(request):
    """(JAX model with f32 attention, its non-zero parameters, the port's
    model holding them, the config)."""
    cfg = small_cfg(request.param)
    jm = f32_jax(cfg)
    params = init(jm, 1, jnp.asarray(clip()))
    return jm, params, port_like(cfg, params), cfg


# -- building blocks --------------------------------------------------------


def test_sincos_embeddings():
    for dim, grid in ((64, (3, 5)), (48, (4, 4))):
        np.testing.assert_array_equal(S.get_2d_sincos_pos_embed(dim, grid),
                                      JS.get_2d_sincos_pos_embed(dim, grid))
        np.testing.assert_array_equal(S.get_1d_sincos_pos_embed(dim, 7),
                                      JS.get_1d_sincos_pos_embed(dim, 7))
    enc = S.STTEncoder(input_size=(4, 24, 40), patch_size=(1, 8, 8), hidden_size=64,
                       depth=1, num_heads=4)
    jenc = JS.STTEncoder(input_size=(4, 24, 40), patch_size=(1, 8, 8), hidden_size=64,
                         depth=1, num_heads=4)
    np.testing.assert_array_equal(enc.pos_embed.numpy(), np.asarray(jenc.spatial_pos_embed()))
    np.testing.assert_array_equal(enc.pos_embed_temporal[0].numpy(),
                                  np.asarray(jenc.temporal_pos_embed()))


@pytest.mark.parametrize("group", [False, True], ids=["attention", "group"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention(group, causal):
    x = np.random.RandomState(2).randn(3, 8, 64).astype(np.float32)
    if group:
        jm = JS.GroupAttention(64, 4, group_size=4, attn_dtype=None)
        tm = S.GroupAttention(64, 4, group_size=4, attn_dtype=None)
    else:
        jm, tm = JS.Attention(64, 4, attn_dtype=None), S.Attention(64, 4, attn_dtype=None)
    params = init(jm, 3, jnp.asarray(x), causal=causal)
    tm.load_state_dict(block_sd(params))
    want = jm.apply({"params": params}, jnp.asarray(x), causal=causal)
    np.testing.assert_allclose(tm(t(x), causal=causal).detach(), want, **TOL)


def test_patch_embed_pads():
    x = np.random.RandomState(4).randn(2, 5, 20, 28, 3).astype(np.float32)
    jm, tm = JS.PatchEmbed3D((2, 8, 8), 32), S.PatchEmbed3D((2, 8, 8), 3, 32)
    params = init(jm, 4, jnp.asarray(x))
    tm.load_state_dict(block_sd(params))
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(t(ncthw(x))).detach()
    assert got.shape == want.shape == (2, 3 * 3 * 4, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_stblock():
    x = np.random.RandomState(5).randn(2, 4, 6, 64).astype(np.float32)
    tpe = np.random.RandomState(6).randn(1, 4, 64).astype(np.float32)
    jm = JS.STBlock(64, 4, d_s=6, d_t=4, attn_dtype=None)
    tm = S.STBlock(64, 4, attn_dtype=None)
    params = init(jm, 5, jnp.asarray(x), jnp.asarray(tpe))
    tm.load_state_dict(block_sd(params))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(tpe))
    np.testing.assert_allclose(tm(t(x), t(tpe)).detach(), want, **TOL)


def test_final_layer_and_unpatchify():
    y = np.random.RandomState(7).randn(2, 2 * 3 * 2, 64).astype(np.float32)
    jm = JS.T2IFinalLayer(2 * 4 * 8, 3)
    tm = S.T2IFinalLayer(64, 2 * 4 * 8, 3)
    params = init(jm, 7, jnp.asarray(y))
    tm.load_state_dict(block_sd(params))
    out = jm.apply({"params": params}, jnp.asarray(y))
    got = tm(t(y))
    np.testing.assert_allclose(got.detach(), out, **TOL)
    kw = dict(input_size=(4, 12, 16), patch_size=(2, 4, 8), hidden_size=64, depth=1,
              num_heads=4)
    want = JS.STTDecoder(**kw).unpatchify(jnp.asarray(got.detach().numpy()))
    np.testing.assert_array_equal(S.STTDecoder(**kw).unpatchify(got.detach()).numpy(),
                                  ncthw(want))


# -- whole modules ------------------------------------------------------------


def test_stt_encoder_decoder(pair):
    jm, params, tm, _ = pair
    x = clip(8)
    z = jm.encoder.apply({"params": params["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(tm.encoder(t(ncthw(x))), ncthw(z), **TOL)
        dec = jm.decoder.apply({"params": params["decoder"]}, z)
        np.testing.assert_allclose(tm.decoder(t(ncthw(z))), ncthw(dec), **TOL)


def test_qformer():
    jm = JQ.QFormerInterface(num_query_tokens=4, query_hidden_size=32,
                             encoder_hidden_size=64)
    tm = QFormerInterface(num_query_tokens=4, query_hidden_size=32, encoder_hidden_size=64)
    x = np.random.RandomState(9).randn(6, 4, 64).astype(np.float32)
    params = init(jm, 9, jnp.asarray(x))
    tm.load_state_dict(sub_sd(params, "qformer", "temporal_qformer."))
    want = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(tm(t(x)).detach(), want, **TOL)


def _encode_decode(jm, params, tm, x, parts=(None, "content", "motion")):
    z, u_s, u_dx, u_dy, log = jm.apply({"params": params}, jnp.asarray(x),
                                       sample_override=False, method=JVAE.encode)
    with torch.no_grad():
        tz, tu_s, tu_dx, tu_dy, tlog = tm.encode(t(ncthw(x)), sample=False)
        for got, want in ((tz, ncthw(z)), (tu_s, u_s), (tu_dx, u_dx), (tu_dy, u_dy)):
            assert got.shape == np.shape(want)
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(float(tlog["kl_loss"]), float(log["kl_loss"]), rtol=1e-4)
        for part in parts:
            dec = jm.apply({"params": params}, u_s, u_dx, u_dy, only_part=part,
                           method=JVAE.decode)
            np.testing.assert_allclose(tm.decode(t(np.asarray(u_s)), t(np.asarray(u_dx)),
                                                 t(np.asarray(u_dy)), only_part=part),
                                       ncthw(dec), **TOL, err_msg=str(part))


def test_vidtwin_encode_decode(pair):
    jm, params, tm, _ = pair
    _encode_decode(jm, params, tm, clip(10))


def test_vidtwin_forward(pair):
    jm, params, tm, _ = pair
    x = clip(11)
    z, dec, log, lat = jm.apply({"params": params}, jnp.asarray(x), sample_override=False)
    with torch.no_grad():
        tz, tdec, tlog, tlat = tm(t(ncthw(x)), sample=False)
    np.testing.assert_allclose(tz, ncthw(z), **TOL)
    np.testing.assert_allclose(tdec, ncthw(dec), **TOL)
    np.testing.assert_allclose(float(tlog["kl_loss"]), float(log["kl_loss"]), rtol=1e-4)
    assert tuple(tdec.shape) == (2, 3, 4, 32, 32)


def test_symvid_vae_false():
    """``VidAutoEncoderQformerCompactSymVid``: heads of ``expect_ch`` /
    ``d_dim`` channels, nothing sampled, kl_loss 0."""
    cfg = dict(small_cfg(True), target="VidAutoEncoderQformerCompactSymVid")
    jm = f32_jax(cfg)
    assert not jm.vae
    params = init(jm, 12, jnp.asarray(clip()))
    tm = port_like(cfg, params)
    assert not tm.vae and tm.bottle_down.out_channels == 8
    _encode_decode(jm, params, tm, clip(12), parts=(None,))


def test_ablations_raise():
    """The ablation ladder builds (``ablations.py``; held to JAX in
    ``test_torch_vidtwin_ablations*.py``), and the engine serves it
    through ``forward`` only: ``encode``, ``decode`` and ``cross_reenact``
    are ``VidTwinVAE``'s and raise on an ablation, as JAX's engine cannot
    run them (it calls ``VidTwinVAE.encode`` by name)."""
    from vidtok_tpu_torch.models.vidtwin import ablations as A
    from vidtok_tpu_torch.models.vidtwin.engine import VidTwinTokenizer

    q = {"target": "q", "params": {"num_query_tokens": 2, "query_hidden_size": 32,
                                   "encoder_hidden_size": 64}}
    classes = {"VidAutoEncoderQformer": A.VidTwinQformer,
               "VidAutoEncoderQformerCompact": A.VidTwinCompact,
               "VidAutoEncoderQformerCompactSym": A.VidTwinSym,
               "VidAutoEncoderQformerCompactSymDis": A.VidTwinSym}
    x = t(ncthw(clip(16)))
    for target, cls in classes.items():
        cfg = dict(small_cfg(), target=f"vidtwin.models.vidtwin_ae.{target}")
        cfg["params"] = dict(cfg["params"], height_qformer_config=q, width_qformer_config=q,
                             space_qformer_config=q)
        model, meta = build_vidtwin_from_config(cfg)
        assert type(model) is cls and meta["kind"] == "vidtwin"
        assert getattr(model, "dis", False) == target.endswith("Dis")
        reset_params_(model, torch.Generator().manual_seed(0))
        tok = VidTwinTokenizer(model, meta)
        z, dec, log = tok(x)
        assert dec.shape == x.shape and float(log["kl_loss"]) == 0.0
        for call in (lambda: tok.encode(x), lambda: tok.cross_reenact(x, x),
                     lambda: tok.decode(x, x, x)):
            with pytest.raises(TypeError, match="serves forward only"):
                call()


def test_bf16_attention_default():
    """Both packages at their default (bf16 q, k, v and probabilities, f32
    softmax, f32 elsewhere): within twice JAX's own bf16-vs-f32 distance."""
    cfg = small_cfg(True)
    jm16, _ = j_build(cfg)
    jm16 = jm16.clone(sample=False)
    jm32 = f32_jax(cfg)
    x = clip(13)
    params = init(jm32, 13, jnp.asarray(x))
    tm = port_like(cfg, params, attn_dtype=torch.bfloat16)
    _, d16, _, _ = jm16.apply({"params": params}, jnp.asarray(x), sample_override=False)
    _, d32, _, _ = jm32.apply({"params": params}, jnp.asarray(x), sample_override=False)
    with torch.no_grad():
        got = tm(t(ncthw(x)), sample=False)[1]
    jax_spread = rel_l2(d16, d32)
    assert 0 < jax_spread < 5e-2
    assert rel_l2(got, ncthw(d16)) <= 2 * jax_spread, (rel_l2(got, ncthw(d16)), jax_spread)


def test_causality():
    """With ``temporal_casual`` the encoder's tokens of frames before a
    perturbation do not change (``tests/test_vidtwin.py:118-135``); every
    weight non-zero, ``attn_temp.proj`` included."""
    cfg = small_cfg(True)
    tm = port_like(cfg, init(f32_jax(cfg), 14, jnp.asarray(clip())))
    x = ncthw(clip(14, (1, 4, 32, 32, 3)))
    x2 = x.copy()
    x2[:, :, 2:] = 0.0
    with torch.no_grad():
        z1, z2 = tm.encoder(t(x)), tm.encoder(t(x2))
    np.testing.assert_allclose(z1[:, :, :2], z2[:, :, :2], atol=1e-5)
    assert not torch.allclose(z1[:, :, 2:], z2[:, :, 2:])


# -- randomness -------------------------------------------------------------


def test_shuffle_content(pair):
    """The Q-Former sees each sample's frames in the permutation drawn
    from the generator; the motion latents are the unshuffled model's."""
    _, _, tm, _ = pair
    seen = []
    hook = tm.temporal_qformer.register_forward_hook(lambda m, a, o: seen.append(a[0]))
    x = t(ncthw(clip(15)))
    try:
        with torch.no_grad():
            plain = tm.encode(x, sample=False)
            tm.shuffle_content = True
            g = torch.Generator().manual_seed(3)
            perms = torch.rand((2, 4), generator=torch.Generator().manual_seed(3)).argsort(1)
            shuffled = tm.encode(x, sample=False, generator=g)
    finally:
        tm.shuffle_content = False
        hook.remove()
    a, b = (s.reshape(2, 16, 4, 64) for s in seen)  # [B, H'W', F, C]
    assert sorted(perms[0].tolist()) == [0, 1, 2, 3] and not torch.equal(perms[0], perms[1])
    for i in range(2):
        torch.testing.assert_close(b[i], a[i][:, perms[i]], rtol=0, atol=0)
    torch.testing.assert_close(shuffled[2], plain[2], rtol=0, atol=0)
    torch.testing.assert_close(shuffled[3], plain[3], rtol=0, atol=0)
    assert not torch.allclose(shuffled[1], plain[1])


def test_drop_path():
    x = torch.randn(4096, 3, 5)
    assert S.drop_path(x, 0.3, True) is x and S.drop_path(x, 0.0, False) is x
    y = S.drop_path(x, 0.25, False, torch.Generator().manual_seed(0))
    kept = (y != 0).flatten(1).all(1)
    assert torch.equal(kept, (y != 0).flatten(1).any(1))  # whole samples
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    blk = S.STBlock(64, 4, drop_path_rate=0.5, attn_dtype=None)
    reset_params_(blk, torch.Generator().manual_seed(0))
    ref = S.STBlock(64, 4, attn_dtype=None)
    ref.load_state_dict(blk.state_dict())
    xb = torch.randn(2, 4, 6, 64)
    with torch.no_grad():
        torch.testing.assert_close(blk(xb), ref(xb), rtol=0, atol=0)
        assert not torch.equal(blk(xb, deterministic=False,
                                   generator=torch.Generator().manual_seed(1)), ref(xb))


def test_full_width_parameters():
    """The shipped config built on the meta device: every parameter's
    shape is the converted ``jax.eval_shape`` tree's; 311,518,770 in all."""
    cfg = j_load_config(SHIPPED)
    jm, _ = j_build(cfg["model"])
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((1, 16, 224, 224, 3)), sample_override=False))["params"]
    want = vidtwin_state_dict_from_jax(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    with torch.device("meta"):
        model, _ = build_vidtwin_from_config(cfg["model"])
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert sum(p.numel() for p in model.parameters()) == 311_518_770
    assert [sum(p.numel() for p in m.parameters()) for m in
            (model.encoder, model.decoder, model.temporal_qformer)] == [
        151_819_008, 151_820_544, 1_017_984]


def test_chip_smoke_config():
    """``chip_smoke.py`` drives the shipped model section (its copy is
    resolved, so the card needs no YAML parser)."""
    import chip_smoke

    assert chip_smoke.VIDTWIN_CFG["model"] == j_load_config(SHIPPED)["model"]
