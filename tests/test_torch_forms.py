"""The decoder's alternative kernel forms in the PyTorch port against
``vidtok_tpu``.

* Kernels G, H, I and D': the plain version beside each CUDA kernel against
  the JAX package's Pallas function in interpret mode
  (``parity_blend_interleave``, ``parity_blend_interleave4``,
  ``subpixel_interleave_z``, ``decoder_tail_rgb(..., tap_pack=False)``);
  tolerance 1e-5.
* ``TimeUpsampleRes2x`` in the ``merged`` and ``split`` parity forms
  against JAX's ``_parity_up2x_conv_blend`` with kernel E made to decline
  and ``_PARITY_MERGED`` on or off; ``SpatialUpsample`` in the ``merged``
  subpixel form against JAX with ``_SUBPIXEL_MERGED`` on.
* The tiny v1.0 model of ``tests/test_torch_v1_0.py`` with ``fused`` and
  each non-default form, against JAX's fused forward under the same
  switches, and the tiny v1.1 model's tiled decode in the ``merged``
  subpixel and ``taps`` tail forms against the default forms.
* ``KernelForms`` refuses unknown values; off the CPU each new wrapper
  launches its kernel or raises.

Inputs and parameters come from numpy seeds, with random norm scales and
biases (``ln_silu(0) != 0``); fp32. Module and model tolerances are the
repo's golden bound, rtol 1e-4 and atol 2e-4. On CPU tensors the kernel
wrappers run their plain versions and launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu.modules.blocks as JB
import vidtok_tpu.ops.pallas.decoder_tail as JT
import vidtok_tpu.ops.pallas.upsample_epilogue as JU
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.ops.pallas.subpixel_epilogue import subpixel_interleave_z as j_sub_z
from vidtok_tpu_torch import KernelForms, load_model_from_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.models.autoencoder import VideoTokenizer
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels.decoder_tail import decoder_tail_rgb_taps_plain
from vidtok_tpu_torch.ops.kernels.subpixel import subpixel_interleave_z_plain
from vidtok_tpu_torch.ops.kernels.upsample_epilogue import (
    parity_blend_interleave4_plain, parity_blend_interleave_plain)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ["zero", "replicate"]

_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2], "time_downsample_factor": 2,
      "num_res_blocks": 1, "norm_type": "layernorm",
      "init_pad_mode": "replicate", "tempo_ds": [0], "tempo_us": [1]}


def _cfg(enc, dec, params):
    return {"params": {
        "encoder_config": {"target": enc, "params": dict(params)},
        "decoder_config": {"target": dec, "params": dict(params)},
        "regularizer_config": {"target": "DiagonalGaussianRegularizer"}}}


CFG = _cfg("EncoderCausal3D", "DecoderCausal3D", _P)
CFG_V1_1 = _cfg("EncoderCausal3DV1_1", "DecoderCausal3DV1_1",
                dict(_P, interpolation_mode="trilinear"))
# the four new wrappers and the default-form ones they stand in for
NEW = ("parity_blend_interleave", "parity_blend_interleave4",
       "subpixel_interleave_z", "decoder_tail_rgb_taps")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def randomize(tree, rng):
    """Random leaves: norm scales 1 +- 0.2, everything else N(0, 0.1)."""
    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.1 * r

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load_port(module, params, path, prefix):
    """Load a JAX parameter tree into ``module`` through
    ``state_dict_from_jax``, the tree placed at ``path`` of the model."""
    tree = params
    for name in reversed(path):
        tree = {name: tree}
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(tree).items()}
    module.load_state_dict(sd, strict=True)
    return module


def jax_forms(monkeypatch, forms: KernelForms):
    """Set the JAX package's switches to ``forms`` for this test: kernel E
    declines for the merged and split parity forms (``blocks.py:628``
    imports it at call time), ``_PARITY_MERGED``, ``_SUBPIXEL_MERGED`` and
    the tail's ``_TAP_PACK``. Returns {JAX Pallas function: calls}, counted
    for G, H, I and D'."""
    calls = dict.fromkeys(NEW, 0)

    def counted(mod, fn_name, key, when=lambda *a, **k: True):
        fn = getattr(mod, fn_name)

        def wrapper(*a, **k):
            if when(*a, **k):
                calls[key] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, fn_name, wrapper)

    if forms.parity != "fused":
        monkeypatch.setattr(
            "vidtok_tpu.ops.pallas.parity_upsample_fused.parity_up2x_fused",
            lambda *a, **k: None)
    monkeypatch.setattr(JB, "_PARITY_MERGED", forms.parity != "split")
    monkeypatch.setattr(JB, "_SUBPIXEL_MERGED", forms.subpixel == "merged")
    monkeypatch.setattr(JT, "_TAP_PACK", "0" if forms.tail == "taps" else "1")
    counted(JU, "parity_blend_interleave", "parity_blend_interleave")
    counted(JU, "parity_blend_interleave4", "parity_blend_interleave4")
    import vidtok_tpu.ops.pallas.subpixel_epilogue as JS
    counted(JS, "subpixel_interleave_z", "subpixel_interleave_z")
    counted(JT, "decoder_tail_rgb", "decoder_tail_rgb_taps",
            when=lambda *a, **k: JT._TAP_PACK == "0")
    return calls


# -- kernels G, H, I and D' -------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_kernels_g_h_plain(mode):
    """G from two phase-packed conv outputs, H from one [cur | prev]
    tensor: the front at t = 0 is zeros, or y_prev[0] in replicate mode."""
    rng = np.random.RandomState(0)
    b, tt, h, w, c = 1, 3, 4, 8, 16
    s = rng.randn(b, tt, h, w, c).astype(np.float32)
    y4 = rng.randn(b, tt, h, w, 4 * c).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    alpha = torch.tensor([0.7])
    yc, yp = y4[..., :2 * c], y4[..., 2 * c:]
    want = JU.parity_blend_interleave(jnp.asarray(s), jnp.asarray(yc),
                                      jnp.asarray(yp), jnp.asarray(bias), 0.7,
                                      mode, interpret=True)
    want4 = JU.parity_blend_interleave4(jnp.asarray(s), jnp.asarray(y4),
                                        jnp.asarray(bias), 0.7, mode,
                                        interpret=True)
    assert want.shape == want4.shape == (b, 2 * tt, h, w, c)
    close(parity_blend_interleave_plain(t(s), t(yc), t(yp), t(bias), alpha, mode),
          want, **KERNEL_TOL)
    close(parity_blend_interleave4_plain(t(s), t(y4), t(bias), alpha, mode),
          want4, **KERNEL_TOL)
    K.reset_counts()
    close(K.parity_blend_interleave(t(s), t(yc), t(yp), t(bias), alpha, mode),
          want, **KERNEL_TOL)
    close(K.parity_blend_interleave4(t(s), t(y4), t(bias), alpha, mode), want4,
          **KERNEL_TOL)
    calls = K.counts("calls")
    assert calls["parity_blend_interleave"] == calls["parity_blend_interleave4"] == 1
    assert all(n == 0 for n in K.counts().values())  # CPU: no launches


def test_kernel_i_plain():
    """A non-square 12 x 20 grid; z's groups e00 | e01 | e10 | e11 sit at
    row and column offsets (pr, pc)."""
    rng = np.random.RandomState(1)
    n, h, w, c = 2, 12, 20, 16
    z = rng.randn(n, h + 1, w + 1, 4 * c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    want = j_sub_z(jnp.asarray(z), jnp.asarray(bias), c, interpret=True)
    assert want.shape == (n, 2 * h, 2 * w, c)
    close(subpixel_interleave_z_plain(t(z), t(bias)), want, **KERNEL_TOL)
    K.reset_counts()
    close(K.subpixel_interleave_z(t(z), t(bias)), want, **KERNEL_TOL)
    assert K.counts("calls")["subpixel_interleave_z"] == 1
    with pytest.raises(ValueError, match="channels"):
        K.subpixel_interleave_z(t(z[..., :-8]), t(bias))


@pytest.mark.parametrize("mode", MODES)
def test_kernel_d_taps_plain(mode):
    """The tail's per-tap body with the exact LayerNorm + SiLU: two row
    tiles of the Pallas kernel, halo rows zeroed after the activation."""
    rng = np.random.RandomState(2)
    c = 32
    x = (rng.randn(1, 5, 16, 24, c) * 0.5).astype(np.float32)
    norm = {"scale": 1 + 0.2 * rng.randn(c).astype(np.float32),
            "bias": 0.2 * rng.randn(c).astype(np.float32)}
    conv = {"kernel": 0.05 * rng.randn(3, 3, 3, c, 3).astype(np.float32),
            "bias": 0.1 * rng.randn(3).astype(np.float32)}
    want = JT.decoder_tail_rgb(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, norm),
                               jax.tree_util.tree_map(jnp.asarray, conv), mode,
                               tap_pack=False, interpret=True)
    sd = state_dict_from_jax({"decoder": {"norm_out": norm, "conv_out": conv}})
    tnorm = (t(sd["decoder.norm_out.norm.weight"]), t(sd["decoder.norm_out.norm.bias"]))
    tconv = (t(sd["decoder.conv_out.conv.weight"]), t(sd["decoder.conv_out.conv.bias"]))
    close(decoder_tail_rgb_taps_plain(t(x), tnorm, tconv, mode), want, **KERNEL_TOL)
    K.reset_counts()
    close(K.decoder_tail_rgb_taps(t(x), tnorm, tconv, mode), want, **KERNEL_TOL)
    assert K.counts("calls")["decoder_tail_rgb_taps"] == 1
    assert K.counts("calls")["decoder_tail_rgb"] == 0


@pytest.mark.parametrize("name,args", [
    ("parity_blend_interleave", lambda m: (m(1, 2, 4, 4, 8), m(1, 2, 4, 4, 16),
                                           m(1, 2, 4, 4, 16), m(8), m(1))),
    ("parity_blend_interleave4", lambda m: (m(1, 2, 4, 4, 8), m(1, 2, 4, 4, 32),
                                            m(8), m(1))),
    ("subpixel_interleave_z", lambda m: (m(2, 5, 5, 32), m(8))),
    ("decoder_tail_rgb_taps", lambda m: (m(1, 2, 4, 4, 16), (m(16), m(16)),
                                         (m(3, 16, 3, 3, 3), m(3)))),
])
def test_new_wrappers_refuse_off_cpu(name, args):
    """Off the CPU a wrapper launches its kernel or raises: a tensor that is
    not on a CUDA device (the meta device stands in here) never reaches the
    plain version."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    fn = K.WRAPPERS[name]
    extra = () if name == "subpixel_interleave_z" else ("zero",)
    K.reset_counts()
    with pytest.raises(ValueError):
        fn(*args(meta), *extra)
    assert K.counts("calls")[name] == 1
    assert K.counts()[name] == 0


# -- the forms at their call sites -------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parity", ["merged", "split"])
def test_time_upsample_parity_forms(monkeypatch, parity, mode):
    """JAX with kernel E declining runs one C->4C conv + H
    (``_PARITY_MERGED``) or two C->2C convs + G; the port's module in the
    same form, through its G or H wrapper."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 3, 6, 8, 16).astype(np.float32)
    forms = KernelForms(parity=parity)
    jcalls = jax_forms(monkeypatch, forms)
    jm = JB.TimeUpsampleRes2x(16, interpolation_mode="nearest", first_pad_mode=mode)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = jm.apply({"params": p}, jnp.asarray(x))
    key = "parity_blend_interleave4" if parity == "merged" else "parity_blend_interleave"
    assert jcalls == dict.fromkeys(NEW, 0) | {key: 1}

    tm = load_port(TB.TimeUpsampleRes2x(16, 16, first_pad_mode=mode,
                                        interpolation_mode="nearest"),
                   p, ("decoder", "up_temporal_1_upsample"),
                   "decoder.up_temporal.1.upsample.")
    K.reset_counts()
    with torch.no_grad():
        close(tm(t(x), fused=True, forms=forms), want)
    assert K.counts("calls") == dict.fromkeys(K.WRAPPERS, 0) | {key: 1}


def test_spatial_upsample_merged(monkeypatch):
    """One VALID 2x2 conv of the once-padded input + I, on a non-square
    12 x 20 grid."""
    rng = np.random.RandomState(4)
    x = rng.randn(1, 3, 12, 20, 16).astype(np.float32)
    forms = KernelForms(subpixel="merged")
    jcalls = jax_forms(monkeypatch, forms)
    jm = JB.SpatialUpsample()
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = jm.apply({"params": p}, jnp.asarray(x), fused=True)
    assert jcalls["subpixel_interleave_z"] == 1
    tm = load_port(TB.SpatialUpsample(16), p, ("decoder", "up_1_upsample"),
                   "decoder.up.1.upsample.")
    K.reset_counts()
    with torch.no_grad():
        close(tm(t(x), fused=True, forms=forms), want)
        close(tm(t(x), fused=False, forms=forms), want)     # the plain path
    assert K.counts("calls") == dict.fromkeys(K.WRAPPERS, 0) | {
        "subpixel_interleave_z": 1}


# -- the slice: the tiny models -------------------------------------------------

FORMS = [KernelForms(parity="merged"), KernelForms(parity="split"),
         KernelForms(subpixel="merged"), KernelForms(tail="taps"),
         KernelForms("merged", "merged", "taps")]


@pytest.fixture(scope="module")
def tiny():
    """The JAX v1.0 core, random params and a padded [1, 3, 5, 32, 32] clip."""
    core, _ = j_build(CFG)
    rng = np.random.RandomState(0)
    x = np.clip(rng.randn(1, 3, 5, 32, 32) * 0.5, -1, 1).astype(np.float32)
    v = core.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                  jnp.asarray(x.transpose(0, 2, 3, 4, 1)), sample_override=False)
    return core, randomize(v["params"], rng), x


@pytest.mark.parametrize("forms", FORMS, ids=lambda f: f"{f.parity}-{f.subpixel}-{f.tail}")
def test_tiny_v1_0_forms(monkeypatch, tiny, forms):
    """The port with ``fused`` and ``forms`` against JAX's fused forward
    under the same switches: one temporal upsample, one spatial upsample
    and one tail, each through the wrapper its form names."""
    core, params, x = tiny
    jcalls = jax_forms(monkeypatch, forms)
    zj, dj, lj = jax.jit(lambda p, v: core.apply(
        {"params": p}, v, sample_override=False, fused=True))(
            params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    tok = load_model_from_config({"model": CFG}, device="cpu", fused=True,
                                 forms=forms)
    load_port(tok.core, params, (), "")
    K.reset_counts()
    z, dec, log = tok(x)
    calls = K.counts("calls")
    parity = {"fused": "parity_up2x_fused", "merged": "parity_blend_interleave4",
              "split": "parity_blend_interleave"}[forms.parity]
    subpixel = {"split": "subpixel_interleave",
                "merged": "subpixel_interleave_z"}[forms.subpixel]
    tail = {"packed": "decoder_tail_rgb", "taps": "decoder_tail_rgb_taps"}[forms.tail]
    assert calls == dict.fromkeys(K.WRAPPERS, 0) | {
        "fused_spatial_resblock": 6, "fused_temporal_resblock": 6,
        parity: 1, subpixel: 1, tail: 1}
    assert all(n == 0 for n in K.counts().values())
    assert jcalls == {k: int(k in (parity, subpixel, tail)) for k in NEW}
    close(z, np.asarray(zj).transpose(0, 4, 1, 2, 3))
    close(dec, np.asarray(dj).transpose(0, 4, 1, 2, 3))
    np.testing.assert_allclose(float(log["kl_loss"]), float(lj["kl_loss"]), rtol=1e-4)


def test_tiled_v1_1_forms_equal_default():
    """The tiny v1.1 model's tiled decode (with overlap) in the ``merged``
    subpixel and ``taps`` tail forms equals the default forms', in fp32;
    I and D' run once per decoder chunk."""
    tok = load_model_from_config({"model": CFG_V1_1}, device="cpu", fused=True)
    core, _ = j_build(CFG_V1_1)
    rng = np.random.RandomState(5)
    x = np.clip(rng.randn(1, 3, 9, 16, 16) * 0.5, -1, 1).astype(np.float32)
    v = core.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                  jnp.asarray(x.transpose(0, 2, 3, 4, 1)), sample_override=False)
    load_port(tok.core, randomize(v["params"], rng), (), "")
    tok.use_tiling, tok.use_overlap = True, True
    tok.t_chunk_enc, tok.t_chunk_dec = 4, 2
    z = tok.encode(x)
    want = tok.decode(z)
    tok.forms = KernelForms(subpixel="merged", tail="taps")
    K.reset_counts()
    got = tok.decode(z)
    n_chunks = len(tok.build_chunk_start_end(z.shape[2], decoder_mode=True))
    assert n_chunks == 3 and got.shape == (1, 3, 10, 16, 16)
    assert K.counts("calls") == dict.fromkeys(K.WRAPPERS, 0) | {
        "fused_spatial_resblock": 4 * n_chunks,
        "fused_temporal_resblock_stream": 4 * n_chunks,
        "subpixel_interleave_z": n_chunks, "decoder_tail_rgb_taps": n_chunks,
        "temporal_linear_blend": n_chunks}
    close(got, want)


@pytest.mark.parametrize("field", ["parity", "subpixel", "tail"])
def test_unknown_form_raises(field):
    with pytest.raises(ValueError, match=f"unknown {field} form"):
        KernelForms(**{field: "packed" if field != "tail" else "merged"})
    with pytest.raises(ValueError, match="unknown"):
        KernelForms(**{field: "nope"})


def test_engine_takes_forms():
    """``forms`` reaches the engine through ``load_model_from_config``; it
    defaults to JAX's default forms and must be a ``KernelForms``."""
    tok = load_model_from_config({"model": CFG}, device="cpu")
    assert tok.forms == KernelForms("fused", "split", "packed")
    forms = KernelForms("split", "merged", "taps")
    assert load_model_from_config({"model": CFG}, device="cpu",
                                  forms=forms).forms is forms
    with pytest.raises(TypeError):
        VideoTokenizer(tok.core, tok.meta, forms="merged")
