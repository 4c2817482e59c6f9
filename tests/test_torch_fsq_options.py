"""FSQ's options in the PyTorch port against ``vidtok_tpu`` (fp32, CPU).

* The regularizer alone (``check_fsq_options``, also run by
  ``tests/test_torch_v1_0.py`` for each option alone): two codebooks, a
  projection down (``dim`` 8 onto one codebook of 4 levels), a projection
  up (``dim`` 4 onto two codebooks of 4), ``diversity_gamma`` 0.5 (both
  built by their packages' ``build_core_from_config``) and
  ``inv_temperature`` 10 (the port's ``build_core_from_config`` against
  JAX's module, since JAX's ``build_core_from_config`` drops the option): indices exactly, the output and
  ``decode_indices`` exactly (the codes), or within rtol 1e-4, atol 2e-4
  where ``project_out`` maps them (an f32 GEMM in each package),
  ``decode_indices`` equal to the forward's output, ``aux_loss`` within
  rtol 1e-4 with and without annealing, and the gradients of ``aux_loss``
  and of the output with respect to z within 1e-4 of ``jax.grad``.
* A tiny v1.0 model with projections and two codebooks: z, x_rec within
  rtol 1e-4, atol 2e-4 and indices exactly, decoding from the indices; the
  same bottleneck in a tiny v1.1 model tiled against JAX's tiled engine
  (the sharded run over two gloo ranks is ``tests/test_torch_sharded.py``'s
  ``fsq_proj`` case).
* Weights: ``state_dict_from_jax`` maps the projections' Dense kernels to
  Linear weights, and a reference-layout ``.ckpt`` with
  ``regularization.project_{in,out}.{weight,bias}`` loads strictly through
  ``load_model_from_config(ckpt=...)`` to JAX's converted weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_stream import _P as _P_V1_1
from tests.test_torch_stream import jax_tok, port_tok
from tests.test_torch_v1_0 import (FSQ_CFG, FSQ_PARAMS, close, flat, load_jax_params,
                                   random_params, t)
from vidtok_tpu.models.autoencoder import TokenizerCore
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.modules.regularizers import FSQRegularizer as JFSQ
from vidtok_tpu.utils.checkpoint import convert_torch_state_dict
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.models.autoencoder import build_core_from_config

torch.set_num_threads(2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LEVELS = [8, 5, 5, 5]
# a projection up onto two codebooks: z_channels 4 -> 2 x 4 FSQ values
PROJ = {"dim": 4, "num_codebooks": 2}


def fsq_cfg(base, extra):
    """``base`` (a model section) with FSQ_PARAMS and ``extra`` as its
    regularizer's parameters."""
    return {"params": dict(base["params"], regularizer_config={
        "target": "FSQRegularizer", "params": dict(FSQ_PARAMS, **extra)})}


def jax_regularizer(extra):
    """JAX's regularizer of ``extra``: from JAX's ``build_core_from_config``,
    but for ``inv_temperature``, which it drops (the module itself)."""
    if "inv_temperature" in extra:
        return JFSQ(levels=tuple(LEVELS), **{k: v for k, v in FSQ_PARAMS.items()
                                             if k != "levels"}, **extra)
    return j_build(fsq_cfg(FSQ_CFG, extra))[0].regularizer


def check_fsq_options(extra, seed=0):
    """The port's regularizer built from ``extra`` against JAX's on a
    ``[2, 3, 4, 4, dim]`` latent; projections random (non-zero biases)."""
    reg = build_core_from_config(fsq_cfg(FSQ_CFG, extra))[0].regularization
    jreg = jax_regularizer(extra)
    c = extra.get("num_codebooks", 1)
    dim = extra.get("dim", len(LEVELS) * c)
    assert reg.dim == dim and reg.num_codebooks == c
    assert reg.has_projections == (dim != len(LEVELS) * c)
    for key in ("diversity_gamma", "inv_temperature"):
        if key in extra:
            assert getattr(reg, key) == extra[key]
    rng = np.random.RandomState(seed)
    z = rng.randn(2, 3, 4, 4, dim).astype(np.float32) * 1.5
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * (1 / np.sqrt(a.shape[0]) if a.ndim == 2
                                          else 0.1)).astype(np.float32),
        jreg.init(jax.random.PRNGKey(0), jnp.asarray(z)).get("params", {}))
    variables = {"params": params} if params else {}
    sd = {k[len("regularization."):]: t(v)
          for k, v in state_dict_from_jax({"regularizer": params}).items()}
    reg.load_state_dict(sd, strict=True)

    for n_steps in (0, 3000):  # annealed and not
        jout, jlog = jreg.apply(variables, jnp.asarray(z), n_steps=n_steps)
        with torch.no_grad():
            out, log = reg(t(z), n_steps=n_steps)
        want_idx = np.asarray(jlog["indices"])
        assert want_idx.shape == ((2, 3, 4, 4, c) if c > 1 else (2, 3, 4, 4))
        np.testing.assert_array_equal(log["indices"].numpy(), want_idx)
        # the codes exactly; their projection as two f32 GEMMs round it
        (close if reg.has_projections else np.testing.assert_array_equal)(
            out.numpy(), np.asarray(jout))
        np.testing.assert_allclose(float(log["aux_loss"]), float(jlog["aux_loss"]),
                                   rtol=1e-4)
    idx = log["indices"]
    jdec = jreg.apply(variables, jlog["indices"], method=JFSQ.decode_indices)
    with torch.no_grad():
        dec = reg.decode_indices(idx).numpy()
    (close if reg.has_projections else np.testing.assert_array_equal)(
        dec, np.asarray(jdec))
    np.testing.assert_array_equal(dec, out.numpy())

    # gradients with respect to z: of aux_loss, and of the output through
    # the straight-through rounding (and the projections)
    w = rng.randn(*out.shape).astype(np.float32)
    for what in ("aux_loss", "out"):
        def j_loss(v):
            o, lg = jreg.apply(variables, v, n_steps=0)
            return lg["aux_loss"] if what == "aux_loss" else jnp.sum(o * w)

        zt = t(z).requires_grad_(True)
        o, lg = reg(zt)
        (lg["aux_loss"] if what == "aux_loss" else (o * t(w)).sum()).backward()
        np.testing.assert_allclose(zt.grad.numpy(),
                                   np.asarray(jax.grad(j_loss)(jnp.asarray(z))),
                                   **GRAD_TOL, err_msg=what)


def test_fsq_projection_and_codebooks():
    """A projection up onto two codebooks, the combination the other cases
    take one by one."""
    check_fsq_options(PROJ, seed=5)


def test_fsq_lecun_init_is_seeded():
    """Random weights come from the seed's generator: JAX's Dense init
    (lecun normal kernels, zero biases) drawn from the seed."""
    cfg = {"model": fsq_cfg(FSQ_CFG, PROJ)}
    a, b = (load_model_from_config(cfg, device="cpu", seed=s).core.regularization
            for s in (0, 0))
    c = load_model_from_config(cfg, device="cpu", seed=1).core.regularization
    assert torch.equal(a.project_in.weight, b.project_in.weight)
    assert not torch.equal(a.project_in.weight, c.project_in.weight)
    assert a.project_in.weight.shape == (8, 4) and a.project_out.weight.shape == (4, 8)
    assert not a.project_in.bias.any() and not a.project_out.bias.any()
    # truncated at 2 sigma of the rescaled normal: |w| <= 2 sqrt(1 / fan_in) / 0.8796...
    # (1e-6: the draw is scaled in f32)
    assert float(a.project_in.weight.detach().abs().max()) <= 2 / np.sqrt(4) / 0.87962566 + 1e-6


@pytest.fixture(scope="module")
def tiny_proj():
    """JAX's tiny v1.0 FSQ model with PROJ, random params, a padded
    5-frame clip and JAX's forward."""
    cfg = fsq_cfg(FSQ_CFG, PROJ)
    core, _ = j_build(cfg)
    x = np.clip(np.random.RandomState(8).randn(1, 3, 5, 32, 32) * 0.5, -1, 1)
    x = x.astype(np.float32)
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    params = random_params(core, xt, seed=9)
    out = jax.jit(lambda p, v: core.apply({"params": p}, v, sample_override=False))(
        params, xt)
    return cfg, core, params, x, out


def test_tiny_fsq_projections_end_to_end(tiny_proj):
    cfg, core, params, x, (zj, dj, lj) = tiny_proj
    tok = load_model_from_config({"model": cfg}, device="cpu")
    load_jax_params(tok.core, params)
    z, dec, log = tok(x)
    idx = log["indices"]
    assert idx.dtype == torch.int32 and idx.shape == (1, 3, 16, 16, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(lj["indices"]))
    close(z, np.asarray(zj).transpose(0, 4, 1, 2, 3))
    close(dec, np.asarray(dj).transpose(0, 4, 1, 2, 3))
    np.testing.assert_allclose(float(log["aux_loss"]), float(lj["aux_loss"]), rtol=1e-4)
    want = core.apply({"params": params}, lj["indices"], method=TokenizerCore.decode_indices)
    close(tok.indices_to_latent(idx), np.asarray(want).transpose(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(tok.indices_to_latent(idx).numpy(), z.numpy())
    np.testing.assert_array_equal(tok.decode(idx, decode_from_indices=True).numpy(),
                                  dec.numpy())


def test_tiled_fsq_projections():
    """The PROJ bottleneck in a tiny v1.1 model, tiled with overlap, against
    JAX's tiled engine: the chunks' indices ``[B, T', H', W', 2]`` joined
    along time."""
    cfg = {"params": {
        "encoder_config": {"target": "EncoderCausal3DV1_1",
                           "params": dict(_P_V1_1, double_z=False)},
        "decoder_config": {"target": "DecoderCausal3DV1_1",
                           "params": dict(_P_V1_1, double_z=False)},
        "regularizer_config": {"target": "FSQRegularizer",
                               "params": dict(FSQ_PARAMS, **PROJ)}}}
    core, meta = j_build(cfg)
    rng = np.random.RandomState(11)
    x = np.clip(rng.randn(1, 3, 9, 16, 16) * 0.5, -1, 1).astype(np.float32)
    params = random_params(core, x.transpose(0, 2, 3, 4, 1), seed=12)
    jt = jax_tok(core, meta, params, use_overlap=True)
    jz, jlog = jt.encode(jnp.asarray(x), return_reg_log=True)
    tok = port_tok(params, cfg, use_overlap=True)
    z, log = tok.encode(x, return_reg_log=True)
    assert log["indices"].shape == (1, 5, 8, 8, 2)
    np.testing.assert_array_equal(log["indices"].numpy(), np.asarray(jlog["indices"]))
    close(z, jz)
    close(log["aux_loss"], jlog["aux_loss"])
    close(tok.decode(log["indices"], decode_from_indices=True),
          jt.decode(jlog["indices"], decode_from_indices=True))


def test_projections_convert_and_load(tiny_proj, tmp_path):
    """JAX's tree -> the port's keys (Dense IO -> Linear OI); a
    reference-layout ``.ckpt`` (with a ``loss.*`` entry and FSQ buffers,
    which the reader drops) loads strictly and gives JAX's weights; JAX's
    converter reads the port's keys back to JAX's tree."""
    cfg, _, params, _, _ = tiny_proj
    sd = state_dict_from_jax(params)
    reg = params["regularizer"]
    for name in ("project_in", "project_out"):
        np.testing.assert_array_equal(sd[f"regularization.{name}.weight"],
                                      np.asarray(reg[name]["kernel"]).T)
        np.testing.assert_array_equal(sd[f"regularization.{name}.bias"],
                                      np.asarray(reg[name]["bias"]))
    ref = {k: t(v) for k, v in sd.items()}
    ref.update({"loss.logvar": torch.zeros(()), "regularization._levels":
                torch.tensor(LEVELS), "regularization.implicit_codebook": torch.zeros(4, 4)})
    path = str(tmp_path / "fsq_proj.ckpt")
    torch.save({"state_dict": ref}, path)
    tok = load_model_from_config({"model": cfg}, ckpt=path, device="cpu")
    got = tok.core.state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = convert_torch_state_dict({k: v.numpy() for k, v in got.items()})
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    del ref["regularization.project_out.bias"]
    torch.save({"state_dict": ref}, path)
    with pytest.raises(ValueError, match="missing.*project_out.bias"):
        load_model_from_config({"model": cfg}, ckpt=path, device="cpu")
