"""Checkpoints in the PyTorch port (``vidtok_tpu_torch/utils/checkpoint.py``)
against ``vidtok_tpu``'s.

* Name parity: the port's ``state_dict()`` of the tiny v1.0, v1.1,
  non-causal and groupnorm models, through JAX's
  ``convert_torch_state_dict``, holds JAX's init tree exactly
  (``validate_params``: no missing, unexpected or mis-shaped leaf).
* A ``.ckpt`` written by ``VideoTokenizer.save`` loads in JAX's
  ``load_params`` and in the port (``ckpt=``), with equal outputs; a JAX
  ``save_params`` ``.npz`` and a full-checkpoint ``.npz``
  (``save_full_npz``) load in the port with JAX's outputs.
* Both spellings of a key that JAX's converter maps to one leaf load: the
  causal model with no wrapper levels and Conv3d-shaped temporal weights,
  the non-causal model with ``.conv`` levels added; ``.safetensors``.
* ``ignore_keys`` drops what it matches; a missing, unexpected or
  mis-shaped key raises; the reference's training-only keys are dropped.
* ``model.params.ckpt_path`` is honoured, and ``ckpt=`` wins over it.

Tiny models, fp32; the port against JAX at rtol 1e-4, atol 2e-4, the port
against itself exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.utils.checkpoint import (convert_torch_state_dict, load_params,
                                         save_full_npz, save_params,
                                         validate_params)
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.models.autoencoder import reset_params_
from vidtok_tpu_torch.utils import checkpoint as C

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)

_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2], "time_downsample_factor": 2,
      "num_res_blocks": 1, "norm_type": "layernorm",
      "interpolation_mode": "trilinear", "tempo_ds": [0], "tempo_us": [1]}


def model_cfg(enc, dec, params):
    return {"params": {
        "encoder_config": {"target": enc, "params": dict(params)},
        "decoder_config": {"target": dec, "params": dict(params)},
        "regularizer_config": {"target": "DiagonalGaussianRegularizer"}}}


VARIANTS = {
    "v1_0": model_cfg("EncoderCausal3D", "DecoderCausal3D", _P),
    "v1_1": model_cfg("EncoderCausal3DV1_1", "DecoderCausal3DV1_1", _P),
    "noncausal": model_cfg("Encoder3D", "Decoder3D", dict(
        _P, ch_mult=[1, 2, 2], time_downsample_factor=4, tempo_ds=[0, 1],
        tempo_us=[1, 2])),
    "groupnorm": model_cfg("EncoderCausal3D", "DecoderCausal3D",
                           dict(_P, ch=64, norm_type="groupnorm")),
}
X = np.clip(np.random.RandomState(0).randn(1, 3, 8, 16, 16) * 0.5, -1, 1).astype(np.float32)


def port(variant="v1_1", seed=1, **kw):
    """The port's tiny model on the CPU with weights that exercise every
    parameter: ``reset_params_`` from ``seed``, then every norm and mix
    factor and the zero-initialized temporal conv2 drawn too."""
    tok = load_model_from_config({"model": VARIANTS[variant]}, device="cpu", **kw)
    if "ckpt" not in kw:
        g = torch.Generator().manual_seed(seed)
        reset_params_(tok.core, g)
        with torch.no_grad():
            for p in tok.core.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return tok


def jax_out(variant, params):
    core, _ = j_build(VARIANTS[variant])
    z, dec, _ = core.apply({"params": params}, jnp.asarray(X.transpose(0, 2, 3, 4, 1)),
                           sample_override=False)
    return [np.asarray(a).transpose(0, 4, 1, 2, 3) for a in (z, dec)]


def port_out(tok):
    z, dec, _ = tok(X)
    return [z.numpy(), dec.numpy()]


def same(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def near(a, b):
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v, **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_name_parity(variant):
    tok = port(variant)
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in tok.core.state_dict().items()})
    core, _ = j_build(VARIANTS[variant])
    ref = jax.eval_shape(lambda: core.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.asarray(X.transpose(0, 2, 3, 4, 1)), sample_override=False))["params"]
    assert validate_params(params, ref) == ([], [], [])


def test_port_ckpt_loads_in_jax_and_port(tmp_path):
    tok = port()
    path = str(tmp_path / "tiny.ckpt")
    tok.save(path)
    want = port_out(tok)
    near(want, jax_out("v1_1", load_params(path, verbose=False)))
    same(want, port_out(port(ckpt=path)))


@pytest.mark.parametrize("full", [False, True])
def test_jax_npz_loads(tmp_path, full):
    """``save_params``' flat npz, or a full checkpoint's ``core`` section
    beside its other sections."""
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in port(seed=2).core.state_dict().items()})
    path = str(tmp_path / "tiny.npz")
    if full:
        save_full_npz(path, {"core": params, "logvar": np.float32(0.5),
                             "disc_params": {"conv0": {"kernel": np.ones((1, 2))}}})
    else:
        save_params(path, params)
    near(port_out(port(ckpt=path)), jax_out("v1_1", params))


def _bare(key, value):
    """The key with no wrapper level, a temporal weight Conv3d-shaped."""
    return C.canonical(key), (value[..., None, None] if value.dim() == 3 else value)


def _wrapped(key, value):
    """A ``.conv`` level under each conv wrapper name that has none."""
    *path, leaf = key.split(".")
    if path[-1] in C._CONV_WRAPPERS and leaf in ("weight", "bias"):
        path.append("conv")
    return ".".join(path + [leaf]), value


@pytest.mark.parametrize("variant,form", [("v1_1", _bare), ("noncausal", _wrapped)],
                         ids=["causal_bare", "noncausal_wrapped"])
def test_both_key_forms_load(tmp_path, variant, form):
    tok = port(variant)
    sd = dict(form(k, v) for k, v in tok.core.state_dict().items())
    assert sd.keys() != tok.core.state_dict().keys()
    path = str(tmp_path / "forms.ckpt")
    torch.save({"state_dict": sd, "global_step": 3}, path)
    same(port_out(tok), port_out(port(variant, ckpt=path)))


def test_safetensors(tmp_path, monkeypatch):
    safetensors = pytest.importorskip("safetensors.torch")
    tok = port(seed=3)
    path = str(tmp_path / "tiny.safetensors")
    safetensors.save_file(dict(tok.core.state_dict()), path)
    same(port_out(tok), port_out(port(ckpt=path)))
    monkeypatch.setitem(__import__("sys").modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors"):
        C.read_state_dict(path)


def test_training_keys_and_ignore_keys(tmp_path):
    """The reference's loss, EMA and FSQ buffer keys are dropped; a key
    ``ignore_keys`` matches is dropped (and one it leaves raises)."""
    tok = port(seed=4)
    sd = dict(tok.core.state_dict())
    sd.update({"loss.logvar": torch.zeros(()), "model_ema.decay": torch.ones(()),
               "regularization._levels": torch.ones(4),
               "encoder.extra.weight": torch.ones(2)})
    path = str(tmp_path / "train.ckpt")
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match=r"1 unexpected \(encoder.extra.weight\)"):
        port(ckpt=path)
    cfg = {"model": dict(VARIANTS["v1_1"], params=dict(
        VARIANTS["v1_1"]["params"], ckpt_path=path, ignore_keys=[r"encoder\.extra"]))}
    same(port_out(tok), port_out(load_model_from_config(cfg, device="cpu")))
    with pytest.raises(ValueError, match="1 missing"):
        C.load_into(port().core, C.read_state_dict(path, [r"encoder\.extra",
                                                          r"decoder\.conv_out\.conv\.bias"]))


@pytest.mark.parametrize("fault", ["missing", "mis-shaped"])
def test_strict_load_raises(fault):
    core = port().core
    sd = dict(core.state_dict())
    key = "decoder.conv_in.conv.weight"
    if fault == "missing":
        del sd[key]
    else:
        sd[key] = sd[key][:, :3]
    with pytest.raises(ValueError, match=f"1 {fault} .*{key}"):
        C.load_into(core, sd)


def test_ckpt_wins_over_ckpt_path(tmp_path):
    a, b = port(seed=5), port(seed=6)
    pa, pb = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    a.save(pa)
    b.save(pb)
    cfg = {"model": dict(VARIANTS["v1_1"], params=dict(VARIANTS["v1_1"]["params"],
                                                        ckpt_path=pa))}
    same(port_out(a), port_out(load_model_from_config(cfg, device="cpu")))
    same(port_out(b), port_out(load_model_from_config(cfg, device="cpu", ckpt=pb)))
