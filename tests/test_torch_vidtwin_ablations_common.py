"""What the port's ablation-ladder tests share (no tests here):
``tests/test_vidtwin_ablations.py``'s size and cases (clips [4, 32, 32],
patch 1 x 8 x 8, hidden 64, depth 2, 4 heads, ``temporal_casual`` False,
f32 attention on both sides), each JAX model with its weights drawn from a
seed (``tests/test_torch_vidtwin.py``'s ``random_params``: no parameter
left at zero), its jitted forward, and the port's model holding the same
weights through ``vidtwin_ablation_state_dict_from_jax``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_vidtwin import TOL, clip, init, ncthw, to_torch
from tests.test_vidtwin_ablations import _build, _q_cfg, _stt_cfg
from vidtok_tpu.models.vidtwin.convert import convert_vidtwin_ablation_state_dict
from vidtok_tpu_torch.models.vidtwin.convert import vidtwin_ablation_state_dict_from_jax
from vidtok_tpu_torch.models.vidtwin.vidtwin_ae import build_vidtwin_from_config
from vidtok_tpu_torch.utils.checkpoint import load_into

SYM = dict(temporal_qformer_config=_q_cfg(4), space_qformer_config=_q_cfg(3), init_ch=16,
           cont_num_blocks=1, expect_ch=8)
_COMPACT = dict(temporal_qformer_config=_q_cfg(4), space_qformer_config=_q_cfg(3),
                temporal_down_dim=8)
# tests/test_vidtwin_ablations.py's cases, Sym also without retain_num_frames
CASES = {
    "qformer": ("VidAutoEncoderQformer", dict(
        temporal_qformer_config=_q_cfg(4), height_qformer_config=_q_cfg(2),
        width_qformer_config=_q_cfg(2))),
    "compact": ("VidAutoEncoderQformerCompact", _COMPACT),
    "compact_alt": ("VidAutoEncoderQformerCompact", dict(
        _COMPACT, retain_num_frames=False, repeat_for_decoder=True)),
    "sym": ("VidAutoEncoderQformerCompactSym", SYM),
    "sym_alt": ("VidAutoEncoderQformerCompactSym", dict(SYM, retain_num_frames=False)),
    "symdis": ("VidAutoEncoderQformerCompactSymDis", dict(SYM, shuffle_content_ratio=0.0)),
}


def model_cfg(target, **params):
    """``_build``'s config (JAX's test builds from it)."""
    return {"target": target, "params": {
        "encoder_config": _stt_cfg("e"), "decoder_config": _stt_cfg("d"),
        "regularizer_config": {"target": "DiagonalGaussianRegularizer",
                               "params": {"sample": False}},
        **params}}


def port(cfg, params):
    """The port's model of ``cfg`` holding JAX's ``params``, f32
    attention, eval mode."""
    model, _ = build_vidtwin_from_config(cfg)
    load_into(model, to_torch(vidtwin_ablation_state_dict_from_jax(params)),
              model.unused_keys())
    model.encoder.set_attn_dtype(None)
    model.decoder.set_attn_dtype(None)
    return model.eval()


@functools.lru_cache(maxsize=None)
def pair(case):
    """(JAX model (f32 attention), its drawn params, its jitted forward
    ``fn(params, x) -> (z, dec, pre, reg_log, latents)``, the port's
    model)."""
    target, params = CASES[case]
    jm = _build(target, **params)
    p = init(jm, 50 + list(CASES).index(case), jnp.asarray(clip()))
    fn = jax.jit(lambda p, x: jm.apply({"params": p}, x, return_features=True,
                                       rngs={"sample": jax.random.PRNGKey(0)}))
    return jm, p, fn, port(model_cfg(target, **params), p)


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want), (what, got.shape, np.shape(want))
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def check_forward(case):
    jm, p, fn, tm = pair(case)
    x = clip(60)
    z, dec, pre, log, lat = fn(p, jnp.asarray(x))
    seen = []  # JAX's features: the input of the decoder's final linear
    hook = tm.decoder.final_layer.linear.register_forward_pre_hook(
        lambda m, a: seen.append(a[0]))
    try:
        with torch.no_grad():
            out = tm(torch.from_numpy(ncthw(x)), generator=torch.Generator().manual_seed(0))
    finally:
        hook.remove()
    assert len(out) == 4 and len(seen) == 1
    tz, tdec, tlog, tlat = out
    close(tz.permute(0, 2, 3, 4, 1), z, "z")
    close(tdec, ncthw(dec), "reconstruction")
    close(seen[0], pre, "features")
    assert len(tlat) == len(lat) == (3 if case == "qformer" else 2)
    for i, (a, b) in enumerate(zip(tlat, lat)):
        close(a, b, f"latent {i}")
    assert float(tlog["kl_loss"]) == float(log["kl_loss"]) == 0.0
    assert tuple(tz.shape) == ((4,) if case == "symdis" else (2,)) + (64, 4, 4, 4)


def check_only_part(case, part):
    jm, p, fn, tm = pair(case)
    _, _, _, _, (u_c, u_m) = fn(p, jnp.asarray(clip(60)))
    want = jm.apply({"params": p}, u_c, u_m, only_part=part, method=type(jm).decode)
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(np.array(u_c)), torch.from_numpy(np.array(u_m)),
                        only_part=part)
    close(got, ncthw(want), part)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def check_state_dict(case):
    """JAX's converter of the port's state dict: JAX's tree leaf for leaf."""
    _, p, _, tm = pair(case)
    back = _flat(convert_vidtwin_ablation_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}))
    want = _flat(p)
    extra = {"/up_channel_temp/kernel", "/up_channel_temp/bias"} if case == "compact_alt" else set()
    assert set(back) == set(want) | extra
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
