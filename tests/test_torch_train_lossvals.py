"""The port's loss stack against ``vidtok_tpu``'s (fp32):
``generator_loss`` and ``discriminator_loss`` (every log, ``d_weight``,
LeCAM's new EMAs) on the tiny model's ``forward_train`` output, in the two
cases of ``tests/test_train.py:90-101`` (2D, hinge, LeCAM, cross-entropy,
learned log-variance; 3D, vanilla), before and after ``disc_start``:
rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_common import config, lpips_npz, to_torch
from vidtok_tpu.train import losses as JL
from vidtok_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from vidtok_tpu_torch.train import losses as TL

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def lpips(tmp_path_factory):
    return lpips_npz(tmp_path_factory.mktemp("lpips") / "lpips.npz")


@pytest.mark.parametrize("step", [2, 5])
@pytest.mark.parametrize("case", ["2d", "3d"])
def test_loss_values(case, step, lpips):
    """The loss stack on one forward: ``disc_start`` 6 of the reference
    goldens, so step 2 (global step 4) is before it and step 5 after."""
    from vidtok_tpu.models.autoencoder import TokenizerCore, build_core_from_config
    from vidtok_tpu.modules.lpips import LPIPS as JLPIPS
    from vidtok_tpu.modules.lpips import load_lpips_params
    from vidtok_tpu_torch.models.autoencoder import build_core_from_config as t_build
    from vidtok_tpu_torch.modules.lpips import LPIPS, load_lpips_params as t_lpips
    from vidtok_tpu_torch.utils.checkpoint import load_into

    cfg = config("kl", case, disc_start=6)
    mcfg = cfg["model"]
    core, _ = build_core_from_config(mcfg)
    x = (np.random.RandomState(2).randn(2, 5, 32, 32, 3) * 0.3).astype(np.float32)
    xj = jnp.asarray(x)
    params = core.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                       xj, sample_override=False)["params"]
    lcfg = JL.LossConfig.from_dict(mcfg["params"]["loss_config"]["params"])
    disc = JL.make_discriminator(lcfg)
    dvars = disc.init(jax.random.PRNGKey(2), JL._fold_frames(xj) if case == "2d" else xj)
    lp = load_lpips_params(lpips)
    logvar = jnp.float32(lcfg.logvar_init)

    z, xrec, pre, reg_log = core.apply({"params": params}, xj,
                                       rngs={"sample": jax.random.PRNGKey(0)},
                                       method=TokenizerCore.forward_train)
    jloss, jlogs, bs = JL.generator_loss(
        cfg=lcfg, lpips=JLPIPS(), lpips_params=lp, disc=disc, disc_vars=dvars,
        last_layer_params=params["decoder"]["conv_out"],
        apply_last_layer=core.decoder.apply_conv_out, logvar=logvar, x=xj, xrec=xrec,
        pre_features=pre, reg_log=reg_log, global_step=step)
    dl, dlogs, _, (er, ef) = JL.discriminator_loss(
        cfg=lcfg, disc=disc, disc_vars={**dvars, "batch_stats": bs}, x=xj, xrec=xrec,
        global_step=step, lecam_ema_real=jnp.float32(0.3), lecam_ema_fake=jnp.float32(-0.2))

    tcore, _ = t_build(mcfg)
    load_into(tcore, to_torch(state_dict_from_jax(jax.device_get(params))))
    tdisc = TL.make_discriminator(TL.LossConfig.from_dict(mcfg["params"]["loss_config"]["params"]))
    tdisc.load_state_dict(to_torch(discriminator_state_dict_from_jax(
        jax.device_get(dvars["params"]), jax.device_get(dvars["batch_stats"]))))
    tlp = LPIPS()
    tlp.load_state_dict(t_lpips(lpips))
    tcfg = TL.LossConfig.from_dict(mcfg["params"]["loss_config"]["params"])
    xt = torch.from_numpy(x)
    _, txrec, _, treg = tcore.forward_train(xt)
    tloss, tlogs = TL.generator_loss(
        cfg=tcfg, lpips=tlp, disc=tdisc, last_layer=tcore.decoder.conv_out.conv.weight,
        logvar=torch.tensor(tcfg.logvar_init, requires_grad=True), x=xt, xrec=txrec,
        reg_log=treg, global_step=step)
    tdl, tdlogs, (tr, tf) = TL.discriminator_loss(
        cfg=tcfg, disc=tdisc, x=xt, xrec=txrec, global_step=step,
        lecam_ema_real=torch.tensor(0.3), lecam_ema_fake=torch.tensor(-0.2))

    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(float(tdl), float(dl), **TOL)
    for want, got in ((jlogs, tlogs), (dlogs, tdlogs)):
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **TOL)
    np.testing.assert_allclose([float(tr), float(tf)], [float(er), float(ef)], **TOL)
    assert float(tlogs["train/d_weight"]) > 0
    assert float(tlogs["train/disc_factor"]) == (0.0 if step == 2 else 1.0)
