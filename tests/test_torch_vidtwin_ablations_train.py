"""The port's ``VidTwinTrainer`` on the ablation ladder (JAX's trainer
takes any ladder class: ``model.apply(..., return_features=True)``), on
the CPU at ``tests/test_vidtwin_ablations.py``'s size cut to one block a
transformer and two layers a Q-Former:

* one fp32 ``fit_step`` on a Compact model against JAX's
  ``VidTwinTrainer`` (one mesh device) on the same weights (the model's
  drawn, the discriminator's its JAX init, as in
  ``test_torch_vidtwin_train.py``) and batch, f32 attention on both
  sides: every log within rtol 1e-4, ``d_weight`` (through
  ``decoder.final_layer.linear``) > 0, ``kl_loss`` 0. LPIPS is off
  (``perceptual_weight`` 0): ``test_torch_vidtwin_train.py`` holds it, and
  its weights here are ``chip_smoke.clis.lpips_npz``'s random ones;
* one step of the port's trainer on each of the other three targets:
  finite logs, ``d_weight`` > 0 and ``kl_loss`` 0 for every class, and
  the generator moved by a second step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke.clis import lpips_npz
from tests.test_torch_vidtwin import random_params, to_torch
from tests.test_torch_vidtwin_ablations_common import CASES, model_cfg
from tests.test_vidtwin_train import CFG
from vidtok_tpu_torch.models.vidtwin.convert import vidtwin_ablation_state_dict_from_jax
from vidtok_tpu_torch.models.vidtwin.trainer import VidTwinTrainer
from vidtok_tpu_torch.utils.checkpoint import load_into

torch.set_num_threads(2)
X = (np.random.RandomState(0).randn(2, 4, 32, 32, 3) * 0.3).astype(np.float32)


def train_cfg(case):
    """``tests/test_vidtwin_train.py``'s recipe on the ablation ``case``,
    ``perceptual_weight`` 0, one block a transformer and two layers a
    Q-Former (JAX's compile of the step is most of this file's time; the
    forward at the full test size is held in the other ablation files)."""
    target, params = CASES[case]
    cfg = copy.deepcopy(CFG)
    cfg["model"]["target"] = target
    p = cfg["model"]["params"]
    p.update(copy.deepcopy(model_cfg(target, **params)["params"]))
    for part in ("encoder_config", "decoder_config"):
        p[part]["params"]["depth"] = 1
    for key, q in p.items():
        if key.endswith("qformer_config"):
            q["params"] = dict(q["params"], num_hidden_layers=2)
    p["loss_config"]["params"]["perceptual_weight"] = 0.0
    return cfg


def jax_model(cfg):
    """JAX's model of ``cfg`` with f32 attention (``_build``'s clone)."""
    from vidtok_tpu.models.vidtwin.vidtwin_ae import build_vidtwin_from_config

    model, _ = build_vidtwin_from_config(cfg["model"])
    return model.clone(encoder=model.encoder.clone(attn_dtype=None),
                       decoder=model.decoder.clone(attn_dtype=None))


def test_trainer_step_against_jax(tmp_path):
    from vidtok_tpu.models.vidtwin.trainer import VidTwinTrainer as JT
    from vidtok_tpu.parallel.mesh import make_mesh
    from vidtok_tpu_torch.convert import discriminator_state_dict_from_jax

    cfg = train_cfg("compact")
    lp = str(tmp_path / "lpips.npz")
    lpips_npz(lp)
    jt = JT(cfg, mesh=make_mesh(n_data=1), lpips_weights=lp, total_steps=1000)
    jt.model = jax_model(cfg)
    shapes = jax.eval_shape(jt.init_state, X)
    core = random_params(shapes.params_g["core"], 65)
    dvars = jax.device_get(jax.jit(lambda k, x: jt.disc.init(k, x, train=False))(
        jax.random.PRNGKey(66), X.reshape(-1, 32, 32, 3)))
    params_g = {"core": core, "logvar": np.float32(0.0)}
    state = jax.tree_util.tree_map(jnp.asarray, shapes.replace(
        step=np.int32(0), params_g=params_g, params_d=dvars["params"],
        batch_stats_d=dvars["batch_stats"], opt_state_g=jt.opt_g.init(params_g),
        opt_state_d=jt.opt_d.init(dvars["params"]),
        lecam_ema_real=np.float32(0.0), lecam_ema_fake=np.float32(0.0)))
    tt = VidTwinTrainer(cfg, device="cpu", lpips_weights=lp, total_steps=1000).init_state()
    assert type(tt.model).__name__ == "VidTwinCompact"
    tt.model.encoder.set_attn_dtype(None)
    tt.model.decoder.set_attn_dtype(None)
    load_into(tt.model, to_torch(vidtwin_ablation_state_dict_from_jax(core)))
    tt.disc.load_state_dict(to_torch(discriminator_state_dict_from_jax(
        dvars["params"], dvars["batch_stats"])))
    with torch.no_grad():
        tt.logvar.fill_(0.0)
    _, jlogs = jt.fit_step(state, X, jax.random.PRNGKey(0))
    tlogs = tt.fit_step(torch.from_numpy(X))
    assert set(jlogs) == set(tlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(tlogs["train/kl_loss"]) == 0.0 and float(tlogs["train/d_weight"]) > 0


@pytest.mark.parametrize("case", ["qformer", "sym", "symdis"])
def test_trainer_takes_every_class(case, tmp_path):
    lp = str(tmp_path / "lpips.npz")
    lpips_npz(lp)
    tt = VidTwinTrainer(train_cfg(case), device="cpu", lpips_weights=lp,
                        total_steps=1000).init_state()
    logs = tt.fit_step(torch.from_numpy(X))
    assert all(bool(torch.isfinite(v)) for v in logs.values()), logs
    assert float(logs["train/kl_loss"]) == 0.0 and float(logs["train/d_weight"]) > 0
    before = [p.detach().clone() for p in tt.model.parameters()]
    tt.fit_step(torch.from_numpy(X))
    assert any(not torch.equal(a, p) for a, p in zip(before, tt.model.parameters()))
