"""The port's VidTwin training (``vidtok_tpu_torch/models/vidtwin``:
``schedules``, ``trainer``) against ``vidtok_tpu``'s on the CPU.

* The four learning-rate schedules against JAX's (f32 ``jnp``) at steps 0,
  warm-up - 1, warm-up, mid-way and the end: within 1e-7 absolute and 4
  f32 ulps relative (JAX rounds each operation to f32, the port computes
  in Python floats).
* One fp32 ``fit_step`` against JAX's ``VidTwinTrainer`` (one mesh device)
  on ``tests/test_vidtwin_train.py``'s config with sampling off and f32
  attention on both sides, on the same weights, batch and LPIPS weights:
  the VidTwin model's drawn (every parameter, the zero-initialised ones
  too), the discriminator's its JAX init, as both trainers start (with
  drawn N(0, 1/fan_in) convs its BatchNorm backward is ill-conditioned in
  f32: both frameworks' clipped gradients then lie 3e-3 from a float64
  run's); each logged loss and ``d_weight`` within
  rtol 1e-4; the clipped gradients of the generator and of the
  discriminator (each AdamW's first moment, which with beta1 0 is the
  clipped gradient) within a relative L2 of 1e-4; every parameter after
  the step within 1e-4 relative (L2, per tensor), the generator's equal to
  its start (lr_g is 0 at step 0), the discriminator's total update
  within a relative L2 of 0.1 (AdamW moves each weight by about
  lr x sign(g), so a gradient near zero that the frameworks round to
  opposite signs moves it 2 x lr apart).
* ``lr_g`` 0 and ``lr_d`` 1e-5 at step 0; one AdamW over every generator
  parameter and logvar, with the config's betas and weight decay.
* A second step of both, where lr_g is 3e-7: the logs and the generator's
  clipped gradient as at step 0, every generator parameter within 1e-4
  relative (L2, per tensor), the generator's whole update within a relative
  L2 of ``UPD_G1`` and logvar (its update, as it starts at 0) within rtol
  1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_common import lpips_npz, rel
from tests.test_torch_vidtwin import f32_jax, random_params, to_torch
from tests.test_vidtwin_train import CFG
from vidtok_tpu.models.vidtwin import schedules as JS
from vidtok_tpu_torch.convert import discriminator_state_dict_from_jax
from vidtok_tpu_torch.models.vidtwin import schedules as S
from vidtok_tpu_torch.models.vidtwin.convert import vidtwin_state_dict_from_jax
from vidtok_tpu_torch.models.vidtwin.trainer import VidTwinTrainer

torch.set_num_threads(2)
F32_ULP = 2.0 ** -23
# the generator's whole step-1 update, port against JAX: 8.8e-4 relative L2
# measured (f32 rounding of p0 + u, with u about 3e-7 against p about 0.05,
# and the 2e-6 gap in the clipped gradient); 5e-3 keeps 5x of headroom and
# still fails a learning rate or an Adam step off by 0.5 %
UPD_G1 = 5e-3


def _cfg():
    import copy

    cfg = copy.deepcopy(CFG)
    cfg["model"]["params"]["regularizer_config"]["params"]["sample"] = False
    return cfg


@pytest.mark.parametrize("name", ["cosine", "linear", "constant", "inverse_sqrt"])
def test_schedules(name):
    warm, total = 100, 1000
    make = {"cosine": lambda m: m.lambda_warmup_cosine(1e-6, 3e-5, 1e-5, warm, total),
            "linear": lambda m: m.linear_warmup(3e-5, warm, total),
            "constant": lambda m: m.constant_warmup(3e-5, warm),
            "inverse_sqrt": lambda m: m.inverse_sqrt(3e-5, warm)}[name]
    got, want = make(S), make(JS)
    for step in (0, warm - 1, warm, (warm + total) // 2, total):
        g, w = got(step), float(want(step))
        assert isinstance(g, float)
        assert abs(g - w) <= min(1e-7, 4 * F32_ULP * abs(w) + 1e-30), (step, g, w)


def test_schedules_from_config():
    p = CFG["model"]["params"]
    for key in ("lr_scheduler_config_g", "lr_scheduler_config_d"):
        got, want = S.from_config(p[key], 1e-4, 1000), JS.from_config(p[key], 1e-4, 1000)
        for step in (0, 99, 100, 550, 1000):
            assert abs(got(step) - float(want(step))) <= 4 * F32_ULP * abs(float(want(step)))
    assert S.from_config(None, 1e-4, 10)(500) == 1e-4


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """One step of JAX's ``VidTwinTrainer`` and of the port's on the same
    weights (the model's drawn in JAX's tree, whose shapes ``jax.eval_shape``
    of its ``init_state`` gives; the discriminator's JAX init), batch and
    LPIPS weights, f32 attention on both sides; then a second step of the
    port's."""
    from vidtok_tpu.models.vidtwin.trainer import VidTwinTrainer as JT
    from vidtok_tpu.parallel.mesh import make_mesh

    cfg = _cfg()
    lp = lpips_npz(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    x = (np.random.RandomState(0).randn(2, 4, 32, 32, 3) * 0.3).astype(np.float32)
    jt = JT(cfg, mesh=make_mesh(n_data=1), lpips_weights=lp, total_steps=1000)
    jt.model = f32_jax(cfg["model"])
    shapes = jax.eval_shape(jt.init_state, x)
    core = random_params(shapes.params_g["core"], 40)
    dvars = jax.device_get(jt.disc.init(jax.random.PRNGKey(41), x.reshape(-1, 32, 32, 3),
                                        train=False))
    disc, stats = dvars["params"], dvars["batch_stats"]
    params_g = {"core": core, "logvar": np.float32(0.0)}
    state = jax.tree_util.tree_map(jnp.asarray, shapes.replace(
        step=np.int32(0), params_g=params_g, params_d=disc, batch_stats_d=stats,
        opt_state_g=jt.opt_g.init(params_g), opt_state_d=jt.opt_d.init(disc),
        lecam_ema_real=np.float32(0.0), lecam_ema_fake=np.float32(0.0)))

    tt = VidTwinTrainer(cfg, device="cpu", lpips_weights=lp, total_steps=1000).init_state()
    tt.model.encoder.set_attn_dtype(None)
    tt.model.decoder.set_attn_dtype(None)
    tt.model.load_state_dict(to_torch(vidtwin_state_dict_from_jax(core)), strict=True)
    tt.disc.load_state_dict(to_torch(discriminator_state_dict_from_jax(disc, stats)))
    with torch.no_grad():
        tt.logvar.fill_(0.0)
    g0 = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    d0 = {n: p.detach().clone() for n, p in tt.disc.named_parameters()}

    state, jlogs = jt.fit_step(state, x, jax.random.PRNGKey(0))
    tlogs = tt.fit_step(torch.from_numpy(x))
    out = {"jlogs": {k: float(v) for k, v in jlogs.items()},
           "tlogs": {k: float(v) for k, v in tlogs.items()}, "g0": g0, "d0": d0}
    mu = jax.device_get(state.opt_state_g[1][0].mu)
    want = vidtwin_state_dict_from_jax(mu["core"])
    names = [n for n, _ in tt.model.named_parameters()]
    got = {n: tt.opt_g.state[p]["exp_avg"].numpy() for n, p in tt.model.named_parameters()}
    out["grad_g"] = rel(np.concatenate([got[n].ravel() for n in names]),
                        np.concatenate([want[n].ravel() for n in names]))
    out["grad_logvar"] = (float(tt.opt_g.state[tt.logvar]["exp_avg"]), float(mu["logvar"]))
    mud = discriminator_state_dict_from_jax(jax.device_get(state.opt_state_d[1][0].mu), None)
    dnames = [n for n, _ in tt.disc.named_parameters()]
    dp = dict(tt.disc.named_parameters())
    out["grad_d"] = rel(np.concatenate([tt.opt_d.state[dp[n]]["exp_avg"].numpy().ravel()
                                        for n in dnames]),
                        np.concatenate([mud[n].ravel() for n in dnames]))
    out["params_g"] = ({n: p.detach().clone() for n, p in tt.model.named_parameters()},
                       vidtwin_state_dict_from_jax(jax.device_get(state.params_g["core"])))
    out["params_d"] = ({n: p.detach().clone() for n, p in tt.disc.named_parameters()},
                       discriminator_state_dict_from_jax(jax.device_get(state.params_d), None))
    # step 1, where lr_g > 0: the generator's AdamW step held to JAX's
    state, jlogs1 = jt.fit_step(state, x, jax.random.PRNGKey(1))
    out["step1"] = {k: float(v) for k, v in tt.fit_step(torch.from_numpy(x)).items()}
    out["jstep1"] = {k: float(v) for k, v in jlogs1.items()}
    got1 = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    want1 = vidtwin_state_dict_from_jax(jax.device_get(state.params_g["core"]))
    out["params_g1"] = (got1, want1)
    out["upd_g1"] = rel(np.concatenate([(got1[n] - g0[n]).numpy().ravel() for n in names]),
                        np.concatenate([(want1[n] - g0[n].numpy()).ravel() for n in names]))
    out["logvar1"] = (float(tt.logvar.detach()), float(state.params_g["logvar"]))
    mu1 = vidtwin_state_dict_from_jax(jax.device_get(state.opt_state_g[1][0].mu)["core"])
    out["grad_g1"] = rel(np.concatenate([tt.opt_g.state[p]["exp_avg"].numpy().ravel()
                                         for p in tt.model.parameters()]),
                         np.concatenate([mu1[n].ravel() for n in names]))
    out["groups_g"] = [(g["lr"], g["betas"], g["weight_decay"], len(g["params"]))
                       for g in tt.opt_g.param_groups]
    out["n_params_g"] = len(names) + 1  # the model's and logvar
    return out


def test_first_step_logs(parity):
    j, t = parity["jlogs"], parity["tlogs"]
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert t["train/d_weight"] > 0


def test_first_step_gradients(parity):
    assert parity["grad_g"] <= 1e-4, parity["grad_g"]
    assert parity["grad_d"] <= 1e-4, parity["grad_d"]
    np.testing.assert_allclose(*parity["grad_logvar"], rtol=1e-4)


@pytest.mark.parametrize("part", ["generator", "discriminator"])
def test_params_after_step(parity, part):
    got, want = parity["params_g" if part == "generator" else "params_d"]
    start = parity["g0" if part == "generator" else "d0"]
    for n, p in got.items():
        assert rel(p.numpy(), want[n]) <= 1e-4, n
        if part == "generator":
            assert torch.equal(p, start[n]) and np.array_equal(want[n], start[n].numpy()), n
    if part == "discriminator":
        upd = [(got[n] - start[n]).numpy().ravel() for n in got]
        upd_j = [(want[n] - start[n].numpy()).ravel() for n in got]
        assert rel(np.concatenate(upd), np.concatenate(upd_j)) <= 0.1


def test_learning_rates(parity):
    assert parity["tlogs"]["train/lr_g"] == 0.0
    assert abs(parity["tlogs"]["train/lr_d"] - 1e-5) < 1e-12
    assert parity["step1"]["train/lr_g"] > 0
    # one AdamW over every generator parameter, logvar included, with the
    # config's betas and decoupled weight decay (optax.adamw, no mask)
    assert [g[1:] for g in parity["groups_g"]] == [((0.0, 0.9), 1e-4, parity["n_params_g"])]


def test_second_step_generator(parity):
    """Step 1 moves the generator (lr_g 3e-7): its logs, its clipped
    gradient, its parameters (1e-4 relative L2 per tensor), its whole
    update and logvar (0 at the start, so its value is its update) held to
    a second step of JAX's trainer."""
    j, t = parity["jstep1"], parity["step1"]
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert parity["grad_g1"] <= 1e-4, parity["grad_g1"]
    got, want = parity["params_g1"]
    for n, p in got.items():
        assert rel(p.numpy(), want[n]) <= 1e-4, n
    assert parity["upd_g1"] <= UPD_G1, parity["upd_g1"]
    np.testing.assert_allclose(*parity["logvar1"], rtol=1e-4)
    assert parity["logvar1"][0] != 0.0
