"""The port's training pieces against ``vidtok_tpu``, each alone (fp32):

* FSQ's gradient with respect to z (the straight-through rounding, the
  entropy and commitment losses, a weighted sum of the codes) equal to
  ``jax.grad`` of JAX's ``FSQRegularizer``: rtol 1e-4, atol 1e-6; also
  under entropy-weight annealing. The codes carry the gradient straight
  through (a zero gradient would mean ``round`` without the estimator).
* The discriminators (2D, 3D; BatchNorm and ActNorm) in train mode: logits
  within rtol 1e-4, atol 1e-5 of JAX's on converted weights; BatchNorm's
  running mean equal to flax's (atol 1e-6), its running variance equal
  after torch's unbiased factor n / (n - 1) (rtol 1e-5); ActNorm's
  data-dependent init equal to flax's.
* The EMA update and Adam after a global-norm clip (norm above and below
  20) against JAX's ``ema_update`` and optax, over 3 steps: rtol 1e-5,
  atol 1e-7. The clip differs by torch's +1e-6 in the norm's divisor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train_common import to_torch
from vidtok_tpu.modules import discriminator as JD
from vidtok_tpu.modules.regularizers import FSQRegularizer as JFSQ
from vidtok_tpu.train.state import ema_update as j_ema_update
from vidtok_tpu.train.state import make_optimizer as j_make_optimizer
from vidtok_tpu_torch.convert import discriminator_state_dict_from_jax
from vidtok_tpu_torch.modules import discriminator as TD
from vidtok_tpu_torch.modules.regularizers import FSQRegularizer as TFSQ
from vidtok_tpu_torch.train.state import ema_update, make_optimizer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_steps", [0, 700])
def test_fsq_gradient(n_steps):
    kw = dict(levels=(8, 5, 5, 5), entropy_loss_weight=0.1,
              entropy_loss_annealing_steps=2000, entropy_loss_annealing_factor=3.0,
              commitment_loss_weight=0.25)
    rng = np.random.RandomState(0)
    z = (rng.randn(2, 3, 4, 4, 4) * 1.5).astype(np.float32)
    w = rng.randn(2, 3, 4, 4, 4).astype(np.float32)
    jm = JFSQ(**kw)

    def jloss(zz):
        codes, log = jm.apply({}, zz, n_steps=n_steps)
        return log["aux_loss"] + jnp.sum(codes * w), log["aux_loss"]

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(z))
    tm = TFSQ(**{k: v for k, v in kw.items()})
    zt = torch.from_numpy(z).requires_grad_(True)
    codes, log = tm(zt, n_steps=n_steps)
    loss = log["aux_loss"] + (codes * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(log["aux_loss"].detach()), float(jaux), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), **TOL)
    # the codes alone: the straight-through gradient, bound'(z) / half width
    zt.grad = None
    tm(zt)[0].sum().backward()
    assert (zt.grad.abs() > 0).all()


DISCS = [("2d", False), ("3d", False), ("2d", True), ("3d", True)]


@pytest.mark.parametrize("kind,actnorm", DISCS, ids=[f"{k}-{'act' if a else 'bn'}"
                                                     for k, a in DISCS])
def test_discriminator(kind, actnorm):
    rng = np.random.RandomState(1)
    shape = (6, 32, 32, 3) if kind == "2d" else (2, 5, 32, 32, 3)
    x = (rng.randn(*shape) * 0.5).astype(np.float32)
    jcls = JD.NLayerDiscriminator if kind == "2d" else JD.NLayerDiscriminator3D
    jd = jcls(input_nc=3, n_layers=3, use_actnorm=actnorm)
    v = jd.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    # random non-trivial parameters (ActNorm's init is compared below)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05 + (a == 1)), v["params"])
    tcls = TD.NLayerDiscriminator if kind == "2d" else TD.NLayerDiscriminator3D
    td = tcls(input_nc=3, n_layers=3, use_actnorm=actnorm).train()
    x_t = torch.from_numpy(x.transpose((0, 3, 1, 2) if kind == "2d" else (0, 4, 1, 2, 3)))
    if actnorm:
        # data-dependent init: flax at .init (``v``), the port at its first
        # training forward, on the same convs and batch
        td.load_state_dict(to_torch(discriminator_state_dict_from_jax(v["params"])))
        for m in td.modules():
            if isinstance(m, TD.ActNorm):
                m.initialized.zero_()
        td(x_t)
        sd = {k: a.numpy() for k, a in td.state_dict().items()}
        ref = discriminator_state_dict_from_jax(v["params"])
        names = [k for k in ref if k.endswith(("loc", "scale"))]
        assert len(names) == 6
        for k in names:
            np.testing.assert_allclose(sd[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    td.load_state_dict(to_torch(discriminator_state_dict_from_jax(
        params, v.get("batch_stats"))))
    want, upd = jd.apply({"params": params, **({"batch_stats": v["batch_stats"]}
                                               if "batch_stats" in v else {})},
                         jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = td(x_t)
    perm = (0, 2, 3, 1) if kind == "2d" else (0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy().transpose(perm), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    if actnorm:
        return
    # BatchNorm statistics after one training forward: flax's momentum 0.9
    # is torch's 0.1; torch's running variance takes the unbiased variance
    bn = {k: v for k, v in discriminator_state_dict_from_jax(
        params, upd["batch_stats"]).items() if "running" in k}
    convs = [m for m in td.main if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    h = x_t
    for i, m in enumerate(td.main):
        if isinstance(m, TD.GlobalBatchNorm):
            n = h.numel() // h.shape[1]
            mean = np.asarray(bn[f"main.{i}.running_mean"])
            np.testing.assert_allclose(m.running_mean.numpy(), mean, atol=1e-6)
            # flax: 0.9 * 1 + 0.1 * biased; torch: 0.9 * 1 + 0.1 * unbiased
            biased = (np.asarray(bn[f"main.{i}.running_var"]) - 0.9) / 0.1
            np.testing.assert_allclose(m.running_var.numpy(), 0.9 + 0.1 * biased * n / (n - 1),
                                       rtol=1e-5)
        h = m(h)
    assert len(convs) == 5


@pytest.mark.parametrize("scale", [0.01, 30.0], ids=["unclipped", "clipped"])
def test_optimizer_and_ema(scale):
    rng = np.random.RandomState(3)
    shapes = {"a": (4, 5), "b": (7,), "c": ()}
    params = {k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.randn(*s) * scale, np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    opt = j_make_optimizer(1e-3, 20.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = opt.init(jp)
    jema = jax.tree_util.tree_map(jnp.array, jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in shapes]
    topt = make_optimizer(tp, 1e-3)
    tema = [p.detach().clone() for p in tp]
    for step, g in enumerate(grads):
        upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        jema = j_ema_update(jema, jp, jnp.int32(step), 0.999)
        for p, k in zip(tp, shapes):
            p.grad = torch.from_numpy(g[k].copy())
        norm = torch.nn.utils.clip_grad_norm_(tp, 20.0)
        assert (float(norm) > 20.0) == (scale > 1)
        topt.step()
        ema_update(tema, tp, step, 0.999)
        for i, k in enumerate(shapes):
            np.testing.assert_allclose(tp[i].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(tema[i].numpy(), np.asarray(jema[k]),
                                       rtol=1e-5, atol=1e-7)
