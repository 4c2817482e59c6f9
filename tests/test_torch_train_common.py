"""What the port's training tests share (no tests here): the tiny config
of ``tests/test_train.py`` (``ch`` 32, ``ch_mult`` [1, 2], ``tdf`` 2, one
resblock, layernorm) with a chosen bottleneck and loss, random LPIPS
weights in JAX's file layout, and a JAX ``VidTokTrainer`` with a port
``VidTokTrainer`` holding the same weights.
"""

import numpy as np
import torch

P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 32,
     "ch_mult": [1, 2], "time_downsample_factor": 2, "num_res_blocks": 1,
     "norm_type": "layernorm", "tempo_ds": [0], "tempo_us": [1]}
FSQ = {"target": "FSQRegularizer", "params": {
    "levels": [8, 5, 5, 5], "entropy_loss_weight": 0.1,
    "entropy_loss_annealing_steps": 2000, "entropy_loss_annealing_factor": 3,
    "commitment_loss_weight": 0.25}}
KL = {"target": "DiagonalGaussianRegularizer", "params": {"sample": False}}
# the loss cases of tests/test_train.py:90-101 at disc_start 0
LOSS = {
    "2d": dict(disc_start=0, disc_weight=0.2, disc_type="2d", learn_logvar=True,
               gen_loss_cross_entropy=True, lecam_loss_weight=0.005, disc_loss="hinge",
               logvar_init=0.3, perceptual_weight=1.0,
               regularization_weights={"kl_loss": 1e-4, "aux_loss": 1.0}),
    "3d": dict(disc_start=0, disc_weight=0.7, disc_type="3d", learn_logvar=False,
               gen_loss_cross_entropy=False, lecam_loss_weight=0.0, disc_loss="vanilla",
               logvar_init=0.0, perceptual_weight=1.0,
               regularization_weights={"kl_loss": 1e-4, "aux_loss": 1.0}),
}


def config(reg="kl", loss="2d", lr=1e-4, ema=0.999, use_checkpoint=False, **loss_over):
    p = dict(P, double_z=reg == "kl")
    return {"model": {"base_learning_rate": lr, "params": {
        "encoder_config": {"target": "EncoderCausal3D", "params": dict(p)},
        "decoder_config": {"target": "DecoderCausal3D", "params": dict(p)},
        "regularizer_config": KL if reg == "kl" else FSQ,
        "loss_config": {"target": "GeneralLPIPSWithDiscriminator",
                        "params": dict(LOSS[loss], dims=3, **loss_over)},
        "ema_decay": ema}},
        "training": {"use_checkpoint": use_checkpoint}}


def lpips_npz(path):
    """JAX's random LPIPS parameters (``init_lpips_params``) written as
    ``tools/convert_lpips.py``'s flat ``.npz``; returns the path."""
    import jax

    from vidtok_tpu.modules.lpips import init_lpips_params

    params = init_lpips_params(jax.random.PRNGKey(3))
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(str(path), **flat)
    return str(path)


def clip(seed=0, shape=(2, 5, 32, 32, 3), scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def to_torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def port_like(cfg, lpips, jstate, n_layers=3):
    """A port trainer on the CPU holding ``jstate``'s weights (core,
    logvar, discriminator with its statistics), its EMA copies equal."""
    import jax

    from vidtok_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
    from vidtok_tpu_torch.train.trainer import VidTokTrainer
    from vidtok_tpu_torch.utils.checkpoint import load_into

    tt = VidTokTrainer(cfg, device="cpu", lpips_weights=lpips).init_state()
    state = jax.device_get(jstate)
    load_into(tt.core, to_torch(state_dict_from_jax(state.params_g["core"])))
    tt.disc.load_state_dict(to_torch(discriminator_state_dict_from_jax(
        state.params_d, state.batch_stats_d, n_layers)))
    with torch.no_grad():
        tt.logvar.fill_(float(state.params_g["logvar"]))
    if tt.ema is not None:
        tt.ema["core"].load_state_dict(tt.core.state_dict())
        tt.ema["disc"].load_state_dict(tt.disc.state_dict())
        tt.ema["logvar"].fill_(float(tt.logvar.detach()))
    return tt


def rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def fit_step_parity(cfg, lpips, x, steps=3):
    """Run ``steps`` steps of JAX's ``VidTokTrainer.fit_step`` (one mesh
    device) and of the port's on the same weights and clip. Returns the
    measurements the tests bound: the relative L2 of the first step's
    clipped gradients (read from each Adam's first moment, 0.1 x the
    clipped gradient after one step; generator and discriminator), the
    first step's logs of both, the largest parameter difference after
    ``steps`` steps, the relative L2 of the two runs' total parameter
    updates, the discriminator's BatchNorm statistics and the learning
    rate."""
    import jax

    from vidtok_tpu.parallel.mesh import make_mesh
    from vidtok_tpu.train.trainer import VidTokTrainer as JT
    from vidtok_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax

    jt = JT(cfg, mesh=make_mesh(n_data=1), lpips_weights=lpips)
    state = jt.init_state(x)
    tt = port_like(cfg, lpips, state)
    p0 = {n: p.detach().clone().numpy() for n, p in tt.core.named_parameters()}
    out = {"lr": jt.lr}
    for step in range(steps):
        state, jlogs = jt.fit_step(state, x, jax.random.PRNGKey(step))
        tlogs = tt.fit_step(torch.from_numpy(x))
        if step == 0:
            mu = jax.device_get(state.opt_state_g[1][0].mu)
            want = state_dict_from_jax(mu["core"])
            names = [n for n, _ in tt.core.named_parameters()]
            got = dict(zip(names, (tt.opt_g.state[p]["exp_avg"].numpy()
                                   for _, p in tt.core.named_parameters())))
            out["grad_g"] = rel(np.concatenate([got[n].ravel() for n in names]),
                                np.concatenate([want[n].ravel() for n in names]))
            out["grad_logvar"] = (float(tt.opt_g.state[tt.logvar]["exp_avg"])
                                  if tt.logvar in tt.opt_g.state else 0.0,
                                  float(mu["logvar"]))
            mud = discriminator_state_dict_from_jax(
                jax.device_get(state.opt_state_d[1][0].mu), None)
            names = [n for n, _ in tt.disc.named_parameters()]
            got = dict(tt.disc.named_parameters())
            out["grad_d"] = rel(np.concatenate([tt.opt_d.state[got[n]]["exp_avg"].numpy().ravel()
                                                for n in names]),
                                np.concatenate([mud[n].ravel() for n in names]))
            out["logs"] = ({k: float(v) for k, v in jlogs.items()},
                           {k: float(v) for k, v in tlogs.items()})
    pj = state_dict_from_jax(jax.device_get(state.params_g["core"]))
    names = list(p0)
    pt = {n: p.detach().numpy() for n, p in tt.core.named_parameters()}
    out["param_max_abs"] = max(float(np.abs(pt[n] - pj[n]).max()) for n in names)
    out["update_rel"] = rel(np.concatenate([(pt[n] - p0[n]).ravel() for n in names]),
                            np.concatenate([(pj[n] - p0[n]).ravel() for n in names]))
    out["disc_stats"] = (
        {k: v.numpy() for k, v in tt.disc.state_dict().items() if "running" in k},
        discriminator_state_dict_from_jax(jax.device_get(state.params_d),
                                          jax.device_get(state.batch_stats_d)))
    return out
