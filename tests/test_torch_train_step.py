"""One whole GAN step of the port's trainer against ``vidtok_tpu``'s
``VidTokTrainer.fit_step`` (one mesh device, fp32, the regularizer's mode:
``sample: false``), on the tiny KL model with the 2D discriminator, hinge
loss, LeCAM, the non-saturating generator loss, a learned log-variance
and activation checkpointing on (``training.use_checkpoint``).

* The first step's clipped gradients (each Adam's first moment), over the
  whole generator and discriminator: relative L2 <= 1e-4.
* The first step's logs: the same keys, each within rtol 1e-4 (atol 1e-6).
* After 3 steps: every parameter within 4 x lr of JAX's. After one Adam
  step a parameter moves by about lr x sign(g), so a gradient near zero
  that the frameworks round to opposite signs moves it 2 x lr apart; the
  total updates of the two runs agree to a relative L2 of 0.1 (the
  sign flips are few).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_train_common import clip, config, fit_step_parity, lpips_npz

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    lp = lpips_npz(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    return fit_step_parity(config("kl", "2d", use_checkpoint=True), lp, clip())


def test_first_step_gradients(parity):
    assert parity["grad_g"] <= 1e-4, parity["grad_g"]
    assert parity["grad_d"] <= 1e-4, parity["grad_d"]
    got, want = parity["grad_logvar"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_first_step_logs(parity):
    jlogs, tlogs = parity["logs"]
    assert set(jlogs) == set(tlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k], jlogs[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert tlogs["train/d_weight"] > 0


def test_params_after_three_steps(parity):
    assert parity["param_max_abs"] <= 4 * parity["lr"], parity["param_max_abs"]
    assert parity["update_rel"] <= 0.1, parity["update_rel"]
