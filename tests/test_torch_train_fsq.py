"""One whole GAN step of the port's trainer against ``vidtok_tpu``'s
``VidTokTrainer.fit_step`` on the tiny FSQ model (straight-through
rounding, entropy and commitment losses) with the 3D discriminator and
the vanilla loss (fp32, one mesh device), the case of
``tests/test_train.py:90-101`` that ``test_torch_train_step.py`` does not
run.

The 3D discriminator's gradient is sensitive to f32 rounding in both
frameworks: a LeakyReLU input within rounding of 0 takes the other slope
in one of them, and that one element moves the discriminator's small
input gradient, hence ``d_weight`` and the generator's GAN gradient
(float64 shows the flipped element; learn_logvar is off here). So the
bounds are looser than the 2D case's: the first step's clipped gradients
within relative L2 2e-3 (generator) and 2e-3 (discriminator), the logs
within rtol 1e-3 (atol 1e-6), and after 3 steps the total updates of the
two runs within relative L2 0.2 and every parameter within 6 x lr (the
most three Adam steps of about lr each can put two runs apart, so this
last bound only catches a parameter that moved far off).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_train_common import clip, config, fit_step_parity, lpips_npz

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    lp = lpips_npz(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    return fit_step_parity(config("fsq", "3d"), lp, clip())


def test_first_step_gradients(parity):
    assert parity["grad_g"] <= 2e-3, parity["grad_g"]
    assert parity["grad_d"] <= 2e-3, parity["grad_d"]
    assert parity["grad_logvar"] == (0.0, 0.0)  # learn_logvar off


def test_first_step_logs(parity):
    jlogs, tlogs = parity["logs"]
    assert set(jlogs) == set(tlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k], jlogs[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert tlogs["train/aux_loss"] != 0 and tlogs["train/d_weight"] > 0


def test_params_after_three_steps(parity):
    assert parity["update_rel"] <= 0.2, parity["update_rel"]
    assert parity["param_max_abs"] <= 6 * parity["lr"], parity["param_max_abs"]
