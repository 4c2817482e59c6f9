"""The port's VidTwin ablation ladder against ``vidtok_tpu``'s on the CPU:
the Sym and SymDis targets (``test_torch_vidtwin_ablations.py`` has the
others, and the shared size, cases and tolerance); rtol 1e-4, atol 2e-4:

* each target's forward against JAX's with ``return_features`` (z, the
  reconstruction, the decoder's final-layer input, both latents,
  ``kl_loss`` 0): Sym with
  ``retain_num_frames`` both ways, SymDis at ``shuffle_content_ratio`` 0
  (z is the encoder's over the clip and its copy, ``[2B, ...]``);
* ``decode`` with ``only_part`` content and motion (Sym);
* JAX's ``convert_vidtwin_ablation_state_dict`` of the port's state dict
  is JAX's tree leaf for leaf;
* SymDis at ratio 1, on Sym's weights: the encoder sees the clip and,
  behind it, each sample's frames in the permutation drawn from the
  generator (gates first, then the permutations); the motion latent is the
  unshuffled Sym's, the content latent Sym's content pathway on the
  shuffled clip's tokens; on a clip of one repeated frame the forward
  equals JAX's Sym (JAX's ``test_symdis_shuffles_content_only``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vidtwin import clip, ncthw
from tests.test_torch_vidtwin_ablations_common import (SYM, check_forward, check_only_part,
                                                      check_state_dict, close, model_cfg,
                                                      pair, port)

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["sym", "sym_alt", "symdis"])
def test_forward(case):
    check_forward(case)


@pytest.mark.parametrize("part", ["content", "motion"])
def test_only_part(part):
    check_only_part("sym", part)


@pytest.mark.parametrize("case", ["sym", "sym_alt", "symdis"])
def test_state_dict_to_jax(case):
    check_state_dict(case)


def test_symdis_shuffles_content_only():
    _, p, fn, _ = pair("sym")
    tm = port(model_cfg("VidAutoEncoderQformerCompactSymDis", **dict(
        SYM, shuffle_content_ratio=1.0)), p)
    assert tm.dis and tm.shuffle_ratio == 1.0
    x = torch.from_numpy(ncthw(clip(63)))
    seen = []
    hook = tm.encoder.register_forward_hook(lambda m, a, o: seen.append((a[0], o)))
    with torch.no_grad():
        z2, u_c, u_m, _ = tm.encode(x, generator=torch.Generator().manual_seed(4))
        hook.remove()
        g = torch.Generator().manual_seed(4)
        gates = torch.rand((2,), generator=g) < 1.0
        perms = torch.rand((2, 4), generator=g).argsort(1)
        xin, z_all = seen[0]
        assert gates.all() and torch.equal(z_all, z2) and z2.shape[0] == 4
        assert not torch.equal(perms, torch.arange(4).expand(2, 4))
        torch.testing.assert_close(xin[:2], x, rtol=0, atol=0)
        for i in range(2):
            torch.testing.assert_close(xin[2 + i], x[i][:, perms[i]], rtol=0, atol=0)
        tm.dis = False
        _, u_c_sym, u_m_sym, _ = tm.encode(x)
        torch.testing.assert_close(u_m, u_m_sym, rtol=0, atol=0)
        assert not torch.allclose(u_c, u_c_sym, atol=1e-3)
        torch.testing.assert_close(u_c, tm.content_tokens(z2[2:].permute(0, 2, 3, 4, 1)),
                                   rtol=0, atol=0)
        tm.dis = True
        # one repeated frame: shuffling changes nothing, SymDis is Sym
        frame = np.random.RandomState(0).randn(1, 1, 32, 32, 3)
        xc = np.repeat(frame, 2, axis=0).repeat(4, axis=1).astype(np.float32)
        _, dec, _, (u_c, u_m) = tm(torch.from_numpy(ncthw(xc)),
                                   generator=torch.Generator().manual_seed(1))
    _, dec_j, _, _, (u_c_j, u_m_j) = fn(p, jnp.asarray(xc))
    close(u_c, u_c_j, "content")
    close(u_m, u_m_j, "motion")
    close(dec, ncthw(dec_j), "reconstruction")
