"""The port's VidTwin ablation ladder (``vidtok_tpu_torch/models/vidtwin/
ablations.py``) against ``vidtok_tpu``'s on the CPU: the Qformer and
Compact targets (Sym and SymDis in ``test_torch_vidtwin_ablations_sym.py``,
the trainer in ``test_torch_vidtwin_ablations_train.py``; the three split
so that each runs within a minute), at ``tests/test_vidtwin_ablations.py``'s
size with JAX's weights drawn from a seed
(``test_torch_vidtwin_ablations_common.py``); rtol 1e-4, atol 2e-4:

* each target's forward against JAX's with ``return_features``: z, the
  reconstruction, the decoder's final-layer input (the port's read by a
  hook on ``decoder.final_layer.linear``) and every latent, ``kl_loss``
  0; the
  Qformer, Compact as configured by default and with
  ``retain_num_frames=False, repeat_for_decoder=True``;
* ``decode`` with ``only_part`` content and motion (Compact);
* weights: JAX's ``convert_vidtwin_ablation_state_dict`` of the port's
  state dict is JAX's tree leaf for leaf (plus the unused
  ``up_channel_temp`` the reference builds under ``repeat_for_decoder``,
  which JAX's test tolerates too); a reference-named ``.ckpt`` with the
  keys the reader drops (the widened ``DROPPED``: every Q-Former's text
  FFN) and JAX's ``.npz`` load strictly through the engine and give
  JAX's reconstruction.
"""

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_vidtwin import clip, ncthw
from tests.test_torch_vidtwin_ablations_common import (CASES, check_forward,
                                                      check_only_part, check_state_dict,
                                                      close, model_cfg, pair)
from vidtok_tpu.utils.checkpoint import save_params
from vidtok_tpu_torch.models.vidtwin.convert import DROPPED
from vidtok_tpu_torch.models.vidtwin.engine import VidTwinTokenizer

torch.set_num_threads(2)
HERE = ("qformer", "compact", "compact_alt")


@pytest.mark.parametrize("case", HERE)
def test_forward(case):
    check_forward(case)


@pytest.mark.parametrize("part", ["content", "motion"])
def test_only_part(part):
    check_only_part("compact", part)


@pytest.mark.parametrize("case", HERE)
def test_state_dict_to_jax(case):
    check_state_dict(case)


@pytest.mark.parametrize("fmt", ["ckpt", "npz"])
@pytest.mark.parametrize("case", ["qformer", "compact_alt"])
def test_checkpoint_sources(case, fmt, tmp_path):
    """The Qformer (``hight_qformer``) and the Compact with the unused
    ``up_channel_temp``, which JAX's ``.npz`` lacks: the load keeps the
    port's."""
    jm, p, fn, tm = pair(case)
    target, params = CASES[case]
    cfg = {"model": model_cfg(target, **params)}
    if fmt == "ckpt":
        path = tmp_path / "m.ckpt"
        extra = {"loss.logvar": torch.zeros(()), "model_ema.decay": torch.ones(()),
                 "encoder.pos_embed": torch.zeros(1, 16, 64),
                 "encoder.final_layer.linear.weight": torch.zeros(192, 64)}
        for root in ("temporal_qformer", "hight_qformer", "width_qformer", "space_qformer"):
            if hasattr(tm, root):
                extra[f"{root}.qformer.encoder.layer.0.intermediate.dense.weight"] = \
                    torch.zeros(32, 32)
                extra[f"{root}.qformer.encoder.layer.1.output.LayerNorm.bias"] = torch.zeros(32)
        assert all(DROPPED.search(k) for k in extra)
        torch.save({"state_dict": {**tm.state_dict(), **extra}}, path)
    else:
        path = tmp_path / "m.npz"
        save_params(str(path), p)
    tok = VidTwinTokenizer.from_config(cfg, ckpt=str(path), device="cpu")
    for k, v in tm.state_dict().items():
        if fmt == "ckpt" or not k.startswith("up_channel_temp"):
            assert torch.equal(tok.model.state_dict()[k], v), k
    tok.model.encoder.set_attn_dtype(None)
    tok.model.decoder.set_attn_dtype(None)
    x = clip(64)
    _, dec, _, _, _ = fn(p, jnp.asarray(x))
    close(tok(ncthw(x))[1], ncthw(dec), "reconstruction")
    with pytest.raises(TypeError, match="serves forward only"):
        tok.encode(ncthw(x))
