"""The resblocks' dropout in the PyTorch port (fp32, CPU).

* Serving a model whose config sets ``dropout`` 0.1 equals JAX's
  ``deterministic`` forward (rtol 1e-4, atol 2e-4), with the port's kernel
  wrappers on (their plain versions here) and off: dropout is the identity
  there, and the port keeps its kernels where JAX declines its Pallas
  ones.
* ``forward_train``: the input of every resblock's ``conv2`` is the
  activation the block would give without dropout, each value zeroed or
  scaled by exactly 1 / (1 - p), the zeroed share within 5 binomial
  standard deviations of p in every block; equal generator states give
  equal masks, other seeds other ones.
* ``use_checkpoint`` with dropout raises, as JAX asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_v1_0 import CFG, close, load_jax_params, random_params
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.models.autoencoder import build_core_from_config
from vidtok_tpu_torch.modules.blocks import (ResnetBlock3D, ResnetBlockSpatial,
                                             ResnetBlockTemporal)
from vidtok_tpu_torch.modules.norms import silu
from vidtok_tpu_torch.ops import kernels as K

torch.set_num_threads(2)
P = 0.1
BLOCKS = (ResnetBlockSpatial, ResnetBlockTemporal, ResnetBlock3D)


def dropout_cfg(p=P, **extra):
    enc, dec = (dict(CFG["params"][k]["params"], dropout=p, **extra)
                for k in ("encoder_config", "decoder_config"))
    return {"params": dict(
        CFG["params"],
        encoder_config=dict(CFG["params"]["encoder_config"], params=enc),
        decoder_config=dict(CFG["params"]["decoder_config"], params=dec))}


@pytest.fixture(scope="module")
def model():
    """JAX's tiny v1.0 KL model with dropout, random params, a clip."""
    core, _ = j_build(dropout_cfg())
    x = np.clip(np.random.RandomState(30).randn(1, 3, 5, 32, 32) * 0.5, -1, 1)
    x = x.astype(np.float32)
    return core, random_params(core, x.transpose(0, 2, 3, 4, 1), seed=31), x


@pytest.mark.parametrize("fused", [False, True])
def test_serving_ignores_dropout(model, fused):
    core, params, x = model
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    zj, dj, _ = jax.jit(lambda p, v: core.apply(
        {"params": p}, v, sample_override=False))(params, xt)
    tok = load_model_from_config({"model": dropout_cfg()}, device="cpu", fused=fused)
    load_jax_params(tok.core, params)
    blocks = [m for m in tok.core.modules() if isinstance(m, BLOCKS)]
    assert blocks and all(m.dropout == P for m in blocks)
    K.reset_counts()
    z, dec, _ = tok(x)
    calls = K.counts("calls")
    assert (calls["fused_spatial_resblock"] > 0 and calls["fused_temporal_resblock"] > 0) \
        == fused
    close(z, np.asarray(zj).transpose(0, 4, 1, 2, 3))
    close(dec, np.asarray(dj).transpose(0, 4, 1, 2, 3))


def _conv2_inputs(core, x, seed):
    """forward_train with a generator of ``seed``: (per resblock, (the
    activation before dropout, ``conv2``'s input)), z, x_rec."""
    seen, hooks = {}, []
    for m in core.modules():
        if isinstance(m, BLOCKS):
            hooks.append(m.register_forward_pre_hook(
                lambda blk, args: seen.setdefault(blk, {}).update(x=args[0])))
            hooks.append(m.conv2.register_forward_pre_hook(
                lambda conv, args, blk=m: seen.setdefault(blk, {}).update(a=args[0])))
    try:
        with torch.no_grad():
            z, dec, _, _ = core.forward_train(torch.from_numpy(x),
                                              generator=torch.Generator().manual_seed(seed))
            pairs = [(silu(blk.norm2(blk.conv1(silu(blk.norm1(d["x"]))))), d["a"])
                     for blk, d in seen.items()]
    finally:
        for h in hooks:
            h.remove()
    return pairs, z, dec


def test_train_dropout_masks(model):
    _, params, x = model
    core = build_core_from_config(dropout_cfg())[0]
    load_jax_params(core, params)
    xt = x.transpose(0, 2, 3, 4, 1).copy()
    pairs, z, dec = _conv2_inputs(core, xt, seed=0)
    assert len(pairs) == sum(isinstance(m, BLOCKS) for m in core.modules())
    for ref, got in pairs:
        kept = got != 0
        np.testing.assert_array_equal(got[kept].numpy(), (ref / (1 - P))[kept].numpy())
        share = 1 - float(kept.float().mean())
        n = got.numel()
        assert abs(share - P) < 5 * np.sqrt(P * (1 - P) / n), (share, n)
    # equal generator states, equal masks; another seed, other ones
    _, z2, dec2 = _conv2_inputs(core, xt, seed=0)
    _, z3, dec3 = _conv2_inputs(core, xt, seed=1)
    assert torch.equal(z, z2) and torch.equal(dec, dec2)
    assert not torch.equal(dec, dec3)
    # without dropout the training forward is the serving one
    plain = build_core_from_config(dropout_cfg(0.0))[0]
    load_jax_params(plain, params)
    with torch.no_grad():
        _, d0, _, _ = plain.forward_train(torch.from_numpy(xt),
                                          generator=torch.Generator().manual_seed(0))
        _, d1, _ = plain(torch.from_numpy(xt), sample=True,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(d0, d1)
    assert not torch.allclose(dec, d0, atol=1e-3)


@pytest.mark.parametrize("where", ["config", "override"])
def test_checkpointing_refuses_dropout(where):
    if where == "config":
        with pytest.raises(ValueError, match="use_checkpoint requires dropout=0"):
            build_core_from_config(dropout_cfg(use_checkpoint=True))
    else:
        with pytest.raises(ValueError, match="use_checkpoint requires dropout=0"):
            build_core_from_config(dropout_cfg(), use_checkpoint=True)
        build_core_from_config(dropout_cfg(), use_checkpoint=False)
