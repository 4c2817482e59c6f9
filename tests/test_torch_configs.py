"""Every tokenizer config of the repo in the PyTorch port, against
``vidtok_tpu``.

* All 23 VidTok configs under ``configs/`` (VidTwin aside) at full width:
  the port builds each (on the meta device, no memory) with JAX's
  parameter tree, leaf for leaf (``jax.eval_shape`` of the JAX init, so no
  158M-parameter init runs), and its meta says the variant.
* One tiny-width forward per distinct shape family, the config's own
  topology at ``ch`` 16 and one resblock a level: 288 (``tdf`` 2), 444
  (``spatial_ds`` / ``spatial_us``), 41616 (a fifth level), 888 (``tdf`` 8;
  FSQ with 5 levels), the v1.1 41616 FSQ 262144 (6 levels); FSQ losses on. The port (``fused`` off)
  against JAX at 2e-4; the v1.1 families also tiled, with overlap, against
  JAX's tiled engine; 41616 and 888 also with ``fused`` on (the wrappers'
  plain versions on the CPU) against JAX with ``fused`` on (Pallas in
  interpret mode).
"""

import copy
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from vidtok_tpu.models.autoencoder import VideoTokenizer as JTok
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.utils.checkpoint import convert_torch_state_dict
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.config import load_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.models.autoencoder import build_core_from_config
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.utils.checkpoint import load_into

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=2e-4)
CONFIGS = sorted(os.path.relpath(p, os.path.join(ROOT, "configs")) for p in
                 glob.glob(os.path.join(ROOT, "configs", "*.yaml"))
                 + glob.glob(os.path.join(ROOT, "configs", "v1_1", "*.yaml")))


def model_section(name):
    return load_config(os.path.join(ROOT, "configs", name))["model"]


def leaves(tree):
    return {jax.tree_util.keystr(k): tuple(np.shape(v))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_every_config_listed():
    assert len(CONFIGS) == 23


@pytest.mark.parametrize("name", CONFIGS)
def test_full_width_config(name):
    cfg = model_section(name)
    with torch.device("meta"):
        core, meta = build_core_from_config(cfg)
    want = ("noncausal" if "noncausal" in name else
            "causal_v1_1" if "v1_1" in name else "causal")
    assert meta["variant"] == want and meta["is_causal"] == (want != "noncausal")
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, v.shape) for k, v in core.state_dict().items()}
    jcore, _ = j_build(cfg)
    shapes = jax.eval_shape(lambda: jcore.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((1, 16, 32, 32, 3)), sample_override=False))
    ref = leaves(shapes["params"])
    assert leaves(convert_torch_state_dict(sd)) == ref
    assert sum(p.numel() for p in core.parameters()) == sum(
        int(np.prod(s)) for s in ref.values())


# family -> (config, clip [B, C, T, H, W], t_chunk_enc of the tiled run (v1.1)
# or None (v1.0 does not tile), fused run too). 888 is the FSQ family with 5
# levels, fsq6 the one with 6.
FAMILIES = {
    "288": ("v1_1/vidtok_kl_causal_288_8chn_v1_1.yaml", (1, 3, 9, 16, 16), 4, False),
    "444": ("vidtok_kl_causal_444_4chn.yaml", (1, 3, 9, 16, 16), None, False),
    "41616": ("vidtok_kl_causal_41616_4chn.yaml", (1, 3, 9, 32, 32), None, True),
    "888": ("v1_1/vidtok_fsq_causal_888_32768_v1_1.yaml", (1, 3, 33, 16, 16), 16, True),
    "fsq6": ("v1_1/vidtok_fsq_causal_41616_262144_v1_1.yaml", (1, 3, 9, 32, 32), 8,
             False),
}


def tiny_section(cfg, **over):
    """A model section at ``ch`` 16 (and ``over``)."""
    cfg = copy.deepcopy(cfg)
    for part in ("encoder_config", "decoder_config"):
        cfg["params"][part]["params"].update(ch=16, **over)
    return cfg


def tiny(name):
    """The config's model section at ``ch`` 16, one resblock a level."""
    return tiny_section(model_section(name), num_res_blocks=1)


def randomize(tree, rng):
    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.08 * r

    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def family(fam):
    """(JAX core, meta, random params, the port's model section, clip)."""
    name, shape, _, _ = FAMILIES[fam]
    cfg = tiny(name)
    core, meta = j_build(cfg)
    x = np.clip(np.random.RandomState(1).randn(*shape) * 0.5, -1, 1).astype(np.float32)
    v = jax.eval_shape(lambda: core.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)), sample_override=False))
    params = randomize(v["params"], np.random.RandomState(2))
    return core, meta, params, cfg, x


def port_tok(cfg, params, fused=False):
    tok = load_model_from_config({"model": cfg}, device="cpu", fused=fused)
    load_into(tok.core, {k: torch.from_numpy(np.array(a))
                         for k, a in state_dict_from_jax(params).items()})
    return tok


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def check(out, jout, discrete):
    (z, dec, log), (jz, jdec, jlog) = out, jout
    close(z, jz)
    close(dec, jdec)
    loss = "aux_loss" if discrete else "kl_loss"
    close(float(log[loss]), float(jlog[loss]))
    if discrete:
        np.testing.assert_array_equal(log["indices"].numpy(), np.asarray(jlog["indices"]))


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_family_forward(fam):
    """The port's forward, ``fused`` off (and on for 41616 and 888),
    against JAX's, ``fused`` off (and on)."""
    core, meta, params, cfg, x = family(fam)
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    for f in (False, True) if FAMILIES[fam][3] else (False,):
        zj, dj, lj = jax.jit(lambda p, x: core.apply(
            {"params": p}, x, sample_override=False, fused=f))(params, xt)
        jout = (np.asarray(zj).transpose(0, 4, 1, 2, 3),
                np.asarray(dj).transpose(0, 4, 1, 2, 3), lj)
        K.reset_counts()
        out = port_tok(cfg, params, fused=f)(x)
        called = {k for k, n in K.counts("calls").items() if n}
        want = {"fused_spatial_resblock", "fused_temporal_resblock",
                "subpixel_interleave", "decoder_tail_rgb"}
        if meta["variant"] == "causal":
            want.add("parity_up2x_fused")
        if meta["variant"] == "causal_v1_1":
            want.add("temporal_linear_blend")
        assert called == (want if f else set())
        assert out[1].shape == x.shape
        check(out, jout, meta["discrete"])


@pytest.mark.parametrize("fam", [f for f in sorted(FAMILIES) if FAMILIES[f][2]])
def test_family_tiled(fam):
    """v1.1 families: the tiled forward (``use_overlap``) against JAX's
    tiled engine; for 888 (``t_chunk_dec`` 2, cache offsets up to 8) also
    with the kernel call sites on, kernel F at every temporal block."""
    core, meta, params, cfg, x = family(fam)
    t_chunk, fused = FAMILIES[fam][2:]
    jt = JTok(core, params, dict(meta, use_tiling=True, t_chunk_enc=t_chunk), fused=False)
    jt.use_overlap = True
    jz, jlog = jt.encode(jnp.asarray(x), return_reg_log=True)
    jout = (jz, jt.decode(jz), jlog)
    for f in (False, True) if fused else (False,):
        tok = port_tok(cfg, params, fused=f)
        tok.use_tiling, tok.use_overlap = True, True
        tok.t_chunk_enc = t_chunk
        tok.t_chunk_dec = t_chunk // tok.time_downsample_factor
        K.reset_counts()
        z, log = tok.encode(x, return_reg_log=True)
        check((z, tok.decode(z), log), jout, meta["discrete"])
        called = {k for k, n in K.counts("calls").items() if n}
        assert called == ({"fused_spatial_resblock", "fused_temporal_resblock_stream",
                           "subpixel_interleave", "decoder_tail_rgb",
                           "temporal_linear_blend"} if f else set())


def _recorder(calls, name, fn, key):
    def wrapped(*args, **kwargs):
        calls[name, key(*args, **kwargs)] += 1
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("path", ["v1_0", "tiled"] + sorted(cs.CONFIG_PATHS))
def test_chip_smoke_call_shapes(path, monkeypatch):
    """``chip_smoke.model_calls``, which gives the card's gates their call
    shapes and the serving runs their launches per forward, equals the
    kernel call sites the port's model reaches with ``fused`` on, key by
    key, for each configuration ``chip_smoke`` serves (at ``ch`` 16 and
    32² frames here; the same walk at full width there)."""
    from collections import Counter

    from vidtok_tpu_torch.modules import blocks, decoder
    from vidtok_tpu_torch.ops.kernels import temporal_linear

    cfg, shape, tiled = {"v1_0": (cs.V1_0_CFG, cs.REQUEST, False),
                         "tiled": (cs.V1_1_CFG, cs.TILED_REQUEST, True)}.get(
                             path) or cs.CONFIG_PATHS[path]
    cfg = {"model": tiny_section(cfg["model"])}
    shape = shape[:3] + (32, 32)
    calls = Counter()
    keys = {
        (blocks, "fused_spatial_resblock"):
            lambda x, n1, c1, *a: tuple(x.shape) + (c1[0].shape[0],),
        (blocks, "fused_temporal_resblock"): lambda x, *a: (tuple(x.shape), a[-1]),
        (blocks, "fused_temporal_resblock_stream"):
            lambda x, *a: (tuple(x.shape), a[-2], a[-1]),
        (blocks, "subpixel_interleave"): lambda y, *a: tuple(y.shape),
        (blocks, "parity_up2x_fused"): lambda s, *a: (tuple(s.shape), a[-1]),
        (temporal_linear, "temporal_linear_blend"):
            lambda x, p, bias, alpha, split, prev, front, nxt: (
                tuple(x.shape), split, "carried" if isinstance(front, torch.Tensor) else front,
                nxt),
        (decoder, "decoder_tail_rgb"): lambda h, *a: (tuple(h.shape), a[-1]),
    }
    for (mod, name), key in keys.items():
        monkeypatch.setattr(mod, name, _recorder(calls, name, getattr(mod, name), key))
    tok = load_model_from_config(cfg, device="cpu", fused=True)
    tok.use_tiling = tok.use_overlap = tiled
    x = np.zeros(shape, np.float32)
    tok(x)
    assert calls == cs.model_calls(cfg, shape, tiled)
    assert sum(calls.values()) > 0


@pytest.mark.parametrize("name,path", [
    ("V1_0_CFG", "vidtok_kl_causal_488_16chn.yaml"),
    ("FSQ_CFG", "vidtok_fsq_causal_488_4096.yaml"),
    ("V1_1_CFG", "v1_1/vidtok_kl_causal_488_16chn_v1_1.yaml"),
    ("NONCAUSAL_CFG", "vidtok_kl_noncausal_488_16chn.yaml"),
    ("FSQ_41616_CFG", "v1_1/vidtok_fsq_causal_41616_262144_v1_1.yaml"),
    ("FSQ_888_CFG", "v1_1/vidtok_fsq_causal_888_32768_v1_1.yaml"),
    ("KL_444_CFG", "vidtok_kl_causal_444_4chn.yaml"),
    ("FSQ_262144_CFG", "vidtok_fsq_causal_488_262144.yaml"),
    ("FSQ_32768_V1_1_CFG", "v1_1/vidtok_fsq_causal_488_32768_v1_1.yaml"),
    ("NONCAUSAL_FSQ_CFG", "vidtok_fsq_noncausal_488_262144.yaml")])
def test_chip_smoke_configs_are_the_files(name, path):
    """``chip_smoke`` holds its model sections resolved, so the card
    needs no YAML parser: each equals its config file's."""
    want = model_section(path)["params"]
    got = getattr(cs, name)["model"]["params"]
    for part in ("encoder_config", "decoder_config", "regularizer_config"):
        assert got[part] == want[part], part
    for key in ("use_tiling", "t_chunk_enc"):
        assert got.get(key) == want.get(key), key


def test_chip_smoke_fsq_options_config():
    """Phase 10b's model is the FSQ 4096 file's with FSQ's other options
    added to its regularizer, and builds projections onto two codebooks."""
    from vidtok_tpu_torch.models.autoencoder import build_core_from_config

    want = model_section("vidtok_fsq_causal_488_4096.yaml")["params"]
    got = cs.FSQ_OPTIONS_CFG["model"]["params"]
    for part in ("encoder_config", "decoder_config"):
        assert got[part] == want[part], part
    assert got["regularizer_config"] == dict(want["regularizer_config"], params=dict(
        want["regularizer_config"]["params"], **cs.FSQ_OPTIONS))
    reg = build_core_from_config(cs.FSQ_OPTIONS_CFG["model"])[0].regularization
    assert reg.has_projections and reg.num_codebooks == 2
    assert tuple(reg.project_in.weight.shape) == (8, 4)
    assert (reg.diversity_gamma, reg.inv_temperature) == (0.5, 10.0)
