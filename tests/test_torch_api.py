"""The port's public API beside ``vidtok_tpu``'s (fp32, CPU).

* ``build_core_from_config``'s decoder target: a decoder target that names no variant
  (``Decoder``, a user's name) takes the encoder's variant, as JAX's
  ``build_core_from_config`` does; the same weights give the same z and
  reconstruction (rtol 1e-4, atol 2e-4). An unknown encoder target raises
  in both packages.
* ``merge_configs`` over paths and dicts, nested overrides, lists, dotlists
  (spaces around the key, an item without ``=``), ``${...}`` references:
  equal to JAX's result, dict for dict.
* ``register`` / ``registered`` / ``instantiate_from_config`` of a user's
  class, the registry after resolving a built-in, the package's exports.
* ``DiagonalGaussian.var`` / ``.nll``, ``TokenizerCore.encode_raw`` /
  ``.regularize`` / ``.encode(n_steps=...)``, FSQ's ``effective_dim`` /
  ``has_projections``, the encoder's and decoder's ``causal`` /
  ``first_pad_mode`` and ``local_batch_slice`` against JAX's.
* The public-surface guard: every public name, method and constructor
  field of ``vidtok_tpu/`` (read from its source by ``ast``, nothing
  imported) has a counterpart in ``vidtok_tpu_torch/``, under the same
  name or the spelling ``SPELLINGS`` gives, or stands in ``NO_PORT`` with
  its reason. ROADMAP.md carries the same list.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu
import vidtok_tpu.parallel.distributed as JD
import vidtok_tpu.registry as JR
import vidtok_tpu_torch
import vidtok_tpu_torch.parallel.distributed as TD
import vidtok_tpu_torch.registry as TR
from tests.test_torch_v1_0 import CFG, FSQ_CFG, close, load_jax_params, random_params, t
from vidtok_tpu.config import merge_configs as j_merge
from vidtok_tpu.models.autoencoder import TokenizerCore as JCore
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.modules.decoder import Decoder as JDecoder
from vidtok_tpu.modules.encoder import Encoder as JEncoder
from vidtok_tpu.modules.regularizers import DiagonalGaussian as JGaussian
from vidtok_tpu.modules.regularizers import FSQRegularizer as JFSQ
from vidtok_tpu_torch.config import merge_configs
from vidtok_tpu_torch.models.autoencoder import build_core_from_config
from vidtok_tpu_torch.modules.decoder import Decoder
from vidtok_tpu_torch.modules.encoder import Encoder
from vidtok_tpu_torch.modules.regularizers import DiagonalGaussian, FSQRegularizer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with_decoder(cfg, target, encoder=None):
    p = dict(cfg["params"])
    if encoder is not None:
        p["encoder_config"] = dict(p["encoder_config"], target=encoder)
    p["decoder_config"] = dict(p["decoder_config"], target=target)
    return {"params": p}


def _pair(cfg, x, seed=0):
    """JAX's core and random weights, and the port's core holding them."""
    jcore, _ = j_build(cfg)
    params = random_params(jcore, x, seed)
    core, _ = build_core_from_config(cfg)
    load_jax_params(core, params)
    return jcore, params, core.eval()


# -- building from a config ---------------------------------------------------


@pytest.mark.parametrize("encoder,decoder,variant", [
    ("EncoderCausal3D", "Decoder", "causal"),
    ("vidtok.modules.model_3dcausal_v1_1.EncoderCausal3DPadding", "MyDecoder",
     "causal_v1_1"),
], ids=["v1_0-Decoder", "v1_1-user-name"])
def test_decoder_target_falls_back(encoder, decoder, variant):
    cfg = _with_decoder(CFG, decoder, encoder)
    x = np.random.RandomState(1).uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    jcore, params, core = _pair(cfg, x)
    jmeta = j_build(cfg)[1]
    assert core.decoder.variant == core.encoder.variant == jmeta["variant"] == variant
    assert jcore.decoder.variant == variant
    zj, dj, lj = jcore.apply({"params": params}, jnp.asarray(x), sample_override=False)
    with torch.no_grad():
        z, dec, log = core(t(x), sample=False)
    close(z, zj)
    close(dec, dj)
    close(log["kl_loss"], lj["kl_loss"], rtol=1e-4)


def test_unknown_encoder_target_raises():
    cfg = {"params": dict(CFG["params"], encoder_config=dict(
        CFG["params"]["encoder_config"], target="Encoder"))}
    with pytest.raises(KeyError):
        j_build(cfg)
    with pytest.raises(KeyError, match="unknown encoder target 'Encoder'"):
        build_core_from_config(cfg)


# -- configs and the registry ---------------------------------------------------

_BASE = {"model": {"target": "m", "params": {
    "encoder_config": {"params": {"ch": 128, "ch_mult": [1, 2, 4, 4], "z_channels": 4}},
    "decoder_config": {"params": "${model.params.encoder_config.params}"},
    "lr": 1e-4}}, "data": {"batch_size": 2}}
_OVER = {"model": {"params": {"encoder_config": {"params": {"z_channels": 16}},
                              "regularizer_config": {"target": "FSQRegularizer"}}},
         "data": {"batch_size": 4, "sizes": [17, 256, 256]}}
_LIST = {"data": {"sizes": [33, 128]}, "extra": [{"a": 1}, {"b": [2, 3]}]}


@pytest.mark.parametrize("configs,dotlist", [
    (("base.yaml",), ()),
    (("base.yaml", _OVER), ()),
    ((_BASE, "over.yaml", _LIST), ()),
    (("base.yaml", "over.yaml"), ["model.params.lr=3e-5", " data.batch_size =8",
                                  "model.params.encoder_config.params.ch_mult=[1, 2]"]),
    ((_BASE,), ["model.params.lr", "new.key=yes", "new.path=${data.batch_size}"]),
], ids=["one-path", "path+dict", "dict+path+list", "dotlist-spaces", "no-equals-and-ref"])
def test_merge_configs(tmp_path, configs, dotlist):
    import yaml

    (tmp_path / "base.yaml").write_text(yaml.safe_dump(_BASE))
    (tmp_path / "over.yaml").write_text(yaml.safe_dump(_OVER))
    args = [str(tmp_path / c) if isinstance(c, str) else c for c in configs]
    want = j_merge(*args, dotlist=dotlist)
    got = merge_configs(*args, dotlist=dotlist)
    assert got == want
    # the inputs are not changed, and the reference resolved
    assert _BASE["model"]["params"]["decoder_config"]["params"].startswith("${")
    assert got["model"]["params"]["decoder_config"]["params"] == \
        got["model"]["params"]["encoder_config"]["params"]


def test_train_cli_uses_merge_configs():
    from vidtok_tpu_torch.scripts import train

    assert train.merge_configs is merge_configs


@pytest.fixture
def fresh_registries(monkeypatch):
    monkeypatch.setattr(JR, "_REGISTRY", {})
    monkeypatch.setattr(TR, "_REGISTRY", {})


def test_register_and_instantiate(fresh_registries):
    class Widget:
        def __init__(self, width=1, depth=2):
            self.width, self.depth = width, depth

    for reg in (JR, TR):
        assert reg.register()(Widget) is Widget
        reg.register("Gadget")(Widget)
    cfg = {"target": "Gadget", "params": {"width": 5}}
    for build in (JR.instantiate_from_config, vidtok_tpu_torch.instantiate_from_config):
        w = build(cfg, depth=7)
        assert isinstance(w, Widget) and (w.width, w.depth) == (5, 7)
    assert TR.resolve("Widget") is JR.resolve("Widget") is Widget
    assert TR.registered() == JR.registered() == {"Widget": Widget, "Gadget": Widget}
    with pytest.raises(KeyError):
        TR.resolve("Unregistered")


def test_registered_after_resolve(fresh_registries):
    from vidtok_tpu_torch.modules.lpips import LPIPS

    assert TR.resolve("LPIPS") is LPIPS
    JR.resolve("LPIPS")
    assert set(TR.registered()) == set(JR.registered()) == {"LPIPS"}
    assert TR.registered()["LPIPS"] is LPIPS
    # a registered name wins over the built-in table
    TR.register("LPIPS")(dict)
    assert TR.resolve("LPIPS") is dict


@pytest.mark.parametrize("name", vidtok_tpu.__all__)
def test_exports(name):
    assert name in vidtok_tpu_torch.__all__
    assert callable(getattr(vidtok_tpu_torch, name))


# -- model API -------------------------------------------------------------------


def test_gaussian_var_nll():
    rng = np.random.RandomState(3)
    p = rng.randn(2, 3, 4, 5, 8).astype(np.float32)
    p[..., 4:] *= 20  # logvar past both clamps
    sample = rng.randn(2, 3, 4, 5, 4).astype(np.float32)
    jg, tg = JGaussian(jnp.asarray(p)), DiagonalGaussian(t(p))
    close(tg.var, jg.var)
    for s in (sample, p[..., :4]):
        close(tg.nll(t(s)), jg.nll(jnp.asarray(s)), rtol=1e-5)
    close(tg.nll(tg.mode()), jg.nll(jg.mode()), rtol=1e-5)


@pytest.fixture(scope="module")
def fsq_pair():
    x = np.random.RandomState(2).uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    return _pair(FSQ_CFG, x) + (x,)


@pytest.mark.parametrize("n_steps", [0, 500, 4000])
def test_encode_raw_regularize(fsq_pair, n_steps):
    jcore, params, core, x = fsq_pair
    v = {"params": params}
    zp_j = jcore.apply(v, jnp.asarray(x), method=JCore.encode_raw)
    zj, lj = jcore.apply(v, zp_j, n_steps=n_steps, method=JCore.regularize)
    ej, elj = jcore.apply(v, jnp.asarray(x), n_steps=n_steps, method=JCore.encode)
    with torch.no_grad():
        zp = core.encode_raw(t(x))
        z, log = core.regularize(zp, n_steps)
        e, elog = core.encode(t(x), n_steps=n_steps)
    close(zp, zp_j)
    close(z, zj)
    np.testing.assert_array_equal(log["indices"].numpy(), np.asarray(lj["indices"]))
    close(log["aux_loss"], lj["aux_loss"], rtol=1e-4)
    assert torch.equal(e, z) and torch.equal(elog["aux_loss"], log["aux_loss"])
    close(elog["aux_loss"], elj["aux_loss"], rtol=1e-4)


def test_encode_raw_streaming():
    """Chunk by chunk (the tiny v1.1 model), ``encode_raw`` carries the
    cache that ``encode`` does, and ``regularize`` of it is ``encode``'s
    result."""
    from tests.test_torch_model import CFG as V1_1
    from vidtok_tpu_torch.models.autoencoder import reset_params_

    core, _ = build_core_from_config(V1_1)
    reset_params_(core, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (1, 6, 16, 16, 3))
                         .astype(np.float32))
    with torch.no_grad():
        cache_a = cache_b = None
        for i in range(3):
            chunk = x[:, 2 * i:2 * i + 2]
            zp, cache_a = core.encode_raw(chunk, streaming=True, first_chunk=i == 0,
                                          cache=cache_a)
            z, _, cache_b = core.encode(chunk, sample=False, streaming=True,
                                        first_chunk=i == 0, cache=cache_b)
            assert torch.equal(core.regularize(zp, sample=False)[0], z)
            assert cache_a.keys() == cache_b.keys()
            assert all(torch.equal(cache_a[k], cache_b[k]) for k in cache_a)


@pytest.mark.parametrize("levels,dim,codebooks", [
    ((8, 5, 5, 5), None, 1), ((8, 5, 5, 5), 4, 1), ((4, 4), 8, 1), ((8, 8), 4, 2),
    ((8, 8), None, 2), ((5, 5, 5), 3, 1)])
def test_fsq_properties(levels, dim, codebooks):
    j = JFSQ(levels=levels, dim=dim, num_codebooks=codebooks)
    p = FSQRegularizer(levels, dim=dim, num_codebooks=codebooks)
    assert (p.effective_dim, p.has_projections) == (j.effective_dim, j.has_projections)
    assert hasattr(p, "project_in") == p.has_projections


@pytest.mark.parametrize("variant", ["causal", "causal_v1_1", "noncausal"])
def test_causal_first_pad_mode(variant):
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
              norm_type="layernorm", time_downsample_factor=2, variant=variant)
    for j, p in ((JEncoder(**kw), Encoder(**kw)), (JDecoder(**kw), Decoder(**kw))):
        assert (p.causal, p.first_pad_mode) == (j.causal, j.first_pad_mode)


@pytest.mark.parametrize("world,batch", [(1, 3), (2, 8), (4, 8), (4, 6)])
def test_local_batch_slice(monkeypatch, world, batch):
    monkeypatch.setattr(TD, "world_size", lambda: world)
    if world == 1:
        assert TD.local_batch_slice(batch) == JD.local_batch_slice(batch) == batch
    elif batch % world:
        with pytest.raises(ValueError):
            TD.local_batch_slice(batch)
    else:
        assert TD.local_batch_slice(batch) == batch // world


# -- the public-surface guard ---------------------------------------------------

# JAX module -> its port, where the path differs (None: no port)
MODULES = {
    "ops/pallas/act.py": "ops/kernels/act.py",
    "ops/pallas/decoder_tail.py": "ops/kernels/decoder_tail.py",
    "ops/pallas/fused_spatial_v2.py": "ops/kernels/fused_spatial.py",
    "ops/pallas/fused_temporal.py": "ops/kernels/fused_temporal.py",
    "ops/pallas/parity_upsample_fused.py": "ops/kernels/parity_upsample.py",
    "ops/pallas/subpixel_epilogue.py": "ops/kernels/subpixel.py",
    "ops/pallas/upsample_epilogue.py": "ops/kernels/upsample_epilogue.py",
    "ops/pallas/__init__.py": "ops/kernels/__init__.py",
    "ops/pallas/tuning.py": None,
    "utils/compile_cache.py": None,
}
# JAX name -> the port's name for it ("Class.member", or a member of any class)
SPELLINGS = {
    "fused_spatial_resblock_v2": "fused_spatial_resblock",
    "out_channels": "cout",
    "features": "cout",
    "QFormerLayer.hidden_size": "hidden",
    "QFormerLayer.intermediate_size": "intermediate",
    "VidTwinVAE.qformer": "temporal_qformer",
    "TokenizerCore.regularizer": "regularization",
}
# JAX's public names with no port, each with its reason (ROADMAP.md,
# queue 1, carries the same list)
_JIT = "jit and GSPMD plumbing, which the port's eager trainer does not need"
_FLAX_CONVERTER = ("a torch-to-Flax converter or Flax-tree file helper: the port reads "
                   "torch files and JAX's .npz directly (utils/checkpoint.py)")
_INIT = "an init helper: the port initialises in reset_params / randomize_"
_INLINE = "an internal JAX module the port computes inline"
_TPU = "TPU-only"
NO_PORT = {
    "setup": "Flax's setup: a torch module builds its children in __init__",
    "TrainState": _JIT,
    "build_train_step": _JIT,
    "jitted_train_step": _JIT,
    "shard_batch": _JIT,
    "shard_state": _JIT,
    "convert_torch_state_dict": _FLAX_CONVERTER,
    "convert_discriminator_state_dict": _FLAX_CONVERTER,
    "convert_full_checkpoint": _FLAX_CONVERTER,
    "convert_vidtwin_state_dict": _FLAX_CONVERTER,
    "convert_vidtwin_ablation_state_dict": _FLAX_CONVERTER,
    "load_torch_state_dict": _FLAX_CONVERTER,
    "save_params": _FLAX_CONVERTER,
    "load_params": _FLAX_CONVERTER,
    "save_full_npz": _FLAX_CONVERTER,
    "load_full_npz": _FLAX_CONVERTER,
    "validate_params": _FLAX_CONVERTER,
    "flatten_params": _FLAX_CONVERTER,
    "init_lpips_params": _INIT,
    "zero_init": _INIT,
    "Decoder.apply_conv_out": ("functional use of a Flax parameter: the port differentiates "
                               "with respect to decoder.conv_out.weight itself"),
    "T2IFinalLayer.apply_linear": ("functional use of a Flax parameter: the port "
                                   "differentiates with respect to "
                                   "decoder.final_layer.linear.weight itself"),
    "TokenMix": _INLINE,
    "BertSelfAttention": _INLINE,
    "VGG16Features": _INLINE,
    "STBlock.d_s": "unused by JAX's block, which reads the shapes from x",
    "STBlock.d_t": "unused by JAX's block, which reads the shapes from x",
    "use_bias": "no JAX module turns it off: every conv of the models has a bias",
    "StepTimer": ("an EMA of host time with no synchronize, read by nothing: the port is "
                  "timed by the benchmark's windows and traced by utils/profiling.span"),
    "TimeUpsampleRes2x.pallas_ok": ("JAX's switch for its remat'd training call; the "
                                    "port's training forward runs no kernel"),
    "set_conv_impl": _TPU + ": picks XLA's conv lowering, no meaning under cuDNN",
    "get_conv_impl": _TPU + ": picks XLA's conv lowering, no meaning under cuDNN",
    "conv3d": _TPU + ": the lowering switch's dispatcher (conv3d_cl is the port's conv)",
    "default_fast": _TPU + ": Mosaic's LN+SiLU form switch (VIDTOK_SILU_FAST)",
    "resolve": _TPU + ": Mosaic's LN+SiLU form switch (VIDTOK_SILU_FAST)",
    "impl": _TPU + ": Mosaic's LN+SiLU form switch (VIDTOK_SILU_FAST)",
    "ln_silu_mxu": _TPU + ": an LN+SiLU form for the MXU",
    "ln_silu_bf16s": _TPU + ": an LN+SiLU form for the TPU's bf16 VPU",
    "tail_fits": _TPU + ": a VMEM fit test (the port's tile plans are ops/kernels/plan.py)",
    "stream_tile": _TPU + ": a VMEM tile choice (the port's tile plans are "
                          "ops/kernels/plan.py)",
    "ops/pallas/tuning.py": _TPU + ": Mosaic's VMEM and compiler parameters",
    "utils/compile_cache.py": _TPU + ": XLA's persistent compile cache",
}


def _trees(pkg):
    base = os.path.join(ROOT, pkg)
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    out[os.path.relpath(path, base)] = ast.parse(fh.read())
    return out


def _public(name):
    return not name.startswith("_")


def _jax_surface(tree):
    """{name: None for a function, set of members for a class}: the public
    functions and classes, each class's public methods and fields."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and _public(node.name):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = {
                m.name if isinstance(m, ast.FunctionDef) else m.target.id
                for m in node.body
                if (isinstance(m, ast.FunctionDef) and _public(m.name))
                or (isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name)
                    and _public(m.target.id))}
    return out


def _module_names(tree):
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(n.id for n in node.targets if isinstance(n, ast.Name))
    return names


def _port_classes(trees):
    """class name -> (members, base names) over the whole port: methods,
    properties, ``__init__``'s arguments, ``self.x`` it sets."""
    out = {}
    for tree in trees.values():
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            members = set()
            for n in ast.walk(node):
                if isinstance(n, ast.FunctionDef):
                    members.add(n.name)
                    if n.name == "__init__":
                        members.update(a.arg for a in n.args.args + n.args.kwonlyargs)
                elif (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                      and n.value.id == "self"):
                    members.add(n.attr)
                elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                    targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                    members.update(x.id for x in targets if isinstance(x, ast.Name))
            bases = {b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
                     for b in node.bases}
            old = out.get(node.name, (set(), set()))
            out[node.name] = (old[0] | members, old[1] | bases)
    return out


def _members(classes, name, seen=()):
    if name not in classes or name in seen:
        return set()
    members, bases = classes[name]
    for b in bases:
        members = members | _members(classes, b, seen + (name,))
    return members


def _no_port(key, member=None):
    return key in NO_PORT or (member is not None and member in NO_PORT)


def _missing():
    jax_trees, port_trees = _trees("vidtok_tpu"), _trees("vidtok_tpu_torch")
    classes = _port_classes(port_trees)
    missing, unused = [], set(NO_PORT)
    for rel, tree in sorted(jax_trees.items()):
        port_rel = MODULES.get(rel, rel)
        if port_rel is None or port_rel not in port_trees:
            if rel in NO_PORT:
                unused.discard(rel)
            else:
                missing.append(rel)
            continue
        names = _module_names(port_trees[port_rel])
        for name, jmembers in sorted(_jax_surface(tree).items()):
            if SPELLINGS.get(name, name) not in names:
                if _no_port(name):
                    unused.discard(name)
                else:
                    missing.append(f"{rel}: {name}")
                continue
            pmembers = _members(classes, SPELLINGS.get(name, name))
            for m in sorted(jmembers or ()):
                qual = f"{name}.{m}"
                if m in pmembers or SPELLINGS.get(qual, SPELLINGS.get(m)) in pmembers:
                    continue
                if _no_port(qual, m):
                    unused.discard(qual if qual in NO_PORT else m)
                else:
                    missing.append(f"{rel}: {qual}")
    return missing, unused


def test_public_surface():
    """Each public name of ``vidtok_tpu`` has a port or a reason; each
    reason still names something the port lacks."""
    missing, unused = _missing()
    assert not missing, f"no counterpart in vidtok_tpu_torch and not in NO_PORT: {missing}"
    assert not unused, f"NO_PORT entries the port has, or JAX lacks: {sorted(unused)}"
