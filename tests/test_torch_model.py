"""The PyTorch port's tokenizer as a whole against ``vidtok_tpu``.

* The tiny causal v1.1 model of ``tests/test_fast_paths.py`` with random
  parameters: z, reconstruction and kl_loss of the port's
  ``VideoTokenizer.forward`` (kernel call sites on and off) against JAX
  with ``fused`` False and True; fp32, rtol 1e-4, atol 2e-4.
* Weights: ``state_dict_from_jax`` and ``convert_torch_state_dict`` are
  inverse; the full-width v1.1 16-channel model's parameter shapes equal
  ``jax.eval_shape`` of the JAX init.
* Import hygiene: the port imports neither JAX, Flax nor PyYAML, also
  when it builds the v1.0 KL and FSQ models, and nothing of ``vidtok_tpu``
  when it loads a YAML config; without CUDA, naming no device raises.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.utils.checkpoint import convert_torch_state_dict
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.models.autoencoder import build_core_from_config
from vidtok_tpu_torch.ops import kernels as K

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=2e-4)

_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2], "time_downsample_factor": 2,
      "num_res_blocks": 1, "norm_type": "layernorm",
      "interpolation_mode": "trilinear", "tempo_ds": [0], "tempo_us": [1]}
CFG = {"params": {
    "encoder_config": {"target": "EncoderCausal3DV1_1", "params": dict(_P)},
    "decoder_config": {"target": "DecoderCausal3DV1_1", "params": dict(_P)},
    "regularizer_config": {"target": "DiagonalGaussianRegularizer"},
}}
# tests/test_vidtwin.py's small VidTwin (its small_cfg), resolved
_STT = {"in_channels": 3, "input_size": [4, 32, 32], "patch_size": [1, 8, 8],
        "hidden_size": 64, "depth": 2, "num_heads": 4, "temporal_casual": True}
VIDTWIN = {"target": "VidTwinVAE", "params": {
    "expect_ch": 8, "cont_num_blocks": 1, "downsample_motion": True, "motion_num_blocks": 1,
    "d_dim": 8, "init_ch": 16,
    "temporal_qformer_config": {"target": "QFormerInterface", "params": {
        "num_query_tokens": 4, "query_hidden_size": 32, "encoder_hidden_size": 64}},
    "encoder_config": {"target": "STTEncoder", "params": dict(_STT)},
    "decoder_config": {"target": "STTDecoder", "params": dict(_STT)},
    "regularizer_config": {"target": "DiagonalGaussianRegularizer"}}}
# the Sym ablation on the same backbone (a spatial Q-Former beside)
VIDTWIN_SYM = {"target": "vidtwin.models.vidtwin_ae.VidAutoEncoderQformerCompactSym",
               "params": dict(VIDTWIN["params"], space_qformer_config=VIDTWIN["params"][
                   "temporal_qformer_config"])}
V11_16CHN = os.path.join(ROOT, "configs", "v1_1",
                         "vidtok_kl_causal_488_16chn_v1_1.yaml")


def load_jax_params(module, params):
    """Copy a JAX parameter tree into ``module`` (strict key match)."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in state_dict_from_jax(params).items()}
    module.load_state_dict(sd, strict=True)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def tiny():
    """JAX core + random params (non-zero norm biases, temporal conv2) and
    a [1, 3, 5, 32, 32] clip."""
    core, _ = j_build(CFG)
    rng = np.random.RandomState(0)
    x = np.clip(rng.randn(1, 3, 5, 32, 32) * 0.5, -1, 1).astype(np.float32)
    v = core.init({"params": jax.random.PRNGKey(0),
                   "sample": jax.random.PRNGKey(0)},
                  jnp.asarray(x.transpose(0, 2, 3, 4, 1)), sample_override=False)

    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.08 * r

    params = jax.tree_util.tree_map_with_path(leaf, v["params"])
    return core, params, x


@pytest.mark.parametrize("fused", [True, False])
def test_tiny_v1_1_end_to_end(tiny, fused):
    core, params, x = tiny
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    tok = load_model_from_config({"model": CFG}, device="cpu", fused=fused)
    load_jax_params(tok.core, params)
    K.reset_counts()
    z, dec, log = tok(x)
    calls = K.counts("calls")
    # one call per spatial/temporal resblock (1 + 1 encoder levels,
    # 2 + 2 decoder levels), one spatial upsample, one decoder tail
    # (v1.1 upsamples time trilinearly: no parity upsample, J and K once)
    want = dict.fromkeys(K.WRAPPERS, 0)
    if fused:
        want.update(fused_spatial_resblock=6, fused_temporal_resblock=6,
                    subpixel_interleave=1, decoder_tail_rgb=1, temporal_linear_up2x=1,
                    linear_blend=1)
    assert calls == want
    assert all(n == 0 for n in K.counts().values())  # CPU: no launches
    assert z.shape == (1, 4, 3, 16, 16) and dec.shape == x.shape
    for j_fused in (False, True):
        zj, dj, lj = core.apply({"params": params}, xt, sample_override=False,
                                fused=j_fused)
        np.testing.assert_allclose(z.numpy(), np.asarray(zj).transpose(0, 4, 1, 2, 3),
                                   **TOL)
        np.testing.assert_allclose(dec.numpy(), np.asarray(dj).transpose(0, 4, 1, 2, 3),
                                   **TOL)
        np.testing.assert_allclose(float(log["kl_loss"]), float(lj["kl_loss"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_default(dtype):
    """The kernel call sites are on by default only on a CUDA device (in
    bf16 or f32: tests/test_torch_f32_kernels.py); on the CPU they stay off
    unless asked for."""
    tok = load_model_from_config({"model": CFG}, device="cpu", compute_dtype=dtype)
    assert tok.fused is False
    tok = load_model_from_config({"model": CFG}, device="cpu", compute_dtype=dtype,
                                 fused=True)
    assert tok.fused is True


def test_state_dict_round_trip(tiny):
    _, params, _ = tiny
    tok = load_model_from_config({"model": CFG}, device="cpu")
    load_jax_params(tok.core, params)
    back = convert_torch_state_dict(
        {k: v.numpy() for k, v in tok.core.state_dict().items()})
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sd = state_dict_from_jax(params)
    assert sd.keys() == tok.core.state_dict().keys()


def test_full_width_v1_1_16chn_shapes():
    """Parameter shapes of the port's full-width model (on the meta device,
    no memory) equal the JAX init's, with no forward pass."""
    from vidtok_tpu.config import load_config

    cfg = load_config(V11_16CHN)["model"]
    with torch.device("meta"):
        core, meta = build_core_from_config(cfg)
    assert meta["variant"] == "causal_v1_1" and not meta["use_tiling"]
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, v.shape) for k, v in core.state_dict().items()}
    port = {k: v.shape for k, v in flat(convert_torch_state_dict(sd)).items()}

    jcore, _ = j_build(cfg)
    shapes = jax.eval_shape(
        lambda: jcore.init({"params": jax.random.PRNGKey(0),
                            "sample": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 4, 16, 16, 3)), sample_override=False))
    ref = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert port == ref
    assert sum(int(np.prod(s)) for s in ref.values()) == 157_949_351
    assert sum(p.numel() for p in core.parameters()) == 157_949_351


def test_import_hygiene(tmp_path):
    """The port imports torch and numpy only: no jax, flax or yaml when it
    builds a model from a config dict (v1.1 KL, v1.0 KL and FSQ, the
    non-causal KL, a VidTwin through ``load_model_from_config``, and a
    VidTwin trainer) beside its two tool modules (the temporal
    microbenchmark, the SiLU probe), its six CLIs, its data package
    (the training pipeline and data module too), metrics and LPIPS, the
    registry, the loggers, the distributed helpers and the mesh, the
    profiling helpers and the sharded-scaling tool, builds a VidTwin
    ablation (Sym), builds a trainer (its
    discriminator, losses and optimizers), saves a ``.ckpt`` and loads it
    back, merges two config dicts (``merge_configs``, a ``Decoder`` target
    that takes the encoder's variant) and builds a class it registered
    (``register``, ``instantiate_from_config``), none of which pulls in
    ``vidtok_tpu`` either; and no jax,
    flax or ``vidtok_tpu`` module when it loads a YAML file (PyYAML is
    allowed there) whose ``${...}`` reference its own resolver follows.
    Neither pulls in cv2, PIL or pandas: importing the port needs none."""
    import yaml

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    v1_0 = {"params": {
        "encoder_config": {"target": "EncoderCausal3D", "params": dict(_P)},
        "decoder_config": {"target": "DecoderCausal3D", "params": dict(_P)},
        "regularizer_config": {"target": "DiagonalGaussianRegularizer"}}}
    fsq = {"params": dict(v1_0["params"], regularizer_config={
        "target": "FSQRegularizer", "params": {"levels": [8, 8, 8, 8]}})}
    noncausal = {"params": dict(
        v1_0["params"],
        encoder_config={"target": "Encoder3D", "params": dict(_P)},
        decoder_config={"target": "vidtok.modules.model_3dnoncausal.Decoder3D",
                        "params": dict(_P)})}
    ckpt = str(tmp_path / "tiny.ckpt")
    yaml_cfg = {"model": {"params": dict(CFG["params"], decoder_config={
        "target": "DecoderCausal3DV1_1",
        "params": "${model.params.encoder_config.params}"})}}
    path = tmp_path / "tiny_v1_1.yaml"
    path.write_text(yaml.safe_dump(yaml_cfg))
    code = (
        "import sys, vidtok_tpu_torch, vidtok_tpu_torch.convert\n"
        "import vidtok_tpu_torch.ops.kernels\n"
        "import vidtok_tpu_torch.tools.microbench_temporal\n"
        "import vidtok_tpu_torch.tools.probe_silu_bf16\n"
        "import vidtok_tpu_torch.data, vidtok_tpu_torch.ops.metrics\n"
        "import vidtok_tpu_torch.modules.lpips\n"
        "import vidtok_tpu_torch.scripts.inference_evaluate\n"
        "import vidtok_tpu_torch.scripts.inference_reconstruct\n"
        "import vidtok_tpu_torch.scripts.stream_tokens\n"
        "import vidtok_tpu_torch.scripts.train, vidtok_tpu_torch.registry\n"
        "import vidtok_tpu_torch.data.pipeline, vidtok_tpu_torch.data.datamodule\n"
        "import vidtok_tpu_torch.utils.logging, vidtok_tpu_torch.parallel.distributed\n"
        "import vidtok_tpu_torch.parallel.mesh, vidtok_tpu_torch.utils.profiling\n"
        "import vidtok_tpu_torch.tools.sharded_scaling\n"
        "import vidtok_tpu_torch.models.vidtwin.ablations\n"
        "from vidtok_tpu_torch.train.trainer import VidTokTrainer\n"
        f"VidTokTrainer({{'model': {fsq!r}}}, device='cpu').init_state()\n"
        "import vidtok_tpu_torch.scripts.vidtwin_evaluate\n"
        "import vidtok_tpu_torch.scripts.vidtwin_reconstruct\n"
        "from vidtok_tpu_torch.models.vidtwin.trainer import VidTwinTrainer\n"
        f"twin = vidtok_tpu_torch.load_model_from_config({{'model': {VIDTWIN!r}}}, "
        "device='cpu')\n"
        "assert type(twin).__name__ == 'VidTwinTokenizer'\n"
        f"sym = vidtok_tpu_torch.load_model_from_config({{'model': {VIDTWIN_SYM!r}}}, "
        "device='cpu')\n"
        "assert type(sym.model).__name__ == 'VidTwinSym'\n"
        f"VidTwinTrainer({{'model': {VIDTWIN!r}}}, device='cpu').init_state()\n"
        f"for m in ({CFG!r}, {v1_0!r}, {fsq!r}):\n"
        "    tok = vidtok_tpu_torch.load_model_from_config({'model': m}, "
        "device='cpu')\n"
        "assert tok.meta['variant'] == 'causal' and tok.meta['discrete']\n"
        f"tok = vidtok_tpu_torch.load_model_from_config({{'model': {noncausal!r}}}, "
        "device='cpu')\n"
        "assert tok.meta['variant'] == 'noncausal'\n"
        f"tok.save({ckpt!r})\n"
        f"back = vidtok_tpu_torch.load_model_from_config({{'model': {noncausal!r}}}, "
        f"device='cpu', ckpt={ckpt!r})\n"
        "import torch\n"
        "assert all(torch.equal(a, b) for a, b in zip(\n"
        "    tok.core.state_dict().values(), back.core.state_dict().values()))\n"
        "merged = vidtok_tpu_torch.merge_configs(\n"
        f"    {{'model': {CFG!r}}},\n"
        "    {'model': {'params': {'decoder_config': {'target': 'Decoder'}}}})\n"
        "tok = vidtok_tpu_torch.load_model_from_config(merged, device='cpu')\n"
        "assert tok.core.decoder.variant == 'causal_v1_1'\n"
        "@vidtok_tpu_torch.register('Widget')\n"
        "class W:\n"
        "    pass\n"
        "assert type(vidtok_tpu_torch.instantiate_from_config({'target': 'Widget'})) is W\n"
        "bad = [m for m in ('jax', 'flax', 'yaml', 'vidtok_tpu', 'cv2', 'PIL', 'pandas')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        f"tok = vidtok_tpu_torch.load_model_from_config({str(path)!r}, "
        "device='cpu')\n"
        "assert tok.meta['variant'] == 'causal_v1_1'\n"
        "assert tok.core.decoder.conv_in.conv.in_channels == 4\n"
        "bad = [m for m in ('jax', 'flax', 'vidtok_tpu', 'cv2', 'PIL', 'pandas')\n"
        "       if m in sys.modules]\n"
        "assert not bad and 'yaml' in sys.modules, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_default_device_needs_cuda(monkeypatch):
    """A caller who names no device gets the card; where there is none the
    entry point raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_from_config({"model": CFG})
    assert load_model_from_config({"model": CFG}, device="cpu").device.type == "cpu"
