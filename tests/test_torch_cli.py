"""The port's CLIs (``vidtok_tpu_torch/scripts``) against the JAX package's
(``scripts/``), on the CPU with tiny models.

Both read the same mp4 and the same weights: random values in JAX's
parameter tree (every leaf drawn, so every parameter matters) saved as a
JAX ``.npz`` and passed as ``--ckpt`` to both. The JAX scripts run in this process (``runpy``
with a patched ``sys.argv``), the port's through their ``main(argv)`` with
``--device cpu``; each JAX tokenizer is built and compiled once per
configuration and shared (``jax_tokenizers``).

* ``inference_evaluate``: the printed per-window PSNR and SSIM and the
  means, LPIPS included (random weights in JAX's converted ``.npz``
  layout), within one unit of the printed precision plus one
  of f32 drift (2e-4 on the 4-decimal means, 0.011 dB and 2e-4 on the
  per-window lines); causal v1.1 windows, ``--read_long_video``, and a
  non-causal model; the "LPIPS: skipped" line without weights.
* ``inference_reconstruct`` and ``stream_tokens``: in
  ``test_torch_cli_stream.py``, on this file's fixtures.
* ``--ckpt`` of a Lightning ``.ckpt`` whose extra entries need the full
  pickle: refused without ``--full_pickle``, loaded with it.
"""

import argparse
import contextlib
import io
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vidtok_tpu
from vidtok_tpu.config import load_config as j_load_config
from vidtok_tpu.data import video_reader as JV
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.modules.lpips import init_lpips_params
from vidtok_tpu.utils.checkpoint import flatten_params, save_params
from vidtok_tpu_torch.scripts import inference_evaluate as PE

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3, "ch": 32,
      "ch_mult": [1, 2], "time_downsample_factor": 2, "num_res_blocks": 1,
      "norm_type": "layernorm", "interpolation_mode": "trilinear",
      "tempo_ds": [0], "tempo_us": [1]}


def _cfg(enc, dec, params, reg=None):
    return {"model": {"params": {
        "encoder_config": {"target": enc, "params": params},
        "decoder_config": {"target": dec, "params": "${model.params.encoder_config.params}"},
        "regularizer_config": reg or {"target": "DiagonalGaussianRegularizer"}}}}


CONFIGS = {
    # tests/test_scripts.py's TINY_MODEL: v1.1, trilinear
    "v1_1": _cfg("EncoderCausal3DV1_1", "DecoderCausal3DV1_1", _P),
    "fsq": _cfg("EncoderCausal3DV1_1", "DecoderCausal3DV1_1", dict(_P, double_z=False),
                {"target": "FSQRegularizer", "params": {"levels": [8, 8, 8, 8]}}),
    "noncausal": _cfg("Encoder3D", "Decoder3D", dict(
        _P, ch_mult=[1, 2, 2], time_downsample_factor=4, tempo_ds=[0, 1],
        tempo_us=[1, 2])),
    "v1_0": _cfg("EncoderCausal3D", "DecoderCausal3D",
                 {k: v for k, v in _P.items() if k != "interpolation_mode"}),
}


def random_params(shapes, seed):
    """Values for a parameter tree of ``jax.ShapeDtypeStruct`` leaves:
    kernels N(0, gain / fan_in), norm scales 1 + N(0, 0.1), the rest
    N(0, 0.05) (biases, mix factors)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.randn(*s.shape).astype(np.float32) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        base = 1.0 if name == "scale" else 0.0
        return (base + (0.1 if name == "scale" else 0.05) * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A 40-frame 48x64 clip at 30 fps, each config as YAML, random weights
    for each in JAX's parameter tree as a JAX ``.npz`` (shapes from
    ``jax.eval_shape`` of its init), and LPIPS weights in JAX's converted
    layout (lin heads non-negative, as trained ones are)."""
    d = tmp_path_factory.mktemp("cli")
    (d / "videos").mkdir()
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:48, 0:64] / 64
    frames = np.stack([0.5 + 0.35 * np.sin(5 * (xx + 0.7 * yy) + 0.25 * i)[..., None]
                       * np.array([1.0, -0.7, 0.5]) for i in range(40)])
    frames = np.clip(frames + 0.02 * rng.randn(*frames.shape), 0, 1)
    JV.write_video(str(d / "videos" / "clip.mp4"), (frames * 255).astype(np.uint8), fps=30)
    x = jnp.zeros((1, 5, 32, 32, 3))
    for i, (name, cfg) in enumerate(CONFIGS.items()):
        (d / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
        core, _ = j_build(j_load_config(cfg)["model"])
        shapes = jax.eval_shape(lambda: core.init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)}, x,
            sample_override=False))["params"]
        save_params(str(d / f"{name}.npz"), random_params(shapes, i))
    lpips = random_params(jax.eval_shape(init_lpips_params), 9)
    for k in range(5):
        lpips[f"lin{k}"]["kernel"] = np.abs(lpips[f"lin{k}"]["kernel"])
    np.savez(str(d / "lpips.npz"), **flatten_params(lpips))
    return d


@pytest.fixture(scope="module")
def jax_tokenizers():
    """``vidtok_tpu.load_model_from_config`` cached per (config, weights,
    dtype), its tiling settings reset on each hand-out, so that each JAX
    tokenizer compiles its shapes once for the whole module."""
    real = vidtok_tpu.load_model_from_config
    cache = {}

    def cached(config, ckpt=None, **kw):
        key = (config, ckpt, str(kw.get("compute_dtype")))
        if key not in cache:
            cache[key] = real(config, ckpt=ckpt, **kw)
        tok = cache[key]
        tok.use_tiling = tok.meta.get("use_tiling", False)
        tok.t_chunk_enc = tok.meta.get("t_chunk_enc", 16)
        tok.t_chunk_dec = tok.t_chunk_enc // tok.time_downsample_factor
        tok.use_overlap = False
        return tok

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vidtok_tpu, "load_model_from_config", cached)
        yield


def run_jax(script, args):
    """Run ``scripts/<script>.py`` in this process; its standard output."""
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [script] + [str(a) for a in args]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, "scripts", f"{script}.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue()


def run_port(module, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main([str(a) for a in args] + ["--device", "cpu"])
    return out.getvalue()


def means(out):
    """{"PSNR": x, ...} from the ``mean ...:`` lines; per-window (psnr, ssim)."""
    got = {line.split()[1].rstrip(":"): float(line.split()[2])
           for line in out.splitlines() if line.startswith("mean ")}
    windows = [(float(line.split("psnr=")[1].split()[0]), float(line.split("ssim=")[1]))
               for line in out.splitlines() if line.startswith("[")]
    return got, windows


EVAL_CASES = {
    "v1_1": ["--num_frames", "9"],
    "v1_1_lpips": ["--num_frames", "9", "--lpips"],
    "v1_1_long": ["--read_long_video", "--chunk_size", "8", "--lpips"],
    "noncausal": [],
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate(workdir, jax_tokenizers, case):
    cfg = "noncausal" if case == "noncausal" else "v1_1"
    args = ["--config", workdir / f"{cfg}.yaml", "--ckpt", workdir / f"{cfg}.npz",
            "--data_dir", workdir / "videos", "--input_height", 32, "--input_width", 32]
    extra = list(EVAL_CASES[case])
    if "--lpips" in extra:
        extra[extra.index("--lpips"):] = ["--lpips_weights", workdir / "lpips.npz"]
    else:
        extra += ["--lpips_weights", workdir / "absent.npz"]
    want, got = run_jax("inference_evaluate", args + extra), run_port(PE, args + extra)
    (wm, ww), (gm, gw) = means(want), means(got)
    assert set(gm) == set(wm) == ({"PSNR", "SSIM", "LPIPS"} if "lpips" in case
                                  or "long" in case else {"PSNR", "SSIM"})
    for k in wm:
        assert abs(gm[k] - wm[k]) <= 2e-4, (k, gm[k], wm[k])
    assert len(gw) == len(ww) > 0
    for (gp, gs), (wp, ws) in zip(gw, ww):
        assert abs(gp - wp) <= 0.011 and abs(gs - ws) <= 2e-4
    strip = lambda s: [l.split("psnr=")[0] for l in s.splitlines() if not l.startswith("mean")]
    assert strip(got) == strip(want)


def test_ckpt_full_pickle(workdir, tmp_path):
    """A Lightning ``.ckpt`` with an ``argparse.Namespace`` in its
    hyper-parameters: the weights-only load refuses it, naming the
    opt-in; ``--full_pickle`` loads it, with the ``.npz``'s results."""
    from vidtok_tpu_torch import load_model_from_config

    tok = load_model_from_config(str(workdir / "v1_1.yaml"), ckpt=str(workdir / "v1_1.npz"),
                                 device="cpu")
    path = tmp_path / "lightning.ckpt"
    torch.save({"state_dict": tok.core.state_dict(), "global_step": 7,
                "hyper_parameters": argparse.Namespace(lr=1e-4)}, path)
    args = ["--config", workdir / "v1_1.yaml", "--data_dir", workdir / "videos",
            "--input_height", 32, "--input_width", 32, "--num_frames", "9",
            "--lpips_weights", workdir / "absent.npz"]
    with pytest.raises(Exception, match="full_pickle"):
        run_port(PE, args + ["--ckpt", path])
    want = run_port(PE, args + ["--ckpt", workdir / "v1_1.npz"])
    assert run_port(PE, args + ["--ckpt", path, "--full_pickle"]) == want
