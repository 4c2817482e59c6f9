"""The port's VidTwin engine, weights and CLIs against ``vidtok_tpu``'s,
on the CPU with ``tests/test_vidtwin.py``'s small causal model
(``test_torch_vidtwin.py`` holds the modules).

* ``VidTwinTokenizer`` (``device="cpu"``, f32 attention) against JAX's
  engine: encode, decode with each ``only_part``, forward and
  ``cross_reenact`` (rtol 1e-4, atol 2e-4); sampling from its generator;
  ``load_model_from_config`` returns it; without CUDA the default device
  raises.
* Weights: ``vidtwin_state_dict_from_jax`` inverts JAX's
  ``convert_vidtwin_state_dict`` (a reference-named state dict with the
  keys JAX drops comes back less them); a ``.ckpt``, a ``.safetensors``
  and a JAX ``.npz`` load strictly and give JAX's reconstruction; a
  mis-shaped, missing or unexpected key raises.
* The two CLIs as subprocesses (``--device cpu``) against the JAX scripts
  in this process, on written mp4s and the same JAX ``.npz``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_cli import run_jax
from tests.test_torch_vidtwin import ROOT, TOL, clip, f32_jax, init, ncthw, to_torch
from tests.test_vidtwin import small_cfg
from vidtok_tpu.config import load_config as j_load_config
from vidtok_tpu.data import video_reader as JV
from vidtok_tpu.models.vidtwin.convert import convert_vidtwin_state_dict
from vidtok_tpu.models.vidtwin.engine import VidTwinTokenizer as JTok
from vidtok_tpu.models.vidtwin.vidtwin_ae import build_vidtwin_from_config as j_build
from vidtok_tpu.utils.checkpoint import save_params
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.models.vidtwin.convert import DROPPED, vidtwin_state_dict_from_jax
from vidtok_tpu_torch.models.vidtwin.engine import VidTwinTokenizer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The causal small config as YAML, non-zero JAX weights for it as a
    JAX ``.npz`` (shapes from ``jax.eval_shape``), and the JAX engine with
    f32 attention on them."""
    d = tmp_path_factory.mktemp("vidtwin")
    cfg = {"model": {"target": "VidTwinVAE", **small_cfg(True)}}
    (d / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    jm, _ = j_build(cfg["model"])
    params = init(jm, 20, jnp.zeros((1, 4, 32, 32, 3)), sample_override=False)
    save_params(str(d / "tiny.npz"), params)
    jtok = JTok.from_config(str(d / "tiny.yaml"), ckpt=str(d / "tiny.npz"))
    jtok.model = f32_jax(cfg["model"])
    return d, cfg, params, jtok


def port_tok(d, ckpt, **kw):
    tok = load_model_from_config(str(d / "tiny.yaml"), ckpt=str(ckpt), device="cpu", **kw)
    tok.model.encoder.set_attn_dtype(None)
    tok.model.decoder.set_attn_dtype(None)
    return tok


def test_engine(files):
    d, _, _, jtok = files
    tok = port_tok(d, d / "tiny.npz")
    assert isinstance(tok, VidTwinTokenizer) and tok.device.type == "cpu"
    xa, xb = ncthw(clip(21, (1, 4, 32, 32, 3))), ncthw(clip(22, (1, 4, 32, 32, 3)))
    want, got = jtok.encode(jnp.asarray(xa)), tok.encode(xa)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(float(got[3]["kl_loss"]), float(want[3]["kl_loss"]), rtol=1e-4)
    for part in (None, "content", "motion"):
        np.testing.assert_allclose(tok.decode(*got[:3], only_part=part),
                                   jtok.decode(*want[:3], only_part=part), **TOL)
    for w, g in zip(jtok.forward(jnp.asarray(xa))[:2], tok.forward(xa)[:2]):
        np.testing.assert_allclose(g, w, **TOL)
    cross = tok.cross_reenact(xa, xb)
    np.testing.assert_allclose(cross, jtok.cross_reenact(jnp.asarray(xa), jnp.asarray(xb)),
                               **TOL)
    assert not torch.allclose(cross, tok(xa)[1]) and not torch.allclose(cross, tok(xb)[1])


def test_engine_sampling_and_default_device(files, monkeypatch):
    """``sample=True`` draws from the engine's generator, which advances
    per call; without CUDA the default device raises."""
    d, cfg, _, _ = files
    tok = port_tok(d, d / "tiny.npz", seed=5)
    x = ncthw(clip(23, (1, 4, 32, 32, 3)))
    a, b, mode = tok.encode(x, sample=True), tok.encode(x, sample=True), tok.encode(x)
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[0], mode[0])
    again = port_tok(d, d / "tiny.npz", seed=5).encode(x, sample=True)
    assert torch.equal(again[0], a[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_from_config(cfg)


def reference_sd(params):
    """A reference-named state dict of ``params`` with the keys JAX's
    converter drops (and the port's reader with it)."""
    sd = vidtwin_state_dict_from_jax(params)
    rng = np.random.RandomState(30)
    extra = {"loss.logvar": (), "loss.discriminator.main.0.weight": (4, 3, 4, 4),
             "model_ema.decay": (), "regularization.dummy": (2,),
             "encoder.pos_embed": (1, 16, 64), "decoder.pos_embed_temporal": (1, 4, 64),
             "encoder.final_layer.linear.weight": (192, 64),
             "encoder.final_layer.scale_shift_table": (2, 64),
             "decoder.x_embedder.proj.weight": (64, 3, 1, 8, 8),
             "temporal_qformer.qformer.encoder.layer.0.intermediate.dense.weight": (32, 32),
             "temporal_qformer.qformer.encoder.layer.1.output.LayerNorm.bias": (32,)}
    return sd, {k: np.asarray(rng.randn(*s), np.float32) for k, s in extra.items()}


def test_state_dict_round_trip(files):
    """Reference keys -> JAX's ``convert_vidtwin_state_dict`` ->
    ``vidtwin_state_dict_from_jax``: the original, less the dropped keys."""
    _, _, params, _ = files
    sd, extra = reference_sd(params)
    assert all(DROPPED.search(k) for k in extra) and not any(DROPPED.search(k) for k in sd)
    back = vidtwin_state_dict_from_jax(convert_vidtwin_state_dict({**sd, **extra}))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors", "npz"])
def test_checkpoint_sources(files, tmp_path, fmt):
    """Each source loads strictly (extra reference keys dropped) and gives
    JAX's reconstruction."""
    d, _, params, jtok = files
    sd, extra = reference_sd(params)
    if fmt == "ckpt":
        path = tmp_path / "m.ckpt"
        torch.save({"state_dict": to_torch({**sd, **extra})}, path)
    elif fmt == "safetensors":
        st = pytest.importorskip("safetensors.torch")
        path = tmp_path / "m.safetensors"
        st.save_file(to_torch({**sd, **extra}), str(path))
    else:
        path = d / "tiny.npz"
    x = ncthw(clip(24, (1, 4, 32, 32, 3)))
    np.testing.assert_allclose(port_tok(d, path)(x)[1], jtok(jnp.asarray(x))[1], **TOL)


@pytest.mark.parametrize("fault", ["mis-shaped", "missing", "unexpected"])
def test_checkpoint_faults(files, tmp_path, fault):
    d, _, params, _ = files
    sd = to_torch(vidtwin_state_dict_from_jax(params))
    if fault == "mis-shaped":
        sd["decoder.final_layer.linear.weight"] = sd["decoder.final_layer.linear.weight"][:-1]
    elif fault == "missing":
        del sd["motion_head.bias"]
    else:
        sd["decoder.blocks.0.attn.extra"] = torch.zeros(1)
    torch.save({"state_dict": sd}, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match=f"1 {fault}"):
        port_tok(d, tmp_path / "bad.ckpt")


def run_port(module, args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", f"vidtok_tpu_torch.scripts.{module}"]
                       + [str(a) for a in args] + ["--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def mean_psnr(out):
    return float(next(l for l in out.splitlines() if l.startswith("mean PSNR")).split()[-1])


@pytest.fixture(scope="module")
def videos(files):
    d = files[0]
    (d / "videos").mkdir(exist_ok=True)
    yy, xx = np.mgrid[0:48, 0:64] / 64
    for k in range(2):
        frames = np.stack([0.5 + 0.35 * np.sin(5 * (xx + 0.7 * yy) + (0.25 + k) * i)[..., None]
                           * np.array([1.0, -0.7, 0.5]) for i in range(40)])
        JV.write_video(str(d / "videos" / f"clip{k}.mp4"),
                       (np.clip(frames, 0, 1) * 255).astype(np.uint8), fps=30)
    return d / "videos"


def test_cli_evaluate(files, videos, monkeypatch):
    """The mean PSNR printed by the port's ``vidtwin_evaluate`` (bf16
    attention by default, as JAX's) within ``2 x spread + 2e-4`` dB of JAX's
    script, ``spread`` being JAX's own change of the mean PSNR when its
    attention runs in f32 (each side's bf16 rounding moves it about that
    far; 2e-4 covers the printed precision)."""
    d = files[0]
    args = ["--config", d / "tiny.yaml", "--ckpt", d / "tiny.npz", "--data_dir", videos]
    want = run_jax("vidtwin_evaluate", args)
    real = JTok.from_config.__func__

    def f32_from_config(cls, *a, **kw):
        tok = real(cls, *a, **kw)
        tok.model = f32_jax(j_load_config(str(d / "tiny.yaml"))["model"])
        return tok

    monkeypatch.setattr(JTok, "from_config", classmethod(f32_from_config))
    spread = abs(mean_psnr(run_jax("vidtwin_evaluate", args)) - mean_psnr(want))
    got = run_port("vidtwin_evaluate", args)
    lines = [l.split("psnr=")[0] for l in got.splitlines() if l.startswith("[")]
    assert lines == [l.split("psnr=")[0] for l in want.splitlines() if l.startswith("[")]
    assert len(lines) > 2
    assert abs(mean_psnr(got) - mean_psnr(want)) <= 2 * spread + 2e-4, (got, want, spread)


@pytest.mark.parametrize("cross", [False, True], ids=["reconstruct", "cross"])
def test_cli_reconstruct(files, videos, tmp_path, cross):
    """The side-by-side mp4 (``_recon`` or ``_cross``): its input half
    within 1 of 255 of JAX's script's, the whole a mean absolute
    difference of at most 3 of 255 (bf16 attention on both sides, then
    the mp4 codec)."""
    d = files[0]
    args = ["--config", d / "tiny.yaml", "--ckpt", d / "tiny.npz",
            "--input_video_path", videos / "clip0.mp4"]
    if cross:
        args += ["--dynamics_video_path", videos / "clip1.mp4"]
    tag = "cross" if cross else "recon"
    run_jax("vidtwin_reconstruct", args + ["--output_video_dir", tmp_path / "jax"])
    out = run_port("vidtwin_reconstruct", args + ["--output_video_dir", tmp_path / "port"])
    assert f"clip0_{tag}.mp4" in out
    read = lambda p: np.rint(JV.read_frames_at(str(p), list(range(4))) * 255)  # noqa
    want, got = read(tmp_path / "jax" / f"clip0_{tag}.mp4"), read(tmp_path / "port" / f"clip0_{tag}.mp4")
    assert got.shape == want.shape == (4, 32, 64, 3)
    assert np.abs(got[:, :, :32] - want[:, :, :32]).max() <= 1
    assert np.abs(got - want).mean() <= 3
