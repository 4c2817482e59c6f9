"""The port's ``inference_reconstruct`` and ``stream_tokens`` against the
JAX package's, on the CPU with tiny models, on ``test_torch_cli.py``'s
clip, weights and runners (the JAX scripts in this process, the port's
``main(argv)`` with ``--device cpu``).

* ``inference_reconstruct`` (plain, ``--read_long_video``,
  ``--pad_gen_frames``): the side-by-side uint8 frames handed to the mp4
  writer within 1 level, on at most 0.1% of the values (f32 rounding at
  the uint8 cut); the mp4s of the same frame count and size, their
  decoded frames within 0.5 level on average (mp4v turns a 1-level input
  change into a few levels around it).
* ``stream_tokens``: the printed schedule and token counts equal, the
  saved z within 1e-5 of JAX's (KL and FSQ); a v1.0 model refused with
  JAX's message.
"""

import numpy as np
import pytest

from tests.test_torch_cli import jax_tokenizers, run_jax, run_port, workdir  # noqa: F401
from vidtok_tpu.data import video_reader as JV
from vidtok_tpu_torch.scripts import inference_reconstruct as PR
from vidtok_tpu_torch.scripts import stream_tokens as PS


def _capture(monkeypatch, module):
    """The frames ``module.write_video`` is handed, kept; the file is written."""
    seen = []
    real = module.write_video

    def write(path, frames, fps=30.0):
        seen.append(np.array(frames))
        real(path, frames, fps)

    monkeypatch.setattr(module, "write_video", write)
    return seen


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    ok, f = cap.read()
    while ok:
        frames.append(f)
        ok, f = cap.read()
    cap.release()
    return np.stack(frames).astype(np.int16)


@pytest.mark.parametrize("flags", [[], ["--read_long_video"], ["--pad_gen_frames"]],
                         ids=["plain", "long", "pad_gen"])
def test_reconstruct(workdir, jax_tokenizers, monkeypatch, flags):
    args = ["--config", workdir / "v1_1.yaml", "--ckpt", workdir / "v1_1.npz",
            "--input_video_path", workdir / "videos" / "clip.mp4", "--input_height", 32,
            "--input_width", 32, "--chunk_size", 8] + flags
    want_frames = _capture(monkeypatch, JV)
    got_frames = _capture(monkeypatch, PR)
    want = run_jax("inference_reconstruct", args + ["--output_video_dir", workdir / "jax"])
    got = run_port(PR, args + ["--output_video_dir", workdir / "port"])
    assert got.splitlines()[0].split(" for ")[1] == want.splitlines()[0].split(" for ")[1]
    (a,), (b,) = got_frames, want_frames
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    assert a.shape[1:] == (32, 64, 3) and a.shape[0] == (33 if "--read_long_video" in flags else 36)
    diff = np.abs(a.astype(np.int16) - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    va, vb = _decode(workdir / "port" / "clip_recon.mp4"), _decode(workdir / "jax" / "clip_recon.mp4")
    assert va.shape == vb.shape == a.shape[:3] + (3,)
    assert np.abs(va - vb).mean() <= 0.5


@pytest.mark.parametrize("cfg", ["v1_1", "fsq"])
def test_stream_tokens(workdir, jax_tokenizers, cfg):
    args = ["--config", workdir / f"{cfg}.yaml", "--ckpt", workdir / f"{cfg}.npz",
            "--input_video_path", workdir / "videos" / "clip.mp4", "--input_height", 32,
            "--input_width", 32, "--chunk_size", 8]
    want = run_jax("stream_tokens", args + ["--out", workdir / f"jax_{cfg}.npz"])
    got = run_port(PS, args + ["--out", workdir / f"port_{cfg}.npz"])
    # every line but the chunks' times
    strip = lambda s: [l.split(": read")[0] + l.split(" ms  z")[-1] for l in s.splitlines()]
    assert strip(got)[:-1] == strip(want)[:-1] and len(strip(got)) == 8
    assert ("tokens=" in got) == (cfg == "fsq")
    a = np.load(workdir / f"port_{cfg}.npz")["z"]
    b = np.load(workdir / f"jax_{cfg}.npz")["z"]
    assert a.dtype == np.float32 and a.shape == b.shape == (1, 4, 17, 16, 16)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_stream_tokens_refuses_v1_0(workdir):
    args = ["--config", workdir / "v1_0.yaml", "--ckpt", workdir / "v1_0.npz",
            "--input_video_path", workdir / "videos" / "clip.mp4"]
    with pytest.raises(SystemExit) as want:
        run_jax("stream_tokens", args)
    with pytest.raises(SystemExit) as got:
        run_port(PS, args)
    assert str(got.value) == str(want.value) == "streaming tokenization requires a v1.1 model"


def test_encode_chunk_is_the_tiled_encode(workdir):
    """The CLIs' attributes match JAX's engine, and the tiled ``encode`` is
    ``encode_chunk`` over the schedule, bit for bit (KL and FSQ)."""
    import torch

    import vidtok_tpu
    from vidtok_tpu_torch import load_model_from_config

    x = np.clip(np.random.RandomState(5).randn(1, 3, 13, 32, 32) * 0.5, -1, 1).astype(np.float32)
    for cfg in ("v1_1", "fsq", "noncausal", "v1_0"):
        args = (str(workdir / f"{cfg}.yaml"),), dict(ckpt=str(workdir / f"{cfg}.npz"))
        tok = load_model_from_config(*args[0], device="cpu", **args[1])
        want = vidtok_tpu.load_model_from_config(*args[0], **args[1])
        assert (tok.is_causal, tok.discrete) == (want.is_causal, want.discrete)
        if cfg not in ("v1_1", "fsq"):
            with pytest.raises(ValueError, match="v1.1|causal model"):
                tok.encode_chunk(x[:, :, :1])
            continue
        tok.use_tiling, tok.t_chunk_enc = True, 4
        z, log = tok.encode(x, return_reg_log=True)
        cache, zs = None, []
        for s, e in tok.build_chunk_start_end(x.shape[2]):
            zc, _, cache = tok.encode_chunk(torch.from_numpy(x[:, :, s:e]), cache)
            zs.append(zc)
        assert torch.equal(torch.cat(zs, dim=2), z) and z.shape[2] == 7
        assert ("indices" in log) == tok.discrete
