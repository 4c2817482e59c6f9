"""The port's video data path (``vidtok_tpu_torch/data``) against
``vidtok_tpu/data``.

* ``sample_frames_with_fps`` equal over drawn totals, fps and starts.
* ``read_frames_at`` bit-equal to JAX's on written clips, through the
  native FFmpeg library and through OpenCV alone.
* ``default_transform`` bit-equal to JAX's Pillow pipeline: downscaling
  (both aspect ratios), upscaling a video smaller than the target, and
  unchanged sizes (no resize, no quantization), on decoded and on
  arbitrary [0, 1] frames.
* ``VidTokValDataset``'s windows and items equal to JAX's (causal and
  non-causal, with and without ``read_long_video``, pre-loaded or not,
  a meta CSV or a directory), ``VidTokDataset``'s items at a fixed
  start, and its refusal of a missing file.
* ``_read_meta`` keeps the rows pandas keeps (bad lines, NA strings,
  short rows, blank lines, quoted commas, pandas' implicit index).
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vidtok_tpu.data import dataset as JD
from vidtok_tpu.data import native_reader as JN
from vidtok_tpu.data import transforms as JT
from vidtok_tpu.data import video_reader as JV
from vidtok_tpu_torch.data import dataset as PD
from vidtok_tpu_torch.data import native_reader as PN
from vidtok_tpu_torch.data import transforms as PT
from vidtok_tpu_torch.data import video_reader as PV

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Two clips of smooth moving content plus noise: 40 frames of 48x64 at
    30 fps and 30 frames of 24x32 at 60 fps (smaller than the targets).
    Widths are multiples of 16: the native library corrupts its heap on
    frames 40 or 90 pixels wide."""
    d = tmp_path_factory.mktemp("videos")
    rng = np.random.RandomState(0)
    for name, (t, h, w, fps) in {"a.mp4": (40, 48, 64, 30), "sub/b.mp4": (30, 24, 32, 60)}.items():
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        frames = np.stack([0.5 + 0.4 * np.sin(6 * (xx + yy) + 0.3 * i)[..., None]
                           * np.array([1.0, 0.6, -0.8]) for i in range(t)])
        frames = np.clip(frames + 0.03 * rng.randn(*frames.shape), 0, 1)
        (d / name).parent.mkdir(exist_ok=True)
        JV.write_video(str(d / name), (frames * 255).astype(np.uint8), fps=fps)
    (d / "meta.csv").write_text("videos,caption\na.mp4,one\nmissing.mp4,two\n"
                                "sub/b.mp4,three,extra\nsub/b.mp4,three\nNA,four\n")
    return d


@settings(max_examples=60, deadline=None)
@given(total=st.integers(1, 400), video_fps=st.sampled_from([23.976, 25.0, 30.0, 59.94, 60.0]),
       n=st.integers(1, 40), sample_fps=st.sampled_from([3, 8, 15, 30]),
       start=st.one_of(st.none(), st.integers(0, 50)), seed=st.integers(0, 1000))
def test_sample_frames_with_fps(total, video_fps, n, sample_fps, start, seed):
    want = JV.sample_frames_with_fps(total, video_fps, n, sample_fps, start,
                                     random.Random(seed))
    got = PV.sample_frames_with_fps(total, video_fps, n, sample_fps, start,
                                    random.Random(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["native", "cv2"])
def test_read_frames_at(videos, backend, monkeypatch):
    if backend == "native":
        assert PN.available() and JN.available()
    else:
        monkeypatch.setattr(JN, "available", lambda: False)
        monkeypatch.setattr(PN, "available", lambda: False)
    for name, ids in (("a.mp4", [0, 3, 3, 17, 39, 45]), ("sub/b.mp4", list(range(0, 30, 2)))):
        path = str(videos / name)
        assert PV.video_info(path) == JV.video_info(path)
        want = JV.read_frames_at(path, ids)
        got = PV.read_frames_at(path, ids)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        frames, idx = PV.read_video_frames(path, 9, 15, start_index=1)
        want_frames, want_idx = JV.read_video_frames(path, 9, 15, start_index=1)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(frames, want_frames)


@pytest.mark.parametrize("shape,target", [
    ((3, 48, 64, 3), (32, 32)),     # down, landscape
    ((2, 64, 40, 3), (24, 24)),     # down, portrait
    ((2, 36, 90, 3), (32, 48)),     # down, crop wider than tall
    ((2, 20, 24, 3), (32, 40)),     # up: smaller than the target
    ((2, 20, 24, 3), (16, 30)),     # down, then padded by the crop
    ((2, 32, 40, 3), (32, 32)),     # unchanged size: crop only
    ((1, 32, 32, 3), (32, 32))])    # unchanged
@pytest.mark.parametrize("quantized", [True, False], ids=["decoded", "any"])
def test_default_transform_bit_equal(shape, target, quantized):
    rng = np.random.RandomState(sum(shape))
    if quantized:
        x = rng.randint(0, 256, shape).astype(np.float32) / 255.0
    else:
        x = rng.rand(*shape).astype(np.float32)
    want = JT.default_transform(x, *target)
    got = PT.default_transform(torch.from_numpy(x), *target)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


VAL_CASES = {
    "causal": dict(sample_num_frames=9),
    "noncausal": dict(sample_num_frames=8, is_causal=False),
    "causal_long": dict(sample_num_frames=9, read_long_video=True, chunk_size=8),
    "noncausal_long": dict(sample_num_frames=8, is_causal=False, read_long_video=True,
                           chunk_size=8),
    "drop_meta": dict(sample_num_frames=12, last_frames_handle="drop", meta=True),
}


@pytest.mark.parametrize("case", sorted(VAL_CASES))
@pytest.mark.parametrize("pre_load", [True, False])
def test_val_dataset(videos, case, pre_load):
    kw = dict(VAL_CASES[case])
    vp = dict(input_height=32, input_width=32, sample_fps=15,
              sample_num_frames=kw.pop("sample_num_frames"))
    if kw.pop("meta", False):
        kw["meta_path"] = str(videos / "meta.csv")
    want = JD.VidTokValDataset(str(videos), vp, pre_load_frames=pre_load, **kw)
    got = PD.VidTokValDataset(str(videos), vp, pre_load_frames=pre_load, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got.frames_batch, want.frames_batch):
        assert (g["video_fp"], g["num_frames_ids"]) == (w["video_fp"], w["num_frames_ids"])
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a["path"] == b["path"]
        np.testing.assert_array_equal(a["jpg"].numpy(), b["jpg"])


def test_train_dataset(videos):
    vp = dict(input_height=32, input_width=40, sample_num_frames=12, sample_fps=15)
    kw = dict(data_dir=str(videos), meta_path=str(videos / "meta.csv"), video_params=vp,
              start_index=0, skip_missing_files=False)
    want, got = JD.VidTokDataset(**kw), PD.VidTokDataset(**kw)
    assert got.paths == want.paths and len(got) == 3
    for i in (0, 2):
        a, b = got[i], want[i]
        assert a["path"] == b["path"]
        np.testing.assert_array_equal(a["jpg"].numpy(), b["jpg"])
    for ds in (want, got):
        with pytest.raises(ValueError, match="missing video"):
            ds[1]


CSVS = {
    "bad_line_and_na": "videos,caption\na.mp4,x\nb.mp4,y,z\nc.mp4,NA\nd.mp4,ok\n\n"
                       "e.mp4,\nf.mp4,\"q,r\"\nNA,g\nnull,h\ng.mp4, NA\nnone,i\n",
    "short_rows": "videos,caption\na.mp4\nb.mp4,x\n   \nc.mp4,n/a\nd.mp4,#N/A\n",
    "one_column": "videos\na.mp4\nNaN\n\nb.mp4,extra\nc.mp4\n\"\"\n",
    "implicit_index": "videos,caption\nk0,b.mp4,y\na.mp4,x\nk2,c.mp4,w\nk3,d.mp4,NA\n",
    "latin1": "videos,caption\ncaf\xe9.mp4,ok\nb.mp4,<NA>\n",
}


@pytest.mark.parametrize("name", sorted(CSVS))
def test_read_meta_keeps_pandas_rows(tmp_path, name):
    path = tmp_path / "meta.csv"
    path.write_bytes(CSVS[name].encode("ISO-8859-1"))
    want = [str(v) for v in JD._read_meta(str(path))["videos"]]
    got = [r["videos"] for r in PD._read_meta(str(path))]
    assert got == want and want
