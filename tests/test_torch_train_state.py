"""The port's train state, data pipeline and activation checkpointing on
the CPU:

* Train-state checkpoints: two steps, a save, a third step; the file
  restored into another trainer and its third step are bit-equal to the
  run that continued (every parameter, buffer, Adam moment, the EMA, the
  LeCAM EMAs and the logs). Retention against ``vidtok_tpu``'s
  ``save_train_state`` over the same saves (newest 3 without a monitor;
  the best 3 by monitor plus the newest with one), ``latest_checkpoint``
  and ``best_checkpoint`` likewise.
* ``ThreadedLoader``: the index stream and every batch equal to JAX's for
  3 seeds x 2 epochs, shuffled or not, with and without ``drop_last``;
  ``device_prefetch`` keeps the order; ``DataModuleFromConfig`` resolves
  the reference's dotted targets through the registry.
* Activation checkpointing (``use_checkpoint``): ``forward_train``'s
  outputs and every parameter's gradient equal with and without it
  (rtol 1e-6, atol 1e-7), as ``tests/test_remat.py`` holds JAX.
* The loggers write their JSONL, PNG and GIF files.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_train_common import clip, config
from vidtok_tpu_torch.data.pipeline import ThreadedLoader, device_prefetch, upload
from vidtok_tpu_torch.train.trainer import VidTokTrainer
from vidtok_tpu_torch.utils import checkpoint as C

torch.set_num_threads(2)


def trainer():
    return VidTokTrainer(config("fsq", "3d", lecam_loss_weight=0.1), device="cpu",
                         seed=5).init_state()


def test_resume_is_bit_equal(tmp_path):
    x = torch.from_numpy(clip(1, (1, 5, 16, 16, 3)))
    a = trainer()
    for _ in range(2):
        a.fit_step(x)
    path = C.save_train_state(str(tmp_path), a, a.step)
    logs_a = a.fit_step(x)
    # a fresh trainer (the same LPIPS weights, which are not train state)
    # moved off by a step of its own, then restored
    b = trainer()
    b.fit_step(-x)
    assert C.restore_train_state(path, b) == 2
    logs_b = b.fit_step(x)
    assert b.step == a.step == 3
    for k in logs_a:
        assert torch.equal(logs_a[k], logs_b[k]), k
    sa, sb = a.state_dict(), b.state_dict()
    for part in ("core", "disc"):
        for k, v in sa[part].items():
            assert torch.equal(v, sb[part][k]), (part, k)
    for k, v in sa["ema"]["core"].items():
        assert torch.equal(v, sb["ema"]["core"][k]), k
    assert torch.equal(sa["lecam"], sb["lecam"]) and torch.equal(sa["logvar"], sb["logvar"])
    for opt in ("opt_g", "opt_d"):
        for i, st in sa[opt]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb[opt]["state"][i][k]), (opt, i, k)


class _Tiny:
    """A stand-in trainer whose state is one tensor."""

    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step, "w": torch.full((2,), float(self.step))}


def test_retention_matches_jax(tmp_path):
    import jax.numpy as jnp

    from vidtok_tpu.utils import checkpoint as J

    saves = [(1, None), (2, None), (3, None), (4, None), (5, 0.5), (6, 0.2), (7, 0.9),
             (8, 0.3), (9, None), (10, 0.1)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    for step, mon in saves:
        J.save_train_state(jdir, {"w": jnp.full((2,), step, jnp.float32)}, step,
                           monitor_value=mon)
        C.save_train_state(tdir, _Tiny(step), step, monitor_value=mon)
        assert sorted(C.all_checkpoint_steps(tdir)) == sorted(J.all_checkpoint_steps(jdir))
        assert C.load_monitor_ledger(tdir) == J.load_monitor_ledger(jdir)
        assert C.latest_checkpoint(tdir)[1] == J.latest_checkpoint(jdir)[1]
        assert C.best_checkpoint(tdir)[1] == J.best_checkpoint(jdir)[1]
    assert sorted(C.all_checkpoint_steps(tdir)) == [6, 8, 10]
    path, step = C.best_checkpoint(tdir)
    assert step == 10 and torch.load(path, weights_only=True)["w"][0] == 10


class _Items:
    """A map-style dataset of numbered arrays."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"jpg": np.full((2, 3), i, np.float32), "path": f"v{i}.mp4"}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (True, False)])
def test_loader_matches_jax(shuffle, drop_last):
    from vidtok_tpu.data.pipeline import ThreadedLoader as JLoader

    ds = _Items(11)
    for seed in (0, 1, 7):
        kw = dict(batch_size=3, shuffle=shuffle, num_workers=3, seed=seed, drop_last=drop_last)
        jl, tl = JLoader(ds, **kw), ThreadedLoader(ds, **kw)
        assert len(jl) == len(tl)
        for epoch in (0, 1):
            want = list(jl.epoch(epoch))
            got = list(tl.epoch(epoch))
            order = jl._index_stream(epoch)
            n = len(order) // 3 * 3 if drop_last else len(order)
            np.testing.assert_array_equal(tl.index_stream(epoch), order[:n])
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["jpg"], w["jpg"])
                assert g["path"] == w["path"]
            prefetched = list(device_prefetch(tl.epoch(epoch), lambda b: upload(b, "cpu")))
            for g, w in zip(prefetched, want):
                assert torch.equal(g["jpg"], torch.from_numpy(w["jpg"]))


def test_datamodule_from_reference_config(tmp_path):
    from vidtok_tpu_torch.data.datamodule import DataModuleFromConfig
    from vidtok_tpu_torch.data.dataset import VidTokDataset
    from vidtok_tpu_torch.registry import instantiate_from_config

    (tmp_path / "meta.csv").write_text("videos\na.mp4\n")
    vp = {"input_height": 16, "input_width": 16, "sample_num_frames": 5, "sample_fps": 8}
    dm = instantiate_from_config({
        "target": "vidtok.data.datamodule.DataModuleFromConfig",
        "params": {"batch_size": 2, "train": {
            "target": "vidtok.data.vidtok.VidTokDataset",
            "params": {"data_dir": str(tmp_path), "meta_path": str(tmp_path / "meta.csv"),
                       "video_params": vp}}}}).setup()
    assert isinstance(dm, DataModuleFromConfig) and dm.num_workers == 4
    assert isinstance(dm.datasets["train"], VidTokDataset)
    assert dm.val_dataloader() is None and dm.train_dataloader().batch_size == 2


def test_remat_equal():
    x = torch.from_numpy(clip(2, (1, 5, 16, 16, 3)))
    runs = []
    for remat in (False, True):
        tr = VidTokTrainer(config("kl", "2d", use_checkpoint=remat), device="cpu",
                           seed=3).init_state()
        assert tr.core.encoder.use_checkpoint == tr.core.decoder.use_checkpoint == remat
        z, xrec, pre, log = tr.core.forward_train(x)
        (xrec.square().sum() + 0.1 * z.square().sum() + pre.mean() + log["kl_loss"]).backward()
        runs.append(((z, xrec, pre), {n: p.grad for n, p in tr.core.named_parameters()}))
    (outs0, g0), (outs1, g1) = runs
    for a, b in zip(outs0, outs1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
    assert set(g0) == set(g1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7, msg=n)


def test_loggers(tmp_path):
    from vidtok_tpu_torch.utils.logging import ImageVideoLogger, MetricLogger

    m = MetricLogger(str(tmp_path), use_tensorboard=False)
    m.log_scalars(3, {"train/aeloss": torch.tensor(1.5)})
    m.close()
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert rows[0]["step"] == 3 and rows[0]["train/aeloss"] == 1.5
    img = ImageVideoLogger(str(tmp_path), batch_frequency=4, increase_log_steps=True)
    assert [s for s in range(9) if img.should_log(s)] == [1, 2, 4, 8]
    v = clip(3, (1, 3, 8, 8, 3))
    img.log(4, v, -v)
    assert sorted(os.listdir(tmp_path / "images")) == ["train_gs00000004_b0.gif",
                                                       "train_gs00000004_b0.png"]


@pytest.mark.parametrize("path,batch", [
    ("vidtok_kl_causal_488_16chn.yaml", "TRAIN_BATCH"),
    ("vidtok_fsq_causal_488_4096.yaml", "TRAIN_BATCH"),
    ("v1_1/vidtok_kl_causal_488_16chn_v1_1.yaml", "TRAIN_BATCH_V1_1")])
def test_chip_smoke_train_recipe_is_the_files(path, batch):
    """``chip_smoke`` phase 15 trains at the configs' own recipe: their
    loss section (``disc_start`` 0 aside), learning rate, precision, remat
    and clip, batch size, frames and frame size."""
    import chip_smoke as cs
    from chip_smoke import training
    from vidtok_tpu_torch.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", path))
    ours = training.train_cfg(cs.V1_0_CFG)
    want = cfg["model"]["params"]["loss_config"]
    assert ours["model"]["params"]["loss_config"] == dict(
        want, params=dict(want["params"], disc_start=0))
    assert ours["model"]["base_learning_rate"] == cfg["model"]["base_learning_rate"]
    for key in ("precision", "use_checkpoint", "grad_clip"):
        assert ours["training"][key] == cfg["training"][key], key
    data = cfg["data"]["params"]
    vp = data["train"]["params"]["video_params"]
    assert getattr(training, batch) == (data["batch_size"], vp["sample_num_frames"],
                                  vp["input_height"], vp["input_width"], 3)


def test_init_from_reference_ckpt(tmp_path):
    """``model.params.ckpt_path`` (the reference's fine-tune workflow): a
    Lightning-style ``.ckpt`` gives the core (less ``ignore_keys``: those
    keep the seed's weights), the discriminator (``loss.discriminator.*``,
    by the reference's module names) and ``loss.logvar``."""
    src = VidTokTrainer(config("kl", "2d"), device="cpu", seed=11).init_state()
    sd = {**{k: v for k, v in src.core.state_dict().items()},
          **{f"loss.discriminator.{k}": v for k, v in src.disc.state_dict().items()},
          "loss.logvar": torch.tensor(0.7)}
    torch.save({"state_dict": sd, "global_step": 9}, tmp_path / "ref.ckpt")
    cfg = config("kl", "2d")
    cfg["model"]["params"].update(ckpt_path=str(tmp_path / "ref.ckpt"),
                                  ignore_keys=["decoder.conv_out"])
    tr = VidTokTrainer(cfg, device="cpu", seed=12).init_state()
    fresh = VidTokTrainer(config("kl", "2d"), device="cpu", seed=12).init_state()
    for k, v in tr.core.state_dict().items():
        want = (fresh if k.startswith("decoder.conv_out") else src).core.state_dict()[k]
        assert torch.equal(v, want), k
    for k, v in tr.disc.state_dict().items():
        assert torch.equal(v, src.disc.state_dict()[k]), k
    assert float(tr.logvar) == pytest.approx(0.7)
