"""DataModuleFromConfig (``vidtok_tpu/data/datamodule.py``; reference
vidtok/data/datamodule.py:42-150): the train / validation / test loaders
of dataset configs, on :class:`~.pipeline.ThreadedLoader`."""

from __future__ import annotations

from typing import Optional

from ..registry import instantiate_from_config
from .pipeline import ThreadedLoader


class DataModuleFromConfig:
    def __init__(self, batch_size: int, train: Optional[dict] = None,
                 validation: Optional[dict] = None, test: Optional[dict] = None,
                 predict: Optional[dict] = None, num_workers: Optional[int] = None,
                 shuffle_train: bool = True, seed: int = 0, **_):
        self.batch_size = batch_size
        # the reference's default: 2 workers per sample of a batch
        self.num_workers = num_workers if num_workers is not None else batch_size * 2
        self.shuffle_train = shuffle_train
        self.seed = seed
        self.configs = dict(train=train, validation=validation, test=test,
                            predict=predict)
        self.datasets = {}

    def setup(self):
        for split, cfg in self.configs.items():
            if cfg is not None and split not in self.datasets:
                self.datasets[split] = instantiate_from_config(cfg)
        return self

    def _loader(self, split, shuffle, drop_last):
        if split not in self.datasets:
            self.setup()
        if split not in self.datasets:
            return None
        return ThreadedLoader(self.datasets[split], self.batch_size, shuffle=shuffle,
                              num_workers=self.num_workers, seed=self.seed,
                              drop_last=drop_last)

    def train_dataloader(self):
        return self._loader("train", self.shuffle_train, True)

    def val_dataloader(self):
        return self._loader("validation", False, False)

    def test_dataloader(self):
        return self._loader("test", False, False)

    def predict_dataloader(self):
        return self._loader("predict", False, False)
