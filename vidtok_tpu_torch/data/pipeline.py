"""The host input pipeline (``vidtok_tpu/data/pipeline.py``): worker threads
that read a map-style dataset in JAX's index order and batch it, and a
device stage that uploads the next batches ahead of the step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class ThreadedLoader:
    """Batches of a map-style dataset read by ``num_workers`` threads.
    The index stream is JAX's: ``arange(epoch_len or len) % len``, shuffled
    by ``RandomState(seed + epoch)``; ``drop_last`` drops a short last
    batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 epoch_len: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.epoch_len = epoch_len

    def __len__(self):
        n = self.epoch_len or len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def index_stream(self, epoch: int) -> np.ndarray:
        """The dataset indices of ``epoch``, in order, before batching."""
        n = len(self.dataset)
        order = np.arange(self.epoch_len or n) % n
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if self.drop_last:
            order = order[: len(order) // self.batch_size * self.batch_size]
        return order

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        order = self.index_stream(epoch)
        items: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 4)
        done = object()

        def worker(w: int):
            for j in range(w, len(order), self.num_workers):
                try:
                    items.put((j, self.dataset[int(order[j])]))
                except Exception as e:  # raised in order by the consumer
                    items.put((j, e))
            items.put((None, done))

        for w in range(self.num_workers):
            threading.Thread(target=worker, args=(w,), daemon=True).start()
        pending, finished, batch = {}, 0, []
        for j in range(len(order)):
            while j not in pending:
                k, item = items.get()
                if item is done:
                    finished += 1
                    if finished == self.num_workers and j not in pending:
                        raise RuntimeError("loader workers ended early")
                else:
                    pending[k] = item
            item = pending.pop(j)
            if isinstance(item, Exception):
                raise item
            batch.append(item)
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []
        if batch:
            yield collate(batch)


def collate(items):
    """Stack each key's arrays (numpy or torch); other values become lists."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack(vals)
        elif isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


def upload(batch: dict, device, key: str = "jpg") -> dict:
    """``batch[key]`` on ``device``: from pinned host memory without
    blocking when the device is a card."""
    x = batch[key]
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    device = torch.device(device)
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    else:
        x = x.to(device)
    return {**batch, key: x}


def device_prefetch(iterator, put: Callable, depth: int = 2):
    """``put(batch)`` for each batch of ``iterator`` in a thread, ``depth``
    batches ahead of the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()

    def producer():
        try:
            for b in iterator:
                q.put(put(b))
        except Exception as e:
            q.put(e)
        q.put(done)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        b = q.get()
        if b is done:
            return
        if isinstance(b, Exception):
            raise b
        yield b
