"""Dataset protocol, collation and the threaded loader (counterpart of
``zeroshape_tpu/data/base.py``).

The loader yields batches of numpy arrays (NHWC), decoded on a thread pool
with a bounded prefetch queue so host IO overlaps the device's steps. Under
several processes each rank yields its contiguous slice of every global
batch (``:121-155``): an uneven tail is padded to the full global batch with
repeats of its last row, so the valid rows stay a global prefix, and rank
``r`` takes rows ``[r * local, (r + 1) * local)``. Rank and world come from
``torch.distributed`` where it is initialised. With ``pin_memory`` the
producer thread also copies each batch's float arrays into pinned host
tensors, which ``runtime.shape_engine.to_device`` copies to the card
without blocking.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zeroshape_tpu_torch.parallel import dist


class Dataset:
    """``__len__`` + ``__getitem__`` -> a dict of numpy arrays; ``set_epoch``
    keys per-sample randomness (the SDF subsample) on the epoch."""

    def __init__(self, opt, split="train"):
        self.opt = opt
        self.split = split
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError

    def setup_loader(self, opt, shuffle=False, drop_last=False, batch_size=None, pin_memory=False):
        """The loader of a run: ``opt.batch_size`` (or ``batch_size``) is the
        global batch, sliced over the ranks of the process group."""
        return DataLoader(self, batch_size=batch_size or opt.batch_size, shuffle=shuffle, drop_last=drop_last,
                          num_workers=(opt.get("data") or {}).get("num_workers", 4), seed=opt.get("seed", 0) or 0,
                          process_index=dist.rank(), process_count=dist.world(), pin_memory=pin_memory)


def default_collate(samples):
    """Stack leaf arrays; nested dicts recurse; strings become lists."""
    out = {}
    for key, val in samples[0].items():
        vals = [s[key] for s in samples]
        if isinstance(val, dict):
            out[key] = default_collate(vals)
        elif isinstance(val, str):
            out[key] = list(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
    return out


def pin(batch):
    """The float32 arrays of ``batch`` (recursively) as pinned CPU tensors."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = pin(v)
        elif isinstance(v, np.ndarray) and v.dtype == np.float32:
            out[k] = torch.from_numpy(v).pin_memory()
        else:
            out[k] = v
    return out


class DataLoader:
    """Epoch-based loader: shuffle -> batch -> rank slice -> threaded decode -> prefetch.

    ``dataset`` is any sequence of sample dicts (a :class:`Dataset` or a
    list). :meth:`epoch` walks one epoch from a given batch on; ``wait``
    accumulates the seconds the consumer spent waiting for a batch.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False, num_workers=4, seed=0, prefetch=2,
                 collate=default_collate, process_index=0, process_count=1, pin_memory=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.collate = collate
        self.process_index = process_index
        self.process_count = process_count
        self.pin_memory = pin_memory
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(f"global batch_size {batch_size} must divide evenly over {process_count} processes")
        self._epoch = 0
        self.wait = 0.0

    def set_epoch(self, epoch):
        """Reshuffle for ``epoch`` and hand it to the dataset's per-sample randomness."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed * 100003 + self._epoch).shuffle(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start: start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            if self.process_count > 1:
                if len(idx) < self.batch_size:
                    idx = np.concatenate([idx, np.repeat(idx[-1], self.batch_size - len(idx))])
                local = len(idx) // self.process_count
                idx = idx[self.process_index * local: (self.process_index + 1) * local]
            batches.append(idx)
        return batches

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        return self.epoch()

    def epoch(self, skip=0):
        """The batches of the current epoch from batch ``skip`` on (the ones
        before it are never loaded)."""
        batches = self._batch_indices()[skip:]
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_batch(idx):
            batch = self.collate(list(pool.map(self.dataset.__getitem__, idx.tolist())))
            return pin(batch) if self.pin_memory else batch

        def put_or_stop(item):
            # a bounded put that gives up once the consumer abandons the iterator
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx in batches:
                    if stop.is_set() or not put_or_stop(load_batch(idx)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put_or_stop(e)
            finally:
                put_or_stop(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait += time.perf_counter() - t0
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)
