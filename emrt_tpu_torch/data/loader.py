"""Host-side data loading (counterpart of ``emrt_tpu/data/loader.py``;
reference src/utils/dataloader.py:22-77 and multi_batch_collate.py).

A deterministic infinite index sampler, sharded by an explicit
``shard_index`` / ``num_shards``; a thread pool that maps it over the numpy
dataset with the JAX package's per-sample generator
``np.random.default_rng((seed, it, idx, k))``, so the two packages load the
same batches bit for bit; and a bounded prefetch queue of host batches that
are copied to the device from pinned memory without blocking. The
sequential val iterator is ``val_batches``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class IterationSampler:
    """Infinite per-shard batch-index stream, reshuffled every epoch.

    Equivalent to IterationBasedBatchSampler(set_epoch per iteration) +
    DistributedBatchSampler sharding (reference dataloader.py:22-77): every
    shard sees a disjoint 1/num_shards slice of each epoch's permutation.
    """

    def __init__(self, num_samples: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
            idx = rng.permutation(self.num_samples)
        else:
            idx = np.arange(self.num_samples)
        # pad to a multiple of (num_shards * batch) so every shard steps equally
        per = self.num_shards * self.batch_size
        if len(idx) % per:
            pad = per - len(idx) % per
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.shard_index::self.num_shards]

    def __iter__(self):
        epoch = 0
        while True:
            idx = self.epoch_indices(epoch)
            for i in range(0, len(idx) - self.batch_size + 1, self.batch_size):
                yield idx[i:i + self.batch_size]
            epoch += 1


class DataLoader:
    """Maps a sampler over a dataset with worker threads and prefetch.

    Yields {"image": float32 [n, 3, H, W], "label": int64 [n, H, W]} on
    ``device`` (None: CPU tensors). ``start_iter`` skips the batches a
    resumed run has already consumed.
    """

    def __init__(self, dataset, batch_size: int, iterations: int | None = None,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 2,
                 prefetch: int = 2, device=None, start_iter: int = 0,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.iterations = iterations
        self.sampler = IterationSampler(len(dataset), batch_size, shuffle=shuffle,
                                        seed=seed, shard_index=shard_index,
                                        num_shards=num_shards)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        self.seed = seed
        self.start_iter = start_iter

    def _load_batch(self, indices: np.ndarray, it: int):
        imgs, labels = [], []
        for k, idx in enumerate(indices):
            rng = np.random.default_rng((self.seed, it, int(idx), k))
            img, label = self.dataset.get(int(idx), rng=rng)
            imgs.append(img)
            labels.append(label)
        batch = {"image": torch.from_numpy(np.stack(imgs)),
                 "label": torch.from_numpy(np.stack(labels).astype(np.int64))}
        if self.device is not None and self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _to_device(self, batch):
        if self.device is not None:
            batch = {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
        batch["image"] = batch["image"].permute(0, 3, 1, 2).contiguous()
        return batch

    def __iter__(self):
        stop = threading.Event()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def producer():
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            try:
                futures = []
                it = self.start_iter
                sampler_iter = iter(self.sampler)
                for _ in range(self.start_iter):     # batches consumed before a resume
                    next(sampler_iter)
                for indices in sampler_iter:
                    if stop.is_set() or (self.iterations is not None
                                         and it >= self.iterations):
                        break
                    futures.append(pool.submit(self._load_batch, indices, it))
                    it += 1
                    while len(futures) >= self.num_workers or (
                            futures and futures[0].done()):
                        q.put(futures.pop(0).result())
                        if stop.is_set():
                            return
                for f in futures:
                    q.put(f.result())
            except Exception as e:          # a failed batch: the consumer raises it
                q.put(e)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield self._to_device(batch)
        finally:
            stop.set()
            while thread.is_alive():        # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def __len__(self):
        if self.iterations is not None:
            return self.iterations - self.start_iter
        return len(self.dataset) // self.batch_size


def val_batches(dataset, batch_size: int, shard_index: int = 0, num_shards: int = 1):
    """Sequential val iteration: yields lists of (img, label) numpy pairs.

    Mirrors the reference's multi_val_fn collate (variable-shape batches as
    python lists, multi_batch_collate.py:17-29). Shard ``shard_index`` of
    ``num_shards`` (a rank of a data-parallel evaluation) gets the batches j
    = shard_index (mod num_shards) of the one-shard sequence, whole, and
    loads no other image: every image is evaluated once, in the batch it
    would have had in one process.
    """
    for start in range(shard_index * batch_size, len(dataset), num_shards * batch_size):
        yield [dataset.get(i) for i in range(start, min(start + batch_size, len(dataset)))]
