"""Input pipeline: threaded prefetching loader with padded dense batches
(port of mm_distillnet_tpu/data/loader.py; numpy only).

Stands where the reference has torch DataLoader(num_workers, pin_memory,
custom_collate, DistributedSampler) (reference
src/optimization/traditional.py:57-80, src/datasets/utils.py:90-120): a
thread-pool loader that:
- shards the index space across processes (DistributedSampler
  semantics: rank r takes indices r::world_size after an epoch-seeded
  shuffle, drop_last); every rank gets len // world_size indices, so that
  the ranks take the same number of steps (the JAX loader gives the first
  len % world_size ranks one more, and a rank with a batch more than the
  others would wait forever in its step's collectives);
- collates samples into dense NHWC numpy batches with labels padded to
  (B, max_gt, 5) using -1 label markers (the focal loss contract);
- prefetches a configurable number of batches ahead so host IO overlaps
  device compute.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict], max_gt: int = 64) -> Dict[str, np.ndarray]:
    batch: Dict[str, np.ndarray] = {}
    for key in ('rgb', 'thermal', 'depth', 'audio'):
        vals = [s.get(key) for s in samples]
        if any(v is None for v in vals):
            continue
        batch[key] = np.stack(vals).astype(np.float32)
    labels = np.full((len(samples), max_gt, 5), -1.0, np.float32)
    labels[..., :4] = 0.0
    has_labels = False
    for i, s in enumerate(samples):
        lab = s.get('label')
        if lab is None or len(lab) == 0:
            continue
        has_labels = True
        lab = np.asarray(lab, np.float32)[:max_gt]
        labels[i, :lab.shape[0]] = lab
    batch['label'] = labels if has_labels else labels  # always dense
    batch['id'] = [s['id'] for s in samples]
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = True,
                 max_gt: int = 64, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.max_gt = max_gt
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """DistributedSampler.set_epoch equivalent."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        idx = idx[self.process_index::self.process_count][:self._share()]
        if self.drop_last:
            usable = (len(idx) // self.batch_size) * self.batch_size
            idx = idx[:usable]
        return idx

    def _share(self) -> int:
        """Indices per rank: all of them for one process, else an equal
        share."""
        n = len(self.dataset)
        return n if self.process_count == 1 else n // self.process_count

    def __len__(self) -> int:
        idx_len = self._share()
        if self.drop_last:
            return idx_len // self.batch_size
        return (idx_len + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]

        def load_batch(batch_idx):
            samples = [self.dataset[int(i)] for i in batch_idx]
            return collate(samples, self.max_gt)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(batches)
            for _ in range(self.prefetch + 1):
                b = next(it, None)
                if b is not None:
                    pending.append(pool.submit(load_batch, b))
            while pending:
                fut = pending.pop(0)
                b = next(it, None)
                if b is not None:
                    pending.append(pool.submit(load_batch, b))
                yield fut.result()
