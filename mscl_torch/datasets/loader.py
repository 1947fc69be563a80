"""NumpyLoader: host-side assembly of global batches.

Port of ``mscl_tpu/datasets/loader.py`` with its thread workers (the
reference's torch DataLoader + DistributedSampler, re-expressed in the JAX
package as one loader of global batches): a producer thread builds the
batches of an epoch in order into a bounded prefetch queue; with more than
one worker it decodes the samples of a batch on a thread each. The order of
an epoch is ``np.random.default_rng(seed + epoch)``'s permutation.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List

import numpy as np


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of per-sample dicts into a batch dict.

    - np arrays            -> stacked along a new axis 0
    - [q, k] array lists   -> list of stacked arrays (MoCo paired views)
    - ints/floats          -> 1-D arrays
    - anything else        -> list (metadata)
    """
    assert len(samples) > 0
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        v0 = vals[0]
        if isinstance(v0, np.ndarray):
            if v0.shape == (1,) and v0.dtype in (np.int64, np.int32):
                out[key] = np.concatenate(vals)  # labels: (B,)
            else:
                out[key] = np.stack(vals)
        elif isinstance(v0, list) and len(v0) and isinstance(
                v0[0], np.ndarray):
            out[key] = [np.stack([v[i] for v in vals])
                        for i in range(len(v0))]
        elif isinstance(v0, (int, np.integer)):
            out[key] = np.asarray(vals, dtype=np.int64)
        elif isinstance(v0, (float, np.floating)):
            out[key] = np.asarray(vals, dtype=np.float32)
        else:
            out[key] = vals
    return out


class _EpochIterator:

    def __init__(self, loader: 'NumpyLoader', order: np.ndarray):
        self.loader = loader
        self.order = order
        self.batch_size = loader.batch_size
        n = len(order)
        if loader.drop_last:
            self.num_batches = n // self.batch_size
        else:
            self.num_batches = (n + self.batch_size - 1) // self.batch_size
        self._q: 'queue.Queue' = queue.Queue(maxsize=loader.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        self._served = 0

    def _load_one(self, idx):
        return self.loader.dataset[int(idx)]

    def _producer(self):
        try:
            for b in range(self.num_batches):
                if self._stop.is_set():
                    return
                inds = self.order[b * self.batch_size:
                                  (b + 1) * self.batch_size]
                if self.loader.num_workers > 1:
                    samples = [None] * len(inds)

                    def work(slot, i):
                        samples[slot] = self._load_one(i)

                    threads = []
                    for slot, i in enumerate(inds):
                        t = threading.Thread(target=work, args=(slot, i))
                        t.start()
                        threads.append(t)
                    for t in threads:
                        t.join()
                else:
                    samples = [self._load_one(i) for i in inds]
                batch = self.loader.collate_fn(samples)
                # timeout-put loop so a producer blocked on a full queue
                # still observes close() (no daemon-thread leak)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface worker errors to the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __len__(self):
        return self.num_batches

    def __next__(self):
        if self._served >= self.num_batches:
            raise StopIteration
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        self._served += 1
        return item

    def close(self):
        """Stop the producer (it sees the flag within half a second, also
        when blocked on a full queue)."""
        self._stop.set()


class NumpyLoader:
    """Iterable over global batches; reshuffles per epoch with a
    deterministic seed (DistributedSampler set_epoch semantics,
    reference samplers/distributed_sampler.py:12-48)."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=None,
                 drop_last=False, num_workers=0, prefetch=2,
                 collate_fn=default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = 0 if seed is None else seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.collate_fn = collate_fn
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if getattr(self.dataset, 'sample_by_class', False) and self.shuffle:
            raise NotImplementedError('the class-balanced sampler is not '
                                      'ported')
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        return _EpochIterator(self, order)
