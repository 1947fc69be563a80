"""NumpyLoader: host-side assembly of global batches.

Port of ``mscl_tpu/datasets/loader.py`` (the reference's torch DataLoader +
DistributedSampler, re-expressed in the JAX package as one loader of global
batches): a producer thread emits the batches of an epoch in order into a
bounded prefetch queue. With ``workers_mode='thread'`` and more than one
worker it decodes the samples of a batch on a thread each; with
``workers_mode='process'`` a pool of decode processes makes whole batches,
``workers + prefetch`` of them in flight. The order of an epoch is
``np.random.default_rng(seed + epoch)``'s permutation, or its draws of
the class-balanced or the PK sampler (``epoch_order``).

Data parallel (``world`` > 1, one loader a rank): ``batch_size`` is the
global batch and ``len`` counts global batches. Every rank draws the same
order and decodes only its own rows of each global batch, rows
``[rank * L, (rank + 1) * L)`` of ``L = batch_size / world``. A short last
batch must divide over the ranks, unless ``pad_last``: then it is tiled to
the full global batch (the JAX package's eval padding, at the index level),
and the caller trims the gathered rows. Process workers take seeds
``seed + rank * workers + worker_id``, distinct over the ranks.

The JAX package's host decodes the whole global batch and the mesh shards
it, so its host crop draws are one stream; here each rank's host draws its
own rows' crops (thread workers from the rank's global numpy generator,
process workers from their seeds), so they differ from one device's. The
host data path is already what bounds an iteration, and decoding the whole
global batch on every rank would multiply it by the world size.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import random
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

# how long _EpochIterator.close() waits for its producer to end
CLOSE_TIMEOUT_S = 60.0


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


def _pool_worker_main(dataset, task_q, result_q, seed, worker_id):
    """Decode-worker loop. Reseeds numpy's and Python's generators with
    ``seed + worker_id``, as the reference's worker_init_fn does, so the
    stochastic transforms of the workers differ. A task is a whole batch,
    tagged with its epoch's generation, so results of an abandoned epoch
    are never taken for the next epoch's batches.

    A worker runs only the dataset's numpy pipeline (and the ctypes PNG row
    unfilter): never a torch op, never CUDA. The devices are hidden before
    anything in the child could look for them (a ``forkserver`` or
    ``spawn`` child imports torch afresh), and a ``fork`` child of a parent
    that already holds a CUDA context cannot reach it: torch refuses CUDA
    in a forked child, so a stray call fails loudly there instead of
    sharing the parent's context."""
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    np.random.seed((seed + worker_id) % (2 ** 32))
    random.seed(seed + worker_id)
    while True:
        task = task_q.get()
        if task is None:
            return
        gen, bid, inds = task
        try:
            result_q.put((gen, bid, [dataset[int(i)] for i in inds]))
        except BaseException as e:  # surface to the consumer
            result_q.put((gen, bid, RuntimeError(
                f'decode worker {worker_id} failed on batch {bid}: '
                f'{type(e).__name__}: {e}')))


def _route_result(result_q, gen: int, pending: Dict[int, Any],
                  timeout: float = 0.5) -> None:
    """Pop one result and route it by generation tag.

    - rgen == gen: this epoch's batch -> pending.
    - rgen <  gen: an abandoned epoch's leftover -> dropped.
    - rgen >  gen: a newer epoch's result popped by this (closing) epoch's
      lingering producer -> re-queued, so that the newer epoch's in-order
      emit finds it; dropping it would hang that epoch."""
    try:
        rgen, bid, payload = result_q.get(timeout=timeout)
    except queue.Empty:
        return
    if rgen == gen:
        pending[bid] = payload
    elif rgen > gen:
        result_q.put((rgen, bid, payload))
        time.sleep(0.02)   # yield so the newer epoch's thread wins the re-get


class _ProcessPool:
    """Decode-worker processes: the numpy pipelines of a batch run outside
    the trainer's GIL.

    Start method: 'fork' by default. It inherits the dataset without
    pickling it, and is safe in a trainer that already drives the card
    because a child runs pure numpy (see ``_pool_worker_main``) and the
    host C unfilter is loaded here first, so no child compiles it or waits
    on its loader's lock. A parent with other threads can in principle hold
    some other lock at the fork; 'forkserver' or 'spawn' (``mp_context``)
    avoid that when the dataset pickles."""

    def __init__(self, dataset, num_workers: int, seed: int,
                 mp_context: str = 'fork'):
        """Worker w reseeds with ``seed + w``."""
        from ..utils import image_io
        image_io._unfilter_lib()
        ctx = multiprocessing.get_context(mp_context)
        self.task_q = ctx.Queue()
        self.result_q = ctx.Queue()
        self.generation = 0
        self.workers = []
        for wid in range(num_workers):
            p = ctx.Process(target=_pool_worker_main,
                            args=(dataset, self.task_q, self.result_q,
                                  seed, wid),
                            daemon=True)
            p.start()
            self.workers.append(p)

    def shutdown(self):
        for _ in self.workers:
            try:
                self.task_q.put(None)
            except Exception:
                pass
        for p in self.workers:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        self.workers = []
        for q in (self.task_q, self.result_q):
            q.close()
            q.cancel_join_thread()


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
        target = (self._producer_pool
                  if loader.workers_mode == 'process' and
                  loader.num_workers > 0 else self._producer)
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        self._served = 0

    def _load_one(self, idx):
        return self.loader.dataset[int(idx)]

    def _put(self, batch):
        # timeout-put loop so a producer blocked on a full queue still
        # observes close() (no daemon-thread leak)
        while not self._stop.is_set():
            try:
                self._q.put(batch, timeout=0.5)
                return
            except queue.Full:
                continue

    def _producer_pool(self):
        """Dispatch batches to the process pool and emit the results in
        order. Each epoch bumps the pool's generation; results tagged with
        an older one (an abandoned epoch's leftovers) are dropped."""
        try:
            pool = self.loader._get_pool()
            pool.generation += 1
            gen = pool.generation
            max_out = len(pool.workers) + self.loader.prefetch
            pending: Dict[int, Any] = {}
            next_submit = next_emit = 0
            while next_emit < self.num_batches:
                while (next_submit < self.num_batches and
                       next_submit - next_emit < max_out):
                    inds = self.loader.rank_indices(
                        self.order[next_submit * self.batch_size:
                                   (next_submit + 1) * self.batch_size])
                    pool.task_q.put((gen, next_submit,
                                     list(map(int, inds))))
                    next_submit += 1
                while next_emit not in pending:
                    if self._stop.is_set():
                        return
                    _route_result(pool.result_q, gen, pending)
                payload = pending.pop(next_emit)
                if isinstance(payload, BaseException):
                    raise payload
                batch = self.loader.collate_fn(payload)
                next_emit += 1
                self._put(batch)
        except BaseException as e:
            self._put(e)

    def _producer(self):
        try:
            for b in range(self.num_batches):
                if self._stop.is_set():
                    return
                inds = self.loader.rank_indices(
                    self.order[b * self.batch_size:
                               (b + 1) * self.batch_size])
                if self.loader.num_workers > 1:
                    samples, errors = [None] * len(inds), []

                    def work(slot, i):
                        try:
                            samples[slot] = self._load_one(i)
                        except BaseException as e:  # raised below, in order
                            errors.append((slot, e))

                    threads = []
                    for slot, i in enumerate(inds):
                        t = threading.Thread(target=work, args=(slot, i))
                        t.start()
                        threads.append(t)
                    for t in threads:
                        t.join()
                    if errors:
                        raise min(errors, key=lambda se: se[0])[1]
                else:
                    samples = [self._load_one(i) for i in inds]
                self._put(self.loader.collate_fn(samples))
        except BaseException as e:  # surface worker errors to the consumer
            self._put(e)

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
        """Stop the producer and wait for it to end. It sees the flag
        within half a second when blocked on a full queue, and after the
        batch it is decoding otherwise; until it ends it may still draw
        from the global ``random`` and ``np.random`` generators, so the
        caller's next draws are its own only once this returns. Raises if
        the producer has not ended within CLOSE_TIMEOUT_S seconds."""
        self._stop.set()
        self._thread.join(CLOSE_TIMEOUT_S)
        if self._thread.is_alive():
            raise RuntimeError(f'the producer of the loader did not stop '
                               f'within {CLOSE_TIMEOUT_S} s of close()')


class NumpyLoader:
    """Iterable over global batches; reshuffles per epoch with a
    deterministic seed (DistributedSampler set_epoch semantics,
    reference samplers/distributed_sampler.py:12-48)."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=None,
                 drop_last=False, num_workers=0, prefetch=2,
                 collate_fn=default_collate, workers_mode='thread',
                 mp_context='fork', world=1, rank=0, pad_last=False,
                 sampler=None):
        assert workers_mode in ('thread', 'process'), workers_mode
        if batch_size % world:
            raise ValueError(f'a global batch of {batch_size} does not '
                             f'divide over {world} ranks')
        self.world, self.rank, self.pad_last = world, rank, pad_last
        self.workers_mode = workers_mode
        self.mp_context = mp_context
        self._pool: Optional[_ProcessPool] = None
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = 0 if seed is None else seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.collate_fn = collate_fn
        self.sampler = dict(sampler) if sampler else None
        self.epoch = 0

    def _get_pool(self) -> _ProcessPool:
        if self._pool is None or not self._pool.workers:
            self._pool = _ProcessPool(
                self.dataset, self.num_workers,
                self.seed + self.rank * self.num_workers, self.mp_context)
        return self._pool

    def rank_indices(self, inds: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch's dataset indices."""
        if self.world == 1:
            return inds
        n = len(inds)
        if n < self.batch_size and self.pad_last:
            inds = np.tile(inds, -(-self.batch_size // n))[:self.batch_size]
        elif n % self.world:
            raise ValueError(f'a global batch of {n} does not divide over '
                             f'{self.world} ranks (drop the last batch or '
                             f'choose a dataset size the world divides)')
        per = len(inds) // self.world
        return inds[self.rank * per:(self.rank + 1) * per]

    def shutdown(self):
        """Stop the decode processes (a later epoch starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _class_balanced_order(self, rng) -> np.ndarray:
        """ClassSpecificDistributedSampler (reference
        samplers/distributed_sampler.py:50-140, mscl_tpu's
        ``_class_balanced_order``): ``len(dataset)`` draws of a class with
        probability proportional to its size ** ``power`` (0: uniform over
        the classes), each then of one of its videos, uniformly."""
        by_class = self.dataset.video_infos_by_class
        labels = sorted(by_class)
        freqs = np.array([len(by_class[c]) for c in labels], np.float64)
        probs = freqs ** getattr(self.dataset, 'power', 0.0)
        probs = probs / probs.sum()
        class_indices = {c: [] for c in labels}
        for i, info in enumerate(self.dataset.video_infos):
            class_indices[info['label']].append(i)
        chosen = rng.choice(len(labels), size=len(self.dataset), p=probs)
        return np.array([
            class_indices[labels[c]][rng.integers(
                len(class_indices[labels[c]]))] for c in chosen])

    def _pk_order(self, rng, pk_sample_num: int) -> np.ndarray:
        """PKDistributedSampler (reference
        samplers/distributed_sampler.py:141-201, reid; mscl_tpu's
        ``_pk_order``): each anchor of the (shuffled) order followed by
        ``pk_sample_num`` - 1 other videos of its class, drawn with
        replacement only when the class has too few (the anchor itself
        when it is alone)."""
        labels = [info['label'] for info in self.dataset.video_infos]
        class_indices: Dict[Any, list] = {}
        for i, lab in enumerate(labels):
            class_indices.setdefault(lab, []).append(i)
        base = rng.permutation(len(labels)) if self.shuffle else \
            np.arange(len(labels))
        order = []
        k = pk_sample_num - 1
        for ind in base:
            order.append(ind)
            pool = [i for i in class_indices[labels[ind]] if i != ind]
            if pool:
                extra = rng.choice(pool, size=k, replace=len(pool) < k)
                order.extend(int(x) for x in extra)
            else:
                order.extend([int(ind)] * k)
        return np.asarray(order)

    def epoch_order(self) -> np.ndarray:
        """The dataset indices of this epoch, from
        ``np.random.default_rng(seed + epoch)``: the PK order for a
        ``PKSampler`` / ``PKDistributedSampler`` (``pk_sample_num`` a
        video, default 2), the class-balanced one for a dataset with
        ``sample_by_class`` when shuffling, else a permutation (or, not
        shuffling, the dataset's order). Another sampler type is read as
        none, as the JAX loader reads it."""
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.sampler and self.sampler.get('type') in (
                'PKDistributedSampler', 'PKSampler'):
            return self._pk_order(rng, self.sampler.get('pk_sample_num', 2))
        if getattr(self.dataset, 'sample_by_class', False) and self.shuffle:
            return self._class_balanced_order(rng)
        return rng.permutation(n) if self.shuffle else np.arange(n)

    def __iter__(self):
        return _EpochIterator(self, self.epoch_order())
