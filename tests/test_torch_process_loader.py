"""The port's loader with decode processes (``workers_mode='process'``):
the port's copies of tests/test_misc_datasets.py's process-pool tests
(batches in order and complete, pool reuse and shutdown, a worker's error
reaching the consumer, ``_route_result``'s generations, forkserver, an
abandoned epoch's leftovers), and the flagship train pipeline through one
decode process against mscl_tpu's loader in the same mode, bitwise."""
import copy
import multiprocessing
import queue

import numpy as np
import pytest

from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.datasets import build_dataloader
from mscl_torch.datasets.loader import NumpyLoader, _route_result
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.datasets.loader import NumpyLoader as JaxNumpyLoader

from _torch_data_util import write_videos
from _torch_loader_util import Items
from test_torch_pipelines import CFG, _small, assert_same


def _labels(batches):
    return np.concatenate([b['label'] for b in batches])


def test_batches_in_order_and_complete():
    loader = NumpyLoader(Items(), batch_size=3, shuffle=False, num_workers=2,
                         workers_mode='process', drop_last=False)
    try:
        batches = list(iter(loader))
        assert len(batches) == 4
        np.testing.assert_array_equal(_labels(batches), np.arange(10))
        np.testing.assert_array_equal(batches[1]['imgs'][:, 0, 0], [3, 4, 5])
        pool = loader._pool
        loader.set_epoch(1)            # the second epoch reuses the pool
        assert len(list(iter(loader))) == 4
        assert loader._pool is pool and pool.generation == 2
        workers = list(pool.workers)
    finally:
        loader.shutdown()
    assert loader._pool is None
    assert not any(p.is_alive() for p in workers)


def test_worker_error_propagates():
    loader = NumpyLoader(Items(bad=4), batch_size=5, shuffle=False,
                         num_workers=2, workers_mode='process')
    try:
        with pytest.raises(RuntimeError, match='batch 0: ValueError: boom'):
            list(iter(loader))
    finally:
        loader.shutdown()


def test_route_result_by_generation():
    """A newer epoch's result is put back (dropping it would hang that
    epoch's in-order emit), an older one's dropped, this epoch's kept."""
    rq = queue.Queue()
    pending = {}
    rq.put((5, 0, 'newer'))
    _route_result(rq, 4, pending, timeout=0.01)
    assert pending == {} and rq.get_nowait() == (5, 0, 'newer')
    rq.put((3, 0, 'stale'))
    _route_result(rq, 4, pending, timeout=0.01)
    assert pending == {} and rq.empty()
    rq.put((4, 2, 'mine'))
    _route_result(rq, 4, pending, timeout=0.01)
    assert pending == {2: 'mine'} and rq.empty()


def test_forkserver_context():
    loader = NumpyLoader(Items(), batch_size=5, shuffle=False, num_workers=1,
                         workers_mode='process', mp_context='forkserver')
    try:
        batches = list(iter(loader))
        assert len(batches) == 2
        np.testing.assert_array_equal(_labels(batches), np.arange(10))
    finally:
        loader.shutdown()


def test_abandoned_epoch_leftovers_discarded():
    loader = NumpyLoader(Items(), batch_size=2, shuffle=True, seed=7,
                         num_workers=2, workers_mode='process')
    try:
        it0 = iter(loader)
        next(it0)                      # one batch, then the epoch is left
        it0.close()
        loader.set_epoch(1)
        got = _labels(list(iter(loader)))
        np.testing.assert_array_equal(
            got, np.random.default_rng(7 + 1).permutation(10))
    finally:
        loader.shutdown()


def test_build_dataloader_passes_the_mode():
    loader = build_dataloader(Items(), videos_per_gpu=5, workers_per_gpu=2,
                              shuffle=False, workers_mode='process')
    try:
        assert loader.workers_mode == 'process'
        np.testing.assert_array_equal(_labels(list(loader)), np.arange(10))
        assert len(loader._pool.workers) == 2
    finally:
        loader.shutdown()
    assert not multiprocessing.active_children()


def test_one_worker_matches_jax_process_mode(tmp_path):
    """The flagship train pipeline (MDS sampling, FRA, MoCo crops, cut to
    16x16 crops) in one decode process each: the worker reseeds numpy and
    Python from seed + 0, so both loaders draw the same clips and crops."""
    pkl = write_videos(str(tmp_path), 4, 24, (48, 64), (24, 32),
                       chosen_idx=(0, 3, 9, 11))
    cfg = dict(type='FileRawframeDataset', pkl_path=pkl,
               pipeline=_small(CFG.to_dict()['train_pipeline'], 16),
               extra_keys=['nids_flow', 'chosen_idx'])
    kw = dict(batch_size=2, shuffle=True, seed=5, num_workers=1,
              workers_mode='process')
    jl = JaxNumpyLoader(j_build_dataset(copy.deepcopy(cfg)), **kw)
    tl = NumpyLoader(t_build_dataset(cfg), **kw)
    try:
        for epoch in range(2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            want, got = list(jl), list(tl)
            assert len(got) == 2
            assert_same(want, got, f'epoch {epoch}')
    finally:
        jl.shutdown()
        tl.shutdown()
