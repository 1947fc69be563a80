"""The port's host data path (``mscl_torch/datasets``) against mscl_tpu's:
each transform of the flagship config's train and val pipelines, and
``dataset[i]`` whole, bitwise under the same ``random``/``np.random``
seeds, on JPEG frames with ``.np4`` flows and PNG frames with ``.npy``
flows; then the loader (epoch order, collate, drop_last, close, thread
workers)."""
import copy
import random
import threading
import time

import numpy as np
import pytest

from mscl_torch.config import Config
from mscl_torch.apis import FLAGSHIP_CONFIG
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.datasets import loader as t_loader
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.datasets import loader as j_loader

from _torch_data_util import write_videos

CFG = Config.fromfile(FLAGSHIP_CONFIG)


def _small(pipeline, target):
    """The pipeline with its 112x112 target cut to ``target`` (small frames
    then still take the half-scale decode plan)."""
    out = copy.deepcopy(pipeline)
    for t in out:
        if t['type'] == 'MoCoDecodePlan':
            t['target'] = (target, target)
        if t['type'] == 'MoCoResize':
            t['scale'] = (target, target)
    return out


# (frame ext, flow ext, frame hw, flow hw, target): the recipe's sizes for
# PNG + npy (what the card's data path reads), a small set for JPEG + np4
SETS = {
    'png_npy': ('png', 'npy', (256, 340), (128, 171), 112),
    'jpg_np4': ('jpg', 'np4', (48, 64), (24, 32), 16),
    'png_npy_small': ('png', 'npy', (48, 64), (24, 32), 16),
}


@pytest.fixture(scope='module', params=sorted(SETS))
def data(request, tmp_path_factory):
    fext, flext, img_hw, flow_hw, target = SETS[request.param]
    root = str(tmp_path_factory.mktemp(request.param))
    n = 40 if target == 112 else 24
    pkl = write_videos(root, 3, n, img_hw, flow_hw, fext, flext,
                       chosen_idx=(0, 3, 9, 11))
    return dict(pkl=pkl, target=target, name=request.param)


def _datasets(data, which):
    pipeline = CFG.to_dict()[f'{which}_pipeline']
    if data['target'] != 112:
        pipeline = _small(pipeline, data['target'])
    cfg = dict(type='FileRawframeDataset', pkl_path=data['pkl'],
               pipeline=pipeline, extra_keys=['nids_flow', 'chosen_idx'])
    return j_build_dataset(copy.deepcopy(cfg)), t_build_dataset(cfg)


def assert_same(a, b, path='results'):
    """Same structure, types and bytes (arrays bitwise, dtype included)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), \
            (path, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f'{path}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype,
                                                          b.dtype)
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _states():
    return random.getstate(), np.random.get_state()


@pytest.mark.parametrize('which', ['train', 'val'])
def test_each_transform_matches(data, which):
    """Each transform on the same input and the same generator states
    gives the same results and draws as many numbers."""
    jds, tds = _datasets(data, which)
    assert [type(t).__name__ for t in jds.pipeline.transforms] == \
        [type(t).__name__ for t in tds.pipeline.transforms]
    for idx in range(len(jds)):
        _seed(100 + idx)
        start = copy.deepcopy(jds.data_transfer(jds.video_infos[idx]))
        start.update(filename_tmpl=jds.filename_tmpl,
                     modality=jds.modality, start_index=jds.start_index)
        rj, rt = copy.deepcopy(start), copy.deepcopy(start)
        for jt, tt in zip(jds.pipeline.transforms, tds.pipeline.transforms):
            before = _states()
            rj = jt(rj)
            after = _states()
            random.setstate(before[0])
            np.random.set_state(before[1])
            rt = tt(rt)
            assert_same(rj, rt, f'{type(jt).__name__}')
            assert random.getstate() == after[0]
            np.testing.assert_array_equal(np.random.get_state()[1],
                                          after[1][1])
            assert np.random.get_state()[2] == after[1][2]


def test_dataset_items_match(data):
    for which in ('train', 'val'):
        jds, tds = _datasets(data, which)
        for idx in range(len(jds)):
            _seed(7 + idx)
            want = jds[idx]
            _seed(7 + idx)
            got = tds[idx]
            assert_same(want, got, f'{which}[{idx}]')
            assert sorted(got) == ['flow_imgs', 'imgs']
            t = 8
            hw = data['target']
            assert [x.shape for x in got['imgs']] == [(3, t, hw, hw)] * 2
            assert [x.shape for x in got['flow_imgs']] == \
                [(2, 2 * t, hw, hw)] * 2


def test_two_branch_dataset_matches(data):
    """FileRawframe2BranchDataset: the train and the val pipeline on the
    same annotation, the second's keys suffixed with 2."""
    train = CFG.to_dict()['train_pipeline']
    val = CFG.to_dict()['val_pipeline']
    if data['target'] != 112:
        train, val = _small(train, data['target']), _small(val,
                                                           data['target'])
    cfg = dict(type='FileRawframe2BranchDataset', pkl_path=data['pkl'],
               pipeline=train, pipeline2=val,
               extra_keys=['nids_flow', 'chosen_idx'])
    jds, tds = j_build_dataset(copy.deepcopy(cfg)), t_build_dataset(cfg)
    _seed(3)
    want = jds[1]
    _seed(3)
    got = tds[1]
    assert_same(want, got)
    assert sorted(got) == ['flow_imgs', 'flow_imgs2', 'imgs', 'imgs2']


def test_decode_plan_halves_png_frames(tmp_path):
    """The recipe's 256x340 PNG frames take the half-scale decode whenever
    a crop allows it, through the port's own PNG path."""
    pkl = write_videos(str(tmp_path), 1, 24, (256, 340), (128, 171))
    _, tds = _datasets(dict(pkl=pkl, target=112), 'train')
    reduced = 0
    for s in range(12):
        _seed(s)
        res = copy.deepcopy(tds.data_transfer(tds.video_infos[0]))
        res.update(filename_tmpl='', modality='RGB', start_index=0)
        for tr in tds.pipeline.transforms[:4]:     # up to LocalDecode
            res = tr(res)
        reduced += res['img_shape_dec_q'] == (128, 170)
    assert reduced > 0


class _Items:
    """A dataset without draws: item i is a dict of arrays and scalars."""

    def __init__(self, n, delay=0.0):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        x = np.full((2, 3), i, np.float32)
        return dict(imgs=[x, -x], label=np.array([i], np.int64), idx=i,
                    w=float(i) / 2, name=f'v{i}')


@pytest.mark.parametrize('shuffle,drop_last', [(True, True), (True, False),
                                               (False, False)])
def test_loader_order_and_batches_match(shuffle, drop_last):
    ds = _Items(11)
    jl = j_loader.NumpyLoader(ds, 4, shuffle=shuffle, seed=3,
                              drop_last=drop_last)
    tl = t_loader.NumpyLoader(ds, 4, shuffle=shuffle, seed=3,
                              drop_last=drop_last)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    for epoch in range(3):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want, got = list(jl), list(tl)
        assert len(got) == len(tl)
        assert_same(want, got, f'epoch {epoch}')


def test_default_collate_matches():
    samples = [_Items(3)[i] for i in range(3)]
    out = t_loader.default_collate(samples)
    assert_same(j_loader.default_collate(samples), out)
    assert out['label'].shape == (3,) and out['imgs'][0].shape == (3, 2, 3)
    assert out['idx'].dtype == np.int64 and out['w'].dtype == np.float32
    assert out['name'] == ['v0', 'v1', 'v2']


def test_close_stops_the_producer():
    loader = t_loader.NumpyLoader(_Items(64, delay=0.01), 2, prefetch=1)
    it = iter(loader)
    next(it)
    time.sleep(0.1)             # the producer now waits on a full queue
    assert it._thread.is_alive()
    it.close()
    it._thread.join(timeout=3)
    assert not it._thread.is_alive()


def test_thread_workers_give_the_batches_of_one_worker():
    """A pipeline without draws: 4 worker threads (a thread a sample) give
    what no workers give."""
    ds = _Items(9, delay=0.002)
    one = t_loader.NumpyLoader(ds, 4, seed=1, num_workers=0)
    many = t_loader.NumpyLoader(ds, 4, seed=1, num_workers=4)
    assert_same(list(one), list(many))
    assert threading.active_count() < 50
