"""The plain-MoCo configs' host data path (SampleFrames, LocalDecode,
MoCoTransform, Collect, ToTensor) in mscl_torch against mscl_tpu's, bitwise
under the same ``random`` / ``np.random`` seeds: MoCoTransform alone (both
views, ``img_shape``, dtype, the draws it takes) and ``dataset[i]`` whole,
at the config's 112 crop on 256x340 PNG frames and at a 16 crop on small
JPEG frames."""
import copy
import random

import numpy as np
import pytest

from mscl_torch.config import Config
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.datasets.pipelines import MoCoTransform as TMoCoTransform
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.datasets.pipelines.combined_augmentations import \
    MoCoTransform as JMoCoTransform

from _torch_data_util import write_videos
from test_torch_pipelines import assert_same

CONFIG = 'configs/recognition/moco/moco_r18_lr3e-2.py'
# name -> (frame ext, frame hw, crop)
SETS = {'png_112': ('png', (256, 340), 112), 'jpg_16': ('jpg', (48, 64), 16)}


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _pipeline(crop):
    pipeline = copy.deepcopy(Config.fromfile(CONFIG).to_dict()[
        'train_pipeline'])
    for t in pipeline:
        if t['type'] == 'MoCoTransform':
            t['crop_transform']['size'] = (crop, crop)
    return pipeline


@pytest.fixture(scope='module', params=sorted(SETS))
def data(request, tmp_path_factory):
    ext, hw, crop = SETS[request.param]
    root = str(tmp_path_factory.mktemp(request.param))
    pkl = write_videos(root, 3, 72, hw, (8, 8), ext, 'npy')
    cfg = dict(type='FileRawframeDataset', pkl_path=pkl,
               pipeline=_pipeline(crop))
    return j_build_dataset(copy.deepcopy(cfg)), t_build_dataset(cfg), crop


@pytest.mark.parametrize('hw,size,scale', [
    ((256, 340), (112, 112), (0.2, 1)), ((40, 30), (24, 16), (0.5, 0.9)),
    ((20, 20), 8, (0.2, 1))])
def test_moco_transform_bitwise(hw, size, scale):
    """Both views, img_shape and dtype equal bitwise, and the same numbers
    drawn from both generators."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for _ in range(8)]
    kw = dict(crop_transform=dict(size=size, scale=scale))
    for seed in range(6):
        _seed(seed)
        want = JMoCoTransform(**kw)(dict(imgs=list(imgs), img_shape=hw))
        states = random.getstate(), np.random.get_state()
        _seed(seed)
        got = TMoCoTransform(**kw)(dict(imgs=list(imgs), img_shape=hw))
        assert_same(want, got)
        assert got['imgs'][0].dtype == np.float32
        assert random.getstate() == states[0]
        np.testing.assert_array_equal(np.random.get_state()[1], states[1][1])
    s = (size, size) if isinstance(size, int) else size
    assert got['imgs'][0].shape == (3, 8, s[1], s[0])   # size is (w, h)
    assert got['img_shape'] == (s[1], s[0])
    assert not np.array_equal(got['imgs'][0], got['imgs'][1])


def test_dataset_items_match(data):
    jds, tds, crop = data
    assert [type(t).__name__ for t in tds.pipeline.transforms] == \
        [type(t).__name__ for t in jds.pipeline.transforms]
    for idx in range(len(jds)):
        _seed(11 + idx)
        want = jds[idx]
        _seed(11 + idx)
        got = tds[idx]
        assert_same(want, got, f'item {idx}')
        assert sorted(got) == ['imgs']
        assert [x.shape for x in got['imgs']] == [(3, 8, crop, crop)] * 2
