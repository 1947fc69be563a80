"""The motion-guided crop and the lazy pipeline against mscl_tpu's, bit for
bit under the same ``random`` / ``np.random`` seeds, on the CPU:
``MCLRandomResizedCrop`` (its boxes, crop quadruple and cropped frames and
flows) and ``motion_map_from_flow``; JAX's lazy-versus-eager case
(CenterCrop, Resize, Flip, then Fuse), a lazy RandomResizedCrop and two
composed crops through Fuse; and the eager Flip, the Flow modality's x
frames inverted."""
import copy
import random

import numpy as np
import pytest

from mscl_torch.datasets import PIPELINES as T_PIPELINES
from mscl_torch.datasets.pipelines import mcl_augmentations as tmcl
from mscl_tpu.datasets import PIPELINES as J_PIPELINES
from mscl_tpu.datasets.pipelines import mcl_augmentations as jmcl

from test_torch_pipelines import assert_same


def _run(pipeline, results, registry, seed):
    random.seed(seed)
    np.random.seed(seed)
    for t in pipeline:
        results = registry.build(dict(t))(results)
    return results


def _frames(seed, n=4, hw=(48, 64)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for _ in range(n)]


def _flows(seed, n=3, hw=(24, 32)):
    """Flows with a moving square, so the motion map has mass somewhere."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for i in range(n):
        f = rng.normal(scale=0.1, size=hw + (2,)).astype(np.float32)
        f[4 + i:14 + i, 6 + 2 * i:18 + 2 * i] += np.float32([3.0, -1.0])
        out.append(f)
    return out


def test_motion_map_matches():
    for f in _flows(0):
        np.testing.assert_array_equal(tmcl.motion_map_from_flow(f),
                                      jmcl.motion_map_from_flow(f))


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('flow_key', ['flow_imgs', 'flows', 'norms'])
def test_mcl_random_resized_crop_matches(seed, flow_key):
    """Two-channel flows (the Sobel motion map) under the configured key or
    'flows', and three-channel flow images (the norm) under the key."""
    flows = _flows(seed)
    key = 'flow_imgs'
    if flow_key == 'flows':
        key = 'flows'
    elif flow_key == 'norms':
        flows = [np.abs(f[..., [0, 1, 0]]) * 40 for f in flows]
    results = {'imgs': _frames(seed), 'img_shape': (48, 64), key: flows}
    pipe = [dict(type='MCLRandomResizedCrop', area_range=(0.3, 1.0),
                 top_rate=0.2, decay=0.8)]
    want = _run(pipe, copy.deepcopy(results), J_PIPELINES, seed)
    got = _run(pipe, results, T_PIPELINES, seed)
    assert_same(want, got)


LAZY = {
    # tests/test_pipelines.py TestLazyOps.test_lazy_matches_eager
    'center_resize_flip': [dict(type='CenterCrop', crop_size=32, lazy=True),
                           dict(type='Resize', scale=(48, 48),
                                keep_ratio=False, lazy=True),
                           dict(type='Flip', flip_ratio=1.0, lazy=True),
                           dict(type='Fuse')],
    'random_resized_crop': [dict(type='RandomResizedCrop', lazy=True),
                            dict(type='Resize', scale=(24, 24),
                                 keep_ratio=False, lazy=True),
                            dict(type='Fuse')],
    'two_crops': [dict(type='CenterCrop', crop_size=(40, 36), lazy=True),
                  dict(type='RandomResizedCrop', area_range=(0.4, 1.0),
                       lazy=True),
                  dict(type='Flip', flip_ratio=0.5, lazy=True),
                  dict(type='Fuse')],
    'eager_same_chain': [dict(type='CenterCrop', crop_size=32),
                         dict(type='Resize', scale=(48, 48),
                              keep_ratio=False),
                         dict(type='Flip', flip_ratio=1.0)],
}


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('case', sorted(LAZY))
def test_lazy_pipeline_matches(case, seed):
    results = dict(imgs=_frames(seed), modality='RGB')
    want = _run(LAZY[case], copy.deepcopy(results), J_PIPELINES, seed)
    got = _run(LAZY[case], results, T_PIPELINES, seed)
    assert_same(want, got)
    assert 'lazy' not in got


@pytest.mark.parametrize('direction,modality', [
    ('horizontal', 'RGB'), ('vertical', 'RGB'), ('horizontal', 'Flow')])
def test_eager_flip_matches(direction, modality):
    rng = np.random.default_rng(4)
    imgs = ([rng.integers(0, 256, (12, 16), dtype=np.uint8)
             for _ in range(4)] if modality == 'Flow' else _frames(4))
    results = dict(imgs=imgs, modality=modality, label=3,
                   gt_bboxes=np.array([[2., 3., 10., 9.]], np.float32))
    pipe = [dict(type='Flip', flip_ratio=1.0, direction=direction,
                 flip_label_map={3: 5})]
    want = _run(pipe, copy.deepcopy(results), J_PIPELINES, 0)
    got = _run(pipe, results, T_PIPELINES, 0)
    assert_same(want, got)
    if modality == 'Flow':
        np.testing.assert_array_equal(got['imgs'][0],
                                      255 - imgs[0][:, ::-1])


def test_fuse_refuses_without_lazy():
    with pytest.raises(ValueError, match='No lazy'):
        T_PIPELINES.build(dict(type='Fuse'))(dict(imgs=_frames(0)))
