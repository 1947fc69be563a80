"""The TSN-style crops, ColorJitter and the formatting steps of the port
against mscl_tpu's, on the CPU, bitwise: the same arrays, dtypes and
draws from the same generator states. OpenCV's uint8 HSV conversions,
which ColorJitter's hue step runs through, are held against cv2 on every
uint8 input.
"""
import copy
import random

import cv2
import numpy as np
import pytest

from mscl_torch.datasets.pipelines import Compose as TCompose
from mscl_torch.utils.color import hsv_to_rgb, rgb_to_hsv
from mscl_tpu.datasets.pipelines import Compose as JCompose

from test_torch_pipelines import assert_same


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _both(cfg, results, seed=0):
    outs = []
    for compose in (JCompose, TCompose):
        _seed(seed)
        outs.append(compose([dict(c) for c in cfg])(copy.deepcopy(results)))
        outs.append((random.getstate(), np.random.get_state()[1].tobytes()))
    assert outs[1] == outs[3], 'a different number of draws'
    assert_same(outs[0], outs[2])
    return outs[2]


def _clip(n, h, w, seed=0, grey=False):
    rng = np.random.default_rng(seed)
    shape = (h, w) if grey else (h, w, 3)
    imgs = [rng.integers(0, 256, shape).astype(np.uint8) for _ in range(n)]
    return dict(imgs=imgs, img_shape=(h, w), original_shape=(h, w),
                modality='Flow' if grey else 'RGB', num_clips=1,
                clip_len=n // 2 if grey else n)


def test_rgb_to_hsv_is_cv2s_on_every_colour():
    c = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
    rgb = rgb.reshape(4096, 4096, 3)
    np.testing.assert_array_equal(rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize('width', [256, 1, 45])
def test_hsv_to_rgb_is_cv2s_on_every_triple(width):
    """OpenCV's vector loop (32 pixels of a row at a time) and its scalar
    tail (the rest of the row) round differently: every triple in rows of
    256 (vector only), of 1 (tail only) and of 45 (both)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing='ij')
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)
    if width == 45:      # both paths in each row
        hsv = hsv[::7][:len(hsv) // 7 // 45 * 45]
    hsv = hsv.reshape(-1, width, 3)
    np.testing.assert_array_equal(hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


CROPS = [
    [dict(type='RandomCrop', size=13)],
    [dict(type='MultiScaleCrop', input_size=16, scales=(1, 0.875, 0.75,
                                                        0.66),
          max_wh_scale_gap=1)],
    [dict(type='MultiScaleCrop', input_size=16, scales=(1, 0.8),
          max_wh_scale_gap=0, random_crop=True)],
    [dict(type='MultiScaleCrop', input_size=(18, 14), scales=(1, 0.875, 0.75),
          num_fixed_crops=13)],
    [dict(type='MultiScaleCrop', input_size=16, scales=(1, 0.875),
          lazy=True), dict(type='Resize', scale=(16, 16), keep_ratio=False,
                           lazy=True),
     dict(type='Flip', flip_ratio=0.5, lazy=True), dict(type='Fuse')],
    [dict(type='RandomRescale', scale_range=(20, 40))],
    [dict(type='RandomScale', scales=((40, 20), (60, 30)))],
    [dict(type='RandomScale', scales=((40, 20), (60, 30), (30, 16)),
          mode='value', keep_ratio=False)],
    [dict(type='Resize', scale=(-1, 24)), dict(type='ThreeCrop',
                                               crop_size=24)],
    [dict(type='ThreeCrop', crop_size=(21, 18))],
    [dict(type='TenCrop', crop_size=12)],
    [dict(type='MultiGroupCrop', crop_size=10, groups=3)],
    [dict(type='RandomResizedCrop'), dict(type='CenterCrop', crop_size=8)],
    [dict(type='GPUNormalize', input_format='NCTHW', mean=[1, 2, 3],
          std=[4, 5, 6])],
]


@pytest.mark.parametrize('i', range(len(CROPS)))
def test_crops_match(i):
    for seed in range(6):
        _both(CROPS[i], _clip(3, 30, 21, seed), seed)


@pytest.mark.parametrize('flow', [False, True])
def test_flow_frames_through_the_flow_configs_steps(flow):
    """The flow config's train steps on grey x/y frames (Resize of 2-D
    frames, a flip that inverts the x frames, the two-channel Normalize)."""
    steps = [dict(type='Resize', scale=(-1, 26)),
             dict(type='RandomResizedCrop'),
             dict(type='Resize', scale=(16, 16), keep_ratio=False),
             dict(type='Flip', flip_ratio=0.5),
             dict(type='Normalize', mean=[128, 128] if flow else [1, 2, 3],
                  std=[128, 128] if flow else [3, 2, 1]),
             dict(type='FormatShape', input_format='NCTHW')]
    for seed in range(6):
        out = _both(steps, _clip(8, 21, 30, seed, grey=flow), seed)
        assert out['imgs'].shape == (1, 2 if flow else 3, 4 if flow else 8,
                                     16, 16)


@pytest.mark.parametrize('hue', [0.0, 0.1, (0.2, 0.45)])
def test_color_jitter_matches(hue):
    steps = [dict(type='ColorJitter', hue=hue)]
    for seed in range(4):
        _both(steps, _clip(3, 19, 23, seed), seed)
    _both([dict(type='ColorJitter', brightness=(0.9, 1.1), contrast=0.2,
                saturation=(0.5, 2.0), hue=hue)], _clip(2, 8, 9), 7)


@pytest.mark.parametrize('fmt', ['NCTHW', 'NTHWC', 'NCHW', 'NCHW_Flow',
                                 'NCTHW_Heatmap', 'NPTCHW'])
def test_format_shape_matches(fmt):
    rng = np.random.default_rng(3)
    imgs = rng.normal(size=(2 * 3 * 4, 5, 6, 2)).astype(np.float32)
    results = dict(imgs=imgs, num_clips=3, clip_len=4, num_proposals=2)
    out = _both([dict(type='FormatShape', input_format=fmt)], results)
    assert out['input_shape'] == out['imgs'].shape
    one = dict(imgs=list(imgs[:4]), num_clips=1, clip_len=4, num_proposals=1)
    if fmt != 'NCHW':
        _both([dict(type='FormatShape', input_format=fmt, collapse=True)],
              one)
    with pytest.raises(ValueError, match='invalid'):
        TCompose([dict(type='FormatShape', input_format='NHWTC')])


def test_other_formatting_steps_match():
    rng = np.random.default_rng(4)
    results = dict(imgs=rng.normal(size=(5, 6, 3)).astype(np.float32),
                   aux=rng.normal(size=(2, 3, 4)), label=3)
    _both([dict(type='Rename', mapping=dict(label='gt', nothing='x')),
           dict(type='Transpose', keys=['aux'], order=(2, 0, 1)),
           dict(type='ImageToTensor', keys=['imgs']),
           dict(type='ToDataContainer', fields=[dict(key=['imgs', 'aux']),
                                                dict(key='gt')]),
           dict(type='Collect', keys=['imgs', 'aux', 'gt'], meta_keys=[])],
          results)
    with pytest.raises(AssertionError, match='missing'):
        TCompose([dict(type='ToDataContainer', fields=[dict(key='x')])])(
            dict(results))
