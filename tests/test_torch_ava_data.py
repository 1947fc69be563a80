"""The AVA data path of the port against mscl_tpu's, on the CPU, bit for
bit: the assigner, sampler and padded targets (``core/bbox.py``) on the
same ``np.random.Generator``, ``AVADataset``'s records (the csv, the
exclude file, the proposals and their score filter), ``SampleAVAFrames``
on the global ``np.random``, every shipped AVA train pipeline item for
item (``AVAAssignSample`` seeded in both packages), ``evaluate``, and
the custom-classes fault both packages share: the labels each
custom-classes config keeps.
"""
import copy
import os.path as osp
import random

import cv2
import numpy as np
import pytest

from mscl_torch.config import Config
from mscl_torch.core import bbox as tbbox
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.datasets.ava_dataset import AVAAssignSample, SampleAVAFrames
from mscl_tpu.core import bbox as jbbox
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.datasets.ava_dataset import AVAAssignSample as JAssign
from mscl_tpu.datasets.ava_dataset import SampleAVAFrames as JSample

from _torch_ava_util import write_ava_set
from test_torch_pipelines import assert_same

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
DET = osp.join(ROOT, 'configs', 'detection')
RCNN = dict(assigner=dict(type='MaxIoUAssignerAVA', pos_iou_thr=0.9,
                          neg_iou_thr=0.9, min_pos_iou=0.9),
            sampler=dict(type='RandomSampler', num=32, pos_fraction=1,
                         neg_pos_ub=-1, add_gt_as_proposals=True),
            pos_weight=1.0)
# one config a distinct train pipeline: 4x16, SlowFast's 32x2, 8x8
PIPELINE_CONFIGS = ('ava/slowonly_r50_4x16x1_20e_ava_rgb.py',
                    'ava/slowfast_r50_4x16x1_20e_ava_rgb.py',
                    'ava/slowonly_r101_8x8x1_20e_ava_rgb.py')
CUSTOM = ('ava/slowonly_r50_4x16x1_20e_ava_rgb_custom_classes.py',
          'ava/slowfast_r50_4x16x1_20e_ava_rgb_custom_classes.py')


def _seed(s):
    random.seed(s)
    np.random.seed(s)


@pytest.fixture(scope='module')
def ava(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ava'))
    return write_ava_set(root, cv2.imwrite, n_videos=3, keyframes=(902, 904),
                         labels=(1, 3, 5, 10, 11, 12, 14, 59, 80))


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(size * 0.02, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _case(seed):
    """gts, their multilabel rows, and proposals: near copies of the gts
    (positives at 0.9), exact duplicates (ties), and random boxes."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(0, 4))
    gts = _boxes(rng, k)
    labels = (rng.random((k, 7)) > 0.6).astype(np.float32)
    near = gts + rng.uniform(-0.3, 0.3, gts.shape).astype(np.float32)
    props = np.concatenate([near, gts[:1], _boxes(rng, int(
        rng.integers(0, 40)))]).astype(np.float32)
    return gts, labels, props


@pytest.mark.parametrize('seed', range(12))
def test_assign_and_sample_bitwise(seed):
    gts, labels, props = _case(seed)
    for cfg in (RCNN, dict(RCNN, sampler=dict(RCNN['sampler'], num=8,
                                               pos_fraction=0.25,
                                               neg_pos_ub=2)),
                dict(RCNN, assigner=dict(pos_iou_thr=0.5,
                                         neg_iou_thr=(0.1, 0.4),
                                         min_pos_iou=0.3,
                                         gt_max_assign_all=seed % 2 == 0))):
        assert_same(tbbox.bbox_overlaps(props, gts),
                    jbbox.bbox_overlaps(props, gts))
        a_cfg = {k: v for k, v in cfg['assigner'].items() if k != 'type'}
        assert_same(tbbox.MaxIoUAssignerAVA(**a_cfg).assign(props, gts,
                                                            labels),
                    jbbox.MaxIoUAssignerAVA(**a_cfg).assign(props, gts,
                                                            labels))
        assert_same(tbbox.assign_and_sample(
            props, gts, labels, cfg, np.random.default_rng(seed)),
            jbbox.assign_and_sample(props, gts, labels, cfg,
                                    np.random.default_rng(seed)))


def test_sampler_without_a_generator_repeats_from_the_global_seed():
    """JAX's sampler takes an OS-seeded generator when given none; the
    port's one seeded from the global np.random stream."""
    gts, labels, props = _case(3)
    cfg = dict(RCNN, sampler=dict(RCNN['sampler'], num=4))
    outs = []
    for _ in range(2):
        _seed(5)
        outs.append(tbbox.assign_and_sample(props, gts, labels, cfg))
    assert_same(outs[0], outs[1])


def _datasets(cfg_path, ava, **kw):
    cfg = Config.fromfile(osp.join(DET, cfg_path)).to_dict()
    train = cfg['data']['train']
    train.update(ann_file=ava['ann'], exclude_file=ava['exclude'],
                 proposal_file=ava['proposals'], data_prefix=ava['prefix'],
                 **kw)
    for step in train['pipeline']:
        if step['type'] == 'AVAAssignSample':
            step['seed'] = 7
    return (t_build_dataset(copy.deepcopy(train)),
            j_build_dataset(copy.deepcopy(train)))


def test_dataset_records_bitwise(ava):
    port, jax_ds = _datasets(PIPELINE_CONFIGS[0], ava)
    assert_same(port.video_infos, jax_ds.video_infos)
    assert_same(port.proposals, jax_ds.proposals)
    # the exclude file removed one keyframe of the six
    assert len(port) == 5
    # each keyframe's results before the pipeline: its proposals kept by
    # score (2.0: only the best one)
    port.pipeline.transforms, jax_ds.pipeline.transforms = [], []
    for thr in (0.5, 0.95, 2.0):
        for ds in (port, jax_ds):
            ds.person_det_score_thr = thr
        for i in range(len(port)):
            assert_same(port[i], jax_ds[i])
    assert len(port[0]['proposals']) == 1


@pytest.mark.parametrize('cfg_path', PIPELINE_CONFIGS)
def test_train_pipeline_items_bitwise(cfg_path, ava):
    port, jax_ds = _datasets(cfg_path, ava)
    for ds in (port, jax_ds):   # the test's frames are 64x48: scale 0.25
        for step in ds.pipeline.transforms:
            if type(step).__name__ == 'RandomRescale':
                step.scale_range = (40, 52)
            if type(step).__name__ == 'RandomCrop':
                step.size = 36
    for i in range(len(port)):
        _seed(i)
        want = jax_ds[i]
        _seed(i)
        got = port[i]
        assert_same(got, want)
    assert got['rois'].shape == (32, 4) and got['roi_labels'].shape == \
        (32, 81)


@pytest.mark.parametrize('test_mode', [False, True])
def test_sample_ava_frames_bitwise(test_mode):
    for clip_len, interval in ((4, 16), (32, 2), (8, 8), (5, 3)):
        for ts in (900, 902, 1799):
            results = dict(fps=30, timestamp=ts, timestamp_start=900,
                           shot_info=(0, 27000))
            _seed(ts)
            want = JSample(clip_len, interval, test_mode)(dict(results))
            _seed(ts)
            got = SampleAVAFrames(clip_len, interval, test_mode)(
                dict(results))
            assert_same(got, want)


def test_assign_sample_step_with_a_seed_draws_alike_each_call():
    """With a seed, every call of JAX's step re-seeds, so every sample
    draws the same numbers (mscl_tpu/datasets/ava_dataset.py:80-81); the
    port's does the same."""
    gts, labels, props = _case(4)
    results = dict(gt_bboxes=gts, gt_labels=labels, proposals=props)
    cfg = dict(RCNN, sampler=dict(RCNN['sampler'], num=3))
    outs = [step(dict(results)) for step in
            (AVAAssignSample(cfg, seed=1), AVAAssignSample(cfg, seed=1),
             JAssign(cfg, seed=1))]
    assert_same(outs[0], outs[2])
    assert_same(outs[0], outs[1])
    _seed(2)
    first = AVAAssignSample(cfg)(dict(results))
    _seed(2)
    assert_same(AVAAssignSample(cfg)(dict(results)), first)


@pytest.mark.parametrize('cfg_path', CUSTOM)
def test_custom_classes_keep_the_raw_ids_below_num_classes(cfg_path, ava):
    """Both packages filter by the custom ids and one-hot the raw id,
    dropping those not below num_classes (mscl_tpu/datasets/
    ava_dataset.py:136-148): the slowonly config (ids 11-80,
    num_classes 10) keeps no label, the SlowFast one (num_classes 17)
    only 3, 6 and 10 of its 16."""
    port, jax_ds = _datasets(cfg_path, ava)
    assert_same(port.video_infos, jax_ds.video_infos)
    cfg = Config.fromfile(osp.join(DET, cfg_path))
    kept = sorted(set(np.nonzero(np.concatenate(
        [v['gt_labels'] for v in port.video_infos]))[1]))
    custom = cfg.data.train.custom_classes
    assert kept == sorted(c for c in custom if c < cfg.num_classes
                          and c in (1, 3, 5, 10, 11, 12, 14, 59, 80))
    if cfg.num_classes == 10:
        assert kept == []
    else:
        assert kept == [3, 10]          # the set's labels among 3, 6, 10


def test_evaluate_bitwise(ava):
    port, jax_ds = _datasets(PIPELINE_CONFIGS[0], ava)
    rng = np.random.default_rng(0)
    results = []
    for info in port.video_infos:
        n = len(info['gt_bboxes']) + 2
        boxes = np.concatenate([info['gt_bboxes'], _boxes(rng, 2, 1.0)])
        boxes += rng.uniform(-0.02, 0.02, boxes.shape).astype(np.float32)
        results.append(dict(bboxes=boxes, scores=rng.random((n, 81))))
    want = jax_ds.evaluate(results)
    assert_same(port.evaluate(results), want)
    assert 0 < want['mAP@0.5IOU'] < 1
