"""The fine-tune slice's host-side parts against mscl_tpu's, on the CPU:
the five transforms of the fine-tune pipelines (bitwise under the same
``random``/``np.random`` seeds), the 'step' lr policy, every function of
``core/evaluation/accuracy.py`` and ``BaseDataset.evaluate`` (exact, on
random scores), and ``retrieval_recall`` (random features without ties,
and tests/test_e2e_workloads.py's hand-computable case)."""
import copy
import json
import pickle
import random

import numpy as np
import pytest

from mscl_torch.apis import retrieval_recall
from mscl_torch.core import build_lr_schedule
from mscl_torch.core.evaluation import accuracy as t_acc
from mscl_torch.datasets import PIPELINES as T_PIPELINES
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_tpu.apis.inference import retrieval_recall as jax_recall
from mscl_tpu.core import build_lr_schedule as jax_lr
from mscl_tpu.core.evaluation import accuracy as j_acc
from mscl_tpu.datasets import PIPELINES as J_PIPELINES
from mscl_tpu.datasets import build_dataset as j_build_dataset

from test_torch_pipelines import assert_same

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])


def _frames(seed, n=5, hw=(40, 56)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for _ in range(n)]


def _run(pipeline, results, registry, seed):
    random.seed(seed)
    np.random.seed(seed)
    for t in pipeline:
        results = registry.build(dict(t))(results)
    return results


# each case: the transforms after the frames are decoded
TRANSFORMS = {
    'resize_short_side': [dict(type='Resize', scale=(-1, 24))],
    'resize_fixed': [dict(type='Resize', scale=(16, 12), keep_ratio=False)],
    'resize_factor': [dict(type='Resize', scale=0.5)],
    'random_resized_crop': [dict(type='RandomResizedCrop')],
    'random_resized_crop_narrow': [dict(type='RandomResizedCrop',
                                        area_range=(0.5, 1.0),
                                        aspect_ratio_range=(0.9, 1.1))],
    'center_crop': [dict(type='CenterCrop', crop_size=32)],
    'center_crop_rect': [dict(type='CenterCrop', crop_size=(30, 20))],
    'normalize': [dict(type='Normalize', to_bgr=False, **NORM)],
    'normalize_bgr': [dict(type='Normalize', to_bgr=True, **NORM)],
    'seg2t': [dict(type='Normalize', **NORM), dict(type='Seg2T')],
    # the fine-tune configs' pipelines after LocalDecode
    'train_pipeline': [dict(type='Resize', scale=(-1, 32)),
                       dict(type='RandomResizedCrop'),
                       dict(type='Resize', scale=(16, 16), keep_ratio=False),
                       dict(type='Normalize', **NORM), dict(type='Seg2T')],
    'val_pipeline': [dict(type='Resize', scale=(-1, 28)),
                     dict(type='CenterCrop', crop_size=24),
                     dict(type='Normalize', **NORM), dict(type='Seg2T')],
}


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('case', sorted(TRANSFORMS))
def test_transform_matches(case, seed):
    frames = _frames(seed)
    results = dict(imgs=frames, num_clips=len(frames), clip_len=1,
                   modality='RGB',
                   gt_bboxes=np.array([[2., 3., 30., 20.]], np.float32))
    want = _run(TRANSFORMS[case], copy.deepcopy(results), J_PIPELINES, seed)
    got = _run(TRANSFORMS[case], results, T_PIPELINES, seed)
    assert_same(want, got)


def test_flow_normalize_matches():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (12, 16), dtype=np.uint8) for _ in range(4)]
    pipe = [dict(type='Normalize', mean=[128, 128], std=[64, 32],
                 adjust_magnitude=True)]
    results = dict(imgs=imgs, modality='Flow',
                   scale_factor=np.array([0.5, 2.0], np.float32))
    assert_same(_run(pipe, copy.deepcopy(results), J_PIPELINES, 0),
                _run(pipe, results, T_PIPELINES, 0))


@pytest.mark.parametrize('name', ['Resize', 'RandomResizedCrop',
                                  'CenterCrop'])
def test_lazy_is_refused(name):
    """With lazy=True the transform records JAX's geometry and leaves the
    frames alone; an eager transform after it is refused until Fuse, as in
    the JAX package."""
    arg = dict(Resize=dict(scale=(16, 16)), CenterCrop=dict(crop_size=8),
               RandomResizedCrop={})[name]
    lazy = [dict(type=name, lazy=True, **arg)]
    frames = _frames(0)
    want = _run(lazy, dict(imgs=copy.deepcopy(frames)), J_PIPELINES, 0)
    got = _run(lazy, dict(imgs=frames), T_PIPELINES, 0)
    assert_same(want, got)
    assert all(a is b for a, b in zip(got['imgs'], frames))
    for results, registry in ((want, J_PIPELINES), (got, T_PIPELINES)):
        with pytest.raises(AssertionError, match='Fuse'):
            registry.build(dict(type='CenterCrop', crop_size=4))(results)


@pytest.mark.parametrize('lr_config', [
    dict(policy='step', step=[14, 18]),
    dict(policy='step', step=[1]),
    dict(policy='step', step=3, gamma=0.5, by_epoch=False),
])
def test_step_lr_matches(lr_config):
    want = jax_lr(dict(lr_config), 0.12, 22, 3)
    got = build_lr_schedule(dict(lr_config), 0.12, 22, 3)
    for step in range(70):
        assert np.float32(got(step)) == np.float32(want(step)), step


def test_step_lr_with_warmup_matches():
    cfg = dict(policy='step', step=[2, 4], warmup='linear', warmup_iters=4)
    want = jax_lr(dict(cfg), 0.12, 6, 3)
    got = build_lr_schedule(dict(cfg), 0.12, 6, 3)
    for step in range(20):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=f'step {step}')


def _scores(seed, n=60, classes=7):
    rng = np.random.default_rng(seed)
    return (list(rng.normal(size=(n, classes)).astype(np.float32)),
            rng.integers(0, classes, n))


def _equal(want, got):
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _equal(w, g)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize('seed', [0, 1])
def test_accuracy_functions_match(seed):
    scores, labels = _scores(seed)
    pred = np.argmax(scores, axis=1)
    multi = (np.random.default_rng(seed + 9).random((60, 7)) < 0.3
             ).astype(np.float64)
    cases = [
        ('confusion_matrix', (pred, labels)),
        ('confusion_matrix', (pred.astype(np.int32), labels.astype(np.int32))),
        *[('confusion_matrix', (pred, labels), dict(normalize=n))
          for n in ('true', 'pred', 'all')],
        ('top_k_accuracy', (scores, labels, (1, 3, 5))),
        ('mean_class_accuracy', (scores, labels)),
        ('per_class_accuracy', (scores, labels)),
        ('binary_precision_recall_curve', (np.asarray(scores)[:, 0],
                                           multi[:, 0])),
        ('mean_average_precision', (scores, list(multi))),
        ('mmit_mean_average_precision', (scores, list(multi))),
        ('top_k_classes', (np.asarray(scores), labels, 3, 'accurate')),
        ('top_k_classes', (np.asarray(scores), labels, 3, 'inaccurate')),
        ('get_weighted_score', ([scores, scores[::-1]], [0.3, 0.7])),
    ]
    for name, args, *kw in cases:
        kw = kw[0] if kw else {}
        _equal(getattr(j_acc, name)(*args, **kw),
               getattr(t_acc, name)(*args, **kw))


def _annotations(path, labels):
    with open(path, 'wb') as f:
        pickle.dump([dict(frames=['unused'], label=lab) for lab in labels], f)
    return str(path)


def test_evaluate_matches(tmp_path):
    scores, labels = _scores(4, n=30, classes=6)
    pkl = _annotations(tmp_path / 'a.pkl', labels.tolist())
    metrics = ['top_k_accuracy', 'mean_class_accuracy',
               'vis_mean_class_accuracy', 'mean_average_precision']
    out = {}
    for name, build in (('jax', j_build_dataset), ('port', t_build_dataset)):
        vis = dict(cur_path=str(tmp_path / name), dataset_name='x',
                   vis_cf=True)
        ds = build(dict(type='FileRawframeDataset', pkl_path=pkl,
                        pipeline=[], num_classes=6, visual_cfg=vis))
        out[name] = ds.evaluate(scores, metrics=metrics)
        out[name + '_topk3'] = ds.evaluate(
            scores, metrics='top_k_accuracy',
            metric_options=dict(top_k_accuracy=dict(topk=3)))
        out[name + '_files'] = [
            json.load(open(tmp_path / name / 'per_class_acc_x.json')),
            np.load(tmp_path / name / 'confusion_x.npy')]
    assert out['port'] == out['jax']
    assert sorted(out['port']) == ['mean_average_precision',
                                   'mean_class_accuracy', 'top1_acc',
                                   'top5_acc']
    assert out['port_topk3'] == out['jax_topk3']
    assert out['port_files'][0] == out['jax_files'][0]
    np.testing.assert_array_equal(out['port_files'][1], out['jax_files'][1])
    with pytest.raises(KeyError, match='not supported'):
        ds.evaluate(scores, metrics=['recall'])


def test_evaluate_mmit_matches(tmp_path):
    scores, _ = _scores(5, n=20, classes=4)
    multi = (np.random.default_rng(6).random((20, 4)) < 0.4).astype(float)
    multi[:, 0] = 1.0                  # no video without a positive
    pkl = _annotations(tmp_path / 'm.pkl', list(multi))
    got = [build(dict(type='FileRawframeDataset', pkl_path=pkl,
                      pipeline=[])).evaluate(
                          scores, metrics=['mmit_mean_average_precision'])
           for build in (j_build_dataset, t_build_dataset)]
    assert got[0] == got[1]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_retrieval_recall_matches(seed):
    rng = np.random.default_rng(seed)
    train = rng.normal(size=(50, 24)).astype(np.float32)
    test = rng.normal(size=(20, 24)).astype(np.float32)
    train_labels = rng.integers(0, 5, 50)
    test_labels = rng.integers(0, 5, 20)
    want = jax_recall(train, train_labels, test, test_labels)
    got = retrieval_recall(train, train_labels, test, test_labels,
                           device='cpu')
    assert got == want
    assert got['recall@50'] == 1.0     # every train video is a neighbour


def test_retrieval_recall_hand_computable():
    """tests/test_e2e_workloads.py:278: each test video lies by its
    class's ten train videos."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 16)) * 5
    train_feats = np.repeat(centers, 10, axis=0) + \
        rng.normal(size=(40, 16)) * 0.01
    train_labels = np.repeat(np.arange(4), 10)
    test_feats = centers + rng.normal(size=(4, 16)) * 0.01
    test_labels = np.arange(4)
    args = (train_feats, train_labels, test_feats, test_labels)
    got = retrieval_recall(*args, topk=(1, 5), device='cpu')
    assert got == jax_recall(*args, topk=(1, 5))
    assert got == {'recall@1': 1.0, 'recall@5': 1.0}
