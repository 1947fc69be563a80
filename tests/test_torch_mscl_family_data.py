"""The rest of the MSCL family's host side in mscl_torch against mscl_tpu,
on the CPU: ``AlignIndex``, ``TemporalShiftSampleFrames`` and ``FlowToGT``
(loading_mscl.py), ``Flow2ImgWithAug``, ``NormFlowWithStidedAugV2``,
``NormFlowWithAugV2`` and ``NormFlowV2`` (transforms_motion.py) and
``MoCoNormalizeV2``, bitwise under one ``np.random`` seed; the tools
``merge_pkls`` (its output byte for byte against the JAX tool's, run as a
script: it imports no JAX) and ``clip_feature_extraction`` (its ``.npz``
against the JAX tool's on the same JAX ``.ckpt``, which the port reads
itself, and on the same weights converted to a ``.pth``; features within
2e-4, labels equal)."""
import copy
import os.path as osp
import pickle
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import mscl_tpu.apis.train as jax_train
from mscl_tpu.core import save_checkpoint as jax_save_checkpoint
from mscl_tpu.datasets.builder import PIPELINES as JAX_PIPELINES
from mscl_torch.convert import jax_to_state_dict
from mscl_torch.datasets.builder import PIPELINES
from mscl_torch.tools import clip_feature_extraction as cfe_cli
from mscl_torch.tools import merge_pkls as merge_cli

from _torch_data_util import one_torch_thread, write_videos  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _both(cfg, results, seed):
    """The JAX and the port transform of cfg on copies of results, each
    after np.random.seed(seed)."""
    out = []
    for registry in (JAX_PIPELINES, PIPELINES):
        np.random.seed(seed)
        out.append(registry.build(dict(cfg))(copy.deepcopy(results)))
    return out


def _same(a, b, path='results'):
    """Equal, bit for bit, through dicts, lists and arrays."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _flows(rng, n=4, hw=(12, 10)):
    return [(rng.normal(size=hw + (2,)) * 3).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize('with_img_flows', [False, True])
def test_align_index_matches(with_img_flows):
    results = dict(img_paths=[f'img_{i}' for i in range(40)],
                   flow_paths=[f'flow_{i}' for i in range(16)])
    if with_img_flows:
        results['flow_img_paths'] = [f'fimg_{i}' for i in range(16)]
    want, got = _both(dict(type='AlignIndex', gap=2, adjacent=8), results, 0)
    _same(got, want)
    assert got['total_frames'] == 16 and got['img_paths'][1] == 'img_2'
    with pytest.raises(AssertionError):
        PIPELINES.build(dict(type='AlignIndex', gap=3, adjacent=8))(
            copy.deepcopy(results))


@pytest.mark.parametrize('seed', range(4))
def test_temporal_shift_sample_frames_matches(seed):
    cfg = dict(type='TemporalShiftSampleFrames', clip_len=4,
               frame_interval=2, shift_range=[1, 2, 1, 3][seed],
               out_of_bound_opt=['loop', 'repeat_last'][seed % 2])
    for total in (5, 30, 64):
        results = dict(total_frames=total, start_index=seed % 2)
        want, got = _both(cfg, results, seed * 10 + total)
        _same(got, want)
        assert got['num_clips'] == 2 and got['frame_inds'].shape == (8,)


def test_flow_to_gt_matches():
    boxes = np.array([[1, 2, 5, 6]], np.float32)
    want, got = _both(dict(type='FlowToGT'), dict(flow_prposals=boxes), 0)
    _same(got, want)
    with pytest.raises(NotImplementedError):
        PIPELINES.build(dict(type='FlowToGT'))(dict(flow_prposals=boxes,
                                                    gt_bboxes=boxes))


FLOW_CASES = {
    'Flow2ImgWithAug': dict(ratios=(-0.5, 0.5)),
    'Flow2ImgWithAug/bgr_split': dict(ratios=(0.0, 1.0),
                                      convert_to_bgr=True, merge_aug=False),
    'NormFlowWithStidedAugV2': dict(ratios=(-1.0, 1.0), num_chunks=8),
    'NormFlowWithStidedAugV2/split': dict(ratios=(0.0, 1.0), num_chunks=4,
                                          merge_aug=False),
    'NormFlowWithAugV2': dict(ratios=(-1.0, 1.0)),
    'NormFlowWithAugV2/split': dict(ratios=(0.0, 0.5), merge_aug=False),
    'NormFlowV2': dict(),
}


@pytest.mark.parametrize('case', sorted(FLOW_CASES))
def test_flow_transform_matches(case):
    name = case.split('/')[0]
    rng = np.random.default_rng(len(case))
    results = dict(flows=_flows(rng))
    want, got = _both(dict(FLOW_CASES[case], type=name), results, len(case))
    _same(got, want)
    if name.startswith('NormFlowWith'):
        assert len(got['flows']) == (4 if 'split' in case else 8)
        assert 'rotated_flows' in got if 'split' in case else True
    if name == 'Flow2ImgWithAug':
        assert got['flow_imgs'][0].dtype == np.uint8


@pytest.mark.parametrize('ori_flow', [False, True])
def test_moco_normalize_v2_matches(ori_flow):
    rng = np.random.default_rng(int(ori_flow))

    def frames(n, c, dtype):
        return [rng.integers(0, 256, size=(6, 5, c)).astype(dtype)
                for _ in range(n)]
    results = dict(imgs=[frames(4, 3, np.uint8), frames(4, 3, np.uint8)],
                   flow_imgs=[frames(4, 3, np.uint8 if not ori_flow
                                     else np.float64),
                              frames(4, 3, np.uint8 if not ori_flow
                                     else np.float64)],
                   flows=[_flows(rng, hw=(6, 5)),
                          [f.astype(np.float64) for f in _flows(
                              rng, hw=(6, 5))]])
    want, got = _both(dict(type='MoCoNormalizeV2', ori_flow=ori_flow),
                      results, 0)
    _same(got, want)
    assert got['flows'][1].shape == (2, 4, 6, 5)
    assert got['flows'][1].dtype == np.float32


def test_merge_pkls_matches_the_jax_tool(tmp_path):
    """Two shards as flow_extraction --num-shards 2 deals them out, one
    annotation repeated across them and one without a video_name: the
    pickle's bytes equal the JAX tool's, and every named video is in it
    once."""
    annos = [dict(video_name=f'v{i}', total_frames=10 + i,
                  flow_paths=[f'v{i}/flow_{j:05d}.np4' for j in range(2)])
             for i in range(7)]
    shards = [annos[0::2] + [dict(total_frames=3)], annos[1::2] + annos[:1]]
    for i, shard in enumerate(shards):
        with open(tmp_path / f'annos_shard{i}.pkl', 'wb') as f:
            pickle.dump(shard, f)
    pattern = str(tmp_path / 'annos_shard*.pkl')
    subprocess.run([sys.executable, osp.join(ROOT, 'tools/misc/merge_pkls.py'),
                    pattern, str(tmp_path / 'jax.pkl')], check=True,
                   capture_output=True)
    merged = merge_cli.main([pattern, str(tmp_path / 'port.pkl')])
    assert (tmp_path / 'port.pkl').read_bytes() == \
        (tmp_path / 'jax.pkl').read_bytes()
    named = [a['video_name'] for a in merged if 'video_name' in a]
    assert sorted(named) == sorted(a['video_name'] for a in annos)
    assert len(merged) == len(annos) + 1


def _feature_config(tmp_path, pkl):
    from test_e2e_workloads import finetune_cfg
    pipeline = finetune_cfg(dict(pkl=pkl), 'unused', '')['data']['test'][
        'pipeline']
    model = dict(type='Recognizer3D',
                 backbone=dict(type='torchvision.r3d_18',
                               layers=(1, 1, 1, 1), base_width=4),
                 cls_head=dict(type='I3DHead', num_classes=2, in_channels=32,
                               dropout_ratio=0.0))
    ds = dict(type='FileRawframeDataset', pkl_path=pkl, pipeline=pipeline)
    path = tmp_path / 'cfg.py'
    with open(path, 'w') as f:
        f.write(f'model = {model!r}\n'
                f'data = dict(videos_per_gpu=1, workers_per_gpu=0, '
                f'test={ds!r})\n')
    return str(path), model, ds


def test_clip_feature_extraction_matches_the_jax_tool(tmp_path, xla3d_conv):
    from flax import serialization
    pkl = write_videos(str(tmp_path / 'videos'), 8, 12, (32, 32), (16, 16))
    cfg_py, model_cfg, ds = _feature_config(tmp_path, pkl)
    jstate = jax_train.init_state(
        jax_train.build_model_from_cfg(model_cfg),
        jax_train.build_optimizer(dict(type='SGD', lr=0.0),
                                  jax_train.build_lr_schedule(
                                      dict(policy='fixed'), 0.0, 1, 1)),
        jax_train.example_batch_from(jax_train.build_dataset(
            dict(ds, test_mode=True)), 8))
    jckpt = jax_save_checkpoint(serialization.to_state_dict(jstate),
                                str(tmp_path / 'jax'), 1)
    tckpt = str(tmp_path / 'port.pth')
    torch.save({'state_dict': {k: torch.from_numpy(v) for k, v in
                               jax_to_state_dict({
                                   'params': jstate.params,
                                   'batch_stats': jstate.batch_stats
                               }).items()}}, tckpt)
    saved = sys.argv
    sys.argv = ['clip_feature_extraction.py', cfg_py, jckpt, '--out',
                str(tmp_path / 'jax.npz')]
    try:
        runpy.run_path(osp.join(ROOT, 'tools/misc/clip_feature_extraction.py'),
                       run_name='__main__')
    finally:
        sys.argv = saved
    want = np.load(tmp_path / 'jax.npz')
    for ckpt in (jckpt, tckpt):
        out = str(tmp_path / 'port.npz')
        feats, labels = cfe_cli.main([cfg_py, ckpt, '--out', out,
                                      '--device', 'cpu'])
        got = np.load(out)
        assert sorted(got.files) == sorted(want.files) == ['features',
                                                           'labels']
        assert got['features'].shape == want['features'].shape == (8, 32)
        np.testing.assert_allclose(got['features'], want['features'],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(got['labels'], want['labels'])
        np.testing.assert_array_equal(feats, got['features'])
    # '' keeps the seed-0 init: other weights, the same shapes
    feats, _ = cfe_cli.main([cfg_py, '', '--out', out, '--device', 'cpu'])
    assert feats.shape == (8, 32) and not np.allclose(feats,
                                                      want['features'])
