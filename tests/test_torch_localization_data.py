"""The localization data path and host code of mscl_torch against
mscl_tpu's, bitwise: the proposal utilities (IoU, IoP, soft-NMS,
post-processing, AR@AN), BSN's proposal generation, SSN's proposal file,
regression, NMS and AP, ActivityNet detection mAP, the four pipeline
steps, the ActivityNet, SSN and HVU datasets (items under one seed, and
``evaluate``), and the three tools' outputs."""
import copy
import json
import os
import os.path as osp
import random
import runpy
import sys
from unittest import mock

import cv2
import numpy as np
import pytest

import mscl_tpu.datasets  # noqa: F401  (registers the pipelines)
import mscl_tpu.localization as jloc
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.datasets.builder import PIPELINES as JAX_PIPELINES
import mscl_torch.localization as tloc
from mscl_torch.config import Config
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.datasets.builder import PIPELINES
from mscl_torch.tools import bsn_proposal_generation, denormalize_proposal_file
from mscl_torch.tools import report_map

from _torch_localization_util import write_activitynet, write_hvu, \
    write_ssn_set
from test_torch_pipelines import assert_same

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _plain(x):
    """SSNInstance records (each package has its class) as their fields,
    recursively."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if type(x).__name__ == 'SSNInstance':
        return ('SSNInstance', _plain(vars(x)))
    return x


def _props(rng, n):
    t0 = rng.uniform(0, 0.8, n)
    return np.stack([t0, t0 + rng.uniform(0.02, 0.4, n),
                     rng.uniform(size=n)], axis=1)


def test_proposal_utils_bitwise():
    rng = np.random.default_rng(0)
    p = _props(rng, 40)
    for fn in ('temporal_iou', 'temporal_iop'):
        assert_same(getattr(jloc, fn)(p[:, 0], p[:, 1], 0.3, 0.6),
                    getattr(tloc, fn)(p[:, 0], p[:, 1], 0.3, 0.6))
    assert_same(jloc.soft_nms(p.copy(), 0.4, 0.5, 0.9, 10),
                tloc.soft_nms(p.copy(), 0.4, 0.5, 0.9, 10))
    info = dict(duration_frame=300, duration_second=10.0)
    assert_same(jloc.post_processing(p.copy(), info, 0.4, 0.5, 0.9, 20),
                tloc.post_processing(p.copy(), info, 0.4, 0.5, 0.9, 20))
    gt = {f'v{i}': np.sort(rng.uniform(0, 10, (1 + i % 2, 2)), axis=1)
          for i in range(5)}
    props = {f'v{i}': _props(rng, 30) * [10, 10, 1] for i in range(5)}
    assert_same(jloc.average_recall_at_avg_proposals(gt, props, 150),
                tloc.average_recall_at_avg_proposals(gt, props, 150))


def _tem_results(root, ann, tscale=20):
    """TEM csv results (action, start, end, tmin, tmax) for each video of
    the ActivityNet json: smooth random curves."""
    rng = np.random.default_rng(1)
    out = osp.join(root, 'tem_results')
    os.makedirs(out, exist_ok=True)
    tmins = np.arange(tscale) / tscale
    for name in json.load(open(ann)):
        curves = np.convolve(rng.uniform(size=3 * tscale + 4),
                             np.ones(5) / 5, 'valid').reshape(3, tscale)
        rows = np.concatenate([curves, [tmins, tmins + 1 / tscale]]).T
        np.savetxt(osp.join(out, name + '.csv'), rows, delimiter=',',
                   header='action,start,end,tmin,tmax', comments='')
    return out


@pytest.fixture(scope='module')
def anet(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('anet'))
    ann, feats = write_activitynet(root, 4, 20, 24)
    return root, ann, feats, _tem_results(root, ann)


def test_bsn_utils_bitwise(anet):
    """Candidate proposals and BSP features, from the csv directory and
    from in-memory results, equal JAX's."""
    root, ann, _, tem = anet
    infos = bsn_proposal_generation.load_video_infos(ann)
    ids = list(range(len(infos)))
    want = jloc.generate_candidate_proposals(ids, infos, tem, 20, 0.5)
    got = tloc.generate_candidate_proposals(ids, infos, tem, 20, 0.5)
    assert_same(want, got)
    assert all(len(v) for v in got.values())
    kw = dict(top_k=12, num_sample_start=4, num_sample_end=4,
              num_sample_action=8, num_sample_interp=2)
    assert_same(jloc.generate_bsp_feature(ids, infos, tem, want, **kw),
                tloc.generate_bsp_feature(ids, infos, tem, got, **kw))


@pytest.fixture(scope='module')
def ssn(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ssn'))
    return root, write_ssn_set(root, cv2.imwrite, n_videos=3)


def test_ssn_and_det_eval_utils_bitwise(ssn, tmp_path):
    _, ann = ssn
    assert jloc.load_localize_proposal_file(ann) == \
        tloc.load_localize_proposal_file(ann)
    rng = np.random.default_rng(2)
    dets = np.concatenate([_props(rng, 25), rng.normal(
        scale=0.1, size=(25, 2))], axis=1)
    assert_same(jloc.perform_regression(dets), tloc.perform_regression(dets))
    assert_same(jloc.temporal_nms(dets, 0.3), tloc.temporal_nms(dets, 0.3))
    gts = [{f'v{i}': np.sort(rng.uniform(0, 1, (2, 2)), axis=1)
            for i in range(3)} for _ in range(2)]
    by_cls = [{f'v{i}': _props(rng, 6) for i in range(3)} for _ in range(2)]
    iou = np.arange(0.1, 1.0, 0.1)
    assert_same(jloc.eval_ap(by_cls, gts, iou), tloc.eval_ap(by_cls, gts, iou))
    boxes = [dict(bboxes=rng.uniform(0, 1, (3, 4)) * [1, 1, 2, 2],
                  scores=rng.uniform(size=(3, 4)),
                  labels=(rng.uniform(size=(3, 4)) > 0.5).astype(float))
             for _ in range(4)]
    assert jloc.frame_map(boxes, boxes[::-1], 4) == \
        tloc.frame_map(boxes, boxes[::-1], 4)
    gt = {f'v_{i}': dict(annotations=[dict(
        segment=sorted(rng.uniform(0, 50, 2).tolist()), label=f'c{i % 2}')])
        for i in range(4)}
    pred = dict(results={f'{i}': [dict(
        segment=sorted(rng.uniform(0, 50, 2).tolist()), label=f'c{k}',
        score=float(rng.uniform())) for k in range(2)] for i in range(4)})
    paths = [str(tmp_path / 'gt.json'), str(tmp_path / 'pred.json')]
    for path, obj in zip(paths, (gt, pred)):
        with open(path, 'w') as f:
            json.dump(obj, f)
    want = jloc.ActivityNetDetection(*paths).evaluate()
    got = tloc.ActivityNetDetection(*paths).evaluate()
    assert_same(list(want), list(got))


def _anet_cfg(name, ann, feats):
    cfg = Config.fromfile(osp.join(ROOT, 'configs', 'localization', name))
    return dict(cfg.to_dict()['data']['train'], ann_file=ann,
                data_prefix=feats, temporal_dim=16)


def test_activitynet_items_and_evaluate_bitwise(anet):
    """BMN's and TEM's shipped pipelines: every item equal (the features
    resized to 16 rows, the ragged gt_bbox); AR@AN and AUC equal."""
    _, ann, feats, _ = anet
    for name in ('bmn/bmn_400x100_2x8_9e_activitynet_feature.py',
                 'bsn/bsn_tem_400x100_1x16_20e_activitynet_feature.py'):
        cfg = _anet_cfg(name, ann, feats)
        jds, tds = j_build_dataset(copy.deepcopy(cfg)), t_build_dataset(cfg)
        for i in range(len(tds)):
            assert_same(jds[i], tds[i])
        assert tds[0]['raw_feature'].shape == (16, 24)
    rng = np.random.default_rng(3)
    results = [dict(video_name=info['video_name'], proposal_list=[
        dict(segment=sorted(rng.uniform(0, 60, 2).tolist()),
             score=float(rng.uniform())) for _ in range(20)])
        for info in tds.video_infos]
    assert_same(jds.evaluate(results), tds.evaluate(results))


def test_load_proposals_bitwise(anet, tmp_path):
    """LoadProposals on PGM files (one video with fewer rows than top_k):
    equal, and the short video gives its rows only."""
    root, ann, _, tem = anet
    bsn_proposal_generation.main([
        ann, '--tem-results-dir', tem, '--pgm-proposals-dir',
        str(tmp_path / 'p'), '--pgm-features-dir', str(tmp_path / 'f'),
        '--temporal-scale', '20', '--top-k', '6'])
    kw = dict(top_k=10, pgm_proposals_dir=str(tmp_path / 'p'),
              pgm_features_dir=str(tmp_path / 'f'))
    for name in json.load(open(ann)):
        want = JAX_PIPELINES.get('LoadProposals')(**kw)(dict(video_name=name))
        got = PIPELINES.get('LoadProposals')(**kw)(dict(video_name=name))
        assert_same(want, got)
        assert len(got['bsp_feature']) == 6


SSN_TRAIN_CFG = dict(ssn=dict(
    assigner=dict(positive_iou_threshold=0.7, background_iou_threshold=0.01,
                  incomplete_iou_threshold=0.3,
                  background_coverage_threshold=0.02,
                  incomplete_overlap_threshold=0.01),
    sampler=dict(num_per_video=8, positive_ratio=1, background_ratio=1,
                 incomplete_ratio=6, add_gt_as_proposals=True),
    loss_weight=dict(comp_loss_weight=0.1, reg_loss_weight=0.1)))
SSN_TEST_CFG = dict(ssn=dict(sampler=dict(test_interval=6),
                             evaluater=dict(top_k=2000, nms=0.2)))


def test_ssn_dataset_bitwise(ssn):
    """The pools, the regression constants and every item of the shipped
    train pipeline (at 16x16) equal under one seed, with the same draws
    taken from np.random; the val-mode proposal sampling too."""
    root, ann = ssn
    cfg = Config.fromfile(osp.join(
        ROOT, 'configs/localization/ssn/ssn_r50_450e_thumos14_rgb_train.py'))
    cfg = dict(cfg.to_dict()['data']['train'], ann_file=ann,
               data_prefix=root)
    for t in cfg['pipeline']:
        if t['type'] == 'Resize':
            t['scale'] = (16, 16) if t.get('keep_ratio') is False \
                else (24, 20)
    jds, tds = j_build_dataset(copy.deepcopy(cfg)), t_build_dataset(cfg)
    for pool in ('positive_pool', 'incomplete_pool', 'background_pool'):
        assert [(v, p.__dict__) for v, p in getattr(jds, pool)] == \
            [(v, p.__dict__) for v, p in getattr(tds, pool)], pool
        assert getattr(tds, pool)
    assert_same(jds.reg_norm_consts, tds.reg_norm_consts)
    for i in range(len(tds)):
        _seed(i)
        want = jds[i]
        state = np.random.get_state()
        _seed(i)
        got = tds[i]
        assert_same(want, got)
        np.testing.assert_array_equal(np.random.get_state()[1], state[1])
    assert got['imgs'].shape == (8, 9, 3, 16, 16)
    for mode in ('val', 'test'):
        kw = dict(clip_len=1, body_segments=5, aug_segments=(2, 2),
                  aug_ratio=0.5, mode=mode)
        item = dict(tds.video_infos[0], start_index=1,
                    out_proposals=[(('v', p), 0) for p in
                                   tds.video_infos[0]['proposals']])
        _seed(0)
        want = JAX_PIPELINES.get('SampleProposalFrames')(**kw)(
            copy.copy(item))
        _seed(0)
        assert_same(_plain(want), _plain(PIPELINES.get(
            'SampleProposalFrames')(**kw)(copy.copy(item))))


def test_ssn_test_items_detections_and_evaluate_bitwise(ssn):
    """prepare_test_frames (the relative proposals, ticks and scale
    factors), results_to_detections and evaluate's mAP equal."""
    root, ann = ssn
    kw = dict(ann_file=ann, pipeline=[], train_cfg=SSN_TRAIN_CFG,
              test_cfg=SSN_TEST_CFG, data_prefix=root, test_mode=True)
    jds = j_build_dataset(dict(type='SSNDataset', **copy.deepcopy(kw)))
    tds = t_build_dataset(dict(type='SSNDataset', **kw))
    rng = np.random.default_rng(4)
    results = []
    for i in range(len(tds)):
        assert_same(_plain(jds.prepare_test_frames(i)),
                    _plain(tds.prepare_test_frames(i)))
        rel = tds.prepare_test_frames(i)['relative_proposal_list']
        n = len(rel)
        results.append(dict(
            relative_proposal_list=rel,
            activity_scores=rng.normal(size=(n, 4)).astype(np.float32),
            completeness_scores=rng.normal(size=(n, 3)).astype(np.float32),
            bbox_preds=rng.normal(scale=0.1, size=(n, 3, 2))
            .astype(np.float32)))
    assert_same(jds.results_to_detections(results, top_k=50),
                tds.results_to_detections(results, top_k=50))
    assert_same(jds.evaluate(results), tds.evaluate(results))


def test_hvu_dataset_and_label_bitwise(tmp_path):
    """HVUDataset's items (its one-hot over the categories) through the
    rawframe steps, LoadHVULabel on the tag dicts, and the per-category
    mAP, equal."""
    root = str(tmp_path)
    cats = (('action', 12), ('scene', 5))
    ann = write_hvu(root, cv2.imwrite, category_nums=cats)
    pipeline = [dict(type='SampleFrames', clip_len=1, frame_interval=1,
                     num_clips=3),
                dict(type='RawFrameDecode'),
                dict(type='Resize', scale=(16, 16), keep_ratio=False),
                dict(type='FormatShape', input_format='NCHW'),
                dict(type='Collect', keys=['imgs', 'label'], meta_keys=[])]
    cfg = dict(type='HVUDataset', ann_file=ann, pipeline=pipeline,
               data_prefix=root, tag_categories=[c for c, _ in cats],
               tag_category_nums=[n for _, n in cats],
               filename_tmpl='img_{:05d}.jpg')
    jds, tds = j_build_dataset(copy.deepcopy(cfg)), t_build_dataset(cfg)
    for i in range(len(tds)):
        _seed(i)
        want = jds[i]
        _seed(i)
        assert_same(want, tds[i])
    kw = dict(categories=[c for c, _ in cats], category_nums=[n for _, n in
                                                             cats])
    for info in tds.video_infos:
        item = dict(copy.deepcopy(info), **kw)
        assert_same(JAX_PIPELINES.get('LoadHVULabel')()(copy.deepcopy(item)),
                    PIPELINES.get('LoadHVULabel')()(item))
    rng = np.random.default_rng(5)
    scores = [rng.uniform(size=17) for _ in range(len(tds))]
    assert_same(jds.evaluate(scores), tds.evaluate(scores))


def _jax_tool(path, argv):
    with mock.patch.object(sys, 'argv', [path] + argv):
        runpy.run_path(osp.join(ROOT, path), run_name='__main__')


def test_tools_match_jax(anet, ssn, tmp_path):
    """bsn_proposal_generation's csv and npy files, report_map's detection
    json and mAP, and denormalize_proposal_file's output equal the JAX
    tools' (one worker and two for the proposal generation)."""
    root, ann, _, tem = anet
    outs = {}
    for who, workers in (('jax', '1'), ('port', '1'), ('port2', '2')):
        argv = [ann, '--tem-results-dir', tem, '--pgm-proposals-dir',
                str(tmp_path / who / 'p'), '--pgm-features-dir',
                str(tmp_path / who / 'f'), '--temporal-scale', '20',
                '--num-workers', workers]
        if who == 'jax':
            _jax_tool('tools/misc/bsn_proposal_generation.py', argv)
        else:
            assert bsn_proposal_generation.main(argv) == 4
        outs[who] = {f'{d}/{n}': open(tmp_path / who / d / n, 'rb').read()
                     for d in 'pf' for n in sorted(os.listdir(
                         tmp_path / who / d))}
    assert outs['port'] == outs['jax'] == outs['port2'] and outs['jax']

    names = [n[2:] for n in json.load(open(ann))]
    rng = np.random.default_rng(6)
    proposal = dict(results={n: [dict(segment=sorted(
        rng.uniform(0, 60, 2).tolist()), score=float(rng.uniform()))
        for _ in range(5)] for n in names})
    cls_pred = dict(results={n: [dict(label=f'class{k}',
                                      score=float(rng.uniform()))
                                 for k in range(3)] for n in names})
    for name, obj in (('proposal', proposal), ('cls', cls_pred)):
        with open(tmp_path / f'{name}.json', 'w') as f:
            json.dump(obj, f)
    common = ['--proposal', str(tmp_path / 'proposal.json'), '--gt', ann,
              '--cls-pred', str(tmp_path / 'cls.json')]
    _jax_tool('tools/analysis/report_map.py',
              common + ['--det-output', str(tmp_path / 'jdet.json')])
    got = report_map.main(common + ['--det-output',
                                    str(tmp_path / 'tdet.json')])
    assert open(tmp_path / 'jdet.json').read() == \
        open(tmp_path / 'tdet.json').read()
    want = jloc.ActivityNetDetection(ann, str(tmp_path / 'jdet.json'),
                                     tiou_thresholds=np.linspace(
                                         0.5, 0.95, 10)).evaluate()
    assert_same(list(want), [got['mAP'], got['average_mAP']])

    sroot, sann = ssn
    infos = tloc.load_localize_proposal_file(sann)
    lines = []
    for idx, (vid, n, gts, props) in enumerate(infos):
        lines += [f'# {idx}', vid, '1', '1', str(len(gts))]
        lines += [f'{g[0]} {int(g[1]) / n:.4f} {int(g[2]) / n:.4f}'
                  for g in gts]
        lines += [str(len(props))] + [
            f'{p[0]} {p[1]} {p[2]} {int(p[3]) / n:.4f} {int(p[4]) / n:.4f}'
            for p in props]
    out = {}
    for who in ('jax', 'port'):
        norm = tmp_path / who / 'normalized_props.txt'
        norm.parent.mkdir(exist_ok=True)
        norm.write_text('\n'.join(lines) + '\n')
        if who == 'jax':
            _jax_tool('tools/data/denormalize_proposal_file.py',
                      [str(norm), sroot])
        else:
            denormalize_proposal_file.main([str(norm), sroot])
        out[who] = (tmp_path / who / 'props.txt').read_text()
    assert out['jax'] == out['port']
    assert len(tloc.load_localize_proposal_file(
        str(tmp_path / 'port' / 'props.txt'))) == len(infos)
