"""The skeleton data path, batch blending and the new classification losses
of the port against mscl_tpu's, on the CPU: UniformSampleFrames (its three
regimes and the seeded test mode), PoseDecode, GeneratePoseTarget (joint
and limb heatmaps, ``double``), LoadKineticsPose, PoseCompact, PoseDataset
(``valid_ratio``, ``box_thr``) and the PoseC3D configs' pipelines, bitwise;
MixupBlending and CutmixBlending on JAX's replayed draws within 1e-6; the
losses within 1e-6 relative.
"""
import copy
import os.path as osp
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_torch.config import Config
from mscl_torch.datasets import CutmixBlending, MixupBlending
from mscl_torch.datasets import build_dataset as t_build_dataset
from mscl_torch.models import LOSSES as T_LOSSES
from mscl_tpu.datasets import build_dataset as j_build_dataset
from mscl_tpu.datasets.blending import CutmixBlending as JCutmix
from mscl_tpu.datasets.blending import MixupBlending as JMixup
from mscl_tpu.models import LOSSES as J_LOSSES

from test_torch_pipelines import assert_same
from test_torch_transforms import _both

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
POSE_CONFIGS = ['slowonly_r50_u48_240e_ntu60_xsub_keypoint.py',
                'slowonly_r50_u48_240e_ntu120_xsub_keypoint.py',
                'slowonly_r50_u48_240e_ntu60_xsub_limb.py']


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def skeletons(n, frames, hw=(56, 56), persons=2, seed=0, extra=False):
    """NTU-shaped samples: ``persons`` x ``frames`` x 17 COCO keypoints
    wandering inside ``hw``, with scores, some joints missing."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = frames if isinstance(frames, int) else frames[i % len(frames)]
        base = rng.uniform(8, min(hw) - 8, (persons, 1, 17, 2))
        kp = base + np.cumsum(rng.normal(0, 0.7, (persons, t, 17, 2)), 1)
        score = rng.uniform(0, 1, (persons, t, 17)).astype(np.float32)
        score[rng.uniform(size=score.shape) < 0.1] = 0
        item = dict(frame_dir=f'S001C001P001R001A{i:03d}', total_frames=t,
                    img_shape=hw, original_shape=hw, label=i % 5,
                    keypoint=kp.astype(np.float32), keypoint_score=score)
        if extra:
            item.update(valid_frames=int(t * rng.uniform(0.3, 1)),
                        box_score=list(rng.uniform(0, 1, 6)),
                        **{f'valid@{b}': int(t * rng.uniform(0.3, 1))
                           for b in ('0.5', '0.7')})
        out.append(item)
    return out


@pytest.mark.parametrize('total', [20, 48, 60, 96, 150])
@pytest.mark.parametrize('num_clips,test_mode', [(1, False), (1, True),
                                                 (10, True)])
def test_uniform_sample_frames_matches(total, num_clips, test_mode):
    cfg = [dict(type='UniformSampleFrames', clip_len=48,
                num_clips=num_clips, test_mode=test_mode),
           dict(type='PoseDecode')]
    sample = skeletons(1, total)[0]
    sample['start_index'] = 0
    for seed in range(3):
        out = _both(cfg, sample, seed)
        assert out['keypoint'].shape == (2, 48 * num_clips, 17, 2)
    if test_mode:       # reseeded: the same clips whatever the state
        _seed(5)
        a = _both(cfg, sample, 11)
        assert_same(a['frame_inds'], _both(cfg, sample, 12)['frame_inds'])


@pytest.mark.parametrize('kw', [dict(), dict(use_score=False),
                                dict(with_kp=False, with_limb=True),
                                dict(with_limb=True, double=True,
                                     sigma=1.3)])
def test_generate_pose_target_matches(kw):
    sample = skeletons(1, 6)[0]
    sample['keypoint'][0, 2, 3] = [0.2, 55.9]           # at the edge
    sample['keypoint'][1, 1, 5] = sample['keypoint'][1, 1, 7]   # a dot limb
    out = _both([dict(type='GeneratePoseTarget', **kw),
                 dict(type='FormatShape', input_format='NCTHW_Heatmap')],
                dict(sample, num_clips=1, clip_len=6))
    k = (17 if kw.get('with_kp', True) else 0) + \
        (17 if kw.get('with_limb') else 0)
    assert out['imgs'].shape == (2 if kw.get('double') else 1, k, 6, 56, 56)
    assert out['imgs'].max() > 0.5


def test_pose_compact_matches():
    for seed, kw in enumerate([dict(), dict(hw_ratio=1.0),
                               dict(hw_ratio=(0.5, 2.0), allow_imgpad=False,
                                    padding=0.4), dict(threshold=100)]):
        sample = skeletons(1, 5, hw=(120, 200), seed=seed)[0]
        sample['keypoint'][0, 1, 2] = np.nan
        _both([dict(type='PoseCompact', **kw)], sample)


@pytest.mark.parametrize('max_person', [100, 2])
def test_load_kinetics_pose_matches(tmp_path, max_person):
    rng = np.random.default_rng(7)
    kps = rng.uniform(0, 1, (23, 17, 3)).astype(np.float32)
    path = str(tmp_path / 'kp.pkl')
    with open(path, 'wb') as f:
        pickle.dump(kps, f)
    frame_inds = np.sort(rng.integers(3, 40, 23))
    for source in ('mmpose', 'openpose'):
        results = dict(filename=path, total_frames=50, img_shape=(64, 80),
                       frame_inds=frame_inds, box_score=list(range(23)))
        n = 18 if source == 'openpose' else 17
        if source == 'openpose':
            with open(path, 'wb') as f:
                pickle.dump(rng.uniform(0, 1, (23, n, 3)).astype(np.float32),
                            f)
        out = _both([dict(type='LoadKineticsPose', source=source,
                          max_person=max_person)], results)
        assert out['keypoint'].shape[0] <= max_person


@pytest.mark.parametrize('kw', [dict(), dict(valid_ratio=0.6),
                                dict(valid_ratio=0.5, box_thr='0.7')])
def test_pose_dataset_matches(tmp_path, kw):
    ann = str(tmp_path / 'train.pkl')
    with open(ann, 'wb') as f:
        pickle.dump(skeletons(6, (30, 70), extra=True), f)
    pipeline = [dict(type='UniformSampleFrames', clip_len=8),
                dict(type='PoseDecode'),
                dict(type='GeneratePoseTarget', with_limb=True),
                dict(type='FormatShape', input_format='NCTHW_Heatmap'),
                dict(type='Collect', keys=['imgs', 'label'], meta_keys=[])]
    cfg = dict(type='PoseDataset', ann_file=ann, pipeline=pipeline, **kw)
    j, t = j_build_dataset(copy.deepcopy(cfg)), t_build_dataset(cfg)
    assert len(j) == len(t) and len(t) > 0
    assert_same(j.video_infos, t.video_infos)
    for i in range(len(t)):
        _seed(i)
        a = j[i]
        _seed(i)
        assert_same(a, t[i])


def test_ntu120_has_ntu60s_pipelines():
    a, b = (Config.fromfile(osp.join(ROOT, 'configs', 'skeleton', 'posec3d',
                                     n)).data for n in POSE_CONFIGS[:2])
    for split in ('train', 'val', 'test'):
        assert a[split].to_dict()['pipeline'] == \
            b[split].to_dict()['pipeline']


@pytest.mark.parametrize('name', [POSE_CONFIGS[0], POSE_CONFIGS[2]])
def test_posec3d_config_pipelines_match(tmp_path, name):
    """Each PoseC3D config's splits, item for item, on NTU-shaped
    skeletons at 56x56 (NTU-120's are NTU-60's); the limb config's train
    pipeline is refused, as the JAX package refuses it (its Flip takes no
    left_kp)."""
    ann = str(tmp_path / 'ntu.pkl')
    with open(ann, 'wb') as f:
        pickle.dump(skeletons(2, (100, 40)), f)
    cfg = Config.fromfile(osp.join(ROOT, 'configs', 'skeleton', 'posec3d',
                                   name))
    for split in ('train', 'val', 'test'):
        ds = dict(cfg.data[split].to_dict(), ann_file=ann)
        if 'limb' in name and split == 'train':
            for build in (j_build_dataset, t_build_dataset):
                with pytest.raises(TypeError, match='left_kp'):
                    build(copy.deepcopy(ds))
            continue
        j, t = j_build_dataset(copy.deepcopy(ds)), t_build_dataset(ds)
        for i in range(1):
            _seed(i)
            a = j[i]
            _seed(i)
            b = t[i]
            assert_same(a, b)
        clips = 20 if split == 'test' else 1
        assert b['imgs'].shape == (clips, 17, 48, 56, 56)


# ------------------------------------------------------------- blending

@pytest.mark.parametrize('cls', ['mixup', 'cutmix'])
def test_blending_on_jax_draws(cls):
    rng = np.random.default_rng(0)
    nthwc = rng.normal(size=(6, 3, 14, 10, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    imgs = torch.from_numpy(np.transpose(nthwc, (0, 4, 1, 2, 3)).copy())
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        if cls == 'mixup':
            mixed, soft = JMixup(5, alpha=0.4)(key, jnp.asarray(nthwc),
                                               jnp.asarray(labels))
            k1, k2 = jax.random.split(key)
            draws = {}
        else:
            mixed, soft = JCutmix(5, alpha=0.4)(key, jnp.asarray(nthwc),
                                                jnp.asarray(labels))
            k1, k2, k3, k4 = jax.random.split(key, 4)
            draws = dict(cy=int(jax.random.randint(k3, (), 0, 14)),
                         cx=int(jax.random.randint(k4, (), 0, 10)))
        lam = float(jax.random.beta(k1, 0.4, 0.4))
        perm = torch.from_numpy(np.array(jax.random.permutation(k2, 6)))
        port = MixupBlending if cls == 'mixup' else CutmixBlending
        onehot = torch.nn.functional.one_hot(torch.from_numpy(labels), 5)
        got, got_soft = port.mix(imgs, onehot.float(), lam, perm, **draws)
        np.testing.assert_allclose(
            np.transpose(got.numpy(), (0, 2, 3, 4, 1)), np.array(mixed),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_soft.numpy(), np.array(soft),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('port', [MixupBlending, CutmixBlending])
def test_blending_draws_from_its_generator(port):
    imgs = torch.randn(4, 3, 2, 8, 8, generator=torch.Generator()
                       .manual_seed(1))
    labels = torch.tensor([0, 1, 2, 1])
    runs = [port(3, alpha=0.2)(imgs, labels,
                               torch.Generator().manual_seed(9))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    mixed, soft = runs[0]
    assert mixed.shape == imgs.shape and soft.shape == (4, 3)
    np.testing.assert_allclose(soft.sum(1).numpy(), 1, rtol=1e-6)
    lams = [port(3, alpha=0.2).beta(torch.Generator().manual_seed(s))
            for s in range(400)]
    assert all(0 <= x <= 1 for x in lams)
    assert abs(np.mean(lams) - 0.5) < 0.06        # Beta(a, a)'s mean


# --------------------------------------------------------------- losses

@pytest.mark.parametrize('name,kw', [
    ('BCELossWithLogits', dict()),
    ('BCELossWithLogits', dict(loss_weight=0.5,
                               class_weight=[1.0, 2.0, 0.5, 1.5, 1.0])),
    ('NLLLoss', dict(loss_weight=2.0)),
    ('WeightedCrossEntropyLoss_torch', dict()),
    ('WeightedCrossEntropyLoss_torch', dict(ignore_index=-1,
                                            loss_weight=0.3)),
])
def test_losses_match(name, kw):
    rng = np.random.default_rng(3)
    score = (rng.normal(size=(7, 5)) * 4).astype(np.float32)
    if name == 'NLLLoss':
        score = np.array(jax.nn.log_softmax(score))
    if name == 'BCELossWithLogits':
        label = (rng.uniform(size=(7, 5)) < 0.4).astype(np.float32)
    else:
        label = rng.integers(0, 5, 7)
        label[2] = kw.get('ignore_index', 0)
    extra = {}
    if name.startswith('Weighted'):
        extra = dict(pool_weight=rng.uniform(0, 2, 7).astype(np.float32))
    want = J_LOSSES.build(dict(type=name, **kw))(
        jnp.asarray(score), jnp.asarray(label),
        **{k: jnp.asarray(v) for k, v in extra.items()})
    got = T_LOSSES.build(dict(type=name, **kw))(
        torch.from_numpy(score), torch.from_numpy(label),
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
