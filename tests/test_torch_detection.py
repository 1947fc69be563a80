"""The AVA detection slice of the port against mscl_tpu's, on the CPU:

- ``roi_align``: RoIs inside, partly and wholly off the map, tiny ones and
  the zero padding rows, ``aligned`` on and off, two sampling grids;
  the output and its gradient within 1e-5;
- ``merge_pathways`` and ``SingleRoIExtractor3D`` (SlowFast's pathways
  resized, avg and max temporal pools, ``with_global``'s antialiased
  resize), ``BBoxHeadAVA`` with its focal loss and metrics, the FBO heads
  on a sampled bank, and ``LFBInferHead`` / ``LFB``'s files and draws;
- three narrowed detectors whole (SlowFast 8x8 with temporal max, the
  focal loss and ``with_global``; LFB non-local; ACRN):
  ``forward_test`` within 1e-4, a ``train_step`` (losses, metrics,
  gradients, BN statistics) with JAX's dropout masks replayed
  (``_torch_model_util``) in float64 in both packages (the narrowed
  depth-50 stacks' train-mode BN is ill-conditioned in float32, as
  tests/test_torch_resnet3d.py measures: the stem's kernel gradients lie
  up to 3.6e-4 apart there), and each parameter's JAX path;
- two ``train_model`` steps of ``ava/slowonly_r50_4x16x1_20e_ava_rgb.py``
  narrowed, in both packages, over a synthetic AVA set: every logged
  value within 2e-4, each tensor's change within 5e-3;
- the detector's dropout generators, saved and put back, as a resumed run
  needs them.
"""
import copy
import os.path as osp
import pickle
import random

import cv2
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
import numpy as np
import pytest
import torch

import mscl_tpu.apis.train as jax_train
from mscl_torch.apis import build_model_from_cfg, train_model
from mscl_torch.config import Config
from mscl_torch.convert import jax_param_paths, jax_to_state_dict
from mscl_torch.datasets import build_dataset
from mscl_torch.core import (build_lr_schedule, build_optimizer,
                             save_checkpoint, train_state)
from mscl_torch.models import detection as tdet
from mscl_torch.models.heads import lfb as tlfb
from mscl_torch.models.heads.base import RateDropout
from mscl_torch.ops.roi_align import roi_align
from mscl_tpu import Config as JaxConfig
from mscl_tpu.core.train_loop import TrainState
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS
from mscl_tpu.models import detection as jdet
from mscl_tpu.models.heads import lfb as jlfb
from mscl_tpu.ops.roi_align import roi_align as jax_roi_align
from mscl_tpu.parallel.mesh import create_mesh

from _torch_ava_util import write_ava_set
from _torch_model_util import carry, hold_eval, hold_train
from _torch_recognition_util import (_fast_compiled_but_the_step, _log,
                                     port_to_jax, recorded_bernoulli,
                                     replay_dropout)
from test_torch_optim_precise_bn import _paths_by_name

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
DET = osp.join(ROOT, 'configs', 'detection')
TOL = dict(rtol=1e-5, atol=1e-5)
OUT_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------- RoIAlign

ROIS = np.array([[0, 1.3, 2.2, 60.1, 70.4],     # partly off (bottom right)
                 [1, -20.0, -10.0, 30.0, 25.0],  # partly off (top left)
                 [1, 100.0, 90.0, 140.0, 120.0],  # wholly off
                 [0, 10.0, 10.0, 10.2, 10.1],    # under a pixel
                 [0, 0.0, 0.0, 0.0, 0.0],        # a padding row
                 [1, 5.5, 7.25, 40.0, 33.0]], np.float32)


@pytest.mark.parametrize('aligned', [True, False])
def test_roi_align_matches_jax(aligned):
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    for size, ratio in ((4, 2), (3, 1)):
        want, vjp = jax.vjp(lambda f: jax_roi_align(
            f, jnp.asarray(ROIS), size, 1 / 8, ratio, aligned),
            jnp.asarray(feat))
        ft = torch.from_numpy(feat).requires_grad_()
        got = roi_align(ft, torch.from_numpy(ROIS), size, 1 / 8, ratio,
                        aligned)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        cot = rng.normal(size=want.shape).astype(np.float32)
        got.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(ft.grad.numpy(),
                                   np.asarray(vjp(jnp.asarray(cot))[0]),
                                   **TOL)
    assert np.abs(_np(got)[2]).max() == 0          # wholly off the map


# --------------------------------------------------- extractor and bbox head

@pytest.mark.parametrize('mode,pool,glob', [('avg', True, True),
                                            ('max', True, False),
                                            ('avg', False, True)])
def test_extractor_matches_jax(mode, pool, glob):
    """SlowFast's two maps (T 2 and 8, 8x8) -> RoI features; with
    ``with_global`` the whole frame shrunk to 3x3 with antialiasing."""
    rng = np.random.default_rng(1)
    slow = rng.normal(size=(2, 6, 2, 8, 8)).astype(np.float32)
    fast = rng.normal(size=(2, 3, 8, 8, 8)).astype(np.float32)
    kw = dict(featmap_stride=8, output_size=3, with_temporal_pool=pool,
              temporal_pool_mode=mode, with_global=glob)
    want = jdet.SingleRoIExtractor3D(**kw).apply(
        {}, tuple(jnp.asarray(np.transpose(f, (0, 2, 3, 4, 1)))
                  for f in (slow, fast)), jnp.asarray(ROIS))
    got = tdet.SingleRoIExtractor3D(**kw)(
        (torch.from_numpy(slow), torch.from_numpy(fast)),
        torch.from_numpy(ROIS))
    assert got.shape == want.shape == (6, 1 if pool else 8, 3, 3,
                                       (6 + 3) * (2 if glob else 1))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize('focal', [(1.0, 0.0), (3.0, 1.0)])
def test_bbox_head_loss_matches_jax(focal):
    """The head on 5-D RoI features and on pooled (R, C) ones: scores,
    the focal BCE over the rows with a positive (padding rows' weight 0),
    recall and precision at 0.5 and the top k, and the gradients."""
    alpha, gamma = focal
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 2, 3, 3, 8)).astype(np.float32)
    labels = (rng.random((6, 9)) > 0.6).astype(np.float32)
    labels[3] = 0                                   # a negative row
    valid = np.array([1, 1, 1, 1, 1, 0], np.float32)
    kw = dict(in_channels=8, num_classes=9, focal_alpha=alpha,
              focal_gamma=gamma, topk=(2, 3))
    jhead = jdet.BBoxHeadAVA(**kw)
    for inp in (x, x.max(axis=(1, 2, 3))):
        variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(inp))
        port = tdet.BBoxHeadAVA(**kw)
        port.fc_cls.weight.data = torch.from_numpy(np.asarray(
            variables['params']['fc_cls']['kernel']).T.copy())
        port.fc_cls.bias.data = torch.from_numpy(np.asarray(
            variables['params']['fc_cls']['bias']).copy())

        def jloss(params, xx):
            score = jhead.apply({'params': params}, xx)
            out = jhead.apply({'params': params}, score, jnp.asarray(labels),
                              jnp.asarray(valid), method='loss')
            return out['loss_action_cls'], out
        (_, jout), (jgrad, jxgrad) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(variables['params'],
                                                 jnp.asarray(inp))
        xt = torch.from_numpy(inp).requires_grad_()
        out = port.loss(port(xt), torch.from_numpy(labels),
                        torch.from_numpy(valid))
        out['loss_action_cls'].backward()
        assert sorted(out) == sorted(jout)
        for k in out:
            np.testing.assert_allclose(_np(out[k]), np.asarray(jout[k]),
                                       err_msg=k, **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jxgrad),
                                   **TOL)
        np.testing.assert_allclose(port.fc_cls.weight.grad.numpy(),
                                   np.asarray(jgrad['fc_cls']['kernel']).T,
                                   **TOL)


# ------------------------------------------------------------------- LFB

def test_lfb_files_draws_and_fbo_heads_match_jax(tmp_path):
    """LFBInferHead's pickle equal after unpickling; LFB's blocks bitwise
    on the same generator; FBOHead ('non_local' in eval mode, 'avg',
    'max') on the sampled bank within 1e-5."""
    rng = np.random.default_rng(3)
    c = 8
    metas = [dict(img_key='vidA,0902'), dict(img_key='vidA,0903'),
             dict(img_key='vidB,0902')]
    x = rng.normal(size=(5, 2, 3, 3, c)).astype(np.float32)
    rois = np.array([[0, 0, 0, 4, 4], [0, 1, 1, 5, 5], [1, 0, 0, 4, 4],
                     [2, 2, 2, 6, 6], [2, 1, 2, 3, 4]], np.float32)
    paths = []
    for mod, d in ((jlfb, tmp_path / 'jax'), (tlfb, tmp_path / 'port')):
        infer = mod.LFBInferHead(str(d), dataset_mode='train')
        arg = torch.from_numpy(x) if mod is tlfb else x
        assert _np(infer(arg, rois, metas)).shape == x.shape
        paths.append(infer.save())
    banks = []
    for p in paths:
        with open(p, 'rb') as f:
            banks.append(pickle.load(f))
    assert banks[0].keys() == banks[1].keys()
    for vid in banks[0]:
        assert banks[0][vid].keys() == banks[1][vid].keys()
        for sec, feats in banks[0][vid].items():
            for a, b in zip(feats, banks[1][vid][sec]):
                assert a.dtype == b.dtype == np.float16
                assert a.tobytes() == b.tobytes()
    kw = dict(max_num_sampled_feat=2, window_size=4, lfb_channels=c,
              dataset_modes=('train',))
    jbank = jlfb.LFB(str(tmp_path / 'jax'), **kw)
    tbank = tlfb.LFB(str(tmp_path / 'port'), **kw)
    keys = ['vidA,0902', 'vidA,0903', 'vidB,0902', 'vidC,0100']
    lt = tlfb.sample_lfb(tbank, keys, np.random.default_rng(4))
    want = jlfb.sample_lfb(jbank, keys, np.random.default_rng(4))
    assert lt.tobytes() == want.tobytes() and lt.shape == (4, 8, c)
    roi_feat = rng.normal(size=(4, 2, 3, 3, c)).astype(np.float32)
    for fbo in (dict(type='non_local', st_feat_channels=c,
                     lt_feat_channels=c, latent_channels=6),
                dict(type='avg'), dict(type='max')):
        jhead = jlfb.FBOHead(fbo_cfg=fbo)
        variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(roi_feat),
                               jnp.asarray(lt))
        variables = jax.tree.map(lambda a: a + 0.1 * jnp.arange(
            a.size, dtype=a.dtype).reshape(a.shape) / a.size, variables)
        port = tlfb.FBOHead(fbo_cfg=fbo, in_channels=c).eval()
        if variables:
            port.load_state_dict({k: torch.from_numpy(v) for k, v in
                                  jax_to_state_dict(variables).items()})
        want = jhead.apply(variables, jnp.asarray(roi_feat), jnp.asarray(lt))
        with torch.no_grad():
            got = port(torch.from_numpy(roi_feat), torch.from_numpy(lt))
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# -------------------------------------------------------- whole detectors

def narrow_detector(model):
    """An AVA config's model narrowed in place: SlowOnly (and SlowFast's
    slow path) to base 8, its fast path to 2, one block a stage; FBO's
    latent width to 16, ACRN's to 32; the head's widths follow."""
    bb = model['backbone']
    if bb['type'] == 'ResNet3dSlowFast':
        bb['slow_pathway'].update(base_channels=8, stage_blocks=(1,) * 4)
        bb['fast_pathway'].update(base_channels=2, stage_blocks=(1,) * 4)
        width = (8 + 2) * 8 * 4
    else:
        bb.update(base_channels=8, stage_blocks=(1,) * 4)
        width = 8 * 8 * 4
    rh = model['roi_head']
    if rh['bbox_roi_extractor'].get('with_global'):
        width *= 2
    sh = rh.get('shared_head')
    if sh and sh['type'] == 'ACRNHead':
        sh.update(in_channels=2 * width, out_channels=32)
        width = 32
    elif sh and sh['type'] == 'FBOHead':
        if sh['fbo_cfg']['type'] == 'non_local':
            sh['fbo_cfg'].update(st_feat_channels=width,
                                 lt_feat_channels=width, latent_channels=16)
            width += 16
        else:
            width *= 2
    rh['bbox_head']['in_channels'] = width
    return model


DETECTORS = {
    'slowfast_max_focal_global': (
        'ava/slowfast_temporal_max_focal_alpha3_gamma1_r50_8x8x1_cosine_10e_'
        'ava22_rgb.py', 8, dict(with_global=True)),
    'lfb_nl': ('lfb/lfb_nl_r50_4x16x1_20e_ava_rgb.py', 4, {}),
    'acrn': ('acrn/slowfast_acrn_r50_8x8x1_cosine_10e_ava22_rgb.py', 4, {}),
}


def _det_batch(rng, frames, b=2, r=4):
    rois = np.concatenate([rng.uniform(0, 30, (b, r, 2)),
                           rng.uniform(34, 64, (b, r, 2))], -1)
    rois[:, -1] = 0                                 # padding rows
    labels = (rng.random((b, r, 81)) > 0.93).astype(np.float32)
    labels[:, 0, 5] = 1                             # a positive a clip
    labels[:, -1] = 0
    weights = np.ones((b, r), np.float32)
    weights[:, -1] = 0
    return dict(imgs=rng.normal(size=(b, 3, frames, 64, 64)).astype(
        np.float32), rois=rois.astype(np.float32), roi_labels=labels,
        roi_weights=weights)


@pytest.mark.parametrize('name', sorted(DETECTORS))
def test_detector_matches_jax(name):
    path, frames, extractor = DETECTORS[name]
    cfg = Config.fromfile(osp.join(DET, path)).to_dict()['model']
    cfg['roi_head']['bbox_roi_extractor'].update(extractor)
    narrow_detector(cfg)
    batch = _det_batch(np.random.default_rng(5), frames)
    port = build_model_from_cfg(copy.deepcopy(cfg), device='cpu')
    jcfg = dict(cfg)
    jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
    variables = carry(jmodel, port, batch)
    assert jax_param_paths(port) == _paths_by_name(variables['params'])
    flat = np.asarray(jdet.AVAFastRCNN.flatten_rois(jnp.asarray(
        batch['rois'])))
    kwargs = {}
    if name == 'lfb_nl':            # a bank's block, as forward_test takes
        kwargs['lt_feat'] = np.random.default_rng(6).normal(
            size=(len(flat), 12, 256)).astype(np.float32)
    scores = hold_eval(jmodel, port, variables, (batch['imgs'], flat),
                       kwargs)
    assert scores.shape == (len(flat), 81)
    jmodel = JAX_RECOGNIZERS.get(cfg['type'])(dtype=jnp.float64, **jcfg)
    log, n_masks = hold_train(jmodel, port, variables, batch, x64=True)
    assert n_masks == len(port._dropouts()) == (5 if name == 'lfb_nl' else 1)
    assert log['loss'] > 0


# ------------------------------------------------------------ train_model

def _ava_cfg(ava, work_dir):
    cfg = Config.fromfile(osp.join(
        DET, 'ava/slowonly_r50_4x16x1_20e_ava_rgb.py')).to_dict()
    narrow_detector(cfg['model'])
    cfg['model']['roi_head']['bbox_head']['dropout_ratio'] = 0.5
    data = cfg['data']
    data.update(videos_per_gpu=2, workers_per_gpu=0)
    data['train'].update(ann_file=ava['ann'], exclude_file=ava['exclude'],
                         proposal_file=ava['proposals'],
                         data_prefix=ava['prefix'])
    for step in data['train']['pipeline']:
        if step['type'] == 'RandomRescale':
            step['scale_range'] = (40, 52)
        elif step['type'] == 'RandomCrop':
            step['size'] = 32
        elif step['type'] == 'AVAAssignSample':
            step['rcnn'] = dict(step['rcnn'], sampler=dict(
                step['rcnn']['sampler'], num=8))
            step['seed'] = 3
    cfg.update(total_epochs=1, work_dir=work_dir, log_config=dict(interval=1),
               checkpoint_config=dict(interval=1))
    return cfg


def _seed(s=0):
    random.seed(s)
    np.random.seed(s)


def test_ava_config_trains_as_in_jax(tmp_path):
    """Two train_model steps of the narrowed SlowOnly AVA config (5
    keyframes, batch 2, 8 RoIs a clip): JAX's dropout masks replayed, every
    logged value within 2e-4, each tensor's change within 5e-3 of the
    largest change of that tensor."""
    ava = write_ava_set(str(tmp_path), cv2.imwrite, n_videos=3,
                        keyframes=(902, 904))
    cfg = _ava_cfg(ava, str(tmp_path / 'port'))
    model = build_model_from_cfg(cfg['model'], device='cpu')
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    mesh = create_mesh(1)
    real = jax_train.init_state

    def init_state(jmodel, tx, example, rng=None, post_init_fn=None):
        init_rng, state_rng = jax.random.split(rng)
        shapes = jax.eval_shape(lambda r, b: jmodel.init(
            {'params': r, 'dropout': r, 'moco': r}, b,
            method='train_step'), init_rng, example)
        v = port_to_jax(shapes, init, jnp.float32)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                           batch_stats=v['batch_stats'], moco_state={},
                           opt_state=jax.jit(tx.init)(v['params']),
                           rng=state_rng)
        return jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    masks = []
    jax_train.init_state = init_state
    try:
        with recorded_bernoulli(masks), _fast_compiled_but_the_step():
            _seed()
            _, jstate = jax_train.train_model(
                JaxConfig.fromdict(_ava_cfg(ava, str(tmp_path / 'jax'))),
                validate=False, seed=0, mesh=mesh)
    finally:
        jax_train.init_state = real
    final = jax_to_state_dict({'params': jstate.params,
                               'batch_stats': jstate.batch_stats})
    assert len(masks) == 2
    opt = build_optimizer(model, dict(cfg['optimizer']),
                          build_lr_schedule({}, 0.0, 1, 1))
    ckpt0 = save_checkpoint(train_state(model, opt), str(tmp_path / 'p0'), 0)
    real_dropout = RateDropout.dropout
    replay_dropout(RateDropout, masks)
    try:
        _seed()
        example = build_dataset(copy.deepcopy(cfg['data']['train']))
        for i in range(2):                # JAX's example_batch_from draws
            example[i]
        runner, _ = train_model(Config.fromdict(cfg), validate=False, seed=0,
                                device='cpu', resume_from=ckpt0)
    finally:
        RateDropout.dropout = real_dropout
    jlog, tlog = _log(str(tmp_path / 'jax')), _log(str(tmp_path / 'port'))
    assert len(jlog) == len(tlog) == 2
    for j, t in zip(jlog, tlog):
        assert sorted(j) == sorted(t)
        for k in j:
            if k == 'mode':
                assert t[k] == j[k]
            elif k not in ('time', 'data_time'):
                np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=2e-4,
                                           err_msg=k)
    assert runner.optimizer.steps == 2
    got = {k: v.numpy() - init[k] for k, v in
           runner.model.state_dict().items()}
    for k, v in final.items():
        want = np.asarray(v) - init[k]
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got[k] - want).max() / scale <= 5e-3, k


def test_dropout_state_resumes_every_site():
    """The detector's dropout generators (the bbox head's and FBO's three
    sites) saved by ``dropout_state`` and put back by
    ``set_dropout_state`` draw the same masks again, as a resumed run
    needs; ``seed_dropout`` seeds each site apart."""
    cfg = Config.fromfile(osp.join(DET, DETECTORS['lfb_nl'][0])) \
        .to_dict()['model']
    narrow_detector(cfg)
    model = build_model_from_cfg(cfg, device='cpu')
    assert len(model._dropouts()) == 5
    batch = {k: torch.from_numpy(v) for k, v in
             _det_batch(np.random.default_rng(7), 4).items()}
    model.train()
    with torch.no_grad():
        model.train_step(batch)
        state = model.dropout_state()
        want = model.train_step(batch)[0]
        other = model.train_step(batch)[0]
        model.set_dropout_state(state)
        got = model.train_step(batch)[0]
    assert got == want and other != want
    assert len({bytes(s.numpy()) for s in state}) == 5
