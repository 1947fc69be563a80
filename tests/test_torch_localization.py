"""The localizers and their losses in mscl_torch against mscl_tpu's, on the
CPU at narrow sizes: BMN (T 16, 24 features, 8 samples of 2 a bin, hidden
16/8/16), TEM and PEM of width 16, SSN over a 2D ResNet of one Basic
block a stage at 16x16; BMNLoss, BinaryLogisticRegressionLoss, HVULoss and
OHEM.

- The modules from the same converted weights (the port's init carried
  across and perturbed, ``_torch_zoo_util.hold``): outputs within 1e-4 in
  eval and train mode, gradients within rtol 5e-3 / atol 1e-4.
- Each ``train_step``: every logged loss within 2e-4 and the gradients as
  above. BMN's and PEM's balanced samples draw two uniforms; JAX's, taken
  from its step by ``jax.debug.callback``, are replayed into the port's
  ``draw_uniforms`` (the port's own come from a ``torch.Generator``).
- The host helpers (the sample mask, the match map, the label generation,
  the proposals' post-processing) equal bitwise.
- SSN: ``forward_test`` within 1e-4, and two steps of the shipped config,
  narrowed, through ``train_model`` in both packages on the same files
  and weights: the losses within 2e-4, each tensor's change within 5e-3
  of JAX's (relative to its largest change).
- The refusals: ``train_model`` refuses BMN, TEM and PEM by name (JAX's
  fails on their data), and the HVU config's data and target fail in the
  port by name where JAX's fail.
"""
import copy
import json
import os
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mscl_tpu.apis.train as jax_train
import mscl_torch.apis.train as port_train
from mscl_tpu import Config as JaxConfig
from mscl_tpu.core.train_loop import TrainState
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS
from mscl_tpu.models.localizers import bmn as jbmn
from mscl_tpu.models.localizers import ssn as jssn
from mscl_tpu.models.losses import hvu_loss as jhvu
from mscl_tpu.parallel.mesh import create_mesh
from mscl_torch.apis import build_model_from_cfg, train_model
from mscl_torch.config import Config
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.datasets import build_dataset
from mscl_torch.models import RECOGNIZERS
from mscl_torch.models.localizers import bmn as tbmn
from mscl_torch.models.localizers import bsn as tbsn
from mscl_torch.models.localizers import ssn as tssn
from mscl_torch.models.losses import bmn_loss as tbmn_loss
from mscl_torch.models.losses import hvu_loss as thvu

from _torch_localization_util import write_activitynet, write_hvu, \
    write_ssn_set
from _torch_port_util import perturb
from _torch_recognition_util import (FAST_COMPILE, ONE_BASIC, _log, _seed,
                                     cut_tables, port_to_jax)
from _torch_step_util import jax_float64
from _torch_zoo_util import GRAD_TOL, OUT_TOL, hold

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
BMN_KW = dict(temporal_dim=16, feat_dim=24, num_samples=8,
              num_samples_per_bin=2, hidden_dim_1d=16, hidden_dim_2d=8,
              hidden_dim_3d=16)
TEM_KW = dict(temporal_dim=16, tem_feat_dim=24, tem_hidden_dim=16)
PEM_KW = dict(pem_feat_dim=16, pem_hidden_dim=16)
CONFIGS = {
    'BMN': 'localization/bmn/bmn_400x100_2x8_9e_activitynet_feature.py',
    'TEM': 'localization/bsn/bsn_tem_400x100_1x16_20e_activitynet_feature.py',
    'PEM': 'localization/bsn/bsn_pem_400x100_1x16_20e_activitynet_feature.py',
    'SSN': 'localization/ssn/ssn_r50_450e_thumos14_rgb_train.py',
    'HVU': 'recognition/tsn/tsn_r18_1x1x8_100e_hvu_action_rgb.py',
}


def _gts(n, seed):
    """n videos' ground-truth segments in [0, 1], 1-3 a video."""
    rng = np.random.default_rng(seed)
    return [np.sort(rng.uniform(0, 1, (1 + i % 3, 2)), axis=1)
            .astype(np.float32) for i in range(n)]


def test_sample_mask_match_map_and_labels_bitwise():
    for geometry in ((16, 8, 2, 0.5), (10, 32, 3, 0.5), (7, 4, 3, 0.25)):
        np.testing.assert_array_equal(tbmn.build_interp1d_mask(*geometry),
                                      jbmn.build_interp1d_mask(*geometry))
    np.testing.assert_array_equal(tbmn.build_match_map(16),
                                  jbmn.build_match_map(16))
    gts = _gts(3, 0)
    for jkw, tname, kw in ((BMN_KW, 'BMN', BMN_KW), (TEM_KW, 'TEM', TEM_KW)):
        want = JAX_RECOGNIZERS.get(tname)(**jkw).generate_labels(gts)
        got = RECOGNIZERS.get(tname)(**kw).generate_labels(
            [torch.from_numpy(g) for g in gts])
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('name', ['BMN', 'TEM', 'PEM'])
def test_module_matches_jax(name):
    """Outputs in eval and train mode and the gradients, from the same
    weights (no BN and no dropout in these three)."""
    kw = dict(BMN=BMN_KW, TEM=TEM_KW, PEM=PEM_KW)[name]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 16) if name == 'PEM' else
                   (2, 16, 24)).astype(np.float32)
    hold(lambda dtype: JAX_RECOGNIZERS.get(name)(dtype=dtype, **kw),
         RECOGNIZERS.get(name)(**kw), x)


def _recorded_uniforms(masks):
    """jax.random.uniform also appending each draw to ``masks`` as the
    (traced) step runs, in order; the caller puts it back."""
    real = jax.random.uniform

    def uniform(*args, **kwargs):
        out = real(*args, **kwargs)
        jax.debug.callback(lambda v: masks.append(np.asarray(v)), out,
                           ordered=True)
        return out
    return real, uniform


def _jax_step(name, kw, batch, init):
    """JAX's train_step of ``name`` from the port's ``init`` weights: the
    log vars, the gradients as a state dict and the uniforms it drew."""
    jmodel = JAX_RECOGNIZERS.get(name)(**kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda r: jmodel.init(
        {'params': r, 'moco': r}, jbatch, method='train_step'),
        jax.random.PRNGKey(0))
    variables = port_to_jax(shapes, init, jnp.float32)
    variables = {'params': perturb(variables['params'], 2)}
    draws = []
    real, jax.random.uniform = _recorded_uniforms(draws)
    try:
        def loss_fn(params):
            return jmodel.apply({'params': params}, jbatch,
                                method='train_step',
                                rngs={'moco': jax.random.PRNGKey(7)})
        (_, log_vars), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True), compiler_options=FAST_COMPILE)(
            variables['params'])
        jax.effects_barrier()
    finally:
        jax.random.uniform = real
    return (variables, {k: float(v) for k, v in log_vars.items()},
            jax_to_state_dict({'params': grads}), draws)


@pytest.mark.parametrize('name', ['BMN', 'TEM', 'PEM'])
def test_train_step_matches_jax(name, monkeypatch):
    """The losses of one train_step within 2e-4 and the gradients within
    rtol 5e-3 / atol 1e-4, BMN's and PEM's sample draws replayed."""
    kw = dict(BMN=BMN_KW, TEM=TEM_KW, PEM=PEM_KW)[name]
    model = RECOGNIZERS.get(name)(**kw)
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    if name == 'PEM':
        batch = dict(bsp_feature=rng.normal(size=(2, 12, 16)),
                     reference_temporal_iou=rng.uniform(0, 1, (2, 12)))
    else:
        labels = model.generate_labels(_gts(2, 3))
        keys = ('label_confidence' if name == 'BMN' else 'label_action',
                'label_start', 'label_end')
        batch = dict(raw_feature=rng.normal(size=(2, 16, 24)),
                     **dict(zip(keys, labels)))
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    variables, want, grads, draws = _jax_step(
        name, kw, batch, {k: v.numpy() for k, v in
                          model.state_dict().items()})
    assert len(draws) == (0 if name == 'TEM' else 2)
    load_jax_variables(model, variables)
    replay = iter(draws)
    module = tbsn if name == 'PEM' else tbmn_loss
    monkeypatch.setattr(module, 'draw_uniforms', lambda gen, shape, dev: (
        torch.tensor(next(replay)), torch.tensor(next(replay))))
    model.train()
    loss, log_vars = model.train_step(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(log_vars) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(log_vars[k].item(), v, err_msg=k,
                                   **LOSS_TOL)
    loss.backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(grads)
    for k in grads:
        np.testing.assert_allclose(got[k], grads[k], err_msg=k, **GRAD_TOL)


def test_bmn_and_pem_draw_from_the_model_generator():
    """The port's own draws: seeded by seed_dropout, the same numbers again
    after set_dropout_state, other numbers from another seed."""
    model = RECOGNIZERS.get('PEM')(**PEM_KW)
    model.init_weights(torch.Generator().manual_seed(0))
    batch = dict(bsp_feature=torch.randn(2, 40, 16),
                 reference_temporal_iou=torch.rand(2, 40))
    model.seed_dropout(3)
    first = model.train_step(batch)[0]
    state = model.dropout_state()
    second = model.train_step(batch)[0]
    model.set_dropout_state(state)
    assert model.train_step(batch)[0].item() == second.item()
    model.seed_dropout(3)
    assert model.train_step(batch)[0].item() == first.item()


HVU_CASES = {
    'all': dict(loss_type='all'),
    'all_masked': dict(loss_type='all', with_mask=True),
    'individual': dict(loss_type='individual'),
    'individual_sum_masked': dict(loss_type='individual', with_mask=True,
                                  reduction='sum',
                                  category_loss_weights=(1, 2, 0.5)),
}


@pytest.mark.parametrize('case', sorted(HVU_CASES))
def test_hvu_loss_matches_jax(case):
    """Every logged loss within 2e-4 and the gradient on the scores within
    rtol 5e-3 / atol 1e-4, with and without the tag and category masks."""
    kw = dict(dict(categories=('action', 'scene', 'object'),
                   category_nums=(5, 3, 4), category_loss_weights=(1, 1, 1)),
              **HVU_CASES[case])
    rng = np.random.default_rng(4)
    score = rng.normal(size=(4, 12)).astype(np.float32)
    label = (rng.uniform(size=(4, 12)) > 0.7).astype(np.float32)
    mask = (rng.uniform(size=(4, 12)) > 0.3).astype(np.float32)
    cmask = np.array([[1, 0, 1], [1, 1, 1], [0, 1, 0], [1, 0, 0]],
                     np.float32)
    jloss = jhvu.HVULoss(**kw)

    def jfn(s):
        out = jloss(s, jnp.asarray(label), mask=jnp.asarray(mask),
                    category_mask=jnp.asarray(cmask))
        return out['loss_cls'], out
    (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(score))
    s = torch.from_numpy(score).requires_grad_()
    got = thvu.HVULoss(**kw)(s, torch.from_numpy(label),
                             mask=torch.from_numpy(mask),
                             category_mask=torch.from_numpy(cmask))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   err_msg=k, **LOSS_TOL)
    got['loss_cls'].backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgrad),
                               **GRAD_TOL)


@pytest.mark.parametrize('is_positive,ratio,group', [(1, 1.0, 4),
                                                     (-1, 0.17, 8),
                                                     (-1, 0.5, 6)])
def test_ohem_hinge_loss_matches_jax(is_positive, ratio, group):
    """The sum of each group's kept losses within 2e-4 and its gradient as
    above. The scores are distinct draws, so no two losses tie (with ties
    the sum would be the same whichever the top-k keeps)."""
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(4 * group, 5)).astype(np.float32)
    labels = rng.integers(1, 6, 4 * group).astype(np.int32)
    want, jgrad = jax.value_and_grad(lambda p: jhvu.ohem_hinge_loss(
        p, jnp.asarray(labels), is_positive, ratio, group))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = thvu.OHEMHingeLoss(ratio, group, is_positive)(
        p, torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    got.backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_proposals_from_outputs_bitwise():
    """BMN's and PEM's host post-processing (peaks, soft-NMS, seconds) on
    the same scores give equal proposal lists."""
    rng = np.random.default_rng(6)
    info = dict(duration_frame=256, duration_second=8.0, video_name='v_x')
    conf = rng.uniform(size=(16, 16, 2)).astype(np.float32)
    start, end = rng.uniform(size=(2, 16)).astype(np.float32)
    want = JAX_RECOGNIZERS.get('BMN')(**BMN_KW).proposals_from_outputs(
        conf, start, end, info)
    got = RECOGNIZERS.get('BMN')(**BMN_KW).proposals_from_outputs(
        torch.from_numpy(conf), torch.from_numpy(start),
        torch.from_numpy(end), info)
    assert want and got == want
    cols = rng.uniform(size=(5, 30)).astype(np.float32)
    cols[1] = cols[0] + 0.2
    want = JAX_RECOGNIZERS.get('PEM')(**PEM_KW).proposals_from_outputs(
        *cols, info)
    got = RECOGNIZERS.get('PEM')(**PEM_KW).proposals_from_outputs(
        *[torch.from_numpy(c) for c in cols], info)
    assert want and got == want


SSN_CFG = dict(ssn=dict(
    sampler=dict(num_per_video=8, positive_ratio=1, background_ratio=1,
                 incomplete_ratio=6),
    loss_weight=dict(comp_loss_weight=0.1, reg_loss_weight=0.1)))


def test_stpp_and_ssn_loss_match_jax():
    """STPP (a two-part course stage) within 1e-6, and SSNLoss's three
    losses within 2e-4 on the same scores."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(6, 9, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (6, 2)).astype(np.float32)
    for stage in ((1, 1, 1), (1, (1, 2), 1)):
        want = jssn.stpp_train(jnp.asarray(x), jnp.asarray(scale), stage)
        got = tssn.stpp_train(torch.from_numpy(x), torch.from_numpy(scale),
                              stage)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    n = 16
    act = rng.normal(size=(n, 4)).astype(np.float32)
    comp = rng.normal(size=(n, 3)).astype(np.float32)
    reg = rng.normal(size=(n, 3, 2)).astype(np.float32)
    ptype = np.tile([0] + [1] * 6 + [2], 2).astype(np.int32)
    labels = np.where(ptype == 2, 0, rng.integers(1, 4, n)).astype(np.int32)
    targets = rng.normal(size=(n, 2)).astype(np.float32)
    want = jssn.SSNLoss()(*map(jnp.asarray, (act, comp, reg, ptype, labels,
                                             targets)), SSN_CFG)
    got = tssn.SSNLoss()(*map(torch.from_numpy, (act, comp, reg, ptype,
                                                 labels, targets)), SSN_CFG)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   err_msg=k, **LOSS_TOL)


@pytest.fixture(scope='module')
def ssn_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ssn'))
    return root, write_ssn_set(root, cv2.imwrite)


def _ssn_cfg(root, ann, work_dir):
    """The shipped SSN config narrowed: ResNet of one Basic block a stage
    (under ``cut_tables``), 3 classes, frames resized to 20 short edge and
    cropped 16, 1 epoch of 2 steps (one video a step), a log line a
    step."""
    cfg = Config.fromfile(osp.join(ROOT, 'configs', CONFIGS['SSN'])).to_dict()
    cfg['model']['backbone']['depth'] = ONE_BASIC
    cfg['model']['cls_head'].update(in_channels=512, num_classes=3)
    cfg['data']['train'].update(ann_file=ann, data_prefix=root)
    for t in cfg['data']['train']['pipeline']:
        if t['type'] == 'Resize':
            t['scale'] = (16, 16) if t.get('keep_ratio') is False \
                else (24, 20)
    cfg.update(total_epochs=1, work_dir=work_dir,
               checkpoint_config=dict(interval=1),
               log_config=dict(interval=1))
    return cfg


def test_ssn_forward_test_matches_jax(ssn_set):
    """SSN's test scores (activity, completeness, regression) from the same
    perturbed weights on the same clips, within 1e-4."""
    cfg = _ssn_cfg(*ssn_set, 'unused')['model']
    rng = np.random.default_rng(9)
    imgs = rng.normal(size=(1, 4, 9, 3, 16, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (1, 4, 2)).astype(np.float32)
    with cut_tables():
        model = build_model_from_cfg(cfg, device='cpu')
        jcfg = dict(cfg)
        jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
        shapes = jax.eval_shape(lambda r: jmodel.init(
            {'params': r, 'dropout': r}, jnp.asarray(imgs),
            jnp.asarray(scale)), jax.random.PRNGKey(0))
        variables = port_to_jax(shapes, {k: v.numpy() for k, v in
                                         model.state_dict().items()},
                                jnp.float32)
        variables = {'params': perturb(variables['params'], 2),
                     'batch_stats': perturb(variables['batch_stats'], 3)}
        want = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(imgs),
                                              jnp.asarray(scale)),
                       compiler_options=FAST_COMPILE)(variables)
    load_jax_variables(model, variables)
    model.eval()
    with torch.no_grad():
        got = model.forward_test(torch.from_numpy(imgs),
                                 torch.from_numpy(scale))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OUT_TOL)


def test_ssn_train_model_matches_jax(ssn_set, tmp_path, monkeypatch):
    """Two steps of the shipped SSN config (narrowed) through train_model
    in both packages, from the port's initial weights, on the same files
    under the same seeds (the proposal sampling and the crops draw from
    the global generators in the same order): each logged loss within
    2e-4, each tensor's change within 5e-3 of JAX's. Both run in float64
    (JAX with x64, the port's model in float64): two steps at lr 1e-3
    move the BN scales near 1 by about 1e-6, tens of float32 spacings, so
    float32 rounding alone puts their changes 1-3 % apart."""
    root, ann = ssn_set
    cfg = _ssn_cfg(root, ann, str(tmp_path / 'port'))
    real_build = port_train.build_model_from_cfg

    def build64(*args, **kwargs):
        model = real_build(*args, **kwargs).double()
        model.dtype = torch.float64        # SSN casts its frames
        return model
    monkeypatch.setattr(port_train, 'build_model_from_cfg', build64)
    with cut_tables():
        model = build_model_from_cfg(cfg['model'], device='cpu')
        init = {k: v.numpy().astype(np.float64)
                for k, v in model.state_dict().items()}
        real = jax_train.init_state
        mesh = create_mesh(1)

        def init_state(jmodel, tx, example, rng=None, post_init_fn=None):
            """JAX's init_state, the init traced and set to the port's."""
            shapes = jax.eval_shape(lambda r: jmodel.init(
                {'params': r, 'dropout': r, 'moco': r}, example,
                method='train_step'), jax.random.PRNGKey(0))
            variables = port_to_jax(shapes, init, jnp.float64)
            return TrainState(
                step=jnp.zeros((), jnp.int32), params=variables['params'],
                batch_stats=variables['batch_stats'], moco_state={},
                opt_state=jax.jit(tx.init)(variables['params']),
                rng=jax.random.PRNGKey(1))
        jax_train.init_state = init_state
        jcfg = _ssn_cfg(root, ann, str(tmp_path / 'jax'))
        jcfg['model']['dtype'] = jnp.float64
        try:
            with jax_float64():
                _seed()
                _, jstate = jax_train.train_model(
                    JaxConfig.fromdict(jcfg), validate=False, seed=0,
                    mesh=mesh)
        finally:
            jax_train.init_state = real
        _seed()
        example = build_dataset(copy.deepcopy(cfg['data']['train']))
        example[0]                  # JAX's example_batch_from's draws
        runner, tmodel = train_model(Config.fromdict(cfg), validate=False,
                                     seed=0, device='cpu')
    jlog, tlog = _log(str(tmp_path / 'jax')), _log(str(tmp_path / 'port'))
    assert [r['mode'] for r in tlog] == [r['mode'] for r in jlog] == \
        ['train'] * 2
    for j, t in zip(jlog, tlog):
        assert sorted(j) == sorted(t)
        for k in j:
            if k.startswith('loss'):
                np.testing.assert_allclose(t[k], j[k], err_msg=k,
                                           **LOSS_TOL)
    assert runner.optimizer.steps == 2
    final = jax_to_state_dict({'params': jstate.params,
                               'batch_stats': jstate.batch_stats})
    got = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert sorted(got) == sorted(final)
    for k, v in final.items():
        want = np.asarray(v) - init[k]
        err = np.abs(got[k] - init[k] - want).max() / \
            max(np.abs(want).max(), 1e-12)
        assert err <= 5e-3, (k, err)


@pytest.mark.parametrize('name', ['BMN', 'TEM', 'PEM'])
def test_train_model_refuses_by_name(name, tmp_path):
    """JAX's train_model fails on these configs' data (ragged rows, no
    label step): the port refuses them before building anything."""
    cfg = Config.fromfile(osp.join(ROOT, 'configs', CONFIGS[name]))
    cfg.merge_from_dict(dict(work_dir=str(tmp_path)))
    with pytest.raises(NotImplementedError, match=name):
        train_model(cfg, validate=False, device='cpu')


def _write_pgm(root, ann, rows):
    """PGM proposal csv and BSP feature files (16 wide) for each video of
    ``ann``: ``rows(i)`` rows for the i-th video."""
    rng = np.random.default_rng(1)
    dirs = osp.join(root, 'pgm_proposals'), osp.join(root, 'pgm_features')
    for d in dirs:
        os.makedirs(d)
    for i, name in enumerate(json.load(open(ann))):
        np.savetxt(osp.join(dirs[0], name + '.csv'),
                   rng.uniform(size=(rows(i), 6)), delimiter=',',
                   header='tmin,tmax,tmin_score,tmax_score,score,match_iou',
                   comments='')
        np.save(osp.join(dirs[1], name + '.npy'),
                rng.normal(size=(rows(i), 16)).astype(np.float32))
    return dirs


# (model, its rows, JAX's error, its message): 'ragged' as shipped (a
# gt_bbox of 1-3 segments a video; PEM's proposals 3 or 4 rows a video),
# 'even' with one segment (and 5 proposals) a video
JAX_TRAIN_FAULTS = (
    ('BMN', 'ragged', ValueError, 'same shape'),      # datasets/loader.py:41
    ('BMN', 'even', KeyError, 'label_confidence'),    # localizers/bmn.py:181
    ('TEM', 'ragged', ValueError, 'same shape'),
    ('TEM', 'even', TypeError, "of type <class 'str'>"),  # train_loop.py:57
    ('PEM', 'ragged', ValueError, 'same shape'),
    ('PEM', 'even', TypeError, "of type <class 'str'>"))


@pytest.mark.parametrize('name,rows,error,match', JAX_TRAIN_FAULTS)
def test_jax_cannot_train_as_shipped(name, rows, error, match, tmp_path):
    """The faults behind the refusals, on JAX's side, each model at its
    narrow width: the shipped pipelines give a ragged gt_bbox (PEM's
    LoadProposals ragged rows), which JAX's collate fails to stack; with
    even rows BMN's train_step reads labels no step made, and TEM's and
    PEM's video_meta strings reach the init."""
    root = str(tmp_path)
    ann, feats = write_activitynet(root, 4, 20, 24)
    if rows == 'even':
        anno = json.load(open(ann))
        for video in anno.values():
            video['annotations'] = video['annotations'][:1]
        with open(ann, 'w') as f:
            json.dump(anno, f)
    cfg = JaxConfig.fromfile(osp.join(ROOT, 'configs', CONFIGS[name]))
    cfg = cfg.to_dict()
    cfg['model'].update(dict(BMN=BMN_KW, TEM=TEM_KW, PEM=PEM_KW)[name])
    cfg['data'].update(videos_per_gpu=2, workers_per_gpu=0)
    cfg['data']['train'].update(ann_file=ann, data_prefix=feats)
    if name == 'PEM':
        props, bsp = _write_pgm(root, ann, lambda i: 5 if rows == 'even'
                                else 3 + i % 2)
        for step in cfg['data']['train']['pipeline']:
            if step['type'] == 'LoadProposals':
                step.update(pgm_proposals_dir=props, pgm_features_dir=bsp)
    else:
        cfg['data']['train'].update(temporal_dim=16)
    cfg.update(total_epochs=1, work_dir=osp.join(root, 'jax'))
    with pytest.raises(error, match=match):
        jax_train.train_model(JaxConfig.fromdict(cfg), validate=False,
                              seed=0, mesh=create_mesh(1))


def test_hvu_config_fails_by_name(tmp_path):
    """tsn_r18_1x1x8_100e_hvu_action_rgb: JAX's HVUDataset hands
    RawFrameDecode a None filename_tmpl; with one, its LoadHVULabel meets
    the one-hot array the dataset made; and its Recognizer2D flattens the
    one-hot target, which HVULoss cannot index. The port fails at each of
    these by name (the last is Recognizer2D's multi_class refusal)."""
    root = str(tmp_path)
    ann = write_hvu(root, cv2.imwrite, category_nums=(('action', 739),))
    cfg = Config.fromfile(osp.join(ROOT, 'configs', CONFIGS['HVU']))
    data = dict(cfg.data['train'].to_dict(), ann_file=ann, data_prefix=root)
    with pytest.raises(ValueError, match='filename_tmpl'):
        build_dataset(copy.deepcopy(data))[0]
    with pytest.raises(TypeError, match='LoadHVULabel'):
        build_dataset(dict(data, filename_tmpl='img_{:05d}.jpg'))[0]
    model_cfg = cfg.model.to_dict()
    model_cfg['backbone']['depth'] = ONE_BASIC
    imgs = np.zeros((2, 2, 3, 16, 16), np.float32)
    label = np.zeros((2, 739), np.float32)
    label[:, 3] = 1
    with cut_tables():
        jcfg = dict(model_cfg)
        jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
        with pytest.raises(IndexError):
            jax.eval_shape(lambda: jmodel.init(
                {'params': jax.random.PRNGKey(0),
                 'dropout': jax.random.PRNGKey(1)},
                dict(imgs=jnp.asarray(imgs), label=jnp.asarray(label)),
                method='train_step'))
        model = build_model_from_cfg(model_cfg, device='cpu')
    with pytest.raises(NotImplementedError, match='multi_class'):
        model.train_step(dict(imgs=torch.from_numpy(imgs),
                              label=torch.from_numpy(label)))
