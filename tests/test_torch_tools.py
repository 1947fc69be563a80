"""The analysis and deployment tools of mscl_torch (``mscl_torch/tools``)
against the JAX package's (``tools/analysis``, ``tools/deployment``), on
the CPU.

- ``print_config``, ``eval_metric``, ``report_accuracy`` and
  ``analyze_logs cal_train_time``: the same printed text as the JAX tool's
  on the same files.
- ``publish_model``: the JAX tool's naming (``-<8 hex of the sha256>``),
  its printed line, the optimizer state gone and the model's state kept.
- ``get_flops``: JAX's parameter count exactly (its params tree, traced);
  the FLOPs within [1.0, 1.1] times XLA's cost analysis of the same
  inference at 224x224. The two count different things: XLA counts the
  taps of a convolution that fall inside its input (not those on the zero
  padding) and the elementwise work (BN, ReLU, pooling, softmax);
  ``FlopCounterMode`` counts every tap, padding included, and only the
  convolutions and matmuls. For the narrowed TSN the padding outweighs
  the elementwise work by 7.6 % (at 64x64, where more of each map is its
  border, by 30 %).
- ``benchmark``: its lines on the CPU (a count of calls, not a timing of
  the card).
- ``export``: the ``torch.export`` program reloaded gives the eager
  model's scores (``--verify``), and the checkpoint's weights are the
  ones exported.
"""
import contextlib
import io
import json
import os.path as osp
import pickle
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from mscl_torch.core import (build_lr_schedule, build_optimizer,
                             load_checkpoint, save_checkpoint, train_state)
from mscl_torch.tools import (analyze_logs, benchmark, eval_metric, export,
                              get_flops, print_config, publish_model,
                              report_accuracy)

from _torch_data_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TSN = osp.join(ROOT, 'configs/recognition/tsn/'
               'tsn_r50_1x1x3_100e_kinetics400_rgb.py')
SWIN = osp.join(ROOT, 'configs/recognition/tsn/custom_backbones/'
                'tsn_swin_base_1x1x3_100e_kinetics400_rgb.py')
NARROW = ['model.backbone.depth=18', 'model.cls_head.in_channels=512',
          'model.cls_head.num_classes=5']


def _jax_tool(rel, argv):
    """The JAX tool's printed text (run as its script)."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [rel] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(osp.join(ROOT, 'tools', rel), run_name='__main__')
    finally:
        sys.argv = saved
    return out.getvalue()


def _port_tool(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(list(argv))
    return out.getvalue(), result


@pytest.mark.parametrize('config', [TSN, SWIN])
def test_print_config_matches_jax(config):
    argv = [config, '--cfg-options', 'data.videos_per_gpu=4']
    got, _ = _port_tool(print_config.main, argv)
    assert got == _jax_tool('analysis/print_config.py', argv)
    assert 'videos_per_gpu=4' in got


@pytest.fixture
def scored(tmp_path):
    """A test list of 12 videos (labels 0-4) and two pickles of scores."""
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 5, 12)
    ann = tmp_path / 'list.txt'
    ann.write_text(''.join(f'video_{i} 40 {lab}\n'
                           for i, lab in enumerate(labels)))
    paths = []
    for k in range(2):
        path = tmp_path / f'scores_{k}.pkl'
        with open(path, 'wb') as f:
            pickle.dump([rng.normal(size=5).astype(np.float32)
                         for _ in labels], f)
        paths.append(str(path))
    return str(ann), paths


def test_eval_metric_matches_jax(scored):
    ann, (scores, _) = scored
    argv = [TSN, scores, '--eval', 'top_k_accuracy', 'mean_class_accuracy',
            '--cfg-options', f'data.test.ann_file={ann}',
            f'data.test.data_prefix={osp.dirname(ann)}']
    got, metrics = _port_tool(eval_metric.main, argv)
    assert got == _jax_tool('analysis/eval_metric.py', argv)
    assert set(metrics) == {'top1_acc', 'top5_acc', 'mean_class_accuracy'}


@pytest.mark.parametrize('softmax', [False, True])
def test_report_accuracy_matches_jax(scored, softmax):
    ann, scores = scored
    argv = ['--scores', *scores, '--coefficients', '1', '0.5',
            '--datalist', ann] + (['--apply-softmax'] if softmax else [])
    got, _ = _port_tool(report_accuracy.main, argv)
    assert got == _jax_tool('analysis/report_accuracy.py', argv)


def test_analyze_logs_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    log = tmp_path / 'log.json'
    records = [dict(mode='train', epoch=1, iter=i + 1, time=float(t),
                    data_time=float(d), loss=float(l))
               for i, (t, d, l) in enumerate(rng.uniform(size=(6, 3)))]
    records.insert(3, dict(mode='val', epoch=1, top1_acc=0.5))
    log.write_text(''.join(json.dumps(r) + '\n' for r in records))
    for extra in ([], ['--include-outliers']):
        argv = ['cal_train_time', str(log)] + extra
        got, _ = _port_tool(analyze_logs.main, argv)
        assert got == _jax_tool('analysis/analyze_logs.py', argv)


def _narrow_model(config):
    from mscl_torch.apis import build_model_from_cfg
    from mscl_torch.config import Config
    cfg = Config.fromfile(config)
    cfg.merge_from_dict({'model.backbone.depth': 18,
                         'model.cls_head.in_channels': 512,
                         'model.cls_head.num_classes': 5})
    return build_model_from_cfg(cfg.model.to_dict(), device='cpu'), cfg


def test_publish_model(tmp_path):
    model, cfg = _narrow_model(TSN)
    opt = build_optimizer(model, dict(type='SGD', lr=0.1, momentum=0.9),
                          build_lr_schedule({}, 0.1, 1, 1))
    path = save_checkpoint(train_state(model, opt), str(tmp_path), 3)
    out, final = _port_tool(publish_model.main,
                            [path, str(tmp_path / 'published.pth')])
    sha = re.fullmatch(r'published to (.*)-([0-9a-f]{8})\.pth\n', out)
    assert sha and sha.group(1) == str(tmp_path / 'published')
    import hashlib
    with open(final, 'rb') as f:
        assert hashlib.sha256(f.read()).hexdigest()[:8] == sha.group(2)
    ckpt = load_checkpoint(final)
    assert ckpt['optimizer'] is None
    for k, v in model.state_dict().items():
        assert torch.equal(ckpt['state_dict'][k], v), k


def test_get_flops_matches_jax():
    """The narrowed TSN at 3 segments of 224x224: the parameters exactly
    as JAX's tree holds them, the FLOPs within [1.0, 1.1] times XLA's
    cost analysis of the same inference (the module's note)."""
    import jax.numpy as jnp
    import mscl_tpu.apis.train as jax_train
    from mscl_tpu import Config as JaxConfig
    shape = [1, 3, 3, 224, 224]
    out, counts = _port_tool(get_flops.main, [
        TSN, '--shape', *map(str, shape), '--device', 'cpu',
        '--cfg-options', *NARROW])
    assert out.splitlines()[0] == f'input shape: {tuple(shape)}'
    jcfg = JaxConfig.fromfile(TSN)
    model_cfg = {k: v for k, v in dict(jcfg.model).items()
                 if k != 'train_cfg'}
    model_cfg['backbone'] = dict(model_cfg['backbone'], depth=18)
    model_cfg['cls_head'] = dict(model_cfg['cls_head'], in_channels=512,
                                 num_classes=5)
    jmodel = jax_train.build_model_from_cfg(model_cfg)
    x = jnp.zeros(shape)
    shapes = jax.eval_shape(lambda r: jmodel.init(
        {'params': r, 'dropout': r}, x, jnp.zeros(1, jnp.int32)),
        jax.random.PRNGKey(0))
    assert counts['params'] == sum(int(np.prod(s.shape)) for s in
                                   jax.tree.leaves(shapes['params']))
    variables = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    cost = jax.jit(lambda v, xx: jmodel.apply(
        v, xx, train=False, return_loss=False)).lower(
        {k: variables[k] for k in ('params', 'batch_stats')}, x
    ).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    ratio = counts['flops'] / cost['flops']
    assert 1.0 <= ratio <= 1.1, (counts['flops'], cost['flops'])


def test_benchmark_lines():
    out, res = _port_tool(benchmark.main, [
        TSN, '--shape', '2', '3', '3', '32', '32', '--iterations', '4',
        '--log-interval', '2', '--device', 'cpu', '--cfg-options', *NARROW])
    lines = out.splitlines()
    assert [ln.split(':')[0] for ln in lines] == ['iter 2', 'iter 4',
                                                  'overall']
    assert len(res['times']) == 4 and res['device'] == 'cpu'


@pytest.mark.parametrize('config', [TSN, SWIN])
def test_export_reloads_to_the_eager_scores(config, tmp_path):
    opts = NARROW if config == TSN else [
        'model.backbone.embed_dim=16', 'model.backbone.depths=[2,1]',
        'model.backbone.num_heads=[1,2]', 'model.backbone.img_size=32',
        'model.cls_head.in_channels=32']
    ckpt = ''
    if config == TSN:
        model, _ = _narrow_model(TSN)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
        ckpt = save_checkpoint(train_state(model), str(tmp_path), 1)
    path = str(tmp_path / 'model.pt2')
    out, res = _port_tool(export.main, [
        config, ckpt, '--output-file', path, '--shape', '1', '3', '3', '32',
        '32', '--verify', '--device', 'cpu', '--cfg-options', *opts])
    assert res['max_abs_err'] < 1e-4 and osp.getsize(path) == res['bytes']
    program = torch.export.load(path)
    if config == TSN:
        exported = {k: v for k, v in program.state_dict.items()}
        for k, v in model.state_dict().items():
            if 'model.' + k in exported:
                assert torch.equal(exported['model.' + k], v), k
        assert any(k.startswith('model.backbone') for k in exported)
