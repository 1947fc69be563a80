"""The OmniSource parts of mscl_torch against mscl_tpu, on the CPU:
``ImageDataset`` with ``ImageDecode`` and ``BuildPseudoClip`` (the
omnisource config's image pipeline, its sizes scaled down, over JPEG and
PNG images written by cv2; single- and multi-label lists) bitwise;
``OmniSourceRunner`` as tests/test_train_loop.py's TestOmniSourceRunner
drives the JAX one (a main and an auxiliary loader, ``train_ratio`` [1, 2],
``/aux0`` log keys), the port's and JAX's (in float64) from the same
weights, every logged loss within 2e-4; and the omnisource config's list of
train sets, on which the JAX ``train_model`` fails before any step (its
``dict()`` of the list) and the port's refuses by name."""
import copy
import json
import os.path as osp
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

import mscl_tpu.apis.train as jax_train
from mscl_tpu import Config as JaxConfig
from mscl_tpu.core import OmniSourceRunner as JaxOmniSourceRunner
from mscl_tpu.core import build_lr_schedule as jax_lr
from mscl_tpu.core import build_optimizer as jax_optimizer
from mscl_tpu.core.train_loop import TrainState
from mscl_tpu.datasets import DATASETS as JAX_DATASETS
from mscl_tpu.datasets import NumpyLoader as JaxLoader
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS
from mscl_tpu.parallel.mesh import create_mesh
from mscl_torch.apis import build_model_from_cfg, train_model
from mscl_torch.config import Config
from mscl_torch.core import (OmniSourceRunner, build_lr_schedule,
                             build_optimizer)
from mscl_torch.datasets import DATASETS, NumpyLoader

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401
from _torch_recognition_util import _small, port_to_jax
from _torch_step_util import jax_float64

pytestmark = pytest.mark.usefixtures('one_torch_thread')
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
OMNI = osp.join(ROOT, 'configs/recognition/omnisource/'
                'tsn_r50_1x1x8_100e_minikinetics_rgb.py')


def _images(root, multi_class):
    rng = np.random.default_rng(0)
    lines = []
    for i, (ext, hw) in enumerate([('jpg', (48, 64)), ('png', (37, 50)),
                                   ('jpg', (60, 45)), ('png', (40, 40))]):
        img = rng.integers(0, 256, hw + (3,), np.uint8)
        img = cv2.GaussianBlur(img, (5, 5), 0)
        cv2.imwrite(osp.join(root, f'im{i}.{ext}'), img)
        labels = f'{i % 3} {(i + 2) % 5}' if multi_class else f'{i % 3}'
        lines.append(f'im{i}.{ext} {labels}\n')
    ann = osp.join(root, 'images.txt')
    with open(ann, 'w') as f:
        f.writelines(lines)
    return ann


@pytest.mark.parametrize('multi_class', [False, True])
def test_image_dataset_matches_bitwise(tmp_path, multi_class):
    cfg = Config.fromfile(OMNI).to_dict()
    ds_cfg = copy.deepcopy(cfg['data']['train'][1])
    ds_cfg.update(ann_file=_images(str(tmp_path), multi_class),
                  data_prefix=str(tmp_path),
                  pipeline=_small(ds_cfg['pipeline']))
    if multi_class:
        ds_cfg.update(multi_class=True, num_classes=5)
    datasets = [registry.get('ImageDataset')(**{
        k: v for k, v in copy.deepcopy(ds_cfg).items() if k != 'type'})
        for registry in (JAX_DATASETS, DATASETS)]
    assert [i['filename'] for i in datasets[0].video_infos] == \
        [i['filename'] for i in datasets[1].video_infos]
    for idx in range(4):
        samples = []
        for ds in datasets:
            random.seed(idx)
            np.random.seed(idx)
            samples.append(ds[idx])
        want, got = samples
        assert sorted(want) == sorted(got)
        assert got['imgs'].shape == (1, 3, 32, 32)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_build_pseudo_clip_and_image_decode(tmp_path):
    """ImageDecode reads the image as cv2 reads it (RGB); BuildPseudoClip
    repeats it clip_len times as one clip."""
    from mscl_torch.datasets.pipelines import BuildPseudoClip, ImageDecode
    _images(str(tmp_path), False)
    path = osp.join(str(tmp_path), 'im0.jpg')
    out = BuildPseudoClip(3)(ImageDecode()(dict(filename=path)))
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    assert len(out['imgs']) == 3 and out['num_clips'] == 1
    assert out['clip_len'] == 3 and out['img_shape'] == want.shape[:2]
    for img in out['imgs']:
        np.testing.assert_array_equal(img, want)
    assert out['imgs'][0] is not out['imgs'][1]


class DS:
    """TestOmniSourceRunner's dataset, each sample drawn from its index."""

    def __init__(self, n, seed):
        self.n, self.seed = n, seed
        self.video_infos = [dict(label=i % 2) for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        return dict(imgs=rng.random((1, 3, 4, 16, 16)).astype(np.float32),
                    label=np.int64(i % 2))


MODEL = dict(type='Recognizer3D', backbone=dict(type='resnet_flow.r2d_18'),
             cls_head=dict(type='I3DHead', num_classes=2, in_channels=128,
                           spatial_type='avg', dropout_ratio=0.0))
RUN_CFG = dict(total_epochs=1, log_config=dict(interval=1),
               checkpoint_config=dict(interval=1))


def _losses(work_dir):
    with open(osp.join(work_dir, 'log.json')) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k.startswith(('loss', 'top'))} for line in f]


def test_omnisource_runner_matches_jax(tmp_path, xla3d_conv):
    """JAX in float64 (x64, flax's BN): its float32 run drifts from its
    own float64 by 2.4e-3 in the sixth step's loss, six steps on two
    batches at lr 0.01, while the port's float32 stays within 1e-6."""
    model = build_model_from_cfg(MODEL, device='cpu')
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    with jax_float64():
        _jax_omnisource(tmp_path, init)
    tdir = str(tmp_path / 'port')
    lr = build_lr_schedule(dict(policy='fixed'), 0.01, 1, 1)
    opt = build_optimizer(model, dict(type='SGD', lr=0.01, momentum=0.9), lr)
    runner = OmniSourceRunner(
        model, opt, NumpyLoader(DS(16, 0), 8, shuffle=False), dict(RUN_CFG),
        tdir, lr_schedule=lr, device='cpu',
        aux_loaders=[NumpyLoader(DS(8, 1), 8, shuffle=False)],
        train_ratio=[1, 2])
    runner.run()
    # 2 main batches, each followed by 2 auxiliary steps
    assert opt.steps == 6
    want, got = _losses(str(tmp_path / 'jax')), _losses(tdir)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert ['loss/aux0' in r for r in got] == [False, True, True] * 2
    for w, g in zip(want, got):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=2e-4,
                                       err_msg=k)


def _jax_omnisource(tmp_path, init):
    """The JAX OmniSourceRunner's run from the port's weights."""
    jcfg = dict(MODEL)
    jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(dtype=jnp.float64, **jcfg)
    main, aux = JaxLoader(DS(16, 0), batch_size=8, shuffle=False), \
        JaxLoader(DS(8, 1), batch_size=8, shuffle=False)
    example = next(iter(main))
    shapes = jax.eval_shape(lambda r, b: jmodel.init(
        {'params': r, 'dropout': r}, b, method='train_step'),
        jax.random.PRNGKey(0), example)
    variables = port_to_jax(shapes, init, jnp.float64)
    tx = jax_optimizer(dict(type='SGD', lr=0.01, momentum=0.9),
                       jax_lr(dict(policy='fixed'), 0.01, 1, 1))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables['params'],
        batch_stats=variables['batch_stats'], moco_state={},
        opt_state=tx.init(variables['params']), rng=jax.random.PRNGKey(1))
    mesh = create_mesh(1)
    state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    runner = JaxOmniSourceRunner(jmodel, tx, main, cfg=dict(RUN_CFG),
                                 work_dir=str(tmp_path / 'jax'), mesh=mesh,
                                 aux_loaders=[aux], train_ratio=[1, 2])
    assert int(runner.run(state).step) == 6


def test_train_model_refuses_a_list_of_train_sets():
    """The JAX train_model's dict() of data.train fails on the
    omnisource config's list before any step; the port's names it."""
    with pytest.raises(ValueError, match='dictionary update sequence'):
        jax_train.train_model(JaxConfig.fromfile(OMNI), validate=False,
                              mesh=create_mesh(1))
    with pytest.raises(NotImplementedError, match='OmniSource'):
        train_model(Config.fromfile(OMNI), validate=False, device='cpu')
