"""The shipped recognition configs (I3D, SlowOnly, PoseC3D; the
frame-based TSN, TSM, TIN, TANet, TRN, TSM on MobileNetV2; C3D), narrowed,
through ``train_model`` in the port and in mscl_tpu on the same synthetic
files and the same initial weights (the port's, carried across through
``mscl_torch/convert.py``'s map): every logged loss within 2e-4, the
validation metrics equal, and each parameter's and BN statistic's change
over the run within 5e-3 of JAX's (relative to the largest change of that
tensor). TRN's training subsets are JAX's, recorded from its jitted step
and replayed into the port's ``TRNHead.relation_picks``; so are a TPN
neck's auxiliary dropout masks (``recorded_bernoulli``,
``replay_dropout``).

The depth-50 stacks are too ill-conditioned in float32 for that (at 32x32
crops and a batch of 2 the stem's change after two steps lies 6.8e-3 from
JAX's float32 run), so JAX runs in float64 (``x64``: x64 on, the model's
dtype float64, flax's BatchNorm, as tests/test_torch_resnet3d.py does) and
the port's float32 run is held to it; a tensor that misses 5e-3 must lie no
farther from JAX's float64 than ULP_MULT times the distance one ulp on the
input clips moves the port's float32 run, as that file holds the depth-50
stacks.
"""
import contextlib
import copy
import json
import os.path as osp
import pickle
import random
from unittest import mock

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
import numpy as np
import pytest
import torch

import mscl_tpu.apis.train as jax_train
import mscl_torch.apis.train as port_train
from mscl_tpu import Config as JaxConfig
from mscl_tpu.core.train_loop import TrainState
from mscl_tpu.models.backbones import extern_2d as jax_extern_2d
from mscl_tpu.models.backbones import mobilenet_v2 as jax_mobilenet_v2
from mscl_tpu.models.backbones import resnet2d as jax_resnet2d
from mscl_tpu.models.backbones import s3d as jax_s3d
from mscl_tpu.parallel.mesh import create_mesh
from mscl_torch.apis import build_model_from_cfg, train_model
from mscl_torch.config import Config
from mscl_torch.convert import jax_to_state_dict
from mscl_torch.core import (build_lr_schedule, build_optimizer,
                             save_checkpoint, train_loop, train_state)
from mscl_torch.datasets import build_dataset
from mscl_torch.models.backbones import extern_2d, mobilenet_v2, resnet2d, s3d
from mscl_torch.models.heads import TRNHead
from mscl_torch.models.necks import TPN

from _torch_step_util import jax_float64
from test_torch_pose_data import skeletons
from test_torch_rawframe_data import write_rawframes

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
# a JAX program a test runs once, a forward at a small size: XLA compiles it
# without LLVM's optimisation, which takes most of such a compile's time
# and changes no arithmetic (the HLO passes stay)
FAST_COMPILE = {'xla_backend_optimization_level': 0}
B = 2
GRAD_TOL = 5e-3
ULP_MULT = 8.0
ULPS = (1 - 2.0 ** -24, 1 + 2.0 ** -23)


def _seed(s=0):
    random.seed(s)
    np.random.seed(s)


def _log(work_dir):
    with open(osp.join(work_dir, 'log.json')) as f:
        return [json.loads(line) for line in f]


def rawframe_set(root, flow=False):
    """4 videos of 40 frames at 64x48 (and the flow's grey pairs)."""
    return write_rawframes(root, 4, 40, (64, 48), 'jpg', flow=flow)


def skeleton_set(root):
    """4 NTU-shaped samples at 56x56, of 100 and 40 frames."""
    ann = osp.join(root, 'ntu.pkl')
    with open(ann, 'wb') as f:
        pickle.dump(skeletons(4, (100, 40)), f)
    return ann


SIZES = {256: 40, 224: 32, 128: 40, 112: 32}


def _small(pipeline, ncthw=False):
    """The pipeline with its sizes scaled down (short edge 256 or 128 ->
    40, crops 224 or 112 -> 32), with ``ncthw`` NTHWC clips formatted
    NCTHW; tests/test_torch_rawframe_data.py holds the pipelines at their
    own sizes."""
    out = []
    for step in pipeline:
        step = dict(step)
        if ncthw and step.get('input_format') == 'NTHWC':
            step['input_format'] = 'NCTHW'
        for key in ('scale', 'input_size', 'crop_size'):
            v = step.get(key)
            if isinstance(v, int):
                step[key] = SIZES.get(v, v)
            elif isinstance(v, (tuple, list)):
                step[key] = tuple(SIZES.get(x, x) for x in v)
        out.append(step)
    return out


# the 2D tables cut while a test runs (cut_tables): ResNet's Basic and
# Bottleneck stacks and ResNeXt's with one block a stage, and MobileNetV2's
# table with
# one block a stage but the second (a shifted residual block), in both
# packages' tables (mscl_tpu's TIN and TANet read resnet2d.ARCH)
ONE_BASIC = 'basic, one block a stage'
ONE_BOTTLENECK = 'bottleneck, one block a stage'
ONE_NEXT = 'ResNeXt, one block a stage'
MBV2_ARCH = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 1, 2), (6, 64, 1, 2),
             (6, 96, 1, 1), (6, 160, 1, 2), (6, 320, 1, 1)]


# S3D's Inception table with every branch an eighth as wide (at least 4),
# in both packages while a test runs (S3D has no width option); its last
# block then gives S3D_OUT channels
S3D_TABLE = [(n, cfg if cfg is None else tuple(max(c // 8, 4) for c in cfg))
             for n, cfg in jax_s3d._INCEPTION]
S3D_OUT = 384 // 8 + 384 // 8 + 128 // 8 + 128 // 8
# S3D's module case (tests/test_torch_video_zoo.py): the cut table's first
# block of each group and its pools (the recipe holds every block)
S3D_SHORT = [S3D_TABLE[i] for i in (0, 2, 3, 8, 10)]


@contextlib.contextmanager
def short_s3d():
    with mock.patch.object(jax_s3d, '_INCEPTION', S3D_SHORT), \
            mock.patch.object(s3d, '_INCEPTION', S3D_SHORT):
        yield


@contextlib.contextmanager
def cut_tables():
    arch = {ONE_BASIC: ('basic', (1, 1, 1, 1)),
            ONE_BOTTLENECK: ('bottleneck', (1, 1, 1, 1))}
    with mock.patch.dict(jax_resnet2d.ARCH, arch), \
            mock.patch.dict(resnet2d.ARCH, arch), \
            mock.patch.dict(jax_extern_2d.ARCH_NEXT, {ONE_NEXT: (1,) * 4}), \
            mock.patch.dict(extern_2d.ARCH_NEXT, {ONE_NEXT: (1,) * 4}), \
            mock.patch.object(jax_mobilenet_v2, 'ARCH', MBV2_ARCH), \
            mock.patch.object(mobilenet_v2, 'ARCH', MBV2_ARCH), \
            mock.patch.object(jax_s3d, '_INCEPTION', S3D_TABLE), \
            mock.patch.object(s3d, '_INCEPTION', S3D_TABLE):
        yield


def narrow_model(model):
    """A recognition config's model narrowed in place, dropout 0: a 3D
    ResNet (CSN too) to base_channels 8 and one block a stage; a
    frame-based ResNet (TSN, TSM, TIN, TANet, TRN; 64 wide, the 2D ResNets
    have no width option) to Basic blocks, one a stage, and MobileNetV2 to
    widen_factor 0.5 (its last conv stays 1280 wide) and the cut table,
    under ``cut_tables``; C3D as it is. The 3D zoo: SlowFast's slow path to
    base 8 and its fast path to 2, one block a stage; R(2+1)D to base
    width 8, one block a stage; X3D to base 8 and one block a stage
    before ``gamma_d``; S3D to the cut table; TimeSformer to 32 wide, 2
    heads, 2 layers, its image size the crop's (32); the external-name 2D
    backbones: ResNeXt to one block a stage (32 groups of 4 stay),
    DenseNet to 16 initial features, growth 8, one layer a block, Swin to
    16 wide, depths (2, 1, 1, 1), its image size the crop's (32, which
    the JAX module reads from its input: ``PORT_ONLY``); a TPN neck to the
    narrowed stages' widths and 64 out (its aux dropout is the JAX
    module's fixed 0.5)."""
    bb, head = model['backbone'], model['cls_head']
    head['dropout_ratio'] = 0.0
    if bb['type'] == 'ResNet3dSlowFast':
        bb['slow_pathway'].update(base_channels=8, stage_blocks=(1,) * 4)
        bb['fast_pathway'].update(base_channels=2, stage_blocks=(1,) * 4)
        head['in_channels'] = (8 + 2) * 8 * 4
    elif bb['type'] == 'ResNet2Plus1d':
        bb.update(base_width=8, layers=(1,) * 4)
        head['in_channels'] = 64
    elif bb['type'] == 'X3D':
        bb.update(base_channels=8, stage_blocks=(1,) * 4)
        head['in_channels'] = int(64 * bb.get('gamma_b', 2.25))
    elif bb['type'] == 'S3D':
        head['in_channels'] = S3D_OUT
    elif bb['type'] == 'TimeSformer':
        bb.update(embed_dims=32, num_heads=2, num_transformer_layers=2,
                  img_size=32)
        head['in_channels'] = 32
    elif bb['type'].startswith('MobileNetV2'):
        bb['widen_factor'] = 0.5
    elif bb['type'] == 'mmcls.ResNeXt':
        bb['depth'] = ONE_NEXT
    elif bb['type'] == 'torchvision.densenet161':
        bb.update(num_init_features=16, growth_rate=8,
                  block_config=(1, 1, 1, 1))
        head['in_channels'] = 17
    elif bb['type'] == 'timm.swin_base_patch4_window7_224':
        bb.update(embed_dim=16, depths=(2, 1, 1, 1), num_heads=(1, 1, 2, 2),
                  img_size=32)
        head['in_channels'] = 128
    elif model['type'] == 'Recognizer2D':
        bb['depth'] = ONE_BASIC
        head['in_channels'] = 512
    elif bb['type'] != 'C3D':
        stages = bb.get('num_stages', 4)
        bb.update(base_channels=8, stage_blocks=(1,) * stages)
        head['in_channels'] = 8 * 2 ** (stages - 1) * 4
    neck = model.get('neck')
    if neck is not None:                # TPN on the last two stages
        top = head['in_channels']
        neck.update(in_channels=[top // 2, top], out_channels=64)
    return model


def narrow_cfg(name, root, ann, work_dir, validate, ncthw=False,
               update=None, epochs=1):
    """The config file as a dict: its model narrowed (``narrow_model``), a
    batch of 2, ``epochs`` epochs of 2 steps over ``ann`` (the flow set's
    grey x/y files) with the pipelines' sizes scaled down (with ``ncthw``
    NTHWC clips formatted NCTHW, as the port's Recognizer3D reads clips:
    C3D's recipe formats NTHWC), validation every epoch on the same list;
    then ``update`` (a function of the dict, or None) applied."""
    cfg = Config.fromfile(osp.join(ROOT, 'configs', name)).to_dict()
    narrow_model(cfg['model'])
    data = cfg['data']
    data.update(videos_per_gpu=B, workers_per_gpu=0)
    for split in ('train', 'val', 'test'):
        data[split]['ann_file'] = ann
        data[split]['pipeline'] = _small(data[split]['pipeline'], ncthw)

        if data[split]['type'] == 'RawframeDataset':
            data[split]['data_prefix'] = root
            data[split]['filename_tmpl'] = '{}_{:05d}.jpg' \
                if data[split].get('modality') == 'Flow' else 'img_{:05}.jpg'
    cfg.update(total_epochs=epochs, work_dir=work_dir,
               checkpoint_config=dict(interval=1),
               log_config=dict(interval=1))
    cfg['evaluation'] = dict(interval=1, metrics=['top_k_accuracy',
                                                  'mean_class_accuracy'])
    if not validate:
        cfg['data'].pop('val')
    if update is not None:
        update(cfg)
    return cfg


# backbone arguments the port takes and the JAX module does not (it sizes
# from its first input what the port sizes when it is built)
PORT_ONLY = {'timm.swin_base_patch4_window7_224': ('img_size',)}


def jax_cfg(cfg):
    """``narrow_cfg``'s config less what only the port's backbone takes."""
    bb = cfg['model']['backbone']
    for key in PORT_ONLY.get(bb['type'], ()):
        bb.pop(key, None)
    return cfg


def port_to_jax(shapes, state_dict, dtype):
    """JAX variables of ``shapes`` (the model's init, traced by
    ``jax.eval_shape``) holding the port's ``state_dict``:
    ``jax_to_state_dict`` only moves entries, so a tree of each entry's
    index shows where each lands."""
    leaves, treedef = jax.tree.flatten(shapes)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    index = jax.tree.unflatten(treedef, [
        np.arange(a, a + n, dtype=np.float64).reshape(leaf.shape)
        for a, n, leaf in zip(starts, sizes, leaves)])
    flat = np.full(starts[-1], np.nan)
    for key, where in jax_to_state_dict(index).items():
        flat[where.ravel().astype(np.int64)] = state_dict[key].ravel()
    assert not np.isnan(flat).any()
    return jax.tree.unflatten(treedef, [
        jnp.asarray(flat[a:a + n].reshape(leaf.shape),
                    dtype if leaf.dtype == jnp.float32 else leaf.dtype)
        for a, n, leaf in zip(starts, sizes, leaves)])


def run_both(name, root, ann, tmp, validate, x64, ncthw=False,
             port64=False, update=None, epochs=1):
    """``train_model`` of mscl_tpu (in float64 with ``x64``) and of the
    port from the port's initial weights (its model and clips in float64
    with ``port64``); returns the two logs, the port's run (a function of
    a work dir and an input scale), the initial and JAX's final variables
    as state dicts."""
    jdir, tdir, t0dir = (osp.join(tmp, n) for n in ('jax', 'port', 'p0'))
    cfg = narrow_cfg(name, root, ann, tdir, validate, ncthw, update, epochs)
    model = build_model_from_cfg(cfg['model'], device='cpu')
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    real = jax_train.init_state

    def init_state(model, tx, example, rng=None, post_init_fn=None):
        """JAX's init_state (mscl_tpu/core/train_loop.py:42-66), the
        variables traced, not compiled (compiling the init whole costs
        seconds), and set to the port's initial weights."""
        init_rng, state_rng = jax.random.split(rng)
        shapes = jax.eval_shape(lambda r, b: model.init(
            {'params': r, 'dropout': r, 'moco': r}, b,
            method='train_step'), init_rng, example)
        variables = port_to_jax(shapes, init, jnp.float64 if x64
                                else jnp.float32)
        if post_init_fn is not None:
            variables = post_init_fn(variables)
        state = TrainState(
            step=jnp.zeros((), jnp.int32), params=variables['params'],
            batch_stats=variables.get('batch_stats', {}),
            moco_state=variables.get('moco_state', {}),
            # one compilation, not one a parameter shape
            opt_state=jax.jit(tx.init)(variables['params']), rng=state_rng)
        # placed as the step returns it, so the second step reuses the
        # first one's compilation
        return jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    mesh = create_mesh(1)
    jax_train.init_state = init_state
    jcfg = jax_cfg(narrow_cfg(name, root, ann, jdir, validate, ncthw,
                              update, epochs))
    if x64:
        jcfg['model']['dtype'] = jnp.float64
    picks, masks = [], []
    try:
        with jax_float64() if x64 else contextlib.nullcontext(), \
                _recorded_choice(picks), recorded_bernoulli(masks), \
                _fast_compiled_but_the_step():
            _seed()
            _, jstate = jax_train.train_model(
                JaxConfig.fromdict(jcfg), validate=validate, seed=0,
                mesh=mesh)
    finally:
        jax_train.init_state = real
    # TRN's multi-scale head drew its subsets in each training step
    assert bool(picks) == (cfg['model']['cls_head']['type'] == 'TRNHead')
    # a TPN neck's auxiliary head drew its dropout masks
    assert bool(masks) == bool((cfg['model'].get('neck') or {}).get(
        'aux_head_cfg'))
    jax_final = {k: np.asarray(v, np.float64 if port64 else np.float32)
                 for k, v in jax_to_state_dict(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats}).items()}

    # the config's optimizer (its groups, no state yet): the runs resume
    # from these initial weights
    opt = build_optimizer(model, dict(cfg['optimizer']),
                          build_lr_schedule({}, 0.0, 1, 1))
    ckpt0 = save_checkpoint(train_state(model, opt), t0dir, 0)

    def port_run(work_dir, scale=None):
        """The port's train_model from the initial weights; with
        ``scale`` every clip multiplied by it (one ulp's perturbation)."""
        real_to = train_loop.to_torch
        real_build = port_train.build_model_from_cfg

        def to_torch(batch, device):
            out = real_to(batch, device)
            key = 'audios' if 'audios' in out else 'imgs'
            if scale is not None:
                out[key] = out[key] * scale
            if port64:
                out[key] = out[key].double()
            return out
        train_loop.to_torch = to_torch
        if port64:
            def build64(*args, **kwargs):
                model = real_build(*args, **kwargs).double()
                model.dtype = torch.float64   # Recognizer2D casts its frames
                test = model.forward_test         # validation's clips too
                model.forward_test = lambda imgs: test(imgs.double())
                return model
            port_train.build_model_from_cfg = build64
        replay = iter(picks)
        try:
            if masks:                # TPN's aux dropout, as JAX drew it
                replay_dropout(TPN, masks)
            if picks:                # TRN's subsets, as JAX drew them
                TRNHead.relation_picks = lambda self, n, k, device: \
                    torch.from_numpy(next(replay)).to(device) \
                    if self.training else real_picks(self, n, k, device)
            _seed()
            example = build_dataset(copy.deepcopy(cfg['data']['train']))
            for i in range(B):               # JAX's example_batch_from draws
                example[i]
            return train_model(Config.fromdict(dict(cfg, work_dir=work_dir)),
                               validate=validate, seed=0, device='cpu',
                               resume_from=ckpt0)[0]
        finally:
            train_loop.to_torch = real_to
            port_train.build_model_from_cfg = real_build
            TRNHead.relation_picks = real_picks
            TPN.dropout = real_dropout
    real_picks = TRNHead.relation_picks
    real_dropout = TPN.dropout
    return _log(jdir), port_run, init, jax_final


@contextlib.contextmanager
def _fast_compiled_but_the_step():
    """Every ``jax.jit`` made inside but the train step's (the validation's
    forward, the optimizer's init) compiled with FAST_COMPILE: the step
    runs a forward and a backward in float64 and runs slower so."""
    real = jax.jit

    def jit(fun, *args, **kwargs):
        if getattr(fun, '__name__', '') != 'train_step':
            kwargs.setdefault('compiler_options', FAST_COMPILE)
        return real(fun, *args, **kwargs)
    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real


@contextlib.contextmanager
def _recorded_choice(picks):
    """jax.random.choice (TRNHead's subset draws, inside the jitted step)
    also appending each draw to ``picks`` as the step runs, in order."""
    real = jax.random.choice

    def choice(*args, **kwargs):
        out = real(*args, **kwargs)
        jax.debug.callback(
            lambda v: picks.append(np.asarray(v, np.int64)), out,
            ordered=True)
        return out
    jax.random.choice = choice
    try:
        yield
    finally:
        jax.random.choice = real


@contextlib.contextmanager
def recorded_bernoulli(masks):
    """jax.random.bernoulli (flax Dropout's mask, inside a jitted step too)
    also appending each draw to ``masks`` as it runs, in order."""
    real = jax.random.bernoulli

    def bernoulli(*args, **kwargs):
        out = real(*args, **kwargs)
        jax.debug.callback(lambda v: masks.append(np.asarray(v)), out,
                           ordered=True)
        return out
    jax.random.bernoulli = bernoulli
    try:
        yield
    finally:
        jax.random.bernoulli = real


def replay_dropout(cls, masks):
    """``cls.dropout`` (a SeededDropout's) keeping, in training, what the
    next of ``masks`` (JAX's draws, in order) keeps, scaled as flax's
    Dropout scales it; the caller puts the method back."""
    replay = iter(list(masks))

    def dropout(self, x):
        if not self.training or self.dropout_ratio == 0:
            return x
        keep = torch.from_numpy(next(replay)).to(x.device)
        return torch.where(keep, x / (1 - self.dropout_ratio),
                           torch.zeros_like(x))
    cls.dropout = dropout


def _changes(runner, init):
    return {k: v.numpy() - init[k] for k, v in
            runner.model.state_dict().items()}


def check(name, root, ann, tmp, validate, x64=False, ncthw=False,
          spacing_floor=False, port64=False, update=None, epochs=1):
    """``spacing_floor`` (TSM's, TIN's and TANet's recipes alone) also
    passes a tensor whose gap from JAX's float64 change lies within two
    float32 spacings of the port's parameter: a change the float32
    parameter cannot record (TIN's offset-net biases near 0.51 and BN
    scales near 1 in TANet and TSM move by about 1e-6 in two steps, one
    spacing 6e-8-1.2e-7). ``port64`` (with ``x64``) runs the port in
    float64 too and holds every tensor to the tolerance with no ulp
    control: for a recipe whose float32 conditioning defeats that control
    (ir-CSN's, where JAX's own float32 run lies up to 49 % from its
    float64). ``update`` changes the narrowed config (an optimizer, a
    sampler, PreciseBN) in both packages; ``epochs`` epochs of 2 steps
    run. Returns the port's runner."""
    with cut_tables():
        return _check(name, root, ann, tmp, validate, x64, ncthw,
                      spacing_floor, port64, update, epochs)


def _check(name, root, ann, tmp, validate, x64, ncthw, spacing_floor,
           port64=False, update=None, epochs=1):
    jlog, port_run, init, final = run_both(name, root, ann, tmp, validate,
                                           x64, ncthw, port64, update, epochs)
    runner = port_run(osp.join(tmp, 'port'))
    tlog = _log(osp.join(tmp, 'port'))
    modes = (['train', 'train'] + (['val'] if validate else [])) * epochs
    assert [r['mode'] for r in tlog] == [r['mode'] for r in jlog] == modes
    for j, t in zip(jlog, tlog):
        assert sorted(j) == sorted(t)
        for k in j:
            if k in ('time', 'data_time'):
                continue
            if k.startswith('loss') or k == 'lr':
                assert np.isfinite(t[k])
                np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=2e-4,
                                           err_msg=f'{t["mode"]} {k}')
            else:
                assert t[k] == j[k], (t['mode'], k)
    assert runner.optimizer.steps == 2 * epochs
    got = _changes(runner, init)
    want = {k: v - init[k] for k, v in final.items()}
    scale = {k: max(np.abs(v).max(), 1e-12) for k, v in want.items()}
    errs = {k: np.abs(got[k] - v).max() / scale[k] for k, v in want.items()}
    missed = {k: e for k, e in errs.items() if e > GRAD_TOL}
    if spacing_floor:
        final = {k: v.numpy() for k, v in runner.model.state_dict().items()}
        missed = {k: e for k, e in missed.items() if np.any(
            np.abs(got[k] - want[k]) > 2 * np.spacing(
                np.abs(final[k]).astype(np.float32)))}
    if missed:
        assert not port64, missed
        # the float32 conditioning, not a fault: one ulp on the input moves
        # the port's own float32 run as far (ULP_MULT, as
        # tests/test_torch_resnet3d.py holds the depth-50 stacks)
        moved = {k: 0.0 for k in missed}
        for i, u in enumerate(ULPS):
            ctrl = _changes(port_run(osp.join(tmp, f'ulp{i}'), u), init)
            for k in missed:
                moved[k] = max(moved[k], np.abs(ctrl[k] - got[k]).max() /
                               scale[k])
        far = {k: (e, moved[k]) for k, e in missed.items()
               if e > ULP_MULT * moved[k]}
        assert not far, far
    return runner


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    """The synthetic sets, each written when a test first asks for it."""
    class Sets(dict):
        def __missing__(self, kind):
            root = str(tmp_path_factory.mktemp(kind))
            self[kind] = (root, skeleton_set(root) if kind == 'pose' else
                          rawframe_set(root, flow=kind == 'flow'))
            return self[kind]
    return Sets()

