"""What the data-parallel tests run in each spawned rank
(``mscl_torch.parallel.dist.spawn`` pickles a function by its import path,
so these live in a module of their own). Each function runs on the CPU in a
gloo group, or with no group for the world of one, and returns plain
tensors and numbers. Nothing here imports JAX: a spawned rank starts from a
fresh interpreter, and the world of one is held against JAX elsewhere
(tests/test_torch_mscl_step_aug.py, tests/test_torch_recognizer3d.py)."""
import builtins
import os
import random
from functools import partial

import numpy as np
import torch

from mscl_torch.apis import (FLAGSHIP_AUG, MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, narrow_flagship_cfg, to_torch)
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.models.recognizers import build_ema_fn
from mscl_torch.ops import batch_norm as bn_ops
from mscl_torch.ops import decayed_infonce as di
from mscl_torch.parallel import dist

# tests/test_mscl_torch_composite.py's shapes, a global batch of 8
B, T, HW, FLOW_HW, K, DIM = 8, 8, 32, 16, 32, 32
RGB_W, FLOW_W = 8, 2
LR, MAX_NORM = 0.02, 2.0
BATCH_SEEDS = (21, 22)


def one_thread():
    torch.set_num_threads(1)


def rows(x):
    """This rank's rows of a numpy global batch (a list: of each)."""
    if isinstance(x, (list, tuple)):
        return [rows(v) for v in x]
    per = x.shape[0] // dist.world_size()
    return x[dist.rank() * per:(dist.rank() + 1) * per]


def _counting(module, name, counts):
    real = getattr(module, name)

    def wrapper(*args):
        counts[name] += 1
        return real(*args)
    setattr(module, name, wrapper)


# ----------------------------------------------------------- batch norm
def bn_case(dtype_name):
    """One train-mode BN forward and backward of a (8, 4, 2, 3, 3) global
    batch, this rank's rows: the output, dx and the input's rows gathered,
    dweight and dbias summed over the ranks, the running statistics."""
    one_thread()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (8, 4, 2, 3, 3))
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    if dtype_name == 'float32':
        bn = bn_ops.BatchNorm3d(4)
    else:
        bn = bn_ops.LowPrecisionBatchNorm(4, getattr(torch, dtype_name))
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0, -1.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.1, -0.2, 0.3]))
    bn.train()
    xr = dist.rank_rows(x).clone().requires_grad_(True)
    y = bn(xr)
    (y.float() * dist.rank_rows(g)).sum().backward()
    grads = [bn.weight.grad.clone(), bn.bias.grad.clone()]
    dist.all_reduce_(grads)
    return dict(y=dist.all_gather_rows(y.detach().float()),
                dx=dist.all_gather_rows(xr.grad.float()),
                dweight=grads[0], dbias=grads[1],
                running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone())


# ------------------------------------------------------- MSCLWithAug V5
def mscl_steps():
    """Two train steps of the narrow MSCLWithAug with SyncMoCoAugmentV5 on
    this rank's rows of two global batches of 8: the state after each,
    the logged values, the decayed-InfoNCE calls (the plain versions'
    calls on the CPU) and the collectives."""
    one_thread()
    calls = dict(l_neg_plain=0, dq_plain=0)
    for name in calls:
        _counting(di, name, calls)
    cfg = narrow_flagship_cfg(K=K, dim=DIM, rgb_width=RGB_W,
                              flow_width=FLOW_W, num_frames=T,
                              aug=dict(FLAGSHIP_AUG, crop_size=HW))
    model = build_model_from_cfg(cfg, device='cpu', seed=3)
    opt = build_optimizer(
        model, dict(type='SGD', lr=LR, momentum=0.9, weight_decay=1e-4),
        build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), LR, 400,
                          100),
        grad_clip=dict(max_norm=MAX_NORM), freeze_patterns=MOCO_FREEZE)
    step = make_train_step(model, opt, build_ema_fn(model))
    dist.reset_counts()
    states, logs, step_calls = [], [], []
    for seed in BATCH_SEEDS:
        batch = flagship_batch(B, num_frames=T, hw=HW, flow_hw=FLOW_HW,
                               seed=seed)
        before = dict(calls)
        logs.append({k: v.item() for k, v in step(to_torch(
            {k: rows(v) for k, v in batch.items()}, 'cpu')).items()})
        step_calls.append({k: calls[k] - before[k] for k in calls})
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return dict(states=states, logs=logs, calls=step_calls,
                collectives=dist.counts(), rows=B // dist.world_size())


# ---------------------------------------------- MoCo on its own, its aug
MOCO_CFG = dict(
    type='MoCo',
    backbone=dict(type='torchvision.r3d_18', layers=(1, 1, 1, 1),
                  base_width=4),
    neck=dict(type='BaseMoCo'),
    moco_head=dict(type='MoCoHead', loss_cls=dict(
        type='CrossEntropyLoss_torch', ignore_index=-1)),
    im_key='imgs', dim_in=32, dim=DIM, K=K, m=0.99, T=0.07, mlp=True,
    aux_info=[], aug=dict(type='SyncMoCoAugmentV2', crop_size=16,
                          sync_level='params', t=4, flow_suffix=None))


def moco_steps():
    """Two train steps of a narrow MoCo tower on its own with
    SyncMoCoAugmentV2 (the moco_r18 consistent-aug config's model, cut) on
    this rank's rows of two global batches of 8 clips: the state, logged
    values and gradients after each, and the aug's global draws."""
    one_thread()
    model = build_model_from_cfg(MOCO_CFG, device='cpu', seed=6)
    opt = build_optimizer(
        model, dict(type='SGD', lr=LR, momentum=0.9, weight_decay=1e-4),
        build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), LR, 400,
                          100),
        grad_clip=dict(max_norm=MAX_NORM), freeze_patterns=MOCO_FREEZE)
    step = make_train_step(model, opt, build_ema_fn(model))
    drawn, real_draw = [], model.aug.draw

    def draw(*args, **kwargs):
        drawn.append(real_draw(*args, **kwargs))
        return drawn[-1]
    model.aug.draw = draw
    rng = np.random.default_rng(10)
    states, logs, grads = [], [], []
    for _ in range(2):
        batch = {'imgs': [rng.uniform(size=(B, 3, 4, 16, 16)).astype(
            np.float32) for _ in range(2)]}
        logs.append({k: v.item() for k, v in step(to_torch(
            {k: rows(v) for k, v in batch.items()}, 'cpu')).items()})
        states.append({k: v.clone() for k, v in model.state_dict().items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    return dict(states=states, logs=logs, grads=grads, draws=drawn)


# ----------------------------------------------- Recognizer3D, weighted CE
def recognizer3d_cfg(class_weight=None):
    loss = dict(type='CrossEntropyLoss')
    if class_weight is not None:
        loss['class_weight'] = list(class_weight)
    return dict(type='Recognizer3D',
                backbone=dict(type='torchvision.r3d_18', layers=(1, 1, 1, 1),
                              base_width=4),
                cls_head=dict(type='I3DHead', num_classes=5, in_channels=32,
                              dropout_ratio=0.5, loss_cls=loss))


def recognizer3d_steps(class_weight=None):
    """Two SGD steps (the clip acting) of a narrow Recognizer3D with
    dropout 0.5 on this rank's rows of a global batch of 8 clips; labels
    put so that, under class weights, the ranks' denominators differ."""
    one_thread()
    model = build_model_from_cfg(recognizer3d_cfg(class_weight),
                                 device='cpu', seed=5)
    opt = build_optimizer(
        model, dict(type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-4),
        build_lr_schedule(dict(policy='fixed'), 0.1, 1, 1),
        grad_clip=dict(max_norm=0.5))
    step = make_train_step(model, opt)
    rng = np.random.default_rng(6)
    labels = np.array([0, 0, 0, 0, 1, 2, 3, 4])
    logs = []
    for _ in range(2):
        batch = dict(imgs=rng.normal(size=(8, 3, 4, 16, 16)).astype(
            np.float32), label=labels)
        logs.append({k: v.item() for k, v in step(to_torch(
            {k: rows(v) for k, v in batch.items()}, 'cpu')).items()})
    return dict(logs=logs,
                state={k: v.clone() for k, v in model.state_dict().items()},
                dropout=model.dropout_state())


def ce_case():
    """CrossEntropyLoss_torch with ignore_index over a global batch of 8
    whose ignored rows all lie on rank 0's side (a world of 2: rank 0 keeps
    1 row, rank 1 all 4), and a class-weighted CrossEntropyLoss: the
    losses mean-reduced as the step logs them, and the score gradients
    gathered."""
    one_thread()
    from mscl_torch.models.losses.cross_entropy_loss import (
        CrossEntropyLoss, CrossEntropyLossTorch)
    rng = np.random.default_rng(8)
    score = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    labels = torch.tensor([-1, -1, 2, -1, 0, 1, 4, 3])
    out = {}
    for name, loss_fn, lab in (
            ('ignore', CrossEntropyLossTorch(ignore_index=-1), labels),
            ('weighted', CrossEntropyLoss(class_weight=[1.0, 2.0, 0.5, 3.0,
                                                        1.5]),
             labels.clamp(min=0))):
        s = dist.rank_rows(score).clone().requires_grad_(True)
        loss = loss_fn(s, dist.rank_rows(lab))
        loss.backward()
        grad = s.grad / dist.world_size()     # its share of the mean
        val = loss.detach().clone().reshape(1)
        dist.all_reduce_([val], 'mean')
        out[name] = dict(loss=val[0], grad=dist.all_gather_rows(grad))
    return out


# --------------------------------------------------------- evaluation
class ClipSet:
    """Seven videos of one (3, 4, 16, 16) clip each, from a seed."""

    def __init__(self, n=7):
        rng = np.random.default_rng(9)
        self.clips = rng.normal(size=(n, 3, 4, 16, 16)).astype(np.float32)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return dict(imgs=self.clips[i])


def eval_case():
    """run_test and extract_features of a narrow Recognizer3D over ClipSet
    at a global batch of 4 (the last batch short: 3 videos), each rank
    decoding its rows: every rank's outputs, in dataset order."""
    one_thread()
    from mscl_torch.apis import extract_features, run_test
    from mscl_torch.datasets.loader import NumpyLoader
    model = build_model_from_cfg(recognizer3d_cfg(), device='cpu', seed=5)
    loader = NumpyLoader(ClipSet(), 4, shuffle=False,
                         world=dist.world_size(), rank=dist.rank(),
                         pad_last=True)
    return dict(scores=np.stack(run_test(model, loader)),
                feats=extract_features(model, loader))


def bundle():
    """Everything the world of 2 checks, in one group."""
    return dict(bn={d: bn_case(d) for d in ('float32', 'bfloat16')},
                mscl=mscl_steps(), moco=moco_steps(),
                r3d=recognizer3d_steps(),
                r3d_weighted=recognizer3d_steps([1, 2, 0.5, 3, 1.5]),
                ce=ce_case(), eval=eval_case())


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if dist.rank() == 1:
        raise ValueError('rank 1 fails on purpose')
    dist.barrier()


def stuck_on_rank_1():
    """Rank 1 never reaches the collective rank 0 waits in."""
    if dist.rank() == 1:
        import time
        time.sleep(600)
    dist.barrier()


# --------------------------------------------------- train_model, files
def register_tiny3d():
    """tests/test_e2e_workloads.py's ``test.tiny3d`` in the port's
    registry (that module imports JAX, which a rank does not)."""
    from mscl_torch.models import BACKBONES
    from mscl_torch.models.backbones.video_resnet import VideoResNet
    if 'test.tiny3d' not in BACKBONES:
        BACKBONES.register_module(
            name='test.tiny3d',
            module=partial(VideoResNet, conv_makers=('no_temporal',) * 4,
                           layers=(1, 1, 1, 1), stem='flow_basic',
                           base_width=8))


def train_model_rank(cfg, resume_from=None, max_epochs=None):
    """train_model on this rank with the host draws reseeded each epoch
    (from the epoch and the rank), as tests/test_torch_runner.py's
    ``epoch_seeded`` does. Returns the logged records, the files this rank
    opened for writing (torch.save included), the final state and, on a
    resume, whether the state loaded equals the file's bitwise."""
    one_thread()
    register_tiny3d()
    from mscl_torch.apis import train_model
    from mscl_torch.config import Config
    from mscl_torch.core import load_checkpoint, train_loop, train_state
    from mscl_torch.datasets import loader as t_loader
    real_set_epoch, real_open, real_save = (
        t_loader.NumpyLoader.set_epoch, builtins.open, torch.save)
    real_log, real_resume = train_loop.Runner.log, train_loop.Runner.resume
    records, writes, resumed = [], [], []

    def set_epoch(self, epoch):
        random.seed(1000 * dist.rank() + epoch)
        np.random.seed(1000 * dist.rank() + epoch)
        real_set_epoch(self, epoch)

    def tracing_open(file, mode='r', *args, **kwargs):
        if any(c in mode for c in 'wax+'):
            writes.append(os.path.basename(str(file)))
        return real_open(file, mode, *args, **kwargs)

    def tracing_save(obj, f, *args, **kwargs):
        writes.append(os.path.basename(str(f)))
        return real_save(obj, f, *args, **kwargs)

    def log(self, record):
        records.append(dict(record))
        real_log(self, record)

    def resume(self, path=None):
        real_resume(self, path)
        want = load_checkpoint(path)
        got = train_state(self.model, self.optimizer)
        resumed.append(all(torch.equal(v, got['state_dict'][k])
                           for k, v in want['state_dict'].items()) and
                       want['optimizer']['steps'] == got['optimizer']['steps']
                       and torch.equal(want['aug_rng'], got['aug_rng']))

    t_loader.NumpyLoader.set_epoch = set_epoch
    train_loop.Runner.log, train_loop.Runner.resume = log, resume
    builtins.open, torch.save = tracing_open, tracing_save
    try:
        runner, model = train_model(Config.fromdict(cfg), seed=0,
                                    device='cpu', resume_from=resume_from,
                                    max_epochs=max_epochs)
    finally:
        builtins.open, torch.save = real_open, real_save
        t_loader.NumpyLoader.set_epoch = real_set_epoch
        train_loop.Runner.log, train_loop.Runner.resume = real_log, \
            real_resume
    return dict(records=records, writes=writes, resumed=resumed,
                state={k: v.clone() for k, v in model.state_dict().items()},
                steps=runner.optimizer.steps)


def sigterm_rank(cfg):
    """train_model on this rank, rank 1 sending itself SIGTERM after its
    first step: every rank must stop after that step (exit 143)."""
    import signal
    one_thread()
    register_tiny3d()
    from mscl_torch.apis import train_model
    from mscl_torch.config import Config
    from mscl_torch.core import train_loop
    real_init = train_loop.Runner.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        step = self._train_step

        def stepped(batch):
            out = step(batch)
            if dist.rank() == 1 and not getattr(self, '_sent', False):
                self._sent = True
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        self._train_step = stepped

    train_loop.Runner.__init__ = init
    try:
        train_model(Config.fromdict(cfg), seed=0, device='cpu')
    finally:
        train_loop.Runner.__init__ = real_init
