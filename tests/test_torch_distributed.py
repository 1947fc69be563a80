"""Data parallelism in the port (``mscl_torch/parallel``) on the CPU: n gloo
ranks, spawned, against one device with no process group, on the same
global batch. The one-device path is held against JAX elsewhere
(tests/test_torch_mscl_step_aug.py, tests/test_torch_recognizer3d.py), so
the chain reaches JAX; this is the ``default`` arm of
tests/test_distributed.py's ``test_n8_equals_n1`` at n = 2 and 4.

- BN alone, float32 and bf16 ``LowPrecisionBatchNorm`` (n=2): output, dx,
  dweight, dbias, running statistics;
- two ``MSCLWithAug`` steps with SyncMoCoAugmentV5 (tests/
  test_mscl_torch_composite.py's shapes, a global batch of 8, the clip
  acting), n=2 and 4: every logged value, the queues (``count``,
  ``queue_ptr``, ``iters`` exact), the EMA towers, the BN statistics, the
  parameters after SGD, 7 + 7 decayed-InfoNCE calls a step on each rank,
  and every rank's state the same;
- two steps of a ``MoCo`` tower on its own with SyncMoCoAugmentV2 (its
  own aug, n=2): the aug's global draws, every logged value, the queue of
  keys gathered in rank order (``count``, ``queue_ptr``, ``iters``
  advanced by the global batch, exact), the gradients and the state;
- ``Recognizer3D`` with dropout 0.5, and with class weights whose
  denominators differ over the ranks; cross-entropy with ignored rows on
  one rank only;
- the loader: the ranks' rows make one device's global batches, in thread
  and process mode, the workers' seeds distinct; a short batch the ranks
  do not divide is refused unless padded;
- ``run_test`` and ``extract_features`` in dataset order with a short last
  batch;
- a two-rank ``train_model``: one logged loss on both ranks, files from
  rank 0 only, exact resume, SIGTERM stopping both ranks;
- with no process group, the step and the BN are bitwise the code they
  were before the group existed (frozen copies below).

Tolerances (tests/test_mscl_torch_composite.py:387,451): losses 2e-4,
parameters after SGD 5e-3 / 1e-4, queues 2e-5, EMA 1e-5, BN statistics
1e-4. Each group of ranks is spawned once a module, with one torch thread
a rank and a join timeout.
"""
import json
import math
import os.path as osp

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_dist_util as du
from mscl_torch.apis import MOCO_FREEZE
from mscl_torch.core import optimizer as t_optimizer
from mscl_torch.core import train_loop
from mscl_torch.datasets.loader import NumpyLoader
from mscl_torch.models.common import ssl_aug
from mscl_torch.models.heads import i3d_head
from mscl_torch.models.losses import cross_entropy_loss
from mscl_torch.models.recognizers import moco
from mscl_torch.ops import batch_norm as bn_ops
from mscl_torch.parallel import dist

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_data_util import tiny_pretrain_cfg, write_videos

JOIN_S = 300
TOWERS = ('recognizer', 'recognizer_flow')
pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def one():
    return du.bundle()


@pytest.fixture(scope='module')
def two():
    return dist.spawn(du.bundle, 2, device='cpu', join_timeout_s=JOIN_S)


@pytest.fixture(scope='module')
def four():
    return dist.spawn(du.mscl_steps, 4, device='cpu', join_timeout_s=JOIN_S)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------- BN
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bn_matches_one_device(one, two, dtype):
    want = one['bn'][dtype]
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == 'float32' else \
        dict(rtol=1e-2, atol=2e-2)      # the normalize in bf16
    for r, res in enumerate(two):
        got = res['bn'][dtype]
        for k in ('y', 'dx', 'dweight', 'dbias'):
            _close(got[k].float(), want[k].float(), what=f'{k} rank {r}',
                   **tol)
        for k in ('running_mean', 'running_var'):
            _close(got[k], want[k], 1e-4, 1e-5, f'{k} rank {r}')


# ------------------------------------------------------- MSCLWithAug V5
def _mscl_runs(world, two, four):
    return [r['mscl'] for r in two] if world == 2 else four


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('step', [0, 1])
def test_mscl_logged_values_match(one, two, four, world, step):
    want = one['mscl']['logs'][step]
    for r, res in enumerate(_mscl_runs(world, two, four)):
        got = res['logs'][step]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            _close(got[k], v, 2e-4, 2e-4, f'{k} step {step} rank {r}')


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('step', [0, 1])
def test_mscl_queue_state_matches(one, two, four, world, step):
    want = one['mscl']['states'][step]
    for r, res in enumerate(_mscl_runs(world, two, four)):
        got = res['states'][step]
        for tower in TOWERS:
            _close(got[f'{tower}.queue'], want[f'{tower}.queue'], 0, 2e-5,
                   f'{tower}.queue rank {r}')
            for name in ('count', 'queue_ptr', 'iters'):
                assert torch.equal(got[f'{tower}.{name}'],
                                   want[f'{tower}.{name}']), (tower, name, r)


def _compare_final(one, runs, select, rtol, atol):
    want = one['mscl']['states'][1]
    keys = [k for k in want if select(k)]
    assert keys
    for r, res in enumerate(runs):
        for k in keys:
            _close(res['states'][1][k], want[k], rtol, atol, f'{k} rank {r}')


@pytest.mark.parametrize('world', [2, 4])
def test_mscl_ema_key_towers_match(one, two, four, world):
    _compare_final(one, _mscl_runs(world, two, four),
                   lambda k: any(f'.{p}.' in k for p in MOCO_FREEZE)
                   and 'running' not in k, 1e-5, 1e-6)


@pytest.mark.parametrize('world', [2, 4])
def test_mscl_bn_statistics_match(one, two, four, world):
    _compare_final(one, _mscl_runs(world, two, four),
                   lambda k: 'running' in k, 1e-4, 1e-5)


@pytest.mark.parametrize('world', [2, 4])
def test_mscl_sgd_updated_params_match(one, two, four, world):
    _compare_final(one, _mscl_runs(world, two, four),
                   lambda k: '_q.' in k and 'running' not in k, 5e-3, 1e-4)


@pytest.mark.parametrize('world', [2, 4])
def test_mscl_ranks_hold_one_state(two, four, world):
    runs = _mscl_runs(world, two, four)
    for res in runs[1:]:
        for step in (0, 1):
            assert res['logs'][step] == runs[0]['logs'][step]
            for k, v in runs[0]['states'][step].items():
                assert torch.equal(res['states'][step][k], v), k


@pytest.mark.parametrize('world', [2, 4])
def test_mscl_calls_and_collectives_per_rank(one, two, four, world):
    """7 l_neg and 7 dq products a step on every rank, on its rows; the
    collectives: a BN all-reduce a train-mode BN call, one backward one
    for each query-side BN, the keys gathered once a tower a step (the
    rotated flow pass does not enqueue), a denominator a cross-entropy,
    the gradients in one bucket and the logged values once a step."""
    assert one['mscl']['collectives'] == {}
    for res in _mscl_runs(world, two, four):
        assert res['calls'] == [dict(l_neg_plain=7, dq_plain=7)] * 2
        assert res['rows'] == du.B // world
        c = res['collectives']
        assert c['moco_keys']['calls'] == 2 * 2
        assert c['moco_keys']['bytes'] == 2 * 2 * (du.B // world) * du.DIM * 4
        assert c['loss_denominator']['calls'] == 2 * 8
        assert c['log_vars']['calls'] == 2
        assert c['grad_bucket']['calls'] == 2
        assert c['bn_backward']['calls'] * 2 == c['bn_forward']['calls']


# ------------------------------------------------- MoCo on its own, aug
def _leaves(tree, path=''):
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{path}.{k}')
    elif tree is not None:
        yield path, tree


def test_moco_aug_draws_are_global(one, two):
    """Each rank draws the global batch's params from the same generator,
    so every rank's draws are world 1's, bitwise."""
    want = dict(_leaves(one['moco']['draws']))
    assert want and len(one['moco']['draws']) == 2
    for r, res in enumerate(two):
        got = dict(_leaves(res['moco']['draws']))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (k, r)


@pytest.mark.parametrize('step', [0, 1])
def test_moco_steps_match(one, two, step):
    """Logged values, the queue (every rank's keys in rank order), its
    counters exact, the gradients and the parameters after SGD."""
    want = one['moco']
    for r, res in enumerate(two):
        got = res['moco']
        for k, v in want['logs'][step].items():
            _close(got['logs'][step][k], v, 2e-4, 2e-4,
                   f'{k} step {step} rank {r}')
        ws, gs = want['states'][step], got['states'][step]
        _close(gs['queue'], ws['queue'], 0, 2e-5, f'queue rank {r}')
        for name in ('count', 'queue_ptr', 'iters'):
            assert torch.equal(gs[name], ws[name]), (name, r)
        assert int(gs['iters']) == int(gs['queue_ptr']) == du.B * (step + 1)
        assert sorted(got['grads'][step]) == sorted(want['grads'][step])
        for k, v in want['grads'][step].items():
            _close(got['grads'][step][k], v, 5e-3, 1e-4, f'{k} grad rank {r}')
        for k, v in ws.items():
            tol = (1e-4, 1e-4) if 'running' in k else (5e-3, 1e-4)
            _close(gs[k], v, *tol, f'{k} rank {r}')


# ----------------------------------------------- Recognizer3D, weighted CE
@pytest.mark.parametrize('case', ['r3d', 'r3d_weighted'])
def test_recognizer3d_with_dropout_matches(one, two, case):
    want = one[case]
    for r, res in enumerate(two):
        got = res[case]
        for step in (0, 1):
            for k, v in want['logs'][step].items():
                _close(got['logs'][step][k], v, 2e-4, 2e-4,
                       f'{k} step {step} rank {r}')
        for k, v in want['state'].items():
            if 'running' in k:
                _close(got['state'][k], v, 1e-4, 1e-5, f'{k} rank {r}')
            else:
                _close(got['state'][k], v, 5e-3, 1e-4, f'{k} rank {r}')
        assert torch.equal(got['dropout'], want['dropout'])


@pytest.mark.parametrize('case', ['ignore', 'weighted'])
def test_cross_entropy_takes_the_global_denominator(one, two, case):
    """Rank 0 keeps 1 of its 4 rows, rank 1 all 4 (ignore), or their class
    weights sum to 5.5 and 7 (weighted): the mean of the ranks' losses and
    of their gradients is the global batch's."""
    want = one['ce'][case]
    for r, res in enumerate(two):
        got = res['ce'][case]
        _close(got['loss'], want['loss'], 1e-6, 1e-6, f'loss rank {r}')
        _close(got['grad'], want['grad'], 1e-6, 1e-7, f'grad rank {r}')


def test_eval_returns_rows_in_dataset_order(one, two):
    for res in two:
        for k in ('scores', 'feats'):
            assert res['eval'][k].shape == one['eval'][k].shape == (
                (7, 5) if k == 'scores' else (7, 32))
            _close(res['eval'][k], one['eval'][k], 1e-5, 1e-6, k)


# -------------------------------------------------------------- loader
class _IndexSet:
    """Each sample its index and the first key word of the numpy global
    generator's state where it was made (a worker's seed)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return dict(idx=np.array([i]), seed=np.random.get_state()[1][0])


def _epochs(loader, epochs=2):
    out = []
    try:
        for e in range(epochs):
            loader.set_epoch(e)
            out.append([b for b in loader])
    finally:
        loader.shutdown()
    return out


@pytest.mark.parametrize('mode', ['thread', 'process'])
@pytest.mark.parametrize('world', [2, 4])
def test_loader_rows_make_one_devices_batches(mode, world):
    kw = dict(shuffle=True, seed=3, drop_last=True, num_workers=2,
              workers_mode=mode)
    want = _epochs(NumpyLoader(_IndexSet(22), 8, **kw))
    ranks = [_epochs(NumpyLoader(_IndexSet(22), 8, world=world, rank=r,
                                 **kw)) for r in range(world)]
    for e in range(2):
        assert len(want[e]) == 2
        for b, batch in enumerate(want[e]):
            got = np.concatenate([ranks[r][e][b]['idx']
                                  for r in range(world)])
            assert np.array_equal(got, batch['idx']), (e, b)
    assert len(NumpyLoader(_IndexSet(22), 8, world=world, rank=1,
                           drop_last=True)) == 2
    if mode == 'process':
        # rank r's two workers take seeds 3 + 2r and 3 + 2r + 1
        for r in range(world):
            seeds = {int(s) for e in ranks[r] for b in e for s in b['seed']}
            assert seeds and seeds <= {3 + 2 * r, 3 + 2 * r + 1}, (r, seeds)


def test_loader_short_batch_is_refused_or_padded():
    kw = dict(shuffle=False, drop_last=False, world=2)
    with pytest.raises(ValueError, match='divide'):
        list(NumpyLoader(_IndexSet(13), 8, rank=0, **kw))
    rows = [list(NumpyLoader(_IndexSet(13), 8, rank=r, pad_last=True,
                             **kw)) for r in (0, 1)]
    last = np.concatenate([rows[r][-1]['idx'] for r in (0, 1)])
    assert last.tolist() == [8, 9, 10, 11, 12, 8, 9, 10]
    with pytest.raises(ValueError, match='divide'):
        NumpyLoader(_IndexSet(13), 7, world=2)


# --------------------------------------------------------- train_model
@pytest.fixture(scope='module')
def train_runs(tmp_path_factory):
    du.register_tiny3d()
    root = str(tmp_path_factory.mktemp('dist_videos'))
    pkl = write_videos(root, 8, 24, (32, 32), (16, 16))
    work = str(tmp_path_factory.mktemp('dist_work'))
    cfg = tiny_pretrain_cfg(pkl, work, videos_per_gpu=2, val_pkl=pkl)
    straight = dist.spawn(du.train_model_rank, 2, (cfg,), device='cpu',
                          join_timeout_s=JOIN_S)
    resumed = dist.spawn(du.train_model_rank, 2,
                         (cfg, osp.join(work, 'epoch_1.pth')),
                         device='cpu', join_timeout_s=JOIN_S)
    return dict(cfg=cfg, work=work, straight=straight, resumed=resumed)


def test_train_model_two_ranks_log_one_loss(train_runs):
    r0, r1 = train_runs['straight']
    train = [[r for r in res['records'] if r['mode'] == 'train']
             for res in (r0, r1)]
    assert len(train[0]) == 2 * 2          # 8 videos, a global batch of 4
    assert [r['loss'] for r in train[0]] == [r['loss'] for r in train[1]]
    assert all(math.isfinite(r['loss']) for r in train[0])
    assert [r['mode'] for r in r0['records']].count('val') == 2
    assert r0['steps'] == r1['steps'] == 4
    for k, v in r0['state'].items():
        assert torch.equal(v, r1['state'][k]), k
    assert r0['state']['recognizer.queue_ptr'].item() == (4 * 4) % 16
    assert r0['state']['recognizer.iters'].item() == 4 * 4


def test_train_model_files_come_from_rank_0(train_runs):
    r0, r1 = train_runs['straight']
    assert r1['writes'] == [] and r1['records']
    assert {'epoch_1.pth', 'epoch_2.pth', 'latest', 'log.json'} <= \
        set(r0['writes'])
    with open(osp.join(train_runs['work'], 'log.json')) as f:
        lines = f.read().splitlines()
    # the resumed run appended one train epoch's lines and a val line
    assert len(lines) == len(r0['records']) + 2 + 1


def test_train_model_two_ranks_resume_exactly(train_runs):
    for straight, resumed in zip(train_runs['straight'],
                                 train_runs['resumed']):
        assert resumed['resumed'] == [True]
        assert resumed['steps'] == straight['steps']
        for k, v in straight['state'].items():
            assert torch.equal(v, resumed['state'][k]), k
    assert train_runs['resumed'][1]['writes'] == []


def test_sigterm_stops_every_rank(train_runs, tmp_path):
    cfg = dict(train_runs['cfg'], work_dir=str(tmp_path))
    with pytest.raises(SystemExit) as e:
        dist.spawn(du.sigterm_rank, 2, (cfg,), device='cpu',
                   join_timeout_s=JOIN_S)
    assert e.value.code == 143
    assert osp.exists(tmp_path / 'preempt_epoch_0.pth')
    with open(tmp_path / 'latest') as f:
        assert f.read() == 'preempt_epoch_0.pth'
    with open(tmp_path / 'log.json') as f:   # rank 0's lines only
        modes = [json.loads(line)['mode'] for line in f]
    assert modes == ['train', 'preempt']


def test_spawn_fails_with_a_failing_rank():
    with pytest.raises(RuntimeError, match='rank 1 failed'):
        dist.spawn(du.fail_on_rank_1, 2, device='cpu', join_timeout_s=60)


def test_spawn_stops_ranks_past_the_join_timeout():
    with pytest.raises(TimeoutError, match='still running'):
        dist.spawn(du.stuck_on_rank_1, 2, device='cpu', join_timeout_s=10)


# ------------------------------------------------ the path with no group
class _FrozenBNTrainApply(torch.autograd.Function):
    """``_BNTrainApply`` as it was before process groups."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean32, var32, eps):
        dt = x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        m = mean32.to(dt).reshape(shape)
        rstd = torch.rsqrt(var32 + eps).to(dt).reshape(shape)
        ctx.save_for_backward(x, scale, m, rstd)
        return (x - m) * rstd * scale.to(dt).reshape(shape) + \
            bias.to(dt).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale, m, rstd = ctx.saved_tensors
        dt = x.dtype
        axes = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        xhat = (x - m) * rstd
        s1 = dy.float().sum(axes)
        s2 = (dy.float() * xhat.float()).sum(axes)
        k = scale.to(dt).reshape(shape) * rstd
        dx = k * (dy - (s1 / n).to(dt).reshape(shape) -
                  xhat * (s2 / n).to(dt).reshape(shape))
        return dx, s2, s1, None, None, None


def _frozen_bn_forward(self, x):
    if not self.training:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)
    mean = self.running_mean.clone()
    var = self.running_var.clone()
    y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                     self.momentum, self.eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        kept = (1.0 - self.momentum) * self.running_var
        self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
        self.running_mean.copy_(mean)
    return y


def _frozen_lp_bn_forward(self, x):
    x = x.to(torch.promote_types(x.dtype, self.compute_dtype))
    dt = x.dtype
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if not self.training:
        a32 = self.weight * torch.rsqrt(self.running_var + self.eps)
        b32 = self.bias - self.running_mean * a32
        return (x * a32.to(dt).reshape(shape) +
                b32.to(dt).reshape(shape)).to(self.compute_dtype)
    with torch.no_grad():
        mean32, var32 = bn_ops._batch_stats(x)
    y = _FrozenBNTrainApply.apply(x, self.weight, self.bias, mean32, var32,
                                  self.eps)
    with torch.no_grad():
        keep = 1.0 - self.momentum
        self.running_mean.mul_(keep).add_(self.momentum * mean32)
        self.running_var.mul_(keep).add_(self.momentum * var32)
    return y.to(self.compute_dtype)


def _frozen_draw_apply(self, gen, im_q, im_k=None, aux_info=None):
    return self.apply(im_q, im_k, aux_info,
                      self.draw(gen, im_q, im_k, aux_info))


@torch.no_grad()
def _frozen_enqueue(self, k):
    b = k.shape[0]
    if self.K % b:
        raise ValueError(f'K={self.K} % global batch={b} != 0')
    cols = self.queue_ptr + torch.arange(b, device=k.device)
    self.queue = self.queue.index_copy(1, cols, k.T.to(self.queue.dtype))
    idx = torch.arange(self.K, device=k.device)
    in_window = (idx >= self.queue_ptr) & (idx < self.queue_ptr + b)
    self.count = torch.where(in_window, 1, self.count + 1)
    self.queue_ptr = (self.queue_ptr + b) % self.K


def _frozen_forward_train(self, im_q, im_k, update_queue=True):
    q, q_mlvl, k = self.extract_feat(im_q, im_k)
    l_pos = (q * k).sum(dim=1, keepdim=True)
    decay = moco.decay_weights(self.count, self.t_decay)
    bank = (self.queue, decay)
    l_neg = moco.decayed_neg(q.float(), *bank)
    logits = torch.cat([l_pos.float(), l_neg], dim=1) / self.T
    labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    if update_queue:
        self._enqueue(k)
    if self.training:
        self.iters = self.iters + k.shape[0]
    losses = self.moco_head.loss(logits, labels)
    return losses, dict(q=q, q_mlvl=q_mlvl, k=k, q_neg=l_neg, bank=bank)


def _frozen_cross_entropy(cls_score, label, ignore_index=-100,
                          class_weight=None):
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    nll = F.cross_entropy(cls_score, safe, reduction='none')
    if class_weight is not None:
        w = class_weight.to(nll)[safe] * valid
        return (nll * w).sum() / w.sum().clamp(min=1e-12)
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def _frozen_dropout(self, x):
    p = self.dropout_ratio
    if not self.training or p == 0:
        return x
    u = torch.rand(x.shape, generator=self.dropout_generator(x.device),
                   device=x.device, dtype=torch.float32)
    return torch.where(u >= p, x / (1 - p), torch.zeros_like(x))


def _frozen_sgd_step(self):
    self.clip_grads()
    for group in self.opt.param_groups:
        group['lr'] = self.lr_schedule(self.steps)
    self.opt.step()
    self.steps += 1


def _frozen_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bn_ops.BatchNorm3d, 'forward', _frozen_bn_forward)
        mp.setattr(bn_ops.LowPrecisionBatchNorm, 'forward',
                   _frozen_lp_bn_forward)
        mp.setattr(ssl_aug._DrawApply, '__call__', _frozen_draw_apply)
        mp.setattr(moco.MoCoV2, '_enqueue', _frozen_enqueue)
        mp.setattr(moco.MoCoV2, 'forward_train', _frozen_forward_train)
        mp.setattr(cross_entropy_loss, 'cross_entropy', _frozen_cross_entropy)
        mp.setattr(i3d_head.I3DHead, 'dropout', _frozen_dropout)
        mp.setattr(t_optimizer.SGD, 'step', _frozen_sgd_step)
        mp.setattr(train_loop, '_mean_over_ranks', lambda log_vars: log_vars)
        return dict(bn={d: du.bn_case(d) for d in ('float32', 'bfloat16')},
                    mscl=du.mscl_steps(),
                    r3d=du.recognizer3d_steps([1, 2, 0.5, 3, 1.5]))


@pytest.fixture(scope='module')
def frozen():
    return _frozen_runs()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_no_group_bn_is_bitwise_unchanged(one, frozen, dtype):
    assert not dist.is_distributed()
    for k, v in frozen['bn'][dtype].items():
        assert torch.equal(one['bn'][dtype][k], v), k


def test_no_group_steps_are_bitwise_unchanged(one, frozen):
    for step in (0, 1):
        assert one['mscl']['logs'][step] == frozen['mscl']['logs'][step]
        for k, v in frozen['mscl']['states'][step].items():
            assert torch.equal(one['mscl']['states'][step][k], v), k
    assert one['r3d_weighted']['logs'] == frozen['r3d']['logs']
    for k, v in frozen['r3d']['state'].items():
        assert torch.equal(one['r3d_weighted']['state'][k], v), k
