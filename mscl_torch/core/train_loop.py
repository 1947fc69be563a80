"""The train step and the epoch runner (port of
``mscl_tpu/core/train_loop.py`` ``make_train_step`` and ``Runner``).

The step mutates the model and the optimizer in place: the EMA pre-update
of the key towers, then the forward (which advances BN statistics and the
MoCo queues), backward and the optimizer update. With update=False it
computes the same losses and leaves every parameter and buffer, and the
device aug's and dropout's generators, as it was, as the JAX step's caller
discards its new state (validation by loss). Validation by metrics runs an
``eval_fn`` (``apis.inference.make_eval_fn``) and the val dataset's
``evaluate``.

In a process group (``parallel/dist.py``) each rank steps on its rows of the
global batch and the logged values are mean-all-reduced, so every rank logs
the global batch's. Rank 0 alone writes ``log.json`` and the checkpoints
(the others wait for each write); every rank prints its log lines with its
``rank``; validation by metrics is evaluated on rank 0 and its metrics sent
to every rank, so all decide ``save_best`` alike; a SIGTERM seen by any
rank stops every rank after the same step, rank 0 writing the ``preempt_``
checkpoint.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import signal
import sys
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..parallel import dist
from ..utils.device import resolve_device
from .checkpoint import (latest_checkpoint, load_checkpoint, load_meta,
                         restore_train_state, save_checkpoint, train_state)
from .precise_bn import precise_bn_update


def make_train_step(model: nn.Module, optimizer=None,
                    pre_update_fn: Optional[Callable[[], None]] = None,
                    update: bool = True
                    ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Build ``step(batch) -> log_vars`` (detached tensors on the model's
    device; reading them is left to the caller, so a step does not wait on
    the card)."""

    def train_step(batch) -> Dict[str, torch.Tensor]:
        model.train()
        if update:
            if pre_update_fn is not None:
                pre_update_fn()
            loss, log_vars = model.train_step(batch)
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
        else:
            saved = {k: v.clone() for k, v in model.state_dict().items()}
            rngs = [(getattr(model, f'set_{name}_state'),
                     getattr(model, f'{name}_state')())
                    for name in ('aug', 'dropout')
                    if hasattr(model, f'{name}_state')]
            with torch.no_grad():
                if pre_update_fn is not None:
                    pre_update_fn()
                loss, log_vars = model.train_step(batch)
            model.load_state_dict(saved)
            for put_back, state in rngs:
                put_back(state)
        return _mean_over_ranks({k: v.detach() for k, v in log_vars.items()})

    return train_step


def _mean_over_ranks(log_vars: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The ranks' mean of each logged value (float32), one collective; the
    values as they are with no process group."""
    if not dist.is_distributed():
        return log_vars
    vals = torch.stack([v.float() for v in log_vars.values()])
    dist.all_reduce_([vals], 'mean', tag='log_vars')
    return dict(zip(log_vars, vals.unbind()))


def to_torch(batch: Dict, device) -> Dict:
    """numpy batch (dict of arrays or lists of arrays) -> tensors on
    ``device``, one copy a step."""
    def conv(x):
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return {k: conv(v) for k, v in batch.items()}


class Runner:
    """Epoch-based training loop (the JAX package's Runner, itself the
    reference's EpochBasedRunner with its logger, checkpoint and evaluation
    hooks): train epochs, ``precise_bn`` every ``precise_bn.interval``
    epochs, a checkpoint every ``checkpoint_config.interval``
    epochs, validation every ``evaluation.interval`` (by loss with
    ``evaluation.simple``, else by ``evaluation.metrics`` over
    ``eval_fn``'s scores), a JSON log (``log.json``), resume, and on
    SIGTERM a ``preempt_`` checkpoint after the step in flight, then exit
    143. The step's values are read from the device only at
    ``log_config.interval``. ``device`` None means the card, and raises
    without one; the CPU runs only when it is named."""

    def __init__(self, model, optimizer, train_loader, cfg, work_dir,
                 val_loader=None, pre_update_fn=None, lr_schedule=None,
                 device=None, val_dataset=None, eval_fn=None):
        self.model = model
        self.optimizer = optimizer
        self.train_loader = train_loader
        self.cfg = cfg
        self.work_dir = work_dir
        self.val_loader = val_loader
        self.val_dataset = val_dataset
        self.eval_fn = eval_fn
        self.lr_schedule = lr_schedule
        self.device = resolve_device(device)

        self.total_epochs = cfg.get('total_epochs', 1)
        self.log_interval = cfg.get('log_config', {}).get('interval', 20)
        self.ckpt_interval = cfg.get('checkpoint_config', {}).get(
            'interval', 1)
        eval_cfg = cfg.get('evaluation', {}) or {}
        self.eval_interval = eval_cfg.get('interval', 0)
        self.eval_simple = eval_cfg.get('simple', False)
        self.eval_metrics = eval_cfg.get('metrics', ['top_k_accuracy'])
        # save_best (reference core/evaluation/eval_hooks.py:51-416): keep
        # a best_* checkpoint of a key metric; the rule from the key
        self.save_best = eval_cfg.get('save_best')
        rule = eval_cfg.get('rule')
        if rule is None and self.save_best:
            rule = 'less' if 'loss' in self.save_best else 'greater'
        self.best_rule = rule
        self.best_score = None
        self.best_ckpt_path = None
        # PreciseBNHook (reference apis/train.py:127-139; the slowfast_prebn
        # configs' precise_bn=dict(num_iters=200, interval=1)): the BN
        # statistics refreshed from train data every ``interval`` epochs,
        # before the checkpoint (core/precise_bn.py)
        self.precise_bn = dict(cfg.get('precise_bn') or {}) or None

        self._train_step = make_train_step(model, optimizer, pre_update_fn)
        self._val_step = make_train_step(model, None, pre_update_fn,
                                         update=False)
        os.makedirs(work_dir, exist_ok=True)
        self.log_file = osp.join(work_dir, 'log.json')
        self.epoch = 0
        self._preempt_signum = None

    def _note_preempt(self, signum, frame):
        self._preempt_signum = signum

    def state(self) -> Dict:
        return train_state(self.model, self.optimizer)

    def log(self, record: Dict):
        record = {k: (float(v) if hasattr(v, 'dtype') or
                      isinstance(v, (int, float, np.generic)) else v)
                  for k, v in record.items()}
        line = json.dumps(record)
        # the line and its newline in one write: ranks share the stream
        sys.stdout.write(json.dumps(dict(record, rank=dist.rank())) + '\n'
                         if dist.is_distributed() else line + '\n')
        sys.stdout.flush()
        if dist.is_main():
            with open(self.log_file, 'a') as f:
                f.write(line + '\n')

    def _save(self, epoch: int, **kwargs) -> str:
        """A checkpoint of the state, written by rank 0 only."""
        return save_checkpoint(self.state() if dist.is_main() else None,
                               self.work_dir, epoch, **kwargs)

    def resume(self, path: Optional[str] = None) -> None:
        dist.barrier()              # rank 0's last write is on disk
        path = path or latest_checkpoint(self.work_dir)
        if path is None:
            return
        restore_train_state(self.model, self.optimizer,
                            load_checkpoint(path))
        self.epoch = load_meta(path).get('epoch', 0)
        print(f'resumed from {path} at epoch {self.epoch}', flush=True)

    def run(self) -> None:
        """Train to ``total_epochs``. SIGTERM is caught (on the main thread
        only, unless ``preempt_checkpoint=False``) while this runs."""
        previous = None
        if self.cfg.get('preempt_checkpoint', True) and \
                threading.current_thread() is threading.main_thread():
            previous = signal.signal(signal.SIGTERM, self._note_preempt)
        try:
            while self.epoch < self.total_epochs:
                self.train_epoch()
                self.epoch += 1
                if self.precise_bn and self.epoch % self.precise_bn.get(
                        'interval', 1) == 0:
                    precise_bn_update(
                        self.model, self.train_loader,
                        lambda b: to_torch(b, self.device),
                        num_iters=self.precise_bn.get('num_iters', 200))
                if self.ckpt_interval and \
                        self.epoch % self.ckpt_interval == 0:
                    self._save(self.epoch)
                if self.eval_interval and \
                        self.epoch % self.eval_interval == 0:
                    self.validate()
            # final checkpoint if not on an interval boundary
            if not self.ckpt_interval or self.epoch % self.ckpt_interval:
                self._save(self.epoch)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def train_epoch(self) -> None:
        self.train_loader.set_epoch(self.epoch)
        n_batches = len(self.train_loader)
        if n_batches == 0:
            print(f'WARNING: epoch {self.epoch + 1} has 0 batches — '
                  f'dataset ({len(self.train_loader.dataset)} samples) '
                  f'is smaller than the global batch '
                  f'({self.train_loader.batch_size}) with drop_last',
                  flush=True)
        t_end = time.time()
        it = iter(self.train_loader)
        try:
            for i, batch in enumerate(it):
                data_time = time.time() - t_end
                log_vars = self._train_step(to_torch(batch, self.device))
                if (i + 1) % self.log_interval == 0 or i + 1 == n_batches:
                    log_vars = {k: v.item() for k, v in log_vars.items()}
                    step = self.optimizer.steps
                    lr = float(self.lr_schedule(step)) if self.lr_schedule \
                        else None
                    self.log(dict(mode='train', epoch=self.epoch + 1,
                                  iter=i + 1, total_iters=n_batches, lr=lr,
                                  time=time.time() - t_end,
                                  data_time=data_time, **log_vars))
                self.after_step(i)
                signum = self._preempt_signum
                if dist.is_distributed():   # every rank stops together
                    signum = dist.all_reduce_max(signum or 0,
                                                 tag='preempt') or None
                if signum is not None:
                    # meta epoch = completed epochs, so resume re-runs the
                    # interrupted epoch; steps, queues and EMA are exact
                    path = self._save(self.epoch,
                                      meta=dict(preempted=True, iter=i + 1),
                                      prefix='preempt_')
                    if dist.is_main():
                        with open(osp.join(self.work_dir, 'latest'),
                                  'w') as f:
                            f.write(osp.basename(path))
                    self.log(dict(mode='preempt', epoch=self.epoch + 1,
                                  iter=i + 1, checkpoint=path))
                    dist.barrier()      # no rank exits before rank 0's files
                    raise SystemExit(128 + int(signum))
                t_end = time.time()
        finally:
            it.close()  # stop the prefetch producer on an early exit

    def after_step(self, i: int) -> None:
        """Runs after the epoch's step i (0-based) and its log line."""

    def validate(self) -> None:
        """Validation by loss (``evaluation.simple``: the mean of each loss
        of the train step over the val data, nothing updated) or by metrics
        (``eval_fn``'s scores for each video, then the val dataset's
        ``evaluate``); then ``save_best``."""
        if self.val_loader is None:
            return
        metrics = None
        if self.eval_simple:
            meters: Dict[str, list] = {}
            it = iter(self.val_loader)
            try:
                for batch in it:
                    log_vars = self._val_step(to_torch(batch, self.device))
                    for k, v in log_vars.items():
                        meters.setdefault(k, []).append(v.item())
            finally:
                it.close()
            metrics = {k: float(np.mean(v)) for k, v in meters.items()}
            self.log(dict(mode='val', epoch=self.epoch, **metrics))
        elif self.eval_fn is not None:
            results = self.eval_fn(self.val_loader)
            metrics = dist.broadcast_object(
                self.val_dataset.evaluate(results, metrics=self.eval_metrics)
                if dist.is_main() else None)
            self.log(dict(mode='val', epoch=self.epoch, **metrics))
        if self.save_best and metrics and self.save_best in metrics:
            score = float(metrics[self.save_best])
            better = (self.best_score is None or
                      (score > self.best_score if self.best_rule == 'greater'
                       else score < self.best_score))
            if better:
                self.best_score = score
                if dist.is_main() and self.best_ckpt_path and \
                        osp.exists(self.best_ckpt_path):
                    os.remove(self.best_ckpt_path)
                    if osp.exists(self.best_ckpt_path + '.meta.json'):
                        os.remove(self.best_ckpt_path + '.meta.json')
                self.best_ckpt_path = self._save(
                    self.epoch,
                    prefix=f'best_{self.save_best}_'.replace('/', '_'))
                self.log(dict(mode='val', epoch=self.epoch, best_score=score,
                              best_ckpt=self.best_ckpt_path))


class OmniSourceRunner(Runner):
    """The multi-source runner (the JAX package's ``OmniSourceRunner``,
    reference core/runner/omnisource_runner.py): the main loader sets the
    epoch; every ``train_ratio[0]``-th main step (counted over the run) is
    followed by ``train_ratio[1 + k]`` optimizer steps on auxiliary loader
    k, each cycled without end, their values logged as ``{key}/aux{k}``
    on the main step's log interval."""

    def __init__(self, *args, aux_loaders=(), train_ratio=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.aux_loaders = list(aux_loaders)
        self.train_ratio = list(train_ratio or
                                [1] + [1] * len(self.aux_loaders))
        self._iter = 0
        self._aux_iters = []

    @staticmethod
    def _cycle(loader):
        while True:
            it = iter(loader)
            try:
                yield from it
            finally:
                it.close()

    def train_epoch(self) -> None:
        for loader in self.aux_loaders:
            loader.set_epoch(self.epoch)
        self._aux_iters = [self._cycle(ld) for ld in self.aux_loaders]
        try:
            super().train_epoch()
        finally:
            for it in self._aux_iters:
                it.close()

    def after_step(self, i: int) -> None:
        if self._iter % self.train_ratio[0] == 0:
            for k, times in enumerate(self.train_ratio[1:]):
                for _ in range(times):
                    log_vars = self._train_step(to_torch(
                        next(self._aux_iters[k]), self.device))
                    if (i + 1) % self.log_interval == 0:
                        self.log(dict(mode='train', epoch=self.epoch + 1,
                                      iter=i + 1,
                                      **{f'{key}/aux{k}': v.item()
                                         for key, v in log_vars.items()}))
        self._iter += 1
