"""LR schedules with mmcv LrUpdaterHook semantics.

Port of ``mscl_tpu/core/lr_schedule.py``: the 'fixed', 'step',
'CosineAnnealing' and 'TIN' policies with optional linear/constant/exp
warmup (``warmup_by_epoch`` converts warmup_iters from epochs). 'TIN' (the
TIN recipe's updater) anneals over the progress past the warmup, and its
linear warmup is its own: lr x (frac (1 - ratio) + ratio). Warmup applies
only when the ``warmup`` key is set, as in the JAX package. Returns a
step -> lr function of python floats.
"""
from __future__ import annotations

import math
from typing import Callable, Dict


def build_lr_schedule(lr_config: Dict, base_lr: float, total_epochs: int,
                      steps_per_epoch: int) -> Callable[[int], float]:
    cfg = dict(lr_config or {})
    policy = cfg.pop('policy', 'fixed')
    by_epoch = cfg.pop('by_epoch', True)
    warmup = cfg.pop('warmup', None)
    warmup_iters = cfg.pop('warmup_iters', 0)
    warmup_ratio = cfg.pop('warmup_ratio', 0.1)
    if cfg.pop('warmup_by_epoch', False):
        warmup_iters = warmup_iters * steps_per_epoch

    if policy == 'fixed':
        def regular(step):
            return base_lr
    elif policy == 'step':
        # lr * gamma ** (the number of milestones reached); progress in
        # epochs unless by_epoch=False
        steps = cfg.get('step')
        steps = [steps] if isinstance(steps, int) else list(steps)
        gamma = cfg.get('gamma', 0.1)

        def regular(step):
            progress = step // steps_per_epoch if by_epoch else step
            return base_lr * gamma ** sum(progress >= s for s in steps)
    elif policy == 'CosineAnnealing':
        min_lr = cfg.get('min_lr', 0.0)
        if cfg.get('min_lr_ratio') is not None:
            min_lr = base_lr * cfg['min_lr_ratio']
        max_progress = total_epochs if by_epoch else \
            total_epochs * steps_per_epoch

        def regular(step):
            progress = step / steps_per_epoch if by_epoch else step
            frac = min(max(progress / max_progress, 0.0), 1.0)
            return min_lr + (base_lr - min_lr) * 0.5 * (
                math.cos(math.pi * frac) + 1.0)
    elif policy == 'TIN':
        # the TIN recipe's updater: cosine to min_lr over the progress past
        # the warmup, and its own linear warmup k = frac (1 - ratio) + ratio
        min_lr = cfg.get('min_lr', 0.0)
        max_progress = total_epochs if by_epoch else \
            total_epochs * steps_per_epoch
        w_prog = 0.0
        if warmup is not None:
            w_prog = warmup_iters / steps_per_epoch if by_epoch \
                else warmup_iters

        def regular(step):
            progress = step / steps_per_epoch if by_epoch else step
            span = max(max_progress - w_prog, 1e-8) if warmup is not None \
                else max_progress
            frac = min(max((progress - w_prog) / span, 0.0), 1.0)
            return min_lr + (base_lr - min_lr) * 0.5 * (
                math.cos(math.pi * frac) + 1.0)

        if warmup == 'linear':
            def tin_warmup(step):
                reg = regular(step)
                if step >= warmup_iters:
                    return reg
                frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
                return reg * (frac * (1 - warmup_ratio) + warmup_ratio)
            return tin_warmup
    else:
        raise NotImplementedError(f'lr policy {policy}')

    if warmup is None or warmup_iters == 0:
        return regular

    def with_warmup(step):
        reg = regular(step)
        if step >= warmup_iters:
            return reg
        frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        if warmup == 'linear':
            return reg * (1 - (1 - frac) * (1 - warmup_ratio))
        if warmup == 'constant':
            return reg * warmup_ratio
        if warmup == 'exp':
            return reg * warmup_ratio ** (1 - frac)
        raise NotImplementedError(f'warmup {warmup}')

    return with_warmup
