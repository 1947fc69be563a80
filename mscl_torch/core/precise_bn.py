"""PreciseBN: refresh the BN running statistics from training data.

Port of ``mscl_tpu/core/precise_bn.py`` (the role of mmcv's PreciseBNHook,
reference apis/train.py:127-139): ``num_iters`` train-mode forwards of the
training loss (``model.train_step``) over a fresh iterator of the train
loader, started again when it ends, with no gradient and no update. BN
keeps its own EMA form (momentum 0.9 in flax's sense, 0.1 of each batch),
so the statistics converge to a data-weighted average of recent batches:
the JAX package's documented approximation of mmcv's exact mean over the
window. Only the BN running statistics are kept: the parameters, any other
buffer (a MoCo queue, its pointer, counts) and the device aug's and
dropout's generators are put back as they were, as the JAX update keeps
only its new ``batch_stats``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

BN_STATS = ('running_mean', 'running_var')


def _close(it):
    """Stop a loader's epoch iterator (its producer thread)."""
    if hasattr(it, 'close'):
        it.close()


def precise_bn_update(model: nn.Module, loader, to_device: Callable[[Dict],
                      Dict], num_iters: int = 200) -> None:
    """Run the refresh in place over ``loader`` (a NumpyLoader, or any
    iterable of host batches); ``to_device`` moves a host batch onto the
    model's device."""
    state = model.state_dict()
    kept = {k: v.clone() for k, v in state.items()
            if not k.endswith(BN_STATS)}
    rngs = [(getattr(model, f'set_{name}_state'),
             getattr(model, f'{name}_state')())
            for name in ('aug', 'dropout')
            if hasattr(model, f'{name}_state')]
    was_training = model.training
    model.train()
    it = iter(loader)
    try:
        with torch.no_grad():
            for _ in range(num_iters):
                try:
                    batch = next(it)
                except StopIteration:
                    _close(it)
                    it = iter(loader)
                    batch = next(it)
                model.train_step(to_device(batch))
    finally:
        _close(it)
    model.load_state_dict(kept, strict=False)
    for put_back, saved in rngs:
        put_back(saved)
    model.train(was_training)
