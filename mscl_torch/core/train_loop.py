"""The train step (port of ``mscl_tpu/core/train_loop.py``
``make_train_step``).

The step mutates the model and the optimizer in place: the EMA pre-update
of the key towers, then the forward (which advances BN statistics and the
MoCo queues), backward and the optimizer update. With update=False it
computes the same losses and leaves every parameter and buffer as it was,
as the JAX step discards its new state (validation by loss).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn


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
            with torch.no_grad():
                if pre_update_fn is not None:
                    pre_update_fn()
                loss, log_vars = model.train_step(batch)
            model.load_state_dict(saved)
        return {k: v.detach() for k, v in log_vars.items()}

    return train_step
