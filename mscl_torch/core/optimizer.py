"""SGD with the JAX package's update order.

Port of ``mscl_tpu/core/optimizer.py`` ``build_optimizer``, SGD only:
clip all gradients by their global L2 norm, add weight_decay * param, the
momentum trace, then scale by the scheduled learning rate (torch SGD's
order, which the optax chain reproduces). Parameters whose name contains a
freeze pattern (the MoCo key towers) are left out. In a process group
(``parallel/dist.py``) the gradients are first mean-all-reduced in flat
float32 buckets, so the clip acts on the global batch's gradient, as in the
JAX step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..parallel import dist


class SGD:
    """torch.optim.SGD behind a global-norm clip and an lr schedule that
    reads the number of updates made so far."""

    def __init__(self, params, lr_schedule: Callable[[int], float],
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, max_norm: Optional[float] = None):
        self.params = list(params)
        self.lr_schedule = lr_schedule
        self.max_norm = max_norm
        self.steps = 0
        self.opt = torch.optim.SGD(self.params, lr=lr_schedule(0),
                                   momentum=momentum,
                                   weight_decay=weight_decay,
                                   nesterov=nesterov)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip_grads(self):
        """optax.clip_by_global_norm: g * max_norm / ||g|| when ||g|| >=
        max_norm. Stays on the device (no host sync)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_norm is None or not grads:
            return
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        torch._foreach_mul_(grads, scale)

    def state_dict(self) -> Dict:
        """The momentum buffers and ``steps``: what the next update reads."""
        return {'steps': self.steps, 'sgd': self.opt.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """The saved momentum buffers and ``steps``; the hyperparameters
        stay this optimizer's (its config's), as the JAX package's resume
        restores only the optax state into the chain its config built."""
        self.steps = int(state['steps'])
        saved = state['sgd']
        groups = [dict(g, params=s['params']) for g, s in
                  zip(self.opt.state_dict()['param_groups'],
                      saved['param_groups'])]
        self.opt.load_state_dict(dict(saved, param_groups=groups))

    def step(self):
        dist.all_reduce_grads_([p.grad for p in self.params
                                if p.grad is not None])
        self.clip_grads()
        for group in self.opt.param_groups:
            group['lr'] = self.lr_schedule(self.steps)
        self.opt.step()
        self.steps += 1


def build_optimizer(model: nn.Module, optimizer_cfg: Dict,
                    lr_schedule: Callable[[int], float],
                    grad_clip: Optional[Dict] = None,
                    freeze_patterns: Sequence[str] = ()) -> SGD:
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'SGD')
    if opt_type != 'SGD' or cfg.get('paramwise_cfg') or cfg.get('constructor'):
        raise NotImplementedError(f'optimizer {opt_type} with {cfg}')
    if grad_clip and grad_clip.get('norm_type', 2) != 2:
        raise NotImplementedError('only the L2 grad clip is supported')
    params = [p for name, p in model.named_parameters()
              if not any(pat in name for pat in freeze_patterns)]
    return SGD(params, lr_schedule, momentum=cfg.get('momentum', 0.0),
               weight_decay=cfg.get('weight_decay', 0.0),
               nesterov=cfg.get('nesterov', False),
               max_norm=grad_clip['max_norm'] if grad_clip else None)
