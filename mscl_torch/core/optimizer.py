"""The optimizers with the JAX package's update order and parameter groups.

Port of ``mscl_tpu/core/optimizer.py`` ``build_optimizer`` and
``build_tsm_optimizer``: clip all gradients by their global L2 norm, then
each parameter's group's update, scaled by the scheduled learning rate
times the group's ``lr_mult``.

- ``SGD``: add weight_decay * param, the momentum trace, then the rate
  (torch SGD's order, which the optax chain reproduces).
- ``Adam`` and ``AdamW``: Adam's scaled moments, then weight_decay *
  param added (decoupled, as optax's ``add_decayed_weights`` after
  ``scale_by_adam``), then the rate: the JAX package builds both alike,
  so its ``Adam`` decays as AdamW does, not by the L2 term of
  ``torch.optim.Adam``. Both run as ``torch.optim.AdamW``.
- ``paramwise_cfg.custom_keys``: each parameter takes the ``lr_mult`` and
  ``decay_mult`` of its longest matching key (mmcv's
  DefaultOptimizerConstructor); dotted keys are matched against the JAX
  tree's '/'-joined path of the parameter (``convert.jax_param_paths``),
  as the JAX package matches them. No other paramwise option is read.
- ``constructor='TSMOptimizerConstructor'``: SGD in the groups ``bn``
  (zero decay), ``bias2`` (twice the rate, zero decay) and, with
  ``paramwise_cfg.fc_lr5``, ``fc_w5`` (five times the rate) and
  ``fc_b10`` (ten times, zero decay), labelled from the JAX paths as
  ``_tsm_label`` reads them; the optimizer's type is not read, as in the
  JAX constructor, and neither are the freeze patterns.

Parameters whose name contains a freeze pattern (the MoCo key towers) are
left out: a zero update. In a process group (``parallel/dist.py``) the
gradients are first mean-all-reduced in flat float32 buckets, so the clip
acts on the global batch's gradient, as in the JAX step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..convert import jax_param_paths
from ..parallel import dist


class SGD:
    """A torch optimizer (``torch.optim.SGD``, or ``AdamW`` with
    ``adam``) over parameter groups, behind a global-norm clip and an lr
    schedule that reads the number of updates made so far. ``params`` is
    a list of parameters (one group) or of dicts (``params``, ``lr_mult``,
    ``weight_decay``)."""

    def __init__(self, params, lr_schedule: Callable[[int], float],
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, max_norm: Optional[float] = None,
                 adam: Optional[Dict] = None):
        groups = list(params)
        if not groups or not isinstance(groups[0], dict):
            groups = [dict(params=groups)]
        groups = [dict(g, lr_mult=g.get('lr_mult', 1.0),
                       weight_decay=g.get('weight_decay', weight_decay))
                  for g in groups]
        self.params = [p for g in groups for p in g['params']]
        self.lr_schedule = lr_schedule
        self.max_norm = max_norm
        self.steps = 0
        self.kind = 'sgd' if adam is None else 'adam'
        lr = lr_schedule(0)
        for g in groups:
            g['lr'] = g['lr_mult'] * lr
        if adam is None:
            self.opt = torch.optim.SGD(groups, lr=lr, momentum=momentum,
                                       nesterov=nesterov)
        else:
            self.opt = torch.optim.AdamW(groups, lr=lr, **adam)

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
        """The momentum buffers (Adam's moments and counts) and ``steps``:
        what the next update reads."""
        return {'steps': self.steps, self.kind: self.opt.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """The saved buffers and ``steps``; the hyperparameters stay this
        optimizer's (its config's), as the JAX package's resume restores
        only the optax state into the chain its config built."""
        self.steps = int(state['steps'])
        if self.kind not in state:
            raise KeyError(f'a checkpoint of {sorted(set(state) - {"steps"})}'
                           f' state does not resume {self.kind}')
        saved = state[self.kind]
        groups = [dict(g, params=s['params']) for g, s in
                  zip(self.opt.state_dict()['param_groups'],
                      saved['param_groups'])]
        self.opt.load_state_dict(dict(saved, param_groups=groups))

    def step(self):
        dist.all_reduce_grads_([p.grad for p in self.params
                                if p.grad is not None])
        self.clip_grads()
        lr = self.lr_schedule(self.steps)
        for group in self.opt.param_groups:
            group['lr'] = group['lr_mult'] * lr
        self.opt.step()
        self.steps += 1


def _tsm_label(path_str: str, fc_lr5: bool) -> str:
    """A parameter's TSMOptimizerConstructor group from its JAX path
    (mscl_tpu/core/optimizer.py ``_tsm_label``): BN parameters and norm
    scales -> zero decay; biases -> twice the rate, zero decay; the
    cls_head's fc five times the rate (weight) and ten times with zero
    decay (bias) with ``fc_lr5``."""
    p = path_str.lower()
    is_bias = p.endswith('bias')
    if '/bn' in p or 'batchnorm' in p or ('norm' in p and
                                          p.endswith('scale')):
        return 'bn'
    if 'fc_cls' in p and fc_lr5:
        return 'fc_b10' if is_bias else 'fc_w5'
    return 'bias2' if is_bias else 'default'


# the TSM constructor's groups: (lr_mult, weight decay applied)
TSM_GROUPS = {'default': (1.0, True), 'bias2': (2.0, False),
              'bn': (1.0, False), 'fc_w5': (5.0, True),
              'fc_b10': (10.0, False)}


def tsm_groups(model: nn.Module, fc_lr5: bool) -> Dict[str, str]:
    """Each parameter's TSM group, by name."""
    return {name: _tsm_label(path, fc_lr5)
            for name, path in jax_param_paths(model).items()}


def custom_key_groups(model: nn.Module, custom_keys: Dict,
                      freeze_patterns: Sequence[str] = ()
                      ) -> Dict[str, Optional[int]]:
    """Each parameter's custom key (its index in ``custom_keys``; None for
    the default group; -1 frozen) by name: the longest key in its JAX
    path, a frozen pattern first (mscl_tpu/core/optimizer.py
    ``group_of``)."""
    keys = [k.replace('.', '/').strip('/') for k in custom_keys]
    by_len = sorted(enumerate(keys), key=lambda iv: -len(iv[1]))
    out = {}
    for name, path in jax_param_paths(model).items():
        if any(pat in path for pat in freeze_patterns):
            out[name] = -1
            continue
        out[name] = next((i for i, key in by_len if key in path), None)
    return out


def build_optimizer(model: nn.Module, optimizer_cfg: Dict,
                    lr_schedule: Callable[[int], float],
                    grad_clip: Optional[Dict] = None,
                    freeze_patterns: Sequence[str] = ()) -> SGD:
    cfg = dict(optimizer_cfg)
    if grad_clip and grad_clip.get('norm_type', 2) != 2:
        raise NotImplementedError('only the L2 grad clip is supported')
    max_norm = grad_clip['max_norm'] if grad_clip else None
    pw = dict(cfg.pop('paramwise_cfg', None) or {})
    wd = cfg.get('weight_decay', 0.0)
    named = dict(model.named_parameters())
    if cfg.get('constructor') == 'TSMOptimizerConstructor':
        labels = tsm_groups(model, bool(pw.get('fc_lr5', False)))
        groups = [dict(params=[named[n] for n, g in labels.items()
                               if g == label],
                       lr_mult=mult, weight_decay=wd if decays else 0.0)
                  for label, (mult, decays) in TSM_GROUPS.items()]
        return SGD([g for g in groups if g['params']], lr_schedule,
                   momentum=cfg.get('momentum', 0.0),
                   nesterov=cfg.get('nesterov', False), max_norm=max_norm)
    cfg.pop('constructor', None)
    opt_type = cfg.get('type', 'SGD')
    if opt_type in ('SGD', 'CopyOfSGD'):
        kind = dict(momentum=cfg.get('momentum', 0.0),
                    nesterov=cfg.get('nesterov', False))
    elif opt_type in ('Adam', 'AdamW'):
        kind = dict(adam=dict(betas=tuple(cfg.get('betas', (0.9, 0.999))),
                              eps=cfg.get('eps', 1e-8)))
    else:
        raise NotImplementedError(f'optimizer {opt_type}')
    custom = {k: dict(v) for k, v in (pw.get('custom_keys') or {}).items()}
    if not custom:
        params = [p for name, p in named.items()
                  if not any(pat in name for pat in freeze_patterns)]
        return SGD(params, lr_schedule, weight_decay=wd, max_norm=max_norm,
                   **kind)
    labels = custom_key_groups(model, custom, freeze_patterns)
    groups: List[Dict] = [dict(params=[named[n] for n, g in labels.items()
                                       if g is None])]
    for i, v in enumerate(custom.values()):
        groups.append(dict(params=[named[n] for n, g in labels.items()
                                   if g == i],
                           lr_mult=v.get('lr_mult', 1.0),
                           weight_decay=wd * v.get('decay_mult', 1.0)))
    return SGD([g for g in groups if g['params']], lr_schedule,
               weight_decay=wd, max_norm=max_norm, **kind)
