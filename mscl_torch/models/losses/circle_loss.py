"""Multi-positive contrastive losses (the MSF / circle-loss family).

Port of ``mscl_tpu/models/losses/circle_loss.py`` (reference
mmaction/models/losses/circle_loss.py:13-120): softplus(LSE(sn) - LSE(sp))
and its margin and scale variants, over positive similarities ``sp`` (B, P)
and negative ones ``sn`` (B, N); a group axis (B, G, n) is flattened into
the batch before the log-sum-exp.

The circle loss keeps the reference's weights as they are: ``an =
clip(sg(sn) + m, 0)`` is 0 where ``sn`` holds the -1e6 that
``heads/moco_head_v3._msf_sp_sn`` puts at a key's top-k, so each such
entry adds exp(0) = 1, not 0, to the negatives' log-sum-exp (its gradient
is 0). That is the JAX package's value, and the port matches it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..builder import LOSSES


def _flatten_groups(sp: torch.Tensor, sn: torch.Tensor):
    num_group = 1
    if sp.dim() == 3:
        num_group = sp.shape[1]
        sp = sp.reshape(-1, sp.shape[-1])
        sn = sn.reshape(-1, sn.shape[-1])
    return sp, sn, num_group


class _MultiPositive:

    def __init__(self, loss_weight=1.0, avg_on_group=True):
        self.loss_weight = loss_weight
        self.avg_on_group = avg_on_group

    def _loss(self, sp, sn):
        raise NotImplementedError

    def __call__(self, sp, sn, **kwargs):
        sp, sn, num_group = _flatten_groups(sp, sn)
        loss = self._loss(sp, sn).mean()
        if not self.avg_on_group:
            loss = loss * num_group
        return self.loss_weight * loss


@LOSSES.register_module()
class MultiPositiveSumLoss(_MultiPositive):
    """softplus(LSE(sn) - LSE(sp)) a row."""

    def _loss(self, sp, sn):
        return F.softplus(torch.logsumexp(sn, dim=1) -
                          torch.logsumexp(sp, dim=1))


@LOSSES.register_module()
class MultiPositiveUniLoss(_MultiPositive):
    """softplus(LSE(gamma (sn + m)) + LSE(-gamma sp)) a row."""

    def __init__(self, m=0, gamma=1, loss_weight=1.0, avg_on_group=True):
        super().__init__(loss_weight, avg_on_group)
        self.m = m
        self.gamma = gamma

    def _loss(self, sp, sn):
        return F.softplus(torch.logsumexp((sn + self.m) * self.gamma, dim=1) +
                          torch.logsumexp(-sp * self.gamma, dim=1))


@LOSSES.register_module()
class MultiPositiveCircleLoss(_MultiPositive):
    """Circle loss: each similarity weighted by its own distance from its
    optimum (no gradient through the weight), margin m, scale gamma."""

    def __init__(self, m=0.25, gamma=128, loss_weight=1.0,
                 avg_on_group=True):
        super().__init__(loss_weight, avg_on_group)
        self.m = m
        self.gamma = gamma

    def _loss(self, sp, sn):
        ap = (-sp.detach() + 1 + self.m).clamp(min=0.0)
        an = (sn.detach() + self.m).clamp(min=0.0)
        logit_p = -ap * (sp - (1 - self.m)) * self.gamma
        logit_n = an * (sn - self.m) * self.gamma
        return F.softplus(torch.logsumexp(logit_n, dim=1) +
                          torch.logsumexp(logit_p, dim=1))
