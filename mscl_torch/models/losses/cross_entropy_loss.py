"""Cross-entropy losses.

Port of ``mscl_tpu/models/losses/cross_entropy_loss.py``:
``CrossEntropyLoss_torch`` (hard labels with ignore_index: the mean over
non-ignored samples, and 0, not NaN, when every sample is ignored, as the
JAX function returns), ``CrossEntropyLoss`` (hard or soft labels, by
the label's shape, with an optional class weight; the classification
heads' default), ``BCELossWithLogits`` (multi-label, the mean over every
entry), ``NLLLoss`` (on log-probabilities) and
``WeightedCrossEntropyLoss_torch`` (a per-sample pool weight), and the reid
heads' ``TripletLoss`` (batch-hard, with a margin).

In a process group (``parallel/dist.py``) a hard-label loss is the global
batch's: its denominator (the non-ignored count, or the class weights'
sum) can differ across ranks, so it is all-reduced, and a rank's loss is
world x (its numerator) / (the global denominator). The mean of the ranks'
losses, and of their gradients, is then the global batch's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...parallel import dist
from ..builder import LOSSES


def _ratio(num: torch.Tensor, den: torch.Tensor, least: float
           ) -> torch.Tensor:
    """num / max(den, least) on one device; in a process group the
    global batch's share of this rank's numerator (see above)."""
    if not dist.is_distributed():
        return num / den.clamp(min=least)
    den = den.detach().float().clone()
    dist.all_reduce_([den], tag='loss_denominator')
    return num * dist.world_size() / den.clamp(min=least).to(num.dtype)


def cross_entropy(cls_score: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100,
                  class_weight: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    nll = F.cross_entropy(cls_score, safe, reduction='none')
    if class_weight is not None:
        w = class_weight.to(nll)[safe] * valid
        return _ratio((nll * w).sum(), w.sum(), 1e-12)
    return _ratio((nll * valid).sum(), valid.sum(), 1)


def soft_cross_entropy(cls_score: torch.Tensor, label: torch.Tensor,
                       class_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The batch mean of -sum(p * log_softmax(score)) (reference
    cross_entropy_loss.py:43-60)."""
    lsm = F.log_softmax(cls_score, dim=-1)
    if class_weight is not None:
        lsm = lsm * class_weight.to(lsm)
    return -(label * lsm).sum(dim=-1).mean()


@LOSSES.register_module()
class CrossEntropyLoss:
    """mmaction2's CrossEntropyLoss: soft labels when the label has the
    score's shape, hard labels otherwise."""

    def __init__(self, loss_weight=1.0, class_weight=None):
        self.loss_weight = loss_weight
        self.class_weight = None if class_weight is None else \
            torch.as_tensor(class_weight, dtype=torch.float32)

    def __call__(self, cls_score, label, **kwargs):
        if label.dim() == cls_score.dim() and label.shape == cls_score.shape:
            loss = soft_cross_entropy(cls_score, label, self.class_weight)
        else:
            loss = cross_entropy(cls_score, label,
                                 class_weight=self.class_weight)
        return self.loss_weight * loss


@LOSSES.register_module()
class CrossEntropyLossTorch:

    def __init__(self, ignore_index=-100, loss_weight=1.0):
        self.ignore_index = ignore_index
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, **kwargs):
        return self.loss_weight * cross_entropy(cls_score, label,
                                                self.ignore_index)


LOSSES.register_module(name='CrossEntropyLoss_torch',
                       module=CrossEntropyLossTorch)


@LOSSES.register_module()
class BCELossWithLogits:
    """The mean over every entry of the binary cross-entropy of the logits,
    each class weighted by ``class_weight``."""

    def __init__(self, loss_weight=1.0, class_weight=None):
        self.loss_weight = loss_weight
        self.class_weight = None if class_weight is None else \
            torch.as_tensor(class_weight, dtype=torch.float32)

    def __call__(self, cls_score, label, **kwargs):
        per = F.binary_cross_entropy_with_logits(
            cls_score, label.to(cls_score.dtype), reduction='none')
        if self.class_weight is not None:
            per = per * self.class_weight.to(per)
        return self.loss_weight * per.mean()


@LOSSES.register_module()
class NLLLoss:
    """The batch mean of -cls_score[label] (the scores are
    log-probabilities)."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, **kwargs):
        return self.loss_weight * F.nll_loss(cls_score, label.long())


@LOSSES.register_module()
class WeightedCrossEntropyLoss_torch:
    """sum(w * ce) / (sum(w) + eps) with a per-sample ``pool_weight`` w
    (reference cross_entropy_loss.py WeightedCrossEntropyLoss_torch);
    samples labelled ``ignore_index`` add 0."""

    def __init__(self, weight=None, size_average=None, ignore_index=-100,
                 loss_weight=1.0, eps=1e-5):
        self.ignore_index = ignore_index
        self.loss_weight = loss_weight
        self.eps = eps

    def __call__(self, cls_score, label, pool_weight, **kwargs):
        label = label.long()
        valid = label != self.ignore_index
        per = F.cross_entropy(cls_score, torch.where(valid, label, 0),
                              reduction='none') * valid
        loss = (pool_weight * per).sum() / (pool_weight.sum() + self.eps)
        return self.loss_weight * loss


@LOSSES.register_module()
class TripletLoss:
    """Batch-hard triplet loss: for each anchor its farthest positive and
    nearest negative by Euclidean distance, hinged at ``margin`` and
    averaged (the JAX package registers it for the reid heads, whose
    reference names it and ships none). The hardest distances are taken
    with amax / amin, which share the gradient among ties as JAX's max and
    min do."""

    def __init__(self, margin=0.3, loss_weight=1.0):
        self.margin = margin
        self.loss_weight = loss_weight

    def __call__(self, feat, label, **kwargs):
        sq = (feat ** 2).sum(dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * feat @ feat.T
        d = d2.clamp(min=1e-12).sqrt()
        same = (label[:, None] == label[None, :]).to(feat.dtype)
        eye = torch.eye(feat.shape[0], dtype=feat.dtype, device=feat.device)
        hardest_pos = (d * (same - eye)).amax(dim=1)
        hardest_neg = torch.where(same < 1, d,
                                  torch.full_like(d, 1e9)).amin(dim=1)
        per = (hardest_pos - hardest_neg + self.margin).clamp(min=0.0)
        return self.loss_weight * per.mean()
