"""HVULoss and the OHEM hinge loss (port of
``mscl_tpu/models/losses/hvu_loss.py``, reference mmaction
losses/hvu_loss.py and ohem_hinge_loss.py): a multi-task BCE over the tag
categories' slices of the scores, with optional tag and category masks,
and the class-wise hinge loss that keeps each group's largest losses.

OHEM sums the ``keep`` largest losses of each group, so the value is the
same whichever of two equal losses the top-k takes; the gradient reaches
the kept ones, as the JAX top-k's does.
"""
from __future__ import annotations

import torch

from ..builder import LOSSES


def _bce_with_logits(score, label):
    return score.clamp(min=0) - score * label + \
        torch.log1p(torch.exp(-score.abs()))


@LOSSES.register_module()
class HVULoss:
    """``loss_type`` 'all': the BCE over every tag (with ``with_mask``,
    over the ``mask``ed tags of each video); 'individual': each category's
    mean (or sum, ``reduction``) over its tags, averaged over the videos
    (those of ``category_mask`` with ``with_mask``), logged as
    ``{category}_LOSS``, their weighted mean the ``loss_cls``."""

    def __init__(self,
                 categories=('action', 'attribute', 'concept', 'event',
                             'object', 'scene'),
                 category_nums=(739, 117, 291, 69, 1678, 248),
                 category_loss_weights=(1, 1, 1, 1, 1, 1),
                 loss_type='all', with_mask=False, reduction='mean',
                 loss_weight=1.0):
        assert loss_type in ('individual', 'all')
        assert reduction in ('mean', 'sum')
        assert len(category_nums) == len(category_loss_weights)
        self.categories = categories
        self.category_nums = category_nums
        self.category_loss_weights = category_loss_weights
        self.loss_type = loss_type
        self.with_mask = with_mask
        self.reduction = reduction
        self.category_startidx = [0]
        for n in category_nums[:-1]:
            self.category_startidx.append(self.category_startidx[-1] + n)

    def __call__(self, cls_score, label, mask=None, category_mask=None,
                 **kwargs):
        if self.loss_type == 'all':
            per = _bce_with_logits(cls_score, label)
            if self.with_mask and mask is not None:
                per = per * mask
                denom = mask.sum(dim=1).clamp(min=1.0)
                loss = (per.sum(dim=1) / denom).mean()
            else:
                loss = per.mean()
            return dict(loss_cls=loss)

        losses = {}
        total, wsum = 0.0, 0.0
        for name, num, start, w in zip(self.categories,
                                       self.category_nums,
                                       self.category_startidx,
                                       self.category_loss_weights):
            per = _bce_with_logits(cls_score[:, start:start + num],
                                   label[:, start:start + num])
            cat_loss = per.mean(dim=1) if self.reduction == 'mean' else \
                per.sum(dim=1)
            if self.with_mask and category_mask is not None:
                cmask = category_mask[:, list(self.categories).index(name)]
                cat_loss = (cat_loss * cmask).sum() / \
                    cmask.sum().clamp(min=1.0)
            else:
                cat_loss = cat_loss.mean()
            losses[f'{name}_LOSS'] = cat_loss
            total = total + cat_loss * w
            wsum += w
        losses['loss_cls'] = total / max(wsum, 1e-12)
        return losses


def ohem_hinge_loss(pred, labels, is_positive, ohem_ratio, group_size):
    """The hinge loss of each proposal's score for its (1-indexed) class,
    summed over the ``ohem_ratio`` share of largest ones in each group of
    ``group_size``."""
    idx = torch.arange(pred.shape[0], device=pred.device)
    scores = pred[idx, labels.long() - 1]
    losses = (1.0 - is_positive * scores).clamp(min=0.0)
    losses = losses.reshape(-1, group_size)
    keep = max(int(group_size * ohem_ratio), 1)
    return torch.topk(losses, keep, dim=1).values.sum()


@LOSSES.register_module()
class OHEMHingeLoss:

    def __init__(self, ohem_ratio=0.17, group_size=8, is_positive=1):
        self.ohem_ratio = ohem_ratio
        self.group_size = group_size
        self.is_positive = is_positive

    def __call__(self, pred, labels, is_positive=None, ohem_ratio=None,
                 group_size=None, **kwargs):
        return ohem_hinge_loss(
            pred, labels,
            self.is_positive if is_positive is None else is_positive,
            self.ohem_ratio if ohem_ratio is None else ohem_ratio,
            self.group_size if group_size is None else group_size)
